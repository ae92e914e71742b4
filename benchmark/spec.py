"""The benchmark's frozen copy of the two configurations' networks.

Both generators are one family (an upsample prefix, three k4s2p1
transposed convolutions up, three k4s2p1 convolutions down, a Sigmoid
head; BN and ReLU after every layer but the last), at the widths of their
configuration file.  The discriminators are the 64x64 DCGAN-D
(`dcgan64`) and the 8x8 patch-D (`patch8`).  The reference and the FLOP
and byte counts read these lists; the program builds its own.

A layer is a dict: kind ("upsample", "conv", "convT", "flatten"), cin,
cout, k, s, p, bn (bool), act ("relu", "lrelu", "sigmoid", None).
"""

from __future__ import annotations


def _layer(kind, cin, cout, bn=True, act="relu", k=4, s=2, p=1):
    return {"kind": kind, "cin": cin, "cout": cout, "k": k, "s": s, "p": p,
            "bn": bn, "act": act}


def generator(config):
    """The generator of a configuration file's dict."""
    if config["generator"] != "up-3convT-3conv":
        raise ValueError(f"unknown generator family {config['generator']!r}")
    nc, g = config["nc"], config["ngf"]
    return (
        {"kind": "upsample", "factor": 2},
        _layer("convT", nc, 4 * g), _layer("convT", 4 * g, 2 * g),
        _layer("convT", 2 * g, g),
        _layer("conv", g, 2 * g), _layer("conv", 2 * g, 4 * g),
        _layer("conv", 4 * g, nc, bn=False, act="sigmoid"),
    )


def discriminator(config):
    """The discriminator of a configuration file's dict."""
    nc, d = config["nc"], config["ndf"]
    if config["disc"] == "dcgan64":
        return (
            _layer("conv", nc, d, bn=False, act="lrelu"),
            _layer("conv", d, 2 * d, act="lrelu"),
            _layer("conv", 2 * d, 4 * d, act="lrelu"),
            _layer("conv", 4 * d, 8 * d, act="lrelu"),
            _layer("conv", 8 * d, 1, bn=False, act="sigmoid", k=4, s=1, p=0),
            {"kind": "flatten"},
        )
    if config["disc"] == "patch8":
        return (
            _layer("conv", nc, d, bn=False, act="lrelu", k=3, s=1, p=0),
            _layer("conv", d, 2 * d, act="lrelu", k=3, s=1, p=0),
            _layer("conv", 2 * d, 4 * d, act="lrelu", k=3, s=1, p=0),
            _layer("conv", 4 * d, 1, bn=False, act="sigmoid", k=2, s=1, p=0),
            {"kind": "flatten"},
        )
    raise ValueError(f"unknown discriminator {config['disc']!r}")


def weight_shape(layer):
    """OIHW for a conv, IOHW for a transposed conv."""
    k = layer["k"]
    if layer["kind"] == "conv":
        return (layer["cout"], layer["cin"], k, k)
    return (layer["cin"], layer["cout"], k, k)


def fused_pairs(spec):
    """Start indices of the (convT k4s2p1 + BN + ReLU, conv k4s2p1) pairs
    that a fused kernel may take, scanned left to right without overlap."""
    def k4s2p1(layer, kind):
        return (layer["kind"] == kind and layer["k"] == 4 and layer["s"] == 2
                and layer["p"] == 1)

    out, i = [], 0
    while i + 1 < len(spec):
        a, b = spec[i], spec[i + 1]
        if (k4s2p1(a, "convT") and a["bn"] and a["act"] == "relu"
                and k4s2p1(b, "conv")):
            out.append(i)
            i += 2
        else:
            i += 1
    return out
