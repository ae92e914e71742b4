"""The seven reference variants' generator/discriminator topologies as specs.

A data copy of dcgan_sr_tpu/models/specs.py for the PyTorch port (which
imports nothing of the JAX package); tests/test_torch_config.py holds the two
equal for every variant.

Every generator is a point in one family: optional nearest-upsample prefix,
k4s2p1 transposed-conv up-stack, k4s2p1 strided-conv down-stack, Tanh or
Sigmoid head, BN optional (SURVEY.md §7.1).  Discriminators are either the
64x64 5-layer DCGAN-D or the 8x8 patch-D with 3x3 valid convs.

Per-variant sources in the reference:
  rgb-full G  train.lua:97-113          D  train.lua:119-137
  gray G      train-gray.lua:102-117    D  train-gray.lua:123-141  (G has NO BN)
  gray-2 G    train-gray-2.lua:65-77    D  train-gray-2.lua:82-100
  gray-3 G    train-gray-3.lua:52-73    D  train-gray-3.lua:77-95
  gray-patch G train-gray-patch.lua:54-76   D train-gray-patch.lua:94-109
  gray-patch-batch G train-gray-patch-batch.lua:55-78  D :81-97
  overlap G   train-gray-patch-batch-overlap.lua:76-103 (== gray-patch G) D :106-122

Beyond the seven, a port-only model (core/config.py MODELS), SRGAN's
generator, has its spec from `srresnet_spec`.  Its layers add
three things to the dialect: a conv with `"bias": True` and stride 1,
"same" padding; `"act": "prelu"`, a channel-wise PReLU whose slopes are
the layer's parameters; and two kinds, `"residual"` (its `body`, a tuple
of layers, then the sum of the body's output and its input) and
`"pixel_shuffle"` (channel c * r * r + i * r + j of the input to channel c
at (h * r + i, w * r + j), torch's PixelShuffle order, then its `act`).
"""

from __future__ import annotations

from ..core.config import SRResNetConfig


def _up(f=2):
    return {"kind": "upsample", "factor": f}


def _convT(cin, cout, bn=True, act="relu", k=4, s=2, p=1):
    return {"kind": "convT", "cin": cin, "cout": cout, "k": k, "s": s, "p": p,
            "bn": bn, "act": act}


def _conv(cin, cout, bn=True, act="relu", k=4, s=2, p=1):
    return {"kind": "conv", "cin": cin, "cout": cout, "k": k, "s": s, "p": p,
            "bn": bn, "act": act}


def _flat():
    return {"kind": "flatten"}


def _conv_b(cin, cout, k, bn, act):
    return {"kind": "conv", "cin": cin, "cout": cout, "k": k, "s": 1,
            "p": k // 2, "bn": bn, "act": act, "bias": True}


def _residual(*body):
    return {"kind": "residual", "body": tuple(body)}


def _shuffle(cin, r, act):
    return {"kind": "pixel_shuffle", "factor": r, "cin": cin,
            "cout": cin // (r * r), "act": act}


def srresnet_spec(m):
    """SRGAN's generator (arXiv:1609.04802 Fig. 4) at an SRResNetConfig's
    sizes:
    head conv + PReLU; a residual group of `blocks` residual blocks (conv,
    BN, PReLU, conv, BN) and a conv + BN, summed with the head's output;
    the upsampling blocks (conv, PixelShuffle x2, PReLU); the tail conv."""
    c, k = m.channels, m.body_k
    if m.up_channels != 4 * c:
        raise ValueError(f"PixelShuffle x2 of {m.up_channels} channels "
                         f"gives {m.up_channels // 4}, not {c}")

    def block():
        return _residual(_conv_b(c, c, k, True, "prelu"),
                         _conv_b(c, c, k, True, None))

    up = []
    for _ in range(m.up_blocks):
        up += [_conv_b(c, m.up_channels, k, False, None),
               _shuffle(m.up_channels, 2, "prelu")]
    return (
        _conv_b(m.nc, c, m.head_k, False, "prelu"),
        _residual(*(block() for _ in range(m.blocks)),
                  _conv_b(c, c, k, True, None)),
        *up,
        _conv_b(c, m.nc, m.head_k, False, None),
    )


def generator_spec(cfg):
    if isinstance(cfg, SRResNetConfig):
        return srresnet_spec(cfg)
    v, nc, g = cfg.variant, cfg.nc, cfg.ngf
    if v == "rgb-full":
        # 32 -> 64 -> 128 -> 256 -> 128 -> 64 (train.lua:97-113)
        return (
            _convT(nc, g * 8), _convT(g * 8, g * 4), _convT(g * 4, g * 2),
            _conv(g * 2, g, act="lrelu"),
            _conv(g, nc, bn=False, act="tanh"),
        )
    if v == "gray":
        # upsample + 2 FullConv up + 2 conv down, NO BN (train-gray.lua:102-117)
        return (
            _up(),
            _convT(nc, g * 4, bn=False, act=None),
            _convT(g * 4, g * 2, bn=False, act=None),
            _conv(g * 2, g, bn=False, act=None),
            _conv(g, nc, bn=False, act="tanh"),
        )
    if v == "gray-2":
        # 3x nearest-up to 256, 2 stride-2 convs down (train-gray-2.lua:65-77)
        return (
            _up(), _up(), _up(),
            _conv(nc, g),
            _conv(g, nc, bn=False, act="sigmoid"),
        )
    if v == "gray-3":
        # hourglass to 512 and back (train-gray-3.lua:52-73)
        return (
            _up(),
            _convT(nc, g * 4), _convT(g * 4, g * 2), _convT(g * 2, g),
            _conv(g, g * 2), _conv(g * 2, g * 4),
            _conv(g * 4, nc, bn=False, act="sigmoid"),
        )
    if v in ("gray-patch", "gray-patch-batch-overlap"):
        # 4px patch -> up 8 -> T16 -> T32 -> T64 -> c32 -> c16 -> 8
        # (train-gray-patch.lua:54-76; overlap:76-103 is identical as-committed)
        return (
            _up(),
            _convT(nc, g * 4), _convT(g * 4, g * 2), _convT(g * 2, g),
            _conv(g, g * 2), _conv(g * 2, g * 4),
            _conv(g * 4, nc, bn=False, act="sigmoid"),
        )
    if v == "gray-patch-batch":
        # all-conv: 4 FullConvs up (4->64) then 3 convs down (->8)
        # (train-gray-patch-batch.lua:55-78)
        return (
            _convT(nc, g * 8), _convT(g * 8, g * 4), _convT(g * 4, g * 2),
            _convT(g * 2, g),
            _conv(g, g * 2), _conv(g * 2, g * 4),
            _conv(g * 4, nc, bn=False, act="sigmoid"),
        )
    raise KeyError(v)


def discriminator_spec(cfg):
    nc, d = cfg.nc, cfg.ndf
    if cfg.disc == "dcgan64":
        # 64 -> 32 -> 16 -> 8 -> 4 -> 1 (train.lua:119-137)
        return (
            _conv(nc, d, bn=False, act="lrelu"),
            _conv(d, d * 2, act="lrelu"),
            _conv(d * 2, d * 4, act="lrelu"),
            _conv(d * 4, d * 8, act="lrelu"),
            _conv(d * 8, 1, bn=False, act="sigmoid", k=4, s=1, p=0),
            _flat(),
        )
    if cfg.disc == "patch8":
        # 8 -> 6 -> 4 -> 2 -> 1 with 3x3 valid convs (train-gray-patch.lua:94-109)
        return (
            _conv(nc, d, bn=False, act="lrelu", k=3, s=1, p=0),
            _conv(d, d * 2, act="lrelu", k=3, s=1, p=0),
            _conv(d * 2, d * 4, act="lrelu", k=3, s=1, p=0),
            _conv(d * 4, 1, bn=False, act="sigmoid", k=2, s=1, p=0),
            _flat(),
        )
    raise KeyError(cfg.disc)
