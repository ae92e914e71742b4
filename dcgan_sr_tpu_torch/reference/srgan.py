"""SRGAN's generator (SRResNet) in plain PyTorch: the reference the port's
spec-driven network is held to.

Ledig et al., "Photo-Realistic Single Image Super-Resolution Using a
Generative Adversarial Network", 2017, arXiv:1609.04802, Fig. 4 and
§3.  The forward pass, in order:
  1. conv k9n64s1 and PReLU (the head);
  2. B residual blocks, each conv k3n64s1, BN, PReLU, conv k3n64s1, BN,
     then the sum with the block's input;
  3. conv k3n64s1 and BN, then the sum with the head's output (the long
     skip);
  4. log2(scale) upsampling blocks, each conv k3n256s1, PixelShuffle x2,
     PReLU;
  5. conv k9n3s1.
Input (LR) in [0, 1], output (HR) in [-1, 1] (§3.2).  Float32 with TF32 off
for cuDNN and matmul; BN with the running statistics (or, `bn="pooled"`,
the batch's biased statistics), eps 1e-5.

Where the paper leaves a choice, this takes (and the configuration file's
`assumed` repeats):
  - no activation after the last conv, as Fig. 4 draws it;
  - PReLU channel-wise, one slope a channel, initialised at 0.25 (He et
    al. 2015's form);
  - every conv has a bias;
  - PixelShuffle in torch's channel order (channel c * 4 + i * 2 + j goes
    to channel c at (2h + i, 2w + j)).

It imports nothing of dcgan_sr_tpu_torch and nothing of JAX.  Weights are a
nested structure, one entry a layer of the port's spec (models/specs.py):
  params[0]        head  {"w", "b", "prelu"}
  params[1]        trunk {"body": [block x B, mid]}; a block
                   {"body": [{"w", "b", "bn_scale", "bn_bias", "prelu"},
                             {"w", "b", "bn_scale", "bn_bias"}]};
                   mid {"w", "b", "bn_scale", "bn_bias"}
  params[2 + 2u]   upsampling conv u {"w", "b"}
  params[3 + 2u]   its shuffle {"prelu"}
  params[-1]       tail {"w", "b"}
and `state` the same structure with {"bn": {"mean", "var"}} at each BN
layer ({} elsewhere).  `config` is a dict of nc, channels, blocks,
up_channels, scale, head_k and body_k.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

EPS = 1e-5
PRELU_INIT = 0.25
E4M3 = torch.float8_e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """cuDNN and matmul in full float32 for the enclosed calls."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def fp8(x):
    """x rounded to float8 e4m3 at a per-tensor scale that maps its largest
    magnitude to e4m3's largest finite value (the control's rounding)."""
    amax = x.abs().amax().float().clamp_min(1e-30)
    scale = torch.finfo(E4M3).max / amax
    return (x.float() * scale).to(E4M3).float() / scale


def up_blocks(config):
    n = int(math.log2(config["scale"]))
    if 2 ** n != config["scale"] or n < 1:
        raise ValueError(f"scale {config['scale']} is not a power of two")
    return n


def spec(config):
    """The layers in the port's spec dialect (models/specs.py)."""
    c, k, nc = config["channels"], config["body_k"], config["nc"]
    u = config["up_channels"]

    def conv(cin, cout, kk, bn, act):
        return {"kind": "conv", "cin": cin, "cout": cout, "k": kk, "s": 1,
                "p": kk // 2, "bn": bn, "act": act, "bias": True}

    def block():
        return {"kind": "residual",
                "body": (conv(c, c, k, True, "prelu"),
                         conv(c, c, k, True, None))}

    up = []
    for _ in range(up_blocks(config)):
        up += [conv(c, u, k, False, None),
               {"kind": "pixel_shuffle", "factor": 2, "cin": u,
                "cout": u // 4, "act": "prelu"}]
    return (conv(nc, c, config["head_k"], False, "prelu"),
            {"kind": "residual",
             "body": (*(block() for _ in range(config["blocks"])),
                      conv(c, c, k, True, None))},
            *up,
            conv(c, nc, config["head_k"], False, None))


def draw(config, gen, device="cpu"):
    """Seeded (params, state) from `gen` (a torch.Generator on `device`),
    in one normal draw: conv weights N(0, 0.02), conv biases N(0, 0.02),
    BN scales 1 + N(0, 0.02), BN biases N(0, 0.02), PReLU slopes 0.25 +
    N(0, 0.02); running statistics (0, 1)."""
    c, nc, k, u = (config["channels"], config["nc"], config["body_k"],
                   config["up_channels"])
    hk = config["head_k"]
    shapes = []       # (path to the dict, key, shape, offset)

    def conv(cin, cout, kk, bn, prelu):
        p = {"w": (cout, cin, kk, kk), "b": (cout,)}
        if bn:
            p["bn_scale"] = p["bn_bias"] = (cout,)
        if prelu:
            p["prelu"] = (cout,)
        return p

    blocks = [{"body": [conv(c, c, k, True, True), conv(c, c, k, True, False)]}
              for _ in range(config["blocks"])]
    layout = [conv(nc, c, hk, False, True),
              {"body": blocks + [conv(c, c, k, True, False)]}]
    for _ in range(up_blocks(config)):
        layout += [conv(c, u, k, False, False), {"prelu": (u // 4,)}]
    layout.append(conv(c, nc, hk, False, False))

    def walk(t):
        if isinstance(t, list):
            for v in t:
                yield from walk(v)
        elif "body" in t:
            yield from walk(t["body"])
        else:
            for key in sorted(t):
                shapes.append((t, key))
                yield t[key]

    total = sum(math.prod(s) for s in walk(layout))
    flat = torch.randn(total, generator=gen, device=device) * 0.02
    at = 0
    for d, key in shapes:
        n = math.prod(d[key])
        v = flat[at:at + n].view(d[key])
        at += n
        d[key] = (1.0 + v if key == "bn_scale" else
                  PRELU_INIT + v if key == "prelu" else v)

    def state_of(t):
        if isinstance(t, list):
            return [state_of(v) for v in t]
        if "body" in t:
            return {"body": state_of(t["body"])}
        if "bn_scale" in t:
            n = t["bn_scale"].shape[0]
            return {"bn": {"mean": torch.zeros(n, device=device),
                           "var": torch.ones(n, device=device)}}
        return {}

    return layout, state_of(layout)


def _conv(x, p, rnd):
    w, pad = p["w"], p["w"].shape[-1] // 2
    if rnd is None:
        return F.conv2d(x, w, p["b"], padding=pad)
    return rnd(F.conv2d(rnd(x), rnd(w), p["b"], padding=pad))


def _bn(x, p, s, mode, stats):
    if mode == "running":
        mean, var = s["bn"]["mean"], s["bn"]["var"]
    else:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats.append((mean, var))
    inv = torch.rsqrt(var + EPS) * p["bn_scale"]
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
        + p["bn_bias"][None, :, None, None]


def _prelu(x, a):
    return torch.where(x >= 0, x, a[None, :, None, None] * x)


def forward(params, state, x, *, bn="running", precision="fp32",
            stats=None):
    """The generator on LR x (N, nc, h, w) -> (N, nc, s h, s w), float32.
    `precision="fp8"` rounds every conv's input, weight and output to e4m3
    (the control); `stats`, a list, collects each BN layer's pooled (mean,
    var) under `bn="pooled"`."""
    rnd = {"fp32": None, "fp8": fp8}[precision]
    with torch.no_grad(), exact_fp32():
        x = x.float()
        head, trunk = params[0], params[1]
        h = _prelu(_conv(x, head, rnd), head["prelu"])
        y = h
        for blk, sblk in zip(trunk["body"][:-1], state[1]["body"][:-1]):
            (c1, c2), (s1, s2) = blk["body"], sblk["body"]
            t = _prelu(_bn(_conv(y, c1, rnd), c1, s1, bn, stats), c1["prelu"])
            y = y + _bn(_conv(t, c2, rnd), c2, s2, bn, stats)
        mid, smid = trunk["body"][-1], state[1]["body"][-1]
        y = _bn(_conv(y, mid, rnd), mid, smid, bn, stats) + h
        for i in range(2, len(params) - 1, 2):
            y = F.pixel_shuffle(_conv(y, params[i], rnd), 2)
            y = _prelu(y, params[i + 1]["prelu"])
        return _conv(y, params[-1], rnd)
