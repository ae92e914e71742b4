"""A spec's network in plain PyTorch, float32.

`params` is one dict a layer: "w" (OIHW, or IOHW for a transposed
convolution) and, where the layer has BN, "bn_scale", "bn_bias" and the
running "bn_mean", "bn_var".  BN statistics:
  "pooled"     over the whole batch, or with `groups=G` over each of G
               equal runs of consecutive images;
  "per_image"  over each image alone;
  "running"    the running statistics (evaluation mode).
Variance is the biased one, as torch's SpatialBatchNormalization takes in
training mode; eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def _stats(x, mode, groups):
    if mode == "per_image":
        var, mean = torch.var_mean(x, dim=(2, 3), unbiased=False)
        return mean, var                                    # (N, C)
    if groups is not None:
        n, c, h, w = x.shape
        g = x.reshape(groups, n // groups, c, h, w)
        var, mean = torch.var_mean(g, dim=(1, 3, 4), unbiased=False)
        rep = n // groups
        return (mean.repeat_interleave(rep, 0),
                var.repeat_interleave(rep, 0))              # (N, C)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    return mean[None], var[None]                            # (1, C)


def batch_norm(x, p, mode, groups=None):
    """BN of x with p's scale and bias; returns (y, (mean, var))."""
    if mode == "running":
        mean, var = p["bn_mean"][None], p["bn_var"][None]
    else:
        mean, var = _stats(x, mode, groups)
    inv = torch.rsqrt(var + EPS) * p["bn_scale"][None]
    y = (x - mean[..., None, None]) * inv[..., None, None] \
        + p["bn_bias"][None, :, None, None]
    return y, (mean, var)


def _act(x, act, logits):
    if act == "relu":
        return torch.relu(x)
    if act == "lrelu":
        return F.leaky_relu(x, 0.2)
    if act == "sigmoid":
        return x if logits else torch.sigmoid(x)
    if act == "tanh":
        return torch.tanh(x)
    return x


def forward(spec, params, x, bn="pooled", *, groups=None, logits=False,
            rnd=None, stats=None):
    """The network on x (N, C, H, W).  `rnd` (precision.Rounding) rounds
    every convolution's input, weight and output (the control's float8);
    `stats`, a list, collects each BN layer's pooled (mean, var)."""
    for layer, p in zip(spec, params):
        kind = layer["kind"]
        if kind == "upsample":
            f = layer["factor"]
            x = x.repeat_interleave(f, 2).repeat_interleave(f, 3)
            continue
        if kind == "flatten":
            x = x.reshape(x.shape[0], -1)[:, 0]
            continue
        conv = F.conv2d if kind == "conv" else F.conv_transpose2d
        if rnd is None:
            x = conv(x, p["w"], stride=layer["s"], padding=layer["p"])
        else:
            x = rnd.act(conv(rnd.act(x), rnd.weight(p["w"]),
                             stride=layer["s"], padding=layer["p"]))
        if layer["bn"]:
            x, st = batch_norm(x, p, bn, groups)
            if stats is not None:
                stats.append(st)
        x = _act(x, layer["act"], logits)
    return x
