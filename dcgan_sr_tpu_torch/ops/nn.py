"""Core NN ops with Torch7-`nn` semantics in PyTorch, differentiable.

Port of dcgan_sr_tpu/ops/nn.py.  Layouts are the reference's: activations
NCHW, conv weight OIHW, conv-transpose weight IOHW, no biases anywhere
(`m:noBias()`, train.lua:46).  The JAX package's custom VJPs work around
XLA's transpose rules and have no counterpart here: autograd differentiates
these ops.

fp32 parity: the JAX package runs fp32 convolutions at Precision.HIGHEST.
cuDNN runs fp32 convolutions in TF32 by default on Hopper (about three
decimal digits), forward and backward alike, and autograd runs the backward
convolutions later, wherever the caller asks for gradients.  So `conv2d` and
`conv_transpose2d` are one autograd function (`_Conv`) that turns TF32 off
(`fp32_convs()`) around its forward call and again around its own backward
call: gradients are full fp32 whether they are taken inside a training step,
in a test, or anywhere else, with no flag for the caller to remember.
Matrix products stay at PyTorch's default full-fp32 precision.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_convs():
    """cuDNN convolutions in full fp32 (TF32 off) for the enclosed calls."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv(torch.autograd.Function):
    """conv2d / conv_transpose2d whose forward and backward both run with
    TF32 off.  The backward is aten's own convolution_backward (the call
    autograd would make), only inside `fp32_convs()`."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed):
        ctx.save_for_backward(x, w)
        ctx.geom = (stride, padding, transposed)
        with fp32_convs():
            if transposed:
                return F.conv_transpose2d(x, w, stride=stride, padding=padding)
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding, transposed = ctx.geom
        with fp32_convs():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad.contiguous(), x, w, None, [stride, stride],
                [padding, padding], [1, 1], transposed, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def conv2d(x, w, stride=1, padding=0):
    """2D cross-correlation, NCHW x OIHW -> NCHW (SpatialConvolution)."""
    return _Conv.apply(x, w, stride, padding, False)


def conv_transpose2d(x, w, stride=2, padding=1):
    """Transposed conv (SpatialFullConvolution), weight (Cin, Cout, kH, kW);
    k4 s2 p1 is exactly 2x upsampling (train.lua:99)."""
    return _Conv.apply(x, w, stride, padding, True)


def batch_stats(x, per_image=False, groups=None):
    """(mean, biased var) over (N, H, W), or over (H, W) of each image with
    `per_image` ((N, C) results), or pooled within each of `groups` equal
    runs of consecutive images ((groups, C) results).  var = E[x^2] - mean^2
    in fp32, the JAX package's formula (ops/nn.py batch_norm)."""
    xf = x.float()
    if groups is not None and not per_image:
        n, c, h, w = xf.shape
        if n % groups:
            raise ValueError(f"batch {n} does not split into {groups} groups")
        xf = xf.reshape(groups, n // groups, c, h, w)
        dims = (1, 3, 4)
    else:
        dims = (2, 3) if per_image else (0, 2, 3)
    mean = xf.mean(dims)
    mean_sq = (xf * xf).mean(dims)
    return mean, mean_sq - mean * mean


def normalize(x, mean, var, scale, bias, eps=1e-5):
    """(x - mean) * (rsqrt(var + eps) * scale) + bias, in the exact fp32
    order of the JAX package.  mean/var are (C,), per-image (N, C), or per
    group (G, C) with N a multiple of G (consecutive images share a row)."""
    inv = torch.rsqrt(var + eps)
    a = inv * scale
    if mean.dim() == 1:
        return (x - mean[None, :, None, None]) * a[None, :, None, None] \
            + bias[None, :, None, None]
    if mean.shape[0] != x.shape[0]:
        rep = x.shape[0] // mean.shape[0]
        mean = mean.repeat_interleave(rep, dim=0)
        a = a.repeat_interleave(rep, dim=0)
    return (x - mean[:, :, None, None]) * a[:, :, None, None] \
        + bias[None, :, None, None]


def batch_norm(x, scale, bias, *, state=None, train=True, per_image=False,
               groups=None, eps=1e-5, momentum=0.1):
    """Torch SpatialBatchNormalization semantics.

    Train mode normalizes with biased batch statistics over (N, H, W), or
    over each image's own (H, W) with `per_image` — the JAX package's
    batch-of-one vmap (infer/tiled.py make_full_sr_fn) written out as a
    batch dimension.  Eval mode (`train=False`) uses `state`'s running
    statistics.

    Returns (y, new_state); new_state = {"mean", "var"} running stats after
    a train-mode step (unbiased var, momentum 0.1, Torch defaults), None when
    `state` is None or the statistics are per image or per group.
    """
    if not train:
        return normalize(x, state["mean"], state["var"], scale, bias, eps), state
    mean, var = batch_stats(x, per_image, groups)
    new_state = None
    if state is not None and not per_image and groups is None:
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var * (n / max(n - 1, 1))
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean,
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
    return normalize(x, mean, var, scale, bias, eps), new_state


def relu(x):
    return torch.clamp_min(x, 0)


def leaky_relu(x, slope=0.2):
    return torch.where(x >= 0, x, x * slope)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def upsample_nearest(x, factor=2):
    """SpatialUpSamplingNearest: repeat each pixel factor x factor (NCHW)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)
