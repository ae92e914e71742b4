"""Float32 with TF32 off, and the float8 rounding of the control."""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


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


def _round(x, dtype):
    """x at a per-tensor scale mapping its largest magnitude to `dtype`'s
    largest finite value, rounded to `dtype` and scaled back."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.detach().float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """A tensor in float8 on its way forward (e4m3) and its gradient in
    float8 on its way back (e5m2): an fp8 step's activations and
    gradients."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8_round(x):
    """x in float8: e4m3 forward, e5m2 gradient."""
    return _Fp8.apply(x)


def fp8_weight(w):
    """A weight in float8 e4m3; its gradient passes unchanged (an fp8
    step keeps its weight gradients and master weights wider)."""
    return w + (_round(w, torch.float8_e4m3fn) - w).detach()


class Rounding:
    """What a precision rounds: the activations and gradients at every
    convolution's input and output (`act`), and its weight (`weight`)."""

    def __init__(self, act, weight):
        self.act, self.weight = act, weight


def rounding(precision):
    """The rounding of a precision: none for "fp32"; for "fp8", the
    control, every convolution's input, weight and output in float8."""
    if precision == "fp32":
        ident = lambda t: t  # noqa: E731
        return Rounding(ident, ident)
    if precision == "fp8":
        return Rounding(fp8_round, fp8_weight)
    raise ValueError(f"unknown precision {precision!r}")
