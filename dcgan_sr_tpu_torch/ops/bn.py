"""BN of a bf16 map on the card in two passes, with the activation after it.

The generator's BN layers in bf16 (ops/nn.py batch_norm: fp32 statistics,
then x * a + b in bf16) run eagerly as seven passes over each map: the cast
to fp32, two means, the squares, the product, the sum and the ReLU's clamp,
about 34 bytes an element.  csrc/bn.cu computes the same function in 6: one
kernel reads the map once at bf16 width for its fp32 sums (chunk by chunk,
combined in a fixed order by a small second kernel that also forms a and b),
and one reads it again to normalise, apply the layer's activation and write
it.  It replaces no Pallas kernel: in the JAX package XLA fuses the same
passes (csrc/bn.cu's note).

`takes(x, scale, bias, axis_name)` is the rule ops/nn.py batch_norm follows,
read from the input alone: x a bf16 CUDA tensor, statistics on this device
(no `axis_name`), and no gradient to carry (not grad mode with any of x,
scale or bias requiring grad).  Then `bn_act` launches the kernels and
nothing else; everything else (the CPU, fp32, cross-replica statistics, the
trainer's autograd) runs batch_norm's plain composition, unchanged.

Statistics modes, as ops/nn.py batch_stats: pooled over (N, H, W), pooled
within each of `groups` runs of consecutive images, per image, or the
running statistics given (`running=(mean, var)`; no statistics kernel).

Counters: `launches` counts each kernel's launches in this process (a
launch captured into a CUDA graph counts once, at capture); `plain_cuda_calls`
counts the BN calls on a CUDA tensor that the rule sent to the plain code.
Every kernel call launches "bn_apply_bf16" once, so bn_apply_bf16 over
bn_apply_bf16 + plain_cuda_calls is the share of CUDA BN calls on the
kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ._build import compile_and_load, raw_stream

ACTS = {None: 0, "relu": 1, "lrelu": 2}   # the activations the kernel applies

launches = {"bn_stats_bf16": 0, "bn_finish_bf16": 0, "bn_apply_bf16": 0}
plain_cuda_calls = 0

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build():
    """Compile csrc/bn.cu (once per source content) and load it."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_and_load("bn")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        d, f = ctypes.c_double, ctypes.c_float
        lib.bn_stats_chunks.argtypes, lib.bn_stats_chunks.restype = \
            [ll, ll, i], ll
        lib.bn_stats_vec.argtypes, lib.bn_stats_vec.restype = [p, ll], i
        lib.bn_stats_bf16.argtypes = [p, p, ll, ll, ll, ll, ll, i, p]
        lib.bn_stats_bf16.restype = i
        lib.bn_finish_bf16.argtypes = [p, ll, p, p, p, p, ll, ll, d, d, p, p,
                                       p, p, i, p]
        lib.bn_finish_bf16.restype = i
        lib.bn_apply_bf16.argtypes = [p, p, p, p, ll, ll, ll, ll, i, f, i, p]
        lib.bn_apply_bf16.restype = i
        _lib = lib
        return lib


def takes(x, scale, bias, axis_name=None):
    """Does BN of x run on the kernels: see the module docstring."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and axis_name is None
            and not (torch.is_grad_enabled() and (
                x.requires_grad or scale.requires_grad
                or bias.requires_grad)))


def _rows(n, per_image, groups):
    """(G, R): rows of statistics and the images a row pools."""
    if per_image:
        return n, 1
    g = groups or 1
    if g < 1 or n % g:
        raise ValueError(f"batch {n} does not split into {groups} groups")
    return g, n // g


def _raise_failed(kernel, err):
    raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def stats(x, scale, bias, *, per_image=False, groups=None, eps=1e-5):
    """(mean, var, a, b) of a contiguous bf16 CUDA x: fp32 mean and biased
    var and bf16 a, b, each (G, C) (G rows as `_rows`)."""
    lib = _lib or build()
    n, c = x.shape[0], x.shape[1]
    s = x.shape[2] * x.shape[3]
    g, r = _rows(n, per_image, groups)
    k = lib.bn_stats_chunks(g * c, r * s, lib.bn_stats_vec(x.data_ptr(), s))
    partial = torch.empty((g * c * k, 2), device=x.device,
                          dtype=torch.float32)
    index = x.get_device()
    err = lib.bn_stats_bf16(x.data_ptr(), partial.data_ptr(), n, c, s, r, k,
                            index, raw_stream(index))
    if err:
        _raise_failed("bn_stats_bf16", err)
    launches["bn_stats_bf16"] += 1
    mean = torch.empty((g, c), device=x.device, dtype=torch.float32)
    var = torch.empty_like(mean)
    a, b = _finish(lib, x, scale, bias, eps, g, partial=partial, k=k,
                   n=r * s, mean=mean, var=var)
    return mean, var, a, b


def running_ab(x, scale, bias, running, eps=1e-5):
    """(a, b), each (1, C) bf16, from the running (mean, var)."""
    mean, var = (t.float().contiguous() for t in running)
    return _finish(_lib or build(), x, scale, bias, eps, 1, mean=mean,
                   var=var)


def _finish(lib, x, scale, bias, eps, g, *, mean, var, partial=None, k=0,
            n=1):
    """bf16 (a, b) (g, C).  With `partial` (g * C * k sums from the stats
    kernel, n elements a row) it also writes mean and var (g, C); without,
    it reads them as the running (C,) statistics."""
    c = x.shape[1]
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    a = torch.empty((g, c), device=x.device, dtype=torch.bfloat16)
    b = torch.empty_like(a)
    stats_in = partial is None
    index = x.get_device()
    err = lib.bn_finish_bf16(
        None if stats_in else partial.data_ptr(), k,
        mean.data_ptr() if stats_in else None,
        var.data_ptr() if stats_in else None, scale.data_ptr(),
        bias.data_ptr(), c, g * c, float(n), float(eps),
        None if stats_in else mean.data_ptr(),
        None if stats_in else var.data_ptr(), a.data_ptr(), b.data_ptr(),
        index, raw_stream(index))
    if err:
        _raise_failed("bn_finish_bf16", err)
    launches["bn_finish_bf16"] += 1
    return a, b


def _check_act(act, slope):
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if act == "lrelu" and slope is None:
        raise ValueError("a leaky ReLU needs its slope")


def apply(x, a, b, act=None, slope=None):
    """act(bf16(bf16(x * a) + b)) of a contiguous bf16 CUDA x (N, C, H, W),
    a and b (G, C) bf16 with N a multiple of G (image n reads row n / (N /
    G)); a leaky ReLU multiplies by bf16(slope), as ops/nn.py leaky_relu
    does in bf16.  y has x's shape and lies at x's address modulo 16."""
    _check_act(act, slope)
    lib = _lib or build()
    n, c = x.shape[0], x.shape[1]
    s = x.shape[2] * x.shape[3]
    g = a.shape[0]
    off = (x.data_ptr() % 16) // 2
    if off:
        y = torch.empty(x.numel() + 8, device=x.device,
                        dtype=torch.bfloat16)[off:off + x.numel()].view(
                            x.shape)
    else:
        y = torch.empty(x.shape, device=x.device, dtype=torch.bfloat16)
    index = x.get_device()
    err = lib.bn_apply_bf16(x.data_ptr(), y.data_ptr(), a.data_ptr(),
                            b.data_ptr(), n, c, s, n // g, ACTS[act],
                            float(torch.tensor(slope, dtype=torch.bfloat16))
                            if act == "lrelu" else 0.0,
                            index, raw_stream(index))
    if err:
        _raise_failed("bn_apply_bf16", err)
    launches["bn_apply_bf16"] += 1
    return y


def bn_act(x, scale, bias, *, running=None, per_image=False, groups=None,
           eps=1e-5, act=None, slope=None):
    """The kernel path: (act(BN(x)), mean, var) of a bf16 CUDA x (N, C, H,
    W), the statistics as ops/nn.py batch_stats returns them: (C,) pooled,
    (N, C) per image, (G, C) in groups, or `running` as given."""
    _check_act(act, slope)
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        x = x.contiguous()
    if running is not None:
        a, b = running_ab(x, scale, bias, running, eps)
        return apply(x, a, b, act, slope), running[0], running[1]
    mean, var, a, b = stats(x, scale, bias, per_image=per_image,
                            groups=groups, eps=eps)
    if not per_image and groups is None:
        mean, var = mean[0], var[0]
    return apply(x, a, b, act, slope), mean, var
