"""The gray-3 generator's "bulge" pair, fused: y = conv(relu(bn(convT(x)))).

Port of dcgan_sr_tpu/ops/pallas_bulge.py fused_bulge_fwd.  convT and conv
are both k4 s2 p1, so the 2x-resolution hidden tensor h = convT(x) exists only
inside the kernel (csrc/bulge.cu); the JAX package's unfused layers 3-4
(models/network.py) compute the same function.

`bulge()` is the entry.  On a CPU tensor it runs `bulge_plain()`, the
unfused PyTorch composition; on a CUDA tensor it launches the hand-written
kernel and nothing else (no fallback).  The kernel's shared library is built
from csrc/bulge.cu with nvcc for sm_90a at first use, into _build/ beside
the package, and loaded with ctypes.

fp32 x has three implementations (`impl=`): "wgmma" (csrc/bulge_wgmma.cu
namespace wgf: TMA, both stages as error-compensated TF32 products, three
TF32 products a product, on wgmma, built for Hopper), "mma"
(csrc/bulge.cu: the same products on mma.sync in a persistent grid; host
side of both: ops/bulge_mma.py) and "fma", the earlier fp32 FMA kernel.
`choose_impl` gives an fp32 call to "wgmma" where its tensor map can take x
(W a multiple of 4, x's base 16-byte aligned) at a triple it was built for,
to "mma" at the other triples "mma" was built for, and to "fma" elsewhere;
an explicit `impl=` is for measurements and tests.  None is ever a fallback
for another.

bf16 (x in bfloat16, JAX fused_bulge_fwd with bf16 x): the tensor-core
kernel's bf16 instantiation, one bf16 mma (m16n8k16, fp32 accumulators) a
product.  x, the packed weights, the hidden tensor fed to the second
product and y are bf16; the statistics, the BN gain and shift and the
normalisation of h are fp32, and h is rounded to bf16 only after BN, ReLU
and the edge mask (pallas_bulge.py:216-228).  Two kernels take bf16:
"wgmma" (csrc/bulge_wgmma.cu: TMA, wgmma and mbarrier rings, built for
Hopper) at bulge_mma.WGMMA_TRIPLES, and "mma" (bulge.cu's mma.sync kernel)
at bulge_mma.MMA_TRIPLES.  `choose_impl` gives a bf16 call to "wgmma" where
its tensor map can take x (W a multiple of 8, x's base 16-byte aligned) at
a triple it was built for, and to "mma" otherwise; "fma", or a triple
neither has, raises.  The choice depends on dtype, shape and alignment
alone, never on whether a launch failed.

BN statistics of h, three ways (`stats=`):
  "pooled"     over the whole batch — K2's own statistics
               (pallas_bulge.py:279-283), train-mode BN; with `groups=G`
               over each of G equal runs of consecutive images, the overlap
               pipeline's per-image tile batches (infer/tiled.py);
  "per_image"  over each image alone — make_full_sr_fn's batch-of-one vmap
               (infer/tiled.py), the parity-BN serving path;
  "running"    the given running (mean, var) — BN eval mode, the default
               serving path.
Either way var is the biased E[h^2] - mean^2, as the JAX package computes it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import bulge_mma as M
from . import nn as N
from ..utils.profiling import span
from ._build import compile_and_load, raw_stream, sm_count

STATS_MODES = ("pooled", "per_image", "running")
IMPLS = ("wgmma", "mma", "fma")  # float32 x
BF16_IMPLS = ("wgmma", "mma")    # bfloat16 x

# Launches of each kernel in this process: a wrapper adds one where it
# launches its kernel, and nowhere else (CPU calls run the plain version).
launches = {"bulge_stats": 0, "bulge_main": 0, "bulge_stats_bf16": 0,
            "bulge_main_bf16": 0}
# The same launches by the implementation that ran (both kernels of a pair
# counted): which one `choose_impl` sent a path through; fp32 launches under
# "wgmma" (bulge_wgmma.cu), "mma" and "fma" (bulge.cu), bf16 launches under
# "wgmma_bf16" (bulge_wgmma.cu) and "mma_bf16" (bulge.cu).
impl_launches = {"wgmma": 0, "mma": 0, "fma": 0, "mma_bf16": 0,
                 "wgmma_bf16": 0}

_lib = None
_lib_lock = threading.Lock()
build_log = ""
_wlib = None
_wlib_lock = threading.Lock()
wgmma_build_log = ""


def build():
    """Compile csrc/bulge.cu (once per source content, ops/_build.py) and
    load it."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_and_load("bulge")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bulge_tile.argtypes, lib.bulge_tile.restype = [], i
        lib.bulge_supported.argtypes, lib.bulge_supported.restype = [i, i], i
        lib.bulge_main_smem_bytes.argtypes = [i, i, i]
        lib.bulge_main_smem_bytes.restype = ctypes.c_size_t
        lib.bulge_mma_supported.argtypes = [i, i, i]
        lib.bulge_mma_supported.restype = i
        lib.bulge_mma_smem_bytes.argtypes = [i]
        lib.bulge_mma_smem_bytes.restype = ctypes.c_size_t
        lib.bulge_mma_bf16_smem_bytes.argtypes = [i]
        lib.bulge_mma_bf16_smem_bytes.restype = ctypes.c_size_t
        lib.bulge_stats_f32.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.bulge_stats_f32.restype = i
        lib.bulge_main_f32.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.bulge_main_f32.restype = i
        lib.bulge_stats_fma_f32.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.bulge_stats_fma_f32.restype = i
        lib.bulge_main_fma_f32.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.bulge_main_fma_f32.restype = i
        lib.bulge_stats_bf16.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.bulge_stats_bf16.restype = i
        lib.bulge_main_bf16.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.bulge_main_bf16.restype = i
        if (lib.bulge_band_rows(), lib.bulge_chunk_cols()) != (
                M.BAND_ROWS, M.CHUNK_COLS) or not all(
                    lib.bulge_mma_supported(*t) for t in M.MMA_TRIPLES):
            raise RuntimeError("csrc/bulge.cu and ops/bulge_mma.py disagree "
                               "on the work item's size or the channel "
                               "triples built")
        _lib = lib
        return lib


def build_wgmma():
    """Compile csrc/bulge_wgmma.cu (once per source content) and load it."""
    global _wlib, wgmma_build_log
    with _wlib_lock:
        if _wlib is not None:
            return _wlib
        lib, wgmma_build_log = compile_and_load("bulge_wgmma")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("band_rows", "chunk_cols", "box_rows", "box_cols"):
            fn = getattr(lib, "bulge_wgmma_" + name)
            fn.argtypes, fn.restype = [], i
        lib.bulge_wgmma_supported.argtypes = [i, i, i]
        lib.bulge_wgmma_supported.restype = i
        lib.bulge_wgmma_encode.argtypes = [p, i, i, i, i, i]
        lib.bulge_wgmma_encode.restype = i
        lib.bulge_wgmma_stats_bf16.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.bulge_wgmma_stats_bf16.restype = i
        lib.bulge_wgmma_main_bf16.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.bulge_wgmma_main_bf16.restype = i
        for name in ("f32_box_cols", "f32_box_col0"):
            fn = getattr(lib, "bulge_wgmma_" + name)
            fn.argtypes, fn.restype = [], i
        lib.bulge_wgmma_f32_main_rows.argtypes = [i]
        lib.bulge_wgmma_f32_main_rows.restype = i
        lib.bulge_wgmma_stats_f32.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.bulge_wgmma_stats_f32.restype = i
        lib.bulge_wgmma_main_f32.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.bulge_wgmma_main_f32.restype = i
        lib.bulge_wgmma_tf32_probe.argtypes = [p, p, p, p]
        lib.bulge_wgmma_tf32_probe.restype = i
        if (lib.bulge_wgmma_band_rows(), lib.bulge_wgmma_chunk_cols(),
                lib.bulge_wgmma_box_rows(), lib.bulge_wgmma_box_cols(),
                lib.bulge_wgmma_f32_box_cols(),
                lib.bulge_wgmma_f32_box_col0()) != (
                M.BAND_ROWS, M.CHUNK_COLS, M.BOX_ROWS, M.BOX_COLS,
                M.F32_BOX_COLS, M.F32_BOX_COL0) or not all(
                    lib.bulge_wgmma_supported(*t)
                    and lib.bulge_wgmma_f32_main_rows(t[0])
                    == M.f32_main_rows(t[0]) for t in M.WGMMA_TRIPLES):
            raise RuntimeError("csrc/bulge_wgmma.cu and ops/bulge_mma.py "
                               "disagree on the work item, the box or the "
                               "channel triples built")
        _wlib = lib
        return lib


def wgmma_takes(ci, cm, co, w, aligned, dtype=torch.bfloat16):
    """Can the wgmma kernel take x of `dtype`, Ci channels and width w at
    this triple: an instantiation, and a tensor map (16-byte row strides, so
    w % 8 == 0 in bf16 and w % 4 == 0 in fp32, and a 16-byte aligned
    base)."""
    per16 = 8 if dtype == torch.bfloat16 else 4
    return (ci, cm, co) in M.WGMMA_TRIPLES and w % per16 == 0 and aligned


def choose_impl(ci, cm, co, h, w, dtype=torch.float32, aligned=True):
    """The implementation `bulge()` runs at these shapes, from dtype, shape
    and alignment alone.  Either dtype: "wgmma" wherever `wgmma_takes`.
    Else float32 runs the mma.sync kernel where it has an instantiation (it
    was faster than the FMA kernel at every path shape measured, PERF.md
    section 6) and the FMA kernel elsewhere; bfloat16 runs "mma"."""
    if wgmma_takes(ci, cm, co, w, aligned, dtype):
        return "wgmma"
    if dtype == torch.bfloat16:
        return "mma"
    return "mma" if (ci, cm, co) in M.MMA_TRIPLES else "fma"


# ---------------------------------------------------------------------------
# plain version: the same function, unfused, in PyTorch
# ---------------------------------------------------------------------------

def bulge_plain(x, wT, scale, bias, wC, *, stats="pooled", running=None,
                groups=None, eps=1e-5):
    """Unfused convT -> BN -> ReLU -> conv with the statistics of `stats`.

    Returns (y, (mean, var)): y (B, Co, H, W) in x's dtype; mean/var (Cm,),
    or (B, Cm) for "per_image", or (groups, Cm), or `running` as given.

    bf16 x: the kernel's function with its rounding points.  The weights
    are rounded to bf16, both products run in fp32 (TF32 off) on the
    upcast operands, where products of bf16 values are exact; statistics,
    BN, ReLU and the edge padding are fp32; h is rounded to bf16 before the
    second product, and y after it."""
    if x.dtype != torch.bfloat16:
        return _plain_pair(x, wT, scale, bias, wC, stats, running, groups,
                           eps)
    as_bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    y, st = _plain_pair(x.float(), as_bf16(wT), scale.float(), bias.float(),
                        as_bf16(wC), stats, running, groups, eps,
                        round_hidden=as_bf16)
    return y.to(torch.bfloat16), st


def _plain_pair(x, wT, scale, bias, wC, stats, running, groups, eps,
                round_hidden=None):
    h = N.conv_transpose2d(x, wT, 2, 1)
    if stats == "running":
        mean, var = running
    else:
        mean, var = N.batch_stats(h, per_image=stats == "per_image",
                                  groups=groups if stats == "pooled" else None)
    hr = N.relu(N.normalize(h, mean, var, scale, bias, eps))
    if round_hidden is not None:
        hr = round_hidden(hr)
    return N.conv2d(hr, wC, 2, 1), (mean, var)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check(x, wT, scale, bias, wC, stats, running, groups):
    if stats not in STATS_MODES:
        raise ValueError(f"stats must be one of {STATS_MODES}, got {stats!r}")
    if groups is not None and (groups < 1 or x.shape[0] % groups):
        raise ValueError(f"batch {x.shape[0]} does not split into {groups} "
                         f"groups")
    if stats == "running" and running is None:
        raise ValueError("stats='running' needs running=(mean, var)")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, Ci, H, W), got {tuple(x.shape)}")
    ci, cm, co = x.shape[1], wT.shape[1], wC.shape[0]
    if tuple(wT.shape) != (ci, cm, 4, 4) or tuple(wC.shape) != (co, cm, 4, 4):
        raise ValueError(f"weights must be wT (Ci, Cm, 4, 4) and wC "
                         f"(Co, Cm, 4, 4); got {tuple(wT.shape)}, "
                         f"{tuple(wC.shape)} for x {tuple(x.shape)}")
    vecs = [scale, bias] + (list(running) if stats == "running" else [])
    if any(tuple(v.shape) != (cm,) for v in vecs):
        raise ValueError(f"BN vectors must be ({cm},)")
    for t in [x, wT, wC] + vecs:
        if t.device != x.device:
            raise ValueError("all bulge inputs must be on one device")


def _impl_for(impl, x, wT, wC=None):
    """The implementation a launch runs: `impl` if given (checked), else
    `choose_impl`'s for x as it is (its dtype, shape and base address).  The
    stats launch has no wC: it takes the choice of the pair it belongs to on
    the paths, Co = 2 Cm.  A bf16 x runs "wgmma" or "mma" or raises (the
    FMA kernel is fp32 only); each dtype has its own wgmma kernel."""
    ci, cm = x.shape[1], wT.shape[1]
    co = 2 * cm if wC is None else wC.shape[0]
    bf16 = x.dtype == torch.bfloat16
    aligned = x.data_ptr() % 16 == 0
    if impl is None:
        impl = choose_impl(ci, cm, co, x.shape[2], x.shape[3], x.dtype,
                           aligned)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "fma" and bf16:
        raise ValueError("the FMA bulge kernel takes float32 only; bf16 runs "
                         "impl='wgmma' or 'mma'")
    if impl == "wgmma" and not wgmma_takes(ci, cm, co, x.shape[3], aligned,
                                           x.dtype):
        raise ValueError(f"the wgmma bulge kernel takes Ci/Cm/Co in "
                         f"{M.WGMMA_TRIPLES}, W a multiple of "
                         f"{8 if bf16 else 4} ({x.dtype}) and a 16-byte "
                         f"aligned x; got Ci={ci}, Cm={cm}, Co={co}, "
                         f"W={x.shape[3]}, x at {x.data_ptr() % 16} mod 16")
    if impl == "mma" and (ci, cm, co) not in M.MMA_TRIPLES:
        raise ValueError(f"the tensor-core bulge kernel has no "
                         f"{'bf16 ' if bf16 else ''}instantiation for "
                         f"Ci={ci}, Cm={cm}, Co={co} (built: {M.MMA_TRIPLES})")
    return impl


def _count(kernel, impl, x):
    bf16 = x.dtype == torch.bfloat16
    launches[kernel + ("_bf16" if bf16 else "")] += 1
    impl_launches[impl + ("_bf16" if bf16 else "")] += 1


def _raise_failed(kernel, impl, x, err):
    if err < 0:
        raise RuntimeError(f"{kernel} ({impl}, {x.dtype}): the tensor map "
                           f"of x could not be encoded (code {err})")
    raise RuntimeError(f"{kernel} ({impl}, {x.dtype}) launch failed: "
                       f"cudaError {err}")


def launch_stats(x, wT, impl=None):
    """Stats launch: fp32 (sum, sum of squares) of h = convT(x) per (image,
    slot), shape (B, slots, 2, Cm); a slot is a work item of
    bulge_mma.Schedule ("wgmma", "mma") or a 16x16 tile ("fma").  x
    contiguous fp32 or bf16 CUDA, wT fp32 (packed in x's dtype).  impl=None
    takes `choose_impl`'s."""
    impl = _impl_for(impl, x, wT)
    bsz, ci, h, w = x.shape
    cm = wT.shape[1]
    if impl == "wgmma":
        lib = _wlib or build_wgmma()
        partial = torch.empty((bsz, M.slots_per_image(h, w), 2, cm),
                              device=x.device, dtype=torch.float32)
        w1 = M.packed_operand("wT", wT, x.dtype, "wgmma")
        entry = lib.bulge_wgmma_stats_bf16 if x.dtype == torch.bfloat16 \
            else lib.bulge_wgmma_stats_f32
        err = entry(
            x.data_ptr(), w1.data_ptr(), partial.data_ptr(), bsz, ci, cm, h,
            w, sm_count(x.device), raw_stream(x.get_device()))
        if err:
            _raise_failed("bulge_stats", impl, x, err)
        _count("bulge_stats", impl, x)
        return partial
    lib = _lib or build()
    if impl == "mma":
        slots = M.slots_per_image(h, w)
        w1 = M.packed_operand("wT", wT, x.dtype)
    else:
        t = lib.bulge_tile()
        slots = -(-h // t) * -(-w // t)
    partial = torch.empty((bsz, slots, 2, cm), device=x.device,
                          dtype=torch.float32)
    if impl == "mma":
        entry = lib.bulge_stats_bf16 if x.dtype == torch.bfloat16 else \
            lib.bulge_stats_f32
        err = entry(x.data_ptr(), w1.data_ptr(), partial.data_ptr(), bsz, ci,
                    cm, h, w, sm_count(x.device), raw_stream(x.get_device()))
    else:
        err = lib.bulge_stats_fma_f32(x.data_ptr(), wT.data_ptr(),
                                      partial.data_ptr(), bsz, ci, cm, h, w,
                                      raw_stream(x.get_device()))
    if err:
        _raise_failed("bulge_stats", impl, x, err)
    _count("bulge_stats", impl, x)
    return partial


def launch_main(x, wT, wC, mu, gain, beta, impl=None):
    """Main launch: y (B, Co, H, W) in x's dtype with h normalized as
    (h - mu) * gain + beta; mu, gain (B, Cm), beta (Cm,) contiguous fp32;
    x contiguous fp32 or bf16 CUDA; wT, wC fp32 (packed in x's dtype).
    impl=None takes `choose_impl`'s."""
    impl = _impl_for(impl, x, wT, wC)
    bsz, ci, h, w = x.shape
    cm, co = wT.shape[1], wC.shape[0]
    y = torch.empty((bsz, co, h, w), device=x.device, dtype=x.dtype)
    if impl == "wgmma":
        lib = _wlib or build_wgmma()
        w1 = M.packed_operand("wT", wT, x.dtype, "wgmma")
        w2 = M.packed_operand("wC", wC, x.dtype, "wgmma")
        entry = lib.bulge_wgmma_main_bf16 if x.dtype == torch.bfloat16 \
            else lib.bulge_wgmma_main_f32
        err = entry(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), mu.data_ptr(),
            gain.data_ptr(), beta.data_ptr(), y.data_ptr(), bsz, ci, cm, co, h,
            w, sm_count(x.device), raw_stream(x.get_device()))
        if err:
            _raise_failed("bulge_main", impl, x, err)
        _count("bulge_main", impl, x)
        return y
    lib = _lib or build()
    if impl == "mma":
        w1 = M.packed_operand("wT", wT, x.dtype)
        w2 = M.packed_operand("wC", wC, x.dtype)
        entry = lib.bulge_main_bf16 if x.dtype == torch.bfloat16 else \
            lib.bulge_main_f32
        err = entry(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), mu.data_ptr(),
                    gain.data_ptr(), beta.data_ptr(), y.data_ptr(), bsz, ci,
                    cm, co, h, w, sm_count(x.device),
                    raw_stream(x.get_device()))
    else:
        err = lib.bulge_main_fma_f32(x.data_ptr(), wT.data_ptr(),
                                     wC.data_ptr(), mu.data_ptr(),
                                     gain.data_ptr(), beta.data_ptr(),
                                     y.data_ptr(), bsz, ci, cm, co, h, w,
                                     raw_stream(x.get_device()))
    if err:
        _raise_failed("bulge_main", impl, x, err)
    _count("bulge_main", impl, x)
    return y


def bulge(x, wT, scale, bias, wC, *, stats="pooled", running=None,
          groups=None, eps=1e-5, impl=None):
    """y = conv_k4s2p1(relu(bn(convT_k4s2p1(x)))) and the BN (mean, var).

    x (B, Ci, H, W) fp32 or bf16 (y in x's dtype); wT (Ci, Cm, 4, 4) IOHW;
    wC (Co, Cm, 4, 4) OIHW; scale, bias (Cm,).  See the module docstring for
    `stats`, `groups` and `impl` (CUDA only; None = `choose_impl`).  The
    whole call is the span `bulge` (utils/profiling.py)."""
    with span("bulge"):
        return _bulge(x, wT, scale, bias, wC, stats, running, groups, eps,
                      impl)


def _bulge(x, wT, scale, bias, wC, stats, running, groups, eps, impl):
    _check(x, wT, scale, bias, wC, stats, running, groups)
    if stats != "pooled":
        groups = None
    if x.device.type == "cpu":
        return bulge_plain(x, wT, scale, bias, wC, stats=stats,
                           running=running, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"bulge runs on cpu or cuda, not {x.device.type}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the bulge kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    bsz, ci, h, w = x.shape
    cm, co = wT.shape[1], wC.shape[0]
    x = x.contiguous()
    impl = _impl_for(impl, x, wT, wC)
    if impl == "wgmma":
        build_wgmma()
    else:
        lib = build()
        if not lib.bulge_supported(cm, co):
            raise ValueError(f"the bulge kernel has no instantiation for "
                             f"Cm={cm}, Co={co} (built: 4/8, 8/16, 16/32)")
        if impl == "fma":
            smem = lib.bulge_main_smem_bytes(ci, cm, co)
        elif x.dtype == torch.bfloat16:
            smem = lib.bulge_mma_bf16_smem_bytes(cm)
        else:
            smem = lib.bulge_mma_smem_bytes(cm)
        if smem > 227 * 1024:
            raise ValueError(f"bulge tile needs {smem} B of shared memory "
                             f"(Ci={ci}); the card offers 232448")
    if wT.dtype != torch.float32 or not wT.is_contiguous():
        wT = wT.float().contiguous()
    if wC.dtype != torch.float32 or not wC.is_contiguous():
        wC = wC.float().contiguous()
    with torch.cuda.device(x.device):
        if stats == "running":
            mean, var = running[0].float(), running[1].float()
            mu, v = mean.expand(bsz, cm), var.expand(bsz, cm)
        else:
            g = bsz if stats == "per_image" else (groups or 1)
            mean, var = M.reduce_partials(launch_stats(x, wT, impl),
                                          4 * h * w, g)      # (g, Cm)
            mu = mean.repeat_interleave(bsz // g, dim=0)
            v = var.repeat_interleave(bsz // g, dim=0)
            if stats == "pooled" and groups is None:
                mean, var = mean[0], var[0]
        gain = torch.rsqrt(v + eps) * scale.float()
        y = launch_main(x, wT, wC, mu.contiguous(), gain.contiguous(),
                        bias.float().contiguous(), impl)
    return y, (mean, var)


def tf32_probe(a, b):
    """d (64, 32) = a (64, 16) @ B by csrc/bulge_wgmma.cu's layout probe:
    two k-steps of wgmma m64n32k8 .tf32 with A from registers, a's fp32
    words passed unsplit, and b the flat `to_wgmma_tf32` layout of B
    (16, 32) in shared memory as given.  What the card returns shows how
    wgmma reads an fp32 word as TF32 and pins the core-matrix layout the
    fp32 kernels use (chip_smoke.py, tests/test_torch_cuda.py).  Counts no
    launch: it is no kernel of a path."""
    if a.device.type != "cuda" or a.shape != (64, 16) or b.numel() != 512:
        raise ValueError("tf32_probe takes a (64, 16) and b (512,) fp32 on "
                         "the card")
    a, b = a.float().contiguous(), b.float().contiguous()
    d = torch.empty((64, 32), device=a.device, dtype=torch.float32)
    lib = _wlib or build_wgmma()
    err = lib.bulge_wgmma_tf32_probe(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                     raw_stream(a.get_device()))
    if err:
        raise RuntimeError(f"tf32_probe launch failed: cudaError {err}")
    return d
