"""The fused pair in its channels-last, row-band, packed-weight formulation.

Port of dcgan_sr_tpu/ops/pallas_fused.py fused_convT_bn_relu_conv: the same
function as ops/bulge.py, y = conv_k4s2p1(relu(bn(convT_k4s2p1(x)))) with
train-mode batch statistics of the hidden tensor, computed the way that
kernel computes it:

  * x goes NHWC and is cut into bands of `tm` rows;
  * convT is one product over K = 4*Ci: position (i, j)'s 2x2 window of x
    against the packed weight `wtall` (4Ci, 4Cm) gives all four output
    parities at once, p[i, j, (di, dj, cm)] = h[2i - di, 2j - dj, cm];
  * BN + ReLU run on the parity planes, and the cells that are the
    consumer's zero padding are zeroed;
  * the consumer conv is one product over K = 16*Cm: a 2x2 window from each
    parity plane against the packed weight `wcall` (16Cm, Co).

`fused_convT_bn_relu_conv()` is the entry, with the JAX function's signature
and return.  On a CPU tensor it runs `fused_nhwc_plain()`, the same packed
formulation in PyTorch; on a CUDA tensor it launches a hand-written kernel
(a stats launch and a main launch) and nothing else.
The NCHW <-> NHWC transposes are torch calls around the launches, as they
are XLA's around the Pallas calls.  Nothing in the served or trained paths
calls this module: like its JAX counterpart it is reached from the
bench_fused tool (--kernel nhwc).

Three implementations (`impl=`), none ever a fallback for another; an
explicit `impl=` is for measurements and tests, `choose_impl` picks one from
dtype, shapes and alignment alone:
  "wgmma"  csrc/fused_nhwc_wgmma.cu (host side ops/fused_nhwc_wgmma.py),
           the pair redesigned for Hopper's units in both dtypes: x by TMA
           straight into wgmma's K-major layout, both products on wgmma
           (fp32 as 3xTF32 with A split in registers, bf16 one pass with A
           by descriptor).  Chosen in both dtypes at (16, 8, 16) and
           (32, 16, 32) whenever its tensor maps take x (a 16-byte aligned
           base, which the wrapper's NHWC copy always has).
  "mma"    csrc/fused_nhwc.cu, both packed products on mma.sync as
           error-compensated TF32 products in a persistent grid (host side
           ops/fused_nhwc_mma.py), at the three triples it is built for;
           chosen at (8, 4, 8).
  "fma"    csrc/fused_nhwc.cu, the first fp32 FMA kernel, every triple;
           chosen in fp32 where no tensor-core kernel was built.
`fused_nhwc_packed(impl=)` is a tensor-core implementation's arithmetic in
PyTorch, item by item from the same operands.

bf16 (x in bfloat16, the JAX function with bf16 x): the mma.sync
kernel's bf16 instantiation (namespace tcb), one bf16 mma (m16n8k16, fp32
accumulators) a product.  The packed weights are rounded to bf16
(pallas_fused.py:193-194); the statistics, BN, ReLU and the edge mask are
fp32 (:108-116, :131-152); the planes are rounded to bf16 before the
consumer product (:153) and y is bf16 (:168, :239); the moments stay fp32.
The wgmma kernel's bf16 instantiation keeps the same rounding points.
"fma" has no bf16 instantiation and refuses bf16 by name.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import fused_nhwc_mma as M
from . import fused_nhwc_wgmma as WG
from ._build import compile_and_load, raw_stream, sm_count

IMPLS = ("mma", "fma", "wgmma")

# Launches of each kernel in this process: a wrapper adds one where it
# launches its kernel, and nowhere else (CPU calls run the plain version).
launches = {"fused_nhwc_stats": 0, "fused_nhwc_main": 0,
            "fused_nhwc_stats_bf16": 0, "fused_nhwc_main_bf16": 0}
# The same launches by the implementation that ran (both kernels of a pair
# counted); bf16 launches under "mma_bf16" and "wgmma_bf16".
impl_launches = {"mma": 0, "fma": 0, "wgmma": 0, "mma_bf16": 0,
                 "wgmma_bf16": 0}

_lib = None
_lib_lock = threading.Lock()
build_log = ""
_wlib = None
_wlib_lock = threading.Lock()
wgmma_build_log = ""


def build():
    """Compile csrc/fused_nhwc.cu (once per source content, ops/_build.py)
    and load it."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_and_load("fused_nhwc")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("fused_nhwc_chunk", "fused_nhwc_pass_rows",
                     "fused_nhwc_chunk_cols"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [], i
        lib.fused_nhwc_mma_supported.argtypes = [i, i, i]
        lib.fused_nhwc_mma_supported.restype = i
        lib.fused_nhwc_smem_bytes.argtypes = [i, i, i]
        lib.fused_nhwc_smem_bytes.restype = ctypes.c_size_t
        lib.fused_nhwc_stats_f32.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.fused_nhwc_stats_f32.restype = i
        lib.fused_nhwc_main_f32.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.fused_nhwc_main_f32.restype = i
        lib.fused_nhwc_stats_bf16.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.fused_nhwc_stats_bf16.restype = i
        lib.fused_nhwc_main_bf16.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.fused_nhwc_main_bf16.restype = i
        lib.fused_nhwc_stats_fma_f32.argtypes = [p, p, p] + [i] * 6 + [p]
        lib.fused_nhwc_stats_fma_f32.restype = i
        lib.fused_nhwc_main_fma_f32.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.fused_nhwc_main_fma_f32.restype = i
        if (lib.fused_nhwc_pass_rows(), lib.fused_nhwc_chunk_cols()) != (
                M.PASS_ROWS, M.CHUNK_COLS) or not all(
                    lib.fused_nhwc_mma_supported(*t) for t in M.MMA_TRIPLES):
            raise RuntimeError("csrc/fused_nhwc.cu and ops/fused_nhwc_mma.py "
                               "disagree on the work item's size or the "
                               "channel triples built")
        _lib = lib
        return lib


def build_wgmma():
    """Compile csrc/fused_nhwc_wgmma.cu (once per source content) and load
    it."""
    global _wlib, wgmma_build_log
    with _wlib_lock:
        if _wlib is not None:
            return _wlib
        lib, wgmma_build_log = compile_and_load("fused_nhwc_wgmma")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("fused_nhwc_wgmma_rows", "fused_nhwc_wgmma_stats_cols"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [], i
        lib.fused_nhwc_wgmma_main_cols.argtypes = [i, i]
        lib.fused_nhwc_wgmma_main_cols.restype = i
        lib.fused_nhwc_wgmma_supported.argtypes = [i, i, i]
        lib.fused_nhwc_wgmma_supported.restype = i
        for dt in ("f32", "bf16"):
            stats = getattr(lib, f"fused_nhwc_wgmma_stats_{dt}")
            stats.argtypes, stats.restype = [p, p, p] + [i] * 6 + [p], i
            main = getattr(lib, f"fused_nhwc_wgmma_main_{dt}")
            main.argtypes, main.restype = [p] * 5 + [i] * 7 + [p], i
        geometry = [(lib.fused_nhwc_wgmma_rows(), WG.ROWS),
                    (lib.fused_nhwc_wgmma_stats_cols(), WG.STATS_COLS)]
        for ci, _, _ in WG.TRIPLES:
            for dtype in (torch.float32, torch.bfloat16):
                geometry.append((lib.fused_nhwc_wgmma_main_cols(
                    ci, dtype == torch.float32), WG.main_cols(ci, dtype)))
        if any(a != b for a, b in geometry) or not all(
                lib.fused_nhwc_wgmma_supported(*t) for t in WG.TRIPLES):
            raise RuntimeError("csrc/fused_nhwc_wgmma.cu and "
                               "ops/fused_nhwc_wgmma.py disagree on the work "
                               "items or the channel triples built")
        _wlib = lib
        return lib


def built_for(impl, ci, cm, co):
    """Does implementation `impl` have an instantiation for (Ci, Cm, Co)?"""
    if impl == "fma":
        return True
    return (ci, cm, co) in (WG.TRIPLES if impl == "wgmma" else M.MMA_TRIPLES)


def choose_impl(ci, cm, co, h, w, dtype=torch.float32, aligned=True):
    """The implementation `fused_convT_bn_relu_conv` runs at these shapes,
    from dtype, shape and alignment alone: "wgmma" (either dtype) at the
    triples it was built for when its tensor maps take x (a 16-byte aligned
    base); else the mma.sync kernel where it has an instantiation, and in
    fp32 the FMA kernel elsewhere (PERF.md section 6 has all three timed in
    turns)."""
    if built_for("wgmma", ci, cm, co) and aligned:
        return "wgmma"
    if dtype == torch.bfloat16 or built_for("mma", ci, cm, co):
        return "mma"
    return "fma"


def _impl_for(impl, ci, cm, co, h, w, bf16=False):
    """`impl` if given (checked), else `choose_impl`'s for the wrapper's
    NHWC copy of x, whose base is always 16-byte aligned."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    if impl is None:
        impl = choose_impl(ci, cm, co, h, w, dtype)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "fma" and bf16:
        raise ValueError("the FMA NHWC kernel takes float32 only; bf16 runs "
                         "impl='mma' or 'wgmma'")
    if not built_for(impl, ci, cm, co):
        name, built = (("wgmma", WG.TRIPLES) if impl == "wgmma"
                       else ("tensor-core", M.MMA_TRIPLES))
        raise ValueError(f"the {name} NHWC kernel has no "
                         f"{'bf16 ' if bf16 else ''}instantiation for "
                         f"Ci={ci}, Cm={cm}, Co={co} (built: {built})")
    return impl


# ---------------------------------------------------------------------------
# packed weights
# ---------------------------------------------------------------------------

def _pack_wT(wT):
    """(Ci, Cm, 4, 4) IOHW -> (4*Ci, 4*Cm): rows (ti, tj, ci), cols
    (di, dj, cm); block (ti, tj; di, dj) is wT[:, :, 3-di-2ti, 3-dj-2tj]."""
    ci, cm = wT.shape[0], wT.shape[1]
    out = wT.new_zeros((4 * ci, 4 * cm))
    for ti in (0, 1):
        for tj in (0, 1):
            r = ti * 2 + tj
            for di in (0, 1):
                for dj in (0, 1):
                    c = di * 2 + dj
                    out[r * ci:(r + 1) * ci, c * cm:(c + 1) * cm] = \
                        wT[:, :, 3 - di - 2 * ti, 3 - dj - 2 * tj]
    return out


def _pack_wC(wC):
    """(Co, Cm, 4, 4) OIHW -> (16*Cm, Co): rows (k = di*2+dj, sa, sb, cm).
    An even-row plane (di = 0) feeds kernel rows a = 1 + 2*sa, an odd-row
    plane a = 2*sa; columns likewise."""
    co, cm = wC.shape[0], wC.shape[1]
    out = wC.new_zeros((16 * cm, co))
    for k in range(4):
        di, dj = k // 2, k % 2
        for sa in (0, 1):
            a = (1 + 2 * sa) if di == 0 else 2 * sa
            for sb in (0, 1):
                b = (1 + 2 * sb) if dj == 0 else 2 * sb
                r = (k * 2 + sa) * 2 + sb
                out[r * cm:(r + 1) * cm, :] = wC[:, :, a, b].T
    return out


# ---------------------------------------------------------------------------
# plain version: the same packed, banded formulation in PyTorch
# ---------------------------------------------------------------------------

def _band_parts(xl, t, tm, wtall):
    """Band t of the padded NHWC input -> parity planes (B, tm+1, W+1, 4Cm):
    the four shifted 2x2 windows side by side, times the packed weight."""
    w = xl.shape[2] - 2
    xw = xl[:, t * tm:t * tm + tm + 2]                   # (B, tm+2, W+2, Ci)
    xp = torch.cat([xw[:, ti:ti + tm + 1, tj:tj + w + 1]
                    for ti in (0, 1) for tj in (0, 1)], dim=-1)
    return xp @ wtall


def _pad_nhwc(x):
    """(B, Ci, H, W) -> NHWC with one zero row and column on every side."""
    return torch.nn.functional.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))


def plain_stats(xl, wtall, tm):
    """Phase 1 in PyTorch: (mean, biased var) of the hidden tensor from the
    padded NHWC input, each hidden cell counted once: even rows live at plane
    positions [0, tm), odd rows at [1, tm]; columns alike."""
    bsz, h, w = xl.shape[0], xl.shape[1] - 2, xl.shape[2] - 2
    cm = wtall.shape[1] // 4
    s = xl.new_zeros(cm)
    sq = xl.new_zeros(cm)
    for t in range(h // tm):
        p = _band_parts(xl, t, tm, wtall)
        for k in range(4):
            di, dj = k // 2, k % 2
            blk = p[:, di:di + tm, dj:dj + w, k * cm:(k + 1) * cm]
            s = s + blk.sum(dim=(0, 1, 2))
            sq = sq + (blk * blk).sum(dim=(0, 1, 2))
    n = bsz * (2 * h) * (2 * w)
    mean = s / n
    return mean, sq / n - mean * mean                    # biased (torch BN)


def plain_main(xl, wtall, wcall, mean, gain, bias, tm, round_parts=None):
    """Phase 2 in PyTorch: recompute the planes, normalize, mask the
    consumer's padding, (`round_parts`: round them,) consume.  Returns y
    (B, H, W, Co) NHWC."""
    h, w = xl.shape[1] - 2, xl.shape[2] - 2
    cm = wtall.shape[1] // 4
    n_tiles = h // tm
    rows = torch.arange(tm + 1, device=xl.device)[:, None]
    cols = torch.arange(w + 1, device=xl.device)[None, :]
    bands = []
    for t in range(n_tiles):
        p = _band_parts(xl, t, tm, wtall)
        p = (p - mean.repeat(4)) * gain.repeat(4) + bias.repeat(4)
        p = torch.clamp_min(p, 0)
        parts = []
        for k in range(4):
            di, dj = k // 2, k % 2
            m = (cols == w) if dj == 0 else (cols == 0)   # h col 2W / -1
            if di == 0 and t == n_tiles - 1:
                m = m | (rows == tm)                     # h row 2H
            if di == 1 and t == 0:
                m = m | (rows == 0)                      # h row -1
            blk = p[..., k * cm:(k + 1) * cm]
            parts.append(torch.where(m[None, :, :, None],
                                     torch.zeros_like(blk), blk))
        yp = torch.cat([parts[k][:, sa:sa + tm, sb:sb + w]
                        for k in range(4) for sa in (0, 1) for sb in (0, 1)],
                       dim=-1)                           # (B, tm, W, 16Cm)
        if round_parts is not None:
            yp = round_parts(yp)
        bands.append(yp @ wcall)
    return torch.cat(bands, dim=1)


def fused_nhwc_plain(x, wT, scale, bias, wC, *, eps=1e-5, tm=32):
    """fused_convT_bn_relu_conv in plain PyTorch, band by band as the kernel
    goes: returns (y (B, Co, H, W) in x's dtype, (mean, biased_var)).

    bf16 x: the JAX kernel's rounding points.  The packed weights are
    rounded to bf16; both products run in fp32 (TF32 off) on the upcast
    operands, where products of bf16 values are exact; the statistics, BN,
    ReLU and the edge mask are fp32; the planes are rounded to bf16 before
    the consumer product, and y after it."""
    if x.dtype != torch.bfloat16:
        return _plain_pair(x, wT, scale, bias, wC, eps, tm)
    as_bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    y, st = _plain_pair(x.float(), as_bf16(wT), scale.float(), bias.float(),
                        as_bf16(wC), eps, tm, round_parts=as_bf16)
    return y.to(torch.bfloat16), st


def _plain_pair(x, wT, scale, bias, wC, eps, tm, round_parts=None):
    xl = _pad_nhwc(x)
    wtall, wcall = _pack_wT(wT), _pack_wC(wC)
    mean, var = plain_stats(xl, wtall, tm)
    gain = scale / torch.sqrt(var + eps)
    y = plain_main(xl, wtall, wcall, mean, gain, bias, tm, round_parts)
    return y.permute(0, 3, 1, 2).contiguous(), (mean, var)


_index_cache = {}


def _operand_index(kind, ci, cm, co, device, bf16=False):
    """Flat gather indices of wT (kind "wT", into wT's elements) or wC
    ("wC") into the tensor-core kernel's operand (bf16: its bf16
    instantiation's); the padding points one past the weight's end, where
    `operands` keeps a zero.  The JAX packers run on an index tensor, so the
    operand is theirs element for element."""
    key = (kind, ci, cm, co, str(device), bf16)
    if key not in _index_cache:
        if kind == "wT":
            n = ci * cm * 16
            idx = M.w1_operand_index(
                _pack_wT(torch.arange(n).reshape(ci, cm, 4, 4)), ci, cm, n,
                bf16)
        else:
            n = co * cm * 16
            idx = M.w2_operand_index(
                _pack_wC(torch.arange(n).reshape(co, cm, 4, 4)), cm, co, n,
                bf16)
        _index_cache[key] = idx.to(device)
    return _index_cache[key]


def operands(wT, wC, impl, dtype=torch.float32):
    """The kernel's two weight operands, contiguous on the weights' device:
    wtall (4Ci, 4Cm) and wcall (16Cm, Co) for "fma"; W1 and W2 in fragment
    order (ops/fused_nhwc_mma.py) for "mma", in `dtype` (fp32, or bf16 for
    the bf16 instantiation: the fp32 weights rounded once); for "wgmma" W1
    and W2 in wgmma's K-major layout (ops/fused_nhwc_wgmma.py operands: fp32
    as (hi, lo) planes, bf16 one plane)."""
    wT, wC = wT.detach().float(), wC.detach().float()
    if impl == "fma":
        return _pack_wT(wT).contiguous(), _pack_wC(wC).contiguous()
    if impl == "wgmma":
        return WG.operands(_pack_wT(wT), _pack_wC(wC), dtype)
    ci, cm, co = wT.shape[0], wT.shape[1], wC.shape[0]
    bf16 = dtype == torch.bfloat16
    return tuple(torch.cat([w.reshape(-1), w.new_zeros(1)])[
        _operand_index(kind, ci, cm, co, w.device, bf16)].to(dtype)
        for kind, w in (("wT", wT), ("wC", wC)))


def _moments(partial, n):
    """(mean, biased var) of the hidden tensor from the stats launch's
    slots: a fixed-order fp64 reduction; n = hidden cells."""
    sums = partial.double().sum(dim=tuple(range(partial.dim() - 2)))
    m64 = sums[0] / n
    return m64.float(), (sums[1] / n - m64 * m64).float()


def _bn_rows(mean, var, scale, bias, eps):
    """(3, 4Cm): mean, gain and bias, each tiled over the four parities."""
    gain = torch.rsqrt(var + eps) * scale.float()
    return torch.stack([mean.repeat(4), gain.repeat(4),
                        bias.float().repeat(4)]).contiguous()


def fused_nhwc_packed(x, wT, scale, bias, wC, *, eps=1e-5, tm=32,
                      impl="mma"):
    """A tensor-core implementation's arithmetic in PyTorch: the wrapper's
    steps, with the two launches emulated item by item from the kernel's
    own operands (a bf16 x: its bf16 instantiation's).  impl "mma":
    ops/fused_nhwc_mma.py's packed_stats and packed_main, any channel
    counts (the operands pad Ci, Cm and Co to multiples of 8); "wgmma":
    ops/fused_nhwc_wgmma.py's emulate_stats and emulate_main, at the
    triples it was built for.  Returns (y (B, Co, H, W) in x's dtype, (mean,
    biased_var))."""
    bsz, ci, h, w = x.shape
    cm, co = wT.shape[1], wC.shape[0]
    xn = x.permute(0, 2, 3, 1).contiguous()
    w1, w2 = operands(wT, wC, impl, x.dtype)
    if impl == "wgmma":
        partial = WG.emulate_stats(xn, w1, ci, cm)
    else:
        partial = M.packed_stats(xn, w1, ci, cm, tm)
    mean, var = _moments(partial, 4.0 * h * w * bsz)
    bn = _bn_rows(mean, var, scale, bias, eps)
    if impl == "wgmma":
        y = WG.emulate_main(xn, w1, w2, bn, ci, cm, co)
    else:
        y = M.packed_main(xn, w1, w2, bn, ci, cm, co, tm)
    return y.permute(0, 3, 1, 2).contiguous(), (mean, var)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check(x, wT, scale, bias, wC, tm):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, Ci, H, W), got {tuple(x.shape)}")
    ci, cm, co = x.shape[1], wT.shape[1], wC.shape[0]
    if tuple(wT.shape) != (ci, cm, 4, 4) or tuple(wC.shape) != (co, cm, 4, 4):
        raise ValueError(f"weights must be wT (Ci, Cm, 4, 4) and wC "
                         f"(Co, Cm, 4, 4); got {tuple(wT.shape)}, "
                         f"{tuple(wC.shape)} for x {tuple(x.shape)}")
    if tuple(scale.shape) != (cm,) or tuple(bias.shape) != (cm,):
        raise ValueError(f"BN vectors must be ({cm},)")
    if tm < 1 or x.shape[2] % tm:
        raise ValueError(f"H = {x.shape[2]} must be a multiple of the band "
                         f"height tm = {tm}")
    for t in (wT, scale, bias, wC):
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")


def _count(kernel, impl, xn):
    bf16 = xn.dtype == torch.bfloat16
    launches[kernel + ("_bf16" if bf16 else "")] += 1
    impl_launches[impl + ("_bf16" if bf16 else "")] += 1


def launch_stats(xn, w1, cm, tm, impl):
    """Stats launch: fp32 (sum, sum of squares) of h per (image, slot), shape
    (B, slots, 2, Cm); a slot is a work item of fused_nhwc_mma.Schedule
    ("mma": H/tm bands x ceil(tm/8) passes x ceil(W/32) chunks), of
    fused_nhwc_wgmma.Schedule ("wgmma": ceil(H/8) bands x ceil(W/32)
    chunks) or a block of the FMA kernel ("fma": H/tm bands x ceil(W/32)
    chunks).  xn (B, H, W, Ci) NHWC and w1 (`operands`' first for `impl`):
    contiguous CUDA, fp32, or both bf16 for a bf16 instantiation."""
    bsz, h, w, ci = xn.shape
    bf16 = xn.dtype == torch.bfloat16
    if impl == "wgmma":
        lib = _wlib or build_wgmma()
        slots = WG.Schedule(1, h, w).per_image
    else:
        lib = _lib or build()
        if impl == "mma":
            slots = M.Schedule(1, h, w, tm).per_image
        else:
            slots = h // tm * -(-w // lib.fused_nhwc_chunk())
    partial = torch.empty((bsz, slots, 2, cm), device=xn.device,
                          dtype=torch.float32)
    stream = raw_stream(xn.get_device())
    if impl == "wgmma":
        entry = lib.fused_nhwc_wgmma_stats_bf16 if bf16 \
            else lib.fused_nhwc_wgmma_stats_f32
        err = entry(xn.data_ptr(), w1.data_ptr(), partial.data_ptr(), bsz, h,
                    w, ci, cm, sm_count(xn.device), stream)
    elif impl == "mma":
        entry = lib.fused_nhwc_stats_bf16 if bf16 \
            else lib.fused_nhwc_stats_f32
        err = entry(xn.data_ptr(), w1.data_ptr(), partial.data_ptr(), bsz, h,
                    w, ci, cm, tm, sm_count(xn.device), stream)
    else:
        err = lib.fused_nhwc_stats_fma_f32(xn.data_ptr(), w1.data_ptr(),
                                           partial.data_ptr(), bsz, h, w, ci,
                                           cm, tm, stream)
    if err:
        raise RuntimeError(f"fused_nhwc_stats ({impl}) launch failed: "
                           f"cudaError {err}")
    _count("fused_nhwc_stats", impl, xn)
    return partial


def launch_main(xn, w1, w2, bn, cm, co, tm, impl):
    """Main launch: y (B, H, W, Co) NHWC in xn's dtype.  bn (3, 4Cm) fp32:
    mean, gain and bias, each tiled over the four parities; w1, w2
    `operands`' for `impl` (bf16 for a bf16 xn); all contiguous CUDA."""
    bsz, h, w, ci = xn.shape
    bf16 = xn.dtype == torch.bfloat16
    lib = (_wlib or build_wgmma()) if impl == "wgmma" else (_lib or build())
    y = torch.empty((bsz, h, w, co), device=xn.device, dtype=xn.dtype)
    stream = raw_stream(xn.get_device())
    if impl == "wgmma":
        entry = lib.fused_nhwc_wgmma_main_bf16 if bf16 \
            else lib.fused_nhwc_wgmma_main_f32
        err = entry(xn.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                    bn.data_ptr(), y.data_ptr(), bsz, h, w, ci, cm, co,
                    sm_count(xn.device), stream)
    elif impl == "mma":
        entry = lib.fused_nhwc_main_bf16 if bf16 \
            else lib.fused_nhwc_main_f32
        err = entry(xn.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                    bn.data_ptr(), y.data_ptr(), bsz, h, w, ci, cm, co, tm,
                    sm_count(xn.device), stream)
    else:
        err = lib.fused_nhwc_main_fma_f32(xn.data_ptr(), w1.data_ptr(),
                                          w2.data_ptr(), bn.data_ptr(),
                                          y.data_ptr(), bsz, h, w, ci, cm, co,
                                          tm, stream)
    if err:
        raise RuntimeError(f"fused_nhwc_main ({impl}) launch failed: "
                           f"cudaError {err}")
    _count("fused_nhwc_main", impl, xn)
    return y


def fused_convT_bn_relu_conv(x, wT, scale, bias, wC, *, eps=1e-5, tm=32,
                             impl=None):
    """y = conv_s2p1k4(relu(bn(convT_s2p1k4(x)))) without storing the
    2x-resolution hidden tensor.

    x: (B, Ci, H, W) fp32 or bf16 (y in x's dtype), H a multiple of tm; wT:
    (Ci, Cm, 4, 4) IOHW; wC: (Co, Cm, 4, 4) OIHW (fp32; packed in x's
    dtype); scale/bias: (Cm,).  Returns (y: (B, Co, H, W), (mean,
    biased_var)) with train-mode batch statistics of the hidden tensor, in
    fp32.  impl (CUDA only): "wgmma", "mma" or "fma", None =
    `choose_impl`'s."""
    _check(x, wT, scale, bias, wC, tm)
    bsz, ci, h, w = x.shape
    cm, co = wT.shape[1], wC.shape[0]
    impl = _impl_for(impl, ci, cm, co, h, w, x.dtype == torch.bfloat16)
    if x.device.type == "cpu":
        return fused_nhwc_plain(x, wT, scale, bias, wC, eps=eps, tm=tm)
    if x.device.type != "cuda":
        raise ValueError(f"runs on cpu or cuda, not {x.device.type}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    lib = build_wgmma() if impl == "wgmma" else build()
    if impl == "fma":
        if 4 * cm > 256:
            raise ValueError(f"the kernel takes Cm <= 64, got {cm}")
        smem = lib.fused_nhwc_smem_bytes(ci, cm, co)
        if smem > 227 * 1024:
            raise ValueError(f"a band pass needs {smem} B of shared memory "
                             f"(Ci={ci}, Cm={cm}, Co={co}); the card offers "
                             f"232448")
    with torch.cuda.device(x.device):
        # the kernels and the tensor maps take x 16 bytes at a time
        xn = x.permute(0, 2, 3, 1).contiguous()
        if xn.data_ptr() % 16:
            xn = xn.clone()
        w1, w2 = operands(wT, wC, impl, x.dtype)
        mean, var = _moments(launch_stats(xn, w1, cm, tm, impl),
                             4.0 * h * w * bsz)
        y = launch_main(xn, w1, w2, _bn_rows(mean, var, scale, bias, eps), cm,
                        co, tm, impl)
    return y.permute(0, 3, 1, 2).contiguous(), (mean, var)
