"""A stride-1, "same"-padded bf16 convolution with few output channels on
the card: SRGAN's 9x9 64->3 tail conv.

cuDNN runs SRGAN's tail conv (x (16, 64, 1024, 1024) bf16, w (3, 64, 9, 9))
as an implicit GEMM whose tiles are 32 output channels wide, 3 of them used,
between two layout transposes of the 2.15 GB map: 27.6 ms a call.
csrc/conv_narrow.cu computes the same function reading x once in its NCHW
layout on wgmma, with the horizontal taps folded into the product's columns
(the source's note), fp32 sums and the bias added in fp32 before the one
rounding to bf16.  It replaces no Pallas kernel: the JAX package leaves
its convolutions to XLA.

`takes(x, w, stride, padding, bias)` is the rule ops/nn.py conv2d follows,
read from the input alone: x a 4-D bf16 CUDA tensor, no gradient to carry
(not grad mode with any of x, w or bias requiring grad), and a shape the
kernel takes (`fits`): stride 1, a square odd kernel up to 9 with padding
k // 2, Cout <= 8 and Cin a multiple of 16 up to 64.  Then `conv` launches
the kernel and nothing else; everything else runs cuDNN as before.

`plan` picks the launch (warps a block, rows a block, shared memory) and
`pack_weights` lays w out as the kernel reads it; `emulate` runs the
kernel's arithmetic in float64 from the same plan and packing on the CPU,
so the CPU tests hold both to the convolution.  `plain` is the function
itself in plain PyTorch (fp32 sums of the bf16 operands, one rounding).

Counters (utils/profiling.py `counters`): "conv_narrow" counts the kernel's
launches; "conv_narrow_plain" the bf16 CUDA calls of a shape the kernel
fits (`fits`) that the rule sent to cuDNN, for a gradient to carry.
conv_narrow / (conv_narrow + conv_narrow_plain) is the share of the calls
the kernel could take that it took; a shape it does not fit (a stride-2
tail) counts in neither.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch
import torch.nn.functional as F

from ..utils.profiling import counters
from ._build import compile_and_load, raw_stream, sm_count

OUT_W = 56      # output columns of a block's strip
M = 64          # input columns of a strip (wgmma's M): OUT_W and a 4-column halo each side
XP = 64         # columns of a strip's channel row in shared memory (128 B)
PPX = 68        # floats in a row of a warpgroup's tile of partial sums
WIDTHS = (16, 32, 48, 80)   # the wgmma widths N the kernel is built for
MAX_COUT, MAX_K, MAX_CIN = 8, 9, 64

_lib = None
_lib_lock = threading.Lock()
_smem_limit = {}
build_log = ""


def build():
    """Compile csrc/conv_narrow.cu (once per source content) and load it."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_and_load("conv_narrow")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conv_narrow_smem_limit.argtypes = [i]
        lib.conv_narrow_smem_limit.restype = ll
        lib.conv_narrow_bf16.argtypes = [p, p, p, p] + [ll] * 10 + [i, p]
        lib.conv_narrow_bf16.restype = i
        _lib = lib
        return lib


def fits(w_shape, stride, padding):
    """Does the kernel take a convolution of weight shape (Cout, Cin, k, k)
    at this stride and padding."""
    cout, cin, kh, kw = w_shape
    return (stride == 1 and kh == kw and kh % 2 == 1 and kh <= MAX_K
            and padding == kh // 2 and cout <= MAX_COUT
            and cin % 16 == 0 and 16 <= cin <= MAX_CIN)


def takes(x, w, stride, padding, bias=None):
    """Does conv2d(x, w) run on the kernel: see the module docstring."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4
            and fits(tuple(w.shape), stride, padding)
            and not (torch.is_grad_enabled() and (
                x.requires_grad or w.requires_grad
                or (bias is not None and bias.requires_grad))))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `groups` warpgroups a block (output rows in flight),
    `rows` a block, `n` the wgmma width, `smem` bytes of shared memory,
    `grid` (strips, row runs, images)."""
    groups: int
    rows: int
    n: int
    smem: int
    grid: tuple


def smem_bytes(cin, cout, k, groups, n):
    """Shared memory of a block: the ring of k - 1 + 3 * groups input rows,
    the packed weights (wgmma width n) and each warpgroup's tile of partial
    sums (Cout * k rows)."""
    return ((k - 1 + 3 * groups) * cin * XP * 2 + k * cin * n * 2
            + groups * cout * k * PPX * 4)


@functools.lru_cache(maxsize=64)
def plan(n, cin, h, w, cout, k, smem_limit, sms):
    """The launch for x (n, cin, h, w) and w (cout, cin, k, k): the
    narrowest wgmma width that holds Cout * k, the most rows in flight that
    fit in `smem_limit`, and the rows a block that fill `sms` SMs in the
    fewest whole waves of one block an SM (each block also reads its rows'
    k - 1 halo rows)."""
    width = next(v for v in WIDTHS if v >= cout * k)
    for groups in (4, 2, 1):
        smem = smem_bytes(cin, cout, k, groups, width)
        if smem <= smem_limit:
            break
    else:
        raise ValueError(f"no launch of the kernel fits {smem_limit} bytes "
                         f"of shared memory at Cin {cin}, Cout {cout}, k {k}")
    strips = -(-(w + 4) // OUT_W)       # strip s outputs columns 56 s - 4 ..
    steps = -(-h // groups)
    best = None
    for runs in range(1, steps + 1):
        rows = groups * -(-steps // runs)
        blocks = strips * n * -(-h // rows)
        cost = -(-blocks // sms) * (rows + k - 1 + 3 * groups)
        if best is None or cost < best[0]:
            best = (cost, rows)
    rows = best[1]
    return Plan(groups, rows, width, smem, (strips, -(-h // rows), n))


def pack_weights(w, n):
    """w (Cout, Cin, k, k) as the kernel reads it: bf16 (k * Cin / 16, 2, n,
    8), [dy * Cin / 16 + kc, h, co * k + dx, e] = w[co, 16 kc + 8 h + e, dy,
    dx], zeros for columns past Cout * k: each k-step's B as wgmma's K-major
    core matrices (8 columns x 8 k, 128 bytes), the two k halves n * 16
    bytes apart."""
    cout, cin, k, _ = w.shape
    wp = w.to(torch.bfloat16).permute(2, 0, 3, 1).reshape(k, cout * k, cin)
    wp = F.pad(wp, (0, 0, 0, n - cout * k))
    return wp.reshape(k, n, cin // 16, 2, 8).permute(0, 2, 3, 1, 4) \
        .reshape(k * cin // 16, 2, n, 8).contiguous()


def plain(x, w, bias=None):
    """The function itself: conv2d(x, w) + bias over the bf16 operands with
    fp32 sums (TF32 off on a card), the bias added in fp32, one rounding to
    bf16."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x.float(), w.to(torch.bfloat16).float(), None,
                     padding=w.shape[-1] // 2)
    if bias is not None:
        y = y + bias.to(torch.bfloat16).float()[None, :, None, None]
    return y.to(torch.bfloat16)


def emulate(x, w, bias=None, smem_limit=232448, sms=132):
    """The kernel's arithmetic in float64 on any device: the plan's strips
    of 56 outputs over 64 input columns, the packed weights, the partial
    sums P[column, (co, dx)] over (dy, ci), and each output's k partial sums
    in order plus the bias.  Returns float64 (N, Cout, H, W), unrounded."""
    n, cin, h, wd = x.shape
    cout, _, k, _ = w.shape
    r = k // 2
    p = plan(n, cin, h, wd, cout, k, smem_limit, sms)
    # back to [dy, column, ci] from the kernel's layout
    wk = pack_weights(w, p.n).double().reshape(k, cin // 16, 2, p.n, 8) \
        .permute(0, 3, 1, 2, 4).reshape(k, p.n, cin)
    strips = p.grid[0]
    # column j of strip s holds input column 56 s - 8 + j, its outputs are
    # columns 56 s - 4 ..; rows pad by r
    xp = torch.zeros((n, cin, h + 2 * r, strips * OUT_W + 8),
                     dtype=torch.float64, device=x.device)
    xp[:, :, r:r + h, 8:8 + wd] = x.double()
    b = (torch.zeros(cout, dtype=torch.float64, device=x.device)
         if bias is None else bias.to(torch.bfloat16).double())
    y = torch.empty((n, cout, h, strips * OUT_W), dtype=torch.float64,
                    device=x.device)     # column c is output column c - 4
    for s in range(strips):
        xs = xp[..., s * OUT_W:s * OUT_W + M]
        part = sum(torch.einsum("mc,ncyj->nmyj", wk[dy],
                                xs[:, :, dy:dy + h])
                   for dy in range(k))
        for co in range(cout):
            acc = part[:, co * k, :, 4 - r:4 - r + OUT_W]
            for dx in range(1, k):
                acc = acc + part[:, co * k + dx, :,
                                 4 - r + dx:4 - r + dx + OUT_W]
            y[:, co, :, s * OUT_W:(s + 1) * OUT_W] = acc + b[co]
    return y[..., 4:4 + wd]


def smem_limit(index):
    """Shared memory a block may use on card `index`, read once a card."""
    v = _smem_limit.get(index)
    if v is None:
        v = (_lib or build()).conv_narrow_smem_limit(index)
        if v < 0:
            raise RuntimeError("could not read the card's shared memory")
        _smem_limit[index] = v
    return v


def conv(x, w, bias=None):
    """The kernel path: bf16 conv2d(x, w, stride 1, padding k // 2) + bias
    of a bf16 CUDA x (N, Cin, H, W), w (Cout, Cin, k, k) and bias (Cout,)
    in any float dtype (both cast to bf16, the bias then added in fp32)."""
    if x.dim() != 4 or not fits(tuple(w.shape), 1, w.shape[-1] // 2) \
            or x.shape[1] != w.shape[1]:
        raise ValueError(f"the kernel does not take x {tuple(x.shape)} with "
                         f"w {tuple(w.shape)}")
    lib = _lib or build()
    if not x.is_contiguous():
        x = x.contiguous()
    n, cin, h, wd = x.shape
    cout, _, k, _ = w.shape
    index = x.get_device()
    p = plan(n, cin, h, wd, cout, k, smem_limit(index), sm_count(x.device))
    wpk = pack_weights(w.detach(), p.n)
    b = (None if bias is None
         else bias.detach().to(torch.bfloat16).float().contiguous())
    y = torch.empty((n, cout, h, wd), device=x.device, dtype=torch.bfloat16)
    err = lib.conv_narrow_bf16(
        x.data_ptr(), wpk.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), n, cin, h, wd, cout, k, p.n, p.groups, p.rows, p.smem,
        index, raw_stream(index))
    if err:
        raise RuntimeError(f"conv_narrow_bf16 launch failed: cudaError {err}")
    counters["conv_narrow"] += 1
    return y
