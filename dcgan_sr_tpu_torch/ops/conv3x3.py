"""A 3x3 stride-1 "same" bf16 convolution of a 64-channel map on the card:
SRGAN's 33 LR convs (64 -> 64) and its two upsampling convs (64 -> 256).

cuDNN runs these convolutions (x (16, 64, 256, 256) and (16, 64, 512, 512)
bf16 NCHW) as NHWC implicit GEMMs between two layout transposes of the map,
and the conv's bias as a broadcast add in PyTorch's strided loop: about 31
ms of a 57 ms SRGAN call, of which the products are 8.  csrc/conv3x3.cu
computes the same function reading x once in its NCHW layout on wgmma,
with fp32 sums and the bias added in fp32 before the one rounding to bf16.
It replaces no Pallas kernel: the JAX package leaves its convolutions to
XLA.

`takes(x, w, stride, padding, bias)` is the rule ops/nn.py conv2d follows,
read from the input alone: x a 4-D bf16 CUDA tensor, no gradient to carry
(not grad mode with any of x, w or bias requiring grad), and a shape the
kernel takes (`fits`): w (Cout, 64, 3, 3) with Cout 64 or 256, stride 1,
padding 1.  Then `conv` launches the kernel and nothing else; everything
else runs as before.

`plan` cuts the launch (the flattened rows of (image, strip of 128
columns) a block, the blocks of each 64-channel output tile) and
`pack_weights` lays w out as the kernel reads it; `emulate` runs the
kernel's arithmetic in float64 from the same plan and packing on any
device, so the CPU tests hold both to the convolution.  `plain` is the
function itself in plain PyTorch (fp32 sums of the bf16 operands, one
rounding).  The packed weights and the fp32 bias are kept per weight
tensor and made again only when its `_version` (or the bias's) moves, so a
call is one launch.

Counters (utils/profiling.py `counters`): "conv3x3" counts the kernel's
launches; "conv3x3_plain" the bf16 CUDA calls of a shape the kernel fits
(`fits`) that the rule sent to cuDNN, for a gradient to carry.
conv3x3 / (conv3x3 + conv3x3_plain) is the share of the calls the kernel
could take that it took.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
import weakref

import torch
import torch.nn.functional as F

from ..utils.profiling import counters
from ._build import compile_and_load, raw_stream, sm_count

CIN = 64        # input channels
SW = 128        # output columns of a strip (wgmma's N)
MT = 64         # output channels of a tile (wgmma's M)
KS = 9 * CIN // 16          # k16 steps of a product
XPOS = SW + 16  # positions of a transposed input row: columns c0 - 8 ..
COUTS = (64, 256)

_lib = None
_lib_lock = threading.Lock()
_packed = {}
build_log = ""


def build():
    """Compile csrc/conv3x3.cu (once per source content) and load it."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_and_load("conv3x3")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conv3x3_bf16.argtypes = [p, p, p, p] + [ll] * 7 + [i, p]
        lib.conv3x3_bf16.restype = i
        _lib = lib
        return lib


def fits(w_shape, stride, padding):
    """Does the kernel take a convolution of weight shape (Cout, Cin, kh,
    kw) at this stride and padding."""
    cout, cin, kh, kw = w_shape
    return (kh == 3 and kw == 3 and cin == CIN and cout in COUTS
            and stride == 1 and padding == 1)


def takes(x, w, stride, padding, bias=None):
    """Does conv2d(x, w) run on the kernel: see the module docstring."""
    return (fits(tuple(w.shape), stride, padding)
            and x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4
            and not (torch.is_grad_enabled() and (
                x.requires_grad or w.requires_grad
                or (bias is not None and bias.requires_grad))))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `tiles` output tiles of 64 channels, `strips` of 128
    columns an image, `rows` flattened (image, strip, output row) rows a
    block, `groups` blocks a tile, `grid` blocks in all (tile = block index
    % tiles)."""
    tiles: int
    strips: int
    rows: int
    groups: int
    grid: int


@functools.lru_cache(maxsize=64)
def plan(n, h, w, cout, sms):
    """The launch for x (n, 64, h, w) and Cout: one block an SM, the SMs
    shared out evenly over the tiles, each block one run of consecutive
    flattened rows (the 4 blocks of a run's tiles side by side)."""
    tiles = cout // MT
    strips = -(-w // SW)
    total = n * strips * h
    groups = max(1, min(sms // tiles, total))
    rows = -(-total // groups)
    groups = -(-total // rows)
    return Plan(tiles, strips, rows, groups, groups * tiles)


def pack_weights(w):
    """w (Cout, 64, 3, 3) as the kernel reads it: bf16 (Cout / 64, 36, 2,
    64, 8), [t, ks, kh, m, e] = w[64 t + m, 16 kc + 8 kh + e, dy, dx] with
    ks = (3 dy + dx) * 4 + kc: each k-step's A as wgmma's K-major core
    matrices (8 channels x 8 k, 128 bytes), the two k halves 1024 bytes
    apart."""
    cout = w.shape[0]
    wp = w.to(torch.bfloat16).reshape(cout // MT, MT, 4, 2, 8, 3, 3)
    return wp.permute(0, 5, 6, 2, 3, 1, 4).reshape(
        cout // MT, KS, 2, MT, 8).contiguous()


def plain(x, w, bias=None):
    """The function itself: conv2d(x, w, padding 1) + bias over the bf16
    operands with fp32 sums (TF32 off on a card), the bias added in fp32,
    one rounding to bf16."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x.float(), w.to(torch.bfloat16).float(), None,
                     padding=1)
    if bias is not None:
        y = y + bias.to(torch.bfloat16).float()[None, :, None, None]
    return y.to(torch.bfloat16)


def emulate(x, w, bias=None):
    """The kernel's arithmetic in float64 on any device: strips of 128
    output columns, each reading the transposed positions of columns c0 - 8
    .. c0 + 135 of three input rows (zeros outside the image), the packed
    weights, and each 64-channel tile's 36 k-steps summed in order, then
    the bias.  Returns float64 (N, Cout, H, W), unrounded."""
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    tiles = cout // MT
    # A[t, ks] (64 x 16) back from the packed layout
    a = pack_weights(w).double().permute(0, 1, 3, 2, 4).reshape(
        tiles, KS, MT, 16)
    strips = -(-wd // SW)
    # column c of xp is input column c - 8; rows pad by one
    xp = torch.zeros((n, cin, h + 2, strips * SW + 16), dtype=torch.float64,
                     device=x.device)
    xp[:, :, 1:h + 1, 8:8 + wd] = x.double()
    b = (torch.zeros(cout, dtype=torch.float64, device=x.device)
         if bias is None else bias.to(torch.bfloat16).double())
    y = torch.empty((n, cout, h, strips * SW), dtype=torch.float64,
                    device=x.device)
    for s in range(strips):
        xs = xp[..., s * SW:s * SW + XPOS]       # position p: column c0-8+p
        for t in range(tiles):
            acc = torch.zeros((n, MT, h, SW), dtype=torch.float64,
                              device=x.device)
            for ks in range(KS):
                dy, dx, kc = ks // 12, (ks // 4) % 3, ks % 4
                acc = acc + torch.einsum(
                    "mk,nkyp->nmyp", a[t, ks],
                    xs[:, 16 * kc:16 * kc + 16, dy:dy + h, dx + 7:dx + 7 + SW])
            y[:, t * MT:(t + 1) * MT, :, s * SW:(s + 1) * SW] = \
                acc + b[t * MT:(t + 1) * MT, None, None]
    return y[..., :wd]


def _operands(w, bias, device):
    """(the packed weights, the bias in fp32 after bf16) of this weight and
    bias on `device`, made once and kept while neither tensor's `_version`
    moves."""
    key = id(w)
    bkey = None if bias is None else (id(bias), bias._version)
    hit = _packed.get(key)
    if (hit is not None and hit[0]() is w and hit[1] == w._version
            and hit[2] == bkey and hit[3].device == device):
        return hit[3], hit[4]
    with torch.no_grad():
        wpk = pack_weights(w.detach().to(device))
        b = (None if bias is None else
             bias.detach().to(device, torch.bfloat16).float().contiguous())
    _packed[key] = (weakref.ref(w, lambda _, k=key: _packed.pop(k, None)),
                    w._version, bkey, wpk, b)
    return wpk, b


def conv(x, w, bias=None):
    """The kernel path: bf16 conv2d(x, w, stride 1, padding 1) + bias of a
    bf16 CUDA x (N, 64, H, W), w (Cout, 64, 3, 3) with Cout a multiple of 64
    and bias (Cout,) in any float dtype (both cast to bf16, the bias then
    added in fp32)."""
    cout = w.shape[0]
    if (x.dim() != 4 or x.shape[1] != CIN or tuple(w.shape[1:]) != (CIN, 3, 3)
            or cout < MT or cout % MT):
        raise ValueError(f"the kernel does not take x {tuple(x.shape)} with "
                         f"w {tuple(w.shape)}")
    lib = _lib or build()
    if not x.is_contiguous():
        x = x.contiguous()
    n, _, h, wd = x.shape
    p = plan(n, h, wd, cout, sm_count(x.device))
    wpk, b = _operands(w, bias, x.device)
    y = torch.empty((n, cout, h, wd), device=x.device, dtype=torch.bfloat16)
    index = x.get_device()
    err = lib.conv3x3_bf16(
        x.data_ptr(), wpk.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), n, h, wd, cout, p.strips, p.rows, p.groups, index,
        raw_stream(index))
    if err:
        raise RuntimeError(f"conv3x3_bf16 launch failed: error {err}")
    counters["conv3x3"] += 1
    return y
