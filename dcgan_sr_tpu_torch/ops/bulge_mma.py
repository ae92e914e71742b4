"""Host side of the tensor-core bulge kernel (csrc/bulge.cu, namespace tc):
the packing of wT and wC into the kernel's two GEMM operands, the TF32
split the kernel applies to every operand in registers, the schedule of work items, and
a plain PyTorch "packed" version of the pair written from the same packed
operands, item by item, as the kernel walks them.

The pair as two matrix products (the parity decomposition of
dcgan_sr_tpu/ops/pallas_bulge.py:19-29, regrouped for an SM):

  stage 1  local position (pi, pj), pi in [0, R], pj in [0, TW], stands for
           x position (r0 - di + pi, c0 - dj + pj) of output parity
           (di, dj).  Its 2x2 window is xs[ci][pi + ti][pj + tj] for all
           four parities alike, xs = x rows r0-1 .. r0+R, columns c0-1 ..
           c0+TW, zero outside the image.  So
             HP (positions x 4 Cmp) = A1 (positions x 4 Ci) @ W1 (4 Ci x 4 Cmp)
           k = (ti*2 + tj)*Ci + ci, n = (di*2 + dj)*Cmp + cm,
           W1[k, n] = wT[ci, cm, 3 - di - 2 ti, 3 - dj - 2 tj].
  stage 2  y pixel (ml, nl) reads, for tap (a, c), parity plane
           ((a+1)&1, (c+1)&1) at (ml + a//2, nl + c//2):
             Y (pixels x Co) = A2 (pixels x 16 Cmp) @ W2 (16 Cmp x Co)
           k = (a*4 + c)*Cmp + cm, W2[k, co] = wC[co, cm, a, c].

Cmp = max(Cm, 8): mma tiles are 8 columns wide, so Cm 4 runs padded with
zero weights.  Both operands go to the card in mma.m16n8k8 B-fragment order
(`to_fragments`), so the kernel stages them with a straight copy.

bf16 (the kernel's bf16 instantiation): the same W1 and W2, rounded to bf16,
in mma.m16n8k16 B-fragment order (`to_fragments_bf16`): a lane's two k-
adjacent values share one 32-bit register, and its four values of an n8
column are one 8-byte load.  The k order is the fp32 kernel's, unpermuted:
the kernel pairs A's k-adjacent values (two channels of one position) from
its NCHW x staging with two 2-byte loads, and from its hidden planes, which
it stores channel-pair interleaved, with one 4-byte load.  `bulge_packed`
takes bf16 x with the kernel's rounding points.

wgmma (csrc/bulge_wgmma.cu, bf16 only): the same W1 and W2, rounded to
bf16, as wgmma's B operand in shared memory, K-major without swizzle
(`to_wgmma_bf16`): 8x8 core matrices (8 n x 8 k, 16 contiguous bytes per
n), ordered k-block major, so the descriptor's leading byte offset (between
core matrices adjacent in k) is N/8 * 128 and its stride byte offset
(adjacent in n) 128 (`wgmma_offsets`, `wgmma_read`).  x reaches that kernel
as one TMA box an item (`tma_box`): BOX_ROWS x BOX_COLS from (r0-1, c0-1),
zero outside the image (the innermost box coordinate must be a multiple of
16 bytes, so the box starts at column c0-8), of which stage 1 reads the
window `staged_window`, from box column BOX_COL0, that the mma.sync kernel
stages by hand.

wgmma in fp32 (csrc/bulge_wgmma.cu namespace wgf, 3xTF32): the same W1 and
W2 as wgmma's tf32 B operand, K-major without swizzle (`to_wgmma_tf32`):
core matrices of 8 n-rows x 4 k-values (16 bytes), with the same
descriptor offsets (`wgmma_offsets`; `wgmma_read_tf32`).  Each goes to the
card as two fp32 planes, hi = tf32(w) and lo = w - hi (`packed_operand(...,
torch.float32, "wgmma")`), and W2's rows are permuted within each k-step
of 8 (KPERM8: logical k t and t+4 are channels 2t and 2t+1, one 8-byte load
of the hidden planes a lane).  Its stats kernel walks the items above; its
main kernel bands of `f32_main_rows(Ci)` rows (4 at Ci 32, where 8 rows'
buffers do not fit in shared memory), `Schedule(rows=)`.  x arrives as one
box an item, F32_BOX_COLS columns from c0-4 (`tma_box_origin(..., dtype)`),
x column c0-1 at box column F32_BOX_COL0.  `bulge_wgmma_f32` emulates its
arithmetic item by item.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

BAND_ROWS = 8        # R: y rows of a work item (csrc/bulge.cu tc::R)
CHUNK_COLS = 32      # TW: y columns of a work item (tc::TW)

# (Ci, Cm, Co) with a compiled tensor-core instantiation
MMA_TRIPLES = ((8, 4, 8), (16, 8, 16), (32, 16, 32))
# (Ci, Cm, Co) with an instantiation of the wgmma kernel (bf16 only)
WGMMA_TRIPLES = ((16, 8, 16), (32, 16, 32))
# the x box the wgmma kernel's tensor map loads an item (csrc/bulge_wgmma.cu
# XR, XC, XO): rows r0-1 .. r0+8, columns c0-8 .. c0+39; x column c0-1 is
# box column BOX_COL0
BOX_ROWS = BAND_ROWS + 2
BOX_COLS = 48
BOX_COL0 = 7
# the fp32 wgmma kernel's box (csrc/bulge_wgmma.cu wgf::XC, XO): rows r0-1
# .. r0+R, columns c0-4 .. c0+39 (16 bytes of fp32 from c0-1's left, and a
# channel plane 24 or 8 floats mod 32, so a fragment load meets no bank
# conflict); x column c0-1 is box column F32_BOX_COL0
F32_BOX_COLS = 44
F32_BOX_COL0 = 3
# stage 2's k order within a k-step of 8 in the fp32 wgmma kernel: logical k
# t and t+4 read channels 2t and 2t+1 of the hidden planes
KPERM8 = (0, 2, 4, 6, 1, 3, 5, 7)


def f32_main_rows(ci):
    """Band rows of the fp32 wgmma main kernel's work items at Ci
    (csrc/bulge_wgmma.cu wgf::main_rows); its stats kernel's are
    BAND_ROWS."""
    return 4 if ci >= 32 else 8


def padded_cm(cm):
    return max(cm, 8)


# ---------------------------------------------------------------------------
# the TF32 split
# ---------------------------------------------------------------------------

def trunc_tf32(a):
    """fp32 -> TF32 as the tensor cores read an operand: the upper 19 bits
    (sign, 8 exponent bits, 10 mantissa bits); the 13 low mantissa bits come
    out zero."""
    bits = a.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split_tf32(a):
    """(hi, lo) as the kernel splits an operand (csrc/bulge.cu split_tf32):
    hi = tf32(a), lo = a - hi, exact in fp32, so hi + lo == a; the mma then
    reads tf32(lo), which leaves a to 2^-20 relative.  hi*hi' + hi*lo' +
    lo*hi' is the product to fp32 accuracy with TF32 multiplies."""
    hi = trunc_tf32(a)
    return hi, a - hi


def mma_3x(a, b):
    """The kernel's error-compensated product of two fp32 matrices, emulated:
    three products of TF32 operands, small terms first, summed in fp32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    al, bl = trunc_tf32(al), trunc_tf32(bl)
    return (al @ bh + ah @ bl) + ah @ bh


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _w1_index(ci, cm):
    """(4 Ci, 4 Cmp) flat indices into wT (Ci, Cm, 4, 4); the padding
    columns point one past its end, where `_gather` keeps a zero."""
    cmp_ = padded_cm(cm)
    idx = np.full((2, 2, ci, 2, 2, cmp_), ci * cm * 16, np.int64)
    c, m = np.meshgrid(np.arange(ci), np.arange(cm), indexing="ij")
    for ti in range(2):
        for tj in range(2):
            for di in range(2):
                for dj in range(2):
                    idx[ti, tj, :, di, dj, :cm] = (
                        ((c * cm + m) * 4 + (3 - di - 2 * ti)) * 4
                        + (3 - dj - 2 * tj))
    return idx.reshape(4 * ci, 4 * cmp_)


def _w2_index(cm, co):
    """(16 Cmp, Co) flat indices into wC (Co, Cm, 4, 4), padding rows as in
    `_w1_index`."""
    cmp_ = padded_cm(cm)
    idx = np.full((4, 4, cmp_, co), co * cm * 16, np.int64)
    m, o = np.meshgrid(np.arange(cm), np.arange(co), indexing="ij")
    for a in range(4):
        for c in range(4):
            idx[a, c, :cm] = ((o * cm + m) * 4 + a) * 4 + c
    return idx.reshape(16 * cmp_, co)


def to_fragments(mat):
    """A (K, N) B operand in mma.m16n8k8 fragment order, flat: element
    [((ks*NT + nt)*32 + lane)*2 + j] = mat[ks*8 + lane%4 + 4j, nt*8 + lane//4]
    (lane = g*4 + t holds rows t and t+4 of column g of each 8x8 block)."""
    k, n = mat.shape
    blocks = mat.reshape(k // 8, 2, 4, n // 8, 8)      # ks, j, t, nt, g
    return blocks.transpose(0, 3, 4, 2, 1).reshape(-1)  # ks, nt, g, t, j


def to_fragments_bf16(mat):
    """A (K, N) B operand in mma.m16n8k16 fragment order, flat: element
    [(((ks*NT + nt)*32 + lane)*2 + j)*2 + i] = mat[ks*16 + 8j + 2t + i][nt*8 + g]
    (lane = g*4 + t; register j of the lane holds rows 8j + 2t and
    8j + 2t + 1 of column g of each 16x8 block, the lower row in the lower
    half)."""
    k, n = mat.shape
    blocks = mat.reshape(k // 16, 2, 4, 2, n // 8, 8)   # ks, j, t, i, nt, g
    return blocks.transpose(0, 4, 5, 2, 1, 3).reshape(-1)  # ks, nt, g, t, j, i


def to_wgmma_bf16(mat):
    """A (K, N) B operand in wgmma's canonical K-major layout without
    swizzle, flat: element [((kb*(N/8) + nb)*8 + r)*8 + e] = mat[kb*8 + e]
    [nb*8 + r]: core matrix (kb, nb) is 8 n-rows of 8 k-values, 128
    contiguous bytes in bf16, core matrices k-block major."""
    k, n = mat.shape
    blocks = mat.reshape(k // 8, 8, n // 8, 8)      # kb, e, nb, r
    return blocks.transpose(0, 2, 3, 1).reshape(-1)  # kb, nb, r, e


def to_wgmma_tf32(mat):
    """A (K, N) B operand in wgmma's canonical K-major tf32 layout without
    swizzle, flat: element [((kb*(N/8) + nb)*8 + r)*4 + e] = mat[kb*4 + e]
    [nb*8 + r]: core matrix (kb, nb) is 8 n-rows of 4 k-values, 128
    contiguous bytes in fp32, core matrices k-block major."""
    k, n = mat.shape
    blocks = mat.reshape(k // 4, 4, n // 8, 8)      # kb, e, nb, r
    return blocks.transpose(0, 2, 3, 1).reshape(-1)  # kb, nb, r, e


def wgmma_offsets(n):
    """(leading, stride) byte offsets of the wgmma descriptor for an operand
    of N = n columns in `to_wgmma_bf16`'s layout: between core matrices
    adjacent in k, and adjacent in n."""
    return n // 8 * 128, 128


def wgmma_read(flat, k, n, n_cols, ks=0):
    """Element (k, n) of the 16-row k-step `ks` of a `to_wgmma_bf16`
    operand with n_cols columns, read as the descriptor addresses it:
    start = ks * 2 * leading, then (k // 8) * leading + (n // 8) * stride
    + (n % 8) * 16 + (k % 8) * 2 bytes."""
    lead, stride = wgmma_offsets(n_cols)
    byte = (ks * 2 * lead + (k // 8) * lead + (n // 8) * stride
            + (n % 8) * 16 + (k % 8) * 2)
    return flat[byte // 2]


def wgmma_read_tf32(flat, k, n, n_cols, ks=0):
    """Element (k, n) of the 8-row k-step `ks` of a `to_wgmma_tf32` plane
    with n_cols columns, read as the descriptor addresses it: start =
    ks * 2 * leading, then (k // 4) * leading + (n // 8) * stride
    + (n % 8) * 16 + (k % 4) * 4 bytes."""
    lead, stride = wgmma_offsets(n_cols)
    byte = (ks * 2 * lead + (k // 4) * lead + (n // 8) * stride
            + (n % 8) * 16 + (k % 4) * 4)
    return flat[byte // 4]


def _gather(w, idx):
    flat = torch.cat([w.reshape(-1), w.new_zeros(1)])
    return flat[idx]


def pack_wT(wT):
    """W1 (4 Ci, 4 Cmp) of wT (Ci, Cm, 4, 4)."""
    ci, cm = wT.shape[:2]
    return _gather(wT, torch.from_numpy(_w1_index(ci, cm)).to(wT.device))


def pack_wC(wC):
    """W2 (16 Cmp, Co) of wC (Co, Cm, 4, 4)."""
    co, cm = wC.shape[:2]
    return _gather(wC, torch.from_numpy(_w2_index(cm, co)).to(wC.device))


_index_cache = {}


def _fragment_index(kind, shape, device, dtype=torch.float32, layout="mma"):
    """Flat gather indices of a weight of `shape` into its operand in the
    fragment order of `dtype`'s mma (layout "mma") or in wgmma's shared
    memory layout (layout "wgmma"), on `device`; kind "wT" or "wC"."""
    key = (kind, tuple(shape[:2]), str(device), dtype, layout)
    if key not in _index_cache:
        idx = _w1_index(*shape[:2]) if kind == "wT" else \
            _w2_index(shape[1], shape[0])
        if layout == "wgmma" and dtype == torch.float32:
            if kind == "wC":
                rows = idx.reshape(-1, 8, idx.shape[1])
                idx = rows[:, list(KPERM8)].reshape(idx.shape)
            order = to_wgmma_tf32
        elif layout == "wgmma":
            order = to_wgmma_bf16
        else:
            order = to_fragments_bf16 if dtype == torch.bfloat16 else \
                to_fragments
        _index_cache[key] = torch.from_numpy(
            np.ascontiguousarray(order(idx))).to(device)
    return _index_cache[key]


# Operands of the weights seen last, so a server packs its generator's pair
# once.  An entry keeps its source tensor alive and is valid while that very
# tensor has not been written to.
_packed = OrderedDict()
_PACKED_MAX = 16


def packed_operand(kind, w, dtype=torch.float32, layout="mma"):
    """W1 of wT (kind "wT") or W2 of wC (kind "wC") in the fragment order of
    `dtype`'s mma (fp32: m16n8k8 TF32, bf16: m16n8k16), or with layout
    "wgmma" in `to_wgmma_bf16`'s order (bf16) or as the planes (hi, lo) of
    `to_wgmma_tf32`'s order, W2 with its rows in KPERM8 order (fp32), flat,
    in `dtype` on w's device."""
    key = (kind, id(w), dtype, layout)
    hit = _packed.get(key)
    if hit is not None and hit[0] is w and hit[1] == w._version:
        _packed.move_to_end(key)
        return hit[2]
    op = _gather(w.detach().float(), _fragment_index(
        kind, w.shape, w.device, dtype, layout)).to(dtype)
    if layout == "wgmma" and dtype == torch.float32:
        hi = trunc_tf32(op)
        op = torch.cat([hi, op - hi])
    _packed[key] = (w, w._version, op)
    while len(_packed) > _PACKED_MAX:
        _packed.popitem(last=False)
    return op


# ---------------------------------------------------------------------------
# the schedule of work items
# ---------------------------------------------------------------------------

def slots_per_image(h, w, rows=BAND_ROWS):
    """Work items, and so statistics slots, of one (h, w) image, in bands
    of `rows` y rows."""
    return -(-h // rows) * -(-w // CHUNK_COLS)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Work items of one launch on x (B, Ci, H, W): item idx is (image,
    band of `rows` y rows, chunk of CHUNK_COLS y columns), chunk fastest;
    block k of a persistent grid of G blocks takes items k, k+G, ...  Item
    idx writes its statistics to slot idx of `partial`, so the slots of image
    b are [b*per_image, (b+1)*per_image).  Every stats launch, and the main
    launches but the fp32 wgmma kernel's at Ci 32 (`f32_main_rows`), walk
    bands of BAND_ROWS."""
    batch: int
    h: int
    w: int
    rows: int = BAND_ROWS

    @property
    def bands(self):
        return -(-self.h // self.rows)

    @property
    def chunks(self):
        return -(-self.w // CHUNK_COLS)

    @property
    def per_image(self):
        return slots_per_image(self.h, self.w, self.rows)

    @property
    def n_items(self):
        return self.batch * self.per_image

    def item(self, idx):
        """(image, first y row, first y column) of item idx."""
        rest, chunk = divmod(idx, self.chunks)
        b, band = divmod(rest, self.bands)
        return b, band * self.rows, chunk * CHUNK_COLS

    def owned(self, idx):
        """The hidden cells whose statistics item idx counts, as
        (image, rows, cols) index arrays of the (2H, 2W) hidden image: local
        position (pi, pj) of parity (di, dj) is owned where (pi - di,
        pj - dj) lies in [0, R) x [0, TW) and in the image."""
        b, r0, c0 = self.item(idx)
        rows, cols = [], []
        for di in range(2):
            for dj in range(2):
                for pi in range(self.rows + 1):
                    for pj in range(CHUNK_COLS + 1):
                        li, lj = pi - di, pj - dj
                        if 0 <= li < self.rows and 0 <= lj < CHUNK_COLS \
                                and r0 + li < self.h and c0 + lj < self.w:
                            rows.append(2 * (r0 + li) + di)
                            cols.append(2 * (c0 + lj) + dj)
        return b, np.asarray(rows), np.asarray(cols)


def reduce_partials(partial, n_cells, groups):
    """Per-group (mean, biased var) of the hidden tensor from the stats
    launch's slots.  partial (B, slots, 2, Cm) fp32: a fixed-order fp64
    reduction, first over an image's slots, then over the B // groups
    consecutive images of a group; n_cells = hidden cells of one image."""
    bsz, _, _, cm = partial.shape
    sums = partial.double().sum(dim=1)                       # (B, 2, Cm)
    sums = sums.reshape(groups, bsz // groups, 2, cm).sum(dim=1)
    n = float(n_cells) * (bsz // groups)
    mean = sums[:, 0] / n
    var = sums[:, 1] / n - mean * mean
    return mean.float(), var.float()                         # (groups, Cm)


# ---------------------------------------------------------------------------
# the packed plain version
# ---------------------------------------------------------------------------

def _window(x_img, r0, c0, rows, cols):
    """x_img rows r0-1 .. r0-2+rows, columns c0-1 .. c0-2+cols, zero outside
    the image."""
    ci, h, w = x_img.shape
    xs = x_img.new_zeros((ci, rows, cols))
    i0, i1 = max(r0 - 1, 0), min(r0 - 1 + rows, h)
    j0, j1 = max(c0 - 1, 0), min(c0 - 1 + cols, w)
    if i1 > i0 and j1 > j0:
        xs[:, i0 - (r0 - 1):i1 - (r0 - 1), j0 - (c0 - 1):j1 - (c0 - 1)] = \
            x_img[:, i0:i1, j0:j1]
    return xs


def staged_window(x_img, r0, c0):
    """The (Ci, R+2, TW+2) x window stage 1 of item (r0, c0) reads: what the
    mma.sync kernel's stage_x copies and zero-fills by hand."""
    return _window(x_img, r0, c0, BAND_ROWS + 2, CHUNK_COLS + 2)


def tma_box_origin(r0, c0, dtype=torch.bfloat16):
    """(column, row) of the wgmma kernel's box for item (r0, c0), innermost
    first, as the tensor-map coordinates it issues; may be negative, and the
    column is a multiple of 16 bytes (8 bf16 or 4 fp32 columns), which the
    hardware requires of the innermost coordinate."""
    col0 = F32_BOX_COL0 if dtype == torch.float32 else BOX_COL0
    return c0 - col0 - 1, r0 - 1


def tma_box(x_img, r0, c0, dtype=torch.bfloat16, rows=BAND_ROWS):
    """The (Ci, rows + 2, columns) box the wgmma kernel's TMA load writes
    for item (r0, c0) of a band of `rows` (BOX_COLS columns for bf16 x,
    F32_BOX_COLS for fp32): the image from `tma_box_origin`, the elements
    outside the image zero-filled by the hardware."""
    c, r = tma_box_origin(r0, c0, dtype)
    cols = F32_BOX_COLS if dtype == torch.float32 else BOX_COLS
    return _window(x_img, r + 1, c + 1, rows + 2, cols)


def _stage1_item(x_img, w1, r0, c0):
    """HP (PR, PC, 4 Cmp) of one item: A1 @ W1 over the staged x window."""
    ci = x_img.shape[0]
    pr, pc = BAND_ROWS + 1, CHUNK_COLS + 1
    xs = staged_window(x_img, r0, c0)
    taps = [xs[:, ti:ti + pr, tj:tj + pc] for ti in range(2) for tj in range(2)]
    a1 = torch.stack(taps).reshape(4 * ci, pr * pc).T        # k = tap*Ci + ci
    return torch.matmul(a1, w1).reshape(pr, pc, -1)


def _in_image(r0, c0, h, w, device):
    """(4, PR, PC) mask: is the hidden cell of parity p at (pi, pj) inside
    the image (else it is the consumer's zero padding)."""
    pi = torch.arange(BAND_ROWS + 1, device=device)[:, None]
    pj = torch.arange(CHUNK_COLS + 1, device=device)[None, :]
    out = []
    for di in range(2):
        for dj in range(2):
            i, j = r0 - di + pi, c0 - dj + pj
            out.append((i >= 0) & (i < h) & (j >= 0) & (j < w))
    return torch.stack(out)


def _as_kernel_reads(x, w):
    """x and a weight as the kernel's products read them: fp32 as given,
    or, for bf16 x, both rounded to bf16 and upcast (exact)."""
    if x.dtype == torch.bfloat16:
        return x.float(), w.to(torch.bfloat16).float()
    return x, w


def packed_stats(x, wT):
    """What the stats launch writes: (B, slots, 2, Cm) sums and sums of
    squares of the hidden cells each item owns."""
    bsz, ci, h, w = x.shape
    cm, cmp_ = wT.shape[1], padded_cm(wT.shape[1])
    x, wT = _as_kernel_reads(x, wT)
    w1 = pack_wT(wT)
    sched = Schedule(bsz, h, w)
    li = torch.arange(BAND_ROWS + 1)[:, None]
    lj = torch.arange(CHUNK_COLS + 1)[None, :]
    out = x.new_zeros((sched.n_items, 2, cm))
    for idx in range(sched.n_items):
        b, r0, c0 = sched.item(idx)
        hp = _stage1_item(x[b], w1, r0, c0).reshape(
            BAND_ROWS + 1, CHUNK_COLS + 1, 4, cmp_)
        for par in range(4):
            di, dj = par >> 1, par & 1
            own = ((li - di >= 0) & (li - di < BAND_ROWS) & (lj - dj >= 0)
                   & (lj - dj < CHUNK_COLS) & (r0 + li - di < h)
                   & (c0 + lj - dj < w)).to(x.device)
            v = hp[:, :, par, :cm] * own[:, :, None]
            out[idx, 0] += v.sum(dim=(0, 1))
            out[idx, 1] += (v * v).sum(dim=(0, 1))
    return out.reshape(bsz, sched.per_image, 2, cm)


def packed_main(x, wT, wC, mu, gain, beta):
    """What the main launch writes: y (B, Co, H, W) in x's dtype with h
    normalised as (h - mu) * gain + beta, mu and gain (B, Cm); for bf16 x,
    h is rounded to bf16 after the edge mask and y after the product."""
    bsz, ci, h, w = x.shape
    cm, cmp_, co = wT.shape[1], padded_cm(wT.shape[1]), wC.shape[0]
    out_dtype = x.dtype
    _, wC = _as_kernel_reads(x, wC)
    x, wT = _as_kernel_reads(x, wT)
    w1, w2 = pack_wT(wT), pack_wC(wC)
    pad = (0, cmp_ - cm)
    mu, gain = (torch.nn.functional.pad(v, pad) for v in (mu, gain))
    beta = torch.nn.functional.pad(beta, pad)
    sched = Schedule(bsz, h, w)
    y = x.new_zeros((bsz, co, h, w))
    for idx in range(sched.n_items):
        b, r0, c0 = sched.item(idx)
        hp = _stage1_item(x[b], w1, r0, c0).reshape(
            BAND_ROWS + 1, CHUNK_COLS + 1, 4, cmp_)
        hp = torch.relu((hp - mu[b]) * gain[b] + beta)
        hp = hp * _in_image(r0, c0, h, w, x.device).permute(1, 2, 0)[..., None]
        if out_dtype == torch.bfloat16:
            hp = hp.to(torch.bfloat16).float()
        taps = [hp[a // 2:a // 2 + BAND_ROWS, c // 2:c // 2 + CHUNK_COLS,
                   ((a + 1) & 1) * 2 + ((c + 1) & 1)]
                for a in range(4) for c in range(4)]       # each (R, TW, Cmp)
        a2 = torch.stack(taps, dim=2).reshape(
            BAND_ROWS * CHUNK_COLS, 16 * cmp_)              # k = tap*Cmp + cm
        tile = torch.matmul(a2, w2).reshape(BAND_ROWS, CHUNK_COLS, co)
        rows, cols = min(BAND_ROWS, h - r0), min(CHUNK_COLS, w - c0)
        y[b, :, r0:r0 + rows, c0:c0 + cols] = \
            tile[:rows, :cols].permute(2, 0, 1)
    return y.to(out_dtype)


def bulge_packed(x, wT, scale, bias, wC, *, stats="pooled", running=None,
                 groups=None, eps=1e-5):
    """The pair through `packed_stats` and `packed_main`, with the wrapper's
    own reduction: the same signature and results as ops/bulge.py
    bulge_plain."""
    bsz, _, h, w = x.shape
    cm = wT.shape[1]
    if stats == "running":
        mean, var = running
        mu, v = mean.expand(bsz, cm), var.expand(bsz, cm)
    else:
        g = bsz if stats == "per_image" else (groups or 1)
        mean, var = reduce_partials(packed_stats(x, wT), 4 * h * w, g)
        mu = mean.repeat_interleave(bsz // g, dim=0)
        v = var.repeat_interleave(bsz // g, dim=0)
        if stats == "pooled" and groups is None:
            mean, var = mean[0], var[0]
    gain = torch.rsqrt(v + eps) * scale.float()
    return packed_main(x, wT, wC, mu, gain, bias.float()), (mean, var)


# ---------------------------------------------------------------------------
# the fp32 wgmma kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def _plane_steps(plane, k, n):
    """A `to_wgmma_tf32` plane read back k-step by k-step through the
    descriptor's addressing: (k // 8, 8, n)."""
    kk, nn = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
    kk, nn = torch.from_numpy(kk), torch.from_numpy(nn)
    return torch.stack([wgmma_read_tf32(plane, kk, nn, n, ks)
                        for ks in range(k // 8)])


def _tf32x3(a_steps, op, k, n):
    """sum over k-steps of A (M, 8) @ B (8, n) as the kernel issues it: A
    split (hi = tf32(a), lo = a - hi), B's packed planes (hi, lo), three
    TF32 products a step (lo*hi, hi*lo, hi*hi) added to an fp32
    accumulator in that order; the tensor cores read an operand's upper 19
    bits."""
    hi, lo = _plane_steps(op[:k * n], k, n), _plane_steps(op[k * n:], k, n)
    acc = None
    for ks, a in enumerate(a_steps):
        ah = trunc_tf32(a)
        al = trunc_tf32(a - ah)
        for p in (al @ hi[ks], ah @ trunc_tf32(lo[ks]), ah @ hi[ks]):
            acc = p if acc is None else acc + p
    return acc


def _stage1_tf32(x_img, w1, r0, c0, rows):
    """HP (rows+1, TW+1, 4 Cm) of one item from its TMA box: A read from
    the box as the kernel's lanes read it (k = tap*Ci + ci, k-steps of 8),
    against the packed W1 planes."""
    ci = x_img.shape[0]
    pc, npos = CHUNK_COLS + 1, (rows + 1) * (CHUNK_COLS + 1)
    box = tma_box(x_img, r0, c0, torch.float32, rows)
    q = torch.arange(npos)
    pi, pj = q // pc, q % pc
    taps = [box[:, pi + ti, F32_BOX_COL0 + pj + tj].T
            for ti in range(2) for tj in range(2)]     # each (npos, Ci)
    a1 = torch.cat(taps, dim=1)                          # k = tap*Ci + ci
    steps = [a1[:, 8 * ks:8 * ks + 8] for ks in range(ci // 2)]
    n = w1.numel() // (2 * 4 * ci)
    return _tf32x3(steps, w1, 4 * ci, n).reshape(rows + 1, pc, n)


def wgmma_f32_stats(x, wT):
    """What the fp32 wgmma stats launch writes: (B, slots, 2, Cm) sums and
    sums of squares of the hidden cells each item owns, items of BAND_ROWS
    rows."""
    bsz, ci, h, w = x.shape
    cm = wT.shape[1]
    w1 = packed_operand("wT", wT, torch.float32, "wgmma")
    sched = Schedule(bsz, h, w)
    li = torch.arange(BAND_ROWS + 1)[:, None]
    lj = torch.arange(CHUNK_COLS + 1)[None, :]
    out = x.new_zeros((sched.n_items, 2, cm))
    for idx in range(sched.n_items):
        b, r0, c0 = sched.item(idx)
        hp = _stage1_tf32(x[b], w1, r0, c0, BAND_ROWS).reshape(
            BAND_ROWS + 1, CHUNK_COLS + 1, 4, cm)
        for par in range(4):
            di, dj = par >> 1, par & 1
            own = ((li - di >= 0) & (li - di < BAND_ROWS) & (lj - dj >= 0)
                   & (lj - dj < CHUNK_COLS) & (r0 + li - di < h)
                   & (c0 + lj - dj < w))
            v = hp[:, :, par] * own[:, :, None]
            out[idx, 0] += v.sum(dim=(0, 1))
            out[idx, 1] += (v * v).sum(dim=(0, 1))
    return out.reshape(bsz, sched.per_image, 2, cm)


def wgmma_f32_main(x, wT, wC, mu, gain, beta):
    """What the fp32 wgmma main launch writes: y (B, Co, H, W), items of
    `f32_main_rows(Ci)` rows; stage 2 reads the hidden planes in KPERM8's
    k order against the packed W2 planes."""
    bsz, ci, h, w = x.shape
    cm, co = wT.shape[1], wC.shape[0]
    rows = f32_main_rows(ci)
    w1 = packed_operand("wT", wT, torch.float32, "wgmma")
    w2 = packed_operand("wC", wC, torch.float32, "wgmma")
    sched = Schedule(bsz, h, w, rows)
    pc = CHUNK_COLS + 1
    ml = torch.arange(rows * CHUNK_COLS) // CHUNK_COLS
    nl = torch.arange(rows * CHUNK_COLS) % CHUNK_COLS
    y = x.new_zeros((bsz, co, h, w))
    for idx in range(sched.n_items):
        b, r0, c0 = sched.item(idx)
        hp = _stage1_tf32(x[b], w1, r0, c0, rows).reshape(
            rows + 1, pc, 4, cm)
        hp = torch.relu(hp * gain[b] + (beta - mu[b] * gain[b]))
        pos = torch.arange((rows + 1) * pc)
        mask = []
        for par in range(4):
            di, dj = par >> 1, par & 1
            i, j = r0 - di + pos // pc, c0 - dj + pos % pc
            mask.append((i >= 0) & (i < h) & (j >= 0) & (j < w))
        hp = hp.reshape(-1, 4, cm) * torch.stack(mask, 1)[:, :, None]
        steps = []
        for ks in range(2 * cm):
            cols = []
            for kk in KPERM8:
                k = ks * 8 + kk
                tap, c = divmod(k, cm)
                a, cc = divmod(tap, 4)
                par = ((a + 1) & 1) * 2 + ((cc + 1) & 1)
                cols.append(hp[(ml + a // 2) * pc + nl + cc // 2, par, c])
            steps.append(torch.stack(cols, 1))
        tile = _tf32x3(steps, w2, 16 * cm, co).reshape(
            rows, CHUNK_COLS, co)
        nr, nc = min(rows, h - r0), min(CHUNK_COLS, w - c0)
        y[b, :, r0:r0 + nr, c0:c0 + nc] = tile[:nr, :nc].permute(2, 0, 1)
    return y


def bulge_wgmma_f32(x, wT, scale, bias, wC, *, stats="pooled", running=None,
                    groups=None, eps=1e-5):
    """The pair through `wgmma_f32_stats` and `wgmma_f32_main` with the
    wrapper's own reduction: the signature and results of ops/bulge.py
    bulge_plain, for fp32 x at a triple the kernel was built for."""
    bsz, _, h, w = x.shape
    cm = wT.shape[1]
    if stats == "running":
        mean, var = running
        mu, v = mean.expand(bsz, cm), var.expand(bsz, cm)
    else:
        g = bsz if stats == "per_image" else (groups or 1)
        mean, var = reduce_partials(wgmma_f32_stats(x, wT), 4 * h * w, g)
        mu = mean.repeat_interleave(bsz // g, dim=0)
        v = var.repeat_interleave(bsz // g, dim=0)
        if stats == "pooled" and groups is None:
            mean, var = mean[0], var[0]
    gain = torch.rsqrt(v + eps) * scale.float()
    return wgmma_f32_main(x, wT, wC, mu, gain, bias.float()), (mean, var)
