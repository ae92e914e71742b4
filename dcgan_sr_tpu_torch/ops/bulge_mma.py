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


def _fragment_index(kind, shape, device, dtype=torch.float32):
    """Flat gather indices of a weight of `shape` into its operand in the
    fragment order of `dtype`'s mma, on `device`; kind "wT" or "wC"."""
    key = (kind, tuple(shape[:2]), str(device), dtype)
    if key not in _index_cache:
        idx = _w1_index(*shape[:2]) if kind == "wT" else \
            _w2_index(shape[1], shape[0])
        order = to_fragments_bf16 if dtype == torch.bfloat16 else to_fragments
        _index_cache[key] = torch.from_numpy(
            np.ascontiguousarray(order(idx))).to(device)
    return _index_cache[key]


# Operands of the weights seen last, so a server packs its generator's pair
# once.  An entry keeps its source tensor alive and is valid while that very
# tensor has not been written to.
_packed = OrderedDict()
_PACKED_MAX = 16


def packed_operand(kind, w, dtype=torch.float32):
    """W1 of wT (kind "wT") or W2 of wC (kind "wC") in the fragment order of
    `dtype`'s mma (fp32: m16n8k8 TF32, bf16: m16n8k16), flat, in `dtype` on
    w's device."""
    key = (kind, id(w), dtype)
    hit = _packed.get(key)
    if hit is not None and hit[0] is w and hit[1] == w._version:
        _packed.move_to_end(key)
        return hit[2]
    op = _gather(w.detach().float(),
                 _fragment_index(kind, w.shape, w.device, dtype)).to(dtype)
    _packed[key] = (w, w._version, op)
    while len(_packed) > _PACKED_MAX:
        _packed.popitem(last=False)
    return op


# ---------------------------------------------------------------------------
# the schedule of work items
# ---------------------------------------------------------------------------

def slots_per_image(h, w):
    """Work items, and so statistics slots, of one (h, w) image."""
    return -(-h // BAND_ROWS) * -(-w // CHUNK_COLS)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Work items of one launch on x (B, Ci, H, W): item idx is (image,
    band of BAND_ROWS y rows, chunk of CHUNK_COLS y columns), chunk fastest;
    block k of a persistent grid of G blocks takes items k, k+G, ...  Item
    idx writes its statistics to slot idx of `partial`, so the slots of image
    b are [b*per_image, (b+1)*per_image)."""
    batch: int
    h: int
    w: int

    @property
    def bands(self):
        return -(-self.h // BAND_ROWS)

    @property
    def chunks(self):
        return -(-self.w // CHUNK_COLS)

    @property
    def per_image(self):
        return slots_per_image(self.h, self.w)

    @property
    def n_items(self):
        return self.batch * self.per_image

    def item(self, idx):
        """(image, first y row, first y column) of item idx."""
        rest, chunk = divmod(idx, self.chunks)
        b, band = divmod(rest, self.bands)
        return b, band * BAND_ROWS, chunk * CHUNK_COLS

    def owned(self, idx):
        """The hidden cells whose statistics item idx counts, as
        (image, rows, cols) index arrays of the (2H, 2W) hidden image: local
        position (pi, pj) of parity (di, dj) is owned where (pi - di,
        pj - dj) lies in [0, R) x [0, TW) and in the image."""
        b, r0, c0 = self.item(idx)
        rows, cols = [], []
        for di in range(2):
            for dj in range(2):
                for pi in range(BAND_ROWS + 1):
                    for pj in range(CHUNK_COLS + 1):
                        li, lj = pi - di, pj - dj
                        if 0 <= li < BAND_ROWS and 0 <= lj < CHUNK_COLS \
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

def _stage1_item(x_img, w1, r0, c0):
    """HP (PR, PC, 4 Cmp) of one item: A1 @ W1 over the staged x window."""
    ci, h, w = x_img.shape
    pr, pc = BAND_ROWS + 1, CHUNK_COLS + 1
    xs = x_img.new_zeros((ci, pr + 1, pc + 1))
    i0, i1 = max(r0 - 1, 0), min(r0 + BAND_ROWS + 1, h)
    j0, j1 = max(c0 - 1, 0), min(c0 + CHUNK_COLS + 1, w)
    xs[:, i0 - (r0 - 1):i1 - (r0 - 1), j0 - (c0 - 1):j1 - (c0 - 1)] = \
        x_img[:, i0:i1, j0:j1]
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
