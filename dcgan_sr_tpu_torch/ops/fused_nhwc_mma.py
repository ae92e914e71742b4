"""Host side of the tensor-core channels-last pair (csrc/fused_nhwc.cu,
namespace tc): the kernel's two weight operands in mma fragment order, the
schedule of work items, and a plain PyTorch "packed" version of the two
launches written from the same operands, item by item, as the kernel walks
them.

The operands are the JAX kernel's packed weights (ops/fused_nhwc.py
`_pack_wT`, `_pack_wC`; dcgan_sr_tpu/ops/pallas_fused.py):

  W1 = wtall (4 Ci x 4 Cmp)  rows (ti, tj, ci), columns (di, dj, cm);
  W2 = wcall (16 Cmp x Cop)  rows (k = di*2 + dj, sa, sb, cm), columns co;

with Cm, and Co, padded to a multiple of 8 by zero weights (mma tiles are 8
columns wide: Cm 4 runs as 8).  Each goes to the card in mma.m16n8k8
B-fragment order with the k index permuted within every group of 8 rows
(`KPERM`): mma k = t reads channel 2t and k = t + 4 channel 2t + 1, so that a
lane's two A elements of a row are adjacent channels of one NHWC pixel and
arrive in one 8-byte load.  This order is K3's own; the NCHW kernel of
ops/bulge_mma.py keeps the plain fragment order and its own W2 row order
(a*4 + c, cm), and nothing is shared between the two modules.

bf16 (namespace tcb of the same source): the same W1 and W2, rounded to
bf16, in mma.m16n8k16 B-fragment order (`to_fragments_bf16`).  There a
lane's register j holds the k-adjacent pair 8j + 2t, 8j + 2t + 1, so the
natural order would already give one 4-byte load a register.  The k index
is permuted all the same, within every group of 16 (`KPERM16`): mma k
8j + 2t + i reads channel 4t + 2j + i, so a lane's two registers of a row
are channels 4t .. 4t + 3 of one NHWC pixel and arrive in ONE 8-byte load.
The fp32 kernel's KPERM does not carry over: it serves m16n8k8 TF32, whose
registers hold one value each, and pairs k = t with k = t + 4.  A group
of 16 is four runs of 4 channels, and the channel counts are multiples of
8, so a run never straddles two taps (stage 1) or two windows (stage 2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PASS_ROWS = 8        # R: rows of a work item (csrc/fused_nhwc.cu tc::R)
CHUNK_COLS = 32      # TW: columns of a work item (tc::TW)

# (Ci, Cm, Co) with a compiled tensor-core instantiation
MMA_TRIPLES = ((8, 4, 8), (16, 8, 16), (32, 16, 32))

# the channel that mma k index kk of a k step reads, within its group of 8
KPERM = (0, 2, 4, 6, 1, 3, 5, 7)
# bf16 (m16n8k16): the channel that mma k index kk reads, within its group
# of 16: kk = 8j + 2t + i reads 4t + 2j + i
KPERM16 = tuple(4 * ((kk % 8) // 2) + 2 * (kk // 8) + kk % 2
                for kk in range(16))


def padded(c):
    """A channel count padded to the mma tile: a multiple of 8."""
    return -(-c // 8) * 8


# ---------------------------------------------------------------------------
# fragment order
# ---------------------------------------------------------------------------

def permute_k(mat):
    """Rows of a (K, N) operand in the kernel's k order: row kk of every
    group of 8 is row KPERM[kk] of the group."""
    k = mat.shape[0]
    return mat.reshape(k // 8, 8, -1)[:, list(KPERM)].reshape(k, -1)


def permute_k16(mat):
    """Rows of a (K, N) operand in the bf16 kernel's k order: row kk of
    every group of 16 is row KPERM16[kk] of the group."""
    k = mat.shape[0]
    return mat.reshape(k // 16, 16, -1)[:, list(KPERM16)].reshape(k, -1)


def unpermute_k(mat):
    k = mat.shape[0]
    inv = [KPERM.index(i) for i in range(8)]
    return mat.reshape(k // 8, 8, -1)[:, inv].reshape(k, -1)


def to_fragments(mat):
    """A (K, N) B operand in K3's fragment order, flat: element
    [((ks*NT + nt)*32 + lane)*2 + j] = mat[ks*8 + KPERM[lane%4 + 4j],
    nt*8 + lane//4], i.e. lane g*4 + t holds channels 2t and 2t + 1 of
    column g of each 8x8 block."""
    k, n = mat.shape
    blocks = permute_k(mat).reshape(k // 8, 2, 4, n // 8, 8)  # ks, j, t, nt, g
    return blocks.permute(0, 3, 4, 2, 1).reshape(-1)          # ks, nt, g, t, j


def from_fragments(flat, k, n):
    """The (K, N) operand back from `to_fragments`, rows in the kernel's
    permuted k order."""
    return flat.reshape(k // 8, n // 8, 8, 4, 2).permute(0, 4, 3, 1, 2) \
        .reshape(k, n)


def to_fragments_bf16(mat):
    """A (K, N) B operand in the bf16 kernel's m16n8k16 fragment order,
    flat: element [(((ks*NT + nt)*32 + lane)*2 + j)*2 + i] =
    mat[ks*16 + KPERM16[8j + 2t + i], nt*8 + g] (lane = g*4 + t), i.e. lane
    g*4 + t holds channels 4t .. 4t + 3 of column g of each 16x8 block, one
    8-byte load."""
    k, n = mat.shape
    blocks = permute_k16(mat).reshape(k // 16, 2, 4, 2, n // 8, 8)
    return blocks.permute(0, 4, 5, 2, 1, 3).reshape(-1)  # ks, nt, g, t, j, i


def from_fragments_bf16(flat, k, n):
    """The (K, N) operand back from `to_fragments_bf16`, rows in the bf16
    kernel's permuted k order."""
    return flat.reshape(k // 16, n // 8, 8, 4, 2, 2) \
        .permute(0, 4, 3, 5, 1, 2).reshape(k, n)


def _order(bf16):
    """(k permutation, operand unpacker) of the kernel of that dtype."""
    return (permute_k16, from_fragments_bf16) if bf16 else \
        (permute_k, from_fragments)


def w1_operand_index(wtall_index, ci, cm, fill, bf16=False):
    """Flat gather indices of W1 in fragment order (bf16: the m16n8k16
    one), from the (4 Ci, 4 Cm) index matrix of wtall; padding entries get
    `fill` (a zero)."""
    out = torch.full((4, padded(ci), 4, padded(cm)), fill, dtype=torch.int64)
    out[:, :ci, :, :cm] = wtall_index.reshape(4, ci, 4, cm)
    order = to_fragments_bf16 if bf16 else to_fragments
    return order(out.reshape(4 * padded(ci), 4 * padded(cm)))


def w2_operand_index(wcall_index, cm, co, fill, bf16=False):
    """Flat gather indices of W2 in fragment order (bf16: the m16n8k16
    one), from the (16 Cm, Co) index matrix of wcall."""
    out = torch.full((16, padded(cm), padded(co)), fill, dtype=torch.int64)
    out[:, :cm, :co] = wcall_index.reshape(16, cm, co)
    order = to_fragments_bf16 if bf16 else to_fragments
    return order(out.reshape(16 * padded(cm), padded(co)))


# ---------------------------------------------------------------------------
# the schedule of work items
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """Work items of one launch on x (B, H, W, Ci) in bands of tm rows: item
    idx is (image, band, pass of PASS_ROWS rows of the band, chunk of
    CHUNK_COLS columns), chunk fastest, then pass, band, image; a pass ends
    at its band's end.  Block k of a persistent grid of G blocks takes items
    k, k+G, ...; item idx writes its statistics to slot idx, so the slots of
    image b are [b*per_image, (b+1)*per_image)."""
    batch: int
    h: int
    w: int
    tm: int

    @property
    def bands(self):
        return self.h // self.tm

    @property
    def passes(self):
        return -(-self.tm // PASS_ROWS)

    @property
    def chunks(self):
        return -(-self.w // CHUNK_COLS)

    @property
    def per_image(self):
        return self.bands * self.passes * self.chunks

    @property
    def n_items(self):
        return self.batch * self.per_image

    def item(self, idx):
        """(image, first row, end row, first column) of item idx."""
        rest, chunk = divmod(idx, self.chunks)
        rest, pas = divmod(rest, self.passes)
        b, band = divmod(rest, self.bands)
        r0 = band * self.tm + pas * PASS_ROWS
        return b, r0, min(r0 + PASS_ROWS, (band + 1) * self.tm), \
            chunk * CHUNK_COLS

    def owned(self, idx):
        """The hidden cells whose statistics item idx counts, as (image,
        rows, cols) index arrays of the (2H, 2W) hidden image: parity
        (di, dj) at local position (pi, pj) is hidden cell
        (2(r0 + pi) - di, 2(c0 + pj) - dj), owned where row r0 + pi - di lies
        in [r0, rend) and column c0 + pj - dj in [c0, min(c0 + TW, W))."""
        b, r0, rend, c0 = self.item(idx)
        cend = min(c0 + CHUNK_COLS, self.w)
        rows, cols = [], []
        for di in range(2):
            for dj in range(2):
                for pi in range(PASS_ROWS + 1):
                    for pj in range(CHUNK_COLS + 1):
                        i, j = r0 + pi - di, c0 + pj - dj
                        if r0 <= i < rend and c0 <= j < cend:
                            rows.append(2 * (r0 + pi) - di)
                            cols.append(2 * (c0 + pj) - dj)
        return b, np.asarray(rows), np.asarray(cols)


# ---------------------------------------------------------------------------
# the packed plain version of the two launches
# ---------------------------------------------------------------------------

def _stage1_item(x_img, w1, r0, c0, permute=permute_k):
    """P (PR, PC, 4 Cmp) of one item: A1 @ W1 over the staged x window, with
    A1's columns in the kernel's permuted k order like W1's rows.  x_img
    (H, W, Ci) NHWC; w1 (4 Cip, 4 Cmp) in permuted row order."""
    h, w, ci = x_img.shape
    cip = w1.shape[0] // 4
    pr, pc = PASS_ROWS + 1, CHUNK_COLS + 1
    xs = x_img.new_zeros((pr + 1, pc + 1, cip))
    i0, i1 = max(r0 - 1, 0), min(r0 + PASS_ROWS + 1, h)
    j0, j1 = max(c0 - 1, 0), min(c0 + CHUNK_COLS + 1, w)
    xs[i0 - (r0 - 1):i1 - (r0 - 1), j0 - (c0 - 1):j1 - (c0 - 1), :ci] = \
        x_img[i0:i1, j0:j1]
    taps = [xs[ti:ti + pr, tj:tj + pc] for ti in range(2) for tj in range(2)]
    a1 = torch.cat(taps, dim=-1).reshape(pr * pc, 4 * cip)   # k = tap*Cip + ci
    a1 = permute(a1.T).T
    return torch.matmul(a1, w1).reshape(pr, pc, -1)


def packed_stats(xn, w1_op, ci, cm, tm):
    """What the stats launch writes: (B, slots, 2, Cm) fp32 sums and sums of
    squares of the hidden cells each item owns.  xn (B, H, W, Ci) NHWC,
    w1_op W1 in fragment order; bf16 xn and w1_op (the bf16 kernel's): the
    products in fp32 on the upcast values, which are exact."""
    bsz, h, w, _ = xn.shape
    cmp_ = padded(cm)
    permute, unpack = _order(xn.dtype == torch.bfloat16)
    xn = xn.float()
    w1 = unpack(w1_op, 4 * padded(ci), 4 * cmp_).float()
    sched = Schedule(bsz, h, w, tm)
    pi = torch.arange(PASS_ROWS + 1)[:, None]
    pj = torch.arange(CHUNK_COLS + 1)[None, :]
    out = xn.new_zeros((sched.n_items, 2, cm))
    for idx in range(sched.n_items):
        b, r0, rend, c0 = sched.item(idx)
        cend = min(c0 + CHUNK_COLS, w)
        p = _stage1_item(xn[b], w1, r0, c0, permute).reshape(
            PASS_ROWS + 1, CHUNK_COLS + 1, 4, cmp_)
        for par in range(4):
            di, dj = par >> 1, par & 1
            own = ((pi - di >= 0) & (r0 + pi - di < rend) & (pj - dj >= 0)
                   & (c0 + pj - dj < cend)).to(xn.device)
            v = p[:, :, par, :cm] * own[:, :, None]
            out[idx, 0] += v.sum(dim=(0, 1))
            out[idx, 1] += (v * v).sum(dim=(0, 1))
    return out.reshape(bsz, sched.per_image, 2, cm)


def _in_image(r0, c0, h, w, device):
    """(PR, PC, 4) mask: does parity p's hidden cell at (pi, pj) lie inside
    the hidden image (else it is the consumer's zero padding)."""
    pi = torch.arange(PASS_ROWS + 1, device=device)[:, None]
    pj = torch.arange(CHUNK_COLS + 1, device=device)[None, :]
    out = []
    for di in range(2):
        for dj in range(2):
            i, j = r0 + pi - di, c0 + pj - dj
            out.append((i >= 0) & (i < h) & (j >= 0) & (j < w))
    return torch.stack(out, dim=-1)


def packed_main(xn, w1_op, w2_op, bn, ci, cm, co, tm):
    """What the main launch writes: y (B, H, W, Co) NHWC in xn's dtype.  bn
    (3, 4 Cm): mean, gain and bias, each tiled over the four parities.  bf16
    (the bf16 kernel's operands): both products in fp32 on the upcast
    values; the planes rounded to bf16 after BN, ReLU and the edge mask, y
    after the second product."""
    bsz, h, w, _ = xn.shape
    cmp_, cop = padded(cm), padded(co)
    bf16 = xn.dtype == torch.bfloat16
    permute, unpack = _order(bf16)
    w1 = unpack(w1_op, 4 * padded(ci), 4 * cmp_).float()
    w2 = unpack(w2_op, 16 * cmp_, cop).float()
    mu, gain, beta = (torch.nn.functional.pad(v[:cm], (0, cmp_ - cm))
                      for v in bn)
    sched = Schedule(bsz, h, w, tm)
    y = xn.new_zeros((bsz, h, w, co))
    xn = xn.float()
    for idx in range(sched.n_items):
        b, r0, rend, c0 = sched.item(idx)
        p = _stage1_item(xn[b], w1, r0, c0, permute).reshape(
            PASS_ROWS + 1, CHUNK_COLS + 1, 4, cmp_)
        p = torch.relu((p - mu) * gain + beta)
        p = p * _in_image(r0, c0, h, w, xn.device)[..., None]
        if bf16:
            p = p.to(torch.bfloat16).float()
        taps = [p[sa:sa + PASS_ROWS, sb:sb + CHUNK_COLS, k]
                for k in range(4) for sa in range(2) for sb in range(2)]
        a2 = torch.stack(taps, dim=2).reshape(PASS_ROWS * CHUNK_COLS,
                                              16 * cmp_)  # (k, sa, sb, cm)
        a2 = permute(a2.T).T
        tile = torch.matmul(a2, w2).reshape(PASS_ROWS, CHUNK_COLS, cop)
        rows, cols = rend - r0, min(CHUNK_COLS, w - c0)
        y[b, r0:rend, c0:c0 + cols] = tile[:rows, :cols, :co]
    return y
