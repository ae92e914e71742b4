"""Host side of the channels-last pair on Hopper's units
(csrc/fused_nhwc_wgmma.cu; namespace wgf in fp32, wgb in bf16): the weights
in wgmma's K-major shared-memory layout, the geometry of a work item and of
the x box its TMA loads write, the descriptor start offsets of every k-step
of both products, and an emulation of the kernel's arithmetic, item by item
from the same operands, read through the same addressing.

The two products are the JAX kernel's (dcgan_sr_tpu/ops/pallas_fused.py
:77-92, :155-166), regrouped for wgmma:

  stage 1  HP (positions x 4 Cm) = A1 (positions x 4 Ci) @ W1 (4 Ci x 4 Cm),
           W1 = wtall: rows (ti, tj, ci), columns (di, dj, cm).  Position
           (pi, pj), pi in [0, R], pj in [0, TW], reads x rows r0-1+pi+ti,
           columns c0-1+pj+tj.
  stage 2  Y (pixels x Co) = A2 (pixels x 16 Cm) @ W2 (16 Cm x Co), W2 =
           wcall with its rows reordered to (sa, sb, di, dj, cm) (`w2_rows`):
           pixel (ml, nl) reads hidden plane (di, dj) at (ml+sa, nl+sb).

Both A operands come straight from shared memory by descriptor, K-major
without swizzle: a core matrix is 8 M rows of 16 bytes (4 fp32 or 8 bf16
channels).  x arrives as the box [channel group][row][column][16 bytes]
(`tma_box`): one 4-D tensor map per 16-byte channel group over NHWC x (B, H,
W, Ci), box 16 bytes x BC columns x XR rows from (c0-1, r0-1), the halo and
the image's edges zero-filled by the hardware.  Stage 1's M rows are the
box's positions q = pi*BC + pj flattened (the rows with pj > TW wrap into
the next box row and are computed and never used), a tap (ti, tj) moves the
start by ti*BC + tj units, a k-step's two core matrices are two channel
groups one box plane apart.  The hidden planes hp[(di, dj, group)][pi*PC +
pj] are written by the kernel in the same K-major layout (PS units a plane);
a stage-2 tile is 8 y rows x 8 y columns, so its 8-row core groups are y
rows, PC units apart, and a window (sa, sb) moves the start by sa*PC + sb.

fp32 (3xTF32): W1 and W2 go to the card as two planes, hi = tf32(w)
(truncated) and lo = w - hi (`to_wgmma`).  wgmma reads an fp32 word as its
truncation (chip_smoke.py tf32_probe_phase), which is the split's hi, so
hi*hi and hi*lo read A by descriptor from the box or the hidden planes and
only lo*hi takes A from registers, lo = a - trunc(a) computed there.  bf16:
one bf16 plane of each weight, one product a k-step.
"""

from __future__ import annotations

import dataclasses

import torch

ROWS = 8             # R: y rows of a work item, every launch
STATS_COLS = 32      # TW of the stats launch's items
# (Ci, Cm, Co) with an instantiation
TRIPLES = ((16, 8, 16), (32, 16, 32))


def elems16(dtype):
    """Elements of a 16-byte unit (a core matrix row): 4 fp32, 8 bf16."""
    return 8 if dtype == torch.bfloat16 else 4


def main_cols(ci, dtype):
    """TW of the main launch's items: 16 for fp32 at Ci 32, where the
    weights' two planes leave room for no more, else 32."""
    return 16 if dtype != torch.bfloat16 and ci >= 32 else 32


@dataclasses.dataclass(frozen=True)
class Geo:
    """The shared-memory geometry of one work item of TW columns (the
    kernel's nhwc::Geo).  Units are 16 bytes."""
    tw: int
    ci: int
    cm: int
    dtype: torch.dtype = torch.float32

    @property
    def e(self):
        return elems16(self.dtype)

    @property
    def bc(self):                 # box columns: x columns c0-1 .. c0+TW
        return self.tw + 2

    @property
    def xr(self):                 # box rows: x rows r0-1 .. r0+R
        return ROWS + 2

    @property
    def plane(self):              # units a box plane (channel group) holds
        return self.xr * self.bc

    @property
    def bp(self):
        """Units a box plane takes: a multiple of 8, so that every plane's
        TMA lands 128-byte aligned."""
        return -(-self.plane // 8) * 8

    @property
    def cig(self):                # box planes
        return self.ci // self.e

    @property
    def lastq(self):              # the last stage-1 row that is a position
        return ROWS * self.bc + self.tw

    @property
    def m1t(self):                # stage-1 m64 tiles
        return (self.lastq + 64) // 64

    @property
    def box_units(self):
        """The box buffer: its planes, and past them what the wrapped rows
        of the last tile read with the largest tap."""
        return max(self.cig * self.bp,
                   (self.cig - 1) * self.bp + self.m1t * 64 + self.bc + 1)

    @property
    def pc(self):                 # hidden-plane position columns
        return self.tw + 1

    @property
    def npos(self):
        return (ROWS + 1) * self.pc

    @property
    def ps(self):
        """Units a hidden plane: npos padded to 4 mod 8, so that the
        epilogue's 8-byte stores of a half warp meet no bank conflict."""
        return self.npos + (4 - self.npos % 8) % 8

    @property
    def hpn(self):                # hidden planes: (di, dj, channel group)
        return 4 * self.cm // self.e

    @property
    def m2t(self):                # stage-2 m64 tiles of 8 x 8 pixels
        return self.tw // 8

    @property
    def k1s(self):                # stage-1 k-steps of 32 bytes
        return 4 * self.ci // (2 * self.e)

    @property
    def k2s(self):
        return 16 * self.cm // (2 * self.e)

    def stage1_koff(self, ks):
        """Units from the tile's start to k-step ks's first core matrix:
        k = tap*Ci + ci, tap = ti*2 + tj, two channel groups a k-step."""
        per_tap = self.cig // 2
        tap, cgp = divmod(ks, per_tap)
        return 2 * cgp * self.bp + (tap >> 1) * self.bc + (tap & 1)

    def stage2_koff(self, ks):
        """Units from the hidden planes' start to k-step ks's first core
        matrix: k = ((sa*2 + sb)*4 + di*2 + dj)*Cm + cm, two planes a
        k-step."""
        per_win = self.hpn // 2
        s, pp = divmod(ks, per_win)
        return 2 * pp * self.ps + (s >> 1) * self.pc + (s & 1)

    # descriptor byte offsets: (leading, stride) of A in each stage
    @property
    def a1_offsets(self):
        return self.bp * 16, 128

    @property
    def a2_offsets(self):
        return self.ps * 16, self.pc * 16


def geo(ci, cm, dtype, main):
    return Geo(main_cols(ci, dtype) if main else STATS_COLS, ci, cm, dtype)


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------

def w2_rows(cm):
    """wcall's row of W2's row k: W2 row (sa, sb, par, cm) is wcall row
    (par, sa, sb, cm), par = di*2 + dj."""
    out = []
    for sa in range(2):
        for sb in range(2):
            for par in range(4):
                base = ((par * 2 + sa) * 2 + sb) * cm
                out.extend(range(base, base + cm))
    return out


def to_wgmma(mat, e):
    """A (K, N) B operand in wgmma's canonical K-major layout without
    swizzle, flat: element [((kb*(N/8) + nb)*8 + r)*e + i] = mat[kb*e + i]
    [nb*8 + r]: core matrix (kb, nb) is 8 n-rows of e k-values (16 bytes),
    core matrices k-block major, so the descriptor's leading offset is
    N/8 * 128 bytes and its stride 128."""
    k, n = mat.shape
    return mat.reshape(k // e, e, n // 8, 8).permute(0, 2, 3, 1).reshape(-1)


def b_offsets(n):
    """(leading, stride) byte offsets of a `to_wgmma` operand of N = n."""
    return n // 8 * 128, 128


def read_b(flat, k, n, n_cols, e, ks=0):
    """Element (k, n) of k-step ks (2e rows) of a `to_wgmma` plane, read as
    the descriptor addresses it: start ks * 2 * leading, then (k // e) *
    leading + (n // 8) * stride + (n % 8) * 16 + (k % e) * 16 / e bytes."""
    lead, stride = b_offsets(n_cols)
    byte = (ks * 2 * lead + (k // e) * lead + (n // 8) * stride
            + (n % 8) * 16 + (k % e) * (16 // e))
    return flat[byte // (16 // e)]


def trunc_tf32(a):
    """fp32 -> TF32 as the tensor cores read an fp32 word: its upper 19
    bits."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def operands(wtall, wcall, dtype):
    """(W1, W2) as the kernel stages them, flat on the weights' device:
    fp32, each the planes (hi, lo) of `to_wgmma`, hi = tf32(w) and lo =
    w - hi; bf16, the packed weights rounded to bf16 (pallas_fused.py
    :193-194), one plane each."""
    cm = wtall.shape[1] // 4
    w2 = wcall[w2_rows(cm)]
    e = elems16(dtype)
    out = []
    for mat in (wtall.float(), w2.float()):
        flat = to_wgmma(mat, e)
        if dtype == torch.bfloat16:
            out.append(flat.to(torch.bfloat16).contiguous())
        else:
            hi = trunc_tf32(flat)
            out.append(torch.cat([hi, flat - hi]).contiguous())
    return tuple(out)


# ---------------------------------------------------------------------------
# the schedule and the box
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """Work items of one launch on x (B, H, W, Ci) NHWC: item idx is
    (image, band of ROWS y rows, chunk of `tw` y columns), chunk fastest;
    each warpgroup of a persistent block takes every other item of its
    block.  The stats launch writes its sums to slot idx."""
    batch: int
    h: int
    w: int
    tw: int = STATS_COLS

    @property
    def bands(self):
        return -(-self.h // ROWS)

    @property
    def chunks(self):
        return -(-self.w // self.tw)

    @property
    def per_image(self):
        return self.bands * self.chunks

    @property
    def n_items(self):
        return self.batch * self.per_image

    def item(self, idx):
        """(image, first y row, first y column) of item idx."""
        rest, chunk = divmod(idx, self.chunks)
        b, band = divmod(rest, self.bands)
        return b, band * ROWS, chunk * self.tw

    def owned(self, idx):
        """The hidden cells whose statistics item idx counts, as (image,
        rows, cols) of the (2H, 2W) hidden image: parity (di, dj) at
        position (pi, pj) is hidden cell (2(r0+pi) - di, 2(c0+pj) - dj),
        owned where pi - di lies in [0, R), pj - dj in [0, TW), inside the
        image."""
        b, r0, c0 = self.item(idx)
        rows, cols = [], []
        for di in range(2):
            for dj in range(2):
                for pi in range(ROWS + 1):
                    for pj in range(self.tw + 1):
                        li, lj = pi - di, pj - dj
                        if 0 <= li < ROWS and 0 <= lj < self.tw and \
                                r0 + li < self.h and c0 + lj < self.w:
                            rows.append(2 * (r0 + pi) - di)
                            cols.append(2 * (c0 + pj) - dj)
        return b, rows, cols


def box_origin(r0, c0):
    """(column, row) coordinates of item (r0, c0)'s box in every channel
    group's tensor map, innermost (the 16-byte unit, coordinate 0) left
    out; negative at the image's top and left edges."""
    return c0 - 1, r0 - 1


def box_extent(g):
    """(16-byte unit in elements, columns, rows, images) of the box."""
    return g.e, g.bc, g.xr, 1


def tma_box(x_img, r0, c0, g):
    """The box the kernel's TMA loads write for item (r0, c0) of x_img (H,
    W, Ci) NHWC: (box_units, e), unit cg*bp + row*bc + col holding x
    channels cg*e .. cg*e+e-1 at (r0-1+row, c0-1+col), zero outside the
    image; the units between and past the planes are zero here (the kernel
    never uses what it computes from them)."""
    h, w, ci = x_img.shape
    c, r = box_origin(r0, c0)
    win = x_img.new_zeros((g.xr, g.bc, ci))
    i0, i1 = max(r, 0), min(r + g.xr, h)
    j0, j1 = max(c, 0), min(c + g.bc, w)
    if i1 > i0 and j1 > j0:
        win[i0 - r:i1 - r, j0 - c:j1 - c] = x_img[i0:i1, j0:j1]
    planes = win.reshape(g.plane, g.cig, g.e).permute(1, 0, 2)
    out = x_img.new_zeros((g.box_units, g.e))
    for cg in range(g.cig):
        out[cg * g.bp:cg * g.bp + g.plane] = planes[cg]
    return out


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def read_a(units, start, lbo, sbo, rows=64):
    """A (rows x 2e) of one k-step as the descriptor reads it from
    `units` (a flat (n, e) view of shared memory in 16-byte units): row r
    at start + (r // 8) * sbo + r % 8, its second core matrix lbo further
    (all in units)."""
    r = torch.arange(rows)
    at = start + (r // 8) * sbo + r % 8
    return torch.cat([units[at], units[at + lbo]], dim=1)


def _b_steps(plane, k, n, e):
    """A `to_wgmma` plane read back k-step by k-step: (k // 2e, 2e, n)."""
    kk = torch.arange(2 * e)[:, None]
    nn = torch.arange(n)[None, :]
    return torch.stack([read_b(plane, kk, nn, n, e, ks)
                        for ks in range(k // (2 * e))])


def _product(a_steps, op, k, n, dtype):
    """sum over k-steps of A (M, 2e) @ B (2e, n) as the kernel issues them.
    fp32: three TF32 products a k-step, lo*hi, hi*lo, hi*hi (lo = a -
    trunc(a) from registers, hi read by truncation), added to an fp32
    accumulator in that order; bf16: one product of bf16 values (exact in
    fp32), fp32 sums."""
    e = elems16(dtype)
    if dtype == torch.bfloat16:
        b = _b_steps(op.float(), k, n, e)
        acc = None
        for ks, a in enumerate(a_steps):
            p = a.float() @ b[ks]
            acc = p if acc is None else acc + p
        return acc
    hi, lo = _b_steps(op[:k * n], k, n, e), _b_steps(op[k * n:], k, n, e)
    acc = None
    for ks, a in enumerate(a_steps):
        ah = trunc_tf32(a)
        al = trunc_tf32(a - ah)
        for p in (al @ hi[ks], ah @ trunc_tf32(lo[ks]), ah @ hi[ks]):
            acc = p if acc is None else acc + p
    return acc


def stage1(x_img, w1, r0, c0, g):
    """Stage 1 of item (r0, c0): (m1t * 64, 4 Cm) fp32, row q the box's
    flattened position q (real where q <= lastq and q % bc <= tw)."""
    units = tma_box(x_img, r0, c0, g)
    lbo, sbo = (o // 16 for o in g.a1_offsets)
    tiles = []
    for mt in range(g.m1t):
        steps = [read_a(units, mt * 64 + g.stage1_koff(ks), lbo, sbo)
                 for ks in range(g.k1s)]
        tiles.append(_product(steps, w1, 4 * g.ci, 4 * g.cm, g.dtype))
    return torch.cat(tiles)


def emulate_stats(xn, w1, ci, cm):
    """What the stats launch writes: (B, slots, 2, Cm) fp32 sums and sums
    of squares of the hidden cells each item owns.  xn (B, H, W, Ci) NHWC
    fp32 or bf16, w1 `operands`' first in xn's dtype."""
    bsz, h, w, _ = xn.shape
    g = geo(ci, cm, xn.dtype, main=False)
    sched = Schedule(bsz, h, w, g.tw)
    q = torch.arange(g.m1t * 64)
    pi, pj = q // g.bc, q % g.bc
    out = torch.zeros((sched.n_items, 2, cm))
    for idx in range(sched.n_items):
        b, r0, c0 = sched.item(idx)
        hp = stage1(xn[b], w1, r0, c0, g).reshape(-1, 4, cm)
        for par in range(4):
            di, dj = par >> 1, par & 1
            own = ((q <= g.lastq) & (pi - di >= 0) & (pi - di < ROWS)
                   & (r0 + pi - di < h) & (pj - dj >= 0) & (pj - dj < g.tw)
                   & (c0 + pj - dj < w))
            v = torch.where(own[:, None], hp[:, par], 0.0)
            out[idx, 0] += v.sum(dim=0)
            out[idx, 1] += (v * v).sum(dim=0)
    return out.reshape(bsz, sched.per_image, 2, cm)


def hidden_planes(hp, r0, c0, h, w, bn, g):
    """The hidden planes the main kernel's stage-1 epilogue writes: (hpn *
    ps, e) units, h = max(acc * gain + (bias - mean * gain), 0), zero where
    the cell lies outside the hidden image, in xn's dtype (bf16: rounded
    once, pallas_fused.py:153)."""
    cm = g.cm
    gain = bn[1]
    shift = bn[2] - bn[0] * bn[1]
    v = torch.relu(hp * gain + shift)                  # (m1t*64, 4 Cm)
    q = torch.arange(v.shape[0])
    pi, pj = q // g.bc, q % g.bc
    real = (q <= g.lastq) & (pj <= g.tw)
    planes = torch.zeros((g.hpn, g.ps, g.e), dtype=g.dtype)
    pos = (pi * g.pc + pj)[real]
    for par in range(4):
        di, dj = par >> 1, par & 1
        inside = ((r0 - di + pi >= 0) & (r0 - di + pi < h)
                  & (c0 - dj + pj >= 0) & (c0 - dj + pj < w))
        blk = torch.where(inside[:, None], v[:, par * cm:(par + 1) * cm], 0.0)
        blk = blk[real].reshape(-1, cm // g.e, g.e).to(g.dtype)
        for cg in range(cm // g.e):
            planes[par * (cm // g.e) + cg, pos] = blk[:, cg]
    return planes.reshape(-1, g.e)


def emulate_main(xn, w1, w2, bn, ci, cm, co):
    """What the main launch writes: y (B, H, W, Co) NHWC in xn's dtype.  bn
    (3, 4 Cm) fp32: mean, gain and bias tiled over the four parities; w1,
    w2 `operands`' in xn's dtype."""
    bsz, h, w, _ = xn.shape
    g = geo(ci, cm, xn.dtype, main=True)
    sched = Schedule(bsz, h, w, g.tw)
    lbo, sbo = (o // 16 for o in g.a2_offsets)
    r = torch.arange(64)
    ml, nl = r // 8, r % 8
    y = torch.zeros((bsz, h, w, co), dtype=xn.dtype)
    for idx in range(sched.n_items):
        b, r0, c0 = sched.item(idx)
        hp = stage1(xn[b], w1, r0, c0, g)
        units = hidden_planes(hp, r0, c0, h, w, bn, g)
        for nb in range(g.m2t):
            steps = [read_a(units, 8 * nb + g.stage2_koff(ks), lbo, sbo)
                     for ks in range(g.k2s)]
            tile = _product(steps, w2, 16 * cm, co, g.dtype)
            rows, cols = r0 + ml, c0 + 8 * nb + nl
            keep = (rows < h) & (cols < w)
            y[b, rows[keep], cols[keep]] = tile[keep].to(xn.dtype)
    return y
