"""What surrounds the channels-last pair on Hopper's units
(csrc/fused_nhwc_wgmma.cu; host side dcgan_sr_tpu_torch/ops/
fused_nhwc_wgmma.py), held on the CPU: the weights in wgmma's K-major
layout (fp32 as hi and lo planes), the box each work item's tensor maps
load, the descriptor start offsets of both products, the schedule of work
items, the static choice of implementation, and an emulation of the
kernel's arithmetic read through the same addressing.  The kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances.  fp32: those of tests/test_torch_fused_nhwc.py (mean, var 1e-5,
y 2e-4, abs + rel) against the JAX package's K3 in interpret mode: the
emulation's three TF32 products a k-step leave each product at fp32
accuracy.  bf16: against the plain bf16 version, statistics 1e-5 relative
and y within one bf16 step of max |y| on at most 1% of its elements (as
tests/test_torch_fused_nhwc_bf16.py): the two differ only in the order of
fp32 sums.  The packing and the box move values and are held to equality."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.ops import pallas_fused as JF
from dcgan_sr_tpu_torch import ablation
from dcgan_sr_tpu_torch.ops import fused_nhwc as TF
from dcgan_sr_tpu_torch.ops import fused_nhwc_wgmma as G
from dcgan_sr_tpu_torch.ops import nn as N

from test_torch_fused_nhwc_bf16 import _hold_stats, _hold_y
from test_torch_fused_nhwc_mma import Y_TOL, STATS_TOL, _rect

import torch_threads  # noqa: F401

BF = torch.bfloat16
DTYPES = [torch.float32, BF]
DT_IDS = ["fp32", "bf16"]
ALL_TRIPLES = [(8, 4, 8), (16, 8, 16), (32, 16, 32)]


def _close(got, want):
    (y, (m, v)), (yw, (mw, vw)) = got, want
    np.testing.assert_allclose(np.asarray(m), np.asarray(mw), **STATS_TOL)
    np.testing.assert_allclose(np.asarray(v), np.asarray(vw), **STATS_TOL)
    np.testing.assert_allclose(np.asarray(y), np.asarray(yw), **Y_TOL)


# ---- the weights -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("ci,cm,co", ALL_TRIPLES)
def test_operands_unpack_to_the_jax_packers(ci, cm, co, dtype):
    """W1 and W2 read back through the descriptor's addressing are wtall and
    wcall (W2's rows in (sa, sb, di, dj, cm) order); fp32: hi + lo == w
    exactly, hi a TF32 value and lo exact; bf16: the packers' matrices
    rounded to bf16."""
    _, wT, _, _, wC = map(torch.from_numpy, _rect(1, ci, cm, co, 4, 4))
    wtall, wcall = TF._pack_wT(wT), TF._pack_wC(wC)
    w1, w2 = TF.operands(wT, wC, "wgmma", dtype)
    e = G.elems16(dtype)
    planes = 2 if dtype == torch.float32 else 1
    assert w1.dtype == w2.dtype == dtype
    assert w1.numel() == planes * wtall.numel()
    assert w2.numel() == planes * wcall.numel()
    w2_mat = wcall[G.w2_rows(cm)]
    for op, mat in ((w1, wtall), (w2, w2_mat)):
        k, n = mat.shape
        kk = torch.arange(2 * e)[:, None]
        nn = torch.arange(n)[None, :]
        for ks in range(k // (2 * e)):
            rows = mat[ks * 2 * e:(ks + 1) * 2 * e]
            hi = G.read_b(op[:k * n], kk, nn, n, e, ks)
            if dtype == BF:
                assert torch.equal(hi.float(), rows.to(BF).float())
                continue
            lo = G.read_b(op[k * n:], kk, nn, n, e, ks)
            assert torch.equal(hi + lo, rows)
            assert torch.equal(G.trunc_tf32(hi), hi)
            assert torch.equal(hi + lo - hi, lo)
            assert (lo.abs() <= hi.abs() * 2.0 ** -10).all()


def test_w2_rows_are_wcall_in_window_major_order():
    """Row (sa, sb, di, dj, cm) of W2 is row ((di*2 + dj)*2 + sa)*2 + sb of
    wcall: a k-step's two core matrices are then two hidden planes at one
    window offset."""
    cm = 8
    rows = G.w2_rows(cm)
    assert sorted(rows) == list(range(16 * cm))
    for sa in range(2):
        for sb in range(2):
            for par in range(4):
                for c in range(cm):
                    k = ((sa * 2 + sb) * 4 + par) * cm + c
                    assert rows[k] == ((par * 2 + sa) * 2 + sb) * cm + c


def test_to_wgmma_is_the_canonical_k_major_layout():
    """Core matrix (kb, nb) is 8 n-rows of 16 bytes, k-block major: element
    (k, n) sits at ((k//e * N/8 + n//8) * 8 + n%8) * e + k%e."""
    for e in (4, 8):
        k, n = 4 * e, 24
        mat = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
        flat = G.to_wgmma(mat, e)
        for kk in range(k):
            for nn in range(n):
                at = ((kk // e * (n // 8) + nn // 8) * 8 + nn % 8) * e + kk % e
                assert flat[at] == mat[kk, nn]
        assert G.b_offsets(n) == (n // 8 * 128, 128)


# ---- the box and the descriptors ----------------------------------------------

# (H, W, r0, c0): ragged widths (37, 33, 3), the image's corners, a band
# clipped at H
BOXES = [(16, 37, 0, 32), (16, 33, 8, 0), (8, 3, 0, 0), (12, 37, 8, 32),
         (9, 40, 8, 0), (16, 64, 8, 32)]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("h,w,r0,c0", BOXES)
def test_box_is_the_zero_padded_window(h, w, r0, c0, dtype):
    """The box the tensor maps load for item (r0, c0), emulated from the
    maps' origin and extent, is the NHWC window x[r0-1 .. r0+R, c0-1 ..
    c0+TW] zero-padded outside the image, channel group by channel group,
    each plane 128-byte aligned."""
    ci, cm = 16, 8
    x = torch.randn(h, w, ci).to(dtype)
    g = G.geo(ci, cm, dtype, main=False)
    assert G.box_origin(r0, c0) == (c0 - 1, r0 - 1)
    assert G.box_extent(g) == (g.e, g.tw + 2, G.ROWS + 2, 1)
    assert g.bp % 8 == 0 and g.bp >= g.plane
    units = G.tma_box(x, r0, c0, g)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, g.bc, 1, g.xr))
    win = xp[r0:r0 + g.xr, c0:c0 + g.bc]            # rows r0-1 .., cols c0-1 ..
    for cg in range(g.cig):
        plane = units[cg * g.bp:cg * g.bp + g.plane].float()
        want = win[..., cg * g.e:(cg + 1) * g.e].reshape(-1, g.e)
        assert torch.equal(plane, want)
        assert not units[cg * g.bp + g.plane:(cg + 1) * g.bp].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("ci,cm", [(16, 8), (32, 16)])
def test_stage1_descriptors_address_each_taps_window(ci, cm, dtype):
    """Stage 1's A, read by descriptor from the box at tile mt's start plus
    k-step ks's offset, holds at row q = pi*BC + pj the channels of x at
    (r0-1+pi+ti, c0-1+pj+tj) that k-step's k = (ti*2 + tj)*Ci + ci name."""
    h, w, r0, c0 = 12, 37, 8, 32
    x = torch.randn(h, w, ci).to(dtype)
    for main in (False, True):
        g = G.geo(ci, cm, dtype, main)
        units = G.tma_box(x, r0, c0, g)
        lbo, sbo = (o // 16 for o in g.a1_offsets)
        xp = torch.nn.functional.pad(x.float(), (0, 0, 1, g.bc, 1, g.xr))
        for mt in range(g.m1t):
            for ks in range(g.k1s):
                a = G.read_a(units, mt * 64 + g.stage1_koff(ks), lbo, sbo)
                k0 = ks * 2 * g.e
                tap, ci0 = divmod(k0, ci)
                ti, tj = tap >> 1, tap & 1
                for r in range(64):
                    q = mt * 64 + r
                    pi, pj = divmod(q, g.bc)
                    if q > g.lastq or pj > g.tw:
                        continue
                    want = xp[r0 + pi + ti, c0 + pj + tj, ci0:ci0 + 2 * g.e]
                    assert torch.equal(a[r].float(), want), (mt, ks, r)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("ci,cm", [(16, 8), (32, 16)])
def test_stage2_descriptors_address_each_window(ci, cm, dtype):
    """Stage 2's A, read by descriptor from the hidden planes at tile nb's
    start plus k-step ks's offset, holds at row r (y pixel (r//8, 8 nb +
    r%8)) the channels of plane (di, dj) at (ml + sa, nl + sb) that k =
    ((sa*2 + sb)*4 + di*2 + dj)*Cm + cm names."""
    g = G.geo(ci, cm, dtype, main=True)
    vals = torch.arange(g.hpn * g.ps * g.e, dtype=torch.float32)
    units = vals.reshape(-1, g.e)
    lbo, sbo = (o // 16 for o in g.a2_offsets)
    for nb in range(g.m2t):
        for ks in range(g.k2s):
            a = G.read_a(units, 8 * nb + g.stage2_koff(ks), lbo, sbo)
            for kk in range(2 * g.e):
                k = ks * 2 * g.e + kk
                s, rest = divmod(k, 4 * cm)
                par, c = divmod(rest, cm)
                sa, sb = s >> 1, s & 1
                plane = par * (cm // g.e) + c // g.e
                for r in range(64):
                    ml, nl = r // 8, 8 * nb + r % 8
                    pos = (ml + sa) * g.pc + nl + sb
                    want = (plane * g.ps + pos) * g.e + c % g.e
                    assert a[r, kk] == want


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("ci,cm", [(16, 8), (32, 16)])
def test_geometry_fits_and_pads(ci, cm, dtype):
    """Every stage-1 row the last tile computes reads inside the box buffer;
    the hidden planes hold every position and are 4 mod 8 units apart; a
    stage-2 tile's rows stay inside a plane."""
    for main in (False, True):
        g = G.geo(ci, cm, dtype, main)
        # the last k-step's second core matrix, one plane on, at row 63
        last = g.stage1_koff(g.k1s - 1) + g.bp + (g.m1t - 1) * 64 + 63
        assert last == g.box_units - 1
        assert g.m1t * 64 > g.lastq >= (g.m1t - 1) * 64
        assert g.ps >= g.npos and g.ps % 8 == 4
        assert 7 * g.pc + 8 * (g.m2t - 1) + 7 + g.pc + 1 < g.npos
    assert G.main_cols(32, torch.float32) == 16
    assert G.main_cols(16, torch.float32) == G.main_cols(32, BF) == 32


# ---- the schedule ------------------------------------------------------------

@pytest.mark.parametrize("bsz,h,w,tw", [(1, 9, 5, 32), (2, 37, 45, 32),
                                        (1, 1, 3, 32), (2, 24, 40, 16),
                                        (1, 16, 33, 16)])
def test_schedule_covers_every_hidden_cell_once(bsz, h, w, tw):
    s = G.Schedule(bsz, h, w, tw)
    assert s.n_items == bsz * -(-h // 8) * -(-w // tw)
    count = np.zeros((bsz, 2 * h, 2 * w), np.int64)
    for idx in range(s.n_items):
        b, r0, c0 = s.item(idx)
        assert r0 % 8 == 0 and c0 % tw == 0 and idx // s.per_image == b
        ob, rows, cols = s.owned(idx)
        np.add.at(count[ob], (np.asarray(rows), np.asarray(cols)), 1)
    assert (count == 1).all()


def test_stats_slots_are_the_schedule_items():
    """Slot idx of the emulated stats launch holds the sum and the sum of
    squares of exactly the hidden cells item idx owns."""
    bsz, ci, cm, co, h, w = 2, 16, 8, 16, 12, 40
    x, wT, _, _, wC = map(torch.from_numpy, _rect(bsz, ci, cm, co, h, w))
    xn = x.permute(0, 2, 3, 1).contiguous()
    w1, _ = TF.operands(wT, wC, "wgmma")
    partial = G.emulate_stats(xn, w1, ci, cm)
    s = G.Schedule(bsz, h, w)
    assert partial.shape == (bsz, s.per_image, 2, cm)
    hid = N.conv_transpose2d(x, wT, 2, 1)
    flat = partial.reshape(-1, 2, cm)
    for idx in range(s.n_items):
        b, rows, cols = s.owned(idx)
        cells = hid[b][:, rows, cols]
        np.testing.assert_allclose(flat[idx, 0], cells.sum(dim=1), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(flat[idx, 1], (cells * cells).sum(dim=1),
                                   rtol=1e-4, atol=1e-4)


# ---- the emulated pair -------------------------------------------------------

# (B, Ci, Cm, Co, H, W, tm): both triples, ragged W (37, 33, 3), a band
# clipped at H, tm that cuts no 8-row band
JAX_GEOMS = [(2, 16, 8, 16, 16, 37, 8), (1, 32, 16, 32, 8, 33, 8),
             (3, 16, 8, 16, 6, 3, 6), (1, 16, 8, 16, 12, 20, 4)]


@pytest.mark.parametrize("geom", JAX_GEOMS, ids=str)
def test_emulated_fp32_pair_matches_jax_kernel(geom):
    tm = geom[-1]
    a = _rect(*geom[:6], seed=2)
    y, (m, v) = TF.fused_nhwc_packed(*map(torch.from_numpy, a), tm=tm,
                                     impl="wgmma")
    assert y.shape == (geom[0], geom[3], geom[4], geom[5])
    want = JF.fused_convT_bn_relu_conv(*map(jnp.asarray, a), tm=tm,
                                       interpret=True)
    _close((y.numpy(), (m.numpy(), v.numpy())), want)


BF16_GEOMS = [(2, 16, 8, 16, 16, 37, 8), (1, 32, 16, 32, 8, 33, 8),
              (3, 16, 8, 16, 6, 3, 6), (1, 16, 8, 16, 24, 40, 12)]


@pytest.mark.parametrize("geom", BF16_GEOMS, ids=str)
def test_emulated_bf16_pair_matches_plain(geom):
    tm = geom[-1]
    t = tuple(map(torch.from_numpy, _rect(*geom[:6], seed=4)))
    t = (t[0].to(BF),) + t[1:]
    y, st = TF.fused_nhwc_packed(*t, tm=tm, impl="wgmma")
    assert y.dtype == BF
    yp, stp = TF.fused_nhwc_plain(*t, tm=tm)
    _hold_stats(st, stp)
    _hold_y(y.float(), yp.float(), f"wgmma emulation vs plain {geom}")


# ---- the choice and the checks -----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_choose_impl_gives_wgmma_at_bench_fused_shape(dtype):
    assert TF.choose_impl(16, 8, 16, 256, 256, dtype) == "wgmma"
    assert TF.choose_impl(32, 16, 32, 32, 33, dtype) == "wgmma"
    assert TF.choose_impl(8, 4, 8, 16, 37, dtype) == "mma"
    # a base the tensor maps cannot take (the wrapper's NHWC copy never has
    # one) goes to the mma.sync kernel
    assert TF.choose_impl(16, 8, 16, 256, 256, dtype, aligned=False) == "mma"
    bf16 = dtype == BF
    assert TF._impl_for(None, 16, 8, 16, 256, 256, bf16) == "wgmma"
    assert TF._impl_for(None, 8, 4, 8, 16, 16, bf16) == "mma"


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_wgmma_refuses_what_it_was_not_built_for(dtype):
    t = tuple(map(torch.from_numpy, _rect(1, 8, 4, 8, 8, 8)))
    t = (t[0].to(dtype),) + t[1:]
    with pytest.raises(ValueError, match="wgmma NHWC kernel has no"):
        TF.fused_convT_bn_relu_conv(*t, tm=8, impl="wgmma")
    odd = tuple(map(torch.from_numpy, _rect(1, 5, 4, 6, 8, 8)))
    with pytest.raises(ValueError, match="no "):
        TF.fused_convT_bn_relu_conv(*odd, tm=8, impl="wgmma")
    if dtype == BF:
        t16 = tuple(map(torch.from_numpy, _rect(1, 16, 8, 16, 8, 8)))
        with pytest.raises(ValueError, match="float32 only"):
            TF.fused_convT_bn_relu_conv(t16[0].to(BF), *t16[1:], tm=8,
                                        impl="fma")
    assert all(v == 0 for v in TF.launches.values())


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_cpu_call_runs_the_plain_version_and_launches_nothing(dtype):
    t = tuple(map(torch.from_numpy, _rect(1, 16, 8, 16, 8, 12)))
    t = (t[0].to(dtype),) + t[1:]
    n0, i0 = dict(TF.launches), dict(TF.impl_launches)
    got = TF.fused_convT_bn_relu_conv(*t, tm=8, impl="wgmma")
    want = TF.fused_nhwc_plain(*t, tm=8)
    assert torch.equal(got[0], want[0])
    assert TF.launches == n0 and TF.impl_launches == i0
    assert {"wgmma", "wgmma_bf16"} <= set(TF.impl_launches)


@pytest.mark.parametrize("kernel,name", [
    (k, n) for k in ("nhwc_wgmma", "nhwc_wgmma_f32")
    for n in sorted(ablation.KERNELS[k].variants)])
def test_every_wgmma_ablation_variant_applies_to_the_kernel_source(kernel,
                                                                   name):
    """python -m dcgan_sr_tpu_torch.ablation --kernel nhwc_wgmma[_f32]
    rebuilds csrc/fused_nhwc_wgmma.cu with text substitutions: each must
    still find its text."""
    src = ablation.variant_source(kernel, name)
    with open(os.path.join(ablation.B.CSRC, "fused_nhwc_wgmma.cu")) as f:
        base = f.read()
    assert (src == base) == (name == "base")
