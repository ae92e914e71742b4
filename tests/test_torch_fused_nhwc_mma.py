"""What surrounds the tensor-core channels-last pair (csrc/fused_nhwc.cu,
namespace tc), held on the CPU: the kernel's weight operands in fragment
order, the schedule of work items and the static choice of implementation
(dcgan_sr_tpu_torch/ops/fused_nhwc_mma.py, ops/fused_nhwc.py).  The kernel
itself is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

`fused_nhwc_packed` computes the pair from the fragment-order operands, item
by item as the kernel walks them, with the mma's permuted k order on both
sides of each product; it is held to `fused_nhwc_plain` and to the JAX
package's K3 in interpret mode.  Tolerances as in
tests/test_torch_fused_nhwc.py: mean, var 1e-5 and y 2e-4 (abs + rel); the
operands move weights and are held to equality."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.ops import pallas_fused as JF
from dcgan_sr_tpu_torch import ablation
from dcgan_sr_tpu_torch.ops import fused_nhwc as TF
from dcgan_sr_tpu_torch.ops import fused_nhwc_mma as M

from test_torch_fused_nhwc import SHAPES, _inputs

import torch_threads  # noqa: F401

STATS_TOL = dict(rtol=1e-5, atol=1e-5)
Y_TOL = dict(rtol=2e-4, atol=2e-4)
# (B, Ci, Cm, Co, H, W, tm): the built triples, ragged W, passes clipped at a
# band's end (tm 4, 6, 12, 2) and more than one pass a band (tm 16)
RECTS = [(2, 16, 8, 16, 12, 20, 4), (1, 8, 4, 8, 16, 37, 8),
         (1, 32, 16, 32, 8, 33, 8), (2, 6, 4, 8, 8, 5, 2),
         (3, 16, 8, 16, 6, 3, 6), (1, 16, 8, 16, 32, 40, 16),
         (1, 5, 4, 6, 12, 20, 12)]


def _rect(bsz, ci, cm, co, h, w, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(bsz, ci, h, w).astype(np.float32),
            (0.1 * rng.randn(ci, cm, 4, 4)).astype(np.float32),
            (1.0 + 0.1 * rng.randn(cm)).astype(np.float32),
            (0.1 * rng.randn(cm)).astype(np.float32),
            (0.1 * rng.randn(co, cm, 4, 4)).astype(np.float32))


def _cases():
    for bsz, ci, cm, co, hw, tm in SHAPES:
        yield (bsz, ci, cm, co, hw, hw, tm), _inputs(bsz, ci, cm, co, hw)
    for geom in RECTS:
        yield geom, _rect(*geom[:6])


CASES = list(_cases())
IDS = [str(g) for g, _ in CASES]


def _close(got, want):
    (y, (m, v)), (yw, (mw, vw)) = got, want
    np.testing.assert_allclose(np.asarray(m), np.asarray(mw), **STATS_TOL)
    np.testing.assert_allclose(np.asarray(v), np.asarray(vw), **STATS_TOL)
    np.testing.assert_allclose(np.asarray(y), np.asarray(yw), **Y_TOL)


# ---- the packed pair ---------------------------------------------------------

@pytest.mark.parametrize("geom,a", CASES, ids=IDS)
def test_packed_pair_matches_plain(geom, a):
    tm = geom[-1]
    t = tuple(map(torch.from_numpy, a))
    got = TF.fused_nhwc_packed(*t, tm=tm)
    assert got[0].shape == (geom[0], geom[3], geom[4], geom[5])
    assert got[1][0].shape == got[1][1].shape == (geom[2],)
    _close(got, TF.fused_nhwc_plain(*t, tm=tm))


@pytest.mark.parametrize("geom,a", CASES, ids=IDS)
def test_packed_pair_matches_jax_kernel(geom, a):
    tm = geom[-1]
    y, (m, v) = TF.fused_nhwc_packed(*map(torch.from_numpy, a), tm=tm)
    want = JF.fused_convT_bn_relu_conv(*map(jnp.asarray, a), tm=tm,
                                       interpret=True)
    _close((y.numpy(), (m.numpy(), v.numpy())), want)


# ---- the operands ------------------------------------------------------------

@pytest.mark.parametrize("ci,cm,co", list(M.MMA_TRIPLES) + [(5, 4, 6),
                                                            (3, 2, 3)])
def test_operands_are_the_jax_packers_in_fragment_order(ci, cm, co):
    """W1 and W2 hold wtall's and wcall's elements and zeros, nothing else;
    unpacked (fragment order undone, k order undone, padding cut) they equal
    the JAX packers' matrices exactly."""
    _, wT, _, _, wC = map(torch.from_numpy, _rect(1, ci, cm, co, 4, 4))
    w1, w2 = TF.operands(wT, wC, "mma")
    wtall, wcall = TF._pack_wT(wT), TF._pack_wC(wC)
    cip, cmp_, cop = M.padded(ci), M.padded(cm), M.padded(co)
    assert w1.shape == (16 * cip * cmp_,) and w2.shape == (16 * cmp_ * cop,)
    for op, mat in ((w1, wtall), (w2, wcall)):
        nz = np.sort(op[op != 0].numpy())
        np.testing.assert_array_equal(nz, np.sort(mat[mat != 0].numpy()))
    u1 = M.unpermute_k(M.from_fragments(w1, 4 * cip, 4 * cmp_))
    u1 = u1.reshape(4, cip, 4, cmp_)
    torch.testing.assert_close(u1[:, :ci, :, :cm].reshape(4 * ci, 4 * cm),
                               wtall, rtol=0, atol=0)
    assert not u1[:, ci:].any() and not u1[..., cm:].any()
    u2 = M.unpermute_k(M.from_fragments(w2, 16 * cmp_, cop))
    u2 = u2.reshape(16, cmp_, cop)
    torch.testing.assert_close(u2[:, :cm, :co].reshape(16 * cm, co), wcall,
                               rtol=0, atol=0)
    assert not u2[:, cm:].any() and not u2[..., co:].any()
    # the fma operands are the packers' own matrices
    f1, f2 = TF.operands(wT, wC, "fma")
    assert torch.equal(f1, wtall) and torch.equal(f2, wcall)


def test_fragment_order_is_what_an_mma_lane_reads():
    """Lane g*4 + t of mma.m16n8k8 holds B[k0 + t][n0 + g] and
    B[k0 + t + 4][n0 + g] of the kernel's k order, which are channels 2t and
    2t + 1 of the group: one 8-byte word at ((ks*NT + nt)*32 + lane)*2."""
    k, n = 32, 24
    mat = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    frag = M.to_fragments(mat)
    assert frag.shape == (k * n,)
    assert sorted(frag.tolist()) == sorted(mat.reshape(-1).tolist())
    nt_n = n // 8
    for ks in range(k // 8):
        for nt in range(nt_n):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                word = frag[((ks * nt_n + nt) * 32 + lane) * 2:][:2]
                assert word[0] == mat[ks * 8 + 2 * t, nt * 8 + g]
                assert word[1] == mat[ks * 8 + 2 * t + 1, nt * 8 + g]
    assert torch.equal(M.unpermute_k(M.from_fragments(frag, k, n)), mat)
    assert torch.equal(M.permute_k(M.unpermute_k(mat)), mat)


# ---- the schedule ------------------------------------------------------------

@pytest.mark.parametrize("bsz,h,w,tm", [(1, 9, 5, 9), (2, 37, 45, 37),
                                        (1, 1, 3, 1), (3, 8, 32, 8),
                                        (1, 16, 33, 16), (2, 24, 40, 12),
                                        (1, 18, 64, 6), (2, 20, 7, 20)])
def test_schedule_covers_every_hidden_cell_once(bsz, h, w, tm):
    s = M.Schedule(bsz, h, w, tm)
    assert s.n_items == bsz * (h // tm) * -(-tm // 8) * -(-w // 32)
    count = np.zeros((bsz, 2 * h, 2 * w), np.int64)
    seen = set()
    for idx in range(s.n_items):
        b, r0, rend, c0 = s.item(idx)
        assert 0 <= b < bsz and r0 < rend <= h and c0 < w
        assert rend - r0 <= M.PASS_ROWS and c0 % M.CHUNK_COLS == 0
        # a pass never crosses a band's end
        assert r0 // tm == (rend - 1) // tm
        seen.add((b, r0, c0))
        assert idx // s.per_image == b      # image b's slots are one run
        ob, rows, cols = s.owned(idx)
        assert ob == b
        np.add.at(count[b], (rows, cols), 1)
    assert len(seen) == s.n_items
    assert (count == 1).all()


def test_schedule_is_chunk_fastest_then_pass_then_band():
    s = M.Schedule(2, 24, 70, 12)
    assert (s.bands, s.passes, s.chunks) == (2, 2, 3)
    assert [s.item(i) for i in range(7)] == [
        (0, 0, 8, 0), (0, 0, 8, 32), (0, 0, 8, 64), (0, 8, 12, 0),
        (0, 8, 12, 32), (0, 8, 12, 64), (0, 12, 20, 0)]
    assert s.item(s.per_image) == (1, 0, 8, 0)


def test_packed_stats_slots_are_the_schedule_items():
    """Slot idx of the stats launch holds the sum and the sum of squares of
    exactly the hidden cells item idx owns."""
    from dcgan_sr_tpu_torch.ops import nn as N
    bsz, ci, cm, co, h, w, tm = 2, 8, 4, 8, 12, 40, 6
    x, wT, _, _, wC = map(torch.from_numpy, _rect(bsz, ci, cm, co, h, w))
    xn = x.permute(0, 2, 3, 1).contiguous()
    w1, _ = TF.operands(wT, wC, "mma")
    partial = M.packed_stats(xn, w1, ci, cm, tm)
    s = M.Schedule(bsz, h, w, tm)
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


# ---- the static choice -------------------------------------------------------

def test_choose_impl_is_a_static_rule_on_the_shapes():
    """The mma.sync kernel keeps the triple the wgmma kernel was not built
    for; the other two go to "wgmma" (tests/test_torch_fused_nhwc_wgmma.py
    holds that choice in both dtypes)."""
    for ci, cm, co in M.MMA_TRIPLES:
        want = "wgmma" if (ci, cm, co) in TF.WG.TRIPLES else "mma"
        for h, w in ((8, 3), (32, 32), (256, 256)):
            assert TF.choose_impl(ci, cm, co, h, w) == want
            assert TF.choose_impl(ci, cm, co, h, w, aligned=False) == "mma"
    assert TF.choose_impl(8, 4, 8, 16, 16) == "mma"
    assert TF.choose_impl(5, 4, 6, 16, 16) == "fma"
    assert TF.choose_impl(16, 16, 32, 16, 16) == "fma"
    assert TF.choose_impl(3, 2, 3, 8, 8) == "fma"


def test_impl_argument_is_checked():
    x, wT, s, b, wC = map(torch.from_numpy, _inputs(1, 5, 4, 6, 8))
    with pytest.raises(ValueError, match="impl must be one of"):
        TF.fused_convT_bn_relu_conv(x, wT, s, b, wC, tm=8, impl="tf32")
    with pytest.raises(ValueError, match="no instantiation"):
        TF.fused_convT_bn_relu_conv(x, wT, s, b, wC, tm=8, impl="mma")
    assert TF._impl_for(None, 5, 4, 6, 8, 8) == "fma"
    assert TF._impl_for("fma", 5, 4, 6, 8, 8) == "fma"
    assert TF._impl_for("mma", 16, 8, 16, 8, 8) == "mma"
    assert set(TF.impl_launches) == set(TF.IMPLS) | {"mma_bf16",
                                                     "wgmma_bf16"}


@pytest.mark.parametrize("impl", [None, "mma", "fma"])
def test_cpu_call_runs_the_plain_version_and_launches_nothing(impl):
    t = tuple(map(torch.from_numpy, _rect(1, 16, 8, 16, 8, 12)))
    n0, i0 = dict(TF.launches), dict(TF.impl_launches)
    got = TF.fused_convT_bn_relu_conv(*t, tm=8, impl=impl)
    want = TF.fused_nhwc_plain(*t, tm=8)
    assert torch.equal(got[0], want[0])
    assert TF.launches == n0 and TF.impl_launches == i0


@pytest.mark.parametrize("name", sorted(ablation.KERNELS["nhwc"].variants))
def test_every_ablation_variant_applies_to_the_kernel_source(name):
    """python -m dcgan_sr_tpu_torch.ablation --kernel nhwc rebuilds
    csrc/fused_nhwc.cu with text substitutions: each must still find its
    text."""
    src = ablation.variant_source("nhwc", name)
    with open(os.path.join(ablation.B.CSRC, "fused_nhwc.cu")) as f:
        base = f.read()
    assert (src == base) == (name == "base")
