"""What surrounds the tensor-core bulge kernel (csrc/bulge.cu, namespace tc),
held on the CPU: the host-side packing of wT and wC into the kernel's two
GEMM operands, the TF32 split, the schedule of work items and the static
choice of implementation (dcgan_sr_tpu_torch/ops/bulge_mma.py, ops/bulge.py).
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

`bulge_packed` computes the pair from the packed operands, item by item as
the kernel walks them, with two torch.matmul's over gathered windows; it is
held to `bulge_plain` and to the JAX package's `_reference_pair`
(tests/test_pallas_fused.py) at the geometries of tests/test_torch_bulge.py.
Tolerances as there: 1e-5 abs + rel for the hidden tensor's mean/var, 2e-4
for y (the products are summed in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu_torch.ops import bulge as K
from dcgan_sr_tpu_torch.ops import bulge_mma as M

from test_pallas_fused import _reference_pair
from test_torch_bulge import GEOMETRIES, STATS_TOL, Y_TOL, _inputs

import torch_threads  # noqa: F401

RAGGED = [(1, 9, 5), (2, 37, 45), (1, 1, 3), (3, 8, 32), (1, 16, 33),
          (2, 24, 40), (1, 17, 64)]


def _tensors(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _call(fn, t, stats, groups=None):
    y, (m, v) = fn(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                   stats=stats, groups=groups,
                   running=(t["rmean"], t["rvar"]) if stats == "running"
                   else None)
    return y.numpy(), m.numpy(), v.numpy()


# ---- the packed pair ---------------------------------------------------------

@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", GEOMETRIES + [(2, 8, 4, 8, 10, 40),
                                               (4, 32, 16, 32, 32, 32)])
def test_packed_pair_matches_plain(geom, stats):
    t = _tensors(_inputs(*geom))
    got, want = _call(M.bulge_packed, t, stats), _call(K.bulge_plain, t, stats)
    assert got[0].shape == (geom[0], geom[3], geom[4], geom[5])
    np.testing.assert_allclose(got[1], want[1], **STATS_TOL)
    np.testing.assert_allclose(got[2], want[2], **STATS_TOL)
    np.testing.assert_allclose(got[0], want[0], **Y_TOL)


@pytest.mark.parametrize("geom,groups", [((4, 16, 8, 16, 12, 20), 2),
                                         ((6, 8, 4, 8, 9, 5), 3),
                                         ((4, 32, 16, 32, 32, 32), 4)])
def test_packed_pair_with_grouped_statistics(geom, groups):
    t = _tensors(_inputs(*geom, seed=1))
    got = _call(M.bulge_packed, t, "pooled", groups)
    want = _call(K.bulge_plain, t, "pooled", groups)
    assert got[1].shape == (groups, geom[2])
    np.testing.assert_allclose(got[1], want[1], **STATS_TOL)
    np.testing.assert_allclose(got[2], want[2], **STATS_TOL)
    np.testing.assert_allclose(got[0], want[0], **Y_TOL)
    # a group's result is the result of that group alone
    lo = geom[0] // groups
    one = {k: (v[lo:2 * lo] if k == "x" else v) for k, v in t.items()}
    np.testing.assert_allclose(got[0][lo:2 * lo],
                               _call(M.bulge_packed, one, "pooled")[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_packed_pair_matches_jax_reference(geom):
    a = _inputs(*geom)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    y_ref, (m_ref, v_ref) = _reference_pair(j["x"], j["wT"], j["scale"],
                                            j["bias"], j["wC"])
    y, m, v = _call(M.bulge_packed, _tensors(a), "pooled")
    np.testing.assert_allclose(m, np.asarray(m_ref), **STATS_TOL)
    np.testing.assert_allclose(v, np.asarray(v_ref), **STATS_TOL)
    np.testing.assert_allclose(y, np.asarray(y_ref), **Y_TOL)


@pytest.mark.parametrize("ci,cm,co", [(8, 4, 8), (16, 8, 16), (32, 16, 32),
                                      (5, 2, 3)])
def test_packing_index_maps(ci, cm, co):
    rng = np.random.RandomState(0)
    wT = torch.from_numpy(rng.randn(ci, cm, 4, 4).astype(np.float32))
    wC = torch.from_numpy(rng.randn(co, cm, 4, 4).astype(np.float32))
    cmp_ = M.padded_cm(cm)
    assert cmp_ == max(cm, 8)
    w1 = M.pack_wT(wT).reshape(2, 2, ci, 2, 2, cmp_)
    w2 = M.pack_wC(wC).reshape(4, 4, cmp_, co)
    for ti in range(2):
        for tj in range(2):
            for di in range(2):
                for dj in range(2):
                    assert torch.equal(
                        w1[ti, tj, :, di, dj, :cm],
                        wT[:, :, 3 - di - 2 * ti, 3 - dj - 2 * tj])
    for a in range(4):
        for c in range(4):
            assert torch.equal(w2[a, c, :cm], wC[:, :, a, c].T)
    # the padding of Cm up to 8 is zero weight
    assert not w1[..., cm:].any() and not w2[:, :, cm:].any()


def test_fragment_order_is_what_an_mma_lane_reads():
    """Lane g*4 + t of mma.m16n8k8 holds B[k0 + t][n0 + g] and
    B[k0 + t + 4][n0 + g]; the kernel reads them as one 8-byte word at
    ((ks*NT + nt)*32 + lane)*2."""
    k, n = 32, 24
    mat = np.arange(k * n, dtype=np.float32).reshape(k, n)
    frag = M.to_fragments(mat)
    assert frag.shape == (k * n,) and sorted(frag) == sorted(mat.reshape(-1))
    nt_n = n // 8
    for ks in range(k // 8):
        for nt in range(nt_n):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                word = frag[((ks * nt_n + nt) * 32 + lane) * 2:][:2]
                assert word[0] == mat[ks * 8 + t, nt * 8 + g]
                assert word[1] == mat[ks * 8 + t + 4, nt * 8 + g]


def test_packed_operand_is_the_fragment_order_of_the_packed_matrix():
    rng = np.random.RandomState(1)
    wT = torch.from_numpy(rng.randn(8, 4, 4, 4).astype(np.float32))
    wC = torch.from_numpy(rng.randn(8, 4, 4, 4).astype(np.float32))
    np.testing.assert_array_equal(M.packed_operand("wT", wT).numpy(),
                                  M.to_fragments(M.pack_wT(wT).numpy()))
    np.testing.assert_array_equal(M.packed_operand("wC", wC).numpy(),
                                  M.to_fragments(M.pack_wC(wC).numpy()))


def test_packed_operand_cache_follows_the_tensor():
    w = torch.randn(8, 4, 4, 4)
    first = M.packed_operand("wT", w)
    assert M.packed_operand("wT", w) is first          # same tensor, unchanged
    w.mul_(2.0)                                        # written to: repack
    second = M.packed_operand("wT", w)
    assert second is not first
    torch.testing.assert_close(second, first * 2.0)
    other = w.clone()                                  # equal values, new tensor
    assert M.packed_operand("wT", other) is not second
    assert len(M._packed) <= M._PACKED_MAX


# ---- the TF32 split ----------------------------------------------------------

def test_split_tf32_halves():
    rng = np.random.RandomState(2)
    a = torch.from_numpy((rng.randn(4096) * np.exp(4 * rng.randn(4096)))
                         .astype(np.float32))
    hi, lo = M.split_tf32(a)
    assert not (hi.view(torch.int32) & 0x1FFF).any()   # 13 low bits zero
    assert torch.equal(hi + lo, a)                     # lo is the exact rest
    # what the mma reads of lo leaves a to 2^-20 relative (2^-21 typical)
    seen = (hi + M.trunc_tf32(lo)).double()
    rel = ((seen - a.double()).abs() / a.double().abs())
    assert rel.max().item() <= 2.0 ** -20
    assert rel.mean().item() <= 2.0 ** -21
    assert (lo.abs() <= a.abs() * 2.0 ** -10).all()


@pytest.mark.parametrize("k", [128, 256])
def test_three_tf32_products_keep_fp32_accuracy(k):
    """The accuracy argument for the tensor-core kernel: the emulated
    three-product sum stays within 2e-6 of the sum of absolute terms of the
    float64 product, and a single TF32 pass does not."""
    rng = np.random.RandomState(k)
    a = torch.from_numpy(rng.randn(64, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(k, 32).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    three = M.mma_3x(a, b).double()
    one = (M.trunc_tf32(a) @ M.trunc_tf32(b)).double()
    assert ((three - exact).abs() / scale).max().item() <= 2e-6
    assert ((one - exact).abs() / scale).max().item() > 2e-6
    # and in the units of the y tolerance: one pass breaks 2e-4, three do not
    assert (three - exact).abs().max().item() < 2e-4 / 4
    assert (one - exact).abs().max().item() > 2e-4


# ---- the schedule ------------------------------------------------------------

@pytest.mark.parametrize("bsz,h,w", RAGGED)
def test_schedule_covers_every_hidden_cell_once(bsz, h, w):
    s = M.Schedule(bsz, h, w)
    assert s.bands == -(-h // M.BAND_ROWS) and s.chunks == -(-w // M.CHUNK_COLS)
    assert s.n_items == bsz * s.per_image
    count = np.zeros((bsz, 2 * h, 2 * w), np.int64)
    seen = set()
    for idx in range(s.n_items):
        b, r0, c0 = s.item(idx)
        assert 0 <= b < bsz and r0 % M.BAND_ROWS == 0 and c0 % M.CHUNK_COLS == 0
        assert r0 < h and c0 < w
        seen.add((b, r0, c0))
        # item idx lands in slot idx: image b's slots are one contiguous run
        assert idx // s.per_image == b
        ob, rows, cols = s.owned(idx)
        assert ob == b
        np.add.at(count[b], (rows, cols), 1)
    assert len(seen) == s.n_items
    assert (count == 1).all()


def test_schedule_is_chunk_fastest():
    s = M.Schedule(2, 20, 70)
    assert [s.item(i) for i in range(4)] == [(0, 0, 0), (0, 0, 32), (0, 0, 64),
                                             (0, 8, 0)]
    assert s.item(s.per_image) == (1, 0, 0)


@pytest.mark.parametrize("groups", [1, 2, 6])
def test_reduce_partials_is_the_grouped_mean_and_var(groups):
    rng = np.random.RandomState(3)
    bsz, slots, cm, cells = 6, 5, 4, 64
    h = rng.randn(bsz, slots, cells // slots + 1, cm)
    h = h[:, :, :cells // slots + 1]            # cells per slot
    n_cells = slots * h.shape[2]
    partial = torch.from_numpy(np.stack(
        [h.sum(axis=2), (h * h).sum(axis=2)], axis=2).astype(np.float32))
    mean, var = M.reduce_partials(partial, n_cells, groups)
    flat = h.reshape(groups, -1, cm)
    assert mean.shape == (groups, cm)
    np.testing.assert_allclose(mean, flat.mean(axis=1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var, flat.var(axis=1), rtol=1e-5, atol=1e-6)


def test_packed_stats_slots_are_the_schedule_items():
    t = _tensors(_inputs(2, 8, 4, 8, 12, 40))
    partial = M.packed_stats(t["x"], t["wT"])
    s = M.Schedule(2, 12, 40)
    assert partial.shape == (2, s.per_image, 2, 4)
    from dcgan_sr_tpu_torch.ops import nn as N
    h = N.conv_transpose2d(t["x"], t["wT"], 2, 1)
    for idx in range(s.n_items):
        b, rows, cols = s.owned(idx)
        cells = h[b][:, rows, cols]
        np.testing.assert_allclose(partial.reshape(-1, 2, 4)[idx, 0],
                                   cells.sum(dim=1), rtol=1e-4, atol=1e-4)


# ---- the static choice -------------------------------------------------------

def test_choose_impl_is_a_static_rule_on_the_shapes():
    """fp32: the wgmma kernel where its tensor map takes x (a triple it was
    built for, W % 4 == 0, an aligned base), the mma.sync kernel at the
    other triples it was built for, the FMA kernel elsewhere."""
    for ci, cm, co in M.MMA_TRIPLES:
        for h, w in ((1, 3), (32, 32), (2048, 2048)):
            wgmma = (ci, cm, co) in M.WGMMA_TRIPLES and w % 4 == 0
            assert K.choose_impl(ci, cm, co, h, w) == \
                ("wgmma" if wgmma else "mma")
            assert K.choose_impl(ci, cm, co, h, w, aligned=False) == "mma"
    assert K.choose_impl(5, 4, 8, 16, 16) == "fma"      # Ci != 2 Cm
    assert K.choose_impl(16, 16, 32, 16, 16) == "fma"


def test_impl_argument_is_checked():
    t = _tensors(_inputs(1, 5, 4, 8, 8, 8))
    with pytest.raises(ValueError, match="impl must be one of"):
        K._impl_for("auto", t["x"], t["wT"], t["wC"])
    with pytest.raises(ValueError, match="wgmma bulge kernel takes Ci/Cm/Co"):
        K._impl_for("wgmma", t["x"], t["wT"], t["wC"])
    with pytest.raises(ValueError, match="no instantiation"):
        K._impl_for("mma", t["x"], t["wT"], t["wC"])
    assert K._impl_for(None, t["x"], t["wT"], t["wC"]) == "fma"
    assert K._impl_for("fma", t["x"], t["wT"], t["wC"]) == "fma"
    assert set(K.impl_launches) == set(K.IMPLS) | {"mma_bf16", "wgmma_bf16"}


def test_network_hands_its_bulge_impl_to_the_pair():
    """Network(bulge_impl=...) asks for an implementation by name; on the CPU
    every choice is the plain version, so the outputs are equal."""
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
    cfg = get_config("gray-3", env_override=False, ngf=4)
    spec = generator_spec(cfg)
    params, state = init_network(spec, torch.Generator().manual_seed(0))
    x = torch.rand((2, 1, 8, 8), generator=torch.Generator().manual_seed(1))
    nets = [Network(spec, params, state, device="cpu", bulge_impl=impl)
            for impl in (None, "fma", "mma")]
    assert [n.bulge_impl for n in nets] == [None, "fma", "mma"]
    assert nets[0].pairs
    outs = [n(x, bn_stats="running") for n in nets]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
