"""What surrounds the fp32 wgmma bulge kernel (csrc/bulge_wgmma.cu namespace
wgf, 3xTF32 on wgmma), held on the CPU: the packing of W1 and W2 as two
fp32 planes (hi, lo) in wgmma's tf32 K-major layout and the descriptor
arithmetic that reads them (ops/bulge_mma.py to_wgmma_tf32,
wgmma_read_tf32, packed_operand), the fp32 TMA box (origin c0-4, 44
columns) at both band heights, an emulation of the kernel's arithmetic
item by item (bulge_mma.bulge_wgmma_f32) held to the TPU kernel in
interpret mode, and the static choice of implementation (ops/bulge.py
choose_impl, _impl_for).  The kernel itself is held to the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py phases 2 and 10).

Tolerances: the packed layout only moves values, so reads through it are
exact, and so is the split (hi + lo == w in fp32).  The emulation runs the
kernel's products (three TF32 products a k-step, fp32 sums) and is held
to fused_bulge_fwd(interpret=True), which runs fp32 at Precision.HIGHEST,
within 1e-5 abs + rel (y and statistics), and to bulge_plain within the
pair's tolerances (tests/test_torch_bulge.py)."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from dcgan_sr_tpu.ops.pallas_bulge import fused_bulge_fwd
from dcgan_sr_tpu_torch import ablation
from dcgan_sr_tpu_torch.ops import bulge as K
from dcgan_sr_tpu_torch.ops import bulge_mma as M

from test_torch_bulge import STATS_TOL, Y_TOL, _inputs

import torch_threads  # noqa: F401

TRIPLES = [(16, 8, 16), (32, 16, 32)]
# ragged geometries the fp32 wgmma kernel takes (W % 4 == 0), both triples
RAGGED = [(2, 16, 8, 16, 13, 44), (3, 16, 8, 16, 1, 4),
          (1, 32, 16, 32, 10, 36), (2, 32, 16, 32, 5, 8)]
# the path shapes: gray-3 served at LR 256, the eval batch, 64 images'
# overlap tiles
PATH = [(1, 16, 8, 16, 2048, 2048), (100, 16, 8, 16, 256, 256),
        (14400, 32, 16, 32, 32, 32)]


def _tensors(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _call(fn, t, stats, groups=None):
    y, (m, v) = fn(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                   stats=stats, groups=groups,
                   running=(t["rmean"], t["rvar"]) if stats == "running"
                   else None)
    return y.numpy(), m.numpy(), v.numpy()


def _mats(ci, cm, co, seed=0):
    rng = np.random.RandomState(seed)
    wT = torch.tensor(rng.randn(ci, cm, 4, 4), dtype=torch.float32)
    wC = torch.tensor(rng.randn(co, cm, 4, 4), dtype=torch.float32)
    w2 = M.pack_wC(wC)
    # stage 2 reads k-step ks's logical k kk as row ks*8 + KPERM8[kk]
    w2 = w2.reshape(-1, 8, co)[:, list(M.KPERM8)].reshape(w2.shape)
    return {"wT": (wT, M.pack_wT(wT)), "wC": (wC, w2)}


def _steps(plane, k, n):
    """The (k, n) operand read k-step by k-step through wgmma_read_tf32."""
    kk, nn = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
    kk, nn = torch.from_numpy(kk), torch.from_numpy(nn)
    return torch.cat([M.wgmma_read_tf32(plane, kk, nn, n, ks)
                      for ks in range(k // 8)])


# ---- the packed operands ----------------------------------------------------

@pytest.mark.parametrize("ci,cm,co", TRIPLES)
def test_tf32_packing_round_trips(ci, cm, co):
    """to_wgmma_tf32 puts every element of W1 and W2 (W2 in KPERM8's row
    order) where the descriptor reads it, k-step by k-step, and a product
    through the packed layout is the plain product."""
    rng = np.random.RandomState(1)
    for kind, (w, mat) in _mats(ci, cm, co).items():
        k, n = mat.shape
        flat = torch.from_numpy(M.to_wgmma_tf32(mat.numpy()).copy())
        assert flat.numel() == mat.numel()
        assert torch.equal(_steps(flat, k, n), mat)
        a = torch.tensor(rng.randn(64, k), dtype=torch.float64)
        got = sum(a[:, 8 * ks:8 * ks + 8] @ _steps(flat, k, n)[
            8 * ks:8 * ks + 8].double() for ks in range(k // 8))
        torch.testing.assert_close(got, a @ mat.double(), rtol=1e-12,
                                   atol=1e-12)
        # the operand the wrapper hands the kernel: hi plane, then lo plane
        op = M.packed_operand(kind, w, torch.float32, "wgmma")
        assert op.dtype == torch.float32 and op.numel() == 2 * mat.numel()
        hi, lo = op[:mat.numel()], op[mat.numel():]
        assert torch.equal(_steps(hi, k, n), M.trunc_tf32(mat))
        assert torch.equal(_steps(hi + lo, k, n), mat)


@pytest.mark.parametrize("ci,cm,co", TRIPLES)
def test_hi_lo_planes_sum_to_the_weights_and_lo_is_exact(ci, cm, co):
    for kind, (w, mat) in _mats(ci, cm, co, seed=2).items():
        op = M.packed_operand(kind, w, torch.float32, "wgmma")
        hi, lo = op[:mat.numel()], op[mat.numel():]
        want = torch.from_numpy(M.to_wgmma_tf32(mat.numpy()).copy())
        assert not (hi.view(torch.int32) & 0x1FFF).any()   # hi is TF32
        assert torch.equal(hi + lo, want)                  # exactly, in fp32
        assert torch.equal(lo.double(), want.double() - hi.double())
        assert (lo.abs() <= want.abs() * 2.0 ** -10).all()


def _desc_start(word):
    """The start address a descriptor's low word addresses (bits 0-13, in
    16-byte units), and its leading byte offset (bits 16-29)."""
    return (word & 0x3FFF) << 4, ((word >> 16) & 0x3FFF) << 4


@pytest.mark.parametrize("ci,cm,co", TRIPLES)
def test_descriptor_offsets_address_what_the_kernel_reads(ci, cm, co):
    """The kernel builds a k-step's descriptors by one integer add to the
    low word of its k-step 0 (csrc/bulge_wgmma.cu wgf::chain): + ks * 2 *
    leading / 16 for the hi plane, + the plane's bytes / 16 more for the lo
    plane.  Decoded, those words address k-step ks of each plane, at the
    weights' place in shared memory (W1 at 0, W2 after it, 128-aligned)."""
    for kind, (w, mat) in _mats(ci, cm, co).items():
        k, n = mat.shape
        op = M.packed_operand(kind, w, torch.float32, "wgmma")
        plane = mat.numel() * 4
        lead, stride = M.wgmma_offsets(n)
        assert (lead, stride) == (n // 8 * 128, 128)
        base = 0 if kind == "wT" else 2 * 16 * ci * cm * 4   # smem offsets
        word0 = ((base & 0x3FFFF) >> 4) | ((lead >> 4) << 16)
        smem = torch.zeros((base + 2 * plane) // 4)
        smem[base // 4:] = op
        for ks in range(k // 8):
            for which, add in (("hi", 0), ("lo", plane >> 4)):
                start, lbo = _desc_start(word0 + (ks * 2 * lead >> 4) + add)
                assert lbo == lead
                got = _steps(smem[start // 4:], 8, n)
                want = op[:mat.numel()] if which == "hi" else op[mat.numel():]
                assert torch.equal(got, _steps(want, k, n)[8 * ks:8 * ks + 8])


# ---- the fp32 TMA box and the band heights ----------------------------------

@pytest.mark.parametrize("geom", RAGGED + PATH[:1] + PATH[2:])
def test_fp32_tma_box_reproduces_the_staged_window(geom):
    """For every work item of either kernel (stats: bands of 8 rows; main:
    f32_main_rows), the fp32 box origin is (c0 - 4, r0 - 1), its column a
    multiple of 4 (16 bytes); the box the hardware fills (a zero-padded
    slice) is tma_box's, its TW + 2 columns from F32_BOX_COL0 are the
    window stage_x stages by hand (its first R + 2 rows, at R = 8), and a
    channel plane is 8 or 24 floats mod 32 (no bank conflicts)."""
    bsz, ci, _, _, h, w = geom
    rng = np.random.RandomState(bsz + h)
    x = torch.tensor(rng.randn(min(bsz, 2), ci if h * w < 1 << 20 else 2, h,
                               w), dtype=torch.float32)
    for rows in (M.BAND_ROWS, M.f32_main_rows(ci)):
        sched = M.Schedule(bsz, h, w, rows)
        items = {sched.item(i)[1:] for i in range(sched.n_items)}
        assert len(items) == sched.bands * sched.chunks
        assert ((rows + 2) * M.F32_BOX_COLS) % 32 in (8, 24)
        for img in x:
            padded = F.pad(img, (M.F32_BOX_COLS,) * 2 + (rows + 2,) * 2)
            for r0, c0 in items:
                c, r = M.tma_box_origin(r0, c0, torch.float32)
                assert (c, r) == (c0 - 4, r0 - 1) and c % 4 == 0
                box = M.tma_box(img, r0, c0, torch.float32, rows)
                assert box.shape == (img.shape[0], rows + 2, M.F32_BOX_COLS)
                assert torch.equal(box, padded[
                    :, r + rows + 2:r + 2 * (rows + 2),
                    c + M.F32_BOX_COLS:c + 2 * M.F32_BOX_COLS])
                window = box[:, :, M.F32_BOX_COL0:
                             M.F32_BOX_COL0 + M.CHUNK_COLS + 2]
                if rows == M.BAND_ROWS:
                    assert torch.equal(window, M.staged_window(img, r0, c0))
                else:
                    assert torch.equal(window, M.staged_window(
                        img, r0, c0)[:, :rows + 2])


def test_main_band_rows_and_schedule():
    """The fp32 main kernel walks bands of 4 rows at Ci 32 (8 rows' buffers
    do not fit in shared memory) and 8 at Ci 16; the statistics slots stay
    the stats kernel's, bands of 8."""
    assert M.f32_main_rows(32) == 4 and M.f32_main_rows(16) == 8
    s4 = M.Schedule(3, 10, 40, rows=4)
    assert (s4.bands, s4.chunks, s4.per_image) == (3, 2, 6)
    assert s4.item(7) == (1, 0, 32)
    s8 = M.Schedule(3, 10, 40)
    assert s8.per_image == M.slots_per_image(10, 40) == 4
    b, rows, cols = s4.owned(5)
    assert b == 0 and rows.max() < 20 and set(rows.tolist()) == set(
        range(16, 20))


# ---- the kernel's arithmetic, emulated --------------------------------------

@pytest.mark.parametrize("geom", [(1, 16, 8, 16, 16, 128),
                                  (1, 32, 16, 32, 8, 128)])
def test_emulation_matches_the_tpu_kernel_interpret(geom):
    """The kernel's arithmetic (packed hi/lo planes, A split as hi =
    a & 0xffffe000 and lo = a - hi, three TF32 products a k-step in the
    kernel's k order, at its band heights) against fused_bulge_fwd, the
    TPU kernel in interpret mode (pooled statistics, its only mode)."""
    a = _inputs(*geom, seed=4)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    y_ref, (m_ref, v_ref) = fused_bulge_fwd(j["x"], j["wT"], j["scale"],
                                            j["bias"], j["wC"], tm=8,
                                            interpret=True)
    y, m, v = _call(M.bulge_wgmma_f32, _tensors(a), "pooled")
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m, np.asarray(m_ref), **tol)
    np.testing.assert_allclose(v, np.asarray(v_ref), **tol)
    np.testing.assert_allclose(y, np.asarray(y_ref), **tol)


@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", RAGGED)
def test_emulation_matches_plain_at_ragged_shapes(geom, stats):
    t = _tensors(_inputs(*geom, seed=5))
    got, want = _call(M.bulge_wgmma_f32, t, stats), _call(K.bulge_plain, t,
                                                          stats)
    np.testing.assert_allclose(got[1], want[1], **STATS_TOL)
    np.testing.assert_allclose(got[2], want[2], **STATS_TOL)
    np.testing.assert_allclose(got[0], want[0], **Y_TOL)


def test_emulation_reads_the_permuted_w2():
    """W2 packed without KPERM8 on its rows gives a wrong y: the
    permutation is what pairs a lane's 8-byte hidden-plane load (channels
    2t, 2t+1 as logical k t, t+4) with its B rows."""
    t = _tensors(_inputs(1, 16, 8, 16, 8, 32, seed=6))
    args = (t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    y, _ = M.bulge_wgmma_f32(*args)
    yp, _ = K.bulge_plain(*args)
    assert (y - yp).abs().max() < 1e-4
    mat = M.pack_wC(t["wC"])                  # rows in plain k order
    flat = torch.from_numpy(M.to_wgmma_tf32(mat.numpy()).copy())
    hi = M.trunc_tf32(flat)
    key = ("wC", id(t["wC"]), torch.float32, "wgmma")
    M._packed[key] = (t["wC"], t["wC"]._version, torch.cat([hi, flat - hi]))
    try:
        y_wrong, _ = M.bulge_wgmma_f32(*args)
    finally:
        M._packed.pop(key, None)
    assert (y_wrong - yp).abs().max() > 1e-2


# ---- the static choice ------------------------------------------------------

def _x(shape, dtype=torch.float32, offset=0):
    """x of this shape whose base lies `offset` bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 16, dtype=dtype)
    size = buf.element_size()
    skip = (-buf.data_ptr() % 16 + offset) // size
    return buf[skip:skip + n].view(*shape)


@pytest.mark.parametrize("geom", PATH)
def test_wgmma_is_chosen_for_fp32_at_the_path_shapes(geom):
    bsz, ci, cm, co, h, w = geom
    assert K.choose_impl(ci, cm, co, h, w) == "wgmma"
    x = _x((1, ci, 8, w))              # the choice reads W, not B or H
    wT, wC = torch.zeros(ci, cm, 4, 4), torch.zeros(co, cm, 4, 4)
    assert K._impl_for(None, x, wT, wC) == "wgmma"
    assert K._impl_for(None, x, wT) == "wgmma"       # the stats launch


def test_mma_takes_what_the_fp32_tensor_map_cannot():
    wT, wC = torch.zeros(16, 8, 4, 4), torch.zeros(16, 8, 4, 4)
    # W % 4 != 0: the map's row stride is not a multiple of 16 bytes
    assert K._impl_for(None, _x((1, 16, 16, 45)), wT, wC) == "mma"
    assert K._impl_for(None, _x((3, 16, 1, 3)), wT, wC) == "mma"
    # a view whose base is 4 bytes past a 16-byte boundary
    x = _x((1, 16, 8, 32), offset=4)
    assert x.data_ptr() % 16 == 4
    assert K._impl_for(None, x, wT, wC) == "mma"
    # a triple the wgmma kernel was not built for
    assert K._impl_for(None, _x((1, 8, 16, 32)), torch.zeros(8, 4, 4, 4),
                       torch.zeros(8, 4, 4, 4)) == "mma"
    assert K._impl_for(None, _x((1, 5, 8, 8)), torch.zeros(5, 4, 4, 4),
                       torch.zeros(8, 4, 4, 4)) == "fma"


def test_impl_and_dtype_mismatches_raise():
    wT, wC = torch.zeros(16, 8, 4, 4), torch.zeros(16, 8, 4, 4)
    # W 20: the fp32 map takes it, the bf16 one does not (W % 8)
    assert K._impl_for("wgmma", _x((1, 16, 8, 20)), wT, wC) == "wgmma"
    with pytest.raises(ValueError, match="multiple of 8"):
        K._impl_for("wgmma", _x((1, 16, 8, 20), torch.bfloat16), wT, wC)
    with pytest.raises(ValueError, match="multiple of 4"):
        K._impl_for("wgmma", _x((1, 16, 8, 18)), wT, wC)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K._impl_for("wgmma", _x((1, 16, 8, 32), offset=8), wT, wC)
    with pytest.raises(ValueError, match="float32 only"):
        K._impl_for("fma", _x((1, 16, 8, 32), torch.bfloat16), wT, wC)
    with pytest.raises(ValueError, match="impl must be one of"):
        K._impl_for("wgmma_bf16", _x((1, 16, 8, 32)), wT, wC)
    assert K.IMPLS == ("wgmma", "mma", "fma")
    assert "wgmma" in K.impl_launches and "wgmma_bf16" in K.impl_launches


@pytest.mark.parametrize("stats", K.STATS_MODES)
def test_fp32_cpu_tensor_runs_the_plain_version(stats):
    """On a CPU tensor impl="wgmma" runs bulge_plain and launches nothing."""
    t = _tensors(_inputs(2, 32, 16, 32, 12, 16, seed=7))
    run = (t["rmean"], t["rvar"]) if stats == "running" else None
    before, by_impl = dict(K.launches), dict(K.impl_launches)
    got = K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                  stats=stats, running=run, impl="wgmma")
    want = K.bulge_plain(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                         stats=stats, running=run)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert K.launches == before and K.impl_launches == by_impl


@pytest.mark.parametrize(
    "name", sorted(ablation.KERNELS["bulge_wgmma_f32"].variants))
def test_every_fp32_ablation_variant_applies_to_the_kernel_source(name):
    """python -m dcgan_sr_tpu_torch.ablation --kernel bulge_wgmma_f32
    rebuilds csrc/bulge_wgmma.cu with text substitutions: each must still
    find its text, and none may touch the bf16 kernel (namespace wg)."""
    src = ablation.variant_source("bulge_wgmma_f32", name)
    with open(os.path.join(ablation.B.CSRC, "bulge_wgmma.cu")) as f:
        base = f.read()
    assert (src == base) == (name == "base")
    cut = base.index("namespace wgf {")
    assert src[:cut] == base[:cut]
