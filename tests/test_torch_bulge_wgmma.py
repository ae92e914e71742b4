"""What surrounds the wgmma bulge kernel (csrc/bulge_wgmma.cu), held on the
CPU: the packing of W1 and W2 into wgmma's shared-memory layout and the
descriptor offsets that read it (ops/bulge_mma.py to_wgmma_bf16,
wgmma_offsets, wgmma_read), the TMA box each work item loads with the
hardware's zero fill (tma_box_origin, tma_box), and the static choice
between the two bf16 kernels (ops/bulge.py choose_impl, _impl_for).  The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 14).

Tolerances: the packed layout only moves values, so a read through it is
exact; products through it are held in float64 to 1e-12 of the plain
product.  The box model is held to the window the mma.sync kernel stages
(stage_x) and to a zero-padded slice, element for element."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dcgan_sr_tpu_torch import ablation
from dcgan_sr_tpu_torch.ops import bulge as K
from dcgan_sr_tpu_torch.ops import bulge_mma as M

from test_torch_bulge import _inputs

import torch_threads  # noqa: F401

BF = torch.bfloat16
# chip_smoke.py BF16_RAGGED (B, Ci, Cm, Co, H, W), and the two path shapes:
# gray-3 served at LR 256 and 64 images' overlap tiles
RAGGED = [(2, 16, 8, 16, 37, 45), (1, 32, 16, 32, 24, 40),
          (1, 8, 4, 8, 16, 20), (3, 16, 8, 16, 1, 3)]
PATH = [(1, 16, 8, 16, 2048, 2048), (14400, 32, 16, 32, 32, 32)]


def _tensors(a, bf16_x=True):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    if bf16_x:
        t["x"] = t["x"].to(BF)
    return t


# ---- the packed operands -------------------------------------------------------

def _operands(ci, cm, co, seed=0):
    rng = np.random.RandomState(seed)
    wT = torch.tensor(rng.randn(ci, cm, 4, 4), dtype=torch.float64)
    wC = torch.tensor(rng.randn(co, cm, 4, 4), dtype=torch.float64)
    return {"wT": (wT, M.pack_wT(wT)), "wC": (wC, M.pack_wC(wC))}


def _unpack(flat, k, n):
    """The (k, n) operand as the kernel's descriptors read it, k-step by
    k-step (wgmma_read)."""
    kk, nn = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    return torch.cat([M.wgmma_read(flat, torch.from_numpy(kk),
                                   torch.from_numpy(nn), n, ks)
                      for ks in range(k // 16)])


@pytest.mark.parametrize("ci,cm,co", [(8, 4, 8), (16, 8, 16), (32, 16, 32)])
def test_wgmma_packing_round_trips(ci, cm, co):
    """to_wgmma_bf16 puts every element of W1 and W2 where the descriptor
    (start ks * 2 * leading, leading between k core matrices, stride between
    n core matrices) reads it, and a product through the packed layout,
    k-step by k-step, is the plain product."""
    rng = np.random.RandomState(1)
    for kind, (w, mat) in _operands(ci, cm, co).items():
        k, n = mat.shape
        flat = torch.from_numpy(M.to_wgmma_bf16(mat.numpy()).copy())
        assert flat.numel() == mat.numel()
        assert torch.equal(_unpack(flat, k, n), mat)
        a = torch.tensor(rng.randn(64, k), dtype=torch.float64)
        steps = sum(a[:, 16 * ks:16 * ks + 16] @ _unpack(flat, k, n)[
            16 * ks:16 * ks + 16] for ks in range(k // 16))
        torch.testing.assert_close(steps, a @ mat, rtol=1e-12, atol=1e-12)
        # the operand the wrapper hands the kernel: the same, in bf16
        got = M.packed_operand(kind, w.float(), BF, "wgmma")
        assert got.dtype == BF
        want = M.to_wgmma_bf16(mat.float().to(BF).float().numpy())
        assert torch.equal(got.float(), torch.from_numpy(want.copy()))


def test_wgmma_offsets_address_a_column_half():
    """The stats kernel's warpgroup v reads columns [v*N/2, (v+1)*N/2) from a
    start v * (N/16) stride bytes in: the same elements as the whole
    operand's."""
    _, mat = _operands(32, 16, 32)["wT"]
    k, n = mat.shape
    flat = M.to_wgmma_bf16(mat.numpy())
    lead, stride = M.wgmma_offsets(n)
    assert (lead, stride) == (n // 8 * 128, 128)
    half = n // 2
    for v in range(2):
        start = v * (half // 8) * stride // 2          # in elements
        for kk in range(0, k, 7):
            for c in range(half):
                byte = (kk // 8) * lead + (c // 8) * stride + (c % 8) * 16 \
                    + (kk % 8) * 2
                assert flat[start + byte // 2] == mat[kk, v * half + c]


# ---- the TMA box --------------------------------------------------------------

def _pad(x_img):
    return F.pad(x_img, (M.BOX_COLS, M.BOX_COLS, M.BOX_ROWS, M.BOX_ROWS))


def _hardware_box(padded, c, r):
    """BOX_ROWS x BOX_COLS of the image from column c, row r (possibly
    negative), zero where the box leaves the image: a slice of the image
    padded with zeros (`_pad`)."""
    return padded[:, r + M.BOX_ROWS:r + 2 * M.BOX_ROWS,
                  c + M.BOX_COLS:c + 2 * M.BOX_COLS]


@pytest.mark.parametrize("geom", RAGGED + PATH)
def test_tma_box_reproduces_the_staged_window(geom):
    """For every work item, the box origin is (c0 - 8, r0 - 1), its column
    a multiple of 8 (16 bytes, which the hardware requires); the box the
    hardware fills (a zero-padded slice) is tma_box's, and its TW + 2
    columns from BOX_COL0 are the window stage_x stages by hand, halo and
    image edge included.  The box's content depends only on (r0, c0), so it is
    checked once per distinct (r0, c0), on two images (at 2048 x 2048 with
    two channels: the geometry does not depend on the channel count)."""
    bsz, ci, _, _, h, w = geom
    sched = M.Schedule(bsz, h, w)
    geoms = {}
    for idx in range(sched.n_items):
        b, r0, c0 = sched.item(idx)
        c, r = M.tma_box_origin(r0, c0)
        assert (c, r) == (c0 - 8, r0 - 1) and c % 8 == 0
        geoms.setdefault((r0, c0), b)
    assert len(geoms) == sched.bands * sched.chunks
    rng = np.random.RandomState(bsz + h)
    x = torch.tensor(rng.randn(min(bsz, 2), ci if h * w < 1 << 20 else 2, h,
                               w), dtype=torch.float32)
    for img in x:
        padded = _pad(img)
        for (r0, c0) in geoms:
            box = M.tma_box(img, r0, c0)
            assert box.shape == (img.shape[0], M.BOX_ROWS, M.BOX_COLS)
            assert torch.equal(box, _hardware_box(padded, c0 - 8, r0 - 1))
            assert torch.equal(
                box[:, :, M.BOX_COL0:M.BOX_COL0 + M.CHUNK_COLS + 2],
                M.staged_window(img, r0, c0))


# ---- the choice between the two bf16 kernels ---------------------------------

def _x(bsz, ci, h, w, offset=0):
    """bf16 x of this shape whose base lies `offset` bytes past a 16-byte
    boundary."""
    n = bsz * ci * h * w
    buf = torch.zeros(n + 16, dtype=BF)
    skip = (-buf.data_ptr() % 16 + offset) // 2
    return buf[skip:skip + n].view(bsz, ci, h, w)


@pytest.mark.parametrize("geom", PATH)
def test_wgmma_is_chosen_at_the_path_shapes(geom):
    bsz, ci, cm, co, h, w = geom
    assert K.choose_impl(ci, cm, co, h, w, BF) == "wgmma"
    x = _x(1, ci, 8, w)                  # the choice reads W, not B or H
    wT, wC = torch.zeros(ci, cm, 4, 4), torch.zeros(co, cm, 4, 4)
    assert K._impl_for(None, x, wT, wC) == "wgmma"
    assert K._impl_for(None, x, wT) == "wgmma"       # the stats launch


def test_mma_takes_what_the_tensor_map_cannot():
    wT, wC = torch.zeros(16, 8, 4, 4), torch.zeros(16, 8, 4, 4)
    # W % 8 != 0: the map's row stride is not a multiple of 16 bytes
    assert K._impl_for(None, _x(1, 16, 16, 20), wT, wC) == "mma"
    # a view whose base is 2 bytes past a 16-byte boundary
    x = _x(1, 16, 8, 32, offset=2)
    assert x.data_ptr() % 16 == 2
    assert K._impl_for(None, x, wT, wC) == "mma"
    assert K.choose_impl(16, 8, 16, 8, 32, BF, aligned=False) == "mma"
    # a triple the wgmma kernel was not built for
    assert (8, 4, 8) not in M.WGMMA_TRIPLES
    assert K._impl_for(None, _x(1, 8, 16, 32), torch.zeros(8, 4, 4, 4),
                       torch.zeros(8, 4, 4, 4)) == "mma"
    # float32 has its own wgmma kernel, whose map needs only W % 4 == 0
    assert K.choose_impl(16, 8, 16, 8, 32) == "wgmma"
    assert K.choose_impl(16, 8, 16, 8, 20) == "wgmma"
    assert K.choose_impl(16, 8, 16, 8, 30) == "mma"


def test_wgmma_refuses_what_it_does_not_take():
    wT, wC = torch.zeros(16, 8, 4, 4), torch.zeros(16, 8, 4, 4)
    # fp32 x goes to the fp32 wgmma kernel, whose map needs W % 4 == 0
    assert K._impl_for("wgmma", torch.zeros(1, 16, 8, 32), wT, wC) == "wgmma"
    with pytest.raises(ValueError, match="multiple of 4"):
        K._impl_for("wgmma", torch.zeros(1, 16, 8, 30), wT, wC)
    with pytest.raises(ValueError, match="multiple of 8"):
        K._impl_for("wgmma", _x(1, 16, 16, 20), wT, wC)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K._impl_for("wgmma", _x(1, 16, 8, 32, offset=4), wT, wC)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K._impl_for("wgmma", _x(1, 8, 8, 32), torch.zeros(8, 4, 4, 4),
                    torch.zeros(8, 4, 4, 4))
    assert K._impl_for("mma", _x(1, 16, 8, 32), wT, wC) == "mma"
    assert set(K.impl_launches) == {"wgmma", "mma", "fma", "mma_bf16",
                                    "wgmma_bf16"}


@pytest.mark.parametrize("stats", K.STATS_MODES)
def test_wgmma_on_cpu_tensors_is_the_plain_version(stats):
    """On a CPU tensor every impl runs bulge_plain and launches nothing."""
    t = _tensors(_inputs(2, 16, 8, 16, 12, 16, seed=3))
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


@pytest.mark.parametrize("name", sorted(ablation.KERNELS["bulge_wgmma"].variants))
def test_every_wgmma_ablation_variant_applies_to_the_kernel_source(name):
    """python -m dcgan_sr_tpu_torch.ablation --kernel bulge_wgmma rebuilds
    csrc/bulge_wgmma.cu with text substitutions: each must still find its
    text."""
    src = ablation.variant_source("bulge_wgmma", name)
    with open(os.path.join(ablation.B.CSRC, "bulge_wgmma.cu")) as f:
        base = f.read()
    assert (src == base) == (name == "base")
