"""Card-only tests of the port: the hand-written CUDA kernels have no CPU
mode, so these skip without an NVIDIA card.  The file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

  python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

Tolerances as in tests/test_torch_bulge.py (1e-5 for the hidden tensor's
mean/var, 2e-4 for y): the fused kernel and cuDNN (TF32 off) sum the same
fp32 products in different orders.  The preprocess kernel keeps its products
and sums uncontracted (no FMA) and sums in the plain version's order, so it
is held to bit equality.  The bf16 instantiations of the bulge kernel and
of the channels-last pair are held to their plain bf16 versions: y within
two bf16 steps of max |y| (h is rounded to bf16 after an fp32 sum in
another order and may round the other way, then y rounds once more), at
most 1% of y's elements different at all.

The trainer's K-step chunk as a CUDA graph (train/multi_step.py) is held to
the eager loop, and the staged feed (train/loop.py) to the plain loop, with
cuDNN's deterministic algorithms (its default backward may sum with
atomics): per-step losses (and, for the feed, the final state) within twice
the run-to-run spread of two runs of the yardstick, 0 when they repeat, and
a float32 floor of 1e-6 relative.  At full width, with cuDNN's own choice,
chip_smoke.py phase 22 holds the graph to the eager loop."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn
from dcgan_sr_tpu_torch.models import Network
from dcgan_sr_tpu_torch.ops import bulge as K
from dcgan_sr_tpu_torch.ops import fused_nhwc as F3
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.ops import preprocess as P
from dcgan_sr_tpu_torch.train import loop
from dcgan_sr_tpu_torch.train.checkpoint import load_generator
from dcgan_sr_tpu_torch.train.loop import train_epochs
from dcgan_sr_tpu_torch.train.multi_step import build_multi_step
from dcgan_sr_tpu_torch.train.step import (build_train_step, init_train_state,
                                           state_from_numpy, state_to_numpy)

import torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
Y_TOL = dict(rtol=2e-4, atol=2e-4)
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "gray3_textured_net_G.npz")
PATCH_FIXTURE = os.path.join(os.path.dirname(FIXTURE),
                             "overlap_textured_net_G.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(bsz, ci, cm, co, h, w, device, seed=0):
    rng = np.random.RandomState(seed)
    a = dict(x=rng.randn(bsz, ci, h, w), wT=0.1 * rng.randn(ci, cm, 4, 4),
             wC=0.1 * rng.randn(co, cm, 4, 4), scale=1 + 0.1 * rng.randn(cm),
             bias=0.1 * rng.randn(cm), rmean=0.1 * rng.randn(cm),
             rvar=0.5 + rng.rand(cm))
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in a.items()}


@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", [(2, 16, 8, 16, 37, 45), (1, 8, 4, 8, 16, 20),
                                  (1, 32, 16, 32, 24, 40), (3, 16, 8, 16, 1, 3)])
def test_kernel_matches_plain(cuda, geom, stats):
    t = _inputs(*geom, cuda)
    run = (t["rmean"], t["rvar"]) if stats == "running" else None
    n0 = dict(K.launches)
    y, (m, v) = K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                        stats=stats, running=run)
    yp, (mp, vp) = K.bulge_plain(t["x"], t["wT"], t["scale"], t["bias"],
                                 t["wC"], stats=stats, running=run)
    torch.cuda.synchronize()
    assert K.launches["bulge_main"] == n0["bulge_main"] + 1
    assert K.launches["bulge_stats"] == n0["bulge_stats"] + (stats != "running")
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


@pytest.mark.parametrize("impl", K.IMPLS)
@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", [(2, 16, 8, 16, 37, 45), (1, 8, 4, 8, 16, 20),
                                  (1, 32, 16, 32, 24, 40), (3, 16, 8, 16, 1, 3)])
def test_each_implementation_matches_plain(cuda, geom, stats, impl):
    """The wgmma kernel ("wgmma", where its tensor map takes x), the
    mma.sync kernel ("mma") and the fp32 FMA kernel ("fma"), each asked for
    by name, against the plain version; the launch counts move by
    implementation.  Where the wgmma kernel does not take x (W % 4 != 0,
    an unbuilt triple) asking for it raises and launches nothing."""
    t = _inputs(*geom, cuda)
    run = (t["rmean"], t["rvar"]) if stats == "running" else None
    n0, i0 = dict(K.launches), dict(K.impl_launches)
    args = (t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    if impl == "wgmma" and not K.wgmma_takes(*geom[1:4], geom[5], True,
                                             torch.float32):
        with pytest.raises(ValueError, match="wgmma bulge kernel takes"):
            K.bulge(*args, stats=stats, running=run, impl=impl)
        assert K.launches == n0 and K.impl_launches == i0
        return
    y, (m, v) = K.bulge(*args, stats=stats, running=run, impl=impl)
    yp, (mp, vp) = K.bulge_plain(*args, stats=stats, running=run)
    torch.cuda.synchronize()
    moved = 1 + (stats != "running")
    assert K.launches["bulge_main"] == n0["bulge_main"] + 1
    assert K.impl_launches[impl] == i0[impl] + moved
    for other in K.impl_launches:
        if other != impl:
            assert K.impl_launches[other] == i0[other]
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


def test_default_implementation_is_the_static_rule(cuda):
    t = _inputs(1, 16, 8, 16, 16, 20, cuda)
    i0 = dict(K.impl_launches)
    K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    assert K.choose_impl(16, 8, 16, 16, 20) == "wgmma"
    assert K.impl_launches == {"wgmma": i0["wgmma"] + 2, "mma": i0["mma"],
                               "fma": i0["fma"], "mma_bf16": i0["mma_bf16"],
                               "wgmma_bf16": i0["wgmma_bf16"]}
    t = _inputs(1, 16, 8, 16, 16, 22, cuda)       # W % 4 != 0: mma.sync
    K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    assert K.impl_launches["mma"] == i0["mma"] + 2
    with pytest.raises(ValueError, match="impl must be one of"):
        K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"], impl="auto")


def test_stats_slots_match_the_packed_version(cuda):
    """The tensor-core stats launch writes, slot by slot, what the packed
    plain version computes for the same work items."""
    from dcgan_sr_tpu_torch.ops import bulge_mma as M
    t = _inputs(2, 16, 8, 16, 20, 70, cuda, seed=5)
    got = K.launch_stats(t["x"], t["wT"].contiguous(), impl="mma")
    want = M.packed_stats(t["x"].cpu(), t["wT"].cpu())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-4, atol=1e-3)


def test_kernel_rejects_unbuilt_channel_counts(cuda):
    t = _inputs(1, 6, 3, 6, 8, 8, cuda)
    with pytest.raises(ValueError, match="no instantiation"):
        K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"])


@pytest.mark.parametrize("bn_eval", [False, True])
def test_fused_generator_matches_unfused_on_card(cuda, bn_eval):
    cfg = get_config("gray-3", env_override=False)
    fused, _ = load_generator(cfg, FIXTURE, device=cuda)
    plain = Network(fused.spec, *_lists(fused), device=cuda, fuse=False)
    x = torch.rand((2, 1, 40, 28), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    n0 = K.launches["bulge_main"]
    got = make_full_sr_fn(fused, bn_eval=bn_eval, lr_input=True)(x)
    want = make_full_sr_fn(plain, bn_eval=bn_eval, lr_input=True)(x)
    assert K.launches["bulge_main"] == n0 + 1
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", K.IMPLS)
def test_network_runs_the_implementation_it_was_given(cuda, impl):
    cfg = get_config("gray-3", env_override=False)
    fused, _ = load_generator(cfg, FIXTURE, device=cuda)
    named = Network(fused.spec, *_lists(fused), device=cuda, bulge_impl=impl)
    x = torch.rand((1, 1, 24, 40), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(3))
    i0 = dict(K.impl_launches)
    got = named(x, bn_stats="per_image")
    assert K.impl_launches[impl] == i0[impl] + 2
    for other in K.impl_launches:
        if other != impl:
            assert K.impl_launches[other] == i0[other]
    np.testing.assert_allclose(got.cpu(), fused(x, bn_stats="per_image").cpu(),
                               rtol=1e-4, atol=1e-4)


# ---- K2 at the overlap pipeline's shapes ------------------------------------

@pytest.mark.parametrize("impl", K.IMPLS)
@pytest.mark.parametrize("bsz,groups", [(225, None), (450, 2), (900, 4)])
def test_each_implementation_at_ci32_with_grouped_statistics(cuda, bsz, groups,
                                                             impl):
    t = _inputs(bsz, 32, 16, 32, 32, 32, cuda, seed=2)
    y, (m, v) = K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                        groups=groups, impl=impl)
    yp, (mp, vp) = K.bulge_plain(t["x"], t["wT"], t["scale"], t["bias"],
                                 t["wC"], groups=groups)
    torch.cuda.synchronize()
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


@pytest.mark.parametrize("impl", K.IMPLS)
def test_each_implementation_takes_more_images_than_a_grid_dimension(cuda,
                                                                     impl):
    """70,000 images; the wgmma kernel, built for Ci 16 and 32 only, at Ci
    16 and 16x8 (and it refuses Ci 8)."""
    t = _inputs(70000, 8, 4, 8, 16, 16, cuda, seed=3)
    run = (t["rmean"], t["rvar"])
    if impl == "wgmma":
        with pytest.raises(ValueError, match="wgmma bulge kernel takes"):
            K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                    stats="running", running=run, impl=impl)
        t = _inputs(70000, 16, 8, 16, 16, 8, cuda, seed=3)
        run = (t["rmean"], t["rvar"])
    y, _ = K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                   stats="running", running=run, impl=impl)
    yp, _ = K.bulge_plain(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                          stats="running", running=run)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


@pytest.mark.parametrize("bsz,groups", [(225, None), (450, 2), (900, 4)])
def test_kernel_at_ci32_with_grouped_statistics(cuda, bsz, groups):
    """Ci 32 / Cm 16 / Co 32 on 32x32 tiles, statistics pooled within each
    image's 225 tiles."""
    t = _inputs(bsz, 32, 16, 32, 32, 32, cuda, seed=2)
    y, (m, v) = K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                        groups=groups)
    yp, (mp, vp) = K.bulge_plain(t["x"], t["wT"], t["scale"], t["bias"],
                                 t["wC"], groups=groups)
    torch.cuda.synchronize()
    assert m.shape == ((groups, 16) if groups else (16,))
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)
    if groups:      # a group's result is the result of that group alone
        lo = bsz // groups
        y1, _ = K.bulge(t["x"][lo:2 * lo], t["wT"], t["scale"], t["bias"],
                        t["wC"])
        np.testing.assert_allclose(y[lo:2 * lo].cpu(), y1.cpu(), rtol=1e-5,
                                   atol=1e-5)


def test_kernel_takes_more_images_than_a_grid_dimension(cuda):
    """70,000 images of 16x16: more than a grid's z dimension takes.  The
    tensor-core kernel's persistent grid has no such limit; the FMA kernel's
    one call goes in two launches."""
    t = _inputs(70000, 8, 4, 8, 16, 16, cuda, seed=3)
    run = (t["rmean"], t["rvar"])
    y, _ = K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                   stats="running", running=run)
    yp, _ = K.bulge_plain(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                          stats="running", running=run)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


@pytest.mark.parametrize("bn_eval", [False, True])
def test_overlap_pipeline_fused_matches_unfused_on_card(cuda, bn_eval):
    from dcgan_sr_tpu_torch.infer.seam import seam_stitch
    from dcgan_sr_tpu_torch.infer.tiled import make_overlap_sr_fn
    cfg = get_config("gray-patch-batch-overlap", env_override=False)
    fused, _ = load_generator(cfg, PATCH_FIXTURE, device=cuda)
    plain = Network(fused.spec, *_lists(fused), device=cuda, fuse=False)
    imgs = torch.rand((3, 64, 64), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(0))
    n0 = dict(K.launches)
    got = make_overlap_sr_fn(cfg, fused, bn_eval=bn_eval)(imgs)
    assert K.launches["bulge_main"] == n0["bulge_main"] + 1
    assert K.launches["bulge_stats"] == n0["bulge_stats"] + (not bn_eval)
    want = make_overlap_sr_fn(cfg, plain, bn_eval=bn_eval)(imgs)
    np.testing.assert_allclose(got["tiles"].cpu(), want["tiles"].cpu(), **Y_TOL)
    np.testing.assert_allclose(got["naive"].cpu(), want["naive"].cpu(), **Y_TOL)
    for g, t in zip(got["seam"].cpu().numpy(), got["tiles"].cpu().numpy()):
        np.testing.assert_array_equal(g, seam_stitch(t, 64, 8, 4))


# ---- K2 in fp32 on wgmma (csrc/bulge_wgmma.cu namespace wgf) ----------------

def test_tf32_probe_pins_the_layout_and_the_truncation(cuda):
    """One wgmma m64n32k8 .tf32 product of raw fp32 words, A from registers
    as the kernels load it and B in to_wgmma_tf32's layout, two k-steps:
    the card's result equals the product of the operands truncated to TF32
    (a & 0xffffe000) to fp32 accuracy, and not the product of them rounded
    to nearest TF32 (1e-3 apart here) - so the core-matrix layout and the
    k-step offset are the kernels', and the tensor cores read an fp32 word
    as its truncation (the kernels store hi truncated all the same)."""
    from dcgan_sr_tpu_torch.ops import bulge_mma as M
    rng = np.random.RandomState(13)
    a = torch.tensor(rng.randn(64, 16), dtype=torch.float32)
    b = torch.tensor(rng.randn(16, 32), dtype=torch.float32)
    packed = torch.from_numpy(M.to_wgmma_tf32(b.numpy()).copy())
    n0, i0 = dict(K.launches), dict(K.impl_launches)
    d = K.tf32_probe(a.to(cuda), packed.to(cuda)).cpu().double()
    assert K.launches == n0 and K.impl_launches == i0

    def rounded(v):
        u = v.numpy().view(np.uint32).astype(np.int64)
        u = ((u + 0x1000) & ~0x1FFF) & 0xFFFFFFFF
        return torch.from_numpy(u.astype(np.uint32).view(np.float32)).double()
    trunc = M.trunc_tf32(a).double() @ M.trunc_tf32(b).double()
    near = rounded(a) @ rounded(b)
    assert (d - trunc).abs().max().item() < 1e-5
    assert (d - near).abs().max().item() > 1e-3


RAGGED_F32 = [(2, 16, 8, 16, 37, 44), (3, 16, 8, 16, 1, 4),
              (1, 32, 16, 32, 24, 40), (2, 32, 16, 32, 21, 36),
              (1, 32, 16, 32, 3, 8)]


@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", RAGGED_F32)
def test_fp32_wgmma_kernel_at_ragged_shapes(cuda, geom, stats):
    """bulge()'s own choice at ragged shapes the fp32 wgmma kernel takes
    (W % 4 == 0; bands and chunks cut by the image's edge, at both band
    heights) is the wgmma kernel, within the pair's tolerances of the plain
    version."""
    t = _inputs(*geom, cuda, seed=8)
    run = (t["rmean"], t["rvar"]) if stats == "running" else None
    i0 = dict(K.impl_launches)
    assert K.choose_impl(*geom[1:]) == "wgmma"
    y, (m, v) = K.bulge(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                        stats=stats, running=run)
    yp, (mp, vp) = K.bulge_plain(t["x"], t["wT"], t["scale"], t["bias"],
                                 t["wC"], stats=stats, running=run)
    torch.cuda.synchronize()
    assert K.impl_launches["wgmma"] == i0["wgmma"] + 1 + (stats != "running")
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


@pytest.mark.parametrize("geom", [(2, 16, 8, 16, 20, 72),
                                  (1, 32, 16, 32, 13, 40)])
def test_fp32_wgmma_matches_its_emulation(cuda, geom):
    """The stats launch slot by slot, and y, against ops/bulge_mma.py's
    emulation of the kernel's arithmetic (the same three TF32 products a
    k-step; only the order of fp32 sums inside a k-step differs)."""
    from dcgan_sr_tpu_torch.ops import bulge_mma as M
    t = _inputs(*geom, cuda, seed=5)
    got = K.launch_stats(t["x"], t["wT"].contiguous(), impl="wgmma")
    want = M.wgmma_f32_stats(t["x"].cpu(), t["wT"].cpu())
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-5, atol=1e-4)
    args = (t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    y, _ = K.bulge(*args, impl="wgmma")
    ye, _ = M.bulge_wgmma_f32(*(a.cpu() for a in args))
    np.testing.assert_allclose(y.cpu(), ye, rtol=1e-5, atol=1e-5)


# ---- K3: the channels-last fused pair ---------------------------------------

@pytest.mark.parametrize("geom,tm", [
    ((2, 5, 4, 6, 16, 16), 8), ((1, 16, 8, 16, 32, 32), 16),
    ((3, 3, 2, 3, 8, 8), 8), ((1, 4, 2, 4, 12, 37), 6),
    ((2, 32, 16, 32, 32, 32), 16), ((2, 16, 8, 16, 64, 100), 32)])
def test_nhwc_kernel_matches_plain(cuda, geom, tm):
    t = _inputs(*geom, cuda, seed=4)
    args = (t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    n0 = dict(F3.launches)
    fp32_moved = {k: c + (not k.endswith("_bf16")) for k, c in n0.items()}
    y, (m, v) = F3.fused_convT_bn_relu_conv(*args, tm=tm)
    assert F3.launches == fp32_moved
    yp, (mp, vp) = F3.fused_nhwc_plain(*args, tm=tm)
    yu, _ = K.bulge_plain(*args)
    torch.cuda.synchronize()
    assert F3.launches == fp32_moved
    assert y.shape == yp.shape and y.is_contiguous()
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)
    np.testing.assert_allclose(y.cpu(), yu.cpu(), **Y_TOL)


NHWC_GEOMS = [((1, 16, 8, 16, 32, 32), 16), ((1, 8, 4, 8, 12, 37), 6),
               ((2, 32, 16, 32, 32, 32), 16), ((2, 16, 8, 16, 64, 100), 32),
               ((3, 16, 8, 16, 6, 3), 6), ((2, 16, 8, 16, 24, 45), 12),
               ((2, 5, 4, 6, 16, 16), 8)]


@pytest.mark.parametrize("geom,tm,impl", [
    (g, tm, impl) for g, tm in NHWC_GEOMS for impl in F3.IMPLS
    if F3.built_for(impl, *g[1:4])])
def test_nhwc_each_implementation_matches_plain(cuda, geom, tm, impl):
    """The TMA and wgmma kernel ("wgmma") and the mma.sync kernel ("mma"),
    each at the triples it is built for, and the FMA kernel ("fma", every
    triple), each asked for by name, against the plain version; the counts
    move by implementation."""
    t = _inputs(*geom, cuda, seed=6)
    args = (t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    i0 = dict(F3.impl_launches)
    y, (m, v) = F3.fused_convT_bn_relu_conv(*args, tm=tm, impl=impl)
    yp, (mp, vp) = F3.fused_nhwc_plain(*args, tm=tm)
    torch.cuda.synchronize()
    assert F3.impl_launches == {**i0, impl: i0[impl] + 2}
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


def test_nhwc_default_implementation_is_the_static_rule(cuda):
    t = _inputs(1, 16, 8, 16, 16, 20, cuda)
    args = (t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    i0 = dict(F3.impl_launches)
    F3.fused_convT_bn_relu_conv(*args, tm=8)
    assert F3.choose_impl(16, 8, 16, 16, 20) == "wgmma"
    assert F3.impl_launches == {**i0, "wgmma": i0["wgmma"] + 2}
    t = _inputs(1, 8, 4, 8, 16, 20, cuda)
    F3.fused_convT_bn_relu_conv(t["x"], t["wT"], t["scale"], t["bias"],
                                t["wC"], tm=8)
    assert F3.impl_launches == {**i0, "wgmma": i0["wgmma"] + 2,
                                "mma": i0["mma"] + 2}


def test_nhwc_stats_slots_match_the_packed_version(cuda):
    """The tensor-core stats launch writes, slot by slot, what the packed
    plain version computes for the same work items."""
    t = _inputs(2, 16, 8, 16, 24, 70, cuda, seed=5)
    xn = t["x"].permute(0, 2, 3, 1).contiguous()
    w1, _ = F3.operands(t["wT"], t["wC"], "mma")
    got = F3.launch_stats(xn, w1, 8, 12, "mma")
    want = F3.M.packed_stats(xn.cpu(), w1.cpu(), 16, 8, 12)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("impl", F3.IMPLS)
def test_nhwc_each_implementation_takes_more_images_than_a_grid_dimension(
        cuda, impl):
    """70,000 images of 8x8: the persistent grid has no limit, the FMA
    kernel's call goes in two launches of its grid."""
    t = _inputs(70000, 16, 8, 16, 8, 8, cuda, seed=3)
    args = (t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    y, (m, v) = F3.fused_convT_bn_relu_conv(*args, tm=8, impl=impl)
    yp, (mp, vp) = F3.fused_nhwc_plain(*args, tm=8)
    torch.cuda.synchronize()
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


def test_nhwc_kernel_rejects_what_it_does_not_take(cuda):
    t = _inputs(1, 3, 2, 3, 8, 8, cuda)
    args = (t["x"], t["wT"], t["scale"], t["bias"], t["wC"])
    n0 = dict(F3.launches)
    with pytest.raises(ValueError, match="multiple of the band height"):
        F3.fused_convT_bn_relu_conv(*args, tm=3)
    with pytest.raises(ValueError, match="float32"):
        F3.fused_convT_bn_relu_conv(t["x"].double(), *args[1:], tm=8)
    with pytest.raises(ValueError, match="no instantiation"):
        F3.fused_convT_bn_relu_conv(*args, tm=8, impl="mma")
    assert F3.launches == n0


# ---- K2 in bf16 ---------------------------------------------------------------

def _hold_bf16(y, yp):
    y, yp = y.float().cpu(), yp.float().cpu()
    step = 2.0 ** (np.floor(np.log2(yp.abs().max().item())) - 7)
    d = (y - yp).abs()
    assert d.max().item() <= 2 * step
    assert (d > 0).float().mean().item() <= 0.01


@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", [(2, 16, 8, 16, 37, 45), (1, 8, 4, 8, 16, 20),
                                  (1, 32, 16, 32, 24, 40), (3, 16, 8, 16, 1, 3),
                                  (2, 16, 8, 16, 64, 96)])
def test_bf16_kernel_matches_plain(cuda, geom, stats):
    t = _inputs(*geom, cuda)
    x = t["x"].to(torch.bfloat16)
    run = (t["rmean"], t["rvar"]) if stats == "running" else None
    n0, i0 = dict(K.launches), dict(K.impl_launches)
    y, (m, v) = K.bulge(x, t["wT"], t["scale"], t["bias"], t["wC"],
                        stats=stats, running=run)
    yp, (mp, vp) = K.bulge_plain(x, t["wT"], t["scale"], t["bias"], t["wC"],
                                 stats=stats, running=run)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and m.dtype == torch.float32
    assert K.launches["bulge_main_bf16"] == n0["bulge_main_bf16"] + 1
    assert K.launches["bulge_stats_bf16"] == \
        n0["bulge_stats_bf16"] + (stats != "running")
    assert K.launches["bulge_main"] == n0["bulge_main"]
    chosen = K.choose_impl(*geom[1:], torch.bfloat16)
    assert chosen == ("wgmma" if geom[-1] % 8 == 0 and geom[1] > 8 else "mma")
    assert K.impl_launches[chosen + "_bf16"] == \
        i0[chosen + "_bf16"] + 1 + (stats != "running")
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    _hold_bf16(y, yp)


@pytest.mark.parametrize("impl", K.BF16_IMPLS)
@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", [(2, 16, 8, 16, 37, 40), (1, 32, 16, 32, 24, 40),
                                  (3, 16, 8, 16, 1, 8), (2, 32, 16, 32, 13, 24),
                                  (2, 16, 8, 16, 64, 96)])
def test_each_bf16_implementation_matches_plain(cuda, geom, stats, impl):
    """The wgmma kernel and the mma.sync kernel, each asked for by name, at
    ragged shapes both take (W % 8 == 0; rows and columns beyond the image
    in the last band and chunk), against the plain bf16 version; the launch
    counts move by implementation."""
    t = _inputs(*geom, cuda)
    x = t["x"].to(torch.bfloat16)
    run = (t["rmean"], t["rvar"]) if stats == "running" else None
    n0, i0 = dict(K.launches), dict(K.impl_launches)
    y, (m, v) = K.bulge(x, t["wT"], t["scale"], t["bias"], t["wC"],
                        stats=stats, running=run, impl=impl)
    yp, (mp, vp) = K.bulge_plain(x, t["wT"], t["scale"], t["bias"], t["wC"],
                                 stats=stats, running=run)
    torch.cuda.synchronize()
    moved = 1 + (stats != "running")
    assert K.launches["bulge_main_bf16"] == n0["bulge_main_bf16"] + 1
    assert K.impl_launches[impl + "_bf16"] == i0[impl + "_bf16"] + moved
    other = [i for i in K.BF16_IMPLS if i != impl][0] + "_bf16"
    assert K.impl_launches[other] == i0[other]
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    _hold_bf16(y, yp)


def test_wgmma_stats_slots_match_the_packed_version(cuda):
    from dcgan_sr_tpu_torch.ops import bulge_mma as M
    t = _inputs(2, 16, 8, 16, 20, 72, cuda, seed=5)
    x = t["x"].to(torch.bfloat16)
    got = K.launch_stats(x, t["wT"].contiguous(), impl="wgmma")
    want = M.packed_stats(x.cpu(), t["wT"].cpu())
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("bsz,groups", [(225, None), (450, 2)])
def test_bf16_kernel_at_ci32_with_grouped_statistics(cuda, bsz, groups):
    t = _inputs(bsz, 32, 16, 32, 32, 32, cuda, seed=2)
    x = t["x"].to(torch.bfloat16)
    y, (m, v) = K.bulge(x, t["wT"], t["scale"], t["bias"], t["wC"],
                        groups=groups)
    yp, (mp, vp) = K.bulge_plain(x, t["wT"], t["scale"], t["bias"], t["wC"],
                                 groups=groups)
    torch.cuda.synchronize()
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    _hold_bf16(y, yp)


def test_bf16_stats_slots_match_the_packed_version(cuda):
    from dcgan_sr_tpu_torch.ops import bulge_mma as M
    t = _inputs(2, 16, 8, 16, 20, 70, cuda, seed=5)
    x = t["x"].to(torch.bfloat16)
    got = K.launch_stats(x, t["wT"].contiguous())
    want = M.packed_stats(x.cpu(), t["wT"].cpu())
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-4, atol=1e-3)


def test_bf16_refuses_the_fma_kernel_and_unbuilt_triples(cuda):
    t = _inputs(1, 16, 8, 16, 8, 8, cuda)
    x = t["x"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32 only"):
        K.bulge(x, t["wT"], t["scale"], t["bias"], t["wC"], impl="fma")
    t = _inputs(1, 5, 4, 8, 8, 8, cuda)
    with pytest.raises(ValueError, match="no bf16 instantiation"):
        K.bulge(t["x"].to(torch.bfloat16), t["wT"], t["scale"], t["bias"],
                t["wC"])


@pytest.mark.parametrize("bn_eval", [False, True])
def test_bf16_fused_generator_runs_the_bf16_kernel(cuda, bn_eval):
    """The served gray-3 generator in bf16 takes layers 3-4 through the bf16
    kernel, and its output stays within 2 levels of 255 of the unfused bf16
    generator's on all but 5% of its pixels (chip_smoke.py TOL_U8_BF16)."""
    cfg = get_config("gray-3", env_override=False)
    fused, _ = load_generator(cfg, FIXTURE, device=cuda)
    plain = Network(fused.spec, *_lists(fused), device=cuda, fuse=False)
    x = torch.rand((2, 1, 40, 28), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    i0 = dict(K.impl_launches)
    got, want = (make_full_sr_fn(net, lr_input=True, bn_eval=bn_eval,
                                 compute_dtype=torch.bfloat16)(x)
                 for net in (fused, plain))
    torch.cuda.synchronize()
    assert K.impl_launches["wgmma_bf16"] > i0["wgmma_bf16"]
    assert K.impl_launches["mma"] == i0["mma"]
    d = (torch.round(got * 255) - torch.round(want * 255)).abs()
    assert got.dtype == torch.float32 and (d > 2).float().mean() <= 0.05


def test_first_request_after_warmup_is_warm(cuda):
    """--warmup builds the kernel and runs every square bucket before the
    first request: the first request then takes at most 3x the median of
    the ten after it."""
    import time

    from dcgan_sr_tpu_torch.serve import SRService
    cfg = get_config("gray-3", env_override=False)
    net, _ = load_generator(cfg, FIXTURE, device=cuda)
    svc = SRService(cfg, net, max_size=128, max_batch=4, window_ms=0,
                    compute_dtype=torch.bfloat16, u8_io=True)
    try:
        svc.warmup()
        img = np.random.RandomState(0).rand(64, 64).astype(np.float32)
        lat = []
        for _ in range(11):
            t0 = time.perf_counter()
            svc.submit(img)
            lat.append(time.perf_counter() - t0)
        assert lat[0] <= 3 * sorted(lat[1:])[5], lat
    finally:
        svc.close()


def _lists(net):
    """(params, state) lists back out of a Network, for a second copy."""
    params, state = [], []
    for layer in net.layers:
        p = {k: v.detach().cpu().numpy() for k, v in layer.named_parameters()}
        b = dict(layer.named_buffers())
        params.append(p)
        state.append({"bn": {"mean": b["bn_mean"].cpu().numpy(),
                             "var": b["bn_var"].cpu().numpy()}} if b else {})
    return params, state


# ---- K1: the fused preprocess ----------------------------------------------

@pytest.mark.parametrize("flags", [(False, False), (True, True), (False, True),
                                   (True, False)])
@pytest.mark.parametrize("shape", [(100, 3, 64, 64), (1280, 3, 8, 8),
                                   (3, 3, 50, 38), (1, 3, 2, 2),
                                   (2, 3, 514, 1030)])
def test_preprocess_kernel_equals_plain(cuda, shape, flags):
    gray, pm1 = flags
    x = torch.rand(shape, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    n0 = P.launches["preprocess"]
    hr, lr = P.preprocess(x, rgb_to_gray=gray, to_pm1=pm1)
    assert P.launches["preprocess"] == n0 + 1
    hp, lp = P.preprocess_plain(x, rgb_to_gray=gray, to_pm1=pm1)
    assert P.launches["preprocess"] == n0 + 1
    torch.cuda.synchronize()
    assert hr.shape == hp.shape and lr.shape == lp.shape
    assert torch.equal(hr, hp) and torch.equal(lr, lp)


def test_preprocess_kernel_single_channel_and_views(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand((100, 1, 64, 64), device=cuda, generator=gen)
    hr, lr = P.preprocess(x)
    assert torch.equal(hr, x) and hr.data_ptr() != x.data_ptr()
    assert torch.equal(lr, P.preprocess_plain(x)[1])
    # a non-contiguous view and a contiguous tensor at an odd element offset
    wide = torch.rand((4, 1, 16, 40), device=cuda, generator=gen)
    view = wide[..., 3:35]
    assert torch.equal(P.preprocess(view, to_pm1=True)[1],
                       P.preprocess_plain(view, to_pm1=True)[1])
    odd = torch.rand(1 + 2 * 8 * 8, device=cuda, generator=gen)[1:].view(2, 1, 8, 8)
    assert odd.data_ptr() % 8 == 4
    assert torch.equal(P.preprocess(odd)[1], P.preprocess_plain(odd)[1])


@pytest.mark.parametrize("shape,flags", [((100, 1, 64, 64), (False, False)),
                                         ((100, 3, 64, 64), (True, True)),
                                         ((3, 3, 50, 38), (False, True))])
def test_preprocess_under_graph_capture_equals_eager(cuda, shape, flags):
    """A call captured into a CUDA graph and replayed gives the eager call's
    bits, also after the input changed in place; the launch count moves once
    per captured call, at capture, and not on replay."""
    gray, pm1 = flags
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.rand(shape, device=cuda, generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        P.preprocess(x, rgb_to_gray=gray, to_pm1=pm1)
    torch.cuda.current_stream().wait_stream(side)
    n0 = P.launches["preprocess"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [P.preprocess(x, rgb_to_gray=gray, to_pm1=pm1)
                for _ in range(3)]
    assert P.launches["preprocess"] == n0 + 3
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert P.launches["preprocess"] == n0 + 3
        hr, lr = P.preprocess(x, rgb_to_gray=gray, to_pm1=pm1)
        hp, lp = P.preprocess_plain(x, rgb_to_gray=gray, to_pm1=pm1)
        for o in outs:
            assert torch.equal(o[0], hr) and torch.equal(o[1], lr)
            assert torch.equal(o[0], hp) and torch.equal(o[1], lp)
        n0 += 1                                   # the eager call above
        x.copy_(torch.rand(shape, device=cuda, generator=gen))


def test_preprocess_outputs_keep_their_contract(cuda):
    x = torch.rand((100, 3, 64, 64), device=cuda, requires_grad=True)
    hr, lr = P.preprocess(x, rgb_to_gray=True)
    assert hr.shape == (100, 1, 64, 64) and lr.shape == (100, 1, 32, 32)
    assert hr.is_contiguous() and lr.is_contiguous()
    assert not hr.requires_grad and not lr.requires_grad
    assert hr.data_ptr() % 8 == 0 and lr.data_ptr() % 8 == 0
    assert hr.device == lr.device == x.device


def test_preprocess_kernel_rejects_what_it_does_not_take(cuda):
    n0 = P.launches["preprocess"]
    with pytest.raises(ValueError, match="even"):
        P.preprocess(torch.zeros((1, 1, 7, 8), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        P.preprocess(torch.zeros((1, 1, 8, 8), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="3 channels"):
        P.preprocess(torch.zeros((1, 1, 8, 8), device=cuda), rgb_to_gray=True)
    assert P.launches["preprocess"] == n0


# ---- TF32 stays off in the backward convolutions ---------------------------

@pytest.mark.parametrize("transposed", [False, True])
def test_conv_gradients_are_full_fp32(cuda, transposed):
    """Gradients of the port's conv ops, taken OUTSIDE any fp32_convs()
    block with cuDNN's TF32 switched on, agree with float64 to fp32
    accuracy (TF32 would leave about 1e-3)."""
    rng = np.random.RandomState(0)
    x64 = torch.tensor(rng.randn(8, 16, 32, 32), device=cuda)
    w64 = torch.tensor(rng.randn(16, 16, 4, 4) * 0.1, device=cuda)
    g64 = torch.tensor(rng.randn(8, 16, 64, 64) if transposed
                       else rng.randn(8, 16, 16, 16), device=cuda)
    op = N.conv_transpose2d if transposed else N.conv2d

    def grads(dtype):
        x = x64.to(dtype).requires_grad_(True)
        w = w64.to(dtype).requires_grad_(True)
        y = op(x, w, 2, 1)
        return (y.detach(),) + torch.autograd.grad(y, (x, w), g64.to(dtype))

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got, want = grads(torch.float32), grads(torch.float64)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.backends.cudnn.allow_tf32 == prev
    for name, g, w in zip(("y", "dx", "dw"), got, want):
        err = ((g.double() - w).abs().max() / w.abs().max()).item()
        assert err < 2e-6, f"{name}: relative error {err:.2e}"


@pytest.mark.parametrize("transposed,k,s,p", [(False, 4, 2, 1),
                                              (True, 4, 2, 1),
                                              (False, 3, 1, 0)])
def test_bf16_weight_gradients_keep_the_jax_precision(cuda, transposed, k, s,
                                                      p):
    """bf16 convolutions on the card against the same op on the CPU
    (upcast operands, fp32 sums; tests/test_torch_bf16_nn.py holds that to
    the JAX package): a k4s2p1 dw stays fp32 (JAX's _dw_conv) and agrees to
    fp32 summation order; any other dw is bf16-valued, as autodiff of the
    bf16 conv gives it."""
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(4, 16, 16, 16), dtype=torch.float32)
    w = torch.tensor(rng.randn(*((16, 8) if transposed else (8, 16)), k, k)
                     * 0.1, dtype=torch.float32)
    op = N.conv_transpose2d if transposed else N.conv2d
    n_out = op(x, w, s, p, compute_dtype=torch.bfloat16).shape
    g = torch.tensor(rng.randn(*n_out), dtype=torch.float32).to(torch.bfloat16)

    def dw(device):
        wd = w.to(device).requires_grad_(True)
        y = op(x.to(device), wd, s, p, compute_dtype=torch.bfloat16)
        (got,) = torch.autograd.grad(y, wd, g.to(device))
        return got.cpu()

    got, want = dw(cuda), dw("cpu")
    assert got.dtype == torch.float32
    rounded = (got == got.to(torch.bfloat16).float()).float().mean().item()
    if (k, s, p) == (4, 2, 1):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * want.abs().max().item())
        assert rounded < 0.5, rounded
    else:
        assert rounded == 1.0, rounded


# ---- one tiny step, kernel against plain ------------------------------------

@pytest.mark.parametrize("variant,chans,over", [
    ("gray-3", 1, {}), ("gray", 3, {"device_preprocess": True})])
def test_step_with_kernel_equals_step_with_plain(cuda, variant, chans, over):
    cfg = get_config(variant, env_override=False, ngf=4, ndf=8, **over)
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device=cuda)
    twin = state_from_numpy(cfg, state_to_numpy(st), device=cuda)
    hr = torch.rand((8, chans, 64, 64), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    n0 = P.launches["preprocess"]
    _, m = build_train_step(cfg)(st, hr)
    assert P.launches["preprocess"] == n0 + 1
    _, mp = build_train_step(cfg, preprocess_fn=P.preprocess_plain)(twin, hr)
    assert P.launches["preprocess"] == n0 + 1
    for k in m:
        assert torch.isfinite(m[k]).all()
        np.testing.assert_allclose(m[k].item(), mp[k].item(), rtol=1e-5)
    a, b = state_to_numpy(st), state_to_numpy(twin)
    for f in ("g_params", "d_params", "g_state", "d_state"):
        for la, lb in zip(a[f], b[f]):
            for key in la:
                va, vb = la[key], lb[key]
                if isinstance(va, dict):
                    va, vb = va["mean"], vb["mean"]
                assert np.abs(va - vb).max() <= 2.1 * cfg.lr


# ---- the eval protocol and the device-side crop -----------------------------

@pytest.mark.parametrize("shape", [(3, 16, 16), (100, 64, 64), (2, 31, 47)])
def test_ssim_on_the_card_equals_the_cpu_path(cuda, shape):
    """SSIM's sigmas are E[x^2] - mu^2 at the 0-255 scale: the convolution
    runs with TF32 off, so the card's SSIM is the CPU's to 1e-5, with
    cudnn.allow_tf32 on around the call."""
    from dcgan_sr_tpu_torch.metrics import cal_psnr_batch, cal_ssim_batch

    rng = np.random.RandomState(shape[0])
    a = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    b = torch.from_numpy(np.clip(a.numpy() + 0.1 * rng.randn(*shape), 0, 1
                                 ).astype(np.float32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = cal_ssim_batch(a.to(cuda), b.to(cuda)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    np.testing.assert_allclose(got.numpy(), cal_ssim_batch(a, b).numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(cal_psnr_batch(a.to(cuda), b.to(cuda)).cpu(),
                               cal_psnr_batch(a, b), rtol=1e-6)


def test_crop_hflip_at_on_the_card_is_bit_equal(cuda):
    from dcgan_sr_tpu_torch.image.ops import crop_hflip_at

    rng = np.random.RandomState(1)
    canvas = torch.from_numpy(rng.rand(100, 3, 96, 96).astype(np.float32))
    tops = rng.randint(0, 33, 100)
    lefts = rng.randint(0, 33, 100)
    flips = rng.rand(100) > 0.5
    want = crop_hflip_at(canvas, tops, lefts, flips, 64)
    got = crop_hflip_at(canvas.to(cuda), tops, lefts, flips, 64)
    on_card = crop_hflip_at(canvas.to(cuda), torch.from_numpy(tops).to(cuda),
                            torch.from_numpy(lefts).to(cuda),
                            torch.from_numpy(flips).to(cuda), 64)
    assert torch.equal(got.cpu(), want) and torch.equal(on_card.cpu(), want)


def test_device_augment_step_launches_k1_on_the_crop(cuda):
    cfg = get_config("gray", env_override=False, ngf=4, ndf=8, batchSize=4,
                     device_augment=True, device_preprocess=True)
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device=cuda)
    rng = np.random.RandomState(2)
    batch = (torch.from_numpy(rng.rand(4, 3, 96, 96).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 33, 4)),
             torch.from_numpy(rng.randint(0, 33, 4)),
             torch.from_numpy(rng.rand(4) > 0.5))
    n0 = P.launches["preprocess"]
    _, m = build_train_step(cfg)(st, tuple(a.to(cuda) for a in batch))
    assert P.launches["preprocess"] == n0 + 1
    assert np.isfinite(float(m["errG"])) and np.isfinite(float(m["errD"]))


def test_eval_on_the_card_equals_the_cpu_and_launches_k2(cuda):
    from dcgan_sr_tpu_torch.data.synthetic import TexturedImages
    from dcgan_sr_tpu_torch.evaluation import evaluate_slice

    cfg = get_config("gray-3", env_override=False)
    src = TexturedImages(64, nc=1, seed=1234)
    card, _ = load_generator(cfg, FIXTURE, device=cuda)
    cpu, _ = load_generator(cfg, FIXTURE, device="cpu")
    n0 = K.launches["bulge_main"]
    got = evaluate_slice(cfg, card, src, [2001], batch_size=20)
    assert K.launches["bulge_main"] == n0 + 1
    want = evaluate_slice(cfg, cpu, src, [2001], batch_size=20)
    assert got.n_images == want.n_images == 20
    for f in ("psnr_bilinear", "psnr_generator"):
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-3, f
    for f in ("ssim_bilinear", "ssim_generator"):
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-4, f


# ---- the channels-last pair in bf16 ------------------------------------------

@pytest.mark.parametrize("geom,tm", [
    ((2, 16, 8, 16, 64, 100), 32), ((1, 8, 4, 8, 12, 37), 6),
    ((2, 32, 16, 32, 32, 33), 16), ((3, 16, 8, 16, 6, 3), 6),
    ((1, 16, 8, 16, 32, 40), 16)])
def test_nhwc_bf16_kernel_matches_plain(cuda, geom, tm):
    t = _inputs(*geom, cuda, seed=7)
    args = (t["x"].to(torch.bfloat16), t["wT"], t["scale"], t["bias"],
            t["wC"])
    n0, i0 = dict(F3.launches), dict(F3.impl_launches)
    y, (m, v) = F3.fused_convT_bn_relu_conv(*args, tm=tm)
    yp, (mp, vp) = F3.fused_nhwc_plain(*args, tm=tm)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and m.dtype == torch.float32
    assert y.shape == yp.shape and y.is_contiguous()
    assert F3.launches == {k: c + k.endswith("_bf16") for k, c in n0.items()}
    ran = ("wgmma" if geom[1:4] in F3.WG.TRIPLES else "mma") + "_bf16"
    assert F3.impl_launches == {**i0, ran: i0[ran] + 2}
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    _hold_bf16(y, yp)


def test_nhwc_bf16_launches_match_the_packed_version(cuda):
    """The bf16 stats launch writes, slot by slot, and the main launch,
    pixel by pixel, what the packed plain version computes from the same
    bf16 operands for the same work items."""
    t = _inputs(2, 16, 8, 16, 24, 70, cuda, seed=5)
    xn = t["x"].permute(0, 2, 3, 1).contiguous().to(torch.bfloat16)
    w1, w2 = F3.operands(t["wT"], t["wC"], "mma", torch.bfloat16)
    got = F3.launch_stats(xn, w1, 8, 12, "mma")
    want = F3.M.packed_stats(xn.cpu(), w1.cpu(), 16, 8, 12)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-4, atol=1e-3)
    mean, var = F3._moments(got, 4.0 * 24 * 70 * 2)
    bn = F3._bn_rows(mean, var, t["scale"], t["bias"], 1e-5)
    y = F3.launch_main(xn, w1, w2, bn, 8, 16, 12, "mma")
    yw = F3.M.packed_main(xn.cpu(), w1.cpu(), w2.cpu(), bn.cpu(), 16, 8, 16,
                          12)
    assert y.dtype == torch.bfloat16 and y.shape == yw.shape
    _hold_bf16(y, yw)


# ---- K3 on Hopper's units (csrc/fused_nhwc_wgmma.cu) --------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("geom,tm", [
    ((2, 16, 8, 16, 64, 100), 32), ((1, 32, 16, 32, 24, 37), 12),
    ((2, 32, 16, 32, 32, 33), 16), ((3, 16, 8, 16, 6, 3), 6),
    ((1, 16, 8, 16, 9, 37), 9), ((2, 16, 8, 16, 24, 45), 12)])
def test_nhwc_wgmma_matches_plain(cuda, geom, tm, dtype):
    """The wgmma kernel in either dtype against the plain version: ragged W
    (100, 37, 33, 3, 45), a last band of one row (H 9), both triples."""
    t = _inputs(*geom, cuda, seed=8)
    args = (t["x"].to(dtype), t["wT"], t["scale"], t["bias"], t["wC"])
    n0, i0 = dict(F3.launches), dict(F3.impl_launches)
    y, (m, v) = F3.fused_convT_bn_relu_conv(*args, tm=tm, impl="wgmma")
    yp, (mp, vp) = F3.fused_nhwc_plain(*args, tm=tm)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    ran = "wgmma_bf16" if bf16 else "wgmma"
    assert F3.impl_launches == {**i0, ran: i0[ran] + 2}
    assert F3.launches == {k: c + (k.endswith("_bf16") == bf16)
                           for k, c in n0.items()}
    assert y.dtype == dtype and y.shape == yp.shape and y.is_contiguous()
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    if bf16:
        _hold_bf16(y, yp)
    else:
        np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_nhwc_wgmma_launches_match_the_emulation(cuda, dtype):
    """The wgmma stats launch writes, slot by slot, and the main launch,
    pixel by pixel, what ops/fused_nhwc_wgmma.py's emulation computes from
    the same operands for the same work items."""
    t = _inputs(2, 32 if dtype == torch.float32 else 16,
                16 if dtype == torch.float32 else 8,
                32 if dtype == torch.float32 else 16, 17, 45, cuda, seed=5)
    ci, cm, co = t["wT"].shape[0], t["wT"].shape[1], t["wC"].shape[0]
    xn = t["x"].permute(0, 2, 3, 1).contiguous().to(dtype)
    w1, w2 = F3.operands(t["wT"], t["wC"], "wgmma", dtype)
    got = F3.launch_stats(xn, w1, cm, 17, "wgmma")
    want = F3.WG.emulate_stats(xn.cpu(), w1.cpu(), ci, cm)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-4, atol=1e-3)
    mean, var = F3._moments(got, 4.0 * 17 * 45 * 2)
    bn = F3._bn_rows(mean, var, t["scale"], t["bias"], 1e-5)
    y = F3.launch_main(xn, w1, w2, bn, cm, co, 17, "wgmma")
    yw = F3.WG.emulate_main(xn.cpu(), w1.cpu(), w2.cpu(), bn.cpu(), ci, cm,
                            co)
    assert y.dtype == dtype and y.shape == yw.shape
    if dtype == torch.bfloat16:
        _hold_bf16(y, yw)
    else:
        np.testing.assert_allclose(y.cpu(), yw, **Y_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_nhwc_wgmma_takes_more_images_than_a_grid_dimension(cuda, dtype):
    t = _inputs(70000, 16, 8, 16, 8, 8, cuda, seed=3)
    args = (t["x"].to(dtype), t["wT"], t["scale"], t["bias"], t["wC"])
    y, (m, v) = F3.fused_convT_bn_relu_conv(*args, tm=8, impl="wgmma")
    yp, (mp, vp) = F3.fused_nhwc_plain(*args, tm=8)
    torch.cuda.synchronize()
    np.testing.assert_allclose(m.cpu(), mp.cpu(), **STATS_TOL)
    np.testing.assert_allclose(v.cpu(), vp.cpu(), **STATS_TOL)
    if dtype == torch.bfloat16:
        _hold_bf16(y, yp)
    else:
        np.testing.assert_allclose(y.cpu(), yp.cpu(), **Y_TOL)


def test_nhwc_wgmma_refuses_what_it_was_not_built_for(cuda):
    t = _inputs(1, 8, 4, 8, 8, 8, cuda)
    n0 = dict(F3.launches)
    with pytest.raises(ValueError, match="wgmma NHWC kernel has no"):
        F3.fused_convT_bn_relu_conv(t["x"], t["wT"], t["scale"], t["bias"],
                                    t["wC"], tm=8, impl="wgmma")
    assert F3.launches == n0


def test_nhwc_bf16_refuses_the_fma_kernel_and_unbuilt_triples(cuda):
    t = _inputs(1, 16, 8, 16, 8, 8, cuda)
    x = t["x"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32 only"):
        F3.fused_convT_bn_relu_conv(x, t["wT"], t["scale"], t["bias"],
                                    t["wC"], tm=8, impl="fma")
    t = _inputs(1, 5, 4, 6, 8, 8, cuda)
    with pytest.raises(ValueError, match="no bf16 instantiation"):
        F3.fused_convT_bn_relu_conv(t["x"].to(torch.bfloat16), t["wT"],
                                    t["scale"], t["bias"], t["wC"], tm=8)


# ---- the trainer's K-step chunk as one CUDA graph -----------------------------

GRAPH_KW = dict(env_override=False, ngf=4, ndf=8, batchSize=8)


@pytest.fixture
def deterministic(monkeypatch):
    """cuDNN's deterministic algorithms for the test: its default backward
    may sum with atomics, and a GAN's steps amplify a last-bit difference
    into one that the spread of two runs would have to cover; a run that
    repeats exactly holds the graph and the staged feed to the yardstick
    bit for bit."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)


def _chunks(cfg, cuda, n=3, k=3):
    """n chunks of k batches on the card: (K, B, C, 64, 64), or under
    device_augment (canvas, tops, lefts, flips) leaves."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    rng = np.random.RandomState(2)
    out = []
    for _ in range(n):
        if cfg.device_augment:
            out.append((
                torch.rand((k, 8, 3, 80, 80), device=cuda, generator=gen),
                torch.from_numpy(rng.randint(0, 17, (k, 8))).to(cuda),
                torch.from_numpy(rng.randint(0, 17, (k, 8))).to(cuda),
                torch.from_numpy(rng.rand(k, 8) > 0.5).to(cuda)))
        else:
            out.append(torch.rand((k, 8, cfg.nc, 64, 64), device=cuda,
                                  generator=gen))
    return out


@pytest.mark.parametrize("variant,over", [
    ("gray-3", {}), ("gray-3", {"compute_dtype": "bfloat16"}),
    ("rgb-full", {}), ("gray", {"device_augment": True,
                                "device_preprocess": True}),
    ("gray-3", {"fast_ops": True}),
    ("gray-3", {"fast_ops": True, "compact_params": True,
                "compute_dtype": "bfloat16"})])
def test_captured_chunks_equal_eager_chunks(cuda, deterministic, variant,
                                           over):
    """Three chunks of three steps: the runner's warm-up chunk and two
    replays against the eager loop on twin states."""
    cfg = get_config(variant, **GRAPH_KW, **over)
    base = state_to_numpy(init_train_state(
        cfg, torch.Generator().manual_seed(0), device=cuda))
    chunks = _chunks(cfg, cuda)
    runs = []
    for graph in (True, False, False):
        st = state_from_numpy(cfg, base, device=cuda)
        run = build_multi_step(cfg)
        fn = run if graph else run.eager
        runs.append((st, run, [fn(st, c)[1] for c in chunks]))
    (sg, rg, mg), (_, _, me1), (_, _, me2) = runs
    assert (rg.captures, rg.replays) == (1, 2)
    assert rg.captured["preprocess"] == 3 and rg.replayed["preprocess"] == 6
    assert int(sg.g_opt["t"]) == int(sg.d_opt["t"]) == 9
    for key in mg[0]:
        g, e1, e2 = (torch.cat([m[key] for m in ms]).cpu()
                     for ms in (mg, me1, me2))
        spread = (e1 - e2).abs().max().item()
        diff = (g - e1).abs().max().item()
        floor = 1e-6 * (1 + e1.abs().max().item())
        assert torch.isfinite(g).all()
        assert diff <= 2 * spread + floor, (key, diff, spread)


def test_compact_graph_chunks_are_the_standard_ones_bit_for_bit(
        cuda, deterministic):
    """--compact-params on the card: the same three chunks (a warm-up and
    two replays) from one init, compact against standard; after
    unpack_state every leaf is equal, and the masters kept their storage."""
    from dcgan_sr_tpu_torch.models import discriminator_spec, generator_spec
    from dcgan_sr_tpu_torch.ops.compact import unpack_state
    from dcgan_sr_tpu_torch.train.step import params_of

    out = []
    for compact in (False, True):
        cfg = get_config("gray-3", **GRAPH_KW, compact_params=compact)
        st = init_train_state(cfg, torch.Generator().manual_seed(0),
                              device=cuda)
        ptrs = [p.data_ptr() for p in params_of(st.g) + params_of(st.d)]
        run = build_multi_step(cfg)
        for c in _chunks(cfg, cuda):
            run(st, c)
        assert (run.captures, run.replays) == (1, 2)
        assert [p.data_ptr() for p in params_of(st.g) + params_of(st.d)] \
            == ptrs
        if compact:
            st = unpack_state(st, generator_spec(cfg), discriminator_spec(cfg))
        out.append(dict(_leaves(state_to_numpy(st))))
    assert sorted(out[0]) == sorted(out[1])
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)


def test_each_replay_advances_the_step_count_on_the_card(cuda):
    cfg = get_config("gray-3", **GRAPH_KW)
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device=cuda)
    run = build_multi_step(cfg)
    (hr,) = _chunks(cfg, cuda, n=1, k=4)
    run(st, hr)                          # the warm-up chunk, then the capture
    assert int(st.g_opt["t"]) == 4 and (run.captures, run.replays) == (1, 0)
    assert st.g_opt["t"].device.type == "cuda"
    for r in (1, 2):
        _, m = run(st, hr)
        assert int(st.g_opt["t"]) == int(st.d_opt["t"]) == 4 * (r + 1)
        assert tuple(m["errG"].shape) == (4,)
    other = init_train_state(cfg, torch.Generator().manual_seed(1),
                             device=cuda)
    with pytest.raises(ValueError, match="another TrainState"):
        run(other, hr)


def test_captured_stage_spans_time_each_replay(cuda):
    """The step's stage spans are event nodes of the captured graph
    (utils/profiling.py capture_stages): one boundary event a stage plus
    the capture's start, no profiler running, and after each replay
    span_totals() reads that replay's stages, which sum to the replay's own
    device time within 2% (what lies outside them: the last step's
    metrics and the stacked output)."""
    from dcgan_sr_tpu_torch.utils import profiling as prof

    cfg = get_config("gray-3", **GRAPH_KW)
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device=cuda)
    prof.reset_spans()
    run = build_multi_step(cfg)
    (hr,) = _chunks(cfg, cuda, n=1, k=3)
    run(st, hr)
    assert prof.span_totals() == {}            # captured, never replayed
    assert len(prof._store.graphs[-1].events) == 1 + 7 * 3
    g = next(iter(run._graphs.values()))
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(2):
        a.record()
        g.graph.replay()
        b.record()
        b.synchronize()
        tot = prof.span_totals()
        assert {n: t["count"] for n, t in tot.items()} == {
            n: 3 for n in ("train.preprocess", "train.g_forward",
                           "train.d_real", "train.d_fake_forward",
                           "train.d_fake_pullbacks", "train.g_backward",
                           "train.adam")}
        stages = sum(t["device_s"] for t in tot.values()) * 1e3
        assert 0.98 * a.elapsed_time(b) <= stages <= a.elapsed_time(b)
    prof.reset_spans()


def test_a_capture_that_fails_raises(cuda):
    """A step that reads a value back to the host trains eagerly (the warm-up
    chunk) and cannot be captured: the runner raises instead of falling back
    to the eager loop.  In a process of its own, since a failed capture may
    leave the CUDA context unusable for captures."""
    code = textwrap.dedent("""
        import torch
        from dcgan_sr_tpu_torch.core import get_config
        from dcgan_sr_tpu_torch.ops import preprocess as P
        from dcgan_sr_tpu_torch.train.multi_step import build_multi_step
        from dcgan_sr_tpu_torch.train.step import init_train_state

        def reads_back(x, **kw):
            float(x.sum())
            return P.preprocess(x, **kw)

        cfg = get_config("gray-3", env_override=False, ngf=4, ndf=8,
                         batchSize=4)
        st = init_train_state(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
        run = build_multi_step(cfg, preprocess_fn=reads_back)
        try:
            run(st, torch.rand((2, 4, 1, 64, 64), device="cuda"))
        except RuntimeError as e:
            print("RAISED" if "does not fall back" in str(e) else repr(e))
        else:
            print("NO ERROR")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(FIXTURE)))
    assert "RAISED" in r.stdout.splitlines(), r.stdout + r.stderr[-3000:]


def _leaves(tree, path=""):
    """(path, array) of every leaf of a state_to_numpy tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, np.asarray(tree)


SLEEP_CYCLES = 20_000_000       # about 10 ms of a stream's time on an H100


@pytest.mark.parametrize("slow", [None, "copy", "compute"])
def test_stage_ahead_on_the_card_trains_the_same_batches(cuda, deterministic,
                                                         monkeypatch, slow):
    """The staged feed (pinned memory, a copy stream, two device buffers a
    chunk shape) with the graph runner, against the plain loop: four
    3-step chunks and a 1-step remainder of distinct batches, the host
    queuing ahead (one fetch, at the epoch's end).  The same builds in the
    same order; every chunk's per-step losses and every leaf of the final
    state within twice the spread of two plain runs and 1e-6 relative.
    `slow` holds back, by about 10 ms a chunk, either the staged copies (a
    chunk that did not wait for its buffer's copy would read the buffer's
    older contents) or the compute stream before each chunk (a copy that
    did not wait for the chunk that last read its buffer would overwrite
    what that chunk is about to read)."""
    cfg = get_config("gray-3", **GRAPH_KW)
    rng = np.random.RandomState(3)
    batches = rng.rand(13, 8, 1, 64, 64).astype(np.float32)
    base = state_to_numpy(init_train_state(
        cfg, torch.Generator().manual_seed(0), device=cuda))
    if slow == "copy":
        put = loop._StagedFeed.put

        def slow_put(self, leaves):
            with torch.cuda.stream(self.stream):
                torch.cuda._sleep(SLEEP_CYCLES)
            return put(self, leaves)

        monkeypatch.setattr(loop._StagedFeed, "put", slow_put)
    runs = []
    for stage_ahead in (False, False, True):
        calls, chunks = [], []
        run = build_multi_step(cfg)

        def multi(st, hr, run=run, chunks=chunks):
            if slow == "compute":
                torch.cuda._sleep(SLEEP_CYCLES)
            st, m = run(st, hr)
            chunks.append(m)
            return st, m

        def batch_fn(e, i, calls=calls):
            calls.append((e, i))
            return batches[i]

        st = state_from_numpy(cfg, base, device=cuda)
        st, m = train_epochs(cfg, st, batch_fn, niter=1, steps_per_epoch=13,
                             log_fn=lambda line: None, log_every=100,
                             scan_steps=3, multi_step_fn=multi,
                             stage_ahead=stage_ahead)
        assert calls == [(1, i) for i in range(13)]
        assert (run.captures, run.replays) == (1, 3)
        assert int(st.g_opt["t"]) == int(st.d_opt["t"]) == 13
        losses = torch.stack([torch.cat([c[k] for c in chunks])
                              for k in sorted(chunks[0])]).cpu().numpy()
        runs.append([("losses", losses), *_leaves(state_to_numpy(st))])
    for (path, p1), (_, p2), (_, staged) in zip(*runs):
        assert np.isfinite(staged).all(), path
        if staged.dtype.kind != "f":
            np.testing.assert_array_equal(staged, p1, err_msg=path)
            continue
        spread = np.abs(p1 - p2).max()
        floor = 1e-6 * (1 + np.abs(p1).max())
        assert np.abs(staged - p1).max() <= 2 * spread + floor, (path, spread)

