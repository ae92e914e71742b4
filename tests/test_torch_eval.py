"""The port's eval harness (dcgan_sr_tpu_torch.evaluation) against the JAX
package's on the CPU: the same weights (copied from the JAX init, or the
committed gray-3 fixture), the same procedural images, small width (ngf 4)
and batch 8 over two file_sets.

Tolerances: slice-mean PSNR 1e-3 dB, SSIM 1e-4, n_images equal.  The
generators agree to 1e-5 (tests/test_torch_network.py); the metrics' sums
run in another order."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.data.synthetic import SyntheticImages as JSynthetic
from dcgan_sr_tpu.data.synthetic import TexturedImages as JTextured
from dcgan_sr_tpu.evaluation import harness as JH
from dcgan_sr_tpu.image.ops import resize_bilinear as j_resize_bilinear
from dcgan_sr_tpu.train import init_train_state
from dcgan_sr_tpu.train.checkpoint import load_branch as j_load_branch
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.data.synthetic import SyntheticImages, TexturedImages
from dcgan_sr_tpu_torch.evaluation import (EvalResult, OverlapEvalResult,
                                           evaluate_overlap_slice,
                                           evaluate_slice, inference_generator,
                                           polarity_rescue)
from dcgan_sr_tpu_torch.image.ops import resize_bilinear
from dcgan_sr_tpu_torch.models import Network, generator_spec
from dcgan_sr_tpu_torch.ops import bulge
from dcgan_sr_tpu_torch.train.checkpoint import load_generator
from dcgan_sr_tpu_torch.train.step import init_train_state as t_init_state

import torch_threads  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures")
KW = dict(env_override=False, ngf=4, ndf=8)
PSNR_TOL, SSIM_TOL = 1e-3, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(variant, seed=0):
    """(jax cfg, params, state, port cfg, port Network) from one JAX init."""
    jcfg, cfg = j_get_config(variant, **KW), get_config(variant, **KW)
    st = init_train_state(jcfg, jax.random.PRNGKey(seed))
    net = Network(generator_spec(cfg), _np(st.g_params), _np(st.g_state),
                  device="cpu")
    return jcfg, st.g_params, st.g_state, cfg, net


def _close(got, want, fields):
    for f in fields:
        tol = PSNR_TOL if f.startswith("psnr") else SSIM_TOL
        assert abs(getattr(got, f) - getattr(want, f)) <= tol, (
            f, getattr(got, f), getattr(want, f))
    assert got.n_images == want.n_images


@pytest.mark.parametrize("variant,nc", [
    ("gray-3", 1),              # fused pair (its plain version here), 01
    ("gray", 1),                # no BN, pm1
    ("rgb-full", 3),            # three channels, pm1
    ("gray-patch-batch", 1),    # 8x8 tiles, grid reassembly
])
def test_evaluate_slice_matches_jax(variant, nc):
    jcfg, params, state, cfg, net = _pair(variant)
    assert (cfg.variant != "gray-3") or net.pairs      # K2 on the eval path
    want = JH.evaluate_slice(jcfg, None, params, state,
                             JSynthetic(64, nc=nc, seed=5), [0, 1],
                             batch_size=8)
    got = evaluate_slice(cfg, net, SyntheticImages(64, nc=nc, seed=5), [0, 1],
                         batch_size=8)
    assert isinstance(got, EvalResult) and got.n_images == 16
    _close(got, want, ("psnr_bilinear", "psnr_generator", "ssim_bilinear",
                       "ssim_generator"))


def test_evaluate_slice_gray3_fixture_matches_jax():
    """The committed gray-3 fixture at full width: parity only (the JAX
    package makes no quality claim for it)."""
    path = os.path.join(FIXTURES, "gray3_textured_net_G.npz")
    jcfg = j_get_config("gray-3", env_override=False)
    cfg = get_config("gray-3", env_override=False)
    tmpl = init_train_state(jcfg, jax.random.PRNGKey(0))
    with np.load(path) as data:
        params = j_load_branch(data, "params", tmpl.g_params)
        state = j_load_branch(data, "state", tmpl.g_state)
    net, _ = load_generator(cfg, path, device="cpu")
    want = JH.evaluate_slice(jcfg, None, params, state,
                             JTextured(64, nc=1, seed=1234), [2001],
                             batch_size=8)
    got = evaluate_slice(cfg, net, TexturedImages(64, nc=1, seed=1234),
                         [2001], batch_size=8)
    _close(got, want, ("psnr_bilinear", "psnr_generator", "ssim_bilinear",
                       "ssim_generator"))
    assert sum(bulge.launches.values()) == 0          # CPU: the plain pair


@pytest.mark.parametrize("variant,nc", [("gray-3", 1), ("gray", 1),
                                        ("rgb-full", 3)])
def test_bilinear_generator_scores_as_control(variant, nc):
    """tests/test_eval_range.py's range invariant, through the port: a
    generator that bilinear-upscales what it is fed scores the control."""
    cfg = get_config(variant, **KW)

    def bilinear_gen(lr):
        return resize_bilinear(lr, cfg.fineSize, cfg.fineSize)

    r = evaluate_slice(cfg, bilinear_gen, TexturedImages(64, nc=nc, seed=1234),
                       [0], batch_size=8, device="cpu")
    np.testing.assert_allclose(r.psnr_generator, r.psnr_bilinear, rtol=1e-6)
    np.testing.assert_allclose(r.ssim_generator, r.ssim_bilinear, rtol=1e-6)
    assert r.psnr_bilinear > 20.0


def test_short_final_batch_does_not_skew_means():
    """The test_eval_range.py case: the mean is over the rows actually read
    (8 + 3), and equals JAX's on the same loader."""
    cfg, jcfg = get_config("gray-3", **KW), j_get_config("gray-3", **KW)
    full = TexturedImages(64, nc=1, seed=1234)

    class ShortLast:
        def load_batch(self, fs, batch_size):
            b = full.load_batch(fs, batch_size)
            return b[:3] if fs == 1 else b

    def gen(lr):
        return resize_bilinear(lr, 64, 64)

    def jgen(params, state, lr):
        return j_resize_bilinear(lr, 64, 64)

    r = evaluate_slice(cfg, gen, ShortLast(), [0, 1], batch_size=8,
                       device="cpu")
    assert r.n_images == 11
    r0 = evaluate_slice(cfg, gen, ShortLast(), [0], batch_size=8, device="cpu")
    r1 = evaluate_slice(cfg, gen, ShortLast(), [1], batch_size=8, device="cpu")
    np.testing.assert_allclose(
        r.psnr_bilinear, (r0.psnr_bilinear * 8 + r1.psnr_bilinear * 3) / 11,
        rtol=1e-6)
    want = JH.evaluate_slice(jcfg, jgen, None, None, ShortLast(), [0, 1],
                             batch_size=8)
    _close(r, want, ("psnr_bilinear", "psnr_generator", "ssim_bilinear",
                     "ssim_generator"))


def test_a_generator_function_needs_a_device():
    cfg = get_config("gray-3", **KW)
    with pytest.raises(ValueError, match="device"):
        evaluate_slice(cfg, lambda lr: lr, TexturedImages(64), [0],
                       batch_size=2)


@pytest.mark.parametrize("bn_eval", [False, True])
def test_evaluate_overlap_slice_matches_jax(bn_eval):
    jcfg, params, state, cfg, _ = _pair("gray-patch-batch-overlap")
    rng = np.random.RandomState(0)
    state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 + 0.3 * np.abs(rng.randn(*a.shape)),
                              jnp.float32), state)
    net = Network(generator_spec(cfg), _np(params), _np(state), device="cpu")
    want = JH.evaluate_overlap_slice(jcfg, params, state,
                                     JTextured(64, nc=1, seed=1234), [0, 1],
                                     batch_size=4, bn_eval=bn_eval)
    got = evaluate_overlap_slice(cfg, net, TexturedImages(64, nc=1, seed=1234),
                                 [0, 1], batch_size=4, bn_eval=bn_eval)
    assert isinstance(got, OverlapEvalResult) and got.n_images == 8
    _close(got, want, ("psnr_bilinear", "psnr_naive", "psnr_seam",
                       "ssim_bilinear", "ssim_naive", "ssim_seam"))


def test_overlap_slice_default_batch_is_cfg_batch():
    cfg = get_config("gray-patch-batch-overlap", env_override=False)
    calls = []

    class Loader:
        def load_batch(self, fs, batch_size):
            calls.append((fs, batch_size))
            return np.random.RandomState(fs).rand(
                batch_size, 1, 64, 64).astype(np.float32)

    res = evaluate_overlap_slice(
        cfg, None, Loader(), [10000], device="cpu",
        sr_fn=lambda hr: {"naive": hr, "seam": hr})
    assert calls == [(10000, cfg.batchSize)] and cfg.batchSize == 20
    assert res.n_images == 20
    assert res.psnr_naive == pytest.approx(99.0)
    assert res.psnr_bilinear < 99.0


def test_polarity_rescue_flips_an_inverted_image():
    rng = np.random.RandomState(3)
    real = rng.rand(16, 16).astype(np.float32)
    img, p, inverted = polarity_rescue(torch.from_numpy(real),
                                       torch.from_numpy(1.0 - real))
    assert inverted and p > 60.0          # 1 - (1 - x) is x to an ulp
    np.testing.assert_allclose(img.numpy(), real, atol=1e-7)
    want = JH.polarity_rescue(real, 1.0 - real)
    assert want[2] and want[1] == pytest.approx(p, rel=1e-3)
    near = np.clip(real + 0.01, 0, 1)
    img, p, inverted = polarity_rescue(torch.from_numpy(real),
                                       torch.from_numpy(near))
    assert not inverted and p > 13.0
    assert p == pytest.approx(JH.polarity_rescue(real, near)[1], abs=1e-4)


def test_print_reference_style_lines_equal_jax():
    vals = (21.123456789, 23.5, 0.7512345678, 0.8)
    lines, want = [], []
    EvalResult(*vals, 200).print_reference_style("Test-set", lines.append)
    JH.EvalResult(*vals, 200).print_reference_style("Test-set", want.append)
    assert lines == want and len(lines) == 4
    ov = (20.0, 21.5, 22.25, 0.7, 0.75, 0.8, 16)
    lines, want = [], []
    OverlapEvalResult(*ov).print_reference_style(log_fn=lines.append)
    JH.OverlapEvalResult(*ov).print_reference_style(log_fn=want.append)
    assert lines == want and len(lines) == 6


def test_inference_generator_is_an_fp32_fused_copy():
    """The eval copy of a bf16-trained state: fused pair, frozen, fp32, its
    own tensors; with `ema` the EMA parameters."""
    cfg = get_config("gray-3", compute_dtype="bfloat16", g_ema=0.9, **KW)
    st = t_init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for e in st.g_ema:
            e.add_(1.0)
    net = inference_generator(cfg, st)
    assert net.pairs and not any(p.requires_grad for p in net.parameters())
    assert all(p.dtype == torch.float32 for p in net.parameters())
    g_params = list(st.g.parameters())
    for a, b in zip(net.parameters(), g_params):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    ema = inference_generator(cfg, st, ema=True)
    for a, b in zip(ema.parameters(), st.g_ema):
        assert torch.equal(a, b)
