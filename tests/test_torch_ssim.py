"""The port's SSIM and the image ops under it (dcgan_sr_tpu_torch.metrics,
image/ops.py) against the JAX package's on the CPU, on numpy inputs made
from a seed.

Tolerances: the Gaussian window bit for bit (both are numpy float64 cast to
fp32); the 'full' convolution rtol 1e-6 of the output's scale (the same fp32
sums in another order); SSIM 1e-5 per image (σ is a difference of values
near 65,025, so the order of the sums shows in the sixth decimal); the scipy
re-derivation of tests/test_metrics.py rtol 1e-4; luma and to_display 1e-7."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.image import ops as JO
from dcgan_sr_tpu.metrics import psnr_ssim as JM
from dcgan_sr_tpu_torch.image import ops as TO
from dcgan_sr_tpu_torch.metrics import (cal_psnr, cal_psnr_batch, cal_ssim,
                                        cal_ssim_batch)

import torch_threads  # noqa: F401


def _pair(shape, seed, noise=0.1):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + noise * rng.randn(*shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("size,sigma", [(11, 1.5 / 11), (7, 0.3), (4, 0.25)])
def test_gaussian_window_is_bit_equal(size, sigma):
    got = TO.gaussian_window(size, sigma).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(JO.gaussian_window(size,
                                                                      sigma)))


@pytest.mark.parametrize("hw,k", [((16, 16), 11), ((31, 47), 11), ((9, 5), 3)])
def test_convolve_full_matches_jax(hw, k):
    rng = np.random.RandomState(hw[0] * k)
    img = (rng.rand(*hw) * 255).astype(np.float32)
    ker = rng.rand(k, k).astype(np.float32)
    want = np.asarray(JO.convolve_full(jnp.asarray(img), jnp.asarray(ker)))
    got = TO.convolve_full(torch.from_numpy(img), torch.from_numpy(ker)).numpy()
    assert got.shape == (hw[0] + k - 1, hw[1] + k - 1) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # a leading batch dimension convolves each image on its own
    two = TO.convolve_full(torch.from_numpy(np.stack([img, img[::-1].copy()])),
                           torch.from_numpy(ker)).numpy()
    np.testing.assert_allclose(two[0], got, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 64, 64), (1, 31, 47)])
def test_ssim_matches_jax_per_image(shape):
    a, b = _pair(shape, seed=shape[1])
    want = np.asarray(JM.cal_ssim_batch(jnp.asarray(a), jnp.asarray(b)))
    got = cal_ssim_batch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for i in range(shape[0]):
        one = float(cal_ssim(torch.from_numpy(a[i]), torch.from_numpy(b[i])))
        assert abs(one - float(JM.cal_ssim(jnp.asarray(a[i]),
                                           jnp.asarray(b[i])))) <= 1e-5
        assert abs(one - got[i]) <= 1e-6     # batched == one at a time
    # identical images score 1
    same = cal_ssim_batch(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(same, 1.0, atol=1e-6)


def test_ssim_matches_independent_scipy_full_conv():
    """tests/test_metrics.py's scipy re-derivation of the reference formula,
    applied to the port."""
    from scipy.signal import convolve2d

    rng = np.random.RandomState(10)
    a = rng.rand(32, 32).astype(np.float32)
    b = np.random.RandomState(11).rand(32, 32).astype(np.float32)
    got = float(cal_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    x = (a + 1) / 2 * 255.0
    y = (b + 1) / 2 * 255.0
    i = np.arange(1, 12, dtype=np.float64)
    g = np.exp(-(((i - (11 / 2 + 0.5)) / 1.5) ** 2) / 2)
    win = np.outer(g, g)
    win /= win.sum()
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mu1 = convolve2d(x, win, mode="full")
    mu2 = convolve2d(y, win, mode="full")
    s1 = convolve2d(x * x, win, mode="full") - mu1 ** 2
    s2 = convolve2d(y * y, win, mode="full") - mu2 ** 2
    s12 = convolve2d(x * y, win, mode="full") - mu1 * mu2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
    np.testing.assert_allclose(got, m.mean(), rtol=1e-4)


def test_ssim_orders_by_noise():
    a, small = _pair((64, 64), seed=7, noise=0.01)
    _, big = _pair((64, 64), seed=7, noise=0.3)
    t = torch.from_numpy
    assert float(cal_ssim(t(a), t(big))) < float(cal_ssim(t(a), t(small))) < 1


def test_psnr_batch_matches_jax():
    a, b = _pair((4, 12, 9), seed=3)
    want = np.asarray(JM.cal_psnr_batch(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(cal_psnr_batch(a, b).numpy(), want, rtol=1e-6)
    assert float(cal_psnr(a[0], a[0])) == 99.0


def test_luma_and_to_display_match_jax():
    rng = np.random.RandomState(5)
    x = rng.rand(2, 3, 9, 7).astype(np.float32)
    np.testing.assert_allclose(
        TO.luma_rec601(torch.from_numpy(x)).numpy(),
        np.asarray(JO.luma_rec601(jnp.asarray(x))), rtol=0, atol=1e-7)
    y = (rng.randn(3, 9, 7) * 4 - 1).astype(np.float32)
    got = TO.to_display(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(JO.to_display(jnp.asarray(y))),
                               rtol=0, atol=1e-7)
    assert got.min() == 0.0 and abs(got.max() - 1.0) <= 1e-7
    const = TO.to_display(torch.full((5, 4), -0.25)).numpy()
    assert (const == 0).all()
