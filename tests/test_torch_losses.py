"""The port's criteria, label schemes and per-image MSEs against the JAX
package's (losses/schemes.py, metrics/psnr_ssim.py), on numpy inputs made
from a seed.  rtol 1e-6: the same fp32 elementwise formulas; only the order
of the mean's sum differs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.losses import schemes as JL
from dcgan_sr_tpu.metrics import (cal_mse_hw as j_mse_hw,
                                  cal_mse_quarter as j_mse_quarter)
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.losses import schemes as TL
from dcgan_sr_tpu_torch.metrics import cal_mse_hw, cal_mse_quarter

import torch_threads  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-7)
VARIANTS = ["rgb-full", "gray", "gray-2", "gray-3", "gray-patch",
            "gray-patch-batch", "gray-patch-batch-overlap"]


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("name", ["mse_loss", "bce_loss",
                                  "bce_with_logits_loss"])
def test_criteria_match(name):
    rng = np.random.RandomState(0)
    target = rng.rand(16).astype(np.float32)
    if name == "bce_with_logits_loss":
        # saturated logits included: the stable formula must hold there
        pred = np.concatenate([4 * rng.randn(12), [-60.0, 60.0, -20.0, 20.0]]
                              ).astype(np.float32)
    else:
        pred = np.concatenate([rng.rand(14), [0.0, 1.0]]).astype(np.float32)
    got = getattr(TL, name)(_t(pred), _t(target))
    want = getattr(JL, name)(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bce_with_logits_gradient_matches():
    import jax
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(16)).astype(np.float32)
    target = rng.rand(16).astype(np.float32)
    lt = _t(logits).requires_grad_(True)
    (g,) = torch.autograd.grad(TL.bce_with_logits_loss(lt, _t(target)), lt)
    want = jax.grad(JL.bce_with_logits_loss)(jnp.asarray(logits),
                                             jnp.asarray(target))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("variant", VARIANTS)
def test_criterion_choice(variant):
    cfg, jcfg = (get_config(variant, env_override=False),
                 j_get_config(variant, env_override=False))
    assert TL.criterion(cfg).__name__ == JL.criterion(jcfg).__name__


@pytest.mark.parametrize("variant", VARIANTS)
def test_make_labels_match(variant):
    cfg, jcfg = (get_config(variant, env_override=False),
                 j_get_config(variant, env_override=False))
    rng = np.random.RandomState(2)
    real = rng.rand(5, cfg.nc, 16, 16).astype(np.float32)
    fake = rng.rand(5, cfg.nc, 16, 16).astype(np.float32)
    got = TL.make_labels(cfg, _t(real), _t(fake))
    want = JL.make_labels(jcfg, jnp.asarray(real), jnp.asarray(fake))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (5,)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("c", [1, 3])
def test_per_image_mse_match(c):
    rng = np.random.RandomState(3)
    a = rng.rand(4, c, 8, 12).astype(np.float32)
    b = rng.rand(4, c, 8, 12).astype(np.float32)
    np.testing.assert_allclose(cal_mse_hw(_t(a), _t(b)).numpy(),
                               np.asarray(j_mse_hw(jnp.asarray(a),
                                                   jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(cal_mse_quarter(_t(a), _t(b)).numpy(),
                               np.asarray(j_mse_quarter(jnp.asarray(a),
                                                        jnp.asarray(b))), **TOL)
