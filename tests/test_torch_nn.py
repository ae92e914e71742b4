"""The port's NN ops (dcgan_sr_tpu_torch.ops.nn, ops.init) against the JAX
package's (dcgan_sr_tpu.ops.nn), same numpy inputs, fp32 on the CPU.

Tolerance: 1e-5 abs + 1e-5 rel for convolutions and BN — XLA:CPU and
oneDNN sum the same fp32 products in different orders (a few ulp of the
O(1) outputs); exact equality for data movement (upsample) and 1e-6 for
the elementwise activations."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.ops import nn as JN
from dcgan_sr_tpu_torch.ops import init as TI
from dcgan_sr_tpu_torch.ops import nn as TN

import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("cin,cout,k,s,p,hw", [
    (3, 5, 4, 2, 1, 12),      # the generators' k4s2p1
    (16, 8, 4, 2, 1, 9),      # gray-3 bulge channels, odd extent
    (4, 6, 3, 1, 0, 8),       # patch-D 3x3 valid
    (6, 1, 2, 1, 0, 2),       # patch-D head
])
def test_conv2d_matches_jax(cin, cout, k, s, p, hw):
    rng = np.random.RandomState(0)
    x = rng.randn(2, cin, hw, hw).astype(np.float32)
    w = (0.1 * rng.randn(cout, cin, k, k)).astype(np.float32)
    want = np.asarray(JN.conv2d(jnp.asarray(x), jnp.asarray(w), s, p))
    got = TN.conv2d(_t(x), _t(w), s, p).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout,hw", [(1, 32, 7), (16, 8, 10), (5, 3, 1)])
def test_conv_transpose2d_matches_jax(cin, cout, hw):
    rng = np.random.RandomState(1)
    x = rng.randn(2, cin, hw, hw + 3).astype(np.float32)
    w = (0.1 * rng.randn(cin, cout, 4, 4)).astype(np.float32)
    want = np.asarray(JN.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), 2, 1))
    got = TN.conv_transpose2d(_t(x), _t(w), 2, 1).numpy()
    assert got.shape == (2, cout, 2 * hw, 2 * hw + 6)
    np.testing.assert_allclose(got, want, **TOL)


def _bn_inputs(seed=2):
    rng = np.random.RandomState(seed)
    x = (3.0 + 2.0 * rng.randn(3, 5, 6, 7)).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(5)).astype(np.float32)
    bias = (0.1 * rng.randn(5)).astype(np.float32)
    state = {"mean": (0.1 * rng.randn(5)).astype(np.float32),
             "var": (1 + rng.rand(5)).astype(np.float32)}
    return x, scale, bias, state


def test_batch_norm_train_and_running_update_match_jax():
    x, scale, bias, state = _bn_inputs()
    jy, jst = JN.batch_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias),
                            state={k: jnp.asarray(v) for k, v in state.items()},
                            train=True)
    ty, tst = TN.batch_norm(_t(x), _t(scale), _t(bias),
                            state={k: _t(v) for k, v in state.items()},
                            train=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)


def test_batch_norm_eval_matches_jax():
    x, scale, bias, state = _bn_inputs(3)
    jy, _ = JN.batch_norm(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias),
                          state={k: jnp.asarray(v) for k, v in state.items()},
                          train=False)
    ty, tst = TN.batch_norm(_t(x), _t(scale), _t(bias),
                            state={k: _t(v) for k, v in state.items()},
                            train=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert tst["mean"] is not None


def test_batch_norm_per_image_is_batch_of_one_each():
    """per_image BN == the JAX package's batch_norm run on each image alone
    (make_full_sr_fn's vmap of batch-of-one calls)."""
    x, scale, bias, _ = _bn_inputs(4)
    want = np.concatenate([
        np.asarray(JN.batch_norm(jnp.asarray(x[i:i + 1]), jnp.asarray(scale),
                                 jnp.asarray(bias), train=True)[0])
        for i in range(len(x))])
    ty, tst = TN.batch_norm(_t(x), _t(scale), _t(bias), train=True,
                            per_image=True)
    np.testing.assert_allclose(ty.numpy(), want, **TOL)
    assert tst is None


def test_activations_and_upsample_match_jax():
    rng = np.random.RandomState(5)
    x = (3 * rng.randn(2, 3, 4, 5)).astype(np.float32)
    for jf, tf in ((JN.relu, TN.relu), (JN.leaky_relu, TN.leaky_relu),
                   (JN.sigmoid, TN.sigmoid), (JN.tanh, TN.tanh)):
        np.testing.assert_allclose(tf(_t(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    for f in (2, 3):
        np.testing.assert_array_equal(
            TN.upsample_nearest(_t(x), f).numpy(),
            np.asarray(JN.upsample_nearest(jnp.asarray(x), f)))


def test_init_statistics_and_reproducibility():
    g = torch.Generator().manual_seed(0)
    w = TI.init_conv((64, 32, 4, 4), g)
    assert abs(float(w.mean())) < 2e-3 and abs(float(w.std()) - 0.02) < 1e-3
    scale, bias, st = TI.init_bn(512, g)
    assert abs(float(scale.mean()) - 1.0) < 5e-3
    assert not bias.any() and not st["mean"].any() and bool((st["var"] == 1).all())
    w2 = TI.init_conv((64, 32, 4, 4), torch.Generator().manual_seed(0))
    assert torch.equal(w, w2)


def test_fp32_convs_turns_tf32_off_and_restores():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with TN.fp32_convs():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
