"""The port's channels-last fused pair (dcgan_sr_tpu_torch.ops.fused_nhwc)
against the JAX package's K3 (ops/pallas_fused.py, in interpret mode) and
the unfused composition, on the CPU.  On a CPU tensor the entry runs
`fused_nhwc_plain`, the packed row-band formulation in PyTorch, so these
tests check the packing, the band geometry and the padding masks; the CUDA
kernel itself is held to this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances are those of tests/test_pallas_fused.py: mean, var 1e-5 and y
2e-4 (abs + rel); the packers move weights and are held to equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.ops import nn as JN
from dcgan_sr_tpu.ops import pallas_fused as JF
from dcgan_sr_tpu_torch.ops import fused_nhwc as TF
from dcgan_sr_tpu_torch.ops.bulge import bulge_plain

import torch_threads  # noqa: F401

# the shapes of tests/test_pallas_fused.py:35-39
SHAPES = [(2, 5, 4, 6, 16, 8), (1, 16, 8, 16, 32, 16), (3, 3, 2, 3, 8, 8)]


def _inputs(bsz, ci, cm, co, hw, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(bsz, ci, hw, hw).astype(np.float32),
            (0.1 * rng.randn(ci, cm, 4, 4)).astype(np.float32),
            (1.0 + 0.1 * rng.randn(cm)).astype(np.float32),
            (0.1 * rng.randn(cm)).astype(np.float32),
            (0.1 * rng.randn(co, cm, 4, 4)).astype(np.float32))


def _reference_pair(x, wT, scale, bias, wC, eps=1e-5):
    """tests/test_pallas_fused.py _reference_pair."""
    h = JN.conv_transpose2d(x, wT, 2, 1)
    mean = h.mean(axis=(0, 2, 3))
    var = ((h - mean[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    hn = (h - mean[None, :, None, None]) / jnp.sqrt(
        var[None, :, None, None] + eps)
    hn = hn * scale[None, :, None, None] + bias[None, :, None, None]
    return JN.conv2d(jnp.maximum(hn, 0.0), wC, 2, 1), (mean, var)


@pytest.mark.parametrize("ci,cm,co", [(5, 4, 6), (16, 8, 16), (3, 2, 3)])
def test_packers_equal_jax(ci, cm, co):
    _, wT, _, _, wC = _inputs(1, ci, cm, co, 8)
    np.testing.assert_array_equal(TF._pack_wT(torch.from_numpy(wT)).numpy(),
                                  np.asarray(JF._pack_wT(jnp.asarray(wT))))
    np.testing.assert_array_equal(TF._pack_wC(torch.from_numpy(wC)).numpy(),
                                  np.asarray(JF._pack_wC(jnp.asarray(wC))))


@pytest.mark.parametrize("bsz,ci,cm,co,hw,tm", SHAPES)
def test_plain_matches_jax_kernel_and_composition(bsz, ci, cm, co, hw, tm):
    a = _inputs(bsz, ci, cm, co, hw)
    y, (m, v) = TF.fused_convT_bn_relu_conv(*map(torch.from_numpy, a), tm=tm)
    assert y.shape == (bsz, co, hw, hw) and y.is_contiguous()
    assert m.shape == v.shape == (cm,)
    ja = tuple(map(jnp.asarray, a))
    for want_y, (want_m, want_v) in (
            JF.fused_convT_bn_relu_conv(*ja, tm=tm, interpret=True),
            _reference_pair(*ja)):
        np.testing.assert_allclose(m.numpy(), np.asarray(want_m), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("h,w,tm", [(12, 20, 4), (12, 20, 12), (8, 5, 2)])
def test_plain_matches_the_bulge_pair_on_rectangles(h, w, tm):
    """Any W, any band height that divides H: same function as ops/bulge.py."""
    rng = np.random.RandomState(1)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    x, wT, wC = t(2, 6, h, w), 0.1 * t(6, 4, 4, 4), 0.1 * t(8, 4, 4, 4)
    scale, bias = 1 + 0.1 * t(4), 0.1 * t(4)
    y, (m, v) = TF.fused_nhwc_plain(x, wT, scale, bias, wC, tm=tm)
    yb, (mb, vb) = bulge_plain(x, wT, scale, bias, wC)
    np.testing.assert_allclose(m.numpy(), mb.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), vb.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), yb.numpy(), rtol=2e-4, atol=2e-4)


def test_rejects_what_it_does_not_take():
    x, wT, s, b, wC = map(torch.from_numpy, _inputs(1, 3, 2, 3, 8))
    with pytest.raises(ValueError, match="multiple of the band height"):
        TF.fused_convT_bn_relu_conv(x, wT, s, b, wC, tm=3)
    with pytest.raises(ValueError, match="multiple of the band height"):
        TF.fused_convT_bn_relu_conv(x, wT, s, b, wC)            # tm = 32 > 8
    with pytest.raises(ValueError, match="weights must be"):
        TF.fused_convT_bn_relu_conv(x, wT[:2], s, b, wC, tm=8)
    with pytest.raises(ValueError, match="BN vectors"):
        TF.fused_convT_bn_relu_conv(x, wT, s[:1], b, wC, tm=8)
    assert TF.launches == {"fused_nhwc_stats": 0, "fused_nhwc_main": 0,
                           "fused_nhwc_stats_bf16": 0,
                           "fused_nhwc_main_bf16": 0}
