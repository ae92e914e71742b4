"""The port's fused preprocess (ops/preprocess.py) on the CPU — its plain
version, which the CUDA kernel is held to on the card — against the JAX
package's Pallas kernel in interpret mode and against the jnp composition,
on the three cases of tests/test_pallas.py.

Tolerances as there: rtol 1e-6 / atol 1e-7 with both flags off (the box
mean sums the same four fp32 values; XLA may order them differently), rtol
1e-5 / atol 1e-6 with gray + pm1 (XLA:CPU may contract the weighted channel
sum into FMAs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.image.ops import (box_downsample2 as j_box,
                                    normalize_pm1 as j_pm1,
                                    rgb2gray as j_gray)
from dcgan_sr_tpu.ops.pallas_kernels import pallas_preprocess
from dcgan_sr_tpu_torch.image import ops as TO
from dcgan_sr_tpu_torch.ops import preprocess as P

import torch_threads  # noqa: F401

CASES = {
    "plain": ((3, 1, 64, 64), False, False, dict(rtol=1e-6, atol=1e-7)),
    "gray_pm1": ((2, 3, 32, 32), True, True, dict(rtol=1e-5, atol=1e-6)),
    "gray": ((4, 3, 16, 16), True, False, dict(rtol=1e-5, atol=1e-6)),
    "pm1_rgb": ((2, 3, 10, 6), False, True, dict(rtol=1e-5, atol=1e-6)),
}


def _x(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_matches_pallas_interpret(case):
    shape, gray, pm1, tol = CASES[case]
    x = _x(shape, 1)
    n0 = P.launches["preprocess"]
    hr, lr = P.preprocess(torch.from_numpy(x), rgb_to_gray=gray, to_pm1=pm1)
    assert P.launches["preprocess"] == n0      # a CPU call launches nothing
    j_hr, j_lr = pallas_preprocess(jnp.asarray(x), rgb_to_gray=gray,
                                   to_pm1=pm1, interpret=True)
    assert tuple(hr.shape) == j_hr.shape and tuple(lr.shape) == j_lr.shape
    np.testing.assert_allclose(hr.numpy(), np.asarray(j_hr), **tol)
    np.testing.assert_allclose(lr.numpy(), np.asarray(j_lr), **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_matches_jnp_composition(case):
    shape, gray, pm1, tol = CASES[case]
    x = _x(shape, 2)
    hr, lr = P.preprocess(torch.from_numpy(x), rgb_to_gray=gray, to_pm1=pm1)
    want = jnp.asarray(x)
    if gray:
        want = j_gray(want)[:, None]
    if pm1:
        want = j_pm1(want)
    np.testing.assert_allclose(hr.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(lr.numpy(), np.asarray(j_box(want)), **tol)


def test_flags_off_returns_x_and_box_mean():
    x = torch.from_numpy(_x((3, 1, 64, 64), 3))
    hr, lr = P.preprocess(x)
    assert torch.equal(hr, x)
    np.testing.assert_allclose(lr.numpy(), TO.box_downsample2(x).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_plain_sums_rows_first_then_columns():
    """The rounding order the kernel repeats: ((a + c) + (b + d)) * 0.25."""
    x = torch.from_numpy(_x((2, 3, 8, 12), 4))
    _, lr = P.preprocess_plain(x)
    a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    assert torch.equal(lr, ((a + c) + (b + d)) * 0.25)


def test_image_ops_match():
    x = _x((2, 3, 8, 8), 5)
    np.testing.assert_allclose(TO.normalize_pm1(torch.from_numpy(x)).numpy(),
                               np.asarray(j_pm1(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(TO.rgb2gray(torch.from_numpy(x)).numpy(),
                               np.asarray(j_gray(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1, 7, 8), (1, 1, 8, 7), (2, 3, 5, 5)])
def test_odd_sizes_raise(shape):
    with pytest.raises(ValueError, match="even"):
        P.preprocess(torch.zeros(shape))


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="float32"):
        P.preprocess(torch.zeros((1, 1, 4, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="3 channels"):
        P.preprocess(torch.zeros((1, 1, 4, 4)), rgb_to_gray=True)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        P.preprocess(torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        P.preprocess(torch.zeros((1, 1, 4, 4), device="meta"))
