"""The port's dihedral self-ensemble (infer/ensemble.py) against the JAX
package's wrapper around the same function of x.  Tolerance 1e-6: the same
few fp32 sums, averaged in the same order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.infer import ensemble as JE
from dcgan_sr_tpu_torch.infer import ensemble as TE

import torch_threads  # noqa: F401

W = np.random.RandomState(0).randn(3, 3).astype(np.float32)


def _j_gen(params, state, x):
    """Not symmetric under the group: 2x nearest upsample of a 3x3
    cross-correlation-like mix of shifted copies, plus a ramp."""
    y = sum(W[a, b] * jnp.roll(x, (a - 1, b - 1), axis=(-2, -1))
            for a in range(3) for b in range(3))
    y = jnp.repeat(jnp.repeat(y, 2, axis=-2), 2, axis=-1)
    return y + jnp.arange(y.shape[-1], dtype=jnp.float32) * 0.01


def _t_gen(x):
    y = sum(float(W[a, b]) * torch.roll(x, (a - 1, b - 1), dims=(-2, -1))
            for a in range(3) for b in range(3))
    y = y.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return y + torch.arange(y.shape[-1], dtype=torch.float32) * 0.01


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("transforms", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(2, 1, 6, 6), (3, 2, 4, 10)])
def test_self_ensemble_matches_jax(shape, transforms, batched):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = JE.self_ensemble(_j_gen, transforms, batched=batched)(
        None, None, jnp.asarray(x))
    got = TE.self_ensemble(_t_gen, transforms, batched=batched)(
        torch.from_numpy(x))
    assert got.shape == (shape[0], shape[1], 2 * shape[2], 2 * shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("h,w,transforms", [(6, 6, 8), (6, 6, 3), (4, 10, 8),
                                            (4, 10, 2), (5, 5, 1)])
def test_dihedral_plan_equals_jax(h, w, transforms):
    assert TE.dihedral_plan(h, w, transforms) == JE.dihedral_plan(h, w,
                                                                  transforms)
    if h != w:      # rectangles fall back to the four shape-preserving members
        assert len(TE.dihedral_plan(h, w, 8)) == 4


def test_plan_rejects_zero_and_one_is_the_function_itself():
    with pytest.raises(ValueError, match=">= 1"):
        TE.dihedral_plan(4, 4, 0)
    assert TE.self_ensemble(_t_gen, 1) is _t_gen


def test_members_invert_to_the_identity():
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 1, 5, 5).astype(np.float32))
    plan = TE.dihedral_plan(5, 5, 8)
    for y in TE._invert(TE._members_of(x, plan), plan):
        assert torch.equal(y, x)
