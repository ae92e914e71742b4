"""The port's fused bulge pair (dcgan_sr_tpu_torch.ops.bulge) against the
JAX package's unfused composition of G layers 3-4.

On the CPU the wrapper runs its plain version; these tests hold that plain
version to `_reference_pair` (tests/test_pallas_fused.py) in all three BN
statistics modes, at that file's geometries plus widths that are not
multiples of 128.  The hand-written CUDA kernel itself is held to the plain
version on the card (tests/test_torch_cuda.py, and chip_smoke.py).

Tolerances (tests/test_pallas_fused.py): 1e-5 abs + rel for the hidden
tensor's mean/var, 2e-4 for y — XLA:CPU and oneDNN sum the convolutions'
products in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.ops import nn as JN
from dcgan_sr_tpu_torch.ops import bulge as K

from test_pallas_fused import _reference_pair

import torch_threads  # noqa: F401

STATS_TOL = dict(rtol=1e-5, atol=1e-5)
Y_TOL = dict(rtol=2e-4, atol=2e-4)

GEOMETRIES = [
    (2, 5, 4, 6, 16, 16),
    (1, 16, 8, 16, 32, 32),    # gray-3 bulge channel geometry
    (3, 3, 2, 3, 8, 8),
    (2, 16, 8, 16, 12, 20),    # W not a multiple of 128, H not of any tm
    (1, 8, 4, 8, 9, 5),        # odd extents
]


def _inputs(bsz, ci, cm, co, h, w, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(bsz, ci, h, w).astype(np.float32),
        wT=(0.1 * rng.randn(ci, cm, 4, 4)).astype(np.float32),
        wC=(0.1 * rng.randn(co, cm, 4, 4)).astype(np.float32),
        scale=(1.0 + 0.1 * rng.randn(cm)).astype(np.float32),
        bias=(0.1 * rng.randn(cm)).astype(np.float32),
        rmean=(0.1 * rng.randn(cm)).astype(np.float32),
        rvar=(0.5 + rng.rand(cm)).astype(np.float32))


def _jax_reference(a, stats):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if stats == "pooled":
        y, (m, v) = _reference_pair(j["x"], j["wT"], j["scale"], j["bias"],
                                    j["wC"])
        return np.asarray(y), np.asarray(m), np.asarray(v)
    if stats == "per_image":     # make_full_sr_fn: each image alone
        outs = [_reference_pair(j["x"][i:i + 1], j["wT"], j["scale"],
                                j["bias"], j["wC"])
                for i in range(a["x"].shape[0])]
        return (np.concatenate([np.asarray(o[0]) for o in outs]),
                np.stack([np.asarray(o[1][0]) for o in outs]),
                np.stack([np.asarray(o[1][1]) for o in outs]))
    # running statistics: the JAX package's unfused eval-mode layers 3-4
    h = JN.conv_transpose2d(j["x"], j["wT"], 2, 1)
    hn, _ = JN.batch_norm(h, j["scale"], j["bias"],
                          state={"mean": j["rmean"], "var": j["rvar"]},
                          train=False)
    y = JN.conv2d(JN.relu(hn), j["wC"], 2, 1)
    return np.asarray(y), a["rmean"], a["rvar"]


def _port(a, stats, fn=K.bulge):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y, (m, v) = fn(t["x"], t["wT"], t["scale"], t["bias"], t["wC"],
                   stats=stats,
                   running=(t["rmean"], t["rvar"]) if stats == "running"
                   else None)
    return y.numpy(), m.numpy(), v.numpy()


@pytest.mark.parametrize("stats", K.STATS_MODES)
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_bulge_matches_jax_unfused_pair(geom, stats):
    a = _inputs(*geom)
    y, m, v = _port(a, stats)
    y_ref, m_ref, v_ref = _jax_reference(a, stats)
    assert y.shape == (geom[0], geom[3], geom[4], geom[5])
    np.testing.assert_allclose(m, m_ref, **STATS_TOL)
    np.testing.assert_allclose(v, v_ref, **STATS_TOL)
    np.testing.assert_allclose(y, y_ref, **Y_TOL)


def test_cpu_bulge_is_the_plain_version_and_launches_nothing():
    a = _inputs(2, 16, 8, 16, 10, 14)
    before = dict(K.launches)
    for stats in K.STATS_MODES:
        got = _port(a, stats)
        want = _port(a, stats, K.bulge_plain)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert K.launches == before


def test_bulge_rejects_malformed_inputs():
    a = {k: torch.from_numpy(v) for k, v in _inputs(1, 16, 8, 16, 8, 8).items()}
    args = (a["x"], a["wT"], a["scale"], a["bias"], a["wC"])
    with pytest.raises(ValueError, match="stats"):
        K.bulge(*args, stats="batch")
    with pytest.raises(ValueError, match="running"):
        K.bulge(*args, stats="running")
    with pytest.raises(ValueError, match="weights"):
        K.bulge(a["x"][:, :8], *args[1:])
    with pytest.raises(ValueError, match="BN vectors"):
        K.bulge(a["x"], a["wT"], a["scale"][:4], a["bias"], a["wC"])
    with pytest.raises(ValueError, match="device"):
        K.bulge(a["x"], a["wT"].to("meta"), a["scale"], a["bias"], a["wC"])


@pytest.mark.slow
def test_bulge_matches_pallas_kernel_interpret():
    """Against the TPU kernel itself, fused_bulge_fwd in interpret mode
    (pooled statistics, its only mode) at its minimal legal geometry."""
    from dcgan_sr_tpu.ops.pallas_bulge import fused_bulge_fwd

    a = _inputs(2, 16, 8, 16, 32, 128)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    y_ref, (m_ref, v_ref) = fused_bulge_fwd(j["x"], j["wT"], j["scale"],
                                            j["bias"], j["wC"], tm=16,
                                            interpret=True)
    y, m, v = _port(a, "pooled")
    np.testing.assert_allclose(m, np.asarray(m_ref), **STATS_TOL)
    np.testing.assert_allclose(v, np.asarray(v_ref), **STATS_TOL)
    np.testing.assert_allclose(y, np.asarray(jax.device_get(y_ref)), **Y_TOL)
