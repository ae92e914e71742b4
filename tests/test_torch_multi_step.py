"""K steps per call (train/multi_step.py) equal K single steps exactly: the
multi-step body is the single step, so every leaf and every metric is
bit-equal on the CPU.  Also against the JAX package's scanned multi-step,
at the train-step test's tolerance for a first step."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.train.multi_step import build_multi_step as j_build_multi_step
from dcgan_sr_tpu.train.step import init_train_state as j_init_train_state
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.train.multi_step import build_multi_step
from dcgan_sr_tpu_torch.train.step import (build_train_step, init_train_state,
                                           state_from_numpy, state_to_numpy)

import torch_threads  # noqa: F401

K, B = 3, 4
KW = dict(env_override=False, ngf=4, ndf=8, batchSize=B)


def _batches(cfg, seed=0):
    hr = np.random.RandomState(seed).rand(K, B, cfg.nc, 64, 64)
    return torch.from_numpy(hr.astype(np.float32))


def _flat(state):
    return jax.tree_util.tree_leaves_with_path(state_to_numpy(state))


@pytest.mark.parametrize("variant,over", [("gray-3", {}), ("gray-3", {"g_ema": 0.9}),
                                          ("gray", {}), ("rgb-full", {})])
def test_k_steps_equal_k_single_steps(variant, over):
    cfg = get_config(variant, **KW, **over)
    a = init_train_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = copy.deepcopy(a)
    hr = _batches(cfg)
    a, stacked = build_multi_step(cfg)(a, hr)
    step = build_train_step(cfg)
    singles = []
    for k in range(K):
        b, m = step(b, hr[k])
        singles.append(m)
    for key, v in stacked.items():
        assert tuple(v.shape) == (K,)
        assert torch.equal(v, torch.stack([m[key] for m in singles])), key
    for (pa, la), (pb, lb) in zip(_flat(a), _flat(b)):
        assert pa == pb
        np.testing.assert_array_equal(la, lb, err_msg=str(pa))
    assert a.g_opt["t"] == a.d_opt["t"] == K


def test_multi_step_updates_state_in_place():
    cfg = get_config("gray-3", **KW)
    st = init_train_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    w0 = st.g.layers[1].w.detach().clone()
    out, _ = build_multi_step(cfg)(st, _batches(cfg))
    assert out is st
    assert not torch.equal(st.g.layers[1].w, w0)


def test_first_scanned_metrics_match_jax():
    """Step 0 of the JAX package's lax.scan multi-step from the same state
    and batches (later steps diverge by Adam's sign flips; the train-step
    test covers them)."""
    jcfg, cfg = j_get_config("gray-3", **KW), get_config("gray-3", **KW)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(1))
    fields = {f: jax.tree_util.tree_map(np.asarray, getattr(jst, f))
              for f in ("g_params", "g_state", "g_opt", "d_params", "d_state",
                        "d_opt", "g_ema_params")}
    st = state_from_numpy(cfg, fields, device="cpu")
    hr = _batches(cfg, seed=2)
    _, jm = jax.jit(j_build_multi_step(jcfg))(jst, jnp.asarray(hr.numpy()))
    _, tm = build_multi_step(cfg)(st, hr)
    assert sorted(tm) == sorted(jm)
    for key in tm:
        assert np.asarray(jm[key]).shape == tuple(tm[key].shape) == (K,)
        np.testing.assert_allclose(tm[key][0].numpy(), np.asarray(jm[key])[0],
                                   rtol=1e-4, atol=1e-7, err_msg=key)
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                   rtol=2e-3, atol=2e-4, err_msg=key)
