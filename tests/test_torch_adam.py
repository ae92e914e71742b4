"""The port's Torch7 Adam (ops/adam.py) against the JAX package's
adam_update: updates on the same numpy parameters and gradients, rtol 1e-6
(the same fp32 formula: the step count is an int32 tensor and the step size
is computed from it in fp32, as in JAX; the port groups (1-b2)*g*g as
(1-b2)*(g*g))."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcgan_sr_tpu.ops.adam import adam_init as j_init, adam_update as j_update
from dcgan_sr_tpu_torch.ops.adam import adam_init, adam_update_

import torch_threads  # noqa: F401

SHAPES = [(8, 4, 4, 4), (8,), (3, 5)]
TOL = dict(rtol=1e-6, atol=1e-9)


def _run(n, **kw):
    rng = np.random.RandomState(0)
    p_np = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jp = [jnp.asarray(p) for p in p_np]
    js = j_init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p_np]
    ts = adam_init(tp)
    for _ in range(n):
        g_np = [(0.1 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
        jp, js = j_update(jp, [jnp.asarray(g) for g in g_np], js, **kw)
        adam_update_(tp, [torch.from_numpy(g) for g in g_np], ts, **kw)
    return jp, js, tp, ts


@pytest.mark.parametrize("n", [1, 2, 3, 20])
def test_updates_match(n):
    jp, js, tp, ts = _run(n)
    assert ts["t"].dtype == torch.int32 and ts["t"].dim() == 0
    assert int(ts["t"]) == int(js["t"]) == n
    for key, got, want in (("p", tp, jp), ("m", ts["m"], js["m"]),
                           ("v", ts["v"], js["v"])):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=key, **TOL)


def test_non_default_hyperparameters():
    jp, js, tp, ts = _run(3, lr=1e-3, beta1=0.9, beta2=0.99, eps=1e-6)
    for g, w in zip(tp, jp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_eps_sits_outside_the_bias_correction():
    """One step from zero moments: x - lr*sqrt(1-b2)/(1-b1) * m/(sqrt(v)+eps),
    which torch.optim.Adam (eps after the bias correction) does not give for
    a gradient near eps."""
    p = [torch.zeros(1)]
    g = [torch.full((1,), 1e-8)]
    adam_update_(p, g, adam_init(p), lr=1.0, beta1=0.5, beta2=0.999, eps=1e-8)
    m, v = 0.5 * 1e-8, 0.001 * 1e-16
    want = -np.sqrt(1 - 0.999) / 0.5 * m / (np.sqrt(v) + 1e-8)
    np.testing.assert_allclose(p[0].numpy(), [want], rtol=1e-5)


def test_update_is_in_place_and_needs_no_grad_graph():
    p = [torch.ones(3, requires_grad=True)]
    st = adam_init(p)
    assert not st["m"][0].requires_grad
    ptr = p[0].data_ptr()
    t = st["t"]
    adam_update_(p, [torch.ones(3)], st)
    assert p[0].data_ptr() == ptr and p[0].requires_grad
    # the step count is a 0-d int32 tensor, advanced in place: a captured
    # graph of the update advances it on every replay
    assert st["t"] is t and t.dtype == torch.int32 and int(t) == 1


def test_step_count_crosses_npz_checkpoints_both_ways(tmp_path):
    """The tensor `t` is written as the JAX package's int32 scalar and read
    back as a 0-d int32 tensor on the state's device: a port checkpoint
    loads in the JAX package with its count, and the JAX package's file of
    that state loads in the port with the same count."""
    import jax
    from dcgan_sr_tpu.core import get_config as j_get_config
    from dcgan_sr_tpu.train import checkpoint as JC
    from dcgan_sr_tpu.train.step import init_train_state as j_init
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.train import checkpoint as TC
    from dcgan_sr_tpu_torch.train.step import init_train_state

    kw = dict(env_override=False, ngf=4, ndf=8, batchSize=4)
    cfg = get_config("gray-3", **kw)
    st = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    st.g_opt["t"].fill_(7)
    st.d_opt["t"].fill_(5)
    TC.save_checkpoint(str(tmp_path / "port"), cfg.name, 1, st)
    jst = JC.load_checkpoint(str(tmp_path / "port"), cfg.name, 1,
                             j_init(j_get_config("gray-3", **kw),
                                    jax.random.PRNGKey(0)))
    assert jst.g_opt["t"].dtype == jnp.int32
    assert (int(jst.g_opt["t"]), int(jst.d_opt["t"])) == (7, 5)
    JC.save_checkpoint(str(tmp_path / "jax"), cfg.name, 1, jst)
    back = TC.load_checkpoint(str(tmp_path / "jax"), cfg.name, 1, st)
    for opt, want in ((back.g_opt, 7), (back.d_opt, 5)):
        assert opt["t"].dtype == torch.int32 and opt["t"].dim() == 0
        assert opt["t"].device == back.g.device and int(opt["t"]) == want
