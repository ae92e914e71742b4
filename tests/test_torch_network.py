"""The port's generator (dcgan_sr_tpu_torch.models.Network) and full-image
SR (infer/tiled.py) against the JAX package's apply_network and
make_full_sr_fn, with weights carried across: from init_train_state at
ngf 4, and from the full-width gray-3 fixture, loaded key for key.

Tolerance: 1e-5 abs + rel on the sigmoid outputs in [0, 1] — the same fp32
products summed in different orders by XLA:CPU and oneDNN, through six
conv layers and five BNs."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.infer.tiled import make_full_sr_fn as j_full_sr_fn
from dcgan_sr_tpu.models import apply_network, generator_spec as j_spec
from dcgan_sr_tpu.train import init_train_state
from dcgan_sr_tpu.train.checkpoint import load_branch as j_load_branch
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.infer.tiled import (make_full_sr_fn,
                                            make_generator_fn, sr_full_image)
from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
from dcgan_sr_tpu_torch.models.network import bulge_pairs
from dcgan_sr_tpu_torch.train.checkpoint import (load_branch, load_generator,
                                                 npz_branches)

import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "gray3_textured_net_G.npz")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """gray-3 at ngf 4 with the JAX package's own random init."""
    cfg = j_get_config("gray-3", env_override=False, ngf=4, ndf=8)
    st = init_train_state(cfg, jax.random.PRNGKey(0))
    params, state = _np_tree(st.g_params), _np_tree(st.g_state)
    # give the running stats non-trivial values so eval mode is exercised
    rng = np.random.RandomState(0)
    for s in state:
        if "bn" in s:
            s["bn"]["mean"] = (0.1 * rng.randn(*s["bn"]["mean"].shape)).astype(np.float32)
            s["bn"]["var"] = (0.5 + rng.rand(*s["bn"]["var"].shape)).astype(np.float32)
    return cfg, params, state


@pytest.fixture(scope="module")
def fixture_weights():
    cfg = j_get_config("gray-3", env_override=False)
    st = init_train_state(cfg, jax.random.PRNGKey(0))
    with np.load(FIXTURE) as data:
        jp = _np_tree(j_load_branch(data, "params", st.g_params))
        js = _np_tree(j_load_branch(data, "state", st.g_state))
    return cfg, jp, js


def test_specs_pair_detection():
    spec = generator_spec(get_config("gray-3", env_override=False))
    assert bulge_pairs(spec) == [3]                 # layers 3-4 (specs.py:68-69)
    assert bulge_pairs(generator_spec(
        get_config("gray", env_override=False))) == []   # no BN in gray's G


def test_fixture_loads_key_for_key(fixture_weights):
    _, jp, js = fixture_weights
    spec = generator_spec(get_config("gray-3", env_override=False))
    params, state = init_network(spec, torch.Generator().manual_seed(0))
    with np.load(FIXTURE) as data:
        assert npz_branches(data) == {"params", "state", "opt"}
        tp = load_branch(data, "params", params)
        ts = load_branch(data, "state", state)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(ts)):
        np.testing.assert_array_equal(a, b)
    net = Network(spec, tp, ts, device="cpu")
    sd = net.state_dict()
    for i, p in enumerate(jp):
        for k, v in p.items():                      # _params_/_<i>_/_<k>_
            np.testing.assert_array_equal(sd[f"layers.{i}.{k}"].numpy(), v)
    for i, s in enumerate(js):
        for k, v in s.get("bn", {}).items():        # _state_/_<i>_/_bn_/_<k>_
            np.testing.assert_array_equal(sd[f"layers.{i}.bn_{k}"].numpy(), v)
    assert len(sd) == sum(len(p) for p in jp) + 2 * sum("bn" in s for s in js)


@pytest.mark.parametrize("bn_stats", ["pooled", "running", "per_image"])
@pytest.mark.parametrize("fuse", [True, False])
def test_tiny_generator_matches_apply_network(tiny, bn_stats, fuse):
    cfg, params, state = tiny
    x = np.random.RandomState(1).rand(3, 1, 6, 10).astype(np.float32)
    spec = j_spec(cfg)
    if bn_stats == "per_image":
        want = np.concatenate([np.asarray(apply_network(
            spec, params, jnp.asarray(x[i:i + 1]), state, train=True)[0])
            for i in range(len(x))])
    else:
        want = np.asarray(apply_network(spec, params, jnp.asarray(x), state,
                                        train=bn_stats == "pooled")[0])
    net = Network(generator_spec(get_config("gray-3", env_override=False,
                                            ngf=4, ndf=8)),
                  params, state, device="cpu", fuse=fuse)
    with torch.inference_mode():
        got = net(torch.from_numpy(x), bn_stats=bn_stats).numpy()
    assert got.shape == (3, 1, 12, 20)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bn_eval", [False, True])
def test_fixture_generator_matches_apply_network(fixture_weights, bn_eval):
    cfg, jp, js = fixture_weights
    x = np.random.RandomState(2).rand(2, 1, 8, 12).astype(np.float32)
    want = np.asarray(apply_network(j_spec(cfg), jp, jnp.asarray(x), js,
                                    train=not bn_eval)[0])
    net = Network(generator_spec(get_config("gray-3", env_override=False)),
                  jp, js, device="cpu")
    gen = make_generator_fn(net, bn_eval=bn_eval)
    np.testing.assert_allclose(gen(torch.from_numpy(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("lr_input", [False, True])
@pytest.mark.parametrize("bn_eval", [False, True])
def test_full_sr_fn_matches_jax(fixture_weights, lr_input, bn_eval):
    """The slice end to end on the CPU: make_full_sr_fn, per-image BN
    statistics in train mode, with the full-width fixture."""
    cfg, jp, js = fixture_weights
    n, side = (2, 16) if lr_input else (2, 24)
    imgs = np.random.RandomState(3).rand(n, 1, side, side - 4).astype(np.float32)
    want = np.asarray(j_full_sr_fn(cfg, bn_eval=bn_eval, lr_input=lr_input)(
        jp, js, jnp.asarray(imgs)))
    net, msg = load_generator(get_config("gray-3", env_override=False),
                              FIXTURE, need_state=True, device="cpu")
    assert msg.startswith("loaded checkpoint")
    got = make_full_sr_fn(net, bn_eval=bn_eval, lr_input=lr_input)(
        torch.from_numpy(imgs)).numpy()
    scale = 2 if lr_input else 1
    assert got.shape == (n, 1, scale * side, scale * (side - 4))
    np.testing.assert_allclose(got, want, **TOL)
    # per-image statistics: an image's result does not depend on its batch
    solo = make_full_sr_fn(net, bn_eval=bn_eval, lr_input=lr_input)(
        torch.from_numpy(imgs[1:2])).numpy()
    np.testing.assert_allclose(solo[0], got[1], **TOL)


def test_sr_full_image_returns_lr(fixture_weights):
    _, jp, js = fixture_weights
    net = Network(generator_spec(get_config("gray-3", env_override=False)),
                  jp, js, device="cpu")
    img = torch.rand(20, 14, generator=torch.Generator().manual_seed(4))
    hr, lr = sr_full_image(make_generator_fn(net), img)
    assert hr.shape == (20, 14) and lr.shape == (10, 7)
    assert bool(torch.isfinite(hr).all())


def test_load_generator_errors(tmp_path):
    cfg = get_config("gray-3", env_override=False)
    with pytest.raises(ValueError, match="ema"):
        load_generator(cfg, FIXTURE, ema=True, device="cpu")
    with np.load(FIXTURE) as data:
        keep = {k: data[k] for k in data.files if not k.startswith("_state_")}
    path = str(tmp_path / "nostate_net_G.npz")
    np.savez(path, **keep)
    with pytest.raises(ValueError, match="state"):
        load_generator(cfg, path, need_state=True, device="cpu")
    net, _ = load_generator(cfg, path, device="cpu")     # parity BN is fine
    assert net.device.type == "cpu"
    net, msg = load_generator(cfg, None, device="cpu")
    assert "random init" in msg
