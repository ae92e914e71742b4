"""npz checkpoints cross both ways (train/checkpoint.py): one the port saves
loads through the JAX package's load_checkpoint, one the JAX package saves
loads in the port, leaf for leaf and bit for bit, `opt.t` included; EMA
branches, atomic saves and resume numbering follow the JAX package's rules."""

import os

import numpy as np
import pytest
import torch

import jax
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.train import checkpoint as JC
from dcgan_sr_tpu.train.step import init_train_state as j_init_train_state
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.train import checkpoint as TC
from dcgan_sr_tpu_torch.train.step import (build_train_step, init_train_state,
                                           state_to_numpy)

import torch_threads  # noqa: F401

KW = dict(env_override=False, ngf=4, ndf=8, batchSize=4)
FIELDS = ("g_params", "g_state", "g_opt", "d_params", "d_state", "d_opt",
          "g_ema_params")


def _trained(cfg, steps=2):
    st = init_train_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    step = build_train_step(cfg)
    gen = torch.Generator().manual_seed(4)
    for _ in range(steps):
        step(st, torch.rand((4, cfg.nc, 64, 64), generator=gen))
    return st


def _j_fields(st):
    return {f: jax.tree_util.tree_map(np.asarray, getattr(st, f))
            for f in FIELDS}


def _assert_same(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("variant,ema", [("gray-3", 0.0), ("gray-3", 0.9),
                                         ("rgb-full", 0.0)])
def test_port_checkpoint_loads_in_jax(tmp_path, variant, ema):
    cfg = get_config(variant, g_ema=ema, **KW)
    st = _trained(cfg)
    assert TC.save_checkpoint(str(tmp_path), cfg.name, 7, st) == 7
    jcfg = j_get_config(variant, g_ema=ema, **KW)
    tmpl = j_init_train_state(jcfg, jax.random.PRNGKey(0))
    got = JC.load_checkpoint(str(tmp_path), cfg.name, 7, tmpl)
    _assert_same(_j_fields(got), state_to_numpy(st))
    assert int(got.g_opt["t"]) == int(got.d_opt["t"]) == 2
    with np.load(TC.checkpoint_path(str(tmp_path), cfg.name, 7, "G")) as data:
        want = {"params", "state", "opt"} | ({"ema"} if ema else set())
        assert set(data["__branches__"]) == want == JC.npz_branches(data)
        assert data["_opt_/_t_"].dtype == np.int32


@pytest.mark.parametrize("variant,ema", [("gray-3", 0.0), ("gray-3", 0.9),
                                         ("gray", 0.0)])
def test_jax_checkpoint_loads_in_port(tmp_path, variant, ema):
    jcfg = j_get_config(variant, g_ema=ema, **KW)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(2))
    jst.g_opt["t"] = jst.g_opt["t"] + 11
    JC.save_checkpoint(str(tmp_path), jcfg.name, 3, jst)
    cfg = get_config(variant, g_ema=ema, **KW)
    tmpl = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    got = TC.load_checkpoint(str(tmp_path), cfg.name, 3, tmpl)
    _assert_same(state_to_numpy(got), _j_fields(jst))
    assert got.g_opt["t"] == 11 and got.d_opt["t"] == 0
    assert all(p.requires_grad for p in got.g.parameters())


def test_both_packages_write_the_same_file(tmp_path):
    """Same state, saved by each package: the same keys, dtypes and bytes."""
    cfg = get_config("gray-3", g_ema=0.9, **KW)
    st = _trained(cfg, steps=1)
    TC.save_checkpoint(str(tmp_path / "t"), cfg.name, 1, st)
    jcfg = j_get_config("gray-3", g_ema=0.9, **KW)
    jst = JC.load_checkpoint(str(tmp_path / "t"), cfg.name, 1,
                             j_init_train_state(jcfg, jax.random.PRNGKey(0)))
    JC.save_checkpoint(str(tmp_path / "j"), cfg.name, 1, jst)
    for net in "GD":
        with np.load(TC.checkpoint_path(str(tmp_path / "t"), cfg.name, 1, net)) as a, \
                np.load(JC.checkpoint_path(str(tmp_path / "j"), cfg.name, 1, net)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_missing_ema_branch(tmp_path):
    plain = get_config("gray-3", **KW)
    TC.save_checkpoint(str(tmp_path), plain.name, 1, _trained(plain, 1))
    cfg = get_config("gray-3", g_ema=0.9, **KW)
    tmpl = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="no EMA branch"):
        TC.load_checkpoint(str(tmp_path), cfg.name, 1, tmpl)
    got = TC.load_checkpoint(str(tmp_path), cfg.name, 1, tmpl,
                             seed_missing_ema=True)
    for e, p in zip(got.g_ema, got.g.parameters()):
        assert torch.equal(e, p.detach()) and e.data_ptr() != p.data_ptr()


def test_shape_mismatch_raises(tmp_path):
    cfg = get_config("gray-3", **KW)
    TC.save_checkpoint(str(tmp_path), cfg.name, 1, _trained(cfg, 1))
    wide = get_config("gray-3", env_override=False, ngf=8, ndf=8)
    tmpl = init_train_state(wide, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.load_checkpoint(str(tmp_path), cfg.name, 1, tmpl)


def test_latest_epoch_and_paths(tmp_path):
    d = str(tmp_path / "ck")
    assert TC.latest_epoch(d, "run") is None
    os.makedirs(d)
    assert TC.latest_epoch(d, "run") is None
    for name in ("run_2_net_G.npz", "run_10_net_G.npz", "run_11_net_D.npz",
                 "run_12_net_G.npz.tmp", "other_99_net_G.npz"):
        open(os.path.join(d, name), "w").close()
    assert TC.latest_epoch(d, "run") == JC.latest_epoch(d, "run") == 10
    assert (TC.checkpoint_path(d, "run", 4, "G")
            == JC.checkpoint_path(d, "run", 4, "G"))


def test_save_is_atomic_and_leaves_no_tmp(tmp_path):
    cfg = get_config("gray-3", **KW)
    TC.save_checkpoint(str(tmp_path), cfg.name, 1, _trained(cfg, 1))
    assert sorted(os.listdir(tmp_path)) == [f"{cfg.name}_1_net_D.npz",
                                            f"{cfg.name}_1_net_G.npz"]


def test_saved_generator_serves(tmp_path):
    """The trainer's G file loads through load_generator, the serving
    loader, with its running statistics."""
    cfg = get_config("gray-3", **KW)
    st = _trained(cfg)
    TC.save_checkpoint(str(tmp_path), cfg.name, 1, st)
    net, _ = TC.load_generator(
        cfg, TC.checkpoint_path(str(tmp_path), cfg.name, 1, "G"),
        need_state=True, device="cpu")
    x = torch.rand((2, 1, 16, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for mode in ("pooled", "running"):
            np.testing.assert_allclose(net(x, bn_stats=mode).numpy(),
                                       st.g(x, bn_stats=mode).numpy(),
                                       rtol=1e-5, atol=1e-6)
