"""The trainer's `--compact-params` layout (dcgan_sr_tpu_torch/ops/compact.py)
on the CPU: pack/unpack equal the JAX package's; the compact step is the
standard step bit for bit over three steps (an EMA copy included); Adam
updates the 2-D masters in place; a checkpoint the JAX package writes from
its pack_state loads into the port's compact trainer key for key and is
written back identically; a compact checkpoint resumes only under the flag
and serves as its unpacked weights; the CLI trains, resumes and dumps its
samples with --compact-params --fast-ops."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.models import (discriminator_spec as j_discriminator_spec,
                                 generator_spec as j_generator_spec)
from dcgan_sr_tpu.ops import compact as JC
from dcgan_sr_tpu.train import checkpoint as JCK
from dcgan_sr_tpu.train.step import init_train_state as j_init_train_state
from dcgan_sr_tpu_torch import cli
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.models import discriminator_spec, generator_spec
from dcgan_sr_tpu_torch.ops.compact import (pack_params, pack_state,
                                            unpack_params, unpack_state)
from dcgan_sr_tpu_torch.train import checkpoint as TCK
from dcgan_sr_tpu_torch.train.step import (build_train_step, init_train_state,
                                           params_of, state_from_numpy,
                                           state_to_numpy)

import torch_threads  # noqa: F401

KW = dict(env_override=False, ngf=4, ndf=8, batchSize=4)


def _leaves(tree, path=""):
    """(path, array) of every leaf of a state_to_numpy tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, np.asarray(tree)


def _assert_identical(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def test_pack_unpack_equal_the_jax_packages():
    jcfg = j_get_config("gray-3", **KW)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(0))
    spec = j_generator_spec(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jst.g_params)
    mine, theirs = pack_params(params), JC.pack_params(params)
    for a, b in zip(mine, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == np.shape(b[k])
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert all(p["w"].ndim == 2 for p in mine if "w" in p)
    back = unpack_params([{k: torch.tensor(v) for k, v in p.items()}
                          for p in mine], generator_spec(get_config(
                              "gray-3", **KW)))
    for a, b in zip(back, JC.unpack_params(theirs, spec)):
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    # pack_state on the port's TrainState: the JAX pack_state's leaves
    cfg = get_config("gray-3", **KW)
    fields = {f: jax.tree_util.tree_map(np.asarray, getattr(jst, f))
              for f in ("g_params", "g_state", "g_opt", "d_params", "d_state",
                        "d_opt", "g_ema_params")}
    packed = pack_state(state_from_numpy(cfg, fields, "cpu"),
                        generator_spec(cfg), discriminator_spec(cfg))
    jpacked = JC.pack_state(jst, spec, j_discriminator_spec(jcfg))
    _assert_identical(state_to_numpy(packed), {
        f: jax.tree_util.tree_map(np.asarray, getattr(jpacked, f))
        for f in fields})


def test_compact_step_is_the_standard_step_bit_for_bit():
    """Three steps from one init (with an EMA copy of G): the same losses
    and, after unpack_state, the same state, every leaf bit for bit."""
    states, metrics = [], []
    for compact in (False, True):
        cfg = get_config("gray-3", g_ema=0.9, compact_params=compact, **KW)
        st = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        step, gen, ms = build_train_step(cfg), torch.Generator().manual_seed(1), []
        for _ in range(3):
            _, m = step(st, torch.rand((4, 1, 64, 64), generator=gen))
            ms.append({k: float(v) for k, v in m.items()})
        if compact:
            assert all(p.dim() == 2 for l in st.g.layers
                       for n, p in l.named_parameters() if n == "w")
            assert all(e.dim() == 2 for e, p in zip(st.g_ema, params_of(st.g))
                       if p.dim() == 2)
            st = unpack_state(st, generator_spec(cfg), discriminator_spec(cfg))
        states.append(state_to_numpy(st))
        metrics.append(ms)
    assert metrics[0] == metrics[1]
    _assert_identical(*states)


def test_adam_updates_the_2d_masters_in_place():
    """The masters, their moments and the EMA copy keep their storage
    through a step (a reshape that copied would leave Adam updating a
    temporary); the gradients Adam sees are 2-D."""
    cfg = get_config("gray-3", g_ema=0.5, compact_params=True, **KW)
    st = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tensors = (params_of(st.g) + params_of(st.d) + st.g_opt["m"]
               + st.g_opt["v"] + st.d_opt["m"] + st.d_opt["v"] + st.g_ema)
    ptrs = [t.data_ptr() for t in tensors]
    before = [t.clone() for t in params_of(st.g)]
    build_train_step(cfg)(st, torch.rand((4, 1, 64, 64)))
    assert [t.data_ptr() for t in tensors] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(before, params_of(st.g)))
    for p, m in zip(params_of(st.g), st.g_opt["m"]):
        assert m.shape == p.shape
    assert any(m.dim() == 2 for m in st.g_opt["m"])


def test_jax_pack_state_checkpoint_loads_key_for_key(tmp_path):
    """The JAX package's compact init (pack_state), saved by its
    save_checkpoint, loads into the port's compact trainer and is written
    back with the same keys, shapes and values."""
    jcfg = j_get_config("gray-3", compact_params=True, **KW)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(2))
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    JCK.save_checkpoint(jd, jcfg.name, 1, jst)
    cfg = get_config("gray-3", compact_params=True, **KW)
    tmpl = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    st = TCK.load_checkpoint(jd, cfg.name, 1, tmpl)
    TCK.save_checkpoint(td, cfg.name, 1, st)
    for net in "GD":
        with np.load(TCK.checkpoint_path(jd, cfg.name, 1, net)) as a, \
                np.load(TCK.checkpoint_path(td, cfg.name, 1, net)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["_params_/_1_/_w_"].ndim == 2


def test_compact_checkpoints_resume_only_under_the_flag(tmp_path):
    """A compact checkpoint into a standard template, and a standard one
    into a compact template, raise; each loads under its own flag."""
    for compact in (True, False):
        cfg = get_config("gray-3", compact_params=compact, **KW)
        d = str(tmp_path / str(compact))
        TCK.save_checkpoint(d, cfg.name, 1, init_train_state(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        other = get_config("gray-3", compact_params=not compact, **KW)
        with pytest.raises(ValueError, match="shape mismatch"):
            TCK.load_checkpoint(d, cfg.name, 1, init_train_state(
                other, torch.Generator().manual_seed(1), "cpu"))
        TCK.load_checkpoint(d, cfg.name, 1, init_train_state(
            cfg, torch.Generator().manual_seed(1), "cpu"))


def test_a_compact_checkpoint_serves_as_its_unpacked_weights(tmp_path):
    """load_generator (serve, upscale) reads a compact G file's leaves by
    key, as the JAX package's load_branch does, and unpacks its 2-D
    masters: the same network as from the standard layout's file."""
    nets = []
    for compact in (False, True):
        cfg = get_config("gray-3", compact_params=compact, **KW)
        st = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        d = str(tmp_path / str(compact))
        TCK.save_checkpoint(d, cfg.name, 1, st)
        net, _ = TCK.load_generator(cfg, TCK.checkpoint_path(
            d, cfg.name, 1, "G"), need_state=True, device="cpu")
        nets.append(net)
    for (ka, a), (kb, b) in zip(nets[0].state_dict().items(),
                                nets[1].state_dict().items()):
        assert ka == kb and torch.equal(a, b)
    x = torch.rand((1, 1, 16, 16))
    with torch.no_grad():
        assert torch.equal(nets[0](x, "running"), nets[1](x, "running"))


def _main(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = cli.main(args)
    return st, buf.getvalue().splitlines()


def test_cli_trains_and_resumes_with_compact_params_and_fast_ops(
        tmp_path, monkeypatch):
    for k, v in (("ngf", "4"), ("ndf", "8"), ("batchSize", "4")):
        monkeypatch.setenv(k, v)
    ck, samples = str(tmp_path / "ck"), str(tmp_path / "s")
    flags = ["--cpu", "--config", "gray-3", "--synthetic", "--seed", "1",
             "--compact-params", "--fast-ops", "--checkpoint-dir", ck]
    st, lines = _main(flags + ["--steps", "3", "--scan", "2", "--epochs", "1",
                               "--samples-dir", samples])
    assert "compact_params=True" in lines[0] and "fast_ops=True" in lines[0]
    assert sum(l.startswith("Epoch: [1]") for l in lines) == 2
    # the returned state is the unpacked one the samples were dumped from
    assert all(p.dim() == 4 for l in st.g.layers
               for n, p in l.named_parameters() if n == "w")
    assert any(f.endswith("_sample.png") for f in os.listdir(samples))
    with np.load(TCK.checkpoint_path(ck, "dcgan-sr-tpu", 1, "G")) as data:
        assert data["_params_/_1_/_w_"].ndim == 2
        assert int(data["_opt_/_t_"]) == 3
    st, lines = _main(flags + ["--steps", "2", "--epochs", "2", "--resume"])
    assert "resumed from epoch 1" in lines
    with np.load(TCK.checkpoint_path(ck, "dcgan-sr-tpu", 2, "G")) as data:
        assert data["_params_/_1_/_w_"].ndim == 2
        assert int(data["_opt_/_t_"]) == 5
