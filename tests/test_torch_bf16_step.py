"""The port's bf16 train step (train/step.py with compute_dtype "bfloat16")
against the JAX package's bf16 build_train_step on the CPU, for gray-3,
rgb-full and gray-patch-batch at NGF 4 / NDF 8 and a tiny batch: the same
initial state (the JAX init, carried across as numpy) and the same two numpy
batches: the first step from that state, and the second step from the JAX
package's bf16 state after its first (carried across as numpy, as
tests/test_torch_train_step.py's "resumed" snapshot does, so that Adam's
sign flips of the first step are not counted twice).  The JAX package's
fp32 step from the same state on the same batch measures how far bf16
itself moves each quantity, and that sets each tolerance: the port-bf16 to
JAX-bf16 distance is at most twice the JAX-bf16 to JAX-fp32 distance plus a
small floor.

  scalars        the six losses: |diff|, floor 1e-6.
  gradients      read from Adam's moments, leaf by leaf and over each whole
                 network: m = (1 - beta1) g and v = (1 - beta2) g^2 after
                 the first step, and after the second, which both sides
                 start from the same moments, m - m' = (1 - beta1)(g - g').
                 Distance: the Frobenius norm of the difference, floor 1e-3
                 of the JAX bf16 moment's norm.  A zeroed gradient or one
                 taken from half the batch fails this.
  statistics     every BN running statistic: max |diff|, floor 1e-6.
  parameters     Adam's first steps are sign-like, so one gradient element
                 near zero that bf16 rounds the other way moves its
                 parameter by 2 lr: max |diff| < 2.1 lr, and the elements
                 off by more than a quarter of lr number at most twice those
                 of JAX bf16 against fp32, plus 2.

The gray-patch-batch case, the patch variants' batches and the CLI's bf16
run are in tests/test_torch_bf16_patch.py, which shares these helpers."""

import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.train.step import (build_train_step as j_build_train_step,
                                     init_train_state as j_init_train_state)
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.train.step import (build_train_step, state_from_numpy,
                                           state_to_numpy)

import torch_threads  # noqa: F401

NGF, NDF = 4, 8
# case -> (variant, batch of the step: (B, C, H, W)[, config overrides])
CASES = {"gray-3": ("gray-3", (4, 1, 64, 64)),
         "rgb-full": ("rgb-full", (4, 3, 64, 64)),
         "gray-patch-batch": ("gray-patch-batch", (128, 1, 8, 8)),
         # tests/test_torch_fast_ops.py
         "gray-3-fast": ("gray-3", (4, 1, 64, 64), {"fast_ops": True})}
METRICS = ("errD", "errD_real", "errD_real_reported", "errD_fake", "errG",
           "pixel_loss")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fields(st):
    return {f: _np_tree(getattr(st, f)) for f in
            ("g_params", "g_state", "g_opt", "d_params", "d_state", "d_opt",
             "g_ema_params")}


@functools.lru_cache(maxsize=None)
def _run(case):
    """[per step: {"bf16", "fp32" (JAX), "port"}: (metrics, state)], each
    step taken from the JAX bf16 state before it."""
    variant, shape, *over = CASES[case]
    kw = dict(env_override=False, ngf=NGF, ndf=NDF, batchSize=shape[0],
              **(over[0] if over else {}))
    jbf = j_get_config(variant, compute_dtype="bfloat16", **kw)
    j32 = j_get_config(variant, **kw)
    cfg = get_config(variant, compute_dtype="bfloat16", **kw)
    # bf16 op by op, not jitted: XLA rounds each op's result to bf16 as the
    # port does, where one jitted program may keep a fused chain in fp32
    # (measured: rgb-full's errD_fake 0.134490 jitted, 0.134000 op by op,
    # the port 0.134000)
    steps = {"bf16": j_build_train_step(jbf),
             "fp32": jax.jit(j_build_train_step(j32))}
    tstep = build_train_step(cfg)
    rng = np.random.RandomState(11)
    batches = rng.rand(2, *shape).astype(np.float32)
    if cfg.data_range == "pm1":
        batches = batches * 2 - 1
    jst = j_init_train_state(jbf, jax.random.PRNGKey(5))
    out = []
    for hr in batches:
        snap = {}
        tst = state_from_numpy(cfg, _fields(jst), device="cpu")
        tst, m = tstep(tst, torch.from_numpy(hr))
        snap["port"] = ({n: float(v) for n, v in m.items()},
                        state_to_numpy(tst))
        after = {}
        for k, fn in steps.items():
            after[k], m = fn(jst, jnp.asarray(hr))
            snap[k] = ({n: float(v) for n, v in m.items()}, _fields(after[k]))
        jst = after["bf16"]
        out.append(snap)
    return cfg, out


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float64))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _hold(got, want, ref, floor, what):
    """max |got - want| <= 2 * max |want - ref| + floor."""
    d, r = np.abs(got - want).max(), np.abs(want - ref).max()
    assert d <= 2 * r + floor, f"{what}: {d:.3e} > 2 * {r:.3e} + {floor:.1e}"


def _norm(arrays):
    return float(np.sqrt(sum(np.square(a).sum() for a in arrays)))


def _hold_norm(got, want, ref, what):
    """||got - want|| <= 2 ||want - ref|| + 1e-3 ||want||, over lists of
    arrays (one leaf, or every leaf of a network)."""
    d = _norm([g - w for g, w in zip(got, want)])
    r = _norm([w - f for w, f in zip(want, ref)])
    floor = 1e-3 * _norm(want)
    assert d <= 2 * r + floor, f"{what}: {d:.3e} > 2 * {r:.3e} + {floor:.1e}"


def check_losses(case):
    _, snaps = _run(case)
    for i, snap in enumerate(snaps):
        for k in METRICS:
            got, want, ref = (snap[s][0][k] for s in ("port", "bf16", "fp32"))
            assert np.isfinite(got)
            _hold(np.float64(got), np.float64(want), np.float64(ref), 1e-6,
                  f"{k} step {i + 1}")


def check_gradients(case):
    _, snaps = _run(case)
    for i, snap in enumerate(snaps):
        for opt in ("g_opt", "d_opt"):
            for mom in ("m", "v"):
                trees = [_leaves(snap[s][1][opt][mom]) for s in ("port", "bf16",
                                                                  "fp32")]
                assert [n for n, _ in trees[0]] == [n for n, _ in trees[1]]
                for (name, got), (_, want), (_, ref) in zip(*trees):
                    assert got.shape == want.shape
                    _hold_norm([got], [want], [ref],
                               f"{opt}.{mom}{name} step {i + 1}")
                _hold_norm(*([v for _, v in t] for t in trees),
                           f"{opt}.{mom} step {i + 1}")


def check_parameters_and_statistics(case):
    cfg, snaps = _run(case)
    for i, snap in enumerate(snaps):
        for field in ("g_state", "d_state"):
            trees = [_leaves(snap[s][1][field]) for s in ("port", "bf16",
                                                          "fp32")]
            assert [n for n, _ in trees[0]] == [n for n, _ in trees[1]]
            for (name, got), (_, want), (_, ref) in zip(*trees):
                _hold(got, want, ref, 1e-6, f"{field}{name} step {i + 1}")
        for field in ("g_params", "d_params"):
            trees = [_leaves(snap[s][1][field]) for s in ("port", "bf16",
                                                          "fp32")]
            assert [n for n, _ in trees[0]] == [n for n, _ in trees[1]]
            for (name, got), (_, want), (_, ref) in zip(*trees):
                what = f"{field}{name} step {i + 1}"
                assert got.shape == want.shape
                d = np.abs(got - want)
                assert d.max() < 2.1 * cfg.lr, what
                off = int((d > cfg.lr / 4).sum())
                ref_off = int((np.abs(want - ref) > cfg.lr / 4).sum())
                assert off <= 2 * ref_off + 2, f"{what}: {off} elements off"
        # the masters and Adam's moments stay fp32
        for field in ("g_params", "d_params"):
            assert all(v.dtype == np.float32 for v in
                       jax.tree_util.tree_leaves(snap["port"][1][field]))
        for opt in ("g_opt", "d_opt"):
            for mom in ("m", "v"):
                assert all(v.dtype == np.float32 for v in
                           jax.tree_util.tree_leaves(snap["port"][1][opt][mom]))
            assert int(snap["port"][1][opt]["t"]) == i + 1


@pytest.mark.parametrize("case", ["gray-3", "rgb-full"])
def test_bf16_losses_match_jax(case):
    check_losses(case)


@pytest.mark.parametrize("case", ["gray-3", "rgb-full"])
def test_bf16_gradients_match_jax(case):
    check_gradients(case)


@pytest.mark.parametrize("case", ["gray-3", "rgb-full"])
def test_bf16_parameters_and_statistics_match_jax(case):
    check_parameters_and_statistics(case)
