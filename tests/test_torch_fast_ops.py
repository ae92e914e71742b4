"""The trainer's `--fast-ops` rewrites (dcgan_sr_tpu_torch/ops/fast.py and
models/network.py) against the JAX package's (dcgan_sr_tpu/ops/fast.py and
its fast train step) on the CPU.

Tolerances.  fp32: outputs and gradients at 1e-5 (tests/test_fast_ops.py's;
a gradient's atol is 1e-5 of its largest magnitude), the folded kernels bit
for bit (a gather on both sides).  bf16: tests/test_torch_bf16_nn.py's one
bf16 step (rtol 2^-7 plus 1e-3 of the largest magnitude); the weight
gradient of a folded convolution is rounded to bf16 on both sides (JAX's
plain autodiff of a bf16 convolution, not its k4s2p1 custom VJP), which
these tests check.  The fast train step from one state on one batch:
losses rtol 1e-4 in fp32 and tests/test_torch_train_step.py's gradient
tolerances; in bf16 the rule of tests/test_torch_bf16_step.py, gradients
included."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.models import (apply_network as j_apply_network,
                                 generator_spec as j_generator_spec,
                                 init_network as j_init_network)
from dcgan_sr_tpu.ops import fast as JF
from dcgan_sr_tpu.train.step import (build_train_step as j_build_train_step,
                                     init_train_state as j_init_train_state)
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.models import Network, discriminator_spec, generator_spec
from dcgan_sr_tpu_torch.ops import fast as FT
from dcgan_sr_tpu_torch.train.step import (build_train_step, state_from_numpy,
                                           state_to_numpy)

from test_torch_bf16_step import (check_gradients, check_losses,
                                  check_parameters_and_statistics)

import torch_threads  # noqa: F401

BF = torch.bfloat16
NGF, NDF, B = 4, 8, 4


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close_bf16(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    tol = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} off, max "
                           f"{np.abs(got - want).max():.3e}")


def _close_fp32(got, want, what):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=what)


def test_s2d_roundtrip():
    """tests/test_fast_ops.py's case: pixel_unshuffle / pixel_shuffle are
    the JAX package's space_to_depth / depth_to_space, channel order
    (c, u, v)."""
    x = _rand(2, 3, 8, 8, seed=1)
    y = FT.space_to_depth(torch.from_numpy(x), 2)
    assert tuple(y.shape) == (2, 12, 4, 4)
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(JF.space_to_depth(x, 2)))
    np.testing.assert_array_equal(FT.depth_to_space(y, 2).numpy(), x)
    # folded channel c*4 + u*2 + v holds x[c, 2i+u, 2j+v]
    np.testing.assert_array_equal(y[0, 1].numpy(), x[0, 0, 0::2, 1::2])
    z = _rand(2, 12, 4, 4, seed=2)
    np.testing.assert_array_equal(FT.depth_to_space(torch.from_numpy(z)).numpy(),
                                  np.asarray(JF.depth_to_space(z, 2)))


@pytest.mark.parametrize("kind,shape", [("subpixel", (16, 8, 4, 4)),
                                        ("s2d", (8, 16, 4, 4)),
                                        ("subpixel", (1, 32, 4, 4)),
                                        ("s2d", (32, 1, 4, 4))])
def test_folded_kernels_equal_the_jax_packages(kind, shape):
    w = _rand(*shape, seed=3)
    mine = getattr(FT, f"_{kind}_kernel")(torch.from_numpy(w))
    theirs = getattr(JF, f"_{kind}_kernel")(jnp.asarray(w))
    assert tuple(mine.shape) == theirs.shape
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def _vjp_pair(transposed, ci, co, hw, dtype):
    """(port, jax) of (y, dx, dw) for one fast convolution on the same
    inputs and cotangent."""
    x = _rand(3, ci, hw, hw, seed=2)
    w = _rand(*((ci, co) if transposed else (co, ci)), 4, 4, seed=3,
              scale=0.2)
    jfn = JF.conv_transpose2d_subpixel if transposed else JF.conv2d_s2d
    tfn = FT.conv_transpose2d_subpixel if transposed else FT.conv2d_s2d
    jdt, tdt = (jnp.bfloat16, BF) if dtype == "bf16" else (None, None)
    # bf16 op by op: one jitted program may keep a bf16 result in fp32
    # (tests/test_torch_bf16_step.py); fp32 jitted, one compile a case
    wrap = jax.jit if dtype == "fp32" else (lambda g: g)
    f = functools.partial(jfn, compute_dtype=jdt)
    y = wrap(f)(jnp.asarray(x), jnp.asarray(w))
    cot = _rand(*y.shape, seed=4)
    jdx, jdw = wrap(lambda a, b, c: jax.vjp(f, a, b)[1](c))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cot, y.dtype))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = tfn(tx, tw, compute_dtype=tdt)
    ty.backward(torch.from_numpy(cot).to(ty.dtype))
    return (ty, tx.grad, tw.grad), (y, jdx, jdw)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("transposed,ci,co,hw", [
    (True, 1, 32, 32), (True, 16, 8, 16), (True, 32, 16, 8),
    (False, 1, 64, 64), (False, 8, 16, 32), (False, 32, 1, 16)])
def test_fast_convolutions_and_gradients_match_jax(transposed, ci, co, hw,
                                                   dtype):
    """The shapes of tests/test_fast_ops.py: output, dx and dw.  In bf16
    the output is bf16 and dw is the bf16-rounded gradient of the folded
    kernel, gathered back in fp32, on both sides."""
    (ty, tdx, tdw), (y, jdx, jdw) = _vjp_pair(transposed, ci, co, hw, dtype)
    close = _close_bf16 if dtype == "bf16" else _close_fp32
    assert tuple(ty.shape) == y.shape
    assert tdx.dtype == tdw.dtype == torch.float32
    for what, got, want in (("y", ty, y), ("dx", tdx, jdx), ("dw", tdw, jdw)):
        close(got, want, what)
    if dtype == "bf16":
        assert ty.dtype == BF and y.dtype == jnp.bfloat16
        for dw in (tdw.numpy(), np.asarray(jdw)):
            np.testing.assert_array_equal(
                dw, torch.from_numpy(dw.copy()).to(BF).float().numpy())


@pytest.mark.parametrize("variant", ["gray-3", "gray-patch-batch", "rgb-full"])
def test_fast_generator_matches_jax_and_the_standard_one(variant):
    """tests/test_fast_ops.py's generator case: the unfused port network
    with fast=True against JAX's fast apply_network (1e-5) and against its
    own standard forward (2e-5)."""
    kw = dict(env_override=False, ngf=NGF)
    jcfg, cfg = j_get_config(variant, **kw), get_config(variant, **kw)
    spec = j_generator_spec(jcfg)
    params, state = j_init_network(jax.random.PRNGKey(0), spec)
    params = jax.tree_util.tree_map(np.asarray, params)
    x = _rand(2, cfg.nc, cfg.train_size // 2, cfg.train_size // 2, seed=6)
    want, _ = jax.jit(lambda p, a, st: j_apply_network(spec, p, a, st,
                                                       fast=True))(
        params, jnp.asarray(x), state)
    net = Network(generator_spec(cfg), params, state, device="cpu",
                  fuse=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x), fast=True).numpy()
        ref = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.fixture
def rewritten(monkeypatch):
    """rewritten(net, x): the weight shapes of the layers whose convolution
    ran in its fast form in net(x, fast=True)."""
    seen = []
    for name in ("conv2d_s2d", "conv_transpose2d_subpixel"):
        real = getattr(FT, name)

        def spy(x, w, _real=real, **kw):
            seen.append(tuple(w.shape))
            return _real(x, w, **kw)
        monkeypatch.setattr(FT, name, spy)

    def run(net, x):
        seen.clear()
        with torch.no_grad():
            net(x, fast=True)
        return list(seen)
    return run


def test_fast_ok_takes_k4s2p1_on_even_inputs_only(rewritten):
    """JAX's fast_ok: k 4, s 2, p 1 and the input's H and W both even.  The
    gray-patch-batch generator's first convT starts from a 4x4 input and is
    rewritten; the patch8 discriminator's k3 valid convs never are; an odd
    input is not; the fused pair never is."""
    from dcgan_sr_tpu_torch.models import init_network
    cfg = get_config("gray-patch-batch", env_override=False, ngf=NGF, ndf=NDF)
    g_spec, d_spec = generator_spec(cfg), discriminator_spec(cfg)
    gen = torch.Generator().manual_seed(0)
    g = Network(g_spec, *init_network(g_spec, gen), device="cpu", fuse=False)
    d = Network(d_spec, *init_network(d_spec, gen), device="cpu", fuse=False)
    k4 = [tuple(l.weight.shape) for l in g.layers if l.foldable]
    assert k4 and g_spec[0]["kind"] == "convT"
    assert rewritten(g, torch.rand(2, 1, 4, 4)) == k4
    assert not any(l.foldable for l in d.layers)
    assert rewritten(d, torch.rand(2, 1, 8, 8)) == []
    one = ({"kind": "conv", "cin": 1, "cout": 2, "k": 4, "s": 2, "p": 1,
            "bn": False, "act": None},)
    conv = Network(one, *init_network(one, gen), device="cpu", fuse=False)
    assert rewritten(conv, torch.rand(1, 1, 8, 8)) == [(2, 1, 4, 4)]
    assert rewritten(conv, torch.rand(1, 1, 9, 8)) == []
    assert rewritten(conv, torch.rand(1, 1, 8, 9)) == []
    spec3 = generator_spec(get_config("gray-3", env_override=False, ngf=NGF))
    p3, s3 = init_network(spec3, gen)
    fused = Network(spec3, p3, s3, device="cpu")
    unfused = Network(spec3, p3, s3, device="cpu", fuse=False)
    x = torch.rand(1, 1, 8, 8)
    assert len(rewritten(unfused, x)) == len(rewritten(fused, x)) + 2


@functools.lru_cache(maxsize=None)
def _fp32_step():
    """(jax metrics, jax fields, port metrics, port fields) of one fp32
    fast step from the JAX init, carried across as numpy."""
    kw = dict(env_override=False, ngf=NGF, ndf=NDF, batchSize=B,
              fast_ops=True)
    jcfg, cfg = j_get_config("gray-3", **kw), get_config("gray-3", **kw)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(5))
    fields = {f: jax.tree_util.tree_map(np.asarray, getattr(jst, f))
              for f in ("g_params", "g_state", "g_opt", "d_params",
                        "d_state", "d_opt", "g_ema_params")}
    hr = np.random.RandomState(11).rand(B, 1, 64, 64).astype(np.float32)
    jst, jm = jax.jit(j_build_train_step(jcfg))(jst, jnp.asarray(hr))
    st, tm = build_train_step(cfg)(state_from_numpy(cfg, fields, "cpu"),
                                   torch.from_numpy(hr))
    jf = {f: jax.tree_util.tree_map(np.asarray, getattr(jst, f))
          for f in fields}
    return (cfg, {k: float(v) for k, v in jm.items()}, jf,
            {k: float(v) for k, v in tm.items()}, state_to_numpy(st))


def _pairs(want, got):
    w = jax.tree_util.tree_leaves_with_path(want)
    g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in w] == [p for p, _ in g]
    return [(jax.tree_util.keystr(p), a, b) for (p, a), (_, b) in zip(w, g)]


def test_fast_step_losses_match_jax_fp32():
    _, jm, _, tm, _ = _fp32_step()
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert np.isfinite(tm[k])
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_fast_step_gradients_and_statistics_match_jax_fp32():
    """Gradients from Adam's first moment (tests/test_torch_train_step.py:
    D rtol 1e-3 / 1e-5 of a leaf's scale, G rtol 1e-3 plus 1e-2 of it) and
    the running statistics (rtol 1e-4 / atol 1e-6)."""
    cfg, _, jf, _, tf = _fp32_step()
    scale = 1.0 / (1.0 - cfg.beta1)
    for net in ("g", "d"):
        for name, w, g in _pairs(jf[f"{net}_opt"]["m"], tf[f"{net}_opt"]["m"]):
            big = np.abs(w * scale).max()
            atol = 1e-2 * big if net == "g" else max(1e-6, 1e-5 * big)
            np.testing.assert_allclose(g * scale, w * scale, rtol=1e-3,
                                       atol=atol, err_msg=f"{net} {name}")
        for name, w, g in _pairs(jf[f"{net}_state"], tf[f"{net}_state"]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{net} {name}")


def test_fast_bf16_step_losses_match_jax():
    check_losses("gray-3-fast")


def test_fast_bf16_step_gradients_match_jax():
    """The bf16 fast step's gradients, read from Adam's moments: the rounded
    dw of each folded convolution shows here, not in the losses."""
    check_gradients("gray-3-fast")


def test_fast_bf16_step_parameters_and_statistics_match_jax():
    check_parameters_and_statistics("gray-3-fast")
