"""The port's train step (train/step.py) against the JAX package's
build_train_step: the same initial state (the JAX init, carried across as
numpy) and the same two numpy batches through both, at NGF 4, NDF 8, B 8,
64x64, on the CPU.  On the JAX side K1 runs in interpret mode wherever the
case switches it on; on the port's side the step always goes through
ops.preprocess.preprocess, which runs its plain version on a CPU tensor.

Three snapshots per case: "first" (one step from the common init),
"second" (the port's own second step against the JAX package's second
step) and "resumed" (the port restarted from the JAX state after step 1,
carried across as numpy, then one step on the second batch: a step with
non-zero Adam moments, t = 2 and moved running statistics, free of the
first step's sign flips described below).

Tolerances:
  losses         rtol 1e-4 ("first", "resumed"): fp32 sums in XLA:CPU's and
                 oneDNN's orders, through eleven conv layers.  "second":
                 rtol 2e-3 / atol 2e-4 as in tests/test_step_parity_torch.py,
                 because its parameters already differ by Adam's flips.
  gradients      read back from Adam's first moment ("first": m = (1 -
                 beta1) * g from zero; "resumed": the same m_prev on both
                 sides).  D: rtol 1e-3 / atol 1e-6, or 1e-5 of the leaf's
                 largest |gradient| where that is more (fp32 sums of O(1)
                 terms leave that on an element near zero).  G: rtol 1e-3 plus 1e-2
                 of the leaf's largest |gradient|: G's gradient comes
                 through up to five train-mode BNs whose backward cancels
                 nearly equal fp32 sums, and a float64 run of the port's own
                 step (test_fp32_gradient_noise_is_shared) shows the JAX
                 package's fp32 gradients and the port's equally far from
                 it, up to 5.4e-3 of a leaf's scale.
  running stats  rtol 1e-4 / atol 1e-6 ("second": rtol 2e-3 / atol 1e-5).
  updated leaves Adam is sign-like in its first steps (beta1 .5, v ~ 1e-3
                 g^2), so a last-bit gradient difference on a near-zero
                 element flips a whole +-lr step: max |diff| < 2.1 lr per
                 step taken, and at most max(8, 5%) of a leaf's elements
                 off by more than 5e-5 (tests/test_step_parity_torch.py)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dcgan_sr_tpu.core import get_config as j_get_config
from dcgan_sr_tpu.models import (apply_network as j_apply_network,
                                 discriminator_spec as j_discriminator_spec)
from dcgan_sr_tpu.train.step import (build_train_step as j_build_train_step,
                                     init_train_state as j_init_train_state)
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.ops import preprocess as P
from dcgan_sr_tpu_torch.train.step import (build_train_step, init_train_state,
                                           state_from_numpy, state_to_numpy)

import torch_threads  # noqa: F401

NGF, NDF, B = 4, 8, 8
FIELDS = ("g_params", "g_state", "g_opt", "d_params", "d_state", "d_opt",
          "g_ema_params")
METRICS = ("errD", "errD_real", "errD_real_reported", "errD_fake", "errG",
           "pixel_loss")
# case -> (variant, config overrides, channels of the fed batch)
CASES = {
    "gray-3": ("gray-3", {}, 1),
    "gray-3-pallas": ("gray-3", {"use_pallas": True}, 1),
    "gray": ("gray", {}, 1),
    "gray-device-preprocess": ("gray", {"device_preprocess": True}, 3),
    "rgb-full": ("rgb-full", {}, 3),
    "gray-2": ("gray-2", {}, 1),
    "gray-3-pixel-gan-ema": ("gray-3", {"pixel_loss_weight": 10.0,
                                        "gan_weight": 0.5, "g_ema": 0.9}, 1),
    # the pure-reconstruction regime: no adversarial gradient reaches G
    "gray-3-pixel-only": ("gray-3", {"pixel_loss_weight": 100.0,
                                     "gan_weight": 0.0}, 1),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j_fields(st):
    return {f: _np_tree(getattr(st, f)) for f in FIELDS}


@functools.lru_cache(maxsize=None)
def _run(case):
    """{"first" | "second" | "resumed": (jax metrics, jax state fields, port
    metrics, port state fields)} and the port's config."""
    variant, over, chans = CASES[case]
    kw = dict(env_override=False, ngf=NGF, ndf=NDF, batchSize=B, **over)
    jcfg, cfg = j_get_config(variant, **kw), get_config(variant, **kw)
    jstep = jax.jit(j_build_train_step(jcfg))
    tstep = build_train_step(cfg)
    rng = np.random.RandomState(7)
    batches = rng.rand(2, B, chans, 64, 64).astype(np.float32)
    if not (cfg.device_preprocess or cfg.data_range != "pm1"):
        batches = batches * 2 - 1

    def snap(jst, tst, hr):
        jst, jm = jstep(jst, jnp.asarray(hr))
        tst, tm = tstep(tst, torch.from_numpy(hr))
        return jst, tst, ({k: float(v) for k, v in jm.items()}, _j_fields(jst),
                          {k: float(v) for k, v in tm.items()},
                          state_to_numpy(tst))

    jst0 = j_init_train_state(jcfg, jax.random.PRNGKey(3))
    tst0 = state_from_numpy(cfg, _j_fields(jst0), device="cpu")
    out = {}
    jst1, tst1, out["first"] = snap(jst0, tst0, batches[0])
    resumed = state_from_numpy(cfg, _j_fields(jst1), device="cpu")
    _, _, out["second"] = snap(jst1, tst1, batches[1])
    _, _, out["resumed"] = snap(jst1, resumed, batches[1])
    return cfg, out


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _pairs(want, got):
    want, got = _leaves(want), _leaves(got)
    assert [p for p, _ in want] == [p for p, _ in got]
    return [(jax.tree_util.keystr(p), w, g)
            for (p, w), (_, g) in zip(want, got)]


LOOSE = {"first": False, "second": True, "resumed": False}
G_NOISE = 1e-2     # of a leaf's largest |gradient|; see the module docstring


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_match(case):
    _, snaps = _run(case)
    for which, (jm, _, tm, _) in snaps.items():
        tol = (dict(rtol=2e-3, atol=2e-4) if LOOSE[which]
               else dict(rtol=1e-4, atol=1e-7))
        assert sorted(tm) == sorted(jm) == sorted(METRICS)
        for k in METRICS:
            assert np.isfinite(tm[k])
            np.testing.assert_allclose(tm[k], jm[k], err_msg=f"{k} {which}",
                                       **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match(case):
    cfg, snaps = _run(case)
    scale = 1.0 / (1.0 - cfg.beta1)
    for which in ("first", "resumed"):
        _, jf, _, tf = snaps[which]
        for net in ("g", "d"):
            for name, w, g in _pairs(jf[f"{net}_opt"]["m"],
                                     tf[f"{net}_opt"]["m"]):
                big = np.abs(w * scale).max()
                atol = G_NOISE * big if net == "g" else max(1e-6, 1e-5 * big)
                np.testing.assert_allclose(
                    g * scale, w * scale, rtol=1e-3, atol=atol,
                    err_msg=f"{net} grad {name} {which}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_updated_leaves_match(case):
    cfg, snaps = _run(case)
    fields = ["g_params", "d_params"] + (["g_ema_params"] if cfg.g_ema else [])
    for which, (_, jf, _, tf) in snaps.items():
        steps_apart = 2 if which == "second" else 1
        for f in fields:
            for name, w, g in _pairs(jf[f], tf[f]):
                assert g.shape == w.shape and g.dtype == np.float32
                diff = np.abs(g - w)
                assert diff.max() < steps_apart * 2.1 * cfg.lr, \
                    f"{f}{name} {which}"
                n_off = int((diff > 5e-5).sum())
                assert n_off <= max(8, 0.05 * diff.size), \
                    f"{f}{name} {which}: {n_off}/{diff.size} elements off"


@pytest.mark.parametrize("case", sorted(CASES))
def test_running_statistics_match(case):
    _, snaps = _run(case)
    for which, (_, jf, _, tf) in snaps.items():
        for f in ("g_state", "d_state"):
            for name, w, g in _pairs(jf[f], tf[f]):
                assert not np.array_equal(w, np.zeros_like(w))
                np.testing.assert_allclose(
                    g, w, rtol=2e-3 if LOOSE[which] else 1e-4,
                    atol=1e-5 if LOOSE[which] else 1e-6,
                    err_msg=f"{f}{name} {which}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_adam_state_matches(case):
    _, snaps = _run(case)
    for which in ("second", "resumed"):
        _, jf, _, tf = snaps[which]
        for net in ("g", "d"):
            jo, to = jf[f"{net}_opt"], tf[f"{net}_opt"]
            assert int(to["t"]) == int(jo["t"]) == 2
            assert to["t"].dtype == np.int32
        assert (tf["g_ema_params"] is None) == (jf["g_ema_params"] is None)
    _, jf, _, tf = snaps["resumed"]
    for net in ("g", "d"):
        for name, w, g in _pairs(jf[f"{net}_opt"]["v"], tf[f"{net}_opt"]["v"]):
            # v = (1 - beta2) g^2 (+ beta2 v_prev): twice the gradient's noise
            atol = 2 * G_NOISE * np.abs(w).max() if net == "g" else 1e-12
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=atol,
                                       err_msg=f"{net} v{name}")


def test_fp32_gradient_noise_is_shared():
    """The port's step in float64, from the same fp32 initial values, on
    gray-3's first batch: D's gradients of both fp32 runs agree with it to
    1e-3; G's are BOTH within G_NOISE of a leaf's scale of it, so the
    G-gradient difference between the packages is fp32 noise that each has,
    not a difference of the step."""
    cfg, snaps = _run("gray-3")
    _, jf, _, tf = snaps["first"]
    jst0 = j_init_train_state(
        j_get_config("gray-3", env_override=False, ngf=NGF, ndf=NDF,
                     batchSize=B), jax.random.PRNGKey(3))
    st = state_from_numpy(cfg, _j_fields(jst0), device="cpu")
    st.g.double(), st.d.double()
    for opt in (st.g_opt, st.d_opt):
        opt["m"] = [m.double() for m in opt["m"]]
        opt["v"] = [v.double() for v in opt["v"]]
    hr = np.random.RandomState(7).rand(2, B, 1, 64, 64).astype(np.float32)[0]
    build_train_step(cfg, preprocess_fn=P.preprocess_plain)(
        st, torch.from_numpy(hr).double())
    exact = state_to_numpy(st)
    for net, tol in (("g", None), ("d", 1e-3)):
        for fields in (jf, tf):
            for name, w, g in _pairs(exact[f"{net}_opt"]["m"],
                                     fields[f"{net}_opt"]["m"]):
                atol = G_NOISE * np.abs(w).max() if net == "g" else 1e-6
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol,
                                           err_msg=f"{net} {name}")


@pytest.mark.parametrize("variant,size", [("gray-3", 64), ("gray-patch", 8),
                                          ("gray-patch-batch", 8)])
def test_discriminator_families_match(variant, size):
    """Both D families (dcgan64, patch8) in train mode against the JAX
    package's apply_network: the output, the logits under `logits=True`, and
    the running statistics after two passes in a row (real, then fake)."""
    kw = dict(env_override=False, ngf=NGF, ndf=NDF)
    jcfg, cfg = j_get_config(variant, **kw), get_config(variant, **kw)
    jst = j_init_train_state(jcfg, jax.random.PRNGKey(5))
    st = state_from_numpy(cfg, _j_fields(jst), device="cpu")
    rng = np.random.RandomState(0)
    xs = rng.rand(2, 6, 1, size, size).astype(np.float32)
    spec = j_discriminator_spec(jcfg)
    head_off = tuple(dict(l, act=None) if l.get("act") == "sigmoid" else l
                     for l in spec)
    want_logits, _ = j_apply_network(head_off, jst.d_params, jnp.asarray(xs[0]),
                                     jst.d_state, train=True)
    js = jst.d_state
    for x in xs:
        want, js = j_apply_network(spec, jst.d_params, jnp.asarray(x), js,
                                   train=True)
    with torch.no_grad():
        logits = st.d(torch.from_numpy(xs[0]), logits=True)
        for x in xs:
            got = st.d(torch.from_numpy(x), track_stats=True)
    assert tuple(got.shape) == (6,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    for name, w, g in _pairs(_np_tree(js), state_to_numpy(st)["d_state"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)


def test_tracking_statistics_needs_the_unfused_network():
    from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
    cfg = get_config("gray-3", env_override=False, ngf=NGF, ndf=NDF)
    spec = generator_spec(cfg)
    net = Network(spec, *init_network(spec, torch.Generator().manual_seed(0)),
                  device="cpu")
    with pytest.raises(ValueError, match="fuse=False"):
        net(torch.zeros((1, 1, 8, 8)), track_stats=True)


def test_gray2_reports_scaled_real_loss():
    cfg, snaps = _run("gray-2")
    assert cfg.report_scale_real == 100000
    tm = snaps["first"][2]
    np.testing.assert_allclose(tm["errD_real_reported"],
                               tm["errD_real"] * 100000, rtol=1e-6)


def test_state_round_trips_through_numpy():
    cfg = get_config("gray-3", env_override=False, ngf=NGF, ndf=NDF, g_ema=0.5)
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    st.g_opt["t"] = 5
    back = state_to_numpy(state_from_numpy(cfg, state_to_numpy(st), "cpu"))
    for (pa, a), (pb, b) in zip(_leaves(state_to_numpy(st)), _leaves(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    assert int(back["g_opt"]["t"]) == 5


def test_step_goes_through_the_preprocess_function():
    """The optional argument is what the step calls, once per step, with the
    flags of cfg.device_preprocess."""
    cfg = get_config("gray", env_override=False, ngf=NGF, ndf=NDF,
                     device_preprocess=True)
    calls = []

    def spy(x, **kw):
        calls.append(kw)
        return P.preprocess_plain(x, **kw)

    st = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    hr = torch.rand((4, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    build_train_step(cfg, preprocess_fn=spy)(st, hr)
    assert calls == [{"rgb_to_gray": True, "to_pm1": True}]


def test_bf16_feed_is_upcast():
    cfg = get_config("gray-3", env_override=False, ngf=NGF, ndf=NDF)
    hr = torch.rand((4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    out = []
    for feed in (hr.bfloat16(), hr.bfloat16().float()):
        st = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        _, m = build_train_step(cfg)(st, feed)
        out.append(float(m["errG"]))
    assert out[0] == out[1]


def test_g_gradient_does_not_leak_into_d():
    """gan_weight scales only G's pullback: D's update is the same for any
    weight, so err_g's gradient never reaches D's parameter gradients."""
    hr = torch.rand((4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    d_after = []
    for w in (1.0, 7.0):
        cfg = get_config("gray-3", env_override=False, ngf=NGF, ndf=NDF,
                         gan_weight=w)
        st = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        build_train_step(cfg)(st, hr)
        d_after.append([m.clone() for m in st.d_opt["m"]])
    for a, b in zip(*d_after):
        assert torch.equal(a, b)


@pytest.mark.parametrize("option", [
    {"compute_dtype": "bfloat16"}, {"fast_ops": True},
    {"compact_params": True}, "axis_name"])
def test_unported_options_raise(option, tmp_path):
    if option == "axis_name":
        # ported: the step builds with a data axis, and over a world of one
        # (a gloo group in this process) it is the single-device step, bit
        # for bit; two and four ranks: tests/test_torch_dp.py
        import torch.distributed as dist
        from dcgan_sr_tpu_torch.parallel import (create_mesh,
                                                 initialize_distributed)
        cfg = get_config("gray-3", env_override=False, ngf=NGF, ndf=NDF,
                         batchSize=2)
        hr = torch.from_numpy(np.random.RandomState(1).rand(
            2, 1, 64, 64).astype(np.float32))
        initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                               backend="gloo")
        try:
            dstep = build_train_step(cfg, axis_name=create_mesh())
            st = [init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu") for _ in range(2)]
            _, dm = dstep(st[0], hr)
        finally:
            dist.destroy_process_group()
        _, m = build_train_step(cfg)(st[1], hr)
        assert {k: float(v) for k, v in dm.items()} == \
            {k: float(v) for k, v in m.items()}
        a, b = state_to_numpy(st[0]), state_to_numpy(st[1])
        for f in FIELDS[:-1]:
            for (_, x), (_, y) in zip(_leaves(a[f]), _leaves(b[f])):
                np.testing.assert_array_equal(x, y)
        with pytest.raises(TypeError, match="parallel.Mesh"):
            build_train_step(cfg, axis_name="data")
        return
    # ported: each builds, and its steps are held to the JAX package's in
    # tests/test_torch_bf16_step.py, test_torch_fast_ops.py and
    # test_torch_compact.py
    cfg = get_config("gray-3", env_override=False, **option)
    assert callable(build_train_step(cfg))
