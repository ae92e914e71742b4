"""ops/bn.py on the CPU: the rule that sends BN to the two-pass kernels
(`bn.takes`), and that everything it does not send there keeps the plain
code's results bit for bit.  The kernels themselves run on the card only
(tests/test_torch_bn_cuda.py).

The rule reads only what the input shows: a bf16 CUDA x, no `axis_name`,
and no gradient to carry.  On the CPU it never holds, so ops/nn.py
batch_norm and models/network.py Layer.post compute exactly what the plain
composition computes, and no counter moves.  Layer.post hands a BN layer's
activation to batch_norm, whose plain path opens the `act` span inside the
layer's `bn` span; where the rule holds, a ReLU or leaky ReLU is folded into
the kernels and no `act` span opens: that is held here with the kernel path
stood in for by its plain version.
"""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn, make_overlap_sr_fn
from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
from dcgan_sr_tpu_torch.models.specs import discriminator_spec
from dcgan_sr_tpu_torch.ops import bn as BN
from dcgan_sr_tpu_torch.ops import nn as N
from dcgan_sr_tpu_torch.utils import profiling as prof

BF16 = torch.bfloat16
MODES = ("pooled", "per_image", "groups", "running")


def _stand_in(is_cuda=True, dtype=BF16, requires_grad=False):
    """What `takes` reads of a tensor, without a card."""
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("case,want", [
    (dict(), True),
    (dict(is_cuda=False), False),
    (dict(dtype=torch.float32), False),
    (dict(dtype=torch.float16), False),
    (dict(axis_name=object()), False),
    (dict(x_grad=True), False),
    (dict(scale_grad=True), False),
    (dict(bias_grad=True), False),
    (dict(x_grad=True, grad_mode=False), True),
    (dict(scale_grad=True, bias_grad=True, grad_mode=False), True),
    (dict(grad_mode=False), True),
    (dict(dtype=torch.float32, grad_mode=False), False),
])
def test_the_rule_reads_device_dtype_axis_and_gradients(case, want):
    x = _stand_in(case.get("is_cuda", True), case.get("dtype", BF16),
                  case.get("x_grad", False))
    scale = _stand_in(requires_grad=case.get("scale_grad", False))
    bias = _stand_in(requires_grad=case.get("bias_grad", False))
    with torch.set_grad_enabled(case.get("grad_mode", True)):
        assert BN.takes(x, scale, bias, case.get("axis_name")) is want


def _inputs(dtype, seed=0, shape=(6, 4, 5, 7)):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((1, shape[1], 1, 1), generator=g)
         + torch.randn(shape, generator=g)).to(dtype)
    c = shape[1]
    vec = lambda s, o: o + s * torch.randn(c, generator=g)  # noqa: E731
    return x, vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 0.0), \
        0.5 + torch.rand(c, generator=g)


def _mode_kw(mode):
    return {"pooled": dict(train=True), "per_image": dict(per_image=True),
            "groups": dict(groups=3), "running": dict(train=False)}[mode]


def _plain(x, scale, bias, state, mode, act):
    """The plain composition the CPU must still compute: batch_stats,
    normalize, the activation, and Torch's running update when pooled."""
    kw = _mode_kw(mode)
    if mode == "running":
        mean, var = state["mean"], state["var"]
    else:
        mean, var = N.batch_stats(x, kw.get("per_image", False),
                                  kw.get("groups"))
    y = N.normalize(x, mean, var, scale, bias)
    if act == "relu":
        y = N.relu(y)
    elif act == "lrelu":
        y = N.leaky_relu(y, 0.2)
    elif act == "tanh":
        y = N.tanh(y)
    new = None
    if mode == "pooled":
        n = x.shape[0] * x.shape[2] * x.shape[3]
        new = {"mean": 0.9 * state["mean"] + 0.1 * mean,
               "var": 0.9 * state["var"] + 0.1 * (var * (n / (n - 1)))}
    elif mode == "running":
        new = state
    return y, new


def _bits(t):
    return t.view(torch.int16) if t.dtype == BF16 else t.view(torch.int32)


@pytest.mark.parametrize("act", ["relu", "lrelu", "tanh", None])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_batch_norm_on_the_cpu_is_the_plain_composition(dtype, mode, act):
    x, scale, bias, rmean, rvar = _inputs(dtype)
    state = {"mean": rmean, "var": rvar}
    n0, p0 = dict(BN.launches), BN.plain_cuda_calls
    y, new = N.batch_norm(x, scale, bias, state=state, act=act,
                          **_mode_kw(mode))
    want, want_new = _plain(x, scale, bias, state, mode, act)
    assert y.dtype == dtype and torch.equal(_bits(y), _bits(want))
    if want_new is None:
        assert new is None
    else:
        for k in ("mean", "var"):
            assert torch.equal(new[k], want_new[k])
    assert BN.launches == n0 and BN.plain_cuda_calls == p0


def _bn_act_plain(x, scale, bias, *, running=None, per_image=False,
                  groups=None, eps=1e-5, act=None, slope=None):
    """BN.bn_act's function by the plain ops: (act(normalize(x)), mean,
    var), the statistics from batch_stats or the `running` (mean, var)."""
    if running is None:
        mean, var = N.batch_stats(x, per_image, groups)
    else:
        mean, var = running
    y = N.normalize(x, mean, var, scale, bias, eps)
    if act == "lrelu":
        return N.leaky_relu(y, slope), mean, var
    return (y if act is None else N.ACTIVATIONS[act](y)), mean, var


@pytest.mark.parametrize("act", ["relu", "lrelu", None])
@pytest.mark.parametrize("mode", MODES)
def test_bn_act_plain_is_batch_norm(mode, act):
    x, scale, bias, rmean, rvar = _inputs(BF16, seed=1)
    kw = _mode_kw(mode)
    running = (rmean, rvar) if mode == "running" else None
    y, mean, var = _bn_act_plain(
        x, scale, bias, running=running, act=act, slope=N.LRELU_SLOPE,
        per_image=kw.get("per_image", False), groups=kw.get("groups"))
    want, _ = N.batch_norm(x, scale, bias, state={"mean": rmean,
                                                  "var": rvar}, act=act, **kw)
    assert torch.equal(_bits(y), _bits(want))
    if running is None:
        wm, wv = N.batch_stats(x, kw.get("per_image", False), kw.get("groups"))
        assert torch.equal(mean, wm) and torch.equal(var, wv)


def test_activations_and_rows_refuse_what_they_do_not_take():
    x, scale, bias = torch.zeros((2, 1, 1, 1), dtype=BF16), torch.ones(1), \
        torch.zeros(1)
    with pytest.raises(ValueError, match="act must be one of"):
        BN.bn_act(x, scale, bias, act="tanh")
    with pytest.raises(ValueError, match="needs its slope"):
        BN.bn_act(x, scale, bias, act="lrelu")
    with pytest.raises(ValueError, match="does not split into 4 groups"):
        BN._rows(6, False, 4)
    assert BN._rows(6, True, 4) == (6, 1)
    assert BN._rows(6, False, 3) == (3, 2)
    assert BN._rows(6, False, None) == (1, 6)
    # one table of activations, one slope, for the plain path and the kernel
    assert N.ACTIVATIONS["lrelu"] is N.leaky_relu and N.LRELU_SLOPE == 0.2
    assert set(BN.ACTS) - {None} <= set(N.ACTIVATIONS)


def _net(variant, disc=False):
    cfg = get_config(variant, env_override=False, ngf=4, ndf=8)
    spec = discriminator_spec(cfg) if disc else generator_spec(cfg)
    return cfg, Network(spec, *init_network(spec, torch.Generator()
                                            .manual_seed(0)), device="cpu")


def _outputs(variant, bn_eval):
    cfg, net = _net(variant)
    if variant == "gray-3":
        x = torch.rand((2, 1, 16, 16), generator=torch.Generator()
                       .manual_seed(2))
        return make_full_sr_fn(net, compute_dtype=BF16, bn_eval=bn_eval)(x)
    x = torch.rand((2, 24, 32), generator=torch.Generator().manual_seed(1))
    out = make_overlap_sr_fn(cfg, net, compute_dtype=BF16, fine=(24, 32),
                             bn_eval=bn_eval)(x)
    return torch.cat([out["tiles"].flatten(), out["naive"].flatten()])


def _fold_with_the_plain_version(monkeypatch, calls):
    """Stand the kernel path in with its plain version, and let the rule
    hold on the CPU: what Layer.post and batch_norm then do is what they do
    on the card."""
    def bn_act(x, scale, bias, **kw):
        calls.append(kw["act"])
        return _bn_act_plain(x, scale, bias, **kw)

    monkeypatch.setattr(BN, "takes", lambda *a, **k: True)
    monkeypatch.setattr(BN, "bn_act", bn_act)


@pytest.mark.parametrize("bn_eval", [False, True])
@pytest.mark.parametrize("variant", ["gray-3", "gray-patch-batch-overlap"])
def test_folding_the_activation_keeps_the_generators_bits(variant, bn_eval,
                                                          monkeypatch):
    want = _outputs(variant, bn_eval)
    calls = []
    _fold_with_the_plain_version(monkeypatch, calls)
    got = _outputs(variant, bn_eval)
    assert torch.equal(got, want)
    # every BN layer outside the fused pair, each with its ReLU folded in
    _, net = _net(variant)
    n_bn = sum(1 for i, layer in enumerate(net.spec)
               if layer.get("bn") and i not in net.pairs)
    assert calls == ["relu"] * n_bn


def test_the_discriminator_folds_its_leaky_relu(monkeypatch):
    _, d = _net("gray-3", disc=True)
    x = torch.rand((3, 1, 64, 64), generator=torch.Generator().manual_seed(4))
    want = d(x, compute_dtype=BF16)
    calls = []
    _fold_with_the_plain_version(monkeypatch, calls)
    got = d(x, compute_dtype=BF16)
    assert torch.equal(got, want)
    assert calls == ["lrelu"] * sum(1 for layer in d.spec if layer.get("bn"))


def _span_names(run):
    prof.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    names = [r["name"] for r in prof.span_records()]
    prof.reset_spans()
    return names


def test_a_folded_layer_opens_no_act_span(monkeypatch):
    cfg, net = _net("gray-patch-batch-overlap")
    run = make_overlap_sr_fn(cfg, net, compute_dtype=BF16, fine=(24, 32))
    x = torch.rand((2, 24, 32), generator=torch.Generator().manual_seed(1))
    plain = _span_names(lambda: run(x))
    _fold_with_the_plain_version(monkeypatch, [])
    folded = _span_names(lambda: run(x))
    n_bn = sum(1 for i, layer in enumerate(net.spec)
               if layer.get("bn") and i not in net.pairs)
    assert plain.count("bn") == folded.count("bn") == n_bn
    # the head's sigmoid keeps its span; the BN layers' ReLUs fold in
    assert plain.count("act") == n_bn + 1 and folded.count("act") == 1


def test_training_keeps_the_plain_path_and_its_act_spans():
    """The trainer's G runs under autograd with parameters that require
    grad: on the card the rule sends it to the plain code; on the CPU too."""
    cfg = get_config("gray-3", env_override=False, ngf=4, ndf=8)
    spec = generator_spec(cfg)
    net = Network(spec, *init_network(spec, torch.Generator().manual_seed(0)),
                  device="cpu", fuse=False, trainable=True)
    x = torch.rand((2, 1, 16, 16), generator=torch.Generator().manual_seed(5))
    assert not BN.takes(_stand_in(), net.layers[1].bn_scale,
                        net.layers[1].bn_bias)
    names = _span_names(lambda: net(x, track_stats=True,
                                    compute_dtype=BF16).sum().backward())
    assert names.count("act") == names.count("bn") + 1


def test_a_bn_layers_act_span_lies_inside_its_bn_span():
    """On the plain path a BN layer's activation is batch_norm's, so its
    `act` span is a child of the layer's `bn` span; the head's sigmoid,
    with no BN, keeps a span of its own."""
    cfg, net = _net("gray-patch-batch-overlap")
    run = make_overlap_sr_fn(cfg, net, compute_dtype=BF16, fine=(24, 32))
    x = torch.rand((2, 24, 32), generator=torch.Generator().manual_seed(1))
    prof.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        run(x)
    recs = prof.span_records()
    prof.reset_spans()
    by_id = {r["id"]: r["name"] for r in recs}
    parents = [by_id.get(r["parent"]) for r in recs if r["name"] == "act"]
    n_bn = sum(1 for i, layer in enumerate(net.spec)
               if layer.get("bn") and i not in net.pairs)
    assert parents.count("bn") == n_bn and len(parents) == n_bn + 1


@pytest.mark.parametrize("act", ["sigmoid", "tanh"])
def test_an_activation_the_kernel_lacks_follows_it(act, monkeypatch):
    """batch_norm folds only what BN.ACTS names; another activation runs
    after the kernel path, as on the plain path."""
    x, scale, bias, rmean, rvar = _inputs(BF16, seed=3)
    want, _ = N.batch_norm(x, scale, bias, state=None, act=act)
    calls = []
    _fold_with_the_plain_version(monkeypatch, calls)
    got, _ = N.batch_norm(x, scale, bias, state=None, act=act)
    assert calls == [None] and torch.equal(_bits(got), _bits(want))
