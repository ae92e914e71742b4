"""The port's spans (dcgan_sr_tpu_torch/utils/profiling.py) on the CPU, at
small widths: off they record nothing and never enter record_function; on
(under torch.profiler) the trace holds the SR pipeline's stages, the
generator's layers and the train step's stages in order and nesting;
span_totals() adds counts and self times right; a captured graph's stages
tile its work; outputs and losses are bit-equal with spans on and off."""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn, make_overlap_sr_fn
from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
from dcgan_sr_tpu_torch.train.step import (build_train_step, init_train_state,
                                           state_from_numpy, state_to_numpy)
from dcgan_sr_tpu_torch.utils import profiling as prof

STAGES = ("train.preprocess", "train.g_forward", "train.d_real",
          "train.d_fake_forward", "train.d_fake_pullbacks",
          "train.g_backward", "train.adam")
FINE = (24, 32)


@pytest.fixture(autouse=True)
def empty_store():
    prof.reset_spans()
    yield
    prof.reset_spans()


def _net(variant):
    cfg = get_config(variant, env_override=False, ngf=4, ndf=8)
    spec = generator_spec(cfg)
    return cfg, Network(spec, *init_network(spec, torch.Generator()
                                            .manual_seed(0)), device="cpu")


def _overlap():
    cfg, net = _net("gray-patch-batch-overlap")
    run = make_overlap_sr_fn(cfg, net, compute_dtype=torch.bfloat16,
                             fine=FINE)
    return run, torch.rand((2,) + FINE, generator=torch.Generator()
                           .manual_seed(1))


def _full():
    _, net = _net("gray-3")
    return (make_full_sr_fn(net, compute_dtype=torch.bfloat16),
            torch.rand((2, 1, 16, 16), generator=torch.Generator()
                       .manual_seed(2)))


def _train():
    cfg = get_config("gray-3", env_override=False, ngf=4, ndf=8, batchSize=4)
    base = state_to_numpy(init_train_state(cfg, torch.Generator()
                                           .manual_seed(0), device="cpu"))
    hr = torch.rand((4, 1, 64, 64), generator=torch.Generator().manual_seed(3))
    return cfg, base, hr


def _annotations(p, tmp_path):
    """(name, start us, end us) of every span in the profiler's trace, in
    the order they began."""
    path = str(tmp_path / "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda a: (a[1], -a[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_records_nothing_and_never_enters_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    run, x = _overlap()
    run(x)
    full, lr = _full()
    full(lr)
    cfg, base, hr = _train()
    build_train_step(cfg)(state_from_numpy(cfg, base, device="cpu"), hr)
    assert entered == []
    assert prof.span_totals() == {} and prof.span_records() == []
    assert prof.span("x") is prof.span("y")        # the shared null context
    with profile(activities=[ProfilerActivity.CPU]):
        run(x)
    assert entered and prof.span_records()


def test_overlap_call_spans_in_order_and_nesting(tmp_path):
    run, x = _overlap()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        run(x)
    ann = _annotations(p, tmp_path)
    top = [a for a in ann if a[0].startswith("sr.")]
    assert [a[0] for a in top] == ["sr.extract", "sr.generator", "sr.stitch",
                                   "sr.seam"]
    for a, b in zip(top, top[1:]):
        assert a[2] <= b[1]                          # siblings, no overlap
    gen = top[1]
    layers = [a for a in ann if not a[0].startswith("sr.")]
    assert layers and all(_inside(a, gen) for a in layers)
    names = [a[0] for a in layers]
    assert names[0] == names[-1] == "cast"
    assert {"upsample", "conv", "bn", "act", "bulge"} <= set(names)
    # the records agree with the trace: the layers' parent is sr.generator,
    # save the activation of a BN layer, which lies inside its `bn` span
    recs = prof.span_records()
    assert [r["name"] for r in recs] == [a[0] for a in ann]
    gid = next(r["id"] for r in recs if r["name"] == "sr.generator")
    bn_ids = {r["id"] for r in recs if r["name"] == "bn"}
    assert all(r["parent"] == gid or (r["name"] == "act"
                                      and r["parent"] in bn_ids)
               for r in recs if not r["name"].startswith("sr."))
    assert all(r["parent"] is None for r in recs if r["name"].startswith("sr."))


def test_full_call_spans_in_order_and_nesting(tmp_path):
    full, lr = _full()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        full(lr)
    ann = _annotations(p, tmp_path)
    assert [a[0] for a in ann if a[0].startswith("sr.")] == ["sr.degrade",
                                                             "sr.generator"]
    gen = next(a for a in ann if a[0] == "sr.generator")
    layers = [a for a in ann if not a[0].startswith("sr.")]
    assert [a[0] for a in layers][:3] == ["cast", "upsample", "conv"]
    assert all(_inside(a, gen) for a in layers)
    t = prof.span_totals()
    assert t["bulge"]["count"] == 1 and t["cast"]["count"] == 2


def test_train_step_stages_tile_the_step(tmp_path):
    """The stage spans come in order, one after the other, and every
    operator of the step between the first stage's start and the last
    stage's end runs inside a stage, but for the detach of the losses."""
    cfg, base, hr = _train()
    step = build_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        step(state_from_numpy(cfg, base, device="cpu"), hr)
    ann = _annotations(p, tmp_path)
    stages = [a for a in ann if a[0].startswith("train.")]
    assert [a[0] for a in stages] == list(STAGES)
    for a, b in zip(stages, stages[1:]):
        assert a[2] <= b[1]
    path = str(tmp_path / "trace.json")
    with open(path) as f:
        ops = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in json.load(f)["traceEvents"]
               if e.get("cat") == "cpu_op"]
    lo, hi = stages[0][1], stages[-1][2]
    outside = {o[0] for o in ops if lo <= o[1] and o[2] <= hi
               and not any(_inside(o, s) for s in stages)}
    assert outside <= {"aten::detach", "detach"}, outside
    t = prof.span_totals()
    assert all(t[n]["count"] == 1 for n in STAGES)
    assert t["conv"]["count"] > 0 and t["bn"]["count"] > 0


def test_totals_count_and_self_time_on_nested_spans(monkeypatch):
    """On the CPU device time is host time: a fake clock gives each span a
    known length, and self time is its length less its children's."""
    ticks = iter(float(i) for i in range(100))

    class Clock:
        @staticmethod
        def perf_counter():
            return next(ticks)

    monkeypatch.setattr(prof, "time", Clock)
    monkeypatch.setattr(prof, "_profiler_enabled", lambda: True)
    with prof.span("a"):            # a: 0 .. 7
        with prof.span("b"):        # b: 1 .. 2
            pass
        with prof.span("c"):        # c: 3 .. 6
            with prof.span("b"):    # b: 4 .. 5
                pass
    with prof.span("b"):            # b: 8 .. 9
        pass
    t = prof.span_totals()
    assert {n: v["count"] for n, v in t.items()} == {"a": 1, "b": 3, "c": 1}
    assert t["a"]["host_s"] == t["a"]["device_s"] == 7.0
    assert t["a"]["self_device_s"] == 7.0 - 1.0 - 3.0
    assert t["c"]["device_s"] == 3.0 and t["c"]["self_device_s"] == 2.0
    assert t["b"]["device_s"] == t["b"]["self_device_s"] == 3.0
    recs = prof.span_records()
    assert [(r["name"], r["parent"]) for r in recs] == [
        ("a", None), ("b", recs[0]["id"]), ("c", recs[0]["id"]),
        ("b", recs[2]["id"]), ("b", None)]
    prof.reset_spans()
    assert prof.span_totals() == {}


class _FakeEvent:
    """A timing event on a fake device clock: each record() is one tick
    (1 ms) later than the last."""
    clock = 0
    made = []

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        self.t = None
        _FakeEvent.made.append(self)

    def record(self):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        if self.t is None or other.t is None:
            raise RuntimeError("event not recorded")
        return float(other.t - self.t)


@pytest.mark.parametrize("profiler_on", [False, True])
def test_captured_stages_share_their_boundaries(monkeypatch, profiler_on):
    """Inside capture_stages() a stage marks one boundary event at its end
    (and the first its start too): K steps give 1 + 7K events, each stage
    runs from the boundary before it to its own, and until a replay has
    recorded them the totals hold none; other spans record nothing there,
    profiler or not."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", [])
    cfg, base, hr = _train()
    step = build_train_step(cfg)
    state = state_from_numpy(cfg, base, device="cpu")
    with _profiler(profiler_on):
        with prof.capture_stages():
            for _ in range(2):
                step(state, hr)
    assert len(_FakeEvent.made) == 1 + 7 * 2
    assert prof.span_records() == []
    for e in _FakeEvent.made:                   # as a replay records them
        e.t = None
    assert prof.span_totals() == {}
    for e in _FakeEvent.made:
        e.record()
    t = prof.span_totals()
    assert {n: v["count"] for n, v in t.items()} == dict.fromkeys(STAGES, 2)
    assert all(v["device_s"] == 2e-3 and v["host_s"] == 0.0
               for v in t.values())


def test_a_failed_capture_keeps_no_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    with pytest.raises(ValueError):
        with prof.capture_stages():
            with prof.stage("train.preprocess"):
                raise ValueError("capture failed")
    assert prof._store.graphs == [] and prof._store.capture is None


def test_outputs_and_losses_are_bit_equal_with_spans_on_and_off():
    run, x = _overlap()
    off = run(x)
    with profile(activities=[ProfilerActivity.CPU]):
        on = run(x)
    assert all(torch.equal(off[k], on[k]) for k in off)
    full, lr = _full()
    off = full(lr)
    with profile(activities=[ProfilerActivity.CPU]):
        on = full(lr)
    assert torch.equal(off, on)
    cfg, base, hr = _train()
    step = build_train_step(cfg)
    states, losses = [], []
    for spans in (False, True):
        st = state_from_numpy(cfg, base, device="cpu")
        with _profiler(spans):
            for _ in range(2):
                _, m = step(st, hr)
        states.append(list(st.g.state_dict().values())
                      + list(st.d.state_dict().values())
                      + st.g_opt["m"] + st.g_opt["v"] + st.d_opt["m"]
                      + st.d_opt["v"])
        losses.append({k: v.item() for k, v in m.items()})
    assert losses[0] == losses[1]
    assert all(torch.equal(a, b) for a, b in zip(*states))


def _profiler(on):
    return (profile(activities=[ProfilerActivity.CPU]) if on
            else contextlib.nullcontext())
