"""The per-layer metrics that read the program's spans, against a
hand-made store of span totals: each gives its share of the spans it
names, and None where no span was recorded or the program has none."""

import sys
import types

import pytest

from benchmark import harness, peaks
from dcgan_sr_tpu_torch.utils import profiling

SPAN_METRICS = ("g_share.train", "d_share.train", "bn_share.sr",
                "conv_share.sr", "k2_span_roofline.sr")


def _t(device_s, count=1):
    return {"count": count, "host_s": 0.0, "device_s": device_s,
            "self_device_s": device_s}


TRAIN = {"train.preprocess": _t(0.001, 20), "train.g_forward": _t(0.3, 20),
         "train.d_real": _t(0.03, 20), "train.d_fake_forward": _t(0.01, 20),
         "train.d_fake_pullbacks": _t(0.05, 20),
         "train.g_backward": _t(0.6, 20), "train.adam": _t(0.009, 20),
         # host spans around the replay, not stages
         "train.feed": _t(0.5, 2), "train.replay": _t(2.0, 2),
         "conv": _t(9.0)}
SR = {"sr.extract": _t(0.002, 30), "sr.generator": _t(0.96, 30),
      "sr.stitch": _t(0.001, 30), "sr.seam": _t(0.037, 30),
      "cast": _t(0.001, 60), "conv": _t(0.25, 120), "bn": _t(0.5, 120),
      "act": _t(0.05, 150), "bulge": _t(0.08, 30)}


def _ctx(work=None):
    return harness.Context(None, None, work or {}, {}, {})


def _read(name, store, monkeypatch, work=None):
    monkeypatch.setattr(profiling, "span_totals", lambda: store)
    return harness.load_reader(name)(_ctx(work))


def test_train_shares(monkeypatch):
    whole = 1.0
    assert _read("g_share.train", TRAIN, monkeypatch) == pytest.approx(
        100 * 0.9 / whole)
    assert _read("d_share.train", TRAIN, monkeypatch) == pytest.approx(
        100 * 0.09 / whole)
    dp = {**TRAIN, "train.pmeans": _t(0.25, 20)}
    assert _read("g_share.train", dp, monkeypatch) == pytest.approx(
        100 * 0.9 / 1.25)


def test_sr_shares(monkeypatch):
    whole = 0.002 + 0.96 + 0.001 + 0.037
    assert _read("bn_share.sr", SR, monkeypatch) == pytest.approx(
        100 * 0.5 / whole)
    assert _read("conv_share.sr", SR, monkeypatch) == pytest.approx(
        100 * 0.25 / whole)
    full = {k: v for k, v in SR.items()
            if k not in ("sr.extract", "sr.stitch", "sr.seam")}
    full["sr.degrade"] = _t(0.04, 30)
    assert _read("bn_share.sr", full, monkeypatch) == pytest.approx(
        100 * 0.5 / 1.0)


def test_span_roofline_uses_the_pair_bound(monkeypatch):
    b, ci, cm, co, h, w = 14400, 32, 16, 32, 32, 32
    from benchmark import flops
    ops, nbytes = flops.pair_work(b, ci, cm, co, h, w, 2)
    bound = 30 * max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    got = _read("k2_span_roofline.sr", SR, monkeypatch,
                {"pair_bound_s": bound, "pair_calls": 30})
    assert got == pytest.approx(100 * bound / 0.08)
    assert _read("k2_span_roofline.sr", SR, monkeypatch, {}) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_when_no_span_was_recorded(name, monkeypatch):
    work = {"pair_bound_s": 1e-3, "pair_calls": 1}
    assert _read(name, {}, monkeypatch, work) is None
    # spans of the other path only
    other = SR if name.endswith(".train") else TRAIN
    assert _read(name, other if "roofline" not in name else TRAIN,
                 monkeypatch, work) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_on_a_program_without_spans(name, monkeypatch):
    """An older program: its profiling module has no span_totals."""
    old = types.ModuleType("dcgan_sr_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "dcgan_sr_tpu_torch.utils.profiling",
                        old)
    import dcgan_sr_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiling", old)
    reader = harness.load_reader(name)
    assert reader(_ctx({"pair_bound_s": 1e-3, "pair_calls": 1})) is None
