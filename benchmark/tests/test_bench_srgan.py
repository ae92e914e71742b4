"""The two cells added with SRGAN's generator, on the CPU at their small
sizes (benchmark/conftest.py): `srgan-bulk-bf16` (driver bulk_srresnet)
and `gray3-train-fp32` (train_chunk in fp32).  Sound runs are correct; the
control and planted faults are not; the frozen reference is the port's
reference; the two span readers read synthetic totals."""

import dataclasses

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.reference import srgan as R
from benchmark.tests.small import SMALL, run_small
from benchmark.tests.test_bench_checks import (_half_batch, _repeat_half,
                                               _replay_unchanged,
                                               _state_unchanged,
                                               _swap_first, _tiled)
from dcgan_sr_tpu_torch.utils import profiling

CELL = "srgan-bulk-bf16"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    return harness.cell_files(CELL)[1]


def test_counts_of_the_work():
    c = _config()
    assert R.conv_flops(c, 1) == 2 * 2_218_176
    assert R.conv_flops(c, 256) * 16 == pytest.approx(4.652e12, rel=1e-3)
    shapes = R.layer_shapes(c, 256)
    assert len(shapes) == 37 and shapes[-1] == (64, 3, 9, 1024)
    assert R.least_bytes(c, 256, 2) > 2 * 3 * (256 ** 2 + 1024 ** 2)


def test_the_frozen_reference_is_the_ports():
    from dcgan_sr_tpu_torch.core import MODELS
    from dcgan_sr_tpu_torch.models import generator_spec
    from dcgan_sr_tpu_torch.reference import srgan as P

    c = _config()
    m = dataclasses.asdict(MODELS["srgan-x4"])
    assert R.spec(c) == P.spec(c) == generator_spec(MODELS["srgan-x4"])
    assert all(m[k] == c[k] for k in m if k in c)
    params, state = R.draw(c, torch.Generator().manual_seed(2))
    x = torch.rand((1, 3, 8, 8), generator=torch.Generator().manual_seed(3))
    for precision in ("fp32", "fp8"):
        assert torch.equal(R.forward(params, state, x, precision=precision),
                           P.forward(params, state, x, precision=precision))


def test_a_sound_run_is_correct_and_counts_its_layers():
    code, res, _, err = run_small(CELL)
    assert code == 0, err[-2000:]
    assert res["correct"], err[-2000:]
    assert set(res["metrics"]) == {"sr_mp_per_s", "setup_s"}
    line = [ln for ln in err.splitlines() if ln.startswith("run: ")][0]
    import json
    counters = json.loads(line[5:])["notes"]["counters"]
    calls = res["attempted"]
    assert counters["residual"] == 17 * calls
    assert counters["shuffle"] == 2 * calls
    assert counters["prelu"] == 19 * calls
    # on the CPU every BN layer runs the plain code, which counts no kernel
    # launch and no plain CUDA call
    assert counters["bn.bn_apply_bf16"] == 0
    assert counters["bn.plain_cuda_calls"] == 0


def test_a_traced_run_reads_the_new_spans():
    code, res, _, err = run_small(CELL, trace=1)
    assert code == 0, err[-2000:]
    for m in ("residual_share.sr", "shuffle_share.sr", "bn_share.sr",
              "conv_share.sr", "mfu.sr"):
        assert res["metrics"][m]["value"] > 0, m
    assert res["metrics"]["residual_share.sr"]["value"] < 100


def test_control_and_planted_faults_fail():
    r = calibrate.readings(CELL, 4, 1.0, ["program", "control",
                                           "fault_swap", "fault_half"],
                           torch.device("cpu"), SMALL[CELL])
    lim = harness.cell_files(CELL)[0]["limits"]
    assert all(r["program"][k] <= v for k, v in lim.items()), r["program"]
    for kind in ("control", "fault_swap", "fault_half"):
        assert any(r[kind][k] > v for k, v in lim.items()), (kind, r[kind])


FAULTS = [
    ("srgan-bulk-bf16", "answer_altered",
     _tiled("make_full_sr_fn", _swap_first)),
    ("srgan-bulk-bf16", "half_batch", _tiled("make_full_sr_fn", _repeat_half)),
    ("gray3-train-fp32", "state_unchanged", _state_unchanged),
    ("gray3-train-fp32", "half_batch", _half_batch),
    ("gray3-train-fp32", "replay_unchanged", _replay_unchanged),
]


@pytest.mark.parametrize("name,fault,plant", FAULTS,
                         ids=[f"{n}-{f}" for n, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, plant, monkeypatch):
    plant(monkeypatch)
    code, res, _, err = run_small(name)
    assert code == 0, err[-2000:]
    assert not res["correct"], err[-2000:]


def _t(device_s):
    return {"count": 1, "host_s": 0.0, "device_s": device_s,
            "self_device_s": device_s}


SR = {"sr.generator": _t(0.8), "conv": _t(0.5), "bn": _t(0.06),
      "act": _t(0.05), "residual": _t(0.04), "shuffle": _t(0.02),
      "cast": _t(0.001)}


@pytest.mark.parametrize("name,part", [("residual_share.sr", 0.04),
                                       ("shuffle_share.sr", 0.02)])
def test_the_readers_on_synthetic_totals(name, part, monkeypatch):
    read = harness.load_reader(name)
    ctx = harness.Context(None, None, {}, {}, {})
    monkeypatch.setattr(profiling, "span_totals", lambda: SR)
    assert read(ctx) == pytest.approx(100 * part / 0.8)
    # none recorded, or only another path's spans
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "span_totals",
                        lambda: {"sr.generator": _t(1.0), "conv": _t(0.5)})
    assert read(ctx) is None
