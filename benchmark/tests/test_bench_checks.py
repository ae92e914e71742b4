"""The check that decides `correct`, on the CPU at small sizes: sound runs
pass it; the control (the reference in float8 in the program's place)
fails one of each cell's limits; and a run whose timed path is broken
underneath (the harness's look for a card skipped, everything else as in a
run) comes out not correct, once for each fault the cell can have.  On the
card, `test_control_fails_at_the_cells_size` reads the control at the
cells' own sizes."""

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.small import SMALL, run_small

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _limits(name):
    return harness.cell_files(name)[0]["limits"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(name):
    code, res, _, err = run_small(name)
    assert code == 0, err[-2000:]
    assert res["correct"], err[-2000:]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    r = calibrate.readings(name, 3, 1.0, ["control"], torch.device("cpu"),
                           SMALL[name])["control"]
    lim = _limits(name)
    assert any(r[k] > v for k, v in lim.items()), (r, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    for seed in (101, 102, 103):
        r = calibrate.readings(name, seed, 3.0, ["control"], card)["control"]
        lim = _limits(name)
        assert any(r[k] > v for k, v in lim.items()), (seed, r, lim)


def _swap_first(t):
    t = t.clone()
    t[0] = t[1] if t.shape[0] > 1 else t[0].flip(-1)
    return t


def _repeat_half(t):
    t = t.clone()
    h = t.shape[0] // 2
    t[h:2 * h] = t[:h]
    return t


def _wrap_outputs(monkeypatch, module, fn_name, fix):
    orig = getattr(module, fn_name)

    def make(*a, **kw):
        run = orig(*a, **kw)

        def broken(x):
            out = run(x)
            if isinstance(out, dict):
                return {k: fix(v) for k, v in out.items()}
            return fix(out)
        return broken

    monkeypatch.setattr(module, fn_name, make)


def _state_unchanged(monkeypatch):
    import dcgan_sr_tpu_torch.train.step as step
    monkeypatch.setattr(step, "adam_update_", lambda *a, **k: None)


def _half_batch(monkeypatch):
    import dcgan_sr_tpu_torch.train.multi_step as ms
    orig = ms.build_train_step

    def build(cfg, **kw):
        step = orig(cfg, **kw)
        return lambda state, hr, *a, **k: step(state, hr[:hr.shape[0] // 2],
                                               *a, **k)

    monkeypatch.setattr(ms, "build_train_step", build)


def _replay_unchanged(monkeypatch):
    """Every call of the runner after its first (the eager chunk and the
    capture), that is every replay, leaves the parameters unchanged."""
    import dcgan_sr_tpu_torch.train.multi_step as ms
    from dcgan_sr_tpu_torch.train.step import params_of
    orig = ms.MultiStep.__call__

    def call(self, state, hr):
        first = not getattr(self, "called", False)
        self.called = True
        if first:
            return orig(self, state, hr)
        leaves = params_of(state.g) + params_of(state.d)
        keep = [t.clone() for t in leaves]
        out = orig(self, state, hr)
        with torch.no_grad():
            for t, k in zip(leaves, keep):
                t.copy_(k)
        return out

    monkeypatch.setattr(ms.MultiStep, "__call__", call)


def _tiled(fn_name, fix):
    def plant(monkeypatch):
        import dcgan_sr_tpu_torch.infer.tiled as tiled
        _wrap_outputs(monkeypatch, tiled, fn_name, fix)
    return plant


FAULTS = [
    ("gray3-train-bf16", "state_unchanged", _state_unchanged),
    ("gray3-train-bf16", "half_batch", _half_batch),
    ("gray3-train-bf16", "replay_unchanged", _replay_unchanged),
    ("overlap-bulk-bf16", "answer_altered",
     _tiled("make_overlap_sr_fn", _swap_first)),
    ("overlap-bulk-bf16", "half_batch",
     _tiled("make_overlap_sr_fn", _repeat_half)),
    ("gray3-bulk-bf16", "answer_altered",
     _tiled("make_full_sr_fn", _swap_first)),
    ("gray3-bulk-bf16", "half_batch", _tiled("make_full_sr_fn", _repeat_half)),
]


@pytest.mark.parametrize("name,fault,plant", FAULTS,
                         ids=[f"{n}-{f}" for n, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, plant, monkeypatch):
    plant(monkeypatch)
    code, res, _, err = run_small(name)
    assert code == 0, err[-2000:]
    assert not res["correct"], err[-2000:]
