"""The trainer's K-step program around the step, on the CPU: the loop's
`stage_ahead` (train/loop.py, port of dcgan_sr_tpu/train/loop.py), the
CLI's `--stage-ahead` and `--profile-dir`, each against the JAX package's
behaviour, and the launch counting of train/multi_step.py.  The CPU runs
the multi-step runner's eager loop; the CUDA graph of a chunk and the
staged copies are held to the plain loop on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 22)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
from dcgan_sr_tpu_torch import cli
from dcgan_sr_tpu_torch.core import get_config
from dcgan_sr_tpu_torch.ops import bulge, fused_nhwc, preprocess
from dcgan_sr_tpu_torch.train.loop import train_epochs
from dcgan_sr_tpu_torch.train.multi_step import (build_multi_step, counted,
                                                 launches_run)
from dcgan_sr_tpu_torch.train.step import init_train_state, state_to_numpy

import torch_threads  # noqa: F401

TINY = dict(env_override=False, ngf=4, ndf=8)
ENV = {"ngf": "4", "ndf": "8", "batchSize": "4"}


def _quiet(*a, **k):
    pass


def _device_augment_batch(rng, b):
    """A (canvas, tops, lefts, flips) batch as the folder route builds it:
    80x80 RGB canvases, offsets in [0, 16], flips."""
    return (rng.rand(b, 3, 80, 80).astype(np.float32),
            rng.randint(0, 17, b), rng.randint(0, 17, b), rng.rand(b) > 0.5)


@pytest.mark.parametrize("variant,over,feed", [
    ("gray-patch-batch", {}, None),
    ("gray", {"device_augment": True, "device_preprocess": True,
              "batchSize": 4}, torch.bfloat16)])
def test_stage_ahead_equals_the_plain_loop_bit_for_bit(variant, over, feed):
    """tests/test_multi_step.py::test_train_epochs_stage_ahead_equals_plain
    for the port: full chunks and the k = 1 remainder, over two epochs, and
    a batch_fn whose output depends on call order; the same builds in the
    same order, and every leaf of the state equal.  Also with the four
    leaves of a device_augment batch, fed in bf16."""
    cfg = get_config(variant, **TINY, **over)
    rng = np.random.RandomState(13)
    if cfg.device_augment:
        batches = [_device_augment_batch(rng, 4) for _ in range(5)]
    else:
        batches = rng.rand(5, 16, 1, 8, 8).astype(np.float32)
    calls = []

    def batch_fn(e, i):
        calls.append((e, i))
        return batches[i]

    runs = []
    for stage_ahead in (False, True):
        calls.clear()
        st = init_train_state(cfg, torch.Generator().manual_seed(21), "cpu")
        st, m = train_epochs(cfg, st, batch_fn, niter=2, steps_per_epoch=5,
                             log_fn=_quiet, scan_steps=2, feed_dtype=feed,
                             stage_ahead=stage_ahead)
        runs.append((list(calls), float(m["errG"]), state_to_numpy(st)))
    (c0, e0, s0), (c1, e1, s1) = runs
    assert c1 == c0 == [(e, i) for e in (1, 2) for i in range(5)]
    assert e1 == e0 and np.isfinite(e0)
    la, lb = (jax.tree_util.tree_leaves_with_path(s) for s in (s0, s1))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def _cli_in_process(monkeypatch, argv):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    return cli.main(["--cpu", "--config", "gray-3", "--synthetic",
                     "--seed", "1", *argv])


def test_cli_scan_stage_ahead_feed_bf16_trains(monkeypatch, capsys, tmp_path):
    """tests/test_cli.py::test_cli_stage_ahead_scan for the port: two
    chunks of two and a single step, finite losses, the graph line (no
    graph on the CPU)."""
    jl = str(tmp_path / "m.jsonl")
    st = _cli_in_process(monkeypatch, ["--steps", "5", "--epochs", "1",
                                       "--scan", "2", "--stage-ahead",
                                       "--feed-bf16", "--metrics-jsonl", jl])
    out = capsys.readouterr().out.splitlines()
    assert "End of epoch 1 / 1" in "\n".join(out)
    recs = [json.loads(ln) for ln in open(jl)]
    assert [r["step"] for r in recs] == [1, 3, 4]
    assert all(np.isfinite(r["errG"]) for r in recs)
    assert int(st.g_opt["t"]) == int(st.d_opt["t"]) == 5
    graph = [ln for ln in out if ln.startswith("graph launches: ")]
    assert len(graph) == 1 and json.loads(graph[0][len("graph launches: "):]) \
        == {"captures": 0, "replays": 0, "captured": {}, "replayed": {}}


def test_cli_profile_dir_writes_a_trace(monkeypatch, capsys, tmp_path):
    prof = tmp_path / "prof"
    _cli_in_process(monkeypatch, ["--steps", "1", "--epochs", "1",
                                  "--profile-dir", str(prof)])
    capsys.readouterr()
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(prof / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)


def test_the_runner_counts_every_kernel_counter():
    """The runner snapshots the counters of every kernel module, so a
    kernel that enters the step has its captured and replayed launches
    kept, not only K1's."""
    cfg = get_config("gray-3", batchSize=2, **TINY)
    run = build_multi_step(cfg)
    keys = {*bulge.launches, *fused_nhwc.launches, *preprocess.launches}
    assert set(counted()) == keys
    assert set(run.captured) == set(run.replayed) == keys


class _Runner:
    """A graph runner's stats(): what launches_run reads."""

    def __init__(self, captured, replayed):
        self.s = {"captures": 1, "replays": 2, "captured": captured,
                  "replayed": replayed}

    def stats(self):
        return {k: dict(v) if isinstance(v, dict) else v
                for k, v in self.s.items()}


@pytest.mark.parametrize("since,want", [
    (None, {"preprocess": 10 - 3 + 6, "bulge_main": 2}),
    ({"captured": {"preprocess": 3}, "replayed": {"preprocess": 3}},
     {"preprocess": 10 + 3, "bulge_main": 2})])
def test_launches_run_is_counted_less_captured_plus_replayed(since, want):
    """A launch captured into a graph is counted once by its wrapper, at
    capture, where it did not run, and runs at every replay; a kernel
    outside the graphs is counted as it ran.  `since` takes a runner's
    stats at the run's start."""
    r = _Runner({"preprocess": 3}, {"preprocess": 6})
    counts = {"preprocess": 10, "bulge_main": 2}
    assert launches_run(counts) == counts
    assert launches_run(counts, r, since) == want
