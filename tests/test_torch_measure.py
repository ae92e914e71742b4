"""The port's measurement helpers (dcgan_sr_tpu_torch/utils/measure.py) and
its CSV metrics file (utils/logging.py MetricsLogger(csv_path=)) against the
JAX package's, on the CPU.

median_spread: identical results on seeded lists.  timed_scan: one warm-up
call, then `reps` timed calls; seconds per iteration.  The CSV logger: the
same header and values as the JAX logger's for the same rows (`wall`, the
seconds since the logger started, excepted), the header only in a new
file, and the JSONL records alike."""

import csv
import json
import time

import numpy as np
import pytest
import torch

from dcgan_sr_tpu.utils import logging as JL
from dcgan_sr_tpu.utils import measure as JM
from dcgan_sr_tpu_torch.utils import logging as TL
from dcgan_sr_tpu_torch.utils import measure as TM

import torch_threads  # noqa: F401


@pytest.mark.parametrize("n,nd", [(1, 3), (2, 0), (5, 4), (8, 6), (13, 2)])
def test_median_spread_equals_jax(n, nd):
    reps = list(np.random.RandomState(n).rand(n) * 100)
    assert TM.median_spread(reps, nd) == JM.median_spread(reps, nd)
    assert TM.median_spread(list(reversed(reps)), nd) == \
        JM.median_spread(reps, nd)


def test_timed_scan_warms_up_then_times_reps_calls():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.02)
        return torch.tensor(float(len(calls)))   # a scalar tensor is fenced

    t = TM.timed_scan(fn, (3,), reps=4, k=5)
    assert calls == [3] * 5                       # reps + 1
    # four calls of >= 20 ms over 4 x 5 iterations: >= 4 ms an iteration
    assert 0.004 <= t < 0.05, t


def test_timed_scan_takes_a_python_scalar():
    n = []
    assert TM.timed_scan(lambda: n.append(1) or 2.0, (), reps=3, k=1) >= 0
    assert len(n) == 4


ROWS = [(1, 0, 3, 0.5, 0.01, {"errG": 1.25, "errD": 0.5, "mse": 0.125}),
        (1, 1, 3, 0.25, 0.02, {"errG": np.float32(1.5), "errD": 0.75,
                               "mse": torch.tensor(0.0625)}),
        (2, 0, 3, 0.125, 0.0, {"errG": 2.0, "errD": 1.0, "mse": 0.03125})]


def _write(mod, tmp, tag, rows):
    csv_path, jsonl_path = tmp / f"{tag}.csv", tmp / f"{tag}.jsonl"
    lines = []
    log = mod.MetricsLogger(jsonl_path=str(jsonl_path),
                            csv_path=str(csv_path), log_fn=lines.append)
    for r in rows:
        # the JAX logger takes floats; the port's also takes tensors
        r = r if mod is TL else r[:5] + ({k: float(v) for k, v in
                                          r[5].items()},)
        log.log_step(*r)
    log.close()
    return csv_path, jsonl_path, lines


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_csv_logger_writes_the_jax_loggers_header_and_rows(tmp_path):
    got = _write(TL, tmp_path, "port", ROWS)
    want = _write(JL, tmp_path, "jax", ROWS)
    assert got[2] == want[2]                      # the stdout lines
    g, w = _csv(got[0]), _csv(want[0])
    assert g[0] == w[0] == ["epoch", "step", "time", "data_time", "wall",
                            "errG", "errD", "mse"]
    wall = g[0].index("wall")
    assert len(g) == len(w) == 1 + len(ROWS)
    for a, b in zip(g[1:], w[1:]):
        assert a[:wall] + a[wall + 1:] == b[:wall] + b[wall + 1:]
        assert float(a[wall]) >= 0
    for a, b in zip(open(got[1]), open(want[1])):
        a, b = json.loads(a), json.loads(b)
        a.pop("wall"), b.pop("wall")
        assert a == b

    # a second logger on the same files appends rows and no second header
    _write(TL, tmp_path, "port", ROWS[:1])
    _write(JL, tmp_path, "jax", ROWS[:1])
    g, w = _csv(got[0]), _csv(want[0])
    assert len(g) == len(w) == 2 + len(ROWS)
    assert [r[0] for r in g] == [r[0] for r in w]
    assert g.count(g[0]) == 1


def test_csv_logger_without_csv_path_writes_no_csv(tmp_path):
    log = TL.MetricsLogger(jsonl_path=str(tmp_path / "m.jsonl"),
                           stdout=False)
    log.log_step(*ROWS[0])
    log.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.jsonl"]
