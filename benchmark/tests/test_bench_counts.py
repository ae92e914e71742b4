"""The FLOP and byte counts, and the arithmetic of the metrics, on shapes
and synthetic timestamps."""

import math
import statistics

import pytest

from benchmark import flops, spec, stats
from benchmark.drivers.bulk_sr import pair_shape
from benchmark.trace import Reading


def _conf(name):
    import json
    import os

    from benchmark import harness
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_overlap_call_flops():
    # 64 images of 64x64: 225 tiles each of 4x4 LR pixels
    g = spec.generator(_conf("gray-patch-batch-overlap"))
    assert round(flops.conv_flops(g, 4) * 64 * 225 / 1e9, 2) == 970.14


def test_gray3_lr256_flops():
    g = spec.generator(_conf("gray-3"))
    assert round(flops.conv_flops(g, 256) / 1e9, 2) == 69.26


def test_flops_match_the_programs_count():
    from dcgan_sr_tpu_torch.attr_overlap import conv_flops
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.models import generator_spec

    for name, hw in (("gray-3", 256), ("gray-patch-batch-overlap", 4)):
        ours = spec.generator(_conf(name))
        port = generator_spec(get_config(name, env_override=False))
        assert flops.conv_flops(ours, hw) == conv_flops(port, hw)


def test_train_step_flops():
    c = _conf("gray-3")
    g, d = spec.generator(c), spec.discriminator(c)
    per = flops.train_step_flops(g, d, 32, 64)
    gf, df = flops.conv_flops(g, 32), flops.conv_flops(d, 64)
    # G: 3 products a layer, the data's gradient left out; D: twice three
    # products and one more pullback to the fake image
    first_g = 2 * 1 * 32 * 16 * 64 * 64
    first_d = 2 * 1 * 64 * 16 * 32 * 32
    assert per == 3 * gf - first_g + 2 * (3 * df - first_d) + df
    assert 4.6e9 < per < 4.7e9


def test_pair_work():
    g = spec.generator(_conf("gray-patch-batch-overlap"))
    assert pair_shape(g, 4, 14400) == (14400, 32, 16, 32, 32, 32)
    ops, nbytes = flops.pair_work(14400, 32, 16, 32, 32, 32, 2)
    # the byte bound of PERF.md's kernel table: 0.564 ms at 3.35 TB/s
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.564, abs=1e-3)
    assert ops / 989e12 < nbytes / 3.35e12
    g3 = spec.generator(_conf("gray-3"))
    assert pair_shape(g3, 256, 16) == (16, 16, 8, 16, 2048, 2048)


def test_percentile_and_rate():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile(xs + [math.inf], 50) == 3.5
    assert stats.percentile([1.0, math.inf], 95) == math.inf
    assert stats.percentile([], 50) is None
    assert stats.rate(300, 10.0) == 30.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_pythons_quartiles():
    xs = [100.0, 101.0, 102.0, 103.0, 104.0, 150.0]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / 102.5)


def test_idle_share_and_breakdown_from_a_synthetic_trace():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 400.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 300.0, "dur": 200.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 700.0,
         "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 900.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 480.0,
         "dur": 250.0},
        {"ph": "i", "cat": "kernel", "name": "skip", "ts": 1.0},
    ]
    r = Reading(ev, window_s=1000e-6)
    # device busy: [0, 500] + [700, 800] + [900, 1000] = 700 us
    assert r.busy_s == pytest.approx(700e-6)
    assert r.device_ops() == [["a", pytest.approx(500e-6)],
                              ["b", pytest.approx(200e-6)]]
    gaps = r.idle()
    assert gaps[0] == ["cpu_op:aten::conv", pytest.approx(200e-6)]
    assert gaps[1][1] == pytest.approx(100e-6)
    secs, n = r.kernel_seconds(lambda name: name == "a")
    assert (secs, n) == (pytest.approx(500e-6), 2)

    from types import SimpleNamespace

    from benchmark import peaks, readers
    ctx = SimpleNamespace(trace=r, work={"flops": 989e12 * 1e-6},
                          peaks=peaks)
    assert readers.idle_share(ctx) == pytest.approx(30.0)
    assert readers.mfu(ctx) == pytest.approx(0.1)
    assert readers.mfu(SimpleNamespace(trace=None, work={}, peaks=peaks)) \
        is None


def test_schedule_gives_every_seed_the_same_work():
    import numpy as np

    from benchmark.drivers.open_loop_serve import schedule
    d1, s1 = schedule(600, 60.0, 10.0, [64, 128, 256], 1)
    d2, s2 = schedule(600, 60.0, 10.0, [64, 128, 256], 2 ** 31 + 5)
    assert sorted(s1) == sorted(s2)
    assert (np.bincount(s1)[[64, 128, 256]] == 200).all()
    assert d1[0] == 0.0 and d1[-1] < 10.0 and (np.diff(d1) >= 0).all()
    assert not np.array_equal(s1, s2)
