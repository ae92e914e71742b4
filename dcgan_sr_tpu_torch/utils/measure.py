"""Timing helpers for the port's measurement tools (port of
dcgan_sr_tpu/utils/measure.py): one home for the methodology, so a fix
lands everywhere at once."""

from __future__ import annotations

import time

import torch


def _fence(v):
    """Wait for `v`: a CUDA synchronise on a card tensor, then fetch the
    scalar (a fence of its own on any device)."""
    if isinstance(v, torch.Tensor) and v.is_cuda:
        torch.cuda.synchronize(v.device)
    return float(v)


def timed_scan(fn, args, reps, k):
    """Warm up with one call, then time `reps` calls of a program that runs k
    iterations each; returns seconds per iteration.

    `fn(*args)` must return a scalar that depends on the whole computation,
    so that waiting for it waits for the work."""
    _fence(fn(*args))
    t0 = time.perf_counter()
    v = 0.0
    for _ in range(reps):
        v = fn(*args)
    _fence(v)
    return (time.perf_counter() - t0) / (reps * k)


def median_spread(reps, nd):
    """(median, [min, median, max]) of a list of rep measurements, rounded to
    `nd` decimals: the spread format every bench JSON line carries."""
    reps = sorted(reps)
    med = reps[len(reps) // 2]
    return med, [round(reps[0], nd), round(med, nd), round(reps[-1], nd)]
