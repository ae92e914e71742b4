"""K train steps per call (port of dcgan_sr_tpu/train/multi_step.py).

The JAX package scans K steps into one XLA program.  Here the K steps are a
Python loop over a (K, B, C, H, W) super-batch that is already on the
device: no step reads anything back, so the host queues all K before the
device has finished the first, and the stacked metrics are the only thing a
caller waits on.  The body is exactly train.step.build_train_step's step.
"""

from __future__ import annotations

import torch

from .step import build_train_step


def build_multi_step(cfg, **step_kw):
    """Returns multi_step(state, hr_batches) -> (state, stacked_metrics).

    hr_batches: (K, B, C, H, W) — K consecutive batches; under
    cfg.device_augment a tuple of such leaves, (K, B, ...) each.
    stacked_metrics: dict of (K,) tensors (per-step losses, reference
    log-line fields preserved)."""
    step = build_train_step(cfg, **step_kw)

    def multi_step(state, hr_batches):
        per_step = []
        tup = isinstance(hr_batches, tuple)
        for j in range((hr_batches[0] if tup else hr_batches).shape[0]):
            hr = tuple(x[j] for x in hr_batches) if tup else hr_batches[j]
            state, metrics = step(state, hr)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return multi_step
