"""Tensor-stats telemetry with the reference's print shape (port of
dcgan_sr_tpu/utils/stats.py).

Every sample section prints max/min/sum/std of each intermediate (e.g.
train-gray-2.lua:300-301: `real_none_train-max: ...  real_none_train-min: ...`
/ `-sum: ... -std: ...`).  The lines are the JAX package's, character for
character: the statistics are taken in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_stats(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x, np.float64)
    return {
        "max": float(a.max()),
        "min": float(a.min()),
        "sum": float(a.sum()),
        "std": float(a.std(ddof=1)) if a.size > 1 else 0.0,  # torch std is unbiased
    }


def print_tensor_stats(name, x, log_fn=print):
    s = tensor_stats(x)
    log_fn(f"{name}-max: {s['max']:.8f}  {name}-min: {s['min']:.8f}")
    log_fn(f"{name}-sum: {s['sum']:.8f}  {name}-std: {s['std']:.8f}")
    return s
