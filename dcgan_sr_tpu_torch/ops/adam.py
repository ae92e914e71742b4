"""Adam with exact torch/optim (Torch7) semantics, over a list of parameter
tensors (port of dcgan_sr_tpu/ops/adam.py).

    m <- b1*m + (1-b1)*g
    v <- b2*v + (1-b2)*g^2
    x <- x - lr*sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)

The epsilon sits OUTSIDE the bias correction of sqrt(v), which is why this is
not `torch.optim.Adam` (that one divides by sqrt(v_hat) + eps).  Defaults:
lr 2e-4, beta1 0.5 (train.lua:18-19), beta2 0.999, eps 1e-8.

The update runs in place on the device as one `torch._foreach_*` pass over
the whole list: a handful of launches for a network, not a handful per
leaf.  The step count `t` is a Python int, so `beta ** t` is exact and the
update never reads a value back from the device; it becomes an int32 array
only in a checkpoint.
"""

from __future__ import annotations

import math

import torch


def adam_init(params):
    """{"m", "v", "t"}: zero moments shaped like `params` (a list of
    tensors), step count 0."""
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params],
            "t": 0}


@torch.no_grad()
def adam_update_(params, grads, state, *, lr=2e-4, beta1=0.5, beta2=0.999,
                 eps=1e-8):
    """One Adam step, in place on `params` (a list of tensors) and `state`."""
    state["t"] += 1
    t = state["t"]
    step_size = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    m, v = state["m"], state["v"]
    grads = list(grads)
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, grads, alpha=1.0 - beta1)
    torch._foreach_mul_(v, beta2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, m, denom, value=-step_size)
