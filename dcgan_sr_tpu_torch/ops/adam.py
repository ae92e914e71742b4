"""Adam with exact torch/optim (Torch7) semantics, over a list of parameter
tensors (port of dcgan_sr_tpu/ops/adam.py).

    m <- b1*m + (1-b1)*g
    v <- b2*v + (1-b2)*g^2
    x <- x - lr*sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)

The epsilon sits OUTSIDE the bias correction of sqrt(v), which is why this is
not `torch.optim.Adam` (that one divides by sqrt(v_hat) + eps).  Defaults:
lr 2e-4, beta1 0.5 (train.lua:18-19), beta2 0.999, eps 1e-8.

The update runs in place on the device as `torch._foreach_*` passes over the
whole list: a handful of launches for a network, not a handful per leaf.
The step count `t` is a 0-d int32 tensor on the parameters' device, advanced
in place, and the step size is computed from it there in fp32, as the JAX
package computes it (`beta ** float32(t)`); the update is JAX's
p - (step_size * m) / (sqrt(v) + eps), with the step size as a tensor
operand.  So nothing returns to the host (the price: nine scalar launches
for the step size, and one more pass over the moments than a host-side
step size needs; timed against that form in chip_smoke.py phase 22), and a CUDA graph that captures the
update advances `t` on every replay (train/multi_step.py).
"""

from __future__ import annotations

import torch


def adam_init(params):
    """{"m", "v", "t"}: zero moments shaped like `params` (a list of
    tensors), step count 0 (int32, on the first parameter's device)."""
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params],
            "t": torch.zeros((), dtype=torch.int32,
                             device=params[0].device)}


@torch.no_grad()
def adam_update_(params, grads, state, *, lr=2e-4, beta1=0.5, beta2=0.999,
                 eps=1e-8):
    """One Adam step, in place on `params` (a list of tensors) and `state`
    (`t` included)."""
    t = state["t"]
    t.add_(1)
    tf = t.float()
    step_size = lr * torch.sqrt(1.0 - torch.pow(beta2, tf)) \
        / (1.0 - torch.pow(beta1, tf))
    m, v = state["m"], state["v"]
    grads = list(grads)
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, grads, alpha=1.0 - beta1)
    torch._foreach_mul_(v, beta2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, eps)
    # p + (-1) * (upd / denom) is p - upd / denom exactly: one pass
    upd = torch._foreach_mul(m, step_size)
    torch._foreach_addcdiv_(params, upd, denom, value=-1.0)
