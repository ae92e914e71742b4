"""The data-parallel train step (port of dcgan_sr_tpu/parallel/dp.py).

The JAX package shard_maps its step over the batch axis: the batch shards
over the `data` mesh axis, params and optimizer state replicate, BN runs
cross-replica and gradients and losses pmean inside the step.  Here each
rank runs the step of train/step.py with `axis_name=mesh` on its slice of
the batch (`shard_batch`); the state is replicated by construction (every
rank builds it from the same seed or checkpoint) and, so that ranks cannot
start apart, rank 0's copy is broadcast the first time a runner sees a
state (`replicate_state`).  BN's moments and the gradient and loss pmeans
are the only traffic, so the replicas stay bit-equal step after step.
"""

from __future__ import annotations

import weakref

import torch

from .collectives import broadcast_
from .mesh import local_batch_slice


def shard_batch(batch, mesh, batch_dim=0):
    """This rank's slice of every leaf of a global batch (a tensor or numpy
    array, or a device_augment tuple of them), on the mesh's device.

    batch_dim selects the dimension that shards (1 for a (K, B, ...) scan
    super-batch whose leading dim is the step axis)."""
    leaves = batch if isinstance(batch, tuple) else (batch,)
    out = []
    for x in leaves:
        x = torch.as_tensor(x)
        n = x.shape[batch_dim]
        if n % mesh.size:
            raise ValueError(f"a batch of {n} does not shard over "
                             f"{mesh.size} ranks")
        sl = local_batch_slice(n, mesh.size, mesh.rank)
        out.append(x.narrow(batch_dim, sl.start, sl.stop - sl.start)
                   .contiguous().to(mesh.device))
    return tuple(out) if isinstance(batch, tuple) else out[0]


def state_tensors(state):
    """Every tensor of a TrainState: both networks' parameters and running
    statistics, both Adam states (m, v, t) and the EMA copy."""
    out = []
    for net, opt in ((state.g, state.g_opt), (state.d, state.d_opt)):
        out += list(net.parameters()) + list(net.buffers())
        out += list(opt["m"]) + list(opt["v"]) + [opt["t"]]
    return out + list(state.g_ema or [])


def replicate_state(state, mesh):
    """Rank 0's state on every rank, in place."""
    broadcast_(state_tensors(state), mesh)
    return state


class Replicas:
    """Broadcasts rank 0's state the first time it is handed a state (and
    again for another state object), never inside a step."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._last = None

    def __call__(self, state):
        if self._last is None or self._last() is not state:
            replicate_state(state, self.mesh)
            self._last = weakref.ref(state)


def build_dp_train_step(cfg, mesh, **step_kw):
    """Returns train_step(state, hr_batch) running data-parallel over
    `mesh`: hr_batch is this rank's slice (`shard_batch`), the state is
    replicated and updated in place on every rank.  step_kw: those of
    train.step.build_train_step."""
    from ..train.step import build_train_step

    step = build_train_step(cfg, axis_name=mesh, **step_kw)
    replicas = Replicas(mesh)

    def dp_step(state, hr, **kw):
        replicas(state)
        return step(state, hr, **kw)

    return dp_step


def build_dp_multi_step(cfg, mesh, **step_kw):
    """K data-parallel steps a call: train.multi_step.MultiStep with the
    cross-replica step.  hr_batches: this rank's (K, B/size, ...) slice
    (shard_batch(..., batch_dim=1)).  On a card under NCCL a full chunk is
    one CUDA graph with the collectives captured inside it; on the CPU the
    Python loop; a CUDA state under gloo raises (a graph cannot hold gloo's
    collectives)."""
    from ..train.multi_step import MultiStep

    return MultiStep(cfg, axis_name=mesh, **step_kw)
