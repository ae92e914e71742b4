"""The data-parallel mesh over `torch.distributed` (port of
dcgan_sr_tpu/parallel/mesh.py).

The JAX package's mesh is a 1-D array of devices with the batch on axis
`data`; one process drives all of a host's chips.  Here one process drives
one card (or, under gloo, the CPU), so a mesh is a process group: the
ranks are the replicas, and the axis is the group.  `Mesh` carries what a
collective needs (the group, this rank, the group's size) and where this
rank's tensors live.

Launch model: one process per card, started by `python -m
torch.distributed.run` (torchrun), which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT.  `initialize_distributed` reads them (or takes
an explicit rank, world size and `init_method`, as the tests and
`multihost_demo` do) and joins the default process group: NCCL on CUDA,
gloo on the CPU.  A rank on a card calls `torch.cuda.set_device(LOCAL_RANK)`
first, so that `utils.device.pick_device` returns its own card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: `group` (None: the default group), this
    process's `rank` in it and its `size`, the axis name (cfg.data_axis in
    the JAX package) and the `device` this rank's tensors live on."""
    group: Any
    rank: int
    size: int
    axis_name: str
    device: torch.device

    @property
    def backend(self):
        return dist.get_backend(self.group)


def launched():
    """Whether this process was started by a launcher (WORLD_SIZE set): the
    port's counterpart of the JAX CLI's `jax.device_count() > 1`.  A world
    of one started by a launcher is still data parallel."""
    return "WORLD_SIZE" in os.environ


def initialize_distributed(init_method=None, world_size=None, rank=None,
                           backend=None):
    """Join the default process group, once per process.

    With no arguments, from the launcher's environment (`env://`: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  `backend` defaults to NCCL when
    a card is visible and gloo otherwise; a `--cpu` run passes "gloo".  A
    rank on a card sets its device (LOCAL_RANK) before it calls this.  A
    second call in the same process is a no-op."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)


def initialize_from_env(cpu=False):
    """An entry point's data-parallel start under a launcher: the card of
    LOCAL_RANK becomes this process's device (unless `cpu`), the default
    group is joined (NCCL, or gloo with `cpu`), and the mesh over it is
    returned."""
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    initialize_distributed(backend="gloo" if cpu else "nccl")
    return create_mesh(device=torch.device("cpu") if cpu else None)


def device_count():
    """The replicas of the data axis: the world size (1 outside a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(n_devices=None, axis_name="data", device=None):
    """The 1-D mesh over ranks 0 .. n_devices - 1 of the default group (all
    of them by default).  Every rank calls it, as `dist.new_group` requires;
    a rank outside a mesh of fewer ranks gets None.  `device` defaults to
    this process's card under NCCL and to the CPU otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: start the "
                           "ranks with python -m torch.distributed.run (or "
                           "call initialize_distributed)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world} "
                         "(start that many ranks)")
    group = None
    if n_devices is not None and n_devices < world:
        group = dist.new_group(list(range(n_devices)))
        if dist.get_rank() >= n_devices:
            return None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), axis_name=axis_name,
                device=torch.device(device))


def local_batch_slice(global_batch: int, process_count=None,
                      process_index=None) -> slice:
    """This rank's slice of a global batch: the i-th of n equal runs.

    Every rank draws the same global batch and keeps its slice (the JAX
    package's per-host feed; here every rank is a host).
    `process_count` / `process_index` default to the world size and this
    rank; pass them explicitly to simulate ranks in tests."""
    n = device_count() if process_count is None else process_count
    if process_index is not None:
        i = process_index
    else:
        i = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // n
    start = i * per
    return slice(start, start + per)
