"""A real multi-process data-parallel run (port of tools/multihost_demo.py).

N processes, one rank each, join one process group; every rank draws the
GLOBAL batch from RandomState(0), keeps only its `local_batch_slice`, and
takes the cross-replica DP train step (parallel/dp.py).  The losses it
prints are replicated: every rank reports the same numbers, and (BN and
gradients being cross-replica) they match a single-process run over the
same global batch whatever the number of ranks.

Two gloo ranks on the CPU, through a file store (or `--coordinator
host:port` for a TCP store):

    python -m dcgan_sr_tpu_torch.multihost_demo --cpu --procs 2 --id 0 \\
        --store /tmp/dp_store &
    python -m dcgan_sr_tpu_torch.multihost_demo --cpu --procs 2 --id 1 \\
        --store /tmp/dp_store

The single-process control: `--procs 1 --id 0`.  Without `--cpu` each rank
takes card `id` (modulo the cards visible) over NCCL.  `--weights DIR`
starts from the latest checkpoint pair in DIR (the `<name>_<epoch>_net_G.npz`
/ `_net_D.npz` files either package writes) instead of the seeded init.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--id", type=int, default=0)
    ap.add_argument("--coordinator", default="localhost:12355",
                    help="host:port of rank 0's TCP store")
    ap.add_argument("--store", default=None,
                    help="a file store's path, in place of --coordinator")
    ap.add_argument("--config", default="gray-3")
    ap.add_argument("--batch", type=int, default=16, help="GLOBAL batch")
    ap.add_argument("--ngf", type=int, default=8)
    ap.add_argument("--ndf", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--weights", default=None,
                    help="directory of a checkpoint pair to start from")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (default: NCCL, a card each)")
    args = ap.parse_args(argv)

    from .core import get_config
    from .parallel import (build_dp_train_step, create_mesh,
                           initialize_distributed, local_batch_slice)
    from .train.checkpoint import latest_epoch, load_checkpoint
    from .train.step import init_train_state

    if not args.cpu:
        torch.cuda.set_device(args.id % torch.cuda.device_count())
    init = (f"file://{args.store}" if args.store
            else f"tcp://{args.coordinator}")
    initialize_distributed(init, args.procs, args.id,
                           backend="gloo" if args.cpu else "nccl")
    try:
        mesh = create_mesh(device=torch.device("cpu") if args.cpu else None)
        cfg = get_config(args.config, env_override=False,
                         batchSize=args.batch, ngf=args.ngf, ndf=args.ndf)
        state = init_train_state(cfg, torch.Generator().manual_seed(1),
                                 device=mesh.device)
        if args.weights:
            state = load_checkpoint(args.weights, cfg.name,
                                    latest_epoch(args.weights, cfg.name),
                                    state)
        step = build_dp_train_step(cfg, mesh)
        b, hw = cfg.step_batch, cfg.train_size
        rng = np.random.RandomState(0)
        out = {}
        for _ in range(args.steps):
            # draw the GLOBAL batch, keep this rank's slice
            full = rng.rand(b, cfg.nc, hw, hw).astype(np.float32)
            local = torch.from_numpy(full[local_batch_slice(b)])
            state, m = step(state, local.to(mesh.device))
            out = {k: float(v) for k, v in m.items()}
        print(json.dumps({"process": mesh.rank, "procs": mesh.size, **out}),
              flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
