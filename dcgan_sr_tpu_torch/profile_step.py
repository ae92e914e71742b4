"""Where a training step's host and device time go, from torch.profiler.

  python -m dcgan_sr_tpu_torch.profile_step --config gray-3 --steps 3

The counterpart of the JAX CLI's `--profile-dir`: it runs a few warm steps of
the trainer's own step (train/step.py) on the procedural source, then
profiles `--steps` more, queued without waiting in between as the training
loop queues them, and prints

  - the wall time per step and the host's time to queue one;
  - the device's busy share: the sum of its kernels' and copies' time over
    the profiled wall time (not printed on the CPU, which has no device);
  - the operators that cost the host most (self CPU time) and the kernels
    that cost the device most.

`--trace FILE` also writes the Chrome trace.  It runs on the first CUDA
device unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .cli import patch_grid
from .core import get_config
from .data.synthetic import SyntheticImages
from .train.step import build_train_step, init_train_state
from .utils.device import pick_device


def _device_us(event):
    """Self device time of a profiler row in us (the attribute was renamed
    from `cuda` to `device` between PyTorch releases)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def profile_steps(cfg, state, batches, steps, warm=2, trace=None, top=12):
    """Profile `steps` steps after `warm` unprofiled ones; returns the
    summary dict that `main` prints."""
    step = build_train_step(cfg)
    cuda = state.g.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for i in range(warm):
        step(state, batches[i % len(batches)])
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(state, batches[i % len(batches)])
        queued = time.perf_counter() - t0
        sync()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)
    # operator rows repeat their kernels' device time: count kernel rows only
    rows = prof.key_averages()
    kernels = [r for r in rows if r.device_type == DeviceType.CUDA]
    device_us = sum(_device_us(r) for r in kernels)
    by_host = sorted((r for r in rows if r.device_type == DeviceType.CPU),
                     key=lambda r: -r.self_cpu_time_total)[:top]
    by_device = sorted(kernels, key=lambda r: -_device_us(r))[:top]
    return {
        "steps": steps,
        "step_ms": wall / steps * 1e3,
        "host_queue_ms": queued / steps * 1e3,
        "device_busy_share": device_us * 1e-6 / wall if cuda else None,
        "host_top": [(r.key, r.count, r.self_cpu_time_total / steps * 1e-3)
                     for r in by_host],
        "device_top": [(r.key, r.count, _device_us(r) / steps * 1e-3)
                       for r in by_device],
        "launches_per_step": sum(r.count for r in kernels) / steps,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="gray-3")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    cfg = get_config(args.config)
    state = init_train_state(cfg, torch.Generator().manual_seed(args.seed),
                             device=device)
    src = SyntheticImages(cfg.fineSize, nc=cfg.nc, seed=1234)
    batches = []
    for i in range(2):
        hr = src.load_batch(i, cfg.images_consumed_per_step)
        if cfg.patch_based:
            hr = patch_grid(hr, cfg.patchSize)
        if cfg.data_range == "pm1":
            hr = hr * 2 - 1
        batches.append(torch.from_numpy(np.ascontiguousarray(hr)).to(device))
    r = profile_steps(cfg, state, batches, args.steps, trace=args.trace)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{cfg.variant} batch {tuple(batches[0].shape)} on {where}: "
          f"step {r['step_ms']:.3f} ms, host queues a step in "
          f"{r['host_queue_ms']:.3f} ms", flush=True)
    if r["device_busy_share"] is not None:
        print(f"device busy share: {r['device_busy_share']:.4f} "
              f"({r['launches_per_step']:.0f} kernels and copies per step)")
    for title, key in (("host, self CPU ms per step", "host_top"),
                       ("device, self ms per step", "device_top")):
        print(title + ":")
        for name, count, ms in r[key]:
            print(f"  {ms:10.4f}  x{count // max(r['steps'], 1):<5d} {name[:90]}")
    return r


if __name__ == "__main__":
    main()
