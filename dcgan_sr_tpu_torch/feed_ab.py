"""One-process paired A/B of a boolean flag of the training loop: the port
of tools/feed_ab.py.

Feed timings taken in two processes compare two hosts' moods as much as two
feeds: the host's copy bandwidth and the other tenants of a shared machine
drift between runs.  This tool alternates the value of the flag under test
epoch by epoch inside ONE process, in ABBA order (round r runs False, True
when r is even and True, False when it is odd), so both values sample the
same drift, and reports the paired times.

  python -m dcgan_sr_tpu_torch.feed_ab --config rgb-full --steps 32 \\
      --scan 8 --feed-bf16 --rounds 4 --flag stage_ahead [--cpu]

Each epoch is `train/loop.py train_epochs(..., **{flag: value})` over
--steps steps of the synthetic source as the CLI builds it
(cli.build_data), K = --scan steps a chunk (train/multi_step.py: on the
card one CUDA graph replay per chunk after the first), and ends in a
fetched metric, so the clock stops after the device's last step.
`--feed-bf16` ships the batches as bfloat16 (`feed_dtype`, as the CLI's
flag).  The flag must be a boolean keyword of train_epochs (stage_ahead).
Use an even --rounds: an odd last round has no partner.  It runs on the
first CUDA device unless --cpu is given.
"""

from __future__ import annotations

import argparse
import time
import types

import torch

from .cli import build_data
from .core import get_config
from .train.loop import train_epochs
from .train.multi_step import build_multi_step, counted, launches_run
from .train.step import build_train_step, init_train_state
from .utils.device import pick_device


def main(argv=None, launches=None):
    """The tool; `launches`, where given, is filled with {kernel: launches
    the card ran} over every epoch, the warm-up's included
    (train/multi_step.py launches_run)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="rgb-full")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--scan", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--feed-bf16", action="store_true")
    ap.add_argument("--flag", default="stage_ahead",
                    help="boolean train_epochs keyword to alternate")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    device = pick_device(args.cpu)
    cfg = get_config(args.config)
    cfg.manualSeed = 1234
    ns = types.SimpleNamespace(synthetic=True, textured=False,
                               native_loader=False, data_root=None)
    _, batch_fn = build_data(cfg, ns)
    state = init_train_state(cfg, torch.Generator().manual_seed(
        cfg.manualSeed), device=device)
    step_fn = build_train_step(cfg)
    before = counted()
    multi = build_multi_step(cfg) if args.scan > 1 else None
    feed_dtype = torch.bfloat16 if args.feed_bf16 else None

    def run_epoch(state, flag_value):
        t0 = time.perf_counter()
        state, m = train_epochs(cfg, state, batch_fn, step_fn=step_fn,
                                niter=1, steps_per_epoch=args.steps,
                                scan_steps=args.scan, multi_step_fn=multi,
                                feed_dtype=feed_dtype,
                                **{args.flag: flag_value})
        # fetch a metric so the clock stops after the full device chain
        _ = float(list(m.values())[0])
        return state, time.perf_counter() - t0

    state, warm = run_epoch(state, False)  # builds and captures, not scored
    print(f"warmup epoch: {warm:.3f}s", flush=True)

    times = {False: [], True: []}
    wins = 0
    for r in range(args.rounds):
        order = (False, True) if r % 2 == 0 else (True, False)
        for flag_value in order:
            state, dt = run_epoch(state, flag_value)
            times[flag_value].append(dt)
            print(f"round {r} {args.flag}={flag_value}: {dt:.3f}s",
                  flush=True)
        wins += times[True][-1] < times[False][-1]

    for flag_value in (False, True):
        v = sorted(times[flag_value])
        print(f"{args.flag}={flag_value}: median {v[len(v) // 2]:.3f}s  "
              f"all={[round(x, 2) for x in times[flag_value]]}")
    print(f"{args.flag}=True won {wins}/{args.rounds} paired rounds")
    if launches is not None:
        launches.update(launches_run(
            {k: n - before[k] for k, n in counted().items()}, multi))
    return times, wins


if __name__ == "__main__":
    main()
