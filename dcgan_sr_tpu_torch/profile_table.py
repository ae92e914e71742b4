"""The gray-3 training step's time under the trainer's execution knobs: the
port of tools/profile_step.py.  (`python -m dcgan_sr_tpu_torch.profile_step`
is another tool, the torch.profiler summary of a step, and keeps its name.)

  python -m dcgan_sr_tpu_torch.profile_table [--batch 100] [--steps 20]
         [--reps 3] [--fp32] [--ngf N] [--ndf N] [--cpu]

Each row is the trainer's K-step chunk (train/multi_step.py
build_multi_step, K = --steps) for get_config("gray-3", batchSize=B,
compute_dtype=bf16 or fp32, **row), from init_train_state with a seeded
generator, over np.random.RandomState(0).rand(K, B, 1, 64, 64): one
untimed call (on the card the eager warm-up and the CUDA graph capture),
then --reps calls (graph replays), the clock stopped by a fetch of the last
errG (utils/measure.timed_scan).  The rows are the JAX tool's:

  baseline           the standard step
  compact_params     2-D master weights (ops/compact.py)
  fast_ops           the k3s1p1 forms of the k4s2p1 convs (ops/fast.py)
  pallas_preprocess  use_pallas=True
  compact+pallas     compact_params and use_pallas
  g_forward_only     G's forward alone, K calls of a repetition on
                     rand(B, 1, 32, 32), train-mode batch statistics, in
                     the row's dtype

The port's step always runs the fused preprocess kernel (cfg.use_pallas is
read nowhere), so the two `pallas` rows run the same programs as
`baseline` and `compact_params`; they are timed all the same, and their
difference is the run's noise.  G's forward runs the frozen fused copy of
G that serving and the eval run (models/network.py), so its layers 3-4 go
through the fused bulge kernel on a card.  fp32 convolutions run with TF32
off, as on every fp32 path of the port.

It prints the JAX tool's line for each row, a `kernel launches:` line (K1's
launches that ran in each training row, K2's in G's forward), one line
about the `pallas` rows, and last the JAX tool's JSON line
{"dtype", "batch", "ms_per_step"}.  It runs on the first CUDA device unless
--cpu is given (CPU times are not the card's).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .core import get_config
from .models import Network, generator_spec, init_network
from .ops import bulge
from .train.multi_step import build_multi_step, counted, launches_run
from .train.step import init_train_state
from .utils.device import pick_device
from .utils.measure import timed_scan

PALLAS_NOTE = ("pallas_preprocess and compact+pallas run the programs of "
               "baseline and compact_params: the port's step always runs the "
               "fused preprocess kernel (cfg.use_pallas is read nowhere); "
               "their differences are this run's noise")


def variants(batch, dtype, **widths):
    """Row name -> get_config overrides, in the JAX tool's order; `widths`
    (ngf=, ndf=) shrink every row alike."""
    base = dict(batchSize=batch, compute_dtype=dtype, **widths)
    return {
        "baseline": dict(base),
        "compact_params": dict(base, compact_params=True),
        "fast_ops": dict(base, fast_ops=True),
        "pallas_preprocess": dict(base, use_pallas=True),
        "compact+pallas": dict(base, compact_params=True, use_pallas=True),
    }


def time_variant(name, cfg, shape, k, reps, device="cuda", launches=None):
    """Seconds a step of `cfg`'s K-step chunk; `launches`, where given, is
    filled with {kernel: launches the card ran} over the calls."""
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device=device)
    before = counted()
    mstep = build_multi_step(cfg)
    sb = torch.from_numpy(np.random.RandomState(0).rand(k, *shape).astype(
        np.float32)).to(device)
    dt = timed_scan(lambda: mstep(state, sb)[1]["errG"][-1], (), reps, k)
    if launches is not None:
        launches.update(launches_run(
            {key: n - before[key] for key, n in counted().items()}, mstep))
    return dt


def time_forward(cfg, batch, k, reps, device="cuda", launches=None):
    """Seconds a call of G's forward alone on a (batch, 1, 32, 32) input,
    train-mode batch statistics, in cfg's compute dtype; `launches`, where
    given, is filled with the fused pair's launches over the calls."""
    spec = generator_spec(cfg)
    net = Network(spec, *init_network(spec, torch.Generator().manual_seed(0)),
                  device=device)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    xs = torch.from_numpy(np.random.RandomState(0).rand(
        k, batch, 1, 32, 32).astype(np.float32)).to(device)

    @torch.inference_mode()
    def many():
        acc = torch.zeros((), device=device)
        for x in xs:
            acc = acc + net(x, "pooled", compute_dtype=dtype).mean()
        return acc

    before = dict(bulge.launches)
    dt = timed_scan(many, (), reps, k)
    if launches is not None:
        launches.update({key: n - before[key]
                         for key, n in bulge.launches.items()})
    return dt


def main(argv=None, launches=None):
    """The tool; returns its JSON dict.  `launches`, where given, is filled
    with {row: {kernel: launches the card ran}}."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--steps", type=int, default=20,
                    help="K: steps a call (G forwards a call in its row)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--ngf", type=int, default=None,
                    help="width override (CPU smoke runs)")
    ap.add_argument("--ndf", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    device = pick_device(args.cpu)
    dtype = "float32" if args.fp32 else "bfloat16"
    shape = (args.batch, 1, 64, 64)
    widths = {k: v for k, v in (("ngf", args.ngf), ("ndf", args.ndf))
              if v is not None}
    rows = variants(args.batch, dtype, **widths)
    ran = {} if launches is None else launches
    out = {}
    for name, overrides in rows.items():
        cfg = get_config("gray-3", env_override=False, **overrides)
        ran[name] = {}
        dt = time_variant(name, cfg, shape, args.steps, args.reps, device,
                          launches=ran[name])
        out[name] = round(dt * 1e3, 3)
        print(f"{name:20s} {dt * 1e3:7.3f} ms/step "
              f"({args.batch / dt:,.0f} img/s)", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    cfg = get_config("gray-3", env_override=False, **rows["baseline"])
    ran["g_forward_only"] = {}
    fwd = time_forward(cfg, args.batch, args.steps, args.reps, device,
                       launches=ran["g_forward_only"])
    out["g_forward_only"] = round(fwd * 1e3, 3)
    print(f"{'g_forward_only':20s} {fwd * 1e3:7.3f} ms/step", flush=True)

    print("kernel launches: " + json.dumps(
        {name: {k: n for k, n in c.items() if n} for name, c in ran.items()}),
        flush=True)
    print(PALLAS_NOTE, flush=True)
    res = {"dtype": dtype, "batch": args.batch, "ms_per_step": out}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
