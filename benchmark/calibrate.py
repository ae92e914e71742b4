"""The readings that the limits of a cell are set from, in one process:

  python -m benchmark.calibrate --workload <cell> --seeds 1,2,3
         [--kinds program,control,fault_half] [--seconds 3]

For each seed it sets the cell up, runs a short window (none with
--seconds 0: the trainer's readings come from set-up's calls), frees the
program's state and prints one JSON line a kind: the check's numbers of
the program ("program"), of the control (the reference in float8 in the
program's place, "control"), or of a planted fault (the drivers' `fault_*`
kinds).  The limits in workloads/<cell>.json were set from such lines, as
PERF.md records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness
from .common import sync
from .trace import Tracer


def readings(name, seed, seconds, kinds, device, overrides=None):
    """{kind: readings} of one seed."""
    driver = harness.make_driver(name, seed, seconds, device,
                                 Tracer(False, lambda: sync(device)),
                                 overrides)
    driver.setup()
    win = driver.window() if seconds > 0 else None
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {k: driver.readings(k) for k in kinds}
    if win is not None:
        out["window"] = {"metrics": win["metrics"],
                         "failed": win["failed"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="program,control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.seconds,
                     args.kinds.split(","), device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "s": round(time.perf_counter() - t0, 1), **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
