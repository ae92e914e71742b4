"""The serve cell's knee, found once by a sweep on the card:

  python -m benchmark.sweep --workload overlap-serve-sweep
         --rates 10,20,30 --seconds 10 --seed 7

For each offered rate it runs the cell's open loop at that rate (set-up
anew, the same code as a run) with a traced stretch, and prints one JSON
line: the rate, p50, p95 and p99 of latency, the median latency of the
first and the last fifth of the requests (a backlog that grows shows as a
last fifth far slower than the first), requests a batch, the device's idle
share in the stretch and how late the generator ran.  PERF.md records the
sweep and the rate the cell takes from it (four fifths of the highest rate
with no growing backlog).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness
from .common import sync
from .readers import idle_share
from .trace import Tracer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        tracer = Tracer(True, lambda: sync(device))
        driver = harness.make_driver(args.workload, args.seed, args.seconds,
                                     device, tracer,
                                     {"traffic_params": {"rate": rate}})
        cell = driver.cell
        driver.setup()
        tracer.warm_up()
        res = driver.window()
        driver.release()
        ctx = harness.Context(cell, tracer.reading, {}, res["counters"], {})
        c = res["counters"]
        print(json.dumps({
            "rate": rate, **res["metrics"], "failed": res["failed"],
            "requests_per_batch": c["requests"] / max(c["batches"], 1),
            "device_idle_pct": idle_share(ctx),
            **{k: res["notes"][k] for k in (
                "p99_ms", "first_fifth_p50_ms", "last_fifth_p50_ms",
                "generator_late_ms_max", "generator_late_ms_p95")}}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
