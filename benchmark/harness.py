"""One run of one cell: find its pieces by name, set up, measure, check,
print.

  BENCHMARK.json                 which metrics the cell reports
  benchmark/workloads/<cell>.json   config, driver, traffic, dtype, limits
  benchmark/configs/<config>.json   the configuration's sizes
  benchmark/drivers/<driver>.py     Driver(cell): setup, window, release,
                                    readings
  benchmark/metrics/<metric>.py     read(ctx) -> value or None

The result is the last line of standard output: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then `checks`,
each number compared with its limit; the same numbers end standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dcgan_sr_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT, "BENCHMARK.json")


def cell_files(name):
    """(workload dict, config dict) of a cell, found by name."""
    wl = load_json(HERE, "workloads", f"{name}.json")
    if wl["name"] != name:
        raise ValueError(f"workloads/{name}.json names {wl['name']!r}")
    return wl, load_json(HERE, "configs", f"{wl['config']}.json")


def make_driver(name, seed, seconds, device, tracer, overrides=None):
    """The driver of one run of a cell, its files found by name and
    `overrides` ({"config": {...}, "traffic_params": {...}}, the tests'
    small sizes) applied over them."""
    from .common import Cell

    wl, config = cell_files(name)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    wl = {**wl, "traffic_params": {**wl["traffic_params"],
                                   **overrides.get("traffic_params", {})}}
    cell = Cell(name, wl, config, int(seed), float(seconds), device, tracer)
    return importlib.import_module(
        f"benchmark.drivers.{wl['driver']}").Driver(cell)


def cell_metrics(bench, name):
    """(end-to-end metric entries, per-layer metric entries) of a cell.
    An entry without `workloads` is the cell's when the cell reports the
    end-to-end metric it moves (or, end to end, always)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names
                              else [])]
    return e2e, layer


def load_reader(metric):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader reads: the traced stretch, the work
    the driver counted in it, the program's counters over the window, the
    run's end-to-end values and the table of peaks."""

    def __init__(self, cell, trace, work, counters, e2e):
        from . import peaks
        self.cell = cell
        self.trace = trace
        self.work = work
        self.counters = counters
        self.e2e = e2e
        self.peaks = peaks


def card_line(device):
    """An earlier line: the card, its power limit, the host's tag."""
    import torch
    line = {"device": str(device)}
    if device.type == "cuda":
        line["kind"] = torch.cuda.get_device_name(device)
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()
            line["power_limit"] = out[device.index or 0].rsplit(",", 1)[1]
        except (OSError, subprocess.SubprocessError, IndexError):
            line["power_limit"] = None
    from dcgan_sr_tpu_torch.utils.host import machine_fingerprint
    line["host"] = machine_fingerprint()[0]
    return line


def counters_line():
    from dcgan_sr_tpu_torch.ops import bulge, preprocess
    return {"bulge": dict(bulge.launches),
            "bulge_impl": dict(bulge.impl_launches),
            "preprocess": dict(preprocess.launches)}


def run(name, seed, seconds, trace, *, t_start, device=None,
        overrides=None, out=sys.stdout, err=sys.stderr):
    """One run; returns (exit code, result dict or None).  `device` and
    `overrides` ({"config": {...}, "traffic_params": {...}}) are for the
    benchmark's own tests on the CPU; a run from the command line takes
    the card."""
    import torch

    from .common import sync
    from .trace import Tracer

    t_imported = time.perf_counter()
    bench = manifest()
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        print(f"no workload {name!r} in BENCHMARK.json", file=err)
        return 2, None
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < entry["chips"]:
            print(f"{name} needs {entry['chips']} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  " visible", file=err)
            return 3, None
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    e2e, layer = cell_metrics(bench, name)
    tracer = Tracer(bool(trace), lambda: sync(device))
    driver = make_driver(name, seed, seconds, device, tracer, overrides)
    cell = driver.cell

    t_driver = time.perf_counter()
    driver.setup()
    if trace:
        tracer.warm_up()
    sync(device)
    t_ready = time.perf_counter()
    setup_s = t_ready - t_start
    setup_parts = {"imports_s": t_imported - t_start,
                   "card_and_files_s": t_driver - t_imported,
                   "driver_setup_s": t_ready - t_driver}
    before = counters_line()
    res = driver.window()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    after = counters_line()
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = driver.readings()
    check_s = time.perf_counter() - t_check

    limits = cell.workload["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]}
              for k in sorted(limits)}
    correct = (res["failed"] == 0 and res["attempted"] > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))

    values = {**res["metrics"], "setup_s": setup_s}
    metrics = {}
    device_block = {"platform": "gpu" if device.type == "cuda" else "cpu",
                    "kind": (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu"),
                    "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": res["attempted"],
              "failed": res["failed"]}
    if trace:
        reading = tracer.reading
        ctx = Context(cell, reading, res.get("work", {}),
                      res.get("counters", {}), values)
        for m in layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if reading is not None:
            device_block["busy_s"] = reading.busy_s
            device_block["window_s"] = reading.window_s
            result["breakdown"] = {"device_ops": reading.device_ops(),
                                   "idle_gaps": reading.idle()}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_block
    found = forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {found}", file=err)
        return 4, None

    notes = {"card": card_line(device), "setup": setup_parts,
             "check_s": check_s, "readings": readings,
             "notes": res.get("notes", {}),
             "kernel_launches_in_window": {
                 g: {k: after[g][k] - before[g].get(k, 0) for k in after[g]
                     if after[g][k] - before[g].get(k, 0)}
                 for g in after}}
    print("run: " + json.dumps(notes, default=str), file=err)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    result["checks"] = checks
    print(json.dumps(result), file=out)
    out.flush()
    return 0, result


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of "
                                 "BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    code, _ = run(args.workload, args.seed, args.seconds, args.trace,
                  t_start=t_start)
    return code
