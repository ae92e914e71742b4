"""Training throughput (images/s) and overlap SR throughput (MP/s) on one
card: the port of bench.py, the repo's headline measurement.

  python -m dcgan_sr_tpu_torch.bench [--cpu] [--ngf N] [--ndf N]
         [--batch 100] [--patch-images 20] [--steps 20] [--reps 3]
         [--images 64]

The workload is bench.py's (bench.py:38-45): bf16 compute, K = 20 steps a
call, 3 timed repetitions, for

  gray-3           batch 100 of 1x64x64
  rgb-full         batch 100 of 3x64x64
  gray-patch-batch 1,280 tiles of 1x8x8 a step, counted as its 20 images

Each trainer runs the trainer's own K-step path (train/multi_step.py
build_multi_step) from `init_train_state` with a seeded generator, over one
super-batch np.random.RandomState(0).rand(K, *shape) put on the device
once.  The first call runs the chunk eagerly and captures it (on the card)
and is not timed; every timed repetition is one CUDA graph replay of the K
steps, timed by the host clock from before the call until a fetch of the
last errG, which waits for the whole chunk.  The overlap lines are
bench_infer.overlap_record in bf16, parity BN first, then bn_eval.

Everything is measured first; then it prints a `bench_selfcert` header, one
`kernel launches:` line (K1's launches that ran, per trainer; K2's launches
by kernel and by implementation) and the five metric lines in bench.py's
order, gray-3 last.  Every metric line carries the [min, median, max]
spread of its repetitions, the host's tag (utils/host.machine_fingerprint;
the header also carries its description), the CPU anchor, the card's name
and power limit, and `vs_baseline`: the value over the torch-CPU baseline in
BASELINE_MEASURED.json, which this module only reads (bench.py measures and
writes it through the JAX package; a missing key gives null).

`--cpu` runs the same code on the CPU to check the plumbing: every metric
name takes a `cpu_` prefix, no `vs_baseline` is written and `device` is
"cpu".  The other flags shrink the workload for that.  This is not yet a
BENCHMARK.json: no cell, no limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Any, Optional

import numpy as np
import torch

from .bench_infer import overlap_record
from .core import get_config
from .ops import bulge
from .train.multi_step import build_multi_step, counted, launches_run
from .train.step import init_train_state
from .utils.device import pick_device
from .utils.host import machine_fingerprint
from .utils.measure import median_spread

STEPS = 20
REPS = 3
BATCH = 100
PATCH_IMAGES = 20
N_IMAGES = 64
BASELINE_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "BASELINE_MEASURED.json")

# variant -> the config's workload overrides (bench.py:38-45); the step's
# input shape and its image count follow from the config
VARIANTS = {"gray-3": {"batchSize": BATCH}, "rgb-full": {"batchSize": BATCH},
            "gray-patch-batch": {"images_per_step": PATCH_IMAGES}}
TRAIN_ORDER = ("rgb-full", "gray-patch-batch", "gray-3")   # flagship last

# metric -> its key in BASELINE_MEASURED.json
BASELINE_KEYS = {
    "overlap_sr_upscaled_mp_per_sec": "torch_cpu_overlap_mp_per_sec",
    "overlap_sr_upscaled_mp_per_sec_bn_eval": "torch_cpu_overlap_mp_per_sec",
    "train_images_per_sec_rgb_full": "rgb-full",
    "train_images_per_sec_gray_patch_batch": "gray-patch-batch",
    "train_images_per_sec": "gray-3",
}


def train_metric(variant):
    suffix = "" if variant == "gray-3" else "_" + variant.replace("-", "_")
    return "train_images_per_sec" + suffix


def step_shape(cfg):
    """The (B, C, H, W) batch one step takes."""
    return (cfg.step_batch, cfg.nc, cfg.train_size, cfg.train_size)


@dataclasses.dataclass
class Chunk:
    """One trainer's workload: its config, state, K-step runner and
    super-batch on the device, and the metrics of the last call."""
    cfg: Any
    state: Any
    runner: Any
    batches: torch.Tensor
    metrics: Optional[dict] = None

    @property
    def images(self):
        """Images a step, as the reference's epoch accounting counts them."""
        return self.cfg.images_consumed_per_step


def workload(variant, k=STEPS, device="cuda", **overrides):
    """bench.py's workload for `variant` on `device`: bf16 unless
    `overrides` says otherwise (compute_dtype=, widths, batch)."""
    cfg = get_config(variant, env_override=False,
                     **{"compute_dtype": "bfloat16", **VARIANTS[variant],
                        **overrides})
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device=device)
    batches = torch.from_numpy(np.random.RandomState(0).rand(
        k, *step_shape(cfg)).astype(np.float32)).to(device)
    return Chunk(cfg, state, build_multi_step(cfg), batches)


def measure_card(variant, k=STEPS, reps=REPS, device="cuda", **overrides):
    """Images/s of each of `reps` timed calls of the K-step chunk, after one
    untimed call (eager, then captured on the card); returns (rates, the
    Chunk).  Each rate is the chunk's images over the host-clock time from
    before the call to the fetch of its last errG."""
    w = workload(variant, k, device, **overrides)
    _, w.metrics = w.runner(w.state, w.batches)
    float(w.metrics["errG"][-1])
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, w.metrics = w.runner(w.state, w.batches)
        float(w.metrics["errG"][-1])      # waits for the whole chunk
        rates.append(w.images * k / (time.perf_counter() - t0))
    return rates, w


def read_baselines(path=BASELINE_FILE):
    """BASELINE_MEASURED.json as a dict ({} where there is none); read only."""
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def with_vs_baseline(rec, baselines):
    """`rec` with `vs_baseline`: its value over the torch-CPU baseline of its
    metric, or None where the file has no such key."""
    base = baselines.get(BASELINE_KEYS[rec["metric"]])
    rec["vs_baseline"] = round(rec["value"] / base, 2) if base else None
    return rec


def cpu_anchor(reps=5):
    """bench.py's host-speed anchor (bench.py:142-155): seconds a rep of a
    fixed numpy workload."""
    rng = np.random.RandomState(0)
    a = rng.rand(768, 768).astype(np.float64)
    b = a @ a  # warmup (BLAS thread pool spin-up)
    t0 = time.perf_counter()
    for _ in range(reps):
        b = a @ (b / np.linalg.norm(b))  # renormalize: bounded, defeats DCE
    return (time.perf_counter() - t0) / reps


def card_desc(device):
    """(name, power limit in W) of the card; ("cpu", None) on the CPU.  The
    limit is nvidia-smi's `power.limit` (None where it cannot be read)."""
    if device.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
        first = out.strip().splitlines()[0]
        return name, float(first.rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return name, None


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    ap.add_argument("--ngf", type=int, default=None,
                    help="generator width override (CPU smoke runs)")
    ap.add_argument("--ndf", type=int, default=None)
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="gray-3 and rgb-full images a step")
    ap.add_argument("--patch-images", type=int, default=PATCH_IMAGES,
                    help="gray-patch-batch images a step (64 tiles each)")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="K: steps a call, and overlap pipeline calls a "
                         "repetition")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--images", type=int, default=N_IMAGES,
                    help="overlap images a pipeline call")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    device = pick_device(args.cpu)
    float(torch.ones((8, 128), device=device).sum())
    probe = round(time.perf_counter() - t0, 3)
    card = device.type == "cuda"
    name, power_w = card_desc(device)
    host, host_desc = machine_fingerprint()
    anchor = round(cpu_anchor(), 4)
    baselines = read_baselines()
    baseline_host = baselines.get("host", "unknown (see BASELINE_MEASURED)")
    widths = {k: v for k, v in (("ngf", args.ngf), ("ndf", args.ndf))
              if v is not None}

    # the overlap pipeline in bf16, parity BN first (bench.py:205-215)
    ocfg = get_config("gray-patch-batch-overlap", env_override=False,
                      **{k: v for k, v in widths.items() if k == "ngf"})
    k2_was = dict(bulge.launches), dict(bulge.impl_launches)
    lines = [overlap_record(bn_eval=bn_eval, n_images=args.images,
                            reps=args.reps, steps=args.steps,
                            device=str(device), cfg=ocfg, dtype="bf16")
             for bn_eval in (False, True)]
    k2 = [{k: n - was[k] for k, n in now.items()}
          for now, was in zip((bulge.launches, bulge.impl_launches), k2_was)]

    k1 = {}
    sizes = {"batchSize": args.batch, "images_per_step": args.patch_images}
    for variant in TRAIN_ORDER:
        before = counted()
        rates, w = measure_card(variant, args.steps, args.reps, device,
                                **widths, **{key: sizes[key] for key in
                                             VARIANTS[variant]})
        ran = launches_run({k: n - before[k] for k, n in counted().items()},
                           w.runner)
        k1[variant] = ran["preprocess"]
        ips, spread = median_spread(rates, 1)
        lines.append({"metric": ("" if card else "cpu_")
                      + train_metric(variant), "value": round(ips, 1),
                      "unit": "images/sec", "rep_spread": spread})
        del w
        if card:
            torch.cuda.empty_cache()

    print(json.dumps({
        "metric": "bench_selfcert", "value": probe,
        "unit": "s (first card round trip)", "host": host,
        "host_desc": host_desc, "cpu_anchor_s": anchor,
        "baseline_host": baseline_host,
        "baseline_note": "vs_baseline comparable only within one baseline "
                         "regeneration (BASELINE_MEASURED.json 'note'); "
                         "'value' fields are comparable across runs on one "
                         "card and power limit",
        "device": name, "power_limit_w": power_w}), flush=True)
    print("kernel launches: " + json.dumps({
        "preprocess_run": k1, "bulge": k2[0], "bulge_impl": k2[1]}),
        flush=True)
    for rec in lines:
        if card:
            with_vs_baseline(rec, baselines)
        rec.update(host=host, cpu_anchor_s=anchor, device=name,
                   power_limit_w=power_w, baseline_host=baseline_host)
        print(json.dumps(rec), flush=True)
    return lines


if __name__ == "__main__":
    main()
