"""Patch-overlap SR inference throughput (upscaled MP/s) on one card: the
port of bench_infer.py's device side (measure_tpu, main).

  python -m dcgan_sr_tpu_torch.bench_infer [--bn-eval] [--images 64]
         [--dtype bf16|fp32] [--cpu]

The pipeline is make_overlap_sr_fn for gray-patch-batch-overlap at full
width (train-gray-patch-batch-overlap.lua:377-704: 225-tile extraction,
per-tile 2x2 degrade, generator over the tile batch, naive + seam-cut
stitch), in bf16 as bench_infer.py measures it (`make_overlap_sr_fn(...,
compute_dtype=bfloat16)`, bench_infer.py:120; `--dtype fp32` for the fp32
pipeline), random-init weights from a seed, batches of 64 images of
64x64 from a seed.  A repetition is `steps` pipeline calls queued back to
back; both stitched outputs are summed into an accumulator that is fetched
at the end, so the clock stops only when every call has finished.  Prints
one JSON line per BN mode asked for.  No `vs_baseline` is recorded here:
`python -m dcgan_sr_tpu_torch.bench` adds it on the card, from the torch-CPU
baseline file that the JAX package's bench measures and writes.
"""

from __future__ import annotations

import argparse
import json
import time

N_IMAGES = 64


DTYPES = ("bf16", "fp32")


def measure(n_images=N_IMAGES, reps=3, steps=20, bn_eval=False, device="cuda",
            seed=0, cfg=None, dtype="bf16", bulge_impl=None):
    """Sustained MP/s of the overlap pipeline on `device`: one value per
    repetition.  bn_eval=False is the parity pipeline (each image's 225
    tiles one train-mode BN batch — the reference's convention,
    overlap:427-431); bn_eval=True the running-stats mode through the flat
    (N*T)-tile generator call.  `bulge_impl` asks the generator's fused
    pair for a kernel by name (ops/bulge.py); None takes the wrapper's
    choice."""
    import numpy as np
    import torch

    from .core import get_config
    from .infer.tiled import make_overlap_sr_fn
    from .train.checkpoint import load_generator

    device = torch.device(device)
    if cfg is None:
        cfg = get_config("gray-patch-batch-overlap", env_override=False)
    net, _ = load_generator(cfg, None, device=device, seed=seed)
    net.bulge_impl = bulge_impl
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    run = make_overlap_sr_fn(
        cfg, net, bn_eval=bn_eval,
        compute_dtype=torch.bfloat16 if dtype == "bf16" else None)
    fs = cfg.fineSize
    batches = torch.from_numpy(np.random.RandomState(seed).rand(
        steps, n_images, fs, fs).astype(np.float32)).to(device)

    def once():
        acc = torch.zeros((), device=device)
        for imgs in batches:
            out = run(imgs)
            acc = acc + out["naive"].sum() + out["seam"].sum()
        return float(acc)      # the fetch waits for every queued call

    once()                     # kernels built, allocator warm
    rep_mps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        dt = (time.perf_counter() - t0) / steps
        rep_mps.append(n_images * fs * fs / 1e6 / dt)
    return rep_mps


def overlap_record(bn_eval=False, **kw):
    """One JSON-able record under bench_infer.py's metric names: the median
    of the repetitions and their [min, median, max] spread
    (utils/measure.median_spread, as bench_infer.py:148-177).  No
    `vs_baseline`: bench.py adds it on the card."""
    import torch

    from .utils.measure import median_spread

    mps, spread = median_spread(measure(bn_eval=bn_eval, **kw), 3)
    dev = torch.device(kw.get("device", "cuda"))
    return {
        # a CPU run checks the plumbing; its rate is not the card's metric
        "metric": ("" if dev.type == "cuda" else "cpu_")
                  + "overlap_sr_upscaled_mp_per_sec"
                  + ("_bn_eval" if bn_eval else ""),
        "value": round(mps, 3),
        "unit": "MP/s",
        "rep_spread": spread,
        "dtype": kw.get("dtype", "bf16"),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bn-eval", action="store_true",
                    help="measure only the running-stats/flat-tile mode "
                         "(default: both modes, parity first)")
    ap.add_argument("--images", type=int, default=N_IMAGES)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bf16", choices=DTYPES,
                    help="compute dtype of the generator (default bf16, the "
                         "JAX bench's)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    from .ops import bulge
    from .utils.device import pick_device

    device = pick_device(args.cpu)
    for bn_eval in ((True,) if args.bn_eval else (False, True)):
        print(json.dumps(overlap_record(
            bn_eval=bn_eval, n_images=args.images, reps=args.reps,
            steps=args.steps, device=str(device), seed=args.seed,
            dtype=args.dtype)), flush=True)
    print("kernel launches: " + json.dumps(bulge.launches))


if __name__ == "__main__":
    main()
