"""Patch-overlap SR inference throughput (upscaled MP/s) on one card: the
port of bench_infer.py's device side (measure_tpu, main).

  python -m dcgan_sr_tpu_torch.bench_infer [--bn-eval] [--images 64]
         [--dtype bf16|fp32] [--self-ensemble 1|2|4|8]
         [--ensemble-batched] [--ngf N] [--cpu]

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

`--self-ensemble N` (N != 1) times the dihedral-averaged pipeline instead
(infer/ensemble.py; `--ensemble-batched` runs the N members as one
generator call), on max(8, images // N) images a call as bench_infer.py
does, and names its lines
overlap_sr_upscaled_mp_per_sec_tta{N}{_batched}{_bn_eval}
(bench_infer.py:183-211).  MP/s counts each image once, members aside.
"""

from __future__ import annotations

import argparse
import json
import time

N_IMAGES = 64


DTYPES = ("bf16", "fp32")


def measure(n_images=N_IMAGES, reps=3, steps=20, bn_eval=False, device="cuda",
            seed=0, cfg=None, dtype="bf16", bulge_impl=None, self_ensemble=1,
            ensemble_batched=False):
    """Sustained MP/s of the overlap pipeline on `device`: one value per
    repetition.  bn_eval=False is the parity pipeline (each image's 225
    tiles one train-mode BN batch — the reference's convention,
    overlap:427-431); bn_eval=True the running-stats mode through the flat
    (N*T)-tile generator call.  `bulge_impl` asks the generator's fused
    pair for a kernel by name (ops/bulge.py); None takes the wrapper's
    choice.  `self_ensemble` / `ensemble_batched` as in make_overlap_sr_fn."""
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
        cfg, net, bn_eval=bn_eval, self_ensemble=self_ensemble,
        ensemble_batched=ensemble_batched,
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


def metric_name(bn_eval=False, self_ensemble=1, ensemble_batched=False):
    """bench_infer.py's metric name of a mode (bench_infer.py:171-172,
    207-209)."""
    if self_ensemble == 1:
        return "overlap_sr_upscaled_mp_per_sec" + ("_bn_eval" if bn_eval
                                                   else "")
    return (f"overlap_sr_upscaled_mp_per_sec_tta{self_ensemble}"
            + ("_batched" if ensemble_batched else "")
            + ("_bn_eval" if bn_eval else ""))


def overlap_record(bn_eval=False, self_ensemble=1, ensemble_batched=False,
                   **kw):
    """One JSON-able record under bench_infer.py's metric names: the median
    of the repetitions and their [min, median, max] spread
    (utils/measure.median_spread, as bench_infer.py:148-177).  No
    `vs_baseline`: bench.py adds it on the card."""
    import torch

    from .utils.measure import median_spread

    mps, spread = median_spread(measure(
        bn_eval=bn_eval, self_ensemble=self_ensemble,
        ensemble_batched=ensemble_batched, **kw), 3)
    dev = torch.device(kw.get("device", "cuda"))
    return {
        # a CPU run checks the plumbing; its rate is not the card's metric
        "metric": ("" if dev.type == "cuda" else "cpu_")
                  + metric_name(bn_eval, self_ensemble, ensemble_batched),
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
    ap.add_argument("--self-ensemble", type=int, default=1,
                    choices=(1, 2, 4, 8),
                    help="time the N-member dihedral-averaged pipeline on "
                         "max(8, images // N) images a call")
    ap.add_argument("--ensemble-batched", action="store_true",
                    help="run the N ensemble members as one generator call "
                         "instead of N")
    ap.add_argument("--ngf", type=int, default=None,
                    help="generator width override (CPU smoke runs)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    from .core import get_config
    from .ops import bn, bulge
    from .utils.device import pick_device

    device = pick_device(args.cpu)
    cfg = get_config("gray-patch-batch-overlap", env_override=False,
                     **({} if args.ngf is None else {"ngf": args.ngf}))
    # as in bench_infer.py (:196-206): --ensemble-batched means nothing at
    # N = 1, and N members run on max(8, images // N) images a call, so a
    # call's tiles stay near one N = 1 call's
    n = args.self_ensemble
    batched = args.ensemble_batched and n != 1
    n_images = args.images if n == 1 else max(8, args.images // n)
    for bn_eval in ((True,) if args.bn_eval else (False, True)):
        print(json.dumps(overlap_record(
            bn_eval=bn_eval, self_ensemble=n, ensemble_batched=batched,
            n_images=n_images,
            reps=args.reps, steps=args.steps, device=str(device),
            seed=args.seed, cfg=cfg, dtype=args.dtype)), flush=True)
    print("kernel launches: " + json.dumps({
        **bulge.launches, **bn.launches,
        "bn_plain_cuda_calls": bn.plain_cuda_calls}))


if __name__ == "__main__":
    main()
