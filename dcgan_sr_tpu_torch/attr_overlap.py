"""Where the overlap SR pipeline's time goes, stage by stage: the port of
tools/attr_overlap.py (reference pipeline
train-gray-patch-batch-overlap.lua:377-704).

  python -m dcgan_sr_tpu_torch.attr_overlap [--images 64] [--steps 20]
         [--reps 3] [--fp32] [--ngf N] [--cpu] [--sweep-bn]

Four cumulative stage programs over a batch of N images, each timed as ms
per pipeline call over K = --steps calls a repetition (one warm
repetition, then --reps timed ones, utils/measure.timed_scan); every stage
folds its output into one device scalar, so the fence waits for it:

  extract   tile extraction + per-tile 2x2 degrade
  gen       + the generator over the N*225 tiles
  naive     + the naive stitch
  seam      + the batched seam DP and ownership gather (the full pipeline)

and `delta_<stage>_ms`, each stage's cost.  The generator runs as
infer/tiled.py make_overlap_sr_fn runs it: the served (fused) network, in
bf16 unless --fp32, each image's 225 tiles one train-mode BN batch through
`Network.forward(groups=N)`, so the gen stage reaches the fused pair (K2)
on layers 3-4 as the served pipeline does.  Nothing loops over images in
Python.

--sweep-bn instead times the full pipeline under four generator-batch
structures:

  vmap_train   per-image 225-tile BN batches (the parity pipeline)
  vmap_eval    per-image calls' structure, running-stats BN
  flat_eval    one (N*225)-tile call, running-stats BN (exact vs vmap_eval)
  flat_pooled  one (N*225)-tile call, train-mode BN pooled across images
               (an ablation: not the reference's math)

The first three are make_overlap_sr_fn(bn_eval=, flat_tiles=).

PyTorch has no counterpart of XLA's cost analysis, which the JAX tool reads
for the bytes and FLOPs of a call.  Here `flops_per_step_g` (and the
sweep's `<name>_gflop`) count the generator's convolutions from the spec's
shapes times the tile count, and the field the JAX tool writes when its
analysis fails, `cost_analysis_error` (the sweep's `<name>_cost_error`),
says that no bytes are counted.  It runs on the first CUDA device unless
--cpu is given (CPU times are not the card's).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .core import get_config
from .image.ops import box_downsample2
from .image.patches import extract_overlap_patches, stitch_overlap_naive
from .infer.seam_device import seam_stitch_device
from .infer.tiled import make_overlap_sr_fn
from .models import generator_spec
from .train.checkpoint import load_generator
from .utils.device import pick_device
from .utils.measure import timed_scan

STAGES = ("extract", "gen", "naive", "seam")
NO_COST_ANALYSIS = "no XLA cost analysis in PyTorch"


def conv_flops(spec, hw):
    """FLOPs of one (1, cin, hw, hw) input through `spec`'s convolutions:
    2 x every multiply-add, from the layers' shapes."""
    flops = 0
    for layer in spec:
        kind = layer["kind"]
        if kind == "upsample":
            hw *= layer["factor"]
        elif kind in ("conv", "convT"):
            k, s, p = layer["k"], layer["s"], layer["p"]
            macs = layer["cin"] * layer["cout"] * k * k
            if kind == "convT":
                flops += 2 * macs * hw * hw
                hw = (hw - 1) * s - 2 * p + k
            else:
                hw = (hw + 2 * p - k) // s + 1
                flops += 2 * macs * hw * hw
    return flops


def _per_image_mean(x):
    """(N, ...) -> (N,) fp32 means."""
    return x.float().reshape(x.shape[0], -1).mean(1)


def _lr_tiles(cfg, images):
    """(N, H, W) images -> (N, T, p/2, p/2): the overlap tiles, degraded."""
    return box_downsample2(extract_overlap_patches(images, cfg.patchSize,
                                                   cfg.overlap))


def _generate(cfg, net, lr, compute_dtype, grouped):
    """The generator over all N*T tiles in one call, train-mode BN over
    each image's tiles (`grouped`) or over all of them -> (N, T, p, p)."""
    n, t = lr.shape[:2]
    fake = net(lr.reshape((n * t, 1) + tuple(lr.shape[2:])),
               bn_stats="pooled", groups=n if grouped else None,
               compute_dtype=compute_dtype)
    return fake[:, 0].reshape(n, t, cfg.patchSize, cfg.patchSize)


def stage_fns(cfg, net, compute_dtype=None):
    """{stage: f(images (N, H, W)) -> device scalar}: the JAX tool's
    cumulative stage programs (tools/attr_overlap.py:204-221), each image's
    value summed over the batch."""
    patch, ov = cfg.patchSize, cfg.overlap

    def value(stage, images):
        fine = tuple(images.shape[-2:])
        lr = _lr_tiles(cfg, images)
        if stage == "extract":
            return _per_image_mean(lr).sum()
        fake = _generate(cfg, net, lr, compute_dtype, grouped=True)
        if stage == "gen":
            return _per_image_mean(fake).sum()
        acc = _per_image_mean(stitch_overlap_naive(fake, fine, patch, ov))
        if stage == "naive":
            return acc.sum()
        return (acc + _per_image_mean(
            seam_stitch_device(fake, fine, patch, ov))).sum()

    return {s: torch.inference_mode()(lambda im, s=s: value(s, im))
            for s in STAGES}


def sweep_fns(cfg, net, compute_dtype=None):
    """{structure: f(images) -> device scalar}: the full pipeline under the
    four generator-batch structures (tools/attr_overlap.py:88-121)."""
    patch, ov = cfg.patchSize, cfg.overlap

    def from_sr_fn(bn_eval, flat):
        sr = make_overlap_sr_fn(cfg, net, compute_dtype=compute_dtype,
                                bn_eval=bn_eval, flat_tiles=flat)

        def run(images):
            out = sr(images)
            return out["naive"].float().mean() + out["seam"].float().mean()
        return run

    @torch.inference_mode()
    def flat_pooled(images):
        fine = tuple(images.shape[-2:])
        fake = _generate(cfg, net, _lr_tiles(cfg, images), compute_dtype,
                         grouped=False)
        return (_per_image_mean(stitch_overlap_naive(fake, fine, patch, ov))
                + _per_image_mean(seam_stitch_device(fake, fine, patch, ov))
                ).sum()

    return {"vmap_train": from_sr_fn(False, False),
            "vmap_eval": from_sr_fn(True, False),
            "flat_eval": from_sr_fn(True, True),
            "flat_pooled": flat_pooled}


def _scanned(body):
    """K pipeline calls over xs (K, N, H, W), folded into one scalar."""
    def run(xs):
        acc = torch.zeros((), device=xs.device)
        for imgs in xs:
            acc = acc + body(imgs)
        return acc
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--ngf", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    ap.add_argument("--sweep-bn", action="store_true",
                    help="measure the four generator-batch structures "
                         "(vmap/flat x train/eval BN) instead of the stage "
                         "attribution")
    args = ap.parse_args(argv)

    device = pick_device(args.cpu)
    overrides = {"ngf": args.ngf} if args.ngf is not None else {}
    cfg = get_config("gray-patch-batch-overlap", env_override=False,
                     **overrides)
    cdt = None if args.fp32 else torch.bfloat16
    fine = (cfg.fineSize, cfg.fineSize)
    n, k, reps = args.images, args.steps, args.reps
    net, _ = load_generator(cfg, None, device=device, seed=0)
    xs = torch.from_numpy(np.random.RandomState(0).rand(
        k, n, *fine).astype(np.float32)).to(device)
    tiles = n * cfg.overlap_patch_line ** 2
    gflop = round(conv_flops(generator_spec(cfg), cfg.patchSize // 2)
                  * tiles / 1e9, 2)
    mp = n * fine[0] * fine[1] / 1e6
    results = {"images_per_dispatch": n, "scan_steps": k,
               "dtype": "float32" if args.fp32 else "bfloat16"}

    if args.sweep_bn:
        for name, body in sweep_fns(cfg, net, cdt).items():
            ms = timed_scan(_scanned(body), (xs,), reps, k) * 1e3
            results[name + "_ms"] = round(ms, 3)
            results[name + "_mp_per_s"] = round(mp / (ms / 1e3), 2)
            results[name + "_gflop"] = gflop
            results[name + "_cost_error"] = NO_COST_ANALYSIS
        print(json.dumps(results, indent=1))
        return results

    for stage, body in stage_fns(cfg, net, cdt).items():
        ms = timed_scan(_scanned(body), (xs,), reps, k) * 1e3
        results[stage + "_ms"] = round(ms, 3)
        results[stage + "_mp_per_s"] = round(mp / (ms / 1e3), 2)
    prev = "extract"
    for stage in STAGES[1:]:
        results[f"delta_{stage}_ms"] = round(
            results[stage + "_ms"] - results[prev + "_ms"], 3)
        prev = stage
    results["flops_per_step_g"] = gflop
    results["cost_analysis_error"] = NO_COST_ANALYSIS
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
