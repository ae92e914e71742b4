"""CLI: `python -m dcgan_sr_tpu_torch.cli --config <variant>` — the trainer.

Port of the training part of dcgan_sr_tpu/cli.py: config with env-var
overrides, the training loop with the reference log line, per-epoch npz
checkpoints and resume.  It runs on the first CUDA device unless `--cpu` is
given.

Data: the variant's route is found as the JAX CLI finds it (the folder
route for rgb-full and gray, then the indexed route); the folder and indexed
loaders are not ported yet, so a route that exists raises unless
`--synthetic` is given, and a route that does not exist prints the JAX
CLI's "not found" line and falls back to the deterministic procedural source
(data/synthetic.py).  The patch variants' batches are the JAX CLI's grid of
patchSize tiles of each image, and their steps per epoch count images.

`--bf16` computes in bf16 (fp32 master parameters); `--feed-bf16` ships the
batches to the device as bf16, which the step upcasts.  Options of the JAX
CLI that the port does not have yet (data parallel, eval, sample dumps, the
device-side augment, stage-ahead) are absent, not accepted and ignored.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from .core import get_config
from .data.synthetic import SyntheticImages
from .ops import bulge, preprocess
from .train.checkpoint import latest_epoch, load_checkpoint
from .train.loop import train_epochs
from .train.step import init_train_state
from .utils.device import pick_device
from .utils.logging import MetricsLogger


# the reference's dataset locations: the folder route (DATA_ROOT,
# dcgan_sr_tpu/cli.py:56-57) and the indexed route (data/indexed.py)
FOLDER_ROUTE = "/CelebA/Img/img_align_celeba"
DEFAULT_ROUTE = "/CelebA/Img/img_align_celeba/Img/"


def _not_ported(loader, route):
    raise NotImplementedError(
        f"{route} exists, but the {loader} loader is not ported yet; pass "
        "--synthetic to train on the procedural source")


def patch_grid(hr, patch):
    """(B, 1, S, S) images -> (B * (S/patch)^2, 1, patch, patch) tiles, row-
    major within each image: the JAX CLI's pure-numpy grid extraction
    (dcgan_sr_tpu/cli.py:124-131)."""
    b = hr.shape[0]
    n = hr.shape[-1] // patch
    return (hr[:, 0].reshape(b, n, patch, n, patch)
            .transpose(0, 1, 3, 2, 4)
            .reshape(b * n * n, 1, patch, patch))


def build_data(cfg, args):
    """Returns batch_fn(epoch, step) -> (B, nc, H, W) float32 in the
    variant's data range (the patch variants: their tiles)."""
    data_root = getattr(args, "data_root", None)
    synthetic = args.synthetic or cfg.dataset == "synthetic"
    if cfg.dataset == "folder" and not args.synthetic:
        root = data_root or os.environ.get("DATA_ROOT", FOLDER_ROUTE)
        if os.path.isdir(root):
            _not_ported("folder (FolderDataset)", root)
        print(f"DATA_ROOT {root} not found; falling back to synthetic data")
    if cfg.device_preprocess:
        # the knob expects the folder path's raw-RGB feed; the synthetic
        # source pre-normalizes on the host
        print("device_preprocess needs the folder data path; "
              "disabled for this run")
        cfg.device_preprocess = False
    if not synthetic:
        route = data_root or DEFAULT_ROUTE
        if os.path.isfile(os.path.join(route, "000001.jpg")):
            _not_ported("indexed CelebA (IndexedCelebA)", route)
        print(f"indexed CelebA not found at {route}; using synthetic data")
    src = SyntheticImages(cfg.fineSize, nc=cfg.nc, seed=cfg.manualSeed or 1234)
    imgs_per_step = cfg.images_consumed_per_step

    def batch_fn(epoch, i):
        hr = src.load_batch(i, imgs_per_step)  # (imgs, nc, fine, fine) [0,1]
        if cfg.patch_based:
            hr = patch_grid(hr, cfg.patchSize)
        if cfg.data_range == "pm1":
            hr = hr * 2 - 1
        return np.ascontiguousarray(hr)

    return batch_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="gray-3",
                    help="one of the reference variants")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per epoch (default: ntrain/batchSize)")
    ap.add_argument("--scan", type=int, default=1,
                    help="queue K steps per call over one (K, B, ...) "
                         "super-batch (epoch math unchanged)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--data-root", default=None,
                    help="the dataset's route (default: the reference's "
                         "CelebA paths); its loaders are not ported yet")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--gan-weight", type=float, default=None, metavar="W",
                    help="scale on G's adversarial gradient (1.0 = parity; "
                         "0 = pure reconstruction CNN with --pixel-loss)")
    ap.add_argument("--pixel-loss", type=float, default=None, metavar="W",
                    help="add W * MSE(fake, real) to G's objective")
    ap.add_argument("--g-ema", type=float, default=None, metavar="D",
                    help="keep an EMA copy of G (decay D, e.g. 0.999)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (fp32 master parameters)")
    ap.add_argument("--feed-bf16", action="store_true",
                    help="ship batches host->device as bfloat16; the step "
                         "upcasts them at entry, so only the input pixels "
                         "carry bf16 rounding")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="also write per-step metrics to this JSONL file")
    ap.add_argument("--log-every", type=int, default=1,
                    help="metric fetch/log cadence; >1 lets the host queue "
                         "steps ahead (a fetch waits for the device)")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)

    overrides = {}
    if args.bf16:
        overrides["compute_dtype"] = "bfloat16"
    if args.pixel_loss is not None:
        overrides["pixel_loss_weight"] = args.pixel_loss
    if args.gan_weight is not None:
        overrides["gan_weight"] = args.gan_weight
    if args.g_ema is not None:
        overrides["g_ema"] = args.g_ema
    cfg = get_config(args.config, **overrides)
    if args.seed is not None:
        cfg.manualSeed = args.seed
    if cfg.manualSeed is None:
        cfg.manualSeed = int(np.random.randint(1, 10001))  # train.lua:30
    print(f"config: {cfg}")
    print(f"Random Seed: {cfg.manualSeed}")

    batch_fn = build_data(cfg, args)
    state = init_train_state(
        cfg, torch.Generator().manual_seed(cfg.manualSeed), device=device)

    start_epoch = 0
    if args.resume and args.checkpoint_dir:
        ep = latest_epoch(args.checkpoint_dir, cfg.name)
        if ep is not None:
            state = load_checkpoint(args.checkpoint_dir, cfg.name, ep, state,
                                    seed_missing_ema=True)
            start_epoch = ep
            print(f"resumed from epoch {ep}")

    epochs = args.epochs if args.epochs is not None else cfg.niter
    if args.steps is not None:
        steps = args.steps
    else:
        imgs = cfg.images_consumed_per_step
        ntrain = cfg.ntrain if math.isfinite(cfg.ntrain) else 1000
        steps = max(int(ntrain) // imgs, 1)

    logger = MetricsLogger(jsonl_path=args.metrics_jsonl)
    t0 = time.perf_counter()
    try:
        state, _ = train_epochs(
            cfg, state, batch_fn, niter=epochs, steps_per_epoch=steps,
            checkpoint_dir=args.checkpoint_dir, logger=logger,
            log_every=args.log_every, scan_steps=args.scan,
            start_epoch=start_epoch,
            feed_dtype=torch.bfloat16 if args.feed_bf16 else None)
    finally:
        logger.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("Total time: %.3f" % (time.perf_counter() - t0))
    print("kernel launches: " + json.dumps(
        {**bulge.launches, **preprocess.launches}))
    return state


if __name__ == "__main__":
    main()
