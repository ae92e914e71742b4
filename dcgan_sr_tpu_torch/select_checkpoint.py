"""Rank per-epoch checkpoints by TRAIN-slice PSNR and report the winner's
held-out numbers, on the card (port of tools/select_checkpoint.py).

The reference has no model selection: it evaluates whatever the last epoch
left behind (train-gray-3.lua:354-535).  GAN training oscillates, so the
epoch is selected on the TRAIN slice (never the test slice) and only that
checkpoint is scored on the held-out slice, which keeps the reported test
number unbiased.

  python -m dcgan_sr_tpu_torch.select_checkpoint --dir checkpoints \
      [--config gray-3] [--epochs 50:91] [--select-sets 3] [--full] [--ema]

Each epoch's `<name>_<epoch>_net_{G,D}.npz` (written by either package)
loads through train/checkpoint.py `load_checkpoint`; a torn npz is skipped
with a SKIPPED line and the ranking goes on.  Scoring runs the eval
harness (`evaluate_slice`, batch 100) on an fp32 fused copy of G, so on a
card G's layers 3-4 go through the bulge kernel.  With --full the winner is
re-scored on the full train and test slices in the reference's print
format.  Runs on the first CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
import zipfile

import torch

from .core import get_config
from .data.synthetic import TexturedImages
from .evaluation import evaluate_slice, inference_generator
from .train.checkpoint import latest_epoch, load_checkpoint
from .train.step import init_train_state
from .utils.device import pick_device


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", required=True, help="checkpoint directory")
    ap.add_argument("--config", default="gray-3")
    ap.add_argument("--epochs", default=None,
                    help="a:b python-range slice of epochs (default: all found)")
    ap.add_argument("--select-sets", type=int, default=3,
                    help="train file_sets used for ranking (100 imgs each)")
    ap.add_argument("--full", action="store_true",
                    help="full 2,100-image train+test eval of the winner")
    ap.add_argument("--ema", action="store_true",
                    help="score the EMA branch of checkpoints trained with "
                         "--g-ema (requires the ema keys in the npz)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    device = pick_device(args.cpu)
    cfg = get_config(args.config, **({"g_ema": 0.999} if args.ema else {}))
    src = TexturedImages(cfg.fineSize, nc=cfg.nc, seed=1234)
    template = init_train_state(cfg, torch.Generator().manual_seed(0),
                                device=device)

    if args.epochs:
        a, b = args.epochs.split(":")
        epochs = range(int(a), int(b))
    else:
        epochs = range(1, (latest_epoch(args.dir, cfg.name) or 0) + 1)

    best = None
    for ep in epochs:
        try:
            st = load_checkpoint(args.dir, cfg.name, ep, template)
        except FileNotFoundError:
            continue
        except (zipfile.BadZipFile, ValueError, KeyError, OSError) as e:
            # a torn npz (a run killed mid-write) must not abort the whole
            # ranking: skip it loudly and keep scoring
            print(f"epoch {ep}: SKIPPED unreadable checkpoint ({e!r})",
                  flush=True)
            continue
        r = evaluate_slice(cfg, inference_generator(cfg, st, ema=args.ema),
                           src, range(args.select_sets), batch_size=100)
        print(f"epoch {ep}: train-slice PSNR {r.psnr_generator:.3f} "
              f"SSIM {r.ssim_generator:.5f}", flush=True)
        if best is None or r.psnr_generator > best[1]:
            best = (ep, r.psnr_generator)

    if best is None:
        sys.exit(f"no checkpoints for {cfg.name} in {args.dir}")
    print(f"BEST by train-slice PSNR: epoch {best[0]} ({best[1]:.3f} dB)",
          flush=True)

    if args.full:
        st = load_checkpoint(args.dir, cfg.name, best[0], template)
        gen = inference_generator(cfg, st, ema=args.ema)
        if cfg.patch_based:
            # 500/500 split mirroring the reference's counts
            # (train-gray-patch-batch.lua:365-367,487-489); at batch 100 the
            # file_set indices address other image numbers than the
            # reference's batch-20 addressing, which is fine on the
            # procedural textured set (10000+ is held out from the images
            # 1..10000 training stream) and is the committed
            # fixture-selection protocol
            slices = (("Train-set", range(0, 5)),
                      ("Test-set", range(10000, 10005)))
        else:
            slices = (("Train-set", range(0, 21)),
                      ("Test-set", range(2000, 2021)))
        for tag, sets in slices:
            # file_set = 100 images in every reference protocol
            # (train-gray-3.lua:360, train-gray-patch-batch.lua:365-367)
            r = evaluate_slice(cfg, gen, src, sets, batch_size=100)
            r.print_reference_style(tag=tag)
    return best


if __name__ == "__main__":
    main()
