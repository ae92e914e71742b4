"""Single-image self-trained SR ("zero-shot" SR) on the card: train the
generator on random crops of YOUR photo, evaluate on a held-out region of
the same photo (port of tools/zssr_photo.py).

The reference trains only on CelebA; its models carry a face prior that
does not transfer to arbitrary photographs.  Internal-statistics training
(Shocher et al.'s ZSSR insight) closes that gap with the port's existing
pieces: the gray-3 hourglass (train-gray-3.lua:52-73 topology), the K-step
training chunk (train/multi_step.py: one CUDA graph replay a chunk on a
card, the preprocess kernel in every step), the pixel-loss knob, and the
full-image inference path (the bulge kernel on a card).

Protocol: the photo is split into a train region (top `1 - holdout`) and a
held-out region (bottom).  Training samples random fineSize crops (+hflip)
from the train region only, with numpy's RandomState(--seed), so a seed
gives the JAX tool's crops byte for byte; evaluation reports PSNR/SSIM of G
vs the bilinear control on the held-out region (the reference's yardstick,
train-gray-3.lua:395-400), in both BN modes, as a `ZSSR_PHOTO {json}` line.

  python -m dcgan_sr_tpu_torch.zssr_photo --input photo.jpg [--steps 3000]
      [--pixel-loss 1000] [--holdout 0.25] [--ckpt-out dir] [--sr-out f.png]
      [--bf16] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .core import get_config
from .evaluation import inference_generator
from .image.io import load_image, save_display
from .image.ops import box_downsample2, resize_bilinear
from .infer.tiled import make_generator_fn, sr_full_image
from .metrics import cal_psnr, cal_ssim
from .ops import bulge, preprocess
from .train.multi_step import build_multi_step, launches_run
from .train.step import init_train_state
from .utils.device import pick_device


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True)
    ap.add_argument("--config", default="gray-3")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--scan", type=int, default=20,
                    help="steps a call (one CUDA graph replay on a card)")
    ap.add_argument("--pixel-loss", type=float, default=1000.0)
    ap.add_argument("--gan-weight", type=float, default=0.0,
                    help="adversarial gradient scale for G. Default 0: on a "
                         "single image D overfits and destabilizes G "
                         "(PARITY.md: gan_weight 1 loses to bilinear, "
                         "gan_weight 0 beats it); raise it for texture "
                         "hallucination")
    ap.add_argument("--holdout", type=float, default=0.25,
                    help="bottom fraction of the photo held out for eval")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ckpt-out", default=None,
                    help="directory to save the trained G checkpoint")
    ap.add_argument("--sr-out", default=None,
                    help="write the held-out region's SR result PNG here")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    device = pick_device(args.cpu)
    cfg = get_config(args.config, env_override=False, batchSize=args.batch,
                     pixel_loss_weight=args.pixel_loss,
                     gan_weight=args.gan_weight,
                     compute_dtype="bfloat16" if args.bf16 else "float32")
    cfg.manualSeed = args.seed
    fs = cfg.fineSize

    img = load_image(args.input, nc=cfg.nc)          # (nc, H, W) in [0, 1]
    # Tanh-head configs train on [-1,1] (donkey hook mul(2):add(-1)): crops
    # and eval inputs are mapped into that range
    pm1 = cfg.data_range == "pm1"
    H, W = img.shape[-2], img.shape[-1]
    split = int(H * (1.0 - args.holdout))
    if split < fs or W < fs:
        raise SystemExit(f"photo {H}x{W}: the train region needs at least "
                         f"{fs}x{fs} pixels")
    train_region = img[..., :split, :]
    # held-out region: even dims for the 2x2 degrade
    test_region = img[..., split + (H - split) % 2:, : W - W % 2]
    print(f"photo {H}x{W}: train rows [0,{split}), held-out "
          f"{test_region.shape[-2]}x{test_region.shape[-1]}")

    # numpy's RandomState in the JAX tool's order: its crops byte for byte
    rng = np.random.RandomState(args.seed)

    def sample_crops(n):
        ys = rng.randint(0, split - fs + 1, size=n)
        xs = rng.randint(0, W - fs + 1, size=n)
        out = np.empty((n, cfg.nc, fs, fs), np.float32)
        for i, (y, x) in enumerate(zip(ys, xs)):
            c = train_region[:, y:y + fs, x:x + fs]
            if rng.rand() < 0.5:
                c = c[..., ::-1]
            out[i] = c
        return out * 2.0 - 1.0 if pm1 else out

    state = init_train_state(cfg, torch.Generator().manual_seed(args.seed),
                             device=device)
    mstep = build_multi_step(cfg)
    n_dispatch = max(-(-args.steps // args.scan), 1)  # ceil: run AT LEAST
    total_steps = n_dispatch * args.scan              # args.steps
    if total_steps != args.steps:
        print(f"rounding {args.steps} steps up to {total_steps} "
              f"({n_dispatch} dispatches of --scan {args.scan})")
    t0 = time.time()
    for d in range(n_dispatch):
        sb = torch.from_numpy(sample_crops(args.scan * args.batch).reshape(
            args.scan, args.batch, cfg.nc, fs, fs)).to(device)
        state, m = mstep(state, sb)
        if d % 10 == 0 or d == n_dispatch - 1:
            print(f"step {(d + 1) * args.scan}/{total_steps}"
                  f"  Err_G {float(m['errG'][-1]):.4f}"
                  f"  Err_D {float(m['errD'][-1]):.4f}"
                  f"  ({time.time() - t0:.1f}s)", flush=True)

    if args.ckpt_out:
        from .train.checkpoint import save_checkpoint
        save_checkpoint(args.ckpt_out, cfg.name, total_steps, state)
        print(f"saved checkpoint to {args.ckpt_out}")

    # ---- held-out eval: G vs bilinear on the unseen region -----------------
    # both BN modes: batch statistics (reference parity) and the training
    # run's running statistics (the right mode for a single unseen image),
    # on an fp32 copy of G whatever the training precision, as in JAX
    hw = torch.from_numpy(np.ascontiguousarray(
        test_region[0] if cfg.nc == 1 else test_region)).to(device)
    bil = resize_bilinear(box_downsample2(hw), hw.shape[-2], hw.shape[-1])
    res = {
        "psnr_bilinear": float(cal_psnr(hw, bil)),
        "ssim_bilinear": float(cal_ssim(hw, bil)),
        "steps": total_steps, "holdout_hw": list(test_region.shape[-2:]),
        "train_time_s": round(time.time() - t0, 1),
    }
    net = inference_generator(cfg, state)
    hw_in = hw * 2.0 - 1.0 if pm1 else hw
    fake = None
    for tag, bn_eval in (("batchstats", False), ("runstats", True)):
        fake, _ = sr_full_image(make_generator_fn(net, bn_eval=bn_eval),
                                hw_in)
        if pm1:
            fake = (fake + 1.0) * 0.5  # back to [0,1] for the PSNR yardstick
        res[f"psnr_generator_{tag}"] = float(cal_psnr(hw, fake))
        res[f"ssim_generator_{tag}"] = float(cal_ssim(hw, fake))
    if args.sr_out:
        save_display(args.sr_out, fake.cpu().numpy())
        print(f"wrote {args.sr_out}")
    print("ZSSR_PHOTO " + json.dumps(res), flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("kernel launches: " + json.dumps(launches_run(
        {**bulge.launches, **preprocess.launches}, mstep)), flush=True)
    return res


if __name__ == "__main__":
    main()
