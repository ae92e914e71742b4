"""Overlap-variant quality protocol on the card: naive stitch vs seam-cut
stitch vs bilinear, on held-out textured images (port of
tools/overlap_protocol.py).

The reference's final section (train-gray-patch-batch-overlap.lua:377-704)
prints PSNR/SSIM of the naively stitched and seam-stitched generator
outputs against the bilinear control for single train/test images.  This
tool runs the same comparison over full 100-image held-out sets through the
on-device overlap pipeline (225 overlapping tiles an image -> batched G ->
naive + seam-DP stitch, infer/tiled.py), whose layers 3-4 go through the
bulge kernel on a card.

  python -m dcgan_sr_tpu_torch.overlap_protocol \
      --ckpt fixtures/overlap_textured_net_G.npz [--sets 10000:10005] \
      [--bn-eval] [--ema] [--cpu]
"""

from __future__ import annotations

import argparse

from .core import get_config
from .data.synthetic import TexturedImages
from .evaluation import evaluate_overlap_slice
from .train.checkpoint import load_generator
from .utils.device import pick_device


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="…_net_G.npz checkpoint")
    ap.add_argument("--config", default="gray-patch-batch-overlap")
    ap.add_argument("--sets", default="10000:10005",
                    help="a:b file_set slice (100 imgs each, the committed "
                         "textured protocol; 10000+ = held out from the "
                         "images 1..10000 training stream, mirroring "
                         "train-gray-patch-batch.lua:489's 500-image "
                         "held-out split)")
    ap.add_argument("--ema", action="store_true",
                    help="score the EMA branch (checkpoint needs ema keys)")
    ap.add_argument("--bn-eval", action="store_true",
                    help="normalize BN with training running stats instead "
                         "of per-image tile-batch stats (the parity default "
                         "reproduces the reference's single-image batches, "
                         "whose stats are unrepresentative; PARITY.md)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    device = pick_device(args.cpu)
    cfg = get_config(args.config, **({"g_ema": 0.999} if args.ema else {}))
    # both branches as the JAX tool reads them: params (or ema) and the BN
    # running statistics
    try:
        net, _ = load_generator(cfg, args.ckpt, ema=args.ema,
                                need_state=True, device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    src = TexturedImages(cfg.fineSize, nc=1, seed=1234)
    a, b = (int(x) for x in args.sets.split(":"))
    # batch_size=100 is part of the committed textured protocol (every
    # PARITY.md overlap row was measured at 100 images a set); the harness
    # default is cfg.batchSize, the reference's file-addressing unit
    res = evaluate_overlap_slice(cfg, net, src, range(a, b),
                                 bn_eval=args.bn_eval, batch_size=100)
    for name, psnr, ssim in (
            ("bilinear", res.psnr_bilinear, res.ssim_bilinear),
            ("naive-stitch", res.psnr_naive, res.ssim_naive),
            ("seam-stitch", res.psnr_seam, res.ssim_seam)):
        print(f"{name:13s} PSNR {psnr:.5f}  SSIM {ssim:.6f}")
    print(f"({res.n_images} images)", flush=True)
    return res


if __name__ == "__main__":
    main()
