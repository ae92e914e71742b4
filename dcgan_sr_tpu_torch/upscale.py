"""Upscale images with a trained generator on the card (port of
tools/upscale.py).

Covers the reference's sample-making flows as a tool: full-image SR (gray-3,
and rgb-full/gray/gray-2), grid-patch SR, or overlap-tile SR with seam-cut
stitching (the patch configs), from a framework checkpoint (.npz) or a
reference Torch checkpoint (`--t7 net_G.t7`, compat/).  Default
is the reference's eval protocol: degrade the input 2x2 internally, restore
it at its own size and print PSNR against the original beside the bilinear
control.  --true-2x treats the input as the LOW-RES image and writes a
2Hx2W output.  A directory input runs every image through one batched
pipeline call.

  python -m dcgan_sr_tpu_torch.upscale --config gray-3 \
      --ckpt fixtures/gray3_textured_net_G.npz --input face.jpg --output sr.png
  python -m dcgan_sr_tpu_torch.upscale --config gray-patch-batch-overlap \
      --mode overlap --ckpt fixtures/overlap_textured_net_G.npz \
      --input face.jpg --output sr.png

A port-only model (core/config.py MODELS) runs the same path at its own
scale and ranges: `--config srgan-x4` always treats the input as the LR
RGB image in [0, 1] (as --true-2x does) and runs SRGAN's generator on the
checkpoint's running statistics (as --bn-eval does), maps its [-1, 1]
output to [0, 1] and writes the image at 4x.

  python -m dcgan_sr_tpu_torch.upscale --config srgan-x4 --bf16 \
      --ckpt srgan_net_G.npz --input photo.png --output photo_x4.png

`--bf16` runs the generator in bf16 (the fused pair through its bf16
kernel on a card) in every mode.  `--dp` under a launcher (`python -m
torch.distributed.run --nproc_per_node N -m dcgan_sr_tpu_torch.upscale --dp
...`) shards directory mode's images over the ranks (infer/tiled.py
`mesh=`): the image count is padded with modular rows to a multiple of the
ranks, as in JAX, every rank gets the whole batch back, and rank 0 writes
the same files as a run without `--dp`; a single image runs on rank 0
alone.  Without a launcher `--dp` is the plain run.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

_IMG_EXT = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm")


def _psnr(nc, a, b):
    from .metrics import cal_psnr, cal_psnr_batch
    if nc == 1:
        return float(cal_psnr(a, b))
    # multi-channel: per-channel PSNR averaged (the harness's convention)
    return float(cal_psnr_batch(a, b).mean())


def _dtype(args):
    return torch.bfloat16 if args.bf16 else None


# the options a port-only model does not take, at their defaults
_NOT_FOR_MODELS = {"mode": "auto", "true_2x": False, "both_seams": False,
                   "ema": False, "t7": None}


def _scale(cfg):
    """The generator's upscaling factor (a variant's is 2)."""
    return getattr(cfg, "scale", 2)


def _in_pm1(cfg):
    """Whether the generator's input is in [-1, 1]; its output is where
    `cfg.data_range` is "pm1"."""
    return getattr(cfg, "lr_range", cfg.data_range) == "pm1"


def batch_upscale(args, cfg, net, mesh=None):
    """Directory mode: ONE batched SR call over all images, optionally
    sharded over data-parallel ranks (`mesh`, --dp).  Patch configs run the
    overlap-tile pipeline; full-image configs run their net-2x generator on
    whole images.  Images of mixed sizes are edge-padded to a common
    pipeline-legal (Hp, Wp) and cropped back."""
    from .image.io import load_image, save_image
    from .image.ops import box_downsample2, resize_bilinear
    from .infer.tiled import (lr_pad_dim, make_full_sr_fn,
                              make_overlap_sr_fn, overlap_pad_dim)

    names = sorted(n for n in os.listdir(args.input)
                   if n.lower().endswith(_IMG_EXT))
    if not names:
        sys.exit(f"no images in {args.input}")
    nc, tiled = cfg.nc, cfg.patch_based
    imgs = [load_image(os.path.join(args.input, n), nc=nc) for n in names]
    imgs = [im[0] if nc == 1 else im for im in imgs]   # (H,W) / (C,H,W)
    sizes = [im.shape[-2:] for im in imgs]

    def pad_dim(d):
        if not tiled:
            # LR inputs: a full-image G maps any integer extent to exactly
            # its scale times itself; the eval protocol degrades 2x2
            return d if args.true_2x else d + (d % 2)
        p, ov = cfg.patchSize, cfg.overlap
        # LR inputs: overlap tiling needs lr-legal extents
        return (lr_pad_dim if args.true_2x else overlap_pad_dim)(d, p, ov)

    Hp = pad_dim(max(h for h, _ in sizes))
    Wp = pad_dim(max(w for _, w in sizes))
    batch = np.stack([
        np.pad(im, [(0, 0)] * (im.ndim - 2)
               + [(0, Hp - im.shape[-2]), (0, Wp - im.shape[-1])],
               mode="edge") for im in imgs])
    n = len(batch)
    if mesh is not None:
        pad_n = (-n) % mesh.size         # shardable image count
        if pad_n:
            # modular row indexing: pad_n rows, no transient full copies
            batch = np.concatenate([batch, batch[np.arange(pad_n) % n]])
    ens = dict(self_ensemble=args.self_ensemble,
               ensemble_batched=args.ensemble_batched,
               compute_dtype=_dtype(args), mesh=mesh)
    if tiled:
        fine = (2 * Hp, 2 * Wp) if args.true_2x else (Hp, Wp)
        ov_fn = make_overlap_sr_fn(cfg, net, fine=fine, lr_input=args.true_2x,
                                   bn_eval=args.bn_eval,
                                   both_seams=args.both_seams, **ens)
        fn = lambda x: ov_fn(x)["seam"]                   # noqa: E731
    else:
        full_fn = make_full_sr_fn(net, lr_input=args.true_2x,
                                  bn_eval=args.bn_eval, **ens)
        if nc == 1:
            fn = lambda x: full_fn(x[:, None])[:, 0]      # noqa: E731
        else:
            fn = full_fn
    x = torch.from_numpy(batch * 2.0 - 1.0 if _in_pm1(cfg) else batch
                         ).to(net.device)
    t0 = time.perf_counter()
    sr_all = fn(x).cpu().numpy()[:n]
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return                           # rank 0 writes the files
    if cfg.data_range == "pm1":
        sr_all = (sr_all + 1.0) * 0.5
    os.makedirs(args.output, exist_ok=True)

    scale = _scale(cfg) if args.true_2x else 1
    for name, im, padded, (h, w), sr in zip(names, imgs, batch, sizes, sr_all):
        sr = sr[..., :scale * h, :scale * w]
        dst = os.path.join(args.output, os.path.splitext(name)[0] + "_sr.png")
        save_image(dst, np.clip(sr, 0, 1))
        if args.true_2x:    # input IS the LR — no ground truth to score
            print(f"{name}: {h}x{w} -> {scale * h}x{scale * w}")
        else:
            # baseline from the PADDED image, then crop (odd sizes)
            bil = resize_bilinear(box_downsample2(torch.from_numpy(padded)),
                                  Hp, Wp).numpy()[..., :h, :w]
            print(f"{name}: {h}x{w}  PSNR(G)={_psnr(nc, im, sr):.3f}  "
                  f"PSNR(bilinear)={_psnr(nc, im, bil):.3f}")
    mp = sum(scale * scale * h * w for h, w in sizes) / 1e6
    where = (f"sharded over {mesh.size} ranks" if mesh is not None
             else "single device")
    print(f"batch: {n} images ({mp:.2f} MP) in {dt:.2f}s on {net.device} "
          f"({where})")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="gray-3")
    ap.add_argument("--ckpt", help="framework checkpoint (…_net_G.npz)")
    ap.add_argument("--input", required=True,
                    help="image file (any size), or a DIRECTORY of images "
                         "for batch mode")
    ap.add_argument("--output", required=True,
                    help="output PNG path (batch mode: output directory)")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "full", "grid", "overlap"])
    ap.add_argument("--resize", type=int, default=None, metavar="N",
                    help="optionally resize the input to NxN first")
    ap.add_argument("--bn-eval", action="store_true",
                    help="normalize BN with the checkpoint's RUNNING stats "
                         "instead of the input's own batch stats (PARITY.md)")
    ap.add_argument("--true-2x", action="store_true",
                    help="treat --input as the LOW-RES image (or directory) "
                         "and emit 2Hx2W output; without it the tool runs "
                         "the reference's eval protocol")
    ap.add_argument("--both-seams", action="store_true",
                    help="overlap mode: intent-mode stitching (interior "
                         "patches keep the top seam outside the left band) "
                         "instead of the committed reference behavior")
    ap.add_argument("--ema", action="store_true",
                    help="use the EMA generator branch of a --ckpt trained "
                         "with --g-ema")
    ap.add_argument("--self-ensemble", type=int, default=1, metavar="N",
                    choices=(1, 2, 4, 8),
                    help="average G over N dihedral transforms of its input "
                         "(all modes; per-tile in grid/overlap — "
                         "infer/ensemble.py)")
    ap.add_argument("--ensemble-batched", action="store_true",
                    help="run the N ensemble members as ONE (N*B)-batch "
                         "generator call; exact with --bn-eval, "
                         "pooled-BN-stats variant in train mode "
                         "(infer/ensemble.py)")
    ap.add_argument("--dp", action="store_true",
                    help="batch mode: shard images over all visible devices "
                         "(the ranks of a torch.distributed launcher)")
    ap.add_argument("--t7", help="reference Torch checkpoint (net_G.t7); "
                    "takes the place of --ckpt")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (fp32 parameters, fp32 output)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    from .core import SRResNetConfig, resolve_config
    from .parallel import initialize_from_env, launched
    from .utils.device import pick_device

    # a variant's Config (env-var overrides apply: ngf=…, etc.) or a
    # port-only model's
    cfg = resolve_config(args.config)
    if isinstance(cfg, SRResNetConfig):
        given = [k for k, v in _NOT_FOR_MODELS.items()
                 if getattr(args, k) != v]
        if given:
            sys.exit(f"--config {cfg.variant}: not supported: "
                     + ", ".join("--" + k.replace("_", "-") for k in given)
                     + f" (its input is the LR image, its scale "
                       f"{cfg.scale}x, its BN on running statistics)")
        args.true_2x = args.bn_eval = True

    # a rank takes its own card (LOCAL_RANK) before pick_device reads it
    mesh = initialize_from_env(args.cpu) if args.dp and launched() else None
    try:
        if mesh is not None and not os.path.isdir(args.input):
            if mesh.rank != 0:
                return                   # a single image: rank 0 alone
            return _run(args, cfg, None, pick_device(args.cpu))
        return _run(args, cfg, mesh, pick_device(args.cpu))
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _run(args, cfg, mesh, device):
    """main() once the device (and under --dp the mesh) is settled."""
    from .image.io import load_image, save_image
    from .image.ops import box_downsample2, resize_bilinear
    from .infer.tiled import (lr_pad_dim, make_full_sr_fn, make_generator_fn,
                              make_overlap_sr_fn, overlap_pad_dim,
                              sr_full_image, sr_grid_patches,
                              sr_overlap_image)
    from .metrics import cal_psnr
    from .train.checkpoint import load_generator

    try:
        net, msg = load_generator(cfg, args.ckpt, t7=args.t7, ema=args.ema,
                                  need_state=args.bn_eval, device=device)
    except ValueError as e:
        sys.exit(str(e))
    print(msg)

    if os.path.isdir(args.input):
        return batch_upscale(args, cfg, net, mesh)

    img = load_image(args.input, nc=cfg.nc)
    if args.resize:
        img = resize_bilinear(torch.from_numpy(img), args.resize,
                              args.resize).numpy()
    hw = img[0] if cfg.nc == 1 else img
    H, W = hw.shape[-2], hw.shape[-1]
    pm1 = cfg.data_range == "pm1"
    pm1_in = _in_pm1(cfg)

    ens = dict(self_ensemble=args.self_ensemble,
               ensemble_batched=args.ensemble_batched,
               compute_dtype=_dtype(args))

    if args.true_2x:
        hw_np = np.asarray(hw)
        if cfg.patch_based:     # overlap-tile true-2x (half-geometry tiles)
            p, ov = cfg.patchSize, cfg.overlap
            Hp, Wp = lr_pad_dim(H, p, ov), lr_pad_dim(W, p, ov)
            if (Hp, Wp) != (H, W):
                hw_np = np.pad(hw_np, [(0, Hp - H), (0, Wp - W)], mode="edge")
                print(f"padded LR {H}x{W} -> {Hp}x{Wp} for overlap tiling")
            fn = make_overlap_sr_fn(cfg, net, fine=(2 * Hp, 2 * Wp),
                                    lr_input=True, bn_eval=args.bn_eval,
                                    both_seams=args.both_seams, **ens)
            net_in = torch.from_numpy(
                hw_np * 2.0 - 1.0 if pm1_in else hw_np).to(device)
            sr = fn(net_in[None])["seam"][0].cpu().numpy()
        else:                   # full-image G: feed the LR directly
            fn = make_full_sr_fn(net, lr_input=True, bn_eval=args.bn_eval,
                                 **ens)
            net_in = torch.from_numpy(
                hw_np * 2.0 - 1.0 if pm1_in else hw_np).to(device)
            x = net_in[None, None] if cfg.nc == 1 else net_in[None]
            sr = fn(x)[0].cpu().numpy()
            sr = sr[0] if cfg.nc == 1 else sr
        if pm1:
            sr = (sr + 1.0) * 0.5
        s = _scale(cfg)
        save_image(args.output, np.clip(sr[..., :s * H, :s * W], 0, 1))
        print(f"true-{s}x: {H}x{W} -> {s * H}x{s * W}")
        print(f"wrote {args.output}")
        return

    mode = args.mode
    if mode == "auto":
        mode = ("overlap" if cfg.variant.endswith("overlap")
                else "grid" if cfg.patch_based else "full")

    # native-size SR: pad to the mode's tiling requirement, crop after.  The
    # reference's patch machinery exists exactly so a tiny fixed-size G
    # covers any image (train-gray-patch-batch-overlap.lua:387-399); here
    # rectangular H x W generalizes by construction.
    def pad_to(d):
        p, ov = cfg.patchSize, cfg.overlap
        if mode == "grid":
            q = p if p % 2 == 0 else 2 * p   # patch grid + even (degrade)
            return max(-(-d // q) * q, p)
        if mode == "overlap":
            return overlap_pad_dim(d, p, ov)
        return d + (d % 2)                    # full-conv G: even dims

    Hp, Wp = pad_to(H), pad_to(W)
    hw_np = np.asarray(hw)
    if (Hp, Wp) != (H, W):
        pad = [(0, 0)] * (hw_np.ndim - 2) + [(0, Hp - H), (0, Wp - W)]
        pad_mode = ("reflect" if Hp - H < H and Wp - W < W else "edge")
        hw_np = np.pad(hw_np, pad, mode=pad_mode)
        print(f"padded {H}x{W} -> {Hp}x{Wp} for {mode} tiling")

    gen = make_generator_fn(net, bn_eval=args.bn_eval, **ens)
    net_in = torch.from_numpy(hw_np * 2.0 - 1.0 if pm1 else hw_np).to(device)
    if mode == "overlap":
        fake = sr_overlap_image(cfg, gen, net_in,
                                both_seams=args.both_seams)["seam"]
    elif mode == "grid":
        fake = sr_grid_patches(cfg, gen, net_in)
    else:
        fake, _ = sr_full_image(gen, net_in)
    fake = fake.cpu().numpy()[..., :H, :W]
    if pm1:
        fake = (fake + 1.0) * 0.5
    save_image(args.output, np.clip(fake, 0, 1))
    bil = resize_bilinear(box_downsample2(torch.from_numpy(hw_np)),
                          Hp, Wp).numpy()[..., :H, :W]
    print(f"mode={mode}  size={H}x{W}  "
          f"PSNR(G)={float(cal_psnr(hw, fake)):.3f}  "
          f"PSNR(bilinear)={float(cal_psnr(hw, bil)):.3f}")
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
