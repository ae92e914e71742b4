"""Quality-parity protocol on the card: the port's twin of the trained
torch baseline, and the baseline's weights scored by the port's harness
(port of tools/quality_protocol.py).

Three measurements:
  1. the port trains the same protocol the torch baseline trained (the
     committed TexturedImages set, batch 20, the baseline's ntrain, epochs
     and seed, the reference step semantics; the preprocess kernel in every
     step on a card) and scores it with the reference eval
     (train-gray-3.lua:354-535 shape; the bulge kernel on a card);
  2. the TORCH-trained weights are imported positionally
     (`load_torch_weights_into_params`) and scored by the same harness on
     the same slices;
  3. the imported generator's fused forward (the bulge kernel on a card) is
     compared with its unfused forward on one batch.  The JAX tool compares
     torch's stack with JAX's here; the port is torch, so that comparison
     is the port's tests' (tests/test_torch_tools.py).

Reads `result.json` and `torch_weights.npz` from --torch-dir, as
tools/torch_baseline.py writes them (it is not imported), and prints a
markdown table fragment.

  python -m dcgan_sr_tpu_torch.quality_protocol [--torch-dir DIR]
      [--config gray-3] [--skip-twin] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .core import get_config
from .data import TexturedImages
from .evaluation import evaluate_slice, inference_generator
from .image.ops import box_downsample2
from .models import Network, generator_spec, init_network
from .ops import bulge, preprocess
from .train.loop import train_epochs
from .train.step import init_train_state
from .utils.device import pick_device


def load_torch_weights_into_params(npz, tag, spec, params):
    """params (the port's per-layer dicts) with every conv weight and BN
    affine replaced from torch_baseline's positional npz dump
    (`{tag}_{i}_w`, `{tag}_{i}_bn_w`, `{tag}_{i}_bn_b`), as float32 numpy
    arrays.  i is the module's index in the nn.Sequential the baseline
    saves, in the JAX package's spec_to_torch order: an upsample or flatten
    is one module; a conv is one, then its BatchNorm2d, then its
    activation."""
    out = [dict(p) for p in params]
    i = 0
    for layer, p in zip(spec, out):
        kind = layer["kind"]
        if kind in ("upsample", "flatten"):
            i += 1
            continue
        if kind not in ("conv", "convT"):
            raise KeyError(kind)
        p["w"] = np.asarray(npz[f"{tag}_{i}_w"], np.float32)
        i += 1
        if layer.get("bn"):
            p["bn_scale"] = np.asarray(npz[f"{tag}_{i}_bn_w"], np.float32)
            p["bn_bias"] = np.asarray(npz[f"{tag}_{i}_bn_b"], np.float32)
            i += 1
        if layer.get("act") is not None:
            i += 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--torch-dir", default="/tmp/torch_baseline")
    ap.add_argument("--config", default="gray-3")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    ap.add_argument("--skip-twin", action="store_true",
                    help="only run the imported-weights checks")
    args = ap.parse_args(argv)

    device = pick_device(args.cpu)
    with open(os.path.join(args.torch_dir, "result.json")) as f:
        tres = json.load(f)
    print("torch baseline:", json.dumps(tres["train"]),
          json.dumps(tres["test"]))
    batch, ntrain = 20, tres["ntrain"]
    epochs, seed, eval_sets = tres["epochs"], tres["seed"], 5

    cfg = get_config(args.config, env_override=False,
                     batchSize=batch, ntrain=ntrain)
    cfg.manualSeed = seed
    src = TexturedImages(cfg.fineSize, nc=1, seed=1234)
    test_sets = range(2000, 2000 + eval_sets)

    rows = []

    # ---- 1. the port's twin: same protocol, the port's stack --------------
    if not args.skip_twin:
        state = init_train_state(cfg, torch.Generator().manual_seed(seed),
                                 device=device)

        def batch_fn(epoch, i):
            return src.load_batch(i, batch)

        state, _ = train_epochs(cfg, state, batch_fn, niter=epochs,
                                steps_per_epoch=ntrain // batch,
                                log_every=20)
        gen = inference_generator(cfg, state)
        rows.append(("ours (port, same protocol/seed)",
                     evaluate_slice(cfg, gen, src, range(eval_sets)),
                     evaluate_slice(cfg, gen, src, test_sets)))

    # ---- 2. torch-trained weights scored by the port's harness ------------
    g_spec = generator_spec(cfg)
    g_params0, g_state0 = init_network(g_spec,
                                       torch.Generator().manual_seed(0))
    with np.load(os.path.join(args.torch_dir, "torch_weights.npz")) as npz:
        g_params_t = load_torch_weights_into_params(npz, "g", g_spec,
                                                    g_params0)
    fused = Network(g_spec, g_params_t, g_state0, device=device)
    rows.append(("torch-trained, OUR eval",
                 evaluate_slice(cfg, fused, src, range(eval_sets)),
                 evaluate_slice(cfg, fused, src, test_sets)))

    # ---- 3. fused against unfused forward on one batch --------------------
    unfused = Network(g_spec, g_params_t, g_state0, device=device, fuse=False)
    hr = torch.from_numpy(src.load_batch(0, batch)).to(device)
    lr = box_downsample2(hr)
    with torch.inference_mode():
        diff = float((fused(lr) - unfused(lr)).abs().max())
    print(f"forward compare (fused vs unfused, imported weights): "
          f"max |diff| = {diff:.3e}")

    # ---- table --------------------------------------------------------------
    def fmt(r):
        return (f"{r.psnr_generator:.3f} / {r.ssim_generator:.4f} "
                f"(bilinear {r.psnr_bilinear:.3f} / {r.ssim_bilinear:.4f})")

    print("\n| stack | train PSNR/SSIM | test PSNR/SSIM |")
    print("|---|---|---|")
    tt, te = tres["train"], tres["test"]
    print(f"| torch-CPU trained+evaluated | {tt['psnr_generator']:.3f} / "
          f"{tt['ssim_generator']:.4f} (bilinear {tt['psnr_bilinear']:.3f} / "
          f"{tt['ssim_bilinear']:.4f}) | {te['psnr_generator']:.3f} / "
          f"{te['ssim_generator']:.4f} (bilinear {te['psnr_bilinear']:.3f} / "
          f"{te['ssim_bilinear']:.4f}) |")
    for name, tr, ts in rows:
        print(f"| {name} | {fmt(tr)} | {fmt(ts)} |")
    print(f"\nforward max|diff| = {diff:.3e}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("kernel launches: " + json.dumps(
        {**bulge.launches, **preprocess.launches}), flush=True)
    return rows, diff


if __name__ == "__main__":
    main()
