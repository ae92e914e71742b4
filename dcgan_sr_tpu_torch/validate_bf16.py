"""Validate bf16-compute training against fp32 on the card (port of
tools/validate_bf16.py; SURVEY.md §7.5: "bf16 compute with fp32 params
where PSNR parity allows — validate!").

Trains gray-3 twice from ONE copied set of initial weights and the same 20
batches, once in fp32 (cuDNN's TF32 off, ops/nn.py) and once in bf16, each
through its own K = 20 step runner (train/multi_step.py: on a card each
chunk after the first is one CUDA graph replay, the preprocess kernel in
every step), then scores both in fp32 on the eval harness (the bulge kernel
on a card) and passes if the bf16 run's PSNR/SSIM is within tolerance of
the fp32 run's.

Both runs and both scores use cuDNN's deterministic algorithms
(torch.backends.cudnn.deterministic on, benchmark off; the caller's
settings are restored after): cuDNN's default algorithms sum with atomics,
and 100 GAN steps amplify that to more than the tolerance between two runs
of one dtype, so the verdict would change from run to run.  The two flags
touch only cuDNN, so a CPU run is unchanged.

  python -m dcgan_sr_tpu_torch.validate_bf16 [--cpu]

Exits 0 on PASS, 1 on FAIL.  The last line counts the kernel launches that
ran (train/multi_step.py `launches_run`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from .core import get_config
from .data import SyntheticImages
from .evaluation import evaluate_slice, inference_generator
from .ops import bulge, preprocess
from .train.multi_step import build_multi_step, launches_run
from .train.step import init_train_state, state_from_numpy, state_to_numpy
from .utils.device import pick_device


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no autotuning; the caller's two
    settings are restored on the way out."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def run(steps=100, batch=100, tol_psnr=1.0, tol_ssim=0.02, device=None,
        k=20, **overrides):
    """The two runs and the verdict line, under `deterministic_cudnn`;
    returns True on PASS.  `device` defaults to the first CUDA device; `k`
    steps a chunk; `overrides` go to get_config (a test's small widths)."""
    if steps < k:
        raise ValueError(f"steps ({steps}) must be at least one chunk of {k}")
    with deterministic_cudnn():
        return _run(steps, batch, tol_psnr, tol_ssim, device, k, overrides)


def _run(steps, batch, tol_psnr, tol_ssim, device, k, overrides):
    device = torch.device(device) if device is not None else pick_device()
    src = SyntheticImages(fine_size=64, nc=1, seed=11)
    batches = torch.from_numpy(np.stack(
        [src.load_batch(s, batch) for s in range(k)])).to(device)
    # one draw of the initial weights, copied into both runs
    cfg0 = get_config("gray-3", env_override=False, batchSize=batch,
                      **overrides)
    init = state_to_numpy(init_train_state(
        cfg0, torch.Generator().manual_seed(5), device="cpu"))

    results, runners = {}, []
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("gray-3", env_override=False, batchSize=batch,
                         compute_dtype=dtype, **overrides)
        state = state_from_numpy(cfg, init, device=device)
        mstep = build_multi_step(cfg)       # a capture per dtype
        runners.append(mstep)
        for _ in range(steps // k):
            state, m = mstep(state, batches)
        # eval in fp32 for both (the fused fp32 copy of G)
        res = evaluate_slice(cfg, inference_generator(cfg, state), src,
                             range(100, 102), batch_size=50)
        results[dtype] = res
        print(f"{dtype:9s}: G-PSNR {res.psnr_generator:.3f}  "
              f"G-SSIM {res.ssim_generator:.4f}  "
              f"(bilinear {res.psnr_bilinear:.3f})  "
              f"errG {float(m['errG'][-1]):.3f}", flush=True)

    dp = abs(results["bfloat16"].psnr_generator
             - results["float32"].psnr_generator)
    ds = abs(results["bfloat16"].ssim_generator
             - results["float32"].ssim_generator)
    ok = dp <= tol_psnr and ds <= tol_ssim
    print(f"delta PSNR {dp:.3f} dB (tol {tol_psnr}), delta SSIM {ds:.4f} "
          f"(tol {tol_ssim}) -> {'PASS' if ok else 'FAIL'}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ran = {**bulge.launches, **preprocess.launches}
    for r in runners:
        ran = launches_run(ran, r)
    print("kernel launches: " + json.dumps(ran), flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)
    return run(device=pick_device(args.cpu))


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
