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

The command line starts both runs from the JAX tool's own initial state:
its `init_train_state(gray-3, PRNGKey(5))`, committed as
fixtures/gray3_jax_init_key5.npz (weights and BN statistics in fp32; Adam's
moments start at zero), so its verdict is the JAX tool's experiment.
`run(seed=N)` without `init=` draws the initial state from torch instead.

  python -m dcgan_sr_tpu_torch.validate_bf16 [--cpu]

Exits 0 on PASS, 1 on FAIL.  The last line counts the kernel launches that
ran (train/multi_step.py `launches_run`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from .core import get_config
from .data import SyntheticImages
from .evaluation import evaluate_slice, inference_generator
from .models import discriminator_spec, generator_spec
from .ops import bulge, preprocess
from .train.multi_step import build_multi_step, launches_run
from .train.step import init_train_state, state_from_numpy, state_to_numpy
from .utils.device import pick_device

# the JAX tool's initial state (tests/test_torch_validate_init.py --write)
JAX_INIT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "fixtures", "gray3_jax_init_key5.npz")


def _layers(flat, field, n):
    """The `field/<layer>/<name>[/<name>]` arrays of `flat` as a list of n
    per-layer dicts (a layer without any: {})."""
    out = [{} for _ in range(n)]
    for key, a in flat.items():
        head, i, *names = key.split("/")
        if head != field:
            continue
        d = out[int(i)]
        for name in names[:-1]:
            d = d.setdefault(name, {})
        d[names[-1]] = a
    return out


def jax_init(path=JAX_INIT):
    """The gray-3 initial state of `path` as a numpy state tree in
    `state_to_numpy`'s layout: its weights and BN statistics, Adam's
    moments at zero with t = 0 (the JAX package's `adam_init`), no EMA."""
    cfg = get_config("gray-3", env_override=False)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree = {"g_ema_params": None}
    for tag, spec in (("g", generator_spec(cfg)),
                      ("d", discriminator_spec(cfg))):
        params = _layers(flat, f"{tag}_params", len(spec))
        tree[f"{tag}_params"] = params
        tree[f"{tag}_state"] = _layers(flat, f"{tag}_state", len(spec))
        tree[f"{tag}_opt"] = {
            m: [{k: np.zeros_like(a) for k, a in p.items()} for p in params]
            for m in ("m", "v")}
        tree[f"{tag}_opt"]["t"] = np.asarray(0, np.int32)
    return tree


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
        k=20, seed=5, init=None, **overrides):
    """The two runs and the verdict line, under `deterministic_cudnn`;
    returns True on PASS.  `device` defaults to the first CUDA device; `k`
    steps a chunk; `init` is the one initial state both runs start from (a
    numpy tree in `state_to_numpy`'s layout, e.g. `jax_init()`), else
    `seed` draws it; `overrides` go to get_config (a test's small
    widths)."""
    if steps < k:
        raise ValueError(f"steps ({steps}) must be at least one chunk of {k}")
    with deterministic_cudnn():
        return _run(steps, batch, tol_psnr, tol_ssim, device, k, seed, init,
                    overrides)


def _run(steps, batch, tol_psnr, tol_ssim, device, k, seed, init,
         overrides):
    device = torch.device(device) if device is not None else pick_device()
    src = SyntheticImages(fine_size=64, nc=1, seed=11)
    batches = torch.from_numpy(np.stack(
        [src.load_batch(s, batch) for s in range(k)])).to(device)
    if init is None:
        # one draw of the initial weights, copied into both runs
        cfg0 = get_config("gray-3", env_override=False, batchSize=batch,
                          **overrides)
        init = state_to_numpy(init_train_state(
            cfg0, torch.Generator().manual_seed(seed), device="cpu"))

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
    return run(device=pick_device(args.cpu), init=jax_init())


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
