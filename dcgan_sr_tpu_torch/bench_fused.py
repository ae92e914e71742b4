"""Measure the fused convT+BN+ReLU+conv kernels against the unfused
composition at the gray-3 bulge geometry (B=100, 16ch 256 -> 8ch 512 -> 16ch
256).  Port of tools/bench_fused.py.

  python -m dcgan_sr_tpu_torch.bench_fused [--batch 100] [--hw 256]
         [--dtype bf16|fp32] [--kernel bulge|nhwc] [--tm 32] [--iters 20]
         [--reps 3] [--cpu]

--kernel bulge times ops/bulge.py (csrc/bulge_wgmma.cu at this shape),
--kernel nhwc ops/fused_nhwc.py (csrc/fused_nhwc_wgmma.cu at this shape, in
either dtype); the unfused composition is the port's conv_transpose2d,
batch statistics, normalize, ReLU and conv2d (cuDNN with TF32 off on the
card).  A timing is CUDA events around --iters
back-to-back calls ending in a synchronize, best of --reps; with --cpu the
host clock (the CPU run checks the plumbing: its times are not the card's).
Prints a line with each kernel's launches by implementation ("wgmma" TMA
and wgmma, "mma" mma.sync tensor cores, "fma" the FMA kernel, chosen by the
shapes; "_bf16" for bf16 x), one with the kernels' launch counts, then
one JSON line with the JAX tool's keys.  `--dtype bf16`,
the default as in the JAX tool (tools/bench_fused.py:31), feeds x in bf16
(the weights stay fp32, as in the JAX tool) to the kernel's bf16
instantiation (either kernel) and to the unfused composition in bf16 (the
port's bf16 convolutions and BN); `--dtype fp32` runs both in fp32.
"""

from __future__ import annotations

import argparse
import json
import time


def _unfused_bf16(x, wT, scale, bias, wC):
    """Layers 3-4 unfused in bf16, as the bf16 generator runs them: convT,
    BN (fp32 statistics, bf16 affine), ReLU, conv (ops/nn.py)."""
    from .ops import nn as N
    bf16 = x.dtype
    h = N.conv_transpose2d(x, wT, 2, 1, compute_dtype=bf16)
    h, _ = N.batch_norm(h, scale, bias)
    return N.conv2d(N.relu(h), wC, 2, 1, compute_dtype=bf16), None


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                    help="x's dtype (the weights stay fp32)")
    ap.add_argument("--kernel", default="bulge", choices=["bulge", "nhwc"])
    ap.add_argument("--tm", type=int, default=32,
                    help="band height of the nhwc kernel")
    ap.add_argument("--iters", type=int, default=20,
                    help="back-to-back calls inside one timing")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .ops import bulge as K
    from .ops import fused_nhwc as F
    from .utils.device import pick_device

    device = pick_device(args.cpu)
    rng = np.random.RandomState(0)
    b, hw = args.batch, args.hw
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    x = t(rng.rand(b, 16, hw, hw))
    if args.dtype == "bf16":
        x = x.to(torch.bfloat16)
    wT = t(0.05 * rng.randn(16, 8, 4, 4))
    wC = t(0.05 * rng.randn(16, 8, 4, 4))
    scale = torch.ones(8, device=device)
    bias = torch.zeros(8, device=device)

    def unfused():
        if x.dtype == torch.bfloat16:      # the JAX tool's unfused bf16 layers
            return _unfused_bf16(x, wT, scale, bias, wC)
        return K.bulge_plain(x, wT, scale, bias, wC)

    if args.kernel == "bulge":
        def fused():
            return K.bulge(x, wT, scale, bias, wC)
    else:
        def fused():
            return F.fused_convT_bn_relu_conv(x, wT, scale, bias, wC,
                                              tm=args.tm)

    def timeit(f, tag):
        with torch.inference_mode():
            f()                                         # build + warm
            best = float("inf")
            for _ in range(args.reps):
                if device.type == "cuda":
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(args.iters):
                        f()
                    e1.record()
                    e1.synchronize()
                    ms = e0.elapsed_time(e1) / args.iters
                else:
                    t0 = time.perf_counter()
                    for _ in range(args.iters):
                        f()
                    ms = (time.perf_counter() - t0) / args.iters * 1e3
                best = min(best, ms)
        print(f"{tag:10s} {best:8.3f} ms/iter", flush=True)
        return best

    t_ref = timeit(unfused, "unfused")
    t_fused = timeit(fused, "fused")
    with torch.inference_mode():
        y_ref, _ = unfused()
        y_fused, _ = fused()
        err = float((y_ref.float() - y_fused.float()).abs().max())
    print("implementation launches: " + json.dumps(
        {"bulge": K.impl_launches, "fused_nhwc": F.impl_launches}))
    print("kernel launches: " + json.dumps({**K.launches, **F.launches}))
    print(json.dumps({"batch": b, "hw": hw, "dtype": args.dtype,
                      "kernel": args.kernel,
                      "tm": args.tm, "unfused_ms": round(t_ref, 3),
                      "fused_ms": round(t_fused, 3),
                      "speedup": round(t_ref / t_fused, 3),
                      "max_abs_diff": err, "device": str(device)}))


if __name__ == "__main__":
    main()
