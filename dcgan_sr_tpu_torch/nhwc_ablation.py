"""Where the tensor-core NHWC pair's time goes, without a profiler: rebuild
csrc/fused_nhwc.cu with one part of the "mma" kernel removed or changed at a
time and time its two launches at bench_fused's shape.

  python -m dcgan_sr_tpu_torch.nhwc_ablation [--batch 100] [--hw 256]
         [--tm 32] [--iters 10]

Each variant is the kernel source with one text substitution (a variant
whose text no longer matches the source stops the run):

  base          the source as it is
  no_stage2     main: the consumer product and the y stores left out
  one_pass      every product one TF32 mma instead of three (the split's low
                halves go unused; the result is off by about 1e-2)
  no_next_x     main: the next item's x is not staged (stage 1 reads stale x)
  no_plane_st   main: the planes are not stored (the epilogue's arithmetic
                stays)
  strides_4     xs and plane pixel strides Ci + 4 and 4 Cm + 4: 8-byte loads
                of a half warp meet bank conflicts
  w1_presplit   stage 1 reads W1 as (hi, lo) pairs split on the host, one
                16-byte load a fragment and no split instructions

Variants change the kernel's arithmetic or skip work, so only their times
mean anything.  The variants build in parallel; then each times its stats
and main launches (CUDA events, `--iters` launches) in turns, in order and
in reverse.  Prints each build's `-Xptxas -v` lines, the base build's SASS
instruction counts where cuobjdump is found beside nvcc, and one JSON line
{variant: [[stats_ms, main_ms], ...]} with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

from .ops import _build as B
from .ops import fused_nhwc as F3

_THREE = """  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);"""
_NEXT_X = """    if (next < gd.n_items) {
      const Item nx = decode(next, gd);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, tid);
    }
    stage2"""
_PLANE_ST = (
    "          *reinterpret_cast<float2*>(hp + q * HS + n0 + ng * 8 + 2 * t) =\n"
    "              make_float2(v[0], v[1]);")
_B1 = """        const float2 bv = *reinterpret_cast<const float2*>(
            w1 + ((ks * N1T + nh * NG + ng) * 32 + lane) * 2);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bv.x, bh0, bl0);
        split_tf32(bv.y, bh1, bl1);"""
_B1_PRESPLIT = """        const float4 bv = *reinterpret_cast<const float4*>(
            w1 + ((ks * N1T + nh * NG + ng) * 32 + lane) * 4);
        const uint32_t bh0 = __float_as_uint(bv.x);
        const uint32_t bh1 = __float_as_uint(bv.y);
        const uint32_t bl0 = __float_as_uint(bv.z);
        const uint32_t bl1 = __float_as_uint(bv.w);"""

VARIANTS = {
    "base": [],
    "no_stage2": [("    stage2<CMP, CO>(hp, s_w2, warp, lane, "
                   "y + it.b * y_img, it, W);\n", "")],
    "one_pass": [(_THREE, "  mma_tf32(c, ah, bh0, bh1);")],
    "no_next_x": [(_NEXT_X, "    stage2")],
    "no_plane_st": [(_PLANE_ST, "          if (v[0] == 123.f && v[1] == 77.f) "
                     "hp[0] = 1.f;")],
    "strides_4": [("return (ci % 32 == 8 || ci % 32 == 24) ? ci : ci + 8;",
                   "return ci + 4;"),
                  ("return 4 * cmp + 8; }", "return 4 * cmp + 4; }"),
                  ("static_assert(xs_stride(8)",
                   "static_assert(true || xs_stride(8)"),
                  ("static_assert(hp_stride(8)",
                   "static_assert(true || hp_stride(8)")],
    "w1_presplit": [(_B1, _B1_PRESPLIT),
                    ("static constexpr int W1N = 4 * CI * 4 * CMP;",
                     "static constexpr int W1N = 8 * CI * 4 * CMP;")],
}
SASS_OPS = ("HMMA", "LDS.64", "LDS ", "STS.64", "LOP3", "FADD", "LDGSTS",
            "STG.E.64", "BAR")


def variant_source(name):
    """csrc/fused_nhwc.cu with variant `name`'s substitutions (every
    occurrence); raises if one no longer matches the source."""
    with open(os.path.join(B.CSRC, "fused_nhwc.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: its text is no longer in "
                               f"csrc/fused_nhwc.cu: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _presplit(w):
    """Fragment-order W1 as (hi, hi, lo, lo) per lane: the split the kernel
    makes in registers, made here."""
    import torch
    w = w.reshape(-1, 2)
    hi = (w.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return torch.cat([hi, w - hi], dim=1).reshape(-1).contiguous()


def _bind(path):
    """The wrapper module bound to the library at `path`."""
    lib = ctypes.CDLL(path)
    F3._lib = None
    build = F3.compile_and_load
    F3.compile_and_load = lambda stem: (lib, "")
    try:
        return F3.build()
    finally:
        F3.compile_and_load = build


def _sass_counts(nvcc, so):
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    out = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True).stdout
    counts, func = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            if "_ZN2tc" not in func:        # the tensor-core kernels
                func = None
            else:
                counts[func] = dict.fromkeys(SASS_OPS, 0)
        elif func:
            for op in SASS_OPS:
                counts[func][op] += op in line
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--tm", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("nhwc_ablation times the kernel on a card; none "
                           "is visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    nvcc = B.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in VARIANTS:
            cu = os.path.join(tmp, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(variant_source(name))
            procs[name] = subprocess.Popen(
                [nvcc, *B.NVCC_FLAGS, "-o", os.path.join(tmp, f"{name}.so"),
                 cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        for name, p in procs.items():
            log = p.communicate()[0]
            if p.returncode:
                raise RuntimeError(f"variant {name} does not build:\n{log}")
            print(f"{name}: " + " | ".join(
                ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln), flush=True)
        print("base SASS: " + json.dumps(
            _sass_counts(nvcc, os.path.join(tmp, "base.so"))), flush=True)

        dev = torch.device("cuda")
        rng = np.random.RandomState(0)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        x = t(rng.rand(args.batch, 16, args.hw, args.hw))
        wT = t(0.05 * rng.randn(16, 8, 4, 4))
        wC = t(0.05 * rng.randn(16, 8, 4, 4))
        xn = x.permute(0, 2, 3, 1).contiguous()
        w1, w2 = F3.operands(wT, wC, "mma")
        ops = {name: (w1, w2) for name in VARIANTS}
        ops["w1_presplit"] = (_presplit(w1), w2)
        bn = torch.stack([torch.zeros(32), torch.ones(32),
                          torch.zeros(32)]).to(dev).contiguous()

        def time_ms(fn):
            fn()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(args.iters):
                fn()
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / args.iters

        times = {}
        try:
            for name in list(VARIANTS) + list(reversed(VARIANTS)):
                _bind(os.path.join(tmp, f"{name}.so"))
                a, b = ops[name]
                times.setdefault(name, []).append([
                    time_ms(lambda: F3.launch_stats(xn, a, 8, args.tm, "mma")),
                    time_ms(lambda: F3.launch_main(xn, a, b, bn, 8, 16,
                                                   args.tm, "mma"))])
        finally:
            F3._lib = None          # the next build() loads the real kernel
    print(json.dumps({"card": smi, "x": list(x.shape), "tm": args.tm,
                      "ms": times}))


if __name__ == "__main__":
    main()
