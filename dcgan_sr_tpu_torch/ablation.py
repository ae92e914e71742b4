"""Where a tensor-core kernel's time goes, without a profiler: rebuild its
CUDA source with one part removed or changed at a time and time its two
launches.

  python -m dcgan_sr_tpu_torch.ablation --kernel bulge [--iters 10]
  python -m dcgan_sr_tpu_torch.ablation --kernel bulge_wgmma [--iters 10]
  python -m dcgan_sr_tpu_torch.ablation --kernel bulge_wgmma_f32 [--iters 10]
  python -m dcgan_sr_tpu_torch.ablation --kernel nhwc [--batch 100]
         [--hw 256] [--tm 32] [--iters 10]
  python -m dcgan_sr_tpu_torch.ablation --kernel nhwc_wgmma[_f32] [--batch
         100] [--hw 256] [--iters 10]

Each variant is the kernel source with text substitutions (every
occurrence; a variant whose text no longer matches the source stops the
run).

  --kernel bulge: csrc/bulge.cu's bf16 kernel (namespace tcb), at x
  (1,16,2048,2048) and (14400,32,32,32)
    base          the source as it is: launch bound 2, two blocks an SM
    one_block     launch bound 1: the compiler may use up to 255
                  registers, so one block an SM
    no_stage2     main: the consumer product and the y stores left out
    no_next_x     main: the next item's x is not staged (stage 1 reads
                  stale x)

  --kernel bulge_wgmma: csrc/bulge_wgmma.cu (the bf16 kernel the paths
  run), at the same two shapes
    base          the source as it is
    no_transpose  the producer does not turn the box into xq (stage 1
                  reads stale xq)
    no_wgmma      no wgmma.mma_async (stage 2's A fragments are still
                  loaded)
    no_a_loads    stage 2: no ldmatrix of A (wgmma multiplies addresses)
    no_hp_store   main: stage 1's epilogue stores no hidden plane
    no_y_store    main: no y store to device memory
    stage2_quarter main: stage 2 runs one of its four m64 tiles (y rows
                  0-1)
    skeleton      the five left-outs above together: the TMA ring, the
                  barriers, the epilogues' arithmetic and the y stores'
                  address math remain
    skeleton_no_tma  skeleton without the TMA load: the producer arrives
                  on the full barrier itself

  --kernel bulge_wgmma_f32: csrc/bulge_wgmma.cu's fp32 kernel (namespace
  wgf, 3xTF32 on wgmma; the fp32 paths run it), at x (1,16,2048,2048),
  (100,16,256,256) and (14400,32,32,32).  It has no K-major copy of x (the
  lanes load A from the TMA box into registers), so `no_a_loads` is the
  variant that takes x's way to the tensor cores out.
    base          the source as it is
    one_pass      one TF32 product a product (hi*hi) instead of three: no
                  split (the result is off by about 1e-3)
    no_wgmma      no wgmma.mma_async (A is still loaded and split)
    no_a_loads    A's shared-memory loads left out (its split and the
                  products stay)
    no_hp_store   main: stage 1's epilogue stores no hidden plane
    no_y_store    main: no y store to device memory
    no_stage2     main: stage 2 left out (stage 1, its epilogue and the
                  barriers stay)
    skeleton      no_wgmma, no_a_loads, no_hp_store and no_y_store together:
                  the TMA loads, the barriers, the split and the epilogues'
                  arithmetic remain
    skeleton_no_tma  skeleton without the TMA load: the issuing thread
                  arrives on the full barrier itself

  --kernel nhwc: csrc/fused_nhwc.cu's fp32 kernel (namespace tc), at
  bench_fused's shape (--batch, 16, --hw, --hw), row bands of --tm
    base          the source as it is
    no_stage2     main: the consumer product and the y stores left out
    one_pass      every product one TF32 mma instead of three (the split's
                  low halves go unused; the result is off by about 1e-2)
    no_next_x     main: the next item's x is not staged (stage 1 reads
                  stale x)
    no_plane_st   main: the planes are not stored (the epilogue's
                  arithmetic stays)
    strides_4     xs and plane pixel strides Ci + 4 and 4 Cm + 4: 8-byte
                  loads of a half warp meet bank conflicts
    w1_presplit   stage 1 reads W1 as (hi, lo) pairs split on the host, one
                  16-byte load a fragment and no split instructions

  --kernel nhwc_wgmma_f32: csrc/fused_nhwc_wgmma.cu in fp32 (3xTF32 on
  wgmma, the kernel bench_fused --kernel nhwc --dtype fp32 runs), at
  bench_fused's shape
    base          the source as it is: A (hi and lo) from registers
    a_desc        hi*hi and hi*lo read A by descriptor from the box and the
                  hidden planes (wgmma truncates the fp32 word to hi); only
                  lo is loaded
    one_pass      one TF32 product a k-step (hi*hi) instead of three (the
                  result is off by about 1e-3)
    no_a_loads    A's shared-memory loads left out (its split and the
                  products stay)
    kc2           main: groups of 2 k-steps of A registers, as in the stats
                  kernel, instead of 4
    stats_kc2     stats: groups of 2 k-steps instead of 1 (ptxas then
                  serializes the wgmma for want of registers)
    stats_one_block  stats: launch bound 1 (up to 255 registers a thread,
                  one block an SM) instead of 2 at Ci 16
    no_wgmma, no_hp_store, no_y_store, no_stage2, no_tma, skeleton,
    skeleton_no_tma, l2_none, l2_256, three_wgs   as for --kernel
                  nhwc_wgmma

  --kernel nhwc_wgmma: csrc/fused_nhwc_wgmma.cu in bf16 (the kernel
  bench_fused --kernel nhwc runs by default), at bench_fused's shape
    base          the source as it is
    no_wgmma      no wgmma.mma_async (fp32: A is still loaded and split)
    no_hp_store   main: stage 1's epilogue stores no hidden plane
    no_y_store    main: no y store to device memory
    no_stage2     main: stage 2 left out (stage 1, its epilogue and the
                  barriers stay)
    no_tma        the TMA loads left out: the issuing thread arrives on the
                  box's barrier itself (the products read stale boxes)
    skeleton      no_wgmma, no_hp_store and no_y_store (fp32: and
                  no_a_loads) together: the TMA loads, the barriers and the
                  epilogues' arithmetic remain
    skeleton_no_tma  skeleton without the TMA loads
    l2_none, l2_256  the tensor maps' L2 promotion none or 256 bytes
                  instead of 128
    three_wgs     main: three warpgroups a block instead of two (each its
                  own box and hidden planes; one box each where two do not
                  fit)

Variants change the kernel's arithmetic or skip work, so only their times
mean anything.  The variants build in parallel; then each times its stats
and main launches (CUDA events, `--iters` launches) at every shape, in
turns, in order and in reverse.  Prints each build's `-Xptxas -v` lines for
the ablated kernels, the base build's SASS instruction counts where
cuobjdump is found beside nvcc, and one JSON line {variant: {shape:
[[stats_ms, main_ms], ...]}} with the card's name and power limit.  Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
from typing import Callable, NamedTuple

from .ops import _build as B
from .ops import bulge as K2
from .ops import fused_nhwc as K3

# ---- K2 (csrc/bulge.cu), the bf16 tensor-core kernel ----------------------

_K2_NEXT_X = """      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, vec, tid);
    }
    stage2<CMP, CO>(hp, s_w2, warp, lane, y + it.b * y_img, it.r0, it.c0, H,
                    W);"""
_K2_VARIANTS = {
    "base": [],
    "one_block": [("__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 1)")],
    "no_stage2": [(_K2_NEXT_X, _K2_NEXT_X.split("\n")[0] + "\n    }")],
    "no_next_x": [(_K2_NEXT_X,
                   "    }\n" + "\n".join(_K2_NEXT_X.split("\n")[2:]))],
}


def _k2_cases(args, torch, rng, dev, impl="mma", dtype=None,
              shapes=((1, 16, 2048, 2048), (14400, 32, 32, 32))):
    cases = {}
    for b, ci, h, w in shapes:
        cm = ci // 2
        x = torch.rand((b, ci, h, w), device=dev).to(dtype or torch.bfloat16)
        wT, wC = (torch.tensor(0.05 * rng.randn(ci, cm, 4, 4),
                               dtype=torch.float32, device=dev)
                  for _ in range(2))
        mu = torch.zeros((b, cm), device=dev)
        gain = torch.ones((b, cm), device=dev)
        beta = torch.zeros(cm, device=dev)

        def launches(name, x=x, wT=wT, wC=wC, mu=mu, gain=gain, beta=beta):
            return (lambda: K2.launch_stats(x, wT, impl),
                    lambda: K2.launch_main(x, wT, wC, mu, gain, beta, impl))
        cases[str((b, ci, h, w))] = launches
    return cases


def _k2_mma_cases(args, torch, rng, dev):
    return _k2_cases(args, torch, rng, dev, "mma")


def _k2_wgmma_cases(args, torch, rng, dev):
    return _k2_cases(args, torch, rng, dev, "wgmma")


def _k2_wgmma_f32_cases(args, torch, rng, dev):
    return _k2_cases(args, torch, rng, dev, "wgmma", torch.float32,
                     ((1, 16, 2048, 2048), (100, 16, 256, 256),
                      (14400, 32, 32, 32)))


# ---- K2 in bf16 on Hopper's units (csrc/bulge_wgmma.cu) ---------------------

_WG_TRANSPOSE = """    ldsm_x4_t(v, box_s + (((cg * 8 + rr) * XR + r) * XC + cb * 8) * 2);
    stsm_x4((unsigned)col < (unsigned)XQC
                ? xq_s + (cg * XQPOS + r * XQC + col) * 16 : junk_s, v);"""
_WG_VARIANTS = {
    "base": [],
    "no_transpose": [(_WG_TRANSPOSE, "    (void)v; (void)col; (void)box_s; "
                      "(void)xq_s; (void)junk_s; (void)cg; (void)r; (void)rr;"
                      )],
    "no_wgmma": [("      Wgmma<N>::run(dd, aa[ks], desc(b0 + (h * KH + ks) * "
                  "b_step, lbo, 128));", "      dd[ks % (N / 2)] += "
                  "__uint_as_float(aa[ks][0] ^ (uint32_t)desc(b0 + (h * KH + "
                  "ks) * b_step, lbo, 128));"),
                 ("      WgmmaSS<N>::run(dd, desc(a0 + a_koff(ks), a_lbo, 128),\n"
                  "                      desc(b0 + ks * b_step, b_lbo, 128));",
                  "      dd[ks % (N / 2)] += __uint_as_float((uint32_t)(desc("
                  "a0 + a_koff(ks), a_lbo, 128) ^ desc(b0 + ks * b_step, "
                  "b_lbo, 128)));")],
    "no_a_loads": [("    for (int ks = 0; ks < KH; ++ks) ldsm_x4(aa[ks], r + "
                    "off(h * KH + ks));", "    for (int ks = 0; ks < KH; ++ks) "
                    "aa[ks][0] = aa[ks][1] = aa[ks][2] = aa[ks][3] = r + off(h "
                    "* KH + ks);")],
    "no_hp_store": [("              stsm_x4(pj <= TW && q <= LASTQ\n"
                     "                          ? hp_s + (plane * NPOS + pi * "
                     "PC + pj) * 16\n                          : junk_s, v);",
                     "              if (v[0] == 0x7fc07fc0u && v[3] == 1u && "
                     "q == plane + pi + pj) stsm_x4(junk_s, v);")],
    "no_y_store": [("          *reinterpret_cast<uint4*>(yb + ((size_t)co * H + "
                    "row) * W + col) = v;", "          if (v.x == 0x7fc07fc0u "
                    "&& v.w == 1u) *reinterpret_cast<uint4*>(yb) = v;")],
    "stage2_quarter": [("pipelined_halves<N2, K2S, M2T>(",
                        "pipelined_halves<N2, K2S, 1>(")],
    "skeleton": None, "skeleton_no_tma": None,
}
_WG_VARIANTS["skeleton"] = [
    sub for name in ("no_transpose", "no_wgmma", "no_a_loads", "no_hp_store",
                     "no_y_store") for sub in _WG_VARIANTS[name]]
_WG_VARIANTS["skeleton_no_tma"] = _WG_VARIANTS["skeleton"] + [(
    """    mbar_expect_tx(&full[slot], (uint32_t)BOX);
    tma_load_box(smem + o_ring + slot * al128(BOX), map, &full[slot],
                 m.c0 - XO - 1, m.r0 - 1, m.b);""", """    mbar_arrive(&full[slot]);
    (void)m; (void)map;""")]


# ---- K2 in fp32 on Hopper's units (csrc/bulge_wgmma.cu namespace wgf) -------

_WF_PRODUCTS = """      Tf32<N>::run(d[u], al[s][kk], bh);
      Tf32<N>::run(d[u], ah[s][kk], bl);
      Tf32<N>::run(d[u], ah[s][kk], bh);"""
_WF_VARIANTS = {
    "base": [],
    "one_pass": [(_WF_PRODUCTS, _WF_PRODUCTS.split("\n")[2])],
    "no_wgmma": [(_WF_PRODUCTS, "      d[u][kk % (N / 2)] += __uint_as_float("
                  "al[s][kk][0] ^ al[s][kk][1] ^ al[s][kk][2] ^ "
                  "al[s][kk][3] ^ ah[s][kk][0] ^ ah[s][kk][1] ^ "
                  "ah[s][kk][2] ^ ah[s][kk][3] ^ (uint32_t)(bh ^ bl));")],
    "no_a_loads": [("      load(u, (c % CPU) * KC + kk, v);",
                    "      v[0] = v[1] = v[2] = v[3] = __int_as_float("
                    "0x3f800000 + c * KC + kk);")],
    "no_hp_store": [("""          *reinterpret_cast<float2*>(
              hp + ((par * CG + cg) * Gm::NPOS + q) * 8 + 2 * t) = o;""",
                     "          if (o.x == 123.f && o.y == 77.f) "
                     "hp[0] = 1.f;")],
    "no_y_store": [("""                  yp[(size_t)(8 * j2 + 2 * t + c) * H * W] =
                      d[4 * j2 + 2 * i + c];""",
                    "                  if (d[4 * j2 + 2 * i + c] == 123.f) "
                    "yp[0] = 1.f;")],
    "no_stage2": [("    chain<N2, K2S, KC, U2, LBO2, (uint32_t)S::W2P>(",
                   "    if (n_items < 0) chain<N2, K2S, KC, U2, LBO2, "
                   "(uint32_t)S::W2P>(")],
    "skeleton": None, "skeleton_no_tma": None,
}
_WF_VARIANTS["skeleton"] = [
    sub for name in ("no_wgmma", "no_a_loads", "no_hp_store", "no_y_store")
    for sub in _WF_VARIANTS[name]]
_WF_VARIANTS["skeleton_no_tma"] = _WF_VARIANTS["skeleton"] + [(
    """  wg::mbar_expect_tx(bar, bytes);
  wg::tma_load_box(dst, map, bar, m.c0 - XO - 1, m.r0 - 1, m.b);""",
    """  wg::mbar_arrive(bar);
  (void)m; (void)map; (void)dst; (void)bytes;""")]


# ---- K3 (csrc/fused_nhwc.cu), the fp32 tensor-core kernel -----------------

_K3_THREE = """  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);"""
_K3_NEXT_X = """    if (next < gd.n_items) {
      const Item nx = decode(next, gd);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, tid);
    }
    stage2"""
_K3_PLANE_ST = (
    "          *reinterpret_cast<float2*>(hp + q * HS + n0 + ng * 8 + 2 * t) =\n"
    "              make_float2(v[0], v[1]);")
_K3_B1 = """        const float2 bv = *reinterpret_cast<const float2*>(
            w1 + ((ks * N1T + nh * NG + ng) * 32 + lane) * 2);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bv.x, bh0, bl0);
        split_tf32(bv.y, bh1, bl1);"""
_K3_B1_PRESPLIT = """        const float4 bv = *reinterpret_cast<const float4*>(
            w1 + ((ks * N1T + nh * NG + ng) * 32 + lane) * 4);
        const uint32_t bh0 = __float_as_uint(bv.x);
        const uint32_t bh1 = __float_as_uint(bv.y);
        const uint32_t bl0 = __float_as_uint(bv.z);
        const uint32_t bl1 = __float_as_uint(bv.w);"""
_K3_VARIANTS = {
    "base": [],
    "no_stage2": [("    stage2<CMP, CO>(hp, s_w2, warp, lane, "
                   "y + it.b * y_img, it, W);\n", "")],
    "one_pass": [(_K3_THREE, "  mma_tf32(c, ah, bh0, bh1);")],
    "no_next_x": [(_K3_NEXT_X, "    stage2")],
    "no_plane_st": [(_K3_PLANE_ST, "          if (v[0] == 123.f && v[1] == 77.f) "
                     "hp[0] = 1.f;")],
    "strides_4": [("return (ci % 32 == 8 || ci % 32 == 24) ? ci : ci + 8;",
                   "return ci + 4;"),
                  ("return 4 * cmp + 8; }", "return 4 * cmp + 4; }"),
                  ("static_assert(xs_stride(8)",
                   "static_assert(true || xs_stride(8)"),
                  ("static_assert(hp_stride(8)",
                   "static_assert(true || hp_stride(8)")],
    "w1_presplit": [(_K3_B1, _K3_B1_PRESPLIT),
                    ("static constexpr int W1N = 4 * CI * 4 * CMP;",
                     "static constexpr int W1N = 8 * CI * 4 * CMP;")],
}


def _presplit(torch, w):
    """Fragment-order W1 as (hi, hi, lo, lo) per lane: the split the kernel
    makes in registers, made here."""
    w = w.reshape(-1, 2)
    hi = (w.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return torch.cat([hi, w - hi], dim=1).reshape(-1).contiguous()


def _k3_cases(args, torch, rng, dev):
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    x = t(rng.rand(args.batch, 16, args.hw, args.hw))
    wT, wC = t(0.05 * rng.randn(16, 8, 4, 4)), t(0.05 * rng.randn(16, 8, 4, 4))
    xn = x.permute(0, 2, 3, 1).contiguous()
    w1, w2 = K3.operands(wT, wC, "mma")
    presplit = _presplit(torch, w1)
    bn = torch.stack([torch.zeros(32), torch.ones(32),
                      torch.zeros(32)]).to(dev).contiguous()

    def launches(name):
        a = presplit if name == "w1_presplit" else w1
        return (lambda: K3.launch_stats(xn, a, 8, args.tm, "mma"),
                lambda: K3.launch_main(xn, a, w2, bn, 8, 16, args.tm, "mma"))
    return {str(tuple(x.shape)): launches}


# ---- K3 on Hopper's units (csrc/fused_nhwc_wgmma.cu), fp32 and bf16 ------

_NW_TMA = """  mbar_expect_tx(bar, (uint32_t)(CIG * PLANE * 16));
#pragma unroll
  for (int g = 0; g < CIG; ++g)
    tma_load(dst + (size_t)g * BP * 16, &maps->m[g], bar, m.c0 - 1,
             m.r0 - 1, m.b);"""
_NW_F32_STEP = """    Tf32RS<N>::run(d, lo, bd);
    if constexpr (kHiByDesc) {
      Tf32SS<N>::run(d, ad, bd + LO);
      Tf32SS<N>::run(d, ad, bd);
    } else {
      Tf32RS<N>::run(d, hi, bd + LO);
      Tf32RS<N>::run(d, hi, bd);
    }"""
_NW_VARIANTS = {
    "base": [],
    "no_wgmma": [("    Bf16SS<N>::run(d, ad, bd);",
                  "    d[0] += __uint_as_float((uint32_t)(ad ^ bd));"),
                 (_NW_F32_STEP, "    d[0] += __uint_as_float(hi[0] ^ hi[1] ^ "
                  "hi[2] ^ hi[3] ^ lo[0] ^ lo[1] ^ lo[2] ^ lo[3] ^ "
                  "(uint32_t)(ad ^ bd));")],
    "no_hp_store": [("""              store2<P::F32>(hp + ((size_t)plane * G::PS + pos) * 16 +
                                 (cm % P::E) * ELEM,
                             o0, o1);""", """              if (o0 == 123.f && o1 == 77.f) hp[plane] = 1;""")],
    "no_y_store": [("""              store2<P::F32>(yp + (8 * j + 2 * t) * ELEM, d[4 * j + 2 * i],
                             d[4 * j + 2 * i + 1]);""",
                    """              if (d[4 * j + 2 * i] == 123.f) yp[0] = 1;""")],
    "no_stage2": [("    chain<P::F32, N2, G::K2S, KC2, G::M2T, W2P>(",
                   "    if (n_items < 0) chain<P::F32, N2, G::K2S, KC2, "
                   "G::M2T, W2P>(")],
    "no_tma": [(_NW_TMA, """  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
      smem_u32(bar)) : "memory");
  (void)m; (void)maps; (void)dst;""")],
    "skeleton": None, "skeleton_no_tma": None,
}
_NW_F32_VARIANTS = {
    **_NW_VARIANTS,
    "a_desc": [("constexpr bool kHiByDesc = false;",
                "constexpr bool kHiByDesc = true;")],
    "one_pass": [(_NW_F32_STEP, "    Tf32RS<N>::run(d, hi, bd);")],
    "no_a_loads": [("""  float v[4];
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[0]) : "r"(r0));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[1]) : "r"(r0 + sbo));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[2]) : "r"(r0 + lbo));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[3]) : "r"(r0 + lbo + sbo));""",
                    """  float v[4];
  for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(0x3f800000u + (r0 >> e & 0xff));""")],
}
_NW_KNOBS = {
    "l2_none": [("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                 "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    "l2_256": [("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "three_wgs": [("  return P::F32 && CI >= 32 ? 1 : 2;\n}",
                   "  return P::F32 && CI >= 32 ? 1 : 3;\n}")],
}
_NW_VARIANTS.update(_NW_KNOBS)
_NW_F32_VARIANTS.update(_NW_KNOBS)
_NW_KC = "    return F32 ? (MAIN ? 4 : 1) : KS;"
_NW_F32_VARIANTS["kc2"] = [(_NW_KC, _NW_KC.replace("MAIN ? 4", "MAIN ? 2"))]
_NW_F32_VARIANTS["stats_kc2"] = [(_NW_KC, _NW_KC.replace(": 1)", ": 2)"))]
_NW_F32_VARIANTS["stats_one_block"] = [(
    "  static constexpr int MINB = bytes <= 113 * 1024 && 4 * CM <= 32 ? 2 : 1;",
    "  static constexpr int MINB = bytes <= 113 * 1024 && 4 * CM <= 32 && "
    "!P::F32 ? 2 : 1;")]
for _v, _extra in ((_NW_VARIANTS, ()), (_NW_F32_VARIANTS, ("no_a_loads",))):
    _v["skeleton"] = [sub for name in ("no_wgmma", "no_hp_store",
                                       "no_y_store") + _extra
                      for sub in _v[name]]
    _v["skeleton_no_tma"] = _v["skeleton"] + _v["no_tma"]


def _k3_wgmma_cases(args, torch, rng, dev, dtype=None):
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    dtype = dtype or torch.bfloat16
    x = t(rng.rand(args.batch, 16, args.hw, args.hw)).to(dtype)
    wT, wC = t(0.05 * rng.randn(16, 8, 4, 4)), t(0.05 * rng.randn(16, 8, 4, 4))
    xn = x.permute(0, 2, 3, 1).contiguous()
    w1, w2 = K3.operands(wT, wC, "wgmma", dtype)
    bn = torch.stack([torch.zeros(32), torch.ones(32),
                      torch.zeros(32)]).to(dev).contiguous()

    def launches(name):
        return (lambda: K3.launch_stats(xn, w1, 8, args.tm, "wgmma"),
                lambda: K3.launch_main(xn, w1, w2, bn, 8, 16, args.tm,
                                       "wgmma"))
    return {str(tuple(x.shape)): launches}


def _k3_wgmma_f32_cases(args, torch, rng, dev):
    return _k3_wgmma_cases(args, torch, rng, dev, torch.float32)


class Kernel(NamedTuple):
    source: str             # in csrc/
    module: object          # its wrapper: compile_and_load and the two below
    lib: str                # the module's attribute holding the library
    build: str              # the module's function that builds and loads it
    prefix: str             # mangled-name prefix of the ablated kernels
    variants: dict          # name -> [(old text, new text), ...]
    sass_ops: tuple         # SASS instructions counted in the base build
    cases: Callable         # (args, torch, rng, device) ->
    #                         {shape: launches(variant) -> (stats, main)}


KERNELS = {
    "bulge": Kernel("bulge.cu", K2, "_lib", "build", "_ZN3tcb", _K2_VARIANTS,
                    ("HMMA", "LDS.U16", "LDS ", "PRMT", "STS ", "LDGSTS",
                     "STG.E.U16", "F2FP", "BAR"), _k2_mma_cases),
    "bulge_wgmma": Kernel("bulge_wgmma.cu", K2, "_wlib", "build_wgmma",
                          "_ZN2wg", _WG_VARIANTS,
                          ("HGMMA", "LDSM", "STSM", "UTMALDG", "SYNCS",
                           "BAR", "STG.E.128", "F2FP"), _k2_wgmma_cases),
    "bulge_wgmma_f32": Kernel("bulge_wgmma.cu", K2, "_wlib", "build_wgmma",
                              "_ZN3wgf", _WF_VARIANTS,
                              ("HGMMA", "LDS.64", "LDS ", "STS.64",
                               "UTMALDG", "SYNCS", "BAR", "STG.E ", "LOP3",
                               "FADD"), _k2_wgmma_f32_cases),
    "nhwc": Kernel("fused_nhwc.cu", K3, "_lib", "build", "_ZN2tc",
                   _K3_VARIANTS, ("HMMA", "LDS.64", "LDS ", "STS.64", "LOP3",
                                  "FADD", "LDGSTS", "STG.E.64", "BAR"),
                   _k3_cases),
    "nhwc_wgmma": Kernel("fused_nhwc_wgmma.cu", K3, "_wlib", "build_wgmma",
                         "_ZN4nhwc", _NW_VARIANTS,
                         ("HGMMA", "UTMALDG", "SYNCS", "BAR", "STS ",
                          "STG.E ", "F2FP"), _k3_wgmma_cases),
    "nhwc_wgmma_f32": Kernel("fused_nhwc_wgmma.cu", K3, "_wlib",
                             "build_wgmma", "_ZN4nhwc", _NW_F32_VARIANTS,
                             ("HGMMA", "LDS ", "STS.64", "UTMALDG", "SYNCS",
                              "BAR", "STG.E.64", "LOP3", "FADD"),
                             _k3_wgmma_f32_cases),
}


def variant_source(kernel, name):
    """The kernel's source with variant `name`'s substitutions (every
    occurrence); raises if one no longer matches the source."""
    k = KERNELS[kernel]
    with open(os.path.join(B.CSRC, k.source)) as f:
        src = f.read()
    for old, new in k.variants[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: its text is no longer in "
                               f"csrc/{k.source}: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _bind(k, path):
    """The kernel's wrapper module bound to the library at `path`."""
    lib = ctypes.CDLL(path)
    setattr(k.module, k.lib, None)
    build = k.module.compile_and_load
    k.module.compile_and_load = lambda stem: (lib, "")
    try:
        return getattr(k.module, k.build)()
    finally:
        k.module.compile_and_load = build


def ptxas_lines(log, prefix):
    """The `-Xptxas -v` register, shared-memory and spill lines of the
    entry functions whose mangled names start with `prefix`, and its notes
    that wgmma was serialized in one of them."""
    out, func = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            func = ln.split("'")[1] if "'" in ln else ""
        elif "serialized" in ln and "'" in ln:
            name = ln.split("'")[-2]
            if name.startswith(prefix):
                out.append(f"wgmma serialized in {name}")
        elif func.startswith(prefix) and ("Used" in ln or "spill" in ln):
            out.append(ln.split("info    :")[-1].strip())
    return out


def _sass_counts(nvcc, so, prefix, ops):
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    out = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True).stdout
    counts, func = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            if not func.startswith(prefix):
                func = None
            else:
                counts[func] = dict.fromkeys(ops, 0)
        elif func:
            for op in ops:
                counts[func][op] += op in line
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--tm", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    k = KERNELS[args.kernel]

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("ablation times the kernel on a card; none is "
                           "visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    nvcc = B.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in k.variants:
            cu = os.path.join(tmp, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(variant_source(args.kernel, name))
            procs[name] = subprocess.Popen(
                [nvcc, *B.NVCC_FLAGS, "-o", os.path.join(tmp, f"{name}.so"),
                 cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        for name, p in procs.items():
            log = p.communicate()[0]
            if p.returncode:
                raise RuntimeError(f"variant {name} does not build:\n{log}")
            print(f"{name}: " + " | ".join(ptxas_lines(log, k.prefix)),
                  flush=True)
        print("base SASS: " + json.dumps(_sass_counts(
            nvcc, os.path.join(tmp, "base.so"), k.prefix, k.sass_ops)),
            flush=True)

        cases = k.cases(args, torch, np.random.RandomState(0),
                        torch.device("cuda"))

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
            for name in list(k.variants) + list(reversed(k.variants)):
                _bind(k, os.path.join(tmp, f"{name}.so"))
                for shape, launches in cases.items():
                    stats, main_ = launches(name)
                    times.setdefault(name, {}).setdefault(shape, []).append(
                        [time_ms(stats), time_ms(main_)])
        finally:
            setattr(k.module, k.lib, None)   # the next build loads the real one
    print(json.dumps({"card": smi, "kernel": args.kernel, "tm": args.tm,
                      "ms": times}))


if __name__ == "__main__":
    main()
