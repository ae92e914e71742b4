// Fused convT(k4s2p1) + BatchNorm + ReLU + conv(k4s2p1) for Hopper (sm_90a).
//
// Replaces the TPU kernel dcgan_sr_tpu/ops/pallas_bulge.py fused_bulge_fwd
// (_stats_kernel :159, _main_kernel :206): the generators' layers 3-4
// (models/specs.py), y = conv(relu(bn(convT(x)))), without writing the
// 2x-resolution hidden tensor h to device memory.
//
// Three kernels live here.
//
// (1) The tensor-core kernel (namespace tc; entries bulge_stats_f32,
//     bulge_main_f32).  Both stages are matrix products on
//     mma.sync.m16n8k8 TF32 with fp32 accumulators, at full fp32 accuracy by
//     error compensation ("3xTF32"): every fp32 operand a is split in
//     registers as hi = tf32(a), lo = a - hi (split_tf32), and every product
//     is three mma's, lo*hi + hi*lo + hi*hi.
//
//     Work item = (image, band of R = 8 y rows, chunk of TW = 32 y
//     columns), enumerated chunk-fastest; a persistent grid of (SMs x
//     blocks that fit) blocks walks items blockIdx.x, + gridDim.x, ...  The
//     packed weights are staged once per block, not once per tile.
//
//     Stage 1 (convT).  Local position (pi, pj), pi in [0, R], pj in
//     [0, TW], stands for x position (r0 - di + pi, c0 - dj + pj) of output
//     parity (di, dj); its 2x2 window is xs[ci][pi + ti][pj + tj] for all
//     four parities alike (xs = x rows r0-1 .. r0+R, columns c0-1 .. c0+TW,
//     zero outside the image).  So stage 1 is ONE product
//       A1 (297 positions x 4*Ci)  @  W1 (4*Ci x 4*Cm)
//     with k = (ti*2 + tj)*Ci + ci and n = (di*2 + dj)*Cm + cm,
//     W1[k][n] = wT[ci][cm][3 - di - 2 ti][3 - dj - 2 tj].  The result is
//     normalised, rectified, zeroed where the hidden cell lies outside the
//     image (the consumer's zero padding) and kept in shared memory as
//     parity planes hp[n][pi*33 + pj].
//     Stage 2 (conv).  y pixel (ml, nl) of the band reads, for tap (a, c),
//     plane (di, dj) = ((a+1)&1, (c+1)&1) at (ml + a/2, nl + c/2):
//       A2 (256 pixels x 16*Cm)  @  W2 (16*Cm x Co),  k = (a*4 + c)*Cm + cm.
//     The only halo is one x row above and below the band and one column
//     each side: 9*33 positions for 8*32 pixels, 1.16x the convT work.
//     Cm = 4 is padded to 8 with zero weights (the host packs W1 and W2,
//     already in mma B-fragment order: ops/bulge_mma.py).
//
//     A warp owns two m16 tiles and up to four n8 tiles at a time, so an A
//     fragment (4 shared loads, split once) feeds 12 mma's and a B fragment
//     (one 8-byte shared load, split once) 6: 3.5 instructions issued per
//     mma.  The 19 m tiles of stage 1 go as 8 pairs and 3 single tiles, so
//     the tail spreads over the warps.  Plane strides (408 floats for xs,
//     312 for hp) are 24 mod 32, so the four k-lanes of a fragment load hit
//     disjoint banks.
//
//     Copies in flight: x of the next item arrives by cp.async while stage
//     2 of the current item runs (stage 2 does not read xs), so one x
//     buffer is enough; rows go as 16-byte copies where W is a multiple of
//     4.  y leaves the registers as 32-byte runs (8 pixels of one channel a
//     quarter warp).
//
//     Shared memory at Ci 32 / Cm 16 / Co 32, bytes: W1 32,768 + W2 32,768
//     (fp32, split at fragment load: the split pair would be 131,072 and
//     not fit) + xs 32*408*4 = 52,224 + hp 64*312*4 = 79,872 + BN vectors
//     192 = 197,824 of 232,448: one block of 8 warps per SM.  At Ci 16 /
//     Cm 8 / Co 16: 8,192 + 8,192 + 26,112 + 39,936 + 96 = 82,528: two
//     blocks per SM.
//
//     Statistics: the stats kernel runs stage 1 alone and counts each hidden
//     cell once (even parities are owned by local positions [0, R) x
//     [0, TW), odd ones by [1, R] x [1, TW], clipped to the image); each
//     item writes fp32 (sum, sum of squares) to its own slot of `partial`,
//     no atomics; the wrapper reduces the slots in fp64 in a fixed order.
//
//     Bounds on an H100 (TF32 495 TFLOP/s, so 165 for 3xTF32; fp32 FMA 67;
//     HBM 3.35 TB/s): at x (14400,32,32,32) the pair is 483 GFLOP: 2.93 ms
//     at the 3xTF32 rate, 7.25 ms at the FMA rate, 1.13 ms for the bytes.
//
// (2) The earlier fp32 FMA kernel (namespace fp32fma; entries
//     bulge_stats_fma_f32, bulge_main_fma_f32): one block per (image, 16x16
//     tile), plain FMA from shared memory.  It is the yardstick the
//     tensor-core kernel is timed against and serves the channel triples the
//     tensor-core kernel has no instantiation for (Ci != 2 Cm).
//
// (3) The tensor-core kernel in bf16 (namespace tcb; entries
//     bulge_stats_bf16, bulge_main_bf16): the function of fused_bulge_fwd
//     with bf16 x (pallas_bulge.py:93-97, 216-230, 261-262).  x, the packed
//     weights, the hidden tensor fed to stage 2 and y are bf16; each product
//     is ONE mma.sync.m16n8k16 bf16 pass with fp32 accumulators (no split);
//     statistics, BN and ReLU run in fp32 on the accumulators, and h is
//     rounded to bf16 only after the edge mask.  Same items, schedule,
//     persistent grid and cp.async staging as (1).
//
//     A register of an m16n8k16 fragment holds two k-adjacent bf16 values.
//     k keeps (1)'s order, so in stage 1 the pair is channels c, c+1 of one
//     position: two 2-byte loads from the NCHW x planes (which cp.async fills
//     straight from device memory; the halo columns go as 4-byte copies of a
//     pair whose outer element nothing reads).  The stage-1 epilogue stores
//     the hidden planes channel-pair interleaved, a word per (cm, cm+1), so
//     stage 2's pair is one 4-byte load.  The host packs W1 and W2 in
//     m16n8k16 B-fragment order: a lane's two registers are one 8-byte load.
//     Plane strides: xs 488 bf16 (channel 2t at word 8t mod 32), hp 312
//     words, so a fragment load's four k-lanes hit disjoint banks.
//
//     Shared memory at Ci 32 / Cm 16 / Co 32, bytes: W1 16,384 + W2 16,384
//     + xs 32*488*2 = 31,232 + hp 4*8*312*4 = 39,936 + BN vectors 192 =
//     104,128: two blocks of 8 warps fit an SM (launch bound 2, at most 128
//     registers).  At Ci 16: 4,096 + 4,096 + 15,616 + 19,968 + 96 = 43,872.
//
//     Bounds on an H100 (bf16 dense 989 TFLOP/s; 3.35 TB/s): at x
//     (14400,32,32,32) bf16 the main launch moves 0.94 GB of x and 0.94 GB
//     of y, 0.56 ms, against 483 GFLOP, 0.49 ms: bound by bytes; the stats
//     launch reads x, 0.28 ms.
//
// Any H and W: ragged edges are masked (the TPU version asserted
// W % 128 == 0 and H % tm == 0).  Any batch: the persistent grid has no z
// limit; the FMA launcher splits at 65,535 images.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/bulge.py).
// Each entry returns the cudaError_t of its launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tc {

constexpr int R = 8;             // y rows of a work item
constexpr int TW = 32;           // y columns of a work item
constexpr int XR = R + 2;        // x rows staged: r0-1 .. r0+R
constexpr int XC = 40;           // xs row stride: column c0-1+q sits at q + XO
constexpr int XO = 3;            // so that column c0 is 16-byte aligned
constexpr int XPS = 408;         // xs plane stride (>= XR*XC, 24 mod 32)
constexpr int PR = R + 1;        // local position rows
constexpr int PC = TW + 1;       // local position columns
constexpr int NPOS = PR * PC;    // 297
constexpr int HPS = 312;         // hp plane stride (>= NPOS, 24 mod 32)
constexpr int NT = 256;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int M1T = (NPOS + 15) / 16;   // stage-1 m16 tiles: 19
constexpr int M1PAIRS = 8;       // of which 16 go in pairs, the rest singly
constexpr int NG = 4;            // n8 tiles a warp holds at a time, at most

static_assert(XR * XC <= XPS && XPS % 32 == 24 && XPS % 4 == 0 &&
              XC % 4 == 0 && (XO + 1) % 4 == 0 && XO + TW + 2 <= XC,
              "xs layout");
static_assert(NPOS <= HPS && HPS % 32 == 24, "hp plane stride");
static_assert(R == NWARP, "stage 2 gives each warp one y row of the band");
static_assert(TW == 32, "a y row of the band is two m16 tiles");
static_assert(2 * M1PAIRS * 16 <= NPOS, "paired tiles hold no phantom row");

// a = hi + lo exactly: hi keeps a's upper 19 bits (a TF32 value), lo is the
// fp32 remainder, of which the mma reads the upper 19 bits in turn.  One
// logic and one add operation: cvt.rna.tf32 on both halves rounds a little
// better (2^-22 against 2^-20 relative) and was measured 1.5x slower for the
// whole kernel, the conversion pipe being a quarter as wide.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The error-compensated product: small terms first.
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0,
                                       uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

struct Item {
  int b, r0, c0;
};

// Item idx -> (image, band, chunk), chunk fastest (ops/bulge_mma.py
// Schedule.item is the same map).
__device__ __forceinline__ Item decode(long long idx, int nbands, int nchunks) {
  Item it;
  const long long rest = idx / nchunks;
  it.c0 = (int)(idx - rest * nchunks) * TW;
  it.b = (int)(rest / nbands);
  it.r0 = (int)(rest - (long long)it.b * nbands) * R;
  return it;
}

// n floats (a multiple of 4), both 16-byte aligned.
__device__ __forceinline__ void stage_weights(float* dst, const float* src,
                                              int n, int tid) {
  for (int k = tid * 4; k < n; k += NT * 4) cp_async16(dst + k, src + k);
}

// xs[ci][r][XO + q] = x[ci][r0-1+r][c0-1+q], zero outside the image.  With
// `vec` (W a multiple of 4 and x 16-byte aligned) the 32 columns from c0 go
// as eight 16-byte copies a row and the two halo columns singly; else every
// element goes alone.
template <int CI>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ xb,
                                        int r0, int c0, int H, int W, bool vec,
                                        int tid) {
  if (vec) {
    constexpr int PER_ROW = TW / 4 + 2;
    for (int k = tid; k < CI * XR * PER_ROW; k += NT) {
      const int c = k / (XR * PER_ROW), rem = k - c * (XR * PER_ROW);
      const int r = rem / PER_ROW, v = rem - r * PER_ROW;
      const int gi = r0 - 1 + r;
      const bool row = gi >= 0 && gi < H;
      const float* src = xb + ((size_t)c * H + gi) * W;
      float* dst = xs + c * XPS + r * XC + XO;
      if (v < TW / 4) {
        const int gj = c0 + 4 * v;
        if (row && gj < W)
          cp_async16(dst + 1 + 4 * v, src + gj);
        else
          *reinterpret_cast<float4*>(dst + 1 + 4 * v) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int q = v == TW / 4 ? 0 : TW + 1;
        const int gj = c0 - 1 + q;
        if (row && gj >= 0 && gj < W)
          cp_async4(dst + q, src + gj);
        else
          dst[q] = 0.f;
      }
    }
  } else {
    constexpr int PER_ROW = TW + 2;
    for (int k = tid; k < CI * XR * PER_ROW; k += NT) {
      const int c = k / (XR * PER_ROW), rem = k - c * (XR * PER_ROW);
      const int r = rem / PER_ROW, q = rem - r * PER_ROW;
      const int gi = r0 - 1 + r, gj = c0 - 1 + q;
      float* dst = xs + c * XPS + r * XC + XO + q;
      if (gi >= 0 && gi < H && gj >= 0 && gj < W)
        cp_async4(dst, xb + ((size_t)c * H + gi) * W + gj);
      else
        *dst = 0.f;
    }
  }
  cp_async_commit();
}

// One unit of stage 1: acc (MT m16 tiles from tile m0 x NG n8 tiles of group
// nh) = A1 @ W1, handed to epi(m0, nh*NG*8, acc).  w1 is in B-fragment order:
// w1[((ks*N1T + nt)*32 + lane)*2 + j] = W1[ks*8 + (lane&3) + 4j][nt*8 + lane/4].
template <int CI, int CMP, int MT, class Epi>
__device__ __forceinline__ void stage1_unit(const float* xs, const float* w1,
                                            int m0, int nh, int lane,
                                            Epi& epi) {
  constexpr int CIS = CI / 8;          // k steps per tap
  constexpr int N1T = 4 * CMP / 8;     // n8 tiles: 4 or 8
  const int g = lane >> 2, t = lane & 3;
  int aoff[2 * MT];   // rows g, g+8 of each tile
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    int q = m0 * 16 + r * 8 + g;
    q = q < NPOS ? q : NPOS - 1;       // phantom rows read a valid cell
    aoff[r] = (q / PC) * XC + (q % PC) + XO + t * XPS;
  }
  float acc[MT][NG][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][ng][e] = 0.f;
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) {
#pragma unroll
    for (int cs = 0; cs < CIS; ++cs) {
      const int ks = tap * CIS + cs;
      const int koff = cs * 8 * XPS + (tap >> 1) * XC + (tap & 1);
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(xs[aoff[2 * mt] + koff], ah[mt][0], al[mt][0]);
        split_tf32(xs[aoff[2 * mt + 1] + koff], ah[mt][1], al[mt][1]);
        split_tf32(xs[aoff[2 * mt] + koff + 4 * XPS], ah[mt][2], al[mt][2]);
        split_tf32(xs[aoff[2 * mt + 1] + koff + 4 * XPS], ah[mt][3],
                   al[mt][3]);
      }
#pragma unroll
      for (int ng = 0; ng < NG; ++ng) {
        const float2 bv = *reinterpret_cast<const float2*>(
            w1 + ((ks * N1T + nh * NG + ng) * 32 + lane) * 2);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bv.x, bh0, bl0);
        split_tf32(bv.y, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3x(acc[mt][ng], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }
  }
  epi(m0, nh * NG * 8, acc);
}

// Stage 1 for one warp: its share of the units (m tiles x groups of NG n
// tiles).  Tiles 0 .. 2*M1PAIRS-1 go in pairs, so a B fragment feeds two
// tiles; the last M1T - 2*M1PAIRS go singly, which spreads the tail over the
// warps (with two groups: 16 pair units in two rounds, 6 single units in
// one) instead of leaving half of them a whole pair behind.
template <int CI, int CMP, class Epi>
__device__ __forceinline__ void stage1(const float* xs, const float* w1,
                                       int warp, int lane, Epi& epi) {
  constexpr int NH = 4 * CMP / 8 / NG;   // groups of n tiles: 1 or 2
  static_assert(NWARP % NH == 0, "a warp keeps its group of n tiles");
  for (int u = warp; u < M1PAIRS * NH; u += NWARP)
    stage1_unit<CI, CMP, 2>(xs, w1, 2 * (u / NH), u % NH, lane, epi);
  for (int u = warp; u < (M1T - 2 * M1PAIRS) * NH; u += NWARP)
    stage1_unit<CI, CMP, 1>(xs, w1, 2 * M1PAIRS + u / NH, u % NH, lane, epi);
}

// Main epilogue: normalise, rectify, zero the consumer's padding, store the
// parity planes.  Column n of a unit is parity n0/CMP + ng*8/CMP, channel
// (ng*8)%CMP + 2t + col: the parity is the same for all lanes.
template <int CMP>
struct MainEpi {
  float* hp;
  const float* bn;    // mu[CMP], gain[CMP], beta[CMP]
  int r0, c0, H, W, lane;
  template <int MT>
  __device__ __forceinline__ void operator()(int m0, int n0,
                                             const float (&acc)[MT][NG][4]) {
    const int g = lane >> 2, t = lane & 3;
    float mu[NG][2], gain[NG][2], beta[NG][2];
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const int cm = (ng * 8) % CMP + 2 * t + col;
        mu[ng][col] = bn[cm];
        gain[ng][col] = bn[CMP + cm];
        beta[ng][col] = bn[2 * CMP + cm];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = (m0 + mt) * 16 + half * 8 + g;
        if (q >= NPOS) continue;
        const int pi = q / PC, pj = q - pi * PC;
        // is the cell of parity (di, dj) at this position inside the image
        bool row_in[2], col_in[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          row_in[d] = (unsigned)(r0 - d + pi) < (unsigned)H;
          col_in[d] = (unsigned)(c0 - d + pj) < (unsigned)W;
        }
#pragma unroll
        for (int ng = 0; ng < NG; ++ng) {
          const int par = n0 / CMP + (ng * 8) / CMP;
          const bool in = row_in[par >> 1] && col_in[par & 1];
#pragma unroll
          for (int col = 0; col < 2; ++col) {
            const int n = n0 + ng * 8 + 2 * t + col;
            const float h = (acc[mt][ng][half * 2 + col] - mu[ng][col]) *
                                gain[ng][col] + beta[ng][col];
            hp[n * HPS + q] = in ? fmaxf(h, 0.f) : 0.f;
          }
        }
      }
  }
};

// Stats epilogue: per-thread fp32 sum and sum of squares of the hidden cells
// this item owns, per column of the thread's fragments.
template <int CMP>
struct StatsEpi {
  float s[NG][2][2];   // [n tile][column][sum, sum of squares]
  int r0, c0, H, W, lane;
  template <int MT>
  __device__ __forceinline__ void operator()(int m0, int n0,
                                             const float (&acc)[MT][NG][4]) {
    const int g = lane >> 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = (m0 + mt) * 16 + half * 8 + g;
        if (q >= NPOS) continue;
        const int pi = q / PC, pj = q - pi * PC;
        // does this item own the cell of parity (di, dj) at this position
        bool row_own[2], col_own[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          row_own[d] = pi - d >= 0 && pi - d < R && r0 + pi - d < H;
          col_own[d] = pj - d >= 0 && pj - d < TW && c0 + pj - d < W;
        }
#pragma unroll
        for (int ng = 0; ng < NG; ++ng) {
          const int par = n0 / CMP + (ng * 8) / CMP;
          const bool own = row_own[par >> 1] && col_own[par & 1];
#pragma unroll
          for (int col = 0; col < 2; ++col) {
            const float v = own ? acc[mt][ng][half * 2 + col] : 0.f;
            s[ng][col][0] += v;
            s[ng][col][1] = fmaf(v, v, s[ng][col][1]);
          }
        }
      }
  }
};

// Stage 2: warp `warp` computes y row r0 + warp of the band, all TW columns
// and all CO channels, from the parity planes.
template <int CMP, int CO>
__device__ __forceinline__ void stage2(const float* hp, const float* w2,
                                       int warp, int lane, float* __restrict__ yb,
                                       int r0, int c0, int H, int W) {
  constexpr int CMS = CMP / 8;         // k steps per tap
  constexpr int N2T = CO / 8;          // n8 tiles: 1, 2 or 4
  static_assert(N2T <= NG, "stage 2 holds all of Co at once");
  const int g = lane >> 2, t = lane & 3;
  const int ml = warp;
  int aoff[4];     // pixels g, g+8, g+16, g+24 of the row
#pragma unroll
  for (int r = 0; r < 4; ++r) aoff[r] = ml * PC + r * 8 + g + t * HPS;
  float acc[2][N2T][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < N2T; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int cs = 0; cs < CMS; ++cs) {
        const int ks = (a * 4 + c) * CMS + cs;
        const int par = ((a + 1) & 1) * 2 + ((c + 1) & 1);
        const int koff = (par * CMP + cs * 8) * HPS + (a >> 1) * PC + (c >> 1);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          split_tf32(hp[aoff[2 * mt] + koff], ah[mt][0], al[mt][0]);
          split_tf32(hp[aoff[2 * mt + 1] + koff], ah[mt][1], al[mt][1]);
          split_tf32(hp[aoff[2 * mt] + koff + 4 * HPS], ah[mt][2], al[mt][2]);
          split_tf32(hp[aoff[2 * mt + 1] + koff + 4 * HPS], ah[mt][3],
                     al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < N2T; ++nt) {
          const float2 bv = *reinterpret_cast<const float2*>(
              w2 + ((ks * N2T + nt) * 32 + lane) * 2);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(bv.x, bh0, bl0);
          split_tf32(bv.y, bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_3x(acc[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
    }
  }
  const int m = r0 + ml;
  if (m >= H) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = c0 + mt * 16 + half * 8 + g;
      if (n >= W) continue;
#pragma unroll
      for (int nt = 0; nt < N2T; ++nt)
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          const int co = nt * 8 + 2 * t + col;
          yb[((size_t)co * H + m) * W + n] = acc[mt][nt][half * 2 + col];
        }
    }
}

template <int CI, int CMP, int CO>
struct MainSmem {
  static constexpr int W1N = 4 * CI * 4 * CMP;
  static constexpr int W2N = 16 * CMP * CO;
  static constexpr int XN = CI * XPS;
  static constexpr int HN = 4 * CMP * HPS;
  static constexpr int BNN = 3 * CMP;
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(W1N + W2N + XN + HN + BNN);
};

template <int CI, int CMP, int CO>
__global__ void __launch_bounds__(NT, (CI <= 16 ? 2 : 1))
bulge_main_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ w2, const float* __restrict__ mu,
                  const float* __restrict__ gain,
                  const float* __restrict__ beta, float* __restrict__ y,
                  int cm_n, int H, int W, int nbands, int nchunks,
                  long long n_items, bool vec) {
  using S = MainSmem<CI, CMP, CO>;
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem;
  float* s_w2 = s_w1 + S::W1N;
  float* xs = s_w2 + S::W2N;
  float* hp = xs + S::XN;
  float* s_bn = hp + S::HN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t x_img = (size_t)CI * H * W, y_img = (size_t)CO * H * W;
  long long idx = blockIdx.x;
  if (idx >= n_items) return;
  stage_weights(s_w1, w1, S::W1N, tid);
  stage_weights(s_w2, w2, S::W2N, tid);
  {
    const Item it = decode(idx, nbands, nchunks);
    stage_x<CI>(xs, x + it.b * x_img, it.r0, it.c0, H, W, vec, tid);
  }
  for (; idx < n_items; idx += gridDim.x) {
    const Item it = decode(idx, nbands, nchunks);
    // stage 1 of the previous item is over (every warp passed the barrier
    // between the stages), so its BN vectors may go
    if (tid < CMP) {
      const bool real = tid < cm_n;
      s_bn[tid] = real ? mu[(size_t)it.b * cm_n + tid] : 0.f;
      s_bn[CMP + tid] = real ? gain[(size_t)it.b * cm_n + tid] : 0.f;
      s_bn[2 * CMP + tid] = real ? beta[tid] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();   // xs (and the weights) arrived; hp is free
    MainEpi<CMP> epi{hp, s_bn, it.r0, it.c0, H, W, lane};
    stage1<CI, CMP>(xs, s_w1, warp, lane, epi);
    __syncthreads();   // hp complete; xs is free
    const long long next = idx + gridDim.x;
    if (next < n_items) {
      const Item nx = decode(next, nbands, nchunks);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, vec, tid);
    }
    stage2<CMP, CO>(hp, s_w2, warp, lane, y + it.b * y_img, it.r0, it.c0, H, W);
  }
}

template <int CI, int CMP>
struct StatsSmem {
  static constexpr int W1N = 4 * CI * 4 * CMP;
  static constexpr int XN = CI * XPS;
  static constexpr int REDN = NWARP * NG * 8 * 2;
  static constexpr size_t bytes = sizeof(float) * (size_t)(W1N + XN + REDN);
};

// partial[idx][0][cm] = sum, partial[idx][1][cm] = sum of squares of the
// hidden cells item idx owns.
template <int CI, int CMP>
__global__ void __launch_bounds__(NT, (CI <= 16 ? 2 : 1))
bulge_stats_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   float* __restrict__ partial, int cm_n, int H, int W,
                   int nbands, int nchunks, long long n_items, bool vec) {
  using S = StatsSmem<CI, CMP>;
  constexpr int NH = 4 * CMP / 8 / NG;
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem;
  float* xs = s_w1 + S::W1N;
  float* red = xs + S::XN;     // [warp][local column 0..31][sum, squares]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t x_img = (size_t)CI * H * W;
  long long idx = blockIdx.x;
  if (idx >= n_items) return;
  stage_weights(s_w1, w1, S::W1N, tid);
  {
    const Item it = decode(idx, nbands, nchunks);
    stage_x<CI>(xs, x + it.b * x_img, it.r0, it.c0, H, W, vec, tid);
  }
  for (; idx < n_items; idx += gridDim.x) {
    const Item it = decode(idx, nbands, nchunks);
    cp_async_wait_all();
    __syncthreads();   // xs arrived; red of the previous item was read
    StatsEpi<CMP> epi;
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int col = 0; col < 2; ++col)
        epi.s[ng][col][0] = epi.s[ng][col][1] = 0.f;
    epi.r0 = it.r0; epi.c0 = it.c0; epi.H = H; epi.W = W; epi.lane = lane;
    stage1<CI, CMP>(xs, s_w1, warp, lane, epi);
    // over the 8 row lanes of a fragment column (lanes with equal t)
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int col = 0; col < 2; ++col)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = epi.s[ng][col][k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[(warp * 32 + ng * 8 + 2 * t + col) * 2 + k] = v;
        }
    __syncthreads();   // red complete; xs is free
    const long long next = idx + gridDim.x;
    if (next < n_items) {
      const Item nx = decode(next, nbands, nchunks);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, vec, tid);
    }
    if (tid < 2 * CMP) {
      // a warp's columns are n = (warp % NH)*32 + local; channel cm sums its
      // four parity columns over the warps, in a fixed order
      const int k = tid / CMP, cm = tid - k * CMP;
      float v = 0.f;
      for (int w = 0; w < NWARP; ++w)
#pragma unroll
        for (int par = 0; par < 4; ++par) {
          const int n = par * CMP + cm;
          if (n / 32 == w % NH) v += red[(w * 32 + n % 32) * 2 + k];
        }
      if (cm < cm_n) partial[((size_t)idx * 2 + k) * cm_n + cm] = v;
    }
  }
}

// May stage_x copy 16 bytes at a time: rows of x start 16-byte aligned.
inline bool vector_rows(const float* x, int W) {
  return W % 4 == 0 && ((uintptr_t)x & 15) == 0;
}

// Blocks of a persistent launch: what fits on the card, at most one per item.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int n_sm,
                            long long n_items, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || n_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * n_sm;
  *grid = (int)(n_items < fit ? n_items : fit);
  return cudaSuccess;
}

template <int CI, int CMP, int CO>
int launch_main(const float* x, const float* w1, const float* w2,
                const float* mu, const float* gain, const float* beta,
                float* y, int B, int cm, int H, int W, int n_sm,
                cudaStream_t stream) {
  const int nbands = (H + R - 1) / R, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  const size_t smem = MainSmem<CI, CMP, CO>::bytes;
  int grid = 0;
  cudaError_t e = persistent_grid(bulge_main_kernel<CI, CMP, CO>, smem, n_sm,
                                  n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  bulge_main_kernel<CI, CMP, CO><<<grid, NT, smem, stream>>>(
      x, w1, w2, mu, gain, beta, y, cm, H, W, nbands, nchunks, n_items,
      vector_rows(x, W));
  return (int)cudaGetLastError();
}

template <int CI, int CMP>
int launch_stats(const float* x, const float* w1, float* partial, int B,
                 int cm, int H, int W, int n_sm, cudaStream_t stream) {
  const int nbands = (H + R - 1) / R, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  const size_t smem = StatsSmem<CI, CMP>::bytes;
  int grid = 0;
  cudaError_t e = persistent_grid(bulge_stats_kernel<CI, CMP>, smem, n_sm,
                                  n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  bulge_stats_kernel<CI, CMP><<<grid, NT, smem, stream>>>(
      x, w1, partial, cm, H, W, nbands, nchunks, n_items, vector_rows(x, W));
  return (int)cudaGetLastError();
}

}  // namespace tc

// The bf16 instantiation of the tensor-core kernel; see (3) in the header.
namespace tcb {

using tc::HPS;
using tc::Item;
using tc::M1PAIRS;
using tc::M1T;
using tc::NG;
using tc::NPOS;
using tc::NT;
using tc::NWARP;
using tc::PC;
using tc::R;
using tc::TW;
using tc::XR;

constexpr int XC = 48;     // xs row stride in bf16: column c0-1+q sits at q + XO
constexpr int XO = 7;      // column c0 16-byte aligned, halo pairs 4-byte aligned
constexpr int XPS = 488;   // xs plane stride (>= XR*XC; channel 2t at word t*XPS)

static_assert(XR * XC <= XPS && XPS % 8 == 0 && XPS % 32 == 8 &&
              XC % 8 == 0 && (XO + 1) % 8 == 0 && XO % 2 == 1 &&
              XO + TW + 3 <= XC, "bf16 xs layout");

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.  Each
// 32-bit register holds two k-adjacent values, the lower k in the lower half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (to nearest even), `lo` in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Channels c and c+1 of one staged position: the register of an A pair.
__device__ __forceinline__ uint32_t x_pair(const uint16_t* xs, int off) {
  return (uint32_t)xs[off] | ((uint32_t)xs[off + XPS] << 16);
}

// xs[ci][r][XO + q] = x[ci][r0-1+r][c0-1+q], zero outside the image.  With
// `vec` (W a multiple of 8 and x 16-byte aligned) the 32 columns from c0 go
// as four 16-byte copies a row, and each halo column as a 4-byte copy of it
// and its outer neighbour, which nothing reads; else every element is loaded
// and stored alone.
template <int CI>
__device__ __forceinline__ void stage_x(uint16_t* xs,
                                        const uint16_t* __restrict__ xb, int r0,
                                        int c0, int H, int W, bool vec,
                                        int tid) {
  if (vec) {
    constexpr int PER_ROW = TW / 8 + 2;
    for (int k = tid; k < CI * XR * PER_ROW; k += NT) {
      const int c = k / (XR * PER_ROW), rem = k - c * (XR * PER_ROW);
      const int r = rem / PER_ROW, v = rem - r * PER_ROW;
      const int gi = r0 - 1 + r;
      const bool row = gi >= 0 && gi < H;
      const uint16_t* src = xb + ((size_t)c * H + gi) * W;
      uint16_t* dst = xs + c * XPS + r * XC + XO;
      if (v < TW / 8) {
        const int gj = c0 + 8 * v;
        if (row && gj < W)
          tc::cp_async16(reinterpret_cast<float*>(dst + 1 + 8 * v),
                         reinterpret_cast<const float*>(src + gj));
        else
          *reinterpret_cast<uint4*>(dst + 1 + 8 * v) = make_uint4(0, 0, 0, 0);
      } else if (v == TW / 8) {          // columns c0-2 (unread) and c0-1
        if (row && c0 > 0)
          tc::cp_async4(reinterpret_cast<float*>(dst - 1),
                        reinterpret_cast<const float*>(src + c0 - 2));
        else
          *reinterpret_cast<uint32_t*>(dst - 1) = 0u;
      } else {                           // columns c0+32 and c0+33 (unread)
        if (row && c0 + TW < W)
          tc::cp_async4(reinterpret_cast<float*>(dst + TW + 1),
                        reinterpret_cast<const float*>(src + c0 + TW));
        else
          *reinterpret_cast<uint32_t*>(dst + TW + 1) = 0u;
      }
    }
  } else {
    constexpr int PER_ROW = TW + 2;
    for (int k = tid; k < CI * XR * PER_ROW; k += NT) {
      const int c = k / (XR * PER_ROW), rem = k - c * (XR * PER_ROW);
      const int r = rem / PER_ROW, q = rem - r * PER_ROW;
      const int gi = r0 - 1 + r, gj = c0 - 1 + q;
      xs[c * XPS + r * XC + XO + q] =
          (gi >= 0 && gi < H && gj >= 0 && gj < W)
              ? xb[((size_t)c * H + gi) * W + gj] : (uint16_t)0;
    }
  }
  tc::cp_async_commit();
}

// One unit of stage 1 in bf16: acc (MT m16 tiles from tile m0 x NG n8 tiles
// of group nh) = A1 @ W1, handed to epi(m0, nh*NG*8, acc).  Register hh of
// a row holds k = ks*16 + 8hh + 2t and the next: channels cb + 2t and
// cb + 2t + 1 of tap (ks*16 + 8hh) / CI, cb = (ks*16 + 8hh) % CI.  w1 is in
// m16n8k16 B-fragment order: a lane's four values of an n8 tile at
// ((ks*N1T + nt)*32 + lane)*4 (ops/bulge_mma.py to_fragments_bf16).
template <int CI, int CMP, int MT, class Epi>
__device__ __forceinline__ void stage1_unit(const uint16_t* xs,
                                            const uint16_t* w1, int m0, int nh,
                                            int lane, Epi& epi) {
  constexpr int KS = 4 * CI / 16;      // k16 steps
  constexpr int N1T = 4 * CMP / 8;     // n8 tiles: 4 or 8
  const int g = lane >> 2, t = lane & 3;
  int aoff[2 * MT];   // rows g, g+8 of each tile, at channel 2t
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    int q = m0 * 16 + r * 8 + g;
    q = q < NPOS ? q : NPOS - 1;       // phantom rows read a valid cell
    aoff[r] = (q / PC) * XC + (q % PC) + XO + 2 * t * XPS;
  }
  float acc[MT][NG][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][ng][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kb = ks * 16 + 8 * hh, tap = kb / CI, cb = kb % CI;
      const int koff = cb * XPS + (tap >> 1) * XC + (tap & 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][2 * hh] = x_pair(xs, aoff[2 * mt] + koff);
        a[mt][2 * hh + 1] = x_pair(xs, aoff[2 * mt + 1] + koff);
      }
    }
#pragma unroll
    for (int ng = 0; ng < NG; ++ng) {
      const uint2 bv = *reinterpret_cast<const uint2*>(
          w1 + ((ks * N1T + nh * NG + ng) * 32 + lane) * 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][ng], a[mt], bv.x, bv.y);
    }
  }
  epi(m0, nh * NG * 8, acc);
}

// Stage 1 for one warp, the units shared out as in tc::stage1.
template <int CI, int CMP, class Epi>
__device__ __forceinline__ void stage1(const uint16_t* xs, const uint16_t* w1,
                                       int warp, int lane, Epi& epi) {
  constexpr int NH = 4 * CMP / 8 / NG;
  static_assert(NWARP % NH == 0, "a warp keeps its group of n tiles");
  for (int u = warp; u < M1PAIRS * NH; u += NWARP)
    stage1_unit<CI, CMP, 2>(xs, w1, 2 * (u / NH), u % NH, lane, epi);
  for (int u = warp; u < (M1T - 2 * M1PAIRS) * NH; u += NWARP)
    stage1_unit<CI, CMP, 1>(xs, w1, 2 * M1PAIRS + u / NH, u % NH, lane, epi);
}

// Main epilogue: normalise, rectify and zero the consumer's padding in fp32,
// then round to bf16 and store channel pair (n, n+1) of a position as one
// word: plane n/2 of hp.  A lane's two columns are that pair.
template <int CMP>
struct MainEpi {
  uint32_t* hp;
  const float* bn;    // mu[CMP], gain[CMP], beta[CMP]
  int r0, c0, H, W, lane;
  template <int MT>
  __device__ __forceinline__ void operator()(int m0, int n0,
                                             const float (&acc)[MT][NG][4]) {
    const int g = lane >> 2, t = lane & 3;
    float mu[NG][2], gain[NG][2], beta[NG][2];
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const int cm = (ng * 8) % CMP + 2 * t + col;
        mu[ng][col] = bn[cm];
        gain[ng][col] = bn[CMP + cm];
        beta[ng][col] = bn[2 * CMP + cm];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = (m0 + mt) * 16 + half * 8 + g;
        if (q >= NPOS) continue;
        const int pi = q / PC, pj = q - pi * PC;
        bool row_in[2], col_in[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          row_in[d] = (unsigned)(r0 - d + pi) < (unsigned)H;
          col_in[d] = (unsigned)(c0 - d + pj) < (unsigned)W;
        }
#pragma unroll
        for (int ng = 0; ng < NG; ++ng) {
          const int par = n0 / CMP + (ng * 8) / CMP;
          const bool in = row_in[par >> 1] && col_in[par & 1];
          float v[2];
#pragma unroll
          for (int col = 0; col < 2; ++col) {
            const float h = (acc[mt][ng][half * 2 + col] - mu[ng][col]) *
                                gain[ng][col] + beta[ng][col];
            v[col] = in ? fmaxf(h, 0.f) : 0.f;
          }
          hp[((n0 + ng * 8) / 2 + t) * HPS + q] = pack_bf16(v[0], v[1]);
        }
      }
  }
};

// Stage 2 in bf16: warp `warp` computes y row r0 + warp of the band.  Register
// hh of a pixel holds k = ks*16 + 8hh + 2t and the next: channels cm0 + 2t,
// +1 of tap (a, c) = ((ks*16 + 8hh) / CMP) as a*4 + c, one word of hp.
template <int CMP, int CO>
__device__ __forceinline__ void stage2(const uint32_t* hp, const uint16_t* w2,
                                       int warp, int lane,
                                       uint16_t* __restrict__ yb, int r0,
                                       int c0, int H, int W) {
  constexpr int KS = CMP;              // 16 * CMP / 16 k16 steps
  constexpr int N2T = CO / 8;
  static_assert(N2T <= NG, "stage 2 holds all of Co at once");
  const int g = lane >> 2, t = lane & 3;
  const int ml = warp;
  int aoff[4];     // pixels g, g+8, g+16, g+24 of the row, at channel pair t
#pragma unroll
  for (int r = 0; r < 4; ++r) aoff[r] = ml * PC + r * 8 + g + t * HPS;
  float acc[2][N2T][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < N2T; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kb = ks * 16 + 8 * hh, tap = kb / CMP, cm0 = kb % CMP;
      const int ta = tap >> 2, tcol = tap & 3;
      const int par = ((ta + 1) & 1) * 2 + ((tcol + 1) & 1);
      const int koff = (par * CMP / 2 + cm0 / 2) * HPS + (ta >> 1) * PC +
                       (tcol >> 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][2 * hh] = hp[aoff[2 * mt] + koff];
        a[mt][2 * hh + 1] = hp[aoff[2 * mt + 1] + koff];
      }
    }
#pragma unroll
    for (int nt = 0; nt < N2T; ++nt) {
      const uint2 bv = *reinterpret_cast<const uint2*>(
          w2 + ((ks * N2T + nt) * 32 + lane) * 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], bv.x, bv.y);
    }
  }
  const int m = r0 + ml;
  if (m >= H) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = c0 + mt * 16 + half * 8 + g;
      if (n >= W) continue;
#pragma unroll
      for (int nt = 0; nt < N2T; ++nt)
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          const int co = nt * 8 + 2 * t + col;
          yb[((size_t)co * H + m) * W + n] = __bfloat16_as_ushort(
              __float2bfloat16_rn(acc[mt][nt][half * 2 + col]));
        }
    }
}

template <int CI, int CMP, int CO>
struct MainSmem {
  static constexpr int W1N = 4 * CI * 4 * CMP;   // bf16
  static constexpr int W2N = 16 * CMP * CO;      // bf16
  static constexpr int XN = CI * XPS;            // bf16
  static constexpr int HN = 2 * CMP * HPS;       // words: 4 parities x CMP/2 pairs
  static constexpr int BNN = 3 * CMP;            // fp32
  static constexpr size_t bytes = 2 * (size_t)(W1N + W2N + XN) +
                                  4 * (size_t)(HN + BNN);
  static_assert((2 * (W1N + W2N + XN)) % 16 == 0, "hp 16-byte aligned");
};

template <int CI, int CMP, int CO>
__global__ void __launch_bounds__(NT, 2)
bulge_main_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w1,
                  const uint16_t* __restrict__ w2, const float* __restrict__ mu,
                  const float* __restrict__ gain,
                  const float* __restrict__ beta, uint16_t* __restrict__ y,
                  int cm_n, int H, int W, int nbands, int nchunks,
                  long long n_items, bool vec) {
  using S = MainSmem<CI, CMP, CO>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* s_w1 = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* s_w2 = s_w1 + S::W1N;
  uint16_t* xs = s_w2 + S::W2N;
  uint32_t* hp = reinterpret_cast<uint32_t*>(xs + S::XN);
  float* s_bn = reinterpret_cast<float*>(hp + S::HN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t x_img = (size_t)CI * H * W, y_img = (size_t)CO * H * W;
  long long idx = blockIdx.x;
  if (idx >= n_items) return;
  tc::stage_weights(reinterpret_cast<float*>(s_w1),
                    reinterpret_cast<const float*>(w1), S::W1N / 2, tid);
  tc::stage_weights(reinterpret_cast<float*>(s_w2),
                    reinterpret_cast<const float*>(w2), S::W2N / 2, tid);
  {
    const Item it = tc::decode(idx, nbands, nchunks);
    stage_x<CI>(xs, x + it.b * x_img, it.r0, it.c0, H, W, vec, tid);
  }
  for (; idx < n_items; idx += gridDim.x) {
    const Item it = tc::decode(idx, nbands, nchunks);
    if (tid < CMP) {
      const bool real = tid < cm_n;
      s_bn[tid] = real ? mu[(size_t)it.b * cm_n + tid] : 0.f;
      s_bn[CMP + tid] = real ? gain[(size_t)it.b * cm_n + tid] : 0.f;
      s_bn[2 * CMP + tid] = real ? beta[tid] : 0.f;
    }
    tc::cp_async_wait_all();
    __syncthreads();   // xs (and the weights) arrived; hp is free
    MainEpi<CMP> epi{hp, s_bn, it.r0, it.c0, H, W, lane};
    stage1<CI, CMP>(xs, s_w1, warp, lane, epi);
    __syncthreads();   // hp complete; xs is free
    const long long next = idx + gridDim.x;
    if (next < n_items) {
      const Item nx = tc::decode(next, nbands, nchunks);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, vec, tid);
    }
    stage2<CMP, CO>(hp, s_w2, warp, lane, y + it.b * y_img, it.r0, it.c0, H,
                    W);
  }
}

template <int CI, int CMP>
struct StatsSmem {
  static constexpr int W1N = 4 * CI * 4 * CMP;   // bf16
  static constexpr int XN = CI * XPS;            // bf16
  static constexpr int REDN = NWARP * NG * 8 * 2;
  static constexpr size_t bytes =
      2 * (size_t)(W1N + XN) + sizeof(float) * (size_t)REDN;
};

// partial[idx][0][cm] = sum, partial[idx][1][cm] = sum of squares of the
// hidden cells item idx owns, in fp32 from the fp32 accumulators.
template <int CI, int CMP>
__global__ void __launch_bounds__(NT, 2)
bulge_stats_kernel(const uint16_t* __restrict__ x,
                   const uint16_t* __restrict__ w1, float* __restrict__ partial,
                   int cm_n, int H, int W, int nbands, int nchunks,
                   long long n_items, bool vec) {
  using S = StatsSmem<CI, CMP>;
  constexpr int NH = 4 * CMP / 8 / NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* s_w1 = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* xs = s_w1 + S::W1N;
  float* red = reinterpret_cast<float*>(xs + S::XN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t x_img = (size_t)CI * H * W;
  long long idx = blockIdx.x;
  if (idx >= n_items) return;
  tc::stage_weights(reinterpret_cast<float*>(s_w1),
                    reinterpret_cast<const float*>(w1), S::W1N / 2, tid);
  {
    const Item it = tc::decode(idx, nbands, nchunks);
    stage_x<CI>(xs, x + it.b * x_img, it.r0, it.c0, H, W, vec, tid);
  }
  for (; idx < n_items; idx += gridDim.x) {
    const Item it = tc::decode(idx, nbands, nchunks);
    tc::cp_async_wait_all();
    __syncthreads();   // xs arrived; red of the previous item was read
    tc::StatsEpi<CMP> epi;
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int col = 0; col < 2; ++col)
        epi.s[ng][col][0] = epi.s[ng][col][1] = 0.f;
    epi.r0 = it.r0; epi.c0 = it.c0; epi.H = H; epi.W = W; epi.lane = lane;
    stage1<CI, CMP>(xs, s_w1, warp, lane, epi);
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int col = 0; col < 2; ++col)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = epi.s[ng][col][k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[(warp * 32 + ng * 8 + 2 * t + col) * 2 + k] = v;
        }
    __syncthreads();   // red complete; xs is free
    const long long next = idx + gridDim.x;
    if (next < n_items) {
      const Item nx = tc::decode(next, nbands, nchunks);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, vec, tid);
    }
    if (tid < 2 * CMP) {
      const int k = tid / CMP, cm = tid - k * CMP;
      float v = 0.f;
      for (int w = 0; w < NWARP; ++w)
#pragma unroll
        for (int par = 0; par < 4; ++par) {
          const int n = par * CMP + cm;
          if (n / 32 == w % NH) v += red[(w * 32 + n % 32) * 2 + k];
        }
      if (cm < cm_n) partial[((size_t)idx * 2 + k) * cm_n + cm] = v;
    }
  }
}

// May stage_x copy 16 bytes at a time: rows of x start 16-byte aligned.
inline bool vector_rows(const void* x, int W) {
  return W % 8 == 0 && ((uintptr_t)x & 15) == 0;
}

template <int CI, int CMP, int CO>
int launch_main(const uint16_t* x, const uint16_t* w1, const uint16_t* w2,
                const float* mu, const float* gain, const float* beta,
                uint16_t* y, int B, int cm, int H, int W, int n_sm,
                cudaStream_t stream) {
  const int nbands = (H + R - 1) / R, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  const size_t smem = MainSmem<CI, CMP, CO>::bytes;
  int grid = 0;
  cudaError_t e = tc::persistent_grid(bulge_main_kernel<CI, CMP, CO>, smem,
                                      n_sm, n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  bulge_main_kernel<CI, CMP, CO><<<grid, NT, smem, stream>>>(
      x, w1, w2, mu, gain, beta, y, cm, H, W, nbands, nchunks, n_items,
      vector_rows(x, W));
  return (int)cudaGetLastError();
}

template <int CI, int CMP>
int launch_stats(const uint16_t* x, const uint16_t* w1, float* partial, int B,
                 int cm, int H, int W, int n_sm, cudaStream_t stream) {
  const int nbands = (H + R - 1) / R, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  const size_t smem = StatsSmem<CI, CMP>::bytes;
  int grid = 0;
  cudaError_t e = tc::persistent_grid(bulge_stats_kernel<CI, CMP>, smem, n_sm,
                                      n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  bulge_stats_kernel<CI, CMP><<<grid, NT, smem, stream>>>(
      x, w1, partial, cm, H, W, nbands, nchunks, n_items, vector_rows(x, W));
  return (int)cudaGetLastError();
}

}  // namespace tcb

// The fp32 FMA kernel: one block per (image, T x T tile); see (2) in the
// header.
namespace fp32fma {


constexpr int T = 16;          // tile side in x / y pixels
constexpr int NT = T * T;      // threads per block, one per tile pixel
constexpr int NWARP = NT / 32;
constexpr int XS = T + 2;      // stats: x tile + 1-pixel halo
constexpr int XM = T + 4;      // main: x tile + 2-pixel halo
constexpr int HP = T + 2;      // main: x positions whose parities cover the hidden tile
constexpr int HS = 2 * T + 2;  // main: hidden tile side
constexpr int MAXB = 65535;    // images per launch: the grid's z limit

// acc[p][cm] += the 2x2 sub-conv of parity p = di*2+dj at one x position.
// v[r][q] = x[i-1+r][j-1+q]; w = wT for one ci, laid out [cm][kh][kw].
template <int CM>
__device__ __forceinline__ void convT_point(const float (&v)[3][3],
                                            const float* __restrict__ w,
                                            float (&acc)[4][CM]) {
#pragma unroll
  for (int cm = 0; cm < CM; ++cm) {
    const float* wc = w + cm * 16;
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        float a = acc[di * 2 + dj][cm];
#pragma unroll
        for (int ti = 0; ti < 2; ++ti)
#pragma unroll
          for (int tj = 0; tj < 2; ++tj)
            a = fmaf(v[di + ti][dj + tj],
                     wc[(3 - di - 2 * ti) * 4 + (3 - dj - 2 * tj)], a);
        acc[di * 2 + dj][cm] = a;
      }
  }
}

template <int CM>
__global__ void __launch_bounds__(NT)
bulge_stats_kernel(const float* __restrict__ x, const float* __restrict__ wT,
                   float* __restrict__ partial, int ci_n, int H, int W) {
  extern __shared__ float smem[];
  float* ws = smem;                    // ci_n * CM * 16
  float* xs = ws + ci_n * CM * 16;     // ci_n * XS * XS
  __shared__ float red[NWARP][2 * CM];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * T, j0 = blockIdx.x * T;
  const float* xb = x + (size_t)b * ci_n * H * W;

  for (int k = tid; k < ci_n * CM * 16; k += NT) ws[k] = wT[k];
  for (int k = tid; k < ci_n * XS * XS; k += NT) {
    const int c = k / (XS * XS), r = (k / XS) % XS, q = k % XS;
    const int gi = i0 - 1 + r, gj = j0 - 1 + q;
    xs[k] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                ? xb[((size_t)c * H + gi) * W + gj] : 0.f;
  }
  __syncthreads();

  const int li = tid / T, lj = tid % T;
  float acc[4][CM];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int cm = 0; cm < CM; ++cm) acc[p][cm] = 0.f;
  for (int ci = 0; ci < ci_n; ++ci) {
    const float* xc = xs + ci * XS * XS + li * XS + lj;
    float v[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) v[r][q] = xc[r * XS + q];
    convT_point<CM>(v, ws + ci * CM * 16, acc);
  }

  // this thread's four hidden pixels, if its x pixel lies in the image
  const bool valid = (i0 + li < H) && (j0 + lj < W);
  float s[2 * CM];
#pragma unroll
  for (int cm = 0; cm < CM; ++cm) {
    float a = 0.f, q = 0.f;
    if (valid) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        a += acc[p][cm];
        q = fmaf(acc[p][cm], acc[p][cm], q);
      }
    }
    s[cm] = a;
    s[CM + cm] = q;
  }
#pragma unroll
  for (int k = 0; k < 2 * CM; ++k) {
    float v = s[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) red[tid >> 5][k] = v;
  }
  __syncthreads();
  if (tid < 2 * CM) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) v += red[w][tid];
    const size_t tile = ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x
                        + blockIdx.x;
    partial[tile * 2 * CM + tid] = v;   // [sum(CM), sumsq(CM)]
  }
}

template <int CM, int CO>
__global__ void __launch_bounds__(NT)
bulge_main_kernel(const float* __restrict__ x, const float* __restrict__ wT,
                  const float* __restrict__ wC, const float* __restrict__ mu,
                  const float* __restrict__ gain,
                  const float* __restrict__ beta, float* __restrict__ y,
                  int ci_n, int H, int W) {
  extern __shared__ float smem[];
  float* ws = smem;                    // ci_n * CM * 16  (wT, IOHW)
  float* wcs = ws + ci_n * CM * 16;    // CO * CM * 16    (wC, OIHW)
  float* xs = wcs + CO * CM * 16;      // ci_n * XM * XM
  float* hs = xs + ci_n * XM * XM;     // CM * HS * HS
  __shared__ float s_mu[CM], s_gain[CM], s_beta[CM];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * T, n0 = blockIdx.x * T;
  const float* xb = x + (size_t)b * ci_n * H * W;

  for (int k = tid; k < ci_n * CM * 16; k += NT) ws[k] = wT[k];
  for (int k = tid; k < CO * CM * 16; k += NT) wcs[k] = wC[k];
  if (tid < CM) {
    s_mu[tid] = mu[b * CM + tid];
    s_gain[tid] = gain[b * CM + tid];
    s_beta[tid] = beta[tid];
  }
  // x rows m0-2 .. m0+T+1 and the same columns around n0
  for (int k = tid; k < ci_n * XM * XM; k += NT) {
    const int c = k / (XM * XM), r = (k / XM) % XM, q = k % XM;
    const int gi = m0 - 2 + r, gj = n0 - 2 + q;
    xs[k] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                ? xb[((size_t)c * H + gi) * W + gj] : 0.f;
  }
  __syncthreads();

  // Hidden tile: local row r' = global row - (2*m0 - 1), r' in [0, HS).
  // x position (p, q) is global (m0-1+p, n0-1+q); its parity (di, dj) lands
  // at local (2p+di-1, 2q+dj-1).
  for (int k = tid; k < HP * HP; k += NT) {
    const int p = k / HP, q = k % HP;
    float acc[4][CM];
#pragma unroll
    for (int pp = 0; pp < 4; ++pp)
#pragma unroll
      for (int cm = 0; cm < CM; ++cm) acc[pp][cm] = 0.f;
    for (int ci = 0; ci < ci_n; ++ci) {
      // v[r][s] = x[i-1+r][j-1+s] = xs[p+r][q+s] (xs row 0 is global m0-2)
      const float* xc = xs + ci * XM * XM + p * XM + q;
      float v[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int s = 0; s < 3; ++s) v[r][s] = xc[r * XM + s];
      convT_point<CM>(v, ws + ci * CM * 16, acc);
    }
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const int lr = 2 * p + di - 1, lc = 2 * q + dj - 1;
        if (lr < 0 || lr >= HS || lc < 0 || lc >= HS) continue;
        const int gr = 2 * (m0 - 1 + p) + di, gc = 2 * (n0 - 1 + q) + dj;
        const bool pad = gr < 0 || gr >= 2 * H || gc < 0 || gc >= 2 * W;
#pragma unroll
        for (int cm = 0; cm < CM; ++cm) {
          const float h = (acc[di * 2 + dj][cm] - s_mu[cm]) * s_gain[cm]
                          + s_beta[cm];
          hs[(cm * HS + lr) * HS + lc] = pad ? 0.f : fmaxf(h, 0.f);
        }
      }
  }
  __syncthreads();

  // consumer: y[m, n] = sum_{cm,a,c} hr[2m+a-1, 2n+c-1] * wC[co, cm, a, c];
  // in local hidden coordinates that is hs[2*ml + a][2*nl + c]
  const int ml = tid / T, nl = tid % T;
  float out[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) out[co] = 0.f;
  for (int cm = 0; cm < CM; ++cm) {
    const float* hc = hs + (cm * HS + 2 * ml) * HS + 2 * nl;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float hv = hc[a * HS + c];
#pragma unroll
        for (int co = 0; co < CO; ++co)
          out[co] = fmaf(hv, wcs[(co * CM + cm) * 16 + a * 4 + c], out[co]);
      }
  }
  const int m = m0 + ml, n = n0 + nl;
  if (m < H && n < W) {
    float* yb = y + (size_t)b * CO * H * W + (size_t)m * W + n;
#pragma unroll
    for (int co = 0; co < CO; ++co) yb[(size_t)co * H * W] = out[co];
  }
}

size_t stats_smem(int ci, int cm) {
  return sizeof(float) * ((size_t)ci * cm * 16 + (size_t)ci * XS * XS);
}

size_t main_smem(int ci, int cm, int co) {
  return sizeof(float) * ((size_t)ci * cm * 16 + (size_t)co * cm * 16 +
                          (size_t)ci * XM * XM + (size_t)cm * HS * HS);
}

template <int CM>
int launch_stats(const float* x, const float* wT, float* partial, int B,
                 int ci, int H, int W, cudaStream_t stream) {
  const size_t smem = stats_smem(ci, CM);
  cudaError_t e = cudaFuncSetAttribute(
      bulge_stats_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // The tile batches of the overlap pipeline hold more images than the
  // grid's z dimension takes: they go MAXB images to a launch.
  const int ntx = (W + T - 1) / T, nty = (H + T - 1) / T;
  for (int b0 = 0; b0 < B; b0 += MAXB) {
    const dim3 grid(ntx, nty, B - b0 < MAXB ? B - b0 : MAXB);
    bulge_stats_kernel<CM><<<grid, NT, smem, stream>>>(
        x + (size_t)b0 * ci * H * W, wT,
        partial + (size_t)b0 * nty * ntx * 2 * CM, ci, H, W);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

template <int CM, int CO>
int launch_main(const float* x, const float* wT, const float* wC,
                const float* mu, const float* gain, const float* beta,
                float* y, int B, int ci, int H, int W, cudaStream_t stream) {
  const size_t smem = main_smem(ci, CM, CO);
  cudaError_t e = cudaFuncSetAttribute(
      bulge_main_kernel<CM, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (int b0 = 0; b0 < B; b0 += MAXB) {   // see launch_stats
    const dim3 grid((W + T - 1) / T, (H + T - 1) / T,
                    B - b0 < MAXB ? B - b0 : MAXB);
    bulge_main_kernel<CM, CO><<<grid, NT, smem, stream>>>(
        x + (size_t)b0 * ci * H * W, wT, wC, mu + (size_t)b0 * CM,
        gain + (size_t)b0 * CM, beta, y + (size_t)b0 * CO * H * W, ci, H, W);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace fp32fma

extern "C" {

// ---- the tensor-core kernel -------------------------------------------------

// Work-item geometry: y rows of a band, y columns of a chunk.  `partial`
// holds B * ceil(H/rows) * ceil(W/cols) * 2 * cm floats.
int bulge_band_rows() { return tc::R; }
int bulge_chunk_cols() { return tc::TW; }

// Channel triples with a compiled tensor-core instantiation: Ci = 2 Cm,
// Co = 2 Cm, Cm in {4, 8, 16} (Cm 4 runs padded to 8).
int bulge_mma_supported(int ci, int cm, int co) {
  return ci == 2 * cm && co == 2 * cm && (cm == 4 || cm == 8 || cm == 16);
}

size_t bulge_mma_smem_bytes(int cm) {
  switch (cm) {
    case 4: return tc::MainSmem<8, 8, 8>::bytes;
    case 8: return tc::MainSmem<16, 8, 16>::bytes;
    case 16: return tc::MainSmem<32, 16, 32>::bytes;
  }
  return 0;
}

// w1: W1 (4 Ci x 4 Cmp) in B-fragment order, Cmp = max(cm, 8).
int bulge_stats_f32(const float* x, const float* w1, float* partial, int B,
                    int ci, int cm, int H, int W, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ci != 2 * cm) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 4: return tc::launch_stats<8, 8>(x, w1, partial, B, cm, H, W, n_sm, s);
    case 8: return tc::launch_stats<16, 8>(x, w1, partial, B, cm, H, W, n_sm, s);
    case 16: return tc::launch_stats<32, 16>(x, w1, partial, B, cm, H, W, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w2: W2 (16 Cmp x Co) in B-fragment order.
int bulge_main_f32(const float* x, const float* w1, const float* w2,
                   const float* mu, const float* gain, const float* beta,
                   float* y, int B, int ci, int cm, int co, int H, int W,
                   int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!bulge_mma_supported(ci, cm, co)) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 4: return tc::launch_main<8, 8, 8>(x, w1, w2, mu, gain, beta, y, B, cm, H, W, n_sm, s);
    case 8: return tc::launch_main<16, 8, 16>(x, w1, w2, mu, gain, beta, y, B, cm, H, W, n_sm, s);
    case 16: return tc::launch_main<32, 16, 32>(x, w1, w2, mu, gain, beta, y, B, cm, H, W, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the tensor-core kernel in bf16 ----------------------------------------

size_t bulge_mma_bf16_smem_bytes(int cm) {
  switch (cm) {
    case 4: return tcb::MainSmem<8, 8, 8>::bytes;
    case 8: return tcb::MainSmem<16, 8, 16>::bytes;
    case 16: return tcb::MainSmem<32, 16, 32>::bytes;
  }
  return 0;
}

// x, y bf16 (B, C, H, W); w1: W1 in bf16 m16n8k16 B-fragment order.
int bulge_stats_bf16(const void* x, const void* w1, float* partial, int B,
                     int ci, int cm, int H, int W, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* xb = (const uint16_t*)x;
  const uint16_t* w = (const uint16_t*)w1;
  if (ci != 2 * cm) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 4: return tcb::launch_stats<8, 8>(xb, w, partial, B, cm, H, W, n_sm, s);
    case 8: return tcb::launch_stats<16, 8>(xb, w, partial, B, cm, H, W, n_sm, s);
    case 16: return tcb::launch_stats<32, 16>(xb, w, partial, B, cm, H, W, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

int bulge_main_bf16(const void* x, const void* w1, const void* w2,
                    const float* mu, const float* gain, const float* beta,
                    void* y, int B, int ci, int cm, int co, int H, int W,
                    int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* xb = (const uint16_t*)x;
  const uint16_t* a = (const uint16_t*)w1;
  const uint16_t* b = (const uint16_t*)w2;
  uint16_t* yb = (uint16_t*)y;
  if (!bulge_mma_supported(ci, cm, co)) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 4: return tcb::launch_main<8, 8, 8>(xb, a, b, mu, gain, beta, yb, B, cm, H, W, n_sm, s);
    case 8: return tcb::launch_main<16, 8, 16>(xb, a, b, mu, gain, beta, yb, B, cm, H, W, n_sm, s);
    case 16: return tcb::launch_main<32, 16, 32>(xb, a, b, mu, gain, beta, yb, B, cm, H, W, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the fp32 FMA kernel ----------------------------------------------------

// Tile side; `partial` holds B * ceil(H/T) * ceil(W/T) * 2 * cm floats.
int bulge_tile() { return fp32fma::T; }

size_t bulge_main_smem_bytes(int ci, int cm, int co) {
  return fp32fma::main_smem(ci, cm, co);
}

// Channel counts with a compiled FMA instantiation, any Ci: (cm, co) =
// (4, 8), (8, 16) (gray-3 at ngf 8) and (16, 32) (the patch variants at
// ngf 16).
int bulge_supported(int cm, int co) {
  return (cm == 4 && co == 8) || (cm == 8 && co == 16) ||
         (cm == 16 && co == 32);
}

int bulge_stats_fma_f32(const float* x, const float* wT, float* partial, int B,
                        int ci, int cm, int H, int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (cm) {
    case 4: return fp32fma::launch_stats<4>(x, wT, partial, B, ci, H, W, s);
    case 8: return fp32fma::launch_stats<8>(x, wT, partial, B, ci, H, W, s);
    case 16: return fp32fma::launch_stats<16>(x, wT, partial, B, ci, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

int bulge_main_fma_f32(const float* x, const float* wT, const float* wC,
                       const float* mu, const float* gain, const float* beta,
                       float* y, int B, int ci, int cm, int co, int H, int W,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cm == 4 && co == 8)
    return fp32fma::launch_main<4, 8>(x, wT, wC, mu, gain, beta, y, B, ci, H, W, s);
  if (cm == 8 && co == 16)
    return fp32fma::launch_main<8, 16>(x, wT, wC, mu, gain, beta, y, B, ci, H, W, s);
  if (cm == 16 && co == 32)
    return fp32fma::launch_main<16, 32>(x, wT, wC, mu, gain, beta, y, B, ci, H, W, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
