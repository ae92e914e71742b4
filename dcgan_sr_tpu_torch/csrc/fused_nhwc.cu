// Fused convT(k4s2p1) + BatchNorm + ReLU + conv(k4s2p1), channels-last,
// row-band formulation with packed weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel dcgan_sr_tpu/ops/pallas_fused.py
// fused_convT_bn_relu_conv (_stats_kernel :98, _main_kernel :119): the same
// function as csrc/bulge.cu, y = conv(relu(bn(convT(x)))) without writing the
// 2x-resolution hidden tensor h to device memory, in that kernel's own
// formulation:
//
//   * x and y are NHWC; the image is cut into bands of `tm` rows;
//   * convT is ONE product over K = 4*Ci: the patch matrix row of position
//     (i, j) holds the 2x2 window x[i-1+ti, j-1+tj, :] (ti, tj in {0, 1}), and
//     the packed weight wtall (4Ci, 4Cm) yields all four output parities
//     (di, dj) at once:  p[i, j, (di, dj, cm)] = h[2i - di, 2j - dj, cm];
//   * the consumer conv is ONE product over K = 16*Cm: output (m, n) gathers a
//     2x2 window of positions (m+sa, n+sb) from each of the four parity
//     planes, against the packed weight wcall (16Cm, Co), rows
//     (k = di*2+dj, sa, sb, cm).
// Both launches (stats, then main) recompute the planes; the hidden cells
// that are the consumer's zero padding (row or column -1, 2H or 2W) are
// zeroed after the ReLU.  H must be a multiple of tm, as in the TPU kernel;
// any W, any batch.
//
// Three kernels live here: (1) and its bf16 instantiation (3) serve the
// built channel triples, (2) every triple in fp32.
//
// (1) The tensor-core kernel (namespace tc; entries fused_nhwc_stats_f32,
//     fused_nhwc_main_f32), for the channel triples (Ci, Cm, Co) = (8, 4, 8),
//     (16, 8, 16), (32, 16, 32); Cm 4 runs padded to 8 with zero weights.
//     Both packed products run on mma.sync.m16n8k8 TF32 with fp32
//     accumulators at full fp32 accuracy by error compensation ("3xTF32"):
//     every operand a is split in registers as hi = a & 0xffffe000, lo =
//     a - hi, and every product is three mma's, lo*hi + hi*lo + hi*hi.
//
//     Work item = (image, pass of R = 8 rows of a tm-row band, chunk of
//     TW = 32 columns), enumerated chunk fastest, then pass, band, image.
//     tm only decides where a band ends: a pass is clipped there, and a pass
//     owns its rows' statistics up to there.  A persistent grid of (SMs x
//     blocks that fit) blocks walks the items blockIdx.x, + gridDim.x, ...,
//     so no grid dimension limits the batch.  The packed weights are staged
//     once per block.
//
//     Stage 1 (convT).  Local position (pi, pj), pi in [0, R], pj in [0, TW],
//     is x position (r0 + pi, c0 + pj); its window is xs rows pi, pi+1 and
//     columns pj, pj+1, with xs = x rows r0-1 .. r0+R, columns c0-1 ..
//     c0+TW, zero outside the image:
//       P (297 positions x 4 Cmp) = A1 (297 x 4 Ci) @ W1 (4 Ci x 4 Cmp).
//     Main: P is normalised, rectified, zeroed where the hidden cell is the
//     consumer's padding, and kept in shared memory as planes
//     hp[position][4 Cmp].  Stats: each item sums the hidden cells it owns
//     (even parities at positions [0, R) x [0, TW), odd ones at [1, R] x
//     [1, TW], clipped to the band and the image), so each cell counts once.
//     Stage 2 (conv, main only).  Warp w computes y row r0 + w, all TW
//     columns and all Co channels:
//       Y (256 pixels x Co) = A2 (256 x 16 Cmp) @ W2 (16 Cmp x Co),
//     A2[(m, n)][(k, sa, sb, cm)] = hp[(m + sa, n + sb)][k Cmp + cm].
//
//     Shared-memory traffic.  In NHWC a pixel's channels are contiguous, so
//     the mma's k index is permuted within each group of 8 channels: k = t
//     is channel 2t and k = t + 4 channel 2t + 1.  Lane (g, t) then reads
//     its two A elements of a row as one 8-byte load, half the loads of K2's
//     NCHW kernel; the host packs W1 and W2 rows in the same order
//     (ops/fused_nhwc_mma.py).  An 8-byte load is served half a warp at a
//     time: the four positions of a half warp must fall on distinct 8-word
//     bank groups, so pixel strides are odd multiples of 8 floats (xs: 8, 24,
//     40 at Ci 8, 16, 32; hp: 4 Cmp + 8 = 40, 72) and the xs row stride is
//     37 pixels, = 33 mod 4, so a tile that wraps from one position row to
//     the next keeps four distinct residues.  The epilogue stores P as 8-byte
//     pairs under the same rule.
//
//     Copies in flight: x arrives by 16-byte cp.async (a pixel is Ci/4
//     copies; outside the image the copy reads nothing and writes zeros, so
//     there is no halo case and no padded copy of x).  The x of the next
//     item arrives while stage 2 of the current one runs.  y leaves the
//     registers as 8-byte stores: four lanes write 32 contiguous bytes of a
//     pixel.
//
//     Shared memory at Ci 16 / Cm 8 / Co 16, bytes: W1 8,192 + W2 8,192 +
//     xs 10*37*24*4 = 35,520 + hp 297*40*4 = 47,520 + BN 96 = 99,520: two
//     blocks of 8 warps an SM.  At Ci 32 / Cm 16 / Co 32: 32,768 + 32,768 +
//     59,200 + 85,536 + 192 = 210,464: one block.
//
//     Bound on an H100 (TF32 495 TFLOP/s, so 165 for 3xTF32; fp32 FMA 67;
//     HBM 3.35 TB/s): at x (100, 16, 256, 256), Cm 8, Co 16 the two packed
//     products are 2048 MAC per pixel each, 27.5 + 54.3 GFLOP for stats +
//     main: 0.167 + 0.329 ms at the 3xTF32 rate, against 0.125 + 0.250 ms
//     for the bytes.  Both launches are bound by operations.
//
// (2) The earlier fp32 FMA kernel (namespace fp32fma; entries
//     fused_nhwc_stats_fma_f32, fused_nhwc_main_fma_f32): a block owns
//     (image, band, 32 columns) and walks its band in passes of 8 rows with
//     plain FMA from shared memory.  It is the yardstick the tensor-core
//     kernel is timed against and serves every other channel triple (Cm up
//     to 64).  A batch over 65,535 images, or more bands than that, goes in
//     several launches.
//
// (3) The tensor-core kernel in bf16 (namespace tcb; entries
//     fused_nhwc_stats_bf16, fused_nhwc_main_bf16): the function of
//     fused_convT_bn_relu_conv with bf16 x (pallas_fused.py:193-194, 153,
//     168, 239).  x, the packed weights, the planes fed to stage 2 and y are
//     bf16; each product is ONE mma.sync.m16n8k16 bf16 pass with fp32
//     accumulators (no split); statistics, BN, ReLU and the edge mask run in
//     fp32 on the accumulators, and a plane is rounded to bf16 only when it
//     is stored.  Same items, schedule, persistent grid, cp.async staging and
//     next-x overlap as (1).
//
//     A register of an m16n8k16 fragment holds two k-adjacent bf16 values:
//     register j of lane (g, t) holds mma k 8j + 2t and 8j + 2t + 1.  The k
//     index is permuted within every group of 16 so that mma k 8j + 2t + i
//     is channel 4t + 2j + i: a lane's two registers of a row are channels
//     4t .. 4t + 3 of one NHWC pixel, ONE 8-byte load (a group of 16 is four
//     runs of 4 channels; channel counts are multiples of 8, so no run
//     straddles two taps or two windows).  The host packs W1 and W2 in the
//     same order (ops/fused_nhwc_mma.py to_fragments_bf16): a lane's four
//     values of an n8 tile are one 8-byte load too.  Pixel strides are odd
//     multiples of 32 bytes (xs: 16, 16, 48 bf16 at Ci 8, 16, 32; hp:
//     4 Cmp + 16 = 48, 80), so the four pixels of a half warp's 8-byte loads
//     fall on distinct 8-bank groups, as in (1).  The epilogue stores a
//     lane's two columns as one bf16 pair (4 bytes), y leaves as bf16 pairs.
//
//     Shared memory, bytes: at Ci 16 / Cm 8 / Co 16, W1 4,096 + W2 4,096 +
//     xs 10*37*16*2 = 11,840 + hp 297*48*2 = 28,512 + BN 96 = 48,640 (half
//     of (1)'s 99,520; launch bound 2 caps the registers at 128, and the
//     occupancy query takes whatever more the registers allow).  At Ci 32 /
//     Cm 16 / Co 32: 16,384 + 16,384 + 35,520 + 47,520 + 192 = 116,000: one
//     block.
//
//     Bounds on an H100 (bf16 dense 989 TFLOP/s; HBM 3.35 TB/s): at x
//     (100, 16, 256, 256) bf16, Cm 8, Co 16, the stats launch reads x (210
//     MB; 223 MB with the tm + 2 row halo of tm 32) and the main launch also
//     writes y (210 MB): 0.063 / 0.125 ms for the bytes, against 27.5 / 54.3
//     GFLOP, 0.028 / 0.055 ms: both bound by bytes.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/fused_nhwc.py).
// Each launch entry returns the cudaError_t of its launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tc {

constexpr int R = 8;             // rows of a work item
constexpr int TW = 32;           // columns of a work item
constexpr int XR = R + 2;        // x rows staged: r0-1 .. r0+R
constexpr int XC = 37;           // xs row stride in pixels (>= TW + 2)
constexpr int PR = R + 1;        // local position rows
constexpr int PC = TW + 1;       // local position columns
constexpr int NPOS = PR * PC;    // 297
constexpr int NT = 256;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int M1T = (NPOS + 15) / 16;   // stage-1 m16 tiles: 19
constexpr int M1PAIRS = 8;       // of which 16 go in pairs, the rest singly
constexpr int NG = 4;            // n8 tiles a warp holds at a time, at most

// pixel stride of xs and of hp, in floats: odd multiples of 8
__host__ __device__ constexpr int xs_stride(int ci) {
  return (ci % 32 == 8 || ci % 32 == 24) ? ci : ci + 8;
}
__host__ __device__ constexpr int hp_stride(int cmp) { return 4 * cmp + 8; }

static_assert(XC >= TW + 2 && (XC - PC) % 4 == 0, "xs row stride");
static_assert(xs_stride(8) % 32 == 8 && xs_stride(16) % 32 == 24 &&
                  xs_stride(32) % 32 == 8,
              "xs pixel stride");
static_assert(hp_stride(8) % 32 == 8 && hp_stride(16) % 32 == 8,
              "hp pixel stride");
static_assert(R == NWARP, "stage 2 gives each warp one row of the item");
static_assert(TW == 32, "a row of the item is two m16 tiles");
static_assert(2 * M1PAIRS * 16 <= NPOS, "paired tiles hold no phantom row");

// a = hi + lo exactly: hi keeps a's upper 19 bits (a TF32 value), lo is the
// fp32 remainder, of which the mma reads the upper 19 bits in turn (as
// csrc/bulge.cu split_tf32).
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

// 16 bytes global -> shared; with src_bytes 0 nothing is read and the 16
// bytes of dst become zero.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One lane's A fragment of a k step from two 8-byte loads (rows g and
// g + 8, channels 2t and 2t + 1, which are the mma's k = t and t + 4), split.
__device__ __forceinline__ void load_a(const float* p0, const float* p1,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 u = *reinterpret_cast<const float2*>(p0);
  const float2 v = *reinterpret_cast<const float2*>(p1);
  split_tf32(u.x, ah[0], al[0]);
  split_tf32(v.x, ah[1], al[1]);
  split_tf32(u.y, ah[2], al[2]);
  split_tf32(v.y, ah[3], al[3]);
}

// Item geometry: image b, rows [r0, rend) (rend clipped at the band's end),
// columns from c0.
struct Item {
  int b, r0, rend, c0;
};

struct Grid {
  int tm, nbands, npass, nchunks;
  long long n_items;
};

__device__ __forceinline__ Item decode(long long idx, const Grid& gd) {
  Item it;
  long long rest = idx / gd.nchunks;
  it.c0 = (int)(idx - rest * gd.nchunks) * TW;
  const long long band_idx = rest / gd.npass;
  const int pass = (int)(rest - band_idx * gd.npass);
  it.b = (int)(band_idx / gd.nbands);
  const int band = (int)(band_idx - (long long)it.b * gd.nbands);
  it.r0 = band * gd.tm + pass * R;
  const int band_end = (band + 1) * gd.tm;
  it.rend = it.r0 + R < band_end ? it.r0 + R : band_end;
  return it;
}

// n floats (a multiple of 4), both 16-byte aligned.
__device__ __forceinline__ void stage_weights(float* dst, const float* src,
                                              int n, int tid) {
  for (int k = tid * 4; k < n; k += NT * 4) cp_async16(dst + k, src + k, 16);
}

// xs[r][q][c] = x[b, r0-1+r, c0-1+q, c], zero outside the image; xb is
// image b.  A row of the window is (TW + 2) * CI contiguous floats of x.
template <int CI>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ xb,
                                        int r0, int c0, int H, int W, int tid) {
  constexpr int PS = xs_stride(CI), V = CI / 4;
  constexpr int PER_ROW = (TW + 2) * V;
  for (int k = tid; k < XR * PER_ROW; k += NT) {
    const int r = k / PER_ROW, rem = k - r * PER_ROW;
    const int q = rem / V, v = rem - q * V;
    const int gi = r0 - 1 + r, gj = c0 - 1 + q;
    const bool in = (unsigned)gi < (unsigned)H && (unsigned)gj < (unsigned)W;
    const float* src = in ? xb + ((size_t)gi * W + gj) * CI + 4 * v : xb;
    cp_async16(xs + (r * XC + q) * PS + 4 * v, src, in ? 16 : 0);
  }
  cp_async_commit();
}

// One unit of stage 1: acc (MT m16 tiles from tile m0 x NG n8 tiles of group
// nh) = A1 @ W1, handed to epi(m0, nh*NG*8, acc).  w1 is in B-fragment order
// with k permuted as above: w1[((ks*N1T + nt)*32 + lane)*2 + j] =
// W1[ks*8 + 2(lane&3) + j][nt*8 + lane/4].
template <int CI, int CMP, int MT, class Epi>
__device__ __forceinline__ void stage1_unit(const float* xs, const float* w1,
                                            int m0, int nh, int lane,
                                            Epi& epi) {
  constexpr int PS = xs_stride(CI);
  constexpr int CIS = CI / 8;          // k steps per tap
  constexpr int N1T = 4 * CMP / 8;     // n8 tiles: 4 or 8
  const int g = lane >> 2, t = lane & 3;
  int aoff[2 * MT];   // rows g, g+8 of each tile
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    int q = m0 * 16 + r * 8 + g;
    q = q < NPOS ? q : NPOS - 1;       // phantom rows read a valid cell
    aoff[r] = ((q / PC) * XC + q % PC) * PS + 2 * t;
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
      const int koff = ((tap >> 1) * XC + (tap & 1)) * PS + cs * 8;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a(xs + aoff[2 * mt] + koff, xs + aoff[2 * mt + 1] + koff, ah[mt],
               al[mt]);
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
// warps.
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
// planes.  Column n of a unit is parity n0/CMP + ng*8/CMP, channel
// (ng*8)%CMP + 2t + col: the parity is the same for all lanes.
template <int CMP>
struct MainEpi {
  float* hp;
  const float* bn;    // mu[CMP], gain[CMP], beta[CMP]
  int r0, c0, H, W, lane;
  template <int MT>
  __device__ __forceinline__ void operator()(int m0, int n0,
                                             const float (&acc)[MT][NG][4]) {
    constexpr int HS = hp_stride(CMP);
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
        // hidden row 2(r0 + pi) - di lies in [0, 2H) iff r0 + pi - di does
        // in [0, H); columns alike
        bool row_in[2], col_in[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          row_in[d] = (unsigned)(r0 + pi - d) < (unsigned)H;
          col_in[d] = (unsigned)(c0 + pj - d) < (unsigned)W;
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
          *reinterpret_cast<float2*>(hp + q * HS + n0 + ng * 8 + 2 * t) =
              make_float2(v[0], v[1]);
        }
      }
  }
};

// Stats epilogue: per-thread fp32 sum and sum of squares of the hidden cells
// this item owns, per column of the thread's fragments.
template <int CMP>
struct StatsEpi {
  float s[NG][2][2];   // [n tile][column][sum, sum of squares]
  int r0, rend, c0, cend, lane;
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
        // parity d's cell at this position is row r0 + pi - d of the item's
        // rows [r0, rend), column c0 + pj - d of [c0, cend)
        bool row_own[2], col_own[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          row_own[d] = pi - d >= 0 && r0 + pi - d < rend;
          col_own[d] = pj - d >= 0 && c0 + pj - d < cend;
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

// Stage 2: warp `warp` computes y row r0 + warp of the item, all TW columns
// and all CO channels, from the planes; yb is image b of y (NHWC).
template <int CMP, int CO>
__device__ __forceinline__ void stage2(const float* hp, const float* w2,
                                       int warp, int lane,
                                       float* __restrict__ yb, const Item& it,
                                       int W) {
  constexpr int HS = hp_stride(CMP);
  constexpr int CMS = CMP / 8;         // k steps per (k, sa, sb)
  constexpr int N2T = CO / 8;          // n8 tiles: 1, 2 or 4
  static_assert(N2T <= NG, "stage 2 holds all of Co at once");
  const int g = lane >> 2, t = lane & 3;
  const int ml = warp;
  int aoff[4];     // pixels g, g+8, g+16, g+24 of the row
#pragma unroll
  for (int r = 0; r < 4; ++r) aoff[r] = (ml * PC + r * 8 + g) * HS + 2 * t;
  float acc[2][N2T][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < N2T; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {      // s = sa*2 + sb
#pragma unroll
      for (int cs = 0; cs < CMS; ++cs) {
        const int ks = (k * 4 + s) * CMS + cs;
        const int koff = ((s >> 1) * PC + (s & 1)) * HS + k * CMP + cs * 8;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          load_a(hp + aoff[2 * mt] + koff, hp + aoff[2 * mt + 1] + koff,
                 ah[mt], al[mt]);
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
  const int m = it.r0 + ml;
  if (m >= it.rend) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = it.c0 + mt * 16 + half * 8 + g;
      if (n >= W) continue;
      float* yp = yb + ((size_t)m * W + n) * CO + 2 * t;
#pragma unroll
      for (int nt = 0; nt < N2T; ++nt)
        *reinterpret_cast<float2*>(yp + nt * 8) =
            make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
    }
}

template <int CI, int CMP, int CO>
struct MainSmem {
  static constexpr int W1N = 4 * CI * 4 * CMP;
  static constexpr int W2N = 16 * CMP * CO;
  static constexpr int XN = XR * XC * xs_stride(CI);
  static constexpr int HN = NPOS * hp_stride(CMP);
  static constexpr int BNN = 3 * CMP;
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(W1N + W2N + XN + HN + BNN);
};

// bn: (3, 4 cm) rows mean, gain, bias, each tiled over the four parities.
template <int CI, int CMP, int CO>
__global__ void __launch_bounds__(NT, (CI <= 16 ? 2 : 1))
fused_nhwc_main_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ w2,
                       const float* __restrict__ bn, float* __restrict__ y,
                       int cm_n, int H, int W, Grid gd) {
  using S = MainSmem<CI, CMP, CO>;
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem;
  float* s_w2 = s_w1 + S::W1N;
  float* xs = s_w2 + S::W2N;
  float* hp = xs + S::XN;
  float* s_bn = hp + S::HN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t x_img = (size_t)H * W * CI, y_img = (size_t)H * W * CO;
  long long idx = blockIdx.x;
  if (idx >= gd.n_items) return;
  stage_weights(s_w1, w1, S::W1N, tid);
  stage_weights(s_w2, w2, S::W2N, tid);
  if (tid < 3 * CMP) {
    const int r = tid / CMP, c = tid - r * CMP;
    s_bn[tid] = c < cm_n ? bn[r * 4 * cm_n + c] : 0.f;
  }
  {
    const Item it = decode(idx, gd);
    stage_x<CI>(xs, x + it.b * x_img, it.r0, it.c0, H, W, tid);
  }
  for (; idx < gd.n_items; idx += gridDim.x) {
    const Item it = decode(idx, gd);
    cp_async_wait_all();
    __syncthreads();   // xs (and the weights) arrived; hp is free
    MainEpi<CMP> epi{hp, s_bn, it.r0, it.c0, H, W, lane};
    stage1<CI, CMP>(xs, s_w1, warp, lane, epi);
    __syncthreads();   // hp complete; xs is free
    const long long next = idx + gridDim.x;
    if (next < gd.n_items) {
      const Item nx = decode(next, gd);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, tid);
    }
    stage2<CMP, CO>(hp, s_w2, warp, lane, y + it.b * y_img, it, W);
  }
}

template <int CI, int CMP>
struct StatsSmem {
  static constexpr int W1N = 4 * CI * 4 * CMP;
  static constexpr int XN = XR * XC * xs_stride(CI);
  static constexpr int REDN = NWARP * NG * 8 * 2;
  static constexpr size_t bytes = sizeof(float) * (size_t)(W1N + XN + REDN);
};

// partial[idx][0][cm] = sum, partial[idx][1][cm] = sum of squares of the
// hidden cells item idx owns.
template <int CI, int CMP>
__global__ void __launch_bounds__(NT, (CI <= 16 ? 2 : 1))
fused_nhwc_stats_kernel(const float* __restrict__ x,
                        const float* __restrict__ w1,
                        float* __restrict__ partial, int cm_n, int H, int W,
                        Grid gd) {
  using S = StatsSmem<CI, CMP>;
  constexpr int NH = 4 * CMP / 8 / NG;
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem;
  float* xs = s_w1 + S::W1N;
  float* red = xs + S::XN;     // [warp][local column 0..31][sum, squares]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t x_img = (size_t)H * W * CI;
  long long idx = blockIdx.x;
  if (idx >= gd.n_items) return;
  stage_weights(s_w1, w1, S::W1N, tid);
  {
    const Item it = decode(idx, gd);
    stage_x<CI>(xs, x + it.b * x_img, it.r0, it.c0, H, W, tid);
  }
  for (; idx < gd.n_items; idx += gridDim.x) {
    const Item it = decode(idx, gd);
    cp_async_wait_all();
    __syncthreads();   // xs arrived; red of the previous item was read
    StatsEpi<CMP> epi;
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int col = 0; col < 2; ++col)
        epi.s[ng][col][0] = epi.s[ng][col][1] = 0.f;
    epi.r0 = it.r0; epi.rend = it.rend; epi.c0 = it.c0;
    epi.cend = it.c0 + TW < W ? it.c0 + TW : W;
    epi.lane = lane;
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
    if (next < gd.n_items) {
      const Item nx = decode(next, gd);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, tid);
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

// The items of x (B, H, W, .) in bands of tm rows; false if the geometry is
// not one the kernel takes.
inline bool make_grid(int B, int H, int W, int tm, Grid* gd) {
  if (B < 0 || H < 1 || W < 1 || tm < 1 || H % tm != 0) return false;
  gd->tm = tm;
  gd->nbands = H / tm;
  gd->npass = (tm + R - 1) / R;
  gd->nchunks = (W + TW - 1) / TW;
  gd->n_items = (long long)B * gd->nbands * gd->npass * gd->nchunks;
  return true;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int CI, int CMP, int CO>
int launch_main(const float* x, const float* w1, const float* w2,
                const float* bn, float* y, int B, int H, int W, int cm,
                int tm, int n_sm, cudaStream_t stream) {
  Grid gd;
  if (!make_grid(B, H, W, tm, &gd) || !aligned16(x) || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (gd.n_items == 0) return (int)cudaSuccess;
  const size_t smem = MainSmem<CI, CMP, CO>::bytes;
  int grid = 0;
  cudaError_t e = persistent_grid(fused_nhwc_main_kernel<CI, CMP, CO>, smem,
                                  n_sm, gd.n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  fused_nhwc_main_kernel<CI, CMP, CO><<<grid, NT, smem, stream>>>(
      x, w1, w2, bn, y, cm, H, W, gd);
  return (int)cudaGetLastError();
}

template <int CI, int CMP>
int launch_stats(const float* x, const float* w1, float* partial, int B,
                 int H, int W, int cm, int tm, int n_sm,
                 cudaStream_t stream) {
  Grid gd;
  if (!make_grid(B, H, W, tm, &gd) || !aligned16(x) || !aligned16(w1))
    return (int)cudaErrorInvalidValue;
  if (gd.n_items == 0) return (int)cudaSuccess;
  const size_t smem = StatsSmem<CI, CMP>::bytes;
  int grid = 0;
  cudaError_t e = persistent_grid(fused_nhwc_stats_kernel<CI, CMP>, smem,
                                  n_sm, gd.n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  fused_nhwc_stats_kernel<CI, CMP><<<grid, NT, smem, stream>>>(
      x, w1, partial, cm, H, W, gd);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The bf16 instantiation of the tensor-core kernel; see (3) in the header.
namespace tcb {

using tc::Grid;
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
using tc::XC;
using tc::XR;

typedef __nv_bfloat16 bf16;

// pixel strides of xs and hp in bf16: odd multiples of 16 (32 bytes)
__host__ __device__ constexpr int xs_stride_b(int ci) {
  return ci <= 16 ? 16 : ci + 16;
}
__host__ __device__ constexpr int hp_stride_b(int cmp) { return 4 * cmp + 16; }

static_assert(xs_stride_b(8) % 64 == 16 && xs_stride_b(16) % 64 == 16 &&
                  xs_stride_b(32) % 64 == 48,
              "bf16 xs pixel stride");
static_assert(hp_stride_b(8) % 64 == 48 && hp_stride_b(16) % 64 == 16,
              "bf16 hp pixel stride");

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
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

// One lane's A fragment of a k16 step from two 8-byte loads: channels
// 4t .. 4t+3 of rows g (p0) and g + 8 (p1).  The first pair of a row is
// register 0 (row g) or 1 (row g + 8), the second register 2 or 3.
__device__ __forceinline__ void load_a(const bf16* p0, const bf16* p1,
                                       uint32_t (&a)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p0);
  const uint2 v = *reinterpret_cast<const uint2*>(p1);
  a[0] = u.x;
  a[1] = v.x;
  a[2] = u.y;
  a[3] = v.y;
}

// xs[r][q][c] = x[b, r0-1+r, c0-1+q, c], zero outside the image; a pixel is
// CI/8 16-byte copies.
template <int CI>
__device__ __forceinline__ void stage_x(bf16* xs, const bf16* __restrict__ xb,
                                        int r0, int c0, int H, int W, int tid) {
  constexpr int PS = xs_stride_b(CI), V = CI / 8;
  constexpr int PER_ROW = (TW + 2) * V;
  for (int k = tid; k < XR * PER_ROW; k += NT) {
    const int r = k / PER_ROW, rem = k - r * PER_ROW;
    const int q = rem / V, v = rem - q * V;
    const int gi = r0 - 1 + r, gj = c0 - 1 + q;
    const bool in = (unsigned)gi < (unsigned)H && (unsigned)gj < (unsigned)W;
    const bf16* src = in ? xb + ((size_t)gi * W + gj) * CI + 8 * v : xb;
    tc::cp_async16(reinterpret_cast<float*>(xs + (r * XC + q) * PS + 8 * v),
                   reinterpret_cast<const float*>(src), in ? 16 : 0);
  }
  tc::cp_async_commit();
}

// One unit of stage 1 in bf16: acc (MT m16 tiles from tile m0 x NG n8 tiles
// of group nh) = A1 @ W1, handed to epi(m0, nh*NG*8, acc).  Lane t of k16
// step ks reads logical k ks*16 + 4t .. +3: channels c .. c+3 of tap
// (ks*16 + 4t) / CI.  w1: a lane's four values of an n8 tile at
// ((ks*N1T + nt)*32 + lane)*4.
template <int CI, int CMP, int MT, class Epi>
__device__ __forceinline__ void stage1_unit(const bf16* xs, const bf16* w1,
                                            int m0, int nh, int lane,
                                            Epi& epi) {
  constexpr int PS = xs_stride_b(CI);
  constexpr int KS = 4 * CI / 16;      // k16 steps
  constexpr int N1T = 4 * CMP / 8;     // n8 tiles: 4 or 8
  const int g = lane >> 2, t = lane & 3;
  int aoff[2 * MT];   // rows g, g+8 of each tile
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    int q = m0 * 16 + r * 8 + g;
    q = q < NPOS ? q : NPOS - 1;       // phantom rows read a valid cell
    aoff[r] = ((q / PC) * XC + q % PC) * PS;
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
    const int kl = ks * 16 + 4 * t;
    const int tap = kl / CI, c = kl - tap * CI;
    const int koff = ((tap >> 1) * XC + (tap & 1)) * PS + c;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      load_a(xs + aoff[2 * mt] + koff, xs + aoff[2 * mt + 1] + koff, a[mt]);
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
__device__ __forceinline__ void stage1(const bf16* xs, const bf16* w1,
                                       int warp, int lane, Epi& epi) {
  constexpr int NH = 4 * CMP / 8 / NG;
  static_assert(NWARP % NH == 0, "a warp keeps its group of n tiles");
  for (int u = warp; u < M1PAIRS * NH; u += NWARP)
    stage1_unit<CI, CMP, 2>(xs, w1, 2 * (u / NH), u % NH, lane, epi);
  for (int u = warp; u < (M1T - 2 * M1PAIRS) * NH; u += NWARP)
    stage1_unit<CI, CMP, 1>(xs, w1, 2 * M1PAIRS + u / NH, u % NH, lane, epi);
}

// Main epilogue in bf16: normalise, rectify and zero the consumer's padding
// in fp32, then round a lane's two columns to a bf16 pair and store it.
template <int CMP>
struct MainEpi {
  bf16* hp;
  const float* bn;    // mu[CMP], gain[CMP], beta[CMP]
  int r0, c0, H, W, lane;
  template <int MT>
  __device__ __forceinline__ void operator()(int m0, int n0,
                                             const float (&acc)[MT][NG][4]) {
    constexpr int HS = hp_stride_b(CMP);
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
          row_in[d] = (unsigned)(r0 + pi - d) < (unsigned)H;
          col_in[d] = (unsigned)(c0 + pj - d) < (unsigned)W;
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
          *reinterpret_cast<uint32_t*>(hp + q * HS + n0 + ng * 8 + 2 * t) =
              pack_bf16(v[0], v[1]);
        }
      }
  }
};

// Stage 2 in bf16: warp `warp` computes y row r0 + warp of the item, all TW
// columns and all CO channels.  Lane t of k16 step ks reads logical k
// ks*16 + 4t .. +3: channels c .. c+3 of window w = (ks*16 + 4t) / CMP,
// w = parity*4 + sa*2 + sb (W2's row order).
template <int CMP, int CO>
__device__ __forceinline__ void stage2(const bf16* hp, const bf16* w2,
                                       int warp, int lane,
                                       bf16* __restrict__ yb, const Item& it,
                                       int W) {
  constexpr int HS = hp_stride_b(CMP);
  constexpr int KS = CMP;              // 16 * CMP / 16 k16 steps
  constexpr int N2T = CO / 8;
  static_assert(N2T <= NG, "stage 2 holds all of Co at once");
  const int g = lane >> 2, t = lane & 3;
  const int ml = warp;
  int aoff[4];     // pixels g, g+8, g+16, g+24 of the row
#pragma unroll
  for (int r = 0; r < 4; ++r) aoff[r] = (ml * PC + r * 8 + g) * HS;
  float acc[2][N2T][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < N2T; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int kl = ks * 16 + 4 * t;
    const int win = kl / CMP, c = kl - win * CMP;
    const int s = win & 3;
    const int koff = ((s >> 1) * PC + (s & 1)) * HS + (win >> 2) * CMP + c;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      load_a(hp + aoff[2 * mt] + koff, hp + aoff[2 * mt + 1] + koff, a[mt]);
#pragma unroll
    for (int nt = 0; nt < N2T; ++nt) {
      const uint2 bv = *reinterpret_cast<const uint2*>(
          w2 + ((ks * N2T + nt) * 32 + lane) * 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], bv.x, bv.y);
    }
  }
  const int m = it.r0 + ml;
  if (m >= it.rend) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = it.c0 + mt * 16 + half * 8 + g;
      if (n >= W) continue;
      bf16* yp = yb + ((size_t)m * W + n) * CO + 2 * t;
#pragma unroll
      for (int nt = 0; nt < N2T; ++nt)
        *reinterpret_cast<uint32_t*>(yp + nt * 8) =
            pack_bf16(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
    }
}

template <int CI, int CMP, int CO>
struct MainSmem {
  static constexpr int W1N = 4 * CI * 4 * CMP;             // bf16
  static constexpr int W2N = 16 * CMP * CO;                // bf16
  static constexpr int XN = XR * XC * xs_stride_b(CI);     // bf16
  static constexpr int HN = NPOS * hp_stride_b(CMP);       // bf16
  static constexpr int BNN = 3 * CMP;                      // fp32
  static constexpr size_t bytes =
      2 * (size_t)(W1N + W2N + XN + HN) + 4 * (size_t)BNN;
  static_assert((2 * (W1N + W2N)) % 16 == 0 && (2 * XN) % 16 == 0 &&
                    (2 * HN) % 16 == 0,
                "xs and hp 16-byte aligned");
};

// bn: (3, 4 cm) fp32 rows mean, gain, bias, each tiled over the four
// parities; x, w1, w2, y bf16.
template <int CI, int CMP, int CO>
__global__ void __launch_bounds__(NT, (CI <= 16 ? 2 : 1))
fused_nhwc_main_bf16_kernel(const bf16* __restrict__ x,
                            const bf16* __restrict__ w1,
                            const bf16* __restrict__ w2,
                            const float* __restrict__ bn,
                            bf16* __restrict__ y, int cm_n, int H, int W,
                            Grid gd) {
  using S = MainSmem<CI, CMP, CO>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_w1 = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_w2 = s_w1 + S::W1N;
  bf16* xs = s_w2 + S::W2N;
  bf16* hp = xs + S::XN;
  float* s_bn = reinterpret_cast<float*>(hp + S::HN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t x_img = (size_t)H * W * CI, y_img = (size_t)H * W * CO;
  long long idx = blockIdx.x;
  if (idx >= gd.n_items) return;
  tc::stage_weights(reinterpret_cast<float*>(s_w1),
                    reinterpret_cast<const float*>(w1), S::W1N / 2, tid);
  tc::stage_weights(reinterpret_cast<float*>(s_w2),
                    reinterpret_cast<const float*>(w2), S::W2N / 2, tid);
  if (tid < 3 * CMP) {
    const int r = tid / CMP, c = tid - r * CMP;
    s_bn[tid] = c < cm_n ? bn[r * 4 * cm_n + c] : 0.f;
  }
  {
    const Item it = tc::decode(idx, gd);
    stage_x<CI>(xs, x + it.b * x_img, it.r0, it.c0, H, W, tid);
  }
  for (; idx < gd.n_items; idx += gridDim.x) {
    const Item it = tc::decode(idx, gd);
    tc::cp_async_wait_all();
    __syncthreads();   // xs (and the weights) arrived; hp is free
    MainEpi<CMP> epi{hp, s_bn, it.r0, it.c0, H, W, lane};
    stage1<CI, CMP>(xs, s_w1, warp, lane, epi);
    __syncthreads();   // hp complete; xs is free
    const long long next = idx + gridDim.x;
    if (next < gd.n_items) {
      const Item nx = tc::decode(next, gd);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, tid);
    }
    stage2<CMP, CO>(hp, s_w2, warp, lane, y + it.b * y_img, it, W);
  }
}

template <int CI, int CMP>
struct StatsSmem {
  static constexpr int W1N = 4 * CI * 4 * CMP;             // bf16
  static constexpr int XN = XR * XC * xs_stride_b(CI);     // bf16
  static constexpr int REDN = NWARP * NG * 8 * 2;          // fp32
  static constexpr size_t bytes =
      2 * (size_t)(W1N + XN) + sizeof(float) * (size_t)REDN;
};

// partial[idx][0][cm] = sum, partial[idx][1][cm] = sum of squares of the
// hidden cells item idx owns, in fp32 from the fp32 accumulators.
template <int CI, int CMP>
__global__ void __launch_bounds__(NT, (CI <= 16 ? 2 : 1))
fused_nhwc_stats_bf16_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ w1,
                             float* __restrict__ partial, int cm_n, int H,
                             int W, Grid gd) {
  using S = StatsSmem<CI, CMP>;
  constexpr int NH = 4 * CMP / 8 / NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_w1 = reinterpret_cast<bf16*>(smem_raw);
  bf16* xs = s_w1 + S::W1N;
  float* red = reinterpret_cast<float*>(xs + S::XN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t x_img = (size_t)H * W * CI;
  long long idx = blockIdx.x;
  if (idx >= gd.n_items) return;
  tc::stage_weights(reinterpret_cast<float*>(s_w1),
                    reinterpret_cast<const float*>(w1), S::W1N / 2, tid);
  {
    const Item it = tc::decode(idx, gd);
    stage_x<CI>(xs, x + it.b * x_img, it.r0, it.c0, H, W, tid);
  }
  for (; idx < gd.n_items; idx += gridDim.x) {
    const Item it = tc::decode(idx, gd);
    tc::cp_async_wait_all();
    __syncthreads();   // xs arrived; red of the previous item was read
    tc::StatsEpi<CMP> epi;
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int col = 0; col < 2; ++col)
        epi.s[ng][col][0] = epi.s[ng][col][1] = 0.f;
    epi.r0 = it.r0; epi.rend = it.rend; epi.c0 = it.c0;
    epi.cend = it.c0 + TW < W ? it.c0 + TW : W;
    epi.lane = lane;
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
    if (next < gd.n_items) {
      const Item nx = tc::decode(next, gd);
      stage_x<CI>(xs, x + nx.b * x_img, nx.r0, nx.c0, H, W, tid);
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

template <int CI, int CMP, int CO>
int launch_main(const bf16* x, const bf16* w1, const bf16* w2,
                const float* bn, bf16* y, int B, int H, int W, int cm, int tm,
                int n_sm, cudaStream_t stream) {
  Grid gd;
  if (!tc::make_grid(B, H, W, tm, &gd) || !tc::aligned16(x) ||
      !tc::aligned16(w1) || !tc::aligned16(w2) || !tc::aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (gd.n_items == 0) return (int)cudaSuccess;
  const size_t smem = MainSmem<CI, CMP, CO>::bytes;
  int grid = 0;
  cudaError_t e = tc::persistent_grid(fused_nhwc_main_bf16_kernel<CI, CMP, CO>,
                                      smem, n_sm, gd.n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  fused_nhwc_main_bf16_kernel<CI, CMP, CO><<<grid, NT, smem, stream>>>(
      x, w1, w2, bn, y, cm, H, W, gd);
  return (int)cudaGetLastError();
}

template <int CI, int CMP>
int launch_stats(const bf16* x, const bf16* w1, float* partial, int B, int H,
                 int W, int cm, int tm, int n_sm, cudaStream_t stream) {
  Grid gd;
  if (!tc::make_grid(B, H, W, tm, &gd) || !tc::aligned16(x) ||
      !tc::aligned16(w1))
    return (int)cudaErrorInvalidValue;
  if (gd.n_items == 0) return (int)cudaSuccess;
  const size_t smem = StatsSmem<CI, CMP>::bytes;
  int grid = 0;
  cudaError_t e = tc::persistent_grid(fused_nhwc_stats_bf16_kernel<CI, CMP>,
                                      smem, n_sm, gd.n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  fused_nhwc_stats_bf16_kernel<CI, CMP><<<grid, NT, smem, stream>>>(
      x, w1, partial, cm, H, W, gd);
  return (int)cudaGetLastError();
}

}  // namespace tcb

// The fp32 FMA kernel; see (2) in the header.
namespace fp32fma {

constexpr int NT = 256;  // threads per block
constexpr int R = 8;     // band rows per pass
constexpr int TW = 32;   // band columns per block
constexpr int NC = 8;    // product columns a thread keeps in registers
constexpr int XR = R + 2, XC = TW + 2;  // x window of a pass
constexpr int PR = R + 1, PC = TW + 1;  // plane positions of a pass
constexpr int NPOS = PR * PC;
constexpr int MAXG = 65535;  // images, or bands, per launch: grid z / y limit

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared-memory layout in floats.  Pixel strides are odd so that threads on
// neighbouring pixels hit distinct banks.
struct Layout {
  int np, cop, cip, ps;          // padded widths and pixel strides
  int wt, wc, tab, xs, pl, end;  // offsets
};

__host__ __device__ inline Layout layout(int ci, int cm, int co, bool main) {
  Layout l;
  l.np = round_up(4 * cm, NC);
  l.cop = round_up(co, NC);
  l.cip = ci | 1;
  l.ps = (4 * cm) | 1;
  l.wt = 0;
  l.wc = l.wt + 4 * ci * l.np;
  l.tab = l.wc + (main ? 16 * cm * l.cop : 0);
  l.xs = l.tab + (main ? 3 * l.np : 0);
  l.pl = l.xs + XR * XC * l.cip;
  l.end = l.pl + NPOS * l.ps;
  return l;
}

// acc[q] += a * w[q] for NC = 8 columns; w is 16-byte aligned
__device__ __forceinline__ void fma8(float (&acc)[NC], float a,
                                     const float* __restrict__ w) {
  const float4 w0 = *reinterpret_cast<const float4*>(w);
  const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
  acc[0] = fmaf(a, w0.x, acc[0]);
  acc[1] = fmaf(a, w0.y, acc[1]);
  acc[2] = fmaf(a, w0.z, acc[2]);
  acc[3] = fmaf(a, w0.w, acc[3]);
  acc[4] = fmaf(a, w1.x, acc[4]);
  acc[5] = fmaf(a, w1.y, acc[5]);
  acc[6] = fmaf(a, w1.z, acc[6]);
  acc[7] = fmaf(a, w1.w, acc[7]);
}

// A launch covers images b0 + blockIdx.z and bands band0 + blockIdx.y of
// x (.., H, W, ci); nbands is the image's.
// MAIN: out = y (B, H, W, Co), stats = (3, 4Cm) rows mean, gain, bias, each
//       tiled over the four parities.
// else: out = partial (B, H/tm, gridDim.x, 2, Cm), wcall and stats unused.
template <bool MAIN>
__global__ void __launch_bounds__(NT)
fused_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ wtall,
                  const float* __restrict__ wcall,
                  const float* __restrict__ stats, float* __restrict__ out,
                  int H, int W, int ci, int cm, int co, int tm, int b0,
                  int band0, int nbands) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[2 * NT];

  const Layout l = layout(ci, cm, co, MAIN);
  float* wt = smem + l.wt;
  float* wc = smem + l.wc;
  float* tab = smem + l.tab;
  float* xs = smem + l.xs;
  float* pl = smem + l.pl;

  const int tid = threadIdx.x;
  const int b = b0 + blockIdx.z, band = band0 + blockIdx.y;
  const int j0 = blockIdx.x * TW;   // first column of this block
  const int row0 = band * tm;       // first row of this band
  const int n4 = 4 * cm;

  for (int k = tid; k < 4 * ci * l.np; k += NT) {
    const int r = k / l.np, n = k - r * l.np;
    wt[k] = n < n4 ? wtall[r * n4 + n] : 0.f;
  }
  if (MAIN) {
    for (int k = tid; k < 16 * cm * l.cop; k += NT) {
      const int r = k / l.cop, n = k - r * l.cop;
      wc[k] = n < co ? wcall[r * co + n] : 0.f;
    }
    for (int k = tid; k < 3 * l.np; k += NT) {
      const int r = k / l.np, n = k - r * l.np;
      tab[k] = n < n4 ? stats[r * n4 + n] : 0.f;
    }
  }

  // stats: this thread's column and its share of the positions
  const int nparts = NT / n4;
  const int scol = tid % n4, spart = tid / n4;
  float ssum = 0.f, ssq = 0.f;

  const float* xb = x + (size_t)b * H * W * ci;

  for (int i0 = 0; i0 < tm; i0 += R) {
    // A: x rows row0+i0-1 .. row0+i0+R, columns j0-1 .. j0+TW
    for (int k = tid; k < XR * XC * ci; k += NT) {
      const int pix = k / ci, c = k - pix * ci;
      const int r = pix / XC, q = pix - r * XC;
      const int gr = row0 + i0 - 1 + r, gc = j0 - 1 + q;
      xs[pix * l.cip + c] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                                ? xb[((size_t)gr * W + gc) * ci + c] : 0.f;
    }
    __syncthreads();

    // B: the parity planes of this pass
    const int nchunk = l.np / NC;
    for (int it = tid; it < NPOS * nchunk; it += NT) {
      const int chunk = it / NPOS, pos = it - chunk * NPOS;
      const int i = pos / PC, j = pos - i * PC;
      float acc[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[q] = 0.f;
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const float* xa = xs + ((i + (tt >> 1)) * XC + j + (tt & 1)) * l.cip;
        const float* w = wt + tt * ci * l.np + chunk * NC;
#pragma unroll 4
        for (int c = 0; c < ci; ++c) fma8(acc, xa[c], w + c * l.np);
      }
      const int ig = i0 + i;        // row of the position within the band
      const int jg = j0 + j;        // its column within the image
      int k = (chunk * NC) / cm, cc = (chunk * NC) - k * cm;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int n = chunk * NC + q;
        if (n < n4) {
          const int di = k >> 1, dj = k & 1;
          float v;
          if (MAIN) {
            const int hr = 2 * (row0 + ig) - di, hc = 2 * jg - dj;
            const bool pad = hr < 0 || hr >= 2 * H || hc < 0 || hc >= 2 * W;
            v = (acc[q] - tab[n]) * tab[l.np + n] + tab[2 * l.np + n];
            v = pad ? 0.f : fmaxf(v, 0.f);
          } else {
            // even rows are owned where i < R, odd rows where i >= 1; the
            // same for columns with TW; nothing beyond the band or the image
            const bool own_r = di ? (i >= 1 && ig <= tm) : (i < R && ig < tm);
            const bool own_c = dj ? (j >= 1 && jg <= W) : (j < TW && jg < W);
            v = (own_r && own_c) ? acc[q] : 0.f;
          }
          pl[pos * l.ps + n] = v;
        }
        if (++cc == cm) { cc = 0; ++k; }
      }
    }
    __syncthreads();

    if (MAIN) {
      // C: y[m, n] for the R x TW pixels of this pass
      const int ochunk = l.cop / NC;
      for (int it = tid; it < R * TW * ochunk; it += NT) {
        const int chunk = it / (R * TW), pix = it - chunk * (R * TW);
        const int m = pix / TW, n = pix - m * TW;
        float acc[NC];
#pragma unroll
        for (int q = 0; q < NC; ++q) acc[q] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {   // (parity k, sa, sb)
          const int k = kk >> 2, sa = (kk >> 1) & 1, sb = kk & 1;
          const float* a = pl + ((m + sa) * PC + n + sb) * l.ps + k * cm;
          const float* w = wc + kk * cm * l.cop + chunk * NC;
#pragma unroll 4
          for (int c = 0; c < cm; ++c) fma8(acc, a[c], w + c * l.cop);
        }
        const int gn = j0 + n;
        if (i0 + m < tm && gn < W) {
          float* yp = out + (((size_t)b * H + row0 + i0 + m) * W + gn) * co;
#pragma unroll
          for (int q = 0; q < NC; ++q)
            if (chunk * NC + q < co) yp[chunk * NC + q] = acc[q];
        }
      }
    } else if (spart < nparts) {
      for (int pos = spart; pos < NPOS; pos += nparts) {
        const float v = pl[pos * l.ps + scol];
        ssum += v;
        ssq = fmaf(v, v, ssq);
      }
    }
    // the next pass's A does not touch the planes, and its barrier comes
    // before its B overwrites them
  }

  if (!MAIN) {
    red[tid] = spart < nparts ? ssum : 0.f;
    red[NT + tid] = spart < nparts ? ssq : 0.f;
    __syncthreads();
    if (tid < cm) {
      float s = 0.f, q = 0.f;
      for (int part = 0; part < nparts; ++part)
        for (int k = 0; k < 4; ++k) {
          s += red[part * n4 + k * cm + tid];
          q += red[NT + part * n4 + k * cm + tid];
        }
      const size_t slot = ((size_t)b * nbands + band) * gridDim.x + blockIdx.x;
      out[slot * 2 * cm + tid] = s;
      out[slot * 2 * cm + cm + tid] = q;
    }
  }
}

template <bool MAIN>
int launch(const float* x, const float* wtall, const float* wcall,
           const float* stats, float* out, int B, int H, int W, int ci, int cm,
           int co, int tm, cudaStream_t stream) {
  if (B < 0 || H < 1 || W < 1 || tm < 1 || H % tm != 0 || 4 * cm > NT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)layout(ci, cm, co, MAIN).end;
  cudaError_t e = cudaFuncSetAttribute(
      fused_nhwc_kernel<MAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // more images or bands than a grid dimension takes go in several launches
  const int nbands = H / tm;
  for (int b0 = 0; b0 < B; b0 += MAXG)
    for (int t0 = 0; t0 < nbands; t0 += MAXG) {
      const dim3 grid((W + TW - 1) / TW,
                      nbands - t0 < MAXG ? nbands - t0 : MAXG,
                      B - b0 < MAXG ? B - b0 : MAXG);
      fused_nhwc_kernel<MAIN><<<grid, NT, smem, stream>>>(
          x, wtall, wcall, stats, out, H, W, ci, cm, co, tm, b0, t0, nbands);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  return (int)cudaSuccess;
}

}  // namespace fp32fma

extern "C" {

// ---- the tensor-core kernel -------------------------------------------------

// Work-item geometry: rows of a pass, columns of a chunk.  `partial` holds
// B * (H/tm) * ceil(tm/rows) * ceil(W/cols) * 2 * cm floats.
int fused_nhwc_pass_rows() { return tc::R; }
int fused_nhwc_chunk_cols() { return tc::TW; }

// Channel triples with a compiled tensor-core instantiation.
int fused_nhwc_mma_supported(int ci, int cm, int co) {
  return (ci == 8 && cm == 4 && co == 8) || (ci == 16 && cm == 8 && co == 16) ||
         (ci == 32 && cm == 16 && co == 32);
}

// x (B, H, W, ci) NHWC; w1: W1 (4 ci x 4 Cmp) in fragment order, Cmp =
// max(cm, 8) -> partial.
int fused_nhwc_stats_f32(const float* x, const float* w1, float* partial,
                         int B, int H, int W, int ci, int cm, int tm, int n_sm,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 8 && cm == 4)
    return tc::launch_stats<8, 8>(x, w1, partial, B, H, W, cm, tm, n_sm, s);
  if (ci == 16 && cm == 8)
    return tc::launch_stats<16, 8>(x, w1, partial, B, H, W, cm, tm, n_sm, s);
  if (ci == 32 && cm == 16)
    return tc::launch_stats<32, 16>(x, w1, partial, B, H, W, cm, tm, n_sm, s);
  return (int)cudaErrorInvalidValue;
}

// w2: W2 (16 Cmp x co) in fragment order; bn (3, 4 cm) -> y (B, H, W, co).
int fused_nhwc_main_f32(const float* x, const float* w1, const float* w2,
                        const float* bn, float* y, int B, int H, int W, int ci,
                        int cm, int co, int tm, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!fused_nhwc_mma_supported(ci, cm, co)) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 4: return tc::launch_main<8, 8, 8>(x, w1, w2, bn, y, B, H, W, cm, tm, n_sm, s);
    case 8: return tc::launch_main<16, 8, 16>(x, w1, w2, bn, y, B, H, W, cm, tm, n_sm, s);
    case 16: return tc::launch_main<32, 16, 32>(x, w1, w2, bn, y, B, H, W, cm, tm, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the tensor-core kernel in bf16 ----------------------------------------

// As fused_nhwc_stats_f32 with x (bf16 NHWC) and w1 (bf16, m16n8k16
// fragment order, k permuted by 16s); partial fp32.
int fused_nhwc_stats_bf16(const void* x, const void* w1, float* partial,
                          int B, int H, int W, int ci, int cm, int tm,
                          int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const tcb::bf16* xb = (const tcb::bf16*)x;
  const tcb::bf16* a = (const tcb::bf16*)w1;
  if (ci == 8 && cm == 4)
    return tcb::launch_stats<8, 8>(xb, a, partial, B, H, W, cm, tm, n_sm, s);
  if (ci == 16 && cm == 8)
    return tcb::launch_stats<16, 8>(xb, a, partial, B, H, W, cm, tm, n_sm, s);
  if (ci == 32 && cm == 16)
    return tcb::launch_stats<32, 16>(xb, a, partial, B, H, W, cm, tm, n_sm, s);
  return (int)cudaErrorInvalidValue;
}

// As fused_nhwc_main_f32 with x, w1, w2 and y bf16; bn (3, 4 cm) fp32.
int fused_nhwc_main_bf16(const void* x, const void* w1, const void* w2,
                         const float* bn, void* y, int B, int H, int W, int ci,
                         int cm, int co, int tm, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const tcb::bf16* xb = (const tcb::bf16*)x;
  const tcb::bf16* a = (const tcb::bf16*)w1;
  const tcb::bf16* b = (const tcb::bf16*)w2;
  tcb::bf16* yb = (tcb::bf16*)y;
  if (!fused_nhwc_mma_supported(ci, cm, co)) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 4: return tcb::launch_main<8, 8, 8>(xb, a, b, bn, yb, B, H, W, cm, tm, n_sm, s);
    case 8: return tcb::launch_main<16, 8, 16>(xb, a, b, bn, yb, B, H, W, cm, tm, n_sm, s);
    case 16: return tcb::launch_main<32, 16, 32>(xb, a, b, bn, yb, B, H, W, cm, tm, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the fp32 FMA kernel ----------------------------------------------------

// Columns per block; `partial` holds B * (H/tm) * ceil(W/chunk) * 2 * cm floats.
int fused_nhwc_chunk() { return fp32fma::TW; }

// Dynamic shared memory of the main launch (the larger of the two).
size_t fused_nhwc_smem_bytes(int ci, int cm, int co) {
  return sizeof(float) * (size_t)fp32fma::layout(ci, cm, co, true).end;
}

// x (B, H, W, ci) NHWC, wtall (4ci, 4cm) -> partial
int fused_nhwc_stats_fma_f32(const float* x, const float* wtall,
                             float* partial, int B, int H, int W, int ci,
                             int cm, int tm, void* stream) {
  return fp32fma::launch<false>(x, wtall, nullptr, nullptr, partial, B, H, W,
                                ci, cm, 0, tm, (cudaStream_t)stream);
}

// x as above, wcall (16cm, co), stats (3, 4cm) -> y (B, H, W, co) NHWC
int fused_nhwc_main_fma_f32(const float* x, const float* wtall,
                            const float* wcall, const float* stats, float* y,
                            int B, int H, int W, int ci, int cm, int co,
                            int tm, void* stream) {
  return fp32fma::launch<true>(x, wtall, wcall, stats, y, B, H, W, ci, cm, co,
                               tm, (cudaStream_t)stream);
}

}  // extern "C"
