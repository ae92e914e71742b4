// A 3x3 stride-1 "same" convolution of a 64-channel map, in bf16 with fp32
// sums, on Hopper (sm_90a): SRGAN's 33 LR convs (64 -> 64) and its two
// upsampling convs (64 -> 256), with their bias.
//
// Replaces no Pallas kernel.  The JAX package leaves every convolution to
// XLA; the port leaves them to cuDNN, whose NHWC implicit GEMMs wrap the
// NCHW map in two layout transposes and leave the bias to a broadcast add
// in PyTorch's strided loop: at x (16, 64, 256, 256) -> 64 the product is
// 0.17 ms of a 0.73 ms call.
//
// Bound on an H100, at that shape: 2 * 16 * 256^2 * 64 * 64 * 9 = 77.3
// GFLOP (0.078 ms at 989 TFLOP/s) against 134 MB of x read once and 134 MB
// of y written (0.080 ms at 3.35 TB/s): both, about equally.  At -> 256
// the operations bound: 309 GFLOP (0.31 ms) at 256x256, 1.237 TFLOP (1.25
// ms) at 512x512.  The design:
//
//   - One product a row: Y[co, px] (64 output channels x 128 output
//     columns of one output row) = sum over 36 k16 steps (tap dy, tap dx,
//     16 input channels) of W[co, k] X[k, px].  wgmma.mma_async
//     m64n128k16, both operands in shared memory: A the packed weights
//     (K-major core matrices, all 36 steps of a 64-channel output tile
//     resident, 72 KB), B a transposed input row, xq[cg][pos][8 channels]:
//     a position's 8 channels are 16 contiguous bytes, so B is K-major too,
//     and the horizontal tap dx moves B's start by dx positions, 16 bytes
//     each.  No copy of x is shifted and the tensor cores do only the
//     convolution's own work.
//   - x arrives by TMA: one 4-D tensor map over NCHW x, one box of 152
//     columns x 1 row x 64 channels an input row (from column c0 - 8, a
//     16-byte boundary: the innermost box coordinate is a multiple of 8
//     columns; a channel row is 304 bytes, so the eight channel rows of one
//     ldmatrix meet eight distinct bank groups).  The hardware zero-fills
//     the padding and everything outside the image.  Two boxes in flight.
//   - Two transposer warps turn each box into xq (ldmatrix.trans reads 8
//     channels x 8 columns, stmatrix writes 8 positions x 8 channels) in a
//     ring of six input rows; each input row of a strip is read from device
//     memory once for the rows it feeds.
//   - Two consumer warpgroups take the output rows in turn, so one's
//     epilogue runs under the other's product.  An output row waits on the
//     ring's three rows it reads (mbarriers) and, once its 36 wgmmas have
//     completed, releases each input row of which it is the last reader on
//     its warpgroup: every ring row takes two such releases a use.
//   - Epilogue: the bias added in fp32 to the fp32 sums, one rounding to
//     bf16, y written in NCHW straight from the accumulators (two adjacent
//     columns a 4-byte store).  No atomics: the same input gives the same
//     bits on every run.
//   - Work: the rows of all (image, strip of 128 columns) pairs, in order,
//     cut into one run of consecutive rows a block; Cout 256 runs as four
//     64-channel tiles, the tile the block index modulo 4, so the four
//     blocks that read the same input rows run side by side and three of
//     the four reads of each row come from L2.  One block an SM (223,360
//     bytes of shared memory), the weights loaded once a block.
//
// The library path rounds twice (cuDNN's output to bf16, then the bias add
// in bf16); this is the same function of the same bf16 operands with one
// rounding fewer.
//
// Shapes: Cin 64, Cout a multiple of 64 (the rule sends 64 and 256), any
// N, H, W.  x with W % 8 == 0 and a 16-byte aligned base is read by TMA;
// any other x is gathered by the transposer warps with plain loads (the
// same arithmetic).  The host (ops/conv3x3.py plan) cuts the rows and
// packs the weights.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/
// conv3x3.py).  The entry returns the cudaError_t of its launch (0 =
// launched), cudaErrorInvalidValue for arguments it does not take, or a
// negative value when the tensor map could not be encoded (-1 - CUresult,
// or -1000 when cuTensorMapEncodeTiled cannot be found).  Nothing here
// synchronises or allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CIN = 64;            // input channels
constexpr int CG = CIN / 8;        // channel groups of 16 bytes
constexpr int SW = 128;            // output columns of a strip: wgmma's N
constexpr int MT = 64;             // output channels of a tile: wgmma's M
constexpr int KS = 9 * CIN / 16;   // k16 steps of a product: 36
constexpr int XPOS = SW + 16;      // xq positions: columns c0-8 .. c0+SW+7
constexpr int BOXW = XPOS + 8;     // box columns: a 304-byte channel row
constexpr int RING = 6;            // input rows in xq form
constexpr int STAGES = 2;          // boxes in flight
constexpr int NT = 2;              // transposer warps
constexpr int NTHREADS = 256 + 32 * NT;
constexpr uint32_t RELEASES = 2 * 4;   // two readers' releases, 4 warps each

constexpr uint32_t W_BYTES = KS * 2 * MT * 16;      // 73,728
constexpr uint32_t ROW_BYTES = CG * XPOS * 16;      // 18,432
constexpr uint32_t PLANE = XPOS * 16;               // one channel group
constexpr uint32_t BOX_BYTES = CIN * BOXW * 2;      // 19,456
constexpr uint32_t O_RING = W_BYTES;
constexpr uint32_t O_BOX = O_RING + RING * ROW_BYTES;
constexpr uint32_t O_BAR = O_BOX + STAGES * BOX_BYTES;
constexpr uint32_t SMEM = O_BAR + 8 * (2 * STAGES + 2 * RING);
static_assert(O_RING % 128 == 0 && O_BOX % 128 == 0 && BOX_BYTES % 128 == 0,
              "TMA and wgmma operands on 128-byte boundaries");
static_assert((BOXW * 2) % 128 == 48, "channel rows on distinct bank groups");
static_assert(SMEM <= 232448, "one block an SM");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, P1;\n}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` of `bar` has completed.  A wait
// that has not completed after about 2^34 cycles (seconds) traps, so a
// fault in the rings ends the launch with an error instead of hanging the
// card.
constexpr long long kWaitLimit = 1LL << 34;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity))
    if (clock64() - t0 > kWaitLimit) __trap();
}

// Box (column c, row r, channel 0, image n) of the 4-D map into dst,
// completing on bar.
__device__ __forceinline__ void tma_load_row(void* dst, const CUtensorMap* map,
                                             uint64_t* bar, int c, int r,
                                             int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c), "r"(r), "r"(0), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
          addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between core matrices adjacent in K), stride byte offset (between
// core matrices adjacent in M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// The accumulators in registers here (wgmma writes them asynchronously).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n128, fp32) += A (m64 x k16) * B (k16 x n128), both bf16 in
// shared memory at descriptors a and b.  Thread (warp w of the warpgroup,
// lane g * 4 + q) holds d[4i + e] = row 16w + g + 8 (e / 2), column 8i +
// 2q + e % 2.
#define ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(a), "l"(b), "r"(1));
}
#undef ACC8

// ---- the rows of a block -------------------------------------------------------

// A block computes the flattened rows [r0, r1) of (image, strip, output row),
// row fastest.  Its input stream is, for each (image, strip) segment of
// those rows with output rows oy_a .. oy_b, the input rows oy_a - 1 ..
// oy_b + 1 in order: stream index s of output row r's tap row dy is
// (r - r0) + 2 (segment of r - segment of r0) + dy.
struct Rows {
  long long r0, r1;
  int H, strips;
  long long seg0, first;   // r0's segment; output rows of that segment here

  __device__ Rows(long long a, long long b, int h, int s)
      : r0(a), r1(b), H(h), strips(s), seg0(a / h) {
    first = min(r1, (seg0 + 1) * H) - r0;
  }
  // input rows in the stream
  __device__ long long stream_len() const {
    return (r1 - r0) + 2 * ((r1 - 1) / H - seg0 + 1);
  }
  // the segment and input row of stream index s
  __device__ void source(long long s, long long& seg, int& iy) const {
    if (s < first + 2) {
      seg = seg0;
      iy = (int)(r0 - seg0 * H - 1 + s);
    } else {
      const long long t = s - (first + 2);
      seg = seg0 + 1 + t / (H + 2);
      iy = (int)(t % (H + 2)) - 1;
    }
  }
};

// ---- the kernel ----------------------------------------------------------------

// x (N, 64, H, W) bf16 (through xmap when tma, else by plain loads); wpk
// (Cout / 64, 36, 2, 64, 8) bf16, the packed weights ([t][ks][kh][m][e] =
// w[64 t + m, 16 kc + 8 kh + e, dy, dx], ks = (3 dy + dx) * 4 + kc); bias
// (Cout,) fp32 or null; y (N, Cout, H, W) bf16.  Grid: tiles x groups
// blocks, block b computing output tile b % tiles over the rows [(b /
// tiles) * rpb, + rpb) of the N * strips * H flattened rows.
__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __nv_bfloat16* __restrict__ x,
                   const uint4* __restrict__ wpk,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, int H, int W, int cout,
                   int strips, long long total, long long rpb, int tiles,
                   bool tma) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* box_full = reinterpret_cast<uint64_t*>(smem + O_BAR);
  uint64_t* box_empty = box_full + STAGES;
  uint64_t* row_full = box_empty + STAGES;
  uint64_t* row_empty = row_full + RING;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int tile = blockIdx.x % tiles;
  const long long r0 = (long long)(blockIdx.x / tiles) * rpb;
  const long long r1 = min(r0 + rpb, total);
  const Rows rows(r0, r1, H, strips);

  {
    const uint4* src = wpk + (size_t)tile * (W_BYTES / 16);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < (int)(W_BYTES / 16); i += NTHREADS) dst[i] = src[i];
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&box_full[s], 1);
      mbar_init(&box_empty[s], NT);
    }
    for (int s = 0; s < RING; ++s) {
      mbar_init(&row_full[s], NT);
      mbar_init(&row_empty[s], RELEASES);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the weights reach wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (warp >= 8) {
    // ---- the transposer warps -------------------------------------------------
    const int pw = warp - 8;
    const long long len = rows.stream_len();
    const bool issuer = tma && pw == 0 && lane == 0;
    auto issue = [&](long long s) {
      long long seg;
      int iy;
      rows.source(s, seg, iy);
      const int st = (int)(s % STAGES);
      mbar_expect_tx(&box_full[st], BOX_BYTES);
      tma_load_row(smem + O_BOX + st * BOX_BYTES, &xmap, &box_full[st],
                   (int)(seg % strips) * SW - 8, iy, (int)(seg / strips));
    };
    if (issuer)
      for (long long s = 0; s < STAGES && s < len; ++s) issue(s);
    const int rr = lane & 7;
    for (long long s = 0; s < len; ++s) {
      __syncwarp();
      const int slot = (int)(s % RING);
      const uint32_t use = (uint32_t)(s / RING);
      if (use > 0) mbar_wait(&row_empty[slot], (use - 1) & 1);
      const uint32_t ring_s = smem_u32(smem + O_RING + slot * ROW_BYTES);
      if (tma) {
        const int st = (int)(s % STAGES);
        const uint32_t par = (uint32_t)(s / STAGES) & 1;
        mbar_wait(&box_full[st], par);
        const uint32_t box_s = smem_u32(smem + O_BOX + st * BOX_BYTES);
        // 8 channel groups x 18 column blocks of 8x8, four a unit
#pragma unroll 3
        for (int u = pw; u < CG * (XPOS / 8) / 4; u += NT) {
          const int blk = u * 4 + (lane >> 3);
          const int cg = blk / (XPOS / 8), cb = blk - cg * (XPOS / 8);
          uint32_t v[4];
          ldsm_x4_t(v, box_s + ((cg * 8 + rr) * BOXW + cb * 8) * 2);
          stsm_x4(ring_s + cg * PLANE + (cb * 8 + rr) * 16, v);
        }
        // xq is read by wgmma, through the async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&box_empty[st]);
          mbar_arrive(&row_full[slot]);
        }
        if (issuer && s + STAGES < len) {
          mbar_wait(&box_empty[st], par);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue(s + STAGES);
        }
      } else {
        long long seg;
        int iy;
        rows.source(s, seg, iy);
        const int c0 = (int)(seg % strips) * SW - 8;
        const bool row_in = iy >= 0 && iy < H;
        const __nv_bfloat16* xn =
            x + ((size_t)(seg / strips) * CIN * H + (row_in ? iy : 0)) * W;
        for (int i = pw * 32 + lane; i < CG * XPOS; i += NT * 32) {
          const int cg = i / XPOS, p = i - cg * XPOS, col = c0 + p;
          const bool in = row_in && col >= 0 && col < W;
          __align__(16) __nv_bfloat16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = in ? xn[(size_t)(cg * 8 + e) * H * W + col]
                      : __float2bfloat16_rn(0.f);
          *reinterpret_cast<uint4*>(smem + O_RING + slot * ROW_BYTES +
                                    cg * PLANE + p * 16) =
              *reinterpret_cast<const uint4*>(v);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&row_full[slot]);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: output rows r0 + wg, r0 + wg + 2, ... ---------
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, q = lane & 3;
  const uint32_t w_s = smem_u32(smem), ring_s = smem_u32(smem + O_RING);
  const int co0 = tile * MT + 16 * wl + g;
  const float b0 = bias != nullptr ? bias[co0] : 0.f;
  const float b1 = bias != nullptr ? bias[co0 + 8] : 0.f;
  const bool pairs = (W & 1) == 0;
  for (long long r = r0 + wg; r < r1; r += 2) {
    const long long seg = r / H;
    const long long s0 = (r - r0) + 2 * (seg - rows.seg0);
    const int oy = (int)(r - seg * H);
    uint32_t slot[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const long long s = s0 + dy;
      slot[dy] = ring_s + (uint32_t)(s % RING) * ROW_BYTES;
      mbar_wait(&row_full[s % RING], (uint32_t)(s / RING) & 1);
    }
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_acc(d);
    wg_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int ks = (dy * 3 + dx) * 4 + kc;
          wgmma_128(d, desc(w_s + ks * 2 * MT * 16, MT * 16, 128),
                    desc(slot[dy] + 2 * kc * PLANE + (dx + 7) * 16, PLANE,
                         128));
        }
    wg_commit();
    wg_wait0();
    fence_acc(d);

    // Release the input rows of which this row is the last reader on its
    // warpgroup (local output row j of a segment of L rows reads local
    // input rows j - 1 .. j + 1): j - 1 and j always, j + 1 when j >= L - 1,
    // and once more where a row has one reader (the first and last input
    // rows of a segment, and row 1 of a one-row segment).
    __syncwarp();
    if (lane == 0) {
      const long long a = max(r0, seg * H), bnd = min(r1, (seg + 1) * H);
      const long long j = r - a + 1, L = bnd - a;
      const int n_rel[3] = {1 + (j == 1), 1 + (L == 1),
                            (j >= L - 1) + (j == L)};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
        for (int k = 0; k < n_rel[dy]; ++k)
          mbar_arrive(&row_empty[(s0 + dy) % RING]);
    }

    // y[co, oy, c0 + px] = bias[co] + d, one rounding
    const int n = (int)(seg / strips), c0 = (int)(seg % strips) * SW;
    __nv_bfloat16* y0 =
        y + (((size_t)n * cout + co0) * H + oy) * W + c0;
    __nv_bfloat16* y1 = y0 + (size_t)8 * H * W;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int px = 8 * i + 2 * q;
      if (c0 + px + 1 < W && pairs) {
        *reinterpret_cast<__nv_bfloat162*>(y0 + px) =
            __floats2bfloat162_rn(d[4 * i] + b0, d[4 * i + 1] + b0);
        *reinterpret_cast<__nv_bfloat162*>(y1 + px) =
            __floats2bfloat162_rn(d[4 * i + 2] + b1, d[4 * i + 3] + b1);
      } else {
        if (c0 + px < W) {
          y0[px] = __float2bfloat16_rn(d[4 * i] + b0);
          y1[px] = __float2bfloat16_rn(d[4 * i + 2] + b1);
        }
        if (c0 + px + 1 < W) {
          y0[px + 1] = __float2bfloat16_rn(d[4 * i + 1] + b0);
          y1[px + 1] = __float2bfloat16_rn(d[4 * i + 3] + b1);
        }
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kNoEntryPoint = -1000;

// cuTensorMapEncodeTiled of libcuda, found once through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map over x (N, 64, H, W) bf16, innermost first: box BOXW x 1 x
// 64 x 1; out-of-image elements read as zero.  Returns 0 or a negative
// code.
int encode_x(CUtensorMap* map, const void* x, long long N, long long H,
             long long W) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEntryPoint;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)CIN,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                 (cuuint64_t)CIN * H * W * 2};
  const cuuint32_t box[4] = {BOXW, 1, CIN, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(x), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1 - (int)r;
}

struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int device) {
    int cur = device;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// y = conv(x, w) + bias, stride 1, padding 1.  x (N, 64, H, W) and y (N,
// Cout, H, W) bf16, contiguous; wpk the packed weights (Cout / 64, 36, 2,
// 64, 8) bf16; bias (Cout,) fp32 or null.  strips = ceil(W / 128); rpb
// flattened rows a block and groups blocks a tile, as ops/conv3x3.py plan
// computes them.
int conv3x3_bf16(const void* x, const void* wpk, const void* bias, void* y,
                 long long N, long long H, long long W, long long cout,
                 long long strips, long long rpb, long long groups, int device,
                 void* stream) {
  const long long total = N * strips * H;
  if (N < 1 || H < 1 || W < 1 || cout < MT || cout % MT ||
      strips != (W + SW - 1) / SW || rpb < 1 || groups < 1 ||
      (groups - 1) * rpb >= total || groups * rpb < total ||
      groups * (cout / MT) > 0x7fffffffLL || N > 0x7fffffffLL ||
      H >= (1LL << 30) || W >= (1LL << 30) ||
      N * cout * H * W >= (1LL << 62) || (((uintptr_t)wpk) & 15))
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  // TMA where every row of x is 16-byte aligned, else plain loads
  const bool tma = W % 8 == 0 && ((uintptr_t)x & 15) == 0;
  CUtensorMap map = {};
  if (tma) {
    const int e = encode_x(&map, x, N, H, W);
    if (e != 0) return e;
  }
  // the shared memory opt-in, once a card
  static bool opted[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  if (!opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    opted[device] = true;
  }
  const int tiles = (int)(cout / MT);
  conv3x3_kernel<<<(unsigned)(groups * tiles), NTHREADS, SMEM,
                   (cudaStream_t)stream>>>(
      map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint4*>(wpk), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), (int)H, (int)W, (int)cout, (int)strips,
      total, rpb, tiles, tma);
  return (int)cudaGetLastError();
}

}  // extern "C"
