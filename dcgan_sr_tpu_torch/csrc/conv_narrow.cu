// A stride-1, "same"-padded convolution with few output channels, in bf16
// with fp32 sums, on Hopper (sm_90a): SRGAN's 9x9 64->3 tail conv.
//
// Replaces no Pallas kernel.  The JAX package leaves every convolution to
// XLA; the port leaves them to cuDNN, whose implicit GEMMs tile the output
// channels 32 wide, so at Cout = 3 they run at 2% of the tensor cores' rate
// and wrap the NCHW map in two layout transposes (27.6 ms for SRGAN's tail
// at x (16, 64, 1024, 1024)).
//
// Bound on an H100, at that shape: 2 * 16 * 1024^2 * 3 * 64 * 81 = 522 GFLOP
// (0.53 ms at 989 TFLOP/s) against 2.15 GB of x read once and 0.10 GB of y
// written (0.67 ms at 3.35 TB/s): bytes, barely.  The design:
//
//   - The horizontal taps fold into the product's columns.  For an output
//     row oy and input column j, P[j, (co, dx)] = sum over (dy, ci) of
//     x[ci, oy + dy - r, j] * w[co, ci, dy, dx]; then y[co, oy, ox] = bias +
//     sum over dx of P[ox + dx - r, (co, dx)].  M = 64 input columns (56
//     outputs), N = Cout * k rounded up to the wgmma width (27 -> 32 for
//     SRGAN), K = k * Cin.  Tensor work is 64/56 x 32/27 of the useful work
//     (8/3 for a direct implicit GEMM with N = 8 output channels), and x is
//     never shifted: every fragment of x starts on a 16-byte boundary.
//   - One warpgroup an output row: wgmma.mma_async m64nNk16, A (x) from
//     registers, loaded by ldmatrix.trans straight from x's NCHW order in
//     shared memory (a strip's row of one channel: 64 columns, 128 bytes,
//     its 16-byte chunk c at c ^ (channel & 7), which puts the eight channel
//     rows of one ldmatrix on distinct banks), B (the packed weights) from
//     shared memory by descriptor.  No layout change of x happens anywhere.
//     A tap row's Cin / 16 wgmmas share one wgmma.fence and one group (a
//     fence between two k-steps waits out the first: 5.1 ms against 3.3 at
//     SRGAN's tail), and the next tap row's ldmatrix runs while they do.
//   - A block owns a strip of 56 output columns, 56 s - 4 .. 56 s + 51 (64
//     input columns from 56 s - 8, a 16-byte boundary of every row: a
//     4-column halo each side, whatever k) and a run of rows.  Its R
//     warpgroups each take one output row of a step of R rows; x's rows
//     stream through a ring of k - 1 + 3R rows in shared memory, so each
//     input row of the strip is read once from device memory: the next two
//     steps' rows arrive by cp.async (16 bytes, past L1, zero-filled outside
//     the image) while this step computes.  The weights (packed on the host
//     as wgmma's K-major core matrices) are read once a block.
//   - Epilogue: each warpgroup writes P's Cout * k columns to its own fp32
//     tile in shared memory, P[n][j] at a 68-float pitch (conflict-free both
//     ways), then each thread sums an output's k partial sums in a fixed
//     order, adds the bias in fp32 and rounds once to bf16.  No atomics
//     anywhere: the same input gives the same bits on every run.
//
// The library path rounds twice (cuDNN's output to bf16, then the bias add
// in bf16); this is the same function of the same bf16 operands with one
// rounding fewer.
//
// Shapes.  Cin a multiple of 16 up to 64, Cout * k up to 80 (wgmma widths
// 16, 32, 48 and 80), k odd up to 9, any N, H, W.  x with W % 8 == 0 and a
// 16-byte aligned base is read by 16-byte copies, any other x by plain
// 2-byte loads (the same arithmetic).  The host (ops/conv_narrow.py plan) picks R, the rows a
// block and the shared memory, and packs the weights.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/
// conv_narrow.py).  The entry returns the cudaError_t of its launch (0 =
// launched), or cudaErrorInvalidValue for arguments it does not take.
// Nothing here synchronises or allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUT_W = 56;   // output columns of a strip
constexpr int M = 64;       // input columns of a strip: wgmma's M
constexpr int XP = 64;      // bf16 of a strip's channel row in smem (128 B)
constexpr int HALO = 4;     // input columns left of the strip's first output
constexpr int PPX = 68;     // floats in a row of a warpgroup's P tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// 16 bytes global -> shared, not through L1; `bytes` 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_2() {
  asm volatile("cp.async.wait_group 2;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
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
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// The accumulators in registers here (wgmma writes them asynchronously).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a kept in its registers up to here: wgmma reads them asynchronously until
// its group has completed.
template <int KS>
__device__ __forceinline__ void keep_a(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[ks][e])::"memory");
}

// d (m64 x N, fp32) += a (m64 x k16, bf16, registers) * B (k16 x N, bf16,
// shared memory at descriptor b).  Thread (warp w of the warpgroup, lane
// g * 4 + q) holds rows 16w + g (+8) of A and D, as mma.m16n8k16 does for
// its warp: d[4i + e] is row 16w + g + 8 (e / 2), column 8i + 2q + e % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void run(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void run(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// x (N, CK * 16, H, W) bf16; wpk (k * CK, 2, NW, 8) bf16, the packed weights
// ([dy * CK + kc][h][co * k + dx][e] = w[co, 16 kc + 8 h + e, dy, dx]); bias
// (Cout,) fp32 or null; y (N, Cout, H, W) bf16.  Grid (ceil((W + 4) / 56),
// ceil(H / rb), N), strip s's outputs at columns 56 s - 4 ..; blockDim.x =
// 128 R: R warpgroups, R output rows in flight.  vec: 16-byte copies of x,
// else plain loads.
template <int CK, int NW>
__global__ void __launch_bounds__(512, 1)
    conv_narrow_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wpk,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int H, int W, int cout,
                       int k, int rb, bool vec) {
  constexpr int CIN = CK * 16;
  constexpr int ROW = CIN * XP;          // bf16 in a ring row
  constexpr int KSTEP = 2 * NW * 8;      // bf16 of B a k-step
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, R = nthreads >> 7;
  const int wg = warp >> 2, wl = warp & 3;
  const int r = k >> 1, ring = k - 1 + 3 * R, ksteps = k * CK;
  const int n_rows = cout * k;
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* ws = xs + ring * ROW;
  auto* ps = reinterpret_cast<float*>(ws + ksteps * KSTEP);
  // the strip's first output column; its input columns start 4 before,
  // on a 16-byte boundary of each row of x (x0 = 56 s - 4)
  const int x0 = blockIdx.x * OUT_W - HALO;
  const int y0 = blockIdx.y * rb;
  const int y1 = min(y0 + rb, H);
  const __nv_bfloat16* xn = x + (size_t)blockIdx.z * CIN * H * W;

  // Input row iy (any integer >= -r) of the strip into its ring slot: the
  // 16-byte chunk c of channel ci's row at chunk c ^ (ci & 7).
  auto load_row = [&](int iy) {
    __nv_bfloat16* dst = xs + ((iy + r) % ring) * ROW;
    const bool row_in = iy >= 0 && iy < H;
    if (vec) {
      for (int i = tid; i < CIN * (M / 8); i += nthreads) {
        const int ci = i / (M / 8), v = i - ci * (M / 8);
        const int col = x0 - HALO + 8 * v;
        const bool in = row_in && col >= 0 && col < W;
        const void* src = in ? xn + ((size_t)ci * H + iy) * W + col : x;
        cp_async16(smem_u32(dst + ci * XP + 8 * (v ^ (ci & 7))), src,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < CIN * M; i += nthreads) {
        const int ci = i / M, j = i - ci * M;
        const int col = x0 - HALO + j;
        dst[ci * XP + 8 * ((j >> 3) ^ (ci & 7)) + (j & 7)] =
            row_in && col >= 0 && col < W ? xn[((size_t)ci * H + iy) * W + col]
                                          : __float2bfloat16_rn(0.f);
      }
    }
  };

  {
    const int wbytes = ksteps * KSTEP * 2;
    const char* src = reinterpret_cast<const char*>(wpk);
    for (int i = tid * 16; i < wbytes; i += nthreads * 16)
      cp_async16(smem_u32(ws) + i, src + i);
  }
  for (int iy = y0 - r; iy < y0 + R + r; ++iy) load_row(iy);
  cp_async_commit();
  if (y0 + R < y1)
    for (int i = 0; i < R; ++i) load_row(y0 + R + r + i);
  cp_async_commit();

  // This lane's ldmatrix row: channel (lane & 7) + 8 (lane >> 4), column
  // 16 wl + 8 ((lane >> 3) & 1): a0..a3 are A's (rows 0-7, k 0-7), (rows
  // 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) of this warp.
  // The eight rows of one matrix meet eight distinct chunks.
  const uint32_t xs_u = smem_u32(xs), ws_u = smem_u32(ws);
  const uint32_t a_off =
      ((lane & 7) + (lane >> 4) * 8) * XP * 2 +
      (((2 * wl + ((lane >> 3) & 1)) ^ (lane & 7)) * 16);
  const int g = lane >> 2, q = lane & 3;
  float* pw = ps + wg * n_rows * PPX;

  for (int row0 = y0; row0 < y1; row0 += R) {
    // two steps ahead: the ring holds this step's rows and the next two
    // steps' new ones
    if (row0 + 2 * R < y1)
      for (int i = 0; i < R; ++i) load_row(row0 + 2 * R + r + i);
    cp_async_commit();
    cp_async_wait_2();
    // the weights reach wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    const int oy = row0 + wg;
    if (oy < y1) {
      float d[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) d[i] = 0.f;
      // A of tap row dy: its CK k-steps' fragments
      auto load_a = [&](int dy, uint32_t (&a)[CK][4]) {
        const uint32_t row = xs_u + ((oy + dy) % ring) * ROW * 2 + a_off;
#pragma unroll
        for (int kc = 0; kc < CK; ++kc)
          ldsm_x4_t(a[kc], row + kc * 16 * XP * 2);
      };
      // tap row dy's CK wgmmas, one group behind one fence (a fence a
      // k-step would wait out each wgmma before the next)
      auto product = [&](int dy, uint32_t (&a)[CK][4]) {
        fence_acc(d);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < CK; ++kc)
          Wgmma<NW>::run(d, a[kc],
                         desc(ws_u + (dy * CK + kc) * KSTEP * 2, NW * 16, 128));
        wg_commit();
      };
      // two tap rows' A in turn: row dy + 1's ldmatrix runs while row dy's
      // wgmmas do, once row dy - 1's, the last reader of its registers, have
      // completed
      uint32_t a0[CK][4], a1[CK][4];
      load_a(0, a0);
      for (int dy = 0; dy < k; dy += 2) {
        product(dy, a0);
        if (dy + 1 >= k) break;
        wg_wait1();
        keep_a(a1);
        load_a(dy + 1, a1);
        product(dy + 1, a1);
        if (dy + 2 < k) {
          wg_wait1();
          keep_a(a0);
          load_a(dy + 2, a0);
        }
      }
      wg_wait0();
      keep_a(a0);
      keep_a(a1);
      fence_acc(d);

      // P[n][j] of this warpgroup's row
#pragma unroll
      for (int i = 0; i < NW / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 8 * i + 2 * q + (e & 1);
          if (n < n_rows)
            pw[n * PPX + 16 * wl + g + 8 * (e >> 1)] = d[4 * i + e];
        }
      }
      named_sync(1 + wg, 128);

      // y[co, oy, x0 + o] = bias[co] + sum over dx of P[co * k + dx][o + dx
      // + HALO - r], the taps in order, one rounding
      const int off = HALO - r, t128 = tid & 127;
      for (int e = t128; e < cout * OUT_W; e += 128) {
        const int co = e / OUT_W, o = e - co * OUT_W, ox = x0 + o;
        if (ox >= 0 && ox < W) {
          const float* pr = pw + co * k * PPX + o + off;
          float s = pr[0];
          for (int dx = 1; dx < k; ++dx) s += pr[dx * (PPX + 1)];
          if (bias != nullptr) s += bias[co];
          y[(((size_t)blockIdx.z * cout + co) * H + oy) * W + ox] =
              __float2bfloat16_rn(s);
        }
      }
    }
    __syncthreads();
  }
}

template <int CK, int NW>
cudaError_t launch(const void* x, const void* wpk, const void* bias, void* y,
                   long long N, long long H, long long W, long long cout,
                   long long k, long long R, long long rb, long long smem,
                   cudaStream_t st) {
  auto kern = conv_narrow_kernel<CK, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies where every row of x is 16-byte aligned, else plain loads
  const bool vec = ((uintptr_t)x & 15) == 0 && W % 8 == 0;
  const dim3 grid((unsigned)((W + HALO + OUT_W - 1) / OUT_W),
                  (unsigned)((H + rb - 1) / rb), (unsigned)N);
  kern<<<grid, (unsigned)(128 * R), (size_t)smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wpk), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), (int)H, (int)W, (int)cout, (int)k,
      (int)rb, vec);
  return cudaGetLastError();
}

template <int CK>
cudaError_t launch_n(long long nw, const void* x, const void* wpk,
                     const void* bias, void* y, long long N, long long H,
                     long long W, long long cout, long long k, long long R,
                     long long rb, long long smem, cudaStream_t st) {
  switch (nw) {
    case 16:
      return launch<CK, 16>(x, wpk, bias, y, N, H, W, cout, k, R, rb, smem, st);
    case 32:
      return launch<CK, 32>(x, wpk, bias, y, N, H, W, cout, k, R, rb, smem, st);
    case 48:
      return launch<CK, 48>(x, wpk, bias, y, N, H, W, cout, k, R, rb, smem, st);
    case 80:
      return launch<CK, 80>(x, wpk, bias, y, N, H, W, cout, k, R, rb, smem, st);
  }
  return cudaErrorInvalidValue;
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

// Shared memory a block may use on `device` (opt-in), in bytes.
long long conv_narrow_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// y = conv(x, w) + bias, stride 1, padding k / 2.  x (N, Cin, H, W) and y
// (N, Cout, H, W) bf16, contiguous; wpk the packed weights (k * Cin / 16, 2,
// nw, 8) bf16 with nw in {16, 32, 48, 80} covering Cout * k; bias (Cout,)
// fp32 or null.  R warpgroups a block, rb rows a block (a multiple of R),
// smem bytes of shared memory: as ops/conv_narrow.py plan computes them.
int conv_narrow_bf16(const void* x, const void* wpk, const void* bias, void* y,
                     long long N, long long cin, long long H, long long W,
                     long long cout, long long k, long long nw, long long R,
                     long long rb, long long smem, int device, void* stream) {
  if (N < 1 || H < 1 || W < 1 || cin < 16 || cin > 64 || cin % 16 ||
      cout < 1 || k < 1 || k > 9 || k % 2 == 0 || cout * k > nw || R < 1 ||
      R > 4 || rb < 1 || rb % R || N > 65535 || (H + rb - 1) / rb > 65535 ||
      N * cin * H * W >= (1LL << 62) || H >= (1LL << 31) ||
      W >= (1LL << 31) || smem < 1)
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  if (smem > conv_narrow_smem_limit(device))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cin / 16) {
    case 1:
      return (int)launch_n<1>(nw, x, wpk, bias, y, N, H, W, cout, k, R, rb,
                              smem, st);
    case 2:
      return (int)launch_n<2>(nw, x, wpk, bias, y, N, H, W, cout, k, R, rb,
                              smem, st);
    case 3:
      return (int)launch_n<3>(nw, x, wpk, bias, y, N, H, W, cout, k, R, rb,
                              smem, st);
    case 4:
      return (int)launch_n<4>(nw, x, wpk, bias, y, N, H, W, cout, k, R, rb,
                              smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
