// Fused convT(k4s2p1) + BatchNorm + ReLU + conv(k4s2p1) in bf16 (namespace
// wg, this header) and in fp32 (namespace wgf, its own header further
// down), built on Hopper's own units (sm_90a): TMA under mbarrier rings,
// wgmma.mma_async, ldmatrix/stmatrix.
//
// Replaces the TPU kernel dcgan_sr_tpu/ops/pallas_bulge.py fused_bulge_fwd
// with bf16 x (_stats_kernel :159, _main_kernel :206): the generators'
// layers 3-4, y = conv(relu(bn(convT(x)))), without writing the
// 2x-resolution hidden tensor h to device memory.  It computes what the
// mma.sync kernel of csrc/bulge.cu (namespace tcb) computes: x, the packed
// weights, the hidden tensor that stage 2 reads and y are bf16; products
// accumulate in fp32; statistics, BN and ReLU run in fp32 on the
// accumulators; h is rounded to bf16 after the edge mask, y after its
// product (pallas_bulge.py:93-97, 216-230, 261-262).  Statistics are one
// fp32 (sum, sum of squares) slot per work item, no atomics; the host
// reduces the slots in fp64 in a fixed order.
//
// Work item = (image, band of R = 8 y rows, chunk of TW = 32 y columns),
// chunk fastest, walked by a persistent grid (block k takes items k,
// k + gridDim.x, ...), as in bulge.cu.  Stage 1 (convT) is one product
//   HP (297 positions x 4 Cm) = A1 (297 x 4 Ci) @ W1 (4 Ci x 4 Cm),
// position (pi, pj) in [0, 8] x [0, 32] standing for x position
// (r0 - di + pi, c0 - dj + pj) of output parity (di, dj), k = (ti*2 + tj)*Ci
// + ci; stage 2 (conv) is
//   Y (256 pixels x Co) = A2 (256 x 16 Cm) @ W2 (16 Cm x Co),
// k = (a*4 + c)*Cm + cm (ops/bulge_mma.py has both maps).
//
// Bounds on an H100 SXM (bf16 dense 989 TFLOP/s, HBM 3.35 TB/s):
//   x (14400,32,32,32): stats 0.2839 ms (bytes; 241 GFLOP = 0.24 ms),
//                       main 0.564 ms (bytes; 483 GFLOP = 0.49 ms);
//   x (1,16,2048,2048): stats 0.0404 ms, main 0.0801 ms (bytes).
// Both launches sit near the card's ridge (about 256 operations a byte at
// Ci 32), so they reach their byte bound only if the products run near the
// tensor cores' peak, which on this card only wgmma reaches.
//
// What each part answers (the causes read from the mma.sync kernel):
// 1. x arrives by TMA: one tiled 4-D tensor map over NCHW x, one box of
//    48 columns x 10 rows x Ci channels an item, origin (c0-8, r0-1) (the
//    innermost box coordinate must be a multiple of 16 bytes, so the box
//    starts 8 columns left of the chunk and the window's column c0-1 is box
//    column 7); the hardware zero-fills everything outside the image, which
//    replaces the hand-written halo and edge code.  One producer lane keeps
//    STAGES boxes in flight under full/empty mbarriers (2 in the main
//    kernel, 3 in the stats kernel) while the consumers work on earlier
//    items (the old kernel issued the next x only after stage 1, or waited
//    for it at once).
// 2. The producer warps (3 in the main kernel and 4 in the stats kernel at
//    Ci 32, 2 at Ci 16) also turn each box, by ldmatrix.trans +
//    stmatrix, into xq[ci/8][position][8 channels] (34 x 10 positions, two
//    buffers): a position's 8 channels are 16 contiguous bytes, the layout
//    wgmma reads a K-major operand in.  Stage 1 is then wgmma with both
//    operands in shared memory: A = xq by descriptor, its M rows the xq
//    positions (5 m64 tiles; the tap offset (ti, tj) moves the start by
//    (ti*34 + tj)*16 bytes, so no copy of x is shifted), B = the packed W1,
//    N = 4 Cm, K = 4 Ci.  Stage 2 is wgmma with A from registers
//    (ldmatrix.x4 from the hidden planes, one instruction a 16x16 fragment;
//    the old kernel built each 32-bit A register from two 2-byte loads), B
//    = the packed W2, 4 m64 tiles of two y rows, N = Co, K = 16 Cm.  W1 and
//    W2 are staged once per persistent block in wgmma's canonical K-major
//    layout without swizzle (ops/bulge_mma.py to_wgmma_bf16).  Each
//    product is pipelined: tile t+1's wgmma groups are issued before tile
//    t's epilogue runs (stage 2 in half-tile steps, so that a second set of
//    A registers is half a tile's).
// 3. y leaves through shared memory: the accumulators go by stmatrix.trans
//    to ys[co][pixel], then each thread stores 16 bytes (8 pixels of one
//    channel) to device memory; the old kernel stored 2 bytes at a time.
// 4. Items are the old kernel's, but the main kernel splits the stages
//    between two warpgroups on double-buffered hidden planes
//    hp[par][cm/8][position][8]: warpgroup 0 runs stage 1 of item i+1
//    while warpgroup 1 runs stage 2 of item i.  In the stats kernel each
//    warpgroup runs stage 1 of every other item, so neither waits for the
//    other.
//
// Shared memory, bytes (Ci 32 / Cm 16 / Co 32; Ci 16 / Cm 8 / Co 16):
//   main:  W1 16,384 / 4,096; W2 16,384 / 4,096; x ring 2 x 30,720 /
//          2 x 15,360; xq 2 x 21,760 / 2 x 10,880; hidden planes 2 x
//          38,016 / 2 x 19,008; 128 for stores that go nowhere; ys 16,896
//          / 8,448; barriers 96 -> 230,880 (one block of 11 warps per SM)
//          / 107,360 (two blocks of 10).
//   stats: W1 16,384 / 4,096; x ring 3 x 30,720 / 3 x 15,360; xq 2 x
//          21,760 / 2 x 10,880; per-warp sums 8,192 / 4,096; 128; barriers
//          80 -> 160,464 / 76,240 (blocks of 12 / 10 warps).
//
// The tensor map needs W a multiple of 8 (16-byte row strides) and x's base
// 16-byte aligned; ops/bulge.py sends every other bf16 call to bulge.cu's
// mma.sync kernel.  The map is encoded on every call (it holds x's address)
// through cudaGetDriverEntryPoint, so the library links against the runtime
// alone.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/bulge.py).
// Each entry returns the cudaError_t of its launch (0 = launched), or a
// negative value when the tensor map could not be encoded (-1 - CUresult,
// or -1000 when the driver entry point is missing).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace wg {

constexpr int R = 8;              // y rows of a work item
constexpr int TW = 32;            // y columns of a work item
constexpr int XR = R + 2;         // box rows: x rows r0-1 .. r0+R
constexpr int XC = 48;            // box columns: x columns c0-8 .. c0+39
constexpr int XO = 7;             // box column of x column c0-1
constexpr int PR = R + 1;         // hidden-plane position rows
constexpr int PC = TW + 1;        // hidden-plane position columns
constexpr int NPOS = PR * PC;     // 297
constexpr int M1T = 5;            // stage-1 m64 tiles
constexpr int M2T = R * TW / 64;  // stage-2 m64 tiles: 4
constexpr int YROW = R * TW + 8;  // ys row (one channel) in bf16, padded
static_assert(TW == 32 && XC % 8 == 0 && XO + TW + 2 <= XC && XO + 1 == 8,
              "box geometry: origin c0 - 8, a multiple of 8 columns");
static_assert((YROW * 2) % 128 == 16, "ys rows in distinct bank groups");

struct Item {
  int b, r0, c0;
};

// Item idx -> (image, band, chunk), chunk fastest (ops/bulge_mma.py
// Schedule.item is the same map).
__device__ __forceinline__ Item decode(long long idx, int nbands,
                                       int nchunks) {
  Item it;
  const long long rest = idx / nchunks;
  it.c0 = (int)(idx - rest * nchunks) * TW;
  it.b = (int)(rest / nbands);
  it.r0 = (int)(rest - (long long)it.b * nbands) * R;
  return it;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers, named barriers, TMA ----------------------------------------

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

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// x box (c, r, 0, b) of the 4-D map into dst, completing on bar.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map,
                                             uint64_t* bar, int c, int r,
                                             int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c), "r"(r), "r"(0), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// ---- ldmatrix / stmatrix ----------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
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

__device__ __forceinline__ void stsm_x4_t(uint32_t addr,
                                          const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// Two fp32 values rounded to bf16 (to nearest even), `lo` in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// x through an opaque move: what is computed from it cannot be hoisted
// above this point (so a fully unrolled product keeps its descriptors out
// of registers until they are used).
__device__ __forceinline__ uint32_t launder(uint32_t x) {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(x));
  return r;
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

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x N, fp32) += a (m64 x k16, bf16, registers) * B (k16 x N, bf16,
// shared memory at `b`).  Thread (warp w of the warpgroup, lane g*4 + t)
// holds rows 16w + g (+8) of A and D, as mma.m16n8k16 does for its warp.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
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
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
        "0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// d (m64 x N, fp32) += A (m64 x k16) * B (k16 x N), both bf16 in shared
// memory, addressed by descriptors.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

// Keeps A fragment registers live (and unmoved) up to this point: wgmma
// reads them asynchronously until its group has completed.
template <int KS>
__device__ __forceinline__ void keep_a(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[ks][e])::"memory");
}

// T m64 x N tiles with A from registers, pipelined at half-tile steps so
// that only half a tile's A fragments (KS/2 k-steps) need a second register
// set: groups (t, 0) and (t, 1) take k-steps [0, KS/2) and [KS/2, KS) into
// one accumulator set; tile t+1's groups are issued before tile t's
// epilogue runs.  For each tile t, A is the KS k16 steps this lane
// addresses at row(t) + off(ks) (ldmatrix.x4), B the packed operand's
// k-step ks at b_base + ks * b_step (descriptor offsets lbo between k core
// matrices, 128 between n core matrices); epi(t, d) receives the finished
// fp32 tile; loaded() runs once, right after the last tile's A has been
// loaded (its source may then be overwritten).
template <int N, int KS, int T, class Row, class Off, class Epi, class Loaded>
__device__ __forceinline__ void pipelined_halves(Row row, Off off,
                                                 uint32_t b_base,
                                                 uint32_t b_step, uint32_t lbo,
                                                 Epi epi, Loaded loaded) {
  constexpr int KH = KS / 2;
  static_assert(KS % 2 == 0, "two halves of k-steps");
  float d[2][N / 2];
  uint32_t a[2][KH][4];
  auto half = [&](float (&dd)[N / 2], uint32_t (&aa)[KH][4], int t, int h,
                  bool zero) {
    const uint32_t r = row(t), b0 = launder(b_base);
#pragma unroll
    for (int ks = 0; ks < KH; ++ks) ldsm_x4(aa[ks], r + off(h * KH + ks));
    if (t == T - 1 && h == 1) loaded();
    if (zero) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) dd[i] = 0.f;
    }
    fence_acc<N>(dd);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KH; ++ks)
      Wgmma<N>::run(dd, aa[ks], desc(b0 + (h * KH + ks) * b_step, lbo, 128));
    wg_commit();
  };
  half(d[0], a[0], 0, 0, true);
  half(d[0], a[1], 0, 1, false);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      wg_wait1();                 // (t, 0) done: a[0] is free
      keep_a<KH>(a[0]);
      half(d[(t + 1) & 1], a[0], t + 1, 0, true);
      wg_wait1();                 // (t, 1) done: a[1] free, tile t complete
      keep_a<KH>(a[1]);
      half(d[(t + 1) & 1], a[1], t + 1, 1, false);
    } else {
      wg_wait0();
      keep_a<KH>(a[0]);
      keep_a<KH>(a[1]);
    }
    fence_acc<N>(d[t & 1]);
    epi(t, d[t & 1]);
  }
}

// T m64 x N tiles of a product with both operands in shared memory,
// pipelined two deep: tile t+1's group is issued before tile t's epilogue
// runs.  Tile t's A is k-step ks at
// a_start(t) + a_koff(ks) (leading offset a_lbo between k core matrices,
// 128 between m core matrices), B as there.  Nothing of A lives in
// registers, so only the two accumulator sets alternate.
template <int N, int KS, int T, class AStart, class AOff, class Epi>
__device__ __forceinline__ void pipelined_ss(AStart a_start, AOff a_koff,
                                             uint32_t a_lbo, uint32_t b_base,
                                             uint32_t b_step, uint32_t b_lbo,
                                             Epi epi) {
  float d[2][N / 2];
  auto start = [&](float (&dd)[N / 2], int t) {
    const uint32_t a0 = launder(a_start(t)), b0 = launder(b_base);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dd[i] = 0.f;
    fence_acc<N>(dd);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      WgmmaSS<N>::run(dd, desc(a0 + a_koff(ks), a_lbo, 128),
                      desc(b0 + ks * b_step, b_lbo, 128));
    wg_commit();
  };
  start(d[0], 0);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      start(d[(t + 1) & 1], t + 1);
      wg_wait1();
    } else {
      wg_wait0();
    }
    fence_acc<N>(d[t & 1]);
    epi(t, d[t & 1]);
  }
}


// ---- staging ----------------------------------------------------------------

constexpr int XQC = TW + 2;          // xq columns: x columns c0-1 .. c0+32
constexpr int XQPOS = XR * XQC;      // xq positions a channel group (340)

// Box (CI x XR x XC, NCHW order, as the TMA writes it) -> xq[ci/8][pos][8],
// pos = r * XQC + (box column - XO): ldmatrix.trans reads 8 channels x 8
// box columns (rows of the box plane), stmatrix writes them back as 8
// positions x 8 channels, the columns outside the window to `junk`.  Units
// of four 8x8 blocks, shared out over `nwarps` warps (this one `w`).
template <int CI>
__device__ __forceinline__ void transpose_box(uint32_t box_s, uint32_t xq_s,
                                              uint32_t junk_s, int w,
                                              int nwarps, int lane) {
  constexpr int CB = XC / 8;                      // column blocks a row
  constexpr int NBLK = (CI / 8) * XR * CB;        // 8x8 blocks an item
  static_assert(NBLK % 4 == 0, "units of four blocks");
  const int rr = lane & 7;
#pragma unroll 4
  for (int u = w; u < NBLK / 4; u += nwarps) {
    const int blk = u * 4 + (lane >> 3);
    const int cg = blk / (XR * CB), rem = blk - cg * (XR * CB);
    const int r = rem / CB, cb = rem - r * CB;
    const int col = cb * 8 + rr - XO;
    uint32_t v[4];
    ldsm_x4_t(v, box_s + (((cg * 8 + rr) * XR + r) * XC + cb * 8) * 2);
    stsm_x4((unsigned)col < (unsigned)XQC
                ? xq_s + (cg * XQPOS + r * XQC + col) * 16 : junk_s, v);
  }
}

// Stage 1's M rows are xq positions q = pi * XQC + pj: row q of tile mt is
// local position (q / XQC, q % XQC), a real one where pj <= TW and
// pi <= R (q <= LASTQ); the others are computed and never stored.
constexpr int LASTQ = R * XQC + TW;
static_assert(M1T * 64 > LASTQ && (M1T - 1) * 64 <= LASTQ, "stage-1 tiles");

// Stage-1 A start, in 16-byte units of xq, of k-step ks (its lower k-half;
// the upper one is the next channel group, the descriptor's leading
// offset): k = tap*CI + ci, tap = ti*2 + tj reads position (pi+ti, pj+tj).
template <int CI>
__device__ __forceinline__ int stage1_koff(int ks) {
  const int kb = ks * 16, tap = kb / CI, cg = (kb % CI) / 8;
  return cg * XQPOS + (tap >> 1) * XQC + (tap & 1);
}

// Stage-2 A offset, in 16-byte units of the hidden planes, of k-step ks
// for k-half kh: k = (a*4 + c)*CM + cm reads plane (par, cm/8) at position
// (ml + a/2, nl + c/2), par = ((a+1)&1)*2 + ((c+1)&1).
template <int CM>
__device__ __forceinline__ int stage2_koff(int ks, int kh) {
  const int kb = ks * 16 + 8 * kh, tap = kb / CM, cg = (kb % CM) / 8;
  const int a = tap >> 2, c = tap & 3;
  const int par = ((a + 1) & 1) * 2 + ((c + 1) & 1);
  return (par * (CM / 8) + cg) * NPOS + (a >> 1) * PC + (c >> 1);
}

// `bytes` (a multiple of 16) from global to shared memory, by all `nt`
// threads of the block.
__device__ __forceinline__ void stage_weights(void* dst, const void* src,
                                              int bytes, int tid, int nt) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int k = tid; k < bytes / 16; k += nt) d[k] = s[k];
}

// ---- shared memory ----------------------------------------------------------

__host__ __device__ constexpr size_t al128(size_t n) {
  return (n + 127) / 128 * 128;
}

template <int CI, int CM, int CO>
struct MainSmem {
  static constexpr int STAGES = 2;                      // x boxes in flight
  static constexpr size_t W1 = 32 * CI * CM;            // (4CI x 4CM) bf16
  static constexpr size_t W2 = 32 * CM * CO;            // (16CM x CO) bf16
  static constexpr size_t BOX = (size_t)CI * XR * XC * 2;
  static constexpr size_t XQ = (size_t)CI / 8 * XQPOS * 16;
  static constexpr size_t HP = (size_t)4 * CM / 8 * NPOS * 16;
  static constexpr size_t YS = (size_t)CO * YROW * 2;
  static constexpr size_t o_w2 = al128(W1);
  static constexpr size_t o_ring = o_w2 + al128(W2);
  static constexpr size_t o_xq = o_ring + STAGES * al128(BOX);
  static constexpr size_t o_hp = o_xq + 2 * al128(XQ);
  static constexpr size_t o_junk = o_hp + 2 * HP;
  static constexpr size_t o_ys = o_junk + 128;
  static constexpr size_t o_bar = o_ys + al128(YS);
  static constexpr size_t bytes = o_bar + 8 * (2 * STAGES + 8);
};

template <int CI, int CM>
struct StatsSmem {
  static constexpr int STAGES = 3;
  static constexpr size_t W1 = 32 * CI * CM;
  static constexpr size_t BOX = (size_t)CI * XR * XC * 2;
  static constexpr size_t XQ = (size_t)CI / 8 * XQPOS * 16;
  // per warpgroup, two items: [warp][column][sum, sum of squares]
  static constexpr size_t RED = (size_t)2 * 2 * 4 * 4 * CM * 2 * 4;
  static constexpr size_t o_ring = al128(W1);
  static constexpr size_t o_xq = o_ring + STAGES * al128(BOX);
  static constexpr size_t o_red = o_xq + 2 * al128(XQ);
  static constexpr size_t o_junk = o_red + al128(RED);
  static constexpr size_t o_bar = o_junk + 128;
  static constexpr size_t bytes = o_bar + 8 * (2 * STAGES + 4);
};

// ---- the producer -----------------------------------------------------------

// Warps 8 .. 8+NPW-1.  Warp 8's lane 0 keeps STAGES x boxes in flight by
// TMA; all NPW warps turn each arrived box into xq buffer it % 2 (item it
// of this block) and release the box.  full/empty: the box ring (empty
// counts the NPW warps); xq_full (NPW arrivals) / xq_empty (the consumer
// warpgroup's 128) the xq buffers.
template <int CI, int STAGES, int NPW>
__device__ __forceinline__ void produce(const CUtensorMap* map,
                                        unsigned char* smem, size_t o_ring,
                                        size_t o_xq, size_t o_junk,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* xq_full, uint64_t* xq_empty,
                                        int nbands, int nchunks,
                                        long long n_items, int pw, int lane) {
  constexpr size_t BOX = (size_t)CI * XR * XC * 2;
  constexpr size_t XQ = (size_t)CI / 8 * XQPOS * 16;
  const bool issuer = pw == 0 && lane == 0;
  auto load = [&](int slot, long long idx) {
    const Item m = decode(idx, nbands, nchunks);
    mbar_expect_tx(&full[slot], (uint32_t)BOX);
    tma_load_box(smem + o_ring + slot * al128(BOX), map, &full[slot],
                 m.c0 - XO - 1, m.r0 - 1, m.b);
  };
  if (issuer)
    for (int s = 0; s < STAGES; ++s) {
      const long long idx = blockIdx.x + (long long)s * gridDim.x;
      if (idx < n_items) load(s, idx);
    }
  const uint32_t junk_s = smem_u32(smem + o_junk);
  int it = 0;
  for (long long idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++it) {
    const int slot = it % STAGES, xb = it & 1;
    mbar_wait(&full[slot], (it / STAGES) & 1);
    if (it >= 2) mbar_wait(&xq_empty[xb], ((it >> 1) - 1) & 1);
    transpose_box<CI>(smem_u32(smem + o_ring + slot * al128(BOX)),
                      smem_u32(smem + o_xq + xb * al128(XQ)), junk_s, pw, NPW,
                      lane);
    // xq is read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&xq_full[xb]);
      mbar_arrive(&empty[slot]);
    }
    if (issuer) {
      const long long next = idx + (long long)STAGES * gridDim.x;
      if (next < n_items) {
        mbar_wait(&empty[slot], (it / STAGES) & 1);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load(slot, next);
      }
    }
  }
}

// ---- the main kernel ----------------------------------------------------------

// Producer warps: the transpose is the producers' work and the launches'
// bound when one warp does it.  A sub-partition of the SM holds three warps
// of a 9- to 12-warp block alike, so up to three producers leave the
// consumers' registers as they are (two at Ci 16, whose two blocks an SM
// share the sub-partitions).
template <int CI>
__host__ __device__ constexpr int main_npw() { return CI >= 32 ? 3 : 2; }
template <int CI>
__host__ __device__ constexpr int main_threads() {
  return 256 + 32 * main_npw<CI>();
}

template <int CI, int CM, int CO>
__global__ void __launch_bounds__(main_threads<CI>(), (CI <= 16 ? 2 : 1))
bulge_main_kernel(const __grid_constant__ CUtensorMap xmap,
                  const uint16_t* __restrict__ w1,
                  const uint16_t* __restrict__ w2,
                  const float* __restrict__ mu, const float* __restrict__ gain,
                  const float* __restrict__ beta, uint16_t* __restrict__ y,
                  int H, int W, int nbands, int nchunks, long long n_items) {
  using S = MainSmem<CI, CM, CO>;
  constexpr int NPW = main_npw<CI>(), NTH = main_threads<CI>();
  constexpr int N1 = 4 * CM, K1S = 4 * CI / 16;   // stage 1: n, k16 steps
  constexpr int N2 = CO, K2S = CM;                // stage 2: 16 CM / 16
  constexpr int CMG = CM / 8;
  static_assert(CM % 8 == 0 && CO % 16 == 0 && CI % 16 == 0, "channels");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::o_bar);
  uint64_t* full = bars;
  uint64_t* empty = full + S::STAGES;
  uint64_t* xq_full = empty + S::STAGES;
  uint64_t* xq_empty = xq_full + 2;
  uint64_t* hp_full = xq_empty + 2;
  uint64_t* hp_empty = hp_full + 2;

  // the warp index through a shuffle, so that the compiler knows the role
  // branches below to be warp-uniform
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  stage_weights(smem, w1, (int)S::W1, tid, NTH);
  stage_weights(smem + S::o_w2, w2, (int)S::W2, tid, NTH);
  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NPW);
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(&xq_full[h], NPW);
      mbar_init(&xq_empty[h], 128);
      mbar_init(&hp_full[h], 128);
      mbar_init(&hp_empty[h], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (warp >= 8) {
    produce<CI, S::STAGES, NPW>(&xmap, smem, S::o_ring, S::o_xq, S::o_junk,
                                full, empty, xq_full, xq_empty, nbands,
                                nchunks, n_items, warp - 8, lane);
    return;
  }

  const int g = lane >> 2, t = lane & 3, kh = lane >> 4;
  if (warp < 4) {
    // ---- warpgroup 0: stage 1 of every item into hidden planes it % 2 ----
    const int w = warp;
    const uint32_t w1_s = smem_u32(smem);
    const uint32_t lbo1 = N1 / 8 * 128;
    const uint32_t junk_s = smem_u32(smem + S::o_junk);
    // this thread's channels: cm = cg*8 + 2t + c over the n8 blocks
    float bn_beta[CMG][2];
#pragma unroll
    for (int cg = 0; cg < CMG; ++cg)
#pragma unroll
      for (int c = 0; c < 2; ++c) bn_beta[cg][c] = beta[cg * 8 + 2 * t + c];
    int it = 0;
    for (long long idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++it) {
      const Item m = decode(idx, nbands, nchunks);
      const int xb = it & 1, h = it & 1;
      // h = acc * gain + shift, shift = beta - mu * gain
      float bn_gain[CMG][2], bn_shift[CMG][2];
#pragma unroll
      for (int cg = 0; cg < CMG; ++cg)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cm = cg * 8 + 2 * t + c;
          const float gv = gain[(size_t)m.b * CM + cm];
          bn_gain[cg][c] = gv;
          bn_shift[cg][c] = fmaf(-mu[(size_t)m.b * CM + cm], gv,
                                 bn_beta[cg][c]);
        }
      mbar_wait(&xq_full[xb], (it >> 1) & 1);
      if (it >= 2) mbar_wait(&hp_empty[h], ((it >> 1) - 1) & 1);
      const uint32_t xq_s = smem_u32(smem + S::o_xq + xb * al128(S::XQ));
      const uint32_t hp_s = smem_u32(smem + S::o_hp + h * S::HP);
      pipelined_ss<N1, K1S, M1T>(
          [&](int mt) { return xq_s + mt * 64 * 16; },
          [](int ks) { return stage1_koff<CI>(ks) * 16; }, XQPOS * 16, w1_s,
          2 * lbo1, lbo1,
          [&](int mt, float (&d)[N1 / 2]) {
            if (mt == M1T - 1) mbar_arrive(&xq_empty[xb]);   // xq read
            // normalise, rectify, zero outside the image, round, store
            bool row_in[2][2], col_in[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int q = mt * 64 + 16 * w + g + 8 * i;
              const int pi = q / XQC, pj = q - pi * XQC;
#pragma unroll
              for (int dd = 0; dd < 2; ++dd) {
                row_in[i][dd] = (unsigned)(m.r0 - dd + pi) < (unsigned)H;
                col_in[i][dd] = (unsigned)(m.c0 - dd + pj) < (unsigned)W;
              }
            }
            const int srow = mt * 64 + 16 * w + (lane & 7);
#pragma unroll
            for (int jj = 0; jj < N1 / 16; ++jj) {
              uint32_t v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = 2 * jj + (e >> 1), i = e & 1;
                const int par = (8 * j) / CM, cg = ((8 * j) % CM) / 8;
                const bool in = row_in[i][par >> 1] && col_in[i][par & 1];
                float o[2];
#pragma unroll
                for (int c = 0; c < 2; ++c)
                  o[c] = in ? fmaxf(fmaf(d[4 * j + 2 * i + c], bn_gain[cg][c],
                                         bn_shift[cg][c]), 0.f)
                            : 0.f;
                v[e] = pack_bf16(o[0], o[1]);
              }
              // lane l addresses row l%8 of block (2jj + (l/8)/2, half
              // (l/8)%2); plane = n / 8 = j
              const int e = lane >> 3;
              const int q = srow + 8 * (e & 1), plane = 2 * jj + (e >> 1);
              const int pi = q / XQC, pj = q - pi * XQC;
              stsm_x4(pj <= TW && q <= LASTQ
                          ? hp_s + (plane * NPOS + pi * PC + pj) * 16
                          : junk_s, v);
            }
          });
      mbar_arrive(&hp_full[h]);
    }
  } else {
    // ---- warpgroup 1: stage 2 of every item from hidden planes it % 2 ----
    const int w = warp - 4, wt = tid - 128;
    const uint32_t w2_s = smem_u32(smem + S::o_w2);
    const uint32_t lbo2 = N2 / 8 * 128;
    unsigned char* ys = smem + S::o_ys;
    const uint32_t ys_s = smem_u32(ys);
    const int mrow = 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int e = lane >> 3, m0 = 16 * w + 8 * (e & 1);
    const size_t y_img = (size_t)CO * H * W;
    int it = 0;
    for (long long idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++it) {
      const Item m = decode(idx, nbands, nchunks);
      const int h = it & 1;
      mbar_wait(&hp_full[h], (it >> 1) & 1);
      named_sync(2, 128);     // every thread has stored the last item's y
      const uint32_t hp_s = smem_u32(smem + S::o_hp + h * S::HP);
      pipelined_halves<N2, K2S, M2T>(
          [&](int mt) {
            return hp_s + ((2 * mt + (mrow >> 5)) * PC + (mrow & 31)) * 16;
          },
          // kh is per lane: both offsets are constants once ks is unrolled
          [kh](int ks) {
            return (kh ? stage2_koff<CM>(ks, 1) : stage2_koff<CM>(ks, 0)) *
                   16;
          },
          w2_s, 2 * lbo2, lbo2,
          [&](int mt, float (&d)[N2 / 2]) {
            // y tile -> ys[co][pixel] by stmatrix.trans: matrix (j, i) is
            // rows 16w + 8i .. +7 (pixels) x channels 8j .. 8j+7
            const int pix = (2 * mt + (m0 >> 5)) * TW + (m0 & 31);
#pragma unroll
            for (int jj = 0; jj < N2 / 16; ++jj) {
              uint32_t v[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int j = 2 * jj + (q >> 1), i = q & 1;
                v[q] = pack_bf16(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
              }
              const int co = 8 * (2 * jj + (e >> 1)) + (lane & 7);
              stsm_x4_t(ys_s + (co * YROW + pix) * 2, v);
            }
          },
          [&] { mbar_arrive(&hp_empty[h]); });   // hp read
      named_sync(2, 128);     // ys complete
      // 16-byte stores: chunk = (co, row, 8 columns); W % 8 == 0, so a chunk
      // is wholly inside or outside the image
      uint16_t* yb = y + (size_t)m.b * y_img;
      for (int k = wt; k < CO * R * (TW / 8); k += 128) {
        const int co = k / (R * TW / 8), rem = k - co * (R * TW / 8);
        const int ml = rem / (TW / 8), nb = rem - ml * (TW / 8);
        const int row = m.r0 + ml, col = m.c0 + 8 * nb;
        if (row < H && col < W) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              ys + (co * YROW + ml * TW + 8 * nb) * 2);
          *reinterpret_cast<uint4*>(yb + ((size_t)co * H + row) * W + col) = v;
        }
      }
    }
  }
}

// ---- the stats kernel ---------------------------------------------------------

// Two consumer warpgroups, each with stage 1 of every other item of the
// block (warpgroup v: items it = v, v+2, ...; xq buffer v), and NPW
// producer warps.
template <int CI>
__host__ __device__ constexpr int stats_npw() { return CI >= 32 ? 4 : 2; }

// partial[idx][0][cm] = sum, partial[idx][1][cm] = sum of squares of the
// hidden cells item idx owns (even parities at local positions [0, R) x
// [0, TW), odd ones at [1, R] x [1, TW], clipped to the image), in fp32
// from the fp32 accumulators.
template <int CI, int CM>
__global__ void __launch_bounds__(256 + 32 * stats_npw<CI>(),
                                  (CI <= 16 ? 2 : 1))
bulge_stats_kernel(const __grid_constant__ CUtensorMap xmap,
                   const uint16_t* __restrict__ w1, float* __restrict__ partial,
                   int H, int W, int nbands, int nchunks, long long n_items) {
  using S = StatsSmem<CI, CM>;
  constexpr int NPW = stats_npw<CI>(), NTH = 256 + 32 * NPW;
  constexpr int N1 = 4 * CM, K1S = 4 * CI / 16, NJ = N1 / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + S::o_red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::o_bar);
  uint64_t* empty = full + S::STAGES;
  uint64_t* xq_full = empty + S::STAGES;
  uint64_t* xq_empty = xq_full + 2;

  // the warp index through a shuffle, so that the compiler knows the role
  // branches below to be warp-uniform
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  stage_weights(smem, w1, (int)S::W1, tid, NTH);
  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NPW);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&xq_full[b], NPW);
      mbar_init(&xq_empty[b], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (warp >= 8) {
    produce<CI, S::STAGES, NPW>(&xmap, smem, S::o_ring, S::o_xq, S::o_junk,
                                full, empty, xq_full, xq_empty, nbands,
                                nchunks, n_items, warp - 8, lane);
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int v = warp >> 2, w = warp & 3, wt = tid & 127;
  const uint32_t w1_s = smem_u32(smem);
  const uint32_t lbo1 = N1 / 8 * 128;
  const uint32_t xq_s = smem_u32(smem + S::o_xq + v * al128(S::XQ));
  // red[v][buf][warp][column][sum, squares]
  auto slot = [&](int buf, int ww, int col, int k) {
    return ((((v * 2 + buf) * 4 + ww) * N1 + col) * 2) + k;
  };
  int k = 0;
  for (long long idx = blockIdx.x + (long long)v * gridDim.x; idx < n_items;
       idx += 2 * (long long)gridDim.x, ++k) {
    const Item m = decode(idx, nbands, nchunks);
    const int buf = k & 1;
    float s[NJ][2][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) s[j][c][0] = s[j][c][1] = 0.f;
    mbar_wait(&xq_full[v], k & 1);
    pipelined_ss<N1, K1S, M1T>(
        [&](int mt) { return xq_s + mt * 64 * 16; },
        [](int ks) { return stage1_koff<CI>(ks) * 16; }, XQPOS * 16, w1_s,
        2 * lbo1, lbo1,
        [&](int mt, float (&d)[N1 / 2]) {
          if (mt == M1T - 1) mbar_arrive(&xq_empty[v]);   // xq read
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = mt * 64 + 16 * w + g + 8 * i;
            const int pi = q / XQC, pj = q - pi * XQC;
            // does this item own the cell of parity (di, dj) here
            bool row_own[2], col_own[2];
#pragma unroll
            for (int dd = 0; dd < 2; ++dd) {
              row_own[dd] = q <= LASTQ && pi - dd >= 0 && pi - dd < R &&
                            m.r0 + pi - dd < H;
              col_own[dd] = pj - dd >= 0 && pj - dd < TW &&
                            m.c0 + pj - dd < W;
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int par = (8 * j) / CM;
              const bool own = row_own[par >> 1] && col_own[par & 1];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float x = own ? d[4 * j + 2 * i + c] : 0.f;
                s[j][c][0] += x;
                s[j][c][1] = fmaf(x, x, s[j][c][1]);
              }
            }
          }
        });
    // over the 8 row lanes of a column (lanes with equal t)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          float x = s[j][c][kk];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if (g == 0) red[slot(buf, w, 8 * j + 2 * t + c, kk)] = x;
        }
    named_sync(1 + v, 128);   // this warpgroup's sums of the item are in
    // channel cm sums its four parity columns n = par*CM + cm over the
    // warpgroup's warps, in a fixed order
    if (wt < 2 * CM) {
      const int kk = wt / CM, cm = wt - kk * CM;
      float sum = 0.f;
#pragma unroll
      for (int par = 0; par < 4; ++par)
#pragma unroll
        for (int ww = 0; ww < 4; ++ww)
          sum += red[slot(buf, ww, par * CM + cm, kk)];
      partial[((size_t)idx * 2 + kk) * CM + cm] = sum;
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

// The driver's cuTensorMapEncodeTiled, found once through the runtime.
inline EncodeTiled encoder() {
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

// The 4-D map over x (B, CI, H, W) bf16, innermost first: box XC x XR x CI
// x 1; out-of-image elements read as zero.  Returns 0 or a negative code.
inline int encode_x(CUtensorMap* map, const void* x, int B, int ci, int H,
                    int W) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEntryPoint;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)ci,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                 (cuuint64_t)ci * H * W * 2};
  const cuuint32_t box[4] = {XC, XR, (cuuint32_t)ci, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(x), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1 - (int)r;
}

// Blocks of a persistent launch: what fits on the card, at most one per item.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, int nt, size_t smem, int n_sm,
                            long long n_items, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || n_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * n_sm;
  *grid = (int)(n_items < fit ? n_items : fit);
  return cudaSuccess;
}

inline bool takes(const void* x, int W) {
  return W % 8 == 0 && ((uintptr_t)x & 15) == 0;
}

template <int CI, int CM, int CO>
int launch_main(const void* x, const uint16_t* w1, const uint16_t* w2,
                const float* mu, const float* gain, const float* beta,
                uint16_t* y, int B, int H, int W, int n_sm,
                cudaStream_t stream) {
  const int nbands = (H + R - 1) / R, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  if (!takes(x, W) || ((uintptr_t)y & 15)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int enc = encode_x(&map, x, B, CI, H, W);
  if (enc != 0) return enc;
  const size_t smem = MainSmem<CI, CM, CO>::bytes;
  int grid = 0;
  constexpr int nt = main_threads<CI>();
  cudaError_t e = persistent_grid(bulge_main_kernel<CI, CM, CO>, nt, smem,
                                  n_sm, n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  bulge_main_kernel<CI, CM, CO><<<grid, nt, smem, stream>>>(
      map, w1, w2, mu, gain, beta, y, H, W, nbands, nchunks, n_items);
  return (int)cudaGetLastError();
}

template <int CI, int CM>
int launch_stats(const void* x, const uint16_t* w1, float* partial, int B,
                 int H, int W, int n_sm, cudaStream_t stream) {
  const int nbands = (H + R - 1) / R, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  if (!takes(x, W)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int enc = encode_x(&map, x, B, CI, H, W);
  if (enc != 0) return enc;
  const size_t smem = StatsSmem<CI, CM>::bytes;
  int grid = 0;
  constexpr int nt = 256 + 32 * stats_npw<CI>();
  cudaError_t e = persistent_grid(bulge_stats_kernel<CI, CM>, nt, smem, n_sm,
                                  n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  bulge_stats_kernel<CI, CM><<<grid, nt, smem, stream>>>(
      map, w1, partial, H, W, nbands, nchunks, n_items);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ============================================================================
// fp32: the same pair at fp32 accuracy, 3xTF32 on wgmma (namespace wgf)
// ============================================================================
//
// Replaces the TPU kernel dcgan_sr_tpu/ops/pallas_bulge.py fused_bulge_fwd
// with fp32 x (_stats_kernel :159, _main_kernel :206), which the JAX package
// runs at Precision.HIGHEST (pallas_bulge.py:93-97).  It computes what the
// mma.sync kernel of csrc/bulge.cu (namespace tc) computes: every product
// is three TF32 products, lo*hi + hi*lo + hi*hi with hi = a & 0xffffe000
// and lo = a - hi, accumulated in fp32; statistics, BN and ReLU run in fp32
// on the accumulators; one fp32 (sum, sum of squares) slot per stats work
// item (band of 8 y rows, 32 y columns), no atomics, reduced by the host in
// fp64 in a fixed order.  Any batch; ragged H and W are masked.
//
// Bounds on an H100 SXM (TF32 495 TFLOP/s dense, so 165 for 3xTF32; HBM
// 3.35 TB/s): at x (14400,32,32,32) the stats launch is 241.6 GFLOP, 1.46
// ms, the main launch 483 GFLOP, 2.93 ms, against 1.13 ms of bytes: both are
// bound by the tensor cores' operations.  At x (1,16,2048,2048): 0.107 /
// 0.211 ms.
//
// What the design does about it:
// 1. Both products are wgmma.mma_async m64nNk8 .tf32 (on this card only
//    wgmma reaches the TF32 peak; mma.sync issued 3.5 instructions a
//    product).  tf32 takes no transpose, so B (the weights) is K-major in
//    shared memory: core matrices of 8 n-rows x 4 k-values (16 bytes),
//    leading byte offset N/8 * 128 (k), stride 128 (n) (ops/bulge_mma.py
//    to_wgmma_tf32).  The host packs each weight as two planes, hi =
//    tf32(w) (stored truncated, so how the tensor cores read an fp32 word
//    does not matter to hi; the layout test tf32_probe pins it) and lo = w -
//    hi.  W2's rows are permuted within each k-step, logical k (t, t+4) ->
//    channels (2t, 2t+1), so stage 2 reads a lane's A pair as one 8-byte
//    load.
// 2. A comes from registers: each lane loads its four fp32 A values of a
//    k-step from shared memory and splits them there (one AND and one
//    subtraction a value), once per k-step of a 64-row tile, for the three
//    products of N columns that follow.  There is no K-major copy of x: the
//    lanes read the TMA box (NCHW) directly.  The box is 44 columns wide,
//    from c0-4 (16 bytes, the innermost coordinate's alignment) to c0+39,
//    so that a channel plane is 440 (R 8) or 264 (R 4) floats, 24 or 8 mod
//    32: the four channels of a fragment load fall in disjoint banks (40
//    columns, the least that covers c0-1 .. c0+32, would give 400 / 240,
//    16 mod 32, and two-way conflicts).
// 3. x arrives by TMA: one 4-D fp32 tensor map over NCHW x, one box an item,
//    the halo and the image's edges zero-filled by the hardware, completing
//    on a full mbarrier.  One consumer thread issues each load as soon as
//    the box's last reader is done (an empty mbarrier in the stats kernel,
//    the barrier after stage 1 in the main kernel), so no producer warp
//    takes registers: ptxas allots registers by whole warpgroups, and a
//    ninth warp cost a third of the consumers' registers (168 a thread,
//    spills, serialized wgmma in the first design).
// 4. Warpgroups that all consume: two in the stats kernel and at Ci 16,
//    three in the main kernel at Ci 32.  A warpgroup's products are chains
//    of chunks of KC k-steps with two A register sets alternating: chunk
//    c+1 is loaded and issued before chunk c is waited for, and a finished
//    tile's epilogue runs while the next tile's chunks run.
//    Stats (R = 8): each warpgroup takes every other item of the block,
//    stage 1 only, 5 m64 tiles of N = 4 Cm, one box each (a ring of 2).
//    Main (R = 4 at Ci 32, 8 at Ci 16): all warpgroups work on every item,
//    on one box and one set of hidden planes.  At Ci 32 three warpgroups
//    take one stage-1 m64 tile each, whole (N = 4 Cm), and two of them one
//    stage-2 tile each; the third starts its tile of the next item as soon
//    as that item's box is in, while the other two run stage 2.  At Ci 16
//    (two blocks share an SM) two warpgroups take 3 and 2 stage-1 tiles and
//    2 stage-2 tiles each (bands of 16 rows with three warpgroups, or one
//    block an SM with longer chunks, measured no faster or slower).  Whole
//    tiles matter: a tile's A loads, splits and descriptors are the same
//    whatever its N, and with column halves (the first design) they, not
//    the tensor cores, bounded the kernel.  The hidden planes
//    hp[par][cm/8][position][8] (fp32, normalised, rectified, zero outside
//    the image) are written after a named barrier that all warpgroups pass
//    when the last item's stage 2 has read them, and read after another;
//    the item's BN gain and shift a column sit in a small table.  y leaves
//    the registers as 32-byte runs (8 pixels of one channel a quarter
//    warp).
//
// Band height and shared memory, bytes (Ci 32 / Cm 16 / Co 32; Ci 16 / Cm 8
// / Co 16).  The hi and lo planes of W1 (4 Ci x 4 Cm) and W2 (16 Cm x Co)
// take 65,536 + 65,536 / 16,384 + 16,384.  At R = 8 in the main kernel,
// one box (10 x 44 x 32 floats, 56,320) and one set of hidden planes (4 x 16
// x 297 floats, 76,032) do not fit beside them at Ci 32 (263,680 of
// 232,448), so the main kernel takes bands of R = 4 there: 3 stage-1 m64
// tiles for 165 positions (1.5x stage 1's useful work against 1.25x at
// R = 8) and 2 stage-2 tiles.  (A cluster of two blocks, one a stage, was
// the alternative; it would send the hidden planes through distributed
// shared memory.)
//   main, Ci 32, R 4:  W 131,072 + box 6 x 44 x 32 x 4 = 33,792 + hidden
//                      planes 4 x 16 x 165 x 4 = 42,240 + BN table 512 +
//                      barrier 8 = 207,624: one block of 12 warps an SM.
//   main, Ci 16, R 8:  32,768 + 28,160 + 38,016 + 256 + 8 = 99,208: two
//                      blocks.
//   stats, R 8:        W1 65,536 / 16,384 + ring 2 x 56,320 / 2 x 28,160 +
//                      per-warp sums 8,192 / 4,096 + barriers 32 = 186,400
//                      (one block) / 76,800 (two blocks).
//
// The tensor map needs W a multiple of 4 (16-byte row strides) and x's base
// 16-byte aligned; ops/bulge.py sends every other fp32 call to bulge.cu.

namespace wgf {

constexpr int TW = 32;            // y columns of a work item
constexpr int XC = 44;            // box columns: x columns c0-4 .. c0+39
constexpr int XO = 3;             // box column of x column c0-1
constexpr int SR = 8;             // the stats kernel's band rows
constexpr int NTH = 256;          // the stats kernel's two warpgroups
static_assert((XC * 4) % 16 == 0 && (XO + 1) * 4 == 16 && XO + TW + 2 <= XC,
              "box geometry: origin c0 - 4, a multiple of 4 columns");

// The main kernel's band rows: 4 at Ci 32, where 8 rows' buffers do not fit.
template <int CI>
__host__ __device__ constexpr int main_rows() { return CI >= 32 ? 4 : 8; }
// k-steps an A register set holds (two sets alternate): as many as the
// registers take (ptxas -v: the stats kernel at Ci 32 uses all 255 at 4)
template <int CI>
__host__ __device__ constexpr int kchunk() { return CI >= 32 ? 4 : 2; }
template <int CI>
__host__ __device__ constexpr int main_kchunk() { return CI >= 32 ? 4 : 2; }
// the main kernel's warpgroups: three at Ci 32 (one a stage-1 tile), two at
// Ci 16 (two blocks an SM)
template <int CI>
__host__ __device__ constexpr int main_wgs() { return CI >= 32 ? 3 : 2; }

template <int R>
struct Geo {
  static constexpr int XR = R + 2;              // box rows: r0-1 .. r0+R
  static constexpr int PLANE = XR * XC;         // box floats a channel
  static constexpr int PC = TW + 1;             // position columns
  static constexpr int NPOS = (R + 1) * PC;     // positions of an item
  static constexpr int M1T = (NPOS + 63) / 64;  // stage-1 m64 tiles
  static constexpr int M2T = R * TW / 64;       // stage-2 m64 tiles
  static_assert(PLANE % 32 == 8 || PLANE % 32 == 24,
                "a fragment load's four channels in disjoint banks");
};

// Item idx -> (image, band of R rows, chunk), chunk fastest (ops/bulge_mma.py
// Schedule(rows=R).item is the same map).  Every thread decodes every item
// of its block, so the divisions are 32-bit where the index allows (a
// 64-bit division is a long emulated sequence).
template <int R>
__device__ __forceinline__ wg::Item decode(long long idx, int nbands,
                                           int nchunks) {
  wg::Item it;
  if (idx < 0x100000000LL) {
    const uint32_t i = (uint32_t)idx, rest = i / (uint32_t)nchunks;
    const uint32_t b = rest / (uint32_t)nbands;
    it.c0 = (int)(i - rest * (uint32_t)nchunks) * TW;
    it.b = (int)b;
    it.r0 = (int)(rest - b * (uint32_t)nbands) * R;
    return it;
  }
  const long long rest = idx / nchunks;
  it.c0 = (int)(idx - rest * nchunks) * TW;
  it.b = (int)(rest / nbands);
  it.r0 = (int)(rest - (long long)it.b * nbands) * R;
  return it;
}

// a = hi + lo exactly: hi keeps a's upper 19 bits (a TF32 value), lo is the
// fp32 remainder, of which the tensor cores read a TF32 value in turn.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d (m64 x N, fp32) += a (m64 x k8, tf32, registers) * B (k8 x N, tf32,
// shared memory at `b`, K-major).  Thread (warp w of the warpgroup, lane
// g*4 + t) holds A[16w + g][t], A[16w+g+8][t], A[16w+g][t+4],
// A[16w+g+8][t+4], as mma.m16n8k8 does for its warp.
template <int N>
struct Tf32;

template <>
struct Tf32<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Tf32<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Tf32<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Keeps a set of A registers live (and unmoved) up to this point: wgmma
// reads them asynchronously until its group has completed.
template <int KC>
__device__ __forceinline__ void keep(uint32_t (&h)[KC][4],
                                     uint32_t (&l)[KC][4]) {
#pragma unroll
  for (int ks = 0; ks < KC; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" : "+r"(h[ks][e]), "+r"(l[ks][e])::"memory");
}

// U m64 x N products of this warpgroup, one after another: unit u is
// d_u = A_u (m64 x 8 KS) @ B_u, each k-step three TF32 products (lo*hi,
// hi*lo, hi*hi) into fp32 accumulators.  A comes from registers in chunks
// of KC k-steps; two register sets alternate, so chunk c+1 is loaded and
// issued before chunk c is waited for (two wgmma groups in flight), and
// unit u's epilogue runs while the chunks after its last one run.
// load(u, ks, v): the thread's four fp32 A values of k-step ks of unit u
// (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4] of its warp's 16 rows);
// bstart(u): shared address of unit u's k-step 0 in B's hi plane (k-step ks
// 2 * LBO bytes on, leading byte offset LBO, stride 128), whose lo plane
// lies LO_OFF bytes on; epi(u, d): unit u's finished tile; loaded(): right
// after the last A load (what A was read from may then be overwritten).
// A k-step's descriptors are one integer add from the unit's.
template <int N, int KS, int KC, int U, uint32_t LBO, uint32_t LO_OFF,
          class Load, class BStart, class Epi, class Loaded>
__device__ __forceinline__ void chain(Load load, BStart bstart, Epi epi,
                                      Loaded loaded) {
  static_assert(KS % KC == 0, "whole chunks");
  constexpr int CPU = KS / KC, C = U * CPU;
  float d[U][N / 2];
  uint32_t ah[2][KC][4], al[2][KC][4];
  auto fill = [&](int c) {
    const int u = c / CPU, s = c & 1;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float v[4];
      load(u, (c % CPU) * KC + kk, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], ah[s][kk][e], al[s][kk][e]);
    }
  };
  auto issue = [&](int c) {
    const int u = c / CPU, s = c & 1;
    if (c % CPU == 0) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[u][i] = 0.f;
    }
    wg::fence_acc<N>(d[u]);
    wg::wg_fence();
    // the low word of the descriptor of k-step 0 (start address, leading
    // byte offset); its high word is the stride, 128 bytes
    const uint32_t d0 = wg::launder(
        (uint32_t)wg::desc(bstart(u), LBO, 128));
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const uint32_t dh = d0 + (((c % CPU) * KC + kk) * 2 * LBO >> 4);
      const uint64_t bh = (uint64_t)(128 >> 4) << 32 | dh;
      const uint64_t bl = (uint64_t)(128 >> 4) << 32 | (dh + (LO_OFF >> 4));
      Tf32<N>::run(d[u], al[s][kk], bh);
      Tf32<N>::run(d[u], ah[s][kk], bl);
      Tf32<N>::run(d[u], ah[s][kk], bh);
    }
    wg::wg_commit();
  };
  auto finish = [&](int c) {      // the epilogue of the unit chunk c ends
    if (c % CPU == CPU - 1) {
      wg::fence_acc<N>(d[c / CPU]);
      epi(c / CPU, d[c / CPU]);
    }
  };
  fill(0);
  if (C == 1) loaded();
  issue(0);
#pragma unroll
  for (int c = 1; c < C; ++c) {
    if (c >= 2) {
      wg::wg_wait1();               // chunk c-2 complete: its set is free
      keep<KC>(ah[c & 1], al[c & 1]);
    }
    fill(c);
    if (c == C - 1) loaded();
    issue(c);
    if (c >= 2) finish(c - 2);
  }
  wg::wg_wait0();
  keep<KC>(ah[0], al[0]);
  keep<KC>(ah[1], al[1]);
#pragma unroll
  for (int c = C >= 2 ? C - 2 : 0; c < C; ++c) finish(c);
}

// Stage 1's A: row q of tile mt is position q = pi * PC + pj (the rows from
// NPOS on are computed on position NPOS-1 and never used); k = tap*CI + ci,
// tap = ti*2 + tj reads box[ci][pi + ti][XO + pj + tj].
template <int CI, int R>
__device__ __forceinline__ void load_x(const float* box, int mt, int ks,
                                       int w, int g, int t, float (&a)[4]) {
  using Gm = Geo<R>;
  const int q0 = min(mt * 64 + 16 * w + g, Gm::NPOS - 1);
  const int q1 = min(mt * 64 + 16 * w + g + 8, Gm::NPOS - 1);
  const int b0 = (q0 / Gm::PC) * XC + q0 % Gm::PC + XO + t * Gm::PLANE;
  const int b1 = (q1 / Gm::PC) * XC + q1 % Gm::PC + XO + t * Gm::PLANE;
  const int kb = ks * 8, tap = kb / CI, ci0 = kb % CI;
  const int off = ci0 * Gm::PLANE + (tap >> 1) * XC + (tap & 1);
  a[0] = box[b0 + off];
  a[1] = box[b1 + off];
  a[2] = box[b0 + off + 4 * Gm::PLANE];
  a[3] = box[b1 + off + 4 * Gm::PLANE];
}

// The x box of item idx into dst, completing on bar: one thread issues it,
// once the box's last reader has released dst.
template <int R>
__device__ __forceinline__ void load_box(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, uint32_t bytes,
                                         long long idx, int nbands,
                                         int nchunks) {
  const wg::Item m = decode<R>(idx, nbands, nchunks);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  wg::mbar_expect_tx(bar, bytes);
  wg::tma_load_box(dst, map, bar, m.c0 - XO - 1, m.r0 - 1, m.b);
}

// ---- the stats kernel ----------------------------------------------------------

template <int CI, int CM>
struct StatsSmem {
  static constexpr int STAGES = 2;
  static constexpr size_t W1P = (size_t)16 * CI * CM * 4;  // a plane of W1
  static constexpr size_t BOX = (size_t)CI * Geo<SR>::PLANE * 4;
  // per warpgroup, two items: [warp][column][sum, sum of squares]
  static constexpr size_t RED = (size_t)2 * 2 * 4 * 4 * CM * 2 * 4;
  static constexpr size_t o_ring = wg::al128(2 * W1P);
  static constexpr size_t o_red = o_ring + STAGES * wg::al128(BOX);
  static constexpr size_t o_bar = o_red + wg::al128(RED);
  static constexpr size_t bytes = o_bar + 8 * 2 * STAGES;
};

// partial[idx][0][cm] = sum, partial[idx][1][cm] = sum of squares of the
// hidden cells item idx owns (even parities at local positions [0, 8) x
// [0, 32), odd ones at [1, 8] x [1, 32], clipped to the image), in fp32 from
// the fp32 accumulators.
template <int CI, int CM>
__global__ void __launch_bounds__(NTH, (CI <= 16 ? 2 : 1))
stats_kernel(const __grid_constant__ CUtensorMap xmap,
             const float* __restrict__ w1, float* __restrict__ partial, int H,
             int W, int nbands, int nchunks, long long n_items) {
  using S = StatsSmem<CI, CM>;
  using Gs = Geo<SR>;
  constexpr int N1 = 4 * CM, K1S = CI / 2, NJ = N1 / 8, KC = kchunk<CI>();
  static_assert(CM % 8 == 0 && CI % 8 == 0, "channels");
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + S::o_red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::o_bar);
  uint64_t* empty = full + S::STAGES;

  // the warp index through a shuffle, so that the compiler knows the role
  // branches below to be warp-uniform
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  wg::stage_weights(smem, w1, (int)(2 * S::W1P), tid, NTH);
  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // the first item of each warpgroup; warpgroup v refills its slot
  if (tid == 0)
    for (int s = 0; s < S::STAGES; ++s) {
      const long long idx = blockIdx.x + (long long)s * gridDim.x;
      if (idx < n_items)
        load_box<SR>(&xmap, smem + S::o_ring + s * wg::al128(S::BOX), &full[s],
                     (uint32_t)S::BOX, idx, nbands, nchunks);
    }

  const int g = lane >> 2, t = lane & 3;
  const int v = warp >> 2, w = warp & 3, wt = tid & 127;
  const uint32_t w1_s = wg::smem_u32(smem);
  // red[v][buf][warp][column][sum, squares]
  auto slot = [&](int buf, int ww, int col, int k) {
    return ((((v * 2 + buf) * 4 + ww) * N1 + col) * 2) + k;
  };
  int k = 0;
  for (long long idx = blockIdx.x + (long long)v * gridDim.x; idx < n_items;
       idx += 2 * (long long)gridDim.x, ++k) {
    const wg::Item m = decode<SR>(idx, nbands, nchunks);
    const int it = 2 * k + v, sl = it % S::STAGES, buf = k & 1;
    const float* box =
        reinterpret_cast<const float*>(smem + S::o_ring + sl * wg::al128(S::BOX));
    float s[NJ][2][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) s[j][c][0] = s[j][c][1] = 0.f;
    wg::mbar_wait(&full[sl], (it / S::STAGES) & 1);
    chain<N1, K1S, KC, Gs::M1T, N1 / 8 * 128, (uint32_t)S::W1P>(
        [&](int mt, int ks, float (&a)[4]) {
          load_x<CI, SR>(box, mt, ks, w, g, t, a);
        },
        [&](int) { return w1_s; },
        [&](int mt, float (&d)[N1 / 2]) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = mt * 64 + 16 * w + g + 8 * i;
            const int pi = q / Gs::PC, pj = q - pi * Gs::PC;
            // does this item own the cell of parity (di, dj) here
            bool row_own[2], col_own[2];
#pragma unroll
            for (int dd = 0; dd < 2; ++dd) {
              row_own[dd] = q < Gs::NPOS && pi - dd >= 0 && pi - dd < SR &&
                            m.r0 + pi - dd < H;
              col_own[dd] = pj - dd >= 0 && pj - dd < TW &&
                            m.c0 + pj - dd < W;
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int par = (8 * j) / CM;
              const bool own = row_own[par >> 1] && col_own[par & 1];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float x = own ? d[4 * j + 2 * i + c] : 0.f;
                s[j][c][0] += x;
                s[j][c][1] = fmaf(x, x, s[j][c][1]);
              }
            }
          }
        },
        [&] {
          // the box is read: the warpgroup's next item goes into its slot
          wg::mbar_arrive(&empty[sl]);
          const long long next = idx + 2 * (long long)gridDim.x;
          if (wt == 0 && next < n_items) {
            wg::mbar_wait(&empty[sl], k & 1);
            load_box<SR>(&xmap, smem + S::o_ring + sl * wg::al128(S::BOX),
                         &full[sl], (uint32_t)S::BOX, next, nbands, nchunks);
          }
        });
    // over the 8 row lanes of a column (lanes with equal t)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          float x = s[j][c][kk];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if (g == 0) red[slot(buf, w, 8 * j + 2 * t + c, kk)] = x;
        }
    wg::named_sync(1 + v, 128);   // this warpgroup's sums of the item are in
    // channel cm sums its four parity columns n = par*CM + cm over the
    // warpgroup's warps, in a fixed order
    if (wt < 2 * CM) {
      const int kk = wt / CM, cm = wt - kk * CM;
      float sum = 0.f;
#pragma unroll
      for (int par = 0; par < 4; ++par)
#pragma unroll
        for (int ww = 0; ww < 4; ++ww)
          sum += red[slot(buf, ww, par * CM + cm, kk)];
      partial[((size_t)idx * 2 + kk) * CM + cm] = sum;
    }
  }
}

// ---- the main kernel -----------------------------------------------------------

template <int CI, int CM, int CO>
struct MainSmem {
  using Gm = Geo<main_rows<CI>()>;
  static constexpr size_t W1P = (size_t)16 * CI * CM * 4;  // a plane of W1
  static constexpr size_t W2P = (size_t)16 * CM * CO * 4;  // a plane of W2
  static constexpr size_t BOX = (size_t)CI * Gm::PLANE * 4;
  static constexpr size_t HP = (size_t)4 * CM * Gm::NPOS * 4;
  static constexpr size_t BN = (size_t)4 * CM * 2 * 4;     // [n][gain, shift]
  static constexpr size_t o_w2 = wg::al128(2 * W1P);
  static constexpr size_t o_box = o_w2 + wg::al128(2 * W2P);
  static constexpr size_t o_hp = o_box + wg::al128(BOX);
  static constexpr size_t o_bn = o_hp + wg::al128(HP);
  static constexpr size_t o_bar = o_bn + wg::al128(BN);
  static constexpr size_t bytes = o_bar + 8;
};

template <int CI, int CM, int CO>
__global__ void __launch_bounds__(128 * main_wgs<CI>(), (CI <= 16 ? 2 : 1))
main_kernel(const __grid_constant__ CUtensorMap xmap,
            const float* __restrict__ w1, const float* __restrict__ w2,
            const float* __restrict__ mu, const float* __restrict__ gain,
            const float* __restrict__ beta, float* __restrict__ y, int H,
            int W, int nbands, int nchunks, long long n_items) {
  constexpr int R = main_rows<CI>();
  using Gm = Geo<R>;
  using S = MainSmem<CI, CM, CO>;
  constexpr int N1 = 4 * CM, K1S = CI / 2;        // stage 1: n, k-steps
  constexpr int N2 = CO, K2S = 2 * CM;            // stage 2: 16 CM / 8
  constexpr int KC = main_kchunk<CI>(), CG = CM / 8;
  constexpr int NWG = main_wgs<CI>(), NT = 128 * NWG;
  // stage-1 tiles: warpgroup v takes tiles v, v + NWG, ...: at Ci 32 one
  // each, at Ci 16 (5 tiles) 3 and 2; stage 2: warpgroups 0 and 1 take
  // tiles v, v + 2, ...
  constexpr int FT0 = (Gm::M1T + NWG - 1) / NWG, FT1 = Gm::M1T / NWG;
  constexpr int U2 = Gm::M2T / 2;
  constexpr uint32_t LBO1 = N1 / 8 * 128, LBO2 = N2 / 8 * 128;
  static_assert(CM % 8 == 0 && CO % 16 == 0 && CI % 8 == 0 &&
                Gm::M2T % 2 == 0 && FT1 >= 1 && Gm::M1T % NWG < 2 &&
                N1 % 32 == 0, "shapes");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::o_bar);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  wg::stage_weights(smem, w1, (int)(2 * S::W1P), tid, NT);
  wg::stage_weights(smem + S::o_w2, w2, (int)(2 * S::W2P), tid, NT);
  if (tid == 0) {
    wg::mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (tid == 0)
    load_box<R>(&xmap, smem + S::o_box, full, (uint32_t)S::BOX, blockIdx.x,
                nbands, nchunks);

  const int g = lane >> 2, t = lane & 3;
  const int v = warp >> 2, w = warp & 3;
  const uint32_t w1_s = wg::smem_u32(smem);
  const uint32_t w2_s = wg::smem_u32(smem + S::o_w2);
  const float* box = reinterpret_cast<const float*>(smem + S::o_box);
  float* hp = reinterpret_cast<float*>(smem + S::o_hp);
  float* bn = reinterpret_cast<float*>(smem + S::o_bn);
  const size_t y_img = (size_t)CO * H * W;
  // stage 1's column n = tid < N1 (cm = n % CM): h = acc * gain + shift,
  // shift = beta - mu * gain.  Thread n reads an item's gain and mean one
  // item ahead, so that no warpgroup waits on the loads.
  const float beta_n = tid < N1 ? beta[tid % CM] : 0.f;
  float gain_n = 0.f, mu_n = 0.f;
  if (tid < N1) {
    const size_t at = (size_t)decode<R>(blockIdx.x, nbands, nchunks).b * CM;
    gain_n = gain[at + tid % CM];
    mu_n = mu[at + tid % CM];
  }

  int it = 0;
  for (long long idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++it) {
    const wg::Item m = decode<R>(idx, nbands, nchunks);
    // the item's BN table (read after the barrier in the first epilogue;
    // the last item's epilogues passed the barrier after stage 1)
    if (tid < N1) {
      bn[2 * tid] = gain_n;
      bn[2 * tid + 1] = fmaf(-mu_n, gain_n, beta_n);
      if (idx + gridDim.x < n_items) {
        const size_t at =
            (size_t)decode<R>(idx + gridDim.x, nbands, nchunks).b * CM;
        gain_n = gain[at + tid % CM];
        mu_n = mu[at + tid % CM];
      }
    }
    wg::mbar_wait(full, it & 1);

    // normalise, rectify, zero outside the image and store stage-1 tile
    // mt's columns n0 .. n0 + (N of d)
    auto store = [&](int mt, int n0, auto& d) {
      constexpr int NJ =
          std::extent<std::remove_reference_t<decltype(d)>>::value / 4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = mt * 64 + 16 * w + g + 8 * i;
        if (q >= Gm::NPOS) continue;
        const int pi = q / Gm::PC, pj = q - pi * Gm::PC;
        bool row_in[2], col_in[2];
#pragma unroll
        for (int dd = 0; dd < 2; ++dd) {
          row_in[dd] = (unsigned)(m.r0 - dd + pi) < (unsigned)H;
          col_in[dd] = (unsigned)(m.c0 - dd + pj) < (unsigned)W;
        }
#pragma unroll
        for (int j2 = 0; j2 < NJ; ++j2) {
          const int n = n0 + 8 * j2;
          const int par = n / CM, cg = (n % CM) / 8;
          const bool in = row_in[par >> 1] && col_in[par & 1];
          const float4 gs =
              *reinterpret_cast<const float4*>(bn + 2 * (n + 2 * t));
          float2 o;
          o.x = in ? fmaxf(fmaf(d[4 * j2 + 2 * i], gs.x, gs.y), 0.f) : 0.f;
          o.y = in ? fmaxf(fmaf(d[4 * j2 + 2 * i + 1], gs.z, gs.w), 0.f)
                   : 0.f;
          *reinterpret_cast<float2*>(
              hp + ((par * CG + cg) * Gm::NPOS + q) * 8 + 2 * t) = o;
        }
      }
    };
    // ---- stage 1: tiles v, v + NWG, ... into the hidden planes ----
    auto stage1 = [&](auto units) {
      chain<N1, K1S, KC, decltype(units)::value, LBO1, (uint32_t)S::W1P>(
          [&](int j, int ks, float (&a)[4]) {
            load_x<CI, R>(box, v + NWG * j, ks, w, g, t, a);
          },
          [&](int) { return w1_s; },
          [&](int j, float (&d)[N1 / 2]) {
            // the last item's stage 2 has read the hidden planes
            if (j == 0) wg::named_sync(1, NT);
            store(v + NWG * j, 0, d);
          },
          [] {});
    };
    if constexpr (FT0 == FT1) {
      stage1(std::integral_constant<int, FT0>());
    } else {
      if (v < Gm::M1T % NWG)
        stage1(std::integral_constant<int, FT0>());
      else
        stage1(std::integral_constant<int, FT1>());
    }
    wg::named_sync(2, NT);        // the hidden planes are complete
    // and the box is read: the next item's box loads during stage 2 (and a
    // third warpgroup starts its next stage-1 tile as soon as it is in)
    if (tid == 0 && idx + gridDim.x < n_items)
      load_box<R>(&xmap, smem + S::o_box, full, (uint32_t)S::BOX,
                  idx + gridDim.x, nbands, nchunks);
    if (v >= 2) continue;

    // ---- stage 2: tiles v, v+2, ... (two y rows each) from the planes ----
    chain<N2, K2S, KC, U2, LBO2, (uint32_t)S::W2P>(
        [&](int j, int ks, float (&a)[4]) {
          // k = tap*CM + cm, tap = a*4 + c: plane ((a+1)&1, (c+1)&1) at
          // (ml + a/2, nl + c/2); logical k (t, t+4) = channels (2t, 2t+1)
          const int p = (v + 2 * j) * 64 + 16 * w + g;
          const int pos = (p >> 5) * Gm::PC + (p & 31);
          const int kb = ks * 8, tap = kb / CM, cg = (kb % CM) / 8;
          const int ta = tap >> 2, tc = tap & 3;
          const int par = ((ta + 1) & 1) * 2 + ((tc + 1) & 1);
          const float* src = hp + ((par * CG + cg) * Gm::NPOS + pos +
                                   (ta >> 1) * Gm::PC + (tc >> 1)) * 8 + 2 * t;
          const float2 r0 = *reinterpret_cast<const float2*>(src);
          const float2 r1 = *reinterpret_cast<const float2*>(src + 64);
          a[0] = r0.x;
          a[1] = r1.x;
          a[2] = r0.y;
          a[3] = r1.y;
        },
        [&](int) { return w2_s; },
        [&](int j, float (&d)[N2 / 2]) {
          float* yb = y + (size_t)m.b * y_img;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int p = (v + 2 * j) * 64 + 16 * w + g + 8 * i;
            const int row = m.r0 + (p >> 5), col = m.c0 + (p & 31);
            if (row < H && col < W) {
              float* yp = yb + (size_t)row * W + col;
#pragma unroll
              for (int j2 = 0; j2 < N2 / 8; ++j2)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                  yp[(size_t)(8 * j2 + 2 * t + c) * H * W] =
                      d[4 * j2 + 2 * i + c];
            }
          }
        },
        [] {});
  }
}

// ---- the layout probe ----------------------------------------------------------

// d (64 x 32) = A (64 x 16) @ B (16 x 32) by two k-steps of m64n32k8 .tf32
// with A from registers as the kernels load it, unsplit, and B staged as
// given (to_wgmma_tf32's layout, k-step ks at ks * 2 * leading bytes): what
// the card computes from raw fp32 words pins the core-matrix layout and
// how the tensor cores read an fp32 word as TF32.  One warpgroup.
__global__ void tf32_probe_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ d) {
  __shared__ __align__(128) float bs[16 * 32];
  const int tid = threadIdx.x;
  for (int k = tid; k < 16 * 32; k += 128) bs[k] = b[k];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g, r1 = r0 + 8;
  uint32_t av[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    av[ks][0] = __float_as_uint(a[r0 * 16 + ks * 8 + t]);
    av[ks][1] = __float_as_uint(a[r1 * 16 + ks * 8 + t]);
    av[ks][2] = __float_as_uint(a[r0 * 16 + ks * 8 + t + 4]);
    av[ks][3] = __float_as_uint(a[r1 * 16 + ks * 8 + t + 4]);
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  const uint32_t lbo = 32 / 8 * 128, b_s = wg::smem_u32(bs);
  wg::fence_acc<32>(acc);
  wg::wg_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    Tf32<32>::run(acc, av[ks], wg::desc(b_s + ks * 2 * lbo, lbo, 128));
  wg::wg_commit();
  wg::wg_wait0();
  wg::fence_acc<32>(acc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        d[(16 * w + g + 8 * i) * 32 + 8 * j + 2 * t + c] = acc[4 * j + 2 * i + c];
}

// ---- launch -------------------------------------------------------------------------

inline bool takes(const void* x, int W) {
  return W % 4 == 0 && ((uintptr_t)x & 15) == 0;
}

// The 4-D map over x (B, CI, H, W) fp32, innermost first: box XC x rows x
// CI x 1; out-of-image elements read as zero.  Returns 0 or a negative code.
inline int encode_x(CUtensorMap* map, const void* x, int B, int ci, int H,
                    int W, int rows) {
  const wg::EncodeTiled fn = wg::encoder();
  if (fn == nullptr) return wg::kNoEntryPoint;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)ci,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4,
                                 (cuuint64_t)ci * H * W * 4};
  const cuuint32_t box[4] = {XC, (cuuint32_t)rows, (cuuint32_t)ci, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(x), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1 - (int)r;
}

template <int CI, int CM, int CO>
int launch_main(const void* x, const float* w1, const float* w2,
                const float* mu, const float* gain, const float* beta,
                float* y, int B, int H, int W, int n_sm, cudaStream_t stream) {
  constexpr int R = main_rows<CI>();
  const int nbands = (H + R - 1) / R, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  if (!takes(x, W)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int enc = encode_x(&map, x, B, CI, H, W, R + 2);
  if (enc != 0) return enc;
  const size_t smem = MainSmem<CI, CM, CO>::bytes;
  int grid = 0;
  constexpr int nt = 128 * main_wgs<CI>();
  cudaError_t e = wg::persistent_grid(main_kernel<CI, CM, CO>, nt, smem,
                                      n_sm, n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  main_kernel<CI, CM, CO><<<grid, nt, smem, stream>>>(
      map, w1, w2, mu, gain, beta, y, H, W, nbands, nchunks, n_items);
  return (int)cudaGetLastError();
}

template <int CI, int CM>
int launch_stats(const void* x, const float* w1, float* partial, int B,
                 int H, int W, int n_sm, cudaStream_t stream) {
  const int nbands = (H + SR - 1) / SR, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  if (!takes(x, W)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int enc = encode_x(&map, x, B, CI, H, W, SR + 2);
  if (enc != 0) return enc;
  const size_t smem = StatsSmem<CI, CM>::bytes;
  int grid = 0;
  cudaError_t e = wg::persistent_grid(stats_kernel<CI, CM>, NTH, smem, n_sm,
                                      n_items, &grid);
  if (e != cudaSuccess) return (int)e;
  stats_kernel<CI, CM><<<grid, NTH, smem, stream>>>(
      map, w1, partial, H, W, nbands, nchunks, n_items);
  return (int)cudaGetLastError();
}

}  // namespace wgf

extern "C" {

// Work-item geometry (must equal bulge.cu's: the statistics slots are the
// same) and the box the tensor map loads.
int bulge_wgmma_band_rows() { return wg::R; }
int bulge_wgmma_chunk_cols() { return wg::TW; }
int bulge_wgmma_box_rows() { return wg::XR; }
int bulge_wgmma_box_cols() { return wg::XC; }

// Channel triples with an instantiation: (16, 8, 16) and (32, 16, 32).
int bulge_wgmma_supported(int ci, int cm, int co) {
  return ci == 2 * cm && co == 2 * cm && (cm == 8 || cm == 16);
}

// The tensor map's host cost: encode one for x (B, ci, H, W) bf16 `reps`
// times; returns 0 or the negative code of a failed encode.
int bulge_wgmma_encode(const void* x, int B, int ci, int H, int W, int reps) {
  CUtensorMap map;
  for (int k = 0; k < reps; ++k) {
    const int e = wg::encode_x(&map, x, B, ci, H, W);
    if (e != 0) return e;
  }
  return 0;
}

// x bf16 (B, ci, H, W); w1: W1 (4 ci x 4 cm) bf16 in the canonical K-major
// core-matrix order (ops/bulge_mma.py to_wgmma_bf16).
int bulge_wgmma_stats_bf16(const void* x, const void* w1, float* partial,
                           int B, int ci, int cm, int H, int W, int n_sm,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* w = (const uint16_t*)w1;
  if (!bulge_wgmma_supported(ci, cm, 2 * cm)) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 8: return wg::launch_stats<16, 8>(x, w, partial, B, H, W, n_sm, s);
    case 16: return wg::launch_stats<32, 16>(x, w, partial, B, H, W, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w2: W2 (16 cm x co) in the same order; mu, gain (B, cm), beta (cm) fp32;
// y bf16 (B, co, H, W).
int bulge_wgmma_main_bf16(const void* x, const void* w1, const void* w2,
                          const float* mu, const float* gain,
                          const float* beta, void* y, int B, int ci, int cm,
                          int co, int H, int W, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* a = (const uint16_t*)w1;
  const uint16_t* b = (const uint16_t*)w2;
  uint16_t* yb = (uint16_t*)y;
  if (!bulge_wgmma_supported(ci, cm, co)) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 8: return wg::launch_main<16, 8, 16>(x, a, b, mu, gain, beta, yb, B, H, W, n_sm, s);
    case 16: return wg::launch_main<32, 16, 32>(x, a, b, mu, gain, beta, yb, B, H, W, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- fp32 (namespace wgf) ----

// Band rows of the fp32 main kernel's work items at Ci (its stats kernel's
// are bulge_wgmma_band_rows'), and the fp32 box's columns and the box
// column of x column c0-1.
int bulge_wgmma_f32_main_rows(int ci) {
  return ci >= 32 ? wgf::main_rows<32>() : wgf::main_rows<16>();
}
int bulge_wgmma_f32_box_cols() { return wgf::XC; }
int bulge_wgmma_f32_box_col0() { return wgf::XO; }

// x fp32 (B, ci, H, W); w1: W1 (4 ci x 4 cm) as two fp32 planes (hi, lo) in
// wgmma's K-major core-matrix order (ops/bulge_mma.py to_wgmma_tf32).
int bulge_wgmma_stats_f32(const void* x, const void* w1, float* partial,
                          int B, int ci, int cm, int H, int W, int n_sm,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = (const float*)w1;
  if (!bulge_wgmma_supported(ci, cm, 2 * cm)) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 8: return wgf::launch_stats<16, 8>(x, w, partial, B, H, W, n_sm, s);
    case 16: return wgf::launch_stats<32, 16>(x, w, partial, B, H, W, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// w2: W2 (16 cm x co), its rows permuted within each k-step of 8, as two
// planes in the same order; mu, gain (B, cm), beta (cm) fp32; y fp32
// (B, co, H, W).
int bulge_wgmma_main_f32(const void* x, const void* w1, const void* w2,
                         const float* mu, const float* gain,
                         const float* beta, void* y, int B, int ci, int cm,
                         int co, int H, int W, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)w1;
  const float* b = (const float*)w2;
  float* yf = (float*)y;
  if (!bulge_wgmma_supported(ci, cm, co)) return (int)cudaErrorInvalidValue;
  switch (cm) {
    case 8: return wgf::launch_main<16, 8, 16>(x, a, b, mu, gain, beta, yf, B, H, W, n_sm, s);
    case 16: return wgf::launch_main<32, 16, 32>(x, a, b, mu, gain, beta, yf, B, H, W, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// d (64 x 32) = a (64 x 16) @ b (to_wgmma_tf32 of a 16 x 32 matrix) on the
// tensor cores, the fp32 words passed unsplit (wgf::tf32_probe_kernel).
int bulge_wgmma_tf32_probe(const float* a, const float* b, float* d,
                           void* stream) {
  wgf::tf32_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a, b, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
