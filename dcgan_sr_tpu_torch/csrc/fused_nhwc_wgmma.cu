// Fused convT(k4s2p1) + BatchNorm + ReLU + conv(k4s2p1), channels-last, on
// Hopper's own units (sm_90a): TMA under mbarriers, wgmma.mma_async with
// both operands in shared memory.  One skeleton, two dtypes: fp32 as 3xTF32
// (namespace wgf) and bf16 (namespace wgb); only the products differ.
//
// Replaces the TPU kernel dcgan_sr_tpu/ops/pallas_fused.py
// fused_convT_bn_relu_conv (_stats_kernel :98, _main_kernel :119), the NHWC
// draft of the pair, and computes what csrc/fused_nhwc.cu's mma.sync kernels
// compute (namespace tc in fp32, tcb in bf16): stage 1 is ONE product over
// K = 4 Ci of each position's 2x2 window against the packed wtall (4 Ci x
// 4 Cm), all four output parities at once; BN, ReLU and the consumer's edge
// mask run in fp32 on the accumulators; stage 2 is ONE product over K =
// 16 Cm of 16 shifted parity windows against wcall (16 Cm x Co).  fp32:
// every product is three TF32 products, lo*hi + hi*lo + hi*hi, with fp32
// accumulators.  bf16: the weights rounded to bf16 (pallas_fused.py
// :193-194), the hidden planes rounded to bf16 before stage 2 (:153), y
// bf16.  Statistics are one fp32 (sum, sum of squares) slot per stats work
// item, no atomics; the host reduces them in fp64 in a fixed order.  Any
// batch, H and W; the JAX contract H % tm == 0 is the wrapper's check (tm
// decides nothing here: the edge mask depends on the image's edges only).
//
// Bounds on an H100 SXM at bench_fused's shape, x (100, 16, 256, 256), Cm 8,
// Co 16: the two products are 27.5 + 54.3 GFLOP.  fp32 at the 3xTF32 rate
// (495 / 3 = 165 TFLOP/s): stats 0.1665 ms, main 0.3292 ms, both bound by
// operations (bytes: 0.125 / 0.250 ms).  bf16 (989 TFLOP/s; HBM 3.35 TB/s):
// stats 0.0631 ms, main 0.1252 ms, both bound by bytes (x read, y written).
//
// What the design does about it:
// 1. x arrives by TMA straight into wgmma's K-major layout.  One 4-D
//    tensor map per 16-byte channel group g over NHWC x (B, H, W, Ci):
//    dimensions (the group's 16 bytes, W, H, B), strides (Ci, W Ci, H W Ci)
//    elements (increasing, as the encoder's examples have them), base x +
//    16 g bytes; the box (16 bytes, BC = TW+2 columns, XR = R+2 rows, 1)
//    from (c0-1, r0-1) lands as plane g of box[group][row][column][16
//    bytes], which is the canonical no-swizzle K-major layout: a core
//    matrix is 8 consecutive positions of one group.  A plane takes a
//    multiple of 128 bytes, so every TMA lands 128-byte aligned.  The halo
//    and the image's edges are zero-filled by the hardware; the innermost
//    coordinate is always 0, so no column offset has to fall on a 16-byte
//    boundary (K2's bf16 box had to start 8 columns left).  The price: a
//    box row is 16 bytes, so the TMA unit moves a box as Ci/e x BC x XR
//    pieces of 16 bytes, and it takes about two cycles a piece on an SM: at
//    bench_fused's shape the bf16 stats launch is bound by it (ablation
//    skeleton 0.158 ms against skeleton_no_tma 0.052 ms, NVIDIA H100 80GB
//    HBM3 at 700 W).  The alternative, one map with Ci innermost (32- to
//    128-byte rows) and a swizzle, would start the tj = 1 tap's descriptor
//    one row into a swizzle atom (the descriptor's base-offset field):
//    riskier, not taken; it is the next step for this launch.
// 2. Stage 1 reads A from the box by descriptor: M rows are the box
//    positions q = pi*BC + pj flattened row by row (a uniform 128-byte
//    stride between 8-row core groups; rows with pj > TW wrap into the next
//    box row and are computed and never used: 5 m64 tiles for 297
//    positions at TW 32), a tap (ti, tj) moves the start by (ti*BC + tj)*16
//    bytes, a k-step's two core matrices are two channel groups one box
//    plane apart (the descriptor's leading offset).  No copy of x is made.
// 3. The hidden planes hp[(di, dj, group)][pi*PC + pj][16 bytes] are
//    written by the stage-1 epilogue in the same K-major layout, so stage 2
//    reads A by descriptor too: a stage-2 tile is 8 y rows x 8 y columns
//    (its 8-row core groups are y rows, PC*16 bytes apart, the stride
//    offset), a window (sa, sb) moves the start by (sa*PC + sb)*16 bytes,
//    and W2's rows are ordered (sa, sb, di, dj, cm) so that a k-step's two
//    core matrices are two planes PS*16 bytes apart.  At Cm 8 in bf16 one
//    k-step (16 channels) spans the planes of two parities.  A plane holds
//    PS positions, padded to 4 mod 8 units, so the epilogue's 8-byte
//    stores of a half warp meet no bank conflict.
// 4. fp32: the weights go to the card as (hi, lo) planes (ops/
//    fused_nhwc_wgmma.py operands); A is split in registers.  wgmma reads
//    an fp32 word as its truncation (chip_smoke.py tf32_probe_phase), which
//    is the split's hi, so hi*hi and hi*lo could read A by descriptor from
//    the box or the planes and only lo be computed (kHiByDesc).  Measured,
//    that is slower (ablation a_desc: stats 0.434 / main 1.106 ms against
//    0.407 / 0.872): every k-step then reads A from shared memory twice
//    more than it loads it, and at N = 16 to 64 that traffic, not the
//    tensor cores, bounds the products.  So each lane loads its four values
//    of a k-step once (conflict-free: a core matrix's 8 rows are 32
//    consecutive words), splits them (hi = a & 0xffffe000, lo = a - hi) and
//    issues all three products from registers.  A lo copy of the box would
//    take one more box of shared memory, which at Ci 32 the weights'
//    planes (131,072 bytes) leave no room for.
// 5. Each warpgroup of a persistent block takes every other item of the
//    block and runs it whole: its own ring of NB boxes (one thread keeps
//    the next boxes in flight), its own hidden planes, and only named
//    barriers of its 128 threads; the other warpgroup's products fill the
//    gaps of its epilogues and barriers.  A warpgroup's tiles run as a
//    chain: tile u+1's products are issued before tile u's epilogue, two
//    accumulator sets alternating (fp32: in chunks of KC k-steps, two sets
//    of A registers alternating).  ptxas allots registers by whole
//    warpgroups, so there is no producer warp: the TMA is issued by one
//    consumer thread, and the warp index comes through a shuffle so that
//    role branches are warp-uniform (a branch that is not serialises
//    wgmma).  The accumulators are fenced for the compiler only where a
//    tile starts: an asm use of them between a tile's groups made ptxas
//    inject waits.  Measured, the fp32 main launch is bound by neither the
//    tensor cores nor the TMA alone (ablation: without wgmma 0.61 ms,
//    without wgmma and TMA 0.58 ms of 0.82): at N = 16 each k-step's A
//    loads and split cost more issue slots than its three products take
//    on the tensor cores, and 8 warps an SM hide little of the latency.
// 6. y leaves the accumulators as 8-byte (fp32) or 4-byte (bf16) stores to
//    NHWC y: the four lanes of a pixel write 32 (16) contiguous bytes, so
//    every 32-byte sector is written whole by one or two stores of a warp.
//    The permute back to NCHW is the wrapper's torch call, as the JAX
//    function leaves it to XLA (pallas_fused.py:248).
//
// Work items: (image, band of R = 8 y rows, chunk of TW y columns), chunk
// fastest.  TW = 32, except the fp32 main kernel at Ci 32 (TW = 16, one
// warpgroup): there the weights' hi and lo planes take 131,072 bytes, and
// an item of 32 columns does not fit beside them.
//
// Shared memory, bytes (NB boxes a warpgroup, two warpgroups a block but
// where named; a box is its planes plus what the last tile's wrapped rows
// read past them; StatsCfg / MainCfg ::bytes):
//   stats fp32 Ci 16: W1 16,384 + 2 x 2 boxes x 22,272 + sums 4,096 +
//         barriers 32 -> 109,600 (two blocks an SM); Ci 32: 65,536 + 2 x 1
//         x 44,288 + 8,192 + 16 -> 162,320 (one block).
//   stats bf16 Ci 16: 4,096 + 4 x 11,264 + 4,096 + 32 -> 53,280; Ci 32:
//         16,384 + 4 x 22,272 + 8,192 + 32 -> 113,696.
//   main fp32 Ci 16 (TW 32): W1 + W2 32,768 + 2 x (2 x 22,272 + hidden
//         planes 8 x 300 x 16 = 38,400) + BN 256 + 32 -> 198,944 (one
//         block); Ci 32 (TW 16, one warpgroup): 131,072 + 2 x 24,064 + 16 x
//         156 x 16 = 39,936 + 512 + 16 -> 219,664.
//   main bf16 Ci 16: 8,192 + 2 x (2 x 11,264 + 4 x 300 x 16 = 19,200) +
//         256 + 32 -> 91,936 (two blocks); Ci 32: 32,768 + 2 x (2 x 22,272 +
//         38,400) + 512 + 32 -> 199,200.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/
// fused_nhwc.py).  Each entry returns the cudaError_t of its launch (0 =
// launched), or a negative value when a tensor map could not be encoded
// (-1 - CUresult, or -1000 when the driver entry point is missing).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace nhwc {

constexpr int R = 8;          // y rows of a work item
constexpr int STATS_TW = 32;  // y columns of a stats work item

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr size_t al128(size_t n) {
  return (n + 127) / 128 * 128;
}

// The geometry of an item of TW columns with CI, CM channels and E
// elements a 16-byte unit (ops/fused_nhwc_wgmma.py Geo).  Units: 16 bytes.
template <int TW, int CI, int CM, int E>
struct Geo {
  static constexpr int BC = TW + 2;               // box columns
  static constexpr int XR = R + 2;                // box rows
  static constexpr int PLANE = XR * BC;           // units a box plane holds
  static constexpr int BP = (PLANE + 7) / 8 * 8;  // ... and takes: a TMA
                                                  // lands 128-byte aligned
  static constexpr int CIG = CI / E;              // box planes
  static constexpr int LASTQ = R * BC + TW;       // last real stage-1 row
  static constexpr int M1T = (LASTQ + 64) / 64;   // stage-1 m64 tiles
  static constexpr int BOXU =
      cmax(CIG * BP, (CIG - 1) * BP + M1T * 64 + BC + 1);
  static constexpr int PC = TW + 1;               // hidden-plane columns
  static constexpr int NPOS = (R + 1) * PC;
  static constexpr int PS = NPOS + (4 - NPOS % 8 + 8) % 8;  // 4 mod 8
  static constexpr int HPN = 4 * CM / E;          // hidden planes
  static constexpr int M2T = TW / 8;              // stage-2 tiles (8 x 8)
  static constexpr int K1S = 4 * CI / (2 * E);    // k-steps of 32 bytes
  static constexpr int K2S = 16 * CM / (2 * E);
  static_assert(CIG % 2 == 0 && HPN % 2 == 0 && TW % 8 == 0, "geometry");
  static_assert(PS % 8 == 4, "hidden-plane stride 4 mod 8 units");
};

struct Item {
  int b, r0, c0;
};

// Item idx -> (image, band, chunk), chunk fastest (ops/fused_nhwc_wgmma.py
// Schedule.item).  32-bit divisions where the index allows.
template <int TW>
__device__ __forceinline__ Item decode(long long idx, int nbands,
                                       int nchunks) {
  Item it;
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

// Wait until the phase of parity `parity` of `bar` has completed; a wait of
// about 2^34 cycles (seconds) traps, so a fault ends the launch with an
// error instead of hanging the card.
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

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Box (0, c, r, b) of a 4-D map into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(0), "r"(c), "r"(r), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// One tensor map per 16-byte channel group (at most 8: fp32 at Ci 32).
constexpr int kMaxMaps = 8;
struct Maps {
  CUtensorMap m[kMaxMaps];
};

// The box of item idx (all CIG planes) into dst, completing on bar.  One
// thread issues it, once the box's readers have released dst.
template <int TW, int CIG, int PLANE, int BP>
__device__ __forceinline__ void load_box(const Maps* maps, unsigned char* dst,
                                         uint64_t* bar, long long idx,
                                         int nbands, int nchunks) {
  const Item m = decode<TW>(idx, nbands, nchunks);
  fence_async();
  mbar_expect_tx(bar, (uint32_t)(CIG * PLANE * 16));
#pragma unroll
  for (int g = 0; g < CIG; ++g)
    tma_load(dst + (size_t)g * BP * 16, &maps->m[g], bar, m.c0 - 1,
             m.r0 - 1, m.b);
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

// x through an opaque move: what is computed from it cannot be hoisted above
// this point (so an unrolled chain keeps its descriptors out of registers
// until they are used).
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
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7])
#define WG_D16                                                          \
  WG_D8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_D32                                                            \
  WG_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define WG_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_R16                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (m64 x N, fp32) += A (m64 x k16) * B (k16 x N), bf16, both in shared
// memory by descriptor.
template <int N>
struct Bf16SS;
#define WG_BF16_SS(N, NR, REGS, DOPS, A, B, P)                             \
  template <>                                                               \
  struct Bf16SS<N> {                                                        \
    static __device__ __forceinline__ void run(float (&d)[NR], uint64_t a,  \
                                               uint64_t b) {                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"         \
                   "wgmma.mma_async.sync.aligned.m64n" #N                   \
                   "k16.f32.bf16.bf16 " REGS ", %" #A ", %" #B              \
                   ", p, 1, 1, 0, 0;\n}"                                    \
                   : DOPS                                                   \
                   : "l"(a), "l"(b), "r"(1));                               \
    }                                                                       \
  };
WG_BF16_SS(16, 8, WG_R8, WG_D8, 8, 9, 10)
WG_BF16_SS(32, 16, WG_R16, WG_D16, 16, 17, 18)
WG_BF16_SS(64, 32, WG_R32, WG_D32, 32, 33, 34)

// d (m64 x N, fp32) += A (m64 x k8) * B (k8 x N), tf32, both in shared
// memory by descriptor (an fp32 word read as its truncation).
template <int N>
struct Tf32SS;
#define WG_TF32_SS(N, NR, REGS, DOPS, A, B, P)                            \
  template <>                                                              \
  struct Tf32SS<N> {                                                       \
    static __device__ __forceinline__ void run(float (&d)[NR], uint64_t a, \
                                               uint64_t b) {               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"        \
                   "wgmma.mma_async.sync.aligned.m64n" #N                  \
                   "k8.f32.tf32.tf32 " REGS ", %" #A ", %" #B              \
                   ", p, 1, 1;\n}"                                         \
                   : DOPS                                                  \
                   : "l"(a), "l"(b), "r"(1));                              \
    }                                                                      \
  };
WG_TF32_SS(16, 8, WG_R8, WG_D8, 8, 9, 10)
WG_TF32_SS(32, 16, WG_R16, WG_D16, 16, 17, 18)
WG_TF32_SS(64, 32, WG_R32, WG_D32, 32, 33, 34)

// d += a (m64 x k8, tf32, registers) * B (k8 x N, shared memory).  Thread
// (warp w of the warpgroup, lane g*4 + t) holds A[16w+g][t], A[16w+g+8][t],
// A[16w+g][t+4], A[16w+g+8][t+4].
template <int N>
struct Tf32RS;
#define WG_TF32_RS(N, NR, REGS, DOPS, A0, A1, A2, A3, B, P)                \
  template <>                                                               \
  struct Tf32RS<N> {                                                        \
    static __device__ __forceinline__ void run(float (&d)[NR],              \
                                               const uint32_t (&a)[4],      \
                                               uint64_t b) {                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"         \
                   "wgmma.mma_async.sync.aligned.m64n" #N                   \
                   "k8.f32.tf32.tf32 " REGS ", {%" #A0 ", %" #A1 ", %" #A2  \
                   ", %" #A3 "}, %" #B ", p, 1, 1;\n}"                      \
                   : DOPS                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                     "r"(1));                                               \
    }                                                                       \
  };
WG_TF32_RS(16, 8, WG_R8, WG_D8, 8, 9, 10, 11, 12, 13)
WG_TF32_RS(32, 16, WG_R16, WG_D16, 16, 17, 18, 19, 20, 21)
WG_TF32_RS(64, 32, WG_R32, WG_D32, 32, 33, 34, 35, 36, 37)

// Keeps a set of A registers live (and unmoved) up to this point: wgmma
// reads them asynchronously until its group has completed.
template <int KC>
__device__ __forceinline__ void keep(uint32_t (&a)[KC][4]) {
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

// ---- the products: the only code that differs between the two dtypes -------

// fp32: whether hi*hi and hi*lo read A by descriptor (true: wgmma reads the
// fp32 word as its truncation, so only lo is loaded) or from registers with
// lo (false).  By descriptor, each fp32 k-step reads A from shared memory
// twice more than it loads it, and at N 16-64 that traffic, not the tensor
// cores, bounds the products; the ablation's a_desc variant measures it.
constexpr bool kHiByDesc = false;

// A k-step of d (m64 x N) += A (m64 x 32 bytes of K) @ B: A by descriptor
// `ad` (bf16; fp32 with kHiByDesc) or from registers (fp32: hi, lo), B's
// (first) plane by `bd`, B's lo plane LO units further (fp32).
template <bool F32, int N, int LO>
struct Step;

template <int N, int LO>
struct Step<false, N, LO> {      // bf16: one product
  static __device__ __forceinline__ void run(float (&d)[N / 2],
                                             const uint32_t (&)[4],
                                             const uint32_t (&)[4],
                                             uint64_t ad, uint64_t bd) {
    Bf16SS<N>::run(d, ad, bd);
  }
};

template <int N, int LO>
struct Step<true, N, LO> {       // fp32: lo*hi, hi*lo, hi*hi
  static __device__ __forceinline__ void run(float (&d)[N / 2],
                                             const uint32_t (&hi)[4],
                                             const uint32_t (&lo)[4],
                                             uint64_t ad, uint64_t bd) {
    Tf32RS<N>::run(d, lo, bd);
    if constexpr (kHiByDesc) {
      Tf32SS<N>::run(d, ad, bd + LO);
      Tf32SS<N>::run(d, ad, bd);
    } else {
      Tf32RS<N>::run(d, hi, bd + LO);
      Tf32RS<N>::run(d, hi, bd);
    }
  }
};

// This thread's four A values of the k-step whose A starts at `a` (shared
// byte address), split: rows 16w+g (+8) are 8-row groups 2w (+1), sbo
// bytes apart; k t and t+4 are the two core matrices, lbo bytes apart.
// hi = a & 0xffffe000 (a TF32 value), lo = a - hi, exact in fp32.
__device__ __forceinline__ void load_split(uint32_t a, uint32_t lbo,
                                           uint32_t sbo, int w, int g, int t,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const uint32_t r0 = a + 2 * w * sbo + 16 * g + 4 * t;
  float v[4];
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[0]) : "r"(r0));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[1]) : "r"(r0 + sbo));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[2]) : "r"(r0 + lbo));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[3]) : "r"(r0 + lbo + sbo));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = __float_as_uint(v[e]) & 0xffffe000u;
    lo[e] = __float_as_uint(v[e] - __uint_as_float(hi[e]));
  }
}

// U m64 x N tiles of this warpgroup, one after another: tile u is
// d_u = A_u (m64 x KS k-steps) @ B.  A's k-step ks of tile u starts at
// shared byte address astart(u) + aoff(ks) (leading offset a_lbo, stride
// a_sbo), B's at b_base + ks * 2 * (N/8 * 128) (leading N/8 * 128, stride
// 128), B's lo plane BLO bytes further (fp32).  Tiles go in groups of KC
// k-steps; tile u+1's groups are issued before tile u's epilogue epi(u, d)
// runs, two accumulator sets alternating; fp32 keeps two sets of A
// registers, so a group is loaded and split while the one before it runs.
template <bool F32, int N, int KS, int KC, int U, uint32_t BLO, class AStart,
          class AOff, class Epi>
__device__ __forceinline__ void chain(AStart astart, AOff aoff,
                                      uint32_t a_lbo, uint32_t a_sbo,
                                      uint32_t b_base, Epi epi, int w,
                                      int lane) {
  static_assert(KS % KC == 0, "whole groups");
  constexpr int CPU = KS / KC;
  constexpr uint32_t LBO = N / 8 * 128;
  const int g = lane >> 2, t = lane & 3;
  float d[2][N / 2];
  uint32_t ah[2][KC][4], al[2][KC][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    // the high words of both descriptors are their stride offsets
    const uint32_t a0 = launder((uint32_t)desc(astart(u), a_lbo, a_sbo));
    const uint32_t b0 = launder((uint32_t)desc(b_base, LBO, 128));
    const uint64_t ahw = (uint64_t)(a_sbo >> 4) << 32;
    const uint64_t bhw = (uint64_t)(128 >> 4) << 32;
#pragma unroll
    for (int c = 0; c < CPU; ++c) {
      const int gc = u * CPU + c, s = gc & 1;
      if constexpr (F32) {
        if (gc >= 2) {
          wg_wait<1>();            // group gc-2 is complete: set s is free
          keep<KC>(ah[s]);
          keep<KC>(al[s]);
        }
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          load_split(astart(u) + aoff(c * KC + kk), a_lbo, a_sbo, w, g, t,
                     ah[s][kk], al[s][kk]);
      }
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) d[u & 1][i] = 0.f;
        fence_acc<N>(d[u & 1]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const int ks = c * KC + kk;
        const uint64_t ad = ahw | (a0 + (aoff(ks) >> 4));
        const uint64_t bd = bhw | (b0 + (ks * 2 * LBO >> 4));
        Step<F32, N, (BLO >> 4)>::run(d[u & 1], ah[s][kk], al[s][kk], ad,
                                      bd);
      }
      wg_commit();
    }
    if (u >= 1) {
      wg_wait<CPU>();              // tile u-1's groups are complete
      if constexpr (F32) {
        keep<KC>(ah[0]);
        keep<KC>(al[0]);
        keep<KC>(ah[1]);
        keep<KC>(al[1]);
      }
      fence_acc<N>(d[(u - 1) & 1]);
      epi(u - 1, d[(u - 1) & 1]);
    }
  }
  wg_wait<0>();
  if constexpr (F32) {
    keep<KC>(ah[0]);
    keep<KC>(al[0]);
    keep<KC>(ah[1]);
    keep<KC>(al[1]);
  }
  fence_acc<N>(d[(U - 1) & 1]);
  epi(U - 1, d[(U - 1) & 1]);
}

// `bytes` (a multiple of 16) from global to shared memory by `nt` threads.
__device__ __forceinline__ void stage_weights(void* dst, const void* src,
                                              int bytes, int tid, int nt) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int k = tid; k < bytes / 16; k += nt) d[k] = s[k];
}

// ---- dtype policies -----------------------------------------------------------

template <bool F32_>
struct Policy {
  static constexpr bool F32 = F32_;
  static constexpr int ELEM = F32 ? 4 : 2;       // bytes an element
  static constexpr int E = 16 / ELEM;            // elements a unit
  static constexpr int WPLANES = F32 ? 2 : 1;    // weight planes (hi, lo)
  // k-steps a group of a chain (bf16: a whole tile).  fp32 is bound by its
  // A registers: 4 in the main kernel (against 2: main 0.823 against 0.879
  // ms at bench_fused's shape, ablation kc2); 1 beside the stats kernel's
  // sums, where 2 made ptxas serialize the wgmma for want of registers at
  // both triples (at Ci 16, two blocks an SM at 128 registers a thread, 1
  // spills 72 bytes and is still faster: stats 0.373 against 0.403 ms,
  // ablation stats_kc2)
  template <int KS, bool MAIN>
  static __host__ __device__ constexpr int kc() {
    return F32 ? (MAIN ? 4 : 1) : KS;
  }
};

// Two values of adjacent columns into one word (fp32: 8 bytes, bf16: 4).
template <bool F32>
__device__ __forceinline__ void store2(unsigned char* p, float a, float b) {
  if constexpr (F32) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
}

// ---- the stats kernel ---------------------------------------------------------

template <class P, int CI, int CM>
struct StatsCfg {
  using G = Geo<STATS_TW, CI, CM, P::E>;
  static constexpr int NWG = 2;
  static constexpr size_t W1 = (size_t)16 * CI * CM * P::ELEM * P::WPLANES;
  static constexpr size_t BOX = al128((size_t)G::BOXU * 16);
  // per warpgroup, two items: [warp][column][sum, sum of squares]
  static constexpr size_t RED = (size_t)2 * 4 * 4 * CM * 2 * 4;
  static constexpr size_t fixed = al128(W1) + NWG * al128(RED) + 64;
  static constexpr int NB = fixed + NWG * 2 * BOX <= 227 * 1024 ? 2 : 1;
  static constexpr size_t o_box = al128(W1);
  static constexpr size_t o_red = o_box + NWG * NB * BOX;
  static constexpr size_t o_bar = o_red + NWG * al128(RED);
  static constexpr size_t bytes = o_bar + 8 * NWG * NB;
  // two blocks an SM where they fit and 128 registers a thread take the
  // accumulators and the sums of N = 4 CM <= 32 columns
  static constexpr int MINB = bytes <= 113 * 1024 && 4 * CM <= 32 ? 2 : 1;
};

// partial[idx][0][cm] = sum, partial[idx][1][cm] = sum of squares of the
// hidden cells item idx owns (even parities at positions [0, R) x [0, TW),
// odd ones at [1, R] x [1, TW], clipped to the image).
template <class P, int CI, int CM>
__global__ void __launch_bounds__(256, StatsCfg<P, CI, CM>::MINB)
stats_kernel(const __grid_constant__ Maps maps, const void* __restrict__ w1,
             float* __restrict__ partial, int H, int W, int nbands,
             int nchunks, long long n_items) {
  using S = StatsCfg<P, CI, CM>;
  using G = typename S::G;
  constexpr int TW = STATS_TW, N1 = 4 * CM, NJ = N1 / 8, NB = S::NB;
  constexpr int KC = P::template kc<G::K1S, false>();
  constexpr uint32_t W1P = 16 * CI * CM * P::ELEM;   // bytes of a W1 plane
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::o_bar);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  stage_weights(smem, w1, (int)S::W1, tid, 256);
  if (tid == 0) {
    for (int s = 0; s < S::NWG * NB; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_async();
  __syncthreads();

  const int v = warp >> 2, w = warp & 3, wt = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* boxes = smem + S::o_box + (size_t)v * NB * S::BOX;
  float* red = reinterpret_cast<float*>(smem + S::o_red + v * al128(S::RED));
  uint64_t* bar = full + v * NB;
  const long long stride = 2 * (long long)gridDim.x;
  const long long first = blockIdx.x + (long long)v * gridDim.x;
  if (wt == 0)
    for (int s = 0; s < NB; ++s)
      if (first + s * stride < n_items)
        load_box<TW, G::CIG, G::PLANE, G::BP>(&maps, boxes + s * S::BOX, &bar[s],
                                       first + s * stride, nbands, nchunks);
  const uint32_t w1_s = smem_u32(smem);
  // red[buf][warp][column][sum, squares]
  auto slot = [&](int buf, int ww, int col, int k) {
    return (((buf * 4 + ww) * N1 + col) * 2) + k;
  };
  int k = 0;
  for (long long idx = first; idx < n_items; idx += stride, ++k) {
    const Item m = decode<TW>(idx, nbands, nchunks);
    const int sl = k % NB, buf = k & 1;
    unsigned char* box = boxes + sl * S::BOX;
    float s[NJ][2][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) s[j][c][0] = s[j][c][1] = 0.f;
    mbar_wait(&bar[sl], (k / NB) & 1);
    const uint32_t box_s = smem_u32(box);
    chain<P::F32, N1, G::K1S, KC, G::M1T, W1P>(
        [&](int mt) { return box_s + mt * 64 * 16; },
        [](int ks) {
          constexpr int per_tap = G::CIG / 2;
          const int tap = ks / per_tap, cgp = ks % per_tap;
          return (uint32_t)((2 * cgp * G::BP + (tap >> 1) * G::BC +
                             (tap & 1)) * 16);
        },
        G::BP * 16, 128, w1_s,
        [&](int mt, float (&d)[N1 / 2]) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = mt * 64 + 16 * w + g + 8 * i;
            const int pi = q / G::BC, pj = q - pi * G::BC;
            // does this item own the cell of parity (di, dj) here
            bool row_own[2], col_own[2];
#pragma unroll
            for (int dd = 0; dd < 2; ++dd) {
              row_own[dd] = q <= G::LASTQ && pi - dd >= 0 && pi - dd < R &&
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
        w, lane);
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
    // the warpgroup's sums of the item are in, and its box is read
    named_sync(1 + v, 128);
    if (wt == 0 && idx + NB * stride < n_items)
      load_box<TW, G::CIG, G::PLANE, G::BP>(&maps, box, &bar[sl], idx + NB * stride,
                                     nbands, nchunks);
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

// ---- the main kernel ----------------------------------------------------------

// Items of TW columns: 32, but 16 for fp32 at Ci 32, with one warpgroup.
template <class P, int CI>
__host__ __device__ constexpr int main_tw() {
  return P::F32 && CI >= 32 ? 16 : 32;
}
template <class P, int CI>
__host__ __device__ constexpr int main_wgs() {
  return P::F32 && CI >= 32 ? 1 : 2;
}

template <class P, int CI, int CM, int CO>
struct MainCfg {
  using G = Geo<main_tw<P, CI>(), CI, CM, P::E>;
  static constexpr int NWG = main_wgs<P, CI>();
  static constexpr size_t W1 = (size_t)16 * CI * CM * P::ELEM * P::WPLANES;
  static constexpr size_t W2 = (size_t)16 * CM * CO * P::ELEM * P::WPLANES;
  static constexpr size_t BOX = al128((size_t)G::BOXU * 16);
  static constexpr size_t HP = al128((size_t)G::HPN * G::PS * 16);
  static constexpr size_t BN = al128((size_t)4 * CM * 2 * 4);  // [n][g, s]
  static constexpr size_t fixed = al128(W1) + al128(W2) + NWG * HP + BN + 64;
  static constexpr int NB = fixed + NWG * 2 * BOX <= 227 * 1024 ? 2 : 1;
  static constexpr size_t o_w2 = al128(W1);
  static constexpr size_t o_box = o_w2 + al128(W2);
  static constexpr size_t o_hp = o_box + NWG * NB * BOX;
  static constexpr size_t o_bn = o_hp + NWG * HP;
  static constexpr size_t o_bar = o_bn + BN;
  static constexpr size_t bytes = o_bar + 8 * NWG * NB;
  static constexpr int MINB = bytes <= 113 * 1024 ? 2 : 1;
};

template <class P, int CI, int CM, int CO>
__global__ void __launch_bounds__(128 * MainCfg<P, CI, CM, CO>::NWG,
                                  MainCfg<P, CI, CM, CO>::MINB)
main_kernel(const __grid_constant__ Maps maps, const void* __restrict__ w1,
            const void* __restrict__ w2, const float* __restrict__ bn_rows,
            void* __restrict__ y, int H, int W, int nbands, int nchunks,
            long long n_items) {
  using S = MainCfg<P, CI, CM, CO>;
  using G = typename S::G;
  constexpr int TW = main_tw<P, CI>(), NWG = S::NWG, NT = 128 * NWG;
  constexpr int N1 = 4 * CM, N2 = CO, NB = S::NB, CMG = CM / P::E;
  constexpr int KC1 = P::template kc<G::K1S, true>();
  constexpr int KC2 = P::template kc<G::K2S, true>();
  constexpr uint32_t W1P = 16 * CI * CM * P::ELEM;
  constexpr uint32_t W2P = 16 * CM * CO * P::ELEM;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::o_bar);
  float* bn = reinterpret_cast<float*>(smem + S::o_bn);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  stage_weights(smem, w1, (int)S::W1, tid, NT);
  stage_weights(smem + S::o_w2, w2, (int)S::W2, tid, NT);
  // column n of stage 1 (cm = n % CM): h = acc * gain + shift, shift = bias
  // - mean * gain
  for (int n = tid; n < N1; n += NT) {
    const float gn = bn_rows[N1 + n];
    bn[2 * n] = gn;
    bn[2 * n + 1] = fmaf(-bn_rows[n], gn, bn_rows[2 * N1 + n]);
  }
  if (tid == 0) {
    for (int s = 0; s < NWG * NB; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_async();
  __syncthreads();

  const int v = warp >> 2, w = warp & 3, wt = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* boxes = smem + S::o_box + (size_t)v * NB * S::BOX;
  unsigned char* hp = smem + S::o_hp + (size_t)v * S::HP;
  uint64_t* bar = full + v * NB;
  const long long stride = NWG * (long long)gridDim.x;
  const long long first = blockIdx.x + (long long)v * gridDim.x;
  if (wt == 0)
    for (int s = 0; s < NB; ++s)
      if (first + s * stride < n_items)
        load_box<TW, G::CIG, G::PLANE, G::BP>(&maps, boxes + s * S::BOX, &bar[s],
                                       first + s * stride, nbands, nchunks);
  const uint32_t w1_s = smem_u32(smem), w2_s = smem_u32(smem + S::o_w2);
  const uint32_t hp_s = smem_u32(hp);
  constexpr int ELEM = P::ELEM;
  const size_t y_row = (size_t)W * CO;           // elements of a y row
  int k = 0;
  for (long long idx = first; idx < n_items; idx += stride, ++k) {
    const Item m = decode<TW>(idx, nbands, nchunks);
    const int sl = k % NB;
    unsigned char* box = boxes + sl * S::BOX;
    mbar_wait(&bar[sl], (k / NB) & 1);
    const uint32_t box_s = smem_u32(box);

    // ---- stage 1: all M1T tiles into the hidden planes ----
    chain<P::F32, N1, G::K1S, KC1, G::M1T, W1P>(
        [&](int mt) { return box_s + mt * 64 * 16; },
        [](int ks) {
          constexpr int per_tap = G::CIG / 2;
          const int tap = ks / per_tap, cgp = ks % per_tap;
          return (uint32_t)((2 * cgp * G::BP + (tap >> 1) * G::BC +
                             (tap & 1)) * 16);
        },
        G::BP * 16, 128, w1_s,
        [&](int mt, float (&d)[N1 / 2]) {
          // the last item's stage 2 has read the hidden planes
          if (mt == 0) named_sync(1 + v, 128);
          // normalise, rectify, zero outside the image, store
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = mt * 64 + 16 * w + g + 8 * i;
            const int pi = q / G::BC, pj = q - pi * G::BC;
            if (q > G::LASTQ || pj > TW) continue;
            bool row_in[2], col_in[2];
#pragma unroll
            for (int dd = 0; dd < 2; ++dd) {
              row_in[dd] = (unsigned)(m.r0 - dd + pi) < (unsigned)H;
              col_in[dd] = (unsigned)(m.c0 - dd + pj) < (unsigned)W;
            }
            const int pos = pi * G::PC + pj;
#pragma unroll
            for (int j = 0; j < N1 / 8; ++j) {
              const int n = 8 * j + 2 * t;
              const int par = n / CM, cm = n % CM;
              const bool in = row_in[par >> 1] && col_in[par & 1];
              const float4 gs = *reinterpret_cast<const float4*>(bn + 2 * n);
              const float o0 =
                  in ? fmaxf(fmaf(d[4 * j + 2 * i], gs.x, gs.y), 0.f) : 0.f;
              const float o1 =
                  in ? fmaxf(fmaf(d[4 * j + 2 * i + 1], gs.z, gs.w), 0.f)
                     : 0.f;
              const int plane = par * CMG + cm / P::E;
              store2<P::F32>(hp + ((size_t)plane * G::PS + pos) * 16 +
                                 (cm % P::E) * ELEM,
                             o0, o1);
            }
          }
        },
        w, lane);
    // the planes are written for the async proxy, and the box is read
    fence_async();
    named_sync(1 + v, 128);
    if (wt == 0 && idx + NB * stride < n_items)
      load_box<TW, G::CIG, G::PLANE, G::BP>(&maps, box, &bar[sl], idx + NB * stride,
                                     nbands, nchunks);

    // ---- stage 2: M2T tiles of 8 y rows x 8 y columns ----
    chain<P::F32, N2, G::K2S, KC2, G::M2T, W2P>(
        [&](int nb) { return hp_s + nb * 8 * 16; },
        [](int ks) {
          constexpr int per_win = G::HPN / 2;
          const int s = ks / per_win, pp = ks % per_win;
          return (uint32_t)((2 * pp * G::PS + (s >> 1) * G::PC + (s & 1)) *
                            16);
        },
        G::PS * 16, G::PC * 16, w2_s,
        [&](int nb, float (&d)[N2 / 2]) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = m.r0 + 2 * w + i, col = m.c0 + 8 * nb + g;
            if (row >= H || col >= W) continue;
            unsigned char* yp = static_cast<unsigned char*>(y) +
                                (((size_t)m.b * H + row) * y_row +
                                 (size_t)col * CO) * ELEM;
#pragma unroll
            for (int j = 0; j < N2 / 8; ++j)
              store2<P::F32>(yp + (8 * j + 2 * t) * ELEM, d[4 * j + 2 * i],
                             d[4 * j + 2 * i + 1]);
          }
        },
        w, lane);
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

// One 4-D map a 16-byte channel group over x (B, H, W, ci) NHWC of `elem`
// bytes an element, innermost first: (E elements, W, H, B), box (E, bc, xr,
// 1); out-of-image elements read as zero.  Returns 0 or a negative code.
inline int encode_maps(Maps* maps, const void* x, int B, int H, int W,
                       int ci, int elem, int bc, int xr) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEntryPoint;
  const int e = 16 / elem, groups = ci / e;
  if (groups > kMaxMaps) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)e, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ci * elem,
                                 (cuuint64_t)W * ci * elem,
                                 (cuuint64_t)H * W * ci * elem};
  const cuuint32_t box[4] = {(cuuint32_t)e, (cuuint32_t)bc, (cuuint32_t)xr,
                             1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = elem == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  for (int g = 0; g < groups; ++g) {
    const CUresult r =
        fn(&maps->m[g], type, 4,
           const_cast<char*>(static_cast<const char*>(x)) + 16 * g, dims,
           strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -1 - (int)r;
  }
  return 0;
}

// Blocks of a persistent launch: what fits on the card, at most one per
// `per_block` items.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, int nt, size_t smem, int n_sm,
                            long long n_items, int per_block, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || n_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * n_sm;
  const long long want = (n_items + per_block - 1) / per_block;
  *grid = (int)(want < fit ? want : fit);
  return cudaSuccess;
}

template <class P, int CI, int CM>
int launch_stats(const void* x, const void* w1, float* partial, int B, int H,
                 int W, int n_sm, cudaStream_t stream) {
  using S = StatsCfg<P, CI, CM>;
  using G = typename S::G;
  const int nbands = (H + R - 1) / R, nchunks = (W + STATS_TW - 1) / STATS_TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  if (((uintptr_t)x & 15) || ((uintptr_t)w1 & 15))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  const int enc = encode_maps(&maps, x, B, H, W, CI, P::ELEM, G::BC, G::XR);
  if (enc != 0) return enc;
  int grid = 0;
  cudaError_t e = persistent_grid(stats_kernel<P, CI, CM>, 256, S::bytes,
                                  n_sm, n_items, S::NWG, &grid);
  if (e != cudaSuccess) return (int)e;
  stats_kernel<P, CI, CM><<<grid, 256, S::bytes, stream>>>(
      maps, w1, partial, H, W, nbands, nchunks, n_items);
  return (int)cudaGetLastError();
}

template <class P, int CI, int CM, int CO>
int launch_main(const void* x, const void* w1, const void* w2,
                const float* bn, void* y, int B, int H, int W, int n_sm,
                cudaStream_t stream) {
  using S = MainCfg<P, CI, CM, CO>;
  using G = typename S::G;
  constexpr int TW = main_tw<P, CI>();
  const int nbands = (H + R - 1) / R, nchunks = (W + TW - 1) / TW;
  const long long n_items = (long long)B * nbands * nchunks;
  if (n_items == 0) return (int)cudaSuccess;
  if (((uintptr_t)x & 15) || ((uintptr_t)w1 & 15) || ((uintptr_t)w2 & 15) ||
      ((uintptr_t)y & 7))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  const int enc = encode_maps(&maps, x, B, H, W, CI, P::ELEM, G::BC, G::XR);
  if (enc != 0) return enc;
  int grid = 0;
  constexpr int nt = 128 * S::NWG;
  cudaError_t e = persistent_grid(main_kernel<P, CI, CM, CO>, nt, S::bytes,
                                  n_sm, n_items, S::NWG, &grid);
  if (e != cudaSuccess) return (int)e;
  main_kernel<P, CI, CM, CO><<<grid, nt, S::bytes, stream>>>(
      maps, w1, w2, bn, y, H, W, nbands, nchunks, n_items);
  return (int)cudaGetLastError();
}

}  // namespace nhwc

// fp32, 3xTF32 on wgmma .tf32
namespace wgf {
using P = nhwc::Policy<true>;
}

// bf16 on wgmma .bf16
namespace wgb {
using P = nhwc::Policy<false>;
}

extern "C" {

// Work-item geometry: y rows of an item, y columns of a stats item, y
// columns of a main item at (ci, fp32 or bf16).
int fused_nhwc_wgmma_rows() { return nhwc::R; }
int fused_nhwc_wgmma_stats_cols() { return nhwc::STATS_TW; }
int fused_nhwc_wgmma_main_cols(int ci, int f32) {
  if (f32)
    return ci >= 32 ? nhwc::main_tw<wgf::P, 32>() : nhwc::main_tw<wgf::P, 16>();
  return ci >= 32 ? nhwc::main_tw<wgb::P, 32>() : nhwc::main_tw<wgb::P, 16>();
}

// Channel triples with an instantiation: (16, 8, 16) and (32, 16, 32).
int fused_nhwc_wgmma_supported(int ci, int cm, int co) {
  return ci == 2 * cm && co == 2 * cm && (cm == 8 || cm == 16);
}

// x fp32 (B, H, W, ci) NHWC; w1: W1 (4 ci x 4 cm) as the planes (hi, lo) in
// wgmma's K-major order (ops/fused_nhwc_wgmma.py operands) -> partial
// (B * ceil(H/8) * ceil(W/32), 2, cm).
int fused_nhwc_wgmma_stats_f32(const void* x, const void* w1, float* partial,
                               int B, int H, int W, int ci, int cm, int n_sm,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!fused_nhwc_wgmma_supported(ci, cm, 2 * cm))
    return (int)cudaErrorInvalidValue;
  if (cm == 8)
    return nhwc::launch_stats<wgf::P, 16, 8>(x, w1, partial, B, H, W, n_sm, s);
  return nhwc::launch_stats<wgf::P, 32, 16>(x, w1, partial, B, H, W, n_sm, s);
}

// w2: W2 (16 cm x co), rows (sa, sb, di, dj, cm), as two planes in the same
// order; bn (3, 4 cm) fp32: mean, gain, bias tiled over the parities ->
// y fp32 (B, H, W, co) NHWC.
int fused_nhwc_wgmma_main_f32(const void* x, const void* w1, const void* w2,
                              const float* bn, void* y, int B, int H, int W,
                              int ci, int cm, int co, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!fused_nhwc_wgmma_supported(ci, cm, co))
    return (int)cudaErrorInvalidValue;
  if (cm == 8)
    return nhwc::launch_main<wgf::P, 16, 8, 16>(x, w1, w2, bn, y, B, H, W,
                                                n_sm, s);
  return nhwc::launch_main<wgf::P, 32, 16, 32>(x, w1, w2, bn, y, B, H, W,
                                               n_sm, s);
}

// As fused_nhwc_wgmma_stats_f32 with x and w1 bf16 (one plane).
int fused_nhwc_wgmma_stats_bf16(const void* x, const void* w1,
                                float* partial, int B, int H, int W, int ci,
                                int cm, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!fused_nhwc_wgmma_supported(ci, cm, 2 * cm))
    return (int)cudaErrorInvalidValue;
  if (cm == 8)
    return nhwc::launch_stats<wgb::P, 16, 8>(x, w1, partial, B, H, W, n_sm, s);
  return nhwc::launch_stats<wgb::P, 32, 16>(x, w1, partial, B, H, W, n_sm, s);
}

// As fused_nhwc_wgmma_main_f32 with x, w1, w2 and y bf16; bn fp32.
int fused_nhwc_wgmma_main_bf16(const void* x, const void* w1, const void* w2,
                               const float* bn, void* y, int B, int H, int W,
                               int ci, int cm, int co, int n_sm,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!fused_nhwc_wgmma_supported(ci, cm, co))
    return (int)cudaErrorInvalidValue;
  if (cm == 8)
    return nhwc::launch_main<wgb::P, 16, 8, 16>(x, w1, w2, bn, y, B, H, W,
                                                n_sm, s);
  return nhwc::launch_main<wgb::P, 32, 16, 32>(x, w1, w2, bn, y, B, H, W,
                                               n_sm, s);
}

}  // extern "C"
