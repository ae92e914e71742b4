// Fused device-side preprocess for Hopper (sm_90a): optional rgb->gray,
// optional [0,1] -> [-1,1], and the 2x2 box degrade, in one pass.
//
// Replaces the TPU kernel dcgan_sr_tpu/ops/pallas_kernels.py
// pallas_preprocess (_preprocess_kernel :42-60).  From x (B, C, H, W) fp32 it
// writes hr (B, C', H, W), the discriminator's input, and lr (B, C', H/2,
// W/2), the generator's input; C' = 1 with rgb_to_gray, else C.
//
// The TPU version takes the box mean as two matrix products with 0.5-weight
// pair matrices, because strided gathers do not lower there.  Here one thread
// owns one lr pixel: it reads the 2x2 window of each input channel as two
// 8-byte loads (neighbouring threads read neighbouring addresses), writes
// the two hr row halves as 8-byte stores and the lr value as a 4-byte
// store.  Every input byte is read once and every output byte written once.
//
// Arithmetic, all fp32, in the order of the TPU formula so that results
// agree to the last bit with the plain PyTorch version (ops/preprocess.py
// preprocess_plain):
//   gray = (0.21 r + 0.72 g) + 0.07 b         three products, two sums
//   pm1  = x * 2 - 1
//   lr   = ((a + c) + (b + d)) * 0.25         rows first, then columns
// for the window [[a, b], [c, d]].  The products and sums go through
// __fmul_rn / __fadd_rn, which nvcc never contracts into a fused
// multiply-add: an FMA would keep the product unrounded and change the last
// bit of the gray term against PyTorch's separate multiplies and adds.
//
// Bound on an H100 (HBM 3.35 TB/s): the kernel does 4 to 12 flops for every
// 12 to 20 bytes, so it is bound by bytes at every size; at the training
// shape (100, 1, 64, 64) the bytes (3.7 MB) take about 1.1 us, less than a
// launch, so there it is bound by launch latency in practice.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/preprocess.py).
// The entry returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.21f, r), __fmul_rn(0.72f, g)),
                   __fmul_rn(0.07f, b));
}

__device__ __forceinline__ float pm1_of(float v) {
  return __fadd_rn(__fmul_rn(v, 2.0f), -1.0f);
}

// total = B * Cout * (H/2) * (W/2) lr pixels, one per thread.
template <bool GRAY, bool PM1>
__global__ void __launch_bounds__(THREADS)
preprocess_kernel(const float* __restrict__ x, float* __restrict__ hr,
                  float* __restrict__ lr, int C, int Cout, int H, int W,
                  long long total) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int W2 = W / 2, H2 = H / 2;
  const int j = (int)(idx % W2);
  long long rest = idx / W2;
  const int i = (int)(rest % H2);
  rest /= H2;
  const int c = (int)(rest % Cout);
  const long long b = rest / Cout;

  const size_t plane = (size_t)H * W;
  const size_t in_plane = ((size_t)b * C + (GRAY ? 0 : c)) * plane;
  const size_t pix = (size_t)(2 * i) * W + 2 * j;   // even: 8-byte aligned
  const float* p = x + in_plane + pix;

  float2 top = *reinterpret_cast<const float2*>(p);
  float2 bot = *reinterpret_cast<const float2*>(p + W);
  if (GRAY) {
    const float2 gt = *reinterpret_cast<const float2*>(p + plane);
    const float2 gb = *reinterpret_cast<const float2*>(p + plane + W);
    const float2 bt = *reinterpret_cast<const float2*>(p + 2 * plane);
    const float2 bb = *reinterpret_cast<const float2*>(p + 2 * plane + W);
    top = make_float2(gray_of(top.x, gt.x, bt.x), gray_of(top.y, gt.y, bt.y));
    bot = make_float2(gray_of(bot.x, gb.x, bb.x), gray_of(bot.y, gb.y, bb.y));
  }
  if (PM1) {
    top = make_float2(pm1_of(top.x), pm1_of(top.y));
    bot = make_float2(pm1_of(bot.x), pm1_of(bot.y));
  }

  float* q = hr + ((size_t)b * Cout + c) * plane + pix;
  *reinterpret_cast<float2*>(q) = top;
  *reinterpret_cast<float2*>(q + W) = bot;
  lr[idx] = __fmul_rn(
      __fadd_rn(__fadd_rn(top.x, bot.x), __fadd_rn(top.y, bot.y)), 0.25f);
}

template <bool GRAY, bool PM1>
int launch(const float* x, float* hr, float* lr, int B, int C, int H, int W,
           cudaStream_t s) {
  const int cout = GRAY ? 1 : C;
  const long long total = (long long)B * cout * (H / 2) * (W / 2);
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  preprocess_kernel<GRAY, PM1><<<(unsigned)blocks, THREADS, 0, s>>>(
      x, hr, lr, C, cout, H, W, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, H, W), hr (B, C', H, W), lr (B, C', H/2, W/2): contiguous fp32,
// 8-byte aligned; H and W even; gray needs C == 3.  `device` is the card the
// tensors and the stream live on: if it is not the thread's current device
// it is made current for the launch and the old one restored, which costs
// the caller no device guard on the host's critical path.  Nothing here
// synchronises or allocates, so the call may be captured into a CUDA graph.
int preprocess_f32(const float* x, float* hr, float* lr, int B, int C, int H,
                   int W, int gray, int pm1, int device, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 0 || C < 1 || H < 0 || W < 0 || (H & 1) || (W & 1) ||
      (gray && C != 3))
    return (int)cudaErrorInvalidValue;
  int current = device;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return (int)e;
  int err;
  if (gray)
    err = pm1 ? launch<true, true>(x, hr, lr, B, C, H, W, s)
              : launch<true, false>(x, hr, lr, B, C, H, W, s);
  else
    err = pm1 ? launch<false, true>(x, hr, lr, B, C, H, W, s)
              : launch<false, false>(x, hr, lr, B, C, H, W, s);
  if (current != device && (e = cudaSetDevice(current)) != cudaSuccess &&
      err == (int)cudaSuccess)
    err = (int)e;
  return err;
}

}  // extern "C"
