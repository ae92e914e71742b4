// BN of a bf16 map on Hopper (sm_90a) in two passes over the map: the
// statistics, then the normalisation with the layer's activation.
//
// Replaces no Pallas kernel.  It does on the card what XLA's fusion did for
// the JAX package's batch_norm (dcgan_sr_tpu/ops/nn.py:111-143): there the
// cast of a bf16 map to fp32 fuses into the reduction, so the map is read
// once at bf16 width for its statistics, and the affine x * a + b and the
// ReLU that follows fuse into one read and one write.  Eager PyTorch runs
// the same formula (dcgan_sr_tpu_torch/ops/nn.py batch_stats, normalize,
// relu) as seven passes, about 34 bytes an element; this file moves 6: two
// bytes read for the statistics, two read and two written to normalise.
//
// Bound on an H100: bytes, 6 B an element at 3.35 TB/s (1.923 ms for the
// gray-3 pipeline's (16, 16, 2048, 2048) map, 0.845 ms for the overlap
// pipeline's (14400, 32, 32, 32)); the arithmetic is a few flops a byte.
// The design meets the bound so:
//   - every load and store is 16 bytes (eight bf16), neighbouring threads on
//     neighbouring addresses, and each thread keeps UNROLL = 4 loads in
//     flight before it uses any of them;
//   - the statistics' grid is cut into about 4,096 blocks of 256 threads
//     whatever the shape (a gray-3 plane is 1-4 M elements, an overlap slice
//     225 runs of 256 or 1,024): each slice (g, c) is split into K chunks of
//     whole vectors, enough for several waves on 132 SMs;
//   - index arithmetic is 32-bit, and the divisions by the run length, the
//     channel count and the group's run count are multiplications by
//     precomputed magic numbers (FastDiv), so a vector costs a few integer
//     instructions beside its sixteen bytes.
//
// Statistics.  Slice (g, c) of x (N, C, H, W) is R runs of S = H * W
// contiguous elements: the images n = g * R .. g * R + R - 1 of channel c.
//   per image   g = n, R = 1
//   pooled      G = groups, R = N / G (the overlap pipeline's per-image
//               batches of 225 tiles); plain pooled is G = 1, R = N.
// Each block sums its chunk's elements and their squares in fp32 (a vector's
// eight pairwise, then along the thread, then across the block by a fixed
// shuffle tree) and writes one (sum, sum of squares) pair.  bn_finish_bf16
// then adds a slice's K pairs in chunk order: no float atomics anywhere, so
// the same input gives the same bits on every run.  It writes the fp32
// mean = sum / n and the biased var = E[x^2] - mean^2 (a track_stats update
// needs both), and the bf16 gain and shift in the plain path's order:
//   inv = rsqrt(var + eps)
//   a   = bf16(inv * scale)
//   b   = bf16(bias - mean * inv * scale)      ((mean * inv) * scale)
// Running statistics (serving's BN eval) skip the first kernel: the finish
// kernel reads the running mean and var in place of the chunk pairs.
//
// Apply.  y = bf16(bf16(x * a) + b) with the plain bf16 form's two roundings,
// then the activation on that bf16 value: relu as clamp_min(v, 0) (a NaN
// stays), lrelu as v >= 0 ? v : bf16(v * bf16(0.2)), or none.  a and b are
// read at row (n / R) * C + c inside the kernel, so nothing is repeated per
// image on the host.  All products and sums go through __fmul_rn / __fadd_rn
// / __fsub_rn, which nvcc never contracts into a fused multiply-add that the
// plain path's separate kernels do not do, so y equals the plain
// composition bit for bit given the same a and b.
//
// Shapes.  The vector path takes x (and y) 16-byte aligned with S % 8 == 0,
// which every map of the generators is (H and W are multiples of 4).  Any
// other S or alignment runs the general path: the statistics read scalars,
// the apply kernel a scalar head up to x's first 16-byte boundary, a 16-byte
// body whose vectors may straddle runs, and a scalar tail (y shares x's
// alignment modulo 16: the wrapper allocates it so).
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/bn.py).
// Each entry returns the cudaError_t of its launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take.  Nothing here
// synchronises or allocates, so every launch may be captured into a CUDA
// graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long TARGET_BLOCKS = 4096;   // statistics grid, any shape
constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_LRELU = 2;

// n / d for 0 <= n < 2^31 and 1 <= d <= 2^31, as a multiply-high and a
// shift (the magic-number division of PyTorch's IntDivider).
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while (s < 31 && (1u << s) < d) ++s;
  const uint64_t one = 1;
  return {d, (unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ unsigned fdiv(const FastDiv& f, unsigned n) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float bf16_bits(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- statistics --------------------------------------------------------------

// The 16-byte vector (W = 8) or the single element (W = 1) at vector index
// `idx` of x, and its sum and sum of squares.
template <int W>
struct Vec;

template <>
struct Vec<8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* x, size_t idx) {
    u = __ldg(reinterpret_cast<const uint4*>(x) + idx);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void add_to(float& s, float& q) const {
    const float e0 = lo_bf16(u.x), e1 = hi_bf16(u.x), e2 = lo_bf16(u.y),
                e3 = hi_bf16(u.y), e4 = lo_bf16(u.z), e5 = hi_bf16(u.z),
                e6 = lo_bf16(u.w), e7 = hi_bf16(u.w);
    s += ((e0 + e1) + (e2 + e3)) + ((e4 + e5) + (e6 + e7));
    q += ((e0 * e0 + e1 * e1) + (e2 * e2 + e3 * e3)) +
         ((e4 * e4 + e5 * e5) + (e6 * e6 + e7 * e7));
  }
};

template <>
struct Vec<1> {
  unsigned short h;
  __device__ __forceinline__ void load(const __nv_bfloat16* x, size_t idx) {
    h = __ldg(reinterpret_cast<const unsigned short*>(x) + idx);
  }
  __device__ __forceinline__ void zero() { h = 0; }
  __device__ __forceinline__ void add_to(float& s, float& q) const {
    const float e = bf16_bits(h);
    s += e;
    q += e * e;
  }
};

// One block a chunk: blockIdx.x = slice * K + k, slice = g * C + c.  The
// slice's Vs = R * Sv vectors (Sv = S / W) are cut into K near-equal ranges.
// Each thread issues its UNROLL loads before it adds any of them.
template <int W>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const __nv_bfloat16* __restrict__ x, float2* __restrict__ partial,
             FastDiv by_sv, unsigned C, unsigned R, unsigned Vs, unsigned K) {
  const unsigned slice = blockIdx.x / K, k = blockIdx.x - slice * K;
  const unsigned g = slice / C, c = slice - g * C;
  const unsigned v0 = (unsigned)((uint64_t)k * Vs / K);
  const unsigned v1 = (unsigned)((uint64_t)(k + 1) * Vs / K);
  const unsigned sv = by_sv.d;
  const size_t run0 = (size_t)g * R;
  float s = 0.f, q = 0.f;
  for (unsigned u = v0 + threadIdx.x; u < v1; u += THREADS * UNROLL) {
    Vec<W> v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const unsigned uj = u + j * THREADS;
      if (uj < v1) {
        const unsigned r = fdiv(by_sv, uj);
        v[j].load(x, ((run0 + r) * C + c) * sv + (uj - r * sv));
      } else {
        v[j].zero();
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) v[j].add_to(s, q);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  __shared__ float2 warps[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = make_float2(s, q);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = warps[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) {
      t.x += warps[w].x;
      t.y += warps[w].y;
    }
    partial[blockIdx.x] = t;
  }
}

// One thread a slice.  With `partial` null it reads the running (mean, var)
// of channel c (slices == C).
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float2* __restrict__ partial, unsigned K,
              const float* __restrict__ run_mean,
              const float* __restrict__ run_var,
              const float* __restrict__ scale, const float* __restrict__ bias,
              unsigned C, unsigned slices, float inv_n, float eps,
              float* __restrict__ mean_out, float* __restrict__ var_out,
              __nv_bfloat16* __restrict__ a_out,
              __nv_bfloat16* __restrict__ b_out) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= slices) return;
  const unsigned c = i % C;
  float mean, var;
  if (partial != nullptr) {
    float s = 0.f, q = 0.f;
    for (unsigned k = 0; k < K; ++k) {
      const float2 p = partial[(size_t)i * K + k];
      s = __fadd_rn(s, p.x);
      q = __fadd_rn(q, p.y);
    }
    mean = __fmul_rn(s, inv_n);
    var = __fsub_rn(__fmul_rn(q, inv_n), __fmul_rn(mean, mean));
    mean_out[i] = mean;
    var_out[i] = var;
  } else {
    mean = run_mean[c];
    var = run_var[c];
  }
  const float inv = rsqrtf(__fadd_rn(var, eps));
  const float sc = scale[c];
  a_out[i] = __float2bfloat16_rn(__fmul_rn(inv, sc));
  b_out[i] = __float2bfloat16_rn(
      __fsub_rn(bias[c], __fmul_rn(__fmul_rn(mean, inv), sc)));
}

// ---- apply -------------------------------------------------------------------

template <int ACT>
__device__ __forceinline__ float bn_act(float xv, float av, float bv,
                                        float slope) {
  const float v = round_bf16(__fadd_rn(round_bf16(__fmul_rn(xv, av)), bv));
  if (ACT == ACT_RELU) return isnan(v) ? v : fmaxf(v, 0.f);
  if (ACT == ACT_LRELU) return v >= 0.f ? v : round_bf16(__fmul_rn(v, slope));
  return v;
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

template <int ACT>
__device__ __forceinline__ uint4 apply_vec(uint4 u, float av, float bv,
                                           float slope) {
  uint4 o;
  o.x = pack2(bn_act<ACT>(lo_bf16(u.x), av, bv, slope),
              bn_act<ACT>(hi_bf16(u.x), av, bv, slope));
  o.y = pack2(bn_act<ACT>(lo_bf16(u.y), av, bv, slope),
              bn_act<ACT>(hi_bf16(u.y), av, bv, slope));
  o.z = pack2(bn_act<ACT>(lo_bf16(u.z), av, bv, slope),
              bn_act<ACT>(hi_bf16(u.z), av, bv, slope));
  o.w = pack2(bn_act<ACT>(lo_bf16(u.w), av, bv, slope),
              bn_act<ACT>(hi_bf16(u.w), av, bv, slope));
  return o;
}

// Vector path: x, y 16-byte aligned, S % 8 == 0, fewer than 2^31 vectors.
// Vector v lies in run v / Sv = n * C + c, whose (a, b) row is (n / R) * C + c.
template <int ACT>
__global__ void __launch_bounds__(THREADS)
apply_vec_kernel(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ y,
                 const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, FastDiv by_sv,
                 FastDiv by_c, FastDiv by_r, unsigned nvec, float slope) {
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const unsigned short* ab = reinterpret_cast<const unsigned short*>(a);
  const unsigned short* bb = reinterpret_cast<const unsigned short*>(b);
  const unsigned base = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  uint4 u[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const unsigned v = base + j * THREADS;
    if (v < nvec) u[j] = __ldg(xv + v);
  }
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const unsigned v = base + j * THREADS;
    if (v < nvec) {
      const unsigned run = fdiv(by_sv, v);
      const unsigned n = fdiv(by_c, run);
      const unsigned row = fdiv(by_r, n) * by_c.d + (run - n * by_c.d);
      yv[v] = apply_vec<ACT>(u[j], bf16_bits(__ldg(ab + row)),
                             bf16_bits(__ldg(bb + row)), slope);
    }
  }
}

// General path: any S and any (shared) alignment of x and y.  Item t < nbody
// is the 16-byte vector at element head + 8 t; the items after it are the
// head's and the tail's single elements.
template <int ACT>
__global__ void __launch_bounds__(THREADS)
apply_any_kernel(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ y,
                 const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, long long S, long long C,
                 long long R, long long numel, long long head,
                 long long nbody, float slope) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long items = nbody + head + (numel - head - 8 * nbody);
  if (t >= items) return;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  unsigned short* ys = reinterpret_cast<unsigned short*>(y);
  const unsigned short* ab = reinterpret_cast<const unsigned short*>(a);
  const unsigned short* bb = reinterpret_cast<const unsigned short*>(b);
  auto row_of = [&](long long run) {
    const long long n = run / C;
    return (n / R) * C + (run - n * C);
  };
  if (t < nbody) {
    const long long e0 = head + 8 * t;
    long long run = e0 / S, rem = e0 - run * S, row = row_of(run);
    const uint4 u = *reinterpret_cast<const uint4*>(xs + e0);
    const unsigned in[4] = {u.x, u.y, u.z, u.w};
    unsigned out[4];
    for (int w = 0; w < 4; ++w) {
      float v[2];
      for (int h = 0; h < 2; ++h) {
        if (rem == S) {
          ++run;
          rem = 0;
          row = row_of(run);
        }
        v[h] = bn_act<ACT>(h ? hi_bf16(in[w]) : lo_bf16(in[w]),
                           bf16_bits(ab[row]), bf16_bits(bb[row]), slope);
        ++rem;
      }
      out[w] = pack2(v[0], v[1]);
    }
    *reinterpret_cast<uint4*>(ys + e0) = make_uint4(out[0], out[1], out[2],
                                                    out[3]);
    return;
  }
  const long long e = t < nbody + head ? t - nbody : t - nbody + 8 * nbody;
  const long long row = row_of(e / S);
  const float v = bn_act<ACT>(bf16_bits(xs[e]), bf16_bits(ab[row]),
                              bf16_bits(bb[row]), slope);
  ys[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int ACT>
int launch_apply(const __nv_bfloat16* x, __nv_bfloat16* y,
                 const __nv_bfloat16* a, const __nv_bfloat16* b, long long N,
                 long long C, long long S, long long R, float slope,
                 cudaStream_t st) {
  const long long numel = N * C * S;
  const uintptr_t ax = (uintptr_t)x & 15, ay = (uintptr_t)y & 15;
  if (ax != ay) return (int)cudaErrorInvalidValue;
  const long long nvec = numel / 8;
  if (ax == 0 && S % 8 == 0 && nvec < (1LL << 31) && N * C < (1LL << 31)) {
    const long long blocks = (nvec + THREADS * UNROLL - 1) / (THREADS * UNROLL);
    apply_vec_kernel<ACT><<<(unsigned)blocks, THREADS, 0, st>>>(
        x, y, a, b, make_div((unsigned)(S / 8)), make_div((unsigned)C),
        make_div((unsigned)R), (unsigned)nvec, slope);
    return (int)cudaGetLastError();
  }
  long long head = ax == 0 ? 0 : (long long)(16 - ax) / 2;
  if (head > numel) head = numel;
  const long long nbody = (numel - head) / 8;
  const long long items = numel - 7 * nbody;
  const long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  apply_any_kernel<ACT><<<(unsigned)blocks, THREADS, 0, st>>>(
      x, y, a, b, S, C, R, numel, head, nbody, slope);
  return (int)cudaGetLastError();
}

// Switches to `device` for the launch if it is not the current one (the
// caller then needs no device guard on the host's critical path).
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

// Chunks a slice of `per_slice` elements is cut into (the grid is slices *
// chunks blocks and `partial` holds that many float2).
long long bn_stats_chunks(long long slices, long long per_slice, int vec) {
  const long long vs = vec ? per_slice / 8 : per_slice;
  long long k = (TARGET_BLOCKS + slices - 1) / slices;
  const long long most = vs / (THREADS * UNROLL);
  if (k > most) k = most;
  return k < 1 ? 1 : k;
}

// Does the statistics kernel read x with 16-byte loads: x 16-byte aligned
// and S % 8 == 0.
int bn_stats_vec(const void* x, long long S) {
  return ((uintptr_t)x & 15) == 0 && S % 8 == 0;
}

// x (N, C, S) bf16, contiguous; slices G * C with G = N / R; partial holds
// G * C * K float2, K = bn_stats_chunks(G * C, R * S, bn_stats_vec(x, S)).
int bn_stats_bf16(const void* x, void* partial, long long N, long long C,
                  long long S, long long R, long long K, int device,
                  void* stream) {
  if (N < 1 || C < 1 || S < 1 || R < 1 || N % R || K < 1)
    return (int)cudaErrorInvalidValue;
  const int vec = bn_stats_vec(x, S);
  const long long vs = R * (vec ? S / 8 : S);
  const long long blocks = (N / R) * C * K;
  if (vs >= (1LL << 31) || blocks > 2147483647LL || K > vs)
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* p = static_cast<float2*>(partial);
  cudaStream_t st = (cudaStream_t)stream;
  const FastDiv by_sv = make_div((unsigned)(vec ? S / 8 : S));
  if (vec)
    stats_kernel<8><<<(unsigned)blocks, THREADS, 0, st>>>(
        xb, p, by_sv, (unsigned)C, (unsigned)R, (unsigned)vs, (unsigned)K);
  else
    stats_kernel<1><<<(unsigned)blocks, THREADS, 0, st>>>(
        xb, p, by_sv, (unsigned)C, (unsigned)R, (unsigned)vs, (unsigned)K);
  return (int)cudaGetLastError();
}

// partial (slices, K) float2 from bn_stats_bf16 and n = R * S elements a
// slice; or partial null and run_mean, run_var (C,) with slices == C.
// Writes mean, var (slices,) fp32 (not with partial null) and a, b (slices,)
// bf16.  scale, bias (C,) fp32.
int bn_finish_bf16(const void* partial, long long K, const void* run_mean,
                   const void* run_var, const void* scale, const void* bias,
                   long long C, long long slices, double n, double eps,
                   void* mean, void* var, void* a, void* b, int device,
                   void* stream) {
  if (C < 1 || slices < 1 || slices % C || slices >= (1LL << 31) ||
      (partial == nullptr && slices != C) || (partial != nullptr && K < 1))
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const long long blocks = (slices + THREADS - 1) / THREADS;
  finish_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(partial), (unsigned)K,
      static_cast<const float*>(run_mean), static_cast<const float*>(run_var),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      (unsigned)C, (unsigned)slices, (float)(1.0 / n), (float)eps,
      static_cast<float*>(mean), static_cast<float*>(var),
      static_cast<__nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(b));
  return (int)cudaGetLastError();
}

// y = act(bf16(bf16(x * a) + b)) over x (N, C, S) bf16, contiguous; a, b
// (N / R, C) bf16; y as x, at the same address modulo 16.  act 0 none,
// 1 relu, 2 lrelu with the given slope (a bf16 value).
int bn_apply_bf16(const void* x, void* y, const void* a, const void* b,
                  long long N, long long C, long long S, long long R, int act,
                  float slope, int device, void* stream) {
  if (N < 1 || C < 1 || S < 1 || R < 1 || N % R || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  cudaStream_t st = (cudaStream_t)stream;
  if (act == ACT_RELU)
    return launch_apply<ACT_RELU>(xb, yb, ab, bb, N, C, S, R, slope, st);
  if (act == ACT_LRELU)
    return launch_apply<ACT_LRELU>(xb, yb, ab, bb, N, C, S, R, slope, st);
  return launch_apply<ACT_NONE>(xb, yb, ab, bb, N, C, S, R, slope, st);
}

}  // extern "C"
