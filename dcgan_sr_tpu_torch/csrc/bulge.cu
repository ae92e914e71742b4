// Fused convT(k4s2p1) + BatchNorm + ReLU + conv(k4s2p1) for Hopper (sm_90a).
//
// Replaces the TPU kernel dcgan_sr_tpu/ops/pallas_bulge.py fused_bulge_fwd
// (_stats_kernel :159, _main_kernel :206): the gray-3 generator's layers 3-4
// (models/specs.py), y = conv(relu(bn(convT(x)))), without writing the
// 2x-resolution hidden tensor h to device memory.
//
// Two launches, as on the TPU, but shaped for an SM rather than for VMEM:
//
//   stats  one block per (image, T x T tile of x).  It computes the 2T x 2T
//          hidden tile that tile owns as four output-parity 2x2 sub-convs,
//            h[2i+di, 2j+dj] = sum_{ci,ti,tj} x[i+di-1+ti, j+dj-1+tj]
//                                             * wT[ci, cm, 3-di-2ti, 3-dj-2tj]
//          (x outside the image is zero), and writes that tile's fp32
//          per-channel sum and sum of squares to its own slot of `partial`.
//          No atomics: the wrapper reduces the slots in a fixed order, so a
//          run repeats bit for bit.
//   main   one block per (image, T x T tile of y), all Co channels.  It stages
//          x with a 2-pixel halo in shared memory, recomputes the
//          (2T+2) x (2T+2) hidden tile the consumer's 4x4 stride-2 window
//          reads, normalises it with (mu, gain, beta) per (image, channel),
//          applies ReLU, zeroes hidden rows/columns -1 and 2H/2W (the
//          consumer's zero padding), and runs the consumer conv from shared
//          memory.
//
// Any H and W: ragged edge tiles are masked here (the TPU version asserted
// W % 128 == 0 and H % tm == 0).
//
// Bound on an H100 (fp32 outside the tensor cores, 67 TFLOP/s; HBM 3.35 TB/s):
// per LR-256 serve request x is (1, 16, 2048, 2048); the stats pass does
// 16*H*W*Ci*Cm = 8.6 GMAC, the main pass twice that (convT again + the
// consumer), about 52 GFLOP together, ~0.77 ms; the bytes (x read twice, y
// written once, 0.8 GB) take ~0.24 ms.  So both launches are bound by
// operations.  This first version uses plain fp32 FMA from shared memory,
// with weights broadcast from shared memory; tensor cores (TF32/bf16 MMA)
// and a single-pass design are later work.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/bulge.py).
// Each entry returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

}  // namespace

extern "C" {

// Tile side; `partial` holds B * ceil(H/T) * ceil(W/T) * 2 * cm floats.
int bulge_tile() { return T; }

size_t bulge_main_smem_bytes(int ci, int cm, int co) {
  return main_smem(ci, cm, co);
}

// Channel counts with a compiled instantiation: (cm, co) = (4, 8), (8, 16)
// (gray-3 at ngf 8) and (16, 32) (the patch variants at ngf 16).
int bulge_supported(int cm, int co) {
  return (cm == 4 && co == 8) || (cm == 8 && co == 16) ||
         (cm == 16 && co == 32);
}

int bulge_stats_f32(const float* x, const float* wT, float* partial, int B,
                    int ci, int cm, int H, int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (cm) {
    case 4: return launch_stats<4>(x, wT, partial, B, ci, H, W, s);
    case 8: return launch_stats<8>(x, wT, partial, B, ci, H, W, s);
    case 16: return launch_stats<16>(x, wT, partial, B, ci, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

int bulge_main_f32(const float* x, const float* wT, const float* wC,
                   const float* mu, const float* gain, const float* beta,
                   float* y, int B, int ci, int cm, int co, int H, int W,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cm == 4 && co == 8)
    return launch_main<4, 8>(x, wT, wC, mu, gain, beta, y, B, ci, H, W, s);
  if (cm == 8 && co == 16)
    return launch_main<8, 16>(x, wT, wC, mu, gain, beta, y, B, ci, H, W, s);
  if (cm == 16 && co == 32)
    return launch_main<16, 32>(x, wT, wC, mu, gain, beta, y, B, ci, H, W, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
