// Fused convT(k4s2p1) + BatchNorm + ReLU + conv(k4s2p1), channels-last,
// row-band formulation with packed weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel dcgan_sr_tpu/ops/pallas_fused.py
// fused_convT_bn_relu_conv (_stats_kernel :98, _main_kernel :119): the same
// function as csrc/bulge.cu, y = conv(relu(bn(convT(x)))) without writing the
// 2x-resolution hidden tensor h to device memory, but in that kernel's own
// formulation:
//
//   * x and y are NHWC; the image is cut into bands of `tm` rows;
//   * convT is ONE product over K = 4*Ci: the patch matrix row of position
//     (i, j) holds the 2x2 window x[i-1+ti, j-1+tj, :] (ti, tj in {0, 1}), and
//     the packed weight wtall (4Ci, 4Cm) yields all four output parities
//     (di, dj) at once:  p[i, j, (di, dj, cm)] = h[2i - di, 2j - dj, cm];
//   * the consumer conv is ONE product over K = 16*Cm: output (m, n) gathers a
//     2x2 window of positions (m+sa, n+sb) from each of the four parity
//     planes, against the packed weight wcall (16Cm, Co).
//
// Two launches, as on the TPU.  A block owns (image, band, TW columns) and
// walks down its band in passes of R rows.  Each pass
//   A  stages the (R+2) x (TW+2) x Ci window of x in shared memory (zeros
//      outside the image: the kernel pads, the caller does not);
//   B  computes the (R+1) x (TW+1) x 4Cm parity planes into shared memory,
//      each thread holding NC columns of one position in registers;
//      stats: a plane cell is kept only where this pass owns the hidden pixel
//      (every pixel of h is counted exactly once over the grid);
//      main:  (p - mean) * gain + bias, ReLU, and zero where the hidden pixel
//      is the consumer's padding (row or column -1, 2H or 2W);
//   C  stats: per-column sums and sums of squares, carried in registers over
//      the passes and written once per block to its own slot of `partial`
//      (no atomics: the wrapper reduces the slots in a fixed order);
//      main:  the consumer product from the planes, NC output channels of one
//      pixel per thread, stored to y.
// The packed weights stay in shared memory for the whole band.
//
// What went with the TPU: the W padding to the sublane tile, the stores that
// stood in for a lane concatenate, the DMA semaphore.  Any W (ragged chunks
// are masked); H must be a multiple of tm, as in the TPU kernel.
//
// Bound on an H100 (fp32 outside the tensor cores, 67 TFLOP/s; HBM
// 3.35 TB/s): at x (100, 16, 256, 256), Cm 8, Co 16 the two packed products
// are 2048 MAC per pixel each, 26.8 + 53.7 GFLOP for stats + main, 0.40 +
// 0.80 ms, against 0.13 + 0.25 ms for the bytes: both launches are bound by
// operations.  This version is plain fp32 FMA with operands from shared
// memory (three shared loads per eight FMAs); tensor cores, TMA and a pass
// pipeline are later work.
//
// Plain C interface, loaded with ctypes (dcgan_sr_tpu_torch/ops/fused_nhwc.py).
// Each launch entry returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int R = 8;     // band rows per pass
constexpr int TW = 32;   // band columns per block
constexpr int NC = 8;    // product columns a thread keeps in registers
constexpr int XR = R + 2, XC = TW + 2;  // x window of a pass
constexpr int PR = R + 1, PC = TW + 1;  // plane positions of a pass
constexpr int NPOS = PR * PC;

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

// MAIN: out = y (B, H, W, Co), stats = (3, 4Cm) rows mean, gain, bias, each
//       tiled over the four parities.
// else: out = partial (B, H/tm, gridDim.x, 2, Cm), wcall and stats unused.
template <bool MAIN>
__global__ void __launch_bounds__(NT)
fused_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ wtall,
                  const float* __restrict__ wcall,
                  const float* __restrict__ stats, float* __restrict__ out,
                  int H, int W, int ci, int cm, int co, int tm) {
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
  const int b = blockIdx.z, band = blockIdx.y;
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
      const size_t slot = ((size_t)b * gridDim.y + band) * gridDim.x + blockIdx.x;
      out[slot * 2 * cm + tid] = s;
      out[slot * 2 * cm + cm + tid] = q;
    }
  }
}

template <bool MAIN>
int launch(const float* x, const float* wtall, const float* wcall,
           const float* stats, float* out, int B, int H, int W, int ci, int cm,
           int co, int tm, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || tm < 1 || H % tm != 0 || 4 * cm > NT ||
      B > 65535 || H / tm > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)layout(ci, cm, co, MAIN).end;
  cudaError_t e = cudaFuncSetAttribute(
      fused_nhwc_kernel<MAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, H / tm, B);
  fused_nhwc_kernel<MAIN><<<grid, NT, smem, stream>>>(
      x, wtall, wcall, stats, out, H, W, ci, cm, co, tm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns per block; `partial` holds B * (H/tm) * ceil(W/chunk) * 2 * cm floats.
int fused_nhwc_chunk() { return TW; }

// Dynamic shared memory of the main launch (the larger of the two).
size_t fused_nhwc_smem_bytes(int ci, int cm, int co) {
  return sizeof(float) * (size_t)layout(ci, cm, co, true).end;
}

// x (B, H, W, ci) NHWC, wtall (4ci, 4cm) -> partial
int fused_nhwc_stats_f32(const float* x, const float* wtall, float* partial,
                         int B, int H, int W, int ci, int cm, int tm,
                         void* stream) {
  return launch<false>(x, wtall, nullptr, nullptr, partial, B, H, W, ci, cm, 0,
                       tm, (cudaStream_t)stream);
}

// x as above, wcall (16cm, co), stats (3, 4cm) -> y (B, H, W, co) NHWC
int fused_nhwc_main_f32(const float* x, const float* wtall, const float* wcall,
                        const float* stats, float* y, int B, int H, int W,
                        int ci, int cm, int co, int tm, void* stream) {
  return launch<true>(x, wtall, wcall, stats, y, B, H, W, ci, cm, co, tm,
                      (cudaStream_t)stream);
}

}  // extern "C"
