// Kernel K2: DCNv2 3x3 modulated deformable convolution (deform_groups=1)
// from precomputed sample coordinates and masks:
//   out[p, f] = sum_t sum_c m[p,t] * bilinear(x, sy[p,t], sx[p,t])[c] * w[t,c,f]
// Bilinear sampling clamps the coordinate into the map and gives zero
// outside (-1, extent), as mv2d_tpu/ops/dcn.py:_dense_bilinear.
//
// Replaces mv2d_tpu/ops/pallas_dcn.py: pallas_dcn_conv (_conv_impl ->
// _run_conv -> _kernel_conv), whose band/overflow split existed to keep
// samples inside VMEM; this kernel reads any offset directly, so it is
// exact for every sample position.
//
// What bounds it on the H100: the gather-then-GEMM form writes the
// [V, Ho, Wo, 9C] modulated samples to device memory and reads them back
// (~150 MB per stage-3 layer in float32), i.e. it is memory bound.  Here a
// block owns 64 output pixels x 64 output channels; per tap it gathers the
// masked bilinear samples of a 32-channel chunk into shared memory and
// accumulates them against the matching [32, 64] slice of w[t] in
// registers, so the samples never leave the chip.  bfloat16 gathers eight
// channels per 16-byte load and runs the products on the tensor cores
// (WMMA 16x16x16, float32 accumulation, samples rounded to bfloat16);
// float32 runs exact float32 FMAs (4x4 per thread).  The gathers are
// repeated once per 64-wide output slice (F / 64 times), which the L2
// cache absorbs.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int TP = 64, TF = 64, KC = 32, NT = 256, TAPS = 9;

// Bilinear corners of pixel p's tap t: pixel indices and weights * mask,
// all weights 0 when the sample lies outside (-1, extent).
__device__ __forceinline__ void tap_corners(
    long long p, int t, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m, int H, int W,
    int HWo, long long N, int* idx, float* wt) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    idx[q] = 0;
    wt[q] = 0.f;
  }
  if (p >= N) return;
  float yy = sy[p * TAPS + t], xx = sx[p * TAPS + t];
  const float mm = m[p * TAPS + t];
  if (!(yy > -1.f && yy < H && xx > -1.f && xx < W)) return;
  yy = fminf(fmaxf(yy, 0.f), (float)(H - 1));
  xx = fminf(fmaxf(xx, 0.f), (float)(W - 1));
  const int y0 = (int)floorf(yy), x0 = (int)floorf(xx);
  const float ly = yy - y0, lx = xx - x0;
  const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);
  const int base = (int)(p / HWo) * H * W;
  idx[0] = base + y0 * W + x0;
  idx[1] = base + y0 * W + x1;
  idx[2] = base + y1 * W + x0;
  idx[3] = base + y1 * W + x1;
  wt[0] = (1.f - ly) * (1.f - lx) * mm;
  wt[1] = (1.f - ly) * lx * mm;
  wt[2] = ly * (1.f - lx) * mm;
  wt[3] = ly * lx * mm;
}

template <typename T>
__global__ void __launch_bounds__(NT) dcn_conv_kernel(
    const T* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const T* __restrict__ w, T* __restrict__ out, int H, int W, int C,
    int HWo, long long N, int F) {
  using mv2d::from_f32;
  using mv2d::to_f32;
  __shared__ float ss[TP * KC];     // masked samples [pixel][channel]
  __shared__ float ws[KC * TF];     // w[t][c0:c0+KC][f0:f0+TF]
  __shared__ int cidx[TP][4];       // corner pixel indices
  __shared__ float cwt[TP][4];      // bilinear weight * mask (0 outside)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long p0 = (long long)blockIdx.x * TP;
  const int f0 = blockIdx.y * TF;
  float acc[4][4] = {};

  for (int t = 0; t < TAPS; ++t) {
    if (tid < TP)
      tap_corners(p0 + tid, t, sy, sx, m, H, W, HWo, N, cidx[tid], cwt[tid]);
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += KC) {
      for (int e = tid; e < TP * KC; e += NT) {
        const int pp = e / KC, c = c0 + e % KC;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s = fmaf(cwt[pp][q], to_f32(x[(size_t)cidx[pp][q] * C + c]), s);
        ss[e] = s;
      }
      for (int e = tid; e < KC * TF; e += NT)
        ws[e] = to_f32(w[((size_t)t * C + c0 + e / TF) * F + f0 + e % TF]);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ss[(ty + 16 * i) * KC + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[k * TF + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty + 16 * i;
    if (p >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[p * F + f0 + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ---- bfloat16: tensor cores; warp w owns output columns 16 * (w % 4)
// and pixel row tiles w / 4 and w / 4 + 2 of the 64 x 64 block tile
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
constexpr int XS = 40, WS = 72;

__global__ void __launch_bounds__(NT) dcn_conv_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const bf16* __restrict__ w, bf16* __restrict__ out, int H, int W, int C,
    int HWo, long long N, int F) {
  __shared__ __align__(128) bf16 ss[TP * XS];   // masked samples
  __shared__ __align__(128) bf16 ws[KC * WS];   // w[t][c0:c0+KC][f0:f0+TF]
  __shared__ __align__(128) float stg[NT / 32][256];
  __shared__ int cidx[TP][4];
  __shared__ float cwt[TP][4];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = warp % 4, r0 = warp / 4;
  const long long p0 = (long long)blockIdx.x * TP;
  const int f0 = blockIdx.y * TF;
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2];
  wm::fill_fragment(acc[0], 0.f);
  wm::fill_fragment(acc[1], 0.f);

  for (int t = 0; t < TAPS; ++t) {
    if (tid < TP)
      tap_corners(p0 + tid, t, sy, sx, m, H, W, HWo, N, cidx[tid], cwt[tid]);
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += KC) {
      {   // one thread: 8 channels of one pixel, 16-byte corner loads
        const int pp = tid / (KC / 8), q = tid % (KC / 8);
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int cq = 0; cq < 4; ++cq) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              x + (size_t)cidx[pp][cq] * C + c0 + q * 8);
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
          const float wq = cwt[pp][cq];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = fmaf(wq, __bfloat162float(e[j]), v[j]);
        }
        uint4 packed;
        bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(v[j]);
        *reinterpret_cast<uint4*>(ss + pp * XS + q * 8) = packed;
      }
      for (int e = tid; e < KC * (TF / 8); e += NT) {
        const int k = e / (TF / 8), q = e % (TF / 8);
        *reinterpret_cast<uint4*>(ws + k * WS + q * 8) =
            *reinterpret_cast<const uint4*>(
                w + ((size_t)t * C + c0 + k) * F + f0 + q * 8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(b, ws + kk * WS + ct * 16, WS);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
          wm::load_matrix_sync(a, ss + (r0 + 2 * i) * 16 * XS + kk, XS);
          wm::mma_sync(acc[i], a, b, acc[i]);
        }
      }
      __syncthreads();
    }
  }
  for (int i = 0; i < 2; ++i) {
    wm::store_matrix_sync(stg[warp], acc[i], 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const long long p = p0 + (r0 + 2 * i) * 16 + e / 16;
      if (p < N) out[p * F + f0 + ct * 16 + e % 16] =
          __float2bfloat16(stg[warp][e]);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int mv2d_dcn_conv(const void* x, const void* sy, const void* sx,
                             const void* m, const void* w, void* out, int V,
                             int H, int W, int C, int Ho, int Wo, int F,
                             int dtype, void* stream) {
  const long long N = (long long)V * Ho * Wo;
  const dim3 grid((unsigned)((N + TP - 1) / TP), F / TF);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* fy = static_cast<const float*>(sy);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fm = static_cast<const float*>(m);
  if (dtype == 0) {
    dcn_conv_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), fy, fx, fm,
        static_cast<const float*>(w), static_cast<float*>(out), H, W, C,
        Ho * Wo, N, F);
  } else if (dtype == 1) {
    dcn_conv_tc_kernel<<<grid, NT, 0, s>>>(
        static_cast<const bf16*>(x), fy, fx, fm, static_cast<const bf16*>(w),
        static_cast<bf16*>(out), H, W, C, Ho * Wo, N, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
