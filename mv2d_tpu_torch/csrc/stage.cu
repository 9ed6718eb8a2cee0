// Kernel B10: one identity ResNet bottleneck of a later stage (1x1 -> 3x3
// -> 1x1, stride 1, width P = 128 or 256, Cin = Cout = 4P, frozen BN folded
// into the weights) with bias, relu and the identity residual fused in.
//
// Replaces mv2d_tpu/ops/pallas_stage.py: fused_identity_chain (_run_chain ->
// _kernel with has_ds=False), which ran blocks 1..n-1 of a DCN-free stage as
// one VMEM-resident chain over row bands.  Here one launch runs one
// bottleneck and the host loops over the chain, as K1 (stage1.cu) does.
//
// What bounds it on the H100: at 4P = 512 or 1024 channels each conv is a
// deep enough product to be compute bound in bfloat16 (the chain's bound is
// its operations), but the unfused chain also writes and re-reads both
// P-wide intermediates through device memory.  This kernel keeps them on
// chip: a block owns a TH x 16 output tile, computes conv1 on the
// (TH + 2) x 18 halo tile into shared memory, conv2 from there into shared
// memory, then conv3 with the residual; only the block input and output
// touch device memory.  K1's tile does not fit at these widths (its
// float32 halo tile alone would take 192 KB at P = 256), so every conv runs
// in passes of 64 output channels and the weights stream in 32- or 64-row
// chunks.  float32 runs exact FMAs from shared memory on a 4 x 16 tile
// (4x4 or 7x4 register tiles per thread, ~201 KB at P = 256).  bfloat16
// runs the products on the tensor cores (WMMA 16x16x16, float32
// accumulation) on an 8 x 16 tile with the intermediates rounded to
// bfloat16 in shared memory, as the unfused bf16 chain rounds them in
// device memory (~202 KB at P = 256).  Neither path pipelines its loads
// (cp.async / TMA) or uses wgmma yet.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int TW = 16;   // output tile width
constexpr int KC = 32;   // input-channel chunk of conv1
constexpr int NC = 64;   // output channels per pass

// ---- float32: exact FMAs on a 4 x 16 output tile
constexpr int FTH = 4, FHW = TW + 2;
constexpr int FNH = (FTH + 2) * FHW;   // 108 halo pixels
constexpr int FNHP = 112;              // padded to 7 thread rows of 16
constexpr int FNO = FTH * TW;          // 64 output pixels
constexpr int FXS = KC + 1;            // input chunk row stride

template <int P>
constexpr int fma_smem_bytes() {
  return (FNHP * (P + 4) + FNO * (P + 4) + FNHP * FXS + KC * NC) * 4;
}

template <typename T, int P>
__global__ void __launch_bounds__(NT) identity_block_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, const T* __restrict__ w3,
    const float* __restrict__ b3, T* __restrict__ out, int H, int W) {
  using mv2d::from_f32;
  using mv2d::to_f32;
  constexpr int CIN = 4 * P, S = P + 4;
  extern __shared__ float smem[];
  float* h1 = smem;               // [FNHP][S] conv1 output on the halo tile
  float* h2 = h1 + FNHP * S;      // [FNO][S]  conv2 output
  float* xs = h2 + FNO * S;       // [FNHP][FXS] input channel chunk
  float* ws = xs + FNHP * FXS;    // [KC][NC] weight chunk
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int y0 = blockIdx.y * FTH, x0 = blockIdx.x * TW;
  const T* xv = x + (size_t)blockIdx.z * H * W * CIN;
  T* ov = out + (size_t)blockIdx.z * H * W * CIN;

  // ---- conv1 (1x1, 4P -> P) + bias + relu on the halo tile; pixels
  // outside the image hold 0 (conv2's zero padding)
  for (int nc = 0; nc < P; nc += NC) {
    float acc[7][4] = {};
    for (int c0 = 0; c0 < CIN; c0 += KC) {
      for (int e = tid; e < FNHP * KC; e += NT) {
        const int r = e / KC, k = e % KC;
        float val = 0.f;
        if (r < FNH) {
          const int gy = y0 - 1 + r / FHW, gx = x0 - 1 + r % FHW;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            val = to_f32(xv[((size_t)gy * W + gx) * CIN + c0 + k]);
        }
        xs[r * FXS + k] = val;
      }
      for (int e = tid; e < KC * NC; e += NT)
        ws[e] = to_f32(w1[(size_t)(c0 + e / NC) * P + nc + e % NC]);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[7], b[4];
#pragma unroll
        for (int i = 0; i < 7; ++i) a[i] = xs[(ty + 16 * i) * FXS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[k * NC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 7; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const int r = ty + 16 * i;
      bool ok = false;
      if (r < FNH) {
        const int gy = y0 - 1 + r / FHW, gx = x0 - 1 + r % FHW;
        ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nc + tx + 16 * j;
        h1[r * S + n] = ok ? fmaxf(acc[i][j] + b1[n], 0.f) : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- conv2 (3x3, P -> P) + bias + relu; output pixel o reads halo
  // pixel hb + (dy * FHW + dx) for tap (dy, dx)
  int hb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = ty + 16 * i;
    hb[i] = (o / TW) * FHW + o % TW;
  }
  for (int nc = 0; nc < P; nc += NC) {
    float acc[4][4] = {};
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * FHW + t % 3;
      for (int c0 = 0; c0 < P; c0 += KC) {
        for (int e = tid; e < KC * NC; e += NT)
          ws[e] = to_f32(
              w2[((size_t)t * P + c0 + e / NC) * P + nc + e % NC]);
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = h1[(hb[i] + off) * S + c0 + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = ws[k * NC + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nc + tx + 16 * j;
        h2[(ty + 16 * i) * S + n] = fmaxf(acc[i][j] + b2[n], 0.f);
      }
  }
  __syncthreads();

  // ---- conv3 (1x1, P -> 4P) + bias + identity + relu
  for (int nc = 0; nc < CIN; nc += NC) {
    float acc[4][4] = {};
    for (int c0 = 0; c0 < P; c0 += KC) {
      for (int e = tid; e < KC * NC; e += NT)
        ws[e] = to_f32(w3[(size_t)(c0 + e / NC) * CIN + nc + e % NC]);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = h2[(ty + 16 * i) * S + c0 + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[k * NC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = ty + 16 * i, oy = y0 + o / TW, ox = x0 + o % TW;
      if (oy >= H || ox >= W) continue;
      const size_t pix = (size_t)oy * W + ox;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nc + tx + 16 * j;
        const float res = to_f32(xv[pix * CIN + n]);
        ov[pix * CIN + n] = from_f32<T>(fmaxf(acc[i][j] + b3[n] + res, 0.f));
      }
    }
  }
}

// ---- bfloat16: tensor cores on an 8 x 16 output tile.  Each of the 8
// warps owns one 16-column slice of a 64-channel pass and the 16-row tiles
// 2 apart; each warp runs its epilogues through its own 16x16 float32
// staging tile.
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

constexpr int TTH = 8, THW = TW + 2;
constexpr int TNH = (TTH + 2) * THW;   // 180 halo pixels
constexpr int TNHP = 192;              // padded to 12 row tiles of 16
constexpr int TNO = TTH * TW;          // 128 output pixels
// bf16 row strides: every row starts 32-byte aligned (wmma loads of the
// shifted 3x3 taps start at any row)
constexpr int XS = KC + 8, WS = NC + 8;

template <int P>
constexpr int tc_smem_bytes() {
  return (TNHP * (P + 16) + TNO * (P + 16) + TNHP * XS + NC * WS) * 2 +
         (NT / 32) * 256 * 4;
}

// ws[k][n] = w[(row0 + k) * ld + n0 + n] for k < rows, n < 64 (16-byte
// copies)
__device__ __forceinline__ void load_w(bf16* ws, const bf16* w, size_t row0,
                                       int rows, int ld, int n0) {
  for (int e = threadIdx.x; e < rows * (NC / 8); e += NT) {
    const int k = e / (NC / 8), q = e % (NC / 8);
    *reinterpret_cast<uint4*>(ws + k * WS + q * 8) =
        *reinterpret_cast<const uint4*>(w + (row0 + k) * ld + n0 + q * 8);
  }
}

// xs[r][0:32] = channels c0..c0+31 of halo pixel r, or 0 outside the image
__device__ __forceinline__ void load_halo(bf16* xs, const bf16* xv, int c0,
                                          int cin, int H, int W, int y0,
                                          int x0) {
  for (int e = threadIdx.x; e < TNHP * (KC / 8); e += NT) {
    const int r = e / (KC / 8), q = e % (KC / 8);
    const int gy = y0 - 1 + r / THW, gx = x0 - 1 + r % THW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < TNH && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const uint4*>(
          xv + ((size_t)gy * W + gx) * cin + c0 + q * 8);
    *reinterpret_cast<uint4*>(xs + r * XS + q * 8) = v;
  }
}

template <int P>
__global__ void __launch_bounds__(NT) identity_block_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const bf16* __restrict__ w3,
    const float* __restrict__ b3, bf16* __restrict__ out, int H, int W) {
  constexpr int CIN = 4 * P, HS = P + 16;
  extern __shared__ __align__(128) unsigned char raw[];
  bf16* h1 = reinterpret_cast<bf16*>(raw);   // [TNHP][HS] conv1 out
  bf16* h2 = h1 + TNHP * HS;                 // [TNO][HS]  conv2 out
  bf16* xs = h2 + TNO * HS;                  // [TNHP][XS] input chunk
  bf16* ws = xs + TNHP * XS;                 // [NC][WS]   weight chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* stw = reinterpret_cast<float*>(ws + NC * WS) + warp * 256;
  const int ct = warp % 4, r0 = warp / 4;    // column tile, first row tile
  const int y0 = blockIdx.y * TTH, x0 = blockIdx.x * TW;
  const bf16* xv = x + (size_t)blockIdx.z * H * W * CIN;
  bf16* ov = out + (size_t)blockIdx.z * H * W * CIN;

  // ---- conv1 on the 12 row tiles of the halo tile; pixels outside the
  // image hold 0 (conv2's zero padding)
  for (int nc = 0; nc < P; nc += NC) {
    FragC acc[6];
    for (int i = 0; i < 6; ++i) wm::fill_fragment(acc[i], 0.f);
    for (int c0 = 0; c0 < CIN; c0 += KC) {
      load_halo(xs, xv, c0, CIN, H, W, y0, x0);
      load_w(ws, w1, c0, KC, P, nc);
      __syncthreads();
      for (int kk = 0; kk < KC; kk += 16) {
        FragB b;
        wm::load_matrix_sync(b, ws + kk * WS + ct * 16, WS);
        for (int i = 0; i < 6; ++i) {
          FragA a;
          wm::load_matrix_sync(a, xs + (r0 + 2 * i) * 16 * XS + kk, XS);
          wm::mma_sync(acc[i], a, b, acc[i]);
        }
      }
      __syncthreads();
    }
    for (int i = 0; i < 6; ++i) {
      wm::store_matrix_sync(stw, acc[i], 16, wm::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = (r0 + 2 * i) * 16 + e / 16, n = nc + ct * 16 + e % 16;
        const int gy = y0 - 1 + r / THW, gx = x0 - 1 + r % THW;
        const bool ok = r < TNH && gy >= 0 && gy < H && gx >= 0 && gx < W;
        h1[r * HS + n] = __float2bfloat16(ok ? fmaxf(stw[e] + b1[n], 0.f)
                                             : 0.f);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- conv2: output row oy (16 pixels) reads halo pixels
  // (oy + dy) * THW + dx .. + 15 of h1 for tap (dy, dx)
  for (int nc = 0; nc < P; nc += NC) {
    FragC acc[4];
    for (int i = 0; i < 4; ++i) wm::fill_fragment(acc[i], 0.f);
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
      for (int c0 = 0; c0 < P; c0 += NC) {
        load_w(ws, w2, (size_t)t * P + c0, NC, P, nc);
        __syncthreads();
        for (int kk = 0; kk < NC; kk += 16) {
          FragB b;
          wm::load_matrix_sync(b, ws + kk * WS + ct * 16, WS);
          for (int i = 0; i < 4; ++i) {
            FragA a;
            const int oy = r0 + 2 * i;
            wm::load_matrix_sync(
                a, h1 + ((oy + dy) * THW + dx) * HS + c0 + kk, HS);
            wm::mma_sync(acc[i], a, b, acc[i]);
          }
        }
        __syncthreads();
      }
    }
    for (int i = 0; i < 4; ++i) {
      wm::store_matrix_sync(stw, acc[i], 16, wm::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int o = (r0 + 2 * i) * 16 + e / 16, n = nc + ct * 16 + e % 16;
        h2[o * HS + n] = __float2bfloat16(fmaxf(stw[e] + b2[n], 0.f));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- conv3 + bias + identity + relu, 64 output channels a pass
  for (int nc = 0; nc < CIN; nc += NC) {
    FragC acc[4];
    for (int i = 0; i < 4; ++i) wm::fill_fragment(acc[i], 0.f);
    for (int c0 = 0; c0 < P; c0 += NC) {
      load_w(ws, w3, c0, NC, CIN, nc);
      __syncthreads();
      for (int kk = 0; kk < NC; kk += 16) {
        FragB b;
        wm::load_matrix_sync(b, ws + kk * WS + ct * 16, WS);
        for (int i = 0; i < 4; ++i) {
          FragA a;
          wm::load_matrix_sync(a, h2 + (r0 + 2 * i) * 16 * HS + c0 + kk, HS);
          wm::mma_sync(acc[i], a, b, acc[i]);
        }
      }
      __syncthreads();
    }
    for (int i = 0; i < 4; ++i) {
      wm::store_matrix_sync(stw, acc[i], 16, wm::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int o = (r0 + 2 * i) * 16 + e / 16, n = nc + ct * 16 + e % 16;
        const int oy = y0 + o / TW, ox = x0 + o % TW;
        if (oy < H && ox < W) {
          const size_t pix = (size_t)oy * W + ox;
          const float res = __bfloat162float(xv[pix * CIN + n]);
          ov[pix * CIN + n] =
              __float2bfloat16(fmaxf(stw[e] + b3[n] + res, 0.f));
        }
      }
      __syncwarp();
    }
  }
}

template <int P>
int launch_block(const void* x, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3,
                 const void* b3, void* out, int V, int H, int W, int dtype,
                 cudaStream_t s) {
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fb3 = static_cast<const float*>(b3);
  if (dtype == 0) {
    constexpr int smem = fma_smem_bytes<P>();
    cudaFuncSetAttribute(identity_block_kernel<float, P>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((W + TW - 1) / TW, (H + FTH - 1) / FTH, V);
    identity_block_kernel<float, P><<<grid, NT, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), fb1,
        static_cast<const float*>(w2), fb2, static_cast<const float*>(w3),
        fb3, static_cast<float*>(out), H, W);
  } else if (dtype == 1) {   // weights come as bfloat16, biases float32
    constexpr int smem = tc_smem_bytes<P>();
    cudaFuncSetAttribute(identity_block_tc_kernel<P>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((W + TW - 1) / TW, (H + TTH - 1) / TTH, V);
    identity_block_tc_kernel<P><<<grid, NT, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), fb1,
        static_cast<const bf16*>(w2), fb2, static_cast<const bf16*>(w3), fb3,
        static_cast<bf16*>(out), H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [V, H, W, 4 * planes] (dtype); w1 [4P, P], w2 [9, P, P] (tap-major),
// w3 [P, 4P] in x's dtype; b1, b2 [P], b3 [4P] float32; planes 128 or 256
extern "C" int mv2d_identity_block(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, void* out, int V, int H,
                                   int W, int planes, int dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (planes == 128)
    return launch_block<128>(x, w1, b1, w2, b2, w3, b3, out, V, H, W, dtype,
                             s);
  if (planes == 256)
    return launch_block<256>(x, w1, b1, w2, b2, w3, b3, out, V, H, W, dtype,
                             s);
  return static_cast<int>(cudaErrorInvalidValue);
}
