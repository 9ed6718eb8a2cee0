// Kernel K1: one ResNet bottleneck of layer1 (1x1 -> 3x3 -> 1x1, stride 1,
// width 64, frozen BN folded into the float32 weights) with bias, relu and
// the residual (identity, or the 1x1 projection of block 0) fused in.
//
// Replaces mv2d_tpu/ops/pallas_stage.py: fused_stage1 (_run_chain ->
// _kernel), which ran the whole layer1 chain over VMEM-resident row bands.
// Here one launch runs one bottleneck; the host loops over the three.
//
// What bounds it on the H100: the unfused chain writes and re-reads the
// 64-channel intermediates ([12, 128, 352, 64] twice per block) through
// device memory, and at 64 channels each conv is too thin to be compute
// bound.  This kernel keeps both intermediates on chip: a block owns an
// 8x16 output tile, computes conv1 on the 10x18 halo tile into shared
// memory, conv2 from there into shared memory, and streams the folded
// weights in 32- or 64-row chunks; only the block input and output touch
// device memory.  bfloat16 runs the products on the tensor cores (WMMA
// 16x16x16 tiles, float32 accumulation, bfloat16 weights; the
// intermediates are rounded to bfloat16 in shared memory, as the unfused
// bf16 chain rounds them in device memory).  float32 keeps exact float32
// FMAs from shared memory (12x4 or 8x4 register tiles per thread).
// Neither path pipelines its loads yet (cp.async / TMA are later work).
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int P = 64;                  // bottleneck width
constexpr int TH = 8, TW = 16;         // output tile
constexpr int HH = TH + 2, HW = TW + 2;
constexpr int NH = HH * HW;            // 180 halo pixels
constexpr int NHP = 192;               // padded to 12 thread rows of 16
constexpr int NO = TH * TW;            // 128 output pixels
constexpr int KC = 32;                 // input-channel chunk
constexpr int NT = 256;
constexpr int SMEM_FLOATS = NHP * P + NO * P + NHP * KC + P * P;

template <typename T>
__global__ void __launch_bounds__(NT) bottleneck_kernel(
    const T* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, const float* __restrict__ wd,
    const float* __restrict__ bd, T* __restrict__ out, int H, int W,
    int cin) {
  using mv2d::from_f32;
  using mv2d::to_f32;
  extern __shared__ float smem[];
  float* h1 = smem;              // [NHP][P] conv1 output on the halo tile
  float* h2 = h1 + NHP * P;      // [NO][P]  conv2 output
  float* xs = h2 + NO * P;       // [NHP][KC] input channel chunk
  float* ws = xs + NHP * KC;     // [<=P][P] weight chunk
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const T* xv = x + (size_t)blockIdx.z * H * W * cin;
  T* ov = out + (size_t)blockIdx.z * H * W * (4 * P);
  const int cout = 4 * P;

  // ---- conv1 (1x1, cin -> P) + bias + relu on the halo tile; pixels
  // outside the image hold 0 (conv2's zero padding)
  {
    float acc[12][4] = {};
    for (int c0 = 0; c0 < cin; c0 += KC) {
      for (int e = tid; e < NHP * KC; e += NT) {
        const int r = e / KC, k = e % KC;
        float val = 0.f;
        if (r < NH) {
          const int gy = y0 - 1 + r / HW, gx = x0 - 1 + r % HW;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            val = to_f32(xv[((size_t)gy * W + gx) * cin + c0 + k]);
        }
        xs[e] = val;
      }
      for (int e = tid; e < KC * P; e += NT)
        ws[e] = w1[(size_t)(c0 + e / P) * P + e % P];
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[12], b[4];
#pragma unroll
        for (int i = 0; i < 12; ++i) a[i] = xs[(ty + 16 * i) * KC + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[k * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 12; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int r = ty + 16 * i;
      bool ok = false;
      if (r < NH) {
        const int gy = y0 - 1 + r / HW, gx = x0 - 1 + r % HW;
        ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        h1[r * P + n] = ok ? fmaxf(acc[i][j] + b1[n], 0.f) : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- conv2 (3x3, P -> P, stride 1) + bias + relu
  {
    float acc[8][4] = {};
    int hbase[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = ty + 16 * i;
      hbase[i] = (o / TW) * HW + (o % TW);
    }
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * HW + (t % 3);
      for (int e = tid; e < P * P; e += NT) ws[e] = w2[(size_t)t * P * P + e];
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < P; ++k) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = h1[(hbase[i] + off) * P + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[k * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        h2[(ty + 16 * i) * P + n] = fmaxf(acc[i][j] + b2[n], 0.f);
      }
  }
  __syncthreads();

  // ---- conv3 (1x1, P -> 4P) + residual + relu, 64 output channels a pass
  int pix[8];
  bool inside[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = ty + 16 * i, oy = y0 + o / TW, ox = x0 + o % TW;
    inside[i] = oy < H && ox < W;
    pix[i] = inside[i] ? oy * W + ox : 0;
  }
  for (int nc = 0; nc < cout; nc += P) {
    float acc[8][4] = {};
    for (int e = tid; e < P * P; e += NT)
      ws[e] = w3[(size_t)(e / P) * cout + nc + e % P];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = h2[(ty + 16 * i) * P + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (wd != nullptr) {   // block 0: 1x1 projection of the block input
      for (int c0 = 0; c0 < cin; c0 += KC) {
        for (int e = tid; e < NO * KC; e += NT) {
          const int o = e / KC, k = e % KC;
          const int oy = y0 + o / TW, ox = x0 + o % TW;
          xs[e] = (oy < H && ox < W)
                      ? to_f32(xv[((size_t)oy * W + ox) * cin + c0 + k])
                      : 0.f;
        }
        for (int e = tid; e < KC * P; e += NT)
          ws[e] = wd[(size_t)(c0 + e / P) * cout + nc + e % P];
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          float a[8], b[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = xs[(ty + 16 * i) * KC + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = ws[k * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!inside[i]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nc + tx + 16 * j;
        const float res = wd != nullptr
                              ? bd[n]
                              : to_f32(xv[(size_t)pix[i] * cin + n]);
        ov[(size_t)pix[i] * cout + n] =
            from_f32<T>(fmaxf(acc[i][j] + b3[n] + res, 0.f));
      }
    }
  }
}

// ---- bfloat16: tensor cores.  Each of the 8 warps owns one 16-column
// slice of the 64 outputs and 16-row tiles 2 apart; each warp runs its
// epilogues through its own 16x16 float32 staging tile, which keeps the
// block at 82 KB of shared memory (two blocks per SM).
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// row strides in elements; 16-bit rows of HS elements start 32-byte
// aligned at every row, as wmma loads need for the shifted 3x3 taps
constexpr int XS = 40, HS = 80, WS = 72;
constexpr int TC_SMEM = (NHP * HS + NO * HS + NHP * XS + P * WS) * 2 +
                        (NT / 32) * 256 * 4;

// ws[k][n] = w[(k0 + k) * ld + n0 + n] for k < rows, n < 64 (bf16 rows,
// 16-byte copies)
__device__ __forceinline__ void load_w(bf16* ws, const bf16* w, int k0,
                                       int rows, int ld, int n0) {
  for (int e = threadIdx.x; e < rows * (P / 8); e += NT) {
    const int k = e / (P / 8), q = e % (P / 8);
    *reinterpret_cast<uint4*>(ws + k * WS + q * 8) =
        *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * ld + n0 +
                                        q * 8);
  }
}

// xs[r][0:32] = channels c0..c0+31 of the image pixel of tile row r, or 0
__device__ __forceinline__ void load_x(bf16* xs, const bf16* xv, int rows,
                                       int c0, int cin, int H, int W,
                                       int y0, int x0, int halo) {
  const int tw = TW + 2 * halo;
  for (int e = threadIdx.x; e < rows * (KC / 8); e += NT) {
    const int r = e / (KC / 8), q = e % (KC / 8);
    const int gy = y0 - halo + r / tw, gx = x0 - halo + r % tw;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < (TH + 2 * halo) * tw && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const uint4*>(
          xv + ((size_t)gy * W + gx) * cin + c0 + q * 8);
    *reinterpret_cast<uint4*>(xs + r * XS + q * 8) = v;
  }
}

__global__ void __launch_bounds__(NT, 2) bottleneck_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const bf16* __restrict__ w3,
    const float* __restrict__ b3, const bf16* __restrict__ wd,
    const float* __restrict__ bd, bf16* __restrict__ out, int H, int W,
    int cin) {
  extern __shared__ __align__(128) unsigned char raw[];
  bf16* h1 = reinterpret_cast<bf16*>(raw);        // [NHP][HS] conv1 out
  bf16* h2 = h1 + NHP * HS;                       // [NO][HS]  conv2 out
  bf16* xs = h2 + NO * HS;                        // [NHP][XS] input chunk
  bf16* ws = xs + NHP * XS;                       // [P][WS]   weight chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* stw = reinterpret_cast<float*>(ws + P * WS) + warp * 256;
  const int ct = warp % 4, r0 = warp / 4;         // column tile, first row
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const bf16* xv = x + (size_t)blockIdx.z * H * W * cin;
  bf16* ov = out + (size_t)blockIdx.z * H * W * (4 * P);
  const int cout = 4 * P;

  // ---- conv1 on the 12 row tiles of the halo tile; pixels outside the
  // image hold 0 (conv2's zero padding)
  {
    FragC acc[6];
    for (int i = 0; i < 6; ++i) wm::fill_fragment(acc[i], 0.f);
    for (int c0 = 0; c0 < cin; c0 += KC) {
      load_x(xs, xv, NHP, c0, cin, H, W, y0, x0, 1);
      load_w(ws, w1, c0, KC, P, 0);
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
        const int r = (r0 + 2 * i) * 16 + e / 16, n = ct * 16 + e % 16;
        const int gy = y0 - 1 + r / HW, gx = x0 - 1 + r % HW;
        const bool ok = r < NH && gy >= 0 && gy < H && gx >= 0 && gx < W;
        h1[r * HS + n] = __float2bfloat16(ok ? fmaxf(stw[e] + b1[n], 0.f)
                                             : 0.f);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- conv2: output row oy (16 pixels) reads halo rows
  // (oy + dy) * HW + dx .. + 15 of h1 for tap (dy, dx)
  {
    FragC acc[4];
    for (int i = 0; i < 4; ++i) wm::fill_fragment(acc[i], 0.f);
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
      load_w(ws, w2, t * P, P, P, 0);
      __syncthreads();
      for (int kk = 0; kk < P; kk += 16) {
        FragB b;
        wm::load_matrix_sync(b, ws + kk * WS + ct * 16, WS);
        for (int i = 0; i < 4; ++i) {
          FragA a;
          const int oy = r0 + 2 * i;
          wm::load_matrix_sync(a, h1 + ((oy + dy) * HW + dx) * HS + kk, HS);
          wm::mma_sync(acc[i], a, b, acc[i]);
        }
      }
      __syncthreads();
    }
    for (int i = 0; i < 4; ++i) {
      wm::store_matrix_sync(stw, acc[i], 16, wm::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int o = (r0 + 2 * i) * 16 + e / 16, n = ct * 16 + e % 16;
        h2[o * HS + n] = __float2bfloat16(fmaxf(stw[e] + b2[n], 0.f));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- conv3 (+ projection) + residual + relu, 64 output channels a pass
  for (int nc = 0; nc < cout; nc += P) {
    FragC acc[4];
    for (int i = 0; i < 4; ++i) wm::fill_fragment(acc[i], 0.f);
    load_w(ws, w3, 0, P, cout, nc);
    __syncthreads();
    for (int kk = 0; kk < P; kk += 16) {
      FragB b;
      wm::load_matrix_sync(b, ws + kk * WS + ct * 16, WS);
      for (int i = 0; i < 4; ++i) {
        FragA a;
        wm::load_matrix_sync(a, h2 + (r0 + 2 * i) * 16 * HS + kk, HS);
        wm::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    __syncthreads();
    if (wd != nullptr) {
      for (int c0 = 0; c0 < cin; c0 += KC) {
        load_x(xs, xv, NO, c0, cin, H, W, y0, x0, 0);
        load_w(ws, wd, c0, KC, cout, nc);
        __syncthreads();
        for (int kk = 0; kk < KC; kk += 16) {
          FragB b;
          wm::load_matrix_sync(b, ws + kk * WS + ct * 16, WS);
          for (int i = 0; i < 4; ++i) {
            FragA a;
            wm::load_matrix_sync(a, xs + (r0 + 2 * i) * 16 * XS + kk, XS);
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
        const int oy = y0 + o / TW, ox = x0 + o % TW;
        if (oy < H && ox < W) {
          const size_t pix = (size_t)oy * W + ox;
          const float res = wd != nullptr
                                ? bd[n]
                                : __bfloat162float(xv[pix * cin + n]);
          ov[pix * cout + n] =
              __float2bfloat16(fmaxf(stw[e] + b3[n] + res, 0.f));
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int mv2d_bottleneck(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, const void* wd, const void* bd,
                               void* out, int V, int H, int W, int cin,
                               int dtype, void* stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, V);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* f1 = static_cast<const float*>(w1);
  const auto* f2 = static_cast<const float*>(w2);
  const auto* f3 = static_cast<const float*>(w3);
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fb3 = static_cast<const float*>(b3);
  const auto* fd = static_cast<const float*>(wd);
  const auto* fbd = static_cast<const float*>(bd);
  if (dtype == 0) {
    const size_t smem = SMEM_FLOATS * sizeof(float);
    cudaFuncSetAttribute(bottleneck_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    bottleneck_kernel<float><<<grid, NT, smem, s>>>(
        static_cast<const float*>(x), f1, fb1, f2, fb2, f3, fb3, fd, fbd,
        static_cast<float*>(out), H, W, cin);
  } else if (dtype == 1) {   // weights come as bfloat16, biases float32
    cudaFuncSetAttribute(bottleneck_tc_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         TC_SMEM);
    bottleneck_tc_kernel<<<grid, NT, TC_SMEM, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), fb1,
        static_cast<const bf16*>(w2), fb2, static_cast<const bf16*>(w3), fb3,
        static_cast<const bf16*>(wd), fbd, static_cast<bf16*>(out), H, W,
        cin);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
