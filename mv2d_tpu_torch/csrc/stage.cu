// Kernel B10: one identity ResNet bottleneck of a later stage (1x1 -> 3x3
// -> 1x1, stride 1, width P = 128 or 256, Cin = Cout = 4P, frozen BN folded
// into the weights) with bias, relu and the identity residual fused in.
//
// Replaces mv2d_tpu/ops/pallas_stage.py: fused_identity_chain (_run_chain ->
// _kernel with has_ds=False), which ran blocks 1..n-1 of a DCN-free stage as
// one VMEM-resident chain over row bands.  Here one launch runs one
// bottleneck and the host loops over the chain, as K1 (stage1.cu) does.
//
// What bounds it on the H100: operations.  A bottleneck is 2 N (4P P + 9 P P
// + P 4P) = 75.3 GFLOP at both main-path shapes (layer2's [12, 64, 176, 512]
// and layer3's [12, 32, 88, 1024]), 0.076 ms at the bf16 peak, against
// 0.083 / 0.041 ms for its input and output bytes.  The first form (WMMA
// 16x16x16, no pipelined loads, one non-persistent block an SM at ~202 KB)
// took 5.74 / 11.50 ms for the two chains, 2.3x and 5.1x the cuDNN chain
// it replaces.
//
// bfloat16 (the model's path) carries K1's design over to widths whose
// weights (544 KB at P = 128, 2.2 MB at P = 256) cannot stay resident: a
// persistent block per SM, two warpgroups, walks TH x 16 output tiles
// (TH = 8 at P = 128, 4 at P = 256, so that both P-wide intermediates fit):
//  * everything the block reads goes through one TMA ring of 64-row chunks
//    (four stages at P = 128, three at P = 256), in the order the products
//    take them: for conv1 the input's (TH + 2) x 18 halo tile in a
//    64-channel box (a 4D map over [V, H, W, C]; out-of-image pixels arrive
//    as zeros, conv2's padding) with the matching 64 rows of w1, then 64-row
//    chunks of w2 and of w3; the weights stream from L2, and the ring runs
//    across tiles, so the next tile's first chunks load under this tile's
//    conv3;
//  * conv1 and conv3 are wgmma with both operands in shared memory (the
//    halo box or h2 K-major, the weight chunk MN-major as w stores it);
//    conv2 is wgmma with A from registers: ldmatrix with per-lane row
//    addresses makes each 3x3 tap a row shift into h1;
//  * h1 (conv1 on the halo tile) and h2 (conv2, written over h1 once both
//    warpgroups are done with it) are bfloat16 in 128-byte-swizzled rows,
//    rounded where the unfused bf16 chain rounds them; bias and relu are
//    applied on the accumulators, as are conv3's bias, its rounding, the
//    identity (16-byte loads of the input, issued before a conv3 group's
//    products so that they hide its latency) and the last relu, and the
//    output leaves in 16-byte stores from registers;
//  * a chunk's stage is refilled once both warpgroups have finished its
//    products (wgmma_wait<1> leaves the next chunk's products running).
// Each weight byte fed to the tensor cores feeds 2 x 180 (P = 128) or
// 2 x 108 (P = 256) products: the tile is as large as shared memory lets
// it be (h1 alone is 48 / 64 KB).  Shared memory a block: 212 KB at P = 128
// (ring 4 x 40 KB, h1 48 KB), 215 KB at P = 256 (ring 3 x 48 KB, h1 64 KB).
// Nothing is atomic: two runs give equal bits.
// 1.059 / 1.423 ms for layer2's and layer3's chains (chip_smoke.py;
// NVIDIA H100 80GB HBM3, 700 W), 22% / 27% of the bound.  What holds it,
// in order (a scratch build with each phase switched off in turn): the
// ring's stream from L2, weights mostly (~770 MB a P = 128 launch), then
// the output's stores from registers.  Tried on the way: the identity
// loaded after conv3's products (its latency exposed: slower).
//
// float32 (the parity tests, TF32 off) keeps exact FMAs from shared memory
// on a 4 x 16 tile (4x4 or 7x4 register tiles per thread, ~201 KB at
// P = 256), one block a tile, nothing pipelined.
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

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

// ---- bfloat16 (the design is in the note at the top of this file)
using bf16 = __nv_bfloat16;

template <int P>
struct Chain {
  static constexpr int TH = P == 128 ? 8 : 4;      // output tile TH x TW
  static constexpr int HWD = TW + 2, NH = (TH + 2) * HWD;   // halo pixels
  static constexpr int NHP = (NH + 63) / 64 * 64;  // padded to m64 blocks
  static constexpr int MB1 = NHP / 64;             // conv1's m64 blocks
  static constexpr int NO = TH * TW, MB2 = NO / 64;   // output pixels
  static constexpr int CIN = 4 * P, KB = P / 64;   // 64-channel blocks of P
  // conv3 goes in four groups of GC output channels: a warpgroup takes
  // 64 rows x 128 of them (its rows of a 128-column group at P = 128, its
  // half of a 256-column group at P = 256)
  static constexpr int GC = 256 / MB2, NG3 = CIN / GC;
  // ring chunks a tile: conv1's (input box + w1 rows), w2's, w3's
  static constexpr int NC1 = CIN / 64, NC2 = 9 * KB, NC3 = NG3 * KB;
  static constexpr int CPT = NC1 + NC2 + NC3;
  static constexpr int N1 = P / 2;                 // conv1 columns a warpgroup
  static constexpr int XS = NHP * 128;             // a 64-channel halo block
  static constexpr int XB = NH * 128;              // the bytes its box brings
  static constexpr int STG = XS + P * 128;         // > a w2 or w3 chunk
  static constexpr int S = P == 128 ? 4 : 3;       // ring stages
  static constexpr int H1 = S * STG;   // h1 [KB][NHP][128 B]; h2 [KB][NO][128 B]
  static constexpr int BIAS = H1 + KB * XS;
  static constexpr int BAR = BIAS + 6 * P * 4;
  static constexpr int BYTES = BAR + 8 * S + 1024;  // + the base's alignment
  static_assert(NC2 % 2 == 0, "conv2's fragments alternate two buffers");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

template <int P>
__global__ void __launch_bounds__(NT, 1) identity_chain_tc_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap w1map,
    const __grid_constant__ CUtensorMap w2map,
    const __grid_constant__ CUtensorMap w3map, const bf16* __restrict__ x,
    const float* __restrict__ b1, const float* __restrict__ b2,
    const float* __restrict__ b3, bf16* __restrict__ out, int H, int W,
    int tiles_w, int tiles_hw, int tiles) {
  using L = Chain<P>;
  using namespace mv2d::tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =                   // the swizzle needs 1024-byte atoms
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t h1 = smem_u32(sm) + L::H1;
  float* bias = reinterpret_cast<float*>(sm + L::BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, lw = warp & 3;
  const int g8 = lane >> 2, tq = lane & 3, lr = lane & 15, lc = lane >> 4;
  // this block's tiles: blockIdx.x, + gridDim.x, ...; ring chunk q is chunk
  // q % CPT of its tile q / CPT, in stage q % S
  const int mine = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int nq = mine * L::CPT;
  auto origin = [&](int j, int& v, int& y0, int& x0) {
    const int id = blockIdx.x + j * gridDim.x;
    v = id / tiles_hw;
    const int r = id - v * tiles_hw;
    y0 = (r / tiles_w) * L::TH;
    x0 = (r % tiles_w) * TW;
  };
  auto issue = [&](int q) {             // one thread
    if (q >= nq) return;
    const int s = q % L::S, i = q % L::CPT;
    unsigned char* st = sm + s * L::STG;
    if (i < L::NC1) {                   // input channels 64 i.. + w1 rows
      int v, y0, x0;
      origin(q / L::CPT, v, y0, x0);
      mbar_expect_tx(full + s, L::XB + P * 128);
      tma_load_4d(st, &xmap, i * 64, x0 - 1, y0 - 1, v, full + s);
      for (int b = 0; b < L::KB; ++b)
        tma_load_2d(st + L::XS + b * 8192, &w1map, b * 64, i * 64, full + s);
    } else if (i < L::NC1 + L::NC2) {   // w2 rows 64 k.. (tap k / KB)
      const int k = i - L::NC1;
      mbar_expect_tx(full + s, P * 128);
      for (int b = 0; b < L::KB; ++b)
        tma_load_2d(st + b * 8192, &w2map, b * 64, k * 64, full + s);
    } else {                            // w3 rows, a GC-column group
      const int k = i - L::NC1 - L::NC2;
      mbar_expect_tx(full + s, L::GC * 128);
      for (int b = 0; b < L::GC / 64; ++b)
        tma_load_2d(st + b * 8192, &w3map, (k / L::KB) * L::GC + b * 64,
                    (k % L::KB) * 64, full + s);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < L::S; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
    for (int q = 0; q < L::S; ++q) issue(q);
  }
  for (int e = tid; e < 6 * P; e += NT)
    bias[e] = e < P ? b1[e] : e < 2 * P ? b2[e - P] : b3[e - 2 * P];
  __syncthreads();

  int q = 0;
  // a chunk's stage, once its data is in
  auto acquire = [&]() -> unsigned char* {
    const int s = q % L::S;
    mbar_wait(full + s, (q / L::S) & 1);
    return sm + s * L::STG;
  };
  // after chunk q's products are committed: the previous chunk of the
  // phase is done in both warpgroups, and its stage is refilled
  auto release = [&](bool first) {
    __syncthreads();
    if (tid == 0 && !first) issue(q - 1 + L::S);
    ++q;
  };
  // the phase's last chunk, once its products are done everywhere
  auto release_last = [&]() {
    __syncthreads();
    if (tid == 0) issue(q - 1 + L::S);
  };

  for (int j = 0; j < mine; ++j) {
    int v, y0, x0;
    origin(j, v, y0, x0);

    // ---- conv1 (1x1, 4P -> P) on the NHP (NH used) halo rows; warpgroup
    // g takes columns N1 g ..
    {
      float acc[L::MB1 * L::N1 / 2];
#pragma unroll
      for (int r = 0; r < L::MB1 * L::N1 / 2; ++r) acc[r] = 0.f;
      for (int k = 0; k < L::NC1; ++k) {
        unsigned char* st = acquire();
#pragma unroll
        for (int r = 0; r < L::MB1 * L::N1 / 2; ++r) fence_operand(acc[r]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mb = 0; mb < L::MB1; ++mb)
            wgmma_ss<L::N1, 0, 1>(
                acc + mb * (L::N1 / 2),
                desc_sw128(st + mb * 8192 + kk * 32, 16, 1024),
                desc_sw128(st + L::XS + wg * (L::N1 / 64) * 8192 + kk * 2048,
                           8192, 1024));
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int r = 0; r < L::MB1 * L::N1 / 2; ++r) fence_operand(acc[r]);
        release(k == 0);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < L::MB1 * L::N1 / 2; ++r) fence_operand(acc[r]);
      release_last();
      // bias + relu -> h1; 0 outside the image (conv2's zero padding)
#pragma unroll
      for (int mb = 0; mb < L::MB1; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mb * 64 + lw * 16 + g8 + 8 * h;
          const int gy = y0 - 1 + r / L::HWD, gx = x0 - 1 + r % L::HWD;
          const bool ok = r < L::NH && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int n = 0; n < L::N1 / 8; ++n) {
            const int col = wg * L::N1 + 8 * n + 2 * tq;
            const float* a = acc + mb * (L::N1 / 2) + 4 * n + 2 * h;
            *reinterpret_cast<uint32_t*>(sm + L::H1 + (col >> 6) * L::XS +
                                         swz(r, (col & 63) >> 3) +
                                         (col & 7) * 2) =
                ok ? pack_bf16(fmaxf(a[0] + bias[col], 0.f),
                               fmaxf(a[1] + bias[col + 1], 0.f))
                   : 0u;
          }
        }
      __syncthreads();
    }

    // ---- conv2 (3x3, P -> P): 128 columns a warpgroup (all of P at
    // P = 128, where warpgroup g takes output rows 4g..; half of it at
    // P = 256); warp w's A fragment is its output row, tap (dy, dx) reading
    // h1 rows (row + dy) * 18 + dx + 0..15 by ldmatrix into registers, a
    // chunk ahead of its product
    {
      const int orow = (L::MB2 == 2 ? 4 * wg : 0) + lw;
      const int n2 = L::MB2 == 2 ? 0 : 128 * wg;
      float acc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = 0.f;
      uint32_t fa[4][4], fb[4][4];
      auto frag = [&](int k, uint32_t (&f)[4][4]) {
        const int tap = k / L::KB;
        const uint32_t base = h1 + (k % L::KB) * L::XS;
        const int row = (orow + tap / 3) * L::HWD + tap % 3 + lr;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(f[kk], base + swz(row, 2 * kk + lc));
      };
      auto chunk = [&](int k, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
        unsigned char* st = acquire();
#pragma unroll
        for (int r = 0; r < 64; ++r) fence_operand(acc[r]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<128>(acc, cur[kk],
                        desc_sw128(st + (n2 / 64) * 8192 + kk * 2048, 8192,
                                   1024));
        wgmma_commit();
        wgmma_wait<1>();                // chunk k - 1's fragments are free
#pragma unroll
        for (int r = 0; r < 64; ++r) fence_operand(acc[r]);
        if (k + 1 < L::NC2) frag(k + 1, nxt);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) fence_operand(nxt[kk][e]);
        release(k == 0);
      };
      frag(0, fa);
      for (int k = 0; k < L::NC2; k += 2) {
        chunk(k, fa, fb);
        chunk(k + 1, fb, fa);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 64; ++r) fence_operand(acc[r]);
      release_last();                   // h1 is read: h2 goes over it
      // bias + relu -> h2
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (L::MB2 == 2 ? 64 * wg : 0) + lw * 16 + g8 + 8 * h;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const int col = n2 + 8 * n + 2 * tq;
          *reinterpret_cast<uint32_t*>(sm + L::H1 + (col >> 6) * (L::NO * 128) +
                                       swz(o, (col & 63) >> 3) +
                                       (col & 7) * 2) =
              pack_bf16(fmaxf(acc[4 * n + 2 * h] + bias[P + col], 0.f),
                        fmaxf(acc[4 * n + 2 * h + 1] + bias[P + col + 1],
                              0.f));
        }
      }
      fence_proxy_async();              // h2, to the warpgroup products
      __syncthreads();
    }

    // ---- conv3 (1x1, P -> 4P) + bias + identity + relu, a group of GC
    // output channels at a time: warpgroup g takes output rows 64 g.. of a
    // 128-column group (P = 128) or columns 128 g.. of a 256-column group
    // (P = 256).  Its identity (the input there, 16-byte loads) is loaded
    // before the group's products, which hide the loads' latency
    const int r3 = L::MB2 == 2 ? 64 * wg : 0, n3 = L::MB2 == 2 ? 0 : 128 * wg;
#pragma unroll 1
    for (int gi = 0; gi < L::NG3; ++gi) {
      const int cbase = gi * L::GC + n3;
      size_t pix[2];
      bool ok[2];
      uint4 res[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = r3 + lw * 16 + g8 + 8 * h;
        const int oy = y0 + o / TW, ox = x0 + o % TW;
        ok[h] = oy < H && ox < W;
        pix[h] = ok[h] ? (((size_t)v * H + oy) * W + ox) * L::CIN : 0;
#pragma unroll
        for (int n0 = 0; n0 < 16; n0 += 4)
          res[h][n0 / 4] = ok[h] ? ldg_nc_v4(x + pix[h] + cbase + (n0 + tq) * 8)
                                 : make_uint4(0, 0, 0, 0);
      }
      float acc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = 0.f;
      for (int k = 0; k < L::KB; ++k) {
        unsigned char* st = acquire();
#pragma unroll
        for (int r = 0; r < 64; ++r) fence_operand(acc[r]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<128, 0, 1>(
              acc,
              desc_sw128(sm + L::H1 + k * (L::NO * 128) + r3 * 128 + kk * 32,
                         16, 1024),
              desc_sw128(st + (n3 / 64) * 8192 + kk * 2048, 8192, 1024));
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int r = 0; r < 64; ++r) fence_operand(acc[r]);
        release(k == 0);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 64; ++r) fence_operand(acc[r]);
      release_last();
      // conv3 + b3 rounded to bf16 (as the unfused chain rounds its conv),
      // + the identity, relu.  A quad holds 2 columns of each n8 tile; four
      // shuffles give lane t of the quad the 8 columns of tile n0 + t of
      // its row, stored as 16 bytes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int n0 = 0; n0 < 16; n0 += 4) {
          uint32_t pk[4], got[4];
#pragma unroll
          for (int s2 = 0; s2 < 4; ++s2) {
            const int col = cbase + 8 * (n0 + s2) + 2 * tq;
            pk[s2] = pack_bf16(acc[(n0 + s2) * 4 + 2 * h] + bias[2 * P + col],
                               acc[(n0 + s2) * 4 + 2 * h + 1] +
                                   bias[2 * P + col + 1]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // lane tq sends its pair of tile (tq + r) % 4 and receives, from
            // lane (tq - r) % 4, that lane's pair of tile tq
            const int snd = (tq + r) & 3, from = (tq - r) & 3;
            const uint32_t send = snd == 0 ? pk[0] : snd == 1 ? pk[1]
                                  : snd == 2 ? pk[2] : pk[3];
            const uint32_t g =
                __shfl_sync(0xffffffffu, send, (lane & ~3) | from);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (u == from) got[u] = g;
          }
          const uint32_t* rr =
              reinterpret_cast<const uint32_t*>(&res[h][n0 / 4]);
          uint32_t o4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 f = unpack_bf16(got[u]), rv = unpack_bf16(rr[u]);
            o4[u] = pack_bf16(fmaxf(f.x + rv.x, 0.f), fmaxf(f.y + rv.y, 0.f));
          }
          if (ok[h])
            *reinterpret_cast<uint4*>(out + pix[h] + cbase + (n0 + tq) * 8) =
                make_uint4(o4[0], o4[1], o4[2], o4[3]);
        }
      }
    }
  }
}

template <int P>
int launch_chain_tc(const bf16* x, const bf16* w1, const float* b1,
                    const bf16* w2, const float* b2, const bf16* w3,
                    const float* b3, bf16* out, int V, int H, int W,
                    cudaStream_t s) {
  using L = Chain<P>;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_hw = tiles_w * ((H + L::TH - 1) / L::TH);
  const int tiles = V * tiles_hw;
  if (tiles == 0) return 0;
  using mv2d::tc::encode_nhwc;
  using mv2d::tc::encode_rows;
  CUtensorMap xmap, w1map, w2map, w3map;
  if (!encode_nhwc(&xmap, x, V, H, W, L::CIN, L::HWD, L::TH + 2) ||
      !encode_rows(&w1map, w1, L::CIN, P, 64) ||
      !encode_rows(&w2map, w2, 9 * P, P, 64) ||
      !encode_rows(&w3map, w3, P, L::CIN, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto* kernel = identity_chain_tc_kernel<P>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       L::BYTES);
  kernel<<<tiles < sms ? tiles : sms, NT, L::BYTES, s>>>(
      xmap, w1map, w2map, w3map, x, b1, b2, b3, out, H, W, tiles_w, tiles_hw,
      tiles);
  return static_cast<int>(cudaGetLastError());
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
    return launch_chain_tc<P>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), fb1,
        static_cast<const bf16*>(w2), fb2, static_cast<const bf16*>(w3), fb3,
        static_cast<bf16*>(out), V, H, W, s);
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

// B10's bfloat16 plan at planes 128 or 256: the output tile's rows (its
// width is 16) and the shared memory a block takes, in bytes
extern "C" long long mv2d_identity_block_tile_rows(int planes) {
  return planes == 128 ? Chain<128>::TH : planes == 256 ? Chain<256>::TH : 0;
}
extern "C" long long mv2d_identity_block_smem(int planes) {
  return planes == 128   ? Chain<128>::BYTES
         : planes == 256 ? Chain<256>::BYTES
                         : 0;
}
