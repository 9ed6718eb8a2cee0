// Kernel K1: one ResNet bottleneck of layer1 (1x1 -> 3x3 -> 1x1, stride 1,
// width 64, frozen BN folded into the weights) with bias, relu and the
// residual (identity, or the 1x1 projection of block 0) fused in.
//
// Replaces mv2d_tpu/ops/pallas_stage.py: fused_stage1 (_run_chain ->
// _kernel), which ran the whole layer1 chain over VMEM-resident row bands.
// Here one launch runs one bottleneck; the host loops over the three.
//
// What bounds it on the H100: a launch must read its input and write its
// 256-channel output (at [12, 128, 352]: 69 or 277 MB in, 277 MB out, in
// bfloat16), and at width 64 its products are too thin for the tensor
// cores to outrun that by much: the chain's 2.3e11 FLOP take 0.233 ms at
// the bf16 peak, its three launches' 1.45 GB of traffic 0.434 ms at 3.35
// TB/s.  Both 64-channel intermediates stay on chip.
//
// bfloat16 (the model's path): a persistent block per SM, 8 warps (two
// warpgroups), keeps w1 and w2 in shared memory and w3 / wd as each
// warp's B fragments in registers (all loaded once a block), and walks
// 8x16-pixel output tiles:
//  * the input's 10x18 halo tile comes by TMA in 64-channel boxes (a 4D
//    tensor map over [V, H, W, C]; the box's out-of-image pixels arrive as
//    zeros) into a ring of two stages, so the next chunk, and at the end
//    of conv1 the next tile's first two, load under the products;
//  * activations live in 128-byte rows swizzled as TMA swizzles them, and
//    A fragments come by ldmatrix with per-lane row addresses, so conv2's
//    nine 3x3 taps are row shifts into the conv1 tile;
//  * conv1 (mma.sync.m16n8k16, 48x32 warp tiles) writes h1 (bias, relu, 0
//    outside the image: conv2's zero padding); conv2 runs as wgmma
//    m64n64k16 with A from registers and w2 read by the tensor cores from
//    shared memory, which halves its shared-memory traffic against
//    mma.sync; h1 and h2 are bfloat16, rounded where the unfused bf16
//    chain rounds them;
//  * conv3 and block 0's projection (which reads the tile's centre from
//    the input stage it already holds) go a quarter tile (2 rows) at a
//    time on mma.sync, each warp 32 output columns; bias, residual and
//    relu are applied on the fragments in a quarter's output buffer, the
//    identity arrives there by TMA beforehand, and a TMA store takes the
//    quarter out while the next one computes; each warp pair syncs only
//    with itself there.
// It moves each launch's input (with the halo re-read from L2) and output
// once through device memory.  What holds it (clock counters per phase):
// the phases (load, conv1, conv2, conv3) run in step across the block's
// warps, each leaving some unit idle; conv3 with block 0's projection is
// the longest, on the mma.sync issue rate; identity blocks' conv1 waits
// on its chunk loads; conv2 runs at about half the warpgroup rate.
// Nothing is atomic: two runs give equal bits.
// Tried on the way at chip_smoke.py's shape: h2 as conv3's register A
// fragments with a warp's 16 pixels x 256 columns and w3 through
// ldmatrix; 16-byte stores through a per-warp staging tile with residual
// loads by the threads (their stalls were the largest loss); conv2 on
// mma.sync with 16x64 or 32x32 warp tiles; staggered block starts; conv1
// as a warpgroup product (A from registers, the columns split across the
// warpgroups: no gain, the chunk loads pace it); a third ring stage in
// the output buffers while conv1 runs (a few percent on identity blocks,
// not worth its aliasing).  Shared memory is full, so w3 / wd cannot join
// w2 as warpgroup B operands.
//
// float32 (the parity tests, TF32 off) keeps exact float32 FMAs from
// shared memory on the same 8x16 tiles (12x4 or 8x4 register tiles per
// thread), one block a tile, nothing pipelined.
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

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

// ---- bfloat16: tensor cores, persistent blocks, resident weights
using bf16 = __nv_bfloat16;

constexpr int ROW = 128;            // bytes of a 64-channel bf16 row
constexpr int STAGE = NHP * ROW;    // a 64-channel chunk of the halo tile
constexpr int BOX = NH * ROW;       // the bytes one TMA box brings
constexpr int BLK = P * ROW;        // a [64][64] weight block
constexpr int QPX = 2 * TW;         // output pixels of a quarter tile
constexpr int QBOX = QPX * ROW;     // a quarter's 64 channels (TMA box)
constexpr int QBUF = 4 * QBOX;      // a quarter's 256 channels

// shared memory of a block (byte offsets, 1024-byte aligned pieces): the
// input ring, h1 (conv1 on the halo tile), h2 (conv2), two output buffers
// of a quarter tile (2 rows x 16 pixels x 256 channels, as four 64-channel
// TMA boxes), w2 (one [64][64] block a tap) and w1 (Cin / 64 blocks) as
// [k][64] rows of 128 bytes, the biases (b1, b2, b3 + bd) and the
// mbarriers (the ring; each box of the output buffers).  w3 and wd pass
// through the output buffers and h1 once, on their way into registers.
template <int CIN>
struct Smem {
  static constexpr bool PROJ = CIN == P;   // block 0 carries wd / bd
  static constexpr int NC = CIN / P;       // input chunks a tile
  static constexpr int H1 = 2 * STAGE;
  static constexpr int H2 = H1 + STAGE;
  static constexpr int OUT = H2 + NO * ROW;
  static constexpr int W2 = OUT + 2 * QBUF;
  static constexpr int W1 = W2 + 9 * BLK;
  static constexpr int BIAS = W1 + NC * BLK;
  static constexpr int BAR = BIAS + 6 * P * 4;
  static constexpr int BYTES = BAR + 80 + 1024;   // + the base's alignment
};

__device__ __forceinline__ void tile_origin(int id, int tiles_w,
                                            int tiles_hw, int& v, int& y0,
                                            int& x0) {
  v = id / tiles_hw;
  const int r = id - v * tiles_hw;
  y0 = (r / tiles_w) * TH;
  x0 = (r % tiles_w) * TW;
}

// CIN 64: block 0 (projection), CIN 256: an identity block
template <int CIN>
__global__ void __launch_bounds__(NT, 1) bottleneck_tc_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap rmap,
    const __grid_constant__ CUtensorMap omap, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const bf16* __restrict__ w3,
    const float* __restrict__ b3, const bf16* __restrict__ wd,
    const float* __restrict__ bd, int H, int W, int tiles_w, int tiles_hw,
    int tiles) {
  using L = Smem<CIN>;
  using namespace mv2d::tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =                   // the swizzle needs 1024-byte atoms
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(sm);
  float* bias = reinterpret_cast<float*>(sm + L::BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);  // ring
  uint64_t* rbar = full + 2;           // [buffer][box]: the residual
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, lr = lane & 15, lc = lane >> 4;
  // this block's tiles: blockIdx.x, + gridDim.x, ...; chunk q is channels
  // 64 (q % NC) .. of its tile q / NC, into ring stage q % 2
  const int mine = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int nq = mine * L::NC;
  auto origin = [&](int j, int& v, int& y0, int& x0) {
    tile_origin(blockIdx.x + j * gridDim.x, tiles_w, tiles_hw, v, y0, x0);
  };
  auto issue = [&](int q) {             // one thread: chunk q's TMA box
    if (q >= nq) return;
    int v, y0, x0;
    origin(q / L::NC, v, y0, x0);
    mbar_expect_tx(full + (q & 1), BOX);
    tma_load_4d(sm + (q & 1) * STAGE, &xmap, (q % L::NC) * P, x0 - 1,
                y0 - 1, v, full + (q & 1));
  };
  // the output buffers' box bx (channels 64 bx ..) belongs to warps 2 bx,
  // 2 bx + 1; the first thread of the pair moves it by TMA.  Identity
  // blocks: that box of quarter qq of tile j's residual (the input there)
  // into output buffer qq % 2, where the epilogue adds it
  const int bx = warp >> 1;
  const bool mover = (tid & 63) == 0;
  auto residual = [&](bool ok, int v, int y0, int x0, int qq) {
    if (L::PROJ || !ok) return;
    uint64_t* bar = rbar + (qq & 1) * 4 + bx;
    mbar_expect_tx(bar, QBOX);
    tma_load_4d(sm + L::OUT + (qq & 1) * QBUF + bx * QBOX, &rmap, bx * P,
                x0, y0 + 2 * qq, v, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 10; ++i) mbar_init(full + i, 1);
    fence_mbar_init();
    issue(0);
    issue(1);
  }
  // the weights, once a block, while the first chunks arrive: w1, w2 to
  // stay; w3 through the output buffers and wd through h1 + h2, into
  // registers
  auto load_w = [&](int off, const bf16* w, int rows, int ld) {
    for (int e = tid; e < rows * ld / 8; e += NT) {
      const int c = e & 7, r = (e >> 3) % rows, b = (e >> 3) / rows;
      cp_async<16>(sm + off + b * rows * ROW + swz(r, c),
                   w + (size_t)r * ld + b * P + c * 8, true);
    }
  };
  load_w(L::W1, w1, CIN, P);
  load_w(L::W2, w2, 9 * P, P);
  load_w(L::OUT, w3, P, 4 * P);
  if constexpr (L::PROJ) load_w(L::H1, wd, CIN, 4 * P);
  cp_async_commit();
  for (int e = tid; e < 6 * P; e += NT) {
    float b = e < P ? b1[e] : e < 2 * P ? b2[e - P] : b3[e - 2 * P];
    if constexpr (L::PROJ) {
      if (e >= 2 * P) b += bd[e - 2 * P];
    }
    bias[e] = b;
  }
  cp_async_wait<0>();
  fence_proxy_async();                  // w2, to the warpgroup products
  __syncthreads();
  // conv3 (and the projection): warp w owns output columns 32w .. 32w + 31,
  // its B fragments in registers for the whole run
  const int cb = (warp & 1) * 32;       // first column in its 64-col block
  uint32_t b3f[4][2][4], bdf[4][2][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const uint32_t at = (warp >> 1) * BLK +
                          swz(16 * ks + lr, (cb >> 3) + 2 * jj + lc);
      ldsm_x4_t(b3f[ks][jj], s0 + L::OUT + at);
      if constexpr (L::PROJ) ldsm_x4_t(bdf[ks][jj], s0 + L::H1 + at);
    }
  float b3r[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    b3r[n][0] = bias[2 * P + 32 * warp + 8 * n + 2 * t];
    b3r[n][1] = bias[2 * P + 32 * warp + 8 * n + 2 * t + 1];
  }
  __syncthreads();
  if (mover) {
    int v, y0, x0;
    origin(0, v, y0, x0);
    residual(true, v, y0, x0, 0);
    residual(true, v, y0, x0, 1);
  }

  const uint32_t h1 = s0 + L::H1, h2 = s0 + L::H2;
  const int wm = warp & 3, wn = warp >> 2;   // conv1: 48 rows x 32 columns
  int q = 0;
  for (int j = 0; j < mine; ++j) {
    int v, y0, x0, nv, ny0, nx0;      // this tile's origin and the next's
    origin(j, v, y0, x0);
    origin(j + 1, nv, ny0, nx0);
    const bool next = j + 1 < mine;

    // ---- conv1 (1x1, CIN -> 64) on the 192 (180 used) halo rows
    float acc1[3][4][4] = {};
    for (int k = 0; k < L::NC; ++k, ++q) {
      mbar_wait(full + (q & 1), (q >> 1) & 1);
      const uint32_t xs = s0 + (q & 1) * STAGE, wb = s0 + L::W1 + k * BLK;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[3][4], b[2][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(a[i], xs + swz(48 * wm + 16 * i + lr, 2 * ks + lc));
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          ldsm_x4_t(b[jj], wb + swz(16 * ks + lr, 4 * wn + 2 * jj + lc));
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(acc1[i][n], a[i], b[n >> 1][2 * (n & 1)],
                     b[n >> 1][2 * (n & 1) + 1]);
      }
      if constexpr (L::NC > 1) {    // the stage is free: chunk q + 2 in
        __syncthreads();
        if (tid == 0) issue(q + 2);
      }
    }
    // bias + relu; 0 outside the image (conv2's zero padding)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 48 * wm + 16 * i + g + 8 * hf;
        const int gy = y0 - 1 + r / HW, gx = x0 - 1 + r % HW;
        const bool ok = r < NH && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = 32 * wn + 8 * n + 2 * t;
          const float v0 = fmaxf(acc1[i][n][2 * hf] + bias[col], 0.f);
          const float v1 = fmaxf(acc1[i][n][2 * hf + 1] + bias[col + 1], 0.f);
          *reinterpret_cast<uint32_t*>(sm + L::H1 + swz(r, col >> 3) +
                                       (col & 7) * 2) =
              ok ? pack_bf16(v0, v1) : 0u;
        }
      }
    __syncthreads();

    // ---- conv2 (3x3) as warpgroup products: warpgroup 0 takes output
    // rows 0-3, warpgroup 1 rows 4-7, 64 columns; warp w's A fragment is
    // its output row w, tap (dy, dx) reading halo rows (w + dy) * 18 + dx
    // + 0..15 by ldmatrix into registers (so the taps are per-lane row
    // shifts); w2 is B, straight from shared memory.  Fragments load two
    // steps ahead of their product (three register sets).
    {
      float acc2[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) acc2[r] = 0.f;
      uint32_t a[3][4];
      auto frag = [&](int st, uint32_t* fa) {
        const int tap = st >> 2, ks = st & 3;
        ldsm_x4(fa, h1 + swz((warp + tap / 3) * HW + tap % 3 + lr,
                             2 * ks + lc));
      };
#pragma unroll
      for (int i = 0; i < 2; ++i) frag(i, a[i]);
#pragma unroll
      for (int r = 0; r < 32; ++r) fence_operand(acc2[r]);
#pragma unroll
      for (int st = 0; st < 36; ++st) {
        wgmma_fence();
        wgmma_rs<64>(acc2, a[st % 3],
                     desc_sw128(sm + L::W2 + (st >> 2) * BLK + (st & 3) * 2048,
                                BLK, 1024));
        wgmma_commit();
        if (st + 2 < 36) {
          wgmma_wait<1>();            // step st - 1 has read its fragment
          frag(st + 2, a[(st + 2) % 3]);
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) fence_operand(a[k][e]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 32; ++r) fence_operand(acc2[r]);
      // relu(conv2 + b2) -> h2
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * warp + g + 8 * hf, col = 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(sm + L::H2 + swz(r, n) + 4 * t) =
              pack_bf16(fmaxf(acc2[4 * n + 2 * hf] + bias[P + col], 0.f),
                        fmaxf(acc2[4 * n + 2 * hf + 1] + bias[P + col + 1],
                              0.f));
        }
    }
    __syncthreads();

    // ---- conv3 (1x1, 64 -> 256) (+ projection) + residual + relu, a
    // quarter tile (output rows 2qq, 2qq + 1) at a time; the results go
    // out by TMA stores from the output buffers, which overlap the next
    // quarter's products and the next tile.  A warp pair syncs only with
    // itself here.
#pragma unroll 1
    for (int qq = 0; qq < 4; ++qq) {
      float acc[2][4][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], h2 + swz((2 * qq + mi) * TW + lr, 2 * ks + lc));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(acc[mi][n], a[mi], b3f[ks][n >> 1][2 * (n & 1)],
                     b3f[ks][n >> 1][2 * (n & 1) + 1]);
      }
      if constexpr (L::PROJ) {          // the tile's centre, still staged
        const uint32_t xs = s0 + ((q - 1) & 1) * STAGE;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldsm_x4(a[mi], xs + swz((2 * qq + mi + 1) * HW + 1 + lr,
                                    2 * ks + lc));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              mma_bf16(acc[mi][n], a[mi], bdf[ks][n >> 1][2 * (n & 1)],
                       bdf[ks][n >> 1][2 * (n & 1) + 1]);
        }
      }
      // + bias (identity blocks round conv3 + b3 as the unfused chain
      // does; block 0 rounds conv3 + b3 plus the projection + bd once),
      // + residual (identity blocks: already in the buffer, all of this
      // lane's words read before any is written back), relu
      unsigned char* buf = sm + L::OUT + (qq & 1) * QBUF + bx * QBOX;
      uint32_t* o[2][2][4];
      uint32_t res[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = cb + 8 * n + 2 * t;
            o[mi][hf][n] = reinterpret_cast<uint32_t*>(
                buf + swz(16 * mi + g + 8 * hf, col >> 3) + (col & 7) * 2);
          }
      if constexpr (!L::PROJ) {
        mbar_wait(rbar + (qq & 1) * 4 + bx, (2 * j + (qq >> 1)) & 1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int n = 0; n < 4; ++n) res[mi][hf][n] = *o[mi][hf][n];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float2 f = unpack_bf16(pack_bf16(acc[mi][n][2 * hf] + b3r[n][0],
                                             acc[mi][n][2 * hf + 1] +
                                                 b3r[n][1]));
            if constexpr (!L::PROJ) {
              const float2 r = unpack_bf16(res[mi][hf][n]);
              f.x += r.x;
              f.y += r.y;
            }
            *o[mi][hf][n] = pack_bf16(fmaxf(f.x, 0.f), fmaxf(f.y, 0.f));
          }
      fence_proxy_async();              // the writes, to the TMA store
      if (mover) {
        // the previous quarter's store has read its buffer: the quarter
        // after this one may fill it (quarter 1's was refilled after the
        // last tile's last store)
        bulk_wait<0, true>();
        if (qq == 1 || qq == 2) residual(true, v, y0, x0, qq + 1);
        else if (qq == 3) residual(next, nv, ny0, nx0, 0);
      }
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + bx) : "memory");
      if (mover) {
        tma_store_4d(&omap, bx * P, x0, y0 + 2 * qq, v, buf);
        bulk_commit();
        if (qq == 3) {                  // the next tile's second quarter
          bulk_wait<0, true>();
          residual(next, nv, ny0, nx0, 1);
        }
      }
    }
    if constexpr (L::NC == 1) {       // the projection is done with the
      __syncthreads();                // stage: chunk q + 1 in
      if (tid == 0) issue(q + 1);
    }
  }
  if (mover) bulk_wait<0, false>();
}

template <int CIN>
int launch_tc(const bf16* x, const bf16* w1, const float* b1,
              const bf16* w2, const float* b2, const bf16* w3,
              const float* b3, const bf16* wd, const float* bd, bf16* out,
              int V, int H, int W, cudaStream_t s) {
  using L = Smem<CIN>;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_hw = tiles_w * ((H + TH - 1) / TH), tiles = V * tiles_hw;
  if (tiles == 0) return 0;
  // x: the halo tile and (identity) the residual; out: a quarter's boxes
  CUtensorMap xmap, rmap, omap;
  using mv2d::tc::encode_nhwc;
  if (!encode_nhwc(&xmap, x, V, H, W, CIN, HW, HH) ||
      !encode_nhwc(&rmap, x, V, H, W, CIN, TW, 2) ||
      !encode_nhwc(&omap, out, V, H, W, 4 * P, TW, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto* kernel = bottleneck_tc_kernel<CIN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       L::BYTES);
  kernel<<<tiles < sms ? tiles : sms, NT, L::BYTES, s>>>(
      xmap, rmap, omap, w1, b1, w2, b2, w3, b3, wd, bd, H, W, tiles_w,
      tiles_hw, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mv2d_bottleneck(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, const void* wd, const void* bd,
                               void* out, int V, int H, int W, int cin,
                               int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fb3 = static_cast<const float*>(b3);
  const auto* fbd = static_cast<const float*>(bd);
  if (dtype == 0) {
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, V);
    const size_t smem = SMEM_FLOATS * sizeof(float);
    cudaFuncSetAttribute(bottleneck_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    bottleneck_kernel<float><<<grid, NT, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), fb1,
        static_cast<const float*>(w2), fb2, static_cast<const float*>(w3),
        fb3, static_cast<const float*>(wd), fbd, static_cast<float*>(out),
        H, W, cin);
    return static_cast<int>(cudaGetLastError());
  }
  // bfloat16 weights, float32 biases: block 0 (Cin 64 with the
  // projection) or an identity block (Cin 256)
  const bool proj = wd != nullptr;
  if (dtype != 1 || (proj ? cin != P : cin != 4 * P))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bx = static_cast<const bf16*>(x);
  const auto* bw1 = static_cast<const bf16*>(w1);
  const auto* bw2 = static_cast<const bf16*>(w2);
  const auto* bw3 = static_cast<const bf16*>(w3);
  auto* bo = static_cast<bf16*>(out);
  return proj ? launch_tc<P>(bx, bw1, fb1, bw2, fb2, bw3, fb3,
                             static_cast<const bf16*>(wd), fbd, bo, V, H, W, s)
              : launch_tc<4 * P>(bx, bw1, fb1, bw2, fb2, bw3, fb3, nullptr,
                                 nullptr, bo, V, H, W, s);
}
