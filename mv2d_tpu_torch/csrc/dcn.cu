// Kernel K2: DCNv2 3x3 modulated deformable convolution (deform_groups=1)
// from precomputed sample coordinates and masks:
//   out[p, f] = sum_t sum_c m[p,t] * bilinear(x, sy[p,t], sx[p,t])[c] * w[t,c,f]
// Bilinear sampling clamps the coordinate into the map and gives zero
// outside (-1, extent), as mv2d_tpu/ops/dcn.py:_dense_bilinear; bfloat16
// samples are rounded to bfloat16 before the product.
//
// Replaces mv2d_tpu/ops/pallas_dcn.py: pallas_dcn_conv (_conv_impl ->
// _run_conv -> _kernel_conv), whose band/overflow split existed to keep
// samples inside VMEM; this kernel reads any offset directly, so it is
// exact for every sample position.
//
// What bounds it on the H100.  The products are 2 N 9C F operations (39.9
// GFLOP at each main-path layer: 0.040 ms at the bf16 peak) on a few tens
// of MB.  But each product's sample costs four 16-byte corner loads, their
// float32 weighting and a rounding, and at the main-path shapes these
// gathers set the pace: the instructions they issue and the SM's shared /
// L1 bandwidth, which they share with the weight tiles and the products.
// So the design gathers as little as it can and hides the products
// behind the gathers:
//  * a block owns 128 output pixels x all of F up to 256, or 64 pixels x
//    all 512 at F = 512: every sample is gathered once and feeds every
//    output channel;
//  * every tap's corners (element offsets into x) and bilinear weights *
//    mask for the block's pixels are computed once, by all threads, into
//    shared memory; a corner load is then one address add;
//  * the (64-channel chunk, tap) loop, taps inner, runs on two rings of
//    128-byte-swizzled shared tiles: the samples A [pixels][64], two
//    stages, written by the block's threads (all corner loads of a thread
//    in flight together, weighted in float32, rounded, one 16-byte store
//    a vector), and the weights W [64][channels], two or three stages,
//    64-column boxes of w by TMA, completed on an mbarrier and refilled
//    right after the chunk's barrier;
//  * the products are wgmma m64n256k16 (bf16 in, float32 accumulate in
//    registers; A K-major, W MN-major as w stores it): two warpgroups, 64
//    pixels x 256 channels each, issued asynchronously, so the threads
//    gather chunk i + 1 while the tensor cores multiply chunk i; one block
//    barrier a chunk;
//  * the output is bf16 straight from the accumulators, 16-byte stores
//    after quad shuffles, no staging tile; nothing is atomic, so two runs
//    give equal bits.
// F a multiple of 128 or 64 takes a 128- or 64-column accumulator; C a
// multiple of 32 but not 64 a 32-channel chunk; ragged N masks the last
// pixel tile.  Tried and dropped on the way (chip_smoke.py shapes):
// mma.sync with ldmatrix (its products alone too slow), a producer
// warpgroup feeding two consumers (one warpgroup cannot gather fast
// enough), cp.async weights (their issue stalls the gathers) and weight
// multicast across a 2-block cluster (its per-chunk cluster barrier costs
// more than the halved L2 traffic saves).
//
// float32 inputs (the tests' and chip_smoke.py's parity phases, held to
// 1e-4 with TF32 off) take an FMA body: 64 pixels x 64 output channels a
// block, samples and products in float32, 4x4 outputs per thread.
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TP = 64, TF = 64, KC = 32, NT = 256, TAPS = 9;
using bf16 = __nv_bfloat16;

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

// ---- bfloat16 K2 (the design is in the note at the top of this file)
template <int FT, int KC, int WGF>
struct ConvWg {
  static constexpr int BP = 128 / WGF, NT = 256;   // pixels, threads
  static constexpr int FB = FT * WGF;          // the block's channels
  static constexpr int NB = FB / 64;           // TMA boxes of a w tile
  static constexpr int NF = FT / 8;            // n8 tiles of an accumulator
  static constexpr int KS = KC / 16;           // k16 steps a chunk
  static constexpr int CV = KC / 8;            // 16-byte vectors a row
  static constexpr int VPT = BP * CV / NT;     // sample vectors a thread
  static constexpr int VSTEP = NT / CV;        // pixels between them
  static constexpr int A_TILE = BP * 128;      // bytes
  static constexpr int W_TILE = KC * FB * 2;   // bytes
  static constexpr int W_LBO = KC * 128;       // between 64-column boxes
  static constexpr int REST = 1024 + 2 * A_TILE + BP * TAPS * 32 + 64;
  static constexpr int S = REST + 3 * W_TILE <= 232448 ? 3 : 2;  // w ring
  static constexpr int SMEM = REST + S * W_TILE;
  static_assert(NF % 4 == 0, "the epilogue stores four n8 tiles a quad");
  static_assert(VSTEP % 8 == 0,
                "a thread's pixels keep their place in the swizzle atom");
};

// a (pixel, tap)'s four corners as element offsets into x (pixel index *
// C) and their bilinear weight * mask; a sample that is 0 (outside the
// map, or a pixel past N) reads element 0 with weight 0, as tap_corners
struct Corner {
  int4 off;
  float4 wt;
};

template <int FT, int KC, int WGF>
__global__ void __launch_bounds__(256, 1) dcn_conv_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const __grid_constant__ CUtensorMap wmap, bf16* __restrict__ out, int H,
    int W, int C, int HWo, long long N, int F) {
  using G = ConvWg<FT, KC, WGF>;
  constexpr int BP = G::BP, S = G::S;
  using namespace mv2d::tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* as =                   // the swizzle needs 1024-byte atoms
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ws = as + 2 * G::A_TILE;
  Corner* ctab = reinterpret_cast<Corner*>(ws + S * G::W_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ctab + BP * TAPS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nF = F / G::FB;              // the slices of a pixel tile are
  const long long p0 = (long long)(blockIdx.x / nF) * BP;   // neighbours
  const int f0 = (blockIdx.x % nF) * G::FB;
  const int n = TAPS * (C / KC);         // chunks: taps inner

  // every tap's corners of the block's pixels, once
  for (int e = tid; e < BP * TAPS; e += G::NT) {
    const int pp = e / TAPS, t = e % TAPS;
    int idx[4];
    float wt[4];
    tap_corners(p0 + pp, t, sy, sx, m, H, W, HWo, N, idx, wt);
    ctab[t * BP + pp] = {make_int4(idx[0] * C, idx[1] * C, idx[2] * C,
                                   idx[3] * C),
                         make_float4(wt[0], wt[1], wt[2], wt[3])};
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
  }

  // chunk i's weights w[t][c0 .. c0 + KC][f0 .. f0 + FB] into stage i % S,
  // 64-column boxes by TMA (one thread)
  auto load_w = [&](int i) {
    const int s = i % S;
    mbar_expect_tx(full + s, G::W_TILE);
    const int row = (i % TAPS) * C + i / TAPS * KC;
    for (int b = 0; b < G::NB; ++b)
      tma_load_2d(ws + s * G::W_TILE + b * G::W_LBO, &wmap, f0 + b * 64,
                  row, full + s);
  };
  // what a thread gathers, fixed for the whole loop: sample vectors v at
  // pixels pp + v * VSTEP, channels 8 q..
  const int pp = tid / G::CV, q = tid % G::CV;
  const uint32_t adst = (pp >> 3) * 1024 + (pp & 7) * 128 +
                        ((q ^ (pp & 7)) << 4);
  const bf16* xq = x + q * 8;

  auto fill = [&](int i, int buf) {      // chunk i's samples into stage buf
    const Corner* ct = ctab + (i % TAPS) * BP + pp;
    const bf16* xc = xq + i / TAPS * KC;
    uint4 raw[G::VPT][4];
#pragma unroll
    for (int v = 0; v < G::VPT; ++v) {   // every corner load in flight
      const int4 o = ct[v * G::VSTEP].off;
      raw[v][0] = ldg_nc_v4(xc + o.x);
      raw[v][1] = ldg_nc_v4(xc + o.y);
      raw[v][2] = ldg_nc_v4(xc + o.z);
      raw[v][3] = ldg_nc_v4(xc + o.w);
    }
#pragma unroll
    for (int v = 0; v < G::VPT; ++v) {   // weigh, round to bf16, store
      const float4 cw = ct[v * G::VSTEP].wt;
      const float wq4[4] = {cw.x, cw.y, cw.z, cw.w};
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t* r = reinterpret_cast<const uint32_t*>(&raw[v][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {    // bf16 pair -> two float32
          s[2 * j] = fmaf(wq4[k], __uint_as_float(r[j] << 16), s[2 * j]);
          s[2 * j + 1] =
              fmaf(wq4[k], __uint_as_float(r[j] & 0xffff0000u), s[2 * j + 1]);
        }
      }
      uint4 packed;
      uint32_t* o = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * j], s[2 * j + 1]);
        o[j] = *reinterpret_cast<uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(as + buf * G::A_TILE + adst +
                                v * (G::VSTEP / 8) * 1024) = packed;
    }
  };

  float acc[G::NF * 4];
#pragma unroll
  for (int r = 0; r < G::NF * 4; ++r) acc[r] = 0.f;

  __syncthreads();                       // corners and barriers are set
  if (tid == 0)
    for (int i = 0; i < S && i < n; ++i) load_w(i);
  fill(0, 0);
  fence_proxy_async();
  __syncthreads();
  // chunk i's products run on the tensor cores while the threads gather
  // chunk i + 1's samples into the other A stage; the weights arrive S - 1
  // chunks ahead.  One block barrier ends the chunk, after which its
  // weight stage is refilled.  Warpgroup g owns pixels 64 g.. of the block
  // (WGF 1) or its channels FT g.. (WGF 2).
  const int wg_row = WGF == 1 ? (warp >> 2) * 64 : 0;
  const int wg_col = WGF == 1 ? 0 : (warp >> 2) * FT;
  for (int i = 0; i < n; ++i) {
    const int buf = i & 1, s = i % S;
    mbar_wait(full + s, (i / S) & 1);
#pragma unroll
    for (int r = 0; r < G::NF * 4; ++r) fence_operand(acc[r]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < G::KS; ++ks)
      wgmma_tb<FT>(acc,
                   desc_sw128(as + buf * G::A_TILE + wg_row * 128 + ks * 32,
                              16, 1024),
                   desc_sw128(ws + s * G::W_TILE + ks * 2048 +
                                  wg_col / 64 * G::W_LBO,
                              G::W_LBO, 1024));
    wgmma_commit();
    if (i + 1 < n) fill(i + 1, buf ^ 1);
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < G::NF * 4; ++r) fence_operand(acc[r]);
    fence_proxy_async();                 // A visible to wgmma's reads
    __syncthreads();                     // stage s read by every warp:
    if (tid == 0 && i + S < n) load_w(i + S);   // refill it
  }

  // epilogue: bf16 straight from the accumulators.  A quad holds 2 columns
  // of each n8 tile; four shuffles give lane t of the quad the 8 columns
  // of tile j0 + t of its row, written as one 16-byte store.
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long p = p0 + wg_row + (warp & 3) * 16 + h * 8 + g;
#pragma unroll
    for (int j0 = 0; j0 < G::NF; j0 += 4) {
      uint32_t v[4], res[4];
#pragma unroll
      for (int s2 = 0; s2 < 4; ++s2) {
        __nv_bfloat162 b2 = __floats2bfloat162_rn(
            acc[(j0 + s2) * 4 + 2 * h], acc[(j0 + s2) * 4 + 2 * h + 1]);
        v[s2] = *reinterpret_cast<uint32_t*>(&b2);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // lane tq sends its pair of tile (tq + r) % 4 and receives, from
        // lane (tq - r) % 4, that lane's pair of tile tq
        const int snd = (tq + r) & 3, from = (tq - r) & 3;
        const uint32_t send = snd == 0 ? v[0] : snd == 1 ? v[1]
                              : snd == 2 ? v[2] : v[3];
        const uint32_t got =
            __shfl_sync(0xffffffffu, send, (lane & ~3) | from);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u == from) res[u] = got;
      }
      if (p < N)
        *reinterpret_cast<uint4*>(out + p * F + f0 + wg_col + (j0 + tq) * 8) =
            make_uint4(res[0], res[1], res[2], res[3]);
    }
  }
}

// ---- B5 / B6: the training path's modulated samples and their gradient.
//   samples[p, t, c] = m[p, t] * bilinear(x, sy[p, t], sx[p, t])[c]
// B5 replaces mv2d_tpu/ops/pallas_dcn.py: _run_samples (_kernel_samples),
// B6 replaces _run_samples_bwd (_kernel_samples_bwd).  The TPU kernels
// worked on row bands kept in VMEM and sent out-of-band samples through
// an XLA gather; here every sample reads its four corners straight from
// the channels-last map, so any offset is exact.
//
// What bounds them on the H100: bytes.  B5 writes the [N, 9, C] samples
// (the tap contraction is a separate GEMM, as in the JAX package) and B6
// reads them back as dsamples; both read x once per tap corner, which the
// L2 cache absorbs.  One warp owns one (pixel, tap): its lanes walk the
// channels in 16-byte vectors, so every corner load and the sample store
// are coalesced.  B6 scatters dx with float32 atomics into a zeroed
// float32 buffer (several taps of several pixels hit one input pixel),
// four channels per vector atomic, and reduces dm, dsy, dsx over the
// channels with warp shuffles.  The
// coordinate derivative is the floor form (exact at integer coordinates,
// where zero-init offsets start) and is zero where the coordinate was
// clamped into the map: the derivative of the plain version.
constexpr int SNT = 256;

template <typename T>
__global__ void __launch_bounds__(SNT) dcn_samples_kernel(
    const T* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    T* __restrict__ out, int H, int W, int C, int HWo, long long N) {
  constexpr int VW = 16 / sizeof(T);
  const long long pt = ((long long)blockIdx.x * SNT + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (pt >= N * TAPS) return;
  int idx[4];
  float wt[4];
  tap_corners(pt / TAPS, (int)(pt % TAPS), sy, sx, m, H, W, HWo, N, idx, wt);
  T* o = out + pt * C;
  for (int c = lane * VW; c < C; c += 32 * VW) {
    float acc[VW] = {};
    if (wt[0] != 0.f || wt[1] != 0.f || wt[2] != 0.f || wt[3] != 0.f) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(x + (size_t)idx[q] * C + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VW; ++j)
          acc[j] = fmaf(wt[q], mv2d::to_f32(e[j]), acc[j]);
      }
    }
    uint4 packed;
    T* e = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < VW; ++j) e[j] = mv2d::from_f32<T>(acc[j]);
    *reinterpret_cast<uint4*>(o + c) = packed;
  }
}

template <typename T>
__global__ void __launch_bounds__(SNT) dcn_samples_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const T* __restrict__ ds, float* __restrict__ dx,
    float* __restrict__ dsy, float* __restrict__ dsx,
    float* __restrict__ dm, int H, int W, int C, int HWo, long long N) {
  constexpr int VW = 16 / sizeof(T);
  const long long pt = ((long long)blockIdx.x * SNT + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (pt >= N * TAPS) return;
  const float yr = sy[pt], xr = sx[pt], mm = m[pt];
  if (!(yr > -1.f && yr < H && xr > -1.f && xr < W)) {
    if (lane == 0) dsy[pt] = dsx[pt] = dm[pt] = 0.f;
    return;
  }
  // d(clamped)/d(raw): 1 inside [0, extent - 1], 0 where clamped
  const float gy = (yr >= 0.f && yr <= (float)(H - 1)) ? 1.f : 0.f;
  const float gx = (xr >= 0.f && xr <= (float)(W - 1)) ? 1.f : 0.f;
  const float yy = fminf(fmaxf(yr, 0.f), (float)(H - 1));
  const float xx = fminf(fmaxf(xr, 0.f), (float)(W - 1));
  const int y0 = (int)floorf(yy), x0 = (int)floorf(xx);
  const float ly = yy - y0, lx = xx - x0;
  const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);
  const size_t base = (size_t)(pt / TAPS / HWo) * H * W;
  const size_t i00 = (base + (size_t)y0 * W + x0) * C;
  const size_t i01 = (base + (size_t)y0 * W + x1) * C;
  const size_t i10 = (base + (size_t)y1 * W + x0) * C;
  const size_t i11 = (base + (size_t)y1 * W + x1) * C;
  const float w00 = (1.f - ly) * (1.f - lx), w01 = (1.f - ly) * lx;
  const float w10 = ly * (1.f - lx), w11 = ly * lx;
  float am = 0.f, ay = 0.f, ax = 0.f;
  const T* d = ds + pt * C;
  for (int c = lane * VW; c < C; c += 32 * VW) {
    float g[VW], v00[VW], v01[VW], v10[VW], v11[VW];
    const uint4 rd = *reinterpret_cast<const uint4*>(d + c);
    const uint4 r00 = *reinterpret_cast<const uint4*>(x + i00 + c);
    const uint4 r01 = *reinterpret_cast<const uint4*>(x + i01 + c);
    const uint4 r10 = *reinterpret_cast<const uint4*>(x + i10 + c);
    const uint4 r11 = *reinterpret_cast<const uint4*>(x + i11 + c);
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      g[j] = mv2d::to_f32(reinterpret_cast<const T*>(&rd)[j]);
      v00[j] = mv2d::to_f32(reinterpret_cast<const T*>(&r00)[j]);
      v01[j] = mv2d::to_f32(reinterpret_cast<const T*>(&r01)[j]);
      v10[j] = mv2d::to_f32(reinterpret_cast<const T*>(&r10)[j]);
      v11[j] = mv2d::to_f32(reinterpret_cast<const T*>(&r11)[j]);
    }
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float bil = w00 * v00[j] + w01 * v01[j] + w10 * v10[j] +
                        w11 * v11[j];
      am = fmaf(g[j], bil, am);
      ay = fmaf(g[j], (1.f - lx) * (v10[j] - v00[j]) +
                          lx * (v11[j] - v01[j]), ay);
      ax = fmaf(g[j], (1.f - ly) * (v01[j] - v00[j]) +
                          ly * (v11[j] - v10[j]), ax);
    }
    const float wq[4] = {w00 * mm, w01 * mm, w10 * mm, w11 * mm};
    const size_t at[4] = {i00, i01, i10, i11};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (wq[q] == 0.f) continue;              // lx or ly 0: no share
      float add[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) add[j] = g[j] * wq[q];
      mv2d::atomic_add<VW>(dx + at[q] + c, add);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s /= 2) {
    am += __shfl_xor_sync(0xffffffffu, am, s);
    ay += __shfl_xor_sync(0xffffffffu, ay, s);
    ax += __shfl_xor_sync(0xffffffffu, ax, s);
  }
  if (lane == 0) {
    dm[pt] = am;
    dsy[pt] = ay * mm * gy;
    dsx[pt] = ax * mm * gx;
  }
}

// ---- B13: the combined backward of the DCN conv (K2's function).
//   ds[p, t, c] = sum_f dy[p, f] w[t, c, f]          (sample gradients)
//   dw[t, c, f] = sum_p samples[p, t, c] dy[p, f]     (tap-weight gradient)
// and from ds, exactly as B6: dx (scattered), dm, dsy, dsx.
// Replaces mv2d_tpu/ops/pallas_dcn.py: _run_conv_bwd (_kernel_conv_bwd),
// the backward of the MV2D_DCN_TRAIN_FUSED=1 training DCN, which recomputed
// the samples per band segment so that neither they nor their gradient
// ([V, Ho, Wo, 9C], ~156 MB a stage-3 layer in float32) reach memory.
//
// What bounds it on the H100: operations.  Both products (ds and dw) are
// 2 * N * 9C * F operations each (39.9 GFLOP each at the stage-3 stride-1
// layer); the bytes (x, dy, the coordinates, dx and dw) are a few tens of
// MB.  Two kernels, neither of which writes the samples or ds:
//  * dcn_conv_bwd_input_kernel: a block owns 64 output pixels and keeps
//    their dy rows in shared memory; per tap and 64-channel slice it forms
//    the ds tile = dy tile . w[t]^T (float32 FMAs, 4x4 per thread) in
//    shared memory, then, as B6 does per sample, reads the four corners,
//    scatters ds * weight * mask into dx with 16-byte float32 vector
//    atomics and reduces dm, dsy, dsx over the channels (shuffles within
//    16-lane groups, registers across the slices);
//  * dcn_conv_bwd_weight_kernel: a block owns a 64 (tap, channel) x 64
//    output-channel tile of dw and a share of the pixels (a split over
//    pixels that fills the card); per 32-pixel chunk it gathers the masked
//    samples into shared memory, loads the dy rows, and accumulates
//    samples^T . dy in registers.  Each split writes its partial tile once
//    and dcn_reduce_splits_kernel sums them: no atomic per product.
// Products are float32 FMAs in both dtypes (the samples are recomputed in
// float32 from x); tensor cores are later work.
constexpr int BTP = 64;    // pixels per input-gradient block
constexpr int BKF = 32;    // output-channel chunk of the ds product
constexpr int BNC = 64;    // channel slice
constexpr int BDS = BNC + 4;
constexpr int WPB = 32;    // pixels per dw chunk

// four consecutive channels of x at element offset i, as float32
__device__ __forceinline__ void load4(const float* x, size_t i, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(x + i);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* x, size_t i,
                                      float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(x + i);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(e[j]);
}

template <typename T>
__global__ void __launch_bounds__(NT) dcn_conv_bwd_input_kernel(
    const T* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const T* __restrict__ w, const T* __restrict__ dy,
    float* __restrict__ dx, float* __restrict__ dsy,
    float* __restrict__ dsx, float* __restrict__ dm, int H, int W, int C,
    int HWo, long long N, int F) {
  using mv2d::to_f32;
  extern __shared__ float sm[];
  const int FS = F + 1;
  float* dys = sm;                   // [BTP][F + 1] dy rows
  float* wts = dys + BTP * FS;       // [BKF][BNC + 1] w[t, c0 + c, f0 + f]
  float* dss = wts + BKF * (BNC + 1);  // [BTP][BDS] ds slice
  __shared__ int cidx[BTP][4];       // corner pixel indices
  __shared__ float cwt[BTP][4];      // bilinear weights (no mask)
  __shared__ float cinfo[BTP][6];    // ly, lx, mask, gy, gx, valid
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int cg = tid % 16;           // channel group of the scatter
  const long long p0 = (long long)blockIdx.x * BTP;

  for (int e = tid; e < BTP * F; e += NT) {
    const int p = e / F, f = e % F;
    dys[p * FS + f] = p0 + p < N ? to_f32(dy[(p0 + p) * F + f]) : 0.f;
  }
  for (int t = 0; t < TAPS; ++t) {
    if (tid < BTP) {
      const long long p = p0 + tid;
      float valid = 0.f;
      if (p < N) {
        const float yr = sy[p * TAPS + t], xr = sx[p * TAPS + t];
        if (yr > -1.f && yr < H && xr > -1.f && xr < W) {
          valid = 1.f;
          const float yy = fminf(fmaxf(yr, 0.f), (float)(H - 1));
          const float xx = fminf(fmaxf(xr, 0.f), (float)(W - 1));
          const int y0 = (int)floorf(yy), x0 = (int)floorf(xx);
          const float ly = yy - y0, lx = xx - x0;
          const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);
          const int base = (int)(p / HWo) * H * W;
          cidx[tid][0] = base + y0 * W + x0;
          cidx[tid][1] = base + y0 * W + x1;
          cidx[tid][2] = base + y1 * W + x0;
          cidx[tid][3] = base + y1 * W + x1;
          cwt[tid][0] = (1.f - ly) * (1.f - lx);
          cwt[tid][1] = (1.f - ly) * lx;
          cwt[tid][2] = ly * (1.f - lx);
          cwt[tid][3] = ly * lx;
          cinfo[tid][0] = ly;
          cinfo[tid][1] = lx;
          cinfo[tid][2] = m[p * TAPS + t];
          // d(clamped)/d(raw): 1 inside [0, extent - 1], 0 where clamped
          cinfo[tid][3] = (yr >= 0.f && yr <= (float)(H - 1)) ? 1.f : 0.f;
          cinfo[tid][4] = (xr >= 0.f && xr <= (float)(W - 1)) ? 1.f : 0.f;
        }
      }
      cinfo[tid][5] = valid;
    }
    __syncthreads();
    float am[4] = {}, ay[4] = {}, ax[4] = {};
    for (int c0 = 0; c0 < C; c0 += BNC) {
      float acc[4][4] = {};
      for (int f0 = 0; f0 < F; f0 += BKF) {
        for (int e = tid; e < BKF * BNC; e += NT) {
          const int c = e / BKF, f = e % BKF;
          wts[f * (BNC + 1) + c] =
              to_f32(w[((size_t)t * C + c0 + c) * F + f0 + f]);
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BKF; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = dys[(ty + 16 * i) * FS + f0 + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = wts[k * (BNC + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dss[(ty + 16 * i) * BDS + tx + 16 * j] = acc[i][j];
      __syncthreads();
      // pixel it * 16 + tid / 16, channels c0 + 4 cg .. + 3
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int p = it * 16 + tid / 16;
        if (cinfo[p][5] == 0.f) continue;
        const float4 g4 =
            *reinterpret_cast<const float4*>(&dss[p * BDS + 4 * cg]);
        const float g[4] = {g4.x, g4.y, g4.z, g4.w};
        const size_t c = (size_t)c0 + 4 * cg;
        float v[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) load4(x, (size_t)cidx[p][q] * C + c, v[q]);
        const float ly = cinfo[p][0], lx = cinfo[p][1], mm = cinfo[p][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bil = cwt[p][0] * v[0][j] + cwt[p][1] * v[1][j] +
                            cwt[p][2] * v[2][j] + cwt[p][3] * v[3][j];
          am[it] = fmaf(g[j], bil, am[it]);
          ay[it] = fmaf(g[j], (1.f - lx) * (v[2][j] - v[0][j]) +
                                  lx * (v[3][j] - v[1][j]), ay[it]);
          ax[it] = fmaf(g[j], (1.f - ly) * (v[1][j] - v[0][j]) +
                                  ly * (v[3][j] - v[2][j]), ax[it]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float wq = cwt[p][q] * mm;
          if (wq == 0.f) continue;               // lx or ly 0: no share
          float add[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) add[j] = g[j] * wq;
          mv2d::atomic_add<4>(dx + (size_t)cidx[p][q] * C + c, add);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
#pragma unroll
      for (int s = 8; s > 0; s /= 2) {
        am[it] += __shfl_xor_sync(0xffffffffu, am[it], s);
        ay[it] += __shfl_xor_sync(0xffffffffu, ay[it], s);
        ax[it] += __shfl_xor_sync(0xffffffffu, ax[it], s);
      }
      const int p = it * 16 + tid / 16;
      if (cg == 0 && p0 + p < N) {
        const size_t o = (size_t)(p0 + p) * TAPS + t;
        const bool ok = cinfo[p][5] != 0.f;
        const float mm = cinfo[p][2];
        dm[o] = ok ? am[it] : 0.f;
        dsy[o] = ok ? ay[it] * mm * cinfo[p][3] : 0.f;
        dsx[o] = ok ? ax[it] * mm * cinfo[p][4] : 0.f;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) dcn_conv_bwd_weight_kernel(
    const T* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const T* __restrict__ dy, float* __restrict__ part, int H, int W, int C,
    int HWo, long long N, int F, long long per_split) {
  using mv2d::to_f32;
  __shared__ float as[WPB][BNC];   // masked samples [pixel][channel]
  __shared__ float bs[WPB][BNC];   // dy [pixel][output channel]
  __shared__ int cidx[WPB][4];
  __shared__ float cwt[WPB][4];    // bilinear weight * mask (0 outside)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * BNC, t = r0 / C, c0 = r0 % C;
  const int f0 = blockIdx.y * BNC;
  const long long beg = (long long)blockIdx.z * per_split;
  const long long end = min(N, beg + per_split);
  float acc[4][4] = {};
  for (long long pc = beg; pc < end; pc += WPB) {
    if (tid < WPB)
      tap_corners(pc + tid, t, sy, sx, m, H, W, HWo, end, cidx[tid],
                  cwt[tid]);
    __syncthreads();
    for (int e = tid; e < WPB * BNC; e += NT) {
      const int p = e / BNC, c = e % BNC;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s = fmaf(cwt[p][q], to_f32(x[(size_t)cidx[p][q] * C + c0 + c]), s);
      as[p][c] = s;
      bs[p][c] = pc + p < end ? to_f32(dy[(pc + p) * F + f0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < WPB; ++p) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[p][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[p][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * TAPS * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)(r0 + ty + 16 * i) * F + f0 + tx + 16 * j] = acc[i][j];
}

// dw[e] = sum_s part[s][e]
__global__ void dcn_reduce_splits_kernel(const float* __restrict__ part,
                                         float* __restrict__ dw,
                                         long long n, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + e];
  dw[e] = s;
}

// the bfloat16 body at one tiling: FT = F's widest of 256 / 128 / 64 that
// divides it, KC = 64 channels a chunk where C allows, else 32
template <int FT, int KC, int WGF>
int launch_conv_tc(const bf16* x, const float* sy, const float* sx,
                   const float* m, const bf16* w, bf16* out, int H, int W,
                   int C, int HWo, long long N, int F, cudaStream_t s) {
  using G = ConvWg<FT, KC, WGF>;
  auto* kernel = dcn_conv_tc_kernel<FT, KC, WGF>;
  // w as a [9 C, F] matrix, read in 64-column x KC-row boxes, 128-byte
  // swizzled as wgmma reads them
  mv2d::tc::TmapEncode encode = mv2d::tc::tmap_encode();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)F, (cuuint64_t)TAPS * C};
  const cuuint64_t strides[1] = {(cuuint64_t)F * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)KC}, unit[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<bf16*>(w), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G::SMEM);
  const long long tiles = (N + G::BP - 1) / G::BP;
  kernel<<<(unsigned)(tiles * (F / G::FB)), G::NT, G::SMEM, s>>>(
      x, sy, sx, m, wmap, out, H, W, C, HWo, N, F);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int launch_conv_tc_f(const bf16* x, const float* sy, const float* sx,
                     const float* m, const bf16* w, bf16* out, int H, int W,
                     int C, int HWo, long long N, int F, cudaStream_t s) {
  if (F % 512 == 0)
    return launch_conv_tc<256, KC, 2>(x, sy, sx, m, w, out, H, W, C, HWo, N,
                                      F, s);
  if (F % 256 == 0)
    return launch_conv_tc<256, KC, 1>(x, sy, sx, m, w, out, H, W, C, HWo, N,
                                      F, s);
  if (F % 128 == 0)
    return launch_conv_tc<128, KC, 1>(x, sy, sx, m, w, out, H, W, C, HWo, N,
                                      F, s);
  return launch_conv_tc<64, KC, 1>(x, sy, sx, m, w, out, H, W, C, HWo, N, F,
                                   s);
}

}  // namespace

// B13: dy [V, Ho, Wo, F] (dtype) -> dx [V, H, W, C] float32 (zeroed by the
// caller, accumulated), dsy / dsx / dm [V, Ho, Wo, 9] float32, dw [9, C, F]
// float32; part [splits, 9, C, F] float32 scratch (unused when splits == 1);
// C and F multiples of 64, F <= 512
extern "C" int mv2d_dcn_conv_bwd(const void* x, const void* sy,
                                 const void* sx, const void* m, const void* w,
                                 const void* dy, void* dx, void* dsy,
                                 void* dsx, void* dm, void* dw, void* part,
                                 int V, int H, int W, int C, int Ho, int Wo,
                                 int F, int splits, int dtype, void* stream) {
  const long long N = (long long)V * Ho * Wo;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* fy = static_cast<const float*>(sy);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fm = static_cast<const float*>(m);
  const int smem = (BTP * (F + 1) + BKF * (BNC + 1) + BTP * BDS) * 4;
  const long long per_split = ((N + splits - 1) / splits + WPB - 1) / WPB *
                              WPB;
  float* pw = splits == 1 ? static_cast<float*>(dw)
                          : static_cast<float*>(part);
  const dim3 gw(TAPS * C / BNC, F / BNC, splits);
  MV2D_DISPATCH(dtype, T, {
    cudaFuncSetAttribute(dcn_conv_bwd_input_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dcn_conv_bwd_input_kernel<T><<<(unsigned)((N + BTP - 1) / BTP), NT,
                                   smem, s>>>(
        static_cast<const T*>(x), fy, fx, fm, static_cast<const T*>(w),
        static_cast<const T*>(dy), static_cast<float*>(dx),
        static_cast<float*>(dsy), static_cast<float*>(dsx),
        static_cast<float*>(dm), H, W, C, Ho * Wo, N, F);
    dcn_conv_bwd_weight_kernel<T><<<gw, NT, 0, s>>>(
        static_cast<const T*>(x), fy, fx, fm, static_cast<const T*>(dy), pw,
        H, W, C, Ho * Wo, N, F, per_split);
  });
  if (splits > 1) {
    const long long n = (long long)TAPS * C * F;
    dcn_reduce_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(dw), n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// x [V, H, W, C] (dtype), sy / sx / m [V, Ho, Wo, 9] float32 ->
// out [V, Ho, Wo, 9, C] (dtype); C a multiple of 16 bytes
extern "C" int mv2d_dcn_samples(const void* x, const void* sy,
                                const void* sx, const void* m, void* out,
                                int V, int H, int W, int C, int Ho, int Wo,
                                int dtype, void* stream) {
  const long long N = (long long)V * Ho * Wo;
  const unsigned blocks = (unsigned)((N * TAPS * 32 + SNT - 1) / SNT);
  auto s = static_cast<cudaStream_t>(stream);
  MV2D_DISPATCH(dtype, T, {
    dcn_samples_kernel<T><<<blocks, SNT, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(sy),
        static_cast<const float*>(sx), static_cast<const float*>(m),
        static_cast<T*>(out), H, W, C, Ho * Wo, N);
  });
  return static_cast<int>(cudaGetLastError());
}

// dsamples [V, Ho, Wo, 9, C] (dtype) -> dx [V, H, W, C] float32 (zeroed by
// the caller, accumulated), dsy / dsx / dm [V, Ho, Wo, 9] float32
extern "C" int mv2d_dcn_samples_bwd(const void* x, const void* sy,
                                    const void* sx, const void* m,
                                    const void* ds, void* dx, void* dsy,
                                    void* dsx, void* dm, int V, int H, int W,
                                    int C, int Ho, int Wo, int dtype,
                                    void* stream) {
  const long long N = (long long)V * Ho * Wo;
  const unsigned blocks = (unsigned)((N * TAPS * 32 + SNT - 1) / SNT);
  auto s = static_cast<cudaStream_t>(stream);
  MV2D_DISPATCH(dtype, T, {
    dcn_samples_bwd_kernel<T><<<blocks, SNT, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(sy),
        static_cast<const float*>(sx), static_cast<const float*>(m),
        static_cast<const T*>(ds), static_cast<float*>(dx),
        static_cast<float*>(dsy), static_cast<float*>(dsx),
        static_cast<float*>(dm), H, W, C, Ho * Wo, N);
  });
  return static_cast<int>(cudaGetLastError());
}

// x [V, H, W, C], w [9, C, F] (dtype), sy / sx / m [V, Ho, Wo, 9] float32
// -> out [V, Ho, Wo, F] (dtype); C % 32 == 0, F % 64 == 0
extern "C" int mv2d_dcn_conv(const void* x, const void* sy, const void* sx,
                             const void* m, const void* w, void* out, int V,
                             int H, int W, int C, int Ho, int Wo, int F,
                             int dtype, void* stream) {
  const long long N = (long long)V * Ho * Wo;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* fy = static_cast<const float*>(sy);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fm = static_cast<const float*>(m);
  if (C % 32 || F % 64 || N == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const dim3 grid((unsigned)((N + TP - 1) / TP), F / TF);
    dcn_conv_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), fy, fx, fm,
        static_cast<const float*>(w), static_cast<float*>(out), H, W, C,
        Ho * Wo, N, F);
    return static_cast<int>(cudaGetLastError());
  }
  // the bfloat16 body keeps element offsets into x in 32 bits
  if (dtype != 1 || (long long)V * H * W * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bx = static_cast<const bf16*>(x);
  const auto* bw = static_cast<const bf16*>(w);
  auto* bo = static_cast<bf16*>(out);
  if (C % 64 == 0)
    return launch_conv_tc_f<64>(bx, fy, fx, fm, bw, bo, H, W, C, Ho * Wo, N,
                                F, s);
  return launch_conv_tc_f<32>(bx, fy, fx, fm, bw, bo, H, W, C, Ho * Wo, N, F,
                              s);
}
