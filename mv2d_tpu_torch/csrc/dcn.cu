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

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TP = 64, TF = 64, KC = 32, NT = 256, TAPS = 9;
using bf16 = __nv_bfloat16;

// A sample inside the map: -1 < y < H and -1 < x < W.
__device__ __forceinline__ bool in_map(float yr, float xr, int H, int W) {
  return yr > -1.f && yr < H && xr > -1.f && xr < W;
}

// the clamped corners (y0, x0), (y0, x1), (y1, x0), (y1, x1) of a sample
// inside the map and its fractions
struct Bilinear {
  int y0, y1, x0, x1;
  float ly, lx;
};

__device__ __forceinline__ Bilinear bilinear_at(float yr, float xr, int H,
                                                int W) {
  Bilinear b;
  const float yy = fminf(fmaxf(yr, 0.f), (float)(H - 1));
  const float xx = fminf(fmaxf(xr, 0.f), (float)(W - 1));
  b.y0 = (int)floorf(yy);
  b.x0 = (int)floorf(xx);
  b.ly = yy - b.y0;
  b.lx = xx - b.x0;
  b.y1 = min(b.y0 + 1, H - 1);
  b.x1 = min(b.x0 + 1, W - 1);
  return b;
}

// Bilinear corners of pixel p's sample at (yr, xr) with mask mm: pixel
// indices and weights * mask, all weights 0 when the sample lies outside
// (-1, extent).
__device__ __forceinline__ void corners_at(long long p, float yr, float xr,
                                           float mm, int H, int W, int HWo,
                                           int* idx, float* wt) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    idx[q] = 0;
    wt[q] = 0.f;
  }
  if (!in_map(yr, xr, H, W)) return;
  const Bilinear b = bilinear_at(yr, xr, H, W);
  const int y0 = b.y0, x0 = b.x0, y1 = b.y1, x1 = b.x1;
  const float ly = b.ly, lx = b.lx;
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

// the same for pixel p's tap t; pixels past N are 0
__device__ __forceinline__ void tap_corners(
    long long p, int t, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m, int H, int W,
    int HWo, long long N, int* idx, float* wt) {
  const bool here = p < N;
  corners_at(p, here ? sy[p * TAPS + t] : -2.f, here ? sx[p * TAPS + t] : -2.f,
             here ? m[p * TAPS + t] : 0.f, H, W, HWo, idx, wt);
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
      wgmma_ss<FT, 0, 1>(
          acc,
          desc_sw128(as + buf * G::A_TILE + wg_row * 128 + ks * 32, 16, 1024),
          desc_sw128(ws + s * G::W_TILE + ks * 2048 + wg_col / 64 * G::W_LBO,
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
// an XLA gather; here every sample reads its corners straight from the
// channels-last map, so any offset is exact.
//
// B5.  What bounds it on the H100: bytes.  It writes the [N, 9, C]
// samples (the tap contraction is a separate GEMM, as in the JAX package)
// and reads x, whose four corners a sample takes come from the L2 cache
// (623 MB of them at stage-3 s2, four times the samples' bytes).  The
// first form gave a warp to each (pixel, tap): every lane computed the
// sample's corners itself, issued its four loads, stored once and exited,
// and a block's eight taps of one pixel shared no corner with the next
// block's (0.136 ms at stage-3 s2, half its 0.068 ms bound).  Now a
// block owns a B5Y x B5X tile of output pixels x all 9 taps x a slice of
// 32 x 16 bytes of channels:
//  * each (pixel, tap)'s four corner offsets and bilinear weights x mask
//    are computed once, a thread a (pixel, tap), into shared memory;
//  * warp w takes the block's (pixel, tap) rows w, w + 8, ..., B5U at a
//    time with all their corner loads in flight (16 bytes a lane; none for
//    a corner of weight 0), so the eight warps work on neighbouring taps
//    together and the tile's shared corners come from L1;
//  * each sample is weighted in float32, rounded once and stored with a
//    16-byte streaming store, so the samples do not push x out of L2.
// 0.100 / 0.086 / 0.055 / 0.047 ms at stage-3 s2 / s1 and stage-4 s2 /
// s1, 68% to 55% of the bound (chip_smoke.py; NVIDIA H100 80GB HBM3,
// 700 W); what is left is each block's prologue and its corner loads'
// latency at four blocks an SM.  Tried and dropped (the same shapes and
// card): 4 x 8 and 8 x 8 pixel tiles (fewer blocks: a tail at stage 4),
// four rows a warp in flight (two blocks an SM), five or eight blocks an
// SM (spills), plain stores in place of the streaming ones.
//
// B6 takes ds = d(loss) / d(samples) and returns dx [V, H, W, C] in
// x.dtype and dsy, dsx, dm [N, 9] in float32.  What bounds it: bytes, ds
// (156 MB at stage-3 s2 in bf16), x and dx, each once.  The gradient to
// x is a scatter: a sample adds w_q m ds to its four corners q, and which
// samples reach a pixel depends on learned offsets that have no bound.
// B6's first form scattered it with float32 atomics into a zeroed float32
// buffer: its result changed from run to run, the atomics took most of
// its time, and the zero-fill and the cast after it moved more bytes than
// the function's bound.  Now every dx element has one owner:
//  * the map is cut into 2 x 2 pixel blocks, and a warp owns a block x a
//    slice of 32 x 16 bytes of channels: it writes the block's dx once,
//    in x.dtype, from float32 sums taken in a fixed order;
//  * an index pass, a thread a sample, gives each sample inside the map
//    one entry for each distinct block among its four corners (2.25 on
//    average at a fractional position, where a list by pixel would take
//    4), keyed by the block, with the weights w_q m its corners put on the
//    block's pixels (stored slot-major, so the stores coalesce); a stable
//    LSD radix sort (8-bit digits, integer counts per tile, a scan of each
//    digit's row, stable ranks from warp matches) lists each block's
//    entries in sample order;
//  * the owner walks its list: lane j reads entry j's weights, and the
//    entries' ds rows stream through a per-warp cp.async ring in shared
//    memory, 12 rows ahead of the ones summed.  Each ds row is added with
//    the weights to the block's pixels in registers, and its dot with x at
//    each of them (x of the block's pixels is loaded once) is written at
//    the entry's sorted place, so ds is read in this pass only.  Four
//    entries go as straight-line code (predicated sums, no branches) and
//    their 16 dots are summed over the warp together by a transposed
//    butterfly, 16 shuffles in 5 dependent steps: a reduction per entry
//    made a chain of shuffles that paced the walk.  A last pass per sample
//    picks its four corners' dots and turns them into dm, dsy and dsx;
//  * a list longer than LMAX entries (a pile-up on one cell) is cut at the
//    multiples of LMAX of the sorted entries: each piece after the first
//    is summed by a warp of its own into a float32 part, and the owner
//    adds the parts in order.
// Nothing is atomic on floats, so two runs give equal bits.  The
// coordinate derivative is the floor form (exact at integer coordinates,
// where zero-init offsets start) and is zero where the coordinate was
// clamped into the map: the derivative of the plain version.
constexpr int SNT = 256;

constexpr int B5Y = 4, B5X = 4;             // B5's output pixel tile
constexpr int B5R = B5Y * B5X * TAPS;       // its (pixel, tap) rows
constexpr int B5U = 2;                      // rows a warp has in flight

template <typename T>
__global__ void __launch_bounds__(SNT, 4) dcn_samples_kernel(
    const T* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    T* __restrict__ out, int H, int W, int C, int Ho, int Wo) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int NW = SNT / 32;
  __shared__ int cidx[B5R][4];
  __shared__ float cwt[B5R][4];
  const int tyn = (Ho + B5Y - 1) / B5Y, txn = (Wo + B5X - 1) / B5X;
  const int v = blockIdx.x / (tyn * txn), t = blockIdx.x % (tyn * txn);
  const int oy0 = t / txn * B5Y, ox0 = t % txn * B5X;
  const long long N = (long long)(v + 1) * Ho * Wo;   // pixels up to v's
  // pixel q of the tile (row-major) and its place, N outside the map
  auto pixel = [&](int q) -> long long {
    const int oy = oy0 + q / B5X, ox = ox0 + q % B5X;
    return oy < Ho && ox < Wo ? ((long long)v * Ho + oy) * Wo + ox : N;
  };
  for (int e = threadIdx.x; e < B5R; e += SNT)
    tap_corners(pixel(e / TAPS), e % TAPS, sy, sx, m, H, W, Ho * Wo, N,
                cidx[e], cwt[e]);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (blockIdx.y * 32 + lane) * VW;
  if (c >= C) return;
  for (int r0 = warp; r0 < B5R; r0 += NW * B5U) {
    uint4 raw[B5U][4];
    float wt[B5U][4];
#pragma unroll
    for (int u = 0; u < B5U; ++u) {
      const int r = r0 + u * NW;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wt[u][q] = r < B5R ? cwt[r][q] : 0.f;
        raw[u][q] = make_uint4(0, 0, 0, 0);
        if (wt[u][q] != 0.f)
          raw[u][q] = *reinterpret_cast<const uint4*>(
              x + (size_t)cidx[r][q] * C + c);
      }
    }
#pragma unroll
    for (int u = 0; u < B5U; ++u) {
      const int r = r0 + u * NW;
      if (r >= B5R) break;
      const long long p = pixel(r / TAPS);
      if (p >= N) continue;
      float acc[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T* e = reinterpret_cast<const T*>(&raw[u][q]);
#pragma unroll
        for (int j = 0; j < VW; ++j)
          acc[j] = fmaf(wt[u][q], mv2d::to_f32(e[j]), acc[j]);
      }
      uint4 packed;
      T* e = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < VW; ++j) e[j] = mv2d::from_f32<T>(acc[j]);
      __stcs(reinterpret_cast<uint4*>(out + (p * TAPS + r % TAPS) * C + c),
             packed);
    }
  }
}

constexpr int RT = 256;               // radix-sort threads a block
constexpr int RI = 16;                // items a thread
constexpr int RTILE = RT * RI;        // items a tile
constexpr int RBITS = 8;              // digit bits a pass, at most
constexpr int LMAX = 256;             // entries a piece of a block's list
constexpr int WG = 4;                 // entries a stage of a walking warp's ring
constexpr int WSTG = 4;               // stages of the ring
constexpr int WALK_WARP = WSTG * WG * 32 + 32 + 8;   // 16-byte words a warp
constexpr int WALK_SMEM = SNT / 32 * WALK_WARP * 16;  // bytes a block
constexpr unsigned NOKEY = 0xffffffffu;

__device__ __forceinline__ int digit_of(unsigned key, int shift, int D) {
  return key == NOKEY ? D : (int)((key >> shift) & (unsigned)(D - 1));
}

// Index pass: the keys of sample pt are the owner blocks of its corners,
// each distinct block once in corner order, then NOKEY (all NOKEY outside
// the map); entry e = 4 pt + slot.  An entry with a key also gets, at
// slot * NP + pt (slot-major, so a warp's stores are coalesced), wp: the
// weight w_q m its corners put on each of the block's four pixels (pixel
// li = 2 (y & 1) + (x & 1)), and pmask: the pixels that hold one of its
// corners (bit li).  A block of RT
// threads makes one RTILE-entry tile and counts its digits for the first
// radix pass: counts[d * nb + tile].
__global__ void __launch_bounds__(RT) owner_keys_kernel(
    const float* __restrict__ sy, const float* __restrict__ sx,
    const float* __restrict__ m, unsigned* __restrict__ keys,
    float4* __restrict__ wp, int* __restrict__ pmask,
    int* __restrict__ counts, int H, int W, int Hb, int Wb,
    int pairs_per_view, long long NP, int D, int nb) {
  __shared__ int h[1 << RBITS];
  for (int d = threadIdx.x; d < D; d += RT) h[d] = 0;
  __syncthreads();
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int j = 0; j < RI / 4; ++j) {
    const long long pt =
        (long long)blockIdx.x * (RTILE / 4) + j * RT + threadIdx.x;
    const bool here = pt < NP;             // every lane takes part below
    const float yr = here ? sy[pt] : -2.f, xr = here ? sx[pt] : -2.f;
    unsigned k[4] = {NOKEY, NOKEY, NOKEY, NOKEY};
    if (in_map(yr, xr, H, W)) {
      const Bilinear b = bilinear_at(yr, xr, H, W);
      const float mm = m[pt];
      const float wq[4] = {(1.f - b.ly) * (1.f - b.lx) * mm,
                           (1.f - b.ly) * b.lx * mm,
                           b.ly * (1.f - b.lx) * mm, b.ly * b.lx * mm};
      const int cy[4] = {b.y0, b.y0, b.y1, b.y1};
      const int cx[4] = {b.x0, b.x1, b.x0, b.x1};
      const unsigned row = (unsigned)(pt / pairs_per_view) * Hb;
      unsigned bq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bq[q] = (row + (cy[q] >> 1)) * Wb + (cx[q] >> 1);
      int slot = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bool fresh = true;
#pragma unroll
        for (int r = 0; r < q; ++r) fresh &= bq[r] != bq[q];
        if (!fresh) continue;
        float w4[4] = {0.f, 0.f, 0.f, 0.f};
        int cm = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int li = (cy[r] & 1) * 2 + (cx[r] & 1);
          const bool same = bq[r] == bq[q];
#pragma unroll
          for (int l = 0; l < 4; ++l)
            if (same && li == l) w4[l] += wq[r];
          cm |= same ? 1 << li : 0;
        }
        k[slot] = bq[q];
        wp[slot * NP + pt] = make_float4(w4[0], w4[1], w4[2], w4[3]);
        pmask[slot * NP + pt] = cm;
        ++slot;
      }
    }
    if (here)
      reinterpret_cast<uint4*>(keys)[pt] = make_uint4(k[0], k[1], k[2], k[3]);
    // digit counts, one shared atomic per digit a warp holds (neighbouring
    // samples share blocks, so per-slot atomics would queue on one word)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned d = k[q] == NOKEY ? D : k[q] & (unsigned)(D - 1);
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d < (unsigned)D && (peers & lt) == 0)
        atomicAdd(&h[d], __popc(peers));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += RT)
    counts[(long long)d * nb + blockIdx.x] = h[d];
}

// Digit counts of one radix pass over the first *count entries (all with
// a key), per RTILE tile: counts[d * nb + tile].
__global__ void __launch_bounds__(RT) radix_hist_kernel(
    const unsigned* __restrict__ keys, const int* __restrict__ count,
    int shift, int D, int nb, int* __restrict__ counts) {
  __shared__ int h[1 << RBITS];
  for (int d = threadIdx.x; d < D; d += RT) h[d] = 0;
  __syncthreads();
  const int n = *count;
  const long long base = (long long)blockIdx.x * RTILE;
#pragma unroll
  for (int j = 0; j < RI; ++j) {
    const long long i = base + j * RT + threadIdx.x;
    if (i < n) atomicAdd(&h[(keys[i] >> shift) & (unsigned)(D - 1)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += RT)
    counts[(long long)d * nb + blockIdx.x] = h[d];
}

// Exclusive prefix sum over the RT threads of a block (v: this thread's
// value); `tmp` holds RT / 32 ints of shared memory; *sum gets the total.
__device__ __forceinline__ int block_scan(int v, int* tmp, int* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();                         // tmp free from an earlier call
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < RT / 32; ++w) {
    before += w < warp ? tmp[w] : 0;
    all += tmp[w];
  }
  *sum = all;
  return before + incl - v;
}

// Row d of counts (the tiles' counts of digit d) -> its exclusive prefix
// sum, in place, and the digit's total: one block a digit.
__global__ void __launch_bounds__(RT) row_scan_kernel(
    int* __restrict__ counts, int nb, int* __restrict__ digit_total) {
  __shared__ int tmp[RT / 32];
  int* row = counts + (long long)blockIdx.x * nb;
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += RT) {
    const int i = b0 + threadIdx.x;
    const int v = i < nb ? row[i] : 0;
    int sum;
    const int ex = block_scan(v, tmp, &sum);
    if (i < nb) row[i] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) digit_total[blockIdx.x] = carry;
}

// One stable radix pass: entry i of the tile goes to (entries of lower
// digits) + offsets[d * nb + tile] (entries of digit d in earlier tiles)
// + (entries of digit d before it in the tile).  A warp ranks 32 entries a
// step with __match_any_sync and keeps running counts per digit, the warps
// of a tile holding consecutive runs, so ranks follow the entry order.  The
// first pass reads the index pass's keys (value: the entry, i) and drops
// NOKEY; the later ones the first *count entries.  With `inv`, the last
// pass also records where each entry went: inv[entry] = its place.
template <bool FIRST>
__global__ void __launch_bounds__(RT) radix_scatter_kernel(
    const unsigned* __restrict__ kin, const int* __restrict__ vin,
    const int* __restrict__ count, long long n_first, int shift, int D,
    int nb, const int* __restrict__ offsets,
    const int* __restrict__ digit_total, int* __restrict__ total,
    unsigned* __restrict__ kout, int* __restrict__ vout,
    int* __restrict__ inv) {
  constexpr int WARPS = RT / 32;
  __shared__ int cnt[WARPS][(1 << RBITS) + 2];
  __shared__ int base_of[1 << RBITS];
  __shared__ int tmp[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = FIRST ? n_first : (long long)*count;
  for (int e = threadIdx.x; e < WARPS * (D + 2); e += RT)
    cnt[e / (D + 2)][e % (D + 2)] = 0;
  // entries of the digits below each digit (D + 1 <= RT + 1 totals)
  {
    const int d = threadIdx.x;
    int sum;
    const int ex = block_scan(d < D ? digit_total[d] : 0, tmp, &sum);
    if (d < D) base_of[d] = ex;
    if (FIRST && blockIdx.x == 0 && d == 0) *total = sum;
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * RTILE + warp * (RI * 32);
  unsigned key[RI];
  int val[RI], dg[RI], rank[RI];
#pragma unroll
  for (int j = 0; j < RI; ++j) {
    const long long i = base + j * 32 + lane;
    const bool ok = i < n;
    key[j] = ok ? kin[i] : NOKEY;
    val[j] = !ok ? 0 : FIRST ? (int)i : vin[i];
    dg[j] = ok ? digit_of(key[j], shift, D) : D + 1;
  }
#pragma unroll
  for (int j = 0; j < RI; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, dg[j]);
    rank[j] = cnt[warp][dg[j]] + __popc(peers & lt);
    __syncwarp();
    if ((peers & lt) == 0) cnt[warp][dg[j]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += RT) {
    int run = base_of[d] + offsets[(long long)d * nb + blockIdx.x];
    for (int w = 0; w < WARPS; ++w) {
      const int t = cnt[w][d];
      cnt[w][d] = run;
      run += t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RI; ++j)
    if (dg[j] < D) {
      const int pos = cnt[warp][dg[j]] + rank[j];
      kout[pos] = key[j];
      vout[pos] = val[j];
      if (inv != nullptr) inv[val[j]] = pos;
    }
}

// starts[k] = the first sorted entry of block k (starts[nkeys] = *count):
// entry i writes the starts of the blocks after its predecessor's, up to
// its own.
__global__ void __launch_bounds__(SNT) owner_starts_kernel(
    const unsigned* __restrict__ keys, const int* __restrict__ count,
    int nkeys, int* __restrict__ starts) {
  const long long i = (long long)blockIdx.x * SNT + threadIdx.x;
  const int n = *count;
  if (i > n) return;
  const int prev = i == 0 ? -1 : (int)keys[i - 1];
  const int cur = i == n ? nkeys : (int)keys[i];
  for (int k = prev + 1; k <= cur; ++k) starts[k] = (int)i;
}

// One step of a transposed warp reduction: lanes with BIT set keep
// values HALF.. of v[0, 2 HALF), the others values ..HALF - 1, each added
// to its partner's (lane ^ BIT) copy, into v[0, HALF).
template <int HALF, int BIT>
__device__ __forceinline__ void exchange(float* v, int lane) {
  const bool up = lane & BIT;
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    const float mine = up ? v[e + HALF] : v[e];
    const float give = up ? v[e] : v[e + HALF];
    v[e] = mine + __shfl_xor_sync(0xffffffffu, give, BIT);
  }
}

// The owners' walk.  A warp takes (item, channel slice).  With OWNER,
// item = block kb: it walks the block's list, or of a list longer than
// LMAX only the first piece, up to the next multiple of LMAX, then adds the
// later pieces' parts in order, and writes dx.  Without, item + 1 = k:
// the piece from entry k * LMAX to the end of the list longer than LMAX
// that runs through it (if that list began before), summed into part[k].
// Both write, for each sorted entry i, the dot of its ds row with x at each
// of the block's pixels: dots[(4 i + li) * S + slice].
template <typename T, bool OWNER>
__global__ void __launch_bounds__(SNT, 2) owner_walk_kernel(
    const T* __restrict__ x, const T* __restrict__ ds,
    const float4* __restrict__ wp, const int* __restrict__ pmask,
    const unsigned* __restrict__ keys, const int* __restrict__ ents,
    const int* __restrict__ starts, const int* __restrict__ count,
    float* __restrict__ part, float* __restrict__ dots, T* __restrict__ dx,
    int H, int W, int C, int Hb, int Wb, int S, long long NP,
    long long items) {
  constexpr int VW = 16 / sizeof(T);
  const long long gw = ((long long)blockIdx.x * SNT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  if (gw >= items) return;
  const int slice = (int)(gw % S);
  const long long item = gw / S;
  int kb, lo, hi, begin, end;
  if (OWNER) {
    kb = (int)item;
    lo = begin = starts[kb];
    end = starts[kb + 1];
    hi = end - begin > LMAX ? min(end, (begin / LMAX + 1) * LMAX) : end;
  } else {
    const long long p0 = (item + 1) * LMAX;
    if (p0 >= *count) return;
    kb = (int)keys[p0];
    lo = (int)p0;
    begin = starts[kb];
    end = starts[kb + 1];
    if (begin == lo || end - begin <= LMAX) return;   // no piece here
    hi = min(end, lo + LMAX);
  }
  const int HWb = Hb * Wb;
  const int v = kb / HWb, by = (kb % HWb) / Wb, bx = kb % Wb;
  const int c = slice * 32 * VW + lane * VW;
  const bool act = c < C;
  uint4 xr[4];                             // x at the block's pixels
#pragma unroll
  for (int li = 0; li < 4; ++li) {
    const int py = 2 * by + (li >> 1), px = 2 * bx + (li & 1);
    xr[li] = make_uint4(0, 0, 0, 0);
    if (act && py < H && px < W)
      xr[li] = *reinterpret_cast<const uint4*>(
          x + (((size_t)v * H + py) * W + px) * C + c);
  }
  float acc[4][VW];
#pragma unroll
  for (int li = 0; li < 4; ++li)
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[li][j] = 0.f;
  // this warp's shared memory: a ring of WSTG stages of WG entries' 16-byte
  // ds vectors a lane, then a batch's weights and pixel masks
  extern __shared__ uint4 walk_smem[];
  uint4* ring = walk_smem + wib * WALK_WARP;
  float4* bw = reinterpret_cast<float4*>(ring + WSTG * WG * 32);
  int* bm = reinterpret_cast<int*>(bw + 32);
  for (int b0 = lo; b0 < hi; b0 += 32) {
    // a batch of up to 32 entries: lane j loads entry b0 + j's record; the
    // entries' ds rows stream in by cp.async, WSTG - 1 groups of WG ahead
    // of the one summed
    const int nbat = min(32, hi - b0), ng = (nbat + WG - 1) / WG;
    const int my_en = lane < nbat ? ents[b0 + lane] : 0;
    auto issue = [&](int g) {
#pragma unroll
      for (int u = 0; u < WG; ++u) {
        const int idx = g * WG + u;
        const int en = __shfl_sync(0xffffffffu, my_en, idx & 31);
        mv2d::tc::cp_async<16>(ring + ((g % WSTG) * WG + u) * 32 + lane,
                               ds + (size_t)(en >> 2) * C + (act ? c : 0),
                               act && idx < nbat);
      }
      mv2d::tc::cp_async_commit();
    };
#pragma unroll
    for (int g = 0; g < WSTG - 1; ++g) {
      if (g < ng) issue(g);
      else mv2d::tc::cp_async_commit();
    }
    __syncwarp();                          // the last batch's records read
    if (lane < nbat) {
      const size_t at = (size_t)(my_en & 3) * NP + (my_en >> 2);
      bw[lane] = wp[at];
      bm[lane] = pmask[at];
    }
    __syncwarp();
    for (int g = 0; g < ng; ++g) {
      if (g + WSTG - 1 < ng) issue(g + WSTG - 1);
      else mv2d::tc::cp_async_commit();
      mv2d::tc::cp_async_wait<WSTG - 1>();
      // the group's WG entries as straight-line code: their sums into
      // acc (predicated on the pixels each entry's corners hold) and their
      // per-pixel dots, dl[4 u + li], reduced together below
      float dl[WG * 4];
#pragma unroll
      for (int u = 0; u < WG; ++u) {
        const int src = g * WG + u;      // >= nbat: a zero-filled slot
        const int pm = src < nbat ? bm[src] : 0;
        const float4 w4 = bw[src & 31];
        const float wl[4] = {w4.x, w4.y, w4.z, w4.w};
        const uint4 rg = ring[((g % WSTG) * WG + u) * 32 + lane];
        const T* ge = reinterpret_cast<const T*>(&rg);
        float gv[VW];
#pragma unroll
        for (int j = 0; j < VW; ++j) gv[j] = mv2d::to_f32(ge[j]);
#pragma unroll
        for (int li = 0; li < 4; ++li) {
          const bool on = pm >> li & 1;
          const T* xe = reinterpret_cast<const T*>(&xr[li]);
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            if (on) acc[li][j] = fmaf(wl[li], gv[j], acc[li][j]);
            d = fmaf(gv[j], mv2d::to_f32(xe[j]), d);
          }
          dl[u * 4 + li] = d;
        }
      }
      // transposed butterfly: each exchange halves the values a lane
      // keeps and doubles the lanes summed into them; lane pair (2 v,
      // 2 v + 1) ends with value v's sum over the warp
      exchange<8, 16>(dl, lane);
      exchange<4, 8>(dl, lane);
      exchange<2, 4>(dl, lane);
      exchange<1, 2>(dl, lane);
      dl[0] += __shfl_xor_sync(0xffffffffu, dl[0], 1);
      {
        // lane bits 4..1 name the value: 8 b4 + 4 b3 + 2 b2 + b1 = 4 u + li
        const int vv = (lane & 16 ? 8 : 0) + (lane & 8 ? 4 : 0) +
                       (lane & 4 ? 2 : 0) + (lane & 2 ? 1 : 0);
        const int u = vv >> 2, li = vv & 3, src = g * WG + u;
        if ((lane & 1) == 0 && src < nbat)
          dots[((size_t)(b0 + src) * 4 + li) * S + slice] = dl[0];
      }
    }
  }
  if (!act) return;
  if (OWNER) {
    if (end - begin > LMAX)
      for (int k = begin / LMAX + 1; (long long)k * LMAX < end; ++k)
#pragma unroll
        for (int li = 0; li < 4; ++li) {
          const float* pp = part + ((size_t)k * 4 + li) * C + c;
#pragma unroll
          for (int j = 0; j < VW; j += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pp + j);
            acc[li][j] += p4.x;
            acc[li][j + 1] += p4.y;
            acc[li][j + 2] += p4.z;
            acc[li][j + 3] += p4.w;
          }
        }
#pragma unroll
    for (int li = 0; li < 4; ++li) {
      const int py = 2 * by + (li >> 1), px = 2 * bx + (li & 1);
      if (py >= H || px >= W) continue;
      uint4 packed;
      T* e = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < VW; ++j) e[j] = mv2d::from_f32<T>(acc[li][j]);
      *reinterpret_cast<uint4*>(dx + (((size_t)v * H + py) * W + px) * C +
                                c) = packed;
    }
  } else {
    const long long k = item + 1;
#pragma unroll
    for (int li = 0; li < 4; ++li) {
      float* pp = part + ((size_t)k * 4 + li) * C + c;
#pragma unroll
      for (int j = 0; j < VW; j += 4)
        *reinterpret_cast<float4*>(pp + j) = make_float4(
            acc[li][j], acc[li][j + 1], acc[li][j + 2], acc[li][j + 3]);
    }
  }
}

// dm, dsy, dsx of each sample from its four corner dots d_q = ds . x_q:
//   dm = sum_q w_q d_q, dsy = ((1 - lx)(d2 - d0) + lx (d3 - d1)) m gy,
//   dsx = ((1 - ly)(d1 - d0) + ly (d3 - d2)) m gx,
// gy, gx = 0 where the coordinate was clamped; all 0 outside the map.
// Corner q's dot is that of its pixel in the entry of its block (slot as
// the index pass numbers them), at the entry's sorted place inv[4 pt +
// slot].
__global__ void __launch_bounds__(SNT) owner_coords_kernel(
    const float* __restrict__ sy, const float* __restrict__ sx,
    const float* __restrict__ m, const int* __restrict__ inv,
    const float* __restrict__ dots, float* __restrict__ dsy,
    float* __restrict__ dsx, float* __restrict__ dm, int H, int W, int S,
    long long NP) {
  const long long pt = (long long)blockIdx.x * SNT + threadIdx.x;
  if (pt >= NP) return;
  const float yr = sy[pt], xr = sx[pt], mm = m[pt];
  if (!in_map(yr, xr, H, W)) {
    dsy[pt] = dsx[pt] = dm[pt] = 0.f;
    return;
  }
  const float gy = (yr >= 0.f && yr <= (float)(H - 1)) ? 1.f : 0.f;
  const float gx = (xr >= 0.f && xr <= (float)(W - 1)) ? 1.f : 0.f;
  const Bilinear b = bilinear_at(yr, xr, H, W);
  const int cy[4] = {b.y0, b.y0, b.y1, b.y1};
  const int cx[4] = {b.x0, b.x1, b.x0, b.x1};
  // a corner's block, as the index pass compares them: (row, column) pair
  int by[4], bx[4], slot_of[4];
  int slots = 0;
  float d[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    by[q] = cy[q] >> 1;
    bx[q] = cx[q] >> 1;
    slot_of[q] = slots;
#pragma unroll
    for (int r = q - 1; r >= 0; --r)
      if (by[r] == by[q] && bx[r] == bx[q]) slot_of[q] = slot_of[r];
    if (slot_of[q] == slots) ++slots;
    const size_t at = ((size_t)inv[4 * pt + slot_of[q]] * 4 +
                       (cy[q] & 1) * 2 + (cx[q] & 1)) * S;
    d[q] = 0.f;
    for (int s = 0; s < S; ++s) d[q] += dots[at + s];
  }
  const float ly = b.ly, lx = b.lx;
  dm[pt] = (1.f - ly) * (1.f - lx) * d[0] + (1.f - ly) * lx * d[1] +
           ly * (1.f - lx) * d[2] + ly * lx * d[3];
  dsy[pt] = ((1.f - lx) * (d[2] - d[0]) + lx * (d[3] - d[1])) * mm * gy;
  dsx[pt] = ((1.f - ly) * (d[1] - d[0]) + ly * (d[3] - d[2])) * mm * gx;
}

// B6's workspace, carved from one buffer (256-byte aligned regions).
struct OwnerPlan {
  long long NP, E4;
  int Hb, Wb, nkeys, S, passes, bits, nb, nchunks;
  size_t keys0, wp, pmask, inv, kA, vA, vB, counts, digit_total, total,
      starts, dots, part, bytes;

  OwnerPlan(int V, int H, int W, int C, int Ho, int Wo, int dtype) {
    NP = (long long)V * Ho * Wo * TAPS;
    E4 = 4 * NP;
    Hb = (H + 1) / 2;
    Wb = (W + 1) / 2;
    nkeys = V * Hb * Wb;
    S = (C + 32 * (dtype == 0 ? 4 : 8) - 1) / (32 * (dtype == 0 ? 4 : 8));
    int key_bits = 1;
    while (key_bits < 31 && (1LL << key_bits) < nkeys) ++key_bits;
    passes = (key_bits + RBITS - 1) / RBITS;
    bits = (key_bits + passes - 1) / passes;
    nb = (int)std::max<long long>(1, (E4 + RTILE - 1) / RTILE);
    nchunks = (int)std::max<long long>(1, (E4 + LMAX - 1) / LMAX);
    size_t at = 0;
    auto take = [&](size_t n) {
      const size_t here = at;
      at += (n + 255) / 256 * 256;
      return here;
    };
    keys0 = take(E4 * 4);                 // the later passes' second keys
    wp = take(E4 * 16);
    pmask = take(E4 * 4);
    inv = take(E4 * 4);
    kA = take(E4 * 4);
    vA = take(E4 * 4);
    vB = take(E4 * 4);
    counts = take((size_t)(1 << bits) * nb * 4);
    digit_total = take((size_t)(1 << bits) * 4);
    total = take(4);
    starts = take(((size_t)nkeys + 1) * 4);
    dots = take(E4 * 4 * S * 4);
    part = take((size_t)nchunks * 4 * C * 4);
    bytes = at;
  }
};

unsigned grid_of(long long threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

// ---- B13: the combined backward of the DCN conv (K2's function).
//   ds[p, t, c] = sum_f dy[p, f] w[t, c, f]          (sample gradients)
//   dw[t, c, f] = sum_p samples[p, t, c] dy[p, f]     (tap-weight gradient)
// and from ds: dx, dm, dsy, dsx, as B6 takes them from dsamples.
// Replaces mv2d_tpu/ops/pallas_dcn.py: _run_conv_bwd (_kernel_conv_bwd),
// the backward of the MV2D_DCN_TRAIN_FUSED=1 training DCN, which recomputed
// the samples per band segment so that the forward saves none of them.
//
// What bounds it on the H100: operations.  Both products are 2 N 9C F
// operations (39.9 GFLOP each at the stage-3 layers: 0.081 ms for the two
// at the bf16 peak); the bytes (x, dy, the coordinates, dx, dw) are a few
// tens of MB.  The first form ran both products as float32 FMAs (over
// 1 ms of FMA floor alone) and scattered dx with float32 vector atomics
// into a zeroed float32 buffer: 6.22 ms at stage-3 s2.  Now one C entry
// runs, in order:
//  * ds = dy w^T on the tensor cores into a workspace in x's dtype, held
//    for the call only (156 MB at stage-3 s2 in bf16; the default route's
//    matmul hands B6 bf16 dsamples too, so the rounding is the port's
//    own).  A persistent block keeps a 128-row slice of w (all of F) in
//    shared memory and walks a contiguous range of 128-pixel tiles: dy
//    arrives by TMA in 64-column chunks through a four-stage ring, two
//    warpgroups run m64n128k16 wgmma (both operands K-major), and each
//    tile leaves through a 128-byte-swizzled staging tile by TMA stores;
//  * dw on the tensor cores: a block owns a (tap, 64 or 128 channels) x
//    F-column tile of dw and a share of the pixels.  Per 64- or 128-pixel
//    chunk it gathers the masked samples into swizzled shared tiles as K2
//    does (each sample weighed in float32 and rounded to bf16 exactly as
//    K2 rounds it, the next chunk's coordinates loaded beside these
//    corners), dy's rows arrive by TMA, and samples^T dy runs as
//    asynchronous wgmma with both operands MN-major while the threads
//    gather the next chunk.  At F = 256 a block takes 128 channels (a
//    warpgroup each), so that each dy row it reads feeds twice the work.
//    The pixel split makes three blocks an SM; each split writes its
//    float32 partial tile once, and a last pass sums the splits in order
//    into dw, in w's dtype;
//  * dx, dsy, dsx, dm by B6's owners' walk over the ds workspace (the
//    index pass, the radix sort, a warp a 2x2 block; see above): dx is
//    written once, in x's dtype, from float32 sums in a fixed order.
// Nothing is atomic on floats: two runs give equal bits, with no zero-fill
// and no cast around the call.  At stage-3 s2 it takes 0.64 ms
// (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W), from 6.22; in a routed
// training step (profile_train) its dw kernel takes 1.55 ms over nine
// launches and B6's walk 1.10 over eighteen.  What holds each: dw, its dy
// rows' L2 traffic and the gathers' latency at one block an SM; ds, each
// tile's four chunk round trips and its staging between its products.
// Tried and dropped on the way (slower or no faster at chip_smoke.py's
// shapes): a 256-row w slice re-read for every pixel tile, two ds blocks
// an SM with stores from registers, a second accumulator overlapping a
// tile's stores with the next tile's products, dw with 64-pixel chunks
// and the coordinates loaded after the gathers.  float32 inputs (the
// parity runs, 1e-4 with TF32 off) run FMA products for ds and dw over
// the same plan, and the same owners' walk.
constexpr int WPB = 32;    // pixels per float32 dw chunk
constexpr int BNC = 64;    // channel slice of a float32 dw tile

// the float32 dw: a block owns a 64 (tap, channel) x 64 output-channel tile
// of dw and a share of the pixels; per 32-pixel chunk it gathers the masked
// samples into shared memory, loads the dy rows and accumulates samples^T
// dy in registers, then writes its split's partial tile once
__global__ void __launch_bounds__(NT) dcn_conv_bwd_weight_kernel(
    const float* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const float* __restrict__ dy, float* __restrict__ part, int H, int W,
    int C, int HWo, long long N, int F, long long per_split) {
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
        s = fmaf(cwt[p][q], x[(size_t)cidx[p][q] * C + c0 + c], s);
      as[p][c] = s;
      bs[p][c] = pc + p < end ? dy[(pc + p) * F + f0 + c] : 0.f;
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

// the float32 ds: D [M, Nc] = A [M, K] B [Nc, K]^T by FMAs, a 64 x 64 tile
// a block (4 x 4 a thread), K in steps of 16 through shared memory
__global__ void __launch_bounds__(NT) sgemm_nt_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ D, long long M, int Nc, int K) {
  __shared__ float as[16][64 + 4], bs[16][64 + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * 64;
  const int n0 = blockIdx.y * 64;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int e = tid; e < 64 * 16; e += NT) {
      const int r = e / 16, k = e % 16;
      as[k][r] = m0 + r < M ? A[(m0 + r) * K + k0 + k] : 0.f;
      bs[k][r] = B[(size_t)(n0 + r) * K + k0 + k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) D[r * Nc + n0 + tx + 16 * j] = acc[i][j];
  }
}

// dw[e] = sum_s part[s][e], the splits in order, in dw's dtype
template <typename T>
__global__ void dcn_reduce_splits_kernel(const float* __restrict__ part,
                                         T* __restrict__ dw, long long n,
                                         int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + e];
  dw[e] = mv2d::from_f32<T>(s);
}

// ds = dy w^T in bf16 (the design is in the note above): BM x BN tiles of
// ds [N, NC], NC = 9C, taken column slice by column slice: a block keeps
// w's [BN][F] slice (F <= 512) and walks its range of pixel tiles, whose dy
// [BM][64] chunks pass through the ring.  A tile leaves through a staging
// tile in shared memory by TMA stores, which drain while the next tile's
// products run
template <int BN>
struct DsGemm {
  static constexpr int BM = 128, S = 4;
  static constexpr int A_ST = BM * 128, B_MAX = BN * 512 * 2;
  static constexpr int OUT = BM * BN * 2;     // BN / 64 boxes of [BM][64]
  static constexpr int SMEM = 1024 + S * A_ST + B_MAX + OUT + 64;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

template <int BN>
__global__ void __launch_bounds__(256, 1) ds_gemm_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap omap, long long N, int NC, int F) {
  using G = DsGemm<BN>;
  using namespace mv2d::tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* as = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bs = as + G::S * G::A_ST;
  unsigned char* os = bs + G::B_MAX;
  uint64_t* full = reinterpret_cast<uint64_t*>(os + G::OUT);
  uint64_t* bfull = full + G::S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, g8 = lane >> 2, tq = lane & 3;
  const int nk = F / 64;
  const long long pix_tiles = (N + G::BM - 1) / G::BM;
  const long long tiles = pix_tiles * (NC / BN);
  // this block's tiles: a contiguous range, column slice outer, so that it
  // loads one or two slices of w; chunk q is dy's columns 64 (q % nk) .. of
  // its tile q / nk, into stage q % S
  const long long first = tiles * blockIdx.x / gridDim.x;
  const int mine = (int)(tiles * (blockIdx.x + 1) / gridDim.x - first);
  const int nq = mine * nk;
  auto issue = [&](int q) {             // one thread
    if (q >= nq) return;
    const long long tile = first + q / nk;
    const int s = q % G::S;
    mbar_expect_tx(full + s, G::A_ST);
    tma_load_2d(as + s * G::A_ST, &amap, (q % nk) * 64,
                (int)(tile % pix_tiles * G::BM), full + s);
  };
  if (tid == 0) {
    for (int s = 0; s <= G::S; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
    for (int q = 0; q < G::S; ++q) issue(q);
  }
  __syncthreads();
  float acc[BN / 2];
  int q = 0, slice = -1, loads = 0;
  for (int j = 0; j < mine; ++j) {
    const long long tile = first + j;
    const int col = (int)(tile / pix_tiles);
    const int m0 = (int)(tile % pix_tiles * G::BM);
    if (col != slice) {   // every product of the last slice is done
      if (tid == 0) {
        mbar_expect_tx(bfull, BN * F * 2);
        for (int k = 0; k < nk; ++k)
          tma_load_2d(bs + k * BN * 128, &bmap, k * 64, col * BN, bfull);
      }
      mbar_wait(bfull, loads++ & 1);
      slice = col;
    }
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
    for (int k = 0; k < nk; ++k, ++q) {
      const int s = q % G::S;
      mbar_wait(full + s, (q / G::S) & 1);
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) fence_operand(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<BN, 0, 0>(
            acc, desc_sw128(as + s * G::A_ST + wg * 64 * 128 + ks * 32, 16,
                            1024),
            desc_sw128(bs + k * BN * 128 + ks * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) fence_operand(acc[r]);
      __syncthreads();                  // stage s read by both warpgroups
      if (tid == 0) issue(q + G::S);
    }
    // the tile, bf16, into the staging tile (128-byte-swizzled rows, as
    // the TMA store reads them) once the last tile's stores have read it
    if (tid == 0) bulk_wait<0, true>();
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + (warp & 3) * 16 + g8 + 8 * h;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        *reinterpret_cast<uint32_t*>(os + (n >> 3) * (G::BM * 128) +
                                     swz(r, n & 7) + 4 * tq) =
            pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    }
    fence_proxy_async();                // the writes, to the TMA store
    __syncthreads();
    if (tid == 0) {                     // rows past N are not written
      for (int b = 0; b < BN / 64; ++b)
        tma_store_2d(&omap, col * BN + b * 64, m0, os + b * (G::BM * 128));
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0, false>();
}

// dw in bf16 (the design is in the note above): a block owns tap t, 64 CG
// channels c0 .. and FB output channels.  With CG = 1 warpgroup g < NWG
// takes FT = FB / NWG of the output channels; with CG = 2 warpgroup g takes
// all FB = FT of them for channel group g, so that the block reads each dy
// row for twice the channels.  A chunk is KP pixels: the samples [CG][KP]
// [64 ch] and a stage of the dy ring [KP][FB] as FB / 64 boxes of 64
// columns
template <int FT, int NWG, int CG, int KP>
struct DwTc {
  static constexpr int FB = CG == 2 ? FT : FT * NWG;
  static constexpr int CV = 8 * CG;            // 16-byte vectors a pixel
  static constexpr int PS = 256 / CV;          // pixels a pass of the block
  static constexpr int VPT = KP / PS;          // vectors a thread
  static constexpr int A_GRP = KP * 128;       // samples [KP px][64 ch]
  static constexpr int A_TILE = CG * A_GRP;
  static constexpr int D_BOX = KP * 128;       // dy [KP px][64]
  static constexpr int D_TILE = D_BOX * FB / 64;
  static constexpr int REST = 1024 + 2 * A_TILE + 3 * KP * 32 + 64;
  static constexpr int S = REST + 3 * D_TILE <= 232448 ? 3 : 2;
  static constexpr int SMEM = REST + S * D_TILE;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

template <int FT, int NWG, int CG, int KP>
__global__ void __launch_bounds__(256, 1) dw_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const __grid_constant__ CUtensorMap dymap, float* __restrict__ part,
    int H, int W, int C, int HWo, long long N, int F, long long per_split) {
  using G = DwTc<FT, NWG, CG, KP>;
  using namespace mv2d::tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* as = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dys = as + 2 * G::A_TILE;
  Corner* ctab = reinterpret_cast<Corner*>(dys + G::S * G::D_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ctab + 3 * KP);
  const int tid = threadIdx.x, warp = tid >> 5, wg = warp >> 2;
  const int nfc = F / G::FB, cpt = C / (64 * CG);
  const int fc = blockIdx.x % nfc, r = blockIdx.x / nfc;
  const int t = r / cpt, c0 = (r % cpt) * 64 * CG, f0 = fc * G::FB;
  // warpgroup wg's channel group and first output channel
  const int wc = CG == 2 ? wg : 0, wf = CG == 2 ? 0 : wg * FT;
  const long long beg = (long long)blockIdx.y * per_split;
  const long long end = min(N, beg + per_split);
  const int n = end > beg ? (int)((end - beg + KP - 1) / KP) : 0;   // chunks

  // chunk i's corners (pixels beg + KP i ..), one thread a pixel, into
  // ctab slot i % 3: the coordinates are loaded first, so that their loads
  // fly with the sample loads of the chunk before
  struct Coord {
    float y, x, m;
  };
  auto coords = [&](int i) -> Coord {
    const long long p = beg + (long long)KP * i + tid;
    if (tid < KP && i < n && p < N)
      return {sy[p * TAPS + t], sx[p * TAPS + t], m[p * TAPS + t]};
    return {-2.f, -2.f, 0.f};
  };
  auto corners = [&](int i, Coord c) {
    if (tid < KP && i < n) {
      int idx[4];
      float wt[4];
      corners_at(beg + (long long)KP * i + tid, c.y, c.x, c.m, H, W, HWo, idx,
                 wt);
      ctab[(i % 3) * KP + tid] = {
          make_int4(idx[0] * C, idx[1] * C, idx[2] * C, idx[3] * C),
          make_float4(wt[0], wt[1], wt[2], wt[3])};
    }
  };
  // chunk i's dy rows, FB / 64 boxes by TMA (one thread); rows past N
  // arrive as zeros
  auto load_dy = [&](int i) {
    const int s = i % G::S;
    mbar_expect_tx(full + s, G::D_TILE);
    for (int b = 0; b < G::FB / 64; ++b)
      tma_load_2d(dys + s * G::D_TILE + b * G::D_BOX, &dymap, f0 + b * 64,
                  (int)(beg + (long long)KP * i), full + s);
  };
  // what a thread gathers: pixels pp + PS v, channels 8 q .. (of group
  // q / 8)
  const int pp = tid / G::CV, q = tid % G::CV, q8 = q & 7;
  const uint32_t adst = (q >> 3) * G::A_GRP + (pp >> 3) * 1024 +
                        (pp & 7) * 128 + ((q8 ^ (pp & 7)) << 4);
  const bf16* xq = x + c0 + q * 8;
  auto fill = [&](int i, int buf) {     // chunk i's samples, K2's rounding
    const Corner* ct = ctab + (i % 3) * KP + pp;
    static_assert(G::PS % 8 == 0, "a thread's pixels keep their swizzle");
    uint4 raw[G::VPT][4];
#pragma unroll
    for (int v = 0; v < G::VPT; ++v) {  // every corner load in flight
      const int4 o = ct[v * G::PS].off;
      raw[v][0] = ldg_nc_v4(xq + o.x);
      raw[v][1] = ldg_nc_v4(xq + o.y);
      raw[v][2] = ldg_nc_v4(xq + o.z);
      raw[v][3] = ldg_nc_v4(xq + o.w);
    }
#pragma unroll
    for (int v = 0; v < G::VPT; ++v) {
      const float4 cw = ct[v * G::PS].wt;
      const float wq4[4] = {cw.x, cw.y, cw.z, cw.w};
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t* rr = reinterpret_cast<const uint32_t*>(&raw[v][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[2 * j] = fmaf(wq4[k], __uint_as_float(rr[j] << 16), s[2 * j]);
          s[2 * j + 1] =
              fmaf(wq4[k], __uint_as_float(rr[j] & 0xffff0000u), s[2 * j + 1]);
        }
      }
      uint4 packed;
      uint32_t* o = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      *reinterpret_cast<uint4*>(as + buf * G::A_TILE + adst +
                                v * G::PS * 128) = packed;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < G::S; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
  }
  corners(0, coords(0));
  corners(1, coords(1));
  __syncthreads();                      // corners and barriers are set
  if (tid == 0)
    for (int i = 0; i < G::S && i < n; ++i) load_dy(i);
  if (n > 0) fill(0, 0);
  fence_proxy_async();
  __syncthreads();
  float acc[FT / 2];
#pragma unroll
  for (int k = 0; k < FT / 2; ++k) acc[k] = 0.f;
  // chunk i's products (samples^T [64 ch x KP px] . dy [KP px x FT], both
  // MN-major) run while the threads gather chunk i + 1 and find chunk i +
  // 2's corners; one block barrier a chunk, after which its dy stage is
  // refilled
  for (int i = 0; i < n; ++i) {
    const int buf = i & 1, s = i % G::S;
    mbar_wait(full + s, (i / G::S) & 1);
#pragma unroll
    for (int k = 0; k < FT / 2; ++k) fence_operand(acc[k]);
    wgmma_fence();
    if (wg < NWG) {
#pragma unroll
      for (int ks = 0; ks < KP / 16; ++ks)
        wgmma_ss<FT, 1, 1>(
            acc,
            desc_sw128(as + buf * G::A_TILE + wc * G::A_GRP + ks * 2048,
                       G::A_GRP, 1024),
            desc_sw128(dys + s * G::D_TILE + wf / 64 * G::D_BOX + ks * 2048,
                       G::D_BOX, 1024));
    }
    wgmma_commit();
    const Coord c = coords(i + 2);
    if (i + 1 < n) fill(i + 1, buf ^ 1);
    corners(i + 2, c);
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < FT / 2; ++k) fence_operand(acc[k]);
    fence_proxy_async();                // the samples, to wgmma's reads
    __syncthreads();
    if (tid == 0 && i + G::S < n) load_dy(i + G::S);
  }
  if (wg >= NWG) return;
  // the split's partial tile, float32, rows (t, c0 + ..), columns f0 + ..
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  float* out = part +
               ((size_t)blockIdx.y * TAPS * C + (size_t)t * C + c0 + wc * 64) *
                   F +
               f0 + wf;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (warp & 3) * 16 + h * 8 + g;
#pragma unroll
    for (int j = 0; j < FT / 8; ++j)
      *reinterpret_cast<float2*>(out + (size_t)row * F + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// B13's plan: the pixel split of dw and its workspace, carved from one
// buffer (256-byte aligned regions): ds [N, 9C] in x's dtype, B6's
// workspace, the splits' float32 partials of dw
struct ConvBwdPlan {
  long long N;
  int ft, nwg, cg, splits;
  long long per_split;
  size_t ds, owner, part, bytes;

  ConvBwdPlan(int V, int H, int W, int C, int Ho, int Wo, int F, int dtype,
              int sms) {
    N = (long long)V * Ho * Wo;
    // the bf16 dw's tile: 64 cg channels x fb output channels a block
    cg = F == 256 && C % 128 == 0 ? 2 : 1;
    ft = F % 512 == 0 || cg == 2 ? 256 : 64;
    nwg = F % 128 == 0 ? 2 : 1;
    const int fb = cg == 2 ? ft : ft * nwg;
    const long long tiles = dtype == 1 ? 9LL * (C / 64 / cg) * (F / fb)
                                       : 9LL * (C / 64) * (F / 64);
    // about three blocks an SM deep, at least 256 pixels a split
    long long s = std::max(1LL, 3LL * sms / std::max(1LL, tiles));
    s = std::min(s, std::max(1LL, (N + 255) / 256));
    splits = (int)s;
    per_split = ((N + splits - 1) / splits + 127) / 128 * 128;
    size_t at = 0;
    auto take = [&](size_t n) {
      const size_t here = at;
      at += (n + 255) / 256 * 256;
      return here;
    };
    ds = take((size_t)N * TAPS * C * (dtype == 1 ? 2 : 4));
    owner = take(OwnerPlan(V, H, W, C, Ho, Wo, dtype).bytes);
    part = take((size_t)splits * TAPS * C * F * 4);
    bytes = at;
  }
};

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int BN>
int launch_ds_gemm(const bf16* dy, const bf16* w, bf16* ds, long long N,
                   int C, int F, int sms, cudaStream_t s) {
  using G = DsGemm<BN>;
  CUtensorMap amap, bmap, omap;
  using mv2d::tc::encode_rows;
  if (F > 512 || !encode_rows(&amap, dy, N, F, G::BM) ||
      !encode_rows(&bmap, w, (long long)TAPS * C, F, BN) ||
      !encode_rows(&omap, ds, N, TAPS * C, G::BM))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = ds_gemm_kernel<BN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G::SMEM);
  const long long tiles = (N + G::BM - 1) / G::BM * (TAPS * C / BN);
  kernel<<<(unsigned)std::min<long long>(tiles, sms), 256, G::SMEM, s>>>(
      amap, bmap, omap, N, TAPS * C, F);
  return static_cast<int>(cudaGetLastError());
}

// dw's tile: KP = 128 pixels a chunk, 64 where the dy stage or the
// registers would be too many (FB = 512, or two channel groups)
template <int FT, int NWG, int CG>
int launch_dw_tc(const bf16* x, const float* sy, const float* sx,
                 const float* m, const bf16* dy, float* part, int H, int W,
                 int C, int HWo, const ConvBwdPlan& P, int F,
                 cudaStream_t s) {
  constexpr int KP = CG == 1 && FT * NWG <= 256 ? 128 : 64;
  using G = DwTc<FT, NWG, CG, KP>;
  CUtensorMap dymap;
  if (!mv2d::tc::encode_rows(&dymap, dy, P.N, F, KP))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = dw_tc_kernel<FT, NWG, CG, KP>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G::SMEM);
  const dim3 grid((unsigned)(TAPS * (C / 64 / CG) * (F / G::FB)),
                  (unsigned)P.splits);
  kernel<<<grid, 256, G::SMEM, s>>>(x, sy, sx, m, dymap, part, H, W, C, HWo,
                                    P.N, F, P.per_split);
  return static_cast<int>(cudaGetLastError());
}

// B6 (the index pass, the radix sort, the owners' walk, the coordinate
// pass) over ds [V, Ho, Wo, 9, C]; work holds OwnerPlan's bytes
int samples_bwd(const void* x, const float* fy, const float* fx,
                const float* fm, const void* ds, void* dx, float* dsy,
                float* dsx, float* dm, void* work, int V, int H, int W,
                int C, int Ho, int Wo, int dtype, cudaStream_t s) {
  const OwnerPlan P(V, H, W, C, Ho, Wo, dtype);
  if (P.nkeys == 0) return 0;             // no map: nothing to write
  char* wb = static_cast<char*>(work);
  auto* keys0 = reinterpret_cast<unsigned*>(wb + P.keys0);
  auto* wp = reinterpret_cast<float4*>(wb + P.wp);
  auto* pmask = reinterpret_cast<int*>(wb + P.pmask);
  auto* inv = reinterpret_cast<int*>(wb + P.inv);
  auto* kA = reinterpret_cast<unsigned*>(wb + P.kA);
  auto* vA = reinterpret_cast<int*>(wb + P.vA);
  auto* vB = reinterpret_cast<int*>(wb + P.vB);
  auto* counts = reinterpret_cast<int*>(wb + P.counts);
  auto* dtot = reinterpret_cast<int*>(wb + P.digit_total);
  auto* total = reinterpret_cast<int*>(wb + P.total);
  auto* starts = reinterpret_cast<int*>(wb + P.starts);
  auto* dots = reinterpret_cast<float*>(wb + P.dots);
  auto* part = reinterpret_cast<float*>(wb + P.part);
  // the index pass and the first radix pass (digits of the low bits)
  int D = 1 << P.bits;
  owner_keys_kernel<<<P.nb, RT, 0, s>>>(fy, fx, fm, keys0, wp, pmask, counts,
                                        H, W, P.Hb, P.Wb, Ho * Wo * TAPS,
                                        P.NP, D, P.nb);
  row_scan_kernel<<<D, RT, 0, s>>>(counts, P.nb, dtot);
  radix_scatter_kernel<true><<<P.nb, RT, 0, s>>>(
      keys0, nullptr, nullptr, P.E4, 0, D, P.nb, counts, dtot, total, kA, vA,
      P.passes == 1 ? inv : nullptr);
  // the later passes, between (kA, vA) and (keys0, vB)
  unsigned *kin = kA, *kout = keys0;
  int *vin = vA, *vout = vB;
  for (int p = 1; p < P.passes; ++p) {
    const int shift = p * P.bits;
    D = 1 << P.bits;
    radix_hist_kernel<<<P.nb, RT, 0, s>>>(kin, total, shift, D, P.nb, counts);
    row_scan_kernel<<<D, RT, 0, s>>>(counts, P.nb, dtot);
    radix_scatter_kernel<false><<<P.nb, RT, 0, s>>>(
        kin, vin, total, 0, shift, D, P.nb, counts, dtot, total, kout, vout,
        p + 1 == P.passes ? inv : nullptr);
    std::swap(kin, kout);
    std::swap(vin, vout);
  }
  owner_starts_kernel<<<grid_of(P.E4 + 1, SNT), SNT, 0, s>>>(kin, total,
                                                             P.nkeys, starts);
  const long long pieces = (long long)(P.nchunks - 1) * P.S;
  const long long owners = (long long)P.nkeys * P.S;
  MV2D_DISPATCH(dtype, T, {
    const T* tx = static_cast<const T*>(x);
    const T* tds = static_cast<const T*>(ds);
    cudaFuncSetAttribute(owner_walk_kernel<T, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WALK_SMEM);
    cudaFuncSetAttribute(owner_walk_kernel<T, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WALK_SMEM);
    if (pieces > 0)
      owner_walk_kernel<T, false><<<grid_of(pieces * 32, SNT), SNT,
                                    WALK_SMEM, s>>>(
          tx, tds, wp, pmask, kin, vin, starts, total, part, dots, nullptr, H,
          W, C, P.Hb, P.Wb, P.S, P.NP, pieces);
    if (owners > 0)
      owner_walk_kernel<T, true><<<grid_of(owners * 32, SNT), SNT,
                                   WALK_SMEM, s>>>(
          tx, tds, wp, pmask, kin, vin, starts, total, part, dots,
          static_cast<T*>(dx), H, W, C, P.Hb, P.Wb, P.S, P.NP, owners);
  });
  if (P.NP > 0)
    owner_coords_kernel<<<grid_of(P.NP, SNT), SNT, 0, s>>>(
        fy, fx, fm, inv, dots, dsy, dsx, dm, H, W, P.S, P.NP);
  return static_cast<int>(cudaGetLastError());
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
  CUtensorMap wmap;
  if (!mv2d::tc::encode_rows(&wmap, w, (long long)TAPS * C, F, KC))
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

// The bytes of B13's workspace at these sizes (the `work` argument below).
extern "C" long long mv2d_dcn_conv_bwd_workspace(int V, int H, int W, int C,
                                                 int Ho, int Wo, int F,
                                                 int dtype) {
  return (long long)ConvBwdPlan(V, H, W, C, Ho, Wo, F, dtype, device_sms())
      .bytes;
}

// B13: dy [V, Ho, Wo, F] (dtype) -> dx [V, H, W, C] (dtype, every element
// written once), dsy / dsx / dm [V, Ho, Wo, 9] float32, dw [9, C, F]
// (dtype, written once); work: the bytes mv2d_dcn_conv_bwd_workspace names,
// 256-byte aligned.  C and F multiples of 64, F <= 512; 36 V Ho Wo and
// V H W C below 2^31.
extern "C" int mv2d_dcn_conv_bwd(const void* x, const void* sy,
                                 const void* sx, const void* m, const void* w,
                                 const void* dy, void* dx, void* dsy,
                                 void* dsx, void* dm, void* dw, void* work,
                                 int V, int H, int W, int C, int Ho, int Wo,
                                 int F, int dtype, void* stream) {
  if (C % 64 || F % 64 || F > 512 || (dtype != 0 && dtype != 1) ||
      (long long)V * H * W * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = device_sms();
  const ConvBwdPlan P(V, H, W, C, Ho, Wo, F, dtype, sms);
  if (P.N == 0 || H == 0 || W == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* fy = static_cast<const float*>(sy);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fm = static_cast<const float*>(m);
  char* wb = static_cast<char*>(work);
  float* part = reinterpret_cast<float*>(wb + P.part);
  const long long n = (long long)TAPS * C * F;
  int err = 0;
  if (dtype == 1) {
    const auto* bx = static_cast<const bf16*>(x);
    const auto* bdy = static_cast<const bf16*>(dy);
    auto* ds = reinterpret_cast<bf16*>(wb + P.ds);
    const auto* bw = static_cast<const bf16*>(w);
    // a slice of w that divides 9C and stays resident
    err = C % 128 == 0 ? launch_ds_gemm<128>(bdy, bw, ds, P.N, C, F, sms, s)
                       : launch_ds_gemm<64>(bdy, bw, ds, P.N, C, F, sms, s);
    if (err) return err;
    const int HWo = Ho * Wo;
    err = P.cg == 2 ? launch_dw_tc<256, 2, 2>(bx, fy, fx, fm, bdy, part, H,
                                              W, C, HWo, P, F, s)
          : P.ft == 256 ? launch_dw_tc<256, 2, 1>(bx, fy, fx, fm, bdy, part,
                                                  H, W, C, HWo, P, F, s)
          : P.nwg == 2 ? launch_dw_tc<64, 2, 1>(bx, fy, fx, fm, bdy, part, H,
                                                W, C, HWo, P, F, s)
                       : launch_dw_tc<64, 1, 1>(bx, fy, fx, fm, bdy, part, H,
                                                W, C, HWo, P, F, s);
    if (err) return err;
    dcn_reduce_splits_kernel<bf16><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        part, static_cast<bf16*>(dw), n, P.splits);
  } else {
    const auto* fdy = static_cast<const float*>(dy);
    auto* ds = reinterpret_cast<float*>(wb + P.ds);
    sgemm_nt_kernel<<<dim3((unsigned)((P.N + 63) / 64), TAPS * C / 64), NT, 0,
                      s>>>(fdy, static_cast<const float*>(w), ds, P.N,
                           TAPS * C, F);
    dcn_conv_bwd_weight_kernel<<<dim3(TAPS * C / BNC, F / BNC, P.splits), NT,
                                 0, s>>>(
        static_cast<const float*>(x), fy, fx, fm, fdy, part, H, W, C, Ho * Wo,
        P.N, F, P.per_split);
    dcn_reduce_splits_kernel<float><<<(unsigned)((n + 255) / 256), 256, 0,
                                      s>>>(part, static_cast<float*>(dw), n,
                                           P.splits);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return samples_bwd(x, fy, fx, fm, wb + P.ds, dx, static_cast<float*>(dsy),
                     static_cast<float*>(dsx), static_cast<float*>(dm),
                     wb + P.owner, V, H, W, C, Ho, Wo, dtype, s);
}

// x [V, H, W, C] (dtype), sy / sx / m [V, Ho, Wo, 9] float32 ->
// out [V, Ho, Wo, 9, C] (dtype); C a multiple of 16 bytes
extern "C" int mv2d_dcn_samples(const void* x, const void* sy,
                                const void* sx, const void* m, void* out,
                                int V, int H, int W, int C, int Ho, int Wo,
                                int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if ((long long)V * Ho * Wo == 0 || C == 0) return 0;
  const long long tiles = (long long)V * ((Ho + B5Y - 1) / B5Y) *
                          ((Wo + B5X - 1) / B5X);
  MV2D_DISPATCH(dtype, T, {
    constexpr int VW = 16 / sizeof(T);
    const dim3 grid((unsigned)tiles, (C / VW + 31) / 32);
    dcn_samples_kernel<T><<<grid, SNT, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(sy),
        static_cast<const float*>(sx), static_cast<const float*>(m),
        static_cast<T*>(out), H, W, C, Ho, Wo);
  });
  return static_cast<int>(cudaGetLastError());
}

// The bytes of B6's workspace at these sizes (the `work` argument below).
extern "C" long long mv2d_dcn_samples_bwd_workspace(int V, int H, int W,
                                                    int C, int Ho, int Wo,
                                                    int dtype) {
  return (long long)OwnerPlan(V, H, W, C, Ho, Wo, dtype).bytes;
}

// dsamples [V, Ho, Wo, 9, C] (dtype) -> dx [V, H, W, C] (dtype, every
// element written once), dsy / dsx / dm [V, Ho, Wo, 9] float32; work: the
// bytes mv2d_dcn_samples_bwd_workspace names, 256-byte aligned.  C % 8 == 0;
// 36 V Ho Wo and V H W C below 2^31.
extern "C" int mv2d_dcn_samples_bwd(const void* x, const void* sy,
                                    const void* sx, const void* m,
                                    const void* ds, void* dx, void* dsy,
                                    void* dsx, void* dm, void* work, int V,
                                    int H, int W, int C, int Ho, int Wo,
                                    int dtype, void* stream) {
  if (C % 8 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return samples_bwd(x, static_cast<const float*>(sy),
                     static_cast<const float*>(sx),
                     static_cast<const float*>(m), ds, dx,
                     static_cast<float*>(dsy), static_cast<float*>(dsx),
                     static_cast<float*>(dm), work, V, H, W, C, Ho, Wo, dtype,
                     static_cast<cudaStream_t>(stream));
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
