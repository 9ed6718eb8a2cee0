// Masked multi-head attention: the packed mask (a helper), kernel K4 (the
// forward) and kernel B8 (its backward).
//
//   out[q, h] = sum_k softmax_k(q_h . k_h / sqrt(D) | allowed[q, k]) v_h[k]
// Rows with no allowed key give zeros (mv2d_tpu/ops/attention.py
// masked_softmax semantics).  K4's second output, each (query, head)'s
// log-sum-exp of its allowed scaled logits, feeds the backward.
//
// K4 replaces mv2d_tpu/ops/pallas_attention.py: masked_flash_attention
// (sparse=True -> _sparse_fwd_call -> _sparse_kernel) and, with the
// log-sum-exp, the training forward (sparse=False -> _fwd_call -> _kernel):
// the same function, and skipping an empty tile is exact.  B8 replaces
// _flash_bwd (_bwd_kernel) and, on the MV2D_FLASH_SPARSE route, the
// block-sparse single-pass backward _flash_sparse_bwd (_sparse_bwd_kernel):
// both compute dQ, dK and dV, and B8 visits only the active tiles too.
//
// The mask.  The decoder's two masks are the same for all its layers, so
// they are packed once per decoder pass (ops/attention.py mask_tiles):
// `bits` [Q, ceil(K/64)] uint64, bit j of word t = allowed[q, 64t + j]
// (mask_bits_kernel below: one __ballot_sync per 32 keys), and two CSR
// lists of the 64x64 tiles that hold any allowed pair: the key tiles of
// each query tile (JAX's _sparse_blocks at 64-wide tiles) and the query
// tiles of each key tile.  K4 and B8 read only those: no mask byte, and
// no empty tile is visited.  At the training cross shape (2628 x 16384)
// the bits are 5.4 MB where the bool mask is 43 MB.
//
// What bounds them on the H100: the products.  With 8 heads of 32 and
// ~7,300 active tile pairs at the training cross shape, K4 does ~30 GFLOP
// and B8 ~107 GFLOP of tile products, plus ~240 M exp a pass, against a
// few MB of q / k / v.  So the bf16 kernels run every product on the
// tensor cores (mma.sync.m16n8k16, bf16 in, float32 accumulate), the
// FlashAttention-2 way: a block of 4 warps owns 64 rows of the fixed axis
// (16 a warp, held as mma fragments in registers), walks its tile list,
// and brings each walked [64, D] tile into shared memory by 16-byte
// cp.async, double-buffered so the next tile's copy overlaps this tile's
// products.  The mask of a fragment comes from one 64-bit word a row; the
// softmax stays in registers (quad shuffles), and P (and dS) turn from
// accumulator fragments into bf16 A fragments in registers for the second
// product.  Head dims 8 and 16 are padded with zeros to the mma depth of
// 16, which is exact.  mma.sync and not wgmma: a tile is [64, 32], so a
// wgmma would be as narrow as the head dim and its shared-memory B operand
// layout buys nothing over fragments loaded by ldmatrix at this size.
//
// K4: a block owns (64 queries, one head, one split of the query tile's
// list of key tiles).  Q = 900 gives only 120 (tile, head) blocks for 132
// SMs, so the list is split evenly across blocks (flash-decoding): each
// block writes its split's unnormalised output and row max / sum, and
// merge_splits_kernel merges them.  B8: delta = rowsum(dO * O), then one
// kernel where a block owns (64 keys, one head) and walks the key tile's
// list of query tiles for dK / dV, and one where a block owns (64 queries,
// one head, one split) and walks its share of the query tile's key tiles
// for dQ (the DN rows' query tiles hold every valid key tile, twice the
// others' share, so dQ splits its lists as K4 does; sum_splits_kernel adds
// the splits in order).  Each output element (each split's, for dQ) is
// written once by one thread, from registers: no atomics, so two runs give
// bit-equal gradients, and keys that no row may attend are written as
// zeros by their own block.
//
// Measured (chip_smoke.py, bf16, NVIDIA H100 80GB HBM3, 700 W): at the
// training cross shape (2628 x 16384, 9851 active tile pairs) K4 with its
// log-sum-exp 0.43 ms (the float32-FMA K4 before it: 4.11) and B8 0.91 ms
// (10.35), against 0.66 and 0.97 ms for masked scaled_dot_product_attention
// forward and backward; at the eval cross shape (900 x 16384) K4 0.16 ms
// (1.46; SDPA 0.34).  That is ~100 and ~160 TFLOP/s of tile products, a
// tenth to a sixth of the bf16 peak; what holds it there (the mma.sync
// issue rate of 16-row warps, the exp, the per-tile fragment loads) is not
// measured.  The packing kernel takes 0.15 ms at the training cross shape,
// twice a training step.
//
// float32 inputs (the tests' and chip_smoke.py's tiny parity phases, held
// to 1e-4 with TF32 off) take float32 FMA bodies on the CUDA cores, driven
// by the same bits and tile lists, with the same block ownership and no
// atomics (the four thread groups of a block meet in shared memory, in a
// fixed order).  bf16-rounded products would not hold 1e-4.  The body is
// chosen by dtype; a dtype neither body takes is refused.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
// log-sum-exp flag of a row with no allowed key: exp(s - kEmptyLse) = 0
constexpr float kEmptyLse = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
using bf16 = __nv_bfloat16;

// ---- the packed mask
// bits viewed as uint32 [Q, 2 * nKw]: word 2t holds keys 64t..64t+31 and
// 2t + 1 keys 64t+32..64t+63 (little-endian halves of uint64 word t); keys
// past K are 0.  One thread a (row, padded key), one ballot a warp.
__global__ void mask_bits_kernel(const uint8_t* __restrict__ mask,
                                 uint32_t* __restrict__ bits, int Q, int K,
                                 int nKw) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long width = (long long)nKw * 64;
  if (e >= (long long)Q * width) return;    // total is whole warps
  const long long qi = e / width;
  const int c = (int)(e % width);
  const bool on = c < K && mask[qi * K + c];
  const unsigned b = __ballot_sync(0xffffffffu, on);
  if ((threadIdx.x & 31) == 0) bits[e / 32] = b;
}

// ---- tensor-core helpers (bf16 kernels)
using namespace mv2d::tc;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 values in one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// A [16 x 16]: a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 8 + 2t..),
// a3 (g + 8, 8 + 2t..); B [16 x 8] (k x n): b0 (k 2t.., n g),
// b1 (k 8 + 2t.., n g); C [16 x 8]: c0 c1 (g, 2t, 2t + 1), c2 c3 (g + 8).
// Tiles in shared memory are row-major [64][LD] bf16, LD = DP + 8 (DP =
// the head dim padded to 16): rows 16 bytes aligned, fragment loads free
// of bank conflicts.
template <int D>
struct Tc {
  static constexpr int DP = D < 16 ? 16 : D;   // the mma depth over D
  static constexpr int LD = DP + 8;
  static constexpr int KS = DP / 16;           // k-steps over D
  static constexpr int ND = D / 8;             // n-tiles over D
  static constexpr int TILE = 64 * LD;         // elements of one tile
};

// A fragment of rows r0..r0+15, columns c0..c0+15 of a tile
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int r0,
                                       int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (r0 + g) * LD + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment (k = columns c0..c0+15, n = rows n0..n0+7) of a tile stored
// [n][k]: the transposed operand of S = A X^T
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1,
                                        const bf16* s, int n0, int c0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * LD + c0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment (k = rows k0..k0+15, n = columns n0..n0+7) of a tile stored
// [k][n], by ldmatrix.trans: the operand of O = P X
template <int LD>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int k0, int n0,
                                       int lane) {
  const bf16* p = s + (k0 + (lane & 15)) * LD + n0;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(p)));
}

// rows row0.. of a [rows, C] bf16 tensor, columns col0..col0+D, into a
// tile by 16-byte cp.async (rows past `rows` zero-filled); 128 threads
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int rows, int C,
                                          int col0, int tid) {
  constexpr int CH = D / 8, LD = Tc<D>::LD;
  for (int e = tid; e < 64 * CH; e += 128) {
    const int r = e / CH, c = e % CH, row = row0 + r;
    const bool ok = row < rows;
    cp_async<16>(dst + r * LD + c * 8,
                 src + (ok ? (size_t)row * C + col0 + c * 8 : 0), ok);
  }
}

// zero the columns D..DP of a tile (head dim 8: the mma depth's padding;
// no copy writes them)
template <int D>
__device__ __forceinline__ void zero_pad(bf16* s, int tid) {
  constexpr int P = Tc<D>::DP - D, LD = Tc<D>::LD;
  if constexpr (P > 0) {
    for (int e = tid; e < 64 * P; e += 128)
      s[(e / P) * LD + D + e % P] = __float2bfloat16(0.f);
  }
}

// this block's share [beg, end) of list entries starts[i]..starts[i + 1]
// when the list is cut into `splits` even parts
__device__ __forceinline__ void split_range(const int* starts, int i,
                                            int split, int splits,
                                            int& beg, int& end) {
  const int lb = starts[i], n = starts[i + 1] - lb;
  const int per = (n + splits - 1) / splits;
  beg = lb + min(n, split * per);
  end = lb + min(n, (split + 1) * per);
}

// ---- K4, bf16: tensor cores
template <int D>
__global__ void __launch_bounds__(128) masked_attention_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint64_t* __restrict__ bits,
    const int* __restrict__ starts, const int* __restrict__ tiles,
    float* __restrict__ po, float* __restrict__ pm, float* __restrict__ pl,
    int Q, int K, int H, int splits) {
  using T = Tc<D>;
  constexpr int LD = T::LD;
  __shared__ __align__(16) bf16 qs[T::TILE];
  __shared__ __align__(16) bf16 ks[2][T::TILE];
  __shared__ __align__(16) bf16 vs[2][T::TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int C = H * D, nKw = (K + BK - 1) / BK;
  int beg, end;
  split_range(starts, qt, split, splits, beg, end);
  zero_pad<D>(qs, tid);
  for (int st = 0; st < 2; ++st) {
    zero_pad<D>(ks[st], tid);
    zero_pad<D>(vs[st], tid);
  }
  load_tile<D>(qs, q, qt * BQ, Q, C, h * D, tid);
  if (beg < end) {
    load_tile<D>(ks[0], k, tiles[beg] * BK, K, C, h * D, tid);
    load_tile<D>(vs[0], v, tiles[beg] * BK, K, C, h * D, tid);
  }
  cp_async_commit();

  const float sl2 = kLog2e / sqrtf((float)D);    // logits in log2 units
  const int r0 = qt * BQ + warp * 16 + g, r1 = r0 + 8;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  float o[T::ND][4];
#pragma unroll
  for (int n = 0; n < T::ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qa[T::KS][4];

  for (int it = beg; it < end; ++it) {
    const int st = (it - beg) & 1, kt = tiles[it];
    const uint64_t w0 = r0 < Q ? bits[(size_t)r0 * nKw + kt] : 0ull;
    const uint64_t w1 = r1 < Q ? bits[(size_t)r1 * nKw + kt] : 0ull;
    if (it + 1 < end) {
      load_tile<D>(ks[st ^ 1], k, tiles[it + 1] * BK, K, C, h * D, tid);
      load_tile<D>(vs[st ^ 1], v, tiles[it + 1] * BK, K, C, h * D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == beg) {
#pragma unroll
      for (int kk = 0; kk < T::KS; ++kk)
        load_a<LD>(qa[kk], qs, warp * 16, kk * 16, lane);
    }
    // S = Q K^T over the tile's 64 keys: 8 n-tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < T::KS; ++kk) {
        uint32_t b0, b1;
        load_bt<LD>(b0, b1, ks[st], j * 8, kk * 16, lane);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
    // mask from the rows' words, row max
    float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        s[j][e] = (w0 >> c) & 1ull ? s[j][e] * sl2 : -INFINITY;
        s[j][2 + e] = (w1 >> c) & 1ull ? s[j][2 + e] * sl2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P as bf16 A fragments; the row sums add the rounded values
    uint32_t pa[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 x = __floats2bfloat162_rn(
          exp2f(s[j][0] - mn0), exp2f(s[j][1] - mn0));
      const __nv_bfloat162 y = __floats2bfloat162_rn(
          exp2f(s[j][2] - mn1), exp2f(s[j][3] - mn1));
      ps0 += __low2float(x) + __high2float(x);
      ps1 += __low2float(y) + __high2float(y);
      pa[j >> 1][(j & 1) * 2] = *reinterpret_cast<const uint32_t*>(&x);
      pa[j >> 1][(j & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&y);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < T::ND; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < T::ND; ++n) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, vs[st], kk * 16, n * 8, lane);
        mma_bf16(o[n], pa[kk], b0, b1);
      }
    }
    __syncthreads();       // the next copy overwrites this stage
  }
  cp_async_wait<0>();
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= Q) continue;
    const size_t row = (size_t)split * Q + r;
#pragma unroll
    for (int n = 0; n < T::ND; ++n)
      *reinterpret_cast<float2*>(po + row * C + h * D + n * 8 + 2 * t) =
          make_float2(o[n][2 * half], o[n][2 * half + 1]);
    if (t == 0) {
      pm[row * H + h] = (half ? m1 : m0) * kLn2;
      pl[row * H + h] = half ? l1 : l0;
    }
  }
}

// ---- K4, float32: FMAs on the CUDA cores over the same lists.  Four
// threads share a query row (16 logits and D/4 output columns each, row
// statistics combined with warp shuffles).
template <int D>
__global__ void __launch_bounds__(NT) masked_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint64_t* __restrict__ bits,
    const int* __restrict__ starts, const int* __restrict__ tiles,
    float* __restrict__ po, float* __restrict__ pm, float* __restrict__ pl,
    int Q, int K, int H, int splits) {
  constexpr int DS = D / 4;            // output columns per thread
  constexpr int JS = BK / 4;           // logits per thread per tile
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[BQ][BK + 1];
  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int qt = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int qi = qt * BQ + row;
  const int C = H * D, nKw = (K + BK - 1) / BK;
  const float scale = 1.f / sqrtf((float)D);
  int beg, end;
  split_range(starts, qt, split, splits, beg, end);

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = qi < Q ? q[(size_t)qi * C + h * D + d] * scale : 0.f;
  float m_i = -1e30f, l_i = 0.f, o[DS];
#pragma unroll
  for (int d = 0; d < DS; ++d) o[d] = 0.f;

  for (int it = beg; it < end; ++it) {
    const int kt = tiles[it], k0 = kt * BK;
    const uint64_t w = qi < Q ? bits[(size_t)qi * nKw + kt] : 0ull;
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D, kj = k0 + j;
      const size_t off = (size_t)kj * C + h * D + d;
      ks[j][d] = kj < K ? k[off] : 0.f;
      vs[j][d] = kj < K ? v[off] : 0.f;
    }
    __syncthreads();

    float s[JS];
    float mt = -1e30f;
#pragma unroll
    for (int jj = 0; jj < JS; ++jj) {
      const int j = sub + 4 * jj;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], ks[j][d], acc);
      s[jj] = acc;
      if ((w >> j) & 1ull) mt = fmaxf(mt, acc);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JS; ++jj) {
      const int j = sub + 4 * jj;
      const float p = (w >> j) & 1ull ? expf(s[jj] - m_new) : 0.f;
      ps[row][j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int d = 0; d < DS; ++d) o[d] *= alpha;
    __syncwarp();                              // a row's p lives in one warp
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = ps[row][j];
#pragma unroll
      for (int d = 0; d < DS; ++d) o[d] = fmaf(p, vs[j][sub * DS + d], o[d]);
    }
    __syncthreads();
  }
  if (qi < Q) {
    const size_t row_split = (size_t)split * Q + qi;
#pragma unroll
    for (int d = 0; d < DS; ++d)
      po[row_split * C + h * D + sub * DS + d] = o[d];
    if (sub == 0) {
      pm[row_split * H + h] = m_i;
      pl[row_split * H + h] = l_i;
    }
  }
}

// out[q, c] = sum_s e^(m_s - M) o_s / max(sum_s e^(m_s - M) l_s, 1e-20),
// M = max_s m_s, for head c / D; rows with no allowed key stay 0
template <typename T>
__global__ void merge_splits_kernel(const float* __restrict__ po,
                                    const float* __restrict__ pm,
                                    const float* __restrict__ pl,
                                    T* __restrict__ out,
                                    float* __restrict__ lse, int Q, int H,
                                    int D, int splits) {
  const int C = H * D;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)Q * C) return;
  const int qi = (int)(e / C), c = (int)(e % C), h = c / D;
  float M = -1e30f;
  for (int s = 0; s < splits; ++s)
    M = fmaxf(M, pm[((size_t)s * Q + qi) * H + h]);
  float o = 0.f, l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t r = (size_t)s * Q + qi;
    const float a = expf(pm[r * H + h] - M);
    o += a * po[r * C + c];
    l += a * pl[r * H + h];
  }
  out[e] = mv2d::from_f32<T>(o / fmaxf(l, 1e-20f));
  if (c % D == 0) lse[(size_t)qi * H + h] = l > 0.f ? M + logf(l) : kEmptyLse;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bits,
           const int* starts, const int* tiles, void* out, float* lse,
           float* po, float* pm, float* pl, int Q, int K, int H, int D,
           int splits, cudaStream_t s) {
  const dim3 grid((Q + BQ - 1) / BQ, H, splits);
  const auto* qq = static_cast<const T*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* bb = static_cast<const uint64_t*>(bits);
  switch (D) {
#define MV2D_FWD(DD)                                                       \
    case DD:                                                               \
      if constexpr (std::is_same<T, float>::value)                         \
        masked_attention_f32_kernel<DD><<<grid, NT, 0, s>>>(               \
            qq, kk, vv, bb, starts, tiles, po, pm, pl, Q, K, H, splits);   \
      else                                                                 \
        masked_attention_tc_kernel<DD><<<grid, 128, 0, s>>>(               \
            qq, kk, vv, bb, starts, tiles, po, pm, pl, Q, K, H, splits);   \
      break;
    MV2D_FWD(8)
    MV2D_FWD(16)
    MV2D_FWD(32)
#undef MV2D_FWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = (long long)Q * H * D;
  merge_splits_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      po, pm, pl, static_cast<T*>(out), lse, Q, H, D, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---- B8: the backward of the masked attention.
// With P = exp(S - lse) recomputed from the forward's per-(query, head)
// log-sum-exp and delta = rowsum(dO * O):
//   dV = P^T dO,  dS = P * (dO V^T - delta),  dK = dS^T Q s,  dQ = dS K s
// (s = 1 / sqrt(D)).  Masked pairs, and so every pair of a row with no
// allowed key, get P = 0 and give nothing.
template <typename T>
__global__ void attention_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta,
                                       long long rows, int D) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows) return;
  float acc = 0.f;
  for (int d = 0; d < D; ++d)
    acc = fmaf(mv2d::to_f32(o[e * D + d]), mv2d::to_f32(dout[e * D + d]),
               acc);
  delta[e] = acc;
}

// a query tile's Q, dO, lse, delta and mask words (the words of key tile
// kt) into one stage of the dK / dV kernel's buffers; 128 threads
template <int D>
__device__ __forceinline__ void load_query_tile(
    bf16* qs, bf16* gs, float* ls, float* dls, uint64_t* ws, const bf16* q,
    const bf16* dout, const float* lse, const float* delta,
    const uint64_t* bits, int q0, int Q, int H, int h, int nKw, int kt,
    int tid) {
  load_tile<D>(qs, q, q0, Q, H * D, h * D, tid);
  load_tile<D>(gs, dout, q0, Q, H * D, h * D, tid);
  const int r = tid & 63, i = q0 + r;
  const bool ok = i < Q;
  if (tid < 64) {
    cp_async<4>(ls + r, lse + (ok ? (size_t)i * H + h : 0), ok);
    cp_async<4>(dls + r, delta + (ok ? (size_t)i * H + h : 0), ok);
  } else {
    cp_async<8>(ws + r, bits + (ok ? (size_t)i * nKw + kt : 0), ok);
  }
}

// ---- B8, bf16, dK / dV: a block owns (64 keys, one head), warp w keys
// 16w..16w+15, and walks the key tile's list of active query tiles.  Per
// query tile, with K and V as A fragments held in registers:
//   S^T = K Q^T, P^T = exp(S^T s - lse) masked, dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q (s at the end).
template <int D>
__global__ void __launch_bounds__(128) attention_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint64_t* __restrict__ bits,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qstarts,
    const int* __restrict__ qtiles, float* __restrict__ dk,
    float* __restrict__ dv, int Q, int K, int H) {
  using T = Tc<D>;
  constexpr int LD = T::LD;
  __shared__ __align__(16) bf16 ks[T::TILE];
  __shared__ __align__(16) bf16 vs[T::TILE];
  __shared__ __align__(16) bf16 qs[2][T::TILE];
  __shared__ __align__(16) bf16 gs[2][T::TILE];
  __shared__ __align__(16) float ls[2][BQ];
  __shared__ __align__(16) float dls[2][BQ];
  __shared__ __align__(16) uint64_t ws[2][BQ];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, h = blockIdx.y;
  const int C = H * D, nKw = (K + BK - 1) / BK;
  const int beg = qstarts[kt], end = qstarts[kt + 1];
  zero_pad<D>(ks, tid);
  zero_pad<D>(vs, tid);
  for (int st = 0; st < 2; ++st) {
    zero_pad<D>(qs[st], tid);
    zero_pad<D>(gs[st], tid);
  }
  load_tile<D>(ks, k, kt * BK, K, C, h * D, tid);
  load_tile<D>(vs, v, kt * BK, K, C, h * D, tid);
  if (beg < end)
    load_query_tile<D>(qs[0], gs[0], ls[0], dls[0], ws[0], q, dout, lse,
                       delta, bits, qtiles[beg] * BQ, Q, H, h, nKw, kt,
                       tid);
  cp_async_commit();

  const float scale = 1.f / sqrtf((float)D), sl2 = scale * kLog2e;
  const int kb0 = warp * 16 + g, kb1 = kb0 + 8;   // the rows' key bits
  float dka[T::ND][4], dva[T::ND][4];
#pragma unroll
  for (int n = 0; n < T::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  uint32_t ka[T::KS][4], va[T::KS][4];

  for (int it = beg; it < end; ++it) {
    const int st = (it - beg) & 1;
    if (it + 1 < end)
      load_query_tile<D>(qs[st ^ 1], gs[st ^ 1], ls[st ^ 1], dls[st ^ 1],
                         ws[st ^ 1], q, dout, lse, delta, bits,
                         qtiles[it + 1] * BQ, Q, H, h, nKw, kt, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == beg) {
#pragma unroll
      for (int kk = 0; kk < T::KS; ++kk) {
        load_a<LD>(ka[kk], ks, warp * 16, kk * 16, lane);
        load_a<LD>(va[kk], vs, warp * 16, kk * 16, lane);
      }
    }
    // S^T and dP^T over the tile's 64 queries: 8 n-tiles each
    float sp[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < T::KS; ++kk) {
        uint32_t b0, b1;
        load_bt<LD>(b0, b1, qs[st], j * 8, kk * 16, lane);
        mma_bf16(sp[j], ka[kk], b0, b1);
        load_bt<LD>(b0, b1, gs[st], j * 8, kk * 16, lane);
        mma_bf16(dp[j], va[kk], b0, b1);
      }
    }
    // P^T and dS^T (rows: keys kb0 / kb1; columns: queries)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        const uint64_t w = ws[st][c];
        const float lc = ls[st][c] * kLog2e, dc = dls[st][c];
        const float p0 = (w >> kb0) & 1ull ? exp2f(sp[j][e] * sl2 - lc) : 0.f;
        const float p1 =
            (w >> kb1) & 1ull ? exp2f(sp[j][2 + e] * sl2 - lc) : 0.f;
        sp[j][e] = p0;
        sp[j][2 + e] = p1;
        dp[j][e] = p0 * (dp[j][e] - dc);
        dp[j][2 + e] = p1 * (dp[j][2 + e] - dc);
      }
    }
    // dV += P^T dO and dK += dS^T Q over the 64 queries: 4 k-steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = 2 * kk + x;
        pa[2 * x] = pack2(sp[j][0], sp[j][1]);
        pa[2 * x + 1] = pack2(sp[j][2], sp[j][3]);
        sa[2 * x] = pack2(dp[j][0], dp[j][1]);
        sa[2 * x + 1] = pack2(dp[j][2], dp[j][3]);
      }
#pragma unroll
      for (int n = 0; n < T::ND; ++n) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, gs[st], kk * 16, n * 8, lane);
        mma_bf16(dva[n], pa, b0, b1);
        load_b<LD>(b0, b1, qs[st], kk * 16, n * 8, lane);
        mma_bf16(dka[n], sa, b0, b1);
      }
    }
    __syncthreads();       // the next copy overwrites this stage
  }
  cp_async_wait<0>();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = kt * BK + warp * 16 + g + 8 * half;
    if (kj >= K) continue;
#pragma unroll
    for (int n = 0; n < T::ND; ++n) {
      const size_t off = (size_t)kj * C + h * D + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk + off) = make_float2(
          dka[n][2 * half] * scale, dka[n][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

// ---- B8, bf16, dQ: a block owns (64 queries, one head, one split of the
// query tile's list of active key tiles), warp w rows 16w..16w+15.  Per
// key tile, with Q and dO as A fragments held in registers:
//   S = Q K^T, P = exp(S s - lse) masked, dP = dO V^T,
//   dS = P (dP - delta), dQ += dS K (s at the end).
// The DN rows' query tiles hold every valid key tile and the others about
// half, so the list is split evenly across blocks, as K4's is: a block
// writes its split's dQ to `part` [splits, Q, H*D] (or, with one split,
// to dq), and sum_splits_kernel adds the splits in order.
template <int D>
__global__ void __launch_bounds__(128) attention_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint64_t* __restrict__ bits,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ starts,
    const int* __restrict__ tiles, float* __restrict__ dq, int Q, int K,
    int H, int splits) {
  using T = Tc<D>;
  constexpr int LD = T::LD;
  __shared__ __align__(16) bf16 qs[T::TILE];
  __shared__ __align__(16) bf16 gs[T::TILE];
  __shared__ __align__(16) bf16 ks[2][T::TILE];
  __shared__ __align__(16) bf16 vs[2][T::TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int C = H * D, nKw = (K + BK - 1) / BK;
  int beg, end;
  split_range(starts, qt, split, splits, beg, end);
  dq += (size_t)split * Q * C;
  zero_pad<D>(qs, tid);
  zero_pad<D>(gs, tid);
  for (int st = 0; st < 2; ++st) {
    zero_pad<D>(ks[st], tid);
    zero_pad<D>(vs[st], tid);
  }
  load_tile<D>(qs, q, qt * BQ, Q, C, h * D, tid);
  load_tile<D>(gs, dout, qt * BQ, Q, C, h * D, tid);
  if (beg < end) {
    load_tile<D>(ks[0], k, tiles[beg] * BK, K, C, h * D, tid);
    load_tile<D>(vs[0], v, tiles[beg] * BK, K, C, h * D, tid);
  }
  cp_async_commit();

  const float scale = 1.f / sqrtf((float)D), sl2 = scale * kLog2e;
  const int r0 = qt * BQ + warp * 16 + g, r1 = r0 + 8;
  const float lc0 = r0 < Q ? lse[(size_t)r0 * H + h] * kLog2e : 0.f;
  const float lc1 = r1 < Q ? lse[(size_t)r1 * H + h] * kLog2e : 0.f;
  const float dc0 = r0 < Q ? delta[(size_t)r0 * H + h] : 0.f;
  const float dc1 = r1 < Q ? delta[(size_t)r1 * H + h] : 0.f;
  float dqa[T::ND][4];
#pragma unroll
  for (int n = 0; n < T::ND; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  uint32_t qa[T::KS][4], ga[T::KS][4];

  for (int it = beg; it < end; ++it) {
    const int st = (it - beg) & 1, kt = tiles[it];
    const uint64_t w0 = r0 < Q ? bits[(size_t)r0 * nKw + kt] : 0ull;
    const uint64_t w1 = r1 < Q ? bits[(size_t)r1 * nKw + kt] : 0ull;
    if (it + 1 < end) {
      load_tile<D>(ks[st ^ 1], k, tiles[it + 1] * BK, K, C, h * D, tid);
      load_tile<D>(vs[st ^ 1], v, tiles[it + 1] * BK, K, C, h * D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == beg) {
#pragma unroll
      for (int kk = 0; kk < T::KS; ++kk) {
        load_a<LD>(qa[kk], qs, warp * 16, kk * 16, lane);
        load_a<LD>(ga[kk], gs, warp * 16, kk * 16, lane);
      }
    }
    // S and dP over the tile's 64 keys: 8 n-tiles each
    float sp[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < T::KS; ++kk) {
        uint32_t b0, b1;
        load_bt<LD>(b0, b1, ks[st], j * 8, kk * 16, lane);
        mma_bf16(sp[j], qa[kk], b0, b1);
        load_bt<LD>(b0, b1, vs[st], j * 8, kk * 16, lane);
        mma_bf16(dp[j], ga[kk], b0, b1);
      }
    }
    // dS (rows r0 / r1; columns: keys)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        const float p0 = (w0 >> c) & 1ull ? exp2f(sp[j][e] * sl2 - lc0) : 0.f;
        const float p1 =
            (w1 >> c) & 1ull ? exp2f(sp[j][2 + e] * sl2 - lc1) : 0.f;
        dp[j][e] = p0 * (dp[j][e] - dc0);
        dp[j][2 + e] = p1 * (dp[j][2 + e] - dc1);
      }
    }
    // dQ += dS K over the 64 keys: 4 k-steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = 2 * kk + x;
        sa[2 * x] = pack2(dp[j][0], dp[j][1]);
        sa[2 * x + 1] = pack2(dp[j][2], dp[j][3]);
      }
#pragma unroll
      for (int n = 0; n < T::ND; ++n) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, ks[st], kk * 16, n * 8, lane);
        mma_bf16(dqa[n], sa, b0, b1);
      }
    }
    __syncthreads();       // the next copy overwrites this stage
  }
  cp_async_wait<0>();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= Q) continue;
#pragma unroll
    for (int n = 0; n < T::ND; ++n)
      *reinterpret_cast<float2*>(dq + (size_t)r * C + h * D + n * 8 + 2 * t) =
          make_float2(dqa[n][2 * half] * scale, dqa[n][2 * half + 1] * scale);
  }
}

// ---- B8, float32: FMAs on the CUDA cores over the same lists.  256
// threads: a thread owns one row of the block's axis (a key for dK / dV,
// a query for dQ) and one of four groups of 16 rows of each walked tile;
// it keeps its row and sums in registers and reads the walked rows from
// shared memory 16 bytes a load.  The four groups meet at the end in
// shared memory, in group order.
constexpr int GROUP = BQ / 4;   // rows of the walked axis per thread group

// four floats of a 16-byte aligned shared row in one load
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a . b[d0..d0+4) for a float4 a
__device__ __forceinline__ float dot4(float4 a, const float* b, float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

// acc[0..4) += w * a
__device__ __forceinline__ void axpy4(float w, float4 a, float* acc) {
  acc[0] = fmaf(w, a.x, acc[0]);
  acc[1] = fmaf(w, a.y, acc[1]);
  acc[2] = fmaf(w, a.z, acc[2]);
  acc[3] = fmaf(w, a.w, acc[3]);
}

// group 0's acc[D] += groups 1, 2, 3's, in that order (row `row` of red)
template <int D>
__device__ __forceinline__ void sum_groups(float* acc, float (*red)[D + 1],
                                           int g, int row) {
  for (int src = 1; src < NT / 64; ++src) {
    if (g == src) {
#pragma unroll
      for (int d = 0; d < D; ++d) red[row][d] = acc[d];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += red[row][d];
    }
    __syncthreads();
  }
}

template <int D>
__global__ void __launch_bounds__(NT) attention_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint64_t* __restrict__ bits,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qstarts,
    const int* __restrict__ qtiles, float* __restrict__ dk,
    float* __restrict__ dv, int Q, int K, int H) {
  __shared__ __align__(16) float qs[BQ][D];     // q * scale
  __shared__ __align__(16) float gs[BQ][D];     // dO
  __shared__ float ls[BQ], dl[BQ];
  __shared__ uint64_t ws[BQ];
  __shared__ float red[BK][D + 1];
  const int tid = threadIdx.x, j = tid % BK, g = tid / BK;
  const int kt = blockIdx.x, h = blockIdx.y, kj = kt * BK + j;
  const int C = H * D, nKw = (K + BK - 1) / BK;
  const float scale = 1.f / sqrtf((float)D);
  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t off = (size_t)kj * C + h * D + d;
    kr[d] = kj < K ? k[off] : 0.f;
    vr[d] = kj < K ? v[off] : 0.f;
    dkr[d] = dvr[d] = 0.f;
  }
  for (int it = qstarts[kt]; it < qstarts[kt + 1]; ++it) {
    const int q0 = qtiles[it] * BQ;
    for (int e = tid; e < BQ * D; e += NT) {
      const int r = e / D, d = e % D, i = q0 + r;
      const size_t off = (size_t)i * C + h * D + d;
      qs[r][d] = i < Q ? q[off] * scale : 0.f;
      gs[r][d] = i < Q ? dout[off] : 0.f;
    }
    for (int r = tid; r < BQ; r += NT) {
      const int i = q0 + r;
      ls[r] = i < Q ? lse[(size_t)i * H + h] : 0.f;
      dl[r] = i < Q ? delta[(size_t)i * H + h] : 0.f;
      ws[r] = i < Q ? bits[(size_t)i * nKw + kt] : 0ull;
    }
    __syncthreads();
#pragma unroll 2
    for (int ii = 0; ii < GROUP; ++ii) {
      const int r = g * GROUP + ii;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        s = dot4(ld4(&qs[r][d]), kr + d, s);
        dp = dot4(ld4(&gs[r][d]), vr + d, dp);
      }
      const float p = (ws[r] >> j) & 1ull ? expf(s - ls[r]) : 0.f;
      const float ds = p * (dp - dl[r]);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        axpy4(p, ld4(&gs[r][d]), dvr + d);
        axpy4(ds, ld4(&qs[r][d]), dkr + d);
      }
    }
    __syncthreads();
  }
  sum_groups<D>(dkr, red, g, j);
  sum_groups<D>(dvr, red, g, j);
  if (g == 0 && kj < K) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[(size_t)kj * C + h * D + d] = dkr[d];
      dv[(size_t)kj * C + h * D + d] = dvr[d];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) attention_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint64_t* __restrict__ bits,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ starts,
    const int* __restrict__ tiles, float* __restrict__ dq, int Q, int K,
    int H) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float red[BQ][D + 1];
  const int tid = threadIdx.x, i = tid % BQ, g = tid / BQ;
  const int qt = blockIdx.x, h = blockIdx.y, qi = qt * BQ + i;
  const int C = H * D, nKw = (K + BK - 1) / BK;
  const float scale = 1.f / sqrtf((float)D);
  float qr[D], gr[D], dqr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t off = (size_t)qi * C + h * D + d;
    qr[d] = qi < Q ? q[off] * scale : 0.f;
    gr[d] = qi < Q ? dout[off] : 0.f;
    dqr[d] = 0.f;
  }
  const float li = qi < Q ? lse[(size_t)qi * H + h] : 0.f;
  const float di = qi < Q ? delta[(size_t)qi * H + h] : 0.f;
  for (int it = starts[qt]; it < starts[qt + 1]; ++it) {
    const int kt = tiles[it], k0 = kt * BK;
    const uint64_t w = qi < Q ? bits[(size_t)qi * nKw + kt] : 0ull;
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D, kj = k0 + r;
      const size_t off = (size_t)kj * C + h * D + d;
      ks[r][d] = kj < K ? k[off] : 0.f;
      vs[r][d] = kj < K ? v[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < GROUP; ++jj) {
      const int r = g * GROUP + jj;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        s = dot4(ld4(&ks[r][d]), qr + d, s);
        dp = dot4(ld4(&vs[r][d]), gr + d, dp);
      }
      const float p = (w >> r) & 1ull ? expf(s - li) : 0.f;
      const float ds = p * (dp - di);
#pragma unroll
      for (int d = 0; d < D; d += 4) axpy4(ds, ld4(&ks[r][d]), dqr + d);
    }
    __syncthreads();
  }
  sum_groups<D>(dqr, red, g, i);
  if (g == 0 && qi < Q) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      dq[(size_t)qi * C + h * D + d] = dqr[d] * scale;
  }
}

// dq[e] = sum over s of part[s][e], in split order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dq, long long n,
                                  int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = part[e];
  for (int s = 1; s < splits; ++s) acc += part[s * n + e];
  dq[e] = acc;
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* bits, const int* starts, const int* tiles,
               const int* qstarts, const int* qtiles, const void* o,
               const void* dout, const float* lse, float* delta, float* dq,
               float* part, float* dk, float* dv, int Q, int K, int H, int D,
               int splits, cudaStream_t s) {
  const auto* qq = static_cast<const T*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* bb = static_cast<const uint64_t*>(bits);
  const auto* gg = static_cast<const T*>(dout);
  const long long rows = (long long)Q * H;
  attention_delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), gg, delta, rows, D);
  const dim3 gk((K + BK - 1) / BK, H), gq((Q + BQ - 1) / BQ, H),
      gqs((Q + BQ - 1) / BQ, H, splits);
  float* dq_out = splits > 1 ? part : dq;
  switch (D) {
#define MV2D_BWD(DD)                                                      \
    case DD:                                                              \
      if constexpr (std::is_same<T, float>::value) {                      \
        attention_dkdv_f32_kernel<DD><<<gk, NT, 0, s>>>(                  \
            qq, kk, vv, bb, gg, lse, delta, qstarts, qtiles, dk, dv, Q,   \
            K, H);                                                        \
        attention_dq_f32_kernel<DD><<<gq, NT, 0, s>>>(                    \
            qq, kk, vv, bb, gg, lse, delta, starts, tiles, dq, Q, K, H);  \
      } else {                                                            \
        attention_dkdv_tc_kernel<DD><<<gk, 128, 0, s>>>(                  \
            qq, kk, vv, bb, gg, lse, delta, qstarts, qtiles, dk, dv, Q,   \
            K, H);                                                        \
        attention_dq_tc_kernel<DD><<<gqs, 128, 0, s>>>(                   \
            qq, kk, vv, bb, gg, lse, delta, starts, tiles, dq_out, Q, K, H, \
            splits);                                                      \
      }                                                                   \
      break;
    MV2D_BWD(8)
    MV2D_BWD(16)
    MV2D_BWD(32)
#undef MV2D_BWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!std::is_same<T, float>::value && splits > 1) {
    const long long n = (long long)Q * H * D;
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        part, dq, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bits [Q, ceil(K/64)] uint64 (written as uint32 halves) from mask [Q, K]
// bool: bit j of word t = mask[q, 64t + j], 0 past K
extern "C" int mv2d_mask_bits(const void* mask, void* bits, int Q, int K,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int nKw = (K + BK - 1) / BK;
  const long long n = (long long)Q * nKw * 64;
  if (n > 0)
    mask_bits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const uint8_t*>(mask), static_cast<uint32_t*>(bits), Q,
        K, nKw);
  return static_cast<int>(cudaGetLastError());
}

// bits from mv2d_mask_bits; starts [nQ + 1] / tiles int32: the CSR list of
// active key tiles (64 x 64) per query tile; po [splits, Q, H*D], pm / pl
// [splits, Q, H]: float32 scratch; lse [Q, H] float32: each row's
// log-sum-exp of its scaled allowed logits, kEmptyLse for a row with no
// allowed key
extern "C" int mv2d_masked_attention(const void* q, const void* k,
                                     const void* v, const void* bits,
                                     const void* starts, const void* tiles,
                                     void* out, void* lse, void* po,
                                     void* pm, void* pl, int Q, int K, int H,
                                     int D, int splits, int dtype,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int*>(starts);
  const auto* tl = static_cast<const int*>(tiles);
  auto* fo = static_cast<float*>(po);
  auto* fm = static_cast<float*>(pm);
  auto* fl = static_cast<float*>(pl);
  auto* fs = static_cast<float*>(lse);
  MV2D_DISPATCH(dtype, T, {
    return launch<T>(q, k, v, bits, st, tl, out, fs, fo, fm, fl, Q, K, H, D,
                     splits, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// o, dout [Q, H*D] (dtype), lse [Q, H] from the forward; bits and the two
// CSR lists (key tiles per query tile, query tiles per key tile) of the
// mask; delta [Q, H] float32 scratch; dq [Q, H*D], dk / dv [K, H*D]
// float32, every element written; part [splits, Q, H*D] float32 scratch
// of the bfloat16 dQ kernel's splits (unused with one split, and by the
// float32 body, which takes no split)
extern "C" int mv2d_masked_attention_bwd(
    const void* q, const void* k, const void* v, const void* bits,
    const void* starts, const void* tiles, const void* qstarts,
    const void* qtiles, const void* o, const void* dout, const void* lse,
    void* delta, void* dq, void* part, void* dk, void* dv, int Q, int K,
    int H, int D, int splits, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int*>(starts);
  const auto* tl = static_cast<const int*>(tiles);
  const auto* qst = static_cast<const int*>(qstarts);
  const auto* qtl = static_cast<const int*>(qtiles);
  const auto* fs = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  auto* fq = static_cast<float*>(dq);
  auto* fp = static_cast<float*>(part);
  auto* fk = static_cast<float*>(dk);
  auto* fv = static_cast<float*>(dv);
  MV2D_DISPATCH(dtype, T, {
    return launch_bwd<T>(q, k, v, bits, st, tl, qst, qtl, o, dout, fs, fd,
                         fq, fp, fk, fv, Q, K, H, D, splits, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
