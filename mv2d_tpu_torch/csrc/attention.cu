// Kernel K4: block-sparse masked multi-head attention, forward.
//   out[q, h] = sum_k softmax_k(q_h . k_h / sqrt(D) | allowed[q, k]) v_h[k]
// Rows with no allowed key give zeros (mv2d_tpu/ops/attention.py
// masked_softmax semantics).
//
// Replaces mv2d_tpu/ops/pallas_attention.py: masked_flash_attention
// (sparse=True -> _flash_sparse -> _sparse_fwd_call -> _sparse_kernel).
// The TPU kernel prefetched per-q-block lists of active key blocks; here
// each block checks its own mask tile and skips it when empty.
//
// What bounds it on the H100: for the decoder's cross-attention (Q ~ 900,
// K = 16384, 8 heads of 32) the dense [H, Q, K] float32 logits are ~470 MB
// written and read back; the mask is ~3% dense per element but ~50% dense
// in 64x64 tiles.  A block owns (64 queries, one head) and walks 64-key
// tiles with an online softmax, so logits never reach device memory, and
// skips every tile whose mask is empty (one byte per (q, k) read per
// head).  A (64-query, head) grid alone is 120 blocks for 132 SMs, so the
// keys are also split across blocks (flash-decoding): each block writes its
// split's unnormalised output and row max / sum, and a second kernel merges
// the splits.  Four threads share a query row (16 logits and D/4 output
// columns each, row statistics combined with warp shuffles); products are
// float32 FMAs.  (A tensor-core variant without the key split measured
// slower than this one did without it: parallelism and the per-tile mask
// reads bound it, not the products.)
#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;

template <typename T, int D>
__global__ void __launch_bounds__(NT) masked_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ mask,
    float* __restrict__ po, float* __restrict__ pm, float* __restrict__ pl,
    int Q, int K, int H, int keys_per_split) {
  using mv2d::to_f32;
  constexpr int DS = D / 4;            // output columns per thread
  constexpr int JS = BK / 4;           // logits per thread per tile
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[BQ][BK + 1];
  __shared__ uint8_t ms[BQ][BK];
  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int h = blockIdx.y, q0 = blockIdx.x * BQ, qi = q0 + row;
  const int C = H * D;
  const float scale = 1.f / sqrtf((float)D);

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = qi < Q ? to_f32(q[(size_t)qi * C + h * D + d]) * scale : 0.f;
  float m_i = -1e30f, l_i = 0.f, o[DS];
#pragma unroll
  for (int d = 0; d < DS; ++d) o[d] = 0.f;

  const int split = blockIdx.z;
  const int kbeg = split * keys_per_split;
  const int kend = min(K, kbeg + keys_per_split);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    int any = 0;
    for (int e = tid; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const uint8_t mv = (q0 + r < Q && k0 + c < kend)
                             ? mask[(size_t)(q0 + r) * K + k0 + c]
                             : 0;
      ms[r][c] = mv;
      any |= mv;
    }
    if (!__syncthreads_or(any)) continue;    // empty mask tile: skip
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D, kj = k0 + j;
      const size_t off = (size_t)kj * C + h * D + d;
      ks[j][d] = kj < kend ? to_f32(k[off]) : 0.f;
      vs[j][d] = kj < kend ? to_f32(v[off]) : 0.f;
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
      if (ms[row][j]) mt = fmaxf(mt, acc);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JS; ++jj) {
      const int j = sub + 4 * jj;
      const float p = ms[row][j] ? expf(s[jj] - m_new) : 0.f;
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
                                    T* __restrict__ out, int Q, int H, int D,
                                    int splits) {
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
}


template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, float* po, float* pm, float* pl, int Q, int K, int H,
           int D, int splits, cudaStream_t s) {
  const int tiles = (K + BK - 1) / BK;
  const int keys_per_split = ((tiles + splits - 1) / splits) * BK;
  const dim3 grid((Q + BQ - 1) / BQ, H, splits);
  const auto* qq = static_cast<const T*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* mm = static_cast<const uint8_t*>(mask);
  switch (D) {
    case 8: masked_attention_kernel<T, 8><<<grid, NT, 0, s>>>(qq, kk, vv, mm, po, pm, pl, Q, K, H, keys_per_split); break;
    case 16: masked_attention_kernel<T, 16><<<grid, NT, 0, s>>>(qq, kk, vv, mm, po, pm, pl, Q, K, H, keys_per_split); break;
    case 32: masked_attention_kernel<T, 32><<<grid, NT, 0, s>>>(qq, kk, vv, mm, po, pm, pl, Q, K, H, keys_per_split); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = (long long)Q * H * D;
  merge_splits_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      po, pm, pl, static_cast<T*>(out), Q, H, D, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// po [splits, Q, H*D], pm / pl [splits, Q, H]: float32 scratch
extern "C" int mv2d_masked_attention(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, void* po, void* pm, void* pl,
                                     int Q, int K, int H, int D, int splits,
                                     int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* fo = static_cast<float*>(po);
  auto* fm = static_cast<float*>(pm);
  auto* fl = static_cast<float*>(pl);
  MV2D_DISPATCH(dtype, T, {
    return launch<T>(q, k, v, mask, out, fo, fm, fl, Q, K, H, D, splits, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
