// Kernel K4: block-sparse masked multi-head attention, forward.
//   out[q, h] = sum_k softmax_k(q_h . k_h / sqrt(D) | allowed[q, k]) v_h[k]
// Rows with no allowed key give zeros (mv2d_tpu/ops/attention.py
// masked_softmax semantics).  A second output, each (query, head)'s
// log-sum-exp of its allowed scaled logits, feeds the backward (B8 below).
//
// Replaces mv2d_tpu/ops/pallas_attention.py: masked_flash_attention
// (sparse=True -> _flash_sparse -> _sparse_fwd_call -> _sparse_kernel) and,
// with the log-sum-exp, the training forward (sparse=False -> _flash ->
// _fwd_call -> _kernel): the same function, and skipping an empty tile is
// exact.
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
// log-sum-exp flag of a row with no allowed key: exp(s - kEmptyLse) = 0
constexpr float kEmptyLse = 1e30f;

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
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, float* lse, float* po, float* pm, float* pl, int Q,
           int K, int H, int D, int splits, cudaStream_t s) {
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
      po, pm, pl, static_cast<T*>(out), lse, Q, H, D, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---- B8: the backward of the masked attention.
// Replaces mv2d_tpu/ops/pallas_attention.py: _flash_bwd (_bwd_kernel),
// the custom VJP of masked_flash_attention(sparse=False), which the
// training path runs.  With P = exp(S - lse) recomputed from the forward's
// per-(query, head) log-sum-exp and delta = rowsum(dO * O):
//   dV = P^T dO,  dS = P * (dO V^T - delta),  dK = dS^T Q s,  dQ = dS K s
// (s = 1 / sqrt(D)).  Masked pairs, and so every pair of a row with no
// allowed key, get P = 0 and give nothing.
//
// What bounds it on the H100: for the training cross-attention (2628
// queries, 16384 keys, 8 heads of 32, DN rows dense) the products, ~5
// float32 FMAs of length D per allowed (query, key, head), done here on
// the CUDA cores; the mask is one byte per (query, key) read per head.
// Simple form: one kernel where a block owns (64 keys, one head) and walks
// the query tiles for dK / dV, one where a block owns (64 queries, one
// head) and walks the key tiles for dQ; both skip mask tiles that are
// empty.  A thread keeps its key (or query) row, and its dK / dV (or dQ)
// sums, in registers, and reads the walked rows from shared memory 16
// bytes a load; the four thread groups that share a row split the other
// axis and meet in float32 vector atomics into zeroed float32 outputs.
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

template <typename T, int D>
__global__ void __launch_bounds__(NT) attention_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int Q, int K, int H) {
  using mv2d::to_f32;
  __shared__ __align__(16) float qs[BQ][D];     // q * scale
  __shared__ __align__(16) float gs[BQ][D];     // dO
  __shared__ float ls[BQ], dl[BQ];
  const int tid = threadIdx.x, j = tid % BK, g = tid / BK;
  const int h = blockIdx.y, kj = blockIdx.x * BK + j;
  const int C = H * D;
  const float scale = 1.f / sqrtf((float)D);
  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t off = (size_t)kj * C + h * D + d;
    kr[d] = kj < K ? to_f32(k[off]) : 0.f;
    vr[d] = kj < K ? to_f32(v[off]) : 0.f;
    dkr[d] = dvr[d] = 0.f;
  }
  for (int q0 = 0; q0 < Q; q0 += BQ) {
    unsigned bits = 0;
    if (kj < K) {
#pragma unroll
      for (int ii = 0; ii < GROUP; ++ii) {
        const int i = q0 + g * GROUP + ii;
        if (i < Q && mask[(size_t)i * K + kj]) bits |= 1u << ii;
      }
    }
    if (!__syncthreads_or(bits != 0)) continue;   // empty mask tile
    for (int e = tid; e < BQ * D; e += NT) {
      const int r = e / D, d = e % D, i = q0 + r;
      const size_t off = (size_t)i * C + h * D + d;
      qs[r][d] = i < Q ? to_f32(q[off]) * scale : 0.f;
      gs[r][d] = i < Q ? to_f32(dout[off]) : 0.f;
    }
    for (int r = tid; r < BQ; r += NT) {
      const int i = q0 + r;
      ls[r] = i < Q ? lse[(size_t)i * H + h] : 0.f;
      dl[r] = i < Q ? delta[(size_t)i * H + h] : 0.f;
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
      const float p = (bits >> ii) & 1u ? expf(s - ls[r]) : 0.f;
      const float ds = p * (dp - dl[r]);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        axpy4(p, ld4(&gs[r][d]), dvr + d);
        axpy4(ds, ld4(&qs[r][d]), dkr + d);
      }
    }
    __syncthreads();
  }
  if (kj < K) {
    mv2d::atomic_add<D>(dk + (size_t)kj * C + h * D, dkr);
    mv2d::atomic_add<D>(dv + (size_t)kj * C + h * D, dvr);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attention_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Q, int K,
    int H) {
  using mv2d::to_f32;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  const int tid = threadIdx.x, i = tid % BQ, g = tid / BQ;
  const int h = blockIdx.y, qi = blockIdx.x * BQ + i;
  const int C = H * D;
  const float scale = 1.f / sqrtf((float)D);
  float qr[D], gr[D], dqr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t off = (size_t)qi * C + h * D + d;
    qr[d] = qi < Q ? to_f32(q[off]) * scale : 0.f;
    gr[d] = qi < Q ? to_f32(dout[off]) : 0.f;
    dqr[d] = 0.f;
  }
  const float li = qi < Q ? lse[(size_t)qi * H + h] : 0.f;
  const float di = qi < Q ? delta[(size_t)qi * H + h] : 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    unsigned bits = 0;
    if (qi < Q) {
      const uint8_t* mrow = mask + (size_t)qi * K;
#pragma unroll
      for (int jj = 0; jj < GROUP; ++jj) {
        const int kj = k0 + g * GROUP + jj;
        if (kj < K && mrow[kj]) bits |= 1u << jj;
      }
    }
    if (!__syncthreads_or(bits != 0)) continue;   // empty mask tile
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D, kj = k0 + r;
      const size_t off = (size_t)kj * C + h * D + d;
      ks[r][d] = kj < K ? to_f32(k[off]) : 0.f;
      vs[r][d] = kj < K ? to_f32(v[off]) : 0.f;
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
      const float p = (bits >> jj) & 1u ? expf(s - li) : 0.f;
      const float ds = p * (dp - di);
#pragma unroll
      for (int d = 0; d < D; d += 4) axpy4(ds, ld4(&ks[r][d]), dqr + d);
    }
    __syncthreads();
  }
  if (qi < Q) {
#pragma unroll
    for (int d = 0; d < D; ++d) dqr[d] *= scale;
    mv2d::atomic_add<D>(dq + (size_t)qi * C + h * D, dqr);
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* mask, const void* o, const void* dout,
               const float* lse, float* delta, float* dq, float* dk,
               float* dv, int Q, int K, int H, int D, cudaStream_t s) {
  const auto* qq = static_cast<const T*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* mm = static_cast<const uint8_t*>(mask);
  const auto* gg = static_cast<const T*>(dout);
  const long long rows = (long long)Q * H;
  attention_delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), gg, delta, rows, D);
  const dim3 gk((K + BK - 1) / BK, H), gq((Q + BQ - 1) / BQ, H);
  switch (D) {
#define MV2D_BWD(DD)                                                      \
    case DD:                                                              \
      attention_dkdv_kernel<T, DD><<<gk, NT, 0, s>>>(                     \
          qq, kk, vv, mm, gg, lse, delta, dk, dv, Q, K, H);               \
      attention_dq_kernel<T, DD><<<gq, NT, 0, s>>>(                       \
          qq, kk, vv, mm, gg, lse, delta, dq, Q, K, H);                   \
      break;
    MV2D_BWD(8)
    MV2D_BWD(16)
    MV2D_BWD(32)
#undef MV2D_BWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- B14: the block-sparse single-pass backward.
// Replaces mv2d_tpu/ops/pallas_attention.py: _flash_sparse_bwd
// (_sparse_bwd_kernel), the backward of the MV2D_FLASH_SPARSE=1 attention:
// per (query tile, head) one pass over the compacted list of key tiles that
// hold any allowed pair (JAX's _sparse_blocks; here in CSR form, built by
// the wrapper), P recomputed once per active tile from the forward's
// log-sum-exp, delta = rowsum(dO * O) from B8's delta kernel:
//   dS = P * (dO V^T - delta);  dQ = dS K s;  dK = dS^T Q s;  dV = P^T dO
// (s = 1 / sqrt(D)).  A row with no allowed key has P = 0.
//
// What bounds it on the H100: the same products as B8 (float32 FMAs on the
// CUDA cores), here in one kernel instead of two, so P and dP are
// recomputed once per active (query tile, key tile, head) instead of
// twice.  A block owns (64 queries, one head); four threads share a query
// row (16 keys of each tile) and keep its q, dO and dQ in registers, so dQ
// is accumulated on the chip and written once.  Per tile, P and dS go to
// shared memory, then each thread owns (key, D/4 columns) of the tile's dK
// and dV, sums them over the 64 queries and adds them to the float32
// outputs with vector atomics: the key tiles of the 960 dense DN rows and
// of the near-dense self-attention take atomics from every query tile.
template <int N>
__device__ __forceinline__ void atomic_add_n(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
    mv2d::atomic_add<N>(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) atomicAdd(p + i, v[i]);
  }
}

template <int D>
constexpr int sparse_bwd_smem_bytes() {
  return (2 * BQ * D + 2 * BK * (D + 1) + 2 * BQ * (BK + 1)) * 4 + BQ * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attention_sparse_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ starts,
    const int* __restrict__ tiles, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, int Q, int K, int H) {
  using mv2d::to_f32;
  constexpr int DS = D / 4;            // columns per thread
  constexpr int JS = BK / 4;           // keys per thread per tile
  constexpr int KS = D + 1, PS = BK + 1;
  extern __shared__ float sm[];
  float* qs = sm;                      // [BQ][D] q * scale
  float* gs = qs + BQ * D;             // [BQ][D] dO
  float* ks = gs + BQ * D;             // [BK][KS]
  float* vs = ks + BK * KS;            // [BK][KS]
  float* ps = vs + BK * KS;            // [BQ][PS] P
  float* dss = ps + BQ * PS;           // [BQ][PS] dS
  uint8_t* ms = reinterpret_cast<uint8_t*>(dss + BQ * PS);   // [BQ][BK]
  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int h = blockIdx.y, qt = blockIdx.x, q0 = qt * BQ, qi = q0 + row;
  const int C = H * D;
  const float scale = 1.f / sqrtf((float)D);

  float qr[D], gr[D], dqr[DS];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t off = (size_t)qi * C + h * D + d;
    qr[d] = qi < Q ? to_f32(q[off]) * scale : 0.f;
    gr[d] = qi < Q ? to_f32(dout[off]) : 0.f;
  }
#pragma unroll
  for (int d = 0; d < DS; ++d) dqr[d] = 0.f;
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D, i = q0 + r;
    const size_t off = (size_t)i * C + h * D + d;
    qs[e] = i < Q ? to_f32(q[off]) * scale : 0.f;
    gs[e] = i < Q ? to_f32(dout[off]) : 0.f;
  }
  const float li = qi < Q ? lse[(size_t)qi * H + h] : 0.f;
  const float di = qi < Q ? delta[(size_t)qi * H + h] : 0.f;
  const int jk = tid / 4;              // key of this thread's dK / dV share
  for (int s = starts[qt]; s < starts[qt + 1]; ++s) {
    const int k0 = tiles[s] * BK;
    for (int e = tid; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      ms[e] = (q0 + r < Q && k0 + c < K) ? mask[(size_t)(q0 + r) * K + k0 + c]
                                         : 0;
    }
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D, kj = k0 + j;
      const size_t off = (size_t)kj * C + h * D + d;
      ks[j * KS + d] = kj < K ? to_f32(k[off]) : 0.f;
      vs[j * KS + d] = kj < K ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < JS; ++jj) {
      const int j = sub + 4 * jj;
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sc = fmaf(qr[d], ks[j * KS + d], sc);
        dp = fmaf(gr[d], vs[j * KS + d], dp);
      }
      const float p = ms[row * BK + j] ? expf(sc - li) : 0.f;
      ps[row * PS + j] = p;
      dss[row * PS + j] = p * (dp - di);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float w = dss[row * PS + j];
#pragma unroll
      for (int d = 0; d < DS; ++d)
        dqr[d] = fmaf(w, ks[j * KS + sub * DS + d], dqr[d]);
    }
    float dkr[DS], dvr[DS];
#pragma unroll
    for (int d = 0; d < DS; ++d) dkr[d] = dvr[d] = 0.f;
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      const float a = dss[i * PS + jk], b = ps[i * PS + jk];
#pragma unroll
      for (int d = 0; d < DS; ++d) {
        dkr[d] = fmaf(a, qs[i * D + sub * DS + d], dkr[d]);
        dvr[d] = fmaf(b, gs[i * D + sub * DS + d], dvr[d]);
      }
    }
    bool any = false;
#pragma unroll
    for (int d = 0; d < DS; ++d) any |= dkr[d] != 0.f || dvr[d] != 0.f;
    if (k0 + jk < K && any) {        // a key no row of the tile attends: 0
      const size_t off = (size_t)(k0 + jk) * C + h * D + sub * DS;
      atomic_add_n<DS>(dk + off, dkr);
      atomic_add_n<DS>(dv + off, dvr);
    }
    __syncthreads();
  }
  if (qi < Q) {
#pragma unroll
    for (int d = 0; d < DS; ++d)
      dq[(size_t)qi * C + h * D + sub * DS + d] = dqr[d] * scale;
  }
}

template <typename T>
int launch_sparse_bwd(const void* q, const void* k, const void* v,
                      const void* mask, const void* o, const void* dout,
                      const float* lse, float* delta, const int* starts,
                      const int* tiles, float* dq, float* dk, float* dv,
                      int Q, int K, int H, int D, cudaStream_t s) {
  const auto* qq = static_cast<const T*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* mm = static_cast<const uint8_t*>(mask);
  const auto* gg = static_cast<const T*>(dout);
  const long long rows = (long long)Q * H;
  attention_delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), gg, delta, rows, D);
  const dim3 grid((Q + BQ - 1) / BQ, H);
  switch (D) {
#define MV2D_SPARSE_BWD(DD)                                                \
    case DD: {                                                             \
      constexpr int smem = sparse_bwd_smem_bytes<DD>();                    \
      cudaFuncSetAttribute(attention_sparse_bwd_kernel<T, DD>,             \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                           smem);                                          \
      attention_sparse_bwd_kernel<T, DD><<<grid, NT, smem, s>>>(           \
          qq, kk, vv, mm, gg, lse, delta, starts, tiles, dq, dk, dv, Q, K, \
          H);                                                              \
      break;                                                               \
    }
    MV2D_SPARSE_BWD(8)
    MV2D_SPARSE_BWD(16)
    MV2D_SPARSE_BWD(32)
#undef MV2D_SPARSE_BWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// po [splits, Q, H*D], pm / pl [splits, Q, H]: float32 scratch;
// lse [Q, H] float32: each row's log-sum-exp of its scaled allowed
// logits, kEmptyLse for a row with no allowed key
extern "C" int mv2d_masked_attention(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, void* lse, void* po, void* pm,
                                     void* pl, int Q, int K, int H, int D,
                                     int splits, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* fo = static_cast<float*>(po);
  auto* fm = static_cast<float*>(pm);
  auto* fl = static_cast<float*>(pl);
  auto* fs = static_cast<float*>(lse);
  MV2D_DISPATCH(dtype, T, {
    return launch<T>(q, k, v, mask, out, fs, fo, fm, fl, Q, K, H, D, splits,
                     s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// o, dout [Q, H*D] (dtype), lse [Q, H] from the forward; delta [Q, H]
// float32 scratch; dq [Q, H*D], dk / dv [K, H*D] float32, zeroed by the
// caller and accumulated
extern "C" int mv2d_masked_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* o, const void* dout, const void* lse, void* delta, void* dq,
    void* dk, void* dv, int Q, int K, int H, int D, int dtype,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* fs = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  auto* fq = static_cast<float*>(dq);
  auto* fk = static_cast<float*>(dk);
  auto* fv = static_cast<float*>(dv);
  MV2D_DISPATCH(dtype, T, {
    return launch_bwd<T>(q, k, v, mask, o, dout, fs, fd, fq, fk, fv, Q, K,
                         H, D, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// B14: starts [nQ + 1] / tiles int32, the CSR list of active key tiles
// (64 x 64) per query tile; dq [Q, H*D] float32 written, dk / dv [K, H*D]
// float32 zeroed by the caller and accumulated; delta [Q, H] scratch
extern "C" int mv2d_masked_attention_sparse_bwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* o, const void* dout, const void* lse, void* delta,
    const void* starts, const void* tiles, void* dq, void* dk, void* dv,
    int Q, int K, int H, int D, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* fs = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  const auto* st = static_cast<const int*>(starts);
  const auto* tl = static_cast<const int*>(tiles);
  auto* fq = static_cast<float*>(dq);
  auto* fk = static_cast<float*>(dk);
  auto* fv = static_cast<float*>(dv);
  MV2D_DISPATCH(dtype, T, {
    return launch_sparse_bwd<T>(q, k, v, mask, o, dout, fs, fd, st, tl, fq,
                                fk, fv, Q, K, H, D, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
