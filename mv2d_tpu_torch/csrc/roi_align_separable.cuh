// The separable RoIAlign core shared by kernels B11 (roi_align_slab.cu) and
// B12 (roi_align_patch.cu): one RoI's 7x7 output for one 64-channel chunk,
// evaluated from the RoI's footprint on its routed level (mmcv
// aligned=True, mmdet level routing on finest_scale 56).
//
// The sampling weights of a RoI factor per axis: with the averaged
// bilinear hat profiles Ay [7, rows] and Ax [7, cols] of the footprint,
//   out[i, j, c] = sum_x Ax[j, x] sum_y Ay[i, y] F[y, x, c].
// The block builds both profiles in shared memory, then walks the
// footprint in tiles of XT columns:
//   1. a thread owns (column, 16-byte channel group) and streams the
//      tile's rows through a ring of STAGES 16-byte cp.async copies of
//      its own cells, accumulating tmp[i] += Ay[i, y] * F[y, x] in
//      registers (the first contraction, tmp = Ay . patch);
//   2. tmp [7, XT, 64] goes to shared memory in float32, and a thread
//      owns (bin, channel group) items, accumulating
//      out[i, j] += Ax[j, x] * tmp[i, x] (the second contraction) in
//      registers across the tiles.
// So every footprint cell is read from device memory (or L2) once per
// RoI and channel, in 16-byte runs along the channels of the
// channels-last map, where K3 reads four corners per bilinear sample.
// Channels are split across blocks (64 a block), since a whole patch
// (e.g. 64 x 72 cells at C 256 in bf16, 2.36 MB) is far beyond a
// block's 227 KB of shared memory; the columns are tiled, and the rows
// are streamed, so any footprint up to a whole level fits.
//
// Sampling: `ns` samples per bin and axis at (s + 0.5) / div of the bin;
// adaptive (sampling_ratio <= 0): ns = ceil(bin), div = max(ns, 1), no
// cap (ns = 0 gives a zero output); fixed: ns = div = sampling_ratio.
// Samples outside (-1, n) weigh nothing; inside they clamp to [0, n - 1].
// Levels up to MAXF cells a side.  Every kernel accumulates in float32.
#pragma once

#include "common.cuh"

namespace mv2d_sep {

constexpr int O = 7;           // output bins a side
constexpr int NT = 256;        // threads a block
constexpr int CS = 64;         // channels a block
constexpr int STAGES = 4;      // rows a thread has in flight
constexpr int MAXF = 512;      // cells a level side

struct Levels {
  const void* f[4];
  int H[4], W[4];
  float scale[4];
};

template <typename T>
struct Tiling {
  static constexpr int VW = 16 / sizeof(T);           // channels a load
  static constexpr int G = CS / VW;                   // channel groups
  static constexpr int XT = NT / G;                   // columns a tile
  static constexpr int ITEMS = (O * O * G + NT - 1) / NT;
  static constexpr size_t RING = (size_t)STAGES * NT * 16;
  static constexpr size_t PROFILE = (size_t)O * MAXF * sizeof(float);
  static constexpr size_t SMEM = RING + 2 * PROFILE +
                                 (size_t)O * XT * CS * sizeof(float);
};

// One RoI at its routed level, in that level's cells.
struct Geometry {
  int lvl;
  float y1, x1, bh, bw;        // aligned origin and bin size per axis
  int ny, nx;                  // samples a bin, per axis
  float divy, divx;
};

__device__ __forceinline__ int route(float bx1, float by1, float bx2,
                                     float by2) {
  const float area = fmaxf((bx2 - bx1) * (by2 - by1), 0.f);
  const float lv = floorf(log2f(sqrtf(area) / 56.f + 1e-6f));
  return (int)fminf(fmaxf(lv, 0.f), 3.f);
}

__device__ __forceinline__ Geometry geometry(const Levels& L,
                                             const float* box, int S) {
  Geometry g;
  g.lvl = route(box[0], box[1], box[2], box[3]);
  const float sc = L.scale[g.lvl];
  g.x1 = box[0] * sc - 0.5f;
  g.y1 = box[1] * sc - 0.5f;
  g.bw = (box[2] - box[0]) * sc / O;
  g.bh = (box[3] - box[1]) * sc / O;
  if (S > 0) {
    g.nx = g.ny = S;
    g.divx = g.divy = (float)S;
  } else {
    g.nx = (int)fmaxf(ceilf(g.bw), 0.f);
    g.ny = (int)fmaxf(ceilf(g.bh), 0.f);
    g.divx = fmaxf((float)g.nx, 1.f);
    g.divy = fmaxf((float)g.ny, 1.f);
  }
  return g;
}

__device__ __forceinline__ float sample_at(float lo, float bin, float div,
                                           int i, int s) {
  return lo + ((float)i + ((float)s + 0.5f) / div) * bin;
}

// [lo, hi]: the cells that the clamped samples of one axis can touch
// (samples are monotone in (bin, sample)).
__device__ __forceinline__ void axis_range(float lo0, float bin, int ns,
                                           float div, int n, int* lo,
                                           int* hi) {
  const float a = sample_at(lo0, bin, div, 0, 0);
  const float b = sample_at(lo0, bin, div, O - 1, ns - 1);
  const float top = (float)(n - 1);
  const float mn = fminf(fmaxf(fminf(a, b), 0.f), top);
  const float mx = fminf(fmaxf(fmaxf(a, b), 0.f), top);
  *lo = (int)floorf(mn);
  *hi = min((int)floorf(mx) + 1, n - 1);
}

// w[i * MAXF + (cell - lo)] for cell in [lo, lo + span): the averaged
// bilinear hats of bin i's samples, summed in sample order (no atomics, so
// the result does not depend on the threads' timing)
__device__ __forceinline__ void axis_profile(float* w, int lo, int span,
                                             float lo0, float bin, int ns,
                                             float div, int n) {
  for (int e = threadIdx.x; e < O * span; e += blockDim.x) {
    const int i = e / span, cell = lo + e % span;
    float acc = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float xx = sample_at(lo0, bin, div, i, s);
      if (!(xx > -1.f && xx < n)) continue;
      const float xc = fminf(fmaxf(xx, 0.f), (float)(n - 1));
      acc += fmaxf(1.f - fabsf(xc - (float)cell), 0.f);
    }
    w[i * MAXF + e % span] = acc / div;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* v) {
  constexpr int VW = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VW; ++j) v[j] = mv2d::to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v) {
  constexpr int VW = 16 / sizeof(T);
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VW; ++j) e[j] = mv2d::from_f32<T>(v[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// One RoI, channels [c0, c0 + 64) of its output out [7, 7, C].  Every
// thread of the block calls it (it synchronises the block); `smem` holds
// Tiling<T>::SMEM bytes.
template <typename T>
__device__ void align_roi(const Levels& L, const Geometry& g, int view,
                          T* __restrict__ out, int C, int c0,
                          unsigned char* smem) {
  using TL = Tiling<T>;
  constexpr int VW = TL::VW, G = TL::G, XT = TL::XT, ITEMS = TL::ITEMS;
  const int t = threadIdx.x;
  float acc[ITEMS][VW];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int k = 0; k < VW; ++k) acc[it][k] = 0.f;

  if (g.ny > 0 && g.nx > 0) {
    uint4* ring = reinterpret_cast<uint4*>(smem);
    float* wy = reinterpret_cast<float*>(smem + TL::RING);
    float* wx = wy + O * MAXF;
    float* tmp = wx + O * MAXF;
    const int H = L.H[g.lvl], W = L.W[g.lvl];
    const T* f = static_cast<const T*>(L.f[g.lvl]) +
                 (size_t)view * H * W * C;
    int ylo, yhi, xlo, xhi;
    axis_range(g.y1, g.bh, g.ny, g.divy, H, &ylo, &yhi);
    axis_range(g.x1, g.bw, g.nx, g.divx, W, &xlo, &xhi);
    const int sy = yhi - ylo + 1, sx = xhi - xlo + 1;
    axis_profile(wy, ylo, sy, g.y1, g.bh, g.ny, g.divy, H);
    axis_profile(wx, xlo, sx, g.x1, g.bw, g.nx, g.divx, W);
    __syncthreads();

    const int grp = t % G, xl = t / G;
    const int c = c0 + grp * VW;
    const size_t rstride = (size_t)W * C;
    for (int x0 = xlo; x0 <= xhi; x0 += XT) {
      // ---- tmp[i, x] = sum_y Ay[i, y] F[y, x], rows streamed by cp.async
      const int x = x0 + xl;
      const bool act = c < C && x <= xhi;
      const T* src = f + ((size_t)ylo * W + (act ? x : 0)) * C +
                     (act ? c : 0);
      float tm[O][VW];
#pragma unroll
      for (int i = 0; i < O; ++i)
#pragma unroll
        for (int k = 0; k < VW; ++k) tm[i][k] = 0.f;
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (act && s < sy) cp_async16(&ring[s * NT + t], src + s * rstride);
        cp_async_commit();
      }
      for (int k = 0; k < sy; ++k) {
        const int kn = k + STAGES - 1;
        if (act && kn < sy)
          cp_async16(&ring[(kn % STAGES) * NT + t], src + kn * rstride);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        if (act) {
          float v[VW];
          unpack<T>(ring[(k % STAGES) * NT + t], v);
#pragma unroll
          for (int i = 0; i < O; ++i) {
            const float w = wy[i * MAXF + k];
#pragma unroll
            for (int j = 0; j < VW; ++j) tm[i][j] = fmaf(w, v[j], tm[i][j]);
          }
        }
      }
      cp_async_wait<0>();
      if (act) {
#pragma unroll
        for (int i = 0; i < O; ++i)
#pragma unroll
          for (int j = 0; j < VW; j += 4)
            *reinterpret_cast<float4*>(
                &tmp[(i * XT + xl) * CS + grp * VW + j]) =
                make_float4(tm[i][j], tm[i][j + 1], tm[i][j + 2],
                            tm[i][j + 3]);
      }
      __syncthreads();
      // ---- out[i, j] += sum_x Ax[j, x] tmp[i, x]
      const int nt = min(XT, xhi - x0 + 1);
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int e = t + it * NT;
        if (e >= O * O * G) break;
        const int bin = e / G, g2 = e % G;
        if (c0 + g2 * VW >= C) continue;
        const int i = bin / O, j = bin % O;
        const float* wrow = wx + j * MAXF + (x0 - xlo);
        for (int xx = 0; xx < nt; ++xx) {
          const float w = wrow[xx];
          if (w == 0.f) continue;
          const float* tp = &tmp[(i * XT + xx) * CS + g2 * VW];
#pragma unroll
          for (int k = 0; k < VW; k += 4) {
            const float4 q = *reinterpret_cast<const float4*>(tp + k);
            acc[it][k] = fmaf(w, q.x, acc[it][k]);
            acc[it][k + 1] = fmaf(w, q.y, acc[it][k + 1]);
            acc[it][k + 2] = fmaf(w, q.z, acc[it][k + 2]);
            acc[it][k + 3] = fmaf(w, q.w, acc[it][k + 3]);
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = t + it * NT;
    if (e >= O * O * G) break;
    const int bin = e / G, c = c0 + (e % G) * VW;
    if (c < C) store16(out + (size_t)bin * C + c, acc[it]);
  }
}

}  // namespace mv2d_sep
