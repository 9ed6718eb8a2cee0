// The axes of a RoI in 7x7 RoIAlign (mmcv aligned=True) and mmdet's level
// routing, shared by K3 and B9 (roi_align.cu) and by the streamed core of
// B11 and B12 (roi_align_stream.cuh).
#pragma once

#include "common.cuh"

namespace mv2d {
namespace roi {

// One axis of a RoI: bin i's samples sit at lo + (i + (s + 0.5) / div) *
// bin for s < ns; a sample inside (-1, n) is clamped into [0, n - 1] and
// weighs (1 - l) / div on its floor cell and l / div on the next (or the
// same, at the last cell).
struct Axis {
  float lo, bin, div;
  int ns, n;

  __device__ __forceinline__ float at(int i, int s) const {
    return lo + ((float)i + ((float)s + 0.5f) / div) * bin;
  }
  // the weight of bin i on cell c, summed in sample order
  __device__ __forceinline__ float weight(int i, int c) const {
    float w = 0.f;
    for (int s = 0; s < ns; ++s) {
      float p = at(i, s);
      if (!(p > -1.f && p < n)) continue;
      p = fminf(fmaxf(p, 0.f), (float)(n - 1));
      const int c0 = (int)floorf(p), c1 = min(c0 + 1, n - 1);
      const float l = p - c0;
      if (c0 == c) w += 1.f - l;
      if (c1 == c) w += l;
    }
    return w / div;
  }
  // w[i] = weight(i, c) for the seven bins, each summed in sample order; one
  // pass over the samples, the bins side by side
  __device__ __forceinline__ void weights(int c, float* w) const {
#pragma unroll
    for (int i = 0; i < 7; ++i) w[i] = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float f = ((float)s + 0.5f) / div;
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        float p = lo + ((float)i + f) * bin;
        if (!(p > -1.f && p < n)) continue;
        p = fminf(fmaxf(p, 0.f), (float)(n - 1));
        const int c0 = (int)floorf(p), c1 = min(c0 + 1, n - 1);
        const float l = p - c0;
        if (c0 == c) w[i] += 1.f - l;
        if (c1 == c) w[i] += l;
      }
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) w[i] /= div;
  }
  // the cells bin i touches: [*a, *b], empty (*a > *b) without a sample
  // inside the map (positions are monotone in s, so inside samples are
  // consecutive; they fall with s only for an inverted RoI at a fixed S)
  __device__ __forceinline__ void range(int i, int* a, int* b) const {
    int s0 = 0, s1 = ns - 1;
    while (s0 < ns && !(at(i, s0) > -1.f && at(i, s0) < n)) ++s0;
    while (s1 >= s0 && !(at(i, s1) > -1.f && at(i, s1) < n)) --s1;
    if (s0 > s1) {
      *a = 1 << 30;
      *b = -1;
      return;
    }
    const float top = (float)(n - 1);
    const float p = at(i, s0), q = at(i, s1);
    *a = (int)floorf(fminf(fmaxf(fminf(p, q), 0.f), top));
    *b = min((int)floorf(fminf(fmaxf(fmaxf(p, q), 0.f), top)) + 1, n - 1);
  }
};

// mmdet's level of RoI b = (x1, y1, x2, y2), image pixels
__device__ __forceinline__ int roi_level(const float* b) {
  const float area = fmaxf((b[2] - b[0]) * (b[3] - b[1]), 0.f);
  const float lv = floorf(log2f(sqrtf(area) / 56.f + 1e-6f));
  return (int)fminf(fmaxf(lv, 0.f), 3.f);
}

// RoI b's two axes on a level of H x W cells at `scale`, 7 bins a side: S
// samples a bin and axis when S > 0, else mmcv's adaptive ceil(bin) with
// no cap (a zero extent takes no sample)
__device__ __forceinline__ void roi_axes(const float* b, float scale, int H,
                                         int W, int S, Axis* ay, Axis* ax) {
  ay->lo = b[1] * scale - 0.5f;
  ax->lo = b[0] * scale - 0.5f;
  ay->bin = (b[3] - b[1]) * scale / 7;
  ax->bin = (b[2] - b[0]) * scale / 7;
  if (S > 0) {
    ay->ns = ax->ns = S;
  } else {
    ay->ns = (int)fmaxf(ceilf(ay->bin), 0.f);
    ax->ns = (int)fmaxf(ceilf(ax->bin), 0.f);
  }
  ay->div = fmaxf((float)ay->ns, 1.f);
  ax->div = fmaxf((float)ax->ns, 1.f);
  ay->n = H;
  ax->n = W;
}

}  // namespace roi
}  // namespace mv2d
