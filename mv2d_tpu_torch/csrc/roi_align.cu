// Kernel K3: R-CNN RoIAlign 7x7 over four FPN levels (mmcv aligned=True,
// sampling_ratio=0: adaptive ceil(bin) samples per RoI and axis, no cap),
// with mmdet's level routing done in-kernel:
//   level = clamp(floor(log2(sqrt(area) / 56 + 1e-6)), 0, 3).
// Output [V, P, 7, 7, C] in natural slot order.
//
// Replaces mv2d_tpu/ops/pallas_roi_align.py: pallas_roi_align_views
// (_prv_impl -> _kernel_slab_v3).  Its per-view slabs, pass classes,
// overflow buckets and slot compaction were VMEM artifacts and are gone.
//
// What bounds it on the H100: reads.  Each output element averages
// Sy*Sx bilinear samples (4 corner loads each) from one level; a block
// owns one RoI and its threads walk (bin, 16-byte channel group) with the
// channels fastest, so every corner load is a coalesced 16-byte run along
// C of the channels-last map, and a RoI's footprint stays in L1/L2 across
// its 49 bins.  The sample coordinates are recomputed per thread (cheap
// ALU) rather than staged.  C must be a multiple of 8.
#include "common.cuh"

namespace {

constexpr int O = 7, NT = 256;

struct Level {
  const void* f;
  int H, W;
  float scale;
};

// VW channels (16 bytes) of pixel p into float32 v, and back
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  constexpr int VW = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VW; ++j) v[j] = mv2d::to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  constexpr int VW = 16 / sizeof(T);
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VW; ++j) e[j] = mv2d::from_f32<T>(v[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(NT) roi_align_kernel(
    Level l0, Level l1, Level l2, Level l3, const float* __restrict__ rois,
    T* __restrict__ out, int P, int C) {
  constexpr int VW = 16 / sizeof(T);   // channels per thread and load
  const int r = blockIdx.x, v = r / P;
  const float bx1 = rois[4 * r], by1 = rois[4 * r + 1];
  const float bx2 = rois[4 * r + 2], by2 = rois[4 * r + 3];
  const float area = fmaxf((bx2 - bx1) * (by2 - by1), 0.f);
  const float lv = floorf(log2f(sqrtf(area) / 56.f + 1e-6f));
  const int lvl = (int)fminf(fmaxf(lv, 0.f), 3.f);
  const Level L = lvl == 0 ? l0 : lvl == 1 ? l1 : lvl == 2 ? l2 : l3;
  const int H = L.H, W = L.W;
  const T* f = static_cast<const T*>(L.f) + (size_t)v * H * W * C;
  const float x1 = bx1 * L.scale - 0.5f, y1 = by1 * L.scale - 0.5f;
  const float bw = (bx2 - bx1) * L.scale / O, bh = (by2 - by1) * L.scale / O;
  const int nx = (int)fmaxf(ceilf(bw), 0.f), ny = (int)fmaxf(ceilf(bh), 0.f);
  const float divx = fmaxf((float)nx, 1.f), divy = fmaxf((float)ny, 1.f);
  T* o = out + (size_t)r * O * O * C;
  const int groups = C / VW;
  for (int e = threadIdx.x; e < O * O * groups; e += blockDim.x) {
    const int bin = e / groups, c = (e % groups) * VW;
    const int oy = bin / O, ox = bin % O;
    float acc[VW] = {};
    for (int iy = 0; iy < ny; ++iy) {
      float yy = y1 + ((float)oy + ((float)iy + 0.5f) / divy) * bh;
      if (!(yy > -1.f && yy < H)) continue;
      yy = fminf(fmaxf(yy, 0.f), (float)(H - 1));
      const int y0 = (int)floorf(yy), yb = min(y0 + 1, H - 1);
      const float ly = yy - y0;
      for (int ix = 0; ix < nx; ++ix) {
        float xx = x1 + ((float)ox + ((float)ix + 0.5f) / divx) * bw;
        if (!(xx > -1.f && xx < W)) continue;
        xx = fminf(fmaxf(xx, 0.f), (float)(W - 1));
        const int x0 = (int)floorf(xx), xb = min(x0 + 1, W - 1);
        const float lx = xx - x0;
        const float w00 = (1.f - ly) * (1.f - lx), w01 = (1.f - ly) * lx;
        const float w10 = ly * (1.f - lx), w11 = ly * lx;
        float v00[VW], v01[VW], v10[VW], v11[VW];
        load_vec(f + ((size_t)y0 * W + x0) * C + c, v00);
        load_vec(f + ((size_t)y0 * W + xb) * C + c, v01);
        load_vec(f + ((size_t)yb * W + x0) * C + c, v10);
        load_vec(f + ((size_t)yb * W + xb) * C + c, v11);
#pragma unroll
        for (int j = 0; j < VW; ++j)
          acc[j] += w00 * v00[j] + w01 * v01[j] + w10 * v10[j] +
                    w11 * v11[j];
      }
    }
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] /= divy * divx;
    store_vec(o + bin * C + c, acc);
  }
}

}  // namespace

extern "C" int mv2d_roi_align(const void* f0, const void* f1, const void* f2,
                              const void* f3, int H0, int W0, int H1, int W1,
                              int H2, int W2, int H3, int W3, float s0,
                              float s1, float s2, float s3, const void* rois,
                              void* out, int V, int P, int C, int dtype,
                              void* stream) {
  const Level l0{f0, H0, W0, s0}, l1{f1, H1, W1, s1}, l2{f2, H2, W2, s2},
      l3{f3, H3, W3, s3};
  auto s = static_cast<cudaStream_t>(stream);
  MV2D_DISPATCH(dtype, T, {
    roi_align_kernel<T><<<V * P, NT, 0, s>>>(
        l0, l1, l2, l3, static_cast<const float*>(rois), static_cast<T*>(out),
        P, C);
  });
  return static_cast<int>(cudaGetLastError());
}
