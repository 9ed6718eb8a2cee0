// Kernel B11: 7x7 RoIAlign over four FPN levels for view-uniform RoIs
// [V, P, 4] -> [V, P, 7, 7, C] in natural slot order: K3's function
// (adaptive ceil(bin) sampling with no cap, mmdet level routing in-kernel).
//
// Replaces mv2d_tpu/ops/pallas_roi_align.py: _prv_impl's v2 branch
// (_kernel_slab_v2, selected by MV2D_ALIGN_V2=1), which keeps one view's
// whole level stack resident in VMEM (~56 MB) and serves that view's RoIs
// from it in buckets of nr = 8 RoIs of one patch-size class, with the
// classes and the per-view bucket compaction of _prv_geom.  Its one-hot
// einsum scatter, HBM slab, band passes and capped overflow buckets are
// TPU artifacts and are gone: every RoI is exact.
//
// On the H100 the counterpart of that slab is the 50 MB L2: one view's
// four levels at C 256 in bf16 are 30.6 MB.  Two launches:
//   1. slab_worklist_kernel, one block per view, builds the per-view work
//      list on the device: each RoI's size class (the pass classes of
//      _prv_geom: long side <= 13, 29, 61 cells at its routed level, or
//      longer), and the view's RoIs grouped by class into buckets of NRB
//      slots (a class's run padded to whole buckets with -1);
//   2. slab_align_kernel: a block serves one bucket of one view for one
//      64-channel chunk, RoI after RoI, with the separable core of
//      roi_align_separable.cuh (footprint rows by cp.async, tmp = Ay .
//      patch, out = tmp . Ax^T from shared memory).  Blocks are ordered
//      view-major, so the blocks in flight share a view and its stack is
//      read from device memory about once, then from L2; a bucket's RoIs
//      are of one class, so a block's loops are of like length.
// What bounds it: bytes, as B12 (roi_align_patch.cu).
#include "roi_align_separable.cuh"

namespace {

using namespace mv2d_sep;

constexpr int NRB = 8;          // RoIs a bucket
constexpr int NCLASS = 4;       // size classes

__device__ __forceinline__ int size_class(const Levels& L, const float* b) {
  const float sc = L.scale[route(b[0], b[1], b[2], b[3])];
  const float cells = fmaxf(b[2] - b[0], b[3] - b[1]) * sc;
  return (cells > 13.f) + (cells > 29.f) + (cells > 61.f);
}

// order [V, Pp]: per view, the RoI index of each bucket slot (-1 empty)
__global__ void slab_worklist_kernel(Levels L, const float* __restrict__ rois,
                                     int* __restrict__ order, int P,
                                     int Pp) {
  __shared__ int cnt[NCLASS], base[NCLASS];
  const int v = blockIdx.x;
  const float* rv = rois + (size_t)v * P * 4;
  int* ov = order + (size_t)v * Pp;
  if (threadIdx.x < NCLASS) cnt[threadIdx.x] = 0;
  for (int e = threadIdx.x; e < Pp; e += blockDim.x) ov[e] = -1;
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    atomicAdd(&cnt[size_class(L, rv + 4 * p)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0;
    for (int k = 0; k < NCLASS; ++k) {
      base[k] = off;
      off += (cnt[k] + NRB - 1) / NRB * NRB;
      cnt[k] = 0;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int k = size_class(L, rv + 4 * p);
    ov[base[k] + atomicAdd(&cnt[k], 1)] = p;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) slab_align_kernel(
    Levels L, const float* __restrict__ rois, const int* __restrict__ order,
    T* __restrict__ out, int P, int Pp, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (C + CS - 1) / CS, buckets = Pp / NRB;
  const int c0 = (blockIdx.x % chunks) * CS;
  const int rest = blockIdx.x / chunks;
  const int v = rest / buckets, b = rest % buckets;
  const int* slots = order + (size_t)v * Pp + b * NRB;
  for (int k = 0; k < NRB; ++k) {
    const int p = slots[k];
    if (p < 0) continue;
    const size_t r = (size_t)v * P + p;
    const Geometry g = geometry(L, rois + 4 * r, 0);
    align_roi<T>(L, g, v, out + r * O * O * C, C, c0, smem);
  }
}

}  // namespace

// rois [V, P, 4] float32 image pixels -> out [V, P, 7, 7, C] (dtype);
// order: int32 scratch [V, Pp], Pp >= P + 4 * (NRB - 1) a multiple of NRB
// (each class's run padded to whole buckets); levels [V, H_l, W_l, C],
// H_l, W_l <= 512
extern "C" int mv2d_roi_align_slab(const void* f0, const void* f1,
                                   const void* f2, const void* f3, int H0,
                                   int W0, int H1, int W1, int H2, int W2,
                                   int H3, int W3, float s0, float s1,
                                   float s2, float s3, const void* rois,
                                   void* order, void* out, int V, int P,
                                   int Pp, int C, int dtype, void* stream) {
  const Levels L{{f0, f1, f2, f3}, {H0, H1, H2, H3}, {W0, W1, W2, W3},
                 {s0, s1, s2, s3}};
  auto s = static_cast<cudaStream_t>(stream);
  if (V == 0 || P == 0) return 0;
  if (Pp % NRB || Pp < P + NCLASS * (NRB - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (C + CS - 1) / CS;
  slab_worklist_kernel<<<V, 1024, 0, s>>>(
      L, static_cast<const float*>(rois), static_cast<int*>(order), P, Pp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  MV2D_DISPATCH(dtype, T, {
    const size_t smem = Tiling<T>::SMEM;
    cudaFuncSetAttribute(slab_align_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    slab_align_kernel<T><<<V * (Pp / NRB) * chunks, NT, smem, s>>>(
        L, static_cast<const float*>(rois),
        static_cast<const int*>(order), static_cast<T*>(out), P, Pp, C);
  });
  return static_cast<int>(cudaGetLastError());
}
