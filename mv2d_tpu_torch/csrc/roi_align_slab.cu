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
// TPU artifacts and are gone: every RoI is exact, on levels of any side.
//
// On the H100 the counterpart of that slab is the 50 MB L2: one view's
// four levels at C 256 in bf16 are 30.6 MB.  Two launches:
//   1. slab_worklist_kernel, one block per view, builds the per-view work
//      list on the device: each RoI's size class (the pass classes of
//      _prv_geom: long side <= 13, 29, 61 cells at its routed level, or
//      longer), and the view's RoIs grouped by class into buckets of NRB
//      slots (a class's run padded to whole buckets with -1);
//   2. the streamed core of roi_align_stream.cuh walks that list in
//      order, view-major, a persistent block every (blocks an SM) x SMs
//      slots; its producer skips the empty slots.  The blocks in flight
//      share a view, so its stack is read from device memory about once,
//      then from L2, and neighbouring slots hold RoIs of like size.
// What bounds it: bytes, as B12 (roi_align_patch.cu): the cells its RoIs'
// footprints cover, read once per (view, level), and the output written once,
// 0.194 ms at [12, 1000] in bf16 (0.067 at [6, 512]; anchor-like RoIs cover
// most of each level, so every level read whole gives 0.200 and 0.078).  Its
// first form gave a block each (bucket, 64-channel chunk) and served the
// bucket's RoIs one after another, each behind its own shared profiles and
// block barriers, so the load pipeline emptied between RoIs: 1.997 and 0.585
// ms.  On the streamed core: 0.776 and 0.248 ms, K3 on the same RoIs 0.887 and
// 0.254 (tools/align_variants.py, NVIDIA H100 80GB HBM3, 700 W).  What holds
// it: the consumers' row work (0.673 ms with the loads switched off: the
// 16-byte reads, the bf16 unpacking and the products of each cell a warp owns,
// at 14 consumer warps an SM), then the stream (0.611 with the row work
// switched off: each RoI's footprint through L2 on its own, rows rounded up to
// whole boxes); the two overlap to 0.776.  Tried and dropped on the same card:
// boxes of 16 or 32 columns (0.760, 0.762 here, slower for B12), one-row slots
// six deep (0.875), 24-column slots four deep (0.808, wide rows then take two
// chunks), K3's direct loads in the same walk (1.259).
#include "roi_align_stream.cuh"

namespace {

constexpr int NRB = 8;          // RoIs a bucket
constexpr int NCLASS = 4;       // size classes

__device__ __forceinline__ int size_class(const stream::Levels& L,
                                          const float* b) {
  const float sc = L.scale[mv2d::roi::roi_level(b)];
  const float cells = fmaxf(b[2] - b[0], b[3] - b[1]) * sc;
  return (cells > 13.f) + (cells > 29.f) + (cells > 61.f);
}

// order [V, Pp]: per view, the RoI index of each bucket slot (-1 empty)
__global__ void slab_worklist_kernel(stream::Levels L,
                                     const float* __restrict__ rois,
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

}  // namespace

// rois [V, P, 4] float32 image pixels -> out [V, P, 7, 7, C] (dtype);
// order: int32 scratch [V, Pp], Pp >= P + 4 * (NRB - 1) a multiple of NRB
// (each class's run padded to whole buckets); levels [V, H_l, W_l, C],
// C % 8 == 0
extern "C" int mv2d_roi_align_slab(const void* f0, const void* f1,
                                   const void* f2, const void* f3, int H0,
                                   int W0, int H1, int W1, int H2, int W2,
                                   int H3, int W3, float s0, float s1,
                                   float s2, float s3, const void* rois,
                                   void* order, void* out, int V, int P,
                                   int Pp, int C, int dtype, void* stream) {
  const stream::Levels L{{f0, f1, f2, f3}, {H0, H1, H2, H3},
                         {W0, W1, W2, W3}, {s0, s1, s2, s3}};
  auto s = static_cast<cudaStream_t>(stream);
  if (V == 0 || P == 0) return 0;
  if (Pp % NRB || Pp < P + NCLASS * (NRB - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  slab_worklist_kernel<<<V, 1024, 0, s>>>(
      L, static_cast<const float*>(rois), static_cast<int*>(order), P, Pp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  MV2D_DISPATCH(dtype, T, {
    return stream::launch<T>(L, V, C, static_cast<const float*>(rois),
                             nullptr, static_cast<const int*>(order),
                             static_cast<T*>(out), V * Pp, P, Pp, 0, s);
  });
  return 0;
}
