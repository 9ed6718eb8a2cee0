// Kernel B12: 7x7 RoIAlign over four FPN levels for FLAT RoIs [R, 4] with a
// view index [R] (mmcv aligned=True), mmdet's level routing in-kernel, a
// fixed sampling ratio S > 0 or mmcv's adaptive ceil(bin) (S <= 0, no
// cap).  Output [R, 7, 7, C].
//
// Replaces mv2d_tpu/ops/pallas_roi_align.py: _stacked_align (_kernel, the
// pallas_call behind pallas_multilevel_roi_align / _pma_impl).  The TPU
// kernel DMAs one [ph, ph + 8, C] patch per RoI into VMEM in three pass
// sizes and evaluates the bilinear weights separably as two batched dots;
// RoIs longer than 61 cells go to an XLA gather (up to 1024 of them).
// Here every RoI is exact in one kernel, with no pass sizes and no
// overflow bucket: a block owns one RoI and one 64-channel chunk and runs
// the separable core of roi_align_separable.cuh - the RoI's footprint rows
// come on chip as 16-byte cp.async copies of the channels-last map, and
// tmp = Ay . patch, out = tmp . Ax^T are evaluated from shared memory.
//
// What bounds it on the H100: bytes from L2 and device memory.  Each
// footprint cell is read once per RoI (the output's ~49 bins share it),
// against K3's four corner loads per bilinear sample; the bound counts
// the levels read once and the output written once.  The dynamic shared
// memory (ring, two profiles, the float32 tmp tile: ~101 KB in bf16) keeps
// two blocks on an SM.
#include "roi_align_separable.cuh"

namespace {

using namespace mv2d_sep;

template <typename T>
__global__ void __launch_bounds__(NT) roi_align_patch_kernel(
    Levels L, const float* __restrict__ rois,
    const int* __restrict__ view_idx, T* __restrict__ out, int C, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (C + CS - 1) / CS;
  const int r = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * CS;
  const Geometry g = geometry(L, rois + 4 * (size_t)r, S);
  align_roi<T>(L, g, view_idx[r], out + (size_t)r * O * O * C, C, c0, smem);
}

}  // namespace

// rois [R, 4] float32 image pixels, view_idx [R] int32 in [0, V) ->
// out [R, 7, 7, C] (dtype); levels [V, H_l, W_l, C], H_l, W_l <= 512
extern "C" int mv2d_roi_align_flat(const void* f0, const void* f1,
                                   const void* f2, const void* f3, int H0,
                                   int W0, int H1, int W1, int H2, int W2,
                                   int H3, int W3, float s0, float s1,
                                   float s2, float s3, const void* rois,
                                   const void* view_idx, void* out, int R,
                                   int C, int S, int dtype, void* stream) {
  const Levels L{{f0, f1, f2, f3}, {H0, H1, H2, H3}, {W0, W1, W2, W3},
                 {s0, s1, s2, s3}};
  auto s = static_cast<cudaStream_t>(stream);
  if (R == 0) return 0;
  const int chunks = (C + CS - 1) / CS;
  MV2D_DISPATCH(dtype, T, {
    const size_t smem = Tiling<T>::SMEM;
    cudaFuncSetAttribute(roi_align_patch_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    roi_align_patch_kernel<T><<<R * chunks, NT, smem, s>>>(
        L, static_cast<const float*>(rois),
        static_cast<const int*>(view_idx), static_cast<T*>(out), C, S);
  });
  return static_cast<int>(cudaGetLastError());
}
