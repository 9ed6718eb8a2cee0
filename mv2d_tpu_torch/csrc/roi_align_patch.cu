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
// Here every RoI is exact in one kernel, with no pass sizes, no overflow
// bucket and no limit on a level's side: the streamed core of
// roi_align_stream.cuh, its work items the RoIs in index order.
//
// What bounds it on the H100: bytes.  The bound counts the cells the RoIs'
// footprints cover, read once per (view, level), and the output written once:
// 0.116 ms at the micro-bench's 12000 RoIs, C 256, bf16, of which the output
// is 301 MB and the levels 86 MB of their 368 (only RoIs under 112 pixels a
// side route to p2, and about half of the RoIs lie below the image and read
// nothing).  The footprints overlap, and each RoI's comes from L2 or device
// memory on its own.  Its first form gave a block each (RoI, 64-channel
// chunk): two axis profiles in shared memory sized for a 512-cell level, two
// block barriers a tile of footprint columns, a cp.async ring restarted on
// every tile, ~101 KB of shared memory: 1.631 ms adaptive, 1.542 at S = 2. Now
// persistent blocks stream RoI after RoI through one TMA ring, and seven
// consumer warps own the bin columns at 256 channels a pass: 0.510 and 0.482
// ms, K3 on the same RoIs 0.478 and 0.483 (tools/align_variants.py, NVIDIA
// H100 80GB HBM3, 700 W).  What holds it: the stream, the producer's records
// and the TMA round trips of a ring three slots deep, 0.460 ms with the
// consumers' row work switched off, against 0.420 for the consumers with the
// loads switched off; the two overlap to 0.510.  The same walk with K3's
// direct loads in the consumers took 0.871 ms.
#include "roi_align_stream.cuh"

// rois [R, 4] float32 image pixels, view_idx [R] int32 in [0, V) ->
// out [R, 7, 7, C] (dtype); levels [V, H_l, W_l, C], C % 8 == 0
extern "C" int mv2d_roi_align_flat(const void* f0, const void* f1,
                                   const void* f2, const void* f3, int H0,
                                   int W0, int H1, int W1, int H2, int W2,
                                   int H3, int W3, float s0, float s1,
                                   float s2, float s3, const void* rois,
                                   const void* view_idx, void* out, int R,
                                   int C, int S, int V, int dtype,
                                   void* stream) {
  const stream::Levels L{{f0, f1, f2, f3}, {H0, H1, H2, H3},
                         {W0, W1, W2, W3}, {s0, s1, s2, s3}};
  auto s = static_cast<cudaStream_t>(stream);
  if (R == 0) return 0;
  MV2D_DISPATCH(dtype, T, {
    return stream::launch<T>(L, V, C, static_cast<const float*>(rois),
                             static_cast<const int*>(view_idx), nullptr,
                             static_cast<T*>(out), R, 0, 0, S, s);
  });
  return 0;
}

// the streamed core's plan for `dtype` (0 float32, 1 bf16): field 0 box
// columns (a box is one row), 1 slot columns, 2 slot rows, 3 ring slots,
// 4 dynamic shared memory a block (bytes), 5 registers a thread, 6 blocks
// an SM
extern "C" long long mv2d_roi_align_stream_plan(int dtype, int field) {
  return stream::plan(dtype, field);
}
