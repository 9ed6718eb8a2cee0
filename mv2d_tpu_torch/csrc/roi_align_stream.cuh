// The streamed RoIAlign core of kernels B11 (roi_align_slab.cu) and B12
// (roi_align_patch.cu): K3's function (roi_align.cu: 7x7 bins over four FPN
// levels, mmcv aligned=True, mmdet's level routing in-kernel) with a fixed
// or adaptive sampling ratio, for RoIs that a work list hands out.
//
// A RoI's weights factor by axis, out[i, j] = sum_y Wy[i, y] sum_x
// Wx[j, x] F[y, x], and a cell feeds only the bins whose samples come
// within one cell of it.  A persistent block walks its work items (RoI,
// channel pass) in a fixed order with a static stride:
//  * the producer, warp 7, computes each item's level, axes, the bins'
//    cells and the footprint (the cells the samples touch) and
//    brings the footprint on chip YS rows at a time, column chunks of SX
//    outer: a chunk of YS rows fills one slot of a ring of STAGES with
//    full / empty mbarriers, each row as TMA boxes of (CB channels x BX
//    columns x 1 row x 1 view), so a row overhangs its footprint by less
//    than BX cells.  The item's record (output row, channel pass, x axis,
//    the bins' columns) goes to the consumers in the header of the
//    item's first slot, and each row's Wy[0..6, y] in the header of
//    its slot (producer lane l computes row y0 + l of a 32-row block,
//    Axis::weights, once for the seven consumer warps).  It runs ahead
//    across items, so the next RoI's first rows are in flight while the
//    consumers finish this one, and it writes the zeros of a RoI with no
//    sample inside the map itself;
//  * consumer warp j owns bin column j, and lane g a 16-byte channel group
//    (32 lanes x 8 bf16 = 256 channels a pass; float32 takes two passes at
//    C 256): it waits for a slot, reads only its bin's columns of the
//    slot's rows (a cell's 512 contiguous bytes across the warp, no bank
//    conflict), contracts each row along x with Wx[j, .] (lane l holds the
//    chunk's column first + l, Axis::weight), adds Wy[i, y] times the row
//    to out[i, j] in float32 registers, arrives on the slot's empty
//    barrier, and writes out[0..6, j] once with 16-byte stores at the
//    item's last slot.
// No block barrier after the set-up, no profile array, no limit on a
// level's side: the footprint's cells lie inside the map (samples clamp to
// [0, n - 1]), and only a box's overhang past the map's right or bottom
// edge reads outside it, where TMA fills zeros that weigh nothing.  Sums
// run in a fixed order and nothing is atomic, so two runs give equal bits.
// `python -m mv2d_tpu_torch.tools.align_variants` times other boxes, slots
// and rings, the same walk with K3's direct loads, and each phase switched
// off.
#pragma once

#include "mma.cuh"
#include "roi_axis.cuh"

namespace {
namespace stream {

using namespace mv2d::roi;
using namespace mv2d::tc;

constexpr int O = 7;
constexpr int NCW = O;                // consumer warps: warp j <-> bin column j
constexpr int NT = (NCW + 1) * 32;    // and the producer warp
constexpr int BX = 8;                 // a box: BX columns of one row
constexpr int SX = 32, YS = 2;        // a slot: YS rows of SX columns
constexpr int STAGES = 3;             // slots of the ring
constexpr int CELL = 512;             // a cell's bytes in a box, at most
constexpr int SLOT = YS * SX * CELL;
static_assert(SX % BX == 0 && SX <= 32, "a lane's column weight");
constexpr int HDR = 256;              // a slot's header
constexpr int SMEM = STAGES * (SLOT + HDR) + 2 * STAGES * 8 + 128;
constexpr int FIRST = 1, LAST = 2, END = 4;

struct Levels {
  const void* f[4];
  int H[4], W[4];
  float scale[4];
};

// one work item, (RoI, channel pass), as the consumers need it
struct Record {
  int out, c0;                        // output row, first channel
  int yhi;                            // the footprint's last row
  int xr[O][2];                       // bin column j's cells [lo, hi]
  Axis ax;
};
constexpr int RECW = sizeof(Record) / 4;

struct alignas(16) Header {           // wy is read as float4s
  int flags, y0, x0, pad;             // FIRST / LAST / END; first row, column
  float wy[YS][8];                    // Wy[0..6, y0 + r]
  Record rec;                         // in an item's first slot
};
static_assert(sizeof(Header) <= HDR, "a slot's header");

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v) {
  constexpr int VW = 16 / sizeof(T);
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < VW; ++k) e[k] = mv2d::from_f32<T>(v[k]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__device__ __forceinline__ void fma16(float* t, float w, const uint4& raw) {
  constexpr int VW = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < VW; ++k) t[k] = fmaf(w, mv2d::to_f32(e[k]), t[k]);
}

// items: with `order` (B11's work list [V, Pp], -1 an empty slot) item k
// is RoI order[k] of view k / Pp, row v * P + p of rois and out; without,
// item k is RoI k of view view_idx[k] (B12).  rois [.., 4] float32 image
// pixels; out [.., 7, 7, C]; CB channels a pass (a box's inner extent)
template <typename T>
__global__ void __launch_bounds__(NT, 2) stream_kernel(
    const __grid_constant__ CUtensorMap m0,
    const __grid_constant__ CUtensorMap m1,
    const __grid_constant__ CUtensorMap m2,
    const __grid_constant__ CUtensorMap m3, Levels L,
    const float* __restrict__ rois, const int* __restrict__ view_idx,
    const int* __restrict__ order, T* __restrict__ out, int items, int P,
    int Pp, int C, int CB, int S) {
  constexpr int VW = 16 / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  __shared__ Record wrec[NCW];        // each consumer warp's current item
  unsigned char* ring =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  Header* hdr = reinterpret_cast<Header*>(ring + STAGES * SLOT);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * (SLOT + HDR));
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cellb = CB * (int)sizeof(T);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NCW);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == NCW) {                  // ---- the producer
    int q = 0;
    // the next slot, once every consumer has released its last use
    auto acquire = [&]() {
      const int s = q % STAGES;
      if (q >= STAGES) mbar_wait(empty + s, (q / STAGES + 1) & 1);
      return s;
    };
    for (int k = blockIdx.x; k < items; k += gridDim.x) {
      int r, v;
      if (order != nullptr) {
        const int p = order[k];
        if (p < 0) continue;
        v = k / Pp;
        r = v * P + p;
      } else {
        r = k;
        v = view_idx[k];
      }
      const float b[4] = {rois[4 * (size_t)r], rois[4 * (size_t)r + 1],
                          rois[4 * (size_t)r + 2], rois[4 * (size_t)r + 3]};
      const int lvl = roi_level(b);
      Axis ay, ax;
      roi_axes(b, L.scale[lvl], L.H[lvl], L.W[lvl], S, &ay, &ax);
      // lanes 0-6: bin row i's cells, lanes 7-13: bin column j's
      int lo = 1 << 30, hi = -1;
      if (lane < O)
        ay.range(lane, &lo, &hi);
      else if (lane < 2 * O)
        ax.range(lane - O, &lo, &hi);
      int ylo = lane < O ? lo : 1 << 30, yhi = lane < O ? hi : -1;
      int xlo = lane < O ? 1 << 30 : lo, xhi = lane < O ? -1 : hi;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        ylo = min(ylo, __shfl_xor_sync(0xffffffffu, ylo, d));
        yhi = max(yhi, __shfl_xor_sync(0xffffffffu, yhi, d));
        xlo = min(xlo, __shfl_xor_sync(0xffffffffu, xlo, d));
        xhi = max(xhi, __shfl_xor_sync(0xffffffffu, xhi, d));
      }
      if (ylo > yhi || xlo > xhi) {   // no sample in the map: zeros
        uint4* o = reinterpret_cast<uint4*>(out + (size_t)r * O * O * C);
        for (int e = lane; e < O * O * C / VW; e += 32)
          o[e] = make_uint4(0, 0, 0, 0);
        continue;
      }
      const CUtensorMap* map = lvl == 0 ? &m0 : lvl == 1 ? &m1
                               : lvl == 2 ? &m2 : &m3;
      float wy[O];                    // Wy[i, yblk + lane]
      int yblk = -(1 << 30);
      for (int c0 = 0; c0 < C; c0 += CB) {
        int x0 = xlo, y0 = ylo, flags = FIRST;
        for (;;) {                    // the item's row pairs, a slot each
          const bool last = y0 + YS > yhi && x0 + SX > xhi;
          const int rows = min(YS, yhi - y0 + 1);
          const int s = acquire();
          Header* h = hdr + s;
          if (lane == 0) {
            h->flags = flags | (last ? LAST : 0);
            h->y0 = y0;
            h->x0 = x0;
          }
          if (y0 < yblk || y0 + rows > yblk + 32) {   // 32 new rows
            yblk = y0;
            ay.weights(y0 + lane, wy);
          }
          const int r0 = y0 - yblk;
          if (lane >= r0 && lane < r0 + rows)
#pragma unroll
            for (int i = 0; i < O; ++i) h->wy[lane - r0][i] = wy[i];
          if (flags & FIRST) {
            Record* rc = &h->rec;
            if (lane == 0) {
              rc->out = r;
              rc->c0 = c0;
              rc->yhi = yhi;
              rc->ax = ax;
            }
            if (lane >= O && lane < 2 * O) {
              rc->xr[lane - O][0] = lo;
              rc->xr[lane - O][1] = hi;
            }
          }
          __threadfence_block();
          __syncwarp();
          if (lane == 0) {            // each row's columns, BX a box
            const int nb = (min(xhi - x0 + 1, SX) + BX - 1) / BX;
            mbar_expect_tx(full + s, rows * nb * BX * cellb);
            for (int rr = 0; rr < rows; ++rr)
              for (int b = 0; b < nb; ++b)
                tma_load_4d(ring + s * SLOT + (rr * SX + b * BX) * cellb,
                            map, c0, x0 + b * BX, y0 + rr, v, full + s);
          }
          ++q;
          if (last) break;
          flags = 0;
          y0 += YS;
          if (y0 > yhi) {
            y0 = ylo;
            x0 += SX;
          }
        }
      }
    }
    const int s = acquire();          // the end of the walk
    if (lane == 0) {
      hdr[s].flags = END;
      mbar_arrive(full + s);
    }
    return;
  }

  // ---- consumer warp j: bin column j, lane g channels c0 + g VW ..
  const int j = warp;
  Record& rec = wrec[j];
  float acc[O][VW];
  float wx = 0.f;                     // Wx[j, xbase + lane]
  int xbase = 0, xa = 0, xb = -1, yhi = -1;
  for (int q = 0;; ++q) {
    const int s = q % STAGES;
    mbar_wait(full + s, (q / STAGES) & 1);
    const Header* h = hdr + s;
    const int flags = h->flags;
    if (flags & END) break;
    if (flags & FIRST) {
      __syncwarp();                   // the last item's record read
      const int* src = reinterpret_cast<const int*>(&h->rec);
      int* dst = reinterpret_cast<int*>(&rec);
      for (int e = lane; e < RECW; e += 32) dst[e] = src[e];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < O; ++i)
#pragma unroll
        for (int c = 0; c < VW; ++c) acc[i][c] = 0.f;
      xa = rec.xr[j][0];
      xb = rec.xr[j][1];
      yhi = rec.yhi;
      xbase = -1;
    }
    const int y0 = h->y0, x0 = h->x0;
    const int ca = max(xa, x0), cb = min(xb, x0 + SX - 1);
    if (ca <= cb) {
      if (ca != xbase) {              // a new column chunk
        xbase = ca;
        wx = ca + lane <= cb ? rec.ax.weight(j, ca + lane) : 0.f;
      }
      // the slot's rows contracted along x (a row past the footprint's
      // last is not loaded and not used), then added to the bins they feed
      float t[YS][VW];
#pragma unroll
      for (int rr = 0; rr < YS; ++rr)
#pragma unroll
        for (int c = 0; c < VW; ++c) t[rr][c] = 0.f;
      const unsigned char* cell = ring + s * SLOT + lane * 16 +
                                  (ca - x0) * cellb;
      for (int x = ca; x <= cb; ++x, cell += cellb) {
        uint4 raw[YS];
#pragma unroll
        for (int rr = 0; rr < YS; ++rr)
          raw[rr] = *reinterpret_cast<const uint4*>(cell + rr * SX * cellb);
        const float w = __shfl_sync(0xffffffffu, wx, x - ca);
#pragma unroll
        for (int rr = 0; rr < YS; ++rr) fma16<T>(t[rr], w, raw[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < YS; ++rr) {
        if (y0 + rr > yhi) break;
        const float4 w03 = *reinterpret_cast<const float4*>(h->wy[rr]);
        const float4 w47 = *reinterpret_cast<const float4*>(h->wy[rr] + 4);
        const float wy[O] = {w03.x, w03.y, w03.z, w03.w,
                             w47.x, w47.y, w47.z};
#pragma unroll
        for (int i = 0; i < O; ++i) {   // along y: the bins the row feeds
          if (wy[i] == 0.f) continue;   // the same in the warp
#pragma unroll
          for (int c = 0; c < VW; ++c)
            acc[i][c] = fmaf(wy[i], t[rr][c], acc[i][c]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (flags & LAST) {
      const int c = rec.c0 + lane * VW;
      if (lane * VW < CB && c < C) {
        T* o = out + (size_t)rec.out * O * O * C + c;
#pragma unroll
        for (int i = 0; i < O; ++i) store16(o + (i * O + j) * C, acc[i]);
      }
    }
  }
}

// The launch: one tensor map per level, CB = min(C, 32 lanes x 16 bytes)
// channels a pass, (blocks an SM) x SMs persistent blocks
template <typename T>
int launch(const Levels& L, int V, int C, const float* rois,
           const int* view_idx, const int* order, T* out, int items, int P,
           int Pp, int S, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (C % 8 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (items <= 0) return 0;
  const int CB = C < 32 * VW ? C : 32 * VW;
  CUtensorMap maps[4];
  for (int l = 0; l < 4; ++l)
    if (!encode_nhwc_dense(&maps[l], L.f[l], (int)sizeof(T), V, L.H[l],
                           L.W[l], C, CB, BX, 1))
      return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = stream_kernel<T>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, SMEM);
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = (int)(items < cap ? items : cap);
  kernel<<<grid, NT, SMEM, s>>>(maps[0], maps[1], maps[2], maps[3], L, rois,
                                view_idx, order, out, items, P, Pp, C, CB, S);
  return static_cast<int>(cudaGetLastError());
}

// the plan of the kernel for `dtype` (0 float32, 1 bf16): 0 BX, 1 SX,
// 2 YS, 3 STAGES, 4 dynamic shared memory a block (bytes), 5 registers a
// thread, 6 blocks an SM
inline long long plan(int dtype, int field) {
  const long long f[5] = {BX, SX, YS, STAGES, SMEM};
  if (field >= 0 && field < 5) return f[field];
  const void* k = dtype == 0
                      ? reinterpret_cast<const void*>(stream_kernel<float>)
                      : reinterpret_cast<const void*>(
                            stream_kernel<__nv_bfloat16>);
  if (field == 5) {
    cudaFuncAttributes a{};
    cudaFuncGetAttributes(&a, k);
    return a.numRegs;
  }
  int per_sm = 0;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, NT, SMEM);
  return field == 6 ? per_sm : -1;
}

}  // namespace stream
}  // namespace
