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
// What bounds it on the H100: bytes, mostly the output (12000 RoIs x 49
// bins x 256 channels in bf16: 301 MB), then the routed levels.  The
// first form of this kernel took each output vector as the mean of its
// bin's bilinear samples, four 16-byte corner loads a sample (several
// samples a bin on the eval path's RoIs): its time grew in step with C,
// so those loads paced it.  The weights of a RoI factor by axis: with the averaged
// bilinear hat profiles Ay [7, rows] and Ax [7, cols] of its footprint,
//   out[i, j, c] = sum_y Ay[i, y] sum_x Ax[j, x] F[y, x, c],
// and a cell feeds only the few bins whose samples come within one cell
// of it.  So:
//  * a block owns one RoI (and, past 32 x 16 bytes of channels, a slice
//    a round); warp j owns output column j, lane g channel group g, and
//    holds out[0..6, j, g] in float32 registers;
//  * warp j walks the footprint's rows, reading only its bin's columns
//    (16-byte loads, two rows x two cells in flight), and contracts each
//    row along x with Ax[j, .] (built once, a lane a column); a cell is
//    read by one warp, or two at a bin's edge, not once per sample
//    corner;
//  * then along y: the row's weights Ay[., y] are built once per tile of
//    64 rows by the block (a thread a (row, bin), each a sum over the
//    bin's samples in sample order) and are the same in the whole block,
//    so a bin the row does not feed costs a branch;
//  * the output goes out as 16-byte stores.
// What holds it now is the work and latency of each warp-row, not bytes:
// its time barely moves with C (chip_smoke.py's `c64_ms`) and deeper
// prefetch did not help; 14 warps an SM (acc takes 56 registers a lane)
// hide too little of it.  Tried and dropped (same shapes, same card): each
// row staged in shared memory by cp.async for all warps (a block barrier a
// row: slower than the first form); a per-warp cp.async ring (no gain);
// four channels a lane with 14 warps a block (spills at the register cap
// of two blocks); weights rebuilt per row by 7 lanes (that scalar work
// then paced it, whatever C); streaming stores for the output (no gain).
// The footprints of the eval path's RoIs overlap heavily, and no block
// reuses another's reads.  Nothing is atomic, so two runs give equal bits.
// C must be a multiple of 8.
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

constexpr int KT = O * 32;        // K3's threads: warp j <-> bin column j
constexpr int KR = 2;             // rows a warp loads at once
constexpr int KC = 2;             // cells of a row a warp loads at once
constexpr int YT = 64;            // footprint rows a tile of bin weights

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
  // the cells bin i touches: [*a, *b], empty (*a > *b) without a sample
  // inside the map (inside samples are consecutive: positions grow with s)
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
    *a = (int)floorf(fminf(fmaxf(at(i, s0), 0.f), top));
    *b = min((int)floorf(fminf(fmaxf(at(i, s1), 0.f), top)) + 1, n - 1);
  }
};

template <typename T>
__global__ void __launch_bounds__(KT, 2) roi_align_kernel(
    Level l0, Level l1, Level l2, Level l3, const float* __restrict__ rois,
    T* __restrict__ out, int P, int C) {
  constexpr int VW = 16 / sizeof(T);   // channels per lane and load
  const int r = blockIdx.x, v = r / P;
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float bx1 = rois[4 * r], by1 = rois[4 * r + 1];
  const float bx2 = rois[4 * r + 2], by2 = rois[4 * r + 3];
  const float area = fmaxf((bx2 - bx1) * (by2 - by1), 0.f);
  const float lv = floorf(log2f(sqrtf(area) / 56.f + 1e-6f));
  const int lvl = (int)fminf(fmaxf(lv, 0.f), 3.f);
  const Level L = lvl == 0 ? l0 : lvl == 1 ? l1 : lvl == 2 ? l2 : l3;
  const int H = L.H, W = L.W;
  const T* f = static_cast<const T*>(L.f) + (size_t)v * H * W * C;
  Axis ay, ax;
  ay.lo = by1 * L.scale - 0.5f;
  ax.lo = bx1 * L.scale - 0.5f;
  ay.bin = (by2 - by1) * L.scale / O;
  ax.bin = (bx2 - bx1) * L.scale / O;
  ay.ns = (int)fmaxf(ceilf(ay.bin), 0.f);
  ax.ns = (int)fmaxf(ceilf(ax.bin), 0.f);
  ay.div = fmaxf((float)ay.ns, 1.f);
  ax.div = fmaxf((float)ax.ns, 1.f);
  ay.n = H;
  ax.n = W;
  // the bins' cells along y and x, once: [lo, hi] each, in shared memory
  __shared__ int rng[4][O];
  __shared__ float wyt[YT][8];           // a row tile's bin weights
  if (threadIdx.x < O)
    ay.range(threadIdx.x, &rng[0][threadIdx.x], &rng[1][threadIdx.x]);
  else if (threadIdx.x < 2 * O)
    ax.range(threadIdx.x - O, &rng[2][threadIdx.x - O],
             &rng[3][threadIdx.x - O]);
  __syncthreads();
  int ylo = 1 << 30, yhi = -1;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    ylo = min(ylo, rng[0][i]);
    yhi = max(yhi, rng[1][i]);
  }
  const int xa = rng[2][j], xb = rng[3][j];   // this warp's columns
  const int groups = C / VW;
  T* o = out + (size_t)r * O * O * C;
  for (int c0 = 0; c0 < groups; c0 += 32) {     // channel slices
    const int g = c0 + lane;
    const bool act = g < groups;
    const T* fg = f + (act ? g * VW : 0);
    float acc[O][VW];
#pragma unroll
    for (int i = 0; i < O; ++i)
#pragma unroll
      for (int k = 0; k < VW; ++k) acc[i][k] = 0.f;
    for (int yt = ylo; yt <= yhi; yt += YT) {    // YT rows at a time
      const int ye = min(yt + YT - 1, yhi);
      __syncthreads();                   // the last tile's weights read
      for (int e = threadIdx.x; e < YT * O; e += KT)
        wyt[e / O][e % O] = yt + e / O <= ye ? ay.weight(e % O, yt + e / O)
                                             : 0.f;
      __syncthreads();
      for (int xc = xa; xc <= xb; xc += 32) {    // 32 columns at a time
        const int xe = min(xc + 31, xb);
        // lane k: the weight of column xc + k
        const float wx = xc + lane <= xe ? ax.weight(j, xc + lane) : 0.f;
        for (int y0 = yt; y0 <= ye; y0 += KR) {
          float t[KR][VW];               // the rows contracted along x
#pragma unroll
          for (int q = 0; q < KR; ++q)
#pragma unroll
            for (int k = 0; k < VW; ++k) t[q][k] = 0.f;
          for (int x0 = xc; x0 <= xe; x0 += KC) {
            uint4 raw[KR][KC];           // every load of the step in flight
#pragma unroll
            for (int q = 0; q < KR; ++q)
#pragma unroll
              for (int u = 0; u < KC; ++u) {
                raw[q][u] = make_uint4(0, 0, 0, 0);
                if (act && x0 + u <= xe && y0 + q <= ye)
                  raw[q][u] = *reinterpret_cast<const uint4*>(
                      fg + ((size_t)(y0 + q) * W + x0 + u) * C);
              }
#pragma unroll
            for (int u = 0; u < KC; ++u) {
              const float w =
                  __shfl_sync(0xffffffffu, wx, (x0 - xc + u) & 31);
#pragma unroll
              for (int q = 0; q < KR; ++q) {
                const T* e = reinterpret_cast<const T*>(&raw[q][u]);
#pragma unroll
                for (int k = 0; k < VW; ++k)
                  t[q][k] = fmaf(w, mv2d::to_f32(e[k]), t[q][k]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < KR; ++q) {
            if (y0 + q > ye) break;
            const float* wr = wyt[y0 + q - yt];
#pragma unroll
            for (int i = 0; i < O; ++i) {  // along y: the bins a row feeds
              const float w = wr[i];
              if (w == 0.f) continue;      // the same in the block
#pragma unroll
              for (int k = 0; k < VW; ++k)
                acc[i][k] = fmaf(w, t[q][k], acc[i][k]);
            }
          }
        }
      }
    }
    if (act)
#pragma unroll
      for (int i = 0; i < O; ++i) store_vec(o + (i * O + j) * C + g * VW,
                                            acc[i]);
  }
}

// ---- B9: the backward of K3, to the features only (the RoIs are
// detached on the training path).  Replaces mv2d_tpu/ops/pallas_roi_align.py:
// _prv_bwd_impl (_kernel_slab_bwd), which accumulated each view's slab
// gradient in VMEM to avoid scatters on the TPU.
//
// What bounds it on the H100: scattering into the float32 level
// gradients.  One atomic per (sample corner, channel) - the transposed
// loop of K3 - measured slower than the plain version (the atomics' L2
// traffic: ~16 samples x 4 corners per bin).  So the backward uses the
// separable form of the RoI's weights, as the plain version does: the
// sampling weights of a RoI factor into per-axis profiles Wy [7, H] and
// Wx [7, W] (each bin's averaged bilinear hats, built in shared memory),
// and dFeat[y, x, c] += sum_i Wy[i, y] sum_j Wx[j, x] dOut[i, j, c].  A
// block owns one RoI with K3's routing and adaptive ceil(bin) sampling
// (no cap); a thread owns a (footprint column x, 16-byte channel group),
// contracts the 7 x 7 dOut over j in registers and walks the footprint's
// rows, so every footprint cell gets one float32 atomic per channel (four
// channels per vector atomic).
// Levels up to 512 cells on a side (MAXF) are taken.
constexpr int MAXF = 512;

struct LevelGrad {
  float* g;
  int H, W;
  float scale;
};

// the averaged bilinear hats of the O bins' samples along one axis:
// w[i][cell] += (1 - l) / div at floor, l / div at floor + 1 (clamped),
// samples outside (-1, n) dropped; [lo, hi] gets the touched cells
__device__ void axis_profile(float (*w)[MAXF], int* lo, int* hi, float x1,
                             float bin, int ns, float div, int n) {
  for (int e = threadIdx.x; e < O * ns; e += blockDim.x) {
    const int i = e / ns, s = e % ns;
    float xx = x1 + ((float)i + ((float)s + 0.5f) / div) * bin;
    if (!(xx > -1.f && xx < n)) continue;
    xx = fminf(fmaxf(xx, 0.f), (float)(n - 1));
    const int x0 = (int)floorf(xx), xb = min(x0 + 1, n - 1);
    const float l = xx - x0;
    atomicAdd(&w[i][x0], (1.f - l) / div);
    atomicAdd(&w[i][xb], l / div);
    atomicMin(lo, x0);
    atomicMax(hi, xb);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) roi_align_bwd_kernel(
    LevelGrad l0, LevelGrad l1, LevelGrad l2, LevelGrad l3,
    const float* __restrict__ rois, const T* __restrict__ dout, int P,
    int C) {
  constexpr int VW = 16 / sizeof(T);
  __shared__ float wx[O][MAXF], wy[O][MAXF];
  __shared__ int xlo, xhi, ylo, yhi;
  const int r = blockIdx.x, v = r / P;
  const float bx1 = rois[4 * r], by1 = rois[4 * r + 1];
  const float bx2 = rois[4 * r + 2], by2 = rois[4 * r + 3];
  const float area = fmaxf((bx2 - bx1) * (by2 - by1), 0.f);
  const float lv = floorf(log2f(sqrtf(area) / 56.f + 1e-6f));
  const int lvl = (int)fminf(fmaxf(lv, 0.f), 3.f);
  const LevelGrad L = lvl == 0 ? l0 : lvl == 1 ? l1 : lvl == 2 ? l2 : l3;
  const int H = L.H, W = L.W;
  float* g = L.g + (size_t)v * H * W * C;
  const float x1 = bx1 * L.scale - 0.5f, y1 = by1 * L.scale - 0.5f;
  const float bw = (bx2 - bx1) * L.scale / O, bh = (by2 - by1) * L.scale / O;
  const int nx = (int)fmaxf(ceilf(bw), 0.f), ny = (int)fmaxf(ceilf(bh), 0.f);
  const float divx = fmaxf((float)nx, 1.f), divy = fmaxf((float)ny, 1.f);
  for (int e = threadIdx.x; e < O * MAXF; e += blockDim.x) {
    wx[e / MAXF][e % MAXF] = 0.f;
    wy[e / MAXF][e % MAXF] = 0.f;
  }
  if (threadIdx.x == 0) {
    xlo = W;
    ylo = H;
    xhi = yhi = -1;
  }
  __syncthreads();
  axis_profile(wx, &xlo, &xhi, x1, bw, nx, divx, W);
  axis_profile(wy, &ylo, &yhi, y1, bh, ny, divy, H);
  __syncthreads();
  if (xhi < xlo || yhi < ylo) return;           // no sample inside the map
  const T* d = dout + (size_t)r * O * O * C;
  const int groups = C / VW;
  for (int e = threadIdx.x; e < (xhi - xlo + 1) * groups; e += blockDim.x) {
    const int x = xlo + e / groups, c = (e % groups) * VW;
    float t[O][VW] = {};                        // sum_j Wx[j, x] dOut[i, j]
#pragma unroll
    for (int j = 0; j < O; ++j) {
      const float w = wx[j][x];
      if (w == 0.f) continue;
#pragma unroll
      for (int i = 0; i < O; ++i) {
        float dv[VW];
        load_vec(d + (i * O + j) * C + c, dv);
#pragma unroll
        for (int k = 0; k < VW; ++k) t[i][k] = fmaf(w, dv[k], t[i][k]);
      }
    }
    for (int y = ylo; y <= yhi; ++y) {
      float acc[VW] = {};
      bool any = false;
#pragma unroll
      for (int i = 0; i < O; ++i) {
        const float w = wy[i][y];
        if (w == 0.f) continue;
        any = true;
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[k] = fmaf(w, t[i][k], acc[k]);
      }
      if (any) mv2d::atomic_add<VW>(g + ((size_t)y * W + x) * C + c, acc);
    }
  }
}

}  // namespace

// dout [V, P, 7, 7, C] (dtype) -> g0..g3 [V, H_l, W_l, C] float32, zeroed
// by the caller and accumulated
extern "C" int mv2d_roi_align_bwd(void* g0, void* g1, void* g2, void* g3,
                                  int H0, int W0, int H1, int W1, int H2,
                                  int W2, int H3, int W3, float s0, float s1,
                                  float s2, float s3, const void* rois,
                                  const void* dout, int V, int P, int C,
                                  int dtype, void* stream) {
  const LevelGrad l0{static_cast<float*>(g0), H0, W0, s0},
      l1{static_cast<float*>(g1), H1, W1, s1},
      l2{static_cast<float*>(g2), H2, W2, s2},
      l3{static_cast<float*>(g3), H3, W3, s3};
  auto s = static_cast<cudaStream_t>(stream);
  MV2D_DISPATCH(dtype, T, {
    roi_align_bwd_kernel<T><<<V * P, NT, 0, s>>>(
        l0, l1, l2, l3, static_cast<const float*>(rois),
        static_cast<const T*>(dout), P, C);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mv2d_roi_align(const void* f0, const void* f1, const void* f2,
                              const void* f3, int H0, int W0, int H1, int W1,
                              int H2, int W2, int H3, int W3, float s0,
                              float s1, float s2, float s3, const void* rois,
                              void* out, int V, int P, int C, int dtype,
                              void* stream) {
  const Level l0{f0, H0, W0, s0}, l1{f1, H1, W1, s1}, l2{f2, H2, W2, s2},
      l3{f3, H3, W3, s3};
  auto s = static_cast<cudaStream_t>(stream);
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (V * P == 0) return 0;
  MV2D_DISPATCH(dtype, T, {
    roi_align_kernel<T><<<V * P, KT, 0, s>>>(
        l0, l1, l2, l3, static_cast<const float*>(rois), static_cast<T*>(out),
        P, C);
  });
  return static_cast<int>(cudaGetLastError());
}
