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

// mmdet's level of RoI b = (x1, y1, x2, y2), image pixels
__device__ __forceinline__ int roi_level(const float* b) {
  const float area = fmaxf((b[2] - b[0]) * (b[3] - b[1]), 0.f);
  const float lv = floorf(log2f(sqrtf(area) / 56.f + 1e-6f));
  return (int)fminf(fmaxf(lv, 0.f), 3.f);
}

// RoI b's two axes on a level of H x W cells at `scale`: adaptive
// ceil(bin) samples a bin, no cap
__device__ __forceinline__ void roi_axes(const float* b, float scale, int H,
                                         int W, Axis* ay, Axis* ax) {
  ay->lo = b[1] * scale - 0.5f;
  ax->lo = b[0] * scale - 0.5f;
  ay->bin = (b[3] - b[1]) * scale / O;
  ax->bin = (b[2] - b[0]) * scale / O;
  ay->ns = (int)fmaxf(ceilf(ay->bin), 0.f);
  ax->ns = (int)fmaxf(ceilf(ax->bin), 0.f);
  ay->div = fmaxf((float)ay->ns, 1.f);
  ax->div = fmaxf((float)ax->ns, 1.f);
  ay->n = H;
  ax->n = W;
}

template <typename T>
__global__ void __launch_bounds__(KT, 2) roi_align_kernel(
    Level l0, Level l1, Level l2, Level l3, const float* __restrict__ rois,
    T* __restrict__ out, int P, int C) {
  constexpr int VW = 16 / sizeof(T);   // channels per lane and load
  const int r = blockIdx.x, v = r / P;
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* b = rois + 4 * r;
  const int lvl = roi_level(b);
  const Level L = lvl == 0 ? l0 : lvl == 1 ? l1 : lvl == 2 ? l2 : l3;
  const int H = L.H, W = L.W;
  const T* f = static_cast<const T*>(L.f) + (size_t)v * H * W * C;
  Axis ay, ax;
  roi_axes(b, L.scale, H, W, &ay, &ax);
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
// detached on the training path):
//   dF_l[v, y, x, c] =
//       sum_r sum_i Wy_r[i, y] sum_j Wx_r[j, x] dOut[r, i, j, c]
// over the RoIs r of view v that K3 routes to level l, with K3's axis
// profiles.  Replaces mv2d_tpu/ops/pallas_roi_align.py: _prv_bwd_impl
// (_kernel_slab_bwd, and _kernel_slab_bwd_v2 of the MV2D_ALIGN_V2 route,
// which computes the same function), which summed each view's slab
// gradient in VMEM so as not to scatter on the TPU.
//
// The bound on the H100 is bytes: dOut read once and the level gradients
// written once in the features' dtype, 0.078 ms at the training RoIs
// [6, 512] in bf16.  The first form gave a block to each RoI, built its
// profiles with float32 atomics in shared memory and scattered its
// footprint into float32 level gradients with vector atomics: 1.10 ms,
// with a zero-fill of those buffers before it, a cast after it, and sums
// whose order changed from run to run.  Now every gradient cell has one
// owner:
//  * an index pass, a thread a RoI, gives each RoI its level and its
//    footprint box, the cells its bins' samples touch;
//  * each (view, level) map is cut into BT x BT cell tiles, and a block
//    owns a tile x a slice of 32 x 16 bytes of channels: warp x owns
//    column x of the tile and holds its BT cells in float32 registers;
//    the coarsest level's tiles come first, since their lists are the
//    longest (at the training RoIs [6, 512] of chip_smoke.py, 32 RoIs a
//    tile on average at p4, 2.6 at p2);
//  * the block lists the RoIs of its view whose level and footprint meet
//    the tile, in RoI order (a ballot and a block scan over the view's
//    footprints, BNT RoIs a round; the listing threads also set up each
//    listed RoI's axes), and walks the list BNB RoIs at a time: the
//    bins' cell ranges, then the profile entries on the tile's rows and
//    columns inside them (a thread an entry, each a sum over its bin's
//    samples in sample order, K3's Axis::weight) and each RoI's bins on
//    the tile's rows and on each column go to shared memory; warp x then
//    loads, for BI bin rows x BJ bin columns at once, the dOut vectors it
//    needs, takes t = sum_j Wx[j, x] dOut[i, j] and adds Wy[i, y] t to
//    its cells;
//  * the owner writes each cell once, in the features' dtype, zeros where
//    no RoI reaches; a pile-up of RoIs on one tile is walked in full by
//    the tile's owner.
// Nothing is atomic on floats, so two runs give equal bits.  What holds
// it now is the latency of each owner's walk (the dOut loads of a RoI, the
// batch's profile entries and its block barriers), not bytes: 0.326 ms at
// [6, 512], 24% of the bound (chip_smoke.py; NVIDIA H100 80GB HBM3,
// 700 W).  Tried and dropped (the same shapes and card): loading one bin
// row at a time, tiles in view order (the long lists of the coarse levels
// then ran last), tiles of 4 rows with three blocks an SM, and batches of
// 32 RoIs were each slower or no faster; profile entries for every bin,
// not only inside its cells, cost time for nothing.
constexpr int BT = 8;             // B9's owner tile side, cells
constexpr int BNT = BT * 32;      // its threads: warp x <-> tile column x
constexpr int BNB = 16;           // RoIs a batch of the owner's walk
constexpr int BI = 4, BJ = 2;     // bin rows x columns of dOut loaded at once

struct LevelGrad {
  void* g;
  int H, W;
  float scale;
};

__host__ __device__ __forceinline__ int tiles_of(const LevelGrad& L) {
  return ((L.H + BT - 1) / BT) * ((L.W + BT - 1) / BT);
}

// B9's index pass: RoI r's level and footprint box (ylo, yhi, xlo, xhi)
// in its level's cells, (1 << 30, -1, 1 << 30, -1) without a sample
// inside the map
__global__ void __launch_bounds__(256) roi_footprint_kernel(
    LevelGrad l0, LevelGrad l1, LevelGrad l2, LevelGrad l3,
    const float* __restrict__ rois, int R, int4* __restrict__ box,
    int* __restrict__ lvl) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= R) return;
  const float* b = rois + 4 * r;
  const int l = roi_level(b);
  const LevelGrad L = l == 0 ? l0 : l == 1 ? l1 : l == 2 ? l2 : l3;
  Axis ay, ax;
  roi_axes(b, L.scale, L.H, L.W, &ay, &ax);
  int4 f = make_int4(1 << 30, -1, 1 << 30, -1);
  for (int i = 0; i < O; ++i) {
    int lo, hi;
    ay.range(i, &lo, &hi);
    f.x = min(f.x, lo);
    f.y = max(f.y, hi);
    ax.range(i, &lo, &hi);
    f.z = min(f.z, lo);
    f.w = max(f.w, hi);
  }
  if (f.x > f.y || f.z > f.w) f = make_int4(1 << 30, -1, 1 << 30, -1);
  box[r] = f;
  lvl[r] = l;
}

// B9's owners: block (tile, channel slice), the tiles numbered from the
// coarsest level down (their lists are the longest, so they start first),
// view-major within a level, row-major within a map.
template <typename T>
__global__ void __launch_bounds__(BNT, 2) roi_owner_kernel(
    LevelGrad l0, LevelGrad l1, LevelGrad l2, LevelGrad l3,
    const float* __restrict__ rois, const int4* __restrict__ box,
    const int* __restrict__ lvl, const T* __restrict__ dout, int V, int P,
    int C) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int NW = BNT / 32;
  __shared__ int list[BNT];
  __shared__ int wsum[NW];
  __shared__ Axis axes[BNT][2];              // the listed RoIs' y, x axes
  __shared__ int rng[BNB][2][O][2];          // the bins' cells [lo, hi]
  __shared__ int bins[BNB][BT + 1][2];       // bins on the rows, a column
  __shared__ float wy[BNB][O][BT], wx[BNB][O][BT];
  const int x = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int t = blockIdx.x, lv = 3;
  LevelGrad G = l3;
  if (t >= V * tiles_of(l3)) {
    t -= V * tiles_of(l3), lv = 2, G = l2;
    if (t >= V * tiles_of(l2)) {
      t -= V * tiles_of(l2), lv = 1, G = l1;
      if (t >= V * tiles_of(l1)) t -= V * tiles_of(l1), lv = 0, G = l0;
    }
  }
  const int v = t / tiles_of(G);
  t %= tiles_of(G);
  const int txn = (G.W + BT - 1) / BT;
  const int ty0 = t / txn * BT, tx0 = t % txn * BT;
  const int ty1 = min(ty0 + BT, G.H) - 1, tx1 = min(tx0 + BT, G.W) - 1;
  const int cx = tx0 + x;                    // this warp's column
  const int g = blockIdx.y * 32 + lane;
  const bool act = g < C / VW;
  float acc[BT][VW];
#pragma unroll
  for (int y = 0; y < BT; ++y)
#pragma unroll
    for (int k = 0; k < VW; ++k) acc[y][k] = 0.f;
  for (int p0 = 0; p0 < P; p0 += BNT) {
    // this round's RoIs that meet the tile, in RoI order, with their axes
    const int p = p0 + threadIdx.x;
    bool meet = false;
    float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < P) {
      const int4 f = box[v * P + p];
      b4 = reinterpret_cast<const float4*>(rois)[v * P + p];
      meet = lvl[v * P + p] == lv && f.x <= ty1 && f.y >= ty0 &&
             f.z <= tx1 && f.w >= tx0;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, meet);
    __syncthreads();                         // the last round's walk done
    if (lane == 0) wsum[x] = __popc(bal);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      before += w < x ? wsum[w] : 0;
      n += wsum[w];
    }
    if (meet) {
      const int at = before + __popc(bal & ((1u << lane) - 1u));
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      list[at] = p;
      roi_axes(bb, G.scale, G.H, G.W, &axes[at][0], &axes[at][1]);
    }
    __syncthreads();
    for (int b0 = 0; b0 < n; b0 += BNB) {
      const int nb = min(BNB, n - b0);
      if (b0 > 0) __syncthreads();           // the last batch's walk done
      for (int e = threadIdx.x; e < nb * 2 * O; e += BNT) {
        const int k = e / (2 * O), a = e / O % 2, i = e % O;
        axes[b0 + k][a].range(i, &rng[k][a][i][0], &rng[k][a][i][1]);
      }
      __syncthreads();
      // the profile entries on the tile's rows and columns, 0 outside the
      // bin's cells (a thread an entry), and per RoI the bins that meet
      // the tile's rows and those on each column
      for (int e = threadIdx.x; e < nb * 2 * O * BT; e += BNT) {
        const int k = e / (2 * O * BT), a = e / (O * BT) % 2;
        const int i = e / BT % O, c = e % BT;
        const int cell = (a == 0 ? ty0 : tx0) + c;
        const bool in = cell >= rng[k][a][i][0] && cell <= rng[k][a][i][1];
        (a == 0 ? wy : wx)[k][i][c] = in ? axes[b0 + k][a].weight(i, cell)
                                         : 0.f;
      }
      for (int e = threadIdx.x; e < nb * (BT + 1); e += BNT) {
        const int k = e / (BT + 1), col = e % (BT + 1) - 1;
        int lo = O, hi = -1;
        for (int j = 0; j < O; ++j) {
          const bool on =
              col < 0 ? rng[k][0][j][0] <= ty1 && rng[k][0][j][1] >= ty0
                      : rng[k][1][j][0] <= tx0 + col &&
                            rng[k][1][j][1] >= tx0 + col;
          if (on) {
            lo = min(lo, j);
            hi = j;
          }
        }
        bins[k][col + 1][0] = lo;
        bins[k][col + 1][1] = hi;
      }
      __syncthreads();
      for (int k = 0; k < nb; ++k) {
        const T* d = dout + (size_t)(v * P + list[b0 + k]) * O * O * C +
                     (act ? g * VW : 0);
        const int ia = bins[k][0][0], ib = bins[k][0][1];
        const int ja = bins[k][x + 1][0], jb = bins[k][x + 1][1];
        if (ja > jb) continue;
        for (int i0 = ia; i0 <= ib; i0 += BI)
          for (int j0 = ja; j0 <= jb; j0 += BJ) {
            uint4 raw[BI][BJ];               // every load of the step
#pragma unroll
            for (int ii = 0; ii < BI; ++ii)
#pragma unroll
              for (int u = 0; u < BJ; ++u) {
                raw[ii][u] = make_uint4(0, 0, 0, 0);
                if (act && i0 + ii <= ib && j0 + u <= jb)
                  raw[ii][u] = *reinterpret_cast<const uint4*>(
                      d + ((i0 + ii) * O + j0 + u) * C);
              }
#pragma unroll
            for (int ii = 0; ii < BI; ++ii) {
              if (i0 + ii > ib) break;
              float tv[VW];                  // sum_j Wx[j, cx] dOut[i, j]
#pragma unroll
              for (int q = 0; q < VW; ++q) tv[q] = 0.f;
#pragma unroll
              for (int u = 0; u < BJ; ++u) {
                if (j0 + u > jb) break;
                const float w = wx[k][j0 + u][x];
                const T* e = reinterpret_cast<const T*>(&raw[ii][u]);
#pragma unroll
                for (int q = 0; q < VW; ++q)
                  tv[q] = fmaf(w, mv2d::to_f32(e[q]), tv[q]);
              }
#pragma unroll
              for (int y = 0; y < BT; ++y) {   // the tile's rows bin i feeds
                const float w = wy[k][i0 + ii][y];
                if (w == 0.f) continue;        // the same in the block
#pragma unroll
                for (int q = 0; q < VW; ++q)
                  acc[y][q] = fmaf(w, tv[q], acc[y][q]);
              }
            }
          }
      }
    }
  }
  if (!act || cx > tx1) return;
  T* o = static_cast<T*>(G.g) +
         (((size_t)v * G.H + ty0) * G.W + cx) * C + g * VW;
#pragma unroll
  for (int y = 0; y < BT; ++y)
    if (ty0 + y <= ty1) store_vec(o + (size_t)y * G.W * C, acc[y]);
}

}  // namespace

// dout [V, P, 7, 7, C] (dtype) -> g0..g3 [V, H_l, W_l, C] (dtype), every
// element written once; box [V P] int4 and lvl [V P] int: workspace of the
// index pass.  C % 8 == 0.
extern "C" int mv2d_roi_align_bwd(void* g0, void* g1, void* g2, void* g3,
                                  int H0, int W0, int H1, int W1, int H2,
                                  int W2, int H3, int W3, float s0, float s1,
                                  float s2, float s3, const void* rois,
                                  const void* dout, void* box, void* lvl,
                                  int V, int P, int C, int dtype,
                                  void* stream) {
  const LevelGrad l0{g0, H0, W0, s0}, l1{g1, H1, W1, s1}, l2{g2, H2, W2, s2},
      l3{g3, H3, W3, s3};
  auto s = static_cast<cudaStream_t>(stream);
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int R = V * P;
  const long long tiles =
      (long long)V * (tiles_of(l0) + tiles_of(l1) + tiles_of(l2) +
                      tiles_of(l3));
  if (tiles == 0 || C == 0) return 0;
  const auto* fr = static_cast<const float*>(rois);
  auto* fb = static_cast<int4*>(box);
  auto* fl = static_cast<int*>(lvl);
  if (R > 0)
    roi_footprint_kernel<<<(R + 255) / 256, 256, 0, s>>>(l0, l1, l2, l3, fr,
                                                         R, fb, fl);
  MV2D_DISPATCH(dtype, T, {
    constexpr int VW = 16 / sizeof(T);
    const dim3 grid((unsigned)tiles, (C / VW + 31) / 32);
    roi_owner_kernel<T><<<grid, BNT, 0, s>>>(l0, l1, l2, l3, fr, fb, fl,
                                             static_cast<const T*>(dout), V,
                                             P, C);
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
