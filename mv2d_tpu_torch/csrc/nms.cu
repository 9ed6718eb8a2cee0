// Greedy 2D NMS on score-sorted boxes, the keep mask of
// core.nms._greedy_suppress_boxes with the axis-aligned IoU, with no host
// round trip: the plain version is a blocked scan whose within-block chain
// is a fixpoint tested on the host every round (a sync a round, dozens a
// forward), so nothing around it could be captured in a CUDA graph.
//
// Input boxes [R, N, 4] (x1, y1, x2, y2; float32 or bfloat16) in score
// order, valid [R, N] bool; output keep [R, N] bool.  Box j is kept when
// it is valid and no earlier kept box i < j has IoU(i, j) > thr.  The
// keep mask equals the plain version's bit for bit:
//  * the IoU is box_iou_xyxy's arithmetic in its order,
//      inter / (area_a + area_b - inter + 1e-4),
//    one IEEE round-to-nearest operation a PyTorch elementwise op (the
//    __f*_rn intrinsics, so nothing contracts into an FMA); bfloat16
//    boxes round each result to bfloat16, as PyTorch's bfloat16 ops do
//    (computed in float32, then rounded);
//  * max / min propagate NaN as torch.maximum / minimum do, and clamp
//    keeps it; a NaN IoU suppresses nothing (NaN > thr is false);
//  * thr comes rounded to the boxes' dtype (the wrapper rounds it), as
//    PyTorch rounds a Python scalar it compares a tensor with.
//
// Two kernels, one launch each:
//  1. nms_mask_kernel: a block a (row, 64-row tile, 64-column tile) of the
//     upper triangle, both tiles' boxes in registers and shared memory,
//     writes word t of row i: bit c = IoU(i, 64 t + c) > thr, for columns
//     past i only.  mask is [R, N, W] 64-bit words, W = ceil(N / 64), in
//     global memory (256 KB a row at N = 2000: more than shared memory
//     holds); the words below the diagonal tile are never written nor
//     read.
//  2. nms_sweep_kernel: a warp a row walks the boxes in order, 64 at a
//     time.  The "removed" words live in shared memory.  For chunk w the
//     warp stages rows 64w..64w+63, words w..w+31 of the mask, by cp.async
//     one chunk ahead (the loads do not depend on the decisions); every
//     lane then resolves the chunk's chain on the diagonal word alone
//     (kept = valid & !removed; a kept row ORs its diagonal word into the
//     chunk's removed word), and lane l ORs the kept rows' word w + l into
//     removed[w + l].  Words past w + 31 (N > 2048) are read from global
//     memory directly.
// Nothing is atomic and nothing depends on timing: two runs give the same
// bits.  The kernels allocate nothing (mask is the caller's scratch) and
// launch on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;       // boxes a tile, bits a word
constexpr int STAGE = 32;      // mask words staged a chunk: w .. w + 31
constexpr int MAX_WORDS = 2048;

// a PyTorch elementwise result in the boxes' dtype
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// torch.maximum / torch.minimum: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

struct Box {
  float x1, y1, x2, y2, area;
};

template <typename T>
__device__ __forceinline__ Box load_box(const T* b) {
  Box r{ld(b), ld(b + 1), ld(b + 2), ld(b + 3), 0.f};
  r.area = rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(r.x2, r.x1)),
                            rnd<T>(__fsub_rn(r.y2, r.y1))));
  return r;
}

// box_iou_xyxy(a, b) > thr, in its order of operations
template <typename T>
__device__ __forceinline__ bool iou_above(const Box& a, const Box& b,
                                          float thr) {
  float w = rnd<T>(__fsub_rn(nan_min(a.x2, b.x2), nan_max(a.x1, b.x1)));
  float h = rnd<T>(__fsub_rn(nan_min(a.y2, b.y2), nan_max(a.y1, b.y1)));
  w = w < 0.f ? 0.f : w;                   // clamp(min=0) keeps NaN
  h = h < 0.f ? 0.f : h;
  const float inter = rnd<T>(__fmul_rn(w, h));
  float den = rnd<T>(__fadd_rn(a.area, b.area));
  den = rnd<T>(__fsub_rn(den, inter));
  den = rnd<T>(__fadd_rn(den, 1e-4f));
  return rnd<T>(__fdiv_rn(inter, den)) > thr;
}

template <typename T>
__global__ void __launch_bounds__(TILE)
    nms_mask_kernel(const T* __restrict__ boxes,
                    unsigned long long* __restrict__ mask, int N, int W,
                    float thr) {
  const int ct = blockIdx.x, rt = blockIdx.y;
  if (ct < rt) return;                     // below the diagonal: unused
  const long long row = blockIdx.z;
  const T* b = boxes + row * N * 4;
  __shared__ Box cols[TILE];
  const int t = threadIdx.x;
  const int j = ct * TILE + t;
  if (j < N) cols[t] = load_box<T>(b + 4LL * j);
  __syncthreads();
  const int i = rt * TILE + t;
  if (i >= N) return;
  const Box a = load_box<T>(b + 4LL * i);
  const int n = min(TILE, N - ct * TILE);
  const int c0 = ct == rt ? t + 1 : 0;    // columns past i only
  unsigned long long word = 0;
  for (int c = c0; c < n; ++c)
    word |= (unsigned long long)iou_above<T>(a, cols[c], thr) << c;
  mask[(row * N + i) * W + ct] = word;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// rows 64w.. of chunk w, words w .. w + 31, into stage [64][STAGE]: lane l
// copies word w + l of each row (a row's 32 words are 256 contiguous bytes)
__device__ __forceinline__ void stage_chunk(
    unsigned long long* stage, const unsigned long long* m, int w, int N,
    int W, int lane) {
  const int u = w + lane;
  if (u < W) {
    const int rows = min(TILE, N - w * TILE);
    for (int t = 0; t < rows; ++t)
      cp_async8(stage + t * STAGE + lane,
                m + (long long)(w * TILE + t) * W + u);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(32)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                     const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ keep, int N, int W) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* stage = smem;                    // [2][64][STAGE]
  unsigned long long* removed = smem + 2 * TILE * STAGE;   // [W]
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + row * N * W;
  const uint8_t* v = valid + row * N;
  uint8_t* k = keep + row * N;
  for (int u = lane; u < W; u += 32) removed[u] = 0;
  stage_chunk(stage, m, 0, N, W, lane);
  for (int w = 0; w < W; ++w) {
    unsigned long long* cur_stage = stage + (w & 1) * TILE * STAGE;
    if (w + 1 < W)
      stage_chunk(stage + ((w + 1) & 1) * TILE * STAGE, m, w + 1, N, W,
                  lane);
    else
      cp_async_commit();                   // an empty group keeps the count
    const int i0 = w * TILE;
    const bool v0 = i0 + lane < N && v[i0 + lane];
    const bool v1 = i0 + 32 + lane < N && v[i0 + 32 + lane];
    const unsigned long long vbits =
        (unsigned long long)__ballot_sync(0xffffffffu, v0) |
        (unsigned long long)__ballot_sync(0xffffffffu, v1) << 32;
    cp_async_wait<1>();                    // chunk w is in
    __syncwarp();
    // the chain, in every lane alike: rows past N are not valid, so their
    // stale staged words are never taken
    unsigned long long cur = removed[w], kept = 0;
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const unsigned long long on = ((vbits & ~cur) >> t) & 1ull;
      cur |= cur_stage[t * STAGE] & (0ull - on);
      kept |= on << t;
    }
    // lane l: word w + l of the kept rows (lane 0's is the diagonal,
    // already resolved)
    const int u = w + lane;
    if (lane > 0 && u < W) {
      unsigned long long acc = 0;
#pragma unroll 16
      for (int t = 0; t < TILE; ++t)
        acc |= cur_stage[t * STAGE + lane] & (0ull - ((kept >> t) & 1ull));
      removed[u] |= acc;
    }
    for (int x = w + STAGE + lane; x < W; x += 32) {
      unsigned long long acc = 0;
      for (int t = 0; t < TILE && i0 + t < N; ++t)
        if ((kept >> t) & 1ull) acc |= m[(long long)(i0 + t) * W + x];
      removed[x] |= acc;
    }
    if (i0 + lane < N) k[i0 + lane] = (kept >> lane) & 1ull;
    if (i0 + 32 + lane < N) k[i0 + 32 + lane] = (kept >> (32 + lane)) & 1ull;
    __syncwarp();                          // before the stage is refilled
  }
  cp_async_wait<0>();
}

size_t sweep_smem(int W) {
  return sizeof(unsigned long long) * (2 * TILE * STAGE + W);
}

}  // namespace

// boxes [R, N, 4] (dtype 0 float32, 1 bfloat16), valid [R, N] bool ->
// keep [R, N] bool; mask: scratch of R * N * ceil(N / 64) 64-bit words
extern "C" int mv2d_nms_keep(const void* boxes, const void* valid,
                             void* keep, void* mask, int R, int N, float thr,
                             int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int W = (N + TILE - 1) / TILE;
  if (R < 0 || N < 0 || W > MAX_WORDS || R > 65535 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || N == 0) return static_cast<int>(cudaSuccess);
  auto* m = static_cast<unsigned long long*>(mask);
  const dim3 grid(W, W, R);
  if (dtype == 0)
    nms_mask_kernel<float><<<grid, TILE, 0, s>>>(
        static_cast<const float*>(boxes), m, N, W, thr);
  else
    nms_mask_kernel<__nv_bfloat16><<<grid, TILE, 0, s>>>(
        static_cast<const __nv_bfloat16*>(boxes), m, N, W, thr);
  // at most 48 KB (W <= MAX_WORDS): no opt-in needed
  nms_sweep_kernel<<<R, 32, sweep_smem(W), s>>>(
      m, static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), N,
      W);
  return static_cast<int>(cudaGetLastError());
}
