// Tensor-core and async-copy helpers of the bfloat16 kernels (K1, K2, K4,
// B8, B10, B13) and of B11 / B12's streamed core: cp.async into shared
// memory, non-coherent 16-byte loads, ldmatrix, mma.sync.m16n8k16, the
// 128-byte swizzle, mbarriers, TMA tensor copies and the host's encoders of
// their tensor maps, and the warpgroup product wgmma (bf16 in, float32
// accumulate).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mv2d {
namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// async copy of `n` (4, 8 or 16) bytes global -> shared; with ok false the
// destination is filled with zeros and nothing is read
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N), "r"(ok ? N : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory, lanes 8i..8i+7 giving the row
// addresses of matrix i: with rows [m][k], the A fragment of mma_bf16
// (lane l: row l % 16, 8-column group l / 16)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// the same, transposed: with rows [k][n] (lane l: row k0 + l % 16,
// 8-column group n / 8 + l / 16), the B fragments of two n8 tiles,
// (r[0], r[1]) and (r[2], r[3])
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of read-only global memory; volatile, so that it is issued
// where it is written (ahead of the products it overlaps)
__device__ __forceinline__ uint4 ldg_nc_v4(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// offset of 16-byte group c of row r among 128-byte rows (64 bf16
// channels), swizzled as TMA's SWIZZLE_128B lays them (1024-byte aligned
// base): ldmatrix's eight rows of one matrix fall on distinct banks for any
// eight consecutive rows, and wgmma's 128-byte-swizzle descriptors read it
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// ---- mbarriers and TMA (sm_90)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// this thread's arrival, expecting `bytes` more from async copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// this thread's arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// waits until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// mbarrier initialisation made visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a 2D box of the tensor map at (x inner, y outer) into shared memory at
// dst, completing its bytes on the mbarrier
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// a 4D box at (c0 innermost .. c3) into shared memory at dst; coordinates
// may be negative or run past the tensor, whose missing elements arrive
// as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// a 2D box from shared memory at src to the tensor at (x inner, y outer);
// the part of the box outside the tensor is not written.  The copy joins
// this thread's open bulk group
__device__ __forceinline__ void tma_store_2d(const void* tmap, int x, int y,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];\n" ::"l"(tmap),
      "r"(x), "r"(y), "r"(smem_u32(src))
      : "memory");
}

// a 4D box from shared memory at src to the tensor at (c0 .. c3); the
// part of the box outside the tensor is not written.  The copy joins this
// thread's open bulk group
__device__ __forceinline__ void tma_store_4d(const void* tmap, int c0,
                                             int c1, int c2, int c3,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(tmap),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's bulk groups have not yet read
// their shared memory (READ) or not yet completed
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled, a libcuda function, found through the runtime's
// entry-point query (no link against libcuda); null where it is missing
typedef CUresult (*TmapEncode)(CUtensorMap*, CUtensorMapDataType,
                               cuuint32_t, void*, const cuuint64_t*,
                               const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave,
                               CUtensorMapSwizzle, CUtensorMapL2promotion,
                               CUtensorMapFloatOOBfill);

inline TmapEncode tmap_encode() {
  static TmapEncode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TmapEncode>(p);
  }
  return fn;
}

// a bf16 tensor map, 128-byte swizzled, read or written in boxes of 64
// innermost elements; missing elements of a box arrive as zeros
inline bool encode_bf16(CUtensorMap* map, const void* p, int rank,
                        const cuuint64_t* dims, const cuuint32_t* box) {
  TmapEncode encode = tmap_encode();
  if (encode == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t run = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = run *= dims[i];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major [rows, cols] bf16 matrix, read in (64, box_rows) boxes
inline bool encode_rows(CUtensorMap* map, const void* p, long long rows,
                        int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_bf16(map, p, 2, dims, box);
}

// a [V, H, W, C] bf16 tensor, read or written in (64, bw, bh, 1) boxes
inline bool encode_nhwc(CUtensorMap* map, const void* p, int V, int H, int W,
                        int C, int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)V};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return encode_bf16(map, p, 4, dims, box);
}

// a [V, H, W, C] tensor of float32 (`bytes` 4) or bf16 (2), unswizzled,
// read in (cb, bw, bh, 1) boxes that land densely in shared memory (cb
// elements a cell, cb * bytes a multiple of 16, cb <= 256); missing
// elements of a box arrive as zeros
inline bool encode_nhwc_dense(CUtensorMap* map, const void* p, int bytes,
                              int V, int H, int W, int C, int cb, int bw,
                              int bh) {
  TmapEncode encode = tmap_encode();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)V};
  const cuuint64_t row = (cuuint64_t)C * bytes;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)cb, (cuuint32_t)bw, (cuuint32_t)bh,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- wgmma (sm_90a): a warpgroup's asynchronous m64nNk16 product,
// D [64 x N] float32 (+)= A [64 x 16] B [16 x N], both operands in shared
// memory, named by matrix descriptors.  D's registers: n8 tile j of warp w
// of the warpgroup in d[4j .. 4j + 3], laid out as mma.sync's C (rows
// 16w + lane / 4 and + 8, columns 8j + 2 (lane % 4) and + 1).

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous product
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// descriptor of a 128-byte-swizzled tile at p (1024-byte aligned atoms):
// lbo / sbo the byte offsets between atoms along the leading / strided
// dimension (for a K-major operand, sbo between 8-row groups; for an
// MN-major one, lbo between 64-element column groups, sbo between 8-row
// groups along K)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

#define MV2D_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MV2D_D16(i) MV2D_D4(i), MV2D_D4(i + 4), MV2D_D4(i + 8), MV2D_D4(i + 12)
#define MV2D_D32(i) MV2D_D16(i), MV2D_D16(i + 16)
#define MV2D_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define MV2D_R64                                                           \
  MV2D_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"
#define MV2D_R128                                                          \
  MV2D_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "  \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "    \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, " \
  "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127"

// D += A B, bf16 in, both operands in shared memory: TA / TB 0 for a
// K-major operand, 1 for an MN-major one (imm-trans-a / imm-trans-b)
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_ss: N 64/128/256");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MV2D_R32
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : MV2D_D32(0)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MV2D_R64
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : MV2D_D32(0), MV2D_D32(32)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MV2D_R128
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : MV2D_D32(0), MV2D_D32(32), MV2D_D32(64), MV2D_D32(96)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

// D [64 x N] += A B with A from registers (each warp of the warpgroup its
// 16 rows, as mma_bf16's A fragment) and B MN-major (imm-trans-b 1)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N 64/128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MV2D_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : MV2D_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MV2D_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : MV2D_D32(0), MV2D_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// keeps the compiler from reusing a register the asynchronous product
// still reads
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#undef MV2D_R128
#undef MV2D_R64
#undef MV2D_R32
#undef MV2D_D32
#undef MV2D_D16
#undef MV2D_D4

}  // namespace tc
}  // namespace mv2d
