// Hopper (sm_90a) building blocks shared by the warp-specialised kernels
// (wq_matmul.cu, paged_attention.cu's 16-bit decode, and the attention
// forwards of flash_attention.cu and evoformer.cu through
// attn_fwd_hopper.cuh, the flash backward through attn_bwd_hopper.cuh):
// mbarriers, TMA tensor copies (2-D to 5-D) and 1-D bulk copies, the
// host-side tensor-map encoding, register hand-over
// between warpgroups (setmaxnreg), and the asynchronous warpgroup products
// (wgmma) with both operands in shared memory or A in registers.
#pragma once

#include "paged_common.cuh"

#include <cuda.h>

namespace dsk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// make the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait for the phase of `parity` to complete.  The spin loop lives inside
// the asm (labels scoped by its braces), so the compiler sees no divergent
// branch here: a wgmma pipeline around the wait stays asynchronous.  A wait
// that outlasts ~10 s of SM clocks traps: a broken ring fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u64 t0, t1;\n"
      " mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " mov.u64 t1, %%clock64;\n"
      " sub.u64 t1, t1, t0;\n"
      " setp.lt.u64 p, t1, 20000000000;\n"
      " @p bra WAIT;\n"
      " trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// arrive once and expect `bytes` of tensor copies to land on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// expect `bytes` of tensor copies on the barrier without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// ------------------------------------------------------------ TMA copies
// One box of a tensor map into shared memory, completing on `bar`;
// coordinates innermost first.  Elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_u32(bar))
      : "memory");
}
// One contiguous run of `bytes` (16-byte aligned ends, a multiple of 16)
// into shared memory, completing on `bar`: no tensor map.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// arrive on `bar` once this thread's earlier cp.async copies have landed
// (the arrival counts against the barrier's expected count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// generic-proxy shared-memory writes -> visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------- register hand-over
// A warpgroup gives back (dec) or takes (inc) registers; all four of its
// warps execute it, on paths that never reconverge.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ wgmma
// Shared-memory descriptor, 128-byte swizzle (the layout a TMA box of 128-
// byte rows lands in with CU_TENSOR_MAP_SWIZZLE_128B): 8 rows of 128 bytes
// form a 1024-byte atom, atoms of consecutive 8-row groups 1024 bytes apart
// (SBO).  K-major (rows = M or N, 64 16-bit k a row): the start steps 32
// bytes a k16.  MN-major (rows = k, 64 16-bit m or n a row; transpose bit
// set): 16 rows a k16, the start steps 2048 bytes; one instruction reads
// one 64-wide atom column (n <= 64), so the leading offset is unused.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// The same for RB-byte rows in the RB-byte swizzle (RB 128: wg_desc; RB 64:
// 8 rows of 64 bytes form a 512-byte atom, the layout code 2), K-major.
template <int RB>
__device__ __forceinline__ uint64_t wg_desc_rb(const void* p) {
  static_assert(RB == 64 || RB == 128, "swizzle width");
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * RB >> 4) << 32) | ((uint64_t)(RB == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers here: no read or write of them moves across a wgmma fence,
// commit or wait
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}
template <int N>
__device__ __forceinline__ void wg_fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) : : "memory");
}

#define DSK_ACC8(b)                                                                    \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),      \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define DSK_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define DSK_REGS16                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DSK_REGS32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DSK_REGS64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define DSK_ACC16 DSK_ACC8(0), DSK_ACC8(8)
#define DSK_ACC32 DSK_ACC8(0), DSK_ACC8(8), DSK_ACC8(16), DSK_ACC8(24)
#define DSK_ACC64 DSK_ACC32, DSK_ACC8(32), DSK_ACC8(40), DSK_ACC8(48), DSK_ACC8(56)

// d[64 x N] (+)= A[64 x 16] * B[N x 16]^T, both K-major in shared memory
// (acc = 0: d is overwritten).  Accumulator layout: warp w of the warpgroup
// holds rows 16w..16w+15, each n8 slice j as mma.sync's C fragment:
// d[4j + 2h + e] = (row 16w + lane/4 + 8h, column 8j + 2(lane%4) + e).
#define DSK_WGMMA_SS128(TY)                                                            \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                         \
               " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " DSK_REGS64 \
               ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                       \
               : DSK_ACC64                                                             \
               : "l"(da), "l"(db), "r"(acc))
#define DSK_WGMMA_SS64(TY)                                                             \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                         \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSK_REGS32  \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                       \
               : DSK_ACC32                                                             \
               : "l"(da), "l"(db), "r"(acc))
#define DSK_WGMMA_SS32(TY)                                                             \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"                         \
               " wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " DSK_REGS16  \
               ", %16, %17, p, 1, 1, 0, 0;\n}\n"                                       \
               : DSK_ACC16                                                             \
               : "l"(da), "l"(db), "r"(acc))
#define DSK_WGMMA_SS16(TY)                                                             \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"                         \
               " wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " DSK_REGS8   \
               ", %8, %9, p, 1, 1, 0, 0;\n}\n"                                         \
               : DSK_ACC8(0)                                                           \
               : "l"(da), "l"(db), "r"(acc))
// d[64 x 64] += A[64 x 16] (registers: mma.sync's A fragment of each warp's
// 16 rows) * B[16 x 64], B MN-major in shared memory (transpose bit)
#define DSK_WGMMA_RS64(TY)                                                             \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                         \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSK_REGS32  \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                          \
               : DSK_ACC32                                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T> struct Wgmma;
#define DSK_WGMMA_STRUCT(T, TY)                                                         \
  template <> struct Wgmma<T> {                                                         \
    static __device__ __forceinline__ void ss128(float (&d)[64], uint64_t da,           \
                                                 uint64_t db, int acc = 1) {            \
      DSK_WGMMA_SS128(TY);                                                              \
    }                                                                                   \
    static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t da,            \
                                                uint64_t db, int acc = 1) {             \
      DSK_WGMMA_SS64(TY);                                                               \
    }                                                                                   \
    static __device__ __forceinline__ void ss32(float (&d)[16], uint64_t da,            \
                                                uint64_t db, int acc = 1) {             \
      DSK_WGMMA_SS32(TY);                                                               \
    }                                                                                   \
    static __device__ __forceinline__ void ss16(float (&d)[8], uint64_t da,             \
                                                uint64_t db, int acc = 1) {             \
      DSK_WGMMA_SS16(TY);                                                               \
    }                                                                                   \
    static __device__ __forceinline__ void rs64(float (&d)[32], const uint32_t (&a)[4], \
                                                uint64_t db) {                          \
      DSK_WGMMA_RS64(TY);                                                               \
    }                                                                                   \
  };
DSK_WGMMA_STRUCT(__nv_bfloat16, "bf16")
DSK_WGMMA_STRUCT(__half, "f16")
#undef DSK_WGMMA_STRUCT
#undef DSK_WGMMA_RS64
#undef DSK_WGMMA_SS64
#undef DSK_WGMMA_SS32
#undef DSK_WGMMA_SS16
#undef DSK_WGMMA_SS128
#undef DSK_ACC64
#undef DSK_ACC32
#undef DSK_ACC16
#undef DSK_REGS64
#undef DSK_REGS32
#undef DSK_REGS16
#undef DSK_REGS8
#undef DSK_ACC8

// ------------------------------------------------------- host: tensor maps
// cuTensorMapEncodeTiled from libcuda, looked up through the runtime's
// entry-point query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a 2-D row-major [rows, cols] tensor of `elem`-byte elements, read in
// [box_rows, box_cols] tiles, out-of-bounds elements zero-filled
inline bool tensor_map(CUtensorMap* m, CUtensorMapDataType dt, int elem, const void* base,
                       long long rows, long long cols, int box_rows, int box_cols,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(m, dt, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An R-dimensional strided tensor (R <= 5; dims and element strides
// innermost first, the innermost stride 1), read in boxes of `box`.  A dim
// of size 1 or stride 0 (a broadcast) is collapsed to size 1 and its bit
// set in *collapsed: the kernel then passes coordinate 0 for it.  False if
// the driver refuses the map (a base or stride not 16-byte aligned).
inline bool tensor_map_nd(CUtensorMap* m, CUtensorMapDataType dt, int elem, const void* base,
                          int rank, const long long* dims, const long long* strides,
                          const int* box, CUtensorMapSwizzle swizzle, int* collapsed) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rank < 1 || rank > 5 || strides[0] != 1) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], step[5];
  *collapsed = 0;
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    step[i] = 1;
    if (i == 0) continue;
    s[i - 1] = (cuuint64_t)strides[i] * elem;
    if (dims[i] == 1 || strides[i] == 0) {
      d[i] = 1;
      s[i - 1] = 16;  // never stepped
      *collapsed |= 1 << i;
    }
  }
  return fn(m, dt, rank, const_cast<void*>(base), d, s, b, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace dsk
