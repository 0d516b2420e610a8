// Shared device code of the port's kernels (paged_attention.cu,
// ragged_prefill.cu, flash_attention.cu, wq_matmul.cu): dtype traits,
// vectorised row loads, the cp.async page copy, the per-row online-softmax
// state and the mma.sync tile helpers.
//
// Page layout (standard, the only one the port uses): [NB, nkv, bs, hd];
// one (page, kv head) slab is bs*hd contiguous elements.  int8 pages
// (kv_quant) carry a [NB, nkv, bs] fp32 scale pool beside them: one scale
// per (page, head, token), dequantized as the JAX package's _dequant_page
// does — an fp32 product code * scale rounded once to the compute dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dsk {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the TPU kernels

// ---- dtype traits: raw bits <-> float, round-to-nearest-even stores ----
template <typename T> struct Bits;
template <> struct Bits<float> {
  using U = unsigned int;
  static __device__ __forceinline__ float to_f(U u) { return __uint_as_float(u); }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <> struct Bits<__half> {
  using U = unsigned short;
  static __device__ __forceinline__ float to_f(U u) { return __half2float(__ushort_as_half(u)); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ float round(float x) { return __half2float(__float2half_rn(x)); }
};
template <> struct Bits<__nv_bfloat16> {
  using U = unsigned short;
  static __device__ __forceinline__ float to_f(U u) { return __bfloat162float(__ushort_as_bfloat16(u)); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

// int8 KV codes: read as floats, dequantized by the caller (load_kv)
template <> struct Bits<int8_t> {
  using U = signed char;
  static __device__ __forceinline__ float to_f(U u) { return (float)u; }
};

// Byte j of a word of int8 codes offset by 128 (w ^ 0x80808080), as an
// exact fp32: one byte permute puts it in the mantissa of 2^23, and 2^23 +
// 128 comes off (no quarter-rate int-to-float conversion)
__device__ __forceinline__ float biased_code(uint32_t b, int j) {
  return __fsub_rn(__int_as_float(__byte_perm(b, 0x4B000000u, 0x7540 | j)), 8388736.f);
}

// widest word that divides a VEC-element row slice
template <int BYTES> struct Word { using W = unsigned short; };
template <> struct Word<1> { using W = unsigned char; };
template <> struct Word<4> { using W = unsigned int; };
template <> struct Word<8> { using W = uint2; };
template <> struct Word<16> { using W = uint4; };
template <> struct Word<32> { using W = uint4; };

// Load VEC consecutive elements (VEC*sizeof(T) bytes, naturally aligned) as
// floats with the widest vector loads the slice allows.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  using U = typename Bits<T>::U;
  constexpr int BYTES = VEC * (int)sizeof(T);
  using W = typename Word<BYTES>::W;
  constexpr int NW = BYTES / (int)sizeof(W);
  union { W w[NW]; U u[VEC]; } buf;
  const W* src = reinterpret_cast<const W*>(p);
#pragma unroll
  for (int i = 0; i < NW; ++i) buf.w[i] = src[i];
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = Bits<T>::to_f(buf.u[i]);
}

// One K or V row slice of a page held as P (= T, or int8 codes with the
// token's scale sc) as floats of T's precision.
template <typename T, typename P, int VEC>
__device__ __forceinline__ void load_kv(const P* __restrict__ p, float sc, float (&out)[VEC]) {
  load_vec<P, VEC>(p, out);
  if constexpr (!std::is_same<T, P>::value) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = Bits<T>::round(out[i] * sc);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC], float mul) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) p[i] = Bits<T>::from_f(v[i] * mul);
}

// ---- cp.async: 16-byte global -> shared copies, completed in groups ----
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The [bs] fp32 scale rows of one (page, kv head) of K and V (int8 pages);
// issued before the page's load_page, which commits them in its group.
__device__ __forceinline__ void load_scales(float* kdst, float* vdst, const float* __restrict__ kpool,
                                            const float* __restrict__ vpool, int page, int h,
                                            int nkv, int bs) {
  const size_t base = ((size_t)page * nkv + h) * (size_t)bs;
  for (int t = threadIdx.x; t < bs; t += blockDim.x) {
    cp_async4(kdst + t, kpool + base + t);
    cp_async4(vdst + t, vpool + base + t);
  }
}

// The whole block copies one (page, kv head) slab of K and V (bs*hd elements
// each, contiguous in the pool) into shared memory and commits one group.
template <typename T>
__device__ __forceinline__ void load_page(T* kdst, T* vdst, const T* __restrict__ kpool,
                                          const T* __restrict__ vpool, int page, int h,
                                          int nkv, int page_elems) {
  const size_t base = ((size_t)page * nkv + h) * (size_t)page_elems;
  const char* ks = reinterpret_cast<const char*>(kpool + base);
  const char* vs = reinterpret_cast<const char*>(vpool + base);
  char* kd = reinterpret_cast<char*>(kdst);
  char* vd = reinterpret_cast<char*>(vdst);
  const int chunks = page_elems * (int)sizeof(T) / 16;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    cp_async16(kd + 16 * c, ks + 16 * c);
    cp_async16(vd + 16 * c, vs + 16 * c);
  }
  cp_async_commit();
}

// One query row's online softmax: running max m, denominator l and the
// unnormalised output slice acc (this lane's VEC columns), all fp32.  Keys
// arrive one at a time; a masked key is simply never fed, which is the
// -1e30 masking of the TPU kernels without its exp aliasing.  The
// probability is rounded to the page dtype before the P·V product, as the
// TPU kernel's pr.astype(v.dtype); l sums the unrounded values.
template <int VEC>
struct RowState {
  float m, l, acc[VEC];
  __device__ __forceinline__ void init() {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  }
  // raise the running max to cover a coming score (or block of scores)
  __device__ __forceinline__ void rescale(float mx) {
    if (mx > m) {
      const float a = expf(m - mx);
      l *= a;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] *= a;
      m = mx;
    }
  }
  // add one key of score s <= m and value row slice v
  template <typename T>
  __device__ __forceinline__ void add(float s, const float (&v)[VEC]) {
    const float p = expf(s - m);
    l += p;
    const float pr = Bits<T>::round(p);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += pr * v[i];
  }
  template <typename T>
  __device__ __forceinline__ void update(float s, const float (&v)[VEC]) {
    rescale(s);
    add<T>(s, v);
  }
};

// ---- tensor-core tiles: mma.sync m16n8k16, 16-bit inputs, fp32 accumulate.
// Fragment layout (PTX ISA, per lane: grp = lane/4, tig = lane%4):
//   A 16x16 row-major: a0 (grp, 2tig..+1), a1 (grp+8, 2tig..), a2 (grp,
//   2tig+8..), a3 (grp+8, 2tig+8..); B 16x8: b0 (k=2tig..+1, n=grp), b1
//   (k+8); C/D 16x8: c0,c1 (grp, 2tig..+1), c2,c3 (grp+8, 2tig..+1).
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// four values rounded to T (16-bit; nearest even), one 8-byte store
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(Mma<T>::pack(v[0], v[1]), Mma<T>::pack(v[2], v[3]));
}

// Lift a kernel's dynamic shared memory cap to the device's opt-in maximum,
// once per kernel instantiation (the launch itself asks for what it needs).
template <auto kernel>
inline cudaError_t allow_dynamic_smem() {
  static cudaError_t done = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    return e;
  }();
  return done;
}

}  // namespace dsk

// Launchers return a cudaError_t as int; the wrapper turns a non-zero code
// into an exception through this (each kernel source is its own library and
// includes this header once).
extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
