// Tile helpers shared by the port's attention kernels on the tensor cores
// (flash_attention.cu, sparse_attention.cu, evoformer.cu): cp.async row
// staging into padded shared-memory rows, ldmatrix fragment loads and the
// two mma.sync products of an attention tile (scores q kT and the p v / ds k
// accumulation), on top of paged_common.cuh's dtype traits and Mma; the
// causal / window tile ranges and visibility test; and the row helpers of
// their CUDA-core variants.
#pragma once

#include "paged_common.cuh"

namespace dsk {

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// The block copies `rows` token rows of one head (hd contiguous elements
// each, token stride st) into shared memory rows of LD elements, zero-padded
// to HD columns; tokens at or past T are zero-filled.  hd % 8 == 0 (16-bit)
// or % 4 (fp32), so a 16-byte chunk is wholly real or wholly pad.  The
// caller commits the cp.async group.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ base, long long st,
                                          int row0, int rows, int Tlen, int hd = HD) {
  constexpr int EPC = 16 / (int)sizeof(T);       // elements a 16-byte chunk
  constexpr int CPR = HD / EPC;                  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CPR; c += blockDim.x) {
    const int row = c / CPR, cc = c % CPR;
    char* d = reinterpret_cast<char*>(dst + row * LD) + 16 * cc;
    const int t = row0 + row;
    if (t < Tlen && cc * EPC < hd)
      cp_async16(d, reinterpret_cast<const char*>(base + (long long)t * st) + 16 * cc);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ldmatrix: four 8x8 16-bit matrices from shared memory into fragment
// registers; lanes 8i..8i+7 give the row addresses of matrix i.  Plain: lane
// (grp, tig) gets M[grp][2tig..2tig+1]; .trans: M[2tig..2tig+1][grp].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A fragment (16 rows x 16 of head_dim, row-major shared-memory rows of ld
// elements) for k-step ks: a0 rows 0-7 / k 0-7, a1 rows 8-15, a2 k 8-15, a3.
template <typename T>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const T* rows, int ld, int ks,
                                            int lane) {
  ldsm_x4(a, rows + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ks * 16 + ((lane >> 4) << 3));
}

// B fragments whose n index is a shared-memory row and whose k index runs
// along the row (head_dim), for the two n-tiles of rows r0..r0+15 at k-step
// ks: b[0], b[1] rows r0..r0+7; b[2], b[3] rows r0+8..r0+15.
template <typename T>
__device__ __forceinline__ void load_b_rows_t(uint32_t (&b)[4], const T* rows, int ld, int r0,
                                              int ks, int lane) {
  ldsm_x4(b, rows + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + ks * 16 +
                 (((lane >> 3) & 1) << 3));
}

// acc[nt][16 x 8] += A(regs, 16 x HD) * rows[r0 + 8 nt .. +8)T, nt = 0, 1.
template <typename T, int HD, int LD>
__device__ __forceinline__ void mma_rows_t(float (&acc)[2][4], uint32_t (&a)[HD / 16][4],
                                           const T* rows, int r0, int lane) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t b[4];
    load_b_rows_t<T>(b, rows, LD, r0, ks, lane);
    Mma<T>::run(acc[0], a[ks], b[0], b[1]);
    Mma<T>::run(acc[1], a[ks], b[2], b[3]);
  }
}

// acc[d][16 x 8] += A(regs, 16 x 16) * rows[t0 .. t0+16) : the B operand's k
// index is a shared-memory row (a token), its n index a head_dim column, so
// the 8x8 blocks are loaded transposed, two head_dim tiles at a time.
template <typename T, int HD, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                         const T* rows, int t0, int lane) {
  const T* r0 = rows + (t0 + (lane & 15)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int d = 0; d < HD / 8; d += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, r0 + d * 8);
    Mma<T>::run(acc[d], a, b[0], b[1]);
    Mma<T>::run(acc[d + 1], a, b[2], b[3]);
  }
}

// CUDA-core (fp32 and wide head_dim) kernels: lane l of a warp owns the
// columns l, l + 32, ... of a row (VEC of them); columns at or past hd read
// as zero and are not stored.  warp_sum_dot: the row dot product, summed
// over the warp (every lane gets it).
template <typename T, int VEC>
__device__ __forceinline__ void ld_cols_t(const T* row, int lane, int hd, float (&r)[VEC]) {
  using U = typename Bits<T>::U;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    r[j] = lane + 32 * j < hd ? Bits<T>::to_f(reinterpret_cast<const U*>(row)[lane + 32 * j])
                              : 0.f;
}
template <typename T, int VEC>
__device__ __forceinline__ void st_cols_t(T* row, int lane, int hd, const float (&r)[VEC],
                                          float mul) {
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (lane + 32 * j < hd) row[lane + 32 * j] = Bits<T>::from_f(r[j] * mul);
}
template <int VEC>
__device__ __forceinline__ float warp_sum_dot(const float (&a)[VEC], const float (&b)[VEC]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) s += a[j] * b[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// first and last (inclusive) K tile a q tile [q0, q0 + rows) can see
__device__ __forceinline__ void k_tile_range(int q0, int rows, int T, int tile, int causal,
                                             int window, int& first, int& last) {
  const int q_last = min(q0 + rows, T) - 1;
  last = (causal ? min(q_last, T - 1) : T - 1) / tile;
  first = window > 0 ? max(q0 - window + 1, 0) / tile : 0;
}

// first and last (inclusive) q tile that can see the K tile [k0, k0 + rows)
__device__ __forceinline__ void q_tile_range(int k0, int rows, int T, int tile, int causal,
                                             int window, int& first, int& last) {
  first = causal ? k0 / tile : 0;
  const int k_last = min(k0 + rows, T) - 1;
  last = (T - 1) / tile;
  if (window > 0) last = min(last, (k_last + window - 1) / tile);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int causal, int window) {
  return qpos < T && kpos < T && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// The backward kernels take exp2f(s2 - lse2) with both in log2 units.  A row
// that saw no key (lse -1e30, or a row past T) gets +inf, so that its
// probabilities read exactly 0 with no test.
__device__ __forceinline__ float dead_or_log2(float lse) {
  return lse > kNegInf * 0.5f ? lse * kLog2e : __int_as_float(0x7f800000);
}

}  // namespace dsk
