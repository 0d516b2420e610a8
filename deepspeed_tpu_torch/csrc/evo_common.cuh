// Device code shared by the evoformer forward (evoformer.cu) and backward
// (evoformer_bwd.cu): the argument block, the strided bias loads, the
// cp.async row staging with a padded head_dim, and the one logit formula
// both directions use.
#pragma once

#include "flash_common.cuh"

namespace dsk {

struct EvoArgs {
  const void *q, *k, *v, *b1, *b2;
  void* o;
  float* lse_out;
  // backward: do [B, N, S, H, D] contiguous in q's dtype; lse and delta =
  // rowsum(o * do) [B*N, H, S] fp32; dq, dk, dv [B, N, S, H, D] contiguous;
  // db1_part [B*N, H, S] (per-head column sums of ds), db1 [B*N, S] and
  // db2 [B, H, S, S] fp32
  const void* dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float *db1_part, *db1, *db2;
  int B, N, S, H, D;
  long long q_sb, q_sn, q_ss, q_sh, k_sb, k_sn, k_ss, k_sh, v_sb, v_sn, v_ss, v_sh;
  long long b1_sb, b1_sn, b1_sk;         // bias1 viewed [B, N, S]
  long long b2_sb, b2_sh, b2_sq, b2_sk;  // bias2 viewed [B, H, S, S]
  int b1_code, b2_code;                  // -1 absent, 0 fp32, 1 fp16, 2 bf16
  float scale;
};

constexpr int kEvoTile = 64, kEvoWarps = 4;
// the CUDA-core family (fp32 inputs; 16-bit at head_dim above 128): one
// warp a query (key) row, 8 rows a block
constexpr int kEvoSimtWarps = 8;

__device__ __forceinline__ float load_bias(const void* p, long long i, int code) {
  if (code == 0) return static_cast<const float*>(p)[i];
  if (code == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// The logit of one (query, key) pair from its fp32 q . k product, in the
// reference's order and in natural units (_tile_scores): (q . k) * scale,
// then + bias1, then + bias2.  The forward and every backward kernel call
// this one function, so a recomputed logit rounds as the forward's did: at
// a -1e9 mask the fp32 spacing is 64, and another order moves the logit by
// whole steps of it.  b1o / b2o are the (batch, row) and (batch, head)
// offsets of the two biases; a caller that holds the bias values already
// passes them to evo_logit_v.
// Each step is rounded on its own (no fused multiply-add), as the
// reference's separate operations round.
__device__ __forceinline__ float evo_logit_s(float qk, float scale, bool has1, float b1,
                                             bool has2, float b2) {
  float s = __fmul_rn(qk, scale);
  if (has1) s = __fadd_rn(s, b1);
  if (has2) s = __fadd_rn(s, b2);
  return s;
}
__device__ __forceinline__ float evo_logit_v(const EvoArgs& p, float qk, float b1, float b2) {
  return evo_logit_s(qk, p.scale, p.b1_code >= 0, b1, p.b2_code >= 0, b2);
}
__device__ __forceinline__ float bias1_at(const EvoArgs& p, long long b1o, int kpos) {
  return load_bias(p.b1, b1o + kpos * p.b1_sk, p.b1_code);
}
__device__ __forceinline__ float bias2_at(const EvoArgs& p, long long b2o, int qpos, int kpos) {
  return load_bias(p.b2, b2o + qpos * p.b2_sq + kpos * p.b2_sk, p.b2_code);
}
__device__ __forceinline__ float evo_logit(const EvoArgs& p, float qk, long long b1o,
                                           long long b2o, int qpos, int kpos) {
  return evo_logit_s(qk, p.scale, p.b1_code >= 0,
                     p.b1_code >= 0 ? bias1_at(p, b1o, kpos) : 0.f, p.b2_code >= 0,
                     p.b2_code >= 0 ? bias2_at(p, b2o, qpos, kpos) : 0.f);
}

// The block copies `rows` token rows (D contiguous elements each, token
// stride st) into shared-memory rows of LD elements; tokens at or past S
// are zero-filled.  Columns D..HDP of the rows are zeroed once by the
// caller and never written here.  The caller commits the cp.async group.
template <typename T, int LD>
__device__ __forceinline__ void load_rows_d(T* dst, const T* __restrict__ base, long long st,
                                            int row0, int rows, int S, int D) {
  const int cpr = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
    const int row = c / cpr, cc = c % cpr;
    char* d = reinterpret_cast<char*>(dst + row * LD) + 16 * cc;
    const int t = row0 + row;
    if (t < S)
      cp_async16(d, reinterpret_cast<const char*>(base + (long long)t * st) + 16 * cc);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Zero the head_dim pad (columns D..HDP) of `rows` consecutive shared-memory
// rows of LD 16-bit elements starting at buf.
template <int LD>
__device__ __forceinline__ void zero_pad_cols(void* buf, int rows, int D, int HDP) {
  if (D >= HDP) return;
  unsigned short* raw = static_cast<unsigned short*>(buf);
  for (int i = threadIdx.x; i < rows * (HDP - D); i += blockDim.x) {
    const int row = i / (HDP - D), c = D + i % (HDP - D);
    raw[row * LD + c] = 0;
  }
}

}  // namespace dsk
