// Evoformer attention forward on Hopper (sm_90a).
//
// Replaces the TPU kernel of deepspeed_tpu/ops/evoformer.py:
//   _fwd_kernel (launched by _fwd) -> attn_fwd_kernel<..., EVO = true>
//   (16-bit, D up to 128; its design in attn_fwd_hopper.cuh), evo_fwd_simt
//   (fp32, and D above 128)
// Same function: for q, k, v [B, N, S, H, D] (N: MSA rows or residue pairs),
//   o = softmax(q kT * D^-1/2 + bias1 + bias2) v,   bias1 [B, N, 1, 1, S]
//   (per-key mask bias), bias2 [B, 1, H, S, S] (pair bias shared over N),
// with the per-row logsumexp saved for the backward (lse [B*N, H, S] fp32).
// The logits are summed in the reference's order, all in fp32: (q . k) *
// scale, then + bias1, then + bias2 (_tile_scores; evo_logit_s, which the
// backward kernels call too).  The order matters: a -1e9 mask bias puts a
// fully masked row's logits where the fp32 spacing is 64, and such a row
// agrees with the reference only if its logits round the same way.  A row
// whose running maximum stays at -1e30 gives probabilities 0 (the
// reference's guard), o = 0 and lse -1e30.
//
// What bounds it on the H100: bytes and exponentials at AlphaFold2's
// widths.  With D = 32 a (query, key) pair costs 4*D = 128 flops and one
// exp, while q, k, v, o are read or written once per element and bias2
// once per (head, query, key).  The tensor-core forward keeps the logits
// and the staged biases out of device memory, reads each (row, head)'s K
// and V once from it (its q tiles run one after another), and stages the
// bias2 tile by TMA beside K and V instead of 2-byte loads per logit.
// q, k, v and both biases are read through their strides: the [B, N, S,
// H, D] layout needs no transpose, and a broadcast bias (stride 0 over N,
// or over B) is never materialised.  Any S: keys past S are masked, rows
// past S are not written.
#include "attn_fwd_hopper.cuh"

namespace dsk {

// ------------------------------------------------- CUDA-core family (simt)
// fp32 inputs at any head_dim, and 16-bit inputs at head_dim above 128
// (where the tensor-core accumulators would not fit the registers): one warp
// a query row, lane l owning the columns l, l + 32, ... (VEC = HD / 32, the
// pad past D zero); keys one at a time straight from device memory through
// the same logit function and the online softmax of RowState (p rounded to
// T before p v, l summing the unrounded p).
template <typename T, int HD>
__global__ void __launch_bounds__(kEvoSimtWarps * 32) evo_fwd_simt(EvoArgs p) {
  constexpr int VEC = HD / 32;
  const int bn = blockIdx.x, h = blockIdx.z;
  const int b = bn / p.N, n = bn % p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qpos = blockIdx.y * kEvoSimtWarps + warp;
  if (qpos >= p.S) return;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + h * p.v_sh;
  const long long b1o = b * p.b1_sb + n * p.b1_sn;
  const long long b2o = b * p.b2_sb + h * p.b2_sh;
  float qr[VEC];
  ld_cols_t<T, VEC>(qb + qpos * p.q_ss, lane, p.D, qr);
  RowState<VEC> st;
  st.init();
  for (int kpos = 0; kpos < p.S; ++kpos) {
    float kr[VEC], vr[VEC];
    ld_cols_t<T, VEC>(kb + kpos * p.k_ss, lane, p.D, kr);
    ld_cols_t<T, VEC>(vb + kpos * p.v_ss, lane, p.D, vr);
    st.template update<T>(evo_logit(p, warp_sum_dot<VEC>(qr, kr), b1o, b2o, qpos, kpos), vr);
  }
  const float ll = st.l == 0.f ? 1.f : st.l;
  st_cols_t<T, VEC>(static_cast<T*>(p.o) + (((long long)bn * p.S + qpos) * p.H + h) * p.D, lane,
                    p.D, st.acc, 1.f / ll);
  if (lane == 0) p.lse_out[((long long)bn * p.H + h) * p.S + qpos] = st.m + logf(ll);
}

template <typename T, int HD>
cudaError_t launch_evo_simt(const EvoArgs& a, cudaStream_t st) {
  const dim3 grid(a.B * a.N, (a.S + kEvoSimtWarps - 1) / kEvoSimtWarps, a.H);
  evo_fwd_simt<T, HD><<<grid, kEvoSimtWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

// The 16-bit forward on attn_fwd_kernel (attn_fwd_hopper.cuh): q, k, v
// [B, N, S, H, D] as 5-D tensor maps (D, head, token, row, batch) read in
// boxes of [rows, 64 columns] in the 128-byte swizzle, the columns past D
// zero-filled; bias2 [B, H, S, S] as a 4-D map in boxes of [128 queries,
// 128 bytes of keys] where its layout allows (keys contiguous, 16-byte
// aligned base and strides, queries not broadcast), else staged element by
// element.
template <typename T, int HD>
cudaError_t launch_evo_wgmma(const EvoArgs& a, int stages, int qslots, cudaStream_t st) {
  constexpr int BN = HD <= 64 ? 128 : 64;
  FwdArgs p{};
  p.o = a.o;
  p.lse = a.lse_out;
  p.B = a.B * a.N; p.T = a.S; p.N = a.H; p.Nkv = a.H; p.hd = a.D; p.rows = a.N;
  p.stages = stages; p.qslots = qslots;
  p.scale = a.scale;
  p.b1 = a.b1; p.b1_sb = a.b1_sb; p.b1_sn = a.b1_sn; p.b1_sk = a.b1_sk; p.b1_code = a.b1_code;
  p.b2 = a.b2; p.b2_sb = a.b2_sb; p.b2_sh = a.b2_sh; p.b2_sq = a.b2_sq; p.b2_sk = a.b2_sk;
  p.b2_code = a.b2_code;
  const long long dims[5] = {a.D, a.H, a.S, a.N, a.B};
  const long long sq[5] = {1, a.q_sh, a.q_ss, a.q_sn, a.q_sb},
                  sk[5] = {1, a.k_sh, a.k_ss, a.k_sn, a.k_sb},
                  sv[5] = {1, a.v_sh, a.v_ss, a.v_sn, a.v_sb};
  const int box_q[5] = {64, 1, kFwdRows, 1, 1}, box_kv[5] = {64, 1, BN, 1, 1};
  CUtensorMap tmq{}, tmk{}, tmv{}, tmb2{};
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_nd(&tmq, tma_dtype<T>(), 2, a.q, 5, dims, sq, box_q, sw, &p.cq) ||
      !tensor_map_nd(&tmk, tma_dtype<T>(), 2, a.k, 5, dims, sk, box_kv, sw, &p.ck) ||
      !tensor_map_nd(&tmv, tma_dtype<T>(), 2, a.v, 5, dims, sv, box_kv, sw, &p.cv))
    return cudaErrorInvalidValue;
  if (a.b2_code >= 0) {
    const int esz = a.b2_code == 0 ? 4 : 2;
    const CUtensorMapDataType dt = a.b2_code == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : a.b2_code == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const long long d2[4] = {a.S, a.S, a.H, a.B}, s2[4] = {a.b2_sk, a.b2_sq, a.b2_sh, a.b2_sb};
    const int box2[4] = {128 / esz, kFwdRows, 1, 1};
    // a bias2 broadcast over queries (query stride 0) collapses that dim to
    // one row, which a box of 128 rows cannot read: element by element
    p.b2_tma = (reinterpret_cast<uintptr_t>(a.b2) % 16 == 0) &&
               tensor_map_nd(&tmb2, dt, esz, a.b2, 4, d2, s2, box2, sw, &p.cb2) &&
               (!(p.cb2 & 2) || a.S == 1);
  }
  return launch_attn_fwd<T, HD, BN, true>(p, tmq, tmk, tmv, tmb2, st);
}

template <typename T>
cudaError_t launch_evo_d(const EvoArgs& a, int stages, int qslots, cudaStream_t st) {
  if (a.D <= 16) return launch_evo_wgmma<T, 16>(a, stages, qslots, st);
  if (a.D <= 32) return launch_evo_wgmma<T, 32>(a, stages, qslots, st);
  if (a.D <= 64) return launch_evo_wgmma<T, 64>(a, stages, qslots, st);
  if (a.D <= 128) return launch_evo_wgmma<T, 128>(a, stages, qslots, st);
  return launch_evo_simt<T, 256>(a, st);
}

inline cudaError_t launch_evo_f32(const EvoArgs& a, cudaStream_t st) {
  if (a.D <= 64) return launch_evo_simt<float, 64>(a, st);
  if (a.D <= 128) return launch_evo_simt<float, 128>(a, st);
  return launch_evo_simt<float, 256>(a, st);
}

}  // namespace dsk

// q, k, v [B, N, S, H, D] read through element strides (batch, row, token,
// head; D contiguous, every stride a multiple of 8 elements); o [B, N, S, H,
// D] contiguous; lse [B*N, H, S] fp32; bias1 through strides (batch, row,
// key) and bias2 through (batch, head, query, key), either may be null
// (code -1).  dtype: 0 fp32, 1 fp16, 2 bf16; bias codes 0 fp32, 1 fp16,
// 2 bf16.  D: a multiple of 8 up to 256.  stages, qslots: the 16-bit
// forward's ring depth and Q slots (ops/evoformer.py evo_fwd_plan).
extern "C" int ds_evoformer_fwd(const void* q, const void* k, const void* v, const void* b1,
                                const void* b2, void* o, void* lse, int B, int N, int S, int H,
                                int D, const long long* qkv_strides,
                                const long long* bias_strides, int b1_code, int b2_code,
                                float scale, int stages, int qslots, int dtype, void* stream) {
  if (B < 1 || N < 1 || S < 1 || H < 1 || H > 65535 || D < 8 || D > 256 || D % 8 != 0 ||
      (S + dsk::kEvoSimtWarps - 1) / dsk::kEvoSimtWarps > 65535 ||
      (long long)B * N > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  dsk::EvoArgs a{};
  a.q = q; a.k = k; a.v = v; a.b1 = b1; a.b2 = b2;
  a.o = o; a.lse_out = static_cast<float*>(lse);
  a.B = B; a.N = N; a.S = S; a.H = H; a.D = D;
  const long long* s = qkv_strides;
  a.q_sb = s[0]; a.q_sn = s[1]; a.q_ss = s[2]; a.q_sh = s[3];
  a.k_sb = s[4]; a.k_sn = s[5]; a.k_ss = s[6]; a.k_sh = s[7];
  a.v_sb = s[8]; a.v_sn = s[9]; a.v_ss = s[10]; a.v_sh = s[11];
  const long long* t = bias_strides;
  a.b1_sb = t[0]; a.b1_sn = t[1]; a.b1_sk = t[2];
  a.b2_sb = t[3]; a.b2_sh = t[4]; a.b2_sq = t[5]; a.b2_sk = t[6];
  a.b1_code = b1 != nullptr ? b1_code : -1;
  a.b2_code = b2 != nullptr ? b2_code : -1;
  a.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dsk::launch_evo_f32(a, st);
  if (dtype == 1) return (int)dsk::launch_evo_d<__half>(a, stages, qslots, st);
  if (dtype == 2) return (int)dsk::launch_evo_d<__nv_bfloat16>(a, stages, qslots, st);
  return (int)cudaErrorInvalidValue;
}
