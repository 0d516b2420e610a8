// Evoformer attention forward on Hopper (sm_90a).
//
// Replaces the TPU kernel of deepspeed_tpu/ops/evoformer.py:
//   _fwd_kernel (launched by _fwd) -> evo_fwd_kernel
// Same function: for q, k, v [B, N, S, H, D] (N: MSA rows or residue pairs),
//   o = softmax(q kT * D^-1/2 + bias1 + bias2) v,   bias1 [B, N, 1, 1, S]
//   (per-key mask bias), bias2 [B, 1, H, S, S] (pair bias shared over N),
// with the per-row logsumexp saved for the backward (lse [B*N, H, S] fp32).
// The logits are summed in the reference's order, all in fp32: (q . k) *
// scale, then + bias1, then + bias2 (_tile_scores).  The order matters: a
// -1e9 mask bias puts a fully masked row's logits where the fp32 spacing is
// 64, and such a row agrees with the reference only if its logits round the
// same way.  A row whose running maximum stays at -1e30 gives probabilities
// 0 (the reference's guard), o = 0 and lse -1e30.
//
// What bounds it on the H100: bytes at AlphaFold2's widths.  With D = 32 a
// (query, key) pair costs 4*D = 128 flops while q, k, v, o are read or
// written once per element and bias2 once per (head, query, key) - about
// 190 flops a byte at N_res 384, under the card's ~295 flop/byte line.
// What the design does about it:
//   - one block per (batch * MSA row, 64-query tile, head), 4 warps x 16
//     query rows; the key loop runs inside the block over 64-key tiles
//     staged through shared memory with 16-byte cp.async, double buffered.
//     blockIdx.x walks the N MSA rows fastest, so the blocks in flight at
//     one time share the same (head, query tile) and read the same bias2
//     tile from L2: bias2 crosses device memory about once.
//   - q, k, v and both biases are read through their strides: the
//     [B, N, S, H, D] layout needs no transpose, and a broadcast bias
//     (stride 0 over N, or over B) is never materialised.
//   - both products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulate); head_dim D (any multiple of 8 up to 128) is padded to
//     HDP in {16, 32, 64, 128} with zeros in shared memory and registers.
//     fp32 inputs, and 16-bit inputs with D above 128, take evo_fwd_simt, a
//     CUDA-core variant through the same logit function.
//   - any S: keys past S in the last tile are dropped, rows past S are not
//     written.
#include "evo_common.cuh"

namespace dsk {

template <typename T, int HDP>
__global__ void __launch_bounds__(kEvoWarps * 32) evo_fwd_kernel(EvoArgs p) {
  constexpr int KSTEPS = HDP / 16, DTILES = HDP / 8, LD = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kbuf = reinterpret_cast<T*>(smem);  // [2][kEvoTile*LD]
  T* vbuf = kbuf + 2 * kEvoTile * LD;    // [2][kEvoTile*LD]

  const int bn = blockIdx.x, qt = blockIdx.y, h = blockIdx.z;
  const int b = bn / p.N, n = bn % p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int q0 = qt * kEvoTile;
  const int D = p.D;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + h * p.v_sh;
  const long long b1o = b * p.b1_sb + n * p.b1_sn;
  const long long b2o = b * p.b2_sb + h * p.b2_sh;

  // the padded head_dim columns of all four staging buffers read as zeros
  if (D < HDP) {
    unsigned short* raw = reinterpret_cast<unsigned short*>(smem);
    for (int i = threadIdx.x; i < 4 * kEvoTile * (HDP - D); i += blockDim.x) {
      const int row = i / (HDP - D), c = D + i % (HDP - D);
      raw[row * LD + c] = 0;
    }
  }

  int qpos[2];
  bool exists[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + warp * 16 + grp + 8 * i;
    exists[i] = qpos[i] < p.S;
  }
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;
      const int col = ks * 16 + 2 * tig + 8 * (j >> 1);
      qa[ks][j] = (exists[i] && col < D)
                      ? *reinterpret_cast<const uint32_t*>(qb + qpos[i] * p.q_ss + col)
                      : 0u;
    }
  float acc[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[d][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int nkt = (p.S + kEvoTile - 1) / kEvoTile;
  load_rows_d<T, LD>(kbuf, kb, p.k_ss, 0, kEvoTile, p.S, D);
  load_rows_d<T, LD>(vbuf, vb, p.v_ss, 0, kEvoTile, p.S, D);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    const int bsel = kt & 1;
    if (kt + 1 < nkt) {
      load_rows_d<T, LD>(kbuf + (bsel ^ 1) * kEvoTile * LD, kb, p.k_ss, (kt + 1) * kEvoTile,
                         kEvoTile, p.S, D);
      load_rows_d<T, LD>(vbuf + (bsel ^ 1) * kEvoTile * LD, vb, p.v_ss, (kt + 1) * kEvoTile,
                         kEvoTile, p.S, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // also orders the pad zeroing before the first reads
    const T* ks_ = kbuf + bsel * kEvoTile * LD;
    const T* vs_ = vbuf + bsel * kEvoTile * LD;
    for (int t0 = 0; t0 < kEvoTile; t0 += 16) {
      const int kv0 = kt * kEvoTile + t0;
      if (kv0 >= p.S) break;
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
      mma_rows_t<T, HDP, LD>(sc, qa, ks_, t0, lane);
      // natural-unit logits in the reference's order; a key past S or a
      // row past S is absent (-1e30, probability 0 below)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const int kpos = kv0 + nt * 8 + 2 * tig + (j & 1);
          float s = kNegInf;
          if (exists[i] && kpos < p.S) s = evo_logit(p, sc[nt][j], b1o, b2o, qpos[i], kpos);
          sc[nt][j] = s;
          mx[i] = fmaxf(mx[i], s);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mnew = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f((m[i] - mnew) * kLog2e);
        m[i] = mnew;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const int kpos = kv0 + nt * 8 + 2 * tig + (j & 1);
          // a row whose maximum is still -1e30 must not alias exp(0) to 1
          const float pr = (exists[i] && kpos < p.S && m[i] > 0.5f * kNegInf)
                               ? exp2f((sc[nt][j] - m[i]) * kLog2e)
                               : 0.f;
          sc[nt][j] = pr;
          psum[i] += pr;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + psum[i];
#pragma unroll
      for (int d = 0; d < DTILES; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }
      const uint32_t pa[4] = {Mma<T>::pack(sc[0][0], sc[0][1]), Mma<T>::pack(sc[0][2], sc[0][3]),
                              Mma<T>::pack(sc[1][0], sc[1][1]), Mma<T>::pack(sc[1][2], sc[1][3])};
      mma_rows<T, HDP, LD>(acc, pa, vs_, t0, lane);
    }
    __syncthreads();  // buffer bsel is refilled by the next iteration's copy
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* ob = static_cast<T*>(p.o) + ((long long)bn * p.S * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!exists[i]) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / li;
    T* orow = ob + (long long)qpos[i] * p.H * D;
#pragma unroll
    for (int d = 0; d < DTILES; ++d)
      if (d * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + d * 8 + 2 * tig) =
            Mma<T>::pack(acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
    if (tig == 0)
      p.lse_out[((long long)bn * p.H + h) * p.S + qpos[i]] = m[i] + logf(li);
  }
}

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

template <typename T, int HDP>
cudaError_t launch_evo_t(const EvoArgs& a, cudaStream_t st) {
  constexpr int LD = HDP + 8;
  const size_t smem = 4 * (size_t)kEvoTile * LD * sizeof(T);
  cudaError_t err = allow_dynamic_smem<evo_fwd_kernel<T, HDP>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.N, (a.S + kEvoTile - 1) / kEvoTile, a.H);
  evo_fwd_kernel<T, HDP><<<grid, kEvoWarps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_evo_d(const EvoArgs& a, cudaStream_t st) {
  if (a.D <= 16) return launch_evo_t<T, 16>(a, st);
  if (a.D <= 32) return launch_evo_t<T, 32>(a, st);
  if (a.D <= 64) return launch_evo_t<T, 64>(a, st);
  if (a.D <= 128) return launch_evo_t<T, 128>(a, st);
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
// 2 bf16.  D: a multiple of 8 up to 256.
extern "C" int ds_evoformer_fwd(const void* q, const void* k, const void* v, const void* b1,
                                const void* b2, void* o, void* lse, int B, int N, int S, int H,
                                int D, const long long* qkv_strides,
                                const long long* bias_strides, int b1_code, int b2_code,
                                float scale, int dtype, void* stream) {
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
  if (dtype == 1) return (int)dsk::launch_evo_d<__half>(a, st);
  if (dtype == 2) return (int)dsk::launch_evo_d<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
