// Flash attention for training on Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   _fwd_kernel (launched by _fwd)       -> attn_fwd_kernel (16-bit; its
//                                           design in attn_fwd_hopper.cuh),
//                                           flash_fwd_f32_kernel (fp32)
//   _dq_kernel  (launched by _bwd_impl)  -> flash_dq_kernel (16-bit; its
//                                           design in attn_bwd_hopper.cuh),
//                                           flash_dq_f32_kernel (fp32)
//   _dkv_kernel (launched by _bwd_impl)  -> flash_dkv_kernel (16-bit, the
//                                           same header),
//                                           flash_dkv_f32_kernel (fp32)
// Same function: softmax(q kT * scale [+ slope * kpos]) v over canonical
// positions (query t sits at position t), causal or not, optional sliding
// window (kpos > qpos - window) and alibi, GQA by kv head = q head / group
// with K/V never expanded; the forward saves the per-row logsumexp and the
// backward recomputes the probabilities from it.  delta = rowsum(o * do):
// the 16-bit dq makes it in its units when the caller gives none and
// writes it out for dk/dv; the fp32 kernels take it from the caller.  Rows
// that see no key give zeros and lse -1e30.
//
// What bounds it on the H100: operations.  The forward does 4*D flops a
// visible (query, key) pair, dq 6*D (s, dp, ds k), dk/dv 8*D (s, dp, pT do,
// dsT q), against the 989 TFLOP/s dense bf16 peak; each operand is read
// once a 128-row tile, far above the card's ~295 flop/byte line.  The
// 16-bit kernels are warp-specialised on TMA and wgmma: a producer
// warpgroup streams tiles through a ring of mbarrier-guarded stages, two
// consumer warpgroups take turns at the tensor cores, p / ds are packed in
// place as the register A operand of the accumulating products, and every
// head dim up to 256 runs in one block column (the dq accumulator is 64 x
// HD fp32 a warpgroup; above 128, dk/dv's two warpgroups split the column
// blocks of one 64-key unit).  Tensors are read by TMA through their
// (batch, token, head) strides, zero-filled past T and past the head dim,
// which is padded to 64, 96, 128, 192 or 256.  The fp32 inputs (the
// cuda-vs-cpu parity run) take CUDA-core variants: lane l owns the columns
// l, l + 32, ..., warp reductions give the scores.
#include "attn_bwd_hopper.cuh"

namespace dsk {

struct FlashArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *slopes;
  void *o, *dq, *dk, *dv;   // o: the forward's output, the 16-bit dq's input
  float *lse_out, *delta_out;
  int B, T, N, Nkv, hd;  // hd: the real head_dim (the kernels' HD pads it)
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal, window;
  int stages, slots;  // 16-bit: the ring depth and slots (flash_fwd_plan, flash_bwd_plan)
};

// --------------------------------------------------- fp32, CUDA-core variants
// 8 warps x 4 rows; lane l owns the columns l, l + 32, ... (VEC = HD / 32 of
// them, the pad past p.hd zero) and a warp reduction gives each (row, key)
// score.  32-token tiles of the other operand sit in shared memory, padded
// to HD columns with zeros.
constexpr int kF32Warps = 8, kF32Rows = 4, kF32Tile = 32;

template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ base,
                                              long long st, int row0, int Tlen, int hd) {
  for (int c = threadIdx.x; c < kF32Tile * HD / 4; c += blockDim.x) {
    const int row = c / (HD / 4), cc = c % (HD / 4);
    const int t = row0 + row;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < Tlen && 4 * cc < hd)
      val = *reinterpret_cast<const float4*>(base + (long long)t * st + 4 * cc);
    *reinterpret_cast<float4*>(dst + row * HD + 4 * cc) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Warps * 32) flash_fwd_f32_kernel(FlashArgs p) {
  constexpr int VEC = HD / 32, R = kF32Rows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks_ = reinterpret_cast<float*>(smem);  // [kF32Tile * HD]
  float* vs_ = ks_ + kF32Tile * HD;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.N / p.Nkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kF32Tile;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const float* qb = static_cast<const float*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  int qpos[R];
  float qr[R][VEC];
  RowState<VEC> st[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    qpos[i] = q0 + warp * R + i;
    st[i].init();
#pragma unroll
    for (int j = 0; j < VEC; ++j) qr[i][j] = 0.f;
    if (qpos[i] < p.T) ld_cols_t<float, VEC>(qb + (long long)qpos[i] * p.q_st, lane, p.hd, qr[i]);
  }
  int kt_first, kt_last;
  k_tile_range(q0, kF32Tile, p.T, kF32Tile, p.causal, p.window, kt_first, kt_last);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    __syncthreads();
    load_rows_f32<HD>(ks_, kb, p.k_st, kt * kF32Tile, p.T, p.hd);
    load_rows_f32<HD>(vs_, vb, p.v_st, kt * kF32Tile, p.T, p.hd);
    __syncthreads();
    for (int t = 0; t < kF32Tile; ++t) {
      const int kpos = kt * kF32Tile + t;
      if (kpos >= p.T) break;
      float kr[VEC], vr[VEC];
      ld_cols_t<float, VEC>(ks_ + t * HD, lane, HD, kr);
      ld_cols_t<float, VEC>(vs_ + t * HD, lane, HD, vr);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float s = warp_sum_dot<VEC>(qr[i], kr) * p.scale + slope * (float)kpos;
        if (visible(qpos[i], kpos, p.T, p.causal, p.window)) st[i].template update<float>(s, vr);
      }
    }
  }
  float* ob = static_cast<float*>(p.o) + ((long long)b * p.T * p.N + h) * p.hd;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (qpos[i] >= p.T) continue;
    const float ll = st[i].l == 0.f ? 1.f : st[i].l;
    st_cols_t<float, VEC>(ob + (long long)qpos[i] * p.N * p.hd, lane, p.hd, st[i].acc, 1.f / ll);
    if (lane == 0) p.lse_out[((long long)b * p.N + h) * p.T + qpos[i]] = st[i].m + logf(ll);
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Warps * 32) flash_dq_f32_kernel(FlashArgs p) {
  constexpr int VEC = HD / 32, R = kF32Rows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks_ = reinterpret_cast<float*>(smem);  // [kF32Tile * HD]
  float* vs_ = ks_ + kF32Tile * HD;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.N / p.Nkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kF32Tile;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const float* qb = static_cast<const float*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;
  const float* dob = static_cast<const float*>(p.dout) + ((long long)b * p.T * p.N + h) * p.hd;

  int qpos[R];
  bool live[R];
  float qr[R][VEC], dor[R][VEC], acc[R][VEC], lse[R], delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    qpos[i] = q0 + warp * R + i;
    const bool in = qpos[i] < p.T;
    const long long r = ((long long)b * p.N + h) * p.T + qpos[i];
    lse[i] = in ? p.lse[r] : kNegInf;
    delta[i] = in ? p.delta[r] : 0.f;
    live[i] = in && lse[i] > kNegInf * 0.5f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) qr[i][j] = dor[i][j] = acc[i][j] = 0.f;
    if (in) {
      ld_cols_t<float, VEC>(qb + (long long)qpos[i] * p.q_st, lane, p.hd, qr[i]);
      ld_cols_t<float, VEC>(dob + (long long)qpos[i] * p.N * p.hd, lane, p.hd, dor[i]);
    }
  }
  int kt_first, kt_last;
  k_tile_range(q0, kF32Tile, p.T, kF32Tile, p.causal, p.window, kt_first, kt_last);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    __syncthreads();
    load_rows_f32<HD>(ks_, kb, p.k_st, kt * kF32Tile, p.T, p.hd);
    load_rows_f32<HD>(vs_, vb, p.v_st, kt * kF32Tile, p.T, p.hd);
    __syncthreads();
    for (int t = 0; t < kF32Tile; ++t) {
      const int kpos = kt * kF32Tile + t;
      if (kpos >= p.T) break;
      float kr[VEC], vr[VEC];
      ld_cols_t<float, VEC>(ks_ + t * HD, lane, HD, kr);
      ld_cols_t<float, VEC>(vs_ + t * HD, lane, HD, vr);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float s = warp_sum_dot<VEC>(qr[i], kr) * p.scale + slope * (float)kpos;
        const float dp = warp_sum_dot<VEC>(dor[i], vr);
        if (live[i] && visible(qpos[i], kpos, p.T, p.causal, p.window)) {
          const float ds = expf(s - lse[i]) * (dp - delta[i]) * p.scale;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[i][j] += ds * kr[j];
        }
      }
    }
  }
  float* dqb = static_cast<float*>(p.dq) + ((long long)b * p.T * p.N + h) * p.hd;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (qpos[i] < p.T)
      st_cols_t<float, VEC>(dqb + (long long)qpos[i] * p.N * p.hd, lane, p.hd, acc[i], 1.f);
}

template <int HD>
__global__ void __launch_bounds__(kF32Warps * 32) flash_dkv_f32_kernel(FlashArgs p) {
  constexpr int VEC = HD / 32, R = kF32Rows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs_ = reinterpret_cast<float*>(smem);  // [kF32Tile * HD]
  float* dos_ = qs_ + kF32Tile * HD;
  float* ls_ = dos_ + kF32Tile * HD;            // [kF32Tile]
  float* es_ = ls_ + kF32Tile;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.N / p.Nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = kt * kF32Tile;
  const float* kb = static_cast<const float*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  int kpos[R];
  float kr[R][VEC], vr[R][VEC], dk[R][VEC], dv[R][VEC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    kpos[i] = k0 + warp * R + i;
#pragma unroll
    for (int j = 0; j < VEC; ++j) kr[i][j] = vr[i][j] = dk[i][j] = dv[i][j] = 0.f;
    if (kpos[i] < p.T) {
      ld_cols_t<float, VEC>(kb + (long long)kpos[i] * p.k_st, lane, p.hd, kr[i]);
      ld_cols_t<float, VEC>(vb + (long long)kpos[i] * p.v_st, lane, p.hd, vr[i]);
    }
  }
  int qt_first, qt_last;
  q_tile_range(k0, kF32Tile, p.T, kF32Tile, p.causal, p.window, qt_first, qt_last);
  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const float* qb =
        static_cast<const float*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
    const float* dob = static_cast<const float*>(p.dout) + ((long long)b * p.T * p.N + h) * p.hd;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * kF32Tile;
      __syncthreads();
      load_rows_f32<HD>(qs_, qb, p.q_st, q0, p.T, p.hd);
      load_rows_f32<HD>(dos_, dob, (long long)p.N * p.hd, q0, p.T, p.hd);
      for (int t = threadIdx.x; t < kF32Tile; t += blockDim.x) {
        const bool in = q0 + t < p.T;
        const long long r = ((long long)b * p.N + h) * p.T + q0 + t;
        ls_[t] = in ? p.lse[r] : kNegInf;
        es_[t] = in ? p.delta[r] : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < kF32Tile; ++t) {
        const int qpos = q0 + t;
        if (qpos >= p.T) break;
        float qv[VEC], dov[VEC];
        ld_cols_t<float, VEC>(qs_ + t * HD, lane, HD, qv);
        ld_cols_t<float, VEC>(dos_ + t * HD, lane, HD, dov);
        const float lse = ls_[t], delta = es_[t];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float s = warp_sum_dot<VEC>(kr[i], qv) * p.scale + slope * (float)kpos[i];
          const float dp = warp_sum_dot<VEC>(vr[i], dov);
          if (lse > kNegInf * 0.5f && visible(qpos, kpos[i], p.T, p.causal, p.window)) {
            const float pr = expf(s - lse);
            const float ds = pr * (dp - delta) * p.scale;
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              dv[i][c] += pr * dov[c];
              dk[i][c] += ds * qv[c];
            }
          }
        }
      }
    }
  }
  float* dkb = static_cast<float*>(p.dk) + ((long long)b * p.T * p.Nkv + hk) * p.hd;
  float* dvb = static_cast<float*>(p.dv) + ((long long)b * p.T * p.Nkv + hk) * p.hd;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (kpos[i] >= p.T) continue;
    st_cols_t<float, VEC>(dkb + (long long)kpos[i] * p.Nkv * p.hd, lane, p.hd, dk[i], 1.f);
    st_cols_t<float, VEC>(dvb + (long long)kpos[i] * p.Nkv * p.hd, lane, p.hd, dv[i], 1.f);
  }
}

// ----------------------------------------------------------------- launchers
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// The 16-bit forward on attn_fwd_kernel (attn_fwd_hopper.cuh): q [B, T, N,
// hd] and k, v [B, T, Nkv, hd] as 4-D tensor maps (hd, head, token, batch)
// read in boxes of [rows, 64 columns] in the 128-byte swizzle, the columns
// past hd zero-filled up to HD.
template <typename T, int HD>
cudaError_t launch_fwd_wgmma(const FlashArgs& a, cudaStream_t st) {
  constexpr int BN = HD <= 128 ? 128 : 64;
  FwdArgs p{};
  p.o = a.o;
  p.lse = a.lse_out;
  p.B = a.B; p.T = a.T; p.N = a.N; p.Nkv = a.Nkv; p.hd = a.hd; p.rows = 1;
  p.stages = a.stages; p.qslots = a.slots;
  p.scale = a.scale * kLog2e;
  p.slopes = a.slopes; p.causal = a.causal; p.window = a.window;
  p.b1_code = p.b2_code = -1;
  const long long dq[4] = {a.hd, a.N, a.T, a.B}, dkv[4] = {a.hd, a.Nkv, a.T, a.B};
  const long long sq[4] = {1, a.q_sh, a.q_st, a.q_sb}, sk[4] = {1, a.k_sh, a.k_st, a.k_sb},
                  sv[4] = {1, a.v_sh, a.v_st, a.v_sb};
  const int box_q[4] = {64, 1, kFwdRows, 1}, box_kv[4] = {64, 1, BN, 1};
  CUtensorMap tmq{}, tmk{}, tmv{}, unused{};
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_nd(&tmq, tma_dtype<T>(), 2, a.q, 4, dq, sq, box_q, sw, &p.cq) ||
      !tensor_map_nd(&tmk, tma_dtype<T>(), 2, a.k, 4, dkv, sk, box_kv, sw, &p.ck) ||
      !tensor_map_nd(&tmv, tma_dtype<T>(), 2, a.v, 4, dkv, sv, box_kv, sw, &p.cv))
    return cudaErrorInvalidValue;
  return launch_attn_fwd<T, HD, BN, false>(p, tmq, tmk, tmv, unused, st);
}

// The 16-bit backward on flash_dq_kernel / flash_dkv_kernel
// (attn_bwd_hopper.cuh): q, do [B, T, N, hd] and k, v [B, T, Nkv, hd] as
// 4-D tensor maps (hd, head, token, batch) in boxes of [rows, 64 columns],
// 128-byte swizzle; do contiguous.
template <typename T, int HD>
cudaError_t launch_bwd_wgmma(int which, const FlashArgs& a, cudaStream_t st) {
  BwdArgs p{};
  p.lse = a.lse; p.delta = a.delta; p.delta_out = a.delta_out; p.o = a.o; p.dout = a.dout;
  p.dq = a.dq; p.dk = a.dk; p.dv = a.dv; p.slopes = a.slopes;
  p.B = a.B; p.T = a.T; p.N = a.N; p.Nkv = a.Nkv; p.hd = a.hd;
  p.stages = a.stages; p.slots = a.slots;
  p.scale = a.scale; p.causal = a.causal; p.window = a.window;
  if (p.delta == nullptr && (which == kDkv || p.o == nullptr)) return cudaErrorInvalidValue;
  const int q_rows = which == kDq ? kDqRows : dkv_bm<HD>();
  const int kv_rows = which == kDq ? dq_bn<HD>() : (HD > 128 ? 64 : 128);
  const long long dq[4] = {a.hd, a.N, a.T, a.B}, dkv[4] = {a.hd, a.Nkv, a.T, a.B};
  const long long sq[4] = {1, a.q_sh, a.q_st, a.q_sb}, sk[4] = {1, a.k_sh, a.k_st, a.k_sb},
                  sv[4] = {1, a.v_sh, a.v_st, a.v_sb},
                  sdo[4] = {1, a.hd, (long long)a.N * a.hd, (long long)a.T * a.N * a.hd};
  const int box_q[4] = {64, 1, q_rows, 1}, box_kv[4] = {64, 1, kv_rows, 1};
  CUtensorMap tmq{}, tmdo{}, tmk{}, tmv{};
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_nd(&tmq, tma_dtype<T>(), 2, a.q, 4, dq, sq, box_q, sw, &p.cq) ||
      !tensor_map_nd(&tmdo, tma_dtype<T>(), 2, a.dout, 4, dq, sdo, box_q, sw, &p.cdo) ||
      !tensor_map_nd(&tmk, tma_dtype<T>(), 2, a.k, 4, dkv, sk, box_kv, sw, &p.ck) ||
      !tensor_map_nd(&tmv, tma_dtype<T>(), 2, a.v, 4, dkv, sv, box_kv, sw, &p.cv))
    return cudaErrorInvalidValue;
  if (which == kDq) return launch_attn_bwd<T, HD>(1, p, tmq, tmdo, tmk, tmv, st);
  return launch_attn_bwd<T, HD>(2, p, tmk, tmv, tmq, tmdo, st);
}

template <int HD>
cudaError_t launch_f32(int which, const FlashArgs& a, cudaStream_t st) {
  const int tiles = (a.T + kF32Tile - 1) / kF32Tile;
  const size_t smem = 2 * (size_t)kF32Tile * HD * sizeof(float) + 2 * kF32Tile * sizeof(float);
  cudaError_t err;
  if (which == kFwd) {
    err = allow_dynamic_smem<flash_fwd_f32_kernel<HD>>();
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<HD><<<dim3(tiles, a.N, a.B), kF32Warps * 32, smem, st>>>(a);
  } else if (which == kDq) {
    err = allow_dynamic_smem<flash_dq_f32_kernel<HD>>();
    if (err != cudaSuccess) return err;
    flash_dq_f32_kernel<HD><<<dim3(tiles, a.N, a.B), kF32Warps * 32, smem, st>>>(a);
  } else {
    err = allow_dynamic_smem<flash_dkv_f32_kernel<HD>>();
    if (err != cudaSuccess) return err;
    flash_dkv_f32_kernel<HD><<<dim3(tiles, a.Nkv, a.B), kF32Warps * 32, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dtype(int which, int dtype, const FlashArgs& a, cudaStream_t st) {
  switch (dtype) {
    case 0: return launch_f32<HD>(which, a, st);
    case 1:
      return which == kFwd ? launch_fwd_wgmma<__half, HD>(a, st)
                           : launch_bwd_wgmma<__half, HD>(which, a, st);
    case 2:
      return which == kFwd ? launch_fwd_wgmma<__nv_bfloat16, HD>(a, st)
                           : launch_bwd_wgmma<__nv_bfloat16, HD>(which, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The compiled widths; a head_dim is padded up to the first that holds it
// (ops/flash_attention.py's MAX_HEAD_DIM is the last).
inline cudaError_t launch_flash(int which, int dtype, const FlashArgs& a, void* stream) {
  if (a.B < 1 || a.T < 1 || a.N < 1 || a.Nkv < 1 || a.N % a.Nkv != 0 || a.B > 65535 ||
      2 * a.N > 65535 || a.hd < 8 || a.hd > 256 || a.hd % 8 != 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (a.hd <= 64) return launch_dtype<64>(which, dtype, a, st);
  if (a.hd <= 96) return launch_dtype<96>(which, dtype, a, st);
  if (a.hd <= 128) return launch_dtype<128>(which, dtype, a, st);
  if (a.hd <= 192) return launch_dtype<192>(which, dtype, a, st);
  return launch_dtype<256>(which, dtype, a, st);
}

}  // namespace dsk

// q [B, T, N, hd], k/v [B, T, Nkv, hd] read through element strides
// (batch, token, head; head_dim contiguous); o, dout, dq [B, T, N, hd] and
// dk, dv [B, T, Nkv, hd] contiguous; lse, delta [B, N, T] fp32; slopes [N]
// fp32 or null.  dtype: 0 fp32, 1 fp16, 2 bf16.  window <= 0: none.
// stages, qslots: the 16-bit forward's ring depth (1..8) and Q slots (1..2),
// within the card's shared memory (ops/flash_attention.py flash_fwd_plan).
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* slopes,
                            void* o, void* lse, int B, int T, int N, int Nkv, int hd,
                            long long q_sb, long long q_st, long long q_sh, long long k_sb,
                            long long k_st, long long k_sh, long long v_sb, long long v_st,
                            long long v_sh, float scale, int causal, int window, int stages,
                            int qslots, int dtype, void* stream) {
  dsk::FlashArgs a{};
  a.q = q; a.k = k; a.v = v; a.slopes = static_cast<const float*>(slopes);
  a.o = o; a.lse_out = static_cast<float*>(lse);
  a.B = B; a.T = T; a.N = N; a.Nkv = Nkv; a.hd = hd;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh; a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.scale = scale; a.causal = causal; a.window = window;
  a.stages = stages; a.slots = qslots;
  return (int)dsk::launch_flash(dsk::kFwd, dtype, a, stream);
}

// which: 1 writes dq, 2 writes dk and dv (the pointer not written may be
// null).  delta [B, N, T] fp32, or (16-bit dq) null: the kernel makes it
// from o [B, T, N, hd] (contiguous) and dout, and writes it to delta_out if
// that is not null.  stages, slots: the 16-bit kernel's ring depth (1..8)
// and slots (1..2), within the card's shared memory (ops/flash_attention.py
// flash_bwd_plan).
extern "C" int ds_flash_bwd(int which, const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse, const void* delta,
                            void* delta_out, const void* slopes, void* dq, void* dk, void* dv,
                            int B, int T, int N, int Nkv, int hd, long long q_sb, long long q_st,
                            long long q_sh, long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh, float scale,
                            int causal, int window, int stages, int slots, int dtype,
                            void* stream) {
  if (which != dsk::kDq && which != dsk::kDkv) return (int)cudaErrorInvalidValue;
  if (delta == nullptr && dtype == 0) return (int)cudaErrorInvalidValue;
  dsk::FlashArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.o = const_cast<void*>(o);
  a.lse = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.delta_out = static_cast<float*>(delta_out);
  a.slopes = static_cast<const float*>(slopes);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.T = T; a.N = N; a.Nkv = Nkv; a.hd = hd;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh; a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.scale = scale; a.causal = causal; a.window = window;
  a.stages = stages; a.slots = slots;
  return (int)dsk::launch_flash(which, dtype, a, stream);
}
