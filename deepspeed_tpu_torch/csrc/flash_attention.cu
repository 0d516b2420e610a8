// Flash attention for training on Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   _fwd_kernel (launched by _fwd)       -> attn_fwd_kernel (16-bit; its
//                                           design in attn_fwd_hopper.cuh),
//                                           flash_fwd_f32_kernel (fp32)
//   _dq_kernel  (launched by _bwd_impl)  -> flash_dq_*_kernel
//   _dkv_kernel (launched by _bwd_impl)  -> flash_dkv_*_kernel
// Same function: softmax(q kT * scale [+ slope * kpos]) v over canonical
// positions (query t sits at position t), causal or not, optional sliding
// window (kpos > qpos - window) and alibi, GQA by kv head = q head / group
// with K/V never expanded; the forward saves the per-row logsumexp and the
// backward recomputes the probabilities from it (delta = rowsum(o * do) is
// computed by the caller).  Rows that see no key give zeros and lse -1e30.
//
// What bounds it on the H100: operations.  At T = 1024, D = 64 the forward
// does 4*D flops per visible (query, key) pair against 2*D*2 bytes per key
// read once per 128-query tile, far above the card's ~295 flop/byte line;
// the backward more so (dq recomputes s and does 3 products, dk/dv 4).
// The 16-bit forward is warp-specialised on TMA and wgmma (attn_fwd_hopper.
// cuh).  What the backward's design does about it:
//   - 16-bit inputs run every product on the tensor cores (mma.sync
//     m16n8k16, fp32 accumulate).
//   - dq: one block per (batch, q head, 64-query tile), 4 warps x 16 rows.
//     The TPU grid ran K tiles in order and carried its state in VMEM
//     scratch; here the K loop is inside the block, the state lives in
//     registers, and the loop runs only from the window's first K tile to
//     the causal diagonal's, so dead tiles cost nothing.  K/V tiles (64
//     keys) stream through shared memory with 16-byte cp.async, double
//     buffered, rows padded by 8 elements so that ldmatrix's eight row
//     addresses fall in distinct banks.
//   - dk/dv: one block per (batch, KV head, 64-key tile), each warp owning
//     16 keys; the block loops over every q head of the GQA group and every
//     live q tile and keeps dk, dv in fp32 registers - no atomics, so the
//     result is deterministic.  The products are taken transposed
//     (sT = K QT, dpT = V dOT) so that keys are the accumulator rows.
//   - the scalar work around the mma's is what the tensor cores wait for, so
//     it is kept small: scores live in log2 units (exp2f is one instruction),
//     fragments come from shared memory with ldmatrix (.trans for the
//     token-major operands), and a 16 x 16 sub-tile that lies wholly inside
//     the causal / window region skips the per-entry visibility tests.
//   - tensors are read through (batch, token, head) strides, so the model's
//     [B, T, N, D] layout needs no transposes; any T is accepted, the
//     ragged tail is masked.
//   - any head_dim that is a multiple of 8 up to 256: the kernels are
//     compiled at HD 64, 96, 128, 192 and 256 and a head_dim is padded
//     with zeros up to the first that holds it (in shared memory and the
//     q / do fragments; the pad adds nothing to q kT, and its output
//     columns are never stored).  At 192 and 256 the backward's output
//     columns are split over two blocks (NCH), each recomputing the
//     scores, so that dk and dv fit the registers (256 columns would need
//     256 a thread).
//   - fp32 inputs (the cuda-vs-cpu parity run) take CUDA-core variants:
//     lane l owns the columns l, l + 32, ..., warp reductions give the
//     scores.
#include "attn_fwd_hopper.cuh"

namespace dsk {

struct FlashArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *slopes;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, T, N, Nkv, hd;  // hd: the real head_dim (the kernels' HD pads it)
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal, window;
  int stages, qslots;  // forward, 16-bit: the ring depth and Q slots (flash_fwd_plan)
};

constexpr int kTile = 64;      // queries per block (fwd, dq), keys per block (dkv)
constexpr int kFlashWarps = 4;

// ----------------------------------------------------------------- dq, mma
template <typename T, int HD, int NCH>
__global__ void __launch_bounds__(kFlashWarps * 32) flash_dq_mma_kernel(FlashArgs p) {
  constexpr int KSTEPS = HD / 16, DC = HD / NCH, DTILES = DC / 8, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kbuf = reinterpret_cast<T*>(smem);
  T* vbuf = kbuf + 2 * kTile * LD;

  const int nqt = (p.T + kTile - 1) / kTile;
  const int qt = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y / NCH, dc0 = (blockIdx.y % NCH) * DC, b = blockIdx.z;
  const int hk = h / (p.N / p.Nkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int q0 = qt * kTile;
  const float scale2 = p.scale * kLog2e;
  const float slope2 = (p.slopes != nullptr ? p.slopes[h] : 0.f) * kLog2e;

  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + ((long long)b * p.T * p.N + h) * p.hd;

  int qpos[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + warp * 16 + grp + 8 * i;
    const bool in = qpos[i] < p.T;
    const long long r = ((long long)b * p.N + h) * p.T + qpos[i];
    delta[i] = in ? p.delta[r] : 0.f;
    lse2[i] = dead_or_log2(in ? p.lse[r] : kNegInf);
  }
  const int warp_min = q0 + warp * 16, warp_max = min(warp_min + 15, p.T - 1);

  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;
      const int col = ks * 16 + 2 * tig + 8 * (j >> 1);
      const bool in = qpos[i] < p.T && col < p.hd;
      qa[ks][j] = in ? *reinterpret_cast<const uint32_t*>(qb + (long long)qpos[i] * p.q_st + col)
                     : 0u;
      da[ks][j] = in ? *reinterpret_cast<const uint32_t*>(
                           dob + (long long)qpos[i] * p.N * p.hd + col)
                     : 0u;
    }
  float acc[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[d][j] = 0.f;

  int kt_first, kt_last;
  k_tile_range(q0, kTile, p.T, kTile, p.causal, p.window, kt_first, kt_last);
  const int n = kt_last - kt_first + 1;

  load_rows<T, HD, LD>(kbuf, kb, p.k_st, kt_first * kTile, kTile, p.T, p.hd);
  load_rows<T, HD, LD>(vbuf, vb, p.v_st, kt_first * kTile, kTile, p.T, p.hd);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    const int kt = kt_first + it;
    const int bsel = it & 1;
    if (it + 1 < n) {
      load_rows<T, HD, LD>(kbuf + (bsel ^ 1) * kTile * LD, kb, p.k_st, (kt + 1) * kTile, kTile,
                           p.T, p.hd);
      load_rows<T, HD, LD>(vbuf + (bsel ^ 1) * kTile * LD, vb, p.v_st, (kt + 1) * kTile, kTile,
                           p.T, p.hd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks_ = kbuf + bsel * kTile * LD;
    const T* vs_ = vbuf + bsel * kTile * LD;
    for (int t0 = 0; t0 < kTile; t0 += 16) {
      const int kv0 = kt * kTile + t0;
      if (kv0 >= p.T || (p.causal && kv0 > warp_max)) break;
      if (p.window > 0 && kv0 + 15 <= warp_min - p.window) continue;
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
      mma_rows_t<T, HD, LD>(sc, qa, ks_, t0, lane);
      mma_rows_t<T, HD, LD>(dp, da, vs_, t0, lane);
      // every (row, key) pair of the sub-tile visible: no tests needed
      const bool full = (!p.causal || kv0 + 15 <= warp_min) &&
                        (p.window <= 0 || kv0 > warp_min + 15 - p.window) &&
                        kv0 + 16 <= p.T && warp_min + 15 < p.T;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const int kpos = kv0 + nt * 8 + 2 * tig + (j & 1);
          float pr = exp2f(sc[nt][j] * scale2 + slope2 * (float)kpos - lse2[i]);
          if (!full && !visible(qpos[i], kpos, p.T, p.causal, p.window)) pr = 0.f;
          sc[nt][j] = pr * (dp[nt][j] - delta[i]) * p.scale;  // ds
        }
      const uint32_t dsa[4] = {Mma<T>::pack(sc[0][0], sc[0][1]), Mma<T>::pack(sc[0][2], sc[0][3]),
                               Mma<T>::pack(sc[1][0], sc[1][1]), Mma<T>::pack(sc[1][2], sc[1][3])};
      mma_rows<T, DC, LD>(acc, dsa, ks_ + dc0, t0, lane);  // dq += ds k
    }
    __syncthreads();
  }

  T* dqb = static_cast<T*>(p.dq) + ((long long)b * p.T * p.N + h) * p.hd + dc0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= p.T) continue;
    T* row = dqb + (long long)qpos[i] * p.N * p.hd;
#pragma unroll
    for (int d = 0; d < DTILES; ++d)
      if (dc0 + d * 8 < p.hd)
        *reinterpret_cast<uint32_t*>(row + d * 8 + 2 * tig) =
            Mma<T>::pack(acc[d][2 * i], acc[d][2 * i + 1]);
  }
}

// -------------------------------------------------------------- dk/dv, mma
template <typename T, int HD, int NCH>
__global__ void __launch_bounds__(kFlashWarps * 32) flash_dkv_mma_kernel(FlashArgs p) {
  constexpr int KSTEPS = HD / 16, DC = HD / NCH, DTILES = DC / 8, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks_ = reinterpret_cast<T*>(smem);   // [kTile*LD] this block's keys
  T* vs_ = ks_ + kTile * LD;             // [kTile*LD]
  T* qbuf = vs_ + kTile * LD;            // [2][kTile*LD]
  T* dbuf = qbuf + 2 * kTile * LD;       // [2][kTile*LD]
  float* lbuf = reinterpret_cast<float*>(dbuf + 2 * kTile * LD);  // [2][kTile] lse, log2 units
  float* ebuf = lbuf + 2 * kTile;                                   // [2][kTile] delta

  const int kt = blockIdx.x, hk = blockIdx.y / NCH, dc0 = (blockIdx.y % NCH) * DC;
  const int b = blockIdx.z;
  const int group = p.N / p.Nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int k0 = kt * kTile;
  const int wk0 = k0 + warp * 16;        // this warp's first key
  const float scale2 = p.scale * kLog2e;

  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  int qt_first, qt_last;
  q_tile_range(k0, kTile, p.T, kTile, p.causal, p.window, qt_first, qt_last);
  const int nq = max(qt_last - qt_first + 1, 0);
  const int n = nq * group;

  // item -> (q head of the group, q tile); the block copies its Q, dO rows
  // and their lse, delta into buffer `sel`
  auto load_item = [&](int item, int sel) {
    const int h = hk * group + item / nq;
    const int q0 = (qt_first + item % nq) * kTile;
    const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
    const T* dob = static_cast<const T*>(p.dout) + ((long long)b * p.T * p.N + h) * p.hd;
    load_rows<T, HD, LD>(qbuf + sel * kTile * LD, qb, p.q_st, q0, kTile, p.T, p.hd);
    load_rows<T, HD, LD>(dbuf + sel * kTile * LD, dob, (long long)p.N * p.hd, q0, kTile, p.T,
                         p.hd);
    const long long r = ((long long)b * p.N + h) * p.T + q0;
    for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
      const bool in = q0 + t < p.T;
      lbuf[sel * kTile + t] = dead_or_log2(in ? p.lse[r + t] : kNegInf);
      ebuf[sel * kTile + t] = in ? p.delta[r + t] : 0.f;
    }
  };

  float dk[DTILES][4], dv[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[d][j] = dv[d][j] = 0.f;

  load_rows<T, HD, LD>(ks_, kb, p.k_st, k0, kTile, p.T, p.hd);
  load_rows<T, HD, LD>(vs_, vb, p.v_st, k0, kTile, p.T, p.hd);
  if (n > 0) load_item(0, 0);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    const int bsel = it & 1;
    if (it + 1 < n) {
      load_item(it + 1, bsel ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int h = hk * group + it / nq;
    const int q0 = (qt_first + it % nq) * kTile;
    const float slope2 = (p.slopes != nullptr ? p.slopes[h] : 0.f) * kLog2e;
    const T* qs = qbuf + bsel * kTile * LD;
    const T* ds_ = dbuf + bsel * kTile * LD;
    const float* ls = lbuf + bsel * kTile;
    const float* es = ebuf + bsel * kTile;
    for (int t0 = 0; t0 < kTile; t0 += 16) {
      const int qv0 = q0 + t0;                         // this sub-tile's first query
      if (qv0 >= p.T) break;
      if (p.causal && qv0 + 15 < wk0) continue;        // every query before every key
      if (p.window > 0 && wk0 + 15 <= qv0 - p.window) break;  // keys left of every window
      float st[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[nt][j] = dp[nt][j] = 0.f;
      const T* krows = ks_ + warp * 16 * LD;
      const T* vrows = vs_ + warp * 16 * LD;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4], qb[4], db[4];
        load_a_frag<T>(ka, krows, LD, ks, lane);
        load_a_frag<T>(va, vrows, LD, ks, lane);
        load_b_rows_t<T>(qb, qs, LD, t0, ks, lane);
        load_b_rows_t<T>(db, ds_, LD, t0, ks, lane);
        Mma<T>::run(st[0], ka, qb[0], qb[1]);  // sT = k qT
        Mma<T>::run(st[1], ka, qb[2], qb[3]);
        Mma<T>::run(dp[0], va, db[0], db[1]);  // dpT = v doT
        Mma<T>::run(dp[1], va, db[2], db[3]);
      }
      // every (key, query) pair of the sub-tile visible: no tests needed
      const bool full = (!p.causal || wk0 + 15 <= qv0) &&
                        (p.window <= 0 || wk0 > qv0 + 15 - p.window) &&
                        qv0 + 16 <= p.T && wk0 + 16 <= p.T;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = wk0 + grp + 8 * (j >> 1);
          const int qi = t0 + nt * 8 + 2 * tig + (j & 1);
          float pr = exp2f(st[nt][j] * scale2 + slope2 * (float)kpos - ls[qi]);
          if (!full && !visible(q0 + qi, kpos, p.T, p.causal, p.window)) pr = 0.f;
          st[nt][j] = pr;                                       // pT
          dp[nt][j] = pr * (dp[nt][j] - es[qi]) * p.scale;      // dsT
        }
      const uint32_t pa[4] = {Mma<T>::pack(st[0][0], st[0][1]), Mma<T>::pack(st[0][2], st[0][3]),
                              Mma<T>::pack(st[1][0], st[1][1]), Mma<T>::pack(st[1][2], st[1][3])};
      const uint32_t dsa[4] = {Mma<T>::pack(dp[0][0], dp[0][1]), Mma<T>::pack(dp[0][2], dp[0][3]),
                               Mma<T>::pack(dp[1][0], dp[1][1]), Mma<T>::pack(dp[1][2], dp[1][3])};
      mma_rows<T, DC, LD>(dv, pa, ds_ + dc0, t0, lane);   // dv += pT do
      mma_rows<T, DC, LD>(dk, dsa, qs + dc0, t0, lane);   // dk += dsT q
    }
    __syncthreads();
  }

  T* dkb = static_cast<T*>(p.dk) + ((long long)b * p.T * p.Nkv + hk) * p.hd + dc0;
  T* dvb = static_cast<T*>(p.dv) + ((long long)b * p.T * p.Nkv + hk) * p.hd + dc0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = wk0 + grp + 8 * i;
    if (kpos >= p.T) continue;
    const long long off = (long long)kpos * p.Nkv * p.hd;
#pragma unroll
    for (int d = 0; d < DTILES; ++d) {
      if (dc0 + d * 8 >= p.hd) continue;
      *reinterpret_cast<uint32_t*>(dkb + off + d * 8 + 2 * tig) =
          Mma<T>::pack(dk[d][2 * i], dk[d][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvb + off + d * 8 + 2 * tig) =
          Mma<T>::pack(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

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

template <typename T, int HD>
cudaError_t launch_mma(int which, const FlashArgs& a, cudaStream_t st) {
  constexpr int LD = HD + 8, NCH = HD > 128 ? 2 : 1;
  const int tiles = (a.T + kTile - 1) / kTile;
  cudaError_t err;
  if (which == kDkv) {
    const size_t smem = 6 * (size_t)kTile * LD * sizeof(T) + 4 * kTile * sizeof(float);
    err = allow_dynamic_smem<flash_dkv_mma_kernel<T, HD, NCH>>();
    if (err != cudaSuccess) return err;
    flash_dkv_mma_kernel<T, HD, NCH>
        <<<dim3(tiles, a.Nkv * NCH, a.B), kFlashWarps * 32, smem, st>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = 4 * (size_t)kTile * LD * sizeof(T);
  err = allow_dynamic_smem<flash_dq_mma_kernel<T, HD, NCH>>();
  if (err != cudaSuccess) return err;
  flash_dq_mma_kernel<T, HD, NCH>
      <<<dim3(tiles, a.N * NCH, a.B), kFlashWarps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

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
  p.stages = a.stages; p.qslots = a.qslots;
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
      return which == kFwd ? launch_fwd_wgmma<__half, HD>(a, st) : launch_mma<__half, HD>(which, a, st);
    case 2:
      return which == kFwd ? launch_fwd_wgmma<__nv_bfloat16, HD>(a, st)
                           : launch_mma<__nv_bfloat16, HD>(which, a, st);
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
  a.stages = stages; a.qslots = qslots;
  return (int)dsk::launch_flash(dsk::kFwd, dtype, a, stream);
}

// which: 1 writes dq, 2 writes dk and dv (the pointer not written may be null)
extern "C" int ds_flash_bwd(int which, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            const void* slopes, void* dq, void* dk, void* dv, int B, int T,
                            int N, int Nkv, int hd, long long q_sb, long long q_st,
                            long long q_sh, long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh, float scale,
                            int causal, int window, int dtype, void* stream) {
  if (which != dsk::kDq && which != dsk::kDkv) return (int)cudaErrorInvalidValue;
  dsk::FlashArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.slopes = static_cast<const float*>(slopes);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.T = T; a.N = N; a.Nkv = Nkv; a.hd = hd;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh; a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.scale = scale; a.causal = causal; a.window = window;
  return (int)dsk::launch_flash(which, dtype, a, stream);
}
