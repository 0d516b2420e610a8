// Evoformer attention backward on Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/evoformer.py (launched by
// _bwd_impl):
//   _dq_kernel  -> evo_dq_kernel    dq  = scale * sum_k ds k
//   _dkv_kernel -> evo_dkv_kernel   dk  = scale * sum_q dsT q,  dv = sum_q pT do
//   _db2_kernel -> evo_db2_kernel   db2[b, h, q, k] = sum_n ds
//   _db1_kernel -> evo_dkv_kernel's per-head column sums of ds, then
//                  evo_db1_kernel   db1[bn, k] = sum_h (sum_q ds)
// Every kernel recomputes its tile as the reference's _tile_ds does:
//   s  = (q . k) * scale + bias1 + bias2  (evo_logit, shared with the forward)
//   p  = exp(s - lse), 0 on a row whose lse is -1e30 (it saw no key)
//   ds = p * (do . v - delta),  delta = rowsum(o * do) (fp32, from the caller)
// and casts as the reference does: ds to the inputs' dtype before the dq and
// dk products (scale applied to the fp32 sums), p to do's dtype before dv.
// The logit is subtracted from lse in natural units and only the difference
// goes to log2 units inside exp2f: at a -1e9 mask s and lse sit where the
// fp32 spacing is 64 and must cancel exactly as in the forward.
//
// What bounds it on the H100: bytes at AlphaFold2's widths, with
// operations close behind (D = 32: dq 3, dk/dv 4 and dbias2 2 products of
// 2*D flops per (query, key) pair against q, k, v and do read once, bias2
// once per (head, query, key)); in practice the scalar work per logit
// (bias loads, exp) and the mma.sync inner loop set the pace, as in the
// forward.  What the design does about it:
//   - dq: the forward's grid (batch * MSA row, 64-query tile, head), 4 warps
//     x 16 query rows, q and do fragments in registers, 64-key tiles of K
//     and V double-buffered through shared memory with 16-byte cp.async.
//   - dk/dv: one block per (batch * MSA row, 64-key tile, head), each warp
//     owning 16 keys in fp32 registers; the block walks the query tiles
//     (Q, dO, lse, delta double-buffered) and takes the products transposed
//     (sT = K QT, dpT = V dOT) so that keys are the accumulator rows.  When
//     bias1 needs a gradient it also sums ds over its queries per key and
//     head (db1_part); evo_db1_kernel then adds the heads in order, so the
//     reference's fifth pass (#17) costs no recompute.
//   - dbias2: one block per (batch, head, 64-query tile, 64-key tile); it
//     walks the N MSA rows in ascending order (each row's Q, dO, K, V, lse,
//     delta double-buffered, bias1 prefetched in registers) and keeps the
//     64 x 64 sum in fp32 registers; the bias2 tile, the same for every
//     row, is read once into registers.
//   - no atomics: every sum runs in a fixed order, so a run is
//     deterministic.  q, k, v and both biases are read through their
//     strides, head_dim is padded to HDP in {16, 32, 64, 128} with zeros in
//     shared memory, and keys / rows past S are neither used nor written.
//   - fp32 inputs, and 16-bit inputs with D above 128 (the dk/dv
//     accumulators of 256 columns would need 256 fp32 registers a thread),
//     take the CUDA-core variants evo_*_simt below.
#include "evo_common.cuh"

namespace dsk {

// ---------------------------------------------------------------- dq (#14)
template <typename T, int HDP>
__global__ void __launch_bounds__(kEvoWarps * 32) evo_dq_kernel(EvoArgs p) {
  constexpr int KSTEPS = HDP / 16, DTILES = HDP / 8, LD = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kbuf = reinterpret_cast<T*>(smem);  // [2][kEvoTile*LD]
  T* vbuf = kbuf + 2 * kEvoTile * LD;    // [2][kEvoTile*LD]

  const int bn = blockIdx.x, qt = blockIdx.y, h = blockIdx.z;
  const int b = bn / p.N, n = bn % p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int D = p.D;
  const long long tok = (long long)p.H * D;  // token stride of do and dq

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + ((long long)bn * p.S * p.H + h) * D;
  const long long b1o = b * p.b1_sb + n * p.b1_sn;
  const long long b2o = b * p.b2_sb + h * p.b2_sh;
  zero_pad_cols<LD>(smem, 4 * kEvoTile, D, HDP);

  int qpos[2];
  bool exists[2], live[2];
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = qt * kEvoTile + warp * 16 + grp + 8 * i;
    exists[i] = qpos[i] < p.S;
    const long long r = ((long long)bn * p.H + h) * p.S + qpos[i];
    lse[i] = exists[i] ? p.lse[r] : kNegInf;
    delta[i] = exists[i] ? p.delta[r] : 0.f;
    live[i] = lse[i] > 0.5f * kNegInf;  // a row that saw no key has p = 0
  }
  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;
      const int col = ks * 16 + 2 * tig + 8 * (j >> 1);
      const bool in = exists[i] && col < D;
      qa[ks][j] = in ? *reinterpret_cast<const uint32_t*>(qb + qpos[i] * p.q_ss + col) : 0u;
      da[ks][j] = in ? *reinterpret_cast<const uint32_t*>(dob + qpos[i] * tok + col) : 0u;
    }
  float acc[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[d][j] = 0.f;

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
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
      mma_rows_t<T, HDP, LD>(sc, qa, ks_, t0, lane);  // q kT
      mma_rows_t<T, HDP, LD>(dp, da, vs_, t0, lane);  // do vT
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const int kpos = kv0 + nt * 8 + 2 * tig + (j & 1);
          float ds = 0.f;
          if (live[i] && kpos < p.S) {
            const float s = evo_logit(p, sc[nt][j], b1o, b2o, qpos[i], kpos);
            ds = exp2f((s - lse[i]) * kLog2e) * (dp[nt][j] - delta[i]);
          }
          sc[nt][j] = ds;
        }
      const uint32_t dsa[4] = {Mma<T>::pack(sc[0][0], sc[0][1]), Mma<T>::pack(sc[0][2], sc[0][3]),
                               Mma<T>::pack(sc[1][0], sc[1][1]), Mma<T>::pack(sc[1][2], sc[1][3])};
      mma_rows<T, HDP, LD>(acc, dsa, ks_, t0, lane);  // dq += ds k
    }
    __syncthreads();  // buffer bsel is refilled by the next iteration's copy
  }

  T* dqb = static_cast<T*>(p.dq) + ((long long)bn * p.S * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!exists[i]) continue;
    T* row = dqb + qpos[i] * tok;
#pragma unroll
    for (int d = 0; d < DTILES; ++d)
      if (d * 8 < D)
        *reinterpret_cast<uint32_t*>(row + d * 8 + 2 * tig) =
            Mma<T>::pack(acc[d][2 * i] * p.scale, acc[d][2 * i + 1] * p.scale);
  }
}

// The block stages `rows` fp32 values of a [.., S] row (lse or delta) from
// position t0 with 4-byte cp.async; positions at or past S get `fill`.
__device__ __forceinline__ void load_row_f32(float* dst, const float* __restrict__ src, int t0,
                                             int rows, int S, float fill) {
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    if (t0 + t < S)
      cp_async4(dst + t, src + t0 + t);
    else
      dst[t] = fill;
  }
}

// ------------------------------------------------------------ dk/dv (#15)
template <typename T, int HDP>
__global__ void __launch_bounds__(kEvoWarps * 32) evo_dkv_kernel(EvoArgs p) {
  constexpr int KSTEPS = HDP / 16, DTILES = HDP / 8, LD = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks_ = reinterpret_cast<T*>(smem);  // [kEvoTile*LD] this block's keys
  T* vs_ = ks_ + kEvoTile * LD;         // [kEvoTile*LD]
  T* qbuf = vs_ + kEvoTile * LD;        // [2][kEvoTile*LD]
  T* dbuf = qbuf + 2 * kEvoTile * LD;   // [2][kEvoTile*LD]
  float* lbuf = reinterpret_cast<float*>(dbuf + 2 * kEvoTile * LD);  // [2][kEvoTile] lse
  float* ebuf = lbuf + 2 * kEvoTile;                                  // [2][kEvoTile] delta

  const int bn = blockIdx.x, kt = blockIdx.y, h = blockIdx.z;
  const int b = bn / p.N, n = bn % p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int D = p.D;
  const long long tok = (long long)p.H * D;
  const int k0 = kt * kEvoTile, wk0 = k0 + warp * 16;  // the block's, this warp's first key

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + ((long long)bn * p.S * p.H + h) * D;
  const long long b1o = b * p.b1_sb + n * p.b1_sn;
  const long long b2o = b * p.b2_sb + h * p.b2_sh;
  const long long r0 = ((long long)bn * p.H + h) * p.S;  // this (row, head)'s lse / delta
  zero_pad_cols<LD>(smem, 6 * kEvoTile, D, HDP);

  auto load_item = [&](int it, int sel) {
    const int q0 = it * kEvoTile;
    load_rows_d<T, LD>(qbuf + sel * kEvoTile * LD, qb, p.q_ss, q0, kEvoTile, p.S, D);
    load_rows_d<T, LD>(dbuf + sel * kEvoTile * LD, dob, tok, q0, kEvoTile, p.S, D);
    load_row_f32(lbuf + sel * kEvoTile, p.lse + r0, q0, kEvoTile, p.S, kNegInf);
    load_row_f32(ebuf + sel * kEvoTile, p.delta + r0, q0, kEvoTile, p.S, 0.f);
  };

  int kpos[2];
  bool kin[2];
  float b1v[2];  // bias1 of this thread's two keys (absent: unused)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = wk0 + grp + 8 * i;
    kin[i] = kpos[i] < p.S;
    b1v[i] = (kin[i] && p.b1_code >= 0) ? bias1_at(p, b1o, kpos[i]) : 0.f;
  }
  float dk[DTILES][4], dv[DTILES][4], colsum[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[d][j] = dv[d][j] = 0.f;

  const int nqt = (p.S + kEvoTile - 1) / kEvoTile;
  load_rows_d<T, LD>(ks_, kb, p.k_ss, k0, kEvoTile, p.S, D);
  load_rows_d<T, LD>(vs_, vb, p.v_ss, k0, kEvoTile, p.S, D);
  load_item(0, 0);
  cp_async_commit();
  for (int it = 0; it < nqt; ++it) {
    const int bsel = it & 1;
    if (it + 1 < nqt) {
      load_item(it + 1, bsel ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = it * kEvoTile;
    const T* qs = qbuf + bsel * kEvoTile * LD;
    const T* dos = dbuf + bsel * kEvoTile * LD;
    const float* ls = lbuf + bsel * kEvoTile;
    const float* es = ebuf + bsel * kEvoTile;
    const T* krows = ks_ + warp * 16 * LD;
    const T* vrows = vs_ + warp * 16 * LD;
    for (int t0 = 0; t0 < kEvoTile; t0 += 16) {
      if (q0 + t0 >= p.S) break;
      float st[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4], qf[4], df[4];
        load_a_frag<T>(ka, krows, LD, ks, lane);
        load_a_frag<T>(va, vrows, LD, ks, lane);
        load_b_rows_t<T>(qf, qs, LD, t0, ks, lane);
        load_b_rows_t<T>(df, dos, LD, t0, ks, lane);
        Mma<T>::run(st[0], ka, qf[0], qf[1]);  // sT = k qT
        Mma<T>::run(st[1], ka, qf[2], qf[3]);
        Mma<T>::run(dp[0], va, df[0], df[1]);  // dpT = v doT
        Mma<T>::run(dp[1], va, df[2], df[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const int qi = t0 + nt * 8 + 2 * tig + (j & 1);
          const float lse = ls[qi];  // -1e30 for a dead row and a row past S
          float pr = 0.f, ds = 0.f;
          if (kin[i] && lse > 0.5f * kNegInf) {
            const float s = evo_logit_v(
                p, st[nt][j], b1v[i],
                p.b2_code >= 0 ? bias2_at(p, b2o, q0 + qi, kpos[i]) : 0.f);
            pr = exp2f((s - lse) * kLog2e);
            ds = pr * (dp[nt][j] - es[qi]);
          }
          st[nt][j] = pr;  // pT
          dp[nt][j] = ds;  // dsT
          colsum[i] += ds;
        }
      const uint32_t pa[4] = {Mma<T>::pack(st[0][0], st[0][1]), Mma<T>::pack(st[0][2], st[0][3]),
                              Mma<T>::pack(st[1][0], st[1][1]), Mma<T>::pack(st[1][2], st[1][3])};
      const uint32_t dsa[4] = {Mma<T>::pack(dp[0][0], dp[0][1]), Mma<T>::pack(dp[0][2], dp[0][3]),
                               Mma<T>::pack(dp[1][0], dp[1][1]), Mma<T>::pack(dp[1][2], dp[1][3])};
      mma_rows<T, HDP, LD>(dv, pa, dos, t0, lane);  // dv += pT do
      mma_rows<T, HDP, LD>(dk, dsa, qs, t0, lane);  // dk += dsT q
    }
    __syncthreads();
  }

  T* dkb = static_cast<T*>(p.dk) + ((long long)bn * p.S * p.H + h) * D;
  T* dvb = static_cast<T*>(p.dv) + ((long long)bn * p.S * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!kin[i]) continue;
    const long long off = kpos[i] * tok;
#pragma unroll
    for (int d = 0; d < DTILES; ++d)
      if (d * 8 < D) {
        *reinterpret_cast<uint32_t*>(dkb + off + d * 8 + 2 * tig) =
            Mma<T>::pack(dk[d][2 * i] * p.scale, dk[d][2 * i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvb + off + d * 8 + 2 * tig) =
            Mma<T>::pack(dv[d][2 * i], dv[d][2 * i + 1]);
      }
  }
  if (p.db1_part != nullptr) {
    // the four lanes of a key hold its column sum over disjoint queries
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      colsum[i] += __shfl_xor_sync(0xffffffffu, colsum[i], 1);
      colsum[i] += __shfl_xor_sync(0xffffffffu, colsum[i], 2);
      if (tig == 0 && kin[i]) p.db1_part[r0 + kpos[i]] = colsum[i];
    }
  }
}

// ------------------------------------------------------------ dbias2 (#16)
template <typename T, int HDP>
__global__ void __launch_bounds__(kEvoWarps * 32) evo_db2_kernel(EvoArgs p) {
  constexpr int KSTEPS = HDP / 16, LD = HDP + 8, TILE = kEvoTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qbuf = reinterpret_cast<T*>(smem);  // [2][TILE] this row's queries
  T* dbuf = qbuf + 2 * TILE;             // [2][TILE] their do rows
  T* kbuf = dbuf + 2 * TILE;             // [2][TILE] this row's keys
  T* vbuf = kbuf + 2 * TILE;             // [2][TILE]
  float* lbuf = reinterpret_cast<float*>(vbuf + 2 * TILE);  // [2][kEvoTile] lse
  float* ebuf = lbuf + 2 * kEvoTile;                         // [2][kEvoTile] delta
  float* b1buf = ebuf + 2 * kEvoTile;                        // [2][kEvoTile] bias1 of the keys

  const int nkt = (p.S + kEvoTile - 1) / kEvoTile;
  const int b = blockIdx.x / nkt, kt = blockIdx.x % nkt, qt = blockIdx.y, h = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int D = p.D;
  const long long tok = (long long)p.H * D;
  const int q0 = qt * kEvoTile, k0 = kt * kEvoTile;
  const long long b2o = b * p.b2_sb + h * p.b2_sh;
  zero_pad_cols<LD>(smem, 8 * kEvoTile, D, HDP);

  auto stage = [&](int n, int sel) {
    const long long bn = (long long)b * p.N + n;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + h * p.q_sh;
    const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + h * p.k_sh;
    const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + h * p.v_sh;
    const T* dob = static_cast<const T*>(p.dout) + (bn * p.S * p.H + h) * D;
    load_rows_d<T, LD>(qbuf + sel * TILE, qb, p.q_ss, q0, kEvoTile, p.S, D);
    load_rows_d<T, LD>(dbuf + sel * TILE, dob, tok, q0, kEvoTile, p.S, D);
    load_rows_d<T, LD>(kbuf + sel * TILE, kb, p.k_ss, k0, kEvoTile, p.S, D);
    load_rows_d<T, LD>(vbuf + sel * TILE, vb, p.v_ss, k0, kEvoTile, p.S, D);
    const long long r = (bn * p.H + h) * p.S;
    load_row_f32(lbuf + sel * kEvoTile, p.lse + r, q0, kEvoTile, p.S, kNegInf);
    load_row_f32(ebuf + sel * kEvoTile, p.delta + r, q0, kEvoTile, p.S, 0.f);
  };
  // bias1 of key k0 + threadIdx.x in row n (threads below kEvoTile)
  auto b1_of = [&](int n) {
    const int kpos = k0 + (int)threadIdx.x;
    return (threadIdx.x < kEvoTile && kpos < p.S && p.b1_code >= 0)
               ? bias1_at(p, b * p.b1_sb + n * p.b1_sn, kpos)
               : 0.f;
  };

  int qpos[2];
  bool qin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + warp * 16 + grp + 8 * i;
    qin[i] = qpos[i] < p.S;
  }
  // the bias2 tile is the same for every MSA row: read it once
  float b2v[4][2][4], acc[4][2][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j >> 1;
        const int kpos = k0 + t * 16 + nt * 8 + 2 * tig + (j & 1);
        b2v[t][nt][j] =
            (qin[i] && kpos < p.S && p.b2_code >= 0) ? bias2_at(p, b2o, qpos[i], kpos) : 0.f;
        acc[t][nt][j] = 0.f;
      }

  stage(0, 0);
  cp_async_commit();
  if (threadIdx.x < kEvoTile) b1buf[threadIdx.x] = b1_of(0);
  for (int n = 0; n < p.N; ++n) {
    const int bsel = n & 1;
    float b1_next = 0.f;
    if (n + 1 < p.N) {
      stage(n + 1, bsel ^ 1);
      cp_async_commit();
      b1_next = b1_of(n + 1);  // in flight while this row computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qs = qbuf + bsel * TILE;
    const T* dos = dbuf + bsel * TILE;
    const T* ks_ = kbuf + bsel * TILE;
    const T* vs_ = vbuf + bsel * TILE;
    const float* b1s = b1buf + bsel * kEvoTile;
    float lse[2], delta[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + grp + 8 * i;
      lse[i] = lbuf[bsel * kEvoTile + r];
      delta[i] = ebuf[bsel * kEvoTile + r];
      live[i] = lse[i] > 0.5f * kNegInf;
    }
    uint32_t qa[KSTEPS][4], da[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      load_a_frag<T>(qa[ks], qs + warp * 16 * LD, LD, ks, lane);
      load_a_frag<T>(da[ks], dos + warp * 16 * LD, LD, ks, lane);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (k0 + t * 16 < p.S) {
        float sc[2][4], dp[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
        mma_rows_t<T, HDP, LD>(sc, qa, ks_, t * 16, lane);  // q kT
        mma_rows_t<T, HDP, LD>(dp, da, vs_, t * 16, lane);  // do vT
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = j >> 1;
            const int kl = t * 16 + nt * 8 + 2 * tig + (j & 1);
            if (live[i] && k0 + kl < p.S) {
              const float s = evo_logit_v(p, sc[nt][j], b1s[kl], b2v[t][nt][j]);
              acc[t][nt][j] += exp2f((s - lse[i]) * kLog2e) * (dp[nt][j] - delta[i]);
            }
          }
      }
    }
    if (n + 1 < p.N && threadIdx.x < kEvoTile) b1buf[(bsel ^ 1) * kEvoTile + threadIdx.x] = b1_next;
    __syncthreads();  // buffer bsel is refilled by the next iteration's copy
  }

  float* out = p.db2 + ((long long)b * p.H + h) * p.S * p.S;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j >> 1;
        const int kpos = k0 + t * 16 + nt * 8 + 2 * tig + (j & 1);
        if (qin[i] && kpos < p.S) out[(long long)qpos[i] * p.S + kpos] = acc[t][nt][j];
      }
}

// ---------------------------------------------------- dbias1 (#17), reduce
// db1[bn, k] = sum over heads, in order, of evo_dkv_kernel's column sums.
__global__ void evo_db1_kernel(const float* __restrict__ part, float* __restrict__ db1,
                               long long rows, int H, int S) {
  const long long total = rows * S;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long bn = i / S;
    const float* src = part + bn * H * S + i % S;
    float s = 0.f;
    for (int h = 0; h < H; ++h) s += src[(long long)h * S];
    db1[i] = s;
  }
}

// ------------------------------------------------- CUDA-core family (simt)
// fp32 inputs at any head_dim, and 16-bit inputs at head_dim above 128: one
// warp a row (lane l owning the columns l, l + 32, ... of it), the other
// operand's rows read one at a time straight from device memory, the same
// recompute and casts as the tensor-core kernels (ds and p rounded to T
// before their products, the scale applied to the fp32 sums).
template <typename T, int HD>
__global__ void __launch_bounds__(kEvoSimtWarps * 32) evo_dq_simt(EvoArgs p) {
  constexpr int VEC = HD / 32;
  const int bn = blockIdx.x, h = blockIdx.z;
  const int b = bn / p.N, n = bn % p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qpos = blockIdx.y * kEvoSimtWarps + warp;
  if (qpos >= p.S) return;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + h * p.v_sh;
  const long long b1o = b * p.b1_sb + n * p.b1_sn;
  const long long b2o = b * p.b2_sb + h * p.b2_sh;
  const long long row = ((long long)bn * p.S + qpos) * p.H + h;
  const long long r = ((long long)bn * p.H + h) * p.S + qpos;
  const float lse = p.lse[r], delta = p.delta[r];
  float qr[VEC], dor[VEC], acc[VEC];
  ld_cols_t<T, VEC>(static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + h * p.q_sh +
                        qpos * p.q_ss, lane, p.D, qr);
  ld_cols_t<T, VEC>(static_cast<const T*>(p.dout) + row * p.D, lane, p.D, dor);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const int nk = lse > 0.5f * kNegInf ? p.S : 0;  // a row that saw no key: zeros
  for (int kpos = 0; kpos < nk; ++kpos) {
    float kr[VEC], vr[VEC];
    ld_cols_t<T, VEC>(kb + kpos * p.k_ss, lane, p.D, kr);
    ld_cols_t<T, VEC>(vb + kpos * p.v_ss, lane, p.D, vr);
    const float s = evo_logit(p, warp_sum_dot<VEC>(qr, kr), b1o, b2o, qpos, kpos);
    const float ds = Bits<T>::round(expf(s - lse) * (warp_sum_dot<VEC>(dor, vr) - delta));
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += ds * kr[j];
  }
  st_cols_t<T, VEC>(static_cast<T*>(p.dq) + row * p.D, lane, p.D, acc, p.scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kEvoSimtWarps * 32) evo_dkv_simt(EvoArgs p) {
  constexpr int VEC = HD / 32;
  const int bn = blockIdx.x, h = blockIdx.z;
  const int b = bn / p.N, n = bn % p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kpos = blockIdx.y * kEvoSimtWarps + warp;
  if (kpos >= p.S) return;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + h * p.q_sh;
  const long long b1o = b * p.b1_sb + n * p.b1_sn;
  const long long b2o = b * p.b2_sb + h * p.b2_sh;
  const long long r0 = ((long long)bn * p.H + h) * p.S;  // this (row, head)'s lse / delta
  float kr[VEC], vr[VEC], dk[VEC], dv[VEC];
  ld_cols_t<T, VEC>(static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + h * p.k_sh +
                        kpos * p.k_ss, lane, p.D, kr);
  ld_cols_t<T, VEC>(static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + h * p.v_sh +
                        kpos * p.v_ss, lane, p.D, vr);
#pragma unroll
  for (int j = 0; j < VEC; ++j) dk[j] = dv[j] = 0.f;
  float colsum = 0.f;
  for (int qpos = 0; qpos < p.S; ++qpos) {
    const float lse = p.lse[r0 + qpos];
    if (lse <= 0.5f * kNegInf) continue;  // a row that saw no key adds nothing
    float qr[VEC], dor[VEC];
    ld_cols_t<T, VEC>(qb + qpos * p.q_ss, lane, p.D, qr);
    ld_cols_t<T, VEC>(static_cast<const T*>(p.dout) +
                          (((long long)bn * p.S + qpos) * p.H + h) * p.D, lane, p.D, dor);
    const float s = evo_logit(p, warp_sum_dot<VEC>(qr, kr), b1o, b2o, qpos, kpos);
    const float pr = expf(s - lse);
    const float ds = pr * (warp_sum_dot<VEC>(dor, vr) - p.delta[r0 + qpos]);
    colsum += ds;
    const float prr = Bits<T>::round(pr), dsr = Bits<T>::round(ds);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      dv[j] += prr * dor[j];
      dk[j] += dsr * qr[j];
    }
  }
  const long long out = (((long long)bn * p.S + kpos) * p.H + h) * p.D;
  st_cols_t<T, VEC>(static_cast<T*>(p.dk) + out, lane, p.D, dk, p.scale);
  st_cols_t<T, VEC>(static_cast<T*>(p.dv) + out, lane, p.D, dv, 1.f);
  if (p.db1_part != nullptr && lane == 0) p.db1_part[r0 + kpos] = colsum;
}

// db2[b, h, q, k]: one warp a (query, key) pair, walking the N rows in order
template <typename T, int HD>
__global__ void __launch_bounds__(kEvoSimtWarps * 32) evo_db2_simt(EvoArgs p) {
  constexpr int VEC = HD / 32;
  const int b = blockIdx.x / p.S, qpos = blockIdx.x % p.S, h = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kpos = blockIdx.y * kEvoSimtWarps + warp;
  if (kpos >= p.S) return;
  const long long b2o = b * p.b2_sb + h * p.b2_sh;
  float acc = 0.f;
  for (int n = 0; n < p.N; ++n) {
    const long long bn = (long long)b * p.N + n;
    const long long r = (bn * p.H + h) * p.S + qpos;
    const float lse = p.lse[r];
    if (lse <= 0.5f * kNegInf) continue;
    float qr[VEC], kr[VEC], vr[VEC], dor[VEC];
    ld_cols_t<T, VEC>(static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + h * p.q_sh +
                          qpos * p.q_ss, lane, p.D, qr);
    ld_cols_t<T, VEC>(static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + h * p.k_sh +
                          kpos * p.k_ss, lane, p.D, kr);
    ld_cols_t<T, VEC>(static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + h * p.v_sh +
                          kpos * p.v_ss, lane, p.D, vr);
    ld_cols_t<T, VEC>(static_cast<const T*>(p.dout) + ((bn * p.S + qpos) * p.H + h) * p.D, lane,
                      p.D, dor);
    const float s = evo_logit(p, warp_sum_dot<VEC>(qr, kr), b * p.b1_sb + n * p.b1_sn, b2o,
                              qpos, kpos);
    acc += expf(s - lse) * (warp_sum_dot<VEC>(dor, vr) - p.delta[r]);
  }
  if (lane == 0) p.db2[(((long long)b * p.H + h) * p.S + qpos) * p.S + kpos] = acc;
}

template <typename T, int HD>
cudaError_t launch_bwd_simt(int which, const EvoArgs& a, cudaStream_t st) {
  const int rows = (a.S + kEvoSimtWarps - 1) / kEvoSimtWarps;
  if (which == 0)
    evo_dq_simt<T, HD><<<dim3(a.B * a.N, rows, a.H), kEvoSimtWarps * 32, 0, st>>>(a);
  else if (which == 1)
    evo_dkv_simt<T, HD><<<dim3(a.B * a.N, rows, a.H), kEvoSimtWarps * 32, 0, st>>>(a);
  else
    evo_db2_simt<T, HD><<<dim3(a.B * a.S, rows, a.H), kEvoSimtWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t launch_bwd_t(int which, const EvoArgs& a, cudaStream_t st) {
  constexpr size_t TILE = (size_t)kEvoTile * (HDP + 8) * sizeof(T);
  const int nt = (a.S + kEvoTile - 1) / kEvoTile;
  cudaError_t err = cudaSuccess;
  if (which == 0) {
    err = allow_dynamic_smem<evo_dq_kernel<T, HDP>>();
    if (err != cudaSuccess) return err;
    evo_dq_kernel<T, HDP><<<dim3(a.B * a.N, nt, a.H), kEvoWarps * 32, 4 * TILE, st>>>(a);
  } else if (which == 1) {
    err = allow_dynamic_smem<evo_dkv_kernel<T, HDP>>();
    if (err != cudaSuccess) return err;
    evo_dkv_kernel<T, HDP><<<dim3(a.B * a.N, nt, a.H), kEvoWarps * 32,
                             6 * TILE + 4 * kEvoTile * sizeof(float), st>>>(a);
  } else {
    err = allow_dynamic_smem<evo_db2_kernel<T, HDP>>();
    if (err != cudaSuccess) return err;
    evo_db2_kernel<T, HDP><<<dim3(a.B * nt, nt, a.H), kEvoWarps * 32,
                             8 * TILE + 6 * kEvoTile * sizeof(float), st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_d(int which, const EvoArgs& a, cudaStream_t st) {
  if (a.D <= 16) return launch_bwd_t<T, 16>(which, a, st);
  if (a.D <= 32) return launch_bwd_t<T, 32>(which, a, st);
  if (a.D <= 64) return launch_bwd_t<T, 64>(which, a, st);
  if (a.D <= 128) return launch_bwd_t<T, 128>(which, a, st);
  return launch_bwd_simt<T, 256>(which, a, st);
}

inline cudaError_t launch_bwd_f32(int which, const EvoArgs& a, cudaStream_t st) {
  if (a.D <= 64) return launch_bwd_simt<float, 64>(which, a, st);
  if (a.D <= 128) return launch_bwd_simt<float, 128>(which, a, st);
  return launch_bwd_simt<float, 256>(which, a, st);
}

}  // namespace dsk

// One backward kernel: which 0 dq (#14), 1 dk/dv (#15; with db1_part
// non-null it also writes bias1's per-head column sums), 2 dbias2 (#16), 3
// dbias1 (#17: db1 [B*N, S] from db1_part [B*N, H, S]).  q, k, v, biases,
// strides, codes, scale and dtype as ds_evoformer_fwd; do [B, N, S, H, D]
// contiguous in q's dtype; lse, delta [B*N, H, S] fp32; dq, dk, dv [B, N, S,
// H, D] contiguous; db2 [B, H, S, S] fp32.
extern "C" int ds_evoformer_bwd(int which, const void* q, const void* k, const void* v,
                                const void* b1, const void* b2, const void* dout,
                                const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                void* db1_part, void* db1, void* db2, int B, int N, int S, int H,
                                int D, const long long* qkv_strides,
                                const long long* bias_strides, int b1_code, int b2_code,
                                float scale, int dtype, void* stream) {
  const long long ntiles = (S + dsk::kEvoSimtWarps - 1) / dsk::kEvoSimtWarps;
  if (B < 1 || N < 1 || S < 1 || H < 1 || H > 65535 || D < 8 || D > 256 || D % 8 != 0 ||
      ntiles > 65535 || (long long)B * N > 2147483647LL || (long long)B * S > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (which == 3) {
    if (db1_part == nullptr || db1 == nullptr) return (int)cudaErrorInvalidValue;
    const long long total = (long long)B * N * S;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    dsk::evo_db1_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(db1_part),
                                                static_cast<float*>(db1), (long long)B * N, H, S);
    return (int)cudaGetLastError();
  }
  if (which < 0 || which > 2 || dout == nullptr || lse == nullptr || delta == nullptr ||
      (which == 0 && dq == nullptr) || (which == 1 && (dk == nullptr || dv == nullptr)) ||
      (which == 2 && db2 == nullptr))
    return (int)cudaErrorInvalidValue;
  dsk::EvoArgs a{};
  a.q = q; a.k = k; a.v = v; a.b1 = b1; a.b2 = b2;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.db1_part = static_cast<float*>(db1_part);
  a.db2 = static_cast<float*>(db2);
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
  if (dtype == 0) return (int)dsk::launch_bwd_f32(which, a, st);
  if (dtype == 1) return (int)dsk::launch_bwd_d<__half>(which, a, st);
  if (dtype == 2) return (int)dsk::launch_bwd_d<__nv_bfloat16>(which, a, st);
  return (int)cudaErrorInvalidValue;
}
