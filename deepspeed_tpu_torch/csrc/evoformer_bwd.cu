// Evoformer attention backward on Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/evoformer.py (launched by
// _bwd_impl):
//   _dq_kernel  -> evo_dq_kernel    dq  = scale * sum_k ds k
//   _dkv_kernel -> evo_dkv_kernel (attn_bwd_hopper.cuh)
//                                   dk  = scale * sum_q dsT q,  dv = sum_q pT do
//   _db2_kernel -> evo_db2_kernel, then evo_db2_sum_kernel
//                                   db2[b, h, q, k] = sum_n ds
//   _db1_kernel -> evo_dkv_kernel's per-head column sums of ds, then
//                  evo_db1_kernel   db1[bn, k] = sum_h (sum_q ds)
// Every kernel recomputes its tile as the reference's _tile_ds does:
//   s  = (q . k) * scale + bias1 + bias2  (evo_logit_s, shared with the forward)
//   p  = exp(s - lse), 0 on a row whose lse is -1e30 (it saw no key)
//   ds = p * (do . v - delta),  delta = rowsum(o * do) (fp32, from the caller)
// and casts as the reference does: ds to the inputs' dtype before the dq and
// dk products (scale applied to the fp32 sums), p to do's dtype before dv.
// The logit is subtracted from lse in natural units and only the difference
// goes to log2 units inside the exponential: at a -1e9 mask s and lse sit
// where the fp32 spacing is 64 and must cancel exactly as in the forward.
//
// What bounds it on the H100: bytes at AlphaFold2's widths, with
// operations close behind (D = 32: dq 3, dk/dv 4 and dbias2 2 products of
// 2*D flops per (query, key) pair against q, k, v and do read once, bias2
// once per (head, query, key)); in practice the scalar work per logit (the
// biases, the exponential, ~8 fp32 operations) sets the pace.  What the
// design does about it:
//   - dq: the forward's grid (batch * MSA row, 64-query tile, head), 4 warps
//     x 16 query rows on mma.sync, q and do fragments in registers, 64-key
//     tiles of K and V double-buffered through shared memory with 16-byte
//     cp.async.
//   - dk/dv (16-bit, D up to 128): evo_dkv_kernel, the flash backward's
//     warp-specialised TMA + wgmma dk/dv design (attn_bwd_hopper.cuh): 128 keys of one (batch * row, head) a unit, the
//     query tiles streamed with their bias2 tile, lse and delta rows, bias1's
//     per-head column sums of ds written beside dk and dv.
//   - dbias2 (16-bit, D up to 128): evo_db2_kernel, warp-specialised and
//     persistent on TMA + wgmma.  A unit is (batch, chunk of MSA rows, head,
//     128 queries, 64 keys): the producer warpgroup streams each row's Q,
//     dO, K and V tiles (TMA) with its lse, delta and bias1 rows through a
//     ring; the two consumer warpgroups (64 queries each) recompute s and
//     dp on wgmma and add ds into an fp32 accumulator in registers, walking
//     the chunk's rows in ascending order; the unit's bias2 values, the same
//     for every row, are read once into registers (a unit ahead).  Q, dO,
//     K and V rows are 64 bytes (the 64-byte swizzle) at head dims up to
//     32, so the ring holds 8 stages.  The chunks partition
//     the N rows in ascending order, as many as fill the SMs about eight
//     times over, so that the rows' serial walk is split; each unit writes
//     its fp32 partial [chunks, B, H, S, S], and evo_db2_sum_kernel adds the
//     chunks in ascending order into db2.  The tile pairs of one (head,
//     chunk) are neighbouring units, so a row's Q, dO, K and V come from L2
//     after the first read.
//   - no atomics: every sum runs in a fixed order, so a run is
//     deterministic.  q, k, v and both biases are read through their
//     strides, head_dim is padded to HDP in {16, 32, 64, 128} (mma.sync,
//     zeros in shared memory) or to 64 columns a TMA box (zero fill), and
//     keys / rows past S are neither used nor written.
//   - fp32 inputs, and 16-bit inputs with D above 128 (the dk/dv
//     accumulators of 256 columns would need 256 fp32 registers a thread),
//     take the CUDA-core variants evo_*_simt below.
// ops/evoformer.py evo_bwd_plan gives dk/dv's and dbias2's tiles, ring
// depths, slots and chunks by BwdLayout::evo_dkv's and Db2Layout's formulas.
#include "attn_bwd_hopper.cuh"

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

// ------------------------------------------------------------ dbias2 (#16)
constexpr int kDb2Rows = 128, kDb2Keys = 64;  // queries, keys a unit

// A tile row of head dim HD: 64 bytes (32 columns, the 64-byte swizzle) up
// to 32, else HD/64 boxes of 128 bytes (the 128-byte swizzle); the short
// rows keep the narrow heads' stages small, so the ring is deep.
template <int HD>
__host__ __device__ constexpr int db2_row_bytes() {
  return HD <= 32 ? 64 : (HD + 63) / 64 * 128;
}

// Shared memory: the mbarriers, slack to align the rest to 1024 bytes, then
// the ring's stages: Q and dO [128 queries][row], K and V [64 keys][row]
// (a row of 128-byte boxes: [boxes][rows][128 B]), then the lse and delta
// rows (128 fp32 each) and the keys' bias1 (64 fp32), a stage rounded up to
// 1024 bytes.
struct Db2Layout {
  int q_tile, k_tile, stage_bytes;
  __host__ __device__ explicit Db2Layout(int row_bytes) {
    q_tile = kDb2Rows * row_bytes;
    k_tile = kDb2Keys * row_bytes;
    stage_bytes = (2 * q_tile + 2 * k_tile + (2 * kDb2Rows + kDb2Keys) * 4 + 1023) / 1024 * 1024;
  }
  size_t smem(int stages) const {
    return (size_t)kBwdBarBytes + 1024 + (size_t)stages * stage_bytes;
  }
};

// unit u -> (batch, chunk, head, query tile, key tile): the tile pairs of
// one (head, chunk) neighbours, then the heads, the chunks, the batches
__device__ __forceinline__ void db2_unit(const BwdArgs& p, int u, int& b, int& chunk, int& h,
                                         int& qt, int& kt) {
  const int nkt = (p.T + kDb2Keys - 1) / kDb2Keys, tiles = nkt * ((p.T + kDb2Rows - 1) / kDb2Rows);
  const int t = u % tiles;
  int r = u / tiles;
  h = r % p.N;
  r /= p.N;
  chunk = r % p.chunks;
  b = r / p.chunks;
  qt = t / nkt;
  kt = t % nkt;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    evo_db2_kernel(const __grid_constant__ BwdArgs p, const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmdo,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv) {
  // RB-byte rows: NAT boxes of RB bytes (RB/2 columns) a row
  constexpr int RB = HD <= 32 ? 64 : 128, NAT = db2_row_bytes<HD>() / RB, NS = kDb2Keys / 2;
  static_assert(HD % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* full = bars + 4;
  uint64_t* empty = full + kBwdMaxStages;
  unsigned char* ring = smem_raw + kBwdBarBytes;
  ring += (1024 - (smem_u32(ring) & 1023)) & 1023;
  const Db2Layout lay(db2_row_bytes<HD>());
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  // a stage is full once its TMA bytes have landed and the 128 producer
  // threads have written its lse, delta and bias1 rows
  if (threadIdx.x == 0) init_bwd_barriers(bars, p.stages, 1, 128);
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    // Thread 0 issues the TMA copies; every thread stages one query's lse
    // and delta and (below 64) one key's bias1 a stage, loaded a stage
    // ahead and converted only when stored, so their latency runs under the
    // wait for a free stage.
    setmaxnreg_dec<kEvoRegProducer>();
    const int pt = threadIdx.x;
    int u = blockIdx.x, b = 0, chunk = 0, h = 0, qt = 0, kt = 0, n = 0, n1 = 0;
    float lraw = 0.f, draw = 0.f;
    uint32_t braw = 0u;
    auto begin_unit = [&]() {
      if (u >= p.units) return;
      db2_unit(p, u, b, chunk, h, qt, kt);
      n = chunk * p.chunk_rows;
      n1 = min(p.rows, n + p.chunk_rows);
    };
    auto fetch = [&]() {
      const long long rows = (((long long)b * p.rows + n) * p.N + h) * p.T;
      const int q = qt * kDb2Rows + pt, kpos = kt * kDb2Keys + pt;
      lraw = q < p.T ? p.lse[rows + q] : kNegInf;
      draw = q < p.T ? p.delta[rows + q] : 0.f;
      braw = pt < kDb2Keys && kpos < p.T && p.b1_code >= 0
                 ? load_bias_bits(p.b1, b * p.b1_sb + n * p.b1_sn + kpos * p.b1_sk, p.b1_code)
                 : 0u;
    };
    begin_unit();
    if (u < p.units) fetch();
    for (int it = 0; u < p.units; ++it) {
      const int s = it % p.stages;
      if (it >= p.stages) mbar_wait(&empty[s], (it / p.stages - 1) & 1);
      unsigned char* st = ring + (size_t)s * lay.stage_bytes;
      if (pt == 0) {
        const int q0 = qt * kDb2Rows, k0 = kt * kDb2Keys;
        mbar_expect_tx_only(&full[s], 2 * lay.q_tile + 2 * lay.k_tile);  // all 128 arrive
#pragma unroll
        for (int cb = 0; cb < NAT; ++cb) {
          const int col = cb * RB / 2;
          tma_load_5d(st + cb * kDb2Rows * RB, &tmq, col, tma_c(p.cq, 1, h), q0,
                      tma_c(p.cq, 3, n), tma_c(p.cq, 4, b), &full[s]);
          tma_load_5d(st + lay.q_tile + cb * kDb2Rows * RB, &tmdo, col, tma_c(p.cdo, 1, h), q0,
                      tma_c(p.cdo, 3, n), tma_c(p.cdo, 4, b), &full[s]);
          tma_load_5d(st + 2 * lay.q_tile + cb * kDb2Keys * RB, &tmk, col, tma_c(p.ck, 1, h), k0,
                      tma_c(p.ck, 3, n), tma_c(p.ck, 4, b), &full[s]);
          tma_load_5d(st + 2 * lay.q_tile + lay.k_tile + cb * kDb2Keys * RB, &tmv, col,
                      tma_c(p.cv, 1, h), k0, tma_c(p.cv, 3, n), tma_c(p.cv, 4, b), &full[s]);
        }
      }
      // lse in natural units (+inf: a row that saw no key, or past T),
      // delta (0 past T), the keys' bias1 (0 if absent or past T)
      float* stats = reinterpret_cast<float*>(st + 2 * lay.q_tile + 2 * lay.k_tile);
      stats[pt] = lraw > 0.5f * kNegInf ? lraw : __int_as_float(0x7f800000);
      stats[kDb2Rows + pt] = draw;
      if (pt < kDb2Keys)
        stats[2 * kDb2Rows + pt] = p.b1_code >= 0 ? bias_of_bits(braw, p.b1_code) : 0.f;
      mbar_arrive(&full[s]);
      if (++n == n1) {
        u += gridDim.x;
        begin_unit();
      }
      if (u < p.units) fetch();
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kEvoRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  const int rl = 64 * c + 16 * w + grp;  // this thread's rows rl, rl + 8 of a tile
  float sc[NS], dp[NS], acc[NS], b2v[NS];
  uint32_t b2n[NS];  // the next unit's bias2 bits, loaded a unit ahead
  // this thread's bias2 bits of unit u (0 past T: such a logit is never kept)
  auto fetch_b2 = [&](int u) {
    int b, chunk, h, qt, kt;
    db2_unit(p, u, b, chunk, h, qt, kt);
    const long long o2 = b * p.b2_sb + h * p.b2_sh;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = qt * kDb2Rows + rl + 8 * hh, kpos = kt * kDb2Keys + 8 * j + 2 * tq + e;
          b2n[4 * j + 2 * hh + e] =
              q < p.T && kpos < p.T
                  ? load_bias_bits(p.b2, o2 + q * p.b2_sq + kpos * p.b2_sk, p.b2_code)
                  : 0u;
        }
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) sc[j] = dp[j] = 0.f;
  int it = 0;
  if (blockIdx.x < p.units) fetch_b2(blockIdx.x);
  if (c == 1) turn_pass(c);  // the first consumer warpgroup takes the first turn
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    int b, chunk, h, qt, kt;
    db2_unit(p, u, b, chunk, h, qt, kt);
    const int k0 = kt * kDb2Keys, rw = qt * kDb2Rows + rl;
    const int n1 = min(p.rows, (chunk + 1) * p.chunk_rows);
    // the unit's bias2, the same for every row, and the next unit's loads
#pragma unroll
    for (int x = 0; x < NS; ++x) {
      b2v[x] = bias_of_bits(b2n[x], p.b2_code);
      acc[x] = 0.f;
    }
    if (u + gridDim.x < p.units) fetch_b2(u + gridDim.x);
    for (int n = chunk * p.chunk_rows; n < n1; ++n, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const unsigned char* st = ring + (size_t)s * lay.stage_bytes;
      const unsigned char* qs = st + c * 64 * RB;
      const unsigned char* ks = st + 2 * lay.q_tile;
      // s = q kT, dp = do vT (queries the accumulator rows)
      wg_fence_regs(sc);
      wg_fence_regs(dp);
      turn_wait(c);
      wg_fence();
      kmajor_product<T, HD, kDb2Keys, RB>(sc, qs, kDb2Rows, ks);
      kmajor_product<T, HD, kDb2Keys, RB>(dp, qs + lay.q_tile, kDb2Rows, ks + lay.k_tile);
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      wg_fence_regs(sc);
      wg_fence_regs(dp);
      const float* stats = reinterpret_cast<const float*>(ks + 2 * lay.k_tile);
      float lse[2], delta[2];
      float2 b1[NS / 4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        lse[hh] = stats[rl + 8 * hh];
        delta[hh] = stats[kDb2Rows + rl + 8 * hh];
      }
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
        b1[j] = *reinterpret_cast<const float2*>(stats + 2 * kDb2Rows + 8 * j + 2 * tq);
      warp_arrive(&empty[s], lane);  // the stage is read: the producer may refill it
      // acc += exp(s - lse) (dp - delta), s the reference's logit
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e;
            const float sl = evo_logit_s(sc[x], p.scale, true, e ? b1[j].y : b1[j].x, true, b2v[x]);
            acc[x] = fmaf(ex2((sl - lse[hh]) * kLog2e), dp[x] - delta[hh], acc[x]);
          }
    }
    // ---- epilogue: this unit's partial sum, a thread's two keys of a row
    // as one 8-byte store where S is even
    float* out = p.part + ((((long long)chunk * p.B + b) * p.N + h) * p.T) * p.T;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = rw + 8 * hh, kpos = k0 + 8 * j + 2 * tq;
        float* o = out + (long long)q * p.T + kpos;
        const float2 v = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        if (q >= p.T || kpos >= p.T) continue;
        if (p.T % 2 == 0) {
          *reinterpret_cast<float2*>(o) = v;
        } else {
          o[0] = v.x;
          if (kpos + 1 < p.T) o[1] = v.y;
        }
      }
  }
}

// db2 = the chunks' partial sums [chunks, total] added in ascending order
__global__ void evo_db2_sum_kernel(const float* __restrict__ part, float* __restrict__ db2,
                                   long long total, int chunks) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (total % 4 == 0) {
    const long long n4 = total / 4;
    const float4* src = reinterpret_cast<const float4*>(part);
    for (long long i = i0; i < n4; i += stride) {
      float4 s = src[i];
      for (int c = 1; c < chunks; ++c) {
        const float4 v = src[c * n4 + i];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      reinterpret_cast<float4*>(db2)[i] = s;
    }
  } else {
    for (long long i = i0; i < total; i += stride) {
      float s = part[i];
      for (int c = 1; c < chunks; ++c) s += part[c * total + i];
      db2[i] = s;
    }
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
cudaError_t launch_dq(const EvoArgs& a, cudaStream_t st) {
  constexpr size_t TILE = (size_t)kEvoTile * (HDP + 8) * sizeof(T);
  const int nt = (a.S + kEvoTile - 1) / kEvoTile;
  const cudaError_t err = allow_dynamic_smem<evo_dq_kernel<T, HDP>>();
  if (err != cudaSuccess) return err;
  evo_dq_kernel<T, HDP><<<dim3(a.B * a.N, nt, a.H), kEvoWarps * 32, 4 * TILE, st>>>(a);
  return cudaGetLastError();
}

// The plan of a 16-bit dk/dv or dbias2 launch (ops/evoformer.py
// evo_bwd_plan): ring depth, slots, chunks of MSA rows.
struct EvoPlan {
  int stages, slots, chunks;
};

// dk/dv (which 1) on evo_dkv_kernel and dbias2 (which 2) on
// evo_db2_kernel: q, k, v [B, N, S, H, D] as 5-D tensor maps (D, head,
// token, row, batch) through their strides and do the same contiguous, in
// boxes of [rows, 64 columns] in the 128-byte swizzle (the columns past D
// zero-filled); dk/dv's bias2 [B, H, S, S] as a 4-D map in boxes of [BM
// queries, 128 bytes of keys] where its layout allows (keys contiguous,
// 16-byte aligned base and strides, queries not broadcast), else staged
// element by element.
template <typename T, int HD>
cudaError_t launch_bwd_wgmma(int which, const EvoArgs& a, const EvoPlan& plan, cudaStream_t st) {
  const int b2_esz = a.b2_code < 0 ? 0 : (a.b2_code == 0 ? 4 : 2);
  constexpr int BM = HD <= 64 ? 64 : 32;  // dk/dv's queries a stage
  BwdArgs p{};
  p.lse = a.lse; p.delta = a.delta; p.dout = a.dout;
  p.dk = a.dk; p.dv = a.dv;
  p.T = a.S; p.N = a.H; p.Nkv = a.H; p.hd = a.D; p.rows = a.N;
  p.B = which == 1 ? a.B * a.N : a.B;
  p.stages = plan.stages; p.slots = plan.slots;
  p.scale = a.scale;
  p.b1 = a.b1; p.b1_sb = a.b1_sb; p.b1_sn = a.b1_sn; p.b1_sk = a.b1_sk; p.b1_code = a.b1_code;
  p.b2 = a.b2; p.b2_sb = a.b2_sb; p.b2_sh = a.b2_sh; p.b2_sq = a.b2_sq; p.b2_sk = a.b2_sk;
  p.b2_code = a.b2_code;
  p.db1_part = a.db1_part;
  p.part = a.db2_part;
  const long long dims[5] = {a.D, a.H, a.S, a.N, a.B};
  const long long sq[5] = {1, a.q_sh, a.q_ss, a.q_sn, a.q_sb},
                  sk[5] = {1, a.k_sh, a.k_ss, a.k_sn, a.k_sb},
                  sv[5] = {1, a.v_sh, a.v_ss, a.v_sn, a.v_sb},
                  sdo[5] = {1, a.D, (long long)a.H * a.D, (long long)a.S * a.H * a.D,
                            (long long)a.N * a.S * a.H * a.D};
  // dbias2 at head dims up to 32 reads rows of 64 bytes (the 64-byte swizzle)
  const bool narrow = which == 2 && HD <= 32;
  const int q_rows = which == 1 ? BM : kDb2Rows, k_rows = which == 1 ? 128 : kDb2Keys;
  const int cols = narrow ? 32 : 64;
  const int box_q[5] = {cols, 1, q_rows, 1, 1}, box_k[5] = {cols, 1, k_rows, 1, 1};
  CUtensorMap tmq{}, tmdo{}, tmk{}, tmv{}, tmb2{};
  const auto sw = narrow ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_nd(&tmq, tma_dtype<T>(), 2, a.q, 5, dims, sq, box_q, sw, &p.cq) ||
      !tensor_map_nd(&tmdo, tma_dtype<T>(), 2, a.dout, 5, dims, sdo, box_q, sw, &p.cdo) ||
      !tensor_map_nd(&tmk, tma_dtype<T>(), 2, a.k, 5, dims, sk, box_k, sw, &p.ck) ||
      !tensor_map_nd(&tmv, tma_dtype<T>(), 2, a.v, 5, dims, sv, box_k, sw, &p.cv))
    return cudaErrorInvalidValue;
  if (which == 2) {
    // the rows split as evo_bwd_plan splits them: chunk_rows = ceil(N /
    // chunks), and no chunk empty
    if (plan.chunks < 1 || a.db2_part == nullptr) return cudaErrorInvalidValue;
    p.chunks = plan.chunks;
    p.chunk_rows = (a.N + plan.chunks - 1) / plan.chunks;
    if ((a.N + p.chunk_rows - 1) / p.chunk_rows != plan.chunks) return cudaErrorInvalidValue;
    const long long units = (long long)a.B * plan.chunks * a.H *
                            ((a.S + kDb2Rows - 1) / kDb2Rows) * ((a.S + kDb2Keys - 1) / kDb2Keys);
    p.slots = 1;
    const size_t smem = Db2Layout(db2_row_bytes<HD>()).smem(p.stages);
    int grid = 0;
    cudaError_t err = bwd_grid(p, smem, units, grid);
    if (err != cudaSuccess) return err;
    p.units = (int)units;
    err = allow_dynamic_smem<evo_db2_kernel<T, HD>>();
    if (err != cudaSuccess) return err;
    evo_db2_kernel<T, HD><<<grid, kBwdThreads, smem, st>>>(p, tmq, tmdo, tmk, tmv);
    return cudaGetLastError();
  }
  if (a.b2_code >= 0) {
    const CUtensorMapDataType dt = a.b2_code == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : a.b2_code == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const long long d2[4] = {a.S, a.S, a.H, a.B}, s2[4] = {a.b2_sk, a.b2_sq, a.b2_sh, a.b2_sb};
    const int box2[4] = {128 / b2_esz, BM, 1, 1};
    // a bias2 broadcast over queries (query stride 0) collapses that dim to
    // one row, which a box of BM rows cannot read: element by element
    p.b2_tma = (reinterpret_cast<uintptr_t>(a.b2) % 16 == 0) &&
               tensor_map_nd(&tmb2, dt, b2_esz, a.b2, 4, d2, s2, box2, sw, &p.cb2) &&
               (!(p.cb2 & 2) || a.S == 1);
  }
  return launch_evo_dkv<T, HD, BM>(p, tmk, tmv, tmq, tmdo, tmb2, st);
}

template <typename T, int HD>
cudaError_t launch_bwd_hd(int which, const EvoArgs& a, const EvoPlan& plan, cudaStream_t st) {
  if (which == 0) return launch_dq<T, HD>(a, st);
  return launch_bwd_wgmma<T, HD>(which, a, plan, st);
}

template <typename T>
cudaError_t launch_bwd_d(int which, const EvoArgs& a, const EvoPlan& plan, cudaStream_t st) {
  if (a.D <= 16) return launch_bwd_hd<T, 16>(which, a, plan, st);
  if (a.D <= 32) return launch_bwd_hd<T, 32>(which, a, plan, st);
  if (a.D <= 64) return launch_bwd_hd<T, 64>(which, a, plan, st);
  if (a.D <= 128) return launch_bwd_hd<T, 128>(which, a, plan, st);
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
// contiguous in q's dtype; lse, delta [B*N, H, S] fp32; dq, dk, dv [B, N,
// S, H, D] contiguous; db2 [B, H, S, S] fp32.  16-bit inputs with D up to
// 128 take dk/dv and dbias2 on the tensor-core kernels, tiled by `stages`,
// `slots` and `chunks` (ops/evoformer.py evo_bwd_plan); their dbias2
// writes its partial sums to db2_part [chunks, B, H, S, S] fp32, and
// ds_evoformer_db2_sum then makes db2.  fp32 and D above 128 (the
// CUDA-core variants) ignore the plan and write db2 directly.
extern "C" int ds_evoformer_bwd(int which, const void* q, const void* k, const void* v,
                                const void* b1, const void* b2, const void* dout,
                                const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                void* db1_part, void* db1, void* db2, void* db2_part, int B,
                                int N, int S, int H, int D, const long long* qkv_strides,
                                const long long* bias_strides, int b1_code, int b2_code,
                                float scale, int stages, int slots, int chunks, int dtype,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const long long ntiles = (S + dsk::kEvoSimtWarps - 1) / dsk::kEvoSimtWarps;
  if (B < 1 || N < 1 || S < 1 || H < 1 || H > 65535 || D < 8 || D > 256 || D % 8 != 0 ||
      ntiles > 65535 || (long long)B * N > 2147483647LL || (long long)B * S > 2147483647LL)
    return (int)cudaErrorInvalidValue;
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
      (which == 2 && db2 == nullptr && db2_part == nullptr))
    return (int)cudaErrorInvalidValue;
  dsk::EvoArgs a{};
  a.q = q; a.k = k; a.v = v; a.b1 = b1; a.b2 = b2;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.db1_part = static_cast<float*>(db1_part);
  a.db2 = static_cast<float*>(db2);
  a.db2_part = static_cast<float*>(db2_part);
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
  if (which == 2 && a.b2_code < 0) return (int)cudaErrorInvalidValue;  // dbias2 needs bias2
  const dsk::EvoPlan plan{stages, slots, chunks};
  if (dtype == 0) {
    if (which == 2 && db2 == nullptr) return (int)cudaErrorInvalidValue;
    return (int)dsk::launch_bwd_f32(which, a, st);
  }
  if (D > 128 && which == 2 && db2 == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)dsk::launch_bwd_d<__half>(which, a, plan, st);
  if (dtype == 2) return (int)dsk::launch_bwd_d<__nv_bfloat16>(which, a, plan, st);
  return (int)cudaErrorInvalidValue;
}

// dbias2's second pass: db2 (`total` fp32) = the `chunks` partials of
// part [chunks, total] added in ascending order.
extern "C" int ds_evoformer_db2_sum(const void* part, void* db2, long long total, int chunks,
                                    void* stream) {
  if (total < 1 || chunks < 1 || part == nullptr || db2 == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long n = total % 4 == 0 ? total / 4 : total;
  const int blocks = (int)((n + 255) / 256 < 1056 ? (n + 255) / 256 : 1056);
  dsk::evo_db2_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(db2), total, chunks);
  return (int)cudaGetLastError();
}
