// The attention backward on Hopper (sm_90a), 16-bit q, k, v, do:
// flash_dq_kernel (#4) and flash_dkv_kernel (#5), built in
// flash_attention.cu, and evo_dkv_kernel, the evoformer's dk/dv on the same
// design (#15, with #17's column sums), built in evoformer_bwd.cu.  The flash kernels replace
// the TPU kernels _dq_kernel and _dkv_kernel of
// deepspeed_tpu/ops/flash_attention.py (both launched by _bwd_impl) and
// compute what those compute: from the forward's per-row logsumexp, p =
// exp(q kT * scale [+ slope * kpos] - lse), ds = p (do vT - delta) * scale
// with delta = rowsum(o * do), dq = ds k, dk = dsT q, dv = pT do; causal or
// not, a sliding window, alibi, GQA (k / v at head h / group, never
// expanded; dk, dv summed over the group), any T.  The evoformer variant
// replaces _dkv_kernel of deepspeed_tpu/ops/evoformer.py (see evoformer below).
//
// What bounds them on the H100: operations.  dq does 3 products a visible
// (query, key) pair (s, dp, ds k: 6*D flops), dk/dv 4 (s, dp, pT do, dsT q:
// 8*D flops), against the 989 TFLOP/s dense bf16 peak; the bytes (each
// tensor read once a 128-row tile) are far below the card's ~295
// flop/byte line.  Beside the products, each pair takes one exponential
// and ~6 scalar operations, which at head dim 64 cost about as many issue
// slots as the products take tensor-core cycles.  The design:
//   - both kernels are warp-specialised and persistent, as the forward
//     (attn_fwd_hopper.cuh): one block of 3 warpgroups an SM walks units
//     blockIdx.x + i * gridDim.x; warpgroup 0 gives its registers back
//     (setmaxnreg) and issues TMA copies into a "slot" (the unit's fixed
//     tiles, 1-2 slots so the next unit's load overlaps this one) and a
//     ring of stages (the tiles the unit walks); every tile is 64 16-bit
//     columns a box (128 bytes) in the 128-byte swizzle wgmma reads both
//     K-major and MN-major (the transpose bit), a head dim short of a
//     multiple of 64 zero-filled by TMA;
//   - warpgroups 1 and 2 take 64 rows each and every product is a wgmma
//     (fp32 accumulate): the two score-like products with both operands
//     K-major in shared memory, then p / ds packed in place to 16 bits as
//     the register A operand of the accumulating products, whose B is the
//     same shared-memory tile read MN-major - no transposed copy is made.
//     The two warpgroups take turns at issuing (named barriers), so one's
//     exponentials run under the other's products;
//   - dq: a unit is (batch, q head, 128 queries), the heaviest causal ones
//     first; Q and dO sit in the slot, K and V stream through the ring
//     (128 keys a stage at head dim 64, 64 up to 192, 32 at 256).  The dq
//     accumulator is 64 x HD fp32 a warpgroup (128 registers a thread at
//     256), so no head dim splits its columns over blocks.  Three warps of
//     the producer warpgroup make each unit's delta = rowsum(o * do) (when
//     the caller gives none) a slot ahead of the consumers and write it
//     out [B, N, T] for dk/dv;
//   - dk/dv: a unit is (batch, kv head, 128 keys), the heaviest causal ones
//     first; K and V sit in the slot, and the ring streams the Q and dO
//     tiles (BM queries: 128 at head dim 64, 64 above) of every q head of
//     the GQA group and every q tile that sees the unit's keys, with their
//     lse (log2 units) and delta rows, in a fixed order: dk and dv are
//     summed over the group in registers, with no atomics.  Above head dim
//     128, dk + dv of 64 keys fill a warpgroup's registers, so a unit is 64
//     keys and the two warpgroups split dk / dv's 64-column blocks between
//     them (each recomputes the unit's sT and dpT; Q and dO still load
//     once a unit);
//   - evoformer dk/dv (evo_dkv_kernel, D up to 128 at the compiled widths 16,
//     32, 64, 128: the score products take HD / 16 k-steps): a unit is
//     (batch * MSA row, head, 128 keys), the key tiles and heads of one row
//     side by side, so its Q and dO come from device memory about once and
//     bias2 (shared over rows) stays in L2.  The slot holds K, V and the
//     keys' bias1 slice (fp32); a stage Q, dO, the [BM queries, 128 keys]
//     bias2 tile (by TMA where its layout allows, element by element by the
//     producer warpgroup otherwise) and the lse (natural units) and delta
//     rows.  The logits follow the reference's order in fp32 (evo_logit_s:
//     (q . k) * scale, + bias1, + bias2), lse is subtracted in natural units
//     before the exponential (at a -1e9 mask s and lse cancel exactly), a
//     row whose lse is -1e30 gives p = 0; ds is rounded to 16 bits unscaled
//     and the scale goes on dk's fp32 sum, as the reference casts.  Each
//     thread also sums ds over its queries for its two keys, and the four
//     lanes of a key add theirs in a fixed order into bias1's per-head
//     column sums (db1_part), so dbias1 (#17) costs no recompute.  The
//     scalar work a pair (three logit steps, the bias2 load, the
//     exponential, ds, the column sum) outweighs the products at these head
//     dims, so each consumer warpgroup pipelines: stage i+1's score products
//     and stage i's dk / dv products are issued together and run under
//     stage i+1's exponentials.  BM is 64 queries up to head dim 64, 32 at
//     128 (dk + dv take 128 registers a thread there), and the producer
//     warpgroup keeps 64 registers for its stage-ahead loads;
//   - flash: each consumer warpgroup runs one tile at a time (products,
//     then its exponentials, then the accumulating products): keeping the
//     next tile's products in flight under this one's exponentials, as the
//     forward does, measured slower here (it holds two ring stages and
//     more registers);
//   - masking: only a tile that crosses the causal diagonal, the window's
//     edge or T is tested entry by entry (every wgmma is issued on every
//     path: a wgmma behind a branch ptxas cannot prove uniform makes it
//     serialise them all); scores are in log2 units; a row that sees no
//     key (lse -1e30) gets probabilities 0, so zeros.  The evoformer needs
//     no mask: a query past T has lse +inf staged (p = 0), a key past T is
//     a row of dk / dv that is never stored;
//   - deterministic: no atomics, a fixed walk; dq, dk, dv (and the column
//     sums) are bitwise equal from run to run.
// ops/flash_attention.py flash_bwd_plan gives the flash tiles, ring depth
// and slots by BwdLayout's formula, ops/evoformer.py evo_bwd_plan the
// evoformer's (BwdLayout::evo_dkv).
#pragma once

#include "attn_fwd_hopper.cuh"

namespace dsk {

constexpr int kBwdThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kBwdMaxStages = 8;
// registers a thread after setmaxnreg: dq's producer warpgroup also makes
// delta (three warps), dk/dv's only loads.  The consumers can take only what
// the producer gives back of the block's 384 x 168 (a larger ask waits
// forever).
// The evoformer's producers stage bias1, lse and delta a stage ahead in
// every thread of their warpgroup.
constexpr int kDqRegProducer = 56, kDqRegConsumer = 224;
constexpr int kDkvRegProducer = 40, kDkvRegConsumer = 232;
constexpr int kEvoRegProducer = 64, kEvoRegConsumer = 216;
static_assert(128 * kDqRegProducer + 256 * kDqRegConsumer <= 384 * 168 &&
                  128 * kDkvRegProducer + 256 * kDkvRegConsumer <= 384 * 168 &&
                  128 * kEvoRegProducer + 256 * kEvoRegConsumer <= 384 * 168,
              "setmaxnreg beyond the block's registers");
constexpr int kBwdBarBytes = (4 + 2 * kBwdMaxStages) * 8;
constexpr int kDqRows = 128;           // queries a dq unit

// queries a dk/dv stage: 128 at head dim 64, 64 above (where dk + dv take
// 128 registers a thread)
template <int HD>
__host__ __device__ constexpr int dkv_bm() {
  return HD > 64 ? 64 : 128;
}

// keys a dq stage: 128 at head dim 64, 64 up to 192, 32 at 256 (where Q
// and dO take 128 KB and dq 128 registers a thread)
template <int HD>
__host__ __device__ constexpr int dq_bn() {
  return HD > 192 ? 32 : (HD > 64 ? 64 : 128);
}

// Shared memory: the mbarriers, slack to align the rest to 1024 bytes (the
// swizzle's period), `slots` slots of two [HDP/64][slot_rows][128 B] tiles
// (dq: Q, dO; dk/dv: K, V), then the ring's stages of two [HDP/64]
// [ring_rows][128 B] tiles (dq: K, V; dk/dv: Q, dO, then the lse and delta
// rows, ring_rows fp32 each), a stage rounded up to 1024 bytes; dq then
// keeps each slot's delta rows (slot_rows fp32) after the ring.  The
// evoformer's dk/dv (evo_dkv): a slot adds the keys' bias1 slice (128 fp32)
// and is rounded up to 1024 bytes; a stage puts the [ring_rows, 128 keys]
// bias2 tile ([b2_esz][ring_rows][128 B]) between dO and the lse / delta
// rows.
struct BwdLayout {
  int slot_tile, ring_tile, b2_bytes, slot_bytes, stage_bytes, slot_delta;
  __host__ __device__ BwdLayout(int hdp, int slot_rows, int ring_rows, bool dq) {
    slot_tile = slot_rows * hdp * 2;
    ring_tile = ring_rows * hdp * 2;
    b2_bytes = 0;
    slot_bytes = 2 * slot_tile;
    stage_bytes = (2 * ring_tile + (dq ? 0 : 2 * ring_rows * 4) + 1023) / 1024 * 1024;
    slot_delta = dq ? slot_rows * 4 : 0;
  }
  static __host__ __device__ BwdLayout evo_dkv(int hdp, int bm, int b2_esz) {
    BwdLayout l(hdp, 128, bm, false);
    l.b2_bytes = bm * 128 * b2_esz;
    l.slot_bytes = (2 * l.slot_tile + 128 * 4 + 1023) / 1024 * 1024;
    l.stage_bytes = (2 * l.ring_tile + l.b2_bytes + 2 * bm * 4 + 1023) / 1024 * 1024;
    return l;
  }
  size_t smem(int stages, int slots) const {
    return (size_t)kBwdBarBytes + 1024 + (size_t)slots * (slot_bytes + slot_delta) +
           (size_t)stages * stage_bytes;
  }
};

struct BwdArgs {
  const float* lse;     // [B, N, T], natural log
  const float* delta;   // [B, N, T] rowsum(o * do), or null: dq makes it
  float* delta_out;     // dq: where the delta it makes goes, or null
  const void* o;        // dq without delta: o [B, T, N, hd] contiguous
  const void* dout;     // do [B, T, N, hd] contiguous
  void *dq, *dk, *dv;   // contiguous [B, T, N or Nkv, hd]
  const float* slopes;  // alibi [N] fp32 or null
  int B, T, N, Nkv, hd;
  int units, ntiles, stages, slots;
  int cq, ck, cv, cdo;  // collapsed dims of the tensor maps (coordinate 0)
  float scale;          // natural units
  int causal, window;
  // evoformer (q, k, v, do [batch, rows, T, N, hd] as 5-D maps; N the
  // heads): dk/dv runs with B = batch * rows, dbias2 with B = batch.  bias1
  // viewed [batch, rows, T], bias2 [batch, N, T, T] through element
  // strides, codes -1 absent / 0 fp32 / 1 fp16 / 2 bf16; b2_tma: bias2 by
  // TMA (map tmb2, collapsed dims cb2).  db1_part [B, N, T]: bias1's
  // per-head column sums of ds (or null).  dbias2: the rows split into
  // `chunks` chunks of chunk_rows (the last shorter), part [chunks, batch,
  // N, T, T] fp32 its partial sums.
  int rows;
  const void *b1, *b2;
  long long b1_sb, b1_sn, b1_sk, b2_sb, b2_sh, b2_sq, b2_sk;
  int b1_code, b2_code, b2_tma, cb2;
  float* db1_part;
  int chunks, chunk_rows;
  float* part;
};

// two 16-bit values (one 32-bit word) as floats
template <typename T>
__device__ __forceinline__ float2 to_f2(uint32_t w) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// d[64 x N] = A[64 x HD] B[N x HD]T: A the 64 rows at `a` of a
// [HD/(RB/2)][a_rows][RB] tile, B the [..][N][RB] tile at `b`, both K-major
// in the RB-byte swizzle (RB 128: column blocks of 64; RB 64: one block of
// 32 columns, head dims up to 32); not committed
template <typename T, int HD, int N, int RB = 128>
__device__ __forceinline__ void kmajor_product(float (&d)[N / 2], const unsigned char* a,
                                               int a_rows, const unsigned char* b) {
  constexpr int PER = RB / 32;  // k16 steps a row
  static_assert(RB == 128 || HD <= 32, "64-byte rows hold head dims up to 32");
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = wg_desc_rb<RB>(a + (kk / PER) * a_rows * RB + (kk % PER) * 32);
    const uint64_t db = wg_desc_rb<RB>(b + (kk / PER) * N * RB + (kk % PER) * 32);
    if constexpr (N == 128)
      Wgmma<T>::ss128(d, da, db, kk > 0);
    else if constexpr (N == 64)
      Wgmma<T>::ss64(d, da, db, kk > 0);
    else
      Wgmma<T>::ss32(d, da, db, kk > 0);
  }
}

// the A fragments (k16 step kk: n8 slices 2kk, 2kk + 1) of a 64 x N fp32
// accumulator, rounded to 16 bits
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[N / 16][4], const float (&v)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = Mma<T>::pack(v[8 * kk + 2 * r], v[8 * kk + 2 * r + 1]);
}

// delta = rowsum(o * do) (0 past T) of a dq unit's 128 rows into `delta`,
// by warp dw (0..2) of three: 8 lanes a row, 4 rows a step, each lane
// 16-byte chunks of o and do (fp32 sums of the 16-bit products); taken from
// the caller when given, else made and written to delta_out too.
template <typename T, int HD>
__device__ __forceinline__ void dq_row_delta(const BwdArgs& p, int b, int h, int q0, float* delta,
                                             int dw, int lane) {
  constexpr int CH = (HD + 63) / 64;  // chunks a lane a row
  const long long rows = ((long long)b * p.N + h) * p.T;
#pragma unroll 2
  for (int r0 = 4 * dw; r0 < kDqRows; r0 += 12) {
    const int r = r0 + lane / 8, row = q0 + r;
    const bool in = row < p.T;
    float s = 0.f;
    if (p.delta != nullptr) {
      s = in ? p.delta[rows + row] : 0.f;
    } else {
      const long long off = (((long long)b * p.T + row) * p.N + h) * p.hd;
      const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(p.o) + off);
      const uint4* d = reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + off);
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int cch = lane % 8 + 8 * t;
        if (in && cch * 8 < p.hd) {
          const uint4 x4 = o[cch], y4 = d[cch];
          const uint32_t xw[4] = {x4.x, x4.y, x4.z, x4.w}, yw[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = to_f2<T>(xw[e]), y = to_f2<T>(yw[e]);
            s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
          }
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (p.delta_out != nullptr && in && lane % 8 == 0) p.delta_out[rows + row] = s;
    }
    if (lane % 8 == 0) delta[r] = s;
  }
}

// dq unit u -> (batch, q head, q tile): the last (heaviest causal) q tiles
// of every (batch, head) first
__device__ __forceinline__ void dq_unit(const BwdArgs& p, int u, int& b, int& h, int& qt) {
  const int bh = u % (p.B * p.N);
  qt = p.ntiles - 1 - u / (p.B * p.N);
  h = bh % p.N;
  b = bh / p.N;
}

// dk/dv unit u -> (batch, kv head, key tile): the first (heaviest causal)
// key tiles of every (batch, kv head) first
__device__ __forceinline__ void dkv_unit(const BwdArgs& p, int u, int& b, int& hk, int& kt) {
  const int bh = u % (p.B * p.Nkv);
  kt = u / (p.B * p.Nkv);
  hk = bh % p.Nkv;
  b = bh / p.Nkv;
}

// evoformer dk/dv unit u -> (batch * row, head, key tile): the key tiles,
// then the heads, of one batch * row side by side
__device__ __forceinline__ void evo_dkv_unit(const BwdArgs& p, int u, int& b, int& h, int& kt) {
  kt = u % p.ntiles;
  const int r = u / p.ntiles;
  h = r % p.N;
  b = r / p.N;
}

// slot full / empty, then stage full / empty; empty: one arrival a consumer
// warp
__device__ __forceinline__ void init_bwd_barriers(uint64_t* bars, int stages, int slot_count,
                                                  int full_count) {
  for (int s = 0; s < 2; ++s) {
    mbar_init(&bars[s], slot_count);
    mbar_init(&bars[2 + s], 8);
  }
  for (int s = 0; s < stages; ++s) {
    mbar_init(&bars[4 + s], full_count);
    mbar_init(&bars[4 + kBwdMaxStages + s], 8);
  }
  fence_mbar_init();
}

// ------------------------------------------------------------------- dq
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_kernel(const __grid_constant__ BwdArgs p, const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmdo,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv) {
  constexpr int HDP = (HD + 63) / 64 * 64, NAT = HDP / 64, BN = dq_bn<HD>(), NS = BN / 2;
  static_assert(HD % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* slot_full = bars;
  uint64_t* slot_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = full + kBwdMaxStages;
  unsigned char* base = smem_raw + kBwdBarBytes;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  const BwdLayout lay(HDP, kDqRows, BN, true);
  unsigned char* ring = base + p.slots * lay.slot_bytes;
  float* deltas = reinterpret_cast<float*>(ring + p.stages * lay.stage_bytes);  // [slots][128]
  // the warpgroup index, visibly uniform (see attn_fwd_kernel)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  // a slot is full once its Q and dO have landed and the three delta warps
  // have written its rows' delta
  if (threadIdx.x == 0) init_bwd_barriers(bars, p.stages, 4, 1);
  __syncthreads();
  const int group = p.N / p.Nkv;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kDqRegProducer>();
    const int pw = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (pw > 0) {
      // warps 1-3: each unit's delta rows, a slot ahead of the consumers
      // when there are two
      for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
        int b, h, qt;
        dq_unit(p, u, b, h, qt);
        const int slot = i % p.slots;
        if (i >= p.slots) mbar_wait(&slot_empty[slot], (i / p.slots - 1) & 1);
        dq_row_delta<T, HD>(p, b, h, qt * kDqRows, deltas + slot * kDqRows, pw - 1, lane);
        warp_arrive(&slot_full[slot], lane);
      }
      return;
    }
    if (lane != 0) return;
    int it = 0;
    for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
      int b, h, qt, first, last;
      dq_unit(p, u, b, h, qt);
      const int q0 = qt * kDqRows, hk = h / group;
      k_tile_range(q0, kDqRows, p.T, BN, p.causal, p.window, first, last);
      const int slot = i % p.slots;
      if (i >= p.slots) mbar_wait(&slot_empty[slot], (i / p.slots - 1) & 1);
      unsigned char* sl = base + slot * lay.slot_bytes;
      mbar_expect_tx(&slot_full[slot], lay.slot_bytes);
#pragma unroll
      for (int cb = 0; cb < NAT; ++cb) {
        tma_load_4d(sl + cb * kDqRows * 128, &tmq, cb * 64, tma_c(p.cq, 1, h), q0,
                    tma_c(p.cq, 3, b), &slot_full[slot]);
        tma_load_4d(sl + lay.slot_tile + cb * kDqRows * 128, &tmdo, cb * 64,
                    tma_c(p.cdo, 1, h), q0, tma_c(p.cdo, 3, b), &slot_full[slot]);
      }
      for (int kt = first; kt <= last; ++kt, ++it) {
        const int s = it % p.stages;
        if (it >= p.stages) mbar_wait(&empty[s], (it / p.stages - 1) & 1);
        unsigned char* st = ring + (size_t)s * lay.stage_bytes;
        mbar_expect_tx(&full[s], 2 * lay.ring_tile);
#pragma unroll
        for (int cb = 0; cb < NAT; ++cb) {
          tma_load_4d(st + cb * BN * 128, &tmk, cb * 64, tma_c(p.ck, 1, hk), kt * BN,
                      tma_c(p.ck, 3, b), &full[s]);
          tma_load_4d(st + lay.ring_tile + cb * BN * 128, &tmv, cb * 64, tma_c(p.cv, 1, hk),
                      kt * BN, tma_c(p.cv, 3, b), &full[s]);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kDqRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  const float scale2 = p.scale * kLog2e;
  float acc[NAT][32];
  float sc[NS], dp[NS];
  uint32_t da[BN / 16][4];
  auto fence_all = [&]() {
    wg_fence_regs(sc);
    wg_fence_regs(dp);
#pragma unroll
    for (int a = 0; a < NAT; ++a) wg_fence_regs(acc[a]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wg_fence_regs(da[kk]);
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) sc[j] = dp[j] = 0.f;
  int it = 0;
  if (c == 1) turn_pass(c);  // the first consumer warpgroup takes the first turn
  for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
    int b, h, qt, first, last;
    dq_unit(p, u, b, h, qt);
    const int q0 = qt * kDqRows;
    k_tile_range(q0, kDqRows, p.T, BN, p.causal, p.window, first, last);
    const int r0 = q0 + 64 * c;           // this warpgroup's first row
    const int rw = r0 + 16 * w + grp;     // this thread's rows rw, rw + 8
    const int slot = i % p.slots;
    const float slope2 = p.slopes != nullptr ? p.slopes[h] * kLog2e : 0.f;
    const long long rows = ((long long)b * p.N + h) * p.T;
    float lse2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rw + 8 * hh;
      lse2[hh] = dead_or_log2(row < p.T ? p.lse[rows + row] : kNegInf);
    }
#pragma unroll
    for (int a = 0; a < NAT; ++a)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[a][j] = 0.f;
    mbar_wait(&slot_full[slot], (i / p.slots) & 1);
    float dls[2];  // -delta * scale
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) dls[hh] = -deltas[slot * kDqRows + rw - q0 + 8 * hh] * p.scale;
    const unsigned char* qs = base + slot * lay.slot_bytes + c * 64 * 128;
    const unsigned char* dos = qs + lay.slot_tile;
    for (int kt = first; kt <= last; ++kt, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const unsigned char* ks = ring + (size_t)s * lay.stage_bytes;
      const unsigned char* vs = ks + lay.ring_tile;
      // s = q kT, dp = do vT
      fence_all();
      turn_wait(c);
      wg_fence();
      kmajor_product<T, HD, BN>(sc, qs, kDqRows, ks);
      kmajor_product<T, HD, BN>(dp, dos, kDqRows, vs);
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      wg_fence_regs(sc);
      wg_fence_regs(dp);
      // p = 2^(s scale2 + slope2 kpos - lse2), ds = p (dp - delta) scale;
      // the key's offset within the tile is a constant of the unrolled loop
      const int k0 = kt * BN;
      const bool whole = (!p.causal || k0 + BN - 1 <= r0) &&
                         (p.window <= 0 || k0 > r0 + 63 - p.window) && k0 + BN <= p.T;
      const float kb = slope2 * (float)(k0 + 2 * tq);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e, kpos = k0 + 8 * j + 2 * tq + e;
            float pr = ex2(fmaf(sc[x], scale2, fmaf(slope2, (float)(8 * j + e), kb - lse2[hh])));
            if (!whole && !visible(rw + 8 * hh, kpos, p.T, p.causal, p.window)) pr = 0.f;
            sc[x] = pr * fmaf(dp[x], p.scale, dls[hh]);
          }
      pack_a<T, BN>(da, sc);
      // dq += ds k: k read MN-major from the same tile
      fence_all();
      turn_wait(c);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int a = 0; a < NAT; ++a)
          Wgmma<T>::rs64(acc[a], da[kk], wg_desc(ks + a * BN * 128 + kk * 16 * 128));
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      fence_all();
      warp_arrive(&empty[s], lane);
    }
    warp_arrive(&slot_empty[slot], lane);

    // ---- epilogue: dq rows
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rw + 8 * hh;
      if (row >= p.T) continue;
      T* out = static_cast<T*>(p.dq) + (((long long)b * p.T + row) * p.N + h) * p.hd;
#pragma unroll
      for (int a = 0; a < NAT; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * a + 8 * j + 2 * tq;
          if (col < p.hd)
            *reinterpret_cast<uint32_t*>(out + col) =
                Mma<T>::pack(acc[a][4 * j + 2 * hh], acc[a][4 * j + 2 * hh + 1]);
        }
    }
  }
}

// ----------------------------------------------------------------- dk/dv
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_kernel(const __grid_constant__ BwdArgs p, const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmdo) {
  constexpr int HDP = (HD + 63) / 64 * 64, NAT = HDP / 64;
  // above 128 the two warpgroups share 64 keys and split the column blocks
  constexpr bool SPLIT = HD > 128;
  constexpr int KR = SPLIT ? 64 : 128, BM = dkv_bm<HD>(), NS = BM / 2;
  constexpr int NATC = SPLIT ? (NAT + 1) / 2 : NAT;  // column blocks a warpgroup
  static_assert(HD % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* slot_full = bars;
  uint64_t* slot_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = full + kBwdMaxStages;
  unsigned char* base = smem_raw + kBwdBarBytes;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  const BwdLayout lay(HDP, KR, BM, false);
  unsigned char* ring = base + p.slots * lay.slot_bytes;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  // a stage is full once its TMA bytes have landed and the producer warp's
  // 32 lanes have written the lse and delta rows
  if (threadIdx.x == 0) init_bwd_barriers(bars, p.stages, 1, 32);
  __syncthreads();
  const int group = p.N / p.Nkv;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kDkvRegProducer>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int it = 0;
    for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
      int b, hk, kt, qf, ql;
      dkv_unit(p, u, b, hk, kt);
      const int k0 = kt * KR;
      q_tile_range(k0, KR, p.T, BM, p.causal, p.window, qf, ql);
      const int nq = max(ql - qf + 1, 0);
      if (lane == 0) {
        const int slot = i % p.slots;
        if (i >= p.slots) mbar_wait(&slot_empty[slot], (i / p.slots - 1) & 1);
        unsigned char* sl = base + slot * lay.slot_bytes;
        mbar_expect_tx(&slot_full[slot], lay.slot_bytes);
#pragma unroll
        for (int cb = 0; cb < NAT; ++cb) {
          tma_load_4d(sl + cb * KR * 128, &tmk, cb * 64, tma_c(p.ck, 1, hk), k0,
                      tma_c(p.ck, 3, b), &slot_full[slot]);
          tma_load_4d(sl + lay.slot_tile + cb * KR * 128, &tmv, cb * 64, tma_c(p.cv, 1, hk), k0,
                      tma_c(p.cv, 3, b), &slot_full[slot]);
        }
      }
      for (int item = 0; item < group * nq; ++item, ++it) {
        const int h = hk * group + item / nq, q0 = (qf + item % nq) * BM;
        const int s = it % p.stages;
        if (it >= p.stages) mbar_wait(&empty[s], (it / p.stages - 1) & 1);
        unsigned char* st = ring + (size_t)s * lay.stage_bytes;
        if (lane == 0) {
          mbar_expect_tx_only(&full[s], 2 * lay.ring_tile);  // the lanes arrive below
#pragma unroll
          for (int cb = 0; cb < NAT; ++cb) {
            tma_load_4d(st + cb * BM * 128, &tmq, cb * 64, tma_c(p.cq, 1, h), q0,
                        tma_c(p.cq, 3, b), &full[s]);
            tma_load_4d(st + lay.ring_tile + cb * BM * 128, &tmdo, cb * 64, tma_c(p.cdo, 1, h),
                        q0, tma_c(p.cdo, 3, b), &full[s]);
          }
        }
        // lse in log2 units (+inf: a row that sees no key, or past T) and
        // delta (0 past T)
        float* stats = reinterpret_cast<float*>(st + 2 * lay.ring_tile);
        const long long rows = ((long long)b * p.N + h) * p.T;
        float l[BM / 32], d[BM / 32];  // every load first, then the stores
#pragma unroll
        for (int j = 0; j < BM / 32; ++j) {
          const bool in = q0 + lane + 32 * j < p.T;
          l[j] = in ? __ldg(p.lse + rows + q0 + lane + 32 * j) : kNegInf;
          d[j] = in ? __ldg(p.delta + rows + q0 + lane + 32 * j) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < BM / 32; ++j) {
          stats[lane + 32 * j] = dead_or_log2(l[j]);
          stats[BM + lane + 32 * j] = d[j];
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kDkvRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  const float scale2 = p.scale * kLog2e;
  float dk[NATC][32], dv[NATC][32];
  float st[NS], dpt[NS];
  uint32_t pa[BM / 16][4], dsa[BM / 16][4];
  auto fence_all = [&]() {
    wg_fence_regs(st);
    wg_fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < NATC; ++j) {
      wg_fence_regs(dk[j]);
      wg_fence_regs(dv[j]);
    }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      wg_fence_regs(pa[kk]);
      wg_fence_regs(dsa[kk]);
    }
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) st[j] = dpt[j] = 0.f;
  int it = 0;
  if (c == 1) turn_pass(c);
  for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
    int b, hk, kt, qf, ql;
    dkv_unit(p, u, b, hk, kt);
    const int k0 = kt * KR;
    q_tile_range(k0, KR, p.T, BM, p.causal, p.window, qf, ql);
    const int nq = max(ql - qf + 1, 0);
    const int kw0 = k0 + (SPLIT ? 0 : 64 * c);  // this warpgroup's first key
    const int kr = kw0 + 16 * w + grp;           // this thread's keys kr, kr + 8
    const int slot = i % p.slots;
#pragma unroll
    for (int j = 0; j < NATC; ++j)
#pragma unroll
      for (int x = 0; x < 32; ++x) dk[j][x] = dv[j][x] = 0.f;
    mbar_wait(&slot_full[slot], (i / p.slots) & 1);
    const unsigned char* ks = base + slot * lay.slot_bytes + (SPLIT ? 0 : c * 64 * 128);
    const unsigned char* vs = ks + lay.slot_tile;
    for (int item = 0; item < group * nq; ++item, ++it) {
      const int h = hk * group + item / nq, q0 = (qf + item % nq) * BM;
      const float slope2 = p.slopes != nullptr ? p.slopes[h] * kLog2e : 0.f;
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const unsigned char* qs = ring + (size_t)s * lay.stage_bytes;
      const unsigned char* dos = qs + lay.ring_tile;
      const float* ls = reinterpret_cast<const float*>(qs + 2 * lay.ring_tile);
      // sT = k qT, dpT = v doT (keys are the accumulator rows)
      fence_all();
      turn_wait(c);
      wg_fence();
      kmajor_product<T, HD, BM>(st, ks, KR, qs);
      kmajor_product<T, HD, BM>(dpt, vs, KR, dos);
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      wg_fence_regs(st);
      wg_fence_regs(dpt);
      // pT = 2^(sT scale2 + slope2 kpos - lse2), dsT = pT (dpT - delta) scale
      const bool whole = (!p.causal || kw0 + 63 <= q0) &&
                         (p.window <= 0 || kw0 > q0 + BM - 1 - p.window) && q0 + BM <= p.T &&
                         kw0 + 64 <= p.T;
      const float kb0 = slope2 * (float)kr, kb1 = slope2 * (float)(kr + 8);
      // each k16 step's two n8 slices, then their A fragments (the fp32
      // values die as they are packed)
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int qi = 8 * j + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + BM + qi);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e;
            float pr = ex2(fmaf(st[x], scale2, (hh ? kb1 : kb0) - (e ? l2.y : l2.x)));
            if (!whole && !visible(q0 + qi + e, kr + 8 * hh, p.T, p.causal, p.window)) pr = 0.f;
            st[x] = pr;
            dpt[x] = pr * fmaf(dpt[x], p.scale, -(e ? d2.y : d2.x) * p.scale);
          }
        if (j % 2 == 1) {
          const int kk = j / 2;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = Mma<T>::pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            dsa[kk][r] = Mma<T>::pack(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
          }
        }
      }
      // dv += pT do, dk += dsT q: do and q read MN-major from the same tiles
      fence_all();
      turn_wait(c);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int j = 0; j < NATC; ++j) {
          const int a = SPLIT ? min(c + 2 * j, NAT - 1) : j;
          Wgmma<T>::rs64(dv[j], pa[kk], wg_desc(dos + a * BM * 128 + kk * 16 * 128));
          Wgmma<T>::rs64(dk[j], dsa[kk], wg_desc(qs + a * BM * 128 + kk * 16 * 128));
        }
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      fence_all();
      warp_arrive(&empty[s], lane);
    }
    warp_arrive(&slot_empty[slot], lane);

    // ---- epilogue: dk, dv rows (a split's last column block, when NAT is
    // odd, is computed by both warpgroups and stored by the one it is for)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kr + 8 * hh;
      if (key >= p.T) continue;
      const long long off = (((long long)b * p.T + key) * p.Nkv + hk) * p.hd;
      T* dko = static_cast<T*>(p.dk) + off;
      T* dvo = static_cast<T*>(p.dv) + off;
#pragma unroll
      for (int j = 0; j < NATC; ++j) {
        const int a = SPLIT ? c + 2 * j : j;
        if (a >= NAT) continue;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 64 * a + 8 * jj + 2 * tq;
          if (col < p.hd) {
            *reinterpret_cast<uint32_t*>(dko + col) =
                Mma<T>::pack(dk[j][4 * jj + 2 * hh], dk[j][4 * jj + 2 * hh + 1]);
            *reinterpret_cast<uint32_t*>(dvo + col) =
                Mma<T>::pack(dv[j][4 * jj + 2 * hh], dv[j][4 * jj + 2 * hh + 1]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------- evoformer dk/dv
// Four words of a row held as accumulator fragments by the row's four
// lanes (lane t: columns 8j + 2t, 8j + 2t + 1 as word j, j = 0..3) -> this
// lane (t = tq) gets columns 8tq .. 8tq + 7 as one 16-byte vector: four
// rounds of a quad shuffle, each lane sending the word the receiver needs.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4], int tq) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = tq ^ r;  // the word the lane tq ^ r needs, and where ours goes
    const uint32_t send = i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = i == k ? got : o[k];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The evoformer's pT and dsT of one stage in place, fp32 (keys the rows:
// this thread's kl, kl + 8 within the unit's 128; queries the columns),
// ds summed into colsum.  ls: the stage's lse (natural units, +inf: p = 0)
// and delta rows; b2s: the staged bias2 tile ([esz][BM rows][128 B],
// 128-byte swizzle), CODE -1 absent / 0 fp32 / 1 fp16 / 2 bf16.  A
// thread's bias2 of query 8j + 2tq + e and key kl + 8hh sits at a fixed
// address + 1024 j (the swizzle of row 8j + r is that of row r).
template <int CODE, int BM>
__device__ __forceinline__ void evo_dkv_probs(float (&st)[BM / 2], float (&dpt)[BM / 2],
                                              float (&colsum)[2], const float* ls,
                                              const unsigned char* b2s, const float (&b1v)[2],
                                              float scale, int kl, int tq) {
  const unsigned char* b2a[2][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int byte = (kl + 8 * hh) * (CODE == 0 ? 4 : 2), r = 2 * tq + e;
      b2a[hh][e] = b2s + (byte >> 7) * (BM * 128) + r * 128 +
                   ((((byte & 127) >> 4) ^ r) << 4) + (byte & 15);
    }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const int qi = 8 * j + 2 * tq;
    const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
    const float2 d2 = *reinterpret_cast<const float2*>(ls + BM + qi);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * hh + e;
        float b2 = 0.f;
        if constexpr (CODE == 0) {
          b2 = *reinterpret_cast<const float*>(b2a[hh][e] + 1024 * j);
        } else if constexpr (CODE > 0) {
          const unsigned short u = *reinterpret_cast<const unsigned short*>(b2a[hh][e] + 1024 * j);
          b2 = CODE == 1 ? __half2float(__ushort_as_half(u)) : __uint_as_float((uint32_t)u << 16);
        }
        const float s = evo_logit_s(st[x], scale, true, b1v[hh], CODE >= 0, b2);
        const float pr = ex2((s - (e ? l2.y : l2.x)) * kLog2e);
        const float ds = pr * (dpt[x] - (e ? d2.y : d2.x));
        colsum[hh] += ds;
        st[x] = pr;
        dpt[x] = ds;
      }
  }
}

// The evoformer's dk/dv (#15, with #17's column sums): flash_dkv_kernel's
// producer / consumer split, slots and ring, its units and arithmetic the
// evoformer's (see the header comment).
template <typename T, int HD, int BM>
__global__ void __launch_bounds__(kBwdThreads, 1)
    evo_dkv_kernel(const __grid_constant__ BwdArgs p, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmdo,
                   const __grid_constant__ CUtensorMap tmb2) {
  constexpr int HDP = (HD + 63) / 64 * 64, NAT = HDP / 64, KR = 128, NS = BM / 2;
  static_assert(HD % 16 == 0 && HD <= 128 && (BM == 32 || BM == 64), "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* slot_full = bars;
  uint64_t* slot_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = full + kBwdMaxStages;
  unsigned char* base = smem_raw + kBwdBarBytes;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  const int b2_esz = p.b2_code < 0 ? 0 : (p.b2_code == 0 ? 4 : 2);
  const BwdLayout lay = BwdLayout::evo_dkv(HDP, BM, b2_esz);
  unsigned char* ring = base + p.slots * lay.slot_bytes;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  // a slot or stage is full once its TMA bytes have landed and the
  // producer warpgroup's 128 threads have written the rest (a slot's bias1
  // slice; a stage's lse and delta rows, and bias2 when TMA cannot read it)
  if (threadIdx.x == 0) init_bwd_barriers(bars, p.stages, 128, 128);
  __syncthreads();
  const int nq = (p.T - 1) / BM + 1;  // query tiles a unit

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    // Thread 0 issues the TMA copies, every thread stages one key's bias1 a
    // unit and one query's lse and delta a stage (and bias2 element by
    // element when TMA cannot read it).  Each thread's values are loaded a
    // stage ahead (bias1 a unit ahead) and converted only when stored, so
    // their latency runs under the wait for a free slot or stage.
    setmaxnreg_dec<kEvoRegProducer>();
    const int pt = threadIdx.x;
    const bool b2t = p.b2_code >= 0 && p.b2_tma;
    float lraw = 0.f, draw = 0.f;
    uint32_t braw = 0u;
    auto fetch_b1 = [&](int b, int kt) {
      const int kpos = kt * KR + pt;
      braw = kpos < p.T && p.b1_code >= 0
                 ? load_bias_bits(p.b1, (b / p.rows) * p.b1_sb + (b % p.rows) * p.b1_sn +
                                            kpos * p.b1_sk, p.b1_code)
                 : 0u;
    };
    auto fetch_stats = [&](int b, int h, int q0) {
      const long long rows = ((long long)b * p.N + h) * p.T;
      const int q = q0 + pt;
      lraw = pt < BM && q < p.T ? p.lse[rows + q] : kNegInf;
      draw = pt < BM && q < p.T ? p.delta[rows + q] : 0.f;
    };
    int b = 0, h = 0, kt = 0, it = 0;
    if (blockIdx.x < p.units) {
      evo_dkv_unit(p, blockIdx.x, b, h, kt);
      fetch_b1(b, kt);
      fetch_stats(b, h, 0);
    }
    for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
      const int k0 = kt * KR, n = b % p.rows, bt = b / p.rows;
      const int slot = i % p.slots;
      unsigned char* sl = base + slot * lay.slot_bytes;
      if (i >= p.slots) mbar_wait(&slot_empty[slot], (i / p.slots - 1) & 1);
      if (pt == 0) {
        mbar_expect_tx_only(&slot_full[slot], 2 * lay.slot_tile);  // all 128 arrive below
#pragma unroll
        for (int cb = 0; cb < NAT; ++cb) {
          tma_load_5d(sl + cb * KR * 128, &tmk, cb * 64, tma_c(p.ck, 1, h), k0,
                      tma_c(p.ck, 3, n), tma_c(p.ck, 4, bt), &slot_full[slot]);
          tma_load_5d(sl + lay.slot_tile + cb * KR * 128, &tmv, cb * 64, tma_c(p.cv, 1, h), k0,
                      tma_c(p.cv, 3, n), tma_c(p.cv, 4, bt), &slot_full[slot]);
        }
      }
      // the keys' bias1 (0 if absent or past T)
      reinterpret_cast<float*>(sl + 2 * lay.slot_tile)[pt] =
          p.b1_code >= 0 ? bias_of_bits(braw, p.b1_code) : 0.f;
      mbar_arrive(&slot_full[slot]);
      const bool more = u + gridDim.x < p.units;
      int nb = 0, nh = 0, nkt = 0;
      if (more) {
        evo_dkv_unit(p, u + gridDim.x, nb, nh, nkt);
        fetch_b1(nb, nkt);
      }
      for (int item = 0; item < nq; ++item, ++it) {
        const int q0 = item * BM;
        const int s = it % p.stages;
        if (it >= p.stages) mbar_wait(&empty[s], (it / p.stages - 1) & 1);
        unsigned char* st = ring + (size_t)s * lay.stage_bytes;
        if (pt == 0) {
          // the other threads arrive below
          mbar_expect_tx_only(&full[s], 2 * lay.ring_tile + (b2t ? lay.b2_bytes : 0));
#pragma unroll
          for (int cb = 0; cb < NAT; ++cb) {
            tma_load_5d(st + cb * BM * 128, &tmq, cb * 64, tma_c(p.cq, 1, h), q0,
                        tma_c(p.cq, 3, n), tma_c(p.cq, 4, bt), &full[s]);
            tma_load_5d(st + lay.ring_tile + cb * BM * 128, &tmdo, cb * 64, tma_c(p.cdo, 1, h),
                        q0, tma_c(p.cdo, 3, n), tma_c(p.cdo, 4, bt), &full[s]);
          }
          if (b2t) {
            const int per = 128 / b2_esz;  // keys a 128-byte box
            for (int bx = 0; bx < KR / per; ++bx)
              tma_load_4d(st + 2 * lay.ring_tile + bx * BM * 128, &tmb2, k0 + bx * per, q0,
                          tma_c(p.cb2, 2, h), tma_c(p.cb2, 3, bt), &full[s]);
          }
        }
        // lse in natural units (+inf: a row that saw no key, or past T),
        // delta (0 past T)
        float* stats = reinterpret_cast<float*>(st + 2 * lay.ring_tile + lay.b2_bytes);
        if (pt < BM) {
          stats[pt] = lraw > 0.5f * kNegInf ? lraw : __int_as_float(0x7f800000);
          stats[BM + pt] = draw;
        }
        if (item + 1 < nq)
          fetch_stats(b, h, q0 + BM);
        else if (more)
          fetch_stats(nb, nh, 0);
        if (p.b2_code >= 0 && !p.b2_tma) {
          // bias2 element by element (0 outside S x S)
          unsigned char* b2s = st + 2 * lay.ring_tile;
          const long long o2 = bt * p.b2_sb + h * p.b2_sh;
          for (int e = pt; e < BM * KR; e += 128) {
            const int r = e / KR, kk = e % KR, qpos = q0 + r, kpos = k0 + kk;
            const bool in = qpos < p.T && kpos < p.T;
            const long long off = o2 + qpos * p.b2_sq + kpos * p.b2_sk;
            const int byte = kk * b2_esz;
            unsigned char* a = b2s + (byte >> 7) * (BM * 128) + r * 128 +
                               ((((byte & 127) >> 4) ^ (r & 7)) << 4) + (byte & 15);
            if (b2_esz == 4)
              *reinterpret_cast<float*>(a) = in ? static_cast<const float*>(p.b2)[off] : 0.f;
            else
              *reinterpret_cast<unsigned short*>(a) =
                  in ? static_cast<const unsigned short*>(p.b2)[off] : (unsigned short)0;
          }
        }
        mbar_arrive(&full[s]);
      }
      b = nb;
      h = nh;
      kt = nkt;
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kEvoRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  float dk[NAT][32], dv[NAT][32];
  float st[NS], dpt[NS];
  uint32_t pa[BM / 16][4], dsa[BM / 16][4];
  auto fence_all = [&]() {
    wg_fence_regs(st);
    wg_fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < NAT; ++j) {
      wg_fence_regs(dk[j]);
      wg_fence_regs(dv[j]);
    }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      wg_fence_regs(pa[kk]);
      wg_fence_regs(dsa[kk]);
    }
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) st[j] = dpt[j] = 0.f;
  int it = 0;
  if (c == 1) turn_pass(c);
  for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
    int b, h, kt;
    evo_dkv_unit(p, u, b, h, kt);
    const int k0 = kt * KR;
    const int kl = 64 * c + 16 * w + grp;  // this thread's keys k0 + kl, + 8
    const int slot = i % p.slots;
#pragma unroll
    for (int j = 0; j < NAT; ++j)
#pragma unroll
      for (int x = 0; x < 32; ++x) dk[j][x] = dv[j][x] = 0.f;
    float colsum[2] = {0.f, 0.f};  // ds summed over the queries
    mbar_wait(&slot_full[slot], (i / p.slots) & 1);
    const unsigned char* ks = base + slot * lay.slot_bytes + c * 64 * 128;
    const unsigned char* vs = ks + lay.slot_tile;
    const float* b1s = reinterpret_cast<const float*>(base + slot * lay.slot_bytes +
                                                      2 * lay.slot_tile);
    const float b1v[2] = {b1s[kl], b1s[kl + 8]};
    // sT = k qT, dpT = v doT of the stage at qs (keys are the accumulator
    // rows); committed
    auto issue_ss = [&](const unsigned char* qs) {
      kmajor_product<T, HD, BM>(st, ks, KR, qs);
      kmajor_product<T, HD, BM>(dpt, vs, KR, qs + lay.ring_tile);
      wg_commit();
    };
    // dv += pT do, dk += dsT q of the stage at qs: do and q read MN-major
    // from the same tiles; committed
    auto issue_rs = [&](const unsigned char* qs) {
      const unsigned char* dos = qs + lay.ring_tile;
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int j = 0; j < NAT; ++j) {
          Wgmma<T>::rs64(dv[j], pa[kk], wg_desc(dos + j * BM * 128 + kk * 16 * 128));
          Wgmma<T>::rs64(dk[j], dsa[kk], wg_desc(qs + j * BM * 128 + kk * 16 * 128));
        }
      wg_commit();
    };
    // Pipelined: stage item+1's score products and stage item's dk / dv
    // products are issued together and run while stage item+1's
    // exponentials do.  The two warpgroups take turns at issuing; the turn
    // passes once this warpgroup's score products are done, so the other's
    // products queue behind them.
    int s = it % p.stages;
    mbar_wait(&full[s], (it / p.stages) & 1);
    const unsigned char* cur = ring + (size_t)s * lay.stage_bytes;
    fence_all();
    turn_wait(c);
    wg_fence();
    issue_ss(cur);
    wg_wait<0>();
    turn_pass(c);
    wg_fence_regs(st);
    wg_fence_regs(dpt);
    for (int item = 0; item < nq; ++item, ++it) {
      // pT = exp(s - lse) with s the reference's logit, dsT = pT (dpT -
      // delta), unscaled; a uniform branch a bias2 width
      const float* ls = reinterpret_cast<const float*>(cur + 2 * lay.ring_tile + lay.b2_bytes);
      const unsigned char* b2s = cur + 2 * lay.ring_tile;
      switch (p.b2_code) {
        case 0: evo_dkv_probs<0, BM>(st, dpt, colsum, ls, b2s, b1v, p.scale, kl, tq); break;
        case 1: evo_dkv_probs<1, BM>(st, dpt, colsum, ls, b2s, b1v, p.scale, kl, tq); break;
        case 2: evo_dkv_probs<2, BM>(st, dpt, colsum, ls, b2s, b1v, p.scale, kl, tq); break;
        default: evo_dkv_probs<-1, BM>(st, dpt, colsum, ls, b2s, b1v, p.scale, kl, tq); break;
      }
      if (item > 0) {
        // the previous stage's dk / dv products: pa, dsa and its tiles free
        wg_wait<0>();
        fence_all();
        warp_arrive(&empty[(it - 1) % p.stages], lane);
      }
      pack_a<T, BM>(pa, st);
      pack_a<T, BM>(dsa, dpt);
      if (item + 1 < nq) {
        const int s2 = (it + 1) % p.stages;
        mbar_wait(&full[s2], ((it + 1) / p.stages) & 1);
        const unsigned char* nxt = ring + (size_t)s2 * lay.stage_bytes;
        fence_all();
        turn_wait(c);
        wg_fence();
        issue_ss(nxt);
        issue_rs(cur);
        wg_wait<1>();  // the score products; dk / dv's may still run
        turn_pass(c);
        wg_fence_regs(st);
        wg_fence_regs(dpt);
        cur = nxt;
      } else {
        fence_all();
        turn_wait(c);
        wg_fence();
        issue_rs(cur);
        turn_pass(c);
        wg_wait<0>();
        fence_all();
        warp_arrive(&empty[it % p.stages], lane);
      }
    }
    warp_arrive(&slot_empty[slot], lane);

    // ---- epilogue: dk takes the scale here, on the fp32 sum, and each lane
    // stores 16 bytes of a row (its quad's words gathered); then bias1's
    // column sums, the four lanes of a key holding its sum over disjoint
    // queries
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + kl + 8 * hh;
      const long long off = (((long long)b * p.T + key) * p.Nkv + h) * p.hd;
#pragma unroll
      for (int j = 0; j < NAT; ++j)
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int col = 64 * j + 32 * g;  // this quad's 32 columns
          if (col >= p.hd) continue;
          uint32_t wk[4], wv[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int x = 4 * (4 * g + jj) + 2 * hh;
            wk[jj] = Mma<T>::pack(dk[j][x] * p.scale, dk[j][x + 1] * p.scale);
            wv[jj] = Mma<T>::pack(dv[j][x], dv[j][x + 1]);
          }
          const uint4 vk = quad_transpose(wk, tq), vv = quad_transpose(wv, tq);
          if (key < p.T && col + 8 * tq < p.hd) {
            *reinterpret_cast<uint4*>(static_cast<T*>(p.dk) + off + col + 8 * tq) = vk;
            *reinterpret_cast<uint4*>(static_cast<T*>(p.dv) + off + col + 8 * tq) = vv;
          }
        }
    }
    if (p.db1_part != nullptr) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float cs = colsum[hh];
        cs += __shfl_xor_sync(0xffffffffu, cs, 1);
        cs += __shfl_xor_sync(0xffffffffu, cs, 2);
        const int key = k0 + kl + 8 * hh;
        if (tq == 0 && key < p.T) p.db1_part[((long long)b * p.N + h) * p.T + key] = cs;
      }
    }
  }
}

// One launch's checks and grid: the plan's ring within the card's opt-in
// shared memory, one block an SM (or one a unit, if fewer).
inline cudaError_t bwd_grid(const BwdArgs& p, size_t smem, long long units, int& grid) {
  if (p.stages < 1 || p.stages > kBwdMaxStages || p.slots < 1 || p.slots > 2 ||
      units > 2147483647LL)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  grid = (int)std::min<long long>(units, sms);
  return cudaSuccess;
}

// Launch flash dq (which 1) or dk/dv (which 2): `p` filled in but for
// units, ntiles and the grid; the tensor maps built by the caller (dq: q,
// do in boxes of 128 rows, k, v of dq_bn<HD>(); dk/dv: k, v in boxes of 128
// keys, 64 above head dim 128, q, do of dkv_bm<HD>()).
template <typename T, int HD>
cudaError_t launch_attn_bwd(int which, BwdArgs p, const CUtensorMap& tm0, const CUtensorMap& tm1,
                            const CUtensorMap& tm2, const CUtensorMap& tm3, cudaStream_t st) {
  constexpr int HDP = (HD + 63) / 64 * 64;
  constexpr int KR = HD > 128 ? 64 : 128, BM = dkv_bm<HD>();
  const BwdLayout lay = which == 1 ? BwdLayout(HDP, kDqRows, dq_bn<HD>(), true)
                                   : BwdLayout(HDP, KR, BM, false);
  const int rows = which == 1 ? kDqRows : KR;
  p.ntiles = (p.T + rows - 1) / rows;
  const long long units = (long long)p.B * (which == 1 ? p.N : p.Nkv) * p.ntiles;
  int grid = 0;
  cudaError_t err = bwd_grid(p, lay.smem(p.stages, p.slots), units, grid);
  if (err != cudaSuccess) return err;
  p.units = (int)units;
  if (which == 1) {
    err = allow_dynamic_smem<flash_dq_kernel<T, HD>>();
    if (err != cudaSuccess) return err;
    flash_dq_kernel<T, HD><<<grid, kBwdThreads, lay.smem(p.stages, p.slots), st>>>(p, tm0, tm1,
                                                                                   tm2, tm3);
  } else {
    err = allow_dynamic_smem<flash_dkv_kernel<T, HD>>();
    if (err != cudaSuccess) return err;
    flash_dkv_kernel<T, HD><<<grid, kBwdThreads, lay.smem(p.stages, p.slots), st>>>(p, tm0, tm1,
                                                                                    tm2, tm3);
  }
  return cudaGetLastError();
}

// Launch the evoformer's dk/dv: `p` filled in (B = batch * rows, N = Nkv =
// heads) but for units, ntiles and the grid; k, v in boxes of 128 keys, q,
// do of BM rows, bias2 (if b2_tma) in boxes of [BM queries, 128 bytes].
template <typename T, int HD, int BM>
cudaError_t launch_evo_dkv(BwdArgs p, const CUtensorMap& tmk, const CUtensorMap& tmv,
                           const CUtensorMap& tmq, const CUtensorMap& tmdo,
                           const CUtensorMap& tmb2, cudaStream_t st) {
  constexpr int HDP = (HD + 63) / 64 * 64;
  const int b2_esz = p.b2_code < 0 ? 0 : (p.b2_code == 0 ? 4 : 2);
  const size_t smem = BwdLayout::evo_dkv(HDP, BM, b2_esz).smem(p.stages, p.slots);
  p.ntiles = (p.T + 127) / 128;
  const long long units = (long long)p.B * p.N * p.ntiles;
  int grid = 0;
  cudaError_t err = bwd_grid(p, smem, units, grid);
  if (err != cudaSuccess) return err;
  p.units = (int)units;
  err = allow_dynamic_smem<evo_dkv_kernel<T, HD, BM>>();
  if (err != cudaSuccess) return err;
  evo_dkv_kernel<T, HD, BM><<<grid, kBwdThreads, smem, st>>>(p, tmk, tmv, tmq, tmdo, tmb2);
  return cudaGetLastError();
}

}  // namespace dsk
