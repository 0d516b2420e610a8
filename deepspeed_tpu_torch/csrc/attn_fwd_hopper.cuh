// The attention forward on Hopper (sm_90a) shared by the flash forward
// (#3, flash_attention.cu) and the evoformer forward (#13, evoformer.cu):
// softmax(q kT * scale [+ ...]) v with the per-row logsumexp, 16-bit q, k,
// v, fp32 accumulation, one kernel template for both.
//
// What bounds it on the H100: the tensor cores at the flash call (4*D flops
// a visible (query, key) pair against 2*D*2 bytes a key read once a
// 128-query tile), the exponentials and the bytes at the evoformer's D 32.
// The design (warp-specialised, persistent):
//   - a block of 3 warpgroups walks "units" (one batch, one head, 128
//     queries) in a fixed order, unit blockIdx.x + i * gridDim.x, on one
//     block an SM: the next unit's loads overlap this unit's products and
//     epilogue;
//   - warpgroup 0 (producer) gives its registers back (setmaxnreg) and one
//     thread issues TMA copies: the unit's Q tile into one of 1-2 Q slots,
//     then the K and V tiles of every key tile the unit sees into a ring
//     of 2-8 stages; K and V each have a "full" and an "empty" mbarrier a
//     stage, so K is refilled once its tile's softmax is done while V
//     waits for its P V product.
//     Boxes are 64 16-bit columns wide (128 bytes) in the 128-byte swizzle
//     wgmma reads; a head dim that is not a multiple of 64 is padded by
//     TMA's zero fill (the map's inner dim is the real head dim);
//   - warpgroups 1 and 2 (consumers) take 64 query rows each and more
//     registers: S = Q KT on wgmma m64nBNk16 (Q and K K-major), the online
//     softmax in registers, P rounded to 16 bits as wgmma's register A
//     operand of O += P V (V MN-major, the transpose bit), one 64-column
//     m64n64k16 a 64-wide column block of O.  The P V product of one key
//     tile is issued behind the next tile's S and runs while that tile's
//     softmax does (O is rescaled once it has landed), and the two
//     warpgroups take turns at issuing (named barriers), so one's softmax
//     meets the other's products.  Every wgmma is issued on every path,
//     and the warpgroup index is made visibly uniform: a wgmma behind a
//     divergent branch makes ptxas serialise them all.  One O accumulator
//     holds every head dim up to 256 (128 fp32 registers a thread at 256,
//     BN 64 keys a tile there; BN 128 up to 128);
//   - flash: causal key tiles past the diagonal are never loaded, only
//     tiles that cross it (or the window's edge, or T) are masked (a tile
//     that none of a warpgroup's rows sees is masked whole), the heaviest
//     q tiles run first, GQA reads K / V at head h / group;
//     scores in log2 units (scale2 = scale * log2 e); a row that sees no
//     key gives zeros and lse -1e30;
//   - evoformer: the logits in the reference's order in fp32, (q . k) *
//     scale, + bias1, + bias2 (evo_logit_s); the producer warpgroup stages
//     each key tile's bias1 slice (fp32) and the [128 q, BN k] bias2 tile
//     (by TMA where its layout allows, element by element otherwise) beside
//     K and V; units walk the q tiles of one (row, head) in turn, so its K
//     and V are read from device memory once and bias2 (shared over rows,
//     a few MB) stays in L2; keys past S are masked, a row whose maximum
//     stays at -1e30 gives o 0 and lse -1e30.
#pragma once

#include "evo_common.cuh"
#include "hopper_common.cuh"

#include <algorithm>

namespace dsk {

constexpr int kFwdRows = 128;                // queries a unit
constexpr int kFwdThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kFwdMaxStages = 8;
constexpr int kFwdRegProducer = 40, kFwdRegConsumer = 232;
constexpr int kFwdBarBytes = (4 + 4 * kFwdMaxStages) * 8;

// Shared memory: the mbarriers, slack to align the rest to 1024 bytes (the
// swizzle's period), qslots Q tiles [HDP/64][128 rows][128 B], then the
// ring's stages: K and V [HDP/64][BN rows][128 B] each, the bias2 tile
// [BN*esz/128][128 rows][128 B] and the bias1 slice [BN] fp32, the stage
// rounded up to 1024 bytes.  ops/flash_attention.py flash_fwd_plan and
// ops/evoformer.py evo_fwd_plan choose stages and qslots by this formula.
struct FwdLayout {
  int q_bytes, kv_bytes, b2_bytes, stage_bytes;
  __host__ __device__ FwdLayout(int hdp, int bn, int b2_esz, bool has_b1) {
    q_bytes = kFwdRows * hdp * 2;
    kv_bytes = bn * hdp * 2;
    b2_bytes = kFwdRows * bn * b2_esz;
    stage_bytes = (2 * kv_bytes + b2_bytes + (has_b1 ? bn * 4 : 0) + 1023) / 1024 * 1024;
  }
  size_t smem(int stages, int qslots) const {
    return (size_t)kFwdBarBytes + 1024 + (size_t)qslots * q_bytes + (size_t)stages * stage_bytes;
  }
};

struct FwdArgs {
  void* o;      // [B, T, N, hd] contiguous (evoformer: B = batch * rows)
  float* lse;   // [B, N, T]
  int B, T, N, Nkv, hd;
  int rows;     // evoformer: MSA rows a batch (batch b = bn / rows); flash 1
  int units, nqt, stages, qslots;
  int cq, ck, cv, cb2;  // collapsed dims of the tensor maps (coordinate 0)
  float scale;          // flash: scale * log2 e; evoformer: the natural scale
  // flash
  const float* slopes;  // alibi, [N] fp32 or null
  int causal, window;
  // evoformer: bias1 viewed [B', rows, S] and bias2 [B', H, S, S] through
  // element strides (B' the true batch), codes -1 absent / 0 fp32 / 1 fp16 /
  // 2 bf16; b2_tma: bias2 comes by TMA (else element by element)
  const void *b1, *b2;
  long long b1_sb, b1_sn, b1_sk, b2_sb, b2_sh, b2_sq, b2_sk;
  int b1_code, b2_code, b2_tma;
};

__device__ __forceinline__ int tma_c(int collapsed, int dim, int c) {
  return (collapsed >> dim) & 1 ? 0 : c;
}

// unit u -> (batch, head, q tile).  Flash: the last (heaviest causal) q
// tiles of every (batch, head) first.  Evoformer: the q tiles of one
// (batch * row, head) in turn.
template <bool EVO>
__device__ __forceinline__ void fwd_unit(const FwdArgs& p, int u, int& b, int& h, int& qt) {
  if constexpr (EVO) {
    qt = u % p.nqt;
    const int r = u / p.nqt;
    h = r % p.N;
    b = r / p.N;
  } else {
    const int bh = u % (p.B * p.N);
    qt = p.nqt - 1 - u / (p.B * p.N);
    h = bh % p.N;
    b = bh / p.N;
  }
}

template <bool EVO, int BN>
__device__ __forceinline__ void fwd_tiles(const FwdArgs& p, int q0, int& first, int& last) {
  if constexpr (EVO) {
    first = 0;
    last = (p.T - 1) / BN;
  } else {
    k_tile_range(q0, kFwdRows, p.T, BN, p.causal, p.window, first, last);
  }
}

// one 16-bit bias2 pair / fp32 pair (keys 2t, 2t + 1 of an n8 slice) of the
// staged tile, rows of 128 bytes in the 128-byte swizzle
__device__ __forceinline__ float2 b2_pair(const unsigned char* tile, int code, int r, int key) {
  const int esz = code == 0 ? 4 : 2;
  const int byte = key * esz, box = byte >> 7, inb = byte & 127;
  const unsigned char* a =
      tile + box * (kFwdRows * 128) + r * 128 + ((((inb >> 4) ^ (r & 7)) << 4) | (inb & 15));
  if (code == 0) return *reinterpret_cast<const float2*>(a);
  const uint32_t w = *reinterpret_cast<const uint32_t*>(a);
  if (code == 1) return __half22float2(*reinterpret_cast<const __half2*>(&w));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// 2^x in one instruction (ex2.approx.ftz: relative error ~2^-22; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Row maxima / sums of a thread's scores (score j in row (j >> 1) & 1),
// four independent partials a row so the chains do not serialise.
template <int NS>
__device__ __forceinline__ void row_max(const float (&v)[NS], float (&mx)[2]) {
  float t[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i / 4][i % 4] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float& a = t[(j >> 1) & 1][(j & 1) | ((j >> 1) & 2)];
    a = fmaxf(a, v[j]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    mx[h] = fmaxf(mx[h], fmaxf(fmaxf(t[h][0], t[h][1]), fmaxf(t[h][2], t[h][3])));
}
template <int NS>
__device__ __forceinline__ void row_sum(const float (&v)[NS], float (&ps)[2]) {
  float t[2][4] = {};
#pragma unroll
  for (int j = 0; j < NS; ++j) t[(j >> 1) & 1][(j & 1) | ((j >> 1) & 2)] += v[j];
#pragma unroll
  for (int h = 0; h < 2; ++h) ps[h] = (t[h][0] + t[h][1]) + (t[h][2] + t[h][3]);
}

// Named barriers 1 and 2 (256 threads: both consumer warpgroups) take the
// two consumer warpgroups in turns at issuing their products, so that one
// warpgroup's softmax runs while the other's products do (rather than both
// waiting on the tensor cores, then both on the exponentials).
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

// one arrival for the whole warp, once every lane has got here
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The evoformer's logits of one key tile in the reference's order, fp32:
// (q . k) * scale, + bias1 (staged fp32, -inf on keys past S: the key mask),
// + bias2 (staged in its dtype, CODE -1 absent / 0 fp32 / 1 fp16 / 2 bf16;
// adding an absent bias's 0 would change no value, so it is skipped).
// r: the thread's first row within the 128-row tile.
template <int CODE, int BN>
__device__ __forceinline__ void evo_logits(float (&sc)[BN / 2], float scale,
                                           const float* b1s, const unsigned char* b2s, int r,
                                           int tq) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int kk = 8 * j + 2 * tq;
    const float2 b1v = *reinterpret_cast<const float2*>(b1s + kk);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 b2v = CODE >= 0 ? b2_pair(b2s, CODE, r + 8 * hh, kk) : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + 2 * hh + e] = evo_logit_s(sc[4 * j + 2 * hh + e], scale, true,
                                             e ? b1v.y : b1v.x, CODE >= 0, e ? b2v.y : b2v.x);
      }
    }
  }
}

// O[64 x 64a..64a+63] += P[64 x BN] V[BN x 64a..], a = 0..NAT-1: P from
// registers (wgmma's A fragments), V MN-major in the 128-byte swizzle (BN
// key rows of 128 bytes a 64-column block); not committed
template <typename T, int NAT, int BN>
__device__ __forceinline__ void pv_product(float (&o)[NAT][32], const uint32_t (&pa)[BN / 16][4],
                                           const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int a = 0; a < NAT; ++a)
      Wgmma<T>::rs64(o[a], pa[kk], wg_desc(vs + a * BN * 128 + kk * 16 * 128));
}

template <typename T, int HD, int BN, bool EVO>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attn_fwd_kernel(const __grid_constant__ FwdArgs p, const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const __grid_constant__ CUtensorMap tmb2) {
  constexpr int HDP = (HD + 63) / 64 * 64, NAT = HDP / 64, KSTEPS = HD / 16;
  constexpr int NS = BN / 2;  // score registers a thread
  static_assert(HD % 16 == 0 && (BN == 64 || BN == 128), "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* q_empty = q_full + 2;
  // a stage's K (with the biases) and its V are released separately: K once
  // the tile's softmax is done, V once its P V product is
  uint64_t* k_full = q_full + 4;
  uint64_t* k_empty = k_full + kFwdMaxStages;
  uint64_t* v_full = k_empty + kFwdMaxStages;
  uint64_t* v_empty = v_full + kFwdMaxStages;
  unsigned char* base = smem_raw + kFwdBarBytes;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  const int b2_esz = p.b2_code < 0 ? 0 : (p.b2_code == 0 ? 4 : 2);
  const FwdLayout lay(HDP, BN, EVO ? b2_esz : 0, EVO);
  unsigned char* ring = base + p.qslots * lay.q_bytes;
  // the warpgroup index as the compiler can see it is uniform (a shuffle
  // from lane 0): branches on it are not divergent, so it keeps the wgmma
  // pipeline asynchronous
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&k_full[s], EVO ? 128 : 1);
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kFwdRegProducer>();
    const int pt = threadIdx.x;
    if (!EVO && pt != 0) return;
    const int group = p.N / p.Nkv;
    int it = 0;
    for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
      int b, h, qt, first, last;
      fwd_unit<EVO>(p, u, b, h, qt);
      const int q0 = qt * kFwdRows;
      fwd_tiles<EVO, BN>(p, q0, first, last);
      const int n = EVO ? b % p.rows : 0, bt = EVO ? b / p.rows : b;
      const int hk = EVO ? h : h / group;
      if (pt == 0) {
        const int slot = i % p.qslots;
        if (i >= p.qslots) mbar_wait(&q_empty[slot], (i / p.qslots - 1) & 1);
        unsigned char* qs = base + slot * lay.q_bytes;
        mbar_expect_tx(&q_full[slot], lay.q_bytes);
#pragma unroll
        for (int cb = 0; cb < NAT; ++cb) {
          if constexpr (EVO)
            tma_load_5d(qs + cb * kFwdRows * 128, &tmq, cb * 64, tma_c(p.cq, 1, h), q0,
                        tma_c(p.cq, 3, n), tma_c(p.cq, 4, bt), &q_full[slot]);
          else
            tma_load_4d(qs + cb * kFwdRows * 128, &tmq, cb * 64, tma_c(p.cq, 1, h), q0,
                        tma_c(p.cq, 3, bt), &q_full[slot]);
        }
      }
      for (int kt = first; kt <= last; ++kt, ++it) {
        const int s = it % p.stages;
        const int ph = (it / p.stages - 1) & 1;  // the phase that freed the stage
        if (it >= p.stages) mbar_wait(&k_empty[s], ph);
        unsigned char* st = ring + (size_t)s * lay.stage_bytes;
        const int k0 = kt * BN;
        const bool b2t = EVO && p.b2_code >= 0 && p.b2_tma;
        if (pt == 0) {
          const uint32_t tx = lay.kv_bytes + (b2t ? lay.b2_bytes : 0);
          if (EVO)
            mbar_expect_tx_only(&k_full[s], tx);  // all 128 threads arrive below
          else
            mbar_expect_tx(&k_full[s], tx);
#pragma unroll
          for (int cb = 0; cb < NAT; ++cb) {
            if constexpr (EVO)
              tma_load_5d(st + cb * BN * 128, &tmk, cb * 64, tma_c(p.ck, 1, hk), k0,
                          tma_c(p.ck, 3, n), tma_c(p.ck, 4, bt), &k_full[s]);
            else
              tma_load_4d(st + cb * BN * 128, &tmk, cb * 64, tma_c(p.ck, 1, hk), k0,
                          tma_c(p.ck, 3, bt), &k_full[s]);
          }
          if (b2t) {
            const int per = 128 / b2_esz;  // keys a 128-byte box
            for (int bx = 0; bx < BN / per; ++bx)
              tma_load_4d(st + 2 * lay.kv_bytes + bx * kFwdRows * 128, &tmb2, k0 + bx * per,
                          q0, tma_c(p.cb2, 2, h), tma_c(p.cb2, 3, bt), &k_full[s]);
          }
        }
        if constexpr (EVO) {
          // the element-wise parts, then every producer thread's arrival
          unsigned char* b2s = st + 2 * lay.kv_bytes;
          if (pt < BN) {  // bias1 (0 if absent), -inf on keys past S
            const int kpos = k0 + pt;
            float b1 = -INFINITY;
            if (kpos < p.T)
              b1 = p.b1_code >= 0
                       ? load_bias(p.b1, bt * p.b1_sb + n * p.b1_sn + kpos * p.b1_sk, p.b1_code)
                       : 0.f;
            reinterpret_cast<float*>(b2s + lay.b2_bytes)[pt] = b1;
          }
          if (p.b2_code >= 0 && !p.b2_tma) {
            const long long o2 = bt * p.b2_sb + h * p.b2_sh;
            for (int e = pt; e < kFwdRows * BN; e += 128) {
              const int r = e / BN, kk = e % BN, qpos = q0 + r, kpos = k0 + kk;
              const bool in = qpos < p.T && kpos < p.T;
              const long long off = o2 + qpos * p.b2_sq + kpos * p.b2_sk;
              const int byte = kk * b2_esz, box = byte >> 7, inb = byte & 127;
              unsigned char* a = b2s + box * (kFwdRows * 128) + r * 128 +
                                 ((((inb >> 4) ^ (r & 7)) << 4) | (inb & 15));
              if (b2_esz == 4)
                *reinterpret_cast<float*>(a) = in ? static_cast<const float*>(p.b2)[off] : 0.f;
              else
                *reinterpret_cast<unsigned short*>(a) =
                    in ? static_cast<const unsigned short*>(p.b2)[off] : (unsigned short)0;
            }
          }
          mbar_arrive(&k_full[s]);
        }
        if (pt == 0) {  // V, once the stage's last P V product is done
          if (it >= p.stages) mbar_wait(&v_empty[s], ph);
          mbar_expect_tx(&v_full[s], lay.kv_bytes);
#pragma unroll
          for (int cb = 0; cb < NAT; ++cb) {
            if constexpr (EVO)
              tma_load_5d(st + lay.kv_bytes + cb * BN * 128, &tmv, cb * 64, tma_c(p.cv, 1, hk),
                          k0, tma_c(p.cv, 3, n), tma_c(p.cv, 4, bt), &v_full[s]);
            else
              tma_load_4d(st + lay.kv_bytes + cb * BN * 128, &tmv, cb * 64, tma_c(p.cv, 1, hk),
                          k0, tma_c(p.cv, 3, bt), &v_full[s]);
          }
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kFwdRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  float o[NAT][32];
  float sc[NS];
  uint32_t pa[BN / 16][4];
  float m[2], l[2], alpha[2];
#pragma unroll
  for (int j = 0; j < NS; ++j) sc[j] = 0.f;
  int it = 0;
  if (c == 1) turn_pass(c);  // the first consumer warpgroup takes the first turn
  for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
    int b, h, qt, first, last;
    fwd_unit<EVO>(p, u, b, h, qt);
    const int q0 = qt * kFwdRows;
    fwd_tiles<EVO, BN>(p, q0, first, last);
    const int r0 = q0 + 64 * c;  // this warpgroup's first row
    const int slot = i % p.qslots;
    mbar_wait(&q_full[slot], (i / p.qslots) & 1);
    const unsigned char* qs = base + slot * lay.q_bytes + c * 64 * 128;
    // flash: alibi slope in log2 units; evoformer: unused
    const float slope2 = (!EVO && p.slopes != nullptr) ? p.slopes[h] * kLog2e : 0.f;
#pragma unroll
    for (int a = 0; a < NAT; ++a)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[a][j] = 0.f;
    l[0] = l[1] = 0.f;
    m[0] = m[1] = EVO ? kNegInf : -INFINITY;
    // Key tile i's softmax: its logits in sc (its stage st, first key k0)
    // become probabilities, m and l move on and alpha rescales O.  Each
    // variant is its own unrolled loop behind a branch that is uniform
    // over the warpgroup: the scalar work around the products is what
    // bounds a tile, so the common tile does no masking and no bias
    // decoding it does not need.  A tile that none of the warpgroup's rows
    // sees (past the diagonal, the window or T) leaves everything as it was.
    auto softmax = [&](const unsigned char* st, int k0) {
      float mx[2] = {-INFINITY, -INFINITY};
      bool raw = false;  // flash: sc still unscaled (a full tile, no alibi)
      if constexpr (EVO) {
        const unsigned char* b2s = st + 2 * lay.kv_bytes;
        const float* b1s = reinterpret_cast<const float*>(b2s + lay.b2_bytes);
        const int r = 64 * c + 16 * w + grp;
        switch (p.b2_code) {
          case 0: evo_logits<0, BN>(sc, p.scale, b1s, b2s, r, tq); break;
          case 1: evo_logits<1, BN>(sc, p.scale, b1s, b2s, r, tq); break;
          case 2: evo_logits<2, BN>(sc, p.scale, b1s, b2s, r, tq); break;
          default: evo_logits<-1, BN>(sc, p.scale, b1s, b2s, r, tq); break;
        }
      } else {
        const int r_last = r0 + 63;
        const bool full = (!p.causal || k0 + BN - 1 <= r0) &&
                          (p.window <= 0 || k0 > r_last - p.window) && k0 + BN <= p.T &&
                          r_last < p.T;
        if (full && slope2 == 0.f) {
          raw = true;  // max of the raw scores; scale2 > 0 keeps the order
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kpos = k0 + 8 * j + 2 * tq + e;
                const int qpos = r0 + 16 * w + grp + 8 * hh;
                float v = fmaf(sc[4 * j + 2 * hh + e], p.scale, slope2 * (float)kpos);
                if (!full && !visible(qpos, kpos, p.T, p.causal, p.window)) v = -INFINITY;
                sc[4 * j + 2 * hh + e] = v;
              }
        }
      }
      row_max(sc, mx);
      float mu[2], ps[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        if (raw) mx[hh] *= p.scale;
        const float mnew = fmaxf(m[hh], mx[hh]);
        if constexpr (EVO) {
          // natural units: the difference is rounded before the scale, as
          // exp(s - m) rounds it (a -1e9 mask puts s where fp32's spacing is
          // 64); a row whose maximum is still -1e30 gets probabilities 0
          alpha[hh] = ex2((m[hh] - mnew) * kLog2e);
          mu[hh] = mnew > 0.5f * kNegInf ? mnew : INFINITY;
        } else {
          mu[hh] = mnew == -INFINITY ? 0.f : mnew;  // a row that saw no key yet
          alpha[hh] = ex2(m[hh] - mu[hh]);
        }
        m[hh] = mnew;
      }
      if (EVO) {
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[j] = ex2((sc[j] - mu[(j >> 1) & 1]) * kLog2e);
      } else if (raw) {
        const float nm0 = -mu[0], nm1 = -mu[1];
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[j] = ex2(fmaf(sc[j], p.scale, (j >> 1) & 1 ? nm1 : nm0));
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[j] = ex2(sc[j] - mu[(j >> 1) & 1]);
      }
      row_sum(sc, ps);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
    };
    // S = Q KT of the tile in stage st into sc (committed, not waited)
    auto scores = [&](const unsigned char* st) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t da = wg_desc(qs + (kk / 4) * kFwdRows * 128 + (kk % 4) * 32);
        const uint64_t db = wg_desc(st + (kk / 4) * BN * 128 + (kk % 4) * 32);
        if constexpr (BN == 128)
          Wgmma<T>::ss128(sc, da, db, kk > 0);
        else
          Wgmma<T>::ss64(sc, da, db, kk > 0);
      }
      wg_commit();
    };
    // O rescaled by alpha, P packed as wgmma's A fragments (k16 step kk
    // holds the n8 slices 2kk, 2kk+1)
    auto rescale_pack = [&]() {
#pragma unroll
      for (int a = 0; a < NAT; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[a][4 * j + 0] *= alpha[0];
          o[a][4 * j + 1] *= alpha[0];
          o[a][4 * j + 2] *= alpha[1];
          o[a][4 * j + 3] *= alpha[1];
        }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = Mma<T>::pack(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = Mma<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = Mma<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = Mma<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto fence_all = [&]() {
      wg_fence_regs(sc);
#pragma unroll
      for (int a = 0; a < NAT; ++a) wg_fence_regs(o[a]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wg_fence_regs(pa[kk]);
    };


    // The first key tile: S and its softmax.  Then each further tile's S
    // is issued with the previous tile's O += P V behind it, the P V runs
    // while this tile's softmax does, and O is rescaled once it has
    // landed.  Every wgmma is issued on every path (no divergent branch
    // around the asynchronous products).
    int s = it % p.stages;
    mbar_wait(&k_full[s], (it / p.stages) & 1);
    const unsigned char* st = ring + (size_t)s * lay.stage_bytes;
    fence_all();
    turn_wait(c);
    wg_fence();
    scores(st);
    turn_pass(c);
    wg_wait<0>();
    wg_fence_regs(sc);
    softmax(st, first * BN);
    warp_arrive(&k_empty[s], lane);
    rescale_pack();
    int vph = (it / p.stages) & 1;  // the phase of the pending V's stage
    ++it;
    for (int kt = first + 1; kt <= last; ++kt, ++it) {
      const int sp = s;
      const unsigned char* vp = st + lay.kv_bytes;
      s = it % p.stages;
      mbar_wait(&k_full[s], (it / p.stages) & 1);
      mbar_wait(&v_full[sp], vph);
      st = ring + (size_t)s * lay.stage_bytes;
      fence_all();
      turn_wait(c);
      wg_fence();
      scores(st);
      pv_product<T, NAT, BN>(o, pa, vp);
      wg_commit();
      turn_pass(c);
      wg_wait<1>();  // this S; the P V product may still run
      wg_fence_regs(sc);
      softmax(st, kt * BN);
      warp_arrive(&k_empty[s], lane);
      wg_wait<0>();  // the previous P V: O and pa are free again
      fence_all();
      warp_arrive(&v_empty[sp], lane);
      rescale_pack();
      vph = (it / p.stages) & 1;
    }
    // the unit's last P V product
    mbar_wait(&v_full[s], vph);
    fence_all();
    turn_wait(c);
    wg_fence();
    pv_product<T, NAT, BN>(o, pa, st + lay.kv_bytes);
    wg_commit();
    turn_pass(c);
    wg_wait<0>();
    fence_all();
    warp_arrive(&v_empty[s], lane);
    warp_arrive(&q_empty[slot], lane);

    // ---- epilogue: o = acc / l, lse
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 16 * w + grp + 8 * hh;
      if (row >= p.T) continue;
      const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);  // no key seen: zeros
      T* orow = static_cast<T*>(p.o) + (((long long)b * p.T + row) * p.N + h) * p.hd;
#pragma unroll
      for (int a = 0; a < NAT; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * a + 8 * j + 2 * tq;
          if (col < p.hd)
            *reinterpret_cast<uint32_t*>(orow + col) =
                Mma<T>::pack(o[a][4 * j + 2 * hh] * inv, o[a][4 * j + 2 * hh + 1] * inv);
        }
      if (tq == 0) {
        float lse;
        if constexpr (EVO)
          lse = m[hh] + logf(l[hh] == 0.f ? 1.f : l[hh]);
        else
          lse = l[hh] == 0.f ? kNegInf : m[hh] * kLn2 + logf(l[hh]);
        p.lse[((long long)b * p.N + h) * p.T + row] = lse;
      }
    }
  }
}

// Launch one forward: `p` filled in but for units, nqt and the grid; the
// tensor maps built by the caller.  The grid is one block an SM (or one a
// unit, if fewer).
template <typename T, int HD, int BN, bool EVO>
cudaError_t launch_attn_fwd(FwdArgs p, const CUtensorMap& tmq, const CUtensorMap& tmk,
                            const CUtensorMap& tmv, const CUtensorMap& tmb2, cudaStream_t st) {
  constexpr int HDP = (HD + 63) / 64 * 64;
  if (p.stages < 1 || p.stages > kFwdMaxStages || p.qslots < 1 || p.qslots > 2)
    return cudaErrorInvalidValue;
  const int b2_esz = p.b2_code < 0 ? 0 : (p.b2_code == 0 ? 4 : 2);
  const size_t smem = FwdLayout(HDP, BN, EVO ? b2_esz : 0, EVO).smem(p.stages, p.qslots);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = allow_dynamic_smem<attn_fwd_kernel<T, HD, BN, EVO>>();
  if (err != cudaSuccess) return err;
  p.nqt = (p.T + kFwdRows - 1) / kFwdRows;
  const long long units = (long long)p.B * p.N * p.nqt;
  if (units > 2147483647LL) return cudaErrorInvalidValue;
  p.units = (int)units;
  const int grid = (int)std::min<long long>(units, sms);
  attn_fwd_kernel<T, HD, BN, EVO><<<grid, kFwdThreads, smem, st>>>(p, tmq, tmk, tmv, tmb2);
  return cudaGetLastError();
}

}  // namespace dsk
