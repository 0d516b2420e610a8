// Ragged chunked prefill over the paged KV pool on Hopper (sm_90a), 16-bit
// q: bf16 / fp16 pages (#2) and int8 pages with fp32 scale rows (#2i),
// head dims 32 (padded to 64), 64 and 128, pages of any multiple of 16
// tokens up to 256.  Built in ragged_prefill.cu beside the CUDA-core
// ragged_prefill_kernel (fp32, head dim 256 and other pages).
//
// Computes what deepspeed_tpu/ops/paged_attention.py _prefill_kernel
// (:546, launched by _pallas_ragged_prefill_local :711, pallas_call :761)
// computes: row j of slot s is live iff j < q_counts[s], sits at position
// q_starts[s] + j and attends the keys at positions <= its own, below
// kv_lens[s] (and inside the window), scores scaled, then alibi slope x
// key position, then masked; P is rounded to the page dtype before P V;
// dead rows are zeros.
//
// What bounds it on the H100: at the serving main path's call, bytes (each
// slot's visible K and V, q of the live rows and the whole dense output,
// dead rows included) against ~4 hd flops a visible (row, key) pair; and
// the longest walk of one block.  The design:
//   - Units: (slot, kv head, 128 query-head rows = 128 / g tokens), so each
//     visible page is read once per 128 rows.  A persistent grid of one
//     block an SM; every block works out the same schedule from q_counts,
//     q_starts and kv_lens (no host sync, no sort kernel): each unit's
//     stages (64 keys of its visible pages), the fair share F of the whole
//     work a block, a unit with more than F stages cut into ceil(stages /
//     F) even chunks (at most kPfMaxChunks), and the chunks ordered
//     heaviest first (by the power of two of their stages, units in order
//     within one power).  An item is a chunk of one kv head; block b takes
//     item b, then one at a time from a counter in device memory (asked
//     for two stages before the current item's end; the last block out
//     resets it), so the blocks that finish early take more.  A chunk of a split walk
//     writes fp32
//     partials (acc, m, l of its live rows); prefill_combine_kernel merges
//     a unit's chunks in chunk order, launched as a programmatic dependent
//     (its blocks work out the schedule while the last items run).  Same
//     bits every run, whichever block ran what.
//   - Warpgroup 0 (producer) gives registers back (setmaxnreg).  One
//     thread issues the copies: the unit's Q rows by TMA, one box of the
//     5-D q [S, Q, nkv, g, hd] (64 columns, g heads, one kv head, 128 / g
//     tokens) so the (token, head) rows land in order; K and V stages of
//     64 keys, 16-bit by TMA from a 4-D map over the pool [pages, nkv, bs,
//     hd] in the 128-byte swizzle (64 / bs pages a stage below 64-token
//     pages, a 64-row slice of a page above), the page numbers read from
//     the block table by the warp's lanes; missing pages of a short last
//     stage read past the pool, which TMA fills with zeros.  K and V have
//     "full" and "empty" mbarriers of their own, so K is refilled once the
//     stage's softmax is done while V waits for its P V product.  Its
//     three other warps write the dense output's dead rows (tokens past
//     q_counts[s]) as zeros with 16-byte stores, each block its share.
//   - int8 pages: the producer thread brings the stage's codes and scale
//     rows by 1-D bulk copies into the stage's staging area; the three
//     other producer warps dequantize them (code x scale rounded once to
//     q's dtype, as _dequant_page) into the swizzled 16-bit tiles the
//     consumers read, a stage ahead of the products, once a page per 128
//     rows.
//   - Warpgroups 1 and 2 (consumers) take 64 rows each of the unit and
//     share every stage: S = Q K^T on wgmma m64n64k16 (Q, K K-major), the
//     online softmax in registers in log2 units (scale, alibi, then the
//     mask by position, kv length and window; a stage every row of the
//     warpgroup sees whole takes no mask, a warp with no live row skips
//     it), P rounded to the page dtype as
//     the register A operand of O += P V (V MN-major, the transpose bit);
//     one stage's P V runs behind the next stage's S and softmax, and the
//     two warpgroups take turns at issuing (attn_fwd_hopper.cuh's helpers).
#pragma once

#include "attn_fwd_hopper.cuh"

namespace dsk {

constexpr int kPfRows = 128;        // query-head rows a unit
constexpr int kPfKeys = 64;         // keys a stage
constexpr int kPfThreads = 384;     // producer + 2 consumer warpgroups
constexpr int kPfMaxStages = 8;
constexpr int kPfMaxChunks = 16;    // chunks a split walk is cut into at most
constexpr int kPfMinStages = 4;     // stages a chunk holds at least (256 keys)
constexpr int kPfRegProducer = 64, kPfRegConsumer = 216;
// the mbarriers, then the item index of each Q slot (-1: no more work)
constexpr int kPfBarBytes = (4 + 6 * kPfMaxStages) * 8 + 16;
constexpr int kPfBuckets = 34;      // sort keys: 0 (no stage), 1 + log2(stages)

struct PfArgs {
  void* out;                   // [S, Q, nkv, g, hd]
  float* part_acc;             // [chunk slots, 128, hd] fp32
  float* part_ml;              // [chunk slots, 128, 2] fp32
  const void *kpool, *vpool;   // int8 pages: the codes [NB, nkv, bs, hd]
  const float *kscale, *vscale;  // int8 pages: [NB, nkv, bs]
  const int *block_table, *kv_lens, *q_starts, *q_counts;
  const float* slopes;         // [nkv * g] or null
  int* counters;               // [2] zeros: items handed out past the first
                               // grid, blocks done (the last one out resets)
  int S, Q, nkv, g, hd, bs, MB, NB;
  int tq;                      // tokens a unit: 128 / g
  int pps;                     // pages a stage (bs <= 64: 64 / bs), or a
                               // page's 64-row slices (ceil(bs / 64))
  int grid;                    // blocks of the main kernel
  int umax;                    // units the schedule holds at most: S * ceil(Q / tq)
  int stages, window;
  float scale2;                // scale * log2 e
  int cq, ck;                  // collapsed dims of the q and page maps
};

// Shared memory: the mbarriers, the schedule (ints), slack to a 1024-byte
// boundary, two Q slots [HDP/64][128 rows][128 B], then the ring's stages:
// K and V [HDP/64][64 rows][128 B] each and, for int8 pages, the staged
// codes of K and V [64][hd] and their scales [64] fp32 each.
struct PfLayout {
  int q_bytes, kv_bytes, raw_bytes, stage_bytes, sched_bytes;
  __host__ __device__ PfLayout(int hd, bool int8, int S, int umax) {
    const int hdp = (hd + 63) / 64 * 64;
    q_bytes = kPfRows * hdp * 2;
    kv_bytes = kPfKeys * hdp * 2;
    raw_bytes = int8 ? 2 * kPfKeys * hd + 2 * kPfKeys * 4 : 0;
    stage_bytes = (2 * kv_bytes + raw_bytes + 1023) / 1024 * 1024;
    // PfSched: 5S + 2 ints a slot, 9 a unit and one, the buckets, 8 scalars
    sched_bytes = 4 * (5 * S + 2 + 9 * umax + 1 + 2 * kPfBuckets + 8);
  }
  __host__ __device__ size_t head() const { return (size_t)kPfBarBytes + (sched_bytes + 15) / 16 * 16; }
  __host__ __device__ size_t smem(int stages) const {
    return head() + 1024 + 2 * (size_t)q_bytes + (size_t)stages * stage_bytes;
  }
};

// The schedule in shared memory (ints): per slot its live rows, first
// position, kv length, first unit and first dead token; per unit its slot,
// walk pages [lp0, lp1), stages, chunk size and count, its place in the
// sorted order, the first item of each sorted unit and the first chunk slot
// of each split unit; the sort's buckets; scalars.
struct PfSched {
  int *cnt, *start, *len, *ustart, *dstart;
  int *uslot, *ulp0, *ulp1, *ust, *ucs, *unc, *order, *istart, *cbase, *bkt, *misc;
  __device__ PfSched(int* base, int S, int umax) {
    cnt = base;
    start = cnt + S;
    len = start + S;
    ustart = len + S;
    dstart = ustart + S + 1;
    uslot = dstart + S + 1;
    ulp0 = uslot + umax;
    ulp1 = ulp0 + umax;
    ust = ulp1 + umax;
    ucs = ust + umax;
    unc = ucs + umax;
    order = unc + umax;     // the combine kernel: its split units
    istart = order + umax;
    cbase = istart + umax + 1;
    bkt = cbase + umax;
    misc = bkt + 2 * kPfBuckets;  // [0] units, [1] items, [2] fair share F,
                                  // [3] dead tokens, [4] split units
  }
};

// the slot whose prefix range holds i (the last s with pre[s] <= i)
__device__ __forceinline__ int pf_find(const int* pre, int n, int i) {
  int s = 0;
  for (int hi = n - 1; s < hi;) {
    const int mid = (s + hi + 1) / 2;
    if (pre[mid] <= i) s = mid; else hi = mid - 1;
  }
  return s;
}

// Stage i of a walk from logical page lp0 (pages below lp1): its first
// logical page lp, pages n (a 64-row slice sub of one page above 64-token
// pages), first key position pos0 and real keys.  pps: pages a stage up to
// 64-token pages (64 / bs), slices a page above (ceil(bs / 64)).
__device__ __forceinline__ void pf_stage(const PfArgs& p, int lp0, int lp1, int i, int& lp,
                                         int& n, int& sub, int& pos0, int& nreal) {
  if (p.bs <= kPfKeys) {
    lp = lp0 + i * p.pps;
    n = min(p.pps, lp1 - lp);
    sub = 0;
    pos0 = lp * p.bs;
    nreal = n * p.bs;
  } else {
    const int d = i / p.pps;
    lp = lp0 + d;
    n = 1;
    sub = i - d * p.pps;
    pos0 = lp * p.bs + sub * kPfKeys;
    nreal = min(kPfKeys, p.bs - sub * kPfKeys);
  }
}

// A unit of st stages against the fair share F: whole up to 1.5 F (the
// items are handed out heaviest first, so such a walk ends near the
// others), else cut into st / F chunks rounded up (at most kPfMaxChunks)
// with the stages spread evenly over them (every chunk non-empty)
__device__ __forceinline__ void pf_chunks(int st, int F, int& cs, int& nc) {
  if (2 * st <= 3 * F) {
    cs = st;
    nc = 1;
    return;
  }
  nc = min(kPfMaxChunks, (st + F - 1) / F);
  cs = (st + nc - 1) / nc;
  nc = (st + cs - 1) / cs;
}

// exclusive prefix of v over warp 0's lanes, carried across batches
__device__ __forceinline__ int pf_scan(int v, int lane, int& carry) {
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  const int ex = carry + x - v;
  carry += __shfl_sync(0xffffffffu, x, 31);
  return ex;
}

// Every block's copy of the schedule (all its threads take part).  `sort`:
// the items' order (the main kernel); else the list of split units (the
// combine kernel, in `order`).
__device__ void pf_schedule(const PfArgs& p, const PfSched& sc, bool sort) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nw = blockDim.x / 32;
  if (warp == 0) {  // slots: live rows, units and dead tokens, their prefixes
    int cu = 0, cd = 0;
    for (int b = 0; b < p.S; b += 32) {
      const int s = b + lane;
      int u = 0, d = 0;
      if (s < p.S) {
        const int c = min(max(p.q_counts[s], 0), p.Q);
        sc.cnt[s] = c;
        sc.start[s] = p.q_starts[s];
        sc.len[s] = p.kv_lens[s];
        u = (c + p.tq - 1) / p.tq;
        d = p.Q - c;
      }
      const int ue = pf_scan(u, lane, cu), de = pf_scan(d, lane, cd);
      if (s < p.S) sc.ustart[s] = ue, sc.dstart[s] = de;
    }
    if (lane == 0) {
      sc.ustart[p.S] = cu;
      sc.dstart[p.S] = cd;
      sc.misc[0] = cu;
      sc.misc[3] = cd;
    }
  }
  __syncthreads();
  const int U = sc.misc[0];
  int w = 0;  // each unit's walk: the keys [lo, hi) its rows see, as pages
  for (int u = tid; u < U; u += blockDim.x) {
    const int s = pf_find(sc.ustart, p.S + 1, u);
    const int count = sc.cnt[s], start = sc.start[s];
    const int t0 = (u - sc.ustart[s]) * p.tq;
    const int qf = start + t0, ql = start + min(t0 + p.tq, count) - 1;
    const int lo = p.window > 0 ? max(qf - p.window + 1, 0) : 0;
    const int hi = min(min(ql + 1, sc.len[s]), p.MB * p.bs);
    int lp0 = 0, lp1 = 0, st = 0;
    if (hi > lo) {
      lp0 = lo / p.bs;
      lp1 = (hi + p.bs - 1) / p.bs;
      st = p.bs <= kPfKeys ? (lp1 - lp0 + p.pps - 1) / p.pps : (lp1 - lp0) * p.pps;
    }
    sc.uslot[u] = s;
    sc.ulp0[u] = lp0;
    sc.ulp1[u] = lp1;
    sc.ust[u] = st;
    w += st;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
  if (lane == 0) sc.bkt[warp] = w;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int i = 0; i < nw; ++i) total += sc.bkt[i];
    total *= p.nkv;
    sc.misc[2] = max((long long)kPfMinStages, (total + p.grid - 1) / p.grid);
  }
  __syncthreads();
  const int F = sc.misc[2];
  for (int u = tid; u < U; u += blockDim.x) {
    int cs, nc;
    pf_chunks(sc.ust[u], F, cs, nc);
    sc.ucs[u] = cs;
    sc.unc[u] = nc;
  }
  __syncthreads();
  if (warp == 0) {
    // chunk bases of the split units, in unit order (and, for the combine,
    // the split units' list)
    int carry = 0;
    for (int b = 0; b < U; b += 32) {
      const int u = b + lane;
      const int nc = u < U ? sc.unc[u] : 1;
      const int ex = pf_scan(nc > 1 ? nc : 0, lane, carry);
      if (u < U) sc.cbase[u] = ex;
    }
    if (!sort) {
      int n = 0;
      for (int b = 0; b < U; b += 32) {
        const int u = b + lane;
        const bool split = u < U && sc.unc[u] > 1;
        const int ex = pf_scan(split ? 1 : 0, lane, n);
        if (split) sc.order[ex] = u;
      }
      if (lane == 0) sc.misc[4] = n;
    } else {
      // a counting sort of the units by key, heaviest first, stable
      for (int i = lane; i < 2 * kPfBuckets; i += 32) sc.bkt[i] = 0;
      __syncwarp();
      int* bcnt = sc.bkt;
      int* bpos = sc.bkt + kPfBuckets;
      for (int pass = 0; pass < 2; ++pass) {
        for (int b = 0; b < U; b += 32) {
          const int u = b + lane;
          // 1 + log2 of the unit's chunk size (0: no stage)
          const int key = u < U && sc.ucs[u] > 0 ? 32 - __clz(sc.ucs[u]) : 0;
          const unsigned act = __ballot_sync(0xffffffffu, u < U);
          if (u < U) {
            const unsigned same = __match_any_sync(act, key);
            if (pass == 1) sc.order[bpos[key] + __popc(same & ((1u << lane) - 1))] = u;
            __syncwarp(act);
            if (lane == __ffs(same) - 1) (pass == 0 ? bcnt : bpos)[key] += __popc(same);
          }
          __syncwarp();
        }
        if (pass == 0 && lane == 0) {
          int run = 0;
          for (int k = kPfBuckets - 1; k >= 0; --k) bpos[k] = run, run += bcnt[k];
        }
        __syncwarp();
      }
      // the items (chunks x kv heads) of the sorted units, their prefix
      carry = 0;
      for (int b = 0; b < U; b += 32) {
        const int i = b + lane;
        const int ex = pf_scan(i < U ? sc.unc[sc.order[i]] * p.nkv : 0, lane, carry);
        if (i < U) sc.istart[i] = ex;
      }
      if (lane == 0) {
        sc.istart[U] = carry;
        sc.misc[1] = carry;
      }
    }
  }
  __syncthreads();
}

// Item k of the schedule: unit u (slot s, first token t0), chunk c of nc,
// kv head h; its walk and stages [st0, st1) of it
struct PfItem {
  int u, s, h, t0, c, nc, st0, st1, lp0, lp1;
};
__device__ __forceinline__ PfItem pf_item(const PfArgs& p, const PfSched& sc, int k) {
  PfItem it;
  const int pos = pf_find(sc.istart, sc.misc[0], k);
  it.u = sc.order[pos];
  const int local = k - sc.istart[pos];
  it.c = local / p.nkv;
  it.h = local - it.c * p.nkv;
  it.s = sc.uslot[it.u];
  it.t0 = (it.u - sc.ustart[it.s]) * p.tq;
  it.nc = sc.unc[it.u];
  it.st0 = it.c * sc.ucs[it.u];
  it.st1 = min(sc.ust[it.u], it.st0 + sc.ucs[it.u]);
  it.lp0 = sc.ulp0[it.u];
  it.lp1 = sc.ulp1[it.u];
  return it;
}

// eight int8 codes times the row's scale, rounded to T, as 16 bytes
template <typename T>
__device__ __forceinline__ uint4 pf_dequant8(uint2 w, float sc) {
  uint32_t o[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t b = (h ? w.y : w.x) ^ 0x80808080u;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(biased_code(b, j), sc);
    o[2 * h] = Mma<T>::pack(v[0], v[1]);
    o[2 * h + 1] = Mma<T>::pack(v[2], v[3]);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One staged int8 tile (codes [64][hd], scales [64]) into the swizzled
// 16-bit tile [HDP/64][64 rows][128 B]; rows past nreal and columns past hd
// zero.  By the producer warpgroup's warps 1-3 (t = 0..95), 16 codes a step
// and two steps' loads in flight.
template <typename T, int HD>
__device__ __forceinline__ void pf_dequant_tile(const int8_t* codes, const float* scales,
                                                unsigned char* tile, int nreal, int t) {
  constexpr int HDP = (HD + 63) / 64 * 64, C16 = HDP / 16, N = kPfKeys * C16;
  for (int i0 = t; i0 < N; i0 += 2 * 96) {
    uint4 w[2];
    float sc[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + 96 * u, j = i / C16, c = i % C16;
      const bool in = i < N && j < nreal && c * 16 < HD;
      w[u] = in ? *reinterpret_cast<const uint4*>(codes + j * HD + c * 16)
                : make_uint4(0u, 0u, 0u, 0u);
      sc[u] = in ? scales[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + 96 * u, j = i / C16, c = i % C16;
      if (i < N) {
        // 16 columns: two 16-byte groups of one 128-byte row
        unsigned char* row = tile + (c / 4) * (kPfKeys * 128) + j * 128;
        const int g = 2 * (c % 4);
        *reinterpret_cast<uint4*>(row + ((g ^ (j & 7)) << 4)) =
            pf_dequant8<T>(make_uint2(w[u].x, w[u].y), sc[u]);
        *reinterpret_cast<uint4*>(row + (((g + 1) ^ (j & 7)) << 4)) =
            pf_dequant8<T>(make_uint2(w[u].z, w[u].w), sc[u]);
      }
    }
  }
}

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kPfThreads, 1)
    prefill_wgmma_kernel(const __grid_constant__ PfArgs p, const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv) {
  constexpr bool kInt8 = !std::is_same<T, P>::value;
  constexpr int HDP = (HD + 63) / 64 * 64, NAT = HDP / 64, KSTEPS = HD / 16;
  constexpr int NS = kPfKeys / 2;  // score registers a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_full + 4;
  uint64_t* k_empty = k_full + kPfMaxStages;
  uint64_t* v_full = k_empty + kPfMaxStages;
  uint64_t* v_empty = v_full + kPfMaxStages;
  uint64_t* r_full = v_empty + kPfMaxStages;   // int8: the staged codes landed
  uint64_t* r_empty = r_full + kPfMaxStages;   // int8: the staged codes read
  int* qitem = reinterpret_cast<int*>(r_empty + kPfMaxStages);  // [2]
  const PfLayout lay(HD, kInt8, p.S, p.umax);
  const PfSched sc(reinterpret_cast<int*>(smem_raw + kPfBarBytes), p.S, p.umax);
  unsigned char* base = smem_raw + lay.head();
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  unsigned char* ring = base + 2 * lay.q_bytes;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  griddep_launch();  // the combine kernel may be scheduled as blocks finish
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);
    }
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&k_full[s], kInt8 ? 3 : 1);
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_full[s], kInt8 ? 3 : 1);
      mbar_init(&v_empty[s], 8);
      mbar_init(&r_full[s], 1);
      mbar_init(&r_empty[s], 3);
    }
    fence_mbar_init();
  }
  // the ring starts as zeros: the pad rows of a stage short of 64 keys are
  // never written, and V's are read with P = 0
  for (int i = threadIdx.x; i < p.stages * lay.stage_bytes / 16; i += kPfThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  pf_schedule(p, sc, true);
  const int items = sc.misc[1];

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kPfRegProducer>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp > 0) {
      const int t = threadIdx.x - 32;
      // this block's share of the dead rows (tokens past q_counts[s]), zeros
      {
        const int D = sc.misc[3], per = (D + p.grid - 1) / p.grid;
        const int d0 = min(D, blockIdx.x * per), d1 = min(D, d0 + per);
        const size_t row = (size_t)p.nkv * p.g * p.hd;  // elements a token
        for (int s = d0 < d1 ? pf_find(sc.dstart, p.S + 1, d0) : p.S; s < p.S; ++s) {
          const int a = max(d0, sc.dstart[s]), b = min(d1, sc.dstart[s + 1]);
          if (a >= d1) break;
          if (a >= b) continue;
          uint4* dst = reinterpret_cast<uint4*>(static_cast<T*>(p.out) +
                                                ((size_t)s * p.Q + sc.cnt[s] + a - sc.dstart[s]) * row);
          const size_t n = (size_t)(b - a) * row * sizeof(T) / 16;
          for (size_t i = t; i < n; i += 96) dst[i] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if constexpr (kInt8) {
        // dequantize each stage as its codes land, into its K and V tiles,
        // item by item as the Q slots announce them
        int it = 0;
        for (int i = 0;; ++i) {
          mbar_wait(&q_full[i & 1], (i >> 1) & 1);
          const int k = qitem[i & 1];
          if (k < 0) break;
          const PfItem itm = pf_item(p, sc, k);
          for (int j = itm.st0; j < itm.st1; ++j, ++it) {
            const int s = it % p.stages, ph = (it / p.stages - 1) & 1;
            int lp, n, sub, pos0, nreal;
            pf_stage(p, itm.lp0, itm.lp1, j, lp, n, sub, pos0, nreal);
            unsigned char* st = ring + (size_t)s * lay.stage_bytes;
            const int8_t* raw = reinterpret_cast<const int8_t*>(st + 2 * lay.kv_bytes);
            const float* scl = reinterpret_cast<const float*>(raw + 2 * kPfKeys * HD);
            mbar_wait(&r_full[s], (it / p.stages) & 1);
            if (it >= p.stages) mbar_wait(&k_empty[s], ph);
            pf_dequant_tile<T, HD>(raw, scl, st, nreal, t);
            fence_proxy_async();
            warp_arrive(&k_full[s], lane);
            if (it >= p.stages) mbar_wait(&v_empty[s], ph);
            pf_dequant_tile<T, HD>(raw + kPfKeys * HD, scl + kPfKeys, st + lay.kv_bytes, nreal, t);
            fence_proxy_async();
            warp_arrive(&v_full[s], lane);
            warp_arrive(&r_empty[s], lane);
          }
        }
      }
      return;
    }
    // warp 0: every copy, lane 0 issuing.  Item blockIdx.x first, then one
    // from the counter at a time, asked for while the current one streams;
    // each announced in its Q slot, -1 when there is no more
    int* work = p.counters;    // items handed out past the first gridDim.x
    int* done = work + 1;      // blocks whose producer has run out of work
    int it = 0, i = 0;
    for (int k = blockIdx.x;; ++i) {
      const int slot = i & 1;
      if (i >= 2) mbar_wait(&q_empty[slot], ((i >> 1) - 1) & 1);
      if (k >= items) {
        if (lane == 0) {
          qitem[slot] = -1;
          mbar_arrive(&q_full[slot]);
          __threadfence();
          if ((unsigned)atomicAdd(done, 1) == gridDim.x - 1) *work = 0, *done = 0;
        }
        break;
      }
      // the next item is asked for two stages before this one's last, so
      // that a block with a long walk ahead takes no more than its share
      int knext = 0;
      const PfItem itm = pf_item(p, sc, k);
      const int ask = max(itm.st0, itm.st1 - 2);
      if (itm.st1 <= itm.st0 && lane == 0) knext = gridDim.x + atomicAdd(work, 1);
      if (lane == 0) {
        qitem[slot] = k;
        unsigned char* qs = base + slot * lay.q_bytes;
        mbar_expect_tx(&q_full[slot], NAT * p.tq * p.g * 128);
#pragma unroll
        for (int cb = 0; cb < NAT; ++cb)
          tma_load_5d(qs + cb * kPfRows * 128, &tmq, cb * 64, 0, tma_c(p.cq, 2, itm.h),
                      tma_c(p.cq, 3, itm.t0), tma_c(p.cq, 4, itm.s), &q_full[slot]);
      }
      // lane l holds the table entry of logical page tb + l (past the
      // walk: a page past the pool, which TMA reads as zeros), refilled 32
      // pages at a time
      const int* bt = p.block_table + (size_t)itm.s * p.MB;
      int tb = -64, entry = p.NB;
      for (int j = itm.st0; j < itm.st1; ++j, ++it) {
        const int s = it % p.stages, ph = (it / p.stages - 1) & 1;
        if (j == ask && lane == 0) knext = gridDim.x + atomicAdd(work, 1);
        int lp, n, sub, pos0, nreal;
        pf_stage(p, itm.lp0, itm.lp1, j, lp, n, sub, pos0, nreal);
        if (lp + 4 > tb + 32) {
          tb = lp;
          entry = tb + lane < itm.lp1 ? bt[tb + lane] : p.NB;
        }
        const int mine = __shfl_sync(0xffffffffu, entry, min(lp - tb + lane, 31));
        const int mine_ok = lane < n ? mine : p.NB;
        unsigned char* st = ring + (size_t)s * lay.stage_bytes;
        if constexpr (kInt8) {
          if (it >= p.stages) mbar_wait(&r_empty[s], ph);
          unsigned char* raw = st + 2 * lay.kv_bytes;
          float* scl = reinterpret_cast<float*>(raw + 2 * kPfKeys * HD);
          const int rows = p.bs <= kPfKeys ? p.bs : nreal;
          if (lane == 0) mbar_expect_tx(&r_full[s], n * rows * (2 * HD + 8));
          for (int pg = 0; pg < n; ++pg) {
            const int page = __shfl_sync(0xffffffffu, mine_ok, pg);
            if (lane == 0) {
              const size_t slab = ((size_t)page * p.nkv + itm.h) * p.bs + sub * kPfKeys;
              bulk_load(raw + pg * rows * HD, static_cast<const int8_t*>(p.kpool) + slab * HD,
                        rows * HD, &r_full[s]);
              bulk_load(raw + kPfKeys * HD + pg * rows * HD,
                        static_cast<const int8_t*>(p.vpool) + slab * HD, rows * HD, &r_full[s]);
              bulk_load(scl + pg * rows, p.kscale + slab, rows * 4, &r_full[s]);
              bulk_load(scl + kPfKeys + pg * rows, p.vscale + slab, rows * 4, &r_full[s]);
            }
          }
        } else {
          const int pps = p.bs <= kPfKeys ? kPfKeys / p.bs : 1;
          const int rows = min(p.bs, kPfKeys);  // rows a box
          int pages[4];
#pragma unroll
          for (int pg = 0; pg < 4; ++pg) pages[pg] = __shfl_sync(0xffffffffu, mine_ok, pg);
          if (it >= p.stages) mbar_wait(&k_empty[s], ph);
          if (lane == 0) {
            mbar_expect_tx(&k_full[s], NAT * pps * rows * 128);
#pragma unroll
            for (int pg = 0; pg < 4; ++pg)
#pragma unroll
              for (int cb = 0; cb < NAT; ++cb)
                if (pg < pps)
                  tma_load_4d(st + cb * kPfKeys * 128 + pg * rows * 128, &tmk, cb * 64,
                              sub * kPfKeys, tma_c(p.ck, 2, itm.h), tma_c(p.ck, 3, pages[pg]),
                              &k_full[s]);
          }
          if (it >= p.stages) mbar_wait(&v_empty[s], ph);
          if (lane == 0) {
            mbar_expect_tx(&v_full[s], NAT * pps * rows * 128);
#pragma unroll
            for (int pg = 0; pg < 4; ++pg)
#pragma unroll
              for (int cb = 0; cb < NAT; ++cb)
                if (pg < pps)
                  tma_load_4d(st + lay.kv_bytes + cb * kPfKeys * 128 + pg * rows * 128, &tmv,
                              cb * 64, sub * kPfKeys, tma_c(p.ck, 2, itm.h),
                              tma_c(p.ck, 3, pages[pg]), &v_full[s]);
          }
        }
      }
      k = __shfl_sync(0xffffffffu, knext, 0);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kPfRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  const float* slopes = p.slopes;
  float o[NAT][32];
  float sm[NS];
  uint32_t pa[kPfKeys / 16][4];
  float m[2], l[2], alpha[2];
#pragma unroll
  for (int j = 0; j < NS; ++j) sm[j] = 0.f;
  int it = 0;
  if (c == 1) turn_pass(c);  // the first consumer warpgroup takes the first turn
  for (int i = 0;; ++i) {
    const int slot = i & 1;
    mbar_wait(&q_full[slot], (i >> 1) & 1);
    // values from shared memory that steer a wgmma go through a shuffle, so
    // that ptxas sees them uniform (a wgmma behind a branch it cannot prove
    // uniform makes it serialise every wgmma of the kernel)
    const int k = __shfl_sync(0xffffffffu, qitem[slot], 0);
    if (k < 0) break;
    const PfItem itm = pf_item(p, sc, k);
    const int st0 = __shfl_sync(0xffffffffu, itm.st0, 0);
    const int st1 = __shfl_sync(0xffffffffu, itm.st1, 0);
    const int count = sc.cnt[itm.s], start = sc.start[itm.s], len = sc.len[itm.s];
    // this thread's two rows: 64c + 16w + grp (+ 8)
    int qpos[2];
    bool live[2];
    float slope2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 64 * c + 16 * w + grp + 8 * hh, t = r / p.g;
      live[hh] = r < p.tq * p.g && itm.t0 + t < count;
      qpos[hh] = start + itm.t0 + t;
      slope2[hh] = slopes != nullptr ? slopes[itm.h * p.g + r % p.g] * kLog2e : 0.f;
    }
    // the warpgroup's rows as a whole: all live, their first and last position
    const int r_lo = 64 * c, r_hi = 64 * c + 63;
    const bool wg_live = r_hi < p.tq * p.g && itm.t0 + r_hi / p.g < count;
    // this warp's 16 rows: none live (a decode row or a short chunk leaves
    // most warps without one)
    const int w_lo = 64 * c + 16 * w;
    const bool warp_dead = w_lo >= p.tq * p.g || itm.t0 + w_lo / p.g >= count;
    const int q_lo = start + itm.t0 + r_lo / p.g, q_hi = start + itm.t0 + r_hi / p.g;
    const unsigned char* qs = base + slot * lay.q_bytes + c * 64 * 128;
#pragma unroll
    for (int a = 0; a < NAT; ++a)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[a][j] = 0.f;
    l[0] = l[1] = 0.f;
    m[0] = m[1] = -INFINITY;
    // Stage j's softmax: its scores in sm become probabilities, m and l
    // move on and alpha rescales O.  A stage that every row of the
    // warpgroup sees whole takes no mask (and, without alibi, no per-score
    // scaling before the maximum).
    auto softmax = [&](int j) {
      if (warp_dead) {  // no live row: probabilities 0, m and l as they were
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) sm[jj] = 0.f;
        alpha[0] = alpha[1] = 1.f;
        return;
      }
      int lp, n, sub, pos0, nreal;
      pf_stage(p, itm.lp0, itm.lp1, j, lp, n, sub, pos0, nreal);
      const int last = pos0 + kPfKeys - 1;
      const bool full = wg_live && nreal == kPfKeys && last <= q_lo && last < len &&
                        (p.window <= 0 || pos0 > q_hi - p.window);
      const bool raw = full && slopes == nullptr;
      if (!raw) {
        // each row sees the stage's keys [klo, khi): its position, the kv
        // length and the real keys above, the window below
        int klo[2], khi[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          khi[hh] = full ? kPfKeys
                         : (live[hh] ? min(nreal, min(qpos[hh] + 1, len) - pos0) : 0);
          klo[hh] = !full && p.window > 0 ? qpos[hh] - p.window + 1 - pos0 : 0;
        }
#pragma unroll
        for (int j8 = 0; j8 < kPfKeys / 8; ++j8)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * j8 + 2 * tq + e;
              float& v = sm[4 * j8 + 2 * hh + e];
              v = slopes != nullptr ? fmaf(v, p.scale2, slope2[hh] * (float)(pos0 + key))
                                    : v * p.scale2;
              if (key < klo[hh] || key >= khi[hh]) v = -INFINITY;
            }
      }
      float mx[2] = {-INFINITY, -INFINITY}, mu[2], ps[2];
      row_max(sm, mx);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        if (raw) mx[hh] *= p.scale2;
        const float mnew = fmaxf(m[hh], mx[hh]);
        mu[hh] = mnew == -INFINITY ? 0.f : mnew;  // a row that saw no key yet
        alpha[hh] = ex2(m[hh] - mu[hh]);
        m[hh] = mnew;
      }
      if (raw) {
        const float nm0 = -mu[0], nm1 = -mu[1];
#pragma unroll
        for (int jj = 0; jj < NS; ++jj)
          sm[jj] = ex2(fmaf(sm[jj], p.scale2, (jj >> 1) & 1 ? nm1 : nm0));
      } else {
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) sm[jj] = ex2(sm[jj] - mu[(jj >> 1) & 1]);
      }
      row_sum(sm, ps);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
    };
    // S = Q K^T of the stage st into sm (committed, not waited)
    auto scores = [&](const unsigned char* st) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        Wgmma<T>::ss64(sm, wg_desc(qs + (kk / 4) * kPfRows * 128 + (kk % 4) * 32),
                       wg_desc(st + (kk / 4) * kPfKeys * 128 + (kk % 4) * 32), kk > 0);
      wg_commit();
    };
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
      for (int kk = 0; kk < kPfKeys / 16; ++kk) {
        pa[kk][0] = Mma<T>::pack(sm[8 * kk + 0], sm[8 * kk + 1]);
        pa[kk][1] = Mma<T>::pack(sm[8 * kk + 2], sm[8 * kk + 3]);
        pa[kk][2] = Mma<T>::pack(sm[8 * kk + 4], sm[8 * kk + 5]);
        pa[kk][3] = Mma<T>::pack(sm[8 * kk + 6], sm[8 * kk + 7]);
      }
    };
    auto fence_all = [&]() {
      wg_fence_regs(sm);
#pragma unroll
      for (int a = 0; a < NAT; ++a) wg_fence_regs(o[a]);
#pragma unroll
      for (int kk = 0; kk < kPfKeys / 16; ++kk) wg_fence_regs(pa[kk]);
    };

    if (st1 > st0) {
      // the first stage: S and its softmax; then each further stage's S is
      // issued with the previous stage's O += P V behind it, which runs
      // while this stage's softmax does
      int s = it % p.stages;
      mbar_wait(&k_full[s], (it / p.stages) & 1);
      const unsigned char* st = ring + (size_t)s * lay.stage_bytes;
      fence_all();
      turn_wait(c);
      wg_fence();
      scores(st);
      turn_pass(c);
      wg_wait<0>();
      wg_fence_regs(sm);
      softmax(st0);
      warp_arrive(&k_empty[s], lane);
      rescale_pack();
      int vph = (it / p.stages) & 1;
      ++it;
      for (int j = st0 + 1; j < st1; ++j, ++it) {
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
        pv_product<T, NAT, kPfKeys>(o, pa, vp);
        wg_commit();
        turn_pass(c);
        wg_wait<1>();  // this S; the P V product may still run
        wg_fence_regs(sm);
        softmax(j);
        warp_arrive(&k_empty[s], lane);
        wg_wait<0>();  // the previous P V: O and pa are free again
        fence_all();
        warp_arrive(&v_empty[sp], lane);
        rescale_pack();
        vph = (it / p.stages) & 1;
      }
      // the walk's last P V product
      mbar_wait(&v_full[s], vph);
      fence_all();
      turn_wait(c);
      wg_fence();
      pv_product<T, NAT, kPfKeys>(o, pa, st + lay.kv_bytes);
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      fence_all();
      warp_arrive(&v_empty[s], lane);
    }
    warp_arrive(&q_empty[slot], lane);

    // ---- epilogue: a whole walk stores o / l; a chunk of a split walk its
    // fp32 partials (acc, m, l) of the live rows
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    const size_t pslot = ((size_t)sc.cbase[itm.u] + itm.c) * p.nkv + itm.h;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!live[hh]) continue;
      const int r = 64 * c + 16 * w + grp + 8 * hh, t = r / p.g;
      if (itm.nc == 1) {
        const float inv = l[hh] == 0.f ? 0.f : 1.f / l[hh];  // no key seen: zeros
        T* orow = static_cast<T*>(p.out) +
                  ((((size_t)itm.s * p.Q + itm.t0 + t) * p.nkv + itm.h) * p.g + r % p.g) * HD;
#pragma unroll
        for (int a = 0; a < NAT; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * a + 8 * j + 2 * tq;
            if (col < HD)
              *reinterpret_cast<uint32_t*>(orow + col) =
                  Mma<T>::pack(o[a][4 * j + 2 * hh] * inv, o[a][4 * j + 2 * hh + 1] * inv);
          }
      } else {
        float* prow = p.part_acc + (pslot * kPfRows + r) * HD;
#pragma unroll
        for (int a = 0; a < NAT; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * a + 8 * j + 2 * tq;
            if (col < HD)
              *reinterpret_cast<float2*>(prow + col) =
                  make_float2(o[a][4 * j + 2 * hh], o[a][4 * j + 2 * hh + 1]);
          }
        if (tq == 0)
          *reinterpret_cast<float2*>(p.part_ml + (pslot * kPfRows + r) * 2) =
              make_float2(m[hh], l[hh]);
      }
    }
  }
}

// The chunks of each split walk merged in chunk order (the logsumexp
// combine; log2 units).  A block takes (unit, kv head, 16 rows) at a time,
// 8 threads a row and HD / 32 four-column groups a thread; every chunk's
// (m, l) and partial columns are loaded before they are summed, so a group
// costs two rounds of loads.  Launched as a programmatic dependent of
// prefill_wgmma_kernel: the schedule and the list of split units are
// worked out before the wait (a grid with no split walk ends at it).
template <typename T, int HD>
__global__ void __launch_bounds__(128) prefill_combine_kernel(const __grid_constant__ PfArgs p) {
  constexpr int NQ = HD / 32, RG = kPfRows / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PfSched sc(reinterpret_cast<int*>(smem_raw), p.S, p.umax);
  pf_schedule(p, sc, false);
  const int work = sc.misc[4] * p.nkv * RG;  // (split unit, kv head, 16 rows)
  griddep_wait();
  const int rq = threadIdx.x / 8, col = 4 * (threadIdx.x % 8);
  for (int k = blockIdx.x; k < work; k += gridDim.x) {
    const int uh = k / RG, su = uh / p.nkv;
    const int u = sc.order[su], h = uh - su * p.nkv, r = 16 * (k - uh * RG) + rq;
    const int nc = sc.unc[u], s = sc.uslot[u];
    const int t0 = (u - sc.ustart[s]) * p.tq;
    if (r >= min(p.tq, sc.cnt[s] - t0) * p.g) continue;
    const size_t p0 = (size_t)sc.cbase[u] * p.nkv + h;
    float mc[kPfMaxChunks], lc[kPfMaxChunks];
#pragma unroll
    for (int c = 0; c < kPfMaxChunks; ++c) {
      mc[c] = -INFINITY, lc[c] = 0.f;
      if (c < nc) {
        const float2 v =
            *reinterpret_cast<const float2*>(p.part_ml + ((p0 + (size_t)c * p.nkv) * kPfRows + r) * 2);
        mc[c] = v.x, lc[c] = v.y;
      }
    }
    float M = -INFINITY, L = 0.f;
#pragma unroll
    for (int c = 0; c < kPfMaxChunks; ++c) M = fmaxf(M, mc[c]);
#pragma unroll
    for (int c = 0; c < kPfMaxChunks; ++c) {
      mc[c] = mc[c] == -INFINITY ? 0.f : ex2(mc[c] - M);  // the chunk's weight
      L += lc[c] * mc[c];
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    float4 acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    // four chunks' columns in flight at a time, summed in chunk order
#pragma unroll
    for (int c0 = 0; c0 < kPfMaxChunks; c0 += 4) {
      if (c0 >= nc) continue;
      float4 a[4][NQ];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          a[c][q] = c0 + c < nc ? *reinterpret_cast<const float4*>(
                                      p.part_acc +
                                      ((p0 + (size_t)(c0 + c) * p.nkv) * kPfRows + r) * HD +
                                      col + 32 * q)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float wt = mc[c0 + c];
          acc[q].x += a[c][q].x * wt, acc[q].y += a[c][q].y * wt;
          acc[q].z += a[c][q].z * wt, acc[q].w += a[c][q].w * wt;
        }
    }
    T* orow = static_cast<T*>(p.out) +
              ((((size_t)s * p.Q + t0 + r / p.g) * p.nkv + h) * p.g + r % p.g) * HD + col;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      store4<T>(orow + 32 * q, {acc[q].x * inv, acc[q].y * inv, acc[q].z * inv, acc[q].w * inv});
  }
}

// The 16-bit prefill: `p` filled in but for stages (the deepest ring up to
// 8 that the card's opt-in shared memory holds, at least 1); q 16-byte
// aligned [S, Q, nkv, g, hd], 16-bit pages by TMA (int8 pages by bulk
// copies).  Then the combine, as a programmatic dependent.
template <typename T, typename P, int HD>
cudaError_t launch_prefill_hopper(PfArgs p, const void* q, cudaStream_t st) {
  constexpr bool kInt8 = !std::is_same<T, P>::value;
  const PfLayout lay(HD, kInt8, p.S, p.umax);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long long room = (long long)optin - (long long)lay.smem(0);
  p.stages = (int)std::min<long long>(kPfMaxStages, room / lay.stage_bytes);
  if (p.stages < 1 || p.tq < 1 || p.tq * p.g > kPfRows) return cudaErrorInvalidValue;
  CUtensorMap tmq, tmk, tmv;
  {
    const long long dims[5] = {HD, p.g, p.nkv, p.Q, p.S};
    const long long strides[5] = {1, HD, (long long)p.g * HD, (long long)p.nkv * p.g * HD,
                                  (long long)p.Q * p.nkv * p.g * HD};
    const int box[5] = {64, p.g, 1, p.tq, 1};
    if (!tensor_map_nd(&tmq, tma_dtype<T>(), 2, q, 5, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B, &p.cq))
      return cudaErrorInvalidValue;
  }
  tmk = tmv = tmq;
  if constexpr (!kInt8) {
    const long long dims[4] = {HD, p.bs, p.nkv, p.NB};
    const long long strides[4] = {1, HD, (long long)p.bs * HD, (long long)p.nkv * p.bs * HD};
    const int box[4] = {64, std::min(p.bs, kPfKeys), 1, 1};
    int cv = 0;
    if (!tensor_map_nd(&tmk, tma_dtype<T>(), 2, p.kpool, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B, &p.ck) ||
        !tensor_map_nd(&tmv, tma_dtype<T>(), 2, p.vpool, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B, &cv))
      return cudaErrorInvalidValue;
  }
  err = allow_dynamic_smem<prefill_wgmma_kernel<T, P, HD>>();
  if (err == cudaSuccess) err = allow_dynamic_smem<prefill_combine_kernel<T, HD>>();
  if (err != cudaSuccess) return err;
  prefill_wgmma_kernel<T, P, HD><<<p.grid, kPfThreads, lay.smem(p.stages), st>>>(p, tmq, tmk, tmv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pdl(prefill_combine_kernel<T, HD>, dim3(p.grid), dim3(128),
                    (size_t)lay.sched_bytes, st, true, p);
}

}  // namespace dsk
