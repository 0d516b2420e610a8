// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py:_split_kernel
// (launched by _pallas_paged_attention_split): one query token per serving
// slot attends that slot's KV pages through its block table; GQA-native (one
// block serves a kv head and its whole query group), alibi, sliding window
// (pages wholly before the window are never read), kv_len == 0 -> zeros.
// int8 pages (kv_quant, the TPU kernel's quant=True) carry a [bs] fp32 scale
// row of K and of V per (page, head) and are dequantized as the TPU kernel's
// _dequant_page: an fp32 code * scale rounded once to q's dtype.  P is
// rounded to that dtype before P.V; l sums the unrounded values.
//
// What bounds it on the H100: HBM bytes.  Every live K and V row is read
// once (bs=64 x hd=128 bf16 = 16 KB per page and head; half that in int8),
// against ~4*g*hd operations per key: far below the ~295 op/byte ridge.
// The design is about bytes in flight and no wasted work per byte.
//
// 16-bit q (bf16 / fp16 or int8 pages): paged_decode_mma_kernel.
//   - Work: each slot's live pages are cut into chunks (at least ~256 keys,
//     at most 16 chunks a slot), counted from kv_lens by every block itself
//     (the host never syncs); a work item is one (chunk, kv head).  The
//     grid is persistent, two blocks an SM: block b takes item b, then one
//     item at a time from a counter in device memory, asked for while the
//     current item streams.  So the blocks that are served their bytes
//     first take more items, and the last block out does not set the time
//     (with a fixed share per block, the blocks served last did).
//   - Warp 0 (producer): one thread moves each (page, head) slab of K and V
//     (bs*hd contiguous elements) with a 1-D bulk copy (cp.async.bulk)
//     completing on the stage's mbarrier, beside a record of what the stage
//     holds; its lanes copy an int8 page's scale rows with cp.async,
//     arriving on the same barrier; the first page of an item also brings
//     the slot's q rows.  A ring of 1-8 stages runs across items.
//   - Warps 1-4 (consumers): the 16-key tiles of each page are dealt out
//     round robin, so each K and V element is read (and, for int8,
//     dequantized) once a block.  Scores on the tensor cores: mma.sync
//     m16n8k16 with the g query rows padded to 16 (wgmma's 64-row tile
//     would be mostly padding at g = 4): S = Q K^T, the contraction over
//     head_dim taken in the order one 16-byte load of a key row gives, so
//     K is read with 16-byte loads and no shuffles.  The output as O^T =
//     V^T P^T (m16 over head_dim, n8 over the query group): P's fragment
//     comes straight from S's accumulator, and each lane reads four whole
//     value rows' slices of its own head_dim columns.  Each warp keeps its
//     own online softmax (scores in log2 units).
//   - At the end of an item the warps merge their states in shared memory
//     in warp order (a tile's warp follows its place in the item, not the
//     block).  An item that is the whole slot writes the output; a chunk of
//     a longer slot writes fp32 partials (acc, m, l), and
//     decode_combine_kernel merges each such slot's chunks in chunk order
//     (and writes zeros for an empty slot): no float atomics, the same bits
//     every run whichever blocks ran what.  A merge fused into the decode
//     (the last chunk's block merging, found by a counter) waits on device
//     memory under full load: on the H100 it stalled the consumers longer
//     than the second launch takes.
//
// fp32 q (fp32 pages, or int8 pages at fp32, where exact fp32 is the point):
// paged_decode_kernel on the CUDA cores.  Grid (slot, kv head, split), each
// split walks its share of the slot's live pages with the (page, head)
// slabs double-buffered by cp.async; one warp per query head, lanes split
// head_dim, warp reductions give the scores, and the online softmax keeps m,
// l and acc in fp32 registers; split_combine_kernel merges the splits with
// the TPU epilogue's logsumexp combine (paged_attention.py :425-431).
#include "hopper_common.cuh"

namespace dsk {

// ------------------------------------------------ fp32: CUDA cores

// keys per step of a warp: their dot products and shuffle reductions are
// independent, so kKeys of them are in flight together (one key at a time
// left the warp waiting on each reduction's latency)
constexpr int kKeys = 8;

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(256) paged_decode_kernel(
    const T* __restrict__ q, const P* __restrict__ kpool, const P* __restrict__ vpool,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int* __restrict__ block_table, const int* __restrict__ kv_lens,
    const float* __restrict__ slopes, T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int nkv, int g, int bs, int MB, int NS, float scale,
    int window) {
  constexpr int VEC = HD / 32;
  constexpr bool kInt8 = !std::is_same<T, P>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int page_elems = bs * HD;
  P* kbuf = reinterpret_cast<P*>(smem);  // [2][bs*HD]
  P* vbuf = kbuf + 2 * page_elems;       // [2][bs*HD]
  float* ksc = reinterpret_cast<float*>(vbuf + 2 * page_elems);  // int8: [2][bs]
  float* vsc = ksc + 2 * bs;                                     // int8: [2][bs]

  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int gi = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int length = kv_lens[s];
  const int n_pages = (length + bs - 1) / bs;
  const int lo = window > 0 ? max(length - window, 0) : 0;
  const int lo_page = lo / bs;
  const int live = max(n_pages - lo_page, 0);
  const int per = (live + NS - 1) / NS;
  const int p_start = lo_page + sp * per;
  const int n = max(min(p_start + per, n_pages) - p_start, 0);

  const size_t row = ((size_t)s * nkv + h) * g + gi;
  float qr[VEC];
  load_vec<T, VEC>(q + row * HD + lane * VEC, qr);
  const float slope = slopes != nullptr ? slopes[h * g + gi] : 0.f;
  RowState<VEC> st;
  st.init();
  const int* bt = block_table + (size_t)s * MB;

  auto fetch = [&](int buf, int page) {
    if constexpr (kInt8) load_scales(ksc + buf * bs, vsc + buf * bs, kscale, vscale, page, h, nkv, bs);
    load_page(kbuf + buf * page_elems, vbuf + buf * page_elems, kpool, vpool, page, h, nkv,
              page_elems);
  };
  if (n > 0) fetch(0, bt[p_start]);
  for (int i = 0; i < n; ++i) {
    const int p = p_start + i;
    const int b = i & 1;
    if (i + 1 < n) {
      fetch(b ^ 1, bt[p + 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const P* kb = kbuf + b * page_elems;
    const P* vb = vbuf + b * page_elems;
    const float* ks = ksc + b * bs;
    const float* vs = vsc + b * bs;
    const int t0 = max(0, lo - p * bs);          // window: kvpos >= lo
    const int t1 = min(bs, length - p * bs);     // kvpos < length
    for (int t = t0; t < t1; t += kKeys) {
      const int nk = min(kKeys, t1 - t);
      float d[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        d[j] = 0.f;
        if (j < nk) {
          float kr[VEC];
          load_kv<T, P, VEC>(kb + (t + j) * HD + lane * VEC, kInt8 ? ks[t + j] : 1.f, kr);
#pragma unroll
          for (int e = 0; e < VEC; ++e) d[j] += qr[e] * kr[e];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) d[j] += __shfl_xor_sync(0xffffffffu, d[j], o);
      }
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        d[j] = d[j] * scale + slope * (float)(p * bs + t + j);
        if (j < nk) mx = fmaxf(mx, d[j]);
      }
      st.rescale(mx);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (j < nk) {
          float vr[VEC];
          load_kv<T, P, VEC>(vb + (t + j) * HD + lane * VEC, kInt8 ? vs[t + j] : 1.f, vr);
          st.template add<T>(d[j], vr);
        }
      }
    }
    __syncthreads();  // buffer b is refilled by the next iteration's copy
  }

  if (NS == 1) {
    const float inv = 1.f / (st.l == 0.f ? 1.f : st.l);
    store_vec<T, VEC>(out + row * HD + lane * VEC, st.acc, inv);
    return;
  }
  const size_t prow = (((size_t)s * nkv + h) * NS + sp) * g + gi;
#pragma unroll
  for (int j = 0; j < VEC; ++j) part_acc[prow * HD + lane * VEC + j] = st.acc[j];
  if (lane == 0) {
    part_ml[prow * 2] = st.m;
    part_ml[prow * 2 + 1] = st.l;
  }
}

// o = sum_s exp(m_s - m*) acc_s / sum_s exp(m_s - m*) l_s; den == 0 -> 1
// (all splits empty: inactive slot -> zeros).  One block per (slot, kv
// head, query head), one thread per output column: the split weights are
// computed once into shared memory, then each thread streams its column of
// the partials.
template <typename T>
__global__ void split_combine_kernel(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml, T* __restrict__ out,
                                     int g, int hd, int NS) {
  extern __shared__ float wsh[];  // [NS] weights, then [1] denominator
  const int sh = blockIdx.x / g, gi = blockIdx.x % g;
  const size_t base = (size_t)sh * NS * g + gi;   // partial row of split 0
  if (threadIdx.x < 32) {
    float mstar = kNegInf;
    for (int k = threadIdx.x; k < NS; k += 32)
      mstar = fmaxf(mstar, part_ml[(base + (size_t)k * g) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mstar = fmaxf(mstar, __shfl_xor_sync(0xffffffffu, mstar, o));
    float den = 0.f;
    for (int k = threadIdx.x; k < NS; k += 32) {
      const float w = expf(part_ml[(base + (size_t)k * g) * 2] - mstar);
      wsh[k] = w;
      den += part_ml[(base + (size_t)k * g) * 2 + 1] * w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    if (threadIdx.x == 0) wsh[NS] = den == 0.f ? 1.f : den;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float num = 0.f;
#pragma unroll 4
    for (int k = 0; k < NS; ++k) num += part_acc[(base + (size_t)k * g) * hd + d] * wsh[k];
    out[((size_t)sh * g + gi) * hd + d] = Bits<T>::from_f(num / wsh[NS]);
  }
}


// ------------------------------------------------ 16-bit q: tensor cores
constexpr int kDecW = 4;                       // consumer warps
constexpr int kDecThreads = 32 * (kDecW + 1);  // and the producer warp
constexpr int kDecMaxStages = 8;
constexpr int kDecMaxChunks = 16;              // chunks a slot is cut into at most
constexpr int kDecHead = 512;                  // mbarriers, stage records
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block (ops/paged_attention.py decode_plan mirrors
// it; the launch refuses what does not fit):
//   [0, 512)  full[8], empty[8] mbarriers; from 256 each stage's record of
//             what it holds: slot, kv head, chunk, page of the chunk, the
//             chunk's pages, the slot's chunks, and "no more work"
//   ring      `stages` stages, each rounded up to 128 bytes: K slab [bsp][hd]
//             and V slab [bsp][hd] of the page type (bsp = bs rounded up to
//             16; the pad rows of V are zeroed once), the slot's q [g][hd]
//             (first page of a chunk), int8: K and V scales [bsp] fp32
//   merge     each consumer warp's acc [g][hd] and (m, l) [g], then its
//             weight [g] and the item's 1 / l [g], fp32
//   slots     cstart [S + 1] (chunks before each slot), lens [S]
struct DecLayout {
  int bsp, slab, qoff, soff, stage, merge, slots, total;
  __host__ __device__ DecLayout(int S, int g, int hd, int bs, int esize, int qsize, bool int8,
                                int stages) {
    bsp = (bs + 15) / 16 * 16;
    slab = bsp * hd * esize;
    qoff = 2 * slab;
    soff = qoff + g * hd * qsize;
    stage = (soff + (int8 ? 8 * bsp : 0) + 127) / 128 * 128;
    merge = kDecHead + stages * stage;
    slots = merge + kDecW * g * (hd + 2) * 4 + (kDecW + 1) * g * 4;
    total = slots + (2 * S + 1) * 4;
  }
};

// a slot of kv_len `len`: its first visible key, first live page and live
// page count (pages wholly before the window are not live)
struct SlotSpan {
  int lo, first, n;
  __device__ __forceinline__ SlotSpan(int len, int bs, int MB, int window) {
    const int pages = min((len + bs - 1) / bs, MB);
    lo = window > 0 ? max(len - window, 0) : 0;
    first = lo / bs;
    n = max(pages - first, 0);
  }
};

// A slot's n live pages are cut into chunks of chunk_pages pages (the last
// one fewer): at least cmin, and at most kDecMaxChunks chunks a slot
__device__ __forceinline__ int chunk_pages(int n, int cmin) {
  return max(cmin, (n + kDecMaxChunks - 1) / kDecMaxChunks);
}
__device__ __forceinline__ int chunk_count(int n, int cmin) {
  const int c = chunk_pages(n, cmin);
  return (n + c - 1) / c;
}

// the four int8 codes of a word times one scale, in fp32
__device__ __forceinline__ void codes4(uint32_t w, float sc, float* v) {
  const uint32_t b = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(biased_code(b, j), sc);
}

// the same, rounded to T, as two packed pairs
template <typename T>
__device__ __forceinline__ void dequant4(uint32_t w, float sc, uint32_t& lo, uint32_t& hi) {
  float v[4];
  codes4(w, sc, v);
  lo = Mma<T>::pack(v[0], v[1]);
  hi = Mma<T>::pack(v[2], v[3]);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kDecW) : "memory");
}

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kDecThreads, HD == 256 ? 1 : 2) paged_decode_mma_kernel(
    const T* __restrict__ q, const P* __restrict__ kpool, const P* __restrict__ vpool,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int* __restrict__ block_table, const int* __restrict__ kv_lens,
    const float* __restrict__ slopes, T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ counters, int S, int nkv, int g, int bs,
    int MB, int nst, int cmin, float scale2, int window) {
  constexpr bool kInt8 = !std::is_same<T, P>::value;
  constexpr int ES = (int)sizeof(P);
  // K: a lane reads KE elements of a key row at a time (16 bytes, or a
  // quarter of the row), which feed KE/4 k16 steps; NJ reads cover the row
  constexpr int KE = 16 / ES < HD / 4 ? 16 / ES : HD / 4;
  constexpr int NJ = HD / (4 * KE);
  constexpr int KQ = KE / 2;  // q words a read's worth of k steps takes
  // V: a lane owns HV = HD/8 columns of O^T, read SW at a time (SW/2 m16
  // tiles of head_dim rows)
  constexpr int HV = HD / 8;
  constexpr int SW = HV < 8 ? HV : 8;
  constexpr int NM = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const DecLayout L(S, g, HD, bs, ES, (int)sizeof(T), kInt8, nst);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kDecMaxStages;
  int* recs = reinterpret_cast<int*>(smem + 256);           // [8][8]
  unsigned char* ring = smem + kDecHead;
  float* macc = reinterpret_cast<float*>(smem + L.merge);  // [W][g][HD]
  float* mml = macc + kDecW * g * HD;                       // [W][g][2]
  float* mwt = mml + kDecW * g * 2;                         // [W + 1][g]
  int* cstart = reinterpret_cast<int*>(smem + L.slots);    // [S + 1]
  int* lens = cstart + S + 1;                               // [S]
  int* work = counters;   // work items handed out past the first gridDim.x
  int* done = work + 1;   // blocks whose producer has run out of work
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], kInt8 ? 33 : 1);
      mbar_init(&empty[s], 32 * kDecW);
    }
    fence_mbar_init();
  }
  // V's pad rows (and their scales) are read with P = 0: zero them, as
  // 0 * garbage may be NaN
  if (L.bsp > bs) {
    const int pad = (L.bsp - bs) * HD * ES;
    for (int s = 0; s < nst; ++s) {
      unsigned char* v = ring + (size_t)s * L.stage + L.slab + (size_t)bs * HD * ES;
      for (int i = threadIdx.x; i < pad; i += kDecThreads) v[i] = 0;
      if constexpr (kInt8) {
        float* vs = reinterpret_cast<float*>(ring + (size_t)s * L.stage + L.soff) + L.bsp;
        for (int i = bs + threadIdx.x; i < L.bsp; i += kDecThreads) vs[i] = 0.f;
      }
    }
  }
  if (warp == 0) {  // chunks per slot and their running sum
    int carry = 0;
    for (int base = 0; base < S; base += 32) {
      const int s = base + lane;
      const int len = s < S ? kv_lens[s] : 0;
      int v = s < S ? chunk_count(SlotSpan(len, bs, MB, window).n, cmin) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (s < S) {
        cstart[s + 1] = carry + v;
        lens[s] = len;
      }
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) cstart[0] = 0;
  }
  __syncthreads();

  // work items: (chunk, kv head), the head varying fastest
  const int items = cstart[S] * nkv;
  if (warp == 0) {
    // ---- producer: item blockIdx.x first, then one from the counter at a
    // time (asked for while the current item streams), every page of an
    // item into the ring in order, with a record of what the stage holds
    int it = 0;
    for (int w = blockIdx.x; w < items;) {
      int wnext = 0;
      if (lane == 0) wnext = gridDim.x + atomicAdd(work, 1);
      const int h = w % nkv, lc = w / nkv;
      int s = 0;  // the slot of chunk lc: the last with cstart[s] <= lc
      for (int hi = S - 1; s < hi;) {
        const int mid = (s + hi + 1) / 2;
        if (cstart[mid] <= lc) s = mid; else hi = mid - 1;
      }
      const SlotSpan sp(lens[s], bs, MB, window);
      const int cp = chunk_pages(sp.n, cmin), c = lc - cstart[s];
      const int np = min(cp, sp.n - c * cp), nc = cstart[s + 1] - cstart[s];
      for (int j0 = 0; j0 < np; j0 += 32) {
        int lpage = 0;  // lane l reads the table entry of page j0 + l
        if (j0 + lane < np) lpage = block_table[(size_t)s * MB + sp.first + c * cp + j0 + lane];
        for (int j = j0; j < min(np, j0 + 32); ++j, ++it) {
          const int st = it % nst;
          const int page = __shfl_sync(0xffffffffu, lpage, j - j0);
          if (it >= nst) mbar_wait(&empty[st], (it / nst - 1) & 1);
          unsigned char* stg = ring + (size_t)st * L.stage;
          const size_t slab = ((size_t)page * nkv + h) * bs;
          if constexpr (kInt8) {
            float* ks = reinterpret_cast<float*>(stg + L.soff);
            for (int t = lane; t < bs; t += 32) {
              cp_async4(ks + t, kscale + slab + t);
              cp_async4(ks + L.bsp + t, vscale + slab + t);
            }
            cp_async_mbar_arrive(&full[st]);
          }
          if (lane == 0) {
            int* rec = recs + st * 8;
            rec[0] = s, rec[1] = h, rec[2] = c, rec[3] = j, rec[4] = np, rec[5] = nc, rec[6] = 0;
            const uint32_t bytes = (uint32_t)(bs * HD * ES);
            const uint32_t qbytes = (uint32_t)(g * HD * sizeof(T));
            mbar_expect_tx(&full[st], 2 * bytes + (j == 0 ? qbytes : 0));
            bulk_load(stg, kpool + slab * HD, bytes, &full[st]);
            bulk_load(stg + L.slab, vpool + slab * HD, bytes, &full[st]);
            if (j == 0)
              bulk_load(stg + L.qoff, q + ((size_t)s * nkv + h) * g * HD, qbytes, &full[st]);
          }
        }
      }
      w = __shfl_sync(0xffffffffu, wnext, 0);
    }
    // no more work: a record saying so; the last block out resets the
    // counters for the next launch
    const int st = it % nst;
    if (it >= nst) mbar_wait(&empty[st], (it / nst - 1) & 1);
    if constexpr (kInt8) cp_async_mbar_arrive(&full[st]);
    if (lane == 0) {
      recs[st * 8 + 6] = 1;
      mbar_arrive(&full[st]);
      if (atomicAdd(done, 1) == gridDim.x - 1) *work = 0, *done = 0;
    }
    return;
  }

  // ---- consumers
  const int cw = warp - 1, grp = lane / 4, tig = lane % 4;
  const int TP = L.bsp / 16;  // 16-key tiles a page
  float slope2 = 0.f;
  uint32_t qa[NJ][KQ];
  float acc[NM][4];
  float m = kNegInf, l = 0.f;
#pragma unroll
  for (int i = 0; i < NM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0;; ++it) {
    const int st = it % nst;
    mbar_wait(&full[st], (it / nst) & 1);
    const int* rec = recs + st * 8;
    if (rec[6]) break;
    const int s = rec[0], h = rec[1], c = rec[2], j = rec[3], np = rec[4], nc = rec[5];
    const int len = lens[s];
    const SlotSpan sp(len, bs, MB, window);
    const unsigned char* stg = ring + (size_t)st * L.stage;
    if (j == 0) {
      // the item's q rows, in the order K's reads take head_dim
      slope2 = slopes != nullptr && grp < g ? slopes[h * g + grp] * kLog2e : 0.f;
      const T* qs = reinterpret_cast<const T*>(stg + L.qoff) + grp * HD;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int w = 0; w < KQ; w += 4) {
          const uint4 v = grp < g ? *reinterpret_cast<const uint4*>(qs + 4 * KE * jj + KE * tig + 2 * w)
                                  : make_uint4(0u, 0u, 0u, 0u);
          qa[jj][w] = v.x, qa[jj][w + 1] = v.y, qa[jj][w + 2] = v.z, qa[jj][w + 3] = v.w;
        }
    }
    const P* kb = reinterpret_cast<const P*>(stg);
    const P* vb = reinterpret_cast<const P*>(stg + L.slab);
    const float* ksc = reinterpret_cast<const float*>(stg + L.soff);
    const float* vsc = ksc + L.bsp;
    // position of the page's key 0
    const int pos0 = (sp.first + c * chunk_pages(sp.n, cmin) + j) * bs;
    for (int t = 0; t < TP; ++t) {
      // tiles go to the warps by their place in the item: the same split
      // (and so the same bits) whichever block runs it
      if ((j * TP + t) % kDecW != cw) continue;
      const int kt = 16 * t;
      // ---- S = Q K^T: rows = the query group (padded to 16), n = keys
      float sacc[2][4];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        sacc[jn][0] = sacc[jn][1] = sacc[jn][2] = sacc[jn][3] = 0.f;
        const int r = kt + 8 * jn + grp;
        const P* kr = kb + (size_t)r * HD + KE * tig;
        float sc = 1.f;
        if constexpr (kInt8) sc = ksc[r];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          uint32_t w[KE * ES / 4];
          if constexpr (KE * ES == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(kr + 4 * KE * jj);
            w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
          } else {
            const uint2 v = *reinterpret_cast<const uint2*>(kr + 4 * KE * jj);
            w[0] = v.x, w[1] = v.y;
          }
#pragma unroll
          for (int ks = 0; ks < KE / 4; ++ks) {
            uint32_t b0, b1;
            if constexpr (kInt8) {
              dequant4<T>(w[ks], sc, b0, b1);
            } else {
              b0 = w[2 * ks], b1 = w[2 * ks + 1];
            }
            const uint32_t a[4] = {qa[jj][2 * ks], 0u, qa[jj][2 * ks + 1], 0u};
            Mma<T>::run(sacc[jn], a, b0, b1);
          }
        }
      }
      // ---- online softmax of row grp over this lane's four keys
      float x[2][2], mx = kNegInf;
      bool ok[2][2];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt + 8 * jn + 2 * tig + e, pos = pos0 + key;
          ok[jn][e] = key < bs && pos >= sp.lo && pos < len;
          x[jn][e] = ok[jn][e] ? sacc[jn][e] * scale2 + slope2 * (float)pos : kNegInf;
          mx = fmaxf(mx, x[jn][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m, mx);
      const float alpha = exp2f(m - mnew);
      float p[2][2];
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) p[jn][e] = ok[jn][e] ? exp2f(x[jn][e] - mnew) : 0.f;
      l = l * alpha + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
      m = mnew;
      // ---- O^T += V^T P^T: P^T's fragment is S's accumulator, rounded
      const uint32_t pb0 = Mma<T>::pack(p[0][0], p[0][1]);
      const uint32_t pb1 = Mma<T>::pack(p[1][0], p[1][1]);
      const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * tig);  // query 2 tig
      const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * tig + 4);
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        acc[i][0] *= a0, acc[i][1] *= a1, acc[i][2] *= a0, acc[i][3] *= a1;
      }
      const int r0 = kt + 2 * tig;  // value rows r0, r0+1, r0+8, r0+9
      const P* vr = vb + (size_t)r0 * HD + grp * HV;
      float vsr[4] = {1.f, 1.f, 1.f, 1.f};
      if constexpr (kInt8) {
        vsr[0] = vsc[r0], vsr[1] = vsc[r0 + 1], vsr[2] = vsc[r0 + 8], vsr[3] = vsc[r0 + 9];
      }
#pragma unroll
      for (int u2 = 0; u2 < HV / SW; ++u2) {
        // this lane's SW columns of the four value rows, as T pairs (lo,
        // hi) = (column 2i, 2i+1)
        uint32_t w[4][SW / 2];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const P* src = vr + (size_t)((rr & 1) + 8 * (rr >> 1)) * HD + u2 * SW;
          if constexpr (kInt8) {
            float f[SW];
            if constexpr (SW == 8) {
              const uint2 cv = *reinterpret_cast<const uint2*>(src);
              codes4(cv.x, vsr[rr], f);
              codes4(cv.y, vsr[rr], f + 4);
            } else {
              codes4(*reinterpret_cast<const uint32_t*>(src), vsr[rr], f);
            }
#pragma unroll
            for (int i = 0; i < SW / 2; ++i) w[rr][i] = Mma<T>::pack(f[2 * i], f[2 * i + 1]);
          } else if constexpr (SW == 8) {
            const uint4 cv = *reinterpret_cast<const uint4*>(src);
            w[rr][0] = cv.x, w[rr][1] = cv.y, w[rr][2] = cv.z, w[rr][3] = cv.w;
          } else {
            const uint2 cv = *reinterpret_cast<const uint2*>(src);
            w[rr][0] = cv.x, w[rr][1] = cv.y;
          }
        }
#pragma unroll
        for (int i = 0; i < SW / 2; ++i) {
          // rows grp / grp+8 of m-tile u2*SW/2+i are head_dim columns
          // grp*HV + u2*SW + 2i and +1; k = keys r0, r0+1 | r0+8, r0+9
          const uint32_t a[4] = {__byte_perm(w[0][i], w[1][i], 0x5410),
                                 __byte_perm(w[0][i], w[1][i], 0x7632),
                                 __byte_perm(w[2][i], w[3][i], 0x5410),
                                 __byte_perm(w[2][i], w[3][i], 0x7632)};
          Mma<T>::run(acc[u2 * (SW / 2) + i], a, pb0, pb1);
        }
      }
    }
    mbar_arrive(&empty[st]);
    if (j + 1 < np) continue;

    // ---- end of an item: merge the warps in warp order, then store or
    // hand over
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (tig == 0 && grp < g) {
      mml[(cw * g + grp) * 2] = m;
      mml[(cw * g + grp) * 2 + 1] = l;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qq = 2 * tig + e;
      if (qq >= g) continue;
      float* dst = macc + (cw * g + qq) * HD + grp * HV;
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        dst[2 * i] = acc[i][e];
        dst[2 * i + 1] = acc[i][2 + e];
      }
    }
    m = kNegInf, l = 0.f;
#pragma unroll
    for (int i = 0; i < NM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    consumer_sync();
    // each warp's weight per query (and the item's max and sum), once
    const bool whole = nc == 1;
    const size_t prow = (((size_t)h * S + s) * kDecMaxChunks + c) * g;
    if (threadIdx.x - 32 < g) {
      const int qq = threadIdx.x - 32;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kDecW; ++w) M = fmaxf(M, mml[(w * g + qq) * 2]);
      float Ls = 0.f;
#pragma unroll
      for (int w = 0; w < kDecW; ++w) {
        const float wt = exp2f(mml[(w * g + qq) * 2] - M);
        Ls += mml[(w * g + qq) * 2 + 1] * wt;
        mwt[w * g + qq] = wt;
      }
      mwt[kDecW * g + qq] = whole ? (Ls > 0.f ? 1.f / Ls : 0.f) : 1.f;
      if (!whole) part_ml[(prow + qq) * 2] = M, part_ml[(prow + qq) * 2 + 1] = Ls;
    }
    consumer_sync();
    T* orow = out + ((size_t)s * nkv + h) * g * HD;
    for (int e = 4 * (threadIdx.x - 32); e < g * HD; e += 4 * 32 * kDecW) {
      const int qq = e / HD, d = e % HD;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kDecW; ++w) {
        const float4 a = *reinterpret_cast<const float4*>(macc + (w * g + qq) * HD + d);
        const float wt = mwt[w * g + qq];
        o[0] += a.x * wt, o[1] += a.y * wt, o[2] += a.z * wt, o[3] += a.w * wt;
      }
      if (whole) {
        const float inv = mwt[kDecW * g + qq];
        store4<T>(orow + e, {o[0] * inv, o[1] * inv, o[2] * inv, o[3] * inv});
      } else {
        *reinterpret_cast<float4*>(part_acc + (prow + qq) * HD + d) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    consumer_sync();  // the merge buffers are rewritten by the next item
  }
}

// The chunks of a slot that took more than one item, merged in chunk order
// (the logsumexp combine of the TPU epilogue, paged_attention.py :425-431),
// and zeros for a slot with no live key; a slot that was one item was
// written by the decode.  One block per (slot, kv head), a thread per four
// output columns: every chunk's partial row is read once, side by side.
template <typename T, int HD>
__global__ void __launch_bounds__(128, 1) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ kv_lens, T* __restrict__ out, int S, int nkv, int g, int bs, int MB,
    int cmin, int window) {
  const int s = blockIdx.x / nkv, h = blockIdx.x % nkv;
  const int nc = chunk_count(SlotSpan(kv_lens[s], bs, MB, window).n, cmin);
  if (nc == 1) return;
  T* orow = out + ((size_t)s * nkv + h) * g * HD;
  const size_t p0 = ((size_t)h * S + s) * kDecMaxChunks * g;
  for (int e = 4 * threadIdx.x; e < g * HD; e += 4 * blockDim.x) {
    const int qq = e / HD, d = e % HD;
    float M = kNegInf;
    for (int c = 0; c < nc; ++c) M = fmaxf(M, part_ml[(p0 + c * g + qq) * 2]);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float Ls = 0.f;
    for (int c = 0; c < nc; ++c) {
      const size_t r = p0 + c * g + qq;
      const float wt = exp2f(part_ml[r * 2] - M);
      const float4 a = *reinterpret_cast<const float4*>(part_acc + r * HD + d);
      o.x += a.x * wt, o.y += a.y * wt, o.z += a.z * wt, o.w += a.w * wt;
      Ls += part_ml[r * 2 + 1] * wt;
    }
    const float inv = Ls > 0.f ? 1.f / Ls : 0.f;
    store4<T>(orow + e, {o.x * inv, o.y * inv, o.z * inv, o.w * inv});
  }
}

// fp32 q: the CUDA-core kernel, NS splits a slot merged by split_combine
template <typename P, int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const float* ks,
                        const float* vs, const int* bt, const int* lens, const float* slopes,
                        void* out, float* part_acc, float* part_ml, int S, int nkv, int g, int bs,
                        int MB, int NS, float scale, int window, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)bs * HD * sizeof(P) +
                      (std::is_same<float, P>::value ? 0 : 4 * (size_t)bs * sizeof(float));
  auto kern = paged_decode_kernel<float, P, HD>;
  cudaError_t err = allow_dynamic_smem<paged_decode_kernel<float, P, HD>>();
  if (err != cudaSuccess) return err;
  kern<<<dim3(S, nkv, NS), g * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const P*>(k), static_cast<const P*>(v), ks, vs,
      bt, lens, slopes, static_cast<float*>(out), part_acc, part_ml, nkv, g, bs, MB, NS, scale,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS == 1) return err;
  split_combine_kernel<float><<<S * nkv * g, HD, (NS + 1) * sizeof(float), stream>>>(
      part_acc, part_ml, static_cast<float*>(out), g, HD, NS);
  return cudaGetLastError();
}

// 16-bit q: the tensor-core kernel, a persistent grid of NB blocks, a ring
// of nst stages, chunks of at least cmin pages (decode_plan)
template <typename T, typename P, int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* ks,
                       const float* vs, const int* bt, const int* lens, const float* slopes,
                       void* out, float* part_acc, float* part_ml, int* counters, int S, int nkv,
                       int g, int bs, int MB, int NB, int nst, int cmin, float scale, int window,
                       cudaStream_t stream) {
  if (nst < 1 || nst > kDecMaxStages || cmin < 1 || counters == nullptr ||
      part_acc == nullptr || part_ml == nullptr)
    return cudaErrorInvalidValue;
  const DecLayout lay(S, g, HD, bs, (int)sizeof(P), (int)sizeof(T), !std::is_same<T, P>::value,
                      nst);
  cudaError_t err = allow_dynamic_smem<paged_decode_mma_kernel<T, P, HD>>();
  if (err != cudaSuccess) return err;
  paged_decode_mma_kernel<T, P, HD><<<NB, kDecThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k), static_cast<const P*>(v), ks, vs, bt,
      lens, slopes, static_cast<T*>(out), part_acc, part_ml, counters, S, nkv, g, bs, MB, nst,
      cmin, scale * kLog2e, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, HD><<<S * nkv, 128, 0, stream>>>(
      part_acc, part_ml, lens, static_cast<T*>(out), S, nkv, g, bs, MB, cmin, window);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* bt, const int* lens, const float* slopes,
                      void* out, float* pa, float* pm, int* cnt, int S, int nkv, int g, int bs,
                      int MB, int NS, int nst, int cmin, float scale, int window,
                      cudaStream_t st) {
#define DSK_DECODE(HD)                                                                       \
  if constexpr (std::is_same<T, float>::value)                                               \
    return launch_simt<P, HD>(q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, S, nkv, g, bs, \
                              MB, NS, scale, window, st);                                    \
  else                                                                                       \
    return launch_mma<T, P, HD>(q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, cnt, S, nkv, \
                                g, bs, MB, NS, nst, cmin, scale, window, st);
  switch (hd) {
    case 32: DSK_DECODE(32)
    case 64: DSK_DECODE(64)
    case 128: DSK_DECODE(128)
    case 256: DSK_DECODE(256)
    default: return cudaErrorInvalidValue;
  }
#undef DSK_DECODE
}

// int8 pages (quant != 0) or pages of q's type
template <typename T>
cudaError_t launch_pages(int quant, int hd, const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* bt, const int* lens,
                         const float* slopes, void* out, float* pa, float* pm, int* cnt, int S,
                         int nkv, int g, int bs, int MB, int NS, int nst, int cmin, float scale,
                         int window, cudaStream_t st) {
  if (quant)
    return launch_hd<T, int8_t>(hd, q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, cnt, S, nkv, g, bs, MB, NS, nst, cmin, scale, window, st);
  return launch_hd<T, T>(hd, q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, cnt, S, nkv, g, bs, MB, NS, nst, cmin, scale, window, st);
}

}  // namespace dsk

// q [S, nkv, g, hd]; k_pages/v_pages [NB, nkv, bs, hd] of q's type, or
// int8 (quant != 0) with k_scale/v_scale [NB, nkv, bs] fp32; block_table
// [S, MB] int32; kv_lens [S] int32; slopes [nkv*g] fp32 or null; out [S, nkv,
// g, hd].  dtype (of q): 0 fp32, 1 fp16, 2 bf16.  window <= 0: none.
// fp32 q: NS splits a slot; part_acc [S, nkv, NS, g, hd] and part_ml [S,
// nkv, NS, g, 2] fp32 scratch (unused when NS == 1); stages, chunk and
// counters unused.  16-bit q: NS blocks, a ring of `stages` (1-8), chunks
// of at least `chunk` pages; part_acc [nkv, S, 16, g, hd] and part_ml [nkv,
// S, 16, g, 2] fp32 scratch; counters [2] int32 (the work items handed
// out, the blocks done), zero on entry and left zero.
extern "C" int ds_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scale, const void* v_scale,
                                  const void* block_table, const void* kv_lens,
                                  const void* slopes, void* out, void* part_acc,
                                  void* part_ml, void* counters, int S, int nkv, int g, int hd,
                                  int bs, int MB, int NS, int stages, int chunk, float scale,
                                  int window, int dtype, int quant, void* stream) {
  if (g < 1 || g > 8 || NS < 1 || bs < 1) return (int)cudaErrorInvalidValue;
  if (S == 0 || nkv == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto bt = static_cast<const int*>(block_table);
  auto lens = static_cast<const int*>(kv_lens);
  auto sl = static_cast<const float*>(slopes);
  auto pa = static_cast<float*>(part_acc);
  auto pm = static_cast<float*>(part_ml);
  auto cnt = static_cast<int*>(counters);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dsk::launch_pages<float>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, sl, out, pa, pm, cnt, S, nkv, g, bs, MB, NS, stages, chunk, scale, window, st); break;
    case 1: err = dsk::launch_pages<__half>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, sl, out, pa, pm, cnt, S, nkv, g, bs, MB, NS, stages, chunk, scale, window, st); break;
    case 2: err = dsk::launch_pages<__nv_bfloat16>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, sl, out, pa, pm, cnt, S, nkv, g, bs, MB, NS, stages, chunk, scale, window, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
