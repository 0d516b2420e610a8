// Ragged chunked-prefill attention over the paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py:
// _prefill_kernel (launched by _pallas_ragged_prefill_local).  Mixed
// prefill/decode batches arrive dense per slot: q [S, Q, nkv, g, hd], where
// slot s owns q_counts[s] live rows at the contiguous positions
// [q_starts[s], q_starts[s] + q_counts[s]) and its KV (the rows just
// appended included) lives in kv_lens[s] tokens across its block-table
// pages.  Each live row attends causally (kvpos <= qpos, kvpos < kv_len,
// optional sliding window, optional alibi); dead rows come out as zeros.
//
// What bounds it on the H100: at prefill sizes, arithmetic (4*hd FLOPs per
// visible (query head, key) pair) more than the bytes, which are each
// visible page read once per (slot, kv head, q-chunk).  bf16/fp16 pages run
// the arithmetic on the tensor cores (mma.sync m16n8k16, fp32 accumulate —
// ragged_prefill_mma_kernel); fp32 pages, head_dim 256 and pages of a
// size not divisible by 16 take the CUDA-core version (ragged_prefill_kernel).
// wgmma, TMA and warp specialisation are later work.  What the design does:
//   - one thread block per (slot, kv head, q-chunk).  The TPU sized the
//     chunk for VMEM (largest power of two <= 128 dividing Q); here a chunk
//     is cq = 64 / g query tokens so its cq*g query-head rows make a 64-row
//     tile (16 tokens x 4 heads for Llama-3-8B), any Q accepted, ragged tail
//     masked.  A dead chunk (row0 >= q_counts[s]) writes zeros and exits.
//   - the page loop runs from the window's first page to the page of the
//     chunk's last live row only: FLOPs and bytes scale with live tokens,
//     not with S x longest.  K/V (page, head) slabs stream into shared
//     memory with 16-byte cp.async, double-buffered; each K/V page is read
//     from HBM once per block and then served to all 64 rows from shared
//     memory.
//   - CUDA-core version: 8 warps x 8 rows; lanes split head_dim, warp
//     reductions give the fp32 scores and each row keeps its own online
//     softmax (m, l, acc) in registers; rows that cannot see a key skip it
//     (masking without -inf).  Tensor-core version: see below.
//   - int8 pages (kv_quant, the TPU kernel's quant=True): the copied slab
//     is the int8 codes plus the page's [bs] fp32 scale rows of K and V,
//     dequantized as the TPU kernel's _dequant_page (code * scale rounded
//     once to q's dtype) — in registers as rows are read (CUDA-core), or by
//     the whole block into the padded 16-bit K/V tiles the B fragments read
//     (tensor cores), while the next page's codes stream in.
#include "paged_common.cuh"

namespace dsk {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;  // 64 query-head rows per block

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kWarps * 32) ragged_prefill_kernel(
    const T* __restrict__ q, const P* __restrict__ kpool, const P* __restrict__ vpool,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int* __restrict__ block_table, const int* __restrict__ kv_lens,
    const int* __restrict__ q_starts, const int* __restrict__ q_counts,
    const float* __restrict__ slopes, T* __restrict__ out, int Q, int nkv, int g, int cq,
    int bs, int MB, float scale, int window) {
  constexpr int VEC = HD / 32;
  constexpr int RPW = kRowsPerWarp;
  constexpr bool kInt8 = !std::is_same<T, P>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int page_elems = bs * HD;
  P* kbuf = reinterpret_cast<P*>(smem);  // [2][bs*HD]
  P* vbuf = kbuf + 2 * page_elems;       // [2][bs*HD]
  float* ksc = reinterpret_cast<float*>(vbuf + 2 * page_elems);  // int8: [2][bs]
  float* vsc = ksc + 2 * bs;                                     // int8: [2][bs]

  const int s = blockIdx.x, h = blockIdx.y, c = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int count = q_counts[s], start = q_starts[s], length = kv_lens[s];
  const int row0 = c * cq;           // first query token of the chunk
  const int R = cq * g;              // query-head rows of the chunk

  // rows r = warp*RPW + i; row r is query token row0 + r/g, head r%g
  int qi[RPW], qpos[RPW], gi[RPW];
  bool exists[RPW], live[RPW];
  int warp_max_pos = -1;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    gi[i] = r % g;
    qi[i] = row0 + r / g;
    exists[i] = r < R && qi[i] < Q;
    live[i] = exists[i] && qi[i] < count;
    qpos[i] = start + qi[i];
    if (live[i]) warp_max_pos = max(warp_max_pos, qpos[i]);
  }

  float qr[RPW][VEC];
  float slope[RPW];
  RowState<VEC> st[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    st[i].init();
    slope[i] = slopes != nullptr ? slopes[h * g + gi[i]] : 0.f;
    if (live[i]) {
      load_vec<T, VEC>(q + ((((size_t)s * Q + qi[i]) * nkv + h) * g + gi[i]) * HD + lane * VEC,
                       qr[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) qr[i][j] = 0.f;
    }
  }

  int n = 0, p_start = 0;
  if (row0 < count) {
    // pages the chunk can causally see: up to its last live row's position
    const int last_pos = start + min(count, row0 + cq) - 1;
    const int page_end = (min(last_pos + 1, length) + bs - 1) / bs;
    // the chunk's first row's window start bounds every row's from below
    p_start = window > 0 ? max(start + row0 - window + 1, 0) / bs : 0;
    n = max(page_end - p_start, 0);
  }
  const int* bt = block_table + (size_t)s * MB;

  auto fetch = [&](int buf, int page) {
    if constexpr (kInt8) load_scales(ksc + buf * bs, vsc + buf * bs, kscale, vscale, page, h, nkv, bs);
    load_page(kbuf + buf * page_elems, vbuf + buf * page_elems, kpool, vpool, page, h, nkv,
              page_elems);
  };
  if (n > 0) fetch(0, bt[p_start]);
  for (int it = 0; it < n; ++it) {
    const int p = p_start + it;
    const int b = it & 1;
    if (it + 1 < n) {
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
    const int t1 = min(min(bs, length - p * bs), warp_max_pos + 1 - p * bs);
    for (int t = 0; t < t1; ++t) {
      const int kvpos = p * bs + t;
      float kr[VEC], vr[VEC], d[RPW];
      load_kv<T, P, VEC>(kb + t * HD + lane * VEC, kInt8 ? ks[t] : 1.f, kr);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) a += qr[i][j] * kr[j];
        d[i] = a;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) d[i] += __shfl_xor_sync(0xffffffffu, d[i], o);
      }
      load_kv<T, P, VEC>(vb + t * HD + lane * VEC, kInt8 ? vs[t] : 1.f, vr);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const bool valid = live[i] && kvpos <= qpos[i] &&
                           (window <= 0 || kvpos > qpos[i] - window);
        if (valid) st[i].template update<T>(d[i] * scale + slope[i] * (float)kvpos, vr);
      }
    }
    __syncthreads();  // buffer b is refilled by the next iteration's copy
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!exists[i]) continue;
    const float inv = 1.f / (st[i].l == 0.f ? 1.f : st[i].l);  // dead rows -> 0
    store_vec<T, VEC>(
        out + ((((size_t)s * Q + qi[i]) * nkv + h) * g + gi[i]) * HD + lane * VEC, st[i].acc,
        inv);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core variant for 16-bit pages (bf16/fp16; bs % 16 == 0, hd <= 128):
// the same block and page walk, with S = Q·Kᵀ and O += P·V on mma.sync
// m16n8k16 tiles (fp32 accumulate).  4 warps x 16 query-head rows; each warp
// holds its Q rows as A fragments for the whole block and walks the page in
// 16-token sub-tiles: two 16x8 score tiles, a masked online softmax on them
// (row max/sum over the 4 lanes sharing a row), then P (rounded to the page
// dtype — the TPU kernel's pr.astype(v.dtype)) times V on head_dim/8 output
// tiles.  K/V rows sit in shared memory with an 8-element pad so the B
// fragment loads are bank-conflict free.

constexpr int kMmaWarps = 4;

template <typename T, int HD>
__device__ __forceinline__ void load_page_padded(T* kdst, T* vdst, const T* __restrict__ kpool,
                                                 const T* __restrict__ vpool, int page, int h,
                                                 int nkv, int bs) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  const size_t base = ((size_t)page * nkv + h) * (size_t)bs * HD;
  const T* ks = kpool + base;
  const T* vs = vpool + base;
  for (int c = threadIdx.x; c < bs * CPR; c += blockDim.x) {
    const int row = c / CPR, cc = c % CPR;
    cp_async16(reinterpret_cast<char*>(kdst + row * LD) + 16 * cc,
               reinterpret_cast<const char*>(ks + row * HD) + 16 * cc);
    cp_async16(reinterpret_cast<char*>(vdst + row * LD) + 16 * cc,
               reinterpret_cast<const char*>(vs + row * HD) + 16 * cc);
  }
  cp_async_commit();
}

// int8 pages: the block dequantizes one staged page (codes [bs][HD] and the
// [bs] scale rows) into the padded 16-bit K/V tiles, four values a step.
template <typename T, int HD>
__device__ __forceinline__ void dequant_page_padded(const int8_t* k8, const int8_t* v8,
                                                    const float* ks, const float* vs, T* kt,
                                                    T* vt, int bs) {
  constexpr int LD = HD + 8;
  constexpr int Q4 = HD / 4;
  for (int i = threadIdx.x; i < bs * Q4; i += blockDim.x) {
    const int t = i / Q4, d = (i % Q4) * 4;
    const char4 kc = *reinterpret_cast<const char4*>(k8 + t * HD + d);
    const char4 vc = *reinterpret_cast<const char4*>(v8 + t * HD + d);
    const float a = ks[t], b = vs[t];
    const float kf[4] = {(float)kc.x * a, (float)kc.y * a, (float)kc.z * a, (float)kc.w * a};
    const float vf[4] = {(float)vc.x * b, (float)vc.y * b, (float)vc.z * b, (float)vc.w * b};
    store4<T>(kt + t * LD + d, kf);
    store4<T>(vt + t * LD + d, vf);
  }
}

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kMmaWarps * 32) ragged_prefill_mma_kernel(
    const T* __restrict__ q, const P* __restrict__ kpool, const P* __restrict__ vpool,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int* __restrict__ block_table, const int* __restrict__ kv_lens,
    const int* __restrict__ q_starts, const int* __restrict__ q_counts,
    const float* __restrict__ slopes, T* __restrict__ out, int Q, int nkv, int g, int cq,
    int bs, int MB, float scale, int window) {
  constexpr int KSTEPS = HD / 16;  // k-steps of S = Q·Kᵀ over head_dim
  constexpr int DTILES = HD / 8;   // 8-wide output tiles over head_dim
  constexpr int LD = HD + 8;       // padded shared-memory row (elements)
  constexpr bool kInt8 = !std::is_same<T, P>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  // 16-bit pages: [2][bs*LD] K and V tiles, filled by cp.async.  int8
  // pages: [2][bs*HD] staged codes of K and V, [2][bs] scales of each, then
  // one [bs*LD] dequantized K and V tile.
  T* kbuf = reinterpret_cast<T*>(smem);
  T* vbuf = kbuf + 2 * bs * LD;
  int8_t* k8 = reinterpret_cast<int8_t*>(smem);
  int8_t* v8 = k8 + 2 * bs * HD;
  float* ksc = reinterpret_cast<float*>(v8 + 2 * bs * HD);
  float* vsc = ksc + 2 * bs;
  T* kt = reinterpret_cast<T*>(vsc + 2 * bs);
  T* vt = kt + bs * LD;

  const int s = blockIdx.x, h = blockIdx.y, c = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int count = q_counts[s], start = q_starts[s], length = kv_lens[s];
  const int row0 = c * cq;
  const int R = cq * g;

  // this lane's two rows: grp and grp+8 of the warp's 16
  int qi[2], qpos[2];
  bool exists[2], live[2];
  float slope[2];
  const T* qrow[2];
  T* orow[2];
  int my_max = -1, my_min = 1 << 30;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + grp + 8 * i;
    const int gi = r % g;
    qi[i] = row0 + r / g;
    exists[i] = r < R && qi[i] < Q;
    live[i] = exists[i] && qi[i] < count;
    qpos[i] = start + qi[i];
    slope[i] = slopes != nullptr ? slopes[h * g + gi] : 0.f;
    const size_t off = ((((size_t)s * Q + qi[i]) * nkv + h) * g + gi) * HD;
    qrow[i] = q + off;
    orow[i] = out + off;
    if (live[i]) {
      my_max = max(my_max, qpos[i]);
      my_min = min(my_min, qpos[i]);
    }
  }
  const int warp_max = __reduce_max_sync(0xffffffffu, my_max);
  const int warp_min = __reduce_min_sync(0xffffffffu, my_min);

  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;                       // a0/a2: row grp, a1/a3: grp+8
      const int col = ks * 16 + 2 * tig + 8 * (j >> 1);
      qa[ks][j] = live[i] ? *reinterpret_cast<const uint32_t*>(qrow[i] + col) : 0u;
    }
  }
  float acc[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[d][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int n = 0, p_start = 0;
  if (row0 < count) {
    const int last_pos = start + min(count, row0 + cq) - 1;
    const int page_end = (min(last_pos + 1, length) + bs - 1) / bs;
    p_start = window > 0 ? max(start + row0 - window + 1, 0) / bs : 0;
    n = max(page_end - p_start, 0);
  }
  const int* bt = block_table + (size_t)s * MB;

  auto fetch = [&](int buf, int page) {
    if constexpr (kInt8) {
      load_scales(ksc + buf * bs, vsc + buf * bs, kscale, vscale, page, h, nkv, bs);
      load_page(k8 + buf * bs * HD, v8 + buf * bs * HD, kpool, vpool, page, h, nkv, bs * HD);
    } else {
      load_page_padded<T, HD>(kbuf + buf * bs * LD, vbuf + buf * bs * LD, kpool, vpool, page,
                              h, nkv, bs);
    }
  };
  if (n > 0) fetch(0, bt[p_start]);
  for (int it = 0; it < n; ++it) {
    const int p = p_start + it;
    const int b = it & 1;
    if (it + 1 < n) {
      fetch(b ^ 1, bt[p + 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = kbuf + b * bs * LD;
    const T* vb = vbuf + b * bs * LD;
    if constexpr (kInt8) {
      // the previous page's tiles were last read before the loop's closing
      // barrier; staging buffer b^1 was last read before the barrier below
      dequant_page_padded<T, HD>(k8 + b * bs * HD, v8 + b * bs * HD, ksc + b * bs,
                                 vsc + b * bs, kt, vt, bs);
      __syncthreads();
      kb = kt;
      vb = vt;
    }
    const unsigned short* vraw = reinterpret_cast<const unsigned short*>(vb);
    for (int t0 = 0; t0 < bs; t0 += 16) {
      const int kv0 = p * bs + t0;
      if (kv0 > warp_max || kv0 >= length) break;             // causal / length end
      if (window > 0 && kv0 + 15 <= warp_min - window) continue;  // before the window
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
        const T* krow = kb + (t0 + nt * 8 + grp) * LD + 2 * tig;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8);
          Mma<T>::run(sc[nt], qa[ks], b0, b1);
        }
      }
      // scale, alibi, mask; row max over the 4 lanes of each row
      float mx[2] = {kNegInf, kNegInf};
      bool ok[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const int kvpos = kv0 + nt * 8 + 2 * tig + (j & 1);
          ok[nt][j] = live[i] && kvpos <= qpos[i] && kvpos < length &&
                      (window <= 0 || kvpos > qpos[i] - window);
          sc[nt][j] = sc[nt][j] * scale + slope[i] * (float)kvpos;
          if (ok[nt][j]) mx[i] = fmaxf(mx[i], sc[nt][j]);
        }
      }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mnew = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - mnew);   // 0 when m was empty, 1 when unchanged
        m[i] = mnew;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          sc[nt][j] = ok[nt][j] ? expf(sc[nt][j] - m[i]) : 0.f;
          psum[i] += sc[nt][j];
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
      const unsigned short* v0 = vraw + (t0 + 2 * tig) * LD + grp;
#pragma unroll
      for (int d = 0; d < DTILES; ++d) {
        const unsigned short* vc = v0 + d * 8;
        const uint32_t b0 = (uint32_t)vc[0] | ((uint32_t)vc[LD] << 16);
        const uint32_t b1 = (uint32_t)vc[8 * LD] | ((uint32_t)vc[9 * LD] << 16);
        Mma<T>::run(acc[d], pa, b0, b1);
      }
    }
    __syncthreads();  // buffer b is refilled by the next iteration's copy
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!exists[i]) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);  // dead rows -> 0
#pragma unroll
    for (int d = 0; d < DTILES; ++d)
      *reinterpret_cast<uint32_t*>(orow[i] + d * 8 + 2 * tig) =
          Mma<T>::pack(acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
  }
}

template <typename T, typename P, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* bt, const int* lens, const int* starts,
                   const int* counts, const float* slopes, void* out, int S, int Q, int nkv,
                   int g, int cq, int bs, int MB, float scale, int window, cudaStream_t stream) {
  constexpr bool kInt8 = !std::is_same<T, P>::value;
  const int chunks = (Q + cq - 1) / cq;
  const dim3 grid(S, nkv, chunks);
  if constexpr (sizeof(T) == 2 && HD <= 128) {
    if (bs % 16 == 0) {  // tensor-core tiles
      const size_t smem = kInt8 ? 4 * (size_t)bs * HD + 16 * (size_t)bs +
                                      2 * (size_t)bs * (HD + 8) * sizeof(T)
                                : 4 * (size_t)bs * (HD + 8) * sizeof(T);
      cudaError_t err = allow_dynamic_smem<ragged_prefill_mma_kernel<T, P, HD>>();
      if (err != cudaSuccess) return err;
      ragged_prefill_mma_kernel<T, P, HD><<<grid, kMmaWarps * 32, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const P*>(k), static_cast<const P*>(v), ks, vs,
          bt, lens, starts, counts, slopes, static_cast<T*>(out), Q, nkv, g, cq, bs, MB, scale,
          window);
      return cudaGetLastError();
    }
  }
  const size_t smem = 4 * (size_t)bs * HD * sizeof(P) + (kInt8 ? 16 * (size_t)bs : 0);
  cudaError_t err = allow_dynamic_smem<ragged_prefill_kernel<T, P, HD>>();
  if (err != cudaSuccess) return err;
  ragged_prefill_kernel<T, P, HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k), static_cast<const P*>(v), ks, vs, bt,
      lens, starts, counts, slopes, static_cast<T*>(out), Q, nkv, g, cq, bs, MB, scale, window);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* bt, const int* lens, const int* starts,
                      const int* counts, const float* slopes, void* out, int S, int Q, int nkv,
                      int g, int cq, int bs, int MB, float scale, int window, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, P, 32>(q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
    case 64: return launch<T, P, 64>(q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
    case 128: return launch<T, P, 128>(q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
    case 256: return launch<T, P, 256>(q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
    default: return cudaErrorInvalidValue;
  }
}

// int8 pages (quant != 0) or pages of q's type
template <typename T>
cudaError_t launch_pages(int quant, int hd, const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* bt, const int* lens,
                         const int* starts, const int* counts, const float* slopes, void* out,
                         int S, int Q, int nkv, int g, int cq, int bs, int MB, float scale,
                         int window, cudaStream_t st) {
  if (quant)
    return launch_hd<T, int8_t>(hd, q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
  return launch_hd<T, T>(hd, q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
}

}  // namespace dsk

// q [S, Q, nkv, g, hd]; k_pages/v_pages [NB, nkv, bs, hd] of q's type, or
// int8 (quant != 0) with k_scale/v_scale [NB, nkv, bs] fp32; block_table
// [S, MB] int32; kv_lens, q_starts, q_counts [S] int32; slopes [nkv*g] fp32
// or null; out [S, Q, nkv, g, hd].  cq: query tokens per block, cq*g <= 64.
// dtype (of q): 0 fp32, 1 fp16, 2 bf16.  window <= 0: none.
extern "C" int ds_ragged_prefill(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scale, const void* v_scale,
                                 const void* block_table, const void* kv_lens,
                                 const void* q_starts, const void* q_counts,
                                 const void* slopes, void* out, int S, int Q, int nkv, int g,
                                 int hd, int bs, int MB, int cq, float scale, int window,
                                 int dtype, int quant, void* stream) {
  if (g < 1 || cq < 1 || cq * g > dsk::kWarps * dsk::kRowsPerWarp || bs < 1)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || Q == 0 || nkv == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto bt = static_cast<const int*>(block_table);
  auto lens = static_cast<const int*>(kv_lens);
  auto starts = static_cast<const int*>(q_starts);
  auto counts = static_cast<const int*>(q_counts);
  auto sl = static_cast<const float*>(slopes);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dsk::launch_pages<float>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    case 1: err = dsk::launch_pages<__half>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    case 2: err = dsk::launch_pages<__nv_bfloat16>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
