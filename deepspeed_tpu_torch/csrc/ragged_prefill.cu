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
// Two kernels, the route a rule of the call's shapes (route 1 below; the
// wrapper's prefill_route):
//   - 16-bit q with pages of its type or int8, head dims 32 / 64 / 128,
//     pages of a multiple of 16 tokens up to 256: prefill_wgmma_kernel, the
//     persistent warp-specialised TMA + wgmma kernel of prefill_hopper.cuh
//     (its design there), and prefill_combine_kernel for split walks;
//   - everything else (fp32, head dim 256, other pages):
//     ragged_prefill_kernel below, on the CUDA cores.  One thread block per
//     (slot, kv head, q-chunk) of cq = 64 / g query tokens (a dead chunk
//     writes zeros and exits); the page loop runs from the window's first
//     page to the page of the chunk's last live row only, the K/V (page,
//     head) slabs double-buffered by 16-byte cp.async; 8 warps x 8 rows,
//     lanes split head_dim, warp reductions give the fp32 scores and each
//     row keeps its own online softmax (m, l, acc) in registers; rows that
//     cannot see a key skip it (masking without -inf).  int8 pages
//     (kv_quant, the TPU kernel's quant=True): the copied slab is the int8
//     codes plus the page's [bs] fp32 scale rows of K and V, dequantized in
//     registers as rows are read, as the TPU kernel's _dequant_page (code *
//     scale rounded once to q's dtype).
//
// What bounds it on the H100: at the main path's mixed steps, bytes (the
// visible K and V, q and the dense output); at long prefills, the
// arithmetic (4*hd FLOPs per visible (query head, key) pair).
#include "prefill_hopper.cuh"

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

template <typename T, typename P, int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const float* ks,
                        const float* vs, const int* bt, const int* lens, const int* starts,
                        const int* counts, const float* slopes, void* out, int S, int Q, int nkv,
                        int g, int cq, int bs, int MB, float scale, int window,
                        cudaStream_t stream) {
  constexpr bool kInt8 = !std::is_same<T, P>::value;
  const int chunks = (Q + cq - 1) / cq;
  const size_t smem = 4 * (size_t)bs * HD * sizeof(P) + (kInt8 ? 16 * (size_t)bs : 0);
  cudaError_t err = allow_dynamic_smem<ragged_prefill_kernel<T, P, HD>>();
  if (err != cudaSuccess) return err;
  ragged_prefill_kernel<T, P, HD><<<dim3(S, nkv, chunks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k), static_cast<const P*>(v), ks, vs, bt,
      lens, starts, counts, slopes, static_cast<T*>(out), Q, nkv, g, cq, bs, MB, scale, window);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_simt_hd(int hd, const void* q, const void* k, const void* v,
                           const float* ks, const float* vs, const int* bt, const int* lens,
                           const int* starts, const int* counts, const float* slopes, void* out,
                           int S, int Q, int nkv, int g, int cq, int bs, int MB, float scale,
                           int window, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_simt<T, P, 32>(q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
    case 64: return launch_simt<T, P, 64>(q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
    case 128: return launch_simt<T, P, 128>(q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
    case 256: return launch_simt<T, P, 256>(q, k, v, ks, vs, bt, lens, starts, counts, slopes, out, S, Q, nkv, g, cq, bs, MB, scale, window, st);
    default: return cudaErrorInvalidValue;
  }
}

// 16-bit q on the tensor cores (prefill_hopper.cuh): pages of q's type or
// int8, head dims 32, 64, 128
template <typename T>
cudaError_t launch_hopper(const PfArgs& p, const void* q, int quant, cudaStream_t st) {
  switch (p.hd * 2 + (quant ? 1 : 0)) {
    case 64: return launch_prefill_hopper<T, T, 32>(p, q, st);
    case 65: return launch_prefill_hopper<T, int8_t, 32>(p, q, st);
    case 128: return launch_prefill_hopper<T, T, 64>(p, q, st);
    case 129: return launch_prefill_hopper<T, int8_t, 64>(p, q, st);
    case 256: return launch_prefill_hopper<T, T, 128>(p, q, st);
    case 257: return launch_prefill_hopper<T, int8_t, 128>(p, q, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dsk

// q [S, Q, nkv, g, hd]; k_pages/v_pages [NB, nkv, bs, hd] of q's type, or
// int8 (quant != 0) with k_scale/v_scale [NB, nkv, bs] fp32; block_table
// [S, MB] int32; kv_lens, q_starts, q_counts [S] int32; slopes [nkv*g] fp32
// or null; out [S, Q, nkv, g, hd].  dtype (of q): 0 fp32, 1 fp16, 2 bf16.
// window <= 0: none.  route 1: the tensor-core kernel (16-bit q, hd 32 / 64
// / 128, bs % 16 == 0 and bs <= 256, S <= 1024 and S * ceil(Q / (128 / g))
// <= 1024 units), a persistent grid of `grid` blocks, with part_acc [2 *
// grid, 128, hd] and part_ml [2 * grid, 128, 2] fp32 scratch for split
// walks and counters, two int32 zeros (zeros again when the kernel ends).
// route 0: the CUDA-core kernel, cq query tokens a block (cq * g <= 64).
extern "C" int ds_ragged_prefill(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scale, const void* v_scale,
                                 const void* block_table, const void* kv_lens,
                                 const void* q_starts, const void* q_counts,
                                 const void* slopes, void* out, void* part_acc, void* part_ml,
                                 void* counters, int S, int Q, int nkv, int g, int hd, int bs, int MB, int NB,
                                 int cq, int grid, float scale, int window, int dtype, int quant,
                                 int route, void* stream) {
  if (g < 1 || bs < 1) return (int)cudaErrorInvalidValue;
  if (S == 0 || Q == 0 || nkv == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto bt = static_cast<const int*>(block_table);
  auto lens = static_cast<const int*>(kv_lens);
  auto starts = static_cast<const int*>(q_starts);
  auto counts = static_cast<const int*>(q_counts);
  auto sl = static_cast<const float*>(slopes);
  if (route == 1) {
    const int tq = dsk::kPfRows / g;
    const long long umax = (long long)S * ((Q + tq - 1) / tq);
    if (dtype == 0 || tq < 1 || bs % 16 || bs > 256 || S > 1024 || umax > 1024 || grid < 1 ||
        part_acc == nullptr || part_ml == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    dsk::PfArgs p = {};
    p.out = out;
    p.part_acc = static_cast<float*>(part_acc);
    p.part_ml = static_cast<float*>(part_ml);
    p.kpool = k_pages;
    p.vpool = v_pages;
    p.kscale = ks;
    p.vscale = vs;
    p.block_table = bt;
    p.kv_lens = lens;
    p.q_starts = starts;
    p.q_counts = counts;
    p.slopes = sl;
    p.counters = static_cast<int*>(counters);
    p.S = S, p.Q = Q, p.nkv = nkv, p.g = g, p.hd = hd, p.bs = bs, p.MB = MB, p.NB = NB;
    p.tq = tq;
    p.pps = bs <= dsk::kPfKeys ? dsk::kPfKeys / bs : (bs + dsk::kPfKeys - 1) / dsk::kPfKeys;
    p.grid = grid;
    p.umax = (int)umax;
    p.window = window;
    p.scale2 = scale * dsk::kLog2e;
    cudaError_t err = dtype == 1 ? dsk::launch_hopper<__half>(p, q, quant, st)
                                 : dsk::launch_hopper<__nv_bfloat16>(p, q, quant, st);
    return (int)err;
  }
  if (cq < 1 || cq * g > dsk::kWarps * dsk::kRowsPerWarp) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype * 2 + (quant ? 1 : 0)) {
    case 0: err = dsk::launch_simt_hd<float, float>(hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    case 1: err = dsk::launch_simt_hd<float, int8_t>(hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    case 2: err = dsk::launch_simt_hd<__half, __half>(hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    case 3: err = dsk::launch_simt_hd<__half, int8_t>(hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    case 4: err = dsk::launch_simt_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    case 5: err = dsk::launch_simt_hd<__nv_bfloat16, int8_t>(hd, q, k_pages, v_pages, ks, vs, bt, lens, starts, counts, sl, out, S, Q, nkv, g, cq, bs, MB, scale, window, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
