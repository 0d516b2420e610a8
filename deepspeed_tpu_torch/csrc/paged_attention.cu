// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py:_split_kernel
// (launched by _pallas_paged_attention_split): one query token per serving
// slot attends that slot's KV pages through its block table; GQA-native (one
// block serves a kv head and its whole query group), alibi, sliding window
// (pages wholly before the window are never read), kv_len == 0 -> zeros.
//
// What bounds it on the H100: HBM bytes.  Every live K and V token is read
// once (bs=64 x hd=128 bf16 = 16 KB per page and head), against ~4*g*hd
// FLOPs per token: far below the ~295 FLOP/byte ridge, so tensor cores buy
// nothing.  The design is about keeping enough bytes in flight:
//   - grid (slot, kv head, split): the TPU ran the split axis sequentially;
//     here the splits run concurrently (flash-decoding) so a 16-slot x 8-head
//     batch still puts hundreds of blocks on the 132 SMs at long contexts.
//     Each split walks only its share of the slot's live pages and writes
//     unnormalised partials (acc, m, l) that a second small kernel merges
//     with the logsumexp combine of the TPU epilogue (paged_attention.py
//     :425-431).  One split writes the normalised output directly.
//   - each block reads its own block-table entries (no scalar prefetch) and
//     copies whole (page, head) slabs of K and V to shared memory with
//     16-byte cp.async, double-buffered: page p+1 streams in while page p is
//     consumed.  Page order in the table is arbitrary (preemption and
//     re-admission leave non-monotone tables); nothing assumes it.
//   - one warp per query head of the group; lanes split head_dim, warp
//     reductions give the scores in fp32, eight keys at a time, and the
//     online softmax keeps m, l and acc in fp32 registers (one rescale per
//     eight keys).
//   - int8 pages (kv_quant, the TPU kernel's quant=True): the slab copied is
//     the int8 codes (half the bf16 bytes — the bound halves with them) plus
//     the page's [bs] fp32 scale rows of K and V; each row is dequantized in
//     registers as it is read (code * scale rounded once to q's dtype, as
//     the TPU kernel's _dequant_page), before the same score and P.V math.
#include "paged_common.cuh"

namespace dsk {

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

template <typename T, typename P, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* bt, const int* lens, const float* slopes,
                   void* out, float* part_acc, float* part_ml, int S, int nkv, int g, int bs,
                   int MB, int NS, float scale, int window, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)bs * HD * sizeof(P) +
                      (std::is_same<T, P>::value ? 0 : 4 * (size_t)bs * sizeof(float));
  auto kern = paged_decode_kernel<T, P, HD>;
  cudaError_t err = allow_dynamic_smem<paged_decode_kernel<T, P, HD>>();
  if (err != cudaSuccess) return err;
  kern<<<dim3(S, nkv, NS), g * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k), static_cast<const P*>(v), ks, vs, bt,
      lens, slopes, static_cast<T*>(out), part_acc, part_ml, nkv, g, bs, MB, NS, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS == 1) return err;
  split_combine_kernel<T><<<S * nkv * g, HD, (NS + 1) * sizeof(float), stream>>>(
      part_acc, part_ml, static_cast<T*>(out), g, HD, NS);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* bt, const int* lens, const float* slopes,
                      void* out, float* pa, float* pm, int S, int nkv, int g, int bs, int MB,
                      int NS, float scale, int window, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, P, 32>(q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st);
    case 64: return launch<T, P, 64>(q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st);
    case 128: return launch<T, P, 128>(q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st);
    case 256: return launch<T, P, 256>(q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st);
    default: return cudaErrorInvalidValue;
  }
}

// int8 pages (quant != 0) or pages of q's type
template <typename T>
cudaError_t launch_pages(int quant, int hd, const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* bt, const int* lens,
                         const float* slopes, void* out, float* pa, float* pm, int S, int nkv,
                         int g, int bs, int MB, int NS, float scale, int window,
                         cudaStream_t st) {
  if (quant)
    return launch_hd<T, int8_t>(hd, q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st);
  return launch_hd<T, T>(hd, q, k, v, ks, vs, bt, lens, slopes, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st);
}

}  // namespace dsk

// q [S, nkv, g, hd]; k_pages/v_pages [NB, nkv, bs, hd] of q's type, or
// int8 (quant != 0) with k_scale/v_scale [NB, nkv, bs] fp32; block_table
// [S, MB] int32; kv_lens [S] int32; slopes [nkv*g] fp32 or null; out [S, nkv,
// g, hd]; part_acc [S, nkv, NS, g, hd] and part_ml [S, nkv, NS, g, 2] fp32
// scratch (unused when NS == 1).  dtype (of q): 0 fp32, 1 fp16, 2 bf16.
// window <= 0: none.
extern "C" int ds_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scale, const void* v_scale,
                                  const void* block_table, const void* kv_lens,
                                  const void* slopes, void* out, void* part_acc,
                                  void* part_ml, int S, int nkv, int g, int hd, int bs,
                                  int MB, int NS, float scale, int window, int dtype, int quant,
                                  void* stream) {
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
  cudaError_t err;
  switch (dtype) {
    case 0: err = dsk::launch_pages<float>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, sl, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st); break;
    case 1: err = dsk::launch_pages<__half>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, sl, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st); break;
    case 2: err = dsk::launch_pages<__nv_bfloat16>(quant, hd, q, k_pages, v_pages, ks, vs, bt, lens, sl, out, pa, pm, S, nkv, g, bs, MB, NS, scale, window, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
