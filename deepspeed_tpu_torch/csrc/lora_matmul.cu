// Batched-gather LoRA delta for Hopper (sm_90a): every row of a
// multi-tenant batch carries its own adapter slot, and
//
//     y[m] = round_x( round_x(x[m] . A[id_m]) . B[id_m] * s[id_m] )
//
// with x [M, H], A [S, H, r], B [S, r, O], ids [M] int32, s [S] fp32 and y
// [M, O] in x's type.  The rounding is the JAX package's xla_lora_matmul
// (deepspeed_tpu/ops/lora_matmul.py:66): the rank product u = x . A[id]
// accumulates in fp32 and is cast to x's type, then u . B[id] accumulates
// in fp32, is scaled by s[id] in fp32 and cast once.
//
// Replaces the TPU kernel deepspeed_tpu/ops/lora_matmul.py _kernel (:111,
// launched by pallas_lora_matmul :138, pallas_call :164).  That kernel's
// grid (M/bm, S) visits EVERY slot for every row block and masks the dense
// product onto the matching rows (BGMV-style): S times the work, a Mosaic
// constraint.  Here each slot's pages are read for its own rows only, in
// two launches: the shrink writes fp32 partial sums of u over chunks of H,
// part [ceil(H / 256), M, r], and the expand sums them and forms y.
//
// What bounds it on the H100: bytes, and at decode the latency of two
// dependent launches.  At the serving main path's calls (Llama-3-8B, r 16,
// 9 slots, bf16) the work is ~4*M*H*r flops, under 70 MFLOP, against
// 1.5-6.3 MB of x, pages and y: the byte bound is 0.4-1.9 us.
//
// 16-bit x with r % 8 == 0 and O % 8 == 0 (lora_shrink_wgmma,
// lora_expand_wgmma): rows segmented by slot, products on wgmma.
//   - Segmenting, in every block, without a sort and without the host: the
//     block reads ids, counts each slot's rows (each warp a quarter of the
//     rows, equal ids grouped by match_any, a histogram a warp: no
//     atomics), and works out its unit from the counts: (slot, 64-row tile
//     of that slot's rows, H chunk) for the shrink, (slot, 64-row tile, 128
//     output columns) for the expand.  The tile's row indices are compacted
//     in ascending row order with a ballot and a prefix sum; blocks past the
//     last unit exit.  A slot's A and B pages are read once a tile, not once
//     a row.
//   - The shrink: the tile's x rows of the 256-wide H chunk are gathered by
//     16-byte cp.async into a 128-byte-swizzled K-major tile; A[id]'s [256,
//     r] chunk comes by TMA (a 3-D map over [S, H, r]; the rank padded to
//     16 / 32 / 64 columns by zero fill, 64-column boxes above 64) in the
//     swizzle as wide as its rows, MN-major for wgmma (the transpose bit);
//     wgmma m64 n16-64 k16, fp32, then each real row's partials are stored
//     at its original index.
//   - The expand: each row's partials summed over the chunks in ascending
//     order and rounded to x's type (u, zero past r), taken from shared
//     memory as wgmma's register A operand; B[id]'s [r, 128] tile by TMA
//     (MN-major, a 3-D map over [S, r, O], so that padding r up to 16 /
//     32 / 64 / 128 / 256 reads zeros, never the next slot), scaled by
//     s[id] in fp32, cast once, stored at the row's original index.
//   - The expand is launched as a programmatic dependent of the shrink:
//     the shrink's blocks let it be scheduled as they start, its blocks
//     segment and fetch their B tile, then wait for the whole shrink and
//     its stores (griddepcontrol.wait), so the segmenting runs under the
//     shrink.
// fp32 x and other ranks (lora_shrink_kernel, lora_expand_kernel): the
// same two stages on the CUDA cores, one row a block: the shrink's grid
// (M, H/256), thread t owns rank column t % r and walks the chunk's rows of
// the contiguous [H, r] page (coalesced for any r), the block's threads of
// one column summed through shared memory in a fixed order; the expand's
// grid (M, O/256), a thread per output column over the r rank rows.
//
// No atomics and a fixed summation order everywhere: the result is
// deterministic.  Rows of slot 0 (the pool's identity: zero pages, scale
// 0) come out exactly 0.  A row whose id lies outside [0, S) is written as
// NaN: a visible fault, never a read out of bounds.
#include "hopper_common.cuh"

#include <algorithm>

namespace dsk {

constexpr int LORA_THREADS = 256;
constexpr int LORA_RMAX = 256;   // rank limit: a shrink block holds >= r threads
constexpr int LORA_OT = 256;     // output columns of an expand block
constexpr int LORA_HC = 256;     // rows of A (columns of x) a shrink chunk

// ------------------------------------------------------- CUDA cores

template <typename T>
__device__ __forceinline__ float ld(const T* p) {
  return Bits<T>::to_f(*reinterpret_cast<const typename Bits<T>::U*>(p));
}

template <typename T>
__global__ void __launch_bounds__(LORA_THREADS)
lora_shrink_kernel(const T* __restrict__ x, const T* __restrict__ a, const int* __restrict__ ids,
                   float* __restrict__ part, int M, int H, int r, int S) {
  __shared__ float red[LORA_THREADS];
  const int m = blockIdx.x, c = blockIdx.y;
  const int t = threadIdx.x;
  const int lanes = blockDim.x;       // r * (256 / r)
  const int hstep = lanes / r;
  const int id = ids[m];
  float acc = 0.f;
  if (id >= 0 && id < S) {
    const int h1 = min(H, (c + 1) * LORA_HC);
    const T* __restrict__ xr = x + (size_t)m * H;
    const T* __restrict__ ap = a + (size_t)id * H * r + (t % r);
#pragma unroll 8
    for (int h = c * LORA_HC + t / r; h < h1; h += hstep) acc += ld(xr + h) * ld(ap + (size_t)h * r);
  }
  red[t] = acc;
  __syncthreads();
  if (t < r) {
    float s = 0.f;
    for (int i = 0; i < hstep; ++i) s += red[i * r + t];
    part[((size_t)c * M + m) * r + t] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(LORA_OT)
lora_expand_kernel(const float* __restrict__ part, const T* __restrict__ b,
                   const int* __restrict__ ids, const float* __restrict__ scales,
                   T* __restrict__ y, int M, int O, int r, int S, int nsplit) {
  __shared__ float u[LORA_RMAX];
  const int m = blockIdx.x;
  const int o = blockIdx.y * LORA_OT + threadIdx.x;
  const int id = ids[m];
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < nsplit; ++c) s += part[((size_t)c * M + m) * r + j];
    u[j] = Bits<T>::round(s);          // u cast to x's type
  }
  __syncthreads();
  if (o >= O) return;
  if (id < 0 || id >= S) {
    y[(size_t)m * O + o] = Bits<T>::from_f(__int_as_float(0x7fc00000));
    return;
  }
  const T* __restrict__ bp = b + (size_t)id * r * O + o;
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < r; ++j) acc += u[j] * ld(bp + (size_t)j * O);
  y[(size_t)m * O + o] = Bits<T>::from_f(acc * scales[id]);
}

template <typename T>
cudaError_t launch_lora_simt(const void* x, const void* a, const void* b, const int* ids,
                             const float* scales, void* y, float* part, int M, int H, int r,
                             int O, int S, cudaStream_t st) {
  const int nsplit = (H + LORA_HC - 1) / LORA_HC;
  const int lanes = r * (LORA_THREADS / r);
  lora_shrink_kernel<T><<<dim3(M, nsplit), lanes, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, part, M, H, r, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lora_expand_kernel<T><<<dim3(M, (O + LORA_OT - 1) / LORA_OT), LORA_OT, 0, st>>>(
      part, static_cast<const T*>(b), ids, scales, static_cast<T*>(y), M, O, r, S, nsplit);
  return cudaGetLastError();
}

// ------------------------------------------------------- tensor cores

constexpr int kLoraRows = 64;       // rows a tile (wgmma's m)
constexpr int kLoraOT = 128;        // output columns an expand unit
constexpr int kLoraThreads = 128;   // one warpgroup
constexpr int kLoraMaxSlots = 1024;

// Shared memory ahead of the tiles: the mbarrier, the per-warp histograms
// [4][S + 1] (bucket S: ids outside [0, S)), the tile prefix [S + 2] and
// the tile's row indices [64]; then the tiles from a 1024-byte boundary.
__host__ __device__ inline int lora_head_bytes(int S) {
  return (16 + 4 * (4 * (S + 1) + S + 2 + kLoraRows) + 1023) / 1024 * 1024 + 1024;
}

// This block's tile: rows of bucket `slot` (0..nb-1; nb = S for the shrink,
// S + 1 with the out-of-range bucket for the expand), its k-th tile of 64
// rows (row indices in rows[], -1 past the tile's nrow rows).  False if
// tile index `t` lies past the last tile.
struct LoraTile {
  int slot, nrow;
};
__device__ __forceinline__ bool lora_segment(const int* __restrict__ ids, int M, int S, int nb,
                                             int t, int* hist, int* tstart, int* rows,
                                             LoraTile& tile) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < 4 * (S + 1); i += kLoraThreads) hist[i] = 0;
  for (int i = threadIdx.x; i < kLoraRows; i += kLoraThreads) rows[i] = -1;
  __syncthreads();
  // each warp counts its quarter of the rows into its own histogram, the
  // ids of four batches of 32 rows loaded ahead of their counting
  const int per = (M + 3) / 4, r0 = min(M, w * per), r1 = min(M, r0 + per);
  int* h = hist + w * (S + 1);
  for (int b0 = r0; b0 < r1; b0 += 128) {
    int key[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = b0 + 32 * i + lane;
      const int id = m < r1 ? ids[m] : 0;
      key[i] = (id >= 0 && id < S) ? id : S;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = b0 + 32 * i + lane < r1;
      const unsigned act = __ballot_sync(0xffffffffu, in);
      if (in) {
        const unsigned same = __match_any_sync(act, key[i]);
        if (lane == __ffs(same) - 1) h[key[i]] += __popc(same);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // tiles a bucket and their running sum (warp 0)
  if (w == 0) {
    int carry = 0;
    for (int base = 0; base < nb; base += 32) {
      const int s = base + lane;
      const int n = s < nb ? hist[s] + hist[(S + 1) + s] + hist[2 * (S + 1) + s] +
                                 hist[3 * (S + 1) + s]
                           : 0;
      int v = (n + kLoraRows - 1) / kLoraRows;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += x;
      }
      if (s < nb) tstart[s + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) tstart[0] = 0;
  }
  __syncthreads();
  if (t >= tstart[nb]) return false;
  int s = 0;  // the last bucket with tstart[s] <= t
  for (int hi = nb - 1; s < hi;) {
    const int mid = (s + hi + 1) / 2;
    if (tstart[mid] <= t) s = mid; else hi = mid - 1;
  }
  const int k = t - tstart[s];
  const int n = hist[s] + hist[(S + 1) + s] + hist[2 * (S + 1) + s] + hist[3 * (S + 1) + s];
  tile.slot = s;
  tile.nrow = min(kLoraRows, n - k * kLoraRows);
  // the tile's rows: ranks 64k .. 64k + 63 among the bucket's rows, in row
  // order (the warps' quarters in turn, each by a ballot prefix)
  int rank = 0;
  for (int i = 0; i < w; ++i) rank += hist[i * (S + 1) + s];
  for (int b0 = r0; b0 < r1; b0 += 128) {
    bool hit[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = b0 + 32 * i + lane;
      const int id = m < r1 ? ids[m] : 0;
      hit[i] = m < r1 && ((id >= 0 && id < S) ? id : S) == s;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned hits = __ballot_sync(0xffffffffu, hit[i]);
      if (hit[i]) {
        const int j = rank + __popc(hits & ((1u << lane) - 1)) - k * kLoraRows;
        if (j >= 0 && j < kLoraRows) rows[j] = b0 + 32 * i + lane;
      }
      rank += __popc(hits);
    }
  }
  __syncthreads();
  return true;
}

// The shrink: unit blockIdx.x = (tile, H chunk), the chunk fastest.  RP
// rank columns an operand (16, 32 or 64: the swizzle as wide as its rows),
// RG operands of RP columns (ranks above 64: RP 64).
template <typename T, int RP, int RG>
__global__ void __launch_bounds__(kLoraThreads)
    lora_shrink_wgmma(const __grid_constant__ CUtensorMap tma, const T* __restrict__ x,
                      const int* __restrict__ ids, float* __restrict__ part, int M, int H, int r,
                      int S, int nch) {
  constexpr int AROW = RP * 2;                  // bytes of a row of A's tile
  constexpr int ABYTES = LORA_HC * AROW;        // one operand's [256, RP] tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* hist = reinterpret_cast<int*>(smem_raw + 16);
  int* tstart = hist + 4 * (S + 1);
  int* rows = tstart + S + 2;
  unsigned char* base = smem_raw + lora_head_bytes(S) - 1024;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  unsigned char* xs = base;                                // [4][64 rows][128 B]
  unsigned char* as = xs + 4 * kLoraRows * 128;             // [RG][256 rows][AROW]
  LoraTile tile;
  const int c = blockIdx.x % nch;
  // through a shuffle, so that ptxas sees the exit uniform (a wgmma behind
  // a branch it cannot prove uniform makes it serialise them all)
  griddep_launch();  // the expand may be scheduled now (it waits for this grid)
  if (!__shfl_sync(0xffffffffu,
                   (int)lora_segment(ids, M, S, S, blockIdx.x / nch, hist, tstart, rows, tile),
                   0))
    return;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_expect_tx(bar, RG * ABYTES);
#pragma unroll
    for (int g = 0; g < RG; ++g)
      tma_load_3d(as + g * ABYTES, &tma, g * RP, c * LORA_HC, tile.slot, bar);
  }
  // the tile's x rows of the chunk, 16 bytes a copy, zeros past the tile
  // and past H, into the 128-byte swizzle
  const int h0 = c * LORA_HC;
  for (int i = threadIdx.x; i < kLoraRows * (LORA_HC / 8); i += kLoraThreads) {
    const int j = i / (LORA_HC / 8), ch = i % (LORA_HC / 8);
    unsigned char* dst = xs + (ch / 8) * (kLoraRows * 128) + j * 128 + (((ch % 8) ^ (j & 7)) << 4);
    const int m = rows[j], col = h0 + ch * 8;
    if (m >= 0 && col < H)
      cp_async16(dst, x + (size_t)m * H + col);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  mbar_wait(bar, 0);

  float acc[RG][RP / 2];
#pragma unroll
  for (int g = 0; g < RG; ++g)
#pragma unroll
    for (int i = 0; i < RP / 2; ++i) acc[g][i] = 0.f;
#pragma unroll
  for (int g = 0; g < RG; ++g) wg_fence_regs(acc[g]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < LORA_HC / 16; ++kk) {
    const uint64_t da = wg_desc(xs + (kk / 4) * (kLoraRows * 128) + (kk % 4) * 32);
#pragma unroll
    for (int g = 0; g < RG; ++g)
      Wgmma<T>::sst(acc[g], da, wg_desc_rb<AROW>(as + g * ABYTES + kk * 16 * AROW), kk > 0);
  }
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int g = 0; g < RG; ++g) wg_fence_regs(acc[g]);

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, grp = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = rows[16 * w + grp + 8 * hh];
    if (m < 0) continue;
    float* dst = part + ((size_t)c * M + m) * r;
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int j = 0; j < RP / 8; ++j) {
        const int col = g * RP + 8 * j + 2 * tq;
        if (col < r)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(acc[g][4 * j + 2 * hh], acc[g][4 * j + 2 * hh + 1]);
      }
  }
}

// The expand: unit blockIdx.x = (tile, 128 output columns), the columns
// fastest.  RK: the rank rounded up to 16, 32, 64, 128 or 256 (the product's
// k; u and B are zero past r).
template <typename T, int RK>
__global__ void __launch_bounds__(kLoraThreads)
    lora_expand_wgmma(const __grid_constant__ CUtensorMap tmb, const float* __restrict__ part,
                      const int* __restrict__ ids, const float* __restrict__ scales,
                      T* __restrict__ y, int M, int O, int r, int S, int nch) {
  constexpr int BBYTES = RK * 128;   // one 64-column block of B's [RK, 128] tile
  constexpr int UROW = RK + 8;       // u's row in 16-bit elements (padded)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* hist = reinterpret_cast<int*>(smem_raw + 16);
  int* tstart = hist + 4 * (S + 1);
  int* rows = tstart + S + 2;
  unsigned char* base = smem_raw + lora_head_bytes(S) - 1024;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  unsigned char* bs = base;                                   // [2][RK rows][128 B]
  T* us = reinterpret_cast<T*>(bs + 2 * BBYTES);                // [64][UROW]
  const int nout = (O + kLoraOT - 1) / kLoraOT;
  const int o0 = (blockIdx.x % nout) * kLoraOT;
  LoraTile tile;
  if (!__shfl_sync(0xffffffffu,
                   (int)lora_segment(ids, M, S, S + 1, blockIdx.x / nout, hist, tstart, rows,
                                     tile),
                   0))
    return;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, grp = lane >> 2, tq = lane & 3;
  tile.slot = __shfl_sync(0xffffffffu, tile.slot, 0);
  if (tile.slot == S) {  // ids outside [0, S): NaN rows
    const T nan = Bits<T>::from_f(__int_as_float(0x7fc00000));
    for (int i = threadIdx.x; i < tile.nrow * kLoraOT; i += kLoraThreads) {
      const int o = o0 + i % kLoraOT;
      if (o < O) y[(size_t)rows[i / kLoraOT] * O + o] = nan;
    }
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_expect_tx(bar, 2 * BBYTES);
    tma_load_3d(bs, &tmb, o0, 0, tile.slot, bar);
    tma_load_3d(bs + BBYTES, &tmb, o0 + 64, 0, tile.slot, bar);
  }
  griddep_wait();  // the shrink's partials
  // u: each row's partials summed over the chunks in order, rounded to T
  for (int i = threadIdx.x; i < kLoraRows * (RK / 4); i += kLoraThreads) {
    const int j = i / (RK / 4), q = 4 * (i % (RK / 4));
    const int m = rows[j];
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m >= 0 && q < r) {
      // sixteen chunks' loads in flight, then their sum in chunk order
      for (int c0 = 0; c0 < nch; c0 += 16) {
        float4 p[16];
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (c0 + c < nch)
            p[c] = *reinterpret_cast<const float4*>(part + ((size_t)(c0 + c) * M + m) * r + q);
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (c0 + c < nch) s.x += p[c].x, s.y += p[c].y, s.z += p[c].z, s.w += p[c].w;
      }
    }
    store4<T>(us + j * UROW + q, {s.x, s.y, s.z, s.w});
  }
  __syncthreads();
  // u as wgmma's A fragments: rows 16w + grp (+8), k 16kk + 2tq (+8)
  uint32_t pa[RK / 16][4];
  {
    const T* u0 = us + (16 * w + grp) * UROW + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < RK / 16; ++kk) {
      pa[kk][0] = *reinterpret_cast<const uint32_t*>(u0 + 16 * kk);
      pa[kk][1] = *reinterpret_cast<const uint32_t*>(u0 + 8 * UROW + 16 * kk);
      pa[kk][2] = *reinterpret_cast<const uint32_t*>(u0 + 16 * kk + 8);
      pa[kk][3] = *reinterpret_cast<const uint32_t*>(u0 + 8 * UROW + 16 * kk + 8);
    }
  }
  mbar_wait(bar, 0);
  float acc[2][32];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
#pragma unroll
  for (int a = 0; a < 2; ++a) wg_fence_regs(acc[a]);
#pragma unroll
  for (int kk = 0; kk < RK / 16; ++kk) wg_fence_regs(pa[kk]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < RK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 2; ++a)
      Wgmma<T>::rs64(acc[a], pa[kk], wg_desc(bs + a * BBYTES + kk * 16 * 128));
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int a = 0; a < 2; ++a) wg_fence_regs(acc[a]);
  const float sc = scales[tile.slot];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = rows[16 * w + grp + 8 * hh];
    if (m < 0) continue;
    T* dst = y + (size_t)m * O;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = o0 + 64 * a + 8 * j + 2 * tq;
        if (o < O)
          *reinterpret_cast<uint32_t*>(dst + o) =
              Mma<T>::pack(acc[a][4 * j + 2 * hh] * sc, acc[a][4 * j + 2 * hh + 1] * sc);
      }
  }
}

template <typename T, int RP, int RG>
cudaError_t launch_shrink(const void* x, const void* a, const int* ids, float* part, int M,
                          int H, int r, int S, int nch, cudaStream_t st) {
  CUtensorMap tma;
  int collapsed = 0;
  const long long dims[3] = {r, H, S}, strides[3] = {1, r, (long long)H * r};
  const int box[3] = {RP, LORA_HC, 1};
  constexpr CUtensorMapSwizzle sw = RP == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                    : RP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_128B;
  // (a collapsed slot dim is S == 1, where slot 0 is the only coordinate)
  if (!tensor_map_nd(&tma, tma_dtype<T>(), 2, a, 3, dims, strides, box, sw, &collapsed))
    return cudaErrorInvalidValue;
  const size_t smem = lora_head_bytes(S) + 4 * kLoraRows * 128 + RG * LORA_HC * RP * 2;
  cudaError_t err = allow_dynamic_smem<lora_shrink_wgmma<T, RP, RG>>();
  if (err != cudaSuccess) return err;
  // tiles: at most one partial tile a slot beside the full ones
  const int tiles = (M + kLoraRows - 1) / kLoraRows + std::min(S, M);
  lora_shrink_wgmma<T, RP, RG><<<tiles * nch, kLoraThreads, smem, st>>>(
      tma, static_cast<const T*>(x), ids, part, M, H, r, S, nch);
  return cudaGetLastError();
}

template <typename T, int RK>
cudaError_t launch_expand(const void* b, const float* part, const int* ids,
                          const float* scales, void* y, int M, int O, int r, int S, int nch,
                          bool pdl, cudaStream_t st) {
  CUtensorMap tmb;
  int collapsed = 0;
  const long long dims[3] = {O, r, S}, strides[3] = {1, O, (long long)r * O};
  const int box[3] = {64, RK, 1};
  if (!tensor_map_nd(&tmb, tma_dtype<T>(), 2, b, 3, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B, &collapsed))
    return cudaErrorInvalidValue;
  const size_t smem = lora_head_bytes(S) + 2 * RK * 128 + kLoraRows * (RK + 8) * sizeof(T);
  cudaError_t err = allow_dynamic_smem<lora_expand_wgmma<T, RK>>();
  if (err != cudaSuccess) return err;
  const int tiles = (M + kLoraRows - 1) / kLoraRows + std::min(S + 1, M);
  const int nout = (O + kLoraOT - 1) / kLoraOT;
  return launch_pdl(lora_expand_wgmma<T, RK>, dim3(tiles * nout), dim3(kLoraThreads), smem, st,
                    pdl, tmb, part, ids, scales, static_cast<T*>(y), M, O, r, S, nch);
}

template <typename T>
cudaError_t launch_lora_wgmma(const void* x, const void* a, const void* b, const int* ids,
                              const float* scales, void* y, float* part, int M, int H, int r,
                              int O, int S, bool pdl, cudaStream_t st) {
  const int nch = (H + LORA_HC - 1) / LORA_HC;
  cudaError_t err;
  if (r <= 16)
    err = launch_shrink<T, 16, 1>(x, a, ids, part, M, H, r, S, nch, st);
  else if (r <= 32)
    err = launch_shrink<T, 32, 1>(x, a, ids, part, M, H, r, S, nch, st);
  else if (r <= 64)
    err = launch_shrink<T, 64, 1>(x, a, ids, part, M, H, r, S, nch, st);
  else if (r <= 128)
    err = launch_shrink<T, 64, 2>(x, a, ids, part, M, H, r, S, nch, st);
  else
    err = launch_shrink<T, 64, 4>(x, a, ids, part, M, H, r, S, nch, st);
  if (err != cudaSuccess) return err;
  if (r <= 16) return launch_expand<T, 16>(b, part, ids, scales, y, M, O, r, S, nch, pdl, st);
  if (r <= 32) return launch_expand<T, 32>(b, part, ids, scales, y, M, O, r, S, nch, pdl, st);
  if (r <= 64) return launch_expand<T, 64>(b, part, ids, scales, y, M, O, r, S, nch, pdl, st);
  if (r <= 128) return launch_expand<T, 128>(b, part, ids, scales, y, M, O, r, S, nch, pdl, st);
  return launch_expand<T, 256>(b, part, ids, scales, y, M, O, r, S, nch, pdl, st);
}

}  // namespace dsk

// part: [ceil(H / 256), M, r] fp32 scratch.  dtype: 0 fp32, 1 fp16, 2 bf16.
// route 1: the tensor-core pair (16-bit x, r % 8 == 0, O % 8 == 0, H % 8 ==
// 0, S <= 1024, 16-byte aligned x and pages), the expand a programmatic
// dependent of the shrink when pdl; route 0: the CUDA-core pair.
extern "C" int ds_lora_matmul(const void* x, const void* a, const void* b, const void* ids,
                              const void* scales, void* y, void* part, int M, int H, int r,
                              int O, int S, int dtype, int route, int pdl, void* stream) {
  if (r < 1 || r > dsk::LORA_RMAX || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || O == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(ids);
  auto s = static_cast<const float*>(scales);
  auto p = static_cast<float*>(part);
  if (route == 1) {
    if (dtype == 0 || r % 8 || O % 8 || H % 8 || S > dsk::kLoraMaxSlots)
      return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      return (int)dsk::launch_lora_wgmma<__half>(x, a, b, i, s, y, p, M, H, r, O, S, pdl, st);
    if (dtype == 2)
      return (int)dsk::launch_lora_wgmma<__nv_bfloat16>(x, a, b, i, s, y, p, M, H, r, O, S,
                                                        pdl, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0: return (int)dsk::launch_lora_simt<float>(x, a, b, i, s, y, p, M, H, r, O, S, st);
    case 1: return (int)dsk::launch_lora_simt<__half>(x, a, b, i, s, y, p, M, H, r, O, S, st);
    case 2:
      return (int)dsk::launch_lora_simt<__nv_bfloat16>(x, a, b, i, s, y, p, M, H, r, O, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
