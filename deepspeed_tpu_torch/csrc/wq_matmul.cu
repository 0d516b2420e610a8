// Quantized-weight matrix products for Hopper (sm_90a): the weight stays
// int8 (or nibble-packed int4) in device memory and is dequantized tile by
// tile in shared memory.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/wq_matmul.py:
//   mode 0  _kernel, contract=0 (wq_matmul):   y = x[M,K] @ (c[K,N] * s[K/g,N])
//   mode 1  _kernel, contract=1 (wq_matmul_t): y = x[M,H] @ (c[V,H] * s[V/g,H])^T
//   mode 2  _kernel4 (wq_matmul4):             y = x[M,K] @ (unpack(c[K/2,N]) * s[K/g,N])
// Dequantization is the JAX package's: an fp32 product code * scale, cast
// ONCE to x's type, then an fp32-accumulated product and one cast of y to
// x's type (wq_matmul.py:239-243).  A 4-bit byte holds row 2i in its low
// nibble and row 2i+1 in its high nibble, both sign-extended; CUDA has the
// shifts that Mosaic lacked, so rows are unpacked into their natural order
// in shared memory and x is never de-interleaved.
//
// What bounds it on the H100: at decode (M = 16 serving slots) the BYTES of
// the weight — 1 byte of code (1/2 for int4) + 4/g bytes of scale per
// parameter against 2*M flops per parameter, far below the ~295 flop/byte
// ridge; at prefill (M = 256) the OPERATIONS (2*256 flops a weight byte).
//
// Modes 0 and 2 with 16-bit x: wq_wgmma_kernel, warp-specialised for the
// tensor cores' asynchronous product (wgmma).  A block owns a 128-column
// tile over up to 256 rows of x, so each code byte is read and dequantized
// once for every row (M above 256 takes further row blocks).  It walks its
// share of K in 64-deep stages through a ring of 3-8 shared-memory stages
// (as many as fit: 3 at M 256, 6 at M <= 64), each with three mbarriers:
//   - warp 0 (producer): one thread keeps the TMA tensor copies of the x
//     tile (landing in wgmma's 128-byte swizzle), the code tile and its
//     scale rows in flight, three a stage, and the "raw full" barrier
//     completes on their bytes (one warp's 16-byte cp.async through L1
//     was the M-256 products' bottleneck);
//   - warps 1-7 (dequantizers) turn the staged codes into the 16-bit B tile
//     [128 n][64 k], K-major in the 128-byte swizzle that wgmma reads, and
//     signal "B full" - so dequantizing stage k+1 overlaps the product of
//     stage k;
//   - warpgroups 2 and 3 (consumers) each own two 64-row tiles (rows 0-63
//     and 128-191, 64-127 and 192-255) and run wgmma m64n128k16 with fp32
//     accumulators straight from shared memory, then signal "empty".
// Where the column tiles (times the row blocks) are fewer than the SMs, K
// is split across blocks (split-K, from shapes alone: no host sync), each
// split writing fp32 partials that wq_reduce_kernel sums in a fixed order
// and casts once, so y does not depend on the run.
//
// Mode 1 (16-bit x): wq_t_kernel, the swapped product y^T = W x^T on the
// same warp-specialised TMA + wgmma shape, persistent over its tiles (see
// below).  fp32 x (any mode): wq_simt_kernel, a CUDA-core version used where
// exact fp32 is the point (tests, parity).  Code rows whose length or base
// is not 16-byte aligned are loaded element by element (the wgmma kernels'
// producers then stage x by cp.async).
#include "hopper_common.cuh"

#include <algorithm>

namespace dsk {

enum { kW8 = 0, kW8T = 1, kW4 = 2 };

// the low / high 4-bit code of a sign-extended byte, sign-extended
__device__ __forceinline__ int nibble_lo(int b) { return (int)((unsigned)b << 28) >> 28; }
__device__ __forceinline__ int nibble_hi(int b) { return b >> 4; }

// --------------------------------------------- modes 0 and 2: wgmma ring
constexpr int WG_BN = 128;        // output columns a block (one wgmma n128)
constexpr int WG_BM = 256;        // rows of x a block: 4 m64 tiles
constexpr int WG_BK = 64;         // contraction depth a stage: one 128-byte row
constexpr int WG_THREADS = 512;   // 2 producer / dequantizer warpgroups, 2 consumers
constexpr int WG_DQ = 224;        // dequantizer threads (warps 1-7)
// registers a thread after the split: the producer / dequantizer warpgroups
// give back what the consumers' two 64 x 128 fp32 accumulators need
constexpr int WG_REG_DQ = 96, WG_REG_MMA = 160;
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_SROWS = WG_BK / 16;  // scale rows a stage holds at most (g >= 16)
// a stage: x [xrows][64] (swizzled), B [128 n][64 k] (swizzled), codes
// [64][128] bytes, scale rows [4][128] fp32 - every part 1024-byte aligned
constexpr int WG_B_BYTES = WG_BN * 128;
constexpr int WG_C_BYTES = WG_BK * WG_BN;
constexpr int WG_S_BYTES = WG_SROWS * WG_BN * 4;
constexpr int WG_FIXED = WG_B_BYTES + WG_C_BYTES + WG_S_BYTES;
constexpr int WG_BAR_BYTES = 3 * WG_MAX_STAGES * 8;

// code -> fp32 exactly (sign-extended int in [-128, 127]): 2^23 + 128 + c
// read as a float, minus 2^23 + 128
__device__ __forceinline__ float code_f(int c) {
  return __fsub_rn(__int_as_float(0x4B000080 + c), 8388736.f);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1) wq_wgmma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ codes, const float* __restrict__ scales,
    T* __restrict__ y, float* __restrict__ part, int M, int N, int K, int g, int per, int nst,
    int xrows, int aligned, const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmc, const __grid_constant__ CUtensorMap tms) {
  // dynamic shared memory only (a static part would lower the opt-in cap):
  // the mbarriers, then the ring aligned to 1024 bytes, where the swizzle
  // pattern repeats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem_raw);  // copies landed
  uint64_t* b_full = raw_full + WG_MAX_STAGES;                  // B tile dequantized
  uint64_t* empty = raw_full + 2 * WG_MAX_STAGES;               // consumers done
  unsigned char* ring = smem_raw + WG_BAR_BYTES;
  ring += (1024 - (smem_u32(ring) & 1023)) & 1023;
  const int x_bytes = xrows * 128;
  const int stage_bytes = x_bytes + WG_FIXED;

  const int n0 = blockIdx.x * WG_BN, m0 = blockIdx.z * WG_BM;
  const int s0 = blockIdx.y * per;
  const int nit = min(s0 + per, (K + WG_BK - 1) / WG_BK) - s0;
  const int mrows = min(WG_BM, M - m0);
  const int mtiles = (mrows + 63) / 64;
  const int consumers = min(2, mtiles);
  const int wg = threadIdx.x / 128;
  const int gshift = __ffs(g) - 1;  // g is a power of two

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&raw_full[s], aligned ? 1 : 32);
      mbar_init(&b_full[s], WG_DQ);
      mbar_init(&empty[s], 128 * consumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg < 2) {
    setmaxnreg_dec<WG_REG_DQ>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0) {
      // ---- producer: the x tile, the code tile and the scale rows of
      // each stage
      const int crows = MODE == kW4 ? WG_BK / 2 : WG_BK;   // code rows a stage
      const int srows = g > WG_BK ? 1 : WG_BK >> gshift;    // scale rows a stage
      if (aligned) {
        // TMA: one thread issues three tensor copies a stage; the x tile
        // lands in the 128-byte swizzle wgmma reads, rows past M, K or N
        // are zero-filled, and the barrier completes on the bytes
        if (lane == 0)
          for (int it = 0; it < nit; ++it) {
            const int s = it % nst;
            if (it >= nst) mbar_wait(&empty[s], (it / nst - 1) & 1);
            unsigned char* st = ring + (size_t)s * stage_bytes;
            const int k0 = (s0 + it) * WG_BK;
            mbar_expect_tx(&raw_full[s], x_bytes + crows * WG_BN + srows * WG_BN * 4);
            tma_load_2d(st, &tmx, k0, m0, &raw_full[s]);
            tma_load_2d(st + x_bytes + WG_B_BYTES, &tmc, n0, MODE == kW4 ? k0 / 2 : k0,
                        &raw_full[s]);
            tma_load_2d(st + x_bytes + WG_B_BYTES + WG_C_BYTES, &tms, n0, k0 >> gshift,
                        &raw_full[s]);
          }
      } else {
        // code or scale rows not 16-byte aligned: x by 16-byte cp.async,
        // codes and scales element by element
        for (int it = 0; it < nit; ++it) {
          const int s = it % nst;
          if (it >= nst) mbar_wait(&empty[s], (it / nst - 1) & 1);
          unsigned char* st = ring + (size_t)s * stage_bytes;
          int8_t* cs = reinterpret_cast<int8_t*>(st + x_bytes + WG_B_BYTES);
          float* ss = reinterpret_cast<float*>(st + x_bytes + WG_B_BYTES + WG_C_BYTES);
          const int k0 = (s0 + it) * WG_BK, kc = min(WG_BK, K - k0);
          const T* xs = x + (size_t)m0 * K + k0;
          const int xch = kc / 8;
          for (int c = lane; c < mrows * xch; c += 32) {
            const int r = c / xch, cc = c % xch;
            cp_async16(st + r * 128 + ((cc ^ (r & 7)) << 4), xs + (size_t)r * K + cc * 8);
          }
          const int ncols = min(WG_BN, N - n0);
          const int kr = MODE == kW4 ? kc / 2 : kc, sr = g > WG_BK ? 1 : kc >> gshift;
          const int8_t* cg = codes + (size_t)(MODE == kW4 ? k0 / 2 : k0) * N + n0;
          const float* sg = scales + (size_t)(k0 >> gshift) * N + n0;
          for (int c = lane; c < kr * ncols; c += 32) {
            const int r = c / ncols, cc = c % ncols;
            cs[r * WG_BN + cc] = cg[(size_t)r * N + cc];
          }
          for (int c = lane; c < sr * ncols; c += 32) {
            const int r = c / ncols, cc = c % ncols;
            ss[r * WG_BN + cc] = sg[(size_t)r * N + cc];
          }
          cp_async_wait<0>();
          mbar_arrive(&raw_full[s]);
        }
      }
    } else {
      // ---- dequantizers: codes * scale -> B[n][k] (16-byte chunk of 8 k
      // at one n per step; a warp covers 32 consecutive n of one chunk
      // column, so its stores fill all eight swizzle positions)
      const int t = threadIdx.x - 32;
      for (int it = 0; it < nit; ++it) {
        const int s = it % nst;
        mbar_wait(&raw_full[s], (it / nst) & 1);
        unsigned char* st = ring + (size_t)s * stage_bytes;
        unsigned char* bt = st + x_bytes;
        const int8_t* cs = reinterpret_cast<const int8_t*>(bt + WG_B_BYTES);
        const float* ss = reinterpret_cast<const float*>(bt + WG_B_BYTES + WG_C_BYTES);
        const int kc = min(WG_BK, K - (s0 + it) * WG_BK);
        // a stage starts on a group boundary; for g above its depth every
        // k maps to the one staged row
        auto chunk = [&](int i) {
          const int n = i & (WG_BN - 1), c = i / WG_BN;
          const float sc = ss[(g > WG_BK ? 0 : (8 * c) >> gshift) * WG_BN + n];
          float v[8];
          if constexpr (MODE == kW8) {
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(code_f(cs[(8 * c + j) * WG_BN + n]), sc);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int b = cs[(4 * c + j) * WG_BN + n];
              v[2 * j] = __fmul_rn(code_f(nibble_lo(b)), sc);
              v[2 * j + 1] = __fmul_rn(code_f(nibble_hi(b)), sc);
            }
          }
          *reinterpret_cast<uint4*>(bt + n * 128 + ((c ^ (n & 7)) << 4)) =
              make_uint4(Mma<T>::pack(v[0], v[1]), Mma<T>::pack(v[2], v[3]),
                         Mma<T>::pack(v[4], v[5]), Mma<T>::pack(v[6], v[7]));
        };
        if (kc == WG_BK) {  // a whole stage: the same chunks every time, unrolled
          constexpr int kChunks = 8 * WG_BN;
#pragma unroll
          for (int u = 0; u < (kChunks + WG_DQ - 1) / WG_DQ; ++u)
            if (t + u * WG_DQ < kChunks) chunk(t + u * WG_DQ);
        } else {
          for (int i = t; i < (kc / 8) * WG_BN; i += WG_DQ) chunk(i);
        }
        fence_proxy_async();
        mbar_arrive(&b_full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns row tiles cw and cw + 2
  setmaxnreg_inc<WG_REG_MMA>();
  const int cw = wg - 2;
  if (cw >= consumers) return;
  const bool two = cw + 2 < mtiles;
  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[0][j] = acc[1][j] = 0.f;
  for (int it = 0; it < nit; ++it) {
    const int s = it % nst;
    mbar_wait(&b_full[s], (it / nst) & 1);
    fence_proxy_async();
    const unsigned char* st = ring + (size_t)s * stage_bytes;
    const int kc = min(WG_BK, K - (s0 + it) * WG_BK);
    wg_fence_regs(acc[0]);
    wg_fence_regs(acc[1]);
    wg_fence();
    for (int kk = 0; kk < kc / 16; ++kk) {
      const uint64_t db = wg_desc(st + x_bytes + kk * 32);
      Wgmma<T>::ss128(acc[0], wg_desc(st + cw * 64 * 128 + kk * 32), db);
      if (two) Wgmma<T>::ss128(acc[1], wg_desc(st + (cw + 2) * 64 * 128 + kk * 32), db);
    }
    wg_commit();
    wg_wait<0>();
    wg_fence_regs(acc[0]);
    wg_fence_regs(acc[1]);
    mbar_arrive(&empty[s]);
  }

  // accumulator layout: warp w of the warpgroup holds rows 16w..16w+15 of
  // the 64-row tile, each n8 slice j as mma.sync's C fragment:
  // acc[4j + 2h + e] = (row 16w + lane/4 + 8h, column 8j + 2(lane%4) + e)
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q == 1 && !two) break;
    const int rbase = m0 + (cw + 2 * q) * 64 + w * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[q][4 * j + 2 * h], v1 = acc[q][4 * j + 2 * h + 1];
        if (part != nullptr) {  // split-K: fp32 partial of split blockIdx.y
          float* pr = part + ((size_t)blockIdx.y * M + row) * N;
          if (col < N) pr[col] = v0;
          if (col + 1 < N) pr[col + 1] = v1;
        } else if ((N & 1) == 0 && col + 1 < N) {
          *reinterpret_cast<uint32_t*>(y + (size_t)row * N + col) = Mma<T>::pack(v0, v1);
        } else {
          if (col < N) y[(size_t)row * N + col] = Bits<T>::from_f(v0);
          if (col + 1 < N) y[(size_t)row * N + col + 1] = Bits<T>::from_f(v1);
        }
      }
    }
  }
}

// ------------------------------------- mode 1: the swapped wgmma product
// y^T [V, M] = W [V, H] . x^T: the dequantized code tile is wgmma's A
// operand (m64 over vocabulary rows, K-major as the codes are stored) and
// x's K-major tile its B operand (n = M padded to 16 / 32 / 64 / 128), so no
// tensor-core row is padding at decode.  A block is persistent: it walks
// work items (128-row tile of V, 128-row block of x, split of K) t =
// blockIdx.x, t + gridDim.x, ..., and its ring of stages runs across item
// boundaries, so one item's epilogue overlaps the next item's loads.  What
// bounds it is the code bytes and, close behind, their dequantization (3-4
// instructions a weight), so the dequantization has every warp but the
// producer:
//   - warp 0 (producer): one thread keeps the TMA copies of each 64-deep
//     stage in flight (x tile in wgmma's 128-byte swizzle, code tile [128
//     v][64 k] bytes, its scale rows [128/g or 1][64] fp32);
//   - warps 1-7 (dequantizers) and each consumer warpgroup for its own 64
//     rows share the A tile [128 v][64 k]: code * scale in fp32 (each code
//     exact in fp32 by one byte permute), rounded once to T, written in
//     the 128-byte swizzle 8 k (one 16-byte chunk) at a time from 8-byte
//     code reads and scale reads (once a stage for a group of 128 rows or
//     more), no transpose; the dequantizers take the first 32 rows of each
//     consumer's 64, the consumer the other 32 (at decode the consumers'
//     products take little time);
//   - warpgroups 2 and 3 (consumers): rows 0-63 and 64-127 of the tile,
//     wgmma m64nNPk16; the epilogue stages y^T through shared memory so
//     that y's rows are stored 16 bytes a thread.
// Every consumer issues every wgmma on every path (the warpgroup index
// comes through __shfl_sync, the mbarrier spin sits inside its asm): ptxas
// keeps them asynchronous.
constexpr int WT_BN = 128;       // rows of V (output columns) a tile
constexpr int WT_BK = 64;        // contraction depth a stage
constexpr int WT_MAX_NP = 128;   // rows of x a block (wgmma n)
constexpr int WT_MAX_STAGES = 8;
constexpr int WT_SROWS = WT_BN / 16;  // scale rows a stage holds at most (g >= 16)
constexpr int WT_A_BYTES = WT_BN * 128;
constexpr int WT_C_BYTES = WT_BN * WT_BK;
constexpr int WT_S_BYTES = WT_SROWS * WT_BK * 4;
constexpr int WT_YPITCH = WT_BN + 8;  // epilogue row (elements), off the banks' period
constexpr int WT_BAR_BYTES = 3 * WT_MAX_STAGES * 8;

// the x rows a block takes (wgmma n): M rounded up to 16, 32, 64 or 128
__host__ __device__ inline int wt_np(int M) {
  return M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : WT_MAX_NP;
}
__host__ __device__ inline int wt_stage_bytes(int np) {
  return np * 128 + WT_A_BYTES + WT_C_BYTES + WT_S_BYTES;
}
// shared memory: mbarriers, 1024 bytes of alignment slack, the ring, the
// epilogue tile [np][WT_YPITCH] of 16-bit y
__host__ __device__ inline size_t wt_smem(int np, int stages) {
  return WT_BAR_BYTES + 1024 + (size_t)stages * wt_stage_bytes(np) + (size_t)np * WT_YPITCH * 2;
}

// The 8 scales of row v's group for k 8c..8c+7 of the staged scale rows
// (a group of at least the tile's 128 rows: the one staged row)
__device__ __forceinline__ void wt_scales(const float* ss, int v, int c, int g, int gshift,
                                          float (&sc)[8]) {
  const float* sr = ss + (g >= WT_BN ? 0 : v >> gshift) * WT_BK + 8 * c;
  const float4 s0 = *reinterpret_cast<const float4*>(sr);
  const float4 s1 = *reinterpret_cast<const float4*>(sr + 4);
  sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
  sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
}

// One 16-byte chunk of the A tile: row v, k 8c..8c+7 of the staged codes
// [128][64] times its scales, dequantized into the 128-byte swizzle.
template <typename T>
__device__ __forceinline__ void wt_chunk(const int8_t* cs, const float (&sc)[8], unsigned char* at,
                                         int v, int c) {
  const uint2 cb = *reinterpret_cast<const uint2*>(cs + v * WT_BK + 8 * c);
  const uint32_t bx = cb.x ^ 0x80808080u, by = cb.y ^ 0x80808080u;
  float f[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = __fmul_rn(biased_code(bx, j), sc[j]);
    f[4 + j] = __fmul_rn(biased_code(by, j), sc[4 + j]);
  }
  *reinterpret_cast<uint4*>(at + v * 128 + ((c ^ (v & 7)) << 4)) =
      make_uint4(Mma<T>::pack(f[0], f[1]), Mma<T>::pack(f[2], f[3]), Mma<T>::pack(f[4], f[5]),
                 Mma<T>::pack(f[6], f[7]));
}

// Chunks i = t, t + step, ... below n, 8 a row: local row i / 8 of the
// 32-row blocks base, base + 64, ..., column i % 8.  A warp covers 4 whole
// rows (its code reads and swizzled stores conflict-free), and a thread's
// column stays t % 8 (step % 8 == 0), so with a group of at least the
// tile's rows its scales are read once a stage.
template <typename T, int U>
__device__ __forceinline__ void wt_chunks(const int8_t* cs, const float* ss, unsigned char* at,
                                          int t, int step, int n, int base, int g, int gshift) {
  const int c = t % 8;
  float sc[8];
  if (g >= WT_BN) wt_scales(ss, 0, c, g, gshift, sc);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = t + u * step;
    if (i < n) {
      const int lr = i / 8, v = base + (lr / 32) * 64 + lr % 32;
      if (g < WT_BN) wt_scales(ss, v, c, g, gshift, sc);
      wt_chunk<T>(cs, sc, at, v, c);
    }
  }
}

template <int NP> struct WgmmaN;
template <> struct WgmmaN<16> {
  template <typename T> static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b) { Wgmma<T>::ss16(d, a, b); }
};
template <> struct WgmmaN<32> {
  template <typename T> static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) { Wgmma<T>::ss32(d, a, b); }
};
template <> struct WgmmaN<64> {
  template <typename T> static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) { Wgmma<T>::ss64(d, a, b); }
};
template <> struct WgmmaN<128> {
  template <typename T> static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) { Wgmma<T>::ss128(d, a, b); }
};

template <typename T, int NP>
__global__ void __launch_bounds__(512, 1) wq_t_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ codes, const float* __restrict__ scales,
    T* __restrict__ y, float* __restrict__ part, int M, int N, int K, int g, int per, int splits,
    int nst, int aligned, const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmc, const __grid_constant__ CUtensorMap tms) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem_raw);  // copies landed
  uint64_t* a_full = raw_full + WT_MAX_STAGES;                  // dequantizers' rows done
  uint64_t* empty = raw_full + 2 * WT_MAX_STAGES;               // consumers done
  unsigned char* ring = smem_raw + WT_BAR_BYTES;
  ring += (1024 - (smem_u32(ring) & 1023)) & 1023;
  constexpr int X_BYTES = NP * 128;
  constexpr int STAGE = X_BYTES + WT_A_BYTES + WT_C_BYTES + WT_S_BYTES;
  T* ys = reinterpret_cast<T*>(ring + (size_t)nst * STAGE);  // epilogue [NP][WT_YPITCH]

  const int tiles = (N + WT_BN - 1) / WT_BN, rblocks = (M + NP - 1) / NP;
  const int items = tiles * rblocks * splits;
  const int nsteps = (K + WT_BK - 1) / WT_BK;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int gshift = __ffs(g) - 1;  // g is a power of two
  // item -> (tile n0, x rows m0, steps [k0s, k1s))
  auto item_at = [&](int t, int& n0, int& m0, int& k0s, int& k1s) {
    n0 = (t % tiles) * WT_BN;
    m0 = ((t / tiles) % rblocks) * NP;
    k0s = (t / (tiles * rblocks)) * per;
    k1s = min(k0s + per, nsteps);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&raw_full[s], aligned ? 1 : 32);
      mbar_init(&a_full[s], 224);
      mbar_init(&empty[s], 256);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg < 2) {
    setmaxnreg_dec<WG_REG_DQ>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0) {
      // ---- producer
      const int srows = g >= WT_BN ? 1 : WT_BN >> gshift;
      int it = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        int n0, m0, k0s, k1s;
        item_at(t, n0, m0, k0s, k1s);
        for (int step = k0s; step < k1s; ++step, ++it) {
          const int s = it % nst;
          if (it >= nst) mbar_wait(&empty[s], (it / nst - 1) & 1);
          unsigned char* st = ring + (size_t)s * STAGE;
          const int k0 = step * WT_BK;
          if (aligned) {
            if (lane == 0) {
              mbar_expect_tx(&raw_full[s], X_BYTES + WT_C_BYTES + srows * WT_BK * 4);
              tma_load_2d(st, &tmx, k0, m0, &raw_full[s]);
              tma_load_2d(st + X_BYTES + WT_A_BYTES, &tmc, k0, n0, &raw_full[s]);
              tma_load_2d(st + X_BYTES + WT_A_BYTES + WT_C_BYTES, &tms, k0, n0 >> gshift,
                          &raw_full[s]);
            }
            continue;
          }
          // code or scale rows not 16-byte aligned: x by 16-byte cp.async
          // (rows past M and k past K zeroed), codes and scales element
          // by element (past N or K: zero)
          const int kc = min(WT_BK, K - k0);
          for (int c = lane; c < NP * 8; c += 32) {
            const int r = c / 8, cc = c % 8;
            unsigned char* dst = st + r * 128 + ((cc ^ (r & 7)) << 4);
            if (m0 + r < M && cc * 8 < kc)
              cp_async16(dst, x + (size_t)(m0 + r) * K + k0 + cc * 8);
            else
              *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          }
          int8_t* cs = reinterpret_cast<int8_t*>(st + X_BYTES + WT_A_BYTES);
          float* ss = reinterpret_cast<float*>(st + X_BYTES + WT_A_BYTES + WT_C_BYTES);
          for (int c = lane; c < WT_BN * WT_BK; c += 32) {
            const int r = c / WT_BK, k = c % WT_BK;
            cs[c] = n0 + r < N && k < kc ? codes[(size_t)(n0 + r) * K + k0 + k] : 0;
          }
          const int sr0 = n0 >> gshift, nsr = (N + g - 1) >> gshift;
          for (int c = lane; c < srows * WT_BK; c += 32) {
            const int r = c / WT_BK, k = c % WT_BK;
            ss[c] = sr0 + r < nsr && k < kc ? scales[(size_t)(sr0 + r) * K + k0 + k] : 0.f;
          }
          cp_async_wait<0>();
          fence_proxy_async();  // x, written here, is read by wgmma
          mbar_arrive(&raw_full[s]);
        }
      }
    } else {
      // ---- dequantizers: rows 0-31 and 64-95 of the tile
      const int t = threadIdx.x - 32;
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int n0, m0, k0s, k1s;
        item_at(item, n0, m0, k0s, k1s);
        for (int step = k0s; step < k1s; ++step, ++it) {
          const int s = it % nst;
          mbar_wait(&raw_full[s], (it / nst) & 1);
          unsigned char* st = ring + (size_t)s * STAGE;
          unsigned char* at = st + X_BYTES;
          const int8_t* cs = reinterpret_cast<const int8_t*>(at + WT_A_BYTES);
          const float* ss = reinterpret_cast<const float*>(at + WT_A_BYTES + WT_C_BYTES);
          wt_chunks<T, (WT_BN * 4 + 223) / 224>(cs, ss, at, t, 224, WT_BN * 4, 0, g, gshift);
          fence_proxy_async();
          mbar_arrive(&a_full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of a tile,
  // and dequantizes the last 32 of them itself
  setmaxnreg_inc<WG_REG_MMA>();
  const int cw = wg - 2;
  const int ct = threadIdx.x - 256;  // 0..255 over both consumer warpgroups
  const int wt = threadIdx.x % 128;  // 0..127 in this warpgroup
  const int w = wt / 32, lane = threadIdx.x % 32;
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int n0, m0, k0s, k1s;
    item_at(item, n0, m0, k0s, k1s);
    float acc[NP / 2];
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) acc[j] = 0.f;
    for (int step = k0s; step < k1s; ++step, ++it) {
      const int s = it % nst;
      const unsigned char* st = ring + (size_t)s * STAGE;
      unsigned char* at = const_cast<unsigned char*>(st) + X_BYTES;
      mbar_wait(&raw_full[s], (it / nst) & 1);
      wt_chunks<T, 2>(reinterpret_cast<const int8_t*>(at + WT_A_BYTES),
                      reinterpret_cast<const float*>(at + WT_A_BYTES + WT_C_BYTES), at, wt, 128,
                      256, 64 * cw + 32, g, gshift);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");  // this warpgroup's rows
      mbar_wait(&a_full[s], (it / nst) & 1);                         // the dequantizers' rows
      wg_fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WT_BK / 16; ++kk)
        WgmmaN<NP>::template run<T>(acc, wg_desc(at + cw * 64 * 128 + kk * 32),
                                    wg_desc(st + kk * 32));
      wg_commit();
      wg_wait<0>();
      wg_fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    // acc[4j + 2h + e] = y^T (v = 64 cw + 16 w + lane/4 + 8h, m = 8j +
    // 2 (lane%4) + e)
    const int split = item / (tiles * rblocks);
    if (part != nullptr) {  // split-K: fp32 partial of this split
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = n0 + 64 * cw + 16 * w + lane / 4 + 8 * h;
            const int m = m0 + 8 * j + 2 * (lane % 4) + e;
            if (v < N && m < M) part[((size_t)split * M + m) * N + v] = acc[4 * j + 2 * h + e];
          }
      continue;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the last item's stores have read ys
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ys[(8 * j + 2 * (lane % 4) + e) * WT_YPITCH + 64 * cw + 16 * w + lane / 4 + 8 * h] =
              Bits<T>::from_f(acc[4 * j + 2 * h + e]);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const bool vec = (N & 7) == 0;
    for (int c = ct; c < NP * (WT_BN / 8); c += 256) {
      const int r = c / (WT_BN / 8), v = 8 * (c % (WT_BN / 8));
      if (m0 + r >= M || n0 + v >= N) continue;
      const T* src = ys + r * WT_YPITCH + v;
      T* dst = y + (size_t)(m0 + r) * N + n0 + v;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && n0 + v + e < N; ++e) dst[e] = src[e];
      }
    }
  }
}

// fp32 x: CUDA-core tiles of 32 rows x 64 columns, 32 deep; every thread
// owns 2 rows x 4 columns (columns strided by 16 for conflict-free reads).
constexpr int WQS_BM = 32, WQS_BN = 64, WQS_KC = 32;

template <int MODE>
__device__ __forceinline__ float wq_weight(const int8_t* __restrict__ codes,
                                           const float* __restrict__ scales, int N, int K, int g,
                                           int k, int n) {
  if constexpr (MODE == kW8T) {
    return (float)codes[(size_t)n * K + k] * scales[(size_t)(n / g) * K + k];
  } else if constexpr (MODE == kW8) {
    return (float)codes[(size_t)k * N + n] * scales[(size_t)(k / g) * N + n];
  } else {
    const int b = codes[(size_t)(k / 2) * N + n];
    const int q = (k & 1) ? nibble_hi(b) : nibble_lo(b);
    return (float)q * scales[(size_t)(k / g) * N + n];
  }
}

template <int MODE>
__global__ void __launch_bounds__(256) wq_simt_kernel(const float* __restrict__ x,
                                                      const int8_t* __restrict__ codes,
                                                      const float* __restrict__ scales,
                                                      float* __restrict__ y, int M, int N, int K,
                                                      int g) {
  __shared__ float xs[WQS_BM][WQS_KC + 1];
  __shared__ float ws[WQS_KC][WQS_BN + 1];
  const int n0 = blockIdx.x * WQS_BN, m0 = blockIdx.y * WQS_BM;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += WQS_KC) {
    for (int i = tid; i < WQS_BM * WQS_KC; i += 256) {
      const int r = i / WQS_KC, c = i % WQS_KC;
      xs[r][c] = (m0 + r < M && k0 + c < K) ? x[(size_t)(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < WQS_KC * WQS_BN; i += 256) {
      const int k = i / WQS_BN, n = i % WQS_BN;
      ws[k][n] = (k0 + k < K && n0 + n < N)
                     ? wq_weight<MODE>(codes, scales, N, K, g, k0 + k, n0 + n)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < WQS_KC; ++k) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xs[ty + 16 * i][k] * ws[k][tx + 16 * j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) y[(size_t)row * N + col] = acc[i][j];
    }
  }
}

// y = the splits' fp32 partials summed in split order, cast once to T
template <typename T>
__global__ void wq_reduce_kernel(const float* __restrict__ part, T* __restrict__ y, size_t MN,
                                 int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += part[z * MN + i];
    y[i] = Bits<T>::from_f(v);
  }
}

// K steps of `kt` a split owns; every split must own at least one
inline int split_per(int K, int kt, int splits, float* part) {
  const int nsteps = (K + kt - 1) / kt;
  const int per = (nsteps + splits - 1) / splits;
  if ((nsteps + per - 1) / per != splits || (splits > 1) != (part != nullptr)) return 0;
  return per;
}

template <typename T>
cudaError_t launch_reduce(float* part, void* y, int M, int N, int splits, cudaStream_t stream) {
  const size_t MN = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((MN + 255) / 256, 4096);
  wq_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, static_cast<T*>(y), MN, splits);
  return cudaGetLastError();
}

template <typename T, int NP>
cudaError_t launch_t_np(const void* x, const int8_t* codes, const float* scales, void* y,
                        float* part, int M, int N, int K, int g, int splits, int stages,
                        int aligned, int sms, cudaStream_t stream) {
  const int per = split_per(K, WT_BK, splits, part);
  if (per == 0 || stages < 1 || stages > WT_MAX_STAGES) return cudaErrorInvalidValue;
  // aligned rows: the producer's tensor maps (x [M, K] in the 128-byte
  // swizzle; codes [N, K] bytes; scales [N/g, K] fp32)
  CUtensorMap tmx{}, tmc{}, tms{};
  if (aligned) {
    const CUtensorMapDataType xt = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!tensor_map(&tmx, xt, 2, x, M, K, NP, WT_BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&tmc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, N, K, WT_BN, WT_BK,
                    CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !tensor_map(&tms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, N / g, K,
                    g >= WT_BN ? 1 : WT_BN / g, WT_BK, CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_dynamic_smem<wq_t_kernel<T, NP>>();
  if (err != cudaSuccess) return err;
  const int items = (N + WT_BN - 1) / WT_BN * ((M + NP - 1) / NP) * splits;
  wq_t_kernel<T, NP><<<std::min(items, sms), 512, wt_smem(NP, stages), stream>>>(
      static_cast<const T*>(x), codes, scales, static_cast<T*>(y), part, M, N, K, g, per, splits,
      stages, aligned, tmx, tmc, tms);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<T>(part, y, M, N, splits, stream);
}

template <typename T>
cudaError_t launch_t(const void* x, const int8_t* codes, const float* scales, void* y,
                     float* part, int M, int N, int K, int g, int splits, int stages, int aligned,
                     cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  switch (wt_np(M)) {
    case 16: return launch_t_np<T, 16>(x, codes, scales, y, part, M, N, K, g, splits, stages, aligned, sms, stream);
    case 32: return launch_t_np<T, 32>(x, codes, scales, y, part, M, N, K, g, splits, stages, aligned, sms, stream);
    case 64: return launch_t_np<T, 64>(x, codes, scales, y, part, M, N, K, g, splits, stages, aligned, sms, stream);
    default: return launch_t_np<T, 128>(x, codes, scales, y, part, M, N, K, g, splits, stages, aligned, sms, stream);
  }
}

// shared memory of the wgmma kernel: `stages` stages for x tiles of xrows
// rows, the mbarriers and the slack that aligns the ring to 1024 bytes
inline size_t wgmma_smem(int xrows, int stages) {
  return (size_t)stages * (xrows * 128 + WG_FIXED) + WG_BAR_BYTES + 1024;
}

template <typename T, int MODE>
cudaError_t launch_wgmma(const void* x, const int8_t* codes, const float* scales, void* y,
                         float* part, int M, int N, int K, int g, int splits, int stages,
                         int aligned, cudaStream_t stream) {
  const int xrows = std::min(WG_BM, (M + 63) / 64 * 64);
  const size_t smem = wgmma_smem(xrows, stages);
  const int per = split_per(K, WG_BK, splits, part);
  if (per == 0 || stages < 1 || stages > WG_MAX_STAGES) return cudaErrorInvalidValue;
  // aligned rows: the producer's tensor maps (x in the 128-byte swizzle;
  // codes [K, N] or [K/2, N] bytes; scales [K/g, N] fp32)
  CUtensorMap tmx{}, tmc{}, tms{};
  if (aligned) {
    const int crows = MODE == kW4 ? WG_BK / 2 : WG_BK, srows = g > WG_BK ? 1 : WG_BK / g;
    const CUtensorMapDataType xt = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!tensor_map(&tmx, xt, 2, x, M, K, xrows, WG_BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&tmc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, MODE == kW4 ? K / 2 : K, N,
                    crows, WG_BN, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !tensor_map(&tms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, K / g, N, srows, WG_BN,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_dynamic_smem<wq_wgmma_kernel<T, MODE>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + WG_BN - 1) / WG_BN, splits, (M + WG_BM - 1) / WG_BM);
  wq_wgmma_kernel<T, MODE><<<grid, WG_THREADS, smem, stream>>>(
      static_cast<const T*>(x), codes, scales, static_cast<T*>(y), part, M, N, K, g, per,
      stages, xrows, aligned, tmx, tmc, tms);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<T>(part, y, M, N, splits, stream);
}

template <typename T>
cudaError_t launch_16bit(int mode, const void* x, const int8_t* codes, const float* scales,
                         void* y, float* part, int M, int N, int K, int g, int splits,
                         int stages, int aligned, cudaStream_t st) {
  switch (mode) {
    case kW8: return launch_wgmma<T, kW8>(x, codes, scales, y, part, M, N, K, g, splits, stages, aligned, st);
    case kW8T: return launch_t<T>(x, codes, scales, y, part, M, N, K, g, splits, stages, aligned, st);
    case kW4: return launch_wgmma<T, kW4>(x, codes, scales, y, part, M, N, K, g, splits, stages, aligned, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
cudaError_t launch_simt(const void* x, const int8_t* codes, const float* scales, void* y, int M,
                        int N, int K, int g, cudaStream_t st) {
  const dim3 grid((N + WQS_BN - 1) / WQS_BN, (M + WQS_BM - 1) / WQS_BM);
  wq_simt_kernel<MODE><<<grid, 256, 0, st>>>(static_cast<const float*>(x), codes, scales,
                                              static_cast<float*>(y), M, N, K, g);
  return cudaGetLastError();
}

}  // namespace dsk

// x [M, K] (mode 1: [M, H], K = H); codes int8 [K, N] (mode 1: [N, K],
// mode 2: [K/2, N]); scales fp32 [K/g, N] (mode 1: [N/g, K]); y [M, N].
// g: power of two >= 16 dividing the grouped dim.  K % 16 == 0.
// aligned: code and scale rows are 16-byte aligned (TMA / cp.async);
// else element-wise loads.  splits > 1 (16-bit x only): K steps split over that
// many blocks a tile, partials in part [splits, M, N] fp32; every split
// must own a 64-deep step.  stages: the wgmma kernels' ring depth (16-bit
// x; 1..8, within the card's shared memory: see wgmma_smem for modes 0 / 2,
// wt_smem for mode 1).  dtype: 0 fp32, 1 fp16, 2 bf16.
extern "C" int ds_wq_matmul(const void* x, const void* codes, const void* scales, void* y,
                            void* part, int M, int N, int K, int g, int mode, int aligned,
                            int splits, int stages, int dtype, void* stream) {
  if (g < 16 || (g & (g - 1)) || K % 16 || splits < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int8_t*>(codes);
  auto s = static_cast<const float*>(scales);
  auto p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      if (splits != 1) return (int)cudaErrorInvalidValue;
      switch (mode) {
        case dsk::kW8: return (int)dsk::launch_simt<dsk::kW8>(x, c, s, y, M, N, K, g, st);
        case dsk::kW8T: return (int)dsk::launch_simt<dsk::kW8T>(x, c, s, y, M, N, K, g, st);
        case dsk::kW4: return (int)dsk::launch_simt<dsk::kW4>(x, c, s, y, M, N, K, g, st);
        default: return (int)cudaErrorInvalidValue;
      }
    case 1: return (int)dsk::launch_16bit<__half>(mode, x, c, s, y, p, M, N, K, g, splits, stages, aligned, st);
    case 2: return (int)dsk::launch_16bit<__nv_bfloat16>(mode, x, c, s, y, p, M, N, K, g, splits, stages, aligned, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

