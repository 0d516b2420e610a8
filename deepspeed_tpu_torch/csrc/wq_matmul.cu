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
// ridge.  So the design point is that every weight byte is read from HBM
// once: the grid covers N (one 128-column tile a block), and a block loops
// over its share of K, so for M <= 64 no code byte is read twice.  A block
// keeps only one 16 KB step of codes in flight, so few blocks leave HBM
// idle: where the column tiles are fewer than two waves of the card (k / v:
// 8 tiles), K is split across blocks (split-K) until there are, each split
// writing fp32 partials that a second small kernel sums in a fixed order
// and casts once.  At prefill sizes (M = 256: 4 row tiles) the products do
// enough work per byte that the tensor cores matter:
//   - 16-bit x: mma.sync m16n8k16 (fp32 accumulate); 8 warps a block, each
//     owning 16 output columns over the 64-row tile; row tiles past M are
//     skipped (decode runs one of four).
//   - the block walks K in 128-deep steps: for g <= 128 (g | 128) a step
//     holds 128/g whole groups and a scale row per group, for g > 128 (a
//     multiple of 128) it lies inside one group and needs its one scale
//     row, k0 / g; the x tile, the code tile and
//     its scale rows stream into shared memory with 16-byte cp.async,
//     double-buffered (the next step's bytes are in flight while this step
//     dequantizes and multiplies); the code tile is then dequantized into a
//     16-bit tile in the layout the B fragments read ([k][n] for modes 0/2,
//     [n][k] for mode 1, 8-element row pads against bank conflicts).
//   - fp32 x: a CUDA-core version (32 x 64 tiles, same dequantization),
//     used where exact fp32 is the point (tests, cuda-vs-cpu parity).
// Code rows whose length or base is not 16-byte aligned are loaded element
// by element.  wgmma, TMA and a deeper pipeline are later work.
#include "paged_common.cuh"

#include <algorithm>

namespace dsk {

constexpr int WQ_BM = 64;        // output rows a block
constexpr int WQ_BN = 128;       // output columns a block
constexpr int WQ_KT = 128;       // contraction depth a step
constexpr int WQ_THREADS = 256;  // 8 warps
constexpr int WQ_LDX = WQ_KT + 8;  // x tile row (elements)
constexpr int WQ_LDW = WQ_BN + 8;  // [k][n] dequantized tile row (modes 0, 2)
constexpr int WQ_LDT = WQ_KT + 8;  // [n][k] dequantized tile row (mode 1)
constexpr int WQ_SROWS = 8;        // scale rows a step holds at most (g >= 16)

enum { kW8 = 0, kW8T = 1, kW4 = 2 };

template <typename T>
struct WqSmem {
  static constexpr size_t x_elems = (size_t)WQ_BM * WQ_LDX;
  static constexpr size_t code_bytes = (size_t)WQ_KT * WQ_BN;
  static constexpr size_t scale_floats = (size_t)WQ_SROWS * WQ_KT;  // >= 8*BN too
  static constexpr size_t w_elems = (size_t)WQ_KT * WQ_LDW;        // == BN*LDT
  static constexpr size_t bytes = 2 * x_elems * sizeof(T) + 2 * code_bytes +
                                  2 * scale_floats * sizeof(float) + w_elems * sizeof(T);
};

// Stage one K step (k0 .. k0+kc) of x, the codes and their scale rows into
// one shared-memory buffer set, and commit one cp.async group.  Rows of x
// past M and code columns past N are not loaded: they only ever feed output
// rows / columns that are not stored.
template <typename T, int MODE>
__device__ __forceinline__ void wq_stage(const T* __restrict__ x, const int8_t* __restrict__ codes,
                                         const float* __restrict__ scales, T* xs, int8_t* cs,
                                         float* ss, int M, int N, int K, int g, int m0, int n0,
                                         int k0, int kc, bool aligned) {
  const int tid = threadIdx.x;
  constexpr int XCH = 16 / (int)sizeof(T);
  const int xch = kc / XCH;
  const int mrows = min(WQ_BM, M - m0);
  for (int c = tid; c < mrows * xch; c += WQ_THREADS) {
    const int r = c / xch, cc = c % xch;
    cp_async16(xs + r * WQ_LDX + cc * XCH, x + (size_t)(m0 + r) * K + k0 + cc * XCH);
  }
  if constexpr (MODE == kW8T) {
    // codes [V, H]: rows n0.. (live: < N), columns k0..k0+kc -> cs[n][KT]
    const int nrows = min(WQ_BN, N - n0);
    if (aligned) {
      const int ch = kc / 16;
      for (int c = tid; c < nrows * ch; c += WQ_THREADS) {
        const int r = c / ch, cc = c % ch;
        cp_async16(cs + r * WQ_KT + cc * 16, codes + (size_t)(n0 + r) * K + k0 + cc * 16);
      }
    } else {
      for (int c = tid; c < nrows * kc; c += WQ_THREADS) {
        const int r = c / kc, cc = c % kc;
        cs[r * WQ_KT + cc] = codes[(size_t)(n0 + r) * K + k0 + cc];
      }
    }
    // scales [V/g, H]: rows n0/g .. (live), columns k0..k0+kc -> ss[j][KT];
    // a group of g >= BN columns covers the whole tile with one row
    const int srows = g >= WQ_BN ? 1 : min(WQ_BN / g, (N - n0 + g - 1) / g);
    if (aligned) {
      const int ch = kc / 4;
      for (int c = tid; c < srows * ch; c += WQ_THREADS) {
        const int r = c / ch, cc = c % ch;
        cp_async16(ss + r * WQ_KT + cc * 4, scales + (size_t)(n0 / g + r) * K + k0 + cc * 4);
      }
    } else {
      for (int c = tid; c < srows * kc; c += WQ_THREADS) {
        const int r = c / kc, cc = c % kc;
        ss[r * WQ_KT + cc] = scales[(size_t)(n0 / g + r) * K + k0 + cc];
      }
    }
  } else {
    // codes [K, N] (mode 2: [K/2, N] bytes): rows of this step, columns
    // n0 .. n0+BN (live: < N) -> cs[row][BN]
    const int crow0 = MODE == kW4 ? k0 / 2 : k0;
    const int crows = MODE == kW4 ? kc / 2 : kc;
    const int ncols = min(WQ_BN, N - n0);
    if (aligned) {  // N % 16 == 0: a 16-byte chunk is wholly in or out
      const int ch = (ncols + 15) / 16;
      for (int c = tid; c < crows * ch; c += WQ_THREADS) {
        const int r = c / ch, cc = c % ch;
        cp_async16(cs + r * WQ_BN + cc * 16, codes + (size_t)(crow0 + r) * N + n0 + cc * 16);
      }
    } else {
      for (int c = tid; c < crows * ncols; c += WQ_THREADS) {
        const int r = c / ncols, cc = c % ncols;
        cs[r * WQ_BN + cc] = codes[(size_t)(crow0 + r) * N + n0 + cc];
      }
    }
    // scales [K/g, N]: kc/g rows -> ss[j][BN]; a group of g > KT rows holds
    // the whole step, one row (k0 / g)
    const int srows = g > WQ_KT ? 1 : kc / g;
    if (aligned) {
      const int ch = (ncols + 3) / 4;
      for (int c = tid; c < srows * ch; c += WQ_THREADS) {
        const int r = c / ch, cc = c % ch;
        cp_async16(ss + r * WQ_BN + cc * 4, scales + (size_t)(k0 / g + r) * N + n0 + cc * 4);
      }
    } else {
      for (int c = tid; c < srows * ncols; c += WQ_THREADS) {
        const int r = c / ncols, cc = c % ncols;
        ss[r * WQ_BN + cc] = scales[(size_t)(k0 / g + r) * N + n0 + cc];
      }
    }
  }
  cp_async_commit();
}

// the low / high 4-bit code of a sign-extended byte, sign-extended
__device__ __forceinline__ int nibble_lo(int b) { return (int)((unsigned)b << 28) >> 28; }
__device__ __forceinline__ int nibble_hi(int b) { return b >> 4; }

// Dequantize the staged step into the 16-bit tile wd: code * scale in fp32,
// rounded once to T.  Tile-local k / g (n / g) picks the staged scale row:
// the step (tile) starts on a group boundary, and for g above the step's
// depth (width) every local index maps to row 0.
template <typename T, int MODE>
__device__ __forceinline__ void wq_dequant(const int8_t* cs, const float* ss, T* wd, int g,
                                           int kc) {
  const int tid = threadIdx.x;
  if constexpr (MODE == kW8T) {
    const int per_row = kc / 4;
    for (int i = tid; i < WQ_BN * per_row; i += WQ_THREADS) {
      const int n = i / per_row, k = (i % per_row) * 4;
      const char4 c = *reinterpret_cast<const char4*>(cs + n * WQ_KT + k);
      const float4 s = *reinterpret_cast<const float4*>(ss + (n / g) * WQ_KT + k);
      const float v[4] = {(float)c.x * s.x, (float)c.y * s.y, (float)c.z * s.z, (float)c.w * s.w};
      store4<T>(wd + n * WQ_LDT + k, v);
    }
  } else if constexpr (MODE == kW8) {
    constexpr int per_row = WQ_BN / 4;
    for (int i = tid; i < kc * per_row; i += WQ_THREADS) {
      const int k = i / per_row, n = (i % per_row) * 4;
      const char4 c = *reinterpret_cast<const char4*>(cs + k * WQ_BN + n);
      const float4 s = *reinterpret_cast<const float4*>(ss + (k / g) * WQ_BN + n);
      const float v[4] = {(float)c.x * s.x, (float)c.y * s.y, (float)c.z * s.z, (float)c.w * s.w};
      store4<T>(wd + k * WQ_LDW + n, v);
    }
  } else {
    constexpr int per_row = WQ_BN / 4;
    for (int i = tid; i < (kc / 2) * per_row; i += WQ_THREADS) {
      const int kk = i / per_row, n = (i % per_row) * 4;
      const char4 c = *reinterpret_cast<const char4*>(cs + kk * WQ_BN + n);
      const float4 s = *reinterpret_cast<const float4*>(ss + ((2 * kk) / g) * WQ_BN + n);
      const int b[4] = {c.x, c.y, c.z, c.w};  // sign-extended bytes
      const float sc[4] = {s.x, s.y, s.z, s.w};
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = (float)nibble_lo(b[j]) * sc[j];
        hi[j] = (float)nibble_hi(b[j]) * sc[j];
      }
      store4<T>(wd + (2 * kk) * WQ_LDW + n, lo);
      store4<T>(wd + (2 * kk + 1) * WQ_LDW + n, hi);
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(WQ_THREADS) wq_mma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ codes, const float* __restrict__ scales,
    T* __restrict__ y, float* __restrict__ part, int M, int N, int K, int g, int per,
    int aligned) {
  using L = WqSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                                  // [2][BM][LDX]
  int8_t* cs = reinterpret_cast<int8_t*>(xs + 2 * L::x_elems);         // [2][code_bytes]
  float* ss = reinterpret_cast<float*>(cs + 2 * L::code_bytes);        // [2][scale_floats]
  T* wd = reinterpret_cast<T*>(ss + 2 * L::scale_floats);              // [w_elems]

  const int n0 = blockIdx.x * WQ_BN, m0 = blockIdx.y * WQ_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int mrows = min(WQ_BM, M - m0);
  const int mtiles = (mrows + 15) / 16;
  // this block's split of the K steps (part == nullptr: all of them)
  const int s0 = blockIdx.z * per;
  const int s1 = min(s0 + per, (K + WQ_KT - 1) / WQ_KT);

  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  wq_stage<T, MODE>(x, codes, scales, xs, cs, ss, M, N, K, g, m0, n0, s0 * WQ_KT,
                    min(WQ_KT, K - s0 * WQ_KT), aligned != 0);
  for (int step = s0; step < s1; ++step) {
    const int b = (step - s0) & 1;
    const int k0 = step * WQ_KT, kc = min(WQ_KT, K - k0);
    if (step + 1 < s1) {
      const int k1 = k0 + WQ_KT;
      wq_stage<T, MODE>(x, codes, scales, xs + (b ^ 1) * L::x_elems,
                        cs + (b ^ 1) * L::code_bytes, ss + (b ^ 1) * L::scale_floats, M, N, K,
                        g, m0, n0, k1, min(WQ_KT, K - k1), aligned != 0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    wq_dequant<T, MODE>(cs + b * L::code_bytes, ss + b * L::scale_floats, wd, g, kc);
    __syncthreads();
    const T* xb = xs + b * L::x_elems;
    const unsigned short* w16 = reinterpret_cast<const unsigned short*>(wd);
    for (int ks = 0; ks < kc / 16; ++ks) {
      uint32_t bf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = warp * 16 + nt * 8 + grp;
        if constexpr (MODE == kW8T) {
          const T* wr = wd + n * WQ_LDT + ks * 16 + 2 * tig;
          bf[nt][0] = *reinterpret_cast<const uint32_t*>(wr);
          bf[nt][1] = *reinterpret_cast<const uint32_t*>(wr + 8);
        } else {
          const unsigned short* wc = w16 + (ks * 16 + 2 * tig) * WQ_LDW + n;
          bf[nt][0] = (uint32_t)wc[0] | ((uint32_t)wc[WQ_LDW] << 16);
          bf[nt][1] = (uint32_t)wc[8 * WQ_LDW] | ((uint32_t)wc[9 * WQ_LDW] << 16);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mtiles) {
          const T* xr = xb + (mt * 16 + grp) * WQ_LDX + ks * 16 + 2 * tig;
          const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(xr),
                                 *reinterpret_cast<const uint32_t*>(xr + 8 * WQ_LDX),
                                 *reinterpret_cast<const uint32_t*>(xr + 8),
                                 *reinterpret_cast<const uint32_t*>(xr + 8 * WQ_LDX + 8)};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) Mma<T>::run(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();  // x buffer b is refilled by the next step's copy
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt >= mtiles) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + warp * 16 + nt * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mt * 16 + grp + 8 * h;
        if (row >= M) continue;
        if (part != nullptr) {  // split-K: fp32 partial of split blockIdx.z
          float* pr = part + ((size_t)blockIdx.z * M + row) * N;
          if (col < N) pr[col] = acc[mt][nt][2 * h];
          if (col + 1 < N) pr[col + 1] = acc[mt][nt][2 * h + 1];
          continue;
        }
        T* yr = y + (size_t)row * N;
        if (col < N) yr[col] = Bits<T>::from_f(acc[mt][nt][2 * h]);
        if (col + 1 < N) yr[col + 1] = Bits<T>::from_f(acc[mt][nt][2 * h + 1]);
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

template <typename T, int MODE>
cudaError_t launch_mma(const void* x, const int8_t* codes, const float* scales, void* y,
                       float* part, int M, int N, int K, int g, int splits, int aligned,
                       cudaStream_t stream) {
  cudaError_t err = allow_dynamic_smem<wq_mma_kernel<T, MODE>>();
  if (err != cudaSuccess) return err;
  const int nsteps = (K + WQ_KT - 1) / WQ_KT;
  const int per = (nsteps + splits - 1) / splits;
  if ((nsteps + per - 1) / per != splits || (splits > 1) != (part != nullptr))
    return cudaErrorInvalidValue;  // every split must own at least one step
  const dim3 grid((N + WQ_BN - 1) / WQ_BN, (M + WQ_BM - 1) / WQ_BM, splits);
  wq_mma_kernel<T, MODE><<<grid, WQ_THREADS, WqSmem<T>::bytes, stream>>>(
      static_cast<const T*>(x), codes, scales, static_cast<T*>(y), part, M, N, K, g, per,
      aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t MN = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((MN + 255) / 256, 4096);
  wq_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, static_cast<T*>(y), MN, splits);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(int dtype, const void* x, const int8_t* codes, const float* scales,
                        void* y, float* part, int M, int N, int K, int g, int splits,
                        int aligned, cudaStream_t st) {
  switch (dtype) {
    case 0: {
      if (splits != 1) return cudaErrorInvalidValue;
      const dim3 grid((N + WQS_BN - 1) / WQS_BN, (M + WQS_BM - 1) / WQS_BM);
      wq_simt_kernel<MODE><<<grid, 256, 0, st>>>(static_cast<const float*>(x), codes, scales,
                                                  static_cast<float*>(y), M, N, K, g);
      return cudaGetLastError();
    }
    case 1: return launch_mma<__half, MODE>(x, codes, scales, y, part, M, N, K, g, splits, aligned, st);
    case 2: return launch_mma<__nv_bfloat16, MODE>(x, codes, scales, y, part, M, N, K, g, splits, aligned, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dsk

// x [M, K] (mode 1: [M, H], K = H); codes int8 [K, N] (mode 1: [N, K],
// mode 2: [K/2, N]); scales fp32 [K/g, N] (mode 1: [N/g, K]); y [M, N].
// g: power of two >= 16 dividing the grouped dim (up to 128: a K step or
// column tile holds 128/g groups; above: it lies in one); K % 16 == 0.
// aligned: code and scale rows are 16-byte aligned (cp.async); else
// element-wise loads.  splits > 1 (16-bit x only): K steps split over that
// many blocks a tile, partials in part [splits, M, N] fp32; every split
// must own a step.  dtype: 0 fp32, 1 fp16, 2 bf16.
extern "C" int ds_wq_matmul(const void* x, const void* codes, const void* scales, void* y,
                            void* part, int M, int N, int K, int g, int mode, int aligned,
                            int splits, int dtype, void* stream) {
  if (g < 16 || (g & (g - 1)) || K % 16) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int8_t*>(codes);
  auto s = static_cast<const float*>(scales);
  auto p = static_cast<float*>(part);
  if (splits < 1) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case dsk::kW8: return (int)dsk::launch_mode<dsk::kW8>(dtype, x, c, s, y, p, M, N, K, g, splits, aligned, st);
    case dsk::kW8T: return (int)dsk::launch_mode<dsk::kW8T>(dtype, x, c, s, y, p, M, N, K, g, splits, aligned, st);
    case dsk::kW4: return (int)dsk::launch_mode<dsk::kW4>(dtype, x, c, s, y, p, M, N, K, g, splits, aligned, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
