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
// constraint.  Here each row reads only its own slot's pages (the gather
// form of Punica's BGMV), in two launches:
//
//   shrink  grid (M, H/chunk): a block owns one row and one chunk of H and
//           writes the fp32 partial sums part[c, m, 0..r) of that chunk.
//           Thread t owns rank column j = t % r and walks the rows
//           h = t / r, t / r + 256 / r, ... of the chunk, so a warp reads
//           32 consecutive elements of the contiguous [H, r] page: the
//           loads are coalesced for any r.  The block's threads of one
//           column are summed through shared memory in a fixed order.
//   expand  grid (M, O/256): a block owns one row and 256 output columns;
//           it first sums the row's partials over the chunks in order and
//           rounds u to x's type, then each thread forms one output
//           column over the r rank rows of B[id] (consecutive threads read
//           consecutive columns).
//
// No atomics and a fixed summation order everywhere: the result is
// deterministic.  Rows of slot 0 (the pool's identity: zero pages, scale
// 0) come out exactly 0.  A row whose id lies outside [0, S) is written as
// NaN: a visible fault, never a read out of bounds.
//
// What bounds it on the H100: bytes.  At the serving main path's calls
// (Llama-3-8B, r 16, 9 slots, bf16) the work is ~4*M*H*r flops, under 70
// MFLOP, against 1.5-6.3 MB of x, pages and y: the byte bound is 0.4-1.9
// us, so two launches' latency dominates.  A slot's pages (128 KB of A at
// r 16) stay in L2 across the rows that select it; H is split into chunks
// of 256 so that even M = 16 decode rows spread over 256 blocks, and both
// loops are unrolled so that each thread keeps several loads in flight
// (the sums keep their order).  Tensor-core
// fragments (mma.sync), TMA and segmenting rows by slot are later work.
#include "paged_common.cuh"

namespace dsk {

constexpr int LORA_THREADS = 256;
constexpr int LORA_RMAX = 256;   // rank limit: a shrink block holds >= r threads
constexpr int LORA_OT = 256;     // output columns of an expand block

template <typename T>
__device__ __forceinline__ float ld(const T* p) {
  return Bits<T>::to_f(*reinterpret_cast<const typename Bits<T>::U*>(p));
}

template <typename T>
__global__ void __launch_bounds__(LORA_THREADS)
lora_shrink_kernel(const T* __restrict__ x, const T* __restrict__ a, const int* __restrict__ ids,
                   float* __restrict__ part, int M, int H, int r, int S, int chunk) {
  __shared__ float red[LORA_THREADS];
  const int m = blockIdx.x, c = blockIdx.y;
  const int t = threadIdx.x;
  const int lanes = blockDim.x;       // r * (256 / r)
  const int hstep = lanes / r;
  const int id = ids[m];
  float acc = 0.f;
  if (id >= 0 && id < S) {
    const int h1 = min(H, (c + 1) * chunk);
    const T* __restrict__ xr = x + (size_t)m * H;
    const T* __restrict__ ap = a + (size_t)id * H * r + (t % r);
#pragma unroll 8
    for (int h = c * chunk + t / r; h < h1; h += hstep) acc += ld(xr + h) * ld(ap + (size_t)h * r);
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
cudaError_t launch_lora(const void* x, const void* a, const void* b, const int* ids,
                        const float* scales, void* y, float* part, int M, int H, int r, int O,
                        int S, int chunk, cudaStream_t st) {
  const int nsplit = (H + chunk - 1) / chunk;
  const int lanes = r * (LORA_THREADS / r);
  lora_shrink_kernel<T><<<dim3(M, nsplit), lanes, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, part, M, H, r, S, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lora_expand_kernel<T><<<dim3(M, (O + LORA_OT - 1) / LORA_OT), LORA_OT, 0, st>>>(
      part, static_cast<const T*>(b), ids, scales, static_cast<T*>(y), M, O, r, S, nsplit);
  return cudaGetLastError();
}

}  // namespace dsk

// part: [ceil(H / chunk), M, r] fp32 scratch.  dtype: 0 fp32, 1 fp16, 2 bf16.
extern "C" int ds_lora_matmul(const void* x, const void* a, const void* b, const void* ids,
                              const void* scales, void* y, void* part, int M, int H, int r,
                              int O, int S, int chunk, int dtype, void* stream) {
  if (r < 1 || r > dsk::LORA_RMAX || H < 1 || S < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || O == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(ids);
  auto s = static_cast<const float*>(scales);
  auto p = static_cast<float*>(part);
  switch (dtype) {
    case 0: return (int)dsk::launch_lora<float>(x, a, b, i, s, y, p, M, H, r, O, S, chunk, st);
    case 1: return (int)dsk::launch_lora<__half>(x, a, b, i, s, y, p, M, H, r, O, S, chunk, st);
    case 2:
      return (int)dsk::launch_lora<__nv_bfloat16>(x, a, b, i, s, y, p, M, H, r, O, S, chunk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
