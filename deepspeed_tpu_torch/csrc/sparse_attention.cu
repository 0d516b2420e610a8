// Block-sparse flash attention on Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/sparse_attention.py:
//   _sp_fwd_kernel (launched by _make_block_sparse_fn's fwd_impl)
//       -> sparse_fwd_wgmma_kernel (+ sparse_q_merge_kernel), sparse_fwd_kernel
//   _sp_dq_kernel  (bwd_impl)
//       -> sparse_dq_wgmma_kernel (+ sparse_q_merge_kernel), sparse_dq_kernel
//   _sp_dkv_kernel (bwd_impl)
//       -> sparse_dkv_wgmma_kernel (+ sparse_dkv_merge_kernel), sparse_dkv_kernel
// Same function: softmax(q kT * scale) v where query block i sees only the
// key blocks of its row of a static [nb, nb] block layout (and, when causal,
// only keys at or before its own position), GQA by kv head = q head / group
// with K/V never expanded.  The mma.sync and CUDA-core kernels walk the
// layout as the reference's index tables (_layout_tables): for each row
// block the active column blocks and their count (forward, dq), for each
// column block the active row blocks and their count (dk/dv); a block walks
// exactly `count` entries (the reference pads each table row with its last
// index and guards the padding off, so walking the padded width would add
// those blocks twice).  The wgmma kernels walk host plans instead (below).
// The forward saves the per-row logsumexp; the backward recomputes the
// probabilities from it, with delta = rowsum(o * do) made by the wgmma dq
// in its units (the other routes take it from the caller).  A row block
// with no active key block gives o = 0, lse = -1e30 and zero gradients, as
// the reference.
//
// What bounds it on the H100: operations.  A live (query, key) pair costs
// 4*D flops forward, 6*D in dq, 8*D in dk/dv; the bytes are q, k, v, o once
// (the key blocks a row reads come from L2), far below the flops at the
// card's ~295 flop/byte line.  What the design does about it:
//   - a call that is 16-bit at head_dim 64 / 128 with a block that divides
//     128 (dkv_route 2) runs TMA + wgmma, warp-specialised and persistent,
//     on host plans of 128-row units: the forward and dq over 128 queries
//     of one kv head's GQA group (its q heads stacked, so each gathered K /
//     V stage serves them all), dk/dv over 128 gathered keys; heavy walks
//     split into chunks merged in chunk order.  See their sections below.
//   - the other 16-bit blocks that are a multiple of 16 up to 128 (48, 80,
//     96, 112): every product on the tensor cores (mma.sync m16n8k16, fp32
//     accumulate) with the fragment helpers of flash_common.cuh.  Forward
//     and dq: one block per (batch, row block, group of q heads that share
//     a kv head); a warp owns 16 query rows of one head, so a block of
//     bs/16 x hpb warps stages each active K/V block once for hpb heads
//     (cp.async, double buffered, rows padded by 8 elements for
//     conflict-free ldmatrix).  The TPU grid walked the table's padded
//     width in order and carried (m, l, acc) in VMEM; here the walk is a
//     loop inside the block over the row's live entries, state in
//     registers.
//   - dk/dv at those blocks (sparse_dkv_kernel): one block per (batch, kv
//     head, key block), a warp owning 16
//     keys; the group's q heads are spread over hpb sets of warps that walk
//     the transposed table in step (head outer, as the reference fuses its
//     grid), their partial sums added in a fixed order at the end: no
//     atomics, deterministic.  Column blocks differ in how many row blocks
//     read them (a global block is read by every row, a local one by a
//     few), so these blocks differ widely in work; spreading the heads cuts
//     the heaviest block's serial steps by hpb, balancing the columns
//     themselves is what the wgmma kernels' plans do (heavy walks split
//     into chunks, tasks assigned heaviest first).
//   - the causal diagonal block is masked inside the tile by absolute
//     position; a 16 x 16 sub-tile wholly below the diagonal skips the
//     per-entry test, one wholly above it is skipped.
//   - q, k, v are read through (batch, token, head) strides: the model's
//     [B, T, N, D] layout needs no transposes.
#include "attn_bwd_hopper.cuh"

namespace dsk {

struct SparseArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *tab, *cnt;  // fwd, dq: [nb, tab_w] column blocks of each row
                         // block; dkv: row blocks of each column block
  int tab_w;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, T, N, Nkv, bs, hpb;  // hpb: q heads a block serves at once
  int hd;                     // head_dim (the simt family pads it to HD)
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal;
};

constexpr int kSpMaxWarps = 8;

// ------------------------------------------------------------ forward, mma
template <typename T, int HD>
__global__ void __launch_bounds__(kSpMaxWarps * 32) sparse_fwd_kernel(SparseArgs p) {
  constexpr int KSTEPS = HD / 16, DTILES = HD / 8, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bs = p.bs;
  T* kbuf = reinterpret_cast<T*>(smem);  // [2][bs*LD]
  T* vbuf = kbuf + 2 * bs * LD;          // [2][bs*LD]

  const int nb = p.T / bs;
  const int ib = nb - 1 - blockIdx.x;    // causal: the longest rows first
  const int wpr = bs / 16;               // warps a head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.y * p.hpb;
  const int h = h0 + warp / wpr, b = blockIdx.z;
  const int hk = h0 / (p.N / p.Nkv);     // one kv head for the whole block
  const int grp = lane >> 2, tig = lane & 3;
  const float scale2 = p.scale * kLog2e;

  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  const int warp_min = ib * bs + (warp % wpr) * 16, warp_max = warp_min + 15;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = warp_min + grp + 8 * i;  // T % bs == 0: all exist

  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = ks * 16 + 2 * tig + 8 * (j >> 1);
      qa[ks][j] = *reinterpret_cast<const uint32_t*>(qb + (long long)qpos[j & 1] * p.q_st + col);
    }
  float acc[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[d][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n = p.cnt[ib];
  const int* cols = p.tab + (long long)ib * p.tab_w;
  if (n > 0) {
    load_rows<T, HD, LD>(kbuf, kb, p.k_st, cols[0] * bs, bs, p.T);
    load_rows<T, HD, LD>(vbuf, vb, p.v_st, cols[0] * bs, bs, p.T);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    const int jb = cols[it];
    const int bsel = it & 1;
    if (it + 1 < n) {
      const int nxt = cols[it + 1] * bs;
      load_rows<T, HD, LD>(kbuf + (bsel ^ 1) * bs * LD, kb, p.k_st, nxt, bs, p.T);
      load_rows<T, HD, LD>(vbuf + (bsel ^ 1) * bs * LD, vb, p.v_st, nxt, bs, p.T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks_ = kbuf + bsel * bs * LD;
    const T* vs_ = vbuf + bsel * bs * LD;
    for (int t0 = 0; t0 < bs; t0 += 16) {
      const int kv0 = jb * bs + t0;
      if (p.causal && kv0 > warp_max) break;  // past the diagonal
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
      mma_rows_t<T, HD, LD>(sc, qa, ks_, t0, lane);
      const bool full = !p.causal || kv0 + 15 <= warp_min;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const int kpos = kv0 + nt * 8 + 2 * tig + (j & 1);
          float v = sc[nt][j] * scale2;
          if (!full && kpos > qpos[i]) v = kNegInf;
          sc[nt][j] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mnew = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - mnew);
        m[i] = mnew;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const float v = sc[nt][j];
          const float pr = (full || v > 0.5f * kNegInf) ? exp2f(v - m[i]) : 0.f;
          sc[nt][j] = pr;
          psum[i] += pr;
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
      mma_rows<T, HD, LD>(acc, pa, vs_, t0, lane);
    }
    __syncthreads();  // buffer bsel is refilled by the next iteration's copy
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* ob = static_cast<T*>(p.o) + ((long long)b * p.T * p.N + h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);  // dead row block: zeros
    T* orow = ob + (long long)qpos[i] * p.N * HD;
#pragma unroll
    for (int d = 0; d < DTILES; ++d)
      *reinterpret_cast<uint32_t*>(orow + d * 8 + 2 * tig) =
          Mma<T>::pack(acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
    if (tig == 0)  // ... and lse -1e30
      p.lse_out[((long long)b * p.N + h) * p.T + qpos[i]] =
          l[i] == 0.f ? kNegInf : m[i] * kLn2 + logf(l[i]);
  }
}

// ----------------------------------------------------------------- dq, mma
template <typename T, int HD>
__global__ void __launch_bounds__(kSpMaxWarps * 32) sparse_dq_kernel(SparseArgs p) {
  constexpr int KSTEPS = HD / 16, DTILES = HD / 8, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bs = p.bs;
  T* kbuf = reinterpret_cast<T*>(smem);
  T* vbuf = kbuf + 2 * bs * LD;

  const int nb = p.T / bs;
  const int ib = nb - 1 - blockIdx.x;
  const int wpr = bs / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.y * p.hpb;
  const int h = h0 + warp / wpr, b = blockIdx.z;
  const int hk = h0 / (p.N / p.Nkv);
  const int grp = lane >> 2, tig = lane & 3;
  const float scale2 = p.scale * kLog2e;

  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + ((long long)b * p.T * p.N + h) * HD;

  const int warp_min = ib * bs + (warp % wpr) * 16, warp_max = warp_min + 15;
  int qpos[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = warp_min + grp + 8 * i;
    const long long r = ((long long)b * p.N + h) * p.T + qpos[i];
    delta[i] = p.delta[r];
    lse2[i] = dead_or_log2(p.lse[r]);
  }

  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;
      const int col = ks * 16 + 2 * tig + 8 * (j >> 1);
      qa[ks][j] = *reinterpret_cast<const uint32_t*>(qb + (long long)qpos[i] * p.q_st + col);
      da[ks][j] = *reinterpret_cast<const uint32_t*>(dob + (long long)qpos[i] * p.N * HD + col);
    }
  float acc[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[d][j] = 0.f;

  const int n = p.cnt[ib];
  const int* cols = p.tab + (long long)ib * p.tab_w;
  if (n > 0) {
    load_rows<T, HD, LD>(kbuf, kb, p.k_st, cols[0] * bs, bs, p.T);
    load_rows<T, HD, LD>(vbuf, vb, p.v_st, cols[0] * bs, bs, p.T);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    const int jb = cols[it];
    const int bsel = it & 1;
    if (it + 1 < n) {
      const int nxt = cols[it + 1] * bs;
      load_rows<T, HD, LD>(kbuf + (bsel ^ 1) * bs * LD, kb, p.k_st, nxt, bs, p.T);
      load_rows<T, HD, LD>(vbuf + (bsel ^ 1) * bs * LD, vb, p.v_st, nxt, bs, p.T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks_ = kbuf + bsel * bs * LD;
    const T* vs_ = vbuf + bsel * bs * LD;
    for (int t0 = 0; t0 < bs; t0 += 16) {
      const int kv0 = jb * bs + t0;
      if (p.causal && kv0 > warp_max) break;
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
      mma_rows_t<T, HD, LD>(sc, qa, ks_, t0, lane);
      mma_rows_t<T, HD, LD>(dp, da, vs_, t0, lane);
      const bool full = !p.causal || kv0 + 15 <= warp_min;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          const int kpos = kv0 + nt * 8 + 2 * tig + (j & 1);
          float pr = exp2f(sc[nt][j] * scale2 - lse2[i]);
          if (!full && kpos > qpos[i]) pr = 0.f;
          sc[nt][j] = pr * (dp[nt][j] - delta[i]) * p.scale;  // ds
        }
      const uint32_t dsa[4] = {Mma<T>::pack(sc[0][0], sc[0][1]), Mma<T>::pack(sc[0][2], sc[0][3]),
                               Mma<T>::pack(sc[1][0], sc[1][1]), Mma<T>::pack(sc[1][2], sc[1][3])};
      mma_rows<T, HD, LD>(acc, dsa, ks_, t0, lane);  // dq += ds k
    }
    __syncthreads();
  }

  T* dqb = static_cast<T*>(p.dq) + ((long long)b * p.T * p.N + h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* row = dqb + (long long)qpos[i] * p.N * HD;
#pragma unroll
    for (int d = 0; d < DTILES; ++d)
      *reinterpret_cast<uint32_t*>(row + d * 8 + 2 * tig) =
          Mma<T>::pack(acc[d][2 * i], acc[d][2 * i + 1]);
  }
}

// -------------------------------------------------------------- dk/dv, mma
// A block owns one key block; its bs/16 x hpb warps are hpb sets of bs/16
// warps, set s walking the group's heads s, s + hpb, ... over the column's
// live row blocks (all sets in step, one row block a step, each staging
// its own head's Q and dO rows).  The sets' partial dk, dv are summed in
// shared memory in set order at the end: deterministic, no atomics.
template <typename T, int HD>
__global__ void __launch_bounds__(kSpMaxWarps * 32) sparse_dkv_kernel(SparseArgs p) {
  constexpr int KSTEPS = HD / 16, DTILES = HD / 8, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bs = p.bs, hpb = p.hpb;
  T* ks_ = reinterpret_cast<T*>(smem);   // [bs*LD] this block's keys
  T* vs_ = ks_ + bs * LD;                // [bs*LD]
  T* qbuf = vs_ + bs * LD;               // [2][hpb][bs*LD]
  T* dbuf = qbuf + 2 * hpb * bs * LD;    // [2][hpb][bs*LD]
  float* lbuf = reinterpret_cast<float*>(dbuf + 2 * hpb * bs * LD);  // [2][hpb][bs] lse, log2
  float* ebuf = lbuf + 2 * hpb * bs;                                  // [2][hpb][bs] delta

  const int jb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.N / p.Nkv;
  const int wpr = bs / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int set = warp / wpr, kw = warp % wpr;
  const int grp = lane >> 2, tig = lane & 3;
  const int k0 = jb * bs;
  const int wk0 = k0 + kw * 16;          // this warp's first key
  const float scale2 = p.scale * kLog2e;

  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  const int nr = p.cnt[jb];
  const int* rows = p.tab + (long long)jb * p.tab_w;
  const int n = nr * (group / hpb);      // steps: each set's heads x live row blocks

  // step -> (row block, and head s + hpb * (step / nr) for set s); the
  // block copies every set's Q, dO rows and their lse, delta into buffer
  // `sel`
  auto load_step = [&](int step, int sel) {
    const int q0 = rows[step % nr] * bs;
    for (int s = 0; s < hpb; ++s) {
      const int h = hk * group + s + hpb * (step / nr);
      const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
      const T* dob = static_cast<const T*>(p.dout) + ((long long)b * p.T * p.N + h) * HD;
      const int slot = sel * hpb + s;
      load_rows<T, HD, LD>(qbuf + slot * bs * LD, qb, p.q_st, q0, bs, p.T);
      load_rows<T, HD, LD>(dbuf + slot * bs * LD, dob, (long long)p.N * HD, q0, bs, p.T);
      const long long r = ((long long)b * p.N + h) * p.T + q0;
      for (int t = threadIdx.x; t < bs; t += blockDim.x) {
        lbuf[slot * bs + t] = dead_or_log2(p.lse[r + t]);
        ebuf[slot * bs + t] = p.delta[r + t];
      }
    }
  };

  float dk[DTILES][4], dv[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[d][j] = dv[d][j] = 0.f;

  if (n > 0) {
    load_rows<T, HD, LD>(ks_, kb, p.k_st, k0, bs, p.T);
    load_rows<T, HD, LD>(vs_, vb, p.v_st, k0, bs, p.T);
    load_step(0, 0);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    const int bsel = it & 1;
    if (it + 1 < n) {
      load_step(it + 1, bsel ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = rows[it % nr] * bs;
    const int slot = bsel * hpb + set;
    const T* qs = qbuf + slot * bs * LD;
    const T* ds_ = dbuf + slot * bs * LD;
    const float* ls = lbuf + slot * bs;
    const float* es = ebuf + slot * bs;
    for (int t0 = 0; t0 < bs; t0 += 16) {
      const int qv0 = q0 + t0;                      // this sub-tile's first query
      if (p.causal && qv0 + 15 < wk0) continue;     // every query before every key
      float st[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[nt][j] = dp[nt][j] = 0.f;
      const T* krows = ks_ + kw * 16 * LD;
      const T* vrows = vs_ + kw * 16 * LD;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4], qf[4], df[4];
        load_a_frag<T>(ka, krows, LD, ks, lane);
        load_a_frag<T>(va, vrows, LD, ks, lane);
        load_b_rows_t<T>(qf, qs, LD, t0, ks, lane);
        load_b_rows_t<T>(df, ds_, LD, t0, ks, lane);
        Mma<T>::run(st[0], ka, qf[0], qf[1]);  // sT = k qT
        Mma<T>::run(st[1], ka, qf[2], qf[3]);
        Mma<T>::run(dp[0], va, df[0], df[1]);  // dpT = v doT
        Mma<T>::run(dp[1], va, df[2], df[3]);
      }
      const bool full = !p.causal || wk0 + 15 <= qv0;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = wk0 + grp + 8 * (j >> 1);
          const int qi = t0 + nt * 8 + 2 * tig + (j & 1);
          float pr = exp2f(st[nt][j] * scale2 - ls[qi]);
          if (!full && kpos > q0 + qi) pr = 0.f;
          st[nt][j] = pr;                                   // pT
          dp[nt][j] = pr * (dp[nt][j] - es[qi]) * p.scale;  // dsT
        }
      const uint32_t pa[4] = {Mma<T>::pack(st[0][0], st[0][1]), Mma<T>::pack(st[0][2], st[0][3]),
                              Mma<T>::pack(st[1][0], st[1][1]), Mma<T>::pack(st[1][2], st[1][3])};
      const uint32_t dsa[4] = {Mma<T>::pack(dp[0][0], dp[0][1]), Mma<T>::pack(dp[0][2], dp[0][3]),
                               Mma<T>::pack(dp[1][0], dp[1][1]), Mma<T>::pack(dp[1][2], dp[1][3])};
      mma_rows<T, HD, LD>(dv, pa, ds_, t0, lane);   // dv += pT do
      mma_rows<T, HD, LD>(dk, dsa, qs, t0, lane);   // dk += dsT q
    }
    __syncthreads();
  }

  // sets 1.. hand their partials to set 0 through shared memory (the Q / dO
  // buffers are free now), which adds them in set order
  if (hpb > 1) {
    float* red = reinterpret_cast<float*>(qbuf);  // [hpb-1][wpr][32][DTILES*8]
    if (set > 0) {
      float* mine = red + (((set - 1) * wpr + kw) * 32 + lane) * (DTILES * 8);
#pragma unroll
      for (int d = 0; d < DTILES; ++d)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mine[d * 8 + j] = dk[d][j];
          mine[d * 8 + 4 + j] = dv[d][j];
        }
    }
    __syncthreads();
    if (set > 0) return;
    for (int s = 1; s < hpb; ++s) {
      const float* other = red + (((s - 1) * wpr + kw) * 32 + lane) * (DTILES * 8);
#pragma unroll
      for (int d = 0; d < DTILES; ++d)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dk[d][j] += other[d * 8 + j];
          dv[d][j] += other[d * 8 + 4 + j];
        }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + ((long long)b * p.T * p.Nkv + hk) * HD;
  T* dvb = static_cast<T*>(p.dv) + ((long long)b * p.T * p.Nkv + hk) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long off = (long long)(wk0 + grp + 8 * i) * p.Nkv * HD;
#pragma unroll
    for (int d = 0; d < DTILES; ++d) {
      *reinterpret_cast<uint32_t*>(dkb + off + d * 8 + 2 * tig) =
          Mma<T>::pack(dk[d][2 * i], dk[d][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvb + off + d * 8 + 2 * tig) =
          Mma<T>::pack(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

// -------------------------------------------------- dk/dv, TMA + wgmma
// sparse_dkv_wgmma_kernel: the 16-bit dk/dv at head_dim 64 / 128 with a
// block that divides 128 (dkv_route), on the flash backward's
// warp-specialised dk/dv design (attn_bwd_hopper.cuh flash_dkv_kernel).
// A unit is one group of G = 128 / bs column blocks of one (batch, kv
// head), gathered into 128 keys: the host's plan (ops/sparse_attention.py
// sparse_dkv_plan) puts columns whose row lists overlap in one group, and
// lists the union of their row blocks as stages of 64 queries (R segments
// of min(bs, 64) queries, one q head) with each segment's live-column
// bits.  The producer warp puts the group's K / V rows into a slot (one
// TMA box of bs keys a column) and streams each stage's Q / dO segments
// (one box each) with their lse (log2 units), delta, query positions and
// live bits through the ring; the two consumer warpgroups (64 keys each)
// compute sT = K QT and dpT = V dOT on wgmma (both K-major), zero p and ds
// of a dead sub-tile (and, causal, of a key after its query), and add pT
// dO and dsT Q with p / ds packed in registers (dO, Q read MN-major).  The
// walk runs over every q head of the GQA group (head outer), summed in
// registers.  A walk longer than a fair share of the launch is split into
// chunks (tasks), each writing fp32 partials that sparse_dkv_merge_kernel
// adds in chunk order; every block runs the task list the host assigned
// it, heaviest first.  No atomics: deterministic.
constexpr int kSpKeys = 128, kSpRows = 64;  // keys a unit, queries a stage

// Shared memory (ops/sparse_attention.py sparse_dkv_tiles, the same
// formula): the mbarriers, slack to align the rest to 1024 bytes, `slots`
// slots of K and V ([HD/64][128 keys][128 B] each), then the ring's stages
// of Q and dO ([HD/64][64 queries][128 B] each) and four rows of 64 words
// (lse in log2 units, delta, query position, live-column bits), a stage
// rounded up to 1024 bytes.
struct SpDkvLayout {
  int slot_tile, ring_tile, slot_bytes, stage_bytes;
  __host__ __device__ explicit SpDkvLayout(int hd) {
    slot_tile = kSpKeys * hd * 2;
    ring_tile = kSpRows * hd * 2;
    slot_bytes = 2 * slot_tile;
    stage_bytes = (2 * ring_tile + 4 * kSpRows * 4 + 1023) / 1024 * 1024;
  }
  size_t smem(int stages, int slots) const {
    return (size_t)kBwdBarBytes + 1024 + (size_t)slots * slot_bytes +
           (size_t)stages * stage_bytes;
  }
};

// The plan's tables on the device (sparse_dkv_plan): cols [groups, G]
// (-1: a pad column), gst [groups, 2] (first stage, stages), seg / live
// [stages, R] (a segment's first query, its live-column bits), tasks
// [tasks, 5] (group, batch * Nkv + kv head, first item, end item, part
// slot or -1), blk [grid + 1] (each block's run of tasks).
struct SpDkvArgs {
  const float *lse, *delta;  // [B, N, T]
  void *dk, *dv;             // [B, T, Nkv, hd] contiguous
  float* part;               // [parts][2][128][hd] fp32: dk, dv of a chunk
  const int *cols, *gst, *seg, *live, *tasks, *blk;
  int T, N, Nkv, bs, G, R, lbs, lseg, causal, stages, slots;
  int cq, ck, cv, cdo;
  float scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    sparse_dkv_wgmma_kernel(const __grid_constant__ SpDkvArgs p,
                            const __grid_constant__ CUtensorMap tmk,
                            const __grid_constant__ CUtensorMap tmv,
                            const __grid_constant__ CUtensorMap tmq,
                            const __grid_constant__ CUtensorMap tmdo) {
  constexpr int NAT = HD / 64, KR = kSpKeys, BM = kSpRows, NS = BM / 2;
  static_assert(HD == 64 || HD == 128, "head dims");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* slot_full = bars;
  uint64_t* slot_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = full + kBwdMaxStages;
  unsigned char* base = smem_raw + kBwdBarBytes;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  const SpDkvLayout lay(HD);
  unsigned char* ring = base + p.slots * lay.slot_bytes;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  // a stage is full once its TMA bytes have landed and the producer warp's
  // 32 lanes have written its rows of words
  if (threadIdx.x == 0) init_bwd_barriers(bars, p.stages, 1, 32);
  __syncthreads();
  const int group = p.N / p.Nkv, seg = 1 << p.lseg;
  // this block's tasks (lane 0's copy: the bounds steer every wgmma)
  const int t0 = __shfl_sync(0xffffffffu, p.blk[blockIdx.x], 0);
  const int t1 = __shfl_sync(0xffffffffu, p.blk[blockIdx.x + 1], 0);

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kDkvRegProducer>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int it = 0;
    for (int i = 0, t = t0; t < t1; ++i, ++t) {
      const int* tk = p.tasks + 5 * t;
      const int g = tk[0], bh = tk[1], i0 = tk[2], i1 = tk[3];
      const int b = bh / p.Nkv, hk = bh - b * p.Nkv;
      const int st0 = p.gst[2 * g], ns = p.gst[2 * g + 1];
      if (lane == 0) {
        const int slot = i % p.slots;
        if (i >= p.slots) mbar_wait(&slot_empty[slot], (i / p.slots - 1) & 1);
        unsigned char* sl = base + slot * lay.slot_bytes;
        mbar_expect_tx(&slot_full[slot], lay.slot_bytes);
        for (int c = 0; c < p.G; ++c) {
          // a pad column reads column 0 (finite rows; never stored)
          const int k0 = max(p.cols[g * p.G + c], 0) * p.bs;
#pragma unroll
          for (int cb = 0; cb < NAT; ++cb) {
            tma_load_4d(sl + cb * KR * 128 + c * p.bs * 128, &tmk, cb * 64, tma_c(p.ck, 1, hk),
                        k0, tma_c(p.ck, 3, b), &slot_full[slot]);
            tma_load_4d(sl + lay.slot_tile + cb * KR * 128 + c * p.bs * 128, &tmv, cb * 64,
                        tma_c(p.cv, 1, hk), k0, tma_c(p.cv, 3, b), &slot_full[slot]);
          }
        }
      }
      // item i -> (q head hk * group + i / ns, stage st0 + i % ns)
      int h = 0, sti = 0;
      if (i1 > i0) {
        h = hk * group + i0 / ns;
        sti = i0 % ns;
      }
      for (int item = i0; item < i1; ++item, ++it) {
        const int s = it % p.stages;
        if (it >= p.stages) mbar_wait(&empty[s], (it / p.stages - 1) & 1);
        unsigned char* st = ring + (size_t)s * lay.stage_bytes;
        const int* sg = p.seg + (st0 + sti) * p.R;
        const int* lv = p.live + (st0 + sti) * p.R;
        if (lane == 0) {
          mbar_expect_tx_only(&full[s], 2 * lay.ring_tile);  // the lanes arrive below
          for (int r = 0; r < p.R; ++r) {
            const int q0 = sg[r];
#pragma unroll
            for (int cb = 0; cb < NAT; ++cb) {
              tma_load_4d(st + cb * BM * 128 + r * seg * 128, &tmq, cb * 64, tma_c(p.cq, 1, h),
                          q0, tma_c(p.cq, 3, b), &full[s]);
              tma_load_4d(st + lay.ring_tile + cb * BM * 128 + r * seg * 128, &tmdo, cb * 64,
                          tma_c(p.cdo, 1, h), q0, tma_c(p.cdo, 3, b), &full[s]);
            }
          }
        }
        // each row's lse (log2 units; +inf: a row that sees no key), delta,
        // position and live-column bits
        float* stats = reinterpret_cast<float*>(st + 2 * lay.ring_tile);
        int* words = reinterpret_cast<int*>(stats + 2 * BM);
        const long long rows = ((long long)b * p.N + h) * p.T;
        float l[2], d[2];
        int pos[2], bits[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = lane + 32 * j, r = row >> p.lseg;
          pos[j] = sg[r] + (row & (seg - 1));
          bits[j] = lv[r];
          l[j] = __ldg(p.lse + rows + pos[j]);
          d[j] = __ldg(p.delta + rows + pos[j]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = lane + 32 * j;
          stats[row] = dead_or_log2(l[j]);
          stats[BM + row] = d[j];
          words[row] = pos[j];
          words[BM + row] = bits[j];
        }
        mbar_arrive(&full[s]);
        if (++sti == ns) {
          sti = 0;
          ++h;
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kDkvRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  const float scale2 = p.scale * kLog2e;
  const int kl = 64 * c + 16 * w + grp;  // this thread's keys kl, kl + 8 of the unit
  const int cidx = kl >> p.lbs, koff = kl & (p.bs - 1);  // their column and offset in it
  float dk[NAT][32], dv[NAT][32];
  float st[NS], dpt[NS];
  uint32_t pa[BM / 16][4], dsa[BM / 16][4];
  auto fence_all = [&]() {
    wg_fence_regs(st);
    wg_fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < NAT; ++j) {
      wg_fence_regs(dk[j]);
      wg_fence_regs(dv[j]);
    }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      wg_fence_regs(pa[kk]);
      wg_fence_regs(dsa[kk]);
    }
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) st[j] = dpt[j] = 0.f;
  int it = 0;
  if (c == 1) turn_pass(c);  // the first consumer warpgroup takes the first turn
  for (int i = 0, t = t0; t < t1; ++i, ++t) {
    const int* tk = p.tasks + 5 * t;
    const int g = tk[0], bh = tk[1], pslot = tk[4];
    const int n = __shfl_sync(0xffffffffu, tk[3] - tk[2], 0);  // steers the wgmmas
    const int b = bh / p.Nkv, hk = bh - b * p.Nkv;
    const int col = p.cols[g * p.G + cidx];
    const int kpos = col * p.bs + koff;  // this thread's first key (col < 0: a pad)
    const int slot = i % p.slots;
#pragma unroll
    for (int j = 0; j < NAT; ++j)
#pragma unroll
      for (int x = 0; x < 32; ++x) dk[j][x] = dv[j][x] = 0.f;
    mbar_wait(&slot_full[slot], (i / p.slots) & 1);
    const unsigned char* ks = base + slot * lay.slot_bytes + c * 64 * 128;
    const unsigned char* vs = ks + lay.slot_tile;
    for (int item = 0; item < n; ++item, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const unsigned char* qs = ring + (size_t)s * lay.stage_bytes;
      const unsigned char* dos = qs + lay.ring_tile;
      const float* ls = reinterpret_cast<const float*>(qs + 2 * lay.ring_tile);
      const int* words = reinterpret_cast<const int*>(ls + 2 * BM);
      // sT = k qT, dpT = v doT (keys are the accumulator rows)
      fence_all();
      turn_wait(c);
      wg_fence();
      kmajor_product<T, HD, BM>(st, ks, KR, qs);
      kmajor_product<T, HD, BM>(dpt, vs, KR, dos);
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      wg_fence_regs(st);
      wg_fence_regs(dpt);
      // pT = 2^(sT scale2 - lse2), dsT = pT (dpT - delta) scale; 0 on a
      // dead sub-tile and (causal) on a key after its query
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int qi = 8 * j + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + BM + qi);
        const int2 q2 = *reinterpret_cast<const int2*>(words + qi);
        const bool on = (words[BM + qi] >> cidx) & 1;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e;
            const float pr = ex2(fmaf(st[x], scale2, -(e ? l2.y : l2.x)));
            const float ds = pr * fmaf(dpt[x], p.scale, -(e ? d2.y : d2.x) * p.scale);
            // selected, not multiplied: a dead column's rows may hold anything
            const bool vis = on && (!p.causal || kpos + 8 * hh <= (e ? q2.y : q2.x));
            st[x] = vis ? pr : 0.f;
            dpt[x] = vis ? ds : 0.f;
          }
        if (j % 2 == 1) {
          const int kk = j / 2;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = Mma<T>::pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            dsa[kk][r] = Mma<T>::pack(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
          }
        }
      }
      // dv += pT do, dk += dsT q: do and q read MN-major from the same tiles
      fence_all();
      turn_wait(c);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int a = 0; a < NAT; ++a) {
          Wgmma<T>::rs64(dv[a], pa[kk], wg_desc(dos + a * BM * 128 + kk * 16 * 128));
          Wgmma<T>::rs64(dk[a], dsa[kk], wg_desc(qs + a * BM * 128 + kk * 16 * 128));
        }
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      fence_all();
      warp_arrive(&empty[s], lane);
    }
    warp_arrive(&slot_empty[slot], lane);

    // ---- epilogue: the task's dk, dv rows, or its fp32 partial
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (pslot < 0) {
        if (col < 0) continue;
        const long long off = (((long long)b * p.T + kpos + 8 * hh) * p.Nkv + hk) * HD;
        T* dko = static_cast<T*>(p.dk) + off;
        T* dvo = static_cast<T*>(p.dv) + off;
#pragma unroll
        for (int a = 0; a < NAT; ++a)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int cc = 64 * a + 8 * jj + 2 * tq, x = 4 * jj + 2 * hh;
            *reinterpret_cast<uint32_t*>(dko + cc) = Mma<T>::pack(dk[a][x], dk[a][x + 1]);
            *reinterpret_cast<uint32_t*>(dvo + cc) = Mma<T>::pack(dv[a][x], dv[a][x + 1]);
          }
      } else {
        float* pk = p.part + ((size_t)pslot * 2 * KR + kl + 8 * hh) * HD;
        float* pv = pk + (size_t)KR * HD;
#pragma unroll
        for (int a = 0; a < NAT; ++a)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int cc = 64 * a + 8 * jj + 2 * tq, x = 4 * jj + 2 * hh;
            *reinterpret_cast<float2*>(pk + cc) = make_float2(dk[a][x], dk[a][x + 1]);
            *reinterpret_cast<float2*>(pv + cc) = make_float2(dv[a][x], dv[a][x + 1]);
          }
      }
    }
  }
}

// The split walks' second pass: for each merge [group, batch * Nkv + kv
// head, first part, chunks], dk and dv of the group's 128 keys = the
// chunks' fp32 partials added in chunk order, rounded once; one block a
// merge, four values a thread a step.
template <typename T>
__global__ void __launch_bounds__(256)
    sparse_dkv_merge_kernel(const float* __restrict__ part, const int* __restrict__ merges,
                            const int* __restrict__ cols, void* dk, void* dv, int Tlen, int Nkv,
                            int hd, int bs, int G) {
  const int* m = merges + 4 * blockIdx.x;
  const int g = m[0], bh = m[1], p0 = m[2], n = m[3];
  const int b = bh / Nkv, hk = bh - b * Nkv;
  const int per = kSpKeys * hd;  // one tensor of a part
  for (int e = 4 * threadIdx.x; e < 2 * per; e += 4 * blockDim.x) {
    const int which = e >= per, r = e - which * per, row = r / hd, cc = r - row * hd;
    const int col = cols[g * G + row / bs];
    if (col < 0) continue;
    const float* src = part + (size_t)p0 * 2 * per + e;
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int k = 1; k < n; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(src + (size_t)k * 2 * per);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    T* out = static_cast<T*>(which ? dv : dk) +
             (((long long)b * Tlen + col * bs + row % bs) * Nkv + hk) * hd + cc;
    const float vals[4] = {s.x, s.y, s.z, s.w};
    store4<T>(out, vals);
  }
}

// ------------------------------------------ forward and dq, TMA + wgmma
// sparse_fwd_wgmma_kernel and sparse_dq_wgmma_kernel: the 16-bit forward
// and dq at head_dim 64 / 128 with a block that divides 128 (dkv_route 2),
// on the flash forward's and dq's warp-specialised designs
// (attn_fwd_hopper.cuh attn_fwd_kernel, attn_bwd_hopper.cuh
// flash_dq_kernel), the mirror image of sparse_dkv_wgmma_kernel: a unit is
// 128 query rows of one (batch, kv head), R segments of `seg` queries of
// one q head (the host's plan, ops/sparse_attention.py sparse_q_plan: the
// GQA group's heads stacked, then adjacent row blocks), so each key block
// a unit loads serves every q head of the group at once.  Its walk is the
// union of its segments' key blocks, gathered into stages of BN keys (C =
// BN / kb blocks of kb = min(bs, 64) keys; BN 128 in the forward, where a
// stage's fixed cost - waits, turns, the softmax's reductions - measured
// 1.26x cheaper a key than at 64, and 64 in dq, whose S and dP at 128 keys
// would not fit 168 registers); each stage carries 32 words:
// each segment's bits over the stage's blocks (bit c: it reads block c;
// bit 8 + c: the causal position test applies) and each block's first key.
// The producer warp puts the unit's Q (dq: and dO) into a slot, one TMA
// box a segment, and streams each stage's K and V (one box a block) with
// its words through the ring; the two consumer warpgroups (64 rows each)
// run S = Q KT (and dP = dO VT) on wgmma, select p (ds) to 0 where a
// sub-tile is dead (a padded block repeats the stage's first, never
// counted), and add P V (dS K) with P (dS) from registers.  Forward: the
// online softmax in registers, o = acc / l, lse; dq: three producer warps
// make delta = rowsum(o * do) for the unit's rows a slot ahead (written to
// [B, N, T] by a unit's first chunk, for dk/dv).  A walk longer than a fair
// share is split into chunks whose fp32 partials are merged in chunk order
// (sparse_q_merge_kernel); every block runs the tasks the host assigned
// it, heaviest first.  No atomics: deterministic.
constexpr int kSpQRows = 128, kSpQKeys = 64;  // rows a unit, keys a dq stage
constexpr int kSpQFwdKeys = 128;               // keys a forward stage
constexpr int kSpQWords = 32, kSpQLive = 16;  // words a stage; live words first

// Shared memory (ops/sparse_attention.py sparse_q_tiles, the same formula):
// the mbarriers, slack to align the rest to 1024 bytes, `slots` slots of Q
// (dq: Q, dO) [HD/64][128 rows][128 B] each, the ring's stages of K and V
// [HD/64][bn keys][128 B] each, each stage's 32 words, then (dq) each
// slot's 128 delta values.
struct SpQLayout {
  int tile, slot_bytes, kv_tile, stage_bytes, slot_words;
  __host__ __device__ SpQLayout(int hd, bool dq) {
    const int bn = dq ? kSpQKeys : kSpQFwdKeys;
    tile = kSpQRows * hd * 2;
    slot_bytes = (dq ? 2 : 1) * tile;
    kv_tile = bn * hd * 2;
    stage_bytes = 2 * kv_tile;
    slot_words = dq ? kSpQRows * 4 : 0;
  }
  size_t smem(int stages, int slots, int bar_bytes) const {
    return (size_t)bar_bytes + 1024 + (size_t)slots * (slot_bytes + slot_words) +
           (size_t)stages * (stage_bytes + kSpQWords * 4);
  }
};

// The plan's tables on the device (sparse_q_plan): rows [patterns, R, 2]
// (a segment's head within the group, -1 a pad; its first query), ust
// [patterns, 2] (first stage, stages), kst [stages, C] (each block's first
// key), live [stages, R] (each segment's bits), tasks [tasks, 5] (pattern,
// batch * Nkv + kv head, first stage, end stage, part slot or -1), blk
// [grid + 1] (each block's run of tasks).
struct SpQArgs {
  void* o;                  // fwd: o out; dq: o read for delta
  float* lse;               // fwd: lse out; dq: lse in ([B, N, T])
  const void* dout;         // dq: do [B, T, N, hd] contiguous
  const float* delta;       // dq: delta given, or null (made from o, do)
  float* delta_out;         // dq: where the made delta goes, or null
  void* dq;                 // dq out [B, T, N, hd] contiguous
  float *part, *part_ml;    // a split task's o / dq [128, hd] and (fwd) m, l [2, 128]
  const int *rows, *ust, *kst, *live, *tasks, *blk;
  int T, N, Nkv, hd, R, C, lseg, lkb, causal, stages, slots;
  int cq, ck, cv, cdo;
  float scale;
};

// this thread's rows rl, rl + 8 of a unit: q head (-1: a pad row) and
// position
struct SpQRows {
  int head[2], pos[2];
  __device__ __forceinline__ SpQRows(const SpQArgs& p, const int* rows, int hk, int rl) {
    const int group = p.N / p.Nkv;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rl + 8 * hh, sg = r >> p.lseg;
      head[hh] = rows[2 * sg] < 0 ? -1 : hk * group + rows[2 * sg];
      pos[hh] = rows[2 * sg + 1] + (r & ((1 << p.lseg) - 1));
    }
  }
};

// The producer warp's share of a stage: lane 0's TMA boxes of K (and V,
// when `tmv` is given) of the stage's C blocks into `st` (tiles [HD/64][64
// keys][128 B]) on `bar`; every lane then writes the stage's words and
// arrives on `bar` (32 arrivals).
template <int HD, int BN>
__device__ __forceinline__ void sp_q_stage(const SpQArgs& p, int si, int hk, int b,
                                           unsigned char* st, int* wd, const CUtensorMap* tmk,
                                           const CUtensorMap* tmv, uint32_t tx, uint64_t* bar,
                                           int lane) {
  constexpr int NAT = HD / 64;
  const int* ks = p.kst + si * p.C;
  if (lane == 0) {
    mbar_expect_tx_only(bar, tx);
    for (int c = 0; c < p.C; ++c) {
      const int k0 = ks[c];
#pragma unroll
      for (int cb = 0; cb < NAT; ++cb) {
        unsigned char* dst = st + cb * BN * 128 + (c << p.lkb) * 128;
        tma_load_4d(dst, tmk, cb * 64, tma_c(p.ck, 1, hk), k0, tma_c(p.ck, 3, b), bar);
        if (tmv != nullptr)
          tma_load_4d(dst + BN * HD * 2, tmv, cb * 64, tma_c(p.cv, 1, hk), k0,
                      tma_c(p.cv, 3, b), bar);
      }
    }
  }
  if (lane < p.R) wd[lane] = p.live[si * p.R + lane];
  if (lane >= kSpQLive && lane < kSpQLive + p.C) wd[lane] = ks[lane - kSpQLive];
  mbar_arrive(bar);
}

// Which of a thread's 32 scores of a stage its rows rl, rl + 8 (at
// positions pos) see: bit 4j + 2hh + e for key 8j + 2tq + e of row rl + 8hh
// (a segment's live bit for the key's block and, where its bit 8 + c says
// so, key <= query).
template <int BN>
__device__ __forceinline__ uint64_t sp_q_visible(const SpQArgs& p, const int* wd, int rl,
                                                 const int (&pos)[2], int tq) {
  const int lv[2] = {wd[rl >> p.lseg], wd[(rl + 8) >> p.lseg]};
  const int all = (1 << p.C) - 1;
  if (lv[0] == all && lv[1] == all) return ~0ull;  // the common stage
  const bool test = ((lv[0] | lv[1]) >> 8) != 0;
  const int kb = 1 << p.lkb;
  uint64_t vis = 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = (8 * j) >> p.lkb;
    const int kp = test ? wd[kSpQLive + c] + ((8 * j) & (kb - 1)) + 2 * tq : 0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool on = (lv[hh] >> c) & 1;
        if (test && ((lv[hh] >> (8 + c)) & 1)) on = on && kp + e <= pos[hh];
        vis |= (uint64_t)on << (4 * j + 2 * hh + e);
      }
  }
  return vis;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
    sparse_fwd_wgmma_kernel(const __grid_constant__ SpQArgs p,
                            const __grid_constant__ CUtensorMap tmq,
                            const __grid_constant__ CUtensorMap tmk,
                            const __grid_constant__ CUtensorMap tmv) {
  constexpr int NAT = HD / 64, BN = kSpQFwdKeys, NS = BN / 2;
  static_assert(HD == 64 || HD == 128, "head dims");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_full + 4;
  uint64_t* k_empty = k_full + kFwdMaxStages;
  uint64_t* v_full = k_empty + kFwdMaxStages;
  uint64_t* v_empty = v_full + kFwdMaxStages;
  unsigned char* base = smem_raw + kFwdBarBytes;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  const SpQLayout lay(HD, false);
  unsigned char* ring = base + p.slots * lay.slot_bytes;
  int* words = reinterpret_cast<int*>(ring + p.stages * lay.stage_bytes);  // [stages][32]
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);
    }
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&k_full[s], 32);  // the producer warp's lanes (words)
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int group = p.N / p.Nkv, seg = 1 << p.lseg;
  // this block's tasks (lane 0's copy: the bounds steer every wgmma)
  const int t0 = __shfl_sync(0xffffffffu, p.blk[blockIdx.x], 0);
  const int t1 = __shfl_sync(0xffffffffu, p.blk[blockIdx.x + 1], 0);

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kDqRegProducer>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int it = 0;
    for (int i = 0, t = t0; t < t1; ++i, ++t) {
      const int* tk = p.tasks + 5 * t;
      const int pu = tk[0], bh = tk[1], s0 = tk[2], s1 = tk[3];
      const int b = bh / p.Nkv, hk = bh - b * p.Nkv;
      const int* rows = p.rows + pu * p.R * 2;
      const int st0 = p.ust[2 * pu];
      if (lane == 0) {
        const int slot = i % p.slots;
        if (i >= p.slots) mbar_wait(&q_empty[slot], (i / p.slots - 1) & 1);
        unsigned char* qs = base + slot * lay.slot_bytes;
        mbar_expect_tx(&q_full[slot], lay.slot_bytes);
        for (int r = 0; r < p.R; ++r) {
          // a pad segment reads its unit's first rows (finite; never stored)
          const int h = hk * group + max(rows[2 * r], 0), q0 = rows[2 * r + 1];
#pragma unroll
          for (int cb = 0; cb < NAT; ++cb)
            tma_load_4d(qs + cb * kSpQRows * 128 + r * seg * 128, &tmq, cb * 64,
                        tma_c(p.cq, 1, h), q0, tma_c(p.cq, 3, b), &q_full[slot]);
        }
      }
      for (int si = s0; si < s1; ++si, ++it) {
        const int s = it % p.stages;
        const int ph = (it / p.stages - 1) & 1;  // the phase that freed the stage
        if (it >= p.stages) mbar_wait(&k_empty[s], ph);
        unsigned char* st = ring + (size_t)s * lay.stage_bytes;
        sp_q_stage<HD, BN>(p, st0 + si, hk, b, st, words + s * kSpQWords, &tmk, nullptr,
                       lay.kv_tile, &k_full[s], lane);
        if (lane == 0) {  // V, once the stage's last P V product is done
          if (it >= p.stages) mbar_wait(&v_empty[s], ph);
          mbar_expect_tx(&v_full[s], lay.kv_tile);
          const int* ks = p.kst + (st0 + si) * p.C;
          for (int c = 0; c < p.C; ++c)
#pragma unroll
            for (int cb = 0; cb < NAT; ++cb)
              tma_load_4d(st + lay.kv_tile + cb * BN * 128 + (c << p.lkb) * 128, &tmv,
                          cb * 64, tma_c(p.cv, 1, hk), ks[c], tma_c(p.cv, 3, b), &v_full[s]);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kDqRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  const int rl = 64 * c + 16 * w + grp;  // this thread's rows rl, rl + 8 of a unit
  const float scale2 = p.scale * kLog2e;
  float o[NAT][32];
  float sc[NS];
  uint32_t pa[BN / 16][4];
  float m[2], l[2], alpha[2];
  // each product pins only its own registers (sc is zeroed once packed,
  // so nothing of it lives across P V)
  auto fence_s = [&]() { wg_fence_regs(sc); };
  auto fence_all = [&]() {
#pragma unroll
    for (int a = 0; a < NAT; ++a) wg_fence_regs(o[a]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wg_fence_regs(pa[kk]);
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) sc[j] = 0.f;
  int it = 0;
  if (c == 1) turn_pass(c);  // the first consumer warpgroup takes the first turn
  for (int i = 0, t = t0; t < t1; ++i, ++t) {
    const int* tk = p.tasks + 5 * t;
    const int pu = tk[0], bh = tk[1], pslot = tk[4];
    const int n = __shfl_sync(0xffffffffu, tk[3] - tk[2], 0);  // steers the wgmmas
    const int b = bh / p.Nkv, hk = bh - b * p.Nkv;
    const SpQRows rw(p, p.rows + pu * p.R * 2, hk, rl);
    const int slot = i % p.slots;
#pragma unroll
    for (int a = 0; a < NAT; ++a)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[a][j] = 0.f;
    l[0] = l[1] = 0.f;
    m[0] = m[1] = -INFINITY;
    mbar_wait(&q_full[slot], (i / p.slots) & 1);
    const unsigned char* qs = base + slot * lay.slot_bytes + c * 64 * 128;
    // a stage's scores in sc become probabilities (0 where a row does not
    // see the key), m and l move on and alpha rescales O
    // A stage whose every key both rows see (the common case) keeps its
    // raw scores: their maximum, scaled (scale2 > 0 keeps the order), and
    // the scale folded into the exponential.
    auto softmax = [&](const int* wd) {
      const uint64_t vis = sp_q_visible<BN>(p, wd, rl, rw.pos, tq);
      const bool raw = vis == ~0ull;
      if (!raw) {
#pragma unroll
        for (int x = 0; x < NS; ++x) sc[x] = (vis >> x) & 1 ? sc[x] * scale2 : -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, mu[2], ps[2];
      row_max(sc, mx);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        if (raw) mx[hh] *= scale2;
        const float mnew = fmaxf(m[hh], mx[hh]);
        mu[hh] = mnew == -INFINITY ? 0.f : mnew;  // a row that saw no key yet
        alpha[hh] = ex2(m[hh] - mu[hh]);
        m[hh] = mnew;
      }
      if (raw) {
        const float nm0 = -mu[0], nm1 = -mu[1];
#pragma unroll
        for (int x = 0; x < NS; ++x) sc[x] = ex2(fmaf(sc[x], scale2, (x >> 1) & 1 ? nm1 : nm0));
      } else {
#pragma unroll
        for (int x = 0; x < NS; ++x) sc[x] = ex2(sc[x] - mu[(x >> 1) & 1]);
      }
      row_sum(sc, ps);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
    };
    // O rescaled by alpha (skipped where no row maximum moved), P packed
    auto rescale_pack = [&]() {
      if (alpha[0] != 1.f || alpha[1] != 1.f)
#pragma unroll
        for (int a = 0; a < NAT; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[a][4 * j + 0] *= alpha[0];
            o[a][4 * j + 1] *= alpha[0];
            o[a][4 * j + 2] *= alpha[1];
            o[a][4 * j + 3] *= alpha[1];
          }
      pack_a<T, BN>(pa, sc);
#pragma unroll
      for (int x = 0; x < NS; ++x) sc[x] = 0.f;
    };
    // Each stage: S, its softmax (K released), then O += P V (V released).
    // Issuing the next stage's S behind this stage's P V, as
    // attn_fwd_kernel does, measured 8% slower at the Fixed call with
    // 64-key stages, and at 128 keys its registers would not fit.
    for (int item = 0; item < n; ++item, ++it) {
      const int s = it % p.stages;
      mbar_wait(&k_full[s], (it / p.stages) & 1);
      const unsigned char* st = ring + (size_t)s * lay.stage_bytes;
      fence_s();
      turn_wait(c);
      wg_fence();
      kmajor_product<T, HD, BN>(sc, qs, kSpQRows, st);
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      fence_s();
      softmax(words + s * kSpQWords);
      warp_arrive(&k_empty[s], lane);
      rescale_pack();
      mbar_wait(&v_full[s], (it / p.stages) & 1);
      fence_all();
      turn_wait(c);
      wg_fence();
      pv_product<T, NAT, BN>(o, pa, st + lay.kv_tile);
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      fence_all();
      warp_arrive(&v_empty[s], lane);
    }
    warp_arrive(&q_empty[slot], lane);

    // ---- epilogue: o = acc / l and lse, or the chunk's fp32 acc, m and l
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (pslot >= 0) {
        const int r = rl + 8 * hh;
        float* po = p.part + ((size_t)pslot * kSpQRows + r) * HD;
#pragma unroll
        for (int a = 0; a < NAT; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(po + 64 * a + 8 * j + 2 * tq) =
                make_float2(o[a][4 * j + 2 * hh], o[a][4 * j + 2 * hh + 1]);
        if (tq == 0) {
          p.part_ml[((size_t)pslot * 2) * kSpQRows + r] = m[hh];
          p.part_ml[((size_t)pslot * 2 + 1) * kSpQRows + r] = l[hh];
        }
        continue;
      }
      if (rw.head[hh] < 0) continue;
      const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);  // no key seen: zeros
      T* orow = static_cast<T*>(p.o) + (((long long)b * p.T + rw.pos[hh]) * p.N + rw.head[hh]) * HD;
#pragma unroll
      for (int a = 0; a < NAT; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 64 * a + 8 * j + 2 * tq) =
              Mma<T>::pack(o[a][4 * j + 2 * hh] * inv, o[a][4 * j + 2 * hh + 1] * inv);
      if (tq == 0)
        p.lse[((long long)b * p.N + rw.head[hh]) * p.T + rw.pos[hh]] =
            l[hh] == 0.f ? kNegInf : m[hh] * kLn2 + logf(l[hh]);
    }
  }
}

// delta = rowsum(o * do) of a unit's 128 gathered rows into delta[128] (0
// on a pad row), by warp dw (0..2) of three: 8 lanes a row, 4 rows a step,
// each lane 16-byte chunks of o and do (fp32 sums of the 16-bit products);
// taken from p.delta when given, else made and, by a unit's first chunk
// (`write`), written to delta_out [B, N, T].
template <typename T, int HD>
__device__ __forceinline__ void sp_q_delta(const SpQArgs& p, int b, int hk, const int* rows,
                                           float* delta, bool write, int dw, int lane) {
  constexpr int CH = HD / 64;  // chunks a lane a row
  const int group = p.N / p.Nkv;
#pragma unroll 2
  for (int r0 = 4 * dw; r0 < kSpQRows; r0 += 12) {
    const int r = r0 + lane / 8, sg = r >> p.lseg;
    const int j = rows[2 * sg], h = hk * group + max(j, 0);
    const int pos = rows[2 * sg + 1] + (r & ((1 << p.lseg) - 1));
    const long long row = ((long long)b * p.N + h) * p.T + pos;
    float s = 0.f;
    if (p.delta != nullptr) {
      s = j >= 0 ? p.delta[row] : 0.f;
    } else {
      const long long off = (((long long)b * p.T + pos) * p.N + h) * HD;
      const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(p.o) + off);
      const uint4* d = reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + off);
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const uint4 x4 = o[lane % 8 + 8 * t], y4 = d[lane % 8 + 8 * t];
        const uint32_t xw[4] = {x4.x, x4.y, x4.z, x4.w}, yw[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = to_f2<T>(xw[e]), y = to_f2<T>(yw[e]);
          s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (j < 0) s = 0.f;
      if (write && j >= 0 && p.delta_out != nullptr && lane % 8 == 0) p.delta_out[row] = s;
    }
    if (lane % 8 == 0) delta[r] = s;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    sparse_dq_wgmma_kernel(const __grid_constant__ SpQArgs p,
                           const __grid_constant__ CUtensorMap tmq,
                           const __grid_constant__ CUtensorMap tmdo,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv) {
  constexpr int NAT = HD / 64, BN = kSpQKeys, NS = BN / 2;
  static_assert(HD == 64 || HD == 128, "head dims");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* slot_full = bars;
  uint64_t* slot_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = full + kBwdMaxStages;
  unsigned char* base = smem_raw + kBwdBarBytes;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  const SpQLayout lay(HD, true);
  unsigned char* ring = base + p.slots * lay.slot_bytes;
  int* words = reinterpret_cast<int*>(ring + p.stages * lay.stage_bytes);  // [stages][32]
  float* deltas = reinterpret_cast<float*>(words + p.stages * kSpQWords);  // [slots][128]
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  // a slot is full once its Q and dO have landed and the three delta warps
  // have written its rows' delta; a stage once its TMA bytes have landed
  // and the producer warp's 32 lanes have written its words
  if (threadIdx.x == 0) init_bwd_barriers(bars, p.stages, 4, 32);
  __syncthreads();
  const int seg = 1 << p.lseg, group = p.N / p.Nkv;
  const int t0 = __shfl_sync(0xffffffffu, p.blk[blockIdx.x], 0);
  const int t1 = __shfl_sync(0xffffffffu, p.blk[blockIdx.x + 1], 0);

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kEvoDqRegProducer>();  // the delta warps' loads need 80
    const int pw = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (pw > 0) {
      // warps 1-3: each unit's delta rows, a slot ahead of the consumers
      // when there are two
      for (int i = 0, t = t0; t < t1; ++i, ++t) {
        const int* tk = p.tasks + 5 * t;
        const int bh = tk[1], b = bh / p.Nkv, hk = bh - b * p.Nkv;
        const int slot = i % p.slots;
        if (i >= p.slots) mbar_wait(&slot_empty[slot], (i / p.slots - 1) & 1);
        sp_q_delta<T, HD>(p, b, hk, p.rows + tk[0] * p.R * 2, deltas + slot * kSpQRows,
                          tk[2] == 0, pw - 1, lane);
        warp_arrive(&slot_full[slot], lane);
      }
      return;
    }
    int it = 0;
    for (int i = 0, t = t0; t < t1; ++i, ++t) {
      const int* tk = p.tasks + 5 * t;
      const int pu = tk[0], bh = tk[1], s0 = tk[2], s1 = tk[3];
      const int b = bh / p.Nkv, hk = bh - b * p.Nkv;
      const int* rows = p.rows + pu * p.R * 2;
      const int st0 = p.ust[2 * pu];
      if (lane == 0) {
        const int slot = i % p.slots;
        if (i >= p.slots) mbar_wait(&slot_empty[slot], (i / p.slots - 1) & 1);
        unsigned char* sl = base + slot * lay.slot_bytes;
        mbar_expect_tx(&slot_full[slot], lay.slot_bytes);
        for (int r = 0; r < p.R; ++r) {
          const int h = hk * group + max(rows[2 * r], 0), q0 = rows[2 * r + 1];
#pragma unroll
          for (int cb = 0; cb < NAT; ++cb) {
            tma_load_4d(sl + cb * kSpQRows * 128 + r * seg * 128, &tmq, cb * 64,
                        tma_c(p.cq, 1, h), q0, tma_c(p.cq, 3, b), &slot_full[slot]);
            tma_load_4d(sl + lay.tile + cb * kSpQRows * 128 + r * seg * 128, &tmdo, cb * 64,
                        tma_c(p.cdo, 1, h), q0, tma_c(p.cdo, 3, b), &slot_full[slot]);
          }
        }
      }
      for (int si = s0; si < s1; ++si, ++it) {
        const int s = it % p.stages;
        if (it >= p.stages) mbar_wait(&empty[s], (it / p.stages - 1) & 1);
        sp_q_stage<HD, BN>(p, st0 + si, hk, b, ring + (size_t)s * lay.stage_bytes,
                       words + s * kSpQWords, &tmk, &tmv, lay.stage_bytes, &full[s], lane);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kEvoDqRegConsumer>();
  const int c = wg - 1;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  const int rl = 64 * c + 16 * w + grp;  // this thread's rows rl, rl + 8 of a unit
  const float scale2 = p.scale * kLog2e;
  float acc[NAT][32];
  float sc[NS], dp[NS];
  uint32_t da[BN / 16][4];
  // each product pins only its own registers: sc and dp are dead while
  // dq's product runs (zeroed, so nothing of them lives across it)
  auto fence_ss = [&]() {
    wg_fence_regs(sc);
    wg_fence_regs(dp);
  };
  auto fence_rs = [&]() {
#pragma unroll
    for (int a = 0; a < NAT; ++a) wg_fence_regs(acc[a]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wg_fence_regs(da[kk]);
  };
#pragma unroll
  for (int j = 0; j < NS; ++j) sc[j] = dp[j] = 0.f;
  int it = 0;
  if (c == 1) turn_pass(c);  // the first consumer warpgroup takes the first turn
  for (int i = 0, t = t0; t < t1; ++i, ++t) {
    const int* tk = p.tasks + 5 * t;
    const int pu = tk[0], bh = tk[1], pslot = tk[4];
    const int n = __shfl_sync(0xffffffffu, tk[3] - tk[2], 0);  // steers the wgmmas
    const int b = bh / p.Nkv, hk = bh - b * p.Nkv;
    const int slot = i % p.slots;
    // the rows' positions and lse (log2 units; +inf: a pad row or one that
    // sees no key) stay in registers across the walk, their delta is read
    // from the slot each stage
    int pos[2];
    float lse2[2];
    {
      const SpQRows rw(p, p.rows + pu * p.R * 2, hk, rl);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        pos[hh] = rw.pos[hh];
        lse2[hh] = rw.head[hh] < 0
                       ? __int_as_float(0x7f800000)
                       : dead_or_log2(p.lse[((long long)b * p.N + rw.head[hh]) * p.T + pos[hh]]);
      }
    }
#pragma unroll
    for (int a = 0; a < NAT; ++a)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[a][j] = 0.f;
    mbar_wait(&slot_full[slot], (i / p.slots) & 1);
    const float* dl = deltas + slot * kSpQRows + rl;
    const unsigned char* qs = base + slot * lay.slot_bytes + c * 64 * 128;
    const unsigned char* dos = qs + lay.tile;
    for (int item = 0; item < n; ++item, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const unsigned char* ks = ring + (size_t)s * lay.stage_bytes;
      const unsigned char* vs = ks + lay.kv_tile;
      // s = q kT, dp = do vT
      fence_ss();
      turn_wait(c);
      wg_fence();
      kmajor_product<T, HD, BN>(sc, qs, kSpQRows, ks);
      kmajor_product<T, HD, BN>(dp, dos, kSpQRows, vs);
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      fence_ss();
      // ds = p (dp - delta) scale, p = 2^(s scale2 - lse2); selected to 0
      // where the row does not see the key (a dead block's rows may hold
      // anything)
      const uint64_t vis = sp_q_visible<BN>(p, words + s * kSpQWords, rl, pos, tq);
      const float dls[2] = {-dl[0] * p.scale, -dl[8] * p.scale};  // -delta * scale
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int hh = (x >> 1) & 1;
        const float pr = ex2(fmaf(sc[x], scale2, -lse2[hh]));
        sc[x] = (vis >> x) & 1 ? pr * fmaf(dp[x], p.scale, dls[hh]) : 0.f;
      }
      pack_a<T, BN>(da, sc);
#pragma unroll
      for (int x = 0; x < NS; ++x) sc[x] = dp[x] = 0.f;
      // dq += ds k: k read MN-major from the same tile
      fence_rs();
      turn_wait(c);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int a = 0; a < NAT; ++a)
          Wgmma<T>::rs64(acc[a], da[kk], wg_desc(ks + a * BN * 128 + kk * 16 * 128));
      wg_commit();
      turn_pass(c);
      wg_wait<0>();
      fence_rs();
      warp_arrive(&empty[s], lane);
    }
    warp_arrive(&slot_empty[slot], lane);

    // ---- epilogue: dq rows, or the chunk's fp32 partial
    const SpQRows rw(p, p.rows + pu * p.R * 2, hk, rl);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (pslot >= 0) {
        float* pq = p.part + ((size_t)pslot * kSpQRows + rl + 8 * hh) * HD;
#pragma unroll
        for (int a = 0; a < NAT; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(pq + 64 * a + 8 * j + 2 * tq) =
                make_float2(acc[a][4 * j + 2 * hh], acc[a][4 * j + 2 * hh + 1]);
        continue;
      }
      if (rw.head[hh] < 0) continue;
      T* out = static_cast<T*>(p.dq) + (((long long)b * p.T + rw.pos[hh]) * p.N + rw.head[hh]) * HD;
#pragma unroll
      for (int a = 0; a < NAT; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 64 * a + 8 * j + 2 * tq) =
              Mma<T>::pack(acc[a][4 * j + 2 * hh], acc[a][4 * j + 2 * hh + 1]);
    }
  }
}

// The split walks' second pass of the forward and dq: for each merge
// [pattern, batch * Nkv + kv head, first part, chunks], each real row of
// the unit from its chunks in chunk order.  Forward (DQ false): o = sum of
// acc_c 2^(m_c - M) over sum of l_c 2^(m_c - M), M the chunks' largest m
// (log2 units; a chunk that saw no key of the row weighs 0), lse = M ln 2 +
// log(sum) (-1e30 and o = 0 where no chunk saw a key); dq: the partials
// added.  One block a merge, four values a thread a step, rounded once.
template <typename T, bool DQ>
__global__ void __launch_bounds__(256)
    sparse_q_merge_kernel(const float* __restrict__ part, const float* __restrict__ ml,
                          const int* __restrict__ merges, const int* __restrict__ rows, void* out,
                          float* lse, int Tlen, int N, int Nkv, int hd, int R) {
  const int* mg = merges + 4 * blockIdx.x;
  const int pu = mg[0], bh = mg[1], p0 = mg[2], n = mg[3];
  const int b = bh / Nkv, hk = bh - b * Nkv, group = N / Nkv, seg = kSpQRows / R;
  const int* rw = rows + pu * R * 2;
  for (int e = 4 * threadIdx.x; e < kSpQRows * hd; e += 4 * blockDim.x) {
    const int row = e / hd, cc = e - row * hd, sg = row / seg;
    if (rw[2 * sg] < 0) continue;
    const int h = hk * group + rw[2 * sg], pos = rw[2 * sg + 1] + row % seg;
    const float* src = part + (size_t)p0 * kSpQRows * hd + e;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    float top = -INFINITY, tot = 0.f;
    if (DQ) {
      s = *reinterpret_cast<const float4*>(src);
    } else {
      for (int k = 0; k < n; ++k) top = fmaxf(top, ml[(size_t)(p0 + k) * 2 * kSpQRows + row]);
    }
    for (int k = DQ ? 1 : 0; k < n; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(src + (size_t)k * kSpQRows * hd);
      float wk = 1.f;
      if (!DQ) {
        const float mk = ml[(size_t)(p0 + k) * 2 * kSpQRows + row];
        wk = mk == -INFINITY ? 0.f : exp2f(mk - top);
        tot += ml[((size_t)(p0 + k) * 2 + 1) * kSpQRows + row] * wk;
      }
      s.x += v.x * wk;
      s.y += v.y * wk;
      s.z += v.z * wk;
      s.w += v.w * wk;
    }
    const float inv = DQ ? 1.f : 1.f / (tot == 0.f ? 1.f : tot);
    const float vals[4] = {s.x * inv, s.y * inv, s.z * inv, s.w * inv};
    store4<T>(static_cast<T*>(out) + (((long long)b * Tlen + pos) * N + h) * hd + cc, vals);
    if (!DQ && cc == 0)
      lse[((long long)b * N + h) * Tlen + pos] = tot == 0.f ? kNegInf : top * kLn2 + logf(tot);
  }
}

// ------------------------------------------------- CUDA-core family (simt)
// fp32 inputs, and the 16-bit calls the tensor-core kernels above do not
// take (a block that is not a multiple of 16 or above 128, a head_dim
// other than 64 / 128).  One warp a query row (forward, dq) or key row (dk/dv), 8 warps a
// block; lane l owns the columns l, l + 32, ... of the row (VEC = HD / 32,
// past p.hd zero), and a warp reduction gives each score.  The warp walks
// the same tables as the tensor-core kernels at the layout's own block
// size, so a dead block - any size, 8 x 8 included - is never read; rows
// are read straight from device memory (L1 keeps the block's shared keys).
// The arithmetic is the plain version's: fp32 scores, probabilities (ds)
// rounded to the input type before their products.
constexpr int kSimtWarps = 8;

template <typename T, int HD>
__global__ void __launch_bounds__(kSimtWarps * 32) sparse_fwd_simt(SparseArgs p) {
  constexpr int VEC = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qpos = blockIdx.x * kSimtWarps + warp;  // T % 8 == 0: every row exists
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.N / p.Nkv);
  const int ib = qpos / p.bs;
  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;
  float qr[VEC];
  ld_cols_t<T, VEC>(qb + (long long)qpos * p.q_st, lane, p.hd, qr);
  RowState<VEC> st;
  st.init();
  const int n = p.cnt[ib];
  const int* cols = p.tab + (long long)ib * p.tab_w;
  for (int it = 0; it < n; ++it) {
    const int k0 = cols[it] * p.bs;
    const int k1 = p.causal ? min(k0 + p.bs, qpos + 1) : k0 + p.bs;
    for (int kpos = k0; kpos < k1; ++kpos) {
      float kr[VEC], vr[VEC];
      ld_cols_t<T, VEC>(kb + (long long)kpos * p.k_st, lane, p.hd, kr);
      ld_cols_t<T, VEC>(vb + (long long)kpos * p.v_st, lane, p.hd, vr);
      st.template update<T>(warp_sum_dot<VEC>(qr, kr) * p.scale, vr);
    }
  }
  const float ll = st.l == 0.f ? 1.f : st.l;  // dead row block: zeros, lse -1e30
  st_cols_t<T, VEC>(static_cast<T*>(p.o) + (((long long)b * p.T + qpos) * p.N + h) * p.hd, lane,
                    p.hd, st.acc, 1.f / ll);
  if (lane == 0) p.lse_out[((long long)b * p.N + h) * p.T + qpos] = st.m + logf(ll);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kSimtWarps * 32) sparse_dq_simt(SparseArgs p) {
  constexpr int VEC = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qpos = blockIdx.x * kSimtWarps + warp;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.N / p.Nkv);
  const int ib = qpos / p.bs;
  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh;
  const long long row = ((long long)b * p.T + qpos) * p.N + h;
  const long long r = ((long long)b * p.N + h) * p.T + qpos;
  const float lse = p.lse[r], delta = p.delta[r];
  float qr[VEC], dor[VEC], acc[VEC];
  ld_cols_t<T, VEC>(qb + (long long)qpos * p.q_st, lane, p.hd, qr);
  ld_cols_t<T, VEC>(static_cast<const T*>(p.dout) + row * p.hd, lane, p.hd, dor);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const int n = lse > 0.5f * kNegInf ? p.cnt[ib] : 0;  // a dead row: zeros
  const int* cols = p.tab + (long long)ib * p.tab_w;
  for (int it = 0; it < n; ++it) {
    const int k0 = cols[it] * p.bs;
    const int k1 = p.causal ? min(k0 + p.bs, qpos + 1) : k0 + p.bs;
    for (int kpos = k0; kpos < k1; ++kpos) {
      float kr[VEC], vr[VEC];
      ld_cols_t<T, VEC>(kb + (long long)kpos * p.k_st, lane, p.hd, kr);
      ld_cols_t<T, VEC>(vb + (long long)kpos * p.v_st, lane, p.hd, vr);
      const float s = warp_sum_dot<VEC>(qr, kr) * p.scale;
      const float dp = warp_sum_dot<VEC>(dor, vr);
      const float ds = Bits<T>::round(expf(s - lse) * (dp - delta) * p.scale);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += ds * kr[j];
    }
  }
  st_cols_t<T, VEC>(static_cast<T*>(p.dq) + row * p.hd, lane, p.hd, acc, 1.f);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kSimtWarps * 32) sparse_dkv_simt(SparseArgs p) {
  constexpr int VEC = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kpos = blockIdx.x * kSimtWarps + warp;
  const int hk = blockIdx.y, b = blockIdx.z, group = p.N / p.Nkv;
  const int jb = kpos / p.bs;
  float kr[VEC], vr[VEC], dk[VEC], dv[VEC];
  ld_cols_t<T, VEC>(static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * p.k_sh +
                        (long long)kpos * p.k_st, lane, p.hd, kr);
  ld_cols_t<T, VEC>(static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * p.v_sh +
                        (long long)kpos * p.v_st, lane, p.hd, vr);
#pragma unroll
  for (int j = 0; j < VEC; ++j) dk[j] = dv[j] = 0.f;
  const int n = p.cnt[jb];
  const int* rows = p.tab + (long long)jb * p.tab_w;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * p.q_sh;
    for (int it = 0; it < n; ++it) {
      const int r0 = rows[it] * p.bs;
      for (int qpos = p.causal ? max(r0, kpos) : r0; qpos < r0 + p.bs; ++qpos) {
        const long long r = ((long long)b * p.N + h) * p.T + qpos;
        const float lse = p.lse[r];
        if (lse <= 0.5f * kNegInf) continue;  // a dead row adds nothing
        float qr[VEC], dor[VEC];
        ld_cols_t<T, VEC>(qb + (long long)qpos * p.q_st, lane, p.hd, qr);
        ld_cols_t<T, VEC>(static_cast<const T*>(p.dout) +
                              (((long long)b * p.T + qpos) * p.N + h) * p.hd, lane, p.hd, dor);
        const float pr = expf(warp_sum_dot<VEC>(qr, kr) * p.scale - lse);
        const float ds = pr * (warp_sum_dot<VEC>(dor, vr) - p.delta[r]) * p.scale;
        const float prr = Bits<T>::round(pr), dsr = Bits<T>::round(ds);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          dv[j] += prr * dor[j];
          dk[j] += dsr * qr[j];
        }
      }
    }
  }
  const long long out = (((long long)b * p.T + kpos) * p.Nkv + hk) * p.hd;
  st_cols_t<T, VEC>(static_cast<T*>(p.dk) + out, lane, p.hd, dk, 1.f);
  st_cols_t<T, VEC>(static_cast<T*>(p.dv) + out, lane, p.hd, dv, 1.f);
}

// ----------------------------------------------------------------- launchers
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// q heads a block serves at once: the largest divisor of the GQA group that
// keeps the block at kSpMaxWarps warps or fewer
inline int heads_per_block(int group, int wpr) {
  int best = 1;
  for (int d = 1; d <= group; ++d)
    if (group % d == 0 && d * wpr <= kSpMaxWarps) best = d;
  return best;
}

template <typename T, int HD>
cudaError_t launch_sparse_t(int which, SparseArgs a, cudaStream_t st) {
  constexpr int LD = HD + 8;
  const int nb = a.T / a.bs, wpr = a.bs / 16;
  cudaError_t err;
  a.hpb = heads_per_block(a.N / a.Nkv, wpr);
  if (which == kDkv) {
    const size_t smem = (2 + 4 * (size_t)a.hpb) * a.bs * LD * sizeof(T) +
                        4 * (size_t)a.hpb * a.bs * sizeof(float);
    err = allow_dynamic_smem<sparse_dkv_kernel<T, HD>>();
    if (err != cudaSuccess) return err;
    sparse_dkv_kernel<T, HD><<<dim3(nb, a.Nkv, a.B), wpr * a.hpb * 32, smem, st>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = 4 * (size_t)a.bs * LD * sizeof(T);
  const dim3 grid(nb, a.N / a.hpb, a.B);
  const int threads = wpr * a.hpb * 32;
  if (which == kFwd) {
    err = allow_dynamic_smem<sparse_fwd_kernel<T, HD>>();
    if (err != cudaSuccess) return err;
    sparse_fwd_kernel<T, HD><<<grid, threads, smem, st>>>(a);
  } else {
    err = allow_dynamic_smem<sparse_dq_kernel<T, HD>>();
    if (err != cudaSuccess) return err;
    sparse_dq_kernel<T, HD><<<grid, threads, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_simt_t(int which, const SparseArgs& a, cudaStream_t st) {
  const dim3 grid(a.T / kSimtWarps, which == kDkv ? a.Nkv : a.N, a.B);
  if (which == kFwd)
    sparse_fwd_simt<T, HD><<<grid, kSimtWarps * 32, 0, st>>>(a);
  else if (which == kDq)
    sparse_dq_simt<T, HD><<<grid, kSimtWarps * 32, 0, st>>>(a);
  else
    sparse_dkv_simt<T, HD><<<grid, kSimtWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

// the CUDA-core family's widths: head_dim padded up to the first that holds it
template <typename T>
cudaError_t launch_simt(int which, const SparseArgs& a, cudaStream_t st) {
  if (a.hd <= 64) return launch_simt_t<T, 64>(which, a, st);
  if (a.hd <= 128) return launch_simt_t<T, 128>(which, a, st);
  return launch_simt_t<T, 256>(which, a, st);
}

// The kernels a call takes, forward, dq and dk/dv alike
// (ops/sparse_attention.py sparse_dkv_route, the same rule): 2 the wgmma
// kernels (16-bit, head_dim 64 / 128, a block that divides 128), 1 the
// mma.sync kernels (the other 16-bit blocks that are a multiple of 16 up to
// 128), 0 the CUDA-core family.
inline int dkv_route(int dtype, int hd, int bs) {
  if (dtype == 0 || (hd != 64 && hd != 128) || bs % 16 != 0 || bs > 128) return 0;
  return kSpKeys % bs == 0 ? 2 : 1;
}

inline bool sparse_shape_ok(const SparseArgs& a) {
  return !(a.B < 1 || a.T < 1 || a.N < 1 || a.Nkv < 1 || a.N % a.Nkv != 0 || a.B > 65535 ||
           a.N > 65535 || a.bs < 8 || a.bs % 8 != 0 || a.T % a.bs != 0 || a.hd < 8 ||
           a.hd > 256 || a.hd % 8 != 0);
}

// The tensor-core kernels take 16-bit inputs, head_dim 64 or 128 and a
// block that is a multiple of 16 up to 128; every other call the C
// interface takes (fp32, any block that is a multiple of 8, head_dim a
// multiple of 8 up to 256) runs on the CUDA-core family.  A call on the
// wgmma route has its own entries (ds_sparse_q_wgmma, ds_sparse_dkv_wgmma)
// and is refused here.
inline cudaError_t launch_sparse(int which, int dtype, const SparseArgs& a, void* stream) {
  if (!sparse_shape_ok(a) || a.tab_w < 1 || dkv_route(dtype, a.hd, a.bs) == 2)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const bool mma = a.bs % 16 == 0 && a.bs <= 128 && (a.hd == 64 || a.hd == 128);
  if (dtype == 0) return launch_simt<float>(which, a, st);
  if (dtype == 1) {
    if (!mma) return launch_simt<__half>(which, a, st);
    if (a.hd == 64) return launch_sparse_t<__half, 64>(which, a, st);
    return launch_sparse_t<__half, 128>(which, a, st);
  }
  if (dtype == 2) {
    if (!mma) return launch_simt<__nv_bfloat16>(which, a, st);
    if (a.hd == 64) return launch_sparse_t<__nv_bfloat16, 64>(which, a, st);
    return launch_sparse_t<__nv_bfloat16, 128>(which, a, st);
  }
  return cudaErrorInvalidValue;
}

// dk/dv on sparse_dkv_wgmma_kernel: q, do [B, T, N, hd] and k, v [B, T,
// Nkv, hd] as 4-D tensor maps (hd, head, token, batch) in the 128-byte
// swizzle, q and do in boxes of one segment (min(bs, 64) rows), k and v of
// one column block (bs rows); do contiguous.
template <typename T, int HD>
cudaError_t launch_dkv_wgmma_t(const SparseArgs& a, SpDkvArgs p, int grid, cudaStream_t st) {
  const long long dq[4] = {a.hd, a.N, a.T, a.B}, dkv[4] = {a.hd, a.Nkv, a.T, a.B};
  const long long sq[4] = {1, a.q_sh, a.q_st, a.q_sb}, sk[4] = {1, a.k_sh, a.k_st, a.k_sb},
                  sv[4] = {1, a.v_sh, a.v_st, a.v_sb},
                  sdo[4] = {1, a.hd, (long long)a.N * a.hd, (long long)a.T * a.N * a.hd};
  const int box_q[4] = {64, 1, 1 << p.lseg, 1}, box_kv[4] = {64, 1, a.bs, 1};
  CUtensorMap tmq{}, tmdo{}, tmk{}, tmv{};
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_nd(&tmq, tma_dtype<T>(), 2, a.q, 4, dq, sq, box_q, sw, &p.cq) ||
      !tensor_map_nd(&tmdo, tma_dtype<T>(), 2, a.dout, 4, dq, sdo, box_q, sw, &p.cdo) ||
      !tensor_map_nd(&tmk, tma_dtype<T>(), 2, a.k, 4, dkv, sk, box_kv, sw, &p.ck) ||
      !tensor_map_nd(&tmv, tma_dtype<T>(), 2, a.v, 4, dkv, sv, box_kv, sw, &p.cv))
    return cudaErrorInvalidValue;
  const size_t smem = SpDkvLayout(HD).smem(p.stages, p.slots);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (p.stages < 1 || p.stages > kBwdMaxStages || p.slots < 1 || p.slots > 2 || grid < 1 ||
      smem > (size_t)optin)
    return cudaErrorInvalidValue;
  err = allow_dynamic_smem<sparse_dkv_wgmma_kernel<T, HD>>();
  if (err != cudaSuccess) return err;
  sparse_dkv_wgmma_kernel<T, HD><<<grid, kBwdThreads, smem, st>>>(p, tmk, tmv, tmq, tmdo);
  return cudaGetLastError();
}

// forward (kFwd) or dq (kDq) on the wgmma kernels: q, do [B, T, N, hd]
// and k, v [B, T, Nkv, hd] as 4-D tensor maps (hd, head, token, batch) in
// the 128-byte swizzle, q and do in boxes of one segment (seg rows), k and
// v of one key block (min(bs, 64) keys); do contiguous.
template <typename T, int HD>
cudaError_t launch_q_wgmma_t(int which, const SparseArgs& a, SpQArgs p, int grid, cudaStream_t st) {
  const long long dq[4] = {a.hd, a.N, a.T, a.B}, dkv[4] = {a.hd, a.Nkv, a.T, a.B};
  const long long sq[4] = {1, a.q_sh, a.q_st, a.q_sb}, sk[4] = {1, a.k_sh, a.k_st, a.k_sb},
                  sv[4] = {1, a.v_sh, a.v_st, a.v_sb},
                  sdo[4] = {1, a.hd, (long long)a.N * a.hd, (long long)a.T * a.N * a.hd};
  const int box_q[4] = {64, 1, 1 << p.lseg, 1}, box_kv[4] = {64, 1, 1 << p.lkb, 1};
  CUtensorMap tmq{}, tmdo{}, tmk{}, tmv{};
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_nd(&tmq, tma_dtype<T>(), 2, a.q, 4, dq, sq, box_q, sw, &p.cq) ||
      !tensor_map_nd(&tmk, tma_dtype<T>(), 2, a.k, 4, dkv, sk, box_kv, sw, &p.ck) ||
      !tensor_map_nd(&tmv, tma_dtype<T>(), 2, a.v, 4, dkv, sv, box_kv, sw, &p.cv) ||
      (which == kDq && !tensor_map_nd(&tmdo, tma_dtype<T>(), 2, a.dout, 4, dq, sdo, box_q, sw,
                                      &p.cdo)))
    return cudaErrorInvalidValue;
  const SpQLayout lay(HD, which == kDq);
  const size_t smem = lay.smem(p.stages, p.slots, which == kDq ? kBwdBarBytes : kFwdBarBytes);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (p.stages < 1 || p.stages > kBwdMaxStages || p.slots < 1 || p.slots > 2 || grid < 1 ||
      smem > (size_t)optin)
    return cudaErrorInvalidValue;
  if (which == kFwd) {
    err = allow_dynamic_smem<sparse_fwd_wgmma_kernel<T, HD>>();
    if (err != cudaSuccess) return err;
    sparse_fwd_wgmma_kernel<T, HD><<<grid, kFwdThreads, smem, st>>>(p, tmq, tmk, tmv);
  } else {
    err = allow_dynamic_smem<sparse_dq_wgmma_kernel<T, HD>>();
    if (err != cudaSuccess) return err;
    sparse_dq_wgmma_kernel<T, HD><<<grid, kBwdThreads, smem, st>>>(p, tmq, tmdo, tmk, tmv);
  }
  return cudaGetLastError();
}

}  // namespace dsk

// q [B, T, N, hd], k/v [B, T, Nkv, hd] read through element strides
// (batch, token, head; head_dim contiguous); o, dout, dq [B, T, N, hd] and
// dk, dv [B, T, Nkv, hd] contiguous; lse, delta [B, N, T] fp32; tab
// [T/bs, tab_w] int32 and cnt [T/bs] int32 on the device (fwd / dq: the
// row-major table, dkv: the column-major one).  dtype: 0 fp32, 1 fp16,
// 2 bf16.
extern "C" int ds_sparse_fwd(const void* q, const void* k, const void* v, const void* tab,
                             const void* cnt, int tab_w, void* o, void* lse, int B, int T, int N,
                             int Nkv, int hd, int bs, long long q_sb, long long q_st,
                             long long q_sh, long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh, float scale,
                             int causal, int dtype, void* stream) {
  dsk::SparseArgs a{};
  a.q = q; a.k = k; a.v = v;
  a.tab = static_cast<const int*>(tab); a.cnt = static_cast<const int*>(cnt); a.tab_w = tab_w;
  a.o = o; a.lse_out = static_cast<float*>(lse);
  a.B = B; a.T = T; a.N = N; a.Nkv = Nkv; a.bs = bs; a.hd = hd;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh; a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.scale = scale; a.causal = causal;
  return (int)dsk::launch_sparse(dsk::kFwd, dtype, a, stream);
}

// which: 1 writes dq, 2 writes dk and dv (the pointers not written may be null)
extern "C" int ds_sparse_bwd(int which, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* tab, const void* cnt, int tab_w, void* dq, void* dk,
                             void* dv, int B, int T, int N, int Nkv, int hd, int bs,
                             long long q_sb, long long q_st, long long q_sh, long long k_sb,
                             long long k_st, long long k_sh, long long v_sb, long long v_st,
                             long long v_sh, float scale, int causal, int dtype, void* stream) {
  if (which != dsk::kDq && which != dsk::kDkv) return (int)cudaErrorInvalidValue;
  dsk::SparseArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.tab = static_cast<const int*>(tab); a.cnt = static_cast<const int*>(cnt); a.tab_w = tab_w;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.T = T; a.N = N; a.Nkv = Nkv; a.bs = bs; a.hd = hd;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh; a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.scale = scale; a.causal = causal;
  return (int)dsk::launch_sparse(which, dtype, a, stream);
}

// The call's kernels (ops/sparse_attention.py sparse_dkv_route): 2 wgmma
// (ds_sparse_q_wgmma, ds_sparse_dkv_wgmma), 1 mma.sync, 0 CUDA cores (both
// ds_sparse_fwd / ds_sparse_bwd).  dtype: 0 fp32, 1 fp16, 2 bf16.
extern "C" int ds_sparse_dkv_route(int dtype, int hd, int bs) { return dsk::dkv_route(dtype, hd, bs); }

// dk, dv on sparse_dkv_wgmma_kernel, the call's plan from
// ops/sparse_attention.py sparse_dkv_plan: its tables (cols [groups, G],
// gst [groups, 2], seg / live [stages, R], tasks [tasks, 5], blk [grid +
// 1], int32 on the device), ring depth and slots; part [parts, 2, 128, hd]
// fp32 the split walks' partials (null if none).  q, k, v, do, lse, delta,
// strides and dtype as ds_sparse_bwd; the call must take the wgmma route.
extern "C" int ds_sparse_dkv_wgmma(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* cols, const void* gst, const void* seg,
                                   const void* live, const void* tasks, const void* blk,
                                   int grid, int G, int R, int stages, int slots, void* part,
                                   void* dk, void* dv, int B, int T, int N, int Nkv, int hd,
                                   int bs, long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh, float scale,
                                   int causal, int dtype, void* stream) {
  dsk::SparseArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.B = B; a.T = T; a.N = N; a.Nkv = Nkv; a.bs = bs; a.hd = hd;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh; a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  const int seg_len = bs < dsk::kSpRows ? bs : dsk::kSpRows;
  if (!dsk::sparse_shape_ok(a) || dsk::dkv_route(dtype, hd, bs) != 2 ||
      G != dsk::kSpKeys / bs || R != dsk::kSpRows / seg_len || lse == nullptr ||
      delta == nullptr || dout == nullptr || tasks == nullptr || blk == nullptr)
    return (int)cudaErrorInvalidValue;
  dsk::SpDkvArgs p{};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk; p.dv = dv; p.part = static_cast<float*>(part);
  p.cols = static_cast<const int*>(cols); p.gst = static_cast<const int*>(gst);
  p.seg = static_cast<const int*>(seg); p.live = static_cast<const int*>(live);
  p.tasks = static_cast<const int*>(tasks); p.blk = static_cast<const int*>(blk);
  p.T = T; p.N = N; p.Nkv = Nkv; p.bs = bs; p.G = G; p.R = R;
  p.lbs = __builtin_ctz(bs);
  p.lseg = __builtin_ctz(seg_len);
  p.causal = causal; p.stages = stages; p.slots = slots; p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(hd == 64 ? dsk::launch_dkv_wgmma_t<__half, 64>(a, p, grid, st)
                          : dsk::launch_dkv_wgmma_t<__half, 128>(a, p, grid, st));
  return (int)(hd == 64 ? dsk::launch_dkv_wgmma_t<__nv_bfloat16, 64>(a, p, grid, st)
                        : dsk::launch_dkv_wgmma_t<__nv_bfloat16, 128>(a, p, grid, st));
}

// The split walks' second pass (sparse_dkv_merge_kernel): `nmerge` merges
// [group, batch * Nkv + kv head, first part, chunks] of part [parts, 2,
// 128, hd] fp32 into dk, dv [B, T, Nkv, hd] (16-bit, contiguous) at the
// group's keys (cols [groups, 128 / bs]).
extern "C" int ds_sparse_dkv_merge(const void* part, const void* merges, const void* cols,
                                   int nmerge, void* dk, void* dv, int T, int Nkv, int hd,
                                   int bs, int dtype, void* stream) {
  if (nmerge < 1 || part == nullptr || merges == nullptr || cols == nullptr ||
      (hd != 64 && hd != 128) || bs < 16 || dsk::kSpKeys % bs != 0 || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int G = dsk::kSpKeys / bs;
  const float* pt = static_cast<const float*>(part);
  const int* m = static_cast<const int*>(merges);
  const int* c = static_cast<const int*>(cols);
  if (dtype == 1)
    dsk::sparse_dkv_merge_kernel<__half><<<nmerge, 256, 0, st>>>(pt, m, c, dk, dv, T, Nkv, hd,
                                                                 bs, G);
  else
    dsk::sparse_dkv_merge_kernel<__nv_bfloat16><<<nmerge, 256, 0, st>>>(pt, m, c, dk, dv, T,
                                                                        Nkv, hd, bs, G);
  return (int)cudaGetLastError();
}

// The forward (which 0: o [B, T, N, hd] and lse [B, N, T] written) or dq
// (1: dq written; delta [B, N, T] read, or null: made from o and dout, and
// written to delta_out by each unit's first chunk if that is not null) on
// sparse_fwd_wgmma_kernel / sparse_dq_wgmma_kernel, the call's plan from
// ops/sparse_attention.py sparse_q_plan: its tables (rows [patterns, R,
// 2], ust [patterns, 2], kst [stages, C], live [stages, R], tasks [tasks,
// 5], blk [grid + 1], int32 on the device), ring depth and slots; part
// [parts, 128, hd] and (forward) part_ml [parts, 2, 128] fp32 the split
// walks' partials (null if none).  q, k, v, dout, lse, strides and dtype as
// ds_sparse_bwd; the call must take the wgmma route.
extern "C" int ds_sparse_q_wgmma(int which, const void* q, const void* k, const void* v, void* o,
                                 const void* dout, void* lse, const void* delta, void* delta_out,
                                 void* dq, void* part, void* part_ml, const void* rows,
                                 const void* ust, const void* kst, const void* live,
                                 const void* tasks, const void* blk, int grid, int R, int C,
                                 int stages, int slots, int B, int T, int N, int Nkv, int hd,
                                 int bs, long long q_sb, long long q_st, long long q_sh,
                                 long long k_sb, long long k_st, long long k_sh, long long v_sb,
                                 long long v_st, long long v_sh, float scale, int causal,
                                 int dtype, void* stream) {
  dsk::SparseArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.B = B; a.T = T; a.N = N; a.Nkv = Nkv; a.bs = bs; a.hd = hd;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh; a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  const int seg = R > 0 ? dsk::kSpQRows / R : 0, kb = bs < dsk::kSpQKeys ? bs : dsk::kSpQKeys;
  const bool fwd = which == dsk::kFwd;
  if (!dsk::sparse_shape_ok(a) || dsk::dkv_route(dtype, hd, bs) != 2 ||
      (which != dsk::kFwd && which != dsk::kDq) || R < 2 || R > dsk::kSpQLive ||
      seg * R != dsk::kSpQRows || (seg & (seg - 1)) != 0 || seg > bs ||
      C * kb != (fwd ? dsk::kSpQFwdKeys : dsk::kSpQKeys) || lse == nullptr ||
      rows == nullptr || ust == nullptr || kst == nullptr || live == nullptr ||
      tasks == nullptr || blk == nullptr ||
      (fwd && o == nullptr) ||
      (!fwd && (dout == nullptr || dq == nullptr || (delta == nullptr && o == nullptr))))
    return (int)cudaErrorInvalidValue;
  dsk::SpQArgs p{};
  p.o = o; p.lse = static_cast<float*>(lse); p.dout = dout;
  p.delta = static_cast<const float*>(delta); p.delta_out = static_cast<float*>(delta_out);
  p.dq = dq; p.part = static_cast<float*>(part); p.part_ml = static_cast<float*>(part_ml);
  p.rows = static_cast<const int*>(rows); p.ust = static_cast<const int*>(ust);
  p.kst = static_cast<const int*>(kst); p.live = static_cast<const int*>(live);
  p.tasks = static_cast<const int*>(tasks); p.blk = static_cast<const int*>(blk);
  p.T = T; p.N = N; p.Nkv = Nkv; p.hd = hd; p.R = R; p.C = C;
  p.lseg = __builtin_ctz(seg);
  p.lkb = __builtin_ctz(kb);
  p.causal = causal; p.stages = stages; p.slots = slots; p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(hd == 64 ? dsk::launch_q_wgmma_t<__half, 64>(which, a, p, grid, st)
                          : dsk::launch_q_wgmma_t<__half, 128>(which, a, p, grid, st));
  return (int)(hd == 64 ? dsk::launch_q_wgmma_t<__nv_bfloat16, 64>(which, a, p, grid, st)
                        : dsk::launch_q_wgmma_t<__nv_bfloat16, 128>(which, a, p, grid, st));
}

// The forward's and dq's split walks' second pass (sparse_q_merge_kernel):
// which 0 combines the forward's part [parts, 128, hd] and ml [parts, 2,
// 128] into o [B, T, N, hd] and lse [B, N, T]; 1 adds dq's part into dq;
// `nmerge` merges [pattern, batch * Nkv + kv head, first part, chunks], the
// plan's rows [patterns, R, 2] (16-bit out, contiguous).
extern "C" int ds_sparse_q_merge(int which, const void* part, const void* ml, const void* merges,
                                 const void* rows, int nmerge, void* out, void* lse, int T, int N,
                                 int Nkv, int hd, int R, int dtype, void* stream) {
  if (nmerge < 1 || part == nullptr || merges == nullptr || rows == nullptr || out == nullptr ||
      (which != 0 && which != 1) || (which == 0 && (ml == nullptr || lse == nullptr)) ||
      (hd != 64 && hd != 128) || R < 2 || R > dsk::kSpQLive || dsk::kSpQRows % R != 0 ||
      T < 1 || Nkv < 1 || N % Nkv != 0 || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const float* pt = static_cast<const float*>(part);
  const float* m = static_cast<const float*>(ml);
  const int* mg = static_cast<const int*>(merges);
  const int* rw = static_cast<const int*>(rows);
  float* ls = static_cast<float*>(lse);
  if (dtype == 1) {
    if (which == 0)
      dsk::sparse_q_merge_kernel<__half, false><<<nmerge, 256, 0, st>>>(pt, m, mg, rw, out, ls, T,
                                                                        N, Nkv, hd, R);
    else
      dsk::sparse_q_merge_kernel<__half, true><<<nmerge, 256, 0, st>>>(pt, m, mg, rw, out, ls, T,
                                                                       N, Nkv, hd, R);
  } else {
    if (which == 0)
      dsk::sparse_q_merge_kernel<__nv_bfloat16, false><<<nmerge, 256, 0, st>>>(
          pt, m, mg, rw, out, ls, T, N, Nkv, hd, R);
    else
      dsk::sparse_q_merge_kernel<__nv_bfloat16, true><<<nmerge, 256, 0, st>>>(
          pt, m, mg, rw, out, ls, T, N, Nkv, hd, R);
  }
  return (int)cudaGetLastError();
}
