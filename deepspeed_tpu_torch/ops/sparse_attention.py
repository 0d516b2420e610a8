"""Block-sparse attention — counterpart of deepspeed_tpu/ops/sparse_attention.py.

The sparsity pattern is a static [nb, nb] block layout made on the host by
a ``SparsityConfig`` (the reference's ``sparsity_config.py`` family: Dense,
Fixed, BSLongformer, BigBird; BigBird's random blocks come from
``np.random.default_rng(seed)``, so the layouts are bit-equal to the JAX
package's).  Public layout is the model's [B, T, N, D] (k/v [B, T, Nkv, D],
GQA by ``kv head = q head // group``); the logsumexp comes back as fp32
[B, N, 1, T].

Implementations, chosen by the device of the tensors:

- plain PyTorch: ``torch_sparse_attention`` (the op's masked-dense body,
  counterpart of ``_sparse_xla``), and ``torch_sparse_fwd`` /
  ``torch_sparse_bwd``, the kernels' formulas without tiles (the flash
  plain versions over the expanded layout mask).  The CPU path and the
  kernels' reference.
- hand-written CUDA for Hopper, ``cuda_sparse_fwd`` / ``cuda_sparse_dq`` /
  ``cuda_sparse_dkv`` (csrc/sparse_attention.cu, built by ops/builder.py at
  first use, bound with ctypes): tensor-core kernels for 16-bit inputs at
  head_dim 64 / 128 with a block that is a multiple of 16, a CUDA-core
  family for every other call (fp32, block 8, other head dims).  A call
  at a block that divides 128 (``sparse_dkv_route``'s "wgmma" route) runs
  on TMA + wgmma: the forward and dq over ``sparse_q_plan``'s units of 128
  query rows (a GQA group's q heads stacked, key blocks gathered into
  stages of 128 keys, dq's of 64; dq makes delta = rowsum(o * do) for
  dk/dv), dk/dv over
  ``sparse_dkv_plan``'s groups of 128 gathered keys; heavy walks split into
  chunks merged in order (``cuda_sparse_fwd_combine``,
  ``cuda_sparse_dq_merge``, ``cuda_sparse_dkv_merge``).  Other blocks walk
  only their row's (or column's) live entries of the layout's index
  tables.  ``torch_sparse_q_task`` is the plain version of one forward /
  dq task of the plan, ``torch_sparse_fwd_combine`` /
  ``torch_sparse_dq_merge`` / ``torch_sparse_dkv_merge`` of the merges.
  Tables and plans are built on the host
  once per (layout, causal, ..., device) and kept on the device, so a
  call costs no upload and no host sync.  Each wrapper checks its inputs,
  allocates its outputs with ``torch.empty``, launches on the current
  stream, raises on a non-zero ``cudaError_t`` and counts its launches in
  ``<wrapper>.launches``.

``block_sparse_flash`` is the differentiable entry (a
``torch.autograd.Function`` saving q, k, v, o, lse); ``sparse_attention``
is the op: the kernels on CUDA tensors (an unsupported call raises), the
plain body on CPU tensors and for any call with ``dropout_fn`` (the kernels
have no probability dropout, as the reference's).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.evoformer import H100_SMS, _sms
from deepspeed_tpu_torch.ops.flash_attention import (SMEM_LIMIT,
                                                     _BWD_MAX_STAGES,
                                                     _bwd_checked,
                                                     _bwd_inputs, _check_rc,
                                                     _ptr, masked_bwd,
                                                     masked_fwd)
from deepspeed_tpu_torch.ops.flash_attention import _problem as _flash_problem
from deepspeed_tpu_torch.ops.flash_attention import \
    shape_problem as _flash_shape_problem


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Base pattern config (reference sparsity_config.py:15)."""

    block: int = 16
    different_layout_per_head: bool = False   # parity knob; one layout here

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DenseSparsityConfig(SparsityConfig):
    """All blocks active (reference DenseSparsityConfig) — debugging/parity."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = _nblocks(seq_len, self.block)
        return np.ones((nb, nb), bool)


@dataclasses.dataclass(frozen=True)
class FixedSparsityConfig(SparsityConfig):
    """Local windows + periodic global blocks
    (reference FixedSparsityConfig:67, the Sparse-Transformer 'fixed'
    pattern)."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = _nblocks(seq_len, self.block)
        lay = np.zeros((nb, nb), bool)
        nl, ng = self.num_local_blocks, self.num_global_blocks
        for i in range(nb):
            w0 = (i // nl) * nl
            lay[i, w0:i + 1] = True              # local window (causal)
        # last ng blocks of every preceding window attend globally
        for w0 in range(0, nb, nl):
            g0 = max(w0 + nl - ng, 0)
            for i in range(nb):
                if i >= w0 + nl:
                    lay[i, g0:w0 + nl] = True
        return lay


@dataclasses.dataclass(frozen=True)
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + designated global blocks
    (reference BSLongformerSparsityConfig:296)."""

    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = _nblocks(seq_len, self.block)
        lay = np.zeros((nb, nb), bool)
        w = self.num_sliding_window_blocks
        for i in range(nb):
            lay[i, max(0, i - w + 1):i + 1] = True
        for g in self.global_block_indices:
            if g < nb:
                lay[:, g] = True                  # everyone sees global
                lay[g, :] = True                  # global sees everyone
        return lay


@dataclasses.dataclass(frozen=True)
class BigBirdSparsityConfig(SparsityConfig):
    """Random + window + global blocks (reference BigBirdSparsityConfig:218).

    Random blocks are drawn with a fixed seed so the layout is deterministic
    per (seq_len, config)."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = _nblocks(seq_len, self.block)
        lay = np.zeros((nb, nb), bool)
        w = self.num_sliding_window_blocks
        rng = np.random.default_rng(self.seed)
        for i in range(nb):
            lay[i, max(0, i - w + 1):i + 1] = True
            lo = min(i + 1, nb)
            if lo > 0 and self.num_random_blocks:
                picks = rng.choice(lo, min(self.num_random_blocks, lo),
                                   replace=False)
                lay[i, picks] = True
        g = self.num_global_blocks
        lay[:, :g] = True
        lay[:g, :] = True
        return lay


def _nblocks(seq_len: int, block: int) -> int:
    if seq_len % block:
        raise ValueError(f"seq_len {seq_len} not divisible by block {block}")
    return seq_len // block


def expand_layout_mask(layout: np.ndarray, block: int,
                       causal: bool = True) -> np.ndarray:
    """[nb, nb] block layout → [T, T] boolean attention mask (∧ causal)."""
    mask = np.kron(layout, np.ones((block, block), bool))
    if causal:
        T = mask.shape[0]
        mask &= np.tril(np.ones((T, T), bool))
    return mask


def _layout_tables(layout: np.ndarray, causal: bool):
    """[nb, nb] layout → (row-major cols table, counts; col-major rows table,
    counts), each table row padded with its last valid index as the
    reference's (the kernels walk exactly ``count`` entries)."""
    lay = layout.astype(bool).copy()
    if causal:
        lay &= np.tril(np.ones(lay.shape, bool))
    nb = lay.shape[0]
    max_r = max(1, int(lay.sum(1).max()))
    max_c = max(1, int(lay.sum(0).max()))
    cols = np.zeros((nb, max_r), np.int32)
    nact_r = lay.sum(1).astype(np.int32)
    rows = np.zeros((nb, max_c), np.int32)
    nact_c = lay.sum(0).astype(np.int32)
    for i in range(nb):
        idx = np.flatnonzero(lay[i])
        if idx.size:
            cols[i, :idx.size] = idx
            cols[i, idx.size:] = idx[-1]
        jdx = np.flatnonzero(lay[:, i])
        if jdx.size:
            rows[i, :jdx.size] = jdx
            rows[i, jdx.size:] = jdx[-1]
    return cols, nact_r, rows, nact_c


def sparsity_ratio(config: SparsityConfig, seq_len: int,
                   causal: bool = True) -> float:
    """Fraction of ACTIVE attention entries — the compute/memory saving a
    block-skipping kernel realizes."""
    m = expand_layout_mask(config.make_layout(seq_len), config.block, causal)
    denom = np.tril(np.ones(m.shape, bool)).sum() if causal else m.size
    return float(m.sum() / denom)


# ----------------------------------------------------------- plain versions

@functools.lru_cache(maxsize=4)
def _mask(layout_key: bytes, nb: int, block: int, causal: bool,
          device: torch.device) -> torch.Tensor:
    layout = np.frombuffer(layout_key, bool).reshape(nb, nb)
    return torch.from_numpy(expand_layout_mask(layout, block, causal)).to(
        device)


def _visible(layout, block, causal, device) -> torch.Tensor:
    """The expanded [T, T] mask on ``device``, built once per (layout,
    block, causal, device)."""
    lay = np.ascontiguousarray(layout, bool)
    return _mask(lay.tobytes(), lay.shape[0], int(block), bool(causal),
                 torch.device(device))


def torch_sparse_fwd(q, k, v, layout, block: int, causal: bool = True,
                     scale: Optional[float] = None):
    """Plain forward → (o [B, T, N, D], lse fp32 [B, N, 1, T]): fp32 scores
    masked by the expanded layout (and causal) to -1e30, probabilities cast
    to v's dtype before ``p @ v``; a row that sees no key gives o = 0 and
    lse = -1e30, as the reference kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return masked_fwd(q, k, v, _visible(layout, block, causal, q.device),
                      scale)


def torch_sparse_bwd(q, k, v, o, lse, do, layout, block: int,
                     causal: bool = True, scale: Optional[float] = None):
    """Plain backward from the saved logsumexp → (dq, dk, dv): ``ds = p *
    (dp - delta) * scale`` cast before its two products, dk/dv summed over
    the GQA group."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return masked_bwd(q, k, v, o, lse, do,
                      _visible(layout, block, causal, q.device), scale)


def torch_sparse_attention(q, k, v, config: SparsityConfig, *,
                           causal: bool = True, dropout_fn=None):
    """The op's plain body (counterpart of ``_sparse_xla``): the layout
    expanded to a [T, T] mask through the plain attention body."""
    from deepspeed_tpu_torch.ops import _attention_torch
    mask = _visible(config.make_layout(q.shape[1]), config.block, causal,
                    q.device)
    return _attention_torch(q, k, v, causal=False,
                            mask=mask.expand(q.shape[0], *mask.shape),
                            dropout_fn=dropout_fn)


# ------------------------------------------------------------------ kernels

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def shape_problem(q, k, v, block: int) -> Optional[str]:
    """The kernels' rules on shapes, dtypes, strides and the block, without
    looking at the device (None: they take the call): the flash kernels'
    rules on q, k, v, then a block that is a multiple of 8 and divides
    T."""
    problem = _flash_shape_problem(q, k, v)
    if problem is not None:
        return problem
    if block % 8 or block < 8:
        return f"block {block}: the kernels take multiples of 8 " \
               f"(ROADMAP C.1)"
    if q.shape[1] % block:
        return f"seq_len {q.shape[1]} not divisible by block {block}"
    return None


def _problem(q, k, v, block: int) -> Optional[str]:
    """Why the kernels cannot take this call (None: they can)."""
    problem = shape_problem(q, k, v, block)
    if problem is not None:
        return problem
    return _flash_problem(q, k, v)


def block_sparse_supported(q, k, v, config: SparsityConfig, *,
                           causal: bool = True, dropout_fn=None, **_) -> bool:
    """What the kernels take: fp32/fp16/bf16 q [B, T, N, D] and k, v
    [B, T, Nkv, D] on one CUDA device, head_dim a multiple of 8 up to 256
    contiguous with 16-byte-aligned rows, any GQA group that divides N, a
    block that is a multiple of 8 and divides T; causal or not; no
    dropout.  16-bit calls at head_dim 64 / 128 with a block that is a
    multiple of 16 up to 128 run on the tensor cores, every other on CUDA
    cores."""
    return dropout_fn is None and _problem(q, k, v, config.block) is None


@functools.lru_cache(maxsize=64)
def _device_tables(layout_key: bytes, nb: int, causal: bool,
                   device: torch.device):
    """The layout's index tables on ``device``, built and uploaded once per
    (layout, causal, device): (cols, nact, rows, nact_c) int32."""
    layout = np.frombuffer(layout_key, bool).reshape(nb, nb)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in _layout_tables(layout, causal))


# ------------------------------------------- the tensor-core dk/dv's plan

DKV_KEYS = 128        # keys a tensor-core dk/dv unit (a group of columns)
DKV_QUERIES = 64      # queries a ring stage (of one q head)
_DKV_CHUNK = 0.5      # a split walk's chunks: about half a fair share
_DKV_ROUTES = ("simt", "mma", "wgmma")


def sparse_dkv_route(dtype, hd: int, block: int) -> str:
    """The kernels a CUDA call takes, forward, dq and dk/dv alike
    (csrc/sparse_attention.cu ``dkv_route``, the same rule): ``"wgmma"``
    for 16-bit inputs at head_dim 64 / 128 with a block that divides 128
    (16, 32, 64, 128: ``sparse_fwd_wgmma_kernel``,
    ``sparse_dq_wgmma_kernel``, ``sparse_dkv_wgmma_kernel``); ``"mma"`` for
    the other 16-bit blocks that are a multiple of 16 up to 128 (48, 80, 96,
    112: a 128-row unit holds no whole number of them, so they keep
    ``sparse_fwd_kernel``, ``sparse_dq_kernel``, ``sparse_dkv_kernel``);
    ``"simt"`` for everything else (fp32, blocks not a multiple of 16,
    other head dims: the CUDA-core family)."""
    if dtype == torch.float32 or hd not in (64, 128) or block % 16 \
            or block > 128:
        return "simt"
    return "wgmma" if DKV_KEYS % block == 0 else "mma"


def sparse_dkv_tiles(hd: int) -> dict:
    """Shared memory of ``sparse_dkv_wgmma_kernel`` (csrc/sparse_attention.cu
    ``SpDkvLayout``, the same formula) at head_dim ``hd`` (64 or 128):
    slots of the unit's gathered K and V ([128 keys, hd] each) and a ring
    of stages of the gathered Q and dO ([64 queries, hd] each) with four
    rows of 64 words (lse in log2 units, delta, each query's position and
    its segment's live-column bits), a stage rounded up to 1024 bytes.  Two
    slots where a ring of 3 still fits beside them, else one; then as many
    stages as fit, at most ``_BWD_MAX_STAGES``."""
    slot = 2 * DKV_KEYS * hd * 2
    stage = -(-(2 * DKV_QUERIES * hd * 2 + 4 * DKV_QUERIES * 4) // 1024) \
        * 1024
    fixed = (4 + 2 * _BWD_MAX_STAGES) * 8 + 1024  # mbarriers, alignment slack
    fits = {slots: min(_BWD_MAX_STAGES,
                       (SMEM_LIMIT - fixed - slots * slot) // stage)
            for slots in (2, 1)}
    slots = 2 if fits[2] >= 3 else 1
    return dict(slots=slots, stages=fits[slots], slot_bytes=slot,
                stage_bytes=stage,
                smem=fixed + slots * slot + fits[slots] * stage)


def _dkv_column_groups(lay: np.ndarray, block: int) -> np.ndarray:
    """The columns in groups of 128 / block ([groups, G], -1 pads the
    last): ordered by the last row block that reads them, then the first
    (dead columns last), so that columns whose row lists overlap sit
    together - Fixed's global columns, whose lists nest, in one run, each
    window's local columns in another."""
    nb = lay.shape[0]
    G = DKV_KEYS // block
    cnt = lay.sum(0)
    first = np.where(cnt > 0, lay.argmax(0), nb)
    last = np.where(cnt > 0, nb - 1 - lay[::-1].argmax(0), nb)
    order = np.lexsort((np.arange(nb), first, last, cnt == 0))
    pad = -len(order) % G
    return np.concatenate([order, -np.ones(pad, np.int64)]).reshape(
        -1, G).astype(np.int32)


def sparse_dkv_plan(layout: np.ndarray, causal: bool, block: int,
                    group: int, bh: int, hd: int = 128,
                    sms: int = H100_SMS) -> dict:
    """The work of one ``sparse_dkv_wgmma_kernel`` launch, a plain function
    of the layout: ``group`` q heads a kv head, ``bh`` = batch x kv heads,
    ``sms`` blocks at most.

    Units: the layout's columns (causal: its lower triangle) in ``groups``
    of G = 128 / block (``_dkv_column_groups``).  A group's walk is the
    union of its columns' row blocks, as segments of min(block, 64)
    queries (a 128-row block is two), packed R = 64 / min(block, 64) to a
    ``stage``: ``seg`` [stages, R] each segment's first query and ``live``
    [stages, R] the bits of the group's columns that its row block reads (a
    dead sub-tile gets p = ds = 0; a stage's padding repeats the last
    segment with no bits).  ``gst`` [groups, 2]: a group's first stage and
    stage count.  A unit (group, batch x kv head) walks ``group`` x count
    items (q head outer).

    Heavy walks split: the fair share is the items (+1 a unit for its slot
    and epilogue) over ``sms``; a walk longer than one fair share is cut
    into chunks of even length, about ``_DKV_CHUNK`` of a share each (so
    that the heaviest-first assignment below can even the blocks out), each
    a ``task`` that writes fp32 partial dk / dv into its own ``parts`` slot,
    and ``merges`` [group, bh, first part, chunks] add them in chunk order
    (``sparse_dkv_merge_kernel``).  ``tasks`` [n, 5]: group, bh, first
    item, end item, part slot (-1: the task is its unit's only chunk and
    writes dk / dv itself).  Tasks go heaviest first to the least-loaded of
    ``grid`` blocks; ``blk`` [grid + 1] bounds each block's run of
    ``tasks``."""
    lay = np.asarray(layout, bool).copy()
    if causal:
        lay &= np.tril(np.ones(lay.shape, bool))
    seg_len = min(block, DKV_QUERIES)
    R, halves = DKV_QUERIES // seg_len, max(1, block // DKV_QUERIES)
    cols = _dkv_column_groups(lay, block)
    G = cols.shape[1]
    gst, seg, live = [], [], []
    for row in cols:
        real = [(c, j) for c, j in enumerate(row) if j >= 0]
        sub = lay[:, [j for _, j in real]]
        bits = (sub.astype(np.int64) << np.array([c for c, _ in real],
                                                 np.int64)).sum(1)
        segs = [(int(r) * block + half * DKV_QUERIES, int(bits[r]))
                for r in np.flatnonzero(bits) for half in range(halves)]
        n = -(-len(segs) // R)
        segs += [(segs[-1][0], 0)] * (n * R - len(segs)) if segs else []
        gst.append((len(seg), n))
        for i in range(n):
            seg.append([s for s, _ in segs[i * R:(i + 1) * R]])
            live.append([b for _, b in segs[i * R:(i + 1) * R]])
    items = [group * n for _, n in gst]
    fair = bh * sum(n + 1 for n in items) / sms
    tasks, merges, parts = _split_walks(items, bh, fair)
    order, blk, grid, loads = _assign(tasks, sms)
    i32 = functools.partial(np.asarray, dtype=np.int32)
    return dict(sparse_dkv_tiles(hd), G=G, R=R, seg_len=seg_len,
                cols=cols, gst=i32(gst).reshape(-1, 2),
                seg=i32(seg).reshape(-1, R), live=i32(live).reshape(-1, R),
                tasks=i32(order).reshape(-1, 5), blk=i32(blk),
                merges=i32(merges).reshape(-1, 4), parts=parts, grid=grid,
                fair=fair, loads=loads)


def _assign(tasks, sms):
    """Tasks [(.., first, end, ..)] heaviest first to the least-loaded of
    ``grid`` = min(sms, tasks) blocks (a task costs its items + 1) → (the
    tasks in block order, blk [grid + 1] each block's run, grid, each
    block's load)."""
    grid = min(sms, len(tasks))
    heap = [(0, b) for b in range(grid)]
    runs = [[] for _ in range(grid)]
    for t in sorted(range(len(tasks)),
                    key=lambda t: (-(tasks[t][3] - tasks[t][2]), t)):
        load, b = heapq.heappop(heap)
        runs[b].append(t)
        heapq.heappush(heap, (load + tasks[t][3] - tasks[t][2] + 1, b))
    order = [tasks[t] for r in runs for t in r]
    blk = np.cumsum([0] + [len(r) for r in runs])
    loads = [sum(tasks[t][3] - tasks[t][2] + 1 for t in r) for r in runs]
    return order, blk, grid, loads


def _split_walks(items, bh, fair):
    """Each unit (pattern g of walk length ``items[g]``, u of ``bh``) as
    tasks: a walk longer than the ``fair`` share is cut into chunks of even
    length, about ``_DKV_CHUNK`` of a share each, each a task [g, u, first,
    end, part slot]; a unit's only chunk has part -1 → (tasks, merges [g,
    u, first part, chunks], parts)."""
    tasks, merges, parts = [], [], 0
    for g, n in enumerate(items):
        for u in range(bh):
            chunks = -(-n // max(1, int(_DKV_CHUNK * fair))) if n > fair else 1
            bounds = [round(i * n / chunks) for i in range(chunks + 1)]
            for c in range(chunks):
                tasks.append((g, u, bounds[c], bounds[c + 1],
                              parts + c if chunks > 1 else -1))
            if chunks > 1:
                merges.append((g, u, parts, chunks))
                parts += chunks
    return tasks, merges, parts


_PLAN_TABLES = ("cols", "gst", "seg", "live", "tasks", "blk", "merges")


def _device_plan(plan, tables, device):
    """A plan's tables in one int32 buffer on ``device`` → (plan, buffer,
    each table's offset in int32 words)."""
    flat = [np.asarray(plan[k], np.int32).reshape(-1) for k in tables]
    offs = np.cumsum([0] + [a.size for a in flat])
    buf = torch.from_numpy(np.concatenate(flat).astype(np.int32)).to(device)
    return plan, buf, dict(zip(tables, offs[:-1].tolist()))


@functools.lru_cache(maxsize=16)
def _device_dkv_plan(layout_key: bytes, nb: int, causal: bool, block: int,
                     group: int, bh: int, hd: int, device: torch.device):
    """``sparse_dkv_plan`` for the card, built once per (layout, causal,
    block, group, batch x kv heads, head_dim, device): the plan and its
    tables in one int32 buffer on ``device`` with each table's offset."""
    layout = np.frombuffer(layout_key, bool).reshape(nb, nb)
    plan = sparse_dkv_plan(layout, causal, block, group, bh, hd,
                           _sms(device.index or 0))
    return _device_plan(plan, _PLAN_TABLES, device)


# ------------------------------------ the tensor-core forward / dq's plan

Q_ROWS = 128          # query rows a forward / dq unit
FWD_KEYS = 128        # keys a forward stage
Q_KEYS = 64           # keys a dq stage
_Q_WORDS = 32         # int32 words a stage carries beside K and V
_FWD_BAR_BYTES = (4 + 4 * _BWD_MAX_STAGES) * 8   # C side kFwdBarBytes
_DQ_BAR_BYTES = (4 + 2 * _BWD_MAX_STAGES) * 8    # C side kBwdBarBytes


def sparse_q_tiles(hd: int, dq: bool) -> dict:
    """Shared memory of ``sparse_fwd_wgmma_kernel`` (``dq`` False) or
    ``sparse_dq_wgmma_kernel`` (csrc/sparse_attention.cu ``SpQLayout``, the
    same formula) at head_dim ``hd`` (64 or 128): the mbarriers, slack to
    align the rest to 1024 bytes, slots of the unit's gathered Q (dq: and
    dO) [128 rows, hd], a ring of stages of the gathered K and V [128 keys
    (dq: 64), hd] each, each stage's 32 words (its segments' live bits, its
    key blocks' first keys) and (dq) each slot's 128 delta values.  Two slots
    where a ring of 3 still fits beside them, else one; then as many stages
    as fit, at most ``_BWD_MAX_STAGES``."""
    tile = Q_ROWS * hd * 2
    slot = (2 * tile + Q_ROWS * 4) if dq else tile
    stage = 2 * (Q_KEYS if dq else FWD_KEYS) * hd * 2 + _Q_WORDS * 4
    fixed = (_DQ_BAR_BYTES if dq else _FWD_BAR_BYTES) + 1024
    fits = {slots: min(_BWD_MAX_STAGES,
                       (SMEM_LIMIT - fixed - slots * slot) // stage)
            for slots in (2, 1)}
    slots = 2 if fits[2] >= 3 else 1
    return dict(slots=slots, stages=fits[slots], slot_bytes=slot,
                stage_bytes=stage,
                smem=fixed + slots * slot + fits[slots] * stage)


def sparse_q_seg(block: int, group: int) -> int:
    """Queries a segment of a forward / dq unit (one q head, one TMA box):
    the largest power of two with ``group`` of them within 128 rows, at
    least 8 (one 1024-byte swizzle atom of 128-byte rows), at most 64 and
    at most the block."""
    fit = 1 << max(3, (Q_ROWS // group).bit_length() - 1)
    return min(block, 64, fit)


def sparse_q_plan(layout: np.ndarray, causal: bool, block: int, group: int,
                  bh: int, hd: int = 128, sms: int = H100_SMS,
                  dq: bool = False) -> dict:
    """The work of one ``sparse_fwd_wgmma_kernel`` launch, or with ``dq``
    of one ``sparse_dq_wgmma_kernel`` launch, a plain function of the
    layout (shared by both; they differ in a stage's keys, 128 and 64, and
    in their tiles, ``sparse_q_tiles``): ``group`` q heads a kv head, ``bh``
    = batch x kv heads, ``sms`` blocks at most.

    Units: 128 query rows of one (batch, kv head) in R = 128 / ``seg``
    segments of ``seg`` (``sparse_q_seg``) queries of one q head, the GQA
    group's heads stacked first, then a row block's halves, then adjacent
    row blocks (Fixed at block 16, group 4: 4 heads x 2 row blocks x 16;
    block 64: 4 heads x 32 queries, a row block two units; group 1: 128 /
    block row blocks of one head).  ``rows`` [patterns, R, 2]: each
    segment's head within the group (-1: a pad segment past the last row
    block, never written) and first query.  The q heads of a group read
    the same column list, so a stacked unit has no dead sub-tile but the
    row blocks' own differences.

    A unit's walk is the union of its segments' key blocks of kb = min(
    block, 64) keys (a 128-key column is two; causal: only blocks with a
    key at or before one of the segment's queries), in order, gathered
    into ``stages`` of C = 128 / kb blocks (dq: 64 / kb): ``kst`` [stages,
    C] each block's
    first key (a stage's padding repeats its first block) and ``live``
    [stages, R] each segment's bits over the stage's blocks (bit c: it
    reads block c; bit 8 + c: a key of block c lies after one of its
    queries, so the position test applies).  A dead or pad sub-tile gets p
    = ds = 0.  ``ust`` [patterns, 2]: a pattern's first stage and stage
    count.  A unit (pattern, batch x kv head) walks its stages once.

    Heavy walks split as ``sparse_dkv_plan``'s: ``tasks`` [n, 5]
    (pattern, bh, first stage, end stage, part slot or -1), ``merges``
    [pattern, bh, first part, chunks] (the forward's chunks are combined by
    ``sparse_fwd_combine_kernel``, dq's added by ``sparse_dq_merge_kernel``,
    in chunk order), ``blk`` [grid + 1] each block's run, heaviest first."""
    lay = np.asarray(layout, bool).copy()
    if causal:
        lay &= np.tril(np.ones(lay.shape, bool))
    nb = lay.shape[0]
    seg = sparse_q_seg(block, group)
    R, kb = Q_ROWS // seg, min(block, Q_KEYS)
    C = (Q_KEYS if dq else FWD_KEYS) // kb
    # the segments in order: row block, its halves, the group's heads
    rb = np.repeat(np.arange(nb), (block // seg) * group)
    q0 = rb * block + np.tile(np.repeat(np.arange(block // seg) * seg,
                                        group), nb)
    head = np.tile(np.arange(group), nb * (block // seg))
    pad = -len(rb) % R
    rb = np.concatenate([rb, -np.ones(pad, np.int64)])
    q0 = np.concatenate([q0, np.full(pad, q0[0])])
    head = np.concatenate([head, -np.ones(pad, np.int64)])
    k0 = np.arange(nb * (block // kb)) * kb         # every key block
    sees = np.repeat(lay, block // kb, axis=1)      # [row block, key block]
    ust, kst, live = [], [], []
    for u in range(len(rb) // R):
        us = slice(u * R, (u + 1) * R)
        on = np.where(rb[us, None] >= 0, sees[rb[us]], False)  # [R, blocks]
        after = k0[None, :] + kb - 1 > q0[us, None]
        if causal:
            on &= k0[None, :] <= q0[us, None] + seg - 1
        walk = np.flatnonzero(on.any(0))
        n = -(-walk.size // C)
        ust.append((len(kst), n))
        if not n:
            continue
        idx = np.concatenate([walk, np.repeat(walk[(n - 1) * C],
                                              n * C - walk.size)])
        real = np.arange(n * C) < walk.size
        bits = (on[:, idx] & real).astype(np.int64)
        diag = (bits & after[:, idx]) if causal else 0 * bits
        shift = np.tile(np.arange(C), n)
        word = (bits << shift) | (diag << (8 + shift))   # [R, n * C]
        live += list(word.reshape(R, n, C).sum(-1).T)
        kst += list(k0[idx].reshape(n, C))
    rows = np.stack([head, q0], -1).reshape(-1, R, 2)
    fair = bh * sum(n + 1 for _, n in ust) / sms
    tasks, merges, parts = _split_walks([n for _, n in ust], bh, fair)
    order, blk, grid, loads = _assign(tasks, sms)
    i32 = functools.partial(np.asarray, dtype=np.int32)
    return dict(sparse_q_tiles(hd, dq),
                seg=seg, R=R, C=C, kb=kb, rows=i32(rows),
                ust=i32(ust).reshape(-1, 2), kst=i32(kst).reshape(-1, C),
                live=i32(live).reshape(-1, R),
                tasks=i32(order).reshape(-1, 5), blk=i32(blk),
                merges=i32(merges).reshape(-1, 4), parts=parts, grid=grid,
                fair=fair, loads=loads)


_Q_TABLES = ("rows", "ust", "kst", "live", "tasks", "blk", "merges")


@functools.lru_cache(maxsize=16)
def _device_q_plan(layout_key: bytes, nb: int, causal: bool, block: int,
                   group: int, bh: int, hd: int, device: torch.device,
                   dq: bool):
    """``sparse_q_plan`` for the card, built once per (layout, causal,
    block, group, batch x kv heads, head_dim, device, kernel), as
    ``_device_dkv_plan``."""
    layout = np.frombuffer(layout_key, bool).reshape(nb, nb)
    plan = sparse_q_plan(layout, causal, block, group, bh, hd,
                         _sms(device.index or 0), dq)
    return _device_plan(plan, _Q_TABLES, device)


def _call_q_plan(layout, block, causal, q, nkv, dq=False):
    """The forward (``dq``: dq) plan of a call on q [B, T, N, hd] over
    ``nkv`` kv heads: on a CUDA device the cached one with its device
    tables (plan, buffer, offsets), elsewhere the plan for an H100 (plan,
    None, None)."""
    lay = np.ascontiguousarray(layout, bool)
    b, _, n, hd = q.shape
    group, bh = n // nkv, b * nkv
    if q.device.type != "cuda":
        return sparse_q_plan(lay, causal, block, group, bh, hd,
                             dq=dq), None, None
    return _device_q_plan(lay.tobytes(), lay.shape[0], bool(causal),
                          int(block), group, bh, hd, q.device, bool(dq))


def _unit_rows(plan, pattern: int, u: int, nkv: int):
    """A unit's 128 rows → (batch, kv head, each row's q head within the
    group [128] (-1 on a pad segment's rows), position [128], real [128])
    as ints and int64 / bool numpy arrays."""
    b, hk = divmod(u, nkv)
    seg = plan["seg"]
    rows = plan["rows"][pattern].astype(np.int64)      # [R, 2]
    head = np.repeat(rows[:, 0], seg)
    pos = np.repeat(rows[:, 1], seg) + np.tile(np.arange(seg), plan["R"])
    return b, hk, head, pos, head >= 0


def _task_visible(plan, pattern, s0, s1, pos):
    """The keys of a task's stages (s0..s1 of its pattern's walk) and which
    of its 128 rows sees which → (keys [n * C * kb] int64, ok [128, keys]
    bool): a segment's live bits, and the position test where its bit 8 + c
    says so (a padded stage block is dead)."""
    kb, C, seg = plan["kb"], plan["C"], plan["seg"]
    first = int(plan["ust"][pattern, 0])
    st = slice(first + s0, first + s1)
    kst = plan["kst"][st].astype(np.int64)              # [n, C]
    keys = (kst[:, :, None] + np.arange(kb)).reshape(-1)
    word = np.repeat(plan["live"][st].astype(np.int64).T, seg, axis=0)
    word = word[:, np.repeat(np.arange(s1 - s0), C * kb)]  # [128, keys]
    c = np.repeat(np.tile(np.arange(C), s1 - s0), kb)   # each key's block
    on, test = (word >> c) & 1, (word >> (8 + c)) & 1
    ok = (on == 1) & ((test == 0) | (keys[None, :] <= pos[:, None]))
    return keys, ok


def torch_sparse_q_task(kind: str, q, k, v, plan, task, scale=None, o=None,
                        lse=None, do=None, delta=None):
    """The plain version of one task of the tensor-core forward / dq
    (``plan``'s ``tasks`` row ``task``: pattern, batch x kv head, first and
    end stage; ``plan`` the kernel's own ``sparse_q_plan``) on its unit's
    128 rows: ``kind`` "fwd" → (o fp32
    [128, hd] unnormalised, ml fp32 [2, 128]: each row's running maximum in
    log2 units (-inf: no key seen) and sum, what a split task writes);
    "dq" → dq fp32 [128, hd] (ds rounded to k's dtype before ds k; delta
    [B, N, T] fp32 as given, else rowsum(o * do)).  A pad row gives zeros."""
    pattern, u, s0, s1 = (int(x) for x in task[:4])
    nkv, group = k.shape[2], q.shape[2] // k.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, hk, head, pos, real = _unit_rows(plan, pattern, u, nkv)
    keys, ok = _task_visible(plan, pattern, s0, s1, pos)
    dev = q.device
    heads = torch.from_numpy(hk * group + np.maximum(head, 0)).to(dev)
    rows = torch.from_numpy(pos).to(dev)
    kt = torch.from_numpy(keys).to(dev)
    ok = torch.from_numpy(ok & real[:, None]).to(dev)
    qr = q[b, rows, heads].float()                      # [128, hd]
    kr, vr = k[b, kt, hk].float(), v[b, kt, hk].float()  # [keys, hd]
    s2 = (qr @ kr.T) * (scale * 1.4426950408889634)
    if kind == "fwd":
        s2 = torch.where(ok, s2, float("-inf"))
        m = s2.amax(-1)
        mu = torch.where(m == float("-inf"), 0.0, m)
        p = torch.where(ok, torch.exp2(s2 - mu[:, None]), 0.0)
        acc = p.to(v.dtype).float() @ vr
        return acc, torch.stack([m, p.sum(-1)])
    lse_r = lse.reshape(q.shape[0], q.shape[2], -1)[b, heads, rows]
    if delta is None:
        d = (o[b, rows, heads].float() * do[b, rows, heads].float()).sum(-1)
    else:
        d = delta.reshape(q.shape[0], q.shape[2], -1)[b, heads, rows]
    p = torch.where(ok & (lse_r[:, None] > -0.5e30),
                    torch.exp2(s2 - lse_r[:, None] * 1.4426950408889634), 0.0)
    dp = do[b, rows, heads].float() @ vr.T
    ds = p * (dp - d[:, None]) * scale
    return ds.to(k.dtype).float() @ kr


def torch_sparse_q_parts(kind: str, q, k, v, layout, block: int,
                         causal: bool = True, scale: Optional[float] = None,
                         o=None, lse=None, do=None):
    """The split tasks of the call's forward / dq plan (``_call_q_plan``:
    the card's on CUDA tensors, an H100's elsewhere) as the plain version
    computes them (``torch_sparse_q_task``), each in its part slot: "fwd"
    → (part [parts, 128, hd], ml [parts, 2, 128]); "dq" → part [parts,
    128, hd]; fp32."""
    plan = _call_q_plan(layout, block, causal, q, k.shape[2],
                        dq=kind == "dq")[0]
    part = torch.zeros((plan["parts"], Q_ROWS, q.shape[3]),
                       dtype=torch.float32, device=q.device)
    ml = torch.zeros((plan["parts"], 2, Q_ROWS), dtype=torch.float32,
                     device=q.device)
    for t in plan["tasks"].tolist():
        if t[4] < 0:
            continue
        got = torch_sparse_q_task(kind, q, k, v, plan, t, scale, o=o,
                                  lse=lse, do=do)
        if kind == "fwd":
            part[t[4]], ml[t[4]] = got
        else:
            part[t[4]] = got
    return (part, ml) if kind == "fwd" else part


def _lib():
    """Build-and-load the kernel library once and declare its C interface."""
    from deepspeed_tpu_torch.ops.builder import load_op
    lib = load_op("sparse_attention")
    if not getattr(lib, "_ds_declared", False):
        P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
        tail = [I] * 6 + [L] * 9 + [F, I, I, P]
        lib.ds_sparse_fwd.argtypes = [P] * 5 + [I] + [P] * 2 + tail
        lib.ds_sparse_fwd.restype = I
        lib.ds_sparse_bwd.argtypes = [I] + [P] * 8 + [I] + [P] * 3 + tail
        lib.ds_sparse_bwd.restype = I
        lib.ds_sparse_dkv_wgmma.argtypes = [P] * 12 + [I] * 5 + [P] * 3 + tail
        lib.ds_sparse_dkv_wgmma.restype = I
        lib.ds_sparse_dkv_merge.argtypes = [P] * 3 + [I] + [P] * 2 + [I] * 5 \
            + [P]
        lib.ds_sparse_dkv_merge.restype = I
        lib.ds_sparse_q_wgmma.argtypes = [I] + [P] * 17 + [I] * 5 + tail
        lib.ds_sparse_q_wgmma.restype = I
        lib.ds_sparse_q_merge.argtypes = [I] + [P] * 4 + [I] + [P] * 2 \
            + [I] * 6 + [P]
        lib.ds_sparse_q_merge.restype = I
        lib.ds_sparse_dkv_route.argtypes = [I] * 3
        lib.ds_sparse_dkv_route.restype = I
        lib.ds_cuda_error_string.argtypes = [I]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib._ds_declared = True
    return lib


def _prepare(name, q, k, v, layout, block, causal, scale, col_major=False):
    """Check the call; return (table, counts, tail of the C call)."""
    problem = _problem(q, k, v, block)
    if problem is None and layout.shape != (q.shape[1] // block,) * 2:
        problem = f"layout {layout.shape} does not tile T {q.shape[1]} " \
                  f"with block {block}"
    if problem is not None:
        raise ValueError(f"{name}: {problem}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lay = np.ascontiguousarray(layout, bool)
    cols, nact, rows, nact_c = _device_tables(lay.tobytes(), lay.shape[0],
                                              bool(causal), q.device)
    tab, cnt = (rows, nact_c) if col_major else (cols, nact)
    b, t, n, d = q.shape
    tail = ([b, t, n, k.shape[2], d, block]
            + [x.stride(i) for x in (q, k, v) for i in (0, 1, 2)]
            + [float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
               ctypes.c_void_p(torch.cuda.current_stream(q.device)
                               .cuda_stream)])
    return tab, cnt, tail


def _launch_q_wgmma(which, q, k, v, layout, block, causal, tail, *, o=None,
                    lse=None, do=None, delta=None, delta_out=None, dq=None):
    """sparse_fwd_wgmma_kernel (``which`` 0: o, lse written) or
    sparse_dq_wgmma_kernel (1: dq written; o read for delta unless
    ``delta`` is given, ``delta_out`` the delta it makes) on the call's
    plan, then, if a walk was split, the merge of its chunks (its own
    counter)."""
    group = q.shape[2] // k.shape[2]
    plan, buf, offs = _call_q_plan(layout, block, causal, q, k.shape[2],
                                   dq=which == 1)
    tab = {x: ctypes.c_void_p(buf.data_ptr() + 4 * o_)
           for x, o_ in offs.items()}
    part = ml = None
    if plan["parts"]:
        part = torch.empty((plan["parts"], Q_ROWS, q.shape[3]),
                           dtype=torch.float32, device=q.device)
        if which == 0:
            ml = torch.empty((plan["parts"], 2, Q_ROWS), dtype=torch.float32,
                             device=q.device)
    lib = _lib()
    rc = lib.ds_sparse_q_wgmma(
        which, _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(delta_out), _ptr(dq), _ptr(part), _ptr(ml),
        *(tab[x] for x in _Q_TABLES[:6]), plan["grid"], plan["R"],
        plan["C"], plan["stages"], plan["slots"], *tail)
    _check_rc(lib, rc, "sparse_fwd" if which == 0 else "sparse_dq")
    if part is not None and which == 0:
        cuda_sparse_fwd_combine(part, ml, o, lse, layout, block, causal,
                                group)
    elif part is not None:
        cuda_sparse_dq_merge(part, dq, layout, block, causal, group)


def cuda_sparse_fwd(q, k, v, layout, block: int, causal: bool = True,
                    scale: Optional[float] = None):
    """Forward on the card → (o [B, T, N, D], lse fp32 [B, N, 1, T]).  On
    ``sparse_dkv_route``'s "wgmma" route ``sparse_fwd_wgmma_kernel`` walks
    ``sparse_q_plan``'s units, and ``cuda_sparse_fwd_combine`` merges the
    chunks of a split walk; the other routes walk the row table."""
    tab, cnt, tail = _prepare("cuda_sparse_fwd", q, k, v, layout, block,
                              causal, scale)
    b, t, n, d = q.shape
    o = torch.empty((b, t, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    if sparse_dkv_route(q.dtype, d, block) == "wgmma":
        _launch_q_wgmma(0, q, k, v, layout, block, causal, tail, o=o,
                        lse=lse)
    else:
        lib = _lib()
        rc = lib.ds_sparse_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(tab),
                               _ptr(cnt), tab.shape[1], _ptr(o), _ptr(lse),
                               *tail)
        _check_rc(lib, rc, "sparse_fwd")
    cuda_sparse_fwd.launches += 1
    return o, lse.view(b, n, 1, t)


cuda_sparse_fwd.launches = 0


def _bwd_args(name, q, o, lse, do, delta):
    """do and lse checked (contiguous) and delta: the caller's, else the
    eager rowsum(o * do)."""
    if delta is None:
        return _bwd_inputs(name, q, o, lse, do)
    return (*_bwd_checked(name, q, lse, do), delta)


def _launch_bwd(which, name, q, k, v, o, lse, do, layout, block, causal,
                scale, delta, dq, dk, dv):
    tab, cnt, tail = _prepare(name, q, k, v, layout, block, causal, scale,
                              col_major=which == 2)
    do, lse, delta = _bwd_args(name, q, o, lse, do, delta)
    lib = _lib()
    rc = lib.ds_sparse_bwd(which, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
                           _ptr(lse), _ptr(delta), _ptr(tab), _ptr(cnt),
                           tab.shape[1], _ptr(dq), _ptr(dk), _ptr(dv), *tail)
    _check_rc(lib, rc, name)
    return delta


def cuda_sparse_dq(q, k, v, o, lse, do, layout, block: int,
                   causal: bool = True, scale: Optional[float] = None,
                   delta=None, delta_out=None):
    """dq on the card.  ``delta`` [B, N, T] fp32 = rowsum(o * do) is taken
    as given; without it, on the "wgmma" route ``sparse_dq_wgmma_kernel``
    makes it in its units from o and do (the other routes: eagerly), and
    writes it to ``delta_out`` [B, N, T] fp32 if given (the autograd
    Function hands it on to dk/dv).  A split walk's chunks are added by
    ``cuda_sparse_dq_merge``."""
    if delta_out is not None and (
            delta_out.dtype != torch.float32 or not delta_out.is_contiguous()
            or delta_out.numel() != q.shape[0] * q.shape[1] * q.shape[2]
            or delta_out.device != q.device):
        raise ValueError("cuda_sparse_dq: delta_out must be contiguous fp32 "
                         "[B, N, T] on q's device")
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError("cuda_sparse_dq: o must match q in shape, dtype, "
                         "device")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if sparse_dkv_route(q.dtype, q.shape[-1], block) == "wgmma":
        _, _, tail = _prepare("cuda_sparse_dq", q, k, v, layout, block,
                              causal, scale)
        do, lse = _bwd_checked("cuda_sparse_dq", q, lse, do)
        _launch_q_wgmma(1, q, k, v, layout, block, causal, tail,
                        o=o.contiguous() if delta is None else None, lse=lse,
                        do=do, delta=delta,
                        delta_out=delta_out if delta is None else None, dq=dq)
        if delta is not None and delta_out is not None:
            delta_out.copy_(delta.view_as(delta_out))
    else:
        made = _launch_bwd(1, "sparse_dq", q, k, v, o, lse, do, layout, block,
                           causal, scale, delta, dq, None, None)
        if delta_out is not None:
            delta_out.copy_(made.view_as(delta_out))
    cuda_sparse_dq.launches += 1
    return dq


cuda_sparse_dq.launches = 0


def _q_merge_check(part, out, plan, ml=None, lse=None, kernel=False):
    """Why ``part`` (and ``ml``) cannot be merged into ``out`` (and
    ``lse``) for ``plan`` (None: they can): the kernels write 16-bit
    outputs, the plain versions fp32 too."""
    dtypes = (torch.float16, torch.bfloat16) + (() if kernel else
                                                (torch.float32,))
    if out.dtype not in dtypes or out.dim() != 4 or not out.is_contiguous():
        return f"the output must be contiguous {'16-bit' if kernel else ''}" \
               f" [B, T, N, hd], got {out.dtype} {tuple(out.shape)}"
    want = (plan["parts"], Q_ROWS, out.shape[3])
    if part.dtype != torch.float32 or tuple(part.shape) != want \
            or not part.is_contiguous():
        return f"part must be a contiguous float32 {list(want)} tensor, " \
               f"got {part.dtype} {tuple(part.shape)}"
    if ml is not None and (ml.dtype != torch.float32 or not ml.is_contiguous()
                           or tuple(ml.shape) != (want[0], 2, Q_ROWS)):
        return f"ml must be a contiguous float32 [{want[0]}, 2, 128] tensor"
    if lse is not None and (lse.dtype != torch.float32
                            or not lse.is_contiguous()
                            or lse.numel() != out.shape[0] * out.shape[1]
                            * out.shape[2]):
        return "lse must be contiguous fp32 [B, N, 1, T]"
    if not plan["parts"]:
        return "the call's plan splits no walk"
    return None


def _q_merge(which, name, part, ml, out, lse, layout, block, causal, group):
    b, t, n, d = out.shape
    nkv = n // group
    plan, buf, offs = _call_q_plan(layout, block, causal, out, nkv,
                                   dq=which == 1)
    problem = None if buf is not None else "the output must be on a CUDA " \
                                           "device"
    problem = problem or _q_merge_check(part, out, plan, ml, lse, True)
    if problem is None and any(x is not None and x.device != out.device
                               for x in (part, ml, lse)):
        problem = f"every tensor must be on {out.device}"
    if problem is not None:
        raise ValueError(f"{name}: {problem}")
    lib = _lib()
    rc = lib.ds_sparse_q_merge(
        which, _ptr(part), _ptr(ml),
        ctypes.c_void_p(buf.data_ptr() + 4 * offs["merges"]),
        ctypes.c_void_p(buf.data_ptr() + 4 * offs["rows"]),
        len(plan["merges"]), _ptr(out), _ptr(lse), t, n, nkv, d, plan["R"],
        _DTYPE_CODE[out.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream))
    _check_rc(lib, rc, name)


def cuda_sparse_fwd_combine(part, ml, o, lse, layout, block: int,
                            causal: bool = True, group: int = 1):
    """The forward's split walks merged on the card
    (``sparse_fwd_combine_kernel``): for each merge of the call's
    ``sparse_q_plan`` (``group`` q heads a kv head), each row of the unit =
    its chunks of ``part`` [parts, 128, hd] (unnormalised o) weighted by
    2^(m - max m) from ``ml`` [parts, 2, 128] (m in log2 units, the sum l),
    over the weighted sum of l, in chunk order; its lse = max m ln 2 +
    log(sum); written into ``o`` [B, T, N, hd] and ``lse`` [B, N, 1, T]
    in place (a row no chunk saw a key of: 0 and -1e30)."""
    _q_merge(0, "cuda_sparse_fwd_combine", part, ml, o, lse, layout, block,
             causal, group)
    cuda_sparse_fwd_combine.launches += 1
    return o, lse


cuda_sparse_fwd_combine.launches = 0


def cuda_sparse_dq_merge(part, dq, layout, block: int, causal: bool = True,
                         group: int = 1):
    """dq's split walks merged on the card (``sparse_dq_merge_kernel``):
    each merged unit's dq rows = its chunks of ``part`` [parts, 128, hd]
    fp32 added in chunk order, rounded once, written into ``dq`` in
    place."""
    _q_merge(1, "cuda_sparse_dq_merge", part, None, dq, None, layout, block,
             causal, group)
    cuda_sparse_dq_merge.launches += 1
    return dq


cuda_sparse_dq_merge.launches = 0


def _merged_rows(plan, nkv, group):
    """Each merge with the rows it writes → [(first part, chunks, batch,
    q heads [rows], positions [rows], unit rows [rows])] (pad rows out)."""
    out = []
    for g, u, p0, n in plan["merges"].tolist():
        b, hk, head, pos, real = _unit_rows(plan, g, u, nkv)
        r = np.flatnonzero(real)
        out.append((p0, n, b, hk * group + head[r], pos[r], r))
    return out


def torch_sparse_fwd_combine(part, ml, o, lse, layout, block: int,
                             causal: bool = True, group: int = 1):
    """The forward combine's formula → (o, lse) copies with each merged
    unit's rows = its chunks weighted in chunk order (fp32), rounded once
    (as ``cuda_sparse_fwd_combine``)."""
    nkv = o.shape[2] // group
    plan = _call_q_plan(layout, block, causal, o, nkv)[0]
    problem = _q_merge_check(part, o, plan, ml, lse)
    if problem is not None:
        raise ValueError(f"torch_sparse_fwd_combine: {problem}")
    o, lse = o.clone(), lse.clone()
    lse3 = lse.view(o.shape[0], o.shape[2], o.shape[1])
    for p0, n, b, heads, pos, r in _merged_rows(plan, nkv, group):
        m = ml[p0:p0 + n, 0]
        top = m.amax(0)
        acc, tot = torch.zeros_like(part[0]), torch.zeros_like(top)
        for c in range(n):
            w = torch.where(m[c] == float("-inf"), 0.0,
                            torch.exp2(m[c] - top))
            tot = tot + ml[p0 + c, 1] * w
            acc = acc + part[p0 + c] * w[:, None]
        out = acc / torch.where(tot == 0, 1.0, tot)[:, None]
        ls = torch.where(tot == 0, -1e30,
                         top * 0.6931471805599453 + torch.log(
                             torch.where(tot == 0, 1.0, tot)))
        rt, ht, pt = (torch.from_numpy(x).to(o.device) for x in (r, heads,
                                                                 pos))
        o[b, pt, ht] = out[rt].to(o.dtype)
        lse3[b, ht, pt] = ls[rt]
    return o, lse


def torch_sparse_dq_merge(part, dq, layout, block: int, causal: bool = True,
                          group: int = 1):
    """dq's merge formula → a dq copy with each merged unit's rows = its
    chunks of ``part`` added in chunk order (fp32), rounded once."""
    nkv = dq.shape[2] // group
    plan = _call_q_plan(layout, block, causal, dq, nkv, dq=True)[0]
    problem = _q_merge_check(part, dq, plan)
    if problem is not None:
        raise ValueError(f"torch_sparse_dq_merge: {problem}")
    dq = dq.clone()
    for p0, n, b, heads, pos, r in _merged_rows(plan, nkv, group):
        acc = part[p0]
        for c in range(1, n):
            acc = acc + part[p0 + c]
        rt, ht, pt = (torch.from_numpy(x).to(dq.device) for x in (r, heads,
                                                                  pos))
        dq[b, pt, ht] = acc[rt].to(dq.dtype)
    return dq


def _call_plan(layout, block, causal, group, dk):
    """The plan of a dk/dv call whose dk is ``dk`` [B, T, Nkv, hd]: on a
    CUDA device the cached one with its device tables (plan, buffer,
    offsets), elsewhere the plan for an H100 (plan, None, None)."""
    lay = np.ascontiguousarray(layout, bool)
    bh, hd = dk.shape[0] * dk.shape[2], dk.shape[3]
    if dk.device.type != "cuda":
        return sparse_dkv_plan(lay, causal, block, group, bh, hd), None, None
    return _device_dkv_plan(lay.tobytes(), lay.shape[0], bool(causal),
                            int(block), group, bh, hd, dk.device)


def _launch_dkv_wgmma(q, k, v, o, lse, do, layout, block, causal, scale,
                      delta, dk, dv):
    """sparse_dkv_wgmma_kernel on the call's plan, then (if a walk was
    split) the merge of its chunks."""
    _, _, tail = _prepare("sparse_dkv", q, k, v, layout, block, causal,
                          scale, col_major=True)
    do, lse, delta = _bwd_args("sparse_dkv", q, o, lse, do, delta)
    group = q.shape[2] // k.shape[2]
    plan, buf, offs = _call_plan(layout, block, causal, group, dk)
    tab = {x: ctypes.c_void_p(buf.data_ptr() + 4 * o_)
           for x, o_ in offs.items()}
    part = (torch.empty((plan["parts"], 2, DKV_KEYS, q.shape[3]),
                        dtype=torch.float32, device=q.device)
            if plan["parts"] else None)
    lib = _lib()
    rc = lib.ds_sparse_dkv_wgmma(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
        *(tab[x] for x in _PLAN_TABLES[:6]), plan["grid"], plan["G"],
        plan["R"], plan["stages"], plan["slots"], _ptr(part), _ptr(dk),
        _ptr(dv), *tail)
    _check_rc(lib, rc, "sparse_dkv")
    if part is not None:
        cuda_sparse_dkv_merge(part, dk, dv, layout, block, causal, group)


def _merge_problem(part, dk, dv, plan) -> Optional[str]:
    if dk.dtype not in (torch.float16, torch.bfloat16) \
            or dv.dtype != dk.dtype or dv.shape != dk.shape or dk.dim() != 4 \
            or not dk.is_contiguous() or not dv.is_contiguous():
        return f"dk, dv must be contiguous 16-bit [B, T, Nkv, hd] of one " \
               f"shape, got {dk.dtype} {tuple(dk.shape)} / {dv.dtype} " \
               f"{tuple(dv.shape)}"
    want = (plan["parts"], 2, DKV_KEYS, dk.shape[3])
    if part.dtype != torch.float32 or tuple(part.shape) != want \
            or not part.is_contiguous():
        return f"part must be a contiguous float32 {list(want)} tensor, " \
               f"got {part.dtype} {tuple(part.shape)}"
    return None


def cuda_sparse_dkv_merge(part, dk, dv, layout, block: int,
                          causal: bool = True, group: int = 1):
    """The split walks' second pass on the card
    (``sparse_dkv_merge_kernel``): for each of the call's merges (its
    ``sparse_dkv_plan`` for ``group`` q heads a kv head), the dk and dv rows
    of the group's keys = the chunks of ``part`` [parts, 2, 128, hd] fp32
    added in chunk order, rounded once, written into ``dk`` / ``dv`` [B, T,
    Nkv, hd] in place (the other rows are left as they are)."""
    plan, buf, offs = _call_plan(layout, block, causal, group, dk)
    problem = None if buf is not None else "dk must be on a CUDA device"
    problem = problem or _merge_problem(part, dk, dv, plan)
    if problem is None and (part.device != dk.device
                            or dv.device != dk.device):
        problem = f"part, dk, dv must share {dk.device}"
    if problem is None and not plan["parts"]:
        problem = "the call's plan splits no walk"
    if problem is not None:
        raise ValueError(f"cuda_sparse_dkv_merge: {problem}")
    lib = _lib()
    b, t, nkv, d = dk.shape
    rc = lib.ds_sparse_dkv_merge(
        _ptr(part), ctypes.c_void_p(buf.data_ptr() + 4 * offs["merges"]),
        ctypes.c_void_p(buf.data_ptr() + 4 * offs["cols"]),
        len(plan["merges"]), _ptr(dk), _ptr(dv), t, nkv, d, block,
        _DTYPE_CODE[dk.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(dk.device).cuda_stream))
    _check_rc(lib, rc, "sparse_dkv_merge")
    cuda_sparse_dkv_merge.launches += 1
    return dk, dv


cuda_sparse_dkv_merge.launches = 0


def torch_sparse_dkv_merge(part, dk, dv, layout, block: int,
                           causal: bool = True, group: int = 1):
    """The second pass's formula → (dk, dv) copies with each merge's rows
    = its chunks of ``part`` added in chunk order (fp32), rounded once."""
    plan = _call_plan(layout, block, causal, group, dk)[0]
    problem = _merge_problem(part, dk, dv, plan)
    if problem is not None:
        raise ValueError(f"torch_sparse_dkv_merge: {problem}")
    dk, dv = dk.clone(), dv.clone()
    nkv = dk.shape[2]
    for g, u, p0, n in plan["merges"].tolist():
        acc = part[p0]
        for c in range(1, n):
            acc = acc + part[p0 + c]
        b, hk = divmod(u, nkv)
        for ci, col in enumerate(plan["cols"][g].tolist()):
            if col >= 0:
                rows = slice(ci * block, (ci + 1) * block)
                keys = slice(col * block, (col + 1) * block)
                dk[b, keys, hk] = acc[0, rows].to(dk.dtype)
                dv[b, keys, hk] = acc[1, rows].to(dv.dtype)
    return dk, dv


def cuda_sparse_dkv(q, k, v, o, lse, do, layout, block: int,
                    causal: bool = True, scale: Optional[float] = None,
                    delta=None):
    """dk, dv on the card, summed over the GQA group without atomics:
    ``sparse_dkv_route`` picks the kernel.  On the wgmma route a call
    launches ``sparse_dkv_wgmma_kernel`` once on ``sparse_dkv_plan``'s
    column groups and tasks, and, when a walk was split,
    ``cuda_sparse_dkv_merge`` once (its own counter); the other routes walk
    the transposed table."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if sparse_dkv_route(q.dtype, q.shape[-1], block) == "wgmma":
        _launch_dkv_wgmma(q, k, v, o, lse, do, layout, block, causal, scale,
                          delta, dk, dv)
    else:
        _launch_bwd(2, "sparse_dkv", q, k, v, o, lse, do, layout, block,
                    causal, scale, delta, None, dk, dv)
    cuda_sparse_dkv.launches += 1
    return dk, dv


cuda_sparse_dkv.launches = 0


class _BlockSparse(torch.autograd.Function):
    """o = block-sparse flash(q, k, v); saves (q, k, v, o, lse).  CUDA
    tensors go through the three kernels (the backward's dq first, handing
    the delta it makes to dk/dv), CPU tensors through the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block, causal, scale):
        fwd = cuda_sparse_fwd if q.device.type == "cuda" else torch_sparse_fwd
        o, lse = fwd(q, k, v, layout, block, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (layout, block, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type != "cuda":
            dq, dk, dv = torch_sparse_bwd(q, k, v, o, lse, do, *ctx.args)
        else:
            # dq makes delta = rowsum(o * do) (the "wgmma" route in its
            # units) and hands it on to dk/dv
            b, t, n, _ = q.shape
            delta = torch.empty((b, n, t), dtype=torch.float32,
                                device=q.device)
            dq = cuda_sparse_dq(q, k, v, o, lse, do, *ctx.args,
                                delta_out=delta)
            dk, dv = cuda_sparse_dkv(q, k, v, o, lse, do, *ctx.args,
                                     delta=delta)
        return dq, dk, dv, None, None, None, None


def block_sparse_flash(q, k, v, config: SparsityConfig, *,
                       causal: bool = True, scale: Optional[float] = None):
    """Block-skipping sparse attention on [B, T, N, D] (same layout out):
    work scales with the layout's active fraction (``sparsity_ratio``).  On
    CUDA tensors an unsupported call raises (see ``block_sparse_supported``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    layout = config.make_layout(q.shape[1]).astype(bool)
    return _BlockSparse.apply(q, k, v, layout, config.block, bool(causal),
                              float(scale))


def sparse_attention(q, k, v, config: SparsityConfig, *,
                     causal: bool = True, dropout_fn=None):
    """Block-sparse attention on [B, T, N, D] (reference
    SparseSelfAttention.forward): the static layout masks the score matrix.
    The block-skipping kernels on CUDA tensors (an unsupported call
    raises), the masked-dense plain body on CPU tensors and for any call
    with ``dropout_fn``."""
    if dropout_fn is not None:
        return torch_sparse_attention(q, k, v, config, causal=causal,
                                      dropout_fn=dropout_fn)
    from deepspeed_tpu_torch.ops.registry import dispatch
    return dispatch("sparse_attention", q, k, v, config, causal=causal)
