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
  family for every other call (fp32, block 8, other head dims).  Each
  block walks only its row's (or
  column's) live entries of the layout's index tables, which are built on
  the host once per (layout, causal, device) and kept on the device, so a
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
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.flash_attention import (_bwd_inputs, _check_rc,
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


def cuda_sparse_fwd(q, k, v, layout, block: int, causal: bool = True,
                    scale: Optional[float] = None):
    """Forward on the card → (o [B, T, N, D], lse fp32 [B, N, 1, T])."""
    tab, cnt, tail = _prepare("cuda_sparse_fwd", q, k, v, layout, block,
                              causal, scale)
    b, t, n, d = q.shape
    o = torch.empty((b, t, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.ds_sparse_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(tab), _ptr(cnt),
                           tab.shape[1], _ptr(o), _ptr(lse), *tail)
    _check_rc(lib, rc, "sparse_fwd")
    cuda_sparse_fwd.launches += 1
    return o, lse.view(b, n, 1, t)


cuda_sparse_fwd.launches = 0


def _launch_bwd(which, name, q, k, v, o, lse, do, layout, block, causal,
                scale, delta, dq, dk, dv):
    tab, cnt, tail = _prepare(name, q, k, v, layout, block, causal, scale,
                              col_major=which == 2)
    if delta is None:
        do, lse, delta = _bwd_inputs(name, q, o, lse, do)
    lib = _lib()
    rc = lib.ds_sparse_bwd(which, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
                           _ptr(lse), _ptr(delta), _ptr(tab), _ptr(cnt),
                           tab.shape[1], _ptr(dq), _ptr(dk), _ptr(dv), *tail)
    _check_rc(lib, rc, name)


def cuda_sparse_dq(q, k, v, o, lse, do, layout, block: int,
                   causal: bool = True, scale: Optional[float] = None,
                   delta=None):
    """dq on the card.  ``delta`` [B, N, T] fp32 may be passed by a caller
    that already ran ``_bwd_inputs`` (the autograd Function shares its
    result between dq and dk/dv); ``do`` and ``lse`` are then taken as
    returned by it."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(1, "sparse_dq", q, k, v, o, lse, do, layout, block, causal,
                scale, delta, dq, None, None)
    cuda_sparse_dq.launches += 1
    return dq


cuda_sparse_dq.launches = 0


def cuda_sparse_dkv(q, k, v, o, lse, do, layout, block: int,
                    causal: bool = True, scale: Optional[float] = None,
                    delta=None):
    """dk, dv on the card over the transposed table, summed over the GQA
    group without atomics."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(2, "sparse_dkv", q, k, v, o, lse, do, layout, block, causal,
                scale, delta, None, dk, dv)
    cuda_sparse_dkv.launches += 1
    return dk, dv


cuda_sparse_dkv.launches = 0


class _BlockSparse(torch.autograd.Function):
    """o = block-sparse flash(q, k, v); saves (q, k, v, o, lse).  CUDA
    tensors go through the three kernels, CPU tensors through the plain
    versions."""

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
            do, lse, delta = _bwd_inputs("block_sparse_flash", q, o, lse, do)
            dq = cuda_sparse_dq(q, k, v, o, lse, do, *ctx.args, delta=delta)
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
