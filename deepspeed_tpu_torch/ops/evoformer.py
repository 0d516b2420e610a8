"""Evoformer attention — counterpart of deepspeed_tpu/ops/evoformer.py.

AlphaFold2-style attention over [B, N, S, H, D] (N: MSA rows or residue
pairs) with two broadcastable bias terms folded into the logits:

    out = softmax(Q·Kᵀ·d^-1/2 + bias1 + bias2) · V
    bias1: [B, N, 1, 1, S]   (per-key mask bias, e.g. -1e9 padding)
    bias2: [B, 1, H, S, S]   (pair-representation bias, shared over N)

Implementations, chosen by the device of the tensors:

- plain PyTorch: ``torch_evoformer`` (the counterpart of ``_evoformer_xla``:
  fp32 [B, N, H, S, S] logits, softmax, cast to q's dtype), the op's body
  on CPU tensors, differentiated by PyTorch's autograd; and
  ``torch_evoformer_fwd``, the forward kernel's formula without tiles with
  its logsumexp, the kernel's reference.
- hand-written CUDA for Hopper: ``cuda_evoformer_fwd`` (csrc/evoformer.cu),
  the forward with the per-row logsumexp, never materialising the logits
  (16-bit with head dim up to 128: the warp-specialised TMA + wgmma kernel
  of csrc/attn_fwd_hopper.cuh, tiled by ``evo_fwd_plan``; fp32 and wider
  head dims: a CUDA-core kernel);
  and ``cuda_evoformer_bwd`` (csrc/evoformer_bwd.cu), the reference's four
  backward kernels: dq, dk/dv, dbias2 and dbias1 (the last as per-head
  column sums inside dk/dv, added over heads in order).  16-bit with head
  dim up to 128: dk/dv on the warp-specialised TMA + wgmma dk/dv of
  csrc/attn_bwd_hopper.cuh (its evoformer variant) and dbias2 on a TMA +
  wgmma kernel whose units split the N rows into chunks (fp32 partial sums,
  added in ascending order by a second pass), both tiled by
  ``evo_bwd_plan``; dq stays on mma.sync; fp32 and wider head dims take
  CUDA-core kernels.  q, k, v and both biases are read through their
  strides.  ``torch_evoformer_bwd`` is the backward kernels' formula
  without tiles, their reference, and ``torch_evoformer_db2_sum`` the
  second pass's.

``evoformer_attention`` routes as the reference does: an S that no block
tiles is padded (padded keys masked through bias1 = -1e9, padded query rows
sliced off); shapes the reference sends to its einsum (mismatched q/k/v, a
head dim not a multiple of 8) take the plain body on CPU tensors and raise
on CUDA tensors — no plain body runs on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.flash_attention import (
    SMEM_LIMIT, _BWD_MAX_STAGES, _check_rc, _ptr, fwd_plan)

NEG_INF = -1e30     # finite "minus infinity" of the kernels


def _logits(q, k, bias1, bias2):
    """fp32 [B, N, H, S, S] logits, summed in the kernels' order: scaled
    q·kᵀ, then + bias1, then + bias2."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) * scale
    if bias1 is not None:
        s = s + bias1.float()
    if bias2 is not None:
        s = s + bias2.float()
    return s


def torch_evoformer(q, k, v, bias1=None, bias2=None):
    """Plain body (counterpart of ``_evoformer_xla``): the full fp32 logits,
    softmax, ``· v`` in fp32, cast to q's dtype."""
    probs = torch.softmax(_logits(q, k, bias1, bias2), dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, v.float())
    return out.to(q.dtype)


def torch_evoformer_fwd(q, k, v, bias1=None, bias2=None):
    """The forward kernel's formula without tiles → (o [B, N, S, H, D],
    lse fp32 [B·N, H, 1, S]): the running maximum starts at -1e30, a row
    whose maximum stays there gives probabilities 0 (o = 0, lse = -1e30),
    probabilities are cast to v's dtype before ``· v`` and the sum is
    divided by the fp32 denominator afterwards."""
    b, n, s, h, d = q.shape
    logits = _logits(q, k, bias1, bias2)
    m = logits.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.where(m > NEG_INF / 2, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    pv = torch.einsum("bnhqk,bnkhd->bnqhd", p.to(v.dtype).float(), v.float())
    o = (pv / l.permute(0, 1, 3, 2, 4)).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b * n, h, 1, s)
    return o, lse


def _probs_ds(q, k, bias1, bias2, lse, dp, delta):
    """p = exp(s − lse) (0 on a row whose lse is −1e30) and ds = p·(dp −
    delta), fp32 [B, N, H, S, S], from the logits recomputed in the
    forward's order."""
    b, n, s, h, _ = q.shape
    lse = lse.reshape(b, n, h, s, 1)
    p = torch.where(lse > NEG_INF / 2,
                    torch.exp(_logits(q, k, bias1, bias2) - lse), 0.0)
    return p, p * (dp - delta.reshape(b, n, h, s, 1))


def torch_evoformer_bwd(q, k, v, bias1, bias2, o, lse, do):
    """The backward kernels' formula without tiles (the reference's
    _bwd_impl :291) → (dq, dk, dv, db1 fp32 [B, N, 1, 1, S] | None, db2
    fp32 [B, 1, H, S, S] | None), from the forward's o and lse: the logits
    recomputed in the forward's order, p = exp(s − lse) (0 on a row whose
    lse is −1e30), ds = p·(do·vᵀ − delta) with delta = rowsum(o·do) in
    fp32; ds is cast to k's / q's dtype before the dq / dk products (scale
    applied to the fp32 sums) and p to do's dtype before dv, as the
    reference casts; dbias2 = Σ_n ds, dbias1 = Σ_{h,q} ds."""
    b, n, s, h, d = q.shape
    scale = d ** -0.5
    dp = torch.einsum("bnqhd,bnkhd->bnhqk", do.float(), v.float())
    p, ds = _probs_ds(q, k, bias1, bias2, lse, dp, _delta(o, do))
    dq = scale * torch.einsum("bnhqk,bnkhd->bnqhd", ds.to(k.dtype).float(),
                              k.float())
    dk = scale * torch.einsum("bnhqk,bnqhd->bnkhd", ds.to(q.dtype).float(),
                              q.float())
    dv = torch.einsum("bnhqk,bnqhd->bnkhd", p.to(do.dtype).float(),
                      do.float())
    db1 = None if bias1 is None else ds.sum((2, 3)).reshape(b, n, 1, 1, s)
    db2 = None if bias2 is None else ds.sum(1).reshape(b, 1, h, s, s)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), db1, db2


def torch_evoformer_db2_part(q, k, v, bias1, bias2, o, lse, do, rows):
    """The 16-bit dbias2 kernel's partial sums without tiles → fp32
    [len(rows), B, H, S, S]: for each chunk (lo, hi) of the MSA rows (as
    ``evo_bwd_plan`` splits them), ds summed over rows lo..hi−1 one row
    after another, as each unit walks its chunk.  q, k, v, bias1, o, do and
    lse ([B·N, H, 1, S]) may hold only the rows that ``rows`` covers,
    counted from the first."""
    b, n, s, h, _ = q.shape
    dp = torch.einsum("bnqhd,bnkhd->bnhqk", do.float(), v.float())
    ds = _probs_ds(q, k, bias1, bias2, lse, dp, _delta(o, do))[1]
    parts = []
    for lo, hi in rows:
        acc = torch.zeros_like(ds[:, 0])
        for r in range(lo, hi):
            acc = acc + ds[:, r]
        parts.append(acc)
    return torch.stack(parts)


def torch_evoformer_db2_sum(part):
    """The second pass's formula: db2 [B, H, S, S] = the chunks of part
    [chunks, B, H, S, S] fp32 added in ascending order."""
    out = part[0].clone()
    for c in range(1, part.shape[0]):
        out = out + part[c]
    return out


def _block_sizes(s: int, prefer: int = 512):
    """The reference's divisor ladder: the tile its blockwise kernel would
    use for S (None: S needs padding first)."""
    for b in (prefer, 512, 256, 128, 64, 32, 16, 8):
        if b <= s and s % b == 0:
            return b
    return None


def _tiles(q, k, v) -> bool:
    """The reference's ``supported``: shapes its blockwise kernel takes
    without padding."""
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        return False
    s, d = q.shape[2], q.shape[4]
    return _block_sizes(s) is not None and d % 8 == 0 and s >= 8


# ------------------------------------------------------------------ kernel

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_BIAS_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def evo_fwd_plan(d: int, bias2_bytes: int = 2) -> dict:
    """The 16-bit forward's tiles for head dim ``d`` (8..128): compiled width
    hd_k (16, 32, 64 or 128; the pad is TMA's zero fill), 128 queries a
    unit, ``bn`` keys a tile (128 up to hd_k 64, else 64), and, beside K
    and V in each stage, the [128, bn] bias2 tile of ``bias2_bytes`` an
    element (0: no bias2) and the bias1 slice (fp32, always staged: -inf
    past S masks the ragged key tile); Q slots, ring depth and
    shared-memory bytes as ``flash_attention.fwd_plan``."""
    hd_k = next(w for w in (16, 32, 64, 128) if d <= w)
    bn = 128 if hd_k <= 64 else 64
    return fwd_plan(hd_k, bn, 128 * bn * bias2_bytes + 4 * bn)


_DB2_WAVES = 8       # dbias2's units: about this many to a multiprocessor
H100_SMS = 132       # the H100's streaming multiprocessors


def _ceil1024(x: int) -> int:
    return -(-x // 1024) * 1024


def evo_bwd_plan(d: int, bias2_bytes: int = 2, b: int = 1, n: int = 1,
                 s: int = 1, h: int = 1, sms: int = H100_SMS) -> dict:
    """The 16-bit backward's tiles for head dim ``d`` (8..128) at the
    forward's compiled widths hd_k (16, 32, 64, 128; TMA boxes of 64
    columns, the pad zero-filled), with bias2 of ``bias2_bytes`` an
    element (0: none) and [B, N, S, H] = ``b, n, s, h``.

    dk/dv (csrc/attn_bwd_hopper.cuh ``BwdLayout::evo_dkv``, the same
    formula): 128 ``keys`` a unit, its K, V and bias1 slice in a slot;
    ``bm`` queries a ring stage (64 up to hd_k 64, 32 at 128, where dk + dv
    take 128 registers a thread) with the [bm, 128] bias2 tile and the lse
    and delta rows.  Two
    slots (the next unit's K and V land during this one) where two stages
    still fit beside them, else one; then as many stages as fit, at most
    ``_BWD_MAX_STAGES``.

    dbias2 (csrc/evoformer_bwd.cu ``Db2Layout``): units of 128 ``queries``
    x 64 ``keys`` x a chunk of MSA rows, a stage one row's Q, dO, K, V
    (``row_bytes`` a row: 64 up to hd_k 32, in the 64-byte swizzle, so the
    narrow heads' ring is deep) and its lse, delta and bias1 rows
    (``units`` in all; dk/dv's ``units`` are
    its (batch * row, head, key tile) units).  ``chunks`` partition [0, N) in
    ascending order, ``chunk_rows`` each (the last shorter; ``rows`` their
    bounds), as many as give the units ``_DB2_WAVES`` times ``sms``; each
    unit writes an fp32 partial, [chunks, B, H, S, S] (``part_bytes``),
    which the second pass adds in chunk order."""
    hd_k = next(w for w in (16, 32, 64, 128) if d <= w)
    hdp = -(-hd_k // 64) * 64
    fixed = (4 + 2 * _BWD_MAX_STAGES) * 8 + 1024  # mbarriers, alignment slack
    bm = 64 if hd_k <= 64 else 32
    slot = _ceil1024(2 * 128 * hdp * 2 + 128 * 4)
    stage = _ceil1024(2 * bm * hdp * 2 + bm * 128 * bias2_bytes + 2 * bm * 4)
    fits = {slots: min(_BWD_MAX_STAGES,
                       (SMEM_LIMIT - fixed - slots * slot) // stage)
            for slots in (2, 1)}
    slots = 2 if fits[2] >= 2 else 1
    stages = fits[slots]
    row2 = 64 if hd_k <= 32 else hdp * 2     # dbias2's tile row, bytes
    stage2 = _ceil1024(2 * 128 * row2 + 2 * 64 * row2 + (2 * 128 + 64) * 4)
    stages2 = min(_BWD_MAX_STAGES, (SMEM_LIMIT - fixed) // stage2)
    if min(stages, stages2) < 2:
        raise ValueError(f"no backward plan fits {SMEM_LIMIT} bytes at head "
                         f"dim {hd_k}, bias2 of {bias2_bytes} bytes")
    tiles = b * h * -(-s // 128) * -(-s // 64)
    want = max(1, min(n, -(-_DB2_WAVES * sms // tiles)))
    rows = -(-n // want)
    chunks = -(-n // rows)
    return dict(
        hd_k=hd_k, hdp=hdp,
        dkv=dict(keys=128, bm=bm, slots=slots, stages=stages,
                 slot_bytes=slot, stage_bytes=stage,
                 smem=fixed + slots * slot + stages * stage,
                 units=b * n * h * -(-s // 128)),
        db2=dict(queries=128, keys=64, row_bytes=row2, stages=stages2,
                 stage_bytes=stage2,
                 smem=fixed + stages2 * stage2, units=tiles * chunks,
                 chunks=chunks,
                 chunk_rows=rows,
                 rows=tuple((i * rows, min(n, (i + 1) * rows))
                            for i in range(chunks)),
                 part_bytes=chunks * b * h * s * s * 4))


def _bias_views(q, bias1, bias2):
    """bias1 as a [B, N, 1, 1, S] view and bias2 as a [B, 1, H, S, S] view
    (stride 0 where broadcast; nothing is materialised)."""
    b, n, s, h, _ = q.shape
    b1 = None if bias1 is None else torch.broadcast_to(bias1, (b, n, 1, 1, s))
    b2 = None if bias2 is None else torch.broadcast_to(bias2, (b, 1, h, s, s))
    return b1, b2


def shape_problem(q, k, v, bias1=None, bias2=None) -> Optional[str]:
    """The kernels' rules on shapes, dtypes, strides and biases, without
    looking at the device (None: they take the call)."""
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        return "q, k, v must all be [B, N, S, H, D] of one shape"
    b, n, s, h, d = q.shape
    if min(b, n, s, h) < 1 or h > 65535 or b * n > 2 ** 31 - 1 \
            or -(-s // 8) > 65535 or b * s > 2 ** 31 - 1:
        return f"[B, N, S, H] = {[b, n, s, h]} outside the grid's range"
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: the kernels " \
               f"take float32, float16 or bfloat16 for all three"
    if d % 8 or not 8 <= d <= 256:
        return f"head_dim {d}: the kernels take multiples of 8 from 8 to " \
               f"256 (ROADMAP C.1)"
    # the 16-bit forward reads q, k, v by TMA, which takes a 16-byte-aligned
    # base and strides that are multiples of 16 bytes; the other kernels
    # load 16-byte rows
    per16 = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(4) != 1 or any(st % per16 for st in x.stride()[:4]) \
                or x.data_ptr() % 16:
            return f"{name}: head_dim must be contiguous and every other " \
                   f"stride and the base 16-byte aligned (TMA's rule: " \
                   f"strides {tuple(x.stride())}, base offset " \
                   f"{x.data_ptr() % 16} bytes)"
        # a token stride of 0 collapses the map's token dim to one row,
        # which the tensor-core kernels' boxes of many rows cannot read
        if x.stride(2) == 0 and s > 1 and q.dtype != torch.float32 \
                and d <= 128:
            return f"{name}: a token stride of 0 (broadcast over tokens) " \
                   f"cannot be read by TMA; pass it contiguous"
    for name, x in (("bias1", bias1), ("bias2", bias2)):
        if x is not None and x.dtype not in _BIAS_CODE:
            return f"{name} must be float32/float16/bfloat16"
    try:
        _bias_views(q, bias1, bias2)
    except RuntimeError:
        return f"bias1 {None if bias1 is None else tuple(bias1.shape)} / " \
               f"bias2 {None if bias2 is None else tuple(bias2.shape)} do " \
               f"not broadcast to [B, N, 1, 1, S] / [B, 1, H, S, S]"
    return None


def _problem(q, k, v, bias1=None, bias2=None) -> Optional[str]:
    """Why the kernels cannot take this call (None: they can)."""
    problem = shape_problem(q, k, v, bias1, bias2)
    if problem is not None:
        return problem
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        return f"q, k, v must share one CUDA device (q on {q.device})"
    for name, x in (("bias1", bias1), ("bias2", bias2)):
        if x is not None and x.device != q.device:
            return f"{name} must be on {q.device}"
    return None


def supported(q, k, v, bias1=None, bias2=None, **_) -> bool:
    """What the kernels take: fp32/fp16/bf16 q, k, v [B, N, S, H, D] of one
    shape on one CUDA device, head_dim a multiple of 8 up to 256,
    contiguous, every other stride and the base 16-byte aligned; any S;
    biases fp32, fp16 or bf16, broadcastable to [B, N, 1, 1, S] and
    [B, 1, H, S, S].  16-bit inputs with head_dim up to 128 run on the
    tensor cores, fp32 and wider head_dims on the CUDA-core variants."""
    return _problem(q, k, v, bias1, bias2) is None


def _lib(name="evoformer"):
    """Build-and-load a kernel library (``evoformer``: the forward,
    ``evoformer_bwd``: the backward) once and declare its C interface."""
    from deepspeed_tpu_torch.ops.builder import load_op
    lib = load_op(name)
    if not getattr(lib, "_ds_declared", False):
        P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "evoformer":
            lib.ds_evoformer_fwd.argtypes = ([P] * 7 + [I] * 5 + [P, P]
                                             + [I, I, F_, I, I, I, P])
            lib.ds_evoformer_fwd.restype = I
        else:
            lib.ds_evoformer_bwd.argtypes = ([I] + [P] * 15 + [I] * 5
                                             + [P, P] + [I, I, F_] + [I] * 4
                                             + [P])
            lib.ds_evoformer_bwd.restype = I
            lib.ds_evoformer_db2_sum.argtypes = [P, P, ctypes.c_longlong, I,
                                                 P]
            lib.ds_evoformer_db2_sum.restype = I
        lib.ds_cuda_error_string.argtypes = [I]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib._ds_declared = True
    return lib


def _strides(q, k, v, b1, b2):
    """The kernels' stride arrays: q, k, v (batch, row, token, head) and
    bias1 (batch, row, key) / bias2 (batch, head, query, key) of the
    broadcast views (0 where absent)."""
    qkv = (ctypes.c_longlong * 12)(*[x.stride(i) for x in (q, k, v)
                                     for i in (0, 1, 2, 3)])
    bst = (ctypes.c_longlong * 7)(
        *([0, 0, 0] if b1 is None else [b1.stride(0), b1.stride(1),
                                        b1.stride(4)]),
        *([0, 0, 0, 0] if b2 is None else [b2.stride(i)
                                           for i in (0, 2, 3, 4)]))
    return qkv, bst


def _codes(b1, b2):
    return (-1 if b1 is None else _BIAS_CODE[b1.dtype],
            -1 if b2 is None else _BIAS_CODE[b2.dtype])


def _stream(q):
    return ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)


def cuda_evoformer_fwd(q, k, v, bias1=None, bias2=None):
    """Forward on the card → (o [B, N, S, H, D], lse fp32 [B·N, H, 1, S])."""
    problem = _problem(q, k, v, bias1, bias2)
    if problem is not None:
        raise ValueError(f"cuda_evoformer_fwd: {problem}")
    b, n, s, h, d = q.shape
    b1, b2 = _bias_views(q, bias1, bias2)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * n, h, s), dtype=torch.float32, device=q.device)
    plan = (evo_fwd_plan(d, 0 if b2 is None else b2.element_size())
            if q.dtype != torch.float32 and d <= 128 else
            dict(stages=0, qslots=0))        # the CUDA-core kernel's call
    lib = _lib()
    rc = lib.ds_evoformer_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(b1), _ptr(b2), _ptr(o), _ptr(lse),
        b, n, s, h, d, *_strides(q, k, v, b1, b2), *_codes(b1, b2),
        float(d ** -0.5), plan["stages"], plan["qslots"],
        _DTYPE_CODE[q.dtype], _stream(q))
    _check_rc(lib, rc, "evoformer_fwd")
    cuda_evoformer_fwd.launches += 1
    return o, lse.view(b * n, h, 1, s)


cuda_evoformer_fwd.launches = 0


def _delta(o, do):
    """delta = rowsum(o·do) in fp32, from o in q's dtype → [B·N, H, S]
    (the reference's _bwd_impl :299)."""
    b, n, s, h, _ = o.shape
    return ((o.float() * do.float()).sum(-1).permute(0, 1, 3, 2)
            .reshape(b * n, h, s).contiguous())


def _bwd_problem(q, k, v, bias1, bias2, o, lse, do) -> Optional[str]:
    """Why the backward kernels cannot take this call (None: they can):
    what the forward takes, with o and do [B, N, S, H, D] in q's dtype (do
    contiguous: the kernels read it; o only feeds delta) and lse fp32
    [B·N, H, 1, S] as the forward wrote it."""
    problem = _problem(q, k, v, bias1, bias2)
    if problem is not None:
        return problem
    b, n, s, h, _ = q.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            return f"{name} must be a {tuple(q.shape)} {q.dtype} tensor " \
                   f"on {q.device}"
    if not do.is_contiguous():
        return "do must be contiguous"
    if lse.dtype != torch.float32 or lse.numel() != b * n * h * s \
            or lse.device != q.device or not lse.is_contiguous():
        return f"lse must be a contiguous float32 [B·N, H, 1, S] = " \
               f"{[b * n, h, 1, s]} tensor on {q.device}"
    return None


_BWD_KERNEL = {"dq": 0, "dkv": 1, "db2": 2, "db1": 3}


def tensor_core_bwd(q) -> bool:
    """The backward's route rule: 16-bit q with head dim up to 128 takes
    dk/dv and dbias2 on the TMA + wgmma kernels (tiled by ``evo_bwd_plan``;
    dbias2 through its partial sums and the second pass); fp32 and wider
    head dims take the CUDA-core variants, which write dbias2 directly."""
    return q.dtype != torch.float32 and q.shape[-1] <= 128


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_plan(q, b2):
    b, n, s, h, d = q.shape
    return evo_bwd_plan(d, 0 if b2 is None else b2.element_size(), b, n, s,
                        h, _sms(q.device.index))


def _launch_bwd(which, q, k, v, b1, b2, lse, delta, do, out, plan=(0, 0, 0)):
    b, n, s, h, d = q.shape
    lib = _lib("evoformer_bwd")
    rc = lib.ds_evoformer_bwd(
        _BWD_KERNEL[which], _ptr(q), _ptr(k), _ptr(v), _ptr(b1), _ptr(b2),
        _ptr(do), _ptr(lse), _ptr(delta),
        *(_ptr(out.get(x)) for x in ("dq", "dk", "dv", "part", "db1", "db2",
                                     "db2_part")),
        b, n, s, h, d, *_strides(q, k, v, b1, b2), *_codes(b1, b2),
        float(d ** -0.5), *plan, _DTYPE_CODE[q.dtype], _stream(q))
    _check_rc(lib, rc, f"evoformer_{which}")


def _bwd_kernel(which, q, k, v, b1, b2, lse, delta, do, part=None):
    """Launch one backward kernel on checked inputs (b1 / b2 the broadcast
    views) and return its output: dq; (dk, dv, part) — ``part=True``
    also writes bias1's per-head column sums of ds, fp32 [B·N, H, S];
    db2 fp32 [B, H, S, S] (on the tensor cores: the chunks' partial sums,
    then the second pass, one call); or, from ``part``, db1 fp32
    [B·N, S]."""
    b, n, s, h, d = q.shape
    empty = functools.partial(torch.empty, device=q.device)
    out = {}
    tc = tensor_core_bwd(q) and which in ("dkv", "db2")
    plan = _bwd_plan(q, b2) if tc else None
    knobs = (0, 0, 0)
    if which == "dq":
        out["dq"] = empty(q.shape, dtype=q.dtype)
    elif which == "dkv":
        out["dk"] = empty(q.shape, dtype=q.dtype)
        out["dv"] = empty(q.shape, dtype=q.dtype)
        if part:
            out["part"] = empty((b * n, h, s), dtype=torch.float32)
        if tc:
            knobs = (plan["dkv"]["stages"], plan["dkv"]["slots"], 0)
    elif which == "db2":
        out["db2"] = empty((b, h, s, s), dtype=torch.float32)
        if tc:
            knobs = (plan["db2"]["stages"], 1, plan["db2"]["chunks"])
            out["db2_part"] = empty((knobs[2], b, h, s, s),
                                    dtype=torch.float32)
    else:
        out["part"] = part
        out["db1"] = empty((b * n, s), dtype=torch.float32)
    _launch_bwd(which, q, k, v, b1, b2, lse, delta, do, out, knobs)
    counter = f"{which}_launches"
    setattr(cuda_evoformer_bwd, counter,
            getattr(cuda_evoformer_bwd, counter) + 1)
    if which == "db2" and tc:
        cuda_evoformer_db2_sum(out["db2_part"], out["db2"])
    if which == "dkv":
        return out["dk"], out["dv"], out.get("part")
    return out[which]


def cuda_evoformer_db2_sum(part, db2=None):
    """dbias2's second pass on the card (``evo_db2_sum_kernel``): db2 fp32
    [B, H, S, S] (written into ``db2`` when given) = the chunks of the
    contiguous fp32 partial [chunks, B, H, S, S] added in ascending order."""
    if part.device.type != "cuda" or part.dtype != torch.float32 \
            or part.dim() != 5 or not part.is_contiguous():
        raise ValueError(f"cuda_evoformer_db2_sum: part must be a contiguous "
                         f"float32 [chunks, B, H, S, S] CUDA tensor, got "
                         f"{part.dtype} {tuple(part.shape)} on {part.device}")
    if db2 is None:
        db2 = torch.empty(part.shape[1:], dtype=torch.float32,
                          device=part.device)
    lib = _lib("evoformer_bwd")
    rc = lib.ds_evoformer_db2_sum(
        _ptr(part), _ptr(db2), part[0].numel(), part.shape[0], _stream(part))
    _check_rc(lib, rc, "evoformer_db2_sum")
    cuda_evoformer_bwd.db2_sum_launches += 1
    return db2


def cuda_evoformer_bwd(q, k, v, bias1, bias2, o, lse, do, db1=None,
                       db2=None):
    """Backward on the card → (dq, dk, dv, db1 fp32 [B, N, 1, 1, S] | None,
    db2 fp32 [B, 1, H, S, S] | None), through dq (#14), dk/dv (#15),
    dbias2 (#16, with its second pass on the tensor-core route) and dbias1
    (#17); ``db1`` / ``db2`` (default: whether the bias is given) say
    whether the bias gradients are wanted, and the reference's unused bias
    cotangents cost nothing here either."""
    problem = _bwd_problem(q, k, v, bias1, bias2, o, lse, do)
    if problem is not None:
        raise ValueError(f"cuda_evoformer_bwd: {problem}")
    b, n, s, h, _ = q.shape
    want1 = bias1 is not None and (db1 is None or bool(db1))
    want2 = bias2 is not None and (db2 is None or bool(db2))
    b1, b2 = _bias_views(q, bias1, bias2)
    args = (q, k, v, b1, b2, lse, _delta(o, do), do)
    dq = _bwd_kernel("dq", *args)
    dk, dv, part = _bwd_kernel("dkv", *args, part=want1)
    g2 = _bwd_kernel("db2", *args).view(b, 1, h, s, s) if want2 else None
    g1 = (_bwd_kernel("db1", *args, part=part).view(b, n, 1, 1, s)
          if want1 else None)
    return dq, dk, dv, g1, g2


cuda_evoformer_bwd.dq_launches = 0
cuda_evoformer_bwd.dkv_launches = 0
cuda_evoformer_bwd.db2_launches = 0
cuda_evoformer_bwd.db2_sum_launches = 0
cuda_evoformer_bwd.db1_launches = 0


def _bias_grads(db1, db2, bias1, bias2):
    """The fp32 bias gradients of the broadcast problem ([B, N, 1, 1, S],
    [B, 1, H, S, S]) as the caller's biases: cast to each bias's dtype, as
    the reference's backward does (_evo_bwd :446-447), then summed over the
    dims the bias was broadcast along, as autodiff of the reference's
    ``broadcast_to`` does."""
    return tuple(None if g is None else g.to(x.dtype).sum_to_size(x.shape)
                 for g, x in ((db1, bias1), (db2, bias2)))


class _Evoformer(torch.autograd.Function):
    """o = evoformer(q, k, v, bias1, bias2) through the forward kernel,
    differentiated through the four backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, bias1, bias2):
        o, lse = cuda_evoformer_fwd(q, k, v, bias1, bias2)
        ctx.save_for_backward(q, k, v, bias1, bias2, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias1, bias2, o, lse = ctx.saved_tensors
        # ``.sum().backward()`` hands in a do whose strides are all 0; the
        # kernels read 16-byte rows, so it is copied (not a fallback)
        dq, dk, dv, db1, db2 = cuda_evoformer_bwd(
            q, k, v, bias1, bias2, o, lse, do.contiguous(),
            db1=ctx.needs_input_grad[3], db2=ctx.needs_input_grad[4])
        return (dq, dk, dv) + _bias_grads(db1, db2, bias1, bias2)


def _padded(q, k, v, bias1=None, bias2=None):
    """The reference's padding route for an S that no block tiles: q, k, v
    and both biases padded to a multiple of 32 (of 8 below 32), the padded
    keys masked through bias1 = -1e9 (a zero bias1 is made where none is
    given), so that the CPU and CUDA paths see the same padded problem."""
    b, n, s0, h, _ = q.shape
    tgt = 32 if s0 >= 32 else 8
    pad = -(-s0 // tgt) * tgt - s0
    qp, kp, vp = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    b1 = (torch.broadcast_to(bias1, (b, n, 1, 1, s0)) if bias1 is not None
          else torch.zeros((b, n, 1, 1, s0), dtype=torch.float32,
                           device=q.device))
    b1p = F.pad(b1, (0, pad), value=-1e9)
    b2p = (F.pad(torch.broadcast_to(bias2, (b, 1, h, s0, s0)),
                 (0, pad, 0, pad)) if bias2 is not None else None)
    return qp, kp, vp, b1p, b2p


_warned_fallback = set()


def evoformer_attention(q, k, v, bias1=None, bias2=None):
    """q/k/v: [B, N, S, H, D]; bias1 broadcastable to [B, N, 1, 1, S];
    bias2 broadcastable to [B, 1, H, S, S].  Returns [B, N, S, H, D].

    reference evoformer_attn.py:DS4Sci_EvoformerAttention.  Sequence
    lengths that no block tiles are padded (to a multiple of 32, of 8
    below 32; padded keys masked through bias1 = -1e9, padded query rows
    sliced off), so the CPU and CUDA paths see the same padded problem.
    Shapes the reference sends to its einsum (mismatched q/k/v, head dim
    not a multiple of 8) run the plain body on CPU tensors, with a one-time
    warning, and raise on CUDA tensors."""
    if q.dim() != 5:
        raise ValueError(f"evoformer attention expects [B, N, S, H, D] "
                         f"tensors, got rank {q.dim()}")
    if not _tiles(q, k, v):
        b, n, s0, h, d = q.shape
        if k.shape == q.shape and v.shape == q.shape and d % 8 == 0:
            return evoformer_attention(*_padded(q, k, v, bias1, bias2))[
                :, :, :s0]
        if q.device.type != "cpu":
            raise ValueError(
                f"evoformer_attention: shapes q={tuple(q.shape)} "
                f"k={tuple(k.shape)} v={tuple(v.shape)} need matching q/k/v "
                f"and a head dim that is a multiple of 8 on CUDA; the "
                f"reference's einsum fallback materialises the [B, N, H, S, "
                f"S] logits and has no place on the card")
        key = (tuple(q.shape), tuple(k.shape), tuple(v.shape))
        if key not in _warned_fallback:
            _warned_fallback.add(key)
            from deepspeed_tpu_torch.utils.logging import logger
            logger.warning(
                "evoformer_attention: shapes q=%s k=%s v=%s cannot run the "
                "blockwise kernel (needs matching shapes and head dim "
                "%% 8 == 0); the plain body MATERIALIZES the [B, N, H, S, S] "
                "logits", *key)
        return torch_evoformer(q, k, v, bias1, bias2)
    from deepspeed_tpu_torch.ops.registry import dispatch
    return dispatch("evoformer_attention", q, k, v, bias1, bias2)
