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
- hand-written CUDA for Hopper, ``cuda_evoformer_fwd``
  (csrc/evoformer.cu): the forward with the per-row logsumexp, never
  materialising the logits; q, k, v and both biases read through their
  strides.  Its backward (the reference's four kernels dq, dk/dv, dbias2,
  dbias1) is not ported yet: a backward through the CUDA path raises
  ``NotImplementedError`` naming ROADMAP A.13.

``evoformer_attention`` routes as the reference does: an S that no block
tiles is padded (padded keys masked through bias1 = -1e9, padded query rows
sliced off); shapes the reference sends to its einsum (mismatched q/k/v, a
head dim not a multiple of 8) take the plain body on CPU tensors and raise
on CUDA tensors — no plain body runs on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.flash_attention import _check_rc, _ptr

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

_DTYPE_CODE = {torch.float16: 1, torch.bfloat16: 2}
_BIAS_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _bias_views(q, bias1, bias2):
    """bias1 as a [B, N, 1, 1, S] view and bias2 as a [B, 1, H, S, S] view
    (stride 0 where broadcast; nothing is materialised)."""
    b, n, s, h, _ = q.shape
    b1 = None if bias1 is None else torch.broadcast_to(bias1, (b, n, 1, 1, s))
    b2 = None if bias2 is None else torch.broadcast_to(bias2, (b, 1, h, s, s))
    return b1, b2


def _problem(q, k, v, bias1=None, bias2=None) -> Optional[str]:
    """Why the kernel cannot take this call (None: it can)."""
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        return "q, k, v must all be [B, N, S, H, D] of one shape"
    b, n, s, h, d = q.shape
    if min(b, n, s, h) < 1 or h > 65535 or b * n > 2 ** 31 - 1 \
            or -(-s // 64) > 65535:
        return f"[B, N, S, H] = {[b, n, s, h]} outside the grid's range"
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        return f"q, k, v must share one CUDA device (q on {q.device})"
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: the kernel " \
               f"takes float16 or bfloat16 for all three"
    if d % 8 or not 8 <= d <= 128:
        return f"head_dim {d}: the kernel takes multiples of 8 up to 128"
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(4) != 1 or any(st % 8 for st in x.stride()[:4]) \
                or x.data_ptr() % 16:
            return f"{name}: head_dim must be contiguous and every other " \
                   f"stride and the base 16-byte aligned"
    for name, x in (("bias1", bias1), ("bias2", bias2)):
        if x is None:
            continue
        if x.device != q.device or x.dtype not in _BIAS_CODE:
            return f"{name} must be float32/float16/bfloat16 on {q.device}"
    try:
        _bias_views(q, bias1, bias2)
    except RuntimeError:
        return f"bias1 {None if bias1 is None else tuple(bias1.shape)} / " \
               f"bias2 {None if bias2 is None else tuple(bias2.shape)} do " \
               f"not broadcast to [B, N, 1, 1, S] / [B, 1, H, S, S]"
    return None


def supported(q, k, v, bias1=None, bias2=None, **_) -> bool:
    """What the kernel takes: fp16/bf16 q, k, v [B, N, S, H, D] of one shape
    on one CUDA device, head_dim a multiple of 8 up to 128, contiguous,
    every other stride and the base 16-byte aligned; any S; biases fp32,
    fp16 or bf16, broadcastable to [B, N, 1, 1, S] and [B, 1, H, S, S]."""
    return _problem(q, k, v, bias1, bias2) is None


def _lib():
    """Build-and-load the kernel library once and declare its C interface."""
    from deepspeed_tpu_torch.ops.builder import load_op
    lib = load_op("evoformer")
    if not getattr(lib, "_ds_declared", False):
        P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ds_evoformer_fwd.argtypes = ([P] * 7 + [I] * 5 + [P, P]
                                         + [I, I, F_, I, P])
        lib.ds_evoformer_fwd.restype = I
        lib.ds_cuda_error_string.argtypes = [I]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib._ds_declared = True
    return lib


def cuda_evoformer_fwd(q, k, v, bias1=None, bias2=None):
    """Forward on the card → (o [B, N, S, H, D], lse fp32 [B·N, H, 1, S])."""
    problem = _problem(q, k, v, bias1, bias2)
    if problem is not None:
        raise ValueError(f"cuda_evoformer_fwd: {problem}")
    b, n, s, h, d = q.shape
    b1, b2 = _bias_views(q, bias1, bias2)
    qkv = (ctypes.c_longlong * 12)(*[x.stride(i) for x in (q, k, v)
                                     for i in (0, 1, 2, 3)])
    bst = (ctypes.c_longlong * 7)(
        *([0, 0, 0] if b1 is None else [b1.stride(0), b1.stride(1),
                                        b1.stride(4)]),
        *([0, 0, 0, 0] if b2 is None else [b2.stride(i)
                                           for i in (0, 2, 3, 4)]))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * n, h, s), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.ds_evoformer_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(b1), _ptr(b2), _ptr(o), _ptr(lse),
        b, n, s, h, d, qkv, bst,
        -1 if b1 is None else _BIAS_CODE[b1.dtype],
        -1 if b2 is None else _BIAS_CODE[b2.dtype], float(d ** -0.5),
        _DTYPE_CODE[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _check_rc(lib, rc, "evoformer_fwd")
    cuda_evoformer_fwd.launches += 1
    return o, lse.view(b * n, h, 1, s)


cuda_evoformer_fwd.launches = 0


class _Evoformer(torch.autograd.Function):
    """o = evoformer(q, k, v, bias1, bias2) through the forward kernel;
    saves the residuals the reference's backward reads (q, k, v, biases,
    o, lse).  The backward kernels are ROADMAP A.13."""

    @staticmethod
    def forward(ctx, q, k, v, bias1, bias2):
        o, lse = cuda_evoformer_fwd(q, k, v, bias1, bias2)
        ctx.save_for_backward(q, k, v, bias1, bias2, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "evoformer_attention: the backward on CUDA tensors needs the "
            "evoformer backward kernels #14-#17 (dq, dk/dv, dbias2, dbias1), "
            "ROADMAP A.13, not ported yet; the forward runs on the card, "
            "the CPU path differentiates the plain body")


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
            tgt = 32 if s0 >= 32 else 8
            pad = -(-s0 // tgt) * tgt - s0
            qp, kp, vp = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
            b1 = (torch.broadcast_to(bias1, (b, n, 1, 1, s0))
                  if bias1 is not None else
                  torch.zeros((b, n, 1, 1, s0), dtype=torch.float32,
                              device=q.device))
            b1p = F.pad(b1, (0, pad), value=-1e9)          # mask padded keys
            b2p = (F.pad(torch.broadcast_to(bias2, (b, 1, h, s0, s0)),
                         (0, pad, 0, pad))
                   if bias2 is not None else None)
            out = evoformer_attention(qp, kp, vp, b1p, b2p)
            return out[:, :, :s0]
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
