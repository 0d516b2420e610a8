"""deepspeed_tpu_torch.ops — kernel layer (counterpart of deepspeed_tpu/ops).

Every op has a plain PyTorch implementation and, where the TPU package had
a Pallas kernel, a hand-written CUDA kernel; the registry (ops/registry.py)
picks by the device of the tensors.  Public surface of this slice:

- ``causal_attention(q, k, v, ...)``  training attention: flash kernels on
  CUDA tensors, the plain body on CPU tensors and for mask/bias/dropout
- ``flash_attention(...)``            direct differentiable flash entry
- ``lm_cross_entropy(...)``           chunked unembed + softmax CE
- ``paged_attention(...)``            paged decode attention (16-bit or
                                      int8 pages)
- ``ragged_prefill_attention(...)``   ragged chunked-prefill attention
- ``wq_any`` / ``wq_matmul_t``        quantized-weight matmuls (ops
                                      ``wq_matmul``, ``wq_matmul4``,
                                      ``wq_matmul_t``)
- ``lora_matmul(...)``                batched-gather LoRA delta
- ``sparse_attention(q, k, v, config)`` block-sparse attention over a
                                      ``SparsityConfig`` layout (Dense,
                                      Fixed, BSLongformer, BigBird);
                                      ``sparsity_ratio``
- ``evoformer_attention(q, k, v, bias1, bias2)``  AlphaFold2-style
                                      attention over [B, N, S, H, D]
- ``rms_norm`` / ``layer_norm``
- ``op_report()``                     which implementation each device takes
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deepspeed_tpu_torch.ops import evoformer as _evo
from deepspeed_tpu_torch.ops import flash_attention as _flash
from deepspeed_tpu_torch.ops import lora_matmul as _lora
from deepspeed_tpu_torch.ops import paged_attention as _paged
from deepspeed_tpu_torch.ops import registry
from deepspeed_tpu_torch.ops import sparse_attention as _sparse
from deepspeed_tpu_torch.ops import wq_matmul as _wq
from deepspeed_tpu_torch.ops.cross_entropy import (lm_cross_entropy,
                                                   masked_nll_sum)
from deepspeed_tpu_torch.ops.evoformer import evoformer_attention
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.norms import layer_norm, rms_norm
from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                     ragged_prefill_attention)
from deepspeed_tpu_torch.ops.registry import dispatch, op_report, register_op
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, SparsityConfig, sparse_attention, sparsity_ratio)
from deepspeed_tpu_torch.ops.wq_matmul import wq_any, wq_matmul_t



def _attention_torch(q, k, v, *, causal=True, scale=None, dropout_fn=None,
                     mask=None, bias=None, window=None, alibi_slopes=None):
    """Plain attention on [B, T, N, D] — the counterpart of
    ``_attention_xla`` and the numeric ground truth for the flash kernels:
    causal tril masking, or an explicit [B, Tq, S] boolean mask (all-False
    rows give zeros, not NaN), or a causal sliding ``window``; ``bias``
    [B|1, N, Tq|1, S] and ``alibi_slopes`` are added to the fp32 logits;
    probabilities are cast to q's dtype before ``dropout_fn`` and ``· v``."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    t, s = q.shape[1], k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("btnd,bsnd->bnts", q, k).float() * scale
    if alibi_slopes is not None:
        sl = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                             device=q.device).reshape(q.shape[2])
        logits = logits + sl[None, :, None, None] * torch.arange(
            s, dtype=torch.float32, device=q.device)
    if bias is not None:
        logits = logits + bias.float()
    neg = torch.finfo(torch.float32).min
    if window is not None:
        rel = (torch.arange(t, device=q.device)[:, None]
               - torch.arange(s, device=q.device)[None, :])
        m = ((rel >= 0) & (rel < window))[None, None]
    elif mask is not None:
        m = mask[:, None]                                # [B, 1, Tq, S]
    elif causal:
        m = torch.ones((t, s), dtype=torch.bool,
                       device=q.device).tril()[None, None]
    else:
        m = None
    if m is not None:
        logits = torch.where(m, logits, neg)
    probs = torch.softmax(logits, dim=-1)
    if m is not None and (window is not None or mask is not None):
        probs = torch.where(m.any(-1, keepdim=True), probs, 0.0)
    probs = probs.to(q.dtype)
    if dropout_fn is not None:
        probs = dropout_fn(probs)
    return torch.einsum("bnts,bsnd->btnd", probs, v)


def _attention_flash(q, k, v, *, causal=True, scale=None, dropout_fn=None,
                     mask=None, bias=None, window=None, alibi_slopes=None):
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           window=window, alibi_slopes=alibi_slopes)


def _attention_supported(q, k, v, *, causal=True, scale=None,
                         dropout_fn=None, mask=None, bias=None, window=None,
                         alibi_slopes=None):
    return _flash.supported(q, k, v, causal=causal, window=window,
                            alibi_slopes=alibi_slopes)


register_op("causal_attention", torch=_attention_torch,
            kernel=_attention_flash, supported=_attention_supported)


def causal_attention(q, k, v, *, causal: bool = True,
                     scale: Optional[float] = None,
                     dropout_fn: Optional[Callable] = None,
                     mask=None, bias=None, window: Optional[int] = None,
                     alibi_slopes=None):
    """Attention entry used by the model layer.  ``window`` /
    ``alibi_slopes`` assume canonical positions (query t at position t):
    such a call on CUDA tensors runs the flash kernels and raises where
    their ``supported`` rejects it.  A call with ``mask=``, ``bias=`` or
    ``dropout_fn=`` is by definition the plain body on any device (the
    reference never sent those forms to its kernel either)."""
    kw = dict(causal=causal, scale=scale, dropout_fn=dropout_fn, mask=mask,
              bias=bias, window=window, alibi_slopes=alibi_slopes)
    if mask is not None or bias is not None or dropout_fn is not None:
        return _attention_torch(q, k, v, **kw)
    return dispatch("causal_attention", q, k, v, **kw)


register_op("paged_attention", torch=_paged.torch_paged_attention,
            kernel=_paged.cuda_paged_attention, supported=_paged.supported)
register_op("ragged_prefill_attention", torch=_paged.torch_ragged_prefill,
            kernel=_paged.cuda_ragged_prefill,
            supported=_paged.ragged_prefill_supported)

register_op("wq_matmul", torch=_wq.torch_wq_matmul, kernel=_wq.cuda_wq_matmul,
            supported=_wq.supported)
register_op("wq_matmul_t", torch=_wq.torch_wq_matmul_t,
            kernel=_wq.cuda_wq_matmul_t, supported=_wq.supported_t)
register_op("wq_matmul4", torch=_wq.torch_wq_matmul4,
            kernel=_wq.cuda_wq_matmul4, supported=_wq.supported4)
register_op("lora_matmul", torch=_lora.torch_lora_matmul,
            kernel=_lora.cuda_lora_matmul, supported=_lora.lora_supported)


def lora_matmul(x, a_pages, b_pages, adapter_ids, scales):
    """Batched-gather LoRA delta: ``y[i] = (x[i] @ A[id_i]) @ B[id_i] ·
    s[id_i]`` over packed per-slot adapter pages (ops/lora_matmul.py)."""
    return dispatch("lora_matmul", x, a_pages, b_pages, adapter_ids, scales)


register_op("sparse_attention", torch=_sparse.torch_sparse_attention,
            kernel=_sparse.block_sparse_flash,
            supported=_sparse.block_sparse_supported)
register_op("evoformer_attention", torch=_evo.torch_evoformer,
            kernel=_evo._Evoformer.apply, supported=_evo.supported)


__all__ = ["causal_attention", "flash_attention", "lm_cross_entropy",
           "masked_nll_sum", "paged_attention", "ragged_prefill_attention", "rms_norm",
           "wq_any", "wq_matmul_t", "lora_matmul",
           "sparse_attention", "sparsity_ratio", "SparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig",
           "BSLongformerSparsityConfig", "BigBirdSparsityConfig",
           "evoformer_attention",
           "layer_norm", "op_report", "register_op", "dispatch", "registry"]
