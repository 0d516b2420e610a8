"""LM cross-entropy — chunked softmax over the vocabulary with a
fused-gradient fast path (counterpart of deepspeed_tpu/ops/cross_entropy.py).

The fp32 [B·T, V] logits of a GPT-2-scale vocabulary dominate activation
memory, so the loss walks the tokens in chunks and peak logits memory is
O(chunk × V) whatever B·T is.  Two chunked strategies:

- checkpointed (``fused=False``): each chunk's loss under
  ``torch.utils.checkpoint`` — backward recomputes the chunk's logits.
- **fused** (default): a ``torch.autograd.Function`` whose forward computes
  the loss AND both gradients chunk by chunk — ``softmax − onehot`` never
  leaves the chunk: ``gx = dlogits @ Wᵀ`` and ``dW += xᵀ @ dlogits`` are
  accumulated on the spot and backward only scales by the upstream
  cotangent.  The reference has no kernel here (it left the products to
  XLA), so ``torch.matmul`` inside is the port.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_loss(x, w, labels, mask, bias=None):
    """Sum NLL over one flat chunk.  x [C, H], w [H, V], labels/mask [C]."""
    logits = (x @ w).float()
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[:, None])[:, 0]
    return ((lse - ll) * mask).sum()


def masked_nll_sum(x, unembed, labels, mask, bias=None):
    """Sum of masked token NLLs of ``x @ unembed`` (no mean) — for callers
    that aggregate their own denominator.  x [..., H]; labels/mask [...]."""
    h = x.shape[-1]
    return _chunk_loss(x.reshape(-1, h), unembed,
                       labels.reshape(-1).long(),
                       mask.reshape(-1).float(), bias)


class _FusedNLLSum(torch.autograd.Function):
    """Sum NLL over pre-chunked tokens (xc [num, c, H]) with the gradients
    of x, w and bias computed in the forward chunk loop.  Under ``no_grad``
    (or when no input needs a gradient) only the loss is computed and
    nothing is kept."""

    @staticmethod
    def forward(ctx, xc, w, lc, mc, bias, need):
        num = xc.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=xc.device)
        gx = torch.empty_like(xc) if need else None
        dw = (torch.zeros(w.shape, dtype=torch.float32, device=w.device)
              if need else None)
        dbias = (torch.zeros(bias.shape, dtype=torch.float32,
                             device=bias.device)
                 if need and bias is not None else None)
        for i in range(num):
            xi, li, mi = xc[i], lc[i], mc[i]
            logits = (xi @ w).float()
            if bias is not None:
                logits = logits + bias.float()
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, li[:, None])[:, 0]
            total = total + ((lse - ll) * mi).sum()
            if not need:
                continue
            # dlogits of the masked NLL sum: (softmax - onehot) * mask,
            # made in place in the chunk's logits buffer
            p = logits.sub_(lse[:, None]).exp_()
            p.scatter_add_(-1, li[:, None], -torch.ones_like(lse)[:, None])
            p.mul_(mi[:, None])
            pb = p.to(w.dtype)
            gx[i] = pb @ w.t()
            dw += (xi.t() @ pb).float()
            if dbias is not None:
                dbias += p.sum(0)
        if need:
            ctx.save_for_backward(
                gx, dw.to(w.dtype),
                dbias.to(bias.dtype) if dbias is not None else None)
        return total

    @staticmethod
    def backward(ctx, g):
        gx, dw, dbias = ctx.saved_tensors
        return (gx * g.to(gx.dtype), g.to(dw.dtype) * dw, None, None,
                g.to(dbias.dtype) * dbias if dbias is not None else None,
                None)


def lm_cross_entropy(x, unembed, labels, mask,
                     chunk_size: Optional[int] = 512, bias=None,
                     fused: bool = True):
    """Mean masked cross entropy of ``x @ unembed (+ bias)`` against
    ``labels``.

    x [B, T, H] hidden states; unembed [H, V]; labels/mask [B, T]; bias
    optional [V].  ``chunk_size=None`` computes the loss in one shot (the
    ground-truth path).  ``fused`` picks the in-forward-gradient chunk loop
    over the checkpointed one (same numerics, one fewer unembed product).
    """
    b, t, h = x.shape
    n = b * t
    xf = x.reshape(n, h)
    lf = labels.reshape(n).long()
    mf = mask.reshape(n).float()
    denom = mf.sum().clamp_min(1.0)

    if not chunk_size or chunk_size >= n:
        return _chunk_loss(xf, unembed, lf, mf, bias) / denom

    c = int(chunk_size)
    pad = (-n) % c
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad))
        mf = F.pad(mf, (0, pad))             # padded tokens carry mask 0
    num = xf.shape[0] // c
    xc, lc, mc = xf.reshape(num, c, h), lf.reshape(num, c), mf.reshape(num, c)

    if fused:
        # a Function's forward always runs with grad mode off, so whether
        # the gradients are wanted is decided here
        need = torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (xc, unembed, bias))
        return _FusedNLLSum.apply(xc, unembed, lc, mc, bias, need) / denom

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num):
        total = total + checkpoint(_chunk_loss, xc[i], unembed, lc[i], mc[i],
                                   bias, use_reentrant=False)
    return total / denom
