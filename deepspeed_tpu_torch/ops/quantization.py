"""Group-wise weight stores for quantized serving — the weight-store half
of deepspeed_tpu/ops/quantization.py, in PyTorch.

A store is a plain dict, as in the JAX package, so a packed tree mirrors
the JAX one leaf for leaf:

- ``{"v": int8 codes, "s": fp32 scales}`` (``quantize_weight``): codes keep
  the weight's shape; scales have the grouped dim divided by the group.
- ``{"v4": int8 bytes, "s": fp32 scales}`` (``quantize_weight4``): dim-0
  pairs of 4-bit codes packed into one byte (low nibble = even row, high
  nibble = odd row); scales group along dim 0.

Every formula is the JAX package's, operation for operation, so codes are
bit-equal to it: ``quantize_weight`` multiplies by
``inv = where(s > 0, 1/max(s, 1e-30), 0)`` and rounds half to even;
dequantization is an fp32 product cast once to the target dtype.
"""

from __future__ import annotations

import torch


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Fold int8 values in [-7, 7] pairwise along dim 0 into bytes: low
    nibble = even index, high = odd."""
    lo = q[0::2].to(torch.int32) & 0x0F
    hi = (q[1::2].to(torch.int32) & 0x0F) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_nibbles(p: torch.Tensor):
    """Inverse of ``pack_nibbles``: (lo, hi) sign-extended int8 halves."""
    b = p.to(torch.int32)
    return ((b << 28) >> 28).to(torch.int8), (b >> 4).to(torch.int8)


def weight_group_size(shape, group: int, min_group: int = 16) -> int:
    """Effective group along a dim of size ``shape[0]``: the largest power
    of two dividing it that is <= ``group``; 0 (do not quantize) if even
    ``min_group`` does not divide it."""
    if not shape:
        return 0
    g = 1
    while g * 2 <= group and shape[0] % (g * 2) == 0:
        g *= 2
    return g if g >= min_group else 0


def quantize_weight(w: torch.Tensor, *, bits: int = 8, group: int = 128,
                    dim: int = 0):
    """Shape-preserving group-wise symmetric quantization: w ->
    {"v": int8 of w's shape, "s": fp32 with shape[dim] -> shape[dim]/g}."""
    g = weight_group_size((w.shape[dim],), group)
    if g == 0:
        raise ValueError(f"dim {dim} of {tuple(w.shape)} has no usable "
                         f"group <= {group}")
    qmax = float(2 ** (bits - 1) - 1)
    wm = torch.movedim(w, dim, 0)
    d0 = wm.shape[0]
    wf = wm.float().reshape((d0 // g, g) + tuple(wm.shape[1:]))
    s = wf.abs().amax(dim=1) / qmax
    inv = torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-30),
                      torch.zeros_like(s))
    q = torch.clamp(torch.round(wf * inv[:, None]), -qmax, qmax)
    return {"v": torch.movedim(q.reshape(wm.shape).to(torch.int8), 0,
                               dim).contiguous(),
            "s": torch.movedim(s, 0, dim).contiguous()}


def _store_dim(d) -> int:
    """The grouped dim of a store: where codes and scales disagree."""
    for i, (a, b) in enumerate(zip(d["v"].shape, d["s"].shape)):
        if a != b:
            return i
    return 0


def dequantize_weight(d, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_weight``: fp32 code x scale, cast once."""
    dim = _store_dim(d)
    vm = torch.movedim(d["v"], dim, 0)
    sm = torch.movedim(d["s"], dim, 0)
    g = vm.shape[0] // sm.shape[0]
    wf = vm.float().reshape((sm.shape[0], g) + tuple(vm.shape[1:]))
    return torch.movedim((wf * sm[:, None]).reshape(vm.shape), 0,
                         dim).to(dtype)


def is_quantized_weight(leaf) -> bool:
    return (isinstance(leaf, dict) and set(leaf) == {"v", "s"}
            and getattr(leaf["v"], "dtype", None) == torch.int8)


def quantize_weight4(w: torch.Tensor, *, group: int = 128):
    """Nibble-packed 4-bit store: {"v4": int8 [d0/2, *rest], "s": fp32
    [d0/g, *rest]} — dim-0 pairs share a byte."""
    if w.shape[0] % 2:
        raise ValueError(f"dim 0 of {tuple(w.shape)} is odd — nibble "
                         f"packing folds row pairs")
    q = quantize_weight(w, bits=4, group=group)
    return {"v4": pack_nibbles(q["v"]), "s": q["s"]}


def is_quantized_weight4(leaf) -> bool:
    return (isinstance(leaf, dict) and set(leaf) == {"v4", "s"}
            and getattr(leaf["v4"], "dtype", None) == torch.int8)


def quantized_codes(leaf):
    """The codes tensor of a store leaf (``v`` or packed ``v4``), or None
    when ``leaf`` is not a store."""
    if is_quantized_weight(leaf):
        return leaf["v"]
    if is_quantized_weight4(leaf):
        return leaf["v4"]
    return None


def dequantize_weight4(d, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_weight4``."""
    p = d["v4"]
    lo, hi = unpack_nibbles(p)
    q = torch.stack([lo, hi], dim=1).reshape((2 * p.shape[0],)
                                             + tuple(p.shape[1:]))
    return dequantize_weight({"v": q, "s": d["s"]}, dtype)


def store_nbytes(tree) -> int:
    """Bytes of every tensor in a (possibly packed) parameter tree."""
    if isinstance(tree, dict):
        return sum(store_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
