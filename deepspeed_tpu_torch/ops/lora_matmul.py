"""Batched-gather LoRA matmul — counterpart of deepspeed_tpu/ops/lora_matmul.py.

A multi-tenant batch carries a per-row adapter slot, and the LoRA delta

    y[i] = (x[i] @ A[id_i]) @ B[id_i] · s[id_i]

is computed for all rows in one op call over the pool's packed per-slot
pages ``a_pages [S, H, r]`` / ``b_pages [S, r, O]``.  Slot 0 is the
base-model identity (zero pages, scale 0), so its rows get an exact zero.
The rounding is the JAX package's (``xla_lora_matmul`` :66): ``u = x·A[id]``
accumulates in fp32 and is cast to x's dtype; ``u·B[id]`` accumulates in
fp32, is scaled by ``s[id]`` in fp32 and cast to x's dtype once.

Two implementations, chosen by the registry (ops/registry.py) from the
device of the tensors:

- plain PyTorch, ``torch_lora_matmul``: gather the pages, two batched fp32
  products — the counterpart of ``xla_lora_matmul``, the CPU path and the
  kernel's reference;
- hand-written CUDA for Hopper, ``cuda_lora_matmul`` (csrc/lora_matmul.cu,
  built by ops/builder.py at first use, bound with ctypes): each slot's
  pages are read for its own rows only.  ``lora_route`` picks the kernel
  pair by rule: 16-bit x with r, O and H multiples of 8, at most 1024
  slots and 16-byte aligned tensors take the tensor-core pair (rows
  segmented by slot on the device, ``wgmma`` shrink and expand, the
  expand a programmatic dependent launch); everything else the CUDA-core
  pair.  The wrapper checks device, dtype, shape and contiguity,
  allocates its output and fp32 scratch with ``torch.empty``, launches on
  the current stream, raises on a non-zero ``cudaError_t`` and counts its
  calls in ``cuda_lora_matmul.launches`` (the counterpart of JAX's
  ``trace_counts["lora"]``).

The ids are a device tensor and are never read on the host (that would
sync): an id outside ``[0, S)`` is a precondition broken by the caller,
and the kernel writes that row as NaN.  The TPU kernel's Mosaic rules
(``_sublane`` padding with id -1, ``_pick``, the ``_preflight`` with its
silent gather fallback) have no counterpart: the kernel takes any M, any H
and O, and ranks up to 256.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
RANK_MAX = 256      # csrc/lora_matmul.cu LORA_RMAX
H_CHUNK = 256       # rows of A a shrink unit walks (LORA_HC)
WGMMA_MAX_SLOTS = 1024   # slots the tensor-core pair counts (kLoraMaxSlots)
SIMT, WGMMA = 0, 1  # the two kernel pairs


def torch_lora_matmul(x, a_pages, b_pages, adapter_ids, scales):
    """Gather reference: ``y[i] = (x[i] @ A[id_i]) @ B[id_i] · s[id_i]``.

    x [M, H], a_pages [S, H, r], b_pages [S, r, O], adapter_ids [M] int,
    scales [S] → [M, O] in ``x.dtype``; fp32 accumulation in both products
    with ``u`` cast through x's dtype between them (JAX :66)."""
    ids = adapter_ids.long()
    a = a_pages[ids].float()                                # [M, H, r]
    b = b_pages[ids].float()                                # [M, r, O]
    u = torch.bmm(x.float()[:, None, :], a)[:, 0]           # [M, r] fp32
    u = u.to(x.dtype).float()
    y = torch.bmm(u[:, None, :], b)[:, 0]                   # [M, O] fp32
    y = y * scales.float()[ids][:, None]
    return y.to(x.dtype)


def _problem(x, a_pages, b_pages, adapter_ids, scales, on_card=True):
    """Why the kernels cannot take this call (None: they can); without
    ``on_card``, the rules on shapes, dtypes and layouts alone."""
    ts = (x, a_pages, b_pages, adapter_ids, scales)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        return "every argument must be a tensor"
    if on_card and x.device.type != "cuda":
        return f"x is on {x.device}, not a CUDA device"
    if on_card and any(t.device != x.device for t in ts):
        return ("x, the pages, the ids and the scales must lie on one "
                f"device (x on {x.device}, ids on {adapter_ids.device})")
    if x.dtype not in _DTYPE_CODE:
        return f"x dtype {x.dtype}: need float32, float16 or bfloat16"
    if a_pages.dtype != x.dtype or b_pages.dtype != x.dtype:
        return (f"pages {a_pages.dtype} / {b_pages.dtype} must have x's "
                f"dtype {x.dtype}")
    if adapter_ids.dtype != torch.int32 or scales.dtype != torch.float32:
        return (f"ids {adapter_ids.dtype} / scales {scales.dtype}: need "
                f"int32 / float32")
    if (x.dim() != 2 or a_pages.dim() != 3 or b_pages.dim() != 3
            or adapter_ids.dim() != 1 or scales.dim() != 1):
        return "layouts: x [M, H], A [S, H, r], B [S, r, O], ids [M], s [S]"
    s, h, r = a_pages.shape
    if (tuple(b_pages.shape[:2]) != (s, r) or x.shape[1] != h
            or adapter_ids.shape[0] != x.shape[0] or scales.shape[0] != s):
        return (f"shapes x {tuple(x.shape)}, A {tuple(a_pages.shape)}, B "
                f"{tuple(b_pages.shape)}, ids {tuple(adapter_ids.shape)}, "
                f"s {tuple(scales.shape)} do not agree")
    if s < 1 or h < 1:
        return "no slots or an empty hidden dim"
    if not 1 <= r <= RANK_MAX:
        return f"rank {r} outside 1..{RANK_MAX}"
    if not all(t.is_contiguous() for t in ts):
        return "every tensor must be contiguous"
    return None


def lora_route(dtype, H: int, r: int, O: int, S: int,
               aligned: bool = True) -> int:
    """The kernel pair a supported call takes, from shapes alone: WGMMA
    for 16-bit x whose H, r and O are multiples of 8 (TMA's 16-byte row
    strides), at most ``WGMMA_MAX_SLOTS`` slots and 16-byte aligned
    tensors; SIMT (the CUDA cores) otherwise."""
    return WGMMA if (dtype in (torch.float16, torch.bfloat16)
                     and H % 8 == 0 and r % 8 == 0 and O % 8 == 0
                     and S <= WGMMA_MAX_SLOTS and aligned) else SIMT


def lora_scratch_shape(M: int, H: int, r: int):
    """The fp32 partial sums both pairs write: [ceil(H / H_CHUNK), M, r]."""
    return (-(-H // H_CHUNK), M, r)


def shape_problem(x, a_pages, b_pages, adapter_ids, scales):
    """Why the kernels cannot take a call with these shapes, dtypes and
    layouts, wherever its tensors lie (None: they can)."""
    return _problem(x, a_pages, b_pages, adapter_ids, scales, on_card=False)


def lora_supported(x, a_pages, b_pages, adapter_ids, scales) -> bool:
    """Kernel eligibility on CUDA tensors (JAX :87 with CUDA rules)."""
    return _problem(x, a_pages, b_pages, adapter_ids, scales) is None


def _lib():
    from deepspeed_tpu_torch.ops.builder import load_op
    lib = load_op("lora_matmul")
    if not getattr(lib, "_ds_declared", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ds_lora_matmul.argtypes = [P] * 7 + [I] * 8 + [P]
        lib.ds_lora_matmul.restype = I
        lib.ds_cuda_error_string.argtypes = [I]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib._ds_declared = True
    return lib


def call_route(x, a_pages, b_pages) -> int:
    """``lora_route`` of a call the kernels take."""
    S, H, r = a_pages.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, a_pages, b_pages))
    return lora_route(x.dtype, H, r, b_pages.shape[2], S, aligned)


def _launch(x, a_pages, b_pages, adapter_ids, scales, pdl: bool = True):
    """The two launches of #9 on the current stream, on the pair
    ``call_route`` picks (the tensor-core expand a programmatic dependent
    of its shrink when ``pdl``); counts nothing."""
    problem = _problem(x, a_pages, b_pages, adapter_ids, scales)
    if problem is not None:
        raise ValueError(f"cuda_lora_matmul: {problem}")
    M, H = x.shape
    S, _, r = a_pages.shape
    O = b_pages.shape[2]
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    if M == 0 or O == 0:
        return y
    part = torch.empty(lora_scratch_shape(M, H, r), dtype=torch.float32,
                       device=x.device)
    lib = _lib()
    P = ctypes.c_void_p
    rc = lib.ds_lora_matmul(
        P(x.data_ptr()), P(a_pages.data_ptr()), P(b_pages.data_ptr()),
        P(adapter_ids.data_ptr()), P(scales.data_ptr()), P(y.data_ptr()),
        P(part.data_ptr()), M, H, r, O, S, _DTYPE_CODE[x.dtype],
        call_route(x, a_pages, b_pages), int(pdl),
        P(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        msg = lib.ds_cuda_error_string(rc).decode()
        raise RuntimeError(f"lora_matmul launch failed: cudaError {rc} "
                           f"({msg})")
    return y


def cuda_lora_matmul(x, a_pages, b_pages, adapter_ids, scales):
    """#9 on the card (csrc/lora_matmul.cu): shrink then expand, two
    launches counted as one call."""
    y = _launch(x, a_pages, b_pages, adapter_ids, scales)
    if x.shape[0] and b_pages.shape[2]:
        with _LAUNCHES:     # exact when several threads launch (the fleet)
            cuda_lora_matmul.launches += 1
    return y


cuda_lora_matmul.launches = 0
_LAUNCHES = threading.Lock()
