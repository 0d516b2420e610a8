"""Quantized-weight matmuls — counterpart of deepspeed_tpu/ops/wq_matmul.py.

    y[M, N] = x[M, K] @ (codes[K, N] · scales[K/g, N])        wq_matmul
    y[M, V] = x[M, H] @ (codes[V, H] · scales[V/g, H])ᵀ       wq_matmul_t
    y[M, N] = x[M, K] @ (unpack(bytes[K/2, N]) · scales[K/g, N])  wq_matmul4

The weight stays quantized in device memory; dequantization is an fp32
product ``code × scale`` cast once to x's dtype, followed by an
fp32-accumulated product and one cast of the output to x's dtype (JAX
wq_matmul.py:239-243).

Two implementations of each, chosen by the registry (ops/registry.py) from
the device of the tensors:

- plain PyTorch, ``torch_wq_matmul`` / ``torch_wq_matmul_t`` /
  ``torch_wq_matmul4``: dequantize the whole store, then ``x @ w`` — the
  counterparts of the JAX fallbacks (:320, :366, :415), the CPU path and the
  kernels' reference.
- hand-written CUDA for Hopper, ``cuda_wq_matmul`` / ``cuda_wq_matmul_t`` /
  ``cuda_wq_matmul4`` (csrc/wq_matmul.cu, built by ops/builder.py at first
  use, bound with ctypes; 16-bit x runs #7 / #8 on a warp-specialised
  wgmma kernel, #6 on a persistent one computing the swapped product
  y^T = W x^T; ``wq_plan`` picks split-K and the ring depth from shapes
  alone).  Each checks device, dtype, shape and
  contiguity, allocates its output with ``torch.empty``, launches on the
  current stream, raises on a non-zero ``cudaError_t`` and counts its
  launches in ``<wrapper>.launches`` (the counterpart of JAX's
  ``trace_counts``).

The JAX package's Mosaic tile rules and their silent dequantize fallbacks
(``kernel_supported``, ``_preflight``) have no counterpart: every 2-D store
the serving model routes here goes to the kernel on CUDA tensors, and a
store the kernel cannot take raises.  The kernels take every group the
engine packs: a power of two of at least 16 dividing the grouped dimension
(a K step holds whole groups, or lies inside one) — the JAX kernel's
groups (W8 g % 32, W4 g % 64) and 16 besides.
Tensor-parallel ``wq_matmul_tp`` is not ported (ROADMAP A.8).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.quantization import (dequantize_weight,
                                                  dequantize_weight4,
                                                  is_quantized_weight,
                                                  is_quantized_weight4)

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_W8, _W8T, _W4 = 0, 1, 2


def torch_wq_matmul(x, store):
    """``x [M, K] @ dequantize_weight(store [K, N])``."""
    return x @ dequantize_weight(store, x.dtype)


def torch_wq_matmul_t(x, store):
    """``x [M, H] @ dequantize_weight(store [V, H]).T`` — the tied unembed."""
    return x @ dequantize_weight(store, x.dtype).t()


def torch_wq_matmul4(x, store):
    """``x [M, K] @ dequantize_weight4(store {"v4": [K/2, N]})``."""
    return x @ dequantize_weight4(store, x.dtype)


def wq_any(x, store):
    """A 2-D store to its op: nibble-packed -> wq_matmul4, int8 ->
    wq_matmul."""
    from deepspeed_tpu_torch.ops.registry import dispatch
    if is_quantized_weight4(store):
        return dispatch("wq_matmul4", x, store)
    return dispatch("wq_matmul", x, store)


def wq_matmul_t(x, store):
    """Registry entry of the transposed (tied-unembed) product."""
    from deepspeed_tpu_torch.ops.registry import dispatch
    return dispatch("wq_matmul_t", x, store)


def store_as_2d(store):
    """A free (view) 2-D form of a 3-D store whose flattened layout keeps
    uniform dim-0 grouping, or None (JAX wq_matmul.py:467):

    - grouped along dim 0 (q/k/v [H, heads, hd]): the trailing dims flatten
      into N;
    - grouped along dim 1 (attention out [heads, hd, H], g | hd): the
      leading two flatten into K — flat row r = head·hd + d has scale row
      r // g = head·(hd/g) + d//g exactly because g divides hd.

    Packed stores only take the dim-0 case."""
    if is_quantized_weight(store):
        v, s = store["v"], store["s"]
        if v.dim() != 3:
            return None
        if s.shape[1:] == v.shape[1:]:
            return {"v": v.reshape(v.shape[0], -1),
                    "s": s.reshape(s.shape[0], -1)}
        if (s.shape[0] == v.shape[0] and s.shape[2:] == v.shape[2:]
                and v.shape[1] % s.shape[1] == 0):
            return {"v": v.reshape(-1, v.shape[2]),
                    "s": s.reshape(-1, s.shape[2])}
        return None
    if is_quantized_weight4(store):
        p, s = store["v4"], store["s"]
        if p.dim() != 3 or s.shape[1:] != p.shape[1:]:
            return None
        return {"v4": p.reshape(p.shape[0], -1),
                "s": s.reshape(s.shape[0], -1)}
    return None


# ------------------------------------------------------------------ kernels


def _lib():
    from deepspeed_tpu_torch.ops.builder import load_op
    lib = load_op("wq_matmul")
    if not getattr(lib, "_ds_declared", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ds_wq_matmul.argtypes = [P] * 5 + [I] * 9 + [P]
        lib.ds_wq_matmul.restype = I
        lib.ds_cuda_error_string.argtypes = [I]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib._ds_declared = True
    return lib


def _problem(x, store, mode) -> Optional[str]:
    """Why the kernel of ``mode`` cannot take this call (None: it can)."""
    key = "v4" if mode == _W4 else "v"
    if not isinstance(store, dict) or set(store) != {key, "s"}:
        return f"store must be a {{{key!r}, 's'}} dict"
    v, s = store[key], store["s"]
    if x.device.type != "cuda":
        return f"x is on {x.device}, not a CUDA device"
    if v.device != x.device or s.device != x.device:
        return f"store on {v.device}/{s.device}, x on {x.device}"
    if x.dtype not in _DTYPE_CODE:
        return f"x dtype {x.dtype}: need float32, float16 or bfloat16"
    if v.dtype != torch.int8 or s.dtype != torch.float32:
        return f"codes {v.dtype} / scales {s.dtype}: need int8 / float32"
    if x.dim() != 2 or v.dim() != 2 or s.dim() != 2:
        return "x and the store must be 2-D (see store_as_2d)"
    # the grouped dim is the codes' dim 0: V for the tied table, else K
    k = v.shape[1] if mode == _W8T else v.shape[0] * (2 if mode == _W4 else 1)
    grouped = v.shape[0] if mode == _W8T else k
    rows = s.shape[0]
    if x.shape[1] != k:
        return f"x [{x.shape[0]}, {x.shape[1]}] does not contract with a " \
               f"store of contraction dim {k}"
    if s.shape[1] != v.shape[1] or rows == 0 or grouped % rows:
        return f"scales {tuple(s.shape)} are not a dim-0 grouping of " \
               f"codes {tuple(v.shape)}"
    g = grouped // rows
    if g < 16 or g & (g - 1):
        return f"group {g} is not a power of two of at least 16"
    if k % 16:
        return f"contraction dim {k} is not a multiple of 16"
    for t in (x, v, s):
        if not t.is_contiguous():
            return "x and the store must be contiguous"
    if x.data_ptr() % 16:
        return "x must be 16-byte aligned"
    return None


def _supported(mode):
    def supported(x, store) -> bool:
        return _problem(x, store, mode) is None
    return supported


# the kernels' tiles (csrc/wq_matmul.cu): modes 0 / 2's wgmma block (128
# columns over up to 256 rows), K stage and the bytes of a stage besides its
# x tile (B tile, codes, scale rows); mode 1's (128 rows of V; its stage
# besides the x tile: A tile, codes, scale rows; the epilogue's y rows)
_WG_BM, _WG_BN, _WG_BK = 256, 128, 64
_WG_FIXED = _WG_BN * 128 + _WG_BK * _WG_BN + (_WG_BK // 16) * _WG_BN * 4
_WG_MAX_STAGES = 8
SMEM_PER_BLOCK = 232448           # the H100's 227 KB a block (opt-in)
# besides the stages: the wgmma kernel's mbarriers and its 1024-byte
# alignment slack
_WG_EXTRA = 3 * _WG_MAX_STAGES * 8 + 1024
# mode 1: a stage's dequantized A tile, codes and scale rows (besides its x
# tile), and the epilogue's row pitch
_WT_BN = 128
_WT_FIXED = _WT_BN * 128 + _WG_BK * _WT_BN + (_WT_BN // 16) * _WG_BK * 4
_WT_YPITCH = _WT_BN + 8


def wt_rows(M: int) -> int:
    """Rows of x a mode-1 block takes (its wgmma n): M rounded up to 16,
    32, 64 or 128 (csrc wt_np)."""
    return next(n for n in (16, 32, 64, 128) if M <= n or n == 128)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wq_plan(M: int, N: int, K: int, mode: int, dtype, sms: int) -> dict:
    """The launch of one product, from shapes alone (choosing never syncs
    the host): ``splits`` (split-K: blocks a tile, each owning ``per``
    consecutive ``kt``-deep K steps) and, for the wgmma kernels (16-bit x),
    their ring depth ``stages`` and dynamic shared memory ``smem``.  The
    splits fill the card's ``sms`` SMs, one block an SM (its ring takes
    most of the shared memory); mode 1's blocks are persistent, so its
    tiles may outnumber the SMs."""
    if dtype == torch.float32:
        return {"splits": 1, "per": 0, "kt": 0, "stages": 0, "smem": 0}
    if mode == _W8T:
        np_ = wt_rows(M)
        fixed = _WG_EXTRA + np_ * _WT_YPITCH * 2
        stage = np_ * 128 + _WT_FIXED
        stages = min(_WG_MAX_STAGES, (SMEM_PER_BLOCK - fixed) // stage)
        smem = stages * stage + fixed
        tiles, kt, blocks = -(-N // _WT_BN) * -(-M // np_), _WG_BK, sms
    else:
        xrows = min(_WG_BM, -(-M // 64) * 64)
        stage = xrows * 128 + _WG_FIXED
        stages = min(_WG_MAX_STAGES, (SMEM_PER_BLOCK - _WG_EXTRA) // stage)
        smem = stages * stage + _WG_EXTRA
        tiles, kt, blocks = -(-N // _WG_BN) * -(-M // _WG_BM), _WG_BK, sms
    steps = -(-K // kt)
    want = max(1, min(steps, blocks // tiles))
    per = -(-steps // want)
    return {"splits": -(-steps // per), "per": per, "kt": kt,
            "stages": stages, "smem": smem}


def _launch(x, store, mode, name):
    problem = _problem(x, store, mode)
    if problem is not None:
        raise ValueError(f"cuda_{name}: {problem}")
    key = "v4" if mode == _W4 else "v"
    v, s = store[key], store["s"]
    M = x.shape[0]
    if mode == _W8T:
        N, K = v.shape
        g = N // s.shape[0]
    else:
        K, N = x.shape[1], v.shape[1]
        g = K // s.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y, False
    # 16-byte cp.async rows need 16-byte aligned code and scale rows; other
    # layouts take the kernel's element-wise loads
    row_bytes = K if mode == _W8T else N
    aligned = int(row_bytes % 16 == 0 and v.data_ptr() % 16 == 0
                  and s.data_ptr() % 16 == 0)
    plan = wq_plan(M, N, K, mode, x.dtype, _sm_count(x.device.index or 0))
    splits = plan["splits"]
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib = _lib()
    rc = lib.ds_wq_matmul(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(v.data_ptr()),
        ctypes.c_void_p(s.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        None if part is None else ctypes.c_void_p(part.data_ptr()),
        M, N, K, g, mode, aligned, splits, plan["stages"],
        _DTYPE_CODE[x.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        msg = lib.ds_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")
    return y, True


def cuda_wq_matmul(x, store):
    """#7 on the card (csrc/wq_matmul.cu; 16-bit x: the wgmma kernel):
    int8 store [K, N]."""
    y, launched = _launch(x, store, _W8, "wq_matmul")
    cuda_wq_matmul.launches += int(launched)
    return y


def cuda_wq_matmul_t(x, store):
    """#6 on the card: int8 store [V, H], y = x @ wᵀ."""
    y, launched = _launch(x, store, _W8T, "wq_matmul_t")
    cuda_wq_matmul_t.launches += int(launched)
    return y


def cuda_wq_matmul4(x, store):
    """#8 on the card (16-bit x: the wgmma kernel): nibble-packed store
    {"v4": [K/2, N]}."""
    y, launched = _launch(x, store, _W4, "wq_matmul4")
    cuda_wq_matmul4.launches += int(launched)
    return y


cuda_wq_matmul.launches = 0
cuda_wq_matmul_t.launches = 0
cuda_wq_matmul4.launches = 0

supported = _supported(_W8)
supported_t = _supported(_W8T)
supported4 = _supported(_W4)
