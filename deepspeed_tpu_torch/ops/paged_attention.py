"""Paged-KV attention: decode over a block-table page pool, and ragged
chunked prefill — counterpart of deepspeed_tpu/ops/paged_attention.py.

Two implementations of each op, selected by the registry (ops/registry.py)
from the device of the tensors:

- plain PyTorch, ``torch_paged_attention`` / ``torch_ragged_prefill``: the
  counterparts of ``xla_paged_attention`` / ``xla_ragged_prefill`` — gather
  each slot's pages, mask, fp32 softmax, all-masked rows give zeros.  The
  CPU path, the tests' oracle against JAX, and the kernels' reference.
- hand-written CUDA for Hopper, ``cuda_paged_attention`` /
  ``cuda_ragged_prefill`` (csrc/paged_attention.cu, csrc/ragged_prefill.cu,
  built by ops/builder.py at first use and bound with ctypes; 16-bit decode
  runs the warp-specialised bulk-copy + mma.sync kernel that ``decode_plan``
  tiles, fp32 decode the CUDA-core one; the prefill's route is
  ``prefill_route``: 16-bit q at head dims 32 / 64 / 128 with pages of a
  multiple of 16 tokens runs the persistent warp-specialised TMA + wgmma
  kernel (csrc/prefill_hopper.cuh), everything else the CUDA-core one).
  Each wrapper
  checks device, dtype, shape and contiguity, allocates its outputs with
  ``torch.empty``, launches on the current stream, raises on a non-zero
  ``cudaError_t``, and counts its launches in ``<wrapper>.launches``.

Layouts (standard only — the TPU package's kv-major transpose existed for
Mosaic's 128-lane DMA rule and has no counterpart here):
q [S, nkv, g, hd] (decode) or [S, Q, nkv, g, hd] (prefill); k/v pages
[NB, nkv, bs, hd]; block_table [S, MB] int32; kv_lens, q_starts, q_counts
[S] int32.

int8 KV (the engine's ``kv_quant="int8"``): pages hold int8 codes and
``k_scale``/``v_scale`` [NB, nkv, bs] fp32 hold one scale per (page, head,
token).  Both implementations dequantize as the JAX package does — an fp32
product code × scale cast once to q's dtype — the plain versions after the
gather (``_dequant_seq``), the kernels as each page is read.  The JAX
engine's page-size rounding for int8 pages (``kv_block_size_for``: 128-token
pages) is a Mosaic rule applied only where Pallas runs; the port keeps the
configured block size.  int8 launches count in ``<wrapper>.int8_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (32, 64, 128, 256)
_SMEM_OPTIN = 232448       # H100 opt-in shared memory per block (bytes)
_MAX_ROWS = 64             # query-head rows per CUDA-core prefill block
# the tensor-core prefill (csrc/prefill_hopper.cuh): query-head rows a unit,
# and the slots and units its schedule holds (kernel's checks, ds_ragged_prefill)
_PF_ROWS, _PF_MAX_SLOTS, _PF_MAX_UNITS = 128, 1024, 1024
PREFILL_SIMT, PREFILL_WGMMA = 0, 1
# the 16-bit decode kernel (csrc/paged_attention.cu DecLayout): consumer
# warps, ring cap, the bytes before the ring; an SM's shared memory, of which
# each resident block reserves 1 KB
_DEC_WARPS, _DEC_MAX_STAGES, _DEC_HEAD = 4, 8, 512
_DEC_MAX_CHUNKS = 16       # chunks a slot is cut into at most
_SM_SMEM, _SM_RESERVED = 233472, 1024


def _gather_pages(pages, block_table):
    """Each slot's pages in table order → [S, MB*bs, nkv, hd]."""
    got = pages[block_table.long()]               # [S, MB, nkv, bs, hd]
    S, MB, nkv, bs, hd = got.shape
    return got.transpose(2, 3).reshape(S, MB * bs, nkv, hd)


def _check_scales(k_pages, k_scale, v_scale):
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None and v_scale is not None):
        raise ValueError("int8 pages need k_scale and v_scale, and only "
                         "int8 pages take them")


def _gather_seq(pages, scales, block_table, dtype):
    """``_gather_pages``, dequantized when ``scales`` [NB, nkv, bs] is given:
    the int8 codes × each token's scale in fp32, cast once to ``dtype``
    (JAX ``_gather_scales`` + ``_dequant_seq``)."""
    seq = _gather_pages(pages, block_table)
    if scales is None:
        return seq
    sc = scales[block_table.long()]                # [S, MB, nkv, bs]
    S = sc.shape[0]
    sc = sc.transpose(2, 3).reshape(S, -1, sc.shape[2])   # [S, MB*bs, nkv]
    return (seq.float() * sc[..., None]).to(dtype)


def _slopes(alibi_slopes, device):
    return torch.as_tensor(alibi_slopes, dtype=torch.float32,
                           device=device).reshape(-1)


def torch_paged_attention(q, k_pages, v_pages, block_table, kv_lens, *,
                          scale: Optional[float] = None, alibi_slopes=None,
                          window=None, k_scale=None, v_scale=None):
    """Plain decode attention (counterpart of ``xla_paged_attention``): the
    query of slot s sits at position kv_lens[s]-1 and sees keys
    [0, kv_lens[s]) (the last ``window`` of them with a window); alibi adds
    slope[h·g+gi]·kvpos; kv_lens == 0 gives zeros.  int8 pages come with
    ``k_scale``/``v_scale`` and are dequantized after the gather."""
    _check_scales(k_pages, k_scale, v_scale)
    S, nkv, g, hd = q.shape
    bs = k_pages.shape[2]
    MB = block_table.shape[1]
    if scale is None:
        scale = hd ** -0.5
    k_seq = _gather_seq(k_pages, k_scale, block_table, q.dtype)  # [S,K,nkv,hd]
    v_seq = _gather_seq(v_pages, v_scale, block_table, q.dtype)
    kvpos = torch.arange(MB * bs, device=q.device)
    lens = kv_lens.long()
    mask = kvpos[None, :] < lens[:, None]                     # [S, K]
    if window is not None:
        mask = mask & (kvpos[None, :] > lens[:, None] - 1 - window)
    s_log = torch.einsum("sngd,sknd->sngk", q.float(), k_seq.float()) * scale
    if alibi_slopes is not None:
        sl = _slopes(alibi_slopes, q.device).reshape(nkv, g)
        s_log = s_log + sl[None, :, :, None] * kvpos.float()[None, None, None]
    m = mask[:, None, None, :]
    s_log = torch.where(m, s_log, torch.finfo(torch.float32).min)
    probs = torch.softmax(s_log, dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("sngk,sknd->sngd", probs.to(q.dtype), v_seq)


def torch_ragged_prefill(q, k_pages, v_pages, block_table, kv_lens, q_starts,
                         q_counts, *, scale: Optional[float] = None,
                         alibi_slopes=None, window=None, k_scale=None,
                         v_scale=None):
    """Plain ragged prefill (counterpart of ``xla_ragged_prefill``): row j of
    slot s is live iff j < q_counts[s], sits at position q_starts[s]+j and
    sees keys kvpos <= its position, kvpos < kv_lens[s] (and within the
    window); dead rows give zeros.  int8 pages: see torch_paged_attention."""
    _check_scales(k_pages, k_scale, v_scale)
    S, Q, nkv, g, hd = q.shape
    bs = k_pages.shape[2]
    MB = block_table.shape[1]
    if scale is None:
        scale = hd ** -0.5
    k_seq = _gather_seq(k_pages, k_scale, block_table, q.dtype)
    v_seq = _gather_seq(v_pages, v_scale, block_table, q.dtype)
    dev = q.device
    kvpos = torch.arange(MB * bs, device=dev)                  # [K]
    rows = torch.arange(Q, device=dev)
    qpos = q_starts.long()[:, None] + rows[None, :]            # [S, Q]
    live = rows[None, :] < q_counts.long()[:, None]            # [S, Q]
    mask = ((kvpos[None, None, :] <= qpos[:, :, None])
            & (kvpos[None, None, :] < kv_lens.long()[:, None, None])
            & live[:, :, None])                                # [S, Q, K]
    if window is not None:
        mask = mask & (kvpos[None, None, :] > qpos[:, :, None] - window)
    s_log = torch.einsum("sqngd,sknd->snqgk", q.float(), k_seq.float()) * scale
    if alibi_slopes is not None:
        sl = _slopes(alibi_slopes, dev).reshape(nkv, g)
        s_log = s_log + (sl[None, :, None, :, None]
                         * kvpos.float()[None, None, None, None, :])
    m = mask[:, None, :, None, :]                              # [S,1,Q,1,K]
    s_log = torch.where(m, s_log, torch.finfo(torch.float32).min)
    probs = torch.softmax(s_log, dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("snqgk,sknd->sqngd", probs.to(q.dtype), v_seq)


# ------------------------------------------------------------------ kernels


def _lib(name: str):
    """Build-and-load the kernel library once and declare its C interface
    (every pointer and the stream c_void_p, every int c_int)."""
    from deepspeed_tpu_torch.ops.builder import load_op
    lib = load_op(name)
    if not getattr(lib, "_ds_declared", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "paged_attention":
            fn = lib.ds_paged_attention
            fn.argtypes = [P] * 12 + [I] * 9 + [F, I, I, I, P]
        else:
            fn = lib.ds_ragged_prefill
            fn.argtypes = [P] * 14 + [I] * 10 + [F, I, I, I, I, P]
        fn.restype = I
        lib.ds_cuda_error_string.argtypes = [I]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib._ds_declared = True
    return lib


def _check_rc(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.ds_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {rc} ({msg})")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _common_problem(q, k_pages, v_pages, block_table, kv_lens, S, nkv, g, hd,
                    alibi_slopes, window, k_scale, v_scale,
                    ints=(), on_card=True) -> Optional[str]:
    """Why the kernels cannot take this call (None: they can); without
    ``on_card``, the rules on shapes, dtypes and layouts alone."""
    quant = k_pages.dtype == torch.int8
    scales = () if k_scale is None or v_scale is None else (k_scale, v_scale)
    if quant and (v_pages.dtype != torch.int8 or not scales):
        return "int8 pages need int8 v pages and k_scale / v_scale"
    if on_card and q.device.type != "cuda":
        return f"q is on {q.device}, not a CUDA device"
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        return "k/v pages must both be [NB, nkv, bs, hd]"
    for t in (k_pages, v_pages, block_table, kv_lens) + tuple(ints) + scales:
        if on_card and t.device != q.device:
            return f"tensor on {t.device}, q on {q.device}"
    if q.dtype not in _DTYPE_CODE:
        return f"q dtype {q.dtype}: need float32, float16 or bfloat16"
    NB, nkv2, bs, hd2 = k_pages.shape
    if quant:
        for t in scales:
            if t.dtype != torch.float32 or tuple(t.shape) != (NB, nkv2, bs):
                return f"k_scale / v_scale must be float32 [{NB}, {nkv2}, " \
                       f"{bs}] beside int8 pages"
    elif k_scale is not None or v_scale is not None:
        return f"k_scale / v_scale belong to int8 pages, not {k_pages.dtype}"
    elif k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        return f"dtypes q={q.dtype} pages={k_pages.dtype}: pages must be " \
               f"q's dtype, or int8 with scales"
    if nkv2 != nkv or hd2 != hd:
        return f"pages [.., {nkv2}, {bs}, {hd2}] do not match q's nkv={nkv} " \
               f"hd={hd}"
    if hd not in _HEAD_DIMS:
        return f"head_dim {hd} not in {_HEAD_DIMS}"
    if block_table.dim() != 2 or block_table.shape[0] != S:
        return "block_table must be [S, MB]"
    if kv_lens.shape != (S,):
        return "kv_lens must be [S]"
    for t in (block_table, kv_lens) + tuple(ints):
        if t.dtype != torch.int32:
            return f"index tensors must be int32, got {t.dtype}"
    for t in (q, k_pages, v_pages, block_table, kv_lens) + tuple(ints) \
            + scales:
        if not t.is_contiguous():
            return "inputs must be contiguous"
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        return "q and pages must be 16-byte aligned"
    if alibi_slopes is not None and torch.as_tensor(alibi_slopes).numel() \
            != nkv * g:
        return f"alibi_slopes must hold nkv*g={nkv * g} values"
    if window is not None and int(window) <= 0:
        return f"window must be positive, got {window}"
    return None


def _decode_problem(q, k_pages, v_pages, block_table, kv_lens, *, scale=None,
                    alibi_slopes=None, window=None, k_scale=None,
                    v_scale=None):
    if q.dim() != 4:
        return "q must be [S, nkv, g, hd]"
    S, nkv, g, hd = q.shape
    if g > 8:
        return f"query group {g} > 8 (the n8 tile of the query group)"
    problem = _common_problem(q, k_pages, v_pages, block_table, kv_lens, S,
                              nkv, g, hd, alibi_slopes, window, k_scale,
                              v_scale)
    if problem is not None:
        return problem
    bs, esize = k_pages.shape[2], k_pages.element_size()
    if q.dtype == torch.float32:
        smem = 4 * bs * hd * esize + (16 * bs if esize == 1 else 0)
        fits = smem <= _SMEM_OPTIN
    else:
        fits = _decode_stages(S, g, hd, bs, esize, _SMEM_OPTIN) > 0
    if not fits:
        return f"block size {bs} x head_dim {hd} overflows shared memory"
    return None


def _prefill_problem(q, k_pages, v_pages, block_table, kv_lens, q_starts,
                     q_counts, *, scale=None, alibi_slopes=None, window=None,
                     k_scale=None, v_scale=None, on_card=True):
    if q.dim() != 5:
        return "q must be [S, Q, nkv, g, hd]"
    S, Q, nkv, g, hd = q.shape
    if g > _MAX_ROWS:
        return f"query group {g} > {_MAX_ROWS}"
    if q_starts.shape != (S,) or q_counts.shape != (S,):
        return "q_starts and q_counts must be [S]"
    problem = _common_problem(q, k_pages, v_pages, block_table, kv_lens, S,
                              nkv, g, hd, alibi_slopes, window, k_scale,
                              v_scale, ints=(q_starts, q_counts),
                              on_card=on_card)
    if problem is not None:
        return problem
    # the op's page-size limit, kept for both kernels: the CUDA-core
    # kernel's double-buffered K / V slabs (int8: with two dequantized
    # 16-bit tiles beside them, the bound the op has always applied)
    bs, esize = k_pages.shape[2], q.element_size()
    smem = (4 * bs * hd + 16 * bs + 2 * bs * (hd + 8) * esize
            if k_pages.dtype == torch.int8 else 4 * bs * hd * esize)
    if smem > _SMEM_OPTIN:
        return f"block size {bs} x head_dim {hd} overflows shared memory"
    return None


def prefill_shape_problem(*args, **kwargs) -> Optional[str]:
    """Why the prefill kernels cannot take a call with these shapes, dtypes
    and layouts, wherever its tensors lie (None: they can)."""
    return _prefill_problem(*args, on_card=False, **kwargs)


def supported(*args, **kwargs) -> bool:
    """Registry predicate of ``paged_attention``'s kernel."""
    return _decode_problem(*args, **kwargs) is None


def ragged_prefill_supported(*args, **kwargs) -> bool:
    """Registry predicate of ``ragged_prefill_attention``'s kernel."""
    return _prefill_problem(*args, **kwargs) is None


def num_kv_splits_for(S: int, nkv: int, MB: int, device) -> int:
    """fp32 decode: splits per (slot, kv head), enough that a full-width
    slot's split holds about two pages (a block walks its pages one after
    another, so the longest slot's split sets the kernel's time), and at
    least ~4 blocks per SM.  Computed from shapes only — the live lengths
    stay on the device, so choosing never syncs the host; splits a short
    slot does not need exit at once."""
    target = 4 * _sm_count(device.index or 0)
    return max(1, min(max(-(-target // max(1, S * nkv)), -(-MB // 2)), MB,
                      64))


def decode_smem(S: int, g: int, hd: int, bs: int, esize: int,
                stages: int) -> int:
    """Shared memory of one 16-bit decode block (csrc DecLayout): the ring
    of (page, head) slabs of K and V (pages of ``esize`` bytes an element,
    rows rounded up to 16), the slot's q rows and, for int8 pages, the K
    and V scale rows a stage; each consumer warp's merge state and weights;
    the slots' chunk prefix and lengths."""
    bsp = -(-bs // 16) * 16
    slab = bsp * hd * esize
    stage = 2 * slab + g * hd * 2 + (8 * bsp if esize == 1 else 0)
    stage = -(-stage // 128) * 128
    return (_DEC_HEAD + stages * stage + _DEC_WARPS * g * (hd + 2) * 4
            + (_DEC_WARPS + 1) * g * 4 + (2 * S + 1) * 4)


def _decode_stages(S, g, hd, bs, esize, budget) -> int:
    """The deepest ring (at most 8 stages) within ``budget`` bytes, 0 if not
    even one stage fits."""
    best = 0
    for stages in range(1, _DEC_MAX_STAGES + 1):
        if decode_smem(S, g, hd, bs, esize, stages) <= budget:
            best = stages
    return best


@functools.lru_cache(maxsize=None)
def decode_plan(S: int, nkv: int, g: int, hd: int, bs: int, esize: int,
                sms: int) -> dict:
    """The 16-bit decode launch, from shapes alone (choosing never syncs the
    host): a persistent grid of ``blocks``, two an SM where a ring of at
    least two stages lets them share it (else one, with the deepest ring
    that fits; head dim 256 always one, for its registers), ``stages`` and
    ``smem``, and ``chunk``, the fewest pages a work item holds (256 keys).
    On the device each slot's live pages are cut into chunks of at least
    ``chunk`` pages, at most 16 of them, and the blocks take (chunk, kv
    head) items one at a time.  Cached: every decode call of a serving
    step asks for the same plan (callers must not mutate the dict)."""
    for per_sm in (1,) if hd == 256 else (2, 1):
        budget = min(_SMEM_OPTIN, _SM_SMEM // per_sm - _SM_RESERVED)
        stages = _decode_stages(S, g, hd, bs, esize, budget)
        if stages >= (2 if per_sm == 2 else 1):
            break
    if stages == 0:
        raise ValueError(f"decode_plan: block size {bs} x head_dim {hd} "
                         f"overflows shared memory")
    return {"blocks": per_sm * sms, "stages": stages, "per_sm": per_sm,
            "chunk": -(-256 // bs),
            "smem": decode_smem(S, g, hd, bs, esize, stages)}


# The two int32 counters of the 16-bit decode and the tensor-core prefill, by
# (device, stream): the work items handed out and the blocks done.  Zero
# between launches (the last block out resets them), so one buffer serves
# every call of either kernel on its stream
_COUNTERS = {}
# the launch counts are read-modify-write from every thread that launches
# (the serving fleet's replica workers): one lock keeps them exact
_LAUNCHES = threading.Lock()


def _counters(device):
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def cuda_paged_attention(q, k_pages, v_pages, block_table, kv_lens, *,
                         scale: Optional[float] = None, alibi_slopes=None,
                         window=None, k_scale=None, v_scale=None):
    """Paged decode on the card (csrc/paged_attention.cu).  16-bit q: the
    tensor-core kernel tiled by ``decode_plan`` (a persistent grid takes
    (chunk, kv head) items from a device counter), then a small kernel that
    merges the chunks of each long slot in chunk order.
    fp32 q: the CUDA-core kernel; a one-column table runs it in one pass, a
    wider one splits each slot's pages ``num_kv_splits_for`` ways and
    merges the splits in a second kernel."""
    problem = _decode_problem(q, k_pages, v_pages, block_table, kv_lens,
                              alibi_slopes=alibi_slopes, window=window,
                              k_scale=k_scale, v_scale=v_scale)
    if problem is not None:
        raise ValueError(f"cuda_paged_attention: {problem}")
    S, nkv, g, hd = q.shape
    bs, MB = k_pages.shape[2], block_table.shape[1]
    if scale is None:
        scale = hd ** -0.5
    out = torch.empty_like(q)
    part_acc = part_ml = counters = None
    f32 = dict(dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        ns, stages, chunk = num_kv_splits_for(S, nkv, MB, q.device), 0, 0
        if ns > 1:
            part_acc = torch.empty((S, nkv, ns, g, hd), **f32)
            part_ml = torch.empty((S, nkv, ns, g, 2), **f32)
    else:
        plan = decode_plan(S, nkv, g, hd, bs, k_pages.element_size(),
                           _sm_count(q.device.index or 0))
        ns, stages, chunk = plan["blocks"], plan["stages"], plan["chunk"]
        part_acc = torch.empty((nkv, S, _DEC_MAX_CHUNKS, g, hd), **f32)
        part_ml = torch.empty((nkv, S, _DEC_MAX_CHUNKS, g, 2), **f32)
        counters = _counters(q.device)
    slopes = None if alibi_slopes is None else _slopes(alibi_slopes, q.device)
    lib = _lib("paged_attention")
    quant = k_scale is not None
    rc = lib.ds_paged_attention(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(block_table), _ptr(kv_lens), _ptr(slopes), _ptr(out),
        _ptr(part_acc), _ptr(part_ml), _ptr(counters), S, nkv, g, hd, bs, MB,
        ns, stages, chunk, float(scale), int(window or 0), _DTYPE_CODE[q.dtype],
        int(quant),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _check_rc(lib, rc, "paged_attention")
    with _LAUNCHES:
        if quant:
            cuda_paged_attention.int8_launches += 1
        else:
            cuda_paged_attention.launches += 1
    return out


cuda_paged_attention.launches = 0
cuda_paged_attention.int8_launches = 0


def prefill_chunk(g: int) -> int:
    """Query tokens per CUDA-core prefill block: cq·g query-head rows fill
    (at most) one 64-row tile — 16 tokens × 4 heads for Llama-3-8B."""
    return max(1, _MAX_ROWS // g)


def prefill_route(dtype, S: int, Q: int, g: int, hd: int, bs: int,
                  aligned: bool = True) -> int:
    """The kernel a supported prefill call takes, from shapes alone:
    PREFILL_WGMMA for 16-bit q at head dims 32 / 64 / 128 with pages of a
    multiple of 16 tokens up to 256, at most 1024 slots and 1024 units of
    128 / g tokens, and 16-byte aligned int8 scales (``aligned``);
    PREFILL_SIMT (the CUDA cores) for fp32 q, head dim 256 and other
    pages."""
    units = S * -(-Q // max(1, _PF_ROWS // g))
    return PREFILL_WGMMA if (
        dtype in (torch.float16, torch.bfloat16) and hd in (32, 64, 128)
        and bs % 16 == 0 and bs <= 256 and S <= _PF_MAX_SLOTS
        and units <= _PF_MAX_UNITS and aligned) else PREFILL_SIMT


def prefill_scratch(hd: int, sms: int):
    """The tensor-core prefill's persistent grid (one block an SM) and the
    shapes of its fp32 partials for split walks: a split unit's chunks
    hold at least the fair share of the work a block, so all of them fill
    at most 2 x grid (chunk, kv head) slots of [128 rows, hd] and [128
    rows, (m, l)]."""
    return sms, (2 * sms, _PF_ROWS, hd), (2 * sms, _PF_ROWS, 2)


def cuda_ragged_prefill(q, k_pages, v_pages, block_table, kv_lens, q_starts,
                        q_counts, *, scale: Optional[float] = None,
                        alibi_slopes=None, window=None, k_scale=None,
                        v_scale=None):
    """Ragged chunked prefill on the card (csrc/ragged_prefill.cu), on the
    kernel ``prefill_route`` picks; the tensor-core kernel with the fp32
    partials ``prefill_scratch`` sizes and its combine kernel."""
    problem = _prefill_problem(q, k_pages, v_pages, block_table, kv_lens,
                               q_starts, q_counts,
                               alibi_slopes=alibi_slopes, window=window,
                               k_scale=k_scale, v_scale=v_scale)
    if problem is not None:
        raise ValueError(f"cuda_ragged_prefill: {problem}")
    S, Q, nkv, g, hd = q.shape
    NB, bs, MB = k_pages.shape[0], k_pages.shape[2], block_table.shape[1]
    if scale is None:
        scale = hd ** -0.5
    out = torch.empty_like(q)
    slopes = None if alibi_slopes is None else _slopes(alibi_slopes, q.device)
    quant = k_scale is not None
    route = prefill_route(q.dtype, S, Q, g, hd, bs, aligned=not quant or all(
        t.data_ptr() % 16 == 0 for t in (k_scale, v_scale)))
    part_acc = part_ml = counters = None
    grid = 0
    if route == PREFILL_WGMMA:
        grid, acc_shape, ml_shape = prefill_scratch(
            hd, _sm_count(q.device.index or 0))
        part_acc = torch.empty(acc_shape, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(ml_shape, dtype=torch.float32, device=q.device)
        counters = _counters(q.device)
    lib = _lib("ragged_prefill")
    rc = lib.ds_ragged_prefill(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(block_table), _ptr(kv_lens), _ptr(q_starts), _ptr(q_counts),
        _ptr(slopes), _ptr(out), _ptr(part_acc), _ptr(part_ml),
        _ptr(counters), S, Q, nkv, g,
        hd, bs, MB, NB, prefill_chunk(g), grid, float(scale),
        int(window or 0), _DTYPE_CODE[q.dtype], int(quant), route,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _check_rc(lib, rc, "ragged_prefill")
    with _LAUNCHES:
        if quant:
            cuda_ragged_prefill.int8_launches += 1
        else:
            cuda_ragged_prefill.launches += 1
    return out


cuda_ragged_prefill.launches = 0
cuda_ragged_prefill.int8_launches = 0


def paged_attention(q, k_pages, v_pages, block_table, kv_lens, *,
                    scale: Optional[float] = None, alibi_slopes=None,
                    window=None, k_scale=None, v_scale=None):
    """Registry entry: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (raising where the kernel does not support the call)."""
    from deepspeed_tpu_torch.ops.registry import dispatch
    return dispatch("paged_attention", q, k_pages, v_pages, block_table,
                    kv_lens, scale=scale, alibi_slopes=alibi_slopes,
                    window=window, k_scale=k_scale, v_scale=v_scale)


def ragged_prefill_attention(q, k_pages, v_pages, block_table, kv_lens,
                             q_starts, q_counts, *,
                             scale: Optional[float] = None,
                             alibi_slopes=None, window=None, k_scale=None,
                             v_scale=None):
    """Registry entry for the ragged prefill op."""
    from deepspeed_tpu_torch.ops.registry import dispatch
    return dispatch("ragged_prefill_attention", q, k_pages, v_pages,
                    block_table, kv_lens, q_starts, q_counts, scale=scale,
                    alibi_slopes=alibi_slopes, window=window,
                    k_scale=k_scale, v_scale=v_scale)
