"""Flash attention for training — counterpart of
deepspeed_tpu/ops/flash_attention.py.

Public layout is the model's [B, T, N, D] (k/v [B, T, Nkv, D], GQA by
``kv head = q head // group``); the logsumexp comes back as contiguous fp32
[B, N, T] viewed [B, N, 1, T], the layout the ring-attention code reads.
Positions are canonical (query t sits at position t); ``window`` and
``alibi_slopes`` need ``causal=True``, as in the reference.

Two implementations, chosen by the device of the tensors:

- plain PyTorch, ``torch_flash_fwd`` / ``torch_flash_bwd``: the kernels'
  formulas without tiles (fp32 scores masked to -1e30, probabilities cast to
  the value dtype before ``p @ v``, ``ds`` cast before its two products,
  dk/dv summed over the GQA group).  The CPU path and the kernels'
  reference.
- hand-written CUDA for Hopper, ``cuda_flash_fwd`` / ``cuda_flash_dq`` /
  ``cuda_flash_dkv`` (csrc/flash_attention.cu, built by ops/builder.py at
  first use, bound with ctypes; the 16-bit forward is the warp-specialised
  TMA + wgmma kernel of csrc/attn_fwd_hopper.cuh, tiled by
  ``flash_fwd_plan``, the fp32 one a CUDA-core kernel; dq and dk/dv run on
  mma.sync).  Each wrapper checks its inputs, allocates
  its outputs with ``torch.empty``, launches on the current stream, raises
  on a non-zero ``cudaError_t`` and counts its launches in
  ``<wrapper>.launches``.

``flash_attention`` is the differentiable entry (a
``torch.autograd.Function`` saving q, k, v, o, lse); on CUDA tensors it
launches the kernels or raises, on CPU tensors it uses the plain versions.
The TPU package's block-size tables and their environment override are the
TPU's and have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30     # finite "minus infinity" of the kernels
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the widest head_dim the kernels take (csrc/flash_attention.cu pads a
# head_dim up to 64, 96, 128, 192 or 256)
MAX_HEAD_DIM = 256
# shared memory a block may use on the H100 (227 KB, opt-in)
SMEM_LIMIT = 232448
# the forward's deepest ring: csrc/attn_fwd_hopper.cuh kFwdMaxStages, which
# also sizes the mbarrier block at the head of its shared memory
_FWD_MAX_STAGES = 8


def _slopes(alibi_slopes, n_heads: int, device):
    return torch.as_tensor(alibi_slopes, dtype=torch.float32,
                           device=device).reshape(n_heads)


def _visible(t: int, causal: bool, window, device):
    """[T, T] bool: may query row see key column."""
    qpos = torch.arange(t, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    ok = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (qpos >= kpos)
    if window is not None:
        ok = ok & (kpos > qpos - int(window))
    return ok


def _scores(q, k, scale, ok, alibi_slopes):
    """fp32 scores [B, Nkv, g, T, T], -1e30 where ``ok`` [T, T] is False."""
    b, t, n, d = q.shape
    nkv = k.shape[2]
    s = torch.einsum("btkgd,bskd->bkgts",
                     q.reshape(b, t, nkv, n // nkv, d).float(),
                     k.float()) * scale
    if alibi_slopes is not None:
        sl = _slopes(alibi_slopes, n, q.device).reshape(nkv, n // nkv)
        s = s + sl[None, :, :, None, None] * torch.arange(
            t, dtype=torch.float32, device=q.device)
    return torch.where(ok, s, NEG_INF)


def masked_fwd(q, k, v, ok, scale, alibi_slopes=None):
    """The forward kernels' formula without tiles, for any [T, T] visibility
    mask ``ok`` → (o [B, T, N, D], lse fp32 [B, N, 1, T]); a row that sees
    no key gives o = 0 and lse = -1e30."""
    b, t, n, d = q.shape
    s = _scores(q, k, scale, ok, alibi_slopes)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bkgts,bskd->btkgd", (p / l).to(v.dtype), v)
    lse = (m + torch.log(l)).reshape(b, n, 1, t)
    return o.reshape(b, t, n, d), lse.contiguous()


def masked_bwd(q, k, v, o, lse, do, ok, scale, alibi_slopes=None):
    """The backward kernels' formula without tiles, from the saved
    logsumexp → (dq, dk, dv); dk/dv summed over the GQA group."""
    b, t, n, d = q.shape
    nkv = k.shape[2]
    g = n // nkv
    s = _scores(q, k, scale, ok, alibi_slopes)
    lse_r = lse.reshape(b, nkv, g, t, 1)
    p = torch.where(ok & (lse_r > NEG_INF / 2), torch.exp(s - lse_r), 0.0)
    delta = (o.float() * do.float()).sum(-1)             # [B, T, N]
    delta = delta.permute(0, 2, 1).reshape(b, nkv, g, t, 1)
    do_g = do.reshape(b, t, nkv, g, d)
    dp = torch.einsum("btkgd,bskd->bkgts", do_g.float(), v.float())
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bkgts,btkgd->bskd", p.to(do.dtype).float(),
                      do_g.float())
    dq = torch.einsum("bkgts,bskd->btkgd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bkgts,btkgd->bskd", ds.to(q.dtype).float(),
                      q.reshape(b, t, nkv, g, d).float())
    return (dq.reshape(b, t, n, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def torch_flash_fwd(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, window=None,
                    alibi_slopes=None):
    """Plain forward → (o [B, T, N, D], lse fp32 [B, N, 1, T])."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return masked_fwd(q, k, v, _visible(q.shape[1], causal, window, q.device),
                      scale, alibi_slopes)


def torch_flash_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                    scale: Optional[float] = None, window=None,
                    alibi_slopes=None):
    """Plain backward from the saved logsumexp → (dq, dk, dv)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return masked_bwd(q, k, v, o, lse, do,
                      _visible(q.shape[1], causal, window, q.device), scale,
                      alibi_slopes)


# ------------------------------------------------------------------ kernels


def fwd_plan(hd_k: int, bn: int, stage_extra: int = 0) -> dict:
    """Shared memory of the 16-bit attention forward (csrc/attn_fwd_hopper.cuh
    FwdLayout, the same formula) for compiled head dim ``hd_k`` and ``bn``
    keys a stage, ``stage_extra`` bytes a stage beside K and V: Q slots of
    [128 rows, hdp] and a ring of stages, hdp = hd_k padded to 64 (TMA
    boxes of 64 16-bit columns).  Two Q slots (the next unit's Q loads
    while this one runs) where a ring of 2 still fits beside them, else
    one; then as many stages as fit, at most ``_FWD_MAX_STAGES``."""
    hdp = -(-hd_k // 64) * 64
    q_bytes = 128 * hdp * 2
    stage = -(-(2 * bn * hdp * 2 + stage_extra) // 1024) * 1024
    fixed = (4 + 4 * _FWD_MAX_STAGES) * 8 + 1024  # mbarriers, alignment slack
    fits = {qslots: min(_FWD_MAX_STAGES,
                        (SMEM_LIMIT - fixed - qslots * q_bytes) // stage)
            for qslots in (2, 1)}
    qslots = 2 if fits[2] >= 2 else 1
    stages = fits[qslots]
    if stages < 2:
        raise ValueError(f"no forward plan fits {SMEM_LIMIT} bytes at "
                         f"head dim {hd_k}, {bn} keys a stage")
    return dict(hd_k=hd_k, hdp=hdp, bn=bn, qslots=qslots, stages=stages,
                stage_bytes=stage,
                smem=fixed + qslots * q_bytes + stages * stage)


def flash_fwd_plan(d: int) -> dict:
    """The 16-bit forward's tiles for head_dim ``d``: compiled width hd_k
    (64, 96, 128, 192 or 256; the pad is TMA's zero fill), 128 queries a
    unit, ``bn`` keys a tile (128 up to hd_k 128, 64 above, where the
    fp32 O accumulator takes 128 registers a thread), Q slots, ring depth
    and shared-memory bytes (``fwd_plan``)."""
    hd_k = next(w for w in (64, 96, 128, 192, 256) if d <= w)
    return fwd_plan(hd_k, 128 if hd_k <= 128 else 64)


def head_dim_problem(d: int) -> Optional[str]:
    """Why the kernels cannot take head_dim ``d`` (None: they can)."""
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        return f"head_dim {d}: the kernels take multiples of 8 from 8 to " \
               f"{MAX_HEAD_DIM} (ROADMAP C.1)"
    return None


def shape_problem(q, k, v, *, causal=True, window=None,
                  alibi_slopes=None) -> Optional[str]:
    """The kernels' rules on shapes, dtypes, strides and options, without
    looking at the device (None: they take the call)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        return "q must be [B, T, N, D] and k, v both [B, T, Nkv, D]"
    b, t, n, d = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        return f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} " \
               f"(equal batch, sequence length and head_dim needed)"
    if b < 1 or t < 1 or b > 65535 or 2 * n > 65535:
        return f"batch {b} / heads {n} / length {t} outside the grid's range"
    if k.shape[2] < 1 or n % k.shape[2] != 0:
        return f"kv heads {k.shape[2]} must divide q heads {n}"
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: need one of " \
               f"float32/float16/bfloat16 for all three"
    problem = head_dim_problem(d)
    if problem is not None:
        return problem
    # the 16-bit forward reads q, k, v by TMA, which takes a 16-byte-aligned
    # base and strides that are multiples of 16 bytes; the other kernels
    # load 16-byte rows
    per16 = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % per16 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            return f"{name}: head_dim must be contiguous and every other " \
                   f"stride and the base 16-byte aligned (TMA's rule: " \
                   f"strides {tuple(x.stride())}, base offset " \
                   f"{x.data_ptr() % 16} bytes)"
    if window is not None and (not causal or int(window) <= 0):
        return f"window={window} needs causal=True and a positive width"
    if alibi_slopes is not None and (
            not causal or torch.as_tensor(alibi_slopes).numel() != n):
        return f"alibi_slopes needs causal=True and {n} values"
    return None


def _problem(q, k, v, *, causal=True, scale=None, window=None,
             alibi_slopes=None) -> Optional[str]:
    """Why the kernels cannot take this call (None: they can)."""
    problem = shape_problem(q, k, v, causal=causal, window=window,
                            alibi_slopes=alibi_slopes)
    if problem is not None:
        return problem
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        return f"q, k, v must share one CUDA device (q on {q.device})"
    return None


def supported(q, k, v, *, causal=True, scale=None, window=None,
              alibi_slopes=None, **_) -> bool:
    """What the kernels take: fp32/fp16/bf16 q [B, T, N, D] and k, v
    [B, T, Nkv, D] on one CUDA device with head_dim a multiple of 8 from 8
    to 256 (run zero-padded to 64, 96, 128, 192 or 256) contiguous
    and 16-byte-aligned rows, any GQA group that divides N, any T (the tail
    is masked); causal or not; window and alibi with causal only."""
    return _problem(q, k, v, causal=causal, window=window,
                    alibi_slopes=alibi_slopes) is None


def _lib():
    """Build-and-load the kernel library once and declare its C interface."""
    from deepspeed_tpu_torch.ops.builder import load_op
    lib = load_op("flash_attention")
    if not getattr(lib, "_ds_declared", False):
        P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
        tail = [I] * 5 + [L] * 9 + [F, I, I, I, P]
        lib.ds_flash_fwd.argtypes = [P] * 6 + tail[:-2] + [I, I] + tail[-2:]
        lib.ds_flash_fwd.restype = I
        lib.ds_flash_bwd.argtypes = [I] + [P] * 10 + tail
        lib.ds_flash_bwd.restype = I
        lib.ds_cuda_error_string.argtypes = [I]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib._ds_declared = True
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _tail(q, k, v, scale, causal, window):
    b, t, n, d = q.shape
    return ([b, t, n, k.shape[2], d]
            + [x.stride(i) for x in (q, k, v) for i in (0, 1, 2)]
            + [float(scale), int(bool(causal)), int(window or 0),
               _DTYPE_CODE[q.dtype],
               ctypes.c_void_p(torch.cuda.current_stream(q.device)
                               .cuda_stream)])


def _check_rc(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.ds_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {rc} ({msg})")


def _prepare(name, q, k, v, causal, scale, window, alibi_slopes):
    problem = _problem(q, k, v, causal=causal, window=window,
                       alibi_slopes=alibi_slopes)
    if problem is not None:
        raise ValueError(f"{name}: {problem}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    slopes = (None if alibi_slopes is None
              else _slopes(alibi_slopes, q.shape[2], q.device))
    return scale, slopes


def cuda_flash_fwd(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None, window=None,
                   alibi_slopes=None):
    """Forward on the card → (o [B, T, N, D], lse fp32 [B, N, 1, T])."""
    scale, slopes = _prepare("cuda_flash_fwd", q, k, v, causal, scale,
                             window, alibi_slopes)
    b, t, n, d = q.shape
    o = torch.empty((b, t, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    plan = flash_fwd_plan(d)
    tail = _tail(q, k, v, scale, causal, window)
    lib = _lib()
    rc = lib.ds_flash_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(slopes), _ptr(o),
                          _ptr(lse), *tail[:-2], plan["stages"],
                          plan["qslots"], *tail[-2:])
    _check_rc(lib, rc, "flash_fwd")
    cuda_flash_fwd.launches += 1
    return o, lse.view(b, n, 1, t)


cuda_flash_fwd.launches = 0


def _bwd_inputs(name, q, o, lse, do):
    b, t, n, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: do must match q in shape, dtype, device")
    if lse.dtype != torch.float32 or lse.numel() != b * n * t:
        raise ValueError(f"{name}: lse must be fp32 [B, N, 1, T]")
    do = do.contiguous()
    # delta = rowsum(o * do) in fp32, outside the kernels as in the reference
    delta = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    return do, lse.contiguous(), delta


def _launch_bwd(which, name, q, k, v, do, lse, delta, slopes, dq, dk, dv,
                scale, causal, window):
    lib = _lib()
    rc = lib.ds_flash_bwd(which, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
                          _ptr(lse), _ptr(delta), _ptr(slopes), _ptr(dq),
                          _ptr(dk), _ptr(dv),
                          *_tail(q, k, v, scale, causal, window))
    _check_rc(lib, rc, name)


def cuda_flash_dq(q, k, v, o, lse, do, *, causal: bool = True,
                  scale: Optional[float] = None, window=None,
                  alibi_slopes=None, delta=None):
    """dq on the card.  ``delta`` [B, N, T] fp32 may be passed by a caller
    that already ran ``_bwd_inputs`` (the autograd Function shares its
    result between dq and dk/dv); ``do`` and ``lse`` are then taken as
    returned by it."""
    scale, slopes = _prepare("cuda_flash_dq", q, k, v, causal, scale, window,
                             alibi_slopes)
    if delta is None:
        do, lse, delta = _bwd_inputs("cuda_flash_dq", q, o, lse, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(1, "flash_dq", q, k, v, do, lse, delta, slopes, dq, None,
                None, scale, causal, window)
    cuda_flash_dq.launches += 1
    return dq


cuda_flash_dq.launches = 0


def cuda_flash_dkv(q, k, v, o, lse, do, *, causal: bool = True,
                   scale: Optional[float] = None, window=None,
                   alibi_slopes=None, delta=None):
    """dk, dv on the card, summed over the GQA group without atomics."""
    scale, slopes = _prepare("cuda_flash_dkv", q, k, v, causal, scale,
                             window, alibi_slopes)
    if delta is None:
        do, lse, delta = _bwd_inputs("cuda_flash_dkv", q, o, lse, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(2, "flash_dkv", q, k, v, do, lse, delta, slopes, None, dk,
                dv, scale, causal, window)
    cuda_flash_dkv.launches += 1
    return dk, dv


cuda_flash_dkv.launches = 0


class _Flash(torch.autograd.Function):
    """o = flash(q, k, v); saves (q, k, v, o, lse).  CUDA tensors go
    through the three kernels, CPU tensors through the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, alibi_slopes):
        kw = dict(causal=causal, scale=scale, window=window,
                  alibi_slopes=alibi_slopes)
        fwd = cuda_flash_fwd if q.device.type == "cuda" else torch_flash_fwd
        o, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type != "cuda":
            dq, dk, dv = torch_flash_bwd(q, k, v, o, lse, do, **ctx.kw)
        else:
            do, lse, delta = _bwd_inputs("flash_attention", q, o, lse, do)
            dq = cuda_flash_dq(q, k, v, o, lse, do, delta=delta, **ctx.kw)
            dk, dv = cuda_flash_dkv(q, k, v, o, lse, do, delta=delta,
                                    **ctx.kw)
        return dq, dk, dv, None, None, None, None    # slopes: no gradient


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, window=None,
                    alibi_slopes=None):
    """Differentiable flash attention over [B, T, N, D] (same layout out).
    On CUDA tensors an unsupported call raises (see ``supported``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, bool(causal), float(scale),
                        None if window is None else int(window),
                        alibi_slopes)
