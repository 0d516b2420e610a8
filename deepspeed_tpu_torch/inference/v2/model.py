"""Ragged GPT forward over a paged KV cache — counterpart of
deepspeed_tpu/inference/v2/model.py, in PyTorch.

Works directly on the GPTLogits parameter tree (models/gpt.py naming:
backbone/block_i/{Attention_0,MLP_0,Norm_0,Norm_1}, wte/wpe/final_norm,
top-level lm_head) with the JAX tree's weight layouts — wq [H, nh, hd],
wk/wv [H, nkv, hd], wo [nh, hd, H], MLP wi/wg [H, F], wo [F, H], wte [V, H],
lm_head [H, V] — so the weight bridge (models/gpt.params_from_numpy) is a
plain copy.  Products are ``torch.matmul``, as the JAX package left them to
XLA; attention goes through the ops registry (ops/paged_attention.py): the
hand-written CUDA kernels for CUDA tensors, the plain versions on the CPU.

Quantized serving (the engine's ``quant`` block): a weight leaf may be a
store (ops/quantization.py, ``{"v", "s"}`` int8 or ``{"v4", "s"}``
nibble-packed).  The routing is the JAX model's: every 2-D store (and the
free 2-D views of the q/k/v and attention-out stores) goes to the
quantized-weight matmul ops (ops/wq_matmul.py: the CUDA kernels on the
card), the tied unembed to ``wq_matmul_t``; whatever the JAX model
dequantizes at its use site (``_w``) is dequantized here too.  int8 KV
(``kv_quant="int8"``): K/V are quantized per token as they are written
(``quantize_kv_token``) and the attention ops read int8 pages with their
scale pools.

Multi-tenant LoRA (the engine's ``adapters`` block): a batch that carries
a ``lora`` key (the pool's layer-major tables, serving/adapters.py) and an
``adapter_slot`` [S] selection gets a per-row delta on q and v from the
batched-gather op (ops/lora_matmul.py) after the projections, before rope
(``_lora_qv``).  A batch without the key runs exactly the base model's
code: an adapter-less engine passes none.

Where the JAX code relies on buffer donation, this one updates in place:
the KV pool is ONE preallocated tensor, every layer writes its new K/V
through views of it, and each layer's attention gets the contiguous slice
``flat[li*NB:(li+1)*NB]`` — never a copy.  JAX's ``mode="drop"`` scatters
have no torch counterpart, so pad rows are routed to a sink instead: the
pool carries one extra page past the last layer (index L*NB) and the dense
query/count buffers one extra slot (index S), which pad rows write and
nothing ever reads.  Pads are never clamped onto slot 0 (duplicate scatter
indices would corrupt real rows).
"""

from __future__ import annotations

import functools

import torch

from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.models.gpt import (GPTConfig, alibi_slopes,
                                            mlp_activation, rope)
from deepspeed_tpu_torch.ops.norms import LN_EPS, RMS_EPS
from deepspeed_tpu_torch.ops.quantization import (_store_dim,
                                                  dequantize_weight,
                                                  dequantize_weight4,
                                                  is_quantized_weight,
                                                  is_quantized_weight4,
                                                  quantized_codes,
                                                  unpack_nibbles)
from deepspeed_tpu_torch.ops.wq_matmul import store_as_2d


def quantize_kv_token(x):
    """Per-token symmetric int8: x [..., hd] -> (codes int8 [..., hd],
    scales fp32 [...]) with amax-over-head-dim granularity (JAX
    model.py:31, formula for formula)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    return torch.round(xf / s[..., None]).to(torch.int8), s


class PagedKVCache:
    """Paged KV pool (reference KVCacheManager kv_cache.py), standard layout
    [L, num_blocks, nkv, block_size, head_dim] in the compute dtype (so no
    per-layer cast copies it).  Stored flat as [L*num_blocks + 1, nkv, bs,
    hd]: the extra last page is the sink that pad rows write.

    ``quant="int8"``: the pages hold int8 codes and ``k_scale_flat`` /
    ``v_scale_flat`` [L*num_blocks + 1, nkv, bs] fp32 hold each token's
    scale, sink page included."""

    def __init__(self, k_flat: torch.Tensor, v_flat: torch.Tensor,
                 num_layers: int, num_blocks: int, k_scale_flat=None,
                 v_scale_flat=None):
        self.k_flat = k_flat
        self.v_flat = v_flat
        self.k_scale_flat = k_scale_flat
        self.v_scale_flat = v_scale_flat
        self.num_layers = num_layers
        self.num_blocks = num_blocks

    @classmethod
    def create(cls, cfg: GPTConfig, num_blocks: int, block_size: int, dtype,
               device, quant=None):
        shape = (cfg.num_layers * num_blocks + 1, cfg.kv_heads, block_size,
                 cfg.head_dim)
        if quant is None:
            return cls(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       cfg.num_layers, num_blocks)
        if quant != "int8":
            raise ValueError(f"unsupported kv_quant {quant!r}; use 'int8'")
        zeros = functools.partial(torch.zeros, device=device)
        return cls(zeros(shape, dtype=torch.int8),
                   zeros(shape, dtype=torch.int8), cfg.num_layers,
                   num_blocks, zeros(shape[:3], dtype=torch.float32),
                   zeros(shape[:3], dtype=torch.float32))

    @property
    def quantized(self) -> bool:
        return self.k_scale_flat is not None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k_flat, self.v_flat, self.k_scale_flat,
                             self.v_scale_flat) if t is not None)

    @property
    def sink(self) -> int:
        return self.num_layers * self.num_blocks

    @property
    def k(self) -> torch.Tensor:
        """[L, NB, nkv, bs, hd] view (no sink page)."""
        return self.k_flat[:self.sink].view(
            (self.num_layers, self.num_blocks) + self.k_flat.shape[1:])

    def layer(self, li: int):
        """Layer ``li``'s [NB, nkv, bs, hd] K and V pools — contiguous slices
        of the one pool tensor, handed to the kernels as they are."""
        lo, hi = li * self.num_blocks, (li + 1) * self.num_blocks
        return self.k_flat[lo:hi], self.v_flat[lo:hi]

    def layer_scales(self, li: int):
        """The attention ops' ``k_scale``/``v_scale`` keywords of layer
        ``li`` ([NB, nkv, bs] slices), or none for 16-bit pages."""
        if not self.quantized:
            return {}
        lo, hi = li * self.num_blocks, (li + 1) * self.num_blocks
        return {"k_scale": self.k_scale_flat[lo:hi],
                "v_scale": self.v_scale_flat[lo:hi]}


def _norm(p, x, cfg):
    if cfg.use_rmsnorm:
        return ops.rms_norm(x, p["scale"], eps=cfg.norm_eps or RMS_EPS)
    return ops.layer_norm(x, p["scale"], p["bias"],
                          eps=cfg.norm_eps or LN_EPS)


def _w(p, dtype):
    """Weight accessor: a store dequantized at its use site (the
    full-precision tensor exists only inside the layer that consumes it),
    or the plain tensor in ``dtype``."""
    if is_quantized_weight(p):
        return dequantize_weight(p, dtype)
    if is_quantized_weight4(p):
        return dequantize_weight4(p, dtype)
    return p.to(dtype)


def _wmm(x, p, dtype):
    """``x @ W``: a 2-D store goes to the quantized-weight matmul op with
    x's leading dims flattened; anything else is dequantized at its use
    site (JAX model.py:164)."""
    vv = quantized_codes(p) if isinstance(p, dict) else None
    if vv is not None and vv.dim() == 2:
        lead = x.shape[:-1]
        y = ops.wq_any(x.reshape(-1, x.shape[-1]).to(dtype), p)
        return y.reshape(lead + (vv.shape[1],))
    return x.to(dtype) @ _w(p, dtype)


def _mlp(p, x, cfg):
    dtype = x.dtype
    h = _wmm(x, p["wi"], dtype)
    if cfg.mlp_bias:
        h = h + p["bi"]
    if cfg.gated_mlp:
        h = mlp_activation(cfg.gate_act)(_wmm(x, p["wg"], dtype)) * h
    else:
        h = mlp_activation(cfg.activation)(h)
    y = _wmm(h, p["wo"], dtype)
    if cfg.mlp_bias:
        y = y + p["bo"]
    return y


def _block_residual(blk, x, h, attn_delta, cfg):
    """Close out one block: sequential (x+attn, then MLP on a fresh norm) or
    falcon/phi parallel residual — shared by the prefill and decode loops."""
    if cfg.parallel_block:
        h_mlp = _norm(blk["Norm_1"], x, cfg) if cfg.parallel_norms == 2 else h
        return x + attn_delta + _mlp(blk["MLP_0"], h_mlp, cfg)
    x = x + attn_delta
    return x + _mlp(blk["MLP_0"], _norm(blk["Norm_1"], x, cfg), cfg)


def _embed(wte, tokens, dtype):
    """Row gather from a possibly quantized table: the gathered rows' codes
    and their group scales only (JAX model.py:221)."""
    t = tokens.long()
    if is_quantized_weight(wte):
        v, s = wte["v"], wte["s"]
        if _store_dim(wte) != 0:
            raise ValueError(
                "embedding stores must group along dim 0 (vocab) — the row "
                f"gather needs per-row scales; got codes {tuple(v.shape)} "
                f"vs scales {tuple(s.shape)}")
        g = v.shape[0] // s.shape[0]
        return (v[t].float() * s[t // g]).to(dtype)
    if is_quantized_weight4(wte):
        # byte r // 2 holds row r in nibble r % 2
        p, s = wte["v4"], wte["s"]
        lo, hi = unpack_nibbles(p[t // 2])
        q = torch.where((t % 2 == 0)[..., None], lo, hi)
        g = 2 * p.shape[0] // s.shape[0]
        return (q.float() * s[t // g]).to(dtype)
    return wte.to(dtype)[t]


def _embed_in(bb, tokens, token_pos, cfg):
    x = _embed(bb["wte"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype, device=x.device)
    if cfg.embed_norm:
        x = _norm(bb["embed_norm"], x, cfg)
    if not cfg.use_rope and not cfg.use_alibi:
        x = x + bb["wpe"][token_pos.long()]
    return x


def _proj3(x, p, dtype):
    """``x [..., H] @ W [H, k, d] → [..., k, d]``; a dim-0-grouped 3-D
    store goes to the matmul op through its free 2-D view (JAX
    model.py:267)."""
    vv = quantized_codes(p) if isinstance(p, dict) else None
    if vv is not None and vv.dim() == 3:
        v2d = store_as_2d(p)
        if v2d is not None and p["s"].shape[1:] == vv.shape[1:]:
            y = _wmm(x, v2d, dtype)
            return y.reshape(y.shape[:-1] + vv.shape[1:])
    lead = x.shape[:-1]
    w = _w(p, dtype)
    y = x.to(dtype).reshape(-1, x.shape[-1]) @ w.reshape(w.shape[0], -1)
    return y.reshape(lead + w.shape[1:])


def _qkv(ap, h, cfg):
    dtype = h.dtype
    q = _proj3(h, ap["wq"], dtype)
    k = _proj3(h, ap["wk"], dtype)
    v = _proj3(h, ap["wv"], dtype)
    if cfg.qkv_bias:
        q = q + ap["bq"]
        k = k + ap["bk"]
        v = v + ap["bv"]
    return q, k, v


def _lora_qv(q, v, h, lora, row_ids, li):
    """Per-row LoRA deltas on the q and v projections of layer ``li``
    (JAX model.py:289): every row carries its own adapter slot and the
    whole mixed-adapter batch rides ONE op call per projection.  ``lora``
    holds the pool's layer-major tables (``a_q``/``b_q``/``a_v``/``b_v``
    [L, slots, ...] + per-slot fp32 ``scale``), so ``lora[k][li]`` is a
    contiguous view; slot 0 is the identity (zero pages, scale 0).
    Applied pre-rope, in the engine dtype."""
    h2 = h.reshape(-1, h.shape[-1])
    scale = lora["scale"]
    dq = ops.lora_matmul(h2, lora["a_q"][li], lora["b_q"][li], row_ids,
                         scale)
    dv = ops.lora_matmul(h2, lora["a_v"][li], lora["b_v"][li], row_ids,
                         scale)
    return q + dq.reshape(q.shape), v + dv.reshape(v.shape)


def _attn_out(ap, o, cfg):
    """``o [..., nh, hd] @ wo [nh, hd, H]``; a dim-1-grouped store goes to
    the matmul op through its [nh·hd, H] view, any other store is
    dequantized at the use site (JAX model.py:326)."""
    dtype = o.dtype
    p = ap["wo"]
    lead = o.shape[:-2]
    o2 = o.reshape(lead + (o.shape[-2] * o.shape[-1],))
    vv = quantized_codes(p) if isinstance(p, dict) else None
    if vv is not None:
        v2d = store_as_2d(p) if vv.dim() == 3 else None
        if (v2d is not None
                and quantized_codes(v2d).shape[0] == o2.shape[-1]):
            y = _wmm(o2, v2d, dtype)
        else:
            y = o2 @ _w(p, dtype).reshape(-1, vv.shape[-1])
    else:
        y = o2 @ p.reshape(-1, p.shape[-1])
    if cfg.attn_out_bias:
        y = y + ap["bo"]
    return y


def _logits_out(params, bb, x, cfg):
    """Final unembed (tied or untied) + optional bias, fp32 logits.  A
    quantized tied table goes to ``wq_matmul_t``; a vocabulary padded to the
    quantization group is sliced back to ``vocab_size`` (JAX
    model.py:190)."""
    dtype = x.dtype
    if cfg.tie_embeddings:
        wte = bb["wte"]
        if is_quantized_weight(wte):
            lead = x.shape[:-1]
            y = ops.wq_matmul_t(x.reshape(-1, x.shape[-1]), wte)
            logits = y.reshape(lead + (y.shape[-1],)).float()
        else:
            logits = (x @ _w(wte, dtype).t()).float()
        if logits.shape[-1] != cfg.vocab_size:
            logits = logits[..., :cfg.vocab_size]
    else:
        logits = _wmm(x, params["lm_head"], dtype).float()
    if cfg.unembed_bias:
        logits = logits + params["lm_head_bias"].float()
    return logits


@functools.lru_cache(maxsize=None)
def _alibi(n_heads: int, head_dim: int, prescale: bool, device: str):
    return torch.as_tensor(alibi_slopes(n_heads, head_dim, prescale),
                           dtype=torch.float32, device=device)


def _slopes(cfg, device):
    if not cfg.use_alibi:
        return None
    return _alibi(cfg.num_heads, cfg.head_dim, cfg.alibi_prescale,
                  str(device))


def _write_kv(cache: PagedKVCache, dest, off, k, v):
    """Paged KV append (reference linear_blocked_kv_rotary): row i of k/v
    [N, nkv, hd] lands at flat page dest[i], token offset off[i].  The mixed
    advanced index puts the indexed dim first, [N, nkv, hd], as in JAX.  An
    int8 pool stores each token's codes and its [N, nkv] scales."""
    if cache.quantized:
        k, ks = quantize_kv_token(k)
        v, vs = quantize_kv_token(v)
        cache.k_scale_flat[dest, :, off] = ks
        cache.v_scale_flat[dest, :, off] = vs
    cache.k_flat[dest, :, off] = k.to(cache.k_flat.dtype)
    cache.v_flat[dest, :, off] = v.to(cache.v_flat.dtype)


def ragged_forward(params, cache: PagedKVCache, batch, cfg: GPTConfig, *,
                   block_size: int, max_q_per_seq: int, logits: bool = True):
    """One ragged step (mixed prefill chunks + decodes).

    batch: dict of device tensors mirroring ragged.RaggedBatch fields
    (tokens, token_slot, token_pos, token_dense_idx [N]; block_table [S, MB]
    int32; kv_len [S] int32; with adapters also ``lora`` tables and
    ``adapter_slot`` [S] int32).  Returns (logits [S, vocab] fp32 — each
    slot's last-token logits, the cache, updated in place).  ``logits=False``
    only writes the KV (a draft model's lockstep ingestion, whose logits
    the JAX program never computes either: XLA drops unused outputs) and
    returns None for them."""
    bb = params["backbone"]
    tokens = batch["tokens"]
    token_slot = batch["token_slot"]           # [N] (-1 pad)
    token_pos = batch["token_pos"]
    dense_idx = batch["token_dense_idx"].long()
    block_table = batch["block_table"]         # [S, MB] int32
    kv_len = batch["kv_len"]                   # [S] int32
    dev = tokens.device
    N = tokens.shape[0]
    S = block_table.shape[0]
    Q = max_q_per_seq
    valid = token_slot >= 0
    slot0 = token_slot.clamp(min=0).long()     # gather index only

    x = _embed_in(bb, tokens, token_pos, cfg)

    # scatter destinations; pads go to the sink slot S / sink page
    blk_idx = (token_pos // block_size).long()
    page = block_table[slot0, blk_idx].long()
    off = (token_pos % block_size).long()
    scat_slot = torch.where(valid, token_slot, S).long()
    ones = torch.ones(N, dtype=torch.int32, device=dev)
    q_counts = torch.zeros(S + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, scat_slot, ones)[:S]
    q_starts = kv_len - q_counts

    NB = cache.num_blocks
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    g = nh // nkv
    slopes = _slopes(cfg, dev)
    seq_lens = kv_len[slot0][None]
    # per-TOKEN adapter slot through each token's sequence slot; pad rows
    # take the identity slot 0 (computed on the device, no sync)
    lora = batch.get("lora")
    if lora is not None:
        lora_ids = torch.where(valid, batch["adapter_slot"][slot0],
                               0).to(torch.int32)
    for li in range(cfg.num_layers):
        blk = bb[f"block_{li}"]
        ap = blk["Attention_0"]
        h = _norm(blk["Norm_0"], x, cfg)
        q, k, v = _qkv(ap, h, cfg)
        if lora is not None:
            q, v = _lora_qv(q, v, h, lora, lora_ids, li)
        if cfg.use_rope:
            q, k = rope(q[None], k[None], token_pos[None], hd,
                        base=cfg.rope_theta, rope_pct=cfg.rope_pct,
                        scaling=cfg.rope_scaling, seq_lens=seq_lens)
            q, k = q[0], k[0]
        dest = torch.where(valid, li * NB + page, cache.sink)
        _write_kv(cache, dest, off, k, v)

        # ragged blocked attention over dense-per-slot query rows
        q_dense = torch.zeros((S + 1, Q, nh, hd), dtype=q.dtype, device=dev)
        q_dense[scat_slot, dense_idx] = q
        k_pool, v_pool = cache.layer(li)
        o_dense = ops.ragged_prefill_attention(
            q_dense[:S].reshape(S, Q, nkv, g, hd), k_pool, v_pool,
            block_table, kv_len, q_starts, q_counts, scale=cfg.attn_scale,
            alibi_slopes=slopes, window=cfg.window_for_layer(li),
            **cache.layer_scales(li)).reshape(S, Q, nh, hd)
        o = o_dense[slot0, dense_idx]                        # [N, nh, hd]
        o = torch.where(valid[:, None, None], o, 0)
        x = _block_residual(blk, x, h, _attn_out(ap, o, cfg), cfg)

    if not logits:
        return None, cache
    x = _norm(bb["final_norm"], x, cfg)
    # logits gather: the LAST token of each slot's rows
    last = torch.zeros(S + 1, dtype=torch.long, device=dev).scatter_reduce_(
        0, scat_slot, torch.arange(N, device=dev), reduce="amax")[:S]
    return _logits_out(params, bb, x[last], cfg), cache


def _decode_core(params, cache: PagedKVCache, tokens, active, token_pos,
                 block_table, cfg: GPTConfig, block_size: int, lora=None,
                 adapter_slot=None, logits: bool = True):
    """One decode micro-step: writes each active slot's K/V into its page
    and attends over exactly that slot's pages via the paged-attention op.
    Shared by the single-step, burst and draft paths.  Returns logits [S, V]
    (None with ``logits=False``: the KV write alone)."""
    bb = params["backbone"]
    dev = tokens.device
    S = tokens.shape[0]
    NB = cache.num_blocks
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    g = nh // nkv

    x = _embed_in(bb, tokens, token_pos, cfg)
    page = block_table[torch.arange(S, device=dev),
                       (token_pos // block_size).long()].long()
    off = (token_pos % block_size).long()
    kv_len = torch.where(active, token_pos + 1, 0).to(torch.int32)
    slopes = _slopes(cfg, dev)
    if lora is not None:
        # decode rows ARE slots: inactive lanes take the identity slot, so
        # a recycled lane's stale selection never computes a delta
        lora_ids = torch.where(active, adapter_slot, 0).to(torch.int32)

    for li in range(cfg.num_layers):
        blk = bb[f"block_{li}"]
        ap = blk["Attention_0"]
        h = _norm(blk["Norm_0"], x, cfg)
        q, k, v = _qkv(ap, h, cfg)
        if lora is not None:
            q, v = _lora_qv(q, v, h, lora, lora_ids, li)
        if cfg.use_rope:
            q, k = rope(q[:, None], k[:, None], token_pos[:, None], hd,
                        base=cfg.rope_theta, rope_pct=cfg.rope_pct,
                        scaling=cfg.rope_scaling, seq_lens=kv_len[:, None])
            q, k = q[:, 0], k[:, 0]
        dest = torch.where(active, li * NB + page, cache.sink)
        _write_kv(cache, dest, off, k, v)
        k_pages, v_pages = cache.layer(li)
        o = ops.paged_attention(q.reshape(S, nkv, g, hd).contiguous(),
                                k_pages, v_pages, block_table, kv_len,
                                alibi_slopes=slopes,
                                window=cfg.window_for_layer(li),
                                scale=cfg.attn_scale,
                                **cache.layer_scales(li))
        x = _block_residual(blk, x, h,
                            _attn_out(ap, o.reshape(S, nh, hd), cfg), cfg)

    if not logits:
        return None
    x = _norm(bb["final_norm"], x, cfg)
    return _logits_out(params, bb, x, cfg)


def ragged_decode_forward(params, cache: PagedKVCache, batch,
                          cfg: GPTConfig, *, block_size: int):
    """Decode-only step: one token per active slot (batch tokens, active,
    token_pos [S]; block_table [S, MB] int32; with adapters ``lora`` and
    ``adapter_slot`` [S]).  Returns (logits [S, V], the cache, updated in
    place)."""
    logits = _decode_core(params, cache, batch["tokens"], batch["active"],
                          batch["token_pos"], batch["block_table"], cfg,
                          block_size, lora=batch.get("lora"),
                          adapter_slot=batch.get("adapter_slot"))
    return logits, cache


def ragged_decode_burst(params, cache: PagedKVCache, batch, prev_tokens,
                        generator, temperature, top_p, cfg: GPTConfig, *,
                        block_size: int, steps: int, sample_fn,
                        on_step=None):
    """T decode steps, each sampling on the device and feeding its token to
    the next (a Python loop where the JAX package scans), so a burst needs
    no host round trip.  batch: tokens0, from_device, active, pos0 [S],
    block_table [S, MB] — blocks for positions pos0..pos0+T-1 must be
    allocated.  ``on_step`` (host only) is called after each step's
    launches.  Returns (tokens [T, S], prev_tokens' [S])."""
    bt = batch["block_table"]
    active = batch["active"]
    tokens = torch.where(batch["from_device"], prev_tokens, batch["tokens0"])
    pos = batch["pos0"]
    out = []
    for _ in range(steps):
        logits = _decode_core(params, cache, tokens, active, pos, bt, cfg,
                              block_size, lora=batch.get("lora"),
                              adapter_slot=batch.get("adapter_slot"))
        tokens = sample_fn(logits, generator, temperature=temperature,
                           top_p=top_p)
        out.append(tokens)
        pos = pos + 1
        if on_step is not None:
            on_step()
    return torch.stack(out), torch.where(active, tokens, prev_tokens)


def ragged_forward_sampled(params, cache: PagedKVCache, batch, prev_tokens,
                           generator, temperature, top_p, cfg: GPTConfig, *,
                           block_size: int, max_q_per_seq: int, sample_fn):
    """Mixed step with on-device sampling and device-resident token
    feedback: tokens flagged ``from_device`` are read from
    ``prev_tokens[slot]``, and slots flagged ``served`` get their freshly
    sampled token written into the returned prev_tokens (a new tensor — the
    caller keeps earlier ones as records).  The logits never leave the
    device."""
    tokens = torch.where(batch["from_device"],
                         prev_tokens[batch["token_slot"].clamp(min=0).long()],
                         batch["tokens"])
    logits, _ = ragged_forward(params, cache, {**batch, "tokens": tokens},
                               cfg, block_size=block_size,
                               max_q_per_seq=max_q_per_seq)
    nxt = sample_fn(logits, generator, temperature=temperature, top_p=top_p)
    return torch.where(batch["served"], nxt, prev_tokens)


def ragged_decode_sampled(params, cache: PagedKVCache, batch, prev_tokens,
                          generator, temperature, top_p, cfg: GPTConfig, *,
                          block_size: int, sample_fn):
    """Decode-only step with on-device sampling + feedback (see
    ragged_forward_sampled); batch fields are slot-indexed [S]."""
    tokens = torch.where(batch["from_device"], prev_tokens, batch["tokens"])
    logits, _ = ragged_decode_forward(params, cache,
                                      {**batch, "tokens": tokens}, cfg,
                                      block_size=block_size)
    nxt = sample_fn(logits, generator, temperature=temperature, top_p=top_p)
    return torch.where(batch["served"], nxt, prev_tokens)


def ragged_forward_sampled_draft(params, draft_params, cache: PagedKVCache,
                                 draft_cache: PagedKVCache, batch,
                                 prev_tokens, generator, temperature, top_p,
                                 cfg: GPTConfig, draft_cfg: GPTConfig, *,
                                 block_size: int, max_q_per_seq: int,
                                 sample_fn):
    """ragged_forward_sampled that ALSO runs the draft model over the same
    ragged batch (KV only) so the draft's pages ingest every prompt chunk in
    lockstep with the target — the prerequisite for useful speculative
    acceptance (JAX model.py:687).  Draft staleness never affects
    correctness, only acceptance.  Returns prev'."""
    tokens = torch.where(batch["from_device"],
                         prev_tokens[batch["token_slot"].clamp(min=0).long()],
                         batch["tokens"])
    batch = {**batch, "tokens": tokens}
    logits, _ = ragged_forward(params, cache, batch, cfg,
                               block_size=block_size,
                               max_q_per_seq=max_q_per_seq)
    ragged_forward(draft_params, draft_cache, batch, draft_cfg,
                   block_size=block_size, max_q_per_seq=max_q_per_seq,
                   logits=False)
    nxt = sample_fn(logits, generator, temperature=temperature, top_p=top_p)
    return torch.where(batch["served"], nxt, prev_tokens)


def ragged_decode_sampled_draft(params, draft_params, cache: PagedKVCache,
                                draft_cache: PagedKVCache, batch,
                                prev_tokens, generator, temperature, top_p,
                                cfg: GPTConfig, draft_cfg: GPTConfig, *,
                                block_size: int, sample_fn):
    """ragged_decode_sampled with the draft ingesting the same tokens (KV
    only), keeping its pages in lockstep through decode-only rounds so later
    speculative bursts attend no draft-cache holes (JAX model.py:715).
    Returns prev'."""
    tokens = torch.where(batch["from_device"], prev_tokens, batch["tokens"])
    logits = _decode_core(params, cache, tokens, batch["active"],
                          batch["token_pos"], batch["block_table"], cfg,
                          block_size)
    _decode_core(draft_params, draft_cache, tokens, batch["active"],
                 batch["token_pos"], batch["block_table"], draft_cfg,
                 block_size, logits=False)
    nxt = sample_fn(logits, generator, temperature=temperature, top_p=top_p)
    return torch.where(batch["served"], nxt, prev_tokens)


def _verify_core(params, cache: PagedKVCache, tokens, active, pos0,
                 block_table, cfg: GPTConfig, block_size: int):
    """Multi-token scoring forward of speculative decoding (JAX
    model.py:756): every active slot ingests G contiguous tokens at
    positions pos0..pos0+G-1 (K/V written into its pages) and gets logits
    for ALL G positions back.  Dense [S, G] layout; attention goes through
    the ragged-prefill op with q_starts = pos0 and q_counts = G, so on the
    card it runs the prefill kernel (#2), never a plain body.  K/V written
    past the accepted prefix stay in the pages: the next round's kv_len
    stops short of them and later writes overwrite them.  Returns logits
    [S, G, V] fp32."""
    bb = params["backbone"]
    dev = tokens.device
    S, G = tokens.shape
    NB = cache.num_blocks
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    g = nh // nkv

    positions = pos0[:, None] + torch.arange(G, dtype=torch.int32,
                                             device=dev)[None]     # [S, G]
    x = _embed_in(bb, tokens, positions, cfg)                      # [S, G, H]
    flat_pos = positions.reshape(-1)
    # inactive lanes (pos0 0) write the sink page; their column index is
    # clamped so that a narrow table is never indexed past its width
    col = (flat_pos // block_size).long().clamp(max=block_table.shape[1] - 1)
    page = block_table[torch.arange(S, device=dev).repeat_interleave(G),
                       col].long()
    off = (flat_pos % block_size).long()
    act_flat = active.repeat_interleave(G)
    kv_len = torch.where(active, pos0 + G, 0).to(torch.int32)
    q_counts = torch.where(active, G, 0).to(torch.int32)
    q_starts = pos0.to(torch.int32).contiguous()
    slopes = _slopes(cfg, dev)
    H = x.shape[-1]
    for li in range(cfg.num_layers):
        blk = bb[f"block_{li}"]
        ap = blk["Attention_0"]
        h = _norm(blk["Norm_0"], x, cfg)
        q, k, v = _qkv(ap, h, cfg)
        if cfg.use_rope:
            q, k = rope(q, k, positions, hd, base=cfg.rope_theta,
                        rope_pct=cfg.rope_pct, scaling=cfg.rope_scaling,
                        seq_lens=kv_len[:, None])
        dest = torch.where(act_flat, li * NB + page, cache.sink)
        _write_kv(cache, dest, off, k.reshape(S * G, nkv, hd),
                  v.reshape(S * G, nkv, hd))
        k_pool, v_pool = cache.layer(li)
        o = ops.ragged_prefill_attention(
            q.reshape(S, G, nkv, g, hd).contiguous(), k_pool, v_pool,
            block_table, kv_len, q_starts, q_counts, scale=cfg.attn_scale,
            alibi_slopes=slopes, window=cfg.window_for_layer(li),
            **cache.layer_scales(li)).reshape(S, G, nh, hd)
        # inactive lanes (kv_len 0, q_counts 0) hold no rows: zero them as
        # ragged_forward does its pads
        o = torch.where(active[:, None, None, None], o, 0)
        x = _block_residual(blk, x.reshape(S * G, H), h.reshape(S * G, H),
                            _attn_out(ap, o, cfg).reshape(S * G, H),
                            cfg).reshape(S, G, H)

    x = _norm(bb["final_norm"], x, cfg)
    return _logits_out(params, bb, x, cfg)


def _draft_run(draft_params, draft_cache: PagedKVCache, tokens, active, pos,
               block_table, draft_cfg: GPTConfig, block_size: int,
               gamma: int, xform=None, generator=None):
    """The draft half of one speculative outer step: gamma sequential draft
    decodes from ``tokens`` at ``pos`` (argmax, or a sample of
    ``xform(logits)`` when ``xform`` is given), plus one more pass that
    ingests d_gamma's KV so that a fully accepted round leaves no hole in
    the draft's pages at pos+gamma (JAX model.py:894-909).  Returns (d [S,
    gamma], the draft's sampling logits [S, gamma, V] or None)."""
    d_list, q_list = [], []
    dtok, dpos = tokens, pos
    for j in range(gamma + 1):
        dlogits = _decode_core(draft_params, draft_cache, dtok, active, dpos,
                               block_table, draft_cfg, block_size,
                               logits=j < gamma)
        if j < gamma:
            if xform is not None:
                ql = xform(dlogits)
                dtok = torch.multinomial(torch.softmax(ql, -1), 1,
                                         generator=generator)[:, 0]
                q_list.append(ql)
            else:
                dtok = torch.argmax(dlogits, dim=-1)
            dtok = dtok.to(torch.int32)
            d_list.append(dtok)
        dpos = dpos + 1
    return (torch.stack(d_list, dim=1),
            torch.stack(q_list, dim=1) if q_list else None)


def _greedy_accept(vlogits, d, gamma: int):
    """Greedy speculative acceptance (JAX model.py:967): accept the longest
    prefix of draft tokens equal to the target's argmax, then emit the
    target's token at the stop (the correction, or the bonus when all gamma
    were accepted).  Returns (emit [S, gamma+1] int32, counts [S] int32 in
    1..gamma+1)."""
    t = torch.argmax(vlogits, dim=-1).to(torch.int32)             # [S, g+1]
    match = (d == t[:, :gamma]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)                # 0..gamma
    correction = torch.gather(t, 1, n_acc[:, None])[:, 0]
    j_idx = torch.arange(gamma + 1, device=d.device)[None]
    emit = torch.where(j_idx < n_acc[:, None],
                       torch.nn.functional.pad(d, (0, 1)),
                       correction[:, None])
    return emit, (n_acc + 1).to(torch.int32)


def spec_accept(generator, q_logits, p_logits, d):
    """Rejection-sampling acceptance of speculative decoding (Leviathan et
    al. 2023; JAX model.py:1071).  q_logits [S, gamma, V]: the draft's
    post-transform sampling logits (d[s, j] was drawn from
    softmax(q_logits[s, j])); p_logits [S, gamma+1, V]: the target's, plus
    the bonus position; d [S, gamma].  d_j is accepted with probability
    min(1, p(d_j) / q(d_j)); at the first rejection a token is drawn from
    the residual max(p - q, 0) / Z, and when all gamma are accepted from
    the gamma+1-th target distribution, so every emitted token is exactly
    target-distributed for ANY draft.  Returns (emit [S, gamma+1] int32,
    counts [S] int32 in 1..gamma+1)."""
    S, gamma = d.shape
    V = p_logits.shape[-1]
    q = torch.softmax(q_logits, dim=-1)
    p = torch.softmax(p_logits, dim=-1)
    dl = d.long()[..., None]
    pd = torch.gather(p[:, :gamma], 2, dl)[..., 0]
    qd = torch.gather(q, 2, dl)[..., 0]
    u = torch.rand((S, gamma), generator=generator, device=d.device)
    accept = (u * qd < pd).to(torch.int32)
    n = torch.cumprod(accept, dim=1).sum(dim=1)                   # [S]
    p_n = torch.gather(p, 1, n[:, None, None].expand(S, 1, V))[:, 0]
    q_n = torch.gather(q, 1, n.clamp(max=gamma - 1)[:, None, None]
                       .expand(S, 1, V))[:, 0]
    resid = (p_n - q_n).clamp(min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    # a numerically empty residual (p ~ q) falls back to p itself
    resid = torch.where(mass > 1e-9, resid / mass.clamp(min=1e-9), p_n)
    dist = torch.where((n == gamma)[:, None], p_n, resid)
    correction = torch.multinomial(dist, 1, generator=generator)[:, 0].to(
        torch.int32)
    j = torch.arange(gamma + 1, device=d.device)[None]
    emit = torch.where(j < n[:, None], torch.nn.functional.pad(d, (0, 1)),
                       correction[:, None])
    return emit, (n + 1).to(torch.int32)


def _accept_step(vlogits, d, q_logits, active, prev, pos, gamma, xform,
                 generator):
    """The acceptance rule of one outer step and the lane update shared by
    the fused burst and the split verify step: inactive lanes keep their
    prev / pos and count 0.  Returns (emit, counts, prev', pos')."""
    if xform is not None:
        emit, counts = spec_accept(generator, q_logits, xform(vlogits), d)
    else:
        emit, counts = _greedy_accept(vlogits, d, gamma)
    counts = torch.where(active, counts, 0).to(torch.int32)
    last = torch.gather(emit, 1, (counts - 1).clamp(min=0)[:, None]
                        .long())[:, 0]
    return (emit, counts, torch.where(active, last, prev),
            torch.where(active, pos + counts, pos))


def _speculative_burst_core(params, draft_params, cache: PagedKVCache,
                            draft_cache: PagedKVCache, batch, prev_tokens,
                            generator, xform, cfg: GPTConfig,
                            draft_cfg: GPTConfig, *, block_size: int,
                            gamma: int, steps: int):
    """The draft-and-verify choreography (JAX model.py:859; a Python loop
    over the outer steps where JAX scans): each outer step runs the draft
    (``_draft_run``), scores [prev, d_0..d_{gamma-1}] with ONE multi-token
    target forward (``_verify_core``), accepts a prefix and emits accepted
    + 1 tokens.  Rollback is free: positions past the accepted point are
    overwritten by later writes.  Nothing here reads the host.

    batch: tokens0 / from_device / active / pos0 / block_table as in
    ragged_decode_burst; blocks for positions pos0..pos0+steps*(gamma+1)-1
    must be allocated.  Returns (toks [steps, gamma+1, S], counts [steps,
    S], prev') — the first counts[k, s] of toks[k, :, s] are real."""
    bt = batch["block_table"]
    active = batch["active"]
    prev = torch.where(batch["from_device"], prev_tokens, batch["tokens0"])
    pos = batch["pos0"]
    toks, counts = [], []
    for _ in range(steps):
        d, ql = _draft_run(draft_params, draft_cache, prev, active, pos, bt,
                           draft_cfg, block_size, gamma, xform, generator)
        vlogits = _verify_core(params, cache,
                               torch.cat([prev[:, None], d], dim=1), active,
                               pos, bt, cfg, block_size)
        emit, c, prev, pos = _accept_step(vlogits, d, ql, active, prev, pos,
                                          gamma, xform, generator)
        toks.append(emit.t())
        counts.append(c)
    return (torch.stack(toks), torch.stack(counts),
            torch.where(active, prev, prev_tokens))


def _xform(temperature, top_k, top_p):
    from deepspeed_tpu_torch.inference.engine import _sampling_logits
    return functools.partial(_sampling_logits, temperature=temperature,
                             top_k=top_k, top_p=top_p)


def speculative_burst(params, draft_params, cache: PagedKVCache,
                      draft_cache: PagedKVCache, batch, prev_tokens,
                      cfg: GPTConfig, draft_cfg: GPTConfig, *,
                      block_size: int, gamma: int, steps: int):
    """GREEDY speculative decoding (JAX model.py:938): acceptance is an
    exact token match, so the output equals target-only greedy decoding for
    ANY draft, up to argmax near-ties: verify is prefill-shaped and the
    baseline decodes one query at a time, so 16-bit logits can tie
    differently (exactness is pinned in fp32).  Inactive lanes pass their
    prev_tokens through untouched (counts 0, KV unwritten), so one dispatch
    of every request and one dispatch per request give the same tokens.
    Returns (toks, counts, prev')."""
    return _speculative_burst_core(
        params, draft_params, cache, draft_cache, batch, prev_tokens, None,
        None, cfg, draft_cfg, block_size=block_size, gamma=gamma,
        steps=steps)


def speculative_burst_sampled(params, draft_params, cache: PagedKVCache,
                              draft_cache: PagedKVCache, batch, prev_tokens,
                              generator, temperature, top_p, cfg: GPTConfig,
                              draft_cfg: GPTConfig, *, block_size: int,
                              gamma: int, steps: int, top_k: int = 0):
    """Sampled speculative decoding (JAX model.py:1115): the draft samples
    its tokens and verify runs ``spec_accept``, so every emitted token is
    distributed as target-only sampling under the same temperature / top-k
    / top-p, for any draft.  Returns (toks, counts, prev')."""
    return _speculative_burst_core(
        params, draft_params, cache, draft_cache, batch, prev_tokens,
        generator, _xform(temperature, top_k, top_p), cfg, draft_cfg,
        block_size=block_size, gamma=gamma, steps=steps)


def speculative_draft_step(draft_params, draft_cache: PagedKVCache, batch,
                           prev_tokens, pos, generator, temperature, top_p,
                           draft_cfg: GPTConfig, *, block_size: int,
                           gamma: int, top_k: int = 0,
                           sampled: bool = False):
    """The DRAFT half of one outer step as a call of its own (JAX
    model.py:986; the engine's ``speculative.profile`` mode times draft and
    verify apart).  Returns (d [S, gamma], the draft's sampling logits or
    None)."""
    tokens = torch.where(batch["from_device"], prev_tokens, batch["tokens0"])
    return _draft_run(draft_params, draft_cache, tokens, batch["active"],
                      pos, batch["block_table"], draft_cfg, block_size, gamma,
                      _xform(temperature, top_k, top_p) if sampled else None,
                      generator)


def speculative_verify_step(params, cache: PagedKVCache, batch, d, q_logits,
                            prev_tokens, pos, generator, temperature, top_p,
                            cfg: GPTConfig, *, block_size: int, gamma: int,
                            top_k: int = 0, sampled: bool = False):
    """The VERIFY half of one outer step (JAX model.py:1035): one
    multi-token target forward over [seed, d_0..d_{gamma-1}] and the same
    acceptance rule as the fused burst, so the split mode gives the fused
    mode's tokens.  Returns (emit [S, gamma+1], counts [S], prev', pos')."""
    active = batch["active"]
    seed = torch.where(batch["from_device"], prev_tokens, batch["tokens0"])
    vlogits = _verify_core(params, cache, torch.cat([seed[:, None], d], 1),
                           active, pos, batch["block_table"], cfg, block_size)
    return _accept_step(vlogits, d, q_logits, active, prev_tokens, pos,
                        gamma,
                        _xform(temperature, top_k, top_p) if sampled
                        else None, generator)
