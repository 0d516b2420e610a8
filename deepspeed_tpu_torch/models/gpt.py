"""Decoder-only transformer LM (GPT-2 / Llama family) — counterpart of
deepspeed_tpu/models/gpt.py in PyTorch: the shared pieces and the training
modules.

- ``GPTConfig`` (same fields and presets; ``dtype`` is a ``torch.dtype``)
- ``rotary_dim`` / ``_scale_rope_freq`` / ``rope`` (half-split NeoX
  convention), ``mlp_activation``, ``alibi_slopes``, ``count_params``
- ``init_params``: the GPTLogits parameter tree as a nested dict of tensors
  (same names and shapes as the flax tree), drawn from a ``torch.Generator``
- ``params_from_numpy``: the weight bridge from the JAX engine's tree

- the training modules ``Norm``, ``Attention`` (no KV cache), ``MLP``,
  ``Block``, ``GPTBackbone``, ``GPT``, ``GPTChunkedLoss``: ``nn.Module``s
  registering their parameters under the same names and shapes, with
  ``load_params`` / ``params_to_numpy`` / ``grads_to_numpy`` as the bridge
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Dtype = object


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64
    hidden_size: int = 768
    mlp_ratio: int = 4
    max_seq_len: int = 1024
    dropout: float = 0.0
    dtype: Dtype = torch.float32        # compute dtype (engine casts params)
    param_dtype: Dtype = torch.float32
    use_rope: bool = False              # llama-style when True
    use_rmsnorm: bool = False
    gated_mlp: bool = False             # SwiGLU
    num_kv_heads: Optional[int] = None  # GQA; defaults to num_heads
    remat: bool = False
    tie_embeddings: bool = True
    num_experts: int = 0
    moe_k: int = 1
    moe_every: int = 2
    moe_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    moe_dropless: bool = False
    moe_wire_bits: int = 0
    moe_wire_block: int = 256
    moe_hierarchical: bool = False
    moe_num_chunks: int = 1
    sequence_parallel: bool = False
    sp_impl: str = "ulysses"
    sp_ring_layout: str = "drop_in"
    sp_ring_inner: str = "einsum"
    attn_impl: Optional[str] = None
    tp_collective_matmul: bool = False
    loss_chunk: int = 0
    # HF-architecture knobs (llama intermediate_size, rope base, norm eps,
    # bias placement) — see deepspeed_tpu/models/gpt.py for provenance
    mlp_dim_override: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling: Optional[tuple] = None
    norm_eps: Optional[float] = None    # None = ops/norms.py defaults
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    activation: str = "gelu"            # non-gated MLP: gelu|gelu_exact|relu
    parallel_block: bool = False        # x + attn(n(x)) + mlp(n(x))
    parallel_norms: int = 1
    rope_pct: float = 1.0               # partial rotary
    unembed_bias: bool = False
    use_alibi: bool = False
    gate_act: str = "silu"              # gated-MLP gate: silu or gelu
    embed_scale: Optional[float] = None
    sliding_window: Optional[int] = None
    local_attn_layers: tuple = ()
    attn_scale: Optional[float] = None  # None = 1/sqrt(head_dim)
    alibi_prescale: bool = False
    embed_norm: bool = False
    random_ltd_layer_ids: tuple = ()
    act_quant_bits: Optional[int] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def window_for_layer(self, i: int):
        """Per-layer sliding window — the gating rule shared by ragged
        prefill and paged decode."""
        if self.sliding_window and (not self.local_attn_layers
                                    or i in self.local_attn_layers):
            return self.sliding_window
        return None

    @property
    def mlp_dim(self) -> int:
        return self.mlp_dim_override or self.hidden_size * self.mlp_ratio

    def cuda_problem(self) -> Optional[str]:
        """Why the CUDA attention kernels cannot train this model (None:
        they can): their head_dim rule."""
        from deepspeed_tpu_torch.ops.flash_attention import head_dim_problem
        problem = head_dim_problem(self.head_dim)
        return None if problem is None else f"GPTConfig: {problem}"

    @classmethod
    def gpt2_small(cls, **kw):
        return cls(num_layers=12, num_heads=12, head_dim=64, hidden_size=768,
                   **kw)

    @classmethod
    def llama(cls, num_layers=8, hidden=512, heads=8, **kw):
        return cls(num_layers=num_layers, hidden_size=hidden, num_heads=heads,
                   head_dim=hidden // heads, use_rope=True, use_rmsnorm=True,
                   gated_mlp=True, tie_embeddings=False, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 128)
        return cls(num_layers=2, num_heads=4, head_dim=8, hidden_size=32,
                   mlp_ratio=2, **kw)


def alibi_slopes(n_heads: int, head_dim: int = 0, prescale: bool = False):
    """Per-head alibi slopes (HF build_alibi_tensor formula).  ``prescale``:
    the falcon-rw convention — slopes bf16-rounded and folded into the
    1/√head_dim scale.  Returns float32 numpy [n_heads]."""
    cp2 = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = [base ** i for i in range(1, cp2 + 1)]
    if cp2 != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        slopes += [extra_base ** i
                   for i in range(1, 2 * (n_heads - cp2), 2)]
    s = np.asarray(slopes, np.float32)
    if prescale:
        s = torch.from_numpy(s).to(torch.bfloat16).float().numpy() * np.float32(
            head_dim ** -0.5)
    return s


def rotary_dim(head_dim: int, rope_pct: float) -> int:
    """Rotated prefix width for partial rotary, rounded down to even."""
    rot = head_dim if rope_pct >= 1.0 else int(head_dim * rope_pct)
    return rot - (rot % 2)


def _scale_rope_freq(freq, scaling):
    """Frequency transform for long-context rope scaling (HF
    modeling_rope_utils): ("linear", factor) or the llama-3.1 piecewise
    ("llama3", factor, low_freq_factor, high_freq_factor, original_max)."""
    kind = scaling[0]
    if kind == "linear":
        return freq / float(scaling[1])
    if kind == "llama3":
        _, factor, lo_f, hi_f, orig = scaling
        factor, lo_f, hi_f, orig = (float(factor), float(lo_f),
                                    float(hi_f), float(orig))
        wavelen = 2.0 * math.pi / freq
        low_wl = orig / lo_f
        high_wl = orig / hi_f
        scaled = torch.where(wavelen > low_wl, freq / factor, freq)
        smooth = (orig / wavelen - lo_f) / (hi_f - lo_f)
        smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
        is_medium = (wavelen >= high_wl) & (wavelen <= low_wl)
        return torch.where(is_medium, smoothed, scaled)
    raise ValueError(f"unknown rope scaling kind {kind!r}")


def rope(q, k, positions, head_dim, base=10000.0, rope_pct=1.0,
         scaling=None, seq_lens=None):
    """Rotary position embedding on [B, T, n, d] with positions [B, T]
    (half-split NeoX convention).  ``seq_lens`` (shaped like positions)
    selects the longrope short/long factor table per sequence; default is
    the per-row max position + 1.  sin/cos are cast to the activation dtype
    before the products, as in the JAX body."""
    att_factor = None
    rot = rotary_dim(head_dim, rope_pct)
    half = rot // 2
    dev = positions.device
    freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=dev) / half)
    pos = positions.to(torch.float32)[..., None]
    if scaling is not None and scaling[0] == "longrope":
        _, att_factor, short_f, long_f, orig = scaling
        if seq_lens is None:
            seq_lens = positions.amax(dim=-1, keepdim=True) + 1
        is_long = (seq_lens > orig)[..., None]
        ext = torch.where(is_long,
                          torch.as_tensor(long_f, dtype=torch.float32,
                                          device=dev),
                          torch.as_tensor(short_f, dtype=torch.float32,
                                          device=dev))
        angles = pos * (freq / ext)
    else:
        if scaling is not None:
            freq = _scale_rope_freq(freq, tuple(scaling))
        angles = pos * freq
    sin, cos = torch.sin(angles), torch.cos(angles)
    if att_factor is not None:
        sin = sin * float(att_factor)
        cos = cos * float(att_factor)

    def rotfn(x):
        x1, x2 = x[..., :half], x[..., half:rot]
        s = sin[:, :, None, :].to(x.dtype)
        c = cos[:, :, None, :].to(x.dtype)
        parts = [x1 * c - x2 * s, x2 * c + x1 * s]
        if rot < head_dim:
            parts.append(x[..., rot:])
        return torch.cat(parts, dim=-1)

    return rotfn(q), rotfn(k)


def mlp_activation(name: str):
    """Non-gated MLP activation by HF name (gelu = tanh approximation, as
    flax's ``nn.gelu`` default)."""
    try:
        return {"gelu": lambda x: F.gelu(x, approximate="tanh"),
                "gelu_exact": lambda x: F.gelu(x),
                "relu": F.relu,
                "silu": F.silu,
                "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x)}[name]
    except KeyError:
        raise ValueError(f"unknown MLP activation {name!r}; expected "
                         "gelu|gelu_exact|relu|silu|quick_gelu") from None


def count_params(cfg: GPTConfig) -> int:
    H, M, V = cfg.hidden_size, cfg.mlp_dim, cfg.vocab_size
    norms = 1 if (cfg.parallel_block and cfg.parallel_norms == 1) else 2
    per_layer = (cfg.num_heads * cfg.head_dim * H * 2          # wq, wo
                 + cfg.kv_heads * cfg.head_dim * H * 2         # wk, wv
                 + H * M * (3 if cfg.gated_mlp else 2)         # mlp
                 + H * norms * (1 if cfg.use_rmsnorm else 2))
    total = per_layer * cfg.num_layers + V * H + H
    if not cfg.use_rope and not cfg.use_alibi:
        total += cfg.max_seq_len * H
    if cfg.embed_norm:
        total += H * (1 if cfg.use_rmsnorm else 2)
    if not cfg.tie_embeddings:
        total += V * H
    if cfg.unembed_bias:
        total += V
    return total


def param_shapes(cfg: GPTConfig) -> Dict[str, Any]:
    """The GPTLogits parameter tree's names and shapes (nested dict of
    tuples) — the single layout both ``init_params`` and the bridge use.
    Dense (non-MoE) blocks only."""
    H, M, V = cfg.hidden_size, cfg.mlp_dim, cfg.vocab_size
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim

    def norm():
        return ({"scale": (H,)} if cfg.use_rmsnorm
                else {"scale": (H,), "bias": (H,)})

    bb: Dict[str, Any] = {"wte": (V, H), "final_norm": norm()}
    if not cfg.use_rope and not cfg.use_alibi:
        bb["wpe"] = (cfg.max_seq_len, H)
    if cfg.embed_norm:
        bb["embed_norm"] = norm()
    for i in range(cfg.num_layers):
        attn = {"wq": (H, nh, hd), "wk": (H, nkv, hd), "wv": (H, nkv, hd),
                "wo": (nh, hd, H)}
        if cfg.qkv_bias:
            attn.update(bq=(nh, hd), bk=(nkv, hd), bv=(nkv, hd))
        if cfg.attn_out_bias:
            attn["bo"] = (H,)
        mlp = {"wi": (H, M), "wo": (M, H)}
        if cfg.gated_mlp:
            mlp["wg"] = (H, M)
        if cfg.mlp_bias:
            mlp.update(bi=(M,), bo=(H,))
        blk = {"Attention_0": attn, "MLP_0": mlp, "Norm_0": norm()}
        if not (cfg.parallel_block and cfg.parallel_norms == 1):
            blk["Norm_1"] = norm()
        bb[f"block_{i}"] = blk
    tree: Dict[str, Any] = {"backbone": bb}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (H, V)
    if cfg.unembed_bias:
        tree["lm_head_bias"] = (V,)
    return tree


def _map_tree(fn, shapes, path=()):
    return {k: (_map_tree(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v))
            for k, v in shapes.items()}


def init_params(cfg: GPTConfig, generator: torch.Generator, device,
                dtype=None) -> Dict[str, Any]:
    """Random GPTLogits parameters, drawn on ``device`` from ``generator``
    with the flax initializers' laws: weights N(0, 0.02), norm scales 1,
    biases 0.  ``generator`` must live on ``device`` (a CUDA generator for
    weights made on the card)."""
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE blocks are not ported yet (ROADMAP A.8, the MoE serving "
            "path)")
    dtype = dtype or cfg.dtype

    def make(path, shape):
        name = path[-1]
        if name == "scale":
            return torch.ones(shape, dtype=dtype, device=device)
        if name in ("bias", "bq", "bk", "bv", "bo", "bi", "lm_head_bias"):
            return torch.zeros(shape, dtype=dtype, device=device)
        w = torch.empty(shape, dtype=dtype, device=device)
        return w.normal_(0.0, 0.02, generator=generator)

    return _map_tree(make, param_shapes(cfg))


def params_from_numpy(tree, cfg: GPTConfig, device,
                      dtype=None) -> Dict[str, Any]:
    """The weight bridge: the JAX engine's parameter tree (``engine.params``
    of the JAX InferenceEngineV2 — the unboxed GPTLogits tree — with every
    leaf converted by ``np.asarray``) → the port's tree of tensors on
    ``device`` in ``dtype``.  A missing, extra or misshapen leaf raises.

    A quantized engine's tree carries store leaves (ops/quantization.py):
    ``{"v": codes, "s": scales}`` or ``{"v4": packed codes, "s": scales}``
    in place of a weight.  Their codes come over as ``torch.int8`` and their
    scales as fp32, whatever ``dtype`` is; the codes must have the weight's
    shape (dim 0 halved for ``v4``; a ``wte`` table may be padded along
    dim 0 to its quantization group)."""
    dtype = dtype or cfg.dtype
    want = param_shapes(cfg)

    def store(t, shape, path):
        key = "v4" if "v4" in t else "v"
        v, sc = np.asarray(t[key]), np.asarray(t["s"])
        got = list(v.shape)
        if key == "v4":
            got[0] *= 2
        rows_ok = (got[0] == shape[0]
                   or (path[-1] == "wte" and got[0] > shape[0]))
        if not rows_ok or tuple(got[1:]) != tuple(shape[1:]) \
                or sc.ndim != v.ndim:
            raise ValueError(f"{'/'.join(path)}: store codes "
                             f"{tuple(v.shape)} ({key}) do not fit the "
                             f"weight {shape}")
        return {key: torch.tensor(v.astype(np.int8), device=device),
                "s": torch.tensor(sc.astype(np.float32), device=device)}

    def walk(w, t, path):
        if not isinstance(t, dict):
            raise ValueError(f"{'/'.join(path) or '<root>'}: expected a "
                             f"subtree, got {type(t).__name__}")
        if set(w) != set(t):
            raise ValueError(
                f"{'/'.join(path) or '<root>'}: names differ — missing "
                f"{sorted(set(w) - set(t))}, unexpected "
                f"{sorted(set(t) - set(w))}")
        out = {}
        for k, shape in w.items():
            if isinstance(shape, dict):
                out[k] = walk(shape, t[k], path + (k,))
                continue
            if isinstance(t[k], dict) and set(t[k]) in ({"v", "s"},
                                                       {"v4", "s"}):
                out[k] = store(t[k], shape, path + (k,))
                continue
            a = np.asarray(t[k])
            if tuple(a.shape) != tuple(shape):
                raise ValueError(f"{'/'.join(path + (k,))}: shape "
                                 f"{tuple(a.shape)} != expected {shape}")
            out[k] = torch.tensor(np.asarray(a, dtype=np.float32),
                                  dtype=dtype, device=device)
        return out

    return walk(want, tree, ())


# --------------------------------------------------------------------------
# The training modules: nn.Modules that own their nn.Parameters under the
# names and shapes of ``param_shapes(cfg)``, so one tree serves training and
# ``InferenceEngineV2``.


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _check_trainable(cfg: GPTConfig):
    """Raise for the configuration knobs the training path does not have
    yet; none is silently ignored."""
    if cfg.num_experts:
        _unported("MoE blocks (num_experts > 0)", "A.8")
    if cfg.sequence_parallel:
        _unported("sequence parallelism (the sp_active attention branch)",
                  "A.8")
    if cfg.dropout > 0:
        _unported("dropout > 0 (the reference draws its masks from a flax "
                  "RNG that cannot be matched)", "A.11")
    if cfg.random_ltd_layer_ids:
        _unported("random-LTD layers", "A.11")
    if cfg.act_quant_bits:
        _unported("activation quantization (act_quant_bits)", "A.11")


class _ParamModule(torch.nn.Module):
    """Registers a subtree of ``init_params`` as parameters / submodules."""

    def _adopt(self, tree: Dict[str, Any]):
        for name, leaf in tree.items():
            if not isinstance(leaf, dict):
                self.register_parameter(name, torch.nn.Parameter(leaf))


class Norm(_ParamModule):
    def __init__(self, cfg: GPTConfig, tree):
        super().__init__()
        self.cfg = cfg
        self._adopt(tree)

    def forward(self, x):
        from deepspeed_tpu_torch.ops.norms import (LN_EPS, RMS_EPS,
                                                   layer_norm, rms_norm)
        c = self.cfg
        if c.use_rmsnorm:
            return rms_norm(x, self.scale, eps=c.norm_eps or RMS_EPS)
        return layer_norm(x, self.scale, self.bias, eps=c.norm_eps or LN_EPS)


class Attention(_ParamModule):
    """Self-attention without a KV cache (the training leg).  ``fused_ok``:
    positions are canonical (query t at position t), so a window or alibi
    goes to ``ops.causal_attention`` first-class, where the flash kernels
    take it; otherwise they ride an explicit mask / bias on the plain
    body."""

    def __init__(self, cfg: GPTConfig, tree):
        super().__init__()
        self.cfg = cfg
        self._adopt(tree)

    def forward(self, x, positions, window=None, fused_ok: bool = False):
        from deepspeed_tpu_torch import ops
        c = self.cfg
        nh, hd = c.num_heads, c.head_dim
        dt = x.dtype
        q = torch.einsum("bth,hnd->btnd", x, self.wq.to(dt))
        k = torch.einsum("bth,hnd->btnd", x, self.wk.to(dt))
        v = torch.einsum("bth,hnd->btnd", x, self.wv.to(dt))
        if c.qkv_bias:
            q = q + self.bq.to(dt)
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
        if c.use_rope:
            q, k = rope(q, k, positions, hd, base=c.rope_theta,
                        rope_pct=c.rope_pct, scaling=c.rope_scaling)

        def alibi_bias(key_pos):
            """[.., S] key positions → [.., nh, 1, S] logit bias."""
            if not c.use_alibi:
                return None
            s = torch.from_numpy(alibi_slopes(nh, hd, c.alibi_prescale)).to(
                x.device)
            return s[:, None, None] * key_pos[..., None, None, :].float()

        if fused_ok and (window is not None or c.use_alibi):
            slopes = (alibi_slopes(nh, hd, c.alibi_prescale)
                      if c.use_alibi else None)
            out = ops.causal_attention(q, k, v, causal=True, window=window,
                                       alibi_slopes=slopes,
                                       scale=c.attn_scale)
        elif window is not None:
            rel = positions[:, :, None] - positions[:, None, :]
            wmask = (rel >= 0) & (rel < window)
            out = ops.causal_attention(q, k, v, causal=False, mask=wmask,
                                       bias=alibi_bias(positions),
                                       scale=c.attn_scale)
        else:
            out = ops.causal_attention(q, k, v, bias=alibi_bias(positions),
                                       scale=c.attn_scale)
        y = torch.einsum("btnd,ndh->bth", out, self.wo.to(dt))
        return y + self.bo.to(dt) if c.attn_out_bias else y


class MLP(_ParamModule):
    def __init__(self, cfg: GPTConfig, tree):
        super().__init__()
        self.cfg = cfg
        self._adopt(tree)

    def forward(self, x):
        c = self.cfg
        dt = x.dtype
        h = x @ self.wi.to(dt)
        if c.mlp_bias:
            h = h + self.bi.to(dt)
        if c.gated_mlp:
            h = mlp_activation(c.gate_act)(x @ self.wg.to(dt)) * h
        else:
            h = mlp_activation(c.activation)(h)
        y = h @ self.wo.to(dt)
        return y + self.bo.to(dt) if c.mlp_bias else y


class Block(_ParamModule):
    """One decoder block, dense: sequential residuals, or the falcon/phi
    parallel residual (``parallel_block``, one or two input norms)."""

    def __init__(self, cfg: GPTConfig, tree, is_moe: bool = False):
        super().__init__()
        if is_moe:
            _unported("MoE blocks", "A.8")
        self.cfg = cfg
        self.Attention_0 = Attention(cfg, tree["Attention_0"])
        self.MLP_0 = MLP(cfg, tree["MLP_0"])
        self.Norm_0 = Norm(cfg, tree["Norm_0"])
        if "Norm_1" in tree:
            self.Norm_1 = Norm(cfg, tree["Norm_1"])

    def forward(self, x, positions, pld_keep=None, window=None,
                fused_ok: bool = False):
        c = self.cfg
        if pld_keep is not None:
            _unported("the progressive-layer-drop gate", "A.11")
        if c.parallel_block:
            h_attn = self.Norm_0(x)
            h_mlp = self.Norm_1(x) if c.parallel_norms == 2 else h_attn
            a = self.Attention_0(h_attn, positions, window=window,
                                 fused_ok=fused_ok)
            return x + a + self.MLP_0(h_mlp)
        x = x + self.Attention_0(self.Norm_0(x), positions, window=window,
                                 fused_ok=fused_ok)
        return x + self.MLP_0(self.Norm_1(x))


class GPTBackbone(_ParamModule):
    """Token ids → final hidden states (and the embedding table, for the
    tied unembed)."""

    def __init__(self, cfg: GPTConfig, tree):
        super().__init__()
        self.cfg = cfg
        self._adopt(tree)
        if cfg.embed_norm:
            self.embed_norm = Norm(cfg, tree["embed_norm"])
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", Block(cfg, tree[f"block_{i}"]))
        self.final_norm = Norm(cfg, tree["final_norm"])

    def forward(self, input_ids, positions=None, ltd_idx=None,
                pld_theta=None):
        c = self.cfg
        if ltd_idx is not None:
            _unported("random-LTD token dropping", "A.11")
        if pld_theta is not None:
            _unported("progressive layer drop", "A.11")
        B, T = input_ids.shape
        x = F.embedding(input_ids, self.wte.to(c.dtype))
        if c.embed_scale:
            x = x * torch.tensor(c.embed_scale, dtype=c.dtype,
                                 device=x.device)
        if c.embed_norm:
            x = self.embed_norm(x)
        canonical_pos = positions is None
        if positions is None:
            positions = torch.arange(T, device=input_ids.device).expand(B, T)
        if not c.use_rope and not c.use_alibi:
            x = x + F.embedding(positions, self.wpe.to(c.dtype))
        for i in range(c.num_layers):
            block = getattr(self, f"block_{i}")
            win = c.window_for_layer(i)
            if c.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint
                x = checkpoint(block, x, positions, None, win, canonical_pos,
                               use_reentrant=False)
            else:
                x = block(x, positions, window=win, fused_ok=canonical_pos)
        return self.final_norm(x), self.wte


def shift_labels(batch, input_ids):
    """(labels, mask) for next-token LM, honoring explicit labels /
    loss_mask and the ignore convention (labels < 0)."""
    labels = batch.get("labels")
    if labels is None:
        labels = F.pad(input_ids[:, 1:], (0, 1))
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
    else:
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        mask = mask.float() * (labels >= 0)
        labels = labels.clamp_min(0)
    return labels, mask


class GPT(torch.nn.Module):
    """LM-loss wrapper satisfying the engine's model contract:
    ``model(batch) -> scalar loss`` for a batch dict with ``input_ids``
    [B, T] (and optionally ``labels`` / ``loss_mask``).

    ``cfg.loss_chunk > 0`` computes the unembed + CE in chunks
    (ops/cross_entropy.py) so the fp32 [B, T, V] logits never exist whole;
    0 keeps the one-shot path.  Parameters are drawn from ``generator`` on
    ``device`` in ``cfg.param_dtype`` (defaults: a CPU generator seeded 0),
    or loaded afterwards with ``load_params``.
    """

    def __init__(self, cfg: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_trainable(cfg)
        if cfg.sp_ring_layout not in ("drop_in", "native"):
            raise ValueError(f"sp_ring_layout must be drop_in|native, got "
                             f"{cfg.sp_ring_layout!r}")
        self.cfg = cfg
        device = torch.device(device or "cpu")
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        tree = init_params(cfg, generator, device, cfg.param_dtype)
        self.backbone = GPTBackbone(cfg, tree["backbone"])
        if not cfg.tie_embeddings:
            self.lm_head = torch.nn.Parameter(tree["lm_head"])
        if cfg.unembed_bias:
            self.lm_head_bias = torch.nn.Parameter(tree["lm_head_bias"])

    def _loss_chunk(self) -> int:
        return self.cfg.loss_chunk

    def forward(self, batch, deterministic: bool = False):
        from deepspeed_tpu_torch.ops import lm_cross_entropy
        c = self.cfg
        input_ids = batch["input_ids"]
        x, emb = self.backbone(input_ids, ltd_idx=batch.get("random_ltd_idx"),
                               pld_theta=batch.get("pld_theta"))
        if c.tie_embeddings:
            unembed = emb.to(x.dtype).t()                  # [H, V]
        else:
            unembed = self.lm_head.to(x.dtype)
        labels, mask = shift_labels(batch, input_ids)
        bias = self.lm_head_bias if c.unembed_bias else None
        return lm_cross_entropy(x, unembed, labels, mask,
                                chunk_size=self._loss_chunk() or None,
                                bias=bias)

    # ---- the weight bridge -------------------------------------------
    def named_leaves(self):
        """(path, parameter) pairs with ``param_shapes``' slash paths."""
        for name, p in self.named_parameters():
            yield name.replace(".", "/"), p

    @torch.no_grad()
    def load_params(self, tree) -> "GPT":
        """Copy the reference engine's parameter tree (numpy arrays under
        the names of ``param_shapes``, optionally below flax's "params"
        key) into this module.  A missing, extra or misshapen leaf
        raises."""
        if isinstance(tree, dict) and set(tree) == {"params"}:
            tree = tree["params"]
        flat = dict(_flatten(tree))
        want = dict(self.named_leaves())
        if set(flat) != set(want):
            raise ValueError(
                f"parameter names differ — missing "
                f"{sorted(set(want) - set(flat))}, unexpected "
                f"{sorted(set(flat) - set(want))}")
        for path, p in want.items():
            a = np.array(flat[path], dtype=np.float32)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {tuple(a.shape)} != "
                                 f"expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a).to(p.dtype))
        return self


class GPTChunkedLoss(GPT):
    """GPT that always chunks the unembed + CE (512-token chunks when
    ``cfg.loss_chunk`` is unset)."""

    def _loss_chunk(self) -> int:
        return self.cfg.loss_chunk or 512


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _unflatten(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in pairs:
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def params_to_numpy(model: GPT) -> Dict[str, Any]:
    """The module's parameters as a nested dict of float32 numpy arrays
    under ``param_shapes``' names (what ``params_from_numpy`` takes)."""
    return _unflatten((path, p.detach().float().cpu().numpy())
                      for path, p in model.named_leaves())


def grads_to_numpy(model: GPT) -> Dict[str, Any]:
    """The parameters' ``.grad`` under the same names (None where a
    parameter has no gradient yet)."""
    return _unflatten(
        (path, None if p.grad is None else p.grad.detach().float().cpu()
         .numpy()) for path, p in model.named_leaves())
