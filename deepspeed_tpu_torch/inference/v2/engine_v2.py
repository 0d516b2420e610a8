"""InferenceEngineV2 — ragged continuous-batching serving engine ("FastGen"),
PyTorch counterpart of deepspeed_tpu/inference/v2/engine_v2.py.

``put(uids, tokens)`` runs ONE forward over a ragged batch and returns one
logit row per sequence, ``query``/``can_schedule`` expose KV headroom,
``flush`` frees state, and ``generate`` is the continuous-batching driver
with the Dynamic SplitFuse schedule (decodes first, prompt chunks fill the
remaining token budget), fused decode bursts, recompute preemption on pool
starvation, EOS with a sync interval, and open-loop ``arrival_times``.

The engine runs on the card unless the caller names another device:
``device=None`` is ``cuda:0`` and raises without CUDA.  Steps run eagerly;
the paged KV pool is one preallocated tensor updated in place (where the
JAX engine donates it through each jitted step).  The token feedback loop
stays on the device: every step samples there and the next step reads its
input tokens from the previous step's output, so the host learns token
VALUES only at ``materialize`` — one ``.cpu()`` per sync point.

Quantized serving: the ``quant`` block (``enabled``, ``bits`` 8 or 4,
``group_size``) packs the weights into int8 / nibble-packed stores at
construction, with the JAX engine's packing policy rule for rule, and the
engine then holds only the store; ``state_manager.kv_quant="int8"`` keeps
the KV pool as int8 codes with per-token fp32 scales.

Multi-tenant LoRA: the ``adapters`` block (``enabled``, ``rank``,
``alpha``, ``slots``) attaches an ``AdapterPool`` (serving/adapters.py) to
the KV allocator; ``register_adapter`` makes a tenant loadable and
``generate(adapter_ids=...)`` serves each prompt through its tenant's
pages, all tenants in one dispatch (ops/lora_matmul.py).  An engine
without the block passes no adapter keys and runs the base code.

Radix prefix cache (``state_manager.prefix_cache``): a new prompt aliases
the pool blocks of every previously served block-aligned prefix
(ragged.RadixKVCache) and skips their prefill; retired blocks stay cached
until LRU eviction reclaims them.  SLA scheduling (the ``scheduler``
block, ``generate(sla=[...])``): priority orders admission, and a waiting
request whose TTFT objective is at risk recompute-preempts a
lower-priority running one.  Speculative decoding (``draft_model`` /
``draft_params`` and the ``speculative`` block): a draft model with its
own KV pool on the same block table proposes ``gamma`` tokens a round and
the target verifies them in one prefill-shaped forward (greedy: exact
match; sampling: rejection sampling).  Serving telemetry (the
``telemetry`` block, ``self.telemetry``): lifecycle spans, TTFT / TPOT
histograms, KV-pool, prefix-cache, SLA and speculative counters.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
tensor parallelism (A.8, and with it quantized tensor-parallel serving
and a draft under tensor parallelism), MoE models (A.8), HF model
directories (A.9), and ``prefix_cache`` together with ``adapters`` (C.3).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.config import DeepSpeedConfigModel
from deepspeed_tpu_torch.inference.config import (GenerationConfig,
                                                  _DTYPE_ALIASES)
from deepspeed_tpu_torch.inference.engine import _sample_token
from deepspeed_tpu_torch.inference.v2.model import (
    PagedKVCache, ragged_decode_burst, ragged_decode_forward,
    ragged_decode_sampled, ragged_decode_sampled_draft, ragged_forward,
    ragged_forward_sampled, ragged_forward_sampled_draft, speculative_burst,
    speculative_burst_sampled, speculative_draft_step,
    speculative_verify_step)
from deepspeed_tpu_torch.inference.v2.ragged import (DSStateManager,
                                                     RaggedBatch,
                                                     build_ragged_batch)
from deepspeed_tpu_torch.models.gpt import count_params, init_params
from deepspeed_tpu_torch.ops.quantization import (quantize_weight,
                                                  quantize_weight4,
                                                  weight_group_size)
from deepspeed_tpu_torch.telemetry.serving import (ServingTelemetry,
                                                   ServingTelemetryConfig)
from deepspeed_tpu_torch.utils.logging import log_dist

_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16}


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet (ROADMAP {item})")


@dataclasses.dataclass
class DSStateManagerConfig(DeepSpeedConfigModel):
    """reference: inference/v2/ragged/manager_configs.py."""

    max_tracked_sequences: int = 32
    max_ragged_batch_size: int = 256        # token budget per forward
    max_ragged_sequence_count: int = 32
    kv_block_size: int = 64
    num_kv_blocks: Optional[int] = None     # None = enough for all slots full
    max_q_per_seq: int = 128                # prompt-chunk cap (SplitFuse)
    kv_quant: Optional[str] = None          # None or "int8" (int8 KV pages)
    # radix shared-prefix KV cache (ragged.RadixKVCache); greedy output is
    # token-exact with it on or off.  Off by default: a flush no longer
    # returns prompt blocks to the free list at once
    prefix_cache: bool = False
    # SplitFuse cap on prompt-chunk tokens co-scheduled per forward
    # (None = the full remaining token budget)
    prefill_chunk_tokens: Optional[int] = None


@dataclasses.dataclass
class SLAClassConfig(DeepSpeedConfigModel):
    """One serving SLA class (``scheduler.sla_classes`` values; JAX
    engine_v2.py:86).  Higher ``priority`` admits first and may preempt
    lower-priority decoders; ``ttft_slo_ms`` is the time-to-first-token
    objective that ARMS preemption (0 = no SLO: the class never preempts)."""

    priority: int = 0
    ttft_slo_ms: float = 0.0


@dataclasses.dataclass
class SchedulerV2Config(DeepSpeedConfigModel):
    """``scheduler`` block (JAX engine_v2.py:96): SLA-aware admission and
    preemption over the SplitFuse loop.  A request names its class through
    ``generate(..., sla=[...])``; unnamed requests ride the implicit
    ``default`` class (priority 0, no SLO).  When a waiting request with a
    TTFT SLO has burned ``preempt_margin`` of it and cannot be admitted (no
    sequence slot, or no KV blocks even after cache eviction), the most
    recently admitted lower-priority running request is recompute-preempted
    for it."""

    sla_classes: Dict[str, SLAClassConfig] = dataclasses.field(
        default_factory=dict)
    sla_preempt: bool = True
    preempt_margin: float = 0.5     # fraction of ttft_slo_ms before preempting

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.sla_classes, dict):
            raise TypeError(f"SchedulerV2Config.sla_classes: expected a dict "
                            f"of classes, got {self.sla_classes!r}")
        self.sla_classes = {str(k): SLAClassConfig.parse(v)
                            for k, v in self.sla_classes.items()}


@dataclasses.dataclass
class SpeculativeConfig(DeepSpeedConfigModel):
    """Draft-and-verify decoding (JAX engine_v2.py:118); the draft comes
    from the engine's ``draft_model`` / ``draft_params`` arguments.
    ``profile`` dispatches draft and verify apart with a fence between them
    (feeding ``spec_draft_ms_total`` / ``spec_verify_ms_total``): the same
    tokens, slower — a profiling knob.  ``batch_across_requests`` False
    runs each request alone through the same slot-wide program (the
    per-request baseline): the same tokens, more dispatches."""

    gamma: int = 4              # draft tokens per verify
    outer_steps: int = 8        # draft + verify rounds fused per dispatch
    profile: bool = False
    batch_across_requests: bool = True


@dataclasses.dataclass
class V2TPConfig(DeepSpeedConfigModel):
    tp_size: int = 1


@dataclasses.dataclass
class V2QuantConfig(DeepSpeedConfigModel):
    """Quantized weight serving (JAX engine_v2.py:141): weights live on the
    card as int8 codes (``bits`` 8) or nibble-packed 4-bit codes (``bits``
    4) with fp32 scales per ``group_size`` along the grouped dim."""

    enabled: bool = False
    bits: int = 8
    group_size: int = 128


@dataclasses.dataclass
class AdapterLoRAConfig(DeepSpeedConfigModel):
    """Multi-tenant LoRA adapter serving (JAX engine_v2.py:159): per-request
    adapter selection through ONE fused ragged dispatch, adapter pages paged
    as refcounted residents of the KV block allocator.  ``slots`` counts
    device-table lanes INCLUDING the identity slot 0; the LoRA scale is
    ``alpha / rank``."""

    enabled: bool = False
    rank: int = 8
    alpha: float = 16.0
    slots: int = 8


@dataclasses.dataclass
class RaggedInferenceEngineConfig(DeepSpeedConfigModel):
    """reference: inference/v2/config_v2.py RaggedInferenceEngineConfig."""

    dtype: str = "bfloat16"
    tensor_parallel: V2TPConfig = dataclasses.field(default_factory=V2TPConfig)
    state_manager: DSStateManagerConfig = dataclasses.field(
        default_factory=DSStateManagerConfig)
    scheduler: SchedulerV2Config = dataclasses.field(
        default_factory=SchedulerV2Config)
    generation: GenerationConfig = dataclasses.field(
        default_factory=GenerationConfig)
    speculative: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)
    quant: V2QuantConfig = dataclasses.field(default_factory=V2QuantConfig)
    adapters: AdapterLoRAConfig = dataclasses.field(
        default_factory=AdapterLoRAConfig)
    telemetry: ServingTelemetryConfig = dataclasses.field(
        default_factory=ServingTelemetryConfig)

    @classmethod
    def parse(cls, config):
        if isinstance(config, dict) and "dtype" in config:
            key = str(config["dtype"]).replace("torch.", "").lower()
            if key not in _DTYPE_ALIASES:
                raise ValueError(f"unsupported dtype {config['dtype']!r}; "
                                 f"expected one of {sorted(_DTYPE_ALIASES)}")
            config = {**config, "dtype": _DTYPE_ALIASES[key]}
        return super().parse(config)

    @property
    def torch_dtype(self):
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported serving dtype {self.dtype!r}; "
                             f"expected one of {sorted(_TORCH_DTYPES)}")
        return _TORCH_DTYPES[self.dtype]


def _check_unported(config: RaggedInferenceEngineConfig) -> None:
    sm = config.state_manager
    qc = config.quant
    if qc.enabled and config.tensor_parallel.tp_size > 1:
        raise _unported("quant with tensor_parallel.tp_size > 1",
                        "A.8 multi-GPU parallelism (wq_matmul_tp)")
    if config.tensor_parallel.tp_size > 1:
        raise _unported("tensor_parallel.tp_size > 1",
                        "A.8 multi-GPU parallelism")
    if qc.enabled and qc.bits not in (8, 4):
        raise ValueError(f"quant.bits must be 8 or 4, got {qc.bits}")
    if sm.kv_quant not in (None, "int8"):
        raise ValueError(f"unsupported kv_quant {sm.kv_quant!r}; use 'int8'")
    if sm.prefix_cache and config.adapters.enabled:
        # the radix key is the token ids alone, but an adapter's delta on v
        # changes the cached V: a second tenant would reuse the first
        # tenant's KV
        raise _unported("state_manager.prefix_cache with adapters",
                        "C.3: the radix key holds no adapter id")


def _pack_leaf(name: str, p: torch.Tensor, qc: V2QuantConfig, tied: bool):
    """The JAX engine's packing policy (engine_v2.py:321-376), rule for
    rule: one leaf -> a store, or the leaf unchanged."""
    gs = qc.group_size
    pack4 = qc.bits == 4
    # wpe: the positional gather stays direct; gate: an MoE router's
    # discrete top-k decisions must not see rounding
    if (name in ("wpe", "gate") or not p.is_floating_point()
            or p.dim() < 2 or p.numel() < 8 * gs):
        return p
    if name == "wte" and not weight_group_size((p.shape[0],), gs):
        # an odd vocabulary (GPT-2's 50257) cannot group along dim 0: pad
        # the table with zero rows to the group (even for 4 bits); tied
        # logits are sliced back to vocab_size (model._logits_out)
        gpad = -(-p.shape[0] // gs) * gs
        if pack4:
            gpad = -(-gpad // 2) * 2
        p = torch.cat([p, p.new_zeros((gpad - p.shape[0],)
                                      + tuple(p.shape[1:]))])
    # attention wo [heads, hd, H] groups along dim 1 first (its 2-D kernel
    # view needs it); everything else along dim 0 first
    cand = (1, 0) if (p.dim() == 3 and name == "wo") else range(p.dim() - 1)
    for dim in cand:
        if weight_group_size((p.shape[dim],), gs):
            if (pack4 and dim == 0 and p.shape[0] % 2 == 0
                    and not (name == "wte" and tied)):
                # a tied table stays int8: the transposed unembed kernel
                # has no packed variant
                return quantize_weight4(p, group=gs)
            return quantize_weight(p, bits=qc.bits, group=gs, dim=dim)
    return p


def _pack_tree(tree, qc: V2QuantConfig, tied: bool):
    """Pack every leaf of ``tree`` in place of its tensor (the tree is the
    engine's own copy, so each full-precision leaf is freed as it goes)."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            tree[k] = _pack_tree(tree[k], qc, tied)
        else:
            tree[k] = _pack_leaf(k, tree[k], qc, tied)
    return tree




@dataclasses.dataclass
class _Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    # host-materialized tokens (filled from the device records at sync points)
    generated: List[int] = dataclasses.field(default_factory=list)
    # tokens sampled ON DEVICE so far — the host schedules off this count and
    # only learns the VALUES at materialize time (device-resident feedback)
    sampled: int = 0
    # prefill complete: the next input token comes from device feedback
    decode_ready: bool = False
    # host-known continuation token (set after a preemption; feeds the first
    # post-resume decode from the host instead of device feedback)
    held_token: Optional[int] = None
    done: bool = False
    # EOS was discovered at a materialize point (post-EOS overshoot tokens
    # are discarded)
    eos_hit: bool = False
    # re-prefilling after preemption: the completion logits must NOT be
    # sampled (the continuation token is already held in held_token)
    resume: bool = False
    # how many generated tokens have been folded into .prompt by preemptions
    folded: int = 0
    # ---- serving-telemetry lifecycle (ServingTelemetry.now() seconds),
    # taken when the dispatch returns: device completion with
    # ``stream`` on, host submission (a lower bound) without it
    track: int = 0                         # trace tid of this request
    # ---- SLA class (scheduler.sla_classes, named per request through
    # generate(sla=[...])): priority orders admission and arms preemption
    # of lower-priority running decoders when ttft_slo_ms is at risk
    sla: str = "default"
    priority: int = 0
    ttft_slo_ms: float = 0.0
    # LoRA adapter id serving this request (0 = base model identity)
    adapter: int = 0
    t_arrival: float = 0.0
    t_admit: Optional[float] = None
    t_prefill_end: Optional[float] = None
    t_first: Optional[float] = None        # first generated token
    t_last: Optional[float] = None         # last generated token
    preempts: int = 0
    finished: bool = False                 # finish_request recorded
    # distributed TraceContext (telemetry/tracecontext.py): the caller's
    # (generate(trace_ctx=...)) or a local flowless one
    trace: Optional[Any] = None


def _to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """Host batch arrays → device tensors WITHOUT a host sync: a blocking
    host-to-device copy waits for every kernel already queued, which would
    serialise the host's scheduling with the device's work at every step.
    A non-blocking copy from pageable memory stages the bytes before it
    returns, so the numpy arrays may be dropped at once."""
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=True) for k, a in arrays.items()}


def _fetch(*tensors) -> List[np.ndarray]:
    """Several device int tensors → numpy in ONE transfer (one sync)."""
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors]).cpu()
    flat = flat.numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


class InferenceEngineV2:
    """model: a GPTConfig; params: the port's parameter tree (models/gpt.py
    ``init_params`` / ``params_from_numpy``), or None for a fresh seeded
    init.  draft_model / draft_params: a speculative-decoding draft (a
    GPTConfig with the target's vocabulary, and its tree or None for a
    fresh init seeded ``seed + 1``).  See reference engine_v2.py:30."""

    def __init__(self, model, config=None, params=None, seed: int = 0,
                 device=None, draft_model=None, draft_params=None):
        if isinstance(model, str):
            raise _unported("serving an HF model directory",
                            "A.9 offload/checkpoint (checkpoint/hf.py)")
        self.config = RaggedInferenceEngineConfig.parse(config)
        if draft_params is not None and draft_model is None:
            raise ValueError("draft_params given without draft_model")
        if draft_model is not None:
            if self.config.tensor_parallel.tp_size > 1:
                raise _unported("speculative decoding with tensor parallelism",
                                "A.8 multi-GPU parallelism")
            if self.config.adapters.enabled:
                raise NotImplementedError(
                    "speculative decoding with LoRA adapters: the draft has "
                    "no adapter pages to verify against; drop the draft or "
                    "the adapters config")
        _check_unported(self.config)
        self.device = resolve_device(device)
        sm = self.config.state_manager
        dt = self.config.torch_dtype
        model_cfg = dataclasses.replace(model, dtype=dt, dropout=0.0)
        if model_cfg.num_experts:
            raise _unported("MoE models (num_experts > 0)",
                            "A.8 the MoE serving path")
        self.model_config = model_cfg

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(model_cfg, gen, self.device, dt)
        self.params = self._cast_tree(params, dt)
        del params
        if self.config.quant.enabled:
            # cast to the engine dtype first, then quantize (as the JAX
            # engine does); each leaf's full-precision tensor is dropped as
            # its store is made, so the engine at rest holds only the store
            self.params = _pack_tree(self.params, self.config.quant,
                                     model_cfg.tie_embeddings)

        blocks_per_seq = -(-model_cfg.max_seq_len // sm.kv_block_size)
        num_blocks = (sm.num_kv_blocks
                      or sm.max_tracked_sequences * blocks_per_seq)
        self.state = DSStateManager(
            max_tracked_sequences=sm.max_tracked_sequences,
            num_blocks=num_blocks, block_size=sm.kv_block_size,
            max_seq_len=model_cfg.max_seq_len,
            prefix_cache=sm.prefix_cache)
        self.cache = PagedKVCache.create(model_cfg, num_blocks,
                                         sm.kv_block_size, dt, self.device,
                                         quant=sm.kv_quant)
        # ---- speculative decoding draft: the draft shares the pool's
        # GEOMETRY (one block table indexes both pools) but holds its own
        # pages, sink page included; it is never quantized
        self.draft_config = self.draft_params = self.draft_cache = None
        if draft_model is not None:
            dcfg = dataclasses.replace(draft_model, dtype=dt, dropout=0.0)
            if dcfg.num_experts:
                raise _unported("an MoE draft model", "A.8 the MoE serving "
                                "path")
            if dcfg.max_seq_len < model_cfg.max_seq_len:
                raise ValueError(
                    f"draft max_seq_len {dcfg.max_seq_len} < target "
                    f"{model_cfg.max_seq_len}")
            if dcfg.vocab_size != model_cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size {dcfg.vocab_size} != target "
                    f"{model_cfg.vocab_size}: the verify step scores the "
                    f"draft's token ids")
            self.draft_config = dcfg
            if draft_params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed + 1)
                draft_params = init_params(dcfg, gen, self.device, dt)
            self.draft_params = self._cast_tree(draft_params, dt)
            del draft_params
            self.draft_cache = PagedKVCache.create(
                dcfg, num_blocks, sm.kv_block_size, dt, self.device,
                quant=sm.kv_quant)
        self._block_size = sm.kv_block_size
        # recompute-preemption observability: victims taken in steady decode
        # vs mid-(re-)prefill (the latter must keep fold state)
        self.preempt_stats = {"decode_ready": 0, "mid_prefill": 0}
        # device dispatches by kind
        self.dispatches = {"mixed": 0, "decode": 0, "burst": 0, "spec": 0,
                           "spec_draft": 0, "spec_verify": 0}
        # request-level serving telemetry (telemetry/serving.py), on an
        # engine-local registry
        self.telemetry = ServingTelemetry(self.config.telemetry)
        # ---- multi-tenant LoRA adapter pool (serving/adapters.py): A/B
        # pages live as block-granular refcounted residents of the SAME
        # allocator as the KV blocks.  _adapter_slot maps sequence slot ->
        # device-table slot and rides every dispatch when the pool exists
        # (slot 0 = identity).
        ac = self.config.adapters
        self.adapters = None
        self._adapter_slot = np.zeros(sm.max_tracked_sequences, np.int32)
        if ac.enabled:
            from deepspeed_tpu_torch.serving.adapters import AdapterPool
            self.adapters = AdapterPool(
                self.state.allocator, slots=ac.slots, rank=ac.rank,
                hidden=model_cfg.hidden_size,
                num_layers=model_cfg.num_layers,
                q_dim=model_cfg.num_heads * model_cfg.head_dim,
                v_dim=model_cfg.kv_heads * model_cfg.head_dim,
                block_bytes=self.kv_block_bytes(),
                scale=ac.alpha / ac.rank, dtype=dt, device=self.device,
                telemetry=self.telemetry)
            self.state.adapters = self.adapters
        log_dist(f"v2 ragged engine ready on {self.device}: "
                 f"params={count_params(model_cfg) / 1e6:.1f}M "
                 + (f"draft={count_params(self.draft_config) / 1e6:.1f}M "
                    if self.draft_config is not None else "")
                 + f"budget={sm.max_ragged_batch_size}tok "
                 f"slots={sm.max_tracked_sequences} "
                 f"kv_blocks={num_blocks}x{sm.kv_block_size}", ranks=[0])

    def _cast_tree(self, tree, dtype):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and set(v) in ({"v", "s"}, {"v4", "s"}):
                raise TypeError(f"param {k!r} is already a quantized store: "
                                f"pass the unquantized tree and the quant "
                                f"config block")
            if isinstance(v, dict):
                out[k] = self._cast_tree(v, dtype)
            elif not isinstance(v, torch.Tensor):
                raise TypeError(f"param {k!r}: expected a torch.Tensor, got "
                                f"{type(v).__name__} (convert a JAX tree "
                                f"with models.gpt.params_from_numpy)")
            else:
                out[k] = v.to(device=self.device,
                              dtype=dtype if v.is_floating_point()
                              else v.dtype)
        return out

    # ------------------------------------------------ reference put() :107
    def put(self, uids: Sequence[int], tokens_list: Sequence[np.ndarray],
            ) -> np.ndarray:
        """Append tokens to each uid's sequence, run ONE ragged forward,
        return fp32 logits [len(uids), vocab] of each sequence's last
        token."""
        logits = self._put_device(uids, tokens_list)
        slots = [self.state.get(uid).slot for uid in uids]
        return logits.cpu().numpy()[np.asarray(slots)]

    def _put_device(self, uids, tokens_list):
        """put() minus the host transfer: per-SLOT device logits [S, V]."""
        sm = self.config.state_manager
        bs = self.state.block_size
        # validate BEFORE mutating any state, so a rejected put leaves the
        # manager clean
        if len(set(uids)) != len(uids):
            raise ValueError(f"duplicate uids in one put(): {list(uids)}")
        toks_np = [np.asarray(t, np.int32).reshape(-1) for t in tokens_list]
        # radix prefix match (peek only — nothing is acquired until the
        # validation below passes): matched tokens of a NEW sequence alias
        # cached blocks and never enter the batch, so every length and
        # budget check uses the post-match suffix
        matches, pinned, paths = self.state.peek_prefix_batch(
            [None if self.state.get(uid) is not None else toks
             for uid, toks in zip(uids, toks_np)])
        for uid, toks, m in zip(uids, toks_np, matches):
            if len(toks) - m > sm.max_q_per_seq:
                raise ValueError(
                    f"uid {uid}: {len(toks) - m} tokens exceeds max_q_per_seq="
                    f"{sm.max_q_per_seq}; split the prompt (SplitFuse) or use "
                    f"generate()")
            seen = (self.state.get(uid).seen_tokens
                    if self.state.get(uid) else 0)
            if seen + len(toks) > self.model_config.max_seq_len:
                raise ValueError(f"uid {uid} exceeds max_seq_len "
                                 f"{self.model_config.max_seq_len}")
        total = sum(len(t) - m for t, m in zip(toks_np, matches))
        if total > sm.max_ragged_batch_size:
            raise ValueError(f"batch of {total} tokens exceeds ragged budget "
                             f"{sm.max_ragged_batch_size}; check query() first")
        if len(uids) > sm.max_ragged_sequence_count:
            raise ValueError(f"{len(uids)} sequences exceeds "
                             f"max_ragged_sequence_count="
                             f"{sm.max_ragged_sequence_count}")
        new_uids = [u for u in uids if self.state.get(u) is None]
        if len(new_uids) > self.state.free_sequence_slots:
            raise RuntimeError(
                f"{len(new_uids)} new sequences but only "
                f"{self.state.free_sequence_slots} free slots; flush() first")
        # fresh blocks plus the evictable supply the matches would pin
        blocks_needed = pinned + sum(
            (self.state.get(u).kv_blocks_needed(len(t), bs)
             if self.state.get(u) else -(-len(t) // bs) - m // bs)
            for u, t, m in zip(uids, toks_np, matches))
        if blocks_needed > self.state.available_blocks:
            self.telemetry.alloc_failure("put")
            raise RuntimeError(
                f"batch needs {blocks_needed} KV blocks but only "
                f"{self.state.available_blocks} free; check query() first")
        schedule = []
        for uid, toks, path in zip(uids, toks_np, paths):
            seq = self.state.get(uid)
            if seq is None:
                seq = self.state.create(uid)
                # put() serves the base model: clear any previous tenant's
                # adapter selection left on this recycled slot
                self._adapter_slot[seq.slot] = 0
                if self.state.radix is not None:
                    seq.host_tokens = toks
                    # the validation walk is still valid: nothing mutated
                    # the trie since peek_prefix_batch
                    matched = self.state.match_prefix(seq, toks, path=path)
                    self.telemetry.prefix_lookup(matched)
                    toks = toks[matched:]
            elif (self.state.radix is not None
                  and len(seq.host_tokens) == seq.seen_tokens):
                # contiguous host-known content keeps extending the radix
                # insert key; a device-fed gap stops it for good
                seq.host_tokens = np.concatenate([seq.host_tokens, toks])
            schedule.append((seq, toks))
        # blocks are reserved only after EVERY match holds its blocks: an
        # eviction for one sequence must never reclaim blocks another
        # sequence of this batch just matched
        for seq, toks in schedule:
            self.state.ensure_blocks(seq, len(toks))
        for _, toks in schedule:
            self.telemetry.tokens("prefill" if len(toks) > 1 else "decode",
                                  len(toks))
        rb = build_ragged_batch(schedule, self.state,
                                sm.max_ragged_batch_size, sm.max_q_per_seq)
        logits = self._run(rb)
        for seq, toks in schedule:
            seq.seen_tokens += len(toks)
            # index newly completed full blocks (the forward filling them is
            # already queued on the stream, ahead of any later reader)
            self.state.cache_insert(seq)
        self.telemetry.kv_sample(self.state)
        return logits

    def _live_table(self, rb: RaggedBatch) -> np.ndarray:
        """The batch's block table cut to the columns that cover its longest
        live KV.  The decode kernel's split count, and its grid, scale with
        the table's width, so a step must not pass ``max_blocks_per_seq``
        columns that no slot uses."""
        mb = max(1, -(-int(rb.kv_len.max()) // self._block_size))
        return rb.block_table[:, :mb]

    def _slot_table(self, seqs) -> np.ndarray:
        """Slot-indexed block table [S, mb] of ``seqs``, ``mb`` the most
        blocks any of them holds (see _live_table)."""
        bt = np.zeros((self.state.max_tracked_sequences,
                       max([1] + [len(s.blocks) for s in seqs])), np.int32)
        for s in seqs:
            bt[s.slot, :len(s.blocks)] = s.blocks
        return bt

    def _mixed_batch(self, rb: RaggedBatch, from_device=None, served=None):
        """The step's device batch, cut to its live width: ``mb`` table
        columns cover the longest live KV and ``nb`` packed rows the live
        tokens — a small step must not pay for the full ragged budget.  (The
        JAX engine rounds both up to powers of two to bound its compile
        cache; eager steps need no rounding, so the bucket's padding waste
        is 0.)"""
        nb = max(1, rb.total_tokens)
        self.telemetry.padding_waste(rb.total_tokens, nb)
        arrays = {"tokens": rb.tokens[:nb], "token_slot": rb.token_slot[:nb],
                  "token_pos": rb.token_pos[:nb],
                  "token_dense_idx": rb.token_dense_idx[:nb],
                  "block_table": self._live_table(rb),
                  "kv_len": rb.kv_len}
        if from_device is not None:
            arrays["from_device"] = from_device[:nb]    # per token
            arrays["served"] = served                   # per slot
        return self._with_lora(arrays)

    def _with_lora(self, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """A dispatch's host arrays on the device (``_to_device``, no sync)
        plus, when the engine has an adapter pool, the per-slot adapter
        selection (copied with the batch) and the pool's tables (JAX
        ``_with_lora`` :689).  An adapter-less engine adds NO keys, so its
        forward runs exactly the base model's code."""
        if self.adapters is None:
            return _to_device(arrays, self.device)
        batch = _to_device({**arrays,
                            "adapter_slot": self._adapter_slot.copy()},
                           self.device)
        batch["lora"] = self.adapters.tables()
        return batch

    def _run(self, rb: RaggedBatch) -> torch.Tensor:
        """A decode-only step (every slot one token) runs the paged decode
        path; anything else the mixed ragged path."""
        sm = self.config.state_manager
        if int(rb.q_len.max()) <= 1:
            return self._run_decode(rb)
        batch = self._mixed_batch(rb)
        self.dispatches["mixed"] += 1
        self.telemetry.dispatch("mixed")
        with torch.no_grad(), self.telemetry.span(
                "mixed_dispatch", tokens=rb.total_tokens,
                bucket=max(1, rb.total_tokens), seqs=len(rb.logits_slots)):
            logits, self.cache = ragged_forward(
                self.params, self.cache, batch, self.model_config,
                block_size=self._block_size, max_q_per_seq=sm.max_q_per_seq)
        return logits

    def _run_decode(self, rb: RaggedBatch) -> torch.Tensor:
        S = self.state.max_tracked_sequences
        tokens = np.zeros(S, np.int32)
        active = np.zeros(S, bool)
        token_pos = np.zeros(S, np.int32)
        for i in range(rb.total_tokens):
            sl = rb.token_slot[i]
            tokens[sl] = rb.tokens[i]
            active[sl] = True
            token_pos[sl] = rb.token_pos[i]
        batch = self._with_lora({"tokens": tokens, "active": active,
                                 "token_pos": token_pos,
                                 "block_table": self._live_table(rb)})
        self.dispatches["decode"] += 1
        self.telemetry.dispatch("decode")
        with torch.no_grad(), self.telemetry.span("decode_dispatch",
                                                  seqs=rb.total_tokens):
            logits, self.cache = ragged_decode_forward(
                self.params, self.cache, batch, self.model_config,
                block_size=self._block_size)
        return logits

    def _sample_fn(self, gen):
        return functools.partial(_sample_token, do_sample=gen.do_sample,
                                 top_k=gen.top_k)

    def _spec_active(self, gen) -> bool:
        """Speculative decoding runs whenever a draft is loaded: greedy uses
        exact-match acceptance (the target's own tokens), sampling uses
        rejection sampling (exactly target-distributed) — both correct for
        ANY draft (JAX engine_v2.py:767)."""
        return self.draft_params is not None

    def _slot_batch(self, reqs, steps: int):
        """Slot-indexed burst inputs for the running set, reserving blocks
        for ``steps`` more tokens each."""
        S = self.state.max_tracked_sequences
        tokens0 = np.zeros(S, np.int32)
        from_device = np.zeros(S, bool)
        active = np.zeros(S, bool)
        pos0 = np.zeros(S, np.int32)
        seqs = []
        for r in reqs:
            seq = self.state.get(r.uid)
            self.state.ensure_blocks(seq, steps)
            seqs.append(seq)
            sl = seq.slot
            if r.held_token is not None:
                tokens0[sl] = r.held_token
                r.held_token = None
            else:
                from_device[sl] = True
            active[sl] = True
            pos0[sl] = seq.seen_tokens
        return self._with_lora({"tokens0": tokens0,
                                "from_device": from_device,
                                "active": active, "pos0": pos0,
                                "block_table": self._slot_table(seqs)})

    def _run_spec(self, reqs, outer: int, gamma: int, gen, prev, generator):
        """One fused draft-and-verify dispatch over ``reqs`` (JAX
        engine_v2.py:774), then ONE sync to learn the per-step acceptance
        counts: the host cannot schedule past a speculative burst without
        them.  Returns (toks [outer, gamma+1, S], counts [outer, S] numpy,
        prev')."""
        batch = self._slot_batch(reqs, outer * (gamma + 1))
        stel = self.telemetry
        profile = bool(self.config.speculative.profile)
        t_begin = stel.now()
        if profile:
            toks_h, counts_h, prev = self._run_spec_split(
                batch, outer, gamma, gen, prev, generator)
        else:
            with torch.no_grad(), stel.span("spec_dispatch", outer=outer,
                                             gamma=gamma, seqs=len(reqs)):
                if gen.do_sample:
                    toks, counts, prev = speculative_burst_sampled(
                        self.params, self.draft_params, self.cache,
                        self.draft_cache, batch, prev, generator,
                        gen.temperature, gen.top_p, self.model_config,
                        self.draft_config, block_size=self._block_size,
                        gamma=gamma, steps=outer, top_k=gen.top_k)
                else:
                    toks, counts, prev = speculative_burst(
                        self.params, self.draft_params, self.cache,
                        self.draft_cache, batch, prev, self.model_config,
                        self.draft_config, block_size=self._block_size,
                        gamma=gamma, steps=outer)
            self.dispatches["spec"] += 1
            stel.dispatch("spec")
            # THE sync of the speculative path (the JAX engine's too)
            toks_h, counts_h = _fetch(toks, counts)
        emitted = int(counts_h[:, [self.state.get(r.uid).slot
                                   for r in reqs]].sum())
        # spec_burst_ms_total is fused-dispatch wall time by definition; a
        # profiled run's fenced times land in the draft / verify counters
        stel.spec_burst(outer=outer, n_seqs=len(reqs), gamma=gamma,
                        emitted=emitted,
                        dur_ms=(0.0 if profile
                                else (stel.now() - t_begin) * 1e3))
        stel.tokens("spec", emitted)
        return toks_h, counts_h, prev

    def _run_spec_split(self, batch, outer: int, gamma: int, gen, prev,
                        generator):
        """Split-profile speculative path (``speculative.profile``; JAX
        engine_v2.py:861): each outer step runs the draft, fences, runs the
        verify and syncs its counts; the wall time of each side feeds
        ``spec_draft_ms_total`` / ``spec_verify_ms_total``.  The same tokens
        as the fused burst (same acceptance functions), slower: the fences
        ARE the measurement.  Returns (toks_h, counts_h, prev')."""
        stel = self.telemetry
        sampled = bool(gen.do_sample)
        sub = {k: batch[k] for k in ("active", "block_table")}
        pos = batch["pos0"]
        tokens0, from_device = batch["tokens0"], batch["from_device"]
        toks_list, counts_list = [], []
        for k in range(outer):
            step_b = {**sub, "tokens0": tokens0, "from_device": from_device}
            t0 = stel.now()
            with torch.no_grad(), stel.span("spec_draft_dispatch",
                                            outer_index=k, gamma=gamma):
                d, q = speculative_draft_step(
                    self.draft_params, self.draft_cache, step_b, prev, pos,
                    generator, gen.temperature, gen.top_p, self.draft_config,
                    block_size=self._block_size, gamma=gamma,
                    top_k=gen.top_k, sampled=sampled)
                self._stream_fence(d)       # the split IS the measurement
            t1 = stel.now()
            with torch.no_grad(), stel.span("spec_verify_dispatch",
                                            outer_index=k, gamma=gamma):
                emit, counts, prev, pos = speculative_verify_step(
                    self.params, self.cache, step_b, d, q, prev, pos,
                    generator, gen.temperature, gen.top_p, self.model_config,
                    block_size=self._block_size, gamma=gamma,
                    top_k=gen.top_k, sampled=sampled)
                emit_h, counts_h = _fetch(emit, counts)
            for kind in ("spec_draft", "spec_verify"):
                self.dispatches[kind] += 1
                stel.dispatch(kind)
            stel.spec_profile((t1 - t0) * 1e3, (stel.now() - t1) * 1e3)
            toks_list.append(emit_h.T)                  # [gamma+1, S]
            counts_list.append(counts_h)
            # later outer steps seed from the device-resident prev
            from_device = torch.ones_like(from_device)
        return np.stack(toks_list), np.stack(counts_list), prev

    def _run_burst(self, reqs, steps: int, gen, prev, generator):
        """Fused T-step decode over the running set (see
        model.ragged_decode_burst).  Each req's first-step token comes from
        ``held_token`` (host, post-preempt) or from the ``prev`` device
        feedback vector.  Returns (tokens [T, S] on the device, prev') — no
        host sync."""
        batch = self._slot_batch(reqs, steps)
        self.dispatches["burst"] += 1
        self.telemetry.dispatch("burst")
        with torch.no_grad(), self.telemetry.span("burst_dispatch",
                                                  steps=steps,
                                                  seqs=len(reqs)):
            toks, prev = ragged_decode_burst(
                self.params, self.cache, batch, prev, generator,
                gen.temperature, gen.top_p, self.model_config,
                block_size=self._block_size, steps=steps,
                sample_fn=self._sample_fn(gen))
        self.telemetry.tokens("decode", steps * len(reqs))
        for r in reqs:
            self.state.get(r.uid).seen_tokens += steps
        return toks, prev

    def _step_sampled(self, uids, toks_np, from_device, served_slots, gen,
                      prev, generator):
        """One scheduled step through the SAMPLED paths: the schedule of
        _put_device with on-device sampling and token feedback — returns
        prev', never touching the host.  ``from_device`` marks tokens whose
        VALUE lives in prev[slot]; ``served_slots`` are the slots whose
        freshly sampled token is written into prev'.  With a draft loaded,
        the draft ingests the same tokens in lockstep (dual prefill / dual
        decode) so later speculative rounds find its pages complete."""
        sm = self.config.state_manager
        S = self.state.max_tracked_sequences
        schedule = []
        for uid, toks in zip(uids, toks_np):
            seq = self.state.get(uid)
            if seq is None:
                seq = self.state.create(uid)
                self._adapter_slot[seq.slot] = 0
            self.state.ensure_blocks(seq, len(toks))
            schedule.append((seq, toks))
        served = np.zeros(S, bool)
        served[list(served_slots)] = True
        sample_fn = self._sample_fn(gen)
        draft = self._spec_active(gen)
        common = dict(block_size=self._block_size, sample_fn=sample_fn)
        if max(len(t) for t in toks_np) <= 1:
            # decode-only: slot-indexed [S] step
            tokens = np.zeros(S, np.int32)
            active = np.zeros(S, bool)
            token_pos = np.zeros(S, np.int32)
            fdev = np.zeros(S, bool)
            for (seq, toks), fd in zip(schedule, from_device):
                sl = seq.slot
                tokens[sl] = toks[0]
                active[sl] = True
                fdev[sl] = fd
                token_pos[sl] = seq.seen_tokens
            batch = self._with_lora({"tokens": tokens, "active": active,
                                     "token_pos": token_pos,
                                     "block_table": self._slot_table(
                                         [seq for seq, _ in schedule]),
                                     "from_device": fdev, "served": served})
            kind = "decode"
            if draft:
                fn = functools.partial(
                    ragged_decode_sampled_draft, self.params,
                    self.draft_params, self.cache, self.draft_cache,
                    cfg=self.model_config, draft_cfg=self.draft_config,
                    **common)
            else:
                fn = functools.partial(ragged_decode_sampled, self.params,
                                       self.cache, cfg=self.model_config,
                                       **common)
        else:
            rb = build_ragged_batch(schedule, self.state,
                                    sm.max_ragged_batch_size, sm.max_q_per_seq)
            fdev = np.zeros(rb.tokens.shape[0], bool)
            i = 0
            for (seq, toks), fd in zip(schedule, from_device):
                fdev[i:i + len(toks)] = fd
                i += len(toks)
            batch = self._mixed_batch(rb, fdev, served)
            kind = "mixed"
            common["max_q_per_seq"] = sm.max_q_per_seq
            if draft:
                fn = functools.partial(
                    ragged_forward_sampled_draft, self.params,
                    self.draft_params, self.cache, self.draft_cache,
                    cfg=self.model_config, draft_cfg=self.draft_config,
                    **common)
            else:
                fn = functools.partial(ragged_forward_sampled, self.params,
                                       self.cache, cfg=self.model_config,
                                       **common)
        self.dispatches[kind] += 1
        self.telemetry.dispatch(kind)
        span_args = {"draft": True} if draft else {}
        with torch.no_grad(), self.telemetry.span(
                f"{kind}_dispatch", seqs=len(schedule), **span_args):
            prev = fn(batch, prev, generator, gen.temperature, gen.top_p)
        for seq, toks in schedule:
            seq.seen_tokens += len(toks)
        return prev

    # ----------------------------------------- reference query()/can_schedule
    def query(self) -> Dict[str, int]:
        """KV/slot headroom (reference engine_v2.query :158); also refreshes
        the telemetry's KV-pool gauges."""
        sm = self.config.state_manager
        self.telemetry.kv_sample(self.state)
        used = (self.state.allocator.num_blocks
                - self.state.allocator.free_blocks)
        radix = self.state.radix
        return {
            "free_kv_blocks": self.state.allocator.free_blocks,
            "used_kv_blocks": used,
            # supply a scheduler can count on: free + LRU-evictable cached
            "available_kv_blocks": self.state.available_blocks,
            "cached_kv_blocks": radix.node_count if radix is not None else 0,
            "free_sequence_slots": self.state.free_sequence_slots,
            "token_budget": sm.max_ragged_batch_size,
            "max_q_per_seq": sm.max_q_per_seq,
            "kv_block_size": self._block_size,
        }

    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> bool:
        """reference engine_v2.can_schedule :184.  A rejection for want of
        blocks or slots counts into ``kv_alloc_failures_total``."""
        sm = self.config.state_manager
        if (sum(lengths) > sm.max_ragged_batch_size
                or len(uids) > sm.max_ragged_sequence_count):
            self.telemetry.alloc_failure("can_schedule")
            return False
        blocks = slots = 0
        for uid, n in zip(uids, lengths):
            seq = self.state.get(uid)
            if seq is None:
                slots += 1
                blocks += -(-n // self.state.block_size)
            else:
                blocks += seq.kv_blocks_needed(n, self.state.block_size)
        ok = (blocks <= self.state.available_blocks
              and slots <= self.state.free_sequence_slots)
        if not ok:
            self.telemetry.alloc_failure("can_schedule")
        return ok

    def flush(self, uids: Sequence[int]) -> None:
        """reference engine_v2.flush :242."""
        for uid in uids:
            self.state.flush(uid)

    def prefix_cached_tokens(self, prompt) -> int:
        """Longest radix-cached block-aligned prefix of ``prompt`` resident
        on this engine, in tokens (0 with the cache off).  Read-only: no
        LRU stamp freshened, no reference taken (JAX engine_v2.py:1169)."""
        radix = self.state.radix
        if radix is None:
            return 0
        return radix.peek(np.asarray(prompt, np.int32).reshape(-1))

    def prefix_block_handles(self, prompt) -> Tuple[List[int], int]:
        """(pool block ids, matched token count) of ``prompt``'s longest
        radix-cached block-aligned prefix; read-only like
        :meth:`prefix_cached_tokens`; ([], 0) with the cache off (JAX
        engine_v2.py:1181)."""
        radix = self.state.radix
        if radix is None:
            return [], 0
        return radix.peek_blocks(np.asarray(prompt, np.int32).reshape(-1))

    # ------------------------------------------------ multi-tenant LoRA
    def register_adapter(self, adapter_id: int, weights=None) -> None:
        """Make a LoRA adapter id loadable on this engine (host-side only;
        pool blocks and device traffic happen when a request first selects
        the id).  ``weights=None`` generates deterministic per-id weights
        (JAX engine_v2.py:1195)."""
        if self.adapters is None:
            raise ValueError(
                "this engine has no adapter pool; enable config.adapters")
        self.adapters.register(adapter_id, weights)

    def adapter_resident(self, adapter_ids) -> int:
        """How many of ``adapter_ids`` have their pages resident on this
        engine right now (0 with adapters off; id 0 never counts).  A
        read-only host dict peek (JAX engine_v2.py:1205)."""
        if self.adapters is None:
            return 0
        return self.adapters.resident_count(adapter_ids)

    def kv_block_bytes(self) -> int:
        """Bytes one KV pool block holds (K + V across layers) at the
        SERVING dtype's itemsize — also with int8 KV, as the JAX engine
        counts it (engine_v2.py:1217), so that ``blocks_per_adapter``
        equals the JAX pool's."""
        mc = self.model_config
        itemsize = torch.empty((), dtype=self.config.torch_dtype
                               ).element_size()
        return int(2 * mc.num_layers * mc.kv_heads * self._block_size
                   * mc.head_dim * itemsize)

    # ------------------------------- continuous batching (Dynamic SplitFuse)
    def _stream_fence(self, value: torch.Tensor) -> None:
        """Wait until the step that produced ``value`` has finished on the
        card — an event recorded on the current stream after it, waited on
        by the host, never a synchronisation of the whole device — so that
        the timestamp taken next reflects device completion (the point a
        streaming server could emit the token).  Opt-in (``stream`` /
        ``telemetry.stream_sync``, and the profile mode's draft fence); the
        throughput path never fences."""
        if value.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(value.device))
        ev.synchronize()

    def _finish_request(self, r: _Request, outcome: str = "completed"):
        """Record one retired request into the serving telemetry, once."""
        if r.finished:
            return
        r.finished = True
        self.telemetry.finish_request(
            uid=r.uid, track=r.track, t_arrival=r.t_arrival,
            t_admit=r.t_admit, t_prefill_end=r.t_prefill_end,
            t_first=r.t_first, t_last=r.t_last,
            n_prompt=len(r.prompt) - r.folded,
            n_generated=len(r.generated), preempts=r.preempts,
            outcome=outcome, trace=r.trace)

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens=32, seed: int = 0,
                 arrival_times: Optional[Sequence[float]] = None,
                 now_fn=None, stream: Optional[bool] = None,
                 sla: Optional[Sequence[str]] = None,
                 adapter_ids: Optional[Sequence[int]] = None,
                 trace_ctx: Optional[Sequence[Any]] = None,
                 **gen_overrides) -> List[np.ndarray]:
        """Serve a set of prompts to completion with continuous batching.

        Dynamic SplitFuse: every step first schedules 1 token for each
        running decode, then fills the remaining token budget with prompt
        chunks (long prompts split across steps); new requests are admitted
        as slots/blocks free up; when every running sequence is decoding and
        nothing can be admitted, T decode steps fuse into one burst — or,
        with a draft loaded, draft-and-verify rounds fuse into one
        speculative dispatch.  A pool too small for the running set
        recompute-preempts the most recently admitted request (token-exact
        fold-back).

        The token feedback loop is DEVICE-RESIDENT; token VALUES are
        fetched in bulk — once at the end when no eos_token_id is set, else
        every ``sync_interval`` (16) steps; tokens past an EOS are
        discarded at materialize time.  A speculative dispatch syncs once to
        learn its acceptance counts.

        max_new_tokens: int, or one int per prompt.  arrival_times:
        open-loop mode — per-prompt arrival offsets in seconds from call
        start; requests become admittable once their arrival passes.
        ``now_fn`` overrides the clock (a fake clock must advance).
        ``stream`` fences each dispatch before its timestamps (default
        ``telemetry.stream_sync``) so that TTFT / TPOT reflect device
        completion.

        sla: one ``scheduler.sla_classes`` name per prompt (default: the
        implicit ``default`` class, priority 0, no SLO).  Priority orders
        admission; a waiting request that has burned
        ``scheduler.preempt_margin`` of its ``ttft_slo_ms`` and still
        cannot be admitted preempts the most recently admitted
        lower-priority running request.

        adapter_ids: one LoRA adapter id per prompt (0 / omitted = base
        model).  Adapters must be :meth:`register_adapter`-ed; pages load
        at admission and are pinned for the request's life, and every
        dispatch carries a per-token adapter selection, so a mixed-adapter
        batch still runs ONE forward.  An id that can never fit (unknown,
        or larger than the pool next to the request's KV) raises
        ``ValueError`` before anything runs.

        trace_ctx: one distributed TraceContext per prompt (or None
        entries), carried on the request's lifecycle spans; absent, local
        flowless contexts are made when tracing is on."""
        known = {f.name for f in dataclasses.fields(GenerationConfig)}
        bad = sorted(set(gen_overrides) - known)
        if bad:
            raise TypeError(f"unknown generation options {bad}; expected "
                            f"some of {sorted(known)}")
        gen = self.config.generation.model_copy(update=gen_overrides)
        sm = self.config.state_manager
        S = self.state.max_tracked_sequences
        stel = self.telemetry
        now_fn = now_fn if now_fn is not None else stel.now
        stream = stel.stream_sync if stream is None else bool(stream)
        if isinstance(max_new_tokens, (int, np.integer)):
            max_list = [int(max_new_tokens)] * len(prompts)
        else:
            max_list = [int(m) for m in max_new_tokens]
            if len(max_list) != len(prompts):
                raise ValueError("max_new_tokens list must match prompts")
        if (arrival_times is not None
                and len(arrival_times) != len(prompts)):
            raise ValueError("arrival_times must match prompts")
        sched_cfg = self.config.scheduler
        classes = dict(sched_cfg.sla_classes)
        classes.setdefault("default", SLAClassConfig())
        if sla is not None and len(sla) != len(prompts):
            raise ValueError("sla list must match prompts")
        for name in (sla or ()):
            if name not in classes:
                raise ValueError(f"unknown SLA class {name!r}; expected one "
                                 f"of {sorted(classes)}")
        if trace_ctx is not None and len(trace_ctx) != len(prompts):
            raise ValueError("trace_ctx list must match prompts")
        if adapter_ids is not None:
            if len(adapter_ids) != len(prompts):
                raise ValueError("adapter_ids list must match prompts")
            if self.adapters is None and any(int(a) for a in adapter_ids):
                raise ValueError(
                    "adapter_ids passed but this engine has no adapter "
                    "pool; enable config.adapters")
        t_start = now_fn()
        waiting = []
        for i, (p, m) in enumerate(zip(prompts, max_list)):
            cls = sla[i] if sla is not None else "default"
            waiting.append(_Request(
                uid=-(i + 1), prompt=np.asarray(p, np.int32).reshape(-1),
                max_new_tokens=m,
                adapter=(int(adapter_ids[i]) if adapter_ids is not None
                         else 0),
                sla=cls, priority=classes[cls].priority,
                ttft_slo_ms=classes[cls].ttft_slo_ms))
        # the SLA machinery only engages when some request differs from the
        # default class: the FIFO paths stay as they were
        has_sla = any(r.priority != 0 or r.ttft_slo_ms > 0 for r in waiting)
        pool_blocks = self.state.allocator.num_blocks
        for i, r in enumerate(waiting):
            r.track = stel.new_track(f"req {i}")
            if trace_ctx is not None and trace_ctx[i] is not None:
                r.trace = trace_ctx[i]
            elif stel.enabled:
                # a local root context (no flow: a single engine's trace has
                # no cross-file hop to stitch)
                from deepspeed_tpu_torch.telemetry import tracecontext
                r.trace = tracecontext.new_trace(with_flow=False)
            r.t_arrival = t_start + (float(arrival_times[i])
                                     if arrival_times is not None else 0.0)
            if (len(r.prompt) + r.max_new_tokens
                    > self.model_config.max_seq_len):
                raise ValueError(f"prompt {len(r.prompt)} + "
                                 f"{r.max_new_tokens} exceeds max_seq_len")
            need = -(-(len(r.prompt) + r.max_new_tokens)
                     // self.state.block_size)
            if need > pool_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks for its full context but "
                    f"the pool holds {pool_blocks}; raise num_kv_blocks "
                    f"(recompute-preemption cannot make a single sequence fit)")
            if r.adapter and self.adapters is not None:
                # a permanently unservable adapter id is a CLIENT error —
                # reject at dispatch, never loop in admission
                bad = self.adapters.unfittable_reason(r.adapter)
                if bad:
                    raise ValueError(f"prompt {i}: {bad}")
                if need + self.adapters.blocks_per_adapter > pool_blocks:
                    # the request's own pinned adapter pages shrink the pool
                    # its KV must fit in — unservable at any load
                    raise ValueError(
                        f"prompt {i}: {need} KV blocks + "
                        f"{self.adapters.blocks_per_adapter} adapter-page "
                        f"blocks exceed the {pool_blocks}-block pool; raise "
                        f"num_kv_blocks")
        running: List[_Request] = []
        results: Dict[int, _Request] = {r.uid: r for r in waiting}
        incoming: List[_Request] = []
        if arrival_times is not None:
            waiting.sort(key=lambda r: r.t_arrival)
            incoming, waiting = waiting, []

        eos = gen.eos_token_id
        sync_interval = 16 if eos is not None else None
        prev = torch.zeros(S, dtype=torch.int32, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        # device records: ("step", prev [S], [(uid, slot)]) or
        # ("burst", toks [T, S], [(uid, slot)]) — fetched in ONE transfer
        records: List[tuple] = []
        # requests retired while their tokens still sat in device records:
        # telemetry-finished at the next materialize, when .generated is
        # exact
        pending_finish: List[_Request] = []
        steps_since_sync = 0

        def _append(r: _Request, toks) -> None:
            for tok in toks:
                if r.eos_hit or len(r.generated) >= r.max_new_tokens:
                    return                      # discard overshoot
                r.generated.append(int(tok))
                if eos is not None and int(tok) == eos:
                    r.eos_hit = True
                    r.done = True

        def materialize() -> None:
            """Fetch every pending device record (one .cpu()), fill
            .generated, and retire sequences whose EOS was discovered."""
            nonlocal steps_since_sync
            steps_since_sync = 0
            if records:
                arrs = _fetch(*(rec[1] for rec in records))
                for (kind, _, pairs), vals in zip(records, arrs):
                    for uid, sl in pairs:
                        _append(results[uid],
                                [vals[sl]] if kind == "step" else vals[:, sl])
                records.clear()
                for r in list(running):
                    if r.done:                  # EOS found on materialize
                        self.flush([r.uid])
                        running.remove(r)
                        pending_finish.append(r)
            # retired requests reach their final .generated here
            for r in pending_finish:
                self._finish_request(r)
            pending_finish.clear()

        def preempt(victim: _Request, reason: str) -> None:
            """Recompute-preempt one RUNNING request: free its blocks and
            re-queue it with its full folded context; its re-prefill logits
            are not re-sampled (resume).  ``reason`` is ``starvation`` (pool
            deadlock) or ``sla`` (a higher-priority waiting request would
            miss its TTFT SLO).  Callers materialize first so ``generated``
            is exact at the fold."""
            running.remove(victim)
            kind = ("mid_prefill" if not victim.decode_ready
                    else "decode_ready")
            self.preempt_stats[kind] += 1
            stel.preemption(kind)
            if reason == "sla":
                stel.sla_preemption(victim.sla)
            victim.preempts += 1
            if victim.decode_ready:
                # fold generated-but-not-yet-refed tokens into the prompt
                # exactly once (the last sampled token is NOT folded — it
                # replays as a decode via held_token)
                keep = victim.sampled - 1
                new_ctx = victim.generated[victim.folded:keep]
                if new_ctx:
                    victim.prompt = np.concatenate(
                        [victim.prompt, np.asarray(new_ctx, np.int32)])
                victim.folded = keep
                victim.resume = True
                victim.held_token = victim.generated[keep]
                victim.decode_ready = False
            # else: preempted mid-(re-)prefill — folded/resume/held_token
            # already describe everything sampled; recycle unchanged
            self.state.flush(victim.uid)
            waiting.insert(0, victim)

        def retire(r: _Request) -> None:
            """A request that reached its budget: its slot is freed now and
            its telemetry recorded at the next materialize."""
            r.done = True
            self.flush([r.uid])
            running.remove(r)
            pending_finish.append(r)

        burst_sizes = (64, 32, 16, 8)
        while waiting or running or incoming:
            now = now_fn()
            while incoming and incoming[0].t_arrival <= now:
                waiting.append(incoming.pop(0))
            if not waiting and not running:
                # open-loop idle: flush pending records, then sleep to the
                # next arrival (a fake now_fn just re-polls)
                materialize()
                if now_fn is stel.now:
                    time.sleep(max(0.0, incoming[0].t_arrival - now_fn()))
                continue
            stel.kv_sample(self.state)
            stel.occupancy(len(running), S)
            # ---- SLA-aware admission order and preemption (JAX
            # engine_v2.py:1605): waiting sorts by priority (stable: FIFO
            # within a class, a re-queued victim first among its peers).
            # When the head has burned preempt_margin of its TTFT SLO and
            # STILL cannot be admitted, the most recently admitted
            # lower-priority running request is recompute-preempted for it
            if has_sla and waiting:
                waiting.sort(key=lambda r: -r.priority)
                head = waiting[0]
                lows = [r for r in running if r.priority < head.priority]
                at_risk = (sched_cfg.sla_preempt and head.ttft_slo_ms > 0
                           and (now - head.t_arrival) * 1e3
                           >= sched_cfg.preempt_margin * head.ttft_slo_ms)
                if lows and at_risk:
                    m, pin = self.state.peek_prefix_pinned(head.prompt)
                    # size the probe as the admission loop sizes the head's
                    # first chunk
                    first = min(len(head.prompt) - m, sm.max_q_per_seq,
                                sm.max_ragged_batch_size,
                                sm.prefill_chunk_tokens
                                or sm.max_ragged_batch_size)
                    need = (-(-(m + first) // self.state.block_size)
                            - m // self.state.block_size + pin)
                    if (self.state.free_sequence_slots == 0
                            or need > self.state.available_blocks):
                        if records:
                            materialize()   # exact .generated at the fold
                            continue
                        low_p = min(r.priority for r in lows)
                        victim = [r for r in lows if r.priority == low_p][-1]
                        stel.admission(head.sla, decision="preempted_for")
                        preempt(victim, "sla")
                        continue

            decode_only = (
                running
                and (not waiting or self.state.free_sequence_slots == 0)
                and all(r.decode_ready and not r.done for r in running)
                and all(not self.state.get(r.uid).in_flight
                        for r in running))
            # ---- speculative draft-and-verify fast path: the decode
            # burst's eligibility, taken whenever a draft is loaded.  Each
            # outer step yields 1..gamma+1 tokens a slot; the host syncs
            # after the dispatch (it cannot schedule without the acceptance
            # counts), which also materializes EOS
            if decode_only and self._spec_active(gen):
                sp = self.config.speculative
                worst = sp.gamma + 1            # tokens per outer step, max
                n_before = len(running)
                materialize()                   # keep .generated in order
                if len(running) != n_before:
                    continue        # EOS retirements changed the set
                groups = ([list(running)] if sp.batch_across_requests
                          else [[r] for r in list(running)])
                ran_any = False
                for grp in groups:
                    grp = [r for r in grp if r in running]
                    if not grp:
                        continue
                    need_max = max(r.max_new_tokens - r.sampled for r in grp)
                    cap = min(self.model_config.max_seq_len
                              - self.state.get(r.uid).seen_tokens
                              for r in grp)
                    # size for ~half acceptance (2x the full-acceptance
                    # need), rounded DOWN to a power of two as the JAX
                    # engine does for its compile cache (the same rounds,
                    # so the same counters)
                    outer = min(sp.outer_steps, 2 * -(-need_max // worst),
                                cap // worst)
                    if outer >= 1:
                        outer = 1 << (outer.bit_length() - 1)
                    while outer >= 1:
                        need = sum(self.state.get(r.uid).kv_blocks_needed(
                            outer * worst, self.state.block_size)
                            for r in grp)
                        if need <= self.state.available_blocks:
                            break
                        outer //= 2
                    if outer < 1:
                        continue
                    ran_any = True
                    pairs = [(r.uid, self.state.get(r.uid).slot)
                             for r in grp]
                    toks_h, counts_h, prev = self._run_spec(
                        grp, outer, sp.gamma, gen, prev, generator)
                    tnow = now_fn()     # _run_spec synced: completion time
                    for r, (uid, sl) in zip(list(grp), pairs):
                        total = int(counts_h[:, sl].sum())
                        self.state.get(uid).seen_tokens += total
                        vals = []
                        for k in range(outer):
                            c = int(counts_h[k, sl])
                            vals.extend(int(t) for t in toks_h[k, :c, sl])
                        _append(r, vals)
                        r.sampled += total
                        if total:
                            if r.t_first is None:
                                r.t_first = tnow
                            r.t_last = tnow
                        if r.done or r.sampled >= r.max_new_tokens:
                            r.done = True
                            self.flush([r.uid])
                            running.remove(r)
                            self._finish_request(r)
                if ran_any:
                    continue

            # ---- decode-burst fast path: every running sequence is in pure
            # decode and no slot is admittable -> fuse T steps.  With
            # requests WAITING the burst targets the earliest retirement;
            # otherwise it covers the longest remaining budget.  Overshoot
            # tokens of sequences finishing mid-burst are discarded.  Off
            # while a draft is loaded: a plain burst would advance the
            # target without the draft, leaving holes in the draft's pages
            if decode_only and not self._spec_active(gen):
                rem_max = max(r.max_new_tokens - r.sampled for r in running)
                if waiting:
                    # floor the burst so retirements CLUMP and one fat
                    # admission step refills the freed slots
                    rem_min = min(r.max_new_tokens - r.sampled
                                  for r in running)
                    need_max = max(rem_min, min(16, rem_max))
                else:
                    need_max = rem_max
                if sync_interval:
                    # budget against the NEXT materialize point so EOS
                    # overshoot stays ~sync_interval
                    need_max = min(need_max,
                                   max(1, sync_interval - steps_since_sync))
                cap = min(self.model_config.max_seq_len
                          - self.state.get(r.uid).seen_tokens
                          for r in running)
                target = min(need_max, cap)
                fitting = [b for b in burst_sizes if b <= cap]
                covering = [b for b in fitting if b >= target]
                T = (min(covering) if covering
                     else (max(fitting) if fitting else 0))
                # shrink the burst until its block reservation fits the pool
                while T >= burst_sizes[-1]:
                    need = sum(self.state.get(r.uid).kv_blocks_needed(
                        T, self.state.block_size) for r in running)
                    if need <= self.state.available_blocks:
                        break
                    T //= 2
                if T >= burst_sizes[-1]:
                    pairs = [(r.uid, self.state.get(r.uid).slot)
                             for r in running]
                    toks, prev = self._run_burst(running, T, gen, prev,
                                                 generator)
                    if stream:
                        self._stream_fence(prev)
                    tnow = now_fn()
                    records.append(("burst", toks, pairs))
                    for r in list(running):
                        r.sampled += T
                        if r.t_first is None:
                            r.t_first = tnow
                        r.t_last = tnow
                        if r.sampled >= r.max_new_tokens:
                            retire(r)
                    steps_since_sync += T
                    if sync_interval and steps_since_sync >= sync_interval:
                        materialize()
                    continue

            budget = sm.max_ragged_batch_size
            seq_budget = sm.max_ragged_sequence_count
            prefill_budget = (sm.prefill_chunk_tokens
                              if sm.prefill_chunk_tokens else budget)
            sched_uids: List[int] = []
            sched_toks: List[np.ndarray] = []
            sched_fdev: List[bool] = []
            served_slots: List[int] = []
            sampled_now: List[_Request] = []
            newly_ready: List[_Request] = []    # prefill completes this step
            n_decode_toks = n_prefill_toks = 0

            # 1) running decodes: one token each
            for r in running:
                seq = self.state.get(r.uid)
                # a resumed request may be decode-ready while its re-prefill
                # is still chunked in (in_flight) — its decode must wait
                if r.done or not r.decode_ready or seq.in_flight:
                    continue
                if budget <= 0 or len(sched_uids) >= seq_budget:
                    break
                need = seq.kv_blocks_needed(1, self.state.block_size)
                if need and need > self.state.available_blocks:
                    stel.alloc_failure("decode")
                    continue            # defers to a later round
                self.state.ensure_blocks(seq, 1)
                sched_uids.append(r.uid)
                if r.held_token is not None:    # post-preempt continuation
                    sched_toks.append(np.asarray([r.held_token], np.int32))
                    sched_fdev.append(False)
                    r.held_token = None
                else:                           # device feedback
                    sched_toks.append(np.zeros(1, np.int32))
                    sched_fdev.append(True)
                served_slots.append(seq.slot)
                sampled_now.append(r)
                budget -= 1
                n_decode_toks += 1

            def take_chunk(r: _Request, seq, chunk: int) -> None:
                nonlocal budget, prefill_budget, n_prefill_toks
                toks, seq.pending = seq.pending[:chunk], seq.pending[chunk:]
                sched_uids.append(r.uid)
                sched_toks.append(toks)
                sched_fdev.append(False)
                n_prefill_toks += chunk
                stel.prefill_chunk()
                prefill_budget -= chunk
                budget -= chunk
                if not seq.in_flight:       # prompt complete -> decode next
                    r.decode_ready = True
                    newly_ready.append(r)
                    if r.resume:
                        r.resume = False    # continuation token already held
                    else:
                        served_slots.append(seq.slot)
                        sampled_now.append(r)

            # 2) prompt chunks fill the rest: running first, then admit new
            for r in list(running):
                seq = self.state.get(r.uid)
                if (seq is None or not seq.in_flight or budget <= 0
                        or prefill_budget <= 0
                        or len(sched_uids) >= seq_budget):
                    continue
                chunk = min(len(seq.pending), sm.max_q_per_seq, budget,
                            prefill_budget)
                need = seq.kv_blocks_needed(chunk, self.state.block_size)
                if need and need > self.state.available_blocks:
                    stel.alloc_failure("prompt_chunk")
                    continue
                self.state.ensure_blocks(seq, chunk)
                take_chunk(r, seq, chunk)

            while (waiting and budget > 0 and prefill_budget > 0
                   and self.state.free_sequence_slots
                   and len(sched_uids) < seq_budget):
                r = waiting.pop(0)
                # radix prefix match FIRST (matching acquires the cached
                # blocks, pinning them against eviction), THEN size and
                # check the uncached suffix; on a shortfall the match is
                # rolled back (flush releases it) and the request retries
                seq = self.state.create(r.uid)
                seq.host_tokens = r.prompt
                matched = self.state.match_prefix(seq, r.prompt)
                if self.adapters is not None:
                    # adapter residency BEFORE sizing: the load may consume
                    # free blocks (evicting cold adapters), and the block
                    # check below must see the pool as it will be when the
                    # chunk dispatches.  A load the pool cannot fit right
                    # now (every slot pinned by in-flight work) rolls back
                    # like a block shortfall and retries when a retirement
                    # releases pins.
                    try:
                        self.state.ensure_adapters([r.adapter])
                    except RuntimeError:
                        stel.alloc_failure("adapter_load")
                        self.state.flush(r.uid)
                        waiting.insert(0, r)
                        break
                    self.state.bind_adapter(seq, r.adapter)
                    self._adapter_slot[seq.slot] = \
                        self.adapters.slot_of(r.adapter)
                chunk = min(len(r.prompt) - matched, sm.max_q_per_seq,
                            budget, prefill_budget)
                if (seq.kv_blocks_needed(chunk, self.state.block_size)
                        > self.state.available_blocks):
                    stel.alloc_failure("admission")
                    self.state.flush(r.uid)
                    waiting.insert(0, r)
                    break
                if self.state.radix is not None:
                    stel.prefix_lookup(matched)
                seq.pending = r.prompt[matched:]
                self.state.ensure_blocks(seq, chunk)
                running.append(r)
                if r.t_admit is None:
                    r.t_admit = now_fn()
                    stel.admission(r.sla)
                take_chunk(r, seq, chunk)

            if not sched_uids:
                # nothing schedulable: first materialize (EOS retirement may
                # free blocks), then preempt the most recently admitted
                # sequence (pool starvation)
                if records:
                    materialize()
                    continue
                if running:
                    preempt(running[-1], "starvation")
                    continue
                raise RuntimeError(
                    "scheduler deadlock: the KV pool cannot fit even one "
                    "sequence; raise num_kv_blocks")

            pairs = [(r.uid, self.state.get(r.uid).slot)
                     for r in sampled_now]
            stel.tokens("decode", n_decode_toks)
            stel.tokens("prefill", n_prefill_toks)
            prev = self._step_sampled(sched_uids, sched_toks, sched_fdev,
                                      served_slots, gen, prev, generator)
            if stream:
                self._stream_fence(prev)
            tnow = now_fn()
            for r in newly_ready:
                r.t_prefill_end = tnow
                # index the completed prompt's full blocks into the radix:
                # the forward that fills them is already queued
                self.state.cache_insert(self.state.get(r.uid))
            if pairs:
                records.append(("step", prev, pairs))
            for r in sampled_now:
                if r.t_first is None:
                    r.t_first = tnow
                r.t_last = tnow
                r.sampled += 1
                if r.sampled >= r.max_new_tokens:
                    retire(r)
            steps_since_sync += 1
            if sync_interval and steps_since_sync >= sync_interval:
                materialize()

        materialize()
        return [np.asarray(results[-(i + 1)].generated, np.int32)
                for i in range(len(prompts))]
