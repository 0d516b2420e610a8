"""Config base — the dataclass counterpart of deepspeed_tpu/config.py
``DeepSpeedConfigModel`` (which is pydantic; the port's machines have no
pydantic).

Same contract: unknown keys are accepted (kept on the instance, as the
reference warns but proceeds), wrong types are rejected, nested config
blocks are built from dicts, and ``parse()`` accepts None, an instance or
a dict.  Subclasses are ``@dataclasses.dataclass`` classes whose field
annotations (``int``, ``float``, ``bool``, ``str``, ``Optional[...]`` or
another config class) drive the validation."""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional


def _check(cls_name: str, name: str, tp, value):
    """Validate/coerce one field value against its annotation."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if value is None:
            return None
        return _check(cls_name, name, args[0], value)
    if isinstance(tp, type) and issubclass(tp, DeepSpeedConfigModel):
        return tp.parse(value)
    if tp is bool:
        if not isinstance(value, bool):
            raise TypeError(f"{cls_name}.{name}: expected bool, got "
                            f"{value!r}")
        return value
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise TypeError(f"{cls_name}.{name}: expected int, got "
                            f"{value!r}")
        return value
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"{cls_name}.{name}: expected float, got "
                            f"{value!r}")
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            raise TypeError(f"{cls_name}.{name}: expected str, got "
                            f"{value!r}")
        return value
    return value


@dataclasses.dataclass
class DeepSpeedConfigModel:
    """Base config (reference: runtime/config_utils.py:16).  Accepts unknown
    keys (stored in ``extra``), rejects bad types."""

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            if f.name == "extra":
                continue
            setattr(self, f.name, _check(type(self).__name__, f.name,
                                         hints[f.name],
                                         getattr(self, f.name)))

    @classmethod
    def model_validate(cls, config: Dict[str, Any]):
        if not isinstance(config, dict):
            raise TypeError(f"{cls.__name__}: expected a dict, got "
                            f"{type(config).__name__}")
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in config.items() if k in names}
        # ``extra`` is set before __init__ so that a __post_init__ check
        # can read the unknown keys
        obj = cls.__new__(cls)
        obj.extra = {k: v for k, v in config.items() if k not in names}
        obj.__init__(**known)
        return obj

    @classmethod
    def parse(cls, config):
        """None → defaults, an instance → itself, a dict → validated."""
        if config is None:
            return cls()
        if isinstance(config, cls):
            return config
        return cls.model_validate(config)

    def model_copy(self, update: Dict[str, Any] = None):
        """A validated copy with ``update`` applied (pydantic parity)."""
        return type(self).model_validate(
            {**getattr(self, "extra", {}),
             **{f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)},
             **(update or {})})


# --------------------------------------------------------------------------
# The training config surface (counterpart of deepspeed_tpu/config.py's
# DeepSpeedTPUConfig and its blocks).  Same JSON keys.  A block the port does
# not implement yet is accepted when absent or at its default and raises
# NotImplementedError, naming the ROADMAP item that owns it, when it asks
# for behaviour — nothing is parsed and then silently dropped.

AUTO = "auto"


def _check_auto_int(cls_name: str, name: str, value):
    if value != AUTO and (isinstance(value, bool)
                          or not isinstance(value, int)):
        raise TypeError(f"{cls_name}.{name}: expected an int or 'auto', got "
                        f"{value!r}")


@dataclasses.dataclass
class OptimizerConfig(DeepSpeedConfigModel):
    """The "optimizer" block."""
    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig(DeepSpeedConfigModel):
    """The "scheduler" block → runtime/lr_schedules.py."""
    type: str = "WarmupLR"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FP16Config(DeepSpeedConfigModel):
    """The "fp16" block (dynamic loss scaling, runtime/precision.py)."""
    enabled: bool = False
    loss_scale: float = 0.0  # 0 → dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class BF16Config(DeepSpeedConfigModel):
    """The "bf16" block."""
    enabled: bool = False


@dataclasses.dataclass
class OffloadConfig(DeepSpeedConfigModel):
    """An offload block of "zero_optimization"; only ``device: "none"`` is
    implemented (ROADMAP A.9 owns cpu/nvme offload)."""
    device: str = "none"

    def __post_init__(self):
        super().__post_init__()
        if self.device not in ("none", "cpu", "nvme"):
            raise ValueError(f"offload device must be none|cpu|nvme, got "
                             f"{self.device!r}")


# ZeRO++ / MiCS knobs and their defaults: anything else asks for the
# multi-GPU collective pipeline (ROADMAP A.8)
_ZERO_MULTI_GPU_DEFAULTS = {
    "zero_quantized_weights": False, "zero_quantized_gradients": False,
    "zero_hpz_partition_size": 1, "mics_shard_size": 0}


@dataclasses.dataclass
class ZeroConfig(DeepSpeedConfigModel):
    """The "zero_optimization" block.  On one GPU stages 0, 1, 2 and 3 place
    the same tensors (parameters, gradients, optimizer state) on the same
    device, so all four are accepted and run the same program; sharding
    across GPUs is ROADMAP A.8."""
    stage: int = 0
    offload_optimizer: OffloadConfig = dataclasses.field(
        default_factory=OffloadConfig)
    offload_param: OffloadConfig = dataclasses.field(
        default_factory=OffloadConfig)

    def __post_init__(self):
        super().__post_init__()
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage must be 0..3, got "
                             f"{self.stage}")

    def check_implemented(self):
        for name in ("offload_optimizer", "offload_param"):
            if getattr(self, name).device != "none":
                raise NotImplementedError(
                    f"zero_optimization.{name}.device="
                    f"{getattr(self, name).device!r}: offload is not ported "
                    f"yet (ROADMAP A.9)")
        extra = getattr(self, "extra", {})
        for key, default in _ZERO_MULTI_GPU_DEFAULTS.items():
            if extra.get(key, default) != default:
                raise NotImplementedError(
                    f"zero_optimization.{key}: ZeRO++/MiCS wire formats are "
                    f"not ported yet (ROADMAP A.8)")
        zpp = extra.get("zeropp") or {}
        if isinstance(zpp, dict) and (zpp.get("quantized_allreduce")
                                      or zpp.get("hierarchical")):
            raise NotImplementedError(
                "zero_optimization.zeropp: the quantized collective pipeline "
                "is not ported yet (ROADMAP A.8)")


@dataclasses.dataclass
class GradientCompressionConfig(DeepSpeedConfigModel):
    enabled: bool = False
    dtype: str = "bf16"


# top-level blocks that are accepted only when absent or asking for nothing:
# block -> (keys that switch behaviour on, owning ROADMAP item)
_UNPORTED_BLOCKS = {
    "overlap": (("enabled", "collective_matmul"), "A.8"),
    "moe": (("wire_bits", "hierarchical"), "A.8"),
    "telemetry": (("enabled",), "A.10"),
    "flops_profiler": (("enabled",), "A.10"),
    "comms_logger": (("enabled",), "A.10"),
    "tensorboard": (("enabled",), "A.10"),
    "csv_monitor": (("enabled",), "A.10"),
    "wandb": (("enabled",), "A.10"),
    "comet": (("enabled",), "A.10"),
    "guardian": (("enabled",), "A.9"),
    "elasticity": (("enabled",), "A.9"),
    "hybrid_engine": (("enabled",), "A.11"),
    "progressive_layer_drop": (("enabled",), "A.11"),
}


def _block_asks(block, keys) -> bool:
    return isinstance(block, dict) and any(block.get(k) for k in keys)


@dataclasses.dataclass
class DeepSpeedTPUConfig(DeepSpeedConfigModel):
    """Top-level training config (same name and keys as the reference's).
    ``prescale_gradients`` and ``gradient_predivide_factor`` are accepted
    like any unknown key and change nothing, as in the reference: the loss
    is a mean over the whole batch, so there is nothing to pre-divide."""
    train_batch_size: Any = AUTO
    train_micro_batch_size_per_gpu: Any = AUTO
    gradient_accumulation_steps: Any = AUTO

    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = dataclasses.field(
        default_factory=ZeroConfig)
    gradient_compression: GradientCompressionConfig = dataclasses.field(
        default_factory=GradientCompressionConfig)

    gradient_clipping: float = 0.0
    steps_per_print: int = 10
    seed: int = 42

    def __post_init__(self):
        super().__post_init__()
        for name in ("train_batch_size", "train_micro_batch_size_per_gpu",
                     "gradient_accumulation_steps"):
            _check_auto_int(type(self).__name__, name, getattr(self, name))
        self._check_precision()

    def _check_precision(self):
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")

    def check_implemented(self):
        """Raise for every block that asks for behaviour the port does not
        have yet (called by the engine; parsing alone never raises for
        them, so a config can still be inspected)."""
        self.zero_optimization.check_implemented()
        if self.gradient_compression.enabled:
            raise NotImplementedError(
                "gradient_compression: error-feedback gradient compression "
                "is not ported yet (ROADMAP A.11)")
        extra = getattr(self, "extra", {})
        for flag in ("wall_clock_breakdown", "memory_breakdown", "dump_state"):
            if extra.get(flag):
                raise NotImplementedError(
                    f"{flag}: the engine's timers and state dumps are not "
                    f"ported yet (ROADMAP A.10)")
        for block, (keys, item) in _UNPORTED_BLOCKS.items():
            if _block_asks(extra.get(block), keys):
                raise NotImplementedError(
                    f"config block {block!r} asks for behaviour that is not "
                    f"ported yet (ROADMAP {item})")
        mesh = extra.get("mesh")
        if isinstance(mesh, dict) and any(
                v not in (1, -1, AUTO) for v in mesh.values()):
            raise NotImplementedError(
                f"mesh {mesh}: the port runs on one GPU; multi-GPU meshes "
                f"are ROADMAP A.8")
        de = extra.get("data_efficiency")
        if isinstance(de, dict) and de.get("enabled"):
            raise NotImplementedError(
                "data_efficiency (curriculum, random-LTD) is not ported yet "
                "(ROADMAP A.11)")
        if extra.get("compression_training"):
            raise NotImplementedError(
                "compression_training is not ported yet (ROADMAP A.11)")
        res = extra.get("resilience")
        if isinstance(res, dict) and any(res.values()):
            raise NotImplementedError(
                "resilience is not ported yet (ROADMAP A.9)")

    # ---- batch triad (reference config.py resolve_batch_size) ----
    def resolve_batch_size(self, dp_world_size: int) -> None:
        """Reconcile train_batch_size = micro_batch × grad_accum ×
        dp_world_size.  Any two of the three determine the third; a lone
        train_batch_size is split with gas=1; nothing set gives micro=1,
        gas=1."""
        tbs = self.train_batch_size
        mbs = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        tbs = None if tbs == AUTO else tbs
        mbs = None if mbs == AUTO else mbs
        gas = None if gas == AUTO else gas

        if tbs is not None and mbs is not None and gas is None:
            if tbs % (mbs * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tbs} not divisible by micro_batch "
                    f"{mbs} × dp_world {dp_world_size}")
            gas = tbs // (mbs * dp_world_size)
        elif tbs is not None and gas is not None and mbs is None:
            if tbs % (gas * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tbs} not divisible by grad_accum "
                    f"{gas} × dp_world {dp_world_size}")
            mbs = tbs // (gas * dp_world_size)
        elif mbs is not None:
            gas = gas or 1
            tbs = tbs or mbs * gas * dp_world_size
        elif tbs is not None:
            gas = 1
            if tbs % dp_world_size != 0:
                raise ValueError(
                    f"train_batch_size {tbs} not divisible by dp_world "
                    f"{dp_world_size}")
            mbs = tbs // dp_world_size
        else:
            mbs, gas = 1, 1
            tbs = dp_world_size

        if tbs != mbs * gas * dp_world_size:
            raise ValueError(
                f"batch triad inconsistent: {tbs} != {mbs} × {gas} × "
                f"{dp_world_size}")
        self.train_batch_size = tbs
        self.train_micro_batch_size_per_gpu = mbs
        self.gradient_accumulation_steps = gas

    @property
    def compute_dtype(self):
        import torch
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32


def parse_config(config) -> DeepSpeedTPUConfig:
    """Load from a JSON path, a dict, an instance, or None (all defaults)."""
    if config is None:
        return DeepSpeedTPUConfig()
    if isinstance(config, DeepSpeedTPUConfig):
        return config
    if isinstance(config, str):
        import json
        with open(config) as f:
            config = json.load(f)
    return DeepSpeedTPUConfig.model_validate(config)
