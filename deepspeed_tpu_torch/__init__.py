"""deepspeed_tpu_torch: the PyTorch + CUDA port of deepspeed_tpu, for NVIDIA
Hopper (H100).  It imports torch, numpy and the standard library only —
never JAX and never the deepspeed_tpu package, which stays beside it as the
reference the port is held to.

Ported so far: the serving path (``InferenceEngineV2.generate`` over the
paged KV pool, CUDA kernels for paged decode and ragged prefill), the
training main path (``initialize`` → ``engine.train_batch``, CUDA kernels
for the flash-attention forward, dq and dk/dv), quantized serving (W8A16 /
W4A16 stores and int8 KV, the ``wq_matmul`` kernels) and multi-tenant LoRA
serving (``generate(adapter_ids=...)`` over a paged adapter pool, the
batched-gather ``lora_matmul`` kernel).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.config import DeepSpeedTPUConfig, parse_config
from deepspeed_tpu_torch.engine import DeepSpeedEngine, StepMetrics
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models.gpt import (GPT, GPTChunkedLoss, GPTConfig,
                                            params_from_numpy)
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)

__all__ = ["initialize", "DeepSpeedEngine", "DeepSpeedTPUConfig",
           "DeepSpeedDataLoader", "RepeatingLoader", "StepMetrics", "GPT",
           "GPTChunkedLoss", "InferenceEngineV2", "GPTConfig",
           "get_accelerator", "params_from_numpy", "parse_config"]


def initialize(model=None,
               config=None,
               example_batch=None,
               training_data=None,
               lr_scheduler: Optional[Callable[[int], float]] = None,
               optimizer=None,
               collate_fn: Optional[Callable] = None,
               device=None,
               args=None,
               config_params=None,
               **kwargs) -> Tuple[DeepSpeedEngine, Any, Any, Any]:
    """Build the training engine (counterpart of ``deepspeed_tpu.initialize``).

    Returns ``(engine, optimizer, dataloader, lr_scheduler)``.  The
    dataloader is built when ``training_data`` is given.

    model: an ``nn.Module`` whose ``forward(batch)`` returns a scalar loss.
    config: a JSON path, a dict, a ``DeepSpeedTPUConfig`` or None.
    example_batch: accepted and ignored — nothing has to be traced in
    PyTorch; it is kept so that callers port unchanged.
    device: ``None`` is ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the plain PyTorch path.
    """
    if kwargs.get("mesh") is not None:
        raise NotImplementedError("mesh=: the port runs on one GPU; "
                                  "multi-GPU meshes are ROADMAP A.8")
    if model is None:
        raise ValueError("initialize() needs a model")
    if config is None and config_params is None and args is not None:
        config = (getattr(args, "deepspeed_config", None)
                  or getattr(args, "deepscale_config", None))
    cfg = parse_config(config if config is not None else config_params)
    engine = DeepSpeedEngine(model=model, config=cfg,
                             lr_scheduler=lr_scheduler,
                             client_optimizer=optimizer, device=device)
    dataloader = None
    if training_data is not None:
        dataloader = DeepSpeedDataLoader(
            training_data,
            micro_batch_size_per_gpu=int(cfg.train_micro_batch_size_per_gpu),
            gradient_accumulation_steps=int(cfg.gradient_accumulation_steps),
            dp_world_size=engine.dp_world_size,
            collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_schedule
