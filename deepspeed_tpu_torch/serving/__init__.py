"""deepspeed_tpu_torch.serving — the serving layer above one engine
(counterpart of deepspeed_tpu/serving).  Ported so far: the paged LoRA
adapter pool (adapters.py) that the ragged engine's ``adapters`` block
attaches to its KV allocator.  The fleet, router, admission control,
autoscaling and SLO monitor are ROADMAP A.7."""

from deepspeed_tpu_torch.serving.adapters import (PROJS, AdapterPool,
                                                  random_adapter_weights)

__all__ = ["AdapterPool", "PROJS", "random_adapter_weights"]
