"""deepspeed_tpu_torch.inference.v2 — ragged continuous-batching serving
("FastGen"): paged KV pool + host-side block allocator/sequence manager
(ragged.py), the ragged forward over the pool (model.py), and the
put/query/flush engine with a Dynamic SplitFuse generate driver
(engine_v2.py)."""

from deepspeed_tpu_torch.inference.v2.engine_v2 import (
    DSStateManagerConfig, EngineDrained, InferenceEngineV2,
    RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.model import PagedKVCache
from deepspeed_tpu_torch.inference.v2.ragged import (BlockedAllocator,
                                                     DSStateManager,
                                                     RaggedBatch,
                                                     RadixKVCache,
                                                     SequenceDescriptor,
                                                     build_ragged_batch)

__all__ = ["InferenceEngineV2", "EngineDrained", "RaggedInferenceEngineConfig",
           "DSStateManagerConfig", "PagedKVCache", "BlockedAllocator",
           "DSStateManager", "RaggedBatch", "RadixKVCache",
           "SequenceDescriptor", "build_ragged_batch"]
