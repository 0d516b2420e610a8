"""deepspeed_tpu_torch.serving — the serving layer above one engine
(counterpart of deepspeed_tpu/serving): the paged LoRA adapter pool
(adapters.py) that the ragged engine's ``adapters`` block attaches to its
KV allocator, and the multi-replica serving fleet: supervised
``InferenceEngineV2`` replicas (fleet.py), a failure-tolerant router with
bounded retry and request migration (router.py), hysteresis admission
control (admission.py), SLO burn-rate monitoring (slo.py) and
signal-driven prefill/decode pool autoscaling for the disaggregated mode
(autoscale.py).  Chaos sites (``runtime/faults.py``): ``router.dispatch``,
``replica.heartbeat``, ``replica.mid_decode``, ``admission.decide``,
``fleet.respawn_factory``, ``handoff.mid_transfer``.
"""

from deepspeed_tpu_torch.serving.adapters import (PROJS, AdapterPool,
                                                  random_adapter_weights)
from deepspeed_tpu_torch.serving.admission import (AdmissionConfig,
                                                   AdmissionController)
from deepspeed_tpu_torch.serving.autoscale import (AutoscaleConfig,
                                                   PoolAutoscaler)
from deepspeed_tpu_torch.serving.fleet import (REPLICA_STATES, FleetConfig,
                                               FleetDrained, Replica,
                                               ServingFleet)
from deepspeed_tpu_torch.serving.router import (POLICIES, FleetRequest,
                                                NoHealthyReplicas,
                                                RequestFailed, Router,
                                                RouterConfig)
from deepspeed_tpu_torch.serving.slo import (SLOConfig, SLOMonitor, SLOSpec,
                                             burn_rate)

__all__ = ["AdapterPool", "PROJS", "random_adapter_weights",
           "ServingFleet", "FleetConfig", "FleetDrained", "Replica",
           "REPLICA_STATES", "Router", "RouterConfig", "FleetRequest",
           "RequestFailed", "NoHealthyReplicas", "POLICIES",
           "AdmissionController", "AdmissionConfig",
           "PoolAutoscaler", "AutoscaleConfig",
           "SLOMonitor", "SLOConfig", "SLOSpec", "burn_rate"]
