"""Serving telemetry of the PyTorch port (host Python, counterpart of the
serving half of deepspeed_tpu/telemetry):

- ``registry``     — labeled counter/gauge registries
- ``histogram``    — log-bucketed histograms with exact quantiles under a cap
- ``tracer``       — host span recording + Chrome-trace/Perfetto export
- ``tracecontext`` — per-request distributed trace/span ids
- ``exporter``     — snapshot serialization (JSON, Prometheus text)
- ``serving``      — the request-level facade the serving engine drives
                     (lifecycle spans, TTFT/TPOT histograms, KV-pool,
                     prefix-cache, SLA and speculative-decode counters)
"""

from deepspeed_tpu_torch.telemetry.exporter import SnapshotExporter
from deepspeed_tpu_torch.telemetry.histogram import (DEFAULT_BUCKETS,
                                                     Histogram, log_buckets)
from deepspeed_tpu_torch.telemetry.registry import (Counter, Gauge,
                                                    MetricRegistry,
                                                    default_registry)
from deepspeed_tpu_torch.telemetry.serving import (ServingTelemetry,
                                                   ServingTelemetryConfig)
from deepspeed_tpu_torch.telemetry.tracecontext import TraceContext, new_trace
from deepspeed_tpu_torch.telemetry.tracer import SpanTracer, TraceEmitter

__all__ = ["Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram",
           "MetricRegistry", "ServingTelemetry", "ServingTelemetryConfig",
           "SnapshotExporter", "SpanTracer", "TraceContext", "TraceEmitter",
           "default_registry", "log_buckets", "new_trace"]
