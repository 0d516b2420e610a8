"""Counter/gauge registries — the numeric backbone of step telemetry.

The PyTorch port's copy of deepspeed_tpu/telemetry/registry.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

The reference scatters its numbers across MonitorMaster events, the comms
logger, and ad-hoc log lines; here every scalar the engine observes lands in
one labeled registry so the snapshot exporter (exporter.py) can serialize the
whole set at once (JSON + Prometheus text exposition) and fan the scalar
subset out through MonitorMaster.

Semantics follow Prometheus: a **counter** is monotonically increasing
(bytes moved, calls made, cache misses), a **gauge** is a point-in-time
sample (live device memory, last-step flops).  Label sets distinguish series
within one metric (``collective_bytes_total{kind="all_reduce", axis="dp"}``).

ZeRO++ (arxiv 2306.10209) motivates the per-collective byte accounting: the
comms-volume optimizations it describes (quantized gathers/reduces,
hierarchical partitioning) need a measured byte baseline per collective kind
before any of them can be evaluated — ``record_collective`` below is that
baseline's ingestion point (called from comm/collectives.py's trace-time
``_log`` hook).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]  # sorted ((k, v), ...) pairs


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """One named metric holding per-label-set float values."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", registry=None):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]

    def clear(self):
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    """Monotonic counter (Prometheus ``counter`` type)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {value})")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(value)


class Gauge(_Metric):
    """Point-in-time sample (Prometheus ``gauge`` type)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)


class MetricRegistry:
    """Named metric store.  ``counter``/``gauge`` are get-or-create (repeat
    calls with the same name return the same object; a kind mismatch is a
    bug and raises)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets=None):
        """Get-or-create a Histogram (telemetry/histogram.py).  A repeat
        call must not silently change the bucket ladder: cumulative
        ``le`` series under two ladders cannot be merged, so a mismatch
        raises."""
        from deepspeed_tpu_torch.telemetry.histogram import Histogram
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help, buckets=buckets)
                self._metrics[name] = m
            elif not isinstance(m, Histogram):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested histogram")
            elif (buckets is not None
                  and tuple(float(b) for b in buckets) != m.buckets):
                raise ValueError(f"histogram {name!r} already registered "
                                 f"with different buckets")
            return m

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, dict]:
        """{"counters": {name: {"help", "samples": [{"labels", "value"}]}},
        "gauges": {...}, "histograms": {name: {"help", "buckets",
        "samples": [{"labels", "count", "sum", "bucket_counts",
        "p50"/"p90"/"p99"}]}}} — the JSON-stable form exporter.py
        serializes."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            if m.kind == "histogram":
                out["histograms"][m.name] = {
                    "help": m.help,
                    "buckets": list(m.buckets),
                    "samples": [{"labels": labels, **stats}
                                for labels, stats in m.samples()],
                }
                continue
            bucket = out["counters" if m.kind == "counter" else "gauges"]
            bucket[m.name] = {
                "help": m.help,
                "samples": [{"labels": labels, "value": value}
                            for labels, value in m.samples()],
            }
        return out

    def reset(self) -> None:
        """Drop all metrics (tests; a long-lived process keeps its counters)."""
        with self._lock:
            self._metrics.clear()


# Process-global registry: collectives record here from trace time regardless
# of which engine (if any) is running — the same pattern as comm.comms_logger.
default_registry = MetricRegistry()

COLLECTIVE_BYTES = "collective_bytes_total"
COLLECTIVE_CALLS = "collective_calls_total"

_suppress_collectives = 0


class suppress_collective_recording:
    """Context manager silencing ``record_collective`` — used around the
    telemetry layer's AOT ``lower().compile()`` analysis, which RETRACES
    the step function and would otherwise fire every wrapper's trace-time
    hook a second time, doubling the analytic byte baseline."""

    def __enter__(self):
        global _suppress_collectives
        _suppress_collectives += 1
        return self

    def __exit__(self, *exc):
        global _suppress_collectives
        _suppress_collectives -= 1
        return False


def record_collective(name: str, nbytes: int, axis: str,
                      dcn_fraction: float = 0.0) -> None:
    """Trace-time hook for comm/collectives.py: bytes + calls per collective
    kind per mesh axis.  Under jit these count once per *trace*, not per
    execution (per-execution truth comes from the compiled-HLO counters in
    step_telemetry.py); in eager shard_map they count per call.

    ``dcn_fraction`` (the share of the axis's ring hops crossing a host
    boundary — comm/collectives.axis_dcn_fraction) splits the SAME wire
    bytes into ``link="ici"`` / ``link="dcn"`` series alongside the
    unlabeled per-(kind, axis) total.  The split sums exactly to the
    total: ``dcn = round(bytes · fraction)``, ``ici = bytes − dcn`` — the
    telemetry [pod_scale]'s topology-aware collective selection keys on.
    """
    if _suppress_collectives:
        return
    bytes_c = default_registry.counter(
        COLLECTIVE_BYTES,
        "bytes entering named collective wrappers, per kind per mesh axis "
        "(trace-time under jit); link=ici|dcn series split the same bytes "
        "by interconnect and sum exactly to the unlabeled total")
    bytes_c.inc(nbytes, kind=name, axis=axis)
    dcn_bytes = int(round(nbytes * max(0.0, min(1.0, dcn_fraction))))
    bytes_c.inc(nbytes - dcn_bytes, kind=name, axis=axis, link="ici")
    bytes_c.inc(dcn_bytes, kind=name, axis=axis, link="dcn")
    default_registry.counter(
        COLLECTIVE_CALLS,
        "calls into named collective wrappers, per kind per mesh axis "
        "(trace-time under jit)").inc(1, kind=name, axis=axis)
