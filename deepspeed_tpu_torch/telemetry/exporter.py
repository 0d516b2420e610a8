"""Snapshot exporter — registry state → JSON / Prometheus text / monitors.

The PyTorch port's copy of deepspeed_tpu/telemetry/exporter.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

One serialization point for everything the telemetry layer measures: the
counter/gauge registries, the span-phase summary, and the per-executable
compiled figures (collective bytes, ``cost_analysis``/``memory_analysis``)
gathered by ``StepTelemetry``.  Three sinks:

- ``write_json``         — the machine-readable snapshot (bench rows, CI)
- ``write_prometheus``   — text exposition format, scrapeable by any
                           Prometheus-compatible collector via node textfile
                           exporter or a file-serving sidecar
- ``scalar_events``      — the flat scalar subset as MonitorMaster events,
                           so TensorBoard/CSV/W&B pick up the new series
                           through the existing fan-out for free
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.telemetry.registry import MetricRegistry

Event = Tuple[str, float, int]


def _prom_escape(value: str) -> str:
    """LABEL-VALUE escaping: backslash, double-quote, newline (the three
    characters the exposition format's quoted label syntax reserves)."""
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _help_escape(value: str) -> str:
    """HELP-text escaping: only backslash and newline — quotes are legal
    verbatim in HELP, and escaping them there renders a literal ``\\\"``
    in every scrape UI."""
    return value.replace("\\", r"\\").replace("\n", r"\n")


def _le_label(bound: float) -> str:
    """Canonical ``le`` rendering: integral bounds without a trailing .0
    (Prometheus convention), +Inf for the open bucket."""
    if math.isinf(bound):
        return "+Inf"
    return str(int(bound)) if bound == int(bound) else repr(bound)


def _prom_name(namespace: str, name: str) -> str:
    safe = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return f"{namespace}_{safe}" if namespace else safe


def _prom_value(v: float) -> str:
    """Full-precision sample rendering: '%g' (6 significant digits) would
    quantize a multi-GB byte counter so coarsely that per-step increments
    vanish and rate() reads zero.  Non-finite values use the exposition
    format's NaN/+Inf/-Inf tokens (int(v) on them would raise and kill the
    export)."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 2 ** 63:
        return str(int(v))
    return repr(v)


class SnapshotExporter:
    def __init__(self, registry: MetricRegistry, tracer=None,
                 namespace: str = "deepspeed_tpu"):
        self.registry = registry
        self.tracer = tracer
        self.namespace = namespace
        # monotonically increasing per exporter instance: two snapshots
        # from one process diff into rates (counter delta / monotonic
        # delta) without trusting wall clocks, and a scraper can tell a
        # rewrite from a stale file.  Additive keys — old schema preserved.
        self._seq = 0

    # ---- snapshot assembly ----

    def snapshot(self, step: Optional[int] = None,
                 extra: Optional[dict] = None) -> dict:
        self._seq += 1
        snap = {
            "schema": "deepspeed_tpu.telemetry.v1",
            "unix_time": time.time(),
            "monotonic_time": time.monotonic(),
            "snapshot_seq": self._seq,
            **self.registry.snapshot(),
        }
        if step is not None:
            snap["step"] = int(step)
        if self.tracer is not None and self.tracer.events:
            snap["spans"] = self.tracer.summary()
        if extra:
            snap.update(extra)
        return snap

    def write_json(self, path: str, snap: Optional[dict] = None,
                   step: Optional[int] = None) -> str:
        snap = snap if snap is not None else self.snapshot(step=step)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    # ---- Prometheus text exposition ----

    def prometheus_text(self, snap: Optional[dict] = None) -> str:
        snap = snap if snap is not None else self.snapshot()
        lines: List[str] = []

        # snapshot provenance stamps (the JSON schema's additive keys,
        # mirrored into the exposition so two .prom files also diff into
        # rates): seq + wall + monotonic capture time
        for key, pname, help_text in (
                ("snapshot_seq", "snapshot_seq",
                 "monotonically increasing snapshot sequence number "
                 "(per exporter instance)"),
                ("unix_time", "snapshot_unix_time",
                 "wall-clock capture time of this snapshot (seconds)"),
                ("monotonic_time", "snapshot_monotonic_seconds",
                 "monotonic capture time of this snapshot (seconds; "
                 "diff two snapshots for rate denominators)")):
            if key in snap:
                full = _prom_name(self.namespace, pname)
                lines.append(f"# HELP {full} {_help_escape(help_text)}")
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full} {_prom_value(float(snap[key]))}")

        def header(pname: str, metric: dict, prom_type: str) -> None:
            # HELP + TYPE for EVERY family (conformance: scrapers treat a
            # family without TYPE as untyped; help falls back to the metric
            # name so the line is never empty)
            lines.append(f"# HELP {pname} "
                         f"{_help_escape(metric.get('help') or pname)}")
            lines.append(f"# TYPE {pname} {prom_type}")

        def label_body(labels: dict, extra: str = "") -> str:
            parts = [f'{k}="{_prom_escape(str(v))}"'
                     for k, v in sorted(labels.items())]
            if extra:
                parts.append(extra)
            return ("{" + ",".join(parts) + "}") if parts else ""

        for kind_key, prom_type in (("counters", "counter"),
                                    ("gauges", "gauge")):
            for name, metric in sorted(snap.get(kind_key, {}).items()):
                pname = _prom_name(self.namespace, name)
                header(pname, metric, prom_type)
                for s in metric["samples"]:
                    labels = s.get("labels") or {}
                    lines.append(f"{pname}{label_body(labels)} "
                                 f"{_prom_value(s['value'])}")
        for name, metric in sorted(snap.get("histograms", {}).items()):
            pname = _prom_name(self.namespace, name)
            header(pname, metric, "histogram")
            bounds = list(metric.get("buckets", [])) + [float("inf")]
            for s in metric["samples"]:
                labels = s.get("labels") or {}
                cum = 0
                for bound, c in zip(bounds, s["bucket_counts"]):
                    cum += int(c)
                    body = label_body(labels,
                                      extra=f'le="{_le_label(bound)}"')
                    lines.append(f"{pname}_bucket{body} {cum}")
                lines.append(f"{pname}_sum{label_body(labels)} "
                             f"{_prom_value(s['sum'])}")
                lines.append(f"{pname}_count{label_body(labels)} "
                             f"{int(s['count'])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str,
                         snap: Optional[dict] = None) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.prometheus_text(snap))
        os.replace(tmp, path)
        return path

    # ---- MonitorMaster fan-out ----

    def scalar_events(self, snap: Optional[dict] = None, x: int = 0,
                      prefix: str = "Train/Telemetry") -> List[Event]:
        """Flatten every sample into ``(name, value, x)`` monitor events.
        Series names join label VALUES in sorted-key order so they are
        stable — for labels ``{kind: all_reduce, axis: dp}`` the keys sort
        (axis, kind), giving
        ``Train/Telemetry/collective_bytes_total/dp/all_reduce``."""
        snap = snap if snap is not None else self.snapshot()
        events: List[Event] = []
        for kind_key in ("counters", "gauges"):
            for name, metric in sorted(snap.get(kind_key, {}).items()):
                for s in metric["samples"]:
                    labels = s.get("labels") or {}
                    parts = [prefix, name] + [
                        str(labels[k]) for k in sorted(labels)]
                    events.append(("/".join(parts), float(s["value"]),
                                   int(x)))
        # histograms flatten to the scalar summaries monitors can plot
        # (count + exact/interpolated percentiles; the full bucket vector
        # stays in the Prometheus/JSON sinks)
        for name, metric in sorted(snap.get("histograms", {}).items()):
            for s in metric["samples"]:
                labels = s.get("labels") or {}
                lparts = [str(labels[k]) for k in sorted(labels)]
                for field in ("count", "p50", "p99"):
                    v = s.get(field)
                    if v is None or (isinstance(v, float)
                                     and math.isnan(v)):
                        continue
                    events.append(("/".join(
                        [prefix, f"{name}_{field}"] + lparts),
                        float(v), int(x)))
        return events
