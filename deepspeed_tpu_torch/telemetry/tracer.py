"""Host-side span tracer + Chrome-trace/Perfetto emitter.

The PyTorch port's copy of deepspeed_tpu/telemetry/tracer.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

T3 (arxiv 2401.16677) makes the case that optimizing compute/collective
overlap starts from *seeing* the timeline; the device timeline comes from
the framework's profiler, but the host-side step anatomy — batch
assembly, host→device placement, dispatch, waiting on device completion,
optimizer/step bookkeeping, checkpoint I/O — is invisible to it.  The
``SpanTracer`` records those phases as complete events and ``TraceEmitter``
writes the standard Chrome trace-event JSON that Perfetto / chrome://tracing
load directly, so a training run's host anatomy can be inspected next to the
device profile.

Events use the ``ph: "X"`` (complete) form with microsecond timestamps
relative to tracer construction; ``pid`` is the process index so
multi-host traces merge cleanly.

Flow events (``ph: "s"/"t"/"f"``) stitch one request's spans across
replica trace files into a single causal tree (see ``flow()`` and
``telemetry/tracecontext.py``); ``scripts/merge_traces.py`` remaps their
ids per ``otherData.flow_id_scope`` so merged trees survive.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Optional


def _flow_scope() -> str:
    from .tracecontext import FLOW_SCOPE
    return FLOW_SCOPE


class SpanTracer:
    """Records named host-side phase spans.

    ``span()`` is a context manager; when the tracer is disabled it costs one
    attribute check.  The event buffer is bounded — when full, the oldest
    events are dropped and ``dropped_events`` counts them (a watchdog-style
    disclosure rather than silent truncation or unbounded growth).
    """

    def __init__(self, enabled: bool = True, pid: int = 0,
                 max_events: int = 200_000):
        self.enabled = enabled
        self.pid = int(pid)
        self.max_events = int(max_events)
        # deque(maxlen): O(1) overflow (a full list would memmove the whole
        # buffer on every drop)
        self.events: deque = deque(maxlen=self.max_events)
        self.dropped_events = 0
        self.total_recorded = 0
        # incremental per-phase aggregates: summary() must not rescan the
        # buffer (it is embedded in every snapshot export — an O(buffer)
        # walk there would grow with run length)
        self._agg: Dict[str, dict] = {}
        # most recent duration per phase — the flight recorder embeds this
        # in each step record without scanning the buffer
        self.last_dur_ms: Dict[str, float] = {}
        # tid -> display name (Perfetto thread_name metadata): the serving
        # layer maps each request onto its own tid so Perfetto renders one
        # track per request (queue_wait / prefill / decode laid end to end)
        self.thread_names: Dict[int, str] = {}
        self._epoch_ns = time.perf_counter_ns()
        # wall-clock anchor of the ts=0 epoch: lets scripts/merge_traces.py
        # align traces from different processes/replicas (each tracer's ts
        # is relative to its own construction) onto one shared timeline
        self.epoch_unix_time = time.time()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    def now_us(self) -> float:
        """Current tracer-epoch timestamp — for callers that measure a span
        themselves (e.g. the async checkpoint writer, whose end is observed
        from a commit callback on another thread) and record() it after the
        fact.  record()/span() append to a deque, so recording from a
        background thread is safe."""
        return self._now_us()

    @contextmanager
    def span(self, name: str, step: Optional[int] = None, **args):
        if not self.enabled:
            yield
            return
        t0 = self._now_us()
        try:
            yield
        finally:
            self.record(name, t0, self._now_us() - t0, step=step, **args)

    def record(self, name: str, ts_us: float, dur_us: float,
               step: Optional[int] = None, tid: int = 0,
               cat: str = "host_phase", **args) -> None:
        if not self.enabled:
            return
        ev_args = dict(args)
        if step is not None:
            ev_args["step"] = int(step)
        if len(self.events) == self.max_events:
            self.dropped_events += 1
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": round(ts_us, 3), "dur": round(dur_us, 3),
            "pid": self.pid, "tid": int(tid), "args": ev_args,
        })
        self.total_recorded += 1
        agg = self._agg.setdefault(name, {"count": 0, "total_ms": 0.0,
                                          "max_ms": 0.0})
        dur_ms = dur_us / 1e3
        agg["count"] += 1
        agg["total_ms"] += dur_ms
        if dur_ms > agg["max_ms"]:
            agg["max_ms"] = dur_ms
        self.last_dur_ms[name] = round(dur_ms, 3)

    def flow(self, ph: str, flow_id: int, ts_us: float, tid: int = 0,
             name: str = "request_flow", cat: str = "flow") -> None:
        """Emit a Perfetto flow event (``ph`` one of ``s``/``t``/``f``).

        Flow events bind to the slice enclosing ``ts_us`` on this
        pid/tid; a chain of same-``id`` events renders as arrows linking
        the slices — one request's causal tree across replicas.  They
        ride the same bounded event buffer as spans (and count against
        ``dropped_events``), so a long-lived fleet cannot leak per-
        request flow records."""
        if not self.enabled:
            return
        ev = {
            "name": name, "cat": cat, "ph": ph, "ts": round(ts_us, 3),
            "pid": self.pid, "tid": int(tid), "id": int(flow_id),
        }
        if ph == "f":
            ev["bp"] = "e"   # bind to the enclosing slice, not the next
        if len(self.events) == self.max_events:
            self.dropped_events += 1
        self.events.append(ev)
        self.total_recorded += 1

    def set_thread_name(self, tid: int, name: str) -> None:
        """Name a tid's track in the emitted trace (Perfetto thread_name
        metadata) — the serving layer names each request's track.  The
        map is bounded by ``max_events`` (same policy as the event
        buffer): past the cap, new tids go unnamed rather than growing
        per-request metadata without limit."""
        tid = int(tid)
        if tid not in self.thread_names and \
                len(self.thread_names) >= self.max_events:
            self.dropped_events += 1
            return
        self.thread_names[tid] = str(name)

    def summary(self) -> Dict[str, dict]:
        """Per-phase count / total / max / mean milliseconds — the compact
        form the snapshot exporter embeds.  Aggregated over EVERY recorded
        span, including ones the bounded event buffer has already dropped
        (the trace file keeps the last ``max_events``; the summary keeps
        the whole run)."""
        out: Dict[str, dict] = {}
        for name, agg in self._agg.items():
            out[name] = {
                "count": agg["count"],
                "total_ms": round(agg["total_ms"], 3),
                "max_ms": round(agg["max_ms"], 3),
                "mean_ms": round(agg["total_ms"] / max(agg["count"], 1), 3),
            }
        return out

    def clear(self) -> None:
        self.events = deque(maxlen=self.max_events)
        self.dropped_events = 0
        self.total_recorded = 0
        self._agg = {}
        self.last_dur_ms = {}
        self.thread_names = {}


class TraceEmitter:
    """Writes a SpanTracer's buffer as Chrome trace-event JSON.

    The output is the ``{"traceEvents": [...]}`` object form (not the bare
    array) so metadata fields ride along; Perfetto and chrome://tracing both
    accept it.
    """

    def __init__(self, process_name: str = "deepspeed_tpu"):
        self.process_name = process_name

    def to_dict(self, tracer: SpanTracer) -> dict:
        meta = [{
            "name": "process_name", "ph": "M", "pid": tracer.pid, "tid": 0,
            "args": {"name": f"{self.process_name}/{tracer.pid}"},
        }]
        for tid, tname in sorted(tracer.thread_names.items()):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": tracer.pid,
                "tid": tid, "args": {"name": tname},
            })
        return {
            "traceEvents": meta + list(tracer.events),
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_events": tracer.dropped_events,
                # clock anchor for scripts/merge_traces.py: wall time of
                # this trace's ts=0 (absent in traces written before the
                # stamp existed — the merger then falls back to as-is)
                "epoch_unix_time": getattr(tracer, "epoch_unix_time",
                                           None),
                # flow-id allocator scope: files sharing this token used
                # one id space (merge keeps their flows stitched); files
                # from different scopes get disjoint remapped ids
                "flow_id_scope": _flow_scope(),
            },
        }

    def write(self, path: str, tracer: SpanTracer) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(tracer), f)
        os.replace(tmp, path)   # readers never see a half-written trace
        return path
