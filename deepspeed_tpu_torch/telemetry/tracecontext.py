"""Per-request distributed trace context.

The PyTorch port's copy of deepspeed_tpu/telemetry/tracecontext.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

A :class:`TraceContext` names one request's position in the fleet-wide
causal tree: a ``trace_id`` stable for the request's whole lifetime
(across retries, migrations, and the prefill->decode handoff), a
``span_id`` minted per dispatch attempt, and a ``parent_id`` linking the
attempt back to the span that caused it.  The context also carries the
Perfetto flow-event ``id`` used to stitch slices across per-replica
trace files (see ``SpanTracer.flow``) plus the phase/attempt labels
stamped into span ``args`` so ``telemetry/critical_path.py`` can match
engine spans back to fleet requests.

Id allocation is process-local (a locked counter) and therefore only
unique within one process.  Cross-file uniqueness is handled at merge
time: every trace file records ``FLOW_SCOPE`` (a per-process token) in
``otherData.flow_id_scope`` and ``scripts/merge_traces.py`` remaps flow
ids per scope, so files written by the same process keep stitching while
files from different processes can never collide.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Dict, Optional

__all__ = ["TraceContext", "FLOW_SCOPE", "new_trace", "reset_ids"]

# Process-level scope token for flow ids.  Stamped into every trace
# file's otherData so merge_traces can tell "same allocator" files
# (keep ids consistent) from foreign files (remap to disjoint ranges).
FLOW_SCOPE: str = f"{os.getpid():x}-{time.time_ns() & 0xFFFFFFFF:08x}"

_lock = threading.Lock()
_trace_counter = itertools.count(1)
_span_counter = itertools.count(1)


def _next_trace_id() -> int:
    with _lock:  # sync-ok: counter bump, never blocks
        return next(_trace_counter)


def _next_span_id() -> int:
    with _lock:  # sync-ok: counter bump, never blocks
        return next(_span_counter)


def reset_ids() -> None:
    """Reset the id counters (test isolation only)."""
    global _trace_counter, _span_counter
    with _lock:
        _trace_counter = itertools.count(1)
        _span_counter = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Immutable per-attempt trace coordinates for one request."""

    trace_id: int
    span_id: int
    parent_id: Optional[int] = None
    # Perfetto flow-event id; None when the request never crosses a
    # process/replica boundary (e.g. engine-local traces), in which
    # case no flow events are emitted.
    flow_id: Optional[int] = None
    phase: str = "full"
    attempt: int = 0

    def child(self, *, phase: Optional[str] = None,
              attempt: Optional[int] = None) -> "TraceContext":
        """New attempt span under this context, same trace/flow ids."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=_next_span_id(),
            parent_id=self.span_id,
            flow_id=self.flow_id,
            phase=self.phase if phase is None else phase,
            attempt=self.attempt if attempt is None else attempt,
        )

    def args(self) -> Dict[str, Any]:
        """Span ``args`` payload identifying this attempt in a trace."""
        out: Dict[str, Any] = {
            "trace": self.trace_id,
            "span": self.span_id,
            "attempt": self.attempt,
            "phase": self.phase,
        }
        if self.parent_id is not None:
            out["parent_span"] = self.parent_id
        return out


def new_trace(*, phase: str = "full", with_flow: bool = True) -> TraceContext:
    """Allocate a fresh root context for a newly submitted request."""
    tid = _next_trace_id()
    return TraceContext(
        trace_id=tid,
        span_id=_next_span_id(),
        parent_id=None,
        flow_id=tid if with_flow else None,
        phase=phase,
        attempt=0,
    )
