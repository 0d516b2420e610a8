"""Histogram metric — the latency primitive counters/gauges cannot express.

The PyTorch port's copy of deepspeed_tpu/telemetry/histogram.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

Serving SLOs are percentiles: a p99 TTFT regression is invisible to a mean
(one stuck request in a hundred moves the p99 10x while the mean barely
twitches), and a counter can only ever produce a mean.  Each labeled series
keeps two representations at once:

- **fixed log-spaced buckets** (Prometheus ``histogram`` semantics:
  cumulative ``_bucket{le=...}`` counts plus ``_sum``/``_count``), so any
  Prometheus-compatible collector can aggregate/quantile across processes;
- **exact observations under a cap** (default 8192 per series), so the
  in-process quantile a bench or test reads is EXACT while the series is
  small — bucket-interpolated quantiles of a 40-observation smoke run
  would be pure bucket-geometry noise.  Past the cap the stored sample
  set stops growing and ``quantile()`` degrades to standard bucket linear
  interpolation (the same math PromQL ``histogram_quantile`` applies).

Buckets are log-spaced because latency is: serving latencies span 0.1 ms
(a cache-hit decode dispatch) to minutes (a queued 2k-token prefill under
overload), and constant RELATIVE error per bucket is what makes p50 and
p99 equally trustworthy.  The default ladder covers 0.1..1e5 with 4
buckets per decade (~78% spacing, 25 boundaries), matching the registry's
millisecond conventions.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.telemetry.registry import _Metric, _label_key

DEFAULT_EXACT_CAP = 8192


def log_buckets(lo: float = 0.1, hi: float = 1e5,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds from ``lo`` to at least ``hi``,
    ``per_decade`` per decade.  Boundaries are rounded to 3 significant
    digits so the ``le`` labels are stable, human-readable strings."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"invalid bucket spec lo={lo} hi={hi} "
                         f"per_decade={per_decade}")
    out: List[float] = []
    step = 10.0 ** (1.0 / per_decade)
    v = float(lo)
    while True:
        r = float(f"{v:.3g}")
        if not out or r > out[-1]:
            out.append(r)
        if r >= hi:
            break
        v *= step
    return tuple(out)


DEFAULT_BUCKETS = log_buckets()


class _Series:
    """One label-set's state: per-bucket counts (non-cumulative), running
    sum/count, and the exact-value reservoir (first ``cap`` observations)."""

    __slots__ = ("counts", "sum", "count", "values")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)     # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.values: List[float] = []


class Histogram(_Metric):
    """Prometheus ``histogram`` with exact in-process quantiles under a cap.

    Created through ``MetricRegistry.histogram(name, help, buckets=...)`` —
    get-or-create like counters/gauges; a repeat call with different buckets
    raises (two bucket ladders under one name would corrupt exposition).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", registry=None,
                 buckets: Optional[Sequence[float]] = None,
                 exact_cap: int = DEFAULT_EXACT_CAP):
        super().__init__(name, help, registry)
        bs = tuple(float(b) for b in (buckets if buckets is not None
                                      else DEFAULT_BUCKETS))
        if list(bs) != sorted(set(bs)):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing, got {bs}")
        self.buckets = bs
        self.exact_cap = int(exact_cap)
        self._series: Dict[tuple, _Series] = {}

    # ---- ingestion ----

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _Series(len(self.buckets))
            s.counts[bisect.bisect_left(self.buckets, value)] += 1
            s.sum += value
            s.count += 1
            if len(s.values) < self.exact_cap:
                s.values.append(value)

    # ---- reads ----

    def count(self, **labels) -> int:
        s = self._series.get(_label_key(labels))
        return s.count if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(_label_key(labels))
        return s.sum if s else 0.0

    def quantile(self, q: float, **labels) -> float:
        """q in [0, 1].  Exact (numpy 'linear' interpolation over the stored
        values) while the series is under the cap; past it, bucket linear
        interpolation — PromQL ``histogram_quantile`` math, with the open
        +Inf bucket clamped to the highest finite boundary."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s.count == 0:
                return float("nan")
            if s.count <= len(s.values):
                vals = sorted(s.values)
                pos = q * (len(vals) - 1)
                lo = int(pos)
                hi = min(lo + 1, len(vals) - 1)
                return vals[lo] + (pos - lo) * (vals[hi] - vals[lo])
            return self._bucket_quantile(s, q)

    def _bucket_quantile(self, s: _Series, q: float) -> float:
        rank = q * s.count
        cum = 0
        for i, c in enumerate(s.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):      # open +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * max(0.0, (rank - cum)) / c
            cum += c
        return self.buckets[-1]

    # ---- snapshot forms ----

    def samples(self) -> List[Tuple[Dict[str, str], dict]]:
        """[(labels, {"count", "sum", "bucket_counts", "p50", "p90",
        "p99"})] — bucket_counts are NON-cumulative (the exposition layer
        accumulates); quantiles ride along so a written snapshot answers
        percentile questions without re-deriving them."""
        with self._lock:
            keys = list(self._series)
        out = []
        for key in sorted(keys):
            labels = dict(key)
            s = self._series.get(key)
            if s is None:       # raced with clear()
                continue
            out.append((labels, {
                "count": s.count,
                "sum": s.sum,
                "bucket_counts": list(s.counts),
                "p50": self.quantile(0.5, **labels),
                "p90": self.quantile(0.9, **labels),
                "p99": self.quantile(0.99, **labels),
            }))
        return out

    def clear(self):
        with self._lock:
            self._series.clear()
