"""Bounded ring-buffer time series over the metric registry.

The PyTorch port's copy of deepspeed_tpu/telemetry/timeseries.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

Metrics in this repo are point-in-time: a scrape answers "what is the
total now", never "how fast is it moving" or "what fraction of the last
minute's requests met their SLO".  The :class:`TimeSeriesStore` closes
that gap without a collector dependency: it samples registered
counter/histogram series into per-series ``deque(maxlen)`` ring buffers
at a cadence and exposes ``rate()`` / ``window_delta()`` reads over
them — the primitives ``serving/slo.py`` builds multi-window burn rates
from.

Sampling is PULL-based and non-blocking by design: ``maybe_sample`` is
called from the fleet dispatcher tick, costs a handful of dict reads when the cadence has elapsed and one
float compare when it hasn't, and never touches a device.  The optional
``start()`` background thread exists for harnesses that sample outside
a scheduler loop.

Histogram sampling records cumulative SLO *attainment* pairs
(observations at-or-under a threshold, total observations) rather than
raw quantiles: quantile reads sort the exact-value reservoir (O(n log n)
per call — far too heavy per tick), while attainment is a bucket-count
walk.  Thresholds on bucket boundaries are exact; in between, the
straddled bucket interpolates linearly (the same assumption PromQL
``histogram_quantile`` makes).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["TimeSeriesStore", "histogram_attainment"]


def histogram_attainment(hist, threshold: float,
                         labels: Optional[dict] = None
                         ) -> Tuple[float, float]:
    """(observations <= threshold, total observations), summed over every
    label set matching the ``labels`` subset (fleet histograms carry a
    ``replica`` label; an SLO is fleet-wide).  Reads bucket counts
    directly — never the quantile path (which sorts the reservoir)."""
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    with hist._lock:  # sync-ok: bounded dict/list copy, no device work
        rows = [(dict(k), list(s.counts), s.count)
                for k, s in hist._series.items()]
    buckets = hist.buckets
    good = 0.0
    total = 0.0
    for lbls, counts, count in rows:
        if any(lbls.get(k) != v for k, v in want.items()):
            continue
        total += count
        for i, c in enumerate(counts):
            if i >= len(buckets):
                break                       # +Inf bucket: all above
            hi = buckets[i]
            lo = buckets[i - 1] if i > 0 else 0.0
            if hi <= threshold:
                good += c
            elif lo < threshold:
                good += c * (threshold - lo) / (hi - lo)
            else:
                break
    return good, total


class TimeSeriesStore:
    """Ring-buffer store of (timestamp, value) samples per tracked series.

    ``capacity`` bounds every ring (oldest samples fall off — a
    long-lived fleet holds ``capacity * interval_s`` seconds of history,
    which only needs to cover the longest burn-rate window); tracked
    series are registered once at setup, so the per-sample cost is a
    fixed, small number of reads."""

    def __init__(self, *, interval_s: float = 0.25, capacity: int = 4096,
                 clock: Optional[Callable[[], float]] = None):
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.clock = clock or time.monotonic
        self._readers: List[Tuple[str, Callable[[], Dict[str, float]]]] = []
        self._rings: Dict[str, deque] = {}
        self._last_sample: Optional[float] = None
        self.samples_taken = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ tracking
    def _ring(self, key: str) -> deque:
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = deque(maxlen=self.capacity)
        return ring

    def track(self, key: str, fn: Callable[[], float]) -> str:
        """Track one scalar reader under ``key``."""
        self._readers.append((key, lambda k=key, f=fn: {k: float(f())}))
        self._ring(key)
        return key

    def track_counter(self, metric, key: Optional[str] = None,
                      **labels) -> str:
        key = key or metric.name
        return self.track(key, lambda: metric.value(**labels))

    def track_attainment(self, hist, threshold: float,
                         key: Optional[str] = None,
                         labels: Optional[dict] = None) -> str:
        """Track a histogram's cumulative (good, total) attainment pair
        under ``<key>.good`` / ``<key>.total``."""
        key = key or hist.name

        def read(h=hist, th=float(threshold), lb=dict(labels or {}),
                 k=key) -> Dict[str, float]:
            good, total = histogram_attainment(h, th, lb)
            return {f"{k}.good": good, f"{k}.total": total}

        self._readers.append((key, read))
        self._ring(f"{key}.good")
        self._ring(f"{key}.total")
        return key

    # ------------------------------------------------------------ sampling
    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Take one sample if the cadence has elapsed (one float compare
        otherwise).  Called from the dispatcher tick: every reader is a
        bounded host-memory walk — nothing here may block the round."""
        now = self.clock() if now is None else now
        if (self._last_sample is not None
                and now - self._last_sample < self.interval_s):
            return False
        self._last_sample = now
        for _key, read in self._readers:
            for k, v in read().items():
                self._ring(k).append((now, v))
        self.samples_taken += 1
        return True

    def start(self, interval_s: Optional[float] = None) -> None:
        """Background daemon sampler, for harnesses with no scheduler
        tick to piggyback on (the bench telemetry-overhead leg)."""
        if self._thread is not None:
            return
        period = float(interval_s or self.interval_s)
        self._stop.clear()

        def loop():
            while not self._stop.wait(period):
                self.maybe_sample()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="timeseries-sampler")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # --------------------------------------------------------------- reads
    def series(self, key: str) -> List[Tuple[float, float]]:
        return list(self._rings.get(key, ()))

    def latest(self, key: str) -> Optional[Tuple[float, float]]:
        ring = self._rings.get(key)
        return ring[-1] if ring else None

    def value_at(self, key: str, t: float) -> Optional[float]:
        """Value of the newest sample at-or-before ``t`` (None when the
        ring holds nothing that old — the window predates history)."""
        ring = self._rings.get(key)
        if not ring:
            return None
        best = None
        for ts, v in ring:
            if ts <= t:
                best = v
            else:
                break
        return best

    def window_delta(self, key: str, window_s: float,
                     now: Optional[float] = None) -> float:
        """newest − value_at(now − window): the cumulative growth over
        the window.  A window reaching past recorded history clamps to
        the oldest sample (partial-window semantics, disclosed rather
        than NaN: burn rate at startup reads the full short history)."""
        ring = self._rings.get(key)
        if not ring:
            return 0.0
        now = ring[-1][0] if now is None else now
        newest = ring[-1][1]
        base = self.value_at(key, now - window_s)
        if base is None:
            base = ring[0][1]
        return newest - base

    def rate(self, key: str, window_s: float,
             now: Optional[float] = None) -> float:
        """Per-second rate of a cumulative series over the window."""
        ring = self._rings.get(key)
        if not ring or len(ring) < 2:
            return 0.0
        now = ring[-1][0] if now is None else now
        t_lo = now - window_s
        span = [(t, v) for t, v in ring if t >= t_lo]
        if len(span) < 2:
            span = list(ring)[-2:]
        dt = span[-1][0] - span[0][0]
        if dt <= 0:
            return 0.0
        return (span[-1][1] - span[0][1]) / dt
