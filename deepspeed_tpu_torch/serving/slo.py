"""Multi-window SLO burn-rate monitoring for the serving fleet.

The PyTorch port's copy of deepspeed_tpu/serving/slo.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

An SLO here is "``objective`` of requests see ``metric`` at or under
``threshold_ms``" (e.g. 99% of requests get TTFT <= 500 ms).  The
monitor samples the fleet's latency histograms through a bounded
:class:`~deepspeed_tpu_torch.telemetry.timeseries.TimeSeriesStore` and derives
the standard SRE burn rate per window::

    bad_fraction(W) = 1 - good(W) / total(W)          (from the window's
                                                       attainment delta)
    burn(W)         = bad_fraction(W) / (1 - objective)

burn == 1 means the error budget is being spent exactly at the rate the
objective allows; burn == 10 exhausts a 30-day budget in 3 days.
Multi-window alerting (the Google SRE workbook shape) fires ``page``
only when EVERY configured window burns past the threshold — the long
window proves the problem is real, the short window proves it is still
happening — and ``warn`` when only the shortest window does.  Alerts
are edge-triggered into ``slo_alerts_total{slo,severity}`` and the live
per-window burn sits in ``slo_burn_rate{slo,window}``; both fan through
MonitorMaster when one is attached (``attach_monitor``).

The fleet ticks the monitor from its dispatcher loop (sampling must
never block a scheduler round: ``tick`` is host reads only), and the current paging-condition burn (``max_burn()``) is
offered opt-in to admission shedding and the pool autoscaler, closing
observability into the control loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.config import DeepSpeedConfigModel
from deepspeed_tpu_torch.telemetry.timeseries import TimeSeriesStore

__all__ = ["SLOSpec", "SLOConfig", "SLOMonitor", "burn_rate"]


@dataclasses.dataclass
class SLOSpec(DeepSpeedConfigModel):
    """One latency objective over an existing histogram family."""

    name: str                        # label value in slo_burn_rate{slo=}
    metric: str = "serving_ttft_ms"  # histogram to read
    threshold_ms: float = 500.0      # "good" boundary (put it on a bucket
    #                                  boundary for exact attainment)
    objective: float = 0.99          # target good fraction in [0, 1)


@dataclasses.dataclass
class SLOConfig(DeepSpeedConfigModel):
    """``slo`` block of the fleet config.  Defaults OFF: burn-rate
    monitoring is an opt-in layer and an empty ``slos`` list would only
    burn sampling cost."""

    enabled: bool = False
    sample_interval_s: float = 0.25
    capacity: int = 4096             # ring samples kept per series
    # multi-window alert shape, shortest first; ``page`` needs every
    # window past ``alert_burn_threshold``, ``warn`` just the shortest
    windows_s: List[float] = dataclasses.field(
        default_factory=lambda: [5.0, 60.0])
    alert_burn_threshold: float = 1.0
    slos: List[SLOSpec] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.windows_s, (list, tuple)) \
                or not isinstance(self.slos, (list, tuple)):
            raise TypeError(f"SLOConfig: windows_s and slos must be lists, "
                            f"got {self.windows_s!r} and {self.slos!r}")
        self.windows_s = [float(w) for w in self.windows_s]
        self.slos = [SLOSpec.parse(s) for s in self.slos]


def burn_rate(good: float, total: float, objective: float) -> float:
    """Pure burn-rate math (unit-tested against hand-computed values):
    the window's bad fraction over the SLO's allowed bad fraction."""
    if total <= 0:
        return 0.0
    bad = max(0.0, 1.0 - good / total)
    budget = 1.0 - objective
    if budget <= 0:
        return float("inf") if bad > 0 else 0.0
    return bad / budget


class SLOMonitor:
    """Continuous burn-rate evaluation over the fleet registry."""

    def __init__(self, config: Optional[SLOConfig] = None, *,
                 registry, clock: Optional[Callable[[], float]] = None,
                 monitor=None):
        self.config = SLOConfig.parse(config)
        self.clock = clock or time.monotonic
        self.registry = registry
        self._monitor = monitor          # optional MonitorMaster fan-out
        self.store = TimeSeriesStore(
            interval_s=self.config.sample_interval_s,
            capacity=self.config.capacity, clock=self.clock)
        self.windows = sorted(float(w) for w in self.config.windows_s)
        self.g_burn = registry.gauge(
            "slo_burn_rate", "SLO error-budget burn rate per objective "
            "per window: the window's bad-request fraction over the "
            "objective's allowed bad fraction (1.0 = spending budget "
            "exactly at the sustainable rate)")
        self.c_alerts = registry.counter(
            "slo_alerts_total", "burn-rate alert firings, edge-triggered "
            "per SLO per severity (page = every window past the "
            "threshold, warn = shortest window only)")
        self._tracked: Dict[str, SLOSpec] = {}
        for spec in self.config.slos:
            self._track(spec)
        # alerting state per (slo, severity): edge-triggered counters
        self._alerting: Dict[tuple, bool] = {}
        # burn per slo per window from the most recent evaluation; the
        # bench and the control-loop hooks read these without resampling
        self.last_burn: Dict[str, Dict[float, float]] = {}

    def _track(self, spec: SLOSpec) -> None:
        hist = self.registry._metrics.get(spec.metric)
        if hist is None:
            # the serving telemetry registers its families eagerly, but a
            # fleet of fake engines (tests) may not: register on demand so
            # the tracker binds to whatever later observes into it
            # binds to an EXISTING documented family named by the SLO
            # config (default serving_ttft_ms); registers no new name in
            # production, only under test fakes that skipped eager
            # registration
            hist = self.registry.histogram(spec.metric)  # metric-name-ok
        if getattr(hist, "kind", None) != "histogram":
            raise ValueError(f"SLO {spec.name!r}: metric {spec.metric!r} "
                             f"is {getattr(hist, 'kind', None)}, need a "
                             f"histogram")
        self._tracked[spec.name] = spec
        self.store.track_attainment(hist, spec.threshold_ms,
                                    key=f"slo.{spec.name}")

    def attach_monitor(self, monitor) -> None:
        """Fan burn gauges/alerts through a MonitorMaster as well."""
        self._monitor = monitor

    # ------------------------------------------------------------- ticking
    def tick(self, now: Optional[float] = None) -> float:
        """Sample (cadence-gated) and re-evaluate burn.  Returns the
        current paging-condition burn (``max_burn``).  Bounded host
        work only — called inside the dispatcher round."""
        now = self.clock() if now is None else now
        if not self.store.maybe_sample(now):
            return self.max_burn()
        events = []
        for name, spec in self._tracked.items():
            burns = self.last_burn.setdefault(name, {})
            for w in self.windows:
                good = self.store.window_delta(f"slo.{name}.good", w, now)
                total = self.store.window_delta(f"slo.{name}.total", w, now)
                b = burn_rate(good, total, spec.objective)
                burns[w] = b
                self.g_burn.set(b, slo=name, window=f"{w:g}s")
                events.append((f"slo_burn_rate/{name}/{w:g}s", b,
                               self.store.samples_taken))
            self._evaluate_alerts(name, burns, events)
        if self._monitor is not None and events:
            try:
                self._monitor.write_events(events)
            except Exception:  # noqa: BLE001 — monitoring fan-out must
                pass           # never take the dispatcher down
        return self.max_burn()

    def _evaluate_alerts(self, name: str, burns: Dict[float, float],
                         events: list) -> None:
        thr = self.config.alert_burn_threshold
        page = bool(burns) and all(b >= thr for b in burns.values())
        warn = (not page and bool(burns)
                and burns[self.windows[0]] >= thr)
        for severity, active in (("page", page), ("warn", warn)):
            key = (name, severity)
            was = self._alerting.get(key, False)
            if active and not was:
                self.c_alerts.inc(1, slo=name, severity=severity)
                events.append(
                    (f"slo_alerts_total/{name}/{severity}",
                     self.c_alerts.value(slo=name, severity=severity),
                     self.store.samples_taken))
            self._alerting[key] = active

    # --------------------------------------------------------------- reads
    def max_burn(self) -> float:
        """The control-loop signal: per SLO the PAGE-condition burn (the
        minimum across windows — every window must agree, so one noisy
        short window cannot trip the autoscaler), maximum across SLOs."""
        worst = 0.0
        for burns in self.last_burn.values():
            if burns:
                worst = max(worst, min(burns.values()))
        return worst

    def alerts_total(self) -> float:
        total = 0.0
        for (name, severity) in self._alerting:
            total += self.c_alerts.value(slo=name, severity=severity)
        return total
