"""Admission control / graceful degradation for the serving fleet.

The PyTorch port's copy of deepspeed_tpu/serving/admission.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

At overload, a serving tier has exactly two choices: shed load early with
a cheap, explicit rejection, or accept everything and let every request's
latency fall off a cliff together (the queue grows without bound, TTFT
p99 explodes, and the SLO goodput the serving telemetry measures collapses
to zero even
though tokens/s looks fine).  This controller implements the first choice
as a control loop over the two overload signals the telemetry layer
already emits:

- ``kv_alloc_failures_total`` — every starved allocator decision site in
  the v2 engine counts here (with the fleet's shared registry the sum
  spans every replica's series);
- router queue depth — requests arrived and waiting for dispatch.

**Hysteresis**: shedding trips when EITHER signal crosses its high
watermark and releases only when BOTH are back under their low
watermarks, so the controller cannot flap on a load level that hovers at
one threshold (reject → queue drains → admit → queue refills → ...).

A shed request gets a 429-style rejection with a ``retry_after_s`` hint;
the fleet re-enters it after that delay (the in-process stand-in for the
client's retry) without burning the router's retry budget — admission
rejections are back-pressure, not failures.  ``max_rejections`` bounds
how long one request can be shed before it surfaces a typed
``RequestFailed(reason="admission")`` (0 = shed indefinitely: pure
back-pressure).

Chaos site: ``admission.decide`` fires on every decision.  The fleet
treats an injected fault here as *fail open* (admit) — admission is an
optimization layer and must never become a correctness gate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from deepspeed_tpu_torch.config import DeepSpeedConfigModel
from deepspeed_tpu_torch.runtime import faults


@dataclasses.dataclass
class AdmissionConfig(DeepSpeedConfigModel):
    """``admission`` block of the fleet config.  The ``*_queue_depth``
    band is in requests; the ``*_kv_failures_per_s`` band is the RATE of
    the fleet-wide ``kv_alloc_failures_total`` sum — the counter delta
    normalized by elapsed wall time, measured over spans of at least
    ``rate_window_s``.  The tick period is load-variable (the dispatcher
    tick stretches under exactly the conditions admission exists for), so
    a raw per-tick delta would make the effective threshold drift with
    load; per-second is load-invariant, and the minimum window keeps
    back-to-back event-driven ticks from reading one isolated failure as
    an instantaneous thousands/s burst.  The legacy
    ``*_kv_failures_per_tick`` spellings are rejected with a rename hint
    instead of being silently kept in ``extra`` by the base config."""

    enabled: bool = True
    high_queue_depth: int = 64
    low_queue_depth: int = 16
    high_kv_failures_per_s: float = 128.0
    low_kv_failures_per_s: float = 4.0
    # minimum wall-time span a kv-failure rate is measured over: the
    # dispatcher tick is EVENT-driven (back-to-back ticks can be <1 ms
    # apart), so an instantaneous delta/dt estimate would let one isolated
    # failure between two such ticks read as thousands/s and trip
    # fleet-wide shedding; ticks inside the window reuse the last
    # full-window rate
    rate_window_s: float = 0.25
    retry_after_s: float = 0.25
    max_rejections: int = 0          # 0 = unbounded client retries
    # opt-in third signal (serving/slo.py): SLO burn rate as a shed
    # trigger.  Queue depth and kv starvation are CAUSE signals; burn
    # rate is the EFFECT signal — latency already out of budget — so it
    # catches overloads the queue cannot see (e.g. slow replicas at low
    # depth).  Same hysteresis contract: trips at high, releases only
    # when back under low (and the other signals agree).
    slo_burn_shed: bool = False
    high_slo_burn: float = 2.0
    low_slo_burn: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        if self.rate_window_s <= 0:
            raise ValueError(
                f"admission.rate_window_s must be > 0, got "
                f"{self.rate_window_s}")
        extras = getattr(self, "extra", None) or {}
        legacy = [k for k in extras if k.endswith("_kv_failures_per_tick")]
        if legacy:
            raise ValueError(
                f"admission config keys {legacy} were renamed: the "
                f"threshold is now normalized by elapsed time — use "
                f"high_kv_failures_per_s / low_kv_failures_per_s "
                f"(failures per SECOND, not per load-variable tick)")


class AdmissionController:
    """One instance per fleet; ``update()`` runs once per dispatcher tick,
    ``decide()`` once per dispatch attempt."""

    def __init__(self, config: Optional[AdmissionConfig] = None, *,
                 registry, clock: Callable[[], float]):
        cfg = config or AdmissionConfig()
        if cfg.low_queue_depth > cfg.high_queue_depth:
            raise ValueError(
                f"admission hysteresis band inverted: low_queue_depth="
                f"{cfg.low_queue_depth} > high_queue_depth="
                f"{cfg.high_queue_depth}")
        if cfg.low_kv_failures_per_s > cfg.high_kv_failures_per_s:
            raise ValueError(
                f"admission hysteresis band inverted: "
                f"low_kv_failures_per_s={cfg.low_kv_failures_per_s} "
                f"> high_kv_failures_per_s="
                f"{cfg.high_kv_failures_per_s}")
        self.config = cfg
        self.clock = clock
        self.registry = registry
        self.shedding = False
        # kv-failure rate measured over >= rate_window_s spans (see
        # AdmissionConfig.rate_window_s); ticks inside an open window
        # reuse the last full-window rate
        self._rate = 0.0
        self._win_start_t: Optional[float] = None
        self._win_start_total: Optional[float] = None
        # shed rate (rejections/s) over the same windows: the pool
        # autoscaler's overload signal (serving/autoscale.py) — a
        # mis-sized disaggregated pool split shows up here first
        self._shed_rate = 0.0
        self._win_start_rejections: Optional[float] = None
        self.c_rejections = registry.counter(
            "admission_rejections_total", "requests shed (429-style, with "
            "retry-after) by the fleet admission controller before "
            "dispatch")
        self.g_shedding = registry.gauge(
            "admission_shedding", "1 while the admission controller is in "
            "its shedding state (hysteresis band tripped), else 0")
        self.g_shedding.set(0.0)

    # ------------------------------------------------------------- signals
    def kv_failures_total(self) -> float:
        """Fleet-wide sum of ``kv_alloc_failures_total`` over every label
        set (site x replica) in the shared registry."""
        m = self.registry._metrics.get("kv_alloc_failures_total")
        if m is None:
            return 0.0
        return sum(v for _, v in m.samples())

    def shed_rate(self) -> float:
        """Requests shed per second over the last full rate window (same
        windowing as the kv-failure rate).  Read by the pool autoscaler:
        a nonzero shed rate means overload, where a mis-sized
        prefill/decode split costs goodput immediately."""
        return self._shed_rate

    # -------------------------------------------------------- control loop
    def update(self, queue_depth: int,
               kv_failures_total: Optional[float] = None,
               slo_burn: Optional[float] = None) -> bool:
        """One control tick: fold the current signals through the
        hysteresis band and return the (possibly new) shedding state.
        ``kv_failures_total`` is injectable for tests; by default it is
        read from the shared registry.  The kv signal is the counter delta
        NORMALIZED by wall time (failures/s): the dispatcher tick
        stretches under load, and an un-normalized per-tick delta would
        raise the effective trip threshold exactly when shedding matters
        most.  The rate is measured over at least ``rate_window_s`` of
        wall time (not tick-to-tick): ticks are event-driven and can land
        back-to-back, where an instantaneous delta/dt would let a single
        failure read as thousands/s."""
        cfg = self.config
        if not cfg.enabled:
            return False
        total = (self.kv_failures_total() if kv_failures_total is None
                 else float(kv_failures_total))
        rejections = self.c_rejections.value()
        now = self.clock()
        if self._win_start_t is None:
            self._win_start_t = now
            self._win_start_total = total
            self._win_start_rejections = rejections
        elapsed = now - self._win_start_t
        if elapsed >= float(cfg.rate_window_s):
            self._rate = max(0.0, total - self._win_start_total) / elapsed
            self._shed_rate = max(
                0.0, rejections - (self._win_start_rejections or 0.0)) \
                / elapsed
            self._win_start_t = now
            self._win_start_total = total
            self._win_start_rejections = rejections
        rate = self._rate
        # opt-in SLO burn-rate signal (None when the fleet runs no SLO
        # monitor, 0.0 participation when the feature flag is off)
        burn = (float(slo_burn)
                if cfg.slo_burn_shed and slo_burn is not None else None)
        if not self.shedding:
            if (queue_depth > cfg.high_queue_depth
                    or rate >= cfg.high_kv_failures_per_s
                    or (burn is not None and burn >= cfg.high_slo_burn)):
                self.shedding = True
        else:
            if (queue_depth <= cfg.low_queue_depth
                    and rate <= cfg.low_kv_failures_per_s
                    and (burn is None or burn <= cfg.low_slo_burn)):
                self.shedding = False
        self.g_shedding.set(1.0 if self.shedding else 0.0)
        return self.shedding

    # ------------------------------------------------------------ decision
    def decide(self, req) -> Tuple[bool, float]:
        """Admit or shed one request: ``(admitted, retry_after_s)``.
        Fires the ``admission.decide`` chaos site; the fleet catches any
        injected fault and admits (fail open)."""
        faults.fire("admission.decide", index=getattr(req, "index", None))
        if not self.config.enabled or not self.shedding:
            return True, 0.0
        self.c_rejections.inc(1)
        req.rejections += 1
        return False, self.config.retry_after_s
