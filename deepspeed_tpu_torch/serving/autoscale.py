"""PoolAutoscaler — signal-driven prefill/decode pool rebalancing for the
disaggregated serving fleet.

The PyTorch port's copy of deepspeed_tpu/serving/autoscale.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

Splitting the fleet into phase-specialist pools (serving/fleet.py,
``FleetConfig.disaggregated``) trades one sizing problem for another: a
fixed prefill/decode split is only right for one workload shape, and real
traffic drifts — a burst of long prompts starves the prefill pool (TTFT
blows up while decode replicas idle), a burst of long generations starves
decode (TPOT blows up while prefill replicas idle).  The autoscaler closes
that loop from signals the serving telemetry already emits, no new
instrumentation required:

- **TTFT-vs-TPOT histogram skew** — the ratio of fleet-wide p99
  ``serving_ttft_ms`` to p99 ``serving_tpot_ms``.  TTFT is paid in the
  prefill pool, TPOT in the decode pool, so the ratio points at the
  starved side: above ``skew_to_prefill`` a decode replica flips to
  prefill, below ``skew_to_decode`` a prefill replica flips to decode.
  The fleet's serving histograms are per-``replica``-labeled series over
  one shared registry; the fleet-wide read aggregates across label sets
  (max p99 — the SLO-relevant replica IS the worst one).
- **admission shedding rate** — when the admission controller is actively
  shedding (hysteresis latch + its windowed rejection rate,
  ``AdmissionController.shed_rate``), the fleet is in overload and a
  mis-sized pool is costing goodput NOW: both skew thresholds tighten by
  ``shed_tighten`` so the autoscaler acts earlier.

Decisions are bounded, never a correctness gate: per-pool floors
(``min_prefill``/``min_decode``), an evaluation ``interval_s``, a
``cooldown_s`` between moves, and a ``min_requests`` signal-mass floor
keep one noisy percentile from flapping replicas.  The MOVE itself is the
fleet's job (``ServingFleet._rebalance_pools``): it flips an IDLE
replica's role and respawns it as a fresh engine; once the new role has
served in this process its kernels are loaded (ops/builder.py), so the
flip is a warm respawn that builds nothing.

Metrics: ``pool_rebalances_total`` (per direction) counts moves,
``pool_replicas`` (per role) gauges the current split.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

from deepspeed_tpu_torch.config import DeepSpeedConfigModel
from deepspeed_tpu_torch.telemetry.registry import MetricRegistry
from deepspeed_tpu_torch.utils.logging import logger


@dataclasses.dataclass
class AutoscaleConfig(DeepSpeedConfigModel):
    """``autoscale`` block of the fleet config (disaggregated mode only).

    ``skew_to_prefill``/``skew_to_decode`` bound the healthy band of
    p99-TTFT / p99-TPOT: a prefill-starved fleet queues prompts (TTFT
    grows, TPOT flat — ratio rises above the band), a decode-starved one
    queues tokens (ratio falls below it).  The defaults are deliberately
    wide: prefill is prompt-sized work and TTFT p99 legitimately sits
    well above per-token latency; only sustained skew past the band means
    the SPLIT is wrong rather than the workload heavy."""

    enabled: bool = False
    min_prefill: int = 1
    min_decode: int = 1
    interval_s: float = 0.25        # signal evaluation cadence
    cooldown_s: float = 1.0         # minimum time between moves
    skew_to_prefill: float = 50.0   # ratio above: decode replica -> prefill
    skew_to_decode: float = 2.0     # ratio below: prefill replica -> decode
    shed_tighten: float = 2.0       # threshold tightening while shedding
    min_requests: int = 4           # completed-request mass before acting
    # opt-in SLO burn-rate input (serving/slo.py): while the fleet's
    # paging-condition burn is at or past ``high_slo_burn``, the skew
    # thresholds tighten by ``shed_tighten`` exactly as during admission
    # shedding — the error budget is being spent too fast, so a
    # mis-sized split must be corrected earlier
    slo_burn_input: bool = False
    high_slo_burn: float = 1.0


class PoolAutoscaler:
    """Pure decision core + metric bookkeeping; the fleet owns the move.

    Separation of concerns mirrors the admission controller: ``signals()``
    reads the shared registry, ``decide()`` is a pure function of those
    signals (deterministic unit tests feed it directly), ``evaluate()``
    adds the rate limits and pool floors, and ``record_move()`` books a
    move the fleet actually performed."""

    def __init__(self, config: Optional[AutoscaleConfig] = None, *,
                 registry: MetricRegistry,
                 clock: Callable[[], float]):
        self.config = AutoscaleConfig.parse(config)
        self.registry = registry
        self.clock = clock
        self._last_eval = -math.inf
        self._last_move = -math.inf
        self.last_signals: Dict[str, float] = {}
        self.c_rebalances = registry.counter(
            "pool_rebalances_total", "replicas moved between the prefill "
            "and decode pools by the autoscaler, per direction "
            "(to_prefill / to_decode)")
        self.g_pool = registry.gauge(
            "pool_replicas", "healthy replicas per disaggregated pool "
            "role (prefill / decode)")

    # -------------------------------------------------------------- signals
    def _fleet_p99(self, name: str):
        """(max p99 across the metric's per-replica label sets, total
        observation count).  Serving histograms carry a per-``replica``
        label over the shared fleet registry and ``Histogram.quantile`` is
        exact-label-match, so a fleet-wide read must aggregate across the
        label sets; max is the SLO-relevant aggregate (the worst replica
        is the one breaching)."""
        m = self.registry._metrics.get(name)
        if m is None or getattr(m, "kind", "") != "histogram":
            return float("nan"), 0
        worst, count = float("nan"), 0
        for _labels, stats in m.samples():
            count += int(stats.get("count", 0))
            p99 = float(stats.get("p99", float("nan")))
            if not math.isnan(p99) and \
                    (math.isnan(worst) or p99 > worst):
                worst = p99
        return worst, count

    def signals(self, *, shedding: bool = False,
                shed_rate: float = 0.0,
                slo_burn: Optional[float] = None) -> Dict[str, float]:
        """Read the landed signals off the shared registry.  ``shedding``/
        ``shed_rate`` come from the fleet's admission controller and
        ``slo_burn`` from its SLO monitor (they are controller state, not
        registry series with a stable cross-version shape)."""
        ttft, n_ttft = self._fleet_p99("serving_ttft_ms")
        tpot, n_tpot = self._fleet_p99("serving_tpot_ms")
        return {"ttft_p99_ms": ttft, "tpot_p99_ms": tpot,
                "requests": min(n_ttft, n_tpot),
                "shedding": bool(shedding),
                "shed_rate": float(shed_rate),
                "slo_burn": (float(slo_burn)
                             if slo_burn is not None else 0.0)}

    # ------------------------------------------------------------- decision
    def decide(self, signals: Dict[str, float]) -> Optional[str]:
        """Pure skew decision: "to_prefill", "to_decode", or None.  No
        clocks, no floors — ``evaluate`` layers those on."""
        cfg = self.config
        if signals.get("requests", 0) < cfg.min_requests:
            return None
        ttft = signals.get("ttft_p99_ms", float("nan"))
        tpot = signals.get("tpot_p99_ms", float("nan"))
        if math.isnan(ttft) or math.isnan(tpot) or tpot <= 0.0:
            return None
        burning = (cfg.slo_burn_input
                   and signals.get("slo_burn", 0.0) >= cfg.high_slo_burn)
        tighten = (cfg.shed_tighten
                   if (signals.get("shedding") or burning) else 1.0)
        ratio = ttft / tpot
        if ratio > cfg.skew_to_prefill / tighten:
            return "to_prefill"
        if ratio < cfg.skew_to_decode * tighten:
            return "to_decode"
        return None

    def evaluate(self, now: float, pool_sizes: Dict[str, int], *,
                 shedding: bool = False,
                 shed_rate: float = 0.0,
                 slo_burn: Optional[float] = None) -> Optional[str]:
        """Rate-limited decision against the live pool sizes: returns a
        direction the fleet should move ONE replica in, or None.  Keeps
        the ``pool_replicas`` gauge fresh as a side effect (it reads the
        fleet's actual role census, so it is correct even when no move
        happens)."""
        for role in ("prefill", "decode"):
            self.g_pool.set(float(pool_sizes.get(role, 0)), role=role)
        cfg = self.config
        if not cfg.enabled:
            return None
        if now - self._last_eval < cfg.interval_s:
            return None
        self._last_eval = now
        # kept for the bench/tests: proof of what the control loop SAW
        # (e.g. "the burn-rate alert reached the autoscaler hook")
        self.last_signals = self.signals(shedding=shedding,
                                         shed_rate=shed_rate,
                                         slo_burn=slo_burn)
        direction = self.decide(self.last_signals)
        if direction is None:
            return None
        if now - self._last_move < cfg.cooldown_s:
            return None
        donor = "decode" if direction == "to_prefill" else "prefill"
        floor = (cfg.min_decode if donor == "decode"
                 else cfg.min_prefill)
        if pool_sizes.get(donor, 0) <= floor:
            return None
        return direction

    def record_move(self, direction: str, now: float) -> None:
        """Book one completed move (the fleet flipped a replica)."""
        self._last_move = now
        self.c_rebalances.inc(1, direction=direction)
        logger.info(f"autoscaler: moved one replica {direction}")
