"""ServingTelemetry — request-level observability for the inference engines.

The PyTorch port's copy of deepspeed_tpu/telemetry/serving.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

This facade is the serving-side sibling of the training telemetry, built
for the questions a serving operator actually asks:

- **latency percentiles** (p50/p99 TTFT / TPOT / e2e) — histograms, because
  a counter can only produce a mean and SLOs are percentiles;
- **where a request's time went** — per-request lifecycle spans
  (queue_wait → prefill → decode) on one Perfetto track per request,
  next to the engine's dispatch spans on track 0;
- **is the KV pool the bottleneck** — blocks used/free, internal
  fragmentation of allocated pages, and allocation-failure counters per
  decision site (the baseline a radix prefix cache has to beat);
- **why is speculative decoding slow** — accepted/proposed tokens and
  draft/verify wall-time counters replacing ``eng.spec_stats``.

One instance per engine with its OWN ``MetricRegistry`` by default (two
engines in one process — the bench runs seven — must not blend their
accept ratios); pass ``registry=telemetry.default_registry`` to fold the
serving series into the process-wide scrape instead.

Timestamps: request lifecycle times are ``time.perf_counter()`` seconds
(callers may substitute a fake clock for deterministic tests); spans
convert through the tracer's epoch so request tracks line up with
dispatch spans in one trace.
"""

from __future__ import annotations

import dataclasses
import os
import time
from contextlib import nullcontext
from typing import Dict, Optional

from deepspeed_tpu_torch.config import DeepSpeedConfigModel
from deepspeed_tpu_torch.telemetry.exporter import SnapshotExporter
from deepspeed_tpu_torch.telemetry.registry import MetricRegistry
from deepspeed_tpu_torch.telemetry.tracer import SpanTracer, TraceEmitter

_NULL = nullcontext()


def _process_index() -> int:
    """This process's rank in a ``torch.distributed`` group, else 0 (the
    trace pid, so that traces of several processes merge cleanly)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


@dataclasses.dataclass
class ServingTelemetryConfig(DeepSpeedConfigModel):
    """``telemetry`` block of the inference engine configs.

    ``enabled`` covers counters/gauges/histograms (a few dict updates and
    ``perf_counter`` reads per DISPATCH, not per token — cheap enough to
    default on).  ``trace_enabled`` adds span recording (bounded buffer).
    ``stream_sync`` blocks on each dispatch's output before timestamping —
    the streaming-server behavior that makes TTFT/TPOT reflect device
    completion instead of host submission; it serializes the dispatch
    pipeline, so it defaults off and the open-loop bench harness turns it
    on explicitly."""

    enabled: bool = True
    trace_enabled: bool = True
    max_trace_events: int = 100_000
    stream_sync: bool = False
    # fleet mode (serving/fleet.py): the replica's name, threaded as a
    # ``replica`` label into EVERY serving metric family so N replicas can
    # share one fleet-level registry without blending their series; None
    # (single-engine default) adds no label, keeping the series names the
    # dashboards already scrape
    replica: Optional[str] = None


class ServingTelemetry:
    def __init__(self, config: Optional[ServingTelemetryConfig] = None,
                 registry: Optional[MetricRegistry] = None,
                 pid: Optional[int] = None):
        cfg = config or ServingTelemetryConfig()
        self.config = cfg
        self.enabled = bool(cfg.enabled)
        self.stream_sync = bool(cfg.stream_sync)
        # fleet mode: one shared registry + a per-replica label on every
        # series (the merge into self.labels below threads it through each
        # write AND each read, so quantile()/value() callers stay oblivious)
        self.labels: Dict[str, str] = (
            {"replica": str(cfg.replica)} if cfg.replica else {})
        self.registry = registry if registry is not None else MetricRegistry()
        if pid is None:
            pid = _process_index()
        self.tracer = SpanTracer(
            enabled=self.enabled and bool(cfg.trace_enabled), pid=pid,
            max_events=int(cfg.max_trace_events))
        self.emitter = TraceEmitter(process_name="deepspeed_tpu_serving")
        self.exporter = SnapshotExporter(self.registry, self.tracer)
        self._track_count = 0
        # per-request summaries (bounded): histograms answer fleet-level
        # percentile questions, but goodput ("which requests met BOTH their
        # TTFT and TPOT SLOs, and how many tokens did those produce") needs
        # per-request joint attainment — the bench reads this log
        self.request_log: list = []
        self.request_log_cap = 100_000
        if not self.enabled:
            return
        reg = self.registry
        # ---- registered eagerly: every metric carries its help text from
        # the first scrape, and scripts/check_metrics.py sees the literals
        self.h_ttft = reg.histogram(
            "serving_ttft_ms", "request arrival to first generated token "
            "(time-to-first-token), per completed request")
        self.h_tpot = reg.histogram(
            "serving_tpot_ms", "mean inter-token latency after the first "
            "token (time-per-output-token), per completed request")
        self.h_e2e = reg.histogram(
            "serving_e2e_ms", "request arrival to completion, per request")
        self.h_queue = reg.histogram(
            "serving_queue_ms", "request arrival to admission (first "
            "prompt chunk scheduled), per request")
        self.h_prefill = reg.histogram(
            "serving_prefill_ms", "admission to prefill complete (request "
            "decode-ready), per request")
        self.c_requests = reg.counter(
            "serving_requests_total", "requests retired, per outcome")
        self.c_tokens = reg.counter(
            "serving_tokens_total", "tokens scheduled through the serving "
            "engine, per phase (prefill / decode / spec)")
        self.c_dispatch = reg.counter(
            "serving_dispatches_total", "device dispatches issued by the "
            "serving engine, per program kind")
        self.c_preempt = reg.counter(
            "serving_preemptions_total", "recompute-preemption victims "
            "taken, per victim state (decode_ready / mid_prefill)")
        self.g_occupancy = reg.gauge(
            "serving_batch_occupancy", "running sequences / sequence slots "
            "at the most recent dispatch")
        self.g_padding = reg.gauge(
            "serving_bucket_padding_waste", "dead fraction of the most "
            "recent mixed forward's padded token bucket "
            "((bucket - live tokens) / bucket)")
        self.c_kv_fail = reg.counter(
            "kv_alloc_failures_total", "KV block/slot requests the "
            "allocator could not satisfy, per decision site")
        self.g_kv_blocks = reg.gauge(
            "kv_pool_blocks", "paged KV pool blocks, per state "
            "(used / free)")
        self.g_kv_frag = reg.gauge(
            "kv_pool_fragmentation", "internal fragmentation of allocated "
            "KV blocks: 1 - live tokens / (allocated blocks * block size)")
        # ---- radix shared-prefix cache + SplitFuse scheduler: the
        # control-loop families layered over the pool signals above
        self.c_prefix_lookups = reg.counter(
            "kv_prefix_lookups_total", "radix prefix-cache lookups taken "
            "at sequence admission (one per new sequence while the cache "
            "is enabled)")
        self.c_prefix_hits = reg.counter(
            "kv_prefix_hit_tokens_total", "prompt tokens whose KV was "
            "served by aliasing shared radix-cache blocks — prefill "
            "skipped for every one of them")
        self.g_shared_blocks = reg.gauge(
            "kv_shared_blocks", "KV blocks resident in the radix prefix "
            "cache, per state (cached = indexed total / shared = also "
            "held by a live sequence / evictable = reclaimable by LRU "
            "eviction right now)")
        self.c_prefill_chunks = reg.counter(
            "prefill_chunks_total", "prompt chunks the SplitFuse "
            "scheduler co-scheduled with decode tokens (one per chunk "
            "per round, bounded by prefill_chunk_tokens)")
        self.c_admissions = reg.counter(
            "serving_admissions_total", "engine admission decisions, per "
            "SLA class and decision (admitted / preempted_for)")
        self.c_sla_preempt = reg.counter(
            "serving_sla_preemptions_total", "recompute preemptions the "
            "SLA policy took to protect a higher-priority request's TTFT "
            "SLO, per victim SLA class")
        self.c_spec_outer = reg.counter(
            "spec_outer_steps_total", "speculative draft-and-verify outer "
            "steps executed, summed over sequences")
        self.c_spec_proposed = reg.counter(
            "spec_proposed_tokens_total", "draft tokens proposed to the "
            "verify step (gamma per outer step per sequence)")
        self.c_spec_accepted = reg.counter(
            "spec_draft_accepted_tokens_total", "draft-proposed tokens the "
            "verify step accepted (excludes the per-step bonus/correction "
            "token)")
        self.c_spec_emitted = reg.counter(
            "spec_emitted_tokens_total", "tokens emitted by speculative "
            "outer steps (accepted draft tokens + the bonus/correction "
            "token each step)")
        self.c_spec_ms = reg.counter(
            "spec_burst_ms_total", "wall milliseconds spent in fused "
            "speculative dispatches, including their host sync")
        self.c_spec_draft_ms = reg.counter(
            "spec_draft_ms_total", "wall milliseconds in draft-model "
            "dispatches (speculative.profile split mode only)")
        self.c_spec_verify_ms = reg.counter(
            "spec_verify_ms_total", "wall milliseconds in verify "
            "dispatches (speculative.profile split mode only)")
        self.g_spec_ratio = reg.gauge(
            "spec_accept_ratio", "cumulative draft-token acceptance: "
            "accepted / proposed")
        # ---- multi-tenant LoRA adapters: the paged adapter pool
        # sharing the KV allocator (serving/adapters.py)
        self.c_adapter_loads = reg.counter(
            "adapter_loads_total", "LoRA adapter residency resolutions at "
            "request admission, per outcome (hit = pages already resident "
            "/ miss = first host load / reload = re-load after eviction / "
            "failed = pool could not fit the pages)")
        self.c_adapter_evict = reg.counter(
            "adapter_evictions_total", "cold LoRA adapters evicted from "
            "the shared paged pool to reclaim blocks (LRU, never a pinned "
            "adapter)")
        self.g_adapter_hit = reg.gauge(
            "adapter_hit_rate", "cumulative fraction of adapter "
            "activations served from resident pages without a host "
            "reload: hits / (hits + misses)")
        self.g_adapter_blocks = reg.gauge(
            "adapter_pool_blocks", "pool blocks holding LoRA adapter "
            "pages, per state (resident = all loaded adapters / pinned = "
            "held by in-flight requests / evictable = reclaimable by LRU "
            "eviction right now)")

    # ------------------------------------------------------------- clocks

    @staticmethod
    def now() -> float:
        """Lifecycle clock (seconds).  One definition so engine timestamps
        and histogram math never mix clock bases."""
        return time.perf_counter()

    def _trace_us(self, t_seconds: float) -> float:
        """Map a lifecycle timestamp onto the tracer's microsecond epoch so
        request tracks align with dispatch spans."""
        return t_seconds * 1e9 / 1e3 - self.tracer._epoch_ns / 1e3

    # -------------------------------------------------------------- spans

    def span(self, name: str, **args):
        if not self.tracer.enabled:
            return _NULL
        return self.tracer.span(name, **args)

    # ---------------------------------------------------- request lifecycle

    def new_track(self, label: str) -> int:
        """Allocate a trace track (tid) for one request; tid 0 stays the
        engine dispatch track.  Track NAMES are bounded by the event-buffer
        size: a long-lived engine serves unboundedly many requests, and an
        unbounded thread_names dict would leak ~100B per request forever
        (the span deque itself is bounded) — requests past the bound still
        get a tid, just no name metadata (the bound now lives inside
        ``SpanTracer.set_thread_name``)."""
        self._track_count += 1
        tid = self._track_count
        if self.tracer.enabled:
            self.tracer.set_thread_name(tid, label)
        return tid

    def finish_request(self, *, uid, track: int, t_arrival: float,
                       t_admit: Optional[float],
                       t_prefill_end: Optional[float],
                       t_first: Optional[float], t_last: Optional[float],
                       n_prompt: int, n_generated: int,
                       preempts: int = 0, outcome: str = "completed",
                       trace=None) -> None:
        """Record one retired request: latency histograms + the three
        lifecycle spans on the request's own track.  Timestamps are
        ``now()`` seconds; missing stages (a zero-token completion) are
        skipped rather than guessed."""
        if not self.enabled:
            return
        self.c_requests.inc(1, outcome=outcome, **self.labels)
        t_done = t_last if t_last is not None else self.now()
        rec = {"uid": uid, "outcome": outcome,
               "prompt_tokens": int(n_prompt),
               "generated_tokens": int(n_generated),
               "preempts": int(preempts),
               "e2e_ms": (t_done - t_arrival) * 1e3,
               "ttft_ms": None, "tpot_ms": None}
        self.h_e2e.observe(rec["e2e_ms"], **self.labels)
        if t_admit is not None:
            self.h_queue.observe((t_admit - t_arrival) * 1e3, **self.labels)
            if t_prefill_end is not None:
                self.h_prefill.observe((t_prefill_end - t_admit) * 1e3,
                                       **self.labels)
        if t_first is not None:
            rec["ttft_ms"] = (t_first - t_arrival) * 1e3
            self.h_ttft.observe(rec["ttft_ms"], **self.labels)
            if t_last is not None and n_generated > 1:
                rec["tpot_ms"] = (t_last - t_first) * 1e3 / (n_generated - 1)
                self.h_tpot.observe(rec["tpot_ms"], **self.labels)
        if len(self.request_log) < self.request_log_cap:
            self.request_log.append(rec)
        if self.tracer.enabled:
            args = {"uid": uid, "prompt_tokens": int(n_prompt),
                    "generated_tokens": int(n_generated),
                    "preempts": int(preempts), "outcome": outcome}
            if trace is not None:
                # distributed-trace coordinates: critical_path.py matches
                # these engine spans back to fleet requests by (trace,
                # phase) and picks the final attempt by timestamp
                args.update(trace.args())
            spans = [("queue_wait", t_arrival, t_admit),
                     ("prefill", t_admit, t_prefill_end),
                     ("decode", t_prefill_end, t_last)]
            first_ts = None
            for name, a, b in spans:
                if a is None or b is None or b < a:
                    continue
                ts = self._trace_us(a)
                if first_ts is None:
                    first_ts = (ts, (b - a) * 1e6)
                self.tracer.record(name, ts, (b - a) * 1e6,
                                   tid=track, cat="request", **args)
            if (trace is not None and trace.flow_id is not None
                    and first_ts is not None):
                # flow step binding to this replica's first lifecycle
                # slice: the router's `s` event + this `t` + the fleet's
                # `f` stitch the request into one cross-replica tree
                self.tracer.flow("t", trace.flow_id,
                                 first_ts[0] + first_ts[1] / 2, tid=track)

    # ----------------------------------------------------------- counters

    def dispatch(self, kind: str) -> None:
        if self.enabled:
            self.c_dispatch.inc(1, kind=kind, **self.labels)

    def tokens(self, phase: str, n: int) -> None:
        if self.enabled and n:
            self.c_tokens.inc(n, phase=phase, **self.labels)

    def preemption(self, kind: str) -> None:
        if self.enabled:
            self.c_preempt.inc(1, kind=kind, **self.labels)

    def sla_preemption(self, sla: str) -> None:
        if self.enabled:
            self.c_sla_preempt.inc(1, sla=sla, **self.labels)

    def admission(self, sla: str, decision: str = "admitted") -> None:
        if self.enabled:
            self.c_admissions.inc(1, sla=sla, decision=decision,
                                  **self.labels)

    def prefix_lookup(self, hit_tokens: int) -> None:
        """One radix-cache admission lookup; ``hit_tokens`` is the matched
        prefix length actually aliased (0 on a miss)."""
        if self.enabled:
            self.c_prefix_lookups.inc(1, **self.labels)
            if hit_tokens:
                self.c_prefix_hits.inc(hit_tokens, **self.labels)

    def prefill_chunk(self) -> None:
        if self.enabled:
            self.c_prefill_chunks.inc(1, **self.labels)

    def occupancy(self, running: int, slots: int) -> None:
        if self.enabled and slots:
            self.g_occupancy.set(running / slots, **self.labels)

    def padding_waste(self, live_tokens: int, bucket: int) -> None:
        if self.enabled and bucket:
            self.g_padding.set((bucket - live_tokens) / bucket, **self.labels)

    # ------------------------------------------------------------ KV pool

    def alloc_failure(self, site: str, n: int = 1) -> None:
        if self.enabled:
            self.c_kv_fail.inc(n, site=site, **self.labels)

    def kv_sample(self, state) -> None:
        """Gauge the paged pool off a DSStateManager: used/free blocks and
        internal fragmentation.  O(tracked sequences) — called once per
        scheduler round, not per token."""
        if not self.enabled:
            return
        free = state.allocator.free_blocks
        total = state.allocator.num_blocks
        used = total - free
        self.g_kv_blocks.set(used, state="used", **self.labels)
        self.g_kv_blocks.set(free, state="free", **self.labels)
        alloc_tokens = 0
        live_tokens = 0
        for seq in state.tracked.values():
            alloc_tokens += len(seq.blocks) * state.block_size
            live_tokens += seq.seen_tokens
        self.g_kv_frag.set(
            1.0 - live_tokens / alloc_tokens if alloc_tokens else 0.0,
            **self.labels)
        radix = getattr(state, "radix", None)
        if radix is not None:
            st = radix.stats()
            self.g_shared_blocks.set(st["nodes"], state="cached",
                                     **self.labels)
            self.g_shared_blocks.set(st["shared"], state="shared",
                                     **self.labels)
            self.g_shared_blocks.set(st["evictable"], state="evictable",
                                     **self.labels)
        pool = getattr(state, "adapters", None)
        if pool is not None:
            st = pool.stats()
            self.g_adapter_blocks.set(st["resident_blocks"],
                                      state="resident", **self.labels)
            self.g_adapter_blocks.set(st["pinned_blocks"], state="pinned",
                                      **self.labels)
            self.g_adapter_blocks.set(st["evictable_blocks"],
                                      state="evictable", **self.labels)

    # ------------------------------------------------- multi-tenant adapters

    def adapter_load(self, outcome: str, hit_rate: float) -> None:
        """One adapter residency resolution (AdapterPool.ensure); the pool
        passes its cumulative hit rate so the gauge tracks the counter
        without a registry read-back."""
        if self.enabled:
            self.c_adapter_loads.inc(1, outcome=outcome, **self.labels)
            self.g_adapter_hit.set(hit_rate, **self.labels)

    def adapter_eviction(self, n: int = 1) -> None:
        if self.enabled:
            self.c_adapter_evict.inc(n, **self.labels)

    # -------------------------------------------------------- speculative

    def spec_burst(self, *, outer: int, n_seqs: int, gamma: int,
                   emitted: int, dur_ms: float) -> None:
        """Account one fused speculative dispatch: ``emitted`` is the total
        token count the burst produced (counts.sum over the served slots);
        every outer step also emits exactly one non-draft bonus/correction
        token, so draft-accepted = emitted - outer*n_seqs."""
        if not self.enabled:
            return
        steps = outer * n_seqs
        self.c_spec_outer.inc(steps, **self.labels)
        self.c_spec_proposed.inc(steps * gamma, **self.labels)
        self.c_spec_accepted.inc(max(0, emitted - steps), **self.labels)
        self.c_spec_emitted.inc(emitted, **self.labels)
        self.c_spec_ms.inc(dur_ms, **self.labels)
        proposed = self.c_spec_proposed.value(**self.labels)
        if proposed:
            self.g_spec_ratio.set(
                self.c_spec_accepted.value(**self.labels) / proposed,
                **self.labels)

    def spec_profile(self, draft_ms: float, verify_ms: float) -> None:
        if self.enabled:
            self.c_spec_draft_ms.inc(draft_ms, **self.labels)
            self.c_spec_verify_ms.inc(verify_ms, **self.labels)

    def spec_summary(self) -> Dict[str, float]:
        """The bench/test-facing read of the speculative counters (replaces
        the old ``eng.spec_stats`` dict)."""
        if not self.enabled:
            return {}
        L = self.labels
        proposed = self.c_spec_proposed.value(**L)
        outer = self.c_spec_outer.value(**L)
        return {
            "outer_steps": outer,
            "proposed": proposed,
            "accepted": self.c_spec_accepted.value(**L),
            "emitted": self.c_spec_emitted.value(**L),
            "accept_ratio": (self.c_spec_accepted.value(**L) / proposed
                             if proposed else 0.0),
            "emitted_per_outer": (self.c_spec_emitted.value(**L) / outer
                                  if outer else 0.0),
            "burst_ms": self.c_spec_ms.value(**L),
            "draft_ms": self.c_spec_draft_ms.value(**L),
            "verify_ms": self.c_spec_verify_ms.value(**L),
            "draft_dispatches": self.c_dispatch.value(kind="spec_draft", **L),
            "verify_dispatches": self.c_dispatch.value(kind="spec_verify",
                                                       **L),
            # fused draft+verify dispatches: the cross-request batching
            # claim is "dispatches per emitted token strictly lower than
            # per-request spec" — this is the numerator the tests pin
            "spec_dispatches": self.c_dispatch.value(kind="spec", **L),
        }

    # -------------------------------------------------------------- reads

    def value(self, name: str, **labels) -> float:
        """Read one series; an instance's own replica label (fleet mode) is
        merged in so callers address "my" series by the same names a
        single-engine setup uses (pass ``replica=...`` to override)."""
        m = self.registry._metrics.get(name)
        return m.value(**{**self.labels, **labels}) if m is not None else 0.0

    def quantile(self, name: str, q: float, **labels) -> float:
        m = self.registry._metrics.get(name)
        if m is None or m.kind != "histogram":
            return float("nan")
        return m.quantile(q, **{**self.labels, **labels})

    # ------------------------------------------------------------- export

    def export(self, out_dir: str, extra: Optional[dict] = None) -> dict:
        """Write snapshot.json + metrics.prom + trace.json under
        ``out_dir`` and return the snapshot dict.  The trace is the
        combined dispatch (tid 0) + per-request track view Perfetto
        loads directly."""
        if not self.enabled:
            return {}
        os.makedirs(out_dir, exist_ok=True)
        snap = self.exporter.snapshot(extra=extra)
        self.exporter.write_json(os.path.join(out_dir, "snapshot.json"),
                                 snap)
        self.exporter.write_prometheus(
            os.path.join(out_dir, "metrics.prom"), snap)
        if self.tracer.enabled and self.tracer.events:
            self.emitter.write(os.path.join(out_dir, "trace.json"),
                               self.tracer)
        return snap
