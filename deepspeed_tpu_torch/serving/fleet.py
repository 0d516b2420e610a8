"""ServingFleet — N supervised ``InferenceEngineV2`` replicas behind a
failure-tolerant router.

The PyTorch port's copy of deepspeed_tpu/serving/fleet.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

One v2 engine is not a service: a replica death mid-decode used to lose
every in-flight request, and there was no admission, retry, or
degradation story between "one engine" and real traffic.  This module is
the composition layer over the engine's drain semantics, deterministic
fault injection (``runtime/faults.py``) and the serving telemetry (with a
per-replica label over one shared registry) — treating replica failure as
a supported membership event, the
serving-side analogue of the elastic agent's host-loss handling
(arXiv:2004.13336's fault model).

Replica lifecycle (state machine, one worker thread per incarnation)::

    spawn ──> healthy ──────────────> draining ──┐
                │  (request_drain: finish or     │
                │   migrate in-flight, export)   │
                │ death (fault / exception /     │
                │        heartbeat deadline)     │
                ▼                                ▼
              dead ──(respawn: fresh engine on the kernels the
                      process already built = fast resume)──> healthy

Supervision signals: every replica beats once per engine scheduler round
(``replica.heartbeat`` chaos site) and the dispatcher deadlines busy
replicas on ``heartbeat_deadline_s``; the admission controller reads the
fleet-wide ``kv_alloc_failures_total`` sum and router queue depth.

Request flow: the router (serving/router.py) owns pending/inflight/done
with bounded retry + backoff; replica workers run ``engine.generate`` on
their queued batch and report completions or exported migrations through
one event queue back to the dispatcher (single-threaded control plane —
every state transition happens on the ``serve()`` thread).

Token-exactness invariant: all replicas are built from the SAME params
(shared tree or same init seed), decoding is greedy, and migration folds
only host-known generated tokens into the prompt — so any completion
path (direct, migrated once, migrated twice) yields the byte-identical
output of a single no-failure engine, which is what the chaos tests pin.

Chaos wiring: arm ``runtime/faults.py`` sites ``replica.mid_decode``
(death inside the scheduler loop), ``replica.heartbeat`` (``sleep`` =
stalled replica, ``exc`` = death at the beat), ``router.dispatch``
(dispatch-path failure -> retry/backoff), ``admission.decide`` (controller
failure -> fail open), ``handoff.mid_transfer`` (source replica death
between KV pin and handoff commit -> pins released, request re-enters
via the migration fold).

Disaggregated mode (``disaggregated: true``): replicas split into a
prefill pool (serves prompt + FIRST token only — the TTFT-critical
phase) and a decode pool (the token tail).  The phase boundary reuses
the migration fold: the prefill result folds into the prompt and the
request requeues as a decode-phase dispatch, so the decode replica's
prefill over the folded prompt hits either the radix alias of the
handed-off blocks (single-host shared pool) or recomputes token-exactly
— greedy outputs are byte-identical to a unified fleet either way.  A
signal-driven autoscaler (serving/autoscale.py) rebalances the split at
runtime via warm role flips.

Differences from the JAX fleet (by design): the port has no compiled-step
cache, so "warm" means the kernels are loaded: a respawn is warm once an
incarnation of the same role has completed a generate in this process,
since every kernel that generate ran stays in ``ops/builder.py``'s cache
for the life of the process; and every replica
launches on the one default CUDA stream, so the replicas' device work is
serialised, while their host work interleaves under the GIL.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.config import DeepSpeedConfigModel
from deepspeed_tpu_torch.runtime import faults
from deepspeed_tpu_torch.serving.admission import (AdmissionConfig,
                                             AdmissionController)
from deepspeed_tpu_torch.serving.autoscale import AutoscaleConfig, PoolAutoscaler
from deepspeed_tpu_torch.serving.router import (FleetRequest, NoHealthyReplicas,
                                          RequestFailed, Router,
                                          RouterConfig)
from deepspeed_tpu_torch.serving.slo import SLOConfig, SLOMonitor
from deepspeed_tpu_torch.telemetry.registry import MetricRegistry
from deepspeed_tpu_torch.telemetry.tracer import SpanTracer, TraceEmitter
from deepspeed_tpu_torch.utils.logging import logger

REPLICA_STATES = ("spawning", "healthy", "draining", "dead")


class FleetDrained(RuntimeError):
    """``serve()`` stopped because the whole fleet drained (preemption
    notice / ``drain_all``).  Carries what a successor fleet needs:
    ``completed`` (index -> tokens) and ``pending`` (migration-folded
    :class:`FleetRequest` records, original arrival timestamps intact)."""

    def __init__(self, completed: Dict[int, np.ndarray],
                 pending: List[FleetRequest]):
        super().__init__(
            f"fleet drained: {len(completed)} request(s) completed, "
            f"{len(pending)} exported for a successor")
        self.completed = completed
        self.pending = pending


@dataclasses.dataclass
class FleetConfig(DeepSpeedConfigModel):
    """Top-level fleet config.  ``heartbeat_deadline_s`` only applies to
    BUSY replicas (an idle worker beats from its wait loop without the
    chaos site) that have completed WARM-UP — until an incarnation's first
    ``generate`` completes, the (more generous) ``warmup_deadline_s``
    governs instead: a replica's first call legitimately stalls on the
    first-use ``nvcc`` build of its kernels, and a steady-state deadline
    would book a cold replica dead.  ``max_respawns`` bounds
    death-respawns per replica; drain-respawns are planned events and
    bypass it (``respawn_after_drain``).  ``share_compile_cache`` lets a
    respawn count as warm once an incarnation of its role has completed a
    generate in this process (the port builds each kernel once per
    process and keeps it loaded, so there is no per-fleet cache to hand
    out)."""

    num_replicas: int = 2
    heartbeat_deadline_s: float = 10.0
    # deadline for a not-yet-warm incarnation's first busy period (covers
    # the first-use kernel build); never below heartbeat_deadline_s
    warmup_deadline_s: float = 180.0
    respawn: bool = True
    max_respawns: int = 2
    respawn_after_drain: bool = True
    share_compile_cache: bool = True
    poll_interval_s: float = 0.005
    # disaggregated prefill/decode pools: the first ``prefill_replicas``
    # replicas serve ONLY the prompt+first-token phase, the rest only the
    # decode tail; finished prefill KV hands off to the decode replica
    # through the paged pool (refcounted block pin + radix prefix alias —
    # on single-host pools the alias IS the transfer; the multi-host copy
    # is a stub accounted in kv_handoff_bytes_total).  Both phases are
    # greedy over identical weights, so a disaggregated serve is
    # byte-identical to a unified one.
    disaggregated: bool = False
    prefill_replicas: int = 1
    # router-side distributed tracing: the fleet records dispatch /
    # handoff / request-envelope spans plus the Perfetto flow events
    # (``ph`` s/t/f) that stitch one request across the per-replica
    # trace files (telemetry/tracecontext.py).  Bounded like the replica
    # tracers; off = zero per-request trace work on the dispatcher.
    trace_enabled: bool = True
    max_trace_events: int = 100_000
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)


@dataclasses.dataclass(frozen=True)
class _Dispatch:
    """Immutable snapshot of one request at hand-off to a replica worker:
    the worker must never read the live (dispatcher-mutated) FleetRequest.
    ``gen`` is the serve-call generation — events from a zombie worker of
    an earlier serve() are dropped against it."""

    index: int
    epoch: int
    prompt: np.ndarray
    remaining: int
    prefix: Tuple[int, ...]
    gen: int
    # LoRA adapter id serving this request (0 = base model); threaded
    # into engine.generate(adapter_ids=...) when the engine accepts it
    adapter: int = 0
    # TraceContext of the dispatch attempt (already the per-attempt
    # child span — Router.dispatch minted it); threaded into the
    # engine's generate so replica trace files carry the fleet ids
    trace: Any = None


class Replica:
    """One supervised serving replica.  All state transitions happen on
    the dispatcher thread; the worker thread only reads its own
    incarnation's queue and reports through the fleet event queue."""

    def __init__(self, name: str, fleet: "ServingFleet"):
        self.name = name
        self.fleet = fleet
        self.state = "spawning"
        self.engine = None
        # pool membership in disaggregated mode ("prefill"/"decode"; None
        # in unified fleets).  Mutated only by the dispatcher thread — a
        # role flip stale-ifies the worker first (same incarnation fence
        # as a retire), so no worker ever serves across a flip.
        self.role: Optional[str] = None
        self.incarnation = 0
        self.respawns = 0              # death-respawns taken
        self.queue: List[_Dispatch] = []
        self.cond = threading.Condition()
        self.busy = False
        self.last_beat = fleet.clock()
        # warm-up gate: False until this incarnation completes a generate
        # (its first call may build the kernels) — the supervisor deadlines
        # it on warmup_deadline_s, not heartbeat_deadline_s
        self.warmed = False
        self.worker: Optional[threading.Thread] = None

    def beat(self) -> None:
        """Engine-loop liveness beat (once per scheduler round, via
        ``engine.heartbeat_fn``).  Fires the ``replica.heartbeat`` chaos
        site FIRST: a ``sleep`` fault stalls the beat (the supervisor
        deadlines the replica out), an ``exc`` fault kills it here."""
        faults.fire("replica.heartbeat", replica=self.name)
        self.last_beat = self.fleet.clock()

    def enqueue(self, req: FleetRequest) -> None:
        # a prefill-phase request serves the prompt plus EXACTLY one token
        # (full prefill + first sample = the TTFT boundary); the decode
        # phase gets the rest of the budget after the handoff fold
        remaining = 1 if req.phase == "prefill" else req.remaining
        d = _Dispatch(index=req.index, epoch=req.epoch,
                      prompt=np.asarray(req.prompt, np.int32),
                      remaining=remaining,
                      prefix=tuple(req.generated),
                      gen=self.fleet._serve_gen,
                      adapter=int(req.adapter),
                      trace=req.trace)
        with self.cond:
            self.queue.append(d)
            self.cond.notify_all()


class ServingFleet:
    """N supervised replicas + router + admission controller.

    ``model``/``engine_config``/``params`` feed the default engine
    factory (every replica gets identical weights — required for
    token-exact migration); pass ``engine_factory(name)`` to construct
    custom (or fake, in tests) engines instead.  The engine protocol the
    fleet needs: ``generate(prompts, max_new_tokens=list)``,
    ``request_drain()``/``clear_drain()``, ``export_pending_requests()``,
    a writable ``heartbeat_fn`` attribute, and ``EngineDrained`` raised
    on drain.

    One shared ``MetricRegistry`` carries every replica's serving series
    (per-``replica`` label) plus the fleet families
    (``fleet_replica_state``, ``router_retries_total``,
    ``requests_migrated_total``, ``admission_rejections_total``, ...).
    """

    def __init__(self, model=None, engine_config: Optional[dict] = None,
                 params=None, config=None,
                 engine_factory: Optional[Callable[[str], Any]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 registry: Optional[MetricRegistry] = None,
                 preemption_handler=None):
        self.config = FleetConfig.parse(config)
        if self.config.disaggregated:
            n, npre = self.config.num_replicas, self.config.prefill_replicas
            if not 1 <= npre < n:
                raise ValueError(
                    f"disaggregated fleet needs 1 <= prefill_replicas < "
                    f"num_replicas, got prefill_replicas={npre} of {n}")
            # the router must see the same mode (phase-aware pick)
            self.config.router.disaggregated = True
        self.clock = clock or time.monotonic
        self.registry = registry if registry is not None else MetricRegistry()
        self._model = model
        self._engine_config = engine_config or {}
        self._params = params
        # roles (None in a unified fleet) of which some incarnation has
        # completed a generate in this process: its kernels are loaded
        self._served_roles: set = set()
        if engine_factory is None and model is None:
            raise ValueError("pass a model (+ engine_config/params) or an "
                             "engine_factory")
        self._engine_factory = engine_factory or self._default_factory
        self._events: "queue.Queue" = queue.Queue()
        self._serve_gen = 0
        self._fleet_draining = False
        self._admission_failed_open = False
        self.request_log: List[dict] = []
        self.last_failures: Dict[int, RequestFailed] = {}
        self.router = Router(self.config.router, clock=self.clock,
                             registry=self.registry)
        self.admission = AdmissionController(
            self.config.admission, registry=self.registry, clock=self.clock)
        self.g_state = self.registry.gauge(
            "fleet_replica_state", "one-hot replica state machine: 1 for "
            "the replica's current state (spawning / healthy / draining / "
            "dead), 0 for the rest")
        self.c_deaths = self.registry.counter(
            "fleet_replica_deaths_total", "replica deaths booked by the "
            "supervisor, per reason (replica_death / heartbeat_timeout / "
            "drain / respawn_failed)")
        self.c_respawns = self.registry.counter(
            "fleet_respawns_total", "replica respawns (fresh engine on the "
            "kernels the process already built) after a death or drain")
        self.h_recovery = self.registry.histogram(
            "fleet_recovery_ms", "replica death/drain detection to the "
            "replacement healthy (in-flight work is already requeued "
            "before the respawn starts)")
        self.c_handoffs = self.registry.counter(
            "fleet_handoffs_total", "prefill->decode phase handoffs, per "
            "outcome: ok (blocks pinned or accounting-free), aborted "
            "(source died mid-transfer; pins released, request re-entered "
            "through the migration fold)")
        self.c_handoff_bytes = self.registry.counter(
            "kv_handoff_bytes_total", "KV bytes the multi-host handoff "
            "copy path WOULD move (pinned blocks x per-block KV bytes); "
            "single-host pools alias the blocks instead of copying, so "
            "the counter sizes the future wire transfer, not work done")
        # index -> (source replica, incarnation at pin time, pinned block
        # ids): handoff pins released at final completion (or dropped when
        # the source incarnation — and with it the allocator — is gone)
        self._handoffs: Dict[int, Tuple[str, int, List[int]]] = {}
        # router-side tracer: dispatch/handoff/request spans + flow
        # events on pid 0 (replica tracers use their own pids), one tid
        # per request.  _trace_clock_t0 anchors the fleet's injected
        # clock onto the tracer's microsecond epoch.
        self.tracer = SpanTracer(enabled=bool(self.config.trace_enabled),
                                 pid=0,
                                 max_events=int(self.config.max_trace_events))
        self.trace_emitter = TraceEmitter(process_name="deepspeed_tpu_router")
        self._trace_clock_t0 = self.clock()
        # per-request start of the current router-hold interval (arrival,
        # or the end of the previous dispatch/handoff) — the "dispatch"
        # slice each attempt records spans it
        self._trace_hold: Dict[int, float] = {}
        # continuous SLO signals: ring-buffer sampling of the shared
        # registry + multi-window burn rate over the TTFT/TPOT histograms
        # (serving/slo.py).  Sampled from the dispatcher tick — the
        # sampler never blocks the scheduler round.
        self.slo_monitor: Optional[SLOMonitor] = None
        if self.config.slo.enabled:
            self.slo_monitor = SLOMonitor(self.config.slo,
                                          registry=self.registry,
                                          clock=self.clock)
        self._autoscaler: Optional[PoolAutoscaler] = None
        if self.config.disaggregated:
            self._autoscaler = PoolAutoscaler(
                self.config.autoscale, registry=self.registry,
                clock=self.clock)
        # fleet-wide LoRA adapter registry: {id -> host weights or None},
        # replayed onto every fresh incarnation in _spawn so a respawned
        # replica can serve a migrated adapter request token-exact
        self._adapter_registry: Dict[int, Any] = {}
        # every worker thread started and not yet seen finished, zombies
        # of retired incarnations included: shutdown joins them all
        self._workers: List[threading.Thread] = []
        self.replicas: Dict[str, Replica] = {}
        for i in range(int(self.config.num_replicas)):
            rep = Replica(f"r{i}", self)
            if self.config.disaggregated:
                rep.role = ("prefill"
                            if i < int(self.config.prefill_replicas)
                            else "decode")
            self.replicas[rep.name] = rep
            self._spawn(rep, is_respawn=False)
        self._handler = preemption_handler
        if self._handler is not None:
            # latch + poke: the signal frame only sets the flag and drops a
            # marker into the event queue so a sleeping tick wakes promptly
            if hasattr(self._handler, "set_notice_callback"):
                self._handler.set_notice_callback(
                    lambda reason: self._events.put(("wakeup",)))
            self._handler.install()

    # ------------------------------------------------------------ spawning
    def _default_factory(self, name: str):
        from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
        ecfg = copy.deepcopy(self._engine_config)
        ecfg.setdefault("telemetry", {})["replica"] = name
        if self.config.disaggregated:
            # the handoff pins radix-matched blocks on the source pool, and
            # decode-side prefix_affinity routes on radix residency: both
            # need the prefix cache on every replica
            sm = ecfg.setdefault("state_manager", {})
            if isinstance(sm, dict):
                sm.setdefault("prefix_cache", True)
        return InferenceEngineV2(self._model, ecfg, params=self._params,
                                 telemetry_registry=self.registry)

    def _set_state(self, rep: Replica, state: str) -> None:
        assert state in REPLICA_STATES, state
        rep.state = state
        for s in REPLICA_STATES:
            self.g_state.set(1.0 if s == state else 0.0,
                             replica=rep.name, state=s)

    def _spawn(self, rep: Replica, *, is_respawn: bool) -> bool:
        self._set_state(rep, "spawning")
        try:
            if is_respawn:
                # chaos site: an exc here models the factory itself failing
                # (OOM building the engine, a torn shared cache, ...)
                faults.fire("fleet.respawn_factory", replica=rep.name)
            engine = self._engine_factory(rep.name)
        except Exception as e:  # noqa: BLE001 — a respawn-factory failure
            if not is_respawn:
                raise          # construction-time errors surface to the user
            # books THIS replica dead and keeps the dispatcher alive: one
            # replica that cannot be rebuilt must degrade the fleet to
            # N-1, never unwind the whole control plane
            logger.error(f"fleet: respawn factory for {rep.name} failed "
                         f"({e!r}); booking the replica dead")
            with rep.cond:
                rep.incarnation += 1     # no worker runs this incarnation
                rep.busy = False
                rep.queue.clear()
            rep.engine = None
            self._set_state(rep, "dead")
            self.c_deaths.inc(1, reason="respawn_failed")
            return False
        if hasattr(engine, "clear_drain"):
            engine.clear_drain()
        if self._adapter_registry and hasattr(engine, "register_adapter"):
            # replay the fleet's adapter set onto the fresh pool (host
            # dicts only — pages hot-load on first use); identical
            # weights per id on every replica keeps migration token-exact
            for aid, w in self._adapter_registry.items():
                engine.register_adapter(aid, w)
        rep.engine = engine
        with rep.cond:
            rep.incarnation += 1
            inc = rep.incarnation
            rep.busy = False
            # a respawn into a role that has already served in this
            # process builds nothing on its first call (its kernels are
            # loaded): it runs under the steady-state deadline immediately
            # — the warm-up budget would let a wedged respawn (and its
            # queued requests) sit undetected for warmup_deadline_s with
            # no build to excuse.
            rep.warmed = bool(is_respawn and self.config.share_compile_cache
                              and rep.role in self._served_roles)
            rep.queue.clear()

        def _beat(rep=rep, inc=inc):
            # incarnation-guarded: a ZOMBIE worker (heartbeat-declared dead,
            # still inside its old engine.generate) must neither refresh the
            # replacement's liveness clock — that would mask a real hang —
            # nor consume chaos faults armed for the live incarnation
            if rep.incarnation == inc:
                rep.beat()
        engine.heartbeat_fn = _beat
        rep.last_beat = self.clock()
        rep.worker = threading.Thread(
            target=self._worker, args=(rep, engine, inc), daemon=True,
            name=f"fleet-{rep.name}-i{inc}")
        rep.worker.start()
        self._workers = [t for t in self._workers if t.is_alive()]
        self._workers.append(rep.worker)
        self._set_state(rep, "healthy")
        if is_respawn:
            self.c_respawns.inc(1)
        return True

    # ------------------------------------------------------------- tracing
    def _trace_us(self, t: float) -> float:
        """Map a fleet-clock timestamp onto the router tracer's epoch."""
        return (t - self._trace_clock_t0) * 1e6

    def _trace_dispatch(self, req: FleetRequest, replica_name: str,
                        now: float) -> None:
        """Record one dispatch attempt on the request's router track: a
        slice covering the hold since arrival / the previous hop, plus
        the flow event (``s`` on the first attempt, ``t`` after) that
        chains it to the replica-side spans."""
        if not self.tracer.enabled or req.trace is None:
            return
        tid = req.index + 1
        start = self._trace_hold.get(req.index, req.t_arrival)
        self._trace_hold[req.index] = now
        ts = self._trace_us(start)
        dur = max((now - start) * 1e6, 1.0)
        self.tracer.record(f"dispatch {req.phase}", ts, dur, tid=tid,
                           cat="router", replica=replica_name,
                           **req.trace.args())
        if req.trace.flow_id is not None:
            self.tracer.flow("s" if req.attempts == 1 else "t",
                             req.trace.flow_id, ts + dur / 2, tid=tid)

    def _trace_request(self, req: FleetRequest, now: float,
                       n_tokens: int) -> None:
        """Record the request envelope [arrival, done] — the outer span
        critical_path.py decomposes — and terminate the flow (``f``)."""
        if not self.tracer.enabled or req.trace is None:
            return
        tid = req.index + 1
        self.tracer.set_thread_name(tid, f"req {req.index}")
        ts = self._trace_us(req.t_arrival)
        dur = max((now - req.t_arrival) * 1e6, 1.0)
        self.tracer.record(
            "request", ts, dur, tid=tid, cat="router",
            mode="disagg" if self.config.disaggregated else "unified",
            index=req.index, attempts=req.attempts,
            migrations=req.migrations, generated_tokens=int(n_tokens),
            **req.trace.args())
        if req.trace.flow_id is not None:
            self.tracer.flow("f", req.trace.flow_id, ts + dur / 2, tid=tid)
        self._trace_hold.pop(req.index, None)

    def export_trace(self, path: str) -> Optional[str]:
        """Write the router-side trace (dispatch/handoff/request spans +
        flow events) — merge with the per-replica traces via
        scripts/merge_traces.py for the stitched fleet view."""
        if not self.tracer.enabled or not self.tracer.events:
            return None
        return self.trace_emitter.write(path, self.tracer)

    # ------------------------------------------------------ replica worker
    def _worker(self, rep: Replica, engine, incarnation: int) -> None:
        from deepspeed_tpu_torch.inference.v2.engine_v2 import EngineDrained
        # probed once per incarnation: fake/minimal engines in tests need
        # not accept the trace_ctx / adapter_ids keywords
        try:
            gen_params = inspect.signature(engine.generate).parameters
            accepts_trace = "trace_ctx" in gen_params
            accepts_adapters = "adapter_ids" in gen_params
        except (TypeError, ValueError):
            accepts_trace = False
            accepts_adapters = False
        while True:
            with rep.cond:
                while not rep.queue:
                    if rep.incarnation != incarnation:
                        return
                    rep.cond.wait(timeout=0.05)
                    # idle liveness (no chaos site: only the engine loop's
                    # beat models a SERVING replica's heartbeat)
                    rep.last_beat = self.clock()
                if rep.incarnation != incarnation:
                    return
                batch, rep.queue = rep.queue, []
                rep.busy = True
                # deadline clock starts at pick-up, not at the last idle
                # beat (the queue wait must not count against serving)
                rep.last_beat = self.clock()
            try:
                gen_kwargs = {}
                if accepts_trace:
                    gen_kwargs["trace_ctx"] = [d.trace for d in batch]
                # base-model-only batches skip the keyword entirely so an
                # adapter-less fleet's generate calls stay byte-identical
                if accepts_adapters and any(d.adapter for d in batch):
                    gen_kwargs["adapter_ids"] = [d.adapter for d in batch]
                outs = engine.generate(
                    [d.prompt for d in batch],
                    max_new_tokens=[d.remaining for d in batch],
                    **gen_kwargs)
                items = [(d.index, d.epoch, self._stitch(d.prefix, out))
                         for d, out in zip(batch, outs)]
                self._events.put(("complete", rep.name, incarnation,
                                  batch[0].gen, items))
                with rep.cond:
                    if rep.incarnation == incarnation:
                        rep.busy = False
                        rep.warmed = True    # first generate done: the
                        #                      kernels are loaded
                        self._served_roles.add(rep.role)
            except EngineDrained:
                self._events.put(("drained", rep.name, incarnation,
                                  batch[0].gen,
                                  *self._merge_export(engine, batch), ""))
                self._worker_exit(rep, incarnation)
                return
            except BaseException as e:  # noqa: BLE001 — a replica death is
                #                         whatever escaped the engine
                self._events.put(("death", rep.name, incarnation,
                                  batch[0].gen,
                                  *self._merge_export(engine, batch),
                                  repr(e)))
                self._worker_exit(rep, incarnation)
                return

    def _worker_exit(self, rep: Replica, incarnation: int) -> None:
        with rep.cond:
            if rep.incarnation == incarnation:
                rep.busy = False

    @staticmethod
    def _stitch(prefix: Tuple[int, ...], out: np.ndarray) -> np.ndarray:
        if not prefix:
            return np.asarray(out, np.int32)
        return np.concatenate([np.asarray(prefix, np.int32),
                               np.asarray(out, np.int32)])

    @staticmethod
    def _merge_export(engine, batch: List[_Dispatch]):
        """Map the engine's per-call export (local prompt indices) back to
        fleet indices/epochs.  Safe on a dead engine (host-state only);
        a failed export degrades to record-less migration."""
        try:
            completed, pending = engine.export_pending_requests()
        except Exception:  # noqa: BLE001 — dead replica, best effort
            completed, pending = {}, []
        items = [(batch[i].index, batch[i].epoch,
                  ServingFleet._stitch(batch[i].prefix, toks))
                 for i, toks in completed.items() if i < len(batch)]
        migrations = []
        exported = set()
        for rec in pending:
            if rec["index"] >= len(batch):
                continue                 # defensive: not this batch's export
            d = batch[rec["index"]]
            exported.add(rec["index"])
            migrations.append((d.index, d.epoch,
                               {"prompt": rec["prompt"],
                                "generated": list(rec["generated"])}))
        # engine errors before generate() set a serve context (e.g. a
        # death at the very first scheduler round of a previous context)
        # leave batch members unexported: migrate them record-less
        for i, d in enumerate(batch):
            if i not in exported and all(it[0] != d.index for it in items):
                migrations.append((d.index, d.epoch, None))
        return items, migrations

    # ------------------------------------------------------------- serving
    def serve(self, prompts, max_new_tokens=32, arrival_times=None,
              adapter_ids=None, raise_on_failure: bool = True,
              max_wall_s: Optional[float] = None) -> List[np.ndarray]:
        """Serve ``prompts`` to completion across the fleet and return one
        output array per prompt (order preserved).  ``arrival_times`` are
        open-loop offsets in seconds from call start (requests dispatch
        only once arrived).  ``adapter_ids`` optionally pins each request
        to a LoRA adapter registered on the replicas (0/None = base
        model); the id sticks to the request through retries, migrations,
        and the prefill->decode handoff, and an adapter the target replica
        can never fit fails the REQUEST typed (``invalid_request``), not
        the replica.  Failed requests (retry budget exhausted, admission
        bound, no replicas left) surface as a typed
        :class:`RequestFailed` — raised after everything else settled, or
        returned as ``None`` entries with ``raise_on_failure=False``
        (details in ``self.last_failures``).  ``max_wall_s`` is a hard
        safety deadline for tests ("not a hang")."""
        if isinstance(max_new_tokens, (int, np.integer)):
            max_list = [int(max_new_tokens)] * len(prompts)
        else:
            max_list = [int(m) for m in max_new_tokens]
            if len(max_list) != len(prompts):
                raise ValueError("max_new_tokens list must match prompts")
        if arrival_times is not None and len(arrival_times) != len(prompts):
            raise ValueError("arrival_times must match prompts")
        if adapter_ids is not None and len(adapter_ids) != len(prompts):
            raise ValueError("adapter_ids list must match prompts")
        self._serve_gen += 1
        self.request_log = []
        self.last_failures = {}   # never leak a previous serve's failures
        #                           into a call that exits via an exception
        # purge replica queues of any previous serve's undispatched work
        # (e.g. a timed-out attempt whose replica never woke): a batch is
        # taken atomically, so after this every batch is gen-homogeneous
        # and the event-level gen filter in _handle_event is exact
        for rep in self.replicas.values():
            with rep.cond:
                rep.queue.clear()
        # release any handoff pins a previous serve left behind (e.g. an
        # exception path between handoff and final completion)
        for index in list(self._handoffs):
            self._release_handoff(index)
        self.router = Router(self.config.router, clock=self.clock,
                             registry=self.registry)
        self._trace_hold.clear()
        t0 = self.clock()
        phase = "prefill" if self.config.disaggregated else "full"
        for i, (p, m) in enumerate(zip(prompts, max_list)):
            self.router.submit(FleetRequest(
                index=i, prompt=np.asarray(p, np.int32).reshape(-1),
                max_new_tokens=m, phase=phase,
                adapter=(int(adapter_ids[i])
                         if adapter_ids is not None else 0),
                t_arrival=t0 + (float(arrival_times[i])
                                if arrival_times is not None else 0.0)))
        while not self.router.settled():
            if max_wall_s is not None and self.clock() - t0 > max_wall_s:
                raise RuntimeError(
                    f"fleet serve exceeded max_wall_s={max_wall_s}: "
                    f"{len(self.router.pending)} pending, "
                    f"{len(self.router.inflight)} inflight, states "
                    f"{[(r.name, r.state) for r in self.replicas.values()]}")
            self._tick()
            if self._fleet_draining and not self.router.inflight \
                    and not any(r.busy for r in self.replicas.values()):
                raise FleetDrained(dict(self.router.done),
                                   list(self.router.pending))
        self.last_failures = dict(self.router.failed)
        if self.last_failures and raise_on_failure:
            raise self.last_failures[min(self.last_failures)]
        return [self.router.done.get(i) for i in range(len(prompts))]

    # ------------------------------------------------------ dispatcher tick
    def _tick(self) -> None:
        # 1) block briefly on worker events (this wait paces the loop)
        try:
            self._handle_event(
                self._events.get(timeout=self.config.poll_interval_s))
            while True:
                self._handle_event(self._events.get_nowait())
        except queue.Empty:
            pass
        now = self.clock()
        # 2) preemption notice -> fleet-wide drain (flag polled, never a
        # signal-frame action: same contract as the training-side handler)
        if (self._handler is not None and not self._fleet_draining
                and self._handler.requested):
            self.drain_all()
        # 3) supervision: heartbeat deadlines, per-attempt timeouts,
        # draining replicas that went idle
        self._check_health(now)
        self.router.check_timeouts(now)
        for rep in list(self.replicas.values()):
            if rep.state == "draining":
                with rep.cond:
                    busy = rep.busy
                if busy:
                    rep.engine.request_drain()
                else:
                    self._retire_replica(rep, "drain")
        # 4) continuous SLO signals + admission control tick + dispatch
        slo_burn = None
        if self.slo_monitor is not None:
            # cadence-gated ring-buffer sample + burn re-evaluation:
            # bounded host reads, never blocks the round
            slo_burn = self.slo_monitor.tick(now)
        depth = self.router.queue_depth(now)
        self.admission.update(depth, slo_burn=slo_burn)
        # handoff pins of requests that FAILED (retry budget, admission
        # cap, ...) never reach _complete's release — sweep them here
        if self._handoffs:
            for index in [i for i in self._handoffs
                          if i in self.router.failed]:
                self._release_handoff(index)
        if self._fleet_draining:
            return
        if self._autoscaler is not None:
            self._rebalance_pools(now)
        for req in self.router.take_dispatchable(now):
            try:
                admitted, retry_after = self.admission.decide(req)
            except Exception as e:  # noqa: BLE001 — admission fails OPEN:
                # shedding is an optimization, never a correctness gate
                if not self._admission_failed_open:
                    self._admission_failed_open = True
                    logger.warning(f"admission controller failed open: {e!r}")
                admitted, retry_after = True, 0.0
            if not admitted:
                cap = self.config.admission.max_rejections
                if cap and req.rejections >= cap:
                    self.router.failed[req.index] = RequestFailed(
                        req.index, "admission", req.attempts,
                        f"shed {req.rejections} times")
                else:
                    self.router.requeue_wait(req, now + retry_after)
                continue
            healthy = [r for r in self.replicas.values()
                       if r.state == "healthy"]
            try:
                rep = self.router.pick(req, healthy)
            except NoHealthyReplicas:
                if all(r.state == "dead" for r in self.replicas.values()):
                    self.router.failed[req.index] = RequestFailed(
                        req.index, "no_healthy_replicas", req.attempts)
                else:
                    self.router.requeue_wait(
                        req, now + self.config.poll_interval_s)
                continue
            bad = self._invalid_reason(req, rep)
            if bad is not None:
                # a client input error fails the REQUEST, never the
                # replica: without this gate the engine's validation
                # ValueError would book a replica death and a few poison
                # requests could burn the whole fleet's respawn budget
                self.router.failed[req.index] = RequestFailed(
                    req.index, "invalid_request", req.attempts, bad)
                continue
            try:
                self.router.dispatch(req, rep, now)
                self._trace_dispatch(req, rep.name, now)
            except Exception as e:  # noqa: BLE001 — injected or real
                self.router.fail_attempt(req, now, "dispatch_error",
                                         repr(e))

    def _handle_event(self, ev) -> None:
        kind = ev[0]
        if kind == "wakeup":
            return                       # just a queue poke; tick handles it
        name, incarnation, gen = ev[1], ev[2], ev[3]
        rep = self.replicas.get(name)
        stale_serve = gen != self._serve_gen   # zombie of an earlier serve:
        # its request-level payload addresses a retired Router, but its
        # STATE transition is still real — a dead worker must not leave a
        # "healthy" replica silently black-holing new dispatches
        now = self.clock()
        if kind == "complete":
            if not stale_serve:
                for index, epoch, tokens in ev[4]:
                    self._complete(index, epoch, tokens, now)
            return
        # drained / death
        completions, migrations = ev[4], ev[5]
        reason = "drain" if kind == "drained" else "replica_death"
        if not stale_serve:
            for index, epoch, tokens in completions:
                self._complete(index, epoch, tokens, now)
            for index, epoch, record in migrations:
                self._apply_migration(index, epoch, record, reason, now)
        if rep is not None and rep.incarnation == incarnation:
            if kind == "death":
                logger.warning(
                    f"fleet: replica {name} died mid-serve ({ev[6]}); "
                    f"{len(migrations)} request(s) migrated")
            self._retire_replica(rep, reason)

    def _complete(self, index: int, epoch: int, tokens, now: float) -> None:
        req = self.router.inflight.get(index)
        if (req is not None and req.phase == "prefill"
                and req.epoch == epoch
                and len(tokens) < req.max_new_tokens):
            # prefill phase done (prompt + first token) with budget left:
            # hand the KV off and requeue the decode tail instead of
            # completing.  A one-token budget skips this and completes
            # directly — prefill already produced everything.
            self._advance_phase(req, epoch, tokens, now)
            return
        if not self.router.complete(index, epoch, tokens):
            return
        self._release_handoff(index)
        req = self.router.requests[index]
        self.request_log.append({
            "index": index, "t_arrival": req.t_arrival, "t_done": now,
            "generated_tokens": int(len(tokens)), "attempts": req.attempts,
            "migrations": req.migrations, "rejections": req.rejections,
            "t_first": req.t_first})
        self._trace_request(req, now, len(tokens))

    # ----------------------------------------------------------- KV handoff
    def _advance_phase(self, req: FleetRequest, epoch: int, tokens,
                       now: float) -> None:
        """Prefill -> decode handoff.  The transfer primitive is the
        radix block-alias path: the source replica's finished prompt
        blocks are PINNED (refcounted ``acquire``) so eviction cannot
        reclaim them while the decode attempt is in flight, and the decode
        replica's prefix probe then aliases them for free on a shared
        single-host pool.  The multi-host path is a stub: the bytes a
        wire copy would move are accounted in ``kv_handoff_bytes_total``.
        ``handoff.mid_transfer`` fires between pin and commit — an
        injected fault there models the source dying mid-transfer: pins
        are released (no refcount leak) and the request re-enters through
        the existing token-exact migration fold."""
        index = req.index
        src = self.replicas.get(req.assigned) if req.assigned else None
        new = [int(t) for t in np.asarray(tokens).reshape(-1)
               [len(req.generated):]]
        folded = np.concatenate(
            [np.asarray(req.prompt, np.int32),
             np.asarray(new, np.int32)]) if new else req.prompt
        blocks: List[int] = []
        pinned = False
        eng = getattr(src, "engine", None) if src is not None else None
        src_inc = src.incarnation if src is not None else -1
        probe = getattr(eng, "prefix_block_handles", None)
        if probe is not None:
            try:
                blocks, _matched = probe(folded)
                if blocks:
                    # pin vs eviction; acquire validates every block
                    # before bumping any, so a lost race with the radix
                    # evictor (dead block) leaves nothing to unwind and
                    # the handoff degrades to accounting-free
                    eng.state.allocator.acquire(blocks)
                    pinned = True
            except Exception:  # noqa: BLE001 — degraded, never corrupt
                blocks, pinned = [], False
        try:
            faults.fire("handoff.mid_transfer", index=index,
                        replica=src.name if src is not None else None)
        except faults.InjectedFault as e:
            if pinned:
                self._release_blocks(eng, blocks)
            self.c_handoffs.inc(1, outcome="aborted")
            logger.warning(
                f"fleet: handoff of request {index} aborted mid-transfer "
                f"({e!r}); re-entering via migration fold")
            # the prefill result is host-known, so the fold keeps it —
            # the request re-enters token-exact as a decode-phase retry
            # (drain-style: an injected infrastructure fault must not
            # burn the client's retry budget)
            req.phase = "decode"
            if req.t_first is None:
                req.t_first = now
            self.router.migrate(
                req, now, reason="handoff_abort",
                record={"prompt": folded, "generated": new},
                burn_budget=False)
            return
        if pinned:
            self._handoffs[index] = (src.name, src_inc, blocks)
            bytes_fn = getattr(eng, "kv_block_bytes", None)
            if bytes_fn is not None:
                self.c_handoff_bytes.inc(len(blocks) * int(bytes_fn()))
        self.c_handoffs.inc(1, outcome="ok")
        if req.t_first is None:
            req.t_first = now
        t_end = self.clock()
        if self.tracer.enabled and req.trace is not None:
            # the handoff slice is critical_path.py's b2->b3 boundary
            # pair: [prefill result observed, decode requeue committed]
            tid = index + 1
            ts = self._trace_us(now)
            dur = max((t_end - now) * 1e6, 1.0)
            self.tracer.record("fleet.handoff", ts, dur, tid=tid,
                               cat="router",
                               src=src.name if src is not None else None,
                               pinned_blocks=len(blocks),
                               **req.trace.args())
            if req.trace.flow_id is not None:
                self.tracer.flow("t", req.trace.flow_id, ts + dur / 2,
                                 tid=tid)
            self._trace_hold[index] = t_end
        self.router.handoff(index, epoch, tokens, now)

    @staticmethod
    def _release_blocks(eng, blocks: List[int]) -> None:
        try:
            eng.state.allocator.release(blocks)
        except Exception as e:  # noqa: BLE001 — bookkeeping must never
            #                     take the dispatcher down
            logger.warning(f"fleet: handoff pin release failed: {e!r}")

    def _release_handoff(self, index: int) -> None:
        """Release a request's pinned handoff blocks on its SOURCE pool.
        Skipped when the source incarnation is gone — its allocator (and
        the pins with it) died with the engine."""
        rec = self._handoffs.pop(index, None)
        if rec is None:
            return
        name, inc, blocks = rec
        rep = self.replicas.get(name)
        if rep is None or rep.incarnation != inc or rep.engine is None:
            return
        self._release_blocks(rep.engine, blocks)

    def _drop_handoffs_for(self, rep: Replica) -> None:
        """Forget pins sourced on a replica whose engine is being torn
        down (retire / role flip): the allocator dies with it, so there
        is nothing to release — keeping the record would release against
        the REPLACEMENT engine's allocator."""
        for index in [i for i, (name, _inc, _b) in self._handoffs.items()
                      if name == rep.name]:
            del self._handoffs[index]

    # ----------------------------------------------------- pool autoscaling
    def _rebalance_pools(self, now: float) -> None:
        """One autoscaler evaluation: ask for a direction, then flip ONE
        idle replica (healthy, nothing queued, nothing assigned) — moving
        a busy replica would migrate its work for a latency optimization,
        which is backwards.  No idle donor means no move this tick; the
        signal persists and a later tick retries."""
        pools = {"prefill": 0, "decode": 0}
        for r in self.replicas.values():
            if r.state == "healthy" and r.role in pools:
                pools[r.role] += 1
        direction = self._autoscaler.evaluate(
            now, pools, shedding=self.admission.shedding,
            shed_rate=self.admission.shed_rate(),
            slo_burn=(self.slo_monitor.max_burn()
                      if self.slo_monitor is not None else None))
        if direction is None:
            return
        donor_role = "decode" if direction == "to_prefill" else "prefill"
        new_role = "prefill" if direction == "to_prefill" else "decode"
        for rep in sorted(self.replicas.values(), key=lambda r: r.name):
            if rep.state != "healthy" or rep.role != donor_role:
                continue
            with rep.cond:
                idle = not rep.busy and not rep.queue
            if not idle or self.router.assigned_to(rep.name):
                continue
            self._flip_role(rep, new_role)
            self._autoscaler.record_move(direction, now)
            return

    def _flip_role(self, rep: Replica, role: str) -> None:
        """Warm role flip: stale-ify the worker (incarnation fence — same
        mechanism as a retire, but no death is booked and no respawn
        budget burns), swap the role, and respawn: warm when the new role
        has already served in this process, so its kernels are loaded."""
        with rep.cond:
            rep.incarnation += 1
            leftovers, rep.queue = rep.queue, []
            rep.busy = False
            rep.cond.notify_all()
        now = self.clock()
        for d in leftovers:   # donor was idle-checked; belt and braces
            self._apply_migration(d.index, d.epoch, None, "drain", now)
        self._drop_handoffs_for(rep)
        self.router.invalidate_residency(rep.name)
        old = rep.role
        rep.role = role
        logger.info(f"fleet: role flip {rep.name}: {old} -> {role} "
                    f"(warm respawn)")
        self._spawn(rep, is_respawn=True)

    def _apply_migration(self, index: int, epoch: int,
                         record: Optional[dict], reason: str,
                         now: float) -> None:
        req = self.router.inflight.get(index)
        if req is None or req.epoch != epoch:
            return                       # stale: already requeued/finished
        self.router.migrate(req, now, reason=reason, record=record,
                            burn_budget=(reason != "drain"))

    @staticmethod
    def _invalid_reason(req: FleetRequest, rep: Replica) -> Optional[str]:
        """Best-effort mirror of the engine's PER-REQUEST validation (the
        two classes ``generate`` rejects with ValueError before doing any
        work): context overflow and a single request that cannot fit the
        KV pool even empty.  Only runs when the engine exposes the limits
        (fakes without them skip the gate); migration-folded prompts keep
        ``len(prompt) + remaining`` invariant, so a request this gate
        admitted once is never rejected after a migration."""
        eng = rep.engine
        mc = getattr(eng, "model_config", None)
        if mc is not None and len(req.prompt) + req.remaining \
                > mc.max_seq_len:
            return (f"prompt {len(req.prompt)} + {req.remaining} new "
                    f"tokens exceeds max_seq_len {mc.max_seq_len}")
        state = getattr(eng, "state", None)
        need = None
        if state is not None:
            need = -(-(len(req.prompt) + req.remaining)
                     // state.block_size)
            if need > state.allocator.num_blocks:
                return (f"request needs {need} KV blocks but the pool "
                        f"holds {state.allocator.num_blocks}")
        # adapter gate (only when the engine exposes the pool attribute —
        # real engines always do, even disabled; fakes without it also
        # never receive adapter_ids, so there is nothing to mirror): an
        # unknown / never-fits adapter, a base-only replica, or a request
        # whose KV blocks + adapter pages exceed the pool even empty
        # would all ValueError inside generate — on the worker thread
        # that books a replica DEATH, so the gate fails the request here
        if req.adapter and hasattr(eng, "adapters"):
            pool = eng.adapters
            if pool is None:
                return (f"request pins adapter {req.adapter} but the "
                        f"replica serves the base model only "
                        f"(config.adapters disabled)")
            bad = pool.unfittable_reason(req.adapter)
            if bad is not None:
                return bad
            if need is not None and need + pool.blocks_per_adapter \
                    > state.allocator.num_blocks:
                return (f"request needs {need} KV blocks + "
                        f"{pool.blocks_per_adapter} adapter page(s) but "
                        f"the pool holds {state.allocator.num_blocks}")
        return None

    # ---------------------------------------------------------- supervision
    def _check_health(self, now: float) -> None:
        base = self.config.heartbeat_deadline_s
        if base <= 0:
            return
        # a not-yet-warm incarnation's first call contains the on-the-fly
        # kernel build: deadline it on the warm-up budget, never the
        # steady-state one (a cold replica must not be booked dead)
        warmup = max(base, self.config.warmup_deadline_s)
        for rep in list(self.replicas.values()):
            ddl = base if rep.warmed else warmup
            if rep.state in ("healthy", "draining") and rep.busy \
                    and now - rep.last_beat > ddl:
                logger.warning(
                    f"fleet: replica {rep.name} missed its "
                    f"{'steady-state' if rep.warmed else 'warm-up'} "
                    f"heartbeat deadline ({now - rep.last_beat:.2f}s > "
                    f"{ddl}s); declaring dead and migrating its requests")
                self._retire_replica(rep, "heartbeat_timeout")

    def _retire_replica(self, rep: Replica, reason: str) -> None:
        """Book a replica death/drain: stale-ify its worker, migrate every
        request still attributed to it (undispatched queue + router
        inflight), then respawn if policy allows.  Requeue happens BEFORE
        the respawn so migrated work re-dispatches to survivors first."""
        t_detect = self.clock()
        with rep.cond:
            rep.incarnation += 1         # zombie worker exits / goes stale
            leftovers, rep.queue = rep.queue, []
            rep.busy = False
            rep.cond.notify_all()
        # a worker still inside generate (a heartbeat-declared death) is a
        # zombie: stop it at its next round, so that its thread ends and
        # drops the engine and its KV pool rather than serving on beside
        # the replacement (a respawn clears the latch on the engine it gets)
        if rep.engine is not None and hasattr(rep.engine, "request_drain"):
            rep.engine.request_drain()
        self._set_state(rep, "dead")
        self.c_deaths.inc(1, reason=reason)
        self._drop_handoffs_for(rep)
        self.router.invalidate_residency(rep.name)
        now = self.clock()
        for d in leftovers:
            self._apply_migration(d.index, d.epoch, None, reason, now)
        for req in self.router.assigned_to(rep.name):
            self.router.migrate(req, now, reason=reason, record=None,
                                burn_budget=(reason != "drain"))
        if reason == "drain":
            allowed = self.config.respawn_after_drain \
                and not self._fleet_draining
        else:
            # never respawn into a fleet-wide drain either: building an
            # engine inside the preemption window stretches time-to-exit
            # for a replica that could never receive work anyway
            allowed = self.config.respawn \
                and rep.respawns < self.config.max_respawns \
                and not self._fleet_draining
            rep.respawns += 1 if allowed else 0
        if allowed and self._spawn(rep, is_respawn=True):
            self.h_recovery.observe((self.clock() - t_detect) * 1e3)

    # ------------------------------------------------------------- control
    def register_adapter(self, adapter_id: int, weights=None) -> None:
        """Register a LoRA adapter fleet-wide: on every live engine now
        and (via the registry replay in ``_spawn``) on every future
        incarnation.  ``weights=None`` derives deterministic per-id
        weights, identical on every replica — the fleet's token-exactness
        invariant extends to adapter requests, so a migrated or
        handed-off adapter request completes byte-identical wherever it
        lands."""
        self._adapter_registry[int(adapter_id)] = weights
        for rep in self.replicas.values():
            if rep.engine is not None and hasattr(rep.engine,
                                                  "register_adapter"):
                rep.engine.register_adapter(adapter_id, weights)

    def drain_replica(self, name: str) -> None:
        """Graceful drain of one replica: stop admission to it, let it
        finish or migrate in-flight requests (``EngineDrained`` export),
        then retire + respawn it (warm once its role has served)."""
        rep = self.replicas[name]
        if rep.state != "healthy":
            return
        self._set_state(rep, "draining")
        with rep.cond:
            busy = rep.busy
        if busy:
            rep.engine.request_drain()
        # idle replicas are finalized by the next tick

    def drain_all(self) -> None:
        """Fleet-wide drain (preemption notice): stop dispatching, drain
        every replica; ``serve()`` surfaces :class:`FleetDrained` with the
        completed + exported request sets."""
        self._fleet_draining = True
        for rep in self.replicas.values():
            if rep.state == "healthy":
                self.drain_replica(rep.name)

    def health(self) -> Dict[str, dict]:
        """Supervisor view: per-replica state, beat age, and the KV-pool
        gauges (per-replica label) the telemetry layer maintains."""
        now = self.clock()
        reg = self.registry._metrics
        out = {}
        for rep in self.replicas.values():
            kv = reg.get("kv_pool_blocks")
            free = kv.value(replica=rep.name, state="free") if kv else 0.0
            used = kv.value(replica=rep.name, state="used") if kv else 0.0
            out[rep.name] = {
                "state": rep.state, "role": rep.role,
                "beat_age_s": now - rep.last_beat,
                "busy": rep.busy, "respawns": rep.respawns,
                "kv_free_blocks": free, "kv_used_blocks": used,
                "outstanding_tokens":
                    self.router.outstanding_tokens(rep.name)}
        return out

    def shutdown(self) -> None:
        """Stop every worker thread (idempotent).  Busy workers are asked
        to drain cooperatively and JOINED, zombies of retired incarnations
        too: tearing the interpreter down with a thread mid-launch aborts
        the process."""
        for rep in self.replicas.values():
            with rep.cond:
                rep.incarnation += 1
                rep.cond.notify_all()
            if rep.engine is not None and hasattr(rep.engine,
                                                  "request_drain"):
                rep.engine.request_drain()
        for t in self._workers:
            t.join(timeout=60.0)

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False
