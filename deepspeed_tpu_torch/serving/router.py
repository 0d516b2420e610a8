"""Failure-tolerant request routing for the multi-replica serving fleet.

The PyTorch port's copy of deepspeed_tpu/serving/router.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

The router owns the request-level half of the fleet contract
(serving/fleet.py owns the replica-lifecycle half): every request moves
through

    pending --(policy pick + ``router.dispatch`` fault site)--> inflight
      --> done | failed

with three ways back from ``inflight`` to ``pending``:

- **retry** — a dispatch error or a per-attempt timeout re-enters the
  queue after an exponential-backoff-with-jitter delay; each retry burns
  one unit of the bounded budget (``max_retries`` re-dispatches after the
  first attempt) and exhaustion surfaces a typed :class:`RequestFailed`,
  never a hang;
- **migration on death** — a replica dying mid-decode re-enters its queued
  and in-flight requests immediately (no backoff: the survivors are
  healthy) with their ORIGINAL arrival timestamps and any host-known
  generated prefix folded into the prompt (engine
  ``export_pending_requests``), so open-loop greedy output stays
  token-exact vs. a no-failure run; death migrations still count against
  the retry budget so a crash-looping fleet fails requests instead of
  cycling them forever;
- **migration on drain** — a graceful drain migrates the same way but
  burns NO budget (the operator asked for it; punishing the request would
  make drains lossy).

Determinism for tests: the clock is injected (``clock=...``), and the
backoff jitter comes from a seeded ``numpy`` Generator, so the full retry
schedule is pinned by ``RouterConfig.seed``.

Routing policies are pluggable (``POLICIES``): ``least_outstanding_tokens``
(default) balances by the live token footprint per replica;
``round_robin`` is the trivial baseline; ``prefix_affinity`` routes on
ACTUAL radix prefix-cache residency — each healthy replica's engine is
probed for the request's longest cached prefix
(``engine.prefix_cached_tokens``, a read-only host trie walk that is
cross-thread safe) and the request goes to the replica holding the most
of its prompt, least-outstanding-tokens breaking ties.  Replicas without
a probe (cache off, fake engines) report 0, so a cache-less fleet
degrades to exactly least-outstanding routing; under replica death the
migrated request re-probes the survivors and re-prefills only its
uncached suffix there (token-exact either way).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.config import DeepSpeedConfigModel
from deepspeed_tpu_torch.runtime import faults
from deepspeed_tpu_torch.telemetry import tracecontext
from deepspeed_tpu_torch.utils.logging import logger


class RequestFailed(RuntimeError):
    """A request exhausted its bounded retry budget (or the fleet has no
    replica left to serve it).  Typed so callers can distinguish "the
    request failed" from "the fleet is broken" — carries the request
    index, the final failure reason, and the attempt count."""

    def __init__(self, index: int, reason: str, attempts: int,
                 detail: str = ""):
        super().__init__(
            f"request {index} failed after {attempts} attempt(s): {reason}"
            + (f" ({detail})" if detail else ""))
        self.index = index
        self.reason = reason
        self.attempts = attempts


class NoHealthyReplicas(RuntimeError):
    """No replica is in the healthy state to dispatch to (transient while a
    respawn is in flight; terminal when the fleet is out of respawns)."""


@dataclasses.dataclass
class RouterConfig(DeepSpeedConfigModel):
    """``router`` block of the fleet config.

    ``max_retries`` bounds RE-dispatches after the first attempt (so a
    request is tried at most ``max_retries + 1`` times).  The k-th failed
    attempt waits ``min(backoff_max_s, backoff_base_s * backoff_factor**
    (k-1)) * (1 + backoff_jitter * u)`` with ``u ~ U[0, 1)`` from the
    seeded generator.  ``request_timeout_s`` is the per-ATTEMPT completion
    deadline (0 disables): a replica sitting on a request past it gets the
    request retried elsewhere (the stale attempt's late result is
    deduplicated by the assignment epoch)."""

    policy: str = "least_outstanding_tokens"
    max_retries: int = 3
    request_timeout_s: float = 0.0
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    backoff_jitter: float = 0.5
    seed: int = 0
    # disaggregated serving (serving/fleet.py FleetConfig.disaggregated
    # mirrors this down): route each PHASE independently — prefill-phase
    # requests to the prefill-role pool by shortest queue, decode-phase
    # requests to the decode-role pool by prefix_affinity against the
    # handoff residency.  An empty role pool falls back to any healthy
    # replica: specialization is an optimization, never a liveness gate
    disaggregated: bool = False


@dataclasses.dataclass
class FleetRequest:
    """One request's routing state.  ``prompt`` is the CURRENT context —
    migrations fold the host-known generated prefix in, exactly like
    recompute-preemption — while ``generated`` accumulates that prefix so
    the final output is ``generated + last_attempt_output`` and
    ``t_arrival`` never changes (original-arrival semantics)."""

    index: int
    prompt: np.ndarray
    max_new_tokens: int                     # ORIGINAL budget
    t_arrival: float = 0.0
    generated: List[int] = dataclasses.field(default_factory=list)
    attempts: int = 0                       # dispatches tried so far
    rejections: int = 0                     # admission 429s taken
    migrations: int = 0
    epoch: int = 0                          # bumped per requeue: stale-result
    #                                         events are ignored against it
    next_eligible: float = 0.0              # arrival / backoff / retry-after
    deadline: float = float("inf")          # per-attempt timeout
    assigned: Optional[str] = None          # replica name while inflight
    # LoRA adapter serving this request (0 = base model).  Routing treats
    # it as a residency signal (prefix_affinity prefers replicas whose
    # pool already holds the adapter's pages); replicas where the adapter
    # cannot EVER fit fail the request typed at dispatch (fleet
    # ``_invalid_reason``), never a replica death
    adapter: int = 0
    # disaggregated lifecycle: "full" (unified fleet — prefill and decode
    # on one replica), "prefill" (serve the prompt + FIRST token only),
    # "decode" (prefill done and folded; serve the remaining budget).
    # ``handoff`` advances prefill -> decode
    phase: str = "full"
    t_first: Optional[float] = None         # fleet-observed first-token time
    #                                         (set at handoff; None unified)
    # distributed-trace context (telemetry/tracecontext.py): trace_id is
    # STABLE for the request's whole lifetime — retries, migrations, and
    # the prefill->decode handoff keep it — while each dispatch attempt
    # mints a child span under it (Router.dispatch)
    trace: Optional[tracecontext.TraceContext] = None

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)


# ------------------------------------------------------------------ policies

def least_outstanding_tokens(req: FleetRequest, healthy: list,
                             router: "Router", rng) -> object:
    """Default: the replica with the smallest live token footprint
    (outstanding prompts + remaining budgets it has been assigned).  Ties
    break by name so the choice is deterministic."""
    return min(healthy,
               key=lambda rep: (router.outstanding_tokens(rep.name),
                                rep.name))


def round_robin(req: FleetRequest, healthy: list, router: "Router",
                rng) -> object:
    router._rr_cursor += 1
    return healthy[router._rr_cursor % len(healthy)]


def prefix_affinity(req: FleetRequest, healthy: list, router: "Router",
                    rng) -> object:
    """Radix-residency routing:
    probe every healthy replica's engine for the request's longest cached
    prefix and send it where the most of its prompt is already resident —
    those tokens skip prefill there entirely.  Ties (including the
    cache-cold 0-everywhere case) break by least outstanding tokens, then
    name, so an unprimed or cache-less fleet load-balances exactly like
    the default policy.  The probe (``engine.prefix_cached_tokens``) is a
    read-only host trie walk, safe to call from the dispatcher thread
    while the replica worker serves; replicas without one report 0.
    Affinity is an optimization, never a correctness gate: a dead
    favorite simply isn't in ``healthy`` and the survivors re-prefill the
    uncached suffix token-exact.

    Probes go through :meth:`Router.residency` — a per-(replica, prompt)
    cache so scheduling stays O(replicas) dict hits per request instead
    of O(replicas) trie walks: at fleet scale the probe itself was the
    routing cost.  The cache invalidates per replica on dispatch
    (residency there is about to grow) and on death/migration
    (``Router.invalidate_residency``), so a stale entry can only
    UNDER-state residency for one pick, never mis-route.

    Multi-tenant LoRA adds a SECOND residency signal: among replicas with
    equal prefix residency, prefer one whose adapter pool already holds
    the request's adapter pages (``Router.adapter_residency``, probing
    ``engine.adapter_resident`` — the same cached host-dict peek shape as
    the prefix probe).  Landing on an adapter-warm replica skips a
    host->device page upload AND spares a cold eviction there; like the
    prefix signal it is an optimization only — an adapter-cold replica
    just hot-loads the pages on admission."""
    return min(healthy,
               key=lambda rep: (-router.residency(rep, req),
                                -router.adapter_residency(rep, req),
                                router.outstanding_tokens(rep.name),
                                rep.name))


POLICIES: Dict[str, Callable] = {
    "least_outstanding_tokens": least_outstanding_tokens,
    "round_robin": round_robin,
    "prefix_affinity": prefix_affinity,
}


class Router:
    """Request queue + retry/migration bookkeeping.  Single-threaded by
    design: only the fleet dispatcher calls in (replica workers talk to the
    dispatcher through the fleet's event queue), so there is no lock and
    the retry schedule stays deterministic under an injected clock."""

    def __init__(self, config: Optional[RouterConfig] = None, *,
                 clock: Callable[[], float], registry):
        self.config = config or RouterConfig()
        if self.config.policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {self.config.policy!r}; expected "
                f"one of {sorted(POLICIES)}")
        self.clock = clock
        self._policy = POLICIES[self.config.policy]
        self._rng = np.random.default_rng(self.config.seed)
        self._rr_cursor = -1
        self.pending: List[FleetRequest] = []
        self.inflight: Dict[int, FleetRequest] = {}
        self.done: Dict[int, np.ndarray] = {}
        self.failed: Dict[int, RequestFailed] = {}
        self.requests: Dict[int, FleetRequest] = {}
        # per-replica radix-residency probe cache: {replica name ->
        # {prompt bytes -> resident token count}} — see residency()
        self._residency: Dict[str, Dict[bytes, int]] = {}
        self._residency_cap = 4096      # entries per replica before reset
        # per-replica adapter-residency probe cache: {replica name ->
        # {adapter id -> 0/1 resident}} — see adapter_residency(); shares
        # the invalidation sites (and cap) with the prefix cache above
        self._adapter_residency: Dict[str, Dict[int, int]] = {}
        self.c_retries = registry.counter(
            "router_retries_total", "request re-dispatches taken by the "
            "fleet router, per reason (dispatch_error / timeout / "
            "replica_death / heartbeat_timeout)")
        self.c_migrated = registry.counter(
            "requests_migrated_total", "queued or in-flight requests "
            "re-entered into the router after a replica death or drain")
        self.g_depth = registry.gauge(
            "router_queue_depth", "requests arrived and waiting for "
            "dispatch (the admission controller's queue signal)")

    # ----------------------------------------------------------- admission
    def submit(self, req: FleetRequest) -> None:
        self.requests[req.index] = req
        if req.trace is None:
            req.trace = tracecontext.new_trace(phase=req.phase)
        req.next_eligible = max(req.next_eligible, req.t_arrival)
        self.pending.append(req)

    def queue_depth(self, now: float) -> int:
        """Arrived-and-waiting count (not-yet-arrived open-loop requests
        are excluded: they are load that has not happened yet)."""
        depth = sum(1 for r in self.pending if r.t_arrival <= now)
        self.g_depth.set(depth)
        return depth

    def take_dispatchable(self, now: float) -> List[FleetRequest]:
        """Pop every request whose arrival AND backoff/retry-after gates
        have passed, earliest-arrival first (FIFO within a tick)."""
        ready = [r for r in self.pending if r.next_eligible <= now]
        if ready:
            self.pending = [r for r in self.pending
                            if r.next_eligible > now]
            ready.sort(key=lambda r: (r.t_arrival, r.index))
        return ready

    def requeue_wait(self, req: FleetRequest, until: float) -> None:
        """Put a request back untouched (no budget burned) until ``until``
        — the no-healthy-replica / admission-retry-after path."""
        req.next_eligible = until
        self.pending.append(req)

    # ------------------------------------------------------------ dispatch
    def backoff(self, attempt: int) -> float:
        """Delay before re-dispatch number ``attempt`` (1-based count of
        failures so far).  Deterministic given ``RouterConfig.seed``: the
        k-th call consumes the k-th variate of the seeded generator."""
        c = self.config
        base = min(c.backoff_max_s,
                   c.backoff_base_s * c.backoff_factor ** (attempt - 1))
        return base * (1.0 + c.backoff_jitter * float(self._rng.random()))

    def pick(self, req: FleetRequest, healthy: list):
        """Choose a replica for ``req`` under the configured policy.  In
        disaggregated mode each phase routes against its OWN pool:
        prefill-phase requests go to the prefill-role replica with the
        shortest queue (fewest assigned requests — prefill work is one
        prompt-sized burst, so queue length IS the wait), decode-phase
        (and unified "full") requests to the decode pool by
        ``prefix_affinity`` — a handed-off request lands where its folded
        prompt is already radix-resident.  An empty role pool falls back
        to the whole healthy set under the configured policy."""
        if not healthy:
            raise NoHealthyReplicas(
                f"no healthy replica for request {req.index}")
        if self.config.disaggregated:
            role = "prefill" if req.phase == "prefill" else "decode"
            pool = [r for r in healthy
                    if getattr(r, "role", None) == role]
            if pool:
                if role == "prefill":
                    return min(pool, key=lambda rep: (
                        self.assigned_count(rep.name),
                        self.outstanding_tokens(rep.name), rep.name))
                return prefix_affinity(req, pool, self, self._rng)
        return self._policy(req, healthy, self, self._rng)

    def dispatch(self, req: FleetRequest, replica, now: float) -> None:
        """Hand ``req`` to ``replica``.  Fires the ``router.dispatch``
        chaos site BEFORE the hand-off: an injected fault here models a
        dispatch-path failure (connection refused, serialization error)
        and is the retry/backoff path's test vector."""
        req.attempts += 1              # counted even if the dispatch faults
        if req.trace is not None:
            # new attempt span, SAME trace/flow id: a retried or migrated
            # request stays one causal tree with per-attempt children
            req.trace = req.trace.child(phase=req.phase,
                                        attempt=req.attempts)
        faults.fire("router.dispatch", index=req.index,
                    replica=replica.name)
        req.assigned = replica.name
        req.deadline = (now + self.config.request_timeout_s
                        if self.config.request_timeout_s > 0
                        else float("inf"))
        self.inflight[req.index] = req
        # this replica's radix residency is about to change (the dispatch
        # will insert the request's blocks, and its adapter pool may load
        # or evict pages): drop its probe caches so the next pick
        # re-probes it — everyone else's entries stay warm
        self._residency.pop(replica.name, None)
        self._adapter_residency.pop(replica.name, None)
        replica.enqueue(req)

    def fail_attempt(self, req: FleetRequest, now: float, reason: str,
                     detail: str = "") -> None:
        """One attempt failed (dispatch error, timeout, replica death).
        Requeue with backoff, or — past the bounded budget — move the
        request to ``failed`` as a typed :class:`RequestFailed`."""
        self.inflight.pop(req.index, None)
        req.assigned = None
        req.epoch += 1
        if req.attempts > self.config.max_retries:
            self.failed[req.index] = RequestFailed(
                req.index, reason, req.attempts, detail)
            logger.warning(f"router: {self.failed[req.index]}")
            return
        self.c_retries.inc(1, reason=reason)
        req.next_eligible = now + self.backoff(req.attempts)
        self.pending.append(req)

    # ----------------------------------------------------------- migration
    def migrate(self, req: FleetRequest, now: float, *, reason: str,
                record: Optional[dict] = None,
                burn_budget: bool = True) -> None:
        """Re-enter a queued/in-flight request after a replica death or
        drain.  ``record`` is the engine's export for this request (folded
        prompt + generated tail); without one (heartbeat-declared death of
        a hung replica — its state cannot be read safely) the request
        retries from its last known context, recomputing the lost tail.
        The ORIGINAL arrival timestamp is preserved: with greedy decoding
        the re-served request completes token-exact vs. a no-failure run."""
        if req.assigned is not None:
            self._residency.pop(req.assigned, None)
            self._adapter_residency.pop(req.assigned, None)
        self.inflight.pop(req.index, None)
        req.assigned = None
        req.epoch += 1
        req.migrations += 1
        if record is not None:
            req.prompt = record["prompt"]
            req.generated = req.generated + list(record["generated"])
        self.c_migrated.inc(1)
        if burn_budget:
            # the failed dispatch itself already counted in req.attempts
            if req.attempts > self.config.max_retries:
                self.failed[req.index] = RequestFailed(
                    req.index, reason, req.attempts)
                logger.warning(f"router: {self.failed[req.index]}")
                return
            self.c_retries.inc(1, reason=reason)
        # no backoff: the survivors are healthy and the request has waited
        # since its original arrival already
        req.next_eligible = now
        self.pending.append(req)

    # ------------------------------------------------------------- handoff
    def handoff(self, index: int, epoch: int, tokens: np.ndarray,
                now: float) -> Optional[FleetRequest]:
        """Advance a prefill-phase request to its decode phase: fold the
        prefill attempt's output (its first generated token) into the
        prompt — the SAME host-known fold migration uses, so greedy decode
        on any replica continues token-exact — and requeue it immediately
        as phase "decode" for the decode pool to pick up.  Burns no retry
        budget (a handoff is the request's normal lifecycle, not a
        failure).  Strictly epoch-gated, unlike ``complete``: a stale
        prefill attempt must not fold into a request some LIVE attempt
        owns — the live attempt produces its own (token-identical)
        result.  Returns the advanced request, or None when stale/done."""
        if index in self.done or index in self.failed:
            return None
        req = self.inflight.get(index)
        if req is None or req.epoch != epoch:
            return None
        del self.inflight[index]
        req.assigned = None
        req.epoch += 1
        new = [int(t) for t in np.asarray(tokens).reshape(-1)
               [len(req.generated):]]
        if new:
            req.prompt = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(new, np.int32)])
            req.generated = req.generated + new
        req.phase = "decode"
        req.next_eligible = now     # no backoff: this is progress
        self.pending.append(req)
        return req

    # ---------------------------------------------------------- completion
    def complete(self, index: int, epoch: int, tokens: np.ndarray) -> bool:
        """Record a finished request.  First result wins: a stale attempt
        (its epoch lost a requeue race) that still finished carries
        token-identical output under greedy decoding, so it is accepted
        when it arrives first and dropped when it arrives second — either
        way ``done`` holds exactly one output per request."""
        if index in self.done or index in self.failed:
            return False
        req = self.requests.get(index)
        if req is None:
            return False
        self.done[index] = np.asarray(tokens, np.int32)
        # first result retires the request wherever it currently sits —
        # inflight (fresh or re-dispatched attempt) or pending (queued for
        # a retry the stale result just made unnecessary); ``epoch`` is
        # informational here, it only gates MIGRATION records
        self.inflight.pop(index, None)
        self.pending = [r for r in self.pending if r.index != index]
        return True

    def check_timeouts(self, now: float) -> List[FleetRequest]:
        """Per-attempt deadlines: an in-flight request past its deadline is
        retried elsewhere (reason ``timeout``; the hung attempt's late
        result deduplicates against the epoch bump)."""
        late = [r for r in self.inflight.values() if now > r.deadline]
        for req in late:
            self.fail_attempt(req, now, "timeout",
                              detail=f"replica {req.assigned}")
        return late

    # ----------------------------------------------------------- residency
    def residency(self, rep, req: FleetRequest) -> int:
        """Cached radix-residency probe for ``prefix_affinity``: how many
        of ``req.prompt``'s tokens are radix-resident on ``rep``.  The
        underlying ``engine.prefix_cached_tokens`` walk is O(prompt) per
        replica per request; at fleet scale that walk WAS the routing
        cost, so results cache per (replica, prompt bytes) until the
        replica's residency can have changed — a dispatch to it, a
        migration off it, or its death drops that replica's entries
        (``invalidate_residency``).  A stale entry therefore only ever
        UNDER-states residency, which costs one suboptimal pick, never
        correctness.  Replicas without a probe (fakes, cache off) report
        0 uncached, and a failing probe (dying replica) reports 0 without
        poisoning the cache."""
        probe = getattr(getattr(rep, "engine", None),
                        "prefix_cached_tokens", None)
        if probe is None:
            return 0
        cache = self._residency.setdefault(rep.name, {})
        key = np.asarray(req.prompt, np.int32).tobytes()
        hit = cache.get(key)
        if hit is None:
            try:
                hit = int(probe(req.prompt))
            except Exception:  # noqa: BLE001 — a dying replica's probe
                return 0       # must never take the dispatcher down
            if len(cache) >= self._residency_cap:
                cache.clear()
            cache[key] = hit
        return hit

    def adapter_residency(self, rep, req: FleetRequest) -> int:
        """Cached adapter-residency probe for ``prefix_affinity``: 1 when
        ``rep``'s adapter pool already holds ``req.adapter``'s pages, else
        0.  Base-model requests (adapter 0) and replicas without a probe
        (fakes, adapters off) report 0 — the signal vanishes and routing
        degrades to exactly the prefix/least-outstanding order.  The probe
        (``engine.adapter_resident``) is a read-only host dict peek, safe
        from the dispatcher thread; results cache per (replica, adapter)
        and invalidate wherever the prefix cache does (dispatch,
        migration, death), since a dispatch can load OR evict adapter
        pages.  A stale entry only ever UNDER-states residency — one
        suboptimal pick and a hot-load, never a correctness issue — and a
        failing probe (dying replica) reports 0 without poisoning the
        cache."""
        if not req.adapter:
            return 0
        probe = getattr(getattr(rep, "engine", None),
                        "adapter_resident", None)
        if probe is None:
            return 0
        cache = self._adapter_residency.setdefault(rep.name, {})
        hit = cache.get(req.adapter)
        if hit is None:
            try:
                hit = int(probe([req.adapter]))
            except Exception:  # noqa: BLE001 — a dying replica's probe
                return 0       # must never take the dispatcher down
            if len(cache) >= self._residency_cap:
                cache.clear()
            cache[req.adapter] = hit
        return hit

    def invalidate_residency(self, name: Optional[str] = None) -> None:
        """Drop the residency probe cache for one replica (death, drain,
        role flip) or for the whole fleet (``name=None``)."""
        if name is None:
            self._residency.clear()
            self._adapter_residency.clear()
        else:
            self._residency.pop(name, None)
            self._adapter_residency.pop(name, None)

    # -------------------------------------------------------------- status
    def outstanding_tokens(self, replica_name: str) -> int:
        return sum(len(r.prompt) + r.remaining
                   for r in self.inflight.values()
                   if r.assigned == replica_name)

    def assigned_count(self, replica_name: str) -> int:
        """In-flight requests currently assigned to ``replica_name`` (the
        prefill pool's shortest-queue routing signal)."""
        return sum(1 for r in self.inflight.values()
                   if r.assigned == replica_name)

    def assigned_to(self, replica_name: str) -> List[FleetRequest]:
        return [r for r in self.inflight.values()
                if r.assigned == replica_name]

    def settled(self) -> bool:
        return not self.pending and not self.inflight
