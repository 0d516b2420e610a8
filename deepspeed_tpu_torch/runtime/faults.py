"""Deterministic fault injection for resilience testing.

The PyTorch port's copy of deepspeed_tpu/runtime/faults.py (host Python; the
port keeps its own copy so that it imports nothing of the JAX package).

The elastic/drain/checkpoint machinery exists to survive host loss, torn
checkpoint writes, and slow-commit races — failures that are rare and
non-deterministic in production.  This module makes them DETERMINISTIC:
durability-critical code paths call :func:`fire` at named sites
("universal.pre_meta", "drain.pre_export", ...), and a configured injector
trips exactly the failure a test asked for, exactly once (or N times), at
exactly that site.

Reference analog: the reference's elasticity/checkpoint unit tests kill
torch.multiprocessing workers and truncate files by hand; here the injection
points are part of the library surface so chaos tests (tests/test_chaos.py)
and the elastic-agent tests drive the SAME code the fleet runs, not a
test-only copy.

Fault kinds:

- ``exc``       — raise :class:`InjectedFault` (an abortive failure whose
                  cleanup handlers still run; models an I/O error)
- ``host_loss`` — ``os._exit(17)``: the process vanishes mid-operation, no
                  ``finally`` blocks, no atexit — the SIGKILL/preemption case
- ``sleep``     — delay the site by ``arg`` seconds (slow-commit races: a
                  reader scanning for the newest COMPLETE export while the
                  commit is stretched out; a hung collective when armed at
                  ``step.dispatch``)
- ``nan``       — a SIGNAL-ONLY kind: :func:`fire` returns ``"nan"`` and the
                  instrumented site poisons its own values (the engine's
                  ``step.grads`` site writes NaN into the step's gradient
                  computation — the NaN-burst model the guardian remediates)

Configuration: programmatic (``inject("universal.pre_meta", "exc")``) or the
``DSTPU_FAULTS`` env var (comma list of ``kind@site[:arg][*count][+after]``
— ``+after`` lets the first N firings pass, e.g.
``host_loss@universal.mid_fragments+2`` dies mid-write of the THIRD
export), read once at import by worker processes — the elastic agent and
the chaos tests use it to arm faults in spawned workers.

Sites are free-form strings; :func:`fire` at an unarmed site costs one dict
lookup on an empty-by-default registry.  The module is always importable and
always armed-empty in production — there is no "enabled" flag to forget.

Instrumented site families (grep for ``faults.fire`` / ``fire(`` for the
authoritative list): ``universal.*`` / ``drain.*`` (checkpoint + drain
durability ordering), the serving-fleet sites —
``router.dispatch`` (a dispatch attempt from the fleet router),
``replica.heartbeat`` (a replica's liveness beat; ``sleep`` here models a
stalled replica the supervisor must deadline out), ``replica.mid_decode``
(inside the v2 engine's scheduler loop — a replica dying mid-serve),
``admission.decide`` (the admission controller's per-request decision),
``fleet.respawn_factory`` (the engine factory during a respawn — an ``exc``
here must book the replica dead, never unwind the dispatcher),
``handoff.mid_transfer`` (between the KV block pin and the handoff commit
of a disaggregated prefill->decode handoff — an ``exc`` models the source
replica dying mid-transfer: the fleet must release the pinned blocks and
re-enter the request through the migration fold) — and the
training step path: ``step.grads`` (``nan`` poisons the step's gradient
computation) and ``step.dispatch`` (``sleep`` models a hung collective the
guardian's watchdog must deadline out).

Introspection: :func:`fired`/:func:`armed`/:func:`sites` read the per-site
accounting (fired counts persist after a one-shot fault disarms, so a test
can assert "exactly one injection tripped at replica.mid_decode" without
process isolation); :func:`reset` returns the process-wide injector to the
pristine state (disarms everything and zeroes the accounting).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

HOST_LOSS_EXIT_CODE = 17


class InjectedFault(RuntimeError):
    """The exception the ``exc`` fault kind raises at its site."""


class _Fault:
    __slots__ = ("kind", "site", "arg", "remaining", "after", "fired")

    def __init__(self, kind: str, site: str, arg: float = 0.0,
                 count: int = 1, after: int = 0):
        if kind not in ("exc", "host_loss", "sleep", "nan"):
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(expected exc|host_loss|sleep|nan)")
        self.kind = kind
        self.site = site
        self.arg = float(arg)
        self.remaining = int(count)
        self.after = int(after)          # let the first N fire()s pass
        self.fired = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"_Fault({self.kind}@{self.site}:{self.arg} "
                f"after={self.after} remaining={self.remaining} "
                f"fired={self.fired})")


class FaultInjector:
    """Site → armed faults registry.  Thread-safe: drain/export run on
    worker threads and the chaos tests arm faults from the main thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: Dict[str, List[_Fault]] = {}
        # site -> trips since the last clear()/reset(): survives a one-shot
        # fault disarming (the _Fault object keeps its own .fired too, but a
        # site-level log is what determinism assertions read)
        self._fired_log: Dict[str, int] = {}

    # ------------------------------------------------------------- arming

    def inject(self, site: str, kind: str, arg: float = 0.0,
               count: int = 1, after: int = 0) -> None:
        """Arm ``kind`` to trip ``count`` calls of ``fire(site)``, after
        letting the first ``after`` calls pass (deterministic "die on the
        Nth export" scheduling)."""
        f = _Fault(kind, site, arg, count, after)
        with self._lock:
            self._faults.setdefault(site, []).append(f)

    def configure(self, spec: str) -> None:
        """Parse a ``DSTPU_FAULTS``-style spec: comma-separated
        ``kind@site[:arg][*count][+after]`` items, e.g.
        ``host_loss@universal.mid_fragments+2`` (die mid-write of the THIRD
        export)."""
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "@" not in item:
                raise ValueError(
                    f"bad fault spec {item!r}: expected "
                    f"kind@site[:arg][*count][+after]")
            kind, rest = item.split("@", 1)
            after = 0
            if "+" in rest:
                rest, n = rest.rsplit("+", 1)
                after = int(n)
            count = 1
            if "*" in rest:
                rest, n = rest.rsplit("*", 1)
                count = int(n)
            arg = 0.0
            if ":" in rest:
                rest, a = rest.rsplit(":", 1)
                arg = float(a)
            self.inject(rest, kind, arg, count, after)

    def clear(self) -> None:
        with self._lock:
            self._faults.clear()
            self._fired_log.clear()

    # ``reset`` is the test-facing name for "return to pristine": today it
    # is clear(), kept separate so arming semantics can later diverge from
    # accounting semantics without breaking callers of either.
    reset = clear

    # ------------------------------------------------------------- firing

    def fire(self, site: str, **ctx) -> Optional[str]:
        """Trip any fault armed at ``site`` (no-op when none is).  ``ctx``
        is logged for attribution (step, tag, ...).  Returns the kind that
        fired for the NON-raising kinds (``"sleep"`` after the delay,
        ``"nan"`` immediately — the site reads the return value and poisons
        its own state) and None when nothing fired; ``exc`` raises and
        ``host_loss`` never returns."""
        with self._lock:
            pending = self._faults.get(site)
            if not pending:
                return None
            fault = None
            for f in pending:
                if f.remaining <= 0:
                    continue
                if f.after > 0:
                    f.after -= 1         # this call passes FOR THIS fault;
                    continue             # co-armed faults still get a shot
                fault = f
                break
            if fault is None:
                return None
            fault.remaining -= 1
            fault.fired += 1
            self._fired_log[site] = self._fired_log.get(site, 0) + 1
        extra = (" " + " ".join(f"{k}={v}" for k, v in ctx.items())
                 if ctx else "")
        logger.warning(f"fault injection: {fault.kind} at {site}{extra}")
        if fault.kind == "sleep":
            time.sleep(fault.arg)
            return "sleep"
        if fault.kind == "nan":
            return "nan"
        if fault.kind == "host_loss":
            # the preemption/SIGKILL model: the process vanishes NOW —
            # no finally blocks, no atexit checkpoint fences, no cleanup
            os._exit(HOST_LOSS_EXIT_CODE)
        raise InjectedFault(f"injected fault at {site}{extra}")

    def fired(self, site: Optional[str] = None) -> int:
        """How many faults have tripped (at ``site``, or anywhere) since the
        last clear()/reset() — counts persist after a one-shot disarms."""
        with self._lock:
            if site is not None:
                return self._fired_log.get(site, 0)
            return sum(self._fired_log.values())

    def armed(self, site: Optional[str] = None) -> int:
        with self._lock:
            total = 0
            for s, fs in self._faults.items():
                if site is None or s == site:
                    total += sum(f.remaining for f in fs)
            return total

    def sites(self) -> Dict[str, Dict[str, int]]:
        """Snapshot of the per-site accounting:
        ``{site: {"armed": still-pending trips, "fired": trips so far}}``
        covering every site that was ever armed or tripped."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for s, fs in self._faults.items():
                out[s] = {"armed": sum(f.remaining for f in fs), "fired": 0}
            for s, n in self._fired_log.items():
                out.setdefault(s, {"armed": 0, "fired": 0})["fired"] = n
            return out


# the process-wide injector every instrumented site fires through
injector = FaultInjector()


def inject(site: str, kind: str, arg: float = 0.0, count: int = 1,
           after: int = 0) -> None:
    injector.inject(site, kind, arg, count, after)


def fire(site: str, **ctx) -> Optional[str]:
    return injector.fire(site, **ctx)


def clear() -> None:
    injector.clear()


def reset() -> None:
    """Return the process-wide injector to the pristine state: disarm every
    fault and zero the fired/armed accounting (the per-test baseline the
    chaos and fleet suites call instead of isolating processes)."""
    injector.reset()


def fired(site: Optional[str] = None) -> int:
    return injector.fired(site)


def armed(site: Optional[str] = None) -> int:
    return injector.armed(site)


def sites() -> Dict[str, Dict[str, int]]:
    return injector.sites()


# worker processes arm faults from the environment (the elastic agent / chaos
# tests set DSTPU_FAULTS in the spawn env)
_env_spec = os.environ.get("DSTPU_FAULTS", "")
if _env_spec:
    injector.configure(_env_spec)
