"""PyTorch port, the serving fleet's policy modules held to the JAX
package's: ``runtime/faults.py``, ``telemetry/timeseries.py`` and
``serving/{router,admission,autoscale,slo}.py``.

Each scenario is one function of a namespace of classes; it runs once on
the JAX package's modules and once on the port's, with the same inputs,
the same injected clock and the same seed, and logs every output,
decision, counter and exception.  The two logs must be equal exactly.
Pure host code: the whole file takes about a second.
"""

import math

import numpy as np
import pytest

from deepspeed_tpu.runtime import faults as jax_faults
from deepspeed_tpu.serving import admission as jax_admission
from deepspeed_tpu.serving import autoscale as jax_autoscale
from deepspeed_tpu.serving import router as jax_router
from deepspeed_tpu.serving import slo as jax_slo
from deepspeed_tpu.telemetry import registry as jax_registry
from deepspeed_tpu.telemetry import timeseries as jax_timeseries
from deepspeed_tpu_torch.runtime import faults as port_faults
from deepspeed_tpu_torch.serving import admission as port_admission
from deepspeed_tpu_torch.serving import autoscale as port_autoscale
from deepspeed_tpu_torch.serving import router as port_router
from deepspeed_tpu_torch.serving import slo as port_slo
from deepspeed_tpu_torch.telemetry import registry as port_registry
from deepspeed_tpu_torch.telemetry import timeseries as port_timeseries


class _NS:
    def __init__(self, faults, router, admission, autoscale, slo, registry,
                 timeseries):
        self.faults = faults
        self.router = router
        self.admission = admission
        self.autoscale = autoscale
        self.slo = slo
        self.MetricRegistry = registry.MetricRegistry
        self.timeseries = timeseries


JAX = _NS(jax_faults, jax_router, jax_admission, jax_autoscale, jax_slo,
          jax_registry, jax_timeseries)
PORT = _NS(port_faults, port_router, port_admission, port_autoscale,
           port_slo, port_registry, port_timeseries)


@pytest.fixture(autouse=True)
def _clean_faults():
    for ns in (JAX, PORT):
        ns.faults.reset()
    yield
    for ns in (JAX, PORT):
        ns.faults.reset()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


def _error(e):
    """(kind, text) of an exception.  pydantic wraps a config validator's
    ValueError in a ValidationError (a ValueError) around the same text;
    the port's dataclass configs raise the ValueError itself."""
    text = str(e)
    if type(e).__name__ == "ValidationError" and "Value error, " in text:
        text = text.split("Value error, ", 1)[1].split(" [type=", 1)[0]
    return ("ValueError" if isinstance(e, ValueError)
            else type(e).__name__), text


class _Log(list):
    def call(self, fn, *args, **kw):
        """Log fn's result, or the exception it raised (kind and text)."""
        try:
            out = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — the log compares them
            self.append(("raised",) + _error(e))
            return None
        self.append(out)
        return out


def _samples(reg, name):
    m = reg._metrics.get(name)
    return [] if m is None else sorted(
        (sorted(labels.items()), v) for labels, v in m.samples())


class _Replica:
    def __init__(self, name, role=None, engine=None):
        self.name = name
        self.role = role
        self.engine = engine
        self.enqueued = []

    def enqueue(self, req):
        self.enqueued.append(req.index)


class _Probe:
    """A replica engine's residency probes (counted)."""

    def __init__(self, tokens, adapters=(), fail=False):
        self.tokens, self.adapters, self.fail = tokens, set(adapters), fail
        self.probes = 0

    def prefix_cached_tokens(self, prompt):
        self.probes += 1
        if self.fail:
            raise RuntimeError("replica is dying")
        return min(self.tokens, len(prompt))

    def adapter_resident(self, ids):
        return sum(1 for a in ids if a in self.adapters)


# ------------------------------------------------------------- scenarios

def faults_introspection(ns):
    f, log = ns.faults, _Log()
    f.inject("replica.mid_decode", "exc", count=2)
    f.inject("router.dispatch", "exc")
    f.injector.configure("sleep@replica.heartbeat:0.0*2+1, nan@step.grads")
    log += [f.armed("replica.mid_decode"), f.armed(), f.sites()]
    log.call(f.fire, "replica.mid_decode", index=3)
    log += [f.fired("replica.mid_decode"), f.fired(), f.sites()]
    log += [f.fire("replica.heartbeat"), f.fire("replica.heartbeat"),
            f.fire("replica.heartbeat"), f.fire("replica.heartbeat")]
    log += [f.fire("step.grads"), f.fire("step.grads"), f.sites()]
    log.call(f.injector.configure, "exc-router.dispatch")
    log.call(f.inject, "x", "meltdown")
    f.reset()
    log += [f.fired(), f.armed(), f.sites(), f.fire("replica.mid_decode")]
    f.inject("admission.decide", "exc")
    log.call(f.fire, "admission.decide")
    log += [f.fire("admission.decide"), f.fired("admission.decide"),
            f.armed("admission.decide")]
    return log


def router_backoff_and_budget(ns):
    r_mod, log = ns.router, _Log()
    for cfg in (dict(seed=7), dict(seed=0, backoff_base_s=0.1,
                                   backoff_factor=10.0, backoff_max_s=0.5,
                                   backoff_jitter=0.0)):
        r = r_mod.Router(r_mod.RouterConfig(**cfg), clock=lambda: 0.0,
                         registry=ns.MetricRegistry())
        log.append([r.backoff(k) for k in range(1, 10)])
    reg = ns.MetricRegistry()
    r = r_mod.Router(r_mod.RouterConfig(max_retries=2, seed=3),
                     clock=lambda: 0.0, registry=reg)
    req = r_mod.FleetRequest(index=5, prompt=np.zeros(4, np.int32),
                             max_new_tokens=4, t_arrival=1.0)
    r.submit(req)
    rep = _Replica("r0")
    now = 1.0
    log.append([q.index for q in r.take_dispatchable(0.5)])
    for _ in range(3):
        got = r.take_dispatchable(now + 100)
        log.append([q.index for q in got])
        r.dispatch(req, rep, now)
        r.fail_attempt(req, now, "dispatch_error", detail="boom")
        log.append((req.attempts, req.epoch, req.next_eligible - now))
    err = r.failed[5]
    log += [(type(err).__name__, err.reason, err.attempts, str(err)),
            r.settled(), _samples(reg, "router_retries_total")]
    log.call(r_mod.Router, r_mod.RouterConfig(policy="nope"),
             clock=lambda: 0.0, registry=ns.MetricRegistry())
    log.call(r.pick, req, [])
    # per-attempt deadlines
    r = r_mod.Router(r_mod.RouterConfig(request_timeout_s=2.0),
                     clock=lambda: 0.0, registry=reg)
    req = r_mod.FleetRequest(index=1, prompt=np.zeros(3, np.int32),
                             max_new_tokens=2)
    r.submit(req)
    r.take_dispatchable(0.0)
    r.dispatch(req, rep, 0.0)
    log += [[q.index for q in r.check_timeouts(1.0)],
            [q.index for q in r.check_timeouts(2.5)], req.epoch,
            _samples(reg, "router_retries_total")]
    return log


def router_policies(ns):
    r_mod, log = ns.router, _Log()

    def req(i, n, budget=4, adapter=0, prompt=None):
        return r_mod.FleetRequest(
            index=i, prompt=(np.arange(n, dtype=np.int32) if prompt is None
                             else prompt),
            max_new_tokens=budget, adapter=adapter)

    r = r_mod.Router(r_mod.RouterConfig(), clock=lambda: 0.0,
                     registry=ns.MetricRegistry())
    a, b = _Replica("r0"), _Replica("r1")
    q0 = req(0, 10, 10)
    r.submit(q0)
    r.dispatch(q0, a, 0.0)
    log += [r.pick(req(1, 4), [a, b]).name, r.outstanding_tokens("r0"),
            r.assigned_count("r0"), [q.index for q in r.assigned_to("r0")]]
    rr = r_mod.Router(r_mod.RouterConfig(policy="round_robin"),
                      clock=lambda: 0.0, registry=ns.MetricRegistry())
    reps = [_Replica(f"r{i}") for i in range(3)]
    log.append([rr.pick(req(0, 4), reps).name for _ in range(7)])
    # prefix_affinity: residency first, adapter residency second, then
    # least outstanding tokens, then name
    pa = r_mod.Router(r_mod.RouterConfig(policy="prefix_affinity"),
                      clock=lambda: 0.0, registry=ns.MetricRegistry())
    reps = [_Replica("r0"), _Replica("r1", engine=_Probe(16)),
            _Replica("r2", engine=_Probe(8, adapters=(3,))),
            _Replica("r3", engine=_Probe(16, adapters=(3,)))]
    log += [pa.pick(req(i, 20, adapter=i % 4), reps).name for i in range(6)]
    log += [pa.pick(req(0, 20), reps[:3]).name,
            pa.pick(req(0, 20), [_Replica("b1"), _Replica("b0")]).name,
            [p.engine.probes for p in reps[1:]]]
    return log


def router_residency_cache(ns):
    r_mod, log = ns.router, _Log()
    r = r_mod.Router(r_mod.RouterConfig(policy="prefix_affinity"),
                     clock=lambda: 0.0, registry=ns.MetricRegistry())
    e1, e2 = _Probe(8), _Probe(16)
    reps = [_Replica("r1", engine=e1), _Replica("r2", engine=e2)]
    p = np.arange(24, dtype=np.int32)
    reqs = [r_mod.FleetRequest(index=i, prompt=p.copy(), max_new_tokens=2)
            for i in range(4)]
    for q in reqs:
        log.append(r.pick(q, reps).name)
    log.append((e1.probes, e2.probes))
    r.submit(reqs[0])
    r.dispatch(reqs[0], reps[1], 0.0)     # drops r2's entries only
    log += [r.pick(reqs[1], reps).name, (e1.probes, e2.probes)]
    r.invalidate_residency()
    log += [r.pick(reqs[2], reps).name, (e1.probes, e2.probes)]
    e2.fail = True                        # a dying replica's probe
    r.invalidate_residency("r2")
    log += [r.residency(reps[1], reqs[3]), r.residency(reps[1], reqs[3]),
            e2.probes, sorted(r._residency)]
    return log


def router_handoff_and_migration(ns):
    r_mod, log = ns.router, _Log()
    reg = ns.MetricRegistry()
    r = r_mod.Router(r_mod.RouterConfig(disaggregated=True, max_retries=1),
                     clock=lambda: 0.0, registry=reg)
    pre, dec = _Replica("p0", role="prefill"), _Replica("d0", role="decode")
    dec2 = _Replica("d1", role="decode", engine=_Probe(8))
    reqs = []
    for i in range(3):
        q = r_mod.FleetRequest(index=i, prompt=np.arange(5 + i,
                                                         dtype=np.int32),
                               max_new_tokens=6, phase="prefill")
        r.submit(q)
        reqs.append(q)
    for q in r.take_dispatchable(0.0):
        rep = r.pick(q, [pre, dec, dec2])
        log.append(rep.name)
        r.dispatch(q, rep, 0.0)
    q0 = reqs[0]
    stale = q0.epoch
    got = r.handoff(0, stale, np.array([42], np.int32), 1.0)
    log += [got is q0, q0.phase, q0.prompt.tolist(), q0.generated,
            q0.epoch]
    # strictly epoch-gated: a stale prefill attempt folds nothing
    log += [r.handoff(0, stale, np.array([42], np.int32), 1.0),
            q0.generated]
    log.append(r.pick(q0, [pre, dec, dec2]).name)
    log.append(r.pick(q0, [pre]).name)    # empty decode pool: fallback
    # migration: with a record (folded), without, and past the budget
    q1 = reqs[1]
    r.migrate(q1, 2.0, reason="replica_death",
              record={"prompt": np.arange(9, dtype=np.int32),
                      "generated": [7, 8]})
    log += [q1.prompt.tolist(), q1.generated, q1.migrations, q1.epoch,
            q1.next_eligible, q1.remaining]
    r.take_dispatchable(2.0)
    r.dispatch(q1, dec, 2.0)
    r.migrate(q1, 3.0, reason="drain", record=None, burn_budget=False)
    r.take_dispatchable(3.0)
    r.dispatch(q1, dec, 3.0)
    r.migrate(q1, 4.0, reason="replica_death")
    log += [sorted(r.failed), q1.attempts,
            _samples(reg, "router_retries_total"),
            _samples(reg, "requests_migrated_total")]
    # completion: first result wins, a second is dropped
    log += [r.complete(2, 0, np.array([1, 2], np.int32)),
            r.complete(2, 5, np.array([1, 2], np.int32)),
            r.complete(1, 0, np.array([9], np.int32)),
            sorted(r.done), r.queue_depth(10.0),
            _samples(reg, "router_queue_depth")]
    return log


def admission_hysteresis(ns):
    a_mod, r_mod, f, log = ns.admission, ns.router, ns.faults, _Log()
    clk = _Clock()
    reg = ns.MetricRegistry()
    ac = a_mod.AdmissionController(
        a_mod.AdmissionConfig(high_queue_depth=10, low_queue_depth=3,
                              high_kv_failures_per_s=5.0,
                              low_kv_failures_per_s=1.0, retry_after_s=0.1),
        registry=reg, clock=clk)
    steps = [(5, 0.0, 1.0), (11, 0.0, 1.0), (9, 0.0, 1.0), (4, 0.0, 1.0),
             (3, 0.0, 1.0), (8, 3.0, 1.0), (0, 10.0, 1.0), (0, 14.0, 1.0),
             (0, 14.5, 1.0), (0, 26.5, 4.0), (0, 38.5, 0.5),
             (0, 39.5, 0.001), (0, 39.5, 0.3), (2, 39.5, 0.3)]
    req = r_mod.FleetRequest(index=0, prompt=np.zeros(4, np.int32),
                             max_new_tokens=4)
    for depth, kv, dt in steps:
        clk.tick(dt)
        log.append(ac.update(depth, kv_failures_total=kv))
        log.append(ac.decide(req))
        log.append((ac.shed_rate(), ac._rate))
    log += [req.rejections, _samples(reg, "admission_rejections_total"),
            _samples(reg, "admission_shedding")]
    # the registry signal: the fleet-wide kv_alloc_failures_total sum
    reg.counter("kv_alloc_failures_total").inc(7, site="put", replica="r0")
    reg.counter("kv_alloc_failures_total").inc(2, site="put", replica="r1")
    log.append(ac.kv_failures_total())
    # the opt-in SLO burn signal, same hysteresis contract
    burn = a_mod.AdmissionController(
        a_mod.AdmissionConfig(slo_burn_shed=True, high_slo_burn=2.0,
                              low_slo_burn=1.0),
        registry=ns.MetricRegistry(), clock=clk)
    for b in (0.5, 2.5, 1.5, 0.9, None):
        clk.tick()
        log.append(burn.update(0, kv_failures_total=0.0, slo_burn=b))
    # the fault site fires on every decision (the fleet fails open)
    f.inject("admission.decide", "exc")
    log.call(ac.decide, req)
    log.append(f.fired("admission.decide"))
    # config validation
    log.call(a_mod.AdmissionConfig.parse, {"high_kv_failures_per_tick": 5})
    log.call(a_mod.AdmissionConfig.parse, {"rate_window_s": 0.0})
    log.call(a_mod.AdmissionController,
             a_mod.AdmissionConfig(low_queue_depth=20, high_queue_depth=10),
             registry=ns.MetricRegistry(), clock=clk)
    log.call(a_mod.AdmissionController,
             a_mod.AdmissionConfig(low_kv_failures_per_s=9.0,
                                   high_kv_failures_per_s=1.0),
             registry=ns.MetricRegistry(), clock=clk)
    off = a_mod.AdmissionController(a_mod.AdmissionConfig(enabled=False),
                                    registry=ns.MetricRegistry(), clock=clk)
    log += [off.update(10 ** 6), off.decide(req)]
    return log


def autoscaler(ns):
    s_mod, log = ns.autoscale, _Log()
    t = [0.0]
    s = s_mod.PoolAutoscaler(
        s_mod.AutoscaleConfig.parse({"enabled": True, "min_requests": 0,
                                     "interval_s": 1.0, "cooldown_s": 5.0}),
        registry=ns.MetricRegistry(), clock=lambda: t[0])
    reg = s.registry
    h, h2 = reg.histogram("serving_ttft_ms", "t"), \
        reg.histogram("serving_tpot_ms", "t")
    for i in range(8):
        h.observe(1000.0 + i, replica="r0")
        h2.observe(1.0 + 0.1 * i, replica="r1")
    h.observe(5.0, replica="r2")
    pools = {"prefill": 1, "decode": 2}
    log += [s.evaluate(10.0, pools), s.evaluate(10.5, pools),
            sorted(s.last_signals.items())]
    s.record_move("to_prefill", 11.0)
    log += [s.evaluate(13.0, pools),
            s.evaluate(30.0, {"prefill": 2, "decode": 1}),
            _samples(reg, "pool_replicas"),
            _samples(reg, "pool_rebalances_total"),
            s._fleet_p99("serving_ttft_ms"),
            math.isnan(s._fleet_p99("no_such_metric")[0])]
    d = s_mod.PoolAutoscaler(
        s_mod.AutoscaleConfig.parse({"enabled": True, "min_requests": 4,
                                     "slo_burn_input": True,
                                     "high_slo_burn": 1.0}),
        registry=ns.MetricRegistry(), clock=lambda: 0.0)
    base = {"requests": 10, "shedding": False, "shed_rate": 0.0}
    for sig in ({"ttft_p99_ms": 1000.0, "tpot_p99_ms": 2.0},
                {"ttft_p99_ms": 3.0, "tpot_p99_ms": 2.0},
                {"ttft_p99_ms": 40.0, "tpot_p99_ms": 2.0},
                {"ttft_p99_ms": 80.0, "tpot_p99_ms": 2.0},
                {"ttft_p99_ms": 80.0, "tpot_p99_ms": 2.0, "shedding": True},
                {"ttft_p99_ms": 80.0, "tpot_p99_ms": 2.0, "slo_burn": 1.5},
                {"ttft_p99_ms": 4.5, "tpot_p99_ms": 2.0, "slo_burn": 1.5},
                {"requests": 2, "ttft_p99_ms": 1000.0, "tpot_p99_ms": 1.0},
                {"ttft_p99_ms": float("nan"), "tpot_p99_ms": 1.0},
                {"ttft_p99_ms": 10.0, "tpot_p99_ms": 0.0}):
        log.append(d.decide({**base, **sig}))
    off = s_mod.PoolAutoscaler(None, registry=ns.MetricRegistry(),
                               clock=lambda: 0.0)
    log.append(off.evaluate(100.0, pools))
    return log


def slo_burn_over_timeseries(ns):
    slo, ts, log = ns.slo, ns.timeseries, _Log()
    log += [slo.burn_rate(99, 100, 0.99), slo.burn_rate(90, 100, 0.99),
            slo.burn_rate(0, 0, 0.99), slo.burn_rate(5, 10, 1.0),
            slo.burn_rate(10, 10, 1.0)]
    clk = _Clock()
    reg = ns.MetricRegistry()
    h = reg.histogram("serving_ttft_ms", "t")
    mon = slo.SLOMonitor(
        {"enabled": True, "sample_interval_s": 1.0, "windows_s": [60.0, 5.0],
         "alert_burn_threshold": 2.0,
         "slos": [{"name": "ttft", "threshold_ms": 100.0,
                   "objective": 0.9},
                  {"name": "tail", "threshold_ms": 120.0,
                   "objective": 0.5}]},
        registry=reg, clock=clk)
    rng = np.random.default_rng(0)
    for step in range(40):
        bad = 0.05 if step < 10 else (0.6 if step < 25 else 0.02)
        for _ in range(5):
            h.observe(float(rng.uniform(150, 400) if rng.random() < bad
                            else rng.uniform(1, 90)), replica=f"r{step % 2}")
        clk.tick(1.0 if step % 3 else 0.4)
        log.append(mon.tick())
        log.append({k: sorted(v.items()) for k, v in mon.last_burn.items()})
    log += [mon.alerts_total(), _samples(reg, "slo_alerts_total"),
            _samples(reg, "slo_burn_rate"), mon.store.samples_taken]
    store = mon.store
    for key in ("slo.ttft.good", "slo.ttft.total"):
        log += [store.latest(key), store.value_at(key, 10.0),
                store.value_at(key, -1.0), store.window_delta(key, 5.0),
                store.window_delta(key, 1e6), store.rate(key, 5.0),
                store.rate(key, 0.1), len(store.series(key))]
    log.append(ts.histogram_attainment(h, 100.0))
    log.append(ts.histogram_attainment(h, 95.0, {"replica": "r1"}))
    # a scalar and a counter series, and ring capacity
    small = ts.TimeSeriesStore(interval_s=0.5, capacity=3, clock=clk)
    c = reg.counter("router_retries_total")
    val = [0.0]
    small.track("x", lambda: val[0])
    small.track_counter(c, reason="timeout")
    for i in range(6):
        val[0] += i
        c.inc(2, reason="timeout")
        clk.tick(0.3)
        log.append(small.maybe_sample())
    log += [small.series("x"), small.series("router_retries_total"),
            small.rate("x", 10.0)]
    log.call(slo.SLOMonitor, {"enabled": True, "slos": [
        {"name": "bad", "metric": "router_retries_total"}]}, registry=reg,
        clock=clk)
    return log


SCENARIOS = [faults_introspection, router_backoff_and_budget,
             router_policies, router_residency_cache,
             router_handoff_and_migration, admission_hysteresis, autoscaler,
             slo_burn_over_timeseries]


def _normal(x):
    """Make a log comparable across the packages: numpy scalars to Python,
    NaN to a marker, tuples and lists alike."""
    if isinstance(x, (list, tuple)):
        return [_normal(v) for v in x]
    if isinstance(x, dict):
        return {k: _normal(v) for k, v in x.items()}
    if isinstance(x, (np.floating, float)):
        return "nan" if math.isnan(float(x)) else float(x)
    if isinstance(x, np.integer):
        return int(x)
    return x


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_port_equals_jax(scenario):
    want = _normal(scenario(JAX))
    got = _normal(scenario(PORT))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{scenario.__name__} entry {i}: port {g!r}, jax {w!r}"


def test_fault_kinds_and_spec_errors_are_the_jax_ones():
    """The site names and the spec grammar are one API: the port's
    injector takes every spec the JAX one takes, and refuses the same."""
    assert port_faults.HOST_LOSS_EXIT_CODE == jax_faults.HOST_LOSS_EXIT_CODE
    for bad in ("exc", "exc@x:notanumber", "exc@x*y"):
        errs = []
        for f in (jax_faults, port_faults):
            with pytest.raises(ValueError) as ei:
                f.injector.configure(bad)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]
