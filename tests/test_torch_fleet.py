"""PyTorch port, the serving fleet (``deepspeed_tpu_torch.serving``) and the
engine's fleet hooks, held to the JAX engine on the CPU.

One module-scoped greedy ``generate`` of the JAX engine over 8 seeded
requests (the JAX package's tiny config, vocab 97, fp32) is the oracle;
the port's replicas carry the same numpy weights (``params_from_numpy``).
Whatever the fleet goes through — a death mid-decode and its respawn, a
drain, a disaggregated prefill -> decode handoff, aborted handoffs, a role
flip — every request must complete exactly once with the oracle's tokens.

Faults are injected through ``runtime/faults.py`` and drains are
triggered from a replica's own heartbeat (its N-th beat: a beat comes at
the top of each scheduler round and after each step of a decode burst), so
every test is deterministic although replicas serve on worker threads.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import GPTConfig as JaxConfig
from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
from deepspeed_tpu_torch import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import EngineDrained
from deepspeed_tpu_torch.models.gpt import init_params
from deepspeed_tpu_torch.runtime import faults
from deepspeed_tpu_torch.serving import (FleetDrained, RequestFailed,
                                         ServingFleet)
from deepspeed_tpu_torch.telemetry.registry import MetricRegistry

torch.set_num_threads(1)

VOCAB, SEQ = 97, 64
SM = {"max_tracked_sequences": 4, "max_ragged_batch_size": 64,
      "kv_block_size": 8, "max_q_per_seq": 16}
V2CFG = {"dtype": "fp32", "state_manager": SM}
DISAGG = {"num_replicas": 2, "prefill_replicas": 1, "disaggregated": True,
          "respawn": False}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def tcfg():
    return dataclasses.replace(GPTConfig.tiny(vocab_size=VOCAB,
                                              max_seq_len=SEQ),
                               dtype=torch.float32)


@pytest.fixture(scope="module")
def tree(tcfg):
    """Seeded numpy weights in the port's tree layout: norm scales 1,
    everything else N(0, 0.3^2)."""
    rng = np.random.default_rng(0)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else np.ones(tuple(v.shape), np.float32) if k == "scale"
                else (rng.standard_normal(tuple(v.shape)) * 0.3
                      ).astype(np.float32)
                for k, v in t.items()}
    return walk(init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))


@pytest.fixture(scope="module")
def params(tcfg, tree):
    return params_from_numpy(tree, tcfg, "cpu", torch.float32)


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=int(rng.integers(4, 16)))
               .astype(np.int32) for _ in range(8)]
    budgets = [int(b) for b in rng.integers(6, 14, size=8)]
    return prompts, budgets


@pytest.fixture(scope="module")
def reference(tree, workload):
    """The oracle: one greedy generate of the JAX engine."""
    prompts, budgets = workload
    jeng = JaxEngine(JaxConfig.tiny(vocab_size=VOCAB, max_seq_len=SEQ),
                     config=V2CFG, params=tree)
    return jeng.generate(prompts, max_new_tokens=budgets)


def _engine(tcfg, params, sm=None, **kw):
    return InferenceEngineV2(tcfg, config={"dtype": "fp32",
                                           "state_manager": dict(SM, **(sm
                                                                      or {}))},
                             params=params, device="cpu", **kw)


def make_fleet(tcfg, params, fleet_cfg, sm=None, **kw):
    """Port engines on the CPU, one shared registry, a replica label each
    (the factory is the one phase 22 gives the fleet on the card)."""
    reg = MetricRegistry()

    def factory(name):
        return InferenceEngineV2(
            tcfg, config={"dtype": "fp32",
                          "state_manager": dict(SM, **(sm or {})),
                          "telemetry": {"replica": name}},
            params=params, device="cpu", telemetry_registry=reg)
    return ServingFleet(engine_factory=factory, config=fleet_cfg,
                        registry=reg, **kw)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _beat_hook(rep, at, fn):
    """Run ``fn`` from ``rep``'s current incarnation at its ``at``-th
    heartbeat (the engine beats at the top of each scheduler round and
    after each step of a decode burst)."""
    beat, n = rep.engine.heartbeat_fn, [0]

    def hook():
        beat()
        n[0] += 1
        if n[0] == at:
            fn()
    rep.engine.heartbeat_fn = hook


def _deaths(fleet):
    m = fleet.registry._metrics["fleet_replica_deaths_total"]
    return {labels["reason"]: v for labels, v in m.samples()}


def _assert_no_leaks(fleet, free_before=None):
    """Every pool holds references only through its radix cache, and (with
    ``free_before``) every allocator's free count is back where it was."""
    assert not fleet._handoffs, f"handoff pins leaked: {fleet._handoffs}"
    for rep in fleet.replicas.values():
        state = rep.engine.state
        held = set()
        if state.radix is not None:
            state.radix.check_invariants()
            held = {n.block for n in state.radix._nodes()}
        for b, refs in enumerate(state.allocator._ref):
            assert refs == 0 or b in held, (rep.name, b, refs)
        if free_before is not None:
            assert state.allocator.free_blocks == free_before[rep.name]


def _stitch(completed, pending, outs):
    final = dict(completed)
    for rec, out in zip(pending, outs):
        pre = np.asarray(rec["generated"], np.int32)
        final[rec["index"]] = np.concatenate([pre, out]) if pre.size else out
    return [final[i] for i in range(len(final))]


# ------------------------------------------------------ the engine's hooks

@pytest.mark.parametrize("case", ["oracle", "past_a_materialize"])
def test_death_export_requeue_token_exact(tcfg, params, workload, reference,
                                          case):
    """A death at a scheduler round: the export of host state, re-served on
    a fresh engine and stitched, equals the no-failure tokens (the JAX
    engine's on the workload).  With an EOS id that is never sampled (it
    only turns on the materialize every 16 steps), two long requests die
    at their third round, past a materialize: the export carries
    host-known progress folded into the prompt, and the reference is the
    port's own no-failure run."""
    prompts, budgets = workload
    after, eos = 2, None
    if case == "past_a_materialize":
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, VOCAB, 6).astype(np.int32)
                   for _ in range(2)]
        budgets, eos = [40, 40], VOCAB + 7
        reference = _engine(tcfg, params).generate(
            prompts, max_new_tokens=budgets, eos_token_id=eos)
    e1 = _engine(tcfg, params)
    faults.inject("replica.mid_decode", "exc", after=after)
    with pytest.raises(faults.InjectedFault):
        e1.generate(prompts, max_new_tokens=budgets, eos_token_id=eos)
    assert faults.fired("replica.mid_decode") == 1
    completed, pending = e1.export_pending_requests()
    assert len(completed) + len(pending) == len(prompts) and pending
    for rec in pending:
        orig = prompts[rec["index"]]
        np.testing.assert_array_equal(rec["prompt"][:len(orig)], orig)
        np.testing.assert_array_equal(rec["prompt"][len(orig):],
                                      rec["generated"])
        assert rec["max_new_tokens"] == (budgets[rec["index"]]
                                         - len(rec["generated"]))
    if eos is not None:
        assert any(rec["generated"] for rec in pending)
    outs = _engine(tcfg, params).generate(
        [p["prompt"] for p in pending],
        max_new_tokens=[p["max_new_tokens"] for p in pending],
        eos_token_id=eos)
    _same(_stitch(completed, pending, outs), reference)


def test_drain_raises_exports_and_engine_reusable(tcfg, params, workload,
                                                  reference):
    prompts, budgets = workload
    eng = _engine(tcfg, params)
    beats = [0]

    def beat():
        beats[0] += 1
        if beats[0] == 4:
            eng.request_drain()
    eng.heartbeat_fn = beat
    with pytest.raises(EngineDrained):
        eng.generate(prompts, max_new_tokens=budgets)
    # the latch is read at the top of each round (a beat inside a burst
    # asks; the next round stops)
    assert beats[0] >= 4
    completed, pending = eng.export_pending_requests()
    assert len(completed) + len(pending) == len(prompts)
    assert eng.state.free_sequence_slots == SM["max_tracked_sequences"]
    with pytest.raises(EngineDrained):          # latched
        eng.generate(prompts[:1], max_new_tokens=2)
    eng.clear_drain()
    outs = eng.generate([p["prompt"] for p in pending],
                        max_new_tokens=[p["max_new_tokens"] for p in pending])
    _same(_stitch(completed, pending, outs), reference)


def test_clean_generate_exports_nothing_and_shares_registry(tcfg, params,
                                                            workload):
    prompts, _ = workload
    reg = MetricRegistry()
    engs = [InferenceEngineV2(tcfg, config={
        "dtype": "fp32", "state_manager": SM,
        "telemetry": {"replica": name}}, params=params, device="cpu",
        telemetry_registry=reg) for name in ("a", "b")]
    beats = [0]
    for i, eng in enumerate(engs):
        eng.heartbeat_fn = lambda: beats.__setitem__(0, beats[0] + 1)
        eng.generate(prompts[:2 + i], max_new_tokens=20)
        assert eng.export_pending_requests() == ({}, [])
        assert eng.telemetry.registry is reg
    # a beat each round and each step of a fused burst (a host loop)
    assert engs[0].dispatches["burst"] > 0
    assert beats[0] > sum(sum(e.dispatches.values()) for e in engs)
    m = reg._metrics["serving_requests_total"]
    assert {lb["replica"]: v for lb, v in m.samples()} == {"a": 2.0, "b": 3.0}


# ----------------------------------------------------------- the fleet

def test_unified_fleet_equals_jax(tcfg, params, workload, reference):
    prompts, budgets = workload
    with make_fleet(tcfg, params, {"num_replicas": 2}) as fleet:
        outs = fleet.serve(prompts, max_new_tokens=budgets, max_wall_s=120)
        _same(outs, reference)
        assert sorted(r["index"] for r in fleet.request_log) == \
            list(range(len(prompts)))
        m = fleet.registry._metrics["serving_requests_total"]
        assert {s[0]["replica"] for s in m.samples()} == {"r0", "r1"}
        assert sum(v for _, v in m.samples()) == len(prompts)
        health = fleet.health()
        assert {n: h["state"] for n, h in health.items()} == \
            {"r0": "healthy", "r1": "healthy"}
        g = fleet.registry._metrics["fleet_replica_state"]
        assert g.value(replica="r0", state="healthy") == 1.0


@pytest.mark.parametrize("respawn", [False, True],
                         ids=["no_respawn", "respawn"])
def test_death_mid_decode(tcfg, params, workload, reference, respawn):
    """One replica dies at a scheduler round; its requests migrate with
    their host-known prefixes; with respawn on, a fresh incarnation takes
    its place.  Every request completes exactly once, token-exact."""
    prompts, budgets = workload
    faults.inject("replica.mid_decode", "exc", after=3)
    with make_fleet(tcfg, params, {"num_replicas": 2, "respawn": respawn,
                                   "max_respawns": 1}) as fleet:
        outs = fleet.serve(prompts, max_new_tokens=budgets, max_wall_s=120)
        _same(outs, reference)
        reg = fleet.registry._metrics
        assert faults.fired("replica.mid_decode") == 1
        assert _deaths(fleet) == {"replica_death": 1.0}
        assert reg["requests_migrated_total"].value() > 0
        assert len(fleet.request_log) == len(prompts)
        states = sorted(r.state for r in fleet.replicas.values())
        if respawn:
            assert states == ["healthy", "healthy"]
            assert reg["fleet_respawns_total"].value() == 1.0
            assert reg["fleet_recovery_ms"].count() == 1
        else:
            assert states == ["dead", "healthy"]


def test_drain_replica_migrates_and_respawns(tcfg, params, workload,
                                             reference):
    """The workload twice over (greedy fp32 tokens do not depend on the
    batch, so the oracle's tokens twice over), 8 requests a replica on 4
    slots: r0 is drained at its second round, mid-serve."""
    prompts, budgets = workload
    with make_fleet(tcfg, params, {"num_replicas": 2}) as fleet:
        old = fleet.replicas["r0"].engine
        _beat_hook(fleet.replicas["r0"], 2,
                   lambda: fleet.drain_replica("r0"))
        outs = fleet.serve(prompts * 2, max_new_tokens=budgets * 2,
                           max_wall_s=120)
        _same(outs, reference * 2)
        reg = fleet.registry._metrics
        assert _deaths(fleet) == {"drain": 1.0}
        assert reg["router_retries_total"].value(reason="drain") == 0.0
        assert reg["requests_migrated_total"].value() > 0
        assert fleet.replicas["r0"].state == "healthy"
        assert fleet.replicas["r0"].engine is not old
        assert fleet.replicas["r0"].incarnation == 3    # retire, respawn


def test_poison_request_fails_request_not_replica(tcfg, params, workload,
                                                  reference):
    prompts, budgets = workload
    with make_fleet(tcfg, params, {"num_replicas": 2}) as fleet:
        outs = fleet.serve(list(prompts) + [np.zeros(10, np.int32)],
                           max_new_tokens=list(budgets) + [SEQ],
                           raise_on_failure=False, max_wall_s=120)
        err = fleet.last_failures[len(prompts)]
        assert isinstance(err, RequestFailed)
        assert err.reason == "invalid_request" and "max_seq_len" in str(err)
        assert outs[len(prompts)] is None
        assert _deaths(fleet) == {}
        assert all(r.state == "healthy" for r in fleet.replicas.values())
        _same(outs[:len(prompts)], reference)


def test_retry_exhaustion_is_typed(tcfg, params, workload):
    prompts, _ = workload
    faults.inject("router.dispatch", "exc", count=99)
    with make_fleet(tcfg, params, {
            "num_replicas": 1, "router": {"max_retries": 2,
                                          "backoff_base_s": 0.001,
                                          "backoff_max_s": 0.005}}) as fleet:
        t0 = time.monotonic()
        with pytest.raises(RequestFailed) as ei:
            fleet.serve(prompts[:1], max_new_tokens=4, max_wall_s=30)
        assert time.monotonic() - t0 < 10
        assert (ei.value.reason, ei.value.attempts, ei.value.index) == \
            ("dispatch_error", 3, 0)
        assert fleet.registry._metrics["router_retries_total"].value(
            reason="dispatch_error") == 2.0


def test_admission_fault_fails_open(tcfg, params, workload, reference):
    prompts, budgets = workload
    faults.inject("admission.decide", "exc", count=3)
    with make_fleet(tcfg, params, {"num_replicas": 1}) as fleet:
        _same(fleet.serve(prompts, max_new_tokens=budgets, max_wall_s=120),
              reference)
    assert faults.fired("admission.decide") == 3


def test_open_loop_arrivals(tcfg, params, workload, reference):
    prompts, budgets = workload
    arrivals = np.linspace(0.0, 0.2, len(prompts))
    with make_fleet(tcfg, params, {"num_replicas": 2}) as fleet:
        outs = fleet.serve(prompts, max_new_tokens=budgets,
                           arrival_times=arrivals, max_wall_s=120)
        _same(outs, reference)
        for rec in fleet.request_log:
            assert rec["t_done"] >= rec["t_arrival"]
        t0 = min(r["t_arrival"] for r in fleet.request_log)
        assert max(r["t_arrival"] for r in fleet.request_log) - t0 == \
            pytest.approx(0.2)


class _Notice:
    """A preemption handler as the fleet sees one (duck-typed: ``install``,
    ``set_notice_callback``, ``.requested``)."""

    def __init__(self):
        self.requested = False
        self.installed = False
        self._cb = None

    def install(self):
        self.installed = True

    def set_notice_callback(self, cb):
        self._cb = cb

    def request(self, reason="manual"):
        self.requested = True
        self._cb(reason)


def test_preemption_notice_drains_fleet(tcfg, params, workload, reference):
    """A notice mid-serve drains every replica; ``FleetDrained`` carries
    the completed outputs and the migration-folded pending requests, and a
    successor that serves those finishes token-exact."""
    prompts, budgets = workload
    prompts, budgets, reference = prompts * 2, budgets * 2, reference * 2
    notice = _Notice()
    with make_fleet(tcfg, params, {"num_replicas": 2},
                    preemption_handler=notice) as fleet:
        assert notice.installed
        _beat_hook(fleet.replicas["r1"], 2, notice.request)
        with pytest.raises(FleetDrained) as ei:
            fleet.serve(prompts, max_new_tokens=budgets, max_wall_s=120)
        assert all(r.state == "dead" for r in fleet.replicas.values())
    drained = ei.value
    assert set(drained.completed) | {r.index for r in drained.pending} == \
        set(range(len(prompts)))
    assert drained.pending
    for i, out in drained.completed.items():
        np.testing.assert_array_equal(out, reference[i])
    succ = _engine(tcfg, params).generate(
        [r.prompt for r in drained.pending],
        max_new_tokens=[r.remaining for r in drained.pending])
    for r, out in zip(drained.pending, succ):
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(r.generated, np.int32), out]),
            reference[r.index])


# ------------------------------------------------- disaggregated serving

def test_disaggregated_equals_unified_with_handoffs(tcfg, params, workload,
                                                    reference):
    prompts, budgets = workload
    with make_fleet(tcfg, params, DISAGG, sm={"prefix_cache": True}) \
            as fleet:
        roles = {r.name: r.role for r in fleet.replicas.values()}
        assert roles == {"r0": "prefill", "r1": "decode"}
        free = {n: r.engine.state.allocator.free_blocks
                for n, r in fleet.replicas.items()}
        outs = fleet.serve(prompts, max_new_tokens=budgets, max_wall_s=120)
        _same(outs, reference)
        reg = fleet.registry._metrics
        assert reg["fleet_handoffs_total"].value(outcome="ok") == \
            sum(1 for b in budgets if b > 1)
        eng = fleet.replicas["r0"].engine
        pinned = reg["kv_handoff_bytes_total"].value() / eng.kv_block_bytes()
        assert pinned == sum(len(p) // SM["kv_block_size"] for p in prompts)
        tok = reg["serving_tokens_total"]
        assert tok.value(phase="prefill", replica="r0") == \
            sum(len(p) for p in prompts)
        assert tok.value(phase="decode", replica="r0") == 0
        assert all(r["t_first"] is not None and r["t_first"] <= r["t_done"]
                   for r in fleet.request_log)
        # the prompt blocks stay cached in the radix caches; nothing else
        # is held, and with them evicted every pool is whole again
        _assert_no_leaks(fleet)
        for rep in fleet.replicas.values():
            rep.engine.state.radix.evict(10 ** 6)
        _assert_no_leaks(fleet, free)


def test_mid_transfer_abort_releases_pins(tcfg, params, workload,
                                          reference):
    prompts, budgets = workload
    with make_fleet(tcfg, params, DISAGG, sm={"prefix_cache": True}) \
            as fleet:
        faults.inject("handoff.mid_transfer", "exc", count=3)
        outs = fleet.serve(prompts, max_new_tokens=budgets, max_wall_s=120)
        assert faults.fired("handoff.mid_transfer") == 3
        _same(outs, reference)
        reg = fleet.registry._metrics
        assert reg["fleet_handoffs_total"].value(outcome="aborted") == 3
        assert reg["fleet_handoffs_total"].value(outcome="ok") == \
            sum(1 for b in budgets if b > 1) - 3
        assert reg["requests_migrated_total"].value() >= 3
        assert sum(v for _, v in reg["router_retries_total"].samples()) == 0
        _assert_no_leaks(fleet)


def test_role_flip_under_skew_loses_nothing(tcfg, params, workload,
                                            reference):
    """Synthetic TTFT/TPOT skew makes the autoscaler flip the idle decode
    replica to prefill mid-serve; every request completes exactly once,
    token-exact, and no death is booked."""
    prompts, budgets = workload
    with make_fleet(tcfg, params, {
            **DISAGG, "num_replicas": 3,
            "autoscale": {"enabled": True, "interval_s": 0.0,
                          "cooldown_s": 1e9, "min_requests": 1,
                          "min_decode": 1, "skew_to_prefill": 50.0}},
            sm={"prefix_cache": True}) as fleet:
        reg = fleet.registry
        for _ in range(64):
            reg.histogram("serving_ttft_ms").observe(1e4, replica="synth")
            reg.histogram("serving_tpot_ms").observe(1.0, replica="synth")
        outs = fleet.serve(prompts, max_new_tokens=budgets, max_wall_s=120)
        _same(outs, reference)
        assert reg._metrics["pool_rebalances_total"].value(
            direction="to_prefill") == 1.0
        assert sorted(r.role for r in fleet.replicas.values()) == \
            ["decode", "prefill", "prefill"]
        assert sorted(r["index"] for r in fleet.request_log) == \
            list(range(len(prompts)))
        assert _deaths(fleet) == {}
        # both roles have served: every incarnation, the flipped one too,
        # ends warm
        assert fleet._served_roles == {"prefill", "decode"}
        assert all(r.warmed for r in fleet.replicas.values())
        _assert_no_leaks(fleet)


# ------------------------------------------------ the warm-up gate (C.2)

class _Fake:
    """A minimal engine the fleet can drive."""

    def __init__(self):
        self.heartbeat_fn = None

    def clear_drain(self):
        pass

    def request_drain(self):
        pass

    def export_pending_requests(self):
        return {}, []

    def generate(self, prompts, max_new_tokens):
        self.heartbeat_fn()
        return [np.arange(int(m), dtype=np.int32) for m in max_new_tokens]


@pytest.mark.parametrize("share", [True, False])
def test_respawn_is_warm_when_its_kernels_are_loaded(share):
    """The port has no compiled-step cache: a respawn runs under the
    steady-state deadline once an incarnation of its role has completed a
    generate in this process (every kernel that generate ran stays
    loaded), and on the warm-up budget otherwise."""
    fleet = ServingFleet(engine_factory=lambda name: _Fake(),
                         config={"num_replicas": 1, "respawn": False,
                                 "share_compile_cache": share},
                         registry=MetricRegistry())
    try:
        rep = fleet.replicas["r0"]
        assert not rep.warmed                   # a first incarnation
        fleet._spawn(rep, is_respawn=True)
        assert not rep.warmed                   # nothing has served yet
        out = fleet.serve([np.zeros(3, np.int32)], max_new_tokens=2,
                          max_wall_s=30)
        assert len(out[0]) == 2 and rep.warmed
        fleet._spawn(rep, is_respawn=True)
        assert rep.warmed == share
        rep.role = "decode"                     # a role that has not served
        fleet._spawn(rep, is_respawn=True)
        assert not rep.warmed
    finally:
        fleet.shutdown()


class _Hang(_Fake):
    """Serves its first call; a later call stalls without a beat until it
    is asked to drain (a wedged replica)."""

    def __init__(self):
        super().__init__()
        self.drained = threading.Event()
        self.calls = 0

    def request_drain(self):
        self.drained.set()

    def clear_drain(self):
        self.drained.clear()

    def generate(self, prompts, max_new_tokens):
        self.calls += 1
        if self.calls == 1:
            return super().generate(prompts, max_new_tokens)
        if not self.drained.wait(30.0):
            raise RuntimeError("never asked to drain")
        raise EngineDrained("drained")


def test_heartbeat_death_stops_the_zombie_worker():
    """A warm replica that stops beating is booked dead on the
    steady-state deadline, and its worker, still inside generate, is asked
    to drain, so that the thread ends and drops its engine."""
    eng = _Hang()
    fleet = ServingFleet(engine_factory=lambda name: eng,
                         config={"num_replicas": 1, "respawn": False,
                                 "heartbeat_deadline_s": 0.2,
                                 "warmup_deadline_s": 30.0},
                         registry=MetricRegistry())
    try:
        fleet.serve([np.zeros(3, np.int32)], max_new_tokens=2, max_wall_s=30)
        assert fleet.replicas["r0"].warmed
        out = fleet.serve([np.zeros(3, np.int32)], max_new_tokens=2,
                          raise_on_failure=False, max_wall_s=30)
        assert out == [None]
        assert fleet.last_failures[0].reason == "no_healthy_replicas"
        assert _deaths(fleet) == {"heartbeat_timeout": 1.0}
        assert eng.drained.is_set()
    finally:
        fleet.shutdown()
    assert not any(t.is_alive() for t in fleet._workers)


def test_fleet_config_is_a_dataclass_with_the_jax_defaults():
    from deepspeed_tpu.serving import FleetConfig as JaxFleetConfig
    from deepspeed_tpu_torch.serving import FleetConfig
    want = JaxFleetConfig.parse({"router": {"seed": 3},
                                 "slo": {"slos": [{"name": "x"}]}})
    got = FleetConfig.parse({"router": {"seed": 3},
                             "slo": {"slos": [{"name": "x"}]}})
    assert dataclasses.is_dataclass(got)
    assert dataclasses.asdict(got) == want.model_dump()
    with pytest.raises(ValueError, match="prefill_replicas"):
        ServingFleet(engine_factory=lambda name: _Fake(),
                     config={"num_replicas": 2, "prefill_replicas": 2,
                             "disaggregated": True})
    with pytest.raises(ValueError, match="per_s"):
        FleetConfig.parse({"admission": {"low_kv_failures_per_tick": 1}})
