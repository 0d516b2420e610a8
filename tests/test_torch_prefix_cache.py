"""PyTorch port, radix prefix cache and SLA scheduling: the torch engine
held to the JAX engine on the same numpy weights and the same call history,
in fp32 on the CPU (the JAX package's tiny config, vocab 97).

(a) with ``state_manager.prefix_cache`` the tokens equal cache-off and
    JAX's, and ``prefix_cached_tokens`` / ``prefix_block_handles`` and the
    hit counters equal JAX's after every call; a ``put`` that matches a
    cached prefix gives the cache-off logits;
(b) cache on stays token-exact under eviction pressure and preemption;
(c) under one fixed ``now_fn`` the SLA scheduler takes JAX's preemptions
    and admissions and gives JAX's tokens, which equal uncontended runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import GPTConfig as JaxConfig
from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
from deepspeed_tpu_torch import params_from_numpy
from deepspeed_tpu_torch.models.gpt import init_params

torch.set_num_threads(1)

SM = {"max_tracked_sequences": 2, "max_ragged_batch_size": 64,
      "kv_block_size": 8, "max_q_per_seq": 16}
SLA = {"sla_classes": {"batch": {"priority": 0},
                       "gold": {"priority": 10, "ttft_slo_ms": 1.0}}}
CONFIG = {"dtype": "fp32", "state_manager": dict(SM, prefix_cache=True),
          "scheduler": SLA}


def _numpy_tree(tcfg, seed):
    """Seeded numpy weights in the GPTLogits tree layout (the port's
    ``init_params`` names and shapes): norm scales 1, everything else
    N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else np.ones(tuple(v.shape), np.float32) if k == "scale"
                else (rng.standard_normal(tuple(v.shape)) * 0.3
                      ).astype(np.float32)
                for k, v in t.items()}
    return walk(init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))


@pytest.fixture(scope="module")
def tcfg():
    return dataclasses.replace(GPTConfig.tiny(vocab_size=97, max_seq_len=64),
                               dtype=torch.float32)


@pytest.fixture(scope="module")
def tree(tcfg):
    return _numpy_tree(tcfg, 0)


@pytest.fixture(scope="module")
def pair(tcfg, tree):
    """The file's one JAX engine and the port's engine with the same config
    (cache on, SLA classes, 2 slots).  Every test makes the same calls on
    both, so their caches hold the same blocks throughout."""
    jeng = JaxEngine(JaxConfig.tiny(vocab_size=97, max_seq_len=64),
                     config=CONFIG, params=tree)
    return jeng, _port(tcfg, tree, CONFIG)


def _port(tcfg, tree, config):
    return InferenceEngineV2(tcfg, config=config, device="cpu",
                             params=params_from_numpy(tree, tcfg, "cpu",
                                                      torch.float32))


def _plain(tcfg, tree, **sm):
    return _port(tcfg, tree, {"dtype": "fp32",
                              "state_manager": dict(SM, **sm)})


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _shared_prompts(seed, shared_len=16, n=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 97, (shared_len,)).astype(np.int32)
    return [np.concatenate([shared,
                            rng.integers(0, 97, (4 + i,)).astype(np.int32)])
            for i in range(n)]


def _value(eng, name, **labels):
    return eng.telemetry.value(name, **labels)


def _same_radix(jeng, teng, prompts):
    for p in prompts:
        assert teng.prefix_cached_tokens(p) == jeng.prefix_cached_tokens(p)
        tb, tm = teng.prefix_block_handles(p)
        jb, jm = jeng.prefix_block_handles(p)
        assert (list(tb), tm) == (list(jb), jm)
    assert teng.query()["cached_kv_blocks"] == jeng.query()["cached_kv_blocks"]
    for name in ("kv_prefix_lookups_total", "kv_prefix_hit_tokens_total"):
        assert _value(teng, name) == _value(jeng, name), name
    teng.state.radix.check_invariants()


def test_cache_on_equals_off_and_jax(pair, tcfg, tree):
    jeng, teng = pair
    prompts = _shared_prompts(0)
    want = _plain(tcfg, tree).generate(prompts, max_new_tokens=8)
    for call in range(2):
        hits = _value(teng, "kv_prefix_hit_tokens_total")
        _same(jeng.generate(prompts, max_new_tokens=8), want)
        _same(teng.generate(prompts, max_new_tokens=8), want)
        _same_radix(jeng, teng, prompts)
        if call:
            # the second call serves every request's 16-token prefix from
            # the cache
            assert (_value(teng, "kv_prefix_hit_tokens_total") - hits
                    >= 3 * 16)
            assert teng.prefix_cached_tokens(prompts[0]) >= 16


def test_put_through_a_cached_prefix(tcfg, tree):
    """A one-shot put longer than max_q_per_seq is legal once its prefix is
    cached: the matched blocks are aliased, only the suffix is computed,
    and the logits are the cache-off engine's (which test_torch_serving.py
    holds to JAX's)."""
    ids = np.random.default_rng(1).integers(0, 97, (28,)).astype(np.int32)
    on, off = _plain(tcfg, tree, prefix_cache=True), _plain(tcfg, tree)
    for eng in (on, off):
        eng.put([1], [ids[:16]])
        want = eng.put([1], [ids[16:]])
        eng.flush([1])
    got = on.put([2], [ids])
    assert _value(on, "kv_prefix_hit_tokens_total") == 24
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert on.prefix_block_handles(ids)[1] == 24


def test_sla_preemption_matches_jax(pair, tcfg, tree):
    """Two batch requests fill both slots; a gold request arrives at 0.2 s
    with a 1 ms TTFT SLO and preempts the most recently admitted one.  The
    same fixed clock on both engines: the same preemptions, admissions and
    tokens, which equal the uncontended tokens."""
    jeng, teng = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, (n,)).astype(np.int32) for n in (8, 9, 6)]
    kw = dict(max_new_tokens=[24, 20, 4], arrival_times=[0.0, 0.0, 0.2],
              sla=["batch", "batch", "gold"])
    outs, deltas = [], []
    for eng in (jeng, teng):
        clk = [0.0]

        def now():
            clk[0] += 0.05
            return clk[0]
        before = dict(eng.preempt_stats)
        names = [("serving_sla_preemptions_total", {"sla": "batch"}),
                 ("serving_admissions_total", {"sla": "gold",
                                               "decision": "preempted_for"}),
                 ("serving_admissions_total", {"sla": "gold",
                                               "decision": "admitted"}),
                 ("serving_admissions_total", {"sla": "batch",
                                               "decision": "admitted"})]
        c0 = [_value(eng, n, **lab) for n, lab in names]
        log0 = len(eng.telemetry.request_log)
        outs.append(eng.generate(prompts, now_fn=now, **kw))
        recs = {r["uid"]: r["preempts"]
                for r in eng.telemetry.request_log[log0:]}
        deltas.append(({k: eng.preempt_stats[k] - before[k] for k in before},
                       [_value(eng, n, **lab) - c for (n, lab), c
                        in zip(names, c0)], recs))
    _same(outs[1], outs[0])
    assert deltas[1] == deltas[0]
    (stats, counts, recs) = deltas[1]
    assert counts[0] >= 1 and counts[1] >= 1 and counts[2] == 1
    assert stats["decode_ready"] >= 1 and recs[-3] == 0
    _same(outs[1], _plain(tcfg, tree).generate(
        prompts, max_new_tokens=kw["max_new_tokens"]))
    _same_radix(jeng, teng, prompts)


def test_unknown_sla_class_rejected(pair):
    with pytest.raises(ValueError, match="unknown SLA class"):
        pair[1].generate([np.zeros(6, np.int32)], max_new_tokens=2,
                         sla=["platinum"])


@pytest.mark.parametrize("sm", [{"num_kv_blocks": 7},
                                {"num_kv_blocks": 6, "max_q_per_seq": 8,
                                 "max_tracked_sequences": 4}])
def test_cache_exact_under_eviction_and_preemption(tcfg, tree, sm):
    prompts = _shared_prompts(3, n=3)
    want = _plain(tcfg, tree).generate(prompts, max_new_tokens=12)
    eng = _plain(tcfg, tree, prefix_cache=True, **sm)
    _same(eng.generate(prompts, max_new_tokens=12), want)
    eng.state.radix.check_invariants()
    alloc = eng.state.allocator
    assert alloc.free_blocks + eng.state.radix.node_count == alloc.num_blocks
    assert eng.state.available_blocks == alloc.num_blocks
