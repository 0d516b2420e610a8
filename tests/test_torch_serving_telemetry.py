"""PyTorch port, serving telemetry: the torch engine's ``self.telemetry``
held to the JAX engine's on the same numpy weights and the same calls, in
fp32 on the CPU (the JAX package's tiny config, vocab 97).

(a) after ``put`` / ``can_schedule`` / ``query`` and one ``generate`` with
    chunked prompts, bursts and recompute preemption, every counter of the
    snapshot (name, labels, value) equals JAX's, the gauge and histogram
    names are JAX's, and so are the per-request log and the span names;
(b) ``generate(stream=..., trace_ctx=...)`` runs (the stream fence is a
    no-op on the CPU) and carries the caller's trace ids on the request
    spans; ``export`` writes the snapshot, the Prometheus text and the
    trace; a disabled block records nothing.
"""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import GPTConfig as JaxConfig
from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
from deepspeed_tpu_torch import params_from_numpy
from deepspeed_tpu_torch.models.gpt import init_params
from deepspeed_tpu_torch.telemetry import tracecontext

torch.set_num_threads(1)

# 4 blocks of 16 for 3 prompts of 18..26 tokens + 20 new forces recompute
# preemption (of decoding and of mid-prefill victims); max_q_per_seq 8
# chunks every prompt
CONFIG = {"dtype": "fp32",
          "state_manager": {"max_tracked_sequences": 3,
                            "max_ragged_batch_size": 64, "kv_block_size": 16,
                            "max_q_per_seq": 8, "num_kv_blocks": 4}}


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


def _port(tcfg, tree, config=CONFIG):
    return InferenceEngineV2(tcfg, config=config, device="cpu",
                             params=params_from_numpy(tree, tcfg, "cpu",
                                                      torch.float32))


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 97, (18 + 4 * i,)).astype(np.int32)
            for i in range(3)]


def _drive(eng):
    """The calls both engines get: a put, a can_schedule that fails, a
    query, then one generate."""
    eng.put([5], [np.arange(8, dtype=np.int32)])
    eng.flush([5])
    assert not eng.can_schedule([1, 2], [40, 40])
    eng.query()
    return eng.generate(_prompts(), max_new_tokens=20)


def _counters(snap):
    return {(name, tuple(sorted(s["labels"].items()))): s["value"]
            for name, m in snap["counters"].items() for s in m["samples"]}


def _span_names(eng):
    return collections.Counter(e["name"] for e in eng.telemetry.tracer.events
                               if e.get("ph") == "X")


@pytest.fixture(scope="module")
def driven(tcfg, tree):
    jeng = JaxEngine(JaxConfig.tiny(vocab_size=97, max_seq_len=64),
                     config=CONFIG, params=tree)
    teng = _port(tcfg, tree)
    return jeng, teng, _drive(jeng), _drive(teng)


def test_counters_equal_jax(driven):
    jeng, teng, jout, tout = driven
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert teng.preempt_stats == jeng.preempt_stats
    assert min(teng.preempt_stats.values()) > 0
    js = jeng.telemetry.exporter.snapshot()
    ts = teng.telemetry.exporter.snapshot()
    assert _counters(ts) == _counters(js)
    for kind in ("gauges", "histograms"):
        assert sorted(ts[kind]) == sorted(js[kind]), kind
    # every histogram holds as many observations as JAX's (the times differ)
    for name, m in js["histograms"].items():
        assert ([s["count"] for s in ts["histograms"][name]["samples"]]
                == [s["count"] for s in m["samples"]]), name
    keys = ("uid", "outcome", "prompt_tokens", "generated_tokens", "preempts")
    assert ([{k: r[k] for k in keys} for r in teng.telemetry.request_log]
            == [{k: r[k] for k in keys} for r in jeng.telemetry.request_log])
    assert _span_names(teng) == _span_names(jeng)
    names = set(_counters(ts))
    for want in ("serving_dispatches_total", "kv_alloc_failures_total",
                 "serving_preemptions_total", "prefill_chunks_total"):
        assert any(n == want for n, _ in names), want


def test_stream_trace_ctx_and_export(tcfg, tree, tmp_path):
    eng = _port(tcfg, tree, {**CONFIG, "telemetry": {"stream_sync": True}})
    ctx = [tracecontext.new_trace(), None, tracecontext.new_trace()]
    out = eng.generate(_prompts(), max_new_tokens=6, stream=True,
                       trace_ctx=ctx)
    assert [len(o) for o in out] == [6, 6, 6]
    traced = {e["args"]["uid"]: e["args"].get("trace")
              for e in eng.telemetry.tracer.events
              if e.get("cat") == "request"}
    assert traced[-1] == ctx[0].trace_id and traced[-3] == ctx[2].trace_id
    assert traced[-2] is not None       # a local context for the None entry
    snap = eng.telemetry.export(str(tmp_path))
    assert snap["counters"]["serving_requests_total"]["samples"][0][
        "value"] == 3
    for f in ("snapshot.json", "metrics.prom", "trace.json"):
        assert os.path.getsize(tmp_path / f) > 0
    with open(tmp_path / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]
    with pytest.raises(ValueError, match="trace_ctx"):
        eng.generate(_prompts(), max_new_tokens=2, trace_ctx=ctx[:1])


def test_disabled_block_records_nothing(tcfg, tree):
    eng = _port(tcfg, tree, {**CONFIG, "telemetry": {"enabled": False}})
    out = eng.generate(_prompts()[:1], max_new_tokens=4)
    assert len(out[0]) == 4
    assert eng.telemetry.spec_summary() == {}
    assert not eng.telemetry.tracer.events
    assert eng.telemetry.registry.snapshot()["counters"] == {}
