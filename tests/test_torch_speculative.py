"""PyTorch port, speculative decoding: the torch engine with a draft model
held to the JAX engine on the same numpy weights, in fp32 on the CPU (the
JAX package's tiny config: 2 layers, hidden 32, vocab 97).

(a) greedy speculative ``generate`` is token for token the JAX engine's and
    the port's own non-speculative output, for an identical draft and for a
    random draft, with EOS and mixed budgets; ``spec_summary()`` counters
    equal JAX's;
(b) ``_verify_core`` logits and the KV it writes match JAX's at 1e-5;
(c) ``spec_accept`` preserves the target distribution (the statistic of
    the JAX suite's Monte Carlo test);
(d) the sampled path at temperature -> 0, the split-profile mode and the
    per-request dispatch mode give the fused greedy tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import model as jmodel
from deepspeed_tpu.models import GPTConfig as JaxConfig
from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
from deepspeed_tpu_torch import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import model as tmodel
from deepspeed_tpu_torch.models.gpt import init_params

torch.set_num_threads(1)

# outer_steps 1: the JAX engine compiles one program per power-of-two
# round count, so the runs held to it take one (the default 8, with its
# rounds fused into one dispatch, is run by the port-only cases at the end)
V2CFG = {"dtype": "fp32",
         "state_manager": {"max_tracked_sequences": 4,
                           "max_ragged_batch_size": 64,
                           "kv_block_size": 8, "max_q_per_seq": 16},
         "speculative": {"outer_steps": 1}}
COUNTERS = ("outer_steps", "proposed", "accepted", "emitted",
            "spec_dispatches")


def _numpy_tree(tcfg, seed):
    """Seeded numpy weights in the GPTLogits tree layout (the port's
    ``init_params`` names and shapes, which the weight bridge holds equal to
    the flax tree's): norm scales 1, everything else N(0, 0.3^2), wide
    enough that greedy tokens sit far from argmax ties."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else np.ones(tuple(v.shape), np.float32) if k == "scale"
                else (rng.standard_normal(tuple(v.shape)) * 0.3
                      ).astype(np.float32)
                for k, v in t.items()}
    return walk(init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))


@pytest.fixture(scope="module")
def jcfg():
    return JaxConfig.tiny(vocab_size=97, max_seq_len=64)


@pytest.fixture(scope="module")
def tcfg():
    return dataclasses.replace(GPTConfig.tiny(vocab_size=97, max_seq_len=64),
                               dtype=torch.float32)


@pytest.fixture(scope="module")
def trees(tcfg):
    """(target, random draft) numpy trees of the same config."""
    return _numpy_tree(tcfg, 0), _numpy_tree(tcfg, 1)


@pytest.fixture(scope="module")
def jeng(jcfg, trees):
    """The one JAX engine of this file: the target with an identical
    draft.  A test that wants another draft swaps ``draft_params`` (the
    compiled programs take it as an argument) and puts it back."""
    return JaxEngine(jcfg, config=V2CFG, params=trees[0], draft_model=jcfg,
                     draft_params=trees[0])


def _tp(tree, tcfg):
    return params_from_numpy(tree, tcfg, "cpu", torch.float32)


def _port(tcfg, trees, draft=None, config=V2CFG):
    params = _tp(trees[0], tcfg)
    kw = {}
    if draft == "same":
        kw = dict(draft_model=tcfg, draft_params=params)
    elif draft == "random":
        kw = dict(draft_model=tcfg, draft_params=_tp(trees[1], tcfg))
    return InferenceEngineV2(tcfg, config=config, params=params,
                             device="cpu", **kw)


def _prompts(seed, n=3, base=10, step=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, (base + step * i,)).astype(np.int32)
            for i in range(n)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _jax_spec_delta(jeng, fn):
    """Run ``fn`` on the JAX engine; its spec_summary counters' increase."""
    before = jeng.telemetry.spec_summary()
    out = fn()
    after = jeng.telemetry.spec_summary()
    return out, {k: after[k] - before[k] for k in COUNTERS}


@pytest.mark.parametrize("draft", ["same", "random"])
def test_greedy_spec_equals_jax_and_plain(jeng, tcfg, trees, draft):
    prompts = _prompts(0)
    if draft == "random":
        jeng.draft_params = jax.tree_util.tree_map(jnp.asarray, trees[1])
    try:
        want, jstats = _jax_spec_delta(
            jeng, lambda: jeng.generate(prompts, max_new_tokens=18))
    finally:
        jeng.draft_params = jax.tree_util.tree_map(jnp.asarray, trees[0])
    spec = _port(tcfg, trees, draft)
    got = spec.generate(prompts, max_new_tokens=18)
    _same(got, want)
    _same(_port(tcfg, trees).generate(prompts, max_new_tokens=18), want)
    st = spec.telemetry.spec_summary()
    assert {k: st[k] for k in COUNTERS} == jstats
    assert st["outer_steps"] > 0 and spec.dispatches["burst"] == 0
    assert st["emitted"] == st["accepted"] + st["outer_steps"]
    if draft == "same":
        assert st["accept_ratio"] > 0.8, st
    else:
        assert st["accept_ratio"] < 0.5, st
    # the pool is clean after the serve (both pools share one table)
    assert spec.query()["free_kv_blocks"] == spec.state.allocator.num_blocks


def test_eos_and_mixed_budgets(jeng, tcfg, trees):
    prompts = _prompts(1, base=11, step=1)
    budgets = [7, 13, 18]
    plain = _port(tcfg, trees)
    eos = int(plain.generate(prompts, max_new_tokens=budgets)[2][4])
    want, jstats = _jax_spec_delta(jeng, lambda: jeng.generate(
        prompts, max_new_tokens=budgets, eos_token_id=eos))
    spec = _port(tcfg, trees, "same")
    got = spec.generate(prompts, max_new_tokens=budgets, eos_token_id=eos)
    _same(got, want)
    _same(plain.generate(prompts, max_new_tokens=budgets, eos_token_id=eos),
          want)
    assert got[2][-1] == eos and len(got[2]) <= 5
    st = spec.telemetry.spec_summary()
    assert {k: st[k] for k in COUNTERS} == jstats


def test_verify_core_matches_jax(jcfg, tcfg, trees):
    """One verify forward over G = 5 tokens a slot at ragged pos0 (slot 2
    inactive), on pools holding the same earlier context: logits at 1e-5,
    and the pages it wrote."""
    L, NB, bs, nkv, hd = 2, 12, 8, jcfg.kv_heads, jcfg.head_dim
    rng = np.random.default_rng(3)
    k0 = rng.standard_normal((L, NB, nkv, bs, hd)).astype(np.float32)
    v0 = rng.standard_normal((L, NB, nkv, bs, hd)).astype(np.float32)
    bt = rng.permutation(NB)[:12].reshape(4, 3).astype(np.int32)
    pos0 = np.array([3, 9, 0, 13], np.int32)
    active = np.array([True, True, False, True])
    toks = rng.integers(0, 97, (4, 5)).astype(np.int32)

    km = jmodel.kv_major_layout(jcfg)
    swap = (lambda a: np.swapaxes(a, -1, -2)) if km else (lambda a: a)
    jk, jv = (jnp.asarray(swap(a).reshape((L * NB,) + swap(a).shape[2:]))
              for a in (k0, v0))
    fn = jax.jit(functools.partial(jmodel._verify_core, cfg=jcfg,
                                   block_size=bs))
    want, jk, jv, _, _ = fn(jax.tree_util.tree_map(jnp.asarray, trees[0]),
                            jk, jv, None, None, jnp.asarray(toks),
                            jnp.asarray(active), jnp.asarray(pos0),
                            jnp.asarray(bt))

    cache = tmodel.PagedKVCache.create(tcfg, NB, bs, torch.float32, "cpu")
    cache.k_flat[:L * NB] = torch.from_numpy(k0.reshape(L * NB, nkv, bs, hd))
    cache.v_flat[:L * NB] = torch.from_numpy(v0.reshape(L * NB, nkv, bs, hd))
    with torch.no_grad():
        got = tmodel._verify_core(
            _tp(trees[0], tcfg), cache, torch.from_numpy(toks),
            torch.from_numpy(active), torch.from_numpy(pos0),
            torch.from_numpy(bt), tcfg, bs)
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                               atol=1e-5, rtol=1e-5)
    jk = np.asarray(jk).reshape((L, NB) + np.asarray(jk).shape[1:])
    np.testing.assert_allclose(cache.k.numpy(), swap(jk), atol=1e-5)


def test_spec_accept_preserves_target_distribution():
    """Monte Carlo over the accept math: 200k trials of fixed q / p; the
    first emitted token follows softmax(p_0), the second (where reached)
    softmax(p_1)."""
    V, gamma, N = 6, 3, 200_000
    rng = np.random.default_rng(0)
    q_log = torch.from_numpy(rng.standard_normal((1, gamma, V))
                             .astype(np.float32))
    p_log = torch.from_numpy(rng.standard_normal((1, gamma + 1, V))
                             .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    qN, pN = q_log.expand(N, gamma, V), p_log.expand(N, gamma + 1, V)
    d = torch.multinomial(torch.softmax(qN, -1).reshape(-1, V), 1,
                          generator=gen).reshape(N, gamma).to(torch.int32)
    emit, counts = tmodel.spec_accept(gen, qN, pN, d)
    emit, counts = emit.numpy(), counts.numpy()
    assert counts.min() >= 1 and counts.max() <= gamma + 1
    p0 = torch.softmax(p_log[0, 0], -1).numpy()
    np.testing.assert_allclose(np.bincount(emit[:, 0], minlength=V) / N, p0,
                               atol=0.01)
    m = counts >= 2
    p1 = torch.softmax(p_log[0, 1], -1).numpy()
    np.testing.assert_allclose(np.bincount(emit[m, 1], minlength=V) / m.sum(),
                               p1, atol=0.02)


@pytest.mark.parametrize("mode", ["sampled_t0", "profile", "per_request"])
def test_other_spec_modes_give_greedy_tokens(tcfg, trees, mode):
    prompts = _prompts(2)
    want = _port(tcfg, trees).generate(prompts, max_new_tokens=14)
    kw = {}
    config = V2CFG
    if mode == "sampled_t0":
        kw = dict(do_sample=True, temperature=1e-5)
    else:
        key = "profile" if mode == "profile" else "batch_across_requests"
        config = {**V2CFG, "speculative": {key: mode == "profile",
                                           "outer_steps": 8}}
    spec = _port(tcfg, trees, "random", config)
    _same(spec.generate(prompts, max_new_tokens=14, **kw), want)
    st = spec.telemetry.spec_summary()
    assert st["outer_steps"] > 0
    if mode == "profile":
        assert st["draft_dispatches"] == st["verify_dispatches"] > 0
        assert st["spec_dispatches"] == 0 and st["burst_ms"] == 0
    if mode == "per_request":
        assert st["spec_dispatches"] >= 3
