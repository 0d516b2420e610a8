"""PyTorch port, multi-tenant LoRA serving: the torch InferenceEngineV2 with
the ``adapters`` block held to the JAX engine on the same numpy weights and
the same numpy adapter weights, in fp32 on the CPU.

Greedy ``generate(adapter_ids=...)`` is token-exact against the JAX engine
for a mixed 8-tenant batch and for each request served alone; for ids 0,
omitted ids and an adapter-less engine (all three equal); under eviction
churn (``slots`` 3); on an oversubscribed pool that forces recompute
preemption, SplitFuse chunking and decode bursts; and for quant 8 + int8
KV + adapters.  After every run no adapter page is pinned, free + resident
blocks cover the pool, the pool's invariants hold, and its hit / miss /
eviction counts equal the JAX pool's.  The typed client errors carry the
JAX engine's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import GPTConfig as JaxConfig
from deepspeed_tpu.models.gpt import GPTLogits
from deepspeed_tpu.parallel.metadata import unbox
from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
from deepspeed_tpu_torch import params_from_numpy
from deepspeed_tpu_torch.serving import random_adapter_weights

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

# the serving tests' llama-style model (GQA g = 2, head_dim 32):
# q_dim 4 x 32, v_dim 2 x 32
MODEL = dict(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
             vocab_size=512, max_seq_len=256)
Q_DIM, V_DIM = 128, 64
ADP = {"enabled": True, "rank": 4, "alpha": 8.0, "slots": 10}
SM = {"max_tracked_sequences": 8, "max_ragged_batch_size": 64,
      "kv_block_size": 8, "max_q_per_seq": 16}
# oversubscribed: 4 slots, 16 blocks of 8 for prompts of 18..33 tokens + 20
# new, with 2-block adapters beside them -> recompute preemption; prompts
# longer than max_q_per_seq 8 -> SplitFuse chunks; the tail fuses bursts
SM_TIGHT = {"max_tracked_sequences": 4, "max_ragged_batch_size": 64,
            "kv_block_size": 8, "max_q_per_seq": 8, "num_kv_blocks": 16}
CONFIGS = {
    "base": {"state_manager": SM},
    "mixed": {"state_manager": SM, "adapters": ADP},
    "churn": {"state_manager": SM, "adapters": dict(ADP, slots=3)},
    "tight": {"state_manager": SM_TIGHT, "adapters": ADP},
    "q8_kv8": {"state_manager": dict(SM_TIGHT, kv_quant="int8"),
               "quant": {"enabled": True, "bits": 8}, "adapters": ADP},
}
N_TENANTS = 8


def _config(name):
    return {"dtype": "fp32", **CONFIGS[name]}


def _tenant(aid):
    """init_scale 0.2: deltas large enough that tenants steer greedy
    tokens (the default 0.02 would not), at the scale the JAX suite's
    tenants have relative to its model (0.5 at hidden 32 ~ 0.25 at hidden
    128).  At 0.5 here the deltas dwarf the base projections and the JAX
    engine's own greedy tokens change with its CPU thread count, so the
    comparison would measure the reference's rounding noise."""
    return random_adapter_weights(MODEL["num_layers"], MODEL["hidden"],
                                  ADP["rank"], Q_DIM, V_DIM, seed=aid,
                                  init_scale=0.2)


@pytest.fixture(scope="module")
def tree():
    cfg = JaxConfig.llama(**MODEL)
    boxed = jax.eval_shape(lambda r: GPTLogits(cfg).init(
        r, jnp.zeros((1, 8), jnp.int32)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, a):
        if path[-1].key == "scale":
            return np.ones(a.shape, np.float32)
        return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, unbox(boxed["params"]))


STEPS = {}       # shared jitted steps of identically configured JAX engines


def _engines(tree, name):
    """A fresh (JAX, torch) engine pair of config ``name`` with the same 8
    tenants registered on both."""
    jeng = JaxEngine(JaxConfig.llama(**MODEL), config=_config(name),
                     params=tree, steps_cache=STEPS)
    tcfg = dataclasses.replace(GPTConfig.llama(**MODEL), dtype=torch.float32)
    teng = InferenceEngineV2(tcfg, config=_config(name), device="cpu",
                             params=params_from_numpy(tree, tcfg, "cpu",
                                                      torch.float32))
    if teng.adapters is not None:
        for aid in range(1, N_TENANTS + 1):
            w = _tenant(aid)
            jeng.register_adapter(aid, w)
            teng.register_adapter(aid, w)
    return jeng, teng


def _workload(n=8, seed=11, lo=4, hi=30):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, MODEL["vocab_size"], int(rng.integers(lo, hi)))
               .astype(np.int32) for _ in range(n)]
    budgets = [int(b) for b in rng.integers(6, 14, size=n)]
    return prompts, budgets


def _check_pool(jeng, teng):
    """No pin left, free + resident == the pool, invariants, and the
    port's pool counters equal the JAX pool's."""
    st = teng.adapters.stats()
    assert st["pinned_blocks"] == 0
    alloc = teng.state.allocator
    assert alloc.free_blocks + st["resident_blocks"] == alloc.num_blocks
    teng.adapters.check_invariants()
    assert st == jeng.adapters.stats()


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")


def test_mixed_batch_and_solo_runs_token_exact(tree):
    """8 tenants in one generate, and each request alone with its adapter:
    token-exact against JAX, and the mixed batch equals the solo runs."""
    jeng, teng = _engines(tree, "mixed")
    prompts, budgets = _workload()
    ids = [1 + i % N_TENANTS for i in range(len(prompts))]
    got = teng.generate(prompts, max_new_tokens=budgets, adapter_ids=ids)
    _same(got, jeng.generate(prompts, max_new_tokens=budgets,
                             adapter_ids=ids))
    _check_pool(jeng, teng)
    assert teng.adapter_resident(ids) == N_TENANTS
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        solo = teng.generate([p], max_new_tokens=[b], adapter_ids=[ids[i]])
        _same(solo, jeng.generate([p], max_new_tokens=[b],
                                  adapter_ids=[ids[i]]))
        np.testing.assert_array_equal(solo[0], got[i])
    _check_pool(jeng, teng)
    # the adapters really steer: the base model's tokens differ
    base = teng.generate(prompts[:1], max_new_tokens=budgets[:1])
    assert not np.array_equal(base[0], got[0])


def test_identity_ids_omitted_and_adapterless_equal(tree):
    jbase, tbase = _engines(tree, "base")
    jeng, teng = _engines(tree, "mixed")
    prompts, budgets = _workload(seed=12)
    want = jbase.generate(prompts, max_new_tokens=budgets)
    outs = [tbase.generate(prompts, max_new_tokens=budgets),
            teng.generate(prompts, max_new_tokens=budgets),
            teng.generate(prompts, max_new_tokens=budgets,
                          adapter_ids=[0] * len(prompts)),
            tbase.generate(prompts, max_new_tokens=budgets,
                           adapter_ids=[0] * len(prompts))]
    for got in outs:
        _same(got, want)
    _check_pool(jeng, teng)
    assert teng.adapters.stats()["misses"] == 0


def test_eviction_churn_token_exact(tree):
    """slots 3 = two tenant slots for 8 tenants: admission waits for pins to
    drain and loads evict, in the same order as the JAX engine."""
    jeng, teng = _engines(tree, "churn")
    prompts, budgets = _workload(seed=13)
    ids = [1 + i % N_TENANTS for i in range(len(prompts))]
    _same(teng.generate(prompts, max_new_tokens=budgets, adapter_ids=ids),
          jeng.generate(prompts, max_new_tokens=budgets, adapter_ids=ids))
    _check_pool(jeng, teng)
    assert teng.adapters.stats()["evictions"] > 0


def test_oversubscribed_pool_preempts_chunks_bursts(tree):
    jeng, teng = _engines(tree, "tight")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], (18 + 5 * i,))
               .astype(np.int32) for i in range(4)]
    ids = [1, 2, 0, 3]
    _same(teng.generate(prompts, max_new_tokens=20, adapter_ids=ids),
          jeng.generate(prompts, max_new_tokens=20, adapter_ids=ids))
    _check_pool(jeng, teng)
    assert sum(teng.preempt_stats.values()) > 0
    assert teng.preempt_stats == jeng.preempt_stats
    assert teng.dispatches["burst"] > 0 and teng.dispatches["mixed"] > 0


def test_quant8_int8_kv_with_adapters_token_exact(tree):
    jeng, teng = _engines(tree, "q8_kv8")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, MODEL["vocab_size"], (18 + 5 * i,))
               .astype(np.int32) for i in range(4)]
    ids = [4, 0, 5, 6]
    _same(teng.generate(prompts, max_new_tokens=16, adapter_ids=ids),
          jeng.generate(prompts, max_new_tokens=16, adapter_ids=ids))
    _check_pool(jeng, teng)
    assert teng.cache.quantized and isinstance(
        teng.params["backbone"]["block_0"]["MLP_0"]["wi"], dict)


def _errors(fn_j, fn_t):
    """Both engines raise the same type with the same message."""
    with pytest.raises(Exception) as je:
        fn_j()
    with pytest.raises(Exception) as te:
        fn_t()
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)
    return str(te.value)


def test_client_errors_match_jax(tree):
    jeng, teng = _engines(tree, "mixed")
    jbase, tbase = _engines(tree, "base")
    p = np.arange(6, dtype=np.int32)
    msg = _errors(lambda: jeng.generate([p], 4, adapter_ids=[1, 2]),
                  lambda: teng.generate([p], 4, adapter_ids=[1, 2]))
    assert "adapter_ids list must match prompts" in msg
    msg = _errors(lambda: jeng.generate([p], 4, adapter_ids=[99]),
                  lambda: teng.generate([p], 4, adapter_ids=[99]))
    assert "never registered" in msg
    msg = _errors(lambda: jbase.generate([p], 4, adapter_ids=[1]),
                  lambda: tbase.generate([p], 4, adapter_ids=[1]))
    assert "no adapter pool" in msg
    msg = _errors(lambda: jbase.register_adapter(1),
                  lambda: tbase.register_adapter(1))
    assert "no adapter pool" in msg
    assert tbase.adapter_resident([1, 2]) == jbase.adapter_resident([1, 2])
    # id 0 on an adapter-less engine is accepted by both
    _same(tbase.generate([p], 4, adapter_ids=[0]),
          jbase.generate([p], 4, adapter_ids=[0]))
    _check_pool(jeng, teng)


def test_kv_plus_adapter_pages_beyond_pool(tree):
    """KV that fits alone but not next to its own pinned adapter pages is
    unservable at any load: rejected before anything runs."""
    jeng, teng = _engines(tree, "tight")
    prompt = np.zeros(8 * 16 - 12, np.int32)     # 15 blocks + 2 adapter
    msg = _errors(lambda: jeng.generate([prompt], [4], adapter_ids=[1]),
                  lambda: teng.generate([prompt], [4], adapter_ids=[1]))
    assert "adapter-page" in msg
    _same(teng.generate([prompt], [4]), jeng.generate([prompt], [4]))
    _check_pool(jeng, teng)


def test_draft_with_adapters_and_prefix_cache_refused(tree):
    tcfg = dataclasses.replace(GPTConfig.llama(**MODEL), dtype=torch.float32)
    params = params_from_numpy(tree, tcfg, "cpu", torch.float32)
    cfg = _config("mixed")
    with pytest.raises(NotImplementedError, match="speculative"):
        JaxEngine(JaxConfig.llama(**MODEL), config=cfg, params=tree,
                  draft_model=JaxConfig.llama(**MODEL), draft_params=tree)
    with pytest.raises(NotImplementedError, match="speculative"):
        InferenceEngineV2(tcfg, config=cfg, params=params, device="cpu",
                          draft_model=tcfg, draft_params=params)
    # the radix prefix cache stays refused: the reference matches cached KV
    # before binding the adapter, so a second tenant would reuse the
    # first tenant's V (ROADMAP C)
    with pytest.raises(NotImplementedError, match="prefix_cache"):
        InferenceEngineV2(tcfg, config={**cfg, "state_manager": dict(
            SM, prefix_cache=True)}, params=params, device="cpu")
