"""PyTorch port, serving slice: the torch InferenceEngineV2 and its ragged
model held to the JAX package on the same weights and inputs, in fp32 on
the CPU.

(a) the weight bridge round-trips the JAX engine's parameter tree;
(b) one mixed ``ragged_forward`` step and one ``ragged_decode_forward`` step
    give the JAX functions' logits (atol 1e-4) and KV pages;
(c) greedy ``generate`` is token-exact against the JAX engine under SplitFuse
    chunking, decode bursts, recompute preemption and EOS;
(d) sampling transforms match JAX and sampled generation stays in the vocab;
(e) unported config blocks raise NotImplementedError, ported ones serve;
(f) the engine's default device is the card, and without one it raises.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import _sampling_logits as jax_sampling
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import model as jmodel
from deepspeed_tpu.models import GPTConfig as JaxConfig
from deepspeed_tpu.models.gpt import GPTLogits
from deepspeed_tpu.models.gpt import count_params as jax_count_params
from deepspeed_tpu.parallel.metadata import unbox
from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
from deepspeed_tpu_torch import params_from_numpy
from deepspeed_tpu_torch.inference.engine import (_sample_token,
                                                  _sampling_logits)
from deepspeed_tpu_torch.inference.v2 import model as tmodel
from deepspeed_tpu_torch.inference.v2.ragged import (DSStateManager,
                                                     build_ragged_batch)
from deepspeed_tpu_torch.models.gpt import count_params, init_params

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

# bench_serving.py's smoke model with GQA added (g = 2)
MODEL = dict(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
             vocab_size=512, max_seq_len=256)
# oversubscribed pool (10 blocks of 8 for 4 prompts of 18..33 tokens + 20
# new) forces recompute preemption; max_q_per_seq 8 < every prompt forces
# SplitFuse chunking; the tail of the run fuses decode bursts
ENGINE = {"dtype": "fp32",
          "state_manager": {"max_tracked_sequences": 4,
                            "max_ragged_batch_size": 64,
                            "kv_block_size": 8, "max_q_per_seq": 8,
                            "num_kv_blocks": 10}}


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine on seeded numpy weights laid out as the flax
    GPTLogits tree (its names and shapes from an abstract init — a concrete
    flax init would only cost time)."""
    cfg = JaxConfig.llama(**MODEL)
    boxed = jax.eval_shape(lambda r: GPTLogits(cfg).init(
        r, jnp.zeros((1, 8), jnp.int32)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, a):
        if path[-1].key == "scale":
            return np.ones(a.shape, np.float32)
        return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, unbox(boxed["params"]))
    return JaxEngine(cfg, config=ENGINE, params=params)


@pytest.fixture(scope="module")
def tree(jax_engine):
    return jax.tree_util.tree_map(np.asarray, jax_engine.params)


@pytest.fixture(scope="module")
def tcfg():
    return dataclasses.replace(GPTConfig.llama(**MODEL), dtype=torch.float32)


@pytest.fixture(scope="module")
def tparams(tree, tcfg):
    return params_from_numpy(tree, tcfg, "cpu", torch.float32)


def _engine(tcfg, tparams, config=ENGINE):
    return InferenceEngineV2(tcfg, config=config, params=tparams,
                             device="cpu")


def _prompts(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (18 + 5 * i,)).astype(np.int32)
            for i in range(n)]


class TestWeightBridge:
    def test_round_trip(self, tree, tparams):
        flat_j = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat_j) == sum(1 for _ in _leaves(tparams))
        for path, leaf in flat_j:
            t = tparams
            for p in path:
                t = t[p.key]
            np.testing.assert_array_equal(t.numpy(), leaf)

    def test_init_params_layout_and_count(self, tree, tcfg):
        ours = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
        got = {k: v for k, v in _shapes(ours).items()}
        assert got == want
        assert count_params(tcfg) == jax_count_params(JaxConfig.llama(**MODEL))
        assert sum(p.numel() for p in _leaves(ours)) == count_params(tcfg)

    @pytest.mark.parametrize("damage", ["missing", "extra", "shape"])
    def test_mismatch_raises(self, tree, tcfg, damage):
        bad = jax.tree_util.tree_map(lambda a: a, tree)
        attn = bad["backbone"]["block_1"]["Attention_0"]
        if damage == "missing":
            del attn["wk"]
        elif damage == "extra":
            attn["bq"] = np.zeros((4, 32), np.float32)
        else:
            attn["wo"] = attn["wo"][:, :16]
        with pytest.raises(ValueError):
            params_from_numpy(bad, tcfg, "cpu", torch.float32)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


class TestRaggedForward:
    """Mixed prefill+decode steps, then a decode-only step, through both
    packages' model functions on the same RaggedBatch and weights."""

    NB, BS, Q = 16, 8, 8

    def test_mixed_and_decode_logits_match_jax(self, jax_engine, tcfg,
                                               tparams):
        jcfg = jax_engine.model_config
        jcache = jmodel.PagedKVCache.create(jcfg, self.NB, self.BS,
                                            jnp.float32)
        jax_mixed = jax.jit(functools.partial(
            jmodel.ragged_forward, cfg=jcfg, block_size=self.BS,
            max_q_per_seq=self.Q))
        jax_decode = jax.jit(functools.partial(
            jmodel.ragged_decode_forward, cfg=jcfg, block_size=self.BS))
        tcache = tmodel.PagedKVCache.create(tcfg, self.NB, self.BS,
                                            torch.float32, "cpu")
        st = DSStateManager(max_tracked_sequences=4, num_blocks=self.NB,
                            block_size=self.BS, max_seq_len=256)
        rng = np.random.default_rng(1)
        toks = lambda n: rng.integers(0, 512, (n,)).astype(np.int32)  # noqa
        steps = [[(1, toks(5)), (2, toks(8)), (3, toks(3))],
                 # decode of 1, continuation chunk of 2, a new sequence 4
                 [(1, toks(1)), (2, toks(6)), (4, toks(7))]]
        for step in steps:
            schedule = []
            for uid, t in step:
                seq = st.get(uid) or st.create(uid)
                st.ensure_blocks(seq, len(t))
                schedule.append((seq, t))
            rb = build_ragged_batch(schedule, st, 64, self.Q)
            arrays = {"tokens": rb.tokens, "token_slot": rb.token_slot,
                      "token_pos": rb.token_pos,
                      "token_dense_idx": rb.token_dense_idx,
                      "block_table": rb.block_table, "kv_len": rb.kv_len}
            want, jcache = jax_mixed(
                jax_engine.params, jcache,
                {k: jnp.asarray(a) for k, a in arrays.items()})
            got, _ = tmodel.ragged_forward(
                tparams, tcache,
                {k: torch.from_numpy(a) for k, a in arrays.items()}, tcfg,
                block_size=self.BS, max_q_per_seq=self.Q)
            sl = rb.logits_slots
            np.testing.assert_allclose(got.numpy()[sl],
                                       np.asarray(want)[sl], atol=1e-4)
            for seq, t in schedule:
                seq.seen_tokens += len(t)

        # decode-only step over all four sequences
        S = 4
        tokens, active = np.zeros(S, np.int32), np.zeros(S, bool)
        pos = np.zeros(S, np.int32)
        bt = np.zeros((S, st.max_blocks_per_seq), np.int32)
        for uid in (1, 2, 3, 4):
            seq = st.get(uid)
            st.ensure_blocks(seq, 1)
            tokens[seq.slot] = rng.integers(0, 512)
            active[seq.slot] = True
            pos[seq.slot] = seq.seen_tokens
            bt[seq.slot, :len(seq.blocks)] = seq.blocks
        arrays = {"tokens": tokens, "active": active, "token_pos": pos,
                  "block_table": bt}
        want, jcache = jax_decode(
            jax_engine.params, jcache,
            {k: jnp.asarray(a) for k, a in arrays.items()})
        got, _ = tmodel.ragged_decode_forward(
            tparams, tcache, {k: torch.from_numpy(a)
                              for k, a in arrays.items()}, tcfg,
            block_size=self.BS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

        # the KV pools hold the same pages (JAX keeps hd=32 pages in its
        # kv-major transpose [.., hd, bs]; the port only has [.., bs, hd])
        jk = np.asarray(jcache.k)
        if jmodel.kv_major_layout(jcfg):
            jk = np.swapaxes(jk, -1, -2)
        np.testing.assert_allclose(tcache.k.numpy(), jk, atol=1e-4)


class TestGenerateExact:
    def test_greedy_token_exact_with_chunking_bursts_preemption(
            self, jax_engine, tcfg, tparams):
        prompts = _prompts()
        assert min(len(p) for p in prompts) > \
            ENGINE["state_manager"]["max_q_per_seq"]          # chunked
        want = jax_engine.generate(prompts, max_new_tokens=20)
        eng = _engine(tcfg, tparams)
        got = eng.generate(prompts, max_new_tokens=20)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert eng.preempt_stats == jax_engine.preempt_stats
        assert eng.preempt_stats["decode_ready"] > 0
        assert eng.preempt_stats["mid_prefill"] > 0
        assert eng.dispatches["burst"] > 0
        assert eng.query()["free_kv_blocks"] == 10        # pool fully freed

    def test_eos_token_exact(self, jax_engine, tcfg, tparams):
        prompts = _prompts(seed=1)
        ref = jax_engine.generate(prompts, max_new_tokens=20)
        eos = int(ref[1][3])
        want = jax_engine.generate(prompts, max_new_tokens=20,
                                   eos_token_id=eos)
        got = _engine(tcfg, tparams).generate(prompts, max_new_tokens=20,
                                              eos_token_id=eos)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        # request 1 stops at its first eos (at the latest its 4th token)
        assert got[1][-1] == eos and list(got[1]).index(eos) == len(got[1]) - 1
        assert len(got[1]) <= 4

    def test_put_logits_match_jax(self, jax_engine, tcfg, tparams):
        """The engine-level put(): one ragged forward per call."""
        rng = np.random.default_rng(2)
        p = [rng.integers(0, 512, (n,)).astype(np.int32) for n in (5, 8)]
        jeng = JaxEngine(JaxConfig.llama(**MODEL), config=ENGINE,
                         params=jax_engine.params)
        eng = _engine(tcfg, tparams)
        for uids, toks in (([7, 8], p), ([7], [p[0][:1]])):
            np.testing.assert_allclose(eng.put(uids, toks),
                                       jeng.put(uids, toks), atol=1e-4)

    def test_open_loop_arrivals_complete(self, tcfg, tparams):
        clock = iter(np.arange(0.0, 1e4, 0.01))
        out = _engine(tcfg, tparams).generate(
            _prompts(seed=2, n=3), max_new_tokens=[5, 9, 12],
            arrival_times=[0.0, 0.3, 0.05], now_fn=lambda: next(clock))
        assert [len(o) for o in out] == [5, 9, 12]


class TestSampling:
    def test_sampling_logits_match_jax(self):
        rng = np.random.default_rng(3)
        logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
        # (top_p = 1.0 is left out: which far-tail tokens a cumulative sum
        # that rounds to just under 1.0 drops is float noise in both)
        for temp, k, p in ((0.7, 0, 0.97), (1.3, 10, 0.99), (1.0, 0, 0.8),
                           (0.9, 20, 0.6), (1.0, 1000, 0.95)):
            want = np.asarray(jax_sampling(jnp.asarray(logits),
                                           temperature=temp, top_k=k,
                                           top_p=p))
            got = _sampling_logits(torch.from_numpy(logits),
                                   temperature=temp, top_k=k,
                                   top_p=p).numpy()
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)

    def test_sampled_distribution(self):
        """Sampled token frequencies follow softmax of the filtered logits
        (the bits differ from JAX's, so the distribution is what is held)."""
        logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
        kw = dict(temperature=0.8, top_k=4, top_p=0.95)
        probs = torch.softmax(_sampling_logits(logits, **kw), -1)[0]
        gen = torch.Generator().manual_seed(0)
        draws = torch.stack([_sample_token(logits.expand(1000, -1), gen,
                                           do_sample=True, **kw)
                             for _ in range(20)]).reshape(-1)
        freq = torch.bincount(draws.long(), minlength=6).double() / 20000
        np.testing.assert_allclose(freq.numpy(), probs.double().numpy(),
                                   atol=0.015)
        assert freq[4:].sum() == 0                        # filtered out
        greedy = _sample_token(logits, gen, do_sample=False, **kw)
        assert greedy.dtype == torch.int32 and int(greedy[0]) == 0

    def test_sampled_generate_in_vocab_and_seeded(self, tcfg, tparams):
        """Same seed, same fresh engine state → same samples (a reused
        engine hands requests other slots, hence other random rows)."""
        kw = dict(max_new_tokens=12, do_sample=True, temperature=0.9,
                  top_k=50, top_p=0.9)
        a = _engine(tcfg, tparams).generate(_prompts(seed=4), seed=5, **kw)
        b = _engine(tcfg, tparams).generate(_prompts(seed=4), seed=5, **kw)
        for x, y in zip(a, b):
            assert len(x) == 12 and x.min() >= 0 and x.max() < 512
            np.testing.assert_array_equal(x, y)


class TestUnported:
    # (quant and kv_quant are ported — tests/test_torch_quant_serving.py —
    # and so are adapters — tests/test_torch_lora_serving.py; speculative
    # decoding, serving telemetry, SLA scheduling and the prefix cache too —
    # tests/test_torch_{speculative,serving_telemetry,prefix_cache}.py.
    # What still raises: tensor parallelism, and the prefix cache with
    # adapters)
    REFUSED = (0, 1, 4)
    CONFIGS = [
        {"quant": {"enabled": True}, "tensor_parallel": {"tp_size": 2}},
        {"adapters": {"enabled": True, "rank": 4},
         "state_manager": {"prefix_cache": True}},
        {"speculative": {"gamma": 2}},
        {"telemetry": {"stream_sync": True}},
        {"tensor_parallel": {"tp_size": 2}},
        {"state_manager": {"kv_quant": "int8", "prefix_cache": True}},
        {"state_manager": {"prefix_cache": True}},
        {"scheduler": {"sla_classes": {"gold": {"priority": 1}}}},
    ]

    @pytest.mark.parametrize("config", CONFIGS)
    def test_config_blocks_raise(self, tcfg, tparams, config):
        """Each block either raises naming its ROADMAP item or, where it
        is ported, is accepted and serves on the CPU."""
        full = {"dtype": "fp32", **config}
        if self.CONFIGS.index(config) in self.REFUSED:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                InferenceEngineV2(tcfg, config=full, device="cpu")
            return
        kw = {}
        if "speculative" in config:
            kw = dict(draft_model=tcfg, draft_params=tparams)
        if "state_manager" in config:
            # pages of 8 tokens, so that the prompts fill whole blocks the
            # radix can cache
            full["state_manager"] = dict(config["state_manager"],
                                         kv_block_size=8)
        eng = InferenceEngineV2(tcfg, config=full, params=tparams,
                                device="cpu", **kw)
        prompts = _prompts(n=2)
        gen = dict(max_new_tokens=6)
        if "scheduler" in config:
            gen["sla"] = ["gold", "default"]
        out = eng.generate(prompts, **gen)
        assert [len(o) for o in out] == [6, 6]
        if "speculative" in config:
            st = eng.telemetry.spec_summary()
            assert st["outer_steps"] > 0
            assert st["proposed"] == 2 * st["outer_steps"]
        if "telemetry" in config:
            assert eng.telemetry.stream_sync
        if config.get("state_manager", {}).get("prefix_cache"):
            again = eng.generate(prompts, **gen)
            assert all(np.array_equal(a, b) for a, b in zip(out, again))
            assert eng.telemetry.value("kv_prefix_hit_tokens_total") > 0

    def test_other_unported_inputs_raise(self, tcfg, tparams):
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            InferenceEngineV2(dataclasses.replace(tcfg, num_experts=4),
                              config={"dtype": "fp32"}, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
            InferenceEngineV2("/some/hf/model/dir", device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            InferenceEngineV2(tcfg, config={
                "dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
                device="cpu", draft_model=tcfg)
        eng = _engine(tcfg, tparams)
        with pytest.raises(ValueError, match="unknown SLA class"):
            eng.generate(_prompts(n=1), max_new_tokens=2, sla=["gold"])
        with pytest.raises(TypeError, match="unknown generation"):
            eng.generate(_prompts(n=1), max_new_tokens=2, tempreature=0.5)

    def test_draft_model_and_sla_are_ported(self, tcfg, tparams):
        """A draft model (the refusal this replaces) serves the target's
        greedy tokens; generate(sla=...) with a configured class serves."""
        want = _engine(tcfg, tparams).generate(_prompts(n=2),
                                               max_new_tokens=8)
        spec = InferenceEngineV2(tcfg, config={"dtype": "fp32"},
                                 params=tparams, device="cpu",
                                 draft_model=tcfg)
        got = spec.generate(_prompts(n=2), max_new_tokens=8)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert spec.telemetry.spec_summary()["outer_steps"] > 0
        with pytest.raises(ValueError, match="draft vocab_size"):
            InferenceEngineV2(tcfg, config={"dtype": "fp32"}, device="cpu",
                              draft_model=dataclasses.replace(
                                  tcfg, vocab_size=256))

    def test_bad_config_types_rejected(self, tcfg):
        with pytest.raises(TypeError, match="max_tracked_sequences"):
            InferenceEngineV2(tcfg, config={
                "dtype": "fp32",
                "state_manager": {"max_tracked_sequences": "four"}},
                device="cpu")
        with pytest.raises(ValueError, match="dtype"):
            InferenceEngineV2(tcfg, config={"dtype": "fp64"}, device="cpu")


class TestDevice:
    def test_default_device_is_the_card(self, tcfg):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default resolves to "
                        "it instead of raising")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngineV2(tcfg, config={"dtype": "fp32"})
