"""PyTorch port, quantized serving: the torch InferenceEngineV2 with the
``quant`` block (W8A16 / W4A16 weight stores) and ``kv_quant="int8"`` held
to the JAX engine on the same numpy weights, in fp32 on the CPU.

(a) the packed tree equals the JAX engine's: the same leaves quantized, the
    same grouped dim, codes bit-equal and scales equal — 8 and 4 bits, a
    llama-style model (attention wo grouped on dim 1) and a tied GPT-2-style
    model with an odd vocabulary (padded table); the weight bridge carries
    the JAX store leaves over unchanged;
(b) ``put`` logits agree at 1e-4;
(c) greedy ``generate`` is token-exact for quant 8, quant 4, kv_quant int8
    and quant 8 with kv_quant int8, through SplitFuse chunking, decode
    bursts, recompute preemption and EOS;
(d) config handling: unknown kv_quant / bits raise ValueError, quant with
    tensor parallelism and MoE models raise NotImplementedError naming
    their ROADMAP items;
(e) bytes: at rest a realistically shaped engine holds <= 0.53x (8 bits) /
    <= 0.30x (4 bits) of the bf16 tree's bytes and no full-precision
    weight, and an int8 KV pool <= 0.53x of the bf16 pool.
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
from deepspeed_tpu_torch.models.gpt import count_params, init_params
from deepspeed_tpu_torch.ops.quantization import store_nbytes

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

# the serving tests' llama-style model (GQA g = 2, head_dim 32) and a tied
# GPT-2-style one (learned positions, LayerNorm) with an odd vocabulary
MODELS = {
    "llama": lambda lib: lib.llama(num_layers=2, hidden=128, heads=4,
                                   num_kv_heads=2, vocab_size=512,
                                   max_seq_len=256),
    "gpt2": lambda lib: lib(vocab_size=500, num_layers=2, num_heads=4,
                            head_dim=32, hidden_size=128, max_seq_len=256),
    # hidden 256: quant.group_size 256 packs whole groups of 256
    "llama256": lambda lib: lib.llama(num_layers=2, hidden=256, heads=4,
                                      num_kv_heads=2, vocab_size=512,
                                      max_seq_len=256),
}
# oversubscribed pool (preemption), prompts longer than max_q_per_seq
# (chunking), a tail of decode bursts — as in tests/test_torch_serving.py
SM = {"max_tracked_sequences": 4, "max_ragged_batch_size": 64,
      "kv_block_size": 8, "max_q_per_seq": 8, "num_kv_blocks": 10}
QUANT = {
    "q8": {"quant": {"enabled": True, "bits": 8}},
    "q4": {"quant": {"enabled": True, "bits": 4}},
    "kv8": {"state_manager": dict(SM, kv_quant="int8")},
    "q8_kv8": {"quant": {"enabled": True, "bits": 8},
               "state_manager": dict(SM, kv_quant="int8")},
}
GROUP256 = {
    "q8_g256": {"quant": {"enabled": True, "bits": 8, "group_size": 256}},
    "q4_g256": {"quant": {"enabled": True, "bits": 4, "group_size": 256}},
}
# (TestGroup256 lives in test_torch_quant_serving_g256.py: a file of its
# own, so that the pytest-xdist workers share the two files' JAX compiles)


def _config(name):
    return {"dtype": "fp32", "state_manager": SM,
            **{**QUANT, **GROUP256}[name]}


def _numpy_tree(model):
    """Seeded numpy weights laid out as the flax GPTLogits tree."""
    cfg = MODELS[model](JaxConfig)
    boxed = jax.eval_shape(lambda r: GPTLogits(cfg).init(
        r, jnp.zeros((1, 8), jnp.int32)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, a):
        if path[-1].key == "scale":
            return np.ones(a.shape, np.float32)
        return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, unbox(boxed["params"]))


@pytest.fixture(scope="module")
def trees():
    return {m: _numpy_tree(m) for m in MODELS}


@pytest.fixture(scope="module")
def jax_engines(trees):
    """One JAX engine per (model, config), built on first use."""
    cache = {}

    def get(model, name):
        if (model, name) not in cache:
            cache[model, name] = JaxEngine(MODELS[model](JaxConfig),
                                           config=_config(name),
                                           params=trees[model])
        return cache[model, name]
    return get


def _tcfg(model):
    return dataclasses.replace(MODELS[model](GPTConfig), dtype=torch.float32)


def _torch_engine(trees, model, name):
    params = params_from_numpy(trees[model], _tcfg(model), "cpu",
                               torch.float32)
    return InferenceEngineV2(_tcfg(model), config=_config(name),
                             params=params, device="cpu")


def _prompts(seed=0, n=4, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (18 + 5 * i,)).astype(np.int32)
            for i in range(n)]


def _walk(a, b, path=()):
    """Pairs of leaves (stores as dicts) of two trees with the same keys."""
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict) and not set(a[k]) <= {"v", "v4", "s"}:
            yield from _walk(a[k], b[k], path + (k,))
        else:
            yield path + (k,), a[k], b[k]


class TestPackedTree:
    @pytest.mark.parametrize("model,name", [("llama", "q8"), ("llama", "q4"),
                                            ("gpt2", "q8"), ("gpt2", "q4")])
    def test_packed_tree_equals_jax(self, trees, jax_engines, model, name):
        jtree = jax.tree_util.tree_map(np.asarray,
                                       jax_engines(model, name).params)
        eng = _torch_engine(trees, model, name)
        bridged = params_from_numpy(jtree, _tcfg(model), "cpu",
                                    torch.float32)
        stores = 0
        for path, want, got in _walk(jtree, eng.params):
            if isinstance(want, dict):
                stores += 1
                assert isinstance(got, dict) and set(got) == set(want), path
                for key in want:
                    assert got[key].dtype == (torch.int8 if key != "s"
                                              else torch.float32), path
                    np.testing.assert_array_equal(got[key].numpy(),
                                                  want[key], err_msg=str(path))
            else:
                assert not isinstance(got, dict), path
                np.testing.assert_array_equal(got.numpy(), want)
        # the bridge hands JAX's packed tree over leaf for leaf
        for path, want, got in _walk(eng.params, bridged):
            if isinstance(want, dict):
                for key in want:
                    assert torch.equal(want[key], got[key]), path
        bb = eng.params["backbone"]
        wo = bb["block_0"]["Attention_0"]["wo"]
        assert wo["v"].shape == (4, 32, 128)              # stays int8 codes
        assert wo["s"].shape == (4, 1, 128)               # grouped on dim 1
        if model == "gpt2":
            # the odd vocabulary padded to the group; a tied table stays
            # int8 at 4 bits (the transposed kernel has no packed variant)
            assert set(bb["wte"]) == {"v", "s"}
            assert bb["wte"]["v"].shape == (512, 128)
            assert torch.count_nonzero(bb["wte"]["v"][500:]) == 0
            assert torch.count_nonzero(bb["wte"]["s"][-1, :]) > 0
            assert not isinstance(bb["wpe"], dict)        # wpe is not packed
        else:
            mlp = bb["block_1"]["MLP_0"]["wi"]
            assert set(mlp) == ({"v4", "s"} if name == "q4" else {"v", "s"})
        assert stores >= (13 if model == "llama" else 10)

    @pytest.mark.parametrize("model,name", [("llama", "q8"), ("llama", "q4"),
                                            ("llama", "kv8"),
                                            ("llama", "q8_kv8"),
                                            ("gpt2", "q8")])
    def test_put_logits_match_jax(self, trees, jax_engines, model, name):
        rng = np.random.default_rng(2)
        p = [rng.integers(0, 500, (n,)).astype(np.int32) for n in (5, 8)]
        jeng = jax_engines(model, name)     # left clean for later tests
        eng = _torch_engine(trees, model, name)
        for uids, toks in (([7, 8], p), ([7], [p[0][:1]])):
            got = eng.put(uids, toks)
            assert got.shape == (len(uids), 500 if model == "gpt2" else 512)
            np.testing.assert_allclose(got, jeng.put(uids, toks), atol=1e-4)
        jeng.flush([7, 8])
        assert jeng.query()["free_kv_blocks"] == SM["num_kv_blocks"]


class TestGenerateExact:
    @pytest.mark.parametrize("name", sorted(QUANT))
    def test_greedy_token_exact(self, trees, jax_engines, name):
        prompts = _prompts()
        jeng = jax_engines("llama", name)
        want = jeng.generate(prompts, max_new_tokens=20)
        eng = _torch_engine(trees, "llama", name)
        got = eng.generate(prompts, max_new_tokens=20)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert eng.preempt_stats == jeng.preempt_stats
        assert eng.preempt_stats["decode_ready"] > 0
        assert eng.preempt_stats["mid_prefill"] > 0
        assert eng.dispatches["burst"] > 0
        assert eng.query()["free_kv_blocks"] == 10

    def test_eos_token_exact(self, trees, jax_engines):
        prompts = _prompts(seed=1)
        jeng = jax_engines("llama", "q8_kv8")
        ref = jeng.generate(prompts, max_new_tokens=20)
        eos = int(ref[1][3])
        want = jeng.generate(prompts, max_new_tokens=20, eos_token_id=eos)
        got = _torch_engine(trees, "llama", "q8_kv8").generate(
            prompts, max_new_tokens=20, eos_token_id=eos)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert got[1][-1] == eos and len(got[1]) <= 4

    def test_tied_gpt2_w8_token_exact(self, trees, jax_engines):
        prompts = _prompts(seed=3, n=3)
        want = jax_engines("gpt2", "q8").generate(prompts, max_new_tokens=12)
        got = _torch_engine(trees, "gpt2", "q8").generate(prompts,
                                                          max_new_tokens=12)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


class TestConfig:
    def test_unknown_kv_quant_and_bits_raise(self):
        cfg = _tcfg("llama")
        with pytest.raises(ValueError, match="kv_quant"):
            InferenceEngineV2(cfg, config={
                "dtype": "fp32", "state_manager": {"kv_quant": "fp8"}},
                device="cpu")
        with pytest.raises(ValueError, match="bits"):
            InferenceEngineV2(cfg, config={
                "dtype": "fp32", "quant": {"enabled": True, "bits": 6}},
                device="cpu")

    def test_unported_combinations_raise(self):
        cfg = _tcfg("llama")
        with pytest.raises(NotImplementedError, match="A.8"):
            InferenceEngineV2(cfg, config={
                "dtype": "fp32", "quant": {"enabled": True},
                "tensor_parallel": {"tp_size": 2}}, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceEngineV2(dataclasses.replace(cfg, num_experts=4),
                              config={"dtype": "fp32",
                                      "quant": {"enabled": True}},
                              device="cpu")

    def test_packed_tree_is_not_accepted_as_params(self, trees):
        eng = _torch_engine(trees, "llama", "q8")
        with pytest.raises(TypeError, match="quantized store"):
            InferenceEngineV2(_tcfg("llama"), config=_config("q8"),
                              params=eng.params, device="cpu")


class TestBytes:
    @pytest.mark.parametrize("bits,limit", [(8, 0.53), (4, 0.30)])
    def test_store_bytes_at_rest(self, bits, limit):
        """A Llama-shaped model (head_dim 128, GQA 4, FFN 2.75x hidden,
        untied), cut to 2 layers of hidden 1024: the engine holds only the
        store, at the expected share of the bf16 tree's bytes."""
        cfg = GPTConfig.llama(num_layers=2, hidden=1024, heads=8,
                              num_kv_heads=2, vocab_size=4096,
                              max_seq_len=512, mlp_dim_override=2816,
                              dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             torch.bfloat16)
        dense = store_nbytes(params)
        assert dense == 2 * count_params(cfg)
        sm = {"max_tracked_sequences": 2, "kv_block_size": 16}
        eng = InferenceEngineV2(cfg, config={
            "dtype": "bfloat16", "quant": {"enabled": True, "bits": bits},
            "state_manager": dict(sm, kv_quant="int8")},
            params=params, device="cpu")
        del params
        ratio = store_nbytes(eng.params) / dense
        assert ratio <= limit, ratio

        def leaves(t):
            for v in t.values():
                if isinstance(v, dict) and not set(v) <= {"v", "v4", "s"}:
                    yield from leaves(v)
                else:
                    yield v
        for leaf in leaves(eng.params):
            # every weight matrix is a store; norm vectors stay bf16
            assert isinstance(leaf, dict) or leaf.dim() == 1
        bf16_pool = InferenceEngineV2(cfg, config={
            "dtype": "bfloat16", "state_manager": sm},
            device="cpu").cache.nbytes
        assert eng.cache.nbytes / bf16_pool <= 0.53
