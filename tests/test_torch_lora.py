"""PyTorch port, multi-tenant LoRA: the batched-gather op and the paged
adapter pool held to the JAX package on the same numpy inputs, on the CPU.

(a) ``torch_lora_matmul`` (and the registry's ``lora_matmul`` on CPU
    tensors) against ``xla_lora_matmul``: fp32 within 1e-5 of each output
    row's largest value, bf16 within one bf16 rounding of it; identity rows
    exactly 0 — the JAX op tests' case, a ragged M, all-identity rows and
    ranks 16 and 64.  (The Pallas kernel is not the oracle: its own test in
    the JAX suite is red on accumulation order.)
(b) ``AdapterPool`` against JAX's ``AdapterPool`` driven through the same
    scripted steps, one parametrised case per JAX ``TestAdapterPool`` test:
    equal return values and errors, ``stats()``, residency, ``slot_of``,
    free blocks, refcounts and table contents (the port's layer-major
    tables through a permute) after every step.
(c) ``blocks_per_adapter`` and ``kv_block_bytes()`` equal to the JAX
    engine's for bf16, fp32 and int8-KV engines.
(d) The CUDA kernels' route and scratch rules at every rank 1-256 and
    dtype (device-free: ``lora_route``, ``shape_problem``,
    ``lora_scratch_shape``), and the tensor-core pair's arithmetic written
    in torch (rows segmented by slot into 64-row tiles in row order, fp32
    partials over 256-wide H chunks summed in ascending order, u cast to
    x's dtype, the expand, the scale) against ``xla_lora_matmul``: fp32
    within 1e-5 of each row's largest value, bf16 within one bf16
    rounding (2^-7), slot 0 rows exactly 0.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import BlockedAllocator as JaxAllocator
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import GPTConfig as JaxConfig
from deepspeed_tpu.models.gpt import GPTLogits
from deepspeed_tpu.parallel.metadata import unbox
from deepspeed_tpu.serving import adapters as jadapters
from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2, ops
from deepspeed_tpu_torch import params_from_numpy
from deepspeed_tpu_torch.inference.v2.ragged import BlockedAllocator
from deepspeed_tpu_torch.serving import adapters as tadapters

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

jlora = importlib.import_module("deepspeed_tpu.ops.lora_matmul")
tlora = importlib.import_module("deepspeed_tpu_torch.ops.lora_matmul")


# --------------------------------------------------------------------- (a)

def _op_case(S=4, M=16, H=256, R=4, O=128, seed=0, identity=False):
    """The JAX op tests' case: slot 0 the identity (zero pages, scale 0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, H)).astype(np.float32)
    a = rng.normal(size=(S, H, R)).astype(np.float32)
    b = rng.normal(size=(S, R, O)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    scales = np.asarray(([0.0, 2.0, 0.5, 1.0] * S)[:S], np.float32)
    ids = (np.zeros(M, np.int32) if identity
           else rng.integers(0, S, size=M).astype(np.int32))
    return x, a, b, ids, scales


OP_CASES = {
    "jax_case": {},
    "ragged_m13": {"M": 13, "seed": 5},
    "all_identity": {"identity": True},
    "rank16": {"R": 16, "S": 9, "M": 37, "seed": 1},
    "rank64": {"R": 64, "S": 9, "M": 21, "O": 64, "seed": 2},
}


def _row_rel(got, want):
    """Worst row's max |got - want| over the row's largest |want|; rows
    whose true value is all zero must be exactly zero."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(-1)
    zero = scale == 0
    assert not got[zero].any(), "an identity row is not exactly zero"
    d = np.abs(got - want).max(-1)
    return float((d[~zero] / scale[~zero]).max()) if (~zero).any() else 0.0


@pytest.mark.parametrize("case", sorted(OP_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_lora_matmul_matches_xla(case, dtype):
    x, a, b, ids, scales = _op_case(**OP_CASES[case])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jlora.xla_lora_matmul(jnp.asarray(x, jdt), jnp.asarray(a, jdt),
                                 jnp.asarray(b, jdt), jnp.asarray(ids),
                                 jnp.asarray(scales))
    want = np.asarray(want.astype(jnp.float32))
    targs = (torch.from_numpy(x).to(tdt), torch.from_numpy(a).to(tdt),
             torch.from_numpy(b).to(tdt), torch.from_numpy(ids),
             torch.from_numpy(scales))
    got = tlora.torch_lora_matmul(*targs)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    # fp32: accumulation order only.  bf16: u and y each round once to
    # bf16, so a different fp32 sum can land one bf16 step (2^-7 of a
    # value) away
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert _row_rel(got.float(), want) <= tol
    via_registry = ops.lora_matmul(*targs)
    assert torch.equal(via_registry, got)
    if case == "all_identity":
        assert not got.float().any()


def test_lora_matmul_matches_per_request_loop():
    """Row independence: each row equals its own (x A) B s."""
    x, a, b, ids, scales = _op_case()
    got = tlora.torch_lora_matmul(*(torch.from_numpy(t) for t in
                                    (x, a, b, ids, scales))).numpy()
    for i in range(len(ids)):
        s = int(ids[i])
        want = (x[i].astype(np.float64) @ a[s] @ b[s]) * scales[s]
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)


def test_kernel_wrapper_refuses_cpu_and_bad_calls():
    """The registry sends CPU tensors to the plain version; the CUDA
    wrapper's checks reject what the kernel cannot take (on this box every
    tensor is on the CPU, so ``cuda_lora_matmul`` must refuse)."""
    x, a, b, ids, scales = (torch.from_numpy(t) for t in _op_case())
    assert not tlora.lora_supported(x, a, b, ids, scales)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tlora.cuda_lora_matmul(x, a, b, ids, scales)
    assert "lora_matmul" in ops.op_report()
    assert tlora.cuda_lora_matmul.launches == 0


# --------------------------------------------------------------------- (b)

def _pools(num_blocks=4, slots=4, block_bytes=128):
    """Tiny pools: L=1, H=8, r=2, q=v=8 → 256 B an adapter → 2 blocks."""
    kw = dict(slots=slots, rank=2, hidden=8, num_layers=1, q_dim=8, v_dim=8,
              block_bytes=block_bytes, scale=2.0)
    return (jadapters.AdapterPool(JaxAllocator(num_blocks), **kw),
            tadapters.AdapterPool(BlockedAllocator(num_blocks), **kw,
                                  device="cpu"))


def _churn_steps():
    rng = np.random.default_rng(0)
    steps = [("register", a) for a in range(1, 7)]
    for _ in range(40):
        aid = int(rng.integers(1, 7))
        steps += [("ensure", [aid]), ("acquire", aid), ("release", aid)]
    return steps


# (pool kwargs, steps) per JAX TestAdapterPool case
POOL_SCRIPTS = {
    "register_validation": ({}, [
        ("register", 0), ("register", 1, {"a_q": np.zeros((1, 8, 2))}),
        ("register", 1), ("register", 1), ("registered", 1),
        ("registered", 0), ("registered", 2), ("blocks_per_adapter",)]),
    "miss_hit_evict_reload": ({"num_blocks": 4}, [
        ("register", 1), ("register", 2), ("register", 3),
        ("ensure", [1]), ("ensure", [1]), ("ensure", [2]), ("ensure", [3]),
        ("is_resident", 1), ("ensure", [1]), ("hit_rate",)]),
    "pinned_never_evicted": ({"num_blocks": 4}, [
        ("register", 1), ("register", 2), ("register", 3),
        ("ensure", [1, 2]), ("acquire", 1), ("ensure", [3]),
        ("release", 1)]),
    "all_slots_pinned": ({"num_blocks": 8, "slots": 3}, [
        ("register", 1), ("register", 2), ("register", 3),
        ("ensure", [1, 2]), ("acquire", 1), ("acquire", 2),
        ("ensure", [3]), ("release", 1), ("ensure", [3])]),
    "spill_beyond_cold": ({"num_blocks": 5}, [
        ("register", 1), ("register", 2), ("ensure", [1]), ("acquire", 1),
        ("radix_alloc", 2), ("ensure_spill", [2])]),
    "unfittable_reasons": ({}, [
        ("unfittable", 0), ("unfittable", 9), ("register", 1),
        ("unfittable", 1)]),
    "unfittable_tiny_pool": ({"num_blocks": 1}, [
        ("register", 1), ("unfittable", 1)]),
    "unfittable_no_slots": ({"slots": 1}, [
        ("register", 1), ("unfittable", 1), ("ensure", [1])]),
    "identity_slot": ({}, [
        ("register", 1), ("is_resident", 0), ("slot_of", 0),
        ("resident_count", [0, 1, 2]), ("ensure", [1]),
        ("resident_count", [0, 1, 1, 2]), ("slot_of", 1)]),
    "evict_cold_and_unknown": ({"num_blocks": 6}, [
        ("register", 1), ("register", 2), ("register", 3),
        ("ensure", [1, 2, 3]), ("acquire", 2), ("evict_cold", 3),
        ("ensure", [7]), ("release", 2), ("evict_cold", 10)]),
    "churn": ({"num_blocks": 4}, _churn_steps()),
}


def _run_step(pool, step, radix):
    """One scripted step → ("ok", value) or ("raise", type, message)."""
    kind, *args = step
    try:
        if kind == "register":
            return "ok", pool.register(*args)
        if kind == "radix_alloc":        # blocks a radix cache would hold
            radix.extend(pool.allocator.allocate(args[0]))
            return "ok", None
        if kind == "ensure_spill":
            calls = []

            def spill(n):
                calls.append(n)
                freed = pool.allocator.release(radix[:n])
                del radix[:n]
                return len(freed)
            pool.ensure(args[0], spill=spill)
            return "ok", calls
        if kind == "unfittable":
            return "ok", pool.unfittable_reason(*args)
        if kind == "blocks_per_adapter":
            return "ok", pool.blocks_per_adapter
        if kind == "hit_rate":
            return "ok", pool._hit_rate()
        return "ok", getattr(pool, kind)(*args)
    except Exception as e:                                  # noqa: BLE001
        return "raise", type(e).__name__, str(e)


def _snapshot(pool, is_torch):
    alloc = pool.allocator
    tables = {}
    for k, t in pool.tables().items():
        if is_torch:
            t = t.permute(1, 0, 2, 3) if k != "scale" else t
            t = t.numpy()
        tables[k] = np.asarray(t)
    aids = sorted(pool._host)
    return {"stats": pool.stats(),
            "resident": {a: pool.is_resident(a) for a in aids + [0]},
            "slots": {a: pool.slot_of(a) for a in aids
                      if pool.is_resident(a)},
            "free": alloc.free_blocks,
            "refcounts": [alloc.refcount(b) for b in range(alloc.num_blocks)],
            "evictable": pool.evictable_blocks(),
            "tables": tables}


@pytest.mark.parametrize("script", sorted(POOL_SCRIPTS))
def test_adapter_pool_matches_jax_step_by_step(script):
    kw, steps = POOL_SCRIPTS[script]
    jpool, tpool = _pools(**kw)
    jradix, tradix = [], []
    raised = 0
    for i, step in enumerate(steps):
        jr = _run_step(jpool, step, jradix)
        tr = _run_step(tpool, step, tradix)
        assert tr == jr, (script, i, step)
        raised += jr[0] == "raise"
        js, ts = _snapshot(jpool, False), _snapshot(tpool, True)
        for key in ("stats", "resident", "slots", "free", "refcounts",
                    "evictable"):
            assert ts[key] == js[key], (script, i, step, key)
        for k, want in js["tables"].items():
            np.testing.assert_array_equal(ts["tables"][k], want,
                                          err_msg=f"{script} step {i} {k}")
        jpool.check_invariants()
        tpool.check_invariants()
    # the scripts that exercise an error path really hit it
    expect_raise = {"register_validation": 2, "all_slots_pinned": 1,
                    "unfittable_no_slots": 1, "evict_cold_and_unknown": 1}
    assert raised == expect_raise.get(script, 0)


def test_adapter_pool_defaults_to_the_card():
    """With no ``device`` the pool resolves to cuda:0, as every entry of the
    port does; without CUDA that raises instead of running on the CPU."""
    kw = dict(slots=4, rank=2, hidden=8, num_layers=1, q_dim=8, v_dim=8,
              block_bytes=128, scale=2.0)
    if torch.cuda.is_available():
        pool = tadapters.AdapterPool(BlockedAllocator(4), **kw)
        assert pool.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tadapters.AdapterPool(BlockedAllocator(4), **kw)


def test_identity_slot_pages_and_scales():
    _, pool = _pools()
    pool.register(1)
    pool.ensure([1])
    t = pool.tables()
    for k in tadapters.PROJS:
        assert t[k].shape[1] == pool.slots and not t[k][:, 0].any()
        assert t[k][0].is_contiguous()          # a layer's view is a view
    assert float(t["scale"][0]) == 0.0
    assert float(t["scale"][pool.slot_of(1)]) == 2.0


def test_random_adapter_weights_equal_jax():
    want = jadapters.random_adapter_weights(2, 16, 4, 16, 8, seed=3,
                                            init_scale=0.5)
    got = tadapters.random_adapter_weights(2, 16, 4, 16, 8, seed=3,
                                           init_scale=0.5)
    assert set(got) == set(want) == set(tadapters.PROJS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------- (c)

MODEL = dict(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
             vocab_size=512, max_seq_len=256)


@pytest.fixture(scope="module")
def tree():
    cfg = JaxConfig.llama(**MODEL)
    boxed = jax.eval_shape(lambda r: GPTLogits(cfg).init(
        r, jnp.zeros((1, 8), jnp.int32)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.02).astype(np.float32),
        unbox(boxed["params"]))


@pytest.mark.parametrize("dtype,kv_quant", [("bf16", None), ("fp32", None),
                                            ("bf16", "int8")])
@pytest.mark.parametrize("rank", [4, 16])
def test_block_bytes_and_blocks_per_adapter_equal_jax(tree, dtype, kv_quant,
                                                      rank):
    sm = {"max_tracked_sequences": 4, "kv_block_size": 16}
    if kv_quant:
        sm["kv_quant"] = kv_quant
    config = {"dtype": dtype, "state_manager": sm,
              "adapters": {"enabled": True, "rank": rank, "alpha": 8.0,
                           "slots": 3}}
    jeng = JaxEngine(JaxConfig.llama(**MODEL), config=config, params=tree)
    tcfg = GPTConfig.llama(**MODEL)
    teng = InferenceEngineV2(
        tcfg, config=config, device="cpu",
        params=params_from_numpy(tree, dataclasses.replace(
            tcfg, dtype=torch.float32), "cpu", torch.float32))
    assert teng.kv_block_bytes() == jeng.kv_block_bytes()
    assert (teng.adapters.blocks_per_adapter
            == jeng.adapters.blocks_per_adapter)
    assert teng.adapters.scale == jeng.adapters.scale == 8.0 / rank
    assert teng.adapters.tables()["a_q"].dtype == teng.config.torch_dtype


# --------------------------------------------------------------------- (d)

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_lora_route_every_rank(dtype):
    """Every rank 1-256 is taken (the shape rules accept it); 16-bit x with
    r, H and O multiples of 8 takes the tensor-core pair, everything else
    the CUDA-core pair; the fp32 partials are [ceil(H / 256), M, r]."""
    for r in range(1, tlora.RANK_MAX + 1):
        x = torch.zeros((3, 64), dtype=dtype)
        a = torch.zeros((4, 64, r), dtype=dtype)
        b = torch.zeros((4, r, 24), dtype=dtype)
        args = (x, a, b, torch.zeros(3, dtype=torch.int32), torch.ones(4))
        assert tlora.shape_problem(*args) is None
        want = tlora.WGMMA if dtype != torch.float32 and r % 8 == 0 \
            else tlora.SIMT
        assert tlora.call_route(x, a, b) == want
        assert tlora.lora_route(dtype, 64, r, 24, 4) == want
    assert tlora.lora_scratch_shape(37, 4096, 16) == (16, 37, 16)
    assert tlora.lora_scratch_shape(1, 600, 8) == (3, 1, 8)


def test_lora_route_rules_and_refusals():
    """O, H not multiples of 8, more than 1024 slots or a misaligned tensor
    route to the CUDA cores; what the kernels refused before still
    raises."""
    bf = torch.bfloat16
    assert tlora.lora_route(bf, 4096, 16, 4096, 9) == tlora.WGMMA
    assert tlora.lora_route(bf, 4096, 16, 1020, 9) == tlora.SIMT
    assert tlora.lora_route(bf, 4092, 16, 4096, 9) == tlora.SIMT
    assert tlora.lora_route(bf, 4096, 16, 4096, 1024) == tlora.WGMMA
    assert tlora.lora_route(bf, 4096, 16, 4096, 1025) == tlora.SIMT
    assert tlora.lora_route(bf, 4096, 16, 4096, 9, aligned=False) \
        == tlora.SIMT
    x = torch.zeros((5, 64), dtype=bf)
    a = torch.zeros((4, 64, 16), dtype=bf)
    b = torch.zeros((4, 16, 24), dtype=bf)
    assert tlora.call_route(x.view(-1)[8:].view(4, 78)[:, :64].contiguous(),
                            a, b) == tlora.WGMMA
    assert tlora.call_route(x.view(-1)[1:257].view(4, 64), a, b) \
        == tlora.SIMT   # 2 bytes past an aligned base
    ids, s = torch.zeros(5, dtype=torch.int32), torch.ones(4)
    for bad, match in (
            ((x, torch.zeros((4, 64, 257), dtype=bf),
              torch.zeros((4, 257, 24), dtype=bf), ids, s), "rank"),
            ((x.double(), a.double(), b.double(), ids, s), "dtype"),
            ((x, a, b, ids.long(), s), "int32"),
            ((x, a, b.transpose(1, 2).contiguous().transpose(1, 2), ids, s),
             "contiguous"),
            ((x, a[:, :32], b, ids, s), "do not agree")):
        assert match in tlora.shape_problem(*bad)


def _tiles(ids, S, rows=64):
    """csrc/lora_matmul.cu's units, in Python: each slot's rows in row
    order, cut into tiles of 64 rows."""
    out = []
    for s in range(S):
        hit = np.flatnonzero(ids == s)
        out += [(s, hit[i:i + rows]) for i in range(0, len(hit), rows)]
    return out


def _kernel_order_lora(x, a, b, ids, scales):
    """The tensor-core pair's arithmetic in torch: per tile, fp32 partials
    of x . A[slot] over H chunks of ``H_CHUNK``, summed in ascending order,
    u cast to x's dtype, then u . B[slot] in fp32, scaled, cast once."""
    M, H = x.shape
    S, _, r = a.shape
    y = torch.full((M, b.shape[2]), float("nan"), dtype=x.dtype)
    for s, rows in _tiles(ids.numpy(), S):
        rows = torch.from_numpy(rows)
        u = None
        for h0 in range(0, H, tlora.H_CHUNK):
            part = x[rows, h0:h0 + tlora.H_CHUNK].float() \
                @ a[s, h0:h0 + tlora.H_CHUNK].float()
            u = part if u is None else u + part
        yy = (u.to(x.dtype).float() @ b[s].float()) * scales[s]
        y[rows] = yy.to(x.dtype)
    return y


CHUNKED_IDS = {   # M -> ids over slots 0..4 (slot 0 the identity)
    "M1": [2],
    "M37": None,                                   # random over 0..4
    "M65_slot_of_64": [0] + [2] * 64,
    "M130_slots_of_65_and_64": [1] * 65 + [0] + [3] * 64,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CHUNKED_IDS))
def test_chunked_partials_match_xla(case, dtype):
    """H 600 (three chunks, the last one short), r 16, O 40, 5 slots: the
    kernel's order of sums against ``xla_lora_matmul``; the tiles hold
    every valid row once, at most 64 a tile."""
    ids = CHUNKED_IDS[case]
    rng = np.random.default_rng(7)
    if ids is None:
        ids = rng.integers(0, 5, 37)
    ids = np.asarray(ids, np.int32)
    M = len(ids)
    x, a, b, _, scales = _op_case(S=5, M=M, H=600, R=16, O=40, seed=3)
    tiles = _tiles(ids, 5)
    assert sorted(np.concatenate([t for _, t in tiles]).tolist()) \
        == list(range(M))
    assert all(0 < len(t) <= 64 for _, t in tiles)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jlora.xla_lora_matmul(jnp.asarray(x, jdt), jnp.asarray(a, jdt),
                                 jnp.asarray(b, jdt), jnp.asarray(ids),
                                 jnp.asarray(scales))
    want = np.asarray(want.astype(jnp.float32))
    got = _kernel_order_lora(*(torch.from_numpy(t).to(tdt)
                               for t in (x, a, b)), torch.from_numpy(ids),
                             torch.from_numpy(scales))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert _row_rel(got.float(), want) <= tol     # slot 0 rows exactly 0
