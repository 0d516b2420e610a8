"""PyTorch port, the shapes the CUDA kernels take (ROADMAP C.1) and the
quantized product's launch plan, on the CPU:

- the flash, block-sparse and evoformer plain paths at the head dims the
  kernels now pad or route to their CUDA-core variants (flash 40, 80, 96,
  256; block-sparse block 8 at 40 and 80; evoformer 160 and 256), forward
  and gradients against the JAX package (its xla path, ``jax.grad``, and
  the evoformer's backward kernels in interpret mode), fp32: forward at
  1e-5, gradients at 1e-4 of each gradient's largest value (summation
  order only);
- each kernel family's shape rules (``shape_problem``), which look at no
  device: the calls they accept and the ones they refuse, naming C.1;
- a GPT with head dim 80 (Phi-2's) trained 2 steps by both engines from the
  same weights: loss and grad norm at 1e-5, and its config accepted by the
  CUDA rule that ``initialize`` applies, a head dim of 264 refused;
- ``wq_plan``, the wgmma products' split-K and ring plan (modes 0 / 2 and
  mode 1's swapped product): every split owns at least one K step, the
  splits cover K exactly, and the shared memory stays within the H100's
  227 KB a block;
- ``decode_plan``, the 16-bit paged decode's grid, ring and chunk size,
  and the device's cut of each slot's live pages into work items
  (mirrored here): every live page is in one item, a slot has at most 16
  of them (the partial buffers' capacity), and the shared memory fits;
- ``flash_fwd_plan`` / ``evo_fwd_plan``, the 16-bit forwards' tiles, Q
  slots and ring, ``flash_bwd_plan``, the 16-bit flash backward's (dq and
  dk/dv), and ``evo_bwd_plan``, the evoformer's 16-bit dk/dv and dbias2
  (tiles, ring, slots, and the chunks of MSA rows that split dbias2's
  walk): every head dim (and the evoformer's bias layouts and any S) gets
  one that fits the 227 KB, the evoformer's chunks partition the rows in
  ascending order, and the rules refuse a q / k / v that TMA cannot read
  (a stride or base not 16-byte aligned), naming the rule.

- ``prefill_route``, the route every ragged prefill call takes (query
  group 1 / 2 / 4 / 8, head dims 32-256, pages of 16-128 tokens, bf16 /
  fp16 / fp32 and int8 pages): the tensor-core kernel for 16-bit q at
  head dims 32-128, the CUDA cores otherwise, the refusals unchanged;
  ``prefill_scratch``, its partials; and the 16-bit prefill's schedule
  (csrc/prefill_hopper.cuh ``pf_schedule``, mirrored here): the chunks of
  each unit cover its visible pages once, in order, a walk is split only
  beyond 1.5 times the fair share, its chunks hold at least half the fair
  share and at most the fair share (or a 16th of the walk), at most 16 of
  them, every visible key of
  every live row lies in its unit's walk, the items come heaviest first,
  and the split walks' partials fit the 2 x grid slots allocated.

The kernels themselves are held to these plain paths on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu import ops as jops
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu_torch import ops as tops
from deepspeed_tpu_torch.models import gpt as tgpt

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

tfa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
tsp = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
jsp = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
tevo = importlib.import_module("deepspeed_tpu_torch.ops.evoformer")
jevo = importlib.import_module("deepspeed_tpu.ops.evoformer")
twq = importlib.import_module("deepspeed_tpu_torch.ops.wq_matmul")

FWD = dict(atol=1e-5, rtol=0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _assert_grads(got, want, names):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=f"d{name}")


# ------------------------------------------------------------------ flash

SLOPES = np.geomspace(0.5, 1 / 16, 4).astype(np.float32)
FLASH_DIMS = {
    "d40_gqa": (40, 4, 2, {}),
    "d80_window": (80, 4, 4, {"window": 9}),
    "d96_alibi": (96, 4, 2, {"alibi_slopes": SLOPES}),
    "d256_noncausal": (256, 2, 1, {"causal": False}),
}


@pytest.mark.parametrize("case", sorted(FLASH_DIMS))
def test_flash_head_dims_match_xla(case):
    """The flash path (plain versions through the autograd Function on CPU
    tensors) at head dims the kernels pad, against JAX's xla attention."""
    d, n, nkv, kw = FLASH_DIMS[case]
    rng = np.random.default_rng(d)
    q, k, v = _rand(rng, 2, 24, n, d), _rand(rng, 2, 24, nkv, d), \
        _rand(rng, 2, 24, nkv, d)
    fn = lambda *a: jops.causal_attention(*a, impl="xla", **kw)  # noqa: E731
    ref = np.asarray(fn(*map(jnp.asarray, (q, k, v))))
    gref = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, **kw)
    np.testing.assert_allclose(out.detach().numpy(), ref, **FWD)
    got = torch.autograd.grad(out.square().sum(), ts)
    _assert_grads([g.numpy() for g in got], gref, "qkv")


@pytest.mark.parametrize("d", [8, 40, 72, 80, 96, 104, 136, 200, 256])
def test_flash_head_dim_rule_accepts(d):
    assert tfa.head_dim_problem(d) is None


def _flash_tensors(d, dtype=torch.bfloat16, n=4, nkv=2, t=16):
    return (torch.zeros((2, t, n, d), dtype=dtype),
            torch.zeros((2, t, nkv, d), dtype=dtype),
            torch.zeros((2, t, nkv, d), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("d", [8, 40, 80, 96, 136, 256])
def test_flash_shape_rules_accept(d, dtype):
    """The rules alone (no device): CPU tensors of every head dim the
    kernels take pass; the wrapper still refuses them for their device."""
    q, k, v = _flash_tensors(d, dtype)
    assert tfa.shape_problem(q, k, v) is None
    assert "CUDA device" in tfa._problem(q, k, v)


@pytest.mark.parametrize("d", [4, 12, 44, 260, 264, 512])
def test_flash_shape_rules_refuse_head_dims(d):
    problem = tfa.shape_problem(*_flash_tensors(d))
    assert f"head_dim {d}" in problem and "C.1" in problem


def test_flash_shape_rules_refuse_layouts():
    q, k, v = _flash_tensors(80)
    assert "float32/float16/bfloat16" in tfa.shape_problem(
        q.double(), k.double(), v.double())
    assert "must divide" in tfa.shape_problem(q, k[:, :, :1].expand(
        2, 16, 3, 80).contiguous(), v[:, :, :1].expand(2, 16, 3, 80)
        .contiguous())
    wide = torch.zeros((2, 16, 4, 81), dtype=torch.bfloat16)[..., :80]
    assert "16-byte aligned" in tfa.shape_problem(wide, wide, wide)
    assert "causal" in tfa.shape_problem(q, k, v, causal=False, window=4)


# ------------------------------------------------------------ block-sparse

SPARSE8 = {
    "fixed": tsp.FixedSparsityConfig(block=8, num_local_blocks=2,
                                     num_global_blocks=1),
    "longformer": tsp.BSLongformerSparsityConfig(
        block=8, num_sliding_window_blocks=2, global_block_indices=(0,)),
    "bigbird": tsp.BigBirdSparsityConfig(block=8, num_random_blocks=1,
                                         num_sliding_window_blocks=2,
                                         num_global_blocks=1),
}


def _jax_cfg(cfg):
    import dataclasses
    return getattr(jsp, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("name", sorted(SPARSE8))
def test_sparse_block8_head_dims_match_jax(name, d, causal):
    """block_sparse_flash (the kernels' plain versions) at block 8 on the
    reference tests' layouts and head dims the CUDA-core family takes,
    against JAX's masked-dense op and jax.grad of it (GQA 4 over 2)."""
    cfg = SPARSE8[name]
    rng = np.random.default_rng(d)
    q, k, v = _rand(rng, 2, 64, 4, d), _rand(rng, 2, 64, 2, d), \
        _rand(rng, 2, 64, 2, d)
    fn = lambda *a: jsp.sparse_attention(  # noqa: E731
        *a, _jax_cfg(cfg), causal=causal, impl="xla")
    ref = np.asarray(fn(*map(jnp.asarray, (q, k, v))))
    gref = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tsp.block_sparse_flash(*ts, cfg, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), ref, **FWD)
    got = torch.autograd.grad(out.square().sum(), ts)
    _assert_grads([g.numpy() for g in got], gref, "qkv")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,d", [(8, 64), (8, 80), (24, 40), (16, 256),
                                     (128, 128), (64, 96), (192, 64)])
def test_sparse_shape_rules_accept(block, d, dtype):
    q, k, v = _flash_tensors(d, dtype, t=384)
    assert tsp.shape_problem(q, k, v, block) is None
    assert "CUDA device" in tsp._problem(q, k, v, block)


@pytest.mark.parametrize("block,d,t,what", [
    (4, 64, 384, "block 4"), (12, 64, 384, "block 12"),
    (20, 64, 380, "block 20"), (8, 264, 384, "head_dim 264"),
    (8, 36, 384, "head_dim 36")])
def test_sparse_shape_rules_refuse(block, d, t, what):
    problem = tsp.shape_problem(*_flash_tensors(d, t=t), block)
    assert what in problem and "C.1" in problem


def test_sparse_shape_rules_refuse_ragged_length():
    assert "not divisible" in tsp.shape_problem(
        *_flash_tensors(64, t=100), 8)


# --------------------------------------------------------------- evoformer

def _evo_inputs(D, S=16, seed=0, B=1, N=2, H=2):
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, B, N, S, H, D) for _ in range(3))
    b1 = _rand(rng, B, N, 1, 1, S)
    b1[:, 1, ..., -3:] = -1e9               # a masked tail on one row
    b2 = _rand(rng, B, 1, H, S, S)
    return q, k, v, b1, b2


@pytest.mark.parametrize("D", [160, 256])
def test_evoformer_wide_head_dims_match_jax(D):
    """The op and its gradients (dq, dk, dv, dbias1, dbias2 of sum(o²))
    against JAX's einsum path and jax.grad of it."""
    args = _evo_inputs(D)
    ja = [jnp.asarray(x) for x in args]
    ref = np.asarray(jevo._evoformer_xla(*ja))
    gref = jax.grad(lambda *a: jnp.sum(jevo._evoformer_xla(*a) ** 2),
                    argnums=(0, 1, 2, 3, 4))(*ja)
    ts = [torch.from_numpy(x).requires_grad_() for x in args]
    out = tops.evoformer_attention(*ts)
    np.testing.assert_allclose(out.detach().numpy(), ref, **FWD)
    got = torch.autograd.grad(out.square().sum(), ts)
    _assert_grads([g.numpy() for g in got], gref,
                  ("q", "k", "v", "bias1", "bias2"))


@pytest.mark.parametrize("D", [160, 256])
def test_evoformer_wide_plain_versions_match_jax_kernels(D):
    """torch_evoformer_fwd / torch_evoformer_bwd (the kernels' plain
    versions) against the reference's forward and backward kernels in
    interpret mode, the backward on the reference forward's o and lse."""
    q, k, v, b1, b2 = _evo_inputs(D, seed=1)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    ja = [jnp.asarray(x) for x in (q, k, v, b1, b2)]
    o_ref, lse_ref = jevo._fwd(*ja, True)
    o, lse = tevo.torch_evoformer_fwd(*map(torch.from_numpy,
                                           (q, k, v, b1, b2)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **FWD)
    B, N, S, H, _ = q.shape
    o_k = np.array(np.asarray(o_ref).reshape(B, N, H, S, D)
                   .transpose(0, 1, 3, 2, 4))
    np.testing.assert_allclose(o.numpy(), o_k, **FWD)
    want = jevo._bwd_impl(*ja, jnp.asarray(o_k), lse_ref, jnp.asarray(do),
                          True)
    got = tevo.torch_evoformer_bwd(
        *map(torch.from_numpy, (q, k, v, b1, b2)), torch.from_numpy(o_k),
        torch.from_numpy(np.array(lse_ref)), torch.from_numpy(do))
    want = [np.asarray(w).reshape(B, N, H, S, D).transpose(0, 1, 3, 2, 4)
            for w in want[:3]] + [np.asarray(w) for w in want[3:]]
    _assert_grads([g.numpy() for g in got], want,
                  ("q", "k", "v", "bias1", "bias2"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("D", [8, 32, 136, 160, 256])
def test_evoformer_shape_rules_accept(D, dtype):
    q = torch.zeros((1, 2, 13, 2, D), dtype=dtype)
    b1 = torch.zeros((1, 2, 1, 1, 13))
    assert tevo.shape_problem(q, q, q, b1, None) is None
    assert "CUDA device" in tevo._problem(q, q, q, b1, None)


@pytest.mark.parametrize("D", [4, 12, 264])
def test_evoformer_shape_rules_refuse(D):
    q = torch.zeros((1, 2, 13, 2, D), dtype=torch.bfloat16)
    problem = tevo.shape_problem(q, q, q)
    assert f"head_dim {D}" in problem and "C.1" in problem
    assert "float32, float16 or bfloat16" in tevo.shape_problem(
        q.double(), q.double(), q.double())
    assert "broadcast" in tevo.shape_problem(
        *(torch.zeros((1, 2, 13, 2, 16)),) * 3, torch.zeros(1, 2, 1, 1, 7))


@pytest.mark.parametrize("dtype,D,refused", [
    (torch.bfloat16, 32, True), (torch.float16, 128, True),
    (torch.float32, 32, False), (torch.bfloat16, 256, False)])
def test_evoformer_shape_rules_token_broadcast(dtype, D, refused):
    """q, k or v broadcast over tokens (token stride 0) is refused where
    the tensor-core kernels read it by TMA (16-bit, D up to 128) and taken
    by the CUDA-core kernels, which read through strides."""
    x = torch.zeros((1, 2, 13, 2, D), dtype=dtype)
    for i in range(3):
        qkv = [x, x, x]
        qkv[i] = x[:, :, :1].expand(x.shape)
        problem = tevo.shape_problem(*qkv)
        assert (problem is not None and "token stride of 0" in problem
                and "qkv"[i] in problem) if refused else problem is None
    # at S 1 the one token is the whole dim: taken
    one = x[:, :, :1].as_strided((1, 2, 1, 2, D), (4 * D, 2 * D, 0, D, 1))
    assert tevo.shape_problem(one, one, one) is None


# --------------------------------------------------- GPT at head dim 80

PHI2_LIKE = dict(num_layers=2, num_heads=2, head_dim=80, hidden_size=160,
                 mlp_ratio=2, vocab_size=256, max_seq_len=32, loss_chunk=24)
DS = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
      "optimizer": {"type": "AdamW",
                    "params": {"lr": 1e-3, "weight_decay": 0.1}},
      "gradient_clipping": 0.5, "zero_optimization": {"stage": 2},
      "steps_per_print": 0}


def test_head_dim_80_gpt_trains_like_jax():
    """Two train_batch steps of a GPT with Phi-2's head dim (80) from the
    same initial weights on both engines (fp32): loss and grad norm at
    1e-5 each step, then the trained weights held through eval_batch at
    1e-5.  (Element by element AdamW's m / sqrt(v) magnifies rounding where
    a gradient is near 0: one of wv's 25600 weights differs by 3.3e-5.)"""
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (4, 16)).astype(np.int32)}
               for _ in range(3)]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt.GPTChunkedLoss(jgpt.GPTConfig(**PHI2_LIKE)),
        config=dict(DS),
        example_batch={k: v[:2] for k, v in batches[0].items()},
        mesh=single_device_mesh())
    init = jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)),
        jeng.state.params)
    model = tgpt.GPTChunkedLoss(tgpt.GPTConfig(**PHI2_LIKE)).load_params(init)
    teng, *_ = dst.initialize(model=model, config=dict(DS), device="cpu")
    for b in batches[:2]:
        jm, tm = jeng.train_batch(b), teng.train_batch(b)
        assert abs(float(jm.loss) - tm.loss) <= 1e-5
        assert abs(float(jm.grad_norm) - tm.grad_norm) <= 1e-5
    assert abs(float(jeng.eval_batch(batches[2]))
               - float(teng.eval_batch(batches[2]))) <= 1e-5


def test_gpt_config_cuda_rule():
    """The CUDA rule ``initialize`` applies before building an engine on the
    card: Phi-2 (80), Phi-3-mini (96) and Gemma (256) head dims pass, 264
    and 44 are refused with the reason."""
    for d in (64, 80, 96, 128, 256):
        assert tgpt.GPTConfig(head_dim=d).cuda_problem() is None
    for d in (44, 264):
        problem = tgpt.GPTConfig(head_dim=d).cuda_problem()
        assert f"head_dim {d}" in problem and "C.1" in problem


# ------------------------------------------------------------ wq planner

SMS = 132
WQ_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (4096, 128256), (768, 768), (768, 2304), (3072, 768),
             (768, 50304), (4096, 1000), (80, 128), (16, 16)]


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("M", [1, 16, 17, 64, 65, 256, 300, 1024])
@pytest.mark.parametrize("K,N", WQ_SHAPES)
def test_wq_plan_covers_k_and_fits(K, N, M, mode):
    plan = twq.wq_plan(M, N, K, mode, torch.bfloat16, SMS)
    steps = -(-K // plan["kt"])
    splits, per = plan["splits"], plan["per"]
    assert splits >= 1 and per >= 1
    assert splits * per >= steps                # the splits cover K ...
    assert (splits - 1) * per < steps           # ... each owning a step
    if mode == 1:
        # the swapped wgmma kernel: x rows padded to a wgmma n, 64-deep
        # stages of x, the dequantized A tile, codes and scale rows, and
        # the epilogue's y rows; persistent blocks, so tiles may outnumber
        # the SMs, and split-K only where they do not
        np_ = twq.wt_rows(M)
        assert np_ in (16, 32, 64, 128) and (np_ >= M or np_ == 128)
        assert plan["kt"] == 64
        assert 3 <= plan["stages"] <= 8
        assert plan["smem"] <= twq.SMEM_PER_BLOCK
        assert plan["smem"] >= plan["stages"] * (
            np_ * 128 + 128 * 128 + 64 * 128 + 8 * 64 * 4) + np_ * 136 * 2
        tiles = -(-N // 128) * -(-M // np_)
        assert splits == 1 or tiles * splits <= SMS
        return
    assert plan["kt"] == 64
    assert 3 <= plan["stages"] <= 8
    assert plan["smem"] <= twq.SMEM_PER_BLOCK
    xrows = min(256, -(-M // 64) * 64)
    assert plan["smem"] >= plan["stages"] * (xrows * 128 + 128 * 128
                                             + 64 * 128 + 4 * 128 * 4)
    tiles = -(-N // 128) * -(-M // 256)
    assert splits == 1 or tiles * splits <= SMS  # one wave of blocks


def test_wq_plan_fp32_is_one_split():
    assert twq.wq_plan(16, 4096, 4096, 0, torch.float32, SMS)["splits"] == 1


# ------------------------------------------ the 16-bit paged decode's plan

tpa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")


def _decode_chunks(lens, bs, MB, window, cmin):
    """csrc/paged_attention.cu's work items for one kv head, in Python: each
    slot's live pages (pages wholly before the window are not) cut into
    chunks of max(cmin, ceil(n / 16)) pages, the last one fewer.  Returns
    per slot its list of chunks, each a list of (slot, logical page)."""
    slots = []
    for s, n in enumerate(lens):
        pages = min(-(-n // bs), MB)
        first = (max(n - window, 0) if window else 0) // bs
        live = max(pages - first, 0)
        cp = max(cmin, -(-live // 16))
        slots.append([[(s, first + p) for p in range(c, min(c + cp, live))]
                      for c in range(0, live, cp)])
    return slots


DECODE_SHAPES = [  # (S, nkv, g, hd, bs, page bytes)
    (16, 8, 4, 128, 64, 2), (16, 8, 4, 128, 64, 1), (1, 8, 4, 128, 64, 2),
    (5, 2, 8, 256, 128, 2), (5, 2, 1, 32, 16, 1), (300, 2, 2, 64, 16, 1),
    (7, 2, 4, 128, 256, 2), (4, 1, 8, 256, 16, 2), (64, 32, 1, 64, 32, 2)]


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_plan_covers_pages_and_fits(shape, window):
    """The work items cover every live page of every slot exactly once, in
    slot and page order; a slot is cut into at most 16 chunks (the partial
    buffers' capacity), each of at least the plan's ``chunk`` pages (256
    keys) but its last; the plan's ring fits the card's shared memory (two
    blocks an SM where two stages do, the deepest ring up to 8 otherwise,
    head dim 256 one an SM) and its grid is those blocks on every SM."""
    S, nkv, g, hd, bs, esize = shape
    plan = tpa.decode_plan(S, nkv, g, hd, bs, esize, SMS)
    assert 1 <= plan["stages"] <= 8 and plan["per_sm"] in (1, 2)
    assert plan["smem"] == tpa.decode_smem(S, g, hd, bs, esize,
                                           plan["stages"])
    assert plan["smem"] <= SMEM
    assert plan["per_sm"] * (plan["smem"] + 1024) <= 233472
    assert plan["per_sm"] == 1 or plan["stages"] >= 2
    assert plan["per_sm"] == 1 or hd < 256
    assert plan["blocks"] == plan["per_sm"] * SMS
    assert plan["chunk"] * bs >= 256 and (plan["chunk"] - 1) * bs < 256
    MB = 2048 // bs
    rng = np.random.default_rng(S + hd + bs)
    for lens in (rng.integers(0, MB * bs + 1, S), np.zeros(S, int),
                 np.full(S, MB * bs), np.arange(S) % 3):
        slots = _decode_chunks(lens, bs, MB, window, plan["chunk"])
        seen = [p for chunks in slots for c in chunks for p in c]
        want = []
        for s, n in enumerate(lens):
            lo = max(n - window, 0) if window else 0
            want += [(s, p) for p in range(lo // bs, -(-n // bs))]
        assert seen == want                       # each live page once
        for chunks in slots:
            assert len(chunks) <= tpa._DEC_MAX_CHUNKS
            assert all(len(c) >= plan["chunk"] for c in chunks[:-1])
            assert all(c for c in chunks)


# ------------------------------------- the 16-bit attention forward's plan

SMEM = 232448          # the H100's shared memory a block (227 KB, opt-in)


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_flash_fwd_plan_fits(d):
    """Every head dim the flash kernels take gets one block column: a
    compiled width that holds it (TMA's zero fill pads the rest), 128 or
    64 keys a tile, 1-2 Q slots and a ring of 2-8 stages in the card's
    shared memory."""
    plan = tfa.flash_fwd_plan(d)
    assert plan["hd_k"] >= d and plan["hd_k"] in (64, 96, 128, 192, 256)
    assert plan["hdp"] % 64 == 0 and plan["hdp"] >= plan["hd_k"]
    assert plan["bn"] == (128 if plan["hd_k"] <= 128 else 64)
    assert plan["qslots"] in (1, 2) and 2 <= plan["stages"] <= 8
    q_bytes = 128 * plan["hdp"] * 2
    assert plan["stage_bytes"] >= 2 * plan["bn"] * plan["hdp"] * 2
    assert plan["smem"] >= plan["qslots"] * q_bytes \
        + plan["stages"] * plan["stage_bytes"]
    assert plan["smem"] <= SMEM


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_flash_bwd_plan_fits(d):
    """Every head dim the flash kernels take gets one backward block column
    for dq and for dk/dv: a compiled width that holds it, 128 queries a dq
    unit with 128 keys a stage at width 64, 64 up to 192 and 32 at 256, 128
    keys a dk/dv unit (64 above 128, the column blocks split over the two
    warpgroups) with 128 queries (64 above width 64) and their lse and
    delta rows a stage (dq keeps its rows' delta
    a slot), 1-2 slots and a ring of 2-8 stages in the card's shared
    memory."""
    plan = tfa.flash_bwd_plan(d)
    assert plan["hd_k"] >= d and plan["hd_k"] in (64, 96, 128, 192, 256)
    assert plan["hd_k"] == tfa.flash_fwd_plan(d)["hd_k"]
    hdp = plan["hdp"]
    assert hdp % 64 == 0 and hdp >= plan["hd_k"]
    dq, dkv = plan["dq"], plan["dkv"]
    assert dq["rows"] == 128
    assert dq["bn"] == {64: 128, 256: 32}.get(plan["hd_k"], 64)
    assert dkv["split"] == (plan["hd_k"] > 128)
    assert dkv["keys"] == (64 if dkv["split"] else 128)
    assert dkv["bm"] == (128 if plan["hd_k"] == 64 else 64)
    # dq's slot holds its rows' delta, dk/dv's stage its q rows' lse, delta
    for k, slot_rows, ring_rows, slot_stats, ring_stats in (
            (dq, 128, dq["bn"], 128 * 4, 0),
            (dkv, dkv["keys"], dkv["bm"], 0, 2 * dkv["bm"] * 4)):
        assert k["slots"] in (1, 2) and 2 <= k["stages"] <= 8
        assert k["slot_bytes"] == 2 * slot_rows * hdp * 2 + slot_stats
        assert k["stage_bytes"] >= 2 * ring_rows * hdp * 2 + ring_stats
        assert k["stage_bytes"] % 1024 == 0
        assert k["smem"] >= k["slots"] * k["slot_bytes"] \
            + k["stages"] * k["stage_bytes"]
        assert k["smem"] <= SMEM
        # two slots only where a ring of three still fits beside them
        assert k["slots"] == 1 or k["stages"] >= 3


@pytest.mark.parametrize("bias2_bytes", [0, 2, 4])
@pytest.mark.parametrize("d", range(8, 129, 8))
def test_evo_fwd_plan_fits(d, bias2_bytes):
    """Every 16-bit head dim the evoformer's tensor-core forward takes, with
    bias2 absent, 16-bit or fp32, fits the card; the stage holds K, V, the
    [128, bn] bias2 tile and the bias1 slice (always: it masks the keys
    past S)."""
    plan = tevo.evo_fwd_plan(d, bias2_bytes)
    assert plan["hd_k"] >= d and plan["hd_k"] in (16, 32, 64, 128)
    assert plan["bn"] == (128 if plan["hd_k"] <= 64 else 64)
    assert plan["stage_bytes"] >= 2 * plan["bn"] * plan["hdp"] * 2 \
        + 128 * plan["bn"] * bias2_bytes + 4 * plan["bn"]
    assert plan["qslots"] in (1, 2) and 2 <= plan["stages"] <= 8
    assert plan["smem"] <= SMEM


@pytest.mark.parametrize("S", [1, 7, 64, 127, 128, 383, 384, 1000])
@pytest.mark.parametrize("D", [8, 32, 128])
def test_evoformer_any_length_takes_the_tensor_core_forward(S, D):
    """Any S (TMA zero-fills the ragged key and query tiles, the kernel
    masks the keys) at 16-bit head dims up to 128: the rules accept it and
    the plan does not depend on S."""
    q = torch.zeros((1, 2, S, 2, D), dtype=torch.bfloat16)
    b1 = torch.zeros((1, 2, 1, 1, S), dtype=torch.bfloat16)
    b2 = torch.zeros((1, 1, 2, S, S), dtype=torch.bfloat16)
    assert tevo.shape_problem(q, q, q, b1, b2) is None
    assert tevo.evo_fwd_plan(D)["smem"] <= SMEM


def test_tma_rule_refuses_misaligned_strides_and_bases():
    """q, k, v are read by TMA: a stride that is not a multiple of 16 bytes
    or a base that is not 16-byte aligned is refused by the rules, and the
    message names the rule."""
    wide = torch.zeros((2, 16, 4, 81), dtype=torch.bfloat16)[..., :80]
    assert "TMA's rule" in tfa.shape_problem(wide, wide, wide)
    flat = torch.zeros(2 * 16 * 4 * 80 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 16, 4, 80)
    problem = tfa.shape_problem(shifted, shifted, shifted)
    assert "TMA's rule" in problem and "base offset 2 bytes" in problem
    q = torch.zeros((1, 2, 13, 2, 33), dtype=torch.bfloat16)[..., :32]
    assert "TMA's rule" in tevo.shape_problem(q, q, q)


# ------------------------------------------ the evoformer's 16-bit backward

@pytest.mark.parametrize("bias2_bytes", [0, 2, 4])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 64, 72, 128])
def test_evo_bwd_plan_fits(d, bias2_bytes):
    """dk/dv and dbias2 at every compiled width (the forward's: 16, 32,
    64, 128) and bias2 width: the slot holds K, V and the bias1 slice, a
    dk/dv stage Q, dO, the [bm, 128] bias2 tile and the lse / delta rows
    (bm 64 up to width 64, 32 at 128), a dbias2 stage
    one row's Q, dO (128 queries), K, V (64 keys; rows of 64 bytes up to
    width 32) and its lse, delta and bias1 rows; 1-2 slots (two where two stages fit beside them), a ring of
    2-8 stages, 1024-byte aligned, in the card's shared memory."""
    plan = tevo.evo_bwd_plan(d, bias2_bytes, 1, 512, 384, 8)
    assert plan["hd_k"] == tevo.evo_fwd_plan(d)["hd_k"] >= d
    hdp = plan["hdp"]
    assert hdp == (64 if plan["hd_k"] <= 64 else 128)
    dkv, db2 = plan["dkv"], plan["db2"]
    assert dkv["keys"] == 128
    assert dkv["bm"] == (64 if plan["hd_k"] <= 64 else 32)
    assert dkv["slot_bytes"] >= 2 * 128 * hdp * 2 + 128 * 4
    assert dkv["stage_bytes"] >= 2 * dkv["bm"] * hdp * 2 \
        + dkv["bm"] * 128 * bias2_bytes + 2 * dkv["bm"] * 4
    assert (db2["queries"], db2["keys"]) == (128, 64)
    assert db2["row_bytes"] == (64 if plan["hd_k"] <= 32 else hdp * 2)
    assert db2["row_bytes"] >= 2 * plan["hd_k"]
    assert db2["stage_bytes"] >= 2 * 128 * db2["row_bytes"] \
        + 2 * 64 * db2["row_bytes"] + (2 * 128 + 64) * 4
    for k, slots in ((dkv, dkv["slots"]), (db2, 0)):
        assert 2 <= k["stages"] <= 8 and k["stage_bytes"] % 1024 == 0
        assert k["smem"] >= slots * k.get("slot_bytes", 0) \
            + k["stages"] * k["stage_bytes"]
        assert k["smem"] <= SMEM
    assert dkv["slot_bytes"] % 1024 == 0 and dkv["slots"] in (1, 2)
    # two slots only where two stages still fit beside them
    two = (SMEM - dkv["smem"] + dkv["slots"] * dkv["slot_bytes"]
           + dkv["stages"] * dkv["stage_bytes"] - 2 * dkv["slot_bytes"]) \
        // dkv["stage_bytes"]
    assert dkv["slots"] == (2 if two >= 2 else 1)


@pytest.mark.parametrize("bias2_bytes", [0, 2, 4])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 64, 72, 128])
def test_evo_bwd_plan_dq_fits(d, bias2_bytes):
    """dq at every compiled width and bias2 width: a slot holds Q, dO
    (128 queries) and their delta and lse rows, a stage K, V (64 keys),
    the [128, 64] bias2 tile and the keys' bias1 slice; 1-2 slots (two where two
    stages fit beside them), a ring of 2-8 stages, 1024-byte aligned, in
    the card's shared memory; the producer and consumer warpgroups'
    registers within the 384-thread block's 384 x 168, the consumers'
    accumulators (dq [64, hdp], s and dp [64, 64], ds packed) within
    theirs with room for addresses."""
    plan = tevo.evo_bwd_plan(d, bias2_bytes, 1, 512, 384, 8)
    dq, hdp = plan["dq"], plan["hdp"]
    assert (dq["queries"], dq["keys"]) == (128, 64)
    assert dq["slot_bytes"] % 1024 == 0 and dq["stage_bytes"] % 1024 == 0
    assert dq["slot_bytes"] >= 2 * 128 * hdp * 2 + 2 * 128 * 4
    assert dq["stage_bytes"] >= 2 * 64 * hdp * 2 + 128 * 64 * bias2_bytes \
        + 64 * 4
    assert 2 <= dq["stages"] <= 8 and dq["slots"] in (1, 2)
    fixed = dq["smem"] - dq["slots"] * dq["slot_bytes"] \
        - dq["stages"] * dq["stage_bytes"]
    assert 0 < fixed <= 2048 and dq["smem"] <= SMEM
    two = (SMEM - fixed - 2 * dq["slot_bytes"]) // dq["stage_bytes"]
    assert dq["slots"] == (2 if two >= 2 else 1)
    assert dq["units"] == 512 * 8 * 3
    regs = dq["regs"]
    assert 128 * regs["producer"] + 256 * regs["consumer"] <= 384 * 168
    assert regs["live"] == hdp // 2 + 64 + 16
    assert regs["live"] + 48 <= regs["consumer"]


@pytest.mark.parametrize("b,n,s,h", [(1, 512, 384, 8), (1, 384, 384, 4),
                                     (1, 1, 384, 8), (2, 37, 64, 2),
                                     (1, 5, 13, 2), (1, 1000, 16, 1),
                                     (2, 3, 1, 1), (1, 77, 1000, 3)])
def test_evo_bwd_plan_tiles_and_chunks(b, n, s, h):
    """The tiles cover S (dk/dv: 128-key units; dbias2: 128 x 64 query x
    key tiles), and dbias2's chunks partition [0, N) in ascending order,
    ``chunk_rows`` each but the last, as many as give about eight units an
    SM (never more than N); the partial buffer is [chunks, B, H, S, S]
    fp32.  N = 1, an N that no chunk divides, and the MSA call's N 512 /
    S 384 (8 chunks of 64 rows, 37.7 MB)."""
    plan = tevo.evo_bwd_plan(32, 2, b, n, s, h)
    dkv, db2 = plan["dkv"], plan["db2"]
    keys = -(-s // 128)
    assert (keys - 1) * 128 < s <= keys * 128
    assert dkv["units"] == b * n * h * keys
    tiles = -(-s // 128) * -(-s // 64)
    assert db2["units"] == b * h * tiles * db2["chunks"]
    rows, c = db2["rows"], db2["chunk_rows"]
    assert len(rows) == db2["chunks"] and 1 <= db2["chunks"] <= n
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(a[1] == b_[0] for a, b_ in zip(rows, rows[1:]))
    assert all(hi - lo == c for lo, hi in rows[:-1])
    assert 1 <= rows[-1][1] - rows[-1][0] <= c
    assert c == -(-n // db2["chunks"])
    assert db2["part_bytes"] == db2["chunks"] * b * h * s * s * 4
    want = min(n, -(-8 * tevo.H100_SMS // (b * h * tiles)))  # ~8 units an SM
    assert c == -(-n // want)
    if (b, n, s, h) == (1, 512, 384, 8):
        assert (db2["chunks"], c, db2["part_bytes"]) == (8, 64, 37748736)
    if n == 1:
        assert rows == ((0, 1),)


# ------------------------------------------- the ragged prefill's routes


def _prefill_call(g, hd, bs, pages, S=2, Q=3, nkv=1, MB=2):
    """CPU tensors of one prefill call: q of q's dtype, pages of ``pages``
    ('bf16', 'fp16', 'fp32' or 'int8' beside bf16 q)."""
    qdt = {"bf16": torch.bfloat16, "fp16": torch.float16,
           "fp32": torch.float32, "int8": torch.bfloat16}[pages]
    pdt = torch.int8 if pages == "int8" else qdt
    NB = S * MB
    q = torch.zeros((S, Q, nkv, g, hd), dtype=qdt)
    k = torch.zeros((NB, nkv, bs, hd), dtype=pdt)
    ints = [torch.zeros(S, dtype=torch.int32) for _ in range(3)]
    kw = {}
    if pages == "int8":
        kw = {"k_scale": torch.ones((NB, nkv, bs)),
              "v_scale": torch.ones((NB, nkv, bs))}
    bt = torch.zeros((S, MB), dtype=torch.int32)
    return (q, k, k.clone(), bt, *ints), kw


def _prefill_refused_before(hd, bs, pages, esize):
    """The shared-memory bound the op has refused beyond (csrc's CUDA-core
    prefill, and the int8 staging it was sized with)."""
    if pages == "int8":
        smem = 4 * bs * hd + 16 * bs + 2 * bs * (hd + 8) * esize
    else:
        smem = 4 * bs * hd * esize
    return smem > SMEM


@pytest.mark.parametrize("pages", ["bf16", "fp16", "fp32", "int8"])
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_prefill_route(g, hd, bs, pages):
    """16-bit q (pages of its type or int8) at head dims 32 / 64 / 128 with
    pages of a multiple of 16 tokens takes the tensor-core kernel; fp32 and
    head dim 256 the CUDA cores; the calls refused before still are."""
    args, kw = _prefill_call(g, hd, bs, pages)
    problem = tpa.prefill_shape_problem(*args, **kw)
    if _prefill_refused_before(hd, bs, pages, args[0].element_size()):
        assert "overflows shared memory" in problem
        return
    assert problem is None
    want = tpa.PREFILL_WGMMA if pages != "fp32" and hd <= 128 \
        else tpa.PREFILL_SIMT
    assert tpa.prefill_route(args[0].dtype, 2, 3, g, hd, bs) == want


def test_prefill_route_rules_and_refusals():
    """Page sizes that are not multiples of 16 or above 256, more than 1024
    slots or 1024 units, and misaligned int8 scales go to the CUDA cores;
    a head dim outside 32 / 64 / 128 / 256, a query group above 64 and
    fp64 q are refused as before."""
    bf = torch.bfloat16
    W, SIMT = tpa.PREFILL_WGMMA, tpa.PREFILL_SIMT
    assert tpa.prefill_route(bf, 16, 128, 4, 128, 64) == W
    assert tpa.prefill_route(bf, 16, 128, 4, 128, 48) == W
    assert tpa.prefill_route(bf, 16, 128, 4, 128, 256) == W
    assert tpa.prefill_route(bf, 16, 128, 4, 128, 8) == SIMT
    assert tpa.prefill_route(bf, 16, 128, 4, 128, 272) == SIMT
    assert tpa.prefill_route(bf, 1024, 128, 1, 128, 64) == W
    assert tpa.prefill_route(bf, 1025, 1, 1, 128, 64) == SIMT
    assert tpa.prefill_route(bf, 32, 1024, 4, 128, 64) == W     # 1024 units
    assert tpa.prefill_route(bf, 33, 1024, 4, 128, 64) == SIMT
    assert tpa.prefill_route(bf, 16, 128, 4, 128, 64, aligned=False) == SIMT
    for g, hd, pages, match in ((4, 96, "bf16", "head_dim"),
                                (65, 64, "bf16", "query group"),
                                (4, 512, "fp32", "head_dim")):
        args, kw = _prefill_call(g, hd, 16, pages)
        assert match in tpa.prefill_shape_problem(*args, **kw)
    args, kw = _prefill_call(4, 64, 16, "fp32")
    assert "dtype" in tpa.prefill_shape_problem(args[0].double(), *args[1:])
    grid, acc, ml = tpa.prefill_scratch(128, SMS)
    assert (grid, acc, ml) == (SMS, (2 * SMS, 128, 128), (2 * SMS, 128, 2))


def _pf_schedule(counts, starts, lens, Q, g, bs, MB, window, nkv, grid):
    """csrc/prefill_hopper.cuh's schedule, in Python: the units (slot,
    first token, walk pages [lp0, lp1), stages), the fair share F, each
    unit's (chunk size, chunks), the items in order and the split units'
    chunk bases."""
    tq = 128 // g
    units = []
    for s in range(len(counts)):
        c = min(max(int(counts[s]), 0), Q)
        for t0 in range(0, c, tq):
            qf, ql = starts[s] + t0, starts[s] + min(t0 + tq, c) - 1
            lo = max(qf - window + 1, 0) if window else 0
            hi = min(ql + 1, lens[s], MB * bs)
            if hi <= lo:
                units.append((s, t0, 0, 0, 0))
                continue
            lp0, lp1 = lo // bs, -(-hi // bs)
            st = (-(-(lp1 - lp0) // (64 // bs)) if bs <= 64
                  else (lp1 - lp0) * -(-bs // 64))
            units.append((s, t0, lp0, lp1, st))
    F = max(4, -(-sum(u[4] for u in units) * nkv // grid))

    def chunks(st):
        if 2 * st <= 3 * F:
            return st, 1
        nc = min(16, -(-st // F))
        cs = -(-st // nc)
        return cs, -(-st // cs)
    keys = [chunks(u[4])[0].bit_length() for u in units]
    order = sorted(range(len(units)), key=lambda u: (-keys[u], u))
    items = [(u, c, h) for u in order for c in range(chunks(units[u][4])[1])
             for h in range(nkv)]
    cbase, run = [], 0
    for u in units:
        cbase.append(run)
        nc = chunks(u[4])[1]
        run += nc if nc > 1 else 0
    return units, F, [chunks(u[4]) for u in units], keys, items, cbase, run


def _pf_stage_pages(bs, lp0, lp1, i):
    """The logical pages (and 64-row slice) stage i of a walk reads."""
    if bs <= 64:
        lp = lp0 + i * (64 // bs)
        return [(p, 0) for p in range(lp, min(lp + 64 // bs, lp1))]
    per = -(-bs // 64)
    return [(lp0 + i // per, i % per)]


PF_CASES = {   # counts, starts, kv_lens, Q, g, bs, MB, window, nkv, grid
    "main_mixed_step": (
        [0, 1, 1, 37, 128, 128, 5, 128, 64, 1, 128, 17, 128, 100, 128, 1],
        [0, 0, 62, 27, 0, 72, 506, 572, 936, 1023, 1172, 1519, 1649, 1900,
         1919, 2047],
        [0, 1, 63, 64, 128, 200, 511, 700, 1000, 1024, 1300, 1536, 1777,
         2000, 2047, 2048], 128, 4, 64, 32, 0, 8, 132),
    "long_decode_row": ([1, 3, 2], [8191, 10, 5], [8192, 13, 7], 4, 4, 64,
                        128, 0, 8, 132),
    "long_decode_small_grid": ([1, 40, 2], [4095, 10, 5], [4096, 50, 7], 64,
                               8, 16, 256, 0, 2, 8),
    "window_pages_128": ([70, 1, 0], [1000, 3000, 0], [1070, 3001, 0], 96,
                         1, 128, 24, 300, 2, 16),
    "pages_48_g2": ([33, 9], [100, 0], [133, 9], 40, 2, 48, 3, 0, 1, 4),
}


@pytest.mark.parametrize("case", sorted(PF_CASES))
def test_prefill_schedule_covers_walks(case):
    counts, starts, lens, Q, g, bs, MB, window, nkv, grid = PF_CASES[case]
    units, F, ch, keys, items, cbase, slots = _pf_schedule(
        counts, starts, lens, Q, g, bs, MB, window, nkv, grid)
    tq = 128 // g
    for (s, t0, lp0, lp1, st), (cs, nc) in zip(units, ch):
        assert 1 <= nc <= 16 and (nc == 1 or 2 * cs >= F)
        assert (nc == 1) == (2 * st <= 3 * F)
        assert nc == 1 or cs <= max(F, -(-st // 16))
        spans = [(c * cs, min(st, (c + 1) * cs)) for c in range(nc)]
        assert spans[0][0] == 0 and spans[-1][1] == st
        assert all(a < b for a, b in spans) or st == 0
        pages = [pg for a, b in spans for i in range(a, b)
                 for pg in _pf_stage_pages(bs, lp0, lp1, i)]
        per = -(-bs // 64) if bs > 64 else 1
        assert pages == [(p, k) for p in range(lp0, lp1) for k in range(per)]
        # every key a live row of the unit sees lies in the walk
        for t in range(t0, min(t0 + tq, min(counts[s], Q))):
            qpos = starts[s] + t
            seen = [k for k in range(min(lens[s], MB * bs)) if k <= qpos
                    and (not window or k > qpos - window)]
            assert all(lp0 * bs <= k < lp1 * bs for k in seen)
    assert [keys[u] for u, _, _ in items] == sorted(
        (keys[u] for u, _, _ in items), reverse=True)
    assert len(items) == nkv * sum(nc for _, nc in ch)
    # the split walks' (chunk, kv head) partials fit what the wrapper
    # allocates
    assert slots * nkv <= tpa.prefill_scratch(128, grid)[1][0]
    assert all(cbase[u] + ch[u][1] <= slots
               for u in range(len(units)) if ch[u][1] > 1)
    if case.startswith("long_decode"):
        assert max(nc for _, nc in ch) > 1     # the long walk is split
