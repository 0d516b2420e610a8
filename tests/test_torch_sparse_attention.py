"""PyTorch port, block-sparse attention: the layouts, index tables and
sparsity ratios bit-equal to the JAX package's; the op's plain body, the
block-sparse plain versions (``torch_sparse_fwd`` / ``torch_sparse_bwd``,
reached through ``block_sparse_flash``'s autograd Function on CPU tensors)
held to JAX's ``sparse_attention(impl="xla")`` and its Pallas kernels run
in interpret mode.  fp32 on the CPU; forward at 1e-5, gradients of
``sum(o²)`` at 1e-4 of each gradient's largest value (summation order
only).  The CUDA kernels are held to the plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import ops as tops

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

jsp = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
tsp = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")

FWD = dict(atol=1e-5, rtol=0)

# name -> (port config, JAX config) at block 8 (T 64: 8 row blocks)
SMALL = {
    "dense": tsp.DenseSparsityConfig(block=8),
    "fixed": tsp.FixedSparsityConfig(block=8, num_local_blocks=2,
                                     num_global_blocks=1),
    "longformer": tsp.BSLongformerSparsityConfig(
        block=8, num_sliding_window_blocks=2, global_block_indices=(0,)),
    "bigbird": tsp.BigBirdSparsityConfig(block=8, num_random_blocks=1,
                                         num_sliding_window_blocks=2,
                                         num_global_blocks=1),
}
# every class at its defaults (block 16), BigBird with two seeds
DEFAULTS = {
    "dense": tsp.DenseSparsityConfig(),
    "fixed": tsp.FixedSparsityConfig(),
    "longformer": tsp.BSLongformerSparsityConfig(),
    "longformer_globals": tsp.BSLongformerSparsityConfig(
        global_block_indices=(0, 5, 9)),
    "bigbird_seed0": tsp.BigBirdSparsityConfig(),
    "bigbird_seed7": tsp.BigBirdSparsityConfig(seed=7, num_random_blocks=2),
}


def _jax_cfg(cfg):
    return getattr(jsp, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _qkv(n, nkv, seed=0, b=2, t=64, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, n, d)).astype(np.float32),
            rng.standard_normal((b, t, nkv, d)).astype(np.float32),
            rng.standard_normal((b, t, nkv, d)).astype(np.float32))


# ------------------------------------------------------------ layouts

@pytest.mark.parametrize("T", [64, 256, 1024])
@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_layout_bit_equal_to_jax(name, T):
    cfg = DEFAULTS[name]
    got, want = cfg.make_layout(T), _jax_cfg(cfg).make_layout(T)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsp.expand_layout_mask(got, cfg.block),
                                  jsp.expand_layout_mask(want, cfg.block))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_layout_tables_and_ratio_equal_jax(name, causal):
    cfg = DEFAULTS[name]
    lay = cfg.make_layout(512)
    for got, want in zip(tsp._layout_tables(lay, causal),
                         jsp._layout_tables(lay, causal)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tsp.sparsity_ratio(cfg, 512, causal) == jsp.sparsity_ratio(
        _jax_cfg(cfg), 512, causal)


def test_bad_block_size_raises():
    with pytest.raises(ValueError, match="divisible"):
        tsp.FixedSparsityConfig(block=7).make_layout(32)
    q, k, v = (torch.zeros((1, 36, 2, 8)) for _ in range(3))
    with pytest.raises(ValueError, match="divisible"):
        tops.sparse_attention(q, k, v, tsp.FixedSparsityConfig(block=8))


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_forward_matches_jax(name, heads, causal):
    """The op (plain body on CPU tensors) and block_sparse_flash (the
    kernels' plain versions) against JAX's masked-dense op and its Pallas
    kernel in interpret mode."""
    cfg = SMALL[name]
    q, k, v = _qkv(*heads)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = np.asarray(jsp.sparse_attention(jq, jk, jv, _jax_cfg(cfg),
                                          causal=causal, impl="xla"))
    ref_kernel = np.asarray(jsp.block_sparse_flash(
        jq, jk, jv, _jax_cfg(cfg), causal=causal, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tops.sparse_attention(tq, tk, tv, cfg, causal=causal).numpy()
    got_flash = tsp.block_sparse_flash(tq, tk, tv, cfg,
                                       causal=causal).numpy()
    np.testing.assert_allclose(got, ref, **FWD)
    np.testing.assert_allclose(got_flash, ref, **FWD)
    np.testing.assert_allclose(got_flash, ref_kernel, **FWD)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_numpy_logsumexp(causal):
    """JAX exposes no sparse lse: hold torch_sparse_fwd's to a numpy
    logsumexp of the masked dense logits."""
    cfg = SMALL["bigbird"]
    q, k, v = _qkv(4, 2)
    lay = cfg.make_layout(64)
    _, lse = tsp.torch_sparse_fwd(*map(torch.from_numpy, (q, k, v)), lay,
                                  cfg.block, causal)
    mask = tsp.expand_layout_mask(lay, cfg.block, causal)
    kr = np.repeat(k, 2, axis=2)
    s = np.einsum("btnd,bsnd->bnts", q.astype(np.float64),
                  kr.astype(np.float64)) * 16 ** -0.5
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (2, 4, 1, 64) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy()[:, :, 0], want, **FWD)


# ------------------------------------------------------------ backward

def _jax_grads(cfg, causal, q, k, v):
    fn = lambda *a: jsp.sparse_attention(*a, _jax_cfg(cfg), causal=causal,  # noqa: E731
                                         impl="xla")
    return [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


def _assert_grads(got, want):
    for name, a, b in zip("qkv", got, want):
        tol = 1e-4 * float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=tol, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_gradients_match_jax(name, causal):
    """dq, dk, dv of block_sparse_flash through autograd on the CPU, and of
    torch_sparse_bwd called directly, against jax.grad of the masked-dense
    path (GQA 4 q heads over 2 kv heads)."""
    cfg = SMALL[name]
    q, k, v = _qkv(4, 2, seed=1)
    want = _jax_grads(cfg, causal, q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tsp.block_sparse_flash(*ts, cfg, causal=causal)
    got = torch.autograd.grad(o.square().sum(), ts)
    _assert_grads([g.numpy() for g in got], want)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    lay = cfg.make_layout(64)
    o, lse = tsp.torch_sparse_fwd(tq, tk, tv, lay, cfg.block, causal)
    direct = tsp.torch_sparse_bwd(tq, tk, tv, o, lse, 2 * o, lay, cfg.block,
                                  causal)
    _assert_grads([g.numpy() for g in direct], want)


# ------------------------------------------- split walks and their merges

# name -> config on the tensor-core route's blocks (T 256): the H100 plans
# of these small calls split every walk of more than one stage (the
# forward's stages hold 128 keys, so each config has walks longer than that)
SPLIT = {
    "dense": tsp.DenseSparsityConfig(block=32),
    "fixed": tsp.FixedSparsityConfig(block=16, num_local_blocks=2),
    "longformer": tsp.BSLongformerSparsityConfig(
        block=16, global_block_indices=(0, 5, 9)),
    "bigbird": tsp.BigBirdSparsityConfig(block=16),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(SPLIT))
def test_split_merges_equal_unsplit_and_jax(name, causal):
    """The forward's and dq's split walks as the card runs them
    (``sparse_q_plan``'s tasks on an H100, each chunk's fp32 partial made by
    the plain ``torch_sparse_q_parts``), merged by the plain combine / sum
    (``torch_sparse_fwd_combine``, ``torch_sparse_dq_merge``, chunks in
    order), equal the unsplit plain forward and dq (``torch_sparse_fwd`` /
    ``torch_sparse_bwd``) on every merged row, and those equal JAX's
    ``_sparse_xla`` and ``jax.grad`` of ``sum(o²)``: fp32 (B 2, T 256, 4 q
    over 2 kv heads, D 16), o and lse at 1e-5, dq at 1e-4 of its largest
    value (summation order only)."""
    cfg = SPLIT[name]
    q, k, v = _qkv(4, 2, seed=2, t=256)
    ref = np.asarray(jsp.sparse_attention(
        *map(jnp.asarray, (q, k, v)), _jax_cfg(cfg), causal=causal,
        impl="xla"))
    want_dq = _jax_grads(cfg, causal, q, k, v)[0]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    lay = cfg.make_layout(256)
    o, lse = tsp.torch_sparse_fwd(tq, tk, tv, lay, cfg.block, causal)
    dq = tsp.torch_sparse_bwd(tq, tk, tv, o, lse, 2 * o, lay, cfg.block,
                              causal)[0]
    np.testing.assert_allclose(o.numpy(), ref, **FWD)
    _assert_grads([dq.numpy()], [want_dq])
    part, ml = tsp.torch_sparse_q_parts("fwd", tq, tk, tv, lay, cfg.block,
                                        causal)
    o2, lse2 = tsp.torch_sparse_fwd_combine(part, ml, torch.zeros_like(o),
                                            torch.zeros_like(lse), lay,
                                            cfg.block, causal, 2)
    dpart = tsp.torch_sparse_q_parts("dq", tq, tk, tv, lay, cfg.block,
                                     causal, o=o, lse=lse, do=2 * o)
    dq2 = tsp.torch_sparse_dq_merge(dpart, torch.zeros_like(dq), lay,
                                    cfg.block, causal, 2)

    def merged(dq_plan):
        """the rows the forward's (dq's) merges write"""
        plan = tsp._call_q_plan(lay, cfg.block, causal, tq, 2, dq=dq_plan)[0]
        assert plan["parts"] > 0 and len(plan["merges"]) > 0
        rows = np.zeros((2, 256, 4), bool)
        for _, _, b, heads, pos, _ in tsp._merged_rows(plan, 2, 2):
            rows[b, pos, heads] = True
        return rows

    mf, mq = merged(False), merged(True)
    m = torch.from_numpy(mf)
    np.testing.assert_allclose(o2[m].numpy(), o[m].numpy(), **FWD)
    np.testing.assert_allclose(o2[m].numpy(), ref[mf], **FWD)
    assert (o2[~m] == 0).all()
    lm = m.permute(0, 2, 1)
    np.testing.assert_allclose(lse2[:, :, 0][lm].numpy(),
                               lse[:, :, 0][lm].numpy(), **FWD)
    m = torch.from_numpy(mq)
    tol = 1e-4 * float(np.abs(want_dq).max())
    np.testing.assert_allclose(dq2[m].numpy(), dq[m].numpy(), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(dq2[m].numpy(), want_dq[mq], atol=tol,
                               rtol=0)
    assert (dq2[~m] == 0).all()


# ------------------------------------------------------------ edge cases

class _NoDiagonal(tsp.SparsityConfig):
    """Row block 1 sees only column block 2: under causal it sees no key."""

    def make_layout(self, seq_len):
        lay = np.tril(np.ones((seq_len // self.block,) * 2, bool))
        lay[1] = False
        lay[1, 2] = True
        return lay


class _JaxNoDiagonal(jsp.SparsityConfig):
    make_layout = _NoDiagonal.make_layout


def test_dead_row_gives_zeros_and_neg_lse():
    cfg = _NoDiagonal(block=8)
    q, k, v = _qkv(4, 2)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tsp.block_sparse_flash(*ts, cfg)
    assert torch.all(o[:, 8:16] == 0)
    _, lse = tsp.torch_sparse_fwd(*(t.detach() for t in ts),
                                  cfg.make_layout(64), 8, True)
    assert torch.all(lse[:, :, 0, 8:16] == -1e30)
    assert torch.all(lse[:, :, 0, :8] > -1e29)
    dq, _, _ = torch.autograd.grad(o.square().sum(), ts)
    assert torch.all(dq[:, 8:16] == 0)
    ref = np.asarray(jsp.block_sparse_flash(
        *map(jnp.asarray, (q, k, v)), _JaxNoDiagonal(block=8),
        interpret=True))
    np.testing.assert_allclose(o.detach().numpy(), ref, **FWD)


def test_dropout_takes_the_plain_body():
    """The kernels have no probability dropout: a call with ``dropout_fn``
    is the masked-dense plain body, equal to JAX's with the same mask."""
    cfg = SMALL["fixed"]
    q, k, v = _qkv(2, 2)
    keep = (np.random.default_rng(3).random((2, 2, 64, 64)) > 0.2) * 1.25
    ref = np.asarray(jsp.sparse_attention(
        *map(jnp.asarray, (q, k, v)), _jax_cfg(cfg), impl="xla",
        dropout_fn=lambda p: p * jnp.asarray(keep, p.dtype)))
    got = tops.sparse_attention(
        *map(torch.from_numpy, (q, k, v)), cfg,
        dropout_fn=lambda p: p * torch.from_numpy(keep).to(p.dtype))
    np.testing.assert_allclose(got.numpy(), ref, **FWD)
    plain = tops.sparse_attention(*map(torch.from_numpy, (q, k, v)), cfg)
    assert not np.allclose(got.numpy(), plain.numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    cfg = SMALL["fixed"]
    q, k, v = map(torch.from_numpy, _qkv(4, 2))
    lay = cfg.make_layout(64)
    assert not tsp.block_sparse_supported(q, k, v, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        tsp.cuda_sparse_fwd(q, k, v, lay, cfg.block)
    assert tsp.cuda_sparse_fwd.launches == 0
    assert "sparse_attention" in tops.op_report()
