"""PyTorch port, evoformer attention: the op (the plain body on CPU tensors)
and the forward kernel's plain version (``torch_evoformer_fwd``, with its
logsumexp) held to the JAX package's einsum ground truth
(``_evoformer_xla``) and to its Pallas kernel in interpret mode, through
the reference's padding route for S that no block tiles; CPU gradients
(dq, dk, dv, dbias1, dbias2) held to ``jax.grad`` of the einsum path — the
numbers the evoformer backward kernels are to be held to.  fp32 on the
CPU; forward at 1e-5, gradients at 1e-4 of each gradient's largest value.
The CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import ops as tops

jevo = importlib.import_module("deepspeed_tpu.ops.evoformer")
tevo = importlib.import_module("deepspeed_tpu_torch.ops.evoformer")

FWD = dict(atol=1e-5, rtol=0)
B, N, H = 2, 3, 2


def _inputs(S=32, D=8, bias="both", seed=0):
    """q, k, v [B, N, S, H, D] and the biases of ``bias``: "both", "b1",
    "b2", "none", or "broadcast" (bias1 [B, 1, 1, 1, S] shared over N,
    bias2 [1, 1, H, S, S] shared over B)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, N, S, H, D)).astype(np.float32)
               for _ in range(3))
    b1_shape, b2_shape = (B, N, 1, 1, S), (B, 1, H, S, S)
    if bias == "broadcast":
        b1_shape, b2_shape = (B, 1, 1, 1, S), (1, 1, H, S, S)
    b1 = rng.standard_normal(b1_shape).astype(np.float32)
    b2 = rng.standard_normal(b2_shape).astype(np.float32)
    if bias in ("b2", "none"):
        b1 = None
    if bias in ("b1", "none"):
        b2 = None
    return q, k, v, b1, b2


def _jnp(xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _torch(xs, grad=False):
    return [None if x is None else torch.from_numpy(x).requires_grad_(grad)
            for x in xs]


@pytest.mark.parametrize("bias", ["both", "b1", "b2", "none", "broadcast"])
@pytest.mark.parametrize("D", [8, 16])
def test_matches_jax(D, bias):
    args = _inputs(D=D, bias=bias)
    ref = np.asarray(jevo._evoformer_xla(*_jnp(args)))
    ref_kernel = np.asarray(jevo.evoformer_attention(*_jnp(args),
                                                     interpret=True))
    got = tops.evoformer_attention(*_torch(args)).numpy()
    assert got.shape == (B, N, 32, H, D)
    np.testing.assert_allclose(got, ref, **FWD)
    np.testing.assert_allclose(got, ref_kernel, **FWD)
    np.testing.assert_allclose(tevo.torch_evoformer(*_torch(args)).numpy(),
                               ref, **FWD)


@pytest.mark.parametrize("bias", ["both", "none", "broadcast"])
def test_fwd_and_lse_match_jax_kernel(bias):
    """torch_evoformer_fwd against JAX's _fwd in interpret mode: o (in JAX's
    [B·N, H, S, D] kernel layout) and lse [B·N, H, 1, S]."""
    q, k, v, b1, b2 = _inputs(D=16, bias=bias)
    o_ref, lse_ref = jevo._fwd(*_jnp((q, k, v, b1, b2)), True)
    o, lse = tevo.torch_evoformer_fwd(*_torch((q, k, v, b1, b2)))
    assert lse.shape == (B * N, H, 1, 32) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **FWD)
    o_k = o.permute(0, 1, 3, 2, 4).reshape(B * N, H, 32, 16)
    np.testing.assert_allclose(o_k.numpy(), np.asarray(o_ref), **FWD)


@pytest.mark.parametrize("S", [13, 45])
def test_padding_route_matches_jax(S):
    """S that no block tiles pads to a multiple of 8 (below 32) or 32 on
    both sides; the padded keys are masked, the padded rows sliced off."""
    args = _inputs(S=S, bias="both")
    assert not jevo.supported(*_jnp(args[:3]))
    ref = np.asarray(jevo.evoformer_attention(*_jnp(args), interpret=True))
    got = tops.evoformer_attention(*_torch(args)).numpy()
    assert got.shape == (B, N, S, H, 8)
    np.testing.assert_allclose(got, ref, **FWD)
    np.testing.assert_allclose(
        got, np.asarray(jevo._evoformer_xla(*_jnp(args))), **FWD)


def test_mask_bias_excludes_keys():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1, 4, 1, 4))
                                .astype(np.float32)) for _ in range(3))
    bias1 = torch.zeros((1, 1, 1, 1, 4))
    bias1[..., -1] = -1e9
    out = tops.evoformer_attention(q, k, v, bias1)
    want = tops.evoformer_attention(q, k[:, :, :-1], v[:, :, :-1])
    np.testing.assert_allclose(out.numpy(), want.numpy(), **FWD)
    ref = jevo.evoformer_attention(*_jnp((q.numpy(), k.numpy(), v.numpy(),
                                          bias1.numpy())), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


def test_fully_masked_row_and_dead_row():
    """Every key at -1e9 softmaxes over the rounded logits as JAX does; a
    row whose logits are all -1e30 gives o = 0 and lse = -1e30 (the
    kernels' guard)."""
    q, k, v, _, b2 = _inputs(D=8, bias="both")
    b1 = np.zeros((B, N, 1, 1, 32), np.float32)
    b1[0, 1] = -1e9
    ref = np.asarray(jevo._evoformer_xla(*_jnp((q, k, v, b1, b2))))
    got = tops.evoformer_attention(*_torch((q, k, v, b1, b2))).numpy()
    np.testing.assert_allclose(got, ref, **FWD)
    b1[0, 1] = -1e30
    o, lse = tevo.torch_evoformer_fwd(*_torch((q, k, v, b1, None)))
    assert torch.all(o[0, 1] == 0) and torch.all(lse[1] == -1e30)
    lse_ref = jevo._fwd(*_jnp((q, k, v, b1, None)), True)[1]
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **FWD)


def test_rank_check():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="B, N, S, H, D"):
        tops.evoformer_attention(x, x, x)


def test_einsum_shapes_take_the_plain_body_on_cpu():
    """head dim 4 (not a multiple of 8): the reference's einsum route; on
    CPU tensors the plain body, equal to JAX's."""
    args = _inputs(S=16, D=4, bias="both")
    ref = np.asarray(jevo.evoformer_attention(*_jnp(args), interpret=True))
    got = tops.evoformer_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(got, ref, **FWD)
    assert not tevo.supported(*_torch(args))


@pytest.mark.parametrize("bias", ["both", "broadcast"])
def test_gradients_match_jax(bias):
    """dq, dk, dv, dbias1, dbias2 of sum(o²) through PyTorch's autograd on
    the CPU against jax.grad of _evoformer_xla."""
    args = _inputs(D=16, bias=bias, seed=2)
    want = jax.grad(lambda *a: jnp.sum(jevo._evoformer_xla(*a) ** 2),
                    argnums=(0, 1, 2, 3, 4))(*_jnp(args))
    ts = _torch(args, grad=True)
    got = torch.autograd.grad(tops.evoformer_attention(*ts).square().sum(),
                              ts)
    for name, a, b in zip(("q", "k", "v", "bias1", "bias2"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=f"d{name}")


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _torch(_inputs(D=16))
    with pytest.raises(ValueError, match="CUDA device"):
        tevo.cuda_evoformer_fwd(*args)
    assert tevo.cuda_evoformer_fwd.launches == 0
    assert "evoformer_attention" in tops.op_report()
