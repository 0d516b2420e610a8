"""PyTorch port, training attention: the plain body (``_attention_torch``)
and the flash plain versions (``torch_flash_fwd`` / ``torch_flash_bwd``,
reached through the autograd Function on CPU tensors) held to the JAX
package's ``causal_attention(impl="xla")`` and, in one case, to its Pallas
kernels run in interpret mode.  fp32 on the CPU; forward at 1e-5, gradients
of ``sum(out²)`` at 1e-4 (summation order only).  The CUDA kernels are held
to the plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import ops as jops
from deepspeed_tpu_torch import ops as tops

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

# the modules (both ops/__init__ re-export a function of the same name)
tfa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("deepspeed_tpu.ops.flash_attention")

FWD = dict(atol=1e-5, rtol=1e-5)
BWD = dict(atol=1e-4, rtol=1e-4)

B, T, D = 2, 48, 16
SLOPES4 = np.geomspace(0.5, 1 / 16, 4).astype(np.float32)

# name -> (q heads, kv heads, attention kwargs)
CASES = {
    "causal": (4, 4, {}),
    "gqa": (4, 2, {}),
    "window": (4, 4, {"window": 9}),
    "alibi": (4, 4, {"alibi_slopes": SLOPES4}),
    "alibi_window_gqa": (4, 2, {"alibi_slopes": SLOPES4, "window": 13}),
    "noncausal": (4, 4, {"causal": False}),
}


def _qkv(n, nkv, seed=0, b=B, t=T, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, n, d)).astype(np.float32),
            rng.standard_normal((b, t, nkv, d)).astype(np.float32),
            rng.standard_normal((b, t, nkv, d)).astype(np.float32))


def _jax_out_and_grads(fn, q, k, v):
    out = fn(*map(jnp.asarray, (q, k, v)))
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_out_and_grads(fn, q, k, v):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out.square().sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_body_matches_xla(case):
    n, nkv, kw = CASES[case]
    q, k, v = _qkv(n, nkv)
    ref, gref = _jax_out_and_grads(
        lambda *a: jops.causal_attention(*a, impl="xla", **kw), q, k, v)
    out, g = _torch_out_and_grads(
        lambda *a: tops._attention_torch(*a, **kw), q, k, v)
    np.testing.assert_allclose(out, ref, **FWD)
    for a, b in zip(g, gref):
        np.testing.assert_allclose(a, b, **BWD)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_plain_versions_match_xla(case):
    """torch_flash_fwd forward, and torch_flash_bwd through the autograd
    Function (which takes the plain versions for CPU tensors)."""
    n, nkv, kw = CASES[case]
    q, k, v = _qkv(n, nkv, seed=1)
    ref, gref = _jax_out_and_grads(
        lambda *a: jops.causal_attention(*a, impl="xla", **kw), q, k, v)
    o, lse = tfa.torch_flash_fwd(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(o.numpy(), ref, **FWD)
    assert lse.shape == (B, n, 1, T) and lse.dtype == torch.float32 \
        and lse.is_contiguous()
    out, g = _torch_out_and_grads(
        lambda *a: tfa.flash_attention(*a, **kw), q, k, v)
    np.testing.assert_allclose(out, ref, **FWD)
    for a, b in zip(g, gref):
        np.testing.assert_allclose(a, b, **BWD)


def test_dispatch_on_cpu_is_the_plain_body():
    q, k, v = map(torch.from_numpy, _qkv(4, 2, seed=2))
    torch.testing.assert_close(tops.causal_attention(q, k, v),
                               tops._attention_torch(q, k, v))
    assert "causal_attention" in tops.op_report()


@pytest.mark.parametrize("form", ["mask", "bias", "mask_bias"])
def test_mask_and_bias_forms_match_xla(form):
    q, k, v = _qkv(4, 2, seed=3)
    rng = np.random.default_rng(4)
    mask = rng.random((B, T, T)) < 0.6
    mask[:, :, 0] = True
    bias = rng.standard_normal((1, 4, 1, T)).astype(np.float32)
    jkw, tkw = {"causal": False}, {"causal": False}
    if "mask" in form:
        jkw["mask"], tkw["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if "bias" in form:
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    ref, gref = _jax_out_and_grads(
        lambda *a: jops.causal_attention(*a, impl="xla", **jkw), q, k, v)
    out, g = _torch_out_and_grads(
        lambda *a: tops.causal_attention(*a, **tkw), q, k, v)
    np.testing.assert_allclose(out, ref, **FWD)
    for a, b in zip(g, gref):
        np.testing.assert_allclose(a, b, **BWD)


def test_fully_masked_row_gives_zeros():
    """An all-False mask row gives zeros (not NaN) on both sides, and its
    gradients stay finite."""
    q, k, v = _qkv(4, 4, seed=5)
    mask = np.tril(np.ones((T, T), bool))[None].repeat(B, 0)
    mask[:, 7, :] = False
    ref, gref = _jax_out_and_grads(
        lambda *a: jops.causal_attention(*a, impl="xla", causal=False,
                                         mask=jnp.asarray(mask)), q, k, v)
    out, g = _torch_out_and_grads(
        lambda *a: tops.causal_attention(*a, causal=False,
                                         mask=torch.from_numpy(mask)),
        q, k, v)
    assert np.all(out[:, 7] == 0.0) and np.all(ref[:, 7] == 0.0)
    np.testing.assert_allclose(out, ref, **FWD)
    for a, b in zip(g, gref):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **BWD)


def test_flash_dead_rows_zero_with_finite_lse():
    """Rows that see no key (here: a non-causal call cannot make one, so
    the plain version is driven with an empty visibility by hand) give
    zeros, lse -1e30, and no gradient."""
    q, k, v = map(torch.from_numpy, _qkv(2, 2, seed=6, t=8))
    real = tfa._visible
    try:
        def no_first_rows(t, causal, window, device):
            ok = real(t, causal, window, device)
            ok[:2] = False
            return ok
        tfa._visible = no_first_rows
        o, lse = tfa.torch_flash_fwd(q, k, v)
        dq, dk, dv = tfa.torch_flash_bwd(q, k, v, o, lse, torch.ones_like(o))
    finally:
        tfa._visible = real
    assert torch.all(o[:, :2] == 0) and torch.all(lse[..., :2] == tfa.NEG_INF)
    assert torch.isfinite(lse).all() and torch.all(dq[:, :2] == 0)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


def test_against_pallas_interpret():
    """o, lse and the three gradients against the TPU kernels in interpret
    mode, at the shape tests/test_ops.py runs them (B 2, T 128, N 4, D 64)."""
    q, k, v = _qkv(4, 4, seed=7, t=128, d=64)
    ref, gref = _jax_out_and_grads(
        lambda *a: jops.flash_attention(*a, interpret=True), q, k, v)
    out, g = _torch_out_and_grads(tfa.flash_attention, q, k, v)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)
    for a, b in zip(g, gref):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3)
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))  # noqa: E731
    _, lse_ref = jfa._fwd(tr(q), tr(k), tr(v), jnp.zeros((4,), jnp.float32),
                          True, 64 ** -0.5, None, False, True)
    _, lse = tfa.torch_flash_fwd(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-5,
                               rtol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = map(torch.from_numpy, _qkv(4, 4, d=64))
    assert not tfa.supported(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.cuda_flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.cuda_flash_dq(q, k, v, q, torch.zeros(B, 4, 1, T), q)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.cuda_flash_dkv(q, k, v, q, torch.zeros(B, 4, 1, T), q)
