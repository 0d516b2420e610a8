"""PyTorch port, evoformer attention: the op (the plain body on CPU tensors)
and the forward kernel's plain version (``torch_evoformer_fwd``, with its
logsumexp) held to the JAX package's einsum ground truth
(``_evoformer_xla``) and to its Pallas kernel in interpret mode, through
the reference's padding route for S that no block tiles; CPU gradients
(dq, dk, dv, dbias1, dbias2) held to ``jax.grad`` of the einsum path; the
backward kernels' plain version (``torch_evoformer_bwd``) held to the
reference's backward kernels in interpret mode on the same o and lse, the
bias gradients reduced to the callers' broadcast shapes (``_bias_grads``)
and the autograd Function's glue; and dbias2 summed as the 16-bit kernel
sums it (the MSA rows in the chunks of ``evo_bwd_plan``, each chunk one
row after another, the chunks added in order) held to both references.  Tolerances are stated per test.  The
CUDA kernels are held to the plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

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


# ------------------------------------------------------------------ backward
#
# Tolerances, per row (a row: the last dim; a row whose true value is ~0 is
# judged against 1% of the tensor's largest value): fp32 1e-5 of the row's
# largest value (summation order only), bf16 2e-2 (one bf16 rounding of ds,
# p and the output is 2^-8 of it).

BWD_TOL = {np.float32: 1e-5, jnp.bfloat16: 2e-2}
# Held end to end instead (each side runs its own forward), fp32 rows are
# held at 1e-4: o's rounding enters delta = rowsum(o·do), which cancels in
# dq — 2.2e-5 on a small dq row at S 13, where the reference's own kernel
# path and its einsum differ by nearly as much.
E2E_TOL = 1e-4


def _assert_rows(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    d = np.abs(got - want).max(-1)
    floor = 1e-2 * np.abs(want).max()
    row = d / np.maximum(np.abs(want).max(-1), floor)
    assert row.max() <= tol, (name, float(row.max()))


def _kernel_layout(x):
    """[B·N, H, S, D] (the JAX kernels' layout) → [B, N, S, H, D]."""
    return x.reshape(B, -1, *x.shape[1:]).transpose(0, 1, 3, 2, 4)


def _bwd_case(bias, D, S, dtype, seed=3):
    """Inputs, the JAX forward kernel's o and lse (interpret mode) and a
    seeded do, as numpy arrays in ``dtype`` (biases: fp32 bias1, bias2 in
    the inputs' dtype)."""
    q, k, v, b1, b2 = _inputs(S=S, D=D, bias=bias, seed=seed)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape)
    cast = [None if x is None else jnp.asarray(x, dtype)
            for x in (q, k, v, do)]
    jb1 = None if b1 is None else jnp.asarray(b1)
    jb2 = None if b2 is None else jnp.asarray(b2, dtype)
    o, lse = jevo._fwd(cast[0], cast[1], cast[2], jb1, jb2, True)
    return cast[:3] + [jb1, jb2], _kernel_layout(o), lse, cast[3]


def _to_torch(x):
    if x is None:
        return None
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,S", [(8, 24), (32, 64)])
@pytest.mark.parametrize("bias", ["none", "b1", "b2", "both"])
def test_plain_bwd_matches_jax_kernel(bias, D, S, dtype):
    """torch_evoformer_bwd against the reference's _bwd_impl in interpret
    mode, both fed the o and lse of the reference's _fwd: S 24 tiles by 8
    (a 3 x 3 grid of blocks), S 64 by 64."""
    args, o, lse, do = _bwd_case(bias, D, S, dtype)
    want = jevo._bwd_impl(*args, o, lse, do, True)
    want = [_kernel_layout(w) for w in want[:3]] + list(want[3:])
    got = tevo.torch_evoformer_bwd(*map(_to_torch, args), _to_torch(o),
                                   _to_torch(lse), _to_torch(do))
    for name, g, w in zip(("dq", "dk", "dv", "db1", "db2"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            if name in ("dq", "dk", "dv"):
                assert g.dtype == _to_torch(args[0]).dtype, name
            else:
                assert g.dtype == torch.float32, name
            _assert_rows(g.float().numpy(), np.asarray(w, np.float32),
                         BWD_TOL[dtype], name)


@pytest.mark.parametrize("bias", ["both", "b1", "b2", "none"])
def test_autograd_and_plain_bwd_match_jax_grad(bias):
    """All five gradients of PyTorch's autograd through
    ops.evoformer_attention on CPU tensors, and torch_evoformer_bwd on
    torch_evoformer_fwd's o and lse, against jax.vjp of _evoformer_xla
    with the same cotangent (fp32)."""
    args = _inputs(S=24, D=8, bias=bias, seed=5)
    do = np.random.default_rng(6).standard_normal(args[0].shape).astype(
        np.float32)
    live = [i for i, x in enumerate(args) if x is not None]
    jargs = _jnp(args)
    _, vjp = jax.vjp(lambda *a: jevo._evoformer_xla(
        *[a[live.index(i)] if i in live else None for i in range(5)]),
        *[jargs[i] for i in live])
    want = dict(zip(live, vjp(jnp.asarray(do))))
    ts = _torch(args, grad=True)
    tops.evoformer_attention(*ts).backward(torch.from_numpy(do))
    o, lse = tevo.torch_evoformer_fwd(*_torch(args))
    plain = tevo.torch_evoformer_bwd(*_torch(args), o, lse,
                                     torch.from_numpy(do))
    for i in live:
        name = ("dq", "dk", "dv", "db1", "db2")[i]
        _assert_rows(ts[i].grad.numpy(), want[i], 1e-5, "autograd " + name)
        _assert_rows(plain[i].numpy(), want[i], 1e-5, "plain " + name)


def test_masked_and_dead_rows_bwd():
    """A row with every key at -1e9 and a dead row (bias1 -1e30: lse -1e30,
    p = 0) give the reference kernel path's gradients; on the -1e9 row the
    autograd of the plain body gives _evoformer_xla's."""
    q, k, v, _, b2 = _inputs(S=24, D=8, bias="both", seed=7)
    b1 = np.zeros((B, N, 1, 1, 24), np.float32)
    b1[0, 1] = -1e9
    b1[1, 2] = -1e30
    args = [jnp.asarray(x) for x in (q, k, v, b1, b2)]
    o, lse = jevo._fwd(*args, True)
    assert float(lse[B * N - 1].max()) <= -1e30 / 2      # row (1, 2) is dead
    o = _kernel_layout(o)
    do = jnp.asarray(np.random.default_rng(8).standard_normal(q.shape),
                     jnp.float32)
    want = jevo._bwd_impl(*args, o, lse, do, True)
    want = [_kernel_layout(w) for w in want[:3]] + list(want[3:])
    got = tevo.torch_evoformer_bwd(*map(_to_torch, args), _to_torch(o),
                                   _to_torch(lse), _to_torch(do))
    for name, g, w in zip(("dq", "dk", "dv", "db1", "db2"), got, want):
        _assert_rows(g.numpy(), w, 1e-5, name)
    assert not got[0][1, 2].any() and not got[3][1, 2].any()  # dead: 0
    b1[1, 2] = 0.0                   # the -1e9 row alone, against the softmax
    ts = _torch((q, k, v, b1, b2), grad=True)
    tops.evoformer_attention(*ts).backward(_to_torch(do))
    ref = jax.vjp(jevo._evoformer_xla, *_jnp((q, k, v, b1, b2)))[1](do)
    for name, t, w in zip(("dq", "dk", "dv", "db1", "db2"), ts, ref):
        _assert_rows(t.grad.numpy(), w, 1e-5, "autograd " + name)


def _jax_op_grads(args, do):
    """jax.vjp of the reference op (kernel path, interpret mode; its own
    padding route) with respect to every input."""
    return jax.vjp(lambda *a: jevo.evoformer_attention(*a, interpret=True),
                   *_jnp(args))[1](jnp.asarray(do))


def _port_grads(args, do):
    """The card path's gradients computed with the plain backward: the
    op's padded problem where S needs it, torch_evoformer_fwd's o and lse,
    torch_evoformer_bwd, ``_bias_grads`` to the padded biases' shapes, and
    autograd through the padding and the callers' broadcasts."""
    leaves = _torch(args, grad=True)
    S0 = args[0].shape[2]
    pad = not tevo._tiles(*leaves[:3])
    prob = tevo._padded(*leaves) if pad else leaves
    flat = [t.detach() for t in prob]
    o, lse = tevo.torch_evoformer_fwd(*flat)
    dop = torch.nn.functional.pad(torch.from_numpy(do),
                                  (0, 0, 0, 0, 0, flat[0].shape[2] - S0))
    raw = tevo.torch_evoformer_bwd(*flat, o, lse, dop)
    grads = list(raw[:3]) + list(tevo._bias_grads(raw[3], raw[4], flat[3],
                                                  flat[4]))
    assert [g.shape for g in grads] == [t.shape for t in prob]
    torch.autograd.backward(prob, grads)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("S", [32, 13, 45])
def test_bias_grads_broadcast_and_padding_match_jax(S):
    """``_bias_grads`` reduces the fp32 bias gradients to the callers'
    shapes as the reference's autodiff of broadcast_to does: bias1
    [B, 1, 1, 1, S], bias2 [1, 1, H, S, S] broadcast over B; at S 13 and 45
    through the padding route (F.pad of the broadcast biases)."""
    args = _inputs(S=S, D=8, bias="broadcast", seed=9)
    do = np.random.default_rng(10).standard_normal(args[0].shape).astype(
        np.float32)
    want = _jax_op_grads(args, do)
    got = _port_grads(args, do)
    for name, g, w in zip(("dq", "dk", "dv", "db1", "db2"), got, want):
        assert g.shape == tuple(np.shape(w)), name
        _assert_rows(g.numpy(), w, E2E_TOL, name)
    b1, b2 = tevo._bias_grads(torch.ones(B, N, 1, 1, S),
                              torch.ones(B, 1, H, S, S),
                              torch.zeros(B, 1, 1, 1, S, dtype=torch.bfloat16),
                              torch.zeros(S, S))
    assert b1.dtype == torch.bfloat16 and b1.shape == (B, 1, 1, 1, S)
    assert torch.all(b1 == N) and b2.shape == (S, S) and torch.all(
        b2 == B * H)


def test_autograd_function_glue(monkeypatch):
    """_Evoformer's backward with the kernels' plain versions swapped in:
    a do of stride 0 (``.sum().backward()``) is made contiguous, a bias
    that needs no gradient gets none computed, and bias1 [B, 1, 1, 1, S]
    and bias2 expanded over B get the reference op's gradients."""
    seen = []

    def bwd(q, k, v, b1, b2, o, lse, do, db1=None, db2=None):
        seen.append((do.is_contiguous(), db1, db2))
        g = tevo.torch_evoformer_bwd(q, k, v, b1, b2, o, lse, do)
        return g[:3] + (g[3] if db1 else None, g[4] if db2 else None)
    monkeypatch.setattr(tevo, "cuda_evoformer_fwd", tevo.torch_evoformer_fwd)
    monkeypatch.setattr(tevo, "cuda_evoformer_bwd", bwd)
    q, k, v, b1, b2 = _inputs(S=32, D=8, bias="broadcast", seed=11)
    ts = _torch((q, k, v, b1, b2), grad=True)
    tevo._Evoformer.apply(*ts[:4], ts[4].expand(B, 1, H, 32, 32)).sum() \
        .backward()
    want = _jax_op_grads((q, k, v, b1, b2), np.ones(q.shape, np.float32))
    for name, t, w in zip(("dq", "dk", "dv", "db1", "db2"), ts, want):
        _assert_rows(t.grad.numpy(), w, E2E_TOL, name)
    ts2 = _torch((q, k, v, b1, b2))
    ts2[0].requires_grad_()
    tevo._Evoformer.apply(*ts2).sum().backward()
    assert seen == [(True, True, True), (True, False, False)]


@pytest.mark.parametrize("D,S", [(16, 13), (32, 64)])
def test_db2_chunked_sum_matches_jax(D, S):
    """dbias2 in the 16-bit kernel's fixed order: the per-row ds of the
    plain backward summed one row after another within each chunk of MSA
    rows that ``evo_bwd_plan`` makes (the H100's 132 SMs: one row a chunk
    here; one SM: chunks of 2, 2 and 1 rows), then the chunks' partials
    added in ascending order (``torch_evoformer_db2_part``,
    ``torch_evoformer_db2_sum``), on the op's problem (S 13 padded to 16 as
    the reference pads it) and the plain forward's o and lse.  Held in fp32
    at 1e-5 (summation order only) to the reference's kernel path,
    _bwd_impl in interpret mode on the same problem, o and lse, and, on the
    S x S block, to jax.vjp of _evoformer_xla; B 1, N 5, H 2, seeded with
    numpy."""
    rng = np.random.default_rng(12)
    b, n, h = 1, 5, 2
    q, k, v, do = (rng.standard_normal((b, n, S, h, D)).astype(np.float32)
                   for _ in range(4))
    b1 = rng.standard_normal((b, n, 1, 1, S)).astype(np.float32)
    b2 = rng.standard_normal((b, 1, h, S, S)).astype(np.float32)
    args = (q, k, v, b1, b2)
    want_xla = np.asarray(jax.vjp(jevo._evoformer_xla, *_jnp(args))[1](
        jnp.asarray(do))[4])
    ts = _torch(args)
    prob = tevo._padded(*ts) if not tevo._tiles(*ts[:3]) else ts
    sp = prob[0].shape[2]
    o, lse = tevo.torch_evoformer_fwd(*prob)
    dop = torch.nn.functional.pad(torch.from_numpy(do),
                                  (0, 0, 0, 0, 0, sp - S))
    want_kernel = jevo._bwd_impl(
        *[jnp.asarray(x.numpy()) for x in prob], jnp.asarray(o.numpy()),
        jnp.asarray(lse.numpy()), jnp.asarray(dop.numpy()), True)[4]
    splits = []
    for sms in (tevo.H100_SMS, 1):
        rows = tevo.evo_bwd_plan(D, 4, b, n, sp, h, sms)["db2"]["rows"]
        splits.append(rows)
        part = tevo.torch_evoformer_db2_part(*prob, o, lse, dop, rows)
        assert part.shape == (len(rows), b, h, sp, sp)
        got = tevo.torch_evoformer_db2_sum(part).reshape(b, 1, h, sp, sp)
        _assert_rows(got.numpy(), want_kernel, 1e-5, f"kernel path {rows}")
        _assert_rows(got[..., :S, :S].numpy(), want_xla, 1e-5, f"xla {rows}")
    assert splits == [tuple((r, r + 1) for r in range(n)),
                      ((0, 2), (2, 4), (4, 5))]


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, b1, b2 = _torch(_inputs(D=16))
    o, lse = tevo.torch_evoformer_fwd(q, k, v, b1, b2)
    with pytest.raises(ValueError, match="CUDA device"):
        tevo.cuda_evoformer_bwd(q, k, v, b1, b2, o, lse, torch.ones_like(o))
    f = tevo.cuda_evoformer_bwd
    assert (f.dq_launches, f.dkv_launches, f.db2_launches,
            f.db2_sum_launches, f.db1_launches) == (0, 0, 0, 0, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tevo.cuda_evoformer_db2_sum(torch.zeros((2, 1, 2, 4, 4)))
    assert f.db2_sum_launches == 0
