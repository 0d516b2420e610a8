"""PyTorch port, quantized serving ops: the weight stores, the quantized
matmuls' plain versions and the int8-KV attention variants held to the JAX
package on the same inputs on the CPU.

(a) ``quantize_weight`` (dims 0 and 1, groups 16..128), ``quantize_weight4``,
    nibble packing, ``dequantize_weight*`` and ``quantize_kv_token`` are
    bit-equal to JAX in fp32 and bf16;
(b) ``torch_wq_matmul`` / ``_t`` / ``4`` match JAX's ``wq_matmul`` /
    ``wq_matmul_t`` / ``wq_matmul4`` (Pallas interpret mode where the TPU
    kernel takes the store, its dequantize fallback otherwise) and JAX's
    dequantize-then-matmul at 1e-5 in fp32;
(c) ``torch_paged_attention`` / ``torch_ragged_prefill`` with int8 pages and
    scale pools match ``xla_paged_attention`` / ``xla_ragged_prefill`` with
    ``k_scale`` / ``v_scale`` at 1e-5 (window and alibi included);
(d) registry dispatch of the new ops, and the CUDA wrappers' refusals.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.model import \
    quantize_kv_token as jax_quantize_kv_token
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu.ops import wq_matmul as jwq
from deepspeed_tpu.ops.paged_attention import (xla_paged_attention,
                                               xla_ragged_prefill)
from deepspeed_tpu_torch import ops as tops
from deepspeed_tpu_torch.inference.v2.model import quantize_kv_token
from deepspeed_tpu_torch.ops import quantization as tq

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

twq = importlib.import_module("deepspeed_tpu_torch.ops.wq_matmul")
tpa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")

TOL = dict(atol=1e-5, rtol=1e-5)   # fp32 both sides; summation order only
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
GROUPS = (16, 32, 64, 128)


def _pair(a, dtype):
    """The same values in both frameworks (bf16: rounded the same way)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) \
        if a.dtype == jnp.bfloat16 else np.asarray(a)


def _weights(seed, shape):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[0] = 0.0                      # an all-zero group: scale 0, codes 0
    return w


class TestStores:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("dim", [0, 1])
    @pytest.mark.parametrize("group", GROUPS)
    def test_quantize_weight_bit_equal(self, dtype, dim, group):
        w = _weights(group + dim, (256, 128, 3))
        jw, tw = _pair(w, dtype)
        want = jq.quantize_weight(jw, bits=8, group=group, dim=dim)
        got = tq.quantize_weight(tw, bits=8, group=group, dim=dim)
        assert got["v"].dtype == torch.int8 and got["s"].dtype == torch.float32
        np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
        assert tq._store_dim(got) == jq._store_dim(want)
        for out in ("fp32", "bf16"):
            jd, td = DTYPES[out]
            np.testing.assert_array_equal(
                _np(tq.dequantize_weight(got, td)),
                _jnp(jq.dequantize_weight(want, jd)))

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("group", GROUPS)
    def test_quantize_weight4_bit_equal(self, dtype, group):
        w = _weights(7 * group, (256, 96))
        jw, tw = _pair(w, dtype)
        want = jq.quantize_weight4(jw, group=group)
        got = tq.quantize_weight4(tw, group=group)
        assert tq.is_quantized_weight4(got) and got["v4"].shape == (128, 96)
        np.testing.assert_array_equal(got["v4"].numpy(),
                                      np.asarray(want["v4"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
        for out in ("fp32", "bf16"):
            jd, td = DTYPES[out]
            np.testing.assert_array_equal(
                _np(tq.dequantize_weight4(got, td)),
                _jnp(jq.dequantize_weight4(want, jd)))

    def test_nibbles_round_trip(self):
        rng = np.random.default_rng(1)
        q = rng.integers(-7, 8, (64, 5)).astype(np.int8)
        packed = tq.pack_nibbles(torch.from_numpy(q))
        np.testing.assert_array_equal(packed.numpy(),
                                      np.asarray(jq.pack_nibbles(q)))
        lo, hi = tq.unpack_nibbles(packed)
        np.testing.assert_array_equal(lo.numpy(), q[0::2])
        np.testing.assert_array_equal(hi.numpy(), q[1::2])
        # every byte value, against JAX's unpacking
        every = np.arange(-128, 128, dtype=np.int8)
        for a, b in zip(tq.unpack_nibbles(torch.from_numpy(every)),
                        jq.unpack_nibbles(jnp.asarray(every))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_quantize_kv_token_bit_equal(self, dtype):
        rng = np.random.default_rng(2)
        x = (rng.standard_normal((9, 3, 64)) * 2).astype(np.float32)
        x[1, 2] = 0.0               # an all-zero row: scale clamps to 1e-8
        jx, tx = _pair(x, dtype)
        wq, ws = jax_quantize_kv_token(jx)
        gq, gs = quantize_kv_token(tx)
        assert gq.dtype == torch.int8 and gs.dtype == torch.float32
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))

    def test_weight_group_size_and_predicates(self):
        for n in (1, 8, 16, 24, 48, 50257, 50304, 768, 4096, 14336):
            for group in (16, 64, 128, 256):
                assert tq.weight_group_size((n,), group) == \
                    jq.weight_group_size((n,), group)
        store = tq.quantize_weight(torch.ones(32, 4))
        assert tq.is_quantized_weight(store)
        assert not tq.is_quantized_weight4(store)
        assert tq.quantized_codes(store) is store["v"]
        assert tq.quantized_codes(torch.ones(2)) is None
        with pytest.raises(ValueError, match="group"):
            tq.quantize_weight(torch.ones(24, 4), group=8)
        with pytest.raises(ValueError, match="odd"):
            tq.quantize_weight4(torch.ones(33, 4))


def _store(mode, group, k, n, seed=3):
    """The same store in both packages: mode 'w8' [k, n], 'w8t' [n, k]
    (a tied table [V, H] grouped along V), 'w4' nibble-packed [k, n]."""
    if mode == "w8t":
        w = _weights(seed, (n, k))
    else:
        w = _weights(seed, (k, n))
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if mode == "w4":
        return jq.quantize_weight4(jw, group=group), \
            tq.quantize_weight4(tw, group=group)
    return jq.quantize_weight(jw, group=group), \
        tq.quantize_weight(tw, group=group)


JAX_FN = {"w8": (jwq.wq_matmul, lambda s, dt: jq.dequantize_weight(s, dt)),
          "w8t": (jwq.wq_matmul_t,
                  lambda s, dt: jq.dequantize_weight(s, dt).T),
          "w4": (jwq.wq_matmul4, lambda s, dt: jq.dequantize_weight4(s, dt))}
TORCH_FN = {"w8": twq.torch_wq_matmul, "w8t": twq.torch_wq_matmul_t,
            "w4": twq.torch_wq_matmul4}


class TestPlainMatmuls:
    @pytest.mark.parametrize("mode", sorted(JAX_FN))
    @pytest.mark.parametrize("group", GROUPS)
    def test_plain_matches_jax(self, mode, group):
        k, n, m = 256, 200, 13        # odd M, N not a multiple of a tile
        if mode == "w8t":
            n = 384                   # V: a multiple of every group
        jstore, tstore = _store(mode, group, k, n, seed=group)
        x = np.random.default_rng(4).standard_normal((m, k)).astype(
            np.float32)
        kernel, dequant = JAX_FN[mode]
        got = TORCH_FN[mode](torch.from_numpy(x), tstore).numpy()
        want = np.asarray(kernel(jnp.asarray(x), jstore))
        np.testing.assert_allclose(got, want, **TOL)
        ref = np.asarray(jnp.asarray(x) @ dequant(jstore, jnp.float32))
        np.testing.assert_allclose(got, ref, **TOL)

    def test_store_as_2d_matches_jax(self):
        w = _weights(5, (128, 4, 32))
        # q/k/v [H, heads, hd] grouped on dim 0; attention out [heads, hd,
        # H] grouped on dim 1 (g = hd = 32)
        for dim, w in ((0, w), (1, _weights(6, (4, 32, 128)))):
            js = jq.quantize_weight(jnp.asarray(w), group=128, dim=dim)
            ts = tq.quantize_weight(torch.from_numpy(w), group=128, dim=dim)
            jv, tv = jwq.store_as_2d(js), twq.store_as_2d(ts)
            for key in ("v", "s"):
                np.testing.assert_array_equal(tv[key].numpy(),
                                              np.asarray(jv[key]))
            assert tv["v"].data_ptr() == ts["v"].data_ptr()   # a view
        w4 = tq.quantize_weight4(torch.from_numpy(_weights(5, (128, 4, 32))))
        assert twq.store_as_2d(w4)["v4"].shape == (64, 128)
        assert twq.store_as_2d(tq.quantize_weight(torch.ones(64, 8))) is None

    def test_dispatch_and_refusals(self):
        """CPU tensors take the plain version through the registry; the
        CUDA wrappers refuse CPU tensors and launch nothing."""
        _, store = _store("w8", 64, 128, 32)
        _, store4 = _store("w4", 64, 128, 32)
        _, store_t = _store("w8t", 64, 128, 256)
        x = torch.randn(5, 128)
        before = (twq.cuda_wq_matmul.launches, twq.cuda_wq_matmul4.launches,
                  twq.cuda_wq_matmul_t.launches)
        torch.testing.assert_close(tops.wq_any(x, store),
                                   twq.torch_wq_matmul(x, store),
                                   rtol=0, atol=0)
        torch.testing.assert_close(tops.wq_any(x, store4),
                                   twq.torch_wq_matmul4(x, store4),
                                   rtol=0, atol=0)
        torch.testing.assert_close(tops.wq_matmul_t(x, store_t),
                                   twq.torch_wq_matmul_t(x, store_t),
                                   rtol=0, atol=0)
        for fn, st in ((twq.cuda_wq_matmul, store),
                       (twq.cuda_wq_matmul4, store4),
                       (twq.cuda_wq_matmul_t, store_t)):
            with pytest.raises(ValueError, match="not a CUDA device"):
                fn(x, st)
        assert (twq.cuda_wq_matmul.launches, twq.cuda_wq_matmul4.launches,
                twq.cuda_wq_matmul_t.launches) == before
        assert "wq_matmul4" in tops.op_report()


# ---- int8-KV attention (the int8 variants of kernels #1 and #2)

S, NKV, G, HD, NB, BS, MB, Q = 4, 2, 2, 32, 24, 8, 4, 8


def _int8_pages(rng):
    """int8 pages + scale pools made the engine's way: quantize_kv_token of
    random K/V rows (both packages give the same codes, see TestStores)."""
    k = rng.standard_normal((NB, NKV, BS, HD)).astype(np.float32)
    v = rng.standard_normal((NB, NKV, BS, HD)).astype(np.float32)
    kq, ks = quantize_kv_token(torch.from_numpy(k))
    vq, vs = quantize_kv_token(torch.from_numpy(v))
    bt = rng.permutation(NB)[:S * MB].reshape(S, MB).astype(np.int32)
    return kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(), bt


VARIANTS = {"plain": {}, "window5": {"window": 5},
            "alibi": {"alibi": True}, "alibi_window": {"alibi": True,
                                                       "window": 9}}


def _kw(variant, torch_side):
    kw = dict(VARIANTS[variant])
    if kw.pop("alibi", False):
        sl = np.geomspace(0.5, 1 / 256, NKV * G).astype(np.float32)
        kw["alibi_slopes"] = torch.from_numpy(sl) if torch_side \
            else jnp.asarray(sl)
    return kw


class TestInt8KV:
    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_paged_decode_matches_xla(self, variant):
        rng = np.random.default_rng(6)
        q = rng.standard_normal((S, NKV, G, HD)).astype(np.float32)
        kq, vq, ks, vs, bt = _int8_pages(rng)
        lens = np.array([0, 5, 2 * BS, MB * BS], np.int32)
        args = (q, kq, vq, bt, lens)
        want = xla_paged_attention(*map(jnp.asarray, args),
                                   k_scale=jnp.asarray(ks),
                                   v_scale=jnp.asarray(vs),
                                   **_kw(variant, False))
        got = tpa.torch_paged_attention(*map(torch.from_numpy, args),
                                        k_scale=torch.from_numpy(ks),
                                        v_scale=torch.from_numpy(vs),
                                        **_kw(variant, True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_ragged_prefill_matches_xla(self, variant):
        rng = np.random.default_rng(7)
        q = rng.standard_normal((S, Q, NKV, G, HD)).astype(np.float32)
        kq, vq, ks, vs, bt = _int8_pages(rng)
        counts = np.array([0, 1, 5, Q], np.int32)
        lens = np.array([0, 19, 14, Q], np.int32)
        args = (q, kq, vq, bt, lens, lens - counts, counts)
        want = xla_ragged_prefill(*map(jnp.asarray, args),
                                  k_scale=jnp.asarray(ks),
                                  v_scale=jnp.asarray(vs),
                                  **_kw(variant, False))
        got = tpa.torch_ragged_prefill(*map(torch.from_numpy, args),
                                       k_scale=torch.from_numpy(ks),
                                       v_scale=torch.from_numpy(vs),
                                       **_kw(variant, True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_registry_and_wrapper_checks(self):
        rng = np.random.default_rng(8)
        q = torch.from_numpy(rng.standard_normal((S, NKV, G, HD)).astype(
            np.float32))
        kq, vq, ks, vs, bt = map(torch.from_numpy, _int8_pages(rng))
        lens = torch.tensor([0, 5, 16, 32], dtype=torch.int32)
        before = tpa.cuda_paged_attention.int8_launches
        got = tops.paged_attention(q, kq, vq, bt, lens, k_scale=ks,
                                   v_scale=vs)
        torch.testing.assert_close(got, tpa.torch_paged_attention(
            q, kq, vq, bt, lens, k_scale=ks, v_scale=vs), rtol=0, atol=0)
        assert tpa.cuda_paged_attention.int8_launches == before
        assert "CUDA" in tpa._decode_problem(q, kq, vq, bt, lens,
                                             k_scale=ks, v_scale=vs)
        with pytest.raises(ValueError, match="int8"):
            tpa.torch_ragged_prefill(q[:, None], kq, vq, bt, lens, lens - 1,
                                     torch.ones_like(lens))
        with pytest.raises(ValueError, match="int8"):
            tpa.torch_paged_attention(q, kq.float(), vq.float(), bt, lens,
                                      k_scale=ks, v_scale=vs)
