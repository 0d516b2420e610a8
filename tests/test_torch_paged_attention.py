"""PyTorch port, paged-KV attention ops: the plain versions
(``torch_paged_attention`` / ``torch_ragged_prefill``) held to the JAX
package's ``xla_*`` ground truth and to its Pallas kernels run in interpret
mode, in fp32 on the CPU at tolerance 1e-5 (summation order only); the
registry's device dispatch; the CUDA wrappers' refusal of CPU tensors and
of int8 pages without their scales (the int8-KV variants are held to JAX in
tests/test_torch_quantization.py).  The CUDA kernels themselves are held to the plain versions
on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.paged_attention import (pallas_paged_attention,
                                               pallas_ragged_prefill,
                                               xla_paged_attention,
                                               xla_ragged_prefill)
from deepspeed_tpu_torch import ops as tops

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

# the module (ops/__init__ re-exports a function of the same name)
tpa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")

TOL = dict(atol=1e-5, rtol=1e-5)   # fp32 both sides; summation order only

# GQA: nkv=2 kv heads × g=2 query heads, head_dim 32 (the small llama
# config of the serving tests); distinct pages per slot, shuffled
S, NKV, G, HD, NB, BS, MB, Q = 4, 2, 2, 32, 24, 8, 4, 8


def _pages(rng):
    k = rng.standard_normal((NB, NKV, BS, HD)).astype(np.float32)
    v = rng.standard_normal((NB, NKV, BS, HD)).astype(np.float32)
    bt = rng.permutation(NB)[:S * MB].reshape(S, MB).astype(np.int32)
    return k, v, bt


def _decode_case(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, NKV, G, HD)).astype(np.float32)
    k, v, bt = _pages(rng)
    # inactive slot, partial page, exact page boundary, full table
    lens = np.array([0, 5, 2 * BS, MB * BS], np.int32)
    return q, k, v, bt, lens


def _prefill_case(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, Q, NKV, G, HD)).astype(np.float32)
    k, v, bt = _pages(rng)
    # dead slot; pure decode (1 row, long kv); prefill continuation (5 rows
    # after 9 cached); fresh full chunk (Q rows)
    counts = np.array([0, 1, 5, Q], np.int32)
    lens = np.array([0, 19, 14, Q], np.int32)
    return q, k, v, bt, lens, lens - counts, counts


def _slopes():
    return np.geomspace(0.5, 1 / 256, NKV * G).astype(np.float32)


VARIANTS = {
    "plain": {},
    "window3": {"window": 3},
    "window11": {"window": 11},
    "alibi": {"alibi": True},
    "alibi_window": {"alibi": True, "window": 6},
    "scale": {"scale": 0.37},
}


def _kw(variant, torch_side):
    kw = dict(VARIANTS[variant])
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = (torch.from_numpy(_slopes()) if torch_side
                              else jnp.asarray(_slopes()))
    return kw


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


class TestPlainVsJax:
    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_paged_decode_matches_xla(self, variant):
        case = _decode_case(1)
        want = xla_paged_attention(*_j(case), **_kw(variant, False))
        got = tpa.torch_paged_attention(*_t(case), **_kw(variant, True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_ragged_prefill_matches_xla(self, variant):
        case = _prefill_case(2)
        want = xla_ragged_prefill(*_j(case), **_kw(variant, False))
        got = tpa.torch_ragged_prefill(*_t(case), **_kw(variant, True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("variant", ["plain", "alibi_window"])
    def test_paged_decode_matches_pallas_interpret(self, variant):
        """The TPU kernel itself (interpret mode, standard layout)."""
        case = _decode_case(3)
        want = pallas_paged_attention(*_j(case), interpret=True,
                                      **_kw(variant, False))
        got = tpa.torch_paged_attention(*_t(case), **_kw(variant, True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("variant", ["plain", "alibi_window"])
    def test_ragged_prefill_matches_pallas_interpret(self, variant):
        case = _prefill_case(4)
        want = pallas_ragged_prefill(*_j(case), interpret=True,
                                     **_kw(variant, False))
        got = tpa.torch_ragged_prefill(*_t(case), **_kw(variant, True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_zero_length_and_dead_rows_are_zero(self):
        q, k, v, bt, lens = _t(_decode_case(5))
        out = tpa.torch_paged_attention(q, k, v, bt, lens)
        assert torch.count_nonzero(out[0]) == 0          # kv_len == 0
        args = _t(_prefill_case(6))
        out = tpa.torch_ragged_prefill(*args)
        assert torch.count_nonzero(out[0]) == 0          # dead slot
        assert torch.count_nonzero(out[1, 1:]) == 0      # rows past count

    def test_page_order_is_free(self):
        """Permuting the physical pages (and the table with them) leaves
        the result unchanged — nothing assumes monotone tables."""
        q, k, v, bt, lens = _decode_case(7)
        perm = np.random.default_rng(8).permutation(NB)
        inv = np.argsort(perm)
        a = tpa.torch_paged_attention(*_t((q, k, v, bt, lens)))
        b = tpa.torch_paged_attention(*_t((q, k[perm], v[perm],
                                           inv[bt].astype(np.int32), lens)))
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        case = _t(_decode_case(9))
        before = tpa.cuda_paged_attention.launches
        got = tops.paged_attention(*case)
        want = tpa.torch_paged_attention(*case)
        assert tpa.cuda_paged_attention.launches == before
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        args = _t(_prefill_case(10))
        before = tpa.cuda_ragged_prefill.launches
        got = tops.ragged_prefill_attention(*args)
        assert tpa.cuda_ragged_prefill.launches == before
        torch.testing.assert_close(got, tpa.torch_ragged_prefill(*args),
                                   rtol=0, atol=0)

    def test_forced_impls(self):
        """No implementation can be forced: dispatch goes by the tensors'
        device alone, and the kernel slot refuses CPU tensors."""
        case = _t(_decode_case(11))
        for impl in ("torch", "kernel", "pallas"):
            with pytest.raises(TypeError, match="impl"):
                tops.paged_attention(*case, impl=impl)
        spec = tops.registry._REGISTRY["paged_attention"]
        assert not spec.supported(*case)
        with pytest.raises(ValueError, match="not a CUDA device"):
            spec.kernel(*case)

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        with pytest.raises(ValueError, match="not a CUDA device"):
            tpa.cuda_paged_attention(*_t(_decode_case(12)))
        with pytest.raises(ValueError, match="not a CUDA device"):
            tpa.cuda_ragged_prefill(*_t(_prefill_case(13)))

    def test_int8_pages_raise(self):
        """int8 pages without their scale pools are refused."""
        q, k, v, bt, lens = _t(_decode_case(14))
        k8, v8 = k.to(torch.int8), v.to(torch.int8)
        with pytest.raises(ValueError, match="int8"):
            tpa.torch_paged_attention(q, k8, v8, bt, lens)
        assert "int8" in tpa._decode_problem(q, k8, v8, bt, lens)
        assert not tpa.supported(q, k8, v8, bt, lens)

    def test_op_report_lists_both_ops(self):
        rep = tops.op_report()
        assert "paged_attention" in rep and "ragged_prefill_attention" in rep
        assert "kernel" in rep

    def test_kernel_launch_geometry(self):
        """Host-side choices the kernels depend on: 64-row prefill tiles and
        a decode split count from shapes alone."""
        assert tpa.prefill_chunk(4) == 16 and tpa.prefill_chunk(2) == 32
        assert tpa.prefill_chunk(3) * 3 <= 64


class TestScatterLayout:
    def test_mixed_advanced_index_puts_indexed_dim_first(self):
        """``pool[page, :, off] = kv`` with kv [N, nkv, hd]: both frameworks
        put the advanced-indexed dim first — the paged KV append relies on
        it (inference/v2/model.py _write_kv)."""
        rng = np.random.default_rng(15)
        pool = rng.standard_normal((6, 3, 5, 4)).astype(np.float32)
        page = np.array([4, 0, 2], np.int64)
        off = np.array([1, 3, 1], np.int64)
        kv = rng.standard_normal((3, 3, 4)).astype(np.float32)
        want = jnp.asarray(pool).at[page, :, off].set(kv)
        got = torch.from_numpy(pool.copy())
        got[torch.from_numpy(page), :, torch.from_numpy(off)] = \
            torch.from_numpy(kv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert jax.default_backend() == "cpu"
