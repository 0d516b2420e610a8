"""PyTorch port, CUDA kernels on the card: each hand-written kernel held to
its plain PyTorch version at small shapes (the int8-KV variants of the
paged kernels and the quantized-weight matmuls included), and the engine on
the card held to the engine on the CPU, quantized and LoRA serving
included (the batched-gather LoRA kernel too).  Needs an NVIDIA GPU and
nvcc; skipped elsewhere.
Imports no JAX, so on the GPU machine it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

pa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _case(dev, dtype, g=4, hd=64, S=5, Q=24, nkv=2, bs=16, MB=6):
    rng = np.random.default_rng(0)
    NB = S * MB + 3
    gen = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((NB, nkv, bs, hd), device=dev, generator=gen).to(dtype)
    v = torch.randn((NB, nkv, bs, hd), device=dev, generator=gen).to(dtype)
    bt = torch.from_numpy(rng.permutation(NB)[:S * MB].reshape(S, MB)
                          .astype(np.int32)).to(dev)
    lens = torch.tensor([0, 1, 17, 50, MB * bs], dtype=torch.int32,
                        device=dev)[:S]
    counts = torch.tensor([0, 1, 9, Q, 3], dtype=torch.int32, device=dev)[:S]
    qd = torch.randn((S, nkv, g, hd), device=dev, generator=gen).to(dtype)
    qp = torch.randn((S, Q, nkv, g, hd), device=dev, generator=gen).to(dtype)
    return qd, qp, k, v, bt, lens, lens - counts, counts


VARIANTS = ["plain", "window", "alibi"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("g,hd", [(4, 64), (1, 128), (8, 256)])
def test_kernels_match_plain(cuda, dtype, tol, variant, g, hd):
    """Both kernels' variants (16-bit pages: tensor-core prefill for
    hd <= 128, CUDA-core for 256; fp32 pages: CUDA-core) against the plain
    versions, one-pass and split decode."""
    qd, qp, k, v, bt, lens, starts, counts = _case(cuda, dtype, g, hd)
    kw = {"plain": {}, "window": {"window": 7},
          "alibi": {"alibi_slopes": np.geomspace(0.5, 1 / 64, 2 * g)
                    .astype(np.float32)}}[variant]
    bs = k.shape[2]
    # a one-page table runs the one-pass kernel, the full one the split path
    for table, kv in ((bt[:, :1].contiguous(), lens.clamp(max=bs)),
                      (bt, lens)):
        got = pa.cuda_paged_attention(qd, k, v, table, kv, **kw)
        want = pa.torch_paged_attention(qd, k, v, table, kv, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)
    got = pa.cuda_ragged_prefill(qp, k, v, bt, lens, starts, counts, **kw)
    want = pa.torch_ragged_prefill(qp, k, v, bt, lens, starts, counts, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def _int8_pages(k, v):
    """The engine's int8 KV: per-token codes and fp32 scales."""
    from deepspeed_tpu_torch.inference.v2.model import quantize_kv_token
    (kq, ks), (vq, vs) = quantize_kv_token(k), quantize_kv_token(v)
    return kq, vq, ks.contiguous(), vs.contiguous()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("g,hd", [(4, 64), (1, 128), (8, 256)])
def test_int8_kv_kernels_match_plain(cuda, dtype, tol, variant, g, hd):
    """The int8-KV variants of both kernels (int8 pages + per-token fp32
    scales; an empty slot, one-pass and split decode) against the plain
    versions, which dequantize after the gather."""
    qd, qp, k, v, bt, lens, starts, counts = _case(cuda, dtype, g, hd)
    kq, vq, ks, vs = _int8_pages(k.float(), v.float())
    kw = {"plain": {}, "window": {"window": 7},
          "alibi": {"alibi_slopes": np.geomspace(0.5, 1 / 64, 2 * g)
                    .astype(np.float32)}}[variant]
    kw.update(k_scale=ks, v_scale=vs)
    bs = k.shape[2]
    before = (pa.cuda_paged_attention.int8_launches,
              pa.cuda_ragged_prefill.int8_launches)
    for table, kv in ((bt[:, :1].contiguous(), lens.clamp(max=bs)),
                      (bt, lens)):
        got = pa.cuda_paged_attention(qd, kq, vq, table, kv, **kw)
        want = pa.torch_paged_attention(qd, kq, vq, table, kv, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)
    got = pa.cuda_ragged_prefill(qp, kq, vq, bt, lens, starts, counts, **kw)
    want = pa.torch_ragged_prefill(qp, kq, vq, bt, lens, starts, counts, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert (pa.cuda_paged_attention.int8_launches - before[0],
            pa.cuda_ragged_prefill.int8_launches - before[1]) == (2, 1)


# ---- the 16-bit decode kernel at every shape it takes

DECODE_PAGES = {"bf16": (torch.bfloat16, False), "fp16": (torch.float16, False),
                "int8": (torch.bfloat16, True), "int8_fp16": (torch.float16, True)}


def _decode_case(dev, pages, g, hd, bs, S=7, nkv=2, MB=12, seed=0):
    """Pages behind a shuffled table [S, MB]; kv lengths from empty to the
    whole table, the longest slot long enough that the kernel splits it
    over several blocks (each walks at least a ring of pages)."""
    dtype, int8 = DECODE_PAGES[pages]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    NB = S * MB + 3
    k = torch.randn((NB, nkv, bs, hd), device=dev, generator=gen)
    v = torch.randn((NB, nkv, bs, hd), device=dev, generator=gen)
    q = torch.randn((S, nkv, g, hd), device=dev, generator=gen).to(dtype)
    scales = {}
    if int8:
        k, v, ks, vs = _int8_pages(k, v)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = k.to(dtype), v.to(dtype)
    bt = torch.from_numpy(rng.permutation(NB)[:S * MB].reshape(S, MB)
                          .astype(np.int32)).to(dev)
    lens = torch.tensor([0, 1, 17, bs, bs + 1, 5 * bs - 3, MB * bs],
                        dtype=torch.int32, device=dev)[:S]
    return q, k, v, bt, lens, scales


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pages", sorted(DECODE_PAGES))
@pytest.mark.parametrize("bs", [16, 64, 128])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_decode_kernel_every_shape(cuda, pages, bs, hd, g):
    """The 16-bit decode kernel (bf16 / fp16 pages, int8 pages under bf16
    and fp16 q) against the plain version per output row at 2e-2 of the
    row's largest value, at every query group, head dim and page size:
    plain, a window of two pages and a bit (pages wholly before it are
    skipped), alibi; a one-page table and the full table, whose longest
    slot is split over blocks and merged by the last of them; the empty
    slot's rows are exactly zero.  Every call is one int8 or 16-bit
    launch."""
    q, k, v, bt, lens, scales = _decode_case(cuda, pages, g, hd, bs)
    nkv = k.shape[1]
    variants = {"plain": {}, "window": {"window": 2 * bs + 5},
                "alibi": {"alibi_slopes": np.geomspace(0.5, 1 / 64, nkv * g)
                          .astype(np.float32)}}
    counter = "int8_launches" if scales else "launches"
    for name, kw in variants.items():
        for table, kv in ((bt[:, :1].contiguous(), lens.clamp(max=bs)),
                          (bt, lens)):
            before = getattr(pa.cuda_paged_attention, counter)
            got = pa.cuda_paged_attention(q, k, v, table, kv, **kw, **scales)
            want = pa.torch_paged_attention(q, k, v, table, kv, **kw,
                                            **scales)
            assert getattr(pa.cuda_paged_attention, counter) == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got[0], torch.zeros_like(got[0])), name
            _assert_rows(name, got[1:], want[1:], 2e-2)


DECODE_PLAN_CASES = {
    # (S, nkv, g, hd, bs, pages): Llama-3-8B's decode at 16 slots, bf16
    # and int8; one stage of a 256-token page; head dim 256 at a full
    # group; 300 slots (the slots' prefix in shared memory); the smallest
    # pages, eight stages
    "llama_bf16": (16, 8, 4, 128, 64, "bf16"),
    "llama_int8": (16, 8, 4, 128, 64, "int8"),
    "bs256_one_stage": (5, 2, 4, 128, 256, "bf16"),
    "hd256_g8": (5, 2, 8, 256, 128, "fp16"),
    "slots300": (300, 2, 2, 64, 16, "int8_fp16"),
    "hd32_bs16": (9, 4, 1, 32, 16, "bf16"),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(DECODE_PLAN_CASES))
def test_decode_plan_is_what_the_kernel_takes(cuda, case):
    """``decode_plan`` mirrors csrc/paged_attention.cu ``DecLayout``: its
    shared memory fits the card's opt-in limit, the kernel runs on the
    plan's blocks and ring (a launch the C side refuses raises), agrees
    with the plain version per row, and two runs are bitwise equal (the
    split slots' merge runs in block order, no float atomics)."""
    S, nkv, g, hd, bs, pages = DECODE_PLAN_CASES[case]
    props = torch.cuda.get_device_properties(cuda)
    esize = 1 if DECODE_PAGES[pages][1] else 2
    plan = pa.decode_plan(S, nkv, g, hd, bs, esize,
                          props.multi_processor_count)
    assert plan["smem"] <= props.shared_memory_per_block_optin
    assert plan["smem"] == pa.decode_smem(S, g, hd, bs, esize,
                                          plan["stages"])
    q, k, v, bt, lens, scales = _decode_case(cuda, pages, g, hd, bs, S=S,
                                             nkv=nkv, MB=6)
    lens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 6 * bs + 1, S).astype(np.int32)).to(cuda)
    runs = [pa.cuda_paged_attention(q, k, v, bt, lens, **scales)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    _assert_rows(case, runs[0], pa.torch_paged_attention(q, k, v, bt, lens,
                                                         **scales), 2e-2)


# ---- the 16-bit ragged prefill (csrc/prefill_hopper.cuh) at every shape


def _prefill_case(dev, pages, g, hd, bs, nkv=2, seed=0):
    """A mixed step over shuffled pages: a dead slot, a decode row of a
    slot long enough that its walk is split (more than 4 stages of 64
    keys), a slot whose rows span three units of 128 / g tokens (Q is not a
    multiple of the unit), a short fresh chunk and a chunk continuation."""
    dtype, int8 = DECODE_PAGES[pages]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tq = 128 // g
    Q = 3 * tq - 5
    counts = np.array([0, 1, Q, 7, 2 * tq + 3], np.int32)
    lens = np.array([5, 40 * 16 + 3, Q + 70, 7, 2 * tq + 3 + 2 * bs + 1],
                    np.int32)
    MB = int(-(-lens.max() // bs))
    S = len(counts)
    NB = S * MB + 3
    k = torch.randn((NB, nkv, bs, hd), device=dev, generator=gen)
    v = torch.randn((NB, nkv, bs, hd), device=dev, generator=gen)
    q = torch.randn((S, Q, nkv, g, hd), device=dev, generator=gen).to(dtype)
    scales = {}
    if int8:
        kq, vq, ks, vs = _int8_pages(k.float(), v.float())
        k, v, scales = kq, vq, {"k_scale": ks, "v_scale": vs}
    else:
        k, v = k.to(dtype), v.to(dtype)
    bt = torch.from_numpy(rng.permutation(NB)[:S * MB].reshape(S, MB)
                          .astype(np.int32)).to(dev)
    ints = [torch.from_numpy(a).to(dev) for a in (lens, lens - counts,
                                                  counts)]
    return (q, k, v, bt, *ints), scales


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pages", sorted(DECODE_PAGES))
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_prefill_kernel_every_shape(cuda, pages, bs, hd, g):
    """The tensor-core prefill (bf16 / fp16 pages, int8 pages under bf16
    and fp16 q) against the plain version per output row (2e-2 of the
    row's largest value; fp16 pages 4e-3): plain, a window that crosses
    pages, alibi; dead rows (the dead slot's, and past each slot's count)
    exactly zero; two runs bitwise equal (the split walk merged in chunk
    order); one launch a call."""
    args, scales = _prefill_case(cuda, pages, g, hd, bs)
    q, counts = args[0], args[6]
    assert pa.prefill_route(q.dtype, *q.shape[:2], g, hd, bs) \
        == pa.PREFILL_WGMMA
    nkv = args[1].shape[1]
    tol = 4e-3 if pages == "fp16" else 2e-2
    variants = {"plain": {}, "window": {"window": bs + 5},
                "alibi": {"alibi_slopes": np.geomspace(0.5, 1 / 64, nkv * g)
                          .astype(np.float32)}}
    counter = "int8_launches" if scales else "launches"
    dead = torch.arange(q.shape[1], device=cuda)[None] >= counts[:, None]
    for name, kw in variants.items():
        before = getattr(pa.cuda_ragged_prefill, counter)
        runs = [pa.cuda_ragged_prefill(*args, **kw, **scales)
                for _ in range(2)]
        assert getattr(pa.cuda_ragged_prefill, counter) == before + 2
        want = pa.torch_ragged_prefill(*args, **kw, **scales)
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]), name
        assert not runs[0][dead].any(), name
        _assert_rows(name, runs[0][~dead], want[~dead], tol)


# ---- quantized-weight matmuls (csrc/wq_matmul.cu)

wq = importlib.import_module("deepspeed_tpu_torch.ops.wq_matmul")


def _wq_case(dev, mode, g, M, N, K, dtype):
    from deepspeed_tpu_torch.ops import quantization as q
    gen = torch.Generator(device=dev).manual_seed(g + M + N)
    shape = (N, K) if mode == "w8t" else (K, N)
    w = torch.randn(shape, device=dev, generator=gen) * 0.05
    store = (q.quantize_weight4(w, group=g) if mode == "w4"
             else q.quantize_weight(w, group=g))
    x = torch.randn((M, K), device=dev, generator=gen).to(dtype)
    return x, store


WQ = {"w8": ("cuda_wq_matmul", "torch_wq_matmul"),
      "w8t": ("cuda_wq_matmul_t", "torch_wq_matmul_t"),
      "w4": ("cuda_wq_matmul4", "torch_wq_matmul4")}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("mode", sorted(WQ))
@pytest.mark.parametrize("g", [16, 32, 64, 128, 256, 512])
def test_wq_kernels_match_plain(cuda, dtype, tol, mode, g):
    """Each kernel against its plain version, per output row (tol of the
    row's largest value): odd M, N not a multiple of the 128-column tile
    (16-byte aligned rows and not), a K with a partial last step where the
    group allows it, and a single row; groups above the 128-deep K step
    (one scale row a step, or a column tile, split-K over the groups)."""
    K = 320 if g <= 64 else 384 if g <= 128 else 2 * g
    Ns = ((448 if g <= 128 else g, 3 * g) if mode == "w8t"
          else (200, 272))
    kern, plain = getattr(wq, WQ[mode][0]), getattr(wq, WQ[mode][1])
    for M in (37, 1):
        for N in Ns:
            x, store = _wq_case(cuda, mode, g, M, N, K, dtype)
            before = kern.launches
            got = kern(x, store)
            want = plain(x, store)
            assert kern.launches == before + 1
            assert got.shape == want.shape == (M, N) and got.dtype == dtype
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs().amax(-1)
            row = d / want.float().abs().amax(-1).clamp_min(1e-6)
            assert torch.isfinite(got).all()
            assert row.max().item() <= tol, (M, N, row.max().item())


def _misaligned(t):
    """The same values at a base 1 element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("g", [16, 128, 256, 512])
@pytest.mark.parametrize("M", [1, 16, 17, 256, 300])
def test_wq_matmul_t_every_shape(cuda, dtype, g, M):
    """#6 (16-bit x: the swapped wgmma kernel; fp32: the CUDA-core one)
    against the plain version per output row, 2e-2 of the row's largest
    value in 16-bit and 1e-4 in fp32 with TF32 off: rows of x 1 to 300
    (one to three row blocks), groups of 16 (a ragged last tile of V), 128,
    and 256 / 512 (wider than the 128-row tile), GPT-2's H 768, an H with a
    partial last 64-deep stage (784), and code and scale rows read from a
    base that is not 16-byte aligned (the element-wise route)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    N = 27 * g if g == 16 else 5 * g if g == 128 else 3 * g
    for K, misaligned in ((768, False), (784, False), (768, True)):
        x, store = _wq_case(cuda, "w8t", g, M, N, K, dtype)
        if misaligned:
            store = {n: _misaligned(t) for n, t in store.items()}
        before = wq.cuda_wq_matmul_t.launches
        got = wq.cuda_wq_matmul_t(x, store)
        want = wq.torch_wq_matmul_t(x, store)
        assert wq.cuda_wq_matmul_t.launches == before + 1
        assert got.shape == (M, N) and got.dtype == dtype
        torch.cuda.synchronize()
        _assert_rows(f"K={K} misaligned={misaligned}", got, want, tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 16, 17, 64, 128, 256, 300])
def test_wq_t_plan_is_what_the_kernel_takes(cuda, M):
    """Mode 1's ``wq_plan`` mirrors csrc/wq_matmul.cu ``wt_smem`` at GPT-2's
    tied table [50304, 768]: its shared memory fits the card's opt-in
    limit, the kernel runs on the plan's ring depth (a launch the C side
    refuses raises) and agrees with the plain version per row."""
    props = torch.cuda.get_device_properties(cuda)
    plan = wq.wq_plan(M, 50304, 768, 1, torch.bfloat16,
                      props.multi_processor_count)
    assert plan["smem"] <= props.shared_memory_per_block_optin
    assert plan["splits"] == 1
    x, store = _wq_case(cuda, "w8t", 128, M, 50304, 768, torch.bfloat16)
    _assert_rows(f"M={M}", wq.cuda_wq_matmul_t(x, store),
                 wq.torch_wq_matmul_t(x, store), 2e-2)


@pytest.mark.requires_cuda
def test_wq_unsupported_raise(cuda):
    from deepspeed_tpu_torch import ops
    from deepspeed_tpu_torch.ops import quantization as q
    x, store = _wq_case(cuda, "w8", 128, 4, 256, 512, torch.bfloat16)
    # groups of 96 (a store the engine never packs: not a power of two)
    odd = {"v": store["v"][:384].contiguous(),
           "s": torch.ones((4, 256), device=cuda)}
    with pytest.raises(ValueError, match="group"):
        wq.cuda_wq_matmul(x[:, :384].contiguous(), odd)
    with pytest.raises(ValueError, match="contiguous"):
        wq.cuda_wq_matmul(x[:, ::2].repeat(1, 2)[:, :512].t().contiguous()
                          .t(), store)
    with pytest.raises(ValueError, match="does not support"):
        ops.wq_any(x[:, :256].contiguous(), store)


@pytest.mark.requires_cuda
def test_unsupported_shapes_raise(cuda):
    qd, qp, k, v, bt, lens, starts, counts = _case(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        pa.cuda_paged_attention(qd, k, v, bt.long(), lens)
    with pytest.raises(ValueError, match="int8"):
        pa.cuda_paged_attention(qd, k.to(torch.int8), v.to(torch.int8), bt,
                                lens)
    from deepspeed_tpu_torch import ops
    with pytest.raises(ValueError, match="does not support"):
        ops.paged_attention(qd[:, :, :, :48].contiguous(), k[..., :48]
                            .contiguous(), v[..., :48].contiguous(), bt, lens)


@pytest.mark.requires_cuda
def test_engine_on_card_matches_cpu(cuda):
    from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        GPTConfig.llama(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
                        vocab_size=512, max_seq_len=256), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ecfg = {"dtype": "fp32", "state_manager": {
        "max_tracked_sequences": 4, "max_ragged_batch_size": 64,
        "kv_block_size": 8, "max_q_per_seq": 8, "num_kv_blocks": 10}}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (18 + 5 * i,)).astype(np.int32)
               for i in range(4)]
    before = pa.cuda_paged_attention.launches
    outs = [InferenceEngineV2(cfg, config=ecfg, params=params, device=d)
            .generate(prompts, max_new_tokens=20) for d in ("cpu", cuda)]
    assert pa.cuda_paged_attention.launches > before
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_on_card_matches_cpu(cuda, bits):
    """W8 / W4 stores with int8 KV, fp32, TF32 off: greedy tokens on the
    card equal the CPU's, through every quantized kernel."""
    from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        GPTConfig.llama(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
                        vocab_size=512, max_seq_len=256), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ecfg = {"dtype": "fp32", "quant": {"enabled": True, "bits": bits},
            "state_manager": {
                "max_tracked_sequences": 4, "max_ragged_batch_size": 64,
                "kv_block_size": 8, "max_q_per_seq": 8, "num_kv_blocks": 10,
                "kv_quant": "int8"}}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (18 + 5 * i,)).astype(np.int32)
               for i in range(4)]
    kern = wq.cuda_wq_matmul4 if bits == 4 else wq.cuda_wq_matmul
    before = (kern.launches, pa.cuda_paged_attention.int8_launches)
    outs = [InferenceEngineV2(cfg, config=ecfg, params=params, device=d)
            .generate(prompts, max_new_tokens=20) for d in ("cpu", cuda)]
    assert kern.launches > before[0]
    assert pa.cuda_paged_attention.int8_launches > before[1]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ---- flash attention: forward, dq, dk/dv (csrc/flash_attention.cu)

fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")

FLASH_CASES = {
    "causal": dict(),
    "noncausal": dict(causal=False),
    "gqa4": dict(N=8, Nkv=2),
    "gqa8_hd128": dict(N=8, Nkv=1, D=128),
    "window": dict(window=37),
    "alibi": dict(alibi=True),
    "alibi_window_gqa": dict(N=4, Nkv=2, window=50, alibi=True),
    "ragged_tail": dict(T=173),
    "short": dict(T=5),
    # the training main path's call (GPT-2 small, T 1024)
    "main_b16_t1024": dict(B=16, T=1024, N=12, Nkv=12),
    # head dims the kernels pad (40 -> 64, 80 / 96 -> 96, 136 -> 192); the
    # widest (256) in one block column of the forward
    "d40_gqa": dict(N=4, Nkv=2, D=40),
    "d80": dict(D=80, T=173),
    "d96_window": dict(D=96, window=37),
    "d136_alibi": dict(D=136, alibi=True),
    "d256": dict(D=256, N=2, Nkv=1),
}


def _flash_case(dev, dtype, B=2, T=192, N=4, Nkv=4, D=64, causal=True,
                window=None, alibi=False):
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)
    q, do = rand(B, T, N, D), rand(B, T, N, D)
    k, v = rand(B, T, Nkv, D), rand(B, T, Nkv, D)
    kw = dict(causal=causal, window=window,
              alibi_slopes=(np.geomspace(0.5, 1 / 64, N).astype(np.float32)
                            if alibi else None))
    return q, k, v, do, kw


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, dtype, tol, case):
    """Forward (o, lse), dq and dk/dv against the plain versions; per row,
    ``tol`` of the plain row's largest value (lse: absolute).  A row whose
    true value is ~0 (the first query's dq: it sees one key, so dp - delta
    cancels) is judged against 1% of the tensor's largest value instead."""
    q, k, v, do, kw = _flash_case(cuda, dtype, **FLASH_CASES[case])
    o, lse = fa.cuda_flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.torch_flash_fwd(q, k, v, **kw)
    assert lse.shape == lse_ref.shape and lse.is_contiguous()
    torch.testing.assert_close(lse, lse_ref, atol=max(tol, 1e-4), rtol=0)
    dq = fa.cuda_flash_dq(q, k, v, o_ref, lse_ref, do, **kw)
    dk, dv = fa.cuda_flash_dkv(q, k, v, o_ref, lse_ref, do, **kw)
    refs = fa.torch_flash_bwd(q, k, v, o_ref, lse_ref, do, **kw)
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                               (o_ref,) + refs):
        d = (got.float() - want.float()).abs().amax(-1)
        floor = 1e-2 * want.float().abs().max().item()
        row = d / want.float().abs().amax(-1).clamp_min(floor)
        assert torch.isfinite(got).all(), name
        worst = row.flatten().argmax()
        assert row.max().item() <= tol, (
            name, row.max().item(), d.flatten()[worst].item(),
            want.float().abs().amax(-1).flatten()[worst].item(),
            want.float().abs().max().item())


@pytest.mark.requires_cuda
def test_flash_autograd_and_strides(cuda):
    """The autograd Function launches all three kernels, is deterministic,
    and reads q, k, v through strides (a fused qkv projection's views)."""
    B, T, N, D = 2, 128, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((B, T, 3, N, D), device=cuda, generator=gen).to(
        torch.bfloat16).requires_grad_()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = (fa.cuda_flash_fwd.launches, fa.cuda_flash_dq.launches,
              fa.cuda_flash_dkv.launches)
    grads = []
    for _ in range(2):
        out = fa.flash_attention(q, k, v)
        grads.append(torch.autograd.grad(out.float().square().sum(), qkv)[0])
    after = (fa.cuda_flash_fwd.launches, fa.cuda_flash_dq.launches,
             fa.cuda_flash_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    assert torch.equal(grads[0], grads[1])
    qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    o_ref, _ = fa.torch_flash_fwd(qc, kc, vc)
    torch.testing.assert_close(out.float(), o_ref.float(), atol=2e-2, rtol=0)


@pytest.mark.requires_cuda
def test_flash_unsupported_raises(cuda):
    from deepspeed_tpu_torch import ops
    q, k, v, _, _ = _flash_case(cuda, torch.bfloat16, D=64)
    with pytest.raises(ValueError, match="head_dim 44.*C.1"):
        fa.cuda_flash_fwd(q[..., :44].contiguous(), k[..., :44].contiguous(),
                          v[..., :44].contiguous())
    wide = torch.zeros(q.shape[:3] + (264,), dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="head_dim 264.*C.1"):
        fa.cuda_flash_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="causal"):
        fa.cuda_flash_fwd(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="does not support"):
        ops.causal_attention(q, k[:, :100], v[:, :100])


@pytest.mark.requires_cuda
def test_training_on_card_matches_cpu(cuda):
    """Three train_batch steps of a small model, cuda against cpu (fp32,
    TF32 off): loss, grad norm and parameters agree to 1e-4."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import (GPTChunkedLoss, GPTConfig,
                                            params_to_numpy)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(vocab_size=512, num_layers=2, num_heads=2, head_dim=64,
                    hidden_size=128, max_seq_len=128, loss_chunk=96)
    dscfg = {"train_micro_batch_size_per_gpu": 2,
             "gradient_accumulation_steps": 2, "steps_per_print": 0,
             "optimizer": {"type": "adamw",
                           "params": {"lr": 3e-4, "weight_decay": 0.01}},
             "gradient_clipping": 1.0}
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 512, (4, 128)).astype(np.int32)}
               for _ in range(3)]
    runs = {}
    before = fa.cuda_flash_dkv.launches
    for d in ("cpu", cuda):
        model = GPTChunkedLoss(cfg)      # same CPU-seeded weights both times
        eng, *_ = ds.initialize(model=model, config=dict(dscfg), device=d)
        runs[d] = ([eng.train_batch(b) for b in batches],
                   params_to_numpy(model))
    assert fa.cuda_flash_dkv.launches - before == 3 * 2 * 2
    for a, b in zip(runs["cpu"][0], runs[cuda][0]):
        assert abs(a.loss - b.loss) <= 1e-4 and \
            abs(a.grad_norm - b.grad_norm) <= 1e-4
    from deepspeed_tpu_torch.models.gpt import _flatten
    pa_, pb_ = dict(_flatten(runs["cpu"][1])), dict(_flatten(runs[cuda][1]))
    for name in pa_:
        np.testing.assert_allclose(pa_[name], pb_[name], atol=1e-4, rtol=0)



# ---- batched-gather LoRA (csrc/lora_matmul.cu)

lm = importlib.import_module("deepspeed_tpu_torch.ops.lora_matmul")


def _lora_case(dev, dtype, M, O, r, S=9, H=4096, ids="random"):
    """Pages as the pool keeps them (slot 0 zero, scale 0) at Llama-3-8B's
    hidden width; ids random over the slots, all identity or one tenant."""
    gen = torch.Generator(device=dev).manual_seed(M + O + r)
    x = torch.randn((M, H), device=dev, generator=gen).to(dtype)
    a = (torch.randn((S, H, r), device=dev, generator=gen) * 0.05).to(dtype)
    b = (torch.randn((S, r, O), device=dev, generator=gen) * 0.05).to(dtype)
    a[0] = 0
    b[0] = 0
    s = torch.linspace(0.5, 2.0, S, device=dev)
    s[0] = 0
    if ids == "random":
        sel = torch.randint(0, S, (M,), device=dev, generator=gen)
    elif ids == "slots of 64 and 65":
        # slot 2's 64 rows and slot 5's 65 in a shuffled order, the rest
        # random over the other slots
        sel = torch.randint(0, S, (M,), device=dev, generator=gen)
        sel = torch.where((sel == 2) | (sel == 5), 1, sel)
        perm = torch.randperm(M, device=dev, generator=gen)
        n2, n5 = min(64, M), min(65, max(M - 64, 0))
        sel[perm[:n2]] = 2
        sel[perm[n2:n2 + n5]] = 5
    else:
        sel = torch.full((M,), 0 if ids == "identity" else 3, device=dev)
    return x, a, b, sel.to(torch.int32), s


def _lora_row_err(got, want):
    """Worst row's max |got - want| over its largest |want|; rows that are
    exactly 0 in the plain version must be exactly 0."""
    g, w = got.float(), want.float()
    zero = w.abs().amax(-1) == 0
    assert not g[zero].any()
    d = (g - w).abs().amax(-1)[~zero]
    return (d / w.abs().amax(-1)[~zero]).max().item() if d.numel() else 0.0


LORA_MR = [(M, r) for M in (1, 16, 37, 64, 65, 256, 1024)
           for r in (8, 16, 64, 256, 12) if (M, r) != (1024, 256)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("O", [4096, 1024])
@pytest.mark.parametrize("M,r", LORA_MR)
def test_lora_kernel_matches_plain(cuda, dtype, tol, O, M, r):
    """Both kernel pairs (16-bit x at r % 8 == 0 on the tensor cores, fp32
    and r 12 on the CUDA cores) against the plain version per row: ids
    random, all identity (exactly 0), one tenant, a slot holding exactly
    64 and one exactly 65 rows; one row's id out of range comes out NaN
    and every other row right; two runs bitwise equal; one launch a
    call."""
    assert lm.lora_route(dtype, 4096, r, O, 9) == (
        lm.WGMMA if dtype != torch.float32 and r % 8 == 0 else lm.SIMT)
    before = lm.cuda_lora_matmul.launches
    for ids in ("random", "identity", "one", "slots of 64 and 65"):
        args = _lora_case(cuda, dtype, M, O, r, ids=ids)
        got = lm.cuda_lora_matmul(*args)
        want = lm.torch_lora_matmul(*args)
        assert got.dtype == dtype and got.shape == (M, O)
        assert _lora_row_err(got, want) <= tol
        if ids == "identity":
            assert not got.float().any()
        if ids == "random":
            assert torch.equal(got, lm.cuda_lora_matmul(*args))
    x, a, b, sel, s = _lora_case(cuda, dtype, M, O, r)
    bad = sel.clone()
    bad[M // 2] = a.shape[0]
    got = lm.cuda_lora_matmul(x, a, b, bad, s)
    ok = torch.arange(M, device=cuda) != M // 2
    assert torch.isnan(got[M // 2].float()).all()
    assert _lora_row_err(got[ok], lm.torch_lora_matmul(x, a, b, sel, s)[ok]) \
        <= tol
    assert lm.cuda_lora_matmul.launches - before == 6


@pytest.mark.requires_cuda
def test_lora_unsupported_raise(cuda):
    from deepspeed_tpu_torch import ops
    x, a, b, ids, s = _lora_case(cuda, torch.bfloat16, 16, 1024, 16, H=256)
    with pytest.raises(ValueError, match="dtype"):
        lm.cuda_lora_matmul(x.float(), a, b, ids, s)
    with pytest.raises(ValueError, match="one device"):
        lm.cuda_lora_matmul(x, a, b, ids.cpu(), s)
    with pytest.raises(ValueError, match="int32"):
        lm.cuda_lora_matmul(x, a, b, ids.long(), s)
    big = torch.zeros((2, 256, lm.RANK_MAX + 1), dtype=x.dtype, device=cuda)
    with pytest.raises(ValueError, match="rank"):
        lm.cuda_lora_matmul(x, big, torch.zeros(
            (2, lm.RANK_MAX + 1, 8), dtype=x.dtype, device=cuda), ids % 2,
            s[:2])
    with pytest.raises(ValueError, match="does not support"):
        ops.lora_matmul(x, a[:, :128], b, ids, s)


@pytest.mark.requires_cuda
def test_adapter_engine_on_card_matches_cpu(cuda):
    """8 tenants (``slots`` 10 and, with eviction churn, 3) on the small
    model, fp32, TF32 off: greedy tokens on the card equal the CPU's."""
    from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import init_params
    from deepspeed_tpu_torch.serving import random_adapter_weights
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        GPTConfig.llama(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
                        vocab_size=512, max_seq_len=256), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (6 + 5 * i,)).astype(np.int32)
               for i in range(8)]
    ids = [1 + i for i in range(8)]
    for slots in (10, 3):
        ecfg = {"dtype": "fp32", "adapters": {"enabled": True, "rank": 4,
                                              "alpha": 8.0, "slots": slots},
                "state_manager": {"max_tracked_sequences": 8,
                                  "max_ragged_batch_size": 64,
                                  "kv_block_size": 8, "max_q_per_seq": 8}}
        before = lm.cuda_lora_matmul.launches
        outs = []
        for d in ("cpu", cuda):
            eng = InferenceEngineV2(cfg, config=ecfg, params=params, device=d)
            for aid in ids:
                eng.register_adapter(aid, random_adapter_weights(
                    2, 128, 4, 128, 64, seed=aid, init_scale=0.5))
            outs.append(eng.generate(prompts, max_new_tokens=12,
                                     adapter_ids=ids))
            assert eng.adapters.stats()["pinned_blocks"] == 0
            eng.adapters.check_invariants()
        assert lm.cuda_lora_matmul.launches > before
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------ block-sparse, evoformer

sp = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
evo = importlib.import_module("deepspeed_tpu_torch.ops.evoformer")


class _EvenColumns(sp.SparsityConfig):
    """Rows read only the even column blocks at or before them (odd rows the
    one before the diagonal): the odd K/V blocks are never read."""

    def make_layout(self, seq_len):
        nb = seq_len // self.block
        lay = np.tril(np.ones((nb, nb), bool))
        lay[:, 1::2] = False
        return lay


SPARSE_CASES = {
    "fixed_b16_gqa": (sp.FixedSparsityConfig(), 4, 2, 64, True),
    "fixed_b32_d128": (sp.FixedSparsityConfig(block=32), 4, 4, 128, True),
    "longformer_b64": (sp.BSLongformerSparsityConfig(block=64), 4, 1, 64,
                       True),
    "bigbird_b128_noncausal": (sp.BigBirdSparsityConfig(block=128), 2, 2,
                               128, False),
    "dense_b48_noncausal": (sp.DenseSparsityConfig(block=48), 4, 2, 64,
                            False),
    "even_columns_b16": (_EvenColumns(block=16), 4, 2, 64, True),
    # the CUDA-core family: block 8 (the reference's tests' block), blocks
    # that are not multiples of 16, head dims other than 64 / 128
    "fixed_b8_gqa": (sp.FixedSparsityConfig(block=8), 4, 2, 64, True),
    "bigbird_b8_noncausal": (sp.BigBirdSparsityConfig(block=8), 2, 1, 64,
                             False),
    "longformer_b24_d80": (sp.BSLongformerSparsityConfig(block=24), 4, 2, 80,
                           True),
    "fixed_b64_d256": (sp.FixedSparsityConfig(block=64), 2, 2, 256, True),
    "dense_b192_noncausal": (sp.DenseSparsityConfig(block=192), 2, 2, 64,
                             False),
}


def _sparse_case(dev, dtype, N, Nkv, D, B=2, T=384, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)
    return rand(B, T, N, D), rand(B, T, Nkv, D), rand(B, T, Nkv, D), \
        rand(B, T, N, D)


def _assert_rows(name, got, want, tol):
    """Per row, ``tol`` of the plain row's largest value (a row whose true
    value is ~0 against 1% of the tensor's largest; 10% at the fp32
    tolerance, where a row that cancels to 0 - a first query that sees one
    key, dp - delta = 0 - keeps each side's summation noise, ~1e-6 of the
    largest)."""
    d = (got.float() - want.float()).abs().amax(-1)
    floor = (1e-1 if tol <= 1e-4 else 1e-2) * want.float().abs().max().item()
    row = d / want.float().abs().amax(-1).clamp_min(floor)
    assert torch.isfinite(got).all(), name
    assert row.max().item() <= tol, (name, row.max().item())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_kernels_match_plain(cuda, dtype, tol, case):
    """Forward (o, lse), dq and dk/dv against the plain versions."""
    cfg, N, Nkv, D, causal = SPARSE_CASES[case]
    T = 384
    q, k, v, do = _sparse_case(cuda, dtype, N, Nkv, D, T=T)
    lay = cfg.make_layout(T)
    o, lse = sp.cuda_sparse_fwd(q, k, v, lay, cfg.block, causal)
    o_ref, lse_ref = sp.torch_sparse_fwd(q, k, v, lay, cfg.block, causal)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=0)
    dq = sp.cuda_sparse_dq(q, k, v, o_ref, lse_ref, do, lay, cfg.block,
                           causal)
    dk, dv = sp.cuda_sparse_dkv(q, k, v, o_ref, lse_ref, do, lay, cfg.block,
                                causal)
    refs = sp.torch_sparse_bwd(q, k, v, o_ref, lse_ref, do, lay, cfg.block,
                               causal)
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                               (o_ref,) + refs):
        _assert_rows(name, got, want, tol)


# the tensor-core dk/dv's route cases: (case, route)
SPARSE_DKV_ROUTES = [("fixed_b16_gqa", "wgmma"), ("fixed_b32_d128", "wgmma"),
                     ("longformer_b64", "wgmma"),
                     ("bigbird_b128_noncausal", "wgmma"),
                     ("even_columns_b16", "wgmma"),
                     ("dense_b48_noncausal", "mma")]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case,route", SPARSE_DKV_ROUTES)
def test_sparse_dkv_wgmma_matches_plain(cuda, dtype, case, route):
    """dk/dv on its route (the C rule equals ``sparse_dkv_route``): the
    wgmma kernel on the plan's column groups (its split walks merged by one
    more launch) and, at block 48, the mma.sync kernel, against the plain
    backward per row; two runs give the same bits."""
    cfg, N, Nkv, D, causal = SPARSE_CASES[case]
    assert sp.sparse_dkv_route(dtype, D, cfg.block) == route
    code = sp._DTYPE_CODE[dtype]
    assert sp._lib().ds_sparse_dkv_route(code, D, cfg.block) == \
        sp._DKV_ROUTES.index(route)
    q, k, v, do = _sparse_case(cuda, dtype, N, Nkv, D, T=384)
    lay = cfg.make_layout(384)
    o, lse = sp.torch_sparse_fwd(q, k, v, lay, cfg.block, causal)
    plan = sp._call_plan(lay, cfg.block, causal, N // Nkv, k)[0]
    before = (sp.cuda_sparse_dkv.launches, sp.cuda_sparse_dkv_merge.launches)
    runs = [sp.cuda_sparse_dkv(q, k, v, o, lse, do, lay, cfg.block, causal)
            for _ in range(2)]
    torch.cuda.synchronize()
    merged = int(route == "wgmma" and plan["parts"] > 0)
    assert (sp.cuda_sparse_dkv.launches - before[0],
            sp.cuda_sparse_dkv_merge.launches - before[1]) == (2, 2 * merged)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    want = sp.torch_sparse_bwd(q, k, v, o, lse, do, lay, cfg.block, causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 4e-3
    for name, got, w in zip(("dk", "dv"), runs[0], want[1:]):
        _assert_rows(name, got, w, tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", [c for c, r in SPARSE_DKV_ROUTES
                                  if r == "wgmma"])
def test_sparse_q_wgmma_matches_plain(cuda, dtype, case):
    """The forward and dq on the wgmma route (``sparse_q_plan``'s units,
    split walks merged by one more launch each): o, lse and dq against the
    plain versions per row, the delta dq makes against the eager fp32 sum,
    and two runs give the same bits."""
    cfg, N, Nkv, D, causal = SPARSE_CASES[case]
    q, k, v, do = _sparse_case(cuda, dtype, N, Nkv, D, T=384)
    lay = cfg.make_layout(384)
    fm, dm = (int(sp._call_q_plan(lay, cfg.block, causal, q, Nkv,
                                  dq=dq)[0]["parts"] > 0)
              for dq in (False, True))
    counters = (sp.cuda_sparse_fwd, sp.cuda_sparse_fwd_combine,
                sp.cuda_sparse_dq, sp.cuda_sparse_dq_merge)
    before = [c.launches for c in counters]
    fwd = [sp.cuda_sparse_fwd(q, k, v, lay, cfg.block, causal)
           for _ in range(2)]
    o_ref, lse_ref = sp.torch_sparse_fwd(q, k, v, lay, cfg.block, causal)
    made = [torch.empty((2, N, 384), device=cuda) for _ in range(2)]
    dqs = [sp.cuda_sparse_dq(q, k, v, o_ref, lse_ref, do, lay, cfg.block,
                             causal, delta_out=d) for d in made]
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [2, 2 * fm, 2, 2 * dm]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    assert torch.equal(*dqs) and torch.equal(*made)
    tol = 2e-2 if dtype == torch.bfloat16 else 4e-3
    torch.testing.assert_close(fwd[0][1], lse_ref, atol=tol, rtol=0)
    want = sp._bwd_inputs("t", q, o_ref, lse_ref, do)[2]
    torch.testing.assert_close(made[0], want, atol=1e-4 * want.abs().max(),
                               rtol=0)
    dq_ref = sp.torch_sparse_bwd(q, k, v, o_ref, lse_ref, do, lay, cfg.block,
                                 causal)[0]
    _assert_rows("o", fwd[0][0], o_ref, tol)
    _assert_rows("dq", dqs[0], dq_ref, tol)


@pytest.mark.requires_cuda
def test_sparse_q_merges_match_plain(cuda):
    """The forward combine and the dq merge on seeded partials of a plan's
    shape: the combine's o per row at 2e-2 (a 16-bit output: a rounding
    tie may flip one ulp) and its lse at 1e-5, the dq merge bitwise (chunks
    added in order, rounded once); rows of unsplit walks are left as they
    were."""
    cfg = sp.BSLongformerSparsityConfig(global_block_indices=(0, 5, 9))
    lay = cfg.make_layout(384)
    q = torch.zeros((2, 384, 4, 64), dtype=torch.bfloat16, device=cuda)
    fplan, dplan = (sp._call_q_plan(lay, 16, True, q, 2, dq=dq)[0]
                    for dq in (False, True))
    assert fplan["parts"] > 0 and dplan["parts"] > 0
    gen = torch.Generator(device=cuda).manual_seed(5)
    part = torch.randn((fplan["parts"], 128, 64), device=cuda, generator=gen)
    ml = torch.stack([4 * torch.randn((fplan["parts"], 128), device=cuda,
                                      generator=gen),
                      torch.rand((fplan["parts"], 128), device=cuda,
                                 generator=gen) + 0.5], 1)
    ml[:, 0, ::9] = float("-inf")
    ml[:, 1, ::9] = 0.0
    base = torch.randn(q.shape, device=cuda, generator=gen).to(q.dtype)
    lse = torch.randn((2, 4, 1, 384), device=cuda, generator=gen)
    want = sp.torch_sparse_fwd_combine(part, ml, base, lse, lay, 16, True, 2)
    got = sp.cuda_sparse_fwd_combine(part, ml, base.clone(), lse.clone(), lay,
                                     16, True, 2)
    _assert_rows("o", got[0], want[0], 2e-2)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    part = torch.randn((dplan["parts"], 128, 64), device=cuda, generator=gen)
    want = sp.torch_sparse_dq_merge(part, base, lay, 16, True, 2)
    got = sp.cuda_sparse_dq_merge(part, base.clone(), lay, 16, True, 2)
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
def test_sparse_dkv_merge_matches_plain(cuda):
    """The second pass on a seeded partial of a plan's shape equals its
    plain version (chunks added in order, rounded once) bitwise, and
    leaves the rows of unsplit walks as they were."""
    cfg = sp.FixedSparsityConfig()
    lay = cfg.make_layout(384)
    k = torch.zeros((2, 384, 2, 64), dtype=torch.bfloat16, device=cuda)
    plan = sp._call_plan(lay, 16, True, 2, k)[0]
    assert plan["parts"] > 0
    gen = torch.Generator(device=cuda).manual_seed(4)
    part = torch.randn((plan["parts"], 2, 128, 64), device=cuda,
                       generator=gen)
    dk = torch.randn(k.shape, device=cuda, generator=gen).to(k.dtype)
    dv = torch.randn(k.shape, device=cuda, generator=gen).to(k.dtype)
    want = sp.torch_sparse_dkv_merge(part, dk, dv, lay, 16, True, 2)
    got = sp.cuda_sparse_dkv_merge(part, dk.clone(), dv.clone(), lay, 16,
                                   True, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.requires_cuda
def test_sparse_dead_blocks_never_read(cuda):
    """K/V blocks no table entry reads are poisoned with NaN: the kernels'
    o, dq, dk, dv stay finite and equal the plain outputs on clean K/V."""
    cfg = _EvenColumns(block=16)
    q, k, v, do = _sparse_case(cuda, torch.bfloat16, 4, 2, 64, T=256)
    lay = cfg.make_layout(256)
    o_ref, lse_ref = sp.torch_sparse_fwd(q, k, v, lay, 16)
    refs = sp.torch_sparse_bwd(q, k, v, o_ref, lse_ref, do, lay, 16)
    kp, vp = k.clone(), v.clone()
    for j in range(1, 16, 2):
        kp[:, 16 * j:16 * (j + 1)] = float("nan")
        vp[:, 16 * j:16 * (j + 1)] = float("nan")
    o, _ = sp.cuda_sparse_fwd(q, kp, vp, lay, 16)
    dq = sp.cuda_sparse_dq(q, kp, vp, o_ref, lse_ref, do, lay, 16)
    dk, dv = sp.cuda_sparse_dkv(q, kp, vp, o_ref, lse_ref, do, lay, 16)
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                               (o_ref,) + refs):
        _assert_rows(name, got, want, 2e-2)
    # block 8 on the CUDA-core family: the odd 8-key blocks are dead
    cfg8 = _EvenColumns(block=8)
    lay8 = cfg8.make_layout(256)
    for dtype in (torch.bfloat16, torch.float32):
        q8, k8, v8, do8 = (t.to(dtype) for t in (q, k, v, do))
        o_ref, lse_ref = sp.torch_sparse_fwd(q8, k8, v8, lay8, 8)
        refs = sp.torch_sparse_bwd(q8, k8, v8, o_ref, lse_ref, do8, lay8, 8)
        kp, vp = k8.clone(), v8.clone()
        for j in range(1, 32, 2):
            kp[:, 8 * j:8 * (j + 1)] = float("nan")
            vp[:, 8 * j:8 * (j + 1)] = float("nan")
        o, _ = sp.cuda_sparse_fwd(q8, kp, vp, lay8, 8)
        dq = sp.cuda_sparse_dq(q8, kp, vp, o_ref, lse_ref, do8, lay8, 8)
        dk, dv = sp.cuda_sparse_dkv(q8, kp, vp, o_ref, lse_ref, do8, lay8, 8)
        for name, got, want in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                                   (o_ref,) + refs):
            _assert_rows(f"{name} block 8 {dtype}", got, want, 2e-2)


@pytest.mark.requires_cuda
def test_sparse_autograd_and_strides(cuda):
    """sparse_attention on CUDA tensors launches the three kernels once
    each, reads q, k, v through strides, and is deterministic."""
    from deepspeed_tpu_torch import ops
    cfg = sp.FixedSparsityConfig()
    B, T, N, D = 1, 256, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((B, T, 3, N, D), device=cuda, generator=gen).to(
        torch.bfloat16).requires_grad_()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = (sp.cuda_sparse_fwd.launches, sp.cuda_sparse_dq.launches,
              sp.cuda_sparse_dkv.launches)
    grads = []
    for _ in range(2):
        out = ops.sparse_attention(q, k, v, cfg)
        grads.append(torch.autograd.grad(out.float().square().sum(), qkv)[0])
    after = (sp.cuda_sparse_fwd.launches, sp.cuda_sparse_dq.launches,
             sp.cuda_sparse_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    assert torch.equal(grads[0], grads[1])
    want = sp.torch_sparse_attention(*(t.detach().contiguous()
                                       for t in (q, k, v)), cfg)
    _assert_rows("o", out, want, 2e-2)


@pytest.mark.requires_cuda
def test_sparse_unsupported_raises(cuda):
    from deepspeed_tpu_torch import ops
    q, k, v, _ = _sparse_case(cuda, torch.bfloat16, 4, 2, 64, T=128)
    lay = sp.FixedSparsityConfig().make_layout(128)
    with pytest.raises(ValueError, match="head_dim 36.*C.1"):
        sp.cuda_sparse_fwd(q[..., :36].contiguous(), k[..., :36].contiguous(),
                           v[..., :36].contiguous(), lay[:, :], 16)
    with pytest.raises(ValueError, match="block 12.*C.1"):
        sp.cuda_sparse_fwd(q[:, :120], k[:, :120], v[:, :120],
                           np.ones((10, 10), bool), 12)
    with pytest.raises(ValueError, match="float32/float16/bfloat16"):
        sp.cuda_sparse_fwd(q.double(), k.double(), v.double(), lay, 16)
    with pytest.raises(ValueError, match="does not support"):
        ops.sparse_attention(q[..., :36].contiguous(),
                             k[..., :36].contiguous(),
                             v[..., :36].contiguous(),
                             sp.FixedSparsityConfig(block=8))


EVO_CASES = {
    "both_d32": (32, 64, "both"),
    "b1_d8": (8, 13, "b1"),
    "b2_d16": (16, 64, "b2"),
    "none_d64": (64, 13, "none"),
    "both_d128_s100": (128, 100, "both"),
    "broadcast_d32_s383": (32, 383, "broadcast"),
    # bias2 [B, 1, H, 1, S], shared by every query (read element by element)
    "b2q_d32_s200": (32, 200, "b2q"),
    # AlphaFold2's MSA row call's S and D (both biases)
    "both_d32_s384": (32, 384, "both"),
    # head dims above 128: the CUDA-core variants
    "both_d160_s100": (160, 100, "both"),
    "broadcast_d256_s45": (256, 45, "broadcast"),
}


def _evo_case(dev, dtype, D, S, bias, B=1, N=3, H=4):
    """q, k, v [B, N, S, H, D], bias1 [B, N, 1, 1, S] fp32 (row 1 with a
    masked tail, row 2 all masked, where N has them) and bias2 [B, 1, H,
    S, S] in ``dtype``; ``bias``: "both", "b1", "b2", "none", "bothf32"
    (bias2 in fp32), "broadcast" (bias1 [B, 1, 1, 1, S], bias2 expanded
    over a doubled batch), or "b2q" / "b2qf32" (both biases, bias2 [B, 1,
    H, 1, S] shared by every query, in ``dtype`` / fp32)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, device=dev, generator=gen).to(dt)
    q, k, v = (rand(B, N, S, H, D) for _ in range(3))
    b1 = rand(B, N, 1, 1, S, dt=torch.float32)
    if N > 1:
        b1[:, 1, ..., -3:] = -1e9               # a masked tail on one row
    if N > 2:
        b1[:, 2] = -1e9                         # every key masked
    b2 = rand(B, 1, H, S, S, dt=torch.float32 if bias.endswith("f32")
              else dtype)
    if bias.startswith("b2q"):
        b2 = b2[..., :1, :]
    if bias == "broadcast":
        b1, b2 = b1[:, :1], b2.expand(2, 1, H, S, S)
        q, k, v = (torch.cat([x, x]) for x in (q, k, v))
    return q, k, v, (None if bias in ("b2", "none") else b1), \
        (None if bias in ("b1", "none") else b2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", sorted(EVO_CASES))
def test_evoformer_kernel_matches_plain(cuda, dtype, tol, case):
    q, k, v, b1, b2 = _evo_case(cuda, dtype, *EVO_CASES[case])
    o, lse = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
    o_ref, lse_ref = evo.torch_evoformer_fwd(q, k, v, b1, b2)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=0)
    _assert_rows("o", o, o_ref, tol)


FWD_PLAN_CASES = ([("flash", d, None) for d in (64, 96, 128, 192, 256)]
                  + [("evo", d, b2) for d in (16, 32, 64, 128)
                     for b2 in (None, torch.bfloat16, torch.float32)])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel,d,b2_dtype", FWD_PLAN_CASES)
def test_fwd_plan_is_what_the_kernel_takes(cuda, kernel, d, b2_dtype):
    """The wrappers' device-free plans (``flash_fwd_plan``, ``evo_fwd_plan``)
    mirror csrc/attn_fwd_hopper.cuh ``FwdLayout``: at every compiled width
    of the 16-bit forward, and for the evoformer at every bias2 width, the
    plan's shared memory fits the card's opt-in limit, and the kernel run
    on the plan's ring depth and Q slots (a launch the C side refuses
    raises) agrees with the plain version."""
    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    if kernel == "flash":
        assert fa.flash_fwd_plan(d)["smem"] <= optin
        q, k, v, _, kw = _flash_case(cuda, torch.bfloat16, T=200, D=d)
        o, lse = fa.cuda_flash_fwd(q, k, v, **kw)
        o_ref, lse_ref = fa.torch_flash_fwd(q, k, v, **kw)
    else:
        q, k, v, b1, b2 = _evo_case(cuda, torch.bfloat16, d, 200, "both")
        b2 = None if b2_dtype is None else b2.to(b2_dtype)
        assert evo.evo_fwd_plan(
            d, 0 if b2 is None else b2.element_size())["smem"] <= optin
        o, lse = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
        o_ref, lse_ref = evo.torch_evoformer_fwd(q, k, v, b1, b2)
    torch.testing.assert_close(lse, lse_ref, atol=2e-2, rtol=0)
    _assert_rows("o", o, o_ref, 2e-2)


BWD_PLAN_CASES = {
    f"d{d}": dict(D=d, T=200) for d in (64, 96, 128, 192, 256)}
BWD_PLAN_CASES.update({
    "d256_gqa_window_alibi": dict(D=256, N=4, Nkv=2, T=300, window=70,
                                  alibi=True),
    "d192_gqa_ragged": dict(D=192, N=6, Nkv=2, T=131),
    "d128_gqa4_window": dict(D=128, N=8, Nkv=2, T=517, window=129),
    "d64_alibi_ragged": dict(D=64, T=389, alibi=True),
    "d80_noncausal_ragged": dict(D=80, T=77, causal=False),
})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(BWD_PLAN_CASES))
def test_bwd_plan_is_what_the_kernel_takes(cuda, dtype, case):
    """``flash_bwd_plan`` mirrors csrc/attn_bwd_hopper.cuh ``BwdLayout``: at
    every compiled width, and with GQA, a window, alibi and a ragged T, the
    plan's shared memory fits the card's opt-in limit and dq and dk/dv run
    on the plan's ring depth and slots (a launch the C side refuses
    raises), each held per row to the plain backward on the same o and lse
    (2e-2 of the row's largest value; a row whose true value is ~0 against
    1% of the tensor's largest).  dq's delta = rowsum(o * do), made in its
    units, matches the eager fp32 sum; two runs are bitwise equal."""
    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    params = dict(BWD_PLAN_CASES[case])
    plan = fa.flash_bwd_plan(params["D"])
    assert plan["dq"]["smem"] <= optin and plan["dkv"]["smem"] <= optin
    q, k, v, do, kw = _flash_case(cuda, dtype, **params)
    o, lse = fa.torch_flash_fwd(q, k, v, **kw)
    runs = []
    for _ in range(2):
        delta = torch.full(lse.shape[:2] + lse.shape[3:], float("nan"),
                           device=cuda)
        dq = fa.cuda_flash_dq(q, k, v, o, lse, do, delta_out=delta, **kw)
        runs.append((delta, dq) + fa.cuda_flash_dkv(q, k, v, o, lse, do,
                                                     delta=delta, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    delta, dq, dk, dv = runs[0]
    want = fa._delta(o, do)
    assert (delta - want).abs().max() <= 1e-4 * want.abs().max()
    tol = 2e-2 if dtype == torch.bfloat16 else 4e-3
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                              fa.torch_flash_bwd(q, k, v, o, lse, do, **kw)):
        d = (got.float() - ref.float()).abs().amax(-1)
        floor = 1e-2 * ref.float().abs().max().item()
        row = d / ref.float().abs().amax(-1).clamp_min(floor)
        assert torch.isfinite(got).all(), name
        assert row.max().item() <= tol, (name, row.max().item())


def _evo_bwd_counts():
    f = evo.cuda_evoformer_bwd
    return [f.dq_launches, f.dkv_launches, f.db2_launches,
            f.db2_sum_launches, f.db1_launches]


# the backward's cases: the forward's at N 3, and the tensor-core routes'
# widths, lengths, row counts and bias layouts (D, S, bias, N)
EVO_BWD_CASES = {name: c + (3,) for name, c in EVO_CASES.items()}
EVO_BWD_CASES.update({
    "both_d16_s383_n5": (16, 383, "both", 5),
    "b2_d32_s13_n1": (32, 13, "b2", 1),
    "b1_d64_s383_n5": (64, 383, "b1", 5),
    "none_d128_s64_n1": (128, 64, "none", 1),
    "broadcast_d16_s64_n5": (16, 64, "broadcast", 5),
    "bothf32_d32_s200_n3": (32, 200, "bothf32", 3),
    "bothf32_d128_s13_n5": (128, 13, "bothf32", 5),
    "both_d64_s384_n1": (64, 384, "both", 1),
    "b2q_d128_s64_n5": (128, 64, "b2q", 5),
    "b2qf32_d16_s383_n3": (16, 383, "b2qf32", 3),
})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", sorted(EVO_BWD_CASES))
def test_evoformer_bwd_kernels_match_plain(cuda, dtype, tol, case):
    """dq (#14), dk/dv (#15), dbias2 (#16) and dbias1 (#17) against the
    plain backward on the same o and lse, per row; each kernel launches
    once, the bias kernels only with their bias, dbias2's second pass once
    on the tensor-core route (16-bit, D up to 128); two runs are bitwise
    equal."""
    D, S, bias, N = EVO_BWD_CASES[case]
    q, k, v, b1, b2 = _evo_case(cuda, dtype, D, S, bias, N=N)
    o, lse = evo.torch_evoformer_fwd(q, k, v, b1, b2)
    gen = torch.Generator(device=cuda).manual_seed(1)
    do = torch.randn(q.shape, device=cuda, generator=gen).to(dtype)
    before = _evo_bwd_counts()
    got = evo.cuda_evoformer_bwd(q, k, v, b1, b2, o, lse, do)
    want = evo.torch_evoformer_bwd(q, k, v, b1, b2, o, lse, do)
    tc = evo.tensor_core_bwd(q)
    assert [a - b for a, b in zip(_evo_bwd_counts(), before)] == \
        [1, 1, int(b2 is not None), int(b2 is not None and tc),
         int(b1 is not None)]
    for name, g, w in zip(("dq", "dk", "dv", "db1", "db2"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.shape == w.shape and g.dtype == w.dtype, name
            _assert_rows(name, g, w, tol)
    again = evo.cuda_evoformer_bwd(q, k, v, b1, b2, o, lse, do)
    torch.cuda.synchronize()
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["both_d32_s384", "b1_d8", "none_d64",
                                  "both_d128_s100", "b2q_d32_s200",
                                  "broadcast_d32_s383", "bothf32_d32_s200_n3",
                                  "b2q_d128_s64_n5"])
def test_evo_dq_makes_delta(cuda, dtype, case):
    """The tensor-core dq (#14) given no delta makes delta = rowsum(o·do)
    in its producer warps: dq against the plain backward per row, the
    delta against the eager fp32 sum (1e-4 of each row's value, 10% of the
    largest as the floor), two runs bitwise equal."""
    D, S, bias, N = EVO_BWD_CASES[case]
    q, k, v, b1, b2 = _evo_case(cuda, dtype, D, S, bias, N=N)
    o, lse = evo.torch_evoformer_fwd(q, k, v, b1, b2)
    gen = torch.Generator(device=cuda).manual_seed(5)
    do = torch.randn(q.shape, device=cuda, generator=gen).to(dtype)
    b1v, b2v = evo._bias_views(q, b1, b2)
    runs = [evo._bwd_kernel("dq", q, k, v, b1v, b2v, lse, None, do, o=o)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dq, delta = runs[0]
    want = evo.torch_evoformer_bwd(q, k, v, b1, b2, o, lse, do)[0]
    _assert_rows("dq", dq, want, 2e-2 if dtype == torch.bfloat16 else 4e-3)
    eager = evo._delta(o, do)
    assert delta.shape == eager.shape and delta.dtype == torch.float32
    _assert_rows("delta", delta.unsqueeze(-1), eager.unsqueeze(-1), 1e-4)


EVO_BWD_PLAN_CASES = [(d, b2) for d in (16, 32, 64, 128)
                      for b2 in (None, torch.bfloat16, torch.float32)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,b2_dtype", EVO_BWD_PLAN_CASES)
def test_evo_bwd_plan_is_what_the_kernel_takes(cuda, d, b2_dtype):
    """``evo_bwd_plan`` mirrors csrc/attn_bwd_hopper.cuh
    ``BwdLayout::evo_dkv`` and csrc/evoformer_bwd.cu ``Db2Layout``: at
    every compiled width of the 16-bit dk/dv and dbias2 and every bias2
    width, both kernels' shared memory fits the card's opt-in limit, and
    the backward run on the plan's ring depths, slots and chunks (a launch
    the C side refuses raises; N 37 splits unevenly) agrees per row with
    the plain backward and gives the same bits twice; the second pass on a
    partial of the plan's shape equals its plain version bitwise."""
    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    q, k, v, b1, b2 = _evo_case(cuda, torch.bfloat16, d, 200, "both", N=37,
                                H=2)
    b2 = None if b2_dtype is None else b2.to(b2_dtype)
    plan = evo.evo_bwd_plan(d, 0 if b2 is None else b2.element_size(), 1,
                            37, 200, 2, evo._sms(q.device.index))
    assert plan["dkv"]["smem"] <= optin and plan["db2"]["smem"] <= optin
    o, lse = evo.torch_evoformer_fwd(q, k, v, b1, b2)
    gen = torch.Generator(device=cuda).manual_seed(3)
    do = torch.randn(q.shape, device=cuda, generator=gen).to(q.dtype)
    runs = [evo.cuda_evoformer_bwd(q, k, v, b1, b2, o, lse, do)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(g is None or torch.equal(g, a) for g, a in zip(*runs))
    want = evo.torch_evoformer_bwd(q, k, v, b1, b2, o, lse, do)
    for name, g, w in zip(("dq", "dk", "dv", "db1", "db2"), runs[0], want):
        if w is not None:
            _assert_rows(name, g, w, 2e-2)
    part = torch.randn((plan["db2"]["chunks"], 1, 2, 200, 200), device=cuda,
                       generator=gen)
    assert torch.equal(evo.cuda_evoformer_db2_sum(part),
                       evo.torch_evoformer_db2_sum(part))


@pytest.mark.requires_cuda
def test_evoformer_op_on_card(cuda):
    """The op pads S 45 as the reference does and runs the kernel, equal to
    the same op on CPU copies (the same padded problem: a row whose every
    key is -1e9 attends over the padded keys too, as in the reference).
    Its backward runs the four backward kernels once each and equals the
    CPU on copies: the plain backward on CPU copies of the padded problem
    and of the o and lse the forward kernel gave, mapped to the inputs
    through the op's padding and the callers' broadcasts (bias1
    [B, 1, 1, 1, S], bias2 expanded over B) by CPU autograd.  (CPU autograd
    of the plain body differs from the kernel formula by design: delta =
    rowsum(o·do) takes o rounded to bf16, as the reference's kernels do,
    which moves a cancelling dq row beyond the 2e-2 row check.)  A
    ``.sum().backward()`` (a do of stride 0) works; the reference's einsum
    shapes raise on CUDA tensors."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch import ops
    q, k, v, b1, b2 = _evo_case(cuda, torch.bfloat16, 16, 45, "both")
    before = evo.cuda_evoformer_fwd.launches
    out = ops.evoformer_attention(q, k, v, b1, b2)
    assert evo.cuda_evoformer_fwd.launches == before + 1
    want = ops.evoformer_attention(*(x.cpu() for x in (q, k, v, b1, b2)))
    _assert_rows("o", out.cpu(), want, 2e-2)
    q, k, v, b1, b2 = _evo_case(cuda, torch.bfloat16, 16, 45, "broadcast")
    b1 = b1.clone()
    b1[..., -5:] = -1e9                         # a masked tail on every row
    w = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    leaves = [x.detach().requires_grad_() for x in (q, k, v, b1, b2[:1])]
    before = _evo_bwd_counts()
    out = ops.evoformer_attention(*leaves[:4], leaves[4].expand(
        2, *b2.shape[1:]))
    (out.float() * w).sum().backward()
    assert [a - b for a, b in zip(_evo_bwd_counts(), before)] == \
        [1, 1, 1, 1, 1]
    cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v, b1, b2[:1])]
    prob = evo._padded(*cpu[:4], cpu[4].expand(2, *b2.shape[1:]))
    flat = [t.detach() for t in prob]
    o, lse = evo.cuda_evoformer_fwd(*(t.to(cuda) for t in flat))
    do = F.pad(w.cpu().to(torch.bfloat16),
               (0, 0, 0, 0, 0, flat[0].shape[2] - 45))
    raw = evo.torch_evoformer_bwd(*flat, o.cpu(), lse.cpu(), do)
    torch.autograd.backward(prob, list(raw[:3]) + list(
        evo._bias_grads(raw[3], raw[4], flat[3], flat[4])))
    for name, g, c in zip(("dq", "dk", "dv", "db1", "db2"), leaves, cpu):
        assert g.grad.shape == c.grad.shape, name
        assert g.grad.dtype == c.grad.dtype, name
        _assert_rows(name, g.grad.cpu(), c.grad, 2e-2)
    qs = q[:, :, :32].detach().contiguous().requires_grad_()
    ops.evoformer_attention(qs, k[:, :, :32], v[:, :, :32]).sum().backward()
    qo = qs.detach().requires_grad_()
    ops.evoformer_attention(qo, k[:, :, :32], v[:, :, :32]).backward(
        torch.ones(qs.shape, dtype=qs.dtype, device=cuda))
    assert torch.equal(qs.grad, qo.grad)
    q4 = q[..., :4].contiguous()
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.evoformer_attention(q4, q4, q4)
