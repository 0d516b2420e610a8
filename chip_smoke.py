#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

1. The card (name and power limit from nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel of the serving and training
   paths from the sources in this checkout (one nvcc per source, started
   together).
2. Each kernel against its plain PyTorch version on the card at Llama-3-8B
   attention shapes (bf16, nkv=8, g=4, hd=128, 64-token pages, 16 slots,
   KV lengths 0..2048, shuffled block tables) in every variant: plain,
   sliding window, alibi, and the one-pass (one-page table) and split
   decode.  Each output row (one query head of one token) may differ from
   the plain version by ROW_TOL of its largest value; the check is shown
   to catch one lost page of the longest slot.  The plain case is timed as
   in phase 5.
3. Small-config parity: the test model (2 layers, hidden 128, GQA g=2) in
   fp32 with TF32 off — greedy ``generate`` on the card equals the same on
   the CPU token for token, through chunking, bursts and preemption.
4. The main path at full Llama-3-8B width (32 layers, bf16, random weights
   from a seeded generator on the card): ``InferenceEngineV2.generate``
   serves 16 seeded requests of 64..1024 prompt tokens and 64..128 new
   tokens; both kernels' launch counters must rise during it.  The inputs
   of each kernel's first-layer calls are kept (by reference).
5. Each kernel against its plain version on the heaviest of those calls,
   with CUDA-event median device times of the kernel, the plain version
   and one PyTorch SDPA call over the gathered dense K/V, beside the least
   time the card could take (``bound_ms``).

6. The three flash-attention kernels (forward, dq, dk/dv) against their
   plain versions in bf16, per output row at ROW_TOL (lse: absolute), at
   the training main path's shape, Llama-3-8B attention, a window, alibi,
   alibi + window + GQA and a non-causal case; the check is shown to catch
   one dropped K tile.  Each kernel is timed beside its bound, its plain
   version and SDPA (forward; backward through autograd for dq + dk/dv).
7. Small-config training parity: 2 layers, hidden 128, 2 heads x 64, T 128,
   fp32 with TF32 off - three ``train_batch`` steps (gas 2) on the card
   equal the same on the CPU in loss, grad norm and every parameter (1e-4).
8. The training main path at full GPT-2-small width (12 layers, hidden 768,
   12 heads x 64, vocabulary 50304, T 1024, bf16, ZeRO-2 config, AdamW,
   clipping; 16 x 2 x 1024 tokens a step, random weights from a seeded
   generator on the card): ``initialize`` then 2 warm-up and 8 timed
   ``train_batch`` steps on one fixed batch and one ``eval_batch``.  The
   loss must fall and stay finite, no step may be skipped, and each flash
   kernel must launch 24 times a step.  The first layer's flash inputs of
   one step are kept and the kernels held to their plain versions on them
   and timed.  ``--phases 8 --profile`` prints device time by kernel.

The line before the last is one JSON object with every kernel's numbers;
the last line is the device line.  Any failed check exits non-zero.
Without a CUDA device, or outside a checkout of the repository, the script
exits non-zero and prints no result.
"""

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
ROW_TOL = 2e-2                  # of each output row's largest value


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median of per-call CUDA-event times, device time only: the stream is
    held by a spin kernel while the host enqueues every call, so the event
    pairs never bracket the host's launch overhead (a kernel shorter than
    its Python wrapper would otherwise read as the wrapper's time)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)    # ~0.1 s of device cycles
    evs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


# --------------------------------------------------------------- phase 2

FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
ERRS = dict.fromkeys(("paged_attention", "ragged_prefill") + FLASH, 0.0)
# ^ max |kernel - plain| seen per kernel


def _row_err(torch, got, want):
    """Worst output row's max |got - want| over that row's max |want| (a
    row: one query head of one token, hd values)."""
    d = (got.float() - want.float()).abs().amax(-1)
    return (d / want.float().abs().amax(-1).clamp_min(1e-6)).max().item()


def _check(torch, name, label, got, want):
    """Hold a kernel's output to its plain version, row by row: a row may
    differ by ROW_TOL of its largest value (one bf16 rounding of the output
    is at most 2^-7 of it)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    row = _row_err(torch, got, want)
    print(f"  {name}[{label}] max|kernel-plain| = {err:.3e}, worst row "
          f"{row:.3e} of its max", flush=True)
    if not (row <= ROW_TOL) or not torch.isfinite(got).all():
        fail(f"{name} {label}: row error {row} > {ROW_TOL}")
    ERRS[name] = max(ERRS[name], err)


def _paged_case(torch, rng, dev, S=16, nkv=8, g=4, hd=128, bs=64, max_len=2048,
                dtype=None):
    """Pages of 16 slots with mixed KV lengths (0 .. max_len) behind one
    shuffled block table [S, max_len/bs] — the width the engine passes when
    its longest sequence holds max_len tokens."""
    MB = max_len // bs
    NB = S * MB + 8
    lens = np.array([0, 1, 63, 64, 65, 200, 511, 700, 1000, 1024, 1300,
                     1536, 1777, 2000, 2047, 2048][:S], np.int32)
    bt = rng.permutation(NB)[:S * MB].reshape(S, MB).astype(np.int32)
    k = torch.randn((NB, nkv, bs, hd), device=dev).to(dtype)
    v = torch.randn((NB, nkv, bs, hd), device=dev).to(dtype)
    return (k, v, torch.from_numpy(bt).to(dev), torch.from_numpy(lens).to(dev),
            lens)


def _dense_kv(torch, k, v, bt):
    """[S, nkv, MB*bs, hd] gathered K/V for the library (SDPA) timing."""
    S, MB = bt.shape
    NB, nkv, bs, hd = k.shape
    kd = k[bt.long()].permute(0, 2, 1, 3, 4).reshape(S, nkv, MB * bs, hd)
    vd = v[bt.long()].permute(0, 2, 1, 3, 4).reshape(S, nkv, MB * bs, hd)
    return kd.contiguous(), vd.contiguous()


def _sdpa(torch, q, kd, vd, mask):
    """One PyTorch SDPA call over dense K/V with native GQA (torch >= 2.5);
    older versions get the kv heads expanded beforehand."""
    import torch.nn.functional as F
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask, enable_gqa=True)
    rep = q.shape[1] // kd.shape[1]
    ke, ve = (t.repeat_interleave(rep, dim=1) for t in (kd, vd))
    return lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _time_decode(torch, pa, q, k, v, bt, lens, kw):
    """Kernel, plain and SDPA device times of one decode call, and its
    bound: each live key's K and V read once, q read and the output written
    once, plus the live table entries (no window: every key is live)."""
    assert kw.get("window") is None
    S, nkv, g, hd = q.shape
    bs, nh, esize = k.shape[2], nkv * g, q.element_size()
    lens_np = lens.cpu().numpy().astype(np.int64)
    live = int(lens_np.sum())
    nbytes = (live * nkv * hd * 2 * esize + 2 * q.numel() * esize
              + int((-(-lens_np // bs)).sum()) * 4 + S * 4)
    bound_ms, bound_by = _bound(nbytes, 4 * hd * nh * live)
    kd, vd = _dense_kv(torch, k, v, bt)
    K = kd.shape[2]
    mask = (torch.arange(K, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    ms = cuda_ms(lambda: pa.cuda_paged_attention(q, k, v, bt, lens, **kw))
    return dict(
        shape=f"q[{S},{nkv},{g},{hd}] table[{S},{bt.shape[1]}] "
              f"({pa.num_kv_splits_for(S, nkv, bt.shape[1], q.device)} "
              f"splits) pages[{k.shape[0]},{nkv},{bs},{hd}] {q.dtype} "
              f"kv_lens {lens_np.min()}..{lens_np.max()} (sum {live})",
        ms=ms,
        plain_ms=cuda_ms(lambda: pa.torch_paged_attention(
            q, k, v, bt, lens, **kw), reps=10),
        library_ms=cuda_ms(_sdpa(torch, q.reshape(S, nh, 1, hd), kd, vd,
                                 mask)),
        bound_ms=bound_ms, bound_by=bound_by)


def _time_prefill(torch, pa, q, k, v, bt, kvl, starts, counts, kw):
    """The same for one ragged-prefill call.  Bytes: q of the live rows,
    the whole output (dead rows are written as zeros), each slot's visible
    K and V once, the live table entries; operations: 4·hd per (live row,
    visible key) pair and query head (no window)."""
    assert kw.get("window") is None
    S, Q, nkv, g, hd = q.shape
    bs, nh, esize = k.shape[2], nkv * g, q.element_size()
    kvl_np, s_np, c_np = (t.cpu().numpy().astype(np.int64)
                          for t in (kvl, starts, counts))
    keys = np.where(c_np > 0, np.minimum(kvl_np, s_np + c_np), 0)
    qpos = s_np[:, None] + np.arange(Q)[None]
    live = np.arange(Q)[None] < c_np[:, None]
    visible = int(np.where(live, np.minimum(qpos + 1, kvl_np[:, None]),
                           0).sum())
    nbytes = (int(c_np.sum()) * nh * hd * esize + q.numel() * esize
              + int(keys.sum()) * nkv * hd * 2 * esize
              + int((-(-keys // bs)).sum()) * 4 + 3 * S * 4)
    bound_ms, bound_by = _bound(nbytes, 4 * hd * nh * visible)
    kd, vd = _dense_kv(torch, k, v, bt)
    dev = q.device
    kpos = torch.arange(kd.shape[2], device=dev)
    qp = torch.from_numpy(qpos).to(dev)
    pmask = ((kpos[None, None] <= qp[:, :, None])
             & (kpos[None, None] < kvl[:, None, None])
             & torch.from_numpy(live).to(dev)[:, :, None])[:, None]
    qsd = q.reshape(S, Q, nh, hd).transpose(1, 2)
    return dict(
        shape=f"q[{S},{Q},{nkv},{g},{hd}] table[{S},{bt.shape[1]}] "
              f"pages[{k.shape[0]},{nkv},{bs},{hd}] {q.dtype}, "
              f"{int(c_np.sum())} live rows, {visible} visible (row, key) "
              f"pairs per head",
        ms=cuda_ms(lambda: pa.cuda_ragged_prefill(q, k, v, bt, kvl, starts,
                                                  counts, **kw)),
        plain_ms=cuda_ms(lambda: pa.torch_ragged_prefill(
            q, k, v, bt, kvl, starts, counts, **kw), reps=5),
        library_ms=cuda_ms(_sdpa(torch, qsd, kd, vd, pmask)),
        bound_ms=bound_ms, bound_by=bound_by)


def _print_times(results):
    for name, r in results.items():
        print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)


def phase_kernels(torch, pa, dev):
    """Each kernel against its plain version on Llama-3-8B attention shapes
    with every variant: dead and full slots, shuffled pages, a window, alibi,
    the one-pass decode (one-page table) and the split decode."""
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    dt = torch.bfloat16
    S, nkv, g, hd, bs = 16, 8, 4, 128, 64
    nh = nkv * g
    k, v, bt, lens, lens_np = _paged_case(torch, rng, dev, dtype=dt)
    slopes = torch.from_numpy(
        np.geomspace(0.5, 1 / 256, nh).astype(np.float32)).to(dev)
    cases = {"plain": {}, "window512": {"window": 512},
             "alibi": {"alibi_slopes": slopes}}

    # ---- paged decode
    q = torch.randn((S, nkv, g, hd), device=dev).to(dt)
    bt1, lens1 = bt[:, :1].contiguous(), lens.clamp(max=bs)
    for name, kw in cases.items():
        for label, table, kv in ((name, bt, lens),
                                 (f"{name}, one page", bt1, lens1)):
            _check(torch, "paged_attention", label,
                   pa.cuda_paged_attention(q, k, v, table, kv, **kw),
                   pa.torch_paged_attention(q, k, v, table, kv, **kw))
    # the row check must see one lost page of the longest slot
    want = pa.torch_paged_attention(q, k, v, bt, lens)
    lost = bt.clone()
    lost[S - 1, 5] = int(np.setdiff1d(np.arange(k.shape[0]),
                                      bt.cpu().numpy())[0])  # unused page
    r = _row_err(torch, pa.torch_paged_attention(q, k, v, lost, lens), want)
    print(f"  one lost page of a {int(lens_np[-1])}-token slot moves its "
          f"worst row by {r:.3e} of its max (check at {ROW_TOL})", flush=True)
    if not r > ROW_TOL:
        fail("the kernel check cannot see a lost page")
    results = {"paged_attention": _time_decode(torch, pa, q, k, v, bt, lens,
                                               {})}

    # ---- ragged prefill: a mixed step (dead slot, decodes, chunk
    # continuations, fresh chunks) at the engine's max_q_per_seq = 128
    Q = 128
    counts = np.array([0, 1, 1, 37, 128, 128, 5, 128, 64, 1, 128, 17, 128,
                       100, 128, 1], np.int32)
    kvl = np.minimum(np.maximum(lens_np, counts), 2048).astype(np.int32)
    lens2, q_starts, q_counts = (torch.from_numpy(a).to(dev)
                                 for a in (kvl, kvl - counts, counts))
    qp = torch.randn((S, Q, nkv, g, hd), device=dev).to(dt)
    for name, kw in cases.items():
        _check(torch, "ragged_prefill", name,
               pa.cuda_ragged_prefill(qp, k, v, bt, lens2, q_starts, q_counts,
                                      **kw),
               pa.torch_ragged_prefill(qp, k, v, bt, lens2, q_starts,
                                       q_counts, **kw))
    results["ragged_prefill"] = _time_prefill(
        torch, pa, qp, k, v, bt, lens2, q_starts, q_counts, {})
    _print_times(results)
    return results


# --------------------------------------------------------------- phase 3

def phase_parity(torch, dev):
    """Greedy generate on the card == on the CPU, fp32, TF32 off."""
    import dataclasses
    from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        GPTConfig.llama(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
                        vocab_size=512, max_seq_len=256), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ecfg = {"dtype": "fp32",
            "state_manager": {"max_tracked_sequences": 4,
                              "max_ragged_batch_size": 64,
                              "kv_block_size": 8, "max_q_per_seq": 8,
                              "num_kv_blocks": 10}}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (18 + 5 * i,)).astype(np.int32)
               for i in range(4)]
    out = {}
    for d in ("cpu", dev):
        eng = InferenceEngineV2(cfg, config=ecfg, params=params, device=d)
        out[d] = eng.generate(prompts, max_new_tokens=20)
        print(f"  {d}: preemptions {eng.preempt_stats}, dispatches "
              f"{eng.dispatches}", flush=True)
    for i, (a, b) in enumerate(zip(out["cpu"], out[dev])):
        if not np.array_equal(a, b):
            fail(f"small-config parity: request {i} differs\n cpu  {a}\n "
                 f"cuda {b}")
    print(f"  greedy tokens equal on cpu and {dev} "
          f"({sum(len(o) for o in out['cpu'])} tokens)", flush=True)


# --------------------------------------------------------------- phase 4

def _report_profile(torch, prof, wall, reps=1, unprofiled=None):
    """Device time by kernel over the profiled window, and the device's
    busy share of the wall time (an opt-in diagnostic: the profiler slows
    the host side of the run, so where the window is ``reps`` repeats of
    work whose ``unprofiled`` wall time is known, the busy time of one
    repeat is also held against that)."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: -e.self_device_time_total)
    print(f"  profile: device busy {busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} "
          f"ms wall ({busy_us / 1e4 / wall:.1f}%)"
          + ("" if unprofiled is None else
             f"; {busy_us / 1e3 / reps:.1f} ms a repeat against "
             f"{unprofiled * 1e3:.1f} ms unprofiled "
             f"({busy_us / 1e4 / reps / unprofiled:.1f}%)")
          + "; top kernels:", flush=True)
    for e in rows[:25]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
              f"{e.key[:90]}", flush=True)


def phase_main(torch, pa, dev, card, profile=False):
    """InferenceEngineV2.generate at full Llama-3-8B width."""
    from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import count_params, init_params
    cfg = GPTConfig.llama(num_layers=32, hidden=4096, heads=32,
                          num_kv_heads=8, vocab_size=128256,
                          max_seq_len=8192, mlp_dim_override=14336,
                          rope_theta=500000.0, norm_eps=1e-5,
                          dtype=torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  Llama-3-8B width, {count_params(cfg) / 1e9:.3f}B params, "
          f"bf16 weights on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    n_seq, bs = 16, 64
    eng = InferenceEngineV2(cfg, config={
        "dtype": "bfloat16",
        "state_manager": {"max_tracked_sequences": n_seq,
                          "kv_block_size": bs,
                          "num_kv_blocks": n_seq * 2048 // bs}},
        params=params, device=dev)
    del params
    pool = eng.cache.k_flat.numel() * 2 * eng.cache.k_flat.element_size()
    print(f"  KV pool {pool / 1e9:.2f} GB ({n_seq * 2048 // bs} blocks x "
          f"{bs} tokens x 32 layers)", flush=True)
    rng = np.random.default_rng(0)
    plens = rng.integers(64, 1025, n_seq)
    news = rng.integers(64, 129, n_seq)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in plens]
    torch.cuda.reset_peak_memory_stats()
    calls = _record_calls(eng.cache.k_flat)
    pa.cuda_paged_attention.launches = 0
    pa.cuda_ragged_prefill.launches = 0
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        prof = (stack.enter_context(torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])) if profile else None)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as syncs:
            # every host<->device synchronisation inside generate warns once
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            outs = eng.generate(prompts,
                                max_new_tokens=[int(n) for n in news])
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.cuda_paged_attention.launches,
                "ragged_prefill": pa.cuda_ragged_prefill.launches}
    calls.restore()
    if prof is not None:
        _report_profile(torch, prof, wall)
    sync_sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs
                  if "synchroniz" in str(w.message)]
    n_sync = len(sync_sites)
    for name, n in launches.items():
        if n <= 0:
            fail(f"main path never launched the {name} kernel")
    for i, (o, n) in enumerate(zip(outs, news)):
        if len(o) != int(n):
            fail(f"request {i}: {len(o)} tokens, expected {int(n)}")
        if o.min() < 0 or o.max() >= cfg.vocab_size:
            fail(f"request {i}: token outside the vocab")
    n_new = int(sum(len(o) for o in outs))
    peak = torch.cuda.max_memory_allocated()
    print(f"  served {n_seq} requests: {int(plens.sum())} prompt + {n_new} "
          f"generated tokens in {wall:.2f} s = {n_new / wall:.1f} generated "
          f"tok/s ({(int(plens.sum()) + n_new) / wall:.1f} tok/s with the "
          f"prompts); dispatches {eng.dispatches}; preemptions "
          f"{eng.preempt_stats}; peak memory {peak / 1e9:.2f} GB; card "
          f"{card}", flush=True)
    print(f"  kernel launches on the main path: {launches}; host syncs "
          f"inside generate: {n_sync} {sorted(set(sync_sites))}", flush=True)
    # the served model's logits are finite at full width
    logits = eng.put([10 ** 6], [prompts[0][:32]])
    if logits.shape != (1, cfg.vocab_size) or not np.isfinite(logits).all():
        fail(f"put() logits {logits.shape} not finite/of the vocab width")
    return launches, calls, eng, dict(
        wall_s=wall, generated_tokens=n_new, prompt_tokens=int(plens.sum()),
        generated_tok_per_s=n_new / wall, peak_memory_gb=peak / 1e9,
        host_syncs=n_sync, dispatches=dict(eng.dispatches))


class _record_calls(dict):
    """While installed, keeps the inputs of every first-layer call of each
    kernel on the main path, by reference (no copy, no sync), so that
    phase 5 can hold the kernels to their plain versions at the shapes the
    main path gave them.  The kernels and their launch counts are
    untouched; ``pick`` chooses the call with the most work after the run."""
    OPS = {"paged_attention": "paged_attention",
           "ragged_prefill_attention": "ragged_prefill"}

    def __init__(self, first_pages):
        super().__init__({name: [] for name in self.OPS.values()})
        from deepspeed_tpu_torch.ops import registry
        self._specs = {op: registry._REGISTRY[op] for op in self.OPS}
        self._kernels = {op: spec.kernel for op, spec in self._specs.items()}
        for op, spec in self._specs.items():
            spec.kernel = self._recorder(self.OPS[op], spec.kernel,
                                         first_pages.data_ptr())

    def _recorder(self, name, kernel, first_ptr):
        def call(*args, **kw):
            if args[1].data_ptr() == first_ptr:
                self[name].append((args, kw))
            return kernel(*args, **kw)
        return call

    def restore(self):
        for op, spec in self._specs.items():
            spec.kernel = self._kernels[op]

    def pick(self):
        """The decode call with the most live keys, the prefill call with
        the most live rows (the last of equals)."""
        work = {"paged_attention": lambda a: a[4].sum(),
                "ragged_prefill": lambda a: a[6].sum()}
        return {name: max(reversed(self[name]),
                          key=lambda c: int(work[name](c[0])))
                for name in self}


# --------------------------------------------------------------- phase 5

def phase_main_inputs(torch, pa, calls, eng):
    """Each kernel held to its plain version, and timed, on the inputs of
    its heaviest first-layer call on the main path (the KV pool as generate
    left it).  The decode call is also timed with its table padded to the
    engine's max_blocks_per_seq columns, the width it had before the engine
    cut tables to their live blocks."""
    results = {}
    calls = calls.pick()
    (q, k, v, bt, lens), kw = calls["paged_attention"]
    _check(torch, "paged_attention", "main path",
           pa.cuda_paged_attention(q, k, v, bt, lens, **kw),
           pa.torch_paged_attention(q, k, v, bt, lens, **kw))
    results["paged_attention"] = _time_decode(torch, pa, q, k, v, bt, lens,
                                              kw)
    full = torch.zeros((bt.shape[0], eng.state.max_blocks_per_seq),
                       dtype=bt.dtype, device=bt.device)
    full[:, :bt.shape[1]] = bt
    _check(torch, "paged_attention", "main path, full-width table",
           pa.cuda_paged_attention(q, k, v, full, lens, **kw),
           pa.torch_paged_attention(q, k, v, full, lens, **kw))
    wide = _time_decode(torch, pa, q, k, v, full, lens, kw)
    args, kw = calls["ragged_prefill"]
    _check(torch, "ragged_prefill", "main path",
           pa.cuda_ragged_prefill(*args, **kw),
           pa.torch_ragged_prefill(*args, **kw))
    results["ragged_prefill"] = _time_prefill(torch, pa, *args, kw)
    _print_times(dict(results, paged_attention_full_width=wide))
    return results


# --------------------------------------------------------------- phase 6

def _check_rows(torch, name, label, got, want, tol=ROW_TOL):
    """As ``_check``, but a row whose true value is ~0 (the first query's
    dq: it sees one key, so dp - delta cancels) is judged against 1% of the
    tensor's largest value instead of its own."""
    torch.cuda.synchronize()
    wf = want.float()
    d = (got.float() - wf).abs().amax(-1)
    floor = 1e-2 * wf.abs().max().item()
    row = (d / wf.abs().amax(-1).clamp_min(floor)).max().item()
    err = d.max().item()
    print(f"  {name}[{label}] max|kernel-plain| = {err:.3e}, worst row "
          f"{row:.3e} of its max", flush=True)
    if not (row <= tol) or not torch.isfinite(got).all():
        fail(f"{name} {label}: row error {row} > {tol}")
    ERRS[name] = max(ERRS[name], err)
    return row


def _flash_inputs(torch, dev, B, T, N, Nkv, D, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    return (rand(B, T, N, D), rand(B, T, Nkv, D), rand(B, T, Nkv, D),
            rand(B, T, N, D))


def _check_flash(torch, fa, label, q, k, v, do, kw):
    """o, lse, dq, dk, dv of the three kernels against the plain versions
    (the backward kernels get the plain o and lse, so each is judged on its
    own)."""
    o, lse = fa.cuda_flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.torch_flash_fwd(q, k, v, **kw)
    _check_rows(torch, "flash_fwd", label + " o", o, o_ref)
    lerr = (lse - lse_ref).abs().max().item()
    print(f"  flash_fwd[{label} lse] max|kernel-plain| = {lerr:.3e}",
          flush=True)
    if not lerr <= ROW_TOL:
        fail(f"flash_fwd {label}: lse differs by {lerr}")
    dq = fa.cuda_flash_dq(q, k, v, o_ref, lse_ref, do, **kw)
    dk, dv = fa.cuda_flash_dkv(q, k, v, o_ref, lse_ref, do, **kw)
    dq_ref, dk_ref, dv_ref = fa.torch_flash_bwd(q, k, v, o_ref, lse_ref, do,
                                                **kw)
    _check_rows(torch, "flash_dq", label + " dq", dq, dq_ref)
    _check_rows(torch, "flash_dkv", label + " dk", dk, dk_ref)
    _check_rows(torch, "flash_dkv", label + " dv", dv, dv_ref)
    return o_ref, lse_ref


def _live_pairs(T, causal, window):
    """Visible (query, key) pairs of one head."""
    if not causal:
        return T * T
    qpos = np.arange(T, dtype=np.int64)
    return int(np.minimum(qpos + 1, window if window else T).sum())


def _time_flash(torch, fa, q, k, v, do, kw, library=True):
    """Device times of the three kernels, of the plain forward and backward
    and of SDPA forward / backward on the same inputs, beside each kernel's
    bound.  Operations: 2*D flops per visible (query, key) pair and product
    - the forward has 2 products (s, p v), dq 3 (s, dp, ds k), dk/dv 4
    (s, dp, pT do, dsT q).  Bytes: each input once, each output once."""
    import torch.nn.functional as F
    B, T, N, D = q.shape
    Nkv = k.shape[2]
    e = q.element_size()
    pairs = _live_pairs(T, kw.get("causal", True), kw.get("window")) * B * N
    nq, nk, rows = q.numel() * e, k.numel() * e, B * N * T * 4
    o, lse = fa.torch_flash_fwd(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    bounds = {
        "flash_fwd": _bound(nq + 2 * nk + nq + rows, 4 * D * pairs),
        "flash_dq": _bound(2 * nq + 2 * nk + 2 * rows + nq, 6 * D * pairs),
        "flash_dkv": _bound(2 * nq + 2 * nk + 2 * rows + 2 * nk,
                            8 * D * pairs)}
    ms = {
        "flash_fwd": cuda_ms(lambda: fa.cuda_flash_fwd(q, k, v, **kw)),
        "flash_dq": cuda_ms(lambda: fa.cuda_flash_dq(
            q, k, v, o, lse, do, delta=delta, **kw)),
        "flash_dkv": cuda_ms(lambda: fa.cuda_flash_dkv(
            q, k, v, o, lse, do, delta=delta, **kw))}
    plain_fwd = cuda_ms(lambda: fa.torch_flash_fwd(q, k, v, **kw), reps=5)
    plain_bwd = cuda_ms(lambda: fa.torch_flash_bwd(q, k, v, o, lse, do, **kw),
                        reps=5)
    lib_fwd = lib_bwd = None
    if library and kw.get("window") is None \
            and kw.get("alibi_slopes") is None:
        qs, ks_, vs = (t.transpose(1, 2).detach().requires_grad_()
                       for t in (q, k, v))
        dos = do.transpose(1, 2)
        sd = dict(is_causal=kw.get("causal", True))
        if Nkv != N:
            sd["enable_gqa"] = True
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs.detach(), ks_.detach(), vs.detach(), **sd))
        out = F.scaled_dot_product_attention(qs, ks_, vs, **sd)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks_, vs), dos, retain_graph=True))
    shape = (f"q[{B},{T},{N},{D}] kv heads {Nkv} {q.dtype} "
             + ", ".join(f"{a}={b if not hasattr(b, 'shape') else 'yes'}"
                         for a, b in kw.items() if b is not None))
    res = {}
    for name in FLASH:
        res[name] = dict(
            shape=shape, ms=ms[name],
            plain_ms=plain_fwd if name == "flash_fwd" else plain_bwd,
            library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
            bound_ms=bounds[name][0], bound_by=bounds[name][1])
    print(f"  {shape}: fwd {ms['flash_fwd']:.4f} ms (bound "
          f"{bounds['flash_fwd'][0]:.4f}), dq {ms['flash_dq']:.4f} ms "
          f"(bound {bounds['flash_dq'][0]:.4f}), dk/dv "
          f"{ms['flash_dkv']:.4f} ms (bound {bounds['flash_dkv'][0]:.4f}); "
          f"plain fwd {plain_fwd:.3f} ms, plain bwd (dq+dk+dv) "
          f"{plain_bwd:.3f} ms; SDPA fwd "
          f"{'-' if lib_fwd is None else format(lib_fwd, '.4f')} ms, SDPA "
          f"bwd (dq+dk+dv) "
          f"{'-' if lib_bwd is None else format(lib_bwd, '.4f')} ms",
          flush=True)
    return res


def phase_flash(torch, fa, dev):
    """Kernels #3-#5 against their plain versions, every variant."""
    from deepspeed_tpu_torch.ops import _attention_torch
    slopes12 = np.geomspace(0.5, 1 / 256, 12).astype(np.float32)
    slopes8 = np.geomspace(0.5, 1 / 256, 8).astype(np.float32)
    cases = [
        ("main path", (16, 1024, 12, 12, 64), dict(causal=True)),
        ("Llama-3-8B", (2, 2048, 32, 8, 128), dict(causal=True)),
        ("window 512", (2, 2048, 32, 8, 128), dict(causal=True, window=512)),
        ("alibi", (4, 1024, 12, 12, 64),
         dict(causal=True, alibi_slopes=slopes12)),
        ("alibi + window + GQA, ragged T", (2, 1000, 8, 2, 64),
         dict(causal=True, window=200, alibi_slopes=slopes8)),
        ("non-causal", (4, 1024, 12, 12, 64), dict(causal=False)),
    ]
    results = {}
    for label, dims, kw in cases:
        q, k, v, do = _flash_inputs(torch, dev, *dims)
        _check_flash(torch, fa, label, q, k, v, do, kw)
        if label in ("main path", "Llama-3-8B", "window 512"):
            r = _time_flash(torch, fa, q, k, v, do, kw)
            if label == "main path":
                results = r
        del q, k, v, do
        torch.cuda.empty_cache()
    # the row check must see one dropped K tile (64 keys)
    q, k, v, _ = _flash_inputs(torch, dev, 2, 1024, 12, 12, 64)
    want, _ = fa.torch_flash_fwd(q, k, v)
    mask = torch.ones((1024, 1024), dtype=torch.bool, device=dev).tril()
    mask[:, 128:192] = False
    mask[128:192] = mask[128:192] | torch.eye(1024, dtype=torch.bool,
                                              device=dev)[128:192]
    lost = _attention_torch(q, k, v, causal=False, mask=mask[None])
    r = _row_err(torch, lost, want)
    print(f"  one dropped K tile (keys 128..191) moves the worst row by "
          f"{r:.3e} of its max (check at {ROW_TOL})", flush=True)
    if not r > ROW_TOL:
        fail("the flash check cannot see a dropped K tile")
    return results


# --------------------------------------------------------------- phase 7

def phase_train_parity(torch, dev):
    """Three train_batch steps of a small model, cuda against cpu."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import (GPTChunkedLoss, GPTConfig,
                                            params_to_numpy)
    from deepspeed_tpu_torch.models.gpt import _flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    for d in ("cpu", dev):
        model = GPTChunkedLoss(cfg)     # the same CPU-seeded weights
        eng, *_ = ds.initialize(model=model, config=dict(dscfg), device=d)
        metrics = [eng.train_batch(b) for b in batches]
        runs[d] = (metrics, dict(_flatten(params_to_numpy(model))))
        print(f"  {d}: loss {[round(m.loss, 5) for m in metrics]}, grad norm "
              f"{[round(m.grad_norm, 5) for m in metrics]}", flush=True)
    worst = 0.0
    for a, b in zip(runs["cpu"][0], runs[dev][0]):
        worst = max(worst, abs(a.loss - b.loss),
                    abs(a.grad_norm - b.grad_norm))
    pw = max(float(np.abs(runs["cpu"][1][n] - runs[dev][1][n]).max())
             for n in runs["cpu"][1])
    print(f"  worst |cpu - cuda|: loss / grad norm {worst:.3e}, parameters "
          f"{pw:.3e} (limit 1e-4)", flush=True)
    if not (worst <= 1e-4 and pw <= 1e-4):
        fail("small-config training parity: cuda differs from cpu")


# --------------------------------------------------------------- phase 8

class _record_flash:
    """While installed and armed, keeps the q, k, v (by reference) of the
    first flash call on the main path and the cotangent its output gets in
    backward, so that the kernels can be held to their plain versions on
    the path's own inputs.  The kernels and their counts are untouched."""

    def __init__(self):
        from deepspeed_tpu_torch.ops import registry
        self.spec = registry._REGISTRY["causal_attention"]
        self.kernel = self.spec.kernel
        self.armed = False
        self.call = None
        self.spec.kernel = self._call

    def _call(self, q, k, v, **kw):
        out = self.kernel(q, k, v, **kw)
        if self.armed and self.call is None and out.requires_grad:
            self.call = [q.detach(), k.detach(), v.detach(), None,
                         {a: kw[a] for a in ("causal", "scale", "window",
                                             "alibi_slopes")}]
            out.register_hook(self._keep_cotangent)
        return out

    def _keep_cotangent(self, grad):
        self.call[3] = grad.detach()

    def restore(self):
        self.spec.kernel = self.kernel


def phase_train_main(torch, fa, dev, card, profile=False):
    """initialize -> train_batch at full GPT-2-small width."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPTChunkedLoss, GPTConfig
    from deepspeed_tpu_torch.models.gpt import count_params
    cfg = GPTConfig.gpt2_small(vocab_size=50304, max_seq_len=1024,
                               dropout=0.0, loss_chunk=8192,
                               dtype=torch.bfloat16)
    ds_config = {"train_micro_batch_size_per_gpu": 16,
                 "gradient_accumulation_steps": 2,
                 "optimizer": {"type": "adamw",
                               "params": {"lr": 1e-4, "weight_decay": 0.01}},
                 "bf16": {"enabled": True},
                 "zero_optimization": {"stage": 2},
                 "gradient_clipping": 1.0, "steps_per_print": 0}
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (32, 1024)).astype(np.int32)
    data = [{"input_ids": row} for row in ids]
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GPTChunkedLoss(cfg, device=dev, generator=gen)
    engine, _, loader, _ = ds.initialize(model=model, config=ds_config,
                                         training_data=data)
    if engine.device.type != "cuda":
        fail(f"initialize() put the engine on {engine.device}")
    batch = next(iter(ds.RepeatingLoader(loader)))   # the one fixed batch
    tokens = int(np.prod(batch["input_ids"].shape))
    print(f"  GPT-2 small, {count_params(cfg) / 1e6:.1f}M params, bf16 with "
          f"fp32 masters, {batch['input_ids'].shape} tokens a step (gas x "
          f"micro x T)", flush=True)
    rec = _record_flash()
    counters = (fa.cuda_flash_fwd, fa.cuda_flash_dq, fa.cuda_flash_dkv)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    metrics, times, sync_sites, per_step = [], [], [], None
    for step in range(10):
        before = [c.launches for c in counters]
        if step == 1:
            # the second warm-up step also keeps the first layer's flash
            # inputs and counts the host syncs
            rec.armed = True
            with warnings.catch_warnings(record=True) as syncs:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                m = engine.train_batch(batch)
                torch.cuda.set_sync_debug_mode("default")
            rec.armed = False
            sync_sites = [f"{os.path.basename(w.filename)}:{w.lineno}"
                          for w in syncs if "synchroniz" in str(w.message)]
        else:
            t0 = time.perf_counter()
            m = engine.train_batch(batch)
            torch.cuda.synchronize()
            if step >= 2:
                times.append(time.perf_counter() - t0)
        metrics.append(m)
        per_step = [c.launches - b for c, b in zip(counters, before)]
        if per_step != [24, 24, 24]:
            fail(f"step {step}: flash launches {per_step}, expected 24 of "
                 f"each (12 layers x gas 2)")
    ev = float(engine.eval_batch({"input_ids": ids[:16]}))
    torch.cuda.synchronize()
    launches = dict(zip(FLASH, (c.launches for c in counters)))
    rec.restore()
    peak = torch.cuda.max_memory_allocated()
    losses = [m.loss for m in metrics]
    print(f"  loss {[round(x, 4) for x in losses]}; grad norm "
          f"{[round(m.grad_norm, 3) for m in metrics]}; eval loss {ev:.4f}",
          flush=True)
    if not all(np.isfinite(losses)) or not np.isfinite(ev):
        fail("a loss is not finite")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    if engine.skipped_steps != 0 or engine.step_clock != 10:
        fail(f"skipped steps {engine.skipped_steps}, clock "
             f"{engine.step_clock}")
    med = statistics.median(times)
    e2e = dict(step_ms_median=med * 1e3, step_ms_min=min(times) * 1e3,
               step_ms_max=max(times) * 1e3, tokens_per_step=tokens,
               tokens_per_s=tokens / med, peak_memory_gb=peak / 1e9,
               flash_launches_per_step=per_step,
               host_syncs_per_step=len(sync_sites),
               loss_first=losses[0], loss_last=losses[-1], eval_loss=ev)
    print(f"  train_batch: median {med * 1e3:.1f} ms (min "
          f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}) over 8 "
          f"steps = {tokens / med:.0f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB; flash launches a step {per_step}; host "
          f"syncs inside a step: {len(sync_sites)} "
          f"{sorted(set(sync_sites))}; card {card}", flush=True)
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                engine.train_batch(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report_profile(torch, prof, wall, reps=2, unprofiled=med)
    # the kernels on the path's own inputs (layer 0, first micro-batch)
    q, k, v, do, kw = rec.call
    if do is None:
        fail("the first flash call's cotangent was not seen")
    _check_flash(torch, fa, "main path's own inputs", q, k, v, do, kw)
    results = _time_flash(torch, fa, q, k, v, do, kw)
    return launches, results, e2e


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,6,7,8",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="trace phases 4 and 8 with torch.profiler and print "
                         "the device time by kernel")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "deepspeed_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(deepspeed_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    import importlib
    from deepspeed_tpu_torch.ops import builder
    # the module (ops/__init__ re-exports a function of the same name)
    pa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    dev = "cuda:0"

    print("== phase 1: card, versions, kernel build", flush=True)
    card = card_line()
    print(f"  card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    builder.build(["paged_attention", "ragged_prefill", "flash_attention"])
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in builder.build_log.items():
        regs = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = [int(line.split("bytes spill stores")[0].split(",")[-1])
                  for line in log.splitlines() if "spill stores" in line]
        print(f"  [{name}] ptxas: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, spill "
              f"stores up to {max(spills, default=0)} bytes", flush=True)

    results = {}
    if 2 in phases:
        print("== phase 2: kernels vs plain versions, Llama-3-8B attention "
              "shapes, every variant", flush=True)
        results = phase_kernels(torch, pa, dev)
        torch.cuda.empty_cache()
    if 3 in phases:
        print("== phase 3: small-config parity, cuda vs cpu (fp32, TF32 off)",
              flush=True)
        phase_parity(torch, dev)
    launches = {"paged_attention": None, "ragged_prefill": None}
    if 4 in phases:
        print("== phase 4: main path, InferenceEngineV2.generate at "
              "Llama-3-8B width", flush=True)
        launches, calls, eng, e2e = phase_main(torch, pa, dev, card,
                                               args.profile)
        print("E2E " + json.dumps(e2e), flush=True)
        print("== phase 5: kernels vs plain versions on the main path's own "
              "inputs", flush=True)
        results = phase_main_inputs(torch, pa, calls, eng)
        del calls, eng
        gc.collect()
        torch.cuda.empty_cache()
    if 6 in phases:
        print("== phase 6: flash kernels vs plain versions (bf16), every "
              "variant", flush=True)
        results.update(phase_flash(torch, fa, dev))
        torch.cuda.empty_cache()
    if 7 in phases:
        print("== phase 7: small-config training parity, cuda vs cpu (fp32, "
              "TF32 off)", flush=True)
        phase_train_parity(torch, dev)
    launches.update(dict.fromkeys(FLASH))
    if 8 in phases:
        print("== phase 8: training main path, initialize -> train_batch at "
              "GPT-2-small width", flush=True)
        flash_launches, flash_results, e2e = phase_train_main(
            torch, fa, dev, card, args.profile)
        launches.update(flash_launches)
        results.update(flash_results)
        print("E2E_TRAIN " + json.dumps(e2e), flush=True)

    replaces = {"paged_attention":
                "deepspeed_tpu/ops/paged_attention.py:152",
                "ragged_prefill": "deepspeed_tpu/ops/paged_attention.py:546",
                "flash_fwd": "deepspeed_tpu/ops/flash_attention.py:208",
                "flash_dq": "deepspeed_tpu/ops/flash_attention.py:305",
                "flash_dkv": "deepspeed_tpu/ops/flash_attention.py:347"}
    sources = dict.fromkeys(FLASH, "flash_attention")
    kernels = []
    for name in ("paged_attention", "ragged_prefill") + FLASH:
        r = results.get(name, {})
        print("KERNEL " + json.dumps({
            "kernel": name, "shape": r.get("shape"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "library_ms": r.get("library_ms"),
            "bound_ms": r.get("bound_ms"), "launches": launches[name]}),
            flush=True)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/csrc/{sources.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": ERRS[name] if r else None, "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms")})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
