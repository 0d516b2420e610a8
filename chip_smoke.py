#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 4,19,20,21   # the rest of serving

1. The card (name and power limit from nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel of the serving and training
   paths from the sources in this checkout (one nvcc per source, started
   together); ptxas's registers and spills of the 16-bit flash kernels, the
   16-bit decode, #6's kernel, the evoformer's 16-bit dk/dv and dbias2, the
   16-bit prefill (#2 / #2i) with its combine kernel, #9's tensor-core
   shrink and expand, the block-sparse forward (#10), dq (#11) with their
   merge and dk/dv (#12) with its merge and the evoformer's dq (#14) (a
   spill in any but the flash forward and dq fails), and the HGMMA /
   WARPGROUP.DEPBAR counts of the SASS of every wgmma kernel (the attention
   forward in both of its builds, the attention backward (flash dq, the
   dk/dv in both of its builds), the evoformer's dq and dbias2,
   wq_wgmma_kernel in each mode, #6's kernel, the prefill, #9's shrink and
   expand, the block-sparse forward, dq and dk/dv); a forward, attention
   backward, dbias2, #6, prefill, #9 or #10-#12 kernel with a wait after
   every product, or named in a ptxas warning that it serialised the
   products, fails.
2. Each kernel against its plain PyTorch version on the card at Llama-3-8B
   attention shapes (bf16, nkv=8, g=4, hd=128, 64-token pages, 16 slots,
   KV lengths 0..2048, shuffled block tables) in every variant: plain,
   sliding window, alibi, and the one-pass (one-page table) and split
   decode.  Each output row (one query head of one token) may differ from
   the plain version by ROW_TOL of its largest value; the check is shown
   to catch one lost page of the longest slot and one ring stage (page)
   of it skipped; two decode runs are bitwise equal.  For the prefill, two
   runs are bitwise equal and the check is shown to catch a skipped ring
   stage, a page left out of a unit's walk, the second consumer
   warpgroup's rows dropped and a chunk of a split walk left out of its
   merge (each fault's size printed).  The plain case is timed as in
   phase 5, the prefill also with a window of one key and with every row
   dead.
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
   time the card could take (``bound_ms``); the prefill call's slots, and
   its time with a window of one key and with every row dead.

6. The three flash-attention kernels (forward, dq, dk/dv) against their
   plain versions in bf16, per output row at ROW_TOL (lse: absolute), at
   the training main path's shape, Llama-3-8B attention, a window, alibi,
   alibi + window + GQA and a non-causal case, and at Phi-2's (32 x 80, T
   2048), Phi-3-mini's (32 x 96, T 4096) and Gemma-7B's (16 x 256, T 8192)
   attention widths in bf16 and in fp32 (F32_TOL, TF32 off); the delta
   the 16-bit dq makes is held to the eager fp32 sum (F32_TOL of the
   largest).  The check is shown to catch one dropped K tile, and the
   backward's one 128-key tile left out of dq's walk and one 128-query
   tile left out of dk/dv's; the backward run twice at the main call is
   bitwise equal.  Each kernel is timed beside its bound, its plain
   version and SDPA (forward; backward through autograd for dq + dk/dv),
   the wide head dims in bf16 too, and the whole backward (dq making
   delta, then dk/dv) beside SDPA's backward.
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
   and timed.  Then 6 ``train_batch`` steps at Phi-2's widths (hidden 2560,
   32 heads x 80, FFN 10240, vocabulary 51200, T 2048; depth cut from 32
   to 4 layers), each launching each flash kernel 4 x 2 times, the loss
   falling.  ``--phases 8 --profile`` prints device time by kernel.

9. Quantized kernels against their plain versions in bf16: ``wq_matmul``
   (#7) and ``wq_matmul4`` (#8, the wgmma kernel) at every Llama-3-8B and
   GPT-2 small product shape at M 1, 16, 17, 64, 256 and 300 and groups
   16, 128 and 512 where the group divides K, and on code rows that are
   not 16-byte aligned; ``wq_matmul_t`` (#6) at GPT-2's tied [50304, 768]
   table at the same M and groups 16 and 128; the MLP products and the
   tied table again at ``quant.group_size`` 256; each timed at M 16 and
   256 (the tied table at every M) beside its bound and one
   ``torch.matmul`` on the dequantized bf16 weight; the int8-KV decode
   and prefill variants at phase 2's shapes and variants.  The row check
   is shown to see one zeroed scale group, one dropped 64-deep K stage, a
   swizzle slip of the B tile, one tied-table scale row read from the
   neighbouring group, one page read with another page's scales and one
   skipped ring stage of the int8 decode; two int8 decode runs are
   bitwise equal; the int8 prefill's determinism and four fault checks as
   in phase 2.
10. Small-config quantized parity: W8 weights with int8 KV, and W4, in fp32
   with TF32 off — greedy ``generate`` on the card equals the CPU's.
11. The quantized main path at full width, each engine built from a bf16
   tree (Llama-3-8B's is phase 4's): Llama-3-8B W8 + int8 KV, Llama-3-8B
   W4, GPT-2 small W8 (tied, vocabulary padded to 50304), each serving 16
   seeded requests with its kernels' counters set to 0 just before; store
   and KV-pool bytes against bf16 (W8 <= 0.53x, W4 <= 0.30x, int8 pool
   <= 0.53x), tok/s, peak memory, host syncs; the W8 engine's put() logits
   through the kernels against the plain versions swapped into the
   registry; greedy agreement with phase 4 (printed, not gated); tok/s
   against phase 4's bf16 engine.  ``--profile`` traces the W8 run and
   sums the quantized products' device time.
12. (with 11) Each new kernel held to its plain version and timed on its
   heaviest main-path call: kernel, plain, ``torch.matmul`` with the bf16
   weight (#6-#8) or SDPA over dequantized K/V (int8 variants), and bound;
   the int8 decode also on its table padded to the engine's full width;
   the int8 prefill probed as in phase 5.

13. The batched-gather LoRA kernel (#9) against its plain version in bf16
   at Llama-3-8B's q (4096 -> 4096) and v (4096 -> 1024) projections, ranks
   8, 16 and 64, 9 slots, M 1, 16, 37, 256 and 1024, ids random, all
   identity and one tenant: per row at ROW_TOL, identity rows exactly 0;
   the check is shown to see one row read through its neighbour's slot, a
   slot's 65th row left out of its tile and one H chunk left out of the
   sum.  Timed at M 16 and 256 beside its bound (no single PyTorch call
   computes a per-row gathered two-stage product, so no library time), and
   the same pair as two plain launches (the main path's expand is a
   programmatic dependent launch of the shrink).
14. Small-config adapter parity, fp32 with TF32 off: 8 registered tenants
   served in one generate, the same with ``slots`` 3 (eviction churn), and
   quant 8 + int8 KV + adapters — greedy tokens on the card equal the
   CPU's.
15. The LoRA main path at full Llama-3-8B width on phase 4's bf16 tree:
   ``adapters`` rank 16, alpha 32, 9 slots, 8 tenants registered; phase
   4's 16 requests with ``adapter_ids[i] = i % 9``.  Every forward pass
   must launch the kernel 2 x 32 times; the pool must end unpinned and
   consistent; ``put()`` logits through an adapter and the kernel against
   the plain version swapped into the registry (E2E_TOL).  A short second
   run with 3 slots must evict.  The kernel is held to its plain version
   and timed on the main path's heaviest first-layer call and on its
   largest decode-step call (M <= 16); the run's decode-step calls are
   counted.

16. The block-sparse kernels (#10-#12: forward, dq, dk/dv) against their
   plain versions in bf16 (one fp16 case), per output row at ROW_TOL (lse
   absolute; the delta dq makes against the eager fp32 sum at F32_TOL of
   its largest): Dense, Fixed, BSLongformer and BigBird layouts, causal and
   not, GQA 1, 4, 8 and 16, blocks 16-128 (all three on the wgmma kernels;
   block 48 on the mma.sync ones), head_dim 64 and 128, T 1024-2048 and
   1040 (a pad segment); and the CUDA-core family at block 8 and 24,
   head_dim 80 and in fp32 (F32_TOL).  K/V blocks no table entry reads are
   poisoned with NaN (at block 16 and at block 8) and the outputs must
   stay equal to the plain ones on clean inputs; one dropped table entry
   must move a row beyond ROW_TOL.
17. The block-sparse path at full Llama-3-8B attention width and its
   published context (B 1, T 8192, 32 / 8 heads x 128, bf16):
   ``ops.sparse_attention`` and its autograd backward with the default
   Fixed pattern (causal), with BigBird block 64 (non-causal) and with
   BSLongformer's defaults (non-causal: global row block 0 reads every
   column).  Each kernel launches once a call (each merge of split walks
   once, where its plan splits one: the forward's at BSLongformer, dq's at
   BigBird and BSLongformer, dk/dv's at all three); o, dq,
   dk, dv held per row to the plain versions run one KV group at a time,
   the delta dq makes to the eager sum; o, lse, dq, delta, dk, dv of two
   runs bitwise equal; the kernels timed on both calls (the Fixed call's
   in the JSON line, a merge from the first call that runs it) beside their
   bound (live pairs only), the plain versions and SDPA with the expanded
   boolean mask, dq with the delta it makes, and the merges on seeded
   partials (the dk/dv and dq merges held bitwise to their plain
   versions).  The forward's and dq's checks are shown to see, in the
   plain version of one unit's task of their plans: a key block dropped
   from a stage, a dead sub-tile let through, a skipped ring stage, (dq)
   the neighbouring head's delta and, where a plan splits, a chunk left
   out of a split walk's merge; the
   dk/dv check, in the plain backward of one kv head: a column dropped
   from a group, a dead sub-tile let through, a chunk left out of a split
   walk's merge and a skipped ring stage (each fault's size printed).
18. The evoformer kernels, forward (#13) and backward (#14 dq, #15 dk/dv,
   #16 dbias2 with its second pass, #17 dbias1), against their plain
   versions at small shapes (biases none / one / both, an fp32 bias2, a
   bias2 [1, 1, H, 1, S] shared by every query, D 8-128, S 13 / 64 / 383, fully masked rows;
   D 160 and 256 and fp32 on the CUDA-core variants; the backward kernels
   fed the plain o and lse), then AlphaFold2's MSA row
   attention with pair bias (N_clust 512, N_res 384, 8 heads x 32),
   triangle attention (384 x 384, 4 heads x 32) and the MSA call at S 383
   (padded) through ``ops.evoformer_attention`` and ``loss.backward()``
   with q, k, v and both biases requiring grad: one launch of each kernel a
   call; o held per row to the plain forward, every gradient to the plain
   backward on the o and lse the kernels were given (run over chunks of
   the MSA rows), mapped to the inputs through the padding and the biases'
   broadcast.  The MSA call timed beside its bound, the plain versions and
   SDPA with the additive mask (requiring grad in the backward); the
   triangle call's kernels timed too, dbias2 with its second pass and the
   second pass alone (held bitwise to its plain version, beside
   ``part.sum(0)``), dq with the delta it makes (and the eager delta it
   replaced, off the path), and the op's whole backward through autograd.
   A bias2 read through the neighbouring head must show
   in the forward and in every backward kernel, and a dbias2 summed over
   N - 1 rows must show; so must, in the plain backward on the kernels' o
   and lse, a query tile dropped from #15's walk, one chunk left out of
   #16's second pass and one skipped ring stage of each, and in the plain
   dq a key tile out of #14's walk, a skipped #14 stage and the
   neighbouring head's delta rows (each fault's size printed); the delta
   #14 makes is held to the eager fp32 sum.  Two backward runs at the MSA
   call are bitwise equal.

19. Speculative decoding at full width: Llama-3-8B in bf16 (phase 4's
   tree) with a draft of Llama-3.2-1B's widths (seeded random weights),
   gamma 4, 8 outer steps, on phase 4's 16 requests; then a self-draft
   pass (the target's own tensors as the draft).  tok/s against phase 4's,
   ``spec_summary()``, dispatches, host syncs and peak memory on an
   ``E2E_SPEC`` line.  The verify call's #2 (5 rows a slot, 20 live rows
   of a 128-row unit), the draft's #1 (head dim 64, g 4) and the draft's
   prefill #2 at head dim 64 are held per row to their plain versions and
   timed beside their bounds and SDPA with the mask (``KERNEL_SHAPE``
   lines); keys past kv_len (a round's rejected tail) and unread pages
   poisoned must not move #2's or #1's output, and one poisoned key read
   must.
20. The radix prefix cache and SLA scheduling at full Llama-3-8B width:
   16 requests sharing a 512-token system prefix (then 64..512 tokens of
   their own, 64..128 new), ``generate`` twice on one engine with
   ``prefix_cache`` on (the second call must alias at least 16 x 512
   prompt tokens); #2 held and timed on a prefill call past the cached
   pages; then the same traffic on 4 slots with staggered arrivals,
   without and with two SLA classes (``gold``: priority 1, TTFT SLO 200
   ms), which must preempt for gold at least once; ``E2E_PREFIX_SLA``.
21. Small-config parity in fp32 with TF32 off (phase 3's model): greedy
   speculative tokens (a random one-layer draft, then a self-draft) equal
   plain greedy on the card and the CPU's, with the CPU's counters;
   prefix cache on equals off and the CPU's; SLA preemption under one
   fixed clock takes the CPU's decisions and gives the uncontended tokens;
   int8 KV with a draft runs #1i / #2i; the fp32 and int8 verify and
   draft-decode calls held to their plain versions (F32_TOL) with the
   poisoned-tail check.

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
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
ROW_TOL = 2e-2                  # of each output row's largest value
F32_TOL = 1e-4                  # the same, fp32 kernels (TF32 off)
E2E_TOL = 1e-1                  # of the largest logit, kernels vs plain path


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
WQ = ("wq_matmul_t", "wq_matmul", "wq_matmul4")
INT8 = ("paged_attention_int8", "ragged_prefill_int8")
LORA = ("lora_matmul",)
SPARSE = ("sparse_fwd", "sparse_dq", "sparse_dkv", "sparse_dkv_merge",
          "sparse_fwd_combine", "sparse_dq_merge")
EVO_BWD = ("evoformer_dq", "evoformer_dkv", "evoformer_db2",
           "evoformer_db2_sum", "evoformer_db1")
EVO = ("evoformer_fwd",) + EVO_BWD
ERRS = dict.fromkeys(("paged_attention", "ragged_prefill") + FLASH + WQ
                     + INT8 + LORA + SPARSE + EVO, 0.0)
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


def _int8(kw):
    return kw.get("k_scale") is not None


def _token_bytes(k, kw):
    """Bytes of one key (or value) row of a page: hd elements, plus its fp32
    scale for int8 pages."""
    return k.shape[3] * k.element_size() + (4 if _int8(kw) else 0)


def _dequant_pages(torch, k, v, kw, dtype):
    """16-bit pages for the library (SDPA) timing: int8 pages dequantized
    as the kernels do, others as they are."""
    if not _int8(kw):
        return k, v
    return ((k.float() * kw["k_scale"][..., None]).to(dtype),
            (v.float() * kw["v_scale"][..., None]).to(dtype))


def _time_decode(torch, pa, q, k, v, bt, lens, kw):
    """Kernel, plain and SDPA device times of one decode call, and its
    bound: each live key's K and V read once (int8 pages: codes and
    scales), q read and the output written once, plus the live table
    entries (no window: every key is live)."""
    assert kw.get("window") is None
    S, nkv, g, hd = q.shape
    bs, nh, esize = k.shape[2], nkv * g, q.element_size()
    lens_np = lens.cpu().numpy().astype(np.int64)
    live = int(lens_np.sum())
    nbytes = (live * nkv * 2 * _token_bytes(k, kw) + 2 * q.numel() * esize
              + int((-(-lens_np // bs)).sum()) * 4 + S * 4)
    bound_ms, bound_by = _bound(nbytes, 4 * hd * nh * live)
    kd, vd = _dense_kv(torch, *_dequant_pages(torch, k, v, kw, q.dtype), bt)
    K = kd.shape[2]
    mask = (torch.arange(K, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    ms = cuda_ms(lambda: pa.cuda_paged_attention(q, k, v, bt, lens, **kw))
    plan = pa.decode_plan(S, nkv, g, hd, bs, k.element_size(),
                          torch.cuda.get_device_properties(
                              q.device).multi_processor_count)
    return dict(
        shape=f"q[{S},{nkv},{g},{hd}] table[{S},{bt.shape[1]}] "
              f"({plan['blocks']} blocks, {plan['stages']} stages, chunks "
              f"of {plan['chunk']}+ pages) pages[{k.shape[0]},{nkv},{bs},{hd}] "
              f"{k.dtype} "
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
              + int(keys.sum()) * nkv * 2 * _token_bytes(k, kw)
              + int((-(-keys // bs)).sum()) * 4 + 3 * S * 4)
    bound_ms, bound_by = _bound(nbytes, 4 * hd * nh * visible)
    kd, vd = _dense_kv(torch, *_dequant_pages(torch, k, v, kw, q.dtype), bt)
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


def _prefill_probe(torch, pa, args, kw, label):
    """Where a prefill call's time goes: the call timed again with a window
    of one key (every walk one stage: the schedule, Q, stores and dead
    rows) and with every row dead (the schedule and the dead rows alone).
    (No profiler here: these phases run before the serving phases, whose
    tok/s a profiled session in the same process could perturb.)"""
    q, k, v, bt, kvl, starts, counts = args
    dead = torch.zeros_like(counts)
    one = dict(kw, window=1)
    print(f"  {label}: window 1: "
          f"{cuda_ms(lambda: pa.cuda_ragged_prefill(*args, **one)):.4f} ms; "
          f"every row dead: "
          f"{cuda_ms(lambda: pa.cuda_ragged_prefill(q, k, v, bt, kvl, starts, dead, **kw)):.4f} ms",
          flush=True)


def _decode_faults(torch, pa, q, k, v, bt, lens, kw):
    """Two runs of the decode give the same bits (the slots split over
    blocks merge in block order), and the row check must see one ring
    stage (one whole page) of the longest slot skipped: the plain version
    with that page taken out of the slot's table and length."""
    runs = [pa.cuda_paged_attention(q, k, v, bt, lens, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(runs[0], runs[1])
    print(f"  two decode runs bitwise equal: {same}", flush=True)
    if not same:
        fail("the decode is not deterministic")
    s = int(lens.argmax())
    bs, pages = k.shape[2], -(-int(lens[s]) // k.shape[2])
    skip = bt.clone()
    row = [p for i, p in enumerate(bt[s].tolist()) if i != pages // 2]
    skip[s] = torch.tensor(row + row[-1:], dtype=bt.dtype)
    short = lens.clone()
    short[s] -= bs
    r = _row_err(torch, pa.torch_paged_attention(q, k, v, skip, short, **kw),
                 pa.torch_paged_attention(q, k, v, bt, lens, **kw))
    print(f"  one ring stage (page {pages // 2} of a {int(lens[s])}-token "
          f"slot) skipped moves its worst row by {r:.3e} of its max (check "
          f"at {ROW_TOL})", flush=True)
    if not r > ROW_TOL:
        fail("the decode check cannot see a skipped ring stage")


def _decode_full_width(torch, pa, name, q, k, v, bt, lens, kw, width):
    """The decode held and timed with its table padded to ``width``
    columns (the engine's max_blocks_per_seq), the width it had before the
    engine cut tables to their live blocks."""
    full = torch.zeros((bt.shape[0], width), dtype=bt.dtype, device=bt.device)
    full[:, :bt.shape[1]] = bt
    _check(torch, name, "main path, full-width table",
           pa.cuda_paged_attention(q, k, v, full, lens, **kw),
           pa.torch_paged_attention(q, k, v, full, lens, **kw))
    return _time_decode(torch, pa, q, k, v, full, lens, kw)


def _drop_pages(bt, s, p0, p1):
    """Slot s's block table with its logical pages [p0, p1) taken out (the
    later pages move down, the last repeats at the tail)."""
    out = bt.clone()
    row = [p for i, p in enumerate(bt[s].tolist()) if not p0 <= i < p1]
    out[s] = bt.new_tensor(row + row[-1:] * (p1 - p0))
    return out


def _prefill_faults(torch, pa, q, k, v, bt, kvl, starts, counts, kw, label):
    """Two runs of the prefill give the same bits, and the row check must
    see, in the plain version: one ring stage (64 keys) skipped in a walk,
    a page left out of a unit's walk, the second consumer warpgroup's rows
    (rows 64-127 of every 128-row unit) dropped, and one chunk of a split
    walk (256 keys, the fewest a chunk holds) left out of its merge.  Keys
    are taken out of the slot with the longest history before its rows
    (all its rows sit past them), its later keys and rows moved down; each
    fault's size is printed."""
    runs = [pa.cuda_ragged_prefill(q, k, v, bt, kvl, starts, counts, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(runs[0], runs[1])
    print(f"  two {label} runs bitwise equal: {same}", flush=True)
    if not same:
        fail(f"{label} is not deterministic")
    want = pa.torch_ragged_prefill(q, k, v, bt, kvl, starts, counts, **kw)
    g, bs = q.shape[3], k.shape[2]
    st, cn = starts.cpu().numpy(), counts.cpu().numpy()
    s = int(np.argmax(np.where(cn > 0, st, -1)))

    def check(what, got, rows):
        r = _row_err(torch, got[rows], want[rows])
        print(f"  {label}: {what} moves the worst row by {r:.3e} of its max "
              f"(check at {ROW_TOL})", flush=True)
        if not r > ROW_TOL:
            fail(f"the {label} check cannot see {what}")

    def without(p0, p1):
        lens2, starts2 = kvl.clone(), starts.clone()
        lens2[s] -= (p1 - p0) * bs
        starts2[s] -= (p1 - p0) * bs
        if (p1 + 1) * bs > int(st[s]):
            fail(f"{label}: slot {s} has too little history for the fault "
                 f"checks")
        return pa.torch_ragged_prefill(q, k, v, _drop_pages(bt, s, p0, p1),
                                       lens2, starts2, counts, **kw)

    stage = max(1, 64 // bs)
    check(f"a skipped ring stage (pages 1..{stage} of slot {s}, "
          f"{int(kvl[s])} keys)", without(1, 1 + stage), (s,))
    short = kvl.clone()
    short[s] -= bs
    check(f"a page left out of a unit's walk (the last page of slot {s})",
          pa.torch_ragged_prefill(q, k, v, bt, short, starts, counts, **kw),
          (s,))
    dropped = want.clone()
    unit = 128 // g
    for t0 in range(0, q.shape[1], unit):
        dropped[:, t0 + 64 // g:t0 + unit] = 0
    check("the second consumer warpgroup's rows dropped", dropped,
          (slice(None),))
    n = max(1, 256 // bs)
    check(f"one chunk of a split walk ({n * bs} keys of slot {s}) left out "
          f"of the merge", without(1, 1 + n), (s,))


def _print_times(results, library="SDPA"):
    for name, r in results.items():
        print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, {library} {r['library_ms']:.4f} ms, "
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
    _decode_faults(torch, pa, q, k, v, bt, lens, {})
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
    _prefill_faults(torch, pa, qp, k, v, bt, lens2, q_starts, q_counts, {},
                    "ragged_prefill")
    _prefill_probe(torch, pa, (qp, k, v, bt, lens2, q_starts, q_counts), {},
                   "ragged_prefill mixed step")
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
    wq = [e for e in rows if "wq_" in e.key]
    if wq:
        print(f"  quantized products (wq_* kernels, split-K sums included): "
              f"{sum(e.self_device_time_total for e in wq) / 1e3:.1f} ms "
              f"device time", flush=True)


def phase_main(torch, pa, dev, card, profile=False):
    """InferenceEngineV2.generate at full Llama-3-8B width; returns the
    bf16 tree (the engine's own, aliased) and the outputs for phase 11."""
    from deepspeed_tpu_torch import InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import count_params, init_params
    cfg = _llama_cfg(torch)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  Llama-3-8B width, {count_params(cfg) / 1e9:.3f}B params, "
          f"bf16 weights on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    eng = InferenceEngineV2(cfg, config={"dtype": "bfloat16",
                                         "state_manager": LLAMA_SM},
                            params=params, device=dev)
    prompts, news = _requests(cfg.vocab_size, 1025)
    calls = _record_calls(eng, {"paged_attention": "paged_attention",
                                "ragged_prefill_attention": "ragged_prefill"})
    outs, e2e = _serve(torch, "Llama-3-8B bf16", eng, prompts, news,
                       ("paged_attention", "ragged_prefill"), card, profile)
    calls.restore()
    # the served model's logits are finite at full width
    logits = eng.put([10 ** 6], [prompts[0][:32]])
    if logits.shape != (1, cfg.vocab_size) or not np.isfinite(logits).all():
        fail(f"put() logits {logits.shape} not finite/of the vocab width")
    return calls, eng, e2e, params, outs


# 16 slots, 64-token pages, a pool of 2048 tokens a slot
LLAMA_SM = {"max_tracked_sequences": 16, "kv_block_size": 64,
            "num_kv_blocks": 16 * 2048 // 64}


def _requests(vocab, max_prompt):
    """16 seeded requests: prompts of 64..max_prompt-1 tokens, 64..128 new
    tokens each (numpy seed 0)."""
    rng = np.random.default_rng(0)
    plens = rng.integers(64, max_prompt, 16)
    news = rng.integers(64, 129, 16)
    return ([rng.integers(0, vocab, int(n)).astype(np.int32) for n in plens],
            news)


def _counters():
    """Every kernel's launch counter: (wrapper, attribute) by kernel name."""
    import importlib
    pa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
    wqm = importlib.import_module("deepspeed_tpu_torch.ops.wq_matmul")
    lm = importlib.import_module("deepspeed_tpu_torch.ops.lora_matmul")
    return {"paged_attention": (pa.cuda_paged_attention, "launches"),
            "ragged_prefill": (pa.cuda_ragged_prefill, "launches"),
            "paged_attention_int8": (pa.cuda_paged_attention,
                                     "int8_launches"),
            "ragged_prefill_int8": (pa.cuda_ragged_prefill, "int8_launches"),
            "wq_matmul": (wqm.cuda_wq_matmul, "launches"),
            "wq_matmul_t": (wqm.cuda_wq_matmul_t, "launches"),
            "wq_matmul4": (wqm.cuda_wq_matmul4, "launches"),
            "lora_matmul": (lm.cuda_lora_matmul, "launches")}


def _serve(torch, label, eng, prompts, news, kernels, card, profile=False,
           **gen):
    """One main-path run: ``eng.generate`` on the requests (``gen``: more
    of its keywords, e.g. ``adapter_ids``, ``sla``, ``arrival_times``) with
    every launch counter set to 0 just before and read just after; fails if
    a kernel of ``kernels`` never launched or an output is malformed.
    Returns the outputs and the run's numbers (``--profile``: also the
    device time by kernel)."""
    counters = _counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
                                max_new_tokens=[int(n) for n in news], **gen)
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}
    if prof is not None:
        _report_profile(torch, prof, wall)
    sync_sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs
                  if "synchroniz" in str(w.message)]
    for name in kernels:
        if launches[name] <= 0:
            fail(f"{label}: the main path never launched the {name} kernel")
    vocab = eng.model_config.vocab_size
    for i, (o, n) in enumerate(zip(outs, news)):
        if len(o) != int(n) or o.min() < 0 or o.max() >= vocab:
            fail(f"{label}: request {i} gave {len(o)} tokens (expected "
                 f"{int(n)}) or a token outside the vocab")
    n_new = int(sum(len(o) for o in outs))
    n_prompt = int(sum(len(p) for p in prompts))
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label}: served {len(prompts)} requests, {n_prompt} prompt + "
          f"{n_new} generated tokens in {wall:.2f} s = {n_new / wall:.1f} "
          f"generated tok/s ({(n_prompt + n_new) / wall:.1f} tok/s with the "
          f"prompts); dispatches {eng.dispatches}; preemptions "
          f"{eng.preempt_stats}; peak memory {peak / 1e9:.2f} GB; KV pool "
          f"{eng.cache.nbytes / 1e9:.3f} GB; card {card}", flush=True)
    print(f"  kernel launches on the main path: {launches}; host syncs "
          f"inside generate: {len(sync_sites)} {sorted(set(sync_sites))}",
          flush=True)
    return outs, dict(
        run=label, wall_s=wall, generated_tokens=n_new,
        prompt_tokens=n_prompt, generated_tok_per_s=n_new / wall,
        peak_memory_gb=peak / 1e9, host_syncs=len(sync_sites),
        dispatches=dict(eng.dispatches), kv_pool_gb=eng.cache.nbytes / 1e9,
        launches=launches)


class _record_calls(dict):
    """While installed, keeps the inputs of every main-path call of the
    given registry ops that touches the first layer — its KV pool, its
    weight stores or its adapter pages — and every tied-unembed call, by
    reference (no copy, no
    sync), so that the kernels can be held to their plain versions and
    timed at the shapes the main path gave them.  The kernels and their
    launch counts are untouched.  ``swap_plain`` puts the plain versions in
    those ops' kernel slots until ``restore``."""

    def __init__(self, eng, ops):
        super().__init__({name: [] for name in ops.values()})
        from deepspeed_tpu_torch.ops import registry
        from deepspeed_tpu_torch.ops.quantization import quantized_codes
        self._specs = {op: registry._REGISTRY[op] for op in ops}
        self._kernels = {op: spec.kernel for op, spec in self._specs.items()}
        ptrs = {eng.cache.layer(0)[0].data_ptr()}
        if getattr(eng, "draft_cache", None) is not None:
            # a draft's first layer too: its decodes and prefill chunks
            ptrs.add(eng.draft_cache.layer(0)[0].data_ptr())

        def walk(t):
            for leaf in t.values():
                codes = quantized_codes(leaf)
                if codes is not None:
                    ptrs.add(codes.data_ptr())
                elif isinstance(leaf, dict):
                    walk(leaf)
        walk(eng.params["backbone"]["block_0"])
        if getattr(eng, "adapters", None) is not None:
            # layer 0's [slots, H, r] views start at the tables' bases
            ptrs |= {eng.adapters.tables()[k].data_ptr()
                     for k in ("a_q", "a_v")}
        for op, spec in self._specs.items():
            spec.kernel = self._recorder(op, ops[op], spec.kernel, ptrs)

    def _recorder(self, op, name, kernel, ptrs):
        def call(*args, **kw):
            weight = (next(iter(args[1].values())) if op.startswith("wq")
                      else args[1])
            if op == "wq_matmul_t" or weight.data_ptr() in ptrs:
                self[name].append((args, kw))
            return kernel(*args, **kw)
        return call

    def swap_plain(self):
        for spec in self._specs.values():
            spec.kernel = spec.torch

    def restore(self):
        for op, spec in self._specs.items():
            spec.kernel = self._kernels[op]

    def pick(self, name):
        """The call with the most work (the last of equals): M·K·N for the
        products, M·O for LoRA, live keys for decode, live rows for
        prefill."""
        def work(args):
            if name == "lora_matmul":
                return args[0].shape[0] * args[2].shape[2]
            if name.startswith("wq"):
                return args[0].shape[0] * next(iter(args[1].values())).numel()
            return int((args[6] if name.startswith("ragged") else args[4])
                       .sum())
        return max(reversed(self[name]), key=lambda c: work(c[0]))


# --------------------------------------------------------------- phase 5

def phase_main_inputs(torch, pa, calls, eng):
    """Each kernel held to its plain version, and timed, on the inputs of
    its heaviest first-layer call on the main path (the KV pool as generate
    left it).  The decode call is also timed with its table padded to the
    engine's max_blocks_per_seq columns, the width it had before the engine
    cut tables to their live blocks."""
    results = {}
    (q, k, v, bt, lens), kw = calls.pick("paged_attention")
    _check(torch, "paged_attention", "main path",
           pa.cuda_paged_attention(q, k, v, bt, lens, **kw),
           pa.torch_paged_attention(q, k, v, bt, lens, **kw))
    results["paged_attention"] = _time_decode(torch, pa, q, k, v, bt, lens,
                                              kw)
    wide = _decode_full_width(torch, pa, "paged_attention", q, k, v, bt,
                              lens, kw, eng.state.max_blocks_per_seq)
    args, kw = calls.pick("ragged_prefill")
    _check(torch, "ragged_prefill", "main path",
           pa.cuda_ragged_prefill(*args, **kw),
           pa.torch_ragged_prefill(*args, **kw))
    results["ragged_prefill"] = _time_prefill(torch, pa, *args, kw)
    counts = args[6].cpu().numpy()
    print(f"  main-path prefill call: live rows by slot {counts.tolist()}, "
          f"q_starts {args[5].cpu().numpy().tolist()}, kv_lens "
          f"{args[4].cpu().numpy().tolist()}", flush=True)
    _prefill_probe(torch, pa, args, kw, "ragged_prefill main path")
    _print_times(dict(results, paged_attention_full_width=wide))
    return results


# --------------------------------------------------------------- phase 6

def _rows_off(got, want, floor_frac=1e-2):
    """(worst row's max |got - want| over that row's max |want|, floored at
    ``floor_frac`` of the tensor's largest; the largest difference)."""
    wf = want.float()
    d = (got.float() - wf).abs().amax(-1)
    floor = floor_frac * wf.abs().max().item()
    return (d / wf.abs().amax(-1).clamp_min(floor)).max().item(), \
        d.max().item()


def _check_rows(torch, name, label, got, want, tol=ROW_TOL):
    """As ``_check``, but a row whose true value is ~0 (the first query's
    dq: it sees one key, so dp - delta cancels) is judged against 1% of the
    tensor's largest value instead of its own."""
    torch.cuda.synchronize()
    # fp32 kernels: a row that cancels to 0 (a first query that sees one
    # key: dp - delta = 0) keeps each side's summation noise, ~1e-6 of the
    # tensor's largest, so it is judged against 10% of the largest
    row, err = _rows_off(got, want, 1e-1 if tol <= F32_TOL else 1e-2)
    print(f"  {name}[{label}] max|kernel-plain| = {err:.3e}, worst row "
          f"{row:.3e} of its max", flush=True)
    if not (row <= tol) or not torch.isfinite(got).all():
        fail(f"{name} {label}: row error {row} > {tol}")
    ERRS[name] = max(ERRS[name], err)
    return row


def _flash_inputs(torch, dev, B, T, N, Nkv, D, seed=0, dtype=None):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(
            dtype or torch.bfloat16)
    return (rand(B, T, N, D), rand(B, T, Nkv, D), rand(B, T, Nkv, D),
            rand(B, T, N, D))


def _check_flash(torch, fa, label, q, k, v, do, kw):
    """o, lse, dq, dk, dv of the three kernels against the plain versions
    (the backward kernels get the plain o and lse, so each is judged on its
    own); fp32 at F32_TOL, 16-bit at ROW_TOL."""
    tol = F32_TOL if q.dtype == torch.float32 else ROW_TOL
    o, lse = fa.cuda_flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.torch_flash_fwd(q, k, v, **kw)
    _check_rows(torch, "flash_fwd", label + " o", o, o_ref, tol)
    lerr = (lse - lse_ref).abs().max().item()
    print(f"  flash_fwd[{label} lse] max|kernel-plain| = {lerr:.3e}",
          flush=True)
    if not lerr <= tol:
        fail(f"flash_fwd {label}: lse differs by {lerr}")
    # the 16-bit dq makes delta = rowsum(o * do) (its producer warps); it is
    # held to the eager fp32 sum
    B, T, N, _ = q.shape
    delta = torch.full((B, N, T), float("nan"), device=q.device)
    dq = fa.cuda_flash_dq(q, k, v, o_ref, lse_ref, do, delta_out=delta, **kw)
    dk, dv = fa.cuda_flash_dkv(q, k, v, o_ref, lse_ref, do, **kw)
    dq_ref, dk_ref, dv_ref = fa.torch_flash_bwd(q, k, v, o_ref, lse_ref, do,
                                                **kw)
    d_ref = fa._delta(o_ref, do)
    derr = ((delta - d_ref).abs().max() / d_ref.abs().max()).item()
    print(f"  flash_dq[{label} delta] max|kernel-plain| = {derr:.3e} of the "
          f"largest", flush=True)
    if not derr <= F32_TOL:
        fail(f"flash_dq {label}: delta differs by {derr} of the largest")
    _check_rows(torch, "flash_dq", label + " dq", dq, dq_ref, tol)
    _check_rows(torch, "flash_dkv", label + " dk", dk, dk_ref, tol)
    _check_rows(torch, "flash_dkv", label + " dv", dv, dv_ref, tol)
    return o_ref, lse_ref


def _live_pairs(T, causal, window):
    """Visible (query, key) pairs of one head."""
    if not causal:
        return T * T
    qpos = np.arange(T, dtype=np.int64)
    return int(np.minimum(qpos + 1, window if window else T).sum())


def _time_flash(torch, fa, q, k, v, do, kw, library=True):
    """Device times of the three kernels, of the whole backward (dq making
    delta, then dk/dv), of the plain forward and backward and of SDPA
    forward / backward on the same inputs, beside each kernel's bound.  Operations: 2*D flops per visible (query, key) pair and product
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
    o = o.contiguous()

    def backward():
        # as the autograd Function runs it: dq makes delta, dk/dv reads it
        d = torch.empty((B, N, T), dtype=torch.float32, device=q.device)
        fa.cuda_flash_dq(q, k, v, o, lse, do, delta_out=d, **kw)
        fa.cuda_flash_dkv(q, k, v, o, lse, do, delta=d, **kw)
    ms = {
        "flash_fwd": cuda_ms(lambda: fa.cuda_flash_fwd(q, k, v, **kw)),
        "flash_dq": cuda_ms(lambda: fa.cuda_flash_dq(
            q, k, v, o, lse, do, delta=delta, **kw)),
        "flash_dkv": cuda_ms(lambda: fa.cuda_flash_dkv(
            q, k, v, o, lse, do, delta=delta, **kw)),
        "backward": cuda_ms(backward)}
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
    whole = ms["backward"]
    print(f"  {shape}: whole backward (delta + dq + dk/dv) {whole:.4f} ms; "
          f"SDPA backward "
          f"{'-' if lib_bwd is None else format(lib_bwd, '.4f')} ms"
          + ("" if lib_bwd is None else f" ({whole / lib_bwd:.2f}x)"),
          flush=True)
    res["backward"] = dict(shape=shape, ms=whole, library_ms=lib_bwd)
    return res


def _flash_deterministic(torch, fa, q, k, v, do, kw):
    """The backward twice on the same inputs, as the autograd Function runs
    it (dq making delta, dk/dv reading it): bitwise equal outputs."""
    o, lse = fa.cuda_flash_fwd(q, k, v, **kw)
    B, T, N, _ = q.shape
    runs = []
    for _ in range(2):
        d = torch.empty((B, N, T), dtype=torch.float32, device=q.device)
        dq = fa.cuda_flash_dq(q, k, v, o, lse, do, delta_out=d, **kw)
        runs.append((d, dq) + fa.cuda_flash_dkv(q, k, v, o, lse, do,
                                                 delta=d, **kw))
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    print(f"  two backward runs bitwise equal (delta, dq, dk, dv): {same}",
          flush=True)
    if not all(same):
        fail("the flash backward is not deterministic")


def _flash_bwd_faults(torch, fa, dev):
    """The backward's row check must see one 128-key tile left out of dq's
    walk and one 128-query tile left out of dk/dv's (the plain backward on
    the same o and lse with those pairs masked)."""
    q, k, v, do = _flash_inputs(torch, dev, 2, 1024, 12, 12, 64)
    o, lse = fa.torch_flash_fwd(q, k, v)
    want = fa.torch_flash_bwd(q, k, v, o, lse, do)
    ok = torch.ones((1024, 1024), dtype=torch.bool, device=dev).tril()
    scale = 64 ** -0.5
    no_keys, no_queries = ok.clone(), ok.clone()
    no_keys[:, 128:256] = False
    no_queries[128:256] = False
    dq_lost = fa.masked_bwd(q, k, v, o, lse, do, no_keys, scale)[0]
    dk_lost = fa.masked_bwd(q, k, v, o, lse, do, no_queries, scale)[1]
    for what, got, ref in (("128-key tile left out of dq's walk", dq_lost,
                            want[0]),
                           ("128-query tile left out of dk/dv's walk",
                            dk_lost, want[1])):
        r, _ = _rows_off(got, ref)
        print(f"  one {what} moves the worst row by {r:.3e} of its max "
              f"(check at {ROW_TOL})", flush=True)
        if not r > ROW_TOL:
            fail(f"the flash backward check cannot see one {what}")


# head dims the kernels pad (80 -> 96) and the widest (256, where the
# forward's O and dq's accumulators take 128 registers a thread and dk/dv's
# two warpgroups split the column blocks of one 64-key unit): (B, T, N,
# Nkv, D) at each model's attention width
WIDE_HEADS = (("Phi-2", (1, 2048, 32, 32, 80)),
              ("Phi-3-mini", (1, 4096, 32, 32, 96)),
              ("Gemma-7B", (1, 8192, 16, 16, 256)))


def phase_flash(torch, fa, dev):
    """Kernels #3-#5 against their plain versions, every variant, and at
    the wide head dims in bf16 and fp32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    ] + [(f"{name} {dt}".replace("torch.", ""), dims, dict(causal=True),
          dt) for name, dims in WIDE_HEADS
         for dt in (torch.bfloat16, torch.float32)]
    results = {}
    for label, dims, kw, *dt in cases:
        q, k, v, do = _flash_inputs(torch, dev, *dims, dtype=dt and dt[0])
        _check_flash(torch, fa, label, q, k, v, do, kw)
        if label == "main path":
            _flash_deterministic(torch, fa, q, k, v, do, kw)
        if label in ("main path", "Llama-3-8B", "window 512") or (
                dt and dt[0] == torch.bfloat16):
            r = _time_flash(torch, fa, q, k, v, do, kw)
            if label == "main path":
                results = r
        del q, k, v, do
        torch.cuda.empty_cache()
    _flash_bwd_faults(torch, fa, dev)
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


PHI2 = dict(num_layers=4, num_heads=32, head_dim=80, hidden_size=2560,
            mlp_ratio=4, vocab_size=51200, max_seq_len=2048, use_rope=True,
            rope_pct=0.4, parallel_block=True, qkv_bias=True,
            attn_out_bias=True, mlp_bias=True, tie_embeddings=False,
            unembed_bias=True, norm_eps=1e-5, loss_chunk=8192)
# ^ microsoft/phi-2 config.json (32 layers cut to 4): head dim 80, which
#   the flash kernels run padded to 96


def phase_train_phi2(torch, fa, dev, card):
    """initialize -> train_batch at Phi-2's widths (depth cut to 4 layers),
    bf16 with fp32 masters: 2 warm-up and 4 timed steps, the flash
    counters set to 0 just before and gated at 4 layers x gas 2 a step."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import GPTChunkedLoss, GPTConfig
    from deepspeed_tpu_torch.models.gpt import count_params
    cfg = GPTConfig(dtype=torch.bfloat16, **PHI2)
    ds_config = {"train_micro_batch_size_per_gpu": 4,
                 "gradient_accumulation_steps": 2,
                 "optimizer": {"type": "adamw",
                               "params": {"lr": 1e-4, "weight_decay": 0.01}},
                 "bf16": {"enabled": True},
                 "gradient_clipping": 1.0, "steps_per_print": 0}
    ids = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 2048)).astype(np.int32)
    model = GPTChunkedLoss(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    engine, _, loader, _ = ds.initialize(
        model=model, config=ds_config,
        training_data=[{"input_ids": row} for row in ids])
    batch = next(iter(ds.RepeatingLoader(loader)))
    tokens = int(np.prod(batch["input_ids"].shape))
    counters = (fa.cuda_flash_fwd, fa.cuda_flash_dq, fa.cuda_flash_dkv)
    for c in counters:
        c.launches = 0
    losses, times = [], []
    for step in range(6):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(engine.train_batch(batch).loss)
        torch.cuda.synchronize()
        if step >= 2:
            times.append(time.perf_counter() - t0)
        per_step = [c.launches - b for c, b in zip(counters, before)]
        if per_step != [8, 8, 8]:
            fail(f"Phi-2 step {step}: flash launches {per_step}, expected "
                 f"8 of each (4 layers x gas 2)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"Phi-2 widths: losses {losses}")
    med = statistics.median(times)
    e2e = dict(model="Phi-2 widths, 4 of 32 layers",
               params_m=count_params(cfg) / 1e6, step_ms_median=med * 1e3,
               tokens_per_step=tokens, tokens_per_s=tokens / med,
               loss_first=losses[0], loss_last=losses[-1],
               flash_launches=[c.launches for c in counters])
    print(f"  Phi-2 widths (4 of 32 layers, {e2e['params_m']:.0f}M params, "
          f"32 heads x 80): losses {[round(x, 4) for x in losses]}; "
          f"train_batch median {med * 1e3:.1f} ms = {tokens / med:.0f} "
          f"tokens/s; card {card}", flush=True)
    return e2e


# --------------------------------------------------------------- phase 9

LLAMA_PRODUCTS = (          # (label, K, N, group) of Llama-3-8B, then GPT-2
    ("Llama q / attention out", 4096, 4096, 128),
    ("Llama k / v", 4096, 1024, 128),
    ("Llama wi / wg", 4096, 14336, 128),
    ("Llama MLP wo", 14336, 4096, 128),
    ("Llama lm_head", 4096, 128256, 128),
    ("GPT-2 q / k / v", 768, 768, 128),
    ("GPT-2 attention out", 768, 768, 64),
    ("GPT-2 wi", 768, 3072, 128),
    ("GPT-2 MLP wo", 3072, 768, 128))
GPT2_TIED = ("GPT-2 tied unembed", 768, 50304, 128)   # [V, H] store, V padded
# quant.group_size 256: the engine packs groups of 256 where the dim allows
# (a K step, or a tied table's column tile, lies inside one group); the
# tied table padded to the group as the engine pads it
GROUP256 = (("Llama wi / wg, group 256", 4096, 14336, 256),
            ("Llama MLP wo, group 256", 14336, 4096, 256),
            ("GPT-2 tied unembed, group 256", 768, 50432, 256))


def _wq_bound(name, x, store):
    """Bytes: the codes (int4: half a byte a weight) and scales once, x read
    and y written once; operations: 2·M·K·N."""
    codes = store["v4" if name == "wq_matmul4" else "v"]
    M, K = x.shape
    N = codes.shape[0] if name == "wq_matmul_t" else codes.shape[1]
    nbytes = (codes.numel() + store["s"].numel() * 4
              + (M * K + M * N) * x.element_size())
    return _bound(nbytes, 2 * M * K * N)


def _check_wq(torch, wqm, name, label, x, store):
    _check(torch, name, label, getattr(wqm, "cuda_" + name)(x, store),
           getattr(wqm, "torch_" + name)(x, store))


def _int8_kv(torch, quantize_kv_token, k, v, gen):
    """int8 pages made the engine's way from K/V rows whose magnitudes vary
    by token (as activations do), so that a token's scale matters."""
    def q(t):
        mag = torch.exp(0.7 * torch.randn(t.shape[:-1] + (1,),
                                          device=t.device, generator=gen))
        return quantize_kv_token(t.float() * mag)
    (kq, ks), (vq, vs) = q(k), q(v)
    return kq, vq, {"k_scale": ks.contiguous(), "v_scale": vs.contiguous()}


WQ_MS = (1, 16, 17, 64, 256, 300)   # rows of x #7 / #8 are held at
WQ_GROUPS = (16, 128, 512)          # ... at each of these groups that fit
WQ_MISALIGNED = ("misaligned code rows", 4096, 1000, 128)   # N % 16 != 0


def _dequant(torch, name, store, dtype):
    from deepspeed_tpu_torch.ops.quantization import (dequantize_weight,
                                                      dequantize_weight4)
    w = (dequantize_weight4(store, dtype) if name == "wq_matmul4"
         else dequantize_weight(store, dtype))
    return w.t() if name == "wq_matmul_t" else w


def _wq_faults(torch, wqm, x, store):
    """The row check must see each fault the wgmma kernel could make, each
    applied to the plain product: one zeroed scale group (128 rows of K),
    one dropped 64-deep K stage, and a swizzle slip (the 16-byte chunks of
    every stage's B rows read from their neighbour's position: k rows
    8c..8c+7 swapped with 8(c^1)..)."""
    want = wqm.torch_wq_matmul(x, store)
    bad = {"v": store["v"], "s": store["s"].clone()}
    bad["s"][bad["s"].shape[0] // 2] = 0
    w = _dequant(torch, "wq_matmul", store, x.dtype)
    K = w.shape[0]
    dropped = w.clone()
    dropped[K // 2: K // 2 + 64] = 0
    k = torch.arange(K, device=w.device)
    slip = (k // 64) * 64 + (((k % 64) // 8) ^ 1) * 8 + k % 8
    for what, got in (("one zeroed scale group",
                       wqm.torch_wq_matmul(x, bad)),
                      ("one dropped K stage", x @ dropped),
                      ("a swizzle slip", x @ w[slip])):
        r = _row_err(torch, got, want)
        print(f"  {what} moves the worst row by {r:.3e} of its max (check "
              f"at {ROW_TOL})", flush=True)
        if not r > ROW_TOL:
            fail(f"the wq check cannot see {what}")


def _wq_t_fault(torch, wqm, x, store):
    """The row check must see #6 read one scale row (a group of V's rows)
    from the neighbouring group: the plain product with that row
    replaced."""
    bad = {"v": store["v"], "s": store["s"].clone()}
    r0 = bad["s"].shape[0] // 2
    bad["s"][r0] = store["s"][r0 + 1]
    r = _row_err(torch, wqm.torch_wq_matmul_t(x, bad),
                 wqm.torch_wq_matmul_t(x, store))
    print(f"  one scale row of the tied table read from the neighbouring "
          f"group moves the worst row by {r:.3e} of its max (check at "
          f"{ROW_TOL})", flush=True)
    if not r > ROW_TOL:
        fail("the wq_matmul_t check cannot see a neighbouring group's scales")


def phase_quant_kernels(torch, wqm, pa, dev):
    """#7 and #8 (the wgmma kernel) at every Llama-3-8B and GPT-2 product
    shape at M 1, 16, 17, 64, 256 and 300 and groups 16, 128 and 512 where
    the group divides K, and on code rows that are not 16-byte aligned; #6
    at the tied table (group 128 and 256) and #7 / #8 at group 256 on the
    MLP, each at M 16 and 256; the int8-KV variants of #1-#2 at phase 2's
    shapes and variants: each against its plain version.  The row check is
    shown to see a zeroed scale group, a dropped K stage, a swizzle slip
    and one page read with another page's scales.  Each product is timed at
    M 16 and 256 (its own group) beside its bound and one torch.matmul on
    the dequantized bf16 weight."""
    from deepspeed_tpu_torch.inference.v2.model import quantize_kv_token
    from deepspeed_tpu_torch.ops.quantization import (quantize_weight,
                                                      quantize_weight4)
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16
    rows = []
    checked = 0
    for label, K, N, g0 in LLAMA_PRODUCTS + (GPT2_TIED, WQ_MISALIGNED) \
            + GROUP256:
        tied = label.startswith(GPT2_TIED[0])
        w = torch.randn((N, K) if tied else (K, N), device=dev,
                        generator=gen) * 0.02
        main = label in {p[0] for p in LLAMA_PRODUCTS}
        # the tied table is grouped along V (its N), the others along K
        groups = sorted({g0} | ({g for g in WQ_GROUPS if K % g == 0}
                                if main else set())
                        | ({g for g in WQ_GROUPS if N % g == 0}
                           if label == GPT2_TIED[0] else set()))
        for g in groups:
            stores = {"wq_matmul_t": quantize_weight(w, group=g)} if tied \
                else {"wq_matmul": quantize_weight(w, group=g, dim=0),
                      "wq_matmul4": quantize_weight4(w, group=g)}
            for name, store in stores.items():
                ms_list = WQ_MS if main or label in (
                    WQ_MISALIGNED[0], GPT2_TIED[0]) else (16, 256)
                timed = WQ_MS if label == GPT2_TIED[0] else (16, 256)
                for M in ms_list:
                    x = torch.randn((M, K), device=dev, generator=gen).to(dt)
                    _check_wq(torch, wqm, name, f"{label} g={g} M={M}", x,
                              store)
                    checked += 1
                    if g != g0 or M not in timed:
                        continue
                    fn = getattr(wqm, "cuda_" + name)
                    wd = _dequant(torch, name, store, dt)
                    rows.append((name, label, M, cuda_ms(lambda: fn(x, store)),
                                 cuda_ms(lambda: torch.matmul(x, wd)),
                                 *_wq_bound(name, x, store)))
                    del wd
            if label == "Llama q / attention out" and g == g0:
                _wq_faults(torch, wqm, torch.randn(
                    (16, K), device=dev, generator=gen).to(dt),
                    stores["wq_matmul"])
            if label == GPT2_TIED[0] and g == g0:
                _wq_t_fault(torch, wqm, torch.randn(
                    (16, K), device=dev, generator=gen).to(dt),
                    stores["wq_matmul_t"])
            del stores
        del w
        torch.cuda.empty_cache()
    print(f"  {checked} products held per row at {ROW_TOL}", flush=True)
    for name, label, M, ms, lib_ms, bound_ms, by in rows:
        print(f"  {name} {label} M={M}: {ms:.4f} ms, torch.matmul bf16 "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"{bound_ms / ms:.1%} of it", flush=True)

    # int8-KV decode and prefill at phase 2's shapes and variants
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    S, nkv, g, hd, bs = 16, 8, 4, 128, 64
    k, v, bt, lens, lens_np = _paged_case(torch, rng, dev, dtype=dt)
    kq, vq, sc = _int8_kv(torch, quantize_kv_token, k, v, gen)
    del k, v
    slopes = torch.from_numpy(
        np.geomspace(0.5, 1 / 256, nkv * g).astype(np.float32)).to(dev)
    cases = {"plain": {}, "window512": {"window": 512},
             "alibi": {"alibi_slopes": slopes}}
    q = torch.randn((S, nkv, g, hd), device=dev).to(dt)
    bt1, lens1 = bt[:, :1].contiguous(), lens.clamp(max=bs)
    for name, kw in cases.items():
        for lab, table, kv in ((name, bt, lens),
                               (f"{name}, one page", bt1, lens1)):
            _check(torch, "paged_attention_int8", lab,
                   pa.cuda_paged_attention(q, kq, vq, table, kv, **kw, **sc),
                   pa.torch_paged_attention(q, kq, vq, table, kv, **kw, **sc))
    # the row check must see one page of the longest slot read with another
    # page's scales
    want = pa.torch_paged_attention(q, kq, vq, bt, lens, **sc)
    bad = {n: t.clone() for n, t in sc.items()}
    a, b = int(bt[S - 1, 5]), int(bt[S - 1, 6])
    for t in bad.values():
        t[a] = sc["k_scale"][b] if t is bad["k_scale"] else sc["v_scale"][b]
    r = _row_err(torch, pa.torch_paged_attention(q, kq, vq, bt, lens, **bad),
                 want)
    print(f"  one int8 page read with another page's scales moves the worst "
          f"row by {r:.3e} of its max (check at {ROW_TOL})", flush=True)
    if not r > ROW_TOL:
        fail("the int8-KV check cannot see a page's swapped scales")
    _decode_faults(torch, pa, q, kq, vq, bt, lens, dict(sc))
    results = {"paged_attention_int8": _time_decode(
        torch, pa, q, kq, vq, bt, lens, dict(sc))}
    Q = 128
    counts = np.array([0, 1, 1, 37, 128, 128, 5, 128, 64, 1, 128, 17, 128,
                       100, 128, 1], np.int32)
    kvl = np.minimum(np.maximum(lens_np, counts), 2048).astype(np.int32)
    lens2, q_starts, q_counts = (torch.from_numpy(x).to(dev)
                                 for x in (kvl, kvl - counts, counts))
    qp = torch.randn((S, Q, nkv, g, hd), device=dev).to(dt)
    for name, kw in cases.items():
        _check(torch, "ragged_prefill_int8", name,
               pa.cuda_ragged_prefill(qp, kq, vq, bt, lens2, q_starts,
                                      q_counts, **kw, **sc),
               pa.torch_ragged_prefill(qp, kq, vq, bt, lens2, q_starts,
                                       q_counts, **kw, **sc))
    _prefill_faults(torch, pa, qp, kq, vq, bt, lens2, q_starts, q_counts,
                    dict(sc), "ragged_prefill_int8")
    results["ragged_prefill_int8"] = _time_prefill(
        torch, pa, qp, kq, vq, bt, lens2, q_starts, q_counts, dict(sc))
    _print_times(results)


# --------------------------------------------------------------- phase 10

def phase_quant_parity(torch, dev):
    """Quantized greedy generate on the card == on the CPU (fp32, TF32 off):
    W8 weights with int8 KV, and W4 weights."""
    import dataclasses
    from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        GPTConfig.llama(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
                        vocab_size=512, max_seq_len=256), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sm = {"max_tracked_sequences": 4, "max_ragged_batch_size": 64,
          "kv_block_size": 8, "max_q_per_seq": 8, "num_kv_blocks": 10}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (18 + 5 * i,)).astype(np.int32)
               for i in range(4)]
    for label, extra in (("W8 + int8 KV", {
            "quant": {"enabled": True, "bits": 8},
            "state_manager": dict(sm, kv_quant="int8")}),
            ("W4", {"quant": {"enabled": True, "bits": 4},
                    "state_manager": sm})):
        out = {d: InferenceEngineV2(cfg, config={"dtype": "fp32", **extra},
                                    params=params, device=d).generate(
                                        prompts, max_new_tokens=20)
               for d in ("cpu", dev)}
        for i, (a, b) in enumerate(zip(out["cpu"], out[dev])):
            if not np.array_equal(a, b):
                fail(f"quantized parity ({label}): request {i} differs\n cpu "
                     f" {a}\n cuda {b}")
        print(f"  {label}: greedy tokens equal on cpu and {dev} "
              f"({sum(len(o) for o in out['cpu'])} tokens)", flush=True)


# --------------------------------------------------------- phases 11 and 12

def _time_wq(torch, wqm, name, x, store):
    """Kernel, plain and library (one torch.matmul of x with the weight in
    bf16, unquantized) device times of one product, beside its bound."""
    w = _dequant(torch, name, store, x.dtype)
    bound_ms, bound_by = _wq_bound(name, x, store)
    codes = store["v4" if name == "wq_matmul4" else "v"]
    g = (codes.shape[0] if name == "wq_matmul_t"
         else x.shape[1]) // store["s"].shape[0]
    return dict(
        shape=f"x[{x.shape[0]},{x.shape[1]}] {x.dtype}, store "
              f"{tuple(codes.shape)} group {g}",
        ms=cuda_ms(lambda: getattr(wqm, "cuda_" + name)(x, store)),
        plain_ms=cuda_ms(lambda: getattr(wqm, "torch_" + name)(x, store),
                         reps=10),
        library_ms=cuda_ms(lambda: torch.matmul(x, w)),
        bound_ms=bound_ms, bound_by=bound_by)


def _llama_cfg(torch):
    from deepspeed_tpu_torch import GPTConfig
    return GPTConfig.llama(num_layers=32, hidden=4096, heads=32,
                           num_kv_heads=8, vocab_size=128256,
                           max_seq_len=8192, mlp_dim_override=14336,
                           rope_theta=500000.0, norm_eps=1e-5,
                           dtype=torch.bfloat16)


def _quantized_engine(torch, label, cfg, params, ecfg, dev):
    """A quantized engine built from a bf16 tree; prints the store's bytes
    against the tree's."""
    from deepspeed_tpu_torch import InferenceEngineV2
    from deepspeed_tpu_torch.ops.quantization import store_nbytes
    dense = store_nbytes(params)
    t0 = time.perf_counter()
    eng = InferenceEngineV2(cfg, config=ecfg, params=params, device=dev)
    torch.cuda.synchronize()
    store = store_nbytes(eng.params)
    print(f"  {label}: store {store / 1e9:.3f} GB = {store / dense:.4f} of "
          f"the bf16 tree's {dense / 1e9:.3f} GB (built in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return eng, dict(store_gb=store / 1e9, bf16_tree_gb=dense / 1e9,
                     store_ratio=store / dense)


def phase_quant_main(torch, wqm, pa, dev, card, llama_params=None,
                     bf16_outs=None, bf16_pool=None, profile=False,
                     bf16_tok_s=None):
    """Quantized InferenceEngineV2.generate at full width: Llama-3-8B W8 +
    int8 KV and W4 (both built from one bf16 tree, one engine at a time),
    then GPT-2 small W8 (tied, vocabulary padded to 50304); each new kernel
    held and timed on its heaviest main-path call (phase 12)."""
    from deepspeed_tpu_torch.models.gpt import init_params
    from deepspeed_tpu_torch import GPTConfig
    results, e2es = {}, []
    cfg = _llama_cfg(torch)
    if llama_params is None:
        llama_params = init_params(cfg, torch.Generator(
            device=dev).manual_seed(0), dev, torch.bfloat16)
    sm = LLAMA_SM
    if bf16_pool is None:
        bf16_pool = 2 * (cfg.num_layers * sm["num_kv_blocks"] + 1) \
            * cfg.kv_heads * sm["kv_block_size"] * cfg.head_dim * 2
    prompts, news = _requests(cfg.vocab_size, 1025)

    # ---- W8 + int8 KV
    label = "Llama-3-8B W8 + int8 KV"
    eng, sizes = _quantized_engine(
        torch, label, cfg, llama_params,
        {"dtype": "bfloat16", "quant": {"enabled": True, "bits": 8},
         "state_manager": dict(sm, kv_quant="int8")}, dev)
    rec = _record_calls(eng, {"wq_matmul": "wq_matmul",
                              "paged_attention": "paged_attention_int8",
                              "ragged_prefill_attention":
                              "ragged_prefill_int8"})
    outs, e2e = _serve(torch, label, eng, prompts, news,
                       ("wq_matmul", "paged_attention_int8",
                        "ragged_prefill_int8"), card, profile)
    rec.restore()
    e2e.update(sizes)
    if bf16_tok_s:
        e2e["tok_per_s_vs_bf16"] = e2e["generated_tok_per_s"] / bf16_tok_s
        print(f"  {label}: {e2e['tok_per_s_vs_bf16']:.3f}x the bf16 "
              f"engine's generated tok/s (phase 4, same requests)",
              flush=True)
    e2e["kv_pool_ratio"] = e2e["kv_pool_gb"] * 1e9 / bf16_pool
    print(f"  int8 KV pool: {e2e['kv_pool_ratio']:.4f} of the bf16 pool's "
          f"{bf16_pool / 1e9:.3f} GB", flush=True)
    if e2e["store_ratio"] > 0.53 or e2e["kv_pool_ratio"] > 0.53:
        fail(f"W8 store {e2e['store_ratio']} / int8 KV pool "
             f"{e2e['kv_pool_ratio']} above 0.53 of bf16")
    if bf16_outs is not None:
        same = [int(np.sum(a[:min(len(a), len(b))] == b[:min(len(a), len(b))]))
                for a, b in zip(outs, bf16_outs)]
        first = sum(int(a[0] == b[0]) for a, b in zip(outs, bf16_outs))
        e2e["greedy_agreement_with_bf16"] = sum(same) / sum(map(len, outs))
        print(f"  greedy agreement with the bf16 engine (not gated: random "
              f"weights have near-ties): {sum(same)} of "
              f"{sum(map(len, outs))} positions, first token of {first} of "
              f"{len(outs)} requests", flush=True)
    # put logits through the kernels vs the plain versions swapped into the
    # registry, on one fresh prompt each.  E2E_TOL: both paths are bf16;
    # each of the ~290 products and attention calls on the way agrees to
    # about one bf16 rounding (2^-8 of its rows, phases 9 and 12), and 32
    # residual layers of random weights compound those as a random walk
    # (sqrt(290) x 2^-8 ~ 7%)
    p = prompts[0][:64]
    got = eng.put([10 ** 6], [p])
    rec.swap_plain()
    want = eng.put([10 ** 6 + 1], [p])
    rec.restore()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    e2e["put_logits_vs_plain"] = err
    e2e["put_logits_vs_plain_l2"] = rel
    print(f"  put() logits through the kernels vs the plain versions: worst "
          f"|diff| {err:.3e} of the largest logit (check at {E2E_TOL}), "
          f"relative L2 {rel:.3e}; argmax equal: "
          f"{int(got.argmax()) == int(want.argmax())}", flush=True)
    if not np.isfinite(got).all() or not err <= E2E_TOL:
        fail(f"W8 + int8 KV put() logits differ from the plain path by {err}")
    for name in ("wq_matmul", "paged_attention_int8", "ragged_prefill_int8"):
        results[name] = _hold_and_time(torch, wqm, pa, rec, name,
                                       eng.state.max_blocks_per_seq)
        results[name]["launches"] = e2e["launches"][name]
    e2es.append(e2e)
    del eng, rec
    gc.collect()
    torch.cuda.empty_cache()

    # ---- W4
    label = "Llama-3-8B W4"
    eng, sizes = _quantized_engine(
        torch, label, cfg, llama_params,
        {"dtype": "bfloat16", "quant": {"enabled": True, "bits": 4},
         "state_manager": sm}, dev)
    rec = _record_calls(eng, {"wq_matmul4": "wq_matmul4"})
    outs, e2e = _serve(torch, label, eng, prompts, news,
                       ("wq_matmul4", "wq_matmul", "paged_attention",
                        "ragged_prefill"), card)
    rec.restore()
    e2e.update(sizes)
    if bf16_tok_s:
        e2e["tok_per_s_vs_bf16"] = e2e["generated_tok_per_s"] / bf16_tok_s
        print(f"  {label}: {e2e['tok_per_s_vs_bf16']:.3f}x the bf16 "
              f"engine's generated tok/s", flush=True)
    if e2e["store_ratio"] > 0.30:
        fail(f"W4 store at {e2e['store_ratio']} of bf16, above 0.30")
    results["wq_matmul4"] = _hold_and_time(torch, wqm, pa, rec, "wq_matmul4")
    results["wq_matmul4"]["launches"] = e2e["launches"]["wq_matmul4"]
    e2es.append(e2e)
    del eng, rec, llama_params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- GPT-2 small W8, tied and padded
    gcfg = GPTConfig.gpt2_small(vocab_size=50257, max_seq_len=1024,
                                dtype=torch.bfloat16)
    gparams = init_params(gcfg, torch.Generator(device=dev).manual_seed(0),
                          dev, torch.bfloat16)
    gprompts, gnews = _requests(gcfg.vocab_size, 513)
    label = "GPT-2 small W8 (tied)"
    eng, sizes = _quantized_engine(
        torch, label, gcfg, gparams,
        {"dtype": "bfloat16", "quant": {"enabled": True, "bits": 8},
         "state_manager": dict(LLAMA_SM, num_kv_blocks=16 * 1024 // 64)},
        dev)
    rec = _record_calls(eng, {"wq_matmul_t": "wq_matmul_t"})
    outs, e2e = _serve(torch, label, eng, gprompts, gnews,
                       ("wq_matmul_t", "wq_matmul", "paged_attention",
                        "ragged_prefill"), card)
    rec.restore()
    e2e.update(sizes)
    if eng.params["backbone"]["wte"]["v"].shape[0] != 50304:
        fail("GPT-2's tied table was not padded to 50304 rows")
    logits = eng.put([10 ** 6], [gprompts[0][:32]])
    if logits.shape != (1, 50257) or not np.isfinite(logits).all():
        fail(f"GPT-2 W8 put() logits {logits.shape} not finite / 50257 wide")
    results["wq_matmul_t"] = _hold_and_time(torch, wqm, pa, rec,
                                            "wq_matmul_t")
    results["wq_matmul_t"]["launches"] = e2e["launches"]["wq_matmul_t"]
    e2es.append(e2e)
    del eng, rec, gparams
    gc.collect()
    torch.cuda.empty_cache()
    return results, e2es


def _hold_and_time(torch, wqm, pa, rec, name, width=None):
    """Phase 12 for one kernel: hold it to its plain version on its
    heaviest recorded main-path call, then time it there (the decode also
    with its table padded to ``width`` columns)."""
    args, kw = rec.pick(name)
    if name.startswith("wq"):
        x, store = args
        _check_wq(torch, wqm, name, "main path", x, store)
        r = _time_wq(torch, wqm, name, x, store)
        _print_times({name: r}, library="torch.matmul (bf16 weight)")
        return r
    if name == "paged_attention_int8":
        _check(torch, name, "main path", pa.cuda_paged_attention(*args, **kw),
               pa.torch_paged_attention(*args, **kw))
        r = _time_decode(torch, pa, *args, kw)
        _print_times({name + "_full_width": _decode_full_width(
            torch, pa, name, *args, kw, width)})
    else:
        _check(torch, name, "main path", pa.cuda_ragged_prefill(*args, **kw),
               pa.torch_ragged_prefill(*args, **kw))
        r = _time_prefill(torch, pa, *args, kw)
        _prefill_probe(torch, pa, args, kw, f"{name} main path")
    _print_times({name: r})
    return r


# --------------------------------------------------------------- phase 13

LORA_SLOTS = 9              # 8 tenants + the identity slot 0
LORA_H = 4096               # Llama-3-8B hidden
LORA_PROJ = (("q", 4096), ("v", 1024))   # (projection, O)


def _lora_inputs(torch, dev, M, O, r, ids, gen):
    """Pages as the pool keeps them (slot 0 zero, scale 0; the tenants'
    pages at random_adapter_weights' default scale 0.02), x at unit
    scale; ids random over the slots, all identity, or one tenant."""
    dt = torch.bfloat16
    S = LORA_SLOTS
    x = torch.randn((M, LORA_H), device=dev, generator=gen).to(dt)
    a = (torch.randn((S, LORA_H, r), device=dev, generator=gen) * 0.02)
    b = (torch.randn((S, r, O), device=dev, generator=gen) * 0.02)
    a[0] = 0
    b[0] = 0
    s = torch.full((S,), 2.0, device=dev)
    s[0] = 0
    if ids == "random":
        sel = torch.randint(0, S, (M,), device=dev, generator=gen)
    else:
        sel = torch.full((M,), 0 if ids == "identity" else 5, device=dev)
    return x, a.to(dt), b.to(dt), sel.to(torch.int32), s


def _lora_bound(x, a_pages, b_pages, ids, scales):
    """Bytes: x, ids, the pages and scale of each DISTINCT selected slot
    (what this call's data needs) read once, y written once; operations:
    2·M·H·r + 2·M·r·O."""
    M, H = x.shape
    r, O = b_pages.shape[1], b_pages.shape[2]
    used = int(ids.unique().numel())
    es = x.element_size()
    nbytes = ((M * H + M * O) * es + M * 4
              + used * ((H * r + r * O) * es + 4))
    return _bound(nbytes, 2 * M * H * r + 2 * M * r * O)


def _time_lora(torch, lm, args, label):
    """The kernel's time (the expand a programmatic dependent launch of the
    shrink), the same pair as two plain launches, the plain version's, and
    the bound."""
    bound_ms, bound_by = _lora_bound(*args)
    x, a, b, ids, _ = args
    return dict(
        shape=f"{label}: x[{x.shape[0]},{x.shape[1]}] {x.dtype}, A "
              f"{tuple(a.shape)}, B {tuple(b.shape)}, "
              f"{int(ids.unique().numel())} slots used, route "
              f"{'wgmma' if lm.call_route(x, a, b) else 'simt'}",
        ms=cuda_ms(lambda: lm.cuda_lora_matmul(*args)),
        two_launches_ms=cuda_ms(lambda: lm._launch(*args, pdl=False)),
        plain_ms=cuda_ms(lambda: lm.torch_lora_matmul(*args), reps=10),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def _check_lora(torch, lm, label, args):
    got = lm.cuda_lora_matmul(*args)
    want = lm.torch_lora_matmul(*args)
    _check(torch, "lora_matmul", label, got, want)
    ident = args[3] == 0
    if bool(got[ident].any()):
        fail(f"lora_matmul {label}: an identity-slot row is not exactly 0")


def _print_lora(results):
    for r in results:
        print(f"  lora_matmul {r['shape']}: kernel {r['ms']:.4f} ms (two "
              f"plain launches {r['two_launches_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of it",
              flush=True)


def _lora_faults(torch, lm, dev, gen):
    """The row check must see a slot's 65th row (in row order) left out of
    its tile, shown as the row left at zero, and one 256-wide H chunk left
    out of the partial sums (x's chunk zeroed), each in the plain version;
    each fault's size printed."""
    x, a, b, ids, s = _lora_inputs(torch, dev, 130, 4096, 16, "random", gen)
    ids[torch.randperm(130, device=dev, generator=gen)[:70]] = 3
    want = lm.torch_lora_matmul(x, a, b, ids, s)
    left = want.clone()
    left[(ids == 3).nonzero()[64, 0]] = 0
    chunk = x.clone()
    chunk[:, lm.H_CHUNK:2 * lm.H_CHUNK] = 0
    for what, got in (("a slot's 65th row left out of its tile", left),
                      ("one H chunk left out of the sum",
                       lm.torch_lora_matmul(chunk, a, b, ids, s))):
        r = _row_err(torch, got, want)
        print(f"  {what} moves the worst row by {r:.3e} of its max (check "
              f"at {ROW_TOL})", flush=True)
        if not r > ROW_TOL:
            fail(f"the lora check cannot see {what}")


def phase_lora_kernels(torch, lm, dev):
    """#9 against its plain version at Llama-3-8B's q and v projections
    (bf16), ranks 8 / 16 / 64, M 1..1024, three id patterns; the check is
    shown to see a row read through its neighbour's slot; timed at M 16
    and 256 (rank 16).  Returns the M 256 q-projection timing."""
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = []
    for proj, O in LORA_PROJ:
        for r in (8, 16, 64):
            for M in (1, 16, 37, 256, 1024):
                for ids in ("random", "identity", "one tenant"):
                    args = _lora_inputs(torch, dev, M, O, r, ids, gen)
                    _check_lora(torch, lm, f"{proj} r={r} M={M} {ids}",
                                args)
                    if r == 16 and M in (16, 256) and ids == "random":
                        timed.append(_time_lora(torch, lm, args,
                                                f"{proj} r=16 M={M}"))
    # the row check must see one row read through its neighbour's slot
    x, a, b, ids, s = _lora_inputs(torch, dev, 16, 4096, 16, "random", gen)
    ids_np = ids.cpu().numpy()
    i = next(j for j in range(1, 16)
             if ids_np[j] not in (0, ids_np[j - 1]) and ids_np[j - 1] != 0)
    wrong = ids.clone()
    wrong[i] = wrong[i - 1]
    row = _row_err(torch, lm.torch_lora_matmul(x, a, b, wrong, s)[i],
                   lm.torch_lora_matmul(x, a, b, ids, s)[i])
    print(f"  one row read through its neighbour's slot moves by {row:.3e} "
          f"of its max (check at {ROW_TOL})", flush=True)
    if not row > ROW_TOL:
        fail("the lora check cannot see a row read through another slot")
    _lora_faults(torch, lm, dev, gen)
    _print_lora(timed)
    return next(t for t in timed if t["shape"].startswith("q r=16 M=256"))


# --------------------------------------------------------------- phase 14

def _tenants(cfg, rank, init_scale, n=8):
    from deepspeed_tpu_torch.serving import random_adapter_weights
    return {aid: random_adapter_weights(
        cfg.num_layers, cfg.hidden_size, rank, cfg.num_heads * cfg.head_dim,
        cfg.kv_heads * cfg.head_dim, seed=aid, init_scale=init_scale)
        for aid in range(1, n + 1)}


def phase_lora_parity(torch, dev):
    """Adapter greedy generate on the card == on the CPU (fp32, TF32 off):
    8 tenants with 9 slots, with 3 slots (eviction churn), and with quant 8
    + int8 KV."""
    import dataclasses
    from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        GPTConfig.llama(num_layers=2, hidden=128, heads=4, num_kv_heads=2,
                        vocab_size=512, max_seq_len=256), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tenants = _tenants(cfg, 4, 0.5)
    sm = {"max_tracked_sequences": 8, "max_ragged_batch_size": 64,
          "kv_block_size": 8, "max_q_per_seq": 8}
    adp = {"enabled": True, "rank": 4, "alpha": 8.0, "slots": 9}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (6 + 5 * i,)).astype(np.int32)
               for i in range(8)]
    ids = [1 + i for i in range(8)]
    for label, extra in (
            ("8 tenants, 9 slots", {"adapters": adp, "state_manager": sm}),
            ("8 tenants, 3 slots", {"adapters": dict(adp, slots=3),
                                    "state_manager": sm}),
            ("quant 8 + int8 KV + adapters", {
                "adapters": adp, "quant": {"enabled": True, "bits": 8},
                "state_manager": dict(sm, kv_quant="int8")})):
        out, stats = {}, {}
        for d in ("cpu", dev):
            eng = InferenceEngineV2(cfg, config={"dtype": "fp32", **extra},
                                    params=params, device=d)
            for aid, w in tenants.items():
                eng.register_adapter(aid, w)
            out[d] = eng.generate(prompts, max_new_tokens=12,
                                  adapter_ids=ids)
            stats[d] = eng.adapters.stats()
            eng.adapters.check_invariants()
        for i, (a, b) in enumerate(zip(out["cpu"], out[dev])):
            if not np.array_equal(a, b):
                fail(f"adapter parity ({label}): request {i} differs\n cpu "
                     f" {a}\n cuda {b}")
        if stats["cpu"] != stats[dev] or stats[dev]["pinned_blocks"]:
            fail(f"adapter parity ({label}): pool stats differ or pinned: "
                 f"{stats}")
        print(f"  {label}: greedy tokens equal on cpu and {dev} "
              f"({sum(len(o) for o in out['cpu'])} tokens); pool "
              f"{stats[dev]}", flush=True)


# --------------------------------------------------------------- phase 15

class _count_forwards:
    """While installed, counts the model's forward passes (mixed steps and
    decode steps, each step of a burst included) by wrapping the two
    functions every generate step goes through."""

    def __enter__(self):
        import importlib
        self.m = importlib.import_module(
            "deepspeed_tpu_torch.inference.v2.model")
        self.n = 0
        self.orig = (self.m.ragged_forward, self.m._decode_core)

        def wrap(fn):
            def call(*a, **kw):
                self.n += 1
                return fn(*a, **kw)
            return call
        self.m.ragged_forward, self.m._decode_core = (
            wrap(f) for f in self.orig)
        return self

    def __exit__(self, *exc):
        self.m.ragged_forward, self.m._decode_core = self.orig


def _adapter_put(eng, uid, toks, aid):
    """put() of one new sequence through adapter ``aid`` (put itself serves
    the base model): load and pin the adapter, select its slot, run."""
    eng.state.ensure_adapters([aid])
    seq = eng.state.create(uid)
    eng.state.bind_adapter(seq, aid)
    eng._adapter_slot[seq.slot] = eng.adapters.slot_of(aid)
    return eng.put([uid], [toks])


def _check_adapter_pool(label, eng):
    st = eng.adapters.stats()
    alloc = eng.state.allocator
    eng.adapters.check_invariants()
    if st["pinned_blocks"] or (alloc.free_blocks + st["resident_blocks"]
                               != alloc.num_blocks):
        fail(f"{label}: pool not clean after the run: {st}, free "
             f"{alloc.free_blocks} of {alloc.num_blocks}")
    return st


def phase_lora_main(torch, lm, dev, card, params, base_e2e=None,
                    base_outs=None, profile=False):
    """generate(adapter_ids=...) at full Llama-3-8B width (phase 4's bf16
    tree), 8 tenants + identity; then a 3-slot run that must evict."""
    from deepspeed_tpu_torch import InferenceEngineV2
    cfg = _llama_cfg(torch)
    if params is None:
        from deepspeed_tpu_torch.models.gpt import init_params
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, torch.bfloat16)
    t0 = time.perf_counter()
    tenants = _tenants(cfg, 16, 0.02)
    print(f"  8 tenants' host weights (rank 16) made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    adp = {"enabled": True, "rank": 16, "alpha": 32.0, "slots": LORA_SLOTS}
    eng = InferenceEngineV2(cfg, config={"dtype": "bfloat16",
                                         "state_manager": LLAMA_SM,
                                         "adapters": adp},
                            params=params, device=dev)
    for aid, w in tenants.items():
        eng.register_adapter(aid, w)
    pool = eng.adapters
    print(f"  pool: {pool.blocks_per_adapter} blocks of "
          f"{eng.kv_block_bytes() / 2 ** 20:.1f} MiB a tenant; tables "
          f"{sum(t.numel() * t.element_size() for t in pool.tables().values()) / 1e6:.1f} MB",
          flush=True)
    prompts, news = _requests(cfg.vocab_size, 1025)
    ids = [i % LORA_SLOTS for i in range(len(prompts))]
    label = "Llama-3-8B bf16 + LoRA"
    rec = _record_calls(eng, {"lora_matmul": "lora_matmul"})
    with _count_forwards() as fw:
        outs, e2e = _serve(torch, label, eng, prompts, news,
                           ("lora_matmul", "paged_attention",
                            "ragged_prefill"), card, profile,
                           adapter_ids=ids)
    rec.restore()
    n_lora = e2e["launches"]["lora_matmul"]
    want = 2 * cfg.num_layers * fw.n
    print(f"  forward passes {fw.n}; lora_matmul launches {n_lora} "
          f"(2 x {cfg.num_layers} x {fw.n} = {want})", flush=True)
    if n_lora != want:
        fail(f"{label}: {n_lora} lora_matmul launches, expected {want}")
    st = _check_adapter_pool(label, eng)
    e2e["forward_passes"] = fw.n
    e2e["pool"] = st
    print(f"  pool after the run: {st}", flush=True)
    if base_e2e is not None:
        e2e["base_generated_tok_per_s"] = base_e2e["generated_tok_per_s"]
        print(f"  generated tok/s {e2e['generated_tok_per_s']:.1f} with 8 "
              f"tenants against {base_e2e['generated_tok_per_s']:.1f} for "
              f"phase 4's base model in this run "
              f"({e2e['generated_tok_per_s'] / base_e2e['generated_tok_per_s']:.3f}x)",
              flush=True)
    if base_outs is not None:
        same = [int(np.array_equal(outs[i], base_outs[i]))
                for i in range(len(ids)) if ids[i] == 0]
        pos = [int(np.sum(outs[i] == base_outs[i])) for i in range(len(ids))
               if ids[i] == 0]
        e2e["identity_requests_equal_base"] = sum(same)
        print(f"  identity-slot requests equal to phase 4's tokens (not "
              f"gated): {sum(same)} of {len(same)} ({pos} positions)",
              flush=True)
    # put() logits through an adapter: the kernel against the plain version
    # swapped into the registry (E2E_TOL as in phase 11: bf16 both ways,
    # 64 LoRA calls on top of the base path's products and attention)
    p = prompts[1][:64]
    got = _adapter_put(eng, 10 ** 6, p, 1)
    rec.swap_plain()
    want_l = _adapter_put(eng, 10 ** 6 + 1, p, 1)
    rec.restore()
    eng.flush([10 ** 6, 10 ** 6 + 1])
    base_l = eng.put([10 ** 6 + 2], [p])
    eng.flush([10 ** 6 + 2])
    err = float(np.abs(got - want_l).max() / np.abs(want_l).max())
    moved = float(np.abs(want_l - base_l).max() / np.abs(base_l).max())
    e2e["put_logits_vs_plain"] = err
    e2e["adapter_moves_logits"] = moved
    print(f"  put() logits through adapter 1, kernel vs plain: worst |diff| "
          f"{err:.3e} of the largest logit (check at {E2E_TOL}); the "
          f"adapter moves them by {moved:.3e} from the base model's; argmax "
          f"equal: {int(got.argmax()) == int(want_l.argmax())}", flush=True)
    if not np.isfinite(got).all() or not err <= E2E_TOL:
        fail(f"{label}: put() logits differ from the plain path by {err}")
    _check_adapter_pool(label + " after put", eng)
    args, _ = rec.pick("lora_matmul")
    _check_lora(torch, lm, "main path", args)
    result = _time_lora(torch, lm, args, "main path")
    # the decode steps' calls: every row a decode row (M at most the
    # engine's 16 slots); one is held and timed too
    ms_ = [c[0][0].shape[0] for c in rec["lora_matmul"]]
    small = [c for c in rec["lora_matmul"] if c[0][0].shape[0] <= 16]
    decode_calls = len(small) * cfg.num_layers
    print(f"  lora_matmul calls of the run: {n_lora}; decode-step calls "
          f"(M <= 16): {decode_calls} ({len(small)} of the {len(ms_)} "
          f"first-layer calls recorded, M {min(ms_)}..{max(ms_)})",
          flush=True)
    result["decode_calls"] = decode_calls
    timed = [result]
    if small:
        dargs = max(small, key=lambda c: c[0][0].shape[0])[0]
        _check_lora(torch, lm, "main path, decode step", dargs)
        result["decode"] = _time_lora(torch, lm, dargs,
                                      "main path, decode step")
        timed.append(result["decode"])
    _print_lora(timed)
    result["launches"] = n_lora
    del eng, rec
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3 slots: two tenant slots for 7 tenants -> admission waits for
    # pins to drain and loads evict
    eng = InferenceEngineV2(cfg, config={"dtype": "bfloat16",
                                         "state_manager": LLAMA_SM,
                                         "adapters": dict(adp, slots=3)},
                            params=params, device=dev)
    for aid, w in tenants.items():
        eng.register_adapter(aid, w)
    rng = np.random.default_rng(1)
    sprompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                for n in rng.integers(64, 257, 8)]
    label3 = "Llama-3-8B bf16 + LoRA, 3 slots"
    sids = [i % LORA_SLOTS for i in range(8)]
    _, e2e3 = _serve(torch, label3, eng, sprompts, [32] * 8,
                     ("lora_matmul",), card, adapter_ids=sids)
    st3 = _check_adapter_pool(label3, eng)
    print(f"  pool after the 3-slot run: {st3}", flush=True)
    if st3["evictions"] <= 0:
        fail(f"{label3}: no eviction")
    e2e["three_slots"] = dict(pool=st3, wall_s=e2e3["wall_s"],
                              generated_tok_per_s=e2e3[
                                  "generated_tok_per_s"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return result, e2e


# --------------------------------------------------------------- phase 16

LLAMA_ATTN = (1, 8192, 32, 8, 128)   # B, T, N, Nkv, D: Llama-3-8B, its context


def _even_columns(sp):
    """A layout class that leaves the odd K/V blocks unread: every row
    block sees the even column blocks at or before it (the dead-block
    check)."""
    class EvenColumns(sp.SparsityConfig):
        def make_layout(self, seq_len):
            nb = seq_len // self.block
            lay = np.tril(np.ones((nb, nb), bool))
            lay[:, 1::2] = False
            return lay
    return EvenColumns


def _check_sparse(torch, sp, label, q, k, v, do, cfg, causal):
    """o, lse, dq, dk, dv of the three kernels against the plain versions
    (the backward kernels get the plain o and lse)."""
    tol = F32_TOL if q.dtype == torch.float32 else ROW_TOL
    lay = cfg.make_layout(q.shape[1])
    o, lse = sp.cuda_sparse_fwd(q, k, v, lay, cfg.block, causal)
    o_ref, lse_ref = sp.torch_sparse_fwd(q, k, v, lay, cfg.block, causal)
    _check_rows(torch, "sparse_fwd", label + " o", o, o_ref, tol)
    lerr = (lse - lse_ref).abs().max().item()
    print(f"  sparse_fwd[{label} lse] max|kernel-plain| = {lerr:.3e}",
          flush=True)
    if not lerr <= tol:
        fail(f"sparse_fwd {label}: lse differs by {lerr}")
    B, T, N, _ = q.shape
    delta = torch.full((B, N, T), float("nan"), device=q.device)
    dq = sp.cuda_sparse_dq(q, k, v, o_ref, lse_ref, do, lay, cfg.block,
                           causal, delta_out=delta)
    want = sp._bwd_inputs("check", q, o_ref, lse_ref, do)[2]
    derr = ((delta - want).abs().max() / want.abs().max()).item()
    print(f"  sparse_dq[{label} delta] max|kernel-eager| = {derr:.3e} of "
          f"the largest", flush=True)
    if not derr <= F32_TOL:
        fail(f"sparse_dq {label}: the delta it made differs by {derr}")
    dk, dv = sp.cuda_sparse_dkv(q, k, v, o_ref, lse_ref, do, lay, cfg.block,
                                causal, delta=delta)
    dq_ref, dk_ref, dv_ref = sp.torch_sparse_bwd(q, k, v, o_ref, lse_ref, do,
                                                 lay, cfg.block, causal)
    _check_rows(torch, "sparse_dq", label + " dq", dq, dq_ref, tol)
    _check_rows(torch, "sparse_dkv", label + " dk", dk, dk_ref, tol)
    _check_rows(torch, "sparse_dkv", label + " dv", dv, dv_ref, tol)
    return o_ref, lse_ref


def phase_sparse_kernels(torch, sp, dev):
    """Kernels #10-#12 against their plain versions (bf16; one fp16 case)
    over every layout class, causal and not, GQA 1 and 4, blocks 16-128 and
    head_dim 64 / 128; NaN-poisoned unread K/V blocks; one dropped table
    entry must show."""
    EvenColumns = _even_columns(sp)
    cases = [  # label, (B, T, N, Nkv, D), config, causal, dtype
        ("fixed b16 causal g4 d128", (1, 2048, 8, 2, 128),
         sp.FixedSparsityConfig(), True, torch.bfloat16),
        ("fixed b16 causal g4 d128 fp16", (1, 2048, 8, 2, 128),
         sp.FixedSparsityConfig(), True, torch.float16),
        ("fixed b32 non-causal g1 d64", (2, 1024, 4, 4, 64),
         sp.FixedSparsityConfig(block=32), False, torch.bfloat16),
        ("longformer b64 causal g4 d64", (1, 2048, 8, 2, 64),
         sp.BSLongformerSparsityConfig(block=64), True, torch.bfloat16),
        ("bigbird b64 non-causal g4 d128", (1, 2048, 8, 2, 128),
         sp.BigBirdSparsityConfig(block=64), False, torch.bfloat16),
        ("bigbird b128 causal g1 d128", (1, 2048, 4, 4, 128),
         sp.BigBirdSparsityConfig(block=128), True, torch.bfloat16),
        ("dense b128 non-causal g4 d64", (1, 1024, 8, 2, 64),
         sp.DenseSparsityConfig(block=128), False, torch.bfloat16),
        ("dense b16 causal g1 d64", (2, 1024, 4, 4, 64),
         sp.DenseSparsityConfig(block=16), True, torch.bfloat16),
        # the forward / dq's units: 8 q heads of 16 rows, 16 heads of 8
        # rows, and T 1040 (65 row blocks: a pad segment in the last unit)
        ("fixed b32 causal g8 d128", (1, 1024, 16, 2, 128),
         sp.FixedSparsityConfig(block=32), True, torch.bfloat16),
        ("bigbird b16 non-causal g16 d64", (1, 1024, 16, 1, 64),
         sp.BigBirdSparsityConfig(block=16), False, torch.bfloat16),
        ("longformer b16 causal g1 d128 T1040", (2, 1040, 2, 2, 128),
         sp.BSLongformerSparsityConfig(), True, torch.bfloat16),
        # a block that does not divide 128: dk/dv on sparse_dkv_kernel
        ("longformer b48 causal g4 d128", (1, 1536, 8, 2, 128),
         sp.BSLongformerSparsityConfig(block=48), True, torch.bfloat16),
        # the CUDA-core family: block 8, head dim 80, fp32
        ("fixed b8 causal g4 d64", (1, 1024, 8, 2, 64),
         sp.FixedSparsityConfig(block=8), True, torch.bfloat16),
        ("bigbird b8 non-causal g1 d64", (1, 1024, 4, 4, 64),
         sp.BigBirdSparsityConfig(block=8), False, torch.bfloat16),
        ("fixed b16 causal g4 d80", (1, 2048, 8, 2, 80),
         sp.FixedSparsityConfig(), True, torch.bfloat16),
        ("longformer b24 causal g4 d80", (1, 1536, 8, 2, 80),
         sp.BSLongformerSparsityConfig(block=24), True, torch.bfloat16),
        ("fixed b16 causal g4 d128 fp32", (1, 2048, 8, 2, 128),
         sp.FixedSparsityConfig(), True, torch.float32),
        ("bigbird b8 non-causal g4 d80 fp32", (1, 1024, 8, 2, 80),
         sp.BigBirdSparsityConfig(block=8), False, torch.float32),
    ]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for label, dims, cfg, causal, dtype in cases:
        q, k, v, do = (t.to(dtype) for t in _flash_inputs(torch, dev, *dims))
        _check_sparse(torch, sp, label, q, k, v, do, cfg, causal)
    # unread K/V blocks poisoned with NaN: the kernels must never load them
    cfg = EvenColumns(block=16)
    q, k, v, do = _flash_inputs(torch, dev, 1, 2048, 8, 2, 128)
    lay = cfg.make_layout(2048)
    o_ref, lse_ref = sp.torch_sparse_fwd(q, k, v, lay, 16)
    refs = sp.torch_sparse_bwd(q, k, v, o_ref, lse_ref, do, lay, 16)
    kp, vp = k.clone(), v.clone()
    dead = np.flatnonzero(~lay.any(0))
    for j in dead:
        kp[:, 16 * j:16 * (j + 1)] = float("nan")
        vp[:, 16 * j:16 * (j + 1)] = float("nan")
    o, _ = sp.cuda_sparse_fwd(q, kp, vp, lay, 16)
    dq = sp.cuda_sparse_dq(q, kp, vp, o_ref, lse_ref, do, lay, 16)
    dk, dv = sp.cuda_sparse_dkv(q, kp, vp, o_ref, lse_ref, do, lay, 16)
    print(f"  {dead.size} of {lay.shape[0]} K/V blocks unread and poisoned "
          f"with NaN", flush=True)
    for name, lab, got, want in zip(
            ("sparse_fwd", "sparse_dq", "sparse_dkv", "sparse_dkv"),
            ("o", "dq", "dk", "dv"), (o, dq, dk, dv), (o_ref,) + refs):
        _check_rows(torch, name, "NaN-poisoned dead blocks " + lab, got, want)
    # ... and at block 8 on the CUDA-core family: the odd 8-key blocks
    cfg = EvenColumns(block=8)
    lay = cfg.make_layout(1024)
    q, k, v, do = _flash_inputs(torch, dev, 1, 1024, 8, 2, 80)
    o_ref, lse_ref = sp.torch_sparse_fwd(q, k, v, lay, 8)
    refs = sp.torch_sparse_bwd(q, k, v, o_ref, lse_ref, do, lay, 8)
    kp, vp = k.clone(), v.clone()
    dead = np.flatnonzero(~lay.any(0))
    for j in dead:
        kp[:, 8 * j:8 * (j + 1)] = float("nan")
        vp[:, 8 * j:8 * (j + 1)] = float("nan")
    o, _ = sp.cuda_sparse_fwd(q, kp, vp, lay, 8)
    dq = sp.cuda_sparse_dq(q, kp, vp, o_ref, lse_ref, do, lay, 8)
    dk, dv = sp.cuda_sparse_dkv(q, kp, vp, o_ref, lse_ref, do, lay, 8)
    print(f"  block 8: {dead.size} of {lay.shape[0]} K/V blocks unread and "
          f"poisoned with NaN", flush=True)
    for name, lab, got, want in zip(
            ("sparse_fwd", "sparse_dq", "sparse_dkv", "sparse_dkv"),
            ("o", "dq", "dk", "dv"), (o, dq, dk, dv), (o_ref,) + refs):
        _check_rows(torch, name, "NaN-poisoned dead 8 x 8 blocks " + lab,
                    got, want)
    # one active entry dropped from the table must move some row
    cfg = sp.FixedSparsityConfig()
    q, k, v, _ = _flash_inputs(torch, dev, 1, 2048, 8, 2, 128)
    lay = cfg.make_layout(2048)
    want, _ = sp.torch_sparse_fwd(q, k, v, lay, 16)
    cut = lay.copy()
    nb = lay.shape[0]
    cut[nb - 1, np.flatnonzero(lay[nb - 1])[0]] = False
    got, _ = sp.cuda_sparse_fwd(q, k, v, cut, 16)
    r = _row_err(torch, got, want)
    print(f"  one table entry dropped (row block {nb - 1}) moves the worst "
          f"row by {r:.3e} of its max (check at {ROW_TOL})", flush=True)
    if not r > ROW_TOL:
        fail("the block-sparse check cannot see a dropped table entry")


# --------------------------------------------------------------- phase 17

def _by_group(fn, q, k, v, o=None, lse=None, do=None):
    """Run a plain version one KV group at a time (the masked-dense plain
    path holds [B, Nkv, g, T, T] fp32 per tensor: 8.6 GB at Llama-3-8B
    width and T 8192); one result per group."""
    g = q.shape[2] // k.shape[2]
    outs = []
    for j in range(k.shape[2]):
        h, kv = slice(j * g, (j + 1) * g), slice(j, j + 1)
        args = [q[:, :, h], k[:, :, kv], v[:, :, kv]]
        if o is not None:
            args += [o[:, :, h], lse[:, h], do[:, :, h]]
        outs.append(fn(*args))
    return outs


def _sparse_bounds(q, k, pairs):
    """Bytes (each input once, each output once) and operations (2*D flops
    per live (query, key) pair and product: forward 2 products, dq 3, dk/dv
    4) of the three kernels, live pairs counted from this layout; dq with
    its delta: q, do, o, k, v and lse read, dq and delta written."""
    B, T, N, D = q.shape
    e = q.element_size()
    nq, nk, rows = q.numel() * e, k.numel() * e, B * N * T * 4
    return {"sparse_fwd": _bound(nq + 2 * nk + nq + rows, 4 * D * pairs),
            "sparse_dq": _bound(3 * nq + 2 * nk + 2 * rows + nq,
                                6 * D * pairs),
            "sparse_dkv": _bound(2 * nq + 2 * nk + 2 * rows + 2 * nk,
                                 8 * D * pairs)}


def _time_sparse(torch, sp, q, k, v, do, cfg, causal, label):
    """Device times of the three kernels, the plain versions (run one KV
    group at a time) and SDPA with the expanded boolean mask (K/V heads
    expanded beforehand; forward, and its autograd backward for dq + dk/dv),
    beside each kernel's bound."""
    import torch.nn.functional as F
    B, T, N, D = q.shape
    lay = cfg.make_layout(T)
    mask = sp._visible(lay, cfg.block, causal, q.device)
    pairs = int(mask.sum().item()) * B * N
    bounds = _sparse_bounds(q, k, pairs)
    o, lse = sp.cuda_sparse_fwd(q, k, v, lay, cfg.block, causal)
    dos, lse_c, delta = sp._bwd_inputs("time", q, o, lse, do)
    made = torch.empty_like(delta)
    ms = {"sparse_fwd": cuda_ms(lambda: sp.cuda_sparse_fwd(
              q, k, v, lay, cfg.block, causal)),
          # dq with the delta it makes for dk/dv (the main path's call)
          "sparse_dq": cuda_ms(lambda: sp.cuda_sparse_dq(
              q, k, v, o, lse_c, dos, lay, cfg.block, causal,
              delta_out=made)),
          "sparse_dkv": cuda_ms(lambda: sp.cuda_sparse_dkv(
              q, k, v, o, lse_c, dos, lay, cfg.block, causal, delta=delta))}
    plain_fwd = cuda_ms(lambda: _by_group(
        lambda *a: sp.torch_sparse_fwd(*a, lay, cfg.block, causal),
        q, k, v), reps=3, warmup=1)
    plain_bwd = cuda_ms(lambda: _by_group(
        lambda *a: sp.torch_sparse_bwd(*a, lay, cfg.block, causal),
        q, k, v, o, lse, do), reps=3, warmup=1)
    rep = N // k.shape[2]
    qs = q.transpose(1, 2).detach().requires_grad_()
    ks_, vs = (t.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
               .requires_grad_() for t in (k, v))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs.detach(), ks_.detach(), vs.detach(), attn_mask=mask))
    out = F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask)
    dout = do.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        out, (qs, ks_, vs), dout, retain_graph=True), reps=5)
    del out
    ratio = sp.sparsity_ratio(cfg, T, causal)
    shape = (f"q[{B},{T},{N},{D}] kv heads {k.shape[2]} {q.dtype} "
             f"{type(cfg).__name__}(block={cfg.block}) causal={causal}, "
             f"{pairs // (B * N)} live pairs a head, sparsity_ratio "
             f"{ratio:.4f}")
    res = {"sparse_dkv_merge": _time_sparse_merge(torch, sp, q, k, lay,
                                                  cfg.block, causal)}
    res.update(_time_sparse_q_merges(torch, sp, q, k, lay, cfg.block, causal))
    for name in SPARSE[:3]:
        res[name] = dict(
            shape=shape, ms=ms[name],
            plain_ms=plain_fwd if name == "sparse_fwd" else plain_bwd,
            library_ms=lib_fwd if name == "sparse_fwd" else lib_bwd,
            bound_ms=bounds[name][0], bound_by=bounds[name][1])
    print(f"  [{label}] {shape}: fwd {ms['sparse_fwd']:.4f} ms (bound "
          f"{bounds['sparse_fwd'][0]:.4f} {bounds['sparse_fwd'][1]}), dq "
          f"{ms['sparse_dq']:.4f} ms (bound {bounds['sparse_dq'][0]:.4f}), "
          f"dk/dv {ms['sparse_dkv']:.4f} ms (bound "
          f"{bounds['sparse_dkv'][0]:.4f}); plain fwd {plain_fwd:.3f} ms, "
          f"plain bwd (dq+dk+dv) {plain_bwd:.3f} ms; SDPA + mask fwd "
          f"{lib_fwd:.4f} ms, bwd (dq+dk+dv) {lib_bwd:.4f} ms", flush=True)
    return res


def _time_sparse_merge(torch, sp, q, k, lay, block, causal):
    """The split walks' second pass on a seeded partial of the call's
    plan's shape [parts, 2, 128, D]: held bitwise to its plain version
    (the chunks added in order, rounded once) and timed beside its bound
    (the partials read once, the merged rows written once); no single
    PyTorch call sums a varying number of chunks into gathered rows."""
    B, T, N, D = q.shape
    group = N // k.shape[2]
    plan = sp._call_plan(lay, block, causal, group, k)[0]
    if not plan["parts"]:
        return {}
    part = torch.randn((plan["parts"], 2, 128, D), device=q.device,
                       generator=torch.Generator(device=q.device).manual_seed(
                           plan["parts"]))
    dk, dv = torch.zeros_like(k), torch.zeros_like(k)
    got = sp.cuda_sparse_dkv_merge(part, dk.clone(), dv.clone(), lay, block,
                                   causal, group)
    want = sp.torch_sparse_dkv_merge(part, dk, dv, lay, block, causal,
                                     group)
    label = f"{len(plan['merges'])} merges of {plan['parts']} parts"
    for lab, g_, w_ in zip(("dk", "dv"), got, want):
        _check_rows(torch, "sparse_dkv_merge", f"{label} {lab}", g_, w_,
                    F32_TOL)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"  the merge equals its plain version bitwise: {same}",
          flush=True)
    if not same:
        fail("sparse_dkv_merge: the chunks are not added in the plain "
             "version's order")
    rows = sum(int((plan["cols"][g] >= 0).sum()) * block
               for g in plan["merges"][:, 0])
    adds = sum(int(n - 1) * int((plan["cols"][g] >= 0).sum()) * block
               for g, _, _, n in plan["merges"].tolist())
    bound = _bound(part.numel() * 4 + 2 * rows * D * q.element_size(),
                   2 * adds * D)
    ms = cuda_ms(lambda: sp.cuda_sparse_dkv_merge(part, dk, dv, lay, block,
                                                  causal, group))
    plain = cuda_ms(lambda: sp.torch_sparse_dkv_merge(
        part, dk, dv, lay, block, causal, group), reps=3, warmup=1)
    print(f"  sparse_dkv_merge [{label}]: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    return dict(shape=f"part[{plan['parts']},2,128,{D}] float32, {label}",
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound[0],
                bound_by=bound[1])


def _time_sparse_q_merges(torch, sp, q, k, lay, block, causal):
    """The forward's and dq's second passes on seeded partials of the
    shapes of the call's forward and dq plans, where the plan splits a
    walk (ml: m in log2 units, some -inf, l in (0, 64]): the forward
    combine held per row to its plain version, the dq merge bitwise (the
    chunks added in order, rounded once); each timed beside its bound (the
    partials read once, the merged rows written once); no single PyTorch
    call merges a varying number of chunks into gathered rows.  The
    combine's o is 16-bit, so it is held at ROW_TOL (a rounding tie may
    flip one ulp), its lse at F32_TOL."""
    B, T, N, D = q.shape
    nkv = k.shape[2]
    group = N // nkv
    e = q.element_size()
    out = {}
    for name, dq in (("sparse_fwd_combine", False), ("sparse_dq_merge", True)):
        plan = sp._call_q_plan(lay, block, causal, q, nkv, dq=dq)[0]
        if not plan["parts"]:
            continue
        gen = torch.Generator(device=q.device).manual_seed(plan["parts"])
        part = torch.randn((plan["parts"], 128, D), device=q.device,
                           generator=gen)
        label = f"{len(plan['merges'])} merges of {plan['parts']} parts"
        rows = sum(len(r[5]) for r in sp._merged_rows(plan, nkv, group))
        chunks = int(plan["merges"][:, 3].mean())
        base = torch.zeros_like(q)
        if not dq:
            ml = torch.stack([
                torch.randn((plan["parts"], 128), device=q.device,
                            generator=gen) * 8,
                64 * torch.rand((plan["parts"], 128), device=q.device,
                                generator=gen) + 1e-3], 1)
            ml[:, 0, ::17] = float("-inf")
            ml[:, 1, ::17] = 0.0
            lse = torch.zeros((B, N, 1, T), device=q.device)
            args = (part, ml, base, lse, lay, block, causal, group)
            got = sp.cuda_sparse_fwd_combine(part, ml, base.clone(),
                                             lse.clone(), *args[4:])
            want = sp.torch_sparse_fwd_combine(*args)
            _check_rows(torch, name, f"{label} o", got[0], want[0])
            lerr = (got[1] - want[1]).abs().max().item()
            print(f"  {name}[{label} lse] max|kernel-plain| = {lerr:.3e}",
                  flush=True)
            if not lerr <= F32_TOL:
                fail(f"{name}: lse differs by {lerr}")
            bound = _bound(part.numel() * 4 + ml.numel() * 4
                           + rows * (D * e + 4), 3 * rows * D * chunks)
            kernel, plain = sp.cuda_sparse_fwd_combine, \
                sp.torch_sparse_fwd_combine
        else:
            args = (part, base, lay, block, causal, group)
            got = sp.cuda_sparse_dq_merge(part, base.clone(), *args[2:])
            want = sp.torch_sparse_dq_merge(*args)
            _check_rows(torch, name, f"{label} dq", got, want, F32_TOL)
            same = torch.equal(got, want)
            print(f"  the dq merge equals its plain version bitwise: {same}",
                  flush=True)
            if not same:
                fail(f"{name}: the chunks are not added in the plain "
                     f"version's order")
            bound = _bound(part.numel() * 4 + rows * D * e,
                           rows * D * (chunks - 1))
            kernel, plain = sp.cuda_sparse_dq_merge, sp.torch_sparse_dq_merge
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
        print(f"  {name} [{label}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
        out[name] = dict(
            shape=f"part[{plan['parts']},128,{D}] float32, {label}", ms=ms,
            plain_ms=plain_ms, library_ms=None, bound_ms=bound[0],
            bound_by=bound[1])
    return out


def _sparse_q_faults(torch, sp, kind, q, k, v, o, lse, do, lay, block,
                     causal):
    """The forward's (``kind`` "fwd") or dq's row checks must see, in the
    plain version of one unit's task of its own plan
    (``torch_sparse_q_task`` on the kernels' o and lse): where the plan
    splits a walk, one chunk left out of its merge; else, at the unit with
    the longest walk of the first kv head, a key block dropped from a
    stage, a dead sub-tile let through (a live bit set where the plan has
    none: a real block a segment does not read, else a stage's padding),
    a skipped ring stage and (dq) the neighbouring head's delta.  Each
    fault's size is printed."""
    import copy
    plan = sp._call_q_plan(lay, block, causal, q, k.shape[2],
                           dq=kind == "dq")[0]
    ust = plan["ust"]

    def part(pl, task, delta=None):
        """the task's fp32 partial: fwd (acc, ml), dq its rows"""
        return sp.torch_sparse_q_task(kind, q, k, v, pl, task, o=o, lse=lse,
                                      do=do, delta=delta)

    def merge(parts):
        """the rows of a walk's chunks: o = acc / l (weights 2^(m - max m)),
        or dq summed"""
        if kind == "dq":
            return sum(parts)
        top = torch.stack([m[0] for _, m in parts]).amax(0)
        w = [torch.where(m[0] == float("-inf"), 0.0, torch.exp2(m[0] - top))
             for _, m in parts]
        tot = sum(m[1] * wc for (_, m), wc in zip(parts, w))
        acc = sum(a * wc[:, None] for (a, _), wc in zip(parts, w))
        return acc / torch.where(tot == 0, 1.0, tot)[:, None]

    def check(what, got, want):
        r = _rows_off(got, want)[0]
        print(f"  {what} moves the worst {'o' if kind == 'fwd' else kind} row "
              f"by {r:.3e} of its max (check at {ROW_TOL})", flush=True)
        if not r > ROW_TOL:
            fail(f"the sparse {kind} check cannot see {what}")

    if plan["parts"]:
        g, u, _, n = plan["merges"][0].tolist()
        tasks = sorted(t for t in plan["tasks"].tolist() if t[:2] == [g, u])
        parts = [part(plan, t) for t in tasks]
        check(f"chunk {n // 2} of {n} of pattern {g}'s split walk left out "
              f"of its merge", merge(parts[:n // 2] + parts[n // 2 + 1:]),
              merge(parts))
        return
    g, u = int(np.argmax(ust[:, 1])), 0
    first, count = (int(x) for x in ust[g])

    def walk(pl, delta=None):
        return merge([part(pl, (g, u, 0, count), delta)])

    want = walk(plan)
    mid = first + count // 2
    bits = int(np.bitwise_or.reduce(plan["live"][mid])) & ((1 << plan["C"]) - 1)
    c = (bits & -bits).bit_length() - 1     # the stage's first live block
    cut = copy.deepcopy(plan)
    cut["live"][mid] &= ~(1 << c)
    check(f"key block {plan['kst'][mid, c]} dropped from stage {mid}",
          walk(cut), want)
    dead = None   # a real block one real segment does not read, else a pad
    for st in range(first, first + count):
        real = len(set(plan["kst"][st].tolist()))  # padding repeats block 0
        for r in range(plan["R"]):
            for cc in range(plan["C"]):
                if plan["rows"][g, r, 0] >= 0 \
                        and not plan["live"][st, r] >> cc & 1 \
                        and (dead is None or (dead[3] and cc < real)):
                    dead = (st, r, cc, cc >= real)
    if dead is None:
        print(f"  (no dead sub-tile in pattern {g}'s walk: every segment "
              f"reads every block, no stage padded)", flush=True)
    else:
        extra = copy.deepcopy(plan)
        extra["live"][dead[0], dead[1]] |= 1 << dead[2]
        check(f"{'padded' if dead[3] else 'dead'} sub-tile (stage {dead[0]},"
              f" segment {dead[1]}, key block "
              f"{plan['kst'][dead[0], dead[2]]}) let through", walk(extra),
              want)
    skip = copy.deepcopy(plan)
    skip["live"][mid] = 0
    check(f"ring stage {mid} of pattern {g}'s walk skipped", walk(skip),
          want)
    if kind == "dq":
        delta = (o.float() * do.float()).sum(-1).permute(0, 2, 1)
        check("the neighbouring head's delta",
              walk(plan, delta.roll(-1, dims=1).contiguous()), want)


def _sparse_dkv_faults(torch, sp, q, k, v, o, lse, do, lay, block, causal):
    """The dk/dv row checks must see, in the plain backward on the
    kernels' o and lse (one kv head, the first whose walk is split): a
    column dropped from a group, a dead sub-tile of a group's walk let
    through (at the column with the fewest live row blocks, below the
    diagonal), one chunk of a split walk left out of its merge and one
    skipped ring stage (one q head's 64 queries of one stage of that walk).
    Each fault's size is printed."""
    B, T, N, D = q.shape
    Nkv = k.shape[2]
    g = N // Nkv
    plan = sp._call_plan(lay, block, causal, g, k)[0]
    if not plan["parts"]:
        fail("the sparse fault checks need a split walk")
    gi, u, _, nch = plan["merges"][0].tolist()
    b, hk = divmod(u, Nkv)
    hs = slice(hk * g, (hk + 1) * g)
    one = (q[b:b + 1, :, hs], k[b:b + 1, :, hk:hk + 1],
           v[b:b + 1, :, hk:hk + 1], o[b:b + 1, :, hs])
    l1, do1 = lse[b:b + 1, hs], do[b:b + 1, :, hs]
    want = sp.torch_sparse_bwd(*one, l1, do1, lay, block, causal)[1:]

    def check(what, got):
        r = max(_rows_off(x, w)[0] for x, w in zip(got, want))
        print(f"  {what} moves the worst dk/dv row by {r:.3e} of its max "
              f"(check at {ROW_TOL})", flush=True)
        if not r > ROW_TOL:
            fail(f"the sparse_dkv check cannot see {what}")

    cols = plan["cols"][gi]
    cut = lay.copy()
    cut[:, cols[1]] = False
    check(f"column {cols[1]} dropped from group {gi}",
          sp.torch_sparse_bwd(*one, l1, do1, cut, block, causal)[1:])
    # a dead sub-tile below the diagonal, at the column read least
    live = lay & np.tril(np.ones(lay.shape, bool)) if causal else lay
    st0 = plan["gst"][:, 0]
    best = None
    for gj, (first, count) in enumerate(plan["gst"].tolist()):
        for st in range(first, first + count):
            for r in range(plan["R"]):
                rb = int(plan["seg"][st, r]) // block
                for c, col in enumerate(plan["cols"][gj].tolist()):
                    if col >= 0 and rb > col and not live[rb, col] and (
                            best is None or live[:, col].sum() < best[0]):
                        best = (int(live[:, col].sum()), rb, col)
    if best is None:
        fail("no dead sub-tile below the diagonal in any group's walk")
    extra = lay.copy()
    extra[best[1], best[2]] = True
    check(f"dead sub-tile (row block {best[1]}, column {best[2]}) let "
          f"through", sp.torch_sparse_bwd(*one, l1, do1, extra, block,
                                          causal)[1:])
    ns, seg_len = plan["gst"][gi, 1], plan["seg_len"]
    tasks = sorted(t for t in plan["tasks"].tolist() if t[:2] == [gi, u])

    def without(items):
        """the plain dk, dv with the walk's ``items`` (q head, stage) left
        out: those rows dead for this group's columns only"""
        dead = l1.clone()
        for i in items:
            st = int(st0[gi]) + i % ns
            for start in plan["seg"][st].tolist():
                dead[0, i // ns, :, start:start + seg_len] = -1e30
        got = sp.torch_sparse_bwd(*one, dead, do1, lay, block, causal)[1:]
        out = [w.clone() for w in want]
        for col in cols.tolist():
            if col >= 0:
                keys = slice(col * block, (col + 1) * block)
                for x, y in zip(out, got):
                    x[:, keys] = y[:, keys]
        return out

    mid = tasks[nch // 2]
    check(f"chunk {nch // 2} of {nch} (items {mid[2]}..{mid[3] - 1}) of "
          f"group {gi}'s walk left out of its merge",
          without(range(mid[2], mid[3])))
    check(f"one ring stage of group {gi}'s walk skipped (item {mid[2]})",
          without([mid[2]]))


def phase_sparse_main(torch, sp, dev):
    """The block-sparse path at full Llama-3-8B attention width and its
    published context (B 1, T 8192, 32 q heads over 8 kv heads, head_dim
    128, bf16): ``ops.sparse_attention`` forward and ``backward`` through
    autograd, with the reference's default Fixed pattern (causal), with
    BigBird block 64 and with BSLongformer's defaults (both non-causal).  Each kernel launches exactly
    once a call; o is held to the plain forward, and dq, dk, dv to the
    plain backward on the o and lse the backward kernels were given (the
    forward kernel's, recomputed: the kernel is deterministic), the plain
    versions run one KV group at a time.  An end-to-end comparison would
    fold the bf16 rounding of o into delta = rowsum(o·do), which moves the
    first rows' dq (a near-cancelling sum over one or two keys) by ~0.1 of
    their largest value in the plain path itself against fp32.  Two runs
    of each kernel bitwise equal; the forward / dq fault checks on every
    call, the dk/dv ones on the Fixed call; the kernels timed on every call
    (the Fixed call's numbers returned, and a later call's for a merge the
    Fixed call does not run)."""
    from deepspeed_tpu_torch import ops
    calls = [("Fixed (defaults), causal", sp.FixedSparsityConfig(), True),
             ("BigBird block 64, non-causal", sp.BigBirdSparsityConfig(
                 block=64), False),
             # global row block 0 reads every column block: the forward's
             # 128-key walks split here (and not at the two calls above)
             ("BSLongformer (defaults), non-causal",
              sp.BSLongformerSparsityConfig(), False)]
    B, T, N, Nkv, D = LLAMA_ATTN
    total = dict.fromkeys(SPARSE, 0)
    results = {}
    for i, (label, cfg, causal) in enumerate(calls):
        q, k, v, g = _flash_inputs(torch, dev, B, T, N, Nkv, D, seed=17 + i)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        counters = (sp.cuda_sparse_fwd, sp.cuda_sparse_dq, sp.cuda_sparse_dkv,
                    sp.cuda_sparse_dkv_merge, sp.cuda_sparse_fwd_combine,
                    sp.cuda_sparse_dq_merge)
        for c in counters:
            c.launches = 0
        plan = sp._call_plan(cfg.make_layout(T), cfg.block, causal, N // Nkv,
                             torch.empty((B, T, Nkv, D), device=dev))[0]
        merges = int(plan["parts"] > 0)
        fmerges, dmerges = (int(sp._call_q_plan(
            cfg.make_layout(T), cfg.block, causal, q, Nkv, dq=dq)[0]["parts"]
            > 0) for dq in (False, True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = ops.sparse_attention(qg, kg, vg, cfg, causal=causal)
        o.backward(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [c.launches for c in counters]
        print(f"  [{label}] forward + backward {wall * 1e3:.1f} ms wall "
              f"(first call includes the table build), launches "
              f"{dict(zip(SPARSE, counts))}", flush=True)
        if counts != [1, 1, 1, merges, fmerges, dmerges]:
            fail(f"sparse main path [{label}]: launches {counts}, want "
                 f"1 each (the merges where a plan splits: dk/dv {merges}, "
                 f"forward {fmerges}, dq {dmerges})")
        for n, c in zip(SPARSE, counts):
            total[n] += c
        lay = cfg.make_layout(T)
        fwd = _by_group(lambda *a: sp.torch_sparse_fwd(
            *a, lay, cfg.block, causal), q, k, v)
        o_ref = torch.cat([f[0] for f in fwd], dim=2)
        lse_ref = torch.cat([f[1] for f in fwd], dim=1)
        del fwd
        _check_rows(torch, "sparse_fwd", f"{label} o", o.detach(), o_ref)
        o_k, lse_k = sp.cuda_sparse_fwd(q, k, v, lay, cfg.block, causal)
        o_2, lse_2 = sp.cuda_sparse_fwd(q, k, v, lay, cfg.block, causal)
        if not (torch.equal(o_k, o.detach()) and torch.equal(o_k, o_2)
                and torch.equal(lse_k, lse_2)):
            fail(f"sparse_fwd [{label}]: a second launch differs")
        del o_2, lse_2
        lerr = (lse_k - lse_ref).abs().max().item()
        print(f"  sparse_fwd[{label} lse] max|kernel-plain| = {lerr:.3e}",
              flush=True)
        if not lerr <= ROW_TOL:
            fail(f"sparse_fwd {label}: lse differs by {lerr}")
        bwd = _by_group(lambda *a: sp.torch_sparse_bwd(
            *a, lay, cfg.block, causal), q, k, v, o_k, lse_k, g)
        refs = [torch.cat([b_[j] for b_ in bwd], dim=2) for j in range(3)]
        del bwd
        for name, lab, got, want in zip(
                ("sparse_dq", "sparse_dkv", "sparse_dkv"), ("dq", "dk", "dv"),
                (qg.grad, kg.grad, vg.grad), refs):
            _check_rows(torch, name, f"{label} {lab}", got, want)
        dos, lse_c, delta = sp._bwd_inputs("check", q, o_k, lse_k, g)
        made = [torch.empty_like(delta) for _ in range(2)]
        dqs = [sp.cuda_sparse_dq(q, k, v, o_k, lse_c, dos, lay, cfg.block,
                                 causal, delta_out=d) for d in made]
        derr = ((made[0] - delta).abs().max() / delta.abs().max()).item()
        print(f"  sparse_dq[{label} delta] max|kernel-eager| = {derr:.3e} of "
              f"the largest", flush=True)
        if not derr <= F32_TOL:
            fail(f"sparse_dq [{label}]: the delta it made differs by {derr}")
        runs = [sp.cuda_sparse_dkv(q, k, v, o_k, lse_c, dos, lay, cfg.block,
                                   causal, delta=delta) for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        same_q = torch.equal(*dqs) and torch.equal(*made)
        print(f"  [{label}] two runs bitwise equal: o, lse True; dq, delta "
              f"{same_q}; dk, dv {same}", flush=True)
        if not (same and same_q):
            fail(f"sparse dq / dkv [{label}] is not deterministic")
        del runs, dos, lse_c, delta, made, dqs
        for kind in ("fwd", "dq"):
            _sparse_q_faults(torch, sp, kind, q, k, v, o_k, lse_k, g, lay,
                             cfg.block, causal)
        if i == 0:
            _sparse_dkv_faults(torch, sp, q, k, v, o_k, lse_k, g, lay,
                               cfg.block, causal)
        # the Fixed call's numbers; a merge its plans do not split, from
        # the first later call whose plan splits it
        timed = _time_sparse(torch, sp, q, k, v, g, cfg, causal, label)
        for name, r in timed.items():
            if r and (i == 0 or not results.get(name)):
                results[name] = r
        del q, k, v, g, qg, kg, vg, o, o_ref, lse_ref, o_k, lse_k, refs
        gc.collect()
        torch.cuda.empty_cache()
    return total, results


# --------------------------------------------------------------- phase 18

def _evo_inputs(torch, dev, B, N, S, H, D, seed=0, masked_keys=24,
                bias=("b1", "b2"), dtype=None):
    """q, k, v [B, N, S, H, D] bf16 (or ``dtype``), bias1 [B, N, 1, 1, S]
    fp32 — the MSA mask: -1e9 on the last ``masked_keys`` keys of a seeded
    half of the rows — and bias2 [B, 1, H, S, S] in q's dtype, from a
    seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(
            dtype or torch.bfloat16)
    q, k, v = (rand(B, N, S, H, D) for _ in range(3))
    b1 = torch.zeros((B, N, 1, 1, S), device=dev)
    rows = np.random.default_rng(seed).permutation(N)[:N // 2]
    b1[:, torch.from_numpy(rows).to(dev), ..., S - masked_keys:] = -1e9
    b2 = rand(B, 1, H, S, S)
    return (q, k, v, b1 if "b1" in bias else None,
            b2 if "b2" in bias else None)


def _check_evo(torch, evo, label, q, k, v, b1, b2):
    tol = F32_TOL if q.dtype == torch.float32 else ROW_TOL
    o, lse = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
    o_ref, lse_ref = evo.torch_evoformer_fwd(q, k, v, b1, b2)
    _check_rows(torch, "evoformer_fwd", label + " o", o, o_ref, tol)
    lerr = (lse - lse_ref).abs().max().item()
    print(f"  evoformer_fwd[{label} lse] max|kernel-plain| = {lerr:.3e}",
          flush=True)
    if not lerr <= tol:
        fail(f"evoformer_fwd {label}: lse differs by {lerr}")
    return o_ref, lse_ref


GRADS = (("evoformer_dq", "dq"), ("evoformer_dkv", "dk"),
         ("evoformer_dkv", "dv"), ("evoformer_db1", "dbias1"),
         ("evoformer_db2", "dbias2"))


def _check_evo_bwd(torch, evo, label, got, want):
    """(dq, dk, dv, db1, db2) of the kernels against the plain backward's,
    per row (a dbias1 row: the S keys of one MSA row; a dbias2 row: the
    keys of one (head, query))."""
    for (name, lab), g, w in zip(GRADS, got, want):
        if (g is None) != (w is None):
            fail(f"{name} {label}: {lab} computed by one side only")
        if w is not None:
            _check_rows(torch, name, f"{label} {lab}", g, w,
                        F32_TOL if w.dtype == torch.float32
                        and got[0].dtype == torch.float32 else ROW_TOL)


def _evo_by_rows(torch, evo, q, k, v, b1, b2, chunk=128):
    """The plain forward over chunks of the N rows (its fp32 logits are
    [B, N, H, S, S]: 2.4 GB at the MSA shape)."""
    N = q.shape[1]
    outs = [evo.torch_evoformer_fwd(
        q[:, n:n + chunk], k[:, n:n + chunk], v[:, n:n + chunk],
        None if b1 is None else b1[:, n:n + chunk], b2)[0]
        for n in range(0, N, chunk)]
    return torch.cat(outs, dim=1)


def _evo_bwd_by_rows(torch, evo, q, k, v, b1, b2, o, lse, do, chunk=128):
    """The plain backward over chunks of the N rows: dq, dk, dv and dbias1
    row by row, dbias2 summed over the chunks in order."""
    B, N, S, H, D = q.shape
    b1 = None if b1 is None else torch.broadcast_to(b1, (B, N, 1, 1, S))
    lse = lse.view(B, N, H, 1, S)
    parts = []
    for n in range(0, N, chunk):
        c = slice(n, n + chunk)
        parts.append(evo.torch_evoformer_bwd(
            q[:, c], k[:, c], v[:, c], None if b1 is None else b1[:, c], b2,
            o[:, c], lse[:, c].reshape(-1, H, 1, S), do[:, c]))
    out = [torch.cat([p[j] for p in parts], dim=1) for j in range(3)]
    out.append(None if b1 is None else torch.cat([p[3] for p in parts], 1))
    db2 = None
    for p in parts:
        if p[4] is not None:
            db2 = p[4] if db2 is None else db2 + p[4]
    return out + [db2]


def _evo_plain_grads(torch, evo, q, k, v, b1, b2, do):
    """The op's gradients through the plain backward: the op's padded
    problem where S needs one (``_padded``, as ``evoformer_attention``
    builds it), the forward kernel's o and lse on it (what the backward
    kernels were given: the kernel is deterministic), the plain backward
    by chunks of rows, and autograd through the padding and the biases'
    broadcast → (the inputs' gradients, the raw fp32 gradients of the
    padded problem)."""
    import torch.nn.functional as F
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in (q, k, v, b1, b2)]
    S0 = q.shape[2]
    args = (leaves if evo._tiles(q, k, v) else evo._padded(*leaves))
    flat = [None if t is None else t.detach() for t in args]
    o, lse = evo.cuda_evoformer_fwd(*flat)
    pad = flat[0].shape[2] - S0
    dop = F.pad(do, (0, 0, 0, 0, 0, pad)).contiguous()
    raw = _evo_bwd_by_rows(torch, evo, *flat, o, lse, dop)
    grads = raw[:3] + list(evo._bias_grads(raw[3], raw[4], flat[3], flat[4]))
    pairs = [(t, g) for t, g in zip(args, grads) if t is not None]
    torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
    return [None if t is None else t.grad for t in leaves], raw, o[:, :, :S0]


def _time_evo(torch, evo, q, k, v, b1, b2):
    """Kernel (and, for the biases' share, the kernel without them), plain
    and SDPA (additive float mask bias1 + bias2 broadcast to [B·N, H, S,
    S], q/k/v permuted to [B·N, H, S, D]) device times,
    beside the bound: q, k, v, o, both biases (as stored) and lse once;
    4·D flops per (query, key) pair of every head and row."""
    import torch.nn.functional as F
    B, N, S, H, D = q.shape
    e = q.element_size()
    nbytes = (4 * q.numel() * e + b1.numel() * b1.element_size()
              + b2.numel() * b2.element_size() + B * N * H * S * 4)
    bound_ms, bound_by = _bound(nbytes, 4 * D * S * S * H * B * N)
    ms = cuda_ms(lambda: evo.cuda_evoformer_fwd(q, k, v, b1, b2))
    no_bias_ms = cuda_ms(lambda: evo.cuda_evoformer_fwd(q, k, v))
    plain_ms = cuda_ms(lambda: evo.torch_evoformer_fwd(q, k, v, b1, b2),
                       reps=3, warmup=1)
    qs, ks_, vs = (t.permute(0, 1, 3, 2, 4).reshape(B * N, H, S, D)
                   .contiguous() for t in (q, k, v))
    mask = (b1.float() + b2.float()).to(q.dtype).expand(
        B, N, H, S, S).reshape(B * N, H, S, S).contiguous()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks_, vs, attn_mask=mask))
    del mask
    print(f"  the same call without biases: kernel {no_bias_ms:.4f} ms",
          flush=True)
    return dict(shape=f"q[{B},{N},{S},{H},{D}] {q.dtype}, bias1 "
                      f"{list(b1.shape)} {b1.dtype}, bias2 {list(b2.shape)} "
                      f"{b2.dtype}",
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _evo_bwd_bounds(q, b1, b2, chunks):
    """Bytes (q, k, v, do and lse, delta read once, each output written
    once, the biases as stored; dq also reads o and writes the delta it
    makes) and operations (2·D flops per (query, key) pair and product: dq
    3 products, dk/dv 4, dbias2 2) of the backward kernels; dbias2's second
    pass reads the ``chunks`` fp32 partials and
    writes dbias2 (``chunks`` - 1 adds an element); dbias1's kernel adds the
    per-head column sums (written by dk/dv) over the heads."""
    B, N, S, H, D = q.shape
    nq = q.numel() * q.element_size()
    rows = B * N * H * S * 4
    bias = sum(b.numel() * b.element_size() for b in (b1, b2)
               if b is not None)
    pairs = B * N * H * S * S
    db2 = B * H * S * S
    return {"evoformer_dq": _bound(6 * nq + 2 * rows + bias, 6 * D * pairs),
            "evoformer_dkv": _bound(6 * nq + 3 * rows + bias,
                                    8 * D * pairs),
            "evoformer_db2": _bound(4 * nq + 2 * rows + bias + db2 * 4,
                                    4 * D * pairs),
            "evoformer_db2_sum": _bound((chunks + 1) * db2 * 4,
                                        (chunks - 1) * db2),
            "evoformer_db1": _bound(rows + B * N * S * 4, B * N * H * S)}


def _time_evo_bwd(torch, evo, q, k, v, b1, b2, do, full=True):
    """The backward kernels' device times on the call's own inputs (the
    forward kernel's o and lse, delta computed once), beside their bounds:
    dbias2 with its second pass (one call of the wrapper), and the second
    pass alone on a seeded partial of the call's shape [chunks, B, H, S,
    S], held to its plain version (the chunks added in order) and timed
    beside ``part.sum(0)``; with ``full`` also the plain backward and one
    SDPA backward (q/k/v permuted to [B·N, H, S, D], the materialised mask
    bias1 + bias2 requiring grad; the forward taken once, its backward
    timed, as rows 4-5 and 11-12)."""
    import torch.nn.functional as F
    B, N, S, H, D = q.shape
    o, lse = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
    b1v, b2v = evo._bias_views(q, b1, b2)
    args = (q, k, v, b1v, b2v, lse, evo._delta(o, do), do)
    part = evo._bwd_kernel("dkv", *args, part=True)[2]
    chunks = evo._bwd_plan(q, b2v)["db2"]["chunks"]
    partial = torch.randn((chunks, B, H, S, S), device=q.device,
                          generator=torch.Generator(
                              device=q.device).manual_seed(S + chunks))
    dq_args = (q, k, v, b1v, b2v, lse, None, do)
    ms = {"evoformer_dq": cuda_ms(lambda: evo._bwd_kernel("dq", *dq_args,
                                                          o=o)),
          "evoformer_dkv": cuda_ms(lambda: evo._bwd_kernel(
              "dkv", *args, part=True)),
          "evoformer_db2": cuda_ms(lambda: evo._bwd_kernel("db2", *args)),
          "evoformer_db2_sum": cuda_ms(
              lambda: evo.cuda_evoformer_db2_sum(partial)),
          "evoformer_db1": cuda_ms(lambda: evo._bwd_kernel(
              "db1", *args, part=part))}
    got = evo.cuda_evoformer_db2_sum(partial)
    want = evo.torch_evoformer_db2_sum(partial)
    shape = (f"q[{B},{N},{S},{H},{D}] {q.dtype}, bias1 {list(b1.shape)} "
             f"{b1.dtype}, bias2 {list(b2.shape)} {b2.dtype}")
    _check_rows(torch, "evoformer_db2_sum", f"{chunks} chunks, " + shape,
                got, want, F32_TOL)
    same = torch.equal(got, want)
    print(f"  the second pass equals its plain version bitwise: {same}",
          flush=True)
    if not same:
        fail(f"evoformer_db2_sum [{chunks} chunks, {shape}]: the chunks are "
             f"not added in the plain version's order")
    sum_plain = cuda_ms(lambda: evo.torch_evoformer_db2_sum(partial), reps=5)
    sum_lib = cuda_ms(lambda: partial.sum(0))
    # delta = rowsum(o * do) made eagerly (fp32), no longer on the path:
    # what a dq that does not make delta needs beside it
    delta_ms = cuda_ms(lambda: evo._delta(o, do))
    kernels_ms = cuda_ms(lambda: evo.cuda_evoformer_bwd(q, k, v, b1, b2, o,
                                                        lse, do))
    bounds = _evo_bwd_bounds(q, b1, b2, chunks)
    print("  backward kernels on " + shape + ": " + ", ".join(
        f"{n} {ms[n]:.4f} ms (bound {bounds[n][0]:.4f} {bounds[n][1]})"
        for n in EVO_BWD) + f"; sum {sum(ms.values()) - ms['evoformer_db2_sum']:.4f} ms"
        f" (evoformer_dq makes delta; evoformer_db2 includes its second "
        f"pass, {chunks} chunks; second pass alone: plain {sum_plain:.4f}, "
        f"part.sum(0) {sum_lib:.4f} ms); cuda_evoformer_bwd whole "
        f"{kernels_ms:.4f} ms; the eager delta (off the path) "
        f"{delta_ms:.4f} ms", flush=True)
    plain_ms = lib_ms = None
    if full:
        plain_ms = cuda_ms(lambda: evo.torch_evoformer_bwd(
            q, k, v, b1, b2, o, lse, do), reps=3, warmup=1)
        qs, ks_, vs = (t.permute(0, 1, 3, 2, 4).reshape(B * N, H, S, D)
                       .contiguous().requires_grad_() for t in (q, k, v))
        mask = (b1.float() + b2.float()).to(q.dtype).expand(
            B, N, H, S, S).reshape(B * N, H, S, S).contiguous()
        mask.requires_grad_()
        dout = do.permute(0, 1, 3, 2, 4).reshape(B * N, H, S, D)
        out = F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask)
        inputs = (qs, ks_, vs, mask)
        try:
            torch.autograd.grad(out, inputs, dout, retain_graph=True)
            what = "dq, dk, dv and the mask's gradient"
        except RuntimeError as e:
            inputs = (qs, ks_, vs)
            what = f"dq, dk, dv only (no mask gradient: {e})"
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, inputs, dout, retain_graph=True), reps=5)
        del out, mask
        from deepspeed_tpu_torch import ops
        leaves = [t.detach().requires_grad_() for t in (q, k, v, b1, b2)]
        out = ops.evoformer_attention(*leaves)
        op_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), reps=5)
        del out, leaves
        print(f"  plain backward {plain_ms:.3f} ms; SDPA backward with the "
              f"materialised mask ({what}) {lib_ms:.4f} ms; the op's whole "
              f"backward (autograd, bias gradients reduced) {op_ms:.4f} ms",
              flush=True)
    res = {n: dict(shape=shape, ms=ms[n], plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bounds[n][0],
                   bound_by=bounds[n][1]) for n in EVO_BWD}
    res["evoformer_db2_sum"].update(
        shape=f"part[{chunks},{B},{H},{S},{S}] float32", plain_ms=sum_plain,
        library_ms=sum_lib)
    return res


def _evo_counts(evo):
    f = evo.cuda_evoformer_bwd
    return dict(zip(EVO, (evo.cuda_evoformer_fwd.launches, f.dq_launches,
                          f.dkv_launches, f.db2_launches, f.db2_sum_launches,
                          f.db1_launches)))


def _evo_faults(torch, evo, q, k, v, b1, b2, do, raw):
    """The backward check must see bias2 read through the neighbouring head
    in every kernel, and a dbias2 summed over N - 1 rows (the kernel run on
    the first N - 1 rows)."""
    o, lse = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
    bad = evo.cuda_evoformer_bwd(q, k, v, b1, b2.roll(1, dims=2), o, lse, do)
    for (name, lab), g, w in zip(GRADS, bad, raw):
        r = _rows_off(g, w)[0]
        print(f"  bias2 read through the neighbouring head moves the worst "
              f"{lab} row by {r:.3e} of its max (check at {ROW_TOL})",
              flush=True)
        if not r > ROW_TOL:
            fail(f"the {name} check cannot see a misread bias2 ({lab})")
    B, N, S, H, D = q.shape
    b1v, b2v = evo._bias_views(q, b1, b2)
    m = slice(0, N - 1)
    short = evo._bwd_kernel(
        "db2", q[:, m], k[:, m], v[:, m], b1v[:, m], b2v,
        lse.view(B, N, H, S)[:, m].reshape(-1, H, 1, S),
        evo._delta(o, do).view(B, N, H, S)[:, m].reshape(-1, H, S),
        do[:, m].contiguous())
    r = _rows_off(short.view(raw[4].shape), raw[4])[0]
    print(f"  a dbias2 summed over N - 1 = {N - 1} rows moves the worst row "
          f"by {r:.3e} of its max (check at {ROW_TOL})", flush=True)
    if not r > ROW_TOL:
        fail("the dbias2 check cannot see a dropped MSA row")


def _evo_walk_faults(torch, evo, q, k, v, b1, b2, do, raw):
    """The row checks must see, in the plain backward on the kernels' o and
    lse: one query tile of #15's walk dropped (its rows' p = 0 in every
    unit), one chunk left out of #16's second pass, and one skipped ring
    stage of each kernel (#15: one query tile of one (row, head, 128-key)
    unit, held over that row; #16: one MSA row of one (chunk, head, 128
    queries, 64 keys) unit).  Each fault's size is printed."""
    B, N, S, H, D = q.shape
    o, lse = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
    plan = evo._bwd_plan(q, b2)
    bm, rows = plan["dkv"]["bm"], plan["db2"]["rows"]

    def check(what, name, got, want):
        r = _rows_off(got, want)[0]
        print(f"  {what} moves the worst row by {r:.3e} of its max (check "
              f"at {ROW_TOL})", flush=True)
        if not r > ROW_TOL:
            fail(f"the {name} check cannot see {what}")

    lost = lse.clone()
    lost[..., bm:2 * bm] = evo.NEG_INF
    dropped = _evo_bwd_by_rows(torch, evo, q, k, v, b1, b2, o, lost, do)
    check(f"query tile {bm}..{2 * bm - 1} dropped from #15's walk (dk)",
          "evoformer_dkv", dropped[1], raw[1])
    check(f"query tile {bm}..{2 * bm - 1} dropped from #15's walk (dv)",
          "evoformer_dkv", dropped[2], raw[2])
    del dropped
    # the plain partials of the plan's chunks, one slice of rows at a time
    b1n = torch.broadcast_to(b1, (B, N, 1, 1, S))
    l5 = lse.view(B, N, H, 1, S)
    parts = []
    for lo, hi in rows:
        c = slice(lo, hi)
        parts.append(evo.torch_evoformer_db2_part(
            q[:, c], k[:, c], v[:, c], b1n[:, c], b2, o[:, c],
            l5[:, c].reshape(-1, H, 1, S), do[:, c], ((0, hi - lo),))[0])
    mid = len(parts) // 2
    full = evo.torch_evoformer_db2_sum(torch.stack(parts))
    check(f"chunk {mid} of {len(parts)} (rows {rows[mid][0]}.."
          f"{rows[mid][1] - 1}) left out of #16's second pass",
          "evoformer_db2", evo.torch_evoformer_db2_sum(
              torch.stack(parts[:mid] + parts[mid + 1:])),
          full)
    del parts
    # #15: query tile 1 of the (row 0, head 1, key tile 1) unit skipped
    r1 = slice(0, 1)
    one = (q[:, r1], k[:, r1], v[:, r1], b1n[:, r1], b2, o[:, r1])
    l1 = l5[:, r1].reshape(-1, H, 1, S)
    whole = evo.torch_evoformer_bwd(*one, l1, do[:, r1])
    l1x = l1.clone()
    l1x[:, 1, :, bm:2 * bm] = evo.NEG_INF
    skip = evo.torch_evoformer_bwd(*one, l1x, do[:, r1])
    dk = whole[1].clone()
    dk[:, :, 128:256, 1] = skip[1][:, :, 128:256, 1]
    check("one ring stage of #15 skipped (query tile 1 of row 0, head 1, "
          "keys 128..255)", "evoformer_dkv", dk, whole[1])
    # #16: row 0 left out of its (chunk 0, head 1, queries 0..127, keys
    # 64..127) unit
    ds0 = evo.torch_evoformer_db2_part(*one, l1, do[:, r1], ((0, 1),))[0]
    stage = full.clone()
    stage[:, 1, :128, 64:128] -= ds0[:, 1, :128, 64:128]
    check("one ring stage of #16 skipped (row 0 of the unit chunk 0, head "
          "1, queries 0..127, keys 64..127)", "evoformer_db2", stage, full)


def _evo_dq_faults(torch, evo, q, k, v, b1, b2, do):
    """dq makes delta: against the eager fp32 sum (F32_TOL of the
    largest); and the dq row check must see, in the plain dq on the
    kernels' o and lse of the first 32 MSA rows: one 64-key tile (keys
    64..127) out of every unit's walk, one skipped ring stage (that tile
    of the unit row 0, head 1, queries 0..127 alone), and the delta rows
    of the neighbouring head.  Each fault's size is printed."""
    B, N, S, H, D = q.shape
    o, lse = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
    b1v, b2v = evo._bias_views(q, b1, b2)
    _, delta = evo._bwd_kernel("dq", q, k, v, b1v, b2v, lse, None, do, o=o)
    _check_rows(torch, "evoformer_dq", "delta made in the producer warps",
                delta, evo._delta(o, do), F32_TOL)
    m = slice(0, 32)
    b1m = torch.broadcast_to(b1, (B, N, 1, 1, S))[:, m]
    lm = lse.view(B, N, H, 1, S)[:, m].reshape(-1, H, 1, S)
    args = (q[:, m], k[:, m], v[:, m], b1m, b2, o[:, m], lm, do[:, m])
    want = evo.torch_evoformer_bwd(*args)[0]

    def plain_dq(kk, vv, delta=None):
        """the plain dq with k, v replaced (and, if given, delta)"""
        qq = args[0]
        dp = torch.einsum("bnqhd,bnkhd->bnhqk", args[7].float(), vv.float())
        dl = evo._delta(args[5], args[7]) if delta is None else delta
        ds = evo._probs_ds(qq, kk, b1m, b2, lm, dp, dl)[1]
        return (D ** -0.5 * torch.einsum("bnhqk,bnkhd->bnqhd",
                                         ds.to(kk.dtype).float(),
                                         kk.float())).to(qq.dtype)

    def check(what, got):
        r = _rows_off(got, want)[0]
        print(f"  {what} moves the worst dq row by {r:.3e} of its max "
              f"(check at {ROW_TOL})", flush=True)
        if not r > ROW_TOL:
            fail(f"the evoformer_dq check cannot see {what}")

    kz, vz = args[1].clone(), args[2].clone()
    kz[:, :, 64:128] = 0       # a zero key adds nothing to dq = ds k
    vz[:, :, 64:128] = 0
    tile = plain_dq(kz, vz)
    check("key tile 64..127 out of dq's walk", tile)
    stage = want.clone()
    stage[:, 0, :128, 1] = tile[:, 0, :128, 1]
    check("one ring stage of dq skipped (keys 64..127 of row 0, head 1, "
          "queries 0..127)", stage)
    dl = evo._delta(args[5], args[7])
    check("the neighbouring head's delta rows",
          plain_dq(args[1], args[2], dl.roll(1, dims=1)))


# the AlphaFold2 calls (Jumper et al. 2021: Algorithms 7 and 13, the
# fine-tuning crop of Supplementary Table 4): (label, [B, N, S, H, D], keys
# masked on a seeded half of the rows)
EVO_CALLS = (("MSA row attention + pair bias", (1, 512, 384, 8, 32), 24),
             ("triangle attention", (1, 384, 384, 4, 32), 16),
             ("MSA row attention, S 383 (padded)", (1, 512, 383, 8, 32), 24))


def phase_evoformer(torch, evo, dev):
    """Kernels #13-#17 against their plain versions at small shapes
    (biases none / one / both, D 8-128, S 13 / 64 / 383, fully masked
    rows; the backward kernels on the plain o and lse), then the AlphaFold2
    calls through ``ops.evoformer_attention`` and ``loss.backward()``: MSA
    row attention with pair bias (N_clust 512, N_res 384, 8 heads x 32),
    triangle attention (384 x 384, 4 heads x 32) and the MSA call at S 383
    (padded to 384), q, k, v and both biases requiring grad.  One launch
    of each kernel a call; o and every gradient held per row; the MSA call
    timed, the triangle call's kernels too.  A bias2 read through the
    neighbouring head must show, forward and backward, and a dbias2 over
    N - 1 rows; the walk faults of #14-#16 must show and #14's delta
    agree with the eager sum."""
    from deepspeed_tpu_torch import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(8, 13, (), bf16), (16, 64, ("b1",), bf16),
             (32, 383, ("b2",), bf16), (64, 64, ("b1", "b2"), bf16),
             (128, 383, ("b1", "b2"), bf16), (32, 13, ("b1", "b2"), bf16),
             (8, 383, ("b1",), bf16), (16, 383, ("b1", "b2"), bf16),
             # an fp32 bias2 (dk/dv's 64-query stages)
             (32, 200, ("b1", "b2", "b2f32"), bf16),
             (128, 64, ("b2", "b2f32"), bf16),
             # bias2 [1, 1, H, 1, S], shared by every query (no TMA box)
             (32, 200, ("b1", "b2", "b2q"), bf16),
             (128, 64, ("b2", "b2q", "b2f32"), bf16),
             # head dims above 128 and fp32: the CUDA-core variants
             (256, 64, ("b1", "b2"), bf16), (160, 100, ("b1",), bf16),
             (32, 64, ("b1", "b2"), f32), (256, 45, ("b1", "b2"), f32),
             (88, 13, ("b2",), f32)]
    for D, S, bias, dtype in cases:
        q, k, v, b1, b2 = _evo_inputs(torch, dev, 1, 4, S, 4, D,
                                      masked_keys=min(S, 5), bias=bias,
                                      dtype=dtype)
        if "b2f32" in bias:
            b2 = b2.float()
        if "b2q" in bias:
            b2 = b2[..., :1, :]
        if b1 is not None:
            b1[:, 1] = -1e9                     # every key of a row masked
        label = f"D {D} S {S} biases {bias or 'none'} {dtype}".replace(
            "torch.", "")
        o, lse = _check_evo(torch, evo, label, q, k, v, b1, b2)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(D + S)).to(q.dtype)
        _check_evo_bwd(torch, evo, label,
                       evo.cuda_evoformer_bwd(q, k, v, b1, b2, o, lse, do),
                       evo.torch_evoformer_bwd(q, k, v, b1, b2, o, lse, do))
    launches, results = dict.fromkeys(EVO, 0), {}
    for i, (label, dims, masked) in enumerate(EVO_CALLS):
        q, k, v, b1, b2 = _evo_inputs(torch, dev, *dims, seed=18 + i,
                                      masked_keys=masked)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(28 + i)).to(q.dtype)
        leaves = [t.detach().requires_grad_() for t in (q, k, v, b1, b2)]
        evo.cuda_evoformer_fwd.launches = 0
        for name in ("dq", "dkv", "db2", "db2_sum", "db1"):
            setattr(evo.cuda_evoformer_bwd, name + "_launches", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ops.evoformer_attention(*leaves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.backward(do)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = _evo_counts(evo)
        print(f"  [{label}] q {list(q.shape)}: forward {(t1 - t0) * 1e3:.2f} "
              f"ms wall, backward {(t2 - t1) * 1e3:.2f} ms wall (a "
              f"process's first backward includes one-time set-up), "
              f"launches {counts}", flush=True)
        if any(n != 1 for n in counts.values()):
            fail(f"evoformer [{label}]: launches {counts}, want 1 each")
        for name, n in counts.items():
            launches[name] += n
        want = _evo_by_rows(torch, evo, q, k, v, b1, b2)
        _check_rows(torch, "evoformer_fwd", label, out.detach(), want)
        grads, raw, o_k = _evo_plain_grads(torch, evo, q, k, v, b1, b2, do)
        if not torch.equal(o_k, out.detach()):
            fail(f"evoformer_fwd [{label}]: a second launch differs")
        _check_evo_bwd(torch, evo, label, [t.grad for t in leaves], grads)
        if i == 0:
            results["evoformer_fwd"] = r = _time_evo(torch, evo, q, k, v, b1,
                                                     b2)
            print(f"  [{label}] kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, SDPA + mask "
                  f"{r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
            results.update(_time_evo_bwd(torch, evo, q, k, v, b1, b2, do))
            # the check must see bias2 read through the neighbouring head
            got, _ = evo.cuda_evoformer_fwd(q, k, v, b1, b2.roll(1, dims=2))
            r = _row_err(torch, got, want)
            print(f"  bias2 read through the neighbouring head moves the "
                  f"worst row by {r:.3e} of its max (check at {ROW_TOL})",
                  flush=True)
            if not r > ROW_TOL:
                fail("the evoformer check cannot see a misread bias2")
            _evo_faults(torch, evo, q, k, v, b1, b2, do, raw)
            _evo_walk_faults(torch, evo, q, k, v, b1, b2, do, raw)
            _evo_dq_faults(torch, evo, q, k, v, b1, b2, do)
            o1, lse1 = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
            runs = [evo.cuda_evoformer_bwd(q, k, v, b1, b2, o1, lse1, do)
                    for _ in range(2)]
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(*runs)]
            print(f"  two backward runs bitwise equal (dq, dk, dv, dbias1, "
                  f"dbias2): {same}", flush=True)
            if not all(same):
                fail("the evoformer backward is not deterministic")
            del runs, o1, lse1
        elif i == 1:
            fwd_ms = cuda_ms(lambda: evo.cuda_evoformer_fwd(q, k, v, b1, b2))
            print(f"  [{label}] forward kernel {fwd_ms:.4f} ms", flush=True)
            _time_evo_bwd(torch, evo, q, k, v, b1, b2, do, full=False)
        del q, k, v, b1, b2, do, leaves, out, want, grads, raw, o_k
        gc.collect()
        torch.cuda.empty_cache()
    return launches, results


# --------------------------------------------------------- phases 19 to 21

GAMMA, OUTER = 4, 8                 # the speculative block's defaults


def _draft_cfg(torch):
    """The draft users pair with Llama-3-8B (the same vocabulary):
    ``meta-llama/Llama-3.2-1B`` config.json — hidden 2048, 16 layers, 32 /
    8 heads x 64, FFN 8192, vocab 128256, rope_theta 5e5, llama3 rope
    scaling (factor 32, low 1, high 4, original 8192), tied embeddings."""
    import dataclasses
    from deepspeed_tpu_torch import GPTConfig
    return dataclasses.replace(GPTConfig.llama(
        num_layers=16, hidden=2048, heads=32, num_kv_heads=8,
        vocab_size=128256, max_seq_len=8192, mlp_dim_override=8192,
        rope_theta=500000.0, norm_eps=1e-5,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192), dtype=torch.bfloat16),
        tie_embeddings=True)


def _pool_calls(rec, name, cache, q_len=None):
    """The recorded first-layer calls of ``name`` that read ``cache``'s
    pages (and, given ``q_len``, have that many query rows a slot)."""
    ptr = cache.layer(0)[0].data_ptr()
    return [c for c in rec[name] if c[0][1].data_ptr() == ptr
            and (q_len is None or c[0][0].shape[1] == q_len)]


def _heaviest(calls, key):
    return max(reversed(calls), key=lambda c: int(key(c[0]).sum()))


def _garbage(torch, t, gen):
    """Values no live key holds: N(0, 50^2) (int8 pages: random codes)."""
    if t.dtype == torch.int8:
        return torch.randint(-127, 128, t.shape, generator=gen,
                             device=t.device, dtype=torch.int8)
    return (torch.randn(t.shape, generator=gen, device=t.device) * 50
            ).to(t.dtype)


def _poisoned_tail(torch, pa, name, label, args, kw, tol):
    """Rollback is by overwrite: a verify round writes K/V for all of its
    gamma+1 positions and leaves a rejected tail in the pages, past the
    kv_len of the next round.  Such keys must never be read.  Every key
    and value past each slot's kv_len in its last live page, and every page
    of the table no slot reads (scales too, for int8 pages), is overwritten
    with garbage: the kernel's output must stay within ``tol`` of its
    output on the clean pages (bitwise equality printed).  The check is
    shown to see one poisoned key read: the plain version with the kv_len
    of every slot with a poisoned tail one longer (the prefill's rows also
    one position later)."""
    decode = name.startswith("paged")
    q, k, v, bt, kvl = args[:5]
    bs = k.shape[2]
    lens, table = kvl.cpu().numpy(), bt.cpu().numpy()
    live, tails = set(), []
    for s, n_keys in enumerate(lens.tolist()):
        n = -(-n_keys // bs)
        live.update(table[s, :n].tolist())
        if n_keys % bs:
            tails.append((s, int(table[s, n - 1]), n_keys % bs))
    dead = sorted(set(table.reshape(-1).tolist()) - live)
    gen = torch.Generator(device=k.device).manual_seed(0)
    pk = dict(kw)
    kp, vp = k.clone(), v.clone()
    views = [kp, vp]
    if kw.get("k_scale") is not None:
        pk["k_scale"], pk["v_scale"] = (kw["k_scale"].clone(),
                                        kw["v_scale"].clone())
        views += [pk["k_scale"], pk["v_scale"]]
    for t in views:
        for _, p, off in tails:
            t[p, :, off:] = _garbage(torch, t[p, :, off:], gen)
        if dead:
            idx = torch.tensor(dead, device=t.device)
            t[idx] = _garbage(torch, t[idx], gen)
    kern = pa.cuda_paged_attention if decode else pa.cuda_ragged_prefill
    plain = pa.torch_paged_attention if decode else pa.torch_ragged_prefill
    rest = tuple(args[5:])
    clean = kern(*args, **kw)
    dirty = kern(q, kp, vp, bt, kvl, *rest, **pk)
    torch.cuda.synchronize()
    row, _ = _rows_off(dirty, clean)
    print(f"  {label}: {len(tails)} page tails and {len(dead)} unread pages "
          f"poisoned: worst row {row:.3e} of its max (check at {tol}), "
          f"bitwise equal {torch.equal(dirty, clean)}", flush=True)
    if not row <= tol or not torch.isfinite(dirty).all():
        fail(f"{label}: the kernel read keys past kv_len ({row})")
    if not tails:
        fail(f"{label}: no slot has a page tail to poison")
    rows = [t[0] for t in tails]
    longer = kvl.clone()
    longer[rows] += 1
    if not decode:
        rest = (args[5].clone(),) + tuple(args[6:])
        rest[0][rows] += 1
    moved, _ = _rows_off(plain(q, kp, vp, bt, longer, *rest, **pk)[rows],
                         plain(q, kp, vp, bt, kvl, *args[5:], **pk)[rows])
    print(f"  {label}: one poisoned key read by each of those slots moves "
          f"the worst row by {moved:.3e}", flush=True)
    if not moved > tol:
        fail(f"{label}: the poisoned-tail check cannot see a key read")


def _hold_call(torch, pa, name, label, args, kw, tol=ROW_TOL, time_it=True):
    """A recorded call held to its plain version per output row, and timed
    (kernel, plain, SDPA with the mask over the gathered K/V, bound)."""
    decode = name.startswith("paged")
    kern = pa.cuda_paged_attention if decode else pa.cuda_ragged_prefill
    plain = pa.torch_paged_attention if decode else pa.torch_ragged_prefill
    _check_rows(torch, name, label, kern(*args, **kw), plain(*args, **kw),
                tol)
    if not time_it:
        return None
    r = (_time_decode(torch, pa, *args, kw) if decode
         else _time_prefill(torch, pa, *args, kw))
    r["label"] = label
    return r


def _shape_line(name, r, launches):
    print("KERNEL_SHAPE " + json.dumps({
        "kernel": name, "call": r["label"], "shape": r["shape"],
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "launches": launches}), flush=True)


def phase_spec_main(torch, pa, dev, card, params, base_e2e=None):
    """Speculative decoding at full width: Llama-3-8B (phase 4's bf16 tree,
    the same tensors) with a Llama-3.2-1B-widths draft (seeded random
    weights), gamma 4, 8 outer steps, on phase 4's 16 requests; then a
    self-draft pass (the target's own tensors as the draft).  The verify
    call's #2 (5 rows a slot), the draft's #1 (head dim 64, g 4) and the
    draft's prefill #2 are held to their plain versions and timed; the
    poisoned-tail check on the first two."""
    from deepspeed_tpu_torch import InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import count_params, init_params
    cfg, dcfg = _llama_cfg(torch), _draft_cfg(torch)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, torch.bfloat16)
    t0 = time.perf_counter()
    dparams = init_params(dcfg, torch.Generator(device=dev).manual_seed(1),
                          dev, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  draft: Llama-3.2-1B widths, {count_params(dcfg) / 1e9:.3f}B "
          f"params, bf16 on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    prompts, news = _requests(cfg.vocab_size, 1025)
    ecfg = {"dtype": "bfloat16", "state_manager": LLAMA_SM,
            "speculative": {"gamma": GAMMA, "outer_steps": OUTER}}
    kernels = ("paged_attention", "ragged_prefill")
    e2es, results, launches = [], {}, dict.fromkeys(kernels, 0)
    for label, dc, dp in (("Llama-3-8B bf16 + Llama-3.2-1B draft", dcfg,
                           dparams),
                          ("Llama-3-8B bf16, self-draft", cfg, params)):
        eng = InferenceEngineV2(cfg, config=ecfg, params=params,
                                draft_model=dc, draft_params=dp, device=dev)
        same = (eng.draft_params["backbone"]["wte"]
                is params["backbone"]["wte"]) if dc is cfg else None
        rec = _record_calls(eng, {"paged_attention": "paged_attention",
                                  "ragged_prefill_attention":
                                  "ragged_prefill"})
        outs, e2e = _serve(torch, label, eng, prompts, news, kernels, card)
        rec.restore()
        st = eng.telemetry.spec_summary()
        e2e["spec"] = st
        if base_e2e is not None:
            e2e["bf16_generated_tok_per_s"] = base_e2e["generated_tok_per_s"]
        for k in kernels:
            launches[k] += e2e["launches"][k]
        print(f"  {label}: spec {st}" + (
            f"; generated tok/s {e2e['generated_tok_per_s']:.1f} against "
            f"{base_e2e['generated_tok_per_s']:.1f} for phase 4's engine in "
            f"this run ({e2e['generated_tok_per_s'] / base_e2e['generated_tok_per_s']:.3f}x)"
            if base_e2e is not None else "") + (
            f"; the draft's tensors are the target's: {same}"
            if same is not None else ""), flush=True)
        if st["outer_steps"] <= 0 or eng.dispatches["burst"]:
            fail(f"{label}: the speculative path did not run ({st}, "
                 f"{eng.dispatches})")
        if same is False:
            fail(f"{label}: the self-draft copied the target's tensors")
        if dc is dcfg:
            verify = _pool_calls(rec, "ragged_prefill", eng.cache, GAMMA + 1)
            ddec = _pool_calls(rec, "paged_attention", eng.draft_cache)
            dpre = _pool_calls(rec, "ragged_prefill", eng.draft_cache)
            if not (verify and ddec and dpre):
                fail(f"{label}: recorded {len(verify)} verify, {len(ddec)} "
                     f"draft decode, {len(dpre)} draft prefill calls")
            n_calls = {"verify": len(verify) * cfg.num_layers,
                       "draft_decode": len(ddec) * dcfg.num_layers,
                       "draft_prefill": len(dpre) * dcfg.num_layers}
            args, kw = _heaviest(verify, lambda a: a[4])
            cn = args[6].cpu().numpy()
            print(f"  verify call: live rows by slot {cn.tolist()} of "
                  f"{args[0].shape[1]}, q_starts "
                  f"{args[5].cpu().numpy().tolist()}", flush=True)
            results["verify"] = _hold_call(torch, pa, "ragged_prefill",
                                           "verify (5 rows a slot)", args, kw)
            _poisoned_tail(torch, pa, "ragged_prefill", "verify #2", args,
                           kw, ROW_TOL)
            args, kw = _heaviest(ddec, lambda a: a[4])
            results["draft_decode"] = _hold_call(
                torch, pa, "paged_attention", "draft decode (hd 64, g 4)",
                args, kw)
            _poisoned_tail(torch, pa, "paged_attention", "draft decode #1",
                           args, kw, ROW_TOL)
            args, kw = _heaviest(dpre, lambda a: a[6])
            results["draft_prefill"] = _hold_call(
                torch, pa, "ragged_prefill", "draft prefill (hd 64)", args,
                kw)
        e2es.append(e2e)
        del eng, rec
        gc.collect()
        torch.cuda.empty_cache()
    for key, name in (("verify", "ragged_prefill"),
                      ("draft_decode", "paged_attention"),
                      ("draft_prefill", "ragged_prefill")):
        _shape_line(name, results[key], n_calls[key])
    _print_times({r["label"]: r for r in results.values()})
    return launches, e2es


def _prefix_requests(vocab):
    """16 requests sharing a 512-token system prefix (8 pages of 64), then
    64..512 tokens of their own; 64..128 new tokens each (numpy seed 20)."""
    rng = np.random.default_rng(20)
    shared = rng.integers(0, vocab, 512)
    own = rng.integers(64, 513, 16)
    news = rng.integers(64, 129, 16)
    return ([np.concatenate([shared, rng.integers(0, vocab, int(n))])
             .astype(np.int32) for n in own], news)


def phase_prefix_sla_main(torch, pa, dev, card, params):
    """The radix prefix cache and SLA scheduling at full Llama-3-8B width
    (phase 4's bf16 tree): generate twice on one engine with the cache on
    (the second call must alias at least 16 x 512 prompt tokens); the
    prefill call past the cached pages held to its plain version and timed;
    then the same traffic on 4 slots with staggered arrivals (the 12
    default requests every 20 ms, the 4 gold ones together at 0.5 s, so
    that a burst's one retirement cannot seat them all), without and with
    two SLA classes."""
    from deepspeed_tpu_torch import InferenceEngineV2
    cfg = _llama_cfg(torch)
    prompts, news = _prefix_requests(cfg.vocab_size)
    kernels = ("paged_attention", "ragged_prefill")
    launches = dict.fromkeys(kernels, 0)
    out = {}
    eng = InferenceEngineV2(cfg, config={
        "dtype": "bfloat16", "state_manager": dict(LLAMA_SM,
                                                   prefix_cache=True)},
        params=params, device=dev)
    calls = []
    for i in range(2):
        hits0 = eng.telemetry.value("kv_prefix_hit_tokens_total")
        rec = _record_calls(eng, {"ragged_prefill_attention":
                                  "ragged_prefill"})
        label = f"Llama-3-8B bf16, prefix cache, call {i + 1}"
        outs, e2e = _serve(torch, label, eng, prompts, news, kernels, card)
        rec.restore()
        hits = eng.telemetry.value("kv_prefix_hit_tokens_total") - hits0
        e2e["prefix_hit_tokens"] = hits
        e2e["prefix_cached_tokens"] = int(sum(eng.prefix_cached_tokens(p)
                                              for p in prompts))
        print(f"  {label}: {int(hits)} prompt tokens served from cached "
              f"pages; prefix_cached_tokens over the prompts after it "
              f"{e2e['prefix_cached_tokens']}", flush=True)
        for k in kernels:
            launches[k] += e2e["launches"][k]
        out[f"call{i + 1}"] = e2e
        calls = rec["ragged_prefill"]
        if i == 0:
            first = outs
    if out["call2"]["prefix_hit_tokens"] < 16 * 512:
        fail(f"prefix cache: the second call aliased "
             f"{out['call2']['prefix_hit_tokens']} tokens < 16 x 512")
    same = sum(int(np.array_equal(a, b)) for a, b in zip(first, outs))
    out["calls_equal"] = same
    print(f"  requests with the same tokens in both calls (bf16; not "
          f"gated): {same} of 16", flush=True)
    def past_cache(args):
        starts, counts = args[5].cpu().numpy(), args[6].cpu().numpy()
        return counts.any() and starts[counts > 0].min() >= 512
    past = [c for c in calls if past_cache(c[0])]
    if not past:
        fail("prefix cache: no prefill call past the cached pages")
    args, kw = _heaviest(past, lambda a: a[6])
    r = _hold_call(torch, pa, "ragged_prefill",
                   "prefix-cache prefill (q_starts >= 512)", args, kw)
    print(f"  prefix-cache prefill call: q_starts "
          f"{args[5].cpu().numpy().tolist()}, live rows "
          f"{args[6].cpu().numpy().tolist()}", flush=True)
    _shape_line("ragged_prefill", r, len(past) * cfg.num_layers)
    _print_times({r["label"]: r})
    del eng, rec, calls, past
    gc.collect()
    torch.cuda.empty_cache()

    sm4 = dict(LLAMA_SM, max_tracked_sequences=4,
               num_kv_blocks=4 * 2048 // 64, prefix_cache=True)
    sla_cfg = {"sla_classes": {"gold": {"priority": 1, "ttft_slo_ms": 200.0},
                               "default": {"priority": 0}}}
    classes = ["gold" if i % 4 == 3 else "default" for i in range(16)]
    arrivals = [0.5 + 0.02 * (i // 4) if c == "gold" else 0.02 * i
                for i, c in enumerate(classes)]
    runs = {}
    for label, sla in (("4 slots, staggered arrivals, no SLA", None),
                       ("the same with SLA classes", classes)):
        eng = InferenceEngineV2(cfg, config={
            "dtype": "bfloat16", "state_manager": sm4,
            "scheduler": sla_cfg}, params=params, device=dev)
        gen = {"arrival_times": arrivals}
        if sla is not None:
            gen["sla"] = sla
        outs, e2e = _serve(torch, f"Llama-3-8B bf16, {label}", eng, prompts,
                           news, kernels, card, **gen)
        for k in kernels:
            launches[k] += e2e["launches"][k]
        t = eng.telemetry
        ttft = {c: sorted(r["ttft_ms"] for r, cls in zip(
            sorted(t.request_log, key=lambda r: -r["uid"]), classes)
            if cls == c) for c in ("gold", "default")}
        e2e["sla_preemptions"] = t.value("serving_sla_preemptions_total",
                                         sla="default")
        e2e["ttft_ms_median"] = {c: v[len(v) // 2] for c, v in ttft.items()}
        print(f"  {label}: preemptions {eng.preempt_stats}, SLA preemptions "
              f"{int(e2e['sla_preemptions'])}, median TTFT gold "
              f"{e2e['ttft_ms_median']['gold']:.1f} ms / default "
              f"{e2e['ttft_ms_median']['default']:.1f} ms", flush=True)
        runs[label] = (outs, e2e)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    (o1, e1), (o2, e2) = runs.values()
    same = sum(int(np.array_equal(a, b)) for a, b in zip(o1, o2))
    print(f"  SLA run: {int(e2['sla_preemptions'])} SLA preemptions; "
          f"requests with the run-without-SLA's tokens (bf16; recompute "
          f"re-prefills; not gated): {same} of 16; generated tok/s "
          f"{e2['generated_tok_per_s']:.1f} against "
          f"{e1['generated_tok_per_s']:.1f}", flush=True)
    if e2["sla_preemptions"] <= 0:
        fail("SLA run: no SLA preemption")
    out["no_sla"], out["sla"] = e1, dict(e2, tokens_equal_no_sla=same)
    return launches, out


def phase_spec_parity(torch, pa, dev):
    """Small config in fp32, TF32 off (phase 3's model): greedy
    speculative tokens (a random one-layer draft, then a self-draft) equal
    plain greedy on the card and the CPU's; prefix cache on equals off and
    the CPU's; SLA preemption under one fixed clock gives the CPU's
    preemptions and the uncontended tokens; int8 KV with a draft runs #1i /
    #2i.  The fp32 verify and draft-decode calls, and the int8 ones, are
    held to their plain versions (F32_TOL) with the poisoned-tail check."""
    import dataclasses
    from deepspeed_tpu_torch import GPTConfig, InferenceEngineV2
    from deepspeed_tpu_torch.models.gpt import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dict(hidden=128, heads=4, num_kv_heads=2, vocab_size=512,
                 max_seq_len=256)
    cfg = dataclasses.replace(GPTConfig.llama(num_layers=2, **small),
                              dtype=torch.float32)
    dcfg = dataclasses.replace(GPTConfig.llama(num_layers=1, **small),
                               dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dparams = init_params(dcfg, torch.Generator().manual_seed(1), "cpu")
    sm = {"max_tracked_sequences": 4, "max_ragged_batch_size": 64,
          "kv_block_size": 8, "max_q_per_seq": 8, "num_kv_blocks": 16}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (18 + 5 * i,)).astype(np.int32)
               for i in range(4)]
    counters = _counters()

    def run(d, config, draft=None, record=False, **gen):
        kw = ({} if draft is None else
              {"draft_model": draft[0], "draft_params": draft[1]})
        eng = InferenceEngineV2(cfg, config={"dtype": "fp32", **config},
                                params=params, device=d, **kw)
        rec = (_record_calls(eng, {"paged_attention": "paged_attention",
                                   "ragged_prefill_attention":
                                   "ragged_prefill"}) if record else None)
        outs = eng.generate(gen.pop("prompts", prompts),
                            max_new_tokens=gen.pop("new", 20), **gen)
        if rec is not None:
            rec.restore()
        return outs, eng, rec

    def same(label, a, b):
        bad = [i for i, (x, y) in enumerate(zip(a, b))
               if not np.array_equal(x, y)]
        print(f"  {label}: {'equal' if not bad else f'requests {bad} differ'}"
              f" ({sum(len(o) for o in a)} tokens)", flush=True)
        if bad:
            fail(f"spec parity: {label}: requests {bad} differ")

    plain, _, _ = run("cpu", {"state_manager": sm})
    same("plain greedy, cuda = cpu", run(dev, {"state_manager": sm})[0],
         plain)
    for name, draft in (("random one-layer draft", (dcfg, dparams)),
                        ("self-draft", (cfg, params))):
        cpu_out, ceng, _ = run("cpu", {"state_manager": sm}, draft)
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        out, eng, rec = run(dev, {"state_manager": sm}, draft,
                            record=name.startswith("random"))
        st = eng.telemetry.spec_summary()
        print(f"  {name}: spec {st}; preemptions {eng.preempt_stats}",
              flush=True)
        same(f"{name}, speculative cuda = plain greedy", out, plain)
        same(f"{name}, speculative cuda = cpu", out, cpu_out)
        keys = ("outer_steps", "proposed", "accepted", "emitted",
                "spec_dispatches")
        cst = ceng.telemetry.spec_summary()
        if st["outer_steps"] <= 0 or any(st[k] != cst[k] for k in keys):
            fail(f"spec parity: {name}: counters {st} against the cpu's "
                 f"{cst}")
        if rec is not None:
            for nm, calls in (
                    ("ragged_prefill", _pool_calls(rec, "ragged_prefill",
                                                   eng.cache, GAMMA + 1)),
                    ("paged_attention", _pool_calls(rec, "paged_attention",
                                                    eng.draft_cache))):
                if not calls:
                    fail(f"spec parity: no {nm} call recorded")
                args, kw = _heaviest(calls, lambda a: a[4])
                _hold_call(torch, pa, nm, f"fp32 {nm} of the {name}", args,
                           kw, F32_TOL, time_it=False)
                _poisoned_tail(torch, pa, nm, f"fp32 {nm} of the {name}",
                               args, kw, F32_TOL)

    # prefix cache on = off (cuda) = cpu, over two calls
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 512, 40)
    pp = [np.concatenate([shared, rng.integers(0, 512, 5 + 3 * i)])
          .astype(np.int32) for i in range(4)]
    off, _, _ = run(dev, {"state_manager": sm}, prompts=pp, new=12)
    cpu_on, _, _ = run("cpu", {"state_manager": dict(sm, prefix_cache=True)},
                       prompts=pp, new=12)
    eng = InferenceEngineV2(cfg, config={"dtype": "fp32", "state_manager":
                                         dict(sm, prefix_cache=True)},
                            params=params, device=dev)
    for i in range(2):
        on = eng.generate(pp, max_new_tokens=12)
        same(f"prefix cache on (call {i + 1}) = off, cuda", on, off)
    same("prefix cache on, cuda = cpu", on, cpu_on)
    hits = eng.telemetry.value("kv_prefix_hit_tokens_total")
    print(f"  prefix cache: {int(hits)} prompt tokens served from cached "
          f"pages", flush=True)
    if hits < 4 * 40 // 8 * 8:
        fail(f"prefix cache: only {hits} tokens aliased")

    # SLA preemption under one fixed clock: the cpu's decisions and tokens
    sla_sm = dict(sm, max_tracked_sequences=2, num_kv_blocks=64)
    sched = {"sla_classes": {"batch": {"priority": 0},
                             "gold": {"priority": 10, "ttft_slo_ms": 1.0}}}
    res = {}
    for d in ("cpu", dev):
        clk = [0.0]

        def now():
            clk[0] += 0.05
            return clk[0]
        o, e, _ = run(d, {"state_manager": sla_sm, "scheduler": sched},
                      prompts=prompts[:3], new=[24, 20, 4], now_fn=now,
                      arrival_times=[0.0, 0.0, 0.2],
                      sla=["batch", "batch", "gold"])
        res[d] = (o, dict(e.preempt_stats), e.telemetry.value(
            "serving_sla_preemptions_total", sla="batch"))
    same("SLA run, cuda = cpu", res[dev][0], res["cpu"][0])
    print(f"  SLA run: preemptions cuda {res[dev][1:]} cpu "
          f"{res['cpu'][1:]}", flush=True)
    if res[dev][1:] != res["cpu"][1:] or res[dev][2] < 1:
        fail("SLA run: the preemptions differ from the cpu's or none fired")
    solo = [run(dev, {"state_manager": sm}, prompts=[p], new=n)[0][0]
            for p, n in zip(prompts[:3], (24, 20, 4))]
    same("SLA run = uncontended runs", res[dev][0], solo)

    # int8 KV with a draft: #1i and #2i on the main path
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    q8 = {"state_manager": dict(sm, kv_quant="int8")}
    o8, e8, rec = run(dev, q8, (dcfg, dparams), record=True)
    n8 = {k: getattr(*counters[k]) for k in ("paged_attention_int8",
                                             "ragged_prefill_int8")}
    print(f"  int8 KV + draft: int8 launches {n8}; spec "
          f"{e8.telemetry.spec_summary()}", flush=True)
    if min(n8.values()) <= 0:
        fail(f"int8 KV + draft: {n8}")
    cpu8, _, _ = run("cpu", q8, (dcfg, dparams))
    agree = sum(int(np.array_equal(a, b)) for a, b in zip(o8, cpu8))
    print(f"  int8 KV + draft: requests equal to the cpu's (not gated): "
          f"{agree} of {len(o8)}", flush=True)
    for nm, calls in (("ragged_prefill_int8", _pool_calls(
            rec, "ragged_prefill", e8.cache, GAMMA + 1)),
                      ("paged_attention_int8", _pool_calls(
                          rec, "paged_attention", e8.draft_cache))):
        args, kw = _heaviest(calls, lambda a: a[4])
        base = nm.replace("_int8", "")
        decode = base.startswith("paged")
        kern = pa.cuda_paged_attention if decode else pa.cuda_ragged_prefill
        plain_fn = (pa.torch_paged_attention if decode
                    else pa.torch_ragged_prefill)
        _check_rows(torch, nm, f"fp32 q, int8 pages, {nm} of the draft run",
                    kern(*args, **kw), plain_fn(*args, **kw), F32_TOL)
        _poisoned_tail(torch, pa, base, f"int8 {base} of the draft run",
                       args, kw, F32_TOL)


def _ptxas_report(build_log, kernel):
    """ptxas's registers, spills and stack for each instantiation of
    ``kernel`` (template arguments demangled where c++filt exists)."""
    import shutil
    import subprocess
    for name, log in build_log.items():
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if kernel in line else None
            elif entry and ("spill stores" in line or "Used" in line):
                if "Used" in line:
                    args = entry
                    if shutil.which("c++filt"):
                        args = subprocess.run(
                            ["c++filt", entry], capture_output=True,
                            text=True).stdout.strip()
                    args = args[args.find("<"):args.find(">(") + 1] or args
                    print(f"  [{name}] {kernel}{args}: {spill.strip()}; "
                          f"{line.split(':', 1)[1].strip()}", flush=True)
                    entry = None
                else:
                    spill = line


# the redesigned kernels whose ptxas spills must be 0, and the wgmma kernels
# whose products ptxas must keep asynchronous
NEW_KERNELS = ("paged_decode_mma_kernel", "decode_combine_kernel", "wq_t_kernel",
               "evo_dkv_kernel", "evo_db2_kernel", "evo_db2_sum_kernel",
               "prefill_wgmma_kernel", "prefill_combine_kernel",
               "lora_shrink_wgmma", "lora_expand_wgmma",
               "sparse_dkv_wgmma_kernel", "sparse_dkv_merge_kernel",
               "evo_dq_wgmma_kernel", "sparse_fwd_wgmma_kernel",
               "sparse_dq_wgmma_kernel", "sparse_q_merge_kernel")
WGMMA_GATE = ("attn_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
              "evo_dkv_kernel", "evo_db2_kernel", "wq_t_kernel",
              "prefill_wgmma_kernel", "lora_shrink_wgmma",
              "lora_expand_wgmma", "sparse_dkv_wgmma_kernel",
              "evo_dq_wgmma_kernel", "sparse_fwd_wgmma_kernel",
              "sparse_dq_wgmma_kernel")


def _spill_gate(build_log, kernels):
    """Fail if ptxas reports a spill store or load in any instantiation of
    ``kernels``."""
    for name, log in build_log.items():
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and "spill stores" in line and any(
                    k in entry for k in kernels):
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                   r"spill loads", line)
                if spills is None or any(int(n) for n in spills.groups()):
                    fail(f"[{name}] {entry}: {line.strip()}")


def _serialised_gate(build_log, kernels):
    """ptxas's performance warnings that it serialised a kernel's wgmma
    products (C7510-C7520: "wgmma.mma_async instructions are serialized"):
    printed for every kernel, fatal for ``kernels``."""
    for name, log in build_log.items():
        for line in log.splitlines():
            if "wgmma" in line and "serialized" in line:
                print(f"  [{name}] ptxas: {line.strip()[:300]}", flush=True)
                if any(k in line for k in kernels):
                    fail(f"[{name}] ptxas serialised the wgmmas of a gated "
                         f"kernel: {line.strip()[:300]}")


def _sass_report(so, kernels, gate=()):
    """Counts of ``HGMMA`` (wgmma) and ``WARPGROUP.DEPBAR`` (its waits) in
    the SASS of each instantiation of ``kernels`` in the library ``so``.
    ptxas serialises every wgmma of a kernel (one wait after each product,
    silently) when one sits behind a branch it cannot prove uniform: a
    kernel named in ``gate`` with as many waits as products fails."""
    import shutil
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        fail(f"cuobjdump -sass: {r.stderr.strip()[:400]}")
    counts, name = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            name = fn if any(k in fn for k in kernels) else None
            if name:
                counts[name] = [0, 0]
        elif name and "HGMMA." in line:
            counts[name][0] += 1
        elif name and "WARPGROUP.DEPBAR" in line:
            counts[name][1] += 1
    for fn, (hg, dep) in sorted(counts.items()):
        label = fn
        if shutil.which("c++filt"):
            label = subprocess.run(["c++filt", fn], capture_output=True,
                                   text=True).stdout.strip()
            label = label[:label.find("(")] if "(" in label else label
        print(f"  SASS {label}: {hg} HGMMA, {dep} WARPGROUP.DEPBAR",
              flush=True)
        if any(k in fn for k in gate) and hg and dep >= hg:
            fail(f"{label}: every wgmma waited on ({dep} waits, {hg} "
                 f"products): ptxas serialised the kernel")
    for k in kernels:
        if not any(k in fn for fn in counts):
            fail(f"no SASS found for {k} in {so}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,6,7,8,9,10,11,13,14,15,16,17,18,19,"
                            "20,21",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="trace phases 4, 8, 11 (its W8 run) and 15 with "
                         "torch.profiler and print the device time by kernel")
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
    # the modules (ops/__init__ re-exports functions of the same names)
    pa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    wqm = importlib.import_module("deepspeed_tpu_torch.ops.wq_matmul")
    lm = importlib.import_module("deepspeed_tpu_torch.ops.lora_matmul")
    sp = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
    evo = importlib.import_module("deepspeed_tpu_torch.ops.evoformer")
    dev = "cuda:0"

    print("== phase 1: card, versions, kernel build", flush=True)
    card = card_line()
    print(f"  card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    builder.build(["paged_attention", "ragged_prefill", "flash_attention",
                   "wq_matmul", "lora_matmul", "sparse_attention",
                   "evoformer", "evoformer_bwd"])
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in builder.build_log.items():
        regs = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = [int(line.split("bytes spill stores")[0].split(",")[-1])
                  for line in log.splitlines() if "spill stores" in line]
        print(f"  [{name}] built in {builder.build_seconds[name]:.1f} s; "
              f"ptxas: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, spill "
              f"stores up to {max(spills, default=0)} bytes", flush=True)
    for kernel in ("attn_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                   "evo_dkv_kernel", "evo_db2_kernel", "evo_db2_sum_kernel",
                   "paged_decode_mma_kernel", "decode_combine_kernel",
                   "wq_t_kernel", "prefill_wgmma_kernel",
                   "prefill_combine_kernel", "lora_shrink_wgmma",
                   "lora_expand_wgmma", "sparse_dkv_wgmma_kernel",
                   "sparse_dkv_merge_kernel", "evo_dq_wgmma_kernel",
                   "sparse_fwd_wgmma_kernel", "sparse_dq_wgmma_kernel",
                   "sparse_q_merge_kernel"):
        _ptxas_report(builder.build_log, kernel)
    _spill_gate(builder.build_log, NEW_KERNELS)
    _serialised_gate(builder.build_log, WGMMA_GATE)
    for so, kernels in (("flash_attention", ("attn_fwd_kernel",
                                             "flash_dq_kernel",
                                             "flash_dkv_kernel")),
                        ("evoformer", ("attn_fwd_kernel",)),
                        ("evoformer_bwd", ("evo_dq_wgmma_kernel",
                                           "evo_dkv_kernel",
                                           "evo_db2_kernel")),
                        ("sparse_attention", ("sparse_dkv_wgmma_kernel",
                                              "sparse_fwd_wgmma_kernel",
                                              "sparse_dq_wgmma_kernel")),
                        ("wq_matmul", ("wq_wgmma_kernel", "wq_t_kernel")),
                        ("ragged_prefill", ("prefill_wgmma_kernel",)),
                        ("lora_matmul", ("lora_shrink_wgmma",
                                         "lora_expand_wgmma"))):
        _sass_report(builder._so_path(so), kernels,
                     gate=tuple(k for k in kernels if k in WGMMA_GATE))

    results = {}
    if 2 in phases:
        print("== phase 2: kernels vs plain versions, Llama-3-8B attention "
              "shapes, every variant", flush=True)
        results = phase_kernels(torch, pa, dev)
        torch.cuda.empty_cache()
    if 9 in phases:
        print("== phase 9: quantized kernels vs plain versions (#6-#8 at "
              "every Llama-3-8B / GPT-2 product shape; int8-KV decode and "
              "prefill)", flush=True)
        phase_quant_kernels(torch, wqm, pa, dev)
        torch.cuda.empty_cache()
    if 13 in phases:
        print("== phase 13: lora_matmul vs plain version (Llama-3-8B q / v "
              "projections, ranks 8-64, M 1-1024)", flush=True)
        results["lora_matmul"] = phase_lora_kernels(torch, lm, dev)
        torch.cuda.empty_cache()
    if 3 in phases:
        print("== phase 3: small-config parity, cuda vs cpu (fp32, TF32 off)",
              flush=True)
        phase_parity(torch, dev)
    if 10 in phases:
        print("== phase 10: small-config quantized parity, cuda vs cpu (fp32, "
              "TF32 off)", flush=True)
        phase_quant_parity(torch, dev)
    if 14 in phases:
        print("== phase 14: small-config adapter parity, cuda vs cpu (fp32, "
              "TF32 off)", flush=True)
        phase_lora_parity(torch, dev)
    if 21 in phases:
        print("== phase 21: small-config speculative, prefix-cache and SLA "
              "parity, cuda vs cpu (fp32, TF32 off); int8 KV with a draft; "
              "poisoned tails", flush=True)
        phase_spec_parity(torch, pa, dev)
    launches = dict.fromkeys(("paged_attention", "ragged_prefill") + FLASH
                             + WQ + INT8 + LORA + SPARSE + EVO)
    params = outs = pool = e2e = None
    if 4 in phases:
        print("== phase 4: main path, InferenceEngineV2.generate at "
              "Llama-3-8B width", flush=True)
        calls, eng, e2e, params, outs = phase_main(torch, pa, dev, card,
                                                   args.profile)
        launches.update((k, e2e["launches"][k])
                        for k in ("paged_attention", "ragged_prefill"))
        pool = e2e["kv_pool_gb"] * 1e9
        print("E2E " + json.dumps(e2e), flush=True)
        print("== phase 5: kernels vs plain versions on the main path's own "
              "inputs", flush=True)
        results.update(phase_main_inputs(torch, pa, calls, eng))
        del calls, eng
        if not phases & {11, 15, 19, 20}:
            params = None
        gc.collect()
        torch.cuda.empty_cache()
    if 19 in phases:
        print("== phase 19: speculative decoding at full width, Llama-3-8B "
              "with a Llama-3.2-1B draft, then a self-draft", flush=True)
        spec_launches, e2es = phase_spec_main(torch, pa, dev, card, params,
                                              e2e)
        for k, n in spec_launches.items():
            launches[k] = (launches[k] or 0) + n
        for r in e2es:
            print("E2E_SPEC " + json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if 20 in phases:
        print("== phase 20: prefix cache and SLA scheduling at full width, "
              "Llama-3-8B, a shared 512-token system prefix", flush=True)
        if params is None:
            from deepspeed_tpu_torch.models.gpt import init_params
            params = init_params(_llama_cfg(torch), torch.Generator(
                device=dev).manual_seed(0), dev, torch.bfloat16)
        pc_launches, e2e_pc = phase_prefix_sla_main(torch, pa, dev, card,
                                                    params)
        for k, n in pc_launches.items():
            launches[k] = (launches[k] or 0) + n
        print("E2E_PREFIX_SLA " + json.dumps(e2e_pc), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if 19 in phases or 20 in phases:
        if not phases & {11, 15}:
            params = None
    if 15 in phases:
        print("== phase 15: LoRA main path, generate(adapter_ids=...) at "
              "Llama-3-8B width, 8 tenants", flush=True)
        results["lora_matmul"], e2e_lora = phase_lora_main(
            torch, lm, dev, card, params, e2e, outs, args.profile)
        launches["lora_matmul"] = results["lora_matmul"].pop("launches")
        if 11 not in phases:
            params = None
        print("E2E_LORA " + json.dumps(e2e_lora), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if 11 in phases:
        print("== phase 11: quantized main path, generate at full width "
              "(Llama-3-8B W8 + int8 KV, Llama-3-8B W4, GPT-2 small W8 "
              "tied); phase 12: each new kernel held and timed on its "
              "heaviest main-path call", flush=True)
        quant_results, e2es = phase_quant_main(
            torch, wqm, pa, dev, card, params, outs, pool, args.profile,
            e2e and e2e["generated_tok_per_s"])
        params = None
        for r in e2es:
            print("E2E_QUANT " + json.dumps(r), flush=True)
        for name, r in quant_results.items():
            launches[name] = r.pop("launches")
        results.update(quant_results)
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
    if 8 in phases:
        print("== phase 8: training main path, initialize -> train_batch at "
              "GPT-2-small width", flush=True)
        flash_launches, flash_results, e2e = phase_train_main(
            torch, fa, dev, card, args.profile)
        launches.update(flash_launches)
        results.update(flash_results)
        print("E2E_TRAIN " + json.dumps(e2e), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        print("E2E_TRAIN_PHI2 " + json.dumps(
            phase_train_phi2(torch, fa, dev, card)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if 16 in phases:
        print("== phase 16: block-sparse kernels vs plain versions (bf16), "
              "every layout class", flush=True)
        phase_sparse_kernels(torch, sp, dev)
        torch.cuda.empty_cache()
    if 17 in phases:
        print("== phase 17: block-sparse path at Llama-3-8B attention width, "
              "T 8192, forward + backward", flush=True)
        sparse_launches, sparse_results = phase_sparse_main(torch, sp, dev)
        launches.update(sparse_launches)
        results.update(sparse_results)
        torch.cuda.empty_cache()
    if 18 in phases:
        print("== phase 18: evoformer forward + backward, small shapes and "
              "AlphaFold2's MSA row / triangle attention", flush=True)
        evo_launches, evo_results = phase_evoformer(torch, evo, dev)
        launches.update(evo_launches)
        results.update(evo_results)

    replaces = {"paged_attention":
                "deepspeed_tpu/ops/paged_attention.py:152",
                "ragged_prefill": "deepspeed_tpu/ops/paged_attention.py:546",
                "flash_fwd": "deepspeed_tpu/ops/flash_attention.py:208",
                "flash_dq": "deepspeed_tpu/ops/flash_attention.py:305",
                "flash_dkv": "deepspeed_tpu/ops/flash_attention.py:347",
                "wq_matmul_t": "deepspeed_tpu/ops/wq_matmul.py:217",
                "wq_matmul": "deepspeed_tpu/ops/wq_matmul.py:217",
                "wq_matmul4": "deepspeed_tpu/ops/wq_matmul.py:250",
                "paged_attention_int8":
                "deepspeed_tpu/ops/paged_attention.py:152",
                "ragged_prefill_int8":
                "deepspeed_tpu/ops/paged_attention.py:546",
                "lora_matmul": "deepspeed_tpu/ops/lora_matmul.py:111",
                "sparse_fwd": "deepspeed_tpu/ops/sparse_attention.py:186",
                "sparse_dq": "deepspeed_tpu/ops/sparse_attention.py:222",
                "sparse_dkv": "deepspeed_tpu/ops/sparse_attention.py:252",
                "sparse_dkv_merge":
                "deepspeed_tpu/ops/sparse_attention.py:252",
                "sparse_fwd_combine":
                "deepspeed_tpu/ops/sparse_attention.py:186",
                "sparse_dq_merge": "deepspeed_tpu/ops/sparse_attention.py:222",
                "evoformer_fwd": "deepspeed_tpu/ops/evoformer.py:89",
                "evoformer_dq": "deepspeed_tpu/ops/evoformer.py:203",
                "evoformer_dkv": "deepspeed_tpu/ops/evoformer.py:224",
                "evoformer_db2": "deepspeed_tpu/ops/evoformer.py:252",
                "evoformer_db2_sum": "deepspeed_tpu/ops/evoformer.py:252",
                "evoformer_db1": "deepspeed_tpu/ops/evoformer.py:272"}
    # the 16-bit forwards (#3, #13) share one kernel template, built into
    # flash_attention.cu and evoformer.cu; the 16-bit flash backward (#4,
    # #5) is a header built into flash_attention.cu
    sources = {**dict.fromkeys(FLASH, "flash_attention.cu"),
               **dict.fromkeys(WQ, "wq_matmul.cu"),
               **dict.fromkeys(SPARSE, "sparse_attention.cu"),
               "flash_fwd": "attn_fwd_hopper.cuh",
               "flash_dq": "attn_bwd_hopper.cuh",
               "flash_dkv": "attn_bwd_hopper.cuh",
               "evoformer_fwd": "attn_fwd_hopper.cuh",
               **dict.fromkeys(EVO_BWD, "evoformer_bwd.cu"),
               "evoformer_dq": "attn_bwd_hopper.cuh",
               "evoformer_dkv": "attn_bwd_hopper.cuh",
               "paged_attention_int8": "paged_attention.cu",
               # the 16-bit prefill (#2, #2i) is a header built into
               # ragged_prefill.cu
               "ragged_prefill": "prefill_hopper.cuh",
               "ragged_prefill_int8": "prefill_hopper.cuh"}
    kernels = []
    for name in ("paged_attention", "ragged_prefill") + FLASH + WQ + INT8 \
            + LORA + SPARSE + EVO:
        r = results.get(name, {})
        print("KERNEL " + json.dumps({
            "kernel": name, "shape": r.get("shape"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "library_ms": r.get("library_ms"),
            "bound_ms": r.get("bound_ms"), "launches": launches[name]}),
            flush=True)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/"
                      + sources.get(name, name + ".cu"),
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
