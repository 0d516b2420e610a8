#!/usr/bin/env python3
"""Device times of the block-sparse forward (#10), dq with its delta (#11),
dk/dv (#12) and the op's backward, and of the evoformer backward (#14 dq
with its delta, the whole backward) at their main-path calls, for an A/B of
two checkouts of the PyTorch port on one NVIDIA GPU.

    python3 scripts/time_bwd.py [--repo DIR] [--reps N]

``--repo`` names the checkout whose ``deepspeed_tpu_torch`` is timed
(default: the one holding this script), so one copy of the script times an
older checkout too: run parent, change, change, parent in one session and
compare within it.  The calls are chip_smoke.py's phase 17 and 18 main
calls (Llama-3-8B attention at T 8192 with the default Fixed pattern,
causal, and BigBird block 64, non-causal; AlphaFold2's MSA row attention
with pair bias [1, 512, 384, 8, 32] and triangle attention [1, 384, 384, 4,
32], bf16, seeded inputs).  Each number is a CUDA-event median over
``--reps`` calls with the stream held by a spin kernel while they are
enqueued (device time only).  ``dq + delta`` is the dq kernel with the
delta it needs: a dq that makes delta itself alone, otherwise the eager
``_delta`` (block-sparse: ``_bwd_inputs``) and the dq kernel in one timed
call.  Prints the card's name and
power limit (nvidia-smi) and one JSON object.  Needs a CUDA device; imports
no JAX.
"""

import argparse
import importlib
import inspect
import json
import os
import statistics
import subprocess
import sys

import numpy as np


def cuda_ms(torch, fn, reps, warmup=3):
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


def sparse_times(torch, sp, ops, dev, reps):
    out = {}
    calls = (("fixed", sp.FixedSparsityConfig(), True),
             ("bigbird64", sp.BigBirdSparsityConfig(block=64), False))
    for i, (label, cfg, causal) in enumerate(calls):
        gen = torch.Generator(device=dev).manual_seed(17 + i)
        shapes = ((1, 8192, 32, 128), (1, 8192, 8, 128), (1, 8192, 8, 128),
                  (1, 8192, 32, 128))
        q, k, v, do = (torch.randn(shape, device=dev, generator=gen).to(
            torch.bfloat16) for shape in shapes)
        lay = cfg.make_layout(8192)
        o, lse = sp.cuda_sparse_fwd(q, k, v, lay, cfg.block, causal)
        out[f"sparse_fwd_{label}"] = cuda_ms(
            torch, lambda: sp.cuda_sparse_fwd(q, k, v, lay, cfg.block,
                                              causal), reps)
        if "delta_out" in inspect.signature(sp.cuda_sparse_dq).parameters:
            made = torch.empty((1, 32, 8192), device=dev)

            def dq():
                return sp.cuda_sparse_dq(q, k, v, o, lse, do, lay, cfg.block,
                                         causal, delta_out=made)
        else:
            def dq():
                dos, lse_c, delta = sp._bwd_inputs("time", q, o, lse, do)
                return sp.cuda_sparse_dq(q, k, v, o, lse_c, dos, lay,
                                         cfg.block, causal, delta=delta)
        out[f"sparse_dq_with_delta_{label}"] = cuda_ms(torch, dq, reps)
        dos, lse_c, delta = sp._bwd_inputs("time", q, o, lse, do)
        out[f"sparse_delta_eager_{label}"] = cuda_ms(
            torch, lambda: sp._bwd_inputs("time", q, o, lse, do), reps)
        out[f"sparse_dkv_{label}"] = cuda_ms(
            torch, lambda: sp.cuda_sparse_dkv(q, k, v, o, lse_c, dos, lay,
                                              cfg.block, causal, delta=delta),
            reps)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        y = ops.sparse_attention(*leaves, cfg, causal=causal)
        out[f"sparse_backward_{label}"] = cuda_ms(
            torch, lambda: torch.autograd.grad(y, leaves, do,
                                               retain_graph=True),
            max(3, reps // 4))
        del q, k, v, do, o, lse, dos, lse_c, delta, leaves, y
        torch.cuda.empty_cache()
    return out


def evo_times(torch, evo, ops, dev, reps):
    out = {}
    makes_delta = "dq" in evo.evo_bwd_plan(32)
    calls = (("msa", (1, 512, 384, 8, 32), 24),
             ("triangle", (1, 384, 384, 4, 32), 16))
    for i, (label, (B, N, S, H, D), masked) in enumerate(calls):
        gen = torch.Generator(device=dev).manual_seed(18 + i)

        def rand(*shape):
            return torch.randn(shape, device=dev, generator=gen).to(
                torch.bfloat16)
        q, k, v = (rand(B, N, S, H, D) for _ in range(3))
        b1 = torch.zeros((B, N, 1, 1, S), device=dev)
        rows = np.random.default_rng(18 + i).permutation(N)[:N // 2]
        b1[:, torch.from_numpy(rows).to(dev), ..., S - masked:] = -1e9
        b2 = rand(B, 1, H, S, S)
        do = rand(B, N, S, H, D)
        o, lse = evo.cuda_evoformer_fwd(q, k, v, b1, b2)
        b1v, b2v = evo._bias_views(q, b1, b2)
        if makes_delta:
            def dq():
                return evo._bwd_kernel("dq", q, k, v, b1v, b2v, lse, None,
                                       do, o=o)
        else:
            def dq():
                return evo._bwd_kernel("dq", q, k, v, b1v, b2v, lse,
                                       evo._delta(o, do), do)
        out[f"evo_dq_with_delta_{label}"] = cuda_ms(torch, dq, reps)
        out[f"evo_delta_eager_{label}"] = cuda_ms(
            torch, lambda: evo._delta(o, do), reps)
        out[f"evo_bwd_kernels_{label}"] = cuda_ms(
            torch, lambda: evo.cuda_evoformer_bwd(q, k, v, b1, b2, o, lse, do),
            max(3, reps // 2))
        leaves = [t.detach().requires_grad_() for t in (q, k, v, b1, b2)]
        y = ops.evoformer_attention(*leaves)
        out[f"evo_backward_{label}"] = cuda_ms(
            torch, lambda: torch.autograd.grad(y, leaves, do,
                                               retain_graph=True),
            max(3, reps // 4))
        del q, k, v, b1, b2, do, o, lse, b1v, b2v, leaves, y
        torch.cuda.empty_cache()
    out["evo_dq_makes_delta"] = makes_delta
    return out


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=here,
                    help="checkout whose deepspeed_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    if not os.path.isdir(os.path.join(repo, "deepspeed_tpu_torch", "csrc")):
        print(f"no deepspeed_tpu_torch checkout at {repo}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: time_bwd.py times kernels on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    sp = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
    evo = importlib.import_module("deepspeed_tpu_torch.ops.evoformer")
    from deepspeed_tpu_torch import ops
    dev = "cuda:0"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    res = {"repo": repo, "card": card}
    res.update(sparse_times(torch, sp, ops, dev, args.reps))
    res.update(evo_times(torch, evo, ops, dev, args.reps))
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
