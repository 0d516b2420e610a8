#!/usr/bin/env python3
"""Host cost of launching small PyTorch ops from one thread and from two at
once, as the serving fleet's replica workers do (one process, one GIL).

    python3 scripts/thread_launch_cost.py [--steps N] [--layers L]

Each thread runs ``--steps`` x ``--layers`` of a host-bound layer (an RMS
norm, a [16, 1024] x [1024, 1024] bf16 matmul and a SiLU residual: 10 ops)
and times its wall and its own CPU time (``time.thread_time``).  Modes:
CUDA on one thread; CUDA on two threads on the one default stream over
shared weights (the fleet's case), over weights of their own, and on a
stream each; the same layer at width 64 on CPU tensors (one intra-op
thread, so the compute is small) on one and on two threads, which
isolates PyTorch's dispatcher and the GIL from the CUDA driver.  Each mode runs twice and the second run is reported.
Prints the card's name and power limit (nvidia-smi) and one JSON object.
Imports no JAX.
"""

import argparse
import contextlib
import json
import subprocess
import threading
import time

OPS_A_LAYER = 10


def layer(torch, x, w):
    h = x * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + 1e-6).to(
        x.dtype)
    return x + torch.nn.functional.silu(h @ w)


def run(torch, dev, threads, steps, layers, own_weights, own_stream):
    width = 64 if dev == "cpu" else 1024
    gen = torch.Generator(device=dev).manual_seed(0)
    w0 = torch.randn((width, width), device=dev, generator=gen).to(
        torch.bfloat16) * 0.02
    weights = [w0.clone() if own_weights else w0 for _ in range(threads)]
    streams = [torch.cuda.Stream() if own_stream else None
               for _ in range(threads)]
    start = threading.Barrier(threads + 1)
    out = [None] * threads

    def work(i):
        ctx = (torch.cuda.stream(streams[i]) if streams[i] is not None
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            x = torch.randn((16, width), device=dev).to(torch.bfloat16)
            start.wait()
            w, c = time.perf_counter(), time.thread_time()
            for _ in range(steps):
                for _ in range(layers):
                    x = layer(torch, x, weights[i])
            if dev != "cpu":
                torch.cuda.current_stream().synchronize()
            out[i] = (time.perf_counter() - w, time.thread_time() - c)

    pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    for t in pool:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in pool:
        t.join()
    wall = time.perf_counter() - t0
    ops = steps * layers * OPS_A_LAYER
    cpu = [c for _, c in out]
    return dict(threads=threads, wall_s=wall, thread_cpu_s=cpu,
                cpu_us_per_op=1e6 * sum(cpu) / (ops * threads),
                ops_per_s=ops * threads / wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    modes = {
        "cuda, 1 thread": ("cuda", 1, False, False),
        "cuda, 2 threads, one stream, shared weights": ("cuda", 2, False,
                                                        False),
        "cuda, 2 threads, one stream, own weights": ("cuda", 2, True, False),
        "cuda, 2 threads, a stream each, shared weights": ("cuda", 2, False,
                                                           True),
        "cpu, 1 thread": ("cpu", 1, False, False),
        "cpu, 2 threads": ("cpu", 2, False, False),
    }
    res = {}
    for name, (dev, n, own_w, own_s) in modes.items():
        for _ in range(2):
            r = run(torch, dev, n, args.steps, args.layers, own_w, own_s)
        res[name] = r
        print(f"{name}: wall {r['wall_s']:.3f} s, thread CPU "
              f"{[round(c, 3) for c in r['thread_cpu_s']]} s, "
              f"{r['cpu_us_per_op']:.2f} us CPU an op, "
              f"{r['ops_per_s']:.0f} ops/s", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({"card": card.strip(), "ops_a_layer": OPS_A_LAYER,
                      "steps": args.steps, "layers": args.layers,
                      "modes": res}))


if __name__ == "__main__":
    main()
