"""CUDA kernel builder — counterpart of deepspeed_tpu/ops/builder.py (which
builds host C++ with g++ and binds it through ctypes).

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"``
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``csrc/_build/`` (listed in .gitignore) at first use, keyed
by a hash of the source and the headers it may include, and loaded with
``ctypes``.  No PyTorch headers are compiled in, so a build takes seconds
rather than minutes.  A failed build raises with nvcc's stderr.  One module
lock serialises ``build`` and ``load_op`` across threads (the serving
fleet's replica workers), so two threads that first touch a kernel
together start one ``nvcc``, not two on the same ``.tmp`` output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

from deepspeed_tpu_torch.utils.logging import logger

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_BUILD = os.path.join(_CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas=-v"]
_cache: Dict[str, ctypes.CDLL] = {}
# held by build() and load_op(); re-entrant because load_op calls build
_lock = threading.RLock()
# ptxas's per-kernel resource report (registers, shared memory, spills) of
# the builds this process ran, by kernel name
build_log: Dict[str, str] = {}
# wall seconds from the start of a build() call to each source's library
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return found


def _so_path(name: str) -> str:
    """Build product path: hash of the kernel source plus every header in
    csrc/ (any of them may be included) and the flags."""
    h = hashlib.sha256()
    for path in [os.path.join(_CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, so: str, log) -> subprocess.Popen:
    src = os.path.join(_CSRC, f"{name}.cu")
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", so + ".tmp", src]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True)


def build(names: Iterable[str]) -> List[str]:
    """Compile every stale kernel in ``names`` — one nvcc per source, all
    started together — and return the shared-library paths.  Raises with
    nvcc's output if any build fails.  Each build's wall time lands in
    ``build_seconds``."""
    with _lock:
        return _build(list(names))


def _build(names: List[str]) -> List[str]:
    os.makedirs(_BUILD, exist_ok=True)
    sos = [_so_path(n) for n in names]
    t0 = time.perf_counter()
    procs = {}
    for n, so in zip(names, sos):
        if not os.path.exists(so):
            log = open(so + ".log", "w+")
            procs[n] = (so, log, _start(n, so, log))
    errors = []
    while procs:
        for n, (so, log, p) in list(procs.items()):
            if p.poll() is None:
                continue
            del procs[n]
            build_seconds[n] = time.perf_counter() - t0
            log.seek(0)
            out = log.read()
            log.close()
            os.remove(so + ".log")
            if p.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):"
                              f"\n{out}")
                continue
            build_log[n] = out
            os.replace(so + ".tmp", so)
            logger.info(f"built CUDA kernel {n} -> {so}")
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return sos


def load_op(name: str) -> ctypes.CDLL:
    """Build (if stale) and dlopen ``csrc/<name>.cu``, once a process."""
    lib = _cache.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _cache:
            so, = build([name])
            _cache[name] = ctypes.CDLL(so)
        return _cache[name]
