"""The port's kernel builder under threads: two serving-fleet workers that
first touch a kernel together must start one ``nvcc``, not two on the same
``<so>.tmp`` output.  ``nvcc`` is stubbed (``builder._start``), so this
runs on any box."""

import threading
import time
import types

from deepspeed_tpu_torch.ops import builder


class _Proc:
    """A stand-in for nvcc's Popen: 'compiles' for ``seconds``, then writes
    the ``.tmp`` output and exits 0."""

    def __init__(self, so, seconds):
        self.so, self.done_at, self.returncode = so, time.monotonic() + seconds, None

    def poll(self):
        if self.returncode is None and time.monotonic() >= self.done_at:
            with open(self.so + ".tmp", "w") as f:
                f.write("stub")
            self.returncode = 0
        return self.returncode


def test_load_op_from_two_threads_starts_one_build(tmp_path, monkeypatch):
    starts = []

    def start(name, so, log):
        starts.append(name)
        return _Proc(so, 0.2)

    monkeypatch.setattr(builder, "_BUILD", str(tmp_path))
    monkeypatch.setattr(builder, "_start", start)
    monkeypatch.setattr(builder, "_cache", {})
    monkeypatch.setattr(builder, "build_log", {})
    monkeypatch.setattr(builder, "build_seconds", {})
    monkeypatch.setattr(builder, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: ("lib", path)))
    gate = threading.Barrier(2)
    libs = []

    def worker():
        gate.wait()
        libs.append(builder.load_op("paged_attention"))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert starts == ["paged_attention"]
    assert len(libs) == 2 and libs[0] is libs[1]
    assert libs[0][1] == builder._so_path("paged_attention")
    assert list(builder._cache) == ["paged_attention"]
    # a later call, and a build() of the built source, start nothing
    assert builder.load_op("paged_attention") is libs[0]
    assert builder.build(["paged_attention"]) == [libs[0][1]]
    assert starts == ["paged_attention"]
