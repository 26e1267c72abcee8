"""The kernel libraries' loader (``pwasm_tpu_torch/ops/_build.py``) under
concurrency: the serve daemon's worker threads may reach one kernel
wrapper at once on a fresh build directory.  Each library is built
once, no thread sees a bound cache with an entry point missing, and two
threads building one source write two different temporary files."""

import os
import sys
import threading
import time

import pytest

from pwasm_tpu_torch.ops import _build


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    """What ``ctypes.CDLL`` returns: one attribute per C entry point."""

    def __init__(self, path):
        self.path = path
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        time.sleep(0.002)           # widen the window between entries
        return self.fns.setdefault(name, _FakeFn())


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FIRST", {})
    builds: list = []

    def slow_build(names=None):
        builds.append(list(names))
        time.sleep(0.2)
        return {n: 0.2 for n in names}

    monkeypatch.setattr(_build, "build_all", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(_build, "lib_path", lambda name: f"/x/lib{name}.so")
    return builds


@pytest.mark.parametrize("n_threads", [2, 8])
def test_threads_binding_one_library_build_it_once(fresh, n_threads):
    sigs = {f"pw_fn{k}": ([], None) for k in range(12)}
    cache: dict = {}
    seen: list = []
    barrier = threading.Barrier(n_threads)

    def worker():
        barrier.wait(5)
        got = _build.bind("demo", sigs, cache)
        # what the thread sees the moment bind returns: every entry
        seen.append(sorted(got))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # switch threads as often as can be
    try:
        ts = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert fresh == [["demo"]]
    assert seen == [sorted(sigs)] * n_threads
    assert len(_build._LIBS) == 1


def test_two_libraries_build_at_once(fresh, monkeypatch):
    """Two jobs that first need two different kernels build them at
    once: each build waits for the other to start, which passes only
    when neither holds a lock the other needs."""
    both = threading.Barrier(2)

    def meeting_build(names=None):
        fresh.append(list(names))
        both.wait(5)
        return {n: 0.0 for n in names}

    monkeypatch.setattr(_build, "build_all", meeting_build)
    caches = {"a": {}, "b": {}}
    errors: list = []

    def worker(name):
        try:
            _build.bind(name, {"pw_x": ([], None)}, caches[name])
        except Exception as e:          # a broken barrier: serialized
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(n,)) for n in caches]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert not errors
    assert sorted(map(tuple, fresh)) == [("a",), ("b",)]
    assert all(list(c) == ["pw_x"] for c in caches.values())


def test_build_temporaries_differ_between_threads(monkeypatch, tmp_path):
    """``build_all``'s temporary file names the process and the thread:
    two threads building one missing library run two nvcc processes
    into two files."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "lib_path",
                        lambda name: str(tmp_path / f"lib{name}.so"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/bin/nvcc")
    outs: list = []
    lock = threading.Lock()

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            tmp = cmd[cmd.index("-o") + 1]
            with lock:
                outs.append(tmp)
            with open(tmp, "w") as f:
                f.write("lib")

        def communicate(self):
            time.sleep(0.05)
            return "", None

    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    barrier = threading.Barrier(2)

    def worker():
        barrier.wait(5)
        _build.build_all(["consensus"])

    ts = [threading.Thread(target=worker) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert len(outs) == 2 and outs[0] != outs[1]
    assert all(f".{os.getpid()}." in o for o in outs)
    assert os.path.exists(tmp_path / "libconsensus.so")
    assert not any(os.path.exists(o) for o in outs)
