"""The port's bounded CUDA probe (``pwasm_tpu_torch/utils/backend.py``):
the reference's tests/test_backend_probe.py cases (caching, the TTL, the
opt-out and the marker's trust checks) on the CUDA probe, with the
probe's subprocess stubbed, so no test touches a card; then the gate's
order in ``device.py::resolve_device`` and ``--device=cpu``, which never
probes."""

import io
import os
import subprocess

import pytest
import torch

import pwasm_tpu_torch.utils.backend as B
from pwasm_tpu_torch import device as devmod
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.core.errors import PwasmError
from pwasm_tpu_torch.utils.runstats import RunStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# captured before the autouse fixture below swaps it out per test
_REAL_SUCCESS_MARKER = B._success_marker


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Isolate every test: no in-process cache, a private marker path,
    no CUDA context in this process, and the probe on."""
    monkeypatch.setattr(B, "_probe_cache", None)
    marker = tmp_path / "marker"
    monkeypatch.setattr(B, "_success_marker", lambda: str(marker))
    monkeypatch.setattr(B, "_backend_already_initialized", lambda: False)
    monkeypatch.delenv("PWASM_DEVICE_PROBE", raising=False)
    monkeypatch.delenv("PWASM_DEVICE_PROBE_TTL", raising=False)
    yield marker


def _fake_run(returncode=0, stdout="PLATFORM=cuda:1\n", stderr="",
              raises=None, seen=None):
    def fake(argv, env, capture_output, timeout, text):
        if seen is not None:
            seen.append((argv, timeout))
        if raises is not None:
            raise raises
        return subprocess.CompletedProcess(argv, returncode, stdout, stderr)
    return fake


def test_probe_subprocess_asks_for_a_context_and_a_kernel(monkeypatch):
    """``probe_backend`` runs one bounded subprocess that makes a CUDA
    context and runs a reduction there; its answers: a platform, the
    child's stderr, or a hang."""
    seen = []
    monkeypatch.setattr(B.subprocess, "run", _fake_run(seen=seen))
    assert B.probe_backend({}, 7.0) == ("cuda", "")
    (argv, timeout), = seen
    assert timeout == 7.0 and "torch.zeros(1, device='cuda')" in argv[-1]
    assert "import jax" not in argv[-1]
    monkeypatch.setattr(B.subprocess, "run", _fake_run(
        returncode=1, stdout="", stderr="RuntimeError: no CUDA GPUs"))
    assert B.probe_backend({}, 7.0) == (None, "RuntimeError: no CUDA GPUs")
    monkeypatch.setattr(B.subprocess, "run", _fake_run(
        raises=subprocess.TimeoutExpired("python", 7.0)))
    assert B.probe_backend({}, 7.0) == (None, "probe hang (> 7s)")
    monkeypatch.setenv("PWASM_DEVICE_PROBE_TIMEOUT", "2.5")
    assert B.probe_timeout() == 2.5


def test_probe_failure_demotes_and_caches(monkeypatch, _fresh):
    calls = []

    def probe(env, timeout):
        calls.append(1)
        return None, "probe hang (> 1s)"

    monkeypatch.setattr(B, "probe_backend", probe)
    ok, why = B.device_backend_reachable()
    assert not ok and "hang" in why
    ok2, _ = B.device_backend_reachable()
    assert not ok2
    assert len(calls) == 1          # verdict cached within the TTL
    assert not os.path.exists(_fresh)   # failure writes no marker


def test_probe_success_writes_marker_and_skips_reprobe(monkeypatch,
                                                       _fresh):
    calls = []

    def probe(env, timeout):
        calls.append(1)
        return "cuda", ""

    monkeypatch.setattr(B, "probe_backend", probe)
    assert B.device_backend_reachable() == (True, "")
    assert os.path.exists(_fresh)
    # a second process (fresh in-process cache) trusts the marker
    monkeypatch.setattr(B, "_probe_cache", None)
    monkeypatch.setattr(
        B, "probe_backend",
        lambda *a: (_ for _ in ()).throw(AssertionError("re-probed")))
    before = dict(B.probe_counters)
    assert B.device_backend_reachable() == (True, "")
    assert len(calls) == 1
    assert B.probe_counters["warm_hits"] == before["warm_hits"] + 1


def test_failed_verdict_recovers_after_ttl(monkeypatch, _fresh):
    monkeypatch.setenv("PWASM_DEVICE_PROBE_TTL", "100")
    now = [1000.0]
    monkeypatch.setattr(B, "probe_backend", lambda *a: (None, "down"))
    import time as _time

    monkeypatch.setattr(_time, "time", lambda: now[0])
    assert not B.device_backend_reachable()[0]
    # the card comes back; the verdict flips only after the TTL expires
    monkeypatch.setattr(B, "probe_backend", lambda *a: ("cuda", ""))
    assert not B.device_backend_reachable()[0]   # still cached
    now[0] += 200.0
    assert B.device_backend_reachable()[0]       # re-probed, healthy


def test_probe_opt_out(monkeypatch, _fresh):
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    monkeypatch.setattr(
        B, "probe_backend",
        lambda *a: (_ for _ in ()).throw(AssertionError("probed")))
    assert B.device_backend_reachable() == (True, "")


def test_initialized_backend_skips(monkeypatch, _fresh):
    monkeypatch.setattr(B, "_backend_already_initialized", lambda: True)
    monkeypatch.setattr(
        B, "probe_backend",
        lambda *a: (_ for _ in ()).throw(AssertionError("probed")))
    assert B.device_backend_reachable() == (True, "")


def test_untrusted_marker_falls_through_to_probe(monkeypatch, _fresh,
                                                 tmp_path):
    """A symlink or a foreign-uid file at the marker path is not
    trusted: the gate re-probes instead."""
    calls = []

    def probe(env, timeout):
        calls.append(1)
        return "cuda", ""

    monkeypatch.setattr(B, "probe_backend", probe)
    target = tmp_path / "planted"
    target.write_text("")
    os.symlink(target, _fresh)
    monkeypatch.setattr(B, "_probe_cache", None)
    assert B.device_backend_reachable() == (True, "")
    assert len(calls) == 1          # symlink ignored, real probe ran

    # a foreign-uid regular file is equally untrusted
    os.unlink(_fresh)
    _fresh.write_text("")
    real_lstat = os.lstat

    class _St:
        def __init__(self, st):
            self.st_mode = st.st_mode
            self.st_uid = st.st_uid + 1
            self.st_mtime = st.st_mtime

    monkeypatch.setattr(
        B.os, "lstat",
        lambda p: _St(real_lstat(p)) if str(p) == str(_fresh)
        else real_lstat(p))
    monkeypatch.setattr(B, "_probe_cache", None)
    assert B.device_backend_reachable() == (True, "")
    assert len(calls) == 2          # foreign file ignored, re-probed


def test_untrusted_marker_is_removed_so_cache_recovers(monkeypatch,
                                                       _fresh, tmp_path):
    calls = []
    monkeypatch.setattr(B, "probe_backend",
                        lambda *a: (calls.append(1), ("cuda", ""))[1])
    target = tmp_path / "planted2"
    target.write_text("")
    os.symlink(target, _fresh)
    assert B.device_backend_reachable() == (True, "")
    assert len(calls) == 1
    assert os.path.exists(_fresh) and not os.path.islink(_fresh)
    monkeypatch.setattr(B, "_probe_cache", None)
    assert B.device_backend_reachable() == (True, "")
    assert len(calls) == 1


def test_marker_dir_mode_is_tightened(monkeypatch, tmp_path):
    """``makedirs(mode=0o700)`` does not tighten a pre-existing marker
    directory: a group/world-accessible one we own is chmod'd back to
    0700 (or the cache refused) before any marker inside it is
    trusted."""
    import stat as _stat
    import tempfile

    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    d = tmp_path / f"pwasm_torch_probe_{B._marker_uid()}"
    d.mkdir(mode=0o777)
    os.chmod(d, 0o775)
    marker = _REAL_SUCCESS_MARKER()
    assert marker is not None and marker.startswith(str(d))
    assert _stat.S_IMODE(os.lstat(d).st_mode) == 0o700
    os.chmod(d, 0o775)
    monkeypatch.setattr(B.os, "chmod",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("nope")))
    assert _REAL_SUCCESS_MARKER() is None


# ---------------------------------------------------------------------------
# the gate in device.py::resolve_device
# ---------------------------------------------------------------------------
def test_device_cpu_never_probes(monkeypatch, tmp_path):
    monkeypatch.setattr(
        B, "probe_backend",
        lambda *a: (_ for _ in ()).throw(AssertionError("probed")))
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: (_ for _ in ()).throw(
                            AssertionError("asked for CUDA")))
    st = RunStats()
    assert devmod.resolve_device("cpu", st) == torch.device("cpu")
    assert (st.backend_probes, st.backend_warm_hits) == (0, 0)
    # a whole CLI run on the CPU: no probe, backend block 0
    import shutil

    for name in ("in.paf", "q.fa"):
        shutil.copy(os.path.join(REPO, "tests", "golden", name), tmp_path)
    err = io.StringIO()
    assert run([str(tmp_path / "in.paf"), "-r", str(tmp_path / "q.fa"),
                "-o", str(tmp_path / "r.dfa"), "--device=cpu",
                f"--stats={tmp_path / 'st.json'}"], stderr=err) == 0
    import json

    assert json.loads((tmp_path / "st.json").read_text())["backend"] \
        == {"probes": 0, "warm_hits": 0}


def test_resolve_device_probes_before_the_context(monkeypatch):
    """``is_available``, then the bounded probe, then
    ``current_device`` (which makes this process's context): a failed
    probe exits 1 naming its diagnostic and never makes the context;
    a healthy one is counted into ``backend.*``."""
    order = []
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: order.append("available") or True)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: order.append("context") or 0)
    def probe(answer):
        def fake(env, timeout):
            B.probe_counters["probes"] += 1     # as the real one counts
            order.append("probe")
            return answer
        return fake

    monkeypatch.setattr(B, "probe_backend",
                        probe((None, "probe hang (> 150s)\n")))
    st = RunStats()
    with pytest.raises(PwasmError) as ei:
        devmod.resolve_device("cuda", st)
    assert ei.value.exit_code == 1
    assert "the CUDA probe failed (probe hang (> 150s))" in str(ei.value)
    assert order == ["available", "probe"]
    assert (st.backend_probes, st.backend_warm_hits) == (1, 0)
    # healthy: probed once, then the context; the next run is warm
    order.clear()
    monkeypatch.setattr(B, "_probe_cache", None)
    monkeypatch.setattr(B, "probe_backend", probe(("cuda", "")))
    st = RunStats()
    assert devmod.resolve_device("cuda", st) == torch.device("cuda", 0)
    assert order == ["available", "probe", "context"]
    assert (st.backend_probes, st.backend_warm_hits) == (1, 0)
    st = RunStats()
    devmod.resolve_device("cuda", st)
    assert (st.backend_probes, st.backend_warm_hits) == (0, 1)
    # no CUDA at all: the usage error before any probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    order.clear()
    with pytest.raises(PwasmError, match="--device=cpu"):
        devmod.resolve_device("cuda")
    assert order == []
