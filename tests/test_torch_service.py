"""The port's warm-pool service (``pwasm_tpu_torch/service/``) against
the JAX package's, on the CPU.

Ports of ``tests/test_service.py`` and ``tests/test_protocol_fuzz.py``:
the queue and the protocol, an in-process daemon on a background thread
(as the reference's ``_daemon()`` fixture) and ``serve`` as a process,
every job at ``--device=cpu``.  Every served job's outputs are held to
the port's cold run and to ``pwasm_tpu.cli --device=cpu``'s cold run,
byte for byte.  The port's daemon answers one scripted frame sequence
as the reference's does, once the fields that carry walls, timestamps
or the packages' own run counters are masked (``MASKED``).  A frame
nested past the protocol's depth bound answers ``bad_json`` in band.
"""

import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu_torch import corpus
from pwasm_tpu_torch.cli import _load_checkpoint, run
from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
from pwasm_tpu_torch.resilience.lifecycle import SignalDrain
from pwasm_tpu_torch.service import protocol
from pwasm_tpu_torch.service.client import ServiceClient, wait_for_socket
from pwasm_tpu_torch.service.daemon import Daemon
from pwasm_tpu_torch.service.queue import (Draining, Job, JobQueue,
                                           QueueFull, ServiceStats)

from helpers import make_paf_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a deterministic SLOW job: every supervised device call sleeps 0.25 s
# (an injected hang with no deadline) — bytes unchanged, wall stretched,
# so the cancel/drain/disconnect tests have a live mid-run window
SLOW = "--inject-faults=seed=1,rate=1,kinds=hang,hang_s=0.25"


def _corpus(tmp_path, n=24, qlen=120, seed=3):
    rng = np.random.default_rng(seed)
    q = "".join("ACGT"[i] for i in rng.integers(0, 4, qlen))
    lines = []
    for i in range(n):
        cut = 10 + int(rng.integers(0, qlen - 40))
        qb = q[cut]
        tb = "ACGT"[("ACGT".index(qb) + 1) % 4]
        ops = [("=", cut), ("*", tb, qb), ("=", 20), ("ins", "gg"),
               ("=", qlen - cut - 21)]
        lines.append(make_paf_line("q", q, f"asm{i}", "+", ops)[0])
    fa = tmp_path / "q.fa"
    write_fasta(str(fa), [("q", q.encode())])
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa)


def _job_args(tmp_path, tag, paf, fa, extra=()):
    return [paf, "-r", fa, "-o", str(tmp_path / f"{tag}.dfa"),
            "--device=cpu", "--batch=2",
            f"--stats={tmp_path / f'{tag}.json'}"] + list(extra)


def _cold(tmp_path, tag, paf, fa, extra=()):
    """The port's cold run of the job, held to the reference's cold
    ``--device=cpu`` run; its report bytes."""
    err = io.StringIO()
    rc = run(_job_args(tmp_path, tag, paf, fa, extra), stderr=err)
    assert rc == 0, err.getvalue()[:2000]
    err = io.StringIO()
    assert ref_run(_job_args(tmp_path, f"{tag}_ref", paf, fa, extra),
                   stderr=err) == 0, err.getvalue()[:2000]
    got = (tmp_path / f"{tag}.dfa").read_bytes()
    assert got == (tmp_path / f"{tag}_ref.dfa").read_bytes()
    return got


@contextmanager
def _daemon(cls=Daemon, **kw):
    """An in-process daemon on a short-lived socket (serve() runs on a
    background thread; SignalDrain.install is a no-op there, so the
    drain is driven via drain.request / the protocol command — the same
    flag the main-thread SIGTERM handler pulls)."""
    sockdir = tempfile.mkdtemp(prefix="pwsvc")
    sock = os.path.join(sockdir, "s")
    err = io.StringIO()
    dm = cls(sock, stderr=err, **kw)
    rcbox: list = []
    t = threading.Thread(target=lambda: rcbox.append(dm.serve()),
                         daemon=True)
    t.start()
    assert wait_for_socket(sock, 15), err.getvalue()
    try:
        yield SimpleNamespace(daemon=dm, sock=sock, rc=rcbox, err=err,
                              thread=t)
    finally:
        if not dm.drain.requested:
            dm.drain.request("test teardown")
        t.join(20)
        shutil.rmtree(sockdir, ignore_errors=True)


def _submit_and_wait(sock, argv, timeout=120):
    with ServiceClient(sock) as c:
        sub = c.submit(argv)
        assert sub.get("ok"), sub
        return c.result(sub["job_id"], timeout=timeout)


def _wait_mid_run(client, job_id, ckpt_path, budget_s=60):
    """Block until ``job_id`` is running with at least one durable batch
    checkpoint on disk."""
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        state = client.status(job_id)["job"]["state"]
        if state == "running" and os.path.exists(ckpt_path):
            return True
        if state not in ("queued", "running"):
            return False
        time.sleep(0.02)
    return False


def _raw_conn(sock_path):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(10)
    s.connect(sock_path)
    return s


# ---------------------------------------------------------------------------
# queue + protocol units
# ---------------------------------------------------------------------------
def test_job_queue_admission_and_drain_unit():
    q = JobQueue(max_queue=2)
    j1, j2, j3 = (Job(id=f"j{i}", argv=["x"]) for i in (1, 2, 3))
    assert q.submit(j1) == 0
    assert q.submit(j2) == 1
    with pytest.raises(QueueFull):
        q.submit(j3)
    assert q.depth() == 2
    assert q.take(0.01) is j1          # FIFO
    assert q.remove(j2) and not q.remove(j2)
    assert q.submit(j3) == 0
    waiting = q.drain()
    assert waiting == [j3]
    assert q.draining and q.depth() == 0
    with pytest.raises(Draining):
        q.submit(Job(id="j4", argv=["x"]))
    assert q.take(0.01) is None


def test_protocol_frames_roundtrip_and_errors():
    buf = io.BytesIO()
    protocol.write_frame(buf, {"cmd": "ping", "n": 1})
    buf.seek(0)
    assert protocol.read_frame(buf) == {"cmd": "ping", "n": 1}
    assert protocol.read_frame(buf) is None          # clean EOF
    with pytest.raises(protocol.FrameError) as e:
        protocol.read_frame(io.BytesIO(b"not json\n"))
    assert e.value.code == protocol.ERR_BAD_JSON
    assert not e.value.fatal                         # conn survives
    with pytest.raises(protocol.FrameError) as e:
        protocol.read_frame(io.BytesIO(b"[1,2]\n"))
    assert e.value.code == protocol.ERR_BAD_JSON
    big = b"{" + b" " * 64 + b"}\n"
    with pytest.raises(protocol.FrameError) as e:
        protocol.read_frame(io.BytesIO(big), max_bytes=32)
    assert e.value.code == protocol.ERR_FRAME_TOO_LARGE
    assert e.value.fatal                             # stream unsynced
    with pytest.raises(protocol.FrameError):
        protocol.read_frame(io.BytesIO(b'{"x":1}'))  # truncated at EOF


def _nested(depth: int) -> bytes:
    """A ping frame whose ``b`` field nests arrays so that the frame's
    deepest level is ``depth`` (the frame's own object is level 1)."""
    k = depth - 1
    return b'{"cmd":"ping","b":' + b"[" * k + b"0" + b"]" * k + b"}\n"


def test_frame_depth_bound():
    """The bound is explicit: a frame at it parses, one level past it
    answers bad_json (not fatal); brackets inside strings do not
    count."""
    bound = protocol.MAX_FRAME_DEPTH
    assert protocol.read_frame(io.BytesIO(_nested(bound)))["cmd"] \
        == "ping"
    with pytest.raises(protocol.FrameError) as e:
        protocol.read_frame(io.BytesIO(_nested(bound + 1)))
    assert e.value.code == protocol.ERR_BAD_JSON and not e.value.fatal
    quoted = b'{"cmd":"ping","s":"' + b"[{" * 4000 + b'"}\n'
    assert protocol.read_frame(io.BytesIO(quoted))["s"].startswith("[{")


def test_json_bomb_answered_in_band():
    """The 4,000-deep bomb of tests/test_protocol_fuzz.py: bad_json in
    band on this Python, and the connection's next frame is served."""
    bomb = _nested(4001)
    with pytest.raises(protocol.FrameError) as ei:
        protocol.read_frame(io.BytesIO(bomb))
    assert ei.value.code == protocol.ERR_BAD_JSON
    assert not ei.value.fatal
    with _daemon(journal_path=None) as h:
        conn = _raw_conn(h.sock)
        try:
            conn.sendall(bomb + _nested(protocol.MAX_FRAME_DEPTH)
                         + b'{"cmd":"ping"}\n')
            rfile = conn.makefile("rb")
            first = json.loads(rfile.readline(1 << 16))
            assert first["ok"] is False
            assert first["error"] == protocol.ERR_BAD_JSON
            assert json.loads(rfile.readline(1 << 16))["ok"] is True
            assert json.loads(rfile.readline(1 << 16))["ok"] is True
        finally:
            conn.close()


def test_service_stats_rollup_skips_versions_and_bools():
    st = ServiceStats()
    st.rollup_job({"stats_version": 1, "alignments": 3,
                   "preempted": True,
                   "backend": {"probes": 1, "warm_hits": 0}})
    st.rollup_job({"stats_version": 1, "alignments": 2,
                   "preempted": False,
                   "backend": {"probes": 0, "warm_hits": 1}})
    d = st.as_dict()
    assert d["stats_version"] == 1
    assert d["rollup"]["alignments"] == 5
    assert "stats_version" not in d["rollup"]
    assert "preempted" not in d["rollup"]
    assert d["warm"] == {"backend_probes": 1, "backend_warm_hits": 1}


def test_cross_thread_drain_request_only_flags():
    """A drain requested from another thread while an interruptible
    phase is armed only sets the flag: raising PreemptedError in the
    requester (the daemon's thread) would kill the service instead of
    the job."""
    drain = SignalDrain(stderr=io.StringIO(), hard_exit=lambda c: None)
    raised: list = []

    def other():
        try:
            drain.request("from the daemon thread")
        except BaseException as e:   # pragma: no cover - the bug
            raised.append(e)

    with drain.interrupting():
        t = threading.Thread(target=other)
        t.start()
        t.join(5)
    assert not raised
    assert drain.requested


# ---------------------------------------------------------------------------
# protocol edges against a live daemon
# ---------------------------------------------------------------------------
def test_malformed_json_frame_answers_and_connection_survives():
    with _daemon(max_queue=2, journal_path=None) as h:
        s = _raw_conn(h.sock)
        try:
            s.sendall(b"this is not json\n")
            f = s.makefile("rb")
            resp = json.loads(f.readline())
            assert resp["ok"] is False
            assert resp["error"] == protocol.ERR_BAD_JSON
            s.sendall(b'{"cmd":"ping"}\n')
            assert json.loads(f.readline())["ok"] is True
        finally:
            s.close()


def test_oversized_frame_rejected_and_connection_closed():
    with _daemon(max_queue=2, max_frame_bytes=1024,
                 journal_path=None) as h:
        s = _raw_conn(h.sock)
        try:
            s.sendall(b'{"pad":"' + b"x" * 4096 + b'"}\n')
            f = s.makefile("rb")
            resp = json.loads(f.readline())
            assert resp["ok"] is False
            assert resp["error"] == protocol.ERR_FRAME_TOO_LARGE
            assert f.readline() == b""      # the daemon closed it
        finally:
            s.close()
        with ServiceClient(h.sock) as c:
            assert c.ping().get("ok")


def test_unknown_cmd_unknown_job_bad_request():
    with _daemon(max_queue=2, journal_path=None) as h:
        with ServiceClient(h.sock) as c:
            r = c.request({"cmd": "frobnicate"})
            assert r["error"] == protocol.ERR_UNKNOWN_CMD
            r = c.status("job-9999")
            assert r["error"] == protocol.ERR_UNKNOWN_JOB
            r = c.request({"cmd": "submit", "args": "not-a-list"})
            assert r["error"] == protocol.ERR_BAD_REQUEST
            r = c.request({"cmd": "submit", "args": []})
            assert r["error"] == protocol.ERR_BAD_REQUEST
            r = c.submit(["in.paf", "-r", "q.fa"])
            assert r["error"] == protocol.ERR_BAD_REQUEST
            assert "-o" in r["detail"]
            r = c.submit(["serve", "--socket=/x", "-o", "r"])
            assert r["error"] == protocol.ERR_BAD_REQUEST
            # every verb of the reference's daemon is ported: health
            # answers, logs and cache-probe ask for what they need
            assert c.request({"cmd": "health"})["health"]["verdict"] \
                == "ok"
            r = c.request({"cmd": "logs"})
            assert r["error"] == protocol.ERR_BAD_REQUEST
            assert "--log-json" in r["detail"]
            r = c.request({"cmd": "cache-probe"})
            assert r["error"] == protocol.ERR_BAD_REQUEST
            assert "key" in r["detail"]


@pytest.mark.parametrize("flag,later", [
    ("--many2many", None), ("--result-cache=rc", None),
    ("--compile-cache-dir=cc", None), ("--m2m-stream", None)])
def test_later_slice_jobs_refused_at_admission(tmp_path, monkeypatch, flag,
                                               later):
    """No job option is refused at admission for a later slice any more:
    what the later slices brought is admitted and runs (``later`` None)
    — a served ``--many2many`` and ``--m2m-stream``, a job's own
    ``--result-cache`` and ``--compile-cache-dir`` — and is journaled."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    paf, fa = _corpus(tmp_path, n=4)
    journal = str(tmp_path / "j.journal")
    argv = _job_args(tmp_path, "lt", paf, fa, [flag])
    if flag in ("--many2many", "--m2m-stream"):
        (tmp_path / "t.fa").write_text(">t\nACGTACGTAC\n")
        argv = [flag, str(tmp_path / "t.fa"), "-r", fa, "-o",
                str(tmp_path / "lt.dfa"), "--device=cpu"]
    elif later is None:
        argv = [a if not a.startswith("--" + flag[2:].split("=")[0])
                else f"{flag.split('=')[0]}={tmp_path / 'x'}"
                for a in argv]
    with _daemon(journal_path=journal) as h:
        with ServiceClient(h.sock) as c:
            r = c.submit(argv)
            assert later is None and r["ok"] is True, r
            res = c.result(r["job_id"], timeout=120)
            assert res["rc"] == 0, res
        with open(journal) as f:
            assert '"admit"' in f.read()
    assert (tmp_path / "lt.dfa").exists()


# ---------------------------------------------------------------------------
# the warm-pool promise: parity, concurrency, lane state
# ---------------------------------------------------------------------------
def test_warm_jobs_byte_identical(tmp_path):
    paf, fa = _corpus(tmp_path)
    cold = _cold(tmp_path, "cold", paf, fa)
    with _daemon(max_queue=4, journal_path=None) as h:
        for j in (1, 2, 3):
            res = _submit_and_wait(
                h.sock, _job_args(tmp_path, f"warm{j}", paf, fa))
            assert res.get("ok") and res["rc"] == 0, res
            assert (tmp_path / f"warm{j}.dfa").read_bytes() == cold
            bk = json.loads(
                (tmp_path / f"warm{j}.json").read_text())["backend"]
            # --device=cpu never probes (the card's warm hits: the
            # serve phase of chip_smoke.py)
            assert bk == {"probes": 0, "warm_hits": 0}
        with ServiceClient(h.sock) as c:
            st = c.stats()["stats"]
        assert st["jobs"]["accepted"] == 3
        assert st["jobs"]["completed"] == 3
        assert st["rollup"]["alignments"] == 72


def test_relative_paths_resolve_against_client_cwd(tmp_path):
    """A cold run resolves relative paths against the caller's cwd, so
    a served job does too (the client sends its cwd; the daemon rewrites
    the argv with the CLI's own grammar, clustered short flags
    included)."""
    paf, fa = _corpus(tmp_path, n=6)
    cold = _cold(tmp_path, "cold", paf, fa)
    with _daemon(max_queue=4, journal_path=None) as h:
        with ServiceClient(h.sock) as c:
            sub = c.submit(["in.paf", "-r", "q.fa", "-Do", "rel.dfa",
                            "--stats=rel.json", "--device=cpu",
                            "--batch=2"], cwd=str(tmp_path))
            assert sub.get("ok"), sub
            res = c.result(sub["job_id"], timeout=120)
            assert res.get("ok") and res["rc"] == 0, res
        assert (tmp_path / "rel.dfa").read_bytes() == cold
        assert (tmp_path / "rel.json").exists()
        with ServiceClient(h.sock) as c:
            r = c.request({"cmd": "submit",
                           "args": ["in.paf", "-r", "q.fa", "-o",
                                    "x.dfa"],
                           "cwd": "relative/dir"})
            assert r["error"] == protocol.ERR_BAD_REQUEST


def test_two_concurrent_submitters_byte_identical(tmp_path):
    """Two lanes, two jobs at once (one with --realign): each equals its
    cold run in both packages."""
    paf, fa = _corpus(tmp_path)
    cold = {"ca": _cold(tmp_path, "cold_a", paf, fa),
            "cb": _cold(tmp_path, "cold_b", paf, fa,
                        ["--realign", f"-w{tmp_path / 'cold_b.mfa'}"])}
    want_mfa = (tmp_path / "cold_b.mfa").read_bytes()
    results: dict = {}
    extra = {"ca": [], "cb": ["--realign", f"-w{tmp_path / 'cb.mfa'}"]}

    def submitter(tag, sock):
        results[tag] = _submit_and_wait(
            sock, _job_args(tmp_path, tag, paf, fa, extra[tag]))

    with _daemon(max_queue=4, max_concurrent=2, lanes=2,
                 journal_path=None) as h:
        ts = [threading.Thread(target=submitter, args=(t, h.sock))
              for t in ("ca", "cb")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        lanes = {row["lane"]: row["jobs_run"]
                 for row in h.daemon.leases.lane_states()}
    for tag in ("ca", "cb"):
        assert results[tag].get("ok") and results[tag]["rc"] == 0, \
            results[tag]
        assert (tmp_path / f"{tag}.dfa").read_bytes() == cold[tag]
    assert (tmp_path / "cb.mfa").read_bytes() == want_mfa
    assert sum(lanes.values()) == 2


def test_lane_supervisor_state_carried_like_the_reference(tmp_path,
                                                          monkeypatch):
    """The supervisor's state rides the lane from job to job: an
    injected OOM demotes the lane's bucket ceiling, and the next jobs on
    the lane start from it (their end state is not a fresh run's).  The
    port's daemon leaves the same lane state after each job as the
    reference's (its jobs at --device=tpu --fallback=fail
    --recover=off, neither degrading); every report equals both cold
    runs."""
    from pwasm_tpu_torch.service.daemon import WarmContext

    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    paf, fa = _corpus(tmp_path)
    cold = _cold(tmp_path, "cold", paf, fa)
    seq = [["--inject-faults=oom=2"], [], []]
    states: dict = {}
    for who, cls, dev in (("port", Daemon, []),
                          ("ref", None, ["--fallback=fail",
                                         "--recover=off"])):
        if cls is None:
            from pwasm_tpu.service.daemon import Daemon as cls
        states[who] = []
        with _daemon(cls, max_queue=4, journal_path=None) as h:
            for k, extra in enumerate(seq):
                args = _job_args(tmp_path, f"{who}{k}", paf, fa,
                                 extra + dev)
                if who == "ref":
                    args = [a.replace("--device=cpu", "--device=tpu")
                            for a in args]
                res = _submit_and_wait(h.sock, args)
                assert res["rc"] == 0, res
                assert (tmp_path / f"{who}{k}.dfa").read_bytes() == cold
                lane = h.daemon.leases._leases[0]
                states[who].append(dict(lane.supervisor_state))
    assert states["port"] == states["ref"]
    assert states["port"][0]["bucket_ceiling"] is not None
    assert "fault_calls" not in states["port"][0]
    fresh = WarmContext()
    assert run(_job_args(tmp_path, "fresh", paf, fa), warm=fresh,
               stderr=io.StringIO()) == 0
    assert states["port"][1] != fresh.supervisor_state


def test_realistic_shape_three_jobs_parity(tmp_path):
    """The realistic corpus's shape cut to 40 alignments as three
    consecutive jobs with all six outputs: each equal to the port's and
    the reference's cold runs."""
    q, lines = corpus.make_corpus(n_aln=40, asm_lo=4000, asm_hi=9000)
    fa = tmp_path / "cds.fa"
    fa.write_text(f">cds1\n{q}\n")
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    kinds = ("dfa", "sum", "mfa", "ace", "info", "cons")

    def args(tag):
        p = tmp_path / tag
        return [str(paf), "-r", str(fa), "-o", f"{p}.dfa", "-s",
                f"{p}.sum", "-w", f"{p}.mfa", f"--ace={p}.ace",
                f"--info={p}.info", f"--cons={p}.cons", "--device=cpu"]

    def outs(tag):
        return tuple((tmp_path / f"{tag}.{k}").read_bytes()
                     for k in kinds)

    err = io.StringIO()
    assert run(args("cold"), stderr=err) == 0, err.getvalue()[:2000]
    assert ref_run(args("ref"), stderr=err) == 0, err.getvalue()[:2000]
    assert outs("cold") == outs("ref")
    with _daemon(max_queue=4, journal_path=None) as h:
        for j in (1, 2, 3):
            res = _submit_and_wait(h.sock, args(f"sv{j}"), timeout=600)
            assert res.get("ok") and res["rc"] == 0, res
            assert outs(f"sv{j}") == outs("cold"), j


def test_stream_job_byte_identical(tmp_path):
    """A stream job fed in uneven chunks (most split inside a line)
    equals the cold run of the whole file."""
    paf, fa = _corpus(tmp_path)
    cold = _cold(tmp_path, "cold", paf, fa)
    text = open(paf).read()
    rng = np.random.default_rng(4)
    cuts = sorted(rng.choice(np.arange(1, len(text)), 9, replace=False))
    chunks = [text[a:b] for a, b in zip([0, *cuts], [*cuts, len(text)])]
    with _daemon(journal_path=None) as h:
        with ServiceClient(h.sock) as c:
            args = _job_args(tmp_path, "st", paf, fa)[1:]
            resp = c.stream(args, chunks)
            assert resp.get("ok"), resp
            res = c.result(resp["job_id"], timeout=120)
            assert res["rc"] == 0, res
            st = c.stats()["stats"]
    assert (tmp_path / "st.dfa").read_bytes() == cold
    assert st["streams"]["records_in"] == 24


# ---------------------------------------------------------------------------
# admission control + cancel + drain
# ---------------------------------------------------------------------------
def test_queue_full_rejection_is_429_shaped(tmp_path):
    paf, fa = _corpus(tmp_path, n=16)
    with _daemon(max_queue=1, max_concurrent=1, journal_path=None) as h:
        with ServiceClient(h.sock) as c:
            s1 = c.submit(_job_args(tmp_path, "s1", paf, fa, [SLOW]))
            assert s1.get("ok"), s1
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if c.status(s1["job_id"])["job"]["state"] == "running":
                    break
                time.sleep(0.02)
            s2 = c.submit(_job_args(tmp_path, "s2", paf, fa))
            assert s2.get("ok"), s2
            rej = c.submit(_job_args(tmp_path, "s3", paf, fa))
            assert rej["ok"] is False
            assert rej["error"] == protocol.ERR_QUEUE_FULL
            assert rej["retry_after_s"] > 0
            assert rej["max_queue"] == 1
            r1 = c.result(s1["job_id"], timeout=120)
            assert r1["rc"] == 0, r1
            s3 = c.submit(_job_args(tmp_path, "s3", paf, fa))
            assert s3.get("ok"), s3
            assert c.result(s3["job_id"], timeout=120)["rc"] == 0
        with ServiceClient(h.sock) as c:
            st = c.stats()["stats"]
        assert st["jobs"]["rejected"] == 1


def test_cancel_queued_vs_running(tmp_path):
    paf, fa = _corpus(tmp_path)
    cold = _cold(tmp_path, "cold", paf, fa)
    with _daemon(max_queue=4, max_concurrent=1, journal_path=None) as h:
        with ServiceClient(h.sock) as c:
            slow = c.submit(_job_args(tmp_path, "run", paf, fa,
                                      [SLOW]))
            queued = c.submit(_job_args(tmp_path, "qd", paf, fa))
            assert _wait_mid_run(c, slow["job_id"],
                                 str(tmp_path / "run.dfa.ckpt"))
            r = c.cancel(queued["job_id"])
            assert r["ok"] and r["was"] == "queued"
            assert c.status(queued["job_id"])["job"]["state"] \
                == "cancelled"
            assert not (tmp_path / "qd.dfa").exists()
            r = c.cancel(slow["job_id"])
            assert r["ok"] and r["was"] == "running"
            res = c.result(slow["job_id"], timeout=120)
            assert res["job"]["state"] == "cancelled", res
            assert res["rc"] == EXIT_PREEMPTED
    assert isinstance(_load_checkpoint(str(tmp_path / "run.dfa")), tuple)
    err = io.StringIO()
    rc = run(_job_args(tmp_path, "run", paf, fa, ["--resume"]),
             stderr=err)
    assert rc == 0, err.getvalue()[:2000]
    assert (tmp_path / "run.dfa").read_bytes() == cold


def test_drain_finishes_inflight_rejects_new_exits_75(tmp_path):
    """The drain contract (the protocol command; the SIGTERM flavour is
    the subprocess test below): the in-flight job ends at a batch
    boundary with a valid checkpoint and rc 75, the queued job is
    preempted without starting, a submit during the drain answers
    ``draining``, and the daemon exits 75; the preempted job resumes
    to the cold run's bytes."""
    paf, fa = _corpus(tmp_path)
    cold = _cold(tmp_path, "cold", paf, fa)
    with _daemon(max_queue=4, max_concurrent=1, journal_path=None) as h:
        with ServiceClient(h.sock) as c:
            slow = c.submit(_job_args(tmp_path, "infl", paf, fa,
                                      [SLOW]))
            queued = c.submit(_job_args(tmp_path, "quep", paf, fa))
            assert _wait_mid_run(c, slow["job_id"],
                                 str(tmp_path / "infl.dfa.ckpt"))
            d = c.drain()
            assert d["ok"] and d["draining"]
            assert queued["job_id"] in d["preempted_queued"]
            rej = c.submit(_job_args(tmp_path, "late", paf, fa))
            assert rej["ok"] is False
            assert rej["error"] == protocol.ERR_DRAINING
            res = c.result(slow["job_id"], timeout=120)
            assert res["job"]["state"] == "preempted", res
            assert res["rc"] == EXIT_PREEMPTED
            qres = c.result(queued["job_id"], timeout=30)
            assert qres["job"]["state"] == "preempted"
            assert "resum" in qres["job"]["detail"]
        h.thread.join(30)
        assert h.rc == [EXIT_PREEMPTED], h.err.getvalue()[-2000:]
    assert isinstance(_load_checkpoint(str(tmp_path / "infl.dfa")),
                      tuple)
    err = io.StringIO()
    rc = run(_job_args(tmp_path, "infl", paf, fa, ["--resume"]),
             stderr=err)
    assert rc == 0, err.getvalue()[:2000]
    assert (tmp_path / "infl.dfa").read_bytes() == cold


def test_client_disconnect_mid_result_never_kills_daemon(tmp_path):
    paf, fa = _corpus(tmp_path)
    cold = _cold(tmp_path, "cold", paf, fa)
    with _daemon(max_queue=4, journal_path=None) as h:
        s = _raw_conn(h.sock)
        f = s.makefile("rb")
        protocol.write_frame(
            s.makefile("wb"),
            {"cmd": "submit",
             "args": _job_args(tmp_path, "dj", paf, fa, [SLOW])})
        sub = json.loads(f.readline())
        assert sub["ok"], sub
        protocol.write_frame(s.makefile("wb"),
                             {"cmd": "result", "job_id": sub["job_id"]})
        s.close()
        with ServiceClient(h.sock) as c:
            res = c.result(sub["job_id"], timeout=120)
        assert res.get("ok") and res["rc"] == 0, res
        assert (tmp_path / "dj.dfa").read_bytes() == cold
        with ServiceClient(h.sock) as c:
            assert c.ping().get("ok")


def test_failed_job_is_contained(tmp_path):
    """A job whose argv is garbage fails, and the daemon survives and
    says why; so does a scripted kill (a BaseException), and a device
    dispatch that keeps failing: it fails its job after its retries and
    is never run another way."""
    paf, fa = _corpus(tmp_path, n=4)
    with _daemon(max_queue=4, journal_path=None) as h:
        res = _submit_and_wait(
            h.sock, ["/nonexistent.paf", "-r", fa, "-o",
                     str(tmp_path / "x.dfa"), "--device=cpu"])
        assert res["job"]["state"] == "failed", res
        assert res["rc"] not in (0, None)
        assert "Cannot open input file" in res["stderr_tail"]
        res = _submit_and_wait(
            h.sock, _job_args(tmp_path, "kill", paf, fa,
                              ["--inject-faults=kill=1"]))
        assert res["job"]["state"] == "failed", res
        assert "InjectedKill" in res["job"]["detail"]
        res = _submit_and_wait(
            h.sock, _job_args(tmp_path, "broken", paf, fa,
                              ["--inject-faults=seed=3,rate=1,"
                               "kinds=raise", "--max-retries=1"]))
        assert res["job"]["state"] == "failed" and res["rc"] == 1, res
        assert "--fallback=fail forbids degrading" in res["stderr_tail"]
        res = _submit_and_wait(h.sock,
                               _job_args(tmp_path, "ok", paf, fa))
        assert res["rc"] == 0, res


def test_cuda_jobs_without_cuda_fail_with_the_device_message(tmp_path):
    """``--device=cuda`` jobs on a box without CUDA fail each with exit
    1 and the device message; nothing runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the test needs a machine without it")
    paf, fa = _corpus(tmp_path, n=4)
    with _daemon(journal_path=None, warmup="cuda") as h:
        for tag in ("c1", "c2"):
            res = _submit_and_wait(
                h.sock, [a.replace("--device=cpu", "--device=cuda")
                         for a in _job_args(tmp_path, tag, paf, fa)])
            assert res["job"]["state"] == "failed" and res["rc"] == 1
            assert "--device=cpu" in res["stderr_tail"]
            assert not (tmp_path / f"{tag}.dfa").exists()
    assert "warmup (cuda) done" in h.err.getvalue()
    assert "(rc 1)" in h.err.getvalue()


# ---------------------------------------------------------------------------
# the port's daemon frame for frame against the reference's
# ---------------------------------------------------------------------------
# fields that carry walls, timestamps or a package's own run counters
# (the reference's --device=cpu takes its host path, the port's runs
# its device programs on the CPU, so their RunStats differ): masked
MASKED = frozenset((
    "submitted_s", "started_s", "finished_s", "uptime_s", "busy_s",
    "wait_s_total", "queue_depth", "expires_in_s", "remaining_s",
    "stats", "rollup", "flight", "metrics", "retry_after_s", "buffered",
    "evaluations"))


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in MASKED else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _families(exposition: str) -> list[str]:
    return [ln for ln in exposition.splitlines()
            if ln.startswith("# TYPE ")]


def _scripted(sock: str, d: str) -> list[dict]:
    """One frame sequence on one connection: pings, malformed and
    refused frames, a submit, its status/result/inspect/cancel, a
    stream job, the fence verbs, stats and metrics, the drain."""
    job = ["in.paf", "-r", "q.fa", "-o", "r.dfa", "--device=cpu",
           "--batch=2"]
    frames = [
        {"cmd": "ping"}, {"cmd": "frobnicate"},
        {"cmd": "status", "job_id": "job-9999"},
        {"cmd": "submit", "args": "not-a-list"},
        {"cmd": "submit", "args": []},
        {"cmd": "submit", "args": ["in.paf", "-r", "q.fa"], "cwd": d},
        {"cmd": "submit", "args": ["serve", "--socket=/x", "-o", "r"]},
        {"cmd": "submit", "args": job, "cwd": "relative/dir"},
        {"cmd": "submit", "args": job, "cwd": d, "client": "alice",
         "priority": "gold"},
        {"cmd": "submit", "args": job, "cwd": d, "client": "alice",
         "trace_id": "bad id!"},
        {"cmd": "submit", "args": job, "cwd": d, "client": "alice",
         "trace_id": "drill.1"},
        {"cmd": "result", "job_id": "job-0001", "timeout": 60},
        {"cmd": "status", "job_id": "job-0001"},
        {"cmd": "inspect", "job_id": "job-0001"},
        {"cmd": "cancel", "job_id": "job-0001"},
        {"cmd": "stream", "args": ["-r", "q.fa", "-o", "s.dfa",
                                   "--device=cpu", "--batch=2"],
         "cwd": d, "client": "bob", "trace_id": "drill.2"}]
    paf = open(os.path.join(d, "in.paf")).read()
    out = []
    with ServiceClient(sock) as c:
        for fr in frames:
            out.append(c.request(dict(fr)))
        jid = out[-1]["job_id"]
        half = len(paf) // 2 + 7
        for chunk in (paf[:half], paf[half:]):
            out.append(c.request({"cmd": "stream-data", "job_id": jid,
                                  "data": chunk}))
        out.append(c.request({"cmd": "stream-end", "job_id": jid}))
        out.append(c.request({"cmd": "result", "job_id": jid,
                              "timeout": 60}))
        out.append(c.request({"cmd": "stream-data", "job_id": jid,
                              "data": "x"}))
        for fr in ({"cmd": "lease-grant", "epoch": 3, "ttl_s": 600},
                   {"cmd": "lease-grant", "epoch": 2, "ttl_s": 600},
                   {"cmd": "fence", "reason": "drill"},
                   {"cmd": "submit", "args": job, "cwd": d},
                   {"cmd": "lease-grant", "epoch": 3, "ttl_s": 600},
                   {"cmd": "stats"}, {"cmd": "metrics"},
                   {"cmd": "drain"}):
            out.append(c.request(dict(fr)))
    return out


def test_scripted_frames_equal_the_reference(tmp_path):
    """The same frames to the port's daemon and the reference's (both
    with ``--slo-rules=off``): equal answers once MASKED fields are
    masked (the ``health`` block's evaluation count among them), the
    metrics exposition's families equal, and the jobs' outputs
    equal."""
    paf, fa = _corpus(tmp_path, n=10)
    got = {}
    expo = {}
    for who in ("port", "ref"):
        d = tmp_path / who
        d.mkdir()
        for name in (paf, fa):
            shutil.copy(name, d)
        if who == "port":
            ctx = _daemon(journal_path=None, slo_rules="off")
        else:
            from pwasm_tpu.service.daemon import Daemon as RefDaemon
            ctx = _daemon(RefDaemon, journal_path=None, slo_rules="off")
        with ctx as h:
            frames = _scripted(h.sock, str(d))
            h.thread.join(30)
            assert h.rc == [EXIT_PREEMPTED]
        expo[who] = _families(frames[-2]["metrics"])
        got[who] = [_mask(f) for f in frames]
    for k, (a, b) in enumerate(zip(got["port"], got["ref"])):
        assert a == b, (k, a, b)
    assert len(got["port"]) == len(got["ref"])
    assert expo["port"] == expo["ref"] and len(expo["port"]) > 50
    for name in ("r.dfa", "s.dfa"):
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "ref" / name).read_bytes()


# ---------------------------------------------------------------------------
# subprocess: `serve` + SIGTERM
# ---------------------------------------------------------------------------
def _serve_env():
    old_pp = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PWASM_DEVICE_PROBE="0",
                PYTHONPATH=REPO + (os.pathsep + old_pp if old_pp
                                   else ""))


def test_serve_subprocess_sigterm_drains_exit75_resumable(tmp_path):
    """SIGTERM to a live ``python -m pwasm_tpu_torch serve`` mid-job:
    the daemon exits 75, the job's checkpoint verifies, and a cold
    ``--resume`` completes it byte-identically."""
    paf, fa = _corpus(tmp_path)
    cold = _cold(tmp_path, "cold", paf, fa)
    sockdir = tempfile.mkdtemp(prefix="pwsvc")
    sock = os.path.join(sockdir, "s")
    sp = subprocess.Popen(
        [sys.executable, "-m", "pwasm_tpu_torch", "serve",
         f"--socket={sock}"],
        env=_serve_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        assert wait_for_socket(sock, 60)
        with ServiceClient(sock) as c:
            sub = c.submit(_job_args(tmp_path, "sig", paf, fa, [SLOW]))
            assert sub.get("ok"), sub
            assert _wait_mid_run(c, sub["job_id"],
                                 str(tmp_path / "sig.dfa.ckpt"))
        sp.send_signal(signal.SIGTERM)
        rc = sp.wait(timeout=120)
        assert rc == EXIT_PREEMPTED, (rc, sp.stderr.read()[-3000:])
        assert isinstance(_load_checkpoint(str(tmp_path / "sig.dfa")),
                          tuple)
        assert not os.path.exists(sock + ".journal")   # retired
        err = io.StringIO()
        rc = run(_job_args(tmp_path, "sig", paf, fa, ["--resume"]),
                 stderr=err)
        assert rc == 0, err.getvalue()[:2000]
        assert (tmp_path / "sig.dfa").read_bytes() == cold
    finally:
        if sp.poll() is None:
            sp.kill()
            sp.wait()
        sp.stderr.close()
        shutil.rmtree(sockdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# CLI surface: subcommand dispatch + client mains
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv,says", [
    (["serve"], "--socket"),
    (["serve", "--socket=/x", "--max-queue=frog"], "--max-queue"),
    (["serve", "--socket=/x", "--warmup=tpu"], "must be cuda or cpu"),
    (["serve", "--socket=/x", "--slo-rules=rules.json"],
     "cannot read --slo-rules rules.json"),
    (["serve", "--socket=/x", "--result-cache="],
     "Invalid --result-cache value"),
    (["serve", "--socket=/x", "--compile-cache-dir= "],
     "Invalid --compile-cache-dir value"),
    (["serve", "--socket=/x", "--cache-prefetch=0"],
     "Invalid --cache-prefetch value"),
    (["serve", "--socket=/x", "--rate-limit=0"],
     "Invalid --rate-limit value"),
    (["serve", "--socket=/x", "--tls-cert=c"],
     "--tls-cert and --tls-key must be given together"),
    (["serve", "--socket=/x", "--canary-interval=0"],
     "Invalid --canary-interval value: 0"),
    (["submit"], "--socket"), (["svc-stats"], "--socket"),
    (["submit", "--socket=/x", "--tls-ca=c", "--", "x"],
     "cannot load --tls-ca=c"),
    (["health", "--socket=/x"], "cannot connect"),
    (["logs", "--socket=/x"], "cannot connect"),
    pytest.param(["route", "--socket=/x", "--standby-of=/y"],
                 "--socket/--listen are mutually exclusive",
                 id="argv15-slice A11"),
    (["submit", "--socket=/nonexistent.sock", "--", "x", "-o", "y"],
     "cannot connect")])
def test_cli_dispatch_usage_errors(argv, says):
    err = io.StringIO()
    assert run(argv, stderr=err) == 1
    assert says in err.getvalue()


def test_client_mains(tmp_path, monkeypatch):
    """``submit``, ``stream``, ``inspect``, ``metrics`` and ``svc-stats``
    as the CLI dispatches them."""
    paf, fa = _corpus(tmp_path, n=8)
    cold = _cold(tmp_path, "cold", paf, fa)
    with _daemon(max_queue=4, journal_path=None,
                 log_json=str(tmp_path / "ev.ndjson")) as h:
        out, err = io.StringIO(), io.StringIO()
        rc = run(["submit", f"--socket={h.sock}", "--trace-id=drill.7",
                  "--"] + _job_args(tmp_path, "cm", paf, fa),
                 stdout=out, stderr=err)
        assert rc == 0, err.getvalue()
        line = json.loads(out.getvalue())
        assert line["state"] == "done" and line["rc"] == 0
        assert line["trace_id"] == "drill.7"
        assert (tmp_path / "cm.dfa").read_bytes() == cold
        monkeypatch.setattr(sys, "stdin", io.StringIO(open(paf).read()))
        out = io.StringIO()
        rc = run(["stream", f"--socket={h.sock}", "--"]
                 + _job_args(tmp_path, "sm", paf, fa)[1:], stdout=out,
                 stderr=io.StringIO())
        assert rc == 0 and json.loads(out.getvalue())["state"] == "done"
        assert (tmp_path / "sm.dfa").read_bytes() == cold
        out = io.StringIO()
        assert run(["inspect", f"--socket={h.sock}", line["job_id"]],
                   stdout=out, stderr=io.StringIO()) == 0
        rec = json.loads(out.getvalue())
        assert rec["trace_id"] == "drill.7"
        assert {"queue_wait", "lease_wait", "exec", "run"} \
            <= set(rec["flight"]["phases"])
        out = io.StringIO()
        assert run(["metrics", f"--socket={h.sock}"], stdout=out,
                   stderr=io.StringIO()) == 0
        assert "pwasm_service_jobs_total" in out.getvalue()
        out = io.StringIO()
        rc = run(["svc-stats", f"--socket={h.sock}"], stdout=out,
                 stderr=io.StringIO())
        assert rc == 0
        st = json.loads(out.getvalue())
        assert st["stats_version"] == 1
        assert st["jobs"]["completed"] == 2
        assert st["streams"]["records_in"] == 8
        rc = run(["svc-stats", f"--socket={h.sock}", "--drain"],
                 stdout=io.StringIO(), stderr=io.StringIO())
        assert rc == 0
        h.thread.join(30)
        assert h.rc == [EXIT_PREEMPTED]
    events = [json.loads(ln) for ln in
              (tmp_path / "ev.ndjson").read_text().splitlines()]
    assert any(e.get("event") == "job_finish"
               and e.get("trace_id") == "drill.7" for e in events)


def test_profile_jobs_run_one_at_a_time(tmp_path):
    """Two concurrent ``--profile`` jobs: torch.profiler sessions from
    two threads at once would crash the process, so the second fails
    its job (exit 1) and the daemon serves on; each profile that ran is
    whole."""
    paf, fa = _corpus(tmp_path)
    results: dict = {}

    def submitter(tag, sock):
        results[tag] = _submit_and_wait(sock, _job_args(
            tmp_path, tag, paf, fa, [f"--profile={tmp_path / tag}",
                                     SLOW]))

    with _daemon(max_concurrent=2, lanes=2, journal_path=None) as h:
        ts = [threading.Thread(target=submitter, args=(t, h.sock))
              for t in ("p1", "p2")]
        for t in ts:
            t.start()
            time.sleep(0.3)
        for t in ts:
            t.join(120)
        with ServiceClient(h.sock) as c:
            assert c.ping()["ok"]
    rcs = sorted(r["rc"] for r in results.values())
    assert rcs == [0, 1], results
    bad = next(r for r in results.values() if r["rc"] == 1)
    assert "one profile at a time" in bad["stderr_tail"]
    good = next(t for t, r in results.items() if r["rc"] == 0)
    assert json.loads((tmp_path / good / "trace.json").read_text())
