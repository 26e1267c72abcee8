"""The port router's write-ahead journal and epoch leases against the
JAX package's, on the CPU.

Ports of the slice-A11a cases of ``tests/test_fleet_ha.py``:
``fold_route_records`` on seeded record streams (through both packages'
journal replay, a torn tail among them), the router's replay and
compaction of one journal, the journal path, the epoch lease and the
re-admission guard, the bounded stream replay window, the router's WAL
replay after a kill -9, a member self-fencing on lease expiry, and the
zombie drill with a short lease.  The warm standby's and the scaler's
cases are in ``test_torch_standby.py`` and ``test_torch_scaler.py``.
"""

import io
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from pwasm_tpu.fleet import transport as ref_transport
from pwasm_tpu.fleet.fencing import EpochLease as RefEpochLease
from pwasm_tpu.fleet.fencing import readmit_epoch_guard as ref_guard
from pwasm_tpu.fleet.router import fold_route_records as ref_fold
from pwasm_tpu.service.journal import JobJournal as RefJournal
from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
from pwasm_tpu_torch.fleet import transport
from pwasm_tpu_torch.fleet.fencing import EpochLease, readmit_epoch_guard
from pwasm_tpu_torch.fleet.router import fold_route_records
from pwasm_tpu_torch.service import journal as port_journal
from pwasm_tpu_torch.service.client import (ServiceClient, ServiceError,
                                            wait_for_socket)
from pwasm_tpu_torch.service.journal import JobJournal

from test_torch_fleet import (PKGS, SLOW, TIMES, _cold_ref, _corpus,
                              _daemon, _job_args, _mask, _nested,
                              _reap, _router, _serve_env, _spawn_members,
                              _stub_runner, _wait, _wait_mid_run)


# ---------------------------------------------------------------------------
# the record vocabulary and the fold
# ---------------------------------------------------------------------------
def test_router_record_kinds_equal_the_reference():
    from pwasm_tpu.service import journal as ref_journal
    names = [n for n in dir(ref_journal) if n.startswith("REC_")]
    assert {"REC_ROUTE_ADMIT", "REC_ROUTE_PLACE", "REC_ROUTE_RETIRE",
            "REC_EPOCH", "REC_MEMBERS", "REC_SCALE",
            "REC_ROUTE_SHED"} <= set(names)
    for n in names:
        assert getattr(port_journal, n) == getattr(ref_journal, n), n


def _records(seed: int) -> list[dict]:
    """A seeded router-journal stream: admits, placements, failover
    re-placements, retirements, epochs, member snapshots, scaler and
    shed records, strays with no admit and malformed fields."""
    rng = random.Random(seed)
    recs: list = []
    fids = [f"fleet-{k:04d}" for k in range(1, 9)]
    for _ in range(rng.randint(20, 60)):
        kind = rng.choice(["route_admit", "route_admit", "route_place",
                           "route_place", "route_retire", "epoch",
                           "members", "scale", "route_shed", "junk"])
        fid = rng.choice(fids + [None, 7])
        if kind == "route_admit":
            recs.append({"v": 1, "rec": kind, "job_id": fid,
                         "client": rng.choice(["", "a", "tok:b"]),
                         "priority": rng.choice(["", "rt"]),
                         "trace_id": f"tr{rng.randint(0, 9)}",
                         "stream": rng.random() < 0.3,
                         "frame": {"args": ["x.paf", "-o", "x.dfa"],
                                   "cwd": "/w"},
                         "t": 1000.0 + len(recs)})
        elif kind == "route_place":
            recs.append({"v": 1, "rec": kind, "job_id": fid,
                         "member": rng.choice(["m0.sock", "m1.sock"]),
                         "mjid": f"job-{rng.randint(1, 99):04d}",
                         "gen": rng.randint(0, 3),
                         "epoch": rng.randint(0, 5)})
        elif kind == "route_retire":
            recs.append({"v": 1, "rec": kind, "job_id": fid,
                         **({"state": rng.choice(["done", "failed",
                                                  "bogus"]),
                             "rc": rng.choice([0, 1, None]),
                             "detail": "d"} if rng.random() < 0.5
                            else {})})
        elif kind == "epoch":
            recs.append({"v": 1, "rec": kind,
                         "epoch": rng.choice([rng.randint(0, 9), "9",
                                              True])})
        elif kind == "members":
            recs.append({"v": 1, "rec": kind,
                         "backends": rng.choice([["/a.sock"],
                                                 ["/a.sock", "/b.sock"],
                                                 "nope", [1]])})
        elif kind == "scale":
            recs.append({"v": 1, "rec": kind,
                         "action": rng.choice(["spawn", "retire"]),
                         "target": rng.choice(["/s1.sock", "/s2.sock",
                                               None]),
                         "pid": rng.randint(10, 20)})
        elif kind == "route_shed":
            recs.append({"v": 1, "rec": kind, "level": 1, "was": 0,
                         "lanes": ["bulk"]})
        else:
            recs.append({"v": 1, "rec": "mystery", "job_id": fid})
    return recs


@pytest.mark.parametrize("seed", range(6))
def test_fold_route_records_equals_the_reference(tmp_path, seed):
    """The same seeded stream, written as a journal whose last line is
    torn, replays and folds alike in both packages."""
    recs = _records(seed)
    assert fold_route_records(recs) == ref_fold(recs)
    path = str(tmp_path / "router.journal")
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write('{"v": 1, "rec": "route_admit", "job_id": "fleet-9')
    got = JobJournal(path).replay()
    assert got == RefJournal(path).replay() == recs
    assert fold_route_records(got) == ref_fold(got)
    assert fold_route_records([]) == {
        "jobs": {}, "epoch": 0, "members": None, "scaled": {}}


def test_fold_route_records_contract():
    recs = [
        {"rec": "members", "backends": ["/a.sock"]},
        {"rec": "epoch", "epoch": 1},
        {"rec": "route_admit", "job_id": "fleet-0001", "client": "c",
         "frame": {"args": []}},
        {"rec": "route_place", "job_id": "fleet-0001",
         "member": "a.sock", "mjid": "job-0001", "gen": 0, "epoch": 1},
        {"rec": "route_admit", "job_id": "fleet-0002", "client": "c",
         "frame": {"args": []}},
        {"rec": "route_retire", "job_id": "fleet-0002"},
        {"rec": "route_place", "job_id": "fleet-0009", "member": "x"},
        {"rec": "epoch", "epoch": 4},
        {"rec": "members", "backends": ["/a.sock", "/b.sock"]},
        {"rec": "scale", "action": "spawn", "target": "/s1.sock",
         "pid": 11},
        {"rec": "scale", "action": "spawn", "target": "/s2.sock",
         "pid": 12},
        {"rec": "scale", "action": "retire", "target": "/s1.sock"},
    ]
    f = fold_route_records(recs)
    assert f["epoch"] == 4
    assert f["members"] == ["/a.sock", "/b.sock"]
    assert set(f["jobs"]) == {"fleet-0001", "fleet-0002"}
    assert f["jobs"]["fleet-0001"]["place"]["mjid"] == "job-0001"
    assert f["jobs"]["fleet-0001"]["retire"] is None
    assert f["jobs"]["fleet-0002"]["retire"] is not None
    assert set(f["scaled"]) == {"/s2.sock"}


def _replayed(pkg, d, recs):
    """A router of ``pkg`` opening a journal of ``recs``: its job table,
    epoch, ledger and compacted journal."""
    os.makedirs(d)
    sock = os.path.join(d, "r.sock")
    with open(sock + ".router.journal", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    err = io.StringIO()
    r = PKGS[pkg].Router([os.path.join(d, "m0.sock")], socket_path=sock,
                         stderr=err, poll_interval=999)
    r._open_journal()
    r.rjournal.close()
    jobs = {fid: {"member": j.member, "mjid": j.mjid, "gen": j.gen,
                  "epoch": j.epoch, "retired": j.retired,
                  "stream": j.stream, "rbuf": j.rbuf,
                  "terminal": j.terminal, "client": j.client}
            for fid, j in r.jobs.items()}
    compacted = [json.loads(ln) for ln in
                 open(sock + ".router.journal").read().splitlines()]
    return _mask({"jobs": jobs, "epoch": r.epoch, "next": r._next_id,
                  "members": sorted(r.members),
                  "ledger": r.ledger.client_depths(),
                  "recovered": r.recovered, "err": err.getvalue(),
                  "compacted": compacted}, TIMES, (d,))


def test_router_replay_and_compaction_equal_the_reference(tmp_path):
    """One router journal (a live placement, a retired verdict, a live
    stream, an admission never placed, a cache hit, a failover
    re-placement) replayed by both routers: the same table, epoch,
    ledger and compacted journal."""
    frame = {"args": ["x.paf", "-o", "/w/x.dfa"], "cwd": "/w"}
    recs = [
        {"v": 1, "rec": "members", "backends": ["/w/m0.sock",
                                                "/w/m1.sock"]},
        {"v": 1, "rec": "epoch", "epoch": 3},
        {"v": 1, "rec": "route_admit", "job_id": "fleet-0001",
         "client": "a", "priority": "", "trace_id": "t1",
         "stream": False, "frame": frame, "t": 100.0},
        {"v": 1, "rec": "route_place", "job_id": "fleet-0001",
         "member": "m0.sock", "mjid": "job-0001", "gen": 0, "epoch": 3},
        {"v": 1, "rec": "route_admit", "job_id": "fleet-0002",
         "client": "a", "priority": "rt", "trace_id": "t2",
         "stream": False, "frame": frame, "t": 101.0},
        {"v": 1, "rec": "route_place", "job_id": "fleet-0002",
         "member": "m1.sock", "mjid": "job-0001", "gen": 0, "epoch": 3},
        {"v": 1, "rec": "route_retire", "job_id": "fleet-0002",
         "state": "done", "rc": 0, "detail": "ok"},
        {"v": 1, "rec": "route_admit", "job_id": "fleet-0003",
         "client": "b", "priority": "", "trace_id": "t3",
         "stream": True, "frame": frame, "t": 102.0},
        {"v": 1, "rec": "route_place", "job_id": "fleet-0003",
         "member": "m0.sock", "mjid": "job-0002", "gen": 0, "epoch": 3},
        {"v": 1, "rec": "route_admit", "job_id": "fleet-0004",
         "client": "b", "priority": "", "trace_id": "t4",
         "stream": False, "frame": frame, "t": 103.0},
        {"v": 1, "rec": "route_admit", "job_id": "fleet-0005",
         "client": "c", "priority": "", "trace_id": "t5",
         "stream": False, "frame": frame, "cache_hit": True, "t": 104.0},
        {"v": 1, "rec": "route_retire", "job_id": "fleet-0005",
         "state": "done", "rc": 0, "detail": "cache"},
        {"v": 1, "rec": "epoch", "epoch": 4, "why": "member_down:m0"},
        {"v": 1, "rec": "route_place", "job_id": "fleet-0001",
         "member": "m1.sock", "mjid": "job-0002", "gen": 1, "epoch": 4},
        {"v": 1, "rec": "route_shed", "level": 1, "was": 0,
         "lanes": ["bulk"]},
    ]
    got = {pkg: _replayed(pkg, str(tmp_path / pkg), recs)
           for pkg in ("port", "ref")}
    assert got["port"] == got["ref"]
    g = got["port"]
    assert g["epoch"] == 5 and g["next"] == 5
    assert g["jobs"]["fleet-0001"]["member"] == "m1.sock"
    assert g["jobs"]["fleet-0001"]["gen"] == 1
    assert not g["jobs"]["fleet-0001"]["retired"]
    assert g["jobs"]["fleet-0003"]["terminal"]["job"]["state"] \
        == "preempted"
    assert g["jobs"]["fleet-0004"]["retired"]
    assert g["ledger"] == {"a": 1}
    assert "replayed 5 routed job(s)" in g["err"]


def test_router_journal_path_equals_the_reference(tmp_path):
    shared = str(tmp_path)
    for args in (("/run/r.sock", None, None),
                 ("/run/r.sock", None, shared),
                 (None, "node7:9211", shared),
                 (None, "node7:9211", None),
                 ("/run/r.sock", "node7:9211", None)):
        assert transport.router_journal_path(*args) \
            == ref_transport.router_journal_path(*args)
    assert transport.router_journal_path("/run/r.sock", None, None) \
        == "/run/r.sock.router.journal"
    assert transport.router_journal_path(None, "node7:9211", shared) \
        == os.path.join(shared, "router-node7_9211.journal")
    assert transport.router_journal_path(None, "node7:9211", None) \
        is None


# ---------------------------------------------------------------------------
# the epoch lease and the re-admission guard
# ---------------------------------------------------------------------------
def _lease_trace(cls):
    t = [0.0]
    lease = cls(clock=lambda: t[0])
    out = [(lease.governed, lease.expired(), lease.remaining_s())]
    for at, op, args in [
            (0.0, "grant", (0, 5.0)), (0.0, "grant", (True, 5.0)),
            (0.0, "grant", (2, 0)), (0.0, "grant", (2, float("inf"))),
            (0.0, "grant", (2, 5.0)), (0.0, "grant", (1, 5.0)),
            (4.0, "expired", ()), (5.1, "expired", ()),
            (5.1, "fence", ("ttl expired",)), (5.1, "fence", ("again",)),
            (5.1, "as_dict", ()), (5.2, "grant", (3, 5.0)),
            (5.2, "expired", ()), (5.2, "as_dict", ()),
            (5.3, "grant", (3, 5.0)), (9.0, "remaining_s", ())]:
        t[0] = at
        out.append((op, getattr(lease, op)(*args), lease.epoch,
                    lease.fenced))
    return out


def test_epoch_lease_and_guard_equal_the_reference():
    assert _lease_trace(EpochLease) == _lease_trace(RefEpochLease)
    for job_epoch, fleet in ((0, 3), (3, 3), (4, 3)):
        try:
            want = ref_guard(job_epoch, fleet)
        except RuntimeError as e:
            with pytest.raises(RuntimeError) as ei:
                readmit_epoch_guard(job_epoch, fleet)
            assert str(ei.value) == str(e)
        else:
            assert readmit_epoch_guard(job_epoch, fleet) == want


# ---------------------------------------------------------------------------
# the bounded mid-stream replay window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_stream_replay_window_bounds(pkg):
    p = PKGS[pkg]
    r = p.Router(["/nonexistent/a.sock"], socket_path=None,
                 listen="127.0.0.1:0", stderr=io.StringIO(),
                 poll_interval=999, stream_replay_bytes=600)
    job = p.FleetJob("fleet-0001", "c", "", "", {"args": []},
                     "a.sock", "job-0001", stream=True)
    assert job.rbuf == [] and job.rbytes == 0
    f1 = {"cmd": "stream-data", "data": '{"rec": 1}'}
    r._buffer_stream_frame(job, f1)
    assert job.rbuf == [f1] and job.rbytes == len('{"rec": 1}')
    r._buffer_stream_frame(job, {"cmd": "stream-data", "data": None})
    assert job.rbytes == len('{"rec": 1}') + 256
    r._buffer_stream_frame(job, {"cmd": "stream-data",
                                 "data": "x" * 600})
    assert job.rbuf is None and job.rbytes == 0
    r._buffer_stream_frame(job, {"cmd": "stream-data", "data": "y"})
    assert job.rbuf is None
    job2 = p.FleetJob("fleet-0002", "c", "", "", {"args": []},
                      "a.sock", "job-0002", stream=True)
    r._buffer_stream_frame(job2, {"cmd": "stream-end"})
    assert job2.ended
    assert p.FleetJob("fleet-0003", "c", "", "", {"args": []},
                      "a.sock", "job-0003").rbuf is None


# ---------------------------------------------------------------------------
# the router's WAL: kill -9 the router, restart it on the same socket
# ---------------------------------------------------------------------------
def _gated_runner(gate):
    """The stubbed runner, except that a job whose input is ``l.paf``
    runs until ``gate`` is set."""
    stub = _stub_runner()

    def runner(argv, **kw):
        if any(a.endswith("l.paf") for a in argv):
            gate.wait(60)
        return stub(argv, **kw)
    return runner


def test_router_wal_replay_after_kill9(tmp_path):
    """SIGKILL a ``route`` process mid-job and restart it on the same
    socket: the replay restores the routed-job table (the live job
    completes, the finished job answers ``status`` and ``result``) and
    the epoch is past the dead incarnation's; a clean drain then
    retires the journal."""
    gate = threading.Event()
    with _nested(2, _gated_runner(gate), {}) as members:
        d = tempfile.mkdtemp(prefix="pwwal")
        rsock = os.path.join(d, "router.sock")
        jpath = rsock + ".router.journal"
        argv = [sys.executable, "-m", "pwasm_tpu_torch", "route",
                "--backends=" + ",".join(m.sock for m in members),
                f"--socket={rsock}", "--poll-interval=0.1"]
        procs = [subprocess.Popen(argv, env=_serve_env(),
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)]
        try:
            assert wait_for_socket(rsock, 30)
            with ServiceClient(rsock) as c:
                quick = c.submit(["q.paf", "-o", str(tmp_path / "q")],
                                 cwd=str(tmp_path))
                assert quick["ok"]
                assert c.result(quick["job_id"], timeout=60)["rc"] == 0
                live = c.submit(["l.paf", "-o", str(tmp_path / "l")],
                                cwd=str(tmp_path))
                assert live["ok"]
                _wait(lambda: c.status(live["job_id"])["job"]["state"]
                      == "running")
                epoch0 = c.stats()["stats"]["ha"]["epoch"]
            procs[0].kill()                 # SIGKILL: no drain, no flush
            procs[0].wait(timeout=30)
            assert os.path.exists(jpath)
            procs.append(subprocess.Popen(argv, env=_serve_env(),
                                          stdout=subprocess.DEVNULL,
                                          stderr=subprocess.PIPE,
                                          text=True))
            assert wait_for_socket(rsock, 30)
            with ServiceClient(rsock) as c:
                sq = c.status(quick["job_id"])
                assert sq["ok"] and sq["job"]["id"] == quick["job_id"]
                assert c.result(quick["job_id"], timeout=60)["rc"] == 0
                assert c.status(live["job_id"])["job"]["state"] \
                    == "running"
                gate.set()
                rl = c.result(live["job_id"], timeout=60)
                assert rl.get("rc") == 0, rl
                st = c.stats()["stats"]
                assert st["ha"]["epoch"] > epoch0
                assert st["ha"]["journal"]["path"] == jpath
                assert st["fair_share"]["clients"] == {}
                c.drain()
            assert procs[1].wait(timeout=60) == 0
            assert not os.path.exists(jpath)
        finally:
            gate.set()
            _reap(procs)
            shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# member-side fencing through the lease the router grants
# ---------------------------------------------------------------------------
def test_member_self_fences_on_lease_expiry(tmp_path):
    """A member governed by a router's lease fences itself once the
    heartbeat stops: the queued job preempts resumable, new submits
    answer ``fenced``, reads still serve, the running job completes,
    and a newer epoch's grant lifts the fence."""
    out = str(tmp_path / "o.dfa")
    with _daemon(runner=_stub_runner(sleep=1.5)) as h, \
            _router([h.sock], lease_ttl_s=0.6) as rt, \
            ServiceClient(rt.sock) as rc, ServiceClient(h.sock) as c:
        running = rc.submit(["in.paf", "-o", out], cwd=str(tmp_path))
        queued = rc.submit(["in2.paf", "-o", out + "2"],
                           cwd=str(tmp_path))
        assert running["ok"] and queued["ok"]
        lb = c.request({"cmd": "stats"})["stats"]["lease"]
        assert lb["governed"] and lb["epoch"] == 1
        # the router's health loop stops: no more heartbeats, and the
        # TTL lapses
        rt.router._closing.set()
        _wait(lambda: c.request({"cmd": "stats"})
              ["stats"]["lease"]["fenced"])
        lb = c.request({"cmd": "stats"})["stats"]["lease"]
        assert "TTL expired" in lb["reason"]
        # the router still answers for both jobs
        rq = rc.result(queued["job_id"], timeout=15)
        assert rq["rc"] == EXIT_PREEMPTED
        assert "fencing" in rq["job"]["detail"]
        assert rc.result(running["job_id"], timeout=15)["rc"] == 0
        ref = c.submit(["x.paf", "-o", out], cwd=str(tmp_path))
        assert not ref.get("ok") and ref["error"] == "fenced"
        assert c.ping()["ok"]
        g = c.request({"cmd": "lease-grant", "epoch": 2,
                       "ttl_s": 30})
        assert g["ok"] and g["lease"]["fenced"] is False
        assert c.submit(["y.paf", "-o", out],
                        cwd=str(tmp_path))["ok"]
        g2 = c.request({"cmd": "lease-grant", "epoch": 1,
                        "ttl_s": 30})
        assert g2["error"] == "fenced" and "stale epoch" \
            in g2["detail"]


# ---------------------------------------------------------------------------
# the zombie drill: SIGSTOP a member, fail over, thaw it — no double-write
# ---------------------------------------------------------------------------
def test_zombie_member_self_fences_no_double_write(tmp_path):
    """SIGSTOP (not SIGKILL) the port member running a mid-run job: the
    router fails the job over (epoch bumped) and its report equals the
    reference's cold run; thawed with no router left to heartbeat it,
    the zombie fences itself and refuses new work.  A lease of 9 s
    keeps the drill short: the sibling's heartbeats are about 7 s apart
    while the router's serial health loop waits out the frozen member's
    3 s poll and status timeouts."""
    paf, fa = _corpus(tmp_path, n=8)
    expect = _cold_ref(tmp_path, "cold", paf, fa)
    d = tempfile.mkdtemp(prefix="pwzmb")
    procs = []
    vi = None
    try:
        socks, procs = _spawn_members(d, 2)
        with _router(socks, lease_ttl_s=9.0) as rt:
            with ServiceClient(rt.sock, trace_id="zombie-drill") as c:
                ja = c.submit(_job_args(tmp_path, "a", paf, fa, [SLOW]),
                              cwd=str(tmp_path))
                assert ja["ok"], ja
                assert _wait_mid_run(c, ja["job_id"],
                                     str(tmp_path / "a.dfa.ckpt"))
                victim = ja["member"]
                vi = socks.index(rt.router.members[victim].target)
                os.kill(procs[vi].pid, signal.SIGSTOP)
                job = rt.router.jobs[ja["job_id"]]
                # wait on the router itself: a client's result RPC would
                # sit on the frozen member until its own timeout
                _wait(lambda: job.gen == 1, 60)
                ra = c.result(ja["job_id"], timeout=120)
                assert ra.get("rc") == 0, ra
                assert ra["job"]["trace_id"] == "zombie-drill"
                assert ra["job"]["member"] != victim
                assert ra["job"]["failovers"] == 1
                # (read on the router: a stats verb would also wait out
                # the frozen member's poll)
                assert rt.router.failovers >= 1
                assert rt.router.recovered["resumed"] == 1
                assert rt.router.epoch >= 2
                c.drain()
            _wait(lambda: rt.rc == [0], 30)
        assert (tmp_path / "a.dfa").read_bytes() == expect
        os.kill(procs[vi].pid, signal.SIGCONT)
        fenced = None
        deadline = time.monotonic() + 30
        while fenced is None and time.monotonic() < deadline:
            try:
                with ServiceClient(socks[vi], timeout=5.0) as mc:
                    lb = mc.request({"cmd": "stats"})["stats"]["lease"]
                fenced = lb if lb.get("fenced") else None
            except (ServiceError, OSError):
                pass
            time.sleep(0.1)
        assert fenced is not None and fenced["governed"]
        with ServiceClient(socks[vi], timeout=10.0) as mc:
            ref = mc.submit(["z.paf", "-o", str(tmp_path / "z.dfa")],
                            cwd=str(tmp_path))
            assert not ref.get("ok") and ref["error"] == "fenced"
        with ServiceClient(socks[1 - vi]) as mc:
            mc.drain()
        assert procs[1 - vi].wait(timeout=120) == EXIT_PREEMPTED
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGCONT)
                except OSError:
                    pass
        _reap(procs)
        shutil.rmtree(d, ignore_errors=True)
