"""The port's fleet router (``pwasm_tpu_torch/fleet/router.py``) and its
ledger against the JAX package's, on the CPU.

Ports of the router cases of ``tests/test_fleet.py``: the ledger on one
seeded reserve, move and retire sequence through both packages;
``route_main``'s flag checks, each refusal's message equal to the
reference's; routing, placement, the fleet quota, aggregated stats, stream verbs
and the drain over in-process port daemons with the stubbed runner;
every failover verdict (resume, requeue, spool, cancel, stream, no
journal, no sibling, orphan rescue) reached by both routers on the same
hand-written member journals; the kill-one-of-three drill, whose bytes
equal the reference's cold ``--device=cpu`` run; and one scripted frame
sequence through a reference router over reference daemons and a port
router over port daemons, equal once walls and fleet ids are masked.

The harness here (``PKGS``, ``_daemon``, ``_fleet``, ``_stub_runner``)
is shared by ``test_torch_fleet_ha.py``, ``test_torch_gray_failure.py``
and ``test_torch_fleet_edge.py``.
"""

import io
import json
import os
import random
import shutil
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
from pwasm_tpu.fleet.ledger import FleetLedger as RefLedger
from pwasm_tpu.fleet.router import Router as RefRouter
from pwasm_tpu.fleet.router import _FleetJob as RefFleetJob
from pwasm_tpu.fleet.router import route_main as ref_route_main
from pwasm_tpu.service.daemon import Daemon as RefDaemon
from pwasm_tpu.service.queue import QueueFull as RefQueueFull
from pwasm_tpu_torch.fleet import transport
from pwasm_tpu_torch.fleet.ledger import FleetLedger
from pwasm_tpu_torch.fleet.router import Router, _FleetJob, route_main
from pwasm_tpu_torch.service.client import ServiceClient, wait_for_socket
from pwasm_tpu_torch.service.daemon import Daemon
from pwasm_tpu_torch.service.queue import QueueFull
from pwasm_tpu_torch.service.top import render

from helpers import make_paf_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOW = "--inject-faults=seed=1,rate=1,kinds=hang,hang_s=0.25"

PKGS = {
    "port": SimpleNamespace(Router=Router, Daemon=Daemon,
                            FleetJob=_FleetJob, route_main=route_main,
                            Ledger=FleetLedger, QueueFull=QueueFull,
                            module="pwasm_tpu_torch"),
    "ref": SimpleNamespace(Router=RefRouter, Daemon=RefDaemon,
                           FleetJob=RefFleetJob,
                           route_main=ref_route_main, Ledger=RefLedger,
                           QueueFull=RefQueueFull, module="pwasm_tpu.cli"),
}

# fields that carry walls, timestamps, load samples or run counters
TIMES = frozenset(("submitted_s", "started_s", "finished_s", "uptime_s",
                   "busy_s", "wait_s_total", "expires_in_s",
                   "remaining_s", "retry_after_s", "evaluations",
                   "lat_ewma_ms", "depth_ewma", "t"))


def _mask(obj, keys=TIMES, paths=()):
    """``obj`` with the values of ``keys`` masked and each of ``paths``
    (a package's working directory) written as ``<d>``."""
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in keys else _mask(v, keys, paths))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v, keys, paths) for v in obj]
    if isinstance(obj, str):
        for p in paths:
            obj = obj.replace(p, "<d>")
    return obj


# ---------------------------------------------------------------------------
# in-process harness (the reference's tests/test_fleet.py harness, with
# the package a parameter)
# ---------------------------------------------------------------------------
def _stub_runner(log=None, sleep=0.0, rc=0):
    def runner(argv, stdout=None, stderr=None, warm=None,
               input_stream=None, **kw):
        if log is not None:
            log.append(list(argv))
        if input_stream is not None:
            list(input_stream)        # a stream job runs to its end
        if sleep:
            time.sleep(sleep)
        sp = next((a.split("=", 1)[1] for a in argv
                   if a.startswith("--stats=")), None)
        if sp:
            with open(sp, "w") as f:
                json.dump({"wall_s": sleep}, f)
        return rc
    return runner


@contextmanager
def _daemon(runner=None, pkg="port", name=None, **kw):
    """One in-process serve daemon of ``pkg`` on a background thread.
    The socket's basename is unique unless ``name`` is given (member
    names key on it, ``transport.target_name``)."""
    sockdir = tempfile.mkdtemp(prefix="pwflt")
    sock = os.path.join(sockdir,
                        name or os.path.basename(sockdir) + ".sock")
    err = io.StringIO()
    dm = PKGS[pkg].Daemon(sock, stderr=err, runner=runner, **kw)
    rcbox: list = []
    t = threading.Thread(target=lambda: rcbox.append(dm.serve()),
                         daemon=True)
    t.start()
    assert wait_for_socket(sock, 15), err.getvalue()
    try:
        yield SimpleNamespace(daemon=dm, sock=sock, rc=rcbox, err=err,
                              thread=t, dir=sockdir)
    finally:
        if not dm.drain.requested:
            dm.drain.request("test teardown")
        t.join(20)
        shutil.rmtree(sockdir, ignore_errors=True)


@contextmanager
def _nested(n, runner, daemon_kw, pkg="port", names=None):
    stack = []
    try:
        out = []
        for i in range(n):
            cm = _daemon(runner=runner, pkg=pkg,
                         name=names[i] if names else None, **daemon_kw)
            stack.append(cm)
            out.append(cm.__enter__())
        yield out
    finally:
        for cm in reversed(stack):
            cm.__exit__(None, None, None)


@contextmanager
def _router(backends, pkg="port", **kw):
    """One in-process router of ``pkg`` on a background thread."""
    rdir = tempfile.mkdtemp(prefix="pwrt")
    rsock = os.path.join(rdir, "router.sock")
    err = io.StringIO()
    kw.setdefault("poll_interval", 0.1)
    r = PKGS[pkg].Router(backends, socket_path=rsock, stderr=err, **kw)
    rcbox: list = []
    t = threading.Thread(target=lambda: rcbox.append(r.serve()),
                         daemon=True)
    t.start()
    assert wait_for_socket(rsock, 15), err.getvalue()
    try:
        yield SimpleNamespace(router=r, sock=rsock, err=err, rc=rcbox,
                              thread=t, dir=rdir)
    finally:
        if not r.drain.requested:
            r.drain.request("test teardown")
        t.join(20)
        shutil.rmtree(rdir, ignore_errors=True)


@contextmanager
def _fleet(n=2, runner=None, router_kw=None, daemon_kw=None, pkg="port",
           names=None):
    """N in-process member daemons + one in-process router."""
    with _nested(n, runner, daemon_kw or {}, pkg, names) as members:
        with _router([m.sock for m in members], pkg,
                     **(router_kw or {})) as rt:
            yield SimpleNamespace(router=rt.router, sock=rt.sock,
                                  members=members, err=rt.err, rc=rt.rc)


def _wait(pred, budget_s=15.0):
    deadline = time.monotonic() + budget_s
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------
def _ledger_trace(pkg: str, seed: int) -> list:
    """One seeded sequence of admit / restore / move / retire through a
    ledger of ``pkg``; every answer and every state after it."""
    p = PKGS[pkg]
    rng = random.Random(seed)
    led = p.Ledger(max_queue=rng.randint(1, 4),
                   max_total=rng.choice([None, rng.randint(2, 9)]))
    clients, members = ["", "a", "b", "tok:c"], ["m0", "m1", "m2"]
    live: list = []
    out = [(led.max_queue, led.max_total)]
    for _ in range(120):
        op = rng.choice(["admit", "admit", "restore", "move", "retire"])
        c, m = rng.choice(clients), rng.choice(members)
        try:
            if op == "admit":
                led.admit(c, m)
                live.append([c, m])
            elif op == "restore":
                led.restore(c, m)
                live.append([c, m])
            elif op == "move" and live:
                row = rng.choice(live)
                led.move(row[0], row[1], m)
                row[1] = m
            elif op == "retire" and live:
                row = live.pop(rng.randrange(len(live)))
                led.retire(*row)
            ans = "ok"
        except p.QueueFull as e:
            ans = f"QueueFull: {e}"
        out.append((op, ans, led.client_depths(),
                    [led.member_pressure(x) for x in members],
                    led.admitted, led.rejected))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_ledger_equals_the_reference(seed):
    assert _ledger_trace("port", seed) == _ledger_trace("ref", seed)


def test_ledger_quota_move_retire():
    led = FleetLedger(max_queue=2, max_total=3)
    led.admit("a", "m0")
    led.admit("a", "m1")
    with pytest.raises(QueueFull) as ei:
        led.admit("a", "m0")            # per-client fleet quota
    assert "FLEET" in str(ei.value)
    led.admit("b", "m0")
    with pytest.raises(QueueFull):
        led.admit("c", "m0")            # fleet total backstop
    assert led.client_depths() == {"a": 2, "b": 1}
    assert led.member_pressure("m0") == 2
    led.move("a", "m1", "m0")           # failover re-placement
    assert led.member_pressure("m0") == 3
    assert led.client_depths()["a"] == 2
    for c in ("a", "a", "b"):
        led.retire(c, "m0")
    assert led.client_depths() == {} and led.member_pressure("m0") == 0
    led.admit("c", "m0")                # slots freed


# ---------------------------------------------------------------------------
# route_main's flag checks
# ---------------------------------------------------------------------------
def _route_cases(d):
    base = ["--backends=a.sock", f"--socket={d}/r"]
    bad_rules = os.path.join(d, "rules.json")
    return [
        [], ["--backends=a.sock"], ["--backends=a.sock", "--listen=zzz"],
        ["--backends=/x/m.sock,/y/m.sock", f"--socket={d}/r"],
        base + ["--bogus=1"], ["-h"], ["--help"], ["stray"],
        base + ["--max-queue=0"], base + ["--max-queue-total=x"],
        base + ["--max-results=-2"], base + ["--poll-interval=0"],
        base + ["--poll-interval=nan"], base + ["--lease-ttl=0"],
        base + ["--lease-ttl=inf"], base + ["--lease-ttl=abc"],
        base + ["--stream-replay-bytes=-1"],
        base + ["--stream-replay-bytes=4MiB"],
        base + ["--priority-lanes=a,a"], base + ["--priority-lanes=,"],
        base + ["--priority-lanes=bad lane"],
        base + ["--quarantine-x=0.5"], base + ["--quarantine-x=-1"],
        base + ["--quarantine-probation=0"],
        base + ["--result-cache-max-bytes=0"],
        base + [f"--slo-rules={bad_rules}"],
        base + [f"--slo-rules={d}/absent.json"],
        base + ["--max-frame-bytes=0"],
        base + ["--tls-cert=c.pem"], base + ["--tls-client-ca=ca.pem"],
        base + [f"--tls-cert={d}/c.pem", f"--tls-key={d}/k.pem"],
        base + ["--member-tls-cert=c.pem"],
        base + ["--member-tls-cert=c.pem", "--member-tls-key=k.pem"],
        base + [f"--member-tls-ca={d}/absent.pem"],
        base + ["--auth-tokens= "], base + ["--rate-limit=fast"],
        ["--backends=a.sock", "--socket=", "--listen="],
    ]


def test_route_main_refusals_equal_the_reference(tmp_path):
    """Every refusal of ``route_main`` exits as the reference's does,
    with the same message, usage text included."""
    d = str(tmp_path)
    with open(os.path.join(d, "rules.json"), "w") as f:
        json.dump([{"name": "x"}], f)
    cases = _route_cases(d)
    for argv in cases:
        got = {}
        for pkg in ("port", "ref"):
            err = io.StringIO()
            rc = PKGS[pkg].route_main(list(argv), stderr=err)
            got[pkg] = (rc, err.getvalue())
        assert got["port"] == got["ref"], argv
        assert got["port"][0] == 1, argv
    assert not os.path.exists(os.path.join(d, "r"))


def test_route_process_refuses_and_routes(tmp_path):
    """``python -m pwasm_tpu_torch route`` is the router: a refusal
    exits 1 in a process too."""
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", "pwasm_tpu_torch", "route",
                        "--standby-of=/x.sock", "--socket=/x/r.sock"],
                       env=env, capture_output=True, text=True, timeout=60)
    assert p.returncode == 1
    assert "--standby-of and --socket/--listen are mutually exclusive" \
        in p.stderr
    p = subprocess.run([sys.executable, "-m", "pwasm_tpu_torch", "route",
                        "--backends=a.sock"], env=env,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 1
    assert "--socket=PATH and/or --listen=HOST:PORT is required" \
        in p.stderr


# ---------------------------------------------------------------------------
# routing, placement, fair share, aggregation
# ---------------------------------------------------------------------------
def test_router_submit_result_status_inspect_cancel(tmp_path):
    ran: list = []
    with _fleet(n=2, runner=_stub_runner(log=ran)) as f:
        out = str(tmp_path / "o.dfa")
        with ServiceClient(f.sock, trace_id="rt-1") as c:
            p = c.ping()
            assert p["router"] and p["members"] == 2
            sub = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert sub["ok"] and sub["job_id"].startswith("fleet-")
            assert sub["member"] in f.router.members
            st = c.status(sub["job_id"])
            assert st["ok"] and st["job"]["id"] == sub["job_id"]
            r = c.result(sub["job_id"], timeout=30)
            assert r["rc"] == 0
            assert r["job"]["id"] == sub["job_id"]
            assert r["job"]["member"] == sub["member"]
            assert r["job"]["trace_id"] == "rt-1"
            ins = c.inspect(sub["job_id"])
            assert ins["ok"] and ins["job"]["id"] == sub["job_id"]
            assert c.status("fleet-9999")["error"] == "unknown_job"
            assert c.cancel(sub["job_id"])["ok"]   # terminal: a no-op
    # the member absolutizes the argv and adds its own --stats path
    assert len(ran) == 1 and ran[0][1:3] == ["-o", out]


def test_router_spreads_by_least_depth(tmp_path):
    with _fleet(n=3, runner=_stub_runner(sleep=0.3)) as f:
        with ServiceClient(f.sock) as c:
            jids = [c.submit(["in.paf", "-o", str(tmp_path / f"o{k}")],
                             cwd=str(tmp_path))["job_id"]
                    for k in range(6)]
            for j in jids:
                assert c.result(j, timeout=60)["rc"] == 0
            st = c.stats()["stats"]
        routed = {m["name"]: m["jobs_routed"]
                  for m in st["fleet"]["members"]}
        assert sum(routed.values()) == 6
        assert all(n >= 1 for n in routed.values()), routed


def test_router_fleet_quota_and_member_spillover(tmp_path):
    """A client at the FLEET quota answers queue_full at the router;
    below it, a member's own queue_full spills to a sibling."""
    with _fleet(n=2, runner=_stub_runner(sleep=0.4),
                router_kw={"max_queue": 3},
                daemon_kw={"max_queue": 1}) as f:
        with ServiceClient(f.sock, client_token="t") as c:
            subs = [c.submit(["in.paf", "-o", str(tmp_path / f"q{k}")],
                             cwd=str(tmp_path)) for k in range(3)]
            assert all(s["ok"] for s in subs), subs
            r = c.submit(["in.paf", "-o", str(tmp_path / "q9")],
                         cwd=str(tmp_path))
            assert not r.get("ok") and r["error"] == "queue_full"
            assert "FLEET" in r["detail"]
            assert r["client"] == "tok:t"
            for s in subs:
                assert c.result(s["job_id"], timeout=60)["rc"] == 0
        assert len({s["member"] for s in subs}) == 2


def test_router_aggregated_stats_metrics_and_top(tmp_path):
    with _fleet(n=2, runner=_stub_runner()) as f:
        out = str(tmp_path / "o.dfa")
        with ServiceClient(f.sock, client_token="agg") as c:
            for _ in range(2):
                r = c.result(c.submit(["in.paf", "-o", out],
                                      cwd=str(tmp_path))["job_id"],
                             timeout=30)
                assert r["rc"] == 0
            st = c.stats()["stats"]
            met = c.metrics()["metrics"]
        assert st["router"] is True
        assert st["fleet"]["alive"] == 2
        assert st["fleet"]["jobs_routed"] == 2
        assert st["jobs"]["completed"] == 2
        assert st["fair_share"]["clients"] == {}
        assert st["ha"]["scaler"] == {"enabled": False}
        assert st["ha"]["takeover"] is False and st["ha"]["epoch"] == 1
        for fam in ("pwasm_fleet_member_up",
                    "pwasm_fleet_jobs_routed_total",
                    "pwasm_fleet_members 2"):
            assert fam in met, fam
        frame = render(st)
        assert "FLEET" in frame and "MEMBER" in frame and "up" in frame


def test_router_stream_verbs_forward(tmp_path):
    feeds: list = []

    def stream_runner(argv, stdout=None, stderr=None, warm=None,
                      input_stream=None, **kw):
        if input_stream is not None:
            feeds.append(list(input_stream))
        return 0

    with _fleet(n=2, runner=stream_runner) as f:
        with ServiceClient(f.sock) as c:
            so = c.stream_open(["-r", "q.fa", "-o", str(tmp_path / "s")],
                               cwd=str(tmp_path))
            assert so["ok"], so
            jid = so["job_id"]
            assert jid.startswith("fleet-")
            assert c.stream_data(jid, "rec1\tx\nrec2\t")["ok"]
            assert c.stream_data(jid, "y\n")["ok"]
            end = c.stream_end(jid)
            assert end["ok"] and end["records"] == 2
            assert c.result(jid, timeout=30)["rc"] == 0
            # a closed stream refuses more data at the router
            _wait(lambda: f.router.jobs[jid].retired)
            late = c.stream_data(jid, "z\n")
            assert late["error"] == "bad_request"
            assert "closed" in late["detail"]
    assert feeds and [ln.rstrip("\n") for ln in feeds[0]] \
        == ["rec1\tx", "rec2\ty"]


def test_router_drain_rejects_new_keeps_results(tmp_path):
    with _fleet(n=1, runner=_stub_runner(sleep=0.3)) as f:
        out = str(tmp_path / "d.dfa")
        with ServiceClient(f.sock) as c:
            sub = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert sub["ok"]
            d = c.drain()
            assert d["ok"] and d["draining"]
            assert d["running"] == [sub["job_id"]]
            r = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert r["error"] == "draining"
            assert c.result(sub["job_id"], timeout=60)["rc"] == 0
        _wait(lambda: f.rc == [0])
        # the clean drain retired the router's journal
        assert not os.path.exists(f.router.rjournal.path)


def test_router_job_table_bounded_lru(tmp_path):
    with _fleet(n=1, runner=_stub_runner(),
                router_kw={"max_results": 2}) as f:
        out = str(tmp_path / "e.dfa")
        with ServiceClient(f.sock) as c:
            jids = []
            for _ in range(5):
                s = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
                assert s["ok"]
                assert c.result(s["job_id"], timeout=30)["rc"] == 0
                jids.append(s["job_id"])
            _wait(lambda: len(f.router.jobs) <= 2)
            assert c.status(jids[0])["error"] == "unknown_job"
            assert c.status(jids[-1])["ok"]


def test_router_stream_conn_closed_on_terminal(tmp_path):
    def stream_runner(argv, stdout=None, stderr=None, warm=None,
                      input_stream=None, **kw):
        if input_stream is not None:
            list(input_stream)
        return 0

    with _fleet(n=1, runner=stream_runner) as f:
        with ServiceClient(f.sock) as c:
            so = c.stream_open(["-r", "q.fa", "-o", str(tmp_path / "s")],
                               cwd=str(tmp_path))
            assert so["ok"], so
            job = f.router.jobs[so["job_id"]]
            assert job.sconn is not None
            c.stream_data(so["job_id"], "r1\tx\n")
            c.stream_end(so["job_id"])
            assert c.result(so["job_id"], timeout=30)["rc"] == 0
            _wait(lambda: job.sconn is None)
            assert job.retired


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_poll_death_needs_consecutive_strikes(pkg):
    r = PKGS[pkg].Router(["/nonexistent/ghost.sock"], socket_path=None,
                         listen="127.0.0.1:0", stderr=io.StringIO(),
                         poll_interval=999)
    m = r.members["ghost.sock"]
    m.alive = m.ever_alive = True
    r._poll_members()
    assert m.alive and m.fail_streak == 0
    r._poll_members(count_failures=True)
    assert m.alive and m.fail_streak == 1
    r._poll_members(count_failures=True)
    assert not m.alive
    assert r.epoch == 1 and r.failovers == 1


# ---------------------------------------------------------------------------
# failover verdicts: both routers on the same hand-written journals
# ---------------------------------------------------------------------------
def _spool(d, name="job-0001.result.json"):
    from pwasm_tpu.utils.fsio import payload_crc, write_durable_text
    spool = os.path.join(d, name)
    payload = {"version": 1, "job_id": "job-0001", "state": "done",
               "rc": 0, "trace_id": "tr-9", "flight": None,
               "stats": {"alignments": 7}, "stderr_tail": "tail!"}
    payload["crc"] = payload_crc(
        {k: v for k, v in payload.items() if k != "crc"})
    write_durable_text(spool, json.dumps(payload, sort_keys=True,
                                         separators=(",", ":")))
    return spool


def _admit(argv, stream=False):
    return {"v": 1, "rec": "admit", "job_id": "job-0001", "argv": argv,
            "client": "cl1", "t": 1.0, **({"stream": True} if stream
                                            else {})}


START = {"v": 1, "rec": "start", "job_id": "job-0001", "lane": 0}


def _case_records(case, d):
    a = ["a.paf", "-o", os.path.join(d, "a.dfa")]
    s = ["-r", "q.fa", "-o", os.path.join(d, "a.dfa")]
    fin = {"v": 1, "rec": "finish", "job_id": "job-0001", "state": "done",
           "rc": 0, "t": 2.0}
    return {
        "started": [_admit(a), START],
        "unstarted": [_admit(a)],
        "finished_spool": [_admit(a), START, dict(
            fin, spool={"path": _spool(d), "bytes": 1})],
        "finished_bad_spool": [_admit(a), START, dict(
            fin, spool={"path": os.path.join(d, "gone.json"),
                        "bytes": 1})],
        "cancelled": [_admit(a), {"v": 1, "rec": "cancel",
                                  "job_id": "job-0001"}],
        "stream": [_admit(s, stream=True)],
        "stream_replayed": [_admit(s, stream=True)],
        "stream_finished": [_admit(s, stream=True), START, fin],
        "deadline_spent": [_admit(a), START],
        "torn_tail": [_admit(a), START],
        "no_journal": None,
        "no_sibling": [_admit(a), START],
        "orphan_rescue": [_admit(a), START, fin],
    }[case]


FAILOVER_CASES = ["started", "unstarted", "finished_spool",
                  "finished_bad_spool", "cancelled", "stream",
                  "stream_replayed", "stream_finished", "deadline_spent",
                  "torn_tail", "no_journal", "no_sibling",
                  "orphan_rescue"]


def _failover(pkg, case, d):
    """Drive one failover case through a router of ``pkg`` whose member
    ``ghost.sock`` died, with one live sibling ``sib.sock`` of the same
    package (none for ``no_sibling``); everything observable of the
    verdict."""
    p = PKGS[pkg]
    os.makedirs(d)
    ran: list = []
    recs = _case_records(case, d)
    stream = case.startswith("stream")
    ghost = "ghosthost:19999" if case == "no_journal" \
        else os.path.join(d, "ghost.sock")
    with _daemon(runner=_stub_runner(log=ran), pkg=pkg,
                 name="sib.sock") as sib:
        sib_target = sib.sock if case != "no_sibling" \
            else "/nonexistent/sib.sock"
        r = p.Router([sib_target, ghost], socket_path=None,
                     listen="127.0.0.1:0", stderr=io.StringIO(),
                     poll_interval=999)
        for m in r.members.values():
            m.alive = m.ever_alive = True
        gname = transport.target_name(ghost)
        gm = r.members[gname]
        if recs is not None:
            with open(gm.journal_path, "w") as f:
                for rec in recs:
                    f.write(json.dumps(rec) + "\n")
                if case == "torn_tail":
                    f.write('{"v": 1, "rec": "finish", "job_id": "job-0')
        frame = {"args": [str(a) for a in recs[0]["argv"]] if recs
                 else ["a.paf", "-o", os.path.join(d, "a.dfa")],
                 "cwd": d}
        job = p.FleetJob("fleet-0001", "cl1", "", "tr-9", frame, gname,
                         "job-0001", stream=stream)
        if case == "deadline_spent":
            job.deadline_ms = 5
            job.submitted_mono = time.monotonic() - 1.0
        if case == "stream":
            job.rbuf = None           # past --stream-replay-bytes
        if case == "stream_replayed":
            job.rbuf = [{"cmd": "stream-data", "job_id": "job-0001",
                         "data": "rec1\tx\n"}]
            job.ended = True
        r.jobs[job.fid] = job
        r.ledger.admit("cl1", gname)
        if case == "orphan_rescue":
            gm.alive = False          # the death was already noted
            r._recover_job(job)       # the row is resolved inside
        else:
            r._member_down(gname)
        if job.terminal is None:
            _wait(lambda: ran)
            with ServiceClient(sib.sock) as c:
                got = c.result(job.mjid, timeout=30)
            assert got["job"]["trace_id"] == "tr-9"
            assert got["rc"] == 0
        if job.sconn is not None:
            job.sconn.close()
        return _mask({
            "member": job.member, "gen": job.gen,
            "failovers": job.failovers, "epoch": job.epoch,
            "router_epoch": r.epoch, "retired": job.retired,
            "terminal": job.terminal, "recovered": r.recovered,
            "ran": [[a if not a.startswith("--stats=") else "--stats"
                     for a in argv] for argv in ran],
            "ledger": r.ledger.client_depths(),
            "set_aside": [os.path.exists(gm.journal_path or ""),
                          os.path.exists((gm.journal_path or "")
                                         + ".recovered")],
        }, paths=(d,))


@pytest.mark.parametrize("case", FAILOVER_CASES)
def test_failover_verdicts_equal_the_reference(tmp_path, case):
    got = {pkg: _failover(pkg, case, str(tmp_path / pkg))
           for pkg in ("port", "ref")}
    assert got["port"] == got["ref"]
    g = got["port"]
    want = {"started": "resumed", "unstarted": "requeued",
            "finished_spool": "restored", "finished_bad_spool": "restored",
            "cancelled": "cancelled", "stream": "stream_preempted",
            "stream_replayed": "stream_replayed",
            "stream_finished": "restored",
            "deadline_spent": "deadline_exceeded", "torn_tail": "resumed",
            "no_journal": "resumed", "no_sibling": "failed",
            "orphan_rescue": "restored"}[case]
    assert g["recovered"][want] == 1
    assert sum(g["recovered"].values()) == 1
    if want in ("resumed", "requeued"):
        assert g["member"] == "sib.sock" and g["gen"] == 1
        assert ("--resume" in g["ran"][0]) == (want == "resumed")
    if case == "finished_spool":
        assert g["terminal"]["stats"] == {"alignments": 7}
        assert g["terminal"]["stderr_tail"] == "tail!"
    if case == "started":
        assert g["set_aside"] == [False, True]
    if case == "no_sibling":
        assert g["ledger"] == {}
        assert "resubmit" in g["terminal"]["job"]["detail"]


# ---------------------------------------------------------------------------
# the scripted frame sequence: reference router + daemons vs the port's
# ---------------------------------------------------------------------------
def _lines(n, qlen, seed):
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
    return q, lines


def _corpus(tmp_path, n=24, qlen=120, seed=3):
    q, lines = _lines(n, qlen, seed)
    fa = tmp_path / "q.fa"
    write_fasta(str(fa), [("q", q.encode())])
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa)


def _job_args(tmp_path, tag, paf, fa, extra=()):
    return [paf, "-r", fa, "-o", str(tmp_path / f"{tag}.dfa"),
            "--device=cpu", "--batch=2",
            f"--stats={tmp_path / f'{tag}.json'}"] + list(extra)


def _cold_ref(tmp_path, tag, paf, fa, extra=()):
    """The reference's cold ``--device=cpu`` run of the job; its bytes."""
    err = io.StringIO()
    assert ref_run(_job_args(tmp_path, tag, paf, fa, extra),
                   stderr=err) == 0, err.getvalue()[:2000]
    return (tmp_path / f"{tag}.dfa").read_bytes()


SCRIPT_MASK = TIMES | {"stats", "flight", "metrics", "queue_depth",
                       "health", "rollup", "uptime_s", "buffered",
                       "stderr_tail", "lanes", "warm", "journal",
                       "epoch", "records"}


def _scripted(sock, d):
    job = ["in.paf", "-r", "q.fa", "-o", "r.dfa", "--device=cpu",
           "--batch=2"]
    frames = [
        {"cmd": "ping"}, {"cmd": "frobnicate"},
        {"cmd": "status", "job_id": "fleet-9999"},
        {"cmd": "result", "job_id": "job-0001"},
        {"cmd": "submit", "args": "not-a-list", "cwd": d},
        {"cmd": "submit", "args": [], "cwd": d},
        {"cmd": "submit", "args": job, "cwd": d, "client": "x" * 65},
        {"cmd": "submit", "args": job, "cwd": d, "deadline_ms": "soon"},
        {"cmd": "submit", "args": job, "cwd": d, "deadline_ms": 0},
        {"cmd": "submit", "args": job, "cwd": d, "client": "alice",
         "trace_id": "drill.1"},
        {"cmd": "result", "job_id": "fleet-0001", "timeout": 60},
        {"cmd": "status", "job_id": "fleet-0001"},
        {"cmd": "inspect", "job_id": "fleet-0001"},
        {"cmd": "cancel", "job_id": "fleet-0001"},
        {"cmd": "stream-data", "job_id": "fleet-0001", "data": "x"},
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
        for fr in ({"cmd": "stats"}, {"cmd": "health"},
                   {"cmd": "logs"}, {"cmd": "drain"},
                   {"cmd": "submit", "args": job, "cwd": d}):
            out.append(c.request(dict(fr)))
    return out


def test_scripted_frames_equal_the_reference(tmp_path):
    """The same frames to a reference router over a reference daemon and
    to a port router over a port daemon (both with ``--slo-rules=off``):
    equal answers once walls, load samples and run counters are masked,
    and the jobs' outputs equal."""
    paf, fa = _corpus(tmp_path, n=10)
    got = {}
    for pkg in ("port", "ref"):
        d = tmp_path / pkg
        d.mkdir()
        for name in (paf, fa):
            shutil.copy(name, d)
        with _fleet(n=1, pkg=pkg, names=["m0.sock"],
                    daemon_kw={"journal_path": None,
                               "slo_rules": "off"},
                    router_kw={"slo_rules": "off"}) as f:
            frames = _scripted(f.sock, str(d))
            _wait(lambda: f.rc == [0], 30)
        got[pkg] = [_mask(fr, SCRIPT_MASK, (str(d),)) for fr in frames]
    for k, (a, b) in enumerate(zip(got["port"], got["ref"])):
        assert a == b, (k, a, b)
    assert len(got["port"]) == len(got["ref"])
    for name in ("r.dfa", "s.dfa"):
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "ref" / name).read_bytes()
    # the fleet ids, not the members' job ids, reach the client
    assert got["port"][9]["job_id"] == "fleet-0001"
    assert got["port"][9]["member"] == "m0.sock"


# ---------------------------------------------------------------------------
# THE drill: kill one of three port daemons behind the port router
# ---------------------------------------------------------------------------
def _serve_env():
    old_pp = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PWASM_DEVICE_PROBE="0",
                PYTHONPATH=REPO + (os.pathsep + old_pp if old_pp
                                   else ""))


def _spawn_members(d, n, extra=()):
    socks, procs = [], []
    for i in range(n):
        s = os.path.join(d, f"m{i}.sock")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pwasm_tpu_torch", "serve",
             f"--socket={s}", *[a.format(i=i) for a in extra]],
            env=_serve_env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
        socks.append(s)
    for s in socks:
        assert wait_for_socket(s, 60)
    return socks, procs


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stderr.close()


def _wait_mid_run(c, jid, ckpt, budget_s=60):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        st = c.status(jid)["job"]["state"]
        if st == "running" and os.path.exists(ckpt):
            return True
        assert st in ("queued", "running"), st
        time.sleep(0.02)
    return False


def test_kill_one_of_three_members_failover_byte_identical(tmp_path):
    """Three port ``serve`` processes behind the port router; SIGKILL the
    member running a mid-run job: the router reads its journal, resumes
    the job on a sibling, and both reports equal the reference's cold
    ``--device=cpu`` runs, with the trace_id intact and one merged
    timeline of client, router and surviving members."""
    from pwasm_tpu_torch.obs import TraceRecorder
    from pwasm_tpu_torch.obs.merge import merge_traces

    paf, fa = _corpus(tmp_path, n=16)
    expect_a = _cold_ref(tmp_path, "colda", paf, fa)
    expect_b = _cold_ref(tmp_path, "coldb", paf, fa)
    d = tempfile.mkdtemp(prefix="pwdrill")
    procs = []
    try:
        socks, procs = _spawn_members(d, 3, ["--trace-json=" + d
                                             + "/m{i}.trace"])
        rtrace = os.path.join(d, "router.trace")
        with _router(socks, poll_interval=0.1, trace_json=rtrace) as rt:
            ctrace = TraceRecorder()
            with ServiceClient(rt.sock, trace_id="drill-trace") as c:
                t0 = ctrace.now()
                ja = c.submit(_job_args(tmp_path, "a", paf, fa, [SLOW]),
                              cwd=str(tmp_path))
                ctrace.complete("submit_rpc", t0, trace_id=c.trace_id)
                jb = c.submit(_job_args(tmp_path, "b", paf, fa),
                              cwd=str(tmp_path))
                assert ja["ok"] and jb["ok"], (ja, jb)
                assert _wait_mid_run(c, ja["job_id"],
                                     str(tmp_path / "a.dfa.ckpt"))
                victim = ja["member"]
                vi = socks.index(rt.router.members[victim].target)
                procs[vi].kill()
                procs[vi].wait(timeout=30)
                t0 = ctrace.now()
                ra = c.result(ja["job_id"], timeout=300)
                ctrace.complete("result_wait", t0, trace_id=c.trace_id)
                rb = c.result(jb["job_id"], timeout=300)
                assert ra.get("rc") == 0, ra
                assert rb.get("rc") == 0, rb
                assert ra["job"]["trace_id"] == "drill-trace"
                assert rb["job"]["trace_id"] == "drill-trace"
                assert ra["job"]["member"] != victim
                assert ra["job"]["failovers"] == 1
                st = c.stats()["stats"]
                assert st["fleet"]["failovers"] == 1
                assert st["fleet"]["jobs_recovered"]["resumed"] == 1
                assert st["ha"]["epoch"] == 2
                c.drain()
            _wait(lambda: rt.rc == [0], 30)
        assert (tmp_path / "a.dfa").read_bytes() == expect_a
        assert (tmp_path / "b.dfa").read_bytes() == expect_b
        assert os.path.exists(socks[vi] + ".journal.recovered")
        for i, p in enumerate(procs):
            if i != vi:
                with ServiceClient(socks[i]) as c:
                    c.drain()
                assert p.wait(timeout=120) == 75
        ctrace_path = os.path.join(d, "client.trace")
        ctrace.write(ctrace_path)
        docs = [("client", json.load(open(ctrace_path))),
                ("router", json.load(open(rtrace)))]
        for i in range(3):
            tr = os.path.join(d, f"m{i}.trace")
            if i != vi and os.path.exists(tr):
                docs.append((f"member{i}", json.load(open(tr))))
        assert len(docs) == 4
        merged = merge_traces(docs)
        pids = {e["pid"] for e in merged["traceEvents"]
                if isinstance(e.get("args"), dict)
                and e["args"].get("trace_id") == "drill-trace"}
        assert len(pids) >= 3, pids
    finally:
        _reap(procs)
        shutil.rmtree(d, ignore_errors=True)


def test_routed_outputs_equal_the_reference_cold_run(tmp_path):
    """``route`` as a process over two port ``serve`` processes: routed
    jobs land on both members and their outputs equal the reference's
    cold ``--device=cpu`` runs."""
    paf, fa = _corpus(tmp_path, n=8)
    expect = _cold_ref(tmp_path, "cold", paf, fa)
    d = tempfile.mkdtemp(prefix="pwrtp")
    procs = []
    try:
        socks, procs = _spawn_members(d, 2)
        rsock = os.path.join(d, "r.sock")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pwasm_tpu_torch", "route",
             "--backends=" + ",".join(socks), f"--socket={rsock}",
             "--poll-interval=0.1"],
            env=_serve_env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
        assert wait_for_socket(rsock, 60)
        with ServiceClient(rsock) as c:
            subs = [c.submit(_job_args(tmp_path, f"j{k}", paf, fa),
                             cwd=str(tmp_path)) for k in range(2)]
            for s in subs:
                assert s["ok"], s
                assert c.result(s["job_id"], timeout=120)["rc"] == 0
            assert c.drain()["ok"]
        assert procs[2].wait(timeout=60) == 0
        assert {s["member"] for s in subs} == {"m0.sock", "m1.sock"}
        for k in range(2):
            assert (tmp_path / f"j{k}.dfa").read_bytes() == expect
    finally:
        _reap(procs)
        shutil.rmtree(d, ignore_errors=True)
