"""The port router's fleet-wide scatter of ``--m2m-stream`` against the
JAX package's, on the CPU.

Ports of the scatter cases of ``tests/test_surveil.py``: a stream
opened against a router with two or more live members is partitioned,
one sub-stream a member, and the members' section fragments are spliced
back into one report.  Here the same frames go through a port router
over port daemons and a reference router over reference daemons (real
runners, ``--device=cpu``): the same answers, scatter stats, ``status``
and ``inspect`` once walls are masked, and reports equal to each other
and to the reference's cold un-scattered run over the same arrival
order.  A member SIGKILLed mid-stream is re-partitioned onto a
survivor, and the merged report still equals the cold run.  Which
frames are eligible is held to the reference too.
"""

import io
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu_torch.fleet.router import Router
from pwasm_tpu_torch.service.client import ServiceClient, wait_for_socket

from test_torch_fleet import (PKGS, TIMES, _fleet, _mask, _reap,
                              _serve_env, _wait)
from test_torch_surveil import _corpus, _write_targets

MASK = TIMES | {"wall_s", "elapsed_s", "stderr_tail", "flight", "phases",
                "pairs_s", "dispatch_s", "score_s", "splice_s"}


def _ref_cold(tmp_path, qfa, recs, tag):
    """The reference's cold un-scattered ``--m2m-stream`` over ``recs``
    in their order: (report, summary)."""
    tfa = _write_targets(tmp_path, recs, f"{tag}.fa")
    o, s = str(tmp_path / f"{tag}.tsv"), str(tmp_path / f"{tag}.sum")
    err = io.StringIO()
    assert ref_run(["--m2m-stream", tfa, "-r", qfa, "-o", o, "-s", s,
                    "--device=cpu"], stderr=err) == 0, err.getvalue()
    return open(o, "rb").read(), open(s, "rb").read()


def _scattered(pkg, d, qfa, text):
    """One ``--m2m-stream`` through a router of ``pkg`` over three of its
    daemons: the answers, the job's status and inspect, and the
    outputs."""
    o, s = os.path.join(d, "sc.tsv"), os.path.join(d, "sc.sum")
    names = [f"m{i}.sock" for i in range(3)]
    with _fleet(3, pkg=pkg, names=names,
                daemon_kw={"journal_path": None, "slo_rules": "off"},
                router_kw={"slo_rules": "off"}) as f:
        with ServiceClient(f.sock, trace_id="scatter") as c:
            _wait(lambda: c.stats()["stats"]["fleet"]["alive"] == 3, 30)
            r = c.stream(["--m2m-stream", "-r", qfa, "-o", o, "-s", s,
                          "--device=cpu"],
                         [text[i:i + 73] for i in range(0, len(text), 73)],
                         cwd=d)
            res = c.result(r["job_id"], timeout=120)
            st = c.status(r["job_id"])
            ins = c.request({"cmd": "inspect", "job_id": r["job_id"]})
    stats = res.get("stats") or {}
    got = {"open": r, "rc": res.get("rc"), "state": res["job"]["state"],
           "detail": res["job"].get("detail"),
           "scatter": stats.get("scatter"),
           "targets_in": (stats.get("m2m") or {}).get("targets_in"),
           "status": st, "inspect": ins}
    litter = [p for p in os.listdir(d) if ".frag" in p]
    return (_mask(got, MASK, (d,)), open(o, "rb").read(),
            open(s, "rb").read(), litter)


@pytest.mark.parametrize("order", ["arrival", "shuffled"])
def test_scatter_equals_the_reference_router_and_cold_run(tmp_path, order):
    """Three members, nine targets in 73-character frames: both routers
    scatter over all three, answer alike, and merge reports equal to
    the reference's cold run over the same order, leaving no fragment
    behind."""
    qfa, recs = _corpus(tmp_path, nt=9)
    if order == "shuffled":
        random.Random(4).shuffle(recs)
    expect_o, expect_s = _ref_cold(tmp_path, qfa, recs, "cold")
    text = "".join(recs)
    got = {}
    for pkg in ("port", "ref"):
        d = tmp_path / pkg
        d.mkdir()
        shutil.copy(qfa, d / "q.fa")
        got[pkg] = _scattered(pkg, str(d), str(d / "q.fa"), text)
    assert got["port"][0] == got["ref"][0]
    ans, o, s, litter = got["port"]
    assert ans["open"]["ok"] and len(ans["open"]["scatter"]) == 3, ans
    assert ans["rc"] == 0 and ans["state"] == "done", ans
    assert ans["scatter"] == {"subs": 3, "records": 9, "failovers": 0}
    assert ans["targets_in"] == 9
    assert (o, s) == (expect_o, expect_s)
    assert (got["ref"][1], got["ref"][2]) == (expect_o, expect_s)
    assert litter == [] and got["ref"][3] == []


def test_scatter_kill_member_midstream_repartitions_to_parity(tmp_path):
    """SIGKILL the member holding sub-stream 0 mid-stream: the router
    re-partitions its records onto a survivor, the client never sees
    the death, and the merged report equals the reference's cold run,
    with one failover in the scatter stats."""
    qfa, recs = _corpus(tmp_path, nt=9, seed=23)
    expect_o, expect_s = _ref_cold(tmp_path, qfa, recs, "cold")
    d = tempfile.mkdtemp(prefix="pwscat")
    socks, procs = [], []
    o, s = str(tmp_path / "kd.tsv"), str(tmp_path / "kd.sum")
    router = None
    try:
        for i in range(3):
            sk = os.path.join(d, f"m{i}.sock")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pwasm_tpu_torch", "serve",
                 f"--socket={sk}"],
                env=_serve_env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
            socks.append(sk)
        for sk in socks:
            assert wait_for_socket(sk, 60)
        rsock = os.path.join(d, "router.sock")
        rerr = io.StringIO()
        router = Router(socks, socket_path=rsock, stderr=rerr,
                        poll_interval=0.1)
        rt = threading.Thread(target=router.serve, daemon=True)
        rt.start()
        assert wait_for_socket(rsock, 15)
        with ServiceClient(rsock) as c:
            _wait(lambda: c.stats()["stats"]["fleet"]["alive"] == 3, 30)
            r = c.stream_open(["--m2m-stream", "-r", qfa, "-o", o, "-s", s,
                               "--device=cpu"], cwd=str(tmp_path))
            assert r.get("ok") and len(r.get("scatter") or []) == 3, r
            jid = r["job_id"]
            for t in recs[:5]:
                assert c.stream_data(jid, t).get("ok")
            victim = r["scatter"][0]
            vi = socks.index(router.members[victim].target)
            procs[vi].kill()
            procs[vi].wait(timeout=30)
            for t in recs[5:]:
                assert c.stream_data(jid, t).get("ok")
            assert c.stream_end(jid).get("ok")
            res = c.result(jid, timeout=120)
            assert res.get("ok") and res.get("rc") == 0, res
            sc = (res.get("stats") or {}).get("scatter")
            assert sc == {"subs": 3, "records": 9, "failovers": 1}, sc
            st = c.stats()["stats"]
            assert st["fleet"]["jobs_recovered"]["stream_replayed"] == 1
            c.drain()
        rt.join(20)
        assert any("re-partitioned" in ln
                   for ln in rerr.getvalue().splitlines()), rerr.getvalue()
    finally:
        if router is not None and not router.drain.requested:
            router.drain.request("test teardown")
        _reap(procs)
        shutil.rmtree(d, ignore_errors=True)
    assert open(o, "rb").read() == expect_o
    assert open(s, "rb").read() == expect_s


@pytest.mark.parametrize("args", [
    ["--m2m-stream", "-r", "q.fa", "-o", "x.tsv"],
    ["--m2m-stream", "-r", "q.fa", "-s", "x.sum"],
    ["-r", "q.fa", "-o", "x.dfa"],
    ["--m2m-stream", "-r", "q.fa", "-o", 7],
    "--m2m-stream -o x",
    None])
def test_scatter_eligibility_equals_the_reference(args):
    frame = {"args": args, "cwd": "/w"}
    got = {pkg: PKGS[pkg].Router._scatter_eligible(frame)
           for pkg in ("port", "ref")}
    assert got["port"] == got["ref"]
    assert got["port"] is (args == ["--m2m-stream", "-r", "q.fa",
                                    "-o", "x.tsv"])
