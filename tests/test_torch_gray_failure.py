"""The port router's gray-failure defense against the JAX package's, on
the CPU.

Ports of the router cases of ``tests/test_gray_failure.py``: the
slow-member quarantine and the brownout shed controller, each driven by
the same scripted round-trip and pressure sequences into both routers
with equal transitions (and equal operator lines); the surfaces that
show them (``svc-stats``' blocks, ``top``); the router's deadline
decrement; the end-to-end truthful shed; and the gray drill, with
``qa/fleet_chaos.py``'s ``ChaosProxy`` and ``StopWindows`` in front of
port members.
"""

import io
import os
import random
import subprocess
import sys
import tempfile
import time

import pytest

from pwasm_tpu.service.top import render as ref_render
from pwasm_tpu_torch.fleet.transport import target_name
from pwasm_tpu_torch.service.client import ServiceClient, wait_for_socket
from pwasm_tpu_torch.service.top import render

from test_torch_fleet import (PKGS, REPO, TIMES, _daemon, _fleet, _mask,
                              _router, _serve_env, _stub_runner, _wait)

sys.path.insert(0, os.path.join(REPO, "qa"))
from fleet_chaos import (ChaosProxy, StopWindows,  # noqa: E402
                         gray_drill, wait_until)


def _mkrouter(pkg, n, **kw):
    """A router of ``pkg`` that never serves: the detector and the
    controller run against hand-set member state."""
    d = tempfile.mkdtemp(prefix="pwgray")
    err = io.StringIO()
    r = PKGS[pkg].Router([f"/nowhere/m{i}.sock" for i in range(n)],
                         socket_path=os.path.join(d, "r.sock"),
                         stderr=err, **kw)
    for m in r.members.values():
        m.alive = True
    return r, err


def _member_state(r):
    return [(m.name, m.quarantined, m.q_strikes, m.q_clean,
             m.quarantines) for m in r.members.values()]


# ---------------------------------------------------------------------------
# quarantine: scripted and seeded round-trip sequences into both routers
# ---------------------------------------------------------------------------
def _quarantine_trace(pkg, n, kw, steps, preset=()):
    r, err = _mkrouter(pkg, n, **kw)
    for name in preset:
        r.members[name].quarantined = True
    out = []
    for lats in steps:
        for m, v in zip(r.members.values(), lats):
            if v is None:
                m.alive = False
            else:
                m.alive = True
                m.lat_ewma_ms = v
        r._quarantine_scan()
        out.append((_member_state(r),
                    [m.name for m in r._members_by_depth()],
                    r.metrics["quarantines"].value()))
    return out, err.getvalue()


QUARANTINE_SCRIPTS = {
    # two strikes to enter
    "strikes": (3, {"quarantine_x": 3.0}, [[100.0, 100.0, 900.0]] * 3, ()),
    # under the 50 ms floor a 10x outlier is noise
    "floor": (3, {"quarantine_x": 3.0}, [[0.01, 0.01, 0.1]] * 4, ()),
    # never below one eligible member
    "last_eligible": (3, {"quarantine_x": 3.0},
                      [[900.0, 100.0, 100.0]] * 3,
                      ("m1.sock", "m2.sock")),
    # two samples cannot name an outlier
    "two_members": (2, {"quarantine_x": 3.0}, [[100.0, 900.0]] * 3, ()),
    "disabled": (3, {"quarantine_x": 0.0}, [[100.0, 100.0, 9000.0]] * 3,
                 ()),
    "single": (1, {"quarantine_x": 3.0}, [[9000.0]] * 3, ()),
    # probation: two clean polls release; a relapse starts over
    "probation": (3, {"quarantine_x": 3.0, "quarantine_probation": 2},
                  [[100.0, 100.0, 900.0]] * 2
                  + [[100.0, 100.0, 110.0]] * 2
                  + [[100.0, 100.0, 900.0]] * 2, ()),
    # a dead member leaves the sample; all quarantined falls back
    "dead_and_fallback": (3, {"quarantine_x": 2.0},
                          [[100.0, 300.0, 900.0]] * 3
                          + [[None, 300.0, 900.0]] * 2, ()),
}


@pytest.mark.parametrize("name", sorted(QUARANTINE_SCRIPTS))
def test_quarantine_scripts_equal_the_reference(name):
    n, kw, steps, preset = QUARANTINE_SCRIPTS[name]
    port = _quarantine_trace("port", n, kw, steps, preset)
    assert port == _quarantine_trace("ref", n, kw, steps, preset)
    states = port[0]
    if name == "strikes":
        assert [s[0][2][1] for s in states] == [False, True, True]
    if name in ("floor", "two_members", "disabled", "single",
                "last_eligible"):
        assert not any(q for s in states for (_n, q, *_r) in s[0]
                       if _n not in preset)
    if name == "probation":
        assert [s[0][2][1] for s in states] \
            == [False, True, True, False, False, True]
        assert "left quarantine (2 clean polls)" in port[1]


def _random_steps(seed, n):
    rng = random.Random(seed)
    steps = []
    for _ in range(30):
        steps.append([None if rng.random() < 0.05 else
                      rng.choice([rng.uniform(1, 60),
                                  rng.uniform(60, 400),
                                  rng.uniform(400, 3000)])
                      for _ in range(n)])
    return steps


@pytest.mark.parametrize("seed", range(4))
def test_quarantine_seeded_rtts_equal_the_reference(seed):
    n = 3 + seed % 3
    kw = {"quarantine_x": [2.0, 3.0, 4.0][seed % 3],
          "quarantine_probation": 1 + seed % 3}
    steps = _random_steps(seed, n)
    port = _quarantine_trace("port", n, kw, steps)
    assert port == _quarantine_trace("ref", n, kw, steps)


# ---------------------------------------------------------------------------
# the surfaces: svc-stats' blocks and top
# ---------------------------------------------------------------------------
def test_fleet_stats_blocks_and_top_equal_the_reference():
    got = {}
    for pkg in ("port", "ref"):
        r, _err = _mkrouter(pkg, 3, quarantine_x=4.0,
                            quarantine_probation=5,
                            priority_lanes=("rt", "bulk"))
        r.members["m2.sock"].quarantined = True
        r.members["m2.sock"].lat_ewma_ms = 123.456
        r.members["m1.sock"].alive = False
        st0 = r._fleet_stats()
        r._shed_level = 1
        st1 = r._fleet_stats()
        got[pkg] = [_mask(st, TIMES | {"path", "records"}) for st in
                    (st0, st1)]
    # no --scale-policy: ha.scaler is {"enabled": false} in both
    assert got["port"] == got["ref"]
    st0, st1 = got["port"]
    row = [m for m in st0["fleet"]["members"] if m["name"] == "m2.sock"]
    assert row[0]["quarantined"] is True
    assert st0["fleet"]["quarantined"] == 1
    assert st0["ha"]["quarantine"] == {"x": 4.0, "probation": 5,
                                       "members": 1}
    assert st0["ha"]["shed"] == {"level": 0, "priority_lanes": ["rt",
                                                                "bulk"],
                                 "lanes_shed": []}
    assert st1["ha"]["shed"]["lanes_shed"] == ["bulk"]
    assert st0["health"]["members"]["m1.sock"]["verdict"] \
        == "unreachable"


def test_top_renders_quarantine_state_and_shed_banner():
    st = {"uptime_s": 10.0,
          "fleet": {"members": [
              {"name": "m0.sock", "alive": True, "queue_depth": 1,
               "running": 1, "jobs_routed": 5, "lat_ewma_ms": 12.0},
              {"name": "m1.sock", "alive": True, "quarantined": True,
               "queue_depth": 0, "running": 0, "jobs_routed": 2,
               "lat_ewma_ms": 640.0},
          ], "alive": 2},
          "ha": {"shed": {"level": 1, "lanes_shed": ["bulk"]}}}
    frame = render(st)
    assert frame == ref_render(st)
    assert "QUAR" in frame and "640" in frame
    assert "SHEDDING: tier(s) bulk turned away (level 1)" in frame


# ---------------------------------------------------------------------------
# brownout shedding: scripted pressure sequences into both routers
# ---------------------------------------------------------------------------
def _shed_trace(pkg, lanes, script, self_paced=False):
    r, err = _mkrouter(pkg, 2, priority_lanes=lanes)
    probe = list(lanes or ()) + ["", None, "mystery"]
    out = []
    for firing in script:
        r.slo.firing = lambda f=firing: [{"rule": x} for x in f]
        if not self_paced:
            r._shed_last = -1e9
        r._shed_tick()
        checks = []
        for lane in probe:
            resp = r._shed_check(lane)
            checks.append(None if resp is None else _mask(resp))
        out.append((r._shed_level, r._shed_clean, checks,
                    r.metrics["shedding"].value()))
    return out, err.getvalue()


P = ["fleet_queue_pressure"]
L = ["ledger_saturation"]
SHED_SCRIPTS = {
    "escalate_top_tier_kept": (("rt", "bulk", "batch"), [P] * 4),
    "hysteresis": (("rt", "bulk"), [L] + [[]] * 4),
    "flap": (("rt", "bulk", "batch"),
             [P, P, [], P, [], [], [], [], [], [], []]),
    "other_rules_no_pressure": (("rt", "bulk"), [["member_down"]] * 3),
    "inert_without_lanes": (None, [P] * 3),
}


@pytest.mark.parametrize("name", sorted(SHED_SCRIPTS))
def test_shed_scripts_equal_the_reference(name):
    lanes, script = SHED_SCRIPTS[name]
    port = _shed_trace("port", lanes, script)
    assert port == _shed_trace("ref", lanes, script)
    levels = [s[0] for s in port[0]]
    if name == "escalate_top_tier_kept":
        assert levels == [1, 2, 2, 2]
        rt_check = port[0][-1][2][0]
        assert rt_check is None
        bulk = port[0][-1][2][1]
        assert bulk["error"] == "overloaded" and "retry" in bulk["detail"]
    if name == "hysteresis":
        assert levels == [1, 1, 1, 0, 0]
    if name in ("inert_without_lanes", "other_rules_no_pressure"):
        assert set(levels) == {0}


def test_shed_tick_self_paced_against_stats_poll_storm():
    """The controller paces itself off its own clock: a poller that
    keeps ``slo.due()`` false cannot starve it, and back-to-back ticks
    inside one evaluation interval are no-ops — in both routers."""
    got = {}
    for pkg in ("port", "ref"):
        r, _err = _mkrouter(pkg, 2, priority_lanes=("rt", "bulk"))
        r.slo.firing = lambda: [{"rule": "fleet_queue_pressure"}]
        r.slo._last_eval = time.monotonic()
        assert not r.slo.due()
        r._shed_last = -1e9
        r._shed_tick()
        first = r._shed_level
        r._shed_tick()
        got[pkg] = (first, r._shed_level)
    assert got["port"] == got["ref"] == (1, 1)


# ---------------------------------------------------------------------------
# end to end, over in-process port members
# ---------------------------------------------------------------------------
def test_router_decrements_deadline_toward_member(tmp_path):
    log = []
    with _fleet(n=2, runner=_stub_runner(log=log)) as f:
        with ServiceClient(f.sock, deadline_s=0.02) as c:
            time.sleep(0.05)
            s = c.submit(["in.paf", "-o", str(tmp_path / "o")])
            assert not s.get("ok")
            assert s.get("error") == "deadline_exceeded"
        with ServiceClient(f.sock, deadline_s=30.0) as c:
            s = c.submit(["in.paf", "-o", str(tmp_path / "o")])
            assert s.get("ok"), s
            assert c.result(s["job_id"], timeout=30).get("rc") == 0
        with ServiceClient(f.sock) as c:
            for bad in ("soon", True):
                r = c.request({"cmd": "submit", "args": ["x.paf"],
                               "deadline_ms": bad})
                assert r.get("error") == "bad_request"
    flags = [a for argv in log for a in argv
             if a.startswith("--deadline-s=")]
    assert len(flags) == 1
    assert 0.0 < float(flags[0].split("=", 1)[1]) < 30.0


def test_shed_end_to_end_truthful_refusal_and_rt_admission(
        tmp_path, monkeypatch):
    lanes = ("rt", "bulk")
    with _fleet(n=1, runner=_stub_runner(),
                router_kw={"priority_lanes": lanes},
                daemon_kw={"priority_lanes": lanes}) as f:
        monkeypatch.setattr(f.router.slo, "firing",
                            lambda: [{"rule": "fleet_queue_pressure"}])
        assert wait_until(lambda: f.router._shed_level >= 1, 10.0)
        with ServiceClient(f.sock, trace_id="shed-e2e") as c:
            bulk = c.submit(["in.paf", "-o", str(tmp_path / "b")],
                            priority="bulk")
            assert not bulk.get("ok")
            assert bulk.get("error") == "overloaded"
            assert bulk.get("lane") == "bulk"
            assert float(bulk.get("retry_after_s") or 0) > 0
            rt = c.submit(["in.paf", "-o", str(tmp_path / "r")],
                          priority="rt")
            assert rt.get("ok"), rt
            assert c.result(rt["job_id"], timeout=30).get("rc") == 0
            sh = c.stats()["stats"]["ha"]["shed"]
            assert sh["lanes_shed"] == ["bulk"]
        # the transition is in the router's journal
        recs = f.router.rjournal.replay()
        assert any(r["rec"] == "route_shed" and r["level"] == 1
                   for r in recs)
        monkeypatch.setattr(f.router.slo, "firing", lambda: [])
        assert wait_until(lambda: f.router._shed_level == 0, 10.0)


def test_gray_drill_chaos_proxy_quarantines_and_releases():
    """``qa/fleet_chaos.py``'s drill over three port members, one behind
    a ``ChaosProxy`` whose latency makes it an outlier: the port router
    quarantines it (alive, never down), one member always stays
    eligible, and it leaves quarantine once the latency goes."""
    with _daemon(runner=_stub_runner(sleep=0.01)) as m0, \
            _daemon(runner=_stub_runner(sleep=0.01)) as m1, \
            _daemon(runner=_stub_runner(sleep=0.01)) as m2:
        proxy = ChaosProxy(m2.sock)
        addr = proxy.start()
        try:
            with _router([m0.sock, m1.sock, addr],
                         quarantine_x=3.0) as rt:
                time.sleep(0.6)     # healthy EWMAs converge first
                proxy.delay_s = 0.5
                res = gray_drill(rt.sock, target_name(addr),
                                 relieve=lambda: setattr(proxy,
                                                         "delay_s", 0.0))
                assert not rt.router.members[target_name(addr)] \
                    .quarantined
                assert rt.router.members[target_name(addr)].alive
        finally:
            proxy.stop()
    assert res["quarantined"] and res["recovered"], res
    assert res["eligible_floor_held"] and res["quarantines_total"] == 1


def test_gray_drill_stop_windows_on_a_member_process(tmp_path):
    """``StopWindows`` freezes a port ``serve`` process in short windows
    (a GC-storm shaped gray failure): its polls slow past the floor and
    the fleet median, the port router quarantines it without declaring
    it dead, and once the windows stop it is released."""
    d = tempfile.mkdtemp(prefix="pwsw")
    sock = os.path.join(d, "frozen.sock")
    p = subprocess.Popen([sys.executable, "-m", "pwasm_tpu_torch",
                          "serve", f"--socket={sock}", "--journal=off"],
                         env=_serve_env(), stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    sw = None
    try:
        assert wait_for_socket(sock, 60)
        with _daemon(runner=_stub_runner()) as m0, \
                _daemon(runner=_stub_runner()) as m1:
            with _router([m0.sock, m1.sock, sock], quarantine_x=3.0,
                         quarantine_probation=2) as rt:
                frozen = rt.router.members["frozen.sock"]
                _wait(lambda: frozen.alive and frozen.lat_ewma_ms > 0)
                sw = StopWindows(p.pid, stop_s=0.4, run_s=0.05).start()
                _wait(lambda: frozen.quarantined, 20)
                assert frozen.alive
                sw.stop()
                sw = None
                _wait(lambda: not frozen.quarantined, 20)
                assert frozen.quarantines == 1
                with ServiceClient(rt.sock) as c:
                    st = c.stats()["stats"]
                assert st["fleet"]["alive"] == 3
                assert rt.router.failovers == 0
    finally:
        if sw is not None:
            sw.stop()
        if p.poll() is None:
            p.kill()
        p.wait()
        import shutil
        shutil.rmtree(d, ignore_errors=True)
