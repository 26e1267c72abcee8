"""The port's warm standby (``route --standby-of``) against the JAX
package's, on the CPU.

Ports of the standby cases of ``tests/test_fleet_ha.py`` and of the
standby half of ``tests/test_transport_security.py``'s mTLS drill:
``route_main``'s refusals of ``--backends``/``--socket``/``--listen``
beside ``--standby-of`` and of a broken ``--scale-policy``, each message
equal to the reference's; ``run_standby``'s refusal of a TCP primary
and of a dead primary whose journal holds no member set; the ``ha``
block of a router that took over a journal with scaler spawns in it,
equal to the reference router's on the same journal; and three drills
with port ``serve`` processes behind a port ``route`` process and a
port standby: a SIGKILLed primary with a job in flight, the same under
live client traffic, and an all-mTLS fleet.  Every report equals the
reference's cold ``--device=cpu`` run.
"""

import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from pwasm_tpu.fleet.standby import run_standby as ref_run_standby
from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
from pwasm_tpu_torch.fleet.standby import run_standby
from pwasm_tpu_torch.fleet.transport import router_journal_path
from pwasm_tpu_torch.service.client import (ServiceClient, ServiceError,
                                            wait_for_socket)

from test_torch_fleet import (PKGS, SLOW, TIMES, _cold_ref, _corpus,
                              _job_args, _mask, _reap, _serve_env,
                              _spawn_members, _wait, _wait_mid_run)

CERTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "certs")
CA = os.path.join(CERTS, "ca.pem")
SRV_CERT = os.path.join(CERTS, "server.pem")
SRV_KEY = os.path.join(CERTS, "server.key")
ADMIN_CERT = os.path.join(CERTS, "fleet-admin.pem")
ADMIN_KEY = os.path.join(CERTS, "fleet-admin.key")


# ---------------------------------------------------------------------------
# route_main's refusals beside --standby-of, and of a broken policy
# ---------------------------------------------------------------------------
def _refusal_cases(d):
    return {
        "standby_with_backends": ["--standby-of=/p.sock",
                                  "--backends=a.sock"],
        "standby_with_socket": ["--standby-of=/p.sock", f"--socket={d}/r"],
        "standby_with_listen": ["--standby-of=/p.sock",
                                "--listen=127.0.0.1:9211"],
        "standby_with_backends_and_listen": [
            "--standby-of=/p.sock", "--backends=a.sock",
            "--listen=127.0.0.1:9211"],
        "scale_policy_missing": ["--backends=a.sock", f"--socket={d}/r",
                                 f"--scale-policy={d}/nope.json"],
        "scale_policy_not_json": ["--backends=a.sock", f"--socket={d}/r",
                                  f"--scale-policy={d}/bad.json"],
        "scale_policy_no_socket_dir": ["--backends=a.sock",
                                       f"--socket={d}/r",
                                       f"--scale-policy={d}/nodir.json"],
    }


@pytest.mark.parametrize("case", list(_refusal_cases("d")))
def test_route_main_standby_and_policy_refusals_equal_the_reference(
        tmp_path, case):
    """Each refusal exits 1 with the reference's message, usage text
    included, and binds nothing."""
    d = str(tmp_path)
    (tmp_path / "bad.json").write_text("{nope")
    (tmp_path / "nodir.json").write_text(json.dumps({"max_members": 2}))
    argv = _refusal_cases(d)[case]
    got = {}
    for pkg in ("port", "ref"):
        err = io.StringIO()
        rc = PKGS[pkg].route_main(list(argv), stderr=err)
        got[pkg] = (rc, err.getvalue())
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1
    assert "Error: " in got["port"][1]
    assert not os.path.exists(os.path.join(d, "r"))


# ---------------------------------------------------------------------------
# run_standby's own refusals
# ---------------------------------------------------------------------------
def test_standby_refuses_tcp_primary():
    """A takeover binds the primary's socket; a TCP endpoint cannot be
    bound from here.  The same exit and message as the reference's."""
    got = {}
    for name, fn in (("port", run_standby), ("ref", ref_run_standby)):
        err = io.StringIO()
        got[name] = (fn("host:9211", stderr=err), err.getvalue())
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1 and "SOCKET" in got["port"][1]


def test_standby_without_member_snapshot_refuses_takeover(tmp_path):
    """A dead primary whose journal exists but holds no ``members``
    record: after its strikes the standby refuses to take over (exit
    1), as the reference's does, and binds nothing."""
    got = {}
    for name, fn in (("port", run_standby), ("ref", ref_run_standby)):
        d = tmp_path / name
        d.mkdir()
        primary = str(d / "r.sock")
        jpath = router_journal_path(primary, None, None)
        with open(jpath, "w") as f:
            f.write(json.dumps({"v": 1, "rec": "epoch", "epoch": 2}) + "\n")
        err = io.StringIO()
        rc = fn(primary, stderr=err,
                router_kwargs={"poll_interval": 0.05})
        got[name] = (rc, err.getvalue().replace(str(d), "<d>"))
        assert not os.path.exists(primary)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1
    assert "holds no members snapshot" in got["port"][1]


# ---------------------------------------------------------------------------
# the ha block of a router that took over
# ---------------------------------------------------------------------------
def _took_over(pkg, d, recs):
    """A ``takeover=True`` router of ``pkg`` opening a journal of
    ``recs`` (with two scaler spawns, one retired): its ha block and
    member rows."""
    os.makedirs(d)
    sock = os.path.join(d, "r.sock")
    with open(sock + ".router.journal", "w") as f:
        for r in recs:
            f.write(json.dumps(r).replace("<d>", d) + "\n")
    pol = {"min_members": 1, "max_members": 3, "cooldown_s": 0.0,
           "hysteresis": 1, "scale_down_after_s": 5.0,
           "rules": ["queue_pressure"],
           "spawn": {"socket_dir": d, "args": []}}
    r = PKGS[pkg].Router([os.path.join(d, "m0.sock")], socket_path=sock,
                         stderr=io.StringIO(), poll_interval=999,
                         takeover=True, scale_policy=pol)
    r._open_journal()
    r.rjournal.close()
    st = r._fleet_stats()
    rows = [{k: m[k] for k in ("name", "alive", "scaled")}
            for m in st["fleet"]["members"]]
    return _mask({"ha": st["ha"], "members": rows}, TIMES, (d,))


def test_takeover_ha_block_and_scaled_readoption_equal_the_reference(
        tmp_path):
    recs = [
        {"v": 1, "rec": "members", "backends": ["<d>/m0.sock"]},
        {"v": 1, "rec": "epoch", "epoch": 2},
        {"v": 1, "rec": "scale", "action": "spawn",
         "target": "<d>/scaled-1.sock", "pid": 11, "why": ["x"]},
        {"v": 1, "rec": "scale", "action": "spawn",
         "target": "<d>/scaled-2.sock", "pid": 12, "why": ["x"]},
        {"v": 1, "rec": "scale", "action": "retire",
         "target": "<d>/scaled-2.sock", "pid": 12},
    ]
    got = {pkg: _took_over(pkg, str(tmp_path / pkg), recs)
           for pkg in ("port", "ref")}
    assert got["port"] == got["ref"]
    ha = got["port"]["ha"]
    assert ha["takeover"] is True and ha["epoch"] == 3
    assert ha["scaler"]["enabled"] is True
    assert ha["scaler"]["owned"] == 1
    assert {(m["name"], m["scaled"]) for m in got["port"]["members"]} \
        == {("m0.sock", False), ("scaled-1.sock", True)}


# ---------------------------------------------------------------------------
# the drills: port serve processes, a port route process, a port standby
# ---------------------------------------------------------------------------
def _route_proc(argv):
    return subprocess.Popen(
        [sys.executable, "-m", "pwasm_tpu_torch", "route", *argv],
        env=_serve_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def _wait_takeover(rsock, budget_s=60):
    """Seconds until the primary's socket answers a ping again."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < budget_s:
        try:
            with ServiceClient(rsock, timeout=2.0) as c:
                if c.request({"cmd": "ping"}).get("ok"):
                    return time.monotonic() - t0
        except (ServiceError, OSError):
            pass
        time.sleep(0.05)
    raise AssertionError("the standby never took over the primary's socket")


def _drain_all(rsock, standby, socks, procs):
    with ServiceClient(rsock) as c:
        assert c.drain()["ok"]
    assert standby.wait(timeout=60) == 0
    for i, s in enumerate(socks):
        with ServiceClient(s) as c:
            c.drain()
        assert procs[i].wait(timeout=60) == EXIT_PREEMPTED


def test_standby_takeover_kill9_mid_job_byte_identical(tmp_path):
    """SIGKILL the primary router with a slowed job mid-run: the standby
    binds the same socket, the job lands rc 0 with the reference's cold
    bytes and its trace_id, and svc-stats says takeover, a bumped epoch
    and both members."""
    paf, fa = _corpus(tmp_path, n=12)
    expect = _cold_ref(tmp_path, "cold", paf, fa, [SLOW])
    d = tempfile.mkdtemp(prefix="pwsb")
    procs = []
    try:
        socks, procs = _spawn_members(d, 2)
        rsock = os.path.join(d, "router.sock")
        primary = _route_proc(["--backends=" + ",".join(socks),
                               f"--socket={rsock}", "--poll-interval=0.1"])
        procs.append(primary)
        assert wait_for_socket(rsock, 30)
        standby = _route_proc([f"--standby-of={rsock}",
                               "--poll-interval=0.1"])
        procs.append(standby)
        with ServiceClient(rsock, trace_id="ha-drill") as c:
            ja = c.submit(_job_args(tmp_path, "a", paf, fa, [SLOW]),
                          cwd=str(tmp_path))
            assert ja["ok"], ja
            assert _wait_mid_run(c, ja["job_id"],
                                 str(tmp_path / "a.dfa.ckpt"))
        primary.kill()
        primary.wait(timeout=30)
        _wait_takeover(rsock)
        assert standby.poll() is None
        with ServiceClient(rsock, trace_id="ha-drill") as c:
            ra = c.result(ja["job_id"], timeout=120)
            assert ra.get("rc") == 0, ra
            assert ra["job"]["trace_id"] == "ha-drill"
            st = c.stats()["stats"]
        assert st["ha"]["takeover"] is True
        assert st["ha"]["epoch"] >= 2
        assert st["ha"]["scaler"] == {"enabled": False}
        assert len(st["fleet"]["members"]) == 2
        _drain_all(rsock, standby, socks, procs)
        assert (tmp_path / "a.dfa").read_bytes() == expect
    finally:
        _reap(procs)
        shutil.rmtree(d, ignore_errors=True)


def test_standby_takeover_under_live_client_traffic(tmp_path):
    """A pump thread keeps submitting through the takeover window, each
    submit retried on the same address: two jobs land before the
    SIGKILL and two after the standby binds, and every acknowledged job
    lands rc 0 with the reference's cold bytes."""
    paf, fa = _corpus(tmp_path, n=6)
    expect = _cold_ref(tmp_path, "cold", paf, fa)
    d = tempfile.mkdtemp(prefix="pwsblv")
    procs = []
    stop = threading.Event()
    done: list = []
    pump_err: list = []

    def pump(rsock):
        k = 0
        while not stop.is_set():
            tag = f"lv{k}"          # a fresh tag per submit attempt
            k += 1
            jid = None
            try:
                with ServiceClient(rsock, timeout=2.0) as c:
                    s = c.submit(_job_args(tmp_path, tag, paf, fa),
                                 cwd=str(tmp_path))
                    if s.get("ok"):
                        jid = s["job_id"]
            except (OSError, ServiceError):
                pass
            if jid is None:
                time.sleep(0.05)
                continue
            rc = None
            deadline = time.monotonic() + 60
            while rc is None and time.monotonic() < deadline:
                try:
                    with ServiceClient(rsock, timeout=5.0) as c:
                        rc = c.result(jid, timeout=30).get("rc")
                except (OSError, ServiceError):
                    time.sleep(0.05)
            if rc is None:
                pump_err.append(f"{tag}: result never arrived")
                return
            done.append((tag, rc))

    try:
        socks, procs = _spawn_members(d, 2)
        rsock = os.path.join(d, "router.sock")
        primary = _route_proc(["--backends=" + ",".join(socks),
                               f"--socket={rsock}", "--poll-interval=0.1"])
        procs.append(primary)
        assert wait_for_socket(rsock, 30)
        standby = _route_proc([f"--standby-of={rsock}",
                               "--poll-interval=0.1"])
        procs.append(standby)
        t = threading.Thread(target=pump, args=(rsock,), daemon=True)
        t.start()
        _wait(lambda: len(done) >= 2 or pump_err, 60)
        assert not pump_err, pump_err
        primary.kill()
        primary.wait(timeout=30)
        pre = len(done)
        _wait(lambda: len(done) >= pre + 2 or pump_err, 60)
        assert not pump_err, pump_err
        stop.set()
        t.join(timeout=90)
        assert not t.is_alive(), "pump wedged"
        assert standby.poll() is None
        assert [rc for _, rc in done] == [0] * len(done)
        for tag, _ in done:
            assert (tmp_path / f"{tag}.dfa").read_bytes() == expect, tag
        with ServiceClient(rsock) as c:
            st = c.stats()["stats"]
        assert st["ha"]["takeover"] is True and st["ha"]["epoch"] >= 2
        _drain_all(rsock, standby, socks, procs)
    finally:
        stop.set()
        _reap(procs)
        shutil.rmtree(d, ignore_errors=True)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_mtls_fleet_standby_takeover(tmp_path):
    """Two TCP members demanding client certificates, a primary router
    dialing them with its own over a shared ``--journal-dir``, and a
    standby with the same member-TLS flags: SIGKILL the primary and the
    standby takes over, keeps dialing the members over mTLS, and a job
    routed through it lands with the reference's cold bytes."""
    paf, fa = _corpus(tmp_path, n=6)
    expect = _cold_ref(tmp_path, "cold", paf, fa)
    d = tempfile.mkdtemp(prefix="pwsbtls")
    jd = os.path.join(d, "journals")
    os.makedirs(jd)
    procs = []
    try:
        targets = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
        socks = [os.path.join(d, f"m{i}.sock") for i in range(2)]
        for sock, target in zip(socks, targets):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pwasm_tpu_torch", "serve",
                 f"--socket={sock}", f"--listen={target}",
                 f"--tls-cert={SRV_CERT}", f"--tls-key={SRV_KEY}",
                 f"--tls-client-ca={CA}", f"--journal-dir={jd}"],
                env=_serve_env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
        for sock in socks:
            assert wait_for_socket(sock, 60)
        member_tls = [f"--member-tls-ca={CA}",
                      f"--member-tls-cert={ADMIN_CERT}",
                      f"--member-tls-key={ADMIN_KEY}"]
        rsock = os.path.join(d, "router.sock")
        primary = _route_proc([f"--backends={','.join(targets)}",
                               f"--socket={rsock}", f"--journal-dir={jd}",
                               "--poll-interval=0.1", *member_tls])
        procs.append(primary)
        assert wait_for_socket(rsock, 30)
        with ServiceClient(rsock) as c:
            _wait(lambda: c.stats()["stats"]["fleet"]["alive"] == 2)
        standby = _route_proc([f"--standby-of={rsock}",
                               f"--journal-dir={jd}",
                               "--poll-interval=0.1", *member_tls])
        procs.append(standby)
        jpath = router_journal_path(rsock, None, jd)
        _wait(lambda: os.path.exists(jpath))
        time.sleep(0.5)                  # the standby sees the primary
        primary.kill()
        primary.wait(timeout=30)
        _wait_takeover(rsock)
        with ServiceClient(rsock, trace_id="mtls-sb") as c:
            _wait(lambda: c.stats()["stats"]["fleet"]["alive"] == 2)
            j = c.submit(_job_args(tmp_path, "a", paf, fa),
                         cwd=str(tmp_path))
            assert j["ok"], j
            r = c.result(j["job_id"], timeout=60)
            assert r.get("rc") == 0, r
            assert r["job"]["trace_id"] == "mtls-sb"
            st = c.stats()["stats"]
        assert st["ha"]["takeover"] is True
        assert (tmp_path / "a.dfa").read_bytes() == expect
        _drain_all(rsock, standby, socks, procs)
    finally:
        _reap(procs)
        shutil.rmtree(d, ignore_errors=True)
