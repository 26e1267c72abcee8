"""The port router's fleet cache, self-monitoring and edge against the
JAX package's, on the CPU.

Router cases of other reference files, each over port members with jobs
at ``--device=cpu``: the shared-directory hit, cache affinity and family
affinity (``tests/test_cache.py``), with the port's cache key, which
holds the effective ``--batch`` under ``--realign`` at the router too;
the fleet verdict over an injected member outage and ``member_down``
(``tests/test_slo.py``); the edge's token gate, rate limit and frame
ceiling, ``--member-token``, and a member killed under an all-TLS
fleet (``tests/test_transport_security.py``); and the protocol fuzz
against a port router (``tests/test_protocol_fuzz.py``).
"""

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager

from pwasm_tpu.service.cache import classify_argv as ref_classify
from pwasm_tpu.service.cache import derive_keys as ref_derive
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.fleet.transport import (ClientTLS, connect,
                                             router_journal_path)
from pwasm_tpu_torch.service.cache import classify_argv, derive_keys
from pwasm_tpu_torch.service.client import (ServiceClient, ServiceError,
                                            wait_for_socket)
from pwasm_tpu_torch.service.authz import write_auth_tokens

from test_torch_cache import _grown_corpus
from test_torch_fleet import (REPO, SLOW, _cold_ref, _corpus, _daemon,
                              _fleet, _job_args, _reap, _router,
                              _serve_env, _stub_runner, _wait,
                              _wait_mid_run)
from test_torch_slo import _box_runner

sys.path.insert(0, os.path.join(REPO, "qa"))
from protocol_fuzz import fuzz_target, slow_loris_drill  # noqa: E402

CERTS = os.path.join(REPO, "tests", "certs")
CA = os.path.join(CERTS, "ca.pem")
SRV_CERT = os.path.join(CERTS, "server.pem")
SRV_KEY = os.path.join(CERTS, "server.key")
ADMIN_CERT = os.path.join(CERTS, "fleet-admin.pem")
ADMIN_KEY = os.path.join(CERTS, "fleet-admin.key")


def _submit_wait(sock, argv, cwd=None):
    with ServiceClient(sock) as c:
        s = c.submit(argv, cwd=cwd)
        assert s.get("ok"), s
        return s, c.result(s["job_id"], timeout=120)


# ---------------------------------------------------------------------------
# the fleet result cache
# ---------------------------------------------------------------------------
def test_router_shared_dir_hit_never_reaches_a_member(tmp_path):
    """Members and router on one cache directory: a reordered repeat is
    answered at the router, and no member sees it."""
    paf, fa = _corpus(tmp_path)
    shared = str(tmp_path / "shared")
    with _fleet(n=2, daemon_kw={"result_cache": shared},
                router_kw={"result_cache": shared}) as f:
        s1, r1 = _submit_wait(f.sock, [paf, "-r", fa, "-o",
                                       str(tmp_path / "f1.dfa"),
                                       "--device=cpu"])
        assert r1.get("rc") == 0, r1
        s2, r2 = _submit_wait(f.sock, [
            "-r", fa, paf, "-o", str(tmp_path / "f2.dfa"),
            "--device=cpu", f"--stats={tmp_path / 'f2.json'}"])
        assert r2.get("rc") == 0, r2
        assert s2.get("member") == "cache" and s2.get("cache_hit")
        assert r2["job"]["state"] == "done"
        assert json.load(open(tmp_path / "f2.json"))["cache_hit"]
        assert sum(m.daemon.stats.jobs_accepted for m in f.members) == 1
        with ServiceClient(f.sock) as c:
            assert c.stats()["stats"]["cache"]["hits"] == 1
        recs = f.router.rjournal.replay()
        assert [r["rec"] for r in recs if r.get("job_id") == s2["job_id"]] \
            == ["route_admit", "route_retire"]
    assert (tmp_path / "f1.dfa").read_bytes() \
        == (tmp_path / "f2.dfa").read_bytes() \
        == _cold_ref(tmp_path, "cold", paf, fa)


def test_router_cache_key_holds_the_realign_batch(tmp_path):
    """At the router the port's key holds the effective ``--batch`` under
    ``--realign`` (the reference's does not): a routed ``--realign
    --batch=4`` job followed by ``--realign`` is a miss at the router,
    runs on a member, and equals the port's cold ``--realign`` run."""
    paf, fa = _corpus(tmp_path, n=8)
    a4 = [paf, "-r", fa, "-o", "X", "-w", "X.mfa", "--realign",
          "--batch=4", "--device=cpu"]
    a0 = [paf, "-r", fa, "-o", "X", "-w", "X.mfa", "--realign",
          "--device=cpu"]
    keys = [derive_keys(classify_argv(a))[0] for a in (a4, a0)]
    assert keys[0] != keys[1]
    assert ref_derive(ref_classify(a4))[0] \
        == ref_derive(ref_classify(a0))[0]
    shared = str(tmp_path / "shared")
    with _fleet(n=2, daemon_kw={"result_cache": shared},
                router_kw={"result_cache": shared}) as f:
        for tag, argv in (("b4", a4), ("b0", a0)):
            argv = [str(tmp_path / f"{tag}.{a[2:] or 'dfa'}")
                    if a.startswith("X") else a for a in argv]
            s, r = _submit_wait(f.sock, argv)
            assert r.get("rc") == 0, r
            assert s["member"] != "cache" and not s.get("cache_hit")
        with ServiceClient(f.sock) as c:
            st = c.stats()["stats"]
        assert st["cache"]["hits"] == 0 and st["cache"]["misses"] == 2
        assert sum(m.daemon.stats.jobs_accepted for m in f.members) == 2
    err = io.StringIO()
    assert run([paf, "-r", fa, "-o", str(tmp_path / "cold.dfa"), "-w",
                str(tmp_path / "cold.mfa"), "--realign", "--device=cpu"],
               stderr=err) == 0, err.getvalue()
    for ext in ("dfa", "mfa"):
        assert (tmp_path / f"b0.{ext}").read_bytes() \
            == (tmp_path / f"cold.{ext}").read_bytes()


@contextmanager
def _private_cache_fleet(tmp_path, n=2):
    """Members with PRIVATE cache directories behind a router with an
    empty one of its own."""
    with ExitStack() as stack:
        members = [stack.enter_context(
            _daemon(result_cache=str(tmp_path / f"m{k}cd")))
            for k in range(n)]
        yield stack.enter_context(_router(
            [m.sock for m in members],
            result_cache=str(tmp_path / "router-cd")))


def test_router_cache_affinity_places_on_hitting_member(tmp_path):
    paf, fa = _corpus(tmp_path)
    with _private_cache_fleet(tmp_path) as rt:
        s1, r1 = _submit_wait(rt.sock, [paf, "-r", fa, "-o",
                                        str(tmp_path / "g1.dfa"),
                                        "--device=cpu"])
        assert r1.get("rc") == 0, r1
        s2, r2 = _submit_wait(rt.sock, [
            paf, "-r", fa, "-o", str(tmp_path / "g2.dfa"),
            "--device=cpu", f"--stats={tmp_path / 'g2.json'}"])
        assert r2.get("rc") == 0, r2
        assert s2["member"] == s1["member"], (s1, s2)
        assert json.load(open(tmp_path / "g2.json"))["cache_hit"]
    assert (tmp_path / "g1.dfa").read_bytes() \
        == (tmp_path / "g2.dfa").read_bytes()


def test_router_family_affinity_places_delta_on_warm_member(tmp_path):
    p1, p2, fa = _grown_corpus(tmp_path)
    with _private_cache_fleet(tmp_path) as rt:
        s1, r1 = _submit_wait(rt.sock, [p1, "-r", fa, "-o",
                                        str(tmp_path / "r1.dfa"),
                                        "--device=cpu"])
        assert r1.get("rc") == 0
        s2, r2 = _submit_wait(rt.sock, [
            p2, "-r", fa, "-o", str(tmp_path / "r2.dfa"),
            "--device=cpu", f"--stats={tmp_path / 'r2.json'}"])
        assert r2.get("rc") == 0, r2
        assert s2["member"] == s1["member"], (s1, s2)
        st = json.load(open(tmp_path / "r2.json"))
        assert st["cache_delta"] is True
        assert st["cache_records_served"] == 26
    assert run([p2, "-r", fa, "-o", str(tmp_path / "rc.dfa"),
                "--device=cpu"], stderr=io.StringIO()) == 0
    assert (tmp_path / "r2.dfa").read_bytes() \
        == (tmp_path / "rc.dfa").read_bytes()


# ---------------------------------------------------------------------------
# self-monitoring: the fleet verdict
# ---------------------------------------------------------------------------
CANARY_S = 0.75


def _health(sock):
    with ServiceClient(sock) as c:
        return c.health()["health"]


def test_fleet_outage_detection_drill(tmp_path):
    """Three members with canaries; an outage injected on one fails its
    verdict and, within two canary intervals, the router's fleet
    verdict, naming the member; the siblings stay ok; healing resolves
    both."""
    boxes = [{} for _ in range(3)]
    with _daemon(runner=_box_runner(boxes[0]), journal_path=None,
                 canary_interval_s=CANARY_S) as m0, \
            _daemon(runner=_box_runner(boxes[1]), journal_path=None,
                    canary_interval_s=CANARY_S) as m1, \
            _daemon(runner=_box_runner(boxes[2]), journal_path=None,
                    canary_interval_s=CANARY_S) as m2, \
            _router([m0.sock, m1.sock, m2.sock]) as rt:
        members = [m0, m1, m2]
        for m in members:
            _wait(lambda m=m: (_health(m.sock)["canary"] or {})
                  .get("runs", 0) >= 1)
        _wait(lambda: _health(rt.sock)["verdict"] == "ok")
        t_inject = time.monotonic()
        boxes[0]["body"] = b"WEDGED-LANE-GARBAGE"
        _wait(lambda: _health(rt.sock)["verdict"] == "failing",
              2 * CANARY_S + 10)
        detect = time.monotonic() - t_inject
        assert detect <= 2 * CANARY_S + 0.5, detect
        fh = _health(rt.sock)
        name = os.path.basename(m0.sock)
        assert fh["members"][name]["verdict"] == "failing"
        assert "canary_failing" in fh["members"][name]["firing"]
        for m in members[1:]:
            assert fh["members"][os.path.basename(m.sock)]["verdict"] \
                == "ok"
        boxes[0]["body"] = b"OK"
        _wait(lambda: _health(rt.sock)["verdict"] == "ok",
              2 * CANARY_S + 10)
        with ServiceClient(rt.sock) as c:
            h = c.request({"cmd": "health"})
            assert h["ok"] and h["health"]["router"] is True


def test_router_member_down_rule_and_fleet_health():
    with _fleet(n=2, runner=_stub_runner()) as f:
        _wait(lambda: _health(f.sock)["verdict"] == "ok")
        f.members[1].daemon.drain.request("die")
        _wait(lambda: "member_down" in [x["rule"] for x in
                                        _health(f.sock)["firing"]])
        fh = _health(f.sock)
        assert fh["verdict"] == "failing", fh
        name = os.path.basename(f.members[1].sock)
        assert fh["members"][name]["verdict"] == "unreachable"
        t = f.router.registry.get("pwasm_alert_transitions_total")
        _wait(lambda: t.value(rule="failover_burst", state="firing") >= 1)
        with ServiceClient(f.sock) as c:
            st = c.stats()["stats"]
        assert st["health"]["verdict"] == "failing"
        from pwasm_tpu_torch.service.top import render
        assert "member_down[page" in render(st)


# ---------------------------------------------------------------------------
# the router's edge
# ---------------------------------------------------------------------------
def _mint(tmp_path, tokens):
    p = str(tmp_path / "tokens.json")
    write_auth_tokens(p, tokens)
    return p


def _journal_bytes(path):
    try:
        return open(path, "rb").read()
    except OSError:
        return b""


def test_router_edge_auth_rate_and_frame_ceiling(tmp_path):
    tok = _mint(tmp_path, {"writer": ["submit", "read"],
                           "boss": ["admin"]})
    with _daemon(runner=_stub_runner()) as m, \
            _router([m.sock], listen="127.0.0.1:0", auth_tokens=tok,
                    rate_limit=(1.0, 1.0), max_frame_bytes=4096) as rt:
        journal = router_journal_path(rt.sock, None, None)
        out = str(tmp_path / "o.dfa")
        with ServiceClient(rt.sock, client_token="writer") as c:
            j = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert j["ok"], j
            assert c.result(j["job_id"], timeout=30)["rc"] == 0
            before = _journal_bytes(journal)
            rr = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert rr["error"] == "overloaded", rr
            assert rr["retry_after_s"] > 0
            for req in ({"cmd": "drain"}, {"cmd": "fence"},
                        {"cmd": "lease-grant", "lease": {"epoch": 9}}):
                resp = c.request(req)
                assert resp["error"] == "unauthorized", resp
            assert _journal_bytes(journal) == before
            assert c.ping()["draining"] is False
        for target in (rt.sock, f"127.0.0.1:{rt.router.tcp_port}"):
            conn = connect(target, timeout=5)
            try:
                conn.sendall(b'{"pad":"' + b"A" * 8192 + b'"}\n')
                resp = json.loads(conn.makefile("rb").readline(1 << 16))
                assert resp["error"] == "frame_too_large", (target, resp)
            finally:
                conn.close()
        with ServiceClient(rt.sock, client_token="boss") as c:
            assert c.drain()["ok"]


def test_router_member_token_reaches_auth_armed_member(tmp_path):
    tok = _mint(tmp_path, {"fleet-svc": ["admin"]})
    with _daemon(runner=_stub_runner(), auth_tokens=tok) as m, \
            _router([m.sock], member_token="fleet-svc") as rt:
        s, r = _submit_wait(rt.sock, ["in.paf", "-o",
                                      str(tmp_path / "o.dfa")],
                            cwd=str(tmp_path))
        assert r["rc"] == 0
        with ServiceClient(rt.sock) as c:
            st = c.stats()["stats"]
        assert len(st["fleet"]["members"]) == 1
        assert st["fleet"]["members"][0]["alive"]
        assert not st["fleet"]["members"][0]["fenced"]


def test_mtls_fleet_member_kill_resumes_byte_identical(tmp_path):
    """Two TCP port members demanding client certificates behind a
    ``route`` process dialing them with its own (``--member-tls-*``)
    over a shared ``--journal-dir``: SIGKILL the member running a
    mid-run job and the job resumes on the sibling, its report equal
    to the reference's cold run, the trace_id intact."""
    paf, fa = _corpus(tmp_path, n=10)
    expect = _cold_ref(tmp_path, "cold", paf, fa)
    d = tempfile.mkdtemp(prefix="pwmtls")
    jd = os.path.join(d, "journals")
    os.makedirs(jd)
    procs = []
    try:
        targets = []
        for i in range(2):
            import socket
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            targets.append(f"127.0.0.1:{port}")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pwasm_tpu_torch", "serve",
                 f"--socket={os.path.join(d, f'm{i}.sock')}",
                 f"--listen=127.0.0.1:{port}", f"--tls-cert={SRV_CERT}",
                 f"--tls-key={SRV_KEY}", f"--tls-client-ca={CA}",
                 f"--journal-dir={jd}"],
                env=_serve_env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
        for i in range(2):
            assert wait_for_socket(os.path.join(d, f"m{i}.sock"), 60)
        try:
            with ServiceClient(targets[0], timeout=5,
                               tls=ClientTLS(CA)) as c:
                c.ping()
            raise AssertionError("a client without a certificate spoke")
        except (ServiceError, OSError):
            pass
        rsock = os.path.join(d, "router.sock")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pwasm_tpu_torch", "route",
             f"--backends={','.join(targets)}", f"--socket={rsock}",
             f"--journal-dir={jd}", "--poll-interval=0.1",
             f"--member-tls-ca={CA}", f"--member-tls-cert={ADMIN_CERT}",
             f"--member-tls-key={ADMIN_KEY}"],
            env=_serve_env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
        assert wait_for_socket(rsock, 60)
        with ServiceClient(rsock, trace_id="mtls-drill") as c:
            _wait(lambda: c.stats()["stats"]["fleet"]["alive"] == 2)
            ja = c.submit(_job_args(tmp_path, "a", paf, fa, [SLOW]),
                          cwd=str(tmp_path))
            assert ja["ok"], ja
            assert _wait_mid_run(c, ja["job_id"],
                                 str(tmp_path / "a.dfa.ckpt"))
            vi = [t.replace(":", "_") for t in targets].index(ja["member"])
            procs[vi].kill()
            procs[vi].wait(timeout=30)
            ra = c.result(ja["job_id"], timeout=120)
            assert ra.get("rc") == 0, ra
            assert ra["job"]["trace_id"] == "mtls-drill"
            assert ra["job"]["member"] != ja["member"]
            assert ra["job"]["failovers"] == 1
            assert c.drain()["ok"]
        assert procs[2].wait(timeout=60) == 0
        assert (tmp_path / "a.dfa").read_bytes() == expect
    finally:
        _reap(procs)
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# protocol fuzz against a port router
# ---------------------------------------------------------------------------
CEILING = 4096


def test_fuzz_router_and_slow_loris():
    with _daemon(runner=_stub_runner()) as m, \
            _router([m.sock], max_frame_bytes=CEILING,
                    listen="127.0.0.1:0") as rt:
        for target, seed in ((rt.sock, 13),
                             (f"127.0.0.1:{rt.router.tcp_port}", 14)):
            s = fuzz_target(target, n=500, seed=seed, ceiling=CEILING)
            assert s["responses"] > 0 and s["control_pings"] > 0
            assert s["codes"].get("frame_too_large", 0) > 0
            assert s["codes"].get("bad_json", 0) > 0
        loris = slow_loris_drill(rt.sock, holders=4, hold_s=0.3)
        assert loris["alive_during_hold"] and loris["alive_after_hold"]
