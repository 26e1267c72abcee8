"""The port's daemon edge: TLS and mTLS on ``--listen``, scoped
capability tokens (``--auth-tokens``) and the per-identity rate limit
(``--rate-limit``), on the CPU.

Ports of the daemon-side cases of ``tests/test_transport_security.py``
(the primitives, the TLS round trip with a plaintext probe, the mTLS
CN, the scoped-token matrix with no state changed on refusal, the hot
reload, the metered failures, the daemon's rate limit, and unchanged
behaviour without the new flags), each against the port's daemon with
a stub runner.  The ``unauthorized`` and ``overloaded`` answers, the
exposition's transport families and the option checks of ``serve``
and the client are also held to the reference's daemon (under
``--slo-rules=off``) and CLI.  Each daemon is held open for seconds."""

import io
import json
import os
import re
import shutil
import stat
import tempfile
import threading
import time
from contextlib import contextmanager
from types import SimpleNamespace

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.service.daemon import Daemon as RefDaemon
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.fleet.transport import ClientTLS, ServerTLS, connect
from pwasm_tpu_torch.service import authz
from pwasm_tpu_torch.service.authz import AuthRegistry, PenaltyBox
from pwasm_tpu_torch.service.client import ServiceClient, ServiceError
from pwasm_tpu_torch.service.client import wait_for_socket
from pwasm_tpu_torch.service.daemon import Daemon
from pwasm_tpu_torch.service.queue import RateLimiter, parse_rate_limit
from pwasm_tpu_torch.utils.fsio import ensure_private_dir

HERE = os.path.dirname(os.path.abspath(__file__))
CERTS = os.path.join(HERE, "certs")
CA = os.path.join(CERTS, "ca.pem")
SRV_CERT = os.path.join(CERTS, "server.pem")
SRV_KEY = os.path.join(CERTS, "server.key")
ALICE_CERT = os.path.join(CERTS, "alice.pem")
ALICE_KEY = os.path.join(CERTS, "alice.key")
ROGUE_CERT = os.path.join(CERTS, "rogue.pem")
ROGUE_KEY = os.path.join(CERTS, "rogue.key")


def _server_tls(client_ca=None, cls=ServerTLS):
    return cls(SRV_CERT, SRV_KEY, client_ca=client_ca)


def _client_tls(cert=None, key=None):
    return ClientTLS(CA, certfile=cert, keyfile=key)


def _journal_bytes(path):
    try:
        return open(path, "rb").read()
    except OSError:
        return b""


def _stub_runner(sleep=0.0, rc=0, gate=None):
    """A job runner that touches no device: it sleeps (or waits for
    ``gate``), writes a ``--stats`` file when asked, and returns
    ``rc``."""
    def runner(argv, stdout=None, stderr=None, warm=None, **kw):
        if sleep:
            time.sleep(sleep)
        if gate is not None:
            assert gate.wait(30)
        sp = next((a.split("=", 1)[1] for a in argv
                   if a.startswith("--stats=")), None)
        if sp:
            with open(sp, "w") as f:
                json.dump({"wall_s": sleep}, f)
        return rc
    return runner


@contextmanager
def _daemon(runner=None, cls=Daemon, **kw):
    sockdir = tempfile.mkdtemp(prefix="pwsec")
    sock = os.path.join(sockdir, os.path.basename(sockdir) + ".sock")
    err = io.StringIO()
    dm = cls(sock, stderr=err, runner=runner, **kw)
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


def _mint(tmp_path, tokens):
    p = str(tmp_path / "tokens.json")
    authz.write_auth_tokens(p, tokens)
    return p


def _transport_lines(sock):
    with ServiceClient(sock) as c:
        body = c.metrics()["metrics"]
    return [ln for ln in body.splitlines() if "pwasm_transport_" in ln]


def _counter(sock, family, needle=""):
    m = [ln for ln in _transport_lines(sock)
         if ln.startswith(family) and needle in ln]
    return float(m[0].split()[-1]) if m else 0.0


# ---------------------------------------------------------------------------
# primitives: private dirs, rate limiter, penalty box, token file
# ---------------------------------------------------------------------------
def test_ensure_private_dir(tmp_path):
    d = str(tmp_path / "a" / "b")
    assert ensure_private_dir(d) == d
    assert stat.S_IMODE(os.stat(d).st_mode) == 0o700
    # idempotent, and a directory that already exists keeps the mode
    # its operator gave it
    wide = str(tmp_path / "wide")
    os.makedirs(wide, mode=0o755)
    os.chmod(wide, 0o755)
    ensure_private_dir(wide)
    assert stat.S_IMODE(os.stat(wide).st_mode) == 0o755
    f = tmp_path / "f"
    f.write_text("x")
    with pytest.raises(FileExistsError):
        ensure_private_dir(str(f))


def test_parse_rate_limit_grammar():
    assert parse_rate_limit("10") == (10.0, 10.0)
    assert parse_rate_limit("10/s") == (10.0, 10.0)
    assert parse_rate_limit("2.5/s:8") == (2.5, 8.0)
    assert parse_rate_limit("0.5") == (0.5, 1.0)   # floor burst 1
    for bad in ("0", "-1", "nope", "1:-2", "1:0.5", "inf", "1:inf"):
        with pytest.raises(ValueError):
            parse_rate_limit(bad)


def test_rate_limiter_truthful_and_bounded():
    rl = RateLimiter(2.0, 3.0)
    t0 = 1000.0
    got = [rl.admit("a", now=t0) for _ in range(5)]
    assert got[:3] == [0.0, 0.0, 0.0]       # burst admits
    assert got[3] == got[4] == 0.5          # 1 token / 2 per s
    assert rl.admit("a", now=t0 + 0.5) == 0.0
    assert rl.admit("b", now=t0) == 0.0     # identities independent
    assert rl.refusals == 2
    small = RateLimiter(1.0, 1.0, max_clients=4)
    for i in range(4):
        small.admit(f"c{i}", now=t0)
    small.admit("c0", now=t0 + 100)         # c0 refilled = idle
    small.admit("fresh", now=t0 + 100)
    assert len(small._buckets) <= 4


def test_penalty_box_caps_and_clears():
    pb = PenaltyBox(base_s=0.05, cap_s=2.0, max_peers=3)
    assert pb.fail("x") == pytest.approx(0.05)
    assert pb.fail("x") == pytest.approx(0.10)
    for _ in range(10):
        d = pb.fail("x")
    assert d == 2.0                          # capped
    pb.clear("x")
    assert pb.fail("x") == pytest.approx(0.05)
    for k in ("a", "b", "c", "d"):
        pb.fail(k)
    assert len(pb._counts) <= 3


def test_token_file_roundtrip_and_integrity(tmp_path):
    p = str(tmp_path / "tokens.json")
    authz.write_auth_tokens(p, {"sekrit": ["submit", "read"],
                                "cn:fleet-admin": ["admin"]})
    reg = AuthRegistry(p)
    assert reg.scopes_for("sekrit", None) == {"submit", "read"}
    assert reg.scopes_for(None, "cn:fleet-admin") == {"admin"}
    assert reg.scopes_for("nope", "uid:12") == frozenset()
    assert reg.allows({"client_token": None}, "cn:fleet-admin",
                      authz.SCOPE_SUBMIT)
    # the reference's token file loads in the port, byte for byte
    from pwasm_tpu.service import authz as ref_authz
    q = str(tmp_path / "ref_tokens.json")
    ref_authz.write_auth_tokens(q, {"sekrit": ["submit", "read"],
                                    "cn:fleet-admin": ["admin"]})
    assert open(q, "rb").read() == open(p, "rb").read()
    raw = open(p).read()
    open(p, "w").write(raw.replace("submit", "sudmit"))
    with pytest.raises(ValueError):
        AuthRegistry(p)
    obj = {"tokens": {"t": ["root"]}}
    from pwasm_tpu_torch.utils.fsio import payload_crc
    obj["crc"] = payload_crc(obj)
    open(p, "w").write(json.dumps(obj))
    with pytest.raises(ValueError) as ei:
        AuthRegistry(p)
    assert "unknown scope" in str(ei.value)


def test_required_scope_map():
    from pwasm_tpu.service import authz as ref_authz
    assert authz.VERB_SCOPES == ref_authz.VERB_SCOPES
    assert authz.required_scope("ping", {}) is None
    assert authz.required_scope("nonesuch", {}) is None  # unknown_cmd
    assert authz.required_scope("submit", {}) == authz.SCOPE_SUBMIT
    assert authz.required_scope("cancel", {}) == authz.SCOPE_CANCEL_OWN
    assert authz.required_scope("drain", {}) == authz.SCOPE_ADMIN
    assert authz.required_scope("stats", {}) == authz.SCOPE_READ
    assert authz.required_scope(
        "stats", {"lease": {"epoch": 1}}) == authz.SCOPE_ADMIN


# ---------------------------------------------------------------------------
# TLS transport on the daemon
# ---------------------------------------------------------------------------
def test_tls_roundtrip_and_plaintext_probe(tmp_path):
    with _daemon(runner=_stub_runner(), listen="127.0.0.1:0",
                 tls=_server_tls()) as h:
        tcp = f"127.0.0.1:{h.daemon.tcp_port}"
        out = str(tmp_path / "o.dfa")
        with ServiceClient(tcp, tls=_client_tls()) as c:
            assert c.ping()["ok"]
            r = c.result(c.submit(["in.paf", "-o", out],
                                  cwd=str(tmp_path))["job_id"],
                         timeout=30)
            assert r["rc"] == 0
        # a client without a TLS config speaks plaintext at the TLS
        # port: a loud close, never a hang, never a serve
        conn = connect(tcp, timeout=5)
        try:
            conn.sendall(b'{"cmd":"ping"}\n')
            conn.settimeout(5)
            try:
                data = conn.recv(1 << 16)
            except OSError:
                data = b""
            assert b'"ok"' not in data
        finally:
            conn.close()
        deadline = time.monotonic() + 5
        seen = 0.0
        while time.monotonic() < deadline:
            seen = _counter(h.sock,
                            "pwasm_transport_tls_handshake_failures_total")
            if seen >= 1:
                break
            time.sleep(0.05)
        assert seen == 1
        assert stat.S_IMODE(os.stat(h.sock).st_mode) == 0o600


def test_mtls_peer_cn_is_attested_identity(tmp_path):
    with _daemon(runner=_stub_runner(), listen="127.0.0.1:0",
                 tls=_server_tls(client_ca=CA)) as h:
        tcp = f"127.0.0.1:{h.daemon.tcp_port}"
        out = str(tmp_path / "o.dfa")
        # the verified CN is the fair-share identity, above a
        # client_token on the same frame
        with ServiceClient(tcp, client_token="spoof",
                           tls=_client_tls(ALICE_CERT, ALICE_KEY)) as c:
            r = c.result(c.submit(["in.paf", "-o", out],
                                  cwd=str(tmp_path))["job_id"],
                         timeout=30)
            assert r["job"]["client"] == "cn:alice"
        with ServiceClient(tcp, tls=_client_tls(ALICE_CERT,
                                                ALICE_KEY)) as c:
            r = c.result(c.submit(["in.paf", "-o", out],
                                  cwd=str(tmp_path),
                                  client="tenant9")["job_id"],
                         timeout=30)
            assert r["job"]["client"] == "tenant9"
        # an untrusted (self-signed) client certificate never completes
        # the handshake
        with pytest.raises((ServiceError, OSError)):
            with ServiceClient(tcp, timeout=5,
                               tls=ClientTLS(CA, certfile=ROGUE_CERT,
                                             keyfile=ROGUE_KEY)) as c:
                c.ping()
        with ServiceClient(tcp, tls=_client_tls(ALICE_CERT,
                                                ALICE_KEY)) as c:
            assert c.ping()["ok"]


def test_state_dirs_created_private(tmp_path):
    """The result cache's and the spool's directories land 0700."""
    cache = str(tmp_path / "cache")
    spool = str(tmp_path / "spool")
    with _daemon(runner=_stub_runner(), result_cache=cache,
                 spool_threshold_bytes=1, spool_dir=spool) as h:
        with ServiceClient(h.sock) as c:
            r = c.result(c.submit(["in.paf", "-o",
                                   str(tmp_path / "o.dfa")],
                                  cwd=str(tmp_path))["job_id"],
                         timeout=30)
            assert r["rc"] == 0
    assert stat.S_IMODE(os.stat(cache).st_mode) == 0o700
    assert stat.S_IMODE(os.stat(spool).st_mode) == 0o700


# ---------------------------------------------------------------------------
# scoped capability tokens on the daemon
# ---------------------------------------------------------------------------
def _state(h):
    """What a refused frame must leave as it was."""
    dm = h.daemon
    return (dm.queue.depth(), len(dm.jobs), dm.leases.grants,
            _journal_bytes(h.sock + ".journal"), dm._draining)


def test_scoped_tokens_matrix_and_zero_state_on_refusal(tmp_path):
    tok = _mint(tmp_path, {
        "writer": ["submit", "read"],
        "reader": ["read"],
        "alice-t": ["submit", "read", "cancel-own"],
        "bob-t": ["submit", "read", "cancel-own"],
        "boss": ["admin"],
    })
    gate = threading.Event()
    gate.set()
    with _daemon(runner=_stub_runner(gate=gate), auth_tokens=tok) as h:
        out = str(tmp_path / "o.dfa")

        def deny(client, req):
            before = _state(h)
            r = client._req(req)
            assert r["ok"] is False and r["error"] == "unauthorized", r
            assert _state(h) == before
            return r

        with ServiceClient(h.sock, client_token="writer") as c:
            assert c.ping()["ok"]            # ping stays open
            j = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert j["ok"], j
            assert c.result(j["job_id"], timeout=30)["rc"] == 0
            # the control plane needs admin
            deny(c, {"cmd": "drain"})
            deny(c, {"cmd": "fence", "reason": "test"})
            deny(c, {"cmd": "lease-grant",
                     "lease": {"epoch": 99, "ttl_s": 5}})
            deny(c, {"cmd": "stats", "lease": {"epoch": 99,
                                               "ttl_s": 5}})
            assert c.ping()["draining"] is False
        with ServiceClient(h.sock, client_token="reader") as c:
            deny(c, {"cmd": "submit", "args": ["in.paf", "-o", out],
                     "cwd": str(tmp_path)})
            deny(c, {"cmd": "stream", "args": ["-o", out],
                     "cwd": str(tmp_path)})
            assert c._req({"cmd": "stats"})["ok"]
        with ServiceClient(h.sock) as c:     # anonymous unix peer
            deny(c, {"cmd": "submit", "args": ["x"]})
        # cancel-own: ownership follows the resolved identity.  The
        # runner holds the first job at the gate, so nothing moves
        # while the refusals are checked
        gate.clear()
        with ServiceClient(h.sock, client_token="alice-t") as ca, \
                ServiceClient(h.sock, client_token="bob-t") as cb, \
                ServiceClient(h.sock, client_token="boss") as cboss:
            j1 = ca.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            deadline = time.monotonic() + 30
            while ca.status(j1["job_id"])["job"]["state"] != "running" \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            deny(cb, {"cmd": "cancel", "job_id": j1["job_id"]})
            assert ca.cancel(j1["job_id"])["ok"]        # owner may
            j2 = ca.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert cboss.cancel(j2["job_id"])["ok"]     # admin may
            # unknown ids pass the gate and answer unknown_job: the
            # auth layer is not a job-id oracle
            r = ca._req({"cmd": "cancel", "job_id": "job-9999"})
            assert r["error"] == "unknown_job"
            gate.set()
            assert cboss.drain()["ok"]


def test_auth_hot_reload_keep_last_good(tmp_path):
    tok = _mint(tmp_path, {"old-tok": ["submit", "read"]})
    with _daemon(runner=_stub_runner(), auth_tokens=tok) as h:
        out = str(tmp_path / "o.dfa")
        with ServiceClient(h.sock, client_token="old-tok") as c:
            assert c.submit(["in.paf", "-o", out],
                            cwd=str(tmp_path))["ok"]
        time.sleep(0.02)                     # distinct mtime_ns
        authz.write_auth_tokens(tok, {"new-tok": ["submit", "read"]})
        deadline = time.monotonic() + 10
        admitted = False
        while time.monotonic() < deadline and not admitted:
            with ServiceClient(h.sock, client_token="new-tok") as c:
                admitted = c.submit(["in.paf", "-o", out],
                                    cwd=str(tmp_path)).get("ok", False)
            time.sleep(0.05)
        assert admitted, "the rotated token never became valid"
        with ServiceClient(h.sock, client_token="old-tok") as c:
            r = c._req({"cmd": "submit", "args": ["x"]})
            assert r["error"] == "unauthorized"
        # a corrupt rotation keeps the last good policy
        time.sleep(0.02)
        open(tok, "w").write("{not json")
        time.sleep(0.5)                      # a few accept ticks
        with ServiceClient(h.sock, client_token="new-tok") as c:
            assert c.submit(["in.paf", "-o", out],
                            cwd=str(tmp_path))["ok"]
        assert "reload refused" in h.err.getvalue()


def test_auth_failures_metered_and_penalized(tmp_path):
    tok = _mint(tmp_path, {"boss": ["admin"]})
    with _daemon(runner=_stub_runner(), auth_tokens=tok) as h:
        with ServiceClient(h.sock, client_token="intruder") as c:
            t0 = time.monotonic()
            for _ in range(4):
                r = c._req({"cmd": "submit", "args": ["x"]})
                assert r["error"] == "unauthorized"
            held = time.monotonic() - t0
        # capped-exponential penalty: 0.05+0.1+0.2+0.4 = 0.75 s
        assert held >= 0.5, held
        with ServiceClient(h.sock, client_token="boss") as c:
            body = c.metrics()["metrics"]
        m = [ln for ln in body.splitlines()
             if ln.startswith("pwasm_transport_auth_failures_total")
             and "intruder" in ln]
        assert m and float(m[0].split()[-1]) == 4
        # the label universe is bounded at 64 identities
        labels = [f"tok:t{i}" for i in range(70)]
        for lab in labels:
            assert h.daemon._auth_label(lab) in (lab, "other")
        assert h.daemon._auth_label("tok:t69") == "other"
        assert len(h.daemon._auth_labels) == 64


def test_daemon_rate_limit_truthful_retry(tmp_path):
    with _daemon(runner=_stub_runner(), rate_limit=(2.0, 2.0)) as h:
        out = str(tmp_path / "o.dfa")
        with ServiceClient(h.sock, client_token="burst") as c:
            a = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            b = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert a["ok"] and b["ok"]
            before = (len(h.daemon.jobs), h.daemon.stats.jobs_accepted)
            r = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            assert r["ok"] is False and r["error"] == "overloaded", r
            assert r["retry_after_s"] > 0
            # the refused frame admitted nothing
            assert (len(h.daemon.jobs),
                    h.daemon.stats.jobs_accepted) == before
            # reads are not rate limited (only admission verbs)
            assert c.request({"cmd": "stats"})["ok"]
            time.sleep(r["retry_after_s"] + 0.05)
            assert c.submit(["in.paf", "-o", out],
                            cwd=str(tmp_path))["ok"]
        with ServiceClient(h.sock, client_token="other") as c:
            assert c.submit(["in.paf", "-o", out],
                            cwd=str(tmp_path))["ok"]


def test_no_new_flags_byte_identical_behavior(tmp_path):
    """The edge is opt-in: without the flags, anonymous clients
    submit, grant leases and drain as before."""
    with _daemon(runner=_stub_runner()) as h:
        assert h.daemon.auth is None
        assert h.daemon.rate_limiter is None
        assert h.daemon.tls is None
        with ServiceClient(h.sock) as c:
            j = c.submit(["in.paf", "-o", str(tmp_path / "o.dfa")],
                         cwd=str(tmp_path))
            assert j["ok"]
            assert c.result(j["job_id"], timeout=30)["rc"] == 0
            assert c.request({"cmd": "stats",
                              "lease": {"epoch": 1,
                                        "ttl_s": 5.0}})["ok"]
            assert c.drain()["ok"]


# ---------------------------------------------------------------------------
# held to the reference's daemon and CLI
# ---------------------------------------------------------------------------
def _edge_answers(cls, tok, tmp_path, **extra):
    """The refusals and the transport families one daemon gives to
    the same frames."""
    from pwasm_tpu.fleet.transport import ServerTLS as RefServerTLS
    tls = _server_tls(cls=ServerTLS if cls is Daemon else RefServerTLS)
    out = str(tmp_path / "o.dfa")
    seen = {}
    with _daemon(runner=_stub_runner(), cls=cls, auth_tokens=tok,
                 rate_limit=(1.0, 1.0), listen="127.0.0.1:0", tls=tls,
                 **extra) as h:
        with ServiceClient(h.sock, client_token="reader") as c:
            r = c._req({"cmd": "submit", "args": ["in.paf", "-o", out],
                        "cwd": str(tmp_path)})
            seen["unauthorized"] = (r["ok"], r["error"], r["detail"])
        with ServiceClient(h.sock, client_token="writer") as c:
            a = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            r = c.submit(["in.paf", "-o", out], cwd=str(tmp_path))
            seen["overloaded"] = (a["ok"], r["ok"], r["error"],
                                  r["detail"], r["client"],
                                  0 < r["retry_after_s"] <= 1.0)
            c.result(a["job_id"], timeout=30)
        conn = connect(f"127.0.0.1:{h.daemon.tcp_port}", timeout=5)
        try:
            conn.sendall(b'{"cmd":"ping"}\n')
            conn.settimeout(5)
            try:
                conn.recv(1 << 16)
            except OSError:
                pass
        finally:
            conn.close()
        deadline = time.monotonic() + 5
        while _counter(h.sock, "pwasm_transport_tls_handshake_failures_"
                       "total") < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        seen["transport"] = _transport_lines(h.sock)
    return seen


def test_refusals_and_transport_families_match_reference(tmp_path):
    tok = _mint(tmp_path, {"writer": ["submit", "read"],
                           "reader": ["read"], "*": ["read"]})
    port = _edge_answers(Daemon, tok, tmp_path)
    ref = _edge_answers(RefDaemon, tok, tmp_path, slo_rules="off")
    assert port == ref
    assert port["unauthorized"][1] == "unauthorized"
    assert port["overloaded"][2] == "overloaded"
    assert any(ln.startswith("pwasm_transport_auth_failures_total")
               for ln in port["transport"])


def _last_line(text):
    return [ln for ln in text.splitlines() if ln.strip()][-1]


@pytest.mark.parametrize("argv", [
    ["serve", "--socket=/nonexistent/s.sock", "--tls-cert=c.pem"],
    ["serve", "--socket=/nonexistent/s.sock", "--tls-key=k.pem"],
    ["serve", "--socket=/nonexistent/s.sock", "--tls-client-ca=ca.pem"],
    ["serve", "--socket=/nonexistent/s.sock", "--tls-cert=nope.pem",
     "--tls-key=nope.key"],
    ["serve", "--socket=/nonexistent/s.sock", "--auth-tokens= "],
    ["serve", "--socket=/nonexistent/s.sock", "--auth-tokens=/nope.json"],
    ["serve", "--socket=/nonexistent/s.sock", "--rate-limit=0"],
    ["serve", "--socket=/nonexistent/s.sock", "--rate-limit=1:0.5"],
    ["submit", "--socket=/nonexistent/s.sock", "--tls-cert=c.pem", "--",
     "x", "-o", "y"],
    ["submit", "--socket=127.0.0.1:1", "--tls-ca=/nope.pem", "--", "x",
     "-o", "y"],
], ids=lambda a: " ".join(a[2:4]))
def test_edge_options_checked_as_the_reference(argv):
    err = io.StringIO()
    rc = run(list(argv), stderr=err)
    ref_err = io.StringIO()
    assert rc == ref_run(list(argv), stderr=ref_err) == 1
    assert _last_line(err.getvalue()) == _last_line(ref_err.getvalue())


def test_edge_options_leave_the_refusal_tables(tmp_path):
    """The four edge options parse on ``serve`` and the three TLS
    options on the client: none is refused as a later slice's."""
    from pwasm_tpu_torch.service import daemon
    assert not hasattr(daemon, "_LATER_SERVE")
    tok = _mint(tmp_path, {"*": ["submit", "read", "admin"]})
    sock = str(tmp_path / "s.sock")
    err = io.StringIO()
    done: list = []
    t = threading.Thread(target=lambda: done.append(run(
        ["serve", f"--socket={sock}", "--listen=127.0.0.1:0",
         f"--tls-cert={SRV_CERT}", f"--tls-key={SRV_KEY}",
         f"--tls-client-ca={CA}", f"--auth-tokens={tok}",
         "--rate-limit=50/s:10", "--journal=off"], stderr=err)),
        daemon=True)
    t.start()
    try:
        assert wait_for_socket(sock, 15), err.getvalue()
        port = re.search(r"tcp 127\.0\.0\.1:(\d+)", err.getvalue())[1]
        out = io.StringIO()
        assert run(["svc-stats", f"--socket=127.0.0.1:{port}",
                    f"--tls-ca={CA}",
                    f"--tls-cert={ALICE_CERT}", f"--tls-key={ALICE_KEY}"],
                   stdout=out, stderr=io.StringIO()) == 0
        assert json.loads(out.getvalue())["jobs"]["accepted"] == 0
    finally:
        with ServiceClient(sock) as c:
            c.drain()
        t.join(20)
    assert done == [75], err.getvalue()
