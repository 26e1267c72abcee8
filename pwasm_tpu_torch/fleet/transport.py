"""The service transport layer: unix sockets joined by (optionally
TLS-wrapped) TCP.

Counterpart of ``pwasm_tpu/fleet/transport.py``, copied whole.  The
port's daemon and client use all of it: the unix and TCP listeners,
and the TLS half that ``serve --tls-*`` and the client's ``--tls-*``
options arm.

Every service surface (``serve``, ``submit``, ``route``, ``top``,
``svc-stats``) names its peer with one *target* string:

- a filesystem path (any string containing ``/``, or anything that is
  not ``host:port`` shaped) is a unix socket — the single-host default,
  with kernel-attested ``SO_PEERCRED`` client identity.  The socket
  inode is created owner-only (0600): the filesystem is the unix
  transport's authentication layer;
- ``HOST:PORT`` (e.g. ``10.0.0.7:9211``, ``localhost:9211``) is TCP —
  the cross-host transport fleet federation runs on.  Plaintext TCP has
  no peer credentials; with ``--tls-cert/--tls-key`` the listener
  upgrades to TLS (stdlib ``ssl``, TLS 1.2 floor) and with
  ``--tls-client-ca`` it demands a client certificate (mTLS), whose
  subject CN becomes a kernel-grade *attested* identity (``cn:<name>``)
  ranking above the free-form ``client_token`` in
  ``protocol.resolve_client_identity``.  The NDJSON protocol itself is
  byte-identical on every transport.

This module is the ONE place sockets are made and wrapped: parsing,
connecting, listening, TLS context construction and the per-connection
server handshake all live here, so the client, the daemon and the
router cannot disagree about what a target string means or which
protocol floor it speaks.

Certificate verification is chain-of-trust against the configured CA
bundle, NOT hostname matching (``check_hostname=False``): fleet
certificates attest *identities* (their CN), and members are dialed by
whatever address the operator listed — pinning the CA is the contract.
"""

from __future__ import annotations

import os
import re
import socket
import ssl

# HOST:PORT — host is anything path-free and colon-free (DNS name or
# IPv4); a string with "/" can only be a unix path.  IPv6 literals are
# deliberately out of the grammar (brackets would collide with shells);
# use a DNS name.
_TCP_RE = re.compile(r"^(?P<host>[^/:\s]+):(?P<port>\d{1,5})$")

# member names double as journal filenames and metric label values:
# keep the charset boring
_NAME_BAD = re.compile(r"[^A-Za-z0-9_.-]")

# a handshake must finish promptly or the connection thread would be
# parked forever by a client that connected and went silent — the same
# slow-loris shape the idle reaper bounds for established streams
HANDSHAKE_TIMEOUT_S = 10.0


def is_tcp_target(target: str) -> bool:
    """True when ``target`` is ``HOST:PORT`` shaped (a path — anything
    with a ``/`` or no ``:<digits>`` tail — is a unix socket)."""
    return bool(_TCP_RE.match(target or ""))


def split_hostport(target: str) -> tuple[str, int]:
    m = _TCP_RE.match(target or "")
    if not m or not 0 <= int(m.group("port")) <= 65535:
        raise ValueError(
            f"not a HOST:PORT target: {target!r} (port 0-65535)")
    return m.group("host"), int(m.group("port"))


# ---------------------------------------------------------------------------
# TLS configuration: built ONCE at startup — a bad cert path
# fails the process before the socket exists, never the first client
# ---------------------------------------------------------------------------
class ServerTLS:
    """Server-side TLS for a TCP listener: ``--tls-cert/--tls-key``
    [+ ``--tls-client-ca`` for mTLS].  Construction validates and
    loads everything eagerly; a broken file is a startup ValueError,
    not a per-connection surprise."""

    def __init__(self, certfile: str, keyfile: str,
                 client_ca: str | None = None,
                 handshake_timeout_s: float = HANDSHAKE_TIMEOUT_S):
        self.certfile = certfile
        self.keyfile = keyfile
        self.client_ca = client_ca
        self.handshake_timeout_s = handshake_timeout_s
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        try:
            ctx.load_cert_chain(certfile, keyfile)
        except (OSError, ssl.SSLError) as e:
            raise ValueError(
                f"cannot load --tls-cert={certfile} / "
                f"--tls-key={keyfile}: {e}")
        if client_ca:
            try:
                ctx.load_verify_locations(client_ca)
            except (OSError, ssl.SSLError) as e:
                raise ValueError(
                    f"cannot load --tls-client-ca={client_ca}: {e}")
            ctx.verify_mode = ssl.CERT_REQUIRED
        self.ctx = ctx
        self.mutual = bool(client_ca)

    def wrap(self, conn: socket.socket) -> ssl.SSLSocket:
        """Run the server-side handshake on an accepted connection,
        bounded by the handshake timeout.  Raises ``OSError`` /
        ``ssl.SSLError`` on any failure (plaintext probe, protocol
        downgrade, mid-handshake disconnect, missing client cert) —
        the caller counts and closes."""
        old = conn.gettimeout()
        conn.settimeout(self.handshake_timeout_s)
        tls = self.ctx.wrap_socket(conn, server_side=True)
        tls.settimeout(old)
        return tls


class ClientTLS:
    """Client-side TLS: ``--tls-ca`` pins the server's issuing CA
    (chain verification, hostnames deliberately unchecked — see the
    module docstring) plus an optional ``--tls-cert/--tls-key`` client
    certificate for mTLS listeners."""

    def __init__(self, ca: str, certfile: str | None = None,
                 keyfile: str | None = None):
        self.ca = ca
        self.certfile = certfile
        self.keyfile = keyfile
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED
        try:
            ctx.load_verify_locations(ca)
        except (OSError, ssl.SSLError) as e:
            raise ValueError(f"cannot load --tls-ca={ca}: {e}")
        if certfile:
            try:
                ctx.load_cert_chain(certfile, keyfile or certfile)
            except (OSError, ssl.SSLError) as e:
                raise ValueError(
                    f"cannot load client --tls-cert={certfile} / "
                    f"--tls-key={keyfile}: {e}")
        self.ctx = ctx


def server_handshake(conn: socket.socket, tls: "ServerTLS",
                     on_failure=None) -> ssl.SSLSocket | None:
    """The accept-side TLS upgrade: returns the wrapped socket, or
    ``None`` after a failed handshake — counted via ``on_failure`` and
    answered with a LOUD close (the peer sees EOF/RST immediately, a
    plaintext probe never hangs), never an exception into the accept
    path."""
    try:
        return tls.wrap(conn)
    except (OSError, ssl.SSLError, ValueError) as e:
        if on_failure is not None:
            try:
                on_failure(e)
            except Exception:
                pass
        try:
            conn.close()
        except OSError:
            pass
        return None


def peer_common_name(conn) -> str | None:
    """The verified peer certificate's subject CN, or None (plaintext
    connection, or a TLS listener that did not require client certs).
    Only a ``CERT_REQUIRED`` handshake ever yields a non-empty peer
    cert, so a returned name is an *attested* identity."""
    if not isinstance(conn, ssl.SSLSocket):
        return None
    try:
        cert = conn.getpeercert()
    except (OSError, ssl.SSLError, ValueError):
        return None
    for rdn in (cert or {}).get("subject", ()):
        for key, value in rdn:
            if key == "commonName" and value:
                return str(value)
    return None


def connect(target: str, timeout: float | None = None,
            tls: ClientTLS | None = None) -> socket.socket:
    """One connected stream socket to ``target`` (AF_INET for
    ``HOST:PORT``, AF_UNIX otherwise).  A ``tls`` config wraps TCP
    connections (handshake included before returning); unix targets
    ignore it — they already carry kernel peer credentials, so one
    client config serves a mixed unix+TLS fleet.  Raises OSError /
    ssl.SSLError like the bare socket calls would — the caller owns
    the error rendering."""
    if is_tcp_target(target):
        host, port = split_hostport(target)
        s = socket.create_connection((host, port), timeout=timeout)
        if tls is not None:
            try:
                # SNI carries the dialed host; verification is
                # CA-chain only (check_hostname=False, see above)
                return tls.ctx.wrap_socket(s, server_hostname=host)
            except (OSError, ssl.SSLError):
                s.close()
                raise
        return s
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    if timeout is not None:
        s.settimeout(timeout)
    try:
        s.connect(target)
    except OSError:
        s.close()
        raise
    return s


def make_tcp_listener(spec: str, backlog: int = 16) -> socket.socket:
    """A bound+listening TCP socket for a ``HOST:PORT`` listen spec
    (port 0 = kernel-assigned; read it back via ``getsockname``).
    ``SO_REUSEADDR`` is set so a restarted daemon rebinds without
    waiting out TIME_WAIT — the crash-recovery path must not stall two
    minutes on its own ghost."""
    host, port = split_hostport(spec)
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind((host, port))
        s.listen(backlog)
    except OSError:
        s.close()
        raise
    return s


def make_unix_listener(path: str, backlog: int = 16) -> socket.socket:
    """A bound+listening unix socket at ``path``, chmod 0600 before
    the first accept — the filesystem is the unix transport's
    authentication layer, so the inode must never be born
    group/world-connectable.  A stale socket file is
    unlinked (the caller distinguishes stale from live via
    ``socket_alive`` first); raises OSError like the bare calls."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        if os.path.exists(path):
            os.unlink(path)
        s.bind(path)
        os.chmod(path, 0o600)
        s.listen(backlog)
    except OSError:
        s.close()
        raise
    return s


def socket_alive(path: str) -> bool:
    """True when a live listener answers on the unix socket at
    ``path`` — the stale-vs-live test both ``serve`` and ``route`` run
    before binding over an existing socket file."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(0.5)
    try:
        s.connect(path)
        return True
    except OSError:
        return False
    finally:
        s.close()


def target_name(target: str) -> str:
    """The sanitized member identity a target maps to — journal
    filenames under a shared ``--journal-dir`` and the ``member=``
    metric label both use it.  Unix sockets name by basename (two
    members sharing a journal dir must use distinct socket basenames —
    docs/FLEET.md), TCP targets by ``host_port``."""
    if is_tcp_target(target):
        host, port = split_hostport(target)
        return _NAME_BAD.sub("_", f"{host}_{port}")
    base = target.rstrip("/").rsplit("/", 1)[-1] or "socket"
    return _NAME_BAD.sub("_", base)


def member_journal_path(target: str,
                        journal_dir: str | None) -> str | None:
    """Where a member serving on ``target`` keeps its job journal —
    the placement-policy contract between ``serve --journal-dir`` and
    ``route --journal-dir`` (both compute it HERE, so the router finds
    exactly the file the member wrote):

    - with a shared ``journal_dir`` (durable network storage):
      ``<dir>/<member-name>.journal`` for any transport;
    - without one (fast local disk): the serve default
      ``<socket>.journal`` — readable by a same-host router for unix
      targets, unreachable for TCP targets (returns None: failover
      degrades to resubmit-with---resume, docs/FLEET.md)."""
    if journal_dir:
        return os.path.join(journal_dir,
                            target_name(target) + ".journal")
    if is_tcp_target(target):
        return None
    return target + ".journal"


def router_journal_path(socket_path: str | None, listen: str | None,
                        journal_dir: str | None) -> str | None:
    """Where a router serving on ``socket_path``/``listen`` keeps its
    write-ahead journal — the contract between the primary
    (``route --socket``) and its warm standby (``route --standby-of``),
    both of which compute it HERE so the standby tails exactly the
    file the primary writes.  Same placement policy as member
    journals:

    - with a shared ``journal_dir``: ``<dir>/router-<name>.journal``
      (the ``router-`` prefix keeps it out of the member-journal
      namespace the failover scan reads);
    - without one: ``<socket>.router.journal`` next to the unix
      socket — readable by a same-host standby;
    - TCP-only routers without a journal dir get None (no durable
      path both sides can agree on): the router runs journal-less,
      today's RAM-only behaviour, and says so at startup."""
    name_src = socket_path or listen
    if journal_dir and name_src:
        return os.path.join(
            journal_dir, "router-" + target_name(name_src) + ".journal")
    if socket_path:
        return socket_path + ".router.journal"
    return None
