"""Scoped capability tokens for the daemon's edge.

Counterpart of ``pwasm_tpu/service/authz.py``, with its names.
``serve --auth-tokens=FILE`` arms this module: the file maps
*principals* to capability scopes, and every protocol frame must then
carry a principal whose scopes cover its verb.  Without the flag
nothing here runs and every verb stays open, as on a daemon without
authentication.

Principals (the keys of the token file):

- a bare token string — presented by clients via ``--client-token``
  (the ``client_token`` frame field);
- ``cn:<name>`` — an mTLS-attested peer certificate CN
  (``--tls-client-ca`` listeners): the connection itself is the
  credential, no frame field needed;
- ``uid:<n>`` — a kernel-attested unix-socket peer uid;
- ``*`` — the default entry for frames with no recognized credential
  (set it to ``["submit", "read"]`` to keep the data plane open while
  locking the control plane).

Scopes: ``submit`` (submit/stream admission), ``read``
(status/result/inspect/stats/metrics/health/logs/cache-probe),
``cancel-own`` (cancel jobs whose resolved client identity matches
yours), ``admin`` (everything, including the verbs that can take the
daemon down: ``drain``, ``lease-grant``, ``fence``, cancel-any).

The file is JSON with the checkpoint's integrity rule: a ``crc`` field
(``fsio.payload_crc`` over the rest) so a torn write is DETECTED and
the last good policy kept, never half-applied.  It hot-reloads on the
daemon's 0.2 s accept-loop tick (mtime/size change), so rotating a
token needs no restart; an unreadable or corrupt reload keeps the
previous policy and warns — degrading OPEN on a bad file would be the
one wrong answer.

An unauthorized frame answers the ``unauthorized`` error having
changed no queue/journal/lease state, and repeated failures from one
peer trip :class:`PenaltyBox` — a capped-exponential connection-level
delay (brute-force damping) surfaced as
``pwasm_transport_auth_failures_total{client=...}``.
"""

from __future__ import annotations

import json
import os
import threading

SCOPE_SUBMIT = "submit"
SCOPE_READ = "read"
SCOPE_CANCEL_OWN = "cancel-own"
SCOPE_ADMIN = "admin"
ALL_SCOPES = frozenset((SCOPE_SUBMIT, SCOPE_READ, SCOPE_CANCEL_OWN,
                        SCOPE_ADMIN))

# verb -> required scope (None = open: liveness must stay probeable).
# SCOPE_CANCEL_OWN is special-cased by the caller — ownership needs
# the job row, which only the dispatch site holds.  A ``stats`` frame
# carrying a ``lease`` object is a lease grant riding the heartbeat
# and is promoted to admin by required_scope().
VERB_SCOPES: dict[str, str | None] = {
    "ping": None,
    "submit": SCOPE_SUBMIT,
    "stream": SCOPE_SUBMIT,
    "stream-data": SCOPE_SUBMIT,
    "stream-end": SCOPE_SUBMIT,
    "status": SCOPE_READ,
    "result": SCOPE_READ,
    "inspect": SCOPE_READ,
    "stats": SCOPE_READ,
    "metrics": SCOPE_READ,
    "health": SCOPE_READ,
    "logs": SCOPE_READ,
    "cache-probe": SCOPE_READ,
    "cancel": SCOPE_CANCEL_OWN,
    "drain": SCOPE_ADMIN,
    "lease-grant": SCOPE_ADMIN,
    "fence": SCOPE_ADMIN,
}


def required_scope(cmd, req: dict) -> str | None:
    """The scope ``cmd`` needs (None = open, including unknown verbs
    — those answer ``unknown_cmd``, which changes nothing and leaks
    nothing).  A ``stats`` frame carrying a lease heartbeat is a
    lease GRANT and needs admin like the standalone verb."""
    scope = VERB_SCOPES.get(cmd)
    if cmd == "stats" and req.get("lease") is not None:
        return SCOPE_ADMIN
    return scope


def write_auth_tokens(path: str, tokens: dict) -> None:
    """Mint a token file: ``{principal: [scope, ...]}`` stamped with
    the integrity CRC, written durably (fsio) so a crash mid-rotation
    leaves either the old file or the new one, never a torn hybrid."""
    from pwasm_tpu_torch.utils.fsio import payload_crc, write_durable_text
    payload = {"tokens": {str(k): sorted(set(v))
                          for k, v in tokens.items()}}
    payload["crc"] = payload_crc(payload)
    write_durable_text(path, json.dumps(payload, sort_keys=True,
                                        separators=(",", ":")) + "\n")


def _parse_tokens(path: str) -> dict[str, frozenset]:
    """Load and validate a token file; raises ValueError on ANY
    defect (shape, unknown scope, CRC mismatch) — the caller decides
    whether that is fatal (startup) or keep-last-good (reload)."""
    from pwasm_tpu_torch.utils.fsio import payload_crc
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read auth-tokens file {path}: {e}")
    except json.JSONDecodeError as e:
        raise ValueError(f"auth-tokens file {path} is not JSON: {e}")
    if not isinstance(obj, dict) or "crc" not in obj \
            or not isinstance(obj.get("tokens"), dict):
        raise ValueError(
            f"auth-tokens file {path} must be an object "
            '{"tokens": {principal: [scope, ...]}, "crc": N}')
    crc = obj.pop("crc")
    if payload_crc(obj) != crc:
        raise ValueError(
            f"auth-tokens file {path} failed its integrity CRC "
            "(torn or hand-edited write) — re-mint it")
    out: dict[str, frozenset] = {}
    for principal, scopes in obj["tokens"].items():
        if not isinstance(principal, str) or not principal:
            raise ValueError(
                f"auth-tokens file {path}: empty principal")
        if not isinstance(scopes, list) \
                or not all(isinstance(s, str) for s in scopes):
            raise ValueError(
                f"auth-tokens file {path}: scopes for "
                f"{principal!r} must be a list of strings")
        bad = sorted(set(scopes) - ALL_SCOPES)
        if bad:
            raise ValueError(
                f"auth-tokens file {path}: unknown scope(s) "
                f"{bad} for {principal!r} (valid: "
                f"{sorted(ALL_SCOPES)})")
        out[principal] = frozenset(scopes)
    return out


class AuthRegistry:
    """The live scoped-token policy: strict load at startup,
    keep-last-good hot reload on the accept-loop tick."""

    def __init__(self, path: str, say=None):
        self.path = path
        self._say = say          # warning sink (daemon._say shaped)
        self._lock = threading.Lock()
        self._scopes = _parse_tokens(path)   # startup: fail fast
        self._sig = self._stat_sig()
        self._warned_sig = None  # one warning per bad generation
        self.reloads = 0

    def _stat_sig(self):
        try:
            st = os.stat(self.path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def maybe_reload(self) -> None:
        """Called from the accept-loop tick: swap in a changed file's
        policy atomically, keep the last good one (warn once per bad
        generation) when the new bytes don't validate."""
        sig = self._stat_sig()
        if sig == self._sig:
            return
        try:
            scopes = _parse_tokens(self.path)
        except ValueError as e:
            if sig != self._warned_sig:
                self._warned_sig = sig
                if self._say is not None:
                    self._say(f"warning: auth-tokens reload refused "
                              f"({e}); keeping the previous policy")
            self._sig = sig   # don't re-parse the same bad bytes
            #                   every 0.2 s tick — only on next change
            return
        with self._lock:
            self._scopes = scopes
            self._sig = sig
            self._warned_sig = None
            self.reloads += 1
        if self._say is not None:
            self._say(f"auth-tokens reloaded from {self.path} "
                      f"({len(scopes)} principal(s))")

    def scopes_for(self, token, peer) -> frozenset:
        """Union of the scopes granted to every credential the frame
        presents: its ``client_token``, the connection's attested
        peer principal (``cn:<name>`` / ``uid:<n>``), and the ``*``
        default entry."""
        with self._lock:
            scopes = self._scopes
        out: set = set()
        if isinstance(token, str) and token:
            out |= scopes.get(token, frozenset())
        if isinstance(peer, str) and peer:
            out |= scopes.get(peer, frozenset())
        out |= scopes.get("*", frozenset())
        return frozenset(out)

    def allows(self, req: dict, peer, scope: str) -> bool:
        """True when the frame's credentials carry ``scope`` (admin
        implies every scope)."""
        got = self.scopes_for(req.get("client_token"), peer)
        return scope in got or SCOPE_ADMIN in got


class PenaltyBox:
    """Brute-force damping: consecutive auth failures from one peer
    earn a capped-exponential delay (served in that connection's own
    thread — the accept loop never blocks).  A success clears the
    peer's debt.  The table is bounded: past ``max_peers`` the oldest
    entry is evicted, so an attacker spraying identities costs memory
    O(max_peers), not O(attempts)."""

    def __init__(self, base_s: float = 0.05, cap_s: float = 2.0,
                 max_peers: int = 1024):
        self.base_s = base_s
        self.cap_s = cap_s
        self.max_peers = max_peers
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def fail(self, key: str) -> float:
        """Record one failure for ``key``; returns the delay (s) the
        refusal should be held for."""
        with self._lock:
            if key not in self._counts \
                    and len(self._counts) >= self.max_peers:
                self._counts.pop(next(iter(self._counts)))
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
        return min(self.cap_s, self.base_s * (2 ** (n - 1)))

    def clear(self, key: str) -> None:
        with self._lock:
            self._counts.pop(key, None)
