"""The warm-standby router (``route --standby-of=TARGET``).

Counterpart of ``pwasm_tpu/fleet/standby.py``, with its names.

A single router in front of N members is a single point of failure:
kill it and every client's submit surface is gone until an operator
notices.  The standby closes that hole with the cheapest HA shape
that actually works for a unix-socket daemon:

- **warmth**: the standby tails the primary's write-ahead journal
  (``fleet/transport.py::router_journal_path`` — both sides compute
  the path, so they cannot disagree about which file it is) and
  re-folds it whenever it grows, so at takeover time the routed-job
  table is already parsed and the promotion is a bind, not a scan;
- **death detection**: the primary is pinged every poll tick; only
  ``_TAKEOVER_STRIKES`` CONSECUTIVE failed pings (same philosophy as
  the router's own member strikes) promote — one slow ping is a busy
  primary, not a dead one;
- **takeover**: the standby constructs a full :class:`Router` on the
  PRIMARY's socket path with the journal-adopted member set and calls
  ``serve()`` — the router's own stale-socket check
  (``fleet/transport.py::socket_alive``) unlinks the dead primary's
  socket and binds, its ``_open_journal`` replays the shared WAL, and
  the epoch bump it performs fences any
  zombie primary that is merely stalled: members leased to the old
  epoch refuse its writes the moment the new era heartbeats.

The standby inherits EVERYTHING identity-shaped from the journal —
backends from the last ``members`` record, the socket from
``--standby-of`` itself — and ``route_main`` refuses ``--backends``/
``--socket``/``--listen`` alongside ``--standby-of`` loudly, because a
flag-supplied fleet view is exactly the split-brain the journal
exists to prevent.

Like the rest of ``pwasm_tpu_torch/fleet/`` it imports no torch
(``tests/test_torch_isolation.py``).
"""

from __future__ import annotations

import os
import sys
import time

from pwasm_tpu_torch.core.errors import EXIT_USAGE
from pwasm_tpu_torch.fleet.transport import (is_tcp_target,
                                             router_journal_path)
from pwasm_tpu_torch.resilience.lifecycle import SignalDrain
from pwasm_tpu_torch.service.client import ServiceClient, ServiceError
from pwasm_tpu_torch.service.journal import JobJournal

# consecutive failed pings before the standby promotes itself.  One
# more strike than the router gives its members: a wrong member
# failover re-admits jobs (recoverable); a wrong TAKEOVER binds a
# second router while the first still lives (the epoch fence catches
# it, but there is no reason to race in the first place).
_TAKEOVER_STRIKES = 3


def run_standby(primary: str, stderr=None,
                router_kwargs: dict | None = None) -> int:
    """Tail ``primary``'s journal until it dies, then take over its
    socket as a full router.  Returns the promoted router's exit code
    (or 0 if drained while still standing by)."""
    stderr = stderr if stderr is not None else sys.stderr
    kwargs = dict(router_kwargs or {})
    kwargs.pop("stderr", None)

    def say(msg: str) -> None:
        print(f"pwasm-route: {msg}", file=stderr)

    if is_tcp_target(primary):
        say("error: --standby-of needs the primary's unix SOCKET "
            "path — a takeover binds that socket, and a TCP "
            "endpoint on another host cannot be bound from here")
        return EXIT_USAGE
    jpath = router_journal_path(primary, None,
                                kwargs.get("journal_dir"))
    poll = max(0.05, float(kwargs.get("poll_interval") or 0.5))
    say(f"standing by for router on {primary} "
        f"(tailing {jpath}, poll every {poll}s)")
    strikes = 0
    seen_alive = False
    warm: dict | None = None
    warm_mtime = -1.0
    drain = SignalDrain(stderr=stderr)
    with drain:
        while not drain.requested:
            try:
                with ServiceClient(primary, timeout=3.0) as c:
                    resp = c.request({"cmd": "ping"})
                if not resp.get("ok"):
                    raise ServiceError(f"ping failed: {resp}")
                strikes = 0
                seen_alive = True
            except (ServiceError, OSError):
                # never promote onto a primary we never saw alive AND
                # whose journal does not exist: nothing to inherit
                # means nothing to serve — keep waiting for it to
                # start (the operator may have launched us first)
                if seen_alive or os.path.exists(jpath):
                    strikes += 1
            # warmth: re-fold the journal whenever it grows, so the
            # takeover path starts from parsed state, not a cold file
            try:
                mtime = os.stat(jpath).st_mtime
            except OSError:
                mtime = -1.0
            if mtime != warm_mtime:
                warm_mtime = mtime
                from pwasm_tpu_torch.fleet.router import fold_route_records
                records = JobJournal(jpath).replay()
                warm = fold_route_records(records) if records \
                    else None
            if strikes >= _TAKEOVER_STRIKES:
                break
            time.sleep(poll)
    if drain.requested:
        say("standby drained before any takeover; primary keeps "
            "serving")
        return 0
    backends = (warm or {}).get("members")
    if not backends:
        say(f"error: primary on {primary} is dead but its journal "
            f"({jpath}) holds no members snapshot to inherit — "
            "cannot take over; restart the primary instead")
        return 1
    say(f"primary on {primary} missed {_TAKEOVER_STRIKES} pings — "
        f"TAKING OVER its socket with {len(backends)} member(s) "
        "from the journal")
    # the promoted router replays the shared WAL itself
    # (_open_journal) and bumps the epoch, fencing any zombie primary
    from pwasm_tpu_torch.core.errors import PwasmError
    from pwasm_tpu_torch.fleet.router import Router
    try:
        router = Router(backends, socket_path=primary,
                        takeover=True, stderr=stderr, **kwargs)
        return router.serve()
    except ValueError as e:
        say(f"error: cannot promote: {e}")
        return 1
    except PwasmError as e:
        stderr.write(str(e))
        return e.exit_code
