"""Epoch-lease fencing: the one mechanism standing between a
network-partitioned-but-alive fleet member and silent report
corruption.

Counterpart of ``pwasm_tpu/fleet/fencing.py``, copied whole.  The
router side (the epoch's journal, failover) comes with a later slice
of the port; the serve daemon already keeps the member side.

The failure class
-----------------
Fleet failover re-admits a dead member's in-flight
jobs as ``--resume`` continuations on a sibling.  Death detection is
evidence-based (consecutive stats-poll failures), so a member that is
merely PARTITIONED from the router looks exactly like a dead one —
and once the sibling's resume starts, two processes are appending to
the same report lineage.  Two resumers of one report is the one
failure class the ckpt-v2 clean-prefix contract cannot absorb: each
side's journal is internally consistent, but the merged history is
garbage.

The fix, in three interlocking pieces
-------------------------------------
1. **Epoch**: the router keeps a monotonic fleet epoch, durably
   journaled.  Every failover re-admission and every router
   restart/takeover bumps it — a bump means "placements made under
   earlier epochs may have been superseded".
2. **Lease**: members accept work only under a router-granted lease
   ``{epoch, ttl_s}``, heartbeated by piggybacking on the existing
   stats poll (no new RPC round-trips).  :class:`EpochLease` is the
   member-side latch: grants with a LOWER epoch than the member has
   already seen are refused (a stale router cannot re-arm a member
   the fleet has moved past).
3. **Self-fence**: a member whose lease TTL expires fences itself —
   it preempts in-flight jobs at the next batch boundary (landing a
   valid durable ckpt, exactly like a drain) and answers new
   ``submit``/``stream``/``stream-data`` frames with the ``fenced``
   error — so by the time the router's strike window declares it dead
   and a sibling resumes, the zombie has already stopped writing.
   The router edge independently rejects stale completions (a
   terminal reply whose placement generation changed mid-request),
   so even a fence that lands LATE cannot publish a superseded
   verdict.

:func:`readmit_epoch_guard` is the choke point: any code path that
re-admits a started job as ``--resume`` must route its epoch
bookkeeping through this helper, so "resume without fencing" cannot
be reintroduced silently.

It imports no torch: it runs inside the router and the daemon's
socket threads.
"""

from __future__ import annotations

import threading
import time

# default lease TTL granted by the router.  Long enough that two
# consecutive 2 s stats polls can be missed without fencing a healthy
# member on a scheduling hiccup; short enough that a real partition
# fences well inside the window a human would need to even notice.
DEFAULT_LEASE_TTL_S = 15.0


class EpochLease:
    """The member-side lease latch (one per daemon, thread-safe).

    Ungoverned until the first grant: a standalone ``serve`` daemon
    that never meets a router keeps today's behaviour exactly — no
    TTL, no fencing, ``expired()`` never fires.  The first
    ``lease-grant`` (or lease-carrying stats poll) latches the member
    into governed mode; from then on the lease must be heartbeated or
    the member self-fences."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.governed = False      # latched by the first grant
        self.epoch = 0             # highest epoch ever seen (monotone)
        self.ttl_s = 0.0
        self.fenced = False
        self.fences = 0            # lifetime fence transitions
        self.fence_reason = ""
        self._deadline = float("inf")

    def grant(self, epoch: int, ttl_s: float) -> tuple[bool, str]:
        """Accept or refuse a lease grant/heartbeat.

        Returns ``(accepted, detail)``.  A grant at an epoch LOWER
        than the member has already seen is refused — that is the
        stale-router signature (the fleet bumped past it during a
        failover or takeover this router never saw).  An accepted
        grant refreshes the TTL deadline and clears any standing
        fence: the router is the epoch source of truth, so a
        heartbeat at the current (or newer) epoch means every resume
        race the fence guarded against has been fenced at the router
        edge already."""
        if not isinstance(epoch, int) or isinstance(epoch, bool) \
                or epoch < 1:
            return False, f"lease epoch must be an integer >= 1, " \
                          f"got {epoch!r}"
        try:
            ttl = float(ttl_s)
        except (TypeError, ValueError):
            return False, f"lease ttl_s must be a number, got {ttl_s!r}"
        if not ttl > 0 or ttl != ttl or ttl == float("inf"):
            return False, f"lease ttl_s must be finite and > 0, " \
                          f"got {ttl_s!r}"
        with self._lock:
            if epoch < self.epoch:
                return False, (
                    f"stale epoch {epoch} < member epoch "
                    f"{self.epoch}: this member has seen a newer "
                    f"fleet epoch; the granting router is behind a "
                    f"failover/takeover and must not re-arm it")
            self.governed = True
            self.epoch = epoch
            self.ttl_s = ttl
            self._deadline = self._clock() + ttl
            if self.fenced:
                self.fenced = False
                self.fence_reason = ""
            return True, ""

    def expired(self) -> bool:
        """True when a governed, not-yet-fenced lease has outlived its
        TTL — the daemon's tick loop turns this into a self-fence."""
        with self._lock:
            return self.governed and not self.fenced \
                and self._clock() > self._deadline

    def fence(self, reason: str) -> bool:
        """Latch the fence.  Returns True on the 0->1 transition (the
        caller preempts jobs / counts the metric exactly once)."""
        with self._lock:
            if not self.governed or self.fenced:
                return False
            self.fenced = True
            self.fences += 1
            self.fence_reason = reason
            return True

    def remaining_s(self) -> float:
        with self._lock:
            if not self.governed:
                return float("inf")
            return self._deadline - self._clock()

    def as_dict(self) -> dict:
        """The ``stats``/``health`` lease block (additive schema)."""
        with self._lock:
            out = {"governed": self.governed, "epoch": self.epoch,
                   "ttl_s": self.ttl_s, "fenced": self.fenced,
                   "fences": self.fences}
            if self.governed:
                rem = self._deadline - self._clock()
                out["remaining_s"] = round(rem, 3) \
                    if rem != float("inf") else None
            if self.fenced:
                out["reason"] = self.fence_reason
            return out


def readmit_epoch_guard(job_epoch: int, fleet_epoch: int) -> int:
    """The fencing choke point for ``--resume`` re-admission.

    Called by every code path that re-admits a started job as a
    ``--resume`` continuation (the qa fencing gate enforces this
    statically).  Takes the epoch the job's CURRENT placement was made
    under and the fleet's current epoch; returns the epoch to stamp
    the NEW placement with.  Raises ``RuntimeError`` if the invariant
    that makes resume safe is broken — a re-admission running under an
    epoch NEWER than the fleet's own would mean two routers disagree
    about who owns the fleet, which is exactly the double-resume race
    fencing exists to prevent.
    """
    if job_epoch > fleet_epoch:
        raise RuntimeError(
            f"fencing violation: job placed under epoch {job_epoch} "
            f"but the fleet epoch is {fleet_epoch} — a re-admission "
            f"would race a newer owner's resume of the same report")
    return fleet_epoch
