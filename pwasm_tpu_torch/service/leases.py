"""Device-lease scheduler for the warm-pool daemon.

Counterpart of ``pwasm_tpu/service/leases.py``, with its names.  Two
concurrent jobs with no lease would place their kernels on one card
while the host's other cards idle.  The device inventory is
partitioned into **lanes** (``devices_per_lease`` CUDA devices each),
every running job holds exactly one :class:`DeviceLease`, and a job
that cannot get a lease WAITS: admission is lease-aware, not just
worker-thread-aware.

A lease names a *span of CUDA device indices* ``[device_lo,
device_hi)`` into ``torch.cuda`` order, and the served job's
``cli.run`` maps the span onto real devices (``cli._lane_device_pool``,
clamping when fewer exist; on a one-card host every lane shares
cuda:0, and on the CPU a lease is a plain concurrency token).  This
module imports no torch.

What else rides the lease: the per-lane warm state.  With K lanes a
fault on lane 0's card must not degrade lane 1's healthy card, so the
supervisor snapshot (and the ``monitor`` slot, which the port never
fills: it has no re-probing monitor) live ON the lease, exclusive
while a job holds it and inherited by the NEXT job on the same lane,
and the daemon reports a roll-up (worst lane) for its single breaker
gauge plus a per-lane gauge vector.

Fairness: grants are strict FIFO over waiters (a ticket queue, not a
bare ``Condition`` — ``notify`` order is unspecified, and a starved
submitter is an SLO violation, not a scheduling detail).
"""

from __future__ import annotations

import threading
import time
from collections import deque


class DeviceLease:
    """One lane of the device inventory plus its warm state.

    ``lane``                 0-based lane index;
    ``device_lo/device_hi``  the half-open span of device indices this
                             lane owns (CUDA device indices);
    ``supervisor_state``     the breaker/ceiling snapshot exported by
                             the LAST job that ran on this lane
                             (``BatchSupervisor.export_state`` minus
                             the fault clock);
    ``monitor``              the reference's health-monitor slot,
                             always None in the port;
    ``jobs_run``             completed grants, for the lane gauges.

    No lock: between ``acquire`` and ``release`` the holder owns the
    object exclusively; the manager's lock covers the free/busy flip.
    """

    def __init__(self, lane: int, device_lo: int, device_hi: int):
        self.lane = lane
        self.device_lo = device_lo
        self.device_hi = device_hi
        self.supervisor_state: dict | None = None
        self.monitor = None
        self.jobs_run = 0
        self.busy = False
        self.busy_s_total = 0.0    # cumulative leased wall (the
        #   per-lane busy-fraction gauge source)
        self.granted_at = 0.0      # monotonic grant time while busy

    @property
    def devices(self) -> tuple[int, int]:
        return (self.device_lo, self.device_hi)

    def __repr__(self) -> str:  # debug/log friendliness
        return (f"DeviceLease(lane={self.lane}, "
                f"devices=[{self.device_lo},{self.device_hi}), "
                f"busy={self.busy})")


class _Waiter:
    """One FIFO ticket: ``box`` is filled with the granted lease (or
    None on drain) before ``event`` is set."""

    __slots__ = ("event", "box")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.box: DeviceLease | None = None


class LeaseManager:
    """Thread-safe FIFO lease pool over ``n_lanes`` lanes of
    ``devices_per_lease`` device indices each."""

    def __init__(self, n_lanes: int, devices_per_lease: int = 1):
        self.n_lanes = max(1, int(n_lanes))
        self.devices_per_lease = max(1, int(devices_per_lease))
        self._leases = [
            DeviceLease(i, i * self.devices_per_lease,
                        (i + 1) * self.devices_per_lease)
            for i in range(self.n_lanes)]
        self._free: deque[DeviceLease] = deque(self._leases)
        self._waiters: deque[_Waiter] = deque()
        self._lock = threading.Lock()
        self._draining = False
        self.grants = 0          # cumulative, for stats
        self.wait_s_total = 0.0  # cumulative lease-wait wall

    # ---- introspection (gauges/stats read these) -----------------------
    @property
    def draining(self) -> bool:
        return self._draining

    def leases(self) -> list[DeviceLease]:
        return list(self._leases)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def busy_count(self) -> int:
        with self._lock:
            return self.n_lanes - len(self._free)

    def waiting_count(self) -> int:
        with self._lock:
            return len(self._waiters)

    # ---- grant/release -------------------------------------------------
    def acquire(self, timeout: float | None = None,
                should_abort=None,
                poll_s: float = 0.25,
                prefer_lane: int | None = None) -> DeviceLease | None:
        """Grant the next free lease, FIFO among callers.  Returns None
        on timeout, once :meth:`drain` latched, or when
        ``should_abort()`` turns true mid-wait.  (Wait observability:
        the caller times the call itself — the daemon feeds its
        lease-wait histogram that way, including zero-wait grants —
        and ``wait_s_total`` aggregates the queued waits here.)

        ``prefer_lane`` is an AFFINITY HINT, not a reservation: when
        that lane is free it is granted (a journal-recovered job goes
        back to the lane it ran on, inheriting that lane's warm
        breaker/ceiling state instead of polluting a neighbor's);
        when it is busy — or the caller had to queue — any lane
        serves, because byte output is placement-independent and a
        hard reservation would let one recovered job idle a whole
        pool behind it.

        The ONE ticket enqueued here survives the whole wait —
        ``should_abort`` is polled every ``poll_s`` on the same ticket
        rather than the caller looping short-timeout acquires, because
        a timeout withdraws the ticket and a fresh call re-enqueues at
        the BACK, silently reordering two waiting callers (the exact
        starvation the FIFO queue exists to prevent) and clipping the
        recorded wait to the final slice."""
        t0 = time.monotonic()
        with self._lock:
            if self._draining:
                return None
            if self._free and not self._waiters:
                lease = None
                if prefer_lane is not None:
                    for cand in self._free:
                        if cand.lane == prefer_lane:
                            lease = cand
                            self._free.remove(cand)
                            break
                if lease is None:
                    lease = self._free.popleft()
                lease.busy = True
                lease.granted_at = time.monotonic()
                self.grants += 1
                return lease
            w = _Waiter()
            self._waiters.append(w)
        deadline = None if timeout is None else t0 + timeout
        while True:
            if deadline is None:
                slice_t = poll_s if should_abort is not None else None
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    ok = False
                    break
                slice_t = min(poll_s, remaining) \
                    if should_abort is not None else remaining
            ok = w.event.wait(slice_t)
            if ok:
                break
            if should_abort is not None and should_abort():
                break
            if deadline is not None \
                    and time.monotonic() >= deadline:
                break
        waited = time.monotonic() - t0
        with self._lock:
            if w.box is None:
                # timed out (aborted, or drained): withdraw the
                # ticket; a grant racing this withdrawal filled the
                # box first and wins
                try:
                    self._waiters.remove(w)
                except ValueError:
                    pass
                if w.box is None:
                    return None
            lease = w.box
            self.grants += 1
            self.wait_s_total += waited
        return lease

    def release(self, lease: DeviceLease) -> None:
        """Return ``lease`` to the pool, handing it straight to the
        oldest waiter if one queued (FIFO — the starvation guard)."""
        with self._lock:
            lease.busy = False
            lease.busy_s_total += max(
                0.0, time.monotonic() - lease.granted_at)
            lease.jobs_run += 1
            while self._waiters:
                w = self._waiters.popleft()
                if not w.event.is_set():
                    lease.busy = True
                    lease.granted_at = time.monotonic()
                    w.box = lease
                    w.event.set()
                    return
            if lease not in self._free:
                self._free.append(lease)

    def drain(self) -> None:
        """Latch: every queued and future ``acquire`` returns None.
        Leases already granted stay valid until released (the in-flight
        jobs finish at their batch boundaries)."""
        with self._lock:
            self._draining = True
            waiters, self._waiters = list(self._waiters), deque()
        for w in waiters:
            w.event.set()      # box stays None: "no lease, drained"

    # ---- roll-ups ------------------------------------------------------
    def breaker_rollup(self) -> int:
        """Worst breaker state over all lanes (0 closed, 1 half-open,
        2 open — the daemon-level gauge encoding): one number for the
        operator's 'is anything degraded' glance, with the per-lane
        gauge vector carrying the which.  Derived from the SAME
        locked snapshot as :meth:`lane_states` so the roll-up gauge
        can never disagree with max() over the per-lane vector within
        one scrape."""
        return max((r["breaker_state"] for r in self.lane_states()),
                   default=0)

    def lane_states(self) -> list[dict]:
        """Per-lane stats rows (the svc-stats ``lanes`` block)."""
        from pwasm_tpu_torch.obs.catalog import breaker_state_value
        out = []
        now = time.monotonic()
        with self._lock:
            for lease in self._leases:
                st = lease.supervisor_state
                mon = lease.monitor
                busy_s = lease.busy_s_total
                if lease.busy:
                    # include the CURRENT grant's elapsed time, so a
                    # long-running job shows as busy wall, not zero
                    busy_s += max(0.0, now - lease.granted_at)
                out.append({
                    "lane": lease.lane,
                    "devices": [lease.device_lo, lease.device_hi],
                    "busy": lease.busy,
                    "jobs_run": lease.jobs_run,
                    "busy_s": round(busy_s, 3),
                    "breaker_state": breaker_state_value(
                        bool(st.get("breaker_open")) if st else False,
                        mon.state if mon is not None else None),
                })
        return out
