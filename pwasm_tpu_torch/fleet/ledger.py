"""The global fair-share ledger: per-daemon DRR identities, fleet-wide.

Each serve daemon already runs weighted deficit-round-robin over its
own clients (``service/queue.py``) — but with N daemons behind one
router, "fair" has to mean fair across the FLEET: one client identity
gets one fleet-wide admission quota (not N per-member quotas it can
sum by spraying), and the router's placement must not let a heavy
client's backlog on member A starve a light client it happens to
co-place there.

The ledger is the router's accounting half of that contract (the
scheduling half stays in each member's DRR — the router forwards the
resolved client identity on every submit frame, so per-member fairness
keeps working unchanged):

- **fleet quota**: ``admit`` counts live (queued-or-running) jobs per
  client across all members and raises :class:`QueueFull` past
  ``max_queue`` per client (or ``max_total`` overall) — the same
  429-shaped contract as a single daemon, now with one ledger no
  spraying can dodge;
- **placement accounting**: per-client-per-member live counts back
  the aggregated fair-share/metrics surfaces (``fair_share.clients``,
  ``pwasm_fleet_client_jobs``) and let a failover ``move`` a job's
  slot between members without touching the client's quota.  (The
  router's least-loaded placement uses its own per-member
  dispatched-since-last-poll counter, NOT these lifetime counts — a
  long-running routed job the member already reports in its stats
  must not be double-counted.)

Counterpart of ``pwasm_tpu/fleet/ledger.py``, copied whole.  It
imports no torch: the router that keeps it holds no device.
"""

from __future__ import annotations

import threading

from pwasm_tpu_torch.service.queue import QueueFull


class FleetLedger:
    """Thread-safe fleet-wide per-client admission ledger."""

    def __init__(self, max_queue: int = 64,
                 max_total: int | None = None):
        self.max_queue = max(1, int(max_queue))
        self.max_total = max(self.max_queue, int(max_total)) \
            if max_total is not None else self.max_queue * 8
        self._lock = threading.Lock()
        self._live: dict[str, int] = {}       # client -> live jobs
        self._placed: dict[tuple[str, str], int] = {}  # (client,
        #   member) -> live jobs (the fairness-aware placement view)
        self._member_live: dict[str, int] = {}  # member -> router-
        #   placed live jobs (in-flight dispatch pressure the member's
        #   own queue-depth stat hasn't observed yet)
        self.admitted = 0
        self.rejected = 0

    def admit(self, client: str, member: str) -> None:
        """Count one job for ``client`` placed on ``member``; raises
        :class:`QueueFull` past the fleet quota (the router answers
        the protocol's 429 with it — same dance as a single daemon)."""
        with self._lock:
            if self._live.get(client, 0) >= self.max_queue:
                self.rejected += 1
                raise QueueFull(
                    f"client {client or 'default'!s} at the FLEET "
                    f"queue quota ({self.max_queue})")
            if sum(self._live.values()) >= self.max_total:
                self.rejected += 1
                raise QueueFull(
                    f"fleet at total capacity ({self.max_total})")
            self._live[client] = self._live.get(client, 0) + 1
            key = (client, member)
            self._placed[key] = self._placed.get(key, 0) + 1
            self._member_live[member] = \
                self._member_live.get(member, 0) + 1
            self.admitted += 1

    def restore(self, client: str, member: str) -> None:
        """Journal-replay re-admission (router restart/takeover):
        count a job that was already admitted — and acked —
        before the crash WITHOUT re-running the quota gate.  The
        admission promise was made by the previous incarnation; a
        replay that answered queue_full for it would turn crash
        recovery into a broken ack, which is exactly what the WAL
        exists to prevent.  (``admitted`` is not re-counted: the
        lifetime counter survives in spirit, not across processes.)"""
        with self._lock:
            self._live[client] = self._live.get(client, 0) + 1
            key = (client, member)
            self._placed[key] = self._placed.get(key, 0) + 1
            self._member_live[member] = \
                self._member_live.get(member, 0) + 1

    def move(self, client: str, src: str, dst: str) -> None:
        """Re-place one live job (failover: ``src`` died, the job now
        runs on ``dst``) — quota unchanged, placement counts move."""
        with self._lock:
            self._dec_placed(client, src)
            key = (client, dst)
            self._placed[key] = self._placed.get(key, 0) + 1
            self._member_live[dst] = \
                self._member_live.get(dst, 0) + 1

    def retire(self, client: str, member: str) -> None:
        """One job reached a terminal state the client can read."""
        with self._lock:
            n = self._live.get(client, 0) - 1
            if n > 0:
                self._live[client] = n
            else:
                self._live.pop(client, None)
            self._dec_placed(client, member)

    def _dec_placed(self, client: str, member: str) -> None:
        key = (client, member)
        n = self._placed.get(key, 0) - 1
        if n > 0:
            self._placed[key] = n
        else:
            self._placed.pop(key, None)
        n = self._member_live.get(member, 0) - 1
        if n > 0:
            self._member_live[member] = n
        else:
            self._member_live.pop(member, None)

    def client_depths(self) -> dict[str, int]:
        """Live fleet-wide jobs per client (the aggregated
        ``fair_share.clients`` block and the
        ``pwasm_fleet_client_jobs`` gauge source)."""
        with self._lock:
            return dict(self._live)

    def member_pressure(self, member: str) -> int:
        """Router-placed LIVE jobs on ``member`` (accounting/gauge
        surface; placement uses the router's dispatched-since-poll
        counter instead — see the module docstring)."""
        with self._lock:
            return self._member_live.get(member, 0)
