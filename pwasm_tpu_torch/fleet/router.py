"""The fleet router daemon (``pwasm-tpu route``).

One router process in front of N serve daemons (same host over unix
sockets, across hosts over TCP) exposes the FULL serve protocol —
submit/stream/result/cancel/status/inspect/stats/metrics/drain/ping —
on one endpoint, so "millions of users" stop dying at one socket on
one host:

- **placement**: every submit lands on the member with the least
  (queue depth + running + router-placed-but-not-yet-visible) load,
  refreshed from each member's registry-backed svc-stats by the health
  loop; a member answering ``queue_full`` is skipped for the next-best
  sibling before the client ever sees a 429;
- **global fair share**: client identities (explicit ``client=``,
  ``tok:`` tokens on TCP, peer uid on unix) get ONE fleet-wide
  admission quota in the :class:`~pwasm_tpu_torch.fleet.ledger.FleetLedger`
  and ride every forwarded frame, so each member's DRR keeps being
  fair per member while no client can dodge its quota by spraying
  members;
- **journal-aware failover**: a member that dies mid-job (SIGKILL,
  OOM-kill, host loss) is detected by the health loop; the router
  reads the member's job journal (shared ``--journal-dir`` or the
  same-host ``<socket>.journal`` default — docs/FLEET.md placement
  policy) and re-admits every started-unfinished job to a sibling as
  a ``--resume`` continuation of its own report checkpoint — a
  daemon's own kill -9 recovery, across processes.  Jobs the journal
  shows FINISHED are served from their CRC-verified spool files; acked
  cancels stay cancelled; live streams land terminal
  preempted-RESUMABLE exactly as a restarting member would land them.
  The consumed journal is
  then set aside (``<journal>.recovered``) so a later restart of that
  member cannot re-run work a sibling already owns.

The router holds no device, no queue of its own (members queue), and
imports no torch: it moves frames, reads journals, and keeps the
ledger.  Job identity: the
router mints fleet-wide ids (``fleet-NNNN``) and rewrites member ids
at the edge; the client-supplied ``trace_id`` is forwarded verbatim on
every frame — including failover re-admissions — so one
``trace-merge`` of client + router + member traces reconstructs a
job's whole cross-process, cross-crash life.

Counterpart of ``pwasm_tpu/fleet/router.py``, with its names, its
protocol and its write-ahead journal, over the port's serve daemons,
with the warm standby (``fleet/standby.py``), the SLO scaler
(``fleet/scaler.py``) and the fleet-wide scatter of an
``--m2m-stream`` (``surveil/partition.py``).
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time

from pwasm_tpu_torch.core.errors import EXIT_USAGE, PwasmError
from pwasm_tpu_torch.fleet.fencing import (DEFAULT_LEASE_TTL_S,
                                           readmit_epoch_guard)
from pwasm_tpu_torch.fleet.ledger import FleetLedger
from pwasm_tpu_torch.fleet.transport import (is_tcp_target,
                                             make_tcp_listener,
                                             member_journal_path,
                                             router_journal_path,
                                             target_name)
from pwasm_tpu_torch.resilience.lifecycle import SignalDrain
from pwasm_tpu_torch.service import protocol
from pwasm_tpu_torch.service.client import ServiceClient, ServiceError
from pwasm_tpu_torch.service.journal import (JOURNAL_VERSION,
                                             REC_EPOCH, REC_MEMBERS,
                                             REC_ROUTE_ADMIT,
                                             REC_ROUTE_PLACE,
                                             REC_ROUTE_RETIRE, REC_ROUTE_SHED,
                                             REC_SCALE, JobJournal,
                                             fold_records)
from pwasm_tpu_torch.service.queue import (JOB_CANCELLED, JOB_DONE,
                                           JOB_FAILED, JOB_PREEMPTED,
                                           QueueFull, TERMINAL_STATES,
                                           _sum_numeric)

_ROUTE_USAGE = """Usage:
 pwasm-tpu route --backends=TARGET[,TARGET...]
                 (--socket=PATH | --listen=HOST:PORT) [both allowed]
                 [--journal-dir=DIR] [--max-queue=N]
                 [--max-queue-total=N] [--poll-interval=S]
                 [--lease-ttl=S] [--scale-policy=FILE]
                 [--stream-replay-bytes=N]
                 [--metrics-textfile=PATH] [--log-json=FILE]
                 [--trace-json=FILE] [--slo-rules=FILE|off]
                 [--result-cache=DIR|off]
                 [--result-cache-max-bytes=N]
                 [--tls-cert=PEM --tls-key=PEM [--tls-client-ca=PEM]]
                 [--member-tls-ca=PEM [--member-tls-cert=PEM
                  --member-tls-key=PEM]] [--member-token=TOKEN]
                 [--auth-tokens=FILE] [--rate-limit=N[/s][:burst]]
                 [--max-frame-bytes=N]
 pwasm-tpu route --standby-of=TARGET [--journal-dir=DIR]
                 [--poll-interval=S] [...primary flags inherited
                 on takeover, EXCEPT --backends/--socket/--listen]

   --backends=...       member serve daemons, comma-separated targets
                        (unix socket paths and/or HOST:PORT — required)
   --socket=PATH        unix socket to serve the fleet protocol on
   --listen=HOST:PORT   TCP endpoint to serve it on (port 0 = any)
   --journal-dir=DIR    where members journal (shared durable storage:
                        start each member with the same --journal-dir
                        so the router can read a dead member's journal
                        and fail its jobs over; without it only
                        same-host unix members — default
                        <socket>.journal — are recoverable)
   --max-queue=N        FLEET-WIDE per-client live-job quota
                        (default 64); past it a client's submit
                        answers queue_full on the router, no matter
                        which member it would have landed on
   --max-queue-total=N  fleet-wide live-job backstop (default 8x)
   --max-results=N      retired routed-job entries kept for id lookup
                        (default 4096, LRU by last access; results
                        themselves live on the members — an evicted
                        fleet id answers unknown_job)
   --poll-interval=S    member health/stats refresh period
                        (default 0.5; a live member is declared dead
                        only after 2 consecutive failed polls, or
                        instantly on a mid-request connection
                        failure)
   --standby-of=TARGET  run as the WARM STANDBY of the router serving
                        on unix socket TARGET: tail its write-ahead
                        journal, and when the primary stops answering
                        ping, take over its socket with the routed-job
                        table replayed (docs/FLEET.md).  Mutually
                        exclusive with --backends/--socket/--listen —
                        the standby inherits all three from the
                        primary's journal, never from flags
   --lease-ttl=S        epoch-lease TTL granted to members (default
                        15; heartbeated on every stats poll — keep it
                        well above 2x --poll-interval).  A member that
                        misses heartbeats for S seconds self-fences:
                        drains in-flight work to checkpoints and
                        refuses new frames until a fresh lease
   --scale-policy=FILE  SLO-driven member auto-scaling policy (JSON:
                        min/max members, spawn argv, cooldown,
                        hysteresis — docs/FLEET.md).  Queue-pressure/
                        burn-rate verdicts spawn `serve` members;
                        sustained calm drains the scaler's own
                        members back down
   --priority-lanes=A,B brownout tier order, highest first (mirror
                        the members' --priority-lanes): past the
                        queue-pressure SLO threshold the router sheds
                        admissions LOWEST tier first with a truthful
                        `overloaded` + retry_after_s — before any
                        member sees queue_full.  The top tier is
                        never shed (brownout, not blackout); without
                        this flag shedding is inert
   --quarantine-x=K     slow-member quarantine: a member whose
                        stats-poll latency EWMA sustains past K x the
                        fleet median (default 4, min 1, 0 = off) is
                        quarantined — no new placements, running jobs
                        finish, streams keep their member
   --quarantine-probation=N  consecutive clean polls before a
                        quarantined member takes placements again
                        (default 3)
   --stream-replay-bytes=N  per-stream replay window (default 4194304
                        = 4 MiB, 0 = off): un-acked stream records
                        buffered at the router so a member death
                        MID-STREAM re-drives them to a sibling
                        invisibly instead of answering re-open errors
   --result-cache=DIR   the members' SHARED result-cache dir
                        (docs/SERVICE.md; point members'
                        serve --result-cache at the same shared
                        storage, like --journal-dir): a submit whose
                        content key hits there is answered AT THE
                        ROUTER — no member, no queue, no device,
                        anywhere in the fleet.  On a miss the key
                        drives cache-AFFINITY placement: a member
                        whose `cache-probe` answers hit gets the job
   --result-cache-max-bytes=N  LRU-evict the router's cache dir past
                        N total bytes
   --metrics-textfile=PATH  node-exporter textfile of the fleet
                        families (pwasm_fleet_*, docs/OBSERVABILITY.md)
   --log-json=FILE      append NDJSON fleet events (member_down,
                        failover verdicts, placements)
   --trace-json=FILE    Chrome trace of the router's per-job spans
                        (route_submit / route_result_wait, stamped
                        with each job's trace_id) — `pwasm-tpu
                        trace-merge` joins it with the client's and
                        members' traces on one timeline
   --slo-rules=FILE|off JSON rules merged over the fleet default set
                        (member_down / failover_burst /
                        ledger_saturation — obs/catalog.py); the
                        router's `health` verb folds every member's
                        own verdict into ONE fleet verdict on top
                        ("off" disables the router's engine).
                        docs/OBSERVABILITY.md
   --tls-cert=PEM --tls-key=PEM  serve the router's TCP --listen
                        endpoint over TLS (1.2+; the unix socket stays
                        plaintext — filesystem permissions are its
                        auth).  Clients dial with --tls-ca
   --tls-client-ca=PEM  require mTLS client certificates signed by
                        this CA; the verified peer CN becomes the
                        connection's attested identity (`cn:<name>`),
                        ranking above client_token (docs/FLEET.md
                        Security model)
   --member-tls-ca=PEM  dial MEMBERS over TLS, verifying their server
                        certs against this CA (add --member-tls-cert/
                        --member-tls-key when members demand mTLS).
                        One config serves a mixed fleet: unix-socket
                        members ignore it
   --member-token=TOKEN client_token presented on every router→member
                        frame — required when members run
                        --auth-tokens (the stats poll carries the
                        lease grant, an admin-scope operation)
   --auth-tokens=FILE   scoped capability tokens (JSON, CRC-stamped,
                        hot-reloaded — docs/FLEET.md Security model).
                        Control verbs (drain/lease-grant/fence) demand
                        admin scope; unauthorized frames answer
                        `unauthorized` and touch no ledger state
   --rate-limit=N[/s][:burst]  per-client token-bucket in front of
                        fleet admission (edge rate limiting: a
                        refused submit reaches no member and writes
                        no journal) — refusals answer `overloaded`
                        with a truthful retry_after_s
   --max-frame-bytes=N  per-frame byte ceiling on the router edge
                        (default 8388608 = 8 MiB, mirroring the
                        members'); an oversized frame answers
                        frame_too_large on BOTH transports

 SIGTERM (or the `drain` command) latches admission shut; in-flight
 member jobs keep running and their results stay fetchable until the
 last routed job lands terminal, then the router exits 0.
"""


# consecutive health-poll failures before a live member is declared
# dead (the poll path is a timeout-prone 3s stats RPC; mid-request
# connection failures on the forwarding paths still count as instant
# evidence).  2 keeps real-death detection within ~2 poll ticks while
# absorbing a single slow poll.
_POLL_STRIKES = 2

# gray-failure defense tuning that is policy, not knob:
# consecutive outlier polls before quarantine (2 = detection within
# ~2-3 poll ticks, one slow poll absorbed), the absolute latency
# floor below which nobody is an outlier (a local-socket fleet whose
# polls all land under 50 ms has no gray failures worth reacting to),
# and the pressure-free SLO evaluations required before the brownout
# shed controller de-escalates one priority tier (hysteresis — shed
# state must not flap with each queue-depth sample).
_Q_STRIKES = 2
_Q_FLOOR_MS = 50.0
_SHED_CLEAN_EXITS = 3


class _Member:
    """One backend serve daemon as the router sees it."""

    def __init__(self, target: str, journal_dir: str | None):
        self.target = target
        self.name = target_name(target)
        self.journal_path = member_journal_path(target, journal_dir)
        self.alive = False          # until the first healthy poll
        self.ever_alive = False
        self.queue_depth = 0
        self.running = 0
        self.stats: dict | None = None
        self.jobs_routed = 0
        self.fail_streak = 0
        self.cache_enabled: bool | None = None   # last cache-probe's
        #   enabled verdict: False skips this member in future
        #   affinity probes (one RPC saved per submit per member)
        self.dispatched_since_poll = 0   # router placements the
        #   member's last stats reply cannot have observed yet — the
        #   placement pressure term (reset on every successful poll,
        #   so a long-running routed job is never double-counted
        #   against the depth the member itself reports)
        self.fenced = False         # member reports itself fenced
        #   (lost epoch lease): reachable, but refusing new work
        self.scaled = False         # spawned by the SLO scaler (the
        #   only members the scaler may also retire)
        self.proc = None            # the scaler's child handle
        # ---- gray-failure detection: a member that is
        # ALIVE but pathologically slow (half-dead disk, GC storms,
        # a lossy NIC) passes every liveness poll while dragging the
        # fleet p99 down.  The router EWMAs each member's stats-poll
        # round-trip and its reported queue pressure; a sustained
        # latency outlier vs the fleet MEDIAN is quarantined — no new
        # placements, existing jobs finish, streams keep their member
        # — and probation-exits after clean polls.
        self.lat_ewma_ms = 0.0      # stats-RPC round-trip EWMA
        self.depth_ewma = 0.0       # queued+running EWMA (queue-wait
        #                             proxy, shown in svc-stats/top)
        self.quarantined = False
        self.q_strikes = 0          # consecutive outlier polls
        self.q_clean = 0            # consecutive clean polls while
        #                             quarantined (probation counter)
        self.quarantines = 0        # times this member entered


class _FleetJob:
    """One routed job: fleet id, current placement, and — after a
    failover recovered its verdict from journal+spool — the cached
    terminal result the router serves itself."""

    __slots__ = ("fid", "client", "priority", "trace_id", "frame",
                 "member", "mjid", "gen", "stream", "sconn", "slock",
                 "terminal", "retired", "failovers", "submitted_s",
                 "accessed_s", "recovering", "epoch", "rbuf",
                 "rbytes", "ended", "deadline_ms", "submitted_mono",
                 "scatter")

    def __init__(self, fid: str, client: str, priority: str,
                 trace_id: str, frame: dict, member: str, mjid: str,
                 stream: bool = False):
        self.fid = fid
        self.client = client
        self.priority = priority
        self.trace_id = trace_id
        self.frame = frame          # the ORIGINAL submit fields (args/
        #   cwd/...) — what a failover re-admission replays
        self.member = member
        self.mjid = mjid
        self.gen = 0                # placement generation (bumped per
        #   failover so result-waiters re-aim their member connection)
        self.stream = stream
        self.sconn = None           # persistent member conn for
        #   stream-data frames (one per stream job)
        self.slock = threading.Lock()
        self.terminal: dict | None = None   # router-served verdict
        self.retired = False        # ledger slot released
        self.failovers = 0
        self.submitted_s = time.time()
        self.accessed_s = time.time()   # LRU clock for table eviction
        self.deadline_ms = None     # REMAINING end-to-end budget at
        #   router admission; submitted_mono anchors the
        #   decrement so a failover re-placement forwards only what
        #   is genuinely left of the client's budget
        self.submitted_mono = time.monotonic()
        self.recovering = False     # orphan-recovery once-latch
        self.epoch = 0              # fleet epoch the CURRENT placement
        #   was made under (fencing: a re-placement must carry an
        #   epoch >= every prior placement's — readmit_epoch_guard)
        self.rbuf: list | None = [] if stream else None   # the
        #   bounded mid-stream replay window: acked stream-data/end
        #   frames a failover re-drives to a sibling (None = overflow
        #   or --stream-replay-bytes=0 — replay degrades to the
        #   terminal preempted-resumable verdict)
        self.rbytes = 0
        self.ended = False          # stream-end already acked
        self.scatter = None         # fleet-wide m2m surveillance: when
        #   this stream job is a scattered --m2m-stream, the
        #   router-side partition/merge state (surveil/partition.py) —
        #   per-member sub-streams, record assignment, replay buffers,
        #   fragment paths


def fold_route_records(records: list[dict]) -> dict:
    """Fold a replayed router-WAL stream (``REC_ROUTE_*`` / epoch /
    members / scale records — service/journal.py vocabulary) into the
    state a restarted router or a promoting standby rebuilds:

    - ``jobs``: one ``{"admit", "place", "retire", "_ord"}`` row per
      fleet job id, last-write-wins per kind, admit order preserved
      (rows with no admit are dropped — a torn admit line means the
      client was never acked);
    - ``epoch``: the highest journaled fleet epoch;
    - ``members``: the LAST members snapshot's backend target list
      (None if no snapshot survived — the standby then has no
      backends to adopt and must refuse the takeover);
    - ``scaled``: scaler-owned members still alive at the crash
      (spawn records minus retire records), by target."""
    jobs: dict[str, dict] = {}
    epoch = 0
    members: list | None = None
    scaled: dict[str, dict] = {}
    for rec in records:
        kind = rec.get("rec")
        if kind == REC_EPOCH:
            e = rec.get("epoch")
            if isinstance(e, int) and e > epoch:
                epoch = e
            continue
        if kind == REC_MEMBERS:
            b = rec.get("backends")
            if isinstance(b, list) \
                    and all(isinstance(t, str) for t in b):
                members = b
            continue
        if kind == REC_SCALE:
            t = rec.get("target")
            if isinstance(t, str):
                if rec.get("action") == "spawn":
                    scaled[t] = rec
                else:
                    scaled.pop(t, None)
            continue
        fid = rec.get("job_id")
        if not isinstance(fid, str):
            continue
        if kind == REC_ROUTE_ADMIT:
            jobs.setdefault(fid, {"admit": rec, "place": None,
                                  "retire": None, "_ord": len(jobs)})
            continue
        row = jobs.get(fid)
        if row is None:
            continue
        if kind == REC_ROUTE_PLACE:
            row["place"] = rec
        elif kind == REC_ROUTE_RETIRE:
            row["retire"] = rec
    return {"jobs": jobs, "epoch": epoch, "members": members,
            "scaled": scaled}


class Router:
    """The fleet router.  ``serve()`` runs the accept + health loops;
    everything else is the per-connection protocol dispatch."""

    def __init__(self, backends: list[str],
                 socket_path: str | None = None,
                 listen: str | None = None,
                 journal_dir: str | None = None,
                 max_queue: int = 64,
                 max_queue_total: int | None = None,
                 poll_interval: float = 0.5,
                 max_results: int = 4096,
                 stderr=None, metrics_textfile: str | None = None,
                 log_json: str | None = None,
                 trace_json: str | None = None,
                 slo_rules=None,
                 result_cache: str | None = None,
                 result_cache_max_bytes: int | None = None,
                 lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
                 scale_policy: dict | None = None,
                 stream_replay_bytes: int = 4 << 20,
                 takeover: bool = False,
                 priority_lanes: tuple | list | None = None,
                 quarantine_x: float = 4.0,
                 quarantine_probation: int = 3,
                 max_frame_bytes: int = protocol.MAX_FRAME_BYTES,
                 tls=None, member_tls=None,
                 member_token: str | None = None,
                 auth_tokens: str | None = None,
                 rate_limit: tuple | None = None):
        if not backends:
            raise ValueError("route needs at least one backend")
        if not socket_path and not listen:
            raise ValueError("route needs --socket and/or --listen")
        self.socket_path = socket_path
        self.listen = listen
        self.journal_dir = journal_dir
        self.lease_ttl_s = max(0.1, float(lease_ttl_s))
        self.stream_replay_bytes = max(0, int(stream_replay_bytes))
        self.takeover = bool(takeover)
        self.epoch = 0               # fleet epoch (fencing token);
        #   _open_journal replays the highest journaled epoch and
        #   bumps it — every router incarnation is a new era
        self.tcp_port: int | None = None    # actual port after bind
        self.stderr = stderr if stderr is not None else sys.stderr
        self.poll_interval = max(0.05, float(poll_interval))
        self.members: dict[str, _Member] = {}
        for t in backends:
            m = _Member(t, journal_dir)
            if m.name in self.members:
                raise ValueError(
                    f"two backends map to member name {m.name!r} "
                    f"({self.members[m.name].target!r} and {t!r}) — "
                    "give them distinct basenames/ports")
            self.members[m.name] = m
        self.ledger = FleetLedger(max_queue, max_queue_total)
        self.max_results = max(1, int(max_results))
        self.jobs: dict[str, _FleetJob] = {}
        self._clients_seen: set[str] = set()   # label universe for
        #   the per-client gauge (a retired client reads 0, not gone)
        self.drain = SignalDrain(stderr=self.stderr)
        self._lock = threading.Lock()
        self._draining = False
        self._closing = threading.Event()
        self._next_id = 0
        self._rr = 0                 # placement tie-breaker
        self._t0 = time.monotonic()  # uptime anchor — monotonic, a
        #   wall-clock step must not warp uptime_s
        # ---- gray-failure defense: slow-member
        # quarantine tuning + the brownout shed controller.
        # priority_lanes mirrors the members' --priority-lanes tier
        # order (highest first); shedding turns the LOWEST tier away
        # first and the top tier is never shed — a brownout, not a
        # blackout.  quarantine_x = the outlier multiple over the
        # fleet-median poll round-trip EWMA (0 disables);
        # quarantine_probation = clean polls before a quarantined
        # member takes placements again.
        self.priority_lanes = tuple(priority_lanes or ())
        self.quarantine_x = float(quarantine_x)
        self.quarantine_probation = max(1, int(quarantine_probation))
        self._shed_level = 0         # how many tiers (from the
        #   bottom) are currently turned away
        self._shed_clean = 0         # consecutive pressure-free SLO
        #   evaluations (hysteresis: de-escalate one tier per
        #   _SHED_CLEAN_EXITS clean evals, never flap per-tick)
        self._shed_last = 0.0        # the controller's own cadence
        #   anchor — slo._last_eval is reset by stats-verb
        #   evaluations too, so it cannot pace the shed loop
        self.failovers = 0           # member-death events handled
        self.recovered = {"resumed": 0, "requeued": 0, "restored": 0,
                          "cancelled": 0, "stream_preempted": 0,
                          "stream_replayed": 0, "failed": 0,
                          "deadline_exceeded": 0}
        # ---- router write-ahead journal: every routed
        # admission/placement/retirement + epoch bumps + member-set
        # snapshots, fsync'd per batch through the same JobJournal the
        # members use.  None = journal-less (TCP-only endpoint with
        # no --journal-dir): today's RAM-only behaviour, said loudly.
        jpath = router_journal_path(socket_path, listen, journal_dir)
        self.rjournal = JobJournal(jpath) if jpath else None
        self._rjournal_warned = False
        from pwasm_tpu_torch.obs import (EventLog, MetricsRegistry,
                                   Observability, TraceRecorder)
        from pwasm_tpu_torch.obs.catalog import build_fleet_metrics
        self.registry = MetricsRegistry()
        self.metrics = build_fleet_metrics(self.registry)
        self.metrics["members"].set(len(self.members))
        self.metrics_textfile = metrics_textfile
        events = EventLog(path=log_json) if log_json else None
        tracer = TraceRecorder() if trace_json else None
        self.obs = Observability(registry=self.registry,
                                 events=events, tracer=tracer,
                                 trace_path=trace_json)
        self.drain.obs = self.obs
        self.log_json_path = log_json   # the `logs` verb reads it
        # ---- fleet self-monitoring: the router's own SLO
        # engine over the pwasm_fleet_* families (member_down,
        # failover_burst, ledger_saturation by default; user rules
        # merge by name), plus the member-verdict aggregation the
        # `health` verb performs on demand
        from pwasm_tpu_torch.obs.catalog import (build_slo_metrics,
                                           default_fleet_slo_rules)
        from pwasm_tpu_torch.obs.slo import SloEngine, merge_rules
        self.metrics["max_jobs"].set(self.ledger.max_total)
        self.slo_metrics = build_slo_metrics(self.registry)
        if slo_rules == "off":
            rules = []
        else:
            rules = merge_rules(default_fleet_slo_rules(), slo_rules)
        self.slo = SloEngine(self.registry, rules,
                             metrics=self.slo_metrics,
                             on_event=self.obs.event,
                             eval_interval_s=min(
                                 1.0, self.poll_interval))
        # ---- fleet result cache: `route --result-cache`
        # points at the MEMBERS' shared cache dir (the --journal-dir
        # placement idea — shared durable storage).  A submit whose
        # key hits there is answered AT THE ROUTER: no member, no
        # queue, no device, anywhere.  On a miss the computed key is
        # also used for cache-AFFINITY placement: a member answering
        # the `cache-probe` verb hit=true gets the job (its own
        # admission then serves it from its private cache), so a job
        # already answered by ANY member never re-runs.
        from pwasm_tpu_torch.obs.catalog import build_cache_metrics
        self.cache_metrics = build_cache_metrics(self.registry)
        self.cache = None
        if result_cache and result_cache != "off":
            from pwasm_tpu_torch.service.cache import CacheStore
            try:
                self.cache = CacheStore(
                    result_cache, max_bytes=result_cache_max_bytes,
                    metrics=self.cache_metrics)
            except OSError as e:
                self._say(f"warning: --result-cache dir "
                          f"{result_cache} unusable ({e}); fleet "
                          "result caching disabled")
        # ---- SLO-driven member auto-scaling: the scaler turns the
        # engine's queue-pressure/burn-rate verdicts into spawn/retire
        # actions inside [min,max] bounds, journaled so a restarted
        # router re-adopts the members it owns
        self.scaler = None
        if scale_policy:
            from pwasm_tpu_torch.fleet.scaler import FleetScaler
            self.scaler = FleetScaler(self, scale_policy)
        # ---- zero-trust edge, mirroring the serve daemon:
        # TLS on the router's own TCP listener, ClientTLS + capability
        # token for every router->member dial (the _dial factory), a
        # scoped-token gate on the edge, and the edge rate limiter.
        # All opt-in.
        self.max_frame_bytes = int(max_frame_bytes)
        self.tls = tls                     # transport.ServerTLS | None
        self.member_tls = member_tls       # transport.ClientTLS | None
        self.member_token = member_token
        from pwasm_tpu_torch.obs.catalog import build_transport_metrics
        self.transport_metrics = build_transport_metrics(self.registry)
        self.auth = None
        self._penalty = None
        if auth_tokens:
            from pwasm_tpu_torch.service.authz import (AuthRegistry,
                                                 PenaltyBox)
            self.auth = AuthRegistry(auth_tokens, say=self._say)
            self._penalty = PenaltyBox()
        self._auth_labels: set = set()
        self.rate_limiter = None
        if rate_limit is not None:
            from pwasm_tpu_torch.service.queue import RateLimiter
            self.rate_limiter = RateLimiter(rate_limit[0],
                                            rate_limit[1])

    # ---- lifecycle -----------------------------------------------------
    def serve(self) -> int:
        import selectors
        listeners: list[socket.socket] = []
        try:
            if self.socket_path:
                from pwasm_tpu_torch.fleet.transport import (
                    make_unix_listener, socket_alive)
                if os.path.exists(self.socket_path) \
                        and socket_alive(self.socket_path):
                    raise PwasmError(
                        f"Error: something is already serving on "
                        f"{self.socket_path}\n")
                # the factory chmods the socket 0600:
                # local clients are the serving uid; TCP is the
                # opt-in wider audience, with TLS/auth as its gate
                listeners.append(make_unix_listener(self.socket_path))
            if self.listen:
                t = make_tcp_listener(self.listen)
                self.tcp_port = t.getsockname()[1]
                listeners.append(t)
        except OSError as e:
            for s in listeners:
                s.close()
            raise PwasmError(
                f"Error: cannot bind router endpoint: {e}\n")
        sel = selectors.DefaultSelector()
        for s in listeners:
            s.setblocking(False)
            sel.register(s, selectors.EVENT_READ)
        self._open_journal()         # replay + epoch bump BEFORE the
        #   first poll — the first heartbeat must carry the new era
        if self.takeover:
            self.metrics["takeovers"].inc()
            self.obs.event("standby_takeover", epoch=self.epoch,
                           socket=self.socket_path)
        self._poll_members()         # first placement view up front
        health = threading.Thread(target=self._health_loop,
                                  daemon=True,
                                  name="pwasm-route-health")
        with self.drain:
            health.start()
            where = " + ".join(
                ([self.socket_path] if self.socket_path else [])
                + ([f"{self.listen.rsplit(':', 1)[0]}:"
                    f"{self.tcp_port}"] if self.listen else []))
            self._say(f"routing {len(self.members)} member(s) on "
                      f"{where}")
            self.obs.event("router_start", members=len(self.members),
                           backends=[m.target for m in
                                     self.members.values()])
            self._write_textfile()
            drained_at = None
            try:
                while True:
                    if self.auth is not None:
                        # token rotation without a restart (same
                        # keep-last-good reload as the members)
                        self.auth.maybe_reload()
                    if self.drain.requested:
                        self._begin_drain(self.drain.reason
                                          or "drain requested")
                        if self._drained():
                            if drained_at is None:
                                drained_at = time.monotonic()
                            elif time.monotonic() - drained_at > 0.5:
                                break
                    try:
                        events = sel.select(0.2)
                    except OSError:
                        break
                    for key, _ in events:
                        try:
                            conn, _addr = key.fileobj.accept()
                        except OSError:
                            continue
                        conn.setblocking(True)
                        threading.Thread(target=self._handle_conn,
                                         args=(conn,),
                                         daemon=True).start()
            finally:
                self._closing.set()
                sel.close()
                for s in listeners:
                    s.close()
                with self._lock:
                    sconns = [j.sconn for j in self.jobs.values()
                              if j.sconn is not None]
                for sc in sconns:
                    sc.close()
                if self.socket_path:
                    try:
                        os.unlink(self.socket_path)
                    except OSError:
                        pass
        if self.scaler is not None:
            self.scaler.shutdown()
        if self.rjournal is not None:
            if self.drain.requested and self._drained():
                # clean drain: every routed job landed terminal and
                # every client could read it — nothing to recover
                self.rjournal.unlink()
            else:
                self.rjournal.close()
        self.obs.event("router_exit", drained=self.drain.requested)
        self._write_textfile()
        if self.obs.tracer is not None and self.obs.trace_path:
            try:
                self.obs.tracer.write(self.obs.trace_path)
                self._say(f"trace written to {self.obs.trace_path}")
            except OSError as e:
                self._say(f"warning: cannot write --trace-json "
                          f"{self.obs.trace_path}: {e}")
        if self.obs.events is not None:
            self.obs.events.close()
        if self.drain.requested:
            self._say("drained — every routed job landed terminal; "
                      "members keep serving")
        return 0

    def _say(self, msg: str) -> None:
        print(f"pwasm-route: {msg}", file=self.stderr)

    def _drained(self) -> bool:
        with self._lock:
            return self._draining and all(
                j.retired or j.terminal is not None
                for j in self.jobs.values())

    def _begin_drain(self, reason: str) -> None:
        with self._lock:
            if self._draining:
                return
            self._draining = True
            live = sum(1 for j in self.jobs.values()
                       if not j.retired and j.terminal is None)
        self.obs.event("router_drain", reason=reason, live=live)
        self._say(f"draining ({reason}): {live} routed job(s) still "
                  "live on members; results stay fetchable, new "
                  "submissions rejected")

    # ---- write-ahead journal -------------------------------------------
    def _journal(self, rows: list) -> None:
        """Durably append ``[(rec, fields), ...]`` in one fsync;
        degrades loudly (warn once, keep routing) like the member
        journal — a full disk costs the HA guarantee, not the fleet."""
        if self.rjournal is None:
            return
        now = round(time.time(), 3)
        stamped = [(rec, dict(fields, t=now)) for rec, fields in rows]
        if self.rjournal.append_many(stamped):
            for rec, _f in rows:
                self.metrics["journal_records"].inc(rec=rec)
        elif self.rjournal.broken and not self._rjournal_warned:
            self._rjournal_warned = True
            self._say("warning: router journal append failed "
                      f"({self.rjournal.broken}); continuing WITHOUT "
                      "crash-safe routing — a router crash now loses "
                      "the routed-job table")

    def _open_journal(self) -> None:
        """Open (and replay) the router WAL.  Replay rebuilds the
        routed-job table — live placements re-enter the ledger without
        re-running the quota gate (their admissions were acked),
        journaled terminal verdicts are served from the router again —
        then the epoch is bumped: every incarnation is a new era, so
        members leased to the dead incarnation re-lease or fence."""
        if self.rjournal is None:
            self._say("warning: no durable journal path for this "
                      "endpoint (TCP-only, no --journal-dir): routing "
                      "is NOT crash-safe and no standby can follow")
            return
        records = self.rjournal.replay()
        self.rjournal.open()
        folded = fold_route_records(records) if records else None
        replayed = 0
        if folded is not None:
            replayed = self._replay_state(folded)
            self.epoch = max(self.epoch, folded["epoch"])
        self.epoch += 1
        self._compact_journal()
        self.metrics["epoch"].set(self.epoch)
        if replayed:
            self.metrics["journal_replayed"].inc(replayed)
            self.obs.event("router_journal_replay", jobs=replayed,
                           epoch=self.epoch)
            self._say(f"replayed {replayed} routed job(s) from "
                      f"{self.rjournal.path} (fleet epoch now "
                      f"{self.epoch})")

    def _replay_state(self, folded: dict) -> int:
        """Rebuild the routed-job table from a fold; returns how many
        jobs were restored (live + terminal)."""
        backends = folded.get("members")
        if backends:
            for t in backends:
                self._add_member(t)
        for t in folded.get("scaled", {}):
            self._add_member(t, scaled=True)
        restored = 0
        rows = sorted(folded["jobs"].items(),
                      key=lambda kv: kv[1]["_ord"])
        for fid, row in rows:
            try:
                n = int(fid.rsplit("-", 1)[-1])
            except ValueError:
                n = 0
            self._next_id = max(self._next_id, n)
            admit = row["admit"]
            place = row["place"]
            retire = row["retire"]
            frame = admit.get("frame")
            if not isinstance(frame, dict):
                continue
            stream = bool(admit.get("stream"))
            job = _FleetJob(fid, str(admit.get("client") or ""),
                            str(admit.get("priority") or ""),
                            str(admit.get("trace_id") or ""),
                            frame,
                            str((place or {}).get("member")
                                or "cache"),
                            str((place or {}).get("mjid") or ""),
                            stream=stream)
            if place is not None:
                job.gen = int(place.get("gen") or 0)
                job.epoch = int(place.get("epoch") or 0)
            if stream:
                # the replay window died with the old process and the
                # stream socket died with the client's connection —
                # a live stream cannot survive a ROUTER death, only a
                # member death.  Land it the way a member restart
                # would: terminal preempted-resumable.
                job.rbuf = None
            sub = admit.get("t")
            if isinstance(sub, (int, float)):
                job.submitted_s = float(sub)
            self.jobs[fid] = job
            restored += 1
            if retire is not None:
                job.retired = True
                state = retire.get("state")
                if state in TERMINAL_STATES:
                    rc = retire.get("rc") \
                        if isinstance(retire.get("rc"), int) else None
                    job.terminal = protocol.ok(
                        job={"id": fid, "state": state, "rc": rc,
                             "detail": str(retire.get("detail")
                                           or "")
                             + " [replayed from the router journal]",
                             "client": job.client,
                             "priority": job.priority,
                             "trace_id": job.trace_id,
                             "stream": stream, "recovered": True,
                             "member": job.member,
                             "submitted_s": round(job.submitted_s, 3),
                             "started_s": None,
                             "finished_s": retire.get("t")},
                        rc=rc, stats=None, stderr_tail="")
                continue
            if stream:
                job.recovering = True   # hold the health loop off
                self._cache_terminal(job, JOB_PREEMPTED, 75, (
                    "stream interrupted: the fleet router restarted "
                    "and the stream connection died with it; records "
                    "up to the last checkpoint are durable — re-open "
                    "a stream with --resume and re-send the records"))
                job.recovering = False
                self.recovered["stream_preempted"] += 1
                self.metrics["recovered"].inc(how="stream_preempted")
                continue
            if place is None or job.member == "cache":
                # admitted but never placed (crash in the gap): the
                # admission was never acked either — the ack and the
                # place record commit together — so drop it
                job.retired = True
                continue
            # live placement: re-enter the ledger WITHOUT the quota
            # gate (the admission promise predates this incarnation)
            self.ledger.restore(job.client, job.member)
        return restored

    def _compact_journal(self) -> None:
        """Atomically rewrite the WAL to current state: one members
        snapshot, the current epoch, the scaler's live spawns, then
        admit(+place)(+retire) per surviving job — restart cost stays
        bounded by the table, not router-lifetime traffic."""
        if self.rjournal is None:
            return
        now = round(time.time(), 3)

        def raw(rec: str, **fields) -> dict:
            obj = {"v": JOURNAL_VERSION, "rec": rec, "t": now}
            obj.update(fields)
            return obj

        with self._lock:
            backends = [m.target for m in self.members.values()
                        if not m.scaled]
            scaled = [(m.target, getattr(m.proc, "pid", None))
                      for m in self.members.values() if m.scaled]
            jobs = sorted(self.jobs.values(),
                          key=lambda j: j.submitted_s)
            rows = [raw(REC_MEMBERS, backends=backends),
                    raw(REC_EPOCH, epoch=self.epoch)]
            for target, pid in scaled:
                rows.append(raw(REC_SCALE, action="spawn",
                                target=target, pid=pid))
            for j in jobs:
                rows.append(raw(
                    REC_ROUTE_ADMIT, job_id=j.fid, client=j.client,
                    priority=j.priority, trace_id=j.trace_id,
                    stream=j.stream, frame=j.frame,
                    t=round(j.submitted_s, 3)))
                if j.member != "cache":
                    rows.append(raw(
                        REC_ROUTE_PLACE, job_id=j.fid,
                        member=j.member, mjid=j.mjid, gen=j.gen,
                        epoch=j.epoch))
                if j.retired or j.terminal is not None:
                    f = {}
                    if isinstance(j.terminal, dict) \
                            and isinstance(j.terminal.get("job"),
                                           dict):
                        tj = j.terminal["job"]
                        f = {"state": tj.get("state"),
                             "rc": tj.get("rc"),
                             "detail": tj.get("detail")}
                    rows.append(raw(REC_ROUTE_RETIRE, job_id=j.fid,
                                    **f))
        try:
            self.rjournal.compact(rows)
        except OSError as e:
            if not self._rjournal_warned:
                self._rjournal_warned = True
                self._say(f"warning: router journal compaction "
                          f"failed ({e}); continuing on the old file")

    # ---- member-set mutation (takeover adoption + scaler) --------------
    def _add_member(self, target: str, scaled: bool = False):
        """Idempotently add a backend (journal-replay adoption or a
        scaler spawn).  Returns the member."""
        with self._lock:
            name = target_name(target)
            m = self.members.get(name)
            if m is None:
                m = _Member(target, self.journal_dir)
                m.scaled = scaled
                self.members[name] = m
                n = len(self.members)
            else:
                n = None
        if n is not None:
            self.metrics["members"].set(n)
        return m

    def _remove_member(self, name: str) -> None:
        """Forget a member (scaler retire): MUST run before the drain
        RPC so its planned exit never reads as a death to fail over."""
        with self._lock:
            self.members.pop(name, None)
            n = len(self.members)
        self.metrics["members"].set(n)
        self.metrics["member_up"].set(0, member=name)

    # ---- member health + placement -------------------------------------
    def _health_loop(self) -> None:
        while not self._closing.wait(self.poll_interval):
            self._poll_members(count_failures=True)
            self._reap_finished()
            self._evict_jobs()
            if self.slo.due():
                self.slo.evaluate()   # gauges fresh from the poll
            self._shed_tick()   # every tick, self-paced: due() can
            #   stay false forever under a fast stats-poll loop (the
            #   stats verb evaluates directly), and the brownout must
            #   not be starved by the operator watching the fleet
            if self.scaler is not None:
                self.scaler.tick()
            if self.rjournal is not None \
                    and self.rjournal.records_written > max(
                        1024, 8 * (len(self.jobs) + 1)):
                # the WAL grew well past live state: fold it back down
                self._compact_journal()
            self._write_textfile()

    def _poll_members(self, count_failures: bool = False) -> None:
        """Refresh every member's liveness + load.  Only the health
        loop passes ``count_failures=True``: it is single-threaded, so
        ``fail_streak`` really counts CONSECUTIVE health ticks — a
        stats request's synchronous refresh racing the loop must not
        double-count one member stall into two strikes and fail over
        a live member (the double-run corruption failover exists to
        prevent)."""
        for m in list(self.members.values()):
            t_rpc = time.monotonic()
            try:
                with self._dial(m.target, timeout=3.0) as c:
                    # the epoch lease rides the stats poll: every
                    # healthy tick IS the heartbeat, so fencing needs
                    # no extra RPC round and no extra timer
                    st = c.request({
                        "cmd": "stats",
                        **({"lease": {"epoch": self.epoch,
                                      "ttl_s": self.lease_ttl_s}}
                           if self.epoch >= 1 else {})})
                if not st.get("ok"):
                    raise ServiceError(f"stats failed: {st}")
                lat_ms = (time.monotonic() - t_rpc) * 1000.0
                stats = st["stats"]
                lease = stats.get("lease")
                lease = lease if isinstance(lease, dict) else {}
                with self._lock:
                    revived = not m.alive and m.ever_alive
                    m.alive = True
                    m.ever_alive = True
                    m.fail_streak = 0
                    m.stats = stats
                    m.queue_depth = int(stats.get("queue_depth") or 0)
                    m.running = int(stats.get("running") or 0)
                    # this reply has observed everything we placed
                    # before the RPC — stop counting it as pressure
                    m.dispatched_since_poll = 0
                    m.fenced = bool(lease.get("fenced"))
                    # gray-failure EWMAs: round-trip
                    # latency + queue pressure, ~alpha 0.3 so one
                    # stall neither dominates nor hides.  Only
                    # SUCCESSFUL polls feed them — a refused connect
                    # is death evidence (fail_streak), not latency.
                    m.lat_ewma_ms = lat_ms if m.lat_ewma_ms <= 0.0 \
                        else 0.3 * lat_ms + 0.7 * m.lat_ewma_ms
                    m.depth_ewma = (0.3 * (m.queue_depth + m.running)
                                    + 0.7 * m.depth_ewma)
                if lease.get("accepted") is False:
                    # the member holds a NEWER epoch than ours: WE are
                    # the stale incarnation (a zombie primary racing
                    # its own standby's takeover) — say so loudly
                    self.obs.event(
                        "lease_refused", member=m.name,
                        member_epoch=lease.get("epoch"),
                        epoch=self.epoch,
                        detail=str(lease.get("refused_detail") or ""))
                if revived:
                    self.obs.event("member_up", member=m.name)
                    self._say(f"member {m.name} is back")
            except (ServiceError, OSError, ValueError, TypeError,
                    KeyError):
                if not count_failures:
                    continue
                down = False
                with self._lock:
                    m.fail_streak += 1
                    # a never-seen member just hasn't started yet.  A
                    # known-alive member is declared dead only after
                    # _POLL_STRIKES CONSECUTIVE poll failures: one
                    # missed 3s stats RPC can be a load spike or a
                    # long compile.  (A genuinely dead daemon refuses
                    # the connect instantly, so real death still
                    # resolves within ~2 poll ticks.)
                    if m.alive and m.fail_streak >= _POLL_STRIKES:
                        down = True
                if down:
                    self._member_down(m.name)
        if count_failures:
            # quarantine transitions only on the single-threaded
            # health tick — a synchronous stats refresh racing the
            # loop must not double-count one outlier poll into two
            # strikes (the fail_streak rule, same reason)
            self._quarantine_scan()
        self._refresh_gauges()

    def _quarantine_scan(self) -> None:
        """Slow-member quarantine: after each health tick,
        compare every live member's poll-latency EWMA against the
        fleet MEDIAN.  A member sustained past ``quarantine_x`` times
        the median (with an absolute floor so microsecond-fast local
        fleets don't quarantine noise) for ``_Q_STRIKES`` consecutive
        polls is quarantined: no NEW placements, running jobs finish,
        streams keep their member.  It probation-exits after
        ``quarantine_probation`` consecutive clean polls.  The fleet
        is never wedged: a member is only quarantined while at least
        2 eligible members remain, and placement falls back to
        quarantined members when nothing else is alive."""
        if self.quarantine_x <= 0:
            return
        entered: list[tuple[str, float, float]] = []
        exited: list[tuple[str, float, float]] = []
        with self._lock:
            sampled = [m for m in self.members.values()
                       if m.alive and m.lat_ewma_ms > 0.0]
            if len(sampled) < 2:
                return      # a median of one member is the member
            lats = sorted(m.lat_ewma_ms for m in sampled)
            median = lats[len(lats) // 2]
            cut = max(self.quarantine_x * median, _Q_FLOOR_MS)
            eligible = sum(1 for m in sampled
                           if not m.fenced and not m.quarantined)
            for m in sampled:
                if m.lat_ewma_ms > cut:
                    m.q_strikes += 1
                    m.q_clean = 0
                    if (not m.quarantined
                            and m.q_strikes >= _Q_STRIKES
                            and eligible >= 2):
                        m.quarantined = True
                        m.quarantines += 1
                        eligible -= 1
                        entered.append((m.name, m.lat_ewma_ms,
                                        median))
                else:
                    m.q_strikes = 0
                    if m.quarantined:
                        m.q_clean += 1
                        if m.q_clean >= self.quarantine_probation:
                            m.quarantined = False
                            m.q_clean = 0
                            exited.append((m.name, m.lat_ewma_ms,
                                           median))
        for name, lat, med in entered:
            self.metrics["quarantines"].inc()
            self.obs.event("member_quarantined", member=name,
                           lat_ewma_ms=round(lat, 2),
                           fleet_median_ms=round(med, 2))
            self._say(f"member {name} QUARANTINED: poll latency "
                      f"{lat:.0f} ms vs fleet median {med:.0f} ms — "
                      "no new placements until it recovers")
        for name, lat, med in exited:
            self.obs.event("member_recovered", member=name,
                           lat_ewma_ms=round(lat, 2),
                           fleet_median_ms=round(med, 2))
            self._say(f"member {name} left quarantine "
                      f"({self.quarantine_probation} clean polls)")

    def _refresh_gauges(self) -> None:
        with self._lock:
            rows = [(m.name, m.alive, m.queue_depth + m.running,
                     m.lat_ewma_ms, m.quarantined)
                    for m in self.members.values()]
            live = sum(1 for j in self.jobs.values()
                       if not j.retired and j.terminal is None)
            fenced = sum(1 for m in self.members.values()
                         if m.alive and m.fenced)
            scaled = sum(1 for m in self.members.values()
                         if m.alive and m.scaled)
            shed_level = self._shed_level
        for name, alive, depth, lat, quar in rows:
            self.metrics["member_up"].set(1 if alive else 0,
                                          member=name)
            self.metrics["member_queue_depth"].set(depth, member=name)
            self.metrics["member_latency_ewma"].set(round(lat, 2),
                                                    member=name)
            self.metrics["member_quarantined"].set(
                1 if (alive and quar) else 0, member=name)
        self.metrics["shedding"].set(shed_level)
        self.metrics["live_jobs"].set(live)
        self.metrics["epoch"].set(self.epoch)
        self.metrics["fenced_members"].set(fenced)
        self.metrics["scaler_members"].set(scaled)
        depths = self.ledger.client_depths()
        with self._lock:
            self._clients_seen |= set(depths)
            if len(self._clients_seen) > 1024:
                # identities are client-minted on TCP (tok:...): cap
                # the label universe or a token-cycling client grows
                # router memory and the textfile forever.  Retired
                # (zero-depth) series are dropped oldest-set-first;
                # live clients always keep theirs.
                for c in list(self._clients_seen):
                    if c not in depths:
                        self._clients_seen.discard(c)
                    if len(self._clients_seen) <= 1024:
                        break
            clients = set(self._clients_seen)
        for c in clients:
            # every client ever routed keeps a series (bounded
            # above): a fully retired client must read 0, not freeze
            # at its last nonzero sample (the daemon's gauge rule)
            self.metrics["client_jobs"].set(depths.get(c, 0),
                                            client=c or "default")

    def _write_textfile(self) -> None:
        if not self.metrics_textfile:
            return
        try:
            self.registry.write_textfile(self.metrics_textfile)
        except OSError as e:
            self._say(f"warning: cannot write --metrics-textfile "
                      f"{self.metrics_textfile}: {e}")

    def _reap_finished(self) -> None:
        """Release ledger slots of jobs that finished on their member
        even if no client ever fetched the result — a quota must track
        LIVE work, not politeness."""
        with self._lock:
            pending = [j for j in self.jobs.values() if not j.retired]
        by_member: dict[str, list[_FleetJob]] = {}
        for j in pending:
            if j.terminal is not None:
                self._note_retired(j)   # router-cached verdict
            elif j.scatter is None:
                # scattered jobs are excluded: j.mjid is only sub 0 —
                # a terminal sub 0 does NOT mean the fleet-wide job is
                # done (the merge in _scatter_result decides that)
                by_member.setdefault(j.member, []).append(j)
        for name, jobs in by_member.items():
            with self._lock:
                m = self.members.get(name)
                if m is None or not m.alive:
                    continue
            try:
                with self._dial(m.target, timeout=3.0) as c:
                    for j in jobs:
                        st = c.status(j.mjid)
                        if st.get("ok") and st["job"]["state"] \
                                in TERMINAL_STATES:
                            self._note_retired(j)
            except (ServiceError, OSError, KeyError, TypeError):
                continue

    def _note_retired(self, job: _FleetJob) -> None:
        with self._lock:
            if job.retired:
                return
            job.retired = True
            sconn, job.sconn = job.sconn, None
            term = job.terminal
        if sconn is not None:
            # a terminal stream job's persistent member connection
            # would otherwise leak one fd here and one blocked handler
            # thread on the member for the router's whole life
            sconn.close()
        if job.scatter is not None:
            for row in job.scatter["subs"]:
                row["live"] = False
                try:
                    row["conn"].close()
                except Exception:
                    pass
        self.ledger.retire(job.client, job.member)
        fields: dict = {"job_id": job.fid}
        if isinstance(term, dict) and isinstance(term.get("job"),
                                                 dict):
            tj = term["job"]
            fields.update(state=tj.get("state"), rc=tj.get("rc"),
                          detail=tj.get("detail"))
        self._journal([(REC_ROUTE_RETIRE, fields)])

    def _evict_jobs(self) -> None:
        """Bound the routed-job table: RETIRED jobs past
        ``max_results`` are dropped least-recently-accessed first
        (their results live on the members; an evicted fleet id
        answers unknown_job, same contract as daemon eviction).  Live
        jobs are never candidates — the ledger and failover need
        them."""
        with self._lock:
            retired = [j for j in self.jobs.values() if j.retired]
            excess = len(retired) - self.max_results
            if excess <= 0:
                return
            retired.sort(key=lambda j: j.accessed_s)
            for j in retired[:excess]:
                self.jobs.pop(j.fid, None)

    # ---- brownout shedding ---------------------------------------------
    def _shed_tick(self) -> None:
        """Overload controller, run every health tick on its OWN
        cadence (``self.slo.eval_interval_s``), not gated on
        ``slo.due()``: the stats verb evaluates the engine directly,
        so a client polling stats faster than the eval interval would
        keep ``due()`` false forever and starve this controller — the
        operator watching the fleet would be the very thing stopping
        it from shedding.  While a queue-pressure rule
        (``fleet_queue_pressure`` or ``ledger_saturation``) is
        firing, escalate the shed level one priority tier per tick —
        lowest tier first, the top tier never — and de-escalate one
        tier only after ``_SHED_CLEAN_EXITS`` consecutive clean ticks
        (hysteresis).  Inert without ``--priority-lanes``: with one
        implicit tier there is nothing to brown out that plain
        queue_full doesn't already say."""
        max_level = max(0, len(self.priority_lanes) - 1)
        if max_level == 0:
            return
        now = time.monotonic()
        if now - self._shed_last < self.slo.eval_interval_s:
            return
        self._shed_last = now
        pressure = any(f.get("rule") in ("fleet_queue_pressure",
                                         "ledger_saturation")
                       for f in self.slo.firing())
        level = self._shed_level
        if pressure:
            self._shed_clean = 0
            if level < max_level:
                self._shed_level = level + 1
        elif level > 0:
            self._shed_clean += 1
            if self._shed_clean >= _SHED_CLEAN_EXITS:
                self._shed_clean = 0
                self._shed_level = level - 1
        if self._shed_level == level:
            return
        shed_lanes = list(
            self.priority_lanes[len(self.priority_lanes)
                                - self._shed_level:])
        self.metrics["shedding"].set(self._shed_level)
        self.obs.event("fleet_shed_level", level=self._shed_level,
                       was=level, lanes=shed_lanes)
        self._journal([(REC_ROUTE_SHED,
                        {"level": self._shed_level, "was": level,
                         "lanes": shed_lanes})])
        if self._shed_level > level:
            self._say(f"OVERLOADED: shedding priority tier(s) "
                      f"{','.join(shed_lanes) or '-'} "
                      f"(level {self._shed_level}/{max_level}) until "
                      "queue pressure clears")
        else:
            self._say(f"shed level down to {self._shed_level}"
                      f"/{max_level}"
                      + (f" (still shedding "
                         f"{','.join(shed_lanes)})" if shed_lanes
                         else " — admitting every tier again"))

    def _shed_check(self, priority) -> dict | None:
        """The admission-time half: a submit in one of the currently
        shed tiers is turned away with a truthful ``overloaded`` +
        ``retry_after_s`` BEFORE any member sees it.  None = admit."""
        level = self._shed_level
        if level <= 0 or not self.priority_lanes:
            return None
        lanes = self.priority_lanes      # highest tier first
        lane = str(priority or "") or lanes[-1]
        try:
            rank = lanes.index(lane)
        except ValueError:
            rank = len(lanes) - 1   # a lane no member configured
            #   carries no priority claim here — lowest tier
        if rank < len(lanes) - level:
            return None
        self.metrics["jobs"].inc(outcome="rejected")
        self.metrics["shed"].inc(lane=lane or "default")
        return protocol.err(
            protocol.ERR_OVERLOADED,
            f"fleet is overloaded: priority tier {lane!r} is being "
            f"shed (brownout level {level}/{len(lanes) - 1}) until "
            "queue pressure clears; no member was asked — retry "
            "after the suggested backoff or resubmit on a higher "
            "tier", lane=lane or "default",
            retry_after_s=round(1.0 + level, 1))

    def _members_by_depth(self) -> list[_Member]:
        """Alive members, least-loaded first: reported depth+running
        plus only the placements the member's LAST stats reply cannot
        have observed yet (``dispatched_since_poll`` — counting every
        live routed job here would double-count work the member
        already reports), round-robin on ties."""
        with self._lock:
            # fenced members are reachable but refusing work — they
            # get no placements until the next healthy poll re-grants
            # their lease (a fence is a pause, not a death)
            alive = [m for m in self.members.values()
                     if m.alive and not m.fenced]
            # quarantined members (gray failure) take no
            # NEW placements — but a slow member still beats no
            # member: with every live member quarantined, fall back
            # to them rather than wedge the fleet
            eligible = [m for m in alive if not m.quarantined]
            if eligible:
                alive = eligible
            self._rr += 1
            rr = self._rr
            order = sorted(
                enumerate(alive),
                key=lambda im: (im[1].queue_depth + im[1].running
                                + im[1].dispatched_since_poll,
                                (im[0] + rr) % max(1, len(alive))))
        return [m for _i, m in order]

    # ---- failover ------------------------------------------------------
    def _member_down(self, name: str) -> None:
        with self._lock:
            m = self.members.get(name)
            if m is None or not m.alive:
                return
            m.alive = False
            m.cache_enabled = None   # a member that rejoins may have
            #   been restarted WITH caching on — re-learn its verdict
            affected = [j for j in self.jobs.values()
                        if j.member == name and not j.retired
                        and j.terminal is None and j.scatter is None]
            # scattered m2m streams re-partition, never _recover_job:
            # the router itself holds their replay state per sub
            scattered = [j for j in self.jobs.values()
                         if j.scatter is not None and not j.retired
                         and j.terminal is None]
        self.failovers += 1
        self.metrics["failovers"].inc()
        self.metrics["member_up"].set(0, member=name)
        self.obs.event("member_down", member=name,
                       affected=len(affected))
        self._say(f"member {name} is DOWN ({len(affected)} routed "
                  "job(s) affected)")
        # fencing: bump the fleet epoch BEFORE any re-
        # placement so every re-admission below carries the new era —
        # if the "dead" member is actually a zombie (network blip,
        # stalled host), its lease expires without a heartbeat at the
        # new epoch and it self-fences before it can double-write
        with self._lock:
            self.epoch += 1
            epoch = self.epoch
        self.metrics["epoch"].set(epoch)
        self._journal([(REC_EPOCH,
                        {"epoch": epoch, "why": f"member_down:{name}"})])
        try:
            # best-effort synchronous fence: if the member is a
            # reachable zombie this lands instantly; a truly dead one
            # just refuses the connect
            with self._dial(m.target, timeout=1.0) as c:
                c.request({"cmd": "fence",
                           "reason": f"fleet failover epoch {epoch}: "
                           "the router declared this member dead"})
        except (ServiceError, OSError):
            pass
        folded: dict = {}
        if m.journal_path:
            try:
                records = JobJournal(m.journal_path).replay()
                folded = fold_records(records) if records else {}
            except Exception as e:
                self._say(f"warning: cannot read member journal "
                          f"{m.journal_path}: {e} — failing over "
                          "without it")
        for job in affected:
            self._recover_job(job, folded.get(job.mjid))
        for job in scattered:
            self._scatter_redrive(job, name)
        if folded and affected and m.journal_path:
            # set the consumed journal aside: a later restart of this
            # member must not replay jobs a sibling now owns (two
            # processes resuming the same report file is corruption,
            # not redundancy)
            try:
                from pwasm_tpu_torch.utils.fsio import replace_durable
                replace_durable(m.journal_path,
                                m.journal_path + ".recovered")
                self.obs.event("journal_set_aside", member=name,
                               path=m.journal_path + ".recovered")
            except OSError as e:
                self._say(f"warning: cannot set aside {name}'s "
                          f"journal after failover ({e}); do NOT "
                          "restart the member on it")

    def _recover_job(self, job: _FleetJob,
                     row: dict | None = None) -> None:
        """One job's failover verdict (module docstring).  ``row`` is
        the folded journal state for this job; None means "resolve it
        yourself" — the method re-reads the dead member's journal so
        a caller WITHOUT the fold (a result-waiter rescuing an orphan
        the death snapshot missed) still gets the journal verdict: a
        bare resume-anyway would re-run a job whose finish (or acked
        cancel) is durably recorded.  Idempotent and race-safe: a
        per-job latch plus a live-member check make concurrent calls
        (health loop vs a result-waiter) no-ops — a job must never be
        re-admitted twice."""
        with self._lock:
            if job.terminal is not None or job.retired \
                    or job.recovering:
                return
            m = self.members.get(job.member)
            if m is not None and m.alive:
                return        # already re-placed on a live member
            job.recovering = True
            jp = m.journal_path if m is not None else None
        try:
            if row is None and jp:
                try:
                    records = JobJournal(jp).replay()
                    row = fold_records(records).get(job.mjid) \
                        if records else None
                except Exception:
                    row = None    # unreadable/set-aside journal:
                    #               the resume-anyway path is the
                    #               documented safe fallback
            self._recover_job_inner(job, row)
        finally:
            with self._lock:
                job.recovering = False

    def _deadline_left_ms(self, job: _FleetJob) -> int | None:
        """Remaining end-to-end budget of a routed job (None = no
        deadline): the budget at router arrival minus everything
        spent since, so re-placements never hand a member more time
        than the client has left."""
        if job.deadline_ms is None:
            return None
        return job.deadline_ms - int(
            (time.monotonic() - job.submitted_mono) * 1000.0)

    def _recover_job_inner(self, job: _FleetJob,
                           row: dict | None) -> None:
        dead = job.member
        # journal verdicts FIRST — a stream job whose finish (or
        # acked cancel) is durably recorded must be served, not told
        # to re-send records (the member's own restart replay orders
        # its checks the same way)
        fin = row.get("finish") if row else None
        if fin is not None:
            state = fin.get("state") \
                if fin.get("state") in TERMINAL_STATES else JOB_FAILED
            rc = fin.get("rc") if isinstance(fin.get("rc"), int) \
                else None
            extra: dict = {}
            spool = fin.get("spool")
            if isinstance(spool, dict) \
                    and isinstance(spool.get("path"), str):
                from pwasm_tpu_torch.service.daemon import \
                    load_spool_payload
                payload, err = load_spool_payload(spool["path"])
                if payload is not None:
                    extra = {"stats": payload.get("stats"),
                             "stderr_tail":
                             str(payload.get("stderr_tail") or "")}
                else:
                    extra = {"spool_error": err}
            self._cache_terminal(job, state, rc,
                                 str(fin.get("detail") or "")
                                 + " [served from the dead member's "
                                 "journal+spool]", **extra)
            self.recovered["restored"] += 1
            self.metrics["recovered"].inc(how="restored")
            return
        if row is not None and row.get("cancel") is not None:
            self._cache_terminal(job, JOB_CANCELLED, None, (
                "cancel was acked before the member died; not re-run"))
            self.recovered["cancelled"] += 1
            self.metrics["recovered"].inc(how="cancelled")
            return
        if job.stream:
            # a LIVE-at-crash socket stream: first try the bounded
            # replay window (--stream-replay-bytes) — every acked
            # record is still buffered at the router, so a sibling
            # can be fed the whole prefix and the client never even
            # sees the death.  Past the window (or with it off) no
            # sibling can re-run the stream alone — terminal
            # preempted-resumable, the same verdict the member's own
            # restart replay reaches.
            if self._redrive_stream(job, dead):
                return
            self._cache_terminal(job, JOB_PREEMPTED, 75, (
                "stream interrupted: fleet member died; records up "
                "to the last checkpoint are durable — re-open a "
                "stream with --resume and re-send the records"))
            self.recovered["stream_preempted"] += 1
            self.metrics["recovered"].inc(how="stream_preempted")
            return
        # live at crash time: re-admit on a sibling.  With a journal
        # row, `start` tells us whether a --resume continuation is
        # needed; without one (per-daemon journal on an unreachable
        # host) --resume is still the safe choice — it resumes a valid
        # checkpoint when one exists and restarts cleanly when none
        # does.
        resume = row["start"] is not None if row is not None \
            else True
        argv = list(job.frame.get("args") or [])
        # fencing invariant: every --resume
        # re-admission passes the epoch guard — a resume placed under
        # an older epoch than the job's current one would race the
        # newer owner on the same report file
        epoch = readmit_epoch_guard(job.epoch, self.epoch)
        if resume and "--resume" not in argv:
            argv = argv + ["--resume"]
        fwd = dict(job.frame, args=argv)
        left = self._deadline_left_ms(job)
        if left is not None:
            if left <= 0:
                # the budget died with the member: land the same
                # truthful verdict the member itself would have
                # reached — resumable, journal-honest, no sibling
                # burns a queue slot on an already-expired job
                self._cache_terminal(job, JOB_PREEMPTED, 75, (
                    "deadline_exceeded: the end-to-end budget was "
                    "already spent when its member died; work up to "
                    "the last durable checkpoint survives — "
                    "resubmit with --resume and a fresh "
                    "--deadline-s"))
                self.recovered["deadline_exceeded"] += 1
                self.metrics["recovered"].inc(how="deadline_exceeded")
                return
            fwd["deadline_ms"] = left
        placed = False
        for m in self._members_by_depth():
            if m.name == dead:
                continue
            try:
                c = self._dial(m.target, timeout=30.0)
            except ServiceError:
                continue       # connect refused: safe to try the next
            try:
                with c:
                    resp = c.request({
                        "cmd": "submit", **fwd,
                        "trace_id": job.trace_id,
                        "client": job.client,
                        **({"priority": job.priority}
                           if job.priority else {})})
            except ServiceError:
                # the frame may have been WRITTEN before the
                # connection died — the sibling could have admitted
                # the job without us seeing the ack.  At-most-once
                # (the same rule as _route_submit): land the job
                # terminal failed instead of re-admitting a possibly
                # duplicate copy on yet another sibling.
                self._cache_terminal(job, JOB_FAILED, None, (
                    f"failover re-admission to member {m.name} "
                    "failed mid-request; the job may or may not "
                    "have been admitted there, so it was not "
                    "retried elsewhere (at-most-once). Check that "
                    "member's results before resubmitting."))
                self.recovered["failed"] += 1
                self.metrics["recovered"].inc(how="failed")
                return
            if resp.get("ok"):
                with self._lock:
                    job.member = m.name
                    job.mjid = resp["job_id"]
                    job.gen += 1
                    job.epoch = epoch
                    job.failovers += 1
                    m.jobs_routed += 1
                    m.dispatched_since_poll += 1
                self.ledger.move(job.client, dead, m.name)
                self._journal([(REC_ROUTE_PLACE,
                                {"job_id": job.fid, "member": m.name,
                                 "mjid": job.mjid, "gen": job.gen,
                                 "epoch": epoch})])
                how = "resumed" if resume else "requeued"
                self.recovered[how] += 1
                self.metrics["recovered"].inc(how=how)
                self.obs.event("failover_readmit", job_id=job.fid,
                               trace_id=job.trace_id, member=m.name,
                               resumed=resume, was=dead)
                self._say(f"job {job.fid}: "
                          + ("resumed on" if resume
                             else "re-queued to")
                          + f" member {m.name}")
                placed = True
                break
        if not placed:
            self._cache_terminal(job, JOB_FAILED, None, (
                "fleet member died and no sibling could take the "
                "job over; resubmit (with --resume if a checkpoint "
                "exists)"))
            self.recovered["failed"] += 1
            self.metrics["recovered"].inc(how="failed")

    def _redrive_stream(self, job: _FleetJob, dead: str) -> bool:
        """Invisible mid-stream failover: re-open the
        stream on a sibling and re-drive every buffered (acked)
        record from the bounded replay window.  True = the job now
        lives on the sibling and the client's next frame forwards
        there as if nothing happened; False = no window (overflowed /
        disabled) or no sibling could take it — the caller lands the
        documented preempted-resumable verdict."""
        with self._lock:
            frames = list(job.rbuf) if job.rbuf is not None else None
            ended = job.ended
        if frames is None:
            return False
        left = self._deadline_left_ms(job)
        if left is not None and left <= 0:
            return False   # budget spent: the caller's preempted-
            #   resumable verdict is the truthful answer, and a
            #   sibling would refuse the expired admission anyway
        epoch = readmit_epoch_guard(job.epoch, self.epoch)
        for m in self._members_by_depth():
            if m.name == dead:
                continue
            try:
                c = self._dial(m.target, timeout=60.0)
            except ServiceError:
                continue
            try:
                resp = c.request({
                    "cmd": "stream", **job.frame,
                    "client": job.client,
                    **({"deadline_ms": left}
                       if left is not None else {}),
                    **({"trace_id": job.trace_id}
                       if job.trace_id else {}),
                    **({"priority": job.priority}
                       if job.priority else {})})
                if not resp.get("ok"):
                    c.close()
                    continue
                mjid = resp["job_id"]
                for f in frames:
                    fwd = dict(f)
                    fwd["job_id"] = mjid
                    for _retry in range(50):
                        r = c.request(fwd)
                        if r.get("error") == protocol.ERR_QUEUE_FULL:
                            time.sleep(min(0.2, float(
                                r.get("retry_after_s") or 0.1)))
                            continue
                        break
                    if not r.get("ok"):
                        raise ServiceError(
                            f"redrive rejected: {r.get('detail')}")
                if ended:
                    r = c.request({"cmd": "stream-end",
                                   "job_id": mjid})
                    if not r.get("ok"):
                        raise ServiceError(
                            f"redrive end rejected: {r.get('detail')}")
            except (ServiceError, OSError, KeyError, TypeError) as e:
                # at-most-once: the sibling may hold a half-fed
                # stream — cancel it best-effort, then fall back to
                # the preempted verdict rather than trying a THIRD
                # member with unknown state on the second
                try:
                    c.request({"cmd": "cancel",
                               "job_id": locals().get("mjid", "")})
                except (ServiceError, OSError):
                    pass
                c.close()
                self._say(f"stream {job.fid}: replay to {m.name} "
                          f"failed ({e}); landing preempted")
                return False
            with self._lock:
                old, job.sconn = job.sconn, c
                job.member = m.name
                job.mjid = mjid
                job.gen += 1
                job.epoch = epoch
                job.failovers += 1
                m.jobs_routed += 1
                m.dispatched_since_poll += 1
            if old is not None:
                old.close()
            self.ledger.move(job.client, dead, m.name)
            self._journal([(REC_ROUTE_PLACE,
                            {"job_id": job.fid, "member": m.name,
                             "mjid": mjid, "gen": job.gen,
                             "epoch": epoch})])
            self.recovered["stream_replayed"] += 1
            self.metrics["recovered"].inc(how="stream_replayed")
            self.obs.event("stream_redriven", job_id=job.fid,
                           trace_id=job.trace_id, member=m.name,
                           frames=len(frames), was=dead)
            self._say(f"stream {job.fid}: re-drove {len(frames)} "
                      f"buffered frame(s) to member {m.name} — "
                      "failover invisible to the client")
            return True
        return False

    def _cache_terminal(self, job: _FleetJob, state: str,
                        rc: int | None, detail: str,
                        **extra) -> None:
        resp = protocol.ok(
            job={"id": job.fid, "state": state, "rc": rc,
                 "detail": detail, "client": job.client,
                 "priority": job.priority, "trace_id": job.trace_id,
                 "stream": job.stream, "recovered": True,
                 "member": job.member,
                 "submitted_s": round(job.submitted_s, 3),
                 "started_s": None, "finished_s":
                 round(time.time(), 3)},
            rc=rc, stats=extra.pop("stats", None),
            stderr_tail=extra.pop("stderr_tail", ""), **extra)
        with self._lock:
            job.terminal = resp
        self.obs.event("failover_verdict", job_id=job.fid,
                       trace_id=job.trace_id, state=state, rc=rc)
        self._note_retired(job)

    # ---- protocol ------------------------------------------------------
    def _handle_conn(self, conn: socket.socket) -> None:
        from pwasm_tpu_torch.service.daemon import _peer_identity
        if self.tls is not None and conn.family != socket.AF_UNIX:
            # handshake in THIS connection's thread; a failure is
            # counted and answered with a loud close, never a hang
            # or an accept-loop crash (same contract as the daemon)
            from pwasm_tpu_torch.fleet.transport import server_handshake
            conn = server_handshake(conn, self.tls,
                                    on_failure=self._tls_failed)
            if conn is None:
                return
        protocol.serve_connection(conn, self._dispatch,
                                  peer=_peer_identity(conn),
                                  max_frame_bytes=self.max_frame_bytes)

    def _tls_failed(self, exc: Exception) -> None:
        self.transport_metrics["tls_handshake_failures"].inc()
        self.obs.event("tls_handshake_failed",
                       detail=f"{type(exc).__name__}: {exc}")

    def _dial(self, target: str, timeout: float | None = None,
              **kw) -> ServiceClient:
        """EVERY router->member connection is minted here, so the
        member-facing TLS config and capability token cannot be
        missed by one call site — an all-TLS fleet stays all-TLS
        through failover, cache probes, and scaler retires."""
        if self.member_token is not None:
            kw.setdefault("client_token", self.member_token)
        return ServiceClient(target, timeout=timeout,
                             tls=self.member_tls, **kw)

    def _resolve_client(self, req: dict, peer: str | None) -> str:
        """protocol.resolve_client_identity — shared with the serve
        daemon so router quota buckets and member DRR buckets cannot
        drift."""
        return protocol.resolve_client_identity(req, peer)

    def _auth_label(self, client: str) -> str:
        if client in self._auth_labels or len(self._auth_labels) < 64:
            self._auth_labels.add(client)
            return client
        return "other"

    def _authorize(self, cmd, req: dict, peer) -> dict | None:
        """The router-edge scoped-token gate — the same
        policy shape as the member's: None = proceed, else the
        truthful `unauthorized` frame, with no ledger/journal state
        touched and no frame forwarded to any member."""
        from pwasm_tpu_torch.service import authz
        scope = authz.required_scope(cmd, req)
        ok = False
        if scope is None or self.auth.allows(req, peer,
                                             authz.SCOPE_ADMIN):
            ok = True
        elif scope == authz.SCOPE_CANCEL_OWN:
            if self.auth.allows(req, peer, scope):
                job = self.jobs.get(req.get("job_id"))
                ok = (job is None or job.client
                      == self._resolve_client(req, peer))
        else:
            ok = self.auth.allows(req, peer, scope)
        key = peer or self._resolve_client(req, peer) or "anonymous"
        if ok:
            self._penalty.clear(key)
            return None
        client = self._resolve_client(req, peer) or "anonymous"
        self.transport_metrics["auth_failures"].inc(
            client=self._auth_label(client))
        self.obs.event("unauthorized", cmd=cmd, client=client)
        time.sleep(self._penalty.fail(key))
        return protocol.err(
            protocol.ERR_UNAUTHORIZED,
            f"cmd {cmd!r} requires scope {scope!r} and the presented "
            "credentials do not grant it (token file: "
            f"{self.auth.path})")

    def _dispatch(self, req: dict, peer: str | None = None) -> dict:
        cmd = req.get("cmd")
        if self.auth is not None:
            deny = self._authorize(cmd, req, peer)
            if deny is not None:
                return deny
        if self.rate_limiter is not None \
                and cmd in ("submit", "stream"):
            # edge rate limiting in front of the fleet ledger: a
            # refused frame reaches no member and writes no journal
            client = self._resolve_client(req, peer)
            wait = self.rate_limiter.admit(client or "default")
            if wait > 0:
                self.obs.event("rate_limited",
                               client=client or "default",
                               retry_after_s=wait)
                return protocol.err(
                    protocol.ERR_OVERLOADED,
                    f"rate limit: client "
                    f"{client or 'default'} exceeded "
                    f"{self.rate_limiter.rate:g}/s "
                    f"(burst {self.rate_limiter.burst:g})",
                    client=client or "default",
                    retry_after_s=wait)
        if cmd == "ping":
            with self._lock:
                alive = sum(1 for m in self.members.values()
                            if m.alive)
            return protocol.ok(
                protocol_version=protocol.PROTOCOL_VERSION,
                draining=self._draining, router=True,
                members=len(self.members), members_alive=alive)
        if cmd in ("submit", "stream"):
            return self._route_submit(req, peer,
                                      stream=(cmd == "stream"))
        if cmd in ("stream-data", "stream-end"):
            return self._route_stream_frame(req)
        if cmd == "stats":
            # refresh synchronously: svc-stats (and the fleet-aware
            # top built on it) must describe NOW, not the last poll
            self._poll_members()
            return protocol.ok(stats=self._fleet_stats())
        if cmd == "metrics":
            self._refresh_gauges()
            return protocol.ok(
                metrics=self.registry.expose(
                    exemplars=bool(req.get("exemplars"))),
                content_type="text/plain; version=0.0.4")
        if cmd == "health":
            return protocol.ok(health=self._fleet_health())
        if cmd == "logs":
            return protocol.handle_logs(req, self.log_json_path)
        if cmd == "drain":
            self.drain.request("drain requested by client")
            self._begin_drain(self.drain.reason)
            with self._lock:
                live = sorted(j.fid for j in self.jobs.values()
                              if not j.retired and j.terminal is None)
            return protocol.ok(draining=True, running=live,
                               preempted_queued=[])
        if cmd in ("status", "result", "cancel", "inspect"):
            job = self.jobs.get(req.get("job_id"))
            if job is None:
                # unknown OR evicted past max_results: same answer
                return protocol.err(
                    protocol.ERR_UNKNOWN_JOB,
                    f"unknown job_id {req.get('job_id')!r}")
            job.accessed_s = time.time()   # the LRU clock
            if cmd == "result":
                return self._route_result(job, req)
            return self._route_simple(job, cmd)
        return protocol.err(protocol.ERR_UNKNOWN_CMD,
                            f"unknown cmd {cmd!r}")

    def _route_submit(self, req: dict, peer: str | None,
                      stream: bool) -> dict:
        t_in = time.monotonic()   # the deadline decrement anchor:
        #   every millisecond this frame spends inside the router
        #   (cache probe, affinity pass, placement retries) comes out
        #   of the client's end-to-end budget before a member sees it
        if self._draining:
            return protocol.err(protocol.ERR_DRAINING,
                                "fleet router is draining")
        client = self._resolve_client(req, peer)
        if not isinstance(client, str) or len(client) > 64:
            return protocol.err(protocol.ERR_BAD_REQUEST,
                                "client must be a short identifier")
        deadline_ms, dl_err = protocol.parse_deadline_ms(req)
        if dl_err is not None:
            return dl_err
        shed = self._shed_check(req.get("priority"))
        if shed is not None:
            self.obs.event("route_shed", client=client or "default",
                           lane=str(req.get("priority") or "")
                           or "default")
            return shed
        trace_id = req.get("trace_id")
        frame = {"args": req.get("args"), "cwd": req.get("cwd")}
        if req.get("priority") is not None:
            frame["priority"] = req.get("priority")
        if stream and req.get("delta"):
            # delta-over-stream opt-in (docs/STREAMING.md) rides the
            # member stream-open — and, because it lives in the
            # journaled frame, every failover re-open too
            frame["delta"] = True
        # fleet result cache: consult the shared cache dir
        # at the router's edge — a hit never reaches a member
        cache_key_hex = None
        cache_family = None
        if self.cache is not None and not stream:
            cache_key_hex, cache_family, served = self._cache_lookup(
                frame, client, req.get("priority"), trace_id)
            if served is not None:
                return served
        order = self._members_by_depth()
        if not order:
            return protocol.err(
                protocol.ERR_QUEUE_FULL,
                "no live fleet members (retry after they rejoin)",
                retry_after_s=2.0)
        if stream and len(order) > 1 \
                and self._scatter_eligible(frame):
            # fleet-wide m2m surveillance: partition the target stream
            # across the members; None = could not hold two
            # sub-streams open, fall back to one member
            out = self._scatter_submit(req, frame, client, trace_id,
                                       deadline_ms, t_in, order)
            if out is not None:
                return out
            order = self._members_by_depth()
            if not order:
                return protocol.err(
                    protocol.ERR_QUEUE_FULL,
                    "no live fleet members (retry after they rejoin)",
                    retry_after_s=2.0)
        if cache_key_hex is not None and len(order) > 1:
            # miss at the router: cache-AFFINITY placement — a member
            # whose private cache holds the key gets the job (its own
            # admission serves it), so the fleet never re-runs a job
            # ANY member has already answered.  A member holding only
            # the job's FAMILY (a near-repeat prefix) ranks next: its
            # admission answers the job as a delta
            order = self._cache_affinity(order, cache_key_hex,
                                         cache_family)
        last_reject: dict | None = None
        for m in order:
            fwd_deadline: dict = {}
            if deadline_ms is not None:
                # remaining-budget arithmetic: subtract the time this
                # frame has already spent inside the router before
                # handing the member what is genuinely left
                rem = deadline_ms - int(
                    (time.monotonic() - t_in) * 1000.0)
                if rem <= 0:
                    self.metrics["jobs"].inc(outcome="rejected")
                    return protocol.err(
                        protocol.ERR_DEADLINE_EXCEEDED,
                        "end-to-end deadline budget "
                        f"({deadline_ms} ms at the router) was spent "
                        "in routing before any member admitted the "
                        "job — nothing was admitted; resubmit with a "
                        "fresh --deadline-s", deadline_ms=rem)
                fwd_deadline = {"deadline_ms": rem}
            try:
                self.ledger.admit(client, m.name)
            except QueueFull as e:
                self.metrics["jobs"].inc(outcome="rejected")
                self.obs.event("route_reject", client=client,
                               detail=str(e))
                return protocol.err(
                    protocol.ERR_QUEUE_FULL, str(e),
                    client=client or "default",
                    client_depth=self.ledger.client_depths().get(
                        client, 0),
                    retry_after_s=2.0)
            t0 = self.obs.tracer.now() \
                if self.obs.tracer is not None else 0.0
            try:
                c = self._dial(m.target, timeout=60.0)
            except ServiceError:
                self.ledger.retire(client, m.name)
                self._member_down(m.name)
                continue
            try:
                resp = c.request({
                    "cmd": "stream" if stream else "submit",
                    **frame, "client": client, **fwd_deadline,
                    **({"trace_id": trace_id}
                       if isinstance(trace_id, str) and trace_id
                       else {})})
            except ServiceError:
                # the frame may have been WRITTEN before the
                # connection died: the member could have admitted
                # (and journaled) the job even though we never saw
                # the ack.  Re-placing it on a sibling here would be
                # a possible double admission — two processes running
                # the same -o argv, the corruption this router's own
                # failover logic refuses elsewhere.  At-most-once
                # wins: fail the submission loudly instead.  (A
                # CONNECT-phase failure above carries no such risk
                # and does try the next sibling.)
                c.close()
                self.ledger.retire(client, m.name)
                self._member_down(m.name)
                self.metrics["jobs"].inc(outcome="rejected")
                return protocol.err(
                    protocol.ERR_BAD_REQUEST,
                    f"fleet member {m.name} failed mid-submission; "
                    "the job may or may not have been admitted "
                    "there, so it was NOT retried on a sibling "
                    "(at-most-once). Check the member's "
                    "journal/results before resubmitting.")
            if self.obs.tracer is not None:
                self.obs.tracer.complete(
                    "route_submit", t0, trace_id=trace_id,
                    member=m.name)
            if resp.get("ok"):
                with self._lock:
                    self._next_id += 1
                    fid = f"fleet-{self._next_id:04d}"
                    job = _FleetJob(fid, client,
                                    str(req.get("priority") or ""),
                                    str(resp.get("trace_id")
                                        or trace_id or ""),
                                    frame, m.name, resp["job_id"],
                                    stream=stream)
                    job.epoch = self.epoch
                    if deadline_ms is not None:
                        # anchor at frame ARRIVAL, not placement —
                        # a failover re-admission must forward what
                        # is left of the CLIENT's budget, and the
                        # routing time above already spent some
                        job.deadline_ms = deadline_ms
                        job.submitted_mono = t_in
                    if stream:
                        job.sconn = c
                        if self.stream_replay_bytes <= 0:
                            job.rbuf = None   # replay window off
                    self.jobs[fid] = job
                    m.jobs_routed += 1
                    m.dispatched_since_poll += 1
                if not stream:
                    c.close()
                # WAL: the client's ack and this pair commit together
                # (one fsync) — an admission the journal missed was
                # never acked, so replay can safely drop it
                self._journal([
                    (REC_ROUTE_ADMIT,
                     {"job_id": fid, "client": client,
                      "priority": job.priority,
                      "trace_id": job.trace_id, "stream": stream,
                      "frame": frame}),
                    (REC_ROUTE_PLACE,
                     {"job_id": fid, "member": m.name,
                      "mjid": job.mjid, "gen": 0,
                      "epoch": job.epoch})])
                self.metrics["jobs"].inc(outcome="accepted")
                self.metrics["routed"].inc(member=m.name)
                self.obs.event("route_admit", job_id=fid,
                               member=m.name, client=client,
                               stream=stream,
                               trace_id=job.trace_id)
                out = dict(resp)
                out["job_id"] = fid
                out["member"] = m.name
                return out
            c.close()
            self.ledger.retire(client, m.name)
            if resp.get("error") in (protocol.ERR_QUEUE_FULL,
                                     protocol.ERR_FENCED):
                # queue_full: try the next-best sibling.  fenced: the
                # member lost its lease between our poll and this
                # frame — same treatment (the poll will mark it)
                last_reject = resp
                continue
            # bad_request / draining etc: the member's diagnostic is
            # the authoritative one — relay it
            self.metrics["jobs"].inc(outcome="rejected")
            return resp
        self.metrics["jobs"].inc(outcome="rejected")
        return last_reject if last_reject is not None else \
            protocol.err(protocol.ERR_QUEUE_FULL,
                         "every fleet member is at capacity",
                         retry_after_s=2.0)

    def _cache_lookup(self, frame: dict, client: str, priority,
                      trace_id
                      ) -> tuple[str | None, str | None, dict | None]:
        """``(key, family, terminal-submit-response | None)``: derive
        the content-addressed key from the cwd-absolutized argv and
        consult the router's shared cache dir.  A hit writes the
        verified output bytes to the job's own output paths and
        answers a terminal fleet job on the spot — zero members, zero
        queues, zero devices.  Any defect falls through to a normal
        placement (the key and its delta FAMILY, when derivable,
        still feed affinity)."""
        from pwasm_tpu_torch.service.cache import (argv_stats_path,
                                             classify_argv,
                                             derive_keys,
                                             serve_outputs,
                                             write_hit_stats)
        from pwasm_tpu_torch.service.daemon import _absolutize_argv
        args = frame.get("args")
        if not isinstance(args, list) \
                or not all(isinstance(a, str) for a in args):
            return None, None, None
        argv = list(args)
        cwd = frame.get("cwd")
        if isinstance(cwd, str) and os.path.isabs(cwd):
            argv = _absolutize_argv(argv, cwd)
        cls = classify_argv(argv)
        derived = derive_keys(cls) if cls is not None else None
        if derived is None:
            return None, None, None
        key, family = derived
        got = self.cache.get(key)
        if got is None:
            return key, family, None
        manifest, blobs = got
        try:
            if not serve_outputs(blobs, cls.output_paths):
                return key, family, None
        except OSError:
            return key, family, None   # unwritable outputs: let a
            #                     member produce the real diagnostic
        stats = write_hit_stats(manifest, argv_stats_path(argv))
        with self._lock:
            self._next_id += 1
            fid = f"fleet-{self._next_id:04d}"
            job = _FleetJob(fid, client, str(priority or ""),
                            str(trace_id or ""), dict(frame),
                            "cache", "", stream=False)
            job.retired = True      # never entered the ledger
            self.jobs[fid] = job
        resp = protocol.ok(
            job={"id": fid, "state": "done", "rc": 0,
                 "detail": "served from the fleet result cache "
                           "(byte-identical to a full run)",
                 "client": client, "priority": job.priority,
                 "trace_id": job.trace_id, "stream": False,
                 "recovered": False, "member": "cache",
                 "submitted_s": round(job.submitted_s, 3),
                 "started_s": None,
                 "finished_s": round(time.time(), 3)},
            rc=0, stats=stats, stderr_tail="")
        with self._lock:
            job.terminal = resp
        self._journal([
            (REC_ROUTE_ADMIT,
             {"job_id": fid, "client": client,
              "priority": job.priority, "trace_id": job.trace_id,
              "stream": False, "frame": dict(frame),
              "cache_hit": True}),
            (REC_ROUTE_RETIRE,
             {"job_id": fid, "state": "done", "rc": 0,
              "detail": "served from the fleet result cache "
                        "(byte-identical to a full run)"})])
        self.metrics["jobs"].inc(outcome="accepted")
        self.obs.event("cache_hit", job_id=fid,
                       trace_id=job.trace_id)
        return key, family, protocol.ok(
            job_id=fid, trace_id=job.trace_id,
            member="cache", cache_hit=True, queue_depth=0)

    def _cache_affinity(self, order: list, key: str,
                        family: str | None = None) -> list:
        """Reorder placement so the first member whose ``cache-probe``
        answers hit=true goes first; with an exact hit nowhere, the
        first member answering family_hit=true (it holds a same-family
        entry, so its admission can serve the job as a DELTA) fronts
        instead — the router learns delta verdicts the same way it
        learns exact ones.  The probe is a placement HINT, never worth
        stalling admission for: per-probe timeout is short, the WHOLE
        pass is budgeted (~1s), a member that answered enabled=false
        is skipped until it next rejoins (``_member_down`` resets the
        verdict), and probe failures are never death evidence."""
        deadline = time.monotonic() + 1.0
        family_m = None
        for m in order:
            if m.cache_enabled is False:
                continue
            if time.monotonic() >= deadline:
                break            # a hint must not gate the submit
            probe = {"cmd": "cache-probe", "key": key}
            if family is not None:
                probe["family"] = family
            try:
                with self._dial(m.target, timeout=0.5) as c:
                    r = c.request(probe)
            except ServiceError:
                continue
            if not r.get("ok"):
                continue
            m.cache_enabled = bool(r.get("enabled"))
            if r.get("hit"):
                return [m] + [x for x in order if x is not m]
            if family_m is None and r.get("family_hit"):
                family_m = m
        if family_m is not None:
            return [family_m] + [x for x in order
                                 if x is not family_m]
        return order

    def _route_stream_frame(self, req: dict) -> dict:
        job = self.jobs.get(req.get("job_id"))
        if job is None:
            return protocol.err(
                protocol.ERR_UNKNOWN_JOB,
                f"unknown job_id {req.get('job_id')!r}")
        if not job.stream:
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                f"job {job.fid} is not a stream job")
        if job.scatter is not None:
            job.accessed_s = time.time()
            return self._scatter_stream_frame(job, req)
        with self._lock:
            # snapshot under the lock: _note_retired pops job.sconn
            # concurrently (a stream that landed terminal server-side
            # while the client was still pumping frames)
            sconn = job.sconn
            closed = job.terminal is not None or job.retired \
                or sconn is None
        if closed:
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                f"stream {job.fid} is closed; re-open a stream with "
                "--resume to complete it")
        fwd = dict(req)
        fwd["job_id"] = job.mjid
        try:
            with job.slock:
                resp = sconn.request(fwd)
            if resp.get("ok"):
                self._buffer_stream_frame(job, req)
            return resp
        except ServiceError:
            # decide WHOSE failure this was before declaring a member
            # dead: a router-side close (the job retired mid-request)
            # is a closed stream on a healthy member, and failing the
            # member over for it would re-run jobs it still owns
            with self._lock:
                retired_now = job.retired or job.terminal is not None
                gen = job.gen
            if retired_now:
                return protocol.err(
                    protocol.ERR_BAD_REQUEST,
                    f"stream {job.fid} is closed; re-open a stream "
                    "with --resume to complete it")
            self._member_down(job.member)
            # _member_down runs failover synchronously: if the replay
            # window re-drove this stream to a sibling, forward THIS
            # frame there too — the client never learns anything died
            with self._lock:
                moved = job.gen != gen and job.terminal is None \
                    and not job.retired
                sconn2, mjid2 = job.sconn, job.mjid
            if moved and sconn2 is not None:
                fwd2 = dict(req)
                fwd2["job_id"] = mjid2
                try:
                    with job.slock:
                        resp = sconn2.request(fwd2)
                    if resp.get("ok"):
                        self._buffer_stream_frame(job, req)
                    return resp
                except ServiceError:
                    pass     # the sibling died too: fall through
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                f"stream {job.fid} lost its member mid-stream; "
                "re-open a stream with --resume and re-send the "
                "records")

    def _buffer_stream_frame(self, job: _FleetJob, req: dict) -> None:
        """Append one ACKED stream frame to the job's bounded replay
        window.  Past --stream-replay-bytes the window is dropped
        (not truncated — a partial prefix replays a corrupt stream)
        and mid-stream failover degrades to the documented
        preempted-resumable verdict."""
        with self._lock:
            if req.get("cmd") == "stream-end":
                job.ended = True
                return
            if job.rbuf is None:
                return
            data = req.get("data")
            size = len(data) if isinstance(data, str) else 256
            if job.rbytes + size > self.stream_replay_bytes:
                job.rbuf = None
                job.rbytes = 0
                fid = job.fid
            else:
                job.rbuf.append(dict(req))
                job.rbytes += size
                return
        self.obs.event("stream_window_overflow", job_id=fid,
                       limit=self.stream_replay_bytes)

    # ---- fleet-wide m2m scatter ---------------------------------------
    # A --m2m-stream opened against the router with >= 2 live members
    # is PARTITIONED, not placed: one sub-stream per member, arriving
    # target records dealt round-robin (surveil/partition.ScatterState
    # keeps the arrival-order bookkeeping), per-sub replay buffers so
    # a member death re-partitions its records wholesale onto a
    # survivor, and the per-member section fragments spliced back into
    # ONE report at result time — byte-identical to an un-scattered
    # run over the same stream.  All scatter state lives under
    # sc["lock"] (an RLock: a send failure inside a frame handler
    # re-enters via _member_down -> _scatter_redrive); member sub
    # connections are only ever used under that lock.

    @staticmethod
    def _scatter_eligible(frame: dict) -> bool:
        args = frame.get("args")
        return (isinstance(args, list)
                and all(isinstance(a, str) for a in args)
                and "--m2m-stream" in args and "-o" in args)

    def _scatter_submit(self, req: dict, frame: dict, client: str,
                        trace_id, deadline_ms, t_in: float,
                        order: list) -> dict | None:
        """Open one sub-stream per live member; None = fewer than two
        stayed open (the caller falls back to a single placement)."""
        from pwasm_tpu_torch.surveil.partition import (ScatterState,
                                                       rewrite_out_args)
        from pwasm_tpu_torch.surveil.records import FastaAssembler
        args = [str(a) for a in frame.get("args") or []]
        cwd = frame.get("cwd")
        cwd = cwd if isinstance(cwd, str) and cwd else os.getcwd()

        def _abspath(p):
            return p if os.path.isabs(p) else os.path.join(cwd, p)

        o = s = stats_path = None
        i = 0
        while i < len(args):
            a = args[i]
            if a == "-o" and i + 1 < len(args):
                o = args[i + 1]
                i += 2
                continue
            if a == "-s" and i + 1 < len(args):
                s = args[i + 1]
                i += 2
                continue
            if a.startswith("--stats="):
                stats_path = a[len("--stats="):]
            i += 1
        if not o:
            return None
        o = _abspath(o)
        s = _abspath(s) if s else None
        stats_path = _abspath(stats_path) if stats_path else None
        rem = None
        if deadline_ms is not None:
            rem = deadline_ms - int((time.monotonic() - t_in) * 1000.0)
            if rem <= 0:
                self.metrics["jobs"].inc(outcome="rejected")
                return protocol.err(
                    protocol.ERR_DEADLINE_EXCEEDED,
                    f"end-to-end deadline budget ({deadline_ms} ms "
                    "at the router) was spent in routing before any "
                    "member admitted the scattered stream; resubmit "
                    "with a fresh --deadline-s", deadline_ms=rem)
        state = ScatterState()
        subs: list = []
        ntag = 0
        for m in order:
            # the fragment tag burns per ATTEMPT, not per success: a
            # mid-request open failure may have left a ghost sub job
            # writing to this tag's paths — never reuse them
            frag_o = f"{o}.frag{ntag:02d}"
            frag_s = f"{s}.frag{ntag:02d}" if s else None
            ntag += 1
            sargs = rewrite_out_args(args, o=frag_o, s=frag_s)
            row = self._scatter_open_sub(
                m, sargs, cwd, client, trace_id, rem,
                frame.get("priority"))
            if row is None:
                continue
            state.add_sub()
            row["o"], row["s"] = frag_o, frag_s
            subs.append(row)
        if len(subs) < 2:
            for r in subs:
                self._scatter_cancel_sub(r)
            return None
        try:
            self.ledger.admit(client, subs[0]["member"])
        except QueueFull as e:
            for r in subs:
                self._scatter_cancel_sub(r)
            self.metrics["jobs"].inc(outcome="rejected")
            self.obs.event("route_reject", client=client,
                           detail=str(e))
            return protocol.err(
                protocol.ERR_QUEUE_FULL, str(e),
                client=client or "default",
                client_depth=self.ledger.client_depths().get(
                    client, 0),
                retry_after_s=2.0)
        with self._lock:
            self._next_id += 1
            fid = f"fleet-{self._next_id:04d}"
            job = _FleetJob(fid, client,
                            str(req.get("priority") or ""),
                            str(trace_id or ""), frame,
                            subs[0]["member"], subs[0]["mjid"],
                            stream=True)
            job.epoch = self.epoch
            if deadline_ms is not None:
                job.deadline_ms = deadline_ms
                job.submitted_mono = t_in
            job.rbuf = None   # the scatter keeps RECORD-granular
            #   replay buffers per sub instead of the frame window
            job.scatter = {
                "lock": threading.RLock(), "state": state,
                "subs": subs, "asm": FastaAssembler(), "o": o,
                "s": s, "stats_path": stats_path, "args": args,
                "cwd": cwd, "ntag": ntag,
                "texts": [[] for _ in subs], "rbytes": 0,
                "ended": False}
            if self.stream_replay_bytes <= 0:
                job.scatter["texts"] = None
            self.jobs[fid] = job
            for r in subs:
                m = self.members.get(r["member"])
                if m is not None:
                    m.jobs_routed += 1
                    m.dispatched_since_poll += 1
        rows = [(REC_ROUTE_ADMIT,
                 {"job_id": fid, "client": client,
                  "priority": job.priority, "trace_id": job.trace_id,
                  "stream": True, "frame": frame, "scatter": True})]
        for k, r in enumerate(subs):
            rows.append((REC_ROUTE_PLACE,
                         {"job_id": fid, "member": r["member"],
                          "mjid": r["mjid"], "gen": 0,
                          "epoch": job.epoch, "sub": k}))
        self._journal(rows)
        self.metrics["jobs"].inc(outcome="accepted")
        for r in subs:
            self.metrics["routed"].inc(member=r["member"])
        self.obs.event("scatter_admit", job_id=fid, client=client,
                       subs=len(subs), trace_id=job.trace_id,
                       members=",".join(r["member"] for r in subs))
        self._say(f"stream {fid}: scattered --m2m-stream across "
                  f"{len(subs)} member(s)")
        out = dict(subs[0].pop("open"))
        for r in subs[1:]:
            r.pop("open", None)
        out["job_id"] = fid
        out["member"] = f"scatter[{len(subs)}]"
        out["scatter"] = [r["member"] for r in subs]
        return out

    def _scatter_open_sub(self, m, sargs: list, cwd: str,
                          client: str, trace_id, rem,
                          priority) -> dict | None:
        try:
            c = self._dial(m.target, timeout=60.0)
        except ServiceError:
            self._member_down(m.name)
            return None
        reqd: dict = {"cmd": "stream", "args": sargs, "cwd": cwd,
                      "client": client}
        if priority:
            reqd["priority"] = priority
        if rem is not None:
            reqd["deadline_ms"] = rem
        if isinstance(trace_id, str) and trace_id:
            reqd["trace_id"] = trace_id
        try:
            resp = c.request(reqd)
        except ServiceError:
            # mid-request failure: the member may hold a ghost sub
            # stream — its fragment tag is burned (never reused) and
            # its idle reaper will collect the ghost, so skipping the
            # member is safe where the un-scattered path must abort
            c.close()
            self._member_down(m.name)
            return None
        if not resp.get("ok"):
            c.close()
            return None
        return {"member": m.name, "mjid": resp["job_id"], "conn": c,
                "live": True, "open": resp}

    @staticmethod
    def _scatter_cancel_sub(row: dict) -> None:
        try:
            row["conn"].request({"cmd": "cancel",
                                 "job_id": row["mjid"]})
        except ServiceError:
            pass
        row["conn"].close()
        row["live"] = False

    def _scatter_stream_frame(self, job: _FleetJob,
                              req: dict) -> dict:
        sc = job.scatter
        with self._lock:
            closed = job.terminal is not None or job.retired
        if closed or sc["ended"]:
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                f"stream {job.fid} is closed; re-open a stream with "
                "--resume to complete it")
        with sc["lock"]:
            if req.get("cmd") == "stream-end":
                err = self._scatter_end(job)
                if err is not None:
                    return err
                sc["ended"] = True
                with self._lock:
                    job.ended = True
                return protocol.ok(records=sc["state"].nrec,
                                   buffered=0)
            data = req.get("data")
            if not isinstance(data, str):
                return protocol.err(
                    protocol.ERR_BAD_REQUEST,
                    "stream-data needs a string data field")
            if data == "":
                # keepalive: fan out so no member's idle reaper
                # mistakes a slow producer for a vanished client
                k = 0
                while k < len(sc["subs"]):
                    row = sc["subs"][k]
                    k += 1
                    if not row["live"]:
                        continue
                    err = self._scatter_send(job, row,
                                             {"cmd": "stream-data",
                                              "data": ""})
                    if err is not None:
                        return err
                return protocol.ok(records=sc["state"].nrec,
                                   buffered=0)
            for text in sc["asm"].feed(data):
                err = self._scatter_record(job, text)
                if err is not None:
                    return err
            return protocol.ok(records=sc["state"].nrec, buffered=0)

    def _scatter_record(self, job: _FleetJob, text: str
                        ) -> dict | None:
        """Deal one assembled target record to its sub-stream.  The
        record is BUFFERED before it is sent: a member death mid-send
        re-partitions it from the buffer, so frames never need a
        client resend (backpressure is the router blocking the ack)."""
        sc = job.scatter
        try:
            _gidx, sub = sc["state"].assign()
        except ValueError:
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                f"stream {job.fid}: no live fleet members left for "
                "the scattered stream")
        if sc["texts"] is not None:
            sc["texts"][sub].append(text)
            sc["rbytes"] += len(text)
            if sc["rbytes"] > self.stream_replay_bytes:
                sc["texts"] = None   # window overflow: a member
                #   death now degrades to preempted-resumable
                self.obs.event("stream_window_overflow",
                               job_id=job.fid,
                               limit=self.stream_replay_bytes)
        row = sc["subs"][sub]
        return self._scatter_send(job, row, {"cmd": "stream-data",
                                             "data": text})

    def _scatter_send(self, job: _FleetJob, row: dict,
                      fwd: dict) -> dict | None:
        """One frame to one sub, queue_full absorbed by waiting (the
        client's ack is the backpressure).  None = the frame was
        delivered — directly, or by a redrive that replayed the sub's
        whole buffer onto a survivor (check ``row["live"]`` to tell)."""
        fwd = dict(fwd)
        fwd["job_id"] = row["mjid"]
        attempts = 0
        while True:
            if not row["live"]:
                return None   # a redrive re-homed this sub mid-retry
            try:
                resp = row["conn"].request(fwd)
            except ServiceError:
                return self._scatter_lost(job, row["member"])
            if resp.get("ok"):
                return None
            if resp.get("error") == protocol.ERR_QUEUE_FULL:
                attempts += 1
                if attempts > 240:   # ~60 s stuck: treat the member
                    #   as pathological and re-partition away from it
                    return self._scatter_lost(job, row["member"])
                ra = resp.get("retry_after_s")
                time.sleep(min(0.25, float(ra))
                           if isinstance(ra, (int, float)) and ra > 0
                           else 0.05)
                continue
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                f"fleet member {row['member']} rejected a scattered "
                f"frame: {resp.get('detail')}")

    def _scatter_lost(self, job: _FleetJob, name: str
                      ) -> dict | None:
        """A sub's member failed mid-frame: declare it down (which
        re-partitions every scatter job, this one included via the
        re-entrant sc lock), then answer from the outcome."""
        self._member_down(name)
        self._scatter_redrive(job, name)   # no-op if _member_down
        #   already re-homed it; covers a member that was ALREADY
        #   marked dead (broken conn on a stale row)
        with self._lock:
            dead = job.terminal is not None or job.retired
        if dead:
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                f"stream {job.fid} lost fleet member(s) past its "
                "replay window; re-open a stream with --resume and "
                "re-send the records")
        return None

    def _scatter_end(self, job: _FleetJob) -> dict | None:
        """Route the trailing record, then stream-end every live sub.
        Index-based walk: a redrive mid-loop APPENDS replacement subs,
        and they need the stream-end too."""
        sc = job.scatter
        for text in sc["asm"].finish():
            err = self._scatter_record(job, text)
            if err is not None:
                return err
        k = 0
        while k < len(sc["subs"]):
            row = sc["subs"][k]
            k += 1
            if not row["live"]:
                continue
            err = self._scatter_send(job, row, {"cmd": "stream-end"})
            if err is not None:
                return err
        return None

    def _scatter_redrive(self, job: _FleetJob, dead: str) -> None:
        """Re-partition a dead member's sub-streams wholesale onto
        survivors: each dead sub's buffered records replay — in their
        original relative order — into a fresh sub, so the positional
        row<->record mapping survives the failover unchanged."""
        sc = job.scatter
        if not sc["lock"].acquire(timeout=60):
            return    # pathological cross-job lock contention: the
            #   result waiter will land the truthful verdict later
        try:
            with self._lock:
                if job.terminal is not None or job.retired:
                    return
            dead_idx = [k for k, r in enumerate(sc["subs"])
                        if r["live"] and r["member"] == dead]
            if not dead_idx:
                return
            job.failovers += 1
            for k in dead_idx:
                row = sc["subs"][k]
                row["live"] = False
                try:
                    row["conn"].close()
                except Exception:
                    pass
            if sc["texts"] is None:
                self._scatter_abandon(job, dead)
                return
            epoch = readmit_epoch_guard(job.epoch, self.epoch)
            for k in dead_idx:
                order = sc["state"].kill(k)
                if not self._scatter_replace(job, order,
                                             sc["texts"][k], epoch):
                    self._scatter_abandon(job, dead)
                    return
            anchor = next(r["member"] for r in sc["subs"]
                          if r["live"])
            with self._lock:
                job.gen += 1
                job.epoch = epoch
                if job.member == dead:
                    # the ledger slot is keyed to job.member: keep it
                    # pointing at a member that still hosts a sub
                    self.ledger.move(job.client, dead, anchor)
                    job.member = anchor
            self.recovered["stream_replayed"] += 1
            self.metrics["recovered"].inc(how="stream_replayed")
            self.obs.event("scatter_redriven", job_id=job.fid,
                           trace_id=job.trace_id, was=dead,
                           subs=len(dead_idx))
            self._say(f"stream {job.fid}: re-partitioned "
                      f"{len(dead_idx)} sub-stream(s) off dead "
                      f"member {dead}")
        finally:
            sc["lock"].release()

    def _scatter_replace(self, job: _FleetJob, order: list,
                         texts: list, epoch: int) -> bool:
        """One replacement sub for one dead sub: open on a survivor,
        adopt the dead sub's record order, replay its buffer.  Safe to
        try several survivors — a half-fed replacement is cancelled
        and its fragment tag burned, so no path is ever written twice.
        """
        from pwasm_tpu_torch.surveil.partition import rewrite_out_args
        sc = job.scatter
        rem = self._deadline_left_ms(job)
        if rem is not None and rem <= 0:
            return False
        cands = self._members_by_depth()
        # members without a live sub first: spread before stacking
        loaded = {r["member"] for r in sc["subs"] if r["live"]}
        cands.sort(key=lambda m: m.name in loaded)
        for m in cands:
            frag_o = f"{sc['o']}.frag{sc['ntag']:02d}"
            frag_s = f"{sc['s']}.frag{sc['ntag']:02d}" \
                if sc["s"] else None
            sc["ntag"] += 1
            sargs = rewrite_out_args(sc["args"], o=frag_o, s=frag_s)
            row = self._scatter_open_sub(
                m, sargs, sc["cwd"], job.client, job.trace_id, rem,
                job.frame.get("priority"))
            if row is None:
                continue
            row.pop("open", None)
            row["o"], row["s"] = frag_o, frag_s
            k = sc["state"].add_sub()
            sc["state"].adopt(k, order)
            sc["subs"].append(row)
            sc["texts"].append(list(texts))
            with self._lock:
                mm = self.members.get(m.name)
                if mm is not None:
                    mm.jobs_routed += 1
                    mm.dispatched_since_poll += 1
            for text in texts:
                err = self._scatter_send(job, row,
                                         {"cmd": "stream-data",
                                          "data": text})
                if err is not None:
                    return False
                if not row["live"]:
                    return True   # re-redriven wholesale already
            if sc["ended"] and row["live"]:
                if self._scatter_send(job, row,
                                      {"cmd": "stream-end"}) \
                        is not None:
                    return False
            self._journal([(REC_ROUTE_PLACE,
                            {"job_id": job.fid, "member": m.name,
                             "mjid": row["mjid"], "gen": job.gen + 1,
                             "epoch": epoch, "sub": k})])
            return True
        return False

    def _scatter_abandon(self, job: _FleetJob, dead: str) -> None:
        sc = job.scatter
        for row in sc["subs"]:
            if row["live"]:
                self._scatter_cancel_sub(row)
        self.recovered["stream_preempted"] += 1
        self.metrics["recovered"].inc(how="stream_preempted")
        self._cache_terminal(job, JOB_PREEMPTED, 75, (
            f"scattered m2m stream interrupted: fleet member {dead} "
            "died and the stream could not be re-partitioned onto "
            "the survivors; every member's emitted sections are "
            "durable in its section cache — re-open a stream and "
            "re-send the records (cached targets cost no device "
            "work)"))

    def _scatter_job_dict(self, job: _FleetJob, nlive: int,
                          nrec: int) -> dict:
        return {"id": job.fid, "state": "running",
                "detail": f"scattered across {nlive} member(s), "
                          f"{nrec} record(s) assigned",
                "client": job.client, "priority": job.priority,
                "trace_id": job.trace_id, "stream": True,
                "member": job.member,
                "submitted_s": round(job.submitted_s, 3)}

    def _scatter_simple(self, job: _FleetJob, cmd: str) -> dict:
        with self._lock:
            term = job.terminal
        if term is not None:
            if cmd == "cancel":
                return protocol.ok(state=term["job"]["state"],
                                   was="terminal")
            if cmd == "inspect":
                return protocol.ok(job=dict(term["job"]),
                                   trace_id=job.trace_id,
                                   flight=None)
            return protocol.ok(job=dict(term["job"]))
        sc = job.scatter
        with sc["lock"]:
            rows = [r for r in sc["subs"] if r["live"]]
            nrec = sc["state"].nrec
            if cmd == "cancel":
                for row in rows:
                    try:
                        row["conn"].request({"cmd": "cancel",
                                             "job_id": row["mjid"]})
                    except ServiceError:
                        pass
                return protocol.ok(state="cancelling",
                                   was="scatter", subs=len(rows))
        j = self._scatter_job_dict(job, len(rows), nrec)
        if cmd == "inspect":
            return protocol.ok(job=j, trace_id=job.trace_id,
                               flight=None)
        return protocol.ok(job=j)

    def _scatter_result(self, job: _FleetJob, req: dict) -> dict:
        """Wait for every live sub's terminal, then merge: fragments
        spliced in global arrival order (surveil/partition.py), the
        summary re-derived, per-member m2m stats summed — one verdict,
        served router-side like every failover verdict."""
        wait = req.get("wait", True)
        timeout = req.get("timeout")
        deadline = time.monotonic() + float(timeout) \
            if isinstance(timeout, (int, float)) else None
        sc = job.scatter
        while True:
            with self._lock:
                term = job.terminal
            if term is not None:
                self._note_retired(job)
                return dict(term)
            expired = deadline is not None \
                and time.monotonic() >= deadline
            with sc["lock"]:
                ended = sc["ended"]
                rows = [r for r in sc["subs"] if r["live"]]
                gen = job.gen
                nrec = sc["state"].nrec
            if not ended:
                if not wait or expired:
                    return protocol.ok(
                        job=self._scatter_job_dict(job, len(rows),
                                                   nrec),
                        pending=True)
                time.sleep(0.1)
                continue
            results: list = []
            lost = False
            for row in rows:
                with self._lock:
                    m = self.members.get(row["member"])
                    alive = m is not None and m.alive
                if not alive or not row["live"]:
                    if alive:   # row re-homed by a redrive
                        lost = True
                        break
                    self._member_down(row["member"])
                    self._scatter_redrive(job, row["member"])
                    lost = True
                    break
                slice_s = 2.0
                if deadline is not None:
                    slice_s = min(slice_s, max(
                        0.05, deadline - time.monotonic()))
                try:
                    with self._dial(m.target, timeout=60.0) as c:
                        resp = c.result(row["mjid"],
                                        wait=wait and not expired,
                                        timeout=slice_s)
                except ServiceError:
                    self._member_down(row["member"])
                    self._scatter_redrive(job, row["member"])
                    lost = True
                    break
                if not resp.get("ok"):
                    return resp
                jj = resp.get("job") or {}
                if resp.get("pending") \
                        or jj.get("state") not in TERMINAL_STATES:
                    if not wait or expired:
                        return protocol.ok(
                            job=self._scatter_job_dict(
                                job, len(rows), nrec),
                            pending=True)
                    results = []
                    break   # still running: next lap re-waits
                results.append((row, resp))
            if lost:
                continue
            if len(results) != len(rows):
                continue
            with sc["lock"]:
                rows2 = [r for r in sc["subs"] if r["live"]]
                moved = job.gen != gen
            if moved or rows2 != rows:
                # a redrive raced the collection: some verdicts came
                # from the OLD placement generation — recollect
                continue
            self._scatter_finish(job, results)
            continue   # the verdict is now job.terminal — serve it

    def _scatter_finish(self, job: _FleetJob,
                        results: list) -> None:
        from pwasm_tpu_torch.surveil.partition import merge_fragments
        sc = job.scatter
        bad = [(row, resp) for row, resp in results
               if (resp.get("job") or {}).get("state") != JOB_DONE]
        if bad:
            # severity: failed > preempted > cancelled — one sub's
            # loss is the fleet job's loss (fragments are partial)
            rank = {JOB_FAILED: 0, JOB_PREEMPTED: 1,
                    JOB_CANCELLED: 2}
            row, resp = min(bad, key=lambda b: rank.get(
                (b[1].get("job") or {}).get("state"), 3))
            jj = resp.get("job") or {}
            st = jj.get("state") or JOB_FAILED
            rc = resp.get("rc") if isinstance(resp.get("rc"), int) \
                else (75 if st == JOB_PREEMPTED else None)
            self._cache_terminal(
                job, st, rc,
                f"scattered m2m sub-stream on member "
                f"{row['member']} landed {st}: "
                f"{jj.get('detail') or ''}",
                stderr_tail=str(resp.get("stderr_tail") or ""))
            return
        try:
            frags, orders, sumpaths = [], [], []
            for row, _resp in results:
                k = sc["subs"].index(row)
                orders.append(sc["state"].orders[k])
                with open(row["o"], "rb") as f:
                    frags.append(f.read())
                if row["s"]:
                    sumpaths.append(row["s"])
            merged = merge_fragments(frags, orders,
                                     sc["state"].nrec,
                                     summary=sc["s"] is not None)
            report, summ = merged if sc["s"] is not None \
                else (merged, None)
            from pwasm_tpu_torch.utils.fsio import \
                write_durable_bytes
            write_durable_bytes(sc["o"], report)
            if summ is not None:
                write_durable_bytes(sc["s"], summ)
            for row, _resp in results:   # fragments served their
                for p in (row["o"], row["s"]):   # purpose
                    if p:
                        try:
                            os.unlink(p)
                        except OSError:
                            pass
            m2m: dict = {}
            for _row, resp in results:
                sub = (resp.get("stats") or {}).get("m2m") or {}
                for k2, v in sub.items():
                    if not isinstance(v, (int, float)) \
                            or isinstance(v, bool):
                        continue
                    if k2 == "resident_queries":
                        # every sub scores against the SAME resident
                        # set — max, not sum
                        m2m[k2] = max(m2m.get(k2, 0), v)
                    else:
                        m2m[k2] = m2m.get(k2, 0) + v
            stats = {"m2m": m2m,
                     "scatter": {"subs": len(results),
                                 "records": sc["state"].nrec,
                                 "failovers": job.failovers}}
            if sc["stats_path"]:
                import json
                try:
                    write_durable_bytes(
                        sc["stats_path"],
                        json.dumps(stats, indent=2, sort_keys=True)
                        .encode("ascii") + b"\n")
                except OSError:
                    pass
            self.obs.event("scatter_merged", job_id=job.fid,
                           trace_id=job.trace_id,
                           subs=len(results),
                           records=sc["state"].nrec)
            self._cache_terminal(
                job, JOB_DONE, 0,
                f"fleet-scattered m2m: merged {len(results)} member "
                f"fragment(s), {sc['state'].nrec} target(s), "
                f"byte-identical to one un-scattered run",
                stats=stats)
        except (OSError, ValueError) as e:
            self._cache_terminal(
                job, JOB_FAILED, None,
                f"scatter merge failed: {e} — the per-member "
                "fragments are left in place for inspection")

    def _route_simple(self, job: _FleetJob, cmd: str) -> dict:
        """status / cancel / inspect: one forwarded frame, ids
        rewritten at the edge; a dead member answers from the cached
        failover verdict once one exists."""
        if job.scatter is not None:
            return self._scatter_simple(job, cmd)
        for _attempt in (0, 1):
            with self._lock:
                term = job.terminal
                m = self.members.get(job.member)
                mjid, gen = job.mjid, job.gen
            if term is not None:
                if cmd == "cancel":
                    return protocol.ok(
                        state=term["job"]["state"], was="terminal")
                if cmd == "inspect":
                    return protocol.ok(job=dict(term["job"]),
                                       trace_id=job.trace_id,
                                       flight=None)
                return protocol.ok(job=dict(term["job"]))
            if m is None or not m.alive:
                # same orphan rescue as _route_result: a job the
                # death snapshot missed must still reach a verdict
                # through a status/inspect/cancel poll (idempotent —
                # the per-job latch makes a racing health pass win)
                self._member_down(job.member)
                self._recover_job(job)
                continue
            try:
                with self._dial(m.target, timeout=30.0) as c:
                    resp = c.request({"cmd": cmd, "job_id": mjid})
            except ServiceError:
                self._member_down(job.member)
                self._recover_job(job)
                continue
            j = resp.get("job")
            if isinstance(j, dict) and j.get("state") \
                    in TERMINAL_STATES:
                with self._lock:
                    moved = job.gen != gen
                if moved:
                    # same stale-completion fence as _route_result
                    self.metrics["stale_rejected"].inc()
                    self.obs.event("stale_completion_rejected",
                                   job_id=job.fid, gen=gen,
                                   trace_id=job.trace_id)
                    continue
            return self._rewrite(resp, job)
        # recovery is still in flight (or re-placement raced us):
        # reads answer a soft in-progress state — the client's next
        # poll sees the verdict; a cancel must not pretend it acted
        if cmd == "cancel":
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                f"job {job.fid} is failing over after a member "
                "loss; retry the cancel in a moment")
        return protocol.ok(job={
            "id": job.fid, "state": "running",
            "detail": "member lost; failover in progress",
            "trace_id": job.trace_id, "member": job.member})

    def _route_result(self, job: _FleetJob, req: dict) -> dict:
        if job.scatter is not None:
            return self._scatter_result(job, req)
        wait = req.get("wait", True)
        timeout = req.get("timeout")
        deadline = time.monotonic() + float(timeout) \
            if isinstance(timeout, (int, float)) else None
        t0 = self.obs.tracer.now() \
            if self.obs.tracer is not None else 0.0
        while True:
            with self._lock:
                term = job.terminal
                m = self.members.get(job.member)
                mjid, gen = job.mjid, job.gen
            if term is not None:
                self._note_retired(job)
                if self.obs.tracer is not None:
                    self.obs.tracer.complete(
                        "route_result_wait", t0,
                        trace_id=job.trace_id, job_id=job.fid)
                return dict(term)
            expired = deadline is not None \
                and time.monotonic() >= deadline
            slice_s = 2.0
            if deadline is not None:
                slice_s = min(slice_s, max(
                    0.05, deadline - time.monotonic()))
            if m is None or not m.alive:
                # the member is dead and this job has no verdict yet.
                # Honor the CLIENT's contract first: a no-wait poll or
                # an expired timeout answers pending instead of
                # blocking on the recovery.  Then recover: normally
                # _member_down's failover already owns the job, but
                # one admitted in the gap between the death snapshot
                # and its table insertion would be orphaned forever —
                # _recover_job is idempotent (per-job latch), so
                # calling it here is safe either way.
                if not wait or expired:
                    return protocol.ok(
                        job={"id": job.fid, "state": "running",
                             "detail": "member lost; failover in "
                             "progress", "trace_id": job.trace_id,
                             "member": job.member},
                        pending=True)
                self._recover_job(job, None)
                time.sleep(0.05)
                continue
            try:
                with self._dial(m.target, timeout=60.0) as c:
                    resp = c.result(mjid,
                                    wait=wait and not expired,
                                    timeout=slice_s)
            except ServiceError:
                self._member_down(job.member)
                continue
            if not resp.get("ok"):
                return resp
            if resp.get("pending"):
                with self._lock:
                    moved = job.gen != gen
                if moved or (wait and not expired):
                    continue
                return self._rewrite(resp, job)
            with self._lock:
                moved = job.gen != gen
            if moved:
                # fencing at the router edge: this terminal reply was
                # fetched from the placement generation we snapshotted
                # BEFORE a failover re-placed the job — i.e. a stale
                # (possibly zombie) member's completion.  The newer
                # owner's verdict is the only one that counts.
                self.metrics["stale_rejected"].inc()
                self.obs.event("stale_completion_rejected",
                               job_id=job.fid, gen=gen,
                               trace_id=job.trace_id)
                continue
            self._note_retired(job)
            if self.obs.tracer is not None:
                self.obs.tracer.complete(
                    "route_result_wait", t0, trace_id=job.trace_id,
                    job_id=job.fid, member=job.member)
            return self._rewrite(resp, job)

    def _rewrite(self, resp: dict, job: _FleetJob) -> dict:
        out = dict(resp)
        j = out.get("job")
        if isinstance(j, dict):
            j = dict(j)
            j["id"] = job.fid
            j["member"] = job.member
            if job.failovers:
                j["failovers"] = job.failovers
            out["job"] = j
        return out

    @staticmethod
    def _member_health_entry(mh) -> dict:
        """One member's health dict (from a fresh RPC or its cached
        stats block) folded into the verdict-row shape; anything
        unparseable ranks ``unknown`` (aggregated as degraded —
        unknown must never read as healthy)."""
        if not isinstance(mh, dict):
            return {"verdict": "unknown", "firing": []}
        entry = {
            "verdict": str(mh.get("verdict") or "unknown"),
            "firing": [f.get("rule") for f in
                       (mh.get("firing") or [])
                       if isinstance(f, dict)],
        }
        if mh.get("canary") is not None:
            entry["canary"] = mh["canary"]
        return entry

    def _fleet_health(self, fresh: bool = True) -> dict:
        """The fleet verdict: a fresh evaluation of the
        router's own rules (member_up gauges, failover counters,
        ledger saturation) FOLDED with every live member's own
        ``health`` verdict — worst wins, so one failing member makes
        the fleet verdict failing even when the router itself is
        clean.  ``fresh=True`` (the `health` verb — a probe must see
        NOW) asks each live member over a new connection;
        ``fresh=False`` (the `stats` verb, called right after a
        synchronous member poll) folds the health block each member's
        stats reply already carries — zero extra RPCs, so a slow
        member cannot stall every `top` refresh by its timeout.  A
        DEAD member needs no verdict penalty — the router's own
        member_down rule is already firing for it."""
        from pwasm_tpu_torch.obs.slo import worst_verdict
        self._refresh_gauges()
        h = self.slo.evaluate()
        h["router"] = True
        members: dict[str, dict] = {}
        with self._lock:
            rows = [(m.name, m.target, m.alive,
                     (m.stats or {}).get("health"))
                    for m in self.members.values()]
        verdicts = [h["verdict"]]
        for name, target, alive, cached in rows:
            if not alive:
                members[name] = {"verdict": "unreachable",
                                 "firing": []}
                continue
            mh = cached
            if fresh:
                mh = None
                try:
                    with self._dial(target, timeout=3.0) as c:
                        resp = c.request({"cmd": "health"})
                    if resp.get("ok"):
                        mh = resp.get("health")
                except (ServiceError, OSError, ValueError,
                        TypeError, KeyError):
                    pass     # unknown ranks degraded below
            entry = self._member_health_entry(mh)
            verdicts.append(entry["verdict"])
            members[name] = entry
        h["members"] = members
        h["verdict"] = worst_verdict(*verdicts)
        return h

    def _fleet_stats(self) -> dict:
        """The fleet-aggregated svc-stats surface: member counters
        summed, lanes labeled by member, plus the ``fleet`` block the
        fleet-aware ``top`` renders."""
        from pwasm_tpu_torch.service.queue import SERVICE_STATS_VERSION
        jobs_sum: dict = {}
        warm_sum: dict = {}
        streams_sum: dict = {}
        lanes: list[dict] = []
        depth = running = maxc = 0
        breaker = 0
        member_rows = []
        with self._lock:
            members = list(self.members.values())
            live = sum(1 for j in self.jobs.values()
                       if not j.retired and j.terminal is None)
        for m in members:
            st = m.stats or {}
            if m.alive:
                depth += int(st.get("queue_depth") or 0)
                running += int(st.get("running") or 0)
                maxc += int(st.get("max_concurrent") or 0)
                breaker = max(breaker,
                              int(st.get("breaker_state") or 0))
                if isinstance(st.get("jobs"), dict):
                    _sum_numeric(jobs_sum, st["jobs"])
                if isinstance(st.get("warm"), dict):
                    _sum_numeric(warm_sum, st["warm"])
                if isinstance(st.get("streams"), dict):
                    _sum_numeric(streams_sum, st["streams"])
                for row in (st.get("lanes") or []):
                    if isinstance(row, dict):
                        r = dict(row)
                        r["member"] = m.name
                        lanes.append(r)
            member_rows.append({
                "name": m.name, "target": m.target,
                "alive": m.alive,
                "queue_depth": m.queue_depth if m.alive else None,
                "running": m.running if m.alive else None,
                "jobs_routed": m.jobs_routed,
                "journal": m.journal_path,
                "fenced": m.fenced,
                "scaled": m.scaled,
                # gray-failure columns — the fleet-aware
                # `top` renders quarantine state from here
                "quarantined": m.quarantined,
                "lat_ewma_ms": round(m.lat_ewma_ms, 2),
                "depth_ewma": round(m.depth_ewma, 2),
                "quarantines": m.quarantines,
            })
        return {
            "stats_version": SERVICE_STATS_VERSION,
            "protocol_version": protocol.PROTOCOL_VERSION,
            "router": True,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "draining": self._draining,
            "queue_depth": depth,
            "running": running,
            "breaker_state": breaker,
            "max_queue": self.ledger.max_queue,
            "max_concurrent": maxc,
            "jobs": jobs_sum,
            "warm": warm_sum,
            "streams": streams_sum,
            "cache": self.cache.stats_dict()
            if self.cache is not None else {"enabled": False},
            "lanes": lanes,
            "fair_share": {
                "max_queue_per_client": self.ledger.max_queue,
                "max_queue_total": self.ledger.max_total,
                "clients": {(c or "default"): n for c, n in
                            self.ledger.client_depths().items()},
            },
            "fleet": {
                "members": member_rows,
                "alive": sum(1 for m in members if m.alive),
                "failovers": self.failovers,
                "jobs_routed": self.ledger.admitted,
                "jobs_recovered": dict(self.recovered),
                "live_jobs": live,
                "quarantined": sum(1 for m in members
                                   if m.alive and m.quarantined),
            },
            # router HA — WAL, epoch fencing, takeover provenance and
            # the scaler's accounting
            "ha": {
                "epoch": self.epoch,
                "takeover": self.takeover,
                "lease_ttl_s": self.lease_ttl_s,
                "stream_replay_bytes": self.stream_replay_bytes,
                "members_fenced": sum(
                    1 for m in members if m.alive and m.fenced),
                "journal": {
                    "path": self.rjournal.path
                    if self.rjournal is not None else None,
                    "records": self.rjournal.records_written
                    if self.rjournal is not None else 0,
                    "broken": self.rjournal.broken
                    if self.rjournal is not None else None,
                },
                "scaler": self.scaler.stats_dict()
                if self.scaler is not None else {"enabled": False},
                # gray-failure defense — the
                # quarantine policy in force and the live brownout
                # shed state (0 = admitting every tier)
                "quarantine": {
                    "x": self.quarantine_x,
                    "probation": self.quarantine_probation,
                    "members": sum(1 for m in members
                                   if m.alive and m.quarantined),
                },
                "shed": {
                    "level": self._shed_level,
                    "priority_lanes": list(self.priority_lanes),
                    "lanes_shed": list(
                        self.priority_lanes[len(self.priority_lanes)
                                            - self._shed_level:])
                    if self._shed_level > 0 else [],
                },
            },
            # the aggregated fleet verdict —
            # the fleet-aware `top`'s alerts pane reads it here.
            # fresh=False: the member poll the stats verb just ran
            # already carries each member's health block — no second
            # RPC round
            "health": self._fleet_health(fresh=False),
        }


def route_main(argv: list[str], stdout=None, stderr=None) -> int:
    """The ``pwasm-tpu route`` entry point."""
    stderr = stderr if stderr is not None else sys.stderr
    opts: dict[str, str] = {}
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
        elif a in ("-h", "--help"):
            stderr.write(_ROUTE_USAGE)
            return EXIT_USAGE
        else:
            stderr.write(f"{_ROUTE_USAGE}\nInvalid argument: {a}\n")
            return EXIT_USAGE
    standby_of = opts.pop("standby-of", None)
    backends = [b for b in
                (opts.pop("backends", "") or "").split(",") if b]
    sock = opts.pop("socket", None)
    listen = opts.pop("listen", None)
    if standby_of is not None:
        # a standby's whole identity comes from the primary's journal
        # — a flag-supplied member set or endpoint would let the two
        # disagree about the fleet, which is exactly the split-brain
        # the journal exists to prevent.  Refuse LOUDLY.
        if backends:
            stderr.write(f"{_ROUTE_USAGE}\nError: --standby-of and "
                         "--backends are mutually exclusive — the "
                         "standby inherits the member set from the "
                         "primary's journal (its last `members` "
                         "record), never from flags\n")
            return EXIT_USAGE
        if sock or listen:
            stderr.write(f"{_ROUTE_USAGE}\nError: --standby-of and "
                         "--socket/--listen are mutually exclusive — "
                         "on takeover the standby binds the "
                         "PRIMARY's socket (that is the point)\n")
            return EXIT_USAGE
    elif not backends:
        stderr.write(f"{_ROUTE_USAGE}\nError: --backends=TARGET"
                     "[,TARGET...] is required\n")
        return EXIT_USAGE
    elif not sock and not listen:
        stderr.write(f"{_ROUTE_USAGE}\nError: --socket=PATH and/or "
                     "--listen=HOST:PORT is required\n")
        return EXIT_USAGE
    if listen is not None:
        if not is_tcp_target(listen):
            stderr.write(f"{_ROUTE_USAGE}\nInvalid --listen value: "
                         f"{listen} (HOST:PORT)\n")
            return EXIT_USAGE
    nums: dict[str, int | None] = {}
    for knob, dflt in (("max-queue", 64), ("max-queue-total", None),
                       ("max-results", 4096)):
        val = opts.pop(knob, None)
        if val is None:
            nums[knob] = dflt
        elif val.isascii() and val.isdigit() and int(val) >= 1:
            nums[knob] = int(val)
        else:
            stderr.write(f"{_ROUTE_USAGE}\nInvalid --{knob} value: "
                         f"{val}\n")
            return EXIT_USAGE
    poll = 0.5
    val = opts.pop("poll-interval", None)
    if val is not None:
        import math
        try:
            poll = float(val)
            if poll <= 0 or not math.isfinite(poll):
                raise ValueError
        except (TypeError, ValueError):
            stderr.write(f"{_ROUTE_USAGE}\nInvalid --poll-interval "
                         f"value: {val}\n")
            return EXIT_USAGE
    lease_ttl = DEFAULT_LEASE_TTL_S
    val = opts.pop("lease-ttl", None)
    if val is not None:
        import math
        try:
            lease_ttl = float(val)
            if lease_ttl <= 0 or not math.isfinite(lease_ttl):
                raise ValueError
        except (TypeError, ValueError):
            stderr.write(f"{_ROUTE_USAGE}\nInvalid --lease-ttl "
                         f"value: {val}\n")
            return EXIT_USAGE
    stream_replay_bytes = 4 << 20
    val = opts.pop("stream-replay-bytes", None)
    if val is not None:
        if val.isascii() and val.isdigit():
            stream_replay_bytes = int(val)
        else:
            stderr.write(f"{_ROUTE_USAGE}\nInvalid "
                         f"--stream-replay-bytes value: {val}\n")
            return EXIT_USAGE
    priority_lanes: tuple[str, ...] | None = None
    val = opts.pop("priority-lanes", None)
    if val is not None:
        from pwasm_tpu_torch.service.daemon import _CLIENT_RE
        lanes = [l.strip() for l in val.split(",")]
        if (not lanes or any(not l or not _CLIENT_RE.match(l)
                             for l in lanes)
                or len(set(lanes)) != len(lanes)):
            stderr.write(f"{_ROUTE_USAGE}\nInvalid --priority-lanes "
                         f"value: {val}\n")
            return EXIT_USAGE
        priority_lanes = tuple(lanes)
    quarantine_x = 4.0
    val = opts.pop("quarantine-x", None)
    if val is not None:
        import math
        try:
            quarantine_x = float(val)
            if quarantine_x < 0 or not math.isfinite(quarantine_x) \
                    or (0 < quarantine_x < 1.0):
                raise ValueError
        except (TypeError, ValueError):
            stderr.write(f"{_ROUTE_USAGE}\nInvalid --quarantine-x "
                         f"value: {val} (a multiple >= 1, or 0 to "
                         "disable)\n")
            return EXIT_USAGE
    quarantine_probation = 3
    val = opts.pop("quarantine-probation", None)
    if val is not None:
        if val.isascii() and val.isdigit() and int(val) >= 1:
            quarantine_probation = int(val)
        else:
            stderr.write(f"{_ROUTE_USAGE}\nInvalid "
                         f"--quarantine-probation value: {val}\n")
            return EXIT_USAGE
    scale_policy = None
    val = opts.pop("scale-policy", None)
    if val is not None:
        from pwasm_tpu_torch.fleet.scaler import load_scale_policy
        try:
            scale_policy = load_scale_policy(val)
        except ValueError as e:
            stderr.write(f"{_ROUTE_USAGE}\nError: {e}\n")
            return EXIT_USAGE
    journal_dir = opts.pop("journal-dir", None)
    result_cache = opts.pop("result-cache", None)
    if result_cache == "off" or (result_cache is not None
                                 and not result_cache.strip()):
        result_cache = None
    result_cache_max_bytes = None
    val = opts.pop("result-cache-max-bytes", None)
    if val is not None:
        if val.isascii() and val.isdigit() and int(val) >= 1:
            result_cache_max_bytes = int(val)
        else:
            stderr.write(f"{_ROUTE_USAGE}\nInvalid "
                         f"--result-cache-max-bytes value: {val}\n")
            return EXIT_USAGE
    metrics_textfile = opts.pop("metrics-textfile", None)
    log_json = opts.pop("log-json", None)
    trace_json = opts.pop("trace-json", None)
    slo_rules = None
    val = opts.pop("slo-rules", None)
    if val is not None:
        if val == "off":
            slo_rules = "off"
        else:
            from pwasm_tpu_torch.obs.slo import load_rules_file
            try:
                slo_rules = load_rules_file(val)
            except ValueError as e:
                stderr.write(f"{_ROUTE_USAGE}\nError: {e}\n")
                return EXIT_USAGE
    max_frame_bytes = protocol.MAX_FRAME_BYTES
    val = opts.pop("max-frame-bytes", None)
    if val is not None:
        if val.isascii() and val.isdigit() and int(val) >= 1:
            max_frame_bytes = int(val)
        else:
            stderr.write(f"{_ROUTE_USAGE}\nInvalid "
                         f"--max-frame-bytes value: {val}\n")
            return EXIT_USAGE
    tls_cert = opts.pop("tls-cert", None)
    tls_key = opts.pop("tls-key", None)
    tls_client_ca = opts.pop("tls-client-ca", None)
    if (tls_cert is None) != (tls_key is None):
        stderr.write(f"{_ROUTE_USAGE}\nError: --tls-cert and "
                     "--tls-key must be given together\n")
        return EXIT_USAGE
    if tls_client_ca is not None and tls_cert is None:
        stderr.write(f"{_ROUTE_USAGE}\nError: --tls-client-ca "
                     "requires --tls-cert/--tls-key\n")
        return EXIT_USAGE
    tls = None
    if tls_cert is not None:
        from pwasm_tpu_torch.fleet.transport import ServerTLS
        try:
            tls = ServerTLS(tls_cert, tls_key,
                            client_ca=tls_client_ca)
        except ValueError as e:
            stderr.write(f"{_ROUTE_USAGE}\nError: {e}\n")
            return EXIT_USAGE
    member_tls_ca = opts.pop("member-tls-ca", None)
    member_tls_cert = opts.pop("member-tls-cert", None)
    member_tls_key = opts.pop("member-tls-key", None)
    if (member_tls_cert is None) != (member_tls_key is None):
        stderr.write(f"{_ROUTE_USAGE}\nError: --member-tls-cert and "
                     "--member-tls-key must be given together\n")
        return EXIT_USAGE
    if member_tls_cert is not None and member_tls_ca is None:
        stderr.write(f"{_ROUTE_USAGE}\nError: --member-tls-cert/"
                     "--member-tls-key need --member-tls-ca=PEM\n")
        return EXIT_USAGE
    member_tls = None
    if member_tls_ca is not None:
        from pwasm_tpu_torch.fleet.transport import ClientTLS
        try:
            member_tls = ClientTLS(member_tls_ca,
                                   certfile=member_tls_cert,
                                   keyfile=member_tls_key)
        except ValueError as e:
            stderr.write(f"{_ROUTE_USAGE}\nError: {e}\n")
            return EXIT_USAGE
    member_token = opts.pop("member-token", None)
    auth_tokens = opts.pop("auth-tokens", None)
    if auth_tokens is not None and not auth_tokens.strip():
        stderr.write(f"{_ROUTE_USAGE}\nInvalid --auth-tokens "
                     "value: must name a token file\n")
        return EXIT_USAGE
    rate_limit = None
    val = opts.pop("rate-limit", None)
    if val is not None:
        from pwasm_tpu_torch.service.queue import parse_rate_limit
        try:
            rate_limit = parse_rate_limit(val)
        except ValueError as e:
            stderr.write(f"{_ROUTE_USAGE}\nInvalid --rate-limit "
                         f"value: {val} ({e})\n")
            return EXIT_USAGE
    if opts:
        stderr.write(f"{_ROUTE_USAGE}\nInvalid argument: "
                     f"--{next(iter(opts))}\n")
        return EXIT_USAGE
    router_kwargs = dict(
        journal_dir=journal_dir,
        max_queue=nums["max-queue"],
        max_queue_total=nums["max-queue-total"],
        max_results=nums["max-results"],
        poll_interval=poll, stderr=stderr,
        metrics_textfile=metrics_textfile,
        log_json=log_json, trace_json=trace_json,
        slo_rules=slo_rules,
        result_cache=result_cache,
        result_cache_max_bytes=result_cache_max_bytes,
        lease_ttl_s=lease_ttl, scale_policy=scale_policy,
        stream_replay_bytes=stream_replay_bytes,
        priority_lanes=priority_lanes,
        quarantine_x=quarantine_x,
        quarantine_probation=quarantine_probation,
        max_frame_bytes=max_frame_bytes,
        tls=tls, member_tls=member_tls, member_token=member_token,
        auth_tokens=auth_tokens, rate_limit=rate_limit)
    if standby_of is not None:
        from pwasm_tpu_torch.fleet.standby import run_standby
        return run_standby(standby_of, stderr=stderr,
                           router_kwargs=router_kwargs)
    try:
        router = Router(backends, socket_path=sock, listen=listen,
                        **router_kwargs)
    except ValueError as e:
        stderr.write(f"{_ROUTE_USAGE}\nError: {e}\n")
        return EXIT_USAGE
    try:
        return router.serve()
    except PwasmError as e:
        stderr.write(str(e))
        return e.exit_code
