"""Fair-share job queue with per-client admission control + counters.

Counterpart of ``pwasm_tpu/service/queue.py``, with its names.  The
queue is the daemon's *admission control* point: a serving process
that accepts unboundedly is just an OOM with extra steps.  Two rules
shape it:

- **per-client fair share**: jobs are grouped by *client identity*
  (socket-peer uid, or an explicit ``client=`` submit field) and
  dequeued by weighted deficit-round-robin over the clients — a
  500-job submitter and a 1-job submitter both make progress, and
  within one client order stays strict FIFO (predictable completion
  order per submitter is part of the contract).  Optional
  ``--priority-lanes=hi,lo`` adds strict priority *tiers* above the
  round-robin: a higher lane is always served before a lower one,
  with DRR fairness among the clients inside each lane;
- **per-client depth quotas**: ``max_queue`` is the PER-CLIENT queued
  ceiling (the old single global cliff let one heavy submitter eat
  every slot, turning admission control into a denial of service for
  everyone else); :class:`QueueFull` now names the client at quota.
  ``max_total`` (default ``8 * max_queue``) keeps the global
  memory-bound backstop.

``submit`` fails fast with :class:`QueueFull` (the protocol's
``queue_full`` — 429-shaped: the caller backs off and retries) and
with :class:`Draining` once a drain began.

:class:`ServiceStats` is the service-level mirror of the per-job
``RunStats``: admission/outcome counters plus a numeric roll-up of
every finished job's stats JSON — the ``stats`` protocol response is
versioned (``stats_version``) because a service consumer reads it
programmatically, not a human eyeball.
"""

from __future__ import annotations

import io
import threading
import time
from collections import deque
from dataclasses import dataclass, field

JOB_QUEUED = "queued"
JOB_RUNNING = "running"
JOB_DONE = "done"
JOB_FAILED = "failed"
JOB_PREEMPTED = "preempted"    # drained mid-run (or before starting):
#                                resumable via --resume
JOB_CANCELLED = "cancelled"

TERMINAL_STATES = (JOB_DONE, JOB_FAILED, JOB_PREEMPTED, JOB_CANCELLED)

SERVICE_STATS_VERSION = 1


class QueueFull(Exception):
    """Admission rejected: the bounded queue is at capacity."""


class Draining(Exception):
    """Admission rejected: the service is draining (no new jobs)."""


@dataclass
class Job:
    """One submitted report job and its whole lifecycle record."""

    id: str
    argv: list
    state: str = JOB_QUEUED
    rc: int | None = None
    detail: str = ""
    cancel_requested: bool = False
    client: str = ""                   # fair-share identity (peer uid
    #   or the submit frame's client= field); "" = anonymous bucket
    priority: str = ""                 # priority lane ("" = default)
    trace_id: str = ""                 # cross-process trace identity
    #  : minted by the submitting ServiceClient (or the
    #   daemon when the frame carried none), stamped into the journal,
    #   event-log lines, both sides' Chrome traces, and the flight
    #   record — one greppable id for a job's whole life
    flight: object = field(default=None, repr=False)  # the job's
    #   obs.flight.FlightRecorder (phase walls + event ring), served
    #   by the `inspect` verb and spooled with the result
    prefer_lane: int | None = None     # device-lane affinity hint (a
    #   journal-recovered job asks for the lane it ran on; a stream
    #   job asks for the lane its client's last stream warmed)
    stream: bool = False               # socket-streamed job: input
    #   arrives as stream-data frames, not a file
    feed: object = field(default=None, repr=False)  # the job's
    #   StreamFeed (stream.pafstream) when stream is True
    recovered: bool = False            # re-admitted by journal replay
    seq: int = 0                       # global admission order (drain
    #   and journal replay preserve it across the per-client deques)
    spool: dict | None = None          # disk-spooled result index
    #   ({path, bytes}): the RAM-resident stats/stderr_tail moved to
    #   the spool dir — see daemon._spool_result
    deadline_ms: int | None = None     # REMAINING end-to-end budget
    #   (integer ms) as of admission, from the submit frame's
    #   deadline_ms.  None = no deadline: behavior is
    #   byte-identical to before the field existed.  The worker
    #   subtracts the monotonic time since submitted_mono (queue +
    #   lease wait) before exec; a spent budget lands terminal
    #   deadline_exceeded without running.
    submitted_s: float = field(default_factory=time.time)
    submitted_mono: float = field(default_factory=time.monotonic)
    #   monotonic twin of submitted_s: queue-wait and deadline
    #   arithmetic use THIS (a wall-clock step must never fake a
    #   deadline expiry or an EWMA spike)
    started_s: float | None = None
    finished_s: float | None = None
    accessed_s: float = field(default_factory=time.time)  # last
    #   status/result touch — the LRU clock for --max-results eviction
    stats: dict | None = None          # the job's RunStats JSON
    stats_path: str | None = None
    stats_injected: bool = False       # daemon-owned stats tmp file
    cache: object = field(default=None, repr=False)  # (key,
    #   classified) of a cacheable job that MISSED at admission: the
    #   finished outputs insert under it (service/cache.py)
    delta: tuple | None = field(default=None, repr=False)  # (records
    #   served, records total) of a job re-armed at admission as a
    #   --resume over a cached same-family input prefix
    dstate: dict | None = field(default=None, repr=False)  # a delta
    #   stream's state: while "holding", stream-data frames are
    #   classified against the cache's per-line digest columns BEFORE
    #   the job enters the queue; once "resolved" the daemon keeps
    #   mirroring the digest column so a cleanly finished stream
    #   inserts a delta-indexed entry of its own
    stderr_tail: str = ""
    # per-job drain flag: the daemon's SIGTERM (or a cancel) requests
    # it, and the job's cli.run honors it at the next batch boundary —
    # created at submit time so a drain arriving before the job starts
    # still has a flag to pull
    drain: object = field(default=None, repr=False)
    errbuf: io.StringIO = field(default_factory=io.StringIO, repr=False)
    outbuf: io.StringIO = field(default_factory=io.StringIO, repr=False)
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)

    def describe(self) -> dict:
        return {
            "id": self.id,
            "state": self.state,
            "rc": self.rc,
            "detail": self.detail,
            "cancel_requested": self.cancel_requested,
            "client": self.client,
            "priority": self.priority,
            "trace_id": self.trace_id,
            "stream": self.stream,
            "recovered": self.recovered,
            "submitted_s": round(self.submitted_s, 3),
            "started_s": round(self.started_s, 3)
            if self.started_s else None,
            "finished_s": round(self.finished_s, 3)
            if self.finished_s else None,
        }


class _LaneSched:
    """Weighted deficit-round-robin state for ONE priority lane: a
    strict-FIFO deque per client, a client rotation, and per-client
    deficit counters.  Unit job cost, so with equal weights DRR
    degenerates to plain round-robin over clients — the property the
    fair-share acceptance gate tests (a 1-job submitter never waits
    behind a 500-job submitter's whole backlog)."""

    __slots__ = ("clients", "rr", "deficit")

    def __init__(self) -> None:
        self.clients: dict[str, deque[Job]] = {}
        self.rr: deque[str] = deque()      # client service rotation
        self.deficit: dict[str, float] = {}

    def push(self, job: Job) -> None:
        q = self.clients.get(job.client)
        if q is None:
            q = self.clients[job.client] = deque()
            self.rr.append(job.client)
            self.deficit[job.client] = 0.0
        q.append(job)

    def empty(self) -> bool:
        return not any(self.clients.values())

    def _drop_if_empty(self, client: str) -> None:
        if client in self.clients and not self.clients[client]:
            del self.clients[client]
            del self.deficit[client]
            try:
                self.rr.remove(client)
            except ValueError:
                pass

    def pop(self, weight_of) -> Job | None:
        """One DRR dequeue: the head-of-rotation client is credited
        its weight ONCE per visit (only when its deficit no longer
        covers a job — the mid-burst guard), then serves its OLDEST
        job per unit of deficit; the rotation advances when the burst
        is paid out, so a weight-2 client yields two jobs per rotation
        to a weight-1 client's one.  Weights are clamped positive, so
        deficits grow every full rotation and the loop always
        terminates on a non-empty lane; the credit guard also caps any
        deficit at ``1 + weight`` (no unbounded credit hoarding)."""
        while self.rr:
            c = self.rr[0]
            q = self.clients.get(c)
            if not q:
                self._drop_if_empty(c)
                continue
            if self.deficit[c] < 1.0:    # a fresh visit, not mid-burst
                self.deficit[c] += max(0.05, float(weight_of(c)))
            if self.deficit[c] >= 1.0:
                job = q.popleft()
                self.deficit[c] -= 1.0
                if self.deficit[c] < 1.0 or not q:
                    self.rr.rotate(-1)   # burst paid out: next take
                    #                      serves the NEXT client
                self._drop_if_empty(c)
                return job
            self.rr.rotate(-1)
        return None


class JobQueue:
    """Thread-safe fair-share queue: per-client quotas at admission,
    weighted deficit-round-robin over clients at dequeue, optional
    strict priority lanes above both, and a draining latch.

    ``max_queue`` is the PER-CLIENT depth quota (the global cliff it
    replaces let one heavy submitter starve everyone — see the module
    docstring); ``max_total`` (default ``8 * max_queue``) bounds the
    whole queue.  A single-client workload behaves exactly like the
    old bounded FIFO: same quota arithmetic, same FIFO order."""

    def __init__(self, max_queue: int = 16,
                 max_total: int | None = None,
                 priority_lanes: tuple[str, ...] | None = None):
        self.max_queue = max(1, int(max_queue))
        self.max_total = max(self.max_queue, int(max_total)) \
            if max_total is not None else self.max_queue * 8
        # priority tiers, highest first; () / None = one anonymous lane
        self.priority_lanes = tuple(priority_lanes) \
            if priority_lanes else ("",)
        self._sched = {lane: _LaneSched()
                       for lane in self.priority_lanes}
        self._count = 0
        self._client_counts: dict[str, int] = {}
        self._weights: dict[str, float] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def depth(self) -> int:
        with self._lock:
            return self._count

    def client_depths(self) -> dict[str, int]:
        """Queued-job count per client (the
        ``pwasm_service_client_queue_depth`` gauge source)."""
        with self._lock:
            return dict(self._client_counts)

    def set_client_weight(self, client: str, weight: float) -> None:
        """Set a client's DRR weight (default 1.0): a weight-2 client
        is served two jobs per rotation for every one a weight-1
        client gets.  Clamped positive."""
        with self._lock:
            self._weights[client] = max(0.05, float(weight))

    def _weight_of(self, client: str) -> float:
        return self._weights.get(client, 1.0)

    def submit(self, job: Job) -> int:
        """Admit ``job``; returns the number of jobs queued ahead of
        it.  Raises :class:`Draining` / :class:`QueueFull` — admission
        decisions are exceptions, not silent drops, so the protocol
        layer can answer with the right wire code.  ``job.priority``
        must be one of the configured lanes (the daemon validates the
        submit field before it gets here)."""
        lane = job.priority or self.priority_lanes[-1]
        with self._cond:
            if self._draining:
                raise Draining("service is draining")
            if lane not in self._sched:
                raise QueueFull(f"unknown priority lane {lane!r}")
            if self._client_counts.get(job.client, 0) \
                    >= self.max_queue:
                raise QueueFull(
                    f"client {job.client or 'default'!s} at queue "
                    f"quota ({self.max_queue})")
            if self._count >= self.max_total:
                raise QueueFull(
                    f"queue at total capacity ({self.max_total})")
            pos = self._count
            job.seq = self._seq
            self._seq += 1
            self._sched[lane].push(job)
            self._count += 1
            self._client_counts[job.client] = \
                self._client_counts.get(job.client, 0) + 1
            self._cond.notify()
            return pos

    def _pop_locked(self) -> Job | None:
        for lane in self.priority_lanes:   # strict tiers, high first
            job = self._sched[lane].pop(self._weight_of)
            if job is not None:
                self._count -= 1
                self._uncount_client(job.client)
                return job
        return None

    def _uncount_client(self, client: str) -> None:
        n = self._client_counts.get(client, 0) - 1
        if n > 0:
            self._client_counts[client] = n
        else:
            self._client_counts.pop(client, None)

    def take(self, timeout: float | None = None) -> Job | None:
        """Dequeue the next job by priority tier then client fair
        share (FIFO within a client); None on timeout or when draining
        emptied the queue."""
        with self._cond:
            if not self._count:
                self._cond.wait(timeout)
            if not self._count:
                return None
            return self._pop_locked()

    def remove(self, job: Job) -> bool:
        """Remove a still-queued job (the queued-cancel path)."""
        with self._lock:
            lane = job.priority or self.priority_lanes[-1]
            sched = self._sched.get(lane)
            if sched is None:
                return False
            q = sched.clients.get(job.client)
            if not q:
                return False
            try:
                q.remove(job)
            except ValueError:
                return False
            sched._drop_if_empty(job.client)
            self._count -= 1
            self._uncount_client(job.client)
            return True

    def drain(self) -> list[Job]:
        """Latch the draining state (every later ``submit`` raises
        :class:`Draining`) and return the jobs that were still queued
        in ADMISSION order — the daemon marks them preempted-
        resumable, never starts them."""
        with self._cond:
            self._draining = True
            return self._empty_locked()

    def preempt_all(self) -> list[Job]:
        """Empty the queue WITHOUT latching the draining state — the
        epoch-fence path (``fleet/fencing.py``): queued jobs
        are preempted now, but admission re-opens the moment a lease
        grant un-fences the member.  A fence is a pause; a drain is an
        exit."""
        with self._cond:
            return self._empty_locked()

    def _empty_locked(self) -> list[Job]:
        waiting: list[Job] = []
        for sched in self._sched.values():
            for q in sched.clients.values():
                waiting.extend(q)
            sched.clients.clear()
            sched.rr.clear()
            sched.deficit.clear()
        waiting.sort(key=lambda j: j.seq)
        self._count = 0
        self._client_counts.clear()
        self._cond.notify_all()
        return waiting


class StreamBook:
    """Per-stream admission quotas + fair-share buffer arbitration
   .

    A stream job's records live in its :class:`~pwasm_tpu_torch.stream.
    pafstream.StreamFeed` buffer between the ``stream-data`` frame
    that carried them and the worker that drains them.  Unbounded,
    that buffer is the same OOM-with-extra-steps the job queue's
    admission control exists to prevent — so every feed is gated here
    BEFORE the chunk is committed:

    - **per-stream quota** (``max_buffer`` records, the ``serve
      --stream-buffer`` knob): one stream whose producer outruns its
      consumer answers ``queue_full`` (the protocol's 429 — the client
      backs off on ``retry_backoff_s`` and resends the same frame);
    - **fair share under the global ceiling** (``max_total``, default
      ``4 x max_buffer``): once the streams TOGETHER hit the ceiling,
      a feed is admitted only while that stream sits at or under its
      equal credit share (``max_total / active_streams`` — unit-cost
      DRR degenerates to exactly this equal rotation, the same
      property :class:`_LaneSched` documents).  A heavy stream at the
      ceiling gets backpressure while a light one under its share
      keeps feeding: heavy cannot starve light, the fair-share
      acceptance leg.

    Scheduling BETWEEN stream jobs (which one a worker picks up) rides
    the existing weighted-DRR-over-clients dequeue above — streams are
    ordinary jobs to the queue.  Checks are all-or-nothing per frame,
    so a rejected frame is resendable verbatim."""

    def __init__(self, max_buffer: int = 512,
                 max_total: int | None = None):
        self.max_buffer = max(1, int(max_buffer))
        self.max_total = max(self.max_buffer, int(max_total)) \
            if max_total is not None else self.max_buffer * 4
        self._streams: dict[str, tuple[str, object]] = {}
        self._clients_seen: set[str] = set()   # label universe for the
        #   lag gauge: a finished stream's client reads 0, not gone
        self._done = {"records_in": 0, "records_out": 0, "batches": 0}
        #   retired streams' flow counters — svc-stats totals stay
        #   cumulative after a stream finishes
        self._lock = threading.Lock()

    def register(self, job_id: str, client: str, feed) -> None:
        with self._lock:
            self._streams[job_id] = (client, feed)
            self._clients_seen.add(client)

    def unregister(self, job_id: str) -> None:
        with self._lock:
            row = self._streams.pop(job_id, None)
            if row is not None:
                feed = row[1]
                self._done["records_in"] += feed.records_in
                self._done["records_out"] += feed.records_out
                self._done["batches"] += feed.batches

    def active(self) -> int:
        with self._lock:
            return len(self._streams)

    def admit(self, job_id: str, n: int) -> None:
        """Gate ``n`` more records into ``job_id``'s buffer; raises
        :class:`QueueFull` (quota or fair-share — the message names
        which) instead of admitting.  Unknown streams admit freely:
        the daemon validates the job before calling here.

        A stream whose buffer is EMPTY always admits, even a frame
        larger than the whole quota: the protocol's backoff contract
        is "resend the same frame", so a frame that could never fit
        would livelock the retry dance on an otherwise idle daemon.
        Progress beats strictness — the overage is bounded by one
        already-received frame per stream (the frame ceiling bounds
        its size), and the very next frame backpressures until the
        job drains the buffer back under quota."""
        with self._lock:
            row = self._streams.get(job_id)
            if row is None:
                return
            _client, feed = row
            buffered = feed.buffered
            if not buffered:
                return
            if buffered + n > self.max_buffer:
                raise QueueFull(
                    f"stream {job_id} at its buffer quota "
                    f"({self.max_buffer} records)")
            total = sum(f.buffered
                        for _c, f in self._streams.values())
            if total + n > self.max_total:
                share = max(1, self.max_total
                            // max(1, len(self._streams)))
                if buffered + n > share:
                    raise QueueFull(
                        f"streams at the global buffer ceiling "
                        f"({self.max_total} records); stream "
                        f"{job_id} is over its fair share ({share})")

    def totals(self) -> dict:
        """The roll-up the ``svc-stats`` ``streams`` block reports:
        ``active``/``buffered`` are live, the flow counters are
        cumulative over the daemon's whole life (live + retired)."""
        with self._lock:
            feeds = [f for _c, f in self._streams.values()]
            return {
                "active": len(feeds),
                "buffered": sum(f.buffered for f in feeds),
                "records_in": self._done["records_in"]
                + sum(f.records_in for f in feeds),
                "records_out": self._done["records_out"]
                + sum(f.records_out for f in feeds),
                "batches": self._done["batches"]
                + sum(f.batches for f in feeds),
            }

    def client_lag(self) -> dict[str, int]:
        """Buffered (fed-but-unconsumed) records per client — the
        ``pwasm_stream_lag_records`` gauge source.  Every client that
        ever streamed keeps a series at 0 (a vanished series reads as
        a scrape gap, not an emptied buffer)."""
        with self._lock:
            out = {c: 0 for c in self._clients_seen}
            for client, feed in self._streams.values():
                out[client] = out.get(client, 0) + feed.buffered
            return out

    def client_lag_age(self) -> dict[str, float]:
        """Age of the oldest unconsumed record per client (worst
        stream wins) — the ``pwasm_stream_lag_age_seconds`` gauge
        source; same every-client-keeps-a-series rule as
        :meth:`client_lag`."""
        with self._lock:
            streams = list(self._streams.values())
            out = {c: 0.0 for c in self._clients_seen}
        for client, feed in streams:
            age = feed.lag_age_s() if hasattr(feed, "lag_age_s") \
                else 0.0
            out[client] = max(out.get(client, 0.0), age)
        return out


class ServiceStats:
    """Service-level counters + the numeric roll-up of job RunStats."""

    def __init__(self) -> None:
        self.t0 = time.time()
        self.t0_mono = time.monotonic()   # uptime arithmetic uses the
        #   monotonic twin: an NTP step must not fake (or hide) uptime
        self.jobs_accepted = 0
        self.jobs_rejected = 0        # queue_full admissions
        self.jobs_rejected_draining = 0
        self.jobs_completed = 0
        self.jobs_failed = 0
        self.jobs_preempted = 0
        self.jobs_deadline_exceeded = 0   # subset of preempted whose
        #                                   drain reason was a spent
        #                                   --deadline-s budget
        self.jobs_cancelled = 0
        self.jobs_evicted = 0         # terminal results dropped by
        #                               --result-ttl-s / --max-results
        self.jobs_recovered = 0       # re-admitted by journal replay
        #                               after a daemon crash
        self.journal_replays = 0      # startup replays performed
        self._rollup: dict = {}
        self._lock = threading.Lock()

    def rollup_job(self, stats: dict | None) -> None:
        """Fold one finished job's RunStats JSON into the service
        roll-up (numeric leaves summed, dicts recursed, the schema tag
        and derived rates skipped — summing versions or rates would be
        nonsense)."""
        if not isinstance(stats, dict):
            return
        with self._lock:
            _sum_numeric(self._rollup, stats,
                         skip=("stats_version", "aligned_bases_per_s",
                               "preempted"))

    def as_dict(self, queue_depth: int = 0, running: int = 0,
                draining: bool = False, max_queue: int = 0,
                max_concurrent: int = 0,
                breaker_state: int = 0) -> dict:
        from pwasm_tpu_torch.service.protocol import PROTOCOL_VERSION
        with self._lock:
            rollup = _copy_tree(self._rollup)
        backend = rollup.get("backend", {})
        return {
            "stats_version": SERVICE_STATS_VERSION,
            "protocol_version": PROTOCOL_VERSION,
            "uptime_s": round(time.monotonic() - self.t0_mono, 3),
            "draining": draining,
            # queue_depth / running / breaker_state are SOURCED FROM
            # the daemon's metrics registry (the Prometheus surface):
            # one producer, two renderings, so svc-stats and a scrape
            # cannot disagree
            "queue_depth": queue_depth,
            "running": running,
            "breaker_state": breaker_state,
            "max_queue": max_queue,
            "max_concurrent": max_concurrent,
            "jobs": {
                "accepted": self.jobs_accepted,
                "rejected": self.jobs_rejected,
                "rejected_draining": self.jobs_rejected_draining,
                "completed": self.jobs_completed,
                "failed": self.jobs_failed,
                "preempted": self.jobs_preempted,
                "deadline_exceeded": self.jobs_deadline_exceeded,
                "cancelled": self.jobs_cancelled,
                "evicted": self.jobs_evicted,
                "recovered": self.jobs_recovered,
            },
            # the warm-pool promise, observable: probes paid vs probe
            # checks answered from the warm process state
            "warm": {
                "backend_probes": backend.get("probes", 0),
                "backend_warm_hits": backend.get("warm_hits", 0),
            },
            "rollup": rollup,
        }


def _sum_numeric(dst: dict, src: dict, skip: tuple = ()) -> None:
    for k, v in src.items():
        if k in skip:
            continue
        if isinstance(v, dict):
            sub = dst.setdefault(k, {})
            if isinstance(sub, dict):
                _sum_numeric(sub, v, skip)
        elif isinstance(v, bool):
            continue
        elif isinstance(v, (int, float)):
            prev = dst.get(k, 0)
            if isinstance(prev, (int, float)) \
                    and not isinstance(prev, bool):
                dst[k] = prev + v


def _copy_tree(d: dict) -> dict:
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in d.items()}


def parse_rate_limit(spec: str) -> tuple[float, float]:
    """Parse ``--rate-limit=N[/s][:burst]`` → ``(rate_per_s, burst)``.

    ``N`` is requests per second (float, > 0); ``burst`` is the bucket
    depth (>= 1, default ``max(1, rate)`` so a limit below 1/s still
    admits single requests).  Raises ValueError on anything else — the
    CLI turns that into the usual usage error."""
    s = spec.strip()
    burst_s = None
    if ":" in s:
        s, burst_s = s.split(":", 1)
    if s.endswith("/s"):
        s = s[:-2]
    try:
        rate = float(s)
    except ValueError:
        raise ValueError(f"rate-limit rate {s!r} is not a number")
    if not (rate > 0) or rate != rate or rate == float("inf"):
        raise ValueError("rate-limit rate must be a finite number > 0")
    if burst_s is None:
        burst = max(1.0, rate)
    else:
        try:
            burst = float(burst_s)
        except ValueError:
            raise ValueError(
                f"rate-limit burst {burst_s!r} is not a number")
        if not (burst >= 1) or burst == float("inf"):
            raise ValueError("rate-limit burst must be finite and >= 1")
    return rate, burst


class RateLimiter:
    """Per-identity token bucket in front of admission.

    One bucket per *resolved* client identity (the same string DRR
    fair-share uses), refilled continuously at ``rate_per_s`` up to
    ``burst``.  A refusal is truthful like brownout shedding: it
    reports the ``retry_after_s`` at which the bucket will actually
    hold a whole token, so a well-behaved client that honors it is
    admitted on its next try.

    Monotonic clock only (the clock-discipline gate bans wall-clock
    deltas); the table is bounded at ``max_clients`` — at the cap,
    full (idle) buckets are swept first since they carry no state an
    attacker could launder by eviction, then oldest-inserted."""

    def __init__(self, rate_per_s: float, burst: float,
                 max_clients: int = 4096):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.max_clients = max_clients
        # identity -> [tokens, last_refill_mono]
        self._buckets: dict[str, list] = {}
        self._lock = threading.Lock()
        self.refusals = 0

    def admit(self, client: str, now: float | None = None) -> float:
        """Take one token for ``client``.  Returns 0.0 on admission,
        else the truthful retry_after_s of the refusal."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            b = self._buckets.get(client)
            if b is None:
                if len(self._buckets) >= self.max_clients:
                    self._evict(now)
                b = self._buckets[client] = [self.burst, now]
            tokens = min(self.burst, b[0] + (now - b[1]) * self.rate)
            b[1] = now
            if tokens >= 1.0:
                b[0] = tokens - 1.0
                return 0.0
            b[0] = tokens
            self.refusals += 1
            return max(0.001, round((1.0 - tokens) / self.rate, 3))

    def _evict(self, now: float) -> None:
        # caller holds the lock
        full = [k for k, b in self._buckets.items()
                if min(self.burst, b[0] + (now - b[1]) * self.rate)
                >= self.burst]
        if full:
            for k in full:
                del self._buckets[k]
            return
        self._buckets.pop(next(iter(self._buckets)))
