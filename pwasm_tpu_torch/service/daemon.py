"""The warm-pool serving daemon (``pafreport serve``).

Counterpart of ``pwasm_tpu/service/daemon.py``, with its names.  One
resident process, one unix socket (and, with ``--listen``, TCP), a
fair-share queue, and a small worker pool executing jobs through the
port's own ``cli.run``, so a served job's outputs are byte-identical
to a cold CLI run of the same argv.  What the daemon adds is
everything a cold run cannot amortize:

- **one warm process**: the torch import, the bounded CUDA probe, the
  CUDA context and every kernel library are paid once; jobs after the
  first answer the probe from warm state (``backend.warm_hits`` in
  each job's ``--stats``, with ``backend.probes`` 0);
- **one resilience state a lane**: each device lane
  (``service/leases.py``) carries the supervisor's breaker and bucket
  ceiling from one job to the next on that lane;
- **one drain**: the first SIGTERM/SIGINT (or the ``drain`` protocol
  command) latches admission shut, pulls every running job's drain
  flag (each finishes its in-flight batch, checkpoints, and exits 75
  "preempted, resumable"), marks still-queued jobs preempted without
  starting them, and the daemon itself exits 75.  A second signal
  hard-aborts, exactly like the CLI.

Concurrency model: the accept loop and each client connection run on
their own threads; ``--max-concurrent`` worker threads execute jobs.
Worker threads can never install signal handlers
(``SignalDrain.install`` no-ops off the main thread by design), so the
daemon's OWN drain, installed on the main thread, is the one signal
surface, fanned out to per-job drain flags.

- **one result cache** (``--result-cache=DIR``, ``service/cache.py``):
  a job whose inputs and result-affecting flags were served before is
  answered AT ADMISSION from the stored bytes, landing DONE with no
  queue, lease, probe or kernel (journaled admit + cache_hit +
  finish); an appended input is served its cached prefix and queued
  as a ``--resume`` of the tail; a finished job's outputs are
  inserted.  ``--cache-prefetch`` pages the hottest entries before the
  socket exists; the ``cache-probe`` verb answers whether a key (or
  its family) is held.  Served ``--many2many`` jobs cache their
  sections in the same directory;
- **one build directory** (``--compile-cache-dir=DIR``): where every
  job builds and finds the kernels and the C++ engine; set once for
  the process, so a job's own ``--compile-cache-dir`` is not used.
  A ``stream`` opened with ``"delta": true`` is held against the
  cache's per-line digest columns: a stream whose records extend a
  cached run is served that run's report and queued as a
  ``--resume`` of the tail;
- **one edge** (all opt-in): TLS and mTLS on the ``--listen`` TCP
  listener, scoped capability tokens (``--auth-tokens``,
  ``service/authz.py``) checked before any verb runs, and a
  per-identity token bucket (``--rate-limit``) in front of admission;
- **one self-monitor**: the SLO engine (``obs/slo.py``, the default
  rules of ``obs/catalog.py`` merged with ``--slo-rules=FILE``, or
  none under ``--slo-rules=off``) evaluated on the accept tick, whose
  verdict the ``health`` verb and svc-stats' ``health`` block serve;
  the synthetic canary (``--canary-interval``, ``service/canary.py``)
  probing a free lane with the warmup corpus; and the ``logs`` verb
  over the daemon's own ``--log-json``.
"""

from __future__ import annotations

import os
import re
import socket
import sys
import tempfile
import threading
import time

from pwasm_tpu_torch.core.errors import (EXIT_PREEMPTED, EXIT_USAGE,
                                         PwasmError)
from pwasm_tpu_torch.fleet.fencing import EpochLease
from pwasm_tpu_torch.resilience.lifecycle import SignalDrain
from pwasm_tpu_torch.service import protocol
from pwasm_tpu_torch.service.cache import ByteLedger
from pwasm_tpu_torch.service.journal import (JOURNAL_VERSION, REC_ADMIT,
                                             REC_CACHE_HIT, REC_CANCEL,
                                             REC_EVICT, REC_FINISH,
                                             REC_START, JobJournal,
                                             fold_records)
from pwasm_tpu_torch.service.leases import LeaseManager
from pwasm_tpu_torch.service.queue import (JOB_CANCELLED, JOB_DONE,
                                           JOB_FAILED, JOB_PREEMPTED,
                                           JOB_QUEUED, JOB_RUNNING,
                                           TERMINAL_STATES,
                                           Draining, Job, JobQueue,
                                           QueueFull, ServiceStats,
                                           StreamBook)

_SERVE_USAGE = """Usage:
 pafreport serve --socket=PATH [--listen=HOST:PORT]
                 [--max-queue=N] [--max-queue-total=N]
                 [--max-concurrent=N] [--priority-lanes=hi,lo]
                 [--devices-per-job=N] [--lanes=N]
                 [--journal=PATH|off] [--journal-dir=DIR]
                 [--spool-threshold-bytes=N]
                 [--spool-dir=DIR] [--stream-buffer=N]
                 [--stream-idle-s=S] [--warmup[=cuda|cpu]]
                 [--max-frame-bytes=N] [--metrics-textfile=PATH]
                 [--log-json=FILE] [--log-json-max-bytes=N]
                 [--trace-json=FILE]
                 [--result-ttl-s=S] [--max-results=N]
                 [--canary-interval=S] [--slo-rules=FILE|off]
                 [--compile-cache-dir=DIR]
                 [--result-cache=DIR|off]
                 [--result-cache-max-bytes=N]
                 [--cache-prefetch[=N]]
                 [--tls-cert=PEM --tls-key=PEM
                  [--tls-client-ca=PEM]]
                 [--auth-tokens=FILE] [--rate-limit=N[/s][:burst]]

   --socket=PATH        unix socket to listen on (required)
   --listen=HOST:PORT   ALSO serve the same protocol over plain TCP
                        (port 0 = any free port).  TCP peers have no
                        SO_PEERCRED, so their fair-share identity is
                        the explicit client_token frame field (`submit
                        --client-token=TOK` buckets as tok:TOK);
                        untokened TCP clients share the anonymous
                        bucket
   --journal-dir=DIR    place the job journal (and, unless --spool-dir
                        says otherwise, the result spool) under DIR as
                        <member-name>.journal instead of next to the
                        socket — point it at shared durable storage so
                        a fleet router can read a dead member's
                        journal; leave it unset for fast local disk
   --warmup[=cuda|cpu]  warm up at daemon start (the bare form warms
                        cuda): a tiny synthetic job runs through the
                        normal supervised path on a free lane, paying
                        the CUDA probe, the CUDA context and the
                        kernel-library loads BEFORE the first real job
                        arrives.  Off unless given
   --max-queue=N        admission control: PER-CLIENT queued-job
                        quota (client = socket-peer uid, or the
                        submit frame's client= field), beyond which
                        that client's submit answers queue_full
                        (default 16); other clients keep their own
                        quota — one heavy submitter cannot eat the
                        whole queue
   --max-queue-total=N  global queued-job backstop across all clients
                        (default 8 x max-queue)
   --priority-lanes=A,B strict priority tiers, highest first: a
                        submit tagged priority=A is always dequeued
                        before one tagged B; untagged submits land in
                        the LOWEST lane.  Fair-share round-robin over
                        clients applies within each lane
   --journal=PATH|off   durable job journal (default: <socket>.journal)
                        — every admission/start/finish is an fsync'd
                        NDJSON record, so a daemon restarted after a
                        hard crash (kill -9, OOM-kill) replays it:
                        queued jobs re-queue, running jobs re-admit as
                        --resume continuations of their own ckpts, and
                        finished results restore.  "off" disables
   --spool-threshold-bytes=N  spool a finished job's result (stats +
                        stderr tail) to disk once its JSON exceeds N
                        bytes: daemon RAM keeps only an index entry,
                        `result` reads stream from the spool file
                        (CRC-verified, fsync-then-replace), eviction
                        unlinks it (default: off)
   --spool-dir=DIR      where spooled results live (default:
                        <socket>.spool/); setting it enables spooling
                        with a 65536-byte threshold
   --max-concurrent=N   worker threads executing jobs (default 1).
                        Each running job also holds a DEVICE LEASE
                        (one lane of the CUDA devices), so K
                        concurrent jobs on a K-card host run on K
                        disjoint cards; on one card the lanes share it
   --devices-per-job=N  CUDA devices granted per lease (default 1): a
                        job's --shard work spans exactly its lane
   --lanes=N            lease-lane count (default: --max-concurrent).
                        Set it to cards/devices-per-job; with lanes <
                        max-concurrent a dequeued job WAITS for a free
                        lease (FIFO, measured by the lease-wait
                        histogram), not just a thread
   --stream-buffer=N    per-stream buffered-record quota (default
                        512): records fed over stream-data frames but
                        not yet consumed by the executing job.  A
                        stream past its quota (or over its fair share
                        of the 4x global ceiling once streams together
                        hit it) answers queue_full — the client backs
                        off and resends
   --stream-idle-s=S    drain a stream job after S seconds with no
                        stream-data and no stream-end (default 300):
                        the job exits 75 with a valid checkpoint —
                        preempted-resumable, never silently complete
                        with missing records
   --max-frame-bytes=N  protocol frame ceiling (default 8 MiB)
   --metrics-textfile=PATH  publish the daemon's Prometheus text
                        exposition here (atomic rewrite after every
                        job) for a node-exporter textfile collector;
                        the same exposition answers the `metrics`
                        protocol command / `pafreport metrics` verb
   --log-json=FILE      append structured NDJSON service events (job
                        admit/start/finish/evict, drains); every job
                        event carries the job's trace_id
   --log-json-max-bytes=N  rotate the service event log once it
                        passes N bytes (FILE moves to FILE.1, one
                        generation kept)
   --trace-json=FILE    record the daemon's job-lifecycle spans
                        (queue wait, lease wait, exec — each stamped
                        with the job's trace_id) as Chrome trace JSON,
                        written at exit; `pafreport trace-merge` joins
                        it with a client's trace onto one wall-
                        anchored timeline
   --result-ttl-s=S     evict a finished job's result S seconds after
                        it finished (default: keep forever); evicted
                        job ids answer unknown_job
   --max-results=N      keep at most N finished-job results (least-
                        recently-accessed evicted first)
   --canary-interval=S  run a synthetic canary probe every S seconds
                        (service/canary.py): the deterministic warmup
                        corpus through a free lane's normal serving
                        path, byte-verified against a golden digest —
                        pwasm_canary_* metrics feed the canary_failing
                        SLO rule, so a silently-wedged lane fires an
                        alert instead of waiting for a user job
   --slo-rules=FILE|off JSON list of SLO rule objects merged over the
                        default set (obs/catalog.py; a rule with a
                        default's name replaces it) — evaluated
                        continuously by the in-process engine
                        (obs/slo.py) feeding pwasm_alerts_firing and
                        the `health` verb; "off" disables the engine
   --compile-cache-dir=DIR  build directory of every job (a job's own
                        flag is not used): nvcc's kernel libraries
                        and the C++ engine are built there once and
                        found there by later processes
   --result-cache=DIR   content-addressed result cache: a job whose
                        inputs (by digest) and result-affecting flags
                        match a finished one is answered AT ADMISSION
                        from the cached bytes: zero queue, lease,
                        probe or kernel; journaled admit + cache_hit +
                        finish.  A served --many2many job caches its
                        sections there.  "off" disables
   --result-cache-max-bytes=N  evict least-recently-used cache
                        entries past N total bytes
   --cache-prefetch[=N] before taking traffic, page the N hottest
                        (most-recently-served) --result-cache entries
                        through a verified read (bare: 64), so a
                        daemon restarted on a populated directory
                        serves its first repeat job from a warm cache
   --tls-cert=PEM --tls-key=PEM  upgrade the --listen TCP listener to
                        TLS (stdlib ssl, TLS1.2+ floor; the unix
                        socket keeps kernel peer credentials and
                        never wraps).  Handshake failures — plaintext
                        probes, downgrades, bad certs — are counted
                        (pwasm_transport_tls_handshake_failures_total)
                        and answered with a loud close, never a hang
   --tls-client-ca=PEM  require mTLS: client certificates verified
                        against this CA, and the peer certificate's
                        CN becomes the connection's ATTESTED identity
                        (cn:<name>, ranking above client_token in the
                        resolution order)
   --auth-tokens=FILE   scoped capability tokens (service/authz.py):
                        FILE maps principal (token, cn:<name>,
                        uid:<n>, or the "*" default) -> scopes from
                        {submit, read, cancel-own, admin}.  Control-
                        plane verbs (drain, lease-grant, fence) need
                        admin; cancel needs ownership or admin; an
                        unauthorized frame answers `unauthorized`
                        having changed no queue/journal state.  The
                        file hot-reloads on the accept-loop tick
                        (CRC'd, keep-last-good).  Unset = every verb
                        open
   --rate-limit=N[/s][:burst]  per-identity token bucket in front of
                        admission (submit/stream): past N requests/s
                        (bucket depth `burst`, default max(1,N)) a
                        client's frame answers `overloaded` with a
                        truthful retry_after_s — one hot loop cannot
                        starve admission for everyone else

 SIGTERM/SIGINT (or the `drain` protocol command) drains gracefully:
 in-flight jobs finish at their next batch boundary and checkpoint,
 queued jobs are reported preempted-resumable, new submissions are
 rejected, and the daemon exits 75.  A second signal hard-aborts.
"""

# fair-share client identities double as metric label values and
# journal fields: keep the charset boring (empty = anonymous bucket)
_CLIENT_RE = re.compile(r"^[A-Za-z0-9_.:@/-]*$")


def _num(v, default: float) -> float:
    """A journal field that should be a number, defensively: replay
    must survive bit-rot or hand edits in ANY field, so a wrong-typed
    timestamp/size degrades to the default instead of raising into
    daemon startup."""
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else default


class WarmContext:
    """The state ONE warm process shares across consecutive
    ``cli.run`` invocations.  ``cli.run(..., warm=ctx)`` reads/writes:

    - ``drain``             the SignalDrain the run must honor (the
                            daemon supplies a per-job one via
                            :class:`_JobWarm`);
    - ``monitor`` / ``supervisor_state``  slots for a bare warm
                            context (tests, embedding callers).  Under
                            the daemon they live on the per-lane
                            :class:`DeviceLease` instead
                            (service/leases.py) so a fault on lane 0
                            cannot degrade lane 1; ``_JobWarm``
                            redirects both to the job's lease.  The
                            port has no re-probing health monitor, so
                            ``monitor`` stays None.

    - ``compile_cache_dir`` the build directory of every job (serve
                            ``--compile-cache-dir``; a job's own flag
                            is not used);
    - ``result_cache_dir``  the result cache's directory (serve
                            ``--result-cache``): a served
                            ``--many2many`` job caches its sections
                            there; the daemon's whole-job lookup
                            happens at admission.

    The reference's ``host_executor()`` (a host report-pipeline worker
    shared across jobs) has no counterpart: the port's main loop has no
    host pipeline worker to share.
    """

    def __init__(self) -> None:
        self.drain = None
        self.monitor = None
        self.supervisor_state: dict | None = None
        self.compile_cache_dir: str | None = None
        self.result_cache_dir: str | None = None


class _JobWarm:
    """Per-job view of the warm process: this job's own drain flag and
    the LANE's warm state.  The supervisor's breaker/ceiling snapshot
    lives on the :class:`~pwasm_tpu_torch.service.leases.DeviceLease`
    the job holds, not on the daemon: a fault that opens lane 0's
    breaker degrades only the jobs that later run on lane 0.  The
    lease is held exclusively for the job's duration, so sharing is
    race-free per lane by construction.

    ``lease_devices`` (a ``(lo, hi)`` CUDA device-index span, or None)
    is what ``cli.run`` reads to scope the job's device placement —
    set only when the daemon actually runs multiple lanes or grants
    more than one device, so a single-lane daemon behaves exactly as
    a cold run."""

    def __init__(self, drain: SignalDrain, lease,
                 expose_devices: bool = False,
                 trace_id: str | None = None, flight=None,
                 shared: WarmContext | None = None):
        self._shared = shared if shared is not None else WarmContext()
        self.drain = drain
        self.lease = lease
        self.lease_devices = lease.devices if expose_devices else None
        # cross-process trace identity + the per-job flight record:
        # cli.run stamps the trace_id on its event lines (run_id) and
        # feeds its spans into the flight recorder
        self.trace_id = trace_id
        self.flight = flight

    @property
    def compile_cache_dir(self):
        return self._shared.compile_cache_dir

    @property
    def result_cache_dir(self):
        return self._shared.result_cache_dir

    @property
    def supervisor_state(self):
        return self.lease.supervisor_state

    @supervisor_state.setter
    def supervisor_state(self, st) -> None:
        self.lease.supervisor_state = st


class Daemon:
    """The serving daemon.  ``runner`` is injectable for tests and
    defaults to ``pwasm_tpu_torch.cli.run``."""

    def __init__(self, socket_path: str, max_queue: int = 16,
                 max_concurrent: int = 1,
                 max_frame_bytes: int = protocol.MAX_FRAME_BYTES,
                 stderr=None, runner=None, metrics_textfile=None,
                 log_json=None, result_ttl_s: float | None = None,
                 max_results: int | None = None,
                 lanes: int | None = None, devices_per_job: int = 1,
                 journal_path: str | None = "auto",
                 max_queue_total: int | None = None,
                 priority_lanes: tuple[str, ...] | None = None,
                 spool_threshold_bytes: int | None = None,
                 spool_dir: str | None = None,
                 stream_buffer: int = 512,
                 stream_idle_s: float | None = 300.0,
                 log_json_max_bytes: int | None = None,
                 trace_json: str | None = None,
                 listen: str | None = None,
                 journal_dir: str | None = None,
                 warmup: str | None = None,
                 compile_cache_dir: str | None = None,
                 canary_interval_s: float | None = None,
                 slo_rules=None,
                 result_cache: str | None = None,
                 result_cache_max_bytes: int | None = None,
                 result_cache_ttl_s: float | None = None,
                 cache_prefetch: int | None = None,
                 tls=None, auth_tokens: str | None = None,
                 rate_limit: tuple | None = None):
        self.socket_path = socket_path
        # an optional plain-TCP listener joining the unix socket — same
        # protocol, token-based client identity (no SO_PEERCRED on
        # AF_INET)
        self.listen = listen
        self.tcp_port: int | None = None   # actual port after bind
        self.warmup = warmup
        self._t0_mono = time.monotonic()   # uptime origin (the lane
        #   busy-fraction gauges divide by it)
        self.max_concurrent = max(1, int(max_concurrent))
        # device-lease scheduler: every running job holds one lane of
        # the device inventory.  lanes defaults to the worker count
        # (each worker always finds a lease, wait ~0); an explicit
        # --lanes below the worker count makes admission genuinely
        # lease-gated — a dequeued job waits (FIFO) for a free lane,
        # measured by the lease-wait histogram.
        self.devices_per_job = max(1, int(devices_per_job))
        self.leases = LeaseManager(
            lanes if lanes is not None else self.max_concurrent,
            self.devices_per_job)
        # expose the lane's device span to jobs only when the operator
        # asked for multi-lane/multi-device serving: a 1-lane daemon's
        # jobs run exactly as cold runs
        self._expose_devices = (self.leases.n_lanes > 1
                                or self.devices_per_job > 1)
        self.max_frame_bytes = int(max_frame_bytes)
        self.stderr = stderr if stderr is not None else sys.stderr
        self._runner = runner
        self.queue = JobQueue(max_queue, max_total=max_queue_total,
                              priority_lanes=priority_lanes)
        # ---- crash safety: the durable job journal.  Every
        # admission/start/finish/cancel/evict is an fsync'd NDJSON
        # record (service/journal.py), replayed at the next start on
        # this socket so a kill -9 loses no acked job.
        # --journal-dir places it on shared durable storage a router
        # can read after this process dies; the path arithmetic lives
        # in fleet/transport.py
        if journal_path == "auto":
            from pwasm_tpu_torch.fleet.transport import \
                member_journal_path
            journal_path = member_journal_path(socket_path,
                                               journal_dir)
        self.journal = JobJournal(journal_path) if journal_path \
            else None
        self._journal_warned = False
        # ---- disk-spooled results: past the threshold a finished
        # job's stats/stderr move to <spool_dir>/<id>.result
        # (fsync-then-replace, CRC'd like ckpt v2) and RAM keeps an
        # index row
        if spool_dir is None and journal_dir is not None:
            # one placement knob moves BOTH durable surfaces: spool
            # files ride journal finish records, so a router serving a
            # dead member's results needs them on the same storage
            from pwasm_tpu_torch.fleet.transport import target_name
            spool_dir = os.path.join(
                journal_dir, target_name(socket_path) + ".spool")
        if spool_dir is not None and spool_threshold_bytes is None:
            spool_threshold_bytes = 65536
        self.spool_threshold_bytes = spool_threshold_bytes
        self.spool_dir = spool_dir if spool_dir is not None \
            else socket_path + ".spool"
        # a full disk under the spool dir degrades to pass-through —
        # results are still served from RAM.  Warn ONCE per condition;
        # the counters carry the ongoing truth
        self._spool_warned = False
        self._cache_insert_warned = False
        # the byte ledger the spool and the result cache are charged to
        # (service/cache.py): the two gauges read one synchronized
        # source
        self.ledger = ByteLedger()
        # the state every job's warm view shares: the build directory
        # and the result cache's directory
        self.warm = WarmContext()
        if compile_cache_dir is not None:
            # the build directory is the process's: set once here, and
            # no job moves it (ops/_build.py::job_build_dir)
            from pwasm_tpu_torch.ops._build import use_build_dir
            compile_cache_dir = use_build_dir(compile_cache_dir)
        self.warm.compile_cache_dir = compile_cache_dir
        # ---- streaming ingestion: per-stream buffer quotas +
        # fair-share arbitration; stream jobs are otherwise ordinary
        # queue citizens (DRR over clients, leases, journal)
        self.streams = StreamBook(stream_buffer)
        self.stream_idle_s = stream_idle_s
        self._client_lanes: dict[str, int] = {}   # lane a client's
        #   last stream ran on — consecutive/re-opened streams prefer
        #   it, so they inherit the lane's warm state
        self.jobs: dict[str, Job] = {}
        self.stats = ServiceStats()
        self.drain = SignalDrain(stderr=self.stderr)
        # ---- epoch-lease fencing (fleet/fencing.py): when a fleet
        # router governs this member, its stats polls carry a lease
        # {epoch, ttl_s}; missing heartbeats past the TTL means the
        # fleet may have failed our jobs over — self-fence (drain
        # in-flight to checkpoints, refuse new frames) rather than keep
        # writing as a zombie.  Ungoverned daemons never fence.
        self.epoch_lease = EpochLease()
        self._lock = threading.Lock()
        self._running: dict[str, Job] = {}
        # the finished m2m-stream sessions' flow counters (the svc-stats
        # "m2m" block); they stay 0 until --m2m-stream is ported
        self._m2m_done = {"sessions": 0, "targets_in": 0,
                          "targets_scored": 0, "targets_reused": 0,
                          "pairs_dispatched": 0, "pairs_reused": 0,
                          "batches": 0, "sections_emitted": 0}
        self._draining = False
        self._closing = threading.Event()
        self._next_id = 0
        self._jobdir: tempfile.TemporaryDirectory | None = None
        from collections import deque
        self._job_walls: deque = deque(maxlen=8)  # recent finished-job
        #                       walls (the retry_after_s hint) — only
        #                       the recent window matters, so bounded
        # ---- observability: ONE metrics registry for the daemon's
        # life — queue/admission gauges + job histograms
        # (obs/catalog.py build_service_metrics) plus the cumulative
        # run-level families every finished job's --stats JSON is
        # folded into (fold_run_stats), exposed over the `metrics`
        # protocol command and, optionally, a node-exporter textfile.
        from pwasm_tpu_torch.obs import (EventLog, MetricsRegistry,
                                         Observability, TraceRecorder)
        from pwasm_tpu_torch.obs.catalog import (
            build_cache_metrics, build_canary_metrics, build_m2m_metrics,
            build_run_metrics, build_service_metrics, build_slo_metrics,
            build_stream_metrics, build_transport_metrics)
        self.registry = MetricsRegistry()
        self.svc_metrics = build_service_metrics(self.registry)
        self.stream_metrics = build_stream_metrics(self.registry)
        self.m2m_metrics = build_m2m_metrics(self.registry)
        self.cache_metrics = build_cache_metrics(self.registry)
        # the result cache: looked up at admission, inserted at job
        # finish.  An unusable directory runs the daemon uncached with
        # a warning
        self.cache = None
        if result_cache and result_cache != "off":
            from pwasm_tpu_torch.service.cache import CacheStore
            try:
                self.cache = CacheStore(
                    result_cache, max_bytes=result_cache_max_bytes,
                    ttl_s=result_cache_ttl_s,
                    metrics=self.cache_metrics, ledger=self.ledger)
            except OSError as e:
                self._say(f"warning: --result-cache dir {result_cache} "
                          f"unusable ({e}); result caching disabled")
        self.warm.result_cache_dir = result_cache \
            if self.cache is not None else None
        self.cache_prefetch = cache_prefetch   # entries warmed before
        #                                        the socket exists
        self._cache_evict_at = 0.0    # next TTL/budget sweep (mono)
        # foldable counters only: the live run instruments (attempt
        # histogram, run breaker gauge) belong to each run's own obs
        # bundle — the daemon's breaker view is the
        # pwasm_service_breaker_state gauge
        self.run_metrics = build_run_metrics(self.registry,
                                             include_live=False)
        # ---- the edge: TLS on the TCP listener (the handshake runs on
        # each connection's own thread), scoped capability tokens, and
        # a per-identity rate limit.  All three are opt-in: unarmed,
        # every frame and output is what a daemon without them gives
        self.transport_metrics = build_transport_metrics(self.registry)
        self.tls = tls                     # transport.ServerTLS | None
        self.auth = None
        self._penalty = None
        if auth_tokens:
            from pwasm_tpu_torch.service.authz import (AuthRegistry,
                                                       PenaltyBox)
            # startup is fail-fast (the ValueError reaches serve_main
            # as a usage error): a daemon must never come up OPEN
            # because its token file was bad
            self.auth = AuthRegistry(auth_tokens, say=self._say)
            self._penalty = PenaltyBox()
        self._auth_labels: set[str] = set()   # bounded label universe
        #   for the per-client auth-failure counter (overflow -> other)
        self.rate_limiter = None
        if rate_limit is not None:
            from pwasm_tpu_torch.service.queue import RateLimiter
            self.rate_limiter = RateLimiter(rate_limit[0],
                                            rate_limit[1])
        self.svc_metrics["max_queue"].set(self.queue.max_queue)
        self.svc_metrics["max_concurrent"].set(self.max_concurrent)
        self.svc_metrics["lanes"].set(self.leases.n_lanes)
        self._clients_seen: set[str] = set()   # label universe for the
        #   per-client depth gauge (a drained client reads 0, not gone)
        self.metrics_textfile = metrics_textfile
        self._textfile_lock = threading.Lock()  # fsio's tmp name is
        #   pid-unique, not thread-unique: two workers finishing at
        #   once must not interleave on the same tmp file
        events = None
        if log_json:
            # append: a restarted daemon extends the incident timeline
            # instead of wiping the previous one; --log-json-max-bytes
            # rotates it (FILE -> FILE.1) so a long-lived daemon's log
            # stays bounded
            events = EventLog(path=log_json,
                              max_bytes=log_json_max_bytes)
        # --trace-json: the daemon's OWN span recorder — per-job
        # queue-wait/lease-wait/exec spans stamped with the job's
        # trace_id, wall-anchored so `trace-merge` can join them with
        # the submitting client's trace on one timeline
        tracer = TraceRecorder() if trace_json else None
        if tracer is not None:
            dropped = self.run_metrics.get("trace_dropped")
            if dropped is not None:
                tracer.on_drop = lambda c=dropped: c.inc()
        self.obs = Observability(registry=self.registry,
                                 events=events, tracer=tracer,
                                 trace_path=trace_json)
        self.drain.obs = self.obs   # SIGTERM/drain lands in the log
        self.log_json_path = log_json   # the `logs` verb reads it
        # ---- self-monitoring: the SLO engine over THIS registry
        # (default rules + user --slo-rules merged by name;
        # slo_rules="off" runs an empty engine) and the synthetic
        # canary
        from pwasm_tpu_torch.obs.catalog import default_slo_rules
        from pwasm_tpu_torch.obs.slo import SloEngine, merge_rules
        self.slo_metrics = build_slo_metrics(self.registry)
        self.canary_metrics = build_canary_metrics(self.registry)
        if slo_rules == "off":
            rules = []
        else:
            rules = merge_rules(default_slo_rules(), slo_rules)
        # evaluate fast enough that a canary failure fires within the
        # detection contract (two canary intervals), slow enough to
        # stay invisible next to the 0.2s accept tick
        eval_s = 1.0
        if canary_interval_s is not None:
            eval_s = min(eval_s, max(0.05, canary_interval_s / 2))
        self.slo = SloEngine(self.registry, rules,
                             metrics=self.slo_metrics,
                             on_event=self.obs.event,
                             eval_interval_s=eval_s)
        self.canary = None
        if canary_interval_s is not None:
            from pwasm_tpu_torch.service.canary import CanaryRunner
            self.canary = CanaryRunner(self, canary_interval_s,
                                       self.canary_metrics)
        # ---- result eviction: TTL and/or LRU ceiling over TERMINAL
        # jobs only — running and queued jobs are never touched; an
        # evicted id answers unknown_job exactly like one that never
        # existed
        self.result_ttl_s = result_ttl_s
        self.max_results = max_results

    # ---- lifecycle -----------------------------------------------------
    def serve(self) -> int:
        """Bind, accept, and run until drained.  Returns the process
        exit code: 75 after a graceful drain (the daemon's own
        "preempted, resumable" — queued jobs were reported resumable),
        matching the per-job contract."""
        if self._runner is None:
            from pwasm_tpu_torch.cli import run as cli_run
            self._runner = cli_run
        if self.cache is not None and self.cache_prefetch:
            # page the hottest entries through a CRC-verified read
            # BEFORE the socket exists: socket readiness then implies a
            # warm cache, and the first repeat job is an admission hit
            # served from the page cache
            warmed = self.cache.prefetch(self.cache_prefetch)
            self._say(f"result-cache prefetch: warmed {warmed} "
                      f"entr{'y' if warmed == 1 else 'ies'} from "
                      f"{self.cache.root}")
            self.obs.event("cache_prefetch", warmed=warmed)
        from pwasm_tpu_torch.fleet.transport import (make_unix_listener,
                                                     socket_alive)
        if os.path.exists(self.socket_path):
            # a stale socket from a dead daemon: binding over it
            # needs the unlink; a LIVE daemon still holds the
            # listener, so connecting first tells the two apart
            if socket_alive(self.socket_path):
                raise PwasmError(
                    f"Error: a daemon is already serving on "
                    f"{self.socket_path}\n")
        try:
            # the listener factory chmods the socket 0600 (only the
            # serving uid connects by default; TCP is the opt-in
            # wider audience)
            sock = make_unix_listener(self.socket_path)
        except OSError as e:
            raise PwasmError(
                f"Error: cannot bind service socket "
                f"{self.socket_path}: {e}\n")
        listeners: list[socket.socket] = [sock]
        if self.listen:
            # the TCP transport: same protocol, same dispatch — only
            # the peer-identity source differs
            from pwasm_tpu_torch.fleet.transport import \
                make_tcp_listener
            try:
                tsock = make_tcp_listener(self.listen)
            except (OSError, ValueError) as e:
                sock.close()
                try:
                    os.unlink(self.socket_path)
                except OSError:
                    pass
                raise PwasmError(
                    f"Error: cannot bind --listen={self.listen}: "
                    f"{e}\n")
            self.tcp_port = tsock.getsockname()[1]
            listeners.append(tsock)
        import selectors
        sel = selectors.DefaultSelector()
        for l in listeners:
            l.setblocking(False)
            sel.register(l, selectors.EVENT_READ)
        self._jobdir = tempfile.TemporaryDirectory(prefix="pwasm_svc_")
        if self.journal is not None:
            # replay BEFORE workers start and BEFORE the first accept:
            # recovered jobs must be queued when the first worker looks
            # and restored results visible to the first client request
            try:
                self._replay_journal()
                self.journal.open()
            except OSError as e:
                self._say(f"warning: job journal {self.journal.path} "
                          f"unavailable ({e}); serving WITHOUT crash "
                          "recovery")
                self.journal = None
            except Exception as e:
                # a corrupt journal must degrade, never wedge every
                # restart on this socket (the exact path the journal
                # exists to protect): quarantine it ckpt-v2 style and
                # keep journaling on a fresh file
                self.journal.close()
                bad = self.journal.path + ".bad"
                try:
                    from pwasm_tpu_torch.utils.fsio import \
                        replace_durable
                    replace_durable(self.journal.path, bad)
                except OSError:
                    bad = "(could not quarantine)"
                self._say(f"warning: job journal replay failed "
                          f"({type(e).__name__}: {e}); journal "
                          f"quarantined to {bad} — any jobs it "
                          "named are NOT recovered (resubmit them), "
                          "new jobs are journaled afresh")
                self.obs.event("journal_quarantined", detail=str(e))
                try:
                    self.journal.open()
                except OSError:
                    self.journal = None
        workers = [threading.Thread(target=self._worker, daemon=True,
                                    name=f"pwasm-svc-worker-{i}")
                   for i in range(self.max_concurrent)]
        drained_at: float | None = None
        with self.drain:     # signal handlers (main thread only)
            for w in workers:
                w.start()
            self._say(f"serving on {self.socket_path}"
                      + (f" + tcp {self.listen.rsplit(':', 1)[0]}:"
                         f"{self.tcp_port}" if self.listen else "")
                      + f" (max-queue {self.queue.max_queue}, "
                      f"max-concurrent {self.max_concurrent}, "
                      f"lanes {self.leases.n_lanes}"
                      + (f" x {self.devices_per_job} device(s)"
                         if self.devices_per_job > 1 else "") + ")")
            self.obs.event("daemon_start", socket=self.socket_path,
                           max_queue=self.queue.max_queue,
                           max_concurrent=self.max_concurrent,
                           lanes=self.leases.n_lanes,
                           devices_per_job=self.devices_per_job)
            self._write_textfile()   # scrapers see a file immediately
            if self.warmup:
                # warmup: a tiny synthetic job through the NORMAL
                # supervised path on a free lane, so the CUDA probe,
                # the context and the kernel-library loads are paid
                # before the first real job — in the background,
                # admission is already open
                threading.Thread(target=self._run_warmup, daemon=True,
                                 name="pwasm-svc-warmup").start()
            if self.canary is not None:
                # the synthetic canary loop: started after _jobdir
                # exists — the probe corpus lives under it
                self.canary.start()
            try:
                while True:
                    self._evict_results()
                    self._selfmon_tick()
                    if self.auth is not None:
                        # token rotation without a restart: the file
                        # hot-reloads on this tick (keep-last-good)
                        self.auth.maybe_reload()
                    if self.epoch_lease.expired():
                        self._fence("lease TTL expired: heartbeats "
                                    "from the fleet router stopped")
                    if self.cache is not None and \
                            time.monotonic() >= self._cache_evict_at:
                        # the periodic TTL/budget sweep: an idle cache
                        # still expires, not only on inserts
                        self._cache_evict_at = time.monotonic() + 5.0
                        self.cache.evict_now()
                    if self.drain.requested:
                        self._begin_drain(self.drain.reason
                                          or "drain requested")
                        if self._drained():
                            # linger briefly so waiters blocked in
                            # `result` get their final frames before
                            # the process goes away
                            if drained_at is None:
                                drained_at = time.monotonic()
                            elif time.monotonic() - drained_at > 0.5:
                                break
                    try:
                        events = sel.select(0.2)
                    except OSError:
                        break
                    if not events:
                        continue
                    for key, _mask in events:
                        try:
                            conn, _ = key.fileobj.accept()
                        except OSError:
                            continue
                        conn.setblocking(True)
                        t = threading.Thread(
                            target=self._handle_conn,
                            args=(conn,), daemon=True)
                        t.start()
            finally:
                self._closing.set()
                for w in workers:
                    w.join(timeout=5.0)
                sel.close()
                for l in listeners:
                    l.close()
                try:
                    os.unlink(self.socket_path)
                except OSError:
                    pass
                if self._jobdir is not None:
                    self._jobdir.cleanup()
        rc = EXIT_PREEMPTED if self.drain.requested else 0
        if self.drain.requested:
            # CLEAN exit: every admitted job reached a terminal state
            # its client was told about (in-flight drained resumable,
            # queued reported preempted), so there is nothing for a
            # restart to recover — retire the journal and the spool.
            # A hard crash never reaches this line, which is the point.
            if self.journal is not None:
                self.journal.unlink()
            with self._lock:
                spooled = [j for j in self.jobs.values()
                           if j.spool is not None]
            for j in spooled:
                self._unlink_spool(j)
        elif self.journal is not None:
            self.journal.close()
        self.obs.event("daemon_exit", rc=rc,
                       drained=self.drain.requested)
        self._write_textfile()       # final snapshot for the scraper
        if self.obs.tracer is not None and self.obs.trace_path:
            try:
                self.obs.tracer.write(self.obs.trace_path)
                self._say("trace written to "
                          f"{self.obs.trace_path}")
            except OSError as e:
                self._say(f"warning: cannot write --trace-json "
                          f"{self.obs.trace_path}: {e}")
        if self.obs.events is not None:
            self.obs.events.close()
        if self.drain.requested:
            self._say(f"drained — exiting resumable "
                      f"(exit {EXIT_PREEMPTED}); resubmit preempted "
                      "jobs with --resume to complete them")
            return EXIT_PREEMPTED
        return 0

    def _say(self, msg: str) -> None:
        print(f"pwasm: {msg}", file=self.stderr)

    # ---- observability -------------------------------------------------
    def _selfmon_tick(self) -> None:
        """One accept-loop tick of the SLO engine: refresh the gauges
        the rules read, then evaluate — time-gated inside the engine so
        the 0.2s accept cadence costs nothing between evaluation
        intervals."""
        if self.slo.due():
            self._refresh_gauges()
            self.slo.evaluate()

    def _health(self) -> dict:
        """The `health` verb body: a FRESH evaluation (a probe must
        see now, not the last timer tick), the verdict + firing rules,
        and the canary roll-up."""
        self._refresh_gauges()
        h = self.slo.evaluate()
        h["canary"] = self.canary.summary() \
            if self.canary is not None else None
        return h

    def _refresh_gauges(self) -> None:
        """Stamp the point-in-time gauges from the live state.  Called
        before every exposition/stats read and after every job, so the
        Prometheus surface and svc-stats both read the SAME registry
        (they cannot drift — the svc-stats satellite contract)."""
        m = self.svc_metrics
        m["queue_depth"].set(self.queue.depth())
        with self._lock:
            running = len(self._running)
            held = sum(1 for j in self.jobs.values()
                       if j.state in TERMINAL_STATES)
            clients_seen = set(self._clients_seen)   # snapshot: a
            #   concurrent admit's .add() must not resize the set
            #   mid-iteration below
        m["inflight"].set(running)
        m["draining"].set(1 if self._draining else 0)
        m["results_held"].set(held)
        # the daemon-level breaker gauge is the WORST lane (one number
        # for "is anything degraded"); the per-lane vector carries the
        # which
        m["breaker_state"].set(self.leases.breaker_rollup())
        m["lanes_busy"].set(self.leases.busy_count())
        m["lease_waiting"].set(self.leases.waiting_count())
        uptime = max(1e-9, time.monotonic() - self._t0_mono)
        for row in self.leases.lane_states():
            m["lane_breaker_state"].set(row["breaker_state"],
                                        lane=str(row["lane"]))
            # utilization accounting: fraction of the
            # daemon's uptime this lane spent leased to a job
            m["lane_busy_fraction"].set(
                round(min(1.0, row["busy_s"] / uptime), 6),
                lane=str(row["lane"]))
        # both byte gauges read the ONE ledger (never a bare int a
        # concurrent eviction could tear)
        m["spool_bytes"].set(self.ledger.value("spool"))
        m["fenced"].set(1 if self.epoch_lease.fenced else 0)
        m["member_epoch"].set(self.epoch_lease.epoch)
        self.cache_metrics["bytes"].set(self.ledger.value("cache"))
        for c, lag in self.streams.client_lag().items():
            self.stream_metrics["lag"].set(lag,
                                           client=c or "default")
        for c, age in self.streams.client_lag_age().items():
            self.stream_metrics["lag_age"].set(round(age, 3),
                                               client=c or "default")
        mm = self._m2m_stats()
        g = self.m2m_metrics
        g["active"].set(mm.get("active", 0))
        with self._lock:
            done_in = self._m2m_done["targets_in"]
        g["live_targets"].set(max(0, mm["targets_in"] - done_in))
        pairs = mm["pairs_dispatched"] + mm["pairs_reused"]
        g["reuse_ratio"].set(
            round(mm["pairs_reused"] / pairs, 6) if pairs else 0.0)
        depths = self.queue.client_depths()
        for c in clients_seen | set(depths):
            # every client ever admitted keeps a series: a drained
            # client reads 0 (a disappearing series looks like a
            # scrape gap, not an emptied queue)
            m["client_queue_depth"].set(depths.get(c, 0),
                                        client=c or "default")

    def _write_textfile(self) -> None:
        """Atomic textfile publish (fsync-then-replace via
        ``utils.fsio``) — best-effort: a full disk costs a warning,
        never the serving loop."""
        if not self.metrics_textfile:
            return
        try:
            with self._textfile_lock:
                self._refresh_gauges()
                self.registry.write_textfile(self.metrics_textfile)
        except OSError as e:
            self._say(f"warning: cannot write --metrics-textfile "
                      f"{self.metrics_textfile}: {e}")

    # ---- crash safety: journal + spool -----------------------
    def _journal_append(self, rec: str, **fields) -> None:
        """Durably journal one job transition.  A failed append warns
        ONCE and latches (the daemon keeps serving without crash
        recovery — a full disk must not take the fleet down), never
        raises into the serving path."""
        if self.journal is None:
            return
        if self.journal.append(rec, t=round(time.time(), 3),
                               **fields):
            self.svc_metrics["journal_records"].inc(rec=rec)
        elif not self._journal_warned:
            self._journal_warned = True
            self._say(f"warning: job-journal append failed "
                      f"({self.journal.broken}); continuing WITHOUT "
                      "crash recovery")
            self.obs.event("journal_broken",
                           detail=self.journal.broken)

    def _replay_journal(self) -> None:
        """Rebuild the job table from the journal a crashed
        predecessor left behind (serve() calls this before the first
        accept).  Per admitted job, in admission order:

        - ``finish`` record → restored as a terminal result-index
          entry (stats stream from its spool file when it had one);
        - ``cancel`` without ``finish`` → terminal ``cancelled`` (the
          cancel was acked; silently re-running would un-cancel it);
        - ``start`` without ``finish`` → the crash killed it mid-run:
          re-admitted as a ``--resume`` continuation of its own report
          checkpoint, with lane affinity for the lane it ran on — the
          ckpt-v2 resume contract makes the recovered report
          byte-identical to a never-crashed run;
        - bare ``admit`` → re-queued exactly as submitted.

        Afterwards the journal is compacted to the surviving records
        so restart cost tracks live state, not daemon history."""
        records = self.journal.replay()
        folded = fold_records(records) if records else {}
        if not folded:
            return
        rows = sorted(folded.items(), key=lambda kv: kv[1]["_ord"])
        keep: list[dict] = []
        n_requeued = n_resumed = n_restored = 0
        max_num = 0
        for jid, row in rows:
            try:
                max_num = max(max_num, int(jid.rsplit("-", 1)[-1]))
            except ValueError:
                pass
            if row["evicted"]:
                continue
            admit = row["admit"]
            argv = admit.get("argv")
            if not isinstance(argv, list) \
                    or not all(isinstance(a, str) for a in argv):
                continue
            client = str(admit.get("client") or "")
            priority = str(admit.get("priority") or "")
            trace_id = str(admit.get("trace_id") or "")
            fin = row["finish"]
            if fin is not None or row["cancel"] is not None:
                job = Job(id=jid, argv=list(argv), client=client,
                          priority=priority, trace_id=trace_id)
                job.submitted_s = _num(admit.get("t"),
                                       job.submitted_s)
                if fin is not None:
                    job.state = fin.get("state") \
                        if fin.get("state") in TERMINAL_STATES \
                        else JOB_FAILED
                    job.rc = fin.get("rc") \
                        if isinstance(fin.get("rc"), int) else None
                    job.detail = str(fin.get("detail") or "")
                    job.finished_s = _num(fin.get("t"), time.time())
                    spool = fin.get("spool")
                    if isinstance(spool, dict) \
                            and isinstance(spool.get("path"), str):
                        if os.path.exists(spool["path"]):
                            job.spool = {
                                "path": spool["path"],
                                "bytes": int(_num(
                                    spool.get("bytes"), 0))}
                            self.ledger.add("spool",
                                            job.spool["bytes"])
                        else:
                            job.detail += \
                                " [spooled result lost in crash]"
                else:
                    # a cancel the crash interrupted: the client was
                    # told "cancelling", so re-running would UN-cancel
                    # it — land terminal, resumable by resubmission
                    job.state = JOB_CANCELLED
                    job.detail = ("cancel was in flight when the "
                                  "daemon crashed; not re-run — "
                                  "resubmit (with --resume if a "
                                  "checkpoint exists) to complete it")
                    job.finished_s = time.time()
                job.done.set()
                self.jobs[jid] = job
                keep.append(dict(admit))
                fin_rec = {"v": JOURNAL_VERSION, "rec": REC_FINISH,
                           "job_id": jid,
                           "state": job.state, "rc": job.rc,
                           "detail": job.detail or None,
                           "spool": job.spool,
                           "t": round(job.finished_s, 3)}
                keep.append(fin_rec)
                n_restored += 1
                continue
            if admit.get("stream"):
                # a live-at-crash SOCKET stream: its records came over
                # a connection the crash severed, so the daemon cannot
                # re-run it alone — land it terminal
                # preempted-RESUMABLE (records up to the last
                # batch-boundary ckpt are durable; the client re-opens
                # a stream with --resume and re-sends, byte-identical
                # by the resume contract), and remember its lane so
                # the re-opened stream inherits the warm state
                job = Job(id=jid, argv=list(argv), client=client,
                          priority=priority, trace_id=trace_id)
                job.stream = True
                job.submitted_s = _num(admit.get("t"),
                                       job.submitted_s)
                job.state = JOB_PREEMPTED
                job.rc = EXIT_PREEMPTED
                job.detail = (
                    "stream interrupted by a daemon crash; records "
                    "up to the last checkpoint are durable — re-open "
                    "the stream with --resume and re-send the "
                    "records to complete it")
                job.finished_s = time.time()
                job.done.set()
                self.jobs[jid] = job
                start = row["start"]
                if start is not None \
                        and isinstance(start.get("lane"), int):
                    self._client_lanes.setdefault(client,
                                                  start["lane"])
                keep.append(dict(admit))
                keep.append({"v": JOURNAL_VERSION, "rec": REC_FINISH,
                             "job_id": jid, "state": JOB_PREEMPTED,
                             "rc": EXIT_PREEMPTED,
                             "detail": job.detail,
                             "t": round(job.finished_s, 3)})
                self.stats.jobs_preempted += 1
                n_restored += 1
                continue
            # live at crash time: re-queue, resuming if it had started
            resume = row["start"] is not None
            run_argv = list(argv)
            if resume and "--resume" not in run_argv:
                run_argv.append("--resume")
            job = Job(id=jid, argv=list(run_argv), client=client,
                      priority=priority, trace_id=trace_id)
            job.recovered = True
            job.submitted_s = _num(admit.get("t"), job.submitted_s)
            if resume and isinstance(row["start"].get("lane"), int):
                job.prefer_lane = row["start"]["lane"]
            job.detail = ("recovered from the job journal "
                          + ("(daemon crashed mid-run); resuming "
                             "from its checkpoint" if resume
                             else "(daemon crashed while it was "
                             "queued); re-queued"))
            self._arm_job(job)
            try:
                self.queue.submit(job)
            except (Draining, QueueFull) as e:
                # only reachable when queue limits SHRANK across the
                # restart: surface it as a failed job, never a lost one
                job.state = JOB_FAILED
                job.detail = ("journal recovery could not re-queue "
                              f"({e})")
                job.finished_s = time.time()
                job.done.set()
                self.jobs[jid] = job
                continue
            self.jobs[jid] = job
            self._clients_seen.add(client)
            new_admit = dict(admit)
            new_admit.update({"v": JOURNAL_VERSION, "rec": REC_ADMIT,
                              "job_id": jid, "argv": run_argv,
                              "client": client,
                              "priority": priority})
            keep.append(new_admit)
            self.stats.jobs_recovered += 1
            if resume:
                n_resumed += 1
            else:
                n_requeued += 1
        with self._lock:
            self._next_id = max(self._next_id, max_num)
        self.journal.compact(keep)
        self.stats.journal_replays += 1
        self.svc_metrics["journal_replays"].inc()
        self.obs.event("journal_replay", requeued=n_requeued,
                       resumed=n_resumed, restored=n_restored)
        self._say(f"journal replay: {n_requeued} queued job(s) "
                  f"re-queued, {n_resumed} interrupted job(s) "
                  f"re-admitted with --resume, {n_restored} "
                  "terminal result(s) restored")

    def _spool_result(self, job: Job) -> None:
        """Move a finished job's RAM-resident result (its RunStats
        JSON + stderr tail) to the spool dir once the serialized form
        passes ``--spool-threshold-bytes``: the daemon keeps only the
        index row (path + size), so resident result memory is bounded
        no matter how large reports grow.  The file is published via
        the audited fsync-then-replace and CRC'd like ckpt v2 — a torn
        or rotted spool is detected at read time, never served."""
        if self.spool_threshold_bytes is None or job.spool is not None:
            return
        import json

        from pwasm_tpu_torch.utils.fsio import (ensure_private_dir,
                                          payload_crc,
                                          write_durable_text)
        flight = None
        if job.flight is not None:
            # the flight record is finalized HERE (phase walls are all
            # in by the terminal state) and rides the spool payload —
            # `inspect` on a spooled job reads it back CRC-verified
            wall = (job.finished_s or time.time()) - job.submitted_s
            flight = job.flight.summary(wall_s=wall)
        payload = {"version": 1, "job_id": job.id,
                   "state": job.state, "rc": job.rc,
                   "trace_id": job.trace_id or None,
                   "flight": flight,
                   "stats": job.stats,
                   "stderr_tail": job.stderr_tail}
        blob = json.dumps(payload, sort_keys=True,
                          separators=(",", ":"))
        if len(blob) < self.spool_threshold_bytes:
            return
        payload["crc"] = payload_crc(payload)
        out = json.dumps(payload, sort_keys=True,
                         separators=(",", ":"))
        path = os.path.join(self.spool_dir,
                            f"{job.id}.result.json")
        try:
            ensure_private_dir(self.spool_dir)
            write_durable_text(path, out)
        except OSError as e:
            if not self._spool_warned:
                self._spool_warned = True
                self._say(f"warning: cannot spool results "
                          f"({type(e).__name__}: {e}, first on "
                          f"{job.id}) — results stay in memory until "
                          "the spool dir is writable again; warning "
                          "once, counting every skip")
            self.obs.event("result_spool_error", job_id=job.id,
                           error=type(e).__name__)
            return
        self._spool_warned = False   # a successful spool re-arms the
        #                              warning: the NEXT outage logs
        job.spool = {"path": path, "bytes": len(out)}
        job.stats = None
        job.stderr_tail = ""
        job.flight = None     # the spool file holds it now — RAM
        #                       keeps only the index row
        self.ledger.add("spool", len(out))
        self.obs.event("result_spool", job_id=job.id,
                       bytes=len(out))

    def _load_spool(self, job: Job):
        """(payload, error) read back from the job's spool file,
        CRC-verified (the ckpt-v2 rule: a result that fails
        verification is reported unreadable, never served as if
        whole).  The payload dict carries stats, stderr_tail, the
        job's trace_id and its flight record."""
        return load_spool_payload(job.spool["path"])

    def _unlink_spool(self, job: Job) -> None:
        if job.spool is None:
            return
        try:
            os.unlink(job.spool["path"])
        except OSError:
            pass
        self.ledger.sub("spool", job.spool.get("bytes", 0))
        job.spool = None

    def _evict_results(self) -> None:
        """Drop TERMINAL job results past ``--result-ttl-s`` and/or
        beyond ``--max-results`` (least-recently-accessed first).
        Running/queued jobs are never candidates; a client holding the
        Job object (blocked in ``result``) keeps its reference — only
        the id lookup goes away."""
        if self.result_ttl_s is None and self.max_results is None:
            return
        now = time.time()
        with self._lock:
            terminal = [j for j in self.jobs.values()
                        if j.state in TERMINAL_STATES
                        and j.done.is_set()]
            victims = []
            if self.result_ttl_s is not None:
                victims = [j for j in terminal
                           if now - (j.finished_s or j.submitted_s)
                           > self.result_ttl_s]
            if self.max_results is not None:
                keep = [j for j in terminal if j not in victims]
                excess = len(keep) - self.max_results
                if excess > 0:
                    keep.sort(key=lambda j: j.accessed_s)
                    victims += keep[:excess]
            for j in victims:
                self.jobs.pop(j.id, None)
        for j in victims:
            self._unlink_spool(j)      # eviction bounds DISK too: the
            #                            spool file goes with the entry
            self._journal_append(REC_EVICT, job_id=j.id)
            self.stats.jobs_evicted += 1
            self.svc_metrics["results_evicted"].inc()
            self.obs.event("job_evict", job_id=j.id, state=j.state,
                           trace_id=j.trace_id)

    def _drained(self) -> bool:
        with self._lock:
            return self._draining and not self._running \
                and self.queue.depth() == 0

    def _begin_drain(self, reason: str) -> None:
        with self._lock:
            if self._draining:
                return
            self._draining = True
            running = list(self._running.values())
        self.leases.drain()    # wake lease-waiters empty-handed: their
        #                        jobs are preempted below by the worker
        waiting = self.queue.drain()
        # delta-held streams are queued but not in the queue: the
        # drain preempts them too, or they would hang forever
        with self._lock:
            held = [j for j in self.jobs.values()
                    if j.state == JOB_QUEUED and j.dstate is not None
                    and j.dstate.get("mode") == "holding"]
        for j in held:
            j.dstate["mode"] = "off"
        for job in waiting + held:
            self._retire_stream(job)
            job.state = JOB_PREEMPTED
            job.rc = EXIT_PREEMPTED
            job.detail = ("preempted before start (service drained); "
                          "resubmit to a live service — with --resume "
                          "if a previous attempt checkpointed")
            job.finished_s = time.time()
            self.stats.jobs_preempted += 1
            self.svc_metrics["jobs"].inc(outcome="preempted")
            self._journal_append(REC_FINISH, job_id=job.id,
                                 state=JOB_PREEMPTED,
                                 rc=EXIT_PREEMPTED,
                                 detail=job.detail)
            job.done.set()
        for job in running:
            if job.drain is not None:
                job.drain.request(reason)
        self.obs.event("service_drain", reason=reason,
                       running=len(running), preempted=len(waiting))
        self._say(f"draining ({reason}): {len(running)} in-flight "
                  f"job(s) finishing at their batch boundaries, "
                  f"{len(waiting)} queued job(s) preempted, new "
                  "submissions rejected")

    def _fence(self, reason: str) -> None:
        """Self-fence: the epoch lease is gone, so the
        router may ALREADY have re-admitted our jobs to siblings —
        from this instant every write we could make races the new
        owner.  Drain in-flight work to its durable checkpoints and
        preempt the queue, but — unlike a drain — do NOT latch
        admission or kill the workers: a fence is a pause (the next
        accepted lease lifts it), a drain is an exit."""
        if not self.epoch_lease.fence(reason):
            return                   # already fenced
        with self._lock:
            running = list(self._running.values())
        waiting = self.queue.preempt_all()
        for job in waiting:
            self._retire_stream(job)
            job.state = JOB_PREEMPTED
            job.rc = EXIT_PREEMPTED
            job.detail = ("preempted by fencing (member lost its "
                          "epoch lease); resubmit to the fleet — "
                          "with --resume if a previous attempt "
                          "checkpointed")
            job.finished_s = time.time()
            self.stats.jobs_preempted += 1
            self.svc_metrics["jobs"].inc(outcome="preempted")
            self._journal_append(REC_FINISH, job_id=job.id,
                                 state=JOB_PREEMPTED,
                                 rc=EXIT_PREEMPTED,
                                 detail=job.detail)
            job.done.set()
        for job in running:
            if job.drain is not None:
                job.drain.request(f"fenced: {reason}")
        self.svc_metrics["fences"].inc()
        self.obs.event("fenced", reason=reason,
                       epoch=self.epoch_lease.epoch,
                       running=len(running), preempted=len(waiting))
        self._say(f"FENCED ({reason}): {len(running)} in-flight "
                  f"job(s) draining to checkpoints, {len(waiting)} "
                  "queued job(s) preempted; refusing new work until "
                  "a fresh lease arrives")

    def _lease_grant(self, obj) -> tuple[bool, str]:
        """Apply one router lease heartbeat; returns (accepted,
        detail).  An accepted grant on a fenced member UN-fences it —
        the router has re-asserted ownership at a current epoch."""
        if not isinstance(obj, dict):
            return False, "lease must be an object {epoch, ttl_s}"
        was_fenced = self.epoch_lease.fenced
        ok, detail = self.epoch_lease.grant(obj.get("epoch"),
                                            obj.get("ttl_s"))
        if ok:
            self.svc_metrics["member_epoch"].set(
                self.epoch_lease.epoch)
            if was_fenced:
                self.obs.event("unfenced",
                               epoch=self.epoch_lease.epoch)
                self._say(f"lease re-granted at epoch "
                          f"{self.epoch_lease.epoch} — fence lifted, "
                          "accepting work again")
        return ok, detail

    # ---- workers -------------------------------------------------------
    def _worker(self) -> None:
        while not self._closing.is_set():
            job = self.queue.take(timeout=0.1)
            if job is None:
                if self._draining:
                    return
                continue
            # lease-aware admission: a dequeued job runs only
            # once it holds a device lane — with lanes < workers this
            # wait is real (and measured); a drain while waiting
            # preempts the job exactly like one still queued.  ONE
            # blocking acquire holds ONE FIFO ticket for the whole
            # wait (a short-timeout retry loop would re-enqueue at the
            # back each round, reordering two waiting jobs); drain
            # wakes the ticket empty-handed, and should_abort covers
            # the drain-less close path
            # flight accounting: queue wait ends at this
            # dequeue; the lease wait is its own phase — the two must
            # not overlap or the accounted sum overshoots the wall
            queue_wait = max(0.0,
                             time.monotonic() - job.submitted_mono)
            if job.flight is not None:
                job.flight.note("queue_wait", queue_wait)
            t_wait = time.monotonic()
            lease = self.leases.acquire(
                should_abort=self._closing.is_set,
                prefer_lane=job.prefer_lane)
            if lease is None:        # drained, or closing mid-wait
                self._preempt_leaseless(job)
                continue
            waited = time.monotonic() - t_wait
            self.svc_metrics["lease_wait_seconds"].observe(waited)
            if job.flight is not None:
                job.flight.note("lease_wait", waited,
                                lane=lease.lane)
            if self.obs.tracer is not None:
                # the daemon's trace timeline: queue + lease waits as
                # back-to-back complete spans (explicit end times —
                # the queue wait ends EXACTLY where the lease wait
                # starts, preserving the monotonic-nesting schema),
                # stamped with the job's trace_id so trace-merge can
                # follow one job across both processes
                now = self.obs.tracer.now()
                self.obs.tracer.complete(
                    "job_queue_wait", now - waited - queue_wait,
                    now - waited, job_id=job.id,
                    trace_id=job.trace_id)
                self.obs.tracer.complete(
                    "job_lease_wait", now - waited, now,
                    job_id=job.id, trace_id=job.trace_id,
                    lane=lease.lane)
            with self._lock:
                self._running[job.id] = job
            try:
                self._run_job(job, lease)
            finally:
                self.leases.release(lease)
                with self._lock:
                    self._running.pop(job.id, None)
                self._retire_stream(job)
                job.done.set()

    def _run_warmup(self) -> None:
        """``--warmup``: one tiny deterministic job through the normal
        supervised path (``cli.warmup_files`` corpus) on a free lane —
        the torch import, the CUDA probe, the CUDA context and the
        ctx_scan program's first run are paid NOW, in the background,
        instead of under the first real job.  Best-effort: a failed
        warmup costs a warning, never the daemon (a job that then
        meets the same fault fails on its own)."""
        import io
        t0 = time.monotonic()
        lease = self.leases.acquire(
            should_abort=lambda: (self._closing.is_set()
                                  or self.drain.requested))
        if lease is None:
            return
        try:
            from pwasm_tpu_torch.cli import warmup_files
            wdir = os.path.join(self._jobdir.name, "warmup")
            paf, fa = warmup_files(wdir)
            out = os.path.join(wdir, "warm.dfa")
            device = self.warmup
            argv = [paf, "-r", fa, "-o", out, f"--device={device}",
                    "--batch=8"]
            drain = SignalDrain(stderr=self.stderr,
                                hard_exit=lambda code: None)
            warm = _JobWarm(drain, lease, shared=self.warm,
                            expose_devices=self._expose_devices)
            self.obs.event("warmup_start", device=device,
                           lane=lease.lane)
            rc = self._runner(argv, stdout=io.StringIO(),
                              stderr=io.StringIO(), warm=warm)
            wall = round(time.monotonic() - t0, 3)
            self.obs.event("warmup_done", rc=rc, wall_s=wall,
                           lane=lease.lane)
            self._say(f"warmup ({device}) done in {wall}s (rc {rc})")
        except BaseException as e:   # never take the daemon down
            self._say(f"warning: warmup failed "
                      f"({type(e).__name__}: {e})")
        finally:
            self.leases.release(lease)

    def _retire_stream(self, job: Job) -> None:
        """A stream job leaving the live set: drop it from the quota
        book and latch its feed shut, so later ``stream-data`` frames
        answer an error instead of buffering records nobody will ever
        read."""
        if not job.stream:
            return
        self.streams.unregister(job.id)
        if job.feed is not None:
            job.feed.end()

    def _preempt_leaseless(self, job: Job) -> None:
        """A dequeued job the drain caught BEFORE it got a lease: same
        contract as one still queued — preempted, resumable, never
        started."""
        self._retire_stream(job)
        job.state = JOB_PREEMPTED
        job.rc = EXIT_PREEMPTED
        job.detail = ("preempted waiting for a device lease (service "
                      "drained); resubmit to a live service — with "
                      "--resume if a previous attempt checkpointed")
        job.finished_s = time.time()
        self.stats.jobs_preempted += 1
        self.svc_metrics["jobs"].inc(outcome="preempted")
        self._journal_append(REC_FINISH, job_id=job.id,
                             state=JOB_PREEMPTED, rc=EXIT_PREEMPTED,
                             detail=job.detail)
        self.obs.event("job_preempt_leaseless", job_id=job.id)
        job.done.set()

    def _deadline_remaining_s(self, job: Job) -> float | None:
        """The job's remaining end-to-end budget in seconds: the
        admitted ``deadline_ms`` minus everything spent since
        admission — queue wait and lease wait included, measured on
        the monotonic clock.  None when the job carries no deadline."""
        if job.deadline_ms is None:
            return None
        return (job.deadline_ms / 1000.0
                - (time.monotonic() - job.submitted_mono))

    def _finish_deadline_spent(self, job: Job) -> None:
        """A job whose end-to-end budget ran out before exec (queue +
        lease wait ate it): land terminal WITHOUT running — rc 75,
        the same resumable contract a drain preemption gives, detail
        prefixed ``deadline_exceeded`` so clients and the router can
        tell a budget expiry from a drain.  Journaled truthfully (a
        finish with no start record — the job never ran)."""
        job.state = JOB_PREEMPTED
        job.rc = EXIT_PREEMPTED
        job.detail = ("deadline_exceeded: the end-to-end budget "
                      f"({job.deadline_ms} ms at admission) was spent "
                      "in queue + lease wait before exec; resubmit "
                      "with --resume and a fresh --deadline-s")
        job.finished_s = time.time()
        self.stats.jobs_preempted += 1
        self.stats.jobs_deadline_exceeded += 1
        self.svc_metrics["jobs"].inc(outcome="deadline_exceeded")
        self._journal_append(REC_FINISH, job_id=job.id,
                             state=JOB_PREEMPTED, rc=EXIT_PREEMPTED,
                             detail=job.detail)
        self.obs.event("job_deadline_exceeded", job_id=job.id,
                       trace_id=job.trace_id, ran=False)

    def _run_job(self, job: Job, lease) -> None:
        # end-to-end deadline: subtract the queue + lease
        # wait from the admitted budget HERE, at the exec boundary —
        # a spent budget lands terminal without burning a device
        # second; a live one rides into the run as --deadline-s, where
        # the cli's drain timer enforces it at batch boundaries
        remaining_s = self._deadline_remaining_s(job)
        if remaining_s is not None and remaining_s <= 0:
            self._finish_deadline_spent(job)
            return
        job.state = JOB_RUNNING
        job.started_s = time.time()
        if job.stream:
            # lane affinity for the client's NEXT stream (and, via the
            # journal's start record, for a crash-reopened one)
            with self._lock:
                self._client_lanes[job.client] = lease.lane
        # journal the start BEFORE the run: a kill -9 from here on
        # makes the job a --resume continuation at the next start
        self._journal_append(REC_START, job_id=job.id,
                             lane=lease.lane)
        self.obs.event("job_start", job_id=job.id, lane=lease.lane,
                       trace_id=job.trace_id,
                       queue_wait_s=round(job.started_s
                                          - job.submitted_s, 6))
        # a drain latched between this job's dequeue and here must
        # still reach its flag (the _begin_drain snapshot may have
        # missed it)
        if self.drain.requested and job.drain is not None \
                and not job.drain.requested:
            job.drain.request(self.drain.reason or "service draining")
        warm = _JobWarm(job.drain, lease, shared=self.warm,
                        expose_devices=self._expose_devices,
                        trace_id=job.trace_id, flight=job.flight)
        rc: int | None = None
        kw = {"input_stream": job.feed} if job.stream else {}
        exec_argv = job.argv
        if remaining_s is not None:
            # pass the REMAINING budget down, not the original: the
            # run's own --deadline-s timer then enforces exactly what
            # is left after this daemon's queue + lease wait
            exec_argv = list(job.argv) \
                + [f"--deadline-s={max(remaining_s, 0.001):.3f}"]
        try:
            with self.obs.span("job_exec", job_id=job.id,
                               trace_id=job.trace_id,
                               lane=lease.lane):
                rc = self._runner(exec_argv, stdout=job.outbuf,
                                  stderr=job.errbuf, warm=warm, **kw)
        except BaseException as e:   # InjectedKill, stray PwasmError —
            # a dying job must never take the daemon down with it
            job.detail = f"job raised {type(e).__name__}: {e}"
        job.rc = rc
        job.finished_s = time.time()
        if job.flight is not None:
            job.flight.note("exec", max(
                0.0, job.finished_s - job.started_s),
                lane=lease.lane, rc=rc)
        self._job_walls.append(job.finished_s - job.started_s)
        job.stderr_tail = job.errbuf.getvalue()[-4000:]
        # a resident daemon must not retain every finished job's full
        # output buffers for its whole life: keep only the served tail
        # and drop the StringIOs (re-pointing the job's drain at the
        # daemon stderr first — a late message must not hit a dropped
        # buffer)
        if job.drain is not None:
            job.drain.stderr = self.stderr
        job.errbuf = job.outbuf = None
        job.stats = self._read_job_stats(job)
        if isinstance(job.stats, dict) \
                and isinstance(job.stats.get("m2m"), dict):
            self._m2m_fold(job.stats["m2m"])
        if rc == 0 and job.delta is not None:
            # the fractional hit lands at FINISH, not admission: a
            # failed tail run must not count as served traffic
            self._cache_delta_finish(job)
        if rc == 0:
            job.state = JOB_DONE
            self.stats.jobs_completed += 1
        elif rc == EXIT_PREEMPTED and job.cancel_requested:
            job.state = JOB_CANCELLED
            job.detail = ("cancelled at a batch boundary; the partial "
                          "report is checkpointed (resumable)")
            self.stats.jobs_cancelled += 1
        elif rc == EXIT_PREEMPTED and job.drain is not None \
                and str(job.drain.reason
                        or "").startswith("deadline_exceeded"):
            # the run's own --deadline-s timer pulled the drain flag:
            # same resumable shape as a drain preemption, but the
            # verdict must say WHY — the client decides whether a
            # resume deserves a fresh budget
            job.state = JOB_PREEMPTED
            job.detail = ("deadline_exceeded: stopped at a batch "
                          "boundary with a valid resumable "
                          "checkpoint; --resume with a fresh "
                          "--deadline-s completes it")
            self.stats.jobs_preempted += 1
            self.stats.jobs_deadline_exceeded += 1
            self.obs.event("job_deadline_exceeded", job_id=job.id,
                           trace_id=job.trace_id, ran=True)
        elif rc == EXIT_PREEMPTED:
            job.state = JOB_PREEMPTED
            job.detail = ("preempted by service drain; --resume "
                          "completes it")
            self.stats.jobs_preempted += 1
        else:
            job.state = JOB_FAILED
            if not job.detail:
                job.detail = f"exit {rc}"
            self.stats.jobs_failed += 1
        self.stats.rollup_job(job.stats)
        # fold the finished job into the Prometheus surface: outcome
        # counter, wall + queue-wait histograms, and the job's --stats
        # JSON into the cumulative run-level families (the same fold
        # the one-shot CLI applies to itself — obs/catalog.py)
        from pwasm_tpu_torch.obs.catalog import fold_run_stats
        self.svc_metrics["jobs"].inc(outcome=job.state)
        self.svc_metrics["lane_jobs"].inc(lane=str(lease.lane))
        # exemplar-linked: the bucket this job
        # landed in carries its trace_id, so a p99 bucket in the
        # exposition links straight to `pafreport inspect <job>`
        self.svc_metrics["job_wall_seconds"].observe(
            job.finished_s - job.started_s, trace_id=job.trace_id)
        self.svc_metrics["queue_wait_seconds"].observe(
            max(0.0, job.started_s - job.submitted_s),
            trace_id=job.trace_id)
        fold_run_stats(self.run_metrics, job.stats)
        if job.state == JOB_DONE and job.cache is not None \
                and self.cache is not None:
            # the outputs this run just wrote become the entry an
            # identical later submit is answered from at admission
            self._cache_insert(job)
        elif job.state == JOB_DONE and job.dstate is not None \
                and self.cache is not None:
            # a delta-mirrored stream inserts too: its digest column
            # is the delta index a later stream or file job of the
            # same family extends
            self._stream_cache_insert(job)
        # past every RAM consumer of job.stats: big results move to
        # the spool (index-only in RAM), then the terminal verdict —
        # with its spool pointer — lands durably in the journal
        self._spool_result(job)
        self._journal_append(REC_FINISH, job_id=job.id,
                             state=job.state, rc=rc,
                             detail=job.detail or None,
                             spool=job.spool)
        self.obs.event(
            "job_finish", job_id=job.id, state=job.state, rc=rc,
            lane=lease.lane, trace_id=job.trace_id,
            wall_s=round(job.finished_s - job.started_s, 6),
            detail=job.detail or None)
        self._write_textfile()

    def _read_job_stats(self, job: Job) -> dict | None:
        if job.stats_path is None:
            return None
        try:
            import json
            with open(job.stats_path) as f:
                st = json.load(f)
        except (OSError, ValueError):
            return None
        if job.stats_injected:
            try:
                os.unlink(job.stats_path)
            except OSError:
                pass
        return st if isinstance(st, dict) else None

    # ---- admission -----------------------------------------------------
    def _arm_job(self, job: Job) -> None:
        """Per-job drain flag + RunStats sink (a daemon-owned stats
        tmp is injected when the client didn't pass ``--stats`` — the
        daemon needs every job's RunStats for the roll-up and warm-hit
        gates) + the flight recorder.  Shared by fresh
        admissions and journal recovery."""
        from pwasm_tpu_torch.obs.flight import FlightRecorder
        job.flight = FlightRecorder(trace_id=job.trace_id or None)
        if job.recovered:
            job.flight.mark("journal_recovered")
        job.drain = SignalDrain(stderr=job.errbuf,
                                hard_exit=lambda code: None)
        stats_path = next(
            (a.split("=", 1)[1] for a in job.argv
             if a.startswith("--stats=")), None)
        if stats_path is None:
            stats_path = os.path.join(self._jobdir.name,
                                      f"{job.id}.stats.json")
            job.argv = job.argv + [f"--stats={stats_path}"]
            job.stats_injected = True
        job.stats_path = stats_path

    def submit(self, argv: list, cwd: str | None = None,
               client: str | None = None,
               priority: str | None = None,
               stream: bool = False,
               trace_id: str | None = None,
               deadline_ms: int | None = None,
               delta: bool = False) -> Job:
        """Validate + admit one job (raises Draining/QueueFull/
        ValueError).  Also the in-process API the tests drive.
        ``cwd`` is the CLIENT's working directory: relative paths in
        the job argv are resolved against it, not the daemon's cwd —
        the cold-to-warm drop-in contract (the client sends it
        automatically).  ``client`` is the fair-share identity (the
        protocol layer defaults it to the socket-peer uid);
        ``priority`` must name a ``--priority-lanes`` tier when
        given.  ``stream=True`` admits a SOCKET-STREAM job (the
        ``stream`` protocol verb): its PAF records arrive later as
        ``stream-data`` frames, so the argv must carry no positional
        input, and the job gets a quota-gated StreamFeed plus lane
        affinity to the client's previous stream.  ``delta=True`` (a
        stream under ``--result-cache``) classifies the stream against
        the cache's per-line digest columns: while a same-family entry
        could still prefix-match, the job is HELD out of the queue and
        its frames parked (``_delta_stream_data``)."""
        if not isinstance(argv, list) \
                or not all(isinstance(a, str) for a in argv) \
                or not argv:
            raise ValueError("args must be a non-empty list of strings")
        if client is None:
            client = ""
        if not isinstance(client, str) or len(client) > 64 \
                or not _CLIENT_RE.match(client or "x"):
            raise ValueError(
                "client must be a short identifier "
                "([A-Za-z0-9_.:@/-]{1,64})")
        if priority is None:
            priority = ""
        if not isinstance(priority, str):
            raise ValueError("priority must be a string")
        # cross-process trace identity: ServiceClient mints
        # one and sends it on every frame; a frame without one (an
        # older client, a hand-rolled nc pipe) gets a daemon-minted id
        # so EVERY job is trace-correlatable
        if trace_id is None or trace_id == "":
            from pwasm_tpu_torch.obs.events import new_run_id
            trace_id = new_run_id()
        if not isinstance(trace_id, str) or len(trace_id) > 64 \
                or not _CLIENT_RE.match(trace_id):
            raise ValueError(
                "trace_id must be a short identifier "
                "([A-Za-z0-9_.:@/-]{1,64})")
        if deadline_ms is not None:
            # the REMAINING end-to-end budget as of this hop;
            # 0/negative is valid on the wire — the DISPATCH
            # layer answers it deadline_exceeded before calling here
            if isinstance(deadline_ms, bool) \
                    or not isinstance(deadline_ms, int) \
                    or deadline_ms <= 0:
                raise ValueError(
                    "deadline_ms must be a positive integer "
                    "millisecond budget")
        if priority:
            lanes = [l for l in self.queue.priority_lanes if l]
            if not lanes:
                raise ValueError(
                    "this daemon has no --priority-lanes configured")
            if priority not in lanes:
                raise ValueError(
                    f"unknown priority lane {priority!r} "
                    f"(configured: {','.join(lanes)})")
        from pwasm_tpu_torch.cli import _SERVICE_CMDS, CliError, _parse_args
        if argv[0] in _SERVICE_CMDS:
            raise ValueError(
                f"nested service command {argv[0]!r} not allowed")
        if cwd is not None:
            if not isinstance(cwd, str) or not os.path.isabs(cwd):
                raise ValueError("cwd must be an absolute path")
            argv = _absolutize_argv(argv, cwd)
        # parse with the REAL CLI grammar (clustered short flags like
        # `-Do out` included) so the cold-to-warm drop-in contract
        # cannot drift from what cli.run would accept
        try:
            job_opts, _pos = _parse_args(list(argv))
        except CliError as e:
            raise ValueError(f"unparseable job argv: "
                             f"{str(e).splitlines()[-1]}")
        if "o" not in job_opts:
            raise ValueError(
                "service jobs must write their report to a file "
                "(-o <report>): the socket carries control frames, "
                "not report bytes")
        if stream:
            if _pos:
                raise ValueError(
                    "stream jobs read records from stream-data "
                    "frames: drop the positional PAF path "
                    f"({_pos[0]!r})")
            for bad in ("follow", "many2many"):
                if bad in job_opts:
                    raise ValueError(
                        f"--{bad} does not apply to a socket stream")
        if self.drain.requested:
            raise Draining("service is draining")
        # the result cache: looked up HERE, before queue.submit, so a
        # hit never touches the queue, a lease, the probe or a kernel.
        # Streams bypass it (their input is not a file); a miss keeps
        # its key, under which the finished job inserts its outputs
        cache_row = None
        delta_served = None
        if self.cache is not None and not stream:
            from pwasm_tpu_torch.service.cache import (classify_argv,
                                                       derive_key,
                                                       serve_outputs)
            cls = classify_argv(argv)
            key = derive_key(cls) if cls is not None else None
            if key is not None:
                got = self.cache.get(key)
                if got is not None:
                    try:
                        served = serve_outputs(got[1], cls.output_paths)
                    except OSError:
                        served = False   # unwritable output: the real
                        #   run reports the real diagnostic
                    if served:
                        return self._admit_cache_hit(
                            argv, client, priority, trace_id, got[0])
                cache_row = (key, cls)
                # an exact miss whose same-family entry holds a per-line
                # PREFIX of this input: its report is served now and the
                # job re-armed as a --resume of the tail.  The journal's
                # admit keeps the ORIGINAL argv: a crash replay re-runs
                # the job cold, which is always correct
                from pwasm_tpu_torch.cli import _cache_delta_serve
                delta_served = _cache_delta_serve(self.cache, cls)
        base_argv = list(argv)     # what the journal records: the
        #   pre-injection argv (the injected stats tmp lives in a
        #   directory that dies with this process)
        exec_argv = list(argv)
        if delta_served is not None:
            exec_argv.append("--resume")
        with self._lock:
            self._next_id += 1
            job = Job(id=f"job-{self._next_id:04d}", argv=exec_argv,
                      client=client, priority=priority,
                      trace_id=trace_id)
        job.deadline_ms = deadline_ms   # the monotonic anchor is
        #   Job.submitted_mono (defaulted at construction, just now)
        job.cache = cache_row      # (key, classified) of a cacheable
        #   miss: _run_job inserts the finished outputs under it
        job.delta = delta_served
        self._arm_job(job)
        if stream:
            from pwasm_tpu_torch.stream.pafstream import StreamFeed
            job.stream = True
            job.feed = StreamFeed(idle_timeout_s=self.stream_idle_s)
            # the drain flag wakes a feed-blocked job; the batch hook
            # feeds the per-client arrival-batch counter
            job.feed.bind_drain(job.drain)
            job.feed.on_batch = \
                lambda n, c=(client or "default"): \
                self.stream_metrics["batches"].inc(1, client=c)
            # lane affinity: a client's consecutive (or crash-reopened)
            # streams land on the lane whose warm state they built
            with self._lock:
                job.prefer_lane = self._client_lanes.get(client)
            self.streams.register(job.id, client, job.feed)
            if delta and self.cache is not None:
                # the daemon digests the stream's lines itself, so the
                # stream is classified against the cache like a file
                # input: a strict-prefix match serves the cached
                # report and re-arms the job as a --resume over it
                job.dstate = self._delta_stream_open(job_opts)
        # write-ahead order: the admit record lands BEFORE the queue
        # can hand the job to a worker — a worker only journals start
        # after a successful dequeue, so the file order admit < start
        # that replay's fold depends on cannot invert.  (It also lands
        # before the ok frame, so every ACKED admission is durable; a
        # crash in the gap between append and ack at worst re-runs a
        # job nobody was promised — the benign direction.)
        self._journal_append(REC_ADMIT, job_id=job.id,
                             argv=base_argv, client=client,
                             priority=priority, trace_id=trace_id,
                             **({"stream": True} if stream else {}),
                             **({"deadline_ms": deadline_ms}
                                if deadline_ms else {}))
        if delta_served is not None:
            # a delta job is not a pure hit: its cache_hit record
            # carries the served-vs-total split, and the start and
            # finish records that follow show the tail's real run
            self._journal_append(REC_CACHE_HIT, job_id=job.id,
                                 delta=True, served=delta_served[0],
                                 total=delta_served[1])
            self.obs.event("cache_delta", job_id=job.id,
                           trace_id=job.trace_id,
                           served=delta_served[0],
                           total=delta_served[1])
        try:
            # a delta-HELD stream defers its queue entry: its frames
            # promote it to a --resume, or it goes cold at the
            # viability, cap or end boundary (_delta_stream_queue)
            if not (job.dstate is not None
                    and job.dstate.get("mode") == "holding"):
                self.queue.submit(job)
        except (Draining, QueueFull):
            # the admission never happened: retract the id so replay
            # cannot resurrect a job the client was told was rejected
            self._journal_append(REC_EVICT, job_id=job.id)
            if stream:
                self.streams.unregister(job.id)
            raise
        with self._lock:
            self.jobs[job.id] = job
            self._clients_seen.add(client)
        self.stats.jobs_accepted += 1
        self.svc_metrics["jobs"].inc(outcome="accepted")
        self.obs.event("job_admit", job_id=job.id, client=client,
                       trace_id=job.trace_id, stream=stream,
                       queue_depth=self.queue.depth())
        return job

    def _admit_cache_hit(self, argv: list, client: str, priority: str,
                         trace_id: str, manifest: dict) -> Job:
        """Admit-and-finish a job answered from the result cache: its
        output files are already written from the CRC-verified blobs,
        so the job lands DONE without entering the queue.  Journaled as
        admit + cache_hit + finish in one durable append, so a replay
        restores a truthful terminal verdict (a finish with no start,
        explained by the cache_hit line)."""
        from pwasm_tpu_torch.service.cache import (argv_stats_path,
                                                   write_hit_stats)
        with self._lock:
            self._next_id += 1
            job = Job(id=f"job-{self._next_id:04d}", argv=list(argv),
                      client=client, priority=priority,
                      trace_id=trace_id)
        job.state = JOB_DONE
        job.rc = 0
        job.detail = ("served from the result cache "
                      "(byte-identical to a full run)")
        # a --stats-asking client gets the file a cold-run hit writes
        job.stats = write_hit_stats(manifest, argv_stats_path(argv))
        job.started_s = job.submitted_s
        job.finished_s = time.time()
        job.errbuf = job.outbuf = None
        if self.journal is not None:
            t = round(time.time(), 3)
            if self.journal.append_many([
                    (REC_ADMIT, {"job_id": job.id, "t": t,
                                 "argv": list(argv), "client": client,
                                 "priority": priority,
                                 "trace_id": trace_id}),
                    (REC_CACHE_HIT, {"job_id": job.id, "t": t}),
                    (REC_FINISH, {"job_id": job.id, "t": t,
                                  "state": JOB_DONE, "rc": 0,
                                  "detail": job.detail})]):
                for rec in (REC_ADMIT, REC_CACHE_HIT, REC_FINISH):
                    self.svc_metrics["journal_records"].inc(rec=rec)
            elif not self._journal_warned:
                self._journal_warned = True
                self._say(f"warning: job-journal append failed "
                          f"({self.journal.broken}); continuing "
                          "WITHOUT crash recovery")
                self.obs.event("journal_broken",
                               detail=self.journal.broken)
        job.done.set()
        with self._lock:
            self.jobs[job.id] = job
            self._clients_seen.add(client)
        self.stats.jobs_accepted += 1
        self.stats.jobs_completed += 1
        self.svc_metrics["jobs"].inc(outcome="accepted")
        self.svc_metrics["jobs"].inc(outcome=JOB_DONE)
        wall = max(0.0, job.finished_s - job.submitted_s)
        # the wall and wait histograms see the SERVED latency
        self.svc_metrics["job_wall_seconds"].observe(
            wall, trace_id=job.trace_id)
        self.svc_metrics["queue_wait_seconds"].observe(
            0.0, trace_id=job.trace_id)
        self.obs.event("job_admit", job_id=job.id, client=client,
                       trace_id=job.trace_id, stream=False,
                       queue_depth=self.queue.depth())
        self.obs.event("cache_hit", job_id=job.id, trace_id=job.trace_id)
        self.obs.event("job_finish", job_id=job.id, state=JOB_DONE,
                       rc=0, trace_id=job.trace_id,
                       wall_s=round(wall, 6), detail=job.detail)
        self._write_textfile()
        return job

    def _cache_delta_finish(self, job: Job) -> None:
        """A delta job finished cleanly: account the served fraction and
        stamp its stats (the result frame's and the client's own
        ``--stats`` file) ``cache_delta: true`` with the served and
        total record counts.  A held stream's promote fixed its served
        count when only part of the input had arrived: its total is
        the whole stream, known now."""
        if job.stream and job.feed is not None:
            job.delta = (job.delta[0],
                         max(job.delta[1], job.feed.records_in))
        if self.cache is not None:
            self.cache.note_delta(*job.delta)
        if not isinstance(job.stats, dict):
            return
        job.stats["cache_delta"] = True
        job.stats["cache_records_served"] = job.delta[0]
        job.stats["cache_records_total"] = job.delta[1]
        if job.stats_path is not None and not job.stats_injected:
            try:
                import json
                with open(job.stats_path, "w") as f:
                    json.dump(job.stats, f, indent=1)
                    f.write("\n")
            except OSError:
                pass

    # ---- delta over socket streams ------------------------------------
    #
    # A file job's delta admission has the whole input in hand; a
    # stream's input arrives one frame at a time.  So the stream-delta
    # admission is a small state machine on Job.dstate:
    #
    #   holding  — frames are digested and PARKED (not fed, not
    #              queued) while any same-family cache entry could
    #              still prefix-match the growing digest column;
    #   resolved — the job is queued (as a --resume over served
    #              cached bytes, or cold); parked frames were
    #              replayed into the feed, and the daemon keeps
    #              mirroring the digest column so a clean finish
    #              inserts a delta-indexed entry of its own;
    #   off      — bookkeeping abandoned (cancel/drain while held).
    #
    # Digests are the SERVER's: the client's advisory column
    # (stream-data "digests") is cross-checked, never trusted — a
    # disagreement is a loud bad_request, not a wrong serve.

    def _delta_stream_open(self, job_opts: dict) -> dict | None:
        """Classify a delta-opted stream against the cache; ``None``
        when the shape can never delta-match (bypass flag, non-report
        output, unreadable ref) — the stream then runs exactly as a
        non-delta stream."""
        from pwasm_tpu_torch.service.cache import (DELTA_MAX_LINES,
                                                   classify_stream,
                                                   delta_eligible,
                                                   stream_keys)
        from pwasm_tpu_torch.stream.pafstream import LineAssembler
        cls = classify_stream(job_opts)
        if cls is None or not delta_eligible(cls):
            return None
        keys = stream_keys(cls, [])
        if keys is None:
            return None
        cands = self.cache.delta_index(keys[1])
        return {
            # no candidates = nothing to wait for: queue now, mirror
            # only (this stream still INSERTS a delta entry at finish)
            "mode": "holding" if cands else "resolved",
            "cls": cls, "family": keys[1],
            "digests": [], "held": [],
            "asm": LineAssembler(),
            "cands": cands,
            # parked lines stay under the per-stream buffer quota the
            # feed itself would have enforced
            "cap": min(self.streams.max_buffer, DELTA_MAX_LINES),
        }

    def _delta_stream_queue(self, job: Job) -> dict | None:
        """Late queue entry for a held stream; an error response means
        the hold state is UNCHANGED and the triggering frame (or
        stream-end) resends after backoff — the same all-or-nothing
        contract every stream frame has."""
        try:
            self.queue.submit(job)
        except Draining as e:
            return protocol.err(protocol.ERR_DRAINING, str(e))
        except QueueFull as e:
            return protocol.err(
                protocol.ERR_QUEUE_FULL, str(e),
                queue_depth=self.queue.depth(),
                max_queue=self.queue.max_queue,
                retry_after_s=self._retry_after_s())
        return None

    def _delta_stream_replay(self, job: Job, extra: list,
                             end: bool = False) -> None:
        """Feed the parked frames (plus the triggering frame) into the
        now-queued job's StreamFeed, committing the digest mirror for
        the triggering frame as the feed commits its lines."""
        from pwasm_tpu_torch.service.cache import line_digest
        ds = job.dstate
        feed = job.feed
        for fr in ds["held"] + list(extra):
            n = feed.completed(fr)
            if n:
                try:
                    self.streams.admit(job.id, n)
                except QueueFull:
                    # the hold cap kept parked lines under the
                    # per-stream quota; a shared-total squeeze here is
                    # transient — backpressure resumes on the next
                    # LIVE frame, and parked frames cannot be dropped
                    # (they were acked)
                    pass
            fed = feed.feed(fr)
            if fed:
                self.stream_metrics["records"].inc(
                    fed, client=job.client or "default")
        for fr in extra:
            for ln in ds["asm"].push(fr):
                ds["digests"].append(line_digest(ln))
        ds["held"] = []
        if end:
            for tail in ds["asm"].flush():
                ds["digests"].append(line_digest(tail))
            feed.end()

    def _delta_stream_go_cold(self, job: Job, extra: list,
                              end: bool = False) -> dict | None:
        ds = job.dstate
        err = self._delta_stream_queue(job)
        if err is not None:
            return err
        self._delta_stream_replay(job, extra, end=end)
        ds["mode"] = "resolved"
        return None

    def _delta_stream_promote(self, job: Job, hit: tuple,
                              digests: list, extra: list,
                              end: bool = False) -> dict | None:
        """Serve a delta hit to a held stream: cached report bytes out,
        job re-armed as a --resume, queued, parked frames replayed.
        Falls back to a cold run on any write failure — delta is an
        optimization, never a correctness gate."""
        ds = job.dstate
        _key, _manifest, blobs, nl = hit
        report = ds["cls"].output_paths.get("o")
        served = None
        if report is not None and "o" in blobs:
            try:
                with open(report, "wb") as f:
                    f.write(blobs["o"])
                from pwasm_tpu_torch.cli import _unlink_checkpoint
                _unlink_checkpoint(report)
                served = (max(0, nl - 1), len(digests))
            except OSError:
                served = None
        if served is None:
            return self._delta_stream_go_cold(job, extra, end=end)
        # arm BEFORE queueing — a worker may dequeue at once, and it
        # must see the --resume and the served report
        job.argv.append("--resume")
        job.delta = served
        err = self._delta_stream_queue(job)
        if err is not None:
            # unwind so the client's verbatim resend resolves again
            # cleanly (the report file is written again then)
            job.argv.pop()
            job.delta = None
            return err
        self._journal_append(REC_CACHE_HIT, job_id=job.id,
                             delta=True, served=served[0],
                             total=served[1])
        self.obs.event("cache_delta", job_id=job.id,
                       trace_id=job.trace_id,
                       served=served[0], total=served[1])
        self._delta_stream_replay(job, extra, end=end)
        ds["digests"] = list(digests)
        ds["mode"] = "resolved"
        return None

    def _delta_stream_data(self, job: Job, req: dict,
                           data: str) -> dict:
        """One stream-data frame while HELD: digest its lines, decide
        hit / keep-holding / go-cold, answer the client."""
        from pwasm_tpu_torch.service.cache import line_digest
        ds = job.dstate
        feed = job.feed
        asm = ds["asm"]
        lines = asm.preview(data)
        if not lines and data:
            from pwasm_tpu_torch.stream.pafstream import MAX_RECORD_BYTES
            if len(asm.pending) + len(data) > MAX_RECORD_BYTES:
                return protocol.err(
                    protocol.ERR_BAD_REQUEST,
                    f"unterminated PAF record exceeds "
                    f"{MAX_RECORD_BYTES} bytes — stream-data frames "
                    "must eventually carry a newline")
        digs = [line_digest(ln) for ln in lines]
        cdigs = req.get("digests")
        if cdigs is not None and list(cdigs) != digs:
            return protocol.err(
                protocol.ERR_BAD_REQUEST,
                "stream-data digests disagree with the server's own "
                "line digests — refusing to classify this stream "
                "against the cache (client-side assembler bug?)")
        new = ds["digests"] + digs
        joined = "".join(new)
        # a candidate fully inside our column decides NOW
        if any(nl < len(new) and dx == joined[:len(dx)]
               for nl, dx in ds["cands"]):
            hit = self.cache.delta_lookup(ds["family"], new)
            if hit is not None:
                err = self._delta_stream_promote(job, hit, new,
                                                 extra=[data])
                if err is not None:
                    return err
                return protocol.ok(buffered=feed.buffered,
                                   records=feed.records_in)
            # the snapshot rotted under us: refresh and fall through
            ds["cands"] = self.cache.delta_index(ds["family"])
        # still worth holding?  some candidate our column prefixes
        # (longer = a strict hit later; equal = an exact-length hit at
        # stream-end) and the parked lines stay under the buffer quota
        viable = any(nl >= len(new) and dx[:len(joined)] == joined
                     for nl, dx in ds["cands"])
        if viable and len(new) <= ds["cap"]:
            ds["held"].append(data)
            ds["digests"] = new
            asm.push(data)
            return protocol.ok(buffered=len(new), records=len(new))
        err = self._delta_stream_go_cold(job, extra=[data])
        if err is not None:
            return err
        return protocol.ok(buffered=feed.buffered,
                           records=feed.records_in)

    def _delta_stream_finish(self, job: Job) -> dict:
        """stream-end while HELD: the column is final — one last
        lookup with exact-length matches allowed, then promote or run
        cold over the replayed frames."""
        from pwasm_tpu_torch.service.cache import line_digest
        ds = job.dstate
        feed = job.feed
        tail = ds["asm"].pending
        final = ds["digests"] + ([line_digest(tail)] if tail else [])
        hit = self.cache.delta_lookup(ds["family"], final,
                                      allow_equal=True) \
            if len(final) >= 2 else None
        if hit is not None:
            err = self._delta_stream_promote(job, hit, final,
                                             extra=[], end=True)
        else:
            err = self._delta_stream_go_cold(job, extra=[], end=True)
        if err is not None:
            return err
        return protocol.ok(records=feed.records_in,
                           buffered=feed.buffered)

    def _stream_cache_insert(self, job: Job) -> None:
        """A cleanly finished delta-mirrored stream becomes a cache
        entry with a per-line delta index — the next stream (or FILE
        job: the family namespace is shared) that extends this one is
        served as a delta.  Every guard degrades to 'no insert'."""
        from pwasm_tpu_torch.service.cache import (DELTA_MAX_LINES,
                                                   stream_keys)
        ds = job.dstate
        feed = job.feed
        digests = ds.get("digests") or []
        if ds.get("mode") != "resolved" or feed is None \
                or not feed.ended \
                or feed.records_in != len(digests) \
                or len(digests) < 2 or len(digests) > DELTA_MAX_LINES:
            return
        keys = stream_keys(ds["cls"], digests)
        if keys is None:
            return
        report = ds["cls"].output_paths.get("o")
        if report is None:
            return
        try:
            with open(report, "rb") as f:
                blob = f.read()
        except OSError:
            return
        if self.cache.insert(
                keys[0], {"o": blob}, stats=job.stats,
                delta={"family": keys[1], "lines": len(digests),
                       "dx": "".join(digests).encode("ascii")}):
            self.obs.event("cache_insert", job_id=job.id,
                           trace_id=job.trace_id)

    def _cache_insert(self, job: Job) -> None:
        """Store a cleanly finished job's output files under its
        admission key (``insert_from_paths``, the cold CLI's populate):
        the key's re-derivation skips the insert when the input was
        rewritten meanwhile.  A skipped insert (a full disk, a drifted
        key, an unreadable output) warns once an outage; the job was
        served either way."""
        from pwasm_tpu_torch.service.cache import insert_from_paths
        key, cls = job.cache
        if insert_from_paths(self.cache, key, cls, stats=job.stats):
            self.obs.event("cache_insert", job_id=job.id,
                           trace_id=job.trace_id)
            self._cache_insert_warned = False   # writable again: the
            #                                     next outage warns
        elif not self._cache_insert_warned:
            self._cache_insert_warned = True
            self._say(f"warning: result-cache insert skipped (first on "
                      f"{job.id}) — serving continues without caching; "
                      "see cache.insert_errors / "
                      "pwasm_cache_insert_errors_total")

    def _m2m_fold(self, m: dict) -> None:
        """Fold a finished m2m-stream session's flow (its ``--stats``
        ``m2m`` block) into the cumulative svc-stats ``m2m`` block and
        the ``pwasm_m2m_*`` counters."""
        with self._lock:
            self._m2m_done["sessions"] += 1
            for k in self._m2m_done:
                if k != "sessions":
                    try:
                        self._m2m_done[k] += int(m.get(k, 0) or 0)
                    except (TypeError, ValueError):
                        pass
        self.m2m_metrics["sessions"].inc()
        for k, fam in (("targets_in", "targets_in"),
                       ("targets_scored", "targets_scored"),
                       ("targets_reused", "targets_reused"),
                       ("pairs_dispatched", "pairs_dispatched"),
                       ("pairs_reused", "pairs_reused"),
                       ("batches", "batches"),
                       ("sections_emitted", "sections")):
            try:
                v = int(m.get(k, 0) or 0)
            except (TypeError, ValueError):
                continue
            if v > 0:
                self.m2m_metrics[fam].inc(v)

    def _m2m_stats(self) -> dict:
        """The svc-stats ``m2m`` block: live m2m-stream sessions read
        off their feeds' published progress, finished ones from the
        cumulative fold (a one-shot ``--many2many`` job is not a
        session: it counts as a job)."""
        with self._lock:
            out = dict(self._m2m_done)
            jobs = [j for j in self.jobs.values()
                    if j.stream and j.feed is not None
                    and j.state not in TERMINAL_STATES]
        live = 0
        for j in jobs:
            prog = getattr(j.feed, "m2m_progress", None)
            if not isinstance(prog, dict):
                continue
            live += 1
            for k in out:
                if k == "sessions":
                    continue
                try:
                    out[k] += int(prog.get(k, 0) or 0)
                except (TypeError, ValueError):
                    pass
        out["sessions"] += live
        out["active"] = live
        return out

    def _retry_after_s(self) -> float:
        """The queue_full backoff hint: roughly one recent job's wall
        (the deque's maxlen already bounds the window)."""
        walls = list(self._job_walls)
        return round(max(0.5, sum(walls) / len(walls)), 3) if walls \
            else 1.0

    # ---- protocol ------------------------------------------------------
    def _handle_conn(self, conn: socket.socket) -> None:
        if self.tls is not None and conn.family != socket.AF_UNIX:
            # the TLS handshake runs on THIS connection's thread (never
            # the accept loop): a failure — a plaintext probe, a
            # downgrade, a mid-handshake disconnect — is counted and
            # answered with a loud close, and the daemon serves on
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

    def _auth_label(self, client: str) -> str:
        """Metric label for an auth failure: per-client until the
        universe would explode (identity strings are chosen by the
        caller), then the overflow bucket."""
        if client in self._auth_labels or len(self._auth_labels) < 64:
            self._auth_labels.add(client)
            return client
        return "other"

    def _authorize(self, cmd, req: dict, peer) -> dict | None:
        """The scoped-token gate, BEFORE any verb handler runs: an
        unauthorized frame answers ``unauthorized`` having touched no
        queue, journal or lease state.  None = proceed."""
        from pwasm_tpu_torch.service import authz
        scope = authz.required_scope(cmd, req)
        ok = False
        if scope is None or self.auth.allows(req, peer,
                                             authz.SCOPE_ADMIN):
            ok = True
        elif scope == authz.SCOPE_CANCEL_OWN:
            if self.auth.allows(req, peer, scope):
                job = self.jobs.get(req.get("job_id"))
                # unknown ids fall through to the normal unknown_job
                # answer — the auth layer must not become a job-id
                # oracle; a KNOWN job needs ownership: its recorded
                # fair-share identity == the caller's resolved one
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
        # brute-force damping: consecutive failures from this peer
        # earn a capped-exponential hold, served on this connection's
        # own thread — the accept loop and other clients never wait
        time.sleep(self._penalty.fail(key))
        return protocol.err(
            protocol.ERR_UNAUTHORIZED,
            f"cmd {cmd!r} requires scope {scope!r} and the presented "
            "credentials do not grant it (token file: "
            f"{self.auth.path})")

    def _resolve_client(self, req: dict, peer: str | None) -> str:
        """protocol.resolve_client_identity — shared with the fleet
        router so the two bucketings cannot drift."""
        return protocol.resolve_client_identity(req, peer)

    def _dispatch(self, req: dict, peer: str | None = None) -> dict:
        cmd = req.get("cmd")
        if self.auth is not None:
            deny = self._authorize(cmd, req, peer)
            if deny is not None:
                return deny
        if self.rate_limiter is not None \
                and cmd in ("submit", "stream"):
            # a per-identity token bucket in FRONT of admission: a
            # refused frame never reaches the queue or the journal,
            # and the hint is the instant the bucket next holds a
            # whole token
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
        # eviction runs on every request (plus the accept-loop tick
        # and each admission), so reads observe a deterministic
        # post-eviction view: an id past its TTL/LRU budget answers
        # unknown_job on the very next request, not a tick later
        self._evict_results()
        if cmd == "ping":
            return protocol.ok(
                protocol_version=protocol.PROTOCOL_VERSION,
                draining=self._draining)
        if cmd in ("submit", "stream", "stream-data") \
                and self.epoch_lease.fenced:
            # the fence: no NEW work while the lease is lost — the
            # fleet may already have handed our jobs to siblings.
            # Reads (status/result), stream-end, cancel, stats (the
            # lease heartbeat rides it) and drain all still serve.
            return protocol.err(
                protocol.ERR_FENCED,
                "member is fenced (lost its fleet epoch lease): "
                "new work refused until the router re-grants a "
                "lease — submit to the fleet router instead",
                epoch=self.epoch_lease.epoch)
        if cmd == "lease-grant":
            ok, detail = self._lease_grant(
                {"epoch": req.get("epoch"),
                 "ttl_s": req.get("ttl_s")})
            if not ok:
                return protocol.err(
                    protocol.ERR_FENCED, detail,
                    lease=self.epoch_lease.as_dict())
            return protocol.ok(lease=self.epoch_lease.as_dict())
        if cmd == "fence":
            self._fence(str(req.get("reason")
                            or "fence requested by client"))
            return protocol.ok(lease=self.epoch_lease.as_dict())
        if cmd == "submit":
            client = self._resolve_client(req, peer)
            deadline_ms, dl_err = protocol.parse_deadline_ms(req)
            if dl_err is not None:
                return dl_err
            try:
                job = self.submit(req.get("args"),
                                  cwd=req.get("cwd"),
                                  client=client,
                                  priority=req.get("priority"),
                                  trace_id=req.get("trace_id"),
                                  deadline_ms=deadline_ms)
            except ValueError as e:
                return protocol.err(protocol.ERR_BAD_REQUEST, str(e))
            except Draining as e:
                self.stats.jobs_rejected_draining += 1
                self.svc_metrics["jobs"].inc(
                    outcome="rejected_draining")
                return protocol.err(protocol.ERR_DRAINING, str(e))
            except QueueFull as e:
                # the 429: a well-behaved client backs off and retries
                # (`submit --retry` honors retry_after_s with capped-
                # exponential backoff).  The quota is per client, so
                # the frame names WHOSE quota filled.
                self.stats.jobs_rejected += 1
                self.svc_metrics["jobs"].inc(outcome="rejected")
                return protocol.err(
                    protocol.ERR_QUEUE_FULL, str(e),
                    queue_depth=self.queue.depth(),
                    max_queue=self.queue.max_queue,
                    client=client or "default",
                    client_depth=self.queue.client_depths().get(
                        client, 0),
                    retry_after_s=self._retry_after_s())
            return protocol.ok(job_id=job.id,
                               trace_id=job.trace_id,
                               queue_depth=self.queue.depth())
        if cmd == "stream":
            # streaming ingestion: admit a job whose PAF
            # records will arrive as stream-data frames — the
            # minimap2-pipe-over-the-socket shape.  Admission control
            # is the same per-client fair-share gate as submit.
            client = self._resolve_client(req, peer)
            deadline_ms, dl_err = protocol.parse_deadline_ms(req)
            if dl_err is not None:
                return dl_err
            try:
                job = self.submit(req.get("args"),
                                  cwd=req.get("cwd"),
                                  client=client,
                                  priority=req.get("priority"),
                                  stream=True,
                                  trace_id=req.get("trace_id"),
                                  deadline_ms=deadline_ms,
                                  delta=bool(req.get("delta")))
            except ValueError as e:
                return protocol.err(protocol.ERR_BAD_REQUEST, str(e))
            except Draining as e:
                self.stats.jobs_rejected_draining += 1
                self.svc_metrics["jobs"].inc(
                    outcome="rejected_draining")
                return protocol.err(protocol.ERR_DRAINING, str(e))
            except QueueFull as e:
                self.stats.jobs_rejected += 1
                self.svc_metrics["jobs"].inc(outcome="rejected")
                return protocol.err(
                    protocol.ERR_QUEUE_FULL, str(e),
                    queue_depth=self.queue.depth(),
                    max_queue=self.queue.max_queue,
                    client=client or "default",
                    retry_after_s=self._retry_after_s())
            return protocol.ok(job_id=job.id,
                               trace_id=job.trace_id,
                               max_buffer=self.streams.max_buffer,
                               queue_depth=self.queue.depth())
        if cmd in ("stream-data", "stream-end"):
            job = self.jobs.get(req.get("job_id"))
            if job is None:
                return protocol.err(
                    protocol.ERR_UNKNOWN_JOB,
                    f"unknown job_id {req.get('job_id')!r}")
            if not job.stream:
                return protocol.err(
                    protocol.ERR_BAD_REQUEST,
                    f"job {job.id} is not a stream job")
            job.accessed_s = time.time()
            feed = job.feed
            closed = (feed is None or job.state in TERMINAL_STATES
                      or (cmd == "stream-data" and feed.ended))
            if closed and cmd == "stream-data":
                return protocol.err(
                    protocol.ERR_BAD_REQUEST,
                    f"stream {job.id} is closed ({job.state})"
                    + ("; re-open a stream with --resume to complete "
                       "it" if job.state == JOB_PREEMPTED else ""))
            if cmd == "stream-end":
                ds = job.dstate
                if ds is not None and ds.get("mode") == "holding" \
                        and feed is not None and not feed.ended:
                    return self._delta_stream_finish(job)
                if feed is not None:
                    if ds is not None \
                            and ds.get("mode") == "resolved" \
                            and not feed.ended:
                        from pwasm_tpu_torch.service.cache import \
                            line_digest
                        for tail in ds["asm"].flush():
                            ds["digests"].append(line_digest(tail))
                    feed.end()
                return protocol.ok(
                    records=feed.records_in if feed else 0,
                    buffered=feed.buffered if feed else 0)
            data = req.get("data")
            if not isinstance(data, str):
                return protocol.err(
                    protocol.ERR_BAD_REQUEST,
                    "stream-data needs a string data field")
            ds = job.dstate
            if ds is not None and ds.get("mode") == "holding":
                # a delta hold: this frame is digested and parked or
                # promoted instead of fed — the job is not queued yet
                return self._delta_stream_data(job, req, data)
            n = feed.completed(data)
            if not n and data:
                # the record quota counts complete lines, so
                # newline-less frames must be bounded separately or
                # one client grows the partial-record tail without
                # limit (a protocol violation, not backpressure — no
                # resend can help, so the error is NOT queue_full)
                from pwasm_tpu_torch.stream.pafstream import \
                    MAX_RECORD_BYTES
                if feed.tail_bytes + len(data) > MAX_RECORD_BYTES:
                    return protocol.err(
                        protocol.ERR_BAD_REQUEST,
                        f"unterminated PAF record exceeds "
                        f"{MAX_RECORD_BYTES} bytes — stream-data "
                        "frames must eventually carry a newline")
            if n:
                try:
                    # all-or-nothing per frame: a rejected frame left
                    # no assembler state behind and resends verbatim
                    self.streams.admit(job.id, n)
                except QueueFull as e:
                    # the streaming 429: back off (retry_backoff_s)
                    # and resend — the executing job is draining the
                    # buffer at device speed, so the hint is short
                    return protocol.err(
                        protocol.ERR_QUEUE_FULL, str(e),
                        buffered=feed.buffered,
                        max_buffer=self.streams.max_buffer,
                        retry_after_s=0.1)
            fed = feed.feed(data)
            if fed:
                self.stream_metrics["records"].inc(
                    fed, client=job.client or "default")
            if ds is not None and ds.get("mode") == "resolved":
                # keep the digest mirror current for the finish-time
                # insert — AFTER the commit, so a rejected frame's
                # verbatim resend cannot digest twice
                from pwasm_tpu_torch.service.cache import line_digest
                for ln in ds["asm"].push(data):
                    ds["digests"].append(line_digest(ln))
            return protocol.ok(buffered=feed.buffered,
                               records=feed.records_in)
        if cmd == "stats":
            # queue depth / in-flight / breaker state read back from
            # the SAME registry gauges the `metrics` exposition serves
            # — the two operator surfaces cannot drift
            self._refresh_gauges()
            m = self.svc_metrics
            st = self.stats.as_dict(
                queue_depth=int(m["queue_depth"].value()),
                running=int(m["inflight"].value()),
                draining=self._draining,
                max_queue=self.queue.max_queue,
                max_concurrent=self.max_concurrent,
                breaker_state=int(m["breaker_state"].value()))
            # additive (stats_version unchanged): the device-lease
            # lane table — span, busy, per-lane breaker — plus the
            # grant/wait roll-up
            st["lanes"] = self.leases.lane_states()
            st["leases"] = {
                "lanes": self.leases.n_lanes,
                "devices_per_job": self.devices_per_job,
                "busy": self.leases.busy_count(),
                "waiting": self.leases.waiting_count(),
                "grants": self.leases.grants,
                "wait_s_total": round(self.leases.wait_s_total, 6),
            }
            # additive (stats_version unchanged): crash-safety +
            # fair-share surfaces
            st["fair_share"] = {
                "max_queue_per_client": self.queue.max_queue,
                "max_queue_total": self.queue.max_total,
                "priority_lanes": [l for l in
                                   self.queue.priority_lanes if l],
                "clients": {(c or "default"): n for c, n in
                            self.queue.client_depths().items()},
            }
            st["journal"] = {
                "path": self.journal.path if self.journal else None,
                "records": (self.journal.records_written
                            if self.journal else 0),
                "broken": (self.journal.broken is not None
                           if self.journal else False),
                "replays": self.stats.journal_replays,
                "jobs_recovered": self.stats.jobs_recovered,
            }
            st["spool"] = {
                "dir": self.spool_dir,
                "threshold_bytes": self.spool_threshold_bytes,
                "bytes": self.ledger.value("spool"),
            }
            # the result cache: hit/miss flow, bytes on disk, hit ratio
            st["cache"] = self.cache.stats_dict() \
                if self.cache is not None else {"enabled": False}
            # additive (stats_version unchanged): streaming ingestion
            # — live streams, record/batch flow, buffer lag
            tot = self.streams.totals()
            st["streams"] = {
                "active": tot["active"],
                "records_in": tot["records_in"],
                "records_out": tot["records_out"],
                "batches": tot["batches"],
                "lag_records": tot["buffered"],
                "max_buffer": self.streams.max_buffer,
                "max_buffer_total": self.streams.max_total,
            }
            # m2m-stream sessions: arrival and dispatch flow,
            # incremental reuse, section emission
            st["m2m"] = self._m2m_stats()
            # the self-monitoring verdict: `top`'s alerts pane reads it
            # from the same surface as the JSON verbs
            st["health"] = self._health()
            # additive: epoch-lease fencing.  The router's
            # lease heartbeat RIDES the stats poll (req["lease"]), so
            # governance costs zero extra RPCs; the reply always
            # carries the member's lease view (+ the grant verdict
            # when one was attempted)
            lease_req = req.get("lease")
            lb = self.epoch_lease.as_dict()
            if lease_req is not None:
                ok_g, detail = self._lease_grant(lease_req)
                lb = self.epoch_lease.as_dict()
                lb["accepted"] = ok_g
                if not ok_g:
                    lb["refused_detail"] = detail
            st["lease"] = lb
            return protocol.ok(stats=st)
        if cmd == "metrics":
            self._refresh_gauges()
            # exemplars are OPT-IN (frame field / `metrics
            # --exemplars`): the default body stays parseable by
            # strict 0.0.4 scrapers
            return protocol.ok(
                metrics=self.registry.expose(
                    exemplars=bool(req.get("exemplars"))),
                content_type="text/plain; version=0.0.4")
        if cmd == "health":
            # the machine-readable health verdict: ok/degraded/failing
            # + the firing rules + canary state — what `health
            # --exit-code` and any external orchestrator probe consume
            return protocol.ok(health=self._health())
        if cmd == "cache-probe":
            # could this daemon answer a key from its result cache?  A
            # manifest check: no blob reads, no admission
            key = req.get("key")
            if not isinstance(key, str) or not key:
                return protocol.err(protocol.ERR_BAD_REQUEST,
                                    "cache-probe needs a key field")
            fam = req.get("family")
            return protocol.ok(
                enabled=self.cache is not None,
                hit=self.cache is not None and self.cache.contains(key),
                # an entry of the job's FAMILY is held: this daemon
                # could answer the near-repeat as an admission delta
                family_hit=self.cache is not None
                and isinstance(fam, str) and bool(fam)
                and self.cache.contains_family(fam))
        if cmd == "logs":
            # the incident-query verb: filter THIS daemon's --log-json
            # (rotated .1 generation included) by trace_id/job/event —
            # the same query `pafreport logs FILE` runs locally
            return protocol.handle_logs(req, self.log_json_path)
        if cmd == "drain":
            self.drain.request("drain requested by client")
            self._begin_drain(self.drain.reason)
            with self._lock:
                # snapshot under the lock: a concurrent submit mutates
                # self.jobs, and iterating it bare would raise mid-
                # drain (answering bad_request for a drain that DID
                # latch)
                running = sorted(self._running)
                preempted = sorted(
                    j.id for j in self.jobs.values()
                    if j.state == JOB_PREEMPTED
                    and j.started_s is None)
            return protocol.ok(draining=True, running=running,
                               preempted_queued=preempted)
        if cmd in ("status", "result", "cancel", "inspect"):
            job = self.jobs.get(req.get("job_id"))
            if job is None:
                # unknown OR evicted (--result-ttl-s/--max-results):
                # indistinguishable by design
                return protocol.err(
                    protocol.ERR_UNKNOWN_JOB,
                    f"unknown job_id {req.get('job_id')!r}")
            job.accessed_s = time.time()   # the LRU clock
            if cmd == "inspect":
                # the flight record: phase-accounted walls
                # + the event ring — from RAM while the job holds it,
                # from the CRC-verified spool once the result moved
                # to disk
                flight = None
                spool_error = None
                if job.spool is not None:
                    obj, spool_error = self._load_spool(job)
                    flight = obj.get("flight") if obj else None
                elif job.flight is not None:
                    wall = ((job.finished_s or time.time())
                            - job.submitted_s)
                    flight = job.flight.summary(wall_s=wall)
                resp = protocol.ok(job=job.describe(),
                                   trace_id=job.trace_id,
                                   flight=flight)
                if spool_error is not None:
                    resp["spool_error"] = spool_error
                return resp
            if cmd == "status":
                return protocol.ok(job=job.describe(),
                                   queue_depth=self.queue.depth())
            if cmd == "result":
                if req.get("wait", True):
                    job.done.wait(req.get("timeout"))
                d = job.describe()
                if job.state not in TERMINAL_STATES:
                    return protocol.ok(job=d, pending=True)
                stats, tail = job.stats, job.stderr_tail
                spool_error = None
                if job.spool is not None:
                    # disk-spooled result: RAM held only the index —
                    # the frame streams from the spool file on demand
                    obj, spool_error = self._load_spool(job)
                    stats = obj.get("stats") if obj else None
                    tail = str(obj.get("stderr_tail") or "") \
                        if obj else ""
                resp = protocol.ok(job=d, rc=job.rc, stats=stats,
                                   stderr_tail=tail)
                if spool_error is not None:
                    resp["spool_error"] = spool_error
                return resp
            return self._cancel(job)
        return protocol.err(protocol.ERR_UNKNOWN_CMD,
                            f"unknown cmd {cmd!r}")

    def _cancel(self, job: Job) -> dict:
        if job.state == JOB_QUEUED and job.dstate is not None \
                and job.dstate.get("mode") == "holding":
            # a delta-HELD stream is not in the queue (queue.remove
            # would miss it and the running branch would wait forever
            # on a job that never starts): retire it directly
            job.dstate["mode"] = "off"
            self._retire_stream(job)
            job.state = JOB_CANCELLED
            job.rc = None
            job.detail = ("cancelled while held for stream-delta "
                          "classification (never started)")
            job.finished_s = time.time()
            self.stats.jobs_cancelled += 1
            self.svc_metrics["jobs"].inc(outcome="cancelled")
            self._journal_append(REC_FINISH, job_id=job.id,
                                 state=JOB_CANCELLED, rc=None,
                                 detail=job.detail)
            self.obs.event("job_cancel", job_id=job.id, was="held",
                           trace_id=job.trace_id)
            job.done.set()
            return protocol.ok(state=JOB_CANCELLED, was="held")
        if job.state == JOB_QUEUED and self.queue.remove(job):
            self._retire_stream(job)
            job.state = JOB_CANCELLED
            job.rc = None
            job.detail = "cancelled while queued (never started)"
            job.finished_s = time.time()
            self.stats.jobs_cancelled += 1
            self.svc_metrics["jobs"].inc(outcome="cancelled")
            self._journal_append(REC_FINISH, job_id=job.id,
                                 state=JOB_CANCELLED, rc=None,
                                 detail=job.detail)
            self.obs.event("job_cancel", job_id=job.id, was="queued",
                           trace_id=job.trace_id)
            job.done.set()
            return protocol.ok(state=JOB_CANCELLED, was="queued")
        if job.state in TERMINAL_STATES:
            return protocol.ok(state=job.state, was="terminal")
        # running — or QUEUED-but-already-dequeued (the worker holds
        # it between take() and the RUNNING transition, so the queue
        # removal above missed): a per-job graceful drain either way.
        # The job stops at its next batch boundary with a valid
        # checkpoint — a mid-batch kill would only throw away
        # finished work, and the pre-armed drain flag catches the
        # about-to-run case at its first boundary.
        job.cancel_requested = True
        if job.drain is not None:
            job.drain.request("cancelled by client")
        # journaled so a crash mid-cancel cannot silently UN-cancel:
        # replay lands the job terminal-cancelled instead of re-running
        self._journal_append(REC_CANCEL, job_id=job.id)
        self.obs.event("job_cancel", job_id=job.id, was="running",
                       trace_id=job.trace_id)
        return protocol.ok(state="cancelling", was="running")


def load_spool_payload(path: str):
    """(payload, error) from a spooled-result file, CRC-verified (the
    ckpt-v2 rule: a torn or rotted spool is reported unreadable, never
    served as if whole).  Module-level because the fleet router reads
    a DEAD member's spool files during journal-aware failover — same
    verification, different process."""
    import json

    from pwasm_tpu_torch.utils.fsio import payload_crc
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
        if not isinstance(obj, dict):
            raise ValueError("not an object")
        crc = int(obj.pop("crc"))
        if payload_crc(obj) != crc:
            raise ValueError("spool payload CRC mismatch")
        return obj, None
    except (OSError, ValueError, KeyError, TypeError) as e:
        return None, f"spooled result unreadable ({e})"


# the argv slots that hold PATHS, resolved against the client's cwd:
# short value flags (from cli._VALUE_FLAGS; -c is clipmax), --long=FILE
# options, and the positional PAF input.
_PATH_SHORT = frozenset("rows")
_PATH_LONG = frozenset(("stats", "profile", "motifs",
                        "ace", "info", "cons",
                        "trace-json", "log-json", "metrics-textfile"))


def _absolutize_argv(argv: list[str], cwd: str) -> list[str]:
    """Rewrite relative paths in a job argv against the CLIENT's
    ``cwd``, walking tokens with the same grammar as
    ``cli._parse_args`` (clustered short flags, joined or separated
    values, ``--long=value``) so the rewrite cannot disagree with what
    the run will parse.  Unknown flags pass through untouched — the
    submit-time validation rejects the argv right after with the CLI's
    own diagnostic."""
    from pwasm_tpu_torch.cli import _BOOL_FLAGS, _VALUE_FLAGS

    def ab(v: str) -> str:
        # "-" is the conventional stdin marker, not a path
        if not v or v == "-" or os.path.isabs(v):
            return v
        return os.path.join(cwd, v)

    out: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
                if k in _PATH_LONG:
                    a = f"--{k}={ab(v)}"
            out.append(a)
        elif a.startswith("-") and len(a) > 1:
            j = 1
            rebuilt = "-"
            value_flag = None      # set when the flag's value is the
            #                        NEXT argv token
            while j < len(a):
                ch = a[j]
                if ch in _BOOL_FLAGS:
                    rebuilt += ch
                    j += 1
                elif ch in _VALUE_FLAGS:
                    rebuilt += ch
                    if j + 1 < len(a):     # joined value: -oFILE
                        v = a[j + 1:]
                        rebuilt += ab(v) if ch in _PATH_SHORT else v
                    else:
                        value_flag = ch
                    j = len(a)
                else:
                    rebuilt = a            # unknown flag: untouched
                    j = len(a)
            out.append(rebuilt)
            if value_flag is not None and i + 1 < len(argv):
                i += 1
                v = argv[i]
                out.append(ab(v) if value_flag in _PATH_SHORT else v)
        else:
            out.append(ab(a))              # positional: the PAF input
        i += 1
    return out


def _peer_identity(conn: socket.socket) -> str | None:
    """The connection's DEFAULT fair-share identity, attested by the
    transport: an mTLS client certificate's CN (``cn:<name>`` — the
    listener verified the chain against --tls-client-ca, so the name
    is as trustworthy as the CA), else the unix-socket peer uid via
    ``SO_PEERCRED`` (kernel-attested — a client cannot spoof it the
    way a free-form field could), rendered ``uid:<n>``.  An explicit
    ``client=`` submit field overrides it: one uid fronting many
    logical tenants (a scheduler submitting for users) needs the
    finer identity, and admission quotas are a fairness device here,
    not a security boundary.  None when the platform has no peer
    credentials — those submits share the anonymous bucket."""
    from pwasm_tpu_torch.fleet.transport import peer_common_name
    cn = peer_common_name(conn)
    if cn:
        return f"cn:{cn}"
    peercred = getattr(socket, "SO_PEERCRED", None)
    if peercred is None:
        return None
    if conn.family != socket.AF_UNIX:
        # a TCP peer has no kernel credential (Linux answers uid -1
        # rather than failing): identity there is the explicit
        # client_token, never a fake attestation
        return None
    try:
        import struct
        raw = conn.getsockopt(socket.SOL_SOCKET, peercred,
                              struct.calcsize("3i"))
        _pid, uid, _gid = struct.unpack("3i", raw)
        return f"uid:{uid}"
    except (OSError, ValueError):
        return None


def _socket_alive(path: str) -> bool:
    # kept as an alias: the probe itself lives in fleet/transport.py
    # (the single socket factory of the package)
    from pwasm_tpu_torch.fleet.transport import socket_alive
    return socket_alive(path)


def serve_main(argv: list[str], stdout=None, stderr=None) -> int:
    """The ``pafreport serve`` entry point."""
    stderr = stderr if stderr is not None else sys.stderr
    opts: dict[str, str] = {}
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
        elif a == "--warmup":
            opts["warmup"] = "cuda"   # bare form: warm the device path
        elif a == "--cache-prefetch":
            opts["cache-prefetch"] = "64"   # bare form: default depth
        elif a in ("-h", "--help"):
            stderr.write(_SERVE_USAGE)
            return EXIT_USAGE
        else:
            stderr.write(f"{_SERVE_USAGE}\nInvalid argument: {a}\n")
            return EXIT_USAGE
    sock = opts.pop("socket", None)
    if not sock:
        stderr.write(f"{_SERVE_USAGE}\nError: --socket=PATH is "
                     "required\n")
        return EXIT_USAGE
    nums = {}
    for knob, dflt in (("max-queue", 16), ("max-concurrent", 1),
                       ("max-frame-bytes", protocol.MAX_FRAME_BYTES),
                       ("devices-per-job", 1), ("lanes", None),
                       ("max-queue-total", None),
                       ("spool-threshold-bytes", None),
                       ("stream-buffer", 512),
                       ("log-json-max-bytes", None),
                       ("result-cache-max-bytes", None)):
        val = opts.pop(knob, None)
        if val is None:
            nums[knob] = dflt
        elif val.isascii() and val.isdigit() and int(val) >= 1:
            nums[knob] = int(val)
        else:
            stderr.write(f"{_SERVE_USAGE}\nInvalid --{knob} value: "
                         f"{val}\n")
            return EXIT_USAGE
    journal_path = opts.pop("journal", "auto")
    if journal_path == "off":
        journal_path = None
    elif journal_path is not None and journal_path != "auto" \
            and not journal_path.strip():
        stderr.write(f"{_SERVE_USAGE}\nInvalid --journal value\n")
        return EXIT_USAGE
    listen = opts.pop("listen", None)
    if listen is not None:
        from pwasm_tpu_torch.fleet.transport import is_tcp_target
        if not is_tcp_target(listen):
            stderr.write(f"{_SERVE_USAGE}\nInvalid --listen value: "
                         f"{listen} (HOST:PORT)\n")
            return EXIT_USAGE
    journal_dir = opts.pop("journal-dir", None)
    if journal_dir is not None and not journal_dir.strip():
        stderr.write(f"{_SERVE_USAGE}\nInvalid --journal-dir value\n")
        return EXIT_USAGE
    if journal_dir is not None and journal_path != "auto":
        # an explicit --journal=PATH would silently defeat the shared
        # placement a router's --journal-dir computes — refuse the
        # half-applied combination
        stderr.write(f"{_SERVE_USAGE}\nError: --journal-dir and an "
                     "explicit --journal are mutually exclusive "
                     "(the dir DERIVES the journal path so the "
                     "fleet router can find it)\n")
        return EXIT_USAGE
    compile_cache_dir = opts.pop("compile-cache-dir", None)
    if compile_cache_dir is not None and not compile_cache_dir.strip():
        stderr.write(f"{_SERVE_USAGE}\nInvalid --compile-cache-dir "
                     "value\n")
        return EXIT_USAGE
    if compile_cache_dir is not None:
        # a build directory that cannot be created ends the daemon
        # here: no job would build where the operator asked
        from pwasm_tpu_torch.ops._build import use_build_dir
        try:
            compile_cache_dir = use_build_dir(compile_cache_dir)
        except PwasmError as e:
            stderr.write(str(e))
            return e.exit_code
    warmup = None
    if "warmup" in opts:
        warmup = opts.pop("warmup")
        if warmup not in ("cuda", "cpu"):
            stderr.write(f"{_SERVE_USAGE}\nError: invalid --warmup "
                         f"value: {warmup} (must be cuda or cpu)\n")
            return EXIT_USAGE
    spool_dir = opts.pop("spool-dir", None)
    if spool_dir is not None and not spool_dir.strip():
        stderr.write(f"{_SERVE_USAGE}\nInvalid --spool-dir value\n")
        return EXIT_USAGE
    result_cache = opts.pop("result-cache", None)
    if result_cache is not None and not result_cache.strip():
        stderr.write(f"{_SERVE_USAGE}\nInvalid --result-cache "
                     "value\n")
        return EXIT_USAGE
    if result_cache == "off":
        result_cache = None
    cache_prefetch = None
    val = opts.pop("cache-prefetch", None)
    if val is not None:
        if val.isascii() and val.isdigit() and int(val) >= 1:
            cache_prefetch = int(val)
        else:
            stderr.write(f"{_SERVE_USAGE}\nInvalid --cache-prefetch "
                         f"value: {val}\n")
            return EXIT_USAGE
    priority_lanes: tuple[str, ...] | None = None
    val = opts.pop("priority-lanes", None)
    if val is not None:
        lanes = [l.strip() for l in val.split(",")]
        if (not lanes or any(not l or not _CLIENT_RE.match(l)
                             for l in lanes)
                or len(set(lanes)) != len(lanes)):
            stderr.write(f"{_SERVE_USAGE}\nInvalid --priority-lanes "
                         f"value: {val} (comma-separated unique "
                         "names, highest first)\n")
            return EXIT_USAGE
        priority_lanes = tuple(lanes)
    stream_idle_s = 300.0
    val = opts.pop("stream-idle-s", None)
    if val is not None:
        import math
        try:
            stream_idle_s = float(val)
            if stream_idle_s <= 0 or not math.isfinite(stream_idle_s):
                raise ValueError
        except (TypeError, ValueError):
            stderr.write(f"{_SERVE_USAGE}\nInvalid --stream-idle-s "
                         f"value: {val}\n")
            return EXIT_USAGE
    canary_interval_s = None
    val = opts.pop("canary-interval", None)
    if val is not None:
        import math
        try:
            canary_interval_s = float(val)
            if canary_interval_s <= 0 \
                    or not math.isfinite(canary_interval_s):
                raise ValueError
        except (TypeError, ValueError):
            stderr.write(f"{_SERVE_USAGE}\nInvalid --canary-interval "
                         f"value: {val}\n")
            return EXIT_USAGE
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
                stderr.write(f"{_SERVE_USAGE}\nError: {e}\n")
                return EXIT_USAGE
    # the edge: TLS/mTLS on the TCP listener, scoped capability
    # tokens, per-identity rate limiting — each opt-in
    tls_cert = opts.pop("tls-cert", None)
    tls_key = opts.pop("tls-key", None)
    tls_client_ca = opts.pop("tls-client-ca", None)
    if (tls_cert is None) != (tls_key is None):
        stderr.write(f"{_SERVE_USAGE}\nError: --tls-cert and "
                     "--tls-key must be given together\n")
        return EXIT_USAGE
    if tls_client_ca is not None and tls_cert is None:
        stderr.write(f"{_SERVE_USAGE}\nError: --tls-client-ca "
                     "requires --tls-cert/--tls-key\n")
        return EXIT_USAGE
    tls = None
    if tls_cert is not None:
        from pwasm_tpu_torch.fleet.transport import ServerTLS
        try:
            tls = ServerTLS(tls_cert, tls_key,
                            client_ca=tls_client_ca)
        except ValueError as e:
            stderr.write(f"Error: {e}\n")
            return EXIT_USAGE
    auth_tokens = opts.pop("auth-tokens", None)
    if auth_tokens is not None and not auth_tokens.strip():
        stderr.write(f"{_SERVE_USAGE}\nInvalid --auth-tokens value\n")
        return EXIT_USAGE
    rate_limit = None
    val = opts.pop("rate-limit", None)
    if val is not None:
        from pwasm_tpu_torch.service.queue import parse_rate_limit
        try:
            rate_limit = parse_rate_limit(val)
        except ValueError as e:
            stderr.write(f"{_SERVE_USAGE}\nInvalid --rate-limit "
                         f"value: {val} ({e})\n")
            return EXIT_USAGE
    metrics_textfile = opts.pop("metrics-textfile", None)
    log_json = opts.pop("log-json", None)
    trace_json = opts.pop("trace-json", None)
    if trace_json is not None and not trace_json.strip():
        stderr.write(f"{_SERVE_USAGE}\nInvalid --trace-json value\n")
        return EXIT_USAGE
    result_ttl_s = None
    val = opts.pop("result-ttl-s", None)
    if val is not None:
        import math
        try:
            result_ttl_s = float(val)
            if result_ttl_s < 0 or not math.isfinite(result_ttl_s):
                raise ValueError
        except (TypeError, ValueError):
            stderr.write(f"{_SERVE_USAGE}\nInvalid --result-ttl-s "
                         f"value: {val}\n")
            return EXIT_USAGE
    max_results = None
    val = opts.pop("max-results", None)
    if val is not None:
        if val.isascii() and val.isdigit():
            max_results = int(val)
        else:
            stderr.write(f"{_SERVE_USAGE}\nInvalid --max-results "
                         f"value: {val}\n")
            return EXIT_USAGE
    if opts:
        stderr.write(f"{_SERVE_USAGE}\nInvalid argument: "
                     f"--{next(iter(opts))}\n")
        return EXIT_USAGE
    try:
        daemon = Daemon(sock, max_queue=nums["max-queue"],
                        max_concurrent=nums["max-concurrent"],
                        max_frame_bytes=nums["max-frame-bytes"],
                        stderr=stderr,
                        metrics_textfile=metrics_textfile,
                        log_json=log_json, result_ttl_s=result_ttl_s,
                        max_results=max_results,
                        lanes=nums["lanes"],
                        devices_per_job=nums["devices-per-job"],
                        journal_path=journal_path,
                        max_queue_total=nums["max-queue-total"],
                        priority_lanes=priority_lanes,
                        spool_threshold_bytes=nums[
                            "spool-threshold-bytes"],
                        spool_dir=spool_dir,
                        stream_buffer=nums["stream-buffer"],
                        stream_idle_s=stream_idle_s,
                        log_json_max_bytes=nums["log-json-max-bytes"],
                        trace_json=trace_json,
                        listen=listen, journal_dir=journal_dir,
                        warmup=warmup,
                        compile_cache_dir=compile_cache_dir,
                        canary_interval_s=canary_interval_s,
                        slo_rules=slo_rules,
                        result_cache=result_cache,
                        result_cache_max_bytes=nums[
                            "result-cache-max-bytes"],
                        cache_prefetch=cache_prefetch,
                        tls=tls, auth_tokens=auth_tokens,
                        rate_limit=rate_limit)
    except ValueError as e:
        # the --auth-tokens load is fail-fast: never come up OPEN
        # because the policy file was bad
        stderr.write(f"Error: {e}\n")
        return EXIT_USAGE
    except OSError:
        stderr.write(f"Cannot open file {log_json} for writing!\n")
        return EXIT_USAGE
    try:
        return daemon.serve()
    except PwasmError as e:
        stderr.write(str(e))
        return e.exit_code
