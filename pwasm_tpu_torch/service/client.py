"""Client side of the warm-pool service (``pafreport submit``,
``stream``, ``svc-stats``, ``metrics``, ``inspect``, ``cache-probe``,
``health`` and ``logs``) and the :class:`ServiceClient` library the
tests and ``chip_smoke.py`` drive.

Counterpart of ``pwasm_tpu/service/client.py``, with its names.  A
client is one connection speaking the newline-delimited JSON protocol
(``service.protocol``).  ``submit`` is the cold-CLI drop-in: the job
argv after ``--`` (or after the client flags) is exactly what a cold
``python -m pwasm_tpu_torch`` invocation would take, and the client's
exit code is the job's exit code — so a wrapper can switch between
cold runs and warm submissions by prefixing ``submit --socket=PATH
--`` and nothing else changes.  On a TCP target, ``--tls-ca`` (and,
for mTLS, ``--tls-cert``/``--tls-key``) speak TLS to a ``serve
--tls-cert`` daemon; ``ServiceClient.stream(..., delta=True)`` opens a
delta stream.  ``health`` prints the daemon's self-monitoring verdict
(``--exit-code``: 0 ok, 1 degraded, 2 failing), and ``logs`` queries
its event log, or a log file on disk with no daemon
(``obs/logquery.py``).  ``cache-probe`` is the port's own
verb over the reference's protocol command: the client derives the
job's cache key (``service/cache.py``) and asks whether the daemon
holds it.
"""

from __future__ import annotations

import json
import sys
import time

from pwasm_tpu_torch.core.errors import EXIT_FATAL, EXIT_USAGE
from pwasm_tpu_torch.service import protocol

_CLIENT_USAGE = """Usage:
 pafreport submit --socket=TARGET [--no-wait] [--timeout=S]
                  [--retry[=N]] [--client=NAME] [--priority=LANE]
                  [--client-token=TOK] [--deadline-s=S]
                  [--] <cli args...>

 TARGET is a unix socket path or a HOST:PORT TCP endpoint (a `serve
 --listen` daemon).  On TCP
 there is no kernel peer credential, so pass --client-token=TOK to
 claim a fair-share identity (jobs bucket under tok:TOK); untokened
 TCP submits share the anonymous bucket.  Every verb takes
 --tls-ca=PEM to speak TLS to a `serve --tls-cert` daemon (the CA that
 vouches for it), and --tls-cert=PEM --tls-key=PEM with it to present
 a client certificate (mTLS: the daemon names this peer cn:<CN>).
     submit one report job (the argv a cold CLI run would take; -o is
     required — the socket carries control, not report bytes).  By
     default waits for the job and exits with the JOB's exit code
     (0 done, 75 preempted/cancelled-resumable, else failed); with
     --no-wait prints the job id and exits 0.  A full queue
     (queue_full) exits 11 so wrappers can back off and retry — or
     pass --retry[=N] (default 5 attempts) and the client backs off
     ITSELF: capped-exponential waits seeded by the daemon's
     retry_after_s hint, exiting 11 only once the budget is spent.
     --client=NAME overrides the fair-share identity (default: the
     socket-peer uid); --priority=LANE targets a --priority-lanes
     tier on the daemon.
     --deadline-s=S arms an END-TO-END deadline: every frame carries
     the remaining budget (deadline_ms), each hop subtracts the time
     it spent (router queue/spill, daemon queue + lease wait), and a
     job that cannot finish in budget stops at its next batch
     boundary with a valid resumable checkpoint and a
     deadline_exceeded verdict (rc 75 — resume it with a fresh
     budget, or don't).  The verdict JSON shows the budget
     arithmetic.

 pafreport stream --socket=PATH [--timeout=S] [--client=NAME]
                  [--priority=LANE] [--deadline-s=S]
                  [--] <cli args...>
     open a STREAM job and feed it the PAF read
     from stdin, record-at-a-time — `minimap2 --cs ... | pafreport
     stream --socket=S -- -r cds.fa -o out.dfa` is the pipe shape.
     The job argv takes no positional PAF (records arrive over the
     socket); -o is required like submit.  Backpressure (queue_full
     mid-stream) is handled with capped-exponential backoff
     automatically; exits with the job's exit code.

 pafreport svc-stats --socket=PATH [--drain]
     print the service-level stats JSON (versioned schema); with
     --drain, ask the daemon to drain gracefully first (running jobs
     finish at batch boundaries, queued jobs report resumable, daemon
     exits 75).

 pafreport metrics --socket=PATH [--exemplars]
     print the daemon's metrics as Prometheus text exposition (queue
     depth, in-flight jobs, breaker state, job wall/queue-wait
     histograms, cumulative per-run counters) — the socket twin of
     `serve --metrics-textfile=PATH`.  With
     --exemplars, histogram buckets carry the OpenMetrics exemplar
     suffix linking each bucket to a trace_id (strict 0.0.4 parsers
     reject it, so the default stays pure).

 pafreport cache-probe --socket=PATH [--key=HEX] [--family=HEX]
                       [--] [<cli args...>]
     ask the daemon's result cache whether it holds a job: the key
     (and the delta family) are derived here from the job's argv (its
     inputs are read by digest), or given with --key/--family.  Prints
     {"key", "family", "enabled", "hit", "family_hit"} and exits 0
     when the key is held, 1 when not.

 pafreport inspect --socket=PATH JOB_ID
     print the job's FLIGHT RECORD as JSON:
     trace_id, phase-accounted walls (queue wait, lease wait, exec —
     with the run's per-flush device/host/format breakdown inside)
     and the bounded event ring (retries, breaker transitions, OOM
     bisections, ckpt writes).  Works on live, finished, and
     disk-spooled jobs (spooled records are CRC-verified).

 pafreport health --socket=TARGET [--exit-code]
     print the daemon's health verdict as JSON: ok/degraded/failing,
     the firing SLO rules (obs/catalog.py's rule catalog) and the
     canary's state.  With --exit-code the shell exit encodes the
     verdict (0 ok, 1 degraded, 2 failing) — the orchestrator-probe
     form (k8s liveness, cron pagers).

 pafreport logs (--socket=TARGET | FILE) [--trace-id=ID] [--job=ID]
                [--event=TYPE] [--limit=N]
     query the NDJSON event log — a live daemon's --log-json over the
     socket, or a log FILE on disk directly — filtered by trace_id
     (matches run_id too), job id, and/or event type, rotated .1
     generation included, newest --limit (default 1000) matches in
     order.

 Every frame this client sends carries a trace_id (minted per
 connection, or --trace-id=ID to join an existing trace): the daemon
 stamps it into its journal, event log, flight record and trace spans
 — one greppable identity for a job across both processes.
 `submit --trace-json=FILE` / `stream --trace-json=FILE` additionally
 record the CLIENT's side (submit RPC / stream feed, result wait) as
 a wall-anchored Chrome trace — written on error paths too, because a
 daemon that died mid-job is exactly the incident the trace is for;
 `pafreport trace-merge client.json daemon.json` joins the two.
"""

# distinct from every CLI exit code (1/3/5/75): "the service queue is
# full, back off and retry" — the shell-visible twin of HTTP 429
EXIT_QUEUE_FULL = 11


class ServiceError(Exception):
    """A protocol-level failure talking to the daemon."""


class ServiceClient:
    """One connection to a serve daemon — over a unix socket path or,
    since the fleet federation PR, a ``HOST:PORT`` TCP target (the
    grammar lives in ``pwasm_tpu_torch/fleet/transport.py``).
    Context-manager; every command is one request/response frame pair
    on this connection.

    ``trace_id`` (minted per connection unless passed in) rides EVERY
    frame: the daemon stamps it onto the jobs this client submits —
    into the journal (surviving kill -9 replay), the event log, the
    flight record, and both sides' Chrome traces — so one grep (or one
    ``trace-merge``) reconstructs a job's whole cross-process life.

    ``client_token`` (the ``--client-token`` flag) also rides every
    frame: on TCP — where no kernel-attested ``SO_PEERCRED`` identity
    exists — the daemon buckets this connection's jobs under
    ``tok:<token>`` for DRR fair share, so identities stay
    attested-or-explicit on both transports."""

    def __init__(self, socket_path: str, timeout: float | None = None,
                 max_frame_bytes: int = protocol.MAX_FRAME_BYTES,
                 trace_id: str | None = None,
                 client_token: str | None = None,
                 deadline_s: float | None = None,
                 tls=None):
        from pwasm_tpu_torch.fleet.transport import connect
        from pwasm_tpu_torch.obs.events import new_run_id
        self.socket_path = socket_path
        self.max_frame_bytes = max_frame_bytes
        self.trace_id = trace_id or new_run_id()
        self.client_token = client_token
        # TLS client config (transport.ClientTLS): applies to TCP
        # targets only — a unix-socket connect ignores it
        self.tls = tls
        # ---- end-to-end deadline: --deadline-s mints ONE
        # monotonic deadline for this connection's jobs; every frame
        # carries the REMAINING budget as integer deadline_ms, so each
        # hop (router, daemon, supervisor) sees what is truly left
        # after the time already spent upstream.  None = no deadline:
        # frames are byte-identical to before the field existed.
        self.deadline_s = deadline_s
        self._deadline_mono = (time.monotonic() + deadline_s
                               if deadline_s else None)
        try:
            self._sock = connect(socket_path, timeout=timeout,
                                 tls=tls)
        except (OSError, ValueError) as e:
            raise ServiceError(
                f"cannot connect to service target {socket_path}: "
                f"{e}") from e
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")

    # ---- plumbing ------------------------------------------------------
    def _req(self, obj: dict) -> dict:
        """One command frame, trace_id stamped (the propagation rule:
        EVERY frame carries it, so even a bare status poll is
        correlatable in a packet capture) — and the client token when
        this connection has one (the TCP identity)."""
        obj.setdefault("trace_id", self.trace_id)
        if self._deadline_mono is not None:
            # remaining budget re-read per frame (never cached): a
            # frame sent after a long result wait must carry the truth
            obj.setdefault("deadline_ms",
                           max(0, int(self.deadline_remaining_s()
                                      * 1000)))
        return self.request(obj)

    def deadline_remaining_s(self) -> float:
        """Seconds left in this connection's ``--deadline-s`` budget
        (may be negative once spent); ``inf`` when no deadline is
        armed — the client side of the remaining-budget arithmetic."""
        if self._deadline_mono is None:
            return float("inf")
        return self._deadline_mono - time.monotonic()

    def request(self, obj: dict) -> dict:
        # the credential is a property of the CONNECTION, not of the
        # convenience verbs: raw frames (router→member polls, test
        # probes) must authenticate the same way _req-built ones do
        if self.client_token:
            obj.setdefault("client_token", self.client_token)
        try:
            protocol.write_frame(self._wfile, obj)
            resp = protocol.read_frame(self._rfile,
                                       self.max_frame_bytes)
        except (OSError, protocol.FrameError) as e:
            raise ServiceError(f"service connection failed: {e}") \
                from e
        if resp is None:
            raise ServiceError(
                "service closed the connection mid-request")
        return resp

    def close(self) -> None:
        for f in (self._rfile, self._wfile):
            try:
                f.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- commands ------------------------------------------------------
    def ping(self) -> dict:
        return self._req({"cmd": "ping"})

    def submit(self, argv: list[str], cwd: str | None = None,
               client: str | None = None,
               priority: str | None = None) -> dict:
        """Submit one job.  ``cwd`` (default: this process's cwd) is
        sent along so relative paths in the argv resolve against the
        CLIENT's directory, not the daemon's — what a cold run would
        do.  ``client`` overrides the fair-share identity the daemon
        would otherwise derive from the socket-peer uid; ``priority``
        names a ``--priority-lanes`` tier."""
        import os
        req: dict = {"cmd": "submit", "args": list(argv),
                     "cwd": cwd if cwd is not None else os.getcwd()}
        if client is not None:
            req["client"] = client
        if priority is not None:
            req["priority"] = priority
        return self._req(req)

    def status(self, job_id: str) -> dict:
        return self._req({"cmd": "status", "job_id": job_id})

    def result(self, job_id: str, wait: bool = True,
               timeout: float | None = None) -> dict:
        req: dict = {"cmd": "result", "job_id": job_id, "wait": wait}
        if timeout is not None:
            req["timeout"] = timeout
        return self._req(req)

    def cancel(self, job_id: str) -> dict:
        return self._req({"cmd": "cancel", "job_id": job_id})

    def inspect(self, job_id: str) -> dict:
        """The job's flight record: phase
        walls + event ring, read from daemon RAM or the CRC-verified
        result spool."""
        return self._req({"cmd": "inspect", "job_id": job_id})

    # ---- streaming ingestion -----------------------
    def stream_open(self, argv: list[str], cwd: str | None = None,
                    client: str | None = None,
                    priority: str | None = None,
                    delta: bool = False) -> dict:
        """Admit a stream job: ``argv`` is a submit-shaped job argv
        WITHOUT a positional PAF (the records arrive over
        ``stream_data``).  ``delta=True`` opts the stream into the
        cache's delta classification: the daemon holds early frames
        against its result cache's per-line digest columns, and a
        stream whose records extend a cached run is served that run's
        report and re-armed as a --resume — the file-side delta
        contract, over the socket."""
        import os
        req: dict = {"cmd": "stream", "args": list(argv),
                     "cwd": cwd if cwd is not None else os.getcwd()}
        if client is not None:
            req["client"] = client
        if priority is not None:
            req["priority"] = priority
        if delta:
            req["delta"] = True
        return self._req(req)

    def stream_data(self, job_id: str, data: str,
                    digests: list[str] | None = None) -> dict:
        """Feed one chunk of PAF text (any byte split — the daemon
        reassembles records across frames).  ``digests`` (optional,
        delta streams) carries the 16-hex per-line digests of the
        lines this chunk completes — advisory: the daemon recomputes
        its own column and refuses the frame on disagreement."""
        req: dict = {"cmd": "stream-data", "job_id": job_id,
                     "data": data}
        if digests is not None:
            req["digests"] = digests
        return self._req(req)

    def stream_end(self, job_id: str) -> dict:
        return self._req({"cmd": "stream-end", "job_id": job_id})

    def stream(self, argv: list[str], chunks,
               cwd: str | None = None, client: str | None = None,
               priority: str | None = None, max_retries: int = 8,
               sleep=time.sleep,
               keepalive_s: float | None = None,
               delta: bool = False) -> dict:
        """Open a stream job, feed every chunk from ``chunks``, and
        end the stream — with the backpressure dance built in: a
        ``queue_full`` mid-stream (the stream's buffer quota or fair
        share filled faster than the job drains it) waits
        :func:`retry_backoff_s` seconds (capped-exponential, seeded by
        the daemon's ``retry_after_s`` hint — the same schedule
        ``submit --retry`` uses) and resends the SAME frame; the
        attempt counter resets on every accepted frame.  Raises
        :class:`ServiceError` once one frame stays rejected past
        ``max_retries`` consecutive attempts, or on any non-429
        rejection.  Returns the open response, augmented with
        ``records`` (total the daemon assembled) and
        ``backpressure_waits`` (how often the dance was danced) —
        call :meth:`result` with the returned ``job_id`` to wait for
        the report.

        ``keepalive_s``: while this thread is blocked pulling the
        NEXT chunk from a slow producer (a minimap2 index build can
        go silent for minutes), a helper thread on its OWN
        connection sends an empty ``stream-data`` frame every that
        many seconds — empty frames carry no records but count as
        stream activity, so the daemon's ``--stream-idle-s`` reaper
        never mistakes a slow producer for a vanished client."""
        resp = self.stream_open(argv, cwd=cwd, client=client,
                                priority=priority, delta=delta)
        if not resp.get("ok"):
            return resp
        job_id = resp["job_id"]
        masm = None
        if delta:
            # mirror the daemon's line assembly so each frame carries
            # the digests of exactly the lines it completes (the
            # daemon cross-checks; state advances once per chunk, so
            # a backpressure resend repeats identical digests)
            from pwasm_tpu_torch.service.cache import line_digest
            from pwasm_tpu_torch.stream.pafstream import LineAssembler
            masm = LineAssembler()
        stop = beat = None
        if keepalive_s:
            import threading
            stop = threading.Event()

            def _beat():
                # a SEPARATE connection: two threads interleaving
                # frames on one socket would corrupt the one-request/
                # one-response pairing
                try:
                    with ServiceClient(self.socket_path,
                                       trace_id=self.trace_id,
                                       client_token=self.client_token,
                                       tls=self.tls) \
                            as kc:
                        while not stop.wait(keepalive_s):
                            if not kc.stream_data(job_id,
                                                  "").get("ok"):
                                return
                except ServiceError:
                    pass      # best-effort: the feed itself decides

            beat = threading.Thread(target=_beat, daemon=True)
            beat.start()
        waits = 0
        try:
            for chunk in chunks:
                attempt = 0
                digs = [line_digest(ln) for ln in masm.push(chunk)] \
                    if masm is not None else None
                while True:
                    r = self.stream_data(job_id, chunk, digests=digs)
                    if r.get("ok"):
                        break
                    if r.get("error") != protocol.ERR_QUEUE_FULL:
                        raise ServiceError(
                            f"stream-data rejected: {r}")
                    if attempt >= max_retries:
                        raise ServiceError(
                            f"stream backpressure budget spent "
                            f"({max_retries} consecutive retries): "
                            f"{r}")
                    sleep(retry_backoff_s(attempt,
                                          r.get("retry_after_s")))
                    waits += 1
                    attempt += 1
        finally:
            if stop is not None:
                stop.set()
                beat.join(5)
        attempt = 0
        while True:
            # a delta-held stream resolves AT stream-end (a late queue
            # entry), so even the end frame can answer queue_full —
            # the same backoff-and-resend as a data frame
            end = self.stream_end(job_id)
            if end.get("ok"):
                break
            if end.get("error") != protocol.ERR_QUEUE_FULL \
                    or attempt >= max_retries:
                raise ServiceError(f"stream-end rejected: {end}")
            sleep(retry_backoff_s(attempt, end.get("retry_after_s")))
            waits += 1
            attempt += 1
        resp["records"] = end.get("records")
        resp["backpressure_waits"] = waits
        return resp

    def stats(self) -> dict:
        return self._req({"cmd": "stats"})

    def cache_probe(self, key: str, family: str | None = None) -> dict:
        """Would this daemon's result cache answer ``key``?  A manifest
        check: ``{"hit": bool, "enabled": bool, "family_hit": bool}``,
        ``family_hit`` whether an entry of the delta ``family`` (when
        given) is held."""
        req: dict = {"cmd": "cache-probe", "key": key}
        if family is not None:
            req["family"] = family
        return self._req(req)

    def health(self) -> dict:
        """The machine-readable health verdict: ok/degraded/failing,
        the firing SLO rules and the canary's state."""
        return self._req({"cmd": "health"})

    def logs(self, trace_id: str | None = None,
             job_id: str | None = None, event: str | None = None,
             limit: int = 1000) -> dict:
        """Query the daemon's --log-json event log (rotation-aware).
        The filter rides as ``filter_trace_id`` because every frame
        already carries this CONNECTION's trace_id."""
        req: dict = {"cmd": "logs", "limit": limit}
        if trace_id is not None:
            req["filter_trace_id"] = trace_id
        if job_id is not None:
            req["job_id"] = job_id
        if event is not None:
            req["event"] = event
        return self._req(req)

    def metrics(self, exemplars: bool = False) -> dict:
        """Prometheus text exposition; ``exemplars=True`` opts into
        the OpenMetrics exemplar suffix on histogram buckets (strict
        0.0.4 parsers reject it, so the default stays pure)."""
        req: dict = {"cmd": "metrics"}
        if exemplars:
            req["exemplars"] = True
        return self._req(req)

    def drain(self) -> dict:
        return self._req({"cmd": "drain"})


def retry_backoff_s(attempt: int, hint_s: float | None,
                    base_s: float = 0.5, cap_s: float = 30.0) -> float:
    """The ``submit --retry`` backoff schedule: wait before retry
    number ``attempt`` (0-based) after a ``queue_full``.  The daemon's
    ``retry_after_s`` hint (~one recent job wall) seeds the first
    wait; each consecutive rejection doubles it, capped at ``cap_s``
    so a long outage polls steadily instead of going silent for
    minutes.  Pure and deterministic — the unit-tested contract; the
    caller adds no jitter because the daemon's hint already differs
    per client (it tracks that daemon's own job walls)."""
    if not isinstance(hint_s, (int, float)) or not hint_s > 0:
        hint_s = base_s
    return min(float(cap_s), float(hint_s) * (2.0 ** max(0, attempt)))


def wait_for_socket(path: str, budget_s: float = 30.0) -> bool:
    """Block (bounded) until a daemon answers on ``path`` — the
    "did the serve process come up" primitive for the bench and the
    subprocess tests."""
    deadline = time.monotonic() + max(0.0, budget_s)
    while True:
        try:
            with ServiceClient(path, timeout=1.0) as c:
                if c.ping().get("ok"):
                    return True
        except ServiceError:
            pass
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.05)


def _parse_client_argv(argv: list[str],
                       cmd: str | None = None) -> tuple[dict,
                                                        list[str]]:
    """Split client flags from the job argv: client flags are read
    until the first ``--`` or the first token that is not a recognized
    client flag (so both ``submit --socket=S -- in.paf ...`` and
    ``submit --socket=S in.paf ...`` work).  The verb-specific flags
    (``--exit-code`` on health, ``--job``/``--event``/``--limit`` on
    logs, ``--exemplars`` on metrics, ``--deadline-s`` on submit and
    stream) are recognized ONLY for their verb — on any other verb
    they fall through to the job argv and fail its validation loudly
    instead of being silently swallowed."""
    opts: dict = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--":
            i += 1
            break
        if a.startswith("--socket="):
            opts["socket"] = a.split("=", 1)[1]
        elif a == "--no-wait":
            opts["no_wait"] = True
        elif a == "--drain":
            opts["drain"] = True
        elif a.startswith("--timeout="):
            opts["timeout"] = a.split("=", 1)[1]
        elif a == "--retry":
            opts["retry"] = "5"
        elif a.startswith("--retry="):
            opts["retry"] = a.split("=", 1)[1]
        elif a.startswith("--client="):
            opts["client"] = a.split("=", 1)[1]
        elif a.startswith("--client-token="):
            opts["client_token"] = a.split("=", 1)[1]
        elif a.startswith("--priority="):
            opts["priority"] = a.split("=", 1)[1]
        elif a.startswith("--deadline-s=") and cmd in ("submit",
                                                       "stream"):
            opts["deadline_s"] = a.split("=", 1)[1]
        elif a.startswith("--trace-id="):
            opts["trace_id"] = a.split("=", 1)[1]
        elif a.startswith("--trace-json="):
            opts["trace_json"] = a.split("=", 1)[1]
        elif a.startswith("--tls-ca="):
            opts["tls_ca"] = a.split("=", 1)[1]
        elif a.startswith("--tls-cert="):
            opts["tls_cert"] = a.split("=", 1)[1]
        elif a.startswith("--tls-key="):
            opts["tls_key"] = a.split("=", 1)[1]
        elif a == "--exit-code" and cmd == "health":
            opts["exit_code"] = True
        elif a == "--exemplars" and cmd == "metrics":
            opts["exemplars"] = True
        elif a.startswith("--job=") and cmd == "logs":
            opts["job"] = a.split("=", 1)[1]
        elif a.startswith("--event=") and cmd == "logs":
            opts["event"] = a.split("=", 1)[1]
        elif a.startswith("--limit=") and cmd == "logs":
            opts["limit"] = a.split("=", 1)[1]
        elif a.split("=", 1)[0] in ("--key", "--family") \
                and "=" in a and cmd == "cache-probe":
            opts[a[2:].split("=", 1)[0]] = a.split("=", 1)[1]
        else:
            break
        i += 1
    return opts, argv[i:]


def _job_verdict(resp: dict, job_id: str, stdout, stderr,
                 client=None) -> int:
    """Render a ``result`` response the way ``submit`` always has (one
    JSON verdict line, the stderr tail of a non-done job) and return
    the shell exit code — shared by the ``submit`` and ``stream``
    verbs so the two cannot drift.  When the connection carries a
    ``--deadline-s`` budget, the verdict shows the remaining-budget
    arithmetic (budget granted, seconds left at verdict time) so an
    operator can see at a glance whether a resume is worth a fresh
    budget; without a deadline the verdict is byte-identical to
    before the field existed."""
    if not resp.get("ok"):
        stderr.write(f"Error: result failed: {resp}\n")
        return EXIT_FATAL
    if resp.get("pending"):
        stderr.write(f"Error: job {job_id} still "
                     f"{resp['job']['state']} after the "
                     "--timeout\n")
        return EXIT_FATAL
    job = resp["job"]
    verdict = {"job_id": job_id, "state": job["state"],
               "rc": resp.get("rc"), "detail": job.get("detail"),
               "trace_id": job.get("trace_id")}
    if client is not None and client.deadline_s:
        verdict["deadline"] = {
            "budget_s": round(float(client.deadline_s), 3),
            "remaining_s": round(client.deadline_remaining_s(), 3)}
    json.dump(verdict, stdout)
    stdout.write("\n")
    tail = resp.get("stderr_tail") or ""
    if tail and job["state"] != "done":
        stderr.write(tail)
    rc = resp.get("rc")
    return rc if isinstance(rc, int) else EXIT_FATAL


def _logs_main(opts: dict, positional: list[str],
               sock: str | None, stdout, stderr, tls=None) -> int:
    """The ``pafreport logs`` verb: socket mode asks the daemon to
    filter its own ``--log-json``; FILE mode runs the SAME filter
    (``obs/logquery.py``) over a log on disk — the two cannot
    disagree.  Output is NDJSON, oldest-first, newest --limit kept."""
    # flags may follow the FILE positional (`logs ev.ndjson
    # --event=x` reads as naturally as the flag-first order the
    # generic client parser stops at) — sweep the remainder here
    rest: list[str] = []
    for a in positional:
        if a.startswith("--trace-id="):
            opts["trace_id"] = a.split("=", 1)[1]
        elif a.startswith("--job="):
            opts["job"] = a.split("=", 1)[1]
        elif a.startswith("--event="):
            opts["event"] = a.split("=", 1)[1]
        elif a.startswith("--limit="):
            opts["limit"] = a.split("=", 1)[1]
        else:
            rest.append(a)
    positional = rest
    limit = 1000
    if "limit" in opts:
        val = opts["limit"]
        if not (val.isascii() and val.isdigit()
                and 1 <= int(val) <= 10000):
            stderr.write(f"{_CLIENT_USAGE}\nInvalid --limit value: "
                         f"{val}\n")
            return EXIT_USAGE
        limit = int(val)
    trace_id = opts.get("trace_id")
    job_id = opts.get("job")
    event = opts.get("event")
    if sock:
        if positional:
            stderr.write(f"{_CLIENT_USAGE}\nError: logs takes "
                         "--socket OR a log FILE, not both\n")
            return EXIT_USAGE
        try:
            with ServiceClient(sock, client_token=opts.get("client_token"),
                               tls=tls) as c:
                resp = c.logs(trace_id=trace_id, job_id=job_id,
                              event=event, limit=limit)
        except ServiceError as e:
            stderr.write(f"Error: {e}\n")
            return EXIT_FATAL
        if not resp.get("ok"):
            stderr.write(f"Error: logs failed "
                         f"({resp.get('error')}): "
                         f"{resp.get('detail', '')}\n")
            return EXIT_FATAL
        lines = resp.get("lines") or []
    else:
        if len(positional) != 1:
            stderr.write(f"{_CLIENT_USAGE}\nError: logs needs "
                         "--socket=TARGET or exactly one log FILE\n")
            return EXIT_USAGE
        import os

        path = positional[0]
        if not os.path.exists(path) \
                and not os.path.exists(path + ".1"):
            stderr.write(f"Error: no event log at {path}\n")
            return EXIT_FATAL
        from pwasm_tpu_torch.obs.logquery import query_log
        lines = query_log(path, trace_id=trace_id, job_id=job_id,
                          event=event, limit=limit)
    for rec in lines:
        json.dump(rec, stdout, separators=(",", ":"))
        stdout.write("\n")
    return 0


def _cache_probe_main(sock: str, opts: dict, job_argv: list[str],
                      stdout, stderr, tls=None) -> int:
    """The ``cache-probe`` verb: the job argv's exact key and delta
    family (or ``--key``/``--family``), asked of the daemon."""
    key, family = opts.get("key"), opts.get("family")
    if job_argv:
        import os

        from pwasm_tpu_torch.service.cache import (classify_argv,
                                                   derive_keys)
        from pwasm_tpu_torch.service.daemon import _absolutize_argv
        cls = classify_argv(_absolutize_argv(job_argv, os.getcwd()))
        derived = derive_keys(cls) if cls is not None else None
        if derived is None:
            stderr.write("Error: cache-probe: the job bypasses the "
                         "result cache or its inputs are unreadable\n")
            return EXIT_USAGE
        key, family = derived
    if not key:
        stderr.write(f"{_CLIENT_USAGE}\nError: cache-probe needs the "
                     "job's CLI arguments or --key=HEX\n")
        return EXIT_USAGE
    with ServiceClient(sock, trace_id=opts.get("trace_id"),
                       client_token=opts.get("client_token"),
                       tls=tls) as c:
        resp = c.cache_probe(key, family)
    if not resp.get("ok"):
        stderr.write(f"Error: cache-probe failed "
                     f"({resp.get('error')}): {resp.get('detail', '')}\n")
        return EXIT_FATAL
    json.dump({"key": key, "family": family,
               "enabled": resp.get("enabled"), "hit": resp.get("hit"),
               "family_hit": resp.get("family_hit")}, stdout)
    stdout.write("\n")
    return 0 if resp.get("hit") else 1


def client_main(cmd: str, argv: list[str], stdout=None,
                stderr=None) -> int:
    """The ``pafreport submit`` / ``stream`` / ``svc-stats`` /
    ``metrics`` / ``inspect`` / ``cache-probe`` / ``health`` / ``logs``
    entry point."""
    stdout = stdout if stdout is not None else sys.stdout
    stderr = stderr if stderr is not None else sys.stderr
    opts, job_argv = _parse_client_argv(argv, cmd)
    sock = opts.get("socket")
    # TLS client config: --tls-ca verifies the server, --tls-cert and
    # --tls-key present a client certificate (mTLS).  It applies to
    # TCP targets; a unix-socket connect ignores it
    tls = None
    if "tls_ca" in opts:
        from pwasm_tpu_torch.fleet.transport import ClientTLS
        try:
            tls = ClientTLS(opts["tls_ca"],
                            certfile=opts.get("tls_cert"),
                            keyfile=opts.get("tls_key"))
        except ValueError as e:
            stderr.write(f"Error: {e}\n")
            return EXIT_USAGE
    elif "tls_cert" in opts or "tls_key" in opts:
        stderr.write(f"{_CLIENT_USAGE}\nError: --tls-cert/--tls-key "
                     "need --tls-ca=PEM (the CA that vouches for "
                     "the server)\n")
        return EXIT_USAGE
    if cmd == "logs":
        # the one socket-optional verb: `logs FILE` queries a log on
        # disk directly (the same filter the daemon runs)
        return _logs_main(opts, job_argv, sock, stdout, stderr,
                          tls=tls)
    if not sock:
        stderr.write(f"{_CLIENT_USAGE}\nError: --socket=PATH is "
                     "required\n")
        return EXIT_USAGE
    timeout: float | None = None
    if "timeout" in opts:
        try:
            timeout = float(opts["timeout"])
            if timeout <= 0:
                raise ValueError
        except (TypeError, ValueError):
            stderr.write(f"{_CLIENT_USAGE}\nInvalid --timeout value: "
                         f"{opts['timeout']}\n")
            return EXIT_USAGE
    deadline_s: float | None = None
    if "deadline_s" in opts:
        import math
        try:
            deadline_s = float(opts["deadline_s"])
            if deadline_s <= 0 or not math.isfinite(deadline_s):
                raise ValueError
        except (TypeError, ValueError):
            stderr.write(f"{_CLIENT_USAGE}\nInvalid --deadline-s "
                         f"value: {opts['deadline_s']} (need a "
                         "positive finite number of seconds)\n")
            return EXIT_USAGE
    # --trace-json: record THIS process's side of the job (the RPC
    # spans) as a wall-anchored Chrome trace — the `trace-merge`
    # counterpart of the daemon's serve --trace-json.  Built up here
    # so both the submit and stream verbs share it.
    tracer = None
    if "trace_json" in opts:
        from pwasm_tpu_torch.obs import TraceRecorder
        tracer = TraceRecorder()

    def _span(name: str, t0, c) -> None:
        if tracer is not None:
            tracer.complete(name, t0, trace_id=c.trace_id)

    def _write_trace() -> None:
        if tracer is not None:
            try:
                tracer.write(opts["trace_json"])
                stderr.write(f"pwasm: client trace written to "
                             f"{opts['trace_json']}\n")
            except OSError as e:
                stderr.write(f"Warning: cannot write "
                             f"--trace-json {opts['trace_json']}:"
                             f" {e}\n")

    try:
        if cmd == "metrics":
            with ServiceClient(
                    sock, trace_id=opts.get("trace_id"),
                    client_token=opts.get("client_token"),
                    tls=tls) as c:
                resp = c.metrics(
                    exemplars=bool(opts.get("exemplars")))
            if not resp.get("ok"):
                stderr.write(f"Error: metrics failed: {resp}\n")
                return EXIT_FATAL
            stdout.write(resp.get("metrics", ""))
            return 0
        if cmd == "health":
            with ServiceClient(
                    sock, trace_id=opts.get("trace_id"),
                    client_token=opts.get("client_token"),
                    tls=tls) as c:
                resp = c.health()
            if not resp.get("ok"):
                stderr.write(f"Error: health failed "
                             f"({resp.get('error')}): "
                             f"{resp.get('detail', '')}\n")
                return EXIT_FATAL
            health = resp.get("health") or {}
            json.dump(health, stdout, indent=2)
            stdout.write("\n")
            if opts.get("exit_code"):
                # the orchestrator-probe form: 0 ok / 1 degraded /
                # 2 failing (unknown ranks degraded — a probe must
                # never read a parse problem as health)
                from pwasm_tpu_torch.obs.slo import verdict_exit_code
                return verdict_exit_code(health.get("verdict"))
            return 0
        if cmd == "inspect":
            if len(job_argv) != 1:
                stderr.write(f"{_CLIENT_USAGE}\nError: inspect needs "
                             "exactly one JOB_ID\n")
                return EXIT_USAGE
            with ServiceClient(
                    sock, trace_id=opts.get("trace_id"),
                    client_token=opts.get("client_token"),
                    tls=tls) as c:
                resp = c.inspect(job_argv[0])
            if not resp.get("ok"):
                stderr.write(f"Error: inspect failed "
                             f"({resp.get('error')}): "
                             f"{resp.get('detail', '')}\n")
                return EXIT_FATAL
            json.dump({"job": resp.get("job"),
                       "trace_id": resp.get("trace_id"),
                       "flight": resp.get("flight"),
                       **({"spool_error": resp["spool_error"]}
                          if "spool_error" in resp else {})},
                      stdout, indent=2)
            stdout.write("\n")
            return 0
        if cmd == "cache-probe":
            return _cache_probe_main(sock, opts, job_argv, stdout,
                                     stderr, tls=tls)
        if cmd == "svc-stats":
            with ServiceClient(
                    sock, trace_id=opts.get("trace_id"),
                    client_token=opts.get("client_token"),
                    tls=tls) as c:
                if opts.get("drain"):
                    resp = c.drain()
                    if not resp.get("ok"):
                        stderr.write(f"Error: drain rejected: "
                                     f"{resp}\n")
                        return EXIT_FATAL
                resp = c.stats()
            if not resp.get("ok"):
                stderr.write(f"Error: stats failed: {resp}\n")
                return EXIT_FATAL
            json.dump(resp["stats"], stdout)
            stdout.write("\n")
            return 0
        if cmd == "stream":
            # the minimap2-pipe verb: stdin is the record source, fed
            # record-at-a-time with automatic backpressure handling
            if not job_argv:
                stderr.write(f"{_CLIENT_USAGE}\nError: stream needs "
                             "the job's CLI arguments\n")
                return EXIT_USAGE
            # available-bytes chunking (read1): frames carry whatever
            # the pipe has — low latency on a trickling producer, yet
            # one frame per ~64 KiB on a firehose instead of one RPC
            # per record (the daemon reassembles records across
            # frames either way).  Streams without a .buffer (tests
            # hand a StringIO) fall back to per-line frames.
            buf = getattr(sys.stdin, "buffer", None)
            if buf is not None:
                src = (b.decode("utf-8", "replace") for b in
                       iter(lambda: buf.read1(1 << 16), b""))
            else:
                src = iter(sys.stdin.readline, "")
            with ServiceClient(
                    sock, trace_id=opts.get("trace_id"),
                    client_token=opts.get("client_token"),
                    deadline_s=deadline_s, tls=tls) as c:
                t0 = tracer.now() if tracer is not None else 0.0
                resp = c.stream(job_argv, src,
                                client=opts.get("client"),
                                priority=opts.get("priority"),
                                keepalive_s=30.0)
                _span("stream_feed", t0, c)
                if not resp.get("ok"):
                    code = resp.get("error")
                    stderr.write(f"Error: stream rejected ({code}): "
                                 f"{resp.get('detail', '')}\n")
                    _write_trace()
                    return EXIT_QUEUE_FULL \
                        if code == protocol.ERR_QUEUE_FULL \
                        else EXIT_FATAL
                job_id = resp["job_id"]
                t0 = tracer.now() if tracer is not None else 0.0
                resp = c.result(job_id, wait=True, timeout=timeout)
                _span("result_wait", t0, c)
            _write_trace()
            return _job_verdict(resp, job_id, stdout, stderr,
                                client=c)
        # submit
        if not job_argv:
            stderr.write(f"{_CLIENT_USAGE}\nError: submit needs the "
                         "job's CLI arguments\n")
            return EXIT_USAGE
        retries = 0
        if "retry" in opts:
            val = opts["retry"]
            if not (val.isascii() and val.isdigit() and int(val) >= 1):
                stderr.write(f"{_CLIENT_USAGE}\nInvalid --retry "
                             f"value: {val}\n")
                return EXIT_USAGE
            retries = int(val)
        with ServiceClient(
                sock, trace_id=opts.get("trace_id"),
                client_token=opts.get("client_token"),
                deadline_s=deadline_s, tls=tls) as c:
            for attempt in range(retries + 1):
                t0 = tracer.now() if tracer is not None else 0.0
                resp = c.submit(job_argv, client=opts.get("client"),
                                priority=opts.get("priority"))
                _span("submit_rpc", t0, c)
                if resp.get("ok") \
                        or resp.get("error") != protocol.ERR_QUEUE_FULL \
                        or attempt >= retries:
                    break
                # the 429 dance: honor the daemon's hint, doubling per
                # consecutive rejection (capped — see retry_backoff_s)
                wait = retry_backoff_s(attempt,
                                       resp.get("retry_after_s"))
                stderr.write(f"pwasm: queue full "
                             f"({resp.get('detail', '')}); retry "
                             f"{attempt + 1}/{retries} in "
                             f"{wait:.2f}s\n")
                time.sleep(wait)
            if not resp.get("ok"):
                code = resp.get("error")
                stderr.write(f"Error: submission rejected "
                             f"({code}): {resp.get('detail', '')}\n")
                _write_trace()
                if code == protocol.ERR_QUEUE_FULL:
                    hint = resp.get("retry_after_s")
                    if hint is not None:
                        stderr.write(f"(retry after ~{hint}s)\n")
                    return EXIT_QUEUE_FULL
                return EXIT_FATAL
            job_id = resp["job_id"]
            if opts.get("no_wait"):
                json.dump({"job_id": job_id, "state": "queued",
                           "trace_id": resp.get("trace_id")},
                          stdout)
                stdout.write("\n")
                _write_trace()
                return 0
            t0 = tracer.now() if tracer is not None else 0.0
            resp = c.result(job_id, wait=True, timeout=timeout)
            _span("result_wait", t0, c)
        _write_trace()
        return _job_verdict(resp, job_id, stdout, stderr, client=c)
    except ServiceError as e:
        stderr.write(f"Error: {e}\n")
        # the client-side trace is most valuable exactly when the
        # daemon died mid-job: flush whatever spans landed
        _write_trace()
        return EXIT_FATAL
