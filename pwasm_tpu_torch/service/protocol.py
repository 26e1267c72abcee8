"""The serve wire protocol: newline-delimited JSON over a unix socket.

Counterpart of ``pwasm_tpu/service/protocol.py``, with its frames and
its error codes, and one deliberate difference: :func:`read_frame`
bounds a frame's nesting depth (:data:`MAX_FRAME_DEPTH`) before it
parses, so a JSON bomb answers ``bad_json`` in band on every Python
(the reference relies on the parser raising ``RecursionError``, which
Python 3.12's ``json`` no longer does at the depths a frame can reach).

One request frame per line, one response frame per line — a format a
shell one-liner (``printf ... | nc -U``) can speak, trivially
greppable in a packet capture, and with no length-prefix framing to
get subtly wrong on either side.  Every frame is a single JSON object
terminated by ``\\n``; a frame longer than :data:`MAX_FRAME_BYTES` is
rejected (``frame_too_large``) and the connection closed, because once
a reader has consumed a partial oversized line the stream can no
longer be resynchronized safely.

Commands (``{"cmd": ...}``):

=============  ==========================================================
``submit``     ``{"cmd":"submit","args":[...cli argv...],
               "cwd":ABS_DIR[,"client":NAME,"priority":LANE]}`` —
               enqueue a report job; relative paths in ``args``
               resolve against the client's ``cwd`` (what a cold run
               would do), never the daemon's.  ``client`` overrides
               the fair-share identity (default: the kernel-attested
               socket-peer uid); ``priority`` names a
               ``--priority-lanes`` tier.  Admission control answers
               ``queue_full`` (the 429 of this protocol: back off and
               retry — the frame carries ``retry_after_s``,
               ``client`` and ``client_depth``) once THAT client's
               queue quota (or the global backstop) fills, and
               ``draining`` once a drain began.  Jobs must write
               their outputs to files (``-o`` required): the socket
               carries control, not bulk report bytes.
``stream``     ``{"cmd":"stream","args":[...cli argv...],
               "cwd":ABS_DIR[,"client":NAME,"priority":LANE]}`` —
               admit a STREAMING-INGESTION job (docs/STREAMING.md):
               same validation and fair-share admission as
               ``submit``, but the argv must carry NO positional PAF
               — the records arrive later as ``stream-data`` frames.
``stream-data``  ``{"cmd":"stream-data","job_id":...,"data":TEXT}`` —
               feed a chunk of PAF text to a stream job.  Chunks may
               split records anywhere (the daemon reassembles lines
               across frames).  Answers ``queue_full`` when the
               stream's buffered-record quota (``--stream-buffer``)
               or its fair share of the global ceiling is exceeded:
               back off ``retry_after_s``-seeded capped-exponential
               and RESEND THE SAME FRAME (admission is all-or-nothing
               per frame, so a rejected frame left no partial state).
``stream-end``   ``{"cmd":"stream-end","job_id":...}`` — no more
               records; the job finishes its tail (MSA/summary) and
               lands terminal.  Follow with ``result`` to wait.
``status``     ``{"cmd":"status","job_id":...}`` — non-blocking state.
``inspect``    ``{"cmd":"inspect","job_id":...}`` — the job's FLIGHT
               RECORD (docs/OBSERVABILITY.md): trace_id,
               phase-accounted walls (queue wait, lease wait, exec —
               per-flush device/host/format breakdown inside) and the
               bounded event ring.  Served from daemon RAM for live
               jobs and from the CRC-verified result spool once the
               result moved to disk.
``result``     ``{"cmd":"result","job_id":...[,"wait":bool,
               "timeout":s]}`` — the terminal verdict (rc, per-job
               RunStats, stderr tail); by default blocks until the job
               finishes.
``cancel``     queued job: removed immediately; running job: a graceful
               drain is requested — the job stops at its next batch
               boundary, leaving a valid resumable checkpoint.
``stats``      the service-level counters (versioned schema).
``cache-probe``  ``{"cmd":"cache-probe","key":SHA256}`` — would this
               daemon's result cache (``serve --result-cache``,
               docs/SERVICE.md) answer the content-addressed key?
               ``{"hit":bool,"enabled":bool}`` from a cheap manifest
               check (no blob reads, no admission).  The fleet router
               uses it for cache-affinity placement: a member that
               already answered a job gets its repeat.
``health``     the self-monitoring verdict: ok/degraded/
               failing, the firing SLO rules (docs/OBSERVABILITY.md
               rule catalog) and canary state; a fleet router folds
               every member's verdict into one fleet verdict.
               Surfaced by ``pafreport health [--exit-code]``.
``logs``       filter the server's ``--log-json`` NDJSON event log
               (rotated ``.1`` generation included) by
               ``filter_trace_id`` / ``job_id`` / ``event``, newest
               ``limit`` (default 1000, max 10000) matches returned
               oldest-first.  (The filter field is ``filter_trace_id``
               because every frame already carries the CONNECTION's
               own ``trace_id``.)
``drain``      begin the same graceful drain a SIGTERM triggers: reject
               new submissions, finish in-flight jobs at batch
               boundaries, mark queued jobs preempted-resumable, exit
               75.
``lease-grant``  ``{"cmd":"lease-grant","epoch":N,"ttl_s":S}`` — grant
               (or heartbeat) the member's epoch lease (the
               reference's docs/FLEET.md, fencing).  The fleet router normally
               piggybacks the same ``{"lease":{"epoch":N,"ttl_s":S}}``
               object on its ``stats`` polls instead of spending a
               round-trip on this verb.  A grant at an epoch LOWER
               than the member has already seen answers ``fenced`` —
               a stale router cannot re-arm a member the fleet moved
               past.  An accepted grant clears a standing self-fence.
``fence``      ``{"cmd":"fence"[,"reason":TEXT]}`` — fence the member
               NOW: in-flight jobs are preempted at their next batch
               boundary (valid resumable ckpt, rc 75, exactly like a
               drain) and new ``submit``/``stream``/``stream-data``
               frames answer the ``fenced`` error until a lease grant
               at the current-or-newer epoch un-fences it.  The same
               transition fires autonomously when a governed lease's
               TTL expires unheartbeated (self-fencing: a partitioned
               member stops writing BEFORE a sibling's ``--resume``
               starts).
``ping``       liveness + protocol version.
=============  ==========================================================

Error responses are ``{"ok": false, "error": <code>, "detail": ...}``
with codes from the ``ERR_*`` constants below.

Trace propagation: every request frame MAY carry a
``trace_id`` field (short identifier, ``[A-Za-z0-9_.:@/-]{1,64}``);
``ServiceClient`` mints one per connection and sends it on every
frame.  The ``submit``/``stream`` handlers stamp it onto the admitted
job — journal record, event-log lines, flight record, both sides'
Chrome traces — and echo it in the ok frame; a frame without one gets
a daemon-minted id, so every job is trace-correlatable either way.

Deadline propagation (docs/RESILIENCE.md): a ``submit``/
``stream`` frame MAY carry ``deadline_ms`` — the REMAINING end-to-end
budget in integer milliseconds, minted by ``ServiceClient`` from
``--deadline-s`` and re-stamped at each hop with the time already
spent subtracted (the router subtracts its queue/spill time before
forwarding, the daemon subtracts queue + lease wait before exec, the
supervisor enforces it at batch boundaries).  A frame whose budget is
already spent answers ``deadline_exceeded`` without admission; a job
whose budget expires mid-run stops at its next durable checkpoint and
lands terminal ``deadline_exceeded`` (rc 75, resumable — the journal
records the truth).  A frame WITHOUT ``deadline_ms`` behaves exactly
as before this field existed.

Transports and identity (docs/FLEET.md): the same frames
run over the unix socket and over TCP (``serve --listen=HOST:PORT``,
``route``).  A frame MAY carry a ``client_token`` field: on TCP —
where no kernel-attested ``SO_PEERCRED`` identity exists — the
daemon buckets the submit under ``tok:<token>`` for fair share, so
identities stay attested-or-explicit on both transports (an explicit
``client`` field still wins; an untokened TCP frame shares the
anonymous bucket).  On an mTLS listener (``--tls-client-ca``, a
later slice of the port) the verified client certificate's CN arrives as
the connection's ``cn:<name>`` peer identity and outranks
``client_token`` — attested cryptography beats a free-form field.

Authorization (``--auth-tokens``): when a scoped-token file
is configured, each frame's credentials (its ``client_token``, or the
connection's mTLS CN principal) must carry the scope its verb
requires; a refused frame answers the ``unauthorized`` error having
changed NO queue/journal/lease state.  Without the flag every verb
stays open — byte-identical to the pre-auth protocol.
"""

from __future__ import annotations

import json
import re

PROTOCOL_VERSION = 1

# one frame = one JSON line.  8 MiB is far above any control payload
# (a submit carries argv, not report bytes) while still bounding what a
# misbehaving client can make the daemon buffer.
MAX_FRAME_BYTES = 8 << 20

# the deepest nesting of arrays and objects a frame may carry (the
# frame's own object is depth 1).  Real frames nest 3 deep at most; a
# deeper one is a JSON bomb, answered bad_json before json.loads sees it
MAX_FRAME_DEPTH = 64

# error vocabulary (the "HTTP status codes" of the protocol)
ERR_QUEUE_FULL = "queue_full"        # admission control: back off+retry
ERR_DRAINING = "draining"            # drain in progress: no new jobs
ERR_BAD_JSON = "bad_json"            # unparseable frame (conn survives)
ERR_FRAME_TOO_LARGE = "frame_too_large"  # conn closed: stream unsynced
ERR_BAD_REQUEST = "bad_request"      # parsed, but semantically invalid
ERR_UNKNOWN_CMD = "unknown_cmd"
ERR_UNKNOWN_JOB = "unknown_job"
ERR_FENCED = "fenced"                # epoch-lease fence: member must
#   not accept work (lost/expired lease, or a stale-epoch grant was
#   refused).  Clients treat it like draining: go elsewhere.
ERR_DEADLINE_EXCEEDED = "deadline_exceeded"  # the job's end-to-end
#   deadline budget (submit/stream --deadline-s) ran out: either
#   refused at admission (budget already spent in queues upstream) or
#   landed terminal mid-run at the next batch boundary — rc 75 with a
#   valid resumable checkpoint, so the CLIENT decides whether to
#   resume with a fresh budget or abandon.
ERR_OVERLOADED = "overloaded"        # brownout shedding at the fleet
#   router: fleet-wide queue pressure crossed the SLO threshold and
#   this frame's priority lane is being shed (lowest lane first,
#   hysteresis-damped).  The frame carries retry_after_s; back off
#   like queue_full — but unlike queue_full, no member was asked.
#   Per-client rate limiting (--rate-limit) answers the
#   same code with a truthful retry_after_s: to the client the two
#   are the same instruction — slow down.
ERR_UNAUTHORIZED = "unauthorized"    # scoped capability tokens
#   (--auth-tokens): the frame's credentials do not carry
#   the scope its verb requires (admin for drain/lease-grant/fence,
#   ownership-or-admin for cancel, submit/read for the data plane).
#   The refusal happens BEFORE admission: no queue, journal or lease
#   state changed.  Not retryable with the same credentials.


class FrameError(Exception):
    """A frame-level protocol violation.  ``code`` is the ``ERR_*``
    wire code; ``fatal`` says whether the connection can keep being
    used (a malformed JSON line is recoverable — the next line is a
    fresh frame; an oversized line is not, the reader lost sync)."""

    def __init__(self, code: str, detail: str, fatal: bool = False):
        super().__init__(detail)
        self.code = code
        self.fatal = fatal


def resolve_client_identity(req: dict, peer: str | None) -> str:
    """The fair-share identity resolution order, attested-or-explicit
    on BOTH transports (one function shared by the serve daemon and
    the fleet router, so their quota/DRR bucketing can never drift):
    an explicit ``client`` field wins; else an mTLS-attested peer
    certificate CN (the connection's ``cn:<name>`` peer string —
    verified cryptography outranks any free-form frame field); else a
    ``client_token`` frame field buckets as ``tok:<token>`` (the
    plaintext-TCP identity — AF_INET has no SO_PEERCRED); else the
    kernel-attested unix peer uid; else the anonymous bucket."""
    client = req.get("client")
    if client is not None:
        return client
    if isinstance(peer, str) and peer.startswith("cn:"):
        return peer
    tok = req.get("client_token")
    if isinstance(tok, str) and tok:
        return "tok:" + tok
    return peer or ""


def parse_deadline_ms(req: dict) -> tuple[int | None, dict | None]:
    """Parse the optional ``deadline_ms`` admission-frame field, one
    implementation shared by the serve daemon and the fleet router (so
    the validation and the spent-budget refusal cannot drift): returns
    ``(budget, None)`` — budget ``None`` when the frame carries no
    deadline — or ``(None, error_frame)``.  A malformed budget is a
    ``bad_request``; a present-but-spent one (``<= 0``) answers
    ``deadline_exceeded`` WITHOUT admitting anything — the truthful
    refusal: upstream hops already ate the whole budget."""
    v = req.get("deadline_ms")
    if v is None:
        return None, None
    if isinstance(v, bool) or not isinstance(v, int):
        return None, err(ERR_BAD_REQUEST,
                         "deadline_ms must be an integer "
                         "millisecond budget")
    if v <= 0:
        return None, err(
            ERR_DEADLINE_EXCEEDED,
            f"end-to-end deadline budget already spent ({v} ms "
            "remaining at admission) — nothing was admitted; "
            "resubmit with a fresh --deadline-s",
            deadline_ms=v)
    return v, None


def handle_logs(req: dict, log_path: str | None) -> dict:
    """The ``logs`` verb body: validate the limit, filter the server's
    own ``--log-json`` via ``obs/logquery.py`` (rotated ``.1``
    generation included), answer the newest matches oldest-first."""
    if not log_path:
        return err(ERR_BAD_REQUEST,
                   "this server runs without --log-json; there is "
                   "no event log to query")
    limit = req.get("limit", 1000)
    if not isinstance(limit, int) or isinstance(limit, bool) \
            or not 1 <= limit <= 10000:
        return err(ERR_BAD_REQUEST,
                   "limit must be an integer in [1, 10000]")
    from pwasm_tpu_torch.obs.logquery import query_log
    lines = query_log(log_path,
                      trace_id=req.get("filter_trace_id"),
                      job_id=req.get("job_id"),
                      event=req.get("event"), limit=limit)
    return ok(lines=lines, path=log_path)


def ok(**fields) -> dict:
    out = {"ok": True}
    out.update(fields)
    return out


def err(code: str, detail: str = "", **fields) -> dict:
    out = {"ok": False, "error": code, "detail": detail}
    out.update(fields)
    return out


def serve_connection(conn, dispatch, peer: str | None = None,
                     max_frame_bytes: int = MAX_FRAME_BYTES) -> None:
    """The per-connection frame-serving loop shared by the serve
    daemon and the fleet router (one implementation, so a protocol-
    loop fix cannot land in only one of them): read frames until EOF,
    answer recoverable frame errors in-band, close on fatal ones, and
    turn any ``dispatch(req, peer)`` exception into a ``bad_request``
    frame — client-controlled field types must cost the CLIENT an
    error frame, never the server a dead connection thread.  Peer
    disconnects (possibly mid-result) are swallowed: their problem,
    never the server's."""
    rfile = conn.makefile("rb")
    wfile = conn.makefile("wb")
    try:
        while True:
            try:
                req = read_frame(rfile, max_frame_bytes)
            except FrameError as e:
                write_frame(wfile, err(e.code, str(e)))
                if e.fatal:
                    return
                continue
            if req is None:
                return
            try:
                resp = dispatch(req, peer=peer)
            except Exception as e:
                resp = err(ERR_BAD_REQUEST,
                           f"{type(e).__name__}: {e}")
            write_frame(wfile, resp)
    except (BrokenPipeError, ConnectionResetError, OSError,
            ValueError):
        pass
    finally:
        for f in (rfile, wfile):
            try:
                f.close()
            except OSError:
                pass
        try:
            conn.close()
        except OSError:
            pass


def write_frame(wfile, obj: dict) -> None:
    """Serialize one frame onto a buffered binary writer and flush —
    the peer blocks on the newline, so a buffered-but-unflushed frame
    is a hang, not a latency."""
    wfile.write(json.dumps(obj, separators=(",", ":")).encode("utf-8")
                + b"\n")
    wfile.flush()


def read_frame(rfile, max_bytes: int = MAX_FRAME_BYTES) -> dict | None:
    """Read and parse one frame from a buffered binary reader.

    Returns the parsed object, or ``None`` on a clean EOF (peer closed
    between frames).  Raises :class:`FrameError` for an oversized line
    (fatal — the connection must be closed), a truncated final line
    (peer died mid-frame), a line that is not JSON, or JSON that is not
    an object."""
    line = rfile.readline(max_bytes + 1)
    if not line:
        return None
    if len(line) > max_bytes:
        raise FrameError(
            ERR_FRAME_TOO_LARGE,
            f"frame exceeds {max_bytes} bytes", fatal=True)
    if not line.endswith(b"\n"):
        # EOF mid-line: the peer vanished mid-frame — nothing usable
        raise FrameError(ERR_BAD_JSON, "truncated frame at EOF",
                         fatal=True)
    if too_deep(line):
        raise FrameError(ERR_BAD_JSON,
                         f"frame nests deeper than {MAX_FRAME_DEPTH} "
                         "levels")
    try:
        obj = json.loads(line)
    except ValueError as e:
        raise FrameError(ERR_BAD_JSON, f"unparseable frame: {e}")
    if not isinstance(obj, dict):
        raise FrameError(ERR_BAD_JSON, "frame is not a JSON object")
    return obj


_JSON_STRING = re.compile(rb'"(?:[^"\\]|\\.)*"')
_NOT_BRACKETS = bytes(b for b in range(256) if b not in b"[]{}")


def too_deep(line: bytes) -> bool:
    """Whether a frame's arrays and objects nest deeper than
    :data:`MAX_FRAME_DEPTH`, brackets inside strings not counted.  A
    frame with no more opening brackets than the bound is not scanned,
    and the scan stops at the first level past it, so a bomb costs a
    few dozen steps."""
    if line.count(b"[") + line.count(b"{") <= MAX_FRAME_DEPTH:
        return False
    brackets = _JSON_STRING.sub(b"", line).translate(None, _NOT_BRACKETS)
    depth = 0
    for b in brackets:
        depth += 1 if b in b"[{" else -1
        if depth > MAX_FRAME_DEPTH:
            return True
    return False
