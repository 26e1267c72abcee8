"""Durable job journal for the serve daemon (crash-safe serving).

Counterpart of ``pwasm_tpu/service/journal.py``, with its names and its
line format, so either package's daemon replays the other's journal.
Everything the daemon used to know only in RAM — which jobs were
admitted, which were granted a lane and started, which finished and
how — dies with a ``kill -9``.  The journal is the daemon's write-ahead
record of exactly that state: one fsync'd NDJSON line per transition
(``admit`` / ``start`` / ``finish`` / ``cancel`` / ``evict``), appended
through :class:`pwasm_tpu_torch.utils.fsio.DurableAppender` (the
fsync-per-record primitive), so a daemon restarted on the same socket
can :func:`replay` the file and

- **re-queue** jobs that were admitted but never started (their
  admission was acked to the client, so losing them silently would be
  a broken promise);
- **re-admit** jobs that were running as ``--resume`` continuations of
  their own report checkpoints — the ckpt-v2 resume contract makes the
  recovered report byte-identical to a never-crashed run;
- **restore** terminal jobs as result-index entries (rc/state/detail
  from the ``finish`` record, large results from their spool files) so
  a client polling ``result`` across the crash still gets its verdict.

Crash-safety of the journal itself: records are complete lines or they
don't count.  :func:`replay` parses every whole line and tolerates a
torn final line (the kill landed mid-append) — the corresponding
transition simply never happened, which is exactly the write-ahead
contract.  After replay the daemon :meth:`compact`\\ s the file
(atomic ``fsio.write_durable_text`` rewrite holding only the records
that still matter) so restart cost is bounded by live state, not
daemon-lifetime history.
"""

from __future__ import annotations

import json
import threading

from pwasm_tpu_torch.utils.fsio import DurableAppender, write_durable_text

JOURNAL_VERSION = 1

# the record vocabulary (the "rec" field of every line)
REC_ADMIT = "admit"      # job acked to the client (argv, client, ...)
REC_START = "start"      # job granted a lane and handed to cli.run
REC_FINISH = "finish"    # terminal verdict (state/rc/detail[/spool])
REC_CANCEL = "cancel"    # client requested cancel (queued or running)
REC_EVICT = "evict"      # terminal result dropped (TTL/LRU)
REC_REPLAY = "replay"    # a restart replayed the journal (marker)
REC_CACHE_HIT = "cache_hit"   # job answered from the result cache at
#   admission — it never entered the queue or touched a device, and
#   the record keeps replay accounting truthful: a restarted daemon
#   (or a failover router reading this journal) sees WHY the job has
#   a finish record but no start record


# ── router write-ahead vocabulary (fleet/router.py) ──
# The fleet router journals its routed-job table through this same
# JobJournal (same appender, same torn-tail contract, same compaction)
# with its own record kinds, so a kill -9'd router — or the warm
# standby tailing the file — can rebuild every routed admission and
# in-flight placement.  fold_route_records lives in fleet/router.py
# (the fold is routing semantics; this module only owns the durable
# line format).
REC_ROUTE_ADMIT = "route_admit"    # routed job acked (frame, client,
#                                    trace_id, stream flag)
REC_ROUTE_PLACE = "route_place"    # placement or failover RE-placement
#                                    (member, member job id, gen, epoch)
REC_ROUTE_RETIRE = "route_retire"  # routed job retired from the ledger
#                                    (optionally with a router-cached
#                                    terminal verdict: state/rc/detail)
REC_EPOCH = "epoch"                # fleet epoch bump (fencing): every
#                                    failover event and every router
#                                    restart/takeover writes one
REC_MEMBERS = "members"            # member-set snapshot — the standby
#                                    inherits its backends from the
#                                    LAST of these, never from flags
REC_SCALE = "scale"                # scaler action (spawn/retire) with
#                                    the member target + child pid, so
#                                    a restarted router knows which
#                                    members it owns
REC_ROUTE_SHED = "route_shed"      # brownout shed-level transition
#                                    (level + lane set), so
#                                    the journal records WHEN the
#                                    router started/stopped turning
#                                    low-priority admissions away
#                                    (fold_route_records skips it —
#                                    shed state is not rebuilt, only
#                                    auditable)


class JobJournal:
    """Append-side of the journal.  Thread-safe: worker threads and
    connection threads append concurrently.  A failed append degrades
    loudly (the ``broken`` latch — the daemon warns once and keeps
    serving without crash-safety) rather than taking the service down:
    a full disk must cost the recovery guarantee, not the fleet."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._appender: DurableAppender | None = None
        self.broken: str | None = None   # first append failure detail
        self.records_written = 0

    def open(self) -> None:
        with self._lock:
            if self._appender is None:
                self._appender = DurableAppender(self.path)

    def append(self, rec: str, **fields) -> bool:
        """Durably append one record; returns False (and latches
        ``broken``) on the first OSError instead of raising."""
        return self.append_many([(rec, fields)])

    def append_many(self, rows: list) -> bool:
        """Durably append several records in ONE write+fsync.  Same
        torn-tail contract as single appends (whole newline-terminated
        lines count, a torn suffix never happened) at one fsync's cost
        (the reference's result cache journals its admit/cache_hit/
        finish triple through it).  ``rows`` is ``[(rec, fields), ...]``."""
        chunks = []
        for rec, fields in rows:
            obj = {"v": JOURNAL_VERSION, "rec": rec}
            obj.update(fields)
            chunks.append(json.dumps(
                obj, separators=(",", ":")).encode("utf-8") + b"\n")
        data = b"".join(chunks)
        with self._lock:
            if self._appender is None or self.broken is not None:
                return False
            try:
                self._appender.append(data)
            except OSError as e:
                self.broken = str(e)
                return False
            self.records_written += len(rows)
            return True

    def replay(self) -> list[dict]:
        """Parse every COMPLETE record currently in the journal file.
        A final line without its newline — or any unparseable line —
        is skipped: a record torn by the crash never durably happened.
        Returns [] when the file doesn't exist."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return []
        out: list[dict] = []
        for line in raw.split(b"\n")[:-1]:   # drop the torn tail (the
            # slice keeps only newline-TERMINATED records; a whole
            # final line ends in \n so the last split element is b"")
            if not line.strip():
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and isinstance(obj.get("rec"),
                                                    str):
                out.append(obj)
        return out

    def compact(self, records: list[dict]) -> None:
        """Atomically rewrite the journal to exactly ``records`` (the
        post-replay live state) via the audited fsync-then-replace,
        then reopen the appender on the new file.  Crash-safe at any
        instant: the old journal or the new one, never a mix."""
        text = "".join(json.dumps(r, separators=(",", ":")) + "\n"
                       for r in records)
        with self._lock:
            if self._appender is not None:
                self._appender.close()
                self._appender = None
            write_durable_text(self.path, text)
            self._appender = DurableAppender(self.path)
            self.records_written = len(records)

    def close(self) -> None:
        with self._lock:
            if self._appender is not None:
                self._appender.close()
                self._appender = None

    def unlink(self) -> None:
        """Remove the journal (clean-drain exit: every admitted job
        reached a terminal state the clients were told about, so there
        is nothing left to recover)."""
        import os
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


def fold_records(records: list[dict]) -> dict[str, dict]:
    """Fold a replayed record stream into one state row per job id,
    preserving admit order (the ``_ord`` key): ``{"admit": rec,
    "start": rec|None, "finish": rec|None, "cancel": rec|None,
    "evicted": bool}``.  Records for ids with no admit are dropped
    (their admit line was torn, so the admission never durably
    happened and the client was — at worst — never acked)."""
    out: dict[str, dict] = {}
    for rec in records:
        jid = rec.get("job_id")
        kind = rec.get("rec")
        if kind == REC_REPLAY or not isinstance(jid, str):
            continue
        if kind == REC_ADMIT:
            out.setdefault(jid, {"admit": rec, "start": None,
                                 "finish": None, "cancel": None,
                                 "evicted": False, "cache_hit": False,
                                 "_ord": len(out)})
            continue
        row = out.get(jid)
        if row is None:
            continue
        if kind == REC_START:
            row["start"] = rec
        elif kind == REC_FINISH:
            row["finish"] = rec
        elif kind == REC_CANCEL:
            row["cancel"] = rec
        elif kind == REC_EVICT:
            row["evicted"] = True
        elif kind == REC_CACHE_HIT:
            row["cache_hit"] = True
    return out
