"""Structured NDJSON event log: run-lifecycle events as they happen.

``--log-json=FILE|-`` turns the run's lifecycle into one append-only
stream of JSON lines a fleet can tail, ship and replay: breaker
trip/half-open/reclose, OOM demotion/re-promotion, fallbacks,
checkpoint writes, drains, and (in the serve daemon) job
admit/start/finish/evict.  Every record carries both clocks —
``ts_wall`` (epoch seconds, for correlation across machines) and
``ts_mono`` (monotonic seconds, for intra-run ordering that survives
NTP steps) — plus the run/job id, so one grep over a fleet's logs
reconstructs any incident timeline.

The log is strictly additive observability: emission never raises
(a full disk or closed pipe must not kill the run it observes), lines
are flushed as written (a crashed run's log ends at its last whole
event), and nothing here ever touches the report stream — the
byte-parity contract (`-o`/`-s`/`-w` identical with logging on or
off) is part of the test suite.
"""

from __future__ import annotations

import json
import threading
import time


def new_run_id() -> str:
    """A short unique id stamped on every event of one run (and handed
    to operators in incident timelines) — uuid4-derived, no coordination
    needed between the fleet's processes."""
    import uuid
    return uuid.uuid4().hex[:12]


class EventLog:
    """One NDJSON event sink.  ``stream`` is any text file object;
    ``owns_stream`` says whether :meth:`close` closes it (False for
    ``-`` = the run's stdout).  Thread-safe: daemon workers and the
    accept loop emit concurrently, one whole line per event.

    Size-capped rotation (``--log-json-max-bytes=N``): construct with
    ``path=``/``max_bytes=`` instead of a stream and the log rotates
    once the file passes ``max_bytes`` — the current file moves to
    ``<path>.1`` (ONE rotation generation: a long-lived serve daemon
    holds at most ~2x the cap on disk, instead of growing its NDJSON
    log without bound) and a ``log_rotate`` event opens the fresh
    file, so a tailing collector sees the seam.  Rotation failures
    degrade to appending on (emit-never-raises holds throughout)."""

    def __init__(self, stream=None, run_id: str | None = None,
                 owns_stream: bool = True, path: str | None = None,
                 max_bytes: int | None = None):
        self._lock = threading.Lock()
        self.path = path
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.rotations = 0
        if stream is None and path is not None:
            stream = open(path, "a")    # may raise: caller maps it to
            #   the usual cannot-open diagnostic, like the stream form
            owns_stream = True
        self._fh = stream
        self._owns = owns_stream
        self.run_id = run_id or new_run_id()

    def _maybe_rotate(self) -> None:
        """Rotate under the held lock once the file passed the cap.
        Best-effort: any failure keeps the current handle appending."""
        if self.max_bytes is None or self.path is None \
                or self._fh is None:
            return
        try:
            if self._fh.tell() < self.max_bytes:
                return
            import os
            self._fh.close()
            os.replace(self.path, self.path + ".1")
            self._fh = open(self.path, "a")
            self.rotations += 1
            rec = {"event": "log_rotate", "run_id": self.run_id,
                   "ts_wall": round(time.time(), 6),
                   "ts_mono": round(time.perf_counter(), 6),
                   "rotations": self.rotations,
                   "previous": self.path + ".1"}
            self._fh.write(json.dumps(rec, separators=(",", ":"))
                           + "\n")
            self._fh.flush()
        except Exception:
            # a failed rotation must not kill the log (or the run):
            # reopen the path if the handle died, else keep appending
            if self._fh is None or self._fh.closed:
                try:
                    self._fh = open(self.path, "a")
                except Exception:
                    self._fh = None

    def emit(self, event: str, **fields) -> None:
        """Append one event line.  Never raises — and is safe to call
        from a signal handler's drain path: the lock acquire is
        BOUNDED, because a handler running on the very thread that
        holds the (non-reentrant) lock mid-write would otherwise
        deadlock the drain it is trying to log.  On timeout — self-
        reentrancy or a wedged sink — the line is dropped, never the
        run."""
        if self._fh is None:
            return
        rec = {"event": event, "run_id": self.run_id,
               "ts_wall": round(time.time(), 6),
               "ts_mono": round(time.perf_counter(), 6)}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        if not self._lock.acquire(timeout=0.2):
            return
        try:
            self._maybe_rotate()
            fh = self._fh
            if fh is not None:
                fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
                fh.flush()
        except Exception:
            pass
        finally:
            self._lock.release()

    def close(self) -> None:
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None and self._owns:
            try:
                fh.close()
            except Exception:
                pass
