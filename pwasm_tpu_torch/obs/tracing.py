"""Span tracing: monotonic-clock phase spans as Chrome trace events.

``--trace-json=FILE`` records lightweight spans around the run phases
(the input parse/extract loop, each device flush and its host
formatting, every supervised batch attempt, the MSA tail) and writes
one Chrome trace-event JSON file — loadable in ``chrome://tracing`` /
Perfetto, the same viewers the ``--profile`` Chrome trace
(``utils/profiling.py``) targets, so the host-side phase timeline and
the device profile line up in one toolchain.  This COMPLEMENTS
``--profile=DIR`` (``torch.profiler`` sees the kernels on the card;
these spans see the run around them) and imports no torch, so any run
can trace.  Counterpart of ``pwasm_tpu/obs/tracing.py``.

Spans use the monotonic ``time.perf_counter`` clock (µs, relative to
recorder start — wall time belongs to the event log, which stamps
both).  Each span lands as one complete ``"ph": "X"`` event at exit;
instant marks (breaker trips, drains) land as ``"ph": "i"``.  Nesting
is by construction: a span entered inside another on the same thread
exits first, so its ``[ts, ts+dur]`` interval sits inside the parent's
— the property the schema test asserts.
"""

from __future__ import annotations

import json
import os
import threading
import time


class _SpanCm:
    def __init__(self, rec: "TraceRecorder", name: str, args: dict):
        self._rec = rec
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_SpanCm":
        self._t0 = self._rec._clock()
        return self

    def __exit__(self, etype, exc, tb) -> None:
        if etype is not None:
            # a span that unwound is still a span — mark it so a trace
            # of a failed run shows WHERE it died
            self._args = dict(self._args, error=etype.__name__)
        self._rec._complete(self._name, self._t0, self._rec._clock(),
                            self._args)


class TraceRecorder:
    """Collects trace events in memory (bounded) and serializes them as
    Chrome trace-event JSON.  ``clock`` is injectable for deterministic
    tests; events past ``max_events`` are dropped and counted, never
    grown without bound — a tracer must not become the OOM it was
    meant to observe."""

    def __init__(self, clock=None, max_events: int = 200_000):
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        # the wall-clock anchor of the monotonic origin: two processes'
        # traces (client submit vs serve daemon) each stamp their own,
        # and trace_merge shifts every timeline onto one wall axis —
        # the cross-process correlation the per-process monotonic
        # clocks cannot provide alone
        self.anchor_wall_s = time.time()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._max = max_events
        self.dropped = 0
        self.on_drop = None   # hook: called (unlocked) per dropped
        #   event — the live pwasm_trace_events_dropped_total feed
        self._pid = os.getpid()

    # ---- recording -----------------------------------------------------
    def span(self, name: str, **args) -> _SpanCm:
        """Context manager recording one complete ("X") span."""
        return _SpanCm(self, name, args)

    def complete(self, name: str, t0: float, t1: float | None = None,
                 **args) -> None:
        """Record a complete span from an explicit start time ``t0``
        (same clock as this recorder — ``now()``) to ``t1``/now: the
        manual twin of :meth:`span` for phases whose extent does not
        fit a ``with`` block cleanly."""
        self._complete(name, t0, self._clock() if t1 is None else t1,
                       args)

    def now(self) -> float:
        return self._clock()

    def instant(self, name: str, **args) -> None:
        """One instant ("i") mark at the current monotonic time."""
        self._append({"name": name, "ph": "i", "s": "t",
                      "ts": self._us(self._clock()),
                      "pid": self._pid,
                      "tid": threading.get_ident(),
                      "args": args})

    def _complete(self, name: str, t0: float, t1: float,
                  args: dict) -> None:
        self._append({"name": name, "ph": "X",
                      "ts": self._us(t0),
                      "dur": max(0, self._us(t1) - self._us(t0)),
                      "pid": self._pid,
                      "tid": threading.get_ident(),
                      "args": args})

    def _us(self, t: float) -> int:
        return int(round((t - self._t0) * 1e6))

    def _append(self, ev: dict) -> None:
        # BOUNDED acquire: instants are emitted from the signal-handler
        # drain path (SignalDrain.request -> obs.event -> instant), and
        # a handler interrupting the very thread that holds this
        # non-reentrant lock mid-append would deadlock the drain it is
        # recording — on timeout the event is dropped, never the run
        if not self._lock.acquire(timeout=0.2):
            self._note_drop()
            return
        try:
            if len(self._events) >= self._max:
                self._note_drop()
                return
            self._events.append(ev)
        finally:
            self._lock.release()

    def _note_drop(self) -> None:
        self.dropped += 1
        hook = self.on_drop
        if hook is not None:
            try:
                hook()     # a metrics hook must never kill the drop
            except Exception:
                pass

    # ---- output --------------------------------------------------------
    def to_dict(self) -> dict:
        with self._lock:
            events = list(self._events)
        out = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"anchor_wall_s":
                             round(self.anchor_wall_s, 6),
                             "pid": self._pid}}
        if self.dropped:
            out["otherData"]["dropped_events"] = self.dropped
        return out

    def write(self, path: str) -> None:
        """Publish the trace atomically (``utils.fsio``): a viewer —
        or a crash mid-write — never sees half a JSON document."""
        from pwasm_tpu_torch.utils.fsio import write_durable_text
        write_durable_text(path, json.dumps(self.to_dict()))
