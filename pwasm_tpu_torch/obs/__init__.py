"""Run observability: metrics, spans, event log.

Counterpart of ``pwasm_tpu/obs/__init__.py``.  One torch-free
subsystem behind three CLI flags and one subcommand:

- ``--metrics-textfile=PATH``  a :class:`~pwasm_tpu_torch.obs.metrics.
  MetricsRegistry` rendered in Prometheus text exposition, published
  atomically for a node-exporter textfile collector;
- ``--trace-json=FILE``  monotonic-clock phase/batch spans as Chrome
  trace-event JSON (:mod:`pwasm_tpu_torch.obs.tracing`), complementing
  the ``torch.profiler`` trace of ``--profile=DIR``;
- ``--log-json=FILE|-``  the structured NDJSON run-lifecycle event log
  (:mod:`pwasm_tpu_torch.obs.events`);
- ``trace-merge``  several ``--trace-json`` documents, and
  ``--profile`` traces, on one wall axis (:mod:`pwasm_tpu_torch.obs.merge`);
- the serve daemon's per-job flight record, read by the ``inspect``
  verb (:mod:`pwasm_tpu_torch.obs.flight`);
- the run's stage table (:class:`StageTable`), the ``stages`` block
  of ``--stats``.

The :class:`Observability` facade is what gets threaded through the
run (cli -> the batch supervisor, ``resilience/supervisor.py``).  Its
:meth:`~Observability.span` is the one timer of a run's stages: each
span is timed once and feeds every sink that exists, and under a
``torch.profiler`` session it is also a ``record_function`` range.  A
null instance (no sinks) still times its spans, for the caller that
reads ``dur_s``.  The byte-parity contract — report bytes identical
with observability on and off — holds by construction (observability
writes only to its own sinks, never the report stream).  Metric NAMES
live in :mod:`pwasm_tpu_torch.obs.catalog`, the single registration
namespace.

A run served by the daemon fills the facade's ``flight`` slot with its
job's :class:`~pwasm_tpu_torch.obs.flight.FlightRecorder`; a cold run
leaves it ``None``.
"""

from __future__ import annotations

import sys as _sys
import threading
import time as _time

from pwasm_tpu_torch.obs.events import EventLog, new_run_id  # noqa: F401
from pwasm_tpu_torch.obs.flight import FlightRecorder  # noqa: F401
from pwasm_tpu_torch.obs.metrics import MetricsRegistry  # noqa: F401
from pwasm_tpu_torch.obs.tracing import TraceRecorder  # noqa: F401


def _profiler_module():
    """``torch.autograd.profiler`` while a ``torch.profiler`` session is
    on anywhere in the process, else None.  The flag read is the
    process-wide ``_is_profiler_enabled``: the thread-local
    ``torch._C._autograd._profiler_enabled()`` reads False on every
    thread of a session that profiles all threads.  torch is never
    imported here: a process that has not imported it profiles
    nothing."""
    prof = _sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None


class StageTable:
    """The run's seconds by stage: for each span name the total seconds
    ``s``, the self seconds ``self_s`` (``s`` less the time of its child
    spans on the same thread), the count ``n``, the summed ``items`` of
    the span's ``items=``/``n=`` argument, and the counters tallied into
    its row (``tally``).  Fed by every :class:`_ObsSpan` that exits;
    read by ``--stats`` (its ``stages`` block) and by the views derived
    from it (``host.*_s``, ``device.compile_s``/``steady_s``, ``cli.run``'s
    ``stats["times"]``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: dict[str, dict] = {}

    def _row(self, name: str) -> dict:
        row = self._rows.get(name)
        if row is None:
            row = self._rows[name] = {"s": 0.0, "self_s": 0.0, "n": 0,
                                      "items": 0}
        return row

    def add(self, name: str, s: float, self_s: float,
            items: int = 0) -> None:
        with self._lock:
            row = self._row(name)
            row["s"] += s
            row["self_s"] += self_s
            row["n"] += 1
            row["items"] += items

    def tally(self, name: str, **counters: int) -> None:
        """Add ``counters`` to ``name``'s row (made if absent)."""
        with self._lock:
            row = self._row(name)
            for k, v in counters.items():
                row[k] = row.get(k, 0) + int(v)

    def seconds(self, name: str) -> float:
        with self._lock:
            row = self._rows.get(name)
            return row["s"] if row is not None else 0.0

    def as_dict(self, open_spans=(), now: float = 0.0) -> dict:
        """``{name: {s, self_s, n, items, ...}}``, seconds rounded to
        the microsecond.  ``open_spans`` (outermost first) are spans
        still open at ``now``: each counts once with its time so far,
        which is how ``run`` reaches the ``--stats`` file written
        inside it."""
        with self._lock:
            rows = {k: dict(v) for k, v in self._rows.items()}
        for i, sp in enumerate(open_spans):
            s = max(0.0, now - sp._t0)
            inner = open_spans[i + 1]._t0 if i + 1 < len(open_spans) \
                else now
            row = rows.setdefault(sp._name, {"s": 0.0, "self_s": 0.0,
                                             "n": 0, "items": 0})
            row["s"] += s
            row["self_s"] += max(0.0, s - sp._child_s - (now - inner))
            row["n"] += 1
            row["items"] += sp._items()
        for row in rows.values():
            row["s"] = round(row["s"], 6)
            row["self_s"] = round(row["self_s"], 6)
        return dict(sorted(rows.items()))


class _ObsSpan:
    """One timed span feeding every sink that exists: the trace
    recorder, the per-job flight recorder and the run's stage table;
    under a ``torch.profiler`` session it is also a
    ``record_function`` range of the same name, so the device trace
    carries it among the kernels.  Its one clock is the tracer's (else
    ``perf_counter``); ``dur_s`` holds the wall once it exits, and
    ``args`` may be extended inside the block."""

    __slots__ = ("_obs", "_name", "args", "_t0", "_child_s", "_rf",
                 "dur_s")

    def __init__(self, obs: "Observability", name: str, args: dict):
        self._obs = obs
        self._name = name
        self.args = args
        self._t0 = 0.0
        self._child_s = 0.0
        self._rf = None
        self.dur_s = 0.0

    def _items(self) -> int:
        v = self.args.get("items", self.args.get("n"))
        return v if isinstance(v, int) else 0

    def __enter__(self) -> "_ObsSpan":
        self._obs._stack().append(self)
        self._t0 = self._obs._clock()
        prof = _profiler_module()
        if prof is not None:
            self._rf = prof.record_function(self._name)
            self._rf.__enter__()
        return self

    def __exit__(self, etype, exc, tb) -> None:
        obs = self._obs
        t1 = obs._clock()
        if self._rf is not None:
            self._rf.__exit__(etype, exc, tb)
            self._rf = None
        dur = max(0.0, t1 - self._t0)
        self.dur_s = dur
        stack = obs._stack()
        if self in stack:
            stack.remove(self)
        if stack:
            stack[-1]._child_s += dur
        if obs.tracer is not None:
            # a span that unwound is still a span — marked so a trace
            # of a failed run shows WHERE it died
            args = self.args if etype is None \
                else dict(self.args, error=etype.__name__)
            obs.tracer.complete(self._name, self._t0, t1, **args)
        if obs.flight is not None:
            obs.flight.note(self._name, dur)
        if obs.stages is not None:
            obs.stages.add(self._name, dur, max(0.0, dur - self._child_s),
                           self._items())


class Observability:
    """The per-run observability bundle.  Any of the sinks may be
    absent; every hook degrades to a no-op so call sites never branch.

    ``registry``/``run_metrics`` — the metrics registry and the built
    run-metric families (``obs/catalog.py``); ``tracer`` — the span
    recorder; ``events`` — the NDJSON event log; ``flight`` — the
    per-job :class:`~pwasm_tpu_torch.obs.flight.FlightRecorder` a serve
    daemon hands a served job (spans accumulate phase walls there,
    events land in its ring); ``stages`` — the run's
    :class:`StageTable`.  ``trace_path`` / ``metrics_path`` are
    written by :meth:`close`.
    """

    def __init__(self, registry=None, run_metrics=None, tracer=None,
                 events=None, trace_path=None, metrics_path=None,
                 run_id=None, flight=None, stages=None):
        self.registry = registry
        self.run_metrics = run_metrics
        self.tracer = tracer
        self.events = events
        self.flight = flight
        self.stages = stages
        self.trace_path = trace_path
        self.metrics_path = metrics_path
        self.run_id = run_id or (events.run_id if events is not None
                                 else new_run_id())
        # the one span clock: the tracer's, so a span's trace event and
        # its stage seconds are the same reading
        self._clock = tracer.now if tracer is not None \
            else _time.perf_counter
        self._local = threading.local()   # each thread's open spans

    @property
    def enabled(self) -> bool:
        return (self.registry is not None or self.tracer is not None
                or self.events is not None or self.flight is not None)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ---- hooks (all no-ops when the sink is absent) --------------------
    def span(self, name: str, **args) -> _ObsSpan:
        """One timed span (a ``with`` block) under the thread's
        innermost open span; ``items=``/``n=`` count its work items."""
        return _ObsSpan(self, name, args)

    def tally(self, **counters: int) -> None:
        """Counters into the stage-table row of the calling thread's
        innermost open span (dropped outside any span)."""
        stack = self._stack()
        if self.stages is not None and stack:
            self.stages.tally(stack[-1]._name, **counters)

    def stage_seconds(self, name: str) -> float:
        return self.stages.seconds(name) if self.stages is not None \
            else 0.0

    def stages_dict(self) -> dict:
        """The stage table, the calling thread's open spans counted with
        their time so far (``{}`` without a table)."""
        if self.stages is None:
            return {}
        return self.stages.as_dict(list(self._stack()), self._clock())

    def event(self, event: str, **fields) -> None:
        """One lifecycle event: an NDJSON line, (when tracing) an
        instant mark on the trace timeline, and (for a served job) a
        ring entry on the flight record — the three views line up."""
        if self.events is not None:
            self.events.emit(event, **fields)
        if self.tracer is not None:
            self.tracer.instant(event, **fields)
        if self.flight is not None:
            self.flight.mark(event, **fields)

    def observe(self, key: str, value: float, **labels) -> None:
        if self.run_metrics is not None and key in self.run_metrics:
            self.run_metrics[key].observe(value, **labels)

    def set_gauge(self, key: str, value: float, **labels) -> None:
        if self.run_metrics is not None and key in self.run_metrics:
            self.run_metrics[key].set(value, **labels)

    def count(self, key: str, n: float, **labels) -> None:
        """Increment a run-metric counter (the per-flush host-stage
        fold uses this so the live Prometheus surface attributes
        time WHILE the run is alive, not only at end of run)."""
        if n > 0 and self.run_metrics is not None \
                and key in self.run_metrics:
            self.run_metrics[key].inc(n, **labels)

    # ---- end of run ----------------------------------------------------
    def close(self, stderr=None) -> None:
        """Flush the file-backed sinks (atomic writes) and close the
        event log.  Best-effort by contract: a failed trace write costs
        a warning, never the run's exit code."""
        import sys
        stderr = stderr if stderr is not None else sys.stderr
        if self.tracer is not None and self.trace_path:
            try:
                self.tracer.write(self.trace_path)
                print(f"pwasm: trace written to {self.trace_path}",
                      file=stderr)
            except OSError as e:
                print(f"Warning: cannot write --trace-json "
                      f"{self.trace_path}: {e}", file=stderr)
        if self.registry is not None and self.metrics_path:
            try:
                self.registry.write_textfile(self.metrics_path)
            except OSError as e:
                print(f"Warning: cannot write --metrics-textfile "
                      f"{self.metrics_path}: {e}", file=stderr)
        if self.events is not None:
            self.events.close()


class _NullObservability(Observability):
    """The shared do-nothing instance (default for every ``obs=``
    parameter): hooks resolve to the base no-ops, and it is never
    closed."""

    def __init__(self):
        super().__init__(run_id="null")


NULL_OBS = _NullObservability()


def make_observability(trace_json: str | None = None,
                       log_json: str | None = None,
                       metrics_textfile: str | None = None,
                       stdout=None,
                       trace_max_events: int | None = None,
                       log_json_max_bytes: int | None = None,
                       run_id: str | None = None,
                       flight=None,
                       stages: StageTable | None = None) -> Observability:
    """Build the run's bundle from the CLI flags (any subset).
    ``--log-json=-`` streams events to ``stdout`` (the conventional
    stdin/stdout marker; report writers targeting stdout should use
    ``-o`` with a file).  ``trace_max_events`` overrides the
    recorder's 200k event cap (``--trace-max-events``);
    ``log_json_max_bytes`` turns on size-capped event-log rotation
    (``--log-json-max-bytes``); ``run_id`` stamps an externally-minted
    identity (a served job's trace_id) on every event line; ``flight``
    is the daemon-owned per-job flight recorder; ``stages`` is the
    run's :class:`StageTable` when the run made it first (a new one
    otherwise: every bundle has one).  Raises ``OSError``
    when a log file cannot be opened — the caller maps it to the usual
    cannot-open diagnostic."""
    registry = run_metrics = tracer = events = None
    if metrics_textfile:
        from pwasm_tpu_torch.obs.catalog import build_run_metrics
        registry = MetricsRegistry()
        run_metrics = build_run_metrics(registry)
    if trace_json:
        tracer = TraceRecorder(max_events=trace_max_events
                               or 200_000)
        if run_metrics is not None:
            # surface drops WHILE the run is alive (they used to
            # appear only in otherData at write time): each dropped
            # event lands on the live counter the exposition serves
            dropped = run_metrics.get("trace_dropped")
            if dropped is not None:
                tracer.on_drop = lambda c=dropped: c.inc()
    if log_json:
        if log_json == "-":
            import sys
            events = EventLog(stdout if stdout is not None
                              else sys.stdout, owns_stream=False,
                              run_id=run_id)
        else:
            # append, as documented: a restarted daemon (or a fleet
            # of runs sharing one log) must extend the incident
            # timeline, never wipe it — rotation (when capped) keeps
            # at most one previous generation beside it
            events = EventLog(path=log_json, run_id=run_id,
                              max_bytes=log_json_max_bytes)
    return Observability(registry=registry, run_metrics=run_metrics,
                         tracer=tracer, events=events,
                         trace_path=trace_json,
                         metrics_path=metrics_textfile,
                         run_id=run_id, flight=flight,
                         stages=stages if stages is not None
                         else StageTable())
