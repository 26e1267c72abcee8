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
- ``trace-merge``  several ``--trace-json`` documents on one wall
  axis (:mod:`pwasm_tpu_torch.obs.merge`);
- the serve daemon's per-job flight record, read by the ``inspect``
  verb (:mod:`pwasm_tpu_torch.obs.flight`).

The :class:`Observability` facade is what gets threaded through the
run (cli -> the batch supervisor, ``resilience/supervisor.py``): a null
instance (every hook a cheap no-op) when no flag asked for anything, so
the hot path carries one attribute check per hook and the byte-parity
contract — report bytes identical with observability on and off —
holds by construction (observability writes only to its own sinks,
never the report stream).  Metric NAMES live in
:mod:`pwasm_tpu_torch.obs.catalog`, the single registration namespace.

A run served by the daemon fills the facade's ``flight`` slot with its
job's :class:`~pwasm_tpu_torch.obs.flight.FlightRecorder`; a cold run
leaves it ``None``.
"""

from __future__ import annotations

import time as _time
from contextlib import nullcontext

from pwasm_tpu_torch.obs.events import EventLog, new_run_id  # noqa: F401
from pwasm_tpu_torch.obs.flight import FlightRecorder  # noqa: F401
from pwasm_tpu_torch.obs.metrics import MetricsRegistry  # noqa: F401
from pwasm_tpu_torch.obs.tracing import TraceRecorder  # noqa: F401


class _ObsSpan:
    """One span feeding BOTH sinks that want it: the trace recorder
    (when tracing) and the per-job flight recorder (when the run is a
    served job).  Timing for the flight side is perf_counter around
    the block; the tracer keeps its own clock."""

    __slots__ = ("_obs", "_name", "_tcm", "_t0")

    def __init__(self, obs: "Observability", name: str, args: dict):
        self._obs = obs
        self._name = name
        self._tcm = obs.tracer.span(name, **args) \
            if obs.tracer is not None else None

    def __enter__(self) -> "_ObsSpan":
        self._t0 = _time.perf_counter()
        if self._tcm is not None:
            self._tcm.__enter__()
        return self

    def __exit__(self, etype, exc, tb) -> None:
        if self._tcm is not None:
            self._tcm.__exit__(etype, exc, tb)
        flight = self._obs.flight
        if flight is not None:
            flight.note(self._name,
                        _time.perf_counter() - self._t0)


class Observability:
    """The per-run observability bundle.  Any of the sinks may be
    absent; every hook degrades to a no-op so call sites never branch.

    ``registry``/``run_metrics`` — the metrics registry and the built
    run-metric families (``obs/catalog.py``); ``tracer`` — the span
    recorder; ``events`` — the NDJSON event log; ``flight`` — the
    per-job :class:`~pwasm_tpu_torch.obs.flight.FlightRecorder` a serve
    daemon hands a served job (spans accumulate phase walls there,
    events land in its ring).  ``trace_path`` / ``metrics_path`` are
    written by :meth:`close`.
    """

    def __init__(self, registry=None, run_metrics=None, tracer=None,
                 events=None, trace_path=None, metrics_path=None,
                 run_id=None, flight=None):
        self.registry = registry
        self.run_metrics = run_metrics
        self.tracer = tracer
        self.events = events
        self.flight = flight
        self.trace_path = trace_path
        self.metrics_path = metrics_path
        self.run_id = run_id or (events.run_id if events is not None
                                 else new_run_id())

    @property
    def enabled(self) -> bool:
        return (self.registry is not None or self.tracer is not None
                or self.events is not None or self.flight is not None)

    # ---- hooks (all no-ops when the sink is absent) --------------------
    def span(self, name: str, **args):
        if self.tracer is None and self.flight is None:
            return nullcontext()
        return _ObsSpan(self, name, args)

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

    def clock(self) -> float:
        """The span clock (0.0 when neither tracing nor flight-
        recording) — pair with :meth:`span_complete` for
        manually-extents phases."""
        if self.tracer is not None:
            return self.tracer.now()
        if self.flight is not None:
            return _time.perf_counter()
        return 0.0

    def span_complete(self, name: str, t0: float, **args) -> None:
        if self.tracer is not None:
            now = self.tracer.now()
            self.tracer.complete(name, t0, **args)
        elif self.flight is not None:
            now = _time.perf_counter()
        else:
            return
        if self.flight is not None:
            self.flight.note(name, max(0.0, now - t0))

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
                       flight=None) -> Observability:
    """Build the run's bundle from the CLI flags (any subset).
    ``--log-json=-`` streams events to ``stdout`` (the conventional
    stdin/stdout marker; report writers targeting stdout should use
    ``-o`` with a file).  ``trace_max_events`` overrides the
    recorder's 200k event cap (``--trace-max-events``);
    ``log_json_max_bytes`` turns on size-capped event-log rotation
    (``--log-json-max-bytes``); ``run_id`` stamps an externally-minted
    identity (a served job's trace_id) on every event line; ``flight``
    is the daemon-owned per-job flight recorder.  Raises ``OSError``
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
                         run_id=run_id, flight=flight)
