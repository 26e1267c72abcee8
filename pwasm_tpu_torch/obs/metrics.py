"""Thread-safe metrics registry with Prometheus text exposition.

The fleet-facing half of the observability surface: counters,
gauges and fixed-bucket histograms registered once in a
:class:`MetricsRegistry` and rendered in the Prometheus text exposition
format (version 0.0.4 — the `# HELP` / `# TYPE` / sample-line grammar
every scraper and the node-exporter textfile collector speak).  Two
transports surface it: the serve daemon's ``metrics`` protocol command
(scraped over the unix socket) and the ``--metrics-textfile=PATH``
option (written atomically through ``utils.fsio`` so a collector never
reads a torn file).

Counterpart of ``pwasm_tpu/obs/metrics.py``, the same grammar and
exposition.  Stdlib-only: observability must be importable — and
cheap — on a run that never touches the card.

Naming is checked statically (``tests/test_torch_obs.py``): every
metric name is snake_case with the ``pwasm_`` prefix, and every
registration lives in ``obs/catalog.py`` so the catalog IS the
namespace — duplicate registration raises here at runtime and fails
the lint at review time.
"""

from __future__ import annotations

import re
import threading
import time

# the linted grammar: pwasm_ prefix, lower-snake-case throughout
NAME_RE = re.compile(r"^pwasm_[a-z0-9]+(_[a-z0-9]+)*$")
LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# default histogram buckets for wall-clock seconds (jobs/batches span
# milliseconds on the host path to minutes on a cold device compile)
DEFAULT_TIME_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                        1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


def _fmt_num(v) -> str:
    """One canonical number rendering: ints bare, integral floats as
    ints (Prometheus treats 3 and 3.0 identically; bare ints diff
    cleaner in tests), everything else via repr (shortest round-trip)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(str(v))}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """Base: one metric family (name + help + label names), holding one
    value cell per observed label-value tuple.  All mutation goes
    through the family lock — the daemon's worker threads and the
    accept loop update concurrently."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labels: tuple[str, ...] = ()):
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the lint grammar "
                "(snake_case, pwasm_ prefix)")
        for lb in labels:
            if not LABEL_RE.match(lb):
                raise ValueError(f"bad label name {lb!r} on {name}")
        self.name = name
        self.help_text = help_text
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._cells: dict[tuple, object] = {}

    def _values(self, labels: dict) -> tuple:
        if set(labels) != set(self.labels):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labels)}")
        return tuple(str(labels[n]) for n in self.labels)

    def expose(self, exemplars: bool = False) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help_text)}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            # snapshot INSIDE the lock (including mutable histogram
            # cells) so a concurrent observe() cannot tear one
            # rendered sample apart from another (_sum vs _count)
            cells = [(values, self._snapshot(cell))
                     for values, cell in sorted(self._cells.items())]
        for values, cell in cells:
            out.extend(self._expose_cell(values, cell, exemplars))
        return out

    def _snapshot(self, cell):
        return cell   # numbers are immutable; Histogram overrides

    def snapshot_cells(self) -> list[tuple[dict, object]]:
        """Every live cell as ``({label: value}, snapshot)`` rows —
        the read API the SLO engine (obs/slo.py) evaluates rules over.
        Counter/gauge snapshots are plain numbers; Histogram rows are
        the raw ``(bucket_counts, sum, exemplars)`` triple (counts
        cumulated by the consumer, exactly like exposition).  Taken
        under the family lock, so one evaluation never sees a torn
        cell."""
        with self._lock:
            return [(dict(zip(self.labels, values)),
                     self._snapshot(cell))
                    for values, cell in sorted(self._cells.items())]

    def _expose_cell(self, values: tuple, cell,
                     exemplars: bool = False) -> list[str]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count.  ``inc`` only — a counter that
    can go down is a gauge wearing the wrong TYPE line."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counter decrement ({n})")
        key = self._values(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._cells.get(self._values(labels), 0)

    def _expose_cell(self, values, cell,
                     exemplars: bool = False) -> list[str]:
        return [f"{self.name}{_label_str(self.labels, values)} "
                f"{_fmt_num(cell)}"]


class Gauge(_Metric):
    """A point-in-time level (queue depth, breaker state): settable in
    both directions, resettable to zero."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        key = self._values(labels)
        with self._lock:
            self._cells[key] = v

    def inc(self, n: float = 1, **labels) -> None:
        key = self._values(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def reset(self, **labels) -> None:
        self.set(0, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._cells.get(self._values(labels), 0)

    def _expose_cell(self, values, cell,
                     exemplars: bool = False) -> list[str]:
        return [f"{self.name}{_label_str(self.labels, values)} "
                f"{_fmt_num(cell)}"]


class Histogram(_Metric):
    """Fixed-bucket histogram.  Buckets are declared at registration
    (sorted, finite upper bounds); exposition renders the Prometheus
    cumulative form — each ``_bucket{le="x"}`` counts observations
    ``<= x``, the mandatory ``+Inf`` bucket equals ``_count``, and
    ``_sum`` carries the total.

    Exemplars: ``observe(v, trace_id=...)``
    attaches the observation's cross-process trace identity to the
    bucket it landed in (latest wins per bucket), rendered in the
    OpenMetrics exemplar syntax — ``..._bucket{le="1"} 7
    # {trace_id="8f3ab129cd01"} 0.93 <ts>`` — so a p99 bucket links
    straight to ``pwasm-tpu inspect``'s flight record for a job that
    actually landed there.  Rendering is OPT-IN per exposition
    (``expose(exemplars=True)``): the default output stays pure
    Prometheus 0.0.4, which classic scrapers require."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
                 labels: tuple[str, ...] = ()):
        super().__init__(name, help_text, labels)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(set(bs)):
            raise ValueError(
                f"{name}: buckets must be a sorted unique tuple")
        self.buckets = bs

    def observe(self, v: float, trace_id: str | None = None,
                **labels) -> None:
        key = self._values(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                # per-bucket RAW counts (cumulated at exposition),
                # sum, and the per-bucket latest exemplar
                cell = [[0] * (len(self.buckets) + 1), 0.0, {}]
                self._cells[key] = cell
            counts = cell[0]
            idx = len(self.buckets)      # the +Inf overflow bucket
            for i, b in enumerate(self.buckets):
                if v <= b:
                    idx = i
                    break
            counts[idx] += 1
            cell[1] += v
            if trace_id:
                cell[2][idx] = (str(trace_id), float(v),
                                round(time.time(), 3))

    def count(self, **labels) -> int:
        with self._lock:
            cell = self._cells.get(self._values(labels))
            return sum(cell[0]) if cell else 0

    def _snapshot(self, cell):
        counts, total, ex = cell
        return (list(counts), total, dict(ex))

    def _expose_cell(self, values, cell,
                     exemplars: bool = False) -> list[str]:
        counts, total, ex = cell

        def exemplar(idx: int) -> str:
            e = ex.get(idx) if exemplars else None
            if e is None:
                return ""
            tid, v, ts = e
            return (f' # {{trace_id="{_escape_label(tid)}"}} '
                    f"{_fmt_num(v)} {_fmt_num(ts)}")

        out = []
        cum = 0
        for i, (b, c) in enumerate(zip(self.buckets, counts)):
            cum += c
            lbl = _label_str(self.labels + ("le",),
                             values + (_fmt_num(b),))
            out.append(f"{self.name}_bucket{lbl} {cum}"
                       + exemplar(i))
        cum += counts[-1]
        lbl = _label_str(self.labels + ("le",), values + ("+Inf",))
        out.append(f"{self.name}_bucket{lbl} {cum}"
                   + exemplar(len(self.buckets)))
        base = _label_str(self.labels, values)
        out.append(f"{self.name}_sum{base} {_fmt_num(total)}")
        out.append(f"{self.name}_count{base} {cum}")
        return out


class MetricsRegistry:
    """One namespace of metric families.  Registration is
    first-wins-and-second-raises: a duplicate name is a programming
    error the static lint also catches, never a silent aliasing of two
    meanings onto one time series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, m: _Metric) -> _Metric:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(
                    f"metric {m.name!r} already registered")
            self._metrics[m.name] = m
        return m

    def counter(self, name: str, help_text: str,
                labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter(name, help_text, labels))

    def gauge(self, name: str, help_text: str,
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge(name, help_text, labels))

    def histogram(self, name: str, help_text: str,
                  buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
                  labels: tuple[str, ...] = ()) -> Histogram:
        return self._register(Histogram(name, help_text, buckets,
                                        labels))

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def expose(self, exemplars: bool = False) -> str:
        """The full registry in Prometheus text exposition format
        (families in registration order — stable output diffs are part
        of the test contract).  ``exemplars=True`` additionally
        renders the OpenMetrics exemplar suffix on histogram bucket
        lines — OPT-IN, because classic Prometheus 0.0.4 parsers (and
        the node-exporter textfile collector) reject the trailing
        ``#``: the default exposition and the textfile stay pure
        0.0.4, and exemplar-aware consumers (``pwasm-tpu metrics
        --exemplars``, OpenMetrics scrapers) ask explicitly."""
        with self._lock:
            fams = list(self._metrics.values())
        lines: list[str] = []
        for m in fams:
            lines.extend(m.expose(exemplars))
        return "\n".join(lines) + "\n" if lines else ""

    def write_textfile(self, path: str) -> None:
        """Publish the exposition atomically+durably for a
        node-exporter textfile collector: the audited fsync-then-replace
        (``utils.fsio``) — a scraper reads the old snapshot or the new
        one, never a torn prefix."""
        from pwasm_tpu_torch.utils.fsio import write_durable_text
        write_durable_text(path, self.expose())
