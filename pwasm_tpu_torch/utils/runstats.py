"""Structured per-run statistics: the ``--stats`` JSON and the ``-v`` line.

Counterpart of ``pwasm_tpu/utils/runstats.py``, the same versioned
schema (``STATS_VERSION``), the same keys and the same counting rules.
``RunStats`` tracks the run-level counters (lines, alignments, skipped
lines, aligned bases, events), the device dispatch accounting and the
host stage walls, and writes one JSON object; the per-event
``Summary`` (``report/diff_report.py``) remains the ``-s`` payload.

Where the port counts:

- the input counters in ``cli.py::_main_loop``, as the reference's;
- ``device.*`` at each supervised attempt, in
  ``resilience/supervisor.py::BatchSupervisor.run`` (one
  ``note_dispatch``/``note_flush`` an attempt, and its
  ``device_batch`` span's wall into ``compile_s`` or ``steady_s``),
  and ``device_batches`` once a ctx_scan flush;
- ``device.pad_*`` where the ctx_scan event axis is padded to its
  power-of-two bucket (``report/device_report.py``);
- ``resumed_past`` at the ``--resume`` cursor, ``preempted`` at a
  drain's exit (75), and ``resilience.checkpoints`` once a report batch
  checkpoint is written (``cli.py::_main_loop``);
- the rest of ``resilience.*`` (retries, guardrail rejects, deadline
  timeouts, injected faults, OOM bisection, breaker trips) in the
  supervisor, and ``backend.*`` around the bounded CUDA probe
  (``device.py::resolve_device``).

The ``host`` block maps the port's own stages: ``parse_s`` is the
time in ``parse_paf_line``, summed a line; the rest are the seconds of
the run's spans (``obs.StageTable``): ``extract_s`` the ``extract``
span (the engine's batched crossing, or the one-record call),
``analyze_s`` ``flush_submit`` (the ctx_scan submit: pack, upload,
launch) and ``format_s`` ``flush_format`` (its finish: fetch, assembly,
row formatting) with ``checkpoint`` (the batch's checkpoint).  The
table itself is written beside this schema as the ``stages`` block
(:meth:`write`).

Counters of the reference's degradations stay 0 under its keys: the
port never moves device work to the host, so ``fallback_batches``,
``engine_fallbacks``, ``resilience.fallbacks``, ``degraded_*``,
``breaker_recloses``, ``reprobe_attempts`` and ``recovered_batches``
are 0 on every run that finishes.
"""

from __future__ import annotations

import json
import time
from typing import IO

# The --stats JSON is a versioned schema: programs read it, not just
# eyes.  Additive changes (new keys/blocks) keep the version; a renamed,
# retyped or removed key must bump it.
STATS_VERSION = 1


class RunStats:
    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.lines = 0            # PAF lines seen (non-blank, non-comment)
        self.alignments = 0       # alignments accepted for analysis
        self.skipped_bad = 0      # lines dropped by --skip-bad-lines
        self.skipped_dedup = 0    # gene-mode duplicate (q,t) pairs
        self.skipped_self = 0     # query==target self alignments
        self.resumed_past = 0     # alignments skipped by --resume
        self.aligned_bases = 0    # sum of per-alignment target span
        self.events = 0           # diff events reported
        self.device_batches = 0   # ctx_scan flushes
        self.fallback_batches = 0  # device batches replayed on host
        self.device_events = 0    # events analyzed by the device program
        self.scalar_events = 0    # events analyzed on the host (out of
        #                           device scope: evtlen > MAX_EV)
        self.realigned = 0        # alignments re-aligned (--realign)
        self.msa_dropped = 0      # reported alignments excluded from
        #                           the MSA (bad gap structure)
        self.engine_fallbacks = 0  # engine-level device/native demotions
        # backend-probe accounting (the bounded device probe)
        self.backend_probes = 0     # bounded subprocess probes paid
        self.backend_warm_hits = 0  # probe checks answered warm
        # resilience counters (the supervised device pipeline), one
        # nested "resilience" block in the JSON
        self.res_retries = 0           # re-executed device attempts
        self.res_fallbacks = 0         # batches degraded to the host
        self.res_guardrail_rejects = 0  # outputs rejected as corrupt
        self.res_deadline_timeouts = 0  # attempts past --device-deadline
        self.res_breaker_trips = 0     # global breaker opens
        self.res_site_breaker_trips = 0  # per-site breaker opens
        self.res_injected_faults = 0   # faults injected (--inject-faults)
        self.res_checkpoints = 0       # durable batch checkpoints written
        self.res_oom_events = 0        # device allocation failures seen
        self.res_batch_splits = 0      # batches bisected after an OOM
        self.res_bucket_demotions = 0  # pow2 batch-ceiling lowerings
        self.res_bucket_repromotions = 0  # raises of a demoted ceiling
        self.preempted = False         # the run exited via a graceful
        #                                drain: stats are partial
        self.res_breaker_recloses = 0  # global breaker recloses
        self.res_reprobe_attempts = 0  # backend re-probes while open
        self.res_degraded_batches = 0  # batches skipped to the host
        self.res_recovered_batches = 0  # device batches after a reclose
        self.res_degraded_wall_s = 0.0  # wall with the breaker open
        # host stage walls (the module docstring maps them), one nested
        # "host" block in the JSON, folded into
        # pwasm_host_stage_seconds_total{stage} (obs/catalog.py)
        self.host_parse_s = 0.0
        self.host_extract_s = 0.0
        self.host_analyze_s = 0.0
        self.host_format_s = 0.0
        # dispatch budget: a "dispatch" is one device program launch
        # (one supervised attempt), a "flush" one host-blocking
        # round-trip (the host waits on device results); one nested
        # "device" block in the JSON
        self.device_dispatches = 0     # device program launches
        self.device_flushes = 0        # host-blocking result fetches
        self.dispatches_by_site = {}   # site -> launch count
        # utilization: power-of-two padding waste (live rows vs
        # launched slots in each padded device batch) and the
        # first-vs-later split of dispatch walls (a site's first
        # dispatch pays the kernel build or load and its first launch)
        self.device_pad_items = 0      # live rows in padded launches
        self.device_pad_slots = 0      # total slots (live + pad)
        self.device_compile_s = 0.0    # first-dispatch-per-site wall
        self.device_steady_s = 0.0     # later dispatch wall
        self._compiled_sites: set = set()

    def note_dispatch(self, site: str, n: int = 1) -> None:
        """Count ``n`` device program launches at ``site`` (ctx_scan,
        realign, consensus, refine, many2many)."""
        self.device_dispatches += n
        self.dispatches_by_site[site] = \
            self.dispatches_by_site.get(site, 0) + n

    def note_flush(self, n: int = 1) -> None:
        """Count ``n`` host-blocking device round-trips (a fetch the
        host waits on)."""
        self.device_flushes += n

    def note_pad(self, items: int, slots: int) -> None:
        """Count one power-of-two padded device launch: ``items`` live
        rows in ``slots`` launched slots."""
        self.device_pad_items += items
        self.device_pad_slots += slots

    def note_attempt_wall(self, site: str, wall_s: float) -> None:
        """Split one dispatch's wall into compile-inclusive (the site's
        first dispatch this run) and steady."""
        if site in self._compiled_sites:
            self.device_steady_s += wall_s
        else:
            self._compiled_sites.add(site)
            self.device_compile_s += wall_s

    @property
    def wall_s(self) -> float:
        return time.perf_counter() - self.t0

    def rate(self) -> float:
        """Aligned target bases per second of wall clock."""
        dt = self.wall_s
        return self.aligned_bases / dt if dt > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "stats_version": STATS_VERSION,
            "lines": self.lines,
            "alignments": self.alignments,
            "skipped_bad_lines": self.skipped_bad,
            "skipped_duplicates": self.skipped_dedup,
            "skipped_self": self.skipped_self,
            "resumed_past": self.resumed_past,
            "aligned_bases": self.aligned_bases,
            "events": self.events,
            "device_batches": self.device_batches,
            "fallback_batches": self.fallback_batches,
            "device_events": self.device_events,
            "scalar_events": self.scalar_events,
            "realigned": self.realigned,
            "msa_dropped": self.msa_dropped,
            "engine_fallbacks": self.engine_fallbacks,
            "backend": {
                "probes": self.backend_probes,
                "warm_hits": self.backend_warm_hits,
            },
            "device": {
                "dispatches": self.device_dispatches,
                "flushes": self.device_flushes,
                "by_site": dict(self.dispatches_by_site),
                "pad_items": self.device_pad_items,
                "pad_slots": self.device_pad_slots,
                "compile_s": round(self.device_compile_s, 6),
                "steady_s": round(self.device_steady_s, 6),
            },
            "host": {
                "parse_s": round(self.host_parse_s, 6),
                "extract_s": round(self.host_extract_s, 6),
                "analyze_s": round(self.host_analyze_s, 6),
                "format_s": round(self.host_format_s, 6),
            },
            "resilience": {
                "retries": self.res_retries,
                "fallbacks": self.res_fallbacks,
                "guardrail_rejects": self.res_guardrail_rejects,
                "deadline_timeouts": self.res_deadline_timeouts,
                "breaker_trips": self.res_breaker_trips,
                "site_breaker_trips": self.res_site_breaker_trips,
                "injected_faults": self.res_injected_faults,
                "checkpoints": self.res_checkpoints,
                "oom_events": self.res_oom_events,
                "batch_splits": self.res_batch_splits,
                "bucket_demotions": self.res_bucket_demotions,
                "bucket_repromotions": self.res_bucket_repromotions,
                "breaker_recloses": self.res_breaker_recloses,
                "reprobe_attempts": self.res_reprobe_attempts,
                "degraded_batches": self.res_degraded_batches,
                "recovered_batches": self.res_recovered_batches,
                "degraded_wall_s": round(self.res_degraded_wall_s, 3),
            },
            "preempted": self.preempted,
            "wall_s": round(self.wall_s, 3),
            "aligned_bases_per_s": round(self.rate(), 1),
        }

    def write(self, f: IO[str], stages: dict | None = None) -> None:
        """The ``--stats`` JSON: :meth:`as_dict`, and beside it the run's
        ``stages`` block when given (``obs.StageTable``)."""
        d = self.as_dict()
        if stages is not None:
            d["stages"] = stages
        # json.dumps encodes in C; json.dump would encode in Python and
        # write a piece at a time (the same text, a third of the time)
        f.write(json.dumps(d) + "\n")

    def brief(self) -> str:
        """One human line for -v stderr output (the wall rounded to 3
        places, the rate to 1 and printed whole)."""
        d = self.as_dict()
        return (f"{d['alignments']} alignments, {d['events']} events, "
                f"{d['aligned_bases']} aligned bases in {d['wall_s']}s "
                f"({d['aligned_bases_per_s']:.0f} bases/s)")
