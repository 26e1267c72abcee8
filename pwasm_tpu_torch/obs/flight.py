"""Per-job flight record: bounded phase accounting + event ring.

Counterpart of ``pwasm_tpu/obs/flight.py``, copied whole.
The post-hoc "explain this job's wall" record: every served
job carries ONE :class:`FlightRecorder` from admission to its terminal
state, accumulating

- **phase walls** — queue wait, device-lease wait, the execution wall,
  and the run's own internal phases (input loop, per-flush
  submit/format walls, per-flush host-stage deltas, the MSA tail) as
  the :class:`~pwasm_tpu_torch.obs.Observability` spans feed them in;
- **two bounded rings** — span summaries (per-flush walls; the last
  ``max_entries``) and diagnostic marks (retries, breaker transitions,
  OOM bisections, checkpoint writes, drains; the last ``max_marks``,
  kept SEPARATE so routine per-flush noise can never evict the rare
  events an incident review needs) — oldest dropped first either way
  (a flight recorder must stay bounded no matter how turbulent the
  flight).

The :meth:`summary` is a plain JSON-able dict: it rides the job
record in daemon RAM, moves to the CRC'd result spool past the
threshold, and is served by the ``inspect`` protocol verb /
``pafreport inspect JOB_ID`` — so "why was job X slow?" is one
request, not a grep across four files.  ``coverage`` is the accounted
fraction of the job's wall (queue + lease + exec over
submit→finish); the acceptance gate holds it at >= 0.9.

It imports no torch and never raises, by the same contract as the event log: a
recorder must not become the failure it was meant to explain.
"""

from __future__ import annotations

import threading
import time
from collections import deque

FLIGHT_VERSION = 1

# the phases whose sum is gated against the job wall (submit->finish):
# everything else in ``phases`` is breakdown INSIDE these
ACCOUNTED_PHASES = ("queue_wait", "lease_wait", "exec")

# marks that recur once per BATCH for a job's whole life: they route
# to the span-summary ring, because 64 slots of diagnostic ring must
# never be flooded by minute-2's checkpoint cadence (an OOM bisection
# from hour 1 has to still be visible at hour 9)
ROUTINE_MARKS = frozenset({"ckpt_write"})


class FlightRecorder:
    """Thread-safe bounded per-job phase/event record.

    ``note(phase, dur_s)`` accumulates a phase wall (and appends one
    ring entry); ``mark(event)`` appends a point event.  Both use a
    BOUNDED lock acquire and drop on timeout — the recorder is fed
    from span exits and the signal-drain path, exactly like the event
    log, and must never deadlock or raise into the run it observes.
    """

    def __init__(self, trace_id: str | None = None,
                 max_entries: int = 192, max_marks: int = 64):
        self.trace_id = trace_id
        self._lock = threading.Lock()
        self._phases: dict[str, list] = {}    # name -> [total_s, n]
        # TWO rings, so routine per-flush span summaries (one per
        # flush, hundreds on a long job) can never evict the rare
        # diagnostic marks (a retry, a breaker trip, an OOM bisection)
        # the recorder exists to keep
        self._entries: deque[dict] = deque(maxlen=max(1, max_entries))
        self._marks: deque[dict] = deque(maxlen=max(1, max_marks))
        self._appended = 0
        self._marked = 0

    # ---- recording -----------------------------------------------------
    def note(self, phase: str, dur_s: float, **extra) -> None:
        """Accumulate ``dur_s`` wall seconds under ``phase``."""
        entry = {"ph": str(phase), "s": round(float(dur_s), 6),
                 "t": round(time.time(), 3)}
        for k, v in extra.items():
            if v is not None:
                entry[k] = v
        if not self._lock.acquire(timeout=0.2):
            return
        try:
            cell = self._phases.get(phase)
            if cell is None:
                cell = self._phases[phase] = [0.0, 0]
            cell[0] += float(dur_s)
            cell[1] += 1
            self._entries.append(entry)
            self._appended += 1
        except Exception:
            pass
        finally:
            self._lock.release()

    def mark(self, event: str, **fields) -> None:
        """Append one point event (no duration) to the mark ring —
        except :data:`ROUTINE_MARKS` (per-batch cadence), which land
        in the span ring so they cannot evict rare incident marks."""
        entry = {"ev": str(event), "t": round(time.time(), 3)}
        for k, v in fields.items():
            if v is not None:
                entry[k] = v
        if not self._lock.acquire(timeout=0.2):
            return
        try:
            if event in ROUTINE_MARKS:
                self._entries.append(entry)
                self._appended += 1
            else:
                self._marks.append(entry)
                self._marked += 1
        except Exception:
            pass
        finally:
            self._lock.release()

    # ---- introspection -------------------------------------------------
    def phase_s(self, phase: str) -> float:
        with self._lock:
            cell = self._phases.get(phase)
            return cell[0] if cell else 0.0

    def summary(self, wall_s: float | None = None) -> dict:
        """The JSON-able flight record.  ``wall_s`` (the job's
        submit→finish wall) turns on the coverage figure — the
        accounted fraction the acceptance gate holds at >= 0.9."""
        with self._lock:
            phases = {name: {"s": round(cell[0], 6), "n": cell[1]}
                      for name, cell in sorted(self._phases.items())}
            entries = [dict(e) for e in self._entries]
            marks = [dict(e) for e in self._marks]
            dropped = max(0, self._appended - len(self._entries))
            marks_dropped = max(0, self._marked - len(self._marks))
        accounted = sum(phases[p]["s"] for p in ACCOUNTED_PHASES
                        if p in phases)
        out = {"version": FLIGHT_VERSION,
               "trace_id": self.trace_id,
               "phases": phases,
               "accounted_s": round(accounted, 6),
               "entries": entries,
               "entries_dropped": dropped,
               "events": marks,
               "events_dropped": marks_dropped}
        if wall_s is not None and wall_s > 0:
            out["wall_s"] = round(float(wall_s), 6)
            out["coverage"] = round(min(1.0, accounted / wall_s), 4)
        return out
