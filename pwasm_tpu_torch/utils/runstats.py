"""Per-run counters and the ``-v`` run line.

Counterpart of ``pwasm_tpu/utils/runstats.py``, reduced to what the
closing ``-v`` line reads: alignments, diff events and aligned target
bases, over the run's wall clock.  The resilience, device and ``--stats``
counters of the reference come with the port's resilience slice.
"""

from __future__ import annotations

import time


class RunStats:
    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.alignments = 0       # alignments accepted for analysis
        self.aligned_bases = 0    # sum of per-alignment target span
        self.events = 0           # diff events reported

    @property
    def wall_s(self) -> float:
        return time.perf_counter() - self.t0

    def rate(self) -> float:
        """Aligned target bases per second of wall clock."""
        dt = self.wall_s
        return self.aligned_bases / dt if dt > 0 else 0.0

    def brief(self) -> str:
        """One human line for -v stderr output (the reference's format:
        the wall rounded to 3 places, the rate to 1 and printed whole)."""
        wall_s = round(self.wall_s, 3)
        rate = round(self.rate(), 1)
        return (f"{self.alignments} alignments, {self.events} events, "
                f"{self.aligned_bases} aligned bases in {wall_s}s "
                f"({rate:.0f} bases/s)")
