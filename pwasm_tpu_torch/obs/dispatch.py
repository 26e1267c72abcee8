"""The device dispatch hook: one dispatch, counted and traced.

The reference runs every device round-trip under
``resilience/supervisor.py::BatchSupervisor.run(site, attempt)``, and
one supervised attempt there (``supervisor.py:293-318``) does four
things besides the work:

- ``note_dispatch(site)`` and ``note_flush()`` on the run's
  ``RunStats``;
- a ``device_batch`` span with ``site``, ``attempt`` and ``items``;
- ``note_attempt_wall(site, wall)`` (the first-vs-steady split);
- ``observe("batch_attempt_seconds", wall, site=site)``.

The port has no supervisor yet, so :class:`DispatchHook` does exactly
that around one attempt (``attempt=0``: no retries, no guardrails, no
fallback).  The sites are the reference's: ``ctx_scan``
(``report/device_report.py``), ``realign`` (``ops/realign.py``),
``consensus`` (a call of ``align/msa.py::device_counts_votes``, from
``Msa.build_msa`` or the engine path's ``cli.py::_native_msa_outputs``),
``refine`` (``ops/refine_clip.py::refine_phases``) and ``many2many``
(``parallel/many2many.py``).  A call over a ``--shard`` mesh is one
dispatch, as in the reference.  A library call made outside a run
takes :data:`NULL_HOOK`, which counts and traces nothing.  The port's
resilience slice brings the supervisor, whose ``run`` absorbs this
module: the call sites keep their ``hook.run(site, attempt, items)``
shape.
"""

from __future__ import annotations

import time

from pwasm_tpu_torch.obs import NULL_OBS


class DispatchHook:
    """Counts and traces the run's device dispatches into ``stats`` (a
    ``utils.runstats.RunStats``, or None) and ``obs`` (an
    ``Observability``, default ``NULL_OBS``)."""

    def __init__(self, stats=None, obs=None):
        self.stats = stats
        self.obs = obs if obs is not None else NULL_OBS

    def run(self, site: str, attempt, items: int | None = None):
        """Run ``attempt()`` as one dispatch at ``site`` that ends in
        the host-blocking fetch of its results (one flush), and return
        its result."""
        self.note_flush()
        return self.launch(site, attempt, items)

    def launch(self, site: str, attempt, items: int | None = None):
        """Run ``attempt()`` as one dispatch at ``site`` (``items``: the
        batch's item count, where the reference declares one) whose
        results stay on the device: the caller counts its later fetch
        with :meth:`note_flush`.  The wall is taken around the whole
        attempt."""
        t0 = time.perf_counter()
        try:
            if self.stats is not None:
                self.stats.note_dispatch(site)
            with self.obs.span("device_batch", site=site, attempt=0,
                               items=items):
                return attempt()
        finally:
            wall = time.perf_counter() - t0
            self.obs.observe("batch_attempt_seconds", wall, site=site)
            if self.stats is not None:
                self.stats.note_attempt_wall(site, wall)

    def note_flush(self) -> None:
        """Count one host-blocking fetch of device results."""
        if self.stats is not None:
            self.stats.note_flush()

    def note_pad(self, real: int, padded: int) -> None:
        """Count a launch axis of ``real`` items padded to ``padded``."""
        if self.stats is not None:
            self.stats.note_pad(real, padded)

    def note_events(self, device: int = 0, scalar: int = 0) -> None:
        """Count events analyzed on the device and on the host."""
        if self.stats is not None:
            self.stats.device_events += device
            self.stats.scalar_events += scalar


NULL_HOOK = DispatchHook()
