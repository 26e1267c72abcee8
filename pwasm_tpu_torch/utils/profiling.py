"""Device trace hooks: ``--profile=DIR``.

Counterpart of ``pwasm_tpu/utils/profiling.py``.  ``device_trace(dir)``
wraps a region in a ``torch.profiler`` trace when a directory is given
and writes one Chrome trace-event JSON, ``DIR/trace.json``, viewable in
chrome://tracing or Perfetto beside the ``--trace-json`` host spans.
It records the host's torch ops and, on a CUDA run, every kernel and
copy the card ran inside the region (the CUPTI activities), and marks
the region itself as one ``run`` annotation, so a reader can take the
card's busy share of the run from the file alone.  With no directory it
is a no-op and no profiler is made.

The reference writes a ``jax.profiler`` TensorBoard directory instead;
the port's trace is one file in the directory.

One profile at a time a process: two ``torch.profiler`` sessions
started from two threads at once (two ``--profile`` jobs of one serve
daemon) crash the process, so a run asking for a profile while another
holds it fails (exit 1), as the reference's second ``start_trace``
fails its job.
"""

from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager

from pwasm_tpu_torch.core.errors import PwasmError

TRACE_NAME = "trace.json"
_ACTIVE = threading.Lock()     # held while a profile runs


@contextmanager
def device_trace(profile_dir: str | None, stderr=None,
                 device: str = "cuda"):
    """Profile the ``with`` body into ``profile_dir/trace.json``: the
    CPU activities always, the CUDA ones when ``device`` is ``cuda``."""
    if not profile_dir:
        yield
        return
    stderr = stderr or sys.stderr
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    if not _ACTIVE.acquire(blocking=False):
        raise PwasmError("Error: --profile: another run of this process "
                         "is being profiled (one profile at a time)\n")
    try:
        prof = profile(activities=activities)
        prof.start()
        try:
            with record_function("run"):
                yield
        finally:
            prof.stop()
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  TRACE_NAME))
            print(f"device trace written to {profile_dir}", file=stderr)
    finally:
        _ACTIVE.release()
