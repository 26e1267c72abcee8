"""NDJSON event-log querying (``pafreport logs``).

Counterpart of ``pwasm_tpu/obs/logquery.py``, with its names.
Incident reconstruction without grepping two files by hand — the live
``--log-json`` file plus its rotated ``.1`` generation, in the right
order.  This module is that grep, done once and shared by the two
surfaces:

- ``pafreport logs FILE [filters]`` reads a log on disk directly;
- ``pafreport logs --socket=PATH [filters]`` asks a live daemon over
  the ``logs`` protocol verb — the daemon runs the same
  :func:`query_log` over its own ``--log-json`` path, so remote and
  local filtering cannot disagree.

Filters: ``trace_id`` (matches the record's ``trace_id`` OR its
``run_id`` — a served job's own run events carry the trace identity
as run_id), ``job_id``, and ``event`` (exact event-type match).
Results come back oldest-first across the rotation seam
(``FILE.1`` before ``FILE``), bounded by ``limit`` keeping the NEWEST
matches — an incident query wants the end of the story, not the
beginning of the file.

Stdlib only and read-only, like everything in
``pwasm_tpu_torch/obs/``.
"""

from __future__ import annotations

import json


def iter_log_records(path: str):
    """Yield parsed event dicts from ``path``'s rotated generation
    (``path + '.1'``, when present) then ``path`` itself — oldest
    first across the seam.  Unparseable lines (a torn tail from a
    crash, a hand edit) are skipped, never fatal: the log exists to
    explain failures, so reading it must not add one."""
    for p in (path + ".1", path):
        try:
            f = open(p, encoding="utf-8")
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    yield rec


def record_matches(rec: dict, trace_id: str | None = None,
                   job_id: str | None = None,
                   event: str | None = None) -> bool:
    """One record against the filter set (all given filters must
    match).  ``trace_id`` matches either the explicit ``trace_id``
    field or ``run_id`` — a served job's cli.run stamps its trace
    identity as the run_id on its own event lines."""
    if trace_id is not None and rec.get("trace_id") != trace_id \
            and rec.get("run_id") != trace_id:
        return False
    if job_id is not None and rec.get("job_id") != job_id:
        return False
    if event is not None and rec.get("event") != event:
        return False
    return True


def query_log(path: str, trace_id: str | None = None,
              job_id: str | None = None, event: str | None = None,
              limit: int = 1000) -> list[dict]:
    """The newest ``limit`` matching records, oldest-first, across
    the rotation seam."""
    from collections import deque
    out: deque = deque(maxlen=max(1, int(limit)))
    for rec in iter_log_records(path):
        if record_matches(rec, trace_id=trace_id, job_id=job_id,
                          event=event):
            out.append(rec)
    return list(out)
