"""Cross-process trace correlation: ``pwasm-tpu trace-merge``.

Each :class:`~pwasm_tpu_torch.obs.tracing.TraceRecorder` stamps spans on its
OWN monotonic clock (``ts`` microseconds relative to recorder start)
plus one wall-clock anchor (``otherData.anchor_wall_s``, the wall time
of the monotonic origin).  Two processes' traces of one job — the
client's submit/wait spans and the daemon's queue/lease/exec spans —
therefore live on incomparable time axes until the anchors line them
up: :func:`merge_traces` shifts every document onto the EARLIEST
anchor's axis and emits one Chrome-trace JSON, loadable in
chrome://tracing / Perfetto, where a job's full
client→queue→lease→device→spool life reads as one timeline (grep the
``trace_id`` span args to isolate one job).

A ``--profile`` trace (``utils/profiling.py``, torch.profiler's Chrome
trace) merges too: its ``ts`` microseconds count from its
``baseTimeNanoseconds``, a Unix time, so ``baseTimeNanoseconds / 1e9``
is its anchor.  A served job's daemon spans, its run's stage spans and
the kernels its stages launched then read on one axis; each stage span
of ``--trace-json`` sits beside its ``record_function`` twin in the
profile.

Anchor caveat: the shift is exact only as far as the two hosts' wall
clocks agree — on one machine (the unix-socket serving case) that is
microseconds; across NTP-disciplined hosts, milliseconds.  Span
NESTING within each process is untouched either way (one constant
shift per document), so the monotonic-nesting schema property
survives the merge.

Counterpart of ``pwasm_tpu/obs/merge.py``: the same merge, byte for
byte, of the same ``--trace-json`` documents.
"""

from __future__ import annotations

import json

from pwasm_tpu_torch.core.errors import EXIT_USAGE

_MERGE_USAGE = """Usage:
 pwasm-tpu trace-merge FILE.json [FILE.json ...] [-o OUT.json]

   Merge two or more --trace-json documents (e.g. a submit client's
   trace and the serve daemon's serve --trace-json), and --profile
   traces (DIR/trace.json), onto one wall-anchored timeline.  Writes
   Chrome trace-event JSON to OUT.json (default: stdout) — load it
   in chrome://tracing or Perfetto and filter on a trace_id to follow
   one job across both processes.
"""


def trace_anchor(doc: dict) -> float | None:
    """The wall time (Unix seconds) of ``ts`` 0 in ``doc``: a
    ``--trace-json`` document's ``otherData.anchor_wall_s``, a
    torch.profiler trace's ``baseTimeNanoseconds / 1e9``, else None."""
    a = (doc.get("otherData") or {}).get("anchor_wall_s")
    if isinstance(a, (int, float)):
        return float(a)
    base = doc.get("baseTimeNanoseconds")
    if isinstance(base, (int, float)) and not isinstance(base, bool):
        return base / 1e9
    return None


def merge_traces(docs: list[tuple[str, dict]]) -> dict:
    """Merge ``(label, trace_doc)`` pairs onto one timeline.

    Every document's events are shifted by its wall-anchor delta to
    the earliest anchor (one constant per document — intra-process
    nesting is preserved exactly); pids colliding across documents are
    remapped so two processes that happened to share a pid (or two
    captures of one process) stay separate tracks; a ``process_name``
    metadata event labels each track with its source file."""
    anchors = [trace_anchor(doc) or 0.0 for _label, doc in docs]
    base = min(anchors) if anchors else 0.0
    events: list[dict] = []
    used_pids: set = set()
    dropped_total = 0
    for i, ((label, doc), anchor) in enumerate(zip(docs, anchors)):
        shift_us = int(round((anchor - base) * 1e6))
        doc_events = doc.get("traceEvents") or []
        doc_pids = {e.get("pid") for e in doc_events
                    if isinstance(e, dict)}
        remap = {}
        for pid in doc_pids:
            new = pid
            while new in used_pids:
                new = (new if isinstance(new, int) else 0) + 1_000_000
            remap[pid] = new
            used_pids.add(new)
        for pid in sorted((p for p in doc_pids
                           if isinstance(p, int)), key=int):
            events.append({"name": "process_name", "ph": "M",
                           "pid": remap[pid], "tid": 0,
                           "args": {"name": label}})
        for e in doc_events:
            if not isinstance(e, dict):
                continue
            e2 = dict(e)
            ts = e2.get("ts")
            if isinstance(ts, (int, float)):
                # a profile's fractional microseconds stay fractional
                e2["ts"] = (ts if isinstance(ts, float) else int(ts)) \
                    + shift_us
            if e2.get("pid") in remap:
                e2["pid"] = remap[e2["pid"]]
            events.append(e2)
        od = doc.get("otherData") or {}
        if isinstance(od.get("dropped_events"), int):
            dropped_total += od["dropped_events"]
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"anchor_wall_s": round(base, 6),
                         "merged": len(docs)}}
    if dropped_total:
        out["otherData"]["dropped_events"] = dropped_total
    return out


def trace_merge_main(argv: list[str], stdout=None, stderr=None) -> int:
    """The ``pwasm-tpu trace-merge`` entry point."""
    import os
    import sys
    stdout = stdout if stdout is not None else sys.stdout
    stderr = stderr if stderr is not None else sys.stderr
    paths: list[str] = []
    out_path: str | None = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            stderr.write(_MERGE_USAGE)
            return EXIT_USAGE
        if a == "-o":
            i += 1
            if i >= len(argv):
                stderr.write(f"{_MERGE_USAGE}\n-o needs a file\n")
                return EXIT_USAGE
            out_path = argv[i]
        elif a.startswith("--out="):
            out_path = a.split("=", 1)[1]
        elif a.startswith("-") and a != "-":
            stderr.write(f"{_MERGE_USAGE}\nInvalid argument: {a}\n")
            return EXIT_USAGE
        else:
            paths.append(a)
        i += 1
    if not paths:
        stderr.write(f"{_MERGE_USAGE}\nError: at least one trace "
                     "file is required\n")
        return EXIT_USAGE
    docs: list[tuple[str, dict]] = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            stderr.write(f"Error: cannot read trace {p}: {e}\n")
            return 1
        if not isinstance(doc, dict) \
                or not isinstance(doc.get("traceEvents"), list):
            stderr.write(f"Error: {p} is not a Chrome trace-event "
                         "document\n")
            return 1
        if trace_anchor(doc) is None:
            stderr.write(f"pwasm: warning: {p} carries no wall-clock "
                         "anchor (an older trace?); merging on a "
                         "zero anchor — cross-process alignment will "
                         "be wrong\n")
        docs.append((os.path.basename(p), doc))
    merged = merge_traces(docs)
    text = json.dumps(merged)
    if out_path is None:
        stdout.write(text + "\n")
        return 0
    from pwasm_tpu_torch.utils.fsio import write_durable_text
    try:
        write_durable_text(out_path, text)
    except OSError as e:
        stderr.write(f"Error: cannot write {out_path}: {e}\n")
        return 1
    stderr.write(f"pwasm: merged trace written to {out_path}\n")
    return 0
