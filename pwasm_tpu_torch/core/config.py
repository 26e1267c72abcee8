"""Run configuration.

The reference holds these as globals plus two library statics
(pafreport.cpp:30-46, GapAssem.cpp:5-6); here everything is threaded through
one config object.  The methylation-motif table is configurable (the
reference hardcodes it with a TODO to externalize, pafreport.cpp:39-41).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

DEFAULT_MOTIFS = ("CCTGG", "CCAGG", "GATC", "GTAC")

# Gene-CDS vs full-genome auto-selection threshold: query FASTA *file size*
# in bytes (pafreport.cpp:253-262; quirk SURVEY.md §2.5.7).
AUTO_FULLGENOME_FASTA_BYTES = 120000


@dataclass
class Config:
    debug: bool = False
    verbose: bool = False
    fullgenome: bool = False        # -F: keep every query-target alignment
    gene_cds: bool = False          # -G: first alignment per pair only
    skip_codan: bool = False        # -N / auto: skip codon-impact analysis
    remove_cons_gaps: bool = False  # pafreport forces this off (quirk §2.5.8)
    refine_clipping: bool = True    # MSAColumns::refineClipping default
    clipmax: float = 0.0            # -c: absolute bases (>1) or fraction
    motifs: tuple[str, ...] = field(default=DEFAULT_MOTIFS)

    # port knobs (no reference equivalent)
    device: str = "cuda"            # cuda | cpu (the CPU only on request)
    batch: int = 256                # report batch size per device flush
    band: int = 64                  # banded-DP band width
    realign: bool = False           # --realign: DP traceback gaps for MSA
    skip_bad_lines: bool = False    # warn + continue on malformed lines
    resume: bool = False            # append to -o, skipping emitted alns
    profile_dir: str = ""           # --profile: torch.profiler trace dir
    stats_path: str = ""            # --stats: write run-stats JSON here
    trace_json: str = ""            # --trace-json: Chrome trace-event
    #                                 host spans (obs/tracing.py)
    log_json: str = ""              # --log-json: NDJSON run-lifecycle
    #                                 events (obs/events.py); "-" = stdout
    metrics_textfile: str = ""      # --metrics-textfile: Prometheus
    #                                 exposition at end of run
    trace_max_events: int = 0       # --trace-max-events: span-recorder
    #                                 cap (0 = the recorder's default)
    log_json_max_bytes: int = 0     # --log-json-max-bytes: size-capped
    #                                 event-log rotation (0 = never)
    deadline_s: float = 0.0         # --deadline-s: end-to-end wall
    #                                 budget (0 = unbounded); expiry
    #                                 drains at the next batch boundary:
    #                                 resumable ckpt, rc 75


def deadline_seconds(val) -> float | None:
    """``--deadline-s``'s value as seconds when it is a positive, finite
    number, else None; each caller raises its own usage error."""
    try:
        sec = float(str(val))
    except (TypeError, ValueError):
        return None
    return sec if sec > 0 and math.isfinite(sec) else None


def load_motifs(path: str) -> tuple[str, ...]:
    """Load a motif table: one motif per line, '#' comments allowed.
    Motifs are DNA strings, so the file must be ASCII text — opening with
    ``encoding="ascii"`` keeps the native binary's byte-oriented reader
    and this one in exact agreement (both reject non-ASCII content)."""
    from .errors import PwasmError

    out = []
    try:
        with open(path, encoding="ascii") as f:
            for line in f:
                line = line.strip().upper()
                if line and not line.startswith("#"):
                    out.append(line)
    except UnicodeDecodeError as e:
        raise PwasmError(
            f"Error: motif file {path} is not ASCII text ({e})") from e
    return tuple(out)
