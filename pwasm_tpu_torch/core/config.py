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
    compile_cache_dir: str = ""     # --compile-cache-dir: where nvcc's
    #                                 kernels and the C++ engine build
    deadline_s: float = 0.0         # --deadline-s: end-to-end wall
    #                                 budget (0 = unbounded); expiry
    #                                 drains at the next batch boundary:
    #                                 resumable ckpt, rc 75
    max_retries: int = 2            # --max-retries: extra attempts of
    #                                 a failed/rejected device batch
    device_deadline: float = 0.0    # --device-deadline: per-attempt wall
    #                                 ceiling in seconds (0 = none)
    inject_faults: str = ""         # --inject-faults: FaultPlan spec
    fallback: str = "fail"          # --fallback: the only policy, abort
    recover: str = "off"            # --recover: the only setting, no
    #                                 re-promotion (nothing is demoted)


# the reference's degradations, which the port does not have: each
# option that asks for one exits 1 with its message
FALLBACK_CPU_REFUSED = (
    "Error: --fallback=cpu moves failed device work to the host, a "
    "degradation pwasm_tpu_torch does not have; --fallback=fail (the "
    "default: abort with a resumable checkpoint) is its only policy\n")
RECOVER_AUTO_REFUSED = (
    "Error: --recover=auto re-promotes device work after a move to the "
    "host, a degradation pwasm_tpu_torch does not have; --recover=off "
    "(the default) is its only setting\n")


def reprobe_refused(knob: str) -> str:
    """The message of ``--reprobe-interval`` / ``--reprobe-max``, the
    schedule of ``--recover=auto``'s re-probes."""
    return (f"Error: --{knob} schedules --recover=auto's re-probes after a "
            "move to the host, a degradation pwasm_tpu_torch does not "
            "have\n")


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
