"""pafreport-compatible command line front end of the port.

Counterpart of ``pwasm_tpu/cli.py`` ``run``/``_main_loop``, reduced to
the default product path: parse the PAF and extract the ``cs`` events
on the host (in the C++ engine, ``native/``), analyze each report batch
with the packed ctx_scan program on the run's device, merge the MSA
progressively in the C++ engine, then count and vote the consensus over
the engine's rendered pileup (the CUDA consensus kernel on
``--device=cuda``) and refine it in the engine.  ``PWASM_NATIVE_MSA=0``
selects the Python MSA engine (``align/msa.py``, which refines the clips
on the device), ``PWASM_NATIVE=0`` every Python engine.  With
``--realign`` each alignment's
gap structure is first replaced by a banded Gotoh re-alignment
(``ops/realign.py``, the CUDA realign kernels on ``--device=cuda``).
``--many2many`` scores every query of a multi-FASTA against every target
(``stream/multicds.py``, the CUDA scores kernels on ``--device=cuda``);
``--m2m-stream`` scores targets that arrive as a stream, a batch at a
time (``surveil/session.py``).
``--shard[=N]`` spreads that device work over a mesh of N CUDA devices
(``parallel/mesh.py``).  ``--stats`` writes the run's counters
(``utils/runstats.py``), ``--profile`` a ``torch.profiler`` trace
(``utils/profiling.py``), and ``--trace-json``, ``--log-json`` and
``--metrics-textfile`` the run's spans, events and metrics (``obs/``).
A positional PAF is read in 1 MiB blocks (``stream/pafstream.py``'s
``BlockLineReader``), byte-identical to a text-mode read;
``--follow[=IDLE_S]`` tails a growing PAF instead (``FollowReader``),
until IDLE_S seconds pass without growth or a drain ends the run.
Every device dispatch runs under the run's one ``BatchSupervisor``
(``resilience/supervisor.py``), which counts and traces it, retries it
on the same device (``--max-retries``), abandons a hung attempt
(``--device-deadline``), re-executes output its guardrails reject,
bisects a batch the card could not allocate, and aborts the run (exit
1, ``--fallback=fail``, the only policy) when that runs out;
``--inject-faults`` arms its deterministic fault injection
(``resilience/faults.py``).  Every ``-o`` run leaves a checkpoint after
each report batch (``<report>.ckpt``, version 2, CRC'd, with the
supervisor's state under ``resilience``), from which ``--resume``
continues a killed run; SIGTERM/SIGINT and ``--deadline-s`` drain the
run at the next batch boundary and exit 75, resumable
(``resilience/lifecycle.py``).
``--result-cache=DIR`` serves a job whose inputs and result-affecting
flags were run before from its stored output bytes, launching nothing,
serves an appended input's cached prefix and runs only its tail, and
stores a clean run's outputs (``service/cache.py``);
``--compile-cache-dir=DIR`` is where nvcc's kernel libraries and the
C++ engine are built (``ops/_build.py::use_build_dir``).
Outputs are byte-identical to the reference's, with these flags on or
off.  ``serve`` starts the warm-pool daemon (``service/daemon.py``),
which runs each job through :func:`run` with its ``warm`` hook;
``submit``, ``stream``, ``svc-stats``, ``metrics``, ``inspect``,
``cache-probe``, ``health`` and ``logs`` are its client verbs
(``service/client.py``), and ``top`` its live view
(``service/top.py``).

Usage:
  python -m pwasm_tpu_torch.cli <paf_with_cg_cs> -r <refseq.fa>
      [-s <summary.txt>] [-o <diff_report.dfa>] [-w <outfile.mfa>]
      [--ace=FILE] [--info=FILE] [--cons=FILE] [-G|-F] [-C|-N] [-D] [-v]
      [-c <clipmax>] [--motifs=FILE] [--batch=N] [--remove-cons-gaps]
      [--no-refine-clip] [--realign] [--band=N] [--device=cuda|cpu]
      [--shard[=N]] [--skip-bad-lines] [--stats=FILE] [--profile=DIR]
      [--trace-json=FILE] [--trace-max-events=N] [--log-json=FILE|-]
      [--log-json-max-bytes=N] [--metrics-textfile=PATH] [--resume]
      [--deadline-s=S] [--max-retries=N] [--device-deadline=S]
      [--inject-faults=SPEC] [--fallback=fail] [--recover=off]
      [--follow[=IDLE_S]] [--result-cache=DIR|off]
      [--result-cache-max-bytes=N] [--compile-cache-dir=DIR]
  python -m pwasm_tpu_torch.cli --many2many <targets.fa> -r <cds_multi.fa>
      [-o <scores.tsv>] [-s <summary.txt>] [--band=N] [--device=cuda|cpu]
      [--stats=FILE] [--deadline-s=S] [--max-retries=N] [--fallback=fail]
      [--result-cache=DIR|off] [--result-cache-max-bytes=N]
      [--compile-cache-dir=DIR]
  python -m pwasm_tpu_torch.cli --m2m-stream [<targets.fa>]
      -r <cds_multi.fa> [the options of --many2many]
  python -m pwasm_tpu_torch.cli trace-merge FILE.json [FILE.json ...]
      [-o OUT.json]
  python -m pwasm_tpu_torch.cli serve --socket=PATH [options]
  python -m pwasm_tpu_torch.cli submit|stream|svc-stats|metrics|inspect|
      cache-probe|health|logs|top --socket=PATH [options] [--] [job args]
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import ExitStack, contextmanager

from pwasm_tpu_torch.core.config import (AUTO_FULLGENOME_FASTA_BYTES,
                                         FALLBACK_CPU_REFUSED,
                                         RECOVER_AUTO_REFUSED, Config,
                                         deadline_seconds, load_motifs,
                                         reprobe_refused)
from pwasm_tpu_torch.core.dna import revcomp
from pwasm_tpu_torch.core.errors import (EXIT_PREEMPTED, EXIT_USAGE,
                                         PwasmError)
from pwasm_tpu_torch.core.events import extract_alignment
from pwasm_tpu_torch.core.fasta import FastaFile
from pwasm_tpu_torch.core.paf import _atoi, parse_paf_line
from pwasm_tpu_torch.obs import NULL_OBS
from pwasm_tpu_torch.report.diff_report import Summary
from pwasm_tpu_torch.resilience.lifecycle import PreemptedError, SignalDrain
from pwasm_tpu_torch.utils.runstats import RunStats

USAGE = """Usage:
 pafreport <paf_with_cg_cs> -r <refseq.fa> [-s <summary.txt>]
    [-o <diff_report.dfa>][-w <outfile.mfa>] [-G|-F] [-C|-N]
    [--device=cuda|cpu] [--band=N] [--batch=N] [--motifs=FILE]
    [--shard[=N]]

   <paf_with_cg_cs> is the input PAF file with high quality query sequence(s)
      aligned to many target sequences using minimap2 --cs
   -r provide the fasta file with query sequence(s) (required)
   -o write difference data for each alignment into <diff_report.dfa>
   -s write event summary counts into <summary.txt>
   -w write MSA as multifasta into <outfile.mfa>
   -G gene CDS analysis mode (default for query<100K; assumes -C)
   -F full genome alignment mode (default for query>100Kb; assumes -N)
   -C perform codon impact analysis
   -N skip codon impact analysis
   -c <clipmax> maximum clipping, in bases or as a percentage (N%)
   -D debug output (MSA layout on stderr); -v verbose
   --realign   replace each alignment's PAF gap structure with a banded
               affine-gap DP re-alignment (device traceback) before MSA
               construction; requires an MSA output (-w/--ace/--info/--cons)
   --band=N    first band width of the --realign DP (default 64; lanes
               the band misses retry at 4x wider bands up to 4096)
   --ace=FILE  write the refined MSA as an ACE contig (consensus calling)
   --info=FILE write the refined MSA as a contig-info table (per-seq pid)
   --cons=FILE write the consensus sequence as FASTA
   --remove-cons-gaps  drop all-gap consensus columns during refinement
   --no-refine-clip    skip the X-drop clipping refinement pass
   --motifs=FILE  methylation-motif table, one motif per line
   --batch=N   alignments per device report batch (default 256)
   --device=cuda|cpu  where the device programs run (default cuda; the
               CPU runs only when asked for)
   --shard[=N]    (with --device=cuda) shard the device work over a mesh
               of N CUDA devices (default: all visible): the analysis
               batch and the re-alignment lanes spread over the mesh,
               and the consensus pileup's depth shards' counts are
               summed before the vote
   --skip-bad-lines    warn and continue on malformed PAF lines
   --follow[=IDLE_S]  tail the input PAF as a writer appends to it (a
               minimap2 run writing into a file): records are reported
               as they arrive, in the batches a whole-file run makes,
               to the same bytes.  With IDLE_S the stream ends once the
               file has not grown for IDLE_S seconds; a bare --follow
               runs until SIGTERM/SIGINT or --deadline-s drains it
               (exit 75, resumable with --resume on the completed
               file).  Needs an input file (stdin already streams)
   --resume    append to an existing -o report, skipping alignments
               already emitted (a -s summary then covers only the
               resumed portion); every -o run leaves an atomic
               batch-granular checkpoint (<report>.ckpt, versioned and
               CRC-validated), so a killed run resumes at the last
               completed batch exactly; a checkpoint that fails
               verification is quarantined to <report>.ckpt.bad and
               the run restarts cleanly.  SIGTERM/SIGINT drain
               gracefully: the in-flight batches complete, a final
               checkpoint lands, and the run exits 75 ("preempted,
               resumable"; a second signal hard-aborts)
   --deadline-s=S  end-to-end wall budget for the whole run: when it
               expires the run stops at its next batch boundary with
               a valid resumable checkpoint and exits 75 (reason
               "deadline_exceeded")
   --profile=DIR  write a torch.profiler Chrome trace of the run
               (DIR/trace.json: host ops, and the card's kernels and
               copies on --device=cuda)
   --stats=FILE   write run statistics as one JSON object
   --trace-json=FILE  write host-side phase/batch spans (monotonic
               clock) as Chrome trace-event JSON, viewable in
               chrome://tracing / Perfetto beside the --profile trace
   --log-json=FILE|-  append structured NDJSON run-lifecycle events
               with wall+monotonic timestamps and a run id; "-"
               streams to stdout (requires -o so events never share
               the report stream)
   --log-json-max-bytes=N  rotate the --log-json file once it passes
               N bytes (the current file moves to FILE.1, one
               generation kept; a log_rotate event opens the fresh file)
   --trace-max-events=N  cap the --trace-json recorder at N events
               (default 200000); drops are counted in
               pwasm_trace_events_dropped_total and in the trace's
               otherData
   --metrics-textfile=PATH  write the run's metrics as Prometheus
               text exposition at end of run (atomic publish) for a
               node-exporter textfile collector
   --max-retries=N    re-execute a failed/rejected device batch up to
               N times on the same device (exponential backoff +
               jitter; default 2)
   --device-deadline=S  per-batch device deadline in seconds: a hung
               attempt is abandoned and retried (default: none)
   --fallback=fail  what exhausted retries do: abort the run (exit 1)
               with a valid checkpoint; the only policy (device work
               never moves to the host)
   --recover=off  the only setting (nothing is moved to the host, so
               nothing is re-promoted)
   --inject-faults=SPEC  debug: deterministic seeded fault injection
               into supervised device calls, e.g.
               seed=7,rate=0.3,kinds=raise+hang+nan+corrupt
               a scripted outage window down=A-B[+C-D], a scripted
               preemption preempt=N (graceful drain at supervised
               call N), a simulated memory ceiling oom=N, or a kill at
               supervised attempt K, kill=K
               (see pwasm_tpu_torch/resilience/faults.py for the spec)
   --result-cache=DIR|off  content-addressed result cache: a completed
               run's output files are stored under sha256(ref-FASTA
               digest, input digest, result-affecting flags, output
               kinds), and an identical later run (argv order and
               output paths aside) is served the stored bytes instead
               of re-running, with no kernel launched.  CRC-verified on
               every serve (rot = miss); an appended input serves the
               cached prefix and runs only the tail.  --batch is keyed
               under --realign (one band a dispatch).
               --resume/--follow/--inject-faults and unknown flags
               bypass it
   --result-cache-max-bytes=N  evict least-recently-used cache
               entries past N total bytes
   --compile-cache-dir=DIR  where the CUDA kernels (nvcc) and the C++
               engine (g++) are built and found: a later process on the
               same DIR builds nothing (default pwasm_tpu_torch/_build;
               a served job builds in its daemon's)

 pafreport --many2many <targets.fa> -r <cds_multi.fa> [-o <scores.tsv>]
    [-s <summary.txt>] [--band=N] [--device=cuda|cpu] [--stats=FILE] [-v]
    [--deadline-s=S] [--max-retries=N] [--fallback=fail]
    [--result-cache=DIR|off] [--result-cache-max-bytes=N]
    [--compile-cache-dir=DIR]
   score every query of the -r FASTA against every target of
   <targets.fa> (banded affine-gap DP); one report section per query,
   cached a section at a time under --result-cache

 pafreport --m2m-stream [<targets.fa>] -r <cds_multi.fa> [the options
    of --many2many]
   continuous many2many: the targets arrive as a stream (over the
   daemon's stream verbs, or read from <targets.fa> as one) and score
   in arrival batches against the resident -r queries; each batch
   dispatches only the (query, target) pairs the section cache has
   never scored.  The report equals --many2many's over the same
   targets in arrival order

 pafreport trace-merge FILE.json [FILE.json ...] [-o OUT.json]
   merge --trace-json documents onto one wall-anchored timeline

 pafreport serve --socket=PATH [options]
   the warm-pool daemon: jobs run through this same CLI in one resident
   process (serve -h lists its options)
 pafreport submit|stream|svc-stats|metrics|inspect|cache-probe|health|
    logs --socket=PATH ...
   its client verbs (submit -h lists them)
 pafreport top --socket=PATH [--interval=S] [--once]
   a live view of the daemon's svc-stats, its alerts pane first

 pafreport route --backends=TARGET[,TARGET...] --socket=PATH [options]
   the fleet router: serve daemons (unix sockets and/or HOST:PORT)
   behind one submit surface, with least-loaded placement, a fleet-wide
   fair share and journal-aware failover (route -h lists its options)
"""

# reference optstring "DGFCNvd:p:r:o:m:w:c:s:" minus the value flags the
# reference never reads (-d/-p/-m)
_BOOL_FLAGS = set("DGFCNvh")
_VALUE_FLAGS = set("rowcs")
_LONG_FLAGS = ("ace", "info", "cons", "motifs", "batch", "band", "realign",
               "remove-cons-gaps", "no-refine-clip", "device", "shard",
               "skip-bad-lines", "profile", "stats", "trace-json",
               "trace-max-events", "log-json", "log-json-max-bytes",
               "metrics-textfile", "resume", "deadline-s", "max-retries",
               "device-deadline", "inject-faults", "fallback", "recover",
               "reprobe-interval", "reprobe-max", "follow",
               "result-cache", "result-cache-max-bytes",
               "compile-cache-dir")

# subcommands of the reference that a later slice of the port brings,
# each naming its slice (ROADMAP.md queue A; none is left — the route
# flags still to come are fleet/router.py's _LATER_ROUTE)
_LATER_CMDS: dict[str, str] = {}
# the reference's subcommands, dispatched on the first argv token (a
# served job may name none of them)
_SERVICE_CMDS = ("serve", "submit", "svc-stats", "metrics", "stream",
                 "inspect", "top", "trace-merge", "route", "health",
                 "logs", "cache-probe")


class CliError(PwasmError):
    exit_code = EXIT_USAGE


def _parse_args(argv: list[str]) -> tuple[dict, list[str]]:
    """GArgs-style parser: single-letter flags (joined or separated values)
    plus --long=value options."""
    opts: dict[str, str | bool] = {}
    positional: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
                opts[k] = v
            else:
                opts[a[2:]] = True
        elif a.startswith("-") and len(a) > 1:
            j = 1
            while j < len(a):
                ch = a[j]
                if ch in _BOOL_FLAGS:
                    opts[ch] = True
                    j += 1
                elif ch in _VALUE_FLAGS:
                    if j + 1 < len(a):
                        opts[ch] = a[j + 1:]
                    else:
                        i += 1
                        if i >= len(argv):
                            raise CliError(
                                f"{USAGE}\nInvalid argument: -{ch}\n")
                        opts[ch] = argv[i]
                    j = len(a)
                else:
                    raise CliError(f"{USAGE}\nInvalid argument: {a}\n")
        else:
            positional.append(a)
        i += 1
    return opts, positional


def _parse_clipmax(s: str, verbose: bool, stderr) -> float:
    """-c parsing (pafreport.cpp:217-240)."""
    ispercent = s.endswith("%")
    if ispercent:
        s = s.rstrip("%")
    c = _atoi(s)  # GStr::asInt has C atoi semantics: "12x" parses as 12
    if c <= 0:
        raise PwasmError(
            f"Error: invalid -c <clipmax> ({c}) option provided (must be "
            "a positive integer)!\n")
    if ispercent and c > 99:
        raise PwasmError(
            f"Error: invalid percent value ({c}) for -c option "
            " (must be an integer between 1 and 99)!\n")
    if ispercent:
        if verbose:
            print(f"Percentual max clipping set to {c}%", file=stderr)
        return float(c) / 100
    if verbose:
        print(f"Max clipping set to {c} bases", file=stderr)
    return float(c)


def _ckpt_path(report_path: str) -> str:
    return report_path + ".ckpt"


# Checkpoint format v2 (self-validating), the reference's byte for
# byte: the payload ({bytes, records} and, from the reference's
# supervisor, {resilience}) with a version tag and a CRC32 over the
# payload's canonical JSON encoding.  _load_checkpoint verifies BOTH
# plus a report-tail boundary check (the recorded byte offset must land
# exactly on a record boundary of the actual report file).  Any failure
# quarantines the ckpt to <report>.ckpt.bad and the run restarts
# cleanly — never resumes onto garbage.  The supervisor's state rides
# under "resilience" (``BatchSupervisor.export_state``, the reference's
# keys), so a checkpoint either package wrote resumes in the other.
CKPT_VERSION = 2
_CKPT_META = ("version", "crc")   # non-payload keys, excluded from CRC


def _ckpt_crc(ck: dict) -> int:
    """CRC32 over the ckpt's payload fields in canonical JSON form
    (``fsio.payload_crc`` — the shared self-validating-state
    checksum)."""
    from pwasm_tpu_torch.utils.fsio import payload_crc

    return payload_crc({k: v for k, v in ck.items()
                        if k not in _CKPT_META})


def _on_record_boundary(report_path: str, nbytes: int) -> bool:
    """True when byte offset ``nbytes`` of the report is a record
    boundary: 0, or preceded by a newline with either EOF or the next
    record's ``>`` header right after (a ckpt whose offset lands
    mid-record describes a prefix that was never durable as claimed)."""
    import os

    try:
        size = os.path.getsize(report_path)
        if nbytes == 0:
            return True
        if nbytes > size:
            return False
        with open(report_path, "rb") as f:
            if f.read(1) != b">":
                return False     # not a report of this tool
            f.seek(nbytes - 1)
            if f.read(1) != b"\n":
                return False
            if nbytes < size and f.read(1) != b">":
                return False
        return True
    except OSError:
        return False


def _load_checkpoint(report_path: str) \
        -> tuple[int, int, dict | None] | str | None:
    """Read and VERIFY the batch-granular resume checkpoint for
    ``report_path``.  Returns ``(bytes, records, resilience_state)``
    when the ckpt is whole (version + CRC verified, offset on a record
    boundary of the actual report); ``None`` when no ckpt file exists
    (the header-scan heuristic applies); or a ``str`` diagnostic when a
    ckpt EXISTS but is torn/corrupt/inconsistent — the caller must
    quarantine it and restart cleanly rather than resume onto
    garbage."""
    import json
    import os

    try:
        with open(_ckpt_path(report_path)) as f:
            raw = f.read()
    except OSError:
        return None
    try:
        ck = json.loads(raw)
        if not isinstance(ck, dict):
            raise ValueError("not an object")
    except ValueError as e:
        return f"unparseable ckpt JSON ({e})"
    if ck.get("version") != CKPT_VERSION:
        return f"ckpt version {ck.get('version')!r} != {CKPT_VERSION}"
    try:
        crc = int(ck["crc"])
        nbytes, nrec = ck["bytes"], ck["records"]
        if not (isinstance(nbytes, int) and isinstance(nrec, int)):
            raise TypeError("bytes/records not ints")
    except (KeyError, TypeError, ValueError) as e:
        return f"malformed ckpt fields ({e})"
    if crc != _ckpt_crc(ck):
        return "ckpt payload CRC mismatch"
    if nbytes < 0 or nrec < 0 or (nbytes == 0) != (nrec == 0):
        return f"inconsistent ckpt counts (bytes={nbytes}, " \
               f"records={nrec})"
    try:
        if nbytes > os.path.getsize(report_path):
            return f"ckpt bytes {nbytes} past the report's " \
                   f"{os.path.getsize(report_path)}"
    except OSError as e:
        return f"report unreadable ({e})"
    if not _on_record_boundary(report_path, nbytes):
        return f"ckpt offset {nbytes} is not a record boundary of " \
               "the report"
    res = ck.get("resilience")
    return nbytes, nrec, res if isinstance(res, dict) else None


def _quarantine_checkpoint(report_path: str, why: str, stderr) -> None:
    """Move a failed-verification ckpt aside to ``<report>.ckpt.bad``
    (preserved for post-mortem, out of every future resume's way) and
    say so loudly."""
    import os

    from pwasm_tpu_torch.utils.fsio import replace_durable

    try:
        replace_durable(_ckpt_path(report_path),
                        _ckpt_path(report_path) + ".bad")
    except OSError:
        try:
            os.unlink(_ckpt_path(report_path))
        except OSError:
            pass
    print(f"Warning: checkpoint failed verification ({why}); "
          f"quarantined to {_ckpt_path(report_path)}.bad — "
          "restarting the run from scratch instead of resuming onto "
          "a corrupt prefix", file=stderr)


def _write_checkpoint(freport, report_path: str, records: int,
                      res_state: dict | None = None) -> bool:
    """Atomically AND durably persist the report's durable prefix after
    one completed batch: fsync the report, then publish the v2
    (versioned, CRC'd) ckpt JSON via the audited fsync-then-replace
    (``utils.fsio``: tmp write + tmp fsync + rename + parent-dir
    fsync — a crash at any instant leaves the old ckpt or the new one,
    never a torn or empty file that merely *looks* atomic).
    ``res_state`` rides along (the supervisor's breaker, bucket-ceiling
    and fault-clock snapshot) so a ``--resume`` after a kill inherits
    it.  Best-effort — a failed write never stops the run (returns
    False)."""
    import json
    import os

    from pwasm_tpu_torch.utils.fsio import write_durable_text

    try:
        freport.flush()
        os.fsync(freport.fileno())
        size = os.fstat(freport.fileno()).st_size
        ck = {"version": CKPT_VERSION, "bytes": size,
              "records": records}
        if res_state is not None:
            ck["resilience"] = res_state
        ck["crc"] = _ckpt_crc(ck)
        write_durable_text(_ckpt_path(report_path), json.dumps(ck),
                           tmp_suffix=".tmp")
        return True
    except OSError:
        return False


def _unlink_checkpoint(report_path: str) -> None:
    import os

    try:
        os.unlink(_ckpt_path(report_path))
    except OSError:
        pass


def warmup_files(dirpath: str) -> tuple[str, str]:
    """Write the deterministic warmup corpus (``serve --warmup``): a
    120-base query FASTA and a PAF of 16 one-substitution alignments,
    enough to pay the torch import, the CUDA probe and context and the
    ctx_scan program's first run before a daemon's first real job.
    Host-side text only: no torch, no randomness."""
    import os

    from pwasm_tpu_torch.utils.fsio import ensure_private_dir
    ensure_private_dir(dirpath)
    q = "ACGT" * 30                       # 120-base query
    fa = os.path.join(dirpath, "warm.fa")
    with open(fa, "w") as f:
        f.write(f">warmq\n{q}\n")
    lines = []
    for i in range(16):
        p = 10 + 6 * i                    # substitution position
        qb = q[p]
        tb = "ACGT"[("ACGT".index(qb) + 1) % 4]
        cs = f":{p}*{tb.lower()}{qb.lower()}:{len(q) - p - 1}"
        tseq_len = len(q)
        lines.append("\t".join([
            "warmq", str(len(q)), "0", str(len(q)), "+",
            f"warmt{i}", str(tseq_len), "0", str(tseq_len),
            str(len(q)), str(len(q)), "60", "NM:i:1", "AS:i:0",
            f"cg:Z:{len(q)}M", f"cs:Z:{cs}"]))
    paf = os.path.join(dirpath, "warm.paf")
    with open(paf, "w") as f:
        f.write("".join(ln + "\n" for ln in lines))
    return paf, fa


def run(argv: list[str], stdout=None, stderr=None, warm=None,
        input_stream=None, stats: dict | None = None) -> int:
    """One CLI invocation; returns the exit code (1 usage, 3 parse,
    5 zero-coverage column).

    ``warm`` is the warm-pool service hook (the shape of
    ``service.daemon.WarmContext``): a resident serve process passes
    one a job, carrying the job's drain (which replaces the run's own
    ``SignalDrain``), its lane's supervisor state (restored before the
    run, saved after it), its lane's CUDA devices (``lease_devices``),
    and the job's ``trace_id`` and flight recorder.  ``input_stream``
    is the stream-job feed (``stream.pafstream.StreamFeed``), read in
    place of a positional input.  A cold run (both None) behaves
    exactly as before.  ``stats``, when given, is filled with the
    run's stage seconds (``times``), its wall time, the pileup shape of
    the consensus launch and the alignment count (for ``--many2many``:
    see ``stream/multicds.py::many2many_main``)."""
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    opened: list = []
    try:
        return _run(argv, stdout, stderr, stats, opened, warm,
                    input_stream)
    except PwasmError as e:
        stderr.write(str(e))
        return e.exit_code
    finally:
        for fo in opened:
            fo.close()     # no-op for a handle the run already closed


def _open_out(path: str, opened: list, mode: str = "w"):
    try:
        f = open(path, mode)
    except OSError:
        raise PwasmError(f"Cannot open file {path} for writing!\n")
    opened.append(f)
    return f


def _run(argv, stdout, stderr, stats, opened, warm=None,
         input_stream=None) -> int:
    if argv and argv[0] in _SERVICE_CMDS:
        # the client verbs never import torch: a client process stays
        # light
        return _service_main(argv, stdout, stderr)
    from pwasm_tpu_torch.device import resolve_device

    opts, positional = _parse_args(argv)
    if opts.get("h"):
        stderr.write(USAGE + "\n")
        return EXIT_USAGE
    if opts.get("many2many"):
        # the multi-CDS job: every query of the -r FASTA against every
        # target of the positional FASTA (stream/multicds.py)
        from pwasm_tpu_torch.stream.multicds import many2many_main
        return many2many_main(opts, positional, stdout, stderr, stats,
                              warm=warm)
    if opts.get("m2m-stream"):
        # continuous many2many: targets arrive incrementally — over the
        # stream verbs when served (input_stream), from a FASTA read
        # as a stream when cold — and score against the resident -r
        # query set with per-CDS section emission (surveil/)
        from pwasm_tpu_torch.surveil.session import m2m_stream_main
        return m2m_stream_main(opts, positional, stdout, stderr,
                               warm=warm, input_stream=input_stream)
    for k in opts:
        if len(k) > 1 and k not in _LONG_FLAGS:
            raise CliError(f"Error: --{k} is not an option of "
                           "pwasm_tpu_torch\n")
    cfg = Config()
    cfg.debug = bool(opts.get("D"))
    cfg.fullgenome = bool(opts.get("F"))
    gene_cds = bool(opts.get("G"))
    if cfg.fullgenome and gene_cds:
        stderr.write(f"{USAGE} Error: cannot use both -G and -F!\n")
        return EXIT_USAGE
    force_coding = bool(opts.get("C"))
    force_noncoding = bool(opts.get("N"))
    if force_coding and force_noncoding:
        stderr.write(f"{USAGE} Error: cannot use both -N and -C!\n")
        return EXIT_USAGE
    cfg.verbose = bool(opts.get("v")) or cfg.debug
    cfg.gene_cds = gene_cds
    cfg.device = str(opts.get("device", "cuda"))
    for knob in ("band", "batch"):
        if knob in opts:
            val = opts[knob]
            if val is True or not str(val).isascii() \
                    or not str(val).isdigit() or int(val) < 1:
                raise CliError(f"{USAGE}\nInvalid --{knob} value: {val}\n")
            setattr(cfg, knob, int(val))
    for kind in ("motifs", "ace", "info", "cons"):
        if opts.get(kind) is True:
            raise CliError(f"{USAGE}\n--{kind} requires a file argument\n")
    shard = 0                       # --shard: -1 every visible device
    if "shard" in opts:
        val = opts["shard"]
        if val is True:
            shard = -1
        elif str(val).isascii() and str(val).isdigit() and int(val) >= 1:
            shard = int(val)
        else:
            stderr.write(f"{USAGE}\nInvalid --shard value: {val}\n")
            return EXIT_USAGE
        if cfg.device != "cuda":
            stderr.write(f"{USAGE} Error: --shard requires "
                         "--device=cuda!\n")
            return EXIT_USAGE
    _parse_resilience_opts(cfg, opts)
    cfg.realign = bool(opts.get("realign"))
    if cfg.realign and "w" not in opts \
            and not any(k in opts for k in ("ace", "info", "cons")):
        stderr.write(f"{USAGE} Error: --realign requires an MSA output "
                     "(-w, --ace, --info or --cons)!\n")
        return EXIT_USAGE

    infile = positional[0] if positional else None
    if infile == "-":
        infile = None     # the conventional stdin marker
    follow_idle = _follow_idle(opts, infile)
    if "c" in opts:
        cfg.clipmax = _parse_clipmax(str(opts["c"]), cfg.verbose, stderr)
    if "deadline-s" in opts:
        cfg.deadline_s = deadline_seconds(opts["deadline-s"])
        if cfg.deadline_s is None:
            raise CliError(f"{USAGE}\nInvalid --deadline-s value: "
                           f"{opts['deadline-s']}\n")
    _parse_obs_opts(cfg, opts)
    if cfg.device not in ("cuda", "cpu"):
        resolve_device(cfg.device)      # the usage error
    # the result cache (service/cache.py): an exact hit writes the
    # stored outputs and returns here, before the device is probed or
    # a kernel built; an appended input re-arms this run as a --resume
    # over its cached prefix
    cache = _cache_open(opts, positional, stderr,
                        input_stream is not None)
    if cache.hit is not None:
        return _serve_cache_hit(cache.hit, opts, stderr,
                                verbose=bool(opts.get("v")))
    run_stats = RunStats()
    # the job's set-up (the device check, the input, FASTA and output
    # opens, the observability bundle and the drain) is its first stage,
    # timed into the stage table the run's bundle takes over: the sinks
    # the flags ask for open at its end, so a set-up that fails leaves
    # none of their files behind
    from pwasm_tpu_torch.obs import (Observability, StageTable,
                                     make_observability)
    stages = StageTable()
    setup = Observability(flight=getattr(warm, "flight", None),
                          stages=stages).span("setup")
    setup.__enter__()
    device = resolve_device(cfg.device, run_stats)
    # nvcc's libraries and the C++ engine build in the flag's
    # directory, else the package's; a served job in its daemon's
    from pwasm_tpu_torch.ops._build import job_build_dir
    job_build_dir(cfg.compile_cache_dir, warm, stderr)
    inf = sys.stdin
    if input_stream is not None:
        # a served stream job: its records arrive over the socket
        if infile is not None:
            raise PwasmError(
                "Error: a socket-streamed job reads records from the "
                "stream — drop the positional PAF path!\n")
        inf = input_stream
    elif infile:
        import hashlib

        from pwasm_tpu_torch.stream.pafstream import (BlockLineReader,
                                                      FollowReader)
        # with the cache armed, the ingest pass also feeds the content
        # hasher: the insert's key costs no second read of the input
        hasher = hashlib.sha256() if cache.store is not None else None
        if "follow" in opts:
            # --follow[=IDLE_S]: tail the growing file (it may not exist
            # yet: the reader waits for it, as tail -F does)
            inf = FollowReader(infile, idle_timeout_s=follow_idle,
                               hasher=hasher)
        else:
            try:
                inf = BlockLineReader(infile, hasher=hasher)
            except OSError:
                raise PwasmError(f"Cannot open input file {infile}!\n")
        opened.append(inf)
    if "motifs" in opts:
        try:
            cfg.motifs = load_motifs(str(opts["motifs"]))
        except (OSError, UnicodeDecodeError):
            raise PwasmError(f"Cannot open motif file {opts['motifs']}!\n")
    cfg.resume = bool(opts.get("resume"))
    resume_skip, resume_state = 0, None
    if cfg.resume:
        if "o" not in opts:
            raise CliError(f"{USAGE}\n--resume requires -o <report>\n")
        resume_skip, resume_state = _resume_point(str(opts["o"]), stderr)
    elif "o" in opts:
        # a fresh run invalidates any checkpoint left by a killed
        # predecessor writing the same report path
        _unlink_checkpoint(str(opts["o"]))
    freport = _open_out(str(opts["o"]), opened,
                        "a" if cfg.resume else "w") \
        if "o" in opts else stdout
    rpath = opts.get("r")
    if not rpath:
        raise PwasmError("Error: query FASTA file (-r) is required!\n")
    try:
        qfasta = FastaFile(str(rpath))
    except OSError:
        raise PwasmError(f"Error: invalid FASTA file {rpath} !\n")
    fsize = qfasta.file_size()
    if fsize <= 0:
        raise PwasmError(f"Error: invalid FASTA file {rpath} !\n")
    if not cfg.fullgenome and not gene_cds \
            and fsize > AUTO_FULLGENOME_FASTA_BYTES:
        cfg.fullgenome = True
    cfg.skip_codan = cfg.fullgenome or force_noncoding
    if not cfg.skip_codan and not force_coding \
            and fsize > AUTO_FULLGENOME_FASTA_BYTES:
        cfg.skip_codan = True
    fmsa = None
    cons_outs = {}   # kind -> open file, kinds: ace, info, cons
    if "w" in opts or any(k in opts for k in ("ace", "info", "cons")):
        if cfg.fullgenome:
            stderr.write(
                f"{USAGE} Error: can only generate MSA for -G mode!\n")
            return EXIT_USAGE
        if "w" in opts:
            fmsa = _open_out(str(opts["w"]), opened)
        for kind in ("ace", "info", "cons"):
            if kind in opts:
                cons_outs[kind] = _open_out(str(opts[kind]), opened)
    cfg.remove_cons_gaps = bool(opts.get("remove-cons-gaps"))
    cfg.refine_clipping = not bool(opts.get("no-refine-clip"))
    fsummary = _open_out(str(opts["s"]), opened) if "s" in opts else None
    nmsa = None
    if fmsa is not None or cons_outs:
        # the C++ engine merges the MSA and writes it, unless
        # PWASM_NATIVE_MSA=0 or PWASM_NATIVE=0 select the Python engine
        from pwasm_tpu_torch.native import native_msa
        nmsa = native_msa(stream=stderr)
        if nmsa is not None:
            opened.append(nmsa)
    # a served job on a lease runs on its lane's CUDA devices: the
    # lane's first device is this thread's current device for the
    # whole run, and --shard spans exactly the lane
    lane = ExitStack()
    opened.append(lane)
    pool = lane.enter_context(_lane_device_scope(cfg, warm, stderr))
    if pool is not None:
        device = pool[0]
    mesh = _run_mesh(shard, device, stderr, cfg.verbose, pool)
    from pwasm_tpu_torch.utils.profiling import device_trace

    # --trace-json / --log-json / --metrics-textfile: the observability
    # bundle (obs/).  It writes only to its own sinks, never the report
    # stream, so the outputs are the same bytes with the flags on or off
    # a served job carries the daemon-minted trace_id (stamped on every
    # event line as the run id) and its flight recorder (the run's
    # spans accumulate phase walls there); its stage table, the
    # set-up's, is what its --stats, its host and device walls and
    # stats["times"] are read from
    try:
        obs = make_observability(
            cfg.trace_json or None, cfg.log_json or None,
            cfg.metrics_textfile or None, stdout=stdout,
            trace_max_events=cfg.trace_max_events or None,
            log_json_max_bytes=cfg.log_json_max_bytes or None,
            run_id=getattr(warm, "trace_id", None),
            flight=getattr(warm, "flight", None), stages=stages)
    except OSError:
        raise PwasmError(f"Cannot open file {cfg.log_json} for writing!\n")
    if obs.enabled:
        obs.event("run_start", device=cfg.device, argv=list(argv))
    # graceful drain: the first SIGTERM/SIGINT only raises a flag the
    # line loop honors at the next batch boundary; the in-flight
    # batches complete, a final checkpoint and a partial --stats land,
    # and the run exits 75 ("preempted, resumable"); a second signal
    # hard-aborts.  --deadline-s pulls the same flag from a timer.  A
    # served job's drain is the one the daemon made for it: the
    # daemon's own signal handler fans out to these flags
    drain_cm = warm.drain if warm is not None \
        and warm.drain is not None else SignalDrain(stderr=stderr)
    drain_cm.obs = obs   # the drain request is a lifecycle event
    deadline_timer = None
    if cfg.deadline_s:
        deadline_timer = threading.Timer(
            cfg.deadline_s, drain_cm.request,
            args=(f"deadline_exceeded: --deadline-s={cfg.deadline_s:g} "
                  "budget spent",))
        deadline_timer.daemon = True
        deadline_timer.start()
    setup.__exit__(None, None, None)
    try:
        with device_trace(cfg.profile_dir, stderr, device=device.type), \
                drain_cm as drain, obs.span("run", device=cfg.device):
            rc = _main_loop(cfg, mesh, inf, freport, fmsa, fsummary,
                            qfasta, stderr, cons_outs, nmsa,
                            stats if stats is not None else {}, obs,
                            str(opts["o"]) if "o" in opts else None,
                            resume_skip, resume_state, drain, run_stats,
                            warm)
        if rc == 0 and cache.store is not None:
            for fo in opened:
                fo.close()   # every output whole on disk before it is read
            _cache_finish(cache, cfg.stats_path, inf, stderr)
        return rc
    except PwasmError as e:
        stderr.write(str(e))
        if obs.enabled:
            # a failed run ends its timeline too
            obs.event("run_finish", rc=e.exit_code,
                      error=str(e).strip()[:200])
        return e.exit_code
    finally:
        if deadline_timer is not None:
            deadline_timer.cancel()
        drain_cm.obs = NULL_OBS   # a late timer must not write to the
        #                           event log obs.close is closing
        obs.close(stderr)


def _cache_open(opts: dict, positional: list, stderr, streamed: bool):
    """``--result-cache=DIR|off`` and ``--result-cache-max-bytes=N``
    with the reference's usage errors, and the cache lookup of a run
    (reference cli.py:601-702).  Returns a namespace: ``store`` (the
    ``CacheStore``, None when caching is off, bypassed or the
    directory is unusable), ``key`` and ``cls`` (the exact key and the
    classified argv), ``follow_cls`` (a ``--follow`` run classified
    without the flag), ``hit`` (the manifest of an exact hit whose
    outputs are written) and ``delta`` ((records served, records
    total) when the run was re-armed as a ``--resume`` over a cached
    prefix).  An unusable directory warns and runs uncached; a socket
    stream job is never cached."""
    from types import SimpleNamespace

    cache = SimpleNamespace(store=None, key=None, cls=None,
                            follow_cls=None, hit=None, delta=None)
    rc_dir = opts.get("result-cache")
    if rc_dir is True:
        raise CliError(f"{USAGE}\n--result-cache requires a "
                       "directory (or off)\n")
    rc_max = None
    if "result-cache-max-bytes" in opts:
        val = opts["result-cache-max-bytes"]
        if val is True or not str(val).isascii() \
                or not str(val).isdigit() or int(val) < 1:
            raise CliError(
                f"{USAGE}\nInvalid --result-cache-max-bytes value: "
                f"{val}\n")
        rc_max = int(val)
    if not isinstance(rc_dir, str) or not rc_dir or rc_dir == "off" \
            or streamed:
        return cache
    from pwasm_tpu_torch.service.cache import (CacheStore, classify,
                                               derive_key, serve_outputs)
    follow = "follow" in opts
    cache.cls = classify(opts, positional)
    if cache.cls is None and follow:
        # a --follow job bypasses the exact cache (its input is still
        # growing) but re-enters through the DELTA path: classified
        # without the flag, the grown file's prefix may be a cached
        # entry, and a cleanly idle-ended run populates
        cache.follow_cls = classify(
            {k: v for k, v in opts.items() if k != "follow"}, positional)
    if cache.cls is not None:
        cache.key = derive_key(cache.cls)
    if cache.key is None and cache.follow_cls is None:
        return cache
    try:
        cache.store = CacheStore(rc_dir, max_bytes=rc_max)
    except OSError as e:
        print(f"Warning: --result-cache dir {rc_dir} unusable ({e}); "
              "caching disabled", file=stderr)
        return cache
    if cache.key is not None:
        got = cache.store.get(cache.key)
        if got is not None:
            try:
                if serve_outputs(got[1], cache.cls.output_paths):
                    cache.hit = got[0]
                    return cache
            except OSError:
                pass    # unwritable output: the real run reports the
                #         canonical "Cannot open file ..."
    # exact miss: a same-family entry whose input is a per-line PREFIX
    # of ours serves its cached report and re-arms this run as a
    # --resume over it: only the last cached record and the appended
    # tail recompute
    cache.delta = _cache_delta_serve(cache.store,
                                     cache.follow_cls or cache.cls,
                                     allow_equal=follow)
    if cache.delta is not None:
        opts["resume"] = True
        if opts.get("v"):
            served, total = cache.delta
            print(f"pwasm: cache delta hit — {served + 1} of {total} "
                  "input records served from a cached prefix; computing "
                  "the tail", file=stderr)
    return cache


def _cache_finish(cache, stats_path: str, inf, stderr) -> None:
    """A clean run's end with the cache armed (reference cli.py:
    1050-1083): a delta run stamps its ``--stats`` and is accounted
    fractionally; then the outputs are inserted, a ``--follow`` run's
    under its follow-less key once it idle-ended cleanly (a rotation
    voids the ride-along digest and blocks the insert)."""
    if cache.delta is not None:
        _cache_delta_finish(cache.store, stats_path, cache.delta)
    if cache.follow_cls is not None:
        if getattr(inf, "consumed", False) \
                and inf.hexdigest() is not None:
            from pwasm_tpu_torch.service.cache import derive_key
            fkey = derive_key(cache.follow_cls,
                              input_digest=inf.hexdigest())
            if fkey is not None:
                _cache_populate(cache.store, fkey, cache.follow_cls, inf,
                                stats_path, stderr)
    else:
        _cache_populate(cache.store, cache.key, cache.cls, inf,
                        stats_path, stderr)


def _serve_cache_hit(manifest: dict, opts: dict, stderr,
                     verbose: bool = False) -> int:
    """Finish a cache hit: the output files are already written from
    the verified blobs; emit the hit-shaped ``--stats`` (the original
    run's numbers, ``cache_hit: true``, backend zeroed: this serve
    paid no probe) and return 0."""
    from pwasm_tpu_torch.service.cache import write_hit_stats
    if "stats" in opts and opts["stats"] is not True:
        try:
            write_hit_stats(manifest, str(opts["stats"]), strict=True)
        except OSError:
            raise PwasmError(
                f"Cannot open file {opts['stats']} for writing!\n")
    if verbose:
        print("pwasm: result served from cache (byte-identical to a "
              "full run of these inputs+flags)", file=stderr)
    return 0


def _cache_delta_serve(store, cls, allow_equal: bool = False
                       ) -> tuple[int, int] | None:
    """Near-miss delta serve (the CLI's and the daemon's admission):
    on an exact-key miss, look for a same-FAMILY entry whose recorded
    input is a per-line prefix (strict, unless ``allow_equal``) of this
    job's input.  When one exists, its CRC-verified report bytes are
    written to this job's report path, for the caller to re-arm the run
    as a ``--resume`` over them: the resume drops the last cached record
    and skips the rest parse-only, so only that record and the appended
    tail are computed.  Returns ``(records_served, records_total)`` or
    None (a plain miss)."""
    from pwasm_tpu_torch.service.cache import (delta_eligible,
                                               derive_keys,
                                               paf_line_digests)
    if cls is None or not delta_eligible(cls):
        return None
    digests, _fdig = paf_line_digests(cls.input_path)
    if not digests or len(digests) < 2:
        return None
    derived = derive_keys(cls)
    if derived is None:
        return None
    hit = store.delta_lookup(derived[1], digests, allow_equal=allow_equal)
    if hit is None:
        return None
    _key, _manifest, blobs, nl = hit
    report_path = cls.output_paths["o"]
    try:
        with open(report_path, "wb") as f:
            f.write(blobs["o"])
    except OSError:
        return None     # unwritable output: the real run reports the
        #                 canonical "Cannot open file ..." diagnostic
    # a stale checkpoint of an unrelated earlier run on this report
    # path would hijack the checkpoint-first resume
    _unlink_checkpoint(report_path)
    # the resume's header scan re-pays the LAST cached record (nl >= 2)
    return nl - 1, len(digests)


def _cache_delta_finish(store, stats_path: str | None,
                        served_total: tuple[int, int]) -> None:
    """Close out a completed delta run: fold the fractional outcome into
    the store's accounting and stamp the ``--stats`` file
    ``cache_delta: true`` with the served and total record counts
    (never ``cache_hit``: this run probed and computed its tail)."""
    import json

    served, total = served_total
    store.note_delta(served, total)
    if not stats_path:
        return
    try:
        with open(stats_path) as f:
            st = json.load(f)
    except (OSError, ValueError):
        return
    if not isinstance(st, dict):
        return
    st["cache_delta"] = True
    st["cache_records_served"] = int(served)
    st["cache_records_total"] = int(total)
    try:
        with open(stats_path, "w") as f:
            json.dump(st, f, indent=1)
            f.write("\n")
    except OSError:
        pass


def _cache_populate(store, key_hex: str | None, cls, inf,
                    stats_path: str | None, stderr) -> None:
    """Insert a completed run's outputs into the result cache, best
    effort: a failed insert costs the cache, never the job.  The shared
    ``insert_from_paths`` re-derives the key with the ingest reader's
    ride-along digest when there is one (else a fresh digest pass) and
    skips on drift."""
    import json

    from pwasm_tpu_torch.service.cache import insert_from_paths
    if key_hex is None or cls is None:
        return
    input_digest = inf.hexdigest() if getattr(inf, "consumed", False) \
        else None
    stats = None
    if stats_path:
        try:
            with open(stats_path) as f:
                stats = json.load(f)
        except (OSError, ValueError):
            stats = None
    if isinstance(stats, dict):
        # the entry's stats describe the RESULT, not how this run got it
        for k in ("cache_delta", "cache_records_served",
                  "cache_records_total"):
            stats.pop(k, None)
    insert_from_paths(store, key_hex, cls, input_digest=input_digest,
                      stats=stats)


def _resume_point(report_path: str, stderr) -> tuple[int, dict | None]:
    """``--resume``'s preamble (reference cli.py:837-914): the number
    of accepted alignments whose rows the report already holds, with
    the report truncated to exactly their bytes, and the supervisor
    state the checkpoint carries (or None).

    Checkpoint first: a verified ``<report>.ckpt`` names the byte size
    and record count of the last completed batch; any torn tail past it
    is cut.  A checkpoint that exists but fails verification is
    quarantined to ``<report>.ckpt.bad`` and the run restarts from an
    empty report, never half-resumed by the header scan below, which
    applies only when no checkpoint was written: it drops the LAST
    record (its rows may be torn; a header alone does not prove they
    landed), truncates there and skips the surviving headers."""
    from pwasm_tpu_torch.utils.fsio import truncate_durable

    resume_skip, resume_state = 0, None
    ck = _load_checkpoint(report_path)
    if isinstance(ck, str):
        _quarantine_checkpoint(report_path, ck, stderr)
        try:
            truncate_durable(report_path, 0)
        except OSError:
            pass
        return 0, None
    if ck is not None:
        nbytes, resume_skip, resume_state = ck
        try:
            truncate_durable(report_path, nbytes)
        except OSError:
            resume_skip, resume_state = 0, None
    if resume_skip:
        return resume_skip, resume_state
    try:
        # stream in chunks (reports can be GBs): count record headers
        # and remember where the last one starts
        n_headers = 0
        last_header = -1
        size = 0
        prev_byte = b"\n"  # virtual newline before file start
        with open(report_path, "rb") as f:
            starts_ok = f.read(1) == b">"
            f.seek(0)
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                search = prev_byte + chunk
                pos = search.find(b"\n>")
                while pos != -1:
                    n_headers += 1
                    # search[pos] is the byte BEFORE the '>', so the
                    # record starts at file offset size + pos
                    last_header = size + pos
                    pos = search.find(b"\n>", pos + 1)
                prev_byte = chunk[-1:]
                size += len(chunk)
        if starts_ok and n_headers > 0:
            # drop the LAST record: its rows may be torn
            keep = last_header if n_headers > 1 else 0
            resume_skip = n_headers - 1
        else:
            keep, resume_skip = 0, 0   # not a report of this tool
        if keep != size:
            # the dropped torn record must stay dropped across a crash
            truncate_durable(report_path, keep)
    except OSError:
        resume_skip = 0   # nothing emitted yet: a fresh run
    return resume_skip, resume_state


def _follow_idle(opts: dict, infile: str | None) -> float | None:
    """``--follow[=IDLE_S]``'s idle timeout (None: a bare ``--follow``
    or no ``--follow``), checked with the reference's messages
    (reference cli.py:582-600)."""
    import math

    if "follow" not in opts:
        return None
    val, idle = opts["follow"], None
    if val is not True:
        try:
            idle = float(str(val))
            if idle <= 0 or not math.isfinite(idle):
                raise ValueError
        except (TypeError, ValueError):
            raise CliError(f"{USAGE}\nInvalid --follow value: {val}\n")
    if infile is None:
        raise CliError(f"{USAGE}\n--follow requires an input PAF file "
                       "to tail (stdin already streams)\n")
    return idle


def _parse_obs_opts(cfg: Config, opts: dict) -> None:
    """``--skip-bad-lines``, ``--profile``, ``--stats``, the obs
    options and ``--compile-cache-dir`` (reference cli.py:729,
    :808-836)."""
    cfg.skip_bad_lines = bool(opts.get("skip-bad-lines"))
    for kind in ("profile", "stats", "trace-json", "log-json",
                 "metrics-textfile", "compile-cache-dir"):
        if opts.get(kind) is True:
            raise CliError(f"{USAGE}\n--{kind} requires a file argument\n")
    cfg.compile_cache_dir = str(opts.get("compile-cache-dir", ""))
    cfg.profile_dir = str(opts.get("profile", ""))
    cfg.stats_path = str(opts.get("stats", ""))
    cfg.trace_json = str(opts.get("trace-json", ""))
    cfg.log_json = str(opts.get("log-json", ""))
    cfg.metrics_textfile = str(opts.get("metrics-textfile", ""))
    for knob, attr in (("trace-max-events", "trace_max_events"),
                       ("log-json-max-bytes", "log_json_max_bytes")):
        if knob in opts:
            val = opts[knob]
            if val is True or not str(val).isascii() \
                    or not str(val).isdigit() or int(val) < 1:
                raise CliError(f"{USAGE}\nInvalid --{knob} value: {val}\n")
            setattr(cfg, attr, int(val))
    if cfg.log_json == "-" and "o" not in opts:
        # without -o the report itself streams to stdout: event lines
        # interleaved with report rows would corrupt both
        raise CliError(f"{USAGE}\n--log-json=- requires -o <report> "
                       "(stdout already carries the report)\n")


def _parse_resilience_opts(cfg: Config, opts: dict) -> None:
    """``--max-retries``, ``--device-deadline`` and ``--inject-faults``
    with the reference's checks and messages (reference cli.py:731-806);
    ``--fallback`` and ``--recover`` take only the port's one setting,
    and the reference's degradations (``--fallback=cpu``,
    ``--recover=auto``, ``--reprobe-*``) exit 1 naming what they
    are."""
    import math

    if "max-retries" in opts:
        val = opts["max-retries"]
        if val is True or not str(val).isascii() \
                or not str(val).isdigit():
            raise CliError(f"{USAGE}\nInvalid --max-retries value: "
                           f"{val}\n")
        cfg.max_retries = int(val)
    if "device-deadline" in opts:
        try:
            cfg.device_deadline = float(str(opts["device-deadline"]))
            # nan would poison every thread join, inf is no deadline
            if cfg.device_deadline <= 0 \
                    or not math.isfinite(cfg.device_deadline):
                raise ValueError
        except (TypeError, ValueError):
            raise CliError(f"{USAGE}\nInvalid --device-deadline "
                           f"value: {opts['device-deadline']}\n")
    if "fallback" in opts:
        cfg.fallback = str(opts["fallback"])
        if cfg.fallback not in ("cpu", "fail"):
            raise CliError(f"{USAGE}\nInvalid --fallback value: "
                           f"{cfg.fallback} (must be cpu or fail)\n")
        if cfg.fallback == "cpu":
            raise CliError(FALLBACK_CPU_REFUSED)
    if "recover" in opts:
        cfg.recover = str(opts["recover"])
        if cfg.recover not in ("auto", "off"):
            raise CliError(f"{USAGE}\nInvalid --recover value: "
                           f"{cfg.recover} (must be auto or off)\n")
        if cfg.recover == "auto":
            raise CliError(RECOVER_AUTO_REFUSED)
    for knob in ("reprobe-interval", "reprobe-max"):
        if knob in opts:
            raise CliError(reprobe_refused(knob))
    if "inject-faults" in opts:
        if opts["inject-faults"] is True:
            raise CliError(f"{USAGE}\n--inject-faults requires a spec\n")
        cfg.inject_faults = str(opts["inject-faults"])
        from pwasm_tpu_torch.resilience.faults import parse_fault_spec
        try:
            parse_fault_spec(cfg.inject_faults)
        except ValueError as e:
            raise CliError(f"{USAGE}\nInvalid --inject-faults: {e}\n")


def _run_mesh(shard: int, device, stderr, verbose: bool, lane=None):
    """The run's one mesh: with ``--shard[=N]`` over the first N
    devices of the job's lease (``lane``, a served job's) or else of the
    visible CUDA devices (every one for -1), else the 1 x 1 mesh of
    ``device``."""
    from pwasm_tpu_torch.parallel import mesh as pmesh
    if not shard:
        return pmesh.as_mesh(device)
    pool = lane if lane is not None else pmesh.visible_devices()
    want = len(pool) if shard < 0 else shard
    if want > len(pool):
        where = f"the job's device lease holds {len(pool)}" \
            if lane is not None \
            else f"only {len(pool)} devices are visible"
        raise PwasmError(f"Error: --shard={want} but {where}!\n")
    mesh = pmesh.make_mesh(want, devices=pool)
    if verbose:
        print(f"sharding over mesh {dict(mesh.shape)}", file=stderr)
    return mesh


def _service_main(argv: list[str], stdout, stderr) -> int:
    """The subcommands: ``trace-merge``; ``top``; ``serve`` (the daemon);
    ``route`` (the fleet router) and the client verbs."""
    cmd, rest = argv[0], argv[1:]
    if cmd == "trace-merge":
        from pwasm_tpu_torch.obs.merge import trace_merge_main
        return trace_merge_main(rest, stdout, stderr)
    if cmd == "top":
        from pwasm_tpu_torch.service.top import top_main
        return top_main(rest, stdout, stderr)
    if cmd in _LATER_CMDS:
        raise CliError(f"Error: '{cmd}' is not ported to pwasm_tpu_torch "
                       f"yet; it comes with {_LATER_CMDS[cmd]}\n")
    if cmd == "serve":
        from pwasm_tpu_torch.service.daemon import serve_main
        return serve_main(rest, stdout, stderr)
    if cmd == "route":
        from pwasm_tpu_torch.fleet.router import route_main
        return route_main(rest, stdout, stderr)
    from pwasm_tpu_torch.service.client import client_main
    return client_main(cmd, rest, stdout, stderr)


def _lane_devices(warm):
    """The CUDA device-index span ``[lo, hi)`` of a served job's device
    lease, or None for a cold run or a single-lane daemon (the daemon
    exposes the span only when it runs several lanes)."""
    return getattr(warm, "lease_devices", None)


def _lane_device_pool(span, stderr=None, warn: bool = True) -> list:
    """Map a lease's device-index span onto the visible CUDA devices
    (``parallel/mesh.py::visible_devices``; callable only once the
    bounded probe passed).  Clamps when fewer devices exist than the
    lane layout assumes: on a one-card host every lane maps to cuda:0
    and the lease is a plain concurrency token (the bytes do not depend
    on placement).  With more than one device a clamp means the lanes
    (--lanes x --devices-per-job) oversubscribe the cards and share
    one, which is warned on the job's stderr."""
    from pwasm_tpu_torch.parallel.mesh import visible_devices

    devs = visible_devices()
    lo, hi = span
    pool = devs[lo:hi]
    clamped = len(pool) < hi - lo
    if not pool:
        pool = [devs[lo % len(devs)]]
    if warn and clamped and len(devs) > 1:
        print(f"Warning: device lease [{lo},{hi}) exceeds the "
              f"{len(devs)}-device inventory — lane layout "
              "oversubscribes the cards and lanes may share one; "
              "size --lanes*--devices-per-job to the real device "
              "count", file=stderr if stderr is not None
              else sys.stderr)
    return pool


@contextmanager
def _lane_device_scope(cfg: Config, warm, stderr=None):
    """Pin a leased job to its lane: yields the lane's device pool and,
    for the run's extent, makes the pool's first device this thread's
    current CUDA device (``torch.cuda.device``), so two jobs holding
    different leases place their work on different cards.  The current
    device is per host thread, so the daemon's worker threads scope
    independently.  Yields None, and changes nothing, for a cold run, a
    ``--device=cpu`` job or a single-lane daemon.  Entered after the
    bounded probe passed (``resolve_device``).  ``stderr`` is the job's
    own, where the oversubscription warning belongs."""
    span = _lane_devices(warm)
    if span is None or cfg.device != "cuda":
        yield None
        return
    pool = _lane_device_pool(span, stderr)
    if pool[0].type != "cuda":
        yield pool
        return
    import torch

    with torch.cuda.device(pool[0]):
        yield pool


def _native_msa_outputs(nmsa, cfg: Config, mesh, fmsa, cons_outs: dict,
                        stderr, stats: dict, supervisor) -> None:
    """End-of-run MSA outputs of the C++ engine: the ``-D`` layout, the
    unrefined ``-w``, then, for the consensus outputs, the engine's
    rendered pileup counted and voted by the consensus launch on
    the run's ``mesh`` (the CUDA kernel on a CUDA device), the votes
    applied back
    in the engine (``refine_external``, which also runs the X-drop clip
    refinement), and the ace/info/cons writers.  The consensus launch
    is one ``consensus`` dispatch through ``supervisor``, its output
    checked by ``check_consensus``; the supervisor's observability
    bundle times the ``write``, ``consensus`` and ``refine`` stages."""
    import os
    import tempfile

    import numpy as np

    from pwasm_tpu_torch.align.msa import device_counts_votes
    from pwasm_tpu_torch.resilience.guardrails import check_consensus

    obs = supervisor.obs
    with obs.span("write"):
        built = nmsa.count() > 0
        if cfg.debug and built:
            print(f">MSA ({nmsa.count()})", file=stderr)
            fd, tmp = tempfile.mkstemp(prefix="pwasm_layout_")
            os.close(fd)
            try:
                nmsa.write("layout", tmp)
                with open(tmp) as f:
                    stderr.write(f.read())
            finally:
                os.unlink(tmp)
        if fmsa is not None:
            fmsa.close()
            if built:
                nmsa.write("mfa", fmsa.name)
    if not (cons_outs and built):
        return
    with obs.span("consensus") as span:
        nmsa.prepare_device()
        depth, length = nmsa.dims()
        span.args["items"] = depth
        stats["pileup"] = (depth, length)
        pile = np.empty((depth, length), dtype=np.int8)
        nmsa.render_pileup(pile)
        chars, counts = supervisor.run(
            "consensus", lambda: device_counts_votes(pile, mesh),
            validate=lambda r: check_consensus(r[0], r[1], pile))
    with obs.span("refine"):
        nmsa.refine_external(counts, chars, cfg.remove_cons_gaps,
                             cfg.refine_clipping)
    with obs.span("write"):
        contig = nmsa.contig()
        for kind in ("ace", "info", "cons"):
            if kind in cons_outs:
                f = cons_outs[kind]
                f.close()
                nmsa.write(kind, f.name, contig, cfg.remove_cons_gaps,
                           cfg.refine_clipping)


def _python_msa_outputs(ref_msa, cfg: Config, mesh, fmsa,
                        cons_outs: dict, stderr, stats: dict,
                        supervisor) -> None:
    """End-of-run MSA outputs of the Python engine (``align/msa.py``):
    the ``-D`` layout, the unrefined ``-w``, then refine once (the
    consensus launch over ``Msa.pileup_matrix`` over the run's
    ``mesh``, the clip refinement as torch ops there; both dispatches
    through ``supervisor``, whose observability bundle times the
    stages) and the ace/info/cons writers."""
    obs = supervisor.obs
    with obs.span("write"):
        if cfg.debug:
            print(f">MSA ({ref_msa.count()})", file=stderr)
            ref_msa.print_layout(stderr, "v")
        if fmsa is not None:
            ref_msa.write_msa(fmsa)
        if cons_outs:
            ref_msa.finalize()
    if not cons_outs:
        return
    stats["pileup"] = (ref_msa.count(), ref_msa.length)
    ref_msa.refine_msa(remove_cons_gaps=cfg.remove_cons_gaps,
                       refine_clipping=cfg.refine_clipping,
                       device=mesh, supervisor=supervisor)
    with obs.span("write"):
        contig = ref_msa.seqs[0].name if ref_msa.seqs else "contig"
        if "ace" in cons_outs:
            ref_msa.write_ace(cons_outs["ace"], contig)
        if "info" in cons_outs:
            ref_msa.write_info(cons_outs["info"], contig)
        if "cons" in cons_outs:
            ref_msa.write_cons(cons_outs["cons"], contig)


def _main_loop(cfg: Config, mesh, inf, freport, fmsa, fsummary,
               qfasta: FastaFile, stderr, cons_outs: dict, nmsa,
               stats: dict, obs, report_path: str | None,
               resume_skip: int, resume_state: dict | None,
               drain: SignalDrain, run_stats, warm=None) -> int:
    """The per-PAF-line loop (pafreport.cpp:296-460).  ``nmsa`` is the
    C++ MSA engine (``native.NativeMsa``), or None for the Python
    engine (``align/msa.py``).  ``mesh`` is the run's mesh, over which
    the device work spreads (``parallel/mesh.py``): ``--shard``'s, or
    the one device's.  ``obs`` is the run's observability bundle
    (``obs/``) and ``run_stats`` its ``RunStats``: each device dispatch
    goes through the run's one ``BatchSupervisor``, which counts it
    into both and traces it.

    ``report_path`` (``-o``, else None) gets a checkpoint after each
    completed report batch, with the supervisor's state.
    ``resume_skip`` is the number of accepted alignments whose rows the
    report already holds (``--resume``): they are parsed (and, for an
    MSA output, extracted, re-aligned and merged) but not reported
    again; ``resume_state`` is the supervisor state the checkpoint
    carried.  ``drain`` is the run's ``SignalDrain``: a drain requested
    before the end of input (or by ``--inject-faults=preempt=N``) stops
    the line loop at the next line, one requested in the MSA tail
    aborts it, and either way the run returns 75 with its checkpoint
    kept.  ``warm`` (a served job's, else None) carries its lane's
    supervisor state: restored before the checkpoint's, handed back
    at the end for the lane's next job."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.align.gapseq import FLAG_IS_REF, GapSeq
    from pwasm_tpu_torch.align.msa import Msa
    from pwasm_tpu_torch.report.device_report import submit_diff_info_batch
    from pwasm_tpu_torch.resilience.faults import (parse_fault_spec,
                                                   plan_from_env)
    from pwasm_tpu_torch.resilience.supervisor import (BatchSupervisor,
                                                       ResiliencePolicy)

    t_run = time.perf_counter()
    # a --follow reader blocks between records: the drain flag wakes it,
    # so a SIGTERM or --deadline-s ends the line loop at this record
    # boundary instead of waiting out the idle timeout, or forever
    if hasattr(inf, "bind_drain"):
        inf.bind_drain(drain)
    # one supervisor a run: every device round-trip (report batches,
    # --realign dispatches, the consensus and refine launches) goes
    # through it, with the run's fault plan
    fault_plan = parse_fault_spec(cfg.inject_faults) \
        if cfg.inject_faults else plan_from_env()
    if fault_plan is not None:
        print(f"pwasm: fault injection armed (debug): {fault_plan}",
              file=stderr)
        if fault_plan.preempt:
            # preempt=N pulls the same drain flag a SIGTERM sets
            fault_plan.on_preempt = drain.request
    supervisor = BatchSupervisor(
        ResiliencePolicy(max_retries=cfg.max_retries,
                         deadline_s=cfg.device_deadline or None),
        stats=run_stats, stderr=stderr, faults=fault_plan, obs=obs)
    if warm is not None and warm.supervisor_state:
        # a served job inherits its lane's breaker and bucket ceiling
        # from the lane's previous job: an open breaker is not
        # re-discovered (and re-paid) job after job
        supervisor.restore_state(warm.supervisor_state)
    if resume_state is not None:
        # a --resume inherits the killed run's breaker, bucket ceiling
        # and fault clock; restored after the lane's state, because the
        # job's own checkpoint is the more specific fact
        supervisor.restore_state(resume_state)
    summary = Summary() if fsummary is not None else None
    alnpairs: dict[str, int] = {}   # gene-mode (query~target) dedup counts
    ref_cache: dict[str, bytes] = {}
    refseq_id: str | None = None
    refseq: bytes | None = None
    refseq_rc: bytes | None = None
    ref_gseq: GapSeq | None = None  # MSA instance of the current refseq
    ref_msa: Msa | None = None
    numalns = 0
    build_msa_out = fmsa is not None or bool(cons_outs)
    pending: list[tuple] = []   # report rows awaiting the next flush
    # submitted-but-unformatted batches (<= 2), with their record counts
    inflight: list[tuple] = []
    # the engine's inserts awaiting the next batched merge, all of the
    # current query, and their (query~target) keys
    msa_pending: list[tuple] = []
    msa_pending_keys: set[str] = set()
    # parsed records awaiting the next batched native extraction;
    # --skip-bad-lines keeps the one-record path, whose recovery (the
    # dedup slot freed, the warning at the line's place) is per line
    ex_pending: list[tuple] = []
    use_ex_batch = native.enabled() and not cfg.skip_bad_lines

    # per-flush host-stage fold: each completed batch adds the stage
    # deltas to the live counter; the end-of-run fold adds only the
    # residual, so the totals equal the --stats JSON exactly
    host_folded = dict.fromkeys(("parse", "extract", "analyze", "format"),
                                0.0)
    # records whose rows the report holds, the resumed ones included
    emitted = resume_skip

    def sync_host_stages() -> None:
        """``host.extract_s`` and ``analyze_s`` are the ``extract`` and
        ``flush_submit`` spans' seconds, ``format_s`` the
        ``flush_format`` and ``checkpoint`` spans' (``parse_s`` is
        summed a line, where a span would cost more than the parse)."""
        run_stats.host_extract_s = obs.stage_seconds("extract")
        run_stats.host_analyze_s = obs.stage_seconds("flush_submit")
        run_stats.host_format_s = obs.stage_seconds("flush_format") \
            + obs.stage_seconds("checkpoint")

    def fold_host_stages() -> None:
        sync_host_stages()
        for k in host_folded:
            v = getattr(run_stats, f"host_{k}_s")
            d = v - host_folded[k]
            if d > 0:
                obs.count("host_stage_seconds", d, stage=k)
            host_folded[k] = v

    def note_batch_done(nrec: int) -> None:
        """A report batch is written: make the report's prefix durable
        and checkpoint it (every ``-o`` run, as the reference does),
        then fold the host stages, this batch's included."""
        nonlocal emitted
        emitted += nrec
        if report_path is not None:
            with obs.span("checkpoint", n=nrec):
                if _write_checkpoint(freport, report_path, emitted,
                                     supervisor.export_state()):
                    run_stats.res_checkpoints += 1
                    obs.event("ckpt_write", records=emitted, batch=nrec)
        fold_host_stages()

    def flush_pending(drain: bool = False) -> None:
        """Submit the pending report batch, then format the OLDEST
        in-flight batch: batch k's device program runs while batches
        k-1/k-2 are formatted and written.  ``drain`` formats every
        in-flight batch at end of input."""
        if not pending and not inflight:
            return   # nothing buffered
        batch, pending[:] = pending[:], []
        if batch:
            with obs.span("flush_submit", n=len(batch)):
                inflight.append((submit_diff_info_batch(
                    batch, freport, mesh, skip_codan=cfg.skip_codan,
                    motifs=cfg.motifs, summary=summary, stats=run_stats,
                    supervisor=supervisor),
                    len(batch)))
            run_stats.device_batches += 1
        while len(inflight) > (0 if drain else 2):
            fin, nrec = inflight.pop(0)
            try:
                with obs.span("flush_format", n=nrec):
                    fin()
            except BaseException:
                # a failure mid-batch must leave the report a clean
                # prefix of input order (--resume depends on it): drop
                # every batch submitted after it
                inflight.clear()
                raise
            note_batch_done(nrec)

    def drop_msa(key: str, tlabel: str, realigned: bool) -> None:
        """--skip-bad-lines: exclude an alignment the layout cannot hold
        from the MSA.  Its report rows were already emitted, so it counts
        under msa_dropped, not as a skipped line; its freed dedup slot
        lets a later valid alignment of the pair take its place."""
        run_stats.msa_dropped += 1
        src = ("re-aligned gap structure — possible re-aligner "
               "defect" if realigned else "out-of-layout gap "
               "structure in the input")
        print(f"Warning: excluding alignment {tlabel} from the MSA "
              f"({src})", file=stderr)
        alnpairs.pop(key, None)

    def flush_msa_pending() -> None:
        """Merge the buffered alignments into the engine's MSA through
        one ``pw_msa_add_batch`` crossing.  The engine inserts them in
        order; one whose gap structure the layout cannot hold is fatal
        (GapAssem.cpp:105-107), and the error surfaces at this flush,
        or under --skip-bad-lines is dropped from the MSA."""
        if not msa_pending:
            return
        items, msa_pending[:] = msa_pending[:], []
        msa_pending_keys.clear()
        rid, r_len, refseq_b = items[0][:3]

        def on_drop(idx: int, msg: str) -> None:
            if not cfg.skip_bad_lines:
                raise PwasmError(msg)
            drop_msa(*items[idx][4:])

        with obs.span("msa_merge", n=len(items)):
            gap_cols, member_steps = nmsa.add_batch(
                rid, refseq_b, r_len, [it[3] for it in items], on_drop)
            obs.tally(msa_gap_cols=gap_cols, msa_member_steps=member_steps)

    def msa_add(aln, tlabel: str, refseq_b: bytes, ord_num: int,
                realigned: bool = False) -> None:
        """Insert one alignment into the progressive MSA (the per-line
        body of pafreport.cpp:394-421)."""
        nonlocal ref_gseq, ref_msa
        al = aln.alninfo
        key = f"{al.r_id}~{al.t_id}"
        if nmsa is not None:
            msa_pending.append((al.r_id, al.r_len, refseq_b, (
                tlabel, bytes(aln.tseq), al.r_alnstart, aln.reverse,
                aln.rgaps, aln.tgaps, ord_num), key, tlabel, realigned))
            msa_pending_keys.add(key)
            if len(msa_pending) >= cfg.batch:
                flush_msa_pending()
            return
        with obs.span("msa_merge", n=1):
            taseq = GapSeq(tlabel, "", aln.tseq, offset=al.r_alnstart,
                           revcompl=aln.reverse)
            first_ref_aln = ref_gseq is None
            if first_ref_aln:
                rseq = GapSeq(al.r_id, "", refseq_b)
                rseq.set_flag(FLAG_IS_REF)
            else:
                # bare instance of refseq for this alignment
                rseq = GapSeq(al.r_id, "", b"", seqlen=al.r_len)
            # once a gap, always a gap: propagate this alignment's
            # gaps.  rseq/taseq are fresh, so a gap the layout cannot
            # hold (fatal, GapAssem.cpp:105-107) fails before any MSA
            # mutation and is skippable under --skip-bad-lines
            try:
                for g in aln.rgaps:
                    rseq.set_gap(g.pos, g.len)
                for g in aln.tgaps:
                    taseq.set_gap(g.pos, g.len)
            except PwasmError:
                if not cfg.skip_bad_lines:
                    raise
                drop_msa(key, tlabel, realigned)
                return
            newmsa = Msa(rseq, taseq)
            if first_ref_aln:
                newmsa.ordnum = ord_num
                ref_msa = newmsa
                ref_gseq = rseq
            else:
                ref_gseq.msa.add_align(ref_gseq, newmsa, rseq)
                ref_msa = ref_gseq.msa

    # --realign: buffer MSA insertions and re-align each buffered target
    # with the batched banded-DP traceback (ops/realign.py), replacing
    # the PAF's gap structure before the progressive merge.  Insertion
    # order is kept, and the flushes fall where the reference's do (at
    # --batch, at a query change, at the end of input), so every
    # dispatch places its band as the reference's does.
    re_pending: list[tuple] = []

    def flush_realign() -> None:
        if not re_pending:
            return
        from pwasm_tpu_torch.ops.realign import ops_to_gaps, realign_pairs
        items, re_pending[:] = re_pending[:], []
        with obs.span("realign", n=len(items)):
            results = realign_pairs(
                [(q_seg, bytes(aln.tseq))
                 for aln, _t, _r, _o, q_seg in items],
                band=cfg.band, device=mesh, supervisor=supervisor)
        # the traceback's edit ops as the MSA's gap lists
        with obs.span("realign_gaps", n=len(items)):
            gaps = [None if res is None else ops_to_gaps(
                res[1], aln.offset, aln.alninfo.r_len,
                aln.alninfo.t_alnend - aln.alninfo.t_alnstart, aln.reverse)
                for (aln, *_), res in zip(items, results)]
        for (aln, tlabel, refseq_b, ordn, _q), g in zip(items, gaps):
            al = aln.alninfo
            if g is None:  # outside realignment resource bounds:
                # keep the PAF's own gap structure for this alignment
                print(f"Warning: {al.r_id}~{al.t_id} not re-aligned "
                      "(no band up to the escalation ceiling covered "
                      "its optimal path, and it is too large for the "
                      "host oracle); keeping PAF gaps", file=stderr)
            else:
                aln.rgaps, aln.tgaps = g
                run_stats.realigned += 1
            msa_add(aln, tlabel, refseq_b, ordn, realigned=g is not None)

    def consume_aln(rec, aln, refseq_b: bytes, refseq_aln: bytes,
                    ordnum: int) -> None:
        """The body after extraction (run stats, report row, MSA insert),
        shared by the one-record and the batched extraction."""
        al = rec.alninfo
        run_stats.alignments += 1
        run_stats.aligned_bases += al.t_alnend - al.t_alnstart
        run_stats.events += len(aln.tdiffs)
        tlabel = f"{al.t_id}:{al.t_alnstart}-{al.t_alnend}" \
            + ("-" if al.reverse else "+")
        rlabel = al.r_id
        if cfg.fullgenome:
            rlabel += f":{al.r_alnstart}-{al.r_alnend}"
        if len(qfasta) == 1 and not cfg.fullgenome:
            rlabel = ""
        if run_stats.resumed_past < resume_skip:
            # --resume cursor: this alignment's rows are already in the
            # report from the interrupted run
            run_stats.resumed_past += 1
        else:
            pending.append((aln, rlabel, tlabel, refseq_b))
            if len(pending) >= cfg.batch:
                flush_pending()
        if build_msa_out and cfg.realign:
            q_seg = refseq_aln[aln.offset:aln.offset
                               + (al.r_alnend - al.r_alnstart)]
            re_pending.append((aln, tlabel, refseq_b, ordnum, q_seg))
            if len(re_pending) >= cfg.batch:
                flush_realign()
        elif build_msa_out:
            msa_add(aln, tlabel, refseq_b, ordnum)

    def flush_extract() -> None:
        """Extract the buffered records through one native crossing (a
        lone record takes the direct call), then consume each in input
        order; a failed extraction raises after the records before it
        were consumed."""
        if not ex_pending:
            return
        items, ex_pending[:] = ex_pending[:], []
        with obs.span("extract", n=len(items)):
            if len(items) == 1:
                alns, err = [extract_alignment(items[0][0],
                                               items[0][1])], None
            else:
                alns, err = native.extract_batch_native(
                    [it[0] for it in items], [it[1] for it in items])
        for aln, (rec, refseq_aln, refseq_b, ordnum) in zip(alns, items):
            consume_aln(rec, aln, refseq_b, refseq_aln, ordnum)
        if err is not None:
            raise err

    # the parse/extract/flush phase
    with obs.span("input_loop") as loop_span:
        try:
            file_line = 0
            for line in inf:
                if drain.requested:
                    # graceful drain: stop consuming input here; the
                    # finally below completes the in-flight batches and
                    # checkpoints them, and the run exits 75 (the next
                    # --resume continues exactly here)
                    break
                file_line += 1
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                run_stats.lines += 1
                t0 = time.perf_counter()
                try:
                    rec = parse_paf_line(line)
                except PwasmError:
                    if not cfg.skip_bad_lines:
                        raise
                    run_stats.skipped_bad += 1
                    print("Warning: skipping malformed PAF line "
                          f"{file_line}", file=stderr)
                    continue
                finally:
                    run_stats.host_parse_s += time.perf_counter() - t0
                al = rec.alninfo
                if al.r_id == al.t_id:
                    run_stats.skipped_self += 1
                    if cfg.verbose:
                        print("Skipping alignment of qry seq to itself.",
                              file=stderr)
                    continue
                new_pair = None
                if not cfg.fullgenome:
                    # gene CDS mode: first q~t alignment only
                    key = f"{al.r_id}~{al.t_id}"
                    if key in msa_pending_keys:
                        # the engine decides a buffered insert of this
                        # pair (a dropped one frees its slot) before its
                        # duplicate is judged
                        flush_msa_pending()
                    if key in alnpairs:
                        alnpairs[key] += 1
                        run_stats.skipped_dedup += 1
                        if alnpairs[key] == 1:
                            print(f"Warning: alignment {al.r_id} to "
                                  f"{al.t_id} already seen, ignoring ",
                                  file=stderr)
                        continue
                    alnpairs[key] = 0
                    new_pair = key
                numalns += 1
                if not build_msa_out and not cfg.skip_bad_lines \
                        and run_stats.resumed_past < resume_skip:
                    # --resume fast path: this alignment is already in
                    # the report; advance the cursor on parse-level
                    # information alone (no refseq fetch, no extraction).
                    # Not under --skip-bad-lines, where a line that parses
                    # may have been skipped at extraction in the first run
                    run_stats.resumed_past += 1
                    run_stats.alignments += 1
                    run_stats.aligned_bases += al.t_alnend - al.t_alnstart
                    continue
                if refseq_id is None or refseq_id != al.r_id:
                    # consume the buffered extractions, then merge the
                    # buffered re-alignments and inserts into this
                    # query's MSA before the layout state resets
                    flush_extract()
                    flush_realign()
                    flush_msa_pending()
                    if al.r_id in ref_cache:
                        refseq = ref_cache[al.r_id]
                    else:
                        fetched = qfasta.fetch(al.r_id)
                        if fetched is None:
                            raise PwasmError(
                                f"Error: could not retrieve sequence for "
                                f"{al.r_id} !\n")
                        refseq = bytes(fetched).upper()
                        ref_cache[al.r_id] = refseq
                    refseq_rc = revcomp(refseq)
                    refseq_id = al.r_id
                    ref_gseq = None   # a new query starts a new MSA
                    if nmsa is not None:
                        nmsa.reset()
                if al.r_len != len(refseq):
                    raise PwasmError(
                        "Error: ref seq len in this PAF line "
                        f"({al.r_len}) differs from loaded sequence "
                        f"length({len(refseq)})!\n{line}\n")
                refseq_aln = refseq_rc if al.reverse else refseq
                if use_ex_batch:
                    # batched native extraction: this record is extracted
                    # and consumed, in input order, at the next flush
                    ex_pending.append((rec, refseq_aln, refseq, numalns))
                    if len(ex_pending) >= cfg.batch:
                        flush_extract()
                    continue
                try:
                    with obs.span("extract", n=1):
                        aln = extract_alignment(rec, refseq_aln)
                except PwasmError:
                    if not cfg.skip_bad_lines:
                        raise
                    numalns -= 1
                    if new_pair is not None:
                        # a skipped line must not make later valid
                        # alignments of the same (q,t) pair look like
                        # duplicates
                        del alnpairs[new_pair]
                    run_stats.skipped_bad += 1
                    print("Warning: skipping malformed PAF line "
                          f"{file_line}", file=stderr)
                    continue
                consume_aln(rec, aln, refseq, refseq_aln, numalns)
        finally:
            # consume the records buffered for extraction, then emit
            # the buffered rows, also when a later line raises, so the
            # report keeps every earlier alignment
            try:
                flush_extract()
            finally:
                try:
                    flush_pending(drain=True)
                finally:
                    loop_span.args.update(lines=run_stats.lines,
                                          alignments=run_stats.alignments)

    # a drain requested during the final flushes still counts: the
    # batches completed (and were checkpointed) above, and the MSA tail
    # is skipped; the --resume run replays the MSA from the whole input
    preempted = drain.requested
    if not preempted:
        # the tail runs in the drain's interruptible phase: past the
        # line loop there is no batch boundary to drain at, so a drain
        # requested mid-tail aborts it (PreemptedError); --resume
        # rebuilds the tail's outputs whole
        try:
            with drain.interrupting(), obs.span("msa_tail"):
                flush_realign()
                if nmsa is not None:
                    flush_msa_pending()
                    _native_msa_outputs(nmsa, cfg, mesh, fmsa, cons_outs,
                                        stderr, stats, supervisor)
                elif ref_msa is not None:
                    _python_msa_outputs(ref_msa, cfg, mesh, fmsa,
                                        cons_outs, stderr, stats,
                                        supervisor)
        except PreemptedError:
            preempted = True
    if preempted and nmsa is not None:
        nmsa.close()
    if summary is not None:
        # on a preempted run the summary of the batches that completed;
        # a resumed -s covers the resumed portion
        with obs.span("write"):
            summary.write(fsummary)
    if report_path is not None:
        freport.close()
        if not preempted:
            # the report is whole: its checkpoint is obsolete.  A
            # preempted run keeps it: it is what --resume continues from
            _unlink_checkpoint(report_path)
    supervisor.finalize_stats()
    if warm is not None:
        # the end state for the lane's next job, without the fault
        # clock: a scripted fault window is one job's debug contract
        warm.supervisor_state = {
            k: v for k, v in supervisor.export_state().items()
            if k != "fault_calls"}
    run_stats.preempted = preempted
    sync_host_stages()
    # the stage seconds of cli.run's stats, read from the stage table
    times = {"parse_extract": run_stats.host_parse_s
             + run_stats.host_extract_s,
             "ctx_scan": run_stats.host_analyze_s + run_stats.host_format_s}
    for name in ("msa_merge", "consensus", "refine", "write") \
            + (("realign",) if cfg.realign else ()):
        times[name] = obs.stage_seconds(name)
    stats.update(times=times, wall_s=time.perf_counter() - t_run,
                 alignments=numalns, device=str(mesh.devices.flat[0]))
    if cfg.realign:
        stats["realigned"] = run_stats.realigned
    if obs.registry is not None:
        # the metrics are a function of the same --stats schema
        # (obs/catalog.py): fold the finished run in (only the host
        # residual the per-flush folds left) and stamp the breaker
        # gauge (the port has no re-probing monitor); obs.close
        # publishes the textfile
        from pwasm_tpu_torch.obs.catalog import (breaker_state_value,
                                                 fold_run_stats)
        d = run_stats.as_dict()
        d["host"] = {k + "_s": round(max(
            0.0, d["host"][k + "_s"] - host_folded[k]), 6)
            for k in host_folded}
        fold_run_stats(obs.run_metrics, d)
        obs.set_gauge("breaker_state",
                      breaker_state_value(supervisor.breaker_open))
    if cfg.stats_path:
        try:
            with open(cfg.stats_path, "w") as f:
                # the stage table beside the reference's schema: an
                # additive block, so the schema keeps its version
                run_stats.write(f, stages=obs.stages_dict())
        except OSError:
            raise PwasmError(
                f"Cannot open file {cfg.stats_path} for writing!\n")
    if cfg.verbose:
        print(run_stats.brief(), file=stderr)
    if preempted:
        done = f"{emitted} record(s) durable" if report_path \
            else "no -o report (nothing checkpointed)"
        print(f"pwasm: preempted ({drain.reason}) — drained cleanly, "
              f"{done}; rerun with --resume to complete "
              f"(exit {EXIT_PREEMPTED})", file=stderr)
        obs.event("run_finish", rc=EXIT_PREEMPTED, preempted=True,
                  reason=drain.reason, records=emitted,
                  alignments=run_stats.alignments)
        return EXIT_PREEMPTED
    obs.event("run_finish", rc=0, preempted=False,
              alignments=run_stats.alignments, events=run_stats.events,
              wall_s=round(run_stats.wall_s, 3))
    return 0


def main() -> None:
    try:
        rc = run(sys.argv[1:])
    except BrokenPipeError:
        # downstream consumer (e.g. `head`) closed the pipe; exit quietly
        # like the reference binary does on SIGPIPE
        try:
            sys.stdout.close()
        except Exception:
            pass
        rc = 141  # 128 + SIGPIPE, the conventional shell status
    sys.exit(rc)


if __name__ == "__main__":
    main()
