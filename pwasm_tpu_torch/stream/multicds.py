"""Many-to-many jobs: every CDS of a multi-FASTA against every target.

Counterpart of ``pwasm_tpu/stream/multicds.py``, reduced to the one-shot
job: load both FASTAs, score every query in the ``-r`` FASTA against
every target in the positional FASTA through one
``many2many_scores_ragged`` call (queries bucketed by exact length,
targets padded per query bucket), format, and write.  Each dispatch
runs under the job's ``BatchSupervisor`` (``--max-retries``; the
port's only policy is ``--fallback=fail``), with no fault plan, as in
the reference.  ``--stats`` writes the run's counters
(``utils/runstats.py``): the pairs as lines and alignments, and one
``many2many`` dispatch and flush a supervised attempt.
``--deadline-s`` is checked at the dispatch boundary: a job whose
budget is spent before its scoring call exits 75 (preempted) and
writes no report.  The result cache and the served jobs come with
later slices.

Output contract: the report is a sequence of per-CDS sections, each
depending only on (that query, the targets) —

.. code-block:: text

    >cds1	1500	200          # query id, query length, target count
    asm000	101442	1423         # target id, target length, score
    ...

— so a multi-CDS job's section bytes are IDENTICAL to N single-CDS runs
of the same job, and the ``-s`` summary (one roll-up line per CDS:
id, targets, best target, best score, score sum) concatenates the same
way.  Scores are the banded affine-gap DP global scores (``NEG`` for
pairs whose end diagonal no band placement covers — rendered as ``.``).
"""

from __future__ import annotations

import time

import numpy as np

from pwasm_tpu_torch.core.config import (FALLBACK_CPU_REFUSED,
                                         deadline_seconds)
from pwasm_tpu_torch.core.errors import (EXIT_PREEMPTED, EXIT_USAGE,
                                         PwasmError)
from pwasm_tpu_torch.utils.runstats import RunStats

M2M_USAGE = """Usage:
 pafreport --many2many <targets.fa> -r <cds_multi.fa> [-o <scores.tsv>]
    [-s <summary.txt>] [--device=cuda|cpu] [--band=N] [--stats=FILE] [-v]
    [--deadline-s=S] [--max-retries=N] [--fallback=fail]

   Score EVERY query in the -r FASTA against EVERY target in
   <targets.fa> (banded affine-gap DP, parallel/many2many.py).  The
   report is one section per CDS (">id\\tlen\\tn_targets" then one
   "target\\tlen\\tscore" row per target, in FASTA order); -s writes one
   roll-up line per CDS (id, targets, best target, best score, score
   sum).  Sections are byte-identical to running each CDS as its own
   job.
   --band=N    band width of the DP (default 64)
   --device=cuda|cpu  where the scoring runs (default cuda; the CPU runs
               only when asked for)
   --stats=FILE   write run statistics as one JSON object
   --deadline-s=S  end-to-end wall budget: a job whose budget runs out
               before its scoring dispatch exits 75 (preempted)
   --max-retries=N  re-execute a failed/rejected scoring dispatch up
               to N times on the same device (default 2)
   --fallback=fail  what exhausted retries do: abort the job (exit 1),
               the only policy (the host path is never taken)
"""

# options of the reference's --many2many that later slices of the port
# bring (ROADMAP.md queue A)
_SERVICE = "the service slice (the result cache and the warm pool)"
_LATER = {
    "result-cache": _SERVICE,
    "result-cache-max-bytes": _SERVICE,
    "compile-cache-dir": _SERVICE,
}


class M2mUsageError(PwasmError):
    exit_code = EXIT_USAGE


def _usage_err(msg: str) -> M2mUsageError:
    return M2mUsageError(f"{M2M_USAGE}\n{msg}\n")


def load_fasta(path, what):
    """Load a FASTA into parallel (names, upper-cased seqs) lists."""
    from pwasm_tpu_torch.core.fasta import FastaFile
    try:
        fa = FastaFile(str(path))
    except (OSError, PwasmError):
        raise PwasmError(
            f"Error: invalid FASTA file {path} !\n")
    if not len(fa):
        raise PwasmError(
            f"Error: invalid FASTA file {path} !\n")
    seqs = []
    for name in fa.names:
        s = fa.fetch(name)
        if not s:
            raise PwasmError(
                f"Error: could not retrieve sequence for {name} "
                f"({what})!\n")
        seqs.append(s.upper())
    return fa.names, seqs


def parse_m2m_opts(opts: dict):
    """Validate the ``--many2many`` options.  Returns a plain namespace;
    raises :class:`M2mUsageError` with the usage text on bad values, and
    a PwasmError (exit 1) naming the later slice for an option of the
    reference the port does not take yet."""
    from types import SimpleNamespace

    for bad, why in (("w", "builds an MSA"), ("ace", "builds an MSA"),
                     ("info", "builds an MSA"), ("cons", "builds an "
                      "MSA"), ("realign", "rewrites PAF gaps"),
                     ("follow", "tails a PAF"), ("resume", "resumes a "
                      "report"), ("shard", "is a report-path knob")):
        if bad in opts:
            raise _usage_err(f"Error: --many2many scores sequences; "
                             f"-{'-' if len(bad) > 1 else ''}{bad} "
                             f"{why} and does not apply")
    rpath = opts.get("r")
    if not rpath or rpath is True:
        raise _usage_err("Error: query FASTA file (-r) is required!")
    device = str(opts.get("device", "cuda"))
    if device not in ("cuda", "cpu"):
        raise _usage_err(f"Error: invalid --device value: {device}")
    band = 64
    if "band" in opts:
        val = opts["band"]
        if val is True or not str(val).isascii() \
                or not str(val).isdigit() or int(val) < 1:
            raise _usage_err(f"Error: invalid --band value: {val}")
        band = int(val)
    max_retries = 2
    if "max-retries" in opts:
        val = opts["max-retries"]
        if val is True or not str(val).isascii() \
                or not str(val).isdigit():
            raise _usage_err(
                f"Error: invalid --max-retries value: {val}")
        max_retries = int(val)
    fallback = str(opts.get("fallback", "fail"))
    if fallback not in ("cpu", "fail"):
        raise _usage_err(f"Error: invalid --fallback value: {fallback}")
    if fallback == "cpu":
        raise PwasmError(FALLBACK_CPU_REFUSED, EXIT_USAGE)
    deadline_s = None
    if "deadline-s" in opts:
        deadline_s = deadline_seconds(opts["deadline-s"])
        if deadline_s is None:
            raise _usage_err(
                f"Error: invalid --deadline-s value: {opts['deadline-s']}")
    for k in opts:
        if k in _LATER:
            raise PwasmError(f"Error: --{k} is not ported to "
                             f"pwasm_tpu_torch yet; it comes with "
                             f"{_LATER[k]}\n", EXIT_USAGE)
    if opts.get("stats") is True:
        raise _usage_err("Error: --stats requires a file argument")
    return SimpleNamespace(
        rpath=rpath, device=device, band=band, deadline_s=deadline_s,
        max_retries=max_retries,
        stats_path=str(opts.get("stats", "")),
        verbose=bool(opts.get("v")) or bool(opts.get("D")))


def format_sections(qnames, qlens, tnames, tlens, scores, neg) -> str:
    """Render the per-CDS report sections.  One query's section reads
    only its own score row, so multi-vs-single byte parity holds by
    construction."""
    rows = [f"{tn}\t{tl}\t" for tn, tl in zip(tnames, tlens)]
    out = []
    for qi, qn in enumerate(qnames):
        out.append(f">{qn}\t{qlens[qi]}\t{len(tnames)}\n")
        out.extend(f"{r}{'.' if s == neg else s}\n"
                   for r, s in zip(rows, np.asarray(scores[qi]).tolist()))
    return "".join(out)


def format_summary(qnames, tnames, scores, neg) -> str:
    """One roll-up line per CDS: ``id  n_targets  best_target
    best_score  score_sum`` (ties break to FASTA order; an all-NEG row
    reports ``.`` — nothing aligned under the band)."""
    out = []
    for qi, qn in enumerate(qnames):
        row = np.asarray(scores[qi], dtype=np.int64)
        live = row != neg
        if live.any():
            bi = int(np.argmax(np.where(live, row, np.iinfo(np.int64).min)))
            out.append(f"{qn}\t{len(tnames)}\t{tnames[bi]}\t{row[bi]}"
                       f"\t{int(row[live].sum())}\n")
        else:
            out.append(f"{qn}\t{len(tnames)}\t.\t.\t0\n")
    return "".join(out)


def _preempted(cfg, n_queries: int, run_stats: RunStats, stderr) -> int:
    """The job's budget ran out before its scoring dispatch (reference
    stream/multicds.py:519-548): the warning, a ``--stats`` with
    ``preempted`` and no pair counted, no ``-o`` or ``-s`` written, exit
    75."""
    reason = (f"deadline_exceeded: --deadline-s={cfg.deadline_s:g} "
              "budget spent")
    print(f"Warning: many2many preempted at a per-CDS dispatch boundary "
          f"({reason}); 0 of {n_queries} section(s) finished",
          file=stderr)
    run_stats.preempted = True
    if cfg.stats_path:
        try:
            with open(cfg.stats_path, "w") as f:
                run_stats.write(f)
        except OSError:
            raise PwasmError(
                f"Cannot open file {cfg.stats_path} for writing!\n")
    return EXIT_PREEMPTED


def _write(path, body: bytes) -> None:
    try:
        with open(str(path), "wb") as f:
            f.write(body)
    except OSError:
        raise PwasmError(f"Cannot open file {path} for writing!\n")


def many2many_main(opts: dict, positional: list, stdout, stderr,
                   stats: dict | None = None) -> int:
    """The ``--many2many`` job (dispatched from ``cli.run``).  ``stats``,
    when given, is filled with the stage seconds (``times``: load,
    bucket, score, format, write), the wall time, the dispatch count,
    the pair count and the device."""
    from pwasm_tpu_torch.device import resolve_device
    from pwasm_tpu_torch.ops.banded_dp import NEG, BandPlacementError
    from pwasm_tpu_torch.parallel.many2many import many2many_scores_ragged
    from pwasm_tpu_torch.resilience.supervisor import (BatchSupervisor,
                                                       ResiliencePolicy)

    t_run = time.perf_counter()
    cfg = parse_m2m_opts(opts)
    if len(positional) != 1:
        raise _usage_err("Error: --many2many takes exactly one "
                         "<targets.fa> argument")
    run_stats = RunStats()
    device = resolve_device(cfg.device, run_stats)
    t0_mono = time.monotonic()
    times = dict.fromkeys(("load", "bucket", "score", "format", "write"),
                          0.0)
    t0 = time.perf_counter()
    qnames, qs = load_fasta(cfg.rpath, "-r query")
    tnames, ts = load_fasta(positional[0], "target")
    tlens = [len(t) for t in ts]
    times["load"] = time.perf_counter() - t0
    pairs = len(qs) * len(ts)
    if cfg.verbose:
        print(f"many2many: {pairs} of {pairs} pair(s), band {cfg.band}, "
              f"one {'device' if device.type == 'cuda' else 'cpu'} "
              "session", file=stderr)
    if cfg.deadline_s is not None \
            and time.monotonic() - t0_mono >= cfg.deadline_s:
        # the end-to-end deadline, enforced at the dispatch boundary:
        # never start a dispatch the budget cannot see
        return _preempted(cfg, len(qs), run_stats, stderr)
    sc: dict = {}
    supervisor = BatchSupervisor(
        ResiliencePolicy(max_retries=cfg.max_retries), stats=run_stats,
        stderr=stderr)
    try:
        scores = many2many_scores_ragged(qs, ts, band=cfg.band,
                                         device=device, stats=sc,
                                         supervisor=supervisor)
    except BandPlacementError as e:   # a band too narrow for a group
        raise PwasmError(f"Error: {e}\n")
    times["bucket"], times["score"] = sc["bucket_s"], sc["score_s"]
    t0 = time.perf_counter()
    body = format_sections(qnames, [len(q) for q in qs], tnames, tlens,
                           scores, NEG).encode("utf-8")
    summary = format_summary(qnames, tnames, scores, NEG).encode("utf-8") \
        if "s" in opts else b""
    times["format"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "o" in opts:
        _write(opts["o"], body)
    else:
        stdout.write(body.decode("utf-8"))
    if "s" in opts:
        _write(opts["s"], summary)
    times["write"] = time.perf_counter() - t0
    if stats is not None:
        stats.update(times=times, wall_s=time.perf_counter() - t_run,
                     dispatches=sc["dispatches"], pairs=pairs,
                     device=str(device))
    # every pair is scored: the lines and alignments are the pairs,
    # events none, aligned bases every target once per query
    run_stats.lines = run_stats.alignments = pairs
    run_stats.aligned_bases = sum(tlens) * len(qs)
    supervisor.finalize_stats()
    if cfg.stats_path:
        try:
            with open(cfg.stats_path, "w") as f:
                run_stats.write(f)
        except OSError:
            raise PwasmError(
                f"Cannot open file {cfg.stats_path} for writing!\n")
    if cfg.verbose:
        print(run_stats.brief(), file=stderr)
    return 0
