"""Many-to-many jobs: every CDS of a multi-FASTA against every target.

Counterpart of ``pwasm_tpu/stream/multicds.py``: load both FASTAs,
score every query in the ``-r`` FASTA against every target in the
positional FASTA through ``many2many_scores_ragged`` (queries bucketed
by exact length, targets padded per query bucket), format, and write.
Each dispatch runs under the job's ``BatchSupervisor``
(``--max-retries``; the port's only policy is ``--fallback=fail``),
with no fault plan, as in the reference.  ``--stats`` writes the run's
counters (``utils/runstats.py``): the pairs dispatched as lines and
alignments, and one ``many2many`` dispatch and flush a supervised
attempt.  ``--deadline-s`` is checked at each dispatch boundary: a job
whose budget is spent before a group's scoring call exits 75
(preempted) and writes no report.

``--result-cache=DIR`` (or a served job's daemon directory) caches the
report a SECTION at a time: each query's section is keyed by (its
record, the whole target set, the band), so a job re-scoring cached
CDS plus new ones dispatches only the new ones and splices the stored
sections around them; a section that misses but whose query and band
hold a cached target SUBSET reuses those scores and dispatches only
the new targets (queries owing the same targets share one dispatch).
A job all of whose sections are cached resolves no device and
launches nothing.  A served job runs on its lane; a lane of more than
one device scores over the lane-span 2-D mesh (:func:`lane_span_mesh`).

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
    [--result-cache=DIR|off] [--result-cache-max-bytes=N]
    [--compile-cache-dir=DIR]

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
               before a scoring dispatch exits 75 (preempted)
   --max-retries=N  re-execute a failed/rejected scoring dispatch up
               to N times on the same device (default 2)
   --fallback=fail  what exhausted retries do: abort the job (exit 1),
               the only policy (the host path is never taken)
   --result-cache=DIR  cache the report a CDS section at a time
               (service/cache.py): each section keys on (its query
               record digest, the whole target-set digest, --band), so
               a job re-scoring 9 cached CDS + 1 new one dispatches ONLY
               the new one and splices the byte-identical stored
               sections around it; a superset target set scores only
               the new targets.  A served job under `serve
               --result-cache` inherits the daemon's dir
   --result-cache-max-bytes=N  evict least-recently-used cache
               entries past N total bytes
   --compile-cache-dir=DIR  where the kernels and the C++ engine build
"""


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
    if opts.get("stats") is True:
        raise _usage_err("Error: --stats requires a file argument")
    rc_dir = opts.get("result-cache")
    if rc_dir is True:
        raise _usage_err("Error: --result-cache requires a directory "
                         "(or off)")
    rc_max = None
    if "result-cache-max-bytes" in opts:
        val = opts["result-cache-max-bytes"]
        if val is True or not str(val).isascii() \
                or not str(val).isdigit() or int(val) < 1:
            raise _usage_err("Error: invalid "
                             f"--result-cache-max-bytes value: {val}")
        rc_max = int(val)
    if opts.get("compile-cache-dir") is True:
        raise _usage_err("Error: --compile-cache-dir requires a "
                         "directory")
    return SimpleNamespace(
        rpath=rpath, device=device, band=band, deadline_s=deadline_s,
        max_retries=max_retries, rc_dir=rc_dir, rc_max=rc_max,
        compile_cache_dir=str(opts.get("compile-cache-dir", "")),
        stats_path=str(opts.get("stats", "")),
        verbose=bool(opts.get("v")) or bool(opts.get("D")))


def open_section_store(rc_dir, rc_max, warm, stderr):
    """Resolve and open the per-CDS section cache (the flag first, the
    served job's daemon directory second); None when caching is off or
    the directory is unusable (the reference's warning, and the job runs
    uncached)."""
    if not isinstance(rc_dir, str) or not rc_dir or rc_dir == "off":
        rc_dir = getattr(warm, "result_cache_dir", None) \
            if warm is not None else None
    if not rc_dir:
        return None
    from pwasm_tpu_torch.service.cache import CacheStore
    try:
        return CacheStore(rc_dir, max_bytes=rc_max)
    except OSError as e:
        print(f"Warning: --result-cache dir {rc_dir} unusable "
              f"({e}); caching disabled", file=stderr)
        return None


def lane_span_mesh(device, warm, stderr, verbose: bool = False):
    """A served job whose device lease spans more than one CUDA device
    scores over the whole lane: the 2-D (query x target) tile mesh over
    exactly that span (``parallel/many2many.py::make_mesh2d``).  None
    (the run's one device) for a cold run, a CPU job and a
    single-device lease.  A mesh that cannot be built raises: the
    session is never demoted to one device."""
    if warm is None or device.type != "cuda":
        return None
    from pwasm_tpu_torch.cli import _lane_device_pool, _lane_devices
    span = _lane_devices(warm)
    if not span or span[1] - span[0] <= 1:
        return None
    pool = _lane_device_pool(span, stderr, warn=False)
    if len(pool) <= 1:
        return None
    from pwasm_tpu_torch.parallel.many2many import make_mesh2d
    mesh = make_mesh2d(devices=pool)
    if verbose:
        print(f"many2many: lane-span mesh over {len(pool)} device(s)",
              file=stderr)
    return mesh


def target_rows(tnames, tlens) -> list[str]:
    """Each target's row prefix, ``name\tlength\t``: made once a job,
    shared by every section."""
    return [f"{tn}\t{tl}\t" for tn, tl in zip(tnames, tlens)]


def format_section(qname, qlen, rows, scores, neg) -> str:
    """One query's section over the targets' ``rows`` (``target_rows``):
    it reads only its own score row, so multi-vs-single byte parity holds
    by construction."""
    out = [f">{qname}\t{qlen}\t{len(rows)}\n"]
    out.extend(f"{r}{'.' if s == neg else s}\n"
               for r, s in zip(rows, np.asarray(scores).tolist()))
    return "".join(out)


def target_table(t_digs) -> str:
    """The ``m2m.targets`` manifest member of a job's sections, ``[[
    digest, score], ...]`` in canonical JSON, as a ``%``-template with
    one ``%d`` a target: made once a job, each section's table is
    ``RawJSON(template % tuple(scores))`` (``service/cache.py``; hex
    digests need no JSON escapes and hold no ``%``)."""
    return "[" + ",".join(f'["{d}",%d]' for d in t_digs) + "]"


def format_sections(qnames, qlens, tnames, tlens, scores, neg) -> str:
    """Render the per-CDS report sections."""
    rows = target_rows(tnames, tlens)
    return "".join(format_section(qn, qlens[qi], rows, scores[qi], neg)
                   for qi, qn in enumerate(qnames))


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


def _write(path, body: bytes) -> None:
    try:
        with open(str(path), "wb") as f:
            f.write(body)
    except OSError:
        raise PwasmError(f"Cannot open file {path} for writing!\n")


def _write_stats(cfg, run_stats: RunStats) -> None:
    if cfg.stats_path:
        try:
            with open(cfg.stats_path, "w") as f:
                run_stats.write(f)
        except OSError:
            raise PwasmError(
                f"Cannot open file {cfg.stats_path} for writing!\n")


def _section_cache(store, qnames, qs, tnames, ts, band: int):
    """The section cache's lookups (reference multicds.py:280-352):
    each query's exact section (``section_key``), then, for a query that
    missed, the cached target subset of its family (``m2m_family_key``:
    query and band) that covers the most of this job's targets.
    Returns ``(skeys, q_digs, t_digs, sections, sums, partial)``:
    ``partial`` maps a missed query to its reused ``{target digest:
    score}``."""
    import hashlib

    from pwasm_tpu_torch.service.cache import (m2m_family_key,
                                               record_digest, section_key)
    t_digs = [record_digest(tn, t) for tn, t in zip(tnames, ts)]
    th = hashlib.sha256()
    for d in t_digs:
        th.update(d.encode())
    tdig = th.hexdigest()
    q_digs = [record_digest(qn, q) for qn, q in zip(qnames, qs)]
    skeys = [section_key(qd, tdig, band) for qd in q_digs]
    sections: list = [None] * len(qs)
    sums: list = [None] * len(qs)
    for qi, key in enumerate(skeys):
        got = store.get(key)
        if got is not None and "o" in got[1] and "s" in got[1]:
            sections[qi], sums[qi] = got[1]["o"], got[1]["s"]
    miss = [qi for qi in range(len(qs)) if sections[qi] is None]
    partial: dict[int, dict[str, int]] = {}
    if miss:
        pool: dict[str, list] = {}
        for _key, man in store.m2m_scan():
            fam = man["m2m"].get("family")
            if isinstance(fam, str):
                pool.setdefault(fam, []).append(man)
        cur = set(t_digs)
        distinct = len(cur) == len(t_digs)   # no target record twice
        for qi in miss:
            best = None
            for man in pool.get(m2m_family_key(q_digs[qi], band), ()):
                rows = man["m2m"].get("targets")
                if not isinstance(rows, list):
                    continue
                try:
                    got_map = dict(rows)
                except (TypeError, ValueError):
                    continue
                if not got_map or not got_map.keys() <= cur:
                    continue     # not a subset: nothing to vouch for
                covered = len(got_map) if distinct \
                    else sum(1 for d in t_digs if d in got_map)
                if best is None or covered > best[0]:
                    best = (covered, got_map)
            if best is not None:
                partial[qi] = best[1]
    return skeys, q_digs, t_digs, sections, sums, partial


def many2many_main(opts: dict, positional: list, stdout, stderr,
                   stats: dict | None = None, warm=None) -> int:
    """The ``--many2many`` job (dispatched from ``cli.run``, so the serve
    daemon runs it like any other job, with the warm hook: the lane's
    supervisor state and device lease, the daemon's result-cache and
    build directories).  ``stats``, when given, is filled with the stage
    seconds (``times``: load, bucket, score, format, write), the wall
    time, the dispatch count, the pairs dispatched and the device (None
    when every section came from the cache)."""
    from types import SimpleNamespace

    from pwasm_tpu_torch.ops.banded_dp import NEG, BandPlacementError

    t_run = time.perf_counter()
    cfg = parse_m2m_opts(opts)
    if len(positional) != 1:
        raise _usage_err("Error: --many2many takes exactly one "
                         "<targets.fa> argument")
    run_stats = RunStats()
    # the C++ engine loads the FASTAs, so the build directory is set
    # first: the flag's, else the package's; a served job's daemon's
    from pwasm_tpu_torch.ops._build import job_build_dir
    job_build_dir(cfg.compile_cache_dir, warm, stderr)
    t0_mono = time.monotonic()
    times = dict.fromkeys(("load", "bucket", "score", "format", "write"),
                          0.0)
    t0 = time.perf_counter()
    qnames, qs = load_fasta(cfg.rpath, "-r query")
    tnames, ts = load_fasta(positional[0], "target")
    tlens = [len(t) for t in ts]
    times["load"] = time.perf_counter() - t0

    # the per-CDS section cache: each query's section depends only on
    # (that query record, the target set, the band), so sections cache
    # independently; the flag first (a cold run), the daemon's
    # directory second (a served job)
    store = open_section_store(cfg.rc_dir, cfg.rc_max, warm, stderr)
    skeys = q_digs = t_digs = None
    sections: list = [None] * len(qs)
    sums: list = [None] * len(qs)
    partial: dict[int, dict[str, int]] = {}
    if store is not None:
        skeys, q_digs, t_digs, sections, sums, partial = _section_cache(
            store, qnames, qs, tnames, ts, cfg.band)
    miss = [qi for qi in range(len(qs)) if sections[qi] is None]
    # per-miss target indices still owed to the device: None for every
    # target (no cached subset), else those the subset's ``{target
    # digest: score}`` map lacks
    need: dict[int, tuple | None] = {}
    for qi in miss:
        pm = partial.get(qi)
        need[qi] = None if pm is None \
            else tuple(ti for ti, d in enumerate(t_digs) if d not in pm)
    pairs = sum(len(ts) if need[qi] is None else len(need[qi])
                for qi in miss)
    rows = target_rows(tnames, tlens)
    want_sums = "s" in opts or store is not None
    if store is not None:
        from pwasm_tpu_torch.service.cache import RawJSON, m2m_family_key
        table = target_table(t_digs)

    def finalize(qi, row):
        # one query's section from its whole score row (target order),
        # formatted and cached as soon as it is complete: a preempted
        # job keeps every finished section, and a re-run splices them
        t0 = time.perf_counter()
        sections[qi] = format_section(qnames[qi], len(qs[qi]), rows, row,
                                      NEG).encode("utf-8")
        if want_sums:
            sums[qi] = format_summary([qnames[qi]], tnames, [row],
                                      NEG).encode("utf-8")
        times["format"] += time.perf_counter() - t0
        if store is not None:
            store.insert(skeys[qi], {"o": sections[qi], "s": sums[qi]},
                         extra={"m2m": {
                             "family": m2m_family_key(q_digs[qi],
                                                      cfg.band),
                             "targets": RawJSON(table % tuple(
                                 np.asarray(row).tolist()))}})
            if qi in partial:
                store.note_delta(len(ts) - len(need[qi]), len(ts))

    def spliced(qi, idxs=(), got=()):
        # a query's row from its cached subset, with the scores of the
        # targets ``idxs`` it still owed
        pm = partial[qi]
        row = np.fromiter((pm.get(d, 0) for d in t_digs), np.int64,
                          len(ts))
        row[list(idxs)] = got
        return row

    sc: dict = {}
    done_pairs = done_bases = 0
    preempted = False
    supervisor = device = None
    if pairs:
        # the one device session, resolved only when a pair is owed: an
        # all-hit job probes nothing and launches nothing
        from pwasm_tpu_torch.cli import _lane_device_scope
        from pwasm_tpu_torch.device import resolve_device
        from pwasm_tpu_torch.parallel.many2many import \
            many2many_scores_ragged
        from pwasm_tpu_torch.resilience.supervisor import (
            BatchSupervisor, ResiliencePolicy)

        device = resolve_device(cfg.device, run_stats)
        supervisor = BatchSupervisor(
            ResiliencePolicy(max_retries=cfg.max_retries),
            stats=run_stats, stderr=stderr)
        if warm is not None and warm.supervisor_state:
            supervisor.restore_state(warm.supervisor_state)
        if cfg.verbose:
            note = ""
            if len(miss) < len(qs):
                note += f" ({len(qs) - len(miss)} section(s) from cache)"
            if partial:
                note += (f" ({len(partial)} section(s) spliced from a "
                         "cached target subset)")
            print(f"many2many: {pairs} of {len(qs) * len(ts)} pair(s), "
                  f"band {cfg.band}, one "
                  f"{'device' if device.type == 'cuda' else 'cpu'} "
                  "session" + note, file=stderr)
        # queries owing the same targets share one ragged dispatch: a
        # superset job costs one call for the new targets plus one for
        # any full-miss queries
        groups: dict[tuple | None, list[int]] = {}
        for qi in miss:
            if need[qi] is None or need[qi]:
                groups.setdefault(need[qi], []).append(qi)
        # a served job places its work on its lane, and a lane of more
        # than one device scores over the lane-span mesh
        with _lane_device_scope(SimpleNamespace(device=cfg.device), warm,
                                stderr) as pool:
            if pool is not None:
                device = pool[0]
            mesh = lane_span_mesh(device, warm, stderr, cfg.verbose)
            place = {"mesh": mesh} if mesh is not None \
                else {"device": device}
            for idxs, qis in groups.items():
                tsel = ts if idxs is None else [ts[ti] for ti in idxs]
                # the end-to-end deadline, at each dispatch boundary:
                # never start a group the budget cannot see; every group
                # that finished is cached already
                if cfg.deadline_s is not None \
                        and time.monotonic() - t0_mono >= cfg.deadline_s:
                    preempted = True
                    break
                try:
                    scores = many2many_scores_ragged(
                        [qs[qi] for qi in qis], tsel,
                        band=cfg.band, stats=sc, supervisor=supervisor,
                        **place)
                except BandPlacementError as e:   # a band too narrow
                    raise PwasmError(f"Error: {e}\n")
                for k, qi in enumerate(qis):
                    finalize(qi, scores[k] if idxs is None
                             else spliced(qi, idxs, scores[k]))
                done_pairs += len(qis) * len(tsel)
                done_bases += (sum(tlens) if idxs is None else sum(
                    tlens[ti] for ti in idxs)) * len(qis)
    elif cfg.verbose:
        print(f"many2many: all {len(miss)} missing section(s) spliced "
              "from cached target subsets — no device session" if miss
              else f"many2many: all {len(qs)} section(s) served from the "
              "result cache — no device session", file=stderr)
    times["bucket"] = sc.get("bucket_s", 0.0)
    times["score"] = sc.get("score_s", 0.0)
    if not preempted:
        for qi in miss:
            if sections[qi] is None and need[qi] == ():
                finalize(qi, spliced(qi))   # no device work owed
    # the counters describe the work this run did: cached sections and
    # spliced rows ride in as bytes, not as alignments
    run_stats.lines = run_stats.alignments = done_pairs
    run_stats.aligned_bases = done_bases
    if supervisor is not None:
        supervisor.finalize_stats()
        if warm is not None:
            warm.supervisor_state = {
                k: v for k, v in supervisor.export_state().items()
                if k != "fault_calls"}
    if preempted:
        # the budget ran out before a group's dispatch (reference
        # stream/multicds.py:519-548): the warning, a --stats with
        # ``preempted``, no -o or -s written, exit 75
        run_stats.preempted = True
        reason = (f"deadline_exceeded: --deadline-s={cfg.deadline_s:g} "
                  "budget spent")
        drain = getattr(warm, "drain", None) if warm is not None else None
        if drain is not None and not drain.requested:
            drain.request(reason)
        print(f"Warning: many2many preempted at a per-CDS dispatch "
              f"boundary ({reason}); "
              f"{sum(1 for sec in sections if sec is not None)} of "
              f"{len(qs)} section(s) finished"
              + (" and cached — resubmit to continue"
                 if store is not None else ""), file=stderr)
        _write_stats(cfg, run_stats)
        return EXIT_PREEMPTED
    t0 = time.perf_counter()
    body = b"".join(sections)
    if "o" in opts:
        _write(opts["o"], body)
    else:
        stdout.write(body.decode("utf-8"))
    if "s" in opts:
        _write(opts["s"], b"".join(sums))
    times["write"] = time.perf_counter() - t0
    if stats is not None:
        stats.update(times=times, wall_s=time.perf_counter() - t_run,
                     dispatches=sc.get("dispatches", 0), pairs=done_pairs,
                     device=str(device) if device is not None else None)
    _write_stats(cfg, run_stats)
    if cfg.verbose:
        print(run_stats.brief(), file=stderr)
    return 0
