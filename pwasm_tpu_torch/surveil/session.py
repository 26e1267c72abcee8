"""The ``--m2m-stream`` job type: continuous many2many.

Counterpart of ``pwasm_tpu/surveil/session.py``, with its names.  A
resident CDS query set (``-r``) stays loaded while target assemblies
arrive *incrementally* — over the daemon's stream verbs when served
(``input_stream`` is the job's
:class:`~pwasm_tpu_torch.stream.pafstream.StreamFeed`), or from a
target FASTA read as one stream when run cold.  Every arriving target
is scored against every resident query through the same supervised
``many2many`` site the one-shot job uses (the CUDA scores kernels
on ``--device=cuda``), with *incremental per-CDS emission*: each
arrival batch dispatches only the (query, target) pairs the section
cache has never seen — any cached ``(query record, target record,
band)`` score from the family pool splices in verbatim, because
banded-DP scores are pure in the pair — and the final report is
byte-identical to one ``--many2many`` run over the accumulated targets
in arrival order.  The sections it inserts are keyed, and their
target tables encoded, exactly as ``--many2many``'s
(``stream/multicds.py::target_table``), so the two job types hit each
other's entries.

The device is resolved at the first owed dispatch (``resolve_device``,
which raises rather than demote), so a session whose every pair is
reused touches no device.  A served session runs on its lane, over the
lane-span mesh when the lease spans more than one device.

Deadlines follow the report-batch contract: ``--deadline-s`` is
checked at every per-CDS dispatch boundary; on expiry the session
cache-inserts every fully-scored partial section (the cache IS the
resume mechanism), requests the warm drain with a
``deadline_exceeded`` reason, and exits 75.

No torch at module level: the device stack loads at the first
dispatch, exactly like ``stream/multicds.py``.
"""

from __future__ import annotations

from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED, PwasmError
from pwasm_tpu_torch.stream.multicds import (_usage_err, _write,
                                             format_sections,
                                             format_summary, lane_span_mesh,
                                             load_fasta, open_section_store,
                                             parse_m2m_opts, target_table)
from pwasm_tpu_torch.surveil.records import FastaAssembler, parse_record

# targets per dispatch when the stream runs hot (arrivals outpace the
# device): bounds per-batch latency without giving up batching when
# the feed has drained
MAX_ARRIVAL_BATCH = 64


def m2m_stream_main(opts: dict, positional: list, stdout, stderr,
                    warm=None, input_stream=None) -> int:
    import contextlib
    import time
    from types import SimpleNamespace

    from pwasm_tpu_torch.resilience.supervisor import (BatchSupervisor,
                                                       ResiliencePolicy)
    from pwasm_tpu_torch.utils.runstats import RunStats

    cfg = parse_m2m_opts(opts)
    if opts.get("many2many"):
        raise _usage_err("Error: --m2m-stream and --many2many are "
                         "mutually exclusive job types")
    if input_stream is None and len(positional) != 1:
        raise _usage_err("Error: --m2m-stream takes exactly one "
                         "<targets.fa> argument when not served over "
                         "the stream verbs")
    if input_stream is not None and positional:
        raise _usage_err("Error: a served --m2m-stream job takes its "
                         "targets from the stream, not a positional")
    # the C++ engine loads the query FASTA, so the build directory is
    # set first: the flag's, else the package's; a served job's daemon's
    from pwasm_tpu_torch.ops._build import job_build_dir
    job_build_dir(cfg.compile_cache_dir, warm, stderr)
    t0_mono = time.monotonic()

    qnames, qs = load_fasta(cfg.rpath, "-r query")
    stats = RunStats()

    store = open_section_store(cfg.rc_dir, cfg.rc_max, warm, stderr)
    q_digs: list = []
    # the resident family pool: every cached (query record, target
    # record, band) score in the store is a valid splice — the banded
    # DP score is pure in the pair — so an arriving target re-scores
    # only what the store has never seen
    known: list[dict] = [dict() for _ in qs]
    if store is not None:
        from pwasm_tpu_torch.service.cache import (RawJSON,
                                                   m2m_family_key,
                                                   record_digest,
                                                   section_key)
        q_digs = [record_digest(qn, q) for qn, q in zip(qnames, qs)]
        fams = {m2m_family_key(q_digs[qi], cfg.band): qi
                for qi in range(len(qs))}
        for _key, man in store.m2m_scan():
            fam = man["m2m"].get("family")
            qi = fams.get(fam) if isinstance(fam, str) else None
            rows_man = man["m2m"].get("targets")
            if qi is None or not isinstance(rows_man, list):
                continue
            try:
                for d, s in rows_man:
                    known[qi].setdefault(str(d), int(s))
            except (TypeError, ValueError):
                continue

    supervisor = BatchSupervisor(
        ResiliencePolicy(max_retries=cfg.max_retries), stats=stats,
        stderr=stderr)
    if warm is not None and warm.supervisor_state:
        supervisor.restore_state(warm.supervisor_state)

    # ---- arrival state: targets indexed by GLOBAL arrival order
    tnames: list[str] = []
    ts: list[str] = []
    tlens: list[int] = []
    t_digs: list = []
    rows: list[dict] = [dict() for _ in qs]  # qi -> {gidx: score}
    pending: list[int] = []
    prog = {"resident_queries": len(qs), "targets_in": 0,
            "targets_scored": 0, "targets_reused": 0,
            "pairs_dispatched": 0, "pairs_reused": 0,
            "sections_emitted": 0, "batches": 0, "done": False}

    def publish():
        # live progress for the svc-stats `m2m` block and the top pane
        # (the daemon's _m2m_stats reads it off the feed)
        if input_stream is not None:
            input_stream.m2m_progress = dict(prog)

    state = SimpleNamespace(place=None, preempted=False)
    stack = contextlib.ExitStack()

    def ensure_engine():
        # one device, one lane scope for the whole session, resolved at
        # the FIRST dispatch: an all-reused stream never touches the
        # device at all.  A failed CUDA probe raises (exit 1)
        if state.place is not None:
            return
        from pwasm_tpu_torch.cli import _lane_device_scope
        from pwasm_tpu_torch.device import resolve_device
        device = resolve_device(cfg.device, stats)
        pool = stack.enter_context(_lane_device_scope(
            SimpleNamespace(device=cfg.device), warm, stderr))
        if pool is not None:
            device = pool[0]
        mesh = lane_span_mesh(device, warm, stderr, cfg.verbose)
        state.place = {"mesh": mesh} if mesh is not None \
            else {"device": device}

    def admit(rec_text: str):
        try:
            name, seq = parse_record(rec_text)
        except ValueError as e:
            raise PwasmError(f"Error: {e} (streamed target)!\n")
        seq = seq.upper()
        if not seq:
            raise PwasmError(
                f"Error: could not retrieve sequence for {name} "
                "(target)!\n")
        tnames.append(name)
        ts.append(seq)
        tlens.append(len(seq))
        if store is not None:
            t_digs.append(record_digest(name, seq))
        pending.append(len(tnames) - 1)
        prog["targets_in"] += 1

    def score_batch(batch: list) -> bool:
        """Score one arrival batch; False when the deadline preempts
        mid-batch (whole per-CDS groups stay atomic either way)."""
        need: dict[int, tuple] = {}
        for qi in range(len(qs)):
            if store is not None:
                owed = []
                for i, g in enumerate(batch):
                    got = known[qi].get(t_digs[g])
                    if got is None:
                        owed.append(i)
                    else:
                        rows[qi][g] = got
                owed = tuple(owed)
            else:
                owed = tuple(range(len(batch)))
            if owed:
                need[qi] = owed
        owed_sets = [need.get(qi, ()) for qi in range(len(qs))]
        prog["targets_reused"] += sum(
            1 for i in range(len(batch))
            if all(i not in o for o in owed_sets))
        prog["pairs_reused"] += len(batch) * len(qs) \
            - sum(len(o) for o in owed_sets)
        # queries owing the same targets share one ragged dispatch
        groups: dict[tuple, list] = {}
        for qi, owed in need.items():
            groups.setdefault(owed, []).append(qi)
        from pwasm_tpu_torch.ops.banded_dp import BandPlacementError
        from pwasm_tpu_torch.parallel.many2many import \
            many2many_scores_ragged
        for idxs, qis in groups.items():
            if cfg.deadline_s is not None and \
                    time.monotonic() - t0_mono >= cfg.deadline_s:
                state.preempted = True
                return False
            ensure_engine()
            try:
                scores = many2many_scores_ragged(
                    [qs[qi] for qi in qis],
                    [ts[batch[i]] for i in idxs], band=cfg.band,
                    supervisor=supervisor, **state.place)
            except BandPlacementError as e:    # a band too narrow
                raise PwasmError(f"Error: {e}\n")
            for k, qi in enumerate(qis):
                for j, i in enumerate(idxs):
                    g = batch[i]
                    sc = int(scores[k][j])
                    rows[qi][g] = sc
                    if store is not None:
                        known[qi][t_digs[g]] = sc
            prog["pairs_dispatched"] += len(qis) * len(idxs)
            stats.aligned_bases += sum(
                tlens[batch[i]] for i in idxs) * len(qis)
        prog["targets_scored"] += len(batch)
        prog["batches"] += 1
        publish()
        return True

    def flush_pending() -> bool:
        if not pending:
            return True
        batch = list(pending)
        del pending[:]
        return score_batch(batch)

    asm = FastaAssembler()
    drained_early = False
    try:
        if input_stream is not None:
            publish()
            for line in input_stream:
                for rec in asm.feed(line + "\n"):
                    admit(rec)
                # dispatch boundary: feed drained (the arrival batch
                # is whatever accumulated) or the hot-stream cap hit
                if pending and (input_stream.buffered == 0
                                or len(pending) >= MAX_ARRIVAL_BATCH):
                    if not flush_pending():
                        break
                publish()
            drain = input_stream._drain
            if drain is not None and drain.requested \
                    and not input_stream.ended:
                drained_early = True    # idle/drain preemption: the
                #   stream path's resumable-75 contract
        else:
            try:
                with open(str(positional[0]), "r", encoding="utf-8",
                          errors="replace") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        for rec in asm.feed(chunk):
                            admit(rec)
                        if len(pending) >= MAX_ARRIVAL_BATCH:
                            if not flush_pending():
                                break
            except OSError:
                raise PwasmError(
                    f"Error: invalid FASTA file {positional[0]} !\n")
        if not state.preempted and not drained_early:
            for rec in asm.finish():
                admit(rec)
            flush_pending()
        if input_stream is None and not tnames:
            raise PwasmError(
                f"Error: invalid FASTA file {positional[0]} !\n")
    finally:
        stack.close()

    # the counters describe the work this run did: only dispatched
    # pairs count as alignments; family-pool splices ride in as bytes
    stats.lines = prog["pairs_dispatched"]
    stats.alignments = prog["pairs_dispatched"]

    from pwasm_tpu_torch.ops.banded_dp import NEG

    def insert_sections(final: bool) -> None:
        # cache insert at per-CDS granularity over whatever subset of
        # targets each query has fully scored: the entry's key is
        # EXACTLY the one-shot section key for that target (sub)set,
        # and its target table (--many2many's encoding) donates every
        # (digest, score) pair to future sessions — this is both the
        # incremental skip pool and the deadline resume mechanism
        if store is None:
            return
        import hashlib

        tables: dict[tuple, tuple] = {}
        for qi in range(len(qs)):
            gs = tuple(sorted(rows[qi]))
            if not gs or (final and len(gs) != len(tnames)):
                continue
            if gs not in tables:
                th = hashlib.sha256()
                for g in gs:
                    th.update(t_digs[g].encode())
                tables[gs] = (th.hexdigest(),
                              target_table([t_digs[g] for g in gs]))
            tdig, table = tables[gs]
            row = [rows[qi][g] for g in gs]
            sec = format_sections(
                [qnames[qi]], [len(qs[qi])], [tnames[g] for g in gs],
                [tlens[g] for g in gs], [row], NEG).encode("utf-8")
            sm = format_summary(
                [qnames[qi]], [tnames[g] for g in gs], [row],
                NEG).encode("utf-8")
            store.insert(section_key(q_digs[qi], tdig, cfg.band),
                         {"o": sec, "s": sm},
                         extra={"m2m": {
                             "family": m2m_family_key(q_digs[qi],
                                                      cfg.band),
                             "targets": RawJSON(table % tuple(row))}})
        if prog["pairs_reused"]:
            store.note_delta(
                prog["pairs_reused"],
                prog["pairs_reused"] + prog["pairs_dispatched"])

    def save_supervisor() -> None:
        supervisor.finalize_stats()
        if warm is not None:
            warm.supervisor_state = {
                k: v for k, v in supervisor.export_state().items()
                if k != "fault_calls"}

    if state.preempted or drained_early:
        stats.preempted = True
        insert_sections(final=False)
        if state.preempted:
            reason = (f"deadline_exceeded: --deadline-s="
                      f"{cfg.deadline_s:g} budget spent")
            drain = getattr(warm, "drain", None) \
                if warm is not None else None
            if drain is not None and not drain.requested:
                drain.request(reason)
        else:
            reason = "stream drained before stream-end"
        print(f"Warning: m2m-stream preempted ({reason}); "
              f"{prog['targets_scored']} of {prog['targets_in']} "
              "target(s) scored"
              + (" and cached — resubmit to continue"
                 if store is not None else ""), file=stderr)
        save_supervisor()
        publish()
        _write_stats(opts, stats, prog)
        return EXIT_PREEMPTED

    if cfg.verbose:
        print(f"m2m-stream: {prog['targets_in']} target(s) in "
              f"{prog['batches']} arrival batch(es), "
              f"{prog['pairs_dispatched']} pair(s) dispatched, "
              f"{prog['pairs_reused']} spliced from the family pool",
              file=stderr)

    sections: list = []
    sums: list = []
    for qi in range(len(qs)):
        row = [rows[qi][g] for g in range(len(tnames))]
        sections.append(format_sections(
            [qnames[qi]], [len(qs[qi])], tnames, tlens, [row],
            NEG).encode("utf-8"))
        sums.append(format_summary([qnames[qi]], tnames, [row],
                                   NEG).encode("utf-8"))
        prog["sections_emitted"] += 1
    insert_sections(final=True)

    body = b"".join(sections)
    if "o" in opts:
        _write(opts["o"], body)
    else:
        stdout.write(body.decode("utf-8"))
    if "s" in opts:
        _write(opts["s"], b"".join(sums))
    save_supervisor()
    prog["done"] = True
    publish()
    _write_stats(opts, stats, prog)
    if cfg.verbose:
        print(stats.brief(), file=stderr)
    return 0


def _write_stats(opts: dict, stats, prog: dict) -> None:
    """The versioned ``--stats`` JSON plus an additive ``m2m`` block
    (``fold_run_stats`` ignores unknown keys by contract) — the
    daemon's m2m fold reads it."""
    if "stats" not in opts:
        return
    import json
    d = stats.as_dict()
    d["m2m"] = {k: v for k, v in prog.items() if k != "done"}
    try:
        with open(str(opts["stats"]), "w") as f:
            json.dump(d, f)
            f.write("\n")
    except OSError:
        raise PwasmError(
            f"Cannot open file {opts['stats']} for writing!\n")
