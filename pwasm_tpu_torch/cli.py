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
(``stream/multicds.py``, the CUDA scores kernels on ``--device=cuda``).
Outputs are byte-identical to the reference's.

Usage:
  python -m pwasm_tpu_torch.cli <paf_with_cg_cs> -r <refseq.fa>
      [-s <summary.txt>] [-o <diff_report.dfa>] [-w <outfile.mfa>]
      [--ace=FILE] [--info=FILE] [--cons=FILE] [-G|-F] [-C|-N] [-D] [-v]
      [-c <clipmax>] [--motifs=FILE] [--batch=N] [--remove-cons-gaps]
      [--no-refine-clip] [--realign] [--band=N] [--device=cuda|cpu]
  python -m pwasm_tpu_torch.cli --many2many <targets.fa> -r <cds_multi.fa>
      [-o <scores.tsv>] [-s <summary.txt>] [--band=N] [--device=cuda|cpu]
"""

from __future__ import annotations

import sys
import time

from pwasm_tpu_torch.core.config import (AUTO_FULLGENOME_FASTA_BYTES, Config,
                                         load_motifs)
from pwasm_tpu_torch.core.dna import revcomp
from pwasm_tpu_torch.core.errors import EXIT_USAGE, PwasmError
from pwasm_tpu_torch.core.events import extract_alignment
from pwasm_tpu_torch.core.fasta import FastaFile
from pwasm_tpu_torch.core.paf import _atoi, parse_paf_line
from pwasm_tpu_torch.report.diff_report import Summary

USAGE = """Usage:
 pafreport <paf_with_cg_cs> -r <refseq.fa> [-s <summary.txt>]
    [-o <diff_report.dfa>][-w <outfile.mfa>] [-G|-F] [-C|-N]
    [--device=cuda|cpu] [--band=N] [--batch=N] [--motifs=FILE]

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

 pafreport --many2many <targets.fa> -r <cds_multi.fa> [-o <scores.tsv>]
    [-s <summary.txt>] [--band=N] [--device=cuda|cpu] [-v]
   score every query of the -r FASTA against every target of
   <targets.fa> (banded affine-gap DP); one report section per query
"""

# reference optstring "DGFCNvd:p:r:o:m:w:c:s:" minus the value flags the
# reference never reads (-d/-p/-m)
_BOOL_FLAGS = set("DGFCNvh")
_VALUE_FLAGS = set("rowcs")
_LONG_FLAGS = ("ace", "info", "cons", "motifs", "batch", "band", "realign",
               "remove-cons-gaps", "no-refine-clip", "device")

# flags and subcommands of the reference that later slices of the port
# bring (ROADMAP.md queues A and B)
_LATER = {
    "shard": "the multi-GPU slice (--shard)",
}
_LATER_DEFAULT = ("a later slice (resilience, checkpoints and --stats; "
                  "then service, stream, fleet, surveil and obs)")
_SERVICE_CMDS = ("serve", "submit", "svc-stats", "metrics", "stream",
                 "inspect", "top", "trace-merge", "route", "health",
                 "logs")


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


def run(argv: list[str], stdout=None, stderr=None,
        stats: dict | None = None) -> int:
    """One CLI invocation; returns the exit code (1 usage, 3 parse,
    5 zero-coverage column).  ``stats``, when given, is filled with the
    run's stage seconds (``times``), its wall time, the pileup shape of
    the consensus launch and the alignment count (for ``--many2many``:
    see ``stream/multicds.py::many2many_main``)."""
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    opened: list = []
    try:
        return _run(argv, stdout, stderr, stats, opened)
    except PwasmError as e:
        stderr.write(str(e))
        return e.exit_code
    finally:
        for fo in opened:
            fo.close()     # no-op for a handle the run already closed


def _open_out(path: str, opened: list):
    try:
        f = open(path, "w")
    except OSError:
        raise PwasmError(f"Cannot open file {path} for writing!\n")
    opened.append(f)
    return f


def _run(argv, stdout, stderr, stats, opened) -> int:
    from pwasm_tpu_torch.device import resolve_device

    if argv and argv[0] in _SERVICE_CMDS:
        raise CliError(f"Error: '{argv[0]}' is not ported to "
                       f"pwasm_tpu_torch yet; it comes with "
                       f"{_LATER_DEFAULT}\n")
    opts, positional = _parse_args(argv)
    if opts.get("h"):
        stderr.write(USAGE + "\n")
        return EXIT_USAGE
    if opts.get("many2many"):
        # the multi-CDS job: every query of the -r FASTA against every
        # target of the positional FASTA (stream/multicds.py)
        from pwasm_tpu_torch.stream.multicds import many2many_main
        return many2many_main(opts, positional, stdout, stderr, stats)
    for k in opts:
        if len(k) > 1 and k not in _LONG_FLAGS:
            raise CliError(f"Error: --{k} is not ported to pwasm_tpu_torch "
                           f"yet; it comes with "
                           f"{_LATER.get(k, _LATER_DEFAULT)}\n")
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
    device = resolve_device(cfg.device)
    cfg.realign = bool(opts.get("realign"))
    if cfg.realign and "w" not in opts \
            and not any(k in opts for k in ("ace", "info", "cons")):
        stderr.write(f"{USAGE} Error: --realign requires an MSA output "
                     "(-w, --ace, --info or --cons)!\n")
        return EXIT_USAGE

    infile = positional[0] if positional else None
    inf = sys.stdin
    if infile and infile != "-":
        try:
            inf = open(infile)
        except OSError:
            raise PwasmError(f"Cannot open input file {infile}!\n")
        opened.append(inf)
    if "motifs" in opts:
        try:
            cfg.motifs = load_motifs(str(opts["motifs"]))
        except (OSError, UnicodeDecodeError):
            raise PwasmError(f"Cannot open motif file {opts['motifs']}!\n")
    if "c" in opts:
        cfg.clipmax = _parse_clipmax(str(opts["c"]), cfg.verbose, stderr)
    freport = _open_out(str(opts["o"]), opened) if "o" in opts else stdout
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
    return _main_loop(cfg, device, inf, freport, fmsa, fsummary, qfasta,
                      stderr, cons_outs, nmsa,
                      stats if stats is not None else {})


def _native_msa_outputs(nmsa, cfg: Config, device, fmsa, cons_outs: dict,
                        stderr, stats: dict, times: dict) -> None:
    """End-of-run MSA outputs of the C++ engine: the ``-D`` layout, the
    unrefined ``-w``, then, for the consensus outputs, the engine's
    rendered pileup counted and voted by the consensus launch on
    ``device`` (the CUDA kernel on a CUDA device), the votes applied back
    in the engine (``refine_external``, which also runs the X-drop clip
    refinement), and the ace/info/cons writers."""
    import os
    import tempfile

    import numpy as np

    from pwasm_tpu_torch.align.msa import device_counts_votes

    t0 = time.perf_counter()
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
    t1 = time.perf_counter()
    times["write"] += t1 - t0
    if not (cons_outs and built):
        return
    nmsa.prepare_device()
    depth, length = nmsa.dims()
    stats["pileup"] = (depth, length)
    pile = np.empty((depth, length), dtype=np.int8)
    nmsa.render_pileup(pile)
    chars, counts = device_counts_votes(pile, device)
    t2 = time.perf_counter()
    times["consensus"] += t2 - t1
    nmsa.refine_external(counts, chars, cfg.remove_cons_gaps,
                         cfg.refine_clipping)
    t3 = time.perf_counter()
    times["refine"] += t3 - t2
    contig = nmsa.contig()
    for kind in ("ace", "info", "cons"):
        if kind in cons_outs:
            f = cons_outs[kind]
            f.close()
            nmsa.write(kind, f.name, contig, cfg.remove_cons_gaps,
                       cfg.refine_clipping)
    times["write"] += time.perf_counter() - t3


def _python_msa_outputs(ref_msa, cfg: Config, device, fmsa,
                        cons_outs: dict, stderr, stats: dict,
                        times: dict) -> None:
    """End-of-run MSA outputs of the Python engine (``align/msa.py``):
    the ``-D`` layout, the unrefined ``-w``, then refine once (the
    consensus launch over ``Msa.pileup_matrix`` on ``device``, the clip
    refinement as torch ops there) and the ace/info/cons writers."""
    t0 = time.perf_counter()
    if cfg.debug:
        print(f">MSA ({ref_msa.count()})", file=stderr)
        ref_msa.print_layout(stderr, "v")
    if fmsa is not None:
        ref_msa.write_msa(fmsa)
    if cons_outs:
        ref_msa.finalize()
        times["write"] += time.perf_counter() - t0
        stats["pileup"] = (ref_msa.count(), ref_msa.length)
        ref_msa.refine_msa(remove_cons_gaps=cfg.remove_cons_gaps,
                           refine_clipping=cfg.refine_clipping,
                           device=device, times=times)
        t0 = time.perf_counter()
        contig = ref_msa.seqs[0].name if ref_msa.seqs else "contig"
        if "ace" in cons_outs:
            ref_msa.write_ace(cons_outs["ace"], contig)
        if "info" in cons_outs:
            ref_msa.write_info(cons_outs["info"], contig)
        if "cons" in cons_outs:
            ref_msa.write_cons(cons_outs["cons"], contig)
    times["write"] += time.perf_counter() - t0


def _main_loop(cfg: Config, device, inf, freport, fmsa, fsummary,
               qfasta: FastaFile, stderr, cons_outs: dict, nmsa,
               stats: dict) -> int:
    """The per-PAF-line loop (pafreport.cpp:296-460).  ``nmsa`` is the
    C++ MSA engine (``native.NativeMsa``), or None for the Python
    engine (``align/msa.py``)."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.align.gapseq import FLAG_IS_REF, GapSeq
    from pwasm_tpu_torch.align.msa import Msa
    from pwasm_tpu_torch.report.device_report import submit_diff_info_batch
    from pwasm_tpu_torch.utils.runstats import RunStats

    t_run = time.perf_counter()
    run_stats = RunStats()
    times = dict.fromkeys(("parse_extract", "ctx_scan", "msa_merge",
                           "consensus", "refine", "write")
                          + (("realign",) if cfg.realign else ()), 0.0)
    realigned = 0
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
    inflight: list = []         # submitted-but-unformatted batches (<= 2)
    # the engine's inserts awaiting the next batched merge, all of the
    # current query, and their (query~target) keys
    msa_pending: list[tuple] = []
    msa_pending_keys: set[str] = set()
    # parsed records awaiting the next batched native extraction
    ex_pending: list[tuple] = []
    use_ex_batch = native.enabled()

    def flush_pending(drain: bool = False) -> None:
        """Submit the pending report batch, then format the OLDEST
        in-flight batch: batch k's device program runs while batches
        k-1/k-2 are formatted and written.  ``drain`` formats every
        in-flight batch at end of input."""
        t0 = time.perf_counter()
        batch, pending[:] = pending[:], []
        if batch:
            inflight.append(submit_diff_info_batch(
                batch, freport, device, skip_codan=cfg.skip_codan,
                motifs=cfg.motifs, summary=summary))
        while len(inflight) > (0 if drain else 2):
            inflight.pop(0)()
        times["ctx_scan"] += time.perf_counter() - t0

    def flush_msa_pending() -> None:
        """Merge the buffered alignments into the engine's MSA through
        one ``pw_msa_add_batch`` crossing.  The engine inserts them in
        order; one whose gap structure the layout cannot hold is fatal
        (GapAssem.cpp:105-107), and the error surfaces at this flush."""
        if not msa_pending:
            return
        t0 = time.perf_counter()
        items, msa_pending[:] = msa_pending[:], []
        msa_pending_keys.clear()
        rid, r_len, refseq_b = items[0][:3]

        def on_drop(_idx: int, msg: str) -> None:
            raise PwasmError(msg)

        nmsa.add_batch(rid, refseq_b, r_len, [it[3] for it in items],
                       on_drop)
        times["msa_merge"] += time.perf_counter() - t0

    def msa_add(aln, tlabel: str, refseq_b: bytes, ord_num: int) -> None:
        """Insert one alignment into the progressive MSA (the per-line
        body of pafreport.cpp:394-421)."""
        nonlocal ref_gseq, ref_msa
        al = aln.alninfo
        if nmsa is not None:
            msa_pending.append((al.r_id, al.r_len, refseq_b, (
                tlabel, bytes(aln.tseq), al.r_alnstart, aln.reverse,
                aln.rgaps, aln.tgaps, ord_num)))
            msa_pending_keys.add(f"{al.r_id}~{al.t_id}")
            if len(msa_pending) >= cfg.batch:
                flush_msa_pending()
            return
        t0 = time.perf_counter()
        taseq = GapSeq(tlabel, "", aln.tseq, offset=al.r_alnstart,
                       revcompl=aln.reverse)
        first_ref_aln = ref_gseq is None
        if first_ref_aln:
            rseq = GapSeq(al.r_id, "", refseq_b)
            rseq.set_flag(FLAG_IS_REF)
        else:
            # bare instance of refseq for this alignment
            rseq = GapSeq(al.r_id, "", b"", seqlen=al.r_len)
        # once a gap, always a gap: propagate this alignment's gaps (a
        # gap the layout cannot hold is fatal, GapAssem.cpp:105-107)
        for g in aln.rgaps:
            rseq.set_gap(g.pos, g.len)
        for g in aln.tgaps:
            taseq.set_gap(g.pos, g.len)
        newmsa = Msa(rseq, taseq)
        if first_ref_aln:
            newmsa.ordnum = ord_num
            ref_msa = newmsa
            ref_gseq = rseq
        else:
            ref_gseq.msa.add_align(ref_gseq, newmsa, rseq)
            ref_msa = ref_gseq.msa
        times["msa_merge"] += time.perf_counter() - t0

    # --realign: buffer MSA insertions and re-align each buffered target
    # with the batched banded-DP traceback (ops/realign.py), replacing
    # the PAF's gap structure before the progressive merge.  Insertion
    # order is kept, and the flushes fall where the reference's do (at
    # --batch, at a query change, at the end of input), so every
    # dispatch places its band as the reference's does.
    re_pending: list[tuple] = []

    def flush_realign() -> None:
        nonlocal realigned
        if not re_pending:
            return
        from pwasm_tpu_torch.ops.realign import ops_to_gaps, realign_pairs
        t0 = time.perf_counter()
        items, re_pending[:] = re_pending[:], []
        results = realign_pairs(
            [(q_seg, bytes(aln.tseq)) for aln, _t, _r, _o, q_seg in items],
            band=cfg.band, device=device)
        times["realign"] += time.perf_counter() - t0
        for (aln, tlabel, refseq_b, ordn, _q), res in zip(items, results):
            al = aln.alninfo
            if res is None:  # outside realignment resource bounds:
                # keep the PAF's own gap structure for this alignment
                print(f"Warning: {al.r_id}~{al.t_id} not re-aligned "
                      "(no band up to the escalation ceiling covered "
                      "its optimal path, and it is too large for the "
                      "host oracle); keeping PAF gaps", file=stderr)
            else:
                aln.rgaps, aln.tgaps = ops_to_gaps(
                    res[1], aln.offset, al.r_len,
                    al.t_alnend - al.t_alnstart, aln.reverse)
                realigned += 1
            msa_add(aln, tlabel, refseq_b, ordn)

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
        t0 = time.perf_counter()
        items, ex_pending[:] = ex_pending[:], []
        if len(items) == 1:
            alns, err = [extract_alignment(items[0][0], items[0][1])], None
        else:
            alns, err = native.extract_batch_native(
                [it[0] for it in items], [it[1] for it in items])
        times["parse_extract"] += time.perf_counter() - t0
        for aln, (rec, refseq_aln, refseq_b, ordnum) in zip(alns, items):
            consume_aln(rec, aln, refseq_b, refseq_aln, ordnum)
        if err is not None:
            raise err

    try:
        for line in inf:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            t0 = time.perf_counter()
            rec = parse_paf_line(line)
            al = rec.alninfo
            if al.r_id == al.t_id:
                if cfg.verbose:
                    print("Skipping alignment of qry seq to itself.",
                          file=stderr)
                continue
            if not cfg.fullgenome:  # gene CDS mode: first q~t alignment only
                key = f"{al.r_id}~{al.t_id}"
                if key in msa_pending_keys:
                    # the engine decides a buffered insert of this pair
                    # before its duplicate is judged
                    flush_msa_pending()
                if key in alnpairs:
                    alnpairs[key] += 1
                    if alnpairs[key] == 1:
                        print(f"Warning: alignment {al.r_id} to {al.t_id} "
                              f"already seen, ignoring ", file=stderr)
                    continue
                alnpairs[key] = 0
            numalns += 1
            if refseq_id is None or refseq_id != al.r_id:
                # consume the buffered extractions, then merge the
                # buffered re-alignments and inserts into this query's
                # MSA before the layout state resets
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
                    f"Error: ref seq len in this PAF line ({al.r_len}) "
                    f"differs from loaded sequence length({len(refseq)})!"
                    f"\n{line}\n")
            refseq_aln = refseq_rc if al.reverse else refseq
            times["parse_extract"] += time.perf_counter() - t0
            if use_ex_batch:
                # batched native extraction: this record is extracted
                # and consumed, in input order, at the next flush
                ex_pending.append((rec, refseq_aln, refseq, numalns))
                if len(ex_pending) >= cfg.batch:
                    flush_extract()
                continue
            t0 = time.perf_counter()
            aln = extract_alignment(rec, refseq_aln)
            times["parse_extract"] += time.perf_counter() - t0
            consume_aln(rec, aln, refseq, refseq_aln, numalns)
    finally:
        # consume the records buffered for extraction, then emit the
        # buffered rows, also when a later line raises, so the report
        # keeps every earlier alignment
        try:
            flush_extract()
        finally:
            flush_pending(drain=True)

    flush_realign()
    if nmsa is not None:
        flush_msa_pending()
        _native_msa_outputs(nmsa, cfg, device, fmsa, cons_outs, stderr,
                            stats, times)
    elif ref_msa is not None:
        _python_msa_outputs(ref_msa, cfg, device, fmsa, cons_outs, stderr,
                            stats, times)
    t0 = time.perf_counter()
    if summary is not None:
        summary.write(fsummary)
    times["write"] += time.perf_counter() - t0
    stats.update(times=times, wall_s=time.perf_counter() - t_run,
                 alignments=numalns, device=str(device))
    if cfg.realign:
        stats["realigned"] = realigned
    if cfg.verbose:
        print(run_stats.brief(), file=stderr)
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
