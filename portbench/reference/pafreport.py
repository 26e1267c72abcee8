"""The plain reference of a ``pafreport`` job: its outputs, from its inputs.

One query CDS in gene mode (the first alignment of each query~target
pair), as ``pafreport -r cds.fa job.paf`` runs it with the default
settings: each alignment's cs walk, its report rows with the scalar event
analysis, the event summary, and for the MSA outputs the progressive
merge of the Python MSA engine (re-aligned first under ``--realign``, in
flushes of ``batch`` alignments as the program places its bands), the
unrefined ``-w``, then the consensus vote, the clip refinement and the
ace, info and cons writers.  Plain Python, NumPy and torch only.
"""

from __future__ import annotations

import io

from .pw.diff_report import Summary, print_diff_info
from .pw.dna import revcomp
from .pw.events import extract_alignment
from .pw.gapseq import FLAG_IS_REF, GapSeq
from .pw.msa import Msa
from .pw.paf import parse_paf_line
from .pw.realign import ops_to_gaps, realign_pairs

# the outputs a job may ask for, by the flag that names each
OUTPUTS = ("o", "s", "w", "ace", "info", "cons")


def pafreport(query: bytes, paf_lines: list[str], outputs: tuple,
              realign: bool = False, band: int = 64, batch: int = 256,
              device="cpu", escalate: bool = True) -> dict[str, bytes]:
    """The bytes of each output in ``outputs`` (names of ``OUTPUTS``) of a
    job over one query sequence and its PAF lines.  ``escalate=False``
    is the control's re-aligner (see ``realign_pairs``)."""
    refseq = bytes(query).upper()
    refseq_rc = revcomp(refseq)
    report = io.StringIO()
    summary = Summary() if "s" in outputs else None
    build_msa = any(k in outputs for k in ("w", "ace", "info", "cons"))
    seen: set[str] = set()
    state = {"gseq": None, "msa": None}
    re_pending: list[tuple] = []
    numalns = 0

    def msa_add(aln, tlabel: str, ord_num: int) -> None:
        al = aln.alninfo
        taseq = GapSeq(tlabel, "", aln.tseq, offset=al.r_alnstart,
                       revcompl=aln.reverse)
        first = state["gseq"] is None
        if first:
            rseq = GapSeq(al.r_id, "", refseq)
            rseq.set_flag(FLAG_IS_REF)
        else:
            rseq = GapSeq(al.r_id, "", b"", seqlen=al.r_len)
        for g in aln.rgaps:
            rseq.set_gap(g.pos, g.len)
        for g in aln.tgaps:
            taseq.set_gap(g.pos, g.len)
        newmsa = Msa(rseq, taseq)
        if first:
            newmsa.ordnum = ord_num
            state["msa"] = newmsa
            state["gseq"] = rseq
        else:
            state["gseq"].msa.add_align(state["gseq"], newmsa, rseq)
            state["msa"] = state["gseq"].msa

    def flush_realign() -> None:
        if not re_pending:
            return
        items, re_pending[:] = re_pending[:], []
        results = realign_pairs(
            [(q_seg, bytes(aln.tseq)) for aln, _t, _o, q_seg in items],
            band=band, device=device, escalate=escalate)
        for (aln, tlabel, ordn, _q), res in zip(items, results):
            al = aln.alninfo
            if res is not None:
                aln.rgaps, aln.tgaps = ops_to_gaps(
                    res[1], aln.offset, al.r_len,
                    al.t_alnend - al.t_alnstart, aln.reverse)
            msa_add(aln, tlabel, ordn)

    for line in paf_lines:
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        rec = parse_paf_line(line)
        al = rec.alninfo
        if al.r_id == al.t_id:
            continue
        key = f"{al.r_id}~{al.t_id}"
        if key in seen:
            continue
        seen.add(key)
        numalns += 1
        if al.r_len != len(refseq):
            raise ValueError(f"query length {al.r_len} in the PAF is not "
                             f"the FASTA's {len(refseq)}")
        refseq_aln = refseq_rc if al.reverse else refseq
        aln = extract_alignment(rec, refseq_aln)
        tlabel = f"{al.t_id}:{al.t_alnstart}-{al.t_alnend}" \
            + ("-" if al.reverse else "+")
        print_diff_info(aln, "", tlabel, report, refseq, summary=summary)
        if build_msa and realign:
            q_seg = refseq_aln[aln.offset:aln.offset
                               + (al.r_alnend - al.r_alnstart)]
            re_pending.append((aln, tlabel, numalns, q_seg))
            if len(re_pending) >= batch:
                flush_realign()
        elif build_msa:
            msa_add(aln, tlabel, numalns)
    flush_realign()

    out: dict[str, bytes] = {}
    if "o" in outputs:
        out["o"] = report.getvalue().encode()
    msa = state["msa"]
    if build_msa and msa is not None:
        if "w" in outputs:
            f = io.StringIO()
            msa.write_msa(f)
            out["w"] = f.getvalue().encode()
        cons_outs = [k for k in ("ace", "info", "cons") if k in outputs]
        if cons_outs:
            msa.finalize()
            msa.refine_msa(remove_cons_gaps=False, refine_clipping=True)
            contig = msa.seqs[0].name if msa.seqs else "contig"
            for kind in cons_outs:
                f = io.StringIO()
                getattr(msa, f"write_{kind}")(f, contig)
                out[kind] = f.getvalue().encode()
    if "s" in outputs:
        f = io.StringIO()
        summary.write(f)
        out["s"] = f.getvalue().encode()
    return out
