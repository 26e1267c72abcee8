"""The per-alignment diff report (.dfa) and its biology analysis.

Byte-parity port of the reference's L3 layer (pafreport.cpp:721-955):
``getRefContext``, ``hpolyCheck``, ``mmotifCheck``, ``predictImpact`` and
``PAFAlignment::printDiffInfo``.  Also implements the event summary counters
that the reference documents for ``-s`` but never writes (quirk SURVEY.md
§2.5.1) — here they are real.

A device path computes the same
quantities as batched tensors; this module is the bit-exact scalar ground truth and the
formatter of record.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO

DEFAULT_MOTIFS = ("CCTGG", "CCAGG", "GATC", "GTAC")
from .dna import translate_codon
from .errors import PwasmError
from .events import DiffEvent, PafAlignment

MAX_EVLEN = 12  # maximum event length to display (pafreport.cpp:919)
# the codons an indel's downstream stop scan may read; None: the rest of
# the sequence, as the reference scans.  Only the control bounds it
STOP_SCAN_CODONS = None


def get_ref_context(refseq: bytes, rloc: int) -> tuple[bytes, int]:
    """9-base reference window centered (-4/+4) on ``rloc`` with edge
    clamping; returns (window, event offset within window).
    Reference: getRefContext (pafreport.cpp:721-733).

    Parity note: at the right edge the reference applies the window shift to
    ``evtloc`` with the wrong sign (pafreport.cpp:726-728), so events near
    the sequence end report a too-small local offset (0 instead of 8 for the
    last base of a 25bp query).  That skews hpolyCheck's overlap test for
    right-edge events; preserved bit-for-bit."""
    ctxstart = rloc - 4
    evtloc = 4
    if ctxstart < 0:
        evtloc += ctxstart
        ctxstart = 0
    elif ctxstart + 8 >= len(refseq):
        evtloc += len(refseq) - ctxstart - 9
        ctxstart = len(refseq) - 9
        if ctxstart < 0:  # degenerate <9bp reference; reference reads OOB
            evtloc += ctxstart
            ctxstart = 0
    return refseq[ctxstart:ctxstart + 9].upper(), evtloc


def hpoly_check(evtbases: bytes, rctx: bytes, rctxloc: int) -> bool:
    """Homopolymer attribution: all event bases identical AND a 4-run of
    that base occurs in the 9bp window overlapping the event position.
    Reference: hpolyCheck (pafreport.cpp:735-748)."""
    if not evtbases:
        return False
    if len(evtbases) > 1 and any(b != evtbases[0] for b in evtbases[1:]):
        return False
    cseed = evtbases[0:1] * 4
    l = rctx.find(cseed)
    return 0 <= l <= rctxloc <= l + 4


def mmotif_check(rctx: bytes, motifs=DEFAULT_MOTIFS) -> tuple[int, str]:
    """First motif found anywhere in the 9bp window wins; returns (1-based
    motif index or 0, status text).  Reference: mmotifCheck
    (pafreport.cpp:751-763)."""
    for m, motif in enumerate(motifs):
        if rctx.find(motif.encode()) >= 0:
            return m + 1, f"motif {motif}"
    return 0, ""


def predict_impact(di: DiffEvent, refseq: bytes, r_trloc: int) -> str:
    """Codon-impact prediction.  Reference: predictImpact
    (pafreport.cpp:801-883).

    ``r_trloc`` is the translation-window start (one codon before the event
    codon, clamped to 0).  Note the reference's GStr(ptr, len) capacity
    quirk (SURVEY.md §2.5.9) makes both the original and modified sequences
    the *entire* reference suffix from ``r_trloc`` — preserved here.
    """
    r_trseq = refseq[r_trloc:]
    modseq = bytearray(r_trseq)
    if di.evt == "S":
        aaofs = -1
        aamods: list[int] = []
        for i in range(len(di.evtbases)):
            p = di.rloc - r_trloc + i
            if modseq[p:p + 1].upper() != di.evtsub[i:i + 1].upper():
                raise PwasmError(
                    f"Error: modseq[{p}] not matching di.evtsub[{i}] !\n")
            modseq[p] = di.evtbases[i]
            ao = p // 3
            if ao != aaofs:
                aaofs = ao
                aamods.append(ao)
        parts: list[str] = []
        mod_b = bytes(modseq)   # one copy for all modified codons
        for ao in aamods:
            aa = translate_codon(r_trseq, ao * 3)
            maa = translate_codon(mod_b, ao * 3)
            if aa != maa:  # not a synonymous codon
                aapos = ao + di.rloc // 3
                s = f"AA{aapos}|{aa}:{maa}"
                if maa == ".":
                    s += f"|premature stop at AA{aapos}"
                parts.append(s)
        return ", ".join(parts) if parts else "synonymous"
    if di.evt == "I":
        pos = di.rloc - r_trloc
        modseq[pos:pos] = di.evtbases
    elif di.evt == "D":
        pos = di.rloc - r_trloc
        del modseq[pos:pos + di.evtlen]
    else:
        raise PwasmError(f"Error: unrecognized editing event ({di.evt})!\n")
    # for I/D, look for a premature stop codon down the road
    aamodc = 0
    aa4: list[str] = []
    maa4: list[str] = []
    txt = ""
    i = 0
    mod_b = bytes(modseq)   # ONE copy — the scan below is per codon,
    #                         and modseq is the whole reference suffix
    end = len(mod_b) if STOP_SCAN_CODONS is None \
        else min(len(mod_b), 3 * STOP_SCAN_CODONS + 2)
    while i + 2 < end:
        aamod = translate_codon(mod_b, i)
        if aamod == ".":
            txt = f"premature stop at AA{1 + (i + r_trloc) // 3}"
            break
        if i > 0 and aamodc < 4:
            aamodc += 1
            if i + 2 < len(r_trseq):
                aa4.append(translate_codon(r_trseq, i))
            maa4.append(aamod)
        i += 3
    if not txt and aa4 and maa4:
        txt = f"frame shift {''.join(aa4)}+:{''.join(maa4)}+"
    return txt


@dataclass
class Summary:
    """Event summary counters — the reference's documented-but-unwritten
    ``-s`` output (pafreport.cpp:20,274; SURVEY.md §5), implemented as a
    trivial reduction over the event stream."""

    alignments: int = 0
    events: dict = field(default_factory=lambda: {"S": 0, "I": 0, "D": 0})
    bases: dict = field(default_factory=lambda: {"S": 0, "I": 0, "D": 0})
    status: dict = field(default_factory=lambda: {
        "homopolymer": 0, "motif": 0, "unknown": 0})
    impact: dict = field(default_factory=lambda: {
        "synonymous": 0, "nonsynonymous": 0, "premature_stop": 0,
        "frame_shift": 0})
    aligned_bases: int = 0

    def add_alignment(self, aln: PafAlignment) -> None:
        self.alignments += 1
        al = aln.alninfo
        self.aligned_bases += al.r_alnend - al.r_alnstart

    def add_event(self, di: DiffEvent, status: str, impact: str) -> None:
        evt = di.evt
        events = self.events
        events[evt] = events.get(evt, 0) + 1
        nb = len(di.evtbases) if evt != "D" else di.evtlen
        bases = self.bases
        bases[evt] = bases.get(evt, 0) + nb
        if status == "homopolymer":
            self.status["homopolymer"] += 1
        elif status.startswith("motif"):
            self.status["motif"] += 1
        else:
            self.status["unknown"] += 1
        if impact:
            if impact == "synonymous":
                self.impact["synonymous"] += 1
            elif "premature stop" in impact:
                self.impact["premature_stop"] += 1
            elif impact.startswith("frame shift"):
                self.impact["frame_shift"] += 1
            else:
                self.impact["nonsynonymous"] += 1

    def write(self, f: IO[str]) -> None:
        # one assembled block, one write (the same batching contract as
        # the report emit path — the per-line appends were measurable
        # under the warm-serve daemon's per-job summaries)
        lines = ["# pwasm-tpu event summary\n",
                 f"alignments\t{self.alignments}\n",
                 f"aligned_query_bases\t{self.aligned_bases}\n",
                 f"events_total\t{sum(self.events.values())}\n"]
        for k, label in (("S", "substitutions"), ("I", "insertions"),
                         ("D", "deletions")):
            lines.append(f"{label}\t{self.events.get(k, 0)}"
                         f"\t{self.bases.get(k, 0)} bases\n")
        for k in ("homopolymer", "motif", "unknown"):
            lines.append(f"cause_{k}\t{self.status[k]}\n")
        for k in ("synonymous", "nonsynonymous", "premature_stop",
                  "frame_shift"):
            lines.append(f"impact_{k}\t{self.impact[k]}\n")
        f.write("".join(lines))


def _truncate_display(data: bytes) -> bytes:
    """``[len]`` truncation for long event strings (pafreport.cpp:928-941)."""
    if len(data) > MAX_EVLEN:
        return b"[" + str(len(data)).encode() + b"]"
    return data


def analyze_event_host(di: DiffEvent, refseq: bytes, skip_codan: bool,
                       motifs=DEFAULT_MOTIFS):
    """Scalar analysis of one event: (aa, aapos, rctx, status, impact).
    NB: upper-cases ``di.evtbases`` in place, like the reference's
    printDiffInfo loop head (pafreport.cpp:895)."""
    di.evtbases = di.evtbases.upper()
    aapos = di.rloc // 3
    aa = translate_codon(refseq, 3 * aapos)
    aapos += 1
    rctx, rctxloc = get_ref_context(refseq, di.rloc)
    status = "homopolymer" if hpoly_check(di.evtbases, rctx, rctxloc) else ""
    r_trloc = 3 * (aapos - 2)  # start editing one codon before
    if r_trloc < 0:
        r_trloc = 0
    if not status:
        _, status = mmotif_check(rctx, motifs)
    impact = ""
    if not skip_codan:
        impact = predict_impact(di, refseq, r_trloc)
    if not status:
        status = "[unknown]"
    return aa, aapos, rctx, status, impact


def format_event_row(di: DiffEvent, aa: str, aapos: int, rctx: bytes,
                     status: str, impact: str) -> str:
    """One TSV report row (pafreport.cpp:942-953), shared by the host and
    device analysis paths."""
    tcontext = di.tctx
    if len(tcontext) > 10 + MAX_EVLEN:
        dlen = len(tcontext) - 10
        tcontext = (di.tctx[:5] + b"[" + str(dlen).encode() + b"]"
                    + di.tctx[-5:])
    evtbases = di.evtbases if len(di.evtbases) <= MAX_EVLEN \
        else _truncate_display(di.evtbases)
    tctx_s = tcontext.decode("ascii", "replace")
    rctx_s = rctx.decode("ascii", "replace")
    eb = evtbases.decode("ascii", "replace")
    if di.evt == "S":
        es = _truncate_display(di.evtsub).decode("ascii", "replace")
        mid = f"{es}:{eb}"
    elif di.evt == "I":
        mid = f":{eb}"
    else:
        mid = f"{eb}:"
    return (f"{di.evt}\t{di.rloc + 1}\t{aapos}({aa})\t{mid}\t"
            f"{di.tloc + 1}\t{tctx_s}\t{rctx_s}\t{status}\t{impact}\n")


def format_header(aln: PafAlignment, rlabel: str, tlabel: str) -> str:
    """The per-alignment report header line (pafreport.cpp:886-892)."""
    al = aln.alninfo
    # degenerate zero-length query: the reference's C++ double division
    # yields NaN and keeps going; mirror that instead of raising
    cov = ((al.r_alnend - al.r_alnstart) * 100.00 / al.r_len
           if al.r_len else float("nan"))
    if not rlabel:
        return (f">{tlabel} coverage:{cov:.2f} score={aln.alnscore} "
                f"edit_distance={aln.edist}\n")
    return (f">{rlabel}--{tlabel} coverage:{cov:.2f} "
            f"score={aln.alnscore} edit_distance={aln.edist}\n")


def print_diff_info(aln: PafAlignment, rlabel: str, tlabel: str, f: IO[str],
                    refseq: bytes, skip_codan: bool = False,
                    motifs=DEFAULT_MOTIFS,
                    summary: Summary | None = None) -> None:
    """Emit the per-alignment diff report rows.
    Reference: PAFAlignment::printDiffInfo (pafreport.cpp:885-955).

    ``refseq`` is the *forward* query sequence (upper-case).
    """
    f.write(format_header(aln, rlabel, tlabel))
    if summary is not None:
        summary.add_alignment(aln)
    for di in aln.tdiffs:
        aa, aapos, rctx, status, impact = analyze_event_host(
            di, refseq, skip_codan, motifs)
        if summary is not None:
            summary.add_event(di, status, impact)
        f.write(format_event_row(di, aa, aapos, rctx, status, impact))
