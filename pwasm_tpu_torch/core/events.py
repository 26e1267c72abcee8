"""Per-alignment diff extraction: the ``cs``-string and CIGAR walks.

This is the ground-truth layer (reference: PAFAlignment constructor,
pafreport.cpp:477-719).  For each PAF line it

1. scans the tags (done upstream in ``pwasm_tpu_torch.core.paf``),
2. walks the ``cs`` string to *reconstruct the target sequence* from the
   reference query and record diff events (pafreport.cpp:526-643),
3. walks the CIGAR to collect ref/target gap positions
   (pafreport.cpp:644-714), and
4. cross-validates reconstructed lengths against the PAF coordinates
   (pafreport.cpp:715-718).

Behavioral parity notes (SURVEY.md §2.5):

- Adjacent substitutions merge into one multi-base S event; on the reverse
  strand they are merged in RC space and un-flipped afterwards (§2.5.5).
- The reconstructed target keeps the reference's case convention: matched
  bases are upper-case (copied from the upper-cased query), substituted and
  inserted bases lower-case — the case leaks into the reported target
  context, so it is observable behavior.
- ``~`` (splice) and unknown ops are fatal; a ``cs`` base that contradicts
  the query FASTA is fatal (§2.5.11).
- Reverse-strand events are recorded against the RC'd query then post-fixed
  into forward coordinates (pafreport.cpp:628-643).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from pwasm_tpu_torch.core.dna import revcomp
from pwasm_tpu_torch.core.errors import PwasmError
from pwasm_tpu_torch.core.paf import AlnInfo, PafRecord

CS_ERROR = "Error parsing cs string from line: {} (cs position: {})\n"
CIGAR_ERROR = "Error parsing cigar string from line: {} (cigar position: {})\n"
SOFTCLIP_WARNING = ("Warning: soft clipping shouldn't be found in this "
                    "application!")
BASE_MISMATCH_ERROR = ("Error: base mismatch {} != qstr[{}] ({}) at line"
                       "\n{}\n")
SPLICE_ERROR = "Error: spliced alignments not supported! at line:\n{}\n"
COORDS_ERROR = ("Error: invalid alignment coordinates "
                "(q {}-{}/{}, t {}-{}) at line:\n{}\n")


def validate_coords(al, line: str) -> None:
    """Coordinate sanity shared by BOTH extractors: corrupted fields
    (negative or inverted spans) must fail as a clean PwasmError, not
    as allocation blow-ups or out-of-bounds reference reads (found by
    fuzzing mutated PAF lines; the reference would GMALLOC the bogus
    size and crash too — our --skip-bad-lines contract needs a clean
    error).  Only what memory safety requires: the query bounds feed
    the offset math (r_len - r_alnend on reverse strands) and the
    reference reads; the target span sizes the reconstruction buffer.
    The PAF t_len column is NOT checked against — the reference never
    reads it, and inputs with a junk t_len but self-consistent spans
    extract identically there."""
    if not (0 <= al.r_alnstart <= al.r_alnend <= al.r_len
            and 0 <= al.t_alnstart <= al.t_alnend):
        raise PwasmError(COORDS_ERROR.format(
            al.r_alnstart, al.r_alnend, al.r_len,
            al.t_alnstart, al.t_alnend, line))
CS_OP_ERROR = "Error: unhandled event at {} in cs, line:\n{}\n"
CIGAR_OP_ERROR = "Error: unhandled cigar_op {} (len {}) in {}\n"
TSEQ_LEN_ERROR = ("Error: tseq alignment length mismatch ({} vs {}({}-{}))"
                  " at line:{}\n")
REF_LEN_ERROR = ("Error: ref alignment length mismatch ({} vs {}-{}) at "
                 "line:{}\n")


@dataclass(slots=True)
class GapData:
    """(pos, len) gap record (reference: GapData, pafreport.cpp:48-52)."""

    pos: int = 0
    len: int = 1


# slots: tens of thousands of events materialize per realistic-scale
# report batch — slotted instances construct ~30% faster and index
# ~20% faster in the columnar assembly hot loop
@dataclass(slots=True)
class DiffEvent:
    """One indel/substitution event (reference: TDiffInfo,
    pafreport.cpp:90-132).

    ``evt`` is 'S' (substitution), 'I' (insertion in target) or 'D'
    (deletion from target); ``rloc`` is the event position on the forward
    query; ``tloc`` the position within the aligned target region on the
    aligned strand (flipped for display on reverse); ``tctx`` the target
    context (event ± 5 bases, case as reconstructed)."""

    evt: str = ""
    evtlen: int = 0
    evtbases: bytes = b""
    evtsub: bytes = b""
    rloc: int = 0
    tloc: int = 0
    tctx: bytes = b""

    def set_tcontext(self, tseq: bytes) -> None:
        """Fill ``tctx`` (reference: TDiffInfo::setTContext,
        pafreport.cpp:120-128; note the right-edge clamp drops the final
        target base — observable quirk preserved)."""
        tc_start = self.tloc - 5
        if tc_start < 0:
            tc_start = 0
        evt_len = 0 if self.evt == "D" else self.evtlen
        tc_end = self.tloc + evt_len + 5
        if tc_end >= len(tseq):
            tc_end = len(tseq) - 1
        self.tctx = bytes(tseq[tc_start:tc_end])


_ASCII_DIGITS = frozenset("0123456789")


def _parse_int(s: str, i: int) -> tuple[int, int]:
    """Parse an unsigned ASCII integer at s[i:]; return (value, next_index)
    or (-1, i) if no digits (the reference's parseInt failure path).  cs and
    CIGAR op counts are always unsigned — accepting a sign would let
    malformed counts cancel in the length cross-validation and yield corrupt
    negative-length gap records instead of a parse error."""
    k = i
    while k < len(s) and s[k] in _ASCII_DIGITS:
        k += 1
    if k == i:
        return -1, i
    return int(s[i:k]), k


@dataclass
class PafAlignment:
    """One parsed alignment: diff events + gap lists + reconstructed target.

    Reference: class PAFAlignment (pafreport.cpp:134-158, ctor 477-719).
    ``tseq`` is the reconstructed target over the aligned region, in the
    alignment orientation (RC space when ``reverse``), mixed case.
    """

    alninfo: AlnInfo
    rgaps: list[GapData] = field(default_factory=list)
    tgaps: list[GapData] = field(default_factory=list)
    tdiffs: list[DiffEvent] = field(default_factory=list)
    seqname: str = ""
    edist: int = -1
    alnscore: int = 0
    seqlen: int = 0
    offset: int = 0
    reverse: int = 0
    tseq: bytes = b""


def extract_alignment(rec: PafRecord, refseq_aln: bytes,
                      use_native: bool | None = None) -> PafAlignment:
    """Build a PafAlignment from a parsed PAF record.

    ``refseq_aln`` is the query sequence in *alignment orientation*: the
    forward upper-cased query, or its reverse complement when the PAF strand
    is '-' (the caller keeps both copies, mirroring pafreport.cpp:338-362).

    Runs in the native engine (``native.extract_native``, the same
    results and messages) unless ``PWASM_NATIVE=0`` or
    ``use_native=False`` asks for the Python walk below.
    """
    from pwasm_tpu_torch import native

    if native.enabled() if use_native is None else use_native:
        return native.extract_native(rec, refseq_aln)
    validate_coords(rec.alninfo, rec.line)
    al = rec.alninfo
    line = rec.line
    aln = PafAlignment(alninfo=al, seqname=al.t_id, reverse=al.reverse,
                       edist=rec.edist, alnscore=rec.alnscore)
    aln.offset = al.r_alnstart
    if al.reverse:  # offset on the reverse-complemented query string
        aln.offset = al.r_len - al.r_alnend
    aln.seqlen = al.t_alnend - al.t_alnstart
    if not rec.cigar:
        raise PwasmError(CIGAR_ERROR.format(line, 0))
    if rec.cs is None:
        raise PwasmError(CS_ERROR.format(line, 0))

    offset = aln.offset
    cs = rec.cs
    tseq = bytearray()
    tdiffs: list[DiffEvent] = []
    qpos = 0  # query position within the alignment (alignment orientation)
    tpos = 0  # target position within the aligned region
    eff_t_len = al.t_alnend - al.t_alnstart
    i = 0
    n = len(cs)
    # ---- cs walk: rebuild tseq and emit diff events (pafreport.cpp:536-626)
    while i < n:
        op = cs[i]
        i += 1
        if op == ":":
            cl, i2 = _parse_int(cs, i)
            if i2 == i:
                raise PwasmError(CS_ERROR.format(line, cs[i:]))
            i = i2
            if offset + qpos + cl > len(refseq_aln):
                # copy-match run goes past the query end (the native
                # extractor checks this too; keeps both paths identical)
                raise PwasmError(CS_ERROR.format(line, cs[i:]))
            tseq += refseq_aln[offset + qpos: offset + qpos + cl]
            qpos += cl
            tpos += cl
        elif op == "*":
            if i + 1 >= n:
                raise PwasmError(CS_ERROR.format(line, cs[i:]))
            tch = cs[i].upper()
            qch = cs[i + 1].upper()
            i += 2
            q_pos = offset + qpos
            if q_pos >= len(refseq_aln) or qch != chr(refseq_aln[q_pos]):
                refc = chr(refseq_aln[q_pos]) \
                    if q_pos < len(refseq_aln) else "?"
                raise PwasmError(
                    BASE_MISMATCH_ERROR.format(qch, q_pos, refc, line))
            # merge adjacent substitutions into a single event
            if (tdiffs and tdiffs[-1].evt == "S"
                    and tdiffs[-1].rloc == q_pos - len(tdiffs[-1].evtbases)):
                # NB: the reference leaves evtlen at 1 for merged multi-base
                # substitutions (pafreport.cpp:556-573) — that shortens the
                # reported target context window, an observable quirk we keep.
                tdiffs[-1].evtbases += tch.encode()
                tdiffs[-1].evtsub += qch.encode()
            else:
                tdiffs.append(DiffEvent("S", 1, tch.encode(), qch.encode(),
                                        rloc=q_pos, tloc=tpos))
            tseq += tch.lower().encode()
            qpos += 1
            tpos += 1
        elif op == "-":
            # gap in query => bases present only in the target (Insertion)
            s_pos = tpos
            while i < n and cs[i].isalpha():
                tseq.append(ord(cs[i].lower()))
                i += 1
                tpos += 1
            e_len = tpos - s_pos
            q_pos = offset + qpos
            ev = DiffEvent("I", e_len, bytes(tseq[-e_len:]) if e_len else b"",
                           b"", rloc=q_pos, tloc=s_pos)
            if al.reverse:
                ev.evtbases = revcomp(ev.evtbases)
                ev.rloc = al.r_len - q_pos
            tdiffs.append(ev)
        elif op == "+":
            # gap in target => query bases missing from the target (Deletion)
            s_pos = qpos
            while i < n and cs[i].isalpha():
                i += 1
                qpos += 1
            e_len = qpos - s_pos
            q_pos = s_pos + offset
            if q_pos + e_len > len(refseq_aln):
                # deleted-bases run goes past the query end (native parity)
                raise PwasmError(CS_ERROR.format(line, cs[i:]))
            ev = DiffEvent("D", e_len,
                           bytes(refseq_aln[q_pos:q_pos + e_len]), b"",
                           rloc=q_pos, tloc=tpos)
            if al.reverse:
                ev.evtbases = revcomp(ev.evtbases)
                ev.rloc = al.r_len - q_pos - e_len
            tdiffs.append(ev)
        elif op == "~":
            raise PwasmError(SPLICE_ERROR.format(line))
        else:
            # the reference reports from the position *after* the op char
            raise PwasmError(CS_OP_ERROR.format(cs[i:], line))

    # ---- context fill + reverse-strand fixups (pafreport.cpp:628-643)
    tseq_final = bytes(tseq)
    for ev in tdiffs:
        ev.set_tcontext(tseq_final)
        if al.reverse:
            ev.tctx = revcomp(ev.tctx)
            ev.tloc = len(tseq_final) - ev.tloc
            if ev.evt == "S":
                # substitutions were kept in RC space to simplify merging
                ev.evtbases = revcomp(ev.evtbases)
                ev.evtsub = revcomp(ev.evtsub)
                ev.rloc = al.r_len - ev.rloc - len(ev.evtbases)
    if al.reverse:
        tdiffs.reverse()
    aln.tdiffs = tdiffs
    aln.tseq = tseq_final

    # ---- CIGAR walk: gap positions (pafreport.cpp:644-714)
    cigar = rec.cigar
    qpos = 0
    tpos = 0
    i = 0
    n = len(cigar)
    while i < n:
        cl, i2 = _parse_int(cigar, i)
        if i2 == i:
            raise PwasmError(CIGAR_ERROR.format(line, cigar[i:]))
        i = i2
        if i >= n:
            raise PwasmError(CIGAR_ERROR.format(line, ""))
        cop = cigar[i]
        if cop in "XM=":
            tpos += cl
            qpos += cl
        elif cop in "PH":
            pass  # neither position advances
        elif cop == "S":
            # soft clip: shouldn't appear in this application
            # (reference warns on stderr, pafreport.cpp:675-679)
            print(f"{SOFTCLIP_WARNING}\n{line}", file=sys.stderr)
            qpos += cl
        elif cop == "I":
            # gap in the target sequence; tpos not advanced
            aln.tgaps.append(GapData(eff_t_len - tpos if al.reverse else tpos,
                                     cl))
            qpos += cl
        elif cop == "D":
            # gap in the query; tpos advances
            pos = offset + qpos
            if al.reverse:
                pos = al.r_len - pos
            aln.rgaps.append(GapData(pos, cl))
            tpos += cl
        elif cop == "N":
            # intron-style skip: treated as a query gap too
            tpos += cl
            pos = offset + qpos
            if al.reverse:
                pos = al.r_len - pos
            aln.rgaps.append(GapData(pos, cl))
        else:
            raise PwasmError(CIGAR_OP_ERROR.format(cop, cl, line))
        i += 1

    # ---- cross-validation (pafreport.cpp:715-718)
    if eff_t_len != tpos or len(tseq) != tpos:
        raise PwasmError(TSEQ_LEN_ERROR.format(
            tpos, eff_t_len, al.t_alnend, al.t_alnstart, line))
    if al.r_alnend - al.r_alnstart != qpos:
        raise PwasmError(REF_LEN_ERROR.format(
            qpos, al.r_alnend, al.r_alnstart, line))
    return aln
