"""Gapped sequence model.

Equivalent of the reference's GASeq (GapAssem.h:35-138, GapAssem.cpp:27-591):
a sequence plus a per-base gap array ``gaps[i]`` = number of gap columns
*before* base ``i`` in the MSA layout; a negative value marks the base
itself as deleted.  Offsets position the sequence in the layout.

The gap array is a numpy int32 tensor, so layout positions are prefix sums
(``find_walk_pos``) rather than the reference's O(pos) walks — the
same math the device kernels use.
"""

from __future__ import annotations

import sys

import numpy as np

from .dna import revcomp
from .errors import PwasmError

# per-seq bit flags (GapAssem.h:12-16)
FLAG_IS_REF = 0
FLAG_HAS_PARENT = 1
FLAG_PREPPED = 2
FLAG_BAD_ALN = 7


class GapSeq:
    """A sequence in an MSA layout: bases + gap counts + offsets + clips."""

    def __init__(self, name: str, descr: str = "", seq: bytes = b"",
                 seqlen: int | None = None, offset: int = 0,
                 clp5: int = 0, clp3: int = 0, revcompl: int = 0):
        self.name = name
        self.descr = descr or ""
        self.seq = bytearray(seq)
        self.seqlen = len(seq) if seqlen is None else seqlen
        self.gaps = np.zeros(self.seqlen, dtype=np.int32)
        self._wcum = None   # cumsum(1 + gaps), cleared when a gap changes
        self.numgaps = 0
        self.offset = offset
        self.ng_ofs = offset
        self.revcompl = revcompl
        self.clp5 = clp5
        self.clp3 = clp3
        self.ext5 = 0
        self.ext3 = 0
        self.flags = 0
        self.msa = None
        self.msaidx = -1
        self.delops: list[tuple[int, bool]] = []  # (pos, revcompl) pairs
        # per-base overlap coverage, opt-in (the reference's compile-time
        # ALIGN_COVERAGE_DATA capability, GapAssem.h:42-46)
        self.cov: np.ndarray | None = None

    # ---- flags ----------------------------------------------------------
    def set_flag(self, bit: int) -> None:
        self.flags |= 1 << bit

    def has_flag(self, bit: int) -> bool:
        return (self.flags >> bit) & 1 != 0

    # ---- basic ops ------------------------------------------------------
    def reverse_complement_bases(self) -> None:
        """RC the base string only (FastaSeq::reverseComplement)."""
        self.seq = bytearray(revcomp(bytes(self.seq)))

    def end_offset(self) -> int:
        return self.offset + self.seqlen + self.numgaps

    def end_ng_offset(self) -> int:
        return self.ng_ofs + self.seqlen

    def gap(self, pos: int) -> int:
        return int(self.gaps[pos])

    def set_gap(self, pos: int, gaplen: int = 1) -> None:
        """Set the gap length before ``pos`` (GapAssem.cpp:104-111)."""
        if pos < 0 or pos >= self.seqlen:
            raise PwasmError(
                f"Error: invalid gap position ({pos + 1}) given for "
                f"sequence {self.name}\n")
        old = int(self.gaps[pos])
        self.numgaps -= old
        self.gaps[pos] = gaplen
        if self._wcum is not None:
            self._wcum[pos:] += gaplen - old
        self.numgaps += gaplen

    def add_gap(self, pos: int, gapadd: int) -> None:
        """Extend the gap before ``pos`` (GapAssem.cpp:113-120)."""
        if pos < 0 or pos >= self.seqlen:
            raise PwasmError(
                f"Error: invalid gap position ({pos + 1}) given for "
                f"sequence {self.name}\n")
        self.numgaps += gapadd
        self.gaps[pos] += gapadd
        if self._wcum is not None:
            self._wcum[pos:] += gapadd

    def remove_base(self, pos: int) -> None:
        """Remove one layout column at ``pos``: a gap if one exists, else
        the base itself (gap count goes negative = deleted base;
        GapAssem.cpp:122-180)."""
        if pos < 0 or pos >= self.seqlen:
            raise PwasmError(
                f"Error: invalid gap position ({pos + 1}) given for "
                f"sequence {self.name}\n")
        self.gaps[pos] -= 1
        if self._wcum is not None:
            self._wcum[pos:] -= 1
        self.numgaps -= 1

    # ---- layout math ----------------------------------------------------
    def find_walk_pos(self, alpos: int) -> int:
        """First position j with W[j] > alpos (== reference walk result);
        returns seqlen if the walk runs off the end."""
        if self._wcum is None:
            self._wcum = np.cumsum(1 + self.gaps.astype(np.int64))
        return int(np.searchsorted(self._wcum, alpos - self.offset,
                                   side="right"))

    # ---- gap/strand transforms -----------------------------------------
    def reverse_gaps(self) -> None:
        """Reverse the gap array in place, keeping index 0 fixed
        (GapAssem.cpp:351-364 — 'shifted by 1 because the first ofs is
        always 0')."""
        if self.seqlen > 1:
            self.gaps[1:] = self.gaps[1:][::-1]
            self._wcum = None

    # ---- coverage tracking (opt-in; the reference's compile-time
    # ALIGN_COVERAGE_DATA capability, GapAssem.h:42-46,131-133) ---------
    def enable_coverage(self) -> None:
        """Allocate the per-base coverage array (zeros), like the
        GCALLOC in the reference ctors (GapAssem.cpp:36-79)."""
        if self.cov is None:
            self.cov = np.zeros(self.seqlen, dtype=np.int32)

    def add_coverage(self, other: "GapSeq") -> None:
        """Merge another instance's coverage of the SAME sequence,
        flipping when orientations differ (GASeq::addCoverage,
        GapAssem.cpp:394-410)."""
        if self.seqlen != other.seqlen:
            raise ValueError(
                f"invalid addCoverage {self.name}(len {self.seqlen}) vs "
                f"{other.name}(len {other.seqlen})")
        if self.cov is None or other.cov is None:
            return
        if self.revcompl != other.revcompl:
            self.cov += other.cov[::-1]
        else:
            self.cov += other.cov

    def rev_complement(self, alignlen: int = 0) -> None:
        """Reverse-complement within an alignment layout
        (GASeq::revComplement, GapAssem.cpp:366-392)."""
        if alignlen > 0:
            self.offset = alignlen - self.end_offset()
            if self.msa is not None:
                self.ng_ofs = self.msa.ng_len - self.end_ng_offset()
                if self.msa.minoffset > self.offset:
                    self.msa.minoffset = self.offset
                if self.msa.ng_minofs > self.ng_ofs:
                    self.msa.ng_minofs = self.ng_ofs
        self.revcompl = 0 if self.revcompl else 1
        if len(self.seq) == self.seqlen:
            self.reverse_complement_bases()
        self.reverse_gaps()
        if self.cov is not None:  # GapAssem.cpp:383-391
            self.cov = self.cov[::-1].copy()

    def prep_seq(self) -> None:
        """Apply deferred deletions, then RC if needed; once per sequence
        (GASeq::prepSeq, GapAssem.cpp:89-101)."""
        for pos, rc in self.delops:
            p = len(self.seq) - pos - 1 if rc else pos
            self.remove_base(p)
        if self.revcompl == 1:
            self.reverse_complement_bases()
        self.set_flag(FLAG_PREPPED)

    def clip_lr(self) -> tuple[int, int]:
        """(clipL, clipR) in layout orientation (strand-aware aliasing of
        clp5/clp3, e.g. GapAssem.cpp:188-189)."""
        if self.revcompl != 0:
            return self.clp3, self.clp5
        return self.clp5, self.clp3

    def remove_clip_gaps(self) -> int:
        """Zero gaps inside the clipped ends, fixing the offset
        (GapAssem.cpp:522-549)."""
        clipL, clipR = self.clip_lr()
        delgaps_l = 0
        delgaps_r = 0
        for i in range(self.seqlen):
            if i <= clipL:
                delgaps_l += int(self.gaps[i])
                self.gaps[i] = 0
                continue
            if i >= self.seqlen - clipR:
                delgaps_r += int(self.gaps[i])
                self.gaps[i] = 0
        self.offset += delgaps_l
        self._wcum = None
        self.numgaps -= delgaps_l + delgaps_r
        return delgaps_l + delgaps_r

    # ---- X-drop end re-alignment ---------------------------------------
    XDROP = -16
    MATCH_SC = 1
    MISMATCH_SC = -3

    def refine_clipping_scalar(self, cons: bytes, cpos: int,
                               skip_dels: bool = False) -> None:
        """Direct transliteration of the reference walk
        (GapAssem.cpp:182-349), one character at a time on the host:
        the oracle that ``refine_clipping`` and ``refine_clipping_batch``
        are held to.  No product path calls it."""
        if self.clp3 == 0 and self.clp5 == 0:
            return
        cons_len = len(cons)
        rev = self.revcompl != 0
        clipL, clipR = self.clip_lr()
        glen = self.seqlen + self.numgaps
        allocsize = glen
        gclipR = clipR
        gclipL = clipL
        if skip_dels:
            for i in range(1, clipR + 1):
                if self.gaps[self.seqlen - i] < 0:
                    allocsize += 1
                else:
                    gclipR += int(self.gaps[self.seqlen - i])
            for i in range(clipL):
                if self.gaps[i] < 0:
                    allocsize += 1
                else:
                    gclipL += int(self.gaps[i])
        else:
            for i in range(1, clipR + 1):
                gclipR += int(self.gaps[self.seqlen - i])
            for i in range(clipL):
                gclipL += int(self.gaps[i])
        gseq = bytearray()
        gxpos: list[int] = []
        for i in range(self.seqlen):
            g = int(self.gaps[i])
            if g < 0:
                if not skip_dels:
                    continue
                if clipL <= i < self.seqlen - clipR:
                    continue
                glen += 1
            for _ in range(max(g, 0)):
                gseq.append(ord("*"))
                gxpos.append(-1)
            gseq.append(self.seq[i])
            gxpos.append(i)
        if glen != allocsize:
            raise PwasmError(
                f"Length mismatch (allocsize {allocsize} vs. glen {glen}) "
                f"while refineClipping for seq {self.name} !\n")
        star = ord("*")

        def write_back():
            # the reference's clipL/clipR are int& aliases of clp5/clp3, so
            # every increment persists even on early returns — mirror that
            if rev:
                self.clp3, self.clp5 = clipL, clipR
            else:
                self.clp5, self.clp3 = clipL, clipR

        if clipR > 0:
            cp = cpos + glen - gclipR - 1
            sp = glen - gclipR - 1
            ok = True
            while (sp < 0 or cp < 0 or cp >= cons_len
                   or gseq[sp] != cons[cp] or gseq[sp] == star):
                if sp >= 0 and gseq[sp] != star:
                    clipR += 1
                sp -= 1
                cp -= 1
                if sp < gclipL:
                    print(f"Warning: reached clipL trying to find an "
                          f"initial match on {self.name}!", file=sys.stderr)
                    ok = False
                    break
            if not ok:
                write_back()
                return
            score = self.MATCH_SC
            maxscore = self.MATCH_SC
            startpos = sp
            bestpos = sp
            while score > self.XDROP:
                cp += 1
                sp += 1
                if cp >= cons_len or sp >= glen:
                    break
                if gseq[sp] == cons[cp]:
                    if gseq[sp] != star:
                        score += self.MATCH_SC
                        if score > maxscore:
                            bestpos = sp
                            maxscore = score
                else:
                    if gseq[sp] != star:
                        score += self.MISMATCH_SC
            if bestpos > startpos:
                clipR = self.seqlen - gxpos[bestpos] - 1
        if clipL > 0:
            cp = cpos + gclipL
            sp = gclipL
            ok = True
            while (sp >= glen or cp >= cons_len or cp < 0
                   or gseq[sp] != cons[cp] or gseq[sp] == star):
                if sp < glen and gseq[sp] != star:
                    clipL += 1
                sp += 1
                cp += 1
                if sp >= glen - gclipR:
                    print(f"Warning: reached clipR trying to find an "
                          f"initial match on {self.name}!", file=sys.stderr)
                    ok = False
                    break
            if not ok:
                write_back()
                return
            score = self.MATCH_SC
            maxscore = self.MATCH_SC
            startpos = sp
            bestpos = sp
            while score > self.XDROP:
                cp -= 1
                sp -= 1
                if cp < 0 or sp < 0:
                    break
                if gseq[sp] == cons[cp]:
                    if gseq[sp] != star:
                        score += self.MATCH_SC
                        if score > maxscore:
                            bestpos = sp
                            maxscore = score
                else:
                    if gseq[sp] != star:
                        score += self.MISMATCH_SC
            if bestpos < startpos:
                clipL = gxpos[bestpos]
        write_back()

    # ---- printers -------------------------------------------------------
    def _check_loaded(self, what: str) -> None:
        if len(self.seq) == 0 or len(self.seq) != self.seqlen:
            raise PwasmError(
                f"GapSeq {what} Error: invalid sequence data '{self.name}' "
                f"(len={len(self.seq)}, seqlen={self.seqlen})\n")

    def print_gapped_fasta(self, f) -> None:
        """ACE-style gapped sequence, '*' gaps, 60-col wrap
        (GASeq::printGappedFasta, GapAssem.cpp:442-480; the exact-multiple
        trailing blank line is preserved)."""
        self._check_loaded("print")
        out = []
        printed = 0
        for i in range(self.seqlen):
            g = int(self.gaps[i])
            if g < 0:
                continue
            for _ in range(g):
                out.append("*")
                printed += 1
                if printed == 60:
                    out.append("\n")
                    printed = 0
            printed += 1
            if printed == 60:
                out.append(chr(self.seq[i]) + "\n")
                printed = 0
            else:
                out.append(chr(self.seq[i]))
        if printed < 60:
            out.append("\n")
        f.write("".join(out))

    def print_mfasta(self, f, llen: int = 60) -> None:
        """Offset-padded multifasta record (GASeq::printMFasta,
        GapAssem.cpp:482-520)."""
        self._check_loaded("print")
        if self.descr:
            f.write(f">{self.name} {self.descr}\n")
        else:
            f.write(f">{self.name}\n")
        out = []
        printed = 0

        def put(ch: str):
            nonlocal printed
            printed += 1
            if printed == llen:
                out.append(ch + "\n")
                printed = 0
            else:
                out.append(ch)

        for _ in range(self.offset):
            put("-")
        for i in range(self.seqlen):
            g = int(self.gaps[i])
            if g < 0:
                continue
            for _ in range(g):
                put("-")
            put(chr(self.seq[i]))
        if printed < llen:
            out.append("\n")
        f.write("".join(out))


def refine_clipping_all(seqs: list[GapSeq], cons: bytes, cposes: list[int],
                        skip_dels: bool = False) -> None:
    """The refineMSA member loop (GapAssem.cpp:1169-1180): each member
    with clipped ends re-aligned against the consensus by the scalar
    walk, one member after another."""
    for s, cpos in zip(seqs, cposes):
        if s.clp5 or s.clp3:
            s.refine_clipping_scalar(cons, cpos, skip_dels=skip_dels)
