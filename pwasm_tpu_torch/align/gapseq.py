"""Gapped sequence model.

Equivalent of the reference's GASeq (GapAssem.h:35-138, GapAssem.cpp:27-591):
a sequence plus a per-base gap array ``gaps[i]`` = number of gap columns
*before* base ``i`` in the MSA layout; a negative value marks the base
itself as deleted.  Offsets position the sequence in the layout.

The gap array is a numpy int32 tensor, so layout positions are prefix sums
(`layout_walk_positions`) rather than the reference's O(pos) walks — the
same math the device kernels use.
"""

from __future__ import annotations

import sys

import numpy as np

from pwasm_tpu_torch.core.dna import revcomp
from pwasm_tpu_torch.core.errors import PwasmError

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

    def clear_flag(self, bit: int) -> None:
        """Toggles ``bit`` (``flags ^= 1 << bit``), as the reference's
        does: a bit that is not set becomes set."""
        self.flags ^= 1 << bit

    def has_flag(self, bit: int) -> bool:
        return (self.flags >> bit) & 1 != 0

    # ---- basic ops ------------------------------------------------------
    def __repr__(self):
        return (f"GapSeq({self.name!r}, len={self.seqlen}, "
                f"offset={self.offset}, gaps={self.numgaps})")

    def reverse_complement_bases(self) -> None:
        """RC the base string only (FastaSeq::reverseComplement)."""
        self.seq = bytearray(revcomp(bytes(self.seq)))

    def allupper(self) -> None:
        self.seq = bytearray(bytes(self.seq).upper())

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
        self.numgaps -= int(self.gaps[pos])
        self.gaps[pos] = gaplen
        self.numgaps += gaplen

    def add_gap(self, pos: int, gapadd: int) -> None:
        """Extend the gap before ``pos`` (GapAssem.cpp:113-120)."""
        if pos < 0 or pos >= self.seqlen:
            raise PwasmError(
                f"Error: invalid gap position ({pos + 1}) given for "
                f"sequence {self.name}\n")
        self.numgaps += gapadd
        self.gaps[pos] += gapadd

    def remove_base(self, pos: int) -> None:
        """Remove one layout column at ``pos``: a gap if one exists, else
        the base itself (gap count goes negative = deleted base;
        GapAssem.cpp:122-180)."""
        if pos < 0 or pos >= self.seqlen:
            raise PwasmError(
                f"Error: invalid gap position ({pos + 1}) given for "
                f"sequence {self.name}\n")
        self.gaps[pos] -= 1
        self.numgaps -= 1

    # ---- layout math ----------------------------------------------------
    def layout_walk_positions(self) -> np.ndarray:
        """W[j] = layout position one past base j, i.e. the reference's
        ``salpos`` after processing position j in its walk loops
        (GapAssem.cpp:739-744).  The first j with W[j] > alpos is the walk's
        stopping position.  Monotone nondecreasing, so searchsorted replaces
        the O(pos) walk."""
        return self.offset + np.cumsum(1 + self.gaps.astype(np.int64))

    def find_walk_pos(self, alpos: int) -> int:
        """First position j with W[j] > alpos (== reference walk result);
        returns seqlen if the walk runs off the end."""
        w = self.layout_walk_positions()
        return int(np.searchsorted(w, alpos, side="right"))

    # ---- gap/strand transforms -----------------------------------------
    def reverse_gaps(self) -> None:
        """Reverse the gap array in place, keeping index 0 fixed
        (GapAssem.cpp:351-364 — 'shifted by 1 because the first ofs is
        always 0')."""
        if self.seqlen > 1:
            self.gaps[1:] = self.gaps[1:][::-1]

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
        self.numgaps -= delgaps_l + delgaps_r
        return delgaps_l + delgaps_r

    # ---- X-drop end re-alignment ---------------------------------------
    XDROP = -16
    MATCH_SC = 1
    MISMATCH_SC = -3

    def refine_clipping(self, cons: bytes, cpos: int, device,
                        skip_dels: bool = False) -> None:
        """Re-align the clipped ends against the consensus with an X-drop
        extension, updating clp5/clp3 (GASeq::refineClipping,
        GapAssem.cpp:182-349).  ``cpos`` is this sequence's start column
        on the consensus.  Runs ``refine_clipping_batch`` with this one
        member on ``device`` (a ``torch.device``): one program serves
        the member and the whole MSA."""
        refine_clipping_batch([self], cons, [cpos], device,
                              skip_dels=skip_dels)

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

    def print_gapped_seq(self, f, baseoffs: int = 0) -> None:
        """Debug layout line (GASeq::printGappedSeq, GapAssem.cpp:412-440)."""
        self._check_loaded("print")
        clipL, clipR = self.clip_lr()
        out = [" " * (self.offset - baseoffs)]
        for i in range(self.seqlen):
            g = int(self.gaps[i])
            if g < 0:
                continue  # deleted base
            out.append("-" * g)
            c = chr(self.seq[i])
            if i < clipL or i >= self.seqlen - clipR:
                c = c.lower()
            out.append(c)
        f.write("".join(out) + "\n")

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


# ---------------------------------------------------------------------------
# batched X-drop clipping refinement: all MSA members in ONE 2-D pass
# ---------------------------------------------------------------------------
def refine_clipping_batch(seqs: list[GapSeq], cons: bytes,
                          cposes: list[int], device,
                          skip_dels: bool = False,
                          supervisor=None) -> None:
    """Refine the clipped ends of MANY members against the consensus in
    one vectorized pass (the refineMSA member loop,
    GapAssem.cpp:1133-1183, flattened into (members, layout) tensors).

    Per member this is the reference's refineClipping program (same
    initial-match seek, same X-drop extension, same clip-bump and abort
    semantics).  The host builds the padded (members, layout) tensors;
    the two phases run as one dense torch program on ``device`` (a
    ``torch.device``, or a mesh the members shard over;
    ops/refine_clip.py); the host writes the clips
    back.  Members with no clips are skipped outright (the common case
    costs nothing).  ``supervisor`` supervises the device dispatch
    (``ops/refine_clip.py::refine_phases``).
    """
    sel = [i for i, s in enumerate(seqs) if s.clp5 or s.clp3]
    if not sel:
        return
    cons_arr = np.frombuffer(cons, dtype=np.uint8)
    star = ord("*")
    M = len(sel)
    XDROP = GapSeq.XDROP
    MATCH_SC = GapSeq.MATCH_SC
    MISMATCH_SC = GapSeq.MISMATCH_SC

    # --- per-member gapped layout build (ragged -> padded 2-D) ----------
    # NB two different lengths per member, exactly like the 1-D pass:
    # ``glen`` is the REFERENCE walk length (seqlen + numgaps, plus the
    # clip-kept deletions under skip_dels — GapAssem.cpp:243) used for
    # every bound, while ``totals`` is the actual rendered layout array
    # length used for index validity; doubly-deleted bases (gap <= -2)
    # make them differ.
    glen = np.zeros(M, dtype=np.int64)
    totals = np.zeros(M, dtype=np.int64)
    gclipL = np.zeros(M, dtype=np.int64)
    gclipR = np.zeros(M, dtype=np.int64)
    clipL0 = np.zeros(M, dtype=np.int64)
    clipR0 = np.zeros(M, dtype=np.int64)
    seqlens = np.zeros(M, dtype=np.int64)
    cpos = np.asarray([cposes[i] for i in sel], dtype=np.int64)
    rows = []
    xrows = []
    for k, i in enumerate(sel):
        s = seqs[i]
        g = s.gaps.astype(np.int64)
        cl, cr = s.clip_lr()
        clipL0[k], clipR0[k] = cl, cr
        seqlens[k] = s.seqlen
        glen0 = s.seqlen + s.numgaps
        allocsize = glen0
        gl, gr = cl, cr
        if skip_dels:
            right = g[s.seqlen - cr:] if cr else g[:0]
            left = g[:cl]
            allocsize += int((right < 0).sum()) + int((left < 0).sum())
            gr += int(right[right >= 0].sum())
            gl += int(left[left >= 0].sum())
            in_clip = np.zeros(s.seqlen, dtype=bool)
            if cl:
                in_clip[:cl] = True
            if cr:
                in_clip[s.seqlen - cr:] = True
            include = (g >= 0) | in_clip
        else:
            gr += int(g[s.seqlen - cr:].sum()) if cr else 0
            gl += int(g[:cl].sum())
            include = g >= 0
        gclipL[k], gclipR[k] = gl, gr
        glen[k] = glen0 + int((include & (g < 0)).sum())
        if glen[k] != allocsize:
            raise PwasmError(
                f"Length mismatch (allocsize {allocsize} vs. glen "
                f"{glen[k]}) while refineClipping for seq {s.name} !\n")
        stars = np.maximum(g, 0)
        counts = stars + include
        ends = np.cumsum(counts)
        total = int(ends[-1]) if s.seqlen else 0
        totals[k] = total
        gseq = np.full(total, star, dtype=np.uint8)
        gxpos = np.full(total, -1, dtype=np.int64)
        seq_arr = np.frombuffer(bytes(s.seq), dtype=np.uint8)
        base_idx = (ends - 1)[include]
        gseq[base_idx] = seq_arr[include]
        gxpos[base_idx] = np.nonzero(include)[0]
        rows.append(gseq)
        xrows.append(gxpos)
    L = max(1, int(totals.max()))
    gseq2 = np.full((M, L), star, dtype=np.uint8)
    gxpos2 = np.full((M, L), -1, dtype=np.int64)
    for k in range(M):
        gseq2[k, :totals[k]] = rows[k]
        gxpos2[k, :totals[k]] = xrows[k]

    from pwasm_tpu_torch.ops.refine_clip import refine_phases
    clipL, clipR, missR, missL = refine_phases(
        gseq2, gxpos2, cons_arr, cpos, glen, totals, gclipL, gclipR,
        clipL0, clipR0, seqlens, XDROP, MATCH_SC, MISMATCH_SC,
        device=device, supervisor=supervisor)
    for km in np.nonzero(missR)[0]:
        print(f"Warning: reached clipL trying to find an "
              f"initial match on {seqs[sel[km]].name}!", file=sys.stderr)
    for km in np.nonzero(missL)[0]:
        print(f"Warning: reached clipR trying to find an "
              f"initial match on {seqs[sel[km]].name}!", file=sys.stderr)
    # write back (strand-aware aliasing, GapAssem.cpp:188-189)
    _write_back_clips(seqs, sel, clipL, clipR)


def _write_back_clips(seqs, sel, clipL, clipR) -> None:
    for k, i in enumerate(sel):
        s = seqs[i]
        if s.revcompl:
            s.clp3, s.clp5 = int(clipL[k]), int(clipR[k])
        else:
            s.clp5, s.clp3 = int(clipL[k]), int(clipR[k])
