"""MSA container: progressive merging, gap propagation, consensus, writers.

Equivalent of the reference's GSeqAlign + MSAColumns + GAlnColumn
(GapAssem.h:255-461, GapAssem.cpp:593-1367).  Differences in mechanism (not
behavior):

- Pileup counts are a single (columns, 6) int32 tensor instead of
  per-column count objects: the consensus kernel counts them, and votes,
  over the (rows, columns) int8 code pileup (``pileup_matrix``).
- The per-member position walks (injectGap/removeColumn/evalClipping) use
  prefix sums + binary search over the same monotone walk positions.
- The consensus vote implements bestChar's stable-sort + '-'/'N' yield rule
  (GapAssem.cpp:1048-1069, quirk SURVEY.md §2.5.10) as a closed-form rule
  over the 6 counts (``ops/consensus.py``).
"""

from __future__ import annotations

import sys
import time
from typing import IO

import numpy as np

from pwasm_tpu_torch.align.gapseq import FLAG_BAD_ALN, FLAG_PREPPED, GapSeq
from pwasm_tpu_torch.core.errors import PwasmError, ZeroCoverageError

# column buckets, exactly this order (GapAssem.h:257-264)
NUC_ORDER = b"ACGTN-"
_BUCKET = np.full(256, 4, dtype=np.int8)  # default: N bucket
for _i, _c in enumerate(b"ACGT"):
    _BUCKET[_c] = _i
    _BUCKET[_c + 32] = _i  # lowercase
_BUCKET[ord("-")] = 5
_BUCKET[ord("*")] = 5


def _rank_by_column(cols: np.ndarray, codes: np.ndarray):
    """Sort (column, code) contributions by column and rank each
    contribution within its column: returns (sorted_cols, sorted_codes,
    occurrence_rank) where rank 0 is a column's first occupant."""
    order = np.argsort(cols, kind="stable")
    sc = cols[order]
    occ = np.arange(len(sc)) - np.searchsorted(sc, sc, side="left")
    return sc, codes[order], occ


def device_counts_votes(pile: np.ndarray, device):
    """Counts + votes for a (rows, cols) int8 code pileup (codes 0..6)
    on ``device`` (a ``torch.device``): the CUDA consensus kernel for a
    CUDA device, its plain torch version on the CPU
    (``ops.consensus.consensus_counts_votes``).  Returns ``(chars (cols,)
    int64 — vote character codes, 0 = zero coverage; counts (cols, 6)
    int32)``."""
    import torch

    from pwasm_tpu_torch.ops.consensus import consensus_counts_votes

    votes, counts = consensus_counts_votes(
        torch.from_numpy(np.ascontiguousarray(pile)).to(device))
    v = votes.cpu().numpy()
    counts = counts.cpu().numpy()
    table = np.frombuffer(NUC_ORDER, dtype=np.uint8)
    chars = np.zeros(len(v), dtype=np.int64)
    valid = v >= 0
    chars[valid] = table[v[valid]]
    return chars, counts


class MsaColumns:
    """Column pileup: (size, 6) count tensor + live [mincol, maxcol] window
    (reference MSAColumns, GapAssem.h:345-376).  ``layers`` counts every
    contribution including gaps; clipped bases contribute only a witness
    flag (GAlnColumn::addNuc clipped path, GapAssem.h:299-308)."""

    def __init__(self, size: int, baseoffset: int = 0):
        self.size = size
        self.baseoffset = baseoffset
        self.counts = np.zeros((size, 6), dtype=np.int32)
        self.layers = np.zeros(size, dtype=np.int32)
        self.has_clip = np.zeros(size, dtype=bool)
        self.mincol = np.iinfo(np.int64).max
        self.maxcol = 0

    def update_min_max(self, minc: int, maxc: int) -> None:
        if minc < self.mincol:
            self.mincol = minc
        if maxc > self.maxcol:
            self.maxcol = maxc

    def len(self) -> int:
        return self.maxcol - self.mincol + 1


class Msa:
    """A multiple sequence alignment (reference GSeqAlign)."""

    def __init__(self, s1: GapSeq | None = None, s2: GapSeq | None = None):
        self.seqs: list[GapSeq] = []
        self.length = 0
        self.minoffset = 0
        self.ng_len = 0
        self.ng_minofs = 0
        self.ordnum = 0
        self.badseqs = 0
        self.consensus = bytearray()
        self.msacolumns: MsaColumns | None = None
        self._vote_chars: np.ndarray | None = None
        self.refined = False
        if s1 is not None and s2 is not None:
            s1.msa = self
            s2.msa = self
            self.seqs = [s1, s2]
            self.minoffset = min(s1.offset, s2.offset)
            self.ng_minofs = self.minoffset
            self.length = max(s1.end_offset(), s2.end_offset()) - self.minoffset
            self.ng_len = max(s1.end_ng_offset(), s2.end_ng_offset()) \
                - self.ng_minofs

    def count(self) -> int:
        return len(self.seqs)

    # ---- membership / offsets ------------------------------------------
    def add_seq(self, s: GapSeq, soffs: int, ngofs: int) -> None:
        """(GSeqAlign::addSeq, GapAssem.cpp:694-716)"""
        s.offset = soffs
        s.ng_ofs = ngofs
        s.msa = self
        self.seqs.append(s)
        if soffs < self.minoffset:
            self.length += self.minoffset - soffs
            self.minoffset = soffs
        if ngofs < self.ng_minofs:
            self.ng_len += self.ng_minofs - ngofs
            self.ng_minofs = ngofs
        if s.end_offset() - self.minoffset > self.length:
            self.length = s.end_offset() - self.minoffset
        if s.end_ng_offset() - self.ng_minofs > self.ng_len:
            self.ng_len = s.end_ng_offset() - self.ng_minofs

    # ---- gap propagation -----------------------------------------------
    def _alpos_of(self, seq: GapSeq, pos: int) -> int:
        """Layout position of seq[pos]
        (the alpos computation, GapAssem.cpp:721-725)."""
        return seq.offset + pos + int(np.sum(seq.gaps[:pos + 1]))

    def inject_gap(self, seq: GapSeq, pos: int, xgap: int) -> None:
        """Propagate a gap in ``seq`` at ``pos`` through every member
        (GSeqAlign::injectGap, GapAssem.cpp:720-753)."""
        alpos = self._alpos_of(seq, pos)
        for s in self.seqs:
            if s is seq:
                spos = pos
            else:
                if s.offset >= alpos:
                    s.offset += xgap
                    continue
                spos = s.find_walk_pos(alpos)
                if spos >= s.seqlen:
                    continue
            s.add_gap(spos, xgap)
        self.length += xgap

    def remove_column(self, column: int) -> None:
        """Delete one layout column from every member
        (GSeqAlign::removeColumn, GapAssem.cpp:755-779)."""
        alpos = column + self.minoffset
        for s in self.seqs:
            if s.offset >= alpos:
                s.offset -= 1
                continue
            spos = s.find_walk_pos(alpos)
            if spos >= s.seqlen:
                continue
            s.remove_base(spos)
        self.length -= 1

    # ---- merging --------------------------------------------------------
    def add_align(self, seq: GapSeq, omsa: "Msa", oseq: GapSeq) -> bool:
        """Merge ``omsa`` into this MSA through the shared sequence
        ``seq``/``oseq`` (same id/length), propagating gap differences both
        ways (GSeqAlign::addAlign, GapAssem.cpp:645-690)."""
        if seq.seqlen != oseq.seqlen:
            raise PwasmError(
                f"GSeqAlign Error: invalid merge {seq.name}"
                f"(len {seq.seqlen}) vs {oseq.name}(len {oseq.seqlen})\n")
        if seq.revcompl != oseq.revcompl:
            omsa.rev_complement()
        for i in range(seq.seqlen):
            d = seq.gap(i) - oseq.gap(i)
            if d > 0:
                omsa.inject_gap(oseq, i, d)
            elif d < 0:
                self.inject_gap(seq, i, -d)
        for s in omsa.seqs:
            if s is oseq:
                continue
            self.add_seq(s, seq.offset + s.offset - oseq.offset,
                         seq.ng_ofs + s.ng_ofs - oseq.ng_ofs)
        return True

    def rev_complement(self) -> None:
        """(GSeqAlign::revComplement, GapAssem.cpp:998-1004)"""
        for s in self.seqs:
            s.rev_complement(self.length)
        self.seqs.sort(key=lambda s: s.offset)

    def finalize(self) -> None:
        """prepSeq every member (GSeqAlign::finalize,
        GapAssem.cpp:1006-1012)."""
        for s in self.seqs:
            if len(s.seq) == 0:
                raise PwasmError(
                    f"Error: sequence for {s.name} not loaded!\n")
            if not s.has_flag(FLAG_PREPPED):
                s.prep_seq()

    # ---- pileup / consensus --------------------------------------------
    def _column_geometry(self, s: GapSeq):
        """Shared layout math for the pileup renderers: returns
        (base_cols, unclipped mask, gap-run columns before unclipped
        bases).  ``base_cols[i]`` is the layout column of base i under the
        walk semantics (1 + gap per base; negative gaps collapse deleted
        bases onto their neighbor's column).

        Post-deletion placement is a repo-defined extension: this walk
        follows the reference's *salpos* accumulation (cumsum of 1+gap,
        so a negative gap pulls the deleted base's successors left),
        NOT its GASeq::toMSA gap loop (GapAssem.cpp:569-588), which
        advances ``max(ofs,0)+1`` and never pulls back.  The two agree
        everywhere the reference can actually reach (buildMSA runs once,
        before any removal); after a library-level remove_base the
        reference has no defined behavior, and host, device, and the
        native C++ engine all implement THIS semantics and are verified
        mutually exact."""
        if len(s.seq) == 0 or len(s.seq) != s.seqlen:
            raise PwasmError(
                f"GapSeq toMSA Error: invalid sequence data '{s.name}' "
                f"(len={len(s.seq)}, seqlen={s.seqlen})\n")
        clipL, clipR = s.clip_lr()
        gaps = s.gaps.astype(np.int64)
        base_cols = (s.offset - self.minoffset
                     + np.arange(s.seqlen, dtype=np.int64) + np.cumsum(gaps))
        idx = np.arange(s.seqlen)
        unclipped = ~((idx < clipL) | (idx >= s.seqlen - clipR))
        gmask = unclipped & (gaps > 0)
        if gmask.any():
            gcols = np.concatenate(
                [np.arange(base_cols[i] - gaps[i], base_cols[i])
                 for i in np.nonzero(gmask)[0]])
        else:
            gcols = np.empty(0, dtype=np.int64)
        # a deleted base can collapse its neighbors' columns off the left
        # edge of the layout (library-level remove_base on the leftmost
        # member).  Counting such a layout is meaningless on BOTH the
        # host scatter path (numpy would wrap the negative index) and
        # the device pileup — refuse loudly instead of drifting.
        live_min = base_cols[unclipped].min() if unclipped.any() else 0
        if live_min < 0 or (len(gcols) and gcols.min() < 0):
            raise PwasmError(
                f"MSA layout error: sequence {s.name} has contributions "
                "outside the layout (stranded deleted base)\n")
        return base_cols, unclipped, gcols

    def _seq_geometry(self, s: GapSeq, cols: MsaColumns) -> None:
        """The geometry side effects of pouring one sequence into the
        column pileup (GASeq::toMSA, GapAssem.cpp:551-591): clip witnesses
        and the live window.  The counts come from the consensus launch
        over ``pileup_matrix()`` (see build_msa)."""
        base_cols, unclipped, _gcols = self._column_geometry(s)
        gaps = s.gaps.astype(np.int64)
        clipped = ~unclipped
        # clip-region deletions may push clipped columns off the layout
        # edge; they carry no counts, so drop (not wrap) their witnesses
        ccols = base_cols[clipped]
        cols.has_clip[ccols[(ccols >= 0) & (ccols < cols.size)]] = True
        # min/max over the unclipped span: mincol includes the gap run
        # before the first unclipped base (GapAssem.cpp:565-590)
        if unclipped.any():
            first = int(np.argmax(unclipped))
            last = s.seqlen - 1 - int(np.argmax(unclipped[::-1]))
            mincol = int(base_cols[first] - max(int(gaps[first]), 0))
            maxcol = int(base_cols[last])
            cols.update_min_max(mincol, maxcol)

    def pileup_matrix(self) -> np.ndarray:
        """Render the MSA as a (rows, length) int8 code matrix for the
        device consensus path: A0 C1 G2 T3 N4, gap columns 5, and 6 (the
        kernels' PAD_CODE) where a row contributes nothing.  Device pileup
        counts over this matrix equal the CPU column counts bit-for-bit.

        Rows 0..depth-1 are the members.  With deleted bases (negative
        gaps, created by remove_column/remove_base during refinement) the
        cumsum layout collapses dead bases onto neighboring columns, so
        one member can contribute MORE than one symbol to a column — the
        host scatter-add counts them all (matching the engine's walk
        semantics; this post-deletion placement is a repo-defined
        extension, see _column_geometry).  A one-symbol-per-cell matrix
        can't hold that in the member's own row, so the extra occupants
        spill onto appended rows: counts are a sum over rows, so the
        device reduction stays exact with any row assignment.  Pre-refine
        (no deletions) there are no collisions and the matrix is exactly
        the historical (depth, length) form.

        Layouts whose contributions fall outside [0, length) — possible
        via library-level remove_base calls that strand a deleted base
        before the first live column — raise PwasmError from the shared
        geometry (such a layout is uncountable on the host scatter path
        too)."""
        mat = np.full((len(self.seqs), self.length), 6, dtype=np.int8)
        spill_cols: list[np.ndarray] = []
        spill_codes: list[np.ndarray] = []
        for k, s in enumerate(self.seqs):
            base_cols, unclipped, gcols = self._column_geometry(s)
            codes = _BUCKET[np.frombuffer(bytes(s.seq), dtype=np.uint8)]
            if not (s.gaps < 0).any():
                # fast path (pre-refine, the device hot path): gap runs
                # and base columns are disjoint — direct scatter
                if len(gcols):
                    mat[k, gcols] = 5
                mat[k, base_cols[unclipped]] = codes[unclipped]
                continue
            cols_all = np.concatenate([gcols, base_cols[unclipped]])
            codes_all = np.concatenate(
                [np.full(len(gcols), 5, dtype=np.int8), codes[unclipped]])
            sc, scd, occ = _rank_by_column(cols_all, codes_all)
            mat[k, sc[occ == 0]] = scd[occ == 0]
            if (occ > 0).any():
                spill_cols.append(sc[occ > 0])
                spill_codes.append(scd[occ > 0])
        if spill_cols:
            # pack spills across members: row r carries every column's
            # (r+1)-th excess occupant, so the row count is bounded by
            # the worst per-column collision depth, not the member count
            sc, scd, occ = _rank_by_column(np.concatenate(spill_cols),
                                           np.concatenate(spill_codes))
            rows = np.full((int(occ.max()) + 1, self.length), 6,
                           dtype=np.int8)
            rows[occ, sc] = scd
            mat = np.concatenate([mat, rows], axis=0)
        return mat

    def build_msa(self, device) -> None:
        """(GSeqAlign::buildMSA, GapAssem.cpp:1088-1106).  The column
        counts and the consensus votes come from one consensus launch over
        ``pileup_matrix()`` on ``device`` (a ``torch.device``;
        ops.consensus.consensus_counts_votes — the device form of
        toMSA+bestChar, GapAssem.cpp:1088-1106 / 1048-1069); the host
        keeps only the geometry side effects (live window, clip
        witnesses, bad-trim flags)."""
        if self.msacolumns is not None:
            raise PwasmError("Error: cannot call buildMSA() twice!\n")
        # deleted bases are handled via spill rows in pileup_matrix; a
        # stranded-deleted-base layout raises from the shared geometry
        pile = self.pileup_matrix()
        self.msacolumns = MsaColumns(self.length, self.minoffset)
        for i, s in enumerate(self.seqs):
            s.msaidx = i
            if s.seqlen - s.clp3 - s.clp5 < 1:
                print(f"Warning: sequence {s.name} (length {s.seqlen}) was "
                      f"trimmed too badly ({s.clp5},{s.clp3}) -- should be "
                      f"removed from MSA w/ {self.seqs[0].name}!",
                      file=sys.stderr)
                s.set_flag(FLAG_BAD_ALN)
                self.badseqs += 1
            self._seq_geometry(s, self.msacolumns)
        chars, counts = device_counts_votes(pile, device)
        self.msacolumns.counts[:] = counts
        self.msacolumns.layers[:] = counts.sum(axis=1, dtype=np.int32)
        self._vote_chars = chars

    def _err_zero_cov(self, col: int) -> None:
        """(GSeqAlign::ErrZeroCov, GapAssem.cpp:1121-1131; exit 5)"""
        print(f"WARNING: 0 coverage column {col} "
              f"(mincol={self.msacolumns.mincol}) found within alignment "
              f"of {self.count()} seqs!", file=sys.stderr)
        for s in self.seqs:
            print(s.name, file=sys.stderr)
        raise ZeroCoverageError(f"zero-coverage column {col}")

    def refine_msa(self, device, remove_cons_gaps: bool = True,
                   refine_clipping: bool = True,
                   times: dict | None = None) -> None:
        """Consensus construction + clipping refinement
        (GSeqAlign::refineMSA, GapAssem.cpp:1133-1183) on ``device`` (a
        ``torch.device``): the column counts and the votes come from one
        consensus launch over the pileup tensor (see build_msa), and the
        clip refinement runs there too.  The two flags are the
        reference's MSAColumns statics; pafreport runs with
        remove_cons_gaps=False (SURVEY.md §2.5.8).  ``times``
        accumulates the ``consensus`` and ``refine`` stage seconds."""
        t0 = time.perf_counter()
        self.build_msa(device)
        cols = self.msacolumns
        votes = self._vote_chars[cols.mincol:cols.maxcol + 1]
        cols_removed = 0
        consensus = bytearray()
        for col in range(cols.mincol, cols.maxcol + 1):
            c = int(votes[col - cols.mincol])
            if c == 0:
                self._err_zero_cov(col)
            if c in (ord("-"), ord("*")):
                if remove_cons_gaps:
                    self.remove_column(col - cols_removed)
                    cols_removed += 1
                    continue
                c = ord("*")
            consensus.append(c)
        self.consensus = consensus
        t1 = time.perf_counter()
        # X-drop clipping refinement: one 2-D pass over all members
        # (refineMSA's member loop, GapAssem.cpp:1169-1180; members are
        # independent given the fixed consensus, so batching is exact)
        from pwasm_tpu_torch.align.gapseq import refine_clipping_batch

        def _cpos(s):
            return s.offset - self.minoffset - cols.mincol

        if refine_clipping:
            refine_clipping_batch(
                self.seqs, bytes(self.consensus),
                [_cpos(s) for s in self.seqs], device)
        second: list = []
        for s in self.seqs:
            grem = s.remove_clip_gaps() if remove_cons_gaps else 0
            if grem != 0 and refine_clipping:
                second.append(s)
        if second:
            refine_clipping_batch(
                second, bytes(self.consensus),
                [_cpos(s) for s in second], device, skip_dels=True)
        self.refined = True
        if times is not None:
            times["consensus"] = times.get("consensus", 0.0) + t1 - t0
            times["refine"] = times.get("refine", 0.0) \
                + time.perf_counter() - t1

    # ---- output ---------------------------------------------------------
    def _need_refined(self, what: str) -> None:
        if not self.refined:
            raise PwasmError(f"{what} requires refine_msa() first\n")

    def print_layout(self, f: IO[str], sep: str = "") -> None:
        """Debug layout view (GSeqAlign::print, GapAssem.cpp:1013-1037)."""
        self.finalize()
        width = max((len(s.name) for s in self.seqs), default=0)
        if sep:
            f.write(f"{'':>{width}}   " + sep * self.length + "\n")
        for s in self.seqs:
            orientation = "-" if s.revcompl == 1 else "+"
            f.write(f"{s.name:>{width}} {orientation} ")
            s.print_gapped_seq(f, self.minoffset)

    def write_msa(self, f: IO[str], linelen: int = 60) -> None:
        """Multifasta MSA (GSeqAlign::writeMSA, GapAssem.cpp:1039-1046)."""
        self.finalize()
        for s in self.seqs:
            s.print_mfasta(f, linelen)

    def write_ace(self, f: IO[str], name: str) -> None:
        """ACE contig output (GSeqAlign::writeACE, GapAssem.cpp:1200-1262)
        of a refined MSA."""
        self._need_refined("write_ace")
        fwd = sum(1 for s in self.seqs if s.revcompl == 0)
        rvs = self.count() - fwd
        cons_dir = "C" if rvs > fwd else "U"
        f.write(f"CO {name} {len(self.consensus)} {self.count()} 0 "
                f"{cons_dir}\n")
        cons = self.consensus.decode("ascii", "replace")
        for i in range(0, len(cons), 60):
            f.write(cons[i:i + 60] + "\n")
        f.write("\nBQ \n\n")
        mincol = self.msacolumns.mincol
        for s in self.seqs:
            sc = "U" if s.revcompl == 0 else "C"
            f.write(f"AF {s.name} {sc} "
                    f"{s.offset - self.minoffset - mincol + 1}\n")
        f.write("\n")
        for s in self.seqs:
            gapped_len = s.seqlen + s.numgaps
            f.write(f"RD {s.name} {gapped_len} 0 0\n")
            s.print_gapped_fasta(f)
            clpl, clpr = s.clip_lr()
            l, r = clpl, clpr
            for j in range(1, r + 1):
                clpr += int(s.gaps[s.seqlen - j])
            for j in range(l + 1):
                clpl += int(s.gaps[j])
            seql = clpl + 1
            seqr = gapped_len - clpr
            if seqr < seql:
                print(f"Bad trimming for {s.name} of gapped len "
                      f"{gapped_len} ({seql}, {seqr})", file=sys.stderr)
                seqr = seql + 1
            f.write(f"\nQA {seql} {seqr} {seql} {seqr}\nDS \n\n")

    def write_cons(self, f: IO[str], name: str, linelen: int = 60) -> None:
        """Consensus sequence of a refined MSA as FASTA ('*' marks kept
        all-gap columns)."""
        self._need_refined("write_cons")
        cons = self.consensus.decode("ascii", "replace")
        f.write(f">{name}_cons {self.count()} seqs\n")
        for i in range(0, len(cons), linelen):
            f.write(cons[i:i + linelen] + "\n")

    def write_info(self, f: IO[str], name: str) -> None:
        """Contig-info output of a refined MSA, with per-seq pid and
        run-length alndata (GSeqAlign::writeInfo, GapAssem.cpp:1264-1367).

        Parity notes (we mirror the code, not the comments):
        - the reference's comment documents alndata as '5g4d2g2-30d12g'
          (offsets before every indel) but the code only emits the
          '<ofs><type><len>-' form for indels longer than 2; short indels
          emit bare type characters (GapAssem.cpp:1337-1344);
        - ``asml``/``asmr`` carry a double '+1' (GapAssem.cpp:1305-1307),
          so the pid comparison reads the consensus shifted one column
          right of the sequence — pid is systematically understated
          (usually 0 for perfect alignments)."""
        self._need_refined("write_info")
        cons = self.consensus.decode("ascii", "replace")
        f.write(f">{name} {self.count()} {cons}\n")
        mincol = self.msacolumns.mincol
        for s in self.seqs:
            gapped_len = s.seqlen + s.numgaps
            seqoffset = s.offset - self.minoffset - mincol + 1
            clpl, clpr = s.clip_lr()
            asml = seqoffset + 1
            asmr = asml - 1
            pid = 0.0
            aligned_len = 0
            indel_ofs = 0
            alndata: list[str] = []
            for j in range(s.clp5, s.seqlen - s.clp3):
                indel = int(s.gaps[j])
                indel_type = ""
                asmr += indel + 1
                if indel < 0:
                    indel_type = "d"
                    indel = -indel
                else:
                    if indel > 0:
                        indel_type = "g"
                    else:
                        indel_ofs += 1
                    if (0 <= asmr - 1 < len(cons)
                            and chr(s.seq[j]).upper()
                            == cons[asmr - 1].upper()):
                        pid += 1
                    aligned_len += 1
                if indel_type:
                    if indel > 2:
                        alndata.append(f"{indel_ofs}{indel_type}{indel}-")
                    else:
                        alndata.append(indel_type * indel)
                    indel_ofs = 0
            pid = (pid * 100.0) / aligned_len if aligned_len else 0.0
            seql = clpl + 1
            seqr = len(s.seq) - clpr
            if seqr < seql:
                print(f"WARNING: Bad trimming for {s.name} of gapped len "
                      f"{gapped_len} ({seql}, {seqr})", file=sys.stderr)
                seqr = seql + 1
            if s.revcompl:
                seql, seqr = seqr, seql
            f.write(f"{s.name} {len(s.seq)} {seqoffset} {asml} {asmr} "
                    f"{seql} {seqr} {pid:4.2f} {''.join(alndata)}\n")

