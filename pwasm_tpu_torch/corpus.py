"""Synthetic minimap2-style PAF corpora, made from a seed.

A copy of the reference repository's realistic-scale corpus generator
(``make_corpus``) and the PAF synthesizer it rides on, so that the port's
smoke run can build the same corpus without the reference's tests.
The same seed gives the same PAF lines.

Alignment ops (in alignment orientation, query side = the ``-r`` FASTA):
  ("=", n)        n matching bases
  ("*", t, q)     substitution: target base t, query base q
  ("ins", bases)  bases present only in the target  (cs '-', cigar D)
  ("del", n)      n query bases absent from the target (cs '+', cigar I)
"""

from __future__ import annotations

import numpy as np

from pwasm_tpu_torch.core.dna import revcomp

BASES = np.array(list(b"ACGT"), dtype=np.uint8)


def synth_alignment(q_aln: str, ops) -> tuple[str, str, str]:
    """Apply ops to the aligned query slice (alignment orientation,
    upper-case); return (cs, cigar, target_seq)."""
    cs_parts = []
    cig_parts = []
    tseq = []
    qpos = 0

    def cig(n, op):
        if cig_parts and cig_parts[-1][1] == op:
            cig_parts[-1] = (cig_parts[-1][0] + n, op)
        else:
            cig_parts.append((n, op))

    for op in ops:
        kind = op[0]
        if kind == "=":
            n = op[1]
            cs_parts.append(f":{n}")
            tseq.append(q_aln[qpos:qpos + n])
            qpos += n
            cig(n, "M")
        elif kind == "*":
            t, q = op[1].lower(), op[2].lower()
            if q_aln[qpos].lower() != q:
                raise ValueError("op mismatch vs q_aln")
            cs_parts.append(f"*{t}{q}")
            tseq.append(t.upper())
            qpos += 1
            cig(1, "M")
        elif kind == "ins":
            bases = op[1].lower()
            cs_parts.append("-" + bases)
            tseq.append(bases.upper())
            cig(len(bases), "D")
        elif kind == "del":
            n = op[1]
            cs_parts.append("+" + q_aln[qpos:qpos + n].lower())
            qpos += n
            cig(n, "I")
        else:
            raise ValueError(kind)
    if qpos != len(q_aln):
        raise ValueError("ops must consume the whole aligned query")
    cigar = "".join(f"{n}{c}" for n, c in cig_parts)
    return "".join(cs_parts), cigar, "".join(tseq)


def make_paf_line(q_id: str, q_seq: str, t_id: str, strand: str, ops,
                  q_start: int = 0, q_end: int | None = None,
                  t_start: int = 0, t_len: int | None = None,
                  nm: int = 0, score: int = 0) -> tuple[str, str]:
    """Build a full PAF line; returns (line, target_seq_in_aln_orientation).
    ``q_start``/``q_end`` are forward-query coordinates of the aligned
    region; for strand '-' the ops consume
    revcomp(q)[qlen-q_end : qlen-q_start]."""
    q_len = len(q_seq)
    if q_end is None:
        q_end = q_len
    if strand == "-":
        q_aln = revcomp(q_seq.encode()).decode()[q_len - q_end:
                                                 q_len - q_start]
    else:
        q_aln = q_seq[q_start:q_end]
    cs, cigar, tseq = synth_alignment(q_aln.upper(), ops)
    t_end = t_start + len(tseq)
    if t_len is None:
        t_len = t_end
    fields = [
        q_id, str(q_len), str(q_start), str(q_end), strand,
        t_id, str(t_len), str(t_start), str(t_end),
        str(q_end - q_start), str(max(q_end - q_start, len(tseq))), "60",
        f"NM:i:{nm}", f"AS:i:{score}", f"cg:Z:{cigar}", f"cs:Z:{cs}",
    ]
    return "\t".join(fields), tseq


def make_corpus(seed: int = 20260730, n_aln: int = 200,
                cds_len: int = 1500,
                asm_lo: int = 50_000, asm_hi: int = 150_000):
    """A Nanopore-like corpus: one ``cds_len`` query, ``n_aln``
    full-CDS alignments against assemblies of ragged length
    ``asm_lo``..``asm_hi`` with 3-8% combined noise (subs dominate;
    indel lengths are geometric with a tail past the device MAX_EV=16
    scope limit).  Returns (query_str, paf_lines)."""
    rng = np.random.default_rng(seed)
    q = "".join(chr(b) for b in rng.choice(BASES, size=cds_len))
    lines = []
    for k in range(n_aln):
        strand = "-" if rng.random() < 0.35 else "+"
        q_aln = revcomp(q.encode()).decode() if strand == "-" else q
        sub_rate = rng.uniform(0.02, 0.05)
        ind_rate = rng.uniform(0.01, 0.03)
        # real aligner output is match-anchored at both ends; reserve
        # head/tail match runs and confine the noise to the interior
        head = int(rng.integers(10, 30))
        tail = int(rng.integers(10, 30))
        noise_end = cds_len - tail
        ops = [("=", head)]
        pos = head
        mrun = 0                       # accumulated match run

        def flush_match():
            nonlocal mrun
            if mrun:
                ops.append(("=", mrun))
                mrun = 0

        while pos < noise_end:
            r = rng.random()           # PER-BASE noise draws
            if r < sub_rate:
                flush_match()
                qb = q_aln[pos]
                tb = "ACGT"[("ACGT".index(qb.upper())
                             + int(rng.integers(1, 4))) % 4]
                ops.append(("*", tb.lower(), qb.lower()))
                pos += 1
            elif r < sub_rate + ind_rate:
                flush_match()
                ln = min(1 + int(rng.geometric(0.25)), 24)
                if rng.random() < 0.5:
                    ins = "".join(
                        chr(b).lower() for b in
                        rng.choice(BASES, size=ln))
                    ops.append(("ins", ins))
                else:
                    ln = min(ln, noise_end - pos)
                    if ln > 0:
                        ops.append(("del", ln))
                        pos += ln
            else:
                mrun += 1
                pos += 1
        flush_match()
        ops.append(("=", cds_len - pos))
        asm_len = int(rng.integers(asm_lo, asm_hi))
        t_start = int(rng.integers(0, asm_len - 2 * cds_len))
        lines.append(make_paf_line(
            "cds1", q, f"asm{k:03d}", strand, ops,
            t_start=t_start, t_len=asm_len)[0])
    return q, lines


def _mutated(rng, q: np.ndarray) -> np.ndarray:
    """A copy of base codes ``q`` with 3-8% substitutions and 0-8 indels
    of 1-3 bases."""
    t = q.copy()
    subs = rng.random(len(t)) < rng.uniform(0.03, 0.08)
    t[subs] = (t[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    for _ in range(int(rng.integers(0, 9))):
        p = int(rng.integers(1, len(t) - 1))
        g = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            t = np.concatenate([t[:p], rng.integers(0, 4, g), t[p:]])
        else:
            t = np.concatenate([t[:p], t[p + g:]])
    return t


def make_m2m_corpus(seed: int = 20261016, n_q: int = 500,
                    n_t: int = 10_240, *, out_dir: str) -> tuple[str, str]:
    """BASELINE.md config 3's many-to-many inputs, written as two FASTAs
    in ``out_dir``: ``n_q`` CDS (``cds0000``...) with lengths drawn as
    multiples of 3 in 1,200-1,800, and ``n_t`` targets (``asm00000``...),
    each a mutated copy of a random CDS (3-8% substitutions, 0-8 indels
    of 1-3 bases).  Returns (query FASTA path, target FASTA path)."""
    import os

    rng = np.random.default_rng(seed)
    cds = [rng.integers(0, 4, 3 * int(rng.integers(400, 601)))
           for _ in range(n_q)]
    paths = []
    for name, recs in (
            ("m2m_cds.fa", ((f"cds{k:04d}", q) for k, q in enumerate(cds))),
            ("m2m_targets.fa",
             ((f"asm{k:05d}", _mutated(rng, cds[int(rng.integers(n_q))]))
              for k in range(n_t)))):
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            for rid, codes in recs:
                f.write(b">" + rid.encode() + b"\n"
                        + BASES[codes].tobytes() + b"\n")
        paths.append(path)
    return paths[0], paths[1]


WALK_CASES = ("random", "random", "no_zero_iy_bit", "no_zero_iy_bit",
              "zero_bit_words_behind", "zero_bit_words_behind",
              "ix_from_last_band_index", "ix_from_last_band_index",
              "end_cell_outside_band", "end_cell_outside_band",
              "end_cell_outside_band", "end_cell_outside_band",
              "leading_gap")


def make_walk_planes(band: int, seed: int, m_max: int = 70) -> dict:
    """Hand-made pointer planes for the re-aligner's walk, one lane per
    entry of ``WALK_CASES`` at one band: random bytes; Iy rows with no
    zero Iy-extend bit at or before b (every bit 3 set); Iy rows whose
    last zero bit lies one to three 32-cell words behind b (the plane is
    steered along the walk's own path: each Iy row's zero bit is placed
    33-127 cells behind b, and the cell it lands on leads to a DIAG row
    whose byte leads back to Iy); an IX step out of band index band - 1;
    end cells outside the band (b_end = band, band + 3, -1, -7; the
    walk starts from the clamped index); an all-DIAG plane that closes on
    a leading gap.  The lanes' q_lens run 0, 1, around one 32-row chunk
    and two, to m_max and past it.

    Returns ptrs (T, m_max, band) uint8, q_lens and t_lens (T,) int32,
    the final wavefront wf (3, T, band) int32 whose cell at the clamped
    end index holds the lane's argmax, and dlo."""
    rng = np.random.default_rng(seed)
    T = len(WALK_CASES)
    dlo = -(band // 2)
    q_lens = np.array([m_max, 1, 31, m_max, 33, m_max - 1, 32, 65,
                       m_max + 3, 0, 64, 17, m_max], np.int32)[:T]
    ptrs = (rng.integers(0, 3, (T, m_max, band))
            | (rng.integers(0, 2, (T, m_max, band)) << 2)
            | (rng.integers(0, 2, (T, m_max, band)) << 3)).astype(np.uint8)
    b_end = rng.integers(0, band, T)
    mat = rng.integers(0, 3, T)
    outside = iter((band, band + 3, -1, -7))
    for k, case in enumerate(WALK_CASES):
        if case == "no_zero_iy_bit":
            ptrs[k] |= 8
            mat[k] = 2
        elif case == "zero_bit_words_behind":
            b_end[k], mat[k] = band - 1, 2
            _steer_far_zeros(ptrs[k], band - 1, int(min(q_lens[k], m_max)),
                             band, rng)
        elif case == "ix_from_last_band_index":
            b_end[k], mat[k] = band - 1, 1
        elif case == "end_cell_outside_band":
            b_end[k] = next(outside)
        elif case == "leading_gap":
            ptrs[k] = 0
            b_end[k], mat[k] = min(band - 1, -dlo + 1), 0
    wf = rng.integers(-50, 50, (3, T, band)).astype(np.int32)
    b0 = np.clip(b_end, 0, band - 1)
    for k in range(T):
        wf[:, k, b0[k]] = 10
        wf[mat[k], k, b0[k]] = 40
    t_lens = (q_lens + dlo + b_end).astype(np.int32)
    return dict(ptrs=ptrs, q_lens=q_lens, t_lens=t_lens, wf=wf, dlo=dlo)


def _steer_far_zeros(plane: np.ndarray, b: int, rows: int, band: int,
                     rng) -> None:
    """Rewrite ``plane`` (m_max, band) along the walk from (row ``rows``,
    b, Iy) so that each Iy row's last zero Iy-extend bit at or before b
    lies 33-127 cells behind b (or nowhere), each Iy row lands on a cell
    whose argmax is M, and each DIAG row's byte leads back to Iy."""
    mat = 2
    for i in range(rows, 0, -1):
        row = plane[i - 1]
        if not 0 <= b < band:
            return
        if mat == 2:
            z = b - 32 * int(rng.integers(1, 4)) - int(rng.integers(1, 32))
            row[max(z, 0):b + 1] |= 8
            if z >= 0:
                row[z] &= 0xF7
            if z >= 1:
                row[z - 1] &= 0xFC
            b, mat = (z - 1 if z >= 0 else -2), 0
        elif mat == 0:
            row[b] = (row[b] & 0xFC) | 2
            mat = 2
        else:
            b, mat = b + 1, (int(row[b]) >> 2) & 1
