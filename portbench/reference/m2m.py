"""The plain reference of a ``--many2many`` job.

The report is one section a query, in FASTA order: ``>id\\tlen\\tT`` then
one ``target\\tlen\\tscore`` row a target, the score ``.`` where the
band misses the pair's end cell; the ``-s`` roll-up is one line a query:
``id  T  best_target  best_score  score_sum`` (ties to FASTA order; a
query with no pair in band reads ``.  .  0``).  Scores are the banded
Gotoh of ``pw/banded.py`` under the ragged width rule.
"""

from __future__ import annotations

import numpy as np

from .pw.banded import NEG, pair_groups, query_scores
from .pw.dna import encode


def read_fasta(path: str) -> list[tuple[str, np.ndarray]]:
    """(name, int8 codes of the upper-cased sequence) of each record."""
    out = []
    name, parts = None, []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, encode(b"".join(parts).upper())))
                name, parts = line[1:].split()[0].decode(), []
            elif line:
                parts.append(line)
    if name is not None:
        out.append((name, encode(b"".join(parts).upper())))
    return out


def in_band(m: int, t_lens: np.ndarray, band: int) -> np.ndarray:
    mask = np.zeros(len(t_lens), dtype=bool)
    for _n, _dlo, keep in pair_groups(m, t_lens, band):
        mask[keep] = True
    return mask


def parse_report(body: bytes, queries, targets, band: int):
    """(scores, layout_off): each query's (T,) int64 scores as the report
    gives them (NEG for ``.``; None for a section missing or cut short),
    and the count of header, row-prefix and in-band-mark departures from
    what the inputs and the band rule give."""
    lines = body.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    T = len(targets)
    t_lens = np.array([len(s) for _n, s in targets], dtype=np.int64)
    prefixes = [f"{n}\t{len(s)}".encode() for n, s in targets]
    scores: list = []
    off = 0
    p = 0
    for qn, q in queries:
        head = f">{qn}\t{len(q)}\t{T}".encode()
        if p >= len(lines) or lines[p] != head:
            off += 1
            scores.append(None)
            # resynchronise on the next header
            while p < len(lines) and not lines[p].startswith(b">"):
                p += 1
            if p < len(lines) and lines[p].startswith(f">{qn}\t".encode()):
                p += 1
            continue
        rows = lines[p + 1:p + 1 + T]
        p += 1 + len(rows)
        if len(rows) < T:
            off += 1 + T - len(rows)
            scores.append(None)
            continue
        parts = [r.rpartition(b"\t") for r in rows]
        off += sum(1 for (a, _s, _c), e in zip(parts, prefixes) if a != e)
        dots = np.fromiter((c == b"." for _a, _s, c in parts), dtype=bool,
                           count=T)
        off += int((dots == in_band(len(q), t_lens, band)).sum())
        try:
            vals = np.array([NEG if c == b"." else int(c)
                             for _a, _s, c in parts], dtype=np.int64)
        except ValueError:
            off += 1
            scores.append(None)
            continue
        scores.append(vals)
    off += len(lines) - p
    return scores, off


def reference_scores(queries, targets, picks, band: int, device="cpu",
                     dtype=None) -> dict:
    """{query index: (T,) int64 scores} of the picked queries."""
    import torch
    tcodes = [s for _n, s in targets]
    return {qi: query_scores(queries[qi][1], tcodes, band, device=device,
                             dtype=dtype or torch.int32)
            for qi in picks}


def format_summary(queries, targets, scores) -> list[str]:
    """The roll-up lines of ``scores`` (a query with None reads as all
    out of band)."""
    out = []
    T = len(targets)
    for (qn, _q), row in zip(queries, scores):
        row = np.full(T, NEG, dtype=np.int64) if row is None else row
        live = row != NEG
        if live.any():
            bi = int(np.argmax(np.where(live, row,
                                        np.iinfo(np.int64).min)))
            out.append(f"{qn}\t{T}\t{targets[bi][0]}\t{row[bi]}"
                       f"\t{int(row[live].sum())}\n")
        else:
            out.append(f"{qn}\t{T}\t.\t.\t0\n")
    return out


def rewrite_rows(o_path: str, s_path: str | None, queries, targets,
                 rows: dict) -> None:
    """Write ``rows`` ({query index: (T,) scores}) over those queries'
    sections of the report at ``o_path`` and over their roll-up lines at
    ``s_path``, every other byte as it was."""
    T = len(targets)
    with open(o_path, "rb") as f:
        lines = f.read().split(b"\n")
    heads = {f">{queries[qi][0]}\t{len(queries[qi][1])}\t{T}".encode(): qi
             for qi in rows}
    for p, line in enumerate(lines):
        qi = heads.get(line)
        if qi is None:
            continue
        for t, v in enumerate(rows[qi]):
            a, _s, _c = lines[p + 1 + t].rpartition(b"\t")
            lines[p + 1 + t] = a + b"\t" + (b"." if v == NEG
                                            else str(int(v)).encode())
    with open(o_path, "wb") as f:
        f.write(b"\n".join(lines))
    if s_path is None:
        return
    with open(s_path, "rb") as f:
        summ = f.read().decode().splitlines(keepends=True)
    for qi, row in rows.items():
        if qi < len(summ):
            summ[qi] = format_summary([queries[qi]], targets, [row])[0]
    with open(s_path, "w") as f:
        f.write("".join(summ))
