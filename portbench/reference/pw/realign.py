"""Banded Gotoh re-alignment with traceback, in plain torch and NumPy.

A frozen copy of the port's plain re-aligner: the forward pass with
pointer bytes and the row walk (``forward_plain``, ``walk_plain``), the
expansion of the walked rows to an op string and to gap records
(``rows_to_ops_fwd``, ``ops_to_gaps``), the unbanded host oracle
(``full_gotoh_traceback``), and the batch rules of ``realign_pairs``:
lanes grouped by their 128-rounded (query, target) shape, one band
placement a group (``_pick_dlo``), lanes whose end cell the band misses
retried at four times the band up to 4,096, and the rest by the oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from .banded import NEG, ScoreParams, initial_wavefront, make_row_step
from .events import GapData

OP_DIAG, OP_IX, OP_IY = 1, 2, 3
MAX_BAND = 4096
PTR_BYTES_LIMIT = 1 << 30


def forward_plain(qs: torch.Tensor, ts: torch.Tensor, q_lens: torch.Tensor,
                  t_lens: torch.Tensor, dlo: int, band: int,
                  params: ScoreParams = ScoreParams()):
    """The banded forward pass with pointers, one lane per row of ``qs``.

    qs (T, m_max) and ts (T, n) int8 codes (pad 127), q_lens / t_lens
    (T,) true lengths.  Rows past a lane's q_len keep the wavefront as
    it was.  Returns (ptrs (T, m_max, band) uint8 — row i at index i-1,
    score (T,) int32 at cell (q_len, t_len) or NEG where the band misses
    it, b0 (T,) int32 the end cell's band index clamped into the band,
    mat0 (T,) int32 its argmax (0=M, 1=Ix, 2=Iy))."""
    dev = qs.device
    T, m_max = qs.shape
    n = ts.shape[1]
    step = make_row_step(n, dlo, band, params, dev, emit_ptrs=True)
    m, ix, iy = (x.expand(T, band)
                 for x in initial_wavefront(n, dlo, band, params, dev))
    q = qs.to(torch.int32)
    t = ts.to(torch.int32)
    ql = q_lens.to(device=dev, dtype=torch.int32)
    tl = t_lens.to(device=dev, dtype=torch.int32)
    ptrs = torch.empty((T, m_max, band), dtype=torch.uint8, device=dev)
    for i in range(1, m_max + 1):
        m_new, ix_new, iy_new, ptr = step(m, ix, iy, i, q[:, i - 1], t)
        ptrs[:, i - 1] = ptr
        keep = (i <= ql)[:, None]
        m = torch.where(keep, m_new, m)
        ix = torch.where(keep, ix_new, ix)
        iy = torch.where(keep, iy_new, iy)
    return (ptrs, *end_cell(m, ix, iy, ql, tl, dlo, band))


def end_cell(m_f, ix_f, iy_f, q_lens, t_lens, dlo: int, band: int):
    """(score, b0, mat0) of each lane's end cell (q_len, t_len) from its
    final (T, band) wavefront: the score is NEG where the band misses
    the cell; b0 is its band index clamped into the band, and mat0 the
    argmax (M >= Ix >= Iy) at b0."""
    b_end = t_lens - q_lens - dlo
    in_band = (b_end >= 0) & (b_end < band)
    b0 = b_end.clamp(0, band - 1)
    idx = b0.long()[:, None]
    mv, xv, yv = (x.gather(1, idx)[:, 0] for x in (m_f, ix_f, iy_f))
    score = torch.where(in_band, torch.maximum(mv, torch.maximum(xv, yv)),
                        NEG)
    mat0 = torch.where((mv >= xv) & (mv >= yv), 0,
                       torch.where(xv >= yv, 1, 2)).to(torch.int32)
    return score, b0, mat0


def walk_plain(ptrs: torch.Tensor, b0: torch.Tensor, mat0: torch.Tensor,
               q_lens: torch.Tensor):
    """The row walk from cell (q_len, b0) in matrix mat0 back to row 0.

    Returns (iy_runs (T, m_max) int32, ops_rows (T, m_max) int8, b_f (T,)
    int32) in FORWARD row order (row r at index r-1, 0 past q_len): the
    forward op string is [IY]*lead + sum_r([op_r] + [IY]*iy_runs[r-1])
    with lead = dlo + b_f.  A band index outside [0, band) reads as 0."""
    dev = ptrs.device
    T, m_max, band = ptrs.shape
    bidx = torch.arange(band, dtype=torch.int32, device=dev)
    ql = q_lens.to(device=dev, dtype=torch.int32)
    b = b0.to(torch.int32)
    mat = mat0.to(torch.int32)
    iy_runs = torch.zeros((T, m_max), dtype=torch.int32, device=dev)
    ops_rows = torch.zeros((T, m_max), dtype=torch.int8, device=dev)

    def at(row, k):
        inside = (k >= 0) & (k < band)
        got = row.gather(1, k.clamp(0, band - 1).long()[:, None])[:, 0]
        return torch.where(inside, got, 0)

    for i in range(m_max, 0, -1):
        live = i <= ql
        p = ptrs[:, i - 1].to(torch.int32)
        # Iy run length entering this row at every band position:
        # b - (last index <= b whose Iy-extend bit is 0, or -1) + 1
        z = torch.where(((p >> 3) & 1) == 0, bidx, -1)
        k_at = bidx - torch.cummax(z, dim=1).values + 1
        is_iy = mat == 2
        iy_run = torch.where(live & is_iy, at(k_at, b), 0)
        b_mid = b - iy_run            # an Iy run always lands in M
        p_mid = at(p, b_mid)
        is_ix = torch.where(is_iy, 0, mat) == 1
        iy_runs[:, i - 1] = iy_run
        ops_rows[:, i - 1] = torch.where(
            live, torch.where(is_ix, OP_IX, OP_DIAG), 0)
        nb = torch.where(is_ix, b_mid + 1, b_mid)
        nmat = torch.where(is_ix, (p_mid >> 2) & 1, p_mid & 3)
        b = torch.where(live, nb, b)
        mat = torch.where(live, nmat, mat)
    return iy_runs, ops_rows, b


def rows_to_ops_fwd(lead: int, iy_runs: np.ndarray, ops_rows: np.ndarray,
                    q_len: int) -> np.ndarray:
    """Expand one lane's compressed rows to the forward op string."""
    vals = np.empty(2 * q_len + 1, dtype=np.int8)
    lens = np.empty(2 * q_len + 1, dtype=np.int64)
    vals[0] = OP_IY
    lens[0] = lead
    vals[1::2] = ops_rows[:q_len]
    lens[1::2] = 1
    vals[2::2] = OP_IY
    lens[2::2] = iy_runs[:q_len]
    return np.repeat(vals, lens)


def ops_to_gaps(ops_fwd: np.ndarray, offset: int, r_len: int,
                eff_t_len: int, reverse: int
                ) -> tuple[list[GapData], list[GapData]]:
    """Convert a forward op string to (rgaps, tgaps) with the exact
    conventions of the CIGAR walk (core/events.py): Ix runs are target
    gaps at the current target position (strand-flipped when reverse),
    Iy runs are query gaps at offset+qpos (strand-flipped when
    reverse)."""
    rgaps: list[GapData] = []
    tgaps: list[GapData] = []
    qpos = tpos = 0
    i = 0
    L = len(ops_fwd)
    while i < L:
        op = ops_fwd[i]
        j = i
        while j < L and ops_fwd[j] == op:
            j += 1
        run = j - i
        if op == OP_DIAG:
            qpos += run
            tpos += run
        elif op == OP_IX:   # gap in the target sequence
            tgaps.append(GapData(eff_t_len - tpos if reverse else tpos,
                                 run))
            qpos += run
        elif op == OP_IY:   # gap in the query
            pos = offset + qpos
            if reverse:
                pos = r_len - pos
            rgaps.append(GapData(pos, run))
            tpos += run
        i = j
    return rgaps, tgaps


def full_gotoh_traceback(q: np.ndarray, t: np.ndarray,
                         params: ScoreParams = ScoreParams()
                         ) -> tuple[int, np.ndarray]:
    """Unbanded Gotoh with traceback — the host oracle.  Tie-breaks
    match the banded passes: diag argmax prefers M, then Ix, then Iy;
    gap recurrences prefer open on ties.  Returns (score, forward op
    array)."""
    m, n = len(q), len(t)
    ge, go = params.gap_extend, params.go
    M = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    Ix = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    Iy = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    DM = np.zeros((m + 1, n + 1), dtype=np.int8)   # diag argmax
    BX = np.zeros((m + 1, n + 1), dtype=np.int8)   # Ix from extend
    BY = np.zeros((m + 1, n + 1), dtype=np.int8)   # Iy from extend
    M[0, 0] = 0
    for j in range(1, n + 1):
        Iy[0, j] = -(go + (j - 1) * ge)
        BY[0, j] = 1 if j > 1 else 0
    for i in range(1, m + 1):
        Ix[i, 0] = -(go + (i - 1) * ge)
        BX[i, 0] = 1 if i > 1 else 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = params.match if (q[i - 1] == t[j - 1] and q[i - 1] < 4) \
                else -params.mismatch
            a, b, c = M[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1]
            if a >= b and a >= c:
                DM[i, j] = 0
                M[i, j] = a + s
            elif b >= c:
                DM[i, j] = 1
                M[i, j] = b + s
            else:
                DM[i, j] = 2
                M[i, j] = c + s
            op_sc, ext_sc = M[i - 1, j] - go, Ix[i - 1, j] - ge
            BX[i, j] = 1 if ext_sc > op_sc else 0
            Ix[i, j] = max(op_sc, ext_sc)
            op_sc, ext_sc = M[i, j - 1] - go, Iy[i, j - 1] - ge
            BY[i, j] = 1 if ext_sc > op_sc else 0
            Iy[i, j] = max(op_sc, ext_sc)
    mv, xv, yv = M[m, n], Ix[m, n], Iy[m, n]
    if mv >= xv and mv >= yv:
        mat = 0
    elif xv >= yv:
        mat = 1
    else:
        mat = 2
    score = int(max(mv, xv, yv))
    ops: list[int] = []
    i, j = m, n
    while i > 0 or j > 0:
        if i == 0:
            ops.append(OP_IY)
            j -= 1
            continue
        if j == 0:
            ops.append(OP_IX)
            i -= 1
            continue
        if mat == 0:
            ops.append(OP_DIAG)
            mat = int(DM[i, j])
            i -= 1
            j -= 1
        elif mat == 1:
            ops.append(OP_IX)
            mat = 1 if BX[i, j] else 0
            i -= 1
        else:
            ops.append(OP_IY)
            mat = 2 if BY[i, j] else 0
            j -= 1
    return score, np.array(ops[::-1], dtype=np.int8)


def _pick_dlo(d_ends: np.ndarray, band: int) -> int:
    """Band placement covering diagonal 0 (the origin) and as many of
    the lanes' end diagonals ``t_len - q_len`` as possible: center the
    band on the hull [min(0, d_min), max(0, d_max)] when it fits,
    else default to centering on the main diagonal."""
    lo = min(0, int(d_ends.min()))
    hi = max(0, int(d_ends.max()))
    span = hi - lo + 1
    if span <= band:
        return lo - (band - span) // 2
    return -(band // 2)


def _round_up(x: int, step: int = 128) -> int:
    return max(step, (x + step - 1) // step * step)


def realign_pairs(pairs, band: int = 64, params: ScoreParams = ScoreParams(),
                  device="cpu", escalate: bool = True):
    """(score, forward ops) of each (query segment, target) byte pair, or
    None where no band up to the ceiling nor the oracle re-aligns it.
    ``escalate=False`` (the control only) keeps each lane at ``band``."""
    from .dna import encode

    if not pairs:
        return []
    enc = [(encode(q.upper()), encode(t.upper())) for q, t in pairs]
    out: list = [None] * len(pairs)
    groups: dict = {}
    for k, (qc, tc) in enumerate(enc):
        groups.setdefault((_round_up(len(qc)), _round_up(len(tc))),
                          []).append(k)
    for (m_max, n), idxs in sorted(groups.items()):
        _realign_group(enc, idxs, m_max, n, band, params, out, device,
                       escalate)
    return out


def _realign_group(enc, idxs, m_max: int, n: int, band: int, params,
                   out: list, device, escalate: bool) -> None:
    T = len(idxs)
    qs = np.full((T, m_max), 127, dtype=np.int8)
    ts = np.full((T, n), 127, dtype=np.int8)
    q_lens = np.zeros(T, dtype=np.int32)
    t_lens = np.zeros(T, dtype=np.int32)
    for k, ki in enumerate(idxs):
        qc, tc = enc[ki]
        qs[k, :len(qc)] = qc
        ts[k, :len(tc)] = tc
        q_lens[k] = len(qc)
        t_lens[k] = len(tc)
    todo = np.arange(T)
    cur_band = max(1, band)
    first = True
    while len(todo) and (first or (escalate and cur_band <= MAX_BAND)):
        first = False
        lane_bytes = m_max * cur_band
        if lane_bytes > PTR_BYTES_LIMIT:
            break
        chunk = max(1, PTR_BYTES_LIMIT // lane_bytes)
        still = []
        for c0 in range(0, len(todo), chunk):
            sub = todo[c0:c0 + chunk]
            dlo = _pick_dlo(t_lens[sub] - q_lens[sub], cur_band)
            args = [torch.from_numpy(x[sub]).to(device)
                    for x in (qs, ts, q_lens, t_lens)]
            ptrs, scores, b0, mat0 = forward_plain(*args, dlo, cur_band,
                                                   params)
            iy_runs, ops_rows, b_f = walk_plain(ptrs, b0, mat0, args[2])
            leads = dlo + b_f
            ok = (scores > NEG // 2) & (leads >= 0)
            leads = torch.where(ok, leads, 0)
            scores, leads, iy_runs, ops_rows, ok = (
                x.cpu().numpy() for x in (scores, leads, iy_runs,
                                          ops_rows, ok))
            for j, k in enumerate(sub):
                if ok[j]:
                    out[idxs[k]] = (int(scores[j]), rows_to_ops_fwd(
                        int(leads[j]), iy_runs[j], ops_rows[j],
                        int(q_lens[k])))
            still.extend(sub[~ok])
        todo = np.array(still, dtype=np.int64)
        cur_band = max(cur_band * 4, 4)
    for k in todo:
        if not escalate:
            continue
        if int(q_lens[k]) * int(t_lens[k]) <= 256_000_000:
            out[idxs[k]] = full_gotoh_traceback(
                qs[k, :q_lens[k]], ts[k, :t_lens[k]], params)
