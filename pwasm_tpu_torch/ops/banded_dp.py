"""Banded affine-gap DP (Gotoh): the shared row recurrence.

Counterpart of ``pwasm_tpu/ops/banded_dp.py``, reduced to what the
re-aligner needs (``ops/realign.py``): ``NEG``, ``ScoreParams``,
``initial_wavefront`` and ``make_row_step`` with pointers.
The scores-only kernels and ``banded_score`` come with the
many-to-many slice.

Formulation.  DP matrices M (match/mismatch), Ix (gap in target,
consumes query), Iy (gap in query, consumes target), a band of width B
in diagonal space: row ``i`` covers columns ``j = i + dlo + b`` for band
index b in [0, B).  Row recurrences in band coordinates:

- ``M[i][b]  = max(M,Ix,Iy)[i-1][b] + s(q_i, t_j)``       (diagonal stays)
- ``Ix[i][b] = max(M[i-1][b+1] - GO, Ix[i-1][b+1] - GE)`` (up shifts by 1)
- ``Iy[i][b] = max_{k<b}(M[i][k] - GO - (b-1-k) GE)``     (left chain)

The Iy chain collapses to a running max of ``M[i][k] + k*GE``, a
cumulative max along the band (``torch.cummax``).  Everything is int32
on (T, band) tensors, one row per lane, on the tensors' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NEG = -(2 ** 30)  # -inf surrogate, safe against int32 underflow


@dataclass(frozen=True)
class ScoreParams:
    """Integer alignment scores (penalties positive)."""

    match: int = 2
    mismatch: int = 4
    gap_open: int = 4    # charged when a gap opens (in addition to extend)
    gap_extend: int = 2

    @property
    def go(self) -> int:  # total cost of the first gap base
        return self.gap_open + self.gap_extend


def initial_wavefront(n: int, dlo: int, band: int, params: ScoreParams,
                      device: torch.device) -> tuple:
    """Row-0 wavefront state (M, Ix, Iy), each (band,) int32."""
    ge, go = params.gap_extend, params.go
    j0 = dlo + torch.arange(band, dtype=torch.int32, device=device)
    neg = torch.full((band,), NEG, dtype=torch.int32, device=device)
    m0 = torch.where(j0 == 0, 0, neg)
    iy0 = torch.where((j0 >= 1) & (j0 <= n), -(go + (j0 - 1) * ge), neg)
    return m0, neg.clone(), iy0


def make_row_step(n: int, dlo: int, band: int, params: ScoreParams,
                  device: torch.device):
    """The DP row recurrence in band coordinates, with pointers.

    Returns ``step(prev_m, prev_ix, prev_iy, i, qi, t) -> (m, ix, iy,
    ptr)``: the wavefronts are (T, band) int32, ``i`` the 1-based query
    row, ``qi`` the (T,) int32 query codes of that row and ``t`` the
    (T, n) int32 padded targets.  ``ptr`` is one uint8 per band cell:
    bits 0-1 = diag argmax (0=M, 1=Ix, 2=Iy, tie-break M >= Ix >= Iy),
    bit 2 = Ix from extend, bit 3 = Iy from extend (gap-open wins
    ties).  The j==0 Ix boundary override equals the generic max it
    replaces (M[i-1][j=0] is NEG for i > 1 and 0 for i = 1), so the
    extend bit stays valid there."""
    ge, go = params.gap_extend, params.go
    bidx = torch.arange(band, dtype=torch.int32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    match = torch.tensor(params.match, **i32)
    mismatch = torch.tensor(-params.mismatch, **i32)
    neg = torch.tensor(NEG, **i32)

    def step(prev_m, prev_ix, prev_iy, i, qi, t):
        T = prev_m.shape[0]
        negcol = neg.expand(T, 1)
        j = i + dlo + bidx
        valid = (j >= 1) & (j <= n)
        cols = (j - 1).clamp(0, n - 1).long()
        tj = torch.where(valid, t[:, cols], 127)
        q = qi[:, None]
        s = torch.where((q == tj) & (q < 4), match, mismatch)
        diag = torch.maximum(prev_m, torch.maximum(prev_ix, prev_iy))
        m_new = torch.where(valid, diag + s, neg)
        up_m = torch.cat([prev_m[:, 1:], negcol], dim=1)
        up_ix = torch.cat([prev_ix[:, 1:], negcol], dim=1)
        ix_new = torch.maximum(up_m - go, up_ix - ge)
        # boundary column j == 0: only a leading target-gap is alive
        ix_new = torch.where(j == 0, -(go + (i - 1) * ge), ix_new)
        ix_new = torch.where((j < 0) | (j > n), neg, ix_new)
        # left chain: Iy[b] = max_{k<b} (M[row][k] - GO - (b-1-k) GE)
        run = torch.cummax(m_new + bidx * ge, dim=1).values
        run_prev = torch.cat([negcol, run[:, :-1]], dim=1)
        iy_new = torch.where(valid, run_prev - go - (bidx - 1) * ge, neg)
        dm = torch.where((prev_m >= prev_ix) & (prev_m >= prev_iy), 0,
                         torch.where(prev_ix >= prev_iy, 1, 2))
        bx = (up_ix - ge > up_m - go).to(torch.int32)
        # Iy[b] == max(M[b-1] - go, Iy[b-1] - ge) (the closed form is
        # the unrolled chain); recover the sequential-form bit in-row
        m_left = torch.cat([negcol, m_new[:, :-1]], dim=1)
        iy_left = torch.cat([negcol, iy_new[:, :-1]], dim=1)
        by = (iy_left - ge > m_left - go).to(torch.int32)
        ptr = (dm | (bx << 2) | (by << 3)).to(torch.uint8)
        return m_new, ix_new, iy_new, ptr

    return step
