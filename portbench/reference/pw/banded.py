"""Banded affine-gap (Gotoh) DP in plain torch, on any device.

A frozen copy of the port's plain scoring recurrence (the row step in
band coordinates, its first wavefront and the read of the end cell), and
the ragged many-to-many scoring rule that ``--many2many`` applies: a
query of length m scores each target of length t in one of two width
groups (t <= m at width m, else at width m + band - 2), with the band
placed by ``band_dlo`` for that width, and NEG where the end diagonal
falls outside the band.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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



class BandPlacementError(ValueError):
    """No band placement covers both the start and the end diagonal."""


def band_dlo(m: int, n: int, band: int) -> int:
    """Static band placement: diagonal offsets j-i in [dlo, dlo+band).
    Centers the band between the start diagonal (0) and the end diagonal
    (n-m); raises BandPlacementError if the band can't cover both."""
    dlo = (n - m) // 2 - band // 2
    if not (dlo <= 0 <= dlo + band - 1 and dlo <= n - m <= dlo + band - 1):
        raise BandPlacementError(
            f"band {band} too narrow for sizes m={m}, n={n}"
            f" (needs to cover diagonals 0 and {n - m})")
    return dlo



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
                  device: torch.device, emit_ptrs: bool = False):
    """The DP row recurrence in band coordinates.

    Returns ``step(prev_m, prev_ix, prev_iy, i, qi, t) -> (m, ix, iy)``:
    the wavefronts are (L, band) int32, ``i`` the 1-based query row,
    ``qi`` the (L,) int32 query codes of that row and ``t`` the (L, n)
    int32 padded targets.  With ``emit_ptrs`` the step also returns
    ``ptr``, one uint8 per band cell: bits 0-1 = diag argmax (0=M, 1=Ix,
    2=Iy, tie-break M >= Ix >= Iy), bit 2 = Ix from extend, bit 3 = Iy
    from extend (gap-open wins ties).  The j==0 Ix boundary override
    equals the generic max it replaces (M[i-1][j=0] is NEG for i > 1 and
    0 for i = 1), so the extend bit stays valid there."""
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
        if not emit_ptrs:
            return m_new, ix_new, iy_new
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



def final_score(m_f, ix_f, iy_f, t_lens, m: int, dlo: int,
                band: int) -> torch.Tensor:
    """The global score at cell (m, t_len) of each lane from its last
    (L, band) wavefront; NEG where t_len falls outside the band."""
    b_end = t_lens.to(torch.int64) - m - dlo
    in_band = (b_end >= 0) & (b_end < band)
    idx = b_end.clamp(0, band - 1)[:, None]
    best = torch.maximum(m_f.gather(1, idx),
                         torch.maximum(ix_f.gather(1, idx),
                                       iy_f.gather(1, idx)))[:, 0]
    return torch.where(in_band, best, NEG).to(torch.int32)


def pair_groups(m: int, t_lens: np.ndarray, band: int):
    """The two width groups of a query of length ``m`` against targets of
    lengths ``t_lens``: ``[(n_eff, dlo, in-band target indices)]``."""
    out = []
    for group, n_eff in ((t_lens <= m, m), (t_lens > m, m + band - 2)):
        if not group.any():
            continue
        dlo = band_dlo(m, n_eff, band)
        b_end = t_lens - m - dlo
        keep = np.flatnonzero(group & (b_end >= 0) & (b_end < band))
        out.append((n_eff, dlo, keep))
    return out


def query_scores(q: np.ndarray, targets: list, band: int = 64,
                 params: ScoreParams = ScoreParams(), device="cpu",
                 dtype=torch.int32, lanes: int = 4096) -> np.ndarray:
    """(T,) int64 scores of one query (int8 codes) against every target
    (a list of int8 code arrays), NEG out of band, by the row step over
    lanes of in-band targets on ``device``.  ``dtype`` is the arithmetic
    of the score planes (int32 as the configuration states; a narrower
    one only for the control)."""
    m = len(q)
    t_lens = np.array([len(t) for t in targets], dtype=np.int64)
    out = np.full(len(targets), NEG, dtype=np.int64)
    for n_eff, dlo, keep in pair_groups(m, t_lens, band):
        for c0 in range(0, len(keep), lanes):
            idx = keep[c0:c0 + lanes]
            T = len(idx)
            ts = np.full((T, n_eff), 127, dtype=np.int8)
            for k, ti in enumerate(idx):
                t = targets[ti][:n_eff]
                ts[k, :len(t)] = t
            tt = torch.from_numpy(ts).to(device=device, dtype=torch.int32)
            step = make_row_step(n_eff, dlo, band, params, tt.device)
            wave = [x.expand(T, band)
                    for x in initial_wavefront(n_eff, dlo, band, params,
                                               tt.device)]
            qq = torch.from_numpy(q.astype(np.int32)).to(tt.device)
            lo, hi = _limits(dtype)
            for i in range(1, m + 1):
                wave = step(*wave, i, qq[i - 1].expand(T), tt)
                if dtype != torch.int32:
                    wave = [w.clamp(lo, hi) for w in wave]
            tl = torch.from_numpy(t_lens[idx]).to(tt.device)
            out[idx] = final_score(*wave, tl, m, dlo, band).cpu().numpy()
    return out


def _limits(dtype) -> tuple[int, int]:
    if dtype == torch.int32:
        return NEG, 2 ** 31 - 1
    info = torch.iinfo(dtype)
    return info.min, info.max
