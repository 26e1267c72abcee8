"""Banded affine-gap DP (Gotoh): the row recurrence and the scores.

Counterpart of ``pwasm_tpu/ops/banded_dp.py``.  ``make_row_step`` is the
row recurrence the re-aligner (``ops/realign.py``, with pointers) and the
scores path share.  The scores path is ``banded_scores_plain`` (the plain
version: the reference's ``banded_scores_batch`` with every (query,
target) pair one lane) and, for CUDA tensors, the scores kernels of
``csrc/banded_dp.cu`` (resident and streamed), reached through
``banded_scores_matrix`` (Q queries x T targets: the reference's
``parallel/many2many.py::many2many_scores``), ``banded_scores`` (one
query: on a CPU tensor, the reference's ``banded_scores_batch``) and
``banded_scores_long`` (one query, the streamed variant: the reference's
``banded_scores_long``).  ``scores_plan`` reads from the built library
which body a variant runs at a shape; ``subwarp_layout``,
``interior_rows`` and ``stream_plan`` are the CPU-tested mirrors of the
sub-warp layout, the row split and the streamed body's ring.
``full_gotoh_score`` is the numpy oracle.

Formulation.  DP matrices M (match/mismatch), Ix (gap in target,
consumes query), Iy (gap in query, consumes target), a band of width B
in diagonal space: row ``i`` covers columns ``j = i + dlo + b`` for band
index b in [0, B).  Row recurrences in band coordinates:

- ``M[i][b]  = max(M,Ix,Iy)[i-1][b] + s(q_i, t_j)``       (diagonal stays)
- ``Ix[i][b] = max(M[i-1][b+1] - GO, Ix[i-1][b+1] - GE)`` (up shifts by 1)
- ``Iy[i][b] = max_{k<b}(M[i][k] - GO - (b-1-k) GE)``     (left chain)

The Iy chain collapses to a running max of ``M[i][k] + k*GE``, a
cumulative max along the band (``torch.cummax``).  Everything is int32
on (lanes, band) tensors, one row per lane, on the tensors' device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from pwasm_tpu_torch.ops import _build

NEG = -(2 ** 30)  # -inf surrogate, safe against int32 underflow

LAUNCHES = {"scores": 0, "scores_long": 0}
_FNS: dict = {}    # the bound C entry points, set on first use
# what the scores launcher takes (csrc/banded_dp.cu::pw_scores_smem)
_LIMITS = ("a band of 1 to 32,768 cells, at most 2**31 - 1 (query, "
           "target) pairs and at most 227 KB of a block's shared memory")


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


# ---------------------------------------------------------------------------
# the plain version (CPU tensors; the kernels' reference on the card)
# ---------------------------------------------------------------------------
def banded_scores_plain(qs: torch.Tensor, ts: torch.Tensor,
                        t_lens: torch.Tensor, band: int = 64,
                        params: ScoreParams = ScoreParams()
                        ) -> torch.Tensor:
    """(Q, T) int32 banded global scores of every query against every
    target, on the inputs' device: qs (Q, m) codes sharing one length
    m, ts (T, n) padded codes (pad 127), t_lens (T,) true lengths.  A
    score is read at cell (m, t_len), NEG where the band misses it.
    The band placement is ``band_dlo(m, n, band)`` (raises when the band
    cannot cover diagonals 0 and n - m).  Every pair is one lane of one
    row loop."""
    Q, m = qs.shape
    T, n = ts.shape
    dlo = band_dlo(m, n, band)
    dev = ts.device
    step = make_row_step(n, dlo, band, params, dev)
    L = Q * T
    q = qs.to(device=dev, dtype=torch.int32).repeat_interleave(T, dim=0)
    t = ts.to(torch.int32).repeat(Q, 1)
    wave = [x.expand(L, band)
            for x in initial_wavefront(n, dlo, band, params, dev)]
    for i in range(1, m + 1):
        wave = step(*wave, i, q[:, i - 1], t)
    tl = t_lens.to(device=dev).repeat(Q)
    return final_score(*wave, tl, m, dlo, band).view(Q, T)


def interior_rows(m: int, n: int, dlo: int, band: int) -> tuple[int, int]:
    """The 0-based rows ``[head, int_end)`` of a lane whose every band
    cell has ``1 <= j <= n`` (row ``i = ii + 1`` is interior iff ``1 -
    dlo <= i <= n - band - dlo + 1``): the reference's split into a
    masked head, an unmasked interior and a masked tail
    (``pwasm_tpu/ops/banded_dp.py::_banded_kernel``).  The resident
    kernel's sub-warp body runs these rows without masks
    (``csrc/banded_dp.cu::interior_rows`` is the same formula)."""
    head = min(max(0, -dlo), m)
    return head, max(head, min(m, n - band - dlo + 1))


def subwarp_layout(band: int) -> tuple[int, int] | None:
    """The sub-warp layout of a band as (C, G): C cells a thread, the
    least power of two >= band but at most 8, and G threads a lane, the
    least power of two with G * C >= band; None where G would pass 32
    (bands above 256), which take the block-wide body
    (``csrc/banded_dp.cu::sub_layout`` is the same rule)."""
    c = 1
    while c < band and c < 8:
        c <<= 1
    g = 1
    while g * c < band:
        g <<= 1
    return (c, g) if g <= 32 else None


# the streamed sub-warp body's ring (csrc/banded_dp.cu kWindow, kRing,
# kSubWarps): W rows a slot, slots a warp, warps a block
STREAM_WINDOW = 16
STREAM_RING = 3
SUB_WARPS = 4


def stream_plan(band: int) -> dict | None:
    """The streamed sub-warp body's plan for a band, the mirror of
    ``csrc/banded_dp.cu::stream_plan``: ``cells`` a thread and
    ``threads`` a lane (``subwarp_layout``), ``lanes`` a block (four
    warps of 32 / G), ``window`` rows a step (W), ``lane_bytes`` of one
    lane's target window (a step's rows read W + G*C - 1 bytes from up to
    15 bytes past a 16-byte floor: round16(W + G*C + 14)), ``slot_bytes``
    (the step's W query codes, then one window a lane of the warp) and
    the block's shared-memory bytes ``smem`` (a ring of STREAM_RING slots
    a warp), which depend on the band alone.  None for bands above 256,
    which take the block-wide body."""
    layout = subwarp_layout(band)
    if layout is None:
        return None
    c, g = layout
    lane_bytes = (STREAM_WINDOW + g * c + 14 + 15) // 16 * 16
    slot_bytes = STREAM_WINDOW + 32 // g * lane_bytes
    return dict(cells=c, threads=g, lanes=SUB_WARPS * 32 // g,
                window=STREAM_WINDOW, lane_bytes=lane_bytes,
                slot_bytes=slot_bytes,
                smem=SUB_WARPS * STREAM_RING * slot_bytes)


def stream_window_start(step: int, dlo: int) -> int:
    """The target byte at which every lane's window of W-row step
    ``step`` starts in the streamed sub-warp body: the 16-byte floor of
    ``step * W + dlo``, the byte ``j - 1`` that the step's first row
    reads at band index 0 (negative before the row; the kernel fills
    those copies with pad code 127)."""
    return (step * STREAM_WINDOW + dlo) & ~15


def full_gotoh_score(q: np.ndarray, t: np.ndarray,
                     params: ScoreParams = ScoreParams()) -> int:
    """Unbanded full-matrix Gotoh global score, identical recurrence
    (no Ix<->Iy adjacency).  Integer math; the oracle for the band
    tests."""
    m, n = len(q), len(t)
    ge, go = params.gap_extend, params.go
    M = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    Ix = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    Iy = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    M[0, 0] = 0
    for j in range(1, n + 1):
        Iy[0, j] = -(go + (j - 1) * ge)
    for i in range(1, m + 1):
        Ix[i, 0] = -(go + (i - 1) * ge)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = params.match if (q[i - 1] == t[j - 1] and q[i - 1] < 4) \
                else -params.mismatch
            M[i, j] = max(M[i - 1, j - 1], Ix[i - 1, j - 1],
                          Iy[i - 1, j - 1]) + s
            Ix[i, j] = max(M[i - 1, j] - go, Ix[i - 1, j] - ge)
            Iy[i, j] = max(M[i, j - 1] - go, Iy[i, j - 1] - ge)
    return int(max(M[m, n], Ix[m, n], Iy[m, n]))


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/banded_dp.cu)
# ---------------------------------------------------------------------------
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "pw_scores": ([_I, _P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P, _P], _I),
    "pw_scores_smem": ([_I, _I, _I, _I], ctypes.c_longlong),
    "pw_scores_plan": ([_I, _I, _I, _I, _I, _P], _I),
}


def _fn(name: str):
    """The C entry point ``pw_scores`` or ``pw_scores_smem`` of
    ``csrc/banded_dp.cu``, built and bound on first use."""
    return _build.bind("banded_dp", _SIGS, _FNS)[name]


def scores_plan(m: int, n: int, band: int,
                streamed: bool = False) -> dict | None:
    """What a variant of the scores kernel runs at a shape, from the
    built library (``pw_scores_plan``): ``body`` ("subwarp" or
    "block"), ``cells`` a thread, ``threads`` a lane, ``lanes`` a block,
    the 0-based rows ``interior`` it runs unmasked, the rows a streamed
    ``window`` covers (0 resident) and the block's shared-memory bytes
    ``smem``; None where the variant does not take the shape."""
    out = (ctypes.c_int * 8)()
    dlo = band_dlo(m, n, band)
    if _fn("pw_scores_plan")(int(streamed), m, n, band, dlo,
                             ctypes.addressof(out)):
        return None
    return dict(body="subwarp" if out[0] else "block", cells=out[1],
                threads=out[2], lanes=out[3], interior=(out[4], out[5]),
                window=out[6], smem=out[7])


def check_launch(rc: int, what: str) -> None:
    """Raise when a C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def pad16(x: torch.Tensor) -> torch.Tensor:
    """A contiguous int8 copy of ``x`` whose rows start at 16-byte
    boundaries (width a multiple of 16, pad code 127), or ``x`` itself
    when it already is one.  The row stride must be the width: a
    one-row view (numpy's ``q[None]``) may carry a row stride of 0."""
    T, w = x.shape
    if w % 16 == 0 and x.stride() == (w, 1) and x.data_ptr() % 16 == 0:
        return x
    width = (max(w, 1) + 15) // 16 * 16
    out = torch.full((T, width), 127, dtype=torch.int8, device=x.device)
    out[:, :w] = x
    return out


def select_kernel(m: int, n: int, band: int) -> str | None:
    """The budget: ``"resident"`` when a block of lanes with their
    queries and targets fits a block's shared memory, else
    ``"streamed"`` when the band's staging ring does (bands up to 256
    always: their ring depends on the band alone), else None (no kernel
    takes the shape).  The sizes come from the kernel's own layout
    (``pw_scores_smem``), so this needs the built library."""
    for name in ("resident", "streamed"):
        if _fn("pw_scores_smem")(int(name == "streamed"), m, n, band):
            return name
    return None


def launch_scores(streamed: bool, qp: torch.Tensor, tp: torch.Tensor,
                  t_lens: torch.Tensor, m: int, n: int, dlo: int,
                  band: int, params: ScoreParams, out: torch.Tensor) -> None:
    """Launch the scores kernel on the current stream into the
    caller-allocated (Q, T) int32 ``out``; ``qp``/``tp`` come from
    ``pad16``, ``t_lens`` is int32.  No checks beyond the launcher's:
    ``scores_kernel`` is the checked entry point, this is its launch
    alone, for a timing loop."""
    rc = _fn("pw_scores")(
        int(streamed), qp.data_ptr(), qp.stride(0), qp.shape[0], m,
        tp.data_ptr(), tp.stride(0), t_lens.data_ptr(), tp.shape[0], n,
        dlo, band, params.match, params.mismatch, params.go,
        params.gap_extend, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    name = "scores_long" if streamed else "scores"
    check_launch(rc, name)
    LAUNCHES[name] += 1


def scores_kernel(qs: torch.Tensor, ts: torch.Tensor, t_lens: torch.Tensor,
                  band: int = 64, params: ScoreParams = ScoreParams(),
                  streamed: bool = False) -> torch.Tensor:
    """``banded_scores_plain`` on the card: the scores kernel, the
    variant forced by ``streamed``.  qs (Q, m) and ts (T, n) int8 codes
    on one CUDA device.  Raises when the shape does not fit the
    variant."""
    if qs.device.type != "cuda" or ts.device != qs.device:
        raise ValueError("scores_kernel: qs and ts must be on one CUDA "
                         f"device, got {qs.device} and {ts.device}")
    if qs.dtype != torch.int8 or ts.dtype != torch.int8 or qs.dim() != 2 \
            or ts.dim() != 2:
        raise ValueError("scores_kernel: need int8 (Q, m) and (T, n) "
                         f"codes, got {qs.dtype} {tuple(qs.shape)} and "
                         f"{ts.dtype} {tuple(ts.shape)}")
    Q, m = qs.shape
    T, n = ts.shape
    dlo = band_dlo(m, n, band)
    if Q * T >= 2 ** 31 or not _fn("pw_scores_smem")(int(streamed), m, n,
                                                     band):
        raise ValueError(
            f"the {'streamed' if streamed else 'resident'} scores kernel "
            f"does not take band {band} at Q={Q}, T={T}, m={m}, n={n}: "
            f"{_LIMITS}")
    tl = t_lens.to(device=qs.device, dtype=torch.int32).contiguous()
    if tl.shape != (T,):
        raise ValueError(f"t_lens of shape {tuple(tl.shape)}, want ({T},)")
    out = torch.empty((Q, T), dtype=torch.int32, device=qs.device)
    if Q and T:
        with torch.cuda.device(qs.device):
            launch_scores(streamed, pad16(qs), pad16(ts), tl, m, n, dlo,
                          band, params, out)
    return out


def banded_scores_matrix(qs: torch.Tensor, ts: torch.Tensor,
                         t_lens: torch.Tensor, band: int = 64,
                         params: ScoreParams = ScoreParams()
                         ) -> torch.Tensor:
    """(Q, T) int32 banded global scores, on the inputs' device: qs (Q,
    m) codes sharing one length, ts (T, n) padded int8 codes, t_lens
    (T,) true lengths.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    scores kernel or raises: the variant comes from the shared-memory
    budget (``select_kernel``), and a band or shape that no variant
    takes raises."""
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if qs.device.type == "cpu":
        return banded_scores_plain(qs, ts, t_lens, band, params)
    if qs.device.type != "cuda":
        raise ValueError(f"banded_scores_matrix: unsupported device "
                         f"{qs.device}")
    name = select_kernel(qs.shape[1], ts.shape[1], band)
    if name is None:
        raise ValueError(f"no scores kernel takes band {band} at "
                         f"m={qs.shape[1]}, n={ts.shape[1]}: {_LIMITS}")
    return scores_kernel(qs, ts, t_lens, band, params,
                         streamed=name == "streamed")


def banded_scores_long(q: torch.Tensor, ts: torch.Tensor,
                       t_lens: torch.Tensor, band: int = 128,
                       params: ScoreParams = ScoreParams()) -> torch.Tensor:
    """Long reads: one query (m,) against (T, n) padded targets -> (T,)
    int32 scores, bit-exact with ``banded_scores`` (the reference's
    ``banded_scores_long``, with its default band).

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    streamed variant of the scores kernel, whose shared memory depends
    on the band alone, so any length fits, or raises.  The reference's
    ``block_t``, ``chunk`` and ``interpret`` tile a TPU's VMEM and run
    its interpreter; nothing here takes their place."""
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if q.device.type == "cpu":
        return banded_scores_plain(q[None], ts, t_lens, band, params)[0]
    return scores_kernel(q[None], ts, t_lens, band, params,
                         streamed=True)[0]


def banded_scores(q: torch.Tensor, ts: torch.Tensor, t_lens: torch.Tensor,
                  band: int = 64,
                  params: ScoreParams = ScoreParams()) -> torch.Tensor:
    """One query against a target batch: (m,) codes, (T, n) padded
    targets -> (T,) int32 scores (``banded_scores_matrix`` with Q = 1)."""
    return banded_scores_matrix(q[None], ts, t_lens, band, params)[0]
