"""Banded affine-gap DP re-alignment: traceback to gap structures.

Counterpart of ``pwasm_tpu/ops/realign.py``.  For every (query segment,
target) pair the re-aligner emits the optimal banded alignment path
and converts it to the gap-record conventions of the CIGAR walk
(``core/events.py``), so a re-aligned MSA drops in where the PAF's own
gap structure was used.

Two passes per dispatch, each a CUDA kernel for CUDA tensors
(``csrc/realign.cu``) and a plain torch version for CPU tensors:

- **forward** (``forward_plain`` / ``forward_kernel``): the banded Gotoh
  recurrence of ``ops/banded_dp.py`` over every query row of every
  lane, emitting one pointer byte per band cell — bits 0-1 the diagonal
  argmax (0=M, 1=Ix, 2=Iy), bit 2 Ix from extend, bit 3 Iy from extend —
  into a (T, m_max, band) uint8 tensor, and the end cell's score, band
  index ``b0`` and argmax ``mat0``.  The kernel has two variants,
  ``resident`` (a block's lanes' sequences in shared memory) and
  ``streamed`` (windows staged from device memory, for long reads);
  bands up to 256 run both on a sub-warp body (``forward_plan``), wider
  ones on a block-wide body, and ``banded_realign_rows`` picks a variant
  by a shared-memory budget.
- **walk** (``walk_plain`` / ``walk_kernel``): the row-parallel
  traceback.  It advances one query row per step: a run of Iy ops
  (gaps in the query, moving down the band) whose length is closed-form
  over the row's Iy-extend bits, then one DIAG or IX op leaving the
  row.  Per row it emits (iy_run, op): the compressed alignment is
  (m, 2) per lane, not (m + n,).  Bands up to 256 run the kernel's ring
  body (pointer rows copied ahead of the chain into shared memory;
  ``walk_plan``), wider ones its wide body.

Tie-breaks are defined (M >= Ix >= Iy on maxima; gap-open wins ties
against gap-extend) and shared by the numpy oracle
``full_gotoh_traceback``, so every path gives the same gap structures.

Op codes (forward order): 1 = diagonal (consumes query+target),
2 = Ix (consumes query => gap in target, the CIGAR-walk 'I' case),
3 = Iy (consumes target => gap in query, the CIGAR-walk 'D' case).

``LAUNCHES`` counts kernel launches by kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pwasm_tpu_torch import native
from pwasm_tpu_torch.core.events import GapData
from pwasm_tpu_torch.ops import _build
from pwasm_tpu_torch.ops.banded_dp import (NEG, ScoreParams, check_launch,
                                           initial_wavefront, interior_rows,
                                           make_row_step, pad16)

OP_DIAG, OP_IX, OP_IY = 1, 2, 3

LAUNCHES = {"fwdptr": 0, "fwdptr_long": 0, "walk": 0}
_FNS: dict = {}    # the bound C entry points, set on first use
# what the fwdptr launcher takes (csrc/realign.cu::pw_fwd_smem)
_LIMITS = ("a band of 1 to 32,768 cells and at most 227 KB of a block's "
           "shared memory")

# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the kernels' references on the card)
# ---------------------------------------------------------------------------
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


def leads_ok(scores: torch.Tensor, b_f: torch.Tensor, dlo: int):
    """(leads, ok) from the end scores and the walk's final band index:
    the leading gap-in-query run is dlo + b_f, and a lane is ok when the
    band held its end cell and the walk closed at a column >= 0 (leads
    0 where not ok)."""
    leads = dlo + b_f
    ok = (scores > NEG // 2) & (leads >= 0)
    return torch.where(ok, leads, 0), ok


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


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/realign.cu)
# ---------------------------------------------------------------------------
def select_kernel(m_max: int, n: int, band: int) -> str | None:
    """The budget: ``"resident"`` when a block of lanes with their
    sequences fits a block's shared memory, else ``"streamed"`` when the
    band's staging ring does (bands up to 256 always: their ring depends
    on the band alone), else None (no kernel takes the shape).  The sizes
    come from the kernel's own layout (``pw_fwd_smem``), so this needs
    the built library; ``forward_plan`` is their mirror."""
    for name in ("resident", "streamed"):
        if _fn("pw_fwd_smem")(int(name == "streamed"), m_max, n, band):
            return name
    return None


# the sub-warp forward body's layout (csrc/realign.cu kCellsMax, kWindow,
# kRing, kGuard): cells a thread at most where a warp's 32 threads hold
# the band, W rows a streamed slot, slots a warp, bytes after a resident
# block's target rows (a block is one warp, kSubWarps); and a block's
# limits
FWD_CELLS = 2
FWD_WINDOW = 16
FWD_RING = 3
FWD_GUARD = 256
SMEM_LIMIT = 232_448          # 227 KB, the opt-in maximum per block
MAX_THREADS = 1024


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def forward_layout(band: int) -> tuple[int, int] | None:
    """The sub-warp forward body's layout of a band as (C, G), the
    mirror of ``csrc/realign.cu::sub_layout``: C cells a thread, the
    least power of two >= band but at most FWD_CELLS, or more (at most
    8) where 32 threads would not hold the band, and G threads a lane,
    the least power of two with G * C >= band; None where G would pass
    32 (bands above 256), which take the block-wide body.  Fewer cells a
    thread than the scores kernels' ``subwarp_layout`` (at most 8): a
    thread's share of a row is the serial part of the row's chain, and
    the forward row holds twice the scores row's work (PERF.md)."""
    c = 1
    while c < band and c < FWD_CELLS:
        c <<= 1
    while c < 8 and 32 * c < band:
        c <<= 1
    g = 1
    while g * c < band:
        g <<= 1
    return (c, g) if g <= 32 else None


def block_smem(streamed: bool, m_max: int, n: int, band: int) -> int:
    """Shared-memory bytes of one block of the block-wide forward body
    (bands above 256; ``csrc/realign.cu::fwd_smem``): the wavefront's
    three int32 rows and 32 warp totals, then the lane's target and query
    (resident) or two target slots of an 8-row window and two 16-byte
    query slots (streamed)."""
    wave = _round16(12 * band) + 128
    if streamed:
        return wave + 2 * _round16(band + 22) + 32
    return wave + _round16(n) + _round16(m_max)


def forward_plan(m_max: int, n: int, band: int, dlo: int,
                 streamed: bool = False) -> dict | None:
    """What a forward variant runs at a shape, the mirror of
    ``csrc/realign.cu::pw_fwd_plan`` (``kernel_plan`` reads that one from
    the built library): ``body`` ("subwarp" or "block"), ``cells`` a
    thread and ``threads`` a lane (``forward_layout``; the block-wide
    body: its cells a thread and threads a block), ``lanes`` and
    ``warps`` a block (a sub-warp block is one warp), the 0-based rows ``interior`` it runs unmasked
    (``interior_rows``; empty for the block-wide body), the rows a
    streamed ``window`` covers (0 resident) and the block's shared-memory
    bytes ``smem``.  The streamed sub-warp plan also gives ``lane_bytes``
    (one lane's target window: a step's rows read W + G*C - 1 bytes from
    up to 15 bytes past a 16-byte floor, round16(W + G*C + 14)) and
    ``slot_bytes`` (per lane of a warp, W query codes and its window).
    None where the variant does not take the shape: a band outside
    1..32,768, or no block that fits 227 KB."""
    if band < 1 or band > 32 * MAX_THREADS or m_max < 0 or n < 0:
        return None
    layout = forward_layout(band)
    if layout is None:
        smem = block_smem(streamed, m_max, n, band)
        if smem > SMEM_LIMIT:
            return None
        cells = 1
        while cells * MAX_THREADS < band:
            cells <<= 1
        threads = ((band + cells - 1) // cells + 31) // 32 * 32
        return dict(body="block", cells=cells, threads=threads, lanes=1,
                    warps=threads // 32, interior=(m_max, m_max),
                    window=8 if streamed else 0, smem=smem)
    c, g = layout
    plan = dict(body="subwarp", cells=c, threads=g,
                interior=interior_rows(m_max, n, dlo, band))
    if streamed:
        lane_bytes = _round16(FWD_WINDOW + g * c + 14)
        slot_bytes = 32 // g * (FWD_WINDOW + lane_bytes)
        plan.update(lanes=32 // g, warps=1, window=FWD_WINDOW,
                    lane_bytes=lane_bytes, slot_bytes=slot_bytes,
                    smem=FWD_RING * slot_bytes)
        return plan
    lanes = 32 // g
    smem = lanes * (_round16(max(m_max, 1)) + _round16(max(n, 1))) \
        + FWD_GUARD
    if smem > SMEM_LIMIT:
        return None
    plan.update(lanes=lanes, warps=1, window=0, smem=smem)
    return plan


def forward_window_start(step: int, dlo: int) -> int:
    """The target byte at which every lane's window of W-row step
    ``step`` starts in the streamed sub-warp body: the 16-byte floor of
    ``step * W + dlo``, the byte ``j - 1`` that the step's first row
    reads at band index 0 (negative before the row; the kernel fills
    those copies with pad code 127)."""
    return (step * FWD_WINDOW + dlo) & ~15


# the walk's ring body (csrc/realign.cu kWalkChunk, kWalkAhead,
# kWalkRingWarps, kWalkRingBand) and the wide body's warps a block
WALK_CHUNK = 32
WALK_AHEAD = 4
WALK_RING_WARPS = 1
WALK_RING_BAND = 256
WALK_WIDE_WARPS = 4


def walk_plan(m_max: int, band: int) -> dict | None:
    """The walk's plan at a shape, the mirror of
    ``csrc/realign.cu::pw_walk_plan`` (``walk_kernel_plan`` reads that one
    from the built library): ``body`` "ring" for bands up to 256 — each
    warp copies its lane's pointer rows into a ring of WALK_AHEAD + 1
    slots of ``chunk_rows`` rows each, ``chunks_ahead`` chunks beyond the
    one it walks, a slot holding the 16-byte cover of the chunk's bytes
    (round16(chunk_rows * band + 15)) — or "wide" above (chunk_rows and
    chunks_ahead 0, no shared memory); ``warps`` a block and the block's
    shared-memory bytes ``smem`` (16 zero bytes, what a row reads outside
    the band, then the rings).  None for a band below 1 or a negative
    m_max."""
    if band < 1 or m_max < 0:
        return None
    if band > WALK_RING_BAND:
        return dict(body="wide", chunk_rows=0, chunks_ahead=0,
                    warps=WALK_WIDE_WARPS, smem=0)
    slot = _round16(WALK_CHUNK * band + 15)
    return dict(body="ring", chunk_rows=WALK_CHUNK, chunks_ahead=WALK_AHEAD,
                warps=WALK_RING_WARPS,
                smem=16 + WALK_RING_WARPS * (WALK_AHEAD + 1) * slot)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "pw_fwdptr": ([_I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P, _P, _P, _P, _P], _I),
    "pw_walk": ([_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P], _I),
    "pw_fwd_smem": ([_I, _I, _I, _I], ctypes.c_longlong),
    "pw_fwd_plan": ([_I, _I, _I, _I, _I, _P], _I),
    "pw_walk_plan": ([_I, _I, _P], _I),
}


def _fn(name: str):
    """The C entry point ``pw_fwdptr``, ``pw_walk``, ``pw_fwd_smem``,
    ``pw_fwd_plan`` or ``pw_walk_plan`` of ``csrc/realign.cu``, built and
    bound on first use."""
    return _build.bind("realign", _SIGS, _FNS)[name]


def kernel_plan(m_max: int, n: int, band: int, dlo: int,
                streamed: bool = False) -> dict | None:
    """A forward variant's plan at a shape from the built library
    (``pw_fwd_plan``), with ``forward_plan``'s keys but the streamed
    window's byte counts; None where the variant does not take it."""
    out = (ctypes.c_int * 9)()
    if _fn("pw_fwd_plan")(int(streamed), m_max, n, band, dlo,
                          ctypes.addressof(out)):
        return None
    return dict(body="subwarp" if out[0] else "block", cells=out[1],
                threads=out[2], lanes=out[3], warps=out[4],
                interior=(out[5], out[6]), window=out[7], smem=out[8])


def walk_kernel_plan(m_max: int, band: int) -> dict | None:
    """The walk's plan at a shape from the built library
    (``pw_walk_plan``), with ``walk_plan``'s keys."""
    out = (ctypes.c_int * 5)()
    if _fn("pw_walk_plan")(m_max, band, ctypes.addressof(out)):
        return None
    return dict(body="ring" if out[0] else "wide", chunk_rows=out[1],
                chunks_ahead=out[2], warps=out[3], smem=out[4])


def launch_forward(streamed: bool, qp: torch.Tensor, tp: torch.Tensor,
                   q_lens: torch.Tensor, t_lens: torch.Tensor, m_max: int,
                   n: int, dlo: int, band: int, params: ScoreParams,
                   ptrs, score, b0, mat0) -> None:
    """Launch fwdptr on the current stream into caller-allocated outputs;
    ``qp``/``tp`` come from ``pad16``, the lengths are int32.  No checks
    beyond the launcher's: ``forward_kernel`` is the checked entry
    point, this is its launch alone, for a timing loop."""
    rc = _fn("pw_fwdptr")(
        int(streamed), qp.data_ptr(), qp.stride(0), tp.data_ptr(),
        tp.stride(0), q_lens.data_ptr(), t_lens.data_ptr(), qp.shape[0],
        m_max, n, dlo, band, params.match, params.mismatch, params.go,
        params.gap_extend, ptrs.data_ptr(), score.data_ptr(),
        b0.data_ptr(), mat0.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "fwdptr_long" if streamed else "fwdptr")
    LAUNCHES["fwdptr_long" if streamed else "fwdptr"] += 1


def launch_walk(ptrs, b0, mat0, q_lens, iy_runs, ops_rows, b_f) -> None:
    """Launch walk on the current stream into caller-allocated outputs
    (the timing-loop counterpart of ``walk_kernel``)."""
    T, m_max, band = ptrs.shape
    rc = _fn("pw_walk")(
        ptrs.data_ptr(), b0.data_ptr(), mat0.data_ptr(), q_lens.data_ptr(),
        T, m_max, band, iy_runs.data_ptr(), ops_rows.data_ptr(),
        b_f.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "walk")
    LAUNCHES["walk"] += 1


def _lens(x: torch.Tensor, T: int, dev) -> torch.Tensor:
    x = x.to(device=dev, dtype=torch.int32).contiguous()
    if x.shape != (T,):
        raise ValueError(f"lengths of shape {tuple(x.shape)}, want ({T},)")
    return x


def forward_kernel(qs: torch.Tensor, ts: torch.Tensor, q_lens, t_lens,
                   dlo: int, band: int, params: ScoreParams = ScoreParams(),
                   streamed: bool = False):
    """``forward_plain`` on the card: the fwdptr kernel (``streamed``
    picks the variant).  Pointers of rows past a lane's q_len are left
    unwritten (no reader exists).  Raises when the shape does not fit
    the variant's shared memory."""
    if qs.device.type != "cuda" or ts.device != qs.device:
        raise ValueError("forward_kernel: qs and ts must be on one CUDA "
                         f"device, got {qs.device} and {ts.device}")
    if qs.dtype != torch.int8 or ts.dtype != torch.int8 or qs.dim() != 2 \
            or ts.dim() != 2 or qs.shape[0] != ts.shape[0]:
        raise ValueError("forward_kernel: need int8 (T, m_max) and (T, n) "
                         f"codes, got {qs.dtype} {tuple(qs.shape)} and "
                         f"{ts.dtype} {tuple(ts.shape)}")
    T, m_max = qs.shape
    n = ts.shape[1]
    if not _fn("pw_fwd_smem")(int(streamed), m_max, n, band):
        raise ValueError(
            f"the {'streamed' if streamed else 'resident'} realign kernel "
            f"does not take band {band} at m_max={m_max}, n={n}: "
            f"{_LIMITS}")
    dev = qs.device
    ptrs = torch.empty((T, m_max, band), dtype=torch.uint8, device=dev)
    score, b0, mat0 = (torch.empty(T, dtype=torch.int32, device=dev)
                       for _ in range(3))
    if T:
        with torch.cuda.device(dev):
            launch_forward(streamed, pad16(qs), pad16(ts),
                           _lens(q_lens, T, dev), _lens(t_lens, T, dev),
                           m_max, n, int(dlo), band, params, ptrs, score,
                           b0, mat0)
    return ptrs, score, b0, mat0


def walk_kernel(ptrs: torch.Tensor, b0: torch.Tensor, mat0: torch.Tensor,
                q_lens: torch.Tensor):
    """``walk_plain`` on the card: the walk kernel."""
    if ptrs.device.type != "cuda" or ptrs.dtype != torch.uint8 \
            or ptrs.dim() != 3 or not ptrs.is_contiguous():
        raise ValueError("walk_kernel: need a contiguous (T, m_max, band) "
                         f"uint8 CUDA tensor, got {ptrs.dtype} "
                         f"{tuple(ptrs.shape)} on {ptrs.device}")
    T, m_max, band = ptrs.shape
    dev = ptrs.device
    iy_runs = torch.empty((T, m_max), dtype=torch.int32, device=dev)
    ops_rows = torch.empty((T, m_max), dtype=torch.int8, device=dev)
    b_f = torch.empty(T, dtype=torch.int32, device=dev)
    if T:
        with torch.cuda.device(dev):
            launch_walk(ptrs, _lens(b0, T, dev), _lens(mat0, T, dev),
                        _lens(q_lens, T, dev), iy_runs, ops_rows, b_f)
    return iy_runs, ops_rows, b_f


# ---------------------------------------------------------------------------
# the batched entry point
# ---------------------------------------------------------------------------
def banded_realign_rows(qs: torch.Tensor, ts: torch.Tensor,
                        q_lens: torch.Tensor, t_lens: torch.Tensor,
                        band: int = 64,
                        params: ScoreParams = ScoreParams(),
                        dlo: int | None = None):
    """Batched banded re-alignment, compressed row form, on the inputs'
    device.

    qs: (T, m_max) int8 per-lane query segments (codes, pad 127)
    ts: (T, n) int8 per-lane targets (codes, pad 127)
    q_lens / t_lens: (T,) true lengths
    dlo: band placement (diagonals covered are [dlo, dlo+band)); default
    centers the band on the main diagonal.

    Returns ``(scores, leads, iy_runs, ops_rows, ok)``:
    scores (T,) int32 global scores at (q_len, t_len);
    leads (T,) int32 leading gap-in-query run;
    iy_runs (T, m_max) int32 per-row Iy run AFTER the row's op;
    ops_rows (T, m_max) int8 per-row leaving op (1=DIAG, 2=IX; 0 pad);
    ok (T,) bool — band covered the end cell and the walk closed.

    A CPU tensor takes the plain versions.  A CUDA tensor launches the
    forward and walk kernels or raises: the forward variant comes from
    the shared-memory budget (``select_kernel``), and a band or shape
    that no variant takes raises."""
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    dlo = -(band // 2) if dlo is None else int(dlo)
    T, m_max = qs.shape
    n = ts.shape[1]
    if qs.device.type == "cpu":
        ptrs, scores, b0, mat0 = forward_plain(qs, ts, q_lens, t_lens, dlo,
                                               band, params)
        iy_runs, ops_rows, b_f = walk_plain(ptrs, b0, mat0, q_lens)
    elif qs.device.type == "cuda":
        name = select_kernel(m_max, n, band)
        if name is None:
            raise ValueError(f"no realign kernel takes band {band} at "
                             f"m_max={m_max}, n={n}: {_LIMITS}")
        ptrs, scores, b0, mat0 = forward_kernel(
            qs, ts, q_lens, t_lens, dlo, band, params,
            streamed=name == "streamed")
        iy_runs, ops_rows, b_f = walk_kernel(ptrs, b0, mat0, q_lens)
    else:
        raise ValueError(f"banded_realign_rows: unsupported device "
                         f"{qs.device}")
    leads, ok = leads_ok(scores, b_f, dlo)
    return scores, leads, iy_runs, ops_rows, ok


def banded_traceback_batch(qs: torch.Tensor, ts: torch.Tensor,
                           q_lens: torch.Tensor, t_lens: torch.Tensor,
                           band: int = 64,
                           params: ScoreParams = ScoreParams(),
                           dlo: int | None = None):
    """Batched banded re-alignment with an expanded op-string traceback:
    ``banded_realign_rows``, its compressed rows expanded on the host.
    Returns numpy ``(scores, ops_bwd, ok)`` with ops_bwd (T, m_max + n)
    int8 REVERSE-order ops, 0-padded (all 0 where not ok)."""
    scores, leads, iy_runs, ops_rows, ok = (
        x.cpu().numpy() for x in banded_realign_rows(
            qs, ts, q_lens, t_lens, band=band, params=params, dlo=dlo))
    T, m_max = iy_runs.shape
    ql = q_lens.cpu().numpy()
    ops_bwd = np.zeros((T, m_max + ts.shape[1]), dtype=np.int8)
    for k in np.flatnonzero(ok):
        fwd = rows_to_ops_fwd(int(leads[k]), iy_runs[k], ops_rows[k],
                              int(ql[k]))
        ops_bwd[k, :len(fwd)] = fwd[::-1]
    return scores, ops_bwd, ok


# ---------------------------------------------------------------------------
# gap extraction on the device: compressed rows -> fixed-capacity slots
# ---------------------------------------------------------------------------
def gap_slots(leads: torch.Tensor, iy_runs: torch.Tensor,
              ops_rows: torch.Tensor, q_lens: torch.Tensor, max_gaps: int):
    """Per lane, up to ``max_gaps`` (pos, len) gap slots per side from
    the compressed rows, on their device: ``(rg_pos, rg_len, r_count,
    tg_pos, tg_len, t_count, overflow)``, int32 (T, G) slots, int32 (T,)
    counts and a bool (T,) overflow (more gaps than slots; the slots past
    G are dropped).  Query gaps: the lead run at qpos 0, then every row
    with an Iy run at qpos = row.  Target gaps: each maximal run of IX
    rows, at the target position where it starts."""
    dev = iy_runs.device
    T, m_max = iy_runs.shape
    G = max_gaps
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.arange(1, m_max + 1, **i32)
    lead = leads.to(**i32)
    live = rows[None, :] <= q_lens.to(**i32)[:, None]
    iy = torch.where(live, iy_runs.to(torch.int32), 0)
    opl = torch.where(live, ops_rows.to(torch.int32), 0)
    consumed = iy + (opl == OP_DIAG).to(torch.int32)
    # target bases consumed before each row's op (exclusive prefix)
    tcons = lead[:, None] + torch.cumsum(consumed, 1, dtype=torch.int32) \
        - consumed
    has_lead = (lead > 0).to(torch.int32)
    r_mask = iy > 0

    def scatter(slot, *vals):
        # slots >= G land in a spare column that is then dropped
        idx = slot.clamp(max=G).long()
        return [torch.zeros((T, G + 1), **i32).scatter_(1, idx, v)[:, :G]
                for v in vals]

    r_slot = torch.where(
        r_mask, torch.cumsum(r_mask, 1, dtype=torch.int32) - 1
        + has_lead[:, None], G)
    rg_pos, rg_len = scatter(r_slot, rows.expand(T, m_max), iy)
    if G:
        first = has_lead == 1
        rg_pos[:, 0] = torch.where(first, 0, rg_pos[:, 0])
        rg_len[:, 0] = torch.where(first, lead, rg_len[:, 0])
    r_count = r_mask.sum(1, dtype=torch.int32) + has_lead
    is_ix = opl == OP_IX
    prev = torch.cat([torch.zeros((T, 1), dtype=torch.bool, device=dev),
                      is_ix[:, :-1]], dim=1)
    start = is_ix & ~prev
    idx = torch.arange(m_max, **i32).expand(T, m_max)
    # the next non-IX row index at or after each row
    nni = torch.cummin(torch.where(is_ix, m_max, idx).flip(1),
                       dim=1).values.flip(1)
    t_slot = torch.where(start, torch.cumsum(start, 1, dtype=torch.int32)
                         - 1, G)
    tg_pos, tg_len = scatter(t_slot, tcons, nni - idx)
    t_count = start.sum(1, dtype=torch.int32)
    overflow = (r_count > G) | (t_count > G)
    return rg_pos, rg_len, r_count, tg_pos, tg_len, t_count, overflow


def realign_gaps_batch(qs: torch.Tensor, ts: torch.Tensor,
                       q_lens: torch.Tensor, t_lens: torch.Tensor,
                       band: int = 64, params: ScoreParams = ScoreParams(),
                       dlo: int | None = None, max_gaps: int = 32):
    """Re-align a batch and extract its gap records on the inputs'
    device: ``(scores, ok, gap_slots(...))``.  ``overflow`` lanes have
    more gaps than slots and must take the expanded-ops path.  Feed the
    slots to ``gap_slots_to_gapdata`` for the CIGAR-walk strand
    conventions."""
    scores, leads, iy_runs, ops_rows, ok = banded_realign_rows(
        qs, ts, q_lens, t_lens, band=band, params=params, dlo=dlo)
    return scores, ok, gap_slots(leads, iy_runs, ops_rows, q_lens,
                                 max_gaps)


def gap_slots_to_gapdata(rg_pos, rg_len, r_count, tg_pos, tg_len, t_count,
                         offset: int, r_len: int, eff_t_len: int,
                         reverse: int
                         ) -> tuple[list[GapData], list[GapData]]:
    """One lane's gap slots -> (rgaps, tgaps) GapData lists with the
    exact conventions of ``ops_to_gaps`` (strand flip included)."""
    rgaps: list[GapData] = []
    for i in range(int(r_count)):
        pos = offset + int(rg_pos[i])
        if reverse:
            pos = r_len - pos
        rgaps.append(GapData(pos, int(rg_len[i])))
    tgaps: list[GapData] = []
    for i in range(int(t_count)):
        pos = int(tg_pos[i])
        tgaps.append(GapData(eff_t_len - pos if reverse else pos,
                             int(tg_len[i])))
    return rgaps, tgaps


# ---------------------------------------------------------------------------
# host side: compressed rows -> op string -> GapData lists; the oracle
# ---------------------------------------------------------------------------
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


def ops_forward(ops_bwd_row: np.ndarray) -> np.ndarray:
    """Reverse the non-zero prefix of one traceback row into forward
    alignment order."""
    k = int((ops_bwd_row != 0).sum())
    return ops_bwd_row[:k][::-1]


def ops_consumed(ops_fwd: np.ndarray) -> tuple[int, int]:
    """(query bases, target bases) consumed by a forward op string."""
    q = int(((ops_fwd == OP_DIAG) | (ops_fwd == OP_IX)).sum())
    t = int(((ops_fwd == OP_DIAG) | (ops_fwd == OP_IY)).sum())
    return q, t


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


def ops_score(ops_fwd: np.ndarray, q: np.ndarray, t: np.ndarray,
              params: ScoreParams = ScoreParams()) -> int:
    """Score a forward op string (an independent check that a traceback
    path achieves the DP score)."""
    s = 0
    qpos = tpos = 0
    prev = 0
    for op in ops_fwd:
        if op == OP_DIAG:
            match = q[qpos] == t[tpos] and q[qpos] < 4
            s += params.match if match else -params.mismatch
            qpos += 1
            tpos += 1
        elif op == OP_IX:
            s -= params.go if prev != OP_IX else params.gap_extend
            qpos += 1
        elif op == OP_IY:
            s -= params.go if prev != OP_IY else params.gap_extend
            tpos += 1
        prev = op
    return s


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


# ---------------------------------------------------------------------------
# the host batch loop: encode, bucket, dispatch, escalate, oracle
# ---------------------------------------------------------------------------
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


# a full-matrix Python traceback beyond this many cells would burn
# minutes of interpreter time; the native oracle takes over far beyond
# it (bounded by its one pointer byte per cell)
_ORACLE_CELL_LIMIT = 4_000_000
_NATIVE_ORACLE_CELL_LIMIT = 256_000_000   # ~256 MB of pointer bytes
_MAX_BAND = 4096
# ceiling on the pointer tensor (T_chunk x m_max x band uint8) per
# dispatch; lanes are chunked to stay under it, and a single lane whose
# m_max x band alone exceeds it skips the device path entirely
_PTR_BYTES_LIMIT = 1 << 30


def realign_pairs(pairs: list[tuple[bytes, bytes]], band: int = 64,
                  params: ScoreParams = ScoreParams(), *,
                  device: torch.device):
    """Re-align a batch of (query_segment, target) byte-string pairs on
    ``device``.

    Returns a list of (score, ops_fwd) — or ``None`` for pairs that
    could not be re-aligned within resource bounds (callers keep their
    original gap structure).  Sequences are encoded upper-case.  Lanes
    are grouped by their 128-rounded (query, target) shape bucket before
    dispatch, so one long target pads only its own group's tensors.
    Lanes whose end diagonal the band cannot cover retry with an
    escalated band (x4 per retry up to 4096); leftovers of at most
    ``_NATIVE_ORACLE_CELL_LIMIT`` cells use the native host oracle."""
    from pwasm_tpu_torch.core.dna import encode
    from pwasm_tpu_torch.parallel.bucketing import group_by_shape

    if not pairs:
        return []
    enc = [(encode(qb.upper()), encode(tb.upper())) for qb, tb in pairs]
    out: list = [None] * len(pairs)
    groups = group_by_shape((len(qc), len(tc)) for qc, tc in enc)
    for (mb, nb), idxs in sorted(groups.items()):
        _realign_group(enc, idxs, mb, nb, band, params, out, device)
    return out


def _realign_group(enc, idxs: list[int], m_max: int, n: int, band: int,
                   params: ScoreParams, out: list,
                   device: torch.device) -> None:
    """Dispatch one shape bucket of ``realign_pairs`` lanes (padded to
    (m_max, n)), writing results into ``out`` at their original
    indices."""
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
    # always try the caller's own band, even above the escalation
    # ceiling; the ceiling bounds only the automatic retries
    while len(todo) and (first or cur_band <= _MAX_BAND):
        first = False
        lane_bytes = m_max * cur_band
        if lane_bytes > _PTR_BYTES_LIMIT:
            break  # even one lane's pointer plane is too large
        chunk = max(1, _PTR_BYTES_LIMIT // lane_bytes)
        still = []
        for c0 in range(0, len(todo), chunk):
            sub = todo[c0:c0 + chunk]
            dlo = _pick_dlo(t_lens[sub] - q_lens[sub], cur_band)
            res = banded_realign_rows(
                *(torch.from_numpy(x[sub]).to(device)
                  for x in (qs, ts, q_lens, t_lens)),
                band=cur_band, params=params, dlo=dlo)
            scores, leads, iy_runs, ops_rows, ok = \
                (x.cpu().numpy() for x in res)
            for idx, k in enumerate(sub):
                if ok[idx]:
                    out[idxs[k]] = (int(scores[idx]),
                                    rows_to_ops_fwd(int(leads[idx]),
                                                    iy_runs[idx],
                                                    ops_rows[idx],
                                                    int(q_lens[k])))
            still.extend(sub[~ok])
        todo = np.array(still, dtype=np.int64)
        cur_band = max(cur_band * 4, 4)
    for k in todo:
        # beyond the band ceiling: the native host oracle (the same
        # tie-breaks) up to ~64x the Python oracle's cells, the Python
        # one when the native pointer matrix cannot be allocated (or
        # PWASM_NATIVE=0), or give up
        cells = int(q_lens[k]) * int(t_lens[k])
        res = None
        if cells <= _NATIVE_ORACLE_CELL_LIMIT and native.enabled():
            res = native.gotoh_traceback(
                qs[k, :q_lens[k]], ts[k, :t_lens[k]], params.match,
                params.mismatch, params.gap_open, params.gap_extend)
        if res is None and cells <= _ORACLE_CELL_LIMIT:
            res = full_gotoh_traceback(qs[k, :q_lens[k]],
                                       ts[k, :t_lens[k]], params)
        if res is not None:
            out[idxs[k]] = res
