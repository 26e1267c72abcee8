"""Per-column consensus: pileup counting + the reference vote rule.

Counterpart of ``pwasm_tpu/ops/consensus.py``.  The vote is the closed
form of the reference's bestChar stable-sort + '-'/'N'-yield rule
(GapAssem.cpp:1048-1069):

- if any of A/C/G/T reaches the max count, the first of them (A<C<G<T) wins;
- else if N and '-' tie at the max, '-' wins;
- else whichever of N/'-' holds the max;
- a zero-coverage column votes ``CODE_ZERO_COV``.

``consensus_counts_votes`` launches the CUDA kernel
(``csrc/consensus.cu``, replacing the TPU kernel ``_consensus_kernel``)
for a CUDA tensor and runs the plain torch version for a CPU tensor.
The kernel splits the depth across the blocks of a thread-block cluster
(``consensus_plan``).  ``LAUNCHES`` counts kernel launches.

Everything is integer: int8 base codes in, int32 counts, int8 votes out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pwasm_tpu_torch.ops import _build
from pwasm_tpu_torch.ops.consensus_host import CODE_ZERO_COV, N_CLASSES

LAUNCHES = 0
_FNS: dict = {}    # the bound C entry points, set on first use
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "pw_consensus": ([_P, _I, _I, _P, _P, _P], _I),
    "pw_consensus_plan": ([_I, _I, _P], _I),
}
# the kernel's layout (csrc/consensus.cu): threads a block, 4 columns a
# thread, at most 8 blocks a cluster, the grid's target of two blocks an
# SM of the H100's 132, and at least 16 rows a block
THREADS = 128
TILE_COLS = 4 * THREADS
MAX_CLUSTER = 8
TARGET_BLOCKS = 264
MIN_ROWS = 16


def pileup_counts(pile: torch.Tensor) -> torch.Tensor:
    """(depth, cols) integer codes -> (cols, 6) int32 counts; codes
    outside [0, 6) are ignored."""
    return torch.stack([(pile == k).sum(0, dtype=torch.int32)
                        for k in range(N_CLASSES)], dim=1)


def consensus_vote_counts(counts: torch.Tensor) -> torch.Tensor:
    """Vote per column from (cols, 6) counts -> (cols,) int8 codes
    (0..3 ACGT, 4 N, 5 gap, CODE_ZERO_COV for empty columns)."""
    counts = counts.to(torch.int32)
    acgt = counts[..., :4]
    n = counts[..., 4]
    gap = counts[..., 5]
    m_acgt = acgt.amax(dim=-1)
    m_all = torch.maximum(m_acgt, torch.maximum(n, gap))
    # first ACGT index at the max: masked minimum over the class axis
    kidx = torch.arange(4, device=counts.device)
    first_acgt = torch.where(acgt == m_all[..., None], kidx,
                             N_CLASSES).amin(dim=-1)
    acgt_wins = m_acgt == m_all
    both_tie = (n == m_all) & (gap == m_all)
    n_wins = (n == m_all) & ~both_tie
    code = torch.where(acgt_wins, first_acgt,
                       torch.where(n_wins, 4, 5))
    layers = counts.sum(dim=-1)
    return torch.where(layers == 0, CODE_ZERO_COV, code).to(torch.int8)


def consensus_counts_votes_plain(pile: torch.Tensor):
    """The plain torch version of the kernel: (votes int8 (cols,),
    counts int32 (cols, 6)) on ``pile``'s device."""
    counts = pileup_counts(pile)
    return consensus_vote_counts(counts), counts


def consensus_counts_votes(pile: torch.Tensor, assume_valid: bool = False):
    """Counts + votes of a (depth, cols) int8 pileup.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream or raises.  ``assume_valid`` is
    accepted for the reference's signature and ignored: the kernel
    masks out-of-range codes at no measurable cost.  Returns (votes int8
    (cols,), counts int32 (cols, 6)) on ``pile``'s device."""
    del assume_valid
    if pile.device.type == "cpu":
        return consensus_counts_votes_plain(pile)
    if pile.device.type != "cuda":
        raise ValueError(f"consensus_counts_votes: unsupported device "
                         f"{pile.device}")
    if pile.dtype != torch.int8 or pile.dim() != 2 \
            or not pile.is_contiguous():
        raise ValueError("consensus_counts_votes: need a contiguous 2-D "
                         f"int8 pileup, got {pile.dtype} "
                         f"{tuple(pile.shape)}")
    cols = pile.shape[1]
    counts = torch.empty((cols, N_CLASSES), dtype=torch.int32,
                         device=pile.device)
    votes = torch.empty((cols,), dtype=torch.int8, device=pile.device)
    if cols == 0:
        return votes, counts
    with torch.cuda.device(pile.device):
        launch(pile, counts, votes)
    return votes, counts


def consensus_plan(depth: int, cols: int) -> dict | None:
    """The kernel's plan at a shape, the mirror of
    ``csrc/consensus.cu::pw_consensus_plan`` (``kernel_plan`` reads that
    one from the built library): ``cluster`` blocks S sharing a column
    tile, each counting a slab of the rows (the least of MAX_CLUSTER, the
    clusters that bring the grid to TARGET_BLOCKS and depth // MIN_ROWS,
    at least 1), ``blocks`` in the grid, ``threads`` a block,
    ``tile_cols`` a tile, ``rows`` a block at most and the block's
    shared-memory bytes ``smem`` (its int32 counts of six classes for
    the tile).  None for a negative depth or cols."""
    if depth < 0 or cols < 0:
        return None
    tiles = -(-cols // TILE_COLS)
    s = max(1, min(MAX_CLUSTER, -(-TARGET_BLOCKS // max(tiles, 1)),
                   depth // MIN_ROWS))
    return dict(cluster=s, blocks=tiles * s, threads=THREADS,
                tile_cols=TILE_COLS, rows=-(-depth // s),
                smem=4 * N_CLASSES * TILE_COLS)


def _fn(name: str):
    """The C entry point ``pw_consensus`` or ``pw_consensus_plan`` of
    ``csrc/consensus.cu``, built and bound on first use."""
    return _build.bind("consensus", _SIGS, _FNS)[name]


def kernel_plan(depth: int, cols: int) -> dict | None:
    """The kernel's plan at a shape from the built library
    (``pw_consensus_plan``), with ``consensus_plan``'s keys."""
    out = (ctypes.c_int * 6)()
    if _fn("pw_consensus_plan")(depth, cols, ctypes.addressof(out)):
        return None
    return dict(zip(("cluster", "blocks", "threads", "tile_cols", "rows",
                     "smem"), out))


def launch(pile: torch.Tensor, counts: torch.Tensor,
           votes: torch.Tensor) -> None:
    """Launch the kernel on the current device's current stream into
    caller-allocated outputs; no checks.  ``consensus_counts_votes`` is
    the checked entry point; this is its launch alone, which a timing
    loop can call without the wrapper's allocations."""
    global LAUNCHES
    depth, cols = pile.shape
    rc = _fn("pw_consensus")(pile.data_ptr(), depth, cols,
                             counts.data_ptr(), votes.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"consensus kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1


def votes_to_chars(votes, star_gap: bool = True) -> bytes:
    """Map vote codes to consensus characters ('*' for gap columns when
    ``star_gap``, matching refineMSA's consensus string)."""
    table = np.frombuffer(b"ACGTN" + (b"*" if star_gap else b"-"),
                          dtype=np.uint8)
    v = votes.cpu().numpy() if isinstance(votes, torch.Tensor) \
        else np.asarray(votes)
    if (v < 0).any():
        raise ValueError("zero-coverage column in votes")
    return table[v.astype(np.int64)].tobytes()
