"""Device meshes and the sharded programs over them.

Counterpart of ``pwasm_tpu/parallel/mesh.py``.  The reference spreads a
program over a ``jax.sharding.Mesh`` with ``shard_map`` inside one
process; the port keeps that one process and holds a grid of
``torch.device`` entries:

- each shard's work is launched on its own device (the kernels'
  wrappers enter ``torch.cuda.device``), every shard before any result
  is fetched, so several cards run at once;
- the reference's depth ``psum`` of int32 pileup counts becomes the
  column shard's first device summing its depth shards' counts after a
  peer copy (``.to``); integer sums are exact in any order, so every
  sharded result equals the unsharded one bit for bit;
- the axes are the reference's: ``batch`` (targets, pileup columns),
  ``depth`` (pileup rows, the only reduction) and, on a multi-slice
  mesh, an outer ``slice`` axis that shards like ``batch``.

An axis of ``n`` rows splits into contiguous shards of ``ceil(n /
shards)`` rows (``shard_bounds``), the layout ``shard_map`` gives an
axis padded to a multiple of the shard count.  A mesh may name one
device more than once: each entry is then a shard run in turn on that
device, which is how the tests (on the CPU) and ``chip_smoke.py`` (on
one card) give the split, pad and reduce real work.  The CLI builds its
mesh from the distinct visible devices (``visible_devices``).

An unsharded run is the one-shard case: the port's device entry points
(``device_counts_votes``, ``realign_pairs``, ``refine_phases``,
``submit_events_device``) take a ``torch.device`` or a ``Mesh`` and run
both through the sharded program, a device as its 1 x 1 mesh
(``as_mesh``).
"""

from __future__ import annotations

import numpy as np
import torch

from pwasm_tpu_torch.ops.banded_dp import ScoreParams, banded_scores
from pwasm_tpu_torch.ops.consensus import (consensus_counts_votes,
                                           consensus_vote_counts)

PILE_PAD = 6     # the pileup code that counts in no class


class Mesh:
    """A named grid of devices: ``devices`` is an object array of
    ``torch.device`` entries whose axes are ``axis_names``, and ``shape``
    maps each axis name to its size, in axis order."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of {arr.ndim} axes needs as many "
                             f"names, got {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))


def as_mesh(where) -> Mesh:
    """``where`` as a mesh: a ``Mesh`` as it is, a ``torch.device`` as
    the 1 x 1 (batch, depth) mesh of that device."""
    if isinstance(where, Mesh):
        return where
    return Mesh(grid_of([torch.device(where)], (1, 1)), ("batch", "depth"))


def visible_devices() -> list[torch.device]:
    """The pool a mesh is built from: every CUDA device torch sees."""
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def _inner_factor(n: int) -> int:
    """Largest factor of n that is <= sqrt(n) — the innermost-axis size
    when factoring a device count into a 2-D grid."""
    for cand in range(int(n ** 0.5), 0, -1):
        if n % cand == 0:
            return cand
    return 1


def device_pool(n_devices: int | None, devices) -> list:
    """The first ``n_devices`` of ``devices`` (else of the visible
    devices); raises when none is left."""
    devs = list(devices) if devices is not None else visible_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("no devices to build a mesh over")
    return devs


def grid_of(devs: list, shape: tuple[int, ...]) -> np.ndarray:
    """``devs`` as an object array of ``shape``."""
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, str] = ("batch", "depth"),
              devices=None) -> Mesh:
    """A 2-D mesh over the first ``n_devices`` devices of the pool
    (``devices``, else ``visible_devices()``); the depth axis gets the
    largest factor <= sqrt(n) so both axes are exercised.  ``devices``
    may repeat a device (see the module docstring)."""
    devs = device_pool(n_devices, devices)
    d = _inner_factor(len(devs))
    return Mesh(grid_of(devs, (len(devs) // d, d)), axis_names)


def make_multislice_mesh(n_slices: int, n_devices: int | None = None,
                         axis_names: tuple[str, str, str] =
                         ("slice", "batch", "depth"),
                         devices=None) -> Mesh:
    """A 3-D (slice, batch, depth) mesh, 'slice' the outermost axis:
    consecutive devices belong to one slice, and each slice is factored
    as ``make_mesh`` factors its pool."""
    devs = device_pool(n_devices, devices)
    n = len(devs)
    if n % n_slices:
        raise ValueError(f"{n} devices don't split into {n_slices} slices")
    per = n // n_slices
    d = _inner_factor(per)
    return Mesh(grid_of(devs, (n_slices, per // d, d)), axis_names)


def shard_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """The rows ``[a, b)`` of each of ``parts`` contiguous shards of an
    axis of ``n`` rows: ``ceil(n / parts)`` each, so trailing shards
    may be short or empty."""
    size = -(-n // parts)
    return [(min(k * size, n), min((k + 1) * size, n))
            for k in range(parts)]


def device_grid(mesh: Mesh, axes) -> np.ndarray:
    """The mesh's devices over ``axes``, in that order, at index 0 of
    every other axis (an axis a program does not shard over replicates
    its work, which one copy computes here)."""
    idx = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
    kept = [a for a in mesh.axis_names if a in axes]
    return np.transpose(mesh.devices[idx], [kept.index(a) for a in axes])


def flat_devices(mesh: Mesh) -> list:
    """One device per shard when a program's axis splits over every
    mesh axis (row-major in the mesh's axis order)."""
    return list(mesh.devices.reshape(-1))


def sharded_counts_votes(mesh: Mesh, dp_axes=("batch",)):
    """Counts AND votes with the pileup sharded (depth, cols) over the
    mesh — the consensus path behind ``pafreport --shard``.

    Returns ``fn(pile (depth, cols)) -> (votes (cols,) int8, counts
    (cols, 6) int32)``, CPU tensors.  The columns split over the
    product of ``dp_axes``, the rows over ``depth``; ``pile`` (a numpy
    array or a tensor) is padded with code 6, which counts in no class,
    to a multiple of each, and the pad columns are sliced off.  Each
    (depth, column) tile is copied contiguously to its device and
    counted there by ``consensus_counts_votes`` (the consensus kernel on
    a CUDA device); the column shard's first device sums its depth
    shards' counts and votes on the sum (``consensus_vote_counts``).  A
    mesh of one depth shard keeps the kernel's own votes, so the 1 x 1
    mesh is the unsharded call."""
    grid = device_grid(mesh, (*dp_axes, "depth"))
    grid = grid.reshape(-1, grid.shape[-1])     # (column, depth) shards
    n_c, n_d = grid.shape

    def fn(pile):
        pile = torch.as_tensor(pile)
        depth, cols = pile.shape
        pad_d, pad_c = -depth % n_d, -cols % n_c
        if pad_d or pad_c:
            padded = torch.full((depth + pad_d, cols + pad_c), PILE_PAD,
                                dtype=pile.dtype, device=pile.device)
            padded[:depth, :cols] = pile
            pile = padded
        rows, width = pile.shape[0] // n_d, pile.shape[1] // n_c
        votes, counts = [], []
        for c in range(n_c):
            parts = [consensus_counts_votes(
                pile[d * rows:(d + 1) * rows, c * width:(c + 1) * width]
                .contiguous().to(grid[c, d])) for d in range(n_d)]
            if n_d == 1:
                vote, total = parts[0]
            else:
                total = sum((p[1].to(grid[c, 0]) for p in parts[1:]),
                            parts[0][1])
                vote = consensus_vote_counts(total)
            votes.append(vote)
            counts.append(total)
        return (torch.cat([v.cpu() for v in votes])[:cols],
                torch.cat([x.cpu() for x in counts])[:cols])

    return fn


def sharded_consensus(mesh: Mesh, dp_axes=("batch",)):
    """The votes alone of ``sharded_counts_votes``: ``fn(bases (depth,
    cols)) -> votes (cols,) int8``."""
    counts_votes = sharded_counts_votes(mesh, dp_axes)
    return lambda bases: counts_votes(bases)[0]


def sharded_refine_phases(mesh: Mesh, xdrop: int, match_sc: int,
                          mismatch_sc: int):
    """The X-drop clip-refinement phases (``ops/refine_clip.py::
    _phases``) with the MEMBER axis sharded over every mesh axis:
    members are independent lanes, the consensus is copied to every
    shard's device, and no reduction is needed.

    Returns ``fn(gseq, gxpos, cons, cpos, glen, totals, gclipL, gclipR,
    clipL0, clipR0, seqlens, cons_len) -> (clipL, clipR, missR, missL)``
    over the padded int64 host tensors ``refine_phases`` builds, CPU
    tensors out."""
    from pwasm_tpu_torch.ops.refine_clip import _phases

    devs = flat_devices(mesh)

    def fn(gseq, gxpos, cons, *per_member_and_len):
        *per_member, cons_len = per_member_and_len
        outs = [_phases(gseq[a:b].to(dev), gxpos[a:b].to(dev), cons.to(dev),
                        *(v[a:b].to(dev) for v in per_member), cons_len,
                        xdrop, match_sc, mismatch_sc)
                for dev, (a, b) in zip(devs, shard_bounds(len(gseq),
                                                          len(devs)))
                if a < b]
        return tuple(torch.cat([o[k].cpu() for o in outs])
                     for k in range(4))

    return fn


def make_pipeline_step(mesh: Mesh, band: int = 32,
                       params: ScoreParams = ScoreParams()):
    """The sharded pipeline step: batched banded DP scores over
    target-sharded lanes plus the depth-sharded consensus vote.

    Returns ``fn(q (m,), ts (T, n), t_lens (T,), pileup (depth, cols))
    -> (scores (T,) int32, votes (cols,) int8)``, CPU tensors.  Targets
    shard over 'batch', each shard scored by ``banded_scores`` (the
    scores kernel on a CUDA device); the pileup shards as in
    ``sharded_counts_votes``."""
    return _make_step(mesh, band, params, ("batch",))


def make_multislice_step(mesh: Mesh, band: int = 32,
                         params: ScoreParams = ScoreParams()):
    """``make_pipeline_step`` on a (slice, batch, depth) mesh: targets
    and pileup columns shard over slice x batch, the counts reduce over
    'depth' only."""
    return _make_step(mesh, band, params, ("slice", "batch"))


def _make_step(mesh: Mesh, band: int, params: ScoreParams, dp_axes):
    devs = list(device_grid(mesh, dp_axes).reshape(-1))
    cons = sharded_consensus(mesh, dp_axes)

    def step(q, ts, t_lens, pileup):
        q, ts, t_lens = (torch.as_tensor(x) for x in (q, ts, t_lens))
        parts = [banded_scores(q.to(dev), ts[a:b].to(dev),
                               t_lens[a:b].to(dev), band, params)
                 for dev, (a, b) in zip(devs, shard_bounds(len(ts),
                                                           len(devs)))
                 if a < b]
        votes = cons(pileup)
        scores = torch.cat([p.cpu() for p in parts]) if parts \
            else torch.empty(0, dtype=torch.int32)
        return scores, votes

    return step
