"""Many-to-many scoring: every query against every target.

Counterpart of ``pwasm_tpu/parallel/many2many.py``:
BASELINE.md config #3, many bacterial CDS queries against many assembly
targets — the full (Q x T) matrix of banded affine-gap DP global scores
(``ops/banded_dp.py::banded_scores_matrix``, the reference's
``many2many_scores``).  On a CUDA device one launch of the scores kernel
covers a dispatch's whole Q x T cross product; on the CPU the plain
version runs.  ``make_many2many`` spreads the (Q x T) matrix over a 2-D
(query x target) mesh (``make_mesh2d``): each tile is scored on its own
device, and no collective is needed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pwasm_tpu_torch.ops.banded_dp import (NEG, ScoreParams, band_dlo,
                                           banded_scores_matrix)
from pwasm_tpu_torch.parallel.bucketing import (bucket_queries, encode_seqs,
                                                pad_to_width)
from pwasm_tpu_torch.parallel.mesh import (Mesh, _inner_factor, device_grid,
                                           device_pool, grid_of, shard_bounds)
from pwasm_tpu_torch.resilience.guardrails import check_scores_matrix


def make_mesh2d(n_devices: int | None = None,
                axis_names: tuple[str, str] = ("query", "target"),
                devices=None) -> Mesh:
    """A 2-D mesh over the first ``n_devices`` devices of the pool
    (``devices``, else every visible CUDA device); the query axis gets
    the largest factor <= sqrt(n) (targets usually outnumber queries, so
    the target axis gets the bigger factor)."""
    devs = device_pool(n_devices, devices)
    nq = _inner_factor(len(devs))
    return Mesh(grid_of(devs, (nq, len(devs) // nq)), axis_names)


def make_many2many(mesh: Mesh, band: int = 64,
                   params: ScoreParams = ScoreParams()):
    """The sharded many-to-many scorer.

    Returns ``fn(qs (Q, m), ts (T, n), t_lens (T,)) -> (Q, T)`` int32
    scores (CPU tensor) with Q split over mesh axis 'query' and T over
    'target': each (query shard, target shard) tile runs
    ``banded_scores_matrix`` on its device (the scores kernel the budget
    picks on a CUDA device), every tile launched before any is fetched,
    and the tiles are stitched back into (Q, T)."""
    grid = device_grid(mesh, ("query", "target"))
    nq, nt = grid.shape

    def fn(qs, ts, t_lens):
        qs, ts, t_lens = (torch.as_tensor(x) for x in (qs, ts, t_lens))
        tiles = [((qa, qb, ta, tb), banded_scores_matrix(
            qs[qa:qb].to(grid[i, j]), ts[ta:tb].to(grid[i, j]),
            t_lens[ta:tb].to(grid[i, j]), band, params))
            for i, (qa, qb) in enumerate(shard_bounds(len(qs), nq))
            for j, (ta, tb) in enumerate(shard_bounds(len(ts), nt))
            if qa < qb and ta < tb]
        out = torch.empty((len(qs), len(ts)), dtype=torch.int32)
        for (qa, qb, ta, tb), s in tiles:
            out[qa:qb, ta:tb] = s.cpu()
        return out

    return fn


def many2many_scores_ragged(qs, ts, band: int = 64,
                            params: ScoreParams = ScoreParams(), *,
                            device: torch.device | None = None,
                            mesh: Mesh | None = None,
                            stats: dict | None = None,
                            supervisor=None) -> np.ndarray:
    """(Q, T) int32 scores for RAGGED query/target sequence lists
    (bytes/str or int8 code arrays), computed on ``device``, or with
    ``mesh`` (a 2-D (query x target) mesh, ``make_mesh2d``) over its
    tiles: each dispatch is ``make_many2many(mesh)``'s tiled scorer,
    each tile on its own device, bit-equal to the unsharded call.

    Queries bucket by exact length; for each query bucket the targets
    dispatch in TWO width groups, because the band placement
    ``band_dlo(m, n, band)`` couples the covered diagonal window to the
    padded width:

    - targets with ``t_len <= m`` at width ``m`` (dlo = -band//2);
    - longer targets at width ``m + band - 2`` (dlo = -1); targets longer
      than that are clipped, which cannot change any score — their end
      diagonal is out of band (NEG either way).

    Cells whose end diagonal falls outside [-band//2, band-2] are NEG.
    Whether a target's end cell (m, t_len) lies in a group's band
    depends on the target alone (``0 <= t_len - m - dlo < band``, m and
    dlo fixed per group), so only the in-band targets are dispatched:
    the others keep the NEG ``out`` starts with, which is what the
    kernel would give them.  The group's ``band_dlo`` runs before that
    filter, so a band too narrow for a group that has targets still
    raises ``BandPlacementError``.  The targets are clipped and padded
    once to the widest width any group needs (the longest query + band
    - 2, whatever the longest target) and sent to the device once; each
    group takes its rows and first ``n`` columns there, which is
    ``pad_to_width`` of those targets at that width.  Results scatter
    back to input order.  ``stats``, when given, gains ``bucket_s``
    (host bucketing and upload), ``score_s`` (the dispatches, through
    the copies of the scores to the host) and ``dispatches`` (the
    dispatches made).  Each launch is one ``many2many`` dispatch that
    ends in the copy of its (rows x in-band targets) block to the host,
    supervised by ``supervisor`` (``resilience/supervisor.py``: the
    block checked by ``check_scores_matrix``) or, with None, a direct
    call; the blocks scatter into the result after each dispatch
    returns, so an attempt writes into no shared array."""
    if (device is None) == (mesh is None):
        raise ValueError("many2many_scores_ragged takes a device or a "
                         "mesh")
    tiled = None
    if mesh is not None:
        tiled = make_many2many(mesh, band, params)
        device = device_grid(mesh, ("query", "target"))[0, 0]
    t0 = time.perf_counter()
    qbs = bucket_queries(list(qs))
    ts_enc = encode_seqs(ts)
    t_len = np.array([len(t) for t in ts_enc], dtype=np.int64)
    Q, T = sum(len(qb.idx) for qb in qbs), len(ts_enc)
    width = max([qb.width for qb in qbs], default=0) + max(band - 2, 0)
    tall = pad_to_width(ts_enc, width, truncate=True)
    t_all = torch.from_numpy(tall.data).to(device)
    lens_all = torch.from_numpy(tall.lens).to(device)
    out = np.full((Q, T), NEG, dtype=np.int32)
    t1 = time.perf_counter()
    dispatches = 0
    for qb in qbs:
        m = qb.width
        qd = torch.from_numpy(qb.data).to(device)
        for group, n_eff in ((t_len <= m, m), (t_len > m, m + band - 2)):
            if not group.any():
                continue
            b_end = t_len - m - band_dlo(m, n_eff, band)
            keep = np.flatnonzero(group & (b_end >= 0) & (b_end < band))
            if not len(keep):
                continue
            cols = torch.from_numpy(keep).to(device)

            def dispatch(qd=qd, cols=cols, n_eff=n_eff):
                if tiled is not None:
                    return tiled(qd, t_all[cols, :n_eff],
                                 lens_all[cols]).numpy()
                return banded_scores_matrix(
                    qd, t_all[cols, :n_eff], lens_all[cols], band,
                    params).cpu().numpy()

            if supervisor is None:
                block = dispatch()
            else:
                block = supervisor.run(
                    "many2many", dispatch,
                    validate=lambda s, n=len(qb.idx), k=len(keep), m=m:
                        check_scores_matrix(s, n, k, params.match, m))
            out[np.ix_(qb.idx, keep)] = block
            dispatches += 1
    if stats is not None:
        stats["bucket_s"] = stats.get("bucket_s", 0.0) + t1 - t0
        stats["score_s"] = stats.get("score_s", 0.0) \
            + time.perf_counter() - t1
        stats["dispatches"] = stats.get("dispatches", 0) + dispatches
    return out
