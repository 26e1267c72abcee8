"""Many-to-many scoring: every query against every target.

Counterpart of ``pwasm_tpu/parallel/many2many.py`` on one device:
BASELINE.md config #3, many bacterial CDS queries against many assembly
targets — the full (Q x T) matrix of banded affine-gap DP global scores
(``ops/banded_dp.py::banded_scores_matrix``, the reference's
``many2many_scores``).  On a CUDA device one launch of the scores kernel
covers a dispatch's whole Q x T cross product; on the CPU the plain
version runs.  The 2-D mesh (``make_mesh2d``/``make_many2many``) comes
with the multi-GPU slice.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pwasm_tpu_torch.ops.banded_dp import (NEG, ScoreParams, band_dlo,
                                           banded_scores_matrix)
from pwasm_tpu_torch.parallel.bucketing import (bucket_queries, encode_seqs,
                                                pad_to_width)


def many2many_scores_ragged(qs, ts, band: int = 64,
                            params: ScoreParams = ScoreParams(), *,
                            device: torch.device,
                            stats: dict | None = None) -> np.ndarray:
    """(Q, T) int32 scores for RAGGED query/target sequence lists
    (bytes/str or int8 code arrays), computed on ``device``.

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
    the copy of the scores to the host) and ``dispatches`` (the
    launches made)."""
    t0 = time.perf_counter()
    qbs = bucket_queries(list(qs))
    ts_enc = encode_seqs(ts)
    t_len = np.array([len(t) for t in ts_enc], dtype=np.int64)
    Q, T = sum(len(qb.idx) for qb in qbs), len(ts_enc)
    width = max([qb.width for qb in qbs], default=0) + max(band - 2, 0)
    tall = pad_to_width(ts_enc, width)
    t_all = torch.from_numpy(tall.data).to(device)
    lens_all = torch.from_numpy(tall.lens).to(device)
    out = torch.full((Q, T), NEG, dtype=torch.int32, device=device)
    t1 = time.perf_counter()
    dispatches = 0
    for qb in qbs:
        m = qb.width
        qd = torch.from_numpy(qb.data).to(device)
        rows = torch.from_numpy(qb.idx).to(device)
        for group, n_eff in ((t_len <= m, m), (t_len > m, m + band - 2)):
            if not group.any():
                continue
            b_end = t_len - m - band_dlo(m, n_eff, band)
            keep = np.flatnonzero(group & (b_end >= 0) & (b_end < band))
            if not len(keep):
                continue
            cols = torch.from_numpy(keep).to(device)
            s = banded_scores_matrix(qd, t_all[cols, :n_eff],
                                     lens_all[cols], band, params)
            out[rows[:, None], cols[None, :]] = s
            dispatches += 1
    res = out.cpu().numpy()
    if stats is not None:
        stats["bucket_s"] = stats.get("bucket_s", 0.0) + t1 - t0
        stats["score_s"] = stats.get("score_s", 0.0) \
            + time.perf_counter() - t1
        stats["dispatches"] = stats.get("dispatches", 0) + dispatches
    return res
