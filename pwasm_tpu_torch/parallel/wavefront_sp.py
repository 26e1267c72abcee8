"""Sequence-parallel banded DP: the query's rows split over a mesh axis.

Counterpart of ``pwasm_tpu/parallel/wavefront_sp.py``.  For a query too
long for one device's serial row loop, the rows split in contiguous
chunks over the ``seq`` axis of a mesh: each chunk advances the
wavefront (M, Ix, Iy in band coordinates) through its rows on its own
device with the row step every plain scorer uses (``ops/banded_dp.py::
make_row_step``), and hands the edge to the next device with ``.to``
(the reference's ``ppermute`` halo).  The carried state is exactly what
crosses a chunk boundary, so the scores equal ``banded_scores`` bit for
bit.

The reference pipelines its scan one target a stage so that every chip
works at once.  Here each chunk advances the whole target batch, one
chunk after another: the row step is plain torch, whose launches the
host issues one at a time, so a per-target pipeline would multiply the
launches by T with nothing to overlap them with.  A kernel for a chunk
with a carried-in wavefront is later speed work (ROADMAP.md).
"""

from __future__ import annotations

import torch

from pwasm_tpu_torch.ops.banded_dp import (ScoreParams, band_dlo,
                                           final_score, initial_wavefront,
                                           make_row_step)
from pwasm_tpu_torch.parallel.mesh import Mesh, device_grid


def make_wavefront_sp(mesh: Mesh, m: int, n: int, T: int, band: int = 64,
                      params: ScoreParams = ScoreParams(),
                      axis: str = "seq", m_true: int | None = None):
    """The sequence-parallel scorer for fixed shapes.

    Returns ``fn(q (m,), ts (T, n), t_lens (T,)) -> (T,) int32
    scores`` (CPU tensor).  ``m`` must divide by the ``axis`` size of
    the mesh; for a query that does not, pad it to the next multiple and
    pass its real length as ``m_true``: rows past ``m_true`` carry the
    wavefront through unchanged, so the scores equal those of the
    unpadded query (``wavefront_sp_scores`` pads automatically)."""
    D = mesh.shape[axis]
    if m % D != 0:
        raise ValueError(f"query length {m} must divide by mesh "
                         f"axis '{axis}' size {D}")
    if m_true is None:
        m_true = m
    if not 0 < m_true <= m:
        raise ValueError(f"m_true {m_true} outside (0, {m}]")
    chunk = m // D
    dlo = band_dlo(m_true, n, band)
    devs = list(device_grid(mesh, (axis,)))

    def fn(q, ts, t_lens):
        q, ts = torch.as_tensor(q), torch.as_tensor(ts)
        if ts.shape != (T, n) or q.shape != (m,):
            raise ValueError(f"want q ({m},) and ts ({T}, {n}), got "
                             f"{tuple(q.shape)} and {tuple(ts.shape)}")
        wave = None
        for d, dev in enumerate(devs):
            if wave is None:
                wave = [x.expand(T, band).contiguous() for x in
                        initial_wavefront(n, dlo, band, params, dev)]
            else:
                wave = [x.to(dev) for x in wave]   # the edge, handed on
            step = make_row_step(n, dlo, band, params, dev)
            t = ts.to(device=dev, dtype=torch.int32)
            qd = q.to(device=dev, dtype=torch.int32)
            for i in range(d * chunk + 1, min((d + 1) * chunk, m_true) + 1):
                wave = step(*wave, i, qd[i - 1].expand(T), t)
        tl = torch.as_tensor(t_lens).to(wave[0].device)
        return final_score(*wave, tl, m_true, dlo, band).cpu()

    return fn


def wavefront_sp_scores(q, ts, t_lens, mesh: Mesh, band: int = 64,
                        params: ScoreParams = ScoreParams(),
                        axis: str = "seq") -> torch.Tensor:
    """Sequence-parallel scores for one (q, ts) workload; a query length
    that does not divide the mesh axis is padded (code 127) to the next
    multiple, the pad rows carried through (``m_true``)."""
    q = torch.as_tensor(q)
    T, n = torch.as_tensor(ts).shape
    m = q.shape[0]
    D = mesh.shape[axis]
    m_pad = (m + D - 1) // D * D
    if m_pad != m:
        q = torch.cat([q, torch.full((m_pad - m,), 127, dtype=q.dtype,
                                  device=q.device)])
    fn = make_wavefront_sp(mesh, m_pad, n, T, band, params, axis,
                           m_true=m)
    return fn(q, ts, t_lens)
