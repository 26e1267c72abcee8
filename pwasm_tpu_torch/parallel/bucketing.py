"""Host-side length bucketing for ragged device batches.

Counterpart of ``pwasm_tpu/parallel/bucketing.py``: the re-aligner
(``ops/realign.py::realign_pairs``) groups lanes by their step-rounded
(query, target) shape, so one long outlier pads only its own group's
tensors; the many-to-many scorer (``parallel/many2many.py``) buckets
queries by exact length and clips and pads all targets once, to the
width its longest query needs (``pad_to_width(truncate=True)``).  Every
bucket keeps the original index of each row, so results scatter back to
input order (``scatter_results``); filler rows carry ``idx == -1``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

PAD = 127      # target-code sentinel the DP kernels treat as never-match


def round_up(x: int, step: int = 128) -> int:
    """``x`` rounded up to a positive multiple of ``step``."""
    return max(step, (x + step - 1) // step * step)


def mesh_multiple(mesh) -> int:
    """Total device count of a mesh (product of its axis sizes) — the
    multiple a dispatch whose axis splits over every mesh axis pads to,
    so every shard receives equal rows; ``mesh`` is any mesh with a
    ``.shape`` mapping."""
    return max(1, int(np.prod([int(v)
                               for v in dict(mesh.shape).values()])))


def group_by_shape(shapes: Iterable[Sequence[int]],
                   step: int = 128) -> dict[tuple, list[int]]:
    """Indices grouped by their step-rounded shape tuple — the n-D
    generalization used by the re-aligner's (query, target) buckets."""
    groups: dict[tuple, list[int]] = {}
    for k, shp in enumerate(shapes):
        key = tuple(round_up(int(x), step) for x in shp)
        groups.setdefault(key, []).append(k)
    return groups


def encode_seqs(seqs) -> list[np.ndarray]:
    """Normalize a ragged sequence list to int8 code arrays: bytes/str
    encode upper-case via ``core.dna.encode``; arrays pass through."""
    from pwasm_tpu_torch.core.dna import encode

    out = []
    for s in seqs:
        if isinstance(s, (bytes, bytearray)):
            out.append(encode(bytes(s).upper()))
        elif isinstance(s, str):
            out.append(encode(s.upper().encode()))
        else:
            out.append(np.asarray(s, dtype=np.int8))
    return out


@dataclass(frozen=True)
class Bucket:
    """One rectangular slice of a ragged batch.

    ``data``  (B, width) int8, padded with ``PAD``;
    ``lens``  (B,) int32 true lengths (0 for filler rows);
    ``idx``   (B,) int64 position of each row in the caller's input
              order, or -1 for filler rows added to satisfy
              ``batch_multiple``.
    """

    data: np.ndarray
    lens: np.ndarray
    idx: np.ndarray

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def n_real(self) -> int:
        return int((self.idx >= 0).sum())


def _build_bucket(enc: list[np.ndarray], idxs: list[int], width: int,
                  batch_multiple: int, pad: int) -> Bucket:
    """Rows ``enc[k][:width]`` for k in ``idxs``, padded with ``pad`` to
    ``width``, then filler rows (``idx == -1``, length 0) up to a
    multiple of ``batch_multiple``; ``lens`` holds the copied
    lengths."""
    n = len(idxs)
    B = -(-n // batch_multiple) * batch_multiple if batch_multiple > 1 \
        else n
    lens = np.zeros(B, dtype=np.int32)
    lens[:n] = [min(len(enc[k]), width) for k in idxs]
    data = np.full((B, width), pad, dtype=np.int8)
    # row-major: the live cells of all rows, in order, are the sequences
    # concatenated
    live = np.arange(width)[None, :] < lens[:, None]
    if n:
        data[live] = np.concatenate([enc[k][:width] for k in idxs])
    idx = np.full(B, -1, dtype=np.int64)
    idx[:n] = idxs
    return Bucket(data, lens, idx)


def bucket_targets(seqs, *, step: int = 128, batch_multiple: int = 1,
                   pad: int = PAD) -> list[Bucket]:
    """Group target sequences by step-rounded length into padded
    (B, width) tensors with true lengths, widest first.
    ``batch_multiple`` rounds each bucket's row count up with filler
    rows (``idx == -1``) so the batch axis divides a mesh factor."""
    enc = encode_seqs(seqs)
    groups: dict[int, list[int]] = {}
    for k, s in enumerate(enc):
        groups.setdefault(round_up(len(s), step), []).append(k)
    return [_build_bucket(enc, idxs, w, batch_multiple, pad)
            for w, idxs in sorted(groups.items(), reverse=True)]


def bucket_queries(seqs, *, batch_multiple: int = 1,
                   pad: int = PAD) -> list[Bucket]:
    """Group query sequences by EXACT length (the banded DP reads its
    global score at cell (m, t_len): padding the query axis would move
    the read row, so queries can only batch with equal-length peers),
    longest first.  Filler rows repeat ``pad`` and are dropped by
    ``scatter_results``."""
    enc = encode_seqs(seqs)
    groups: dict[int, list[int]] = {}
    for k, s in enumerate(enc):
        groups.setdefault(len(s), []).append(k)
    return [_build_bucket(enc, idxs, w, batch_multiple, pad)
            for w, idxs in sorted(groups.items(), reverse=True)]


def pad_to_width(seqs, width: int, *, batch_multiple: int = 1,
                 pad: int = PAD, truncate: bool = False) -> Bucket:
    """One rectangular Bucket at a caller-chosen ``width``.  ``lens``
    always records TRUE lengths.  A sequence longer than ``width``
    raises ``ValueError``, unless ``truncate=True`` clips its data (only
    sound when every cell needing the clipped content is out of band:
    the caller picks ``width`` accordingly)."""
    enc = encode_seqs(seqs)
    over = [k for k, s in enumerate(enc) if len(s) > width]
    if over and not truncate:
        raise ValueError(
            f"{len(over)} sequence(s) longer than width {width} "
            f"(first: index {over[0]}, length {len(enc[over[0]])})")
    b = _build_bucket(enc, list(range(len(enc))), width, batch_multiple,
                      pad)
    b.lens[over] = [len(enc[k]) for k in over]
    return b


def scatter_results(buckets: Sequence[Bucket],
                    per_bucket: Sequence[np.ndarray], n: int,
                    fill=0, trailing_shape: Sequence[int] = (),
                    dtype=None) -> np.ndarray:
    """Reassemble per-bucket row results into input order.

    ``per_bucket[i]`` must have leading dimension equal to
    ``buckets[i].data.shape[0]``; filler rows (``idx == -1``) are
    dropped.  Returns an array of leading dimension ``n`` (rows never
    written stay ``fill``).  The trailing dimensions and dtype come
    from the first result; with EMPTY ``buckets``, from
    ``trailing_shape`` and ``dtype``."""
    if len(buckets) != len(per_bucket):
        raise ValueError("buckets and per_bucket differ in length")
    out = None
    for b, r in zip(buckets, per_bucket):
        r = np.asarray(r)
        if r.shape[0] != b.data.shape[0]:
            raise ValueError(
                f"result rows {r.shape[0]} != bucket rows "
                f"{b.data.shape[0]}")
        if out is None:
            out = np.full((n,) + r.shape[1:], fill, dtype=r.dtype)
        live = b.idx >= 0
        out[b.idx[live]] = r[live]
    if out is None:
        out = np.full((n,) + tuple(trailing_shape), fill, dtype=dtype)
    return out
