"""Host-side length bucketing for ragged device batches.

Counterpart of ``pwasm_tpu/parallel/bucketing.py``: the re-aligner
(``ops/realign.py::realign_pairs``) groups lanes by their step-rounded
(query, target) shape, so one long outlier pads only its own group's
tensors; the many-to-many scorer (``parallel/many2many.py``) buckets
queries by exact length and clips and pads all targets once, to the
width its longest query needs.  Every bucket keeps the original index
of each row, so results scatter back to input order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

PAD = 127      # target-code sentinel the DP kernels treat as never-match


def round_up(x: int, step: int = 128) -> int:
    """``x`` rounded up to a positive multiple of ``step``."""
    return max(step, (x + step - 1) // step * step)


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
    ``lens``  (B,) int32 lengths;
    ``idx``   (B,) int64 position of each row in the caller's input
              order.
    """

    data: np.ndarray
    lens: np.ndarray
    idx: np.ndarray

    @property
    def width(self) -> int:
        return int(self.data.shape[1])


def _build_bucket(enc: list[np.ndarray], idxs: list[int],
                  width: int) -> Bucket:
    """Rows ``enc[k][:width]`` for k in ``idxs``, padded to ``width``;
    ``lens`` holds the copied lengths."""
    lens = np.array([min(len(enc[k]), width) for k in idxs], dtype=np.int32)
    data = np.full((len(idxs), width), PAD, dtype=np.int8)
    # row-major: the live cells of all rows, in order, are the sequences
    # concatenated
    live = np.arange(width)[None, :] < lens[:, None]
    if len(idxs):
        data[live] = np.concatenate([enc[k][:width] for k in idxs])
    return Bucket(data, lens, np.array(idxs, dtype=np.int64))


def bucket_queries(seqs) -> list[Bucket]:
    """Group query sequences by EXACT length (the banded DP reads its
    global score at cell (m, t_len): padding the query axis would move
    the read row, so queries can only batch with equal-length peers),
    longest first."""
    enc = encode_seqs(seqs)
    groups: dict[int, list[int]] = {}
    for k, s in enumerate(enc):
        groups.setdefault(len(s), []).append(k)
    return [_build_bucket(enc, idxs, w)
            for w, idxs in sorted(groups.items(), reverse=True)]


def pad_to_width(seqs, width: int) -> Bucket:
    """One rectangular Bucket at a caller-chosen ``width``: longer
    sequences are clipped, and ``lens`` records the TRUE lengths (only
    sound when every cell needing the clipped content is out of band —
    the caller picks ``width`` accordingly)."""
    enc = encode_seqs(seqs)
    b = _build_bucket(enc, list(range(len(enc))), width)
    b.lens[:] = [len(s) for s in enc]
    return b
