"""Host-side length bucketing for ragged device batches.

Counterpart of ``pwasm_tpu/parallel/bucketing.py``, reduced to what the
re-aligner (``ops/realign.py::realign_pairs``) uses: group lanes by
their step-rounded (query, target) shape, so one long outlier pads only
its own group's tensors, not every lane's.
"""

from __future__ import annotations

from typing import Iterable, Sequence


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
