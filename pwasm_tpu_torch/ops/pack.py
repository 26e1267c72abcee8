"""2-bit sequence packing for host->device transfer.

Counterpart of ``pwasm_tpu/ops/pack.py``: A/C/G/T fit in 2 bits, so a
target batch ships to the device at a quarter of the int8 size.  Packing
runs on the host (numpy), unpacking on the device as a shift/mask.

Padding note: packed batches carry no sentinel — padding columns decode
to base 0 ('A').  That is safe for the banded DP score: cell (i, j)
depends only on columns <= j (diag j-1, up j, left-chain < j), so cells
beyond a target's true length can never reach the score extracted at
(m, t_len).  The unpacked-path sentinel (127) is therefore unnecessary
for scoring; the tests check the two paths give equal scores.
"""

from __future__ import annotations

import numpy as np
import torch

from pwasm_tpu_torch.ops.banded_dp import ScoreParams, banded_scores


def pack_targets(ts_codes: np.ndarray) -> np.ndarray:
    """Pack a (T, n) int8 base-code batch into (T, ceil(n/4)) uint8.

    Accepted codes are 0..3 (A/C/G/T) and the padding sentinel 127,
    which packs as base 0 ('A'); any other code (N=4, gap codes,
    negatives) is rejected — 2-bit packing would silently alias it to a
    real base, so N-bearing targets must use the int8 path."""
    ts = np.ascontiguousarray(ts_codes, dtype=np.int8)
    T, n = ts.shape
    bad = (ts < 0) | ((ts > 3) & (ts != 127))
    if bad.any():
        raise ValueError(
            "pack_targets: batch contains codes outside {0..3, 127 pad}; "
            "2-bit packing would alias them to real bases — use the int8 "
            "path")
    ts = np.where(ts == 127, np.int8(0), ts)
    nb = (n + 3) // 4
    if n % 4:
        ts = np.pad(ts, ((0, 0), (0, 4 * nb - n)))
    flat = (ts.reshape(-1).astype(np.uint8) & 3).reshape(-1, 4)
    packed = (flat[:, 0] | (flat[:, 1] << 2) | (flat[:, 2] << 4)
              | (flat[:, 3] << 6)).astype(np.uint8)
    return packed.reshape(T, nb)


def unpack_targets_device(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_targets`` on the tensor's device: (T, nb) uint8
    -> (T, n) int8 codes in 0..3."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    c = (packed[:, :, None] >> shifts) & 3
    T, nb = packed.shape
    return c.reshape(T, nb * 4)[:, :n].to(torch.int8)


def banded_scores_packed(q: torch.Tensor, ts_packed: torch.Tensor, n: int,
                         t_lens: torch.Tensor, band: int = 64,
                         params: ScoreParams = ScoreParams()
                         ) -> torch.Tensor:
    """Banded DP scores from a 2-bit-packed target batch: unpack on the
    device, then ``banded_scores``.  Equal to ``banded_scores`` on the
    unpacked codes."""
    return banded_scores(q, unpack_targets_device(ts_packed, n), t_lens,
                         band, params)
