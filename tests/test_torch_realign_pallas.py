"""The port's plain re-aligner against the JAX package's Pallas kernels
run in interpret mode (``_rowwalk_batch_pallas``), resident and
streaming, on fuzzed lanes and on the interior-block geometry of
``tests/test_realign.py``.  The Pallas path derives ``mat0`` from the
end cell only when the band holds it, so, as in the JAX package's own
Pallas tests, the rows of lanes that are not ok are compared only
through their (equal) ``ok`` flags; everything else is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.ops.banded_dp import ScoreParams, band_dlo
from pwasm_tpu.ops.realign import _rowwalk_batch_pallas
from pwasm_tpu_torch.ops import realign

from test_realign import _mutate


def _lanes(seed, T, m_max, n_max, fixed_m=False):
    rng = np.random.default_rng(seed)
    qs = np.full((T, m_max), 127, dtype=np.int8)
    ts = np.full((T, n_max), 127, dtype=np.int8)
    qls = np.zeros(T, dtype=np.int32)
    tls = np.zeros(T, dtype=np.int32)
    for k in range(T):
        m = m_max if fixed_m else int(rng.integers(5, m_max + 1))
        q = rng.integers(0, 4, m).astype(np.int8)
        t = _mutate(rng, q, int(rng.integers(0, 8)),
                    int(rng.integers(0, 5)))[:n_max]
        qs[k, :m] = q
        ts[k, :len(t)] = t
        qls[k] = m
        tls[k] = len(t)
    return qs, ts, qls, tls


def _compare(lanes, band, dlo, streaming):
    want = _rowwalk_batch_pallas(*(jnp.asarray(x) for x in lanes), dlo,
                                 band, ScoreParams(), interpret=True,
                                 streaming=streaming)
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in realign.banded_realign_rows(
        *(torch.from_numpy(x) for x in lanes), band=band, dlo=dlo)]
    ok = want[4]
    assert ok.any()
    for name, a, b in zip(("scores", "leads", "ok"), (want[0], want[1], ok),
                          (got[0], got[1], got[4])):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name, a, b in zip(("iy_runs", "ops_rows"), want[2:4], got[2:4]):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)
    return ok


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("band", [16, 32])
def test_plain_equals_pallas_interpret(band, streaming):
    lanes = _lanes(30 + band, T=8, m_max=40, n_max=48)
    _compare(lanes, band, -(band // 2), streaming)


@pytest.mark.parametrize("streaming", [False, True])
def test_plain_equals_pallas_interior_blocks(streaming):
    # the geometry of test_pallas_interior_blocks_match_xla: many 8-row
    # blocks lie wholly inside the band (the kernels' mask-elided body)
    m, n_max, band = 256, 272, 32
    dlo = band_dlo(m, n_max, band)
    assert n_max - band - dlo + 1 - 8 - max(0, -dlo) >= 16
    ok = _compare(_lanes(21, T=2, m_max=m, n_max=n_max, fixed_m=True),
                  band, dlo, streaming)
    assert ok.all()
