"""The re-aligner's leftover lanes (no band up to 4,096 covers their
optimal path) go to the native traceback oracle up to 256 M cells, as
the JAX package's do: a lane between the Python oracle's 4 M cells and
16 M is re-aligned with the reference library's score and ops, not left
with its PAF gaps."""

import numpy as np
import pytest
import torch

import pwasm_tpu.native as ref_native
from pwasm_tpu.core.dna import encode as ref_encode
from pwasm_tpu_torch import native
from pwasm_tpu_torch.core.dna import encode
from pwasm_tpu_torch.ops import realign

CPU = torch.device("cpu")


def _pair(seed: int, m: int, insert: int) -> tuple[bytes, bytes]:
    """A query of ``m`` bases and a target with ``insert`` random bases
    in its middle: the end diagonal lies ``insert`` off the main one."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    q = rng.choice(acgt, m).tobytes()
    return q, q[:m // 2] + rng.choice(acgt, insert).tobytes() + q[m // 2:]


def test_leftover_lane_takes_the_native_oracle(monkeypatch):
    q, t = _pair(0, 1000, 8000)
    cells = len(q) * len(t)
    assert realign._ORACLE_CELL_LIMIT < cells <= 16_000_000
    (res,) = realign.realign_pairs([(q, t)], band=64, device=CPU)
    assert res is not None
    p = realign.ScoreParams()
    want = ref_native.gotoh_traceback(ref_encode(q), ref_encode(t), p.match,
                                      p.mismatch, p.gap_open, p.gap_extend)
    assert res[0] == want[0]
    np.testing.assert_array_equal(res[1], want[1])
    assert realign.ops_score(res[1], encode(q), encode(t)) == res[0]
    # without the native engine the lane is beyond the Python oracle
    monkeypatch.setenv("PWASM_NATIVE", "0")
    assert realign.realign_pairs([(q, t)], band=64, device=CPU) == [None]


@pytest.mark.parametrize("allocated", [True, False])
def test_python_oracle_only_when_native_cannot_allocate(monkeypatch,
                                                        allocated):
    # with the escalation capped at band 4, short lanes whose ends lie
    # further off the diagonal are leftovers too
    monkeypatch.setattr(realign, "_MAX_BAND", 4)
    calls = []
    real = native.gotoh_traceback

    def counted(*args):
        calls.append(len(args[0]) * len(args[1]))
        return real(*args) if allocated else None

    monkeypatch.setattr(native, "gotoh_traceback", counted)
    pairs = [_pair(1 + k, 40 + 7 * k, 20 + k) for k in range(4)]
    got = realign.realign_pairs(pairs, band=4, device=CPU)
    assert sorted(calls) == sorted(len(q) * len(t) for q, t in pairs)
    for (q, t), res in zip(pairs, got):
        want = realign.full_gotoh_traceback(encode(q), encode(t))
        assert res[0] == want[0]
        np.testing.assert_array_equal(res[1], want[1])
