"""The port's re-aligner (``pwasm_tpu_torch/ops/realign.py``) on the CPU
against the JAX package: the plain forward + walk against the XLA path
of ``banded_realign_rows`` on every output of every lane and row (ok or
not), the walk alone against ``_rowwalk_lane`` on hand-made pointer
planes, ``realign_pairs`` with band escalation and the host oracle, and
the host helpers.  All comparisons are exact (integer math)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.ops import banded_dp as ref_dp
from pwasm_tpu.ops import realign as ref
from pwasm_tpu.parallel import bucketing as ref_bucketing
from pwasm_tpu_torch.core.dna import encode
from pwasm_tpu_torch.ops import banded_dp, realign
from pwasm_tpu_torch.parallel import bucketing

from test_realign import _mutate

NAMES = ("scores", "leads", "iy_runs", "ops_rows", "ok")


def make_lanes(seed, T=20, m_max=100, n_max=120, alphabet=5):
    """Random (query, mutated target) lanes, padded with code 127."""
    rng = np.random.default_rng(seed)
    qs = np.full((T, m_max), 127, dtype=np.int8)
    ts = np.full((T, n_max), 127, dtype=np.int8)
    qls = np.zeros(T, dtype=np.int32)
    tls = np.zeros(T, dtype=np.int32)
    for k in range(T):
        m = int(rng.integers(1, m_max + 1))
        q = rng.integers(0, alphabet, m).astype(np.int8)
        t = _mutate(rng, q, int(rng.integers(0, 8)),
                    int(rng.integers(0, 6)))[:n_max]
        qs[k, :m] = q
        ts[k, :len(t)] = t
        qls[k] = m
        tls[k] = len(t)
    return qs, ts, qls, tls


def port_rows(lanes, **kw):
    out = realign.banded_realign_rows(
        *(torch.from_numpy(x) for x in lanes), **kw)
    return [x.numpy() for x in out]


def assert_rows_equal(want, got, where=""):
    for name, a, b in zip(NAMES, want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {where}")


@pytest.mark.parametrize("band", [1, 5, 16, 33, 64])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_rows_equal_xla_path(seed, band):
    lanes = make_lanes(seed)
    # seed 3 places the band off-centre
    dlo = -(band // 3) if seed == 3 else None
    want = ref.banded_realign_rows(*lanes, band=band, dlo=dlo,
                                   kernel="xla")
    assert_rows_equal(want, port_rows(lanes, band=band, dlo=dlo),
                      f"seed={seed} band={band}")


# ---------------------------------------------------------------------------
# the walk alone, on hand-made pointer planes
# ---------------------------------------------------------------------------
def _plane(rng, T, m_max, band, by=None):
    """Random pointer bytes: diag argmax 0-2, random extend bits (the
    Iy-extend bit forced to ``by`` when given)."""
    dm = rng.integers(0, 3, (T, m_max, band))
    bx = rng.integers(0, 2, (T, m_max, band))
    b_y = rng.integers(0, 2, (T, m_max, band)) if by is None \
        else np.full((T, m_max, band), by)
    return (dm | (bx << 2) | (b_y << 3)).astype(np.uint8)


def _wavefront(rng, T, band, b_end, mat):
    """Final wavefronts whose cell at b_end (clamped) holds argmax
    ``mat`` (per lane) with a score well above NEG // 2."""
    wf = rng.integers(-50, 50, (3, T, band)).astype(np.int32)
    b0 = np.clip(b_end, 0, band - 1)
    for k in range(T):
        wf[:, k, b0[k]] = 10
        wf[mat[k], k, b0[k]] = 40
    return wf


def _walk_case(case):
    """(ptrs, q_lens, t_lens, (m_f, ix_f, iy_f), dlo, band) for one
    named corner of the walk."""
    rng = np.random.default_rng(sum(map(ord, case)))
    T, m_max, band, dlo = 6, 12, 40, -5
    q_lens = rng.integers(2, m_max + 1, T).astype(np.int32)
    b_end = rng.integers(0, band, T)
    mat = rng.integers(0, 3, T)
    by = None
    if case == "no_zero_iy_bit_before_b":
        # every Iy-extend bit 1: lastZero = -1, so b_mid = b - (b+2) < 0
        by, mat = 1, np.full(T, 2)
    elif case == "ix_from_last_band_index":
        b_end, mat = np.full(T, band - 1), np.full(T, 1)
    elif case == "end_cell_outside_band":
        b_end = np.array([band, band + 3, -1, -7, 2 * band, band - 1])
    elif case == "q_len_1":
        q_lens = np.ones(T, np.int32)
    elif case == "leading_gap":
        # all-DIAG planes: the walk keeps b, so it closes at b0 > -dlo
        b_end, mat = rng.integers(-dlo + 1, band, T), np.zeros(T, int)
    ptrs = _plane(rng, T, m_max, band, by)
    if case == "leading_gap":
        ptrs[:] = 0
    t_lens = (q_lens + dlo + b_end).astype(np.int32)
    return ptrs, q_lens, t_lens, _wavefront(rng, T, band, b_end, mat), \
        dlo, band


@pytest.mark.parametrize("case", [
    "no_zero_iy_bit_before_b", "ix_from_last_band_index",
    "end_cell_outside_band", "q_len_1", "leading_gap", "random"])
def test_walk_equals_rowwalk_lane_on_hand_made_planes(case):
    ptrs, q_lens, t_lens, (m_f, ix_f, iy_f), dlo, band = _walk_case(case)
    lane = functools.partial(ref._rowwalk_lane, n=1000, dlo=dlo, band=band)
    want = jax.vmap(lane)(jnp.asarray(ptrs), jnp.asarray(q_lens),
                          jnp.asarray(t_lens), jnp.asarray(m_f),
                          jnp.asarray(ix_f), jnp.asarray(iy_f))
    want = [np.asarray(x) for x in want]
    tq = torch.from_numpy(q_lens)
    score, b0, mat0 = realign.end_cell(
        *(torch.from_numpy(x) for x in (m_f, ix_f, iy_f)), tq,
        torch.from_numpy(t_lens), dlo, band)
    iy_runs, ops_rows, b_f = realign.walk_plain(torch.from_numpy(ptrs), b0,
                                                mat0, tq)
    leads, ok = realign.leads_ok(score, b_f, dlo)
    got = [x.numpy() for x in (score, leads, iy_runs, ops_rows, ok)]
    assert_rows_equal(want, got, case)
    # the corner was really reached
    first = q_lens - 1                       # the first walked row
    rows = np.arange(len(q_lens))
    if case == "no_zero_iy_bit_before_b":
        assert (want[2][rows, first] == b0.numpy() + 2).all()
        assert not want[4].any()
    elif case == "ix_from_last_band_index":
        assert (want[3][rows, first] == ref.OP_IX).all()
    elif case == "end_cell_outside_band":
        assert (want[0][:5] == ref_dp.NEG).all() and not want[4][:5].any()
    elif case == "q_len_1":
        assert (want[3][:, 1:] == 0).all()
    elif case == "leading_gap":
        assert want[4].all() and (want[1] > 0).all()


# ---------------------------------------------------------------------------
# realign_pairs: buckets, escalation, the host oracle
# ---------------------------------------------------------------------------
def _pairs():
    rng = np.random.default_rng(40)
    pairs = []
    for m in (30, 90, 150, 300):
        q = rng.integers(0, 4, m).astype(np.int8)
        pairs.append((q, _mutate(rng, q, 4, 3)))
    # an insertion wider than the first band: escalation
    q = rng.integers(0, 4, 96).astype(np.int8)
    pairs.append((q, np.concatenate(
        [q[:48], rng.integers(0, 4, 128).astype(np.int8), q[48:]])))
    # an end diagonal beyond every band up to 4096: the host oracle
    q = rng.integers(0, 4, 24).astype(np.int8)
    pairs.append((q, np.concatenate(
        [q[:12], rng.integers(0, 4, 4200).astype(np.int8), q[12:]])))
    return [(bytes(b"ACGT"[c] for c in q), bytes(b"acgt"[c] for c in t))
            for q, t in pairs]


def test_realign_pairs_equal_reference(monkeypatch):
    pairs = _pairs()
    dispatched = []
    real = realign.banded_realign_rows

    def spy(qs, ts, *a, band, **kw):
        dispatched.append((tuple(qs.shape), band))
        return real(qs, ts, *a, band=band, **kw)

    monkeypatch.setattr(realign, "banded_realign_rows", spy)
    got = realign.realign_pairs(pairs, band=16,
                                device=torch.device("cpu"))
    want = ref.realign_pairs(pairs, band=16)
    assert len(got) == len(want) == len(pairs)
    for k, (w, g) in enumerate(zip(want, got)):
        assert w[0] == g[0], k
        np.testing.assert_array_equal(w[1], g[1], err_msg=str(k))
    # the escalated lane went 16 -> 64 -> 256; the oracle lane every
    # band up to 4096 and then the host
    assert {b for _s, b in dispatched} == {16, 64, 256, 1024, 4096}
    q, t = pairs[-1]
    score, ops = realign.full_gotoh_traceback(encode(q), encode(t.upper()))
    assert got[-1][0] == score
    np.testing.assert_array_equal(got[-1][1], ops)


def test_cpu_path_never_builds_a_kernel(monkeypatch):
    from pwasm_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"CPU path reached the {name} build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(realign, "_FNS", {})
    lanes = make_lanes(4, T=5, m_max=30, n_max=40)
    for band in (1, 8, 64):
        port_rows(lanes, band=band)
    assert realign.realign_pairs(_pairs()[:2], device=torch.device("cpu"))
    assert realign.LAUNCHES == {"fwdptr": 0, "fwdptr_long": 0, "walk": 0}


def test_kernel_budget_and_refusals():
    # the budget itself reads the kernel's layout from the built library,
    # so chip_smoke.py checks its choices on the card; here, the wrappers
    # refuse CPU tensors and the entry point a band below 1
    lanes = [torch.from_numpy(x) for x in make_lanes(5, T=2, m_max=8,
                                                     n_max=8)]
    with pytest.raises(ValueError, match="CUDA"):
        realign.forward_kernel(*lanes, dlo=-2, band=4)
    with pytest.raises(ValueError, match="CUDA"):
        realign.walk_kernel(torch.zeros((2, 8, 4), dtype=torch.uint8),
                            *lanes[2:], lanes[2])
    with pytest.raises(ValueError, match="band"):
        port_rows(make_lanes(5, T=2, m_max=8, n_max=8), band=0)


# ---------------------------------------------------------------------------
# host helpers and copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_host_helpers_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        m = int(rng.integers(1, 30))
        q = rng.integers(0, 5, m).astype(np.int8)
        t = _mutate(rng, q, 3, 3)
        want = ref.full_gotoh_traceback(q, t)
        got = realign.full_gotoh_traceback(q, t)
        assert want[0] == got[0]
        np.testing.assert_array_equal(want[1], got[1])
        assert realign.ops_score(got[1], q, t) == \
            ref.ops_score(want[1], q, t) == got[0]
        for reverse in (0, 1):
            args = (got[1], 3, m + 11, len(t), reverse)
            assert [(g.pos, g.len) for part in ref.ops_to_gaps(*args)
                    for g in part] == \
                [(g.pos, g.len) for part in realign.ops_to_gaps(*args)
                 for g in part]
        lead = int(rng.integers(0, 5))
        iy = rng.integers(0, 4, m + 3).astype(np.int32)
        op = rng.integers(1, 3, m + 3).astype(np.int8)
        np.testing.assert_array_equal(
            ref.rows_to_ops_fwd(lead, iy, op, m),
            realign.rows_to_ops_fwd(lead, iy, op, m))
        d_ends = rng.integers(-300, 300, 4)
        for band in (1, 16, 64, 700):
            assert ref._pick_dlo(d_ends, band) == \
                realign._pick_dlo(d_ends, band)
    assert (realign._ORACLE_CELL_LIMIT, realign._NATIVE_ORACLE_CELL_LIMIT,
            realign._MAX_BAND, realign._PTR_BYTES_LIMIT) == (
                ref._ORACLE_CELL_LIMIT, ref._NATIVE_ORACLE_CELL_LIMIT,
                ref._MAX_BAND, ref._PTR_BYTES_LIMIT)


def test_banded_dp_and_bucketing_copies():
    p = banded_dp.ScoreParams()
    assert (p.match, p.mismatch, p.gap_open, p.gap_extend, p.go) == \
        (2, 4, 4, 2, 6) and banded_dp.NEG == ref_dp.NEG
    for dlo in (-40, -3, 0, 5):
        want = ref_dp.initial_wavefront(70, dlo, 64, ref_dp.ScoreParams())
        got = banded_dp.initial_wavefront(70, dlo, 64, p,
                                          torch.device("cpu"))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    shapes = [(1500, 1400), (1500, 1537), (3, 129), (1, 1), (128, 256)]
    assert bucketing.group_by_shape(shapes) == \
        ref_bucketing.group_by_shape(shapes)
    for x in (0, 1, 127, 128, 129, 100_000):
        assert bucketing.round_up(x) == ref_bucketing.round_up(x)
