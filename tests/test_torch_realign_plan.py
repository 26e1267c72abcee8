"""The re-aligner's forward plan on the CPU: ``forward_plan``, the mirror
of ``csrc/realign.cu::pw_fwd_plan`` (the card checks the two against
each other in ``chip_smoke.py``), its layout, row split, shared-memory
budget and streamed windows; and the plain forward pass, the kernels'
reference on the card, against the JAX package's XLA forward pass at the
sub-warp layout's edge bands, pointers and end cells, exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.ops import realign as ref
from pwasm_tpu.ops.banded_dp import ScoreParams as RefParams
from pwasm_tpu_torch.ops import banded_dp, realign

from test_realign import _mutate

# the realign dispatches (T, m_max, n, band) of the 200-alignment
# --realign run (chip_smoke.py REALIGN_DISPATCHES)
DISPATCHES = [(1, 1536, 1408, 64), (1, 1536, 1408, 256),
              (176, 1536, 1536, 64), (41, 1536, 1536, 256),
              (23, 1536, 1664, 64), (23, 1536, 1664, 256)]


def _round16(x):
    return (x + 15) // 16 * 16


@pytest.mark.parametrize("streamed", [False, True])
def test_forward_plan_layout_and_row_split(streamed):
    """For bands 1 to 256 the plan is the sub-warp body with
    ``forward_layout``'s cells and threads (G * C >= band with G a power
    of two of at most 32, C one of at most 8, and at most FWD_CELLS
    where a warp's 32 threads hold the band) and ``interior_rows``'
    split, over shapes with empty and full interiors."""
    for band in range(1, 257):
        c, g = realign.forward_layout(band)
        assert g & (g - 1) == 0 and 1 <= g <= 32, band
        assert c & (c - 1) == 0 and 1 <= c <= 8, band
        assert g * c >= band > (g // 2) * c, band
        want_c = min(realign.FWD_CELLS, 1 << (band - 1).bit_length())
        while 32 * want_c < band:
            want_c *= 2
        assert c == want_c, band
        for m, n in ((0, 0), (5, 3), (40, 60), (150, 170), (333, 300)):
            for dlo in sorted({1 - band, -(band // 2), 0, 7}):
                plan = realign.forward_plan(m, n, band, dlo, streamed)
                assert plan["body"] == "subwarp"
                assert (plan["cells"], plan["threads"]) == (c, g)
                assert plan["interior"] == \
                    banded_dp.interior_rows(m, n, dlo, band)
                assert plan["lanes"] == plan["warps"] * 32 // g
                assert plan["window"] == \
                    (realign.FWD_WINDOW if streamed else 0)
    assert realign.forward_layout(64) == (2, 32)
    assert realign.forward_layout(257) is None


def test_resident_plan_takes_the_realign_dispatches():
    """The resident plan takes all six ``--realign`` dispatch shapes of
    the 200-alignment run within 227 KB: each block holds its lanes'
    query and target rows and the guard; it refuses the 118,016-row
    long-read lane, which only the streamed plan takes, with shared
    memory set by the band alone."""
    for T, m, n, band in DISPATCHES:
        plan = realign.forward_plan(m, n, band, -(band // 2))
        assert plan is not None, (T, m, n, band)
        assert plan["smem"] == plan["lanes"] * (_round16(m) + _round16(n)) \
            + realign.FWD_GUARD <= realign.SMEM_LIMIT
    assert realign.forward_plan(118_016, 118_016, 64, -32) is None
    long = realign.forward_plan(118_016, 118_016, 64, -32, streamed=True)
    assert long["smem"] == realign.forward_plan(20, 30, 64, -32,
                                                streamed=True)["smem"]
    assert long["smem"] <= 48 * 1024


@pytest.mark.parametrize("band", [257, 300, 1024, 1100, 4096, 20_000,
                                  32_768])
def test_block_plan_above_256(band):
    """Above band 256 the plan is the block-wide body with the bytes of
    today's ``fwd_smem`` (the wavefront's three int32 rows and 32 warp
    totals, then the lane's target and query, or two 8-row target slots
    and two 16-byte query slots), refused past 227 KB."""
    wave = _round16(12 * band) + 128
    for m, n in ((100, 130), (1536, 1664), (200_000, 200_000)):
        for streamed in (False, True):
            want = wave + (2 * _round16(band + 22) + 32 if streamed
                           else _round16(n) + _round16(m))
            plan = realign.forward_plan(m, n, band, -(band // 2), streamed)
            if want > realign.SMEM_LIMIT:
                assert plan is None
                continue
            assert plan["body"] == "block" and plan["smem"] == want
            assert plan["cells"] * realign.MAX_THREADS >= band
            assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
            assert plan["interior"] == (m, m)
            assert plan["window"] == (8 if streamed else 0)
    assert realign.forward_plan(10, 10, 32_769, 0) is None


def test_stream_plan_windows_cover_every_read():
    """The streamed sub-warp body's ring, from ``forward_plan``: for
    bands 1 to 256, dlo across its legal range and m_max up to a few
    hundred, every W-row step's window starts on a 16-byte boundary and
    its ``lane_bytes`` cover every column j - 1 that a row of the step
    reads for every band index b < G * C (pad cells included), and each
    lane's W query codes and window lie inside its share of the slot,
    apart from every other lane's."""
    W = realign.FWD_WINDOW
    for band in range(1, 257):
        c, g = realign.forward_layout(band)
        gc = g * c
        plan = realign.forward_plan(100, 120, band, 0, streamed=True)
        lb, sb = plan["lane_bytes"], plan["slot_bytes"]
        assert lb % 16 == 0 and sb == 32 // g * (W + lb)
        assert plan["warps"] == 1 and plan["lanes"] == 32 // g
        assert plan["smem"] == realign.FWD_RING * sb
        # lane l's share of a slot: [l * (W + lb), (l + 1) * (W + lb)),
        # its W query codes first, then its window
        shares = [(l * (W + lb), l * (W + lb) + W, (l + 1) * (W + lb))
                  for l in range(32 // g)]
        assert shares[-1][2] == sb
        for dlo in sorted({1 - band, -(band // 2), 0, 5}):
            for m in (0, 1, 15, 16, 31, 33, 95, 130, 333):
                for k in range((m + W - 1) // W):
                    ws = realign.forward_window_start(k, dlo)
                    assert ws % 16 == 0 and ws <= k * W + dlo < ws + 16
                    rows = np.arange(k * W + 1, min(m, k * W + W) + 1)
                    # row i's query code at byte i - 1 - k * W of the
                    # lane's W codes
                    assert ((rows - 1 - k * W >= 0)
                            & (rows - 1 - k * W < W)).all()
                    first = rows - 1 + dlo             # b = 0
                    last = first + gc - 1              # b = G * C - 1
                    assert (first >= ws).all(), (band, dlo, m, k)
                    assert (last < ws + lb).all(), (band, dlo, m, k)


# ---------------------------------------------------------------------------
# the plain forward pass against the JAX package's, at the edge bands
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("n", "band"))
def _ref_pointers(qs, ts, q_lens, dlo, n, band):
    """The JAX package's XLA forward pass (``_forward_lane``) over every
    lane: its pointer planes."""
    def lane(q, t, q_len):
        return ref._forward_lane(q, t, q_len, n, dlo, band, RefParams())[3]

    return jax.vmap(lane)(qs, ts, q_lens)


def _spread_lanes(seed, T, m_max, n_max):
    """Lanes whose q_len runs from 1 to m_max (every fourth lane 1, the
    next m_max): one dispatch spreads them by m_max - 1 rows."""
    rng = np.random.default_rng(seed)
    qs = np.full((T, m_max), 127, dtype=np.int8)
    ts = np.full((T, n_max), 127, dtype=np.int8)
    qls = np.zeros(T, dtype=np.int32)
    tls = np.zeros(T, dtype=np.int32)
    for k in range(T):
        m = (1, m_max)[k % 4] if k % 4 < 2 else int(rng.integers(1, m_max))
        q = rng.integers(0, 5, m).astype(np.int8)
        t = _mutate(rng, q, int(rng.integers(0, 8)),
                    int(rng.integers(0, 6)))[:n_max]
        qs[k, :m] = q
        ts[k, :len(t)] = t
        qls[k] = m
        tls[k] = len(t)
    return qs, ts, qls, tls


@pytest.mark.parametrize("band", [7, 8, 9, 65, 127, 129, 255, 256])
def test_plain_forward_equals_jax_at_edge_bands(band):
    """forward_plain against the JAX package on lanes whose q_len differs
    by up to 128 rows, at a centred and an off-centre band: its pointers
    (every row, those past a lane's q_len included) equal the XLA
    forward pass's (``_forward_lane``), and its end cell equals what the
    package's own batch entry point (``_rowwalk_batch_jit``) makes of
    its own: the score exactly, and b0 and mat0 through the walk that
    starts from them (every lane has q_len >= 1, so the first walked
    row's op is IX exactly where mat0 is Ix and its Iy run is non-zero
    exactly where mat0 is Iy; b0 sets where the walk runs, so the runs,
    the ops, the lead and ok all read it)."""
    lanes = _spread_lanes(band, T=6, m_max=129, n_max=140)
    assert int(lanes[2].max() - lanes[2].min()) == 128
    for dlo in (-(band // 2), 3 - band // 3):
        jl = [jnp.asarray(x) for x in lanes]
        want_ptrs = np.asarray(_ref_pointers(
            jl[0], jl[1], jl[2], jnp.int32(dlo), n=lanes[1].shape[1],
            band=band))
        want = [np.asarray(x) for x in ref._rowwalk_batch_jit(
            *jl, jnp.int32(dlo), band, RefParams())]
        ptrs, score, b0, mat0 = realign.forward_plain(
            *(torch.from_numpy(x) for x in lanes), dlo, band)
        iy_runs, ops, b_f = realign.walk_plain(ptrs, b0, mat0,
                                               torch.from_numpy(lanes[2]))
        lead, ok = realign.leads_ok(score, b_f, dlo)
        got = [x.numpy() for x in (score, lead, iy_runs, ops, ok)]
        for name, a, b in zip(("ptrs", "score", "lead", "iy_runs", "ops",
                               "ok"), [want_ptrs, *want],
                              [ptrs.numpy(), *got]):
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64),
                                          err_msg=f"{name} band={band} "
                                                  f"dlo={dlo}")
