"""The re-aligner's walk on the CPU at the edges of its CUDA ring body:
``walk_plain`` (the kernel's reference on the card) against the JAX
package's ``_rowwalk_lane`` and its Pallas ``_walk_kernel`` in interpret
mode, on the hand-made planes of ``corpus.make_walk_planes`` (the same
planes ``chip_smoke.py`` holds the kernel to) at bands 1 to 257; and
``walk_plan``, the mirror of ``csrc/realign.cu::pw_walk_plan`` (the card
checks the two against each other).  All comparisons are exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.ops import realign as ref
from pwasm_tpu_torch.corpus import WALK_CASES, make_walk_planes
from pwasm_tpu_torch.ops import realign

# the edges of the ring body's 32-cell ballot windows, its widest band
# (256) and the wide body
BANDS = (1, 31, 32, 33, 63, 64, 65, 255, 256, 257)


def _pallas_walk(ptrs, b0, mat0, q_lens):
    """The JAX package's ``_walk_kernel`` in interpret mode on a pointer
    plane (T, m_max, band): the plane packed as ``_rowwalk_batch_pallas``
    hands it over (8 rows of 4 bits in an int32, (m8, band, T)), lanes
    padded to one 128-lane block.  A q_len past m_max is clamped to it,
    as the plain walk and the CUDA kernel clamp it themselves (the Pallas
    kernel would walk its zero rows that pad m_max to a multiple of 8;
    no caller passes such a q_len).  Returns (iy_runs, ops_rows, b_f)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    T, m_max, band = ptrs.shape
    block_t = 128
    m8 = -(-m_max // 8)
    pad_t = -(-T // block_t) * block_t
    p = np.zeros((pad_t, m8 * 8, band), np.int64)
    p[:T, :m_max] = ptrs
    packed = sum(p[:, r::8, :] << (4 * r) for r in range(8))
    packed = packed.astype(np.uint32).view(np.int32).transpose(1, 2, 0)

    def lens(x):
        out = np.zeros((1, pad_t), np.int32)
        out[0, :T] = x
        return jnp.asarray(out)

    spec = pl.BlockSpec((1, block_t), lambda tb, p8: (0, tb))
    walk_rows, b_f = pl.pallas_call(
        functools.partial(ref._walk_kernel, band=band, block_t=block_t,
                          m8=m8),
        grid=(pad_t // block_t, m8),
        in_specs=[pl.BlockSpec((1, band, block_t),
                               lambda tb, p8: (m8 - 1 - p8, 0, tb)),
                  spec, spec, spec],
        out_specs=[pl.BlockSpec((1, 8, block_t),
                                lambda tb, p8: (m8 - 1 - p8, 0, tb)),
                   spec],
        out_shape=[jax.ShapeDtypeStruct((m8, 8, pad_t), jnp.int32),
                   jax.ShapeDtypeStruct((1, pad_t), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((1, block_t), jnp.int32)] * 2,
        interpret=True,
    )(jnp.asarray(packed), lens(b0), lens(mat0),
      lens(np.minimum(q_lens, m_max)))
    rows = np.asarray(walk_rows).reshape(m8 * 8, pad_t)[:m_max, :T].T
    return rows // 4, (rows & 3).astype(np.int8), np.asarray(b_f)[0, :T]


def _plain_walk(ptrs, b0, mat0, q_lens):
    return [x.numpy() for x in realign.walk_plain(
        *(torch.from_numpy(np.asarray(x)) for x in (ptrs, b0, mat0,
                                                    q_lens)))]


@pytest.mark.parametrize("band", BANDS)
def test_walk_edges_equal_rowwalk_lane_and_pallas(band):
    d = make_walk_planes(band, seed=band)
    ptrs, ql, tl, wf, dlo = (d[k] for k in ("ptrs", "q_lens", "t_lens",
                                            "wf", "dlo"))
    lane = functools.partial(ref._rowwalk_lane, n=10_000, dlo=dlo, band=band)
    want = [np.asarray(x) for x in jax.vmap(lane)(
        jnp.asarray(ptrs), jnp.asarray(ql), jnp.asarray(tl),
        *(jnp.asarray(x) for x in wf))]
    tq = torch.from_numpy(ql)
    score, b0, mat0 = realign.end_cell(
        *(torch.from_numpy(x) for x in wf), tq, torch.from_numpy(tl), dlo,
        band)
    iy_runs, ops_rows, b_f = _plain_walk(ptrs, b0.numpy(), mat0.numpy(), ql)
    leads, ok = realign.leads_ok(score, torch.from_numpy(b_f), dlo)
    got = [score.numpy(), leads.numpy(), iy_runs, ops_rows, ok.numpy()]
    for name, a, b in zip(("scores", "leads", "iy_runs", "ops_rows", "ok"),
                          want, got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"{name} band={band}")
    for name, a, b in zip(("iy_runs", "ops_rows", "b_f"),
                          _pallas_walk(ptrs, b0.numpy(), mat0.numpy(), ql),
                          (iy_runs, ops_rows, b_f)):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} band={band}")
    # the corners were reached: runs to b + 2 where no zero bit lies at or
    # before b; past 32 cells, runs from a zero bit at least one 32-cell
    # ballot window behind b; an IX step to index band
    case = np.array(WALK_CASES)
    no_zero = case == "no_zero_iy_bit"
    first = np.minimum(ql, ptrs.shape[1]) - 1
    k = np.flatnonzero(no_zero & (first >= 0))
    assert (iy_runs[k, first[k]] == b0.numpy()[k] + 2).all()
    if band > 32:
        assert (iy_runs[case == "zero_bit_words_behind"] > 32).any()
    assert (b_f[case == "ix_from_last_band_index"] >= band).any()
    assert (ql == 0).any() and (ql > ptrs.shape[1]).any()


@pytest.mark.parametrize("band", (1, 64, 257))
def test_walk_from_raw_index_outside_band_equals_pallas(band):
    """The walk entered at a band index outside [0, band) (the kernel's
    callers clamp it, the wrapper does not): every read outside the band
    is 0, in the plain walk as in the Pallas kernel."""
    d = make_walk_planes(band, seed=1000 + band)
    ptrs, ql = d["ptrs"], d["q_lens"]
    T = len(ql)
    b0 = np.resize(np.array([-7, -1, band, band + 3, 2 * band], np.int32), T)
    mat0 = np.resize(np.array([0, 1, 2], np.int32), T)
    got = _plain_walk(ptrs, b0, mat0, ql)
    for name, a, b in zip(("iy_runs", "ops_rows", "b_f"),
                          _pallas_walk(ptrs, b0, mat0, ql), got):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} band={band}")
    assert not got[0].any()


@pytest.mark.parametrize("band", (1, 31, 32, 33, 64, 65, 128, 255, 256))
def test_walk_plan_ring_body(band):
    """Bands up to 256 run the ring body: 32-row chunks (one output row a
    thread), four chunks in flight beyond the one walked, five slots a
    warp of the chunk's 16-byte cover after a block's 16 zero bytes, one
    warp a block, in 48 KB (no opt-in)."""
    plan = realign.walk_plan(1536, band)
    slot = (32 * band + 15 + 15) // 16 * 16
    assert plan == dict(body="ring", chunk_rows=32, chunks_ahead=4, warps=1,
                        smem=16 + 5 * slot)
    assert plan["smem"] % 16 == 0 and plan["smem"] <= 48 * 1024
    # shared memory depends on the band alone
    assert realign.walk_plan(0, band) == realign.walk_plan(118_016, band)


def test_walk_plan_wide_body_and_refusals():
    for band in (257, 1024, 4096):
        assert realign.walk_plan(70, band) == dict(
            body="wide", chunk_rows=0, chunks_ahead=0, warps=4, smem=0)
    assert realign.walk_plan(70, 0) is None
    assert realign.walk_plan(-1, 64) is None
    # the ring grows with the band up to its widest, 256
    sizes = [realign.walk_plan(70, b)["smem"] for b in range(1, 257)]
    assert sizes == sorted(sizes)
    assert realign.walk_plan(70, 64)["smem"] == 16 + 5 * 2064
