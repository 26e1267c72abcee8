"""The re-aligner's gap-record API of the port (``banded_traceback_batch``,
``realign_gaps_batch``, ``gap_slots_to_gapdata``, ``ops_forward``,
``ops_consumed``) on the CPU against the JAX package, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.ops import realign as ref
from pwasm_tpu_torch.ops import realign

from test_torch_realign import make_lanes

SLOT_NAMES = ("rg_pos", "rg_len", "r_count", "tg_pos", "tg_len", "t_count",
              "overflow")


def _plain(gaps):
    """(rgaps, tgaps) as (pos, len) tuples: the two packages' GapData
    are different classes."""
    return tuple([(g.pos, g.len) for g in side] for side in gaps)


def _torch(lanes):
    return [torch.from_numpy(x) for x in lanes]


@pytest.mark.parametrize("band,dlo", [(16, None), (33, -10)])
def test_traceback_batch_equals_reference(band, dlo):
    lanes = make_lanes(7, T=12, m_max=60, n_max=70)
    want = ref.banded_traceback_batch(*lanes, band=band, dlo=dlo)
    got = realign.banded_traceback_batch(*_torch(lanes), band=band, dlo=dlo)
    for name, a, b in zip(("scores", "ops_bwd", "ok"), want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[2].any()
    assert band > 16 or not got[2].all()    # lanes the band missed, too
    for k in np.flatnonzero(got[2]):
        fwd = realign.ops_forward(got[1][k])
        np.testing.assert_array_equal(fwd, ref.ops_forward(want[1][k]))
        q_used, t_used = realign.ops_consumed(fwd)
        assert (q_used, t_used) == ref.ops_consumed(fwd)
        assert (q_used, t_used) == (lanes[2][k], lanes[3][k])


@pytest.mark.parametrize("max_gaps", [32, 1])
def test_realign_gaps_batch_equals_reference(max_gaps):
    """Slots, counts and overflow per lane (max_gaps=1 overflows lanes
    with two or more gaps on a side)."""
    lanes = make_lanes(8, T=16, m_max=60, n_max=70)
    want_scores, want_ok, want = ref.realign_gaps_batch(
        *(jnp.asarray(x) for x in lanes), band=16, max_gaps=max_gaps)
    scores, ok, got = realign.realign_gaps_batch(*_torch(lanes), band=16,
                                                 max_gaps=max_gaps)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_scores))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    for name, a, b in zip(SLOT_NAMES, want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    overflow = got[-1].numpy()
    if max_gaps == 1:
        assert overflow.any()
    else:
        assert not overflow.any()
    # the slots of lanes that fit convert like the expanded op strings
    _s, ops_bwd, ok_bwd = realign.banded_traceback_batch(*_torch(lanes),
                                                         band=16)
    slots = [x.numpy() for x in got]
    for k in np.flatnonzero(ok_bwd & ~overflow):
        for offset, r_len, reverse in ((0, 60, 0), (5, 90, 1)):
            args = (offset, r_len, int(lanes[3][k]), reverse)
            lane = [x[k] for x in slots[:6]]
            gaps = _plain(realign.gap_slots_to_gapdata(*lane, *args))
            assert gaps == _plain(ref.gap_slots_to_gapdata(*lane, *args))
            assert gaps == _plain(realign.ops_to_gaps(
                realign.ops_forward(ops_bwd[k]), *args))
