"""The port's consensus counts + vote against the JAX package.

The port's ``consensus_counts_votes`` on a CPU tensor runs its plain
torch version; the CUDA kernel it stands beside is checked against that
plain version on the card by ``chip_smoke.py``.  Here the plain version
must equal the reference's Pallas kernel (interpret mode on the CPU,
as tests/test_consensus_ops.py runs it), its XLA twin and its numpy
host counts, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.ops.consensus import (consensus_pallas, consensus_votes,
                                     host_class_counts)
from pwasm_tpu.ops.consensus import consensus_vote_counts as ref_vote
from pwasm_tpu.ops.consensus import votes_to_chars as ref_chars
from pwasm_tpu_torch.ops import consensus as tc


def _pile(depth: int, cols: int, seed: int) -> np.ndarray:
    """Codes 0..5 with -1, 6 and 100 mixed in, zero-coverage columns
    and N/gap ties at the column maximum."""
    rng = np.random.default_rng(seed)
    pile = rng.integers(0, 6, size=(depth, cols), dtype=np.int8)
    noise = rng.random((depth, cols))
    pile[noise < 0.05] = -1
    pile[(noise >= 0.05) & (noise < 0.10)] = 6
    pile[(noise >= 0.10) & (noise < 0.12)] = 100
    pile[:, ::7] = rng.choice(np.array([-1, 6, 100], np.int8),
                              size=(depth, len(range(0, cols, 7))))
    tie = np.where(np.arange(depth) % 2 == 0, 4, 5).astype(np.int8)
    if depth % 2:
        tie[-1] = -1                   # equal N and gap counts
    pile[:, 3::11] = tie[:, None]
    return pile


@pytest.mark.parametrize("depth,cols", [(1, 1), (1, 130), (31, 129),
                                        (32, 257), (77, 333),
                                        (1025, 200)])
def test_plain_matches_reference_kernel(depth, cols):
    pile = _pile(depth, cols, seed=depth * 1000 + cols)
    votes, counts = tc.consensus_counts_votes(torch.from_numpy(pile))
    assert votes.dtype == torch.int8 and counts.dtype == torch.int32
    assert votes.shape == (cols,) and counts.shape == (cols, 6)
    rv, rc = consensus_pallas(jnp.asarray(pile), col_tile=128)
    np.testing.assert_array_equal(votes.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(
        votes.numpy(), np.asarray(consensus_votes(jnp.asarray(pile))))
    np.testing.assert_array_equal(counts.numpy(), host_class_counts(pile))
    # the fixture really holds zero-coverage columns and N/gap ties
    assert (votes.numpy() == tc.CODE_ZERO_COV).any()
    if depth > 1 and cols > 3:
        assert votes.numpy()[3] == 5


def test_vote_ties_match_reference():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 6, size=(500, 6)).astype(np.int32)
    counts[:20] = 0
    # every tie pattern across the six buckets
    crafted = np.array([[3 if (p >> k) & 1 else 1 for k in range(6)]
                        for p in range(64)], np.int32)
    counts = np.vstack([counts, crafted])
    got = tc.consensus_vote_counts(torch.from_numpy(counts))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_vote(jnp.asarray(counts))))


def test_votes_to_chars_bytes():
    votes = np.array([0, 1, 2, 3, 4, 5, 5, 0], np.int8)
    for star in (True, False):
        got = tc.votes_to_chars(torch.from_numpy(votes), star_gap=star)
        assert got == ref_chars(votes, star_gap=star)
    assert tc.votes_to_chars(votes) == b"ACGTN**A"
    with pytest.raises(ValueError):
        tc.votes_to_chars(np.array([0, -1], np.int8))


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    pile = torch.zeros((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tc.consensus_counts_votes(pile)


# the CUDA kernel's 4-lane byte counters flush every 255 rows, and a
# cluster's blocks split the depth into slabs: depths on both sides of
# the flush, at a column count no multiple of 4
@pytest.mark.parametrize("depth", [1, 254, 255, 256, 511, 1100])
def test_plain_matches_reference_across_the_flush_depths(depth):
    pile = _pile(depth, 131, seed=depth)
    votes, counts = tc.consensus_counts_votes(torch.from_numpy(pile))
    rv, rc = consensus_pallas(jnp.asarray(pile), col_tile=128)
    np.testing.assert_array_equal(votes.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(counts.numpy(), host_class_counts(pile))


def test_plain_matches_reference_from_a_misaligned_start():
    """A pileup whose first byte is not 4-byte aligned (the kernel reads
    funnel-shifted aligned words there) and whose rows are no multiple
    of 4 bytes."""
    pile = _pile(37, 257, seed=5)
    buf = torch.zeros(pile.size + 3, dtype=torch.int8)
    view = buf[3:].view(pile.shape)
    view.copy_(torch.from_numpy(pile))
    assert view.data_ptr() % 4 != 0 and view.is_contiguous()
    votes, counts = tc.consensus_counts_votes(view)
    rv, rc = consensus_pallas(jnp.asarray(pile), col_tile=128)
    np.testing.assert_array_equal(votes.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))


@pytest.mark.parametrize("depth,cols,cluster", [
    (0, 100, 1), (1, 1, 1), (3, 1_000_001, 1), (15, 9_894, 1),
    (32, 9_894, 2), (201, 9_894, 8), (201, 300, 8), (4_096, 300, 8),
    (2_001, 100_000, 2), (1_025, 4_097, 8)])
def test_consensus_plan(depth, cols, cluster):
    """The mirror of ``pw_consensus_plan``: a cluster of S blocks per
    512-column tile, S the least of 8, the clusters that bring the grid
    to 264 blocks (two an SM of 132) and depth // 16, at least 1; each
    block counts at most ceil(depth / S) rows."""
    plan = tc.consensus_plan(depth, cols)
    tiles = -(-cols // 512)
    assert plan == dict(cluster=cluster, blocks=tiles * cluster,
                        threads=128, tile_cols=512,
                        rows=-(-depth // cluster), smem=6 * 512 * 4)
    if cluster > 1:
        assert plan["rows"] >= 16


def test_consensus_plan_fills_the_card_at_the_realistic_pileup():
    # the 200-alignment corpus's pileup (PERF.md): 20 tiles alone would
    # be 20 blocks on 132 SMs
    plan = tc.consensus_plan(201, 9_894)
    assert plan["blocks"] >= 132 and plan["cluster"] <= 8
    assert tc.consensus_plan(-1, 5) is None
    assert tc.consensus_plan(5, -1) is None
