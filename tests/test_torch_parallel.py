"""The port's multi-device layer against the JAX package's, on the CPU.

The reference's sharded programs run on its 8 virtual CPU devices
(tests/conftest.py); the port's run on meshes whose entries all name the
CPU, each entry a shard run in turn (``parallel/mesh.py``).  Every
comparison is exact: integer math, no tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as RefMesh

from pwasm_tpu.align.gapseq import GapSeq as RefGapSeq
from pwasm_tpu.align.msa import device_counts_votes as ref_counts_votes
from pwasm_tpu.ops.refine_clip import refine_phases_device
from pwasm_tpu.parallel import many2many as ref_m2m
from pwasm_tpu.parallel import mesh as ref_mesh
from pwasm_tpu.parallel.wavefront_sp import \
    wavefront_sp_scores as ref_wavefront
from pwasm_tpu_torch.align.msa import device_counts_votes
from pwasm_tpu_torch.ops import consensus as cons
from pwasm_tpu_torch.ops import ctx_scan
from pwasm_tpu_torch.ops.banded_dp import banded_scores, banded_scores_matrix
from pwasm_tpu_torch.ops.refine_clip import refine_phases
from pwasm_tpu_torch.parallel import mesh as pm
from pwasm_tpu_torch.parallel.bucketing import mesh_multiple
from pwasm_tpu_torch.parallel.many2many import make_many2many, make_mesh2d
from pwasm_tpu_torch.parallel.wavefront_sp import (make_wavefront_sp,
                                                   wavefront_sp_scores)

CPU = torch.device("cpu")


def cpu_mesh(n: int) -> pm.Mesh:
    return pm.make_mesh(devices=[CPU] * n)


def ids(devices) -> np.ndarray:
    return np.vectorize(lambda d: d.id, otypes=[int])(np.asarray(devices))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_layouts_equal_the_reference(n):
    """make_mesh, make_mesh2d and make_multislice_mesh put the same
    device at each index as the reference (ids stand in for devices)."""
    pool = list(range(8))
    got, want = pm.make_mesh(n, devices=pool), ref_mesh.make_mesh(n)
    assert dict(got.shape) == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names) == ("batch", "depth")
    np.testing.assert_array_equal(got.devices.astype(int),
                                  ids(want.devices))
    got2, want2 = make_mesh2d(n, devices=pool), ref_m2m.make_mesh2d(n)
    assert dict(got2.shape) == dict(want2.shape)
    np.testing.assert_array_equal(got2.devices.astype(int),
                                  ids(want2.devices))
    if n % 2 == 0:
        got3 = pm.make_multislice_mesh(2, n, devices=pool)
        want3 = ref_mesh.make_multislice_mesh(2, n)
        assert dict(got3.shape) == dict(want3.shape)
        np.testing.assert_array_equal(got3.devices.astype(int),
                                      ids(want3.devices))
    assert mesh_multiple(got) == n == got.devices.size


def test_mesh_pool_and_errors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = pm.make_mesh()
    assert dict(mesh.shape) == {"batch": 2, "depth": 1}
    assert list(mesh.devices.ravel()) == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
    assert str(dict(cpu_mesh(8).shape)) == "{'batch': 4, 'depth': 2}"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no devices"):
        pm.make_mesh()
    with pytest.raises(ValueError, match="don't split into 3 slices"):
        pm.make_multislice_mesh(3, devices=[CPU] * 8)
    with pytest.raises(ValueError,
                       match="8 devices don't split into 3 slices"):
        ref_mesh.make_multislice_mesh(3, 8)
    assert pm.shard_bounds(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert pm.shard_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


def _pile(rng, depth, cols):
    pile = rng.integers(0, 7, size=(depth, cols)).astype(np.int8)
    pile[:, ::7] = 6                  # columns no code counts in
    return pile


@pytest.mark.parametrize("n,depth,cols", [(8, 1, 37), (4, 5, 64),
                                          (2, 13, 101)])
def test_sharded_counts_votes_equal_reference_and_unsharded(n, depth, cols):
    """Depth below the depth shards (8: 4 x 2), depth no multiple of
    them (4: 2 x 2), columns no multiple of the column shards (8, 2),
    and code-6 cells: the sharded counts and votes equal the
    reference's sharded program and the port's unsharded plain version,
    with one count per (depth, column) shard."""
    pile = _pile(np.random.default_rng(depth * 100 + cols), depth, cols)
    mesh = cpu_mesh(n)
    want_chars, want_counts = ref_counts_votes(
        pile, mesh=ref_mesh.make_mesh(n))
    chars, counts = device_counts_votes(pile, mesh)
    np.testing.assert_array_equal(chars, want_chars)
    np.testing.assert_array_equal(counts, want_counts)
    flat_chars, flat_counts = device_counts_votes(pile, CPU)
    np.testing.assert_array_equal(chars, flat_chars)
    np.testing.assert_array_equal(counts, flat_counts)
    votes, counts_t = pm.sharded_counts_votes(mesh)(pile)
    pv, pc = cons.consensus_counts_votes_plain(torch.from_numpy(pile))
    assert torch.equal(votes, pv) and torch.equal(counts_t, pc)
    assert votes.dtype == torch.int8 and counts_t.dtype == torch.int32
    assert torch.equal(pm.sharded_consensus(mesh)(torch.from_numpy(pile)),
                       pv)


def test_sharded_counts_count_each_tile_once(monkeypatch):
    """Each (depth, column) shard reaches the counting wrapper once, as
    a contiguous tile on its shard's device."""
    tiles = []
    real = pm.consensus_counts_votes

    def spy(pile):
        tiles.append((tuple(pile.shape), pile.is_contiguous()))
        return real(pile)

    monkeypatch.setattr(pm, "consensus_counts_votes", spy)
    pile = _pile(np.random.default_rng(1), 7, 30)
    pm.sharded_counts_votes(cpu_mesh(8))(pile)
    assert tiles == [((4, 8), True)] * 8      # 7 -> 8 rows, 30 -> 32 cols


@pytest.mark.parametrize("n,votes", [(1, 0), (2, 0), (3, 0), (4, 2),
                                     (8, 4)])
def test_one_depth_shard_keeps_the_kernel_votes(monkeypatch, n, votes):
    """A device is its 1 x 1 mesh; a mesh of one depth shard (n = 1, 2,
    3) keeps the counting call's own votes, and only summed depth
    shards vote again, once a column shard."""
    mesh = cpu_mesh(n)
    if n == 1:
        assert dict(pm.as_mesh(CPU).shape) == {"batch": 1, "depth": 1}
        assert pm.as_mesh(CPU).devices.tolist() == [[CPU]]
        assert pm.as_mesh(mesh) is mesh
    calls = []
    real = pm.consensus_vote_counts

    def spy(counts):
        calls.append(tuple(counts.shape))
        return real(counts)

    monkeypatch.setattr(pm, "consensus_vote_counts", spy)
    pile = _pile(np.random.default_rng(n), 9, 40)
    chars, counts = device_counts_votes(pile, mesh)
    assert len(calls) == votes
    want_votes, want_counts = cons.consensus_counts_votes_plain(
        torch.from_numpy(pile))
    np.testing.assert_array_equal(counts, want_counts.numpy())
    table = np.frombuffer(b"ACGTN-", dtype=np.uint8)
    v = want_votes.numpy()
    np.testing.assert_array_equal(
        chars, np.where(v >= 0, table[np.clip(v, 0, 5)], 0))


def _dp_workload(rng, m, T, n):
    q = rng.integers(0, 4, size=m).astype(np.int8)
    ts = np.full((T, n), 127, dtype=np.int8)
    tl = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = list(q)
        for _ in range(int(rng.integers(0, 6))):
            t[int(rng.integers(0, len(t)))] = int(rng.integers(0, 4))
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(1, len(t) - 1))
            if rng.random() < 0.5:
                t.insert(p, int(rng.integers(0, 4)))
            else:
                del t[p]
        t = t[:n]
        ts[k, :len(t)] = t
        tl[k] = len(t)
    return q, ts, tl


@pytest.mark.parametrize("T", [3, 8, 11])
def test_pipeline_step_equals_reference(T):
    """Targets over 'batch' (T below, at and past a multiple of it),
    the pileup over (depth, batch): the reference's step on its 8
    devices, and the port's unsharded calls."""
    rng = np.random.default_rng(T)
    q, ts, tl = _dp_workload(rng, 24, T, 40)
    pileup = rng.integers(0, 7, size=(8, 32)).astype(np.int8)
    scores, votes = pm.make_pipeline_step(cpu_mesh(8), band=32)(
        q, ts, tl, pileup)
    assert torch.equal(scores, banded_scores(
        torch.from_numpy(q), torch.from_numpy(ts), torch.from_numpy(tl),
        32))
    assert torch.equal(votes, cons.consensus_counts_votes_plain(
        torch.from_numpy(pileup))[0])
    if T % 4 == 0:
        ref_s, ref_v = ref_mesh.make_pipeline_step(
            ref_mesh.make_mesh(8), band=32)(
            jnp.asarray(q), jnp.asarray(ts), jnp.asarray(tl),
            jnp.asarray(pileup))
        np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_s))
        np.testing.assert_array_equal(votes.numpy(), np.asarray(ref_v))


def test_multislice_step_equals_reference():
    rng = np.random.default_rng(17)
    m, T, n, depth, cols = 24, 8, 32, 4, 16
    q = rng.integers(0, 4, size=m).astype(np.int8)
    ts = np.full((T, n), 127, dtype=np.int8)
    tl = np.zeros(T, dtype=np.int32)
    for k in range(T):
        L = int(rng.integers(m - 2, n + 1))
        ts[k, :L] = rng.integers(0, 4, size=L)
        tl[k] = L
    pileup = rng.integers(0, 6, size=(depth, cols)).astype(np.int8)
    mesh = pm.make_multislice_mesh(2, devices=[CPU] * 8)
    assert dict(mesh.shape) == {"slice": 2, "batch": 2, "depth": 2}
    scores, votes = pm.make_multislice_step(mesh, band=16)(
        q, ts, tl, pileup)
    ref_s, ref_v = ref_mesh.make_multislice_step(
        ref_mesh.make_multislice_mesh(2, 8), band=16)(
        jnp.asarray(q), jnp.asarray(ts), jnp.asarray(tl),
        jnp.asarray(pileup))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(votes.numpy(), np.asarray(ref_v))


def _m2m_workload(Q, T, m, n, seed=0):
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, size=(Q, m)).astype(np.int8)
    ts = np.full((T, n), 127, dtype=np.int8)
    t_lens = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = list(qs[k % Q])
        for _ in range(int(rng.integers(0, 4))):
            t[int(rng.integers(0, len(t)))] = int(rng.integers(0, 4))
        if rng.random() < 0.5 and len(t) > 2:
            del t[int(rng.integers(1, len(t) - 1))]
        ts[k, :len(t)] = t
        t_lens[k] = len(t)
    return qs, ts, t_lens


@pytest.mark.parametrize("n,Q,T", [(8, 4, 16), (8, 3, 7), (4, 1, 5)])
def test_many2many_equals_reference_and_unsharded(n, Q, T):
    qs, ts, tl = _m2m_workload(Q, T, 24, 32, seed=n + Q + T)
    mesh = make_mesh2d(devices=[CPU] * n)
    got = make_many2many(mesh, band=16)(qs, ts, tl)
    assert got.shape == (Q, T) and got.dtype == torch.int32
    assert torch.equal(got, banded_scores_matrix(
        torch.from_numpy(qs), torch.from_numpy(ts), torch.from_numpy(tl),
        16))
    rm = ref_m2m.make_mesh2d(n)
    if Q % rm.shape["query"] == 0 and T % rm.shape["target"] == 0:
        want = ref_m2m.make_many2many(rm, band=16)(
            jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(tl))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [64, 61])
def test_wavefront_sp_equals_reference(m):
    """Query rows over an 8-entry 'seq' axis, divisible and not (pad rows
    carried through): the reference's ring on its 8 devices, and the
    port's unsharded scores."""
    rng = np.random.default_rng(7)
    T, n, band = 11, 96, 64
    q, ts, tl = _dp_workload(rng, m, T, n)
    mesh = pm.Mesh([CPU] * 8, ("seq",))
    got = wavefront_sp_scores(q, ts, tl, mesh, band=band)
    assert torch.equal(got, banded_scores(
        torch.from_numpy(q), torch.from_numpy(ts), torch.from_numpy(tl),
        band))
    want = ref_wavefront(jnp.asarray(q), jnp.asarray(ts), jnp.asarray(tl),
                         RefMesh(np.asarray(jax.devices()[:8]), ("seq",)),
                         band=band)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wavefront_sp_rejects_indivisible():
    mesh = pm.Mesh([CPU] * 8, ("seq",))
    with pytest.raises(ValueError, match="must divide by mesh axis 'seq' "
                       "size 8"):
        make_wavefront_sp(mesh, 30, 64, 4)
    with pytest.raises(ValueError, match="m_true 33 outside"):
        make_wavefront_sp(mesh, 32, 64, 4, m_true=33)


@pytest.mark.parametrize("n,M", [(3, 13), (8, 37)])
def test_sharded_refine_phases_equal_reference(n, M):
    rng = np.random.default_rng(M)
    L, C = 90, 100
    gseq = rng.choice(np.frombuffer(b"ACGT*", np.uint8), size=(M, L))
    gxpos = np.where(gseq != ord("*"),
                     np.cumsum(gseq != ord("*"), axis=1) - 1, -1)
    consensus = rng.choice(np.frombuffer(b"ACGT*", np.uint8), size=C)
    glen = rng.integers(L // 3, L + 1, size=M)
    totals = np.minimum(glen + rng.integers(-2, 3, size=M), L)
    gclipL = rng.integers(0, 12, size=M)
    gclipR = rng.integers(0, 12, size=M)
    clipL0 = np.where(rng.random(M) < 0.7, gclipL, 0)
    clipR0 = np.where(rng.random(M) < 0.7, gclipR, 0)
    seqlens = np.maximum(gxpos.max(axis=1) + 1, 1)
    cpos = rng.integers(-4, 8, size=M)
    args = (gseq, gxpos, consensus, cpos, glen, totals, gclipL, gclipR,
            clipL0, clipR0, seqlens, RefGapSeq.XDROP, RefGapSeq.MATCH_SC,
            RefGapSeq.MISMATCH_SC)
    got = refine_phases(*args, device=cpu_mesh(n))
    flat = refine_phases(*args, device=CPU)
    want = refine_phases_device(*args, mesh=ref_mesh.make_mesh(n))
    for g, f, w in zip(got, flat, want):
        np.testing.assert_array_equal(g, f)
        np.testing.assert_array_equal(g, w)
    assert (got[0] != clipL0).any() or (got[1] != clipR0).any()


def test_sharded_ctx_scan_counts_a_scan_per_shard():
    """A flush over a mesh of 3 splits the packed events unevenly and
    runs one scan per shard; the rows equal the unsharded flush's."""
    from pwasm_tpu_torch.core.paf import parse_paf_line
    from pwasm_tpu_torch.core.events import extract_alignment
    from pwasm_tpu_torch.report.device_report import submit_events_device

    from helpers import make_paf_line

    q = "ACGGTCCTGAACGGTTCCAATCGAACGTTGCA" * 3
    events = []
    for k in range(40):
        ops = [[("=", 30), ("*", "a", "c"), ("=", 65)],
               [("=", 12), ("ins", "tt"), ("=", 84)],
               [("=", 50), ("del", 3), ("=", 43)]][k % 3]
        line, _ = make_paf_line("q", q, f"t{k}", "+", ops)
        events += extract_alignment(parse_paf_line(line),
                                    q.encode()).tdiffs
    ctx_scan.FLUSHES.clear()
    want = submit_events_device(q.encode(), events, CPU)()
    got = submit_events_device(q.encode(), events,
                               pm.Mesh([CPU] * 3, ("batch",)))()
    assert got == want and len(got) == len(events)
    assert ctx_scan.FLUSHES["cpu"] == 1 + 3
