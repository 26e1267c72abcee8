"""``sharded_realign_rows`` and ``realign_pairs(device=mesh)`` of the port
against the JAX package's sharded re-aligner (its 8 virtual CPU devices)
and the port's unsharded call: T below, at and no multiple of the shard
count, lanes the band misses (which escalate in ``realign_pairs``), and
one band placement for every shard of a dispatch.  All comparisons are
exact (integer math)."""

import numpy as np
import pytest
import torch

from pwasm_tpu.ops import realign as ref
from pwasm_tpu.parallel import mesh as ref_mesh
from pwasm_tpu_torch.ops import realign
from pwasm_tpu_torch.parallel import mesh as pm

from test_torch_realign import NAMES, assert_rows_equal, make_lanes

CPU = torch.device("cpu")


def cpu_mesh(n: int) -> pm.Mesh:
    return pm.make_mesh(devices=[CPU] * n)


@pytest.mark.parametrize("n,T,band,dlo", [
    (8, 3, 16, None), (8, 8, 33, -5), (8, 11, 16, None), (4, 1, 33, -5),
    (3, 10, 16, None)])
def test_sharded_rows_equal_reference_and_unsharded(n, T, band, dlo):
    lanes = make_lanes(100 * n + T, T=T, m_max=60, n_max=80)
    got = realign.sharded_realign_rows(cpu_mesh(n), *lanes, band=band,
                                       dlo=dlo)
    assert all(isinstance(x, torch.Tensor) and x.device == CPU
               for x in got)
    got = [x.numpy() for x in got]
    flat = realign.banded_realign_rows(
        *(torch.from_numpy(x) for x in lanes), band=band, dlo=dlo)
    assert_rows_equal([x.numpy() for x in flat], got, f"n={n} T={T}")
    want = ref.sharded_realign_rows(ref_mesh.make_mesh(n), *lanes,
                                    band=band, dlo=dlo)
    assert_rows_equal(want, got, f"n={n} T={T} vs reference")
    # some lanes fall outside a narrow band: their ok is False
    if band == 16:
        assert 0 < int(got[NAMES.index("ok")].sum()) <= T


def test_empty_shards_launch_nothing(monkeypatch):
    """T = 3 over 8 shards: three dispatches of one lane each, on the
    shards' devices, every one with the caller's dlo."""
    calls = []
    real = realign.banded_realign_rows

    def spy(qs, ts, q_lens, t_lens, band, params, dlo):
        calls.append((qs.shape[0], qs.device, dlo))
        return real(qs, ts, q_lens, t_lens, band=band, params=params,
                    dlo=dlo)

    monkeypatch.setattr(realign, "banded_realign_rows", spy)
    lanes = make_lanes(5, T=3, m_max=40, n_max=50)
    realign.sharded_realign_rows(cpu_mesh(8), *lanes, band=16, dlo=-7)
    assert calls == [(1, CPU, -7)] * 3


def _pairs(seed, k):
    """(query, target) byte pairs: mutated copies, and every fourth
    target with a long tail, so its end diagonal leaves band 16 and the
    lane escalates to band 64."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for j in range(k):
        q = rng.integers(0, 4, int(rng.integers(30, 70)))
        t = q.copy()
        subs = rng.random(len(t)) < 0.08
        t[subs] = (t[subs] + 1) % 4
        if j % 4 == 3:
            t = np.concatenate([t, rng.integers(0, 4, 20)])
        out.append((acgt[q].tobytes(), acgt[t].tobytes()))
    return out


@pytest.mark.parametrize("n", [8])
def test_realign_pairs_share_one_dlo_and_escalate(n, monkeypatch):
    """``realign_pairs(device=mesh)`` equals the unsharded run and the
    reference's sharded run; each dispatch's shards get the one dlo
    ``_pick_dlo`` gives the whole chunk, and the tail lanes escalate."""
    pairs = _pairs(n, 13)
    seen = []
    real = realign.banded_realign_rows

    def spy(qs, ts, q_lens, t_lens, band, params, dlo):
        seen.append((band, dlo))
        return real(qs, ts, q_lens, t_lens, band=band, params=params,
                    dlo=dlo)

    picks = []
    real_pick = realign._pick_dlo

    def pick(d_ends, band):
        picks.append((band, real_pick(d_ends, band)))
        return picks[-1][1]

    monkeypatch.setattr(realign, "banded_realign_rows", spy)
    monkeypatch.setattr(realign, "_pick_dlo", pick)
    got = realign.realign_pairs(pairs, band=16, device=cpu_mesh(n))
    assert {b for b, _ in picks} == {16, 64}          # lanes escalated
    assert set(seen) == set(picks)
    assert len(seen) > len(picks)                     # shards per dispatch
    monkeypatch.undo()
    want = realign.realign_pairs(pairs, band=16, device=CPU)
    ref_out = ref.realign_pairs(pairs, band=16, mesh=ref_mesh.make_mesh(n))
    for g, w, r in zip(got, want, ref_out):
        assert (g is None) == (w is None) == (r is None)
        if g is not None:
            assert g[0] == w[0] == r[0]
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[1], r[1])
