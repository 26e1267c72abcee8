"""The port's many-to-many scoring, bucketing and 2-bit packing on the
CPU against the JAX package: ``many2many_scores`` (the port's
``banded_scores_matrix``) and ``many2many_scores_ragged`` on ragged
lists, a target far longer than every query, the in-band compaction
(targets at every edge of both width groups' band windows, and a spy
that no out-of-band target reaches a dispatch), ``encode_seqs``,
``bucket_queries`` and ``pad_to_width`` field by field, and
``pack_targets``, ``unpack_targets_device`` and ``banded_scores_packed``.
All comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.ops import pack as ref_pack
from pwasm_tpu.parallel import bucketing as ref_bucketing
from pwasm_tpu.parallel import many2many as ref_m2m
from pwasm_tpu_torch.ops import banded_dp, pack
from pwasm_tpu_torch.ops.banded_dp import banded_scores_matrix
from pwasm_tpu_torch.parallel import bucketing, many2many

from test_realign import _mutate

CPU = torch.device("cpu")


def ragged(seed, band):
    """Queries of three lengths and targets shorter than, equal to,
    longer than, and longer than m + band - 2 for each query length,
    mutated copies of the queries (and one unrelated target)."""
    rng = np.random.default_rng(seed)
    lens = (40, 57, 70)
    base = [rng.integers(0, 4, L).astype(np.int8) for L in lens]
    qs = [base[0], _mutate(rng, base[0], 3, 0)[:40], base[1], base[2],
          base[2].copy()]
    qs[-1][::9] = 4                    # an N-bearing query
    ts = []
    for b in base:
        m = len(b)
        for L in (m - 3, m, m + 2, m + band - 2, m + band + 5):
            t = _mutate(rng, b, 4, 2)
            t = np.concatenate([t, rng.integers(0, 4, max(0, L - len(t)))
                                .astype(np.int8)])[:L]
            ts.append(t)
    ts.append(rng.integers(0, 4, 33).astype(np.int8))
    return qs, ts


@pytest.mark.parametrize("band", [8, 16, 64])
def test_ragged_equals_reference(band):
    qs, ts = ragged(band, band)
    want = ref_m2m.many2many_scores_ragged(qs, ts, band=band)
    stats = {}
    got = many2many.many2many_scores_ragged(qs, ts, band=band, device=CPU,
                                            stats=stats)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got > -(2 ** 29)).sum() >= len(qs)     # some real scores
    # three query lengths, each with a short and a long width group
    assert stats["dispatches"] == 6
    assert stats["bucket_s"] >= 0 and stats["score_s"] > 0


def test_ragged_bytes_and_str_inputs():
    rng = np.random.default_rng(3)
    acgtn = np.frombuffer(b"ACGTNacgt", dtype=np.uint8)
    qs = [acgtn[rng.integers(0, 5, 30)].tobytes() for _ in range(3)]
    ts = [acgtn[rng.integers(5, 9, int(n))].tobytes().decode()
          for n in rng.integers(20, 45, 7)]
    np.testing.assert_array_equal(
        many2many.many2many_scores_ragged(qs, ts, band=16, device=CPU),
        ref_m2m.many2many_scores_ragged(qs, ts, band=16))


def test_many2many_scores_equals_reference():
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, 50).astype(np.int8)
    qs = np.stack([q, _mutate(rng, q, 6, 0)[:50], q[::-1].copy()])
    bk = ref_bucketing.pad_to_width([_mutate(rng, q, 3, 3)
                                     for _ in range(9)], 60, truncate=True)
    want = np.asarray(ref_m2m.many2many_scores(
        jnp.asarray(qs), jnp.asarray(bk.data), jnp.asarray(bk.lens),
        band=32))
    got = banded_scores_matrix(
        torch.from_numpy(qs), torch.from_numpy(bk.data),
        torch.from_numpy(bk.lens), band=32)
    np.testing.assert_array_equal(got.numpy(), want)


def _seqs(seed):
    rng = np.random.default_rng(seed)
    return [b"ACGTacgtNn", "ggatcc", b"", "ACGU",
            rng.integers(0, 5, 12).astype(np.int8),
            rng.integers(0, 4, 30).astype(np.int8), b"TTT"]


def test_encode_seqs_equals_reference():
    for a, b in zip(bucketing.encode_seqs(_seqs(1)),
                    ref_bucketing.encode_seqs(_seqs(1))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_buckets_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("data", "lens", "idx"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert g.width == w.width


@pytest.mark.parametrize("extra", [[], [b"ACG", b"GGGTTTAAAC", "acgtn"]])
def test_bucket_queries_equals_reference(extra):
    seqs = _seqs(2) + extra
    _assert_buckets_equal(bucketing.bucket_queries(seqs),
                          ref_bucketing.bucket_queries(seqs))


@pytest.mark.parametrize("width", [40, 12, 5, 0])
def test_pad_to_width_equals_reference(width):
    """The port always clips, as the reference does with truncate=True;
    ``lens`` keeps the true lengths."""
    seqs = _seqs(3)
    got = bucketing.pad_to_width(seqs, width)
    _assert_buckets_equal(
        [got], [ref_bucketing.pad_to_width(seqs, width, truncate=True)])
    assert got.lens.tolist() == [len(s) for s in
                                 bucketing.encode_seqs(seqs)]


def test_ragged_clips_a_long_target(monkeypatch):
    """A target far longer than every query is clipped on the host to
    the longest query + band - 2, the width the reference dispatches it
    at, and still reads NEG; the other scores equal the reference's."""
    qs, ts = ragged(7, 16)
    rng = np.random.default_rng(7)
    ts.insert(2, rng.integers(0, 4, 5_000).astype(np.int8))
    widths = []
    real = many2many.pad_to_width

    def recording(seqs, width):
        b = real(seqs, width)
        widths.append(b.data.shape)
        return b

    monkeypatch.setattr(many2many, "pad_to_width", recording)
    got = many2many.many2many_scores_ragged(qs, ts, band=16, device=CPU)
    assert widths == [(len(ts), 70 + 16 - 2)]
    np.testing.assert_array_equal(
        got, ref_m2m.many2many_scores_ragged(qs, ts, band=16))
    assert (got[:, 2] == -(2 ** 30)).all()
    assert (got > -(2 ** 29)).sum() >= len(qs)


def window_edges(band, m=60, seed=0, longer=True):
    """A query of m bases (and one of m + 13) against mutated copies cut
    or extended to every edge of both width groups' band windows at
    m: m - band//2 - 1 and m - band//2 (the short group's lower edge),
    m - 1, m, m + 1, m + band - 2 and m + band - 1 (the long group's
    upper edge), and far off on both sides.  ``longer=False`` keeps only
    the targets no longer than m."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, m).astype(np.int8)
    qs = [q, np.concatenate([_mutate(rng, q, 4, 0),
                             rng.integers(0, 4, 13).astype(np.int8)])]
    lens = [m - band // 2 - 1, m - band // 2, m - 1, m, m + 1,
            m + band - 2, m + band - 1, m // 3, m + band + 40]
    ts = []
    for L in lens:
        if L > m and not longer:
            continue
        t = _mutate(rng, q, 3, 0)
        t = np.concatenate([t, rng.integers(0, 4, max(0, L - m))
                            .astype(np.int8)])[:L]
        ts.append(t)
    return qs, ts


@pytest.mark.parametrize("band", [1, 2, 7, 64])
def test_compaction_at_the_band_window_edges(band):
    """Only in-band targets are dispatched; the scores at every edge of
    both groups' windows equal the reference's.  At band 1 a target
    longer than its query has no placement: both packages raise the
    same error, and without such targets they agree."""
    qs, ts = window_edges(band, longer=band > 1)
    stats = {}
    got = many2many.many2many_scores_ragged(qs, ts, band=band, device=CPU,
                                            stats=stats)
    np.testing.assert_array_equal(
        got, ref_m2m.many2many_scores_ragged(qs, ts, band=band))
    assert (got > -(2 ** 29)).any()
    assert stats["dispatches"] <= 4
    if band == 1:
        qs, ts = window_edges(band)
        with pytest.raises(ValueError, match="too narrow") as want:
            ref_m2m.many2many_scores_ragged(qs, ts, band=band)
        with pytest.raises(banded_dp.BandPlacementError) as err:
            many2many.many2many_scores_ragged(qs, ts, band=band, device=CPU)
        assert str(err.value) == str(want.value)


@pytest.mark.parametrize("band", [2, 7, 64])
def test_no_out_of_band_target_reaches_a_dispatch(band, monkeypatch):
    """A spy on ``banded_scores_matrix``: every target it is given has
    its end cell in the band, the lanes dispatched are exactly the
    pairs that score, and ``dispatches`` counts the calls."""
    calls = []
    real = many2many.banded_scores_matrix

    def spy(qs, ts, t_lens, band, params):
        m, n = qs.shape[1], ts.shape[1]
        b_end = t_lens.long() - m - banded_dp.band_dlo(m, n, band)
        assert ((b_end >= 0) & (b_end < band)).all(), (m, n, b_end)
        calls.append(qs.shape[0] * ts.shape[0])
        return real(qs, ts, t_lens, band, params)

    monkeypatch.setattr(many2many, "banded_scores_matrix", spy)
    qs, ts = window_edges(band, seed=band)
    qs2, ts2 = ragged(band, band)
    stats = {}
    got = many2many.many2many_scores_ragged(qs + qs2, ts + ts2, band=band,
                                            device=CPU, stats=stats)
    np.testing.assert_array_equal(
        got, ref_m2m.many2many_scores_ragged(qs + qs2, ts + ts2, band=band))
    assert stats["dispatches"] == len(calls) > 0
    assert sum(calls) == int((got != banded_dp.NEG).sum())
    assert sum(calls) < got.size


@pytest.mark.parametrize("n", [37, 40])
def test_pack_unpack_and_packed_scores(n):
    rng = np.random.default_rng(n)
    q = rng.integers(0, 4, 30).astype(np.int8)
    T = 8
    ts = np.full((T, n), 127, dtype=np.int8)
    t_lens = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = _mutate(rng, q, 3, 2)[:n]
        ts[k, :len(t)] = t
        t_lens[k] = len(t)
    packed = pack.pack_targets(ts)
    want_packed = ref_pack.pack_targets(ts)
    assert packed.dtype == want_packed.dtype == np.uint8
    np.testing.assert_array_equal(packed, want_packed)
    un = pack.unpack_targets_device(torch.from_numpy(packed), n)
    np.testing.assert_array_equal(
        un.numpy(), np.asarray(ref_pack.unpack_targets_device(
            jnp.asarray(packed), n)))
    np.testing.assert_array_equal(un.numpy(), np.where(ts == 127, 0, ts))
    got = pack.banded_scores_packed(torch.from_numpy(q),
                                    torch.from_numpy(packed), n,
                                    torch.from_numpy(t_lens), band=16)
    want = np.asarray(ref_pack.banded_scores_packed(
        jnp.asarray(q), jnp.asarray(packed), n, jnp.asarray(t_lens),
        band=16, block_t=8))
    np.testing.assert_array_equal(got.numpy(), want)
    # padding decoded as 'A' gives the scores of the 127-padded batch
    from pwasm_tpu_torch.ops.banded_dp import banded_scores
    np.testing.assert_array_equal(
        got.numpy(), banded_scores(torch.from_numpy(q),
                                   torch.from_numpy(ts),
                                   torch.from_numpy(t_lens), 16).numpy())


@pytest.mark.parametrize("code", [4, 5, -1])
def test_pack_targets_refuses_non_acgt(code):
    ts = np.zeros((2, 9), dtype=np.int8)
    ts[1, 3] = code
    with pytest.raises(ValueError, match="outside"):
        pack.pack_targets(ts)
    with pytest.raises(ValueError, match="outside"):
        ref_pack.pack_targets(ts)
