"""The port's host bucketing (``pwasm_tpu_torch/parallel/bucketing.py``)
against the JAX package's: ``pad_to_width``'s overflow contract (it
raises without ``truncate``, where the port once clipped in silence),
``bucket_targets`` and ``bucket_queries`` with filler rows, and
``scatter_results``' errors and empty buckets.  Every bucket is held to
the reference's field by field; comparisons are exact."""

import numpy as np
import pytest

from pwasm_tpu.parallel import bucketing as ref_bucketing
from pwasm_tpu_torch.core.dna import encode
from pwasm_tpu_torch.parallel.bucketing import (PAD, bucket_queries,
                                                bucket_targets,
                                                pad_to_width, round_up,
                                                scatter_results)

BASES = np.array(list(b"ACGT"), dtype=np.uint8)


def _rand_seqs(rng, n, lo, hi):
    return [bytes(rng.choice(BASES, size=rng.integers(lo, hi)))
            for _ in range(n)]


def _assert_buckets_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("data", "lens", "idx"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert (g.width, g.n_real) == (w.width, w.n_real)


def test_pad_to_width_raises_on_overflow_without_truncate():
    """An over-long sequence raises the reference's ValueError unless the
    caller asks for the clip: silently clipped data would score wrong."""
    seqs = [b"ACGT", b"ACGTACGTACGT"]          # 4 and 12 bases
    with pytest.raises(ValueError) as ref_err:
        ref_bucketing.pad_to_width(seqs, 8)
    with pytest.raises(ValueError) as err:
        pad_to_width(seqs, 8)
    assert str(err.value) == str(ref_err.value) == (
        "1 sequence(s) longer than width 8 (first: index 1, length 12)")


def test_pad_to_width_truncation_contract():
    seqs = [b"ACGT", b"ACGTACGTACGT"]
    b = pad_to_width(seqs, 8, truncate=True, batch_multiple=4)
    assert b.data.shape == (4, 8)
    assert list(b.lens) == [4, 12, 0, 0]        # TRUE length kept
    assert (b.data[1] == encode(b"ACGTACGT")).all()  # data clipped
    assert (b.data[0][:4] == encode(b"ACGT")).all()
    assert (b.data[0][4:] == PAD).all() and (b.data[2:] == PAD).all()
    assert list(b.idx) == [0, 1, -1, -1]        # filler marked
    assert b.n_real == 2
    _assert_buckets_equal([b], [ref_bucketing.pad_to_width(
        seqs, 8, truncate=True, batch_multiple=4)])


@pytest.mark.parametrize("width,mult,pad", [(12, 1, PAD), (12, 3, 5),
                                            (40, 2, PAD)])
def test_pad_to_width_equals_reference_in_range(width, mult, pad):
    rng = np.random.default_rng(width + mult)
    seqs = _rand_seqs(rng, 7, 0, 13)
    _assert_buckets_equal(
        [pad_to_width(seqs, width, batch_multiple=mult, pad=pad)],
        [ref_bucketing.pad_to_width(seqs, width, batch_multiple=mult,
                                    pad=pad)])


@pytest.mark.parametrize("seed,n,lo,hi,step,mult", [
    (0, 40, 1, 50, 16, 1),
    (1, 80, 1, 700, 128, 1),
    (2, 64, 30, 3000, 128, 4),
    (3, 1, 5, 6, 128, 8),
    (4, 33, 200, 201, 64, 2),       # all one bucket, odd count
])
def test_bucket_targets_properties(seed, n, lo, hi, step, mult):
    rng = np.random.default_rng(seed)
    seqs = _rand_seqs(rng, n, lo, hi)
    buckets = bucket_targets(seqs, step=step, batch_multiple=mult)
    _assert_buckets_equal(buckets, ref_bucketing.bucket_targets(
        seqs, step=step, batch_multiple=mult))
    seen = []
    for b in buckets:
        assert b.width % step == 0 and b.width >= step
        assert b.data.shape[0] % mult == 0
        for row, ln, ix in zip(b.data, b.lens, b.idx):
            if ix < 0:
                assert ln == 0 and (row == PAD).all()
                continue
            seen.append(int(ix))
            s = encode(seqs[ix].upper())
            assert ln == len(s) and b.width == round_up(len(s), step)
            assert (row[:ln] == s).all() and (row[ln:] == PAD).all()
    assert sorted(seen) == list(range(n))       # each seq exactly once
    # scatter restores input order and drops the filler rows
    results = [b.lens.astype(np.int64) * 2 for b in buckets]
    got = scatter_results(buckets, results, n)
    np.testing.assert_array_equal(got, [len(s) * 2 for s in seqs])
    np.testing.assert_array_equal(
        got, ref_bucketing.scatter_results(buckets, results, n))


def test_bucket_queries_filler_rows_equal_reference():
    rng = np.random.default_rng(7)
    seqs = _rand_seqs(rng, 30, 3, 40)
    buckets = bucket_queries(seqs, batch_multiple=4, pad=9)
    _assert_buckets_equal(buckets, ref_bucketing.bucket_queries(
        seqs, batch_multiple=4, pad=9))
    for b in buckets:
        live = b.idx >= 0
        assert (b.lens[live] == b.width).all()   # exact, not padded
        assert b.data.shape[0] % 4 == 0
        assert (b.data[~live] == 9).all()


def test_scatter_rejects_mismatched_rows():
    b = bucket_targets([b"ACGT"])[0]
    for fn in (scatter_results, ref_bucketing.scatter_results):
        with pytest.raises(ValueError, match="result rows 2 != bucket "
                           "rows 1"):
            fn([b], [np.zeros(b.data.shape[0] + 1)], 1)
        with pytest.raises(ValueError, match="differ in length"):
            fn([b], [], 1)


def test_scatter_empty_buckets_preserves_shape_and_dtype():
    for fn in (scatter_results, ref_bucketing.scatter_results):
        out = fn([], [], 3, fill=-1, trailing_shape=(4, 2),
                 dtype=np.int32)
        assert out.shape == (3, 4, 2) and out.dtype == np.int32
        assert (out == -1).all()
        out = fn([], [], 2, fill=0, dtype=np.int64)
        assert out.shape == (2,) and out.dtype == np.int64
    # a non-empty call derives everything from per_bucket
    b = bucket_targets([b"ACGT", b"AAAA"])[0]
    r = np.ones((b.data.shape[0], 5), dtype=np.int16)
    out = scatter_results([b], [r], 2, trailing_shape=(9,),
                          dtype=np.float64)
    assert out.shape == (2, 5) and out.dtype == np.int16
