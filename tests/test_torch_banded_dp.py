"""The port's scores-only banded DP (``pwasm_tpu_torch/ops/banded_dp.py``)
on the CPU against the JAX package: the plain version against the XLA
path (``banded_scores_batch``), the two Pallas kernels in interpret mode
and the full-matrix numpy oracle, plus the band placement's error, the
end cell outside the band, N codes, custom scores, the rule that a CPU
tensor never reaches the kernel build, and the CPU mirrors of the
resident kernel's row split (``interior_rows`` against the reference's
formula) and sub-warp layout (``subwarp_layout``).  All comparisons are
exact (integer math)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.ops import banded_dp as ref
from pwasm_tpu_torch.ops import _build, banded_dp

from test_realign import _mutate

NEG = banded_dp.NEG


def make_batch(seed, band, T=16, m_lo=60, m_hi=100, n_max=120,
               alphabet=5):
    """One random query of length m and T mutated targets padded (code
    127) to an n the band can place: m for bands below 4, else up to
    m + band // 2."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(m_lo, m_hi + 1))
    n = m if band < 4 else min(n_max, m + band // 2)
    q = rng.integers(0, alphabet, m).astype(np.int8)
    ts = np.full((T, n), 127, dtype=np.int8)
    t_lens = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = _mutate(rng, q, int(rng.integers(0, 8)),
                    int(rng.integers(0, 6)))[:n]
        ts[k, :len(t)] = t
        t_lens[k] = len(t)
    return q, ts, t_lens


def port_scores(q, ts, t_lens, band, params=banded_dp.ScoreParams()):
    return banded_dp.banded_scores(
        torch.from_numpy(q), torch.from_numpy(ts), torch.from_numpy(t_lens),
        band=band, params=params).numpy()


def ref_scores(q, ts, t_lens, band, params=ref.ScoreParams()):
    return np.asarray(ref.banded_scores_batch(
        jnp.asarray(q), jnp.asarray(ts), jnp.asarray(t_lens), band=band,
        params=params))


@pytest.mark.parametrize("band", [2, 3, 16, 33, 64])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_equals_xla_path(seed, band):
    q, ts, t_lens = make_batch(seed, band)
    want = ref_scores(q, ts, t_lens, band)
    got = port_scores(q, ts, t_lens, band)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if band >= 16:
        assert (got > NEG).sum() >= len(got) // 2   # real scores, not NEG


def test_plain_equals_pallas_resident_kernel():
    rng = np.random.default_rng(21)
    m, n, band, T = 96, 112, 32, 16
    q = rng.integers(0, 4, m).astype(np.int8)
    ts = np.full((T, n), 127, dtype=np.int8)
    t_lens = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = _mutate(rng, q, 6, 3)[:n]
        ts[k, :len(t)] = t
        t_lens[k] = len(t)
    want = np.asarray(ref.banded_scores_pallas(
        jnp.asarray(q), jnp.asarray(ts), jnp.asarray(t_lens), band=band,
        block_t=8, interpret=True))
    np.testing.assert_array_equal(port_scores(q, ts, t_lens, band), want)


def _streamed_inputs(geometry):
    """A query, padded targets, their lengths and the band at a geometry
    of the reference's streamed kernel tests: "plain", "interior_pairs"
    (tests/test_banded_dp.py::test_long_kernel_interior_pairs: whole DMA
    pairs in the mask-elided interior phase) and "short" (fewer query
    rows than the band)."""
    m, n, band, T, seed = {"plain": (96, 112, 32, 16, 22),
                           "interior_pairs": (256, 280, 32, 7, 13),
                           "short": (20, 45, 64, 9, 23)}[geometry]
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, m).astype(np.int8)
    ts = np.full((T, n), 127, dtype=np.int8)
    t_lens = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = _mutate(rng, q, int(rng.integers(0, 8)),
                    int(rng.integers(0, 4)))[:n]
        ts[k, :len(t)] = t
        t_lens[k] = len(t)
    return q, ts, t_lens, band


def _ref_long(q, ts, t_lens, band):
    return np.asarray(ref.banded_scores_long(
        jnp.asarray(q), jnp.asarray(ts), jnp.asarray(t_lens), band=band,
        block_t=8, chunk=32, interpret=True))


@pytest.mark.parametrize("geometry", ["plain", "interior_pairs"])
def test_plain_equals_pallas_streamed_kernel(geometry):
    """The streamed kernel, also at the geometry of
    tests/test_banded_dp.py::test_long_kernel_interior_pairs (whole DMA
    pairs in the mask-elided interior phase)."""
    q, ts, t_lens, band = _streamed_inputs(geometry)
    want = _ref_long(q, ts, t_lens, band)
    np.testing.assert_array_equal(port_scores(q, ts, t_lens, band), want)


@pytest.mark.parametrize("geometry", ["plain", "interior_pairs", "short"])
def test_long_equals_pallas_streamed_kernel(geometry):
    """``banded_scores_long`` on CPU tensors against the reference's
    ``banded_scores_long`` in interpret mode, with the band passed and
    with the default band (128) where it can place."""
    q, ts, t_lens, band = _streamed_inputs(geometry)
    args = (torch.from_numpy(q), torch.from_numpy(ts),
            torch.from_numpy(t_lens))
    got = banded_dp.banded_scores_long(*args, band=band).numpy()
    assert got.dtype == np.int32
    want = _ref_long(q, ts, t_lens, band)
    np.testing.assert_array_equal(got, want)
    assert (got > NEG).sum() >= 2
    if geometry == "short":
        np.testing.assert_array_equal(
            banded_dp.banded_scores_long(*args).numpy(),
            _ref_long(q, ts, t_lens, 128))


@pytest.mark.parametrize("seed", [4, 5])
def test_wide_band_equals_full_gotoh(seed):
    """A band covering the whole matrix gives the unbanded score; the
    port's numpy oracle equals the reference's."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(5, 30))
    q = rng.integers(0, 5, m).astype(np.int8)
    T, n = 6, m + 8
    ts = np.full((T, n), 127, dtype=np.int8)
    t_lens = np.zeros(T, dtype=np.int32)
    for k in range(T):
        t = _mutate(rng, q, 3, 2)[:n]
        ts[k, :len(t)] = t
        t_lens[k] = len(t)
    band = 2 * (m + n) + 1
    got = port_scores(q, ts, t_lens, band)
    for k in range(T):
        t = ts[k, :t_lens[k]]
        want = ref.full_gotoh_score(q, t)
        assert banded_dp.full_gotoh_score(q, t) == want
        assert got[k] == want, k


@pytest.mark.parametrize("m,n,band", [(200, 199, 1), (10, 40, 8),
                                      (40, 10, 16), (5, 5, 1)])
def test_band_dlo_matches_reference(m, n, band):
    try:
        want = ref.band_dlo(m, n, band)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            banded_dp.band_dlo(m, n, band)
        assert str(got.value) == str(e)
        assert "too narrow" in str(e)
    else:
        assert banded_dp.band_dlo(m, n, band) == want


def test_end_cell_outside_band_is_neg():
    """Targets whose t_len puts the end cell outside [0, band) read NEG,
    with the same true t_len on the reference."""
    q, ts, t_lens = make_batch(7, 16)
    m = len(q)
    dlo = banded_dp.band_dlo(m, ts.shape[1], 16)
    t_lens = t_lens.copy()
    t_lens[:4] = [m + dlo - 1, m + dlo + 16, 0, ts.shape[1] + 40]
    got = port_scores(q, ts, t_lens, 16)
    np.testing.assert_array_equal(got, ref_scores(q, ts, t_lens, 16))
    assert (got[:4] == NEG).all()


def test_n_codes_never_match():
    """An N (code 4) in the query never matches, not even an N in the
    target."""
    q, ts, t_lens = make_batch(8, 33, alphabet=4)
    q[::7] = 4
    ts[:, ::5] = np.where(ts[:, ::5] == 127, 127, 4)
    ts[0, :len(q)] = q              # N against N, all along the diagonal
    t_lens[0] = len(q)
    got = port_scores(q, ts, t_lens, 33)
    np.testing.assert_array_equal(got, ref_scores(q, ts, t_lens, 33))
    n_n = int((q == 4).sum())
    assert got[0] == 2 * (len(q) - n_n) - 4 * n_n


def test_custom_score_params():
    q, ts, t_lens = make_batch(9, 33)
    p = dict(match=3, mismatch=5, gap_open=7, gap_extend=1)
    got = port_scores(q, ts, t_lens, 33, banded_dp.ScoreParams(**p))
    np.testing.assert_array_equal(
        got, ref_scores(q, ts, t_lens, 33, ref.ScoreParams(**p)))
    assert (got != port_scores(q, ts, t_lens, 33)).any()


def test_matrix_equals_reference_many2many():
    """The (Q, T) form against the reference's vmapped queries."""
    from pwasm_tpu.parallel.many2many import many2many_scores

    rng = np.random.default_rng(10)
    q, ts, t_lens = make_batch(10, 64, T=9)
    qs = np.stack([q] + [_mutate(rng, q, 5, 0) for _ in range(2)])
    want = np.asarray(many2many_scores(jnp.asarray(qs), jnp.asarray(ts),
                                       jnp.asarray(t_lens), band=64))
    got = banded_dp.banded_scores_matrix(
        torch.from_numpy(qs), torch.from_numpy(ts),
        torch.from_numpy(t_lens), band=64).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        banded_dp.banded_scores(torch.from_numpy(q), torch.from_numpy(ts),
                                torch.from_numpy(t_lens), 64).numpy(),
        want[0])


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU call tried to build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(banded_dp, "_FNS", {})
    q, ts, t_lens = make_batch(11, 16, T=4)
    args = (torch.from_numpy(q), torch.from_numpy(ts),
            torch.from_numpy(t_lens))
    banded_dp.banded_scores(*args, band=16)
    banded_dp.banded_scores_matrix(args[0][None], *args[1:], band=16)
    from pwasm_tpu_torch.parallel.many2many import many2many_scores_ragged
    many2many_scores_ragged([q, q[:50]], list(ts), band=16,
                            device=torch.device("cpu"))
    with pytest.raises(ValueError, match="band must be >= 1"):
        banded_dp.banded_scores_matrix(args[0][None], *args[1:], band=0)
    with pytest.raises(ValueError, match="CUDA"):
        banded_dp.scores_kernel(args[0][None], args[1], args[2], band=16)


def test_pad16_gives_rows_the_launchers_take():
    """``pad16``'s rows start 16 bytes apart, whatever the input's
    strides: a one-row view with row stride 0 (numpy's ``q[None]``), a
    column slice, an odd width; an aligned contiguous input is returned
    as it is."""
    q = np.arange(64, dtype=np.int8)
    for x in (torch.from_numpy(q[None]), torch.from_numpy(q[None, :48]),
              torch.from_numpy(np.stack([q, q]))[:, 16:],
              torch.from_numpy(np.stack([q, q]))[:, :37]):
        T, w = x.shape
        got = banded_dp.pad16(x)
        assert got.shape[0] == T and got.shape[1] % 16 == 0
        assert got.stride() == (got.shape[1], 1)
        assert got.data_ptr() % 16 == 0
        np.testing.assert_array_equal(got[:, :w].numpy(), x.numpy())
        assert (got[:, w:] == 127).all()
    x = torch.from_numpy(np.stack([q, q]))
    if x.data_ptr() % 16 == 0:
        assert banded_dp.pad16(x) is x


def test_long_cpu_tensors_never_reach_the_build(monkeypatch):
    """``banded_scores_long`` on CPU tensors takes the plain version and
    builds nothing; a tensor on neither device raises."""
    def no_build(name):
        raise AssertionError(f"a CPU call tried to build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(banded_dp, "_FNS", {})
    q, ts, t_lens = make_batch(12, 64, T=5)
    args = (torch.from_numpy(q), torch.from_numpy(ts),
            torch.from_numpy(t_lens))
    before = dict(banded_dp.LAUNCHES)
    np.testing.assert_array_equal(
        banded_dp.banded_scores_long(*args, band=64).numpy(),
        port_scores(q, ts, t_lens, 64))
    assert banded_dp.LAUNCHES == before
    with pytest.raises(ValueError, match="band must be >= 1"):
        banded_dp.banded_scores_long(*args, band=0)
    with pytest.raises(ValueError, match="CUDA"):
        banded_dp.banded_scores_long(*(a.to("meta") for a in args), band=64)


def _reference_split(m, n, band, dlo):
    """The reference's head/interior split, read from the source of
    ``_banded_kernel`` (its ``head = ...`` and ``int_end = ...`` lines)
    and evaluated at these sizes."""
    import inspect
    import re

    src = inspect.getsource(ref._banded_kernel)
    scope = dict(m=m, n=n, band=band, dlo=dlo)
    for name in ("head", "int_end"):
        line = re.search(rf"^\s*{name} = (.+?)(\s+#.*)?$", src, re.M)
        scope[name] = eval(line.group(1), {"min": min, "max": max}, scope)
    return scope["head"], scope["int_end"]


@pytest.mark.parametrize("band", [1, 2, 7, 8, 33, 64, 256])
def test_interior_rows_matches_the_reference_split(band):
    """``interior_rows`` equals the reference's formula over a grid of
    shapes the band can place (empty interiors included), and its rows
    are exactly those whose every band cell has 1 <= j <= n."""
    empty = 0
    for m in (0, 1, 5, 20, 45, 150):
        for n in range(max(0, m - band // 2 - 2), m + band + 2, 3):
            try:
                dlo = banded_dp.band_dlo(m, n, band)
            except banded_dp.BandPlacementError:
                continue
            head, int_end = banded_dp.interior_rows(m, n, dlo, band)
            assert (head, int_end) == _reference_split(m, n, band, dlo)
            assert 0 <= head <= int_end <= m
            empty += head == int_end
            for ii in range(m):
                j = ii + 1 + dlo + np.arange(band)
                full = bool(((j >= 1) & (j <= n)).all())
                assert full == (head <= ii < int_end), (m, n, dlo, ii)
    assert empty


def test_subwarp_layout_covers_every_band_a_warp_holds():
    """For bands 1 to 256 the sub-warp layout gives G * C >= band with G
    a power of two of at most 32 and C one of at most 8, and no smaller
    G would do; wider bands take the block-wide body."""
    for band in range(1, 257):
        c, g = banded_dp.subwarp_layout(band)
        assert g & (g - 1) == 0 and 1 <= g <= 32, band
        assert c & (c - 1) == 0 and 1 <= c <= 8, band
        assert g * c >= band > (g // 2) * c, band
        assert c == min(8, 1 << (band - 1).bit_length()), band
    assert banded_dp.subwarp_layout(64) == (8, 8)
    for band in (257, 1024, 4096, 32_768):
        assert banded_dp.subwarp_layout(band) is None


def test_stream_plan_windows_cover_every_read():
    """The streamed body's ring (``stream_plan``, the mirror of
    csrc/banded_dp.cu::stream_plan): for bands 1 to 256, dlo across its
    legal range and m from 0 to a few hundred, the window of every W-row
    step starts on a 16-byte boundary and its ``lane_bytes`` cover every
    column j - 1 that a row of the step reads, for every band index
    b < G * C (pad slots included); where the row is interior, those
    bytes lie in 16-byte copies inside the target's row, so they are
    real bytes, not fill."""
    W = banded_dp.STREAM_WINDOW
    for band in range(1, 257):
        plan = banded_dp.stream_plan(band)
        c, g = banded_dp.subwarp_layout(band)
        assert (plan["cells"], plan["threads"]) == (c, g)
        assert plan["lanes"] == banded_dp.SUB_WARPS * 32 // g
        assert plan["lane_bytes"] % 16 == 0 and plan["slot_bytes"] % 16 == 0
        assert plan["smem"] <= 48 * 1024, band
        gc = g * c
        for dlo in sorted({1 - band, -(band // 2), 0}):
            for m in (0, 1, 15, 16, 31, 32, 33, 95, 130, 333):
                n = m + dlo + band - 1      # the widest n this dlo places
                head, int_end = banded_dp.interior_rows(m, n, dlo, band)
                for k in range((m + W - 1) // W):
                    ws = banded_dp.stream_window_start(k, dlo)
                    assert ws % 16 == 0 and ws <= k * W + dlo < ws + 16
                    rows = np.arange(k * W + 1, min(m, k * W + W) + 1)
                    first = rows - 1 + dlo             # b = 0
                    last = first + gc - 1              # b = G * C - 1
                    assert (first >= ws).all(), (band, dlo, m, k)
                    assert (last < ws + plan["lane_bytes"]).all(), \
                        (band, dlo, m, k)
                    # an interior row's real cells (b < band): the
                    # 16-byte copies holding their columns
                    inner = (rows - 1 >= head) & (rows - 1 < int_end)
                    lo = ws + (first[inner] - ws) // 16 * 16
                    hi = ws + (first[inner] + band - 1 - ws) // 16 * 16 + 16
                    assert (lo >= 0).all() and (first[inner] >= 0).all()
                    assert (hi <= (n + 15) // 16 * 16).all()
    assert banded_dp.stream_plan(257) is None
    assert banded_dp.stream_plan(64)["smem"] == 4 * 3 * (16 + 4 * 96)
