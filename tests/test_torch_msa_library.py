"""The port's MSA library (``pwasm_tpu_torch/align/msa.py``,
``align/gapseq.py``) against the JAX package's: the best-char rule, the
clip transaction (``eval_clipping``, ``apply_clipping``,
``AlnClipOps``), coverage, per-column provenance (``provenance_matrix``,
``column_contributors``, ``column_mismatches``), ``remove_base`` and the
writers that refine on demand, on the reference's own cases
(tests/test_msa.py, tests/test_provenance.py) and on seeded random
progressive MSAs built in both packages.  All comparisons are exact."""

import contextlib
import copy
import io

import numpy as np
import pytest
import torch

from pwasm_tpu.align import gapseq as ref_gapseq
from pwasm_tpu.align import msa as ref_msa
from pwasm_tpu.core.dna import revcomp
from pwasm_tpu_torch.align import gapseq, msa
from pwasm_tpu_torch.core.errors import PwasmError, ZeroCoverageError

CPU = torch.device("cpu")
PORT = (gapseq.GapSeq, msa.Msa, msa.AlnClipOps)
REF = (ref_gapseq.GapSeq, ref_msa.Msa, ref_msa.AlnClipOps)


# ---------------------------------------------------------------------------
# the reference's cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("counts,layers,expect", [
    ([3, 1, 0, 0, 0, 0], 4, "A"),
    ([0, 0, 0, 0, 0, 3], 3, "-"),
    ([2, 0, 0, 0, 0, 2], 4, "A"),      # ACGT beats '-' on ties
    ([0, 2, 0, 0, 2, 0], 4, "C"),      # ACGT beats N on ties
    ([0, 0, 0, 0, 2, 2], 4, "-"),      # N tied with '-': '-' wins
    ([0, 0, 0, 0, 2, 1], 3, "N"),
    ([0, 0, 0, 0, 1, 2], 3, "-"),
    ([1, 1, 1, 1, 0, 0], 4, "A"),      # first of ACGT wins ties
    ([0, 2, 2, 0, 0, 0], 4, "C"),
    ([0, 0, 0, 0, 0, 0], 0, None),     # zero coverage
])
def test_best_char_rule(counts, layers, expect):
    want = 0 if expect is None else ord(expect)
    assert msa.best_char_from_counts(np.array(counts), layers) == want
    assert ref_msa.best_char_from_counts(np.array(counts), layers) == want
    cols = msa.MsaColumns(1)
    cols.counts[0], cols.layers[0] = counts, layers
    assert cols.best_char(0) == want


def _pair(pkg, seq=b"ACGTACGTACGTACGT"):
    G, M, _ = pkg
    a, b = G("a", "", seq), G("b", "", seq)
    return M(a, b), a, b


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_eval_clipping_propagates(pkg):
    m, a, b = _pair(pkg)
    ops = pkg[2]()
    assert m.eval_clipping(a, 2, -1, 0.0, ops)
    assert [(s.name, c5, c3) for s, c5, c3 in ops.ops] == \
        [("a", 2, -1), ("b", 2, -1)]
    assert ops.total == 2 * (10000 + 2)
    m.apply_clipping(ops)
    assert a.clp5 == 2 and b.clp5 == 2


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_eval_clipping_rejects_over_25pct(pkg):
    m, a, _b = _pair(pkg)              # 16 bases: a clip leaves >= 4
    assert not m.eval_clipping(a, 13, -1, 0.0, pkg[2]())
    assert m.eval_clipping(a, 12, -1, 0.0, pkg[2]())


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_eval_clipping_clipmax(pkg):
    m, a, _b = _pair(pkg)
    assert not m.eval_clipping(a, 5, -1, 4.0, pkg[2]())  # absolute max 4
    assert m.eval_clipping(a, 4, -1, 4.0, pkg[2]())
    assert not m.eval_clipping(a, -1, 5, 0.25, pkg[2]())  # 25% of 16
    assert m.eval_clipping(a, -1, 4, 0.25, pkg[2]())


def test_aln_clip_ops_add_equals_reference():
    rng = np.random.default_rng(3)
    for _ in range(200):
        n = int(rng.integers(8, 40))
        clips = [int(x) for x in rng.integers(0, n // 2, 4)]
        clipmax = float(rng.choice([0.0, 0.25, 0.5, 6.0]))
        got = []
        for G, _M, Ops in (PORT, REF):
            s = G("s", "", b"A" * n)
            s.clp5, s.clp3 = clips[0], clips[1]
            ops = Ops()
            ok = ops.add(s, clips[2], clips[3], clipmax)
            got.append((ok, ops.total, [(c5, c3) for _s, c5, c3
                                        in ops.ops]))
        assert got[0] == got[1]


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_coverage_tracking_pairwise_and_merge(pkg):
    G, M, _ = pkg
    s1 = G("a", seq=b"ACGTACGT")
    s2 = G("b", seq=b"CGTACGTA", offset=1)
    M(s1, s2, cov_spans=((1, 8), (0, 7)))
    np.testing.assert_array_equal(s1.cov, [0, 1, 1, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(s2.cov, [1, 1, 1, 1, 1, 1, 1, 0])
    s1b = G("a", seq=b"ACGTACGT", revcompl=1)
    s1b.enable_coverage()
    s1b.cov[:] = [7, 6, 5, 4, 3, 2, 1, 0]
    s1.add_coverage(s1b)                    # strand-aware: flipped
    np.testing.assert_array_equal(s1.cov, [0, 2, 3, 4, 5, 6, 7, 8])
    s1.rev_complement()                     # reverses the coverage
    np.testing.assert_array_equal(s1.cov, [8, 7, 6, 5, 4, 3, 2, 0])
    with pytest.raises(ValueError, match="invalid addCoverage"):
        s1.add_coverage(G("c", seq=b"ACG"))


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_coverage_mismatched_overhang_penalty(pkg):
    G, M, _ = pkg
    s1 = G("a", seq=b"TTACGTACGTTT")
    s2 = G("b", seq=b"GGACGTACGTGG")
    M(s1, s2, cov_spans=((2, 10), (2, 10)))
    np.testing.assert_array_equal(
        s1.cov, [-1, -1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1])
    np.testing.assert_array_equal(s2.cov, s1.cov)


def test_coverage_follows_a_progressive_merge():
    """``add_align`` adds the merged instance's coverage to the shared
    sequence (flipped when the strands differ) in both packages."""
    got = []
    for G, M, _ in (PORT, REF):
        q1, t1 = G("q", "", b"ACGTACGTAC"), G("t1", "", b"ACGTACGTAC")
        m = M(q1, t1, cov_spans=((0, 10), (0, 10)))
        q2 = G("q", "", b"", seqlen=10, revcompl=1)
        t2 = G("t2", "", b"GTACGT", revcompl=1)
        M(q2, t2, cov_spans=((2, 8), (0, 6)))
        m.add_align(q1, q2.msa, q2)
        got.append([s.cov.tolist() for s in m.seqs])
    assert got[0] == got[1]


def _known_msa(pkg):
    """tests/test_provenance.py's layout:
        q           ACGTAC--GTAC
        asm1        ACGTACggGTAC
        asm2        AC--AC--GTAC
        asm3        ACGTAC--GTAC"""
    G, M, _ = pkg
    q = G("q", "", b"ACGTACGTAC")
    a1 = G("asm1", "", b"ACGTACggGTAC")
    a2 = G("asm2", "", b"ACACGTAC")
    a3 = G("asm3", "", b"ACGTACGTAC")
    q.set_gap(6, 2)
    a3.set_gap(6, 2)
    a2.set_gap(2, 2)
    a2.set_gap(4, 2)
    m = M(q, a1)
    m.add_seq(a2, 0, 0)
    m.add_seq(a3, 0, 0)
    return m


def _build(m, pkg):
    if pkg is PORT:
        m.build_msa(CPU)
    else:
        m.build_msa()


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_provenance_matrix_matches_layout(pkg):
    m = _known_msa(pkg)
    prov = m.provenance_matrix()
    assert prov.shape == m.pileup_matrix().shape
    np.testing.assert_array_equal(prov[0, :12],
                                  [1, 2, 3, 4, 5, 6, 0, 0, 7, 8, 9, 10])
    np.testing.assert_array_equal(prov[2, :12],
                                  [1, 2, 0, 0, 3, 4, 0, 0, 5, 6, 7, 8])
    assert (prov[:, 12:] == 0).all()


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_column_contributors_and_mismatches(pkg):
    m = _known_msa(pkg)
    _build(m, pkg)
    contrib = m.column_contributors(6)
    assert (1, 6, "g", False) in contrib
    assert {k for k, _p, sym, _c in contrib if sym == "-"} == {0, 2, 3}
    assert m.column_mismatches(6) == [(1, 6, "g")]
    assert m.column_mismatches(2) == [(2, 2, "-")]
    assert m.column_mismatches(0) == []


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_clipped_contributors_flagged_not_mismatched(pkg):
    m = _known_msa(pkg)
    m.seqs[3].clp5 = 2
    _build(m, pkg)
    flags = {k: clipped for k, _p, _s, clipped in m.column_contributors(0)}
    assert flags[3] is True
    assert m.column_mismatches(0) == []


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_provenance_requires_pre_refine(pkg):
    m = _known_msa(pkg)
    m.seqs[1].remove_base(0)
    with pytest.raises(Exception, match="pre-refine"):
        m.provenance_matrix()
    m2 = _known_msa(pkg)
    with pytest.raises(Exception, match="requires build_msa"):
        m2.column_mismatches(0)


def test_msa_remove_base_equals_reference():
    got = []
    for pkg in (PORT, REF):
        m = _known_msa(pkg)
        m.remove_base(m.seqs[1], 6)        # asm1's 'g': a layout column
        m.remove_base(m.seqs[0], 0)
        got.append((m.length, [(s.offset, s.numgaps, s.gaps.tolist())
                               for s in m.seqs], _text(m.write_msa)))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the writers refine on demand
# ---------------------------------------------------------------------------
def _text(fn, *args, **kw) -> str:
    buf = io.StringIO()
    fn(buf, *args, **kw)
    return buf.getvalue()


def _writer_bytes(m, **kw) -> tuple:
    return (_text(m.write_ace, "ctg", **kw), _text(m.write_info, "ctg"),
            _text(m.write_cons, "ctg"), _text(m.write_msa))


@pytest.mark.parametrize("rcg,rclip", [(True, True), (False, True),
                                       (False, False)])
def test_writers_refine_on_demand_on_cpu(rcg, rclip):
    """An unrefined MSA's writers refine it on the device given, with the
    flags given, to the bytes of an explicit ``refine_msa`` and of the
    reference's on-demand writers."""
    m = _known_msa(PORT)
    m.seqs[3].clp5 = 3
    explicit = copy.deepcopy(m)
    explicit.refine_msa(CPU, rcg, rclip)
    got = _writer_bytes(m, remove_cons_gaps=rcg, refine_clipping=rclip,
                        device=CPU)
    assert m.refined
    r = _known_msa(REF)
    r.seqs[3].clp5 = 3
    assert got == _writer_bytes(explicit) == _writer_bytes(
        r, remove_cons_gaps=rcg, refine_clipping=rclip)
    # write_cons also refines on its own
    m3 = _known_msa(PORT)
    assert _text(m3.write_cons, "ctg", rcg, rclip, CPU, 5) == \
        _text(_known_msa(REF).write_cons, "ctg", rcg, rclip, linelen=5)


def test_writers_without_a_device_resolve_cuda(monkeypatch):
    """``device=None`` resolves CUDA as every entry point does: without
    CUDA that raises; a refined MSA needs no device at all."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _known_msa(PORT)
    with pytest.raises(PwasmError, match="--device=cuda but torch finds "
                       "no CUDA device"):
        m.write_ace(io.StringIO(), "ctg")
    assert not m.refined
    m.refine_msa(CPU)
    assert _text(m.write_info, "ctg") == \
        _text(_known_msa(REF).write_info, "ctg")


# ---------------------------------------------------------------------------
# seeded random progressive MSAs in both packages
# ---------------------------------------------------------------------------
def _progressive(pkg, rng_seed: int, n_targets: int):
    """A random progressive MSA of one reference and ``n_targets``
    mutated, gapped alignments to it, merged as the CLI's ``msa_add``
    does (the first alignment seeds the MSA; each later one is merged
    through its bare reference instance), then finalized."""
    G, M, _ = pkg
    rng = np.random.default_rng(rng_seed)
    L = int(rng.integers(40, 90))
    ref = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), L))
    first = root = None
    for k in range(n_targets):
        a = int(rng.integers(0, L // 4))
        b = int(rng.integers(3 * L // 4, L + 1))
        tseq, tgap, rgaps = bytearray(), [], []
        pending_del = 0
        for i in range(a, b):
            if i > a and rng.random() < 0.05:       # insertion in target
                ins = int(rng.integers(1, 4))
                rgaps.append((i, ins))
                tgap.append(0)
                tseq += bytes(rng.choice(np.frombuffer(b"acgt", np.uint8),
                                         ins))
                tgap.extend([0] * (ins - 1))
            if a < i < b - 1 and rng.random() < 0.05:
                pending_del += 1                    # deletion in target
                continue
            c = ref[i]
            if rng.random() < 0.05:
                c = int(rng.choice(np.frombuffer(b"ACGTN", np.uint8)))
            tgap.append(pending_del)
            pending_del = 0
            tseq.append(c)
        rev = int(rng.integers(0, 2))
        if rev:
            tseq = bytearray(revcomp(bytes(tseq)))
        t = G(f"t{k}", "", bytes(tseq), offset=a, revcompl=rev)
        for j, g in enumerate(tgap):
            if g:
                t.set_gap(j, g)
        if first is None:
            r = G("ref", "", ref)
            r.set_flag(gapseq.FLAG_IS_REF)
        else:
            r = G("ref", "", b"", seqlen=L)
        for pos, ln in rgaps:
            r.set_gap(pos, ln)
        m = M(r, t)
        if first is None:
            first, root = r, m
        else:
            first.msa.add_align(first, m, r)
            root = first.msa
    root.finalize()
    return root


def _ops_view(ops):
    return (ops.total, [(s.name, c5, c3) for s, c5, c3 in ops.ops])


def _run_quiet(fn):
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            out = fn()
    except (PwasmError, ref_msa.PwasmError) as e:
        out = ("raised", type(e).__name__, str(e))
    return out, err.getvalue()


@pytest.mark.parametrize("seed", range(6))
def test_random_progressive_msas_equal_reference(seed):
    n_targets = 3 + seed % 4
    port = _progressive(PORT, seed, n_targets)
    ref = _progressive(REF, seed, n_targets)
    assert _text(port.write_msa) == _text(ref.write_msa)
    rng = np.random.default_rng(1000 + seed)
    verdicts = []
    for _ in range(12):
        k = int(rng.integers(0, port.count()))
        sl = port.seqs[k].seqlen
        c5, c3 = (int(x) for x in rng.integers(-1, sl // 2, 2))
        clipmax = float(rng.choice([0.0, 0.25, 0.4, 12.0, 30.0]))
        got = []
        for m, Ops in ((port, msa.AlnClipOps), (ref, ref_msa.AlnClipOps)):
            ops = Ops()
            ok = m.eval_clipping(m.seqs[k], c5, c3, clipmax, ops)
            if ok:
                m.apply_clipping(ops)
            got.append((ok, _ops_view(ops)))
        assert got[0] == got[1]
        verdicts.append(got[0][0])
    assert [(s.clp5, s.clp3) for s in port.seqs] == \
        [(s.clp5, s.clp3) for s in ref.seqs]
    # provenance, contributors and mismatches at every column
    np.testing.assert_array_equal(port.provenance_matrix(),
                                  ref.provenance_matrix())
    unrefined = copy.deepcopy(port)
    built, ref_built = copy.deepcopy(port), copy.deepcopy(ref)
    assert _run_quiet(lambda: built.build_msa(CPU)) == \
        _run_quiet(lambda: ref_built.build_msa())
    for col in range(port.length):
        assert built.column_contributors(col) == \
            ref_built.column_contributors(col)
        assert built.column_mismatches(col) == \
            ref_built.column_mismatches(col)
    # the refine and the writers' bytes after it; a zero-coverage column
    # raises in both
    rcg = bool(seed % 2)
    got = _run_quiet(lambda: port.refine_msa(CPU, rcg, True))
    want = _run_quiet(lambda: ref.refine_msa(rcg, True))
    assert got[1] == want[1]
    assert (got[0] is None) == (want[0] is None), (got, want)
    if got[0] is None:
        assert [(s.clp5, s.clp3) for s in port.seqs] == \
            [(s.clp5, s.clp3) for s in ref.seqs]
        assert _writer_bytes(port) == _writer_bytes(ref)
        # the on-demand writers of the unrefined copy give the same bytes
        on_demand = _run_quiet(lambda: _writer_bytes(
            unrefined, remove_cons_gaps=rcg, device=CPU))
        assert on_demand == (_writer_bytes(port), got[1])
    else:
        assert isinstance(got[0], tuple) and got[0][1] == want[0][1] \
            == ZeroCoverageError.__name__


def test_random_progressive_msas_reach_every_verdict():
    """The seeds above accept and refuse clips, and refine to writers'
    bytes at least once: the differential is not vacuous."""
    accepted = refused = refined = 0
    for seed in range(6):
        m = _progressive(PORT, seed, 3 + seed % 4)
        rng = np.random.default_rng(1000 + seed)
        for _ in range(12):
            k = int(rng.integers(0, m.count()))
            sl = m.seqs[k].seqlen
            c5, c3 = (int(x) for x in rng.integers(-1, sl // 2, 2))
            clipmax = float(rng.choice([0.0, 0.25, 0.4, 12.0, 30.0]))
            ops = msa.AlnClipOps()
            if m.eval_clipping(m.seqs[k], c5, c3, clipmax, ops):
                m.apply_clipping(ops)
                accepted += 1
            else:
                refused += 1
        refined += _run_quiet(lambda: m.refine_msa(
            CPU, bool(seed % 2), True))[0] is None
    assert accepted > 0 and refused > 0 and refined > 0
