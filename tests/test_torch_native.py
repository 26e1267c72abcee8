"""The port's C++ host engine (``pwasm_tpu_torch.native``) against the
JAX package's (``pwasm_tpu.native``), binding by binding, on inputs made
from a seed, compared exactly; and how the port builds and loads it."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import pwasm_tpu.native as ref_native
from pwasm_tpu.core.errors import PwasmError as RefPwasmError
from pwasm_tpu.core.fasta import FastaFile as RefFastaFile
from pwasm_tpu_torch import native
from pwasm_tpu_torch.core.dna import revcomp
from pwasm_tpu_torch.core.errors import PwasmError
from pwasm_tpu_torch.core.events import extract_alignment
from pwasm_tpu_torch.core.fasta import FastaFile
from pwasm_tpu_torch.core.paf import parse_paf_line
from pwasm_tpu_torch.ops.banded_dp import ScoreParams
from pwasm_tpu_torch.ops.realign import full_gotoh_traceback

from helpers import make_paf_line
from test_events import _random_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _aln_tuple(aln):
    return (aln.tseq, aln.offset, aln.seqlen, aln.reverse, aln.edist,
            aln.alnscore,
            [(e.evt, e.rloc, e.tloc, e.evtlen, e.evtbases, e.evtsub,
              e.tctx) for e in aln.tdiffs],
            [(g.pos, g.len) for g in aln.rgaps],
            [(g.pos, g.len) for g in aln.tgaps])


def _record(rng, i: int, strand: str):
    q = "".join(rng.choice(list("ACGT"), size=int(rng.integers(60, 200))))
    q_start = int(rng.integers(0, 8))
    q_end = len(q) - int(rng.integers(0, 8))
    if strand == "-":
        q_aln = revcomp(q.encode()).decode()[len(q) - q_end:len(q) - q_start]
    else:
        q_aln = q[q_start:q_end]
    line, _ = make_paf_line(f"q{i}", q, f"t{i}", strand,
                            _random_ops(rng, q_aln), q_start=q_start,
                            q_end=q_end)
    rec = parse_paf_line(line)
    ref = revcomp(q.encode()) if strand == "-" else q.encode()
    return line, rec, ref


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strand", ["+", "-"])
@pytest.mark.parametrize("seed", range(4))
def test_extract_native_equals_reference(strand, seed):
    from pwasm_tpu.core.paf import parse_paf_line as ref_parse

    rng = np.random.default_rng(900 + seed)
    for i in range(6):
        line, rec, ref = _record(rng, i, strand)
        got = native.extract_native(rec, ref)
        want = ref_native.extract_native(ref_parse(line), ref)
        assert _aln_tuple(got) == _aln_tuple(want)
        # ...and the port's Python walk gives the same alignment
        assert _aln_tuple(extract_alignment(rec, ref, use_native=False)) \
            == _aln_tuple(got)


def test_extract_batch_native_equals_reference():
    from pwasm_tpu.core.paf import parse_paf_line as ref_parse

    rng = np.random.default_rng(1234)
    lines, recs, refs = [], [], []
    for i in range(13):
        line, rec, ref = _record(rng, i, "+" if i % 3 else "-")
        lines.append(line)
        recs.append(rec)
        refs.append(ref)
    alns, err = native.extract_batch_native(recs, refs)
    want, want_err = ref_native.extract_batch_native(
        [ref_parse(ln) for ln in lines], refs)
    assert err is None and want_err is None and len(alns) == 13
    assert [_aln_tuple(a) for a in alns] == [_aln_tuple(a) for a in want]
    # an unparsable cs op at item 7: the items before it extract, and the
    # error is the reference's, and the one-record call's
    lines[7] = lines[7].replace("cs:Z:", "cs:Z:~zz")
    recs[7] = parse_paf_line(lines[7])
    alns, err = native.extract_batch_native(recs, refs)
    want, want_err = ref_native.extract_batch_native(
        [ref_parse(ln) for ln in lines], refs)
    assert len(alns) == len(want) == 7
    assert [_aln_tuple(a) for a in alns] == [_aln_tuple(a) for a in want]
    assert str(err) == str(want_err)
    with pytest.raises(PwasmError) as ei:
        native.extract_native(recs[7], refs[7])
    assert str(ei.value) == str(err)


@pytest.mark.parametrize("batch", [False, True])
def test_bad_substitution_base_is_the_reference_error(batch):
    from pwasm_tpu.core.paf import parse_paf_line as ref_parse

    q = "ACGTACGTAC"
    line, _ = make_paf_line("q", q, "t", "+",
                            [("=", 3), ("*", "a", "t"), ("=", 6)])
    line = line.replace("*at", "*ag")     # the query has T, not G, there
    good, _ = make_paf_line("q", q, "t2", "+", [("=", 10)])
    with pytest.raises(RefPwasmError) as want:
        ref_native.extract_native(ref_parse(line), q.encode())
    if batch:
        alns, err = native.extract_batch_native(
            [parse_paf_line(good), parse_paf_line(line)],
            [q.encode(), q.encode()])
        assert len(alns) == 1
    else:
        with pytest.raises(PwasmError) as ei:
            native.extract_native(parse_paf_line(line), q.encode())
        err = ei.value
    assert "base mismatch" in str(err)
    assert str(err) == str(want.value)
    with pytest.raises(PwasmError) as py:
        extract_alignment(parse_paf_line(line), q.encode(),
                          use_native=False)
    assert str(py.value) == str(err)


# ---------------------------------------------------------------------------
# the FASTA index, fetch and .fai sidecar
# ---------------------------------------------------------------------------
def _fasta_bytes(kind: str, rng) -> bytes:
    def seq(n, alphabet="ACGT"):
        return "".join(rng.choice(list(alphabet), size=n))

    if kind == "wrapped":
        recs = [(f"s{i}", seq(int(rng.integers(50, 400)))) for i in range(6)]
        return "".join(f">{n} desc {i}\n" + "".join(
            s[k:k + 60] + "\n" for k in range(0, len(s), 60))
            for i, (n, s) in enumerate(recs)).encode()
    if kind == "ragged":
        out = []
        for i in range(5):
            s = seq(int(rng.integers(80, 300)))
            k, lines = 0, []
            while k < len(s):
                w = int(rng.integers(10, 70))
                lines.append(s[k:k + w])
                k += w
            out.append(f">r{i}\n" + "\n".join(lines) + "\n")
        return "".join(out).encode()
    if kind == "lower":
        s1, s2 = seq(130, "acgtn"), seq(77, "ACGTacgt")
        return (f">low1\n{s1[:70]}\n{s1[70:]}\n>mixed\n{s2}\n").encode()
    if kind == "duplicate":
        return (b">one some description\nACGTAC\nGT AC\n\n"
                b">two\r\nACG\r\nT\r\n>one\nTTTT\n>\nGG\n>three")
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["wrapped", "ragged", "lower",
                                  "duplicate"])
def test_fasta_index_fetch_and_fai_equal_reference(tmp_path, kind,
                                                   monkeypatch):
    data = _fasta_bytes(kind, np.random.default_rng(len(kind)))
    paths = {}
    for tag in ("port", "ref", "port_py", "ref_py"):
        (tmp_path / tag).mkdir()
        paths[tag] = tmp_path / tag / "x.fa"
        paths[tag].write_bytes(data)
    entries = native.fasta_index(str(paths["port"]))
    assert entries == ref_native.fasta_index(str(paths["ref"]))
    for name, _len, start, end, *_geom in entries:
        assert native.fasta_fetch(str(paths["port"]), start, end) == \
            ref_native.fasta_fetch(str(paths["ref"]), start, end)
    fas = {"port": FastaFile(str(paths["port"])),
           "ref": RefFastaFile(str(paths["ref"]))}
    # the Python scans: PWASM_NATIVE=0 for the port; the reference's
    # native calls answer None, as they do without its library
    monkeypatch.setenv("PWASM_NATIVE", "0")
    monkeypatch.setattr(ref_native, "fasta_index", lambda path: None)
    monkeypatch.setattr(ref_native, "fasta_fetch", lambda *a: None)
    fas["port_py"] = FastaFile(str(paths["port_py"]))
    fas["ref_py"] = RefFastaFile(str(paths["ref_py"]))
    names = fas["ref"].names
    assert all(fa.names == names for fa in fas.values())
    for name in names:
        assert len({fa.fetch(name) for fa in fas.values()}) == 1
        assert len({fa.length(name) for fa in fas.values()}) == 1
    fai = {tag: (p.parent / "x.fa.fai").read_bytes()
           if (p.parent / "x.fa.fai").exists() else None
           for tag, p in paths.items()}
    assert fai["port"] == fai["ref"] and fai["port_py"] == fai["ref_py"]
    assert (fai["port"] is not None) == (kind in ("wrapped", "lower"))


# ---------------------------------------------------------------------------
# the traceback oracle and the vote
# ---------------------------------------------------------------------------
def test_gotoh_traceback_equals_reference():
    rng = np.random.default_rng(42)
    p = ScoreParams()
    pairs = [(np.zeros(0, np.int8), np.array([1, 2], np.int8)),
             (np.array([1], np.int8), np.zeros(0, np.int8))]
    for _ in range(30):
        q = rng.integers(0, 5, int(rng.integers(1, 150))).astype(np.int8)
        t = list(q)
        for _ in range(int(rng.integers(0, 12))):
            k = int(rng.integers(0, max(1, len(t) - 1)))
            r = rng.random()
            if r < 0.4:
                t[k] = int(rng.integers(0, 5))
            elif r < 0.7:
                t.insert(k, int(rng.integers(0, 4)))
            elif len(t) > 2:
                del t[k]
        pairs.append((q, np.array(t, dtype=np.int8)))
    for q, t in pairs:
        args = (q, t, p.match, p.mismatch, p.gap_open, p.gap_extend)
        score, ops = native.gotoh_traceback(*args)
        want_score, want_ops = ref_native.gotoh_traceback(*args)
        assert score == want_score
        np.testing.assert_array_equal(ops, want_ops)
        py_score, py_ops = full_gotoh_traceback(q, t, p)
        assert py_score == score
        np.testing.assert_array_equal(py_ops, ops)


def test_consensus_vote_counts_equals_reference():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 4, size=(3000, 6)).astype(np.int32)
    counts[::7] = 0                              # zero coverage
    counts[3::11, 4] = counts[3::11, 5] = 9      # N and gap tie
    counts[5::13, :4] = 6                        # four-way base tie
    layers = counts.sum(axis=1, dtype=np.int32)
    got = native.consensus_vote_counts(counts, layers)
    np.testing.assert_array_equal(
        got, ref_native.consensus_vote_counts(counts, layers))
    assert ((got == 0) == (layers == 0)).all() and got.dtype == np.uint8
    with pytest.raises(ValueError):
        native.consensus_vote_counts(counts[:-1], layers)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------
def test_changed_source_changes_the_library_key(tmp_path, monkeypatch):
    for name in native.SOURCES:
        shutil.copy(os.path.join(native._HERE, name), tmp_path / name)
    want = native.lib_path()
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    assert native.lib_path() == want
    keys = {want}
    for name in native.SOURCES[1:]:
        with open(tmp_path / name, "a") as f:
            f.write("\n// a changed header\n")
        keys.add(native.lib_path())
    assert len(keys) == 3
    assert all(os.path.dirname(k) == native.BUILD_DIR for k in keys)


def test_missing_compiler_raises_and_returns_no_none(tmp_path, monkeypatch):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.get_lib()
    q = np.array([0, 1, 2], np.int8)
    with pytest.raises(RuntimeError):
        native.gotoh_traceback(q, q, 2, 4, 4, 2)
    with pytest.raises(RuntimeError):
        native.native_msa()
    assert native._lib is None
    assert not os.listdir(tmp_path / "_build")   # no partial library


def test_loaded_library_lies_under_the_port_build_dir():
    lib = native.get_lib()
    path = os.path.realpath(lib._name)
    build = os.path.realpath(os.path.join(REPO, "pwasm_tpu_torch",
                                          "_build"))
    assert path == os.path.realpath(native.lib_path())
    assert os.path.dirname(path) == build
    with open("/proc/self/maps") as f:
        assert path in f.read()


def test_concurrent_builds_publish_one_library(tmp_path):
    """Three processes building into one empty build directory at once
    each load a whole library, and only the library is left there."""
    code = ("import sys\n"
            "from pwasm_tpu_torch import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "native.get_lib()\n"
            "print(native.lib_path())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    build = str(tmp_path / "_build")
    procs = [subprocess.Popen([sys.executable, "-c", code, build], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert os.listdir(build) == [os.path.basename(paths.pop())]
