"""Byte parity of the port's standalone C++ ``pafreport`` binary
(``pwasm_tpu_torch/native/pafreport_main.cpp``, built by
``native.native_cli_path``) with the port's Python CLI at
``--device=cpu``: report, summary, stderr, exit codes, ``--resume``,
``--stats``, CRLF and CR input, the MSA and consensus writers.

The counterpart of the reference's tests/test_native_cli.py.  The
binary's test hooks are held to the port's Python engine: the X-drop
clip refinement (``--refine-selftest``) to
``align/gapseq.py::refine_clipping_batch`` on the CPU, the clip-bearing
ACE/info writers (``--clip-selftest`` WRITE) and the clip transaction
(``--clip-selftest`` EVAL) to ``align/msa.py``
(``tests/test_torch_msa_library.py`` holds that transaction to the
reference's), and the progressive merge (``--merge-selftest``) to the
reference's Python engine.  On the randomized fixtures the port's binary
is also held to the reference's binary, byte for byte.  Then the build
itself: its key, ``PWASM_NATIVE=0``, a missing g++, concurrent builds,
and the ``Makefile``'s ASan/UBSan gate, ``make memcheck``.
"""

import io
import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu_torch import native
from pwasm_tpu_torch.cli import run

from helpers import make_paf_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BIN: list = []   # built at the first test that needs it, not at collection


def _bin() -> str:
    if not _BIN:
        _BIN.append(native.native_cli_path())
    return _BIN[0]


def _ref_bin() -> str:
    from pwasm_tpu.native import native_cli_path as ref_cli_path

    path = ref_cli_path()
    assert path is not None, "the reference's binary did not build"
    return path


def _with_cpu(args):
    return args if any(a.startswith("--device") for a in args) \
        else args + ["--device=cpu"]


def _run_py(args):
    out, err = io.StringIO(), io.StringIO()
    rc = run(_with_cpu(args), stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


def _run_py_subproc(args):
    """The port's CLI as a process: for output its engine prints to the
    process's own stderr (the soft-clip warning)."""
    res = subprocess.run(
        [sys.executable, "-m", "pwasm_tpu_torch", *_with_cpu(args)],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    return res.returncode, res.stdout, res.stderr


def _run_native(args, binary=None):
    res = subprocess.run([binary or _bin()] + args, capture_output=True,
                         text=True)
    return res.returncode, res.stdout, res.stderr


def _assert_parity(tmp_path, args, compare_stderr=True):
    """Run the Python CLI and the binary with -o/-s outputs per side;
    compare report/summary bytes, stdout, stderr and exit code."""
    py_rep, py_sum = tmp_path / "py.dfa", tmp_path / "py.sum"
    na_rep, na_sum = tmp_path / "na.dfa", tmp_path / "na.sum"
    rc_p, out_p, err_p = _run_py(
        args + ["-o", str(py_rep), "-s", str(py_sum)])
    rc_n, out_n, err_n = _run_native(
        args + ["-o", str(na_rep), "-s", str(na_sum)])
    assert rc_n == rc_p
    assert out_n == out_p
    if compare_stderr:
        assert err_n == err_p
    if py_rep.exists() or na_rep.exists():
        assert na_rep.read_bytes() == py_rep.read_bytes()
    if py_sum.exists() or na_sum.exists():
        assert na_sum.read_bytes() == py_sum.read_bytes()
    return py_rep.read_bytes() if py_rep.exists() else b""


def _assert_ref_binary(tmp_path, args, outs=("dfa", "sum")):
    """The port's binary against the reference's on ``args`` (with the
    ``outs`` files per side): every byte, the exit code and stderr."""
    flags = {"dfa": "-o", "sum": "-s", "mfa": "-w"}
    got = {}
    for side, binary in (("pb", _bin()), ("rb", _ref_bin())):
        files = [f"{flags[o]}{tmp_path / f'{side}.{o}'}" if o in flags
                 else f"--{o}={tmp_path / f'{side}.{o}'}" for o in outs]
        rc, out, err = _run_native(args + files, binary)
        got[side] = (rc, out, err, [(tmp_path / f"{side}.{o}").read_bytes()
                                    for o in outs])
    assert got["pb"] == got["rb"]
    return got["pb"]


def _write_inputs(tmp_path, lines, records):
    fa = tmp_path / "q.fa"
    write_fasta(str(fa), records)
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa)


def _rand_ops(rng, q_aln):
    # alignments are anchored on matches, as minimap2's are: an indel at
    # the very edge would put a gap outside the MSA layout, a separate
    # case below
    n = len(q_aln)
    first = rng.randint(1, min(n, 40))
    ops = [("=", first)]
    pos = first
    while pos < n - 1:
        r = rng.random()
        left = n - 1 - pos   # reserve one base for the final anchor
        if r < 0.55:
            k = rng.randint(1, min(left, 80))
            ops.append(("=", k))
            pos += k
        elif r < 0.78:
            qb = q_aln[pos].upper()
            tb = rng.choice([c for c in "ACGT" if c != qb])
            ops.append(("*", tb.lower(), qb.lower()))
            pos += 1
        elif r < 0.9:
            ops.append(("ins", "".join(
                rng.choice("acgt") for _ in range(rng.randint(1, 15)))))
        else:
            k = rng.randint(1, min(left, 10))
            ops.append(("del", k))
            pos += k
    ops.append(("=", n - pos))
    return ops


def _rand_lines(rng, qname, qseq, n_targets, with_revcomp=True):
    from pwasm_tpu_torch.core.dna import revcomp

    lines = []
    qlen = len(qseq)
    for t in range(n_targets):
        strand = "-" if with_revcomp and rng.random() < 0.4 else "+"
        q_start = rng.randint(0, qlen // 3)
        q_end = rng.randint(q_start + qlen // 3, qlen)
        if strand == "-":
            q_aln = revcomp(qseq.encode()).decode()[
                qlen - q_end:qlen - q_start]
        else:
            q_aln = qseq[q_start:q_end]
        ops = _rand_ops(rng, q_aln.upper())
        line, _ = make_paf_line(qname, qseq, f"t{t}", strand, ops,
                                q_start=q_start, q_end=q_end,
                                t_start=rng.randint(0, 30),
                                nm=rng.randint(0, 9),
                                score=rng.randint(0, 999))
        lines.append(line)
    return lines


# ---------------------------------------------------------------------------
# the report path
# ---------------------------------------------------------------------------
def test_report_and_summary_parity_randomized(tmp_path):
    rng = random.Random(20260730)
    qseq = "".join(rng.choice("ACGT") for _ in range(1200))
    # a homopolymer and a methylation motif, so both checks fire
    qseq = qseq[:300] + "AAAAAA" + qseq[306:600] + "CCTGG" + qseq[605:]
    lines = _rand_lines(rng, "gene1", qseq, 24)
    paf, fa = _write_inputs(tmp_path, lines, [("gene1", qseq.encode())])
    rep = _assert_parity(tmp_path, [paf, "-r", fa])
    assert rep.count(b">") == 24  # every alignment reported
    assert _assert_ref_binary(tmp_path, [paf, "-r", fa])[3][0] == rep


def test_parity_multi_query_and_fullgenome(tmp_path):
    rng = random.Random(99)
    q1 = "".join(rng.choice("ACGT") for _ in range(600))
    q2 = "".join(rng.choice("ACGT") for _ in range(450))
    lines = (_rand_lines(rng, "geneA", q1, 5)
             + _rand_lines(rng, "geneB", q2, 5))
    rng.shuffle(lines)
    paf, fa = _write_inputs(tmp_path, lines,
                            [("geneA", q1.encode()), ("geneB", q2.encode())])
    # gene mode, multi-record FASTA: rlabel prefixes kept
    rep = _assert_parity(tmp_path, [paf, "-r", fa])
    assert b">geneA--" in rep or b">geneB--" in rep
    # full-genome mode: duplicates kept, coordinates in rlabel, no codons
    _assert_parity(tmp_path, [paf, "-r", fa, "-F"])
    _assert_parity(tmp_path, [paf, "-r", fa, "-G", "-N"])


def test_parity_dedup_self_skip_and_verbose(tmp_path):
    rng = random.Random(5)
    qseq = "".join(rng.choice("ACGT") for _ in range(400))
    lines = _rand_lines(rng, "g", qseq, 3)
    lines += [lines[0], lines[0]]  # dup twice: one warning
    self_line, _ = make_paf_line("g", qseq, "g", "+", [("=", len(qseq))])
    lines.append(self_line)
    paf, fa = _write_inputs(tmp_path, lines, [("g", qseq.encode())])
    _assert_parity(tmp_path, [paf, "-r", fa])
    # -v adds the self-skip message (the final stats brief differs by
    # wall time, so compare the lines before it)
    rc_p, _, err_p = _run_py([paf, "-r", fa, "-v", "-o",
                              str(tmp_path / "p")])
    rc_n, _, err_n = _run_native(
        [paf, "-r", fa, "-v", "-o", str(tmp_path / "n")])
    assert rc_n == rc_p == 0
    assert "Skipping alignment of qry seq to itself." in err_n
    assert err_n.splitlines()[:-1] == err_p.splitlines()[:-1]
    assert (tmp_path / "n").read_bytes() == (tmp_path / "p").read_bytes()


def test_parity_auto_fullgenome_by_file_size(tmp_path):
    rng = random.Random(17)
    qseq = "".join(rng.choice("ACGT") for _ in range(130000))
    lines = _rand_lines(rng, "chr", qseq, 2)
    paf, fa = _write_inputs(tmp_path, lines, [("chr", qseq.encode())])
    assert os.path.getsize(fa) > 120000
    rep = _assert_parity(tmp_path, [paf, "-r", fa])
    # auto mode: full genome => coordinates in rlabel, impact column empty
    assert rep.splitlines()[0].startswith(b">chr:")


def test_parity_impact_paths(tmp_path):
    # codon impact: synonymous, nonsense, frameshift
    q = "ATGGCTGCAGCTGCAGCTTGGGCTGCAGCTGCAGCTGCAGCTGCAGCTGCAGCTGCATAA"
    cases = [
        ("syn", [("=", 3), ("*", "a", "t"), ("=", 56)]),
        ("stop", [("=", 21), ("*", "a", "g"), ("=", 38)]),
        ("frame", [("=", 30), ("del", 1), ("=", 29)]),
        ("insfs", [("=", 12), ("ins", "tt"), ("=", 48)]),
        ("inshp", [("=", 9), ("ins", "gg"), ("=", 51)]),
    ]
    lines = []
    for name, ops in cases:
        try:
            line, _ = make_paf_line("cds", q, name, "+", ops)
        except AssertionError:
            continue
        lines.append(line)
    assert lines
    paf, fa = _write_inputs(tmp_path, lines, [("cds", q.encode())])
    _assert_parity(tmp_path, [paf, "-r", fa, "-C"])


def test_parity_display_truncation(tmp_path):
    # an event of more than 12 bases and a context of more than 22 bytes
    rng = random.Random(3)
    q = "".join(rng.choice("ACGT") for _ in range(200))
    ops = [("=", 80), ("ins", "acgtacgtacgtacgtacgt"), ("=", 40),
           ("del", 15), ("=", 65)]
    line, _ = make_paf_line("g", q, "t", "+", ops)
    paf, fa = _write_inputs(tmp_path, [line], [("g", q.encode())])
    rep = _assert_parity(tmp_path, [paf, "-r", fa])
    assert b"[20]" in rep and b"[15]" in rep


def test_parity_error_paths(tmp_path):
    rng = random.Random(11)
    q = "".join(rng.choice("ACGT") for _ in range(120))
    good, _ = make_paf_line("g", q, "t", "+", [("=", 120)])
    fa_rec = [("g", q.encode())]

    def swap(line, old, new):
        assert old in line
        return line.replace(old, new, 1)

    # each corruption fails with the same message and exit code
    corruptions = [
        swap(good, "cs:Z::120", "cs:Z::60*ac:59"),      # base mismatch
        swap(good, "cg:Z:120M", "cg:Z:120Q"),           # unknown cigar op
        swap(good, "cg:Z:120M", "cg:Z:119M"),           # tseq len mismatch
        swap(good, "cs:Z::120", "cs:Z::119~gt10ag:1"),  # splice op
        swap(good, "\tcs:Z::120", ""),                  # missing cs tag
        swap(good, "cs:Z::120", "cs:Z::120!"),          # unhandled cs op
        "too\tfew\tfields",                             # short line
    ]
    for k, bad in enumerate(corruptions):
        paf, fa = _write_inputs(tmp_path, [bad], fa_rec)
        rc_p, out_p, err_p = _run_py([paf, "-r", fa])
        rc_n, out_n, err_n = _run_native([paf, "-r", fa])
        assert (rc_n, err_n) == (rc_p, err_p), f"corruption {k}"
        assert rc_p == 1
    # --skip-bad-lines: same warnings, same surviving report
    lines = [good] + corruptions + [swap(good, "\tt\t", "\tt2\t")]
    paf, fa = _write_inputs(tmp_path, lines, fa_rec)
    _assert_parity(tmp_path, [paf, "-r", fa, "--skip-bad-lines"])


def test_parity_refseq_errors(tmp_path):
    rng = random.Random(13)
    q = "".join(rng.choice("ACGT") for _ in range(80))
    line, _ = make_paf_line("nosuch", q, "t", "+", [("=", 80)])
    paf, fa = _write_inputs(tmp_path, [line], [("g", q.encode())])
    rc_p, _, err_p = _run_py([paf, "-r", fa])
    rc_n, _, err_n = _run_native([paf, "-r", fa])
    assert (rc_n, err_n) == (rc_p, err_p)
    assert "could not retrieve sequence" in err_n
    # r_len mismatch vs FASTA
    line2, _ = make_paf_line("g", q, "t", "+", [("=", 80)])
    line2 = line2.replace(f"\t{len(q)}\t", "\t81\t", 1)
    paf2, fa2 = _write_inputs(tmp_path, [line2], [("g", q.encode())])
    rc_p, _, err_p = _run_py([paf2, "-r", fa2])
    rc_n, _, err_n = _run_native([paf2, "-r", fa2])
    assert (rc_n, err_n) == (rc_p, err_p)
    assert "differs from loaded sequence length" in err_n
    # a missing input file: the same message and exit code
    missing = str(tmp_path / "nope.paf")
    rc_p, _, err_p = _run_py([missing, "-r", fa])
    rc_n, _, err_n = _run_native([missing, "-r", fa])
    assert (rc_n, err_n) == (rc_p, err_p) \
        == (1, f"Cannot open input file {missing}!\n")


def test_parity_softclip_warning(tmp_path):
    rng = random.Random(29)
    q = "".join(rng.choice("ACGT") for _ in range(60))
    line, _ = make_paf_line("g", q, "t", "+", [("=", 60)])
    # a soft clip (query consumed but not aligned): 5S + 55M, with the
    # cs and target shrunk to the 55 aligned bases
    line = line.replace("cg:Z:60M", "cg:Z:5S55M").replace(
        "cs:Z::60", "cs:Z::55")
    line = line.replace("\tt\t60\t0\t60\t", "\tt\t55\t0\t55\t", 1)
    paf, fa = _write_inputs(tmp_path, [line], [("g", q.encode())])
    # the engine prints the soft-clip warning to the process's own
    # stderr: compare processes
    got_p = _run_py_subproc([paf, "-r", fa])
    got_n = _run_native([paf, "-r", fa])
    assert "soft clipping" in got_n[2]
    assert got_n == got_p


def test_parity_motifs_file_and_clipmax(tmp_path):
    rng = random.Random(31)
    q = "".join(rng.choice("ACGT") for _ in range(300))
    lines = _rand_lines(rng, "g", q, 4)
    motifs = tmp_path / "motifs.txt"
    motifs.write_text("# custom\nGGCC\nTTAA\n")
    paf, fa = _write_inputs(tmp_path, lines, [("g", q.encode())])
    _assert_parity(tmp_path, [paf, "-r", fa, f"--motifs={motifs}"])
    # -c's -v message (parsed, never consumed): the first stderr line
    for spec, msg in (("25%", "Percentual max clipping set to 25%"),
                      ("10", "Max clipping set to 10 bases")):
        rc_p, _, err_p = _run_py(
            [paf, "-r", fa, "-v", "-c", spec, "-o", str(tmp_path / "p")])
        rc_n, _, err_n = _run_native(
            [paf, "-r", fa, "-v", "-c", spec, "-o", str(tmp_path / "n")])
        assert rc_n == rc_p == 0
        assert err_p.splitlines()[0] == msg
        assert err_n.splitlines()[0] == msg
    for bad in ("0", "120%"):
        rc_p, _, err_p = _run_py([paf, "-r", fa, "-c", bad])
        rc_n, _, err_n = _run_native([paf, "-r", fa, "-c", bad])
        assert (rc_n, err_n) == (rc_p, err_p)


def test_native_stats_file(tmp_path):
    rng = random.Random(37)
    q = "".join(rng.choice("ACGT") for _ in range(200))
    lines = _rand_lines(rng, "g", q, 3)
    paf, fa = _write_inputs(tmp_path, lines, [("g", q.encode())])
    stats = tmp_path / "stats.json"
    rc, _, _ = _run_native([paf, "-r", fa, "-o", str(tmp_path / "r"),
                            f"--stats={stats}"])
    assert rc == 0
    d = json.loads(stats.read_text())
    py_stats = tmp_path / "py.json"
    assert _run_py([paf, "-r", fa, "-o", str(tmp_path / "p"),
                    f"--stats={py_stats}"])[0] == 0
    p = json.loads(py_stats.read_text())
    # the input counters agree with the port's --stats
    for key in ("lines", "alignments", "skipped_bad_lines",
                "skipped_duplicates", "skipped_self", "resumed_past",
                "aligned_bases", "events", "msa_dropped"):
        assert d[key] == p[key], key
    assert d["alignments"] == 3 and d["aligned_bases"] > 0
    assert set(d) >= {"wall_s", "aligned_bases_per_s"}


def test_parity_knob_validation_and_motif_errors(tmp_path):
    rng = random.Random(43)
    q = "".join(rng.choice("ACGT") for _ in range(100))
    lines = _rand_lines(rng, "g", q, 1)
    paf, fa = _write_inputs(tmp_path, lines, [("g", q.encode())])
    # invalid tuning knobs fail on both sides with exit 1
    for extra in (["--band=abc"], ["--batch=0"], ["--stats"],
                  ["--motifs"]):
        rc_p, _, _ = _run_py([paf, "-r", fa] + extra)
        rc_n, _, _ = _run_native([paf, "-r", fa] + extra)
        assert rc_n == rc_p == 1, extra
    # valid knobs are accepted and do not change the report
    _assert_parity(tmp_path, [paf, "-r", fa, "--band=32", "--batch=16"])
    # missing motif file: same message and exit code
    rc_p, _, err_p = _run_py([paf, "-r", fa, "--motifs=/nonexistent/m"])
    rc_n, _, err_n = _run_native([paf, "-r", fa, "--motifs=/nonexistent/m"])
    assert (rc_n, err_n) == (rc_p, err_p)
    assert "Cannot open motif file" in err_n


def test_parity_zero_length_query(tmp_path):
    # a zero-length record: both print coverage:nan and go on
    (tmp_path / "q.fa").write_text(">e\n\n>g\nACGT\n")
    line = ("e\t0\t0\t0\t+\tt\t0\t0\t0\t0\t0\t60\tNM:i:0\tAS:i:0\t"
            "cg:Z:0M\tcs:Z::0")
    paf = tmp_path / "in.paf"
    paf.write_text(line + "\n")
    rep = _assert_parity(tmp_path, [str(paf), "-r", str(tmp_path / "q.fa")])
    assert b"coverage:nan" in rep


@pytest.mark.parametrize("sep", ["\r\n", "\r"], ids=["crlf", "cr"])
@pytest.mark.parametrize("final", [True, False],
                         ids=["final_newline", "no_final_newline"])
def test_parity_crlf_and_cr_line_endings(tmp_path, sep, final):
    # the Python CLI's block reader and the binary's LineReader treat
    # '\n', '\r\n' and lone '\r' alike, with or without a final one
    rng = random.Random(47)
    q = "".join(rng.choice("ACGT") for _ in range(150))
    lines = _rand_lines(rng, "g", q, 3)
    fa = tmp_path / "q.fa"
    write_fasta(str(fa), [("g", q.encode())])
    paf = tmp_path / "in.paf"
    paf.write_bytes((sep.join(lines) + (sep if final else "")).encode())
    rep = _assert_parity(tmp_path, [str(paf), "-r", str(fa)])
    assert rep.count(b">") == 3


def test_parity_device_values(tmp_path):
    rng = random.Random(53)
    q = "".join(rng.choice("ACGT") for _ in range(80))
    lines = _rand_lines(rng, "g", q, 1)
    paf, fa = _write_inputs(tmp_path, lines, [("g", q.encode())])
    # bare --device and other values: exit 1 with the port's wording
    for val in ("", "=gpu", "=tpu"):
        rc_p, _, err_p = _run_py([paf, "-r", fa, f"--device{val}"])
        rc_n, _, err_n = _run_native([paf, "-r", fa, f"--device{val}"])
        assert (rc_n, err_n) == (rc_p, err_p), val
        assert rc_n == 1 and err_n.startswith("Error: invalid --device "
                                              "value:")
    # --device=cpu runs natively and matches
    _assert_parity(tmp_path, [paf, "-r", fa, "--device=cpu"])


def test_native_rejects_python_only_features(tmp_path):
    rng = random.Random(41)
    q = "".join(rng.choice("ACGT") for _ in range(100))
    lines = _rand_lines(rng, "g", q, 1)
    paf, fa = _write_inputs(tmp_path, lines, [("g", q.encode())])
    for extra in (["--device=cuda"], ["--realign"], ["--shard"],
                  ["--profile=" + str(tmp_path / "t")]):
        rc, _, err = _run_native([paf, "-r", fa] + extra)
        assert rc == 1
        # the rejection line itself points at the port's Python CLI
        assert "is handled by the Python CLI (python -m " \
            "pwasm_tpu_torch)" in err.splitlines()[-1]


# ---------------------------------------------------------------------------
# the MSA and consensus writers
# ---------------------------------------------------------------------------
def _assert_msa_parity(tmp_path, lines, records, extra=None):
    paf, fa = _write_inputs(tmp_path, lines, records)
    args = [paf, "-r", fa] + (extra or [])
    py_m, na_m = tmp_path / "p.mfa", tmp_path / "n.mfa"
    rc_p, _, err_p = _run_py(args + ["-o", str(tmp_path / "p.dfa"),
                                     "-w", str(py_m)])
    rc_n, _, err_n = _run_native(args + ["-o", str(tmp_path / "n.dfa"),
                                         "-w", str(na_m)])
    assert (rc_n, err_n) == (rc_p, err_p)
    if py_m.exists() or na_m.exists():
        assert na_m.read_bytes() == py_m.read_bytes()
    assert (tmp_path / "n.dfa").read_bytes() == \
        (tmp_path / "p.dfa").read_bytes()
    return py_m.read_bytes() if py_m.exists() else b""


def test_parity_msa_randomized(tmp_path):
    rng = random.Random(20260731)
    q = "".join(rng.choice("ACGT") for _ in range(800))
    lines = _rand_lines(rng, "g", q, 16)
    mfa = _assert_msa_parity(tmp_path, lines, [("g", q.encode())])
    assert mfa.count(b">") == 17  # query + every alignment
    paf, fa = str(tmp_path / "in.paf"), str(tmp_path / "q.fa")
    assert _assert_ref_binary(tmp_path, [paf, "-r", fa],
                              ("dfa", "mfa"))[3][1] == mfa


def test_parity_msa_debug_layout(tmp_path):
    rng = random.Random(61)
    q = "".join(rng.choice("ACGT") for _ in range(200))
    lines = _rand_lines(rng, "g", q, 4)
    paf, fa = _write_inputs(tmp_path, lines, [("g", q.encode())])
    rc_p, _, err_p = _run_py(
        [paf, "-r", fa, "-D", "-o", str(tmp_path / "p.dfa"),
         "-w", str(tmp_path / "p.mfa")])
    rc_n, _, err_n = _run_native(
        [paf, "-r", fa, "-D", "-o", str(tmp_path / "n.dfa"),
         "-w", str(tmp_path / "n.mfa")])
    assert rc_n == rc_p == 0
    # the -D layout dump goes to stderr on both sides; the -v brief
    # carries a wall time, so compare the layout block only
    assert ">MSA (5)" in err_n
    p_block = [ln for ln in err_p[err_p.index(">MSA"):].splitlines()
               if "bases/s" not in ln]
    n_block = [ln for ln in err_n[err_n.index(">MSA"):].splitlines()
               if "bases/s" not in ln]
    assert n_block == p_block


def test_parity_msa_out_of_layout_gap(tmp_path):
    # a reverse-strand alignment starting with an insertion puts a ref
    # gap at position r_len: fatal at MSA insertion, skippable under
    # --skip-bad-lines
    rng = random.Random(67)
    q = "".join(rng.choice("ACGT") for _ in range(120))
    bad, _ = make_paf_line("g", q, "tbad", "-",
                           [("ins", "cc"), ("=", 120)])
    good, _ = make_paf_line("g", q, "tok", "+", [("=", 120)])
    records = [("g", q.encode())]
    paf, fa = _write_inputs(tmp_path, [bad], records)
    rc_p, _, err_p = _run_py([paf, "-r", fa, "-o",
                              str(tmp_path / "p.dfa"),
                              "-w", str(tmp_path / "p.mfa")])
    rc_n, _, err_n = _run_native([paf, "-r", fa, "-o",
                                  str(tmp_path / "n.dfa"),
                                  "-w", str(tmp_path / "n.mfa")])
    assert (rc_n, err_n) == (rc_p, err_p)
    assert rc_p == 1 and "invalid gap position" in err_n
    # with skip: dropped from the MSA with the same warning, and the
    # dedup slot frees so a later valid alignment of the pair lands
    bad2 = bad.replace("\ttbad\t", "\ttok\t")
    mfa = _assert_msa_parity(tmp_path, [bad2, good], records,
                             extra=["--skip-bad-lines"])
    assert mfa.count(b">tok") == 1
    stats = tmp_path / "st.json"
    paf, fa = _write_inputs(tmp_path, [bad2, good], records)
    rc, _, _ = _run_native([paf, "-r", fa, "--skip-bad-lines",
                            "-o", str(tmp_path / "r.dfa"),
                            "-w", str(tmp_path / "m.mfa"),
                            f"--stats={stats}"])
    assert rc == 0
    assert json.loads(stats.read_text())["msa_dropped"] == 1


def test_parity_msa_multi_query_writes_last(tmp_path):
    # a PAF spanning several queries writes the LAST query's MSA
    rng = random.Random(71)
    q1 = "".join(rng.choice("ACGT") for _ in range(150))
    q2 = "".join(rng.choice("ACGT") for _ in range(180))
    lines = (_rand_lines(rng, "gA", q1, 2)
             + _rand_lines(rng, "gB", q2, 2))
    mfa = _assert_msa_parity(tmp_path, lines,
                             [("gA", q1.encode()), ("gB", q2.encode())])
    assert b">gB\n" in mfa and b">gA\n" not in mfa


def _assert_cons_parity(tmp_path, lines, records, extra=None):
    """The consensus path: --ace/--info/--cons (with the report and the
    MSA) between the binary and the Python CLI, on the C++ engine and on
    the Python one (``PWASM_NATIVE_MSA=0``)."""
    paf, fa = _write_inputs(tmp_path, lines, records)

    def args(pfx):
        return ([paf, "-r", fa, "-o", str(tmp_path / f"{pfx}.dfa"),
                 "-w", str(tmp_path / f"{pfx}.mfa"),
                 f"--ace={tmp_path / (pfx + '.ace')}",
                 f"--info={tmp_path / (pfx + '.info')}",
                 f"--cons={tmp_path / (pfx + '.cons')}"] + (extra or []))

    rc_n, _, err_n = _run_native(args("n"))
    for pfx, msa_env in (("p", None), ("y", "0")):
        old = os.environ.pop("PWASM_NATIVE_MSA", None)
        if msa_env is not None:
            os.environ["PWASM_NATIVE_MSA"] = msa_env
        try:
            rc_p, _, err_p = _run_py(args(pfx))
        finally:
            os.environ.pop("PWASM_NATIVE_MSA", None)
            if old is not None:
                os.environ["PWASM_NATIVE_MSA"] = old
        assert (rc_n, err_n) == (rc_p, err_p), pfx
        for suff in ("dfa", "mfa", "ace", "info", "cons"):
            pa, na = tmp_path / f"{pfx}.{suff}", tmp_path / f"n.{suff}"
            if pa.exists() or na.exists():
                assert na.read_bytes() == pa.read_bytes(), (pfx, suff)
    return ((tmp_path / "p.ace").read_bytes()
            if (tmp_path / "p.ace").exists() else b"")


@pytest.mark.parametrize("extra", [
    [], ["--remove-cons-gaps"], ["--no-refine-clip"],
    ["--remove-cons-gaps", "--no-refine-clip"]],
    ids=["default", "remove_cons_gaps", "no_refine_clip", "both"])
def test_parity_consensus_writers(tmp_path, extra):
    rng = random.Random(20260801)
    q = "".join(rng.choice("ACGT") for _ in range(600))
    lines = _rand_lines(rng, "g", q, 12)
    ace = _assert_cons_parity(tmp_path, lines, [("g", q.encode())], extra)
    assert ace.startswith(b"CO g ") and b"\nBQ \n" in ace
    if not extra:
        paf, fa = str(tmp_path / "in.paf"), str(tmp_path / "q.fa")
        got = _assert_ref_binary(tmp_path, [paf, "-r", fa],
                                 ("dfa", "mfa", "ace", "info", "cons"))
        assert got[3][2] == ace


def test_parity_consensus_reverse_heavy(tmp_path):
    # a majority-reverse MSA: the ACE contig direction flips to 'C'
    from pwasm_tpu_torch.core.dna import revcomp

    rng = random.Random(20260802)
    q = "".join(rng.choice("ACGT") for _ in range(300))
    lines = []
    for t in range(5):
        strand = "-" if t < 4 else "+"
        q_aln = revcomp(q.encode()).decode() if strand == "-" else q
        line, _ = make_paf_line("g", q, f"t{t}", strand,
                                _rand_ops(rng, q_aln.upper()))
        lines.append(line)
    ace = _assert_cons_parity(tmp_path, lines, [("g", q.encode())])
    assert b" C\n" in ace.splitlines()[0] + b"\n"


def test_parity_resume(tmp_path):
    """--resume as the Python CLI does it: truncate the torn last
    record, re-emit it, skip the survivors, and end byte-identical to an
    uninterrupted run."""
    rng = random.Random(20260804)
    q = "".join(rng.choice("ACGT") for _ in range(300))
    lines = _rand_lines(rng, "g", q, 8)
    paf, fa = _write_inputs(tmp_path, lines, [("g", q.encode())])
    full = tmp_path / "full.dfa"
    rc, _, _ = _run_native([paf, "-r", fa, "-o", str(full)])
    assert rc == 0
    body = full.read_bytes()
    assert _run_py([paf, "-r", fa, "-o", str(tmp_path / "pf.dfa")])[0] == 0
    assert (tmp_path / "pf.dfa").read_bytes() == body
    # an interruption: the first 5 records plus a TORN prefix of the 6th
    header_offs = [i for i in range(len(body))
                   if body[i:i + 1] == b">"
                   and (i == 0 or body[i - 1:i] == b"\n")]
    assert len(header_offs) == 8
    torn = body[:header_offs[5] + 40]
    for pfx in ("p", "n"):
        (tmp_path / f"{pfx}.dfa").write_bytes(torn)
    rc_p, _, err_p = _run_py([paf, "-r", fa, "--resume",
                              "-o", str(tmp_path / "p.dfa")])
    rc_n, _, err_n = _run_native([paf, "-r", fa, "--resume",
                                  "-o", str(tmp_path / "n.dfa")])
    assert (rc_n, err_n) == (rc_p, err_p)
    assert rc_p == 0
    assert (tmp_path / "n.dfa").read_bytes() == \
        (tmp_path / "p.dfa").read_bytes() == body
    # resumed stats: 5 records were skipped by the cursor, on both sides
    for side, fn in (("n2", _run_native), ("p2", _run_py)):
        (tmp_path / f"{side}.dfa").write_bytes(torn)
        stats = tmp_path / f"{side}.json"
        assert fn([paf, "-r", fa, "--resume", "-o",
                   str(tmp_path / f"{side}.dfa"),
                   f"--stats={stats}"])[0] == 0
        d = json.loads(stats.read_text())
        assert d["resumed_past"] == 5 and d["alignments"] == 8, side
    # --resume without -o: exit 1 on both sides
    rc_p, _, err_p = _run_py([paf, "-r", fa, "--resume"])
    rc_n, _, err_n = _run_native([paf, "-r", fa, "--resume"])
    assert rc_n == rc_p == 1
    assert err_n.splitlines()[-1] == err_p.splitlines()[-1] \
        == "--resume requires -o <report>"
    # a fresh resume (no report yet) is a plain run
    rc_n, _, _ = _run_native([paf, "-r", fa, "--resume",
                              "-o", str(tmp_path / "fresh.dfa")])
    assert rc_n == 0
    assert (tmp_path / "fresh.dfa").read_bytes() == body


# ---------------------------------------------------------------------------
# the engine's test hooks
# ---------------------------------------------------------------------------
def test_refine_clipping_parity_fuzz(tmp_path):
    """Clip-seeded fuzz of the engine's X-drop refinement
    (--refine-selftest) against the port's Python engine's
    (``refine_clipping_batch`` on the CPU) and the reference's binary:
    the CLI flow never sets clips, so this hook is the only way to
    drive it (reference GapAssem.cpp:182-349)."""
    import contextlib

    from pwasm_tpu_torch.align.gapseq import GapSeq, refine_clipping_batch

    rng = random.Random(20260803)
    cases = []
    cons = "".join(rng.choice("ACGT*") for _ in range(400))
    for k in range(250):
        n = rng.randint(8, 60)
        bases = "".join(rng.choice("ACGT") for _ in range(n))
        # biased toward consensus-like content so the seek finds matches
        cpos = rng.randint(0, 300)
        if rng.random() < 0.7:
            seg = cons[cpos:cpos + n].replace("*", "A")
            bases = (seg + bases)[:n]
        gaps = [0] * n
        for _ in range(rng.randint(0, 5)):
            gaps[rng.randint(0, n - 1)] = rng.randint(0, 3)
        skip_dels = rng.random() < 0.3
        if skip_dels and rng.random() < 0.5:
            gaps[rng.randint(0, n - 1)] = -1
        clp5 = rng.randint(0, n // 3)
        clp3 = rng.randint(0, n - clp5 - 1) if rng.random() < 0.8 else 0
        rev = rng.randint(0, 1)
        cases.append((f"c{k}", rev, clp5, clp3, cpos, int(skip_dels),
                      gaps, bases))
    infile = tmp_path / "cases.tsv"
    with open(infile, "w") as f:
        f.write(cons + "\n")
        for name, rev, c5, c3, cpos, sd, gaps, bases in cases:
            f.write(f"{name}\t{rev}\t{c5}\t{c3}\t{cpos}\t{sd}\t"
                    f"{','.join(map(str, gaps))}\t{bases}\n")
    rc, out, err = _run_native([f"--refine-selftest={infile}"])
    assert rc == 0
    assert (rc, out, err) == _run_native([f"--refine-selftest={infile}"],
                                         _ref_bin())
    got = {}
    for line in out.splitlines():
        name, c5, c3 = line.split("\t")
        got[name] = (int(c5), int(c3))
    assert len(got) == len(cases)
    for sd in (0, 1):
        seqs, cposes = [], []
        for name, rev, c5, c3, cpos, case_sd, gaps, bases in cases:
            if case_sd != sd:
                continue
            s = GapSeq(name, "", bases.encode())
            s.gaps = np.asarray(gaps, dtype=np.int32)
            s.numgaps = int(sum(gaps))
            s.revcompl = rev
            s.clp5, s.clp3 = c5, c3
            seqs.append(s)
            cposes.append(cpos)
        with contextlib.redirect_stderr(io.StringIO()):
            refine_clipping_batch(seqs, cons.encode(), cposes,
                                  torch.device("cpu"), skip_dels=bool(sd))
        for s in seqs:
            assert got[s.name] == (s.clp5, s.clp3), s.name


def _write_selftest_seqs(f, specs, with_bases=False):
    """SEQ lines for the --clip-selftest hook."""
    for sp in specs:
        row = (f"SEQ\t{sp['name']}\t{sp['revcompl']}\t{sp['offset']}\t"
               f"{sp['clp5']}\t{sp['clp3']}\t"
               f"{','.join(map(str, sp['gaps']))}\t{sp['seqlen']}")
        if with_bases:
            row += f"\t{sp['bases']}"
        f.write(row + "\n")


def _build_python_msa(specs, gapseq_cls, msa_cls):
    """The Python-engine twin of the hook's MSA construction."""
    pseqs = []
    for sp in specs:
        s = gapseq_cls(sp["name"], "", sp.get("bases", "").encode(),
                       seqlen=sp["seqlen"], offset=sp["offset"],
                       clp5=sp["clp5"], clp3=sp["clp3"],
                       revcompl=sp["revcompl"])
        s.gaps = np.asarray(sp["gaps"], dtype=np.int32)
        s.numgaps = int(sum(sp["gaps"]))
        pseqs.append(s)
    msa = msa_cls(pseqs[0], pseqs[1])
    for s in pseqs[2:]:
        msa.add_seq(s, s.offset, s.ng_ofs)
    return msa, pseqs


def test_clip_transaction_parity_fuzz(tmp_path):
    """Clip-transaction fuzz (--clip-selftest EVAL): the engine's
    eval_clipping/apply_clipping accept, reject and apply as the port's
    Python engine (``align/msa.py``) and the reference's binary do, on
    random MSAs and random proposed end trims, across strands and
    clipmax forms."""
    from pwasm_tpu_torch.align.gapseq import GapSeq
    from pwasm_tpu_torch.align.msa import AlnClipOps, Msa

    rng = random.Random(20260805)
    for case in range(40):
        clipmax = rng.choice([0.0, 0.25, 0.4, 12.0, 30.0])
        n_seqs = rng.randint(2, 6)
        seqs_spec = []
        for k in range(n_seqs):
            seqlen = rng.randint(12, 60)
            gaps = [0] * seqlen
            for _ in range(rng.randint(0, 4)):
                gaps[rng.randint(0, seqlen - 1)] = rng.randint(1, 3)
            seqs_spec.append(dict(
                name=f"s{k}", revcompl=rng.randint(0, 1),
                offset=rng.randint(0, 20), clp5=rng.randint(0, 3),
                clp3=rng.randint(0, 3), gaps=gaps, seqlen=seqlen))
        evals = []
        for _ in range(rng.randint(1, 6)):
            idx = rng.randint(0, n_seqs - 1)
            sl = seqs_spec[idx]["seqlen"]
            evals.append((idx, rng.randint(-1, sl // 2),
                          rng.randint(-1, sl // 2)))
        infile = tmp_path / f"clip{case}.tsv"
        with open(infile, "w") as f:
            f.write(f"{clipmax}\n")
            _write_selftest_seqs(f, seqs_spec)
            for idx, c5, c3 in evals:
                f.write(f"EVAL\t{idx}\t{c5}\t{c3}\n")
        rc, out, err = _run_native([f"--clip-selftest={infile}"])
        assert rc == 0, err
        assert (rc, out, err) == _run_native(
            [f"--clip-selftest={infile}"], _ref_bin()), f"case {case}"
        lines = out.splitlines()
        got_clips = {}
        for line in lines[len(evals):]:
            name, c5, c3 = line.split("\t")
            got_clips[name] = (int(c5), int(c3))
        msa, pseqs = _build_python_msa(seqs_spec, GapSeq, Msa)
        want = []
        for idx, c5, c3 in evals:
            ops = AlnClipOps()
            ok = msa.eval_clipping(pseqs[idx], c5, c3, clipmax, ops)
            if ok:
                msa.apply_clipping(ops)
            want.append("ok" if ok else "rejected")
        assert lines[:len(evals)] == want, f"case {case}"
        for s in pseqs:
            assert got_clips[s.name] == (s.clp5, s.clp3), \
                f"case {case} seq {s.name}"


def test_clip_bearing_writers_parity_fuzz(tmp_path):
    """ACE/info writers on MSAs WITH clips (--clip-selftest WRITE): the
    QA clip math, negative AF offsets and the seql/seqr strand swap the
    CLI flow never reaches, byte-compared with the port's Python
    engine (``align/msa.py``) and with the reference's binary."""
    from pwasm_tpu_torch.align.gapseq import GapSeq
    from pwasm_tpu_torch.align.msa import Msa

    rng = random.Random(20260806)
    for case in range(15):
        n_seqs = rng.randint(2, 5)
        seqlen = rng.randint(10, 30)
        specs = []
        for k in range(n_seqs):
            bases = "".join(rng.choice("ACGT") for _ in range(seqlen))
            gaps = [0] * seqlen
            for _ in range(rng.randint(0, 3)):
                gaps[rng.randint(0, seqlen - 1)] = rng.randint(1, 2)
            # member 0 stays unclipped, so every layout column keeps an
            # unclipped contributor (else a zero-coverage exit 5)
            clp5 = rng.randint(0, 3) if k else 0
            clp3 = (rng.randint(0, max(0, seqlen // 2 - clp5 - 2))
                    if k else 0)
            specs.append(dict(name=f"s{k}", revcompl=rng.randint(0, 1),
                              offset=0, clp5=clp5, clp3=clp3,
                              gaps=gaps, bases=bases, seqlen=seqlen))
        # one layout length for every member keeps the MSA covered
        total = [sum(sp["gaps"]) for sp in specs]
        mx = max(total)
        for sp, t in zip(specs, total):
            if t < mx:
                sp["gaps"][0] += mx - t
        infile = tmp_path / f"wclip{case}.tsv"
        with open(infile, "w") as f:
            f.write("0.0\n")
            _write_selftest_seqs(f, specs, with_bases=True)
            f.write("WRITE\tace\nWRITE\tinfo\n")
        rc, out, err = _run_native([f"--clip-selftest={infile}"])
        assert rc == 0, err
        assert (rc, out, err) == _run_native(
            [f"--clip-selftest={infile}"], _ref_bin()), f"case {case}"
        # strip the trailing per-seq clip lines (tab-separated, unlike
        # the space-separated writer bodies)
        native_out = out[:out.rfind(f"{specs[0]['name']}\t")]
        msa, _pseqs = _build_python_msa(specs, GapSeq, Msa)
        msa.refine_msa(torch.device("cpu"), remove_cons_gaps=False,
                       refine_clipping=False)
        buf = io.StringIO()
        msa.write_ace(buf, "ctg")
        msa.write_info(buf, "ctg")
        assert native_out == buf.getvalue(), f"case {case}"


def _merge_spec(rng, name, seqlen, offset, revcompl):
    gaps = [0] * seqlen
    for _ in range(rng.randint(0, 5)):
        gaps[rng.choice([0, seqlen - 1, rng.randint(0, seqlen - 1)])] = \
            rng.randint(1, 3)
    return dict(name=name, revcompl=revcompl, offset=offset, clp5=0,
                clp3=0, gaps=gaps, seqlen=seqlen)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed", [20261018, 20261019, 20261020])
def test_merge_parity_fuzz(tmp_path, seed, flip):
    """The engine's merge (--merge-selftest) leaves every member's
    offset, strand and gaps, and the layout's length and start, as the
    reference's Python engine (one ``inject_gap`` a gap column) does, on
    random MSAs: members starting before, at and past the columns and
    ending before them, gaps at the shared sequence's first and last
    base, with and without the strand flip of the incoming MSA, which
    the CLI flow never reaches.  Its counters: one gap column a
    position whose gap counts differ, at most one pass over each
    member."""
    from pwasm_tpu.align.gapseq import GapSeq
    from pwasm_tpu.align.msa import Msa

    rng = random.Random(seed + flip)
    cases = []
    for case in range(30):
        seqlen = rng.randint(1, 40)
        sides = []
        for side, n in (("a", rng.randint(2, 7)), ("b", rng.randint(2, 4))):
            specs = [_merge_spec(rng, f"{side}{k}",
                                 rng.randint(1, 2 * seqlen),
                                 rng.randint(0, seqlen + 10),
                                 rng.randint(0, 1)) for k in range(n)]
            shared = rng.randrange(n)
            specs[shared] = _merge_spec(rng, f"{side}{shared}", seqlen,
                                        rng.randint(0, 10),
                                        rng.randint(0, 1))
            sides.append((specs, shared))
        (a, ia), (b, ib) = sides
        b[ib]["revcompl"] = a[ia]["revcompl"] ^ flip
        cases.append((a, ia, b, ib))
    infile = tmp_path / "merge.tsv"
    with open(infile, "w") as f:
        for a, ia, b, ib in cases:
            _write_selftest_seqs(f, a)
            f.write("NEXT\n")
            _write_selftest_seqs(f, b)
            f.write(f"MERGE\t{ia}\t{ib}\n")
    rc, out, err = _run_native([f"--merge-selftest={infile}"])
    assert rc == 0, err
    got, block = [], []
    for line in out.splitlines():
        if line.startswith("counts\t"):
            got.append((block, tuple(map(int, line.split("\t")[1:]))))
            block = []
        else:
            block.append(line)
    assert len(got) == len(cases) and not block
    for case, ((a, ia, b, ib), (layout, (n_cols, steps))) in enumerate(
            zip(cases, got)):
        msa, pa = _build_python_msa(a, GapSeq, Msa)
        omsa, pb = _build_python_msa(b, GapSeq, Msa)
        theirs = list(b[ib]["gaps"])
        if flip:
            theirs[1:] = theirs[:0:-1]
        cols = sum(x != y for x, y in zip(a[ia]["gaps"], theirs))
        walkable = sum(s.seqlen for s in pa + pb)
        msa.add_align(pa[ia], omsa, pb[ib])
        assert layout == [f"{msa.length}\t{msa.minoffset}"] + [
            f"{s.name}\t{s.revcompl}\t{s.offset}\t"
            + ",".join(str(int(g)) for g in s.gaps)
            for s in msa.seqs], f"case {case}"
        assert n_cols == cols, f"case {case}"
        assert 0 <= steps <= walkable, f"case {case}"


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------
def test_binary_lies_under_the_port_build_dir_keyed_by_its_sources(
        tmp_path, monkeypatch):
    path = _bin()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("pafreport-")
    assert os.access(path, os.X_OK) and path == native.cli_path()
    assert not os.path.exists(os.path.join(REPO, "pwasm_tpu_torch",
                                           "native", "pafreport"))
    for name in native.CLI_SOURCES:
        shutil.copy(os.path.join(native._HERE, name), tmp_path / name)
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    keys = {native.cli_path()}
    assert keys == {path}
    for name in native.CLI_SOURCES:
        with open(tmp_path / name, "a") as f:
            f.write("\n// a changed source\n")
        keys.add(native.cli_path())
    assert len(keys) == 1 + len(native.CLI_SOURCES)


def test_native_off_or_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PWASM_NATIVE", "0")
    with pytest.raises(RuntimeError, match="PWASM_NATIVE=0"):
        native.native_cli_path()
    monkeypatch.delenv("PWASM_NATIVE")
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.native_cli_path()
    assert not os.listdir(tmp_path / "_build")   # no partial binary


def test_concurrent_builds_publish_one_binary(tmp_path):
    """Three processes building into one empty build directory at once
    each run a whole binary, and only the binary is left there (built
    at -O0 here, to keep the test short)."""
    code = ("import subprocess, sys\n"
            "from pwasm_tpu_torch import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "native.CLI_FLAGS = ('-O0', '-std=c++17')\n"
            "path = native.native_cli_path()\n"
            "res = subprocess.run([path, '-h'], capture_output=True)\n"
            "assert res.returncode == 1 and b'Usage' in res.stderr\n"
            "print(path)\n")
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


def test_native_sanitizer_memcheck(tmp_path):
    """The reference's ASan/UBSan gate, on the port's engine: `make
    memcheck` in pwasm_tpu_torch/native, whose products and scratch
    files all land in pwasm_tpu_torch/_build."""
    d = os.path.join(REPO, "pwasm_tpu_torch", "native")
    # probe: can this toolchain link a sanitized binary at all?
    probe = subprocess.run(
        ["g++", "-fsanitize=address,undefined", "-x", "c++", "-",
         "-o", os.devnull],
        input="int main(){return 0;}", capture_output=True, text=True)
    if probe.returncode != 0:
        pytest.skip("sanitizer toolchain unavailable")
    before = sorted(os.listdir(d))
    res = subprocess.run(["make", "-C", d, "memcheck"], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    for ok in ("native selftest OK", "native CLI sanitizer run OK",
               "msa bridge sanitizer run OK"):
        assert ok in res.stdout, ok
    assert sorted(os.listdir(d)) == before       # the sources alone
    assert not os.listdir(tmp_path)
    build = os.listdir(native.BUILD_DIR)
    for prog in ("selftest_san", "pafreport_san", "msa_bridge_san"):
        assert prog in build
    assert not [f for f in build if f.startswith("san_")]
