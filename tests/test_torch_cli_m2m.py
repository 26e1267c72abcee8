"""``pafreport --many2many`` through the port's CLI on the CPU against the
JAX package's CLI: byte parity of ``-o``, ``-s`` and stdout on the
fixture of ``tests/test_stream.py`` and on a small ``make_m2m_corpus``,
the per-section multi-vs-single contract, and the error paths (same exit
code and error line; the usage text above it names the port's options)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.corpus import make_m2m_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(tmp_path, n_q=4, n_t=6, seed=5):
    """The many2many fixture of tests/test_stream.py."""
    rng = np.random.default_rng(seed)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n)).encode()

    qs = [(f"cds{i}", seq(120 + (i % 3) * 40)) for i in range(n_q)]
    ts = [(f"asm{i}", seq(150 + 17 * i)) for i in range(n_t)]
    qfa, tfa = str(tmp_path / "q.fa"), str(tmp_path / "t.fa")
    write_fasta(qfa, qs)
    write_fasta(tfa, ts)
    return qs, qfa, tfa


def _both(tmp_path, args):
    """Run the reference and the port on ``args`` ("OUT" stands for a
    per-package output prefix): (rc, stdout, stderr, {suffix: bytes})
    each."""
    res = []
    for tag, fn in (("ref", ref_run), ("port", run)):
        argv = [a.replace("OUT", str(tmp_path / tag)) for a in args]
        out, err = io.StringIO(), io.StringIO()
        rc = fn(argv, stdout=out, stderr=err)
        files = {}
        for a in argv:
            if a.startswith(str(tmp_path / tag)) and os.path.exists(a):
                with open(a, "rb") as f:
                    files[a.rsplit(".", 1)[1]] = f.read()
        res.append((rc, out.getvalue(), err.getvalue(), files))
    return res


@pytest.mark.parametrize("band", [2, 16, 64])
def test_fixture_bytes_equal_reference(tmp_path, band):
    _qs, qfa, tfa = _fixture(tmp_path)
    want, got = _both(tmp_path, ["--many2many", tfa, "-r", qfa,
                                 "-o", "OUT.tsv", "-s", "OUT.sum",
                                 f"--band={band}", "--device=cpu"])
    assert got[0] == want[0] == 0, got[2]
    assert set(got[3]) == {"tsv", "sum"}
    assert got[3] == want[3]
    rows = [ln for ln in got[3]["tsv"].decode().splitlines()
            if not ln.startswith(">")]
    real = sum(not ln.endswith("\t.") for ln in rows)
    # no target is within a band of 2 of its query's length
    assert real == 0 if band == 2 else band < 64 or real > 0


def test_stdout_bytes_equal_reference(tmp_path):
    _qs, qfa, tfa = _fixture(tmp_path, n_q=2, n_t=3)
    want, got = _both(tmp_path, ["--many2many", tfa, "-r", qfa,
                                 "--device=cpu"])
    assert got[0] == want[0] == 0
    assert got[1] == want[1] and got[1].startswith(">cds0\t")


def test_corpus_bytes_equal_reference(tmp_path):
    qfa, tfa = make_m2m_corpus(n_q=6, n_t=40, out_dir=str(tmp_path))
    want, got = _both(tmp_path, ["--many2many", tfa, "-r", qfa,
                                 "-o", "OUT.tsv", "-s", "OUT.sum",
                                 "--device=cpu"])
    assert got[0] == want[0] == 0, got[2]
    assert got[3] == want[3]
    rows = got[3]["tsv"].decode().splitlines()
    assert len(rows) == 6 * 41
    assert sum(not r.endswith("\t.") for r in rows) > 6   # real scores


def test_multi_equals_single_sections(tmp_path):
    """One multi-CDS job's sections and -s lines are the concatenation
    of single-CDS runs (tests/test_stream.py's contract)."""
    qs, qfa, tfa = _fixture(tmp_path)
    stats = {}
    assert run(["--many2many", tfa, "-r", qfa, "-o", str(tmp_path / "m.tsv"),
                "-s", str(tmp_path / "m.sum"), "--device=cpu"],
               stderr=io.StringIO(), stats=stats) == 0
    # the 120-base queries have no target of 120 bases or less
    assert stats["dispatches"] == 5 and stats["pairs"] == 24
    assert set(stats["times"]) == {"load", "bucket", "score", "format",
                                   "write"}
    body, summ = b"", b""
    for name, s in qs:
        q1 = str(tmp_path / f"{name}.fa")
        write_fasta(q1, [(name, s)])
        assert run(["--many2many", tfa, "-r", q1,
                    "-o", str(tmp_path / f"{name}.tsv"),
                    "-s", str(tmp_path / f"{name}.sum"), "--device=cpu"],
                   stderr=io.StringIO()) == 0
        body += (tmp_path / f"{name}.tsv").read_bytes()
        summ += (tmp_path / f"{name}.sum").read_bytes()
    assert body == (tmp_path / "m.tsv").read_bytes()
    assert summ == (tmp_path / "m.sum").read_bytes()


@pytest.mark.parametrize("case", ["no_r", "no_targets", "two_targets",
                                  "band_x", "band_0", "w", "realign",
                                  "missing_fasta"])
def test_error_paths_equal_reference(tmp_path, case):
    _qs, qfa, tfa = _fixture(tmp_path, n_q=1, n_t=1)
    argv = {
        "no_r": ["--many2many", tfa],
        "no_targets": ["--many2many", "-r", qfa],
        "two_targets": ["--many2many", tfa, tfa, "-r", qfa],
        "band_x": ["--many2many", tfa, "-r", qfa, "--band=x"],
        "band_0": ["--many2many", tfa, "-r", qfa, "--band=0"],
        "w": ["--many2many", tfa, "-r", qfa, "-w", "x.mfa"],
        "realign": ["--many2many", tfa, "-r", qfa, "--realign"],
        "missing_fasta": ["--many2many", str(tmp_path / "absent.fa"),
                          "-r", qfa, "-o", "OUT.tsv"],
    }[case] + ["--device=cpu"]
    want, got = _both(tmp_path, argv)
    assert got[0] == want[0] == 1
    last = got[2].strip().splitlines()[-1]
    assert last == want[2].strip().splitlines()[-1]
    assert last.startswith("Error:")
    assert not got[3] and not got[1]


def test_device_tpu_rejected(tmp_path):
    _qs, qfa, tfa = _fixture(tmp_path, n_q=1, n_t=1)
    err = io.StringIO()
    assert run(["--many2many", tfa, "-r", qfa, "--device=tpu"],
               stderr=err) == 1
    assert err.getvalue().strip().endswith(
        "Error: invalid --device value: tpu")
    assert "--device=cuda|cpu" in err.getvalue()


@pytest.mark.parametrize("flag,slice_", [
    ("--stats=s.json", "A4"), ("--deadline-s=5", "A4"),
    ("--max-retries=2", "A4"), ("--fallback=cpu", "A4"),
    ("--result-cache=rc", "A6"), ("--result-cache-max-bytes=100", "A6"),
    ("--compile-cache-dir=cc", "A6")])
def test_later_slice_flags_exit_1_naming_the_slice(tmp_path, flag, slice_):
    _qs, qfa, tfa = _fixture(tmp_path, n_q=1, n_t=1)
    err = io.StringIO()
    out = str(tmp_path / "o.tsv")
    assert run(["--many2many", tfa, "-r", qfa, "-o", out, flag,
                "--device=cpu"], stderr=err) == 1
    name = flag[2:].split("=")[0]
    assert err.getvalue().startswith(f"Error: --{name} is not ported")
    assert slice_ in err.getvalue()
    assert not os.path.exists(out)


def test_band_1_long_target_is_a_clean_error(tmp_path):
    """A target longer than its query at --band=1 has no band placement:
    the reference raises out of its CLI (a traceback, exit 1), the port
    exits 1 with the same message."""
    _qs, qfa, tfa = _fixture(tmp_path)
    args = ["--many2many", tfa, "-r", qfa, "--device=cpu"]
    with pytest.raises(ValueError, match="too narrow") as want:
        ref_run(args + ["--band=1"], stdout=io.StringIO(),
                stderr=io.StringIO())
    err = io.StringIO()
    assert run(args + ["--band=1"], stdout=io.StringIO(), stderr=err) == 1
    assert err.getvalue() == f"Error: {want.value}\n"


def test_cuda_without_a_card_exits_1(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _qs, qfa, tfa = _fixture(tmp_path, n_q=1, n_t=1)
    err = io.StringIO()
    assert run(["--many2many", tfa, "-r", qfa], stderr=err) == 1
    assert "no CUDA device" in err.getvalue()


def test_many2many_imports_neither_jax_nor_the_reference(tmp_path):
    _qs, qfa, tfa = _fixture(tmp_path, n_q=2, n_t=3)
    argv = ["--many2many", tfa, "-r", qfa, "-o", str(tmp_path / "o.tsv"),
            "--device=cpu"]
    code = (
        "import sys\n"
        "from pwasm_tpu_torch.cli import run\n"
        f"assert run({argv!r}) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'pwasm_tpu' or m.startswith('pwasm_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
