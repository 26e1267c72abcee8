"""The ``-v`` / ``-D`` stderr of the port's CLI against the JAX package's,
both with ``--device=cpu``: every line but the last byte for byte (the
``--many2many`` header included), and the last line the reference's run
line, ``N alignments, E events, B aligned bases in Ws (R bases/s)``,
with the reference's three counts (the wall and the rate differ from run
to run)."""

import io
import re
import shutil

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.corpus import make_corpus, make_m2m_corpus

from test_torch_cli import GOLDEN
from test_torch_cli_m2m import _fixture

RUN_LINE = re.compile(r"^(\d+) alignments, (\d+) events, (\d+) aligned "
                      r"bases in [0-9.]+s \(\d+ bases/s\)$")


def _stderr(fn, argv):
    err = io.StringIO()
    rc = fn(argv, stdout=io.StringIO(), stderr=err)
    assert rc == 0, err.getvalue()
    return err.getvalue().splitlines()


def _compare(tmp_path, args):
    """Run the reference and the port on ``args`` ("OUT" stands for a
    per-package output prefix); returns the three counts of the port's
    run line, after checking them and every other line against the
    reference's."""
    got = {}
    for tag, fn in (("ref", ref_run), ("port", run)):
        got[tag] = _stderr(fn, [a.replace("OUT", str(tmp_path / tag))
                                for a in args])
    want, mine = got["ref"], got["port"]
    assert mine[:-1] == want[:-1]
    m_ref, m_port = RUN_LINE.match(want[-1]), RUN_LINE.match(mine[-1])
    assert m_ref, want[-1]
    assert m_port, mine[-1]
    assert m_port.groups() == m_ref.groups()
    return tuple(int(x) for x in m_port.groups())


def _golden(tmp_path):
    for name in ("in.paf", "q.fa"):
        shutil.copy(GOLDEN / name, tmp_path / name)
    return str(tmp_path / "in.paf"), str(tmp_path / "q.fa")


@pytest.mark.parametrize("flag", ["-v", "-D"])
def test_golden_run_line(tmp_path, flag):
    paf, fa = _golden(tmp_path)
    counts = _compare(tmp_path, [paf, "-r", fa, "-o", "OUT.dfa",
                                 "-w", "OUT.mfa", flag, "--device=cpu"])
    assert counts == (5, 5, 185)


@pytest.mark.parametrize("extra", [[], ["--realign"], ["-F"]])
def test_corpus_run_line(tmp_path, extra):
    q, lines = make_corpus(n_aln=10)
    fa = tmp_path / "cds.fa"
    paf = tmp_path / "in.paf"
    fa.write_text(f">cds1\n{q}\n")
    paf.write_text("".join(ln + "\n" for ln in lines))
    outs = [] if "-F" in extra else ["-w", "OUT.mfa"]
    n_aln, n_ev, bases = _compare(
        tmp_path, [str(paf), "-r", str(fa), "-o", "OUT.dfa", *outs, "-v",
                   "--device=cpu", *extra])
    assert n_aln == 10 and n_ev > 0 and bases > 0


def test_no_run_line_without_verbose(tmp_path):
    paf, fa = _golden(tmp_path)
    err = _stderr(run, [paf, "-r", fa, "-o", str(tmp_path / "r.dfa"),
                        "--device=cpu"])
    assert not any(RUN_LINE.match(ln) for ln in err)


@pytest.mark.parametrize("band", [16, 64])
def test_many2many_header_and_run_line(tmp_path, band):
    qs, qfa, tfa = _fixture(tmp_path)
    counts = _compare(tmp_path, ["--many2many", tfa, "-r", qfa,
                                 "-o", "OUT.tsv", f"--band={band}", "-v",
                                 "--device=cpu"])
    got = _stderr(run, ["--many2many", tfa, "-r", qfa, "-o",
                        str(tmp_path / "again.tsv"), f"--band={band}",
                        "-v", "--device=cpu"])
    assert got[0] == f"many2many: 24 of 24 pair(s), band {band}, one cpu " \
        "session"
    t_bases = sum(150 + 17 * i for i in range(6))
    assert counts == (24, 0, t_bases * len(qs))


def test_many2many_corpus_run_line_with_debug(tmp_path):
    qfa, tfa = make_m2m_corpus(n_q=3, n_t=5, out_dir=str(tmp_path))
    n_aln, n_ev, _bases = _compare(
        tmp_path, ["--many2many", tfa, "-r", qfa, "-o", "OUT.tsv", "-D",
                   "--device=cpu"])
    assert (n_aln, n_ev) == (15, 0)
