"""``pafreport --realign`` through the port's CLI on the CPU against the
JAX package's CLI: byte parity of all six outputs on the inputs of
``tests/test_cli_realign.py`` and on a 24-alignment realistic corpus,
and the same exit codes and messages on the error paths."""

import io

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.core.errors import PwasmError
from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu_torch.cli import run

from helpers import make_paf_line
from test_realistic_scale import make_corpus

OUTPUTS = ("report.dfa", "summary.txt", "msa.mfa", "contig.ace",
           "contig.info", "cons.fa")
Q = "ACGGTCCTGAACGGTTCCAATCGA"


def _out_args(d, tag):
    p = str(d / tag)
    return ["-o", f"{p}.report.dfa", "-s", f"{p}.summary.txt",
            "-w", f"{p}.msa.mfa", f"--ace={p}.contig.ace",
            f"--info={p}.contig.info", f"--cons={p}.cons.fa"]


def _inputs(tmp_path, case):
    """(paf, fasta, extra args) of one case of tests/test_cli_realign.py
    (or the corpus)."""
    seqs = [("q", Q)]
    extra = []
    if case == "suboptimal_gap":
        seqs = [("q", "AAACGGGG")]
        lines = [make_paf_line("q", "AAACGGGG", "t1", "+",
                               [("=", 3), ("*", "g", "c"), ("del", 1),
                                ("=", 3)])[0]]
    elif case == "optimal_fwd_rev":
        lines = [
            make_paf_line("q", Q, "a1", "+",
                          [("=", 6), ("ins", "TT"), ("=", 18)])[0],
            make_paf_line("q", Q, "a2", "-",
                          [("=", 10), ("del", 2), ("=", 12)])[0],
            make_paf_line("q", Q, "a3", "+", [("=", 24)])[0]]
    elif case == "two_queries":
        q2 = "TTGACCGGATACCAGTTGACAGGT"
        seqs = [("q1", Q), ("q2", q2)]
        lines = [
            make_paf_line("q1", Q, "a1", "+",
                          [("=", 6), ("ins", "TT"), ("=", 18)])[0],
            make_paf_line("q2", q2, "b1", "+",
                          [("=", 10), ("del", 2), ("=", 12)])[0],
            make_paf_line("q2", q2, "b2", "-", [("=", 24)])[0]]
    elif case == "band16_escalation":
        q = Q * 4
        seqs = [("q", q)]
        lines = [make_paf_line("q", q, "big", "+",
                               [("=", 48),
                                ("ins", "TTTTGGGGCCCCAAAA" * 8),
                                ("=", 48)])[0]]
        extra = ["--band=16"]
    elif case == "batch2":
        lines = [make_paf_line("q", Q, f"b{k}", "+",
                               [("=", 4 + k), ("ins", "GG"),
                                ("=", 20 - k)])[0] for k in range(5)]
        extra = ["--batch=2"]
    else:
        q, lines = make_corpus(n_aln=24)
        seqs = [("cds1", q)]
    fa = tmp_path / "q.fa"
    write_fasta(str(fa), [(n, s.encode()) for n, s in seqs])
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa), extra


@pytest.mark.parametrize("case", [
    "suboptimal_gap", "optimal_fwd_rev", "two_queries", "band16_escalation",
    "batch2", "corpus24"])
def test_realign_outputs_byte_identical(tmp_path, case):
    paf, fa, extra = _inputs(tmp_path, case)
    base = [paf, "-r", fa, "--realign", "--device=cpu", *extra]
    err = io.StringIO()
    assert ref_run(base + _out_args(tmp_path, "ref"),
                   stderr=err) == 0, err.getvalue()
    stats = {}
    assert run(base + _out_args(tmp_path, "port"), stderr=err,
               stats=stats) == 0, err.getvalue()
    for name in OUTPUTS:
        assert (tmp_path / f"port.{name}").read_bytes() \
            == (tmp_path / f"ref.{name}").read_bytes(), name
    # every alignment was re-aligned, and the stage was timed
    assert stats["realigned"] == stats["alignments"]
    assert stats["times"]["realign"] > 0
    if case == "suboptimal_gap":
        assert (tmp_path / "port.msa.mfa").read_text() == (
            ">q\nAAACGGGG\n>t1:0-7+\nAAA-gGGG\n")


def test_realign_on_cuda_without_cuda_exits_1(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paf, fa, _ = _inputs(tmp_path, "suboptimal_gap")
    mfa = tmp_path / "m.mfa"
    err = io.StringIO()
    assert run([paf, "-r", fa, "-w", str(mfa), "--realign",
                "--device=cuda"], stdout=io.StringIO(), stderr=err) == 1
    assert "--device=cpu" in err.getvalue() and not mfa.exists()


def _ref_outcome(argv):
    """(rc, message) of the reference CLI, which raises its usage
    errors where the port's ``run`` returns them."""
    err = io.StringIO()
    try:
        rc = ref_run(argv, stdout=io.StringIO(), stderr=err)
    except PwasmError as e:
        return e.exit_code, str(e)
    return rc, err.getvalue()


@pytest.mark.parametrize("flags,msg", [
    (["--realign"], "Error: --realign requires an MSA output "
                    "(-w, --ace, --info or --cons)!\n"),
    (["--realign", "-o", "R", "--band=0"], "Invalid --band value: 0\n"),
    (["--realign", "-w", "M", "--band=x"], "Invalid --band value: x\n"),
    (["-w", "M", "--band"], "Invalid --band value: True\n")])
def test_realign_usage_errors_match_reference(tmp_path, flags, msg):
    paf, fa, _ = _inputs(tmp_path, "suboptimal_gap")
    flags = [str(tmp_path / f) if f in ("R", "M") else f for f in flags]
    argv = [paf, "-r", fa, *flags, "--device=cpu"]
    rc_ref, msg_ref = _ref_outcome(argv)
    err = io.StringIO()
    rc = run(argv, stdout=io.StringIO(), stderr=err)
    assert rc == rc_ref == 1
    assert msg_ref.endswith(msg) and err.getvalue().endswith(msg)
