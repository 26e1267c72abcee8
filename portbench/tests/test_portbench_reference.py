"""The plain reference against the frozen generators' own answers and
against the port's CPU runs, at tiny sizes."""

import io
import os

import numpy as np
import pytest

from portbench import gen
from portbench.reference import m2m, pafreport
from portbench.reference.pw import banded
from portbench.reference.pw.events import extract_alignment
from portbench.reference.pw.paf import parse_paf_line


def test_cs_walk_rebuilds_the_generated_target():
    """``make_paf_line`` returns the target it wrote the cs string for;
    the reference's cs walk rebuilds the same target bases."""
    rng = np.random.default_rng(3)
    q = "".join("ACGT"[i] for i in rng.integers(0, 4, 90))
    for strand in "+-":
        qa = gen.revcomp(q.encode()).decode() if strand == "-" else q
        sub = "a" if qa[10] != "A" else "c"
        ops = [("=", 10), ("*", sub, qa[10].lower()), ("=", 20),
               ("ins", "gga"), ("=", 15), ("del", 4), ("=", 40)]
        line, tseq = gen.make_paf_line("q", q, "t", strand, ops)
        rec = parse_paf_line(line)
        qa = gen.revcomp(q.encode()) if strand == "-" else q.encode()
        aln = extract_alignment(rec, qa)
        assert bytes(aln.tseq).upper() == tseq.encode()


def test_corpus_is_a_function_of_its_seed():
    a = gen.make_corpus(seed=11, n_aln=5, cds_len=300, asm_lo=2000,
                        asm_hi=3000)
    b = gen.make_corpus(seed=11, n_aln=5, cds_len=300, asm_lo=2000,
                        asm_hi=3000)
    assert a == b


def _port_outputs(tmp_path, q, lines, flags):
    """The port's own CPU run (a test may run the port; the reference
    never imports it)."""
    from pwasm_tpu_torch.cli import run
    paf = tmp_path / "job.paf"
    paf.write_text("\n".join(lines) + "\n")
    fa = tmp_path / "cds.fa"
    fa.write_text(f">cds1\n{q}\n")
    outs = {"o": "r.dfa", "s": "s.txt", "w": "m.mfa", "ace": "a.ace",
            "info": "i.info", "cons": "c.fa"}
    argv = [str(paf), "-r", str(fa), "--device=cpu"] + flags
    for k, name in outs.items():
        p = str(tmp_path / name)
        argv += [f"--{k}={p}"] if len(k) > 1 else [f"-{k}", p]
    assert run(argv, stdout=io.StringIO(), stderr=io.StringIO()) == 0
    return {k: (tmp_path / n).read_bytes() for k, n in outs.items()}


@pytest.mark.parametrize("realign", [False, True])
def test_pafreport_reference_equals_the_port(tmp_path, realign):
    q, lines = gen.make_corpus(seed=5, n_aln=12, cds_len=240, asm_lo=2000,
                               asm_hi=4000)
    want = _port_outputs(tmp_path, q, lines,
                         ["--realign"] if realign else [])
    got = pafreport.pafreport(q.encode(), lines, pafreport.OUTPUTS,
                              realign=realign)
    for k in pafreport.OUTPUTS:
        assert got[k] == want[k], k


def test_m2m_reference_equals_the_port(tmp_path):
    import torch

    from pwasm_tpu_torch.parallel.many2many import many2many_scores_ragged
    qfa, tfa = gen.make_m2m_corpus(seed=9, n_q=4, n_t=25,
                                   out_dir=str(tmp_path))
    qs, ts = m2m.read_fasta(qfa), m2m.read_fasta(tfa)
    want = many2many_scores_ragged([s for _n, s in qs], [s for _n, s in ts],
                                   band=64, device=torch.device("cpu"))
    got = m2m.reference_scores(qs, ts, range(len(qs)), 64)
    for qi in range(len(qs)):
        assert np.array_equal(got[qi], want[qi])
    assert (want != banded.NEG).any()


def test_int16_planes_equal_int32_at_these_lengths(tmp_path):
    """16-bit score planes give the int32 reference's scores at the
    configuration's lengths, as its stated precision (exact integers
    that 16 bits hold) says; int8, the control, does not."""
    import torch
    qfa, tfa = gen.make_m2m_corpus(seed=4, n_q=2, n_t=12,
                                   out_dir=str(tmp_path))
    qs, ts = m2m.read_fasta(qfa), m2m.read_fasta(tfa)
    a = m2m.reference_scores(qs, ts, [0, 1], 64)
    b = m2m.reference_scores(qs, ts, [0, 1], 64, dtype=torch.int16)
    c = m2m.reference_scores(qs, ts, [0, 1], 64, dtype=torch.int8)
    assert all(np.array_equal(a[i], b[i]) for i in (0, 1))
    assert any(not np.array_equal(a[i], c[i]) for i in (0, 1))
