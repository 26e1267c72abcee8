"""The port's CLI (``pwasm_tpu_torch.cli``) on the CPU against the JAX
package: the committed golden outputs, byte parity with
``pwasm_tpu.cli --device=cpu`` on a realistic-style corpus, the exit-code
contract, and the refusal of what later slices bring."""

import io
import pathlib
import shutil

import pytest
import torch

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu_torch.align.gapseq import GapSeq
from pwasm_tpu_torch.align.msa import Msa
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.core.errors import ZeroCoverageError
from pwasm_tpu_torch.native import NativeMsa

from test_realistic_scale import make_corpus

GOLDEN = pathlib.Path(__file__).parent / "golden"

OUTPUTS = ("report.dfa", "summary.txt", "msa.mfa", "contig.ace",
           "contig.info", "cons.fa")


def _out_args(d, tag):
    p = str(d / tag)
    return ["-o", f"{p}.report.dfa", "-s", f"{p}.summary.txt",
            "-w", f"{p}.msa.mfa", f"--ace={p}.contig.ace",
            f"--info={p}.contig.info", f"--cons={p}.cons.fa"]


def _read(d, tag):
    return {n: (d / f"{tag}.{n}").read_bytes() for n in OUTPUTS}


def _golden_inputs(tmp_path):
    for name in ("in.paf", "q.fa"):
        shutil.copy(GOLDEN / name, tmp_path / name)
    return str(tmp_path / "in.paf"), str(tmp_path / "q.fa")


def test_golden_outputs_byte_identical(tmp_path):
    paf, fa = _golden_inputs(tmp_path)
    err = io.StringIO()
    rc = run([paf, "-r", fa, *_out_args(tmp_path, "port"),
              "--device=cpu"], stderr=err)
    assert rc == 0, err.getvalue()
    got = _read(tmp_path, "port")
    for name in OUTPUTS:
        assert got[name] == (GOLDEN / name).read_bytes(), name


@pytest.mark.parametrize("extra", [
    [], ["--batch=5"], ["-N"], ["--remove-cons-gaps", "--no-refine-clip"],
    ["--motifs=MOTIFS"], ["-F"]])
def test_corpus_byte_parity_with_reference(tmp_path, extra):
    q, lines = make_corpus(n_aln=12)
    fa = tmp_path / "cds.fa"
    fa.write_text(f">cds1\n{q}\n")
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    (tmp_path / "motifs.txt").write_text("# test table\nGATC\nacgt\nTTA\n")
    extra = [a.replace("MOTIFS", str(tmp_path / "motifs.txt"))
             for a in extra]
    names = OUTPUTS[:2] if "-F" in extra else OUTPUTS   # -F: no MSA

    def outs(tag):
        return _out_args(tmp_path, tag)[:2 * len(names)]

    base = [str(paf), "-r", str(fa), *extra]
    err = io.StringIO()
    assert ref_run(base + outs("ref") + ["--device=cpu"],
                   stderr=err) == 0, err.getvalue()
    stats = {}
    assert run(base + outs("port") + ["--device=cpu"],
               stderr=err, stats=stats) == 0, err.getvalue()
    for n in names:
        assert (tmp_path / f"port.{n}").read_bytes() \
            == (tmp_path / f"ref.{n}").read_bytes(), n
    assert stats["alignments"] == 12 and stats["device"] == "cpu"
    assert set(stats["times"]) == {"parse_extract", "ctx_scan",
                                   "msa_merge", "consensus", "refine",
                                   "write"}
    if "-F" not in extra:
        assert stats["pileup"][0] == 13      # 12 members + the query


def test_zero_coverage_column_exits_5(tmp_path, monkeypatch):
    # a layout with an uncovered column raises exit 5
    msa = Msa(GapSeq("a", "", b"AC", offset=0),
              GapSeq("b", "", b"GT", offset=4))
    with pytest.raises(ZeroCoverageError) as ei:
        msa.refine_msa(torch.device("cpu"), remove_cons_gaps=False,
                       refine_clipping=False)
    assert ei.value.exit_code == 5
    # ...and the CLI turns it into its exit code, from the C++ engine's
    # refinement and from the Python engine's

    def uncovered(self, *a, **kw):
        raise ZeroCoverageError("zero-coverage column 3\n")

    monkeypatch.setattr(NativeMsa, "refine_external", uncovered)
    monkeypatch.setattr(Msa, "refine_msa", uncovered)
    paf, fa = _golden_inputs(tmp_path)
    for python_msa in (False, True):
        if python_msa:
            monkeypatch.setenv("PWASM_NATIVE_MSA", "0")
        err = io.StringIO()
        assert run([paf, "-r", fa, f"--cons={tmp_path / 'c.fa'}",
                    "--device=cpu"], stderr=err) == 5
        assert "zero-coverage" in err.getvalue()


def test_cuda_request_without_cuda_exits_1(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paf, fa = _golden_inputs(tmp_path)
    report = tmp_path / "r.dfa"
    for argv in ([paf, "-r", fa, "-o", str(report), "--device=cuda"],
                 [paf, "-r", fa, "-o", str(report)]):     # cuda default
        err = io.StringIO()
        assert run(argv, stderr=err) == 1
        assert "--device=cpu" in err.getvalue()
        assert not report.exists()       # nothing ran on the CPU


@pytest.mark.parametrize("flag,later", [
    ("--compile-cache-dir=DIR", None),
    ("--m2m-stream", "-w builds an MSA and does not apply"),
    ("--result-cache-max-bytes=1", None),
    ("--result-cache=DIR", None),
    ("--follow=0.2 --result-cache=DIR", None),
    ("--device=tpu", "cuda or cpu")])
def test_later_slices_are_refused(tmp_path, monkeypatch, flag, later):
    """An option the run refuses exits 1 saying why (``--m2m-stream``, a
    job type of its own, takes no MSA output; ``route --standby-of``
    beside ``--socket``, and ``route --scale-policy`` without
    ``--backends``, are refused as the reference refuses them); the
    result cache and the build directory, which an earlier slice
    refused, run (``later`` None) to the flagless outputs."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    paf, fa = _golden_inputs(tmp_path)
    err = io.StringIO()
    dev = [] if flag.startswith("--device") else ["--device=cpu"]
    flags = flag.replace("DIR", str(tmp_path / "dir")).split()
    rc = run([paf, "-r", fa, "-w", str(tmp_path / "m.mfa"), *flags, *dev],
             stderr=err)
    if later is None:
        assert rc == 0, err.getvalue()
        assert run([paf, "-r", fa, "-w", str(tmp_path / "n.mfa"), *dev],
                   stdout=io.StringIO(), stderr=io.StringIO()) == 0
        assert (tmp_path / "m.mfa").read_bytes() \
            == (tmp_path / "n.mfa").read_bytes()
    else:
        assert rc == 1
        assert later in err.getvalue()
    for route_flag, says in (
            ("--standby-of=x.sock", "Error: --standby-of and "
             "--socket/--listen are mutually exclusive"),
            ("--scale-policy=p.json", "Error: --backends=TARGET"
             "[,TARGET...] is required")):
        err = io.StringIO()
        assert run(["route", "--socket=x", route_flag], stderr=err) == 1
        assert says in err.getvalue()


def test_usage_and_parse_exit_codes(tmp_path):
    paf, fa = _golden_inputs(tmp_path)
    assert run([paf, "-r", fa, "-G", "-F", "--device=cpu"],
               stderr=io.StringIO()) == 1
    bad = tmp_path / "bad.paf"
    bad.write_text("q\t37\t0\n")
    err = io.StringIO()
    rc_port = run([str(bad), "-r", fa, "--device=cpu"], stderr=err)
    rc_ref = ref_run([str(bad), "-r", fa], stderr=io.StringIO())
    assert rc_port == rc_ref != 0
