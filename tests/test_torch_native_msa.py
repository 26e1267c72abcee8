"""The port's CLI on its C++ engine against the JAX package's CLI, both
with ``--device=cpu``: all six outputs and stderr byte for byte on
seeded random corpora (one and two queries, both strands), with the
engine and with the Python engines (``PWASM_NATIVE_MSA=0`` on both
sides), on corpora of the benchmark's shape and on corpora aimed at the
edges of the merge's one pass a member, and the partial report of the
fatal "invalid gap position" path.  Then the merge's counters in
``--stats``."""

import io
import json
import re

import numpy as np
import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu_torch import corpus as port_corpus
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.core.dna import revcomp

from helpers import make_paf_line
from test_events import _random_ops

OUTPUTS = ("dfa", "txt", "mfa", "ace", "info", "cons")
RUN_LINE = re.compile(r" in [0-9.]+s \(\d+ bases/s\)$", re.M)


def _corpus(tmp_path, seed: int, n_queries: int, n_per_query: int,
            bad_at: int | None = None):
    """A FASTA of ``n_queries`` CDS and a PAF of ``n_per_query`` random
    alignments to each, both strands, with one duplicate pair; with
    ``bad_at``, a reverse alignment starting with a deletion (a gap the
    MSA layout cannot hold) at that line."""
    rng = np.random.default_rng(seed)
    queries = {f"cds{k}": "".join(rng.choice(list("ACGT"),
                                             size=int(rng.integers(250, 420))))
               for k in range(n_queries)}
    lines = []
    for qid, q in queries.items():
        for i in range(n_per_query):
            strand = "+-"[int(rng.integers(0, 2))]
            q_start = int(rng.integers(0, 12))
            q_end = len(q) - int(rng.integers(0, 12))
            if strand == "-":
                q_aln = revcomp(q.encode()).decode()[len(q) - q_end:
                                                     len(q) - q_start]
            else:
                q_aln = q[q_start:q_end]
            line, _ = make_paf_line(qid, q, f"{qid}_t{i}", strand,
                                    _random_ops(rng, q_aln),
                                    q_start=q_start, q_end=q_end)
            lines.append(line)
    lines.insert(4, lines[2])      # a duplicate pair: warned and ignored
    if bad_at is not None:
        qid, q = next(iter(queries.items()))
        bad, _ = make_paf_line(qid, q, "tbad", "-",
                               [("del", 2), ("=", len(q) - 2)])
        lines.insert(bad_at, bad)
    fa = tmp_path / "cds.fa"
    fa.write_text("".join(f">{k}\n" + "".join(
        v[i:i + 60] + "\n" for i in range(0, len(v), 60))
        for k, v in queries.items()))
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa)


def _run_both(tmp_path, capsys, paf, fa, extra):
    """Run the reference and the port on the same inputs; returns
    {tag: (rc, stderr, {output: bytes})}."""
    got = {}
    for tag, fn in (("ref", ref_run), ("port", run)):
        p = str(tmp_path / tag)
        argv = [paf, "-r", fa, "-o", f"{p}.dfa", "-s", f"{p}.txt",
                "-w", f"{p}.mfa", f"--ace={p}.ace", f"--info={p}.info",
                f"--cons={p}.cons", *extra, "--device=cpu"]
        capsys.readouterr()
        err = io.StringIO()
        rc = fn(argv, stdout=io.StringIO(), stderr=err)
        text = RUN_LINE.sub(" in Ws (R bases/s)",
                            capsys.readouterr().err + err.getvalue())
        got[tag] = (rc, text, {n: (tmp_path / f"{tag}.{n}").read_bytes()
                               for n in OUTPUTS})
    return got


CASES = [("one", []), ("one", ["--batch=1"]), ("two", []),
         ("two", ["-D"]), ("two", ["--remove-cons-gaps"]),
         ("two", ["--no-refine-clip"]), ("two", ["--realign"]),
         ("two", ["--batch=1"]), ("two", ["--batch=3"]),
         ("two", ["--batch=64"])]


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("corpus,extra", CASES)
def test_cli_outputs_and_stderr_equal_reference(tmp_path, capsys,
                                                monkeypatch, engine,
                                                corpus, extra):
    if engine == "python":
        monkeypatch.setenv("PWASM_NATIVE_MSA", "0")
    paf, fa = _corpus(tmp_path, seed=len(corpus) * 7 + len(extra),
                      n_queries=1 if corpus == "one" else 2,
                      n_per_query=24 if corpus == "one" else 14)
    got = _run_both(tmp_path, capsys, paf, fa, extra)
    assert got["port"][0] == got["ref"][0] == 0, got["port"][1]
    assert got["port"][1] == got["ref"][1]
    for n in OUTPUTS:
        assert got["port"][2][n] == got["ref"][2][n], n
    assert got["port"][2]["cons"].count(b">") == 1
    assert "already seen" in got["port"][1]


def _write_inputs(tmp_path, q: str, lines) -> tuple[str, str]:
    fa = tmp_path / "cds.fa"
    fa.write_text(f">cds1\n{q}\n")
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa)


def _assert_same(got) -> None:
    assert got["port"][0] == got["ref"][0] == 0, got["port"][1]
    assert got["port"][1] == got["ref"][1]
    for n in OUTPUTS:
        assert got["port"][2][n] == got["ref"][2][n], n


@pytest.mark.parametrize("seed,n_aln,extra", [
    (20261018, 48, []), (20261019, 64, []), (20261020, 56, ["--realign"])])
def test_cell_shaped_corpus_equals_reference(tmp_path, capsys, seed, n_aln,
                                             extra):
    """The benchmark's job shape, cut in depth: a 1,500-base CDS, full
    alignments on both strands, 3-8% noise with indels up to 24 bases
    (``corpus.make_corpus``, the benchmark generator's copy)."""
    q, lines = port_corpus.make_corpus(seed=seed, n_aln=n_aln)
    assert len(q) == 1500
    assert {ln.split("\t")[4] for ln in lines} == {"+", "-"}
    paf, fa = _write_inputs(tmp_path, q, lines)
    _assert_same(_run_both(tmp_path, capsys, paf, fa, extra))


def _edge_ops(q_start: int, q_end: int, strand: str, events):
    """Alignment ops over the query's [q_start, q_end) with ``events`` in
    forward query coordinates: ("ins", p, n) puts n target-only bases
    before query base p, ("del", p, n) drops query bases p..p+n-1."""
    at = {}
    for kind, p, n in events:
        i = p - q_start if strand == "+" else \
            q_end - (p + n if kind == "del" else p)
        at[i] = (kind, n)
    ops, done = [], 0
    for i in sorted(at):
        if i > done:
            ops.append(("=", i - done))
        kind, n = at[i]
        ops.append(("ins", "acgt"[i % 4] * n) if kind == "ins"
                   else ("del", n))
        done = i + n if kind == "del" else i
    if q_end - q_start > done:
        ops.append(("=", q_end - q_start - done))
    return ops


# each corpus: (q_start, q_end, events) an alignment, merged in order;
# L is the query's last base
EDGES = {
    # a gap column at layout position 0: the seed's member, at offset 0,
    # shifts instead of taking a gap; then one the incoming side takes
    "gap_at_0": [(0, None, []), (0, None, [("ins", 0, 2)]),
                 (0, None, [("ins", 0, 1), ("ins", 5, 1)])],
    # a gap before the last base, and a member ending just before it
    "gap_at_last": [(0, None, []), (0, None, [("ins", "L", 3)]),
                    (0, "L", []),
                    (0, None, [("ins", "L", 1), ("ins", 100, 2)])],
    # a member starting past the columns: shifted once, again when a
    # column lands exactly at its offset, then taking a gap
    "starts_past": [(0, None, []), (150, None, []),
                    (0, None, [("ins", 40, 2), ("ins", 150, 1),
                               ("ins", 200, 2)])],
    # a member ending before the later columns: left alone by them
    "ends_before": [(0, None, []), (0, 100, []),
                    (0, None, [("ins", 50, 1), ("ins", 100, 2),
                               ("ins", 180, 2)])],
    # two columns inside one member's gap run land before the same base
    "same_base": [(0, None, []), (0, None, [("del", 120, 10)]),
                  (0, None, [("ins", 123, 1), ("ins", 126, 2)])],
}


@pytest.mark.parametrize("strand", ["+", "-"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_merge_edge_corpus_equals_reference(tmp_path, capsys, edge, strand):
    rng = np.random.default_rng(len(edge))
    q = "".join(rng.choice(list("ACGT"), size=240))
    last = len(q) - 1
    lines = []
    for k, (qs, qe, events) in enumerate(EDGES[edge]):
        qe = len(q) if qe is None else last if qe == "L" else qe
        events = [(kind, last if p == "L" else p, n)
                  for kind, p, n in events]
        lines.append(make_paf_line(
            "cds1", q, f"t{k}", strand,
            _edge_ops(qs, qe, strand, events),
            q_start=qs, q_end=qe)[0])
    paf, fa = _write_inputs(tmp_path, q, lines)
    got = _run_both(tmp_path, capsys, paf, fa, [])
    _assert_same(got)
    # every alignment reached the layout
    assert got["port"][2]["mfa"].count(b">") == len(lines) + 1


def test_merge_counters_in_stats(tmp_path, monkeypatch):
    """``stages.msa_merge`` of ``--stats`` carries the engine's gap
    columns and member bases walked.  On a 200-alignment job the walk
    stays within one pass over every member of both sides of every
    merge, and is over ten times shorter than the one walk a gap column
    of the Python engine (``Msa.inject_gap``, the algorithm the engine
    had), counted over the same job."""
    from pwasm_tpu_torch.align import gapseq, msa

    q, lines = port_corpus.make_corpus(seed=7, n_aln=200)
    paf, fa = _write_inputs(tmp_path, q, lines)

    def run_stats(tag):
        st = tmp_path / f"{tag}.json"
        assert run([paf, "-r", fa, "-o", str(tmp_path / f"{tag}.dfa"),
                    f"--cons={tmp_path / tag}.fa", "--device=cpu",
                    f"--stats={st}"], stderr=io.StringIO()) == 0
        return json.loads(st.read_text())["stages"]["msa_merge"]

    row = run_stats("native")
    assert row["items"] == 200
    monkeypatch.setenv("PWASM_NATIVE_MSA", "0")
    walk = {"inject": 0, "seq": 0, "bound": 0, "cols": 0}
    real_inject, real_add = msa.Msa.inject_gap, msa.Msa.add_align
    real_walk = gapseq.GapSeq.find_walk_pos

    def inject_gap(self, seq, pos, xgap):
        walk["cols"] += 1
        walk["seq"] += pos + 1            # the layout position's sum
        walk["inject"] += 1
        try:
            return real_inject(self, seq, pos, xgap)
        finally:
            walk["inject"] -= 1

    def find_walk_pos(self, alpos):
        j = real_walk(self, alpos)
        if walk["inject"]:                # the linear walk to base j
            walk["seq"] += min(j + 1, self.seqlen)
        return j

    def add_align(self, seq, omsa, oseq):
        walk["bound"] += sum(s.seqlen + 1 for s in self.seqs + omsa.seqs)
        return real_add(self, seq, omsa, oseq)

    monkeypatch.setattr(msa.Msa, "inject_gap", inject_gap)
    monkeypatch.setattr(msa.Msa, "add_align", add_align)
    monkeypatch.setattr(gapseq.GapSeq, "find_walk_pos", find_walk_pos)
    run_stats("python")
    assert (tmp_path / "native.fa").read_bytes() \
        == (tmp_path / "python.fa").read_bytes()
    assert row["msa_gap_cols"] == walk["cols"] > 0
    assert 0 < row["msa_member_steps"] <= walk["bound"]
    assert row["msa_member_steps"] * 10 <= walk["seq"]


def test_cli_stage_seconds_on_the_engine(tmp_path):
    paf, fa = _corpus(tmp_path, seed=3, n_queries=2, n_per_query=10)
    stats = {}
    assert run([paf, "-r", fa, f"--cons={tmp_path / 'c.fa'}",
                "--device=cpu"], stderr=io.StringIO(), stats=stats) == 0
    assert set(stats["times"]) == {"parse_extract", "ctx_scan",
                                   "msa_merge", "consensus", "refine",
                                   "write"}
    # the last query's MSA: its members and the query
    assert stats["pileup"][0] == 11 and stats["alignments"] == 20


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("batch", [[], ["--batch=3"], ["--batch=64"]])
def test_fatal_gap_partial_report_equals_reference(tmp_path, capsys,
                                                   monkeypatch, engine,
                                                   batch):
    if engine == "python":
        monkeypatch.setenv("PWASM_NATIVE_MSA", "0")
    paf, fa = _corpus(tmp_path, seed=11, n_queries=2, n_per_query=12,
                      bad_at=7)
    got = _run_both(tmp_path, capsys, paf, fa, batch)
    assert got["port"][0] == got["ref"][0] == 1
    assert "invalid gap position" in got["port"][1]
    assert got["port"][1] == got["ref"][1]
    for n in OUTPUTS:
        assert got["port"][2][n] == got["ref"][2][n], n
    assert got["port"][2]["dfa"].count(b">") >= 7


def _engine(paf: str, fa: str):
    """The corpus's first query merged in a fresh engine, as the CLI
    merges it (gene mode: a pair's first alignment only)."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.core.fasta import FastaFile
    from pwasm_tpu_torch.core.paf import parse_paf_line

    q = FastaFile(fa).fetch("cds0").upper()
    nmsa = native.native_msa()
    items, seen = [], set()
    for line in open(paf):
        rec = parse_paf_line(line.rstrip("\n"))
        al = rec.alninfo
        if al.r_id != "cds0" or al.t_id in seen:
            continue
        seen.add(al.t_id)
        aln = native.extract_native(rec, revcomp(q) if al.reverse else q)
        items.append((f"{al.t_id}:{al.t_alnstart}-{al.t_alnend}"
                      + ("-" if al.reverse else "+"), aln.tseq,
                      al.r_alnstart, aln.reverse, aln.rgaps, aln.tgaps,
                      len(items) + 1))

    def fatal(_idx, msg):
        raise AssertionError(msg)

    nmsa.add_batch("cds0", q, len(q), items, fatal)
    return nmsa


@pytest.mark.parametrize("remove_cons_gaps,refine_clipping",
                         [(False, True), (True, True), (True, False)])
def test_refine_external_with_plain_votes_equals_engine_refine(
        tmp_path, remove_cons_gaps, refine_clipping):
    """The engine's rendered pileup, counted and voted by the consensus
    launch's plain version on the CPU (zero coverage as char 0) and
    applied with ``refine_external``, finishes the consensus exactly as
    the engine's own host ``refine``."""
    import torch

    from pwasm_tpu_torch.align.msa import device_counts_votes

    paf, fa = _corpus(tmp_path, seed=5, n_queries=1, n_per_query=30)
    flags = (remove_cons_gaps, refine_clipping)
    written = {}
    for way in ("refine", "external"):
        nmsa = _engine(paf, fa)
        if way == "refine":
            nmsa.refine(*flags)
        else:
            nmsa.prepare_device()
            pile = np.empty(nmsa.dims(), dtype=np.int8)
            nmsa.render_pileup(pile)
            assert set(np.unique(pile)) <= set(range(7))
            chars, counts = device_counts_votes(pile, torch.device("cpu"))
            nmsa.refine_external(counts, chars, *flags)
        contig = nmsa.contig()
        for kind in ("ace", "info", "cons"):
            path = str(tmp_path / f"{way}.{kind}")
            nmsa.write(kind, path, contig, *flags)
            written[way, kind] = open(path, "rb").read()
        nmsa.close()
    for kind in ("ace", "info", "cons"):
        assert written["refine", kind] == written["external", kind], kind
        assert written["refine", kind]


def test_engine_pileup_is_the_python_engine_pileup(tmp_path, monkeypatch):
    """The pileup the engine renders for the consensus launch equals the
    one the Python engine builds (``Msa.pileup_matrix``)."""
    from pwasm_tpu_torch.align import msa

    paf, fa = _corpus(tmp_path, seed=9, n_queries=1, n_per_query=25)
    piles = []
    real = msa.device_counts_votes

    def recording(pile, device):
        piles.append(np.array(pile, copy=True))
        return real(pile, device)

    monkeypatch.setattr(msa, "device_counts_votes", recording)
    for env in ("1", "0"):
        monkeypatch.setenv("PWASM_NATIVE_MSA", env)
        assert run([paf, "-r", fa, f"--cons={tmp_path / env}.fa",
                    "--device=cpu"], stderr=io.StringIO()) == 0
    assert len(piles) == 2 and piles[0].shape[0] == 26   # 25 + the query
    np.testing.assert_array_equal(piles[0], piles[1])
    assert (tmp_path / "1.fa").read_bytes() == (tmp_path / "0.fa").read_bytes()
