"""``--stats``, ``--skip-bad-lines`` and ``--profile`` of the port's CLI
against the JAX package's.

The port runs at ``--device=cpu``, where its device path runs as plain
torch on the CPU, so it counts the dispatches the reference counts at
``--device=tpu`` (on its JAX CPU backend, ``PWASM_DEVICE_PROBE=0``).
The input counters are held to the reference at ``--device=cpu``, the
device counters to the reference at ``--device=tpu``.  Walls differ.
Both count a checkpoint a report batch under ``resilience.checkpoints``.
"""

import io
import json
import os
import shutil

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu_torch import corpus
from pwasm_tpu_torch.cli import run

from helpers import make_paf_line
from test_cli import Q, _mk_inputs, _three_alignments

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT_KEYS = ("lines", "alignments", "skipped_bad_lines",
              "skipped_duplicates", "skipped_self", "resumed_past",
              "aligned_bases", "events", "realigned", "msa_dropped",
              "fallback_batches", "engine_fallbacks", "preempted")
DEVICE_KEYS = ("device_batches", "device_events", "scalar_events")
OUTS = ("dfa", "sum", "mfa", "ace", "info", "cons")


def _keys(d, pre=""):
    out = set()
    for k, v in d.items():
        out.add(pre + k)
        if isinstance(v, dict) and k != "by_site":
            out |= _keys(v, pre + k + ".")
    return out


def _golden(d):
    for name in ("in.paf", "q.fa"):
        shutil.copy(os.path.join(REPO, "tests", "golden", name), d)
    return str(d / "in.paf"), str(d / "q.fa"), []


def _corpus(d):
    """12 alignments of a 300-base CDS, with a duplicate pair and a self
    alignment among them, re-aligned in batches of 4."""
    q, lines = corpus.make_corpus(n_aln=12, cds_len=300, asm_lo=2000,
                                  asm_hi=5000)
    f = lines[0].split("\t")
    self_line = "\t".join(["cds1", *f[1:5], "cds1", *f[6:]])
    lines = lines[:5] + [lines[3], self_line] + lines[5:]
    (d / "q.fa").write_text(f">cds1\n{q}\n")
    (d / "in.paf").write_text("".join(ln + "\n" for ln in lines))
    return str(d / "in.paf"), str(d / "q.fa"), ["--realign", "-G",
                                                "--batch=4"]


CASES = {"golden": (_golden, {}),
         "corpus_realign_python_msa": (_corpus, {"PWASM_NATIVE_MSA": "0"})}


@pytest.fixture(scope="module")
def stats_runs(tmp_path_factory):
    """Each case through the port (cpu) and the reference (cpu, tpu),
    with all six outputs and ``--stats``: {case: {tag: (dir, stats,
    stderr)}}."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("PWASM_DEVICE_PROBE", "0")
        for case, (make, env) in CASES.items():
            d = tmp_path_factory.mktemp(case)
            paf, fa, extra = make(d)
            for k, v in env.items():
                mp.setenv(k, v)
            out[case] = {}
            for tag, runner, device in (("port", run, "cpu"),
                                        ("ref_cpu", ref_run, "cpu"),
                                        ("ref_tpu", ref_run, "tpu")):
                p = str(d / tag)
                err = io.StringIO()
                rc = runner([paf, "-r", fa, "-o", f"{p}.dfa",
                             "-s", f"{p}.sum", "-w", f"{p}.mfa",
                             f"--ace={p}.ace", f"--info={p}.info",
                             f"--cons={p}.cons", f"--device={device}",
                             f"--stats={p}.json", *extra], stderr=err)
                assert rc == 0, err.getvalue()[-2000:]
                out[case][tag] = (d, json.loads(
                    (d / f"{tag}.json").read_text()), err.getvalue())
            for k in env:
                mp.delenv(k)
    finally:
        mp.undo()
    return out


# the port's one block beyond the reference's schema: its stage table,
# written beside RunStats.as_dict() (an additive change, version 1)
PORT_ONLY = "stages"


@pytest.mark.parametrize("case", list(CASES))
def test_stats_schema_equals_the_reference(stats_runs, case):
    got = stats_runs[case]
    port = got["port"][1]
    for tag in ("ref_cpu", "ref_tpu"):
        assert set(port) - set(got[tag][1]) == {PORT_ONLY}
        assert _keys({k: v for k, v in port.items() if k != PORT_ONLY}) \
            == _keys(got[tag][1])
        assert port["stats_version"] == got[tag][1]["stats_version"] == 1


@pytest.mark.parametrize("case", list(CASES))
def test_input_counters_equal_the_reference(stats_runs, case):
    got = stats_runs[case]
    port, ref = got["port"][1], got["ref_cpu"][1]
    assert {k: port[k] for k in INPUT_KEYS} \
        == {k: ref[k] for k in INPUT_KEYS}
    assert port["alignments"] > 0
    d = got["port"][0]
    for ext in OUTS:
        assert (d / f"port.{ext}").read_bytes() \
            == (d / f"ref_cpu.{ext}").read_bytes(), ext


@pytest.mark.parametrize("case", list(CASES))
def test_device_counters_equal_the_reference_device_run(stats_runs, case):
    got = stats_runs[case]
    port, ref = got["port"][1], got["ref_tpu"][1]
    assert {k: port[k] for k in DEVICE_KEYS} \
        == {k: ref[k] for k in DEVICE_KEYS}
    for k in ("dispatches", "flushes", "by_site", "pad_items",
              "pad_slots"):
        assert port["device"][k] == ref["device"][k], k
    assert port["device"]["by_site"]["consensus"] == 1
    assert port["device_events"] + port["scalar_events"] == port["events"]
    if case.startswith("corpus"):
        assert port["realigned"] == port["alignments"]
        assert port["device"]["by_site"]["realign"] >= 1
        assert port["skipped_duplicates"] == port["skipped_self"] == 1


@pytest.mark.parametrize("case", list(CASES))
def test_later_slice_counters_stay_zero(stats_runs, case):
    """The ``resilience`` and ``backend`` blocks, live since the port's
    supervisor slice, equal the reference's at ``--device=tpu`` (a clean
    run: no retry or fault, one checkpoint a report batch; with
    ``PWASM_DEVICE_PROBE=0`` no probe, and the port's ``--device=cpu``
    never probes)."""
    port = stats_runs[case]["port"][1]
    ref = stats_runs[case]["ref_tpu"][1]
    assert port["backend"] == ref["backend"] \
        == {"probes": 0, "warm_hits": 0}
    assert port["resilience"] == ref["resilience"]
    res = dict(port["resilience"])
    assert res.pop("checkpoints") > 0
    assert set(res.values()) == {0}
    assert port["preempted"] is False
    dev = port["device"]
    assert dev["compile_s"] > 0 and dev["steady_s"] >= 0
    host = port["host"]
    assert set(host) == {"parse_s", "extract_s", "analyze_s", "format_s"}
    assert all(v >= 0 for v in host.values()) and host["parse_s"] > 0


def test_verbose_line_reads_the_stats(stats_runs):
    """-v's closing line (tests/test_torch_cli_verbose.py) reads the same
    counters as --stats."""
    d, st, _err = stats_runs["golden"]["port"]
    paf = str(d / "in.paf")
    err = io.StringIO()
    assert run([paf, "-r", str(d / "q.fa"), "-o", str(d / "v.dfa"),
                "--device=cpu", "-v"], stderr=err) == 0
    last = err.getvalue().splitlines()[-1]
    assert last.startswith(f"{st['alignments']} alignments, "
                           f"{st['events']} events, "
                           f"{st['aligned_bases']} aligned bases in ")


# ---------------------------------------------------------------------------
# --skip-bad-lines: the reference's three cases through both packages
# ---------------------------------------------------------------------------
def _skip_case(tmp_path, case):
    """(lines, argv tail without and with the flag) of the reference's
    tests/test_cli.py skip-bad-lines cases."""
    if case == "parse_and_extraction":
        lines = _three_alignments()
        lines.insert(1, "not\ta\tpaf\tline")
        l_badcs, _ = make_paf_line("q", Q, "asmX", "+", [("=", 10)])
        lines.insert(3, l_badcs.replace("cs:Z::10", "cs:Z::4*gc:5"))
        outs = ["-o"]
    elif case.startswith("out_of_layout"):
        good, _ = make_paf_line("q", Q, "t0", "+", [("=", 10)])
        bad, _ = make_paf_line("q", Q, "tBAD", "-", [("del", 2), ("=", 8)])
        redo, _ = make_paf_line("q", Q, "tBAD", "+", [("=", 10)])
        lines = [good, bad, redo]
        outs = ["-o", "-w"]
    else:                                   # dedup_not_poisoned
        good, _ = make_paf_line("q", Q, "asm1", "+",
                                [("=", 6), ("ins", "gg"), ("=", 4)])
        lines = [good.replace("cs:Z::6", "cs:Z::2*gc:3"), good]
        outs = ["-o"]
    return lines, outs


SKIP_CASES = ["parse_and_extraction", "out_of_layout_engine",
              "out_of_layout_python_msa", "dedup_not_poisoned"]


@pytest.mark.parametrize("case", SKIP_CASES)
def test_skip_bad_lines_matches_the_reference(tmp_path, monkeypatch, case):
    lines, outs = _skip_case(tmp_path, case)
    paf, fa = _mk_inputs(tmp_path, lines)
    if case.endswith("python_msa"):
        monkeypatch.setenv("PWASM_NATIVE_MSA", "0")
    got = {}
    for tag, runner in (("port", run), ("ref", ref_run)):
        for flag in ([], ["--skip-bad-lines"]):
            name = f"{tag}{len(flag)}"
            argv = [paf, "-r", fa, "--device=cpu",
                    f"--stats={tmp_path / name}.json", *flag]
            for o in outs:
                argv += [o, str(tmp_path / f"{name}{o}")]
            err = io.StringIO()
            rc = runner(argv, stderr=err)
            files = tuple((tmp_path / f"{name}{o}").read_bytes()
                          if (tmp_path / f"{name}{o}").exists() else None
                          for o in outs)
            st = tmp_path / f"{name}.json"
            stats = json.loads(st.read_text()) if st.exists() else None
            got[tag, len(flag)] = (rc, err.getvalue(), files, stats)
    for flag in (0, 1):
        port, ref = got["port", flag], got["ref", flag]
        assert port[:3] == ref[:3]
        if ref[3] is None:
            assert port[3] is None        # a failed run writes no stats
        else:
            assert {k: port[3][k] for k in INPUT_KEYS} \
                == {k: ref[3][k] for k in INPUT_KEYS}
    rc, err, _files, st = got["port", 1]
    assert rc == 0
    if case == "parse_and_extraction":
        assert got["port", 0][0] != 0
        assert err.count("skipping malformed PAF line") == 2
        assert st["skipped_bad_lines"] == 2 and st["alignments"] == 3
    elif case.startswith("out_of_layout"):
        assert got["port", 0][0] == 1
        assert "excluding alignment tBAD:0-8- from the MSA" in err
        assert st["msa_dropped"] == 1 and st["skipped_bad_lines"] == 0
        assert st["alignments"] == 3
    else:
        assert "already seen" not in err
        assert st["skipped_bad_lines"] == 1


# ---------------------------------------------------------------------------
# --many2many --stats
# ---------------------------------------------------------------------------
def _m2m_inputs(d, lens_t):
    import numpy as np
    rng = np.random.default_rng(5)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    (d / "q.fa").write_text(">qa\n" + seq(200) + "\n>qb\n" + seq(180)
                            + "\n")
    (d / "t.fa").write_text("".join(f">t{k}\n{seq(n)}\n"
                                    for k, n in enumerate(lens_t)))
    return str(d / "t.fa"), str(d / "q.fa")


@pytest.mark.parametrize("lens_t,same_groups", [
    ((170, 175, 180, 172), True),       # every group has in-band targets
    ((120, 175, 260, 400), False)])     # a group with none: not launched
def test_many2many_stats(tmp_path, lens_t, same_groups):
    tfa, qfa = _m2m_inputs(tmp_path, lens_t)
    got = {}
    for tag, runner in (("port", run), ("ref", ref_run)):
        err = io.StringIO()
        st: dict = {}
        kw = {"stats": st} if tag == "port" else {}
        assert runner(["--many2many", tfa, "-r", qfa, "--device=cpu",
                       "-o", str(tmp_path / f"{tag}.tsv"),
                       f"--stats={tmp_path / tag}.json"], stderr=err,
                      **kw) == 0, err.getvalue()
        got[tag] = (json.loads((tmp_path / f"{tag}.json").read_text()), st)
    port, ref = got["port"][0], got["ref"][0]
    assert (tmp_path / "port.tsv").read_bytes() \
        == (tmp_path / "ref.tsv").read_bytes()
    assert _keys(port) == _keys(ref)
    assert {k: port[k] for k in INPUT_KEYS} \
        == {k: ref[k] for k in INPUT_KEYS}
    assert port["lines"] == port["alignments"] == 2 * len(lens_t)
    assert port["device_batches"] == ref["device_batches"] == 0
    n = got["port"][1]["dispatches"]
    assert port["device"]["by_site"] == {"many2many": n}
    # each supervised dispatch ends in the fetch of its own block, in
    # both packages
    assert (port["device"]["dispatches"], port["device"]["flushes"]) \
        == (n, n)
    assert ref["device"]["flushes"] == ref["device"]["dispatches"]
    assert port["resilience"] == ref["resilience"]
    if same_groups:
        assert port["device"]["by_site"] == ref["device"]["by_site"]
    else:
        assert n < ref["device"]["by_site"]["many2many"]


def test_many2many_stats_requires_a_file(tmp_path):
    tfa, qfa = _m2m_inputs(tmp_path, (170,))
    err = io.StringIO()
    assert run(["--many2many", tfa, "-r", qfa, "--device=cpu",
                "--stats"], stderr=err) == 1
    assert err.getvalue().rstrip().endswith(
        "Error: --stats requires a file argument")


# ---------------------------------------------------------------------------
# --profile
# ---------------------------------------------------------------------------
def test_profile_writes_a_trace(tmp_path):
    paf, fa, _ = _golden(tmp_path)
    prof = tmp_path / "prof"
    err = io.StringIO()
    assert run([paf, "-r", fa, "-o", str(tmp_path / "p.dfa"),
                f"--cons={tmp_path / 'c.fa'}", "--device=cpu",
                f"--profile={prof}"], stderr=err) == 0
    assert f"device trace written to {prof}" in err.getvalue()
    doc = json.loads((prof / "trace.json").read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert (tmp_path / "c.fa").read_bytes() == open(
        os.path.join(REPO, "tests", "golden", "cons.fa"), "rb").read()


def test_no_profiler_without_the_flag(tmp_path, monkeypatch):
    """Without --profile no profiler is made; with it, a profiler that
    cannot start fails the run (no quiet fallback)."""
    import torch.profiler

    def refuse(*_a, **_k):
        raise RuntimeError("profiler started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    paf, fa, _ = _golden(tmp_path)
    args = [paf, "-r", fa, "-o", str(tmp_path / "p.dfa"), "--device=cpu"]
    assert run(args, stderr=io.StringIO()) == 0
    with pytest.raises(RuntimeError, match="profiler started"):
        run(args + [f"--profile={tmp_path / 'prof'}"],
            stderr=io.StringIO())
