"""The port's CLI under ``--inject-faults``, ``--max-retries``,
``--device-deadline`` and ``--fallback=fail`` against the JAX package's.

The port runs at ``--device=cpu``, where every device dispatch goes
through its supervisor as on the card; the reference runs at
``--device=tpu`` on its JAX CPU backend with ``--fallback=fail
--recover=off`` (``PWASM_DEVICE_PROBE=0``), so that neither degrades.
Fault draws are keyed on (seed, site, attempt), so the same spec gives
the same faults in both: the six outputs, the exit code, the
``resilience`` block of ``--stats`` and the checkpoints are compared
exactly.
"""

import io
import json
import os
import shutil

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.resilience.faults import InjectedKill as RefKill
from pwasm_tpu_torch import corpus
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.resilience.faults import InjectedKill as PortKill

from test_torch_cli_m2m import _fixture

OUTS = ("dfa", "sum", "mfa", "ace", "info", "cons")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """12 alignments of a 300-base CDS (clipped ends, so the clip
    refinement runs) against 2-5 kb assemblies: (dir, paf, fa)."""
    d = tmp_path_factory.mktemp("faults")
    q, lines = corpus.make_corpus(n_aln=12, cds_len=300, asm_lo=2000,
                                  asm_hi=5000)
    (d / "q.fa").write_text(f">cds1\n{q}\n")
    (d / "in.paf").write_text("".join(ln + "\n" for ln in lines))
    return d, str(d / "in.paf"), str(d / "q.fa")


@pytest.fixture(autouse=True)
def _no_probe(monkeypatch):
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")


def _python_engine_with_clips(monkeypatch):
    """Select the Python MSA engine, and give every member but the
    first 3 clipped bases at each end once the MSA is finalized, in
    both packages: ``pafreport`` itself clips no member, so without this
    the clip refinement (the ``refine`` site) never runs."""
    from pwasm_tpu.align.msa import Msa as RefMsa
    from pwasm_tpu_torch.align.msa import Msa

    monkeypatch.setenv("PWASM_NATIVE_MSA", "0")
    for cls in (Msa, RefMsa):
        def finalize(self, _orig=cls.finalize):
            _orig(self)
            for m in self.seqs[1:]:
                m.clp5 = m.clp3 = 3
        monkeypatch.setattr(cls, "finalize", finalize)


def _cli(who, paf, fa, d, tag, extra=()):
    """One run of ``who`` with all six outputs and ``--stats``:
    (rc, stderr, --stats or None)."""
    p = str(d / tag)
    argv = [paf, "-r", fa, "-o", f"{p}.dfa", "-s", f"{p}.sum",
            "-w", f"{p}.mfa", f"--ace={p}.ace", f"--info={p}.info",
            f"--cons={p}.cons", "--batch=4", f"--stats={p}.json", *extra]
    err = io.StringIO()
    if who == "port":
        rc = run(argv + ["--device=cpu"], stderr=err)
    else:
        rc = ref_run(argv + ["--device=tpu", "--fallback=fail",
                             "--recover=off"], stderr=err)
    path = d / f"{tag}.json"
    return rc, err.getvalue(), (json.loads(path.read_text())
                                if path.exists() else None)


def _outs(d, tag):
    return {ext: (d / f"{tag}.{ext}").read_bytes() for ext in OUTS}


def _both(paf, fa, d, extra, tag="f"):
    """Both packages on the same flags: {who: (rc, stderr, stats)}."""
    return {who: _cli(who, paf, fa, d, f"{tag}_{who}", extra)
            for who in ("port", "ref")}


def _last(err: str) -> str:
    return err.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def clean(inputs):
    """The reference's fault-free run of each flag set: {realign: its
    outputs}."""
    d, paf, fa = inputs
    mp = pytest.MonkeyPatch()
    mp.setenv("PWASM_DEVICE_PROBE", "0")
    out = {}
    try:
        for realign in (False, True):
            tag = f"clean_{int(realign)}"
            rc, err, _st = _cli("ref", paf, fa, d, tag,
                                ["--realign"] if realign else [])
            assert rc == 0, err
            out[realign] = _outs(d, tag)
    finally:
        mp.undo()
    return out


# ---------------------------------------------------------------------------
# seeded faults: the same outputs, exit code and resilience block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,realign,engine", [
    ("seed=2,rate=0.35,kinds=raise+nan+corrupt", False, "native"),
    ("seed=5,rate=0.4,kinds=raise+nan+corrupt", True, "native"),
    ("seed=1,rate=0.3,kinds=raise+nan+corrupt", False, "python")])
def test_faulted_run_equals_the_reference(inputs, clean, tmp_path,
                                          monkeypatch, spec, realign,
                                          engine):
    """Equal outputs, exit code, counters and supervisor lines; on the
    engine also the clean run's outputs (the Python engine's case clips
    its members, so its outputs are compared across the packages
    only)."""
    _d, paf, fa = inputs
    if engine == "python":
        _python_engine_with_clips(monkeypatch)
    extra = [f"--inject-faults={spec}", "--max-retries=8"] \
        + (["--realign"] if realign else [])
    got = _both(paf, fa, tmp_path, extra)
    assert got["port"][0] == got["ref"][0] == 0, got["port"][1][-2000:]
    assert _outs(tmp_path, "f_port") == _outs(tmp_path, "f_ref")
    if engine == "native":
        assert _outs(tmp_path, "f_port") == clean[realign]
    res = got["port"][2]["resilience"]
    assert res == got["ref"][2]["resilience"]
    assert res["injected_faults"] > 0 and res["retries"] > 0
    assert res["guardrail_rejects"] > 0 and res["fallbacks"] == 0
    # every attempt is a dispatch, site for site
    assert got["port"][2]["device"]["by_site"] \
        == got["ref"][2]["device"]["by_site"]
    if engine == "python":
        assert got["port"][2]["device"]["by_site"]["refine"] >= 2
    # the stderr lines of the supervisor are the reference's
    lines = {who: [ln for ln in got[who][1].splitlines()
                   if ln.startswith("pwasm: ")] for who in got}
    assert lines["port"] == lines["ref"] and len(lines["port"]) > 1


def test_hangs_past_the_device_deadline(inputs, clean, tmp_path):
    """Injected 0.5 s hangs against a 0.2 s deadline: each costs one
    timeout, the attempt is abandoned and retried, and the outputs are
    the clean run's in both packages."""
    _d, paf, fa = inputs
    got = _both(paf, fa, tmp_path, [
        "--device-deadline=0.2", "--max-retries=6",
        "--inject-faults=seed=2,rate=0.3,kinds=hang,hang_s=0.5"])
    assert got["port"][0] == got["ref"][0] == 0, got["port"][1][-2000:]
    assert _outs(tmp_path, "f_port") == _outs(tmp_path, "f_ref") \
        == clean[False]
    for who in got:
        res = got[who][2]["resilience"]
        assert res["deadline_timeouts"] > 0 and res["fallbacks"] == 0


def test_oom_bisection_equals_the_reference(inputs, clean, tmp_path):
    _d, paf, fa = inputs
    got = _both(paf, fa, tmp_path, ["--inject-faults=oom=8"])
    assert got["port"][0] == got["ref"][0] == 0, got["port"][1][-2000:]
    assert _outs(tmp_path, "f_port") == _outs(tmp_path, "f_ref") \
        == clean[False]
    port, ref = (got[w][2] for w in ("port", "ref"))
    assert port["resilience"] == ref["resilience"]
    res = port["resilience"]
    assert res["oom_events"] > 0 and res["batch_splits"] > 0
    assert res["bucket_demotions"] > 0 and res["breaker_trips"] == 0
    assert port["device"]["by_site"]["ctx_scan"] \
        == ref["device"]["by_site"]["ctx_scan"] > port["device_batches"]


def test_down_window_exits_1_with_the_reference_checkpoint(inputs,
                                                           tmp_path):
    """A scripted outage: the failures reach the breaker's threshold,
    the probe answers dead, the breaker opens and the run aborts with
    the same error line and the same checkpoint in both."""
    _d, paf, fa = inputs
    got = _both(paf, fa, tmp_path, ["--inject-faults=down=3-4",
                                    "--max-retries=4"])
    assert got["port"][0] == got["ref"][0] == 1
    assert _last(got["port"][1]) == _last(got["ref"][1])
    assert "circuit breaker OPEN" in got["port"][1]
    ck = {who: (tmp_path / f"f_{who}.dfa.ckpt").read_text()
          for who in ("port", "ref")}
    assert ck["port"] == ck["ref"]
    st = json.loads(ck["port"])
    assert st["records"] > 0 and st["resilience"]["breaker_open"] is False
    assert (tmp_path / "f_port.dfa").read_bytes() \
        == (tmp_path / "f_ref.dfa").read_bytes()


# ---------------------------------------------------------------------------
# every supervised site aborts naming itself (the port's behavioural
# form of tests/test_supervision_coverage.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("site,extra,engine", [
    ("ctx_scan", [], "native"), ("realign", ["--realign"], "native"),
    ("consensus", [], "native"), ("consensus", [], "python"),
    ("refine", [], "python")])
def test_every_site_aborts_naming_it(inputs, tmp_path, monkeypatch, site,
                                     extra, engine):
    _d, paf, fa = inputs
    if engine == "python":
        _python_engine_with_clips(monkeypatch)
    # (kinds without hang: a hang with no deadline sleeps, then works)
    got = _both(paf, fa, tmp_path, [
        f"--inject-faults=rate=1,kinds=raise+nan+corrupt,sites={site}",
        "--max-retries=0", *extra])
    assert got["port"][0] == got["ref"][0] == 1
    last = _last(got["port"][1])
    assert last == _last(got["ref"][1])
    assert last.startswith(f"Error: device work '{site}' failed and "
                           "--fallback=fail forbids degrading (")


def test_many2many_site_aborts_naming_it(tmp_path, monkeypatch):
    """``--many2many`` supervises its scoring dispatches without a fault
    plan (as the reference): a launch that raises, with no retry left,
    aborts both packages with the same line."""
    import pwasm_tpu.parallel.many2many as ref_m2m
    import pwasm_tpu_torch.parallel.many2many as port_m2m

    def boom(*a, **k):
        raise RuntimeError("scores launch failed")

    monkeypatch.setattr(port_m2m, "banded_scores_matrix", boom)
    monkeypatch.setattr(ref_m2m, "many2many_scores", boom)
    _qs, qfa, tfa = _fixture(tmp_path, n_q=2, n_t=3)
    last = {}
    for who, fn, dev in (("port", run, "cpu"), ("ref", ref_run, "tpu")):
        err = io.StringIO()
        assert fn(["--many2many", tfa, "-r", qfa, "-o",
                   str(tmp_path / f"{who}.tsv"), "--max-retries=1",
                   "--fallback=fail", f"--device={dev}"],
                  stdout=io.StringIO(), stderr=err) == 1
        last[who] = _last(err.getvalue())
    assert last["port"] == last["ref"] == (
        "Error: device work 'many2many' failed and --fallback=fail "
        "forbids degrading (RuntimeError: scores launch failed)")
    assert not (tmp_path / "port.tsv").exists()


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [
    "--max-retries=x", "--max-retries", "--device-deadline=0",
    "--device-deadline=x", "--device-deadline=nan",
    "--device-deadline=inf", "--fallback=maybe", "--recover=sometimes",
    "--inject-faults", "--inject-faults=rate=9",
    "--inject-faults=kinds=explode"])
def test_flag_validation_matches_the_reference(inputs, tmp_path, bad):
    _d, paf, fa = inputs
    last = {}
    for who, fn in (("port", run), ("ref", ref_run)):
        err = io.StringIO()
        assert fn([paf, "-r", fa, "-o", str(tmp_path / f"{who}.dfa"), bad,
                   "--device=cpu"], stdout=io.StringIO(), stderr=err) == 1
        last[who] = _last(err.getvalue())
    assert last["port"] == last["ref"]
    assert "Invalid" in last["port"] or "requires" in last["port"]


@pytest.mark.parametrize("flag,words", [
    ("--fallback=cpu", "--fallback=cpu moves failed device work to the "
     "host"),
    ("--recover=auto", "--recover=auto re-promotes device work"),
    ("--reprobe-interval=5", "--reprobe-interval schedules"),
    ("--reprobe-max=60", "--reprobe-max schedules")])
def test_degradations_exit_1(inputs, tmp_path, flag, words):
    """The reference's degradations are options the port refuses, each
    with a message naming it; the port's own setting of each runs."""
    _d, paf, fa = inputs
    err = io.StringIO()
    assert run([paf, "-r", fa, "-o", str(tmp_path / "r.dfa"), flag,
                "--device=cpu"], stderr=err) == 1
    assert err.getvalue().startswith(f"Error: {words}")
    assert "degradation pwasm_tpu_torch does not have" in err.getvalue()
    assert not (tmp_path / "r.dfa").exists()
    if flag.startswith("--fallback"):
        _qs, qfa, tfa = _fixture(tmp_path, n_q=1, n_t=2)
        err = io.StringIO()
        assert run(["--many2many", tfa, "-r", qfa, flag, "--device=cpu"],
                   stdout=io.StringIO(), stderr=err) == 1
        assert err.getvalue().startswith(f"Error: {words}")


def test_the_ports_only_policy_runs(inputs, clean, tmp_path):
    """``--fallback=fail --recover=off`` (a strict pipeline's flags) run
    the port as they run the reference."""
    _d, paf, fa = inputs
    rc, err, st = _cli("port", paf, fa, tmp_path, "strict",
                       ["--fallback=fail", "--recover=off",
                        "--max-retries=0", "--device-deadline=30"])
    assert rc == 0, err
    assert _outs(tmp_path, "strict") == clean[False]
    assert st["resilience"]["retries"] == 0


# ---------------------------------------------------------------------------
# the supervisor's state in the checkpoint, across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kill_by,resume_by", [("ref", "port"),
                                               ("port", "ref")])
def test_demoted_ceiling_resumes_across_packages(inputs, clean, tmp_path,
                                                 kill_by, resume_by):
    """A run killed after an OOM demoted its ceiling leaves the ceiling
    in its checkpoint; the other package resumes it with the same
    ``oom=`` armed and inherits it: no new OOM, the clean outputs, and
    the resumed run's counters equal the killer's own resume."""
    _d, paf, fa = inputs
    spec = "--inject-faults=oom=8"
    rc, err, st = _cli(kill_by, paf, fa, tmp_path, "whole", [spec])
    assert rc == 0, err
    k = sum(st["device"]["by_site"].values()) - 2
    # both packages killed at attempt k: the same report and checkpoint
    for who, exc in (("port", PortKill), ("ref", RefKill)):
        with pytest.raises(exc):
            _cli(who, paf, fa, tmp_path, f"k_{who}", [f"{spec},kill={k}"])
    ck = {who: (tmp_path / f"k_{who}.dfa.ckpt").read_text()
          for who in ("port", "ref")}
    assert ck["port"] == ck["ref"]
    state = json.loads(ck[kill_by])
    assert 0 < state["records"] < 12
    assert state["resilience"]["bucket_ceiling"] is not None
    # the killer's run resumed by each package
    got = {}
    for who in (kill_by, resume_by):
        tag = f"r_{who}"
        for ext in ("dfa", "dfa.ckpt"):
            shutil.copy(tmp_path / f"k_{kill_by}.{ext}",
                        tmp_path / f"{tag}.{ext}")
        rc, err, rst = _cli(who, paf, fa, tmp_path, tag, [spec, "--resume"])
        assert rc == 0, err
        outs = _outs(tmp_path, tag)
        assert {e: v for e, v in outs.items() if e != "sum"} \
            == {e: v for e, v in clean[False].items() if e != "sum"}
        got[who] = rst
        assert not os.path.exists(tmp_path / f"{tag}.dfa.ckpt")
    assert got["port"]["resilience"] == got["ref"]["resilience"]
    assert got["port"]["resilience"]["oom_events"] == 0
    assert got["port"]["resumed_past"] == got["ref"]["resumed_past"] \
        == state["records"]


def test_env_armed_plan_equals_the_flag(inputs, clean, tmp_path,
                                        monkeypatch):
    """``PWASM_INJECT_FAULTS`` arms the same plan as the flag (for a
    process that never sees it), with the same "armed" line."""
    _d, paf, fa = inputs
    monkeypatch.setenv("PWASM_INJECT_FAULTS",
                       "seed=2,rate=0.35,kinds=raise+nan+corrupt")
    got = _both(paf, fa, tmp_path, ["--max-retries=8"], tag="env")
    assert got["port"][0] == got["ref"][0] == 0
    armed = {who: [ln for ln in got[who][1].splitlines()
                   if ln.startswith("pwasm: fault injection armed")]
             for who in got}
    assert armed["port"] == armed["ref"] and len(armed["port"]) == 1
    assert got["port"][2]["resilience"] == got["ref"][2]["resilience"]
    assert got["port"][2]["resilience"]["injected_faults"] > 0
    assert _outs(tmp_path, "env_port") == clean[False]


@pytest.mark.parametrize("flag", ["--max-retries=x", "--max-retries",
                                  "--fallback=maybe", "--max-retries=0",
                                  "--fallback=fail"])
def test_many2many_resilience_flags(tmp_path, flag):
    """``--many2many`` takes ``--max-retries`` and ``--fallback=fail``
    with the reference's checks and messages."""
    _qs, qfa, tfa = _fixture(tmp_path, n_q=2, n_t=3)
    got = {}
    for who, fn, dev in (("port", run, "cpu"), ("ref", ref_run, "tpu")):
        err, out = io.StringIO(), str(tmp_path / f"{who}.tsv")
        got[who] = (fn(["--many2many", tfa, "-r", qfa, "-o", out, flag,
                        f"--device={dev}"], stdout=io.StringIO(),
                       stderr=err), err.getvalue())
    assert got["port"][0] == got["ref"][0]
    if got["port"][0]:
        assert _last(got["port"][1]) == _last(got["ref"][1])
    else:
        assert (tmp_path / "port.tsv").read_bytes() \
            == (tmp_path / "ref.tsv").read_bytes()
