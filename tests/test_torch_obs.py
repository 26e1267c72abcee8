"""The port's observability (``pwasm_tpu_torch/obs/``) against the JAX
package's: the metrics registry, the catalog, the span recorder, the
event log and ``trace-merge`` as units, then the CLI wiring
(``--trace-json``, ``--log-json``, ``--metrics-textfile``) on a small
corpus against the reference's ``--device=tpu`` run on its CPU backend.

Exact comparisons, except for walls, clock values and run ids.  Both
write a report-batch checkpoint and its ``ckpt_write`` event a batch.
"""

import io
import json
import os
import re
import shutil
from collections import Counter

import numpy as np
import pytest
import torch

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.obs.catalog import build_cache_metrics as ref_build_cache
from pwasm_tpu.obs.catalog import build_run_metrics as ref_build_run
from pwasm_tpu.obs.catalog import \
    build_service_metrics as ref_build_service
from pwasm_tpu.obs.catalog import fold_run_stats as ref_fold
from pwasm_tpu.obs.merge import merge_traces as ref_merge_traces
from pwasm_tpu.obs.metrics import MetricsRegistry as RefRegistry
from pwasm_tpu_torch import corpus
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.obs import (NULL_OBS, EventLog, MetricsRegistry,
                                 Observability, TraceRecorder,
                                 make_observability)
from pwasm_tpu_torch.obs import catalog
from pwasm_tpu_torch.obs.catalog import (breaker_state_value,
                                         build_run_metrics,
                                         build_service_metrics,
                                         fold_run_stats)
from pwasm_tpu_torch.obs.merge import merge_traces
from pwasm_tpu_torch.obs.metrics import NAME_RE
from pwasm_tpu_torch.resilience.supervisor import (BatchSupervisor,
                                                   ResilienceError,
                                                   ResiliencePolicy)
from pwasm_tpu_torch.utils.runstats import RunStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# metrics registry (the reference's tests/test_obs.py cases, on the port)
# ---------------------------------------------------------------------------
def test_metric_name_grammar_enforced():
    reg = MetricsRegistry()
    for bad in ("queue_depth", "pwasm_Queue", "pwasm_", "pwasm_a-b",
                "Pwasm_x", "pwasm_x__y"):
        with pytest.raises(ValueError):
            reg.counter(bad, "h")
    assert reg.counter("pwasm_ok_total", "h").name == "pwasm_ok_total"


def test_duplicate_registration_raises():
    reg = MetricsRegistry()
    reg.gauge("pwasm_depth", "h")
    with pytest.raises(ValueError):
        reg.counter("pwasm_depth", "h")


def test_counter_monotonic():
    reg = MetricsRegistry()
    c = reg.counter("pwasm_jobs_total", "h", labels=("outcome",))
    c.inc(outcome="done")
    c.inc(2, outcome="done")
    c.inc(outcome="failed")
    assert c.value(outcome="done") == 3
    assert c.value(outcome="failed") == 1
    with pytest.raises(ValueError):
        c.inc(-1, outcome="done")
    with pytest.raises(ValueError):
        c.inc(1)   # missing declared label


def test_gauge_set_inc_reset_exposed():
    reg = MetricsRegistry()
    g = reg.gauge("pwasm_depth", "queue depth")
    g.set(5)
    g.inc()
    g.dec(2)
    assert g.value() == 4
    assert "pwasm_depth 4" in reg.expose().splitlines()
    g.reset()
    assert g.value() == 0
    assert "pwasm_depth 0" in reg.expose().splitlines()


def test_histogram_bucket_cumulativity():
    reg = MetricsRegistry()
    h = reg.histogram("pwasm_wall_seconds", "h", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    sample = {}
    for ln in reg.expose().splitlines():
        if not ln.startswith("#"):
            k, v = ln.rsplit(" ", 1)
            sample[k] = float(v)
    assert sample['pwasm_wall_seconds_bucket{le="0.1"}'] == 2
    assert sample['pwasm_wall_seconds_bucket{le="1"}'] == 3
    assert sample['pwasm_wall_seconds_bucket{le="10"}'] == 4
    assert sample['pwasm_wall_seconds_bucket{le="+Inf"}'] == 5
    assert sample["pwasm_wall_seconds_count"] == 5
    assert sample["pwasm_wall_seconds_sum"] == pytest.approx(55.6)
    with pytest.raises(ValueError):
        reg.histogram("pwasm_bad_seconds", "h", buckets=(1.0, 0.5))


def test_exposition_escaping():
    reg = MetricsRegistry()
    c = reg.counter("pwasm_esc_total", 'help with \\ and\nnewline',
                    labels=("path",))
    c.inc(path='a"b\\c\nd')
    lines = reg.expose().splitlines()
    assert "# HELP pwasm_esc_total help with \\\\ and\\nnewline" in lines
    assert 'pwasm_esc_total{path="a\\"b\\\\c\\nd"} 1' in lines


_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="(\\.|[^"\\])*"'
    r'(,[a-zA-Z0-9_]+="(\\.|[^"\\])*")*\})? -?[0-9.e+Inf-]+$')


def assert_valid_exposition(text: str) -> None:
    """Every line is a HELP/TYPE comment or a sample of a family TYPEd
    before it."""
    typed = set()
    assert text.endswith("\n")
    for ln in text.splitlines():
        if ln.startswith(("# HELP ", "# TYPE ")):
            parts = ln.split(" ", 3)
            assert len(parts) >= 3
            if parts[1] == "TYPE":
                typed.add(parts[2])
            continue
        assert _SAMPLE_RE.match(ln), ln
        name = re.split(r"[{ ]", ln, maxsplit=1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        assert name in typed or base in typed, ln


def test_catalog_builds_valid_exposition():
    reg = MetricsRegistry()
    rm = build_run_metrics(reg)
    sm = build_service_metrics(reg)
    rm["batch_attempt_seconds"].observe(0.2, site="ctx_scan")
    sm["jobs"].inc(outcome="done")
    sm["job_wall_seconds"].observe(1.5)
    fold_run_stats(rm, {"alignments": 3, "wall_s": 0.5,
                        "resilience": {"breaker_trips": 1},
                        "backend": {"probes": 1, "warm_hits": 2},
                        "device": {"dispatches": 4, "flushes": 2}})
    text = reg.expose()
    assert_valid_exposition(text)
    lines = text.splitlines()
    assert "pwasm_run_alignments_total 3" in lines
    assert "pwasm_breaker_trips_total 1" in lines
    assert "pwasm_backend_warm_hits_total 2" in lines
    # a malformed stats dict folds as zeros, never raises
    fold_run_stats(rm, {"alignments": "gibberish",
                        "resilience": "not-a-dict"})
    fold_run_stats(rm, None)


def test_breaker_state_encoding():
    assert breaker_state_value(False) == 0
    assert breaker_state_value(False, "half-open") == 0
    assert breaker_state_value(True, "half-open") == 1
    assert breaker_state_value(True, "open") == 2
    assert breaker_state_value(True, None) == 2


def _stats_dict() -> dict:
    """A port --stats dict with every block populated."""
    st = RunStats()
    st.lines, st.alignments, st.events, st.aligned_bases = 14, 12, 40, 3600
    st.skipped_dedup = st.skipped_self = 1
    st.device_batches, st.device_events, st.scalar_events = 3, 38, 2
    for site in ("ctx_scan", "ctx_scan", "realign", "consensus"):
        st.note_dispatch(site)
        st.note_flush()
    st.note_pad(38, 256)
    st.note_attempt_wall("ctx_scan", 0.125)
    st.note_attempt_wall("ctx_scan", 0.0625)
    st.host_parse_s, st.host_format_s = 0.25, 0.5
    d = st.as_dict()
    d["wall_s"] = 1.5
    return d


@pytest.mark.parametrize("service", [False, True])
def test_catalog_exposition_equals_the_reference(service):
    """The copied catalog renders the reference's exposition byte for
    byte after one run's fold (and, with the daemon families
    registered, their HELP/TYPE lines too)."""
    d = _stats_dict()
    texts = []
    for reg, build_run, build_svc, fold in (
            (MetricsRegistry(), build_run_metrics, build_service_metrics,
             fold_run_stats),
            (RefRegistry(), ref_build_run, ref_build_service, ref_fold)):
        rm = build_run(reg)
        if service:
            build_svc(reg)
        fold(rm, d)
        rm["batch_attempt_seconds"].observe(0.125, site="ctx_scan")
        rm["breaker_state"].set(breaker_state_value(False))
        texts.append(reg.expose())
    assert texts[0] == texts[1]
    assert_valid_exposition(texts[0])


def test_cache_families_equal_the_reference():
    """The result-cache families: the reference's names and types.  One
    HELP text drops the reference's history tag, so HELP lines are not
    compared here."""
    texts = []
    for reg, build in ((MetricsRegistry(), catalog.build_cache_metrics),
                       (RefRegistry(), ref_build_cache)):
        build(reg)
        texts.append([ln for ln in reg.expose().splitlines()
                      if not ln.startswith("# HELP ")])
    assert texts[0] == texts[1] and len(texts[0]) >= 6


# ---------------------------------------------------------------------------
# the catalog rule (the reference's qa/check_supervision.py metric lint,
# held here for the port)
# ---------------------------------------------------------------------------
_REGISTER_RE = re.compile(r"\.\s*(?:counter|gauge|histogram)\s*\(")
_LITERAL_RE = re.compile(r"""["'](pwasm_[A-Za-z0-9_]*)["']""")
_END = "metric-name-lint: end-of-registrations"


def _catalog_names(path: str) -> tuple[list[str], list[str]]:
    """(name literals of the registration region, violations)."""
    names, bad = [], []
    seen: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            if _END in line:
                break
            if line.lstrip().startswith("#"):
                continue
            for name in _LITERAL_RE.findall(line):
                names.append(name)
                if not NAME_RE.match(name):
                    bad.append(f"{i}: {name!r} violates the grammar")
                if name in seen:
                    bad.append(f"{i}: duplicate {name!r} (first at "
                               f"{seen[name]})")
                seen.setdefault(name, i)
    return names, bad


def test_catalog_is_the_only_registration_site():
    top = os.path.join(REPO, "pwasm_tpu_torch")
    allowed = {os.path.join(top, "obs", "catalog.py"),
               os.path.join(top, "obs", "metrics.py")}
    hits = []
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_build")]
        for fn in sorted(filenames):
            path = os.path.join(dirpath, fn)
            if not fn.endswith(".py") or path in allowed:
                continue
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f, 1):
                    if not line.lstrip().startswith("#") \
                            and _REGISTER_RE.search(line):
                        hits.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert not hits, hits
    names, bad = _catalog_names(os.path.join(top, "obs", "catalog.py"))
    assert not bad, bad
    ref_names, _ = _catalog_names(
        os.path.join(REPO, "pwasm_tpu", "obs", "catalog.py"))
    assert len(names) > 100 and names == ref_names


def test_catalog_rule_catches_a_duplicate(tmp_path):
    src = open(os.path.join(REPO, "pwasm_tpu_torch", "obs",
                            "catalog.py"), encoding="utf-8").read()
    dup = src.replace('"pwasm_run_events_total"',
                      '"pwasm_run_alignments_total"', 1)
    bad_name = src.replace('"pwasm_run_events_total"',
                           '"pwasm_Run_events"', 1)
    for text, what in ((dup, "duplicate"), (bad_name, "grammar")):
        p = tmp_path / "catalog.py"
        p.write_text(text, encoding="utf-8")
        _names, bad = _catalog_names(str(p))
        assert any(what in b for b in bad), bad


# ---------------------------------------------------------------------------
# span recorder and event log
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_trace_spans_nest_monotonically():
    clk = _Clock()
    rec = TraceRecorder(clock=clk)
    with rec.span("outer", phase="run"):
        clk.t = 1.0
        with rec.span("inner", site="ctx_scan"):
            clk.t = 2.0
        clk.t = 3.0
    evs = {e["name"]: e for e in rec.to_dict()["traceEvents"]}
    inner, outer = evs["inner"], evs["outer"]
    for e in (inner, outer):
        assert e["ph"] == "X"
        assert {"ts", "dur", "pid", "tid", "args", "name"} <= set(e)
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["dur"] == 3_000_000 and inner["dur"] == 1_000_000


def test_trace_span_records_error_and_instant():
    rec = TraceRecorder(clock=_Clock())
    with pytest.raises(RuntimeError):
        with rec.span("doomed"):
            raise RuntimeError("x")
    rec.instant("breaker_trip", site="ctx_scan")
    evs = {e["name"]: e for e in rec.to_dict()["traceEvents"]}
    assert evs["doomed"]["args"]["error"] == "RuntimeError"
    assert evs["breaker_trip"]["ph"] == "i"


def test_trace_event_cap_bounds_memory():
    rec = TraceRecorder(clock=_Clock(), max_events=3)
    drops = []
    rec.on_drop = lambda: drops.append(1)
    for i in range(5):
        rec.instant(f"e{i}")
    doc = rec.to_dict()
    assert len(doc["traceEvents"]) == 3
    assert doc["otherData"]["dropped_events"] == 2 == len(drops)


def test_event_log_lines_and_clocks():
    buf = io.StringIO()
    log = EventLog(buf, owns_stream=False)
    log.emit("run_start", device="cpu")
    log.emit("run_finish", rc=0, skipme=None)
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert [r["event"] for r in recs] == ["run_start", "run_finish"]
    assert all(r["run_id"] == log.run_id for r in recs)
    assert all("ts_wall" in r and "ts_mono" in r for r in recs)
    assert recs[0]["ts_mono"] <= recs[1]["ts_mono"]
    assert "skipme" not in recs[1]
    assert recs[1]["rc"] == 0


def test_event_log_never_raises():
    class Dead:
        def write(self, *_a):
            raise OSError("gone")

        def flush(self):
            raise OSError("gone")

    log = EventLog(Dead(), owns_stream=False)
    log.emit("run_start")        # swallowed
    log.close()
    log.emit("after_close")      # no-op


def test_event_log_rotates_at_the_cap(tmp_path):
    path = tmp_path / "ev.ndjson"
    log = EventLog(path=str(path), max_bytes=200)
    for i in range(12):
        log.emit("tick", i=i)
    log.close()
    assert log.rotations >= 1
    old = (tmp_path / "ev.ndjson.1").read_text().splitlines()
    new = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert old and new[0]["event"] == "log_rotate"


def test_observability_facade_null_hooks():
    assert not NULL_OBS.enabled and NULL_OBS.flight is None
    with NULL_OBS.span("x", a=1):
        NULL_OBS.event("anything", n=3)
    NULL_OBS.observe("batch_attempt_seconds", 0.1, site="s")
    NULL_OBS.set_gauge("breaker_state", 2)
    NULL_OBS.count("host_stage_seconds", 1.0, stage="parse")
    NULL_OBS.span_complete("y", NULL_OBS.clock())
    # a supervisor made without an obs bundle traces into the null one
    sup = BatchSupervisor()
    assert sup.obs is NULL_OBS and sup.run("ctx_scan", lambda: 4) == 4


def test_make_observability_subsets(tmp_path):
    obs = make_observability()
    assert not obs.enabled
    obs = make_observability(log_json=str(tmp_path / "e.ndjson"))
    assert obs.enabled and obs.registry is None and obs.flight is None
    obs.event("run_start")
    obs.close(io.StringIO())
    first = json.loads((tmp_path / "e.ndjson").read_text().splitlines()[0])
    assert first["event"] == "run_start"
    obs = make_observability(metrics_textfile=str(tmp_path / "m.prom"))
    assert obs.registry is not None and obs.run_metrics
    obs.close(io.StringIO())
    assert_valid_exposition((tmp_path / "m.prom").read_text())


# ---------------------------------------------------------------------------
# the supervised dispatch: one attempt's accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fails", [False, True])
def test_dispatch_hook_counts_traces_and_observes(fails):
    """Each attempt of ``BatchSupervisor.run`` is one dispatch and one
    flush, one ``device_batch`` span with its real ``attempt`` index,
    and one ``batch_attempt_seconds`` sample; a run that exhausts its
    retries aborts with ``ResilienceError``."""
    from pwasm_tpu_torch.obs import tracing
    reg = MetricsRegistry()
    rm = build_run_metrics(reg)
    clk = _Clock()
    obs = Observability(registry=reg, run_metrics=rm,
                        tracer=tracing.TraceRecorder(clock=clk))
    st = RunStats()
    sup = BatchSupervisor(ResiliencePolicy(max_retries=1, backoff_s=0.0),
                          stats=st, stderr=io.StringIO(), obs=obs)

    def attempt():
        clk.t += 1.0
        if fails:
            raise RuntimeError("launch failed")
        return 7

    if fails:
        with pytest.raises(ResilienceError):   # 2 attempts, then abort
            sup.run("realign", attempt, size=3)
    else:
        for _ in range(2):
            assert sup.run("realign", attempt, size=3) == 7
    dev = st.as_dict()["device"]
    assert dev["dispatches"] == dev["flushes"] == 2
    assert dev["by_site"] == {"realign": 2}
    assert dev["compile_s"] > 0 and dev["steady_s"] > 0
    assert rm["batch_attempt_seconds"].count(site="realign") == 2
    assert st.res_retries == (1 if fails else 0)
    spans = [e for e in obs.tracer.to_dict()["traceEvents"]]
    assert [e["name"] for e in spans] == ["device_batch"] * 2
    assert spans[0]["args"]["site"] == "realign"
    assert [e["args"]["attempt"] for e in spans] == ([0, 1] if fails
                                                     else [0, 0])
    assert spans[0]["args"]["items"] == 3
    assert spans[0]["dur"] == 1_000_000
    assert ("error" in spans[0]["args"]) == fails


def test_null_hook_calls_through():
    """A library call outside a run takes ``supervisor=None``: the work
    runs as a direct call, and only ctx_scan, as in the reference,
    counts its own round-trip (into the ``stats`` it is given)."""
    from pwasm_tpu_torch.core.events import extract_alignment
    from pwasm_tpu_torch.core.paf import parse_paf_line
    from pwasm_tpu_torch.ops.realign import realign_pairs
    from pwasm_tpu_torch.parallel.many2many import many2many_scores_ragged
    from pwasm_tpu_torch.report.device_report import submit_events_device

    from helpers import make_paf_line

    cpu = torch.device("cpu")
    res = realign_pairs([(b"ACGTACGTAC", b"ACGTTACGTAC")], band=8,
                        device=cpu)
    assert res[0] is not None
    scores = many2many_scores_ragged([b"ACGTACGT"], [b"ACGTACGT"], band=8,
                                     device=cpu)
    assert scores.shape == (1, 1) and scores[0, 0] > 0
    q = "ATGGCCTGGAAAGATCTGTACCTGAACGT"
    line, _ = make_paf_line("q", q, "t", "+", [("=", 10), ("*", "t", "a"),
                                               ("=", 18)])
    aln = extract_alignment(parse_paf_line(line), q.encode())
    st = RunStats()
    rows = submit_events_device(q.encode(), aln.tdiffs, cpu, stats=st)()
    assert len(rows) == len(aln.tdiffs) == 1
    d = st.as_dict()
    assert d["device"]["by_site"] == {"ctx_scan": 1}
    assert (d["device"]["flushes"], d["device"]["pad_items"],
            d["device_events"]) == (1, 1, 1)


def test_launches_count_no_flush_until_the_fetch():
    """A supervised many2many dispatch ends in the fetch of its own
    block, so each attempt is one dispatch AND one flush (as in the
    reference), and the blocks scatter into the result after
    ``run`` returns; without a supervisor nothing is counted."""
    from pwasm_tpu_torch.parallel.many2many import many2many_scores_ragged

    qs = [b"ACGTACGTAA", b"ACGTACGTAA", b"ACGTAC"]
    ts = [b"ACGTACGTAA", b"ACGTAC", b"ACGTACGTAAC"]
    cpu = torch.device("cpu")
    st = RunStats()
    sc: dict = {}
    got = many2many_scores_ragged(qs, ts, band=8, device=cpu, stats=sc,
                                  supervisor=BatchSupervisor(stats=st))
    assert np.array_equal(got, many2many_scores_ragged(qs, ts, band=8,
                                                       device=cpu))
    d = st.as_dict()["device"]
    assert d["by_site"] == {"many2many": sc["dispatches"]}
    assert d["flushes"] == d["dispatches"] == sc["dispatches"] >= 2


# ---------------------------------------------------------------------------
# trace-merge
# ---------------------------------------------------------------------------
def _doc(anchor, pid, names):
    rec = TraceRecorder(clock=_Clock())
    rec.anchor_wall_s = anchor
    rec._pid = pid
    for i, n in enumerate(names):
        rec.complete(n, 0.0, 0.5 + i)
    rec.instant("mark")
    return rec.to_dict()


def test_merge_traces_equals_the_reference():
    docs = [("client.json", _doc(100.25, 7, ["submit_rpc"])),
            ("daemon.json", _doc(100.75, 7, ["job_exec", "run"])),
            ("third.json", {"traceEvents": [{"name": "x", "ph": "i",
                                             "ts": 3, "pid": "p"}],
                            "otherData": {"dropped_events": 2}})]
    got = merge_traces(docs)
    assert got == ref_merge_traces(docs)
    assert json.dumps(got) == json.dumps(ref_merge_traces(docs))
    assert got["otherData"]["merged"] == 3
    assert len({e["pid"] for e in got["traceEvents"]}) == 3


# ---------------------------------------------------------------------------
# the CLI: the port and the reference on one small corpus
# ---------------------------------------------------------------------------
OBS_OUTS = ("dfa", "sum", "mfa", "cons")


def _write_corpus(d):
    q, lines = corpus.make_corpus(n_aln=12, cds_len=300, asm_lo=2000,
                                  asm_hi=5000)
    (d / "q.fa").write_text(f">cds1\n{q}\n")
    (d / "in.paf").write_text("".join(ln + "\n" for ln in lines))
    return str(d / "in.paf"), str(d / "q.fa")


def _argv(d, tag, paf, fa, device, flags):
    p = str(d / tag)
    argv = [paf, "-r", fa, "-o", f"{p}.dfa", "-s", f"{p}.sum",
            "-w", f"{p}.mfa", f"--cons={p}.cons", f"--device={device}",
            "--batch=4", f"--stats={p}.json"]
    if flags:
        argv += [f"--trace-json={p}.trace", f"--log-json={p}.ndjson",
                 f"--metrics-textfile={p}.prom"]
    return argv


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The corpus through the port at --device=cpu without and with every
    obs flag, and through the reference at --device=tpu with them."""
    d = tmp_path_factory.mktemp("obs_cli")
    paf, fa = _write_corpus(d)
    mp = pytest.MonkeyPatch()
    mp.setenv("PWASM_DEVICE_PROBE", "0")
    out = {}
    try:
        for tag, runner, device, flags in (
                ("off", run, "cpu", False), ("on", run, "cpu", True),
                ("ref", ref_run, "tpu", True)):
            err = io.StringIO()
            rc = runner(_argv(d, tag, paf, fa, device, flags), stderr=err)
            assert rc == 0, err.getvalue()[-2000:]
            out[tag] = err.getvalue()
    finally:
        mp.undo()
    return d, paf, fa, out


def _outs(d, tag):
    return tuple((d / f"{tag}.{ext}").read_bytes() for ext in OBS_OUTS)


def _keys(d, pre=""):
    out = set()
    for k, v in d.items():
        out.add(pre + k)
        if isinstance(v, dict) and k != "by_site":
            out |= _keys(v, pre + k + ".")
    return out


def test_cli_byte_parity_with_all_obs_flags(cli_runs):
    d, _paf, _fa, err = cli_runs
    assert _outs(d, "on") == _outs(d, "off") == _outs(d, "ref")
    on = json.loads((d / "on.json").read_text())
    off = json.loads((d / "off.json").read_text())
    assert _keys(on) == _keys(off)
    assert on["stats_version"] == off["stats_version"] == 1
    assert on["device"]["by_site"] == off["device"]["by_site"]
    assert f"pwasm: trace written to {d / 'on.trace'}" in err["on"]
    assert "trace written" not in err["off"]


def test_cli_metrics_textfile_matches_stats(cli_runs):
    d = cli_runs[0]
    text = (d / "on.prom").read_text()
    assert_valid_exposition(text)
    st = json.loads((d / "on.json").read_text())
    lines = text.splitlines()
    assert f"pwasm_run_alignments_total {st['alignments']}" in lines
    assert f"pwasm_run_events_total {st['events']}" in lines
    assert f"pwasm_device_dispatches_total {st['device']['dispatches']}" \
        in lines
    assert "pwasm_run_breaker_state 0" in lines
    assert 'pwasm_run_finished_total{outcome="completed"} 1' in lines
    for site, n in st["device"]["by_site"].items():
        assert (f'pwasm_run_batch_attempt_seconds_count{{site="{site}"}} '
                f"{n}") in lines
    host = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'pwasm_host_stage_seconds_total\{stage="(\w+)"\} (\S+)', text)}
    for k, v in st["host"].items():
        assert host.get(k[:-2], 0.0) == pytest.approx(v, abs=1e-5)
    assert [p.name for p in d.iterdir() if ".prom." in p.name] == []


def _sample_names(text):
    return sorted(re.split(r"[ ]", ln, maxsplit=1)[0]
                  for ln in text.splitlines() if not ln.startswith("#"))


def test_cli_exposition_matches_the_reference(cli_runs):
    d = cli_runs[0]
    port, ref = ((d / f"{t}.prom").read_text() for t in ("on", "ref"))
    assert _sample_names(port) == _sample_names(ref)
    skip = ("seconds", "wall", "fraction")
    vals = [{ln.rsplit(" ", 1)[0]: ln.rsplit(" ", 1)[1]
             for ln in t.splitlines()
             if not ln.startswith("#") and not any(s in ln for s in skip)}
            for t in (port, ref)]
    assert vals[0] == vals[1]
    assert "pwasm_checkpoints_total 0" not in port.splitlines()
    assert vals[0]["pwasm_checkpoints_total"] \
        == str(json.loads((d / "on.json").read_text())[
            "resilience"]["checkpoints"])


def _trace_shape(path):
    """(name, ph, innermost enclosing span, arg names) of every event,
    with device_batch's site/attempt/items values."""
    evs = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    shape = []
    for e in evs:
        parent = None
        if e["ph"] == "X":
            around = [o for o in spans if o is not e
                      and o["ts"] <= e["ts"]
                      and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
            if around:
                parent = min(around, key=lambda o: o["dur"])["name"]
        args = tuple(sorted(e["args"].items())) \
            if e["name"] == "device_batch" else tuple(sorted(e["args"]))
        shape.append((e["name"], e["ph"], parent, args))
    return shape


def test_cli_trace_matches_the_reference(cli_runs):
    d = cli_runs[0]
    port = _trace_shape(d / "on.trace")
    ref = _trace_shape(d / "ref.trace")
    assert Counter(port) == Counter(ref)
    names = {s[0] for s in port}
    assert {"run", "input_loop", "flush_submit", "flush_format",
            "device_batch", "msa_tail", "run_start", "ckpt_write",
            "run_finish"} <= names
    doc = json.loads((d / "on.trace").read_text())
    runs = [e for e in doc["traceEvents"] if e["name"] == "run"]
    assert len(runs) == 1
    r0, r1 = runs[0]["ts"], runs[0]["ts"] + runs[0]["dur"]
    for e in doc["traceEvents"]:
        assert isinstance(e["ts"], int) and e["ts"] >= 0
        if e["ph"] == "X" and e is not runs[0]:
            assert r0 <= e["ts"] and e["ts"] + e["dur"] <= r1, e
    assert isinstance(doc["otherData"]["anchor_wall_s"], float)


def test_cli_events_match_the_reference(cli_runs):
    d = cli_runs[0]
    evs = [[json.loads(ln) for ln in (d / f"{t}.ndjson").read_text()
            .splitlines()] for t in ("on", "ref")]
    shape = [[(e["event"], tuple(sorted(e))) for e in es] for es in evs]
    assert shape[0] == shape[1]
    ckpts = [e for e in evs[0] if e["event"] == "ckpt_write"]
    assert [e["event"] for e in evs[0]] \
        == ["run_start"] + ["ckpt_write"] * len(ckpts) + ["run_finish"]
    assert ckpts and ckpts[-1]["records"] == 12
    assert [(e["records"], e["batch"]) for e in ckpts] \
        == [(e["records"], e["batch"]) for e in evs[1]
            if e["event"] == "ckpt_write"]
    assert evs[0][-1]["rc"] == 0 and evs[0][-1]["alignments"] == 12
    assert evs[0][0]["device"] == "cpu"
    assert len({e["run_id"] for e in evs[0]}) == 1


def test_cli_log_json_stdout_dash(cli_runs, tmp_path):
    _d, paf, fa, _err = cli_runs
    out, err = io.StringIO(), io.StringIO()
    rc = run([paf, "-r", fa, "-o", str(tmp_path / "d.dfa"),
              "--log-json=-", "--device=cpu"], stdout=out, stderr=err)
    assert rc == 0, err.getvalue()
    evs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert evs[0]["event"] == "run_start"
    assert evs[-1]["event"] == "run_finish" and evs[-1]["rc"] == 0


@pytest.mark.parametrize("flag", ["--trace-json", "--log-json",
                                  "--metrics-textfile", "--stats",
                                  "--profile"])
def test_obs_flags_require_value(cli_runs, flag):
    _d, paf, fa, _err = cli_runs
    got = []
    for runner, dev in ((run, "cpu"), (ref_run, "cpu")):
        err = io.StringIO()
        got.append((runner([paf, "-r", fa, flag, f"--device={dev}"],
                           stderr=err), err.getvalue().splitlines()[-1]))
    assert got[0] == got[1] == (1, f"--{flag[2:]} requires a file "
                                   "argument")


@pytest.mark.parametrize("flag", ["--trace-max-events=0",
                                  "--log-json-max-bytes=x",
                                  "--trace-max-events"])
def test_obs_knobs_reject_bad_values(cli_runs, flag):
    _d, paf, fa, _err = cli_runs
    got = []
    for runner in (run, ref_run):
        err = io.StringIO()
        got.append((runner([paf, "-r", fa, flag, "--device=cpu"],
                           stderr=err), err.getvalue().splitlines()[-1]))
    assert got[0] == got[1]
    assert got[0][0] == 1 and got[0][1].startswith("Invalid --")


def test_log_json_dash_requires_report_file(cli_runs):
    _d, paf, fa, _err = cli_runs
    err = io.StringIO()
    assert run([paf, "-r", fa, "--log-json=-", "--device=cpu"],
               stderr=err) == 1
    assert "--log-json=- requires -o" in err.getvalue()


def test_log_json_appends_across_runs(cli_runs, tmp_path):
    _d, paf, fa, _err = cli_runs
    log = tmp_path / "runs.ndjson"
    for _ in range(2):
        err = io.StringIO()
        assert run([paf, "-r", fa, "-o", str(tmp_path / "a.dfa"),
                    f"--log-json={log}", "--device=cpu"],
                   stderr=err) == 0, err.getvalue()
    evs = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [e["event"] for e in evs].count("run_start") == 2
    assert len({e["run_id"] for e in evs}) == 2


def test_failed_run_finishes_its_timeline(cli_runs, tmp_path):
    """A run that exits non-zero still ends its event log and trace, and
    writes no --stats."""
    _d, paf, fa, _err = cli_runs
    bad = tmp_path / "bad.paf"
    bad.write_text(open(paf).read() + "q\t37\t0\n")
    err = io.StringIO()
    rc = run([str(bad), "-r", fa, "-o", str(tmp_path / "b.dfa"),
              f"--log-json={tmp_path / 'b.ndjson'}",
              f"--trace-json={tmp_path / 'b.trace'}",
              f"--stats={tmp_path / 'b.json'}", "--device=cpu"],
             stderr=err)
    assert rc != 0
    evs = [json.loads(ln) for ln in
           (tmp_path / "b.ndjson").read_text().splitlines()]
    assert evs[-1]["event"] == "run_finish" and evs[-1]["rc"] == rc
    assert evs[-1]["error"]
    names = {e["name"] for e in json.loads(
        (tmp_path / "b.trace").read_text())["traceEvents"]}
    assert "run" in names
    assert not (tmp_path / "b.json").exists()


def test_trace_merge_cli_equals_the_reference(cli_runs, tmp_path):
    d = cli_runs[0]
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    shutil.copy(d / "on.trace", a)
    shutil.copy(d / "ref.trace", b)
    err = io.StringIO()
    assert run(["trace-merge", str(a), str(b), "-o",
                str(tmp_path / "m.json")], stderr=err) == 0
    docs = [(p.name, json.loads(p.read_text())) for p in (a, b)]
    assert (tmp_path / "m.json").read_text() \
        == json.dumps(ref_merge_traces(docs))
    out = io.StringIO()
    assert run(["trace-merge", str(a), str(b)], stdout=out,
               stderr=io.StringIO()) == 0
    assert out.getvalue() == json.dumps(ref_merge_traces(docs)) + "\n"
    err = io.StringIO()
    assert run(["trace-merge"], stderr=err) == 1
    assert "at least one trace file is required" in err.getvalue()
