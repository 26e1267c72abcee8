"""The port's stage table: one span a job stage, timed once, and every
view read from it.

``obs.Observability.span`` times each stage of a run (``cli.py::
_main_loop``) once and feeds the trace, the flight record and the run's
``StageTable``; the ``stages`` block of ``--stats``, ``host.*_s``,
``device.compile_s``/``steady_s`` and ``cli.run``'s ``stats["times"]``
are read from the table, and under a ``torch.profiler`` session each
span is also a ``record_function`` range, which ``trace-merge`` lines up
with the ``--trace-json`` span on one wall axis.
"""

import io
import json
import threading
import time

import pytest

from pwasm_tpu_torch import corpus
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.obs import Observability, StageTable, make_observability
from pwasm_tpu_torch.obs.merge import merge_traces, trace_anchor
from pwasm_tpu_torch.obs.tracing import TraceRecorder

# the stages a -o -s -w --ace --info --cons --realign run times; the
# set-up before run is in the stage table, not in the trace
TRACED = ("run", "input_loop", "extract", "flush_submit", "flush_format",
          "checkpoint", "realign", "realign_gaps", "msa_merge", "msa_tail",
          "consensus", "refine", "write", "device_batch")
STAGES = ("setup",) + TRACED
# the stages directly under run
TOP = ("input_loop", "msa_tail", "write")


def _inputs(d, n_aln=16):
    q, lines = corpus.make_corpus(n_aln=n_aln, cds_len=300, asm_lo=2000,
                                  asm_hi=5000)
    (d / "q.fa").write_text(f">cds1\n{q}\n")
    (d / "in.paf").write_text("".join(ln + "\n" for ln in lines))
    return str(d / "in.paf"), str(d / "q.fa")


def _argv(d, paf, fa, tag, *extra):
    p = str(d / tag)
    return [paf, "-r", fa, "-o", f"{p}.dfa", "-s", f"{p}.sum",
            "-w", f"{p}.mfa", f"--ace={p}.ace", f"--info={p}.info",
            f"--cons={p}.cons", "--realign", "--batch=8", "--device=cpu",
            f"--stats={p}.json", *extra]


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """One run with every output, ``--realign``, ``--trace-json`` and
    ``--profile``: (dir, its --stats, cli.run's stats)."""
    d = tmp_path_factory.mktemp("stages")
    paf, fa = _inputs(d)
    stats: dict = {}
    err = io.StringIO()
    assert run(_argv(d, paf, fa, "a", f"--trace-json={d / 'a.trace'}",
                     f"--profile={d / 'prof'}"),
               stderr=err, stats=stats) == 0, err.getvalue()[-2000:]
    return d, json.loads((d / "a.json").read_text()), stats


def test_stats_carry_every_stage(staged):
    _d, st, _s = staged
    stages = st["stages"]
    assert set(stages) == set(STAGES)
    for name, row in stages.items():
        assert set(row) >= {"s", "self_s", "n", "items"}, name
        assert 0 <= row["self_s"] <= row["s"], name
        assert row["n"] >= 1, name
    assert stages["setup"]["n"] == stages["run"]["n"] == 1
    assert stages["input_loop"]["n"] == stages["msa_tail"]["n"] == 1
    # the items a stage handled: every alignment extracted, reported,
    # re-aligned and merged once
    n = st["alignments"]
    for name in ("extract", "flush_submit", "flush_format", "checkpoint",
                 "realign", "realign_gaps", "msa_merge"):
        assert stages[name]["items"] == n, name
    assert stages["consensus"]["items"] == n + 1     # the members + query
    # the set-up and the run are the job's wall, one after the other
    assert stages["setup"]["s"] + stages["run"]["s"] <= st["wall_s"] + 1e-3


def test_run_is_its_top_level_stages_and_its_self_seconds(staged):
    """run's children in the trace are the top-level stages, and their
    seconds are run's seconds less its self seconds."""
    d, st, _s = staged
    evs = [e for e in json.loads((d / "a.trace").read_text())[
        "traceEvents"] if e["ph"] == "X"]
    (r,) = [e for e in evs if e["name"] == "run"]
    inner = [e for e in evs if e is not r]

    def parent(e):
        around = [o for o in evs if o is not e and o["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        return min(around, key=lambda o: o["dur"]) if around else None

    top = [e for e in inner if parent(e) is r]
    assert {e["name"] for e in top} == set(TOP)
    run_row = st["stages"]["run"]
    assert run_row["s"] - run_row["self_s"] == pytest.approx(
        sum(e["dur"] for e in top) / 1e6, abs=1e-5 * len(top))


def test_one_timer_feeds_every_view(staged):
    _d, st, stats = staged
    stages, host, dev = st["stages"], st["host"], st["device"]
    fmt = stages["flush_format"]["s"] + stages["checkpoint"]["s"]
    assert stages["flush_submit"]["s"] + fmt \
        == pytest.approx(host["analyze_s"] + host["format_s"], abs=2e-6)
    assert stages["flush_submit"]["s"] == host["analyze_s"]
    assert fmt == pytest.approx(host["format_s"], abs=2e-6)
    assert stages["extract"]["s"] == host["extract_s"]
    assert dev["compile_s"] + dev["steady_s"] \
        == pytest.approx(stages["device_batch"]["s"], abs=2e-6)
    assert stages["device_batch"]["n"] == dev["dispatches"]
    times = stats["times"]
    assert list(times) == ["parse_extract", "ctx_scan", "msa_merge",
                           "consensus", "refine", "write", "realign"]
    for name in ("msa_merge", "consensus", "refine", "write", "realign"):
        assert times[name] == pytest.approx(stages[name]["s"], abs=1e-6)
    assert times["ctx_scan"] == pytest.approx(
        host["analyze_s"] + host["format_s"], abs=2e-6)
    assert times["parse_extract"] == pytest.approx(
        host["parse_s"] + host["extract_s"], abs=2e-6)


def test_realign_counts_its_lanes(staged):
    _d, st, _s = staged
    row = st["stages"]["realign"]
    assert 0 < row["lanes_done"] <= row["lane_dispatches"]
    assert row["lanes_done"] <= st["realigned"]


def test_band_escalation_shows_as_lost_lanes(tmp_path):
    """At --band=1 most lanes miss their end diagonal and are launched
    again at a wider band: dispatches exceed the lanes resolved."""
    paf, fa = _inputs(tmp_path, n_aln=8)
    err = io.StringIO()
    assert run(_argv(tmp_path, paf, fa, "b", "--band=1"),
               stderr=err) == 0, err.getvalue()[-2000:]
    row = json.loads((tmp_path / "b.json").read_text())["stages"]["realign"]
    assert row["lanes_done"] < row["lane_dispatches"]
    assert row["items"] == 8


def test_profile_carries_the_stages(staged):
    d, _st, _s = staged
    doc = json.loads((d / "prof" / "trace.json").read_text())
    ann = [e for e in doc["traceEvents"]
           if e.get("cat") == "user_annotation"]
    assert set(TRACED) <= {e["name"] for e in ann}
    assert sum(e["name"] == "run" for e in ann) == 1


def test_trace_merge_lines_spans_up_with_the_profile(staged, tmp_path):
    d, st, _s = staged
    out = tmp_path / "m.json"
    err = io.StringIO()
    assert run(["trace-merge", str(d / "a.trace"),
                str(d / "prof" / "trace.json"), "-o", str(out)],
               stderr=err) == 0, err.getvalue()
    assert "no wall-clock anchor" not in err.getvalue()
    evs = json.loads(out.read_text())["traceEvents"]
    spans = [e for e in evs if e.get("ph") == "X" and "cat" not in e]
    ann = [e for e in evs if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in spans} == set(TRACED)
    starts = []
    for e in spans:
        twin = min((a for a in ann if a["name"] == e["name"]),
                   key=lambda a: abs(a["ts"] - e["ts"]))
        d0 = twin["ts"] - e["ts"]
        d1 = twin["ts"] + twin["dur"] - e["ts"] - e["dur"]
        starts.append(d0)
        # each span sits on its twin within 1 ms at one edge at least:
        # the other edge's two clock reads are apart by whatever time the
        # OS took the thread away between them (milliseconds on a loaded
        # host), which is no fault of the merge
        assert min(abs(d0), abs(d1)) <= 1000, (e["name"], d0, d1)
    # and the merge lines the documents up: their starts agree within 1 ms
    starts.sort()
    assert abs(starts[len(starts) // 2]) <= 1000


def test_profile_anchor():
    prof = {"traceEvents": [{"name": "k", "ph": "X", "ts": 10.5,
                             "dur": 2.0, "pid": 1, "tid": 1}],
            "baseTimeNanoseconds": 1_700_000_000_250_000_000}
    spans = {"traceEvents": [{"name": "s", "ph": "X", "ts": 7, "dur": 1,
                              "pid": 1, "tid": 2}],
             "otherData": {"anchor_wall_s": 1_700_000_000.0}}
    assert trace_anchor(prof) == pytest.approx(1_700_000_000.25)
    assert trace_anchor({"traceEvents": []}) is None
    got = merge_traces([("t.json", spans), ("p.json", prof)])
    by = {e["name"]: e for e in got["traceEvents"] if e["ph"] == "X"}
    assert by["s"]["ts"] == 7
    assert by["k"]["ts"] == pytest.approx(250_010.5)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_span_nesting_self_seconds_and_counters():
    clk = _Clock()
    table = StageTable()
    obs = Observability(tracer=TraceRecorder(clock=clk), stages=table)
    with obs.span("run") as r:
        clk.t += 1.0
        with obs.span("a", n=3):
            clk.t += 2.0
            with obs.span("b", items=5):
                clk.t += 4.0
            obs.tally(lanes=7)
        clk.t += 0.5
        with obs.span("a", n=1):
            clk.t += 1.0
        # the run is open: counted with its time so far
        open_view = obs.stages_dict()
    assert r.dur_s == 8.5
    assert open_view["run"] == {"s": 8.5, "self_s": 1.5, "n": 1,
                                "items": 0}
    got = table.as_dict()
    assert got["a"] == {"s": 7.0, "self_s": 3.0, "n": 2, "items": 4,
                        "lanes": 7}
    assert got["b"] == {"s": 4.0, "self_s": 4.0, "n": 1, "items": 5}
    assert got["run"]["self_s"] == 1.5
    names = [e["name"] for e in obs.tracer.to_dict()["traceEvents"]]
    assert names == ["b", "a", "a", "run"]


def test_threads_keep_their_own_stacks():
    obs = make_observability()
    gate = threading.Barrier(2)

    def work():
        with obs.span("lane"):
            gate.wait()
            time.sleep(0.01)

    t = threading.Thread(target=work)
    with obs.span("main"):
        t.start()
        gate.wait()
        t.join()
    got = obs.stages_dict()
    # the lane's span is not main's child: main's self seconds are whole
    assert got["main"]["self_s"] == got["main"]["s"]
    assert got["lane"]["n"] == 1


def test_span_is_a_range_under_an_all_threads_profile(tmp_path):
    """A profile of every thread records the spans of a thread that was
    running before it started, as a served job's lane is: the gate is
    the process-wide profiler flag."""
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile
    try:
        from torch.profiler import _ExperimentalConfig
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pytest.skip("this torch has no all-threads profiling")
    obs = make_observability()
    go, done = threading.Event(), threading.Event()

    def lane():
        go.wait()
        with obs.span("lane_stage"):
            torch.ones(4).sum()
        done.set()

    t = threading.Thread(target=lane)
    t.start()
    prof = profile(activities=[ProfilerActivity.CPU],
                   experimental_config=cfg)
    prof.start()
    try:
        with obs.span("main_stage"):
            go.set()
            done.wait(10)
    finally:
        prof.stop()
    t.join()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"main_stage", "lane_stage"} <= names
    assert obs.stages_dict()["lane_stage"]["n"] == 1
