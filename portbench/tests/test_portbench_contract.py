"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file by the harness."""

import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
# the held cells (held/) have to meet the contract too, to be put back
HELD = harness.with_held(BENCH)
BOTH = pytest.mark.parametrize("bench", [BENCH, HELD],
                               ids=["benchmark", "with_held"])
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@BOTH
def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    assert len(names) == len(set(names))


@BOTH
def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        plan = harness.cell_plan(bench, w["name"])
        got = {m["name"] for m in plan.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert plan.per_layer
        for m in plan.per_layer:
            assert m["moves"] in got


@pytest.mark.parametrize("w", [w["name"] for w in HELD["workloads"]])
def test_files_found_by_name(w):
    plan = harness.cell_plan(HELD, w)
    for fn in ("make_inputs", "job_argv", "check", "controls",
               "control_runner", "kernel_work"):
        assert callable(getattr(plan.driver, fn))
    for m in plan.end_to_end + plan.per_layer:
        path = os.path.join(harness.HERE, "metrics", m["name"] + ".py")
        mod = harness.load_module(path, "m_" + m["name"].replace(".", "_"))
        assert callable(mod.read)


@BOTH
def test_config_files_under_paths(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("portbench/") and os.path.isfile(
            os.path.join(harness.ROOT, f))
