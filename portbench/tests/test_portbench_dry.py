"""The harness's dry path: every cell, and a cell made only of new
files, run through the daemon and the reference on the CPU at tiny
sizes."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.tiny import run_tiny


HELD = harness.with_held(harness.load_json(
    os.path.join(harness.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("workload", [w["name"] for w in HELD["workloads"]])
def test_cell_runs_correct(tmp_path, workload):
    """Every cell, and every cell held out of BENCHMARK.json under
    ``held/``, runs correct through the harness.  The window holds two
    jobs or more even on a loaded host, so that each corpus of a tiny
    pool of two has a finished job for the check to sample."""
    r = run_tiny(tmp_path, workload, seconds=4.0, bench=HELD)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_traced_run_reports_host_layer_metrics(tmp_path):
    r = run_tiny(tmp_path, "pafreport-report-c1", trace=True)
    assert r["correct"]
    assert "ctx_scan_ms.pafreport" in r["metrics"]
    assert "setup_s" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_cell_from_new_files_only(tmp_path):
    """A copy of the benchmark's folder gains a traffic mix, a metric and
    a cell that names them, and nothing else: the harness runs it."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", ".work",
                                                  "__pycache__"))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    (root / "portbench" / "traffic" / "report-o-c1.json").write_text(
        json.dumps({"clients": 1, "loop": "closed", "outputs": ["o"],
                    "flags": [], "check_sample": 1}))
    (root / "portbench" / "metrics" / "jobs_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records))\n")
    bench["workloads"].append(
        {"name": "pafreport-o-c1", "config": "cds1-nanopore",
         "traffic": "report-o-c1", "chips": 1, "why": "one client"})
    bench["per_layer"].append(
        {"name": "jobs_done", "unit": "jobs", "better": "higher",
         "source": "host_clock", "layer": "service", "moves": "aln_per_s",
         "workloads": ["pafreport-o-c1"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "pafreport-report-c1" in m["workloads"]:
            m["workloads"].append("pafreport-o-c1")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, os, sys, time
sys.path.insert(0, {str(root)!r})
sys.path.insert(1, {harness.ROOT!r})
from portbench import harness
assert harness.HERE == {str(root / 'portbench')!r}, harness.HERE
from portbench.tests.tiny import tiny_bench
os.environ["TMPDIR"] = {str(tmp_path)!r}
harness.prepare_env()
bench = tiny_bench({str(tmp_path)!r}, harness.load_json({str(root / 'BENCHMARK.json')!r}))
for trace in (False, True):
    r = harness.run_cell("pafreport-o-c1", 3, 0.5, trace,
                         time.monotonic(), device="cpu", bench=bench)
    print(json.dumps(r))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert "aln_per_s" in plain["metrics"]
    assert traced["metrics"]["jobs_done"]["value"] >= 1
