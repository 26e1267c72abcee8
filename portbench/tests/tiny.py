"""Tiny copies of the benchmark's configurations for CPU runs of the
harness: the same files, with sizes that a test run can hold."""

import copy
import json
import os

from portbench import harness

TINY = {"cds1-nanopore": dict(n_aln=16, cds_len=240, asm_lo=3000,
                              asm_hi=5000, pool=2),
        "m2m-500x10k": dict(n_q=5, n_t=30, warm_queries=2)}


def tiny_bench(tmp_path, bench=None, sizes=None) -> dict:
    """BENCHMARK.json with each configuration file replaced by a tiny copy
    under ``tmp_path`` (``sizes`` over ``TINY`` for every configuration
    that has its keys)."""
    bench = copy.deepcopy(bench or harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        cfg.update(TINY.get(c["name"], {}))
        if sizes and set(sizes) <= set(cfg):
            cfg.update(sizes)
        p = os.path.join(str(tmp_path), c["name"] + ".json")
        with open(p, "w") as f:
            json.dump(cfg, f)
        c["file"] = p
    return bench


def run_tiny(tmp_path, workload, seed=7, seconds=1.0, trace=False,
             runner_wrap=None, bench=None, sizes=None) -> dict:
    """One CPU run of ``workload`` at tiny sizes; the result object."""
    import time
    os.environ["TMPDIR"] = str(tmp_path)
    harness.prepare_env()
    return harness.run_cell(workload, seed, seconds, trace,
                            time.monotonic(), device="cpu",
                            runner_wrap=runner_wrap,
                            bench=tiny_bench(tmp_path, bench, sizes))
