"""Run a cell with a correctness control in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 5]

For each seed and each control of the cell's configuration driver
(``controls``), one whole run of the cell through the harness, the
daemon and the check, at the cell's own size, with the daemon's runner
wrapped by the driver's ``control_runner``: the plain reference put in
the program's place in a variant that a later change would be tempted
to take (a narrower arithmetic, or a step that breaks a guarantee the
configuration states).  One JSON line a run: ``correct`` has to read
false.  The benchmark's own runs never run this; the limits in
``PERF.md`` are set from its readings.
"""

import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def main(argv):
    import argparse
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    base = os.environ.get("TMPDIR")
    bench = harness.with_held(harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json")))
    plan = harness.cell_plan(bench, a.workload)
    for seed in (int(x) for x in a.seeds.split(",")):
        for name in plan.driver.controls(plan.traffic):
            if base is not None:
                os.environ["TMPDIR"] = base
            work = harness.prepare_env()
            t0 = time.monotonic()
            try:
                r = harness.run_cell(
                    a.workload, seed, a.seconds, False, t0,
                    device=a.device, bench=bench,
                    runner_wrap=plan.driver.control_runner(
                        name, plan.config, plan.traffic, seed, a.device))
            finally:
                shutil.rmtree(work, ignore_errors=True)
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "control": name, "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": r["checks"],
                              "seconds": time.monotonic() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
