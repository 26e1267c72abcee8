"""The check against a broken timed path: each fault a cell can have,
and each control put in the program's place, turns ``correct`` false
through the whole harness, at tiny sizes on the CPU."""

import os
import threading

import pytest

from portbench import harness
from portbench.tests.tiny import run_tiny

BENCH = harness.with_held(harness.load_json(
    os.path.join(harness.ROOT, "BENCHMARK.json")))


def skip_job(run):
    """A job that returns rc 0 and writes nothing: the outputs on disk
    are the previous job's."""
    def runner(argv, stdout=None, stderr=None, warm=None, **kw):
        return 0
    return runner


def skip_every_second_job(run):
    """Every second job of the benchmark returns rc 0 and writes nothing;
    the others run: a job's outputs on disk may be an earlier job's."""
    n = [0]
    lock = threading.Lock()

    def runner(argv, stdout=None, stderr=None, warm=None, **kw):
        if any(a.startswith("--stats=") for a in argv):
            with lock:
                n[0] += 1
                skip = n[0] % 2 == 0
            if skip:
                return 0
        return run(argv, stdout=stdout, stderr=stderr, warm=warm, **kw)
    return runner


def half_batch(run):
    """A job that runs only the first half of its input's records."""
    def runner(argv, stdout=None, stderr=None, warm=None, **kw):
        argv = list(argv)
        paf = argv[0]
        if paf.endswith(".paf"):
            with open(paf) as f:
                lines = f.readlines()
            cut = paf[:-4] + ".half.paf"
            with open(cut, "w") as f:
                f.writelines(lines[:len(lines) // 2])
            argv[0] = cut
        else:
            # --many2many: half of the queries
            q = argv[argv.index("-r") + 1]
            with open(q) as f:
                recs = f.read().split(">")[1:]
            cut = q + ".half"
            with open(cut, "w") as f:
                f.write("".join(">" + r for r in recs[:len(recs) // 2]))
            argv[argv.index("-r") + 1] = cut
        return run(argv, stdout=stdout, stderr=stderr, warm=warm, **kw)
    return runner


def altered_answer(run):
    """A job whose first report row's last digit is changed where it is
    written."""
    def runner(argv, stdout=None, stderr=None, warm=None, **kw):
        rc = run(argv, stdout=stdout, stderr=stderr, warm=warm, **kw)
        out = argv[argv.index("-o") + 1]
        with open(out, "rb") as f:
            body = bytearray(f.read())
        for i in range(len(body) - 1, -1, -1):
            if chr(body[i]).isdigit():
                body[i] = ord("0") + (body[i] - ord("0") + 1) % 10
                break
        with open(out, "wb") as f:
            f.write(bytes(body))
        return rc
    return runner


CELLS = ["pafreport-report-c1", "m2m-config3-c1"]


@pytest.mark.parametrize("fault", [skip_job, skip_every_second_job,
                                   half_batch, altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_turns_correct_false(tmp_path, workload, fault):
    # a pool of one corpus: every job writes the same bytes to the same
    # paths, so a job that skips its write would find the last job's
    # outputs there unless the harness clears them first
    r = run_tiny(tmp_path, workload, runner_wrap=fault,
                 sizes={"pool": 1}, bench=BENCH)
    assert r["correct"] is False, r["checks"]


# each cell's controls, and the sizes at which a test run can hold them:
# the CDS long enough that an indel's stop codon can lie past 64 codons,
# and alignments long enough that some drift past the first band
SIZES = {"pafreport-msa-realign-c1": dict(
             n_aln=6, cds_len=1500, asm_lo=4000, asm_hi=6000, pool=1),
         "pafreport-report-c1": dict(
             n_aln=16, cds_len=900, asm_lo=3000, asm_hi=5000, pool=2),
         "m2m-config3-c1": dict(n_q=3, n_t=20, warm_queries=1)}
CONTROLS = [(w, name) for w in sorted(SIZES)
            for name in harness.cell_plan(BENCH, w).driver.controls(
                harness.cell_plan(BENCH, w).traffic)]


@pytest.mark.parametrize("workload,name", CONTROLS)
def test_control_fails(tmp_path, workload, name):
    """The control, in the program's place for every job of a run, turns
    the harness's own ``correct`` false on one of three seeds at least
    (at these sizes a seed's corpus may hold no case that the control
    gets wrong)."""
    plan = harness.cell_plan(BENCH, workload)
    cfg = dict(plan.config, **SIZES[workload])
    for seed in (21, 22, 23):
        d = tmp_path / str(seed)
        d.mkdir()
        wrap = plan.driver.control_runner(name, cfg, plan.traffic, seed,
                                          "cpu")
        r = run_tiny(d, workload, seed=seed, runner_wrap=wrap,
                     sizes=SIZES[workload], bench=BENCH)
        assert r["checks"]["jobs_failed"]["value"] == 0, r["checks"]
        if r["correct"] is False:
            return
    pytest.fail(f"{workload}'s control {name} read correct on three seeds")


@pytest.mark.chip
def test_cell_on_the_card(cuda_card, tmp_path):
    """A short run of the smallest cell on the card, as the driver runs
    it: a correct result line on a CUDA device."""
    import json
    import subprocess
    import sys
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "pafreport-report-c1", "--seed", "5", "--seconds", "5",
         "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
