"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

A run makes the cell's inputs from the seed, starts the port's warm-pool
daemon (``pwasm_tpu_torch.service.daemon.Daemon``) in this process,
warms every lane with one job of the cell's own traffic, then lets the
cell's clients (``ServiceClient`` threads, closed loops) submit jobs for
``--seconds``.  A job still running when the window closes runs to its
end and counts whole: each client's window ends with its last job, and a
rate is the sum over clients of the work a client completed over its
own window.  With ``--trace 1`` a ``torch.profiler`` session spans the
window, so it holds every kernel of exactly the window's jobs.  After
the window the daemon drains, the device memory peak is read, and the
configuration's plain reference judges what the jobs wrote.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json`` with its driver
``reference/<config>.py``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.  Nothing here names a cell.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import sys
import threading
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "pwasm_tpu")


class HarnessError(Exception):
    """A run that cannot give a result (exit 1, no result line)."""


def load_module(path: str, name: str):
    """A module from a file of the benchmark, by path (names may hold
    dots and dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise HarnessError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def with_held(bench: dict) -> dict:
    """``bench`` with the entries of every cell held out of it under
    ``held/`` (a cell that a later PR puts back by copying its entries
    into ``BENCHMARK.json``): for the tests and ``control.py``; a run of
    the benchmark never sees a held cell."""
    out = {k: list(v) if isinstance(v, list) else v
           for k, v in bench.items()}
    held = os.path.join(HERE, "held")
    for fn in sorted(os.listdir(held)) if os.path.isdir(held) else []:
        h = load_json(os.path.join(held, fn))
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            out[key] += h.get(key, [])
    return out


def cell_plan(bench: dict, workload: str) -> SimpleNamespace:
    """The cell named ``workload``: its entry, configuration, traffic mix,
    driver, and the metrics it reports at each trace level, all found by
    name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise HarnessError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    driver = load_module(os.path.join(HERE, "reference",
                                      w["config"] + ".py"),
                         "portbench_driver_" + w["config"].replace("-", "_"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return SimpleNamespace(name=workload, entry=w, config=cfg,
                           traffic=traffic, driver=driver,
                           end_to_end=e2e, per_layer=layer)


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(1 << 22)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


class Client(threading.Thread):
    """One closed-loop client: submits its next job when the last one
    returns, until ``stop_at`` (monotonic) has passed."""

    def __init__(self, idx: int, sock: str, plan, inputs, outdir: str,
                 start: threading.Event, stop_at: list, records: list,
                 job_source):
        super().__init__(name=f"portbench-client-{idx}", daemon=True)
        self.idx, self.sock, self.plan = idx, sock, plan
        self.inputs, self.outdir = inputs, outdir
        self.start_ev, self.stop_at = start, stop_at
        self.records = records
        self.job_source = job_source
        self.error: BaseException | None = None
        self.begin = self.end = None

    def run(self) -> None:
        from pwasm_tpu_torch.service.client import ServiceClient
        try:
            with ServiceClient(self.sock) as c:
                self.start_ev.wait()
                self.begin = time.monotonic()
                while time.monotonic() < self.stop_at[0]:
                    self.records.append(run_job(
                        c, self.plan, self.inputs, self.outdir, self.idx,
                        self.job_source()))
                self.end = time.monotonic()
        except BaseException as e:    # reported by the main thread
            self.error = e


def run_job(client, plan, inputs, outdir: str, idx: int, k: int,
            warm: bool = False) -> dict:
    """Submit job ``k`` of the cell's job sequence and wait for it: the
    record of its client wall, its verdict, its ``--stats`` and the
    digest of each output it wrote.  ``warm`` asks the driver for its
    warm-up job (``warm_argv``) where it has one."""
    make = getattr(plan.driver, "warm_argv", None) if warm else None
    argv, outputs, key, work = (make or plan.driver.job_argv)(
        plan.config, plan.traffic, inputs, k, outdir)
    stats_path = os.path.join(outdir, "stats.json")
    argv = argv + [f"--stats={stats_path}"]
    # what an earlier job left at these paths goes first: a job that
    # writes nothing reads as missing, never as the last job's outputs
    for path in [*outputs.values(), stats_path]:
        if os.path.exists(path):
            os.unlink(path)
    t0 = time.monotonic()
    sub = client.submit(argv, cwd=outdir)
    if not sub.get("ok"):
        raise HarnessError(f"submit refused: {sub}")
    res = client.result(sub["job_id"], wait=True)
    t1 = time.monotonic()
    rc = res.get("rc")
    digests = {}
    if rc == 0:
        for name, path in outputs.items():
            digests[name] = file_digest(path) if os.path.exists(path) \
                else None
    return dict(client=idx, k=k, key=key, work=work, t_submit=t0,
                t_done=t1, wall_s=t1 - t0, rc=rc,
                stats=res.get("stats") or {}, digests=digests,
                detail=None if rc == 0 else str(res)[-2000:])


class Daemon:
    """The port's daemon in a thread of this process."""

    def __init__(self, work: str, clients: int, device: str, runner_wrap,
                 log_path: str):
        from pwasm_tpu_torch.service.daemon import Daemon as PortDaemon
        self.sock = os.path.join(work, "svc.sock")
        self.log = open(log_path, "w")
        warmup = "cuda" if device == "cuda" else None
        runner = None
        if runner_wrap is not None:
            from pwasm_tpu_torch.cli import run as cli_run
            runner = runner_wrap(cli_run)
        self.d = PortDaemon(self.sock, max_concurrent=clients,
                            warmup=warmup,
                            compile_cache_dir=os.path.join(CACHE, "build"),
                            stderr=self.log, runner=runner)
        self.rc = None
        self.t = threading.Thread(target=self._serve, name="portbench-svc",
                                  daemon=True)

    def _serve(self) -> None:
        self.rc = self.d.serve()

    def start(self, budget_s: float = 600.0) -> None:
        """Serve, and return once the socket is bound.  The daemon's
        warmup job holds a lane until it is done, so the warm round's
        first job waits for it: set-up ends after both."""
        self.t.start()
        deadline = time.monotonic() + budget_s
        while not os.path.exists(self.sock):
            if not self.t.is_alive() or time.monotonic() > deadline:
                raise HarnessError("the daemon did not bind its socket")
            time.sleep(0.02)

    def stop(self) -> None:
        self.d.drain.request("benchmark window closed")
        self.t.join(120.0)
        self.log.close()
        if self.t.is_alive():
            raise HarnessError("the daemon did not stop")


def start_profiler(device: str):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def read_trace(prof, work: str) -> dict:
    """The traced window's device intervals (kernels, copies, sets) and
    host op intervals, from the profiler's Chrome trace."""
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.unlink(path)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        iv = (float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6,
              str(e.get("name", "")))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(iv + (cat,))
        elif cat in ("cpu_op", "cuda_runtime", "python_function",
                     "user_annotation"):
            host.append(iv)
    return dict(device=dev, host=host)


def union_seconds(intervals) -> float:
    total, end = 0.0, None
    for s, d in sorted((iv[0], iv[1]) for iv in intervals):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def breakdown(trace: dict, t0: float, t1: float) -> dict:
    """The device operations that took most time, and the longest idle
    gaps on the device named by the host op that overlapped them most."""
    by = {}
    for s, d, name, _cat in trace["device"]:
        name = short_name(name)
        by[name] = by.get(name, 0.0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    ivs = sorted((s, s + d) for s, d, _n, _c in trace["device"])
    gaps, end = [], t0
    for s, e in ivs:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = sorted(trace["host"])
    named = []
    for a, b in gaps:
        best, over = "host outside torch ops", 0.0
        for s, d, name in host:
            if s > b:
                break
            o = min(b, s + d) - max(a, s)
            if o > over:
                best, over = name, o
        named.append([best, b - a])
    return dict(device_ops=[[n, v] for n, v in ops], idle_gaps=named)


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list, its
    template arguments cut to 80 characters."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut]
    return name if len(name) <= 120 else name[:117] + "..."


def check_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device: str, chips: int) -> dict:
    import torch
    if device != "cuda":
        return dict(platform="cpu", kind="cpu", count=chips,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips,
                memory_peak_bytes=max(torch.cuda.max_memory_allocated(i)
                                      for i in range(chips)))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", runner_wrap=None,
             bench: dict | None = None, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result object (the last line
    a run prints).  ``device="cpu"`` serves the harness's own tests;
    ``runner_wrap`` (a function of the port's runner returning the runner
    the daemon calls) puts a fault or a control in the program's place,
    for those tests and ``control.py``."""
    if bench is None:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    plan = cell_plan(bench, workload)
    chips = int(plan.entry["chips"])
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise HarnessError(
            f"{workload} needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    work = os.environ["PORTBENCH_WORK"]
    t_in = time.monotonic()
    inputs = plan.driver.make_inputs(plan.config, plan.traffic, seed,
                                     os.path.join(work, "inputs"), device)
    say(log, f"inputs made in {time.monotonic() - t_in:.3f} s "
        f"(process start to here {time.monotonic() - t_start:.3f} s)")
    n_clients = int(plan.traffic["clients"])
    outdirs = []
    for c in range(n_clients):
        d = os.path.join(work, f"client{c}")
        os.makedirs(d, exist_ok=True)
        outdirs.append(d)
    daemon = Daemon(work, n_clients, device, runner_wrap,
                    os.path.join(work, "daemon.log"))
    records: list = []
    lock = threading.Lock()
    counter = [0]

    def job_source() -> int:
        with lock:
            counter[0] += 1
            return counter[0] - 1

    try:
        t_d = time.monotonic()
        daemon.start()
        say(log, f"daemon serving in {time.monotonic() - t_d:.3f} s")
        t_w = time.monotonic()
        # warm every lane with the cell's own shapes: one job a client,
        # all at once, from the start of the job sequence
        warm = warm_round(daemon.sock, plan, inputs, outdirs, job_source)
        say(log, f"daemon warmup and warm round of {len(warm)} jobs in "
            f"{time.monotonic() - t_w:.3f} s")
        bad = [r for r in warm if r["rc"] != 0]
        if bad:
            raise HarnessError(f"a warm-up job failed: {bad[0]['detail']}")
        start = threading.Event()
        stop_at = [float("inf")]
        clients = [Client(c, daemon.sock, plan, inputs, outdirs[c], start,
                          stop_at, records, job_source)
                   for c in range(n_clients)]
        for c in clients:
            c.start()
        prof = start_profiler(device) if trace else None
        t0 = time.monotonic()
        setup_s = t0 - t_start
        stop_at[0] = t0 + seconds
        start.set()
        for c in clients:
            c.join()
        t_end = time.monotonic()
        for c in clients:
            if c.error is not None:
                raise c.error
        trace_data = None
        if prof is not None:
            if device == "cuda":
                torch.cuda.synchronize()
            prof.stop()
            trace_data = read_trace(prof, work)
            # the profiler's clock: the window is the span from the
            # first to the last op it recorded, stretched to the host
            # window's length where that is longer
            stamps = [s for s, _d, _n in trace_data["host"]] + \
                [s for s, _d, _n, _c in trace_data["device"]]
            ends = [s + d for s, d, _n in trace_data["host"]] + \
                [s + d for s, d, _n, _c in trace_data["device"]]
            tr0 = min(stamps) if stamps else 0.0
            tr1 = max(max(ends) if ends else 0.0, tr0 + (t_end - t0))
            trace_data.update(t0=tr0, t1=tr1, window_s=t_end - t0,
                              busy_s=union_seconds(trace_data["device"]))
    finally:
        daemon.stop()
    dev = device_info(device, chips)
    if device == "cuda":
        torch.cuda.empty_cache()
    client_ends = {c.idx: c.end for c in clients}
    client_begins = {c.idx: c.begin for c in clients}
    for c in clients:
        walls = [round(r["wall_s"], 2) for r in records if r["client"] == c.idx]
        say(log, f"client {c.idx}: {len(walls)} jobs, walls {walls}")
    ctx = SimpleNamespace(plan=plan, inputs=inputs, records=records,
                          t0=t0, t_end=t_end, client_ends=client_ends,
                          client_begins=client_begins,
                          seconds=seconds, setup_s=setup_s,
                          trace=trace_data, device=device,
                          peaks=load_json(os.path.join(HERE, "peaks.json")))
    say(log, f"window: {len(records)} jobs, {t_end - t0:.3f} s; setup "
        f"{setup_s:.3f} s")
    t_c = time.monotonic()
    checks = plan.driver.check(plan.config, plan.traffic, inputs, records,
                               seed, device, outdirs)
    say(log, f"check in {time.monotonic() - t_c:.3f} s")
    failed = sum(1 for r in records if r["rc"] != 0)
    # the stated guarantee, job by job: rc 0 means every output on disk
    missing = sum(1 for r in records if r["rc"] == 0
                  for d in r["digests"].values() if d is None)
    checks[:0] = [("jobs_failed", failed, 0), ("outputs_missing", missing, 0)]
    correct = all(v <= lim for _n, v, lim in checks) and bool(records)
    metrics = {}
    for m in (plan.per_layer if trace else plan.end_to_end):
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "portbench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        dev.update(busy_s=trace_data["busy_s"],
                   window_s=trace_data["window_s"])
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown(trace_data, trace_data["t0"],
                                        trace_data["t1"])
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result


def say(log, msg: str) -> None:
    print(f"portbench: {msg}", file=log, flush=True)


def warm_round(sock: str, plan, inputs, outdirs, job_source) -> list:
    """One job a client, all clients at once; their records."""
    from pwasm_tpu_torch.service.client import ServiceClient
    out: list = []
    errors: list = []

    def one(c: int) -> None:
        try:
            with ServiceClient(sock) as cl:
                out.append(run_job(cl, plan, inputs, outdirs[c], c,
                                   job_source(), warm=True))
        except BaseException as e:
            errors.append(e)

    ts = [threading.Thread(target=one, args=(c,), daemon=True)
          for c in range(len(outdirs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return out


def prepare_env() -> str:
    """The run's directories: a work directory at a fixed path under
    ``TMPDIR`` (under the checkout when none is set), emptied first, that
    the program's own temporary files go under; the kernel caches at
    fixed paths inside the checkout."""
    base = os.environ.get("TMPDIR") or os.path.join(HERE, ".work")
    work = os.path.join(os.path.abspath(base), "portbench-run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "tmp"), exist_ok=True)
    os.environ["PORTBENCH_WORK"] = work
    os.environ["TMPDIR"] = os.path.join(work, "tmp")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ["USE_FLAX"] = "0"
    import tempfile
    tempfile.tempdir = None
    return work


def main(argv: list[str], t_start: float) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    work = prepare_env()
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                          t_start)
    except HarnessError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = check_modules()
    if bad:
        print(f"portbench: modules loaded that the benchmark may not load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
