"""The port's self-monitoring against the JAX package's, on the CPU.

- ``obs/slo.py``: the same seeded metric samples and clock values fed
  to the port's engine and the reference's, each over its own registry:
  every evaluation's verdict (firing list, values, details), the
  transition events and the registries' expositions (the firing gauges
  and transition counters among them) equal, for every rule kind; the
  grammar's errors, the default sets, the merge by name, the rules
  file and the verdict helpers equal.
- ``obs/logquery.py``: equal records on one rotated log, per filter.
- The canary, ``health``, ``logs`` and ``top`` on an in-process port
  daemon (``tests/test_slo.py``'s stubbed runner where the test is
  about the monitor, the port's ``cli.run`` at ``--device=cpu`` where
  it is about the jobs), and both packages' daemons with the engine on
  held to each other.  The router cases of ``tests/test_slo.py`` wait
  for the port's fleet router.
"""

import io
import json
import os
import random
import shutil
import tempfile
import threading
import time
from contextlib import contextmanager
from types import SimpleNamespace

import pytest

from pwasm_tpu.obs import catalog as ref_catalog
from pwasm_tpu.obs import logquery as ref_logquery
from pwasm_tpu.obs import slo as ref_slo
from pwasm_tpu.obs.metrics import MetricsRegistry as RefRegistry
from pwasm_tpu.service import canary as ref_canary
from pwasm_tpu.service import top as ref_top
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.obs import catalog, logquery, slo
from pwasm_tpu_torch.obs.metrics import MetricsRegistry
from pwasm_tpu_torch.service import canary, top
from pwasm_tpu_torch.service.client import (ServiceClient, client_main,
                                            wait_for_socket)
from pwasm_tpu_torch.service.daemon import Daemon, serve_main

SIDES = {"port": (slo, MetricsRegistry, catalog),
         "ref": (ref_slo, RefRegistry, ref_catalog)}


# ---------------------------------------------------------------------------
# the engine, fed the same samples on both sides
# ---------------------------------------------------------------------------
class _Side:
    """One package's engine over its own registry, with the scenario's
    metric families declared."""

    def __init__(self, side: str, families, rules):
        mod, reg_cls, cat = SIDES[side]
        self.reg = reg_cls()
        self.fam = {}
        for kind, name, arg in families:
            if kind == "gauge":
                self.fam[name] = self.reg.gauge(name, "h", labels=arg)
            elif kind == "counter":
                self.fam[name] = self.reg.counter(name, "h", labels=arg)
            else:
                self.fam[name] = self.reg.histogram(name, "h", buckets=arg)
        self.events: list = []
        self.eng = mod.SloEngine(
            self.reg, rules, metrics=cat.build_slo_metrics(self.reg),
            on_event=lambda ev, **f: self.events.append((ev, f)),
            eval_interval_s=0.01)

    def apply(self, op) -> None:
        verb, name, val, kw = op
        m = self.fam[name]
        if verb == "set":
            m.set(val, **kw)
        elif verb == "inc":
            m.inc(val, **kw)
        else:
            m.observe(val, **kw)


def _drive(families, rules, steps):
    """Run ``steps`` (``(now, [op, ...])``) on both engines; every
    evaluation, the events and the expositions must be equal.  Returns
    the port's verdicts."""
    port, ref = (_Side(s, families, [dict(r) for r in rules])
                 for s in ("port", "ref"))
    verdicts = []
    for now, ops in steps:
        for op in ops:
            port.apply(op)
            ref.apply(op)
        got, want = port.eng.evaluate(now=now), ref.eng.evaluate(now=now)
        assert got == want, (now, got, want)
        verdicts.append(got)
    assert port.events == ref.events
    assert port.reg.expose() == ref.reg.expose()
    assert _no_stamps(port.reg.expose(exemplars=True)) \
        == _no_stamps(ref.reg.expose(exemplars=True))
    return verdicts


def _no_stamps(exposition: str) -> list[str]:
    """The exposition with each exemplar's wall-clock stamp (its last
    field, the moment of the observation) dropped."""
    return [ln.rsplit(" ", 1)[0] if " # {" in ln else ln
            for ln in exposition.splitlines()]


TEST_FAMILIES = (
    ("gauge", "pwasm_test_depth", ()),
    ("gauge", "pwasm_test_client_depth", ("client",)),
    ("gauge", "pwasm_test_quota", ()),
    ("counter", "pwasm_test_replays_total", ()),
    ("counter", "pwasm_test_drops_total", ("site",)),
    ("histogram", "pwasm_test_wall_seconds", (0.1, 1.0, 10.0)))
TEST_RULES = (
    {"name": "deep", "kind": "threshold", "metric": "pwasm_test_depth",
     "op": ">", "value": 5, "severity": "page"},
    {"name": "pressure", "kind": "threshold",
     "metric": "pwasm_test_client_depth", "divide_by": "pwasm_test_quota",
     "op": ">", "value": 0.8},
    {"name": "held", "kind": "threshold", "metric": "pwasm_test_depth",
     "op": ">=", "value": 1, "for_s": 10.0, "runbook": "wait"},
    {"name": "replayed", "kind": "rate",
     "metric": "pwasm_test_replays_total", "op": ">", "value": 0,
     "window_s": 60.0, "baseline": "zero"},
    {"name": "drops", "kind": "rate", "metric": "pwasm_test_drops_total",
     "op": ">=", "value": 2, "window_s": 30.0},
    {"name": "burn", "kind": "burn_rate",
     "metric": "pwasm_test_wall_seconds", "objective_s": 1.0,
     "budget": 0.10, "short_s": 60.0, "long_s": 300.0},
    {"name": "burn_past_bounds", "kind": "burn_rate",
     "metric": "pwasm_test_wall_seconds", "objective_s": 50.0,
     "budget": 0.01, "short_s": 5.0, "long_s": 10.0, "severity": "page"},
    {"name": "ghost", "kind": "threshold",
     "metric": "pwasm_not_registered", "op": ">", "value": 0},
    {"name": "ghost_rate", "kind": "rate",
     "metric": "pwasm_not_registered_total", "op": ">", "value": 0,
     "window_s": 10.0},
    {"name": "ghost_burn", "kind": "burn_rate",
     "metric": "pwasm_not_registered_seconds", "objective_s": 1.0,
     "budget": 0.1, "short_s": 5.0, "long_s": 10.0})


def _set(name, v, **kw):
    return ("set", name, v, kw)


def _inc(name, v=1, **kw):
    return ("inc", name, v, kw)


def _obs(name, v, **kw):
    return ("observe", name, v, kw)


# the scripted cases of tests/test_slo.py:64-206, as step lists over
# TEST_FAMILIES and TEST_RULES: (now, ops) pairs
D, CD, Q = "pwasm_test_depth", "pwasm_test_client_depth", "pwasm_test_quota"
R, DR, W = ("pwasm_test_replays_total", "pwasm_test_drops_total",
            "pwasm_test_wall_seconds")
SCRIPTS = {
    "threshold_fire_resolve": [
        (1000.0, []), (1001.0, [_set(D, 9)]), (1002.0, [_set(D, 2)])],
    "ratio_labeled_any_cell": [
        (1000.0, [_set(Q, 10), _set(CD, 3, client="a"),
                  _set(CD, 4, client="b")]),
        (1001.0, [_set(CD, 9, client="b")]),
        (1002.0, [_set(Q, 0)]), (1003.0, [_set(Q, 20)])],
    "for_s_hold": [
        (1000.0, [_set(D, 1)]), (1005.0, []), (1011.0, []),
        (1012.0, [_set(D, 0)]), (1013.0, [_set(D, 1)]), (1024.0, [])],
    "rate_zero_baseline": [
        (2000.0, [_inc(R)]), (2030.0, []), (2061.0, []),
        (2062.0, [_inc(R)]), (2130.0, [])],
    "rate_first_baseline": [
        (3000.0, [_inc(DR, 40, site="a")]), (3001.0, [_inc(DR, site="a")]),
        (3002.0, [_inc(DR, site="b")]), (3040.0, [])],
    "burn_two_windows": [
        (5000.0, [_obs(W, 0.05)] * 20),
        (5010.0, [_obs(W, 5.0), _obs(W, 0.05)] * 10),
        (5080.0, [_obs(W, 0.05)] * 100)],
    "exemplars": [
        (6000.0, [_obs(W, 0.5), _obs(W, 0.7, trace_id="job-abc"),
                  _obs(W, 20.0, trace_id="job-inf")]),
        (6001.0, [_obs(W, 60.0, trace_id="job-late")] * 3)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_engine_scripted_cases_equal_the_reference(name):
    verdicts = _drive(TEST_FAMILIES, TEST_RULES, SCRIPTS[name])
    assert all(v["rules"] == len(TEST_RULES) for v in verdicts)


def _random_steps(seed: int, n: int = 80):
    rng = random.Random(seed)
    now = 10_000.0 + rng.random() * 100
    steps = []
    for _ in range(n):
        now += rng.choice((0.0, 0.3, 1.0, 4.0, 11.0, 31.0, 70.0))
        ops = []
        for _ in range(rng.randrange(4)):
            pick = rng.randrange(6)
            if pick == 0:
                ops.append(_set(D, rng.choice((0, 1, 3, 6, 9))))
            elif pick == 1:
                ops.append(_set(CD, rng.randrange(12),
                                client=rng.choice("abc")))
            elif pick == 2:
                ops.append(_set(Q, rng.choice((0, 5, 10))))
            elif pick == 3:
                ops.append(_inc(R, rng.choice((1, 2))))
            elif pick == 4:
                ops.append(_inc(DR, rng.randrange(1, 4),
                                site=rng.choice("xy")))
            else:
                tid = rng.choice((None, f"t{rng.randrange(99)}"))
                ops.extend(_obs(W, rng.choice((0.05, 0.5, 2.0, 30.0)),
                                **({"trace_id": tid} if tid else {}))
                           for _ in range(rng.randrange(1, 20)))
        steps.append((now, ops))
    return steps


@pytest.mark.parametrize("seed", range(6))
def test_engine_seeded_samples_equal_the_reference(seed):
    """Random samples at random clock steps over every rule kind: the
    verdicts, transitions and counters are the reference's, and over
    80 steps some rule of each kind fires and resolves."""
    verdicts = _drive(TEST_FAMILIES, TEST_RULES, _random_steps(seed))
    fired = {f["rule"] for v in verdicts for f in v["firing"]}
    assert {"deep", "replayed", "drops"} <= fired, fired


def test_engine_default_rules_equal_the_reference():
    """The daemon's default rule set over the registry a daemon builds
    (service, run, cache, transport, canary families): the same samples
    give the same verdicts."""
    steps = []
    rng = random.Random(5)
    now = 100.0
    for k in range(40):
        now += rng.choice((0.5, 3.0, 20.0, 130.0))
        steps.append(now)

    def build(side):
        mod, reg_cls, cat = SIDES[side]
        reg = reg_cls()
        svc = cat.build_service_metrics(reg)
        run_m = cat.build_run_metrics(reg, include_live=False)
        cache = cat.build_cache_metrics(reg)
        transport = cat.build_transport_metrics(reg)
        can = cat.build_canary_metrics(reg)
        events = []
        eng = mod.SloEngine(reg, cat.default_slo_rules(),
                            metrics=cat.build_slo_metrics(reg),
                            on_event=lambda ev, **f: events.append(
                                (ev, f)), eval_interval_s=0.01)
        return SimpleNamespace(reg=reg, svc=svc, run=run_m, cache=cache,
                               transport=transport, can=can, eng=eng,
                               events=events)

    sides = [build("port"), build("ref")]
    script = random.Random(9)
    for now in steps:
        r = script.random()
        val = script.randrange(5)
        walls = [script.choice((1.0, 200.0)) for _ in range(val + 1)]
        for s in sides:
            s.svc["max_queue"].set(4)
            if r < 0.2:
                s.svc["queue_depth"].set(val)
            elif r < 0.3:
                s.svc["breaker_state"].set(val % 3)
            elif r < 0.45:
                s.can["ok"].set(val % 2)
            elif r < 0.55:
                s.svc["journal_replays"].inc()
            elif r < 0.65:
                s.transport["auth_failures"].inc(6, client="c")
            elif r < 0.75:
                s.cache["evictions"].inc(val)
                s.cache["insertions"].inc(1)
            elif r < 0.9:
                for wall in walls:
                    s.svc["job_wall_seconds"].observe(wall)
        got, want = (s.eng.evaluate(now=now) for s in sides)
        assert got == want
        assert got["rules"] == 9
    assert sides[0].events == sides[1].events and sides[0].events
    # the samples; the HELP texts drop the reference's history tags
    assert [_samples(s.reg.expose()) for s in sides[:1]] \
        == [_samples(s.reg.expose()) for s in sides[1:]]


def _samples(exposition: str) -> list[str]:
    return [ln for ln in exposition.splitlines()
            if not ln.startswith("# HELP ")]


BAD_RULES = [
    {"name": "BadName", "metric": "m"},
    {"name": "x", "metric": "m", "severity": "meh"},
    {"name": "x", "metric": "m", "kind": "wat"},
    {"name": "x", "metric": "m", "op": "~="},
    {"name": "x", "metric": "m", "value": "9"},
    {"name": "x", "metric": "m", "value": True},
    {"name": "x", "metric": "m", "value": 1, "surprise": 1},
    {"name": "x", "metric": ""},
    {"name": "x", "metric": "m", "value": 1, "divide_by": 3},
    {"name": "x", "metric": "m", "value": 1, "for_s": -1},
    {"name": "x", "kind": "rate", "metric": "m", "value": 0,
     "window_s": 0},
    {"name": "x", "kind": "burn_rate", "metric": "m", "objective_s": 1,
     "budget": 0.1, "short_s": 60, "long_s": 60},
    {"name": "x", "kind": "burn_rate", "metric": "m", "budget": 0.1},
    {"name": "x", "kind": "rate", "metric": "m", "value": 0,
     "baseline": "maybe"},
    "not a dict"]


@pytest.mark.parametrize("k", range(len(BAD_RULES)))
def test_rule_validation_errors_equal_the_reference(k):
    msgs = []
    for mod in (slo, ref_slo):
        with pytest.raises(ValueError) as e:
            mod.validate_rule(BAD_RULES[k])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_rule_lists_defaults_merge_and_helpers_equal_the_reference():
    for mod in (slo, ref_slo):
        with pytest.raises(ValueError, match="duplicate"):
            mod.parse_rules([{"name": "a", "metric": "m", "value": 1},
                             {"name": "a", "metric": "m", "value": 2}])
        with pytest.raises(ValueError, match="JSON list"):
            mod.parse_rules({"name": "a"})
    # the shipped defaults pass the user-rule grammar, as the reference's
    assert slo.parse_rules(catalog.default_slo_rules()) \
        == ref_slo.parse_rules(ref_catalog.default_slo_rules())
    assert len(slo.parse_rules(catalog.default_slo_rules())) == 9
    assert slo.parse_rules(catalog.default_fleet_slo_rules()) \
        == ref_slo.parse_rules(ref_catalog.default_fleet_slo_rules())
    user = [{"name": "breaker_open", "kind": "threshold",
             "metric": "pwasm_service_breaker_state", "op": ">=",
             "value": 1, "severity": "warn"},
            {"name": "mine", "metric": "pwasm_service_queue_depth",
             "value": 3}]
    got = slo.merge_rules(catalog.default_slo_rules(),
                          slo.parse_rules(user))
    assert got == ref_slo.merge_rules(ref_catalog.default_slo_rules(),
                                      ref_slo.parse_rules(user))
    assert len(got) == 10
    assert [r for r in got if r["name"] == "breaker_open"][0]["value"] \
        == 1.0
    assert slo.merge_rules(catalog.default_slo_rules(), None) \
        == catalog.default_slo_rules()
    verdicts = [(), ("ok", "ok"), ("ok", "degraded"),
                ("degraded", "failing"), ("ok", "garbled"), ("failing",)]
    assert [slo.worst_verdict(*v) for v in verdicts] \
        == [ref_slo.worst_verdict(*v) for v in verdicts]
    assert [slo.verdict_exit_code(v) for v in
            ("ok", "degraded", "failing", "???", None)] \
        == [ref_slo.verdict_exit_code(v) for v in
            ("ok", "degraded", "failing", "???", None)] == [0, 1, 2, 1, 1]


@pytest.mark.parametrize("body", [
    json.dumps([{"name": "my_rule", "kind": "threshold",
                 "metric": "pwasm_service_queue_depth", "op": ">",
                 "value": 3, "severity": "warn"}]),
    "{not json", json.dumps([{"name": "x"}]), json.dumps({"name": "x"}),
    None])
def test_load_rules_file_equals_the_reference(tmp_path, body):
    path = tmp_path / "rules.json"
    if body is not None:
        path.write_text(body)
    got = []
    for mod in (slo, ref_slo):
        try:
            got.append(mod.load_rules_file(str(path)))
        except ValueError as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]
    assert (body is not None and body.startswith("[{\"name\": \"my")) \
        == (got[0][0] != "error")


def test_engine_transitions_land_in_the_event_hook_in_order():
    """A rule that fires and resolves twice: the hook sees the four
    transitions in order on both sides, and a hook that raises never
    reaches the evaluation (the never-raises contract)."""
    steps = [(1.0, [_set(D, 9)]), (2.0, [_set(D, 0)]),
             (3.0, [_set(D, 7)]), (4.0, [_set(D, 1)])]
    _drive(TEST_FAMILIES, TEST_RULES[:1], steps)
    for mod, reg_cls, cat in SIDES.values():
        reg = reg_cls()
        g = reg.gauge(D, "h")

        def boom(ev, **f):
            raise RuntimeError("hook")
        eng = mod.SloEngine(reg, [dict(TEST_RULES[0])],
                            metrics=cat.build_slo_metrics(reg),
                            on_event=boom)
        g.set(9)
        assert eng.evaluate(now=5.0)["verdict"] == "failing"
        assert eng.due() is False or eng.eval_interval_s <= 1.0


# ---------------------------------------------------------------------------
# query_log
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rotated_log():
    rng = random.Random(3)
    d = tempfile.mkdtemp(prefix="pwlq")
    log = os.path.join(d, "ev.ndjson")
    events = ("job_admit", "job_start", "job_finish", "canary_ok",
              "canary_fail", "alert_firing")

    def rec():
        r = {"event": rng.choice(events), "run_id": f"r{rng.randrange(4)}"}
        if rng.random() < 0.7:
            r["job_id"] = f"j{rng.randrange(5)}"
        if rng.random() < 0.6:
            r["trace_id"] = f"t{rng.randrange(4)}"
        return json.dumps(r)

    with open(log + ".1", "w") as f:
        f.write("".join(rec() + "\n" for _ in range(60)))
    with open(log, "w") as f:
        for k in range(90):
            f.write((rec() if k % 17 else "TORN {\"x\"") + "\n")
            if k % 29 == 0:
                f.write("\n[1, 2]\n")
    yield log
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("flt", [
    {}, {"trace_id": "t1"}, {"trace_id": "r2"}, {"job_id": "j3"},
    {"event": "canary_fail"}, {"job_id": "j0", "event": "job_finish"},
    {"trace_id": "t0", "job_id": "j1", "event": "job_start"},
    {"limit": 7}, {"limit": 1, "event": "job_admit"},
    {"trace_id": "nope"}])
def test_query_log_equals_the_reference(rotated_log, flt):
    got = logquery.query_log(rotated_log, **flt)
    assert got == ref_logquery.query_log(rotated_log, **flt)
    assert got or len(flt) > 1 or flt.get("trace_id") == "nope"
    assert list(logquery.iter_log_records(rotated_log)) \
        == list(ref_logquery.iter_log_records(rotated_log))
    assert logquery.query_log(rotated_log + ".absent", **flt) == []


# ---------------------------------------------------------------------------
# in-process daemons with the stubbed runner (tests/test_slo.py's box)
# ---------------------------------------------------------------------------
def _box_runner(box):
    """A controllable stub runner: writes ``box['body']`` to the -o path
    and answers ``box['rc']`` — flipping the box injects an outage on
    this daemon's serving path (bad bytes = digest drift; bad rc = a
    failed probe), restoring it heals.  An argv carrying
    ``--inject-faults`` answers 1 (the canary's fault window)."""
    def runner(argv, stdout=None, stderr=None, warm=None, **kw):
        box.setdefault("argvs", []).append(list(argv))
        out = None
        for i, a in enumerate(argv):
            if a == "-o" and i + 1 < len(argv):
                out = argv[i + 1]
        if out:
            with open(out, "wb") as f:
                f.write(box.get("body", b"OK"))
        sp = next((a.split("=", 1)[1] for a in argv
                   if a.startswith("--stats=")), None)
        if sp:
            with open(sp, "w") as f:
                json.dump({"wall_s": 0.001}, f)
        if any(a.startswith("--inject-faults=") for a in argv):
            return 1
        return box.get("rc", 0)
    return runner


@contextmanager
def _daemon(box=None, cls=Daemon, runner="box", **kw):
    box = box if box is not None else {}
    d = tempfile.mkdtemp(prefix="pwslo")
    sock = os.path.join(d, "s.sock")
    err = io.StringIO()
    dm = cls(sock, stderr=err, journal_path=None,
             runner=_box_runner(box) if runner == "box" else None, **kw)
    rcbox: list = []
    t = threading.Thread(target=lambda: rcbox.append(dm.serve()),
                         daemon=True)
    t.start()
    assert wait_for_socket(sock, 15), err.getvalue()
    try:
        yield SimpleNamespace(daemon=dm, sock=sock, box=box, err=err,
                              dir=d, rc=rcbox)
    finally:
        if not dm.drain.requested:
            dm.drain.request("test teardown")
        t.join(20)
        shutil.rmtree(d, ignore_errors=True)


def _health(sock):
    with ServiceClient(sock) as c:
        return c.health()["health"]


def _wait(sock, pred, budget_s=15.0):
    """Poll the health verb until ``pred(health)``; (seconds, health)."""
    t0 = time.monotonic()
    h = _health(sock)
    while not pred(h) and time.monotonic() - t0 < budget_s:
        time.sleep(0.05)
        h = _health(sock)
    assert pred(h), h
    return time.monotonic() - t0, h


def _runs(n):
    return lambda h: ((h["canary"] or {}).get("runs", 0) >= n)


def _verdict(v):
    return lambda h: h["verdict"] == v


def test_canary_probes_and_health_verb():
    with _daemon(canary_interval_s=0.1) as h:
        _, health = _wait(h.sock, _runs(2))
        assert health["verdict"] == "ok"
        can = health["canary"]
        assert can["runs"] >= 2 and can["fails"] == 0
        assert can["last_ok"] is True and can["interval_s"] == 0.1
        assert health["rules"] == 9          # the default set
        # canary runs never enter the job table or the journal
        assert h.daemon.jobs == {}
        # the probe: the warmup corpus on cuda (the daemon warms no CPU)
        argv = h.box["argvs"][0]
        assert argv[1:3] == ["-r", argv[2]] and "--device=cuda" in argv
        assert argv[argv.index("-o") + 1].endswith(
            os.path.join("canary", "canary.dfa"))
        with ServiceClient(h.sock) as c:
            plain = c.metrics()["metrics"]
            m = c.metrics(exemplars=True)["metrics"]
        assert "pwasm_canary_ok 1" in plain
        assert 'pwasm_canary_runs_total{outcome="ok"}' in plain
        assert 'pwasm_alerts_firing{rule="canary_failing"} 0' in plain
        # exemplars only on request; the canary wall histogram carries
        # the probes' trace ids
        assert "# {" not in plain
        assert '# {trace_id="canary-' in m


def test_canary_failure_fires_and_recloses(tmp_path):
    log = str(tmp_path / "ev.ndjson")
    with _daemon(canary_interval_s=0.1, log_json=log) as h:
        _wait(h.sock, _runs(1))
        h.box["body"] = b"CORRUPTED"       # the injected outage
        _, health = _wait(h.sock, _verdict("failing"))
        assert [(f["rule"], f["severity"]) for f in health["firing"]] \
            == [("canary_failing", "page")]
        assert "digest drift" in health["canary"]["last_detail"]
        h.box["body"] = b"OK"              # heal
        _wait(h.sock, _verdict("ok"))
        t = h.daemon.registry.get("pwasm_alert_transitions_total")
        assert t.value(rule="canary_failing", state="firing") >= 1
        assert t.value(rule="canary_failing", state="resolved") >= 1
    evs = [r["event"] for r in logquery.query_log(log)]
    i_fail = evs.index("canary_fail")
    i_fire = evs.index("alert_firing")
    i_resolved = evs.index("alert_resolved")
    assert i_fail < i_fire < i_resolved, evs
    fired = logquery.query_log(log, event="alert_firing")[0]
    assert (fired["rule"], fired["severity"]) == ("canary_failing", "page")


def test_canary_bad_rc_fires_too():
    with _daemon(canary_interval_s=0.1) as h:
        _wait(h.sock, _runs(1))
        h.box["rc"] = 3
        _, health = _wait(h.sock, _verdict("failing"))
        assert "canary_failing" in [f["rule"] for f in health["firing"]]
        assert "exit 3" in health["canary"]["last_detail"]


def test_canary_fault_window_fires_then_resolves(monkeypatch):
    """``PWASM_CANARY_FAULTS=2-3:SPEC``: probes 2 and 3 carry
    ``--inject-faults=SPEC`` (the stub fails them), so the verdict turns
    failing within two intervals and returns to ok after the window."""
    monkeypatch.setenv("PWASM_CANARY_FAULTS", "2-3:seed=1,rate=1")
    with _daemon(canary_interval_s=0.1) as h:
        _wait(h.sock, _verdict("failing"))
        _, health = _wait(h.sock, lambda x: x["verdict"] == "ok"
                          and x["canary"]["runs"] >= 4)
        assert health["canary"]["fails"] == 2
    faulted = [k + 1 for k, a in enumerate(h.box["argvs"])
               if "--inject-faults=seed=1,rate=1" in a]
    assert faulted == [2, 3]


@pytest.mark.parametrize("spec", [
    None, "", "2-3:seed=1,rate=1", "4:kill=1", "0-2:x", "3-1:x", "a-b:x",
    "2-3", "2-3:", "1-1:oom=2"])
def test_parse_canary_faults_equals_the_reference(spec):
    assert canary.parse_canary_faults(spec) \
        == ref_canary.parse_canary_faults(spec)
    assert canary.LANE_GRAB_S == ref_canary.LANE_GRAB_S


def test_canary_skips_when_every_lane_is_busy():
    with _daemon(canary_interval_s=30.0) as h:
        lease = h.daemon.leases.acquire(timeout=1.0)
        try:
            assert h.daemon.canary.run_once() is None
        finally:
            h.daemon.leases.release(lease)
        assert h.daemon.canary.run_once() is True
        can = _health(h.sock)["canary"]
        assert (can["skipped"], can["runs"]) == (1, 1)
        with ServiceClient(h.sock) as c:
            assert 'pwasm_canary_runs_total{outcome="skipped"} 1' \
                in c.metrics()["metrics"]


def test_health_exit_code_matrix(tmp_path):
    # ok = 0
    with _daemon(canary_interval_s=0.1) as h:
        _wait(h.sock, _runs(1))
        out = io.StringIO()
        rc = client_main("health", [f"--socket={h.sock}", "--exit-code"],
                         out, io.StringIO())
        assert rc == 0
        doc = json.loads(out.getvalue())
        assert doc["verdict"] == "ok" and doc["canary"]["runs"] >= 1
        # without --exit-code the shell rc stays 0 regardless
        h.box["rc"] = 9
        _wait(h.sock, _verdict("failing"))
        assert client_main("health", [f"--socket={h.sock}"],
                           io.StringIO(), io.StringIO()) == 0
        # failing = 2, through the CLI's dispatch too
        assert run(["health", f"--socket={h.sock}", "--exit-code"],
                   stdout=io.StringIO(), stderr=io.StringIO()) == 2
    # degraded = 1: a user warn rule that always fires
    rules = tmp_path / "r.json"
    rules.write_text(json.dumps([
        {"name": "always_warn", "kind": "threshold",
         "metric": "pwasm_service_max_queue", "op": ">=", "value": 1,
         "severity": "warn"}]))
    with _daemon(slo_rules=slo.load_rules_file(str(rules))) as h:
        _wait(h.sock, _verdict("degraded"))
        assert client_main("health", [f"--socket={h.sock}",
                                      "--exit-code"], io.StringIO(),
                           io.StringIO()) == 1
        assert _health(h.sock)["rules"] == 10
    # --exit-code belongs to health alone: elsewhere it is a job arg
    err = io.StringIO()
    assert client_main("svc-stats", ["--socket=/nonexistent.sock",
                                     "--exit-code"], io.StringIO(),
                       err) == 1


def test_slo_rules_off_disables_engine():
    with _daemon(slo_rules="off") as h:
        health = _health(h.sock)
        assert health == {"verdict": "ok", "firing": [], "rules": 0,
                          "evaluations": health["evaluations"],
                          "canary": None}
        with ServiceClient(h.sock) as c:
            assert "pwasm_alerts_firing{" not in c.metrics()["metrics"]


def test_stats_and_top_carry_the_alerts_pane():
    with _daemon(canary_interval_s=0.1) as h:
        _wait(h.sock, _runs(1))
        h.box["body"] = b"DRIFT"
        _wait(h.sock, _verdict("failing"))
        with ServiceClient(h.sock) as c:
            st = c.stats()["stats"]
        assert st["health"]["verdict"] == "failing"
        frame = top.render(st)
        assert frame == ref_top.render(st)
        assert "ALERTS (failing)" in frame
        assert "canary_failing[page" in frame
        assert "canary: FAILING" in frame
        out = io.StringIO()
        assert run(["top", f"--socket={h.sock}", "--once"], stdout=out,
                   stderr=io.StringIO()) == 0
        assert "ALERTS (failing)" in out.getvalue()
        assert out.getvalue().startswith("pwasm-tpu top — uptime ")
    # a healthy daemon renders the quiet pane; a fleet's stats render
    # the member rows and the shed banner as the reference's
    for st in ({"health": {"verdict": "ok", "firing": []}}, {},
               {"fleet": {"members": [
                   {"name": "m1", "alive": True, "queue_depth": 2,
                    "lat_ewma_ms": 3.0, "jobs_routed": 4},
                   {"name": "m2", "alive": False},
                   {"name": "m3", "alive": True, "quarantined": True}],
                   "alive": 2, "jobs_recovered": {"resumed": 1}},
                "ha": {"shed": {"level": 1, "lanes_shed": ["lo"]}},
                "health": {"verdict": "degraded", "firing": [],
                           "members": {"m2": {"verdict": "failing",
                                              "firing": ["member_down"]}}},
                "m2m": {"sessions": 2, "pairs_dispatched": 9,
                        "pairs_reused": 3},
                "cache": {"enabled": True, "hits": 3, "hit_ratio": 0.5},
                "streams": {"active": 1}, "lanes": [
                    {"lane": 0, "devices": [0, 1], "busy": True,
                     "busy_s": 1.0}],
                "fair_share": {"clients": {"alice": 2}},
                "uptime_s": 10}):
        assert top.render(st) == ref_top.render(st)
    assert "ALERTS: none" in top.render(
        {"health": {"verdict": "ok", "firing": []}})


@pytest.mark.parametrize("argv", [
    [], ["--socket=s", "--interval=0"], ["--socket=s", "--interval=inf"],
    ["--socket=s", "--frob"], ["-h"]])
def test_top_usage_errors_equal_the_reference(argv):
    got = []
    for main in (top.top_main, ref_top.top_main):
        err = io.StringIO()
        rc = main(argv, io.StringIO(), err)
        lines = err.getvalue().splitlines()
        got.append((rc, lines[0], lines[-1] if argv != ["-h"] else None))
    assert got[0] == got[1] and got[0][:2] == (1, "Usage:")


def test_logs_verb_socket_and_validation(tmp_path):
    log = str(tmp_path / "svc.ndjson")
    with _daemon(log_json=log) as h:
        out = str(tmp_path / "o.dfa")
        with ServiceClient(h.sock) as c:
            jid = c.submit(["in.paf", "-o", out],
                           cwd=str(tmp_path))["job_id"]
            r = c.result(jid, timeout=30)
            assert r["rc"] == 0
            trace = r["job"]["trace_id"]
            resp = c.logs(trace_id=trace)
            assert resp["ok"] and resp["path"] == log
            assert [ln["event"] for ln in resp["lines"]] \
                == ["job_admit", "job_start", "job_finish"]
            assert all(ln["trace_id"] == trace for ln in resp["lines"])
            assert [ln["event"] for ln in
                    c.logs(job_id=jid, event="job_finish")["lines"]] \
                == ["job_finish"]
            assert len(c.logs(limit=1)["lines"]) == 1
            for bad in (0, 10001, "5", True):
                r = c.request({"cmd": "logs", "limit": bad})
                assert r["error"] == "bad_request", bad
        # the client verb over the socket: NDJSON, the same records
        out = io.StringIO()
        assert run(["logs", f"--socket={h.sock}", f"--job={jid}"],
                   stdout=out, stderr=io.StringIO()) == 0
        got = [json.loads(ln) for ln in out.getvalue().splitlines()]
        assert got == logquery.query_log(log, job_id=jid)
    # a daemon without --log-json says so
    with _daemon() as h:
        with ServiceClient(h.sock) as c:
            resp = c.logs()
        assert not resp["ok"] and "--log-json" in resp["detail"]


def test_logs_cli_file_mode_equals_the_reference(tmp_path):
    from pwasm_tpu.service.client import client_main as ref_client_main
    log = tmp_path / "ev.ndjson"
    log.write_text(json.dumps({"event": "canary_fail", "run_id": "x"})
                   + "\n" + json.dumps({"event": "canary_ok",
                                        "run_id": "x"}) + "\n")
    (tmp_path / "ev.ndjson.1").write_text(
        json.dumps({"event": "canary_ok", "run_id": "y",
                    "job_id": "j1"}) + "\n")
    for argv in ([str(log), "--event=canary_fail"],
                 ["--event=canary_ok", str(log)], [str(log)],
                 [str(log), "--trace-id=y", "--limit=1"],
                 [str(log), "--job=j1"], ["--event=x"],
                 [str(tmp_path / "no.ndjson")], [str(log), "--limit=0"],
                 [str(log), str(log)], ["--socket=/x.sock", str(log)]):
        got = []
        for main in (client_main, ref_client_main):
            out, err = io.StringIO(), io.StringIO()
            got.append((main("logs", list(argv), out, err),
                        out.getvalue(),
                        (err.getvalue().splitlines() or [""])[-1]))
        assert got[0] == got[1], argv
    out = io.StringIO()
    assert client_main("logs", [str(log), "--event=canary_fail"], out,
                       io.StringIO()) == 0
    assert json.loads(out.getvalue())["event"] == "canary_fail"


def test_serve_main_validates_selfmon_flags(tmp_path):
    from pwasm_tpu.service.daemon import serve_main as ref_serve_main
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([{"name": "x", "metric": "m"}]))
    for flag, says in (("--canary-interval=0", "--canary-interval"),
                       ("--canary-interval=nope", "--canary-interval"),
                       ("--canary-interval=inf", "--canary-interval"),
                       (f"--slo-rules={bad}", "not valid JSON"),
                       (f"--slo-rules={rules}", "value must be a number"),
                       (f"--slo-rules={tmp_path / 'absent'}",
                        "cannot read")):
        got = []
        for main in (serve_main, ref_serve_main):
            err = io.StringIO()
            rc = main([f"--socket={tmp_path}/s.sock", flag], stderr=err)
            got.append((rc, err.getvalue().splitlines()[-1]))
        assert got[0] == got[1] and got[0][0] == 1, flag
        assert says in got[0][1], flag
    assert not os.path.exists(f"{tmp_path}/s.sock")


def _selfmon_view(h):
    """What both packages' daemons must agree on with the engine on:
    the verdict, the rule count, the firing list by rule and severity,
    the canary block's keys, and the exposition's families."""
    health = _health(h.sock)
    with ServiceClient(h.sock) as c:
        expo = c.metrics()["metrics"]
    return dict(verdict=health["verdict"], rules=health["rules"],
                firing=[(f["rule"], f["severity"]) for f in
                        health["firing"]],
                canary=sorted(health["canary"] or {}),
                families=[ln for ln in expo.splitlines()
                          if ln.startswith("# TYPE ")],
                alert_series=sorted(ln.split(" ")[0] for ln in
                                    expo.splitlines()
                                    if ln.startswith("pwasm_alerts_firing")))


def test_both_daemons_with_the_engine_on_agree():
    """The port's daemon and the reference's, each with the default
    rules and a canary over the stubbed runner: healthy, then a digest
    drift, then healed — the same health at each stage."""
    from pwasm_tpu.service.daemon import Daemon as RefDaemon
    views = {}
    for who, cls in (("port", Daemon), ("ref", RefDaemon)):
        with _daemon(cls=cls, canary_interval_s=0.1) as h:
            stages = []
            _wait(h.sock, _runs(2))
            stages.append(_selfmon_view(h))
            h.box["body"] = b"DRIFT"
            _wait(h.sock, _verdict("failing"))
            stages.append(_selfmon_view(h))
            h.box["body"] = b"OK"
            _wait(h.sock, _verdict("ok"))
            stages.append(_selfmon_view(h))
            views[who] = stages
    assert views["port"] == views["ref"]
    assert [s["verdict"] for s in views["port"]] == ["ok", "failing", "ok"]
    assert views["port"][1]["firing"] == [("canary_failing", "page")]
    assert len(views["port"][0]["alert_series"]) == 9


# ---------------------------------------------------------------------------
# the port's cli.run behind the monitor, --device=cpu
# ---------------------------------------------------------------------------
def _paf_job(tmp_path):
    from pwasm_tpu_torch.cli import warmup_files
    return warmup_files(str(tmp_path / "corpus"))


def test_selfmon_byte_parity_on_vs_off(tmp_path):
    """Served outputs with the engine and a real canary (the warmup
    corpus through ``cli.run`` at ``--device=cpu``) equal those of a
    daemon with self-monitoring off and of a cold run; the canary's
    probes pass against their golden digest."""
    paf, fa = _paf_job(tmp_path)
    cold = tmp_path / "cold.dfa"
    assert run([paf, "-r", fa, "-o", str(cold), "--device=cpu"],
               stderr=io.StringIO()) == 0
    outs = {}
    for tag, kw in (("on", dict(canary_interval_s=0.3, warmup="cpu")),
                    ("off", dict(slo_rules="off"))):
        with _daemon(runner=None, **kw) as h:
            body = b""
            for k in range(2):
                out = str(tmp_path / f"{tag}{k}.dfa")
                with ServiceClient(h.sock) as c:
                    r = c.result(c.submit(
                        [paf, "-r", fa, "-o", out, "--device=cpu"])
                        ["job_id"], timeout=120)
                assert r["rc"] == 0, r
                body += open(out, "rb").read()
            if tag == "on":
                _, health = _wait(h.sock, _runs(2), budget_s=60)
                assert health["verdict"] == "ok", health
                assert health["canary"]["fails"] == 0
                assert set(h.daemon.jobs) == {"job-0001", "job-0002"}
            outs[tag] = body
    assert outs["on"] == outs["off"] == cold.read_bytes() * 2


def test_canary_on_cuda_without_cuda_is_a_failed_probe():
    """No CUDA on this box: the default (cuda) probe exits 1 through the
    real runner, which is a failing canary — a metric and an event, the
    daemon serving on — never a probe demoted to the CPU."""
    with _daemon(runner=None, canary_interval_s=0.1) as h:
        _, health = _wait(h.sock, _verdict("failing"), budget_s=60)
        assert health["canary"]["last_ok"] is False
        assert "exit 1" in health["canary"]["last_detail"]
        assert "--device=cpu" in health["canary"]["last_detail"]
        with ServiceClient(h.sock) as c:
            assert c.ping()["ok"]
            assert 'pwasm_canary_runs_total{outcome="fail"}' \
                in c.metrics()["metrics"]
