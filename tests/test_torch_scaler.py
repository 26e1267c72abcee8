"""The port's SLO scaler (``route --scale-policy``) against the JAX
package's, on the CPU.

Ports of the scaler cases of ``tests/test_fleet_ha.py`` and
``tests/test_gray_failure.py``: ``load_scale_policy`` on good and broken
policy files (the same dicts, the same ``ValueError`` texts),
``warm_spawn_args``, the census that leaves quarantined members out,
seeded sequences of health ticks through both packages' scalers (the
same spawns, retires and counters under hysteresis, cooldown and the
member bounds), a spawned member that never shows its socket (killed,
never replaced), and the drill: sustained pressure spawns a real
``python -m pwasm_tpu_torch serve --warmup=cpu`` member that serves a
job with the reference's cold bytes, and sustained calm retires it with
exit 75.
"""

import json
import os
import random
import sys
import time
from types import SimpleNamespace

import pytest

from pwasm_tpu.fleet import scaler as ref_scaler
from pwasm_tpu_torch.fleet import scaler
from pwasm_tpu_torch.service.client import ServiceClient

from test_torch_fleet import (PKGS, _cold_ref, _corpus, _fleet, _job_args,
                              _serve_env, _wait)
from test_torch_gray_failure import _mkrouter

SCALERS = {"port": scaler, "ref": ref_scaler}


# ---------------------------------------------------------------------------
# the policy file and the spawn argv
# ---------------------------------------------------------------------------
_SD = {"socket_dir": "/srv"}
POLICIES = {
    "full": {"min_members": 1, "max_members": 2, "cooldown_s": 5,
             "hysteresis": 1, "scale_down_after_s": 9,
             "rules": ["queue_pressure"],
             "spawn": {"socket_dir": "/srv", "args": ["--warmup"]}},
    "defaults": {"spawn": _SD},
    "float_cooldown": {"spawn": _SD, "cooldown_s": 0.25,
                       "scale_down_after_s": 0},
    "min_zero": {"spawn": _SD, "min_members": 0},
    "max_bool": {"spawn": _SD, "max_members": True},
    "max_below_min": {"spawn": _SD, "min_members": 3, "max_members": 2},
    "hysteresis_float": {"spawn": _SD, "hysteresis": 1.5},
    "negative_cooldown": {"spawn": _SD, "cooldown_s": -1},
    "negative_scale_down": {"spawn": _SD, "scale_down_after_s": -2},
    "rules_empty": {"spawn": _SD, "rules": []},
    "rules_string": {"spawn": _SD, "rules": "queue_pressure"},
    "rules_blank_name": {"spawn": _SD, "rules": ["queue_pressure", ""]},
    "spawn_empty": {"spawn": {}},
    "spawn_missing": {},
    "socket_dir_blank": {"spawn": {"socket_dir": ""}},
    "args_string": {"spawn": {"socket_dir": "/srv", "args": "nope"}},
    "args_not_strings": {"spawn": {"socket_dir": "/srv", "args": [1]}},
    "not_an_object": [1],
    "not_json": "{nope",
    "missing_file": None,
}


def _load(pkg, path):
    try:
        return ("ok", SCALERS[pkg].load_scale_policy(path))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", list(POLICIES))
def test_load_scale_policy_equals_the_reference(tmp_path, case):
    """The same policy dict, or the same ``ValueError`` text, from both
    packages."""
    body = POLICIES[case]
    path = str(tmp_path / "pol.json")
    if isinstance(body, str):
        open(path, "w").write(body)
    elif body is not None:
        open(path, "w").write(json.dumps(body))
    got = {pkg: _load(pkg, path) for pkg in ("port", "ref")}
    assert got["port"] == got["ref"]
    if case in ("full", "defaults", "float_cooldown"):
        assert got["port"][0] == "ok"
    else:
        assert got["port"][0] == "ValueError"
    if case == "defaults":
        assert got["port"][1] == {
            "min_members": 1, "max_members": 4, "cooldown_s": 30.0,
            "hysteresis": 2, "scale_down_after_s": 120.0,
            "rules": ["queue_pressure", "queue_wait_burn",
                      "ledger_saturation"],
            "spawn": {"socket_dir": "/srv", "args": []}}


@pytest.mark.parametrize("args", [
    [], ["--warmup=cuda"], ["--result-cache=/rc"],
    ["--result-cache=off"], ["--result-cache=/rc", "--cache-prefetch=8"],
    ["--result-cache=/rc", "--cache-prefetch"],
    ["--compile-cache-dir=/cc", "--result-cache=/rc", "--lanes=1"]])
def test_warm_spawn_args_equals_the_reference(args):
    got = scaler.warm_spawn_args(args)
    assert got == ref_scaler.warm_spawn_args(args)
    assert got[:len(args)] == args


def test_scaler_census_excludes_quarantined():
    """A quarantined member is missing for capacity and never the idle
    member a retire picks."""
    got = {}
    for pkg in ("port", "ref"):
        r, _err = _mkrouter(pkg, 3, quarantine_x=3.0)
        r.members["m2.sock"].quarantined = True
        r.members["m2.sock"].scaled = True
        sc = object.__new__(SCALERS[pkg].FleetScaler)
        sc.router = r
        alive, idle = SCALERS[pkg].FleetScaler._census(sc)
        got[pkg] = (alive, idle)
    assert got["port"] == got["ref"] == (2, None)


# ---------------------------------------------------------------------------
# seeded tick sequences through both scalers
# ---------------------------------------------------------------------------
class _Proc:
    """A spawned child that exits 75 when drained."""
    pid = 4242

    def __init__(self, argv, **_kw):
        self.argv = argv

    def poll(self):
        return None

    def wait(self, timeout=None):
        return 75

    def kill(self):
        pass


def _tick_trace(pkg, seed, monkeypatch, tmp_path):
    rng = random.Random(seed)
    mod = SCALERS[pkg]
    clock = {"t": 1000.0}
    monkeypatch.setattr(mod, "time",
                        SimpleNamespace(monotonic=lambda: clock["t"]))
    monkeypatch.setattr(mod, "wait_for_socket", lambda s, budget_s: True)
    monkeypatch.setattr(mod.subprocess, "Popen", _Proc)
    sdir = tmp_path / pkg
    sdir.mkdir()
    pol = {"min_members": 1, "max_members": rng.randint(2, 4),
           "cooldown_s": rng.choice([0.0, 2.0, 5.0]),
           "hysteresis": rng.randint(1, 3),
           "scale_down_after_s": rng.choice([0.0, 3.0, 8.0]),
           "rules": ["queue_pressure", "queue_wait_burn"],
           "spawn": {"socket_dir": str(sdir), "args": ["--warmup=cpu"]}}
    r, err = _mkrouter(pkg, 1)
    sc = mod.FleetScaler(r, pol)
    names = ["queue_pressure", "queue_wait_burn", "ledger_saturation",
             "error_rate"]
    out = []
    for _ in range(60):
        firing = {n for n in names if rng.random() < 0.3}
        sc._firing_rules = lambda f=firing: set(f)
        for m in r.members.values():
            m.alive = True               # what the next poll would see
            m.queue_depth = rng.choice([0, 0, 1])
        sc.tick()
        clock["t"] += rng.choice([0.5, 1.0, 2.5])
        out.append((sorted(firing), sorted(r.members),
                    sc.pressure_ticks, sc.calm_since is not None,
                    sc.stats_dict()))
    text = err.getvalue().replace(str(sdir), "<d>")
    return out, [ln for ln in text.splitlines() if "scaler" in ln]


@pytest.mark.parametrize("seed", range(4))
def test_scaler_ticks_equal_the_reference(tmp_path, monkeypatch, seed):
    """One seeded sequence of firing rules, member depths and clock
    steps through both scalers: the same member set, counters and
    messages after every tick."""
    got = {pkg: _tick_trace(pkg, seed, monkeypatch, tmp_path)
           for pkg in ("port", "ref")}
    assert got["port"] == got["ref"]
    trace, said = got["port"]
    assert trace[-1][-1]["spawned"] and trace[-1][-1]["retired"], trace[-1]
    assert all(len(members) <= 4 for _f, members, *_x in trace)
    assert [ln for ln in said if "spawned member" in ln]


def test_scaler_spawn_that_never_comes_up_is_killed(tmp_path, monkeypatch):
    """A spawned member whose socket never shows is killed and reported,
    as the reference does; the fleet is not grown."""
    got = {}
    for pkg in ("port", "ref"):
        mod = SCALERS[pkg]
        spawned = []

        class Proc(_Proc):
            def __init__(self, argv, **kw):
                super().__init__(argv)
                spawned.append(argv)

            def kill(self):
                spawned.append("killed")

        monkeypatch.setattr(mod, "wait_for_socket",
                            lambda s, budget_s: False)
        monkeypatch.setattr(mod.subprocess, "Popen", Proc)
        sdir = tmp_path / pkg
        sdir.mkdir()
        r, err = _mkrouter(pkg, 1)
        sc = mod.FleetScaler(r, {
            "min_members": 1, "max_members": 2, "cooldown_s": 0.0,
            "hysteresis": 1, "scale_down_after_s": 1.0,
            "rules": ["queue_pressure"],
            "spawn": {"socket_dir": str(sdir), "args": ["--warmup=cuda"]}})
        sc._firing_rules = lambda: {"queue_pressure"}
        sc.tick()
        argv = spawned[0]
        assert argv[:3] == [sys.executable, "-m", PKGS[pkg].module]
        got[pkg] = (sorted(r.members), sc.stats_dict(), spawned[1:],
                    err.getvalue().replace(str(sdir), "<d>"),
                    [a.replace(str(sdir), "<d>") for a in argv[3:]])
    assert got["port"] == got["ref"]
    assert got["port"][0] == ["m0.sock"]
    assert got["port"][2] == ["killed"]
    assert "never came up; killing it" in got["port"][3]
    assert got["port"][4] == ["serve", "--socket=<d>/scaled-1.sock",
                              "--warmup=cuda"]


# ---------------------------------------------------------------------------
# the drill: a real spawned port member
# ---------------------------------------------------------------------------
def test_scaler_spawns_and_retires_members(tmp_path, monkeypatch):
    """Sustained pressure spawns a ``pwasm_tpu_torch serve --warmup=cpu``
    process, adopted into the fleet, which serves a job with the
    reference's cold bytes; the bound holds under pressure; sustained
    calm drains it back to ``min_members`` with exit 75."""
    env = _serve_env()
    for k in ("PYTHONPATH", "PWASM_DEVICE_PROBE"):
        monkeypatch.setenv(k, env[k])
    paf, fa = _corpus(tmp_path, n=8)
    expect = _cold_ref(tmp_path, "cold", paf, fa)
    sdir = str(tmp_path / "scaled")
    os.makedirs(sdir)
    policy = {"min_members": 1, "max_members": 2, "cooldown_s": 0.0,
              "hysteresis": 2, "scale_down_after_s": 0.5,
              "rules": ["queue_pressure"],
              "spawn": {"socket_dir": sdir, "args": ["--warmup=cpu"]}}
    pressure = {"on": True}
    with _fleet(n=1, router_kw={"scale_policy": policy}) as f:
        sc = f.router.scaler
        monkeypatch.setattr(
            sc, "_firing_rules",
            lambda: {"queue_pressure"} if pressure["on"] else set())

        def stats():
            with ServiceClient(f.sock) as c:
                return c.stats()["stats"]

        _wait(lambda: stats()["ha"]["scaler"]["owned"] == 1, 60)
        _wait(lambda: stats()["fleet"]["alive"] == 2, 30)
        st = stats()
        assert st["ha"]["scaler"]["enabled"]
        assert len(st["fleet"]["members"]) == 2
        scaled = [m["name"] for m in st["fleet"]["members"]
                  if m["scaled"]]
        assert scaled == ["scaled-1.sock"]
        time.sleep(0.5)                  # pressure cannot pass the bound
        assert len(stats()["fleet"]["members"]) == 2
        landed = []
        with ServiceClient(f.sock) as c:
            for k in range(4):
                subs = [c.submit(_job_args(tmp_path, f"s{k}{i}", paf, fa),
                                 cwd=str(tmp_path)) for i in range(2)]
                for i, s in enumerate(subs):
                    assert s["ok"], s
                    assert c.result(s["job_id"], timeout=60)["rc"] == 0
                    assert (tmp_path / f"s{k}{i}.dfa").read_bytes() \
                        == expect
                    landed.append(s["member"])
                if "scaled-1.sock" in landed:
                    break
        assert "scaled-1.sock" in landed, landed
        pressure["on"] = False
        _wait(lambda: stats()["ha"]["scaler"]["retired"] == 1, 60)
        st = stats()
        assert st["ha"]["scaler"]["owned"] == 0
        assert st["ha"]["scaler"]["spawned"] == 1
        assert len(st["fleet"]["members"]) == 1
        assert "retired idle member scaled-1.sock (rc=75)" \
            in f.err.getvalue()
    assert not os.path.exists(os.path.join(sdir, "scaled-1.sock"))
