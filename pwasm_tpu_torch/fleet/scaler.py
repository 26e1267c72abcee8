"""SLO-driven member auto-scaling (``route --scale-policy=FILE``).

Counterpart of ``pwasm_tpu/fleet/scaler.py``, with its names; a scaled
member is a ``python -m pwasm_tpu_torch serve`` process.

The SLO engine already KNOWS when the fleet is drowning —
``queue_pressure`` and ``queue_wait_burn`` fire while clients wait,
``ledger_saturation`` fires while admissions approach the backstop —
and without a scaler the verdicts only page a human.  The scaler closes
the loop: sustained pressure spawns a ``serve`` member (warmed and
compile-cached, so its FIRST job is already fast), sustained calm
drains one back down, and every action is journaled (``REC_SCALE``)
so a restarted or taken-over router knows exactly which members it
owns and readopts them instead of leaking processes.

The policy file is JSON::

    {"min_members": 1, "max_members": 4,
     "cooldown_s": 30, "hysteresis": 2, "scale_down_after_s": 120,
     "rules": ["queue_pressure", "queue_wait_burn",
               "ledger_saturation"],
     "spawn": {"socket_dir": "/srv/pwasm",
               "args": ["--warmup", "--compile-cache-dir=/srv/cc"]}}

- **hysteresis**: a rule must fire on ``hysteresis`` CONSECUTIVE
  health ticks before a spawn — one noisy evaluation is a blip, not
  load;
- **cooldown**: at most one action per ``cooldown_s`` — scaling reacts
  on the minutes scale the SLO windows measure, not per tick (the
  anti-flap half of hysteresis);
- **bounds**: total members stay within ``[min_members,
  max_members]``; the scaler only ever retires members IT spawned
  (flag-supplied members are the operator's, not ours);
- **retirement is a drain**: the member is removed from the router's
  table FIRST (so its planned exit never reads as a death and
  triggers failover), then asked to ``drain`` — it finishes in-flight
  work, preempts its queue to durable checkpoints, and exits with
  the documented preempted code (75).

Like the rest of ``pwasm_tpu_torch/fleet/`` it imports no torch
(``tests/test_torch_isolation.py``); the members it spawns do.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
from pwasm_tpu_torch.service.client import ServiceError, wait_for_socket

_DEFAULT_RULES = ("queue_pressure", "queue_wait_burn",
                  "ledger_saturation")


def load_scale_policy(path: str) -> dict:
    """Parse + validate a ``--scale-policy`` file; raises ValueError
    with an operator-readable message on any defect (the router must
    refuse a broken policy at startup, not discover it mid-scale)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read --scale-policy {path}: {e}")
    except ValueError as e:
        raise ValueError(f"--scale-policy {path} is not valid "
                         f"JSON: {e}")
    if not isinstance(raw, dict):
        raise ValueError(f"--scale-policy {path} must be a JSON "
                         "object")

    def intval(key: str, dflt: int, lo: int) -> int:
        v = raw.get(key, dflt)
        if not isinstance(v, int) or isinstance(v, bool) or v < lo:
            raise ValueError(f"--scale-policy {key} must be an "
                             f"integer >= {lo} (got {v!r})")
        return v

    pol = {
        "min_members": intval("min_members", 1, 1),
        "max_members": intval("max_members", 4, 1),
        "cooldown_s": float(raw.get("cooldown_s", 30)),
        "hysteresis": intval("hysteresis", 2, 1),
        "scale_down_after_s": float(raw.get("scale_down_after_s",
                                            120)),
    }
    if pol["max_members"] < pol["min_members"]:
        raise ValueError("--scale-policy max_members must be >= "
                         "min_members")
    if not pol["cooldown_s"] >= 0 or not pol["scale_down_after_s"] >= 0:
        raise ValueError("--scale-policy cooldown_s and "
                         "scale_down_after_s must be >= 0")
    rules = raw.get("rules", list(_DEFAULT_RULES))
    if not isinstance(rules, list) \
            or not all(isinstance(r, str) and r for r in rules) \
            or not rules:
        raise ValueError("--scale-policy rules must be a non-empty "
                         "list of SLO rule names")
    pol["rules"] = rules
    spawn = raw.get("spawn")
    if not isinstance(spawn, dict) \
            or not isinstance(spawn.get("socket_dir"), str) \
            or not spawn["socket_dir"]:
        raise ValueError("--scale-policy needs spawn.socket_dir "
                         "(where scaled members' sockets live)")
    args = spawn.get("args", [])
    if not isinstance(args, list) \
            or not all(isinstance(a, str) for a in args):
        raise ValueError("--scale-policy spawn.args must be a list "
                         "of strings")
    pol["spawn"] = {"socket_dir": spawn["socket_dir"],
                    "args": list(args)}
    return pol


def warm_spawn_args(args) -> list:
    """Spawn-argv policy for scaled members: a member joining a shared
    result-cache dir gets ``--cache-prefetch=64`` appended (warm-spawn
    replication — the hottest entries load BEFORE its socket appears,
    so the capacity the scaler adds is fast for repeat traffic from
    its first job).  An explicit ``--cache-prefetch`` in the policy
    wins; cache-off members are left alone."""
    out = list(args)
    if any(a.startswith("--result-cache=") and not a.endswith("=off")
           for a in out) \
            and not any(a.startswith("--cache-prefetch")
                        for a in out):
        out.append("--cache-prefetch=64")
    return out


class FleetScaler:
    """The router's scaling loop body.  Single-threaded: only the
    router's health loop calls :meth:`tick`, so no locking of its own
    state is needed (member-table mutation goes through the router's
    locked ``_add_member``/``_remove_member``)."""

    def __init__(self, router, policy: dict):
        self.router = router
        self.policy = policy
        self.pressure_ticks = 0      # consecutive firing ticks
        self.calm_since: float | None = None
        self.last_action_s = 0.0     # monotonic; 0 = never
        self.spawned = 0
        self.retired = 0
        self._spawn_seq = 0

    # ---- the loop body -------------------------------------------------
    def tick(self) -> None:
        self._reap_dead()
        firing = self._firing_rules()
        pressure = firing & set(self.policy["rules"])
        now = time.monotonic()
        if pressure:
            self.pressure_ticks += 1
            self.calm_since = None
        else:
            self.pressure_ticks = 0
            if self.calm_since is None:
                self.calm_since = now
        if self.last_action_s \
                and now - self.last_action_s < self.policy["cooldown_s"]:
            return                   # cooling down: observe only
        total, scaled_idle = self._census()
        if pressure and self.pressure_ticks >= \
                self.policy["hysteresis"] \
                and total < self.policy["max_members"]:
            self._spawn(sorted(pressure))
            return
        if not pressure and self.calm_since is not None \
                and now - self.calm_since \
                >= self.policy["scale_down_after_s"] \
                and scaled_idle is not None \
                and total > self.policy["min_members"]:
            self._retire(scaled_idle)

    def _firing_rules(self) -> set:
        """Rule names firing NOW: the router's own engine plus every
        member's cached health block (the member-side queue_pressure /
        queue_wait_burn verdicts are the ones that actually see the
        queues)."""
        r = self.router
        names = {f.get("rule") for f in r.slo.firing()}
        with r._lock:
            blocks = [(m.stats or {}).get("health")
                      for m in r.members.values() if m.alive]
        for mh in blocks:
            if isinstance(mh, dict):
                names |= {f.get("rule") for f in
                          (mh.get("firing") or [])
                          if isinstance(f, dict)}
        names.discard(None)
        return names

    def _census(self):
        """(serving member count, an idle scaler-owned member or
        None).  Quarantined members (gray failure) are
        excluded from the count — they take no new placements, so
        for capacity purposes they are missing and sustained
        pressure can spawn a replacement; they are also never the
        idle-retire candidate (retiring the slow member the drill is
        watching would erase the probation-exit evidence — the
        quarantine loop owns its fate)."""
        r = self.router
        with r._lock:
            alive = [m for m in r.members.values()
                     if m.alive and not m.quarantined]
            idle = None
            for m in alive:
                if m.scaled and m.queue_depth == 0 and m.running == 0:
                    idle = m
                    break
        return len(alive), idle

    def _reap_dead(self) -> None:
        """Collect exit codes of retired children (no zombies); a
        child that died WITHOUT being retired stays in the member
        table — the router's normal member-death failover owns it."""
        r = self.router
        with r._lock:
            procs = [(m.name, m.proc) for m in r.members.values()
                     if m.scaled and m.proc is not None]
        for _name, p in procs:
            p.poll()

    # ---- actions -------------------------------------------------------
    def _spawn(self, why: list) -> None:
        r = self.router
        sdir = self.policy["spawn"]["socket_dir"]
        sock = None
        for _ in range(1000):
            self._spawn_seq += 1
            cand = os.path.join(sdir,
                                f"scaled-{self._spawn_seq}.sock")
            if not os.path.exists(cand):
                sock = cand
                break
        if sock is None:
            r._say("scaler: no free socket name under "
                   f"{sdir}; not spawning")
            return
        spawn_args = warm_spawn_args(self.policy["spawn"]["args"])
        argv = [sys.executable, "-m", "pwasm_tpu_torch", "serve",
                f"--socket={sock}"] + spawn_args
        try:
            proc = subprocess.Popen(
                argv, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
        except OSError as e:
            r._say(f"scaler: cannot spawn member ({e})")
            return
        if not wait_for_socket(sock, budget_s=30.0):
            r._say(f"scaler: spawned member on {sock} never came "
                   "up; killing it")
            proc.kill()
            proc.wait()
            return
        m = r._add_member(sock, scaled=True)
        m.proc = proc
        self.spawned += 1
        self.last_action_s = time.monotonic()
        self.pressure_ticks = 0
        from pwasm_tpu_torch.service.journal import REC_SCALE
        r._journal([(REC_SCALE, {"action": "spawn", "target": sock,
                                 "pid": proc.pid, "why": why})])
        r.metrics["scaler_actions"].inc(action="spawn")
        r.obs.event("scaler_spawn", member=m.name, target=sock,
                    pid=proc.pid, why=why)
        r._say(f"scaler: spawned member {m.name} on {sock} "
               f"(pressure: {', '.join(why)})")

    def _retire(self, m) -> None:
        """Drain one scaler-owned idle member out of the fleet.
        Order matters: journal the intent, FORGET the member (so its
        planned exit is never mistaken for a death to fail over),
        then drain it and reap the documented preempted exit code."""
        r = self.router
        from pwasm_tpu_torch.service.journal import REC_SCALE
        r._journal([(REC_SCALE, {"action": "retire",
                                 "target": m.target,
                                 "pid": getattr(m.proc, "pid",
                                                None)})])
        r._remove_member(m.name)
        try:
            # the router's dial factory: a TLS/token-armed fleet
            # retires members with the same credentials it polls with
            with r._dial(m.target, timeout=5.0) as c:
                c.request({"cmd": "drain"})
        except (ServiceError, OSError):
            pass                     # already dying is fine
        rc = None
        if m.proc is not None:
            try:
                rc = m.proc.wait(timeout=60.0)
            except subprocess.TimeoutExpired:
                m.proc.kill()
                rc = m.proc.wait()
        if rc not in (0, EXIT_PREEMPTED, None):
            r._say(f"scaler: retired member {m.name} exited rc={rc} "
                   f"(expected 0 or {EXIT_PREEMPTED})")
        self.retired += 1
        self.last_action_s = time.monotonic()
        self.calm_since = None
        r.metrics["scaler_actions"].inc(action="retire")
        r.obs.event("scaler_retire", member=m.name, target=m.target,
                    rc=rc)
        r._say(f"scaler: retired idle member {m.name} (rc={rc})")

    def shutdown(self) -> None:
        """Router exit: retire every member we own — scaled members
        must not outlive the router that journals their existence."""
        r = self.router
        with r._lock:
            mine = [m for m in r.members.values() if m.scaled]
        for m in mine:
            self._retire(m)

    def stats_dict(self) -> dict:
        with self.router._lock:
            owned = sum(1 for m in self.router.members.values()
                        if m.scaled)
        return {"enabled": True, "owned": owned,
                "spawned": self.spawned, "retired": self.retired,
                "min_members": self.policy["min_members"],
                "max_members": self.policy["max_members"],
                "pressure_ticks": self.pressure_ticks}
