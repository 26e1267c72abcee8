"""Synthetic canary probes (``serve --canary-interval=S``).

Counterpart of ``pwasm_tpu/service/canary.py``, with its names.  The
metrics only describe traffic that HAPPENS: a silently-wedged lane on
an idle daemon looks exactly like a healthy idle daemon until a user
job fails.  The canary closes that gap: every ``S`` seconds the daemon
runs the tiny deterministic warmup corpus (``cli.warmup_files`` — the
same files ``serve --warmup`` runs) through the NORMAL serving
machinery — a device lease on a free lane, the injected runner
(``cli.run``), a real report written to a daemon-private directory —
and **byte-verifies** the report against a golden digest captured on
the first successful probe.  A bad exit code or a digest drift flips
``pwasm_canary_ok`` to 0, which the default ``canary_failing`` SLO
rule (obs/catalog.py) turns into a page-severity firing — black-box
proof the probe→lease→device→report path works end to end,
continuously, without waiting for a user job to be the probe.

Mechanics worth knowing:

- **free lane only**: the lease grab uses a short timeout — a tick
  with every lane busy is counted ``skipped``, never queued behind a
  real job (busy lanes are self-evidently serving; the canary exists
  for the idle-but-broken case);
- **device path**: the probe runs ``--device=cuda`` (``--device=cpu``
  only on a daemon that warms the CPU, ``serve --warmup=cpu``), so the
  probe, the CUDA context and the ctx_scan program are exercised on the
  card.  A failing probe (no CUDA, a kernel that does not build or
  launch, a wrong byte) is a failed canary: its rc and detail are the
  metric and the event, and nothing is retried elsewhere;
- **observability, not traffic**: canary runs never touch the job
  table, the journal, the fair-share queue or the run-metric fold —
  they exist only in the ``pwasm_canary_*`` families, the event log
  (``canary_ok``/``canary_fail``) and their own trace ids (stamped
  as exemplars on the canary wall histogram);
- ``PWASM_CANARY_FAULTS="LO-HI:SPEC"`` (a debug knob): canary runs
  numbered LO..HI (1-based) append ``--inject-faults=SPEC`` — how an
  outage window is scripted without breaking anything real.

No torch at module level: the device is reached only through the
injected runner.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

# how long a tick waits for a free lane before counting itself
# skipped (a reservation would starve real jobs; see module doc)
LANE_GRAB_S = 0.05


def parse_canary_faults(spec: str | None):
    """``"LO-HI:SPEC"`` -> ``(lo, hi, spec)`` or None — the debug
    window of canary run numbers (1-based, inclusive) that carry an
    ``--inject-faults`` spec.  Malformed values are ignored (a debug
    knob must never take the daemon down)."""
    if not spec or ":" not in spec:
        return None
    window, _, fault = spec.partition(":")
    lo, _, hi = window.partition("-")
    try:
        lo_i, hi_i = int(lo), int(hi or lo)
    except ValueError:
        return None
    if lo_i < 1 or hi_i < lo_i or not fault:
        return None
    return (lo_i, hi_i, fault)


class CanaryRunner:
    """The canary loop for one serve daemon.  ``daemon`` supplies the
    pieces (leases, runner, warm context, obs, jobdir); ``metrics``
    is the ``build_canary_metrics`` dict.  Runs on its own thread
    (started by ``Daemon.serve``), exits when the daemon closes or
    drains.  Never raises — a failing canary is a METRIC, not a
    crashed monitor."""

    def __init__(self, daemon, interval_s: float, metrics: dict):
        self.daemon = daemon
        self.interval_s = max(0.01, float(interval_s))
        self.metrics = metrics
        self.golden: str | None = None
        self.runs = 0
        self.fails = 0
        self.skips = 0
        self.last_ok: bool | None = None
        self.last_wall_s: float | None = None
        self.last_detail = ""
        self.last_t: float | None = None
        self._faults = parse_canary_faults(
            os.environ.get("PWASM_CANARY_FAULTS"))
        self._dir: str | None = None
        self._argv_base: list[str] | None = None
        self._lock = threading.Lock()

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.loop, daemon=True,
                             name="pwasm-svc-canary")
        t.start()
        return t

    def _stopping(self) -> bool:
        d = self.daemon
        return d._closing.is_set() or d.drain.requested

    def loop(self) -> None:
        # one full interval before the first probe: daemon startup
        # (journal replay, warmup) owns the first moments
        while not self._stopping():
            if self.daemon._closing.wait(self.interval_s):
                return
            if self._stopping():
                return
            try:
                self.run_once()
            except Exception as e:     # the never-raises contract
                self._record(False, 0.0, f"canary runner error: {e}")

    # ---- one probe -----------------------------------------------------
    def _ensure_corpus(self) -> list[str]:
        """The deterministic probe argv, built once: warmup corpus +
        a daemon-private output path (never a user path — canary runs
        are observability, byte-invisible to real traffic)."""
        if self._argv_base is not None:
            return list(self._argv_base)
        from pwasm_tpu_torch.cli import warmup_files
        d = self.daemon
        self._dir = os.path.join(d._jobdir.name, "canary")
        paf, fa = warmup_files(self._dir)
        out = os.path.join(self._dir, "canary.dfa")
        device = "cpu" if d.warmup == "cpu" else "cuda"
        self._argv_base = [paf, "-r", fa, "-o", out,
                           f"--device={device}", "--batch=8"]
        return list(self._argv_base)

    def _digest(self) -> str:
        out = os.path.join(self._dir, "canary.dfa")
        try:
            with open(out, "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return "missing"

    def run_once(self) -> bool | None:
        """One probe: lease a free lane (or skip), run the corpus,
        verify rc + golden digest, record.  Returns ok/None
        (skipped)."""
        import io

        from pwasm_tpu_torch.obs.events import new_run_id
        from pwasm_tpu_torch.resilience.lifecycle import SignalDrain
        from pwasm_tpu_torch.service.daemon import _JobWarm
        d = self.daemon
        lease = d.leases.acquire(timeout=LANE_GRAB_S,
                                 should_abort=self._stopping)
        if lease is None:
            with self._lock:
                self.skips += 1
            self.metrics["runs"].inc(outcome="skipped")
            return None
        t0 = time.monotonic()
        cid = "canary-" + new_run_id()
        try:
            argv = self._ensure_corpus()
            run_no = self.runs + 1
            if self._faults is not None:
                lo, hi, spec = self._faults
                if lo <= run_no <= hi:
                    argv.append(f"--inject-faults={spec}")
            drain = SignalDrain(stderr=d.stderr,
                                hard_exit=lambda code: None)
            warm = _JobWarm(drain, lease, shared=d.warm,
                            expose_devices=d._expose_devices,
                            trace_id=cid)
            err = io.StringIO()
            try:
                rc = d._runner(argv, stdout=io.StringIO(),
                               stderr=err, warm=warm)
            except BaseException as e:
                rc = None
                err.write(f"canary raised {type(e).__name__}: {e}")
            wall = time.monotonic() - t0
            if rc != 0:
                detail = (f"canary exit {rc}: "
                          + err.getvalue()[-300:].strip())
                return self._record(False, wall, detail, cid)
            digest = self._digest()
            if self.golden is None:
                self.golden = digest
            if digest != self.golden:
                return self._record(
                    False, wall,
                    f"report digest drift: {digest[:16]} != golden "
                    f"{self.golden[:16]}", cid)
            return self._record(True, wall, "", cid)
        finally:
            d.leases.release(lease)

    def _record(self, ok: bool, wall: float, detail: str,
                trace_id: str | None = None) -> bool:
        d = self.daemon
        with self._lock:
            self.runs += 1
            if not ok:
                self.fails += 1
            self.last_ok = ok
            self.last_wall_s = round(wall, 6)
            self.last_detail = detail
            self.last_t = time.time()
        self.metrics["ok"].set(1 if ok else 0)
        self.metrics["wall_seconds"].observe(wall, trace_id=trace_id)
        self.metrics["runs"].inc(outcome="ok" if ok else "fail")
        d.obs.event("canary_ok" if ok else "canary_fail",
                    wall_s=round(wall, 6), run=self.runs,
                    trace_id=trace_id, detail=detail or None)
        return ok

    # ---- introspection (the health verb's canary block) ---------------
    def summary(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "runs": self.runs,
                "fails": self.fails,
                "skipped": self.skips,
                "last_ok": self.last_ok,
                "last_wall_s": self.last_wall_s,
                "last_detail": self.last_detail or None,
                "last_t": round(self.last_t, 3)
                if self.last_t else None,
            }
