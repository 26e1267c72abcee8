"""``pafreport top`` — live introspection over one socket.

Counterpart of ``pwasm_tpu/service/top.py``, with its names and its
frame.  A refresh-loop terminal view rendered from the daemon's
``stats`` response (the SAME registry-backed svc-stats surface
``pafreport svc-stats`` prints as JSON, so the two cannot disagree):
the SLO engine's alerts pane and the canary, device-lease lanes with
busy fraction and breaker state, queued jobs per fair-share client,
live streams with buffer lag, m2m-stream sessions, the result cache and
the job-outcome counters.  The fleet panes (members, quarantine, shed)
render from whatever the stats carry.

``--once`` renders a single frame and exits (the scriptable/testable
form; the refresh loop just repaints it).  Rendering is a pure
function of the stats dict (:func:`render`), unit-tested directly.
No torch: a ``top`` process stays light.
"""

from __future__ import annotations

import time

from pwasm_tpu_torch.core.errors import EXIT_FATAL, EXIT_USAGE

_TOP_USAGE = """Usage:
 pafreport top --socket=TARGET [--interval=S] [--once]

   --socket=TARGET the serve daemon's unix socket or a HOST:PORT
                   TCP endpoint
   --interval=S    refresh period in seconds (default 2)
   --once          render one frame and exit (no screen clearing)

 Ctrl-C exits.  The view is rendered from the daemon's svc-stats
 response.
"""

_BREAKER_NAMES = {0: "closed", 1: "HALF-OPEN", 2: "OPEN"}


def _fmt_breaker(v) -> str:
    return _BREAKER_NAMES.get(v, str(v))


def render(st: dict) -> str:
    """One ``top`` frame from a svc-stats dict — pure and total:
    missing blocks render as empty sections, never a crash (an older
    daemon's stats must still display)."""
    out: list[str] = []
    jobs = st.get("jobs") or {}
    fleet = st.get("fleet") or {}
    out.append(
        ("pwasm-tpu top (FLEET)" if fleet else "pwasm-tpu top")
        + f" — uptime {st.get('uptime_s', 0):.0f}s"
        + ("  [DRAINING]" if st.get("draining") else "")
        + f"  breaker {_fmt_breaker(st.get('breaker_state', 0))}")
    if fleet:
        # fleet-aware view (the `route` daemon's aggregated stats):
        # one row per member daemon, liveness first — "is anything
        # down" is the fleet operator's question zero
        members = fleet.get("members") or []
        out.append(
            f" fleet: {fleet.get('alive', 0)}/{len(members)} members "
            f"up | routed {fleet.get('jobs_routed', 0)}  live "
            f"{fleet.get('live_jobs', 0)}  failovers "
            f"{fleet.get('failovers', 0)}")
        shed = (st.get("ha") or {}).get("shed") or {}
        if shed.get("level"):
            # the brownout banner: the operator must see
            # turned-away tiers before reading any member row
            out.append(
                " SHEDDING: tier(s) "
                + (",".join(shed.get("lanes_shed") or []) or "?")
                + f" turned away (level {shed.get('level')})")
        out.append(" MEMBER                 STATE  DEPTH  RUN  ROUTED"
                   "    LAT")
        for row in members:
            alive = row.get("alive")
            # one word, worst condition first: a quarantined (gray)
            # or fenced member is "up" but taking no placements —
            # rendering it as plain up hides the exact state this
            # view exists to surface
            state = ("DOWN" if not alive
                     else "QUAR" if row.get("quarantined")
                     else "FENC" if row.get("fenced") else "up")
            lat = row.get("lat_ewma_ms")
            out.append(
                f"   {str(row.get('name', '?')):<20} "
                + f"{state:>5}  "
                + (f"{row.get('queue_depth', 0) or 0:>5}  "
                   f"{row.get('running', 0) or 0:>3}  "
                   if alive else "    -    -  ")
                + f"{row.get('jobs_routed', 0):>6}  "
                + (f"{lat:>5.0f}" if isinstance(lat, (int, float))
                   and alive else "    -"))
        rec = fleet.get("jobs_recovered") or {}
        recovered = {k: v for k, v in sorted(rec.items()) if v}
        if recovered:
            out.append(" recovered: " + "  ".join(
                f"{k} {v}" for k, v in recovered.items()))
    # the alerts pane: the SLO engine's verdict + firing
    # rules, from the same health block the `health` verb serves —
    # "is anything wrong" before any counter reading.  On a fleet
    # view the verdict can be degraded/failing through a MEMBER's own
    # rules while the router's are all quiet — those members render
    # here too, or the pane would say "none" under a failing verdict.
    health = st.get("health") or {}
    firing = health.get("firing") or []
    bad_members = {n: m for n, m in
                   (health.get("members") or {}).items()
                   if isinstance(m, dict)
                   and m.get("verdict") not in ("ok", None)}
    if health:
        parts = [
            f"{f.get('rule', '?')}[{f.get('severity', '?')}"
            + (f" {f.get('since_s', 0):.0f}s" if f.get("since_s")
               else "") + "]"
            for f in firing if isinstance(f, dict)]
        parts += [
            f"{n}={m.get('verdict')}"
            + (f"({','.join(str(r) for r in m.get('firing'))})"
               if m.get("firing") else "")
            for n, m in sorted(bad_members.items())]
        if parts or health.get("verdict", "ok") != "ok":
            out.append(
                f" ALERTS ({health.get('verdict', '?')}): "
                + ("  ".join(parts) if parts else "(see members)"))
        else:
            out.append(" ALERTS: none")
    canary = health.get("canary") or {}
    if canary.get("runs"):
        ok = canary.get("last_ok")
        out.append(
            f" canary: {'ok' if ok else 'FAILING'} "
            f"({canary.get('runs', 0)} runs, "
            f"{canary.get('fails', 0)} fails, last "
            f"{canary.get('last_wall_s') or 0:.3f}s)")
    out.append(
        f" jobs: {st.get('running', 0)} running, "
        f"{st.get('queue_depth', 0)} queued | "
        f"done {jobs.get('completed', 0)}  "
        f"failed {jobs.get('failed', 0)}  "
        f"preempted {jobs.get('preempted', 0)}  "
        f"cancelled {jobs.get('cancelled', 0)}  "
        f"rejected {jobs.get('rejected', 0)}  "
        f"recovered {jobs.get('recovered', 0)}")
    lanes = st.get("lanes") or []
    if lanes:
        uptime = max(1e-9, float(st.get("uptime_s") or 0) or 1e-9)
        out.append("")
        out.append(" LANE  DEVICES   STATE  JOBS  BUSY%  BREAKER")
        for row in lanes:
            dev = row.get("devices") or [0, 0]
            busy_pct = 100.0 * min(
                1.0, float(row.get("busy_s") or 0.0) / uptime)
            out.append(
                f" {row.get('lane', '?'):>4}  "
                f"[{dev[0]},{dev[1]}) ".ljust(10)
                + f"{'busy' if row.get('busy') else 'idle':>5}  "
                f"{row.get('jobs_run', 0):>4}  "
                f"{busy_pct:>4.0f}%  "
                f"{_fmt_breaker(row.get('breaker_state', 0))}")
    fair = st.get("fair_share") or {}
    clients = fair.get("clients") or {}
    queued = {c: n for c, n in sorted(clients.items()) if n}
    out.append("")
    if queued:
        out.append(f" QUEUE by client (quota "
                   f"{fair.get('max_queue_per_client', '?')}/client, "
                   f"{fair.get('max_queue_total', '?')} total):")
        for c, n in queued.items():
            out.append(f"   {c:<24} {n}")
    else:
        out.append(" QUEUE empty")
    streams = st.get("streams") or {}
    if streams.get("active"):
        out.append(
            f" STREAMS: {streams.get('active')} live, "
            f"lag {streams.get('lag_records', 0)}/"
            f"{streams.get('max_buffer_total', '?')} records "
            f"(records in {streams.get('records_in', 0)}, "
            f"batches {streams.get('batches', 0)})")
    else:
        out.append(" STREAMS: none")
    m2m = st.get("m2m") or {}
    if m2m.get("active") or m2m.get("sessions"):
        # continuous surveillance: live session flow plus
        # the incremental win — how much of the pair matrix the
        # section cache spliced instead of re-scoring
        pairs = (m2m.get("pairs_dispatched", 0)
                 + m2m.get("pairs_reused", 0))
        ratio = 100.0 * m2m.get("pairs_reused", 0) / pairs \
            if pairs else 0.0
        out.append(
            f" M2M: {m2m.get('active', 0)} live / "
            f"{m2m.get('sessions', 0)} session(s), "
            f"targets {m2m.get('targets_scored', 0)} scored + "
            f"{m2m.get('targets_reused', 0)} reused of "
            f"{m2m.get('targets_in', 0)} | pairs "
            f"{m2m.get('pairs_dispatched', 0)} dispatched, "
            f"{m2m.get('pairs_reused', 0)} spliced "
            f"({ratio:.0f}% reuse), "
            f"{m2m.get('sections_emitted', 0)} section(s)")
    cache = st.get("cache") or {}
    if cache.get("enabled"):
        # the result cache: hit flow + on-disk footprint —
        # "is repeat traffic actually landing on the fast path" (and
        # eviction keeping pace with insertion is the cache_thrash
        # page's precursor, visible here first)
        out.append(
            f" CACHE: {cache.get('hits', 0)} hits / "
            f"{cache.get('misses', 0)} misses "
            f"(ratio {100.0 * float(cache.get('hit_ratio') or 0):.0f}"
            f"%) | {cache.get('insertions', 0)} inserted, "
            f"{cache.get('evictions', 0)} evicted, "
            f"{cache.get('bytes', 0)} bytes")
    warm = st.get("warm") or {}
    journal = st.get("journal") or {}
    out.append(
        f" warm hits {warm.get('backend_warm_hits', 0)} / probes "
        f"{warm.get('backend_probes', 0)} | journal "
        f"{'BROKEN' if journal.get('broken') else 'ok'}, "
        f"{journal.get('records', 0)} records, "
        f"{journal.get('replays', 0)} replay(s)")
    return "\n".join(out) + "\n"


def top_main(argv: list[str], stdout=None, stderr=None) -> int:
    """The ``pafreport top`` entry point."""
    import sys
    stdout = stdout if stdout is not None else sys.stdout
    stderr = stderr if stderr is not None else sys.stderr
    sock = None
    interval = 2.0
    once = False
    for a in argv:
        if a.startswith("--socket="):
            sock = a.split("=", 1)[1]
        elif a.startswith("--interval="):
            import math
            try:
                interval = float(a.split("=", 1)[1])
                if interval <= 0 or not math.isfinite(interval):
                    raise ValueError
            except (TypeError, ValueError):
                stderr.write(f"{_TOP_USAGE}\nInvalid --interval "
                             f"value: {a.split('=', 1)[1]}\n")
                return EXIT_USAGE
        elif a == "--once":
            once = True
        elif a in ("-h", "--help"):
            stderr.write(_TOP_USAGE)
            return EXIT_USAGE
        else:
            stderr.write(f"{_TOP_USAGE}\nInvalid argument: {a}\n")
            return EXIT_USAGE
    if not sock:
        stderr.write(f"{_TOP_USAGE}\nError: --socket=PATH is "
                     "required\n")
        return EXIT_USAGE
    from pwasm_tpu_torch.service.client import ServiceClient, ServiceError
    try:
        while True:
            try:
                with ServiceClient(sock, timeout=10.0) as c:
                    resp = c.stats()
            except ServiceError as e:
                stderr.write(f"Error: {e}\n")
                return EXIT_FATAL
            if not resp.get("ok"):
                stderr.write(f"Error: stats failed: {resp}\n")
                return EXIT_FATAL
            frame = render(resp["stats"])
            if not once:
                stdout.write("\x1b[H\x1b[2J")   # home+clear: repaint
            stdout.write(frame)
            try:
                stdout.flush()
            except Exception:
                pass
            if once:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        # "Ctrl-C exits" means exits CLEANLY — wherever it lands (the
        # in-flight stats RPC included), never a traceback
        return 0
