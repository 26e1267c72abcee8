"""What the metric readers under ``metrics/`` share: the rate of a closed
loop's work, a job's wall beyond its run, the means of ``--stats`` host
stages, the device's idle share, and a layer's roofline share from the
profiled kernel time and the driver's least work.  A reader that finds
nothing to read returns None, and the harness leaves its metric out."""

from __future__ import annotations

import math


def rate(ctx) -> float | None:
    """Work a second: the sum over clients of the work of the jobs a
    client finished with rc 0 over its own window (from its first
    submission to the end of its last job)."""
    total = 0.0
    for c, end in ctx.client_ends.items():
        begin = ctx.client_begins.get(c, ctx.t0) or ctx.t0
        if end is None or end <= begin:
            continue
        work = sum(r["work"] for r in ctx.records
                   if r["client"] == c and r["rc"] == 0)
        total += work / (end - begin)
    return total or None


def served_overhead_ms(ctx) -> float | None:
    """Mean over the window's jobs of the client's wall minus the run's
    own ``wall_s`` (its ``--stats``), in ms."""
    d = [r["wall_s"] - float(r["stats"]["wall_s"]) for r in ctx.records
         if r["rc"] == 0 and "wall_s" in r["stats"]]
    return 1e3 * sum(d) / len(d) if d else None


def percentile(values: list, q: float, beyond: int = 10) -> float | None:
    """The ``q`` quantile (nearest rank) of ``values`` when at least
    ``beyond`` samples lie above it, else None."""
    v = sorted(values)
    n = len(v)
    if not n:
        return None
    k = max(0, math.ceil(q * n) - 1)
    if n - 1 - k < beyond:
        return None
    return v[k]


def host_stage_ms(ctx, keys: tuple) -> float | None:
    """Mean over the window's jobs of the sum of ``host.<key>`` of their
    ``--stats``, in ms."""
    d = [sum(float(r["stats"]["host"][k]) for k in keys)
         for r in ctx.records if r["rc"] == 0 and "host" in r["stats"]]
    return 1e3 * sum(d) / len(d) if d else None


def idle_pct(ctx) -> float | None:
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(ctx, layer: str, patterns: tuple) -> float | None:
    """The layer's least time over its profiled kernel time, in %: the
    least time is, for each window job, the larger of its operations over
    the integer peak and its bytes over the memory peak (the driver's
    ``kernel_work``), summed; the kernel time sums the trace's kernels
    whose names hold one of ``patterns``."""
    t = ctx.trace
    if not t:
        return None
    spent = sum(d for _s, d, name, cat in t["device"]
                if cat == "kernel" and any(p in name for p in patterns))
    if spent <= 0:
        return None
    plan = ctx.plan
    least = 0.0
    for r in ctx.records:
        if r["rc"] != 0:
            continue
        w = plan.driver.kernel_work(plan.config, plan.traffic, ctx.inputs,
                                    r["key"]).get(layer)
        if w is None:
            return None
        ops, nbytes = w
        least += max(ops / ctx.peaks["int_ops_per_s"],
                     nbytes / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / spent if least > 0 else None
