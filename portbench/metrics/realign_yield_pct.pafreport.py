"""realign_yield_pct: the share of the re-aligner's lane launches that
the card resolved, over the window's rc-0 jobs, in %: 100 times the sum
of ``lanes_done`` over the sum of ``lane_dispatches``, the counters of
the ``realign`` row in the ``stages`` block of their ``--stats``.  A
lane that misses its end diagonal is launched again at a wider band, so
the rest is the work band escalation loses.  None where no job's stats
carry the counters."""

STAGE = "realign"


def read(ctx):
    done = sent = 0
    for r in ctx.records:
        row = (r["stats"].get("stages") or {}).get(STAGE) \
            if r["rc"] == 0 else None
        if row is None or "lane_dispatches" not in row:
            continue
        done += int(row["lanes_done"])
        sent += int(row["lane_dispatches"])
    return 100.0 * done / sent if sent else None
