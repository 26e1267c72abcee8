"""realign_ms: the mean over the window's rc-0 jobs of the ``realign``
span's seconds in the ``stages`` block of their ``--stats``, in ms: the
re-aligner (``realign_pairs``: encoding, bucketing, its supervised
kernel dispatches and the host oracle).  None where no job's stats carry
the stage (a program without the stage table)."""

STAGE = "realign"


def read(ctx):
    d = [float(r["stats"]["stages"][STAGE]["s"]) for r in ctx.records
         if r["rc"] == 0 and STAGE in (r["stats"].get("stages") or {})]
    return 1e3 * sum(d) / len(d) if d else None
