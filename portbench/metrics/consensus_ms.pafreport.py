"""consensus_ms: the mean over the window's rc-0 jobs of the ``consensus``
span's seconds in the ``stages`` block of their ``--stats``, in ms: the
consensus stage (the engine's pileup render and the supervised consensus
dispatch).  None where no job's stats carry the stage (a program without
the stage table)."""

STAGE = "consensus"


def read(ctx):
    d = [float(r["stats"]["stages"][STAGE]["s"]) for r in ctx.records
         if r["rc"] == 0 and STAGE in (r["stats"].get("stages") or {})]
    return 1e3 * sum(d) / len(d) if d else None
