"""refine_ms: the mean over the window's rc-0 jobs of the ``refine`` span's
seconds in the ``stages`` block of their ``--stats``, in ms: the
consensus votes applied back in the engine and its clip refinement
(``refine_external``).  None where no job's stats carry the stage (a
program without the stage table)."""

STAGE = "refine"


def read(ctx):
    d = [float(r["stats"]["stages"][STAGE]["s"]) for r in ctx.records
         if r["rc"] == 0 and STAGE in (r["stats"].get("stages") or {})]
    return 1e3 * sum(d) / len(d) if d else None
