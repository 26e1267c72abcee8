"""write_ms: the mean over the window's rc-0 jobs of the ``write`` span's
seconds in the ``stages`` block of their ``--stats``, in ms: the MSA
writers (``-w``'s layout and mfa, ``--ace``, ``--info``, ``--cons``) and
the ``-s`` summary.  None where no job's stats carry the stage (a
program without the stage table)."""

STAGE = "write"


def read(ctx):
    d = [float(r["stats"]["stages"][STAGE]["s"]) for r in ctx.records
         if r["rc"] == 0 and STAGE in (r["stats"].get("stages") or {})]
    return 1e3 * sum(d) / len(d) if d else None
