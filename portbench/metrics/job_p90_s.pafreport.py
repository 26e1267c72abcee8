"""job_p90_s: the 90th percentile of the client's job wall over the
traced window's jobs, given only with ten or more jobs beyond it."""
from portbench import readers


def read(ctx):
    return readers.percentile([r["wall_s"] for r in ctx.records
                               if r["rc"] == 0], 0.90)
