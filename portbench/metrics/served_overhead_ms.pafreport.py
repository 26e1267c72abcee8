"""served_overhead_ms: the mean over the window's jobs of the client's
wall minus the job's own ``wall_s`` (its ``--stats``): the daemon's
queue, lease, protocol and the run's own set-up around its timed body."""
from portbench import readers


def read(ctx):
    return readers.served_overhead_ms(ctx)
