"""device_idle: the share of the traced window in which the profiler
shows no kernel, copy or set on the card, in %."""
from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
