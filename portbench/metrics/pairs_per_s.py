"""pairs_per_s: query x target pairs of the jobs finished with rc 0, a
second of the window, summed over the closed-loop clients
(``readers.rate``)."""
from portbench import readers


def read(ctx):
    return readers.rate(ctx)
