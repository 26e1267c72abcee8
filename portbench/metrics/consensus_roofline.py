"""consensus_roofline: the consensus kernel's least time over its
profiled time, in %."""
from portbench import readers

PATTERNS = ("consensus_kernel",)


def read(ctx):
    return readers.roofline_pct(ctx, "consensus", PATTERNS)
