"""scores_roofline: the scores kernels' least time over their profiled
time, in %."""
from portbench import readers

PATTERNS = ("scores_subwarp_kernel", "scores_stream_kernel",
            "scores_kernel")


def read(ctx):
    return readers.roofline_pct(ctx, "scores", PATTERNS)
