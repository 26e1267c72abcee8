"""realign_roofline: the re-alignment kernels' least time over their
profiled time, in %.  Kernels: the forward pass's and the walk's."""
from portbench import readers

PATTERNS = ("fwd_subwarp_kernel", "fwd_stream_kernel", "fwdptr_kernel",
            "walk_ring_kernel", "walk_wide_kernel")


def read(ctx):
    return readers.roofline_pct(ctx, "realign", PATTERNS)
