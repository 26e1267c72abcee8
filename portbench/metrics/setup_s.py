"""setup_s: seconds from the process's start to the window's first
submission: the torch import, the inputs, the daemon's start with its
CUDA probe and warmup job, and one job a client of the cell's own
traffic (every kernel it uses loaded from the build directory, or built
there on a checkout's first run)."""


def read(ctx):
    return ctx.setup_s
