"""ctx_scan_ms: the mean a job of ``host.analyze_s + host.format_s``
(``--stats``): ctx_scan's submit (pack, upload, launch) and finish
(fetch, assembly, row formatting), in ms."""
from portbench import readers


def read(ctx):
    return readers.host_stage_ms(ctx, ("analyze_s", "format_s"))
