"""parse_extract_ms: the mean a job of ``host.parse_s + host.extract_s``
(``--stats``): the PAF parse and the cs extraction, in ms."""
from portbench import readers


def read(ctx):
    return readers.host_stage_ms(ctx, ("parse_s", "extract_s"))
