"""Continuous many2many — the surveillance pipeline.

Counterpart of ``pwasm_tpu/surveil/``, with its names.  Target FASTAs
arrive incrementally over the stream verbs, are scored against a
resident query set with incremental per-CDS section emission
(``session.py``), and — behind a fleet router — are partitioned
across members and merged back into one byte-identical report
(``partition.py``).  No torch at module level: all device work stays
behind ``stream/multicds.py`` and ``parallel/many2many.py``.
"""

from pwasm_tpu_torch.surveil.partition import (ScatterState,
                                               merge_fragments,
                                               rewrite_out_args)
from pwasm_tpu_torch.surveil.records import FastaAssembler, parse_record

__all__ = ["FastaAssembler", "parse_record", "ScatterState",
           "merge_fragments", "rewrite_out_args"]
