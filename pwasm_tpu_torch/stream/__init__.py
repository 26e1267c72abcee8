"""Ingest and jobs of the port beside the report path: ``pafstream``
(the block reader of a positional PAF, ``--follow``'s reader of a
growing file, and the line feed of a socket stream) and ``multicds``
(the ``--many2many`` job)."""

from pwasm_tpu_torch.stream.pafstream import (FollowReader, LineAssembler,
                                              StreamFeed)

__all__ = ["FollowReader", "LineAssembler", "StreamFeed"]
