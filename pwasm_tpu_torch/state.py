"""The system's state: lookup tables and constants, as tensors.

pwasm has no learned weights.  What the device programs read besides
their inputs is a handful of tables and constants:

- ``motif_codes`` / ``motif_lens``: the default methylation-motif table,
  packed as the ctx_scan program reads it;
- ``aa_lut``: the 5^3 codon -> amino-acid LUT;
- ``encode_table``: the byte -> base-code table;
- ``refine_consts``: the clip-refinement constants (XDROP, MATCH_SC,
  MISMATCH_SC).

``from_reference`` takes these as numpy arrays, as the JAX package
builds them, and returns the port's tensors, checked against the
port's own copies.
"""

from __future__ import annotations

import numpy as np
import torch

STATE_KEYS = ("motif_codes", "motif_lens", "aa_lut", "encode_table",
              "refine_consts")


def builtin_arrays() -> dict[str, np.ndarray]:
    """The port's own tables, as numpy arrays."""
    from pwasm_tpu_torch.align.gapseq import GapSeq
    from pwasm_tpu_torch.core.config import DEFAULT_MOTIFS
    from pwasm_tpu_torch.core.dna import AA_LUT, ENCODE_TABLE
    from pwasm_tpu_torch.ops.ctx_scan_impl import pack_motifs_np

    codes, lens = pack_motifs_np(DEFAULT_MOTIFS)
    return dict(motif_codes=codes, motif_lens=lens, aa_lut=AA_LUT,
                encode_table=ENCODE_TABLE,
                refine_consts=np.array([GapSeq.XDROP, GapSeq.MATCH_SC,
                                        GapSeq.MISMATCH_SC], np.int32))


def from_reference(arrays: dict[str, np.ndarray],
                   device: torch.device) -> dict[str, torch.Tensor]:
    """Convert the reference's state arrays into tensors on ``device``.
    Raises ValueError when a key is missing or a table's shape or dtype
    differs from the port's own copy."""
    own = builtin_arrays()
    out = {}
    for key in STATE_KEYS:
        if key not in arrays:
            raise ValueError(f"state: missing {key!r}")
        a = np.asarray(arrays[key])
        if a.shape != own[key].shape or a.dtype != own[key].dtype:
            raise ValueError(
                f"state: {key!r} is {a.dtype}{a.shape}, the port's is "
                f"{own[key].dtype}{own[key].shape}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out
