"""The variant-context scan as one program per flush, on a torch device.

Counterpart of ``pwasm_tpu/ops/ctx_scan.py`` (an XLA program in the
reference, with no hand kernel): the formulas of ``ops/ctx_scan_impl.py``
run as plain torch ops on the device the inputs live on.  The transfer
shape is the reference's:

- ``pack_events`` ships the event batch as TWO tensors, the int32
  vectors as one (4, E) tensor and the int8 code planes as one
  (2, E, max_ev) tensor, with the event axis padded to a power of two;
- ``ctx_scan_packed`` returns every output field cast to int32 and
  concatenated into ONE (E, total_width) tensor, so a flush costs a
  single device-to-host fetch.

``FLUSHES`` counts the packed scans by device type ("cuda", "cpu"), so a
run can show where its flushes ran.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from pwasm_tpu_torch.ops.ctx_scan_impl import (ctx_scan_calc,
                                               ctx_scan_layout,
                                               pack_events_np,
                                               pack_motifs_np)

FLUSHES: Counter = Counter()


def pack_events(events, max_ev: int, device: torch.device) -> dict:
    """SoA-pack a list of DiffEvent into tensors on ``device``: two
    host-to-device transfers per flush (see ``pack_events_np`` for the
    power-of-two event-axis bucketing)."""
    d = pack_events_np(events, max_ev)
    ints = torch.from_numpy(np.stack([d["rloc"], d["evt"], d["evtlen"],
                                      d["nbases"]])).to(device)
    codes = torch.from_numpy(np.stack([d["evtbases"],
                                       d["evtsub"]])).to(device)
    return dict(rloc=ints[0], evt=ints[1], evtlen=ints[2],
                nbases=ints[3], evtbases=codes[0], evtsub=codes[1])


def pack_motifs(motifs, device: torch.device):
    """Motif table -> (codes (NM, MAX_MOTIF) int8, lens (NM,) int32)."""
    codes, lens = pack_motifs_np(motifs)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(lens).to(device))


def ctx_scan_packed(ref: torch.Tensor, ref_len: int, ev: dict, mot_codes,
                    mot_lens, max_codons: int = 8, max_len: int = 4096,
                    skip_codan: bool = False) -> torch.Tensor:
    """The fused event analysis with every output field cast to int32
    and concatenated into ONE (E, total_width) tensor on ``ref``'s
    device, in the fixed ``ctx_scan_layout`` order
    (``ctx_scan_impl.unpack_ctx_scan`` splits it back)."""
    FLUSHES[ref.device.type] += 1
    out = ctx_scan_calc(ref, ref_len, ev, mot_codes, mot_lens,
                        max_codons=max_codons, max_len=max_len,
                        skip_codan=skip_codan)
    E = ev["rloc"].shape[0]
    return torch.cat([out[name].to(torch.int32).reshape(E, width)
                      for name, width in ctx_scan_layout(max_codons,
                                                         skip_codan)],
                     dim=1)
