"""The variant-context scan as one program per flush, on a torch device.

Counterpart of ``pwasm_tpu/ops/ctx_scan.py`` (an XLA program in the
reference, with no hand kernel): the formulas of ``ops/ctx_scan_impl.py``
run as plain torch ops on the device the inputs live on: ``ctx_scan``
returns the fields as a dict, and the five stage functions
(``ref_context_windows``, ``hpoly_flags``, ``motif_hits``,
``sub_impact``, ``indel_stop_scan``) are its parts.  The transfer shape
of the packed form is the reference's:

- ``pack_events`` ships the event batch as TWO tensors, the int32
  vectors as one (4, E) tensor and the int8 code planes as one
  (2, E, max_ev) tensor, with the event axis padded to a power of two;
- ``ctx_scan_packed`` returns every output field cast to int32 and
  concatenated into ONE (E, total_width) tensor, so a flush costs a
  single device-to-host fetch.

``FLUSHES`` counts the packed scans by device type ("cuda", "cpu"), so a
run can show where its flushes ran; a flush sharded over a mesh counts
one scan per shard.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from pwasm_tpu_torch.ops.ctx_scan_impl import (  # noqa: F401
    ctx_scan_calc, ctx_scan_layout, hpoly_flags, indel_stop_scan,
    motif_hits, pack_events_np, pack_motifs_np, ref_context_windows,
    sub_impact)

FLUSHES: Counter = Counter()


def pack_events(events, max_ev: int, device: torch.device) -> dict:
    """SoA-pack a list of DiffEvent into tensors on ``device``: two
    host-to-device transfers per flush (see ``pack_events_np`` for the
    power-of-two event-axis bucketing)."""
    return upload_events(pack_events_np(events, max_ev), device)


def upload_events(d: dict, device: torch.device,
                  rows: slice = slice(None)) -> dict:
    """The rows ``rows`` of ``pack_events_np``'s arrays as tensors on
    ``device``: the int32 vectors as one (4, E) transfer and the int8
    code planes as one (2, E, max_ev) transfer."""
    ints = torch.from_numpy(np.stack([d[k][rows] for k in (
        "rloc", "evt", "evtlen", "nbases")])).to(device)
    codes = torch.from_numpy(np.stack([d["evtbases"][rows],
                                       d["evtsub"][rows]])).to(device)
    return dict(rloc=ints[0], evt=ints[1], evtlen=ints[2],
                nbases=ints[3], evtbases=codes[0], evtsub=codes[1])


def pack_motifs(motifs, device: torch.device):
    """Motif table -> (codes (NM, MAX_MOTIF) int8, lens (NM,) int32)."""
    codes, lens = pack_motifs_np(motifs)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(lens).to(device))


def ctx_scan(ref: torch.Tensor, ref_len: int, ev: dict, mot_codes,
             mot_lens, max_codons: int = 8, max_len: int = 4096,
             skip_codan: bool = False) -> dict:
    """The fused event analysis on ``ref``'s device: a dict of tensors
    there, one per ``ctx_scan_layout`` field (``ev`` as ``pack_events``
    gives it)."""
    return ctx_scan_calc(ref, ref_len, ev, mot_codes, mot_lens,
                         max_codons=max_codons, max_len=max_len,
                         skip_codan=skip_codan)


def ctx_scan_packed(ref: torch.Tensor, ref_len: int, ev: dict, mot_codes,
                    mot_lens, max_codons: int = 8, max_len: int = 4096,
                    skip_codan: bool = False) -> torch.Tensor:
    """The fused event analysis with every output field cast to int32
    and concatenated into ONE (E, total_width) tensor on ``ref``'s
    device, in the fixed ``ctx_scan_layout`` order
    (``ctx_scan_impl.unpack_ctx_scan`` splits it back)."""
    FLUSHES[ref.device.type] += 1
    out = ctx_scan(ref, ref_len, ev, mot_codes, mot_lens, max_codons,
                   max_len, skip_codan)
    E = ev["rloc"].shape[0]
    return torch.cat([out[name].to(torch.int32).reshape(E, width)
                      for name, width in ctx_scan_layout(max_codons,
                                                         skip_codan)],
                     dim=1)
