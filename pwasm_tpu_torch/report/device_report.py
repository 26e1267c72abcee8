"""Device-path diff analysis: batch the events of many alignments through
the packed ctx_scan program, then assemble the same report rows as the
scalar path.

Division of labor: the device computes homopolymer/motif attribution and
the codon-impact amino acids over the whole event batch in one program;
the host slices the 9bp context strings (byte-faithful for IUPAC
ambiguity characters that the int8 code space collapses to N) and
formats rows with the shared formatter.

Transfer shape: events ship as two stacked tensors, the reference pads
to a power-of-two bucket, and the whole analysis returns as ONE packed
int32 fetch per reference group.

Routing: events longer than ``max_ev`` bases are analyzed by the scalar
host analyzer, exactly as the reference routes them.
"""

from __future__ import annotations

import numpy as np
import torch

from pwasm_tpu_torch.core.config import DEFAULT_MOTIFS
from pwasm_tpu_torch.core.dna import encode
from pwasm_tpu_torch.obs.dispatch import NULL_HOOK
from pwasm_tpu_torch.ops.ctx_scan import (ctx_scan_packed, pack_motifs,
                                          upload_events)
from pwasm_tpu_torch.ops.ctx_scan_impl import (PAD, pack_events_np,
                                               ref_bucket_len,
                                               unpack_ctx_scan)
from pwasm_tpu_torch.parallel.mesh import as_mesh, flat_devices, shard_bounds
from pwasm_tpu_torch.report.columnar import assemble_results, emit_batch_rows
from pwasm_tpu_torch.report.diff_report import analyze_event_host

MAX_EV = 16


def submit_events_device(refseq: bytes, events, device,
                         skip_codan: bool = False,
                         motifs=DEFAULT_MOTIFS, max_ev: int = MAX_EV,
                         hook=NULL_HOOK):
    """Launch the analysis of a batch of DiffEvents on ``device`` (a
    ``torch.device``, or a mesh of them) and return a ``finish() ->
    list[tuple]`` closure that fetches and assembles the results.

    Device work is asynchronous on CUDA, so between ``submit`` and
    ``finish`` the card computes while the host formats earlier batches
    (the CLI keeps a two-deep in-flight pipeline).  The packed event
    axis splits over every axis of the mesh (``parallel/mesh.py``,
    ``pafreport --shard``; a device is its one-shard mesh): each shard's
    rows, the reference and the motif tables go to its device, one
    ``ctx_scan_packed`` runs there, and ``finish`` joins the shards in
    event order (the analysis of an event reads no other event).

    ``hook`` (``obs/dispatch.py``) counts the padded event axis and,
    once the fetch succeeded, the events the device analyzed and those
    the host analyzed; the fetch is one ``ctx_scan`` dispatch through
    it, the whole mesh's shards together."""
    if not events:
        return lambda: []
    ref_len = len(refseq)
    max_codons = max_ev // 3 + 2
    # the reference tensor is padded to a power-of-two bucket; positions
    # >= ref_len hold PAD, which never matches a base and is masked by
    # ref_len elsewhere
    max_len = ref_bucket_len(ref_len, max_ev)
    fits = [len(ev.evtbases) <= max_ev and len(ev.evtsub) <= max_ev
            for ev in events]
    small = [ev for ev, ok in zip(events, fits) if ok]
    big = [ev for ev, ok in zip(events, fits) if not ok]
    packed = []
    if small:
        ref_codes = np.full(max_len, PAD, dtype=np.int8)
        ref_codes[:ref_len] = encode(refseq.upper())
        d = pack_events_np(small, max_ev)
        # the event axis is padded to its power-of-two bucket
        hook.note_pad(len(small), len(d["rloc"]))
        devs = flat_devices(as_mesh(device))
        spans = [(dev, a, b) for dev, (a, b)
                 in zip(devs, shard_bounds(len(d["rloc"]), len(devs)))
                 if a < b]
        for dev, a, b in spans:
            packed.append(ctx_scan_packed(
                torch.from_numpy(ref_codes).to(dev), ref_len,
                upload_events(d, dev, slice(a, b)),
                *pack_motifs(motifs, dev), max_codons=max_codons,
                max_len=max_len, skip_codan=skip_codan))

    def finish() -> list[tuple]:
        results: dict[int, tuple] = {}
        if small:
            # one host fetch a shard, joined in event order, then numpy
            # views
            flat = hook.run("ctx_scan", lambda: np.concatenate(
                [p.cpu().numpy() for p in packed]), items=len(small))
            hook.note_events(device=len(small))
            host = unpack_ctx_scan(flat, max_codons, skip_codan)
            for ev, r in zip(small, assemble_results(
                    small, host, refseq, motifs, skip_codan)):
                results[id(ev)] = r
        hook.note_events(scalar=len(big))
        for ev in big:
            results[id(ev)] = analyze_event_host(ev, refseq, skip_codan,
                                                 motifs)
        return [results[id(ev)] for ev in events]

    return finish


def submit_diff_info_batch(batch, f, device,
                           skip_codan: bool = False,
                           motifs=DEFAULT_MOTIFS, summary=None,
                           max_ev: int = MAX_EV, hook=NULL_HOOK):
    """Launch the analysis for a report batch and return a
    ``finish() -> None`` closure that fetches the results and writes the
    rows.

    ``batch`` is a list of (aln: PafAlignment, rlabel, tlabel,
    refseq: bytes) in input order.  Events are grouped per distinct
    refseq (the program is specialized on the reference tensor),
    analyzed in one ``ctx_scan_packed`` call per group, then rows are
    emitted in exactly the order the scalar path would produce.
    ``device`` is a ``torch.device`` or a mesh each group's events shard
    over (``submit_events_device``, which counts and dispatches through
    ``hook``)."""
    groups: dict[bytes, list] = {}
    for aln, _rl, _tl, refseq in batch:
        groups.setdefault(refseq, []).extend(aln.tdiffs)
    finishes = [(events, submit_events_device(refseq, events, device,
                                              skip_codan, motifs, max_ev,
                                              hook))
                for refseq, events in groups.items()]

    def finish() -> None:
        analyzed: dict[int, tuple] = {}
        for events, fin in finishes:
            for ev, r in zip(events, fin()):
                analyzed[id(ev)] = r
        emit_batch_rows(batch, analyzed, f, summary)

    return finish
