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
from pwasm_tpu_torch.ops.ctx_scan import (ctx_scan_packed, pack_motifs,
                                          upload_events)
from pwasm_tpu_torch.ops.ctx_scan_impl import (PAD, next_pow2,
                                               pack_events_np,
                                               ref_bucket_len,
                                               unpack_ctx_scan)
from pwasm_tpu_torch.parallel.mesh import as_mesh, flat_devices, shard_bounds
from pwasm_tpu_torch.report.columnar import assemble_results, emit_batch_rows
from pwasm_tpu_torch.report.diff_report import analyze_event_host
from pwasm_tpu_torch.resilience.guardrails import check_ctx_scan
from pwasm_tpu_torch.resilience.supervisor import BisectableBatch

MAX_EV = 16


def submit_events_device(refseq: bytes, events, device,
                         skip_codan: bool = False,
                         motifs=DEFAULT_MOTIFS, max_ev: int = MAX_EV,
                         stats=None, supervisor=None):
    """Launch the analysis of a batch of DiffEvents on ``device`` (a
    ``torch.device``, or a mesh of them) and return a ``finish() ->
    list[tuple]`` closure that fetches and assembles the results.

    Device work is asynchronous on CUDA, so between ``submit`` and
    ``finish`` the card computes while the host formats earlier batches
    (the CLI keeps a two-deep in-flight pipeline).  The packed event
    axis splits over every axis of the mesh (``parallel/mesh.py``,
    ``pafreport --shard``; a device is its one-shard mesh): each shard's
    rows, the reference and the motif tables go to its device, one
    ``ctx_scan_packed`` runs there, and the fetch joins the shards in
    event order (the analysis of an event reads no other event).

    ``supervisor`` (``resilience/supervisor.py``) supervises the fetch
    as one ``ctx_scan`` dispatch: the host outputs are checked by
    ``check_ctx_scan``, a failed or rejected fetch re-submits the
    program, and a device OOM bisects the events (the one
    ``BisectableBatch`` site).  A flush is pre-chunked to the run's
    demoted ``bucket_ceiling``, each chunk supervised on its own.
    Without a supervisor the fetch is a direct call that counts its
    round-trip into ``stats`` (a ``RunStats``) itself.  ``stats`` also
    counts each launch's padded event axis and, once the fetch
    succeeded, the events the device analyzed and those the host
    analyzed."""
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
    out = None
    chunks: list[list] = []
    pre: list = []
    if small:
        ref_codes = np.full(max_len, PAD, dtype=np.int8)
        ref_codes[:ref_len] = encode(refseq.upper())
        devs = flat_devices(as_mesh(device))

        def launch_for(evs) -> list:
            d = pack_events_np(evs, max_ev)
            return [ctx_scan_packed(
                torch.from_numpy(ref_codes).to(dev), ref_len,
                upload_events(d, dev, slice(a, b)),
                *pack_motifs(motifs, dev), max_codons=max_codons,
                max_len=max_len, skip_codan=skip_codan)
                for dev, (a, b) in zip(devs, shard_bounds(
                    len(d["rloc"]), len(devs))) if a < b]

        def note_pad(evs) -> None:
            # the event axis is padded to its power-of-two bucket
            if stats is not None:
                stats.note_pad(len(evs), next_pow2(len(evs)))

        if supervisor is None:
            note_pad(small)
            out = launch_for(small)
        else:
            # a device OOM demoted the run's pow2 batch ceiling: chunk
            # this flush to it so the allocation that failed is never
            # launched again; each chunk is supervised on its own
            ceil = supervisor.bucket_ceiling
            if ceil and len(small) > ceil:
                chunks = [small[i:i + ceil]
                          for i in range(0, len(small), ceil)]
            else:
                chunks = [small]
            for evs in chunks:
                note_pad(evs)
                try:
                    pre.append(launch_for(evs))  # async submit; a
                except Exception:    # failure is retried at finish,
                    pre.append(None)  # inside the supervised attempt

    def fetch_unpack(parts: list) -> dict:
        # one host fetch a shard, joined in event order (a fresh host
        # array an attempt), then numpy views
        return unpack_ctx_scan(np.concatenate(
            [p.cpu().numpy() for p in parts]), max_codons, skip_codan)

    def merge_parts(parts) -> dict:
        """Reassemble per-part host dicts in item order: each part
        contributes exactly its live rows (its arrays are padded to a
        bucket, so slice before concatenating)."""
        if len(parts) == 1:
            return parts[0][1]
        keys = list(parts[0][1].keys())
        return {k: np.concatenate(
            [np.asarray(r[k])[:len(evs)] for evs, r in parts], axis=0)
            for k in keys}

    def finish() -> list[tuple]:
        results: dict[int, tuple] = {}
        if small:
            if supervisor is not None:
                def validate_for(h, evs):
                    check_ctx_scan(h, len(evs), ref_len, len(motifs),
                                   skip_codan)

                parts = []
                for evs, submitted in zip(chunks, pre):
                    pending = [submitted]

                    def attempt(evs=evs, pending=pending):
                        o = pending.pop() if pending else None
                        o = launch_for(evs) if o is None else o
                        return fetch_unpack(o)

                    part = supervisor.run(
                        "ctx_scan", attempt,
                        validate=lambda h, evs=evs: validate_for(h, evs),
                        bisect=BisectableBatch(
                            items=evs,
                            attempt_for=lambda e: fetch_unpack(
                                launch_for(e)),
                            combine=merge_parts,
                            validate_for=validate_for))
                    parts.append((evs, part))
                host = merge_parts(parts)
            else:
                if stats is not None:
                    # a direct call counts its round-trip here (a
                    # supervised one inside supervisor.run)
                    stats.note_dispatch("ctx_scan")
                    stats.note_flush()
                host = fetch_unpack(out)
            if stats is not None:
                # credited only once the fetch succeeded
                stats.device_events += len(small)
            for ev, r in zip(small, assemble_results(
                    small, host, refseq, motifs, skip_codan)):
                results[id(ev)] = r
        if big and stats is not None:
            stats.scalar_events += len(big)
        for ev in big:
            results[id(ev)] = analyze_event_host(ev, refseq, skip_codan,
                                                 motifs)
        return [results[id(ev)] for ev in events]

    return finish


def analyze_events_device(refseq: bytes, events, device,
                          skip_codan: bool = False,
                          motifs=DEFAULT_MOTIFS,
                          max_ev: int = MAX_EV) -> list[tuple]:
    """Synchronous submit and finish on ``device``: a list of (aa, aapos,
    rctx, status, impact) tuples in event order, the contract of
    ``analyze_event_host`` (which, like this, upper-cases each event's
    ``evtbases`` in place, as printDiffInfo does)."""
    return submit_events_device(refseq, events, device, skip_codan,
                                motifs, max_ev)()


def submit_diff_info_batch(batch, f, device,
                           skip_codan: bool = False,
                           motifs=DEFAULT_MOTIFS, summary=None,
                           max_ev: int = MAX_EV, stats=None,
                           supervisor=None):
    """Launch the analysis for a report batch and return a
    ``finish() -> None`` closure that fetches the results and writes the
    rows.

    ``batch`` is a list of (aln: PafAlignment, rlabel, tlabel,
    refseq: bytes) in input order.  Events are grouped per distinct
    refseq (the program is specialized on the reference tensor),
    analyzed in one ``ctx_scan_packed`` call per group, then rows are
    emitted in exactly the order the scalar path would produce.
    ``device`` is a ``torch.device`` or a mesh each group's events shard
    over (``submit_events_device``, which counts into ``stats`` and
    dispatches through ``supervisor``)."""
    groups: dict[bytes, list] = {}
    for aln, _rl, _tl, refseq in batch:
        groups.setdefault(refseq, []).extend(aln.tdiffs)
    finishes = [(events, submit_events_device(refseq, events, device,
                                              skip_codan, motifs, max_ev,
                                              stats, supervisor))
                for refseq, events in groups.items()]

    def finish() -> None:
        analyzed: dict[int, tuple] = {}
        for events, fin in finishes:
            for ev, r in zip(events, fin()):
                analyzed[id(ev)] = r
        emit_batch_rows(batch, analyzed, f, summary)

    return finish


def print_diff_info_batch(batch, f, device, skip_codan: bool = False,
                          motifs=DEFAULT_MOTIFS, summary=None,
                          max_ev: int = MAX_EV) -> None:
    """Synchronous submit and finish of one report batch on ``device``."""
    submit_diff_info_batch(batch, f, device, skip_codan, motifs, summary,
                           max_ev)()
