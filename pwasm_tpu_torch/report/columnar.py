"""Row assembly from per-event analysis results.

The device path (``report/device_report.py``) fetches the fused
``ctx_scan`` analysis as one packed tensor; this module turns those
arrays into the ``analyze_event_host`` tuples and writes one report
block per batch through the fused formatter (``report/rowbytes.py``).

A flagged substitution mismatch (the reference's fatal modseq-vs-evtsub
verification) re-runs the event through the scalar analyzer, so the
error message is byte-identical to the scalar ground truth.
"""

from __future__ import annotations

import numpy as np

from pwasm_tpu_torch.report.diff_report import (Summary, analyze_event_host,
                                                get_ref_context)
from pwasm_tpu_torch.report.rowbytes import format_batch_block

_SCALAR_FIELDS = ("aa", "aapos", "hpoly", "motif", "s_mismatch",
                  "stop_aapos")


def _impact_text_l(ev, k: int, L: dict, refseq: bytes, skip_codan: bool,
                   motifs) -> str:
    """predictImpact's text from analysis results (pafreport.cpp:804-883
    semantics), all fields from the bulk-converted lists ``L`` — the
    per-codon planes are converted ONCE per batch in
    :func:`assemble_results` (the former per-row ``.tolist()``
    extraction cost 4-8 numpy calls per indel event).  A flagged
    substitution mismatch re-runs the event through the scalar analyzer
    so message/indices match the scalar ground truth byte-for-byte."""
    if ev.evt == "S":
        if L["s_mismatch"][k]:
            # the scalar analyzer raises the reference's exact error (or,
            # if the byte-level check disagrees with the code-level flag,
            # yields the scalar ground-truth result)
            return analyze_event_host(ev, refseq, skip_codan, motifs)[4]
        if L["s_syn"][k]:
            # vectorized fast path: no valid codon changed — the
            # per-codon row walk below would emit no parts
            return "synonymous"
        parts = []
        s_valid = L["s_valid"][k]
        s_orig = L["s_orig_aa"][k]
        s_new = L["s_new_aa"][k]
        s_pos = None
        for d in range(len(s_orig)):
            if not s_valid[d]:
                break
            aa = chr(s_orig[d])
            maa = chr(s_new[d])
            if aa != maa:
                if s_pos is None:
                    s_pos = L["s_aapos"][k]
                aapos = s_pos[d]
                s = f"AA{aapos}|{aa}:{maa}"
                if maa == ".":
                    s += f"|premature stop at AA{aapos}"
                parts.append(s)
        return ", ".join(parts) if parts else "synonymous"
    stop = L["stop_aapos"][k]
    if stop >= 0:
        return f"premature stop at AA{stop}"
    aa4 = "".join(chr(c) for c, v in
                  zip(L["aa4"][k], L["aa4_valid"][k]) if v)
    maa4 = "".join(chr(c) for c, v in
                   zip(L["maa4"][k], L["maa4_valid"][k]) if v)
    if aa4 and maa4:
        return f"frame shift {aa4}+:{maa4}+"
    return ""


def assemble_results(events, host: dict, refseq: bytes, motifs,
                     skip_codan: bool) -> list:
    """Per-event ``(aa, aapos, rctx, status, impact)`` tuples — the
    ``analyze_event_host`` contract — from the fetched analysis dict.
    Upper-cases each event's ``evtbases`` in place, matching
    printDiffInfo."""
    # bulk tolist for the per-event scalars (python-int indexing from
    # lists is ~5x cheaper than numpy scalar extraction at report
    # scale); the (E, K) codon planes stay arrays and convert per ROW
    # on demand — most of their content is never read
    A = {k: np.asarray(v) for k, v in host.items()
         if k not in ("rctx", "rctxloc")}
    L = {k: A[k].tolist() for k in _SCALAR_FIELDS if k in A}
    if "s_valid" in A:
        # synonymous = no valid codon changed (computed vectorized so
        # the common case skips the per-codon row walk entirely)
        changed = (A["s_orig_aa"] != A["s_new_aa"]) \
            & (A["s_valid"] != 0)
        L["s_syn"] = (~changed.any(axis=1)).tolist()
        # bulk-convert the small per-codon planes ONCE: the (E, K)/
        # (E, 4) rows used to be extracted per event inside
        # _impact_text_l — 4-8 numpy row+tolist calls per indel/sub
        for plane in ("s_valid", "s_orig_aa", "s_new_aa", "s_aapos",
                      "aa4", "maa4", "aa4_valid", "maa4_valid"):
            if plane in A:
                L[plane] = A[plane].tolist()
    motif_text = ["[unknown]"] + [f"motif {m}" for m in motifs]
    # the host slices the 9bp context strings (byte-faithful for IUPAC
    # ambiguity characters the int8 code space collapses) — one
    # vectorized gather for the whole batch; <9bp references keep the
    # scalar degenerate-clamp path of get_ref_context
    ref_len = len(refseq)
    wb = None
    if ref_len >= 9:
        ru = np.frombuffer(refseq.upper(), np.uint8)
        rl = np.fromiter((ev.rloc for ev in events), np.int64,
                         len(events))
        ctxstart = np.clip(rl - 4, 0, ref_len - 9)
        wb = ru[ctxstart[:, None] + np.arange(9)].tobytes()
    out = []
    for k, ev in enumerate(events):
        ev.evtbases = ev.evtbases.upper()
        aa = chr(L["aa"][k])
        aapos = L["aapos"][k]
        if wb is not None:
            k9 = 9 * k
            rctx = wb[k9:k9 + 9]
        else:
            rctx = get_ref_context(refseq, ev.rloc)[0]
        if L["hpoly"][k]:
            status = "homopolymer"
        else:
            status = motif_text[L["motif"][k]]
        impact = ""
        if not skip_codan:
            impact = _impact_text_l(ev, k, L, refseq, skip_codan,
                                    motifs)
        out.append((aa, aapos, rctx, status, impact))
    return out


def emit_batch_rows(batch, analyzed: dict, f,
                    summary: Summary | None) -> None:
    """Write one batch's report rows from per-event analysis results:
    one fused block, one writer call per batch."""
    f.write(format_batch_block(batch, analyzed, summary))
