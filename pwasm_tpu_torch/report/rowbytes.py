"""Batched report byte assembly.

The scalar emit path paid ~4-5 Python calls per event row — an
``analyzed[id(di)]`` dict probe, a tuple unpack, ``format_event_row``
(three per-field ``bytes.decode`` round-trips plus two f-string
interpolations), and ``Summary.add_event`` (half a dozen dict
operations) — and that per-event constant was the realistic-scale
host wall's largest flat term (BASELINE.md ceiling analysis).  This
module assembles one whole report block per flush instead:

- one fused pass over the batch builds every row with the truncation
  rules inlined and NO intermediate per-field objects;
- the ``-s`` summary counters accumulate in local integers during the
  same pass and fold into the ``Summary`` once per batch
  (:meth:`~pwasm_tpu_torch.report.diff_report.Summary.fold_event_counts`);
- the block leaves as ONE ``str`` for a single ``f.write`` per batch.

Byte-parity contract: every row is byte-for-byte what
the reference's scalar ``print_diff_info`` loop writes — the
assembly works in ``str`` space because the report stream is a
text-mode file and Python's ascii ``decode(..., "replace")`` is
byte-wise, so field-at-a-time and block-at-a-time conversions agree.
"""

from __future__ import annotations

from pwasm_tpu_torch.report.diff_report import (MAX_EVLEN, Summary,
                                                format_header)

_TCTX_MAX = 10 + MAX_EVLEN      # target-context truncation threshold


def format_batch_block(batch, analyzed: dict,
                       summary: Summary | None) -> str:
    """Assemble one report batch — headers interleaved with event rows,
    exactly the bytes the scalar ``print_diff_info`` loop writes — as a
    single ``str``; fold the batch's summary counters in bulk.

    ``batch`` is the CLI's flush list of ``(aln, rlabel, tlabel,
    refseq)``; ``analyzed`` maps ``id(di)`` to the analysis tuple
    ``(aa, aapos, rctx, status, impact)`` (the ``analyze_event_host``
    contract, produced from the device fetch).
    """
    rows: list[str] = []
    append = rows.append
    # summary counters: locals in the hot loop, folded once at the end
    n_s = n_i = n_d = 0          # events per type
    b_s = b_i = b_d = 0          # bases per type
    c_hp = c_mo = c_un = 0       # cause classes
    i_syn = i_non = i_stop = i_fs = 0   # impact classes
    count = summary is not None
    for aln, rlabel, tlabel, _refseq in batch:
        append(format_header(aln, rlabel, tlabel))
        if count:
            summary.add_alignment(aln)
        for di in aln.tdiffs:
            aa, aapos, rctx, status, impact = analyzed[id(di)]
            evt = di.evt
            evtbases = di.evtbases
            if len(evtbases) > MAX_EVLEN:
                eb = f"[{len(evtbases)}]"
            else:
                eb = evtbases.decode("ascii", "replace")
            if evt == "S":
                evtsub = di.evtsub
                if len(evtsub) > MAX_EVLEN:
                    mid = f"[{len(evtsub)}]:{eb}"
                else:
                    mid = f"{evtsub.decode('ascii', 'replace')}:{eb}"
            elif evt == "I":
                mid = f":{eb}"
            else:
                mid = f"{eb}:"
            tctx = di.tctx
            if len(tctx) > _TCTX_MAX:
                tctx_s = (f"{tctx[:5].decode('ascii', 'replace')}"
                          f"[{len(tctx) - 10}]"
                          f"{tctx[-5:].decode('ascii', 'replace')}")
            else:
                tctx_s = tctx.decode("ascii", "replace")
            append(f"{evt}\t{di.rloc + 1}\t{aapos}({aa})\t{mid}\t"
                   f"{di.tloc + 1}\t{tctx_s}\t"
                   f"{rctx.decode('ascii', 'replace')}\t{status}\t"
                   f"{impact}\n")
            if count:
                if evt == "S":
                    n_s += 1
                    b_s += len(evtbases)
                elif evt == "I":
                    n_i += 1
                    b_i += len(evtbases)
                else:
                    n_d += 1
                    b_d += di.evtlen
                if status == "homopolymer":
                    c_hp += 1
                elif status.startswith("motif"):
                    c_mo += 1
                else:
                    c_un += 1
                if impact:
                    if impact == "synonymous":
                        i_syn += 1
                    elif "premature stop" in impact:
                        i_stop += 1
                    elif impact.startswith("frame shift"):
                        i_fs += 1
                    else:
                        i_non += 1
    if count:
        summary.fold_event_counts(
            {"S": n_s, "I": n_i, "D": n_d},
            {"S": b_s, "I": b_i, "D": b_d},
            {"homopolymer": c_hp, "motif": c_mo, "unknown": c_un},
            {"synonymous": i_syn, "nonsynonymous": i_non,
             "premature_stop": i_stop, "frame_shift": i_fs})
    block = "".join(rows)
    return block
