"""Router-side scatter/merge bookkeeping for fleet-wide m2m streams.

Counterpart of ``pwasm_tpu/surveil/partition.py``, with its names.
Pure data structures (no sockets, no torch): a fleet router partitions the
arriving target-record stream across member sub-streams round-robin
(:class:`ScatterState` — the affinity-ordered member list decides who
sub 0 is), remembers each record's global arrival index, and at the
end splices the per-member section FRAGMENTS back into one report in
global arrival order (:func:`merge_fragments`) — byte-identical to one
un-scattered run over the same stream, because every fragment row is
spliced verbatim and only headers/summary (which depend on the total
target count) are re-rendered.

Member death re-partitions wholesale: the dead sub's records are
replayed — in their original relative order — into a fresh sub-stream
on a survivor (``kill``/``adopt``), so the positional row↔record
mapping survives failover unchanged.
"""

from __future__ import annotations


class ScatterState:
    """Record→sub assignment with arrival-order bookkeeping."""

    def __init__(self):
        self.orders: list[list[int]] = []  # per sub: global record
        self.live: list[bool] = []         # indices in send order
        self.nrec = 0
        self._rr = 0

    def add_sub(self) -> int:
        self.orders.append([])
        self.live.append(True)
        return len(self.orders) - 1

    def live_subs(self) -> list[int]:
        return [k for k, ok in enumerate(self.live) if ok]

    def assign(self) -> tuple[int, int]:
        """Admit the next arriving record; return ``(gidx, sub)``.

        Round-robin over the CURRENTLY live subs in index order —
        deterministic given the arrival order and the death history.
        """
        alive = self.live_subs()
        if not alive:
            raise ValueError("no live subs to assign to")
        gidx = self.nrec
        self.nrec += 1
        sub = alive[self._rr % len(alive)]
        self._rr += 1
        self.orders[sub].append(gidx)
        return gidx, sub

    def kill(self, sub: int) -> list[int]:
        """Mark ``sub`` dead; return the records it owned (in send
        order) for wholesale replay into a replacement sub."""
        self.live[sub] = False
        return list(self.orders[sub])

    def adopt(self, sub: int, order: list[int]) -> None:
        """A fresh replacement sub inherits a dead sub's records."""
        if self.orders[sub]:
            raise ValueError("adopting sub already owns records")
        self.orders[sub] = list(order)


def rewrite_out_args(args: list, o=None, s=None,
                     strip=("stats",)) -> list:
    """Rewrite a stream job's argv for one member sub-stream: fragment
    ``-o``/``-s`` paths in, per-client ``--stats`` out (each member
    writes its own; the router merges)."""
    out: list = []
    i = 0
    repl = {"-o": o, "-s": s}
    strip_eq = tuple(f"--{name}=" for name in strip)
    strip_lone = tuple(f"--{name}" for name in strip)
    while i < len(args):
        a = args[i]
        if a in repl and repl[a] is not None and i + 1 < len(args):
            out.extend([a, repl[a]])
            i += 2
            continue
        if isinstance(a, str) and (a.startswith(strip_eq)
                                   or a in strip_lone):
            i += 2 if a in strip_lone and i + 1 < len(args) \
                and not str(args[i + 1]).startswith("-") else 1
            continue
        out.append(a)
        i += 1
    return out


def _parse_fragment(data: bytes):
    """Parse one member's section-report fragment into
    ``[(header_fields, [row_bytes, ...]), ...]`` per query — rows kept
    as raw bytes so the merge splices them verbatim."""
    secs: list = []
    for ln in data.split(b"\n"):
        if not ln:
            continue
        if ln.startswith(b">"):
            fields = ln[1:].split(b"\t")
            if len(fields) != 3:
                raise ValueError(
                    f"malformed section header: {ln[:60]!r}")
            secs.append((fields, []))
        else:
            if not secs:
                raise ValueError("fragment row before any header")
            secs[-1][1].append(ln)
    return secs


def merge_fragments(fragments: list, orders: list, total: int,
                    summary: bool = False):
    """Splice per-member section fragments into ONE report in global
    arrival order.

    ``fragments[k]`` is the raw ``-o`` bytes member ``k`` emitted for
    the records in ``orders[k]`` (same index space, live subs only);
    ``total`` is the stream's total record count.  Returns the merged
    report bytes, or ``(report, summary)`` when ``summary`` is true —
    the summary is re-derived from the spliced rows with exactly the
    ``format_summary`` rendering, since best/sum depend on the whole
    row, not any one fragment.
    """
    if len(fragments) != len(orders):
        raise ValueError("fragments/orders length mismatch")
    parsed = [_parse_fragment(f) for f in fragments]
    nq = {len(p) for p in parsed}
    if len(nq) > 1:
        raise ValueError(f"fragments disagree on query count: {nq}")
    out: list = []
    sums: list = []
    for qi in range(nq.pop() if nq else 0):
        name = qlen = None
        rows: dict[int, bytes] = {}
        for k, p in enumerate(parsed):
            fields, frag_rows = p[qi]
            if name is None:
                name, qlen = fields[0], fields[1]
            elif (name, qlen) != (fields[0], fields[1]):
                raise ValueError(
                    f"fragments disagree on query {qi}: "
                    f"{name!r} vs {fields[0]!r}")
            if len(frag_rows) != len(orders[k]):
                raise ValueError(
                    f"fragment {k} query {qi}: {len(frag_rows)} "
                    f"row(s) for {len(orders[k])} record(s)")
            for gidx, row in zip(orders[k], frag_rows):
                rows[gidx] = row
        if len(rows) != total:
            raise ValueError(
                f"query {qi}: merged {len(rows)} of {total} row(s)")
        out.append(b">%s\t%s\t%d\n" % (name, qlen, total))
        merged = [rows[g] for g in range(total)]
        for row in merged:
            out.append(row + b"\n")
        if summary:
            sums.append(_summarize(name, merged, total))
    report = b"".join(out)
    return (report, b"".join(sums)) if summary else report


def _summarize(qname: bytes, rows: list, total: int) -> bytes:
    """Re-render one query's summary line from its merged rows —
    byte-for-byte the ``stream/multicds.format_summary`` contract
    (ties break to arrival order; all-``.`` reports ``.  .  0``)."""
    live: list = []
    for ti, row in enumerate(rows):
        fields = row.split(b"\t")
        if len(fields) != 3:
            raise ValueError(f"malformed section row: {row[:60]!r}")
        if fields[2] != b".":
            live.append((int(fields[2]), ti, fields[0]))
    if live:
        best, bi, bname = max(live, key=lambda p: (p[0], -p[1]))
        tot = sum(v for v, _t, _n in live)
        return b"%s\t%d\t%s\t%d\t%d\n" % (qname, total, bname,
                                          best, tot)
    return b"%s\t%d\t.\t.\t0\n" % (qname, total)
