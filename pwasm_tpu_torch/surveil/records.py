"""Incremental FASTA record assembly for streamed target sets.

Counterpart of ``pwasm_tpu/surveil/records.py``, with its names.
Targets arrive over the stream verbs as raw FASTA text chunks split at
arbitrary byte boundaries.  ``FastaAssembler`` reassembles them into
*complete records* — a record is complete once the next ``>`` header
arrives (or the stream ends) — so the session (which parses them into
``(name, seq)`` pairs) and a router's scatter path (which forwards
whole-record texts to members) agree on record boundaries.

Canonical record text is ``>header\\n`` followed by the sequence lines
exactly as received (minus blank lines), so re-concatenating the
records of a stream reproduces a parseable FASTA with identical
record digests.
"""

from __future__ import annotations


class FastaAssembler:
    """Reassemble FASTA records from arbitrarily-chunked text."""

    def __init__(self):
        self._tail = ""        # partial last line
        self._lines: list[str] = []  # complete lines of the open record
        self.records_out = 0

    @property
    def pending_lines(self) -> int:
        return len(self._lines) + (1 if self._tail else 0)

    def feed(self, data: str) -> list[str]:
        """Feed a chunk; return the record texts completed by it."""
        out: list[str] = []
        buf = self._tail + data.replace("\r\n", "\n").replace("\r", "\n")
        self._tail = ""
        lines = buf.split("\n")
        self._tail = lines.pop()  # "" when data ended on a newline
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            if ln.startswith(">") and self._lines:
                out.append(self._emit())
            self._lines.append(ln)
        return out

    def finish(self) -> list[str]:
        """Flush the trailing record (stream ended)."""
        if self._tail.strip():
            self._lines.append(self._tail.strip())
        self._tail = ""
        return [self._emit()] if self._lines else []

    def _emit(self) -> str:
        rec = "\n".join(self._lines) + "\n"
        self._lines = []
        self.records_out += 1
        return rec


def parse_record(text: str) -> tuple[str, str]:
    """Parse one canonical record text into ``(name, seq)``.

    The name is the first whitespace-delimited token of the header,
    matching ``stream/multicds.load_fasta``.
    """
    lines = [ln for ln in text.split("\n") if ln.strip()]
    if not lines or not lines[0].startswith(">"):
        raise ValueError(f"not a FASTA record: {text[:40]!r}")
    name = lines[0][1:].split()[0] if lines[0][1:].split() else ""
    seq = "".join(ln.strip() for ln in lines[1:])
    if not name:
        raise ValueError("FASTA record with empty name")
    return name, seq
