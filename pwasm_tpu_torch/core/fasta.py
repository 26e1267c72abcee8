"""Random-access FASTA reader (faidx-style).

Equivalent capability to the reference's gclib GFastaDb/GFastaIndex/GFaSeqGet
usage (pafreport.cpp:255,346): open a FASTA file, fetch whole records by id
without re-scanning the file.  The index is built in one streaming pass and
records byte offsets, so fetches are O(record size) seeks.

Like gclib's GFastaIndex (the ``.fai`` files pafreport rides), the index
persists: after a scan of a uniformly-wrapped FASTA a samtools-compatible
5-column ``<path>.fai`` sidecar is written, and later opens load it instead
of re-scanning — the sidecar is ignored when older than the FASTA.
Irregularly-wrapped files (which the 5-column format cannot describe) are
simply re-scanned each open.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from pwasm_tpu_torch.core.errors import PwasmError


@dataclass
class _FaiEntry:
    name: str
    length: int  # number of sequence bytes (newlines excluded)
    offset: int  # byte offset of first sequence byte
    end: int     # byte offset one past the last sequence line


class FastaFile:
    """Indexed FASTA access by sequence id.

    >>> fa = FastaFile(path)
    >>> fa.fetch("gene1")      # -> bytes (no newlines), or None if absent
    >>> len(fa)                # number of records
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._index: dict[str, _FaiEntry] = {}
        self._order: list[str] = []
        # per-record (linebases, linewidth, uniform) from the native
        # scan, so _write_fai needs no second pass over the file
        self._geom: dict[str, tuple[int, int, int]] = {}
        if not self._load_fai():
            self._full_scan()
            self._write_fai()

    @property
    def _fai_path(self) -> str:
        return self.path + ".fai"

    def _load_fai(self) -> bool:
        """Load the ``.fai`` sidecar when present and not older than the
        FASTA itself.  The 5-column samtools layout is name, length,
        offset, linebases, linewidth; the fetch window's end offset is
        derived from the line geometry.

        mtime alone cannot catch an mtime-preserving content swap
        (``cp -p``/``rsync -a``), so the loaded geometry is probed
        against the file's structure: a header must end right before
        each record's first base, the next record's ``>`` must sit
        exactly where the previous record's window closes, and the last
        window must close at EOF (modulo a missing final newline).  Any
        probe failure falls back to a full scan."""
        try:
            if (os.path.getmtime(self._fai_path)
                    < os.path.getmtime(self.path)):
                return False
            rows = []
            with open(self._fai_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    name, length, offset, lb, lw = line.split("\t")
                    length, offset = int(length), int(offset)
                    lb, lw = int(lb), int(lw)
                    if length < 0 or offset < 0 or lb < 1 or lw <= lb:
                        return False
                    nlines = (length + lb - 1) // lb
                    end = offset + length + nlines * (lw - lb)
                    rows.append((name, length, offset, end, lw - lb))
            if not rows:
                return False
            fsize = os.path.getsize(self.path)
            with open(self.path, "rb") as f:
                if f.read(1) != b">":
                    return False
                prev_end = 0
                for name, _l, offset, end, term in sorted(
                        rows, key=lambda r: r[2]):
                    f.seek(offset - 1)
                    if f.read(1) != b"\n":
                        return False
                    f.seek(end)
                    nxt = f.read(1)
                    if nxt != b">" and not (
                            nxt == b"" and end in (fsize, fsize + term)):
                        return False
                    # the header between the previous window and this
                    # record must still carry this record's name (a
                    # same-geometry swap with renamed records would
                    # otherwise serve stale attributions)
                    f.seek(prev_end)
                    header = f.read(min(offset - prev_end, 1 << 16))
                    if not header.startswith(b">"):
                        return False
                    tok = header[1:].split(None, 1)
                    got = tok[0] if tok else b""
                    if got.decode("utf-8", "replace") != name:
                        return False
                    prev_end = end
            for name, length, offset, end, _t in rows:
                self._add(name, length, offset, end)
        except (OSError, ValueError):
            self._index.clear()
            self._order.clear()
            return False
        return bool(self._index)

    def _write_fai(self) -> None:
        """Persist the index when every record is uniformly wrapped (the
        only shape the 5-column format can describe — foreign faidx
        readers like samtools/pysam derive in-record offsets from the
        line geometry, so a coincidental total-window match is not
        enough); best-effort — a read-only directory just skips
        persistence.  Geometry comes from the native scan when it ran
        (``self._geom``, no extra IO); after the Python scan it is
        verified line by line, one extra sequential pass."""
        rows = []
        try:
            fsize = os.path.getsize(self.path)
            with open(self.path, "rb") as f:
                for name in self._order:
                    ent = self._index[name]
                    if "\t" in name or "\n" in name:
                        return
                    geom = self._geom.get(name)
                    if geom is not None:
                        lb, lw, uniform = geom
                        if not uniform or lb < 1 or lw <= lb:
                            return
                    else:
                        # no native geometry: verify EVERY line — each
                        # full line exactly lb bases + the same
                        # terminator, no interior whitespace; the final
                        # line may be short, and may lack its
                        # terminator only at EOF
                        f.seek(ent.offset)
                        first = f.readline()
                        lb = len(first.rstrip(b"\r\n"))
                        lw = len(first)
                        if lb < 1 or lw <= lb:
                            return
                        f.seek(ent.offset)
                        left = ent.length
                        pos = ent.offset
                        while left > 0:
                            line = f.readline()
                            pos += len(line)
                            body = line.rstrip(b"\r\n")
                            if body.translate(
                                    None, b" \t\v\f\r\n") != body:
                                return
                            if len(body) != min(lb, left):
                                return
                            if len(line) - len(body) != lw - lb and not (
                                    len(body) == left and pos == fsize):
                                return
                            left -= len(body)
                        if pos != ent.end:
                            return
                    # belt: the derived window must reproduce the scan
                    nlines = (ent.length + lb - 1) // lb
                    span = ent.length + nlines * (lw - lb)
                    window = ent.end - ent.offset
                    if window != span and not (
                            window == span - (lw - lb)
                            and ent.end == fsize):
                        return
                    rows.append(f"{name}\t{ent.length}\t{ent.offset}"
                                f"\t{lb}\t{lw}\n")
            # atomic + durable publish (utils.fsio): a concurrent
            # reader must see either no sidecar or a complete one,
            # never a prefix — and a crash right after the rename must
            # not leave a complete rename of an unwritten file
            from pwasm_tpu_torch.utils.fsio import write_durable_text
            write_durable_text(self._fai_path, "".join(rows))
        except OSError:
            # best-effort sidecar: write_durable_text cleans up its
            # own tmp file on failure
            return

    def _full_scan(self) -> None:
        # the native one-pass scan (the same entries, and each record's
        # line geometry) unless PWASM_NATIVE=0 asks for the Python scan
        from pwasm_tpu_torch import native
        entries = None
        if native.enabled():
            try:
                entries = native.fasta_index(self.path)
            except OSError:
                pass  # the Python reader below raises its own error
        if entries is not None:
            for name, seqlen, start, end, lb, lw, uniform in entries:
                if name not in self._index:
                    self._geom[name] = (lb, lw, uniform)
                self._add(name, seqlen, start, end)
            if not self._index:
                raise PwasmError(f"Error: invalid FASTA file {self.path} !")
            return
        name = None
        seqlen = 0
        seq_start = 0
        pos = 0
        with open(self.path, "rb") as f:
            for line in f:
                linelen = len(line)
                if line.startswith(b">"):
                    if name is not None:
                        self._add(name, seqlen, seq_start, pos)
                    header = line[1:].strip()
                    name = header.split(None, 1)[0].decode() if header else ""
                    seqlen = 0
                    seq_start = pos + linelen
                elif name is not None:
                    # count exactly the bytes fetch() will return (all
                    # whitespace removed, not just line ends)
                    seqlen += len(line.translate(None, b" \t\r\n\v\f"))
                pos += linelen
            if name is not None:
                self._add(name, seqlen, seq_start, pos)
        if not self._index:
            raise PwasmError(f"Error: invalid FASTA file {self.path} !")

    def _add(self, name: str, seqlen: int, start: int, end: int) -> None:
        if name not in self._index:
            self._index[name] = _FaiEntry(name, seqlen, start, end)
            self._order.append(name)

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    @property
    def names(self) -> list[str]:
        return list(self._order)

    def length(self, name: str) -> int:
        return self._index[name].length

    def fetch(self, name: str) -> bytes | None:
        """Fetch a full record's sequence (newlines stripped), or None."""
        ent = self._index.get(name)
        if ent is None:
            return None
        from pwasm_tpu_torch import native
        if native.enabled():
            try:
                return native.fasta_fetch(self.path, ent.offset, ent.end)
            except OSError:
                pass  # the Python read below raises its own error
        with open(self.path, "rb") as f:
            f.seek(ent.offset)
            raw = f.read(ent.end - ent.offset)
        # strip ALL whitespace, matching the per-line strip() used when
        # indexing — otherwise length() and fetch() disagree on files with
        # trailing blanks and stray bytes later encode as phantom Ns
        return bytes(raw.translate(None, b" \t\r\n\v\f"))

    def file_size(self) -> int:
        """Size of the FASTA file in bytes.

        The reference auto-selects full-genome mode when this exceeds 120000
        bytes (pafreport.cpp:253-262, quirk SURVEY.md §2.5.7) — by *file
        size*, not sequence length; we preserve that contract.
        """
        return os.path.getsize(self.path)


def write_fasta(path: str, records: list[tuple[str, bytes]],
                width: int = 60) -> None:
    """Write ``(name, seq)`` records as FASTA, ``width`` bases a line."""
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            s = seq.decode() if isinstance(seq, (bytes, bytearray)) else seq
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + "\n")
