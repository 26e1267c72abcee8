"""PAF record parsing.

Mirrors the reference's per-line handling: tab-split with >=15 fields
required (pafreport.cpp:307-309), core coordinates lifted into an AlnInfo
struct (pafreport.cpp:54-88), and the tag scan over fields 12+ for
``NM:i:``, ``AS:i:``, ``cg:Z:``, ``cs:Z:`` with first-hit-wins semantics
(pafreport.cpp:492-520).  A missing/empty CIGAR is fatal (pafreport.cpp:521).
The reference never validates the presence of ``cs`` (it would crash on a
NULL pointer, SURVEY.md §2.5.4); we raise a clear error instead — the input
contract is unchanged (PAF must come from ``minimap2 -c --cs``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .errors import PwasmError


_ASCII_DIGITS = frozenset("0123456789")


def _atoi(s: str) -> int:
    """C atoi semantics: optional sign + leading ASCII digits; 0 on junk.

    Restricted to ASCII digits — ``str.isdigit`` accepts unicode digit
    forms that ``int()`` rejects, which would turn junk input into a crash
    instead of atoi's tolerant 0."""
    s = s.strip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j] in _ASCII_DIGITS:
        j += 1
    if j == i:
        return 0
    return int(s[:j])


@dataclass
class AlnInfo:
    """One PAF line's core fields (reference: AlnInfo, pafreport.cpp:54-88)."""

    reverse: int = 2
    r_id: str = ""
    r_len: int = 0
    r_alnstart: int = 0
    r_alnend: int = 0
    t_id: str = ""
    t_len: int = 0
    t_alnstart: int = 0
    t_alnend: int = 0

    @classmethod
    def from_fields(cls, fields: list[str]) -> "AlnInfo":
        return cls(
            reverse=1 if fields[4] == "-" else 0,
            r_id=fields[0],
            r_len=_atoi(fields[1]),
            r_alnstart=_atoi(fields[2]),
            r_alnend=_atoi(fields[3]),
            t_id=fields[5],
            t_len=_atoi(fields[6]),
            t_alnstart=_atoi(fields[7]),
            t_alnend=_atoi(fields[8]),
        )


@dataclass
class PafRecord:
    """A parsed PAF line: AlnInfo + the tags the pipeline consumes."""

    alninfo: AlnInfo
    fields: list[str] = field(default_factory=list)
    edist: int = -1       # NM:i:
    alnscore: int = 0     # AS:i:
    cigar: str | None = None   # cg:Z:
    cs: str | None = None      # cs:Z:

    @property
    def line(self) -> str:
        return "\t".join(self.fields)


def parse_paf_line(line: str) -> PafRecord:
    """Parse one PAF line (must have >=15 tab-separated fields)."""
    fields = line.rstrip("\n").split("\t")
    if len(fields) < 15:
        raise PwasmError(
            f"Error: invalid PAF fline (num. fields={len(fields)}):\n{line}\n"
        )
    rec = PafRecord(alninfo=AlnInfo.from_fields(fields), fields=fields)
    got = 0
    gotall = 1 + 2 + 4 + 8
    for f in fields[12:]:
        if f.startswith("NM:i:"):
            rec.edist = _atoi(f[5:])
            got |= 1
        elif f.startswith("AS:i:"):
            rec.alnscore = _atoi(f[5:])
            got |= 2
        elif f.startswith("cg:Z:"):
            rec.cigar = f[5:]
            got |= 4
        elif f.startswith("cs:Z:"):
            rec.cs = f[5:]
            got |= 8
        if got == gotall:
            break
    return rec
