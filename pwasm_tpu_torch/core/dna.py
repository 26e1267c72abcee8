"""DNA alphabet tables: complement, integer encoding, codon translation.

Covers the surface the reference pulls from gclib's ``gdna`` (IUPAC
complement tables used by ``revCompl``, pafreport.cpp:469-472) and ``codons``
(``translateCodon``, pafreport.cpp:824-825,855).  Device-side kernels use the
integer encodings and LUTs defined here; host-side string code uses the byte
translation tables.

Base codes (device layout): A=0 C=1 G=2 T=3 N=4, gap=5.  The 0..3 range is
what the 2-bit packers and the banded-DP kernel consume; code 4 captures any
ambiguity character; code 5 is the explicit gap bucket used by the consensus
pileup (mirrors the 6-bucket column counts of GAlnColumn, GapAssem.h:257-264).
"""

from __future__ import annotations

import numpy as np

CODE_A = 0
CODE_C = 1
CODE_G = 2
CODE_T = 3
CODE_N = 4
CODE_GAP = 5

BASE_CHARS = b"ACGTN-"

# ---------------------------------------------------------------------------
# IUPAC complement (case preserving), equivalent to GStr::tr(IUPAC_DEFS,
# IUPAC_COMP) followed by reverse() in the reference's revCompl().
# ---------------------------------------------------------------------------
_IUPAC_PAIRS = {
    "A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
    "M": "K", "R": "Y", "W": "W", "S": "S", "Y": "R", "K": "M",
    "V": "B", "H": "D", "D": "H", "B": "V", "N": "N", "X": "X",
}


def _build_comp_table() -> bytes:
    tbl = bytearray(range(256))
    for a, b in _IUPAC_PAIRS.items():
        tbl[ord(a)] = ord(b)
        tbl[ord(a.lower())] = ord(b.lower())
    return bytes(tbl)


COMP_TABLE = _build_comp_table()


def complement(seq: bytes) -> bytes:
    """IUPAC complement, preserving case, without reversing."""
    return seq.translate(COMP_TABLE)


def revcomp(seq: bytes) -> bytes:
    """Reverse complement, preserving case (reference: revCompl,
    pafreport.cpp:469-472)."""
    return seq.translate(COMP_TABLE)[::-1]


# ---------------------------------------------------------------------------
# Byte -> integer code encoding (and back)
# ---------------------------------------------------------------------------
def _build_encode_table() -> np.ndarray:
    tbl = np.full(256, CODE_N, dtype=np.int8)
    for ch, code in ((b"A", CODE_A), (b"C", CODE_C), (b"G", CODE_G),
                     (b"T", CODE_T), (b"U", CODE_T)):
        tbl[ch[0]] = code
        tbl[ch.lower()[0]] = code
    tbl[ord("-")] = CODE_GAP
    tbl[ord("*")] = CODE_GAP  # ACE-style gap char (GASeq::printGappedFasta)
    return tbl


ENCODE_TABLE = _build_encode_table()
DECODE_TABLE = np.frombuffer(BASE_CHARS, dtype=np.uint8)


def encode(seq: bytes) -> np.ndarray:
    """Encode a byte string to int8 base codes (A0 C1 G2 T3 N4 gap5)."""
    arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return ENCODE_TABLE[arr]


def decode(codes: np.ndarray) -> bytes:
    """Decode int8 base codes back to an upper-case byte string."""
    return DECODE_TABLE[np.asarray(codes, dtype=np.int64)].tobytes()


# ---------------------------------------------------------------------------
# Codon translation (standard genetic code; stop='.', ambiguous/short='X').
# Matches the behavior of gclib's translateCodon as used by predictImpact
# (pafreport.cpp:824-825,855): reading off the end of the sequence or through
# a non-ACGT base yields 'X'.
# ---------------------------------------------------------------------------
_CODON_TABLE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": ".", "TAG": ".",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": ".", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}


_CODON_TABLE_B = {k.encode(): v for k, v in _CODON_TABLE.items()}


def translate_codon(seq: bytes, pos: int = 0) -> str:
    """Translate the codon starting at ``pos``; 'X' if short or ambiguous."""
    codon = bytes(seq[pos:pos + 3])
    aa = _CODON_TABLE_B.get(codon)     # fast path: already upper ACGT
    if aa is not None:
        return aa
    codon = codon.upper().replace(b"U", b"T")
    if len(codon) < 3:
        return "X"
    return _CODON_TABLE_B.get(codon, "X")


def _build_aa_lut() -> np.ndarray:
    """5**3 LUT over base codes (A0..T3, N4) -> amino-acid ASCII (uint8).

    Any codon containing code 4 (N) maps to 'X'; stop codons map to '.'.
    Device kernels index this with ``c0*25 + c1*5 + c2``.
    """
    lut = np.full(125, ord("X"), dtype=np.uint8)
    bases = "ACGT"
    for i0, b0 in enumerate(bases):
        for i1, b1 in enumerate(bases):
            for i2, b2 in enumerate(bases):
                aa = _CODON_TABLE[b0 + b1 + b2]
                lut[i0 * 25 + i1 * 5 + i2] = ord(aa)
    return lut


AA_LUT = _build_aa_lut()


def translate_codes(codes: np.ndarray) -> np.ndarray:
    """Vectorized translation of an (..., 3k) base-code array to amino-acid
    ASCII codes of shape (..., k).  Positions beyond the array or ambiguous
    codons yield 'X'."""
    codes = np.asarray(codes)
    n_codons = codes.shape[-1] // 3
    trimmed = np.clip(codes[..., : n_codons * 3], 0, CODE_N)
    c = trimmed.reshape(*codes.shape[:-1], n_codons, 3).astype(np.int64)
    idx = c[..., 0] * 25 + c[..., 1] * 5 + c[..., 2]
    return AA_LUT[idx]
