"""The port's packed ctx_scan program against the JAX package's.

Both run on the CPU over the same events and reference codes; the packed
(E, width) int32 results must be bit-equal.  Events come from the
realistic-scale corpus and from hand-made edge and tie cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwasm_tpu.core.config import DEFAULT_MOTIFS
from pwasm_tpu.core.dna import encode, revcomp
from pwasm_tpu.core.events import DiffEvent, extract_alignment
from pwasm_tpu.core.paf import parse_paf_line
from pwasm_tpu.ops import ctx_scan as ref_cs
from pwasm_tpu_torch.ops import ctx_scan as cs
from pwasm_tpu_torch.ops.ctx_scan_impl import first_true

from test_realistic_scale import make_corpus

MAX_EV = 16
CPU = torch.device("cpu")


def _both(refseq: bytes, events, skip_codan: bool):
    ref_len = len(refseq)
    max_len = ref_cs.ref_bucket_len(ref_len, MAX_EV)
    max_codons = MAX_EV // 3 + 2
    ref_codes = np.full(max_len, ref_cs.PAD, np.int8)
    ref_codes[:ref_len] = encode(refseq.upper())
    want = np.asarray(ref_cs.ctx_scan_packed(
        jnp.asarray(ref_codes), jnp.int32(ref_len),
        ref_cs.pack_events(events, MAX_EV), *ref_cs.pack_motifs(
            DEFAULT_MOTIFS), max_codons=max_codons, max_len=max_len,
        skip_codan=skip_codan))
    got = cs.ctx_scan_packed(
        torch.from_numpy(ref_codes), ref_len,
        cs.pack_events(events, MAX_EV, CPU),
        *cs.pack_motifs(DEFAULT_MOTIFS, CPU), max_codons=max_codons,
        max_len=max_len, skip_codan=skip_codan)
    assert got.dtype == torch.int32
    return want, got.numpy()


@pytest.mark.parametrize("skip_codan", [False, True])
def test_corpus_events_bit_equal(skip_codan):
    q, lines = make_corpus(n_aln=10)
    refseq = q.encode()
    events = []
    for line in lines:
        rec = parse_paf_line(line)
        aln = extract_alignment(
            rec, revcomp(refseq) if rec.alninfo.reverse else refseq,
            use_native=False)
        events += [ev for ev in aln.tdiffs
                   if len(ev.evtbases) <= MAX_EV
                   and len(ev.evtsub) <= MAX_EV]
    assert len(events) > 500
    want, got = _both(refseq, events, skip_codan)
    np.testing.assert_array_equal(got, want)


def _ev(evt, rloc, bases, sub=b""):
    n = len(bases)
    return DiffEvent(evt=evt, evtlen=1 if evt == "S" else n,
                     evtbases=bases, evtsub=sub or bases, rloc=rloc)


def test_hand_made_ties_and_edges_bit_equal():
    # a window holding GATC at two offsets, CCTGG overlapping GATC (the
    # table order decides), a homopolymer run at several offsets, a
    # stop codon at the scan's first codon, and events at both edges
    refseq = (b"TAAGC" b"GATCGATCA" b"CCTGGATCA" b"TTAAAAAAAAC"
              b"ACGTACGTTAGCATGCA" b"GGTAC")
    n = len(refseq)
    events = [
        _ev("D", 4, b"C"),                     # stop TAA at codon 0
        _ev("I", 1, b"AA"),                    # insert inside codon 0
        _ev("S", 9, b"T", b"G"),               # GATC twice in window
        _ev("S", 18, b"G", b"T"),              # CCTGG + GATC window
        _ev("I", 28, b"AA"),                   # homopolymer insertion
        _ev("D", 30, b"AAA"),                  # homopolymer deletion
        _ev("S", 0, b"C", b"T"),               # left edge
        _ev("S", n - 1, b"A", b"C"),           # right edge quirk
        _ev("D", n - 3, b"TAC"),               # deletion at the end
        _ev("I", n - 1, b"TTTT"),              # insertion at the end
        _ev("S", 40, b"GC", b"CA"),            # merged substitution
    ]
    for skip_codan in (False, True):
        want, got = _both(refseq, events, skip_codan)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_random_events_with_n_bases_bit_equal(seed):
    # random references holding N, events of every type and width up to
    # MAX_EV at every position, substitutions that disagree with the
    # reference (the mismatch flag)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 400))
    refseq = bytes(rng.choice(list(b"ACGTACGTN"), n).astype(np.uint8))
    events = []
    for _ in range(int(rng.integers(1, 300))):
        kind = str(rng.choice(["S", "I", "D"]))
        width = int(rng.integers(1, MAX_EV + 1))
        rloc = int(rng.integers(0, n))
        bases = bytes(rng.choice(list(b"ACGTN"), width).astype(np.uint8))
        if kind == "I":
            events.append(_ev("I", rloc, bases))
            continue
        width = min(width, n - rloc)
        here = refseq[rloc:rloc + width]
        if kind == "S":
            events.append(_ev("S", rloc, bases[:width],
                              here if rng.random() < 0.8 else bases))
        else:
            events.append(_ev("D", rloc, here))
    for skip_codan in (False, True):
        want, got = _both(refseq, events, skip_codan)
        np.testing.assert_array_equal(got, want)


def test_first_true_takes_the_first_index():
    mask = torch.tensor([[False, True, True], [False, False, False],
                         [True, False, True]])
    assert first_true(mask, 1).tolist() == [1, 0, 0]
    assert first_true(mask, 0).tolist() == [2, 0, 0]
