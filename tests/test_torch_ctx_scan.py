"""The port's ctx_scan program against the JAX package's.

Both run on the CPU over the same events and reference codes; the packed
(E, width) int32 results must be bit-equal, and so must the unpacked
``ctx_scan``, its five stage functions and the report's synchronous
entry points (``analyze_events_device``, ``print_diff_info_batch``).
Events come from the realistic-scale corpus and from hand-made edge and
tie cases.
"""

import io

import jax
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


def _corpus_events(n_aln: int, mods):
    """The corpus's first ``n_aln`` alignments through ``mods``' parser
    and extraction: (refseq, [(aln, rlabel, tlabel, refseq)], events)."""
    paf, events = mods
    q, lines = make_corpus(n_aln=n_aln)
    refseq = q.encode()
    batch = []
    for line in lines:
        rec = paf.parse_paf_line(line)
        al = rec.alninfo
        aln = events.extract_alignment(
            rec, revcomp(refseq) if al.reverse else refseq,
            use_native=False)
        batch.append((aln, al.r_id, f"{al.t_id}:{al.t_alnstart}", refseq))
    return refseq, batch, [ev for aln, *_ in batch for ev in aln.tdiffs]


@pytest.mark.parametrize("skip_codan", [False, True])
def test_unpacked_ctx_scan_and_stages_equal_reference(skip_codan):
    """``ctx_scan``'s dict, field by field, and each of its five stage
    functions on the same tensors, equal the reference's."""
    q, lines = make_corpus(n_aln=4)
    refseq = q.encode()
    events = []
    for line in lines:
        rec = parse_paf_line(line)
        events += [ev for ev in extract_alignment(
            rec, revcomp(refseq) if rec.alninfo.reverse else refseq,
            use_native=False).tdiffs if len(ev.evtbases) <= MAX_EV
            and len(ev.evtsub) <= MAX_EV]
    ref_len = len(refseq)
    max_len = ref_cs.ref_bucket_len(ref_len, MAX_EV)
    K = MAX_EV // 3 + 2
    ref_codes = np.full(max_len, ref_cs.PAD, np.int8)
    ref_codes[:ref_len] = encode(refseq)
    r_ev = ref_cs.pack_events(events, MAX_EV)
    r_mot = ref_cs.pack_motifs(DEFAULT_MOTIFS)
    r_ref = jnp.asarray(ref_codes)
    want = ref_cs.ctx_scan(r_ref, jnp.int32(ref_len), r_ev, *r_mot,
                           max_codons=K, max_len=max_len,
                           skip_codan=skip_codan)
    ev = cs.pack_events(events, MAX_EV, CPU)
    mot = cs.pack_motifs(DEFAULT_MOTIFS, CPU)
    t_ref = torch.from_numpy(ref_codes)
    got = cs.ctx_scan(t_ref, ref_len, ev, *mot, max_codons=K,
                      max_len=max_len, skip_codan=skip_codan)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)

    def same(a, b):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    # the reference's stage functions, jitted (eager jnp takes seconds)
    ref_stage = {name: jax.jit(getattr(ref_cs, name), static_argnums=st)
                 for name, st in (("ref_context_windows", ()),
                                  ("hpoly_flags", ()), ("motif_hits", ()),
                                  ("sub_impact", (6,)),
                                  ("indel_stop_scan", (8,)))}
    rctx, rctxloc = cs.ref_context_windows(t_ref, ref_len, ev["rloc"])
    same((rctx, rctxloc), ref_stage["ref_context_windows"](
        r_ref, ref_len, r_ev["rloc"]))
    same(cs.hpoly_flags(ev["evtbases"], ev["nbases"], rctx, rctxloc),
         ref_stage["hpoly_flags"](r_ev["evtbases"], r_ev["nbases"],
                                  jnp.asarray(rctx.numpy()),
                                  jnp.asarray(rctxloc.numpy())))
    same(cs.motif_hits(rctx, *mot),
         ref_stage["motif_hits"](jnp.asarray(rctx.numpy()), *r_mot))
    trloc = (3 * (ev["rloc"] // 3 - 1)).clamp_min(0)
    r_trloc = jnp.asarray(trloc.numpy())
    same(cs.sub_impact(t_ref, ev["rloc"], ev["nbases"], ev["evtbases"],
                       ev["evtsub"], trloc, K),
         ref_stage["sub_impact"](r_ref, r_ev["rloc"], r_ev["nbases"],
                                 r_ev["evtbases"], r_ev["evtsub"], r_trloc,
                                 K))
    same(cs.indel_stop_scan(t_ref, ref_len, ev["rloc"], ev["evt"],
                            ev["evtlen"], ev["nbases"], ev["evtbases"],
                            trloc, max_len),
         ref_stage["indel_stop_scan"](
             r_ref, ref_len, r_ev["rloc"], r_ev["evt"], r_ev["evtlen"],
             r_ev["nbases"], r_ev["evtbases"], r_trloc, max_len))


@pytest.mark.parametrize("skip_codan", [False, True])
def test_synchronous_report_entry_points_equal_reference(skip_codan):
    """``analyze_events_device`` and ``print_diff_info_batch`` on the CPU
    device give the reference's tuples and rows, long events (routed to
    the host analyzer) included."""
    from pwasm_tpu.core import events as ref_events, paf as ref_paf
    from pwasm_tpu.report import device_report as ref_dr
    from pwasm_tpu_torch.core import events as port_events, paf as port_paf
    from pwasm_tpu_torch.report import device_report as dr

    refseq, _, r_events = _corpus_events(6, (ref_paf, ref_events))
    _, _, p_events = _corpus_events(6, (port_paf, port_events))
    assert any(len(e.evtbases) > MAX_EV for e in p_events)
    assert dr.analyze_events_device(refseq, p_events, CPU, skip_codan) == \
        ref_dr.analyze_events_device(refseq, r_events, skip_codan)
    _, r_batch, _ = _corpus_events(6, (ref_paf, ref_events))
    _, p_batch, _ = _corpus_events(6, (port_paf, port_events))
    got, want = io.StringIO(), io.StringIO()
    dr.print_diff_info_batch(p_batch, got, CPU, skip_codan)
    ref_dr.print_diff_info_batch(r_batch, want, skip_codan)
    assert got.getvalue() == want.getvalue() and got.getvalue()
