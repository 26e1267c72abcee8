"""The variant-context scan formulas, on torch tensors.

Counterpart of ``pwasm_tpu/ops/ctx_scan_impl.py``: the same integer
formulas, written for torch tensors on whatever device the inputs live
on (``ops/ctx_scan.py`` runs them as one program per flush).  Semantics
are the reference's bit for bit (pafreport.cpp:721-883): context windows
with the right-edge quirk, the homopolymer 4-run overlap rule, the
first-motif-wins scan, codon impact through the 5^3 amino-acid LUT and
the frameshift stop scan over the whole modified suffix.

Differences from the numpy/jax idiom are mechanical: gathers use int64
indices (``torch.gather`` / advanced indexing), and "first index where
true" is an explicit masked minimum (:func:`first_true`) instead of
``argmax`` over a boolean, so the first-occurrence tie rule does not
depend on how a backend implements ``argmax``.

Event tensor layout (produced by ``pack_events_np``):
  rloc (E,) int32; evt (E,) int32 {0=S, 1=I, 2=D}; evtlen (E,) int32
  (the reference's evtlen field — stays 1 for merged substitutions);
  nbases (E,) actual evtbases length; evtbases/evtsub (E, MAXEV) int8
  codes padded with PAD.
"""

from __future__ import annotations

import numpy as np
import torch

from pwasm_tpu_torch.core.dna import AA_LUT, CODE_N, ENCODE_TABLE, encode

PAD = 6
EVT_S, EVT_I, EVT_D = 0, 1, 2
CTX = 9          # reference-context window size
MAX_MOTIF = 8    # max motif length supported by the scan


def next_pow2(n: int, floor: int = 256) -> int:
    """Smallest power of two >= max(n, floor) — the shape-bucket rule
    shared by the event axis and the reference tensor."""
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


def ref_bucket_len(ref_len: int, max_ev: int) -> int:
    """Power-of-two padded length for the reference tensor.  Must cover
    ``ref_len + max_ev + 3`` (the frameshift stop-scan window reads the
    whole modified suffix, which an insertion lengthens by up to
    ``max_ev`` bases, plus one codon of slack)."""
    return next_pow2(ref_len + max_ev + 3)


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where there is none,
    like ``argmax`` over an all-False row), as int64."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, device=mask.device).view(shape)
    first = torch.where(mask, idx, n).amin(dim=dim)
    return torch.where(first == n, 0, first)


def translate_codes(c0, c1, c2):
    """Codes (clipped to N) -> amino-acid ASCII (uint8) via the 5^3 LUT;
    any code outside [0,4) translates through N -> 'X'."""
    lut = torch.as_tensor(AA_LUT, device=c0.device)
    c0 = c0.long().clamp(0, CODE_N)
    c1 = c1.long().clamp(0, CODE_N)
    c2 = c2.long().clamp(0, CODE_N)
    return lut[c0 * 25 + c1 * 5 + c2]


def pack_events_np(events, max_ev: int = 16, bucket: int = 256) -> dict:
    """SoA-pack a list of DiffEvent into numpy tensors.  Events whose
    bases exceed ``max_ev`` must take the scalar path (caller filters).

    The event axis is padded to ``next_pow2`` of a multiple of
    ``bucket``; padding rows are zeros (a 0-length 'S' event at rloc 0)
    and callers read only the first ``len(events)`` results."""
    E = len(events)
    E_pad = next_pow2(E, bucket) if bucket else E
    if E == 0:
        return dict(rloc=np.zeros(E_pad, np.int32),
                    evt=np.zeros(E_pad, np.int32),
                    evtlen=np.zeros(E_pad, np.int32),
                    nbases=np.zeros(E_pad, np.int32),
                    evtbases=np.full((E_pad, max_ev), PAD, np.int8),
                    evtsub=np.full((E_pad, max_ev), PAD, np.int8))
    evt_code = {"S": EVT_S, "I": EVT_I, "D": EVT_D}
    rloc = np.zeros(E_pad, np.int32)
    evt = np.zeros(E_pad, np.int32)
    evtlen = np.zeros(E_pad, np.int32)
    rloc[:E] = np.fromiter((ev.rloc for ev in events), np.int32, E)
    evt[:E] = np.fromiter((evt_code[ev.evt] for ev in events),
                          np.int32, E)
    evtlen[:E] = np.fromiter((ev.evtlen for ev in events), np.int32, E)

    def code_plane(raw: list[bytes]):
        # one concatenated encode + a single scatter instead of one
        # numpy round-trip per event
        lens = np.fromiter(map(len, raw), np.int64, E)
        cat = np.frombuffer(b"".join(raw), dtype=np.uint8)
        codes = ENCODE_TABLE[cat]
        keep_lens = np.minimum(lens, max_ev)
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        idx_row = np.repeat(np.arange(E), lens)
        idx_col = np.arange(len(cat)) - np.repeat(starts, lens)
        plane = np.full((E_pad, max_ev), PAD, np.int8)
        sel = idx_col < max_ev
        plane[idx_row[sel], idx_col[sel]] = codes[sel]
        return plane, keep_lens.astype(np.int32)

    evtbases, nb = code_plane([ev.evtbases.upper() for ev in events])
    evtsub, _ = code_plane([ev.evtsub.upper() for ev in events])
    nbases = np.zeros(E_pad, np.int32)
    nbases[:E] = nb
    return dict(rloc=rloc, evt=evt, evtlen=evtlen, nbases=nbases,
                evtbases=evtbases, evtsub=evtsub)


def pack_motifs_np(motifs) -> tuple[np.ndarray, np.ndarray]:
    """Motif table -> (codes (NM, MAX_MOTIF) int8, lens (NM,) int32)."""
    nm = len(motifs)
    codes = np.full((nm, MAX_MOTIF), PAD, np.int8)
    lens = np.zeros(nm, np.int32)
    for i, mot in enumerate(motifs):
        b = encode(mot.encode() if isinstance(mot, str) else mot)
        if len(b) > MAX_MOTIF:
            raise ValueError(f"motif longer than {MAX_MOTIF}: {mot}")
        codes[i, :len(b)] = b
        lens[i] = len(b)
    return codes, lens


def _gather(ref: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``ref[clip(idx, 0, len-1)]`` with int64 indices."""
    return ref[idx.long().clamp(0, ref.shape[0] - 1)]


def ref_context_windows(ref, ref_len: int, rloc):
    """(E,) event positions -> (E, 9) windows + (E,) local offsets,
    mirroring get_ref_context exactly (including the right-edge quirk)."""
    ctxstart = rloc - 4
    evtloc = torch.full_like(rloc, 4)
    left = ctxstart < 0
    right = ~left & (ctxstart + 8 >= ref_len)
    evtloc = torch.where(left, evtloc + ctxstart, evtloc)
    # the right-edge branch uses the OLD ctxstart in its (sign-flipped)
    # adjustment — reference behavior preserved
    evtloc = torch.where(right, evtloc + ref_len - ctxstart - 9, evtloc)
    ctxstart = torch.where(left, 0, ctxstart)
    ctxstart = torch.where(right, ref_len - 9, ctxstart)
    degen = right & (ctxstart < 0)
    evtloc = torch.where(degen, evtloc + ctxstart, evtloc)
    ctxstart = torch.where(degen, 0, ctxstart)
    idx = ctxstart[:, None] + torch.arange(CTX, device=rloc.device)[None, :]
    return _gather(ref, idx), evtloc


def hpoly_flags(evtbases, nbases, rctx, rctxloc):
    """Vectorized hpolyCheck: all event bases identical AND a 4-run of the
    base inside the window overlapping the event offset."""
    dev = evtbases.device
    first = evtbases[:, 0]
    kidx = torch.arange(evtbases.shape[1], device=dev)[None, :]
    valid = kidx < nbases[:, None]
    all_same = ((evtbases == first[:, None]) | ~valid).all(dim=1)
    # seed positions l in [0, 6): window[l:l+4] all == first
    l = torch.arange(CTX - 4 + 1, device=dev)
    runs = (rctx[:, l[:, None] + torch.arange(4, device=dev)[None, :]]
            == first[:, None, None]).all(dim=2)         # (E, 6)
    # reference uses GStr::index -> FIRST run position only
    has_run = runs.any(dim=1)
    lpos = first_true(runs, 1)
    overlap = (lpos <= rctxloc) & (rctxloc <= lpos + 4)
    return all_same & has_run & overlap & (nbases > 0)


def motif_hits(rctx, mot_codes, mot_lens):
    """First motif (table order) found anywhere in each window; returns
    (E,) int32 1-based motif index, 0 = none."""
    dev = rctx.device
    nm, mw = mot_codes.shape
    starts = torch.arange(CTX, device=dev)            # candidate start pos
    ks = torch.arange(mw, device=dev)
    idx = (starts[:, None] + ks[None, :]).clamp(0, CTX - 1)   # (9, mw)
    win = rctx[:, idx]                                # (E, 9, mw)
    cmp = win[:, None] == mot_codes[None, :, None]    # (E, nm, 9, mw)
    klt = ks[None, :] < mot_lens[:, None]             # (nm, mw)
    ok = (cmp | ~klt[None, :, None, :]).all(dim=3)    # (E, nm, 9)
    fits = (starts[None, :] + mot_lens[:, None]) <= CTX   # (nm, 9)
    found = (ok & fits[None]).any(dim=2)              # (E, nm)
    any_hit = found.any(dim=1)
    first = first_true(found, 1)
    return torch.where(any_hit, first + 1, 0).to(torch.int32)


def sub_impact(ref, rloc, nbases, evtbases, evtsub, r_trloc,
               max_codons: int):
    """Substitution codon impact: for up to ``max_codons`` affected codons
    return (orig_aa, new_aa, aapos, valid, sub_mismatch)."""
    dev = ref.device
    e_off = rloc - r_trloc                  # event offset in the window
    ao_first = e_off // 3
    ao_last = (e_off + nbases.clamp_min(1) - 1) // 3
    d = torch.arange(max_codons, device=dev)[None, :]
    ao = ao_first[:, None] + d              # (E, K) codon window indices
    kvalid = ao <= ao_last[:, None]
    cpos = r_trloc[:, None, None] + ao[..., None] * 3 \
        + torch.arange(3, device=dev)[None, None, :]  # (E, K, 3) abs pos
    Rn = ref.shape[0]
    orig = torch.where(cpos < Rn, _gather(ref, cpos), PAD)
    # overlay the substituted bases at [rloc, rloc+nbases)
    rel = cpos - rloc[:, None, None]
    inside = (rel >= 0) & (rel < nbases[:, None, None])
    rows = torch.arange(evtbases.shape[0], device=dev)[:, None, None]
    sub = evtbases[rows, rel.long().clamp(0, evtbases.shape[1] - 1)]
    mod = torch.where(inside, sub, orig)
    orig_aa = translate_codes(orig[..., 0], orig[..., 1], orig[..., 2])
    new_aa = translate_codes(mod[..., 0], mod[..., 1], mod[..., 2])
    aapos = ao + (rloc // 3)[:, None]
    # the reference verifies each substituted base against the query
    # (pafreport.cpp:812-813); surface that as a flag the host turns fatal
    kb = torch.arange(evtbases.shape[1], device=dev)[None, :]
    bvalid = kb < nbases[:, None]
    refb = _gather(ref, rloc[:, None] + kb)
    mism = ((refb != evtsub) & bvalid).any(dim=1)
    return orig_aa, new_aa, aapos, kvalid, mism


def indel_stop_scan(ref, ref_len: int, rloc, evt, evtlen, nbases,
                    evtbases, r_trloc, max_len: int):
    """Frameshift analysis for I/D events: build the modified suffix
    (insert/cut at the event), translate codon-by-codon, find the first
    premature stop, and collect the reference's aa4/maa4 preview codons.

    Returns (stop_aapos (E,) int32 or -1, aa4 (E,4) uint8, maa4 (E,4)
    uint8, aa4_valid, maa4_valid).  ``max_len`` bounds the scanned
    window (the caller sizes it to cover the whole modified suffix)."""
    dev = ref.device
    E = rloc.shape[0]
    e_off = rloc - r_trloc
    is_ins = evt == EVT_I
    nb = torch.where(is_ins, nbases, evtlen)
    j = torch.arange(max_len, dtype=torch.int32, device=dev)[None, :]
    # source index for each modified-sequence position
    before = j < e_off[:, None]
    ins_src = torch.where(before, r_trloc[:, None] + j,
                          r_trloc[:, None] + j - nb[:, None])
    ins_inside = ~before & (j < (e_off + nb)[:, None])
    del_src = torch.where(before, r_trloc[:, None] + j,
                          r_trloc[:, None] + j + nb[:, None])
    src = torch.where(is_ins[:, None], ins_src, del_src)
    base = torch.where(src < ref_len, _gather(ref, src), PAD)
    rows = torch.arange(E, device=dev)[:, None]
    insb = evtbases[rows, (j - e_off[:, None]).long().clamp(
        0, evtbases.shape[1] - 1)]
    seq = torch.where(is_ins[:, None] & ins_inside, insb, base)
    modlen = torch.where(is_ins, ref_len - r_trloc + nb,
                         ref_len - r_trloc - nb)
    n_cod = max_len // 3
    cpos = torch.arange(n_cod, device=dev)[None, :] * 3
    cpos_b = cpos.expand(E, n_cod)
    aa = translate_codes(seq.gather(1, cpos_b), seq.gather(1, cpos_b + 1),
                         seq.gather(1, cpos_b + 2))     # (E, n_cod)
    cvalid = (cpos + 2) < modlen[:, None]   # while i+2 < len(modseq)
    stop = (aa == ord(".")) & cvalid
    has_stop = stop.any(dim=1)
    cstar = first_true(stop, 1)
    stop_aapos = torch.where(has_stop, 1 + cstar + r_trloc // 3, -1)
    # aa4/maa4: codons c = 1..4, before the stop, valid in each sequence
    c14 = torch.arange(1, 5, device=dev)[None, :]
    before_stop = ~has_stop[:, None] | (c14 < cstar[:, None])
    c14_b = c14.expand(E, 4)
    maa4_valid = before_stop & cvalid.gather(1, c14_b)
    maa4 = aa.gather(1, c14_b)
    # aa4 comes from the unmodified suffix (same positions)
    opos = r_trloc[:, None] + c14 * 3
    o0 = torch.where(opos < ref_len, _gather(ref, opos), PAD)
    o1 = torch.where(opos + 1 < ref_len, _gather(ref, opos + 1), PAD)
    o2 = torch.where(opos + 2 < ref_len, _gather(ref, opos + 2), PAD)
    aa4 = translate_codes(o0, o1, o2)
    # reference guard: i+2 < len(r_trseq)  <=>  opos+2 < ref_len
    aa4_valid = maa4_valid & ((opos + 2) < ref_len)
    return (stop_aapos.to(torch.int32), aa4, maa4, aa4_valid,
            maa4_valid)


def ctx_scan_calc(ref, ref_len: int, ev: dict, mot_codes, mot_lens,
                  max_codons: int = 8, max_len: int = 4096,
                  skip_codan: bool = False) -> dict:
    """The fused event-analysis program.  Returns a dict of tensors;
    ``report/columnar.py`` turns them into report rows."""
    rloc = ev["rloc"]
    rctx, rctxloc = ref_context_windows(ref, ref_len, rloc)
    hpoly = hpoly_flags(ev["evtbases"], ev["nbases"], rctx, rctxloc)
    motif = motif_hits(rctx, mot_codes, mot_lens)
    aapos0 = rloc // 3
    ca = aapos0 * 3
    aa = translate_codes(
        _gather(ref, ca),
        torch.where(ca + 1 < ref_len, _gather(ref, ca + 1), PAD),
        torch.where(ca + 2 < ref_len, _gather(ref, ca + 2), PAD))
    out = dict(rctx=rctx, rctxloc=rctxloc, hpoly=hpoly, motif=motif,
               aa=aa, aapos=aapos0 + 1)
    if not skip_codan:
        r_trloc = (3 * (aapos0 + 1 - 2)).clamp_min(0)
        s_orig, s_new, s_pos, s_valid, s_mism = sub_impact(
            ref, rloc, ev["nbases"], ev["evtbases"], ev["evtsub"],
            r_trloc, max_codons)
        stop_aapos, aa4, maa4, aa4_v, maa4_v = indel_stop_scan(
            ref, ref_len, rloc, ev["evt"], ev["evtlen"], ev["nbases"],
            ev["evtbases"], r_trloc, max_len)
        out.update(s_orig_aa=s_orig, s_new_aa=s_new, s_aapos=s_pos,
                   s_valid=s_valid, s_mismatch=s_mism,
                   stop_aapos=stop_aapos, aa4=aa4, maa4=maa4,
                   aa4_valid=aa4_v, maa4_valid=maa4_v)
    return out


def ctx_scan_layout(max_codons: int, skip_codan: bool) -> list:
    """(field, per-event width) pairs of the scan output, in the fixed
    order of the packed single-tensor transfer (``ctx_scan_packed`` /
    ``unpack_ctx_scan``)."""
    fields = [("rctx", CTX), ("rctxloc", 1), ("hpoly", 1), ("motif", 1),
              ("aa", 1), ("aapos", 1)]
    if not skip_codan:
        K = max_codons
        fields += [("s_orig_aa", K), ("s_new_aa", K), ("s_aapos", K),
                   ("s_valid", K), ("s_mismatch", 1), ("stop_aapos", 1),
                   ("aa4", 4), ("maa4", 4), ("aa4_valid", 4),
                   ("maa4_valid", 4)]
    return fields


def unpack_ctx_scan(flat: np.ndarray, max_codons: int,
                    skip_codan: bool) -> dict:
    """Split the packed (E, total_width) int32 fetch back into the
    per-field dict (numpy views — no copies).  Width-1 fields come back
    as (E,) and the rest as (E, width)."""
    out = {}
    col = 0
    for name, width in ctx_scan_layout(max_codons, skip_codan):
        if width == 1:
            out[name] = flat[:, col]
        else:
            out[name] = flat[:, col:col + width]
        col += width
    return out
