"""X-drop clip-refinement phases as one dense torch program.

Counterpart of ``pwasm_tpu/ops/refine_clip.py`` (an XLA program in the
reference, with no hand kernel).  The per-member seek-initial-match and
X-drop-extension walks, flattened to (members, layout) tensors by the
host batch pass (``align/gapseq.py refine_clipping_batch``), run as
plain torch ops on the given device: every member is a lane, every
candidate walk step a column, early exits become masks.  Bit-exact with
the host pass: same integer scores, same first-occurrence tie-breaks,
same bounds masks.

The host keeps the ragged-to-padded layout build and the clp5/clp3
write-back; only the two phase computations run here.  Members pad to
a power of two (floor 8), layouts and the consensus to a power of two
(floor 128), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from pwasm_tpu_torch.ops.ctx_scan_impl import first_true

STAR = ord("*")


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


def _phases(gseq, gxpos, cons, cpos, glen, totals, gclipL, gclipR,
            clipL0, clipR0, seqlens, cons_len: int, xdrop: int,
            match_sc: int, mismatch_sc: int):
    """Both phases over padded int64 tensors on one device; returns
    (clipL, clipR, missR, missL) per member lane."""
    M, L = gseq.shape
    dev = gseq.device
    cons2 = cons[None, :].expand(M, cons.shape[0])
    d = torch.arange(L, device=dev)[None, :]

    def take(arr2, pos, valid):
        vals = arr2.gather(1, pos.clamp(0, arr2.shape[1] - 1))
        return torch.where(valid, vals, 0)

    def seek(active, sp0, n_cand, direction):
        # batched initial-match seek (gapseq.py seek2, dense)
        sp = sp0[:, None] + direction * d
        cmask = active[:, None] & (d < n_cand[:, None])
        valid_s = cmask & (sp >= 0) & (sp < totals[:, None])
        gs = take(gseq, sp, valid_s)
        cp = cpos[:, None] + sp
        valid_c = cmask & (cp >= 0) & (cp < cons_len)
        cs = take(cons2, cp, valid_c)
        hit = valid_s & valid_c & (gs == cs) & (gs != STAR)
        bump = (valid_s & (gs != STAR)).long()
        hh = hit.any(dim=1)
        kk = first_true(hit, 1)
        bc = bump.cumsum(dim=1)
        bump_at = bump.gather(1, kk[:, None])[:, 0]
        bc_at = bc.gather(1, kk[:, None])[:, 0]
        # hit rows: non-star candidates strictly before the hit;
        # miss rows: over ALL candidates (the scalar abort semantics)
        bumps = torch.where(hh, bc_at - bump_at, bc[:, -1])
        return active & hh, kk, torch.where(active, bumps, 0)

    def extend(active, sp_m, direction):
        # batched X-drop extension (gapseq.py extend2, dense)
        cp_m = cpos + sp_m
        if direction > 0:
            K = torch.minimum(glen - 1 - sp_m, cons_len - 1 - cp_m)
        else:
            K = torch.minimum(sp_m, cp_m)
        K = torch.where(active, K.clamp_min(0), 0)
        ks = 1 + d
        within = active[:, None] & (ks <= K[:, None])
        pos = sp_m[:, None] + direction * ks
        gs = take(gseq, pos, within)
        cp2 = cp_m[:, None] + direction * ks
        cs = take(cons2, cp2, within)
        nonstar = within & (gs != STAR)
        eq = gs == cs
        delta = torch.where(nonstar,
                            torch.where(eq, match_sc, mismatch_sc), 0)
        scores = match_sc + delta.cumsum(dim=1)
        stop = within & (scores <= xdrop)
        first_stop = torch.where(stop.any(dim=1), first_true(stop, 1), L)
        in_limit = within & (d <= first_stop[:, None])
        cand = torch.where(eq & nonstar & in_limit, scores, xdrop)
        best = cand.amax(dim=1).clamp_min(xdrop)
        bestk = 1 + first_true(cand == cand.amax(dim=1, keepdim=True), 1)
        improved = active & (best > match_sc)
        return torch.where(improved, sp_m + direction * bestk, sp_m)

    def xpos_at(best):
        return gxpos.gather(1, best.clamp(0, L - 1)[:, None])[:, 0]

    # --- clipR phase (gapseq.py lines tagged 'clipR phase') ------------
    actR = clipR0 > 0
    sp0R = glen - gclipR - 1
    n_candR = torch.where(sp0R >= gclipL, sp0R - gclipL + 1, 1)
    hasR, kR, bumpsR = seek(actR, sp0R, n_candR, -1)
    missR = actR & ~hasR
    clipR = torch.where(actR, clipR0 + bumpsR, clipR0)
    sp_mR = sp0R - kR
    bestR = extend(hasR, sp_mR, +1)
    updR = hasR & (bestR > sp_mR)
    clipR = torch.where(updR, seqlens - xpos_at(bestR) - 1, clipR)

    # --- clipL phase ---------------------------------------------------
    actL = (clipL0 > 0) & ~missR
    sp0L = gclipL
    hi = glen - gclipR - 1
    n_candL = torch.where(hi >= sp0L, hi - sp0L + 1, 1)
    hasL, kL, bumpsL = seek(actL, sp0L, n_candL, +1)
    missL = actL & ~hasL
    clipL = torch.where(actL, clipL0 + bumpsL, clipL0)
    sp_mL = sp0L + kL
    bestL = extend(hasL, sp_mL, -1)
    updL = hasL & (bestL < sp_mL)
    clipL = torch.where(updL, xpos_at(bestL), clipL)
    return clipL, clipR, missR, missL


def refine_phases(gseq2, gxpos2, cons_arr, cpos, glen, totals, gclipL,
                  gclipR, clipL0, clipR0, seqlens, xdrop: int,
                  match_sc: int, mismatch_sc: int,
                  device: torch.device):
    """Run both refinement phases on ``device`` over the layout arrays
    built by refine_clipping_batch (numpy in, numpy out).  Returns
    (clipL, clipR, missR, missL) for the M real members."""
    M, L = gseq2.shape
    Mp = _pow2(M, 8)
    Lp = _pow2(L, 128)
    C = len(cons_arr)
    Cp = _pow2(C, 128)

    gseq = np.full((Mp, Lp), STAR, dtype=np.int64)
    gseq[:M, :L] = gseq2
    gxpos = np.zeros((Mp, Lp), dtype=np.int64)
    gxpos[:M, :L] = gxpos2
    cons = np.zeros(Cp, dtype=np.int64)
    cons[:C] = cons_arr

    def dev(a):
        return torch.from_numpy(a).to(device)

    def padv(v):
        out = np.zeros(Mp, dtype=np.int64)
        out[:M] = v
        return dev(out)

    clipL, clipR, missR, missL = _phases(
        dev(gseq), dev(gxpos), dev(cons), padv(cpos), padv(glen),
        padv(totals), padv(gclipL), padv(gclipR), padv(clipL0),
        padv(clipR0), padv(seqlens), C, int(xdrop), int(match_sc),
        int(mismatch_sc))
    return (clipL[:M].cpu().numpy(), clipR[:M].cpu().numpy(),
            missR[:M].cpu().numpy(), missL[:M].cpu().numpy())
