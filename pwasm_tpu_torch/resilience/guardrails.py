"""Cheap invariant validation of device outputs.

Counterpart of ``pwasm_tpu/resilience/guardrails.py``, copied whole; it
runs on the host copies each supervised attempt returns.

A device that silently returns garbage is worse than one that raises:
the garbage lands in the report and the run "succeeds".  Each check
below costs O(batch) numpy work — noise next to the device program it
guards — and raises :class:`GuardrailViolation`, which the supervisor
treats exactly like a device exception: the batch is re-executed, and
only validated output is ever formatted.

The checks are *domain* invariants, not recomputation: value ranges of
the int8/ASCII code spaces, index bounds against the reference length,
and the conservation laws the kernels guarantee by construction
(pileup counts sum to column coverage; a re-alignment walk consumes
exactly ``t_len`` target bases).  A corruption that passes all of them
is allowed to differ from the host path only where the host path could
have produced it too.
"""

from __future__ import annotations

import numpy as np


class GuardrailViolation(Exception):
    """A device output failed invariant validation (treated as a device
    fault: retried, then degraded, never written to the report)."""


def _fail(site: str, msg: str):
    raise GuardrailViolation(f"{site}: {msg}")


def check_array(arr, name: str, *, site: str, shape=None, dtype_kind=None,
                lo=None, hi=None, finite: bool = True) -> None:
    """Shape/dtype/range/finiteness check for one output tensor."""
    a = np.asarray(arr)
    if shape is not None and tuple(a.shape) != tuple(shape):
        _fail(site, f"{name} shape {a.shape} != expected {tuple(shape)}")
    if dtype_kind is not None and a.dtype.kind not in dtype_kind:
        _fail(site, f"{name} dtype {a.dtype} not of kind {dtype_kind!r}")
    if a.size == 0:
        return
    if finite and a.dtype.kind == "f" and not np.isfinite(a).all():
        _fail(site, f"{name} contains non-finite values")
    if lo is not None and int(a.min()) < lo:
        _fail(site, f"{name} min {a.min()} < {lo}")
    if hi is not None and int(a.max()) > hi:
        _fail(site, f"{name} max {a.max()} > {hi}")


def check_ctx_scan(host: dict, n_events: int, ref_len: int,
                   n_motifs: int, skip_codan: bool,
                   site: str = "ctx_scan") -> None:
    """Validate a fetched ctx_scan output dict (device_report's host
    fetch): leading dims match the event batch, flag/code/position
    tensors stay inside their domains.  AA codes are ASCII (0 when
    unset), positions are bounded by the reference's codon count."""
    aa_hi = 127
    # AA positions are 1-based codon indices; the frameshift stop scan
    # may run a few codons past the reference end (the modified suffix
    # includes up to MAX_EV inserted bases), so the bound is loose by a
    # small constant — injected garbage sits orders of magnitude above
    pos_hi = ref_len + 64
    req = ("aa", "aapos", "hpoly", "motif")
    for k in req:
        if k not in host:
            _fail(site, f"missing output {k!r}")
    # pack_events pads the event batch to a compile bucket, so every
    # leading dim is >= the live event count (and all equal); only the
    # live prefix reaches the report, so ranges are checked on it alone
    lead = None
    for k, v in host.items():
        a = np.asarray(v)
        if a.ndim == 0 or a.shape[0] < n_events:
            _fail(site, f"{k} leading dim {a.shape} < batch {n_events}")
        if lead is None:
            lead = a.shape[0]
        elif a.shape[0] != lead:
            _fail(site, f"{k} leading dim {a.shape[0]} != {lead}")
        if a.dtype.kind == "f" and not np.isfinite(a[:n_events]).all():
            _fail(site, f"{k} contains non-finite values")

    def live(k):
        return np.asarray(host[k])[:n_events]

    check_array(live("aa"), "aa", site=site, lo=0, hi=aa_hi)
    check_array(live("aapos"), "aapos", site=site, lo=-1, hi=pos_hi)
    check_array(live("hpoly"), "hpoly", site=site, lo=0, hi=1)
    check_array(live("motif"), "motif", site=site, lo=0, hi=n_motifs)
    if not skip_codan:
        for k in ("s_orig_aa", "s_new_aa", "aa4", "maa4"):
            if k in host:
                check_array(live(k), k, site=site, lo=0, hi=aa_hi)
        for k in ("s_valid", "aa4_valid", "maa4_valid", "s_mismatch"):
            if k in host:
                check_array(live(k), k, site=site, lo=0, hi=1)
        if "s_aapos" in host:
            check_array(live("s_aapos"), "s_aapos", site=site, lo=-1,
                        hi=pos_hi)
        if "stop_aapos" in host:
            check_array(live("stop_aapos"), "stop_aapos", site=site,
                        lo=-1, hi=pos_hi)


def check_realign(scores, leads, iy_runs, ops_rows, ok, q_lens, t_lens,
                  match_score: int, site: str = "realign") -> None:
    """Validate one realign dispatch (``banded_realign_rows`` outputs).

    Domain checks on every lane plus the conservation law on ``ok``
    lanes: the walk's forward op string consumes exactly ``t_len``
    target bases, i.e. ``lead + sum(iy_runs) + #DIAG rows == t_len``
    (query bases are consumed structurally — one op per live row).
    Scores are bounded above by a perfect match of the whole query."""
    from pwasm_tpu_torch.ops.realign import OP_DIAG, OP_IX

    scores = np.asarray(scores)
    leads = np.asarray(leads)
    iy = np.asarray(iy_runs)
    ops = np.asarray(ops_rows)
    okv = np.asarray(ok)
    q_lens = np.asarray(q_lens)
    t_lens = np.asarray(t_lens)
    T = q_lens.shape[0]
    m_max = iy.shape[1] if iy.ndim == 2 else 0
    check_array(scores, "scores", site=site, shape=(T,))
    check_array(leads, "leads", site=site, shape=(T,), lo=0)
    check_array(iy, "iy_runs", site=site, shape=(T, m_max), lo=0)
    check_array(ops, "ops_rows", site=site, shape=(T, m_max), lo=0,
                hi=max(OP_DIAG, OP_IX))
    check_array(okv, "ok", site=site, shape=(T,), dtype_kind="b")
    if not okv.any():
        return
    live = np.arange(m_max)[None, :] < q_lens[:, None]
    diag = ((ops == OP_DIAG) & live).sum(axis=1)
    consumed = leads + np.where(live, iy, 0).sum(axis=1) + diag
    bad = okv & (consumed != t_lens)
    if bad.any():
        k = int(np.argmax(bad))
        _fail(site, f"lane {k}: walk consumes {consumed[k]} target "
                    f"bases != t_len {t_lens[k]}")
    hi = q_lens * match_score
    if (okv & (scores > hi)).any():
        _fail(site, "score exceeds the perfect-match bound")


def check_consensus(chars, counts, pile, site: str = "consensus") -> None:
    """Validate a device consensus (``device_counts_votes`` output)
    against the pileup it was computed from: per-column class counts
    must sum to the column's coverage (entries with codes 0..5 — the
    pileup-count conservation law), and vote characters must come from
    the consensus alphabet (0 = zero coverage)."""
    chars = np.asarray(chars)
    counts = np.asarray(counts)
    pile = np.asarray(pile)
    ncols = pile.shape[1]
    check_array(counts, "counts", site=site, shape=(ncols, 6), lo=0)
    check_array(chars, "chars", site=site, shape=(ncols,))
    alphabet = {0} | set(b"ACGTN-*")
    vals = set(np.unique(chars).tolist())
    if not vals <= alphabet:
        _fail(site, f"vote characters outside the consensus alphabet: "
                    f"{sorted(vals - alphabet)[:5]}")
    coverage = (pile < 6).sum(axis=0, dtype=np.int64)
    got = counts.sum(axis=1, dtype=np.int64)
    if (got != coverage).any():
        k = int(np.argmax(got != coverage))
        _fail(site, f"column {k}: counts sum {got[k]} != coverage "
                    f"{coverage[k]} (pileup-count conservation)")


def check_refine_clips(clipL, clipR, seqlens, site: str = "refine") -> None:
    """Validate a device clip-refinement result: per-member clip counts
    are non-negative and bounded by the member's sequence length (a
    clip can never exceed the sequence it trims)."""
    clipL = np.asarray(clipL)
    clipR = np.asarray(clipR)
    seqlens = np.asarray(seqlens)
    M = seqlens.shape[0]
    check_array(clipL, "clipL", site=site, shape=(M,), lo=0)
    check_array(clipR, "clipR", site=site, shape=(M,), lo=0)
    if (clipL > seqlens).any() or (clipR > seqlens).any():
        _fail(site, "clip exceeds the member sequence length")


def check_scores_matrix(scores, n_rows: int, n_cols: int,
                        max_per_base: int, m: int,
                        site: str = "many2many") -> None:
    """Validate a (Q, T) banded-DP score matrix: shape, integer dtype,
    and the perfect-match upper bound ``m * match`` (NEG sentinels are
    legal below)."""
    s = np.asarray(scores)
    check_array(s, "scores", site=site, shape=(n_rows, n_cols),
                dtype_kind="iu")
    if s.size and int(s.max()) > m * max_per_base:
        _fail(site, f"score {s.max()} exceeds the perfect-match bound "
                    f"{m * max_per_base}")
