"""The port's clip-refinement phases against the JAX package's.

``refine_phases`` (torch, CPU) must equal ``refine_phases_device`` (jax,
CPU) on random padded layouts, and the port's batch refinement (on the
CPU device) must leave every member with the reference's clips, on
randomized MSA members in the style of tests/test_gapseq_refine.py.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from pwasm_tpu.align.gapseq import GapSeq as RefGapSeq
from pwasm_tpu.align.gapseq import refine_clipping_batch as ref_batch
from pwasm_tpu.ops.refine_clip import refine_phases_device
from pwasm_tpu_torch.align.gapseq import GapSeq, refine_clipping_batch
from pwasm_tpu_torch.ops.refine_clip import refine_phases

from test_gapseq_refine import _random_gapseq

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", range(4))
def test_phases_match_reference_on_random_layouts(seed):
    rng = np.random.default_rng(seed)
    M, L, C = 37, 90, 100
    gseq = rng.choice(np.frombuffer(b"ACGT*", np.uint8), size=(M, L))
    gxpos = np.where(gseq != ord("*"),
                     np.cumsum(gseq != ord("*"), axis=1) - 1, -1)
    cons = rng.choice(np.frombuffer(b"ACGT*", np.uint8), size=C)
    glen = rng.integers(L // 3, L + 1, size=M)
    totals = np.minimum(glen + rng.integers(-2, 3, size=M), L)
    gclipL = rng.integers(0, 12, size=M)
    gclipR = rng.integers(0, 12, size=M)
    clipL0 = np.where(rng.random(M) < 0.7, gclipL, 0)
    clipR0 = np.where(rng.random(M) < 0.7, gclipR, 0)
    seqlens = np.maximum(gxpos.max(axis=1) + 1, 1)
    cpos = rng.integers(-4, 8, size=M)
    args = (gseq, gxpos, cons, cpos, glen, totals, gclipL, gclipR,
            clipL0, clipR0, seqlens, RefGapSeq.XDROP, RefGapSeq.MATCH_SC,
            RefGapSeq.MISMATCH_SC)
    want = refine_phases_device(*args)
    got = refine_phases(*args, device=CPU)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (got[0] != clipL0).any() or (got[1] != clipR0).any()


def _port_copy(s) -> GapSeq:
    c = GapSeq(s.name, s.descr, bytes(s.seq))
    c.gaps = s.gaps.copy()
    c.numgaps = s.numgaps
    c.clp5, c.clp3 = s.clp5, s.clp3
    c.revcompl = s.revcompl
    c.offset = s.offset
    return c


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("skip_dels", [False, True])
def test_batch_refinement_matches_reference(seed, skip_dels):
    rng = np.random.default_rng(200 + seed)
    ref_seqs, cposes = [], []
    for k in range(24):
        s = _random_gapseq(rng, with_dels=skip_dels)
        if k % 5 == 0:
            s.clp5 = s.clp3 = 0      # the skip path
        ref_seqs.append(s)
        cposes.append(int(rng.integers(0, 5)))
    port = [_port_copy(s) for s in ref_seqs]
    before = [(s.clp5, s.clp3) for s in port]
    glen_max = max(s.seqlen + s.numgaps for s in ref_seqs)
    cons = rng.choice(list(b"ACGT*"), glen_max + 8).astype("uint8").tobytes()
    with contextlib.redirect_stderr(io.StringIO()):
        ref_batch(ref_seqs, cons, cposes, skip_dels=skip_dels, device=True)
        refine_clipping_batch(port, cons, cposes, CPU,
                              skip_dels=skip_dels)
    for r, d in zip(ref_seqs, port):
        assert (d.clp5, d.clp3) == (r.clp5, r.clp3), r.name
    assert before != [(s.clp5, s.clp3) for s in port]
