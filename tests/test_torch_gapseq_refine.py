"""The port's per-member X-drop clip refinement
(``pwasm_tpu_torch/align/gapseq.py``) against the JAX package's.

``GapSeq.refine_clipping`` (one member through ``refine_clipping_batch``
on the CPU device) is fuzzed against the reference's
``refine_clipping_scalar``, the port's own ``refine_clipping_scalar``
against the reference's, and the port's scalar oracle against its batch
program over many members at once.  Clips and stderr warnings are
compared exactly, in the style of tests/test_gapseq_refine.py."""

import contextlib
import io

import numpy as np
import pytest
import torch

from pwasm_tpu_torch.align.gapseq import (FLAG_BAD_ALN, FLAG_IS_REF,
                                          GapSeq, refine_clipping_batch)

from test_gapseq_refine import _clone, _random_gapseq

CPU = torch.device("cpu")


def _port_copy(s) -> GapSeq:
    c = GapSeq(s.name, s.descr, bytes(s.seq))
    c.gaps = s.gaps.copy()
    c.numgaps = s.numgaps
    c.clp5, c.clp3 = s.clp5, s.clp3
    c.revcompl = s.revcompl
    c.offset = s.offset
    return c


def _quiet(fn) -> str:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        fn()
    return err.getvalue()


def _case(rng, with_dels):
    s = _random_gapseq(rng, with_dels=with_dels)
    glen = s.seqlen + s.numgaps
    if rng.random() < 0.6:
        cons = bytes(s.seq) + rng.choice(
            list(b"ACGT"), int(rng.integers(0, 9))).astype("uint8").tobytes()
    else:
        cons = rng.choice(list(b"ACGT*"), max(4, glen + int(
            rng.integers(-4, 5)))).astype("uint8").tobytes()
    return s, cons, int(rng.integers(-3, 6))


def _check_member(s, cons, cpos, skip_dels):
    """Port per-member, port scalar and the reference's scalar agree."""
    ref = _clone(s)
    port, port_scalar = _port_copy(s), _port_copy(s)
    want_err = _quiet(lambda: ref.refine_clipping_scalar(
        cons, cpos, skip_dels=skip_dels))
    got_err = _quiet(lambda: port.refine_clipping(cons, cpos, CPU,
                                                  skip_dels=skip_dels))
    scalar_err = _quiet(lambda: port_scalar.refine_clipping_scalar(
        cons, cpos, skip_dels=skip_dels))
    want = (ref.clp5, ref.clp3)
    assert (port.clp5, port.clp3) == want, (s.name, cons, cpos)
    assert (port_scalar.clp5, port_scalar.clp3) == want
    assert got_err == scalar_err == want_err


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("skip_dels", [False, True])
@pytest.mark.parametrize("with_dels", [False, True])
def test_refine_clipping_matches_reference_scalar_fuzz(seed, skip_dels,
                                                       with_dels):
    rng = np.random.default_rng(100 + seed)
    for _ in range(40):
        _check_member(*_case(rng, with_dels), skip_dels)


def test_refine_clipping_degenerate_inputs():
    """An empty consensus and a fully deleted layout warn and return in
    all three, as the reference's walk does."""
    rng = np.random.default_rng(5)
    s = _random_gapseq(rng)
    s.clp5, s.clp3 = 2, 2
    _check_member(s, b"", 0, False)
    from pwasm_tpu.align.gapseq import GapSeq as RefGapSeq
    s2 = RefGapSeq("alldel", "", b"ACGT")
    for p in range(4):
        s2.remove_base(p)
    s2.clp3 = 2
    _check_member(s2, b"ACGTACGT", 0, False)


@pytest.mark.parametrize("skip_dels", [False, True])
def test_scalar_oracle_equals_batch_program(skip_dels):
    """The port's scalar walk, member by member, equals one batch pass of
    ``refine_clipping_batch`` over all the members together."""
    rng = np.random.default_rng(31 + skip_dels)
    cases = [_case(rng, with_dels=True) for _ in range(60)]
    cons = cases[0][1] + b"ACGT*" * 8
    scalar = [_port_copy(s) for s, _c, _p in cases]
    batch = [_port_copy(s) for s, _c, _p in cases]
    cposes = [p for _s, _c, p in cases]
    want_err = _quiet(lambda: [s.refine_clipping_scalar(
        cons, p, skip_dels=skip_dels) for s, p in zip(scalar, cposes)])
    got_err = _quiet(lambda: refine_clipping_batch(
        batch, cons, cposes, CPU, skip_dels=skip_dels))
    assert [(s.clp5, s.clp3) for s in batch] == \
        [(s.clp5, s.clp3) for s in scalar]
    assert sorted(got_err.splitlines()) == sorted(want_err.splitlines())


def test_flags_toggle_and_allupper_equal_reference():
    """``clear_flag`` toggles its bit, as the reference's does (a bit
    that is not set becomes set); ``allupper`` upper-cases the bases."""
    from pwasm_tpu.align.gapseq import GapSeq as RefGapSeq

    got, want = GapSeq("a", "", b"acGtn"), RefGapSeq("a", "", b"acGtn")
    trace = []
    for g in (got, want):
        g.set_flag(FLAG_IS_REF)
        g.clear_flag(FLAG_IS_REF)
        g.clear_flag(FLAG_BAD_ALN)        # not set: the toggle sets it
        g.allupper()
        trace.append((g.flags, g.has_flag(FLAG_BAD_ALN), bytes(g.seq)))
    assert trace[0] == trace[1] == (1 << FLAG_BAD_ALN, True, b"ACGTN")
