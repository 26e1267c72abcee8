"""``pwasm_tpu_torch/utils/runstats.py`` against the JAX package's
``RunStats``: the same versioned schema, the same note rules, the same
``-v`` line, and the same dispatch sites for the consensus and the clip
refinement, which the CLI reaches only through the Python MSA engine's
``refine_msa``."""

import io
import time

import numpy as np
import pytest
import torch

from pwasm_tpu.align.gapseq import GapSeq as RefGapSeq
from pwasm_tpu.align.msa import Msa as RefMsa
from pwasm_tpu.resilience import BatchSupervisor, ResiliencePolicy
from pwasm_tpu.utils.runstats import STATS_VERSION as REF_VERSION
from pwasm_tpu.utils.runstats import RunStats as RefRunStats
from pwasm_tpu_torch.align.gapseq import GapSeq
from pwasm_tpu_torch.align.msa import Msa
from pwasm_tpu_torch.resilience.supervisor import \
    BatchSupervisor as PortSupervisor
from pwasm_tpu_torch.utils.runstats import STATS_VERSION, RunStats

WALLS = ("wall_s", "aligned_bases_per_s")


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k != "by_site":
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


def test_schema_equals_the_reference():
    port, ref = RunStats().as_dict(), RefRunStats().as_dict()
    assert STATS_VERSION == REF_VERSION == port["stats_version"] == 1
    assert list(port) == list(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert list(port[k]) == list(v), k
    assert {k: v for k, v in _flat(port).items() if k not in WALLS} \
        == {k: v for k, v in _flat(ref).items() if k not in WALLS}


NOTES = {
    "dispatches": [("dispatch", "ctx_scan"), ("flush",),
                   ("dispatch", "realign", 3), ("flush", 2),
                   ("dispatch", "ctx_scan"), ("dispatch", "consensus")],
    "pads": [("pad", 5, 256), ("pad", 300, 512), ("pad", 0, 256)],
    "walls": [("wall", "ctx_scan", 0.5), ("wall", "ctx_scan", 0.25),
              ("wall", "realign", 0.125), ("wall", "ctx_scan", 0.0625)],
}


@pytest.mark.parametrize("seq", list(NOTES))
def test_notes_equal_the_reference(seq):
    out = []
    for st in (RunStats(), RefRunStats()):
        st.alignments, st.events, st.aligned_bases = 3, 7, 90
        for note in NOTES[seq]:
            kind, args = note[0], note[1:]
            {"dispatch": st.note_dispatch, "flush": st.note_flush,
             "pad": st.note_pad, "wall": st.note_attempt_wall}[kind](*args)
        out.append({k: v for k, v in _flat(st.as_dict()).items()
                    if k not in WALLS})
    assert out[0] == out[1]


@pytest.mark.parametrize("wall,bases", [(2.5, 1000), (0.0004, 17),
                                        (1.23456, 123456789)])
def test_brief_equals_the_reference(monkeypatch, wall, bases):
    lines = []
    for cls in (RunStats, RefRunStats):
        monkeypatch.setattr(time, "perf_counter", lambda: 100.0)
        st = cls()
        st.alignments, st.events, st.aligned_bases = 4, 9, bases
        monkeypatch.setattr(time, "perf_counter", lambda: 100.0 + wall)
        lines.append(st.brief())
        monkeypatch.undo()
    assert lines[0] == lines[1]
    assert lines[0].startswith(f"4 alignments, 9 events, {bases} aligned")


def test_write_is_one_json_line(tmp_path):
    import json
    st = RunStats()
    st.note_dispatch("ctx_scan")
    buf = io.StringIO()
    st.write(buf)
    text = buf.getvalue()
    assert text.endswith("\n") and text.count("\n") == 1
    assert json.loads(text)["device"]["by_site"] == {"ctx_scan": 1}


def _msa(cls_gap, cls_msa, seed):
    """The reference's tests/test_consensus_ops.py random MSA, with clips
    on every member but the first."""
    rng = np.random.default_rng(seed)
    seqs = []
    for k in range(6):
        seq = rng.choice(list(b"ACGT"), size=40).astype(np.uint8).tobytes()
        s = cls_gap(f"s{k}", "", seq)
        for _ in range(rng.integers(0, 4)):
            s.set_gap(int(rng.integers(0, 40)), int(rng.integers(1, 3)))
        seqs.append(s)
    msa = cls_msa(seqs[0], seqs[1])
    for s in seqs[2:]:
        msa.add_seq(s, 0, 0)
    r = np.random.default_rng(seed + 60)
    for s in msa.seqs[1:]:
        s.clp5 = int(r.integers(1, 4))
        s.clp3 = int(r.integers(1, 4))
    return msa


@pytest.mark.parametrize("seed,remove_gaps", [(0, False), (3, True)])
def test_refine_msa_dispatch_sites_equal_the_reference(seed, remove_gaps):
    port_st = RunStats()
    port = _msa(GapSeq, Msa, seed)
    port.refine_msa(torch.device("cpu"), remove_cons_gaps=remove_gaps,
                    supervisor=PortSupervisor(stats=port_st))
    ref_st = RefRunStats()
    ref = _msa(RefGapSeq, RefMsa, seed)
    sup = BatchSupervisor(ResiliencePolicy(), stats=ref_st,
                          stderr=io.StringIO(),
                          probe=lambda: (True, ""))
    ref.refine_msa(remove_cons_gaps=remove_gaps, device=True,
                   supervisor=sup)
    assert bytes(port.consensus) == bytes(ref.consensus)
    for a, b in zip(port.seqs, ref.seqs):
        assert (a.clp5, a.clp3) == (b.clp5, b.clp3)
    pd, rd = port_st.as_dict()["device"], ref_st.as_dict()["device"]
    assert pd["by_site"] == rd["by_site"]
    assert pd["by_site"]["consensus"] == 1 and pd["by_site"]["refine"] >= 1
    assert (pd["dispatches"], pd["flushes"]) \
        == (rd["dispatches"], rd["flushes"])
