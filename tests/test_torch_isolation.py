"""The port stands alone: ``pwasm_tpu_torch`` and ``chip_smoke.py``
import neither jax nor anything of the JAX package, at run time and in
their source; its state tables and its corpus generator equal the
reference's."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pwasm_tpu.align.gapseq import GapSeq as RefGapSeq
from pwasm_tpu.core.config import DEFAULT_MOTIFS as REF_MOTIFS
from pwasm_tpu.core.dna import AA_LUT as REF_AA_LUT
from pwasm_tpu.core.dna import ENCODE_TABLE as REF_ENCODE
from pwasm_tpu.ops.ctx_scan_impl import pack_motifs_np as ref_pack_motifs
from pwasm_tpu_torch import corpus, state

from test_realistic_scale import make_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"\bimport\s+jax\b|\bfrom\s+jax\b"
                       r"|\bpwasm_tpu\.|\bimport\s+pwasm_tpu\b"
                       r"|\bfrom\s+pwasm_tpu\s+import\b")


CXX_FORBIDDEN = re.compile(r"pwasm_tpu/|\bpwasm_tpu\.|\bjax\b")


def _port_sources():
    top = os.path.join(REPO, "pwasm_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_build")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_never_name_jax_or_the_reference():
    hits = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if FORBIDDEN.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{i}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)
    assert sum(1 for _ in _port_sources()) > 20


def test_port_cxx_sources_never_name_the_reference():
    top = os.path.join(REPO, "pwasm_tpu_torch", "native")
    paths = sorted(os.path.join(top, fn) for fn in os.listdir(top)
                   if fn.endswith((".cpp", ".h")))
    assert [os.path.basename(p) for p in paths] == [
        "fastparse.cpp", "pafreport_msa.h", "pafreport_util.h"]
    hits = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if CXX_FORBIDDEN.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{i}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)


def test_cli_run_imports_neither_jax_nor_the_reference(tmp_path):
    for name in ("in.paf", "q.fa"):
        shutil.copy(os.path.join(REPO, "tests", "golden", name), tmp_path)
    outs = [f"-o{tmp_path / 'r.dfa'}", f"-s{tmp_path / 's.txt'}",
            f"-w{tmp_path / 'm.mfa'}", f"--ace={tmp_path / 'c.ace'}",
            f"--info={tmp_path / 'c.info'}", f"--cons={tmp_path / 'c.fa'}"]
    argv = [str(tmp_path / "in.paf"), "-r", str(tmp_path / "q.fa"),
            *outs, "--device=cpu"]
    code = (
        "import sys\n"
        "from pwasm_tpu_torch.cli import run\n"
        f"assert run({argv!r}) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'pwasm_tpu' or m.startswith('pwasm_tpu.'))\n"
        "print('BAD', bad)\n"
        "maps = open('/proc/self/maps').read().split()\n"
        f"ref = {os.path.join(REPO, 'pwasm_tpu') + os.sep!r}\n"
        "print('LIBS', sorted({p for p in maps if p.startswith(ref)}))\n"
        "print('ENGINE', any('libfastparse-' in p for p in maps))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
    # the run loaded the port's engine, and no library of the reference
    assert "LIBS []" in out.stdout and "ENGINE True" in out.stdout, \
        out.stdout
    assert (tmp_path / "c.fa").read_bytes() == open(
        os.path.join(REPO, "tests", "golden", "cons.fa"), "rb").read()


def _reference_state() -> dict:
    codes, lens = ref_pack_motifs(REF_MOTIFS)
    return dict(motif_codes=codes, motif_lens=lens, aa_lut=REF_AA_LUT,
                encode_table=REF_ENCODE,
                refine_consts=np.array([RefGapSeq.XDROP,
                                        RefGapSeq.MATCH_SC,
                                        RefGapSeq.MISMATCH_SC], np.int32))


def test_state_from_reference_equals_builtin_tables():
    cpu = torch.device("cpu")
    got = state.from_reference(_reference_state(), cpu)
    own = state.from_reference(state.builtin_arrays(), cpu)
    assert set(got) == set(state.STATE_KEYS)
    for key in state.STATE_KEYS:
        assert got[key].device == cpu
        assert torch.equal(got[key], own[key]), key
    bad = dict(_reference_state(), aa_lut=REF_AA_LUT[:-1])
    with pytest.raises(ValueError):
        state.from_reference(bad, cpu)
    with pytest.raises(ValueError):
        state.from_reference({}, cpu)


@pytest.mark.parametrize("seed,n_aln", [(20260730, 25), (7, 9)])
def test_corpus_copy_gives_the_reference_lines(seed, n_aln):
    assert corpus.make_corpus(seed=seed, n_aln=n_aln) \
        == make_corpus(seed=seed, n_aln=n_aln)
