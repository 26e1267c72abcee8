"""What a run loads: nothing of JAX or of the JAX package anywhere, and
nothing of the program in the reference."""

import os
import subprocess
import sys

from portbench import harness

SNIPPET = r"""
import glob, os, sys
sys.path.insert(0, {root!r})
from portbench import harness
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _tops(body: str) -> set:
    code = SNIPPET.format(root=harness.ROOT, body=body)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_run_and_metrics_load_no_jax():
    tops = _tops("""
import runpy
runpy.run_path(os.path.join(harness.HERE, "run.py"), run_name="dry")
for p in glob.glob(os.path.join(harness.HERE, "metrics", "*.py")):
    harness.load_module(p, "m_" + os.path.basename(p)[:-3].replace(".", "_"))
for p in glob.glob(os.path.join(harness.HERE, "reference", "*-*.py")):
    harness.load_module(p, "r_" + os.path.basename(p)[:-3].replace("-", "_"))
import portbench.control
import pwasm_tpu_torch.service.daemon, pwasm_tpu_torch.cli
""")
    assert not tops & {"jax", "jaxlib", "flax", "pwasm_tpu"}


def test_reference_loads_nothing_of_the_program():
    tops = _tops("""
import importlib
for mod in ("pafreport", "m2m", "pw.banded", "pw.diff_report", "pw.dna",
            "pw.events", "pw.gapseq", "pw.msa", "pw.paf", "pw.realign"):
    importlib.import_module("portbench.reference." + mod)
for p in glob.glob(os.path.join(harness.HERE, "reference", "*-*.py")):
    harness.load_module(p, "r_" + os.path.basename(p)[:-3].replace("-", "_"))
""")
    assert "pwasm_tpu_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "pwasm_tpu"}
