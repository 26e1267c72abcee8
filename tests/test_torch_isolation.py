"""The port stands alone: ``pwasm_tpu_torch`` and ``chip_smoke.py``
import neither jax nor anything of the JAX package, at run time and in
their source; its state tables and its corpus generator equal the
reference's."""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

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
    # the multi-device layer is among the sources checked
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {f"pwasm_tpu_torch/parallel/{m}.py" for m in (
        "mesh", "many2many", "wavefront_sp", "bucketing")} <= rel
    # and so are the run statistics, the profiler hook and obs/
    assert {f"pwasm_tpu_torch/obs/{m}.py" for m in (
        "__init__", "catalog", "events", "merge", "metrics",
        "tracing")} <= rel
    assert {f"pwasm_tpu_torch/utils/{m}.py" for m in (
        "backend", "fsio", "profiling", "runstats")} <= rel
    # and the drain, the supervisor, its guardrails and fault injection
    assert {f"pwasm_tpu_torch/resilience/{m}.py" for m in (
        "__init__", "faults", "guardrails", "lifecycle",
        "supervisor")} <= rel
    # and the streaming ingest
    assert {f"pwasm_tpu_torch/stream/{m}.py" for m in (
        "__init__", "multicds", "pafstream")} <= rel
    # and the serving daemon, its fleet pieces and the flight record
    assert {f"pwasm_tpu_torch/service/{m}.py" for m in (
        "__init__", "cache", "client", "daemon", "journal", "leases",
        "protocol", "queue")} <= rel
    assert {f"pwasm_tpu_torch/fleet/{m}.py" for m in (
        "__init__", "fencing", "ledger", "router", "scaler", "standby",
        "transport")} <= rel
    assert "pwasm_tpu_torch/obs/flight.py" in rel
    # and self-monitoring and surveillance
    assert {"pwasm_tpu_torch/obs/slo.py", "pwasm_tpu_torch/obs/logquery.py",
            "pwasm_tpu_torch/service/canary.py",
            "pwasm_tpu_torch/service/top.py"} <= rel
    assert {f"pwasm_tpu_torch/surveil/{m}.py" for m in (
        "__init__", "partition", "records", "session")} <= rel


def test_port_cxx_sources_never_name_the_reference():
    top = os.path.join(REPO, "pwasm_tpu_torch", "native")
    paths = sorted(os.path.join(top, fn) for fn in os.listdir(top)
                   if fn.endswith((".cpp", ".h")) or fn == "Makefile")
    assert [os.path.basename(p) for p in paths] == [
        "Makefile", "fastparse.cpp", "msa_bridge_san.cpp",
        "pafreport_main.cpp", "pafreport_msa.h", "pafreport_util.h",
        "selftest.cpp"]
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
    obs = [f"--stats={tmp_path / 'st.json'}",
           f"--trace-json={tmp_path / 't.json'}",
           f"--log-json={tmp_path / 'e.ndjson'}",
           f"--metrics-textfile={tmp_path / 'm.prom'}",
           f"--profile={tmp_path / 'prof'}"]
    argv = [str(tmp_path / "in.paf"), "-r", str(tmp_path / "q.fa"),
            *outs, *obs, "--device=cpu", "--max-retries=8",
            "--inject-faults=seed=1,rate=0.3,kinds=raise+nan+corrupt"]
    merge = ["trace-merge", str(tmp_path / "t.json"), "-o",
             str(tmp_path / "tm.json")]
    # a served job: a daemon on a thread of this process, and the
    # client verb as the CLI dispatches it
    serve = ["submit", f"--socket={tmp_path / 's.sock'}", "--",
             *argv[:1], "-r", argv[2], f"-o{tmp_path / 'served.dfa'}",
             "--device=cpu"]
    code_serve = (
        "import threading\n"
        "from pwasm_tpu_torch.service.daemon import Daemon\n"
        "from pwasm_tpu_torch.service.client import wait_for_socket\n"
        f"dm = Daemon({str(tmp_path / 's.sock')!r}, journal_path=None)\n"
        "t = threading.Thread(target=dm.serve, daemon=True)\n"
        "t.start()\n"
        f"assert wait_for_socket({str(tmp_path / 's.sock')!r}, 30)\n")
    code = (
        "import sys\n"
        "from pwasm_tpu_torch.cli import run\n"
        + code_serve +
        f"assert run({argv!r}) == 0\n"
        f"assert run({merge!r}) == 0\n"
        "import pwasm_tpu_torch.parallel.mesh\n"
        "import pwasm_tpu_torch.parallel.many2many\n"
        "import pwasm_tpu_torch.parallel.wavefront_sp\n"
        "import pwasm_tpu_torch.obs.catalog\n"
        "import pwasm_tpu_torch.utils.backend\n"
        "import pwasm_tpu_torch.utils.profiling\n"
        "import pwasm_tpu_torch.resilience\n"
        "import pwasm_tpu_torch.stream.pafstream\n"
        "import pwasm_tpu_torch.obs.flight\n"
        "import pwasm_tpu_torch.fleet.fencing\n"
        "import pwasm_tpu_torch.fleet.ledger\n"
        "import pwasm_tpu_torch.fleet.router\n"
        "import pwasm_tpu_torch.fleet.scaler\n"
        "import pwasm_tpu_torch.fleet.standby\n"
        "import pwasm_tpu_torch.fleet.transport\n"
        "import pwasm_tpu_torch.service.cache\n"
        "import pwasm_tpu_torch.service.journal\n"
        "import pwasm_tpu_torch.service.leases\n"
        "import pwasm_tpu_torch.service.queue\n"
        "import pwasm_tpu_torch.service.canary\n"
        "import pwasm_tpu_torch.service.top\n"
        "import pwasm_tpu_torch.obs.slo\n"
        "import pwasm_tpu_torch.obs.logquery\n"
        "import pwasm_tpu_torch.surveil.session\n"
        f"assert run({serve!r}) == 0\n"
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
    assert (tmp_path / "served.dfa").read_bytes() \
        == (tmp_path / "r.dfa").read_bytes()
    for name in ("st.json", "t.json", "e.ndjson", "m.prom",
                 "prof/trace.json", "tm.json"):
        assert (tmp_path / name).stat().st_size > 0, name


def _verbs_code(verbs):
    """A process running each argv of ``verbs`` as ``python -m
    pwasm_tpu_torch`` runs it, then printing the exit codes and every
    loaded module of torch, jax or the reference."""
    return (
        "import runpy, sys\n"
        "rcs = []\n"
        f"for argv in {verbs!r}:\n"
        "    sys.argv = ['pwasm_tpu_torch', *argv]\n"
        "    try:\n"
        "        runpy.run_module('pwasm_tpu_torch', run_name='__main__',\n"
        "                         alter_sys=True)\n"
        "    except SystemExit as e:\n"
        "        rcs.append(e.code)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'pwasm_tpu'))\n"
        "print('RCS', rcs)\n"
        "print('BAD', bad)\n")


def test_client_processes_import_no_torch(tmp_path):
    """A ``submit``, ``top``, ``health`` or ``logs`` client process, as
    ``python -m pwasm_tpu_torch`` runs it, against a live port daemon
    (and ``logs`` on a file with no daemon), stays light: it loads no
    torch, no jax and nothing of the reference.  So does a ``route``
    process over that daemon with its SLO scaler armed, which routes a
    job and drains (exit 0), and a ``route --standby-of`` process
    tailing it, which stands by until SIGTERM (exit 0)."""
    for name in ("in.paf", "q.fa"):
        shutil.copy(os.path.join(REPO, "tests", "golden", name), tmp_path)
    sock = str(tmp_path / "s.sock")
    log = str(tmp_path / "ev.ndjson")
    env = dict(os.environ, PYTHONPATH=REPO)
    daemon = subprocess.Popen(
        [sys.executable, "-m", "pwasm_tpu_torch", "serve",
         f"--socket={sock}", f"--log-json={log}", "--journal=off"],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    rsock = str(tmp_path / "r.sock")
    verbs = [["submit", f"--socket={sock}", "--", "in.paf", "-r", "q.fa",
              "-o", "r.dfa", "--device=cpu"],
             ["health", f"--socket={sock}", "--exit-code"],
             ["top", f"--socket={sock}", "--once"],
             ["logs", f"--socket={sock}", "--event=job_finish"],
             ["logs", log, "--event=job_admit"],
             ["submit", f"--socket={rsock}", "--", "in.paf", "-r", "q.fa",
              "-o", "routed.dfa", "--device=cpu"],
             ["svc-stats", f"--socket={rsock}", "--drain"]]
    # a policy whose bound is the one member: the scaler ticks, never
    # spawns
    pol = tmp_path / "pol.json"
    pol.write_text(json.dumps({"min_members": 1, "max_members": 1,
                               "spawn": {"socket_dir": str(tmp_path)}}))
    route = [["route", f"--backends={sock}", f"--socket={rsock}",
              "--poll-interval=0.1", f"--scale-policy={pol}"]]
    standby = [["route", f"--standby-of={rsock}", "--poll-interval=0.1"]]
    router = stand = None
    try:
        from pwasm_tpu_torch.service.client import wait_for_socket
        assert wait_for_socket(sock, 60)
        router = subprocess.Popen(
            [sys.executable, "-c", _verbs_code(route)], cwd=str(tmp_path),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        assert wait_for_socket(rsock, 60)
        sb_err = tmp_path / "sb.err"
        with open(sb_err, "w") as ef:
            stand = subprocess.Popen(
                [sys.executable, "-c", _verbs_code(standby)],
                cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                stderr=ef, text=True)
        deadline = time.monotonic() + 60
        while "standing by" not in sb_err.read_text():
            assert time.monotonic() < deadline, sb_err.read_text()
            time.sleep(0.05)
        time.sleep(0.5)              # past its signal handler's install
        stand.send_signal(signal.SIGTERM)
        sout, _ = stand.communicate(timeout=60)
        serr = sb_err.read_text()
        out = subprocess.run([sys.executable, "-c", _verbs_code(verbs)],
                             cwd=str(tmp_path), env=env,
                             capture_output=True, text=True, timeout=240)
        rout, rerr = router.communicate(timeout=60)
    finally:
        for p in (router, stand):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        daemon.terminate()
        daemon.wait(60)
    assert stand.returncode == 0, serr[-2000:]
    assert "RCS [0]" in sout and "BAD []" in sout, sout + serr
    assert "standby drained before any takeover" in serr
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RCS [0, 0, 0, 0, 0, 0, 0]" in out.stdout, \
        out.stdout + out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert router.returncode == 0, rerr[-2000:]
    assert "RCS [0]" in rout and "BAD []" in rout, rout + rerr
    assert (tmp_path / "routed.dfa").read_bytes() \
        == (tmp_path / "r.dfa").read_bytes()
    assert "ALERTS: none" in out.stdout
    assert '"event":"job_finish"' in out.stdout
    assert '"event":"job_admit"' in out.stdout


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
