"""``pafreport --shard`` of the port on a pool of CPU entries.

The port's pool and device functions are monkeypatched so that
``--device=cuda --shard[=N]`` builds its mesh over eight entries that
all name the CPU (each a shard run in turn).  The outputs must be byte-
identical to the port's unsharded ``--device=cpu`` run and to the JAX
package's ``--device=tpu --shard`` run on its 8 virtual CPU devices, on
the inputs of ``tests/test_cli.py`` and ``tests/test_cli_realign.py``'s
shard tests, on the C++ engine and on the Python one
(``PWASM_NATIVE_MSA=0``).  Their ``--stats`` device counters are the
reference's: a call over the mesh is one dispatch, and the pad counts
are the event axis's power-of-two bucket in both (ROADMAP C).  The
usage errors and the ``-v`` line are the reference's, with ``cuda`` for
``tpu``."""

import io
import json

import numpy as np
import pytest
import torch

import pwasm_tpu_torch.device as devmod
from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.ops import consensus, ctx_scan
from pwasm_tpu_torch.parallel import mesh as pm

from helpers import make_paf_line

CPU = torch.device("cpu")
OUTPUTS = ("report.dfa", "summary.txt", "msa.mfa", "contig.ace",
           "contig.info", "cons.fa")
DEVICE_COUNTS = ("device_batches", "device_events", "scalar_events")
DEVICE_BLOCK = ("dispatches", "flushes", "by_site", "pad_items",
                "pad_slots")


def _out_args(d, tag):
    p = str(d / tag)
    return ["-o", f"{p}.report.dfa", "-s", f"{p}.summary.txt",
            "-w", f"{p}.msa.mfa", f"--ace={p}.contig.ace",
            f"--info={p}.contig.info", f"--cons={p}.cons.fa"]


def _read(d, tag):
    return {n: (d / f"{tag}.{n}").read_bytes() for n in OUTPUTS}


def _device_stats(d, tag):
    """The device counters of the run's ``--stats={tag}.json``."""
    st = json.loads((d / f"{tag}.json").read_text())
    return ({k: st[k] for k in DEVICE_COUNTS},
            {k: st["device"][k] for k in DEVICE_BLOCK})


def _inputs(d, q, lines):
    fa = d / "q.fa"
    write_fasta(str(fa), [("q", q.encode())])
    paf = d / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return [str(paf), "-r", str(fa)]


def _corpus(d, realign: bool):
    """tests/test_cli.py's 64 alignments of a 10-base query, or
    tests/test_cli_realign.py's 12 of a 150-base one."""
    if not realign:
        q = "ACGTACGTAC"
        ops = [[("=", 10)], [("=", 6), ("ins", "gg"), ("=", 4)],
               [("=", 2), ("del", 2), ("=", 6)]]
        return _inputs(d, q, [make_paf_line("q", q, f"t{k:03d}", "+",
                                            ops[k % 3])[0]
                              for k in range(64)])
    rng = np.random.default_rng(33)
    q = "".join("ACGT"[i] for i in rng.integers(0, 4, 150))
    ops = [[("=", 150)], [("=", 40), ("ins", "TT"), ("=", 110)],
           [("=", 70), ("del", 3), ("=", 77)]]
    return _inputs(d, q, [make_paf_line("q", q, f"t{k}", "+",
                                        ops[k % 3])[0] for k in range(12)])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's ``--device=tpu --shard`` outputs and device
    counters of both corpora."""
    out = {}
    for realign in (False, True):
        d = tmp_path_factory.mktemp(f"ref{int(realign)}")
        extra = ["--realign"] if realign else []
        err = io.StringIO()
        rc = ref_run([*_corpus(d, realign), *_out_args(d, "ref"),
                      "--device=tpu", "--shard", f"--stats={d}/ref.json",
                      *extra], stderr=err)
        assert rc == 0, err.getvalue()
        out[realign] = _read(d, "ref"), _device_stats(d, "ref")
    return out


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    """The port's ``--device=cpu`` outputs of both corpora, on each MSA
    engine, and the ctx_scan flushes of each run."""
    out = {}
    for realign in (False, True):
        for engine in ("native", "python"):
            d = tmp_path_factory.mktemp(f"flat{int(realign)}{engine}")
            with pytest.MonkeyPatch.context() as mp:
                if engine == "python":
                    mp.setenv("PWASM_NATIVE_MSA", "0")
                ctx_scan.FLUSHES.clear()
                err = io.StringIO()
                rc = run([*_corpus(d, realign), *_out_args(d, "flat"),
                          "--device=cpu",
                          *(["--realign"] if realign else [])], stderr=err)
                assert rc == 0, err.getvalue()
            out[realign, engine] = (_read(d, "flat"),
                                    ctx_scan.FLUSHES["cpu"])
    return out


@pytest.fixture
def cpu_pool(monkeypatch):
    """``--device=cuda`` resolves to the CPU, the pool holds eight CPU
    entries, and no bounded CUDA probe runs (this box has no card)."""
    real = devmod.resolve_device
    monkeypatch.setattr(devmod, "resolve_device",
                        lambda name, stats=None: CPU if name == "cuda"
                        else real(name, stats))
    monkeypatch.setattr(pm, "visible_devices", lambda: [CPU] * 8)
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")


@pytest.mark.parametrize("flag,shards", [("--shard", 8), ("--shard=4", 4)])
@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("realign", [False, True])
def test_shard_byte_identical(tmp_path, monkeypatch, cpu_pool, reference,
                              unsharded, realign, engine, flag, shards):
    if engine == "python":
        monkeypatch.setenv("PWASM_NATIVE_MSA", "0")
    argv = _corpus(tmp_path, realign) + (["--realign"] if realign else [])
    launches = []
    real = consensus.consensus_counts_votes

    def spy(pile, *a, **k):
        launches.append(tuple(pile.shape))
        return real(pile, *a, **k)

    monkeypatch.setattr(pm, "consensus_counts_votes", spy)
    ctx_scan.FLUSHES.clear()
    err = io.StringIO()
    assert run([*argv, *_out_args(tmp_path, "shard"), flag,
                f"--stats={tmp_path}/shard.json"],
               stderr=err) == 0, err.getvalue()
    flat, flat_flushes = unsharded[realign, engine]
    # one count a (depth, column) shard, one scan a shard
    assert len(launches) == shards, launches
    assert ctx_scan.FLUSHES["cpu"] == shards * flat_flushes > 0
    got = _read(tmp_path, "shard")
    ref_out, ref_stats = reference[realign]
    assert got == flat
    assert got == ref_out
    # a call over the mesh is one dispatch: the shards' launches above
    # count as one a site, as the reference's
    counts, block = _device_stats(tmp_path, "shard")
    assert (counts, block) == ref_stats
    assert block["by_site"]["consensus"] == block["by_site"]["ctx_scan"] \
        == 1
    assert block["by_site"].get("realign", 0) == int(realign)


@pytest.mark.parametrize("argv,msg,ref_argv,ref_msg", [
    (["--shard=0"], "Invalid --shard value: 0\n", ["--device=tpu"], None),
    (["--shard=two"], "Invalid --shard value: two\n", ["--device=tpu"],
     None),
    (["--shard", "--device=cpu"],
     " Error: --shard requires --device=cuda!\n", [],
     " Error: --shard requires --device=tpu!\n"),
    (["--shard=9"], "Error: --shard=9 but only 8 devices are visible!\n",
     ["--device=tpu"], None)])
def test_shard_usage_errors(tmp_path, cpu_pool, argv, msg, ref_argv,
                            ref_msg):
    """Each mistake exits 1 with the reference's message (``tpu`` read
    as ``cuda``)."""
    base = [*_corpus(tmp_path, False), "-o", str(tmp_path / "r.dfa")]
    err, ref_err = io.StringIO(), io.StringIO()
    assert run([*base, *argv], stderr=err) == 1
    assert err.getvalue().endswith(msg)
    assert ref_run([*base, *argv, *ref_argv], stderr=ref_err) == 1
    assert ref_err.getvalue().endswith(ref_msg or msg)


@pytest.mark.parametrize("flag,shape", [
    ("--shard", "{'batch': 4, 'depth': 2}"),
    ("--shard=4", "{'batch': 2, 'depth': 2}"),
    ("--shard=1", "{'batch': 1, 'depth': 1}")])
def test_shard_verbose_line(tmp_path, cpu_pool, flag, shape):
    """``-v`` prints the mesh first, as the reference does; every other
    line but the run line is the reference's."""
    argv = [*_corpus(tmp_path, False), "-o", str(tmp_path / "r.dfa"),
            "-w", str(tmp_path / "m.mfa"), "-v", flag]
    err, ref_err = io.StringIO(), io.StringIO()
    assert run(argv, stderr=err) == 0
    assert ref_run(argv + ["--device=tpu"], stderr=ref_err) == 0
    mine, want = err.getvalue().splitlines(), ref_err.getvalue().splitlines()
    assert mine[0] == f"sharding over mesh {shape}"
    assert mine[:-1] == want[:-1]
