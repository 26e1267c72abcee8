"""The port's serve daemon with the result cache, and served
``--many2many``, against the JAX package's, on the CPU.

Ports of the daemon cases of ``tests/test_cache.py`` (admission with
zero pipeline, a restart that keeps its hits, eviction under budget,
the ``cache-probe`` verb, served ``--many2many`` on the daemon's
directory, the admission delta, the prefetch drill), each job at
``--device=cpu``, outputs held to the port's cold run and to
``pwasm_tpu.cli --device=cpu``'s, byte for byte.  Served
``--many2many`` with a section hit and a superset splice is also held
to the reference's daemon (under ``--slo-rules=off``) serving the same
jobs.  No refusal table of a later slice is left.
Each daemon is held open for seconds."""

import io
import json
import os
import shutil
import tempfile
import threading
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.service import protocol
from pwasm_tpu_torch.service.cache import classify_argv, derive_keys
from pwasm_tpu_torch.service.client import ServiceClient, wait_for_socket
from pwasm_tpu_torch.service.daemon import Daemon

from helpers import make_paf_line


def _lines(n, qlen, seed):
    rng = np.random.default_rng(seed)
    q = "".join("ACGT"[i] for i in rng.integers(0, 4, qlen))
    lines = []
    for i in range(n):
        cut = 10 + int(rng.integers(0, qlen - 40))
        qb = q[cut]
        tb = "ACGT"[("ACGT".index(qb) + 1) % 4]
        ops = [("=", cut), ("*", tb, qb), ("=", 20), ("ins", "gg"),
               ("=", qlen - cut - 21)]
        lines.append(make_paf_line("q", q, f"asm{i}", "+", ops)[0])
    return q, lines


def _corpus(tmp_path, n=24, qlen=120, seed=3):
    q, lines = _lines(n, qlen, seed)
    fa = tmp_path / "q.fa"
    write_fasta(str(fa), [("q", q.encode())])
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa)


def _key_of(argv):
    return derive_keys(classify_argv(argv))[0]


@contextmanager
def _daemon(cls=Daemon, **kw):
    sockdir = tempfile.mkdtemp(prefix="pwcache")
    sock = os.path.join(sockdir, "s.sock")
    err = io.StringIO()
    dm = cls(sock, stderr=err, **kw)
    rcbox: list = []
    t = threading.Thread(target=lambda: rcbox.append(dm.serve()),
                         daemon=True)
    t.start()
    assert wait_for_socket(sock, 15), err.getvalue()
    try:
        yield SimpleNamespace(daemon=dm, sock=sock, rc=rcbox, err=err,
                              thread=t, dir=sockdir)
    finally:
        if not dm.drain.requested:
            dm.drain.request("test teardown")
        t.join(20)
        shutil.rmtree(sockdir, ignore_errors=True)


def _submit_wait(sock, argv, timeout=120):
    with ServiceClient(sock) as c:
        sub = c.submit(argv)
        assert sub.get("ok"), sub
        res = c.result(sub["job_id"], timeout=timeout)
    assert res.get("ok"), res
    return res


def _cold_ref(tmp_path, argv, out):
    """The reference's cold run of ``argv`` (its report at ``out``)."""
    assert ref_run(argv + ["-o", str(out)], stderr=io.StringIO()) == 0
    return out.read_bytes()


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------
def test_serve_admission_hit_zero_pipeline(tmp_path):
    """Job 1 misses and inserts; job 2 (a reordered argv, other output
    paths) is answered AT ADMISSION: done, no probe, no lease grant, no
    run of the CLI, a cache_hit journal record and no start record."""
    paf, fa = _corpus(tmp_path)
    calls = []

    def runner(argv, **kw):
        calls.append(list(argv))
        return run(argv, **kw)

    with _daemon(result_cache=str(tmp_path / "cd"), runner=runner) as h:
        r1 = _submit_wait(h.sock, [paf, "-r", fa, "-o",
                                   str(tmp_path / "j1.dfa"),
                                   "--device=cpu",
                                   f"--stats={tmp_path / 'j1.json'}"])
        assert r1.get("rc") == 0, r1
        grants = h.daemon.leases.grants
        t0 = time.perf_counter()
        r2 = _submit_wait(h.sock, ["-r", fa, paf, "--device=cpu",
                                   f"--stats={tmp_path / 'j2.json'}",
                                   "-o", str(tmp_path / "j2.dfa")])
        hit_wall = time.perf_counter() - t0
        assert r2.get("rc") == 0, r2
        assert "result cache" in r2["job"]["detail"]
        assert len(calls) == 1                  # the hit ran nothing
        assert h.daemon.leases.grants == grants
        assert hit_wall < 1.0
        st2 = json.load(open(tmp_path / "j2.json"))
        assert st2["cache_hit"] is True
        assert st2["backend"] == {"probes": 0, "warm_hits": 0}
        with ServiceClient(h.sock) as c:
            st = c.stats()["stats"]
        assert (st["cache"]["hits"], st["cache"]["misses"],
                st["cache"]["insertions"]) == (1, 1, 1)
        assert st["jobs"]["completed"] == 2
        rows = [json.loads(ln) for ln in
                open(h.sock + ".journal").read().splitlines()]
        kinds = [r["rec"] for r in rows if r.get("job_id") == "job-0002"]
        assert kinds == ["admit", "cache_hit", "finish"], kinds
        h.daemon.drain.request("done")
    assert h.rc == [75]
    want = _cold_ref(tmp_path, [paf, "-r", fa], tmp_path / "ref.dfa")
    assert (tmp_path / "j1.dfa").read_bytes() == want
    assert (tmp_path / "j2.dfa").read_bytes() == want


def test_serve_hit_survives_restart(tmp_path):
    """The cache outlives the daemon: a fresh daemon on the same
    directory serves a hit for a job its predecessor ran."""
    paf, fa = _corpus(tmp_path)
    cd = str(tmp_path / "cd")
    with _daemon(result_cache=cd) as h:
        assert _submit_wait(h.sock, [paf, "-r", fa, "-o",
                                     str(tmp_path / "p.dfa"),
                                     "--device=cpu"]).get("rc") == 0
        h.daemon.drain.request("cycle")
    with _daemon(result_cache=cd) as h2:
        r = _submit_wait(h2.sock, [paf, "-r", fa, "-o",
                                   str(tmp_path / "q.dfa"),
                                   f"--stats={tmp_path / 'q.json'}",
                                   "--device=cpu"])
        assert r.get("rc") == 0
        assert json.load(open(tmp_path / "q.json"))["cache_hit"] is True
    assert (tmp_path / "p.dfa").read_bytes() \
        == (tmp_path / "q.dfa").read_bytes()


def test_serve_eviction_under_budget(tmp_path):
    """--result-cache-max-bytes: two distinct jobs overflow a 1-byte
    budget, LRU eviction runs, and svc-stats counts it."""
    paf, fa = _corpus(tmp_path)
    with _daemon(result_cache=str(tmp_path / "cd"),
                 result_cache_max_bytes=1) as h:
        for i, extra in enumerate(([], ["-c", "30"])):
            r = _submit_wait(h.sock, [paf, "-r", fa, "-o",
                                      str(tmp_path / f"e{i}.dfa"),
                                      "--device=cpu"] + extra)
            assert r.get("rc") == 0
        with ServiceClient(h.sock) as c:
            st = c.stats()["stats"]["cache"]
        assert st["insertions"] == 2 and st["evictions"] >= 1


def test_cache_probe_verb(tmp_path):
    """The ``cache-probe`` command and the client verb: true for a held
    key (the verb derives it from the job's argv, as the reference's
    ``derive_keys`` does), false for another, a bad request without a
    key, and disabled without a cache."""
    paf, fa = _corpus(tmp_path)
    argv = [paf, "-r", fa, "-o", str(tmp_path / "a.dfa"), "--device=cpu"]
    with _daemon(result_cache=str(tmp_path / "cd")) as h:
        assert _submit_wait(h.sock, argv).get("rc") == 0
        key, fam = derive_keys(classify_argv(argv))
        with ServiceClient(h.sock) as c:
            hitp = c.cache_probe(key)
            famp = c.cache_probe("0" * 64, fam)
            missp = c.cache_probe("0" * 64)
            badp = c.cache_probe("")
        assert hitp.get("hit") is True and hitp.get("enabled")
        assert famp.get("hit") is False and famp.get("family_hit") is True
        assert missp.get("hit") is False
        assert badp.get("error") == protocol.ERR_BAD_REQUEST
        out, err = io.StringIO(), io.StringIO()
        assert run(["cache-probe", f"--socket={h.sock}", "--"] + argv,
                   stdout=out, stderr=err) == 0, err.getvalue()
        assert json.loads(out.getvalue()) == {
            "key": key, "family": fam, "enabled": True, "hit": True,
            "family_hit": True}
        out = io.StringIO()
        assert run(["cache-probe", f"--socket={h.sock}",
                    f"--key={'0' * 64}"], stdout=out,
                   stderr=io.StringIO()) == 1
        assert json.loads(out.getvalue())["hit"] is False
    with _daemon() as h2:
        with ServiceClient(h2.sock) as c:
            p = c.cache_probe("0" * 64)
        assert p.get("enabled") is False and p.get("hit") is False


def test_serve_admission_delta_rearms_as_resume(tmp_path):
    """An appended input exact-misses at admission but delta-hits: the
    daemon writes the cached prefix, queues the job as a ``--resume``,
    stamps its finished stats with the served and total records,
    journals a delta cache_hit record (the admit keeps the original
    argv), and moves the hit ratio fractionally."""
    q, lines = _lines(30, 120, 3)
    fa = tmp_path / "dq.fa"
    write_fasta(str(fa), [("q", q.encode())])
    p1, p2 = tmp_path / "prefix.paf", tmp_path / "full.paf"
    p1.write_text("".join(ln + "\n" for ln in lines[:27]))
    p2.write_text("".join(ln + "\n" for ln in lines))
    with _daemon(result_cache=str(tmp_path / "cd")) as h:
        r1 = _submit_wait(h.sock, [str(p1), "-r", str(fa), "-o",
                                   str(tmp_path / "j1.dfa"),
                                   "--device=cpu"])
        assert r1.get("rc") == 0, r1
        r2 = _submit_wait(h.sock, [str(p2), "-r", str(fa), "-o",
                                   str(tmp_path / "j2.dfa"),
                                   f"--stats={tmp_path / 'j2.json'}",
                                   "--device=cpu"])
        assert r2.get("rc") == 0, r2
        st = r2.get("stats") or {}
        assert st.get("cache_delta") is True
        assert (st["cache_records_served"],
                st["cache_records_total"]) == (26, 30)
        assert json.load(open(tmp_path / "j2.json"))["cache_delta"] \
            is True
        with ServiceClient(h.sock) as c:
            cb = c.stats()["stats"]["cache"]
        assert (cb["delta_hits"], cb["delta_records_served"]) == (1, 26)
        assert cb["hits"] == 0 and cb["misses"] == 2
        assert abs(cb["hit_ratio"] - (26 / 30) / 2) < 1e-6
        rows = [json.loads(ln) for ln in
                open(h.sock + ".journal").read().splitlines()]
        drecs = [r for r in rows
                 if r.get("rec") == "cache_hit" and r.get("delta")]
        assert drecs and (drecs[0]["served"], drecs[0]["total"]) \
            == (26, 30)
        admits = [r for r in rows if r.get("rec") == "admit"
                  and r.get("job_id") == drecs[0]["job_id"]]
        assert admits and "--resume" not in admits[0]["argv"]
    want = _cold_ref(tmp_path, [str(p2), "-r", str(fa)],
                     tmp_path / "cold.dfa")
    assert (tmp_path / "j2.dfa").read_bytes() == want


def test_warm_spawn_prefetch_drill(tmp_path):
    """A daemon started with --cache-prefetch over a populated directory
    warms entries BEFORE its socket exists; its first repeat job is an
    admission hit (no probe) and svc-stats counts the prefetched
    entries; the ``cache_prefetch`` event lands in its log."""
    paf, fa = _corpus(tmp_path)
    cd = str(tmp_path / "shared")
    with _daemon(result_cache=cd) as h:
        assert _submit_wait(h.sock, [paf, "-r", fa, "-o",
                                     str(tmp_path / "w1.dfa"),
                                     "--device=cpu"]).get("rc") == 0
    log = tmp_path / "ev.ndjson"
    with _daemon(result_cache=cd, cache_prefetch=8,
                 log_json=str(log)) as h2:
        with ServiceClient(h2.sock) as c:
            assert c.stats()["stats"]["cache"]["prefetched"] >= 1
        r = _submit_wait(h2.sock, [paf, "-r", fa, "-o",
                                   str(tmp_path / "w2.dfa"),
                                   f"--stats={tmp_path / 'w2.json'}",
                                   "--device=cpu"])
        assert r.get("rc") == 0, r
        st = json.load(open(tmp_path / "w2.json"))
        assert st["cache_hit"] is True and st["backend"]["probes"] == 0
        err = h2.err.getvalue()
        assert err.index("prefetch") < err.index("serving on")
    events = [json.loads(ln)["event"] for ln in log.read_text()
              .splitlines()]
    assert events.index("cache_prefetch") < events.index("daemon_start")
    assert (tmp_path / "w1.dfa").read_bytes() \
        == (tmp_path / "w2.dfa").read_bytes()


def test_insert_outage_warns_once_and_serves(tmp_path, monkeypatch):
    """A failed insert costs the cache, never the job: the jobs finish
    with their outputs, the daemon warns once for the outage, and
    ``insert_errors`` counts each skip."""
    paf, fa = _corpus(tmp_path, n=6)
    with _daemon(result_cache=str(tmp_path / "cd")) as h:
        # every blob write fails, as on a full disk
        monkeypatch.setattr(h.daemon.cache, "_blob_path",
                            lambda key, kind: str(tmp_path / "gone" /
                                                  f"{key}.{kind}"))
        for i, extra in enumerate(([], ["-c", "30"])):
            r = _submit_wait(h.sock, [paf, "-r", fa, "-o",
                                      str(tmp_path / f"f{i}.dfa"),
                                      "--device=cpu"] + extra)
            assert r.get("rc") == 0
        with ServiceClient(h.sock) as c:
            cb = c.stats()["stats"]["cache"]
        assert cb["insert_errors"] == 2 and cb["insertions"] == 0
        assert h.err.getvalue().count("result-cache insert skipped") == 1
    assert (tmp_path / "f0.dfa").stat().st_size > 0


# ---------------------------------------------------------------------------
# served --many2many
# ---------------------------------------------------------------------------
def _m2m_files(tmp_path, nq=4, nt=6, seed=7):
    rng = np.random.default_rng(seed)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    qs = [(f"cds{k}", seq(120 + 10 * k)) for k in range(nq)]
    ts = [(f"asm{k}", seq(200 + 13 * k)) for k in range(nt)]
    tfa = tmp_path / "targets.fa"
    tfa.write_text("".join(f">{n}\n{s}\n" for n, s in ts))
    return qs, ts, str(tfa)


def _write_fa(tmp_path, name, recs):
    p = tmp_path / name
    p.write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    return str(p)


def test_m2m_served_job_uses_daemon_cache_dir(tmp_path):
    """A served --many2many job inherits ``serve --result-cache``: its
    sections land in the daemon's directory and a later served job
    partial-hits (only the new query scored), to the cold run's bytes."""
    qs, _ts, tfa = _m2m_files(tmp_path)
    q3 = _write_fa(tmp_path, "q3.fa", qs[:3])
    q4 = _write_fa(tmp_path, "q4.fa", qs)
    with _daemon(result_cache=str(tmp_path / "cd")) as h:
        r = _submit_wait(h.sock, ["--many2many", tfa, "-r", q3, "-o",
                                  str(tmp_path / "s3.tsv"),
                                  "--device=cpu"])
        assert r.get("rc") == 0, r
        stj = str(tmp_path / "s4.json")
        r = _submit_wait(h.sock, ["--many2many", tfa, "-r", q4, "-o",
                                  str(tmp_path / "s4.tsv"),
                                  f"--stats={stj}", "--device=cpu"])
        assert r.get("rc") == 0, r
        assert json.load(open(stj))["alignments"] == 6
    want = _cold_ref(tmp_path, ["--many2many", tfa, "-r", q4],
                     tmp_path / "ref.tsv")
    assert (tmp_path / "s4.tsv").read_bytes() == want


def _served_m2m(cls, tmp_path, tag, qfa, t_small, t_big, **kw):
    """One daemon of ``cls`` on a fresh cache: the small-target job (a
    miss), the same again (answered at admission), the superset job (a
    splice of the new targets' pairs), the superset again.  Returns the
    reports, the stats files and the cache blocks."""
    out = {}
    with _daemon(cls, result_cache=str(tmp_path / f"{tag}cd"),
                 journal_path=None, **kw) as h:
        for step, tfa in (("miss", t_small), ("hit", t_small),
                          ("super", t_big), ("super_hit", t_big)):
            stj = str(tmp_path / f"{tag}{step}.json")
            r = _submit_wait(h.sock, [
                "--many2many", tfa, "-r", qfa, "-o",
                str(tmp_path / f"{tag}{step}.tsv"), "-s",
                str(tmp_path / f"{tag}{step}.sum"), f"--stats={stj}",
                "--device=cpu"])
            assert r.get("rc") == 0, r
            st = json.load(open(stj))
            out[step] = dict(
                tsv=(tmp_path / f"{tag}{step}.tsv").read_bytes(),
                sum=(tmp_path / f"{tag}{step}.sum").read_bytes(),
                alignments=st.get("alignments"),
                cache_hit=st.get("cache_hit"), detail=r["job"]["detail"])
        with ServiceClient(h.sock) as c:
            st = c.stats()["stats"]
        out["cache"] = {k: st["cache"][k] for k in (
            "hits", "misses", "insertions", "delta_hits",
            "delta_records_served", "delta_records_total")}
        out["m2m"] = st["m2m"]
    return out


def test_served_m2m_superset_equals_cold_and_the_reference(tmp_path):
    """Served --many2many on one daemon: a miss, the same job answered
    at admission (no scoring), a superset target set whose sections
    splice the cached scores and score only the new targets' pairs, and
    that superset again.  Every report and summary equals the port's and
    the reference's cold runs; the reference's daemon serving the same
    jobs gives the same bytes, the same counts and the same cache
    block."""
    from pwasm_tpu.service.daemon import Daemon as RefDaemon
    qs, ts, t6 = _m2m_files(tmp_path, nq=3, nt=6, seed=17)
    qfa = _write_fa(tmp_path, "q.fa", qs)
    t4 = _write_fa(tmp_path, "t4.fa", ts[:4])
    port = _served_m2m(Daemon, tmp_path, "p", qfa, t4, t6)
    ref = _served_m2m(RefDaemon, tmp_path, "r", qfa, t4, t6,
                      slo_rules="off")
    for big, tfa in (("miss", t4), ("super", t6)):
        err = io.StringIO()
        assert run(["--many2many", tfa, "-r", qfa, "-o",
                    str(tmp_path / f"cold{big}.tsv"), "-s",
                    str(tmp_path / f"cold{big}.sum"), "--device=cpu"],
                   stderr=err) == 0, err.getvalue()
    for step, cold in (("miss", "miss"), ("hit", "miss"),
                       ("super", "super"), ("super_hit", "super")):
        for ext in ("tsv", "sum"):
            want = (tmp_path / f"cold{cold}.{ext}").read_bytes()
            assert port[step][ext] == ref[step][ext] == want, (step, ext)
        assert port[step]["alignments"] == ref[step]["alignments"]
        assert port[step]["cache_hit"] == ref[step]["cache_hit"]
        assert port[step]["detail"] == ref[step]["detail"]
    assert [port[s]["alignments"] for s in ("miss", "super")] == [12, 6]
    assert port["hit"]["cache_hit"] is port["super_hit"]["cache_hit"] \
        is True
    assert port["cache"] == ref["cache"]
    assert (port["cache"]["hits"], port["cache"]["insertions"]) == (2, 2)
    assert port["m2m"] == ref["m2m"]


def test_served_m2m_lane_span_mesh(tmp_path, monkeypatch):
    """A lease of more than one device scores over the lane-span 2-D mesh
    (``stream/multicds.py::lane_span_mesh``), here of CPU entries (with
    ``--device=cuda`` mapped to the CPU), to the cold run's bytes; a
    one-device lease has no mesh, and a mesh that cannot be built raises
    (no demotion to one device)."""
    import torch

    from pwasm_tpu_torch import device as devmod
    from pwasm_tpu_torch.parallel import mesh as pm
    from pwasm_tpu_torch.parallel import many2many
    from pwasm_tpu_torch.stream import multicds
    cpu = torch.device("cpu")
    monkeypatch.setattr(devmod, "resolve_device",
                        lambda name, stats=None: cpu)
    monkeypatch.setattr(pm, "visible_devices", lambda: [cpu] * 4)
    cpu_cuda = SimpleNamespace(type="cuda")
    warm = SimpleNamespace(lease_devices=(0, 4))
    mesh = multicds.lane_span_mesh(cpu_cuda, warm, io.StringIO())
    assert dict(mesh.shape) == {"query": 2, "target": 2}
    assert multicds.lane_span_mesh(
        cpu_cuda, SimpleNamespace(lease_devices=(1, 2)),
        io.StringIO()) is None
    assert multicds.lane_span_mesh(cpu, warm, io.StringIO()) is None
    assert multicds.lane_span_mesh(cpu_cuda, None, io.StringIO()) is None
    monkeypatch.setattr(many2many, "make_mesh2d",
                        lambda devices: (_ for _ in ()).throw(
                            RuntimeError("no such mesh")))
    with pytest.raises(RuntimeError, match="no such mesh"):
        multicds.lane_span_mesh(cpu_cuda, warm, io.StringIO())
    monkeypatch.undo()
    # end to end: a served job on a 4-device lease scores on the mesh
    monkeypatch.setattr(devmod, "resolve_device",
                        lambda name, stats=None: cpu)
    monkeypatch.setattr(pm, "visible_devices", lambda: [cpu] * 4)
    monkeypatch.setattr(multicds, "lane_span_mesh",
                        lambda device, warm, stderr, verbose=False:
                        many2many.make_mesh2d(devices=[cpu] * 4))
    seen = []
    real = many2many.many2many_scores_ragged

    def spy(*a, **k):
        seen.append(sorted(k.keys() & {"mesh", "device"}))
        return real(*a, **k)

    monkeypatch.setattr(many2many, "many2many_scores_ragged", spy)
    qs, _ts, tfa = _m2m_files(tmp_path, nq=3)
    qfa = _write_fa(tmp_path, "q.fa", qs)
    with _daemon(devices_per_job=4) as h:
        r = _submit_wait(h.sock, ["--many2many", tfa, "-r", qfa, "-o",
                                  str(tmp_path / "m.tsv")])
        assert r.get("rc") == 0, r
    assert seen == [["mesh"]]
    want = _cold_ref(tmp_path, ["--many2many", tfa, "-r", qfa],
                     tmp_path / "ref.tsv")
    assert (tmp_path / "m.tsv").read_bytes() == want


# ---------------------------------------------------------------------------
# the build directory and the refusals
# ---------------------------------------------------------------------------
def test_serve_compile_cache_dir_is_the_jobs_build_dir(tmp_path,
                                                       monkeypatch):
    """``serve --compile-cache-dir`` is every job's build directory: a
    job's own flag leaves it as it is, with a warning, so no job moves
    the directory under another; a directory that cannot be made ends
    ``serve`` with a message."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    paf, fa = _corpus(tmp_path, n=4)
    seen = []
    real_run = run

    def runner(argv, **kw):
        rc = real_run(argv, **kw)
        seen.append(_build.BUILD_DIR)
        return rc

    with _daemon(compile_cache_dir=str(tmp_path / "bd"),
                 runner=runner) as h:
        tails = []
        for extra in ([], [f"--compile-cache-dir={tmp_path / 'own'}"]):
            r = _submit_wait(h.sock, [paf, "-r", fa, "-o",
                                      str(tmp_path / "b.dfa"),
                                      "--device=cpu"] + extra)
            assert r.get("rc") == 0, r
            tails.append(r.get("stderr_tail", ""))
    assert seen == [str(tmp_path / "bd")] * 2
    assert "--compile-cache-dir" not in tails[0]
    assert f"--compile-cache-dir={tmp_path / 'own'} not used" in tails[1]
    assert not (tmp_path / "own").exists()
    (tmp_path / "file").write_text("x")
    err = io.StringIO()
    assert run(["serve", f"--socket={tmp_path / 's.sock'}",
                f"--compile-cache-dir={tmp_path}/file/d"],
               stderr=err) == 1
    assert "--compile-cache-dir" in err.getvalue() \
        and "unusable" in err.getvalue()
    assert not (tmp_path / "s.sock").exists()


def test_refusal_tables_name_their_slices(tmp_path, monkeypatch):
    """No refusal of a later slice is left: no subcommand, and no
    option of ``route`` (``--standby-of`` and ``--scale-policy`` run
    since slice A11b).  What the cache's, the edge's, the
    self-monitoring and the router's slices brought is refused nowhere:
    the cache options on the CLI and on ``serve``, ``cache-probe``, a
    served ``--many2many``, delta streams, the edge's options,
    ``--m2m-stream``, ``top``, ``health``, ``logs``, ``route`` and
    ``serve --canary-interval/--slo-rules``."""
    from pwasm_tpu_torch import cli, native
    from pwasm_tpu_torch.fleet import router
    from pwasm_tpu_torch.ops import _build
    from pwasm_tpu_torch.service import daemon
    from pwasm_tpu_torch.stream import multicds
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    assert cli._LATER_CMDS == {}
    assert not hasattr(router, "_LATER_ROUTE")
    for name in ("_LATER_SERVE", "_LATER_CMDS", "DELTA_STREAMS_LATER"):
        assert not hasattr(daemon, name), name
    for name in ("_LATER_OPTS", "later_option"):
        assert not hasattr(cli, name), name
    assert not hasattr(multicds, "_LATER")
    assert set(cli._SERVICE_CMDS) - set(cli._LATER_CMDS) == {
        "serve", "submit", "svc-stats", "metrics", "stream", "inspect",
        "top", "trace-merge", "health", "logs", "cache-probe", "route"}
    paf, fa = _corpus(tmp_path, n=4)
    qs, _ts, tfa = _m2m_files(tmp_path, nq=1, nt=2)
    qfa = _write_fa(tmp_path, "q1.fa", qs)
    with _daemon(result_cache=str(tmp_path / "cd"),
                 compile_cache_dir=str(tmp_path / "bd"),
                 cache_prefetch=4) as h:
        with ServiceClient(h.sock) as c:
            assert c.cache_probe("0" * 64).get("ok")
            assert c.health()["health"]["rules"] == 9
        for argv in ([paf, "-r", fa, "-o", str(tmp_path / "a.dfa"),
                      f"--result-cache={tmp_path / 'own'}",
                      "--result-cache-max-bytes=99999999",
                      f"--compile-cache-dir={tmp_path / 'bd'}"],
                     ["--many2many", tfa, "-r", qfa, "-o",
                      str(tmp_path / "a.tsv")],
                     ["--m2m-stream", tfa, "-r", qfa, "-o",
                      str(tmp_path / "b.tsv")]):
            assert _submit_wait(h.sock, argv + ["--device=cpu"]) \
                .get("rc") == 0
