"""The port's job journal (``pwasm_tpu_torch/service/journal.py``) and
the daemon's replay of it, against the JAX package's.

A selection of ``tests/test_journal.py``, one case a contract: the
torn last record never happened; a replay after a hard kill re-queues
the queued jobs, re-admits the running ones as ``--resume``
continuations and restores the finished and spooled results (their
CRC checked); a journal the reference's code wrote replays in the
port; and the kill -9 drill against a ``serve`` process, whose
recovered reports equal the cold runs of both packages.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from pwasm_tpu.service.journal import JobJournal as RefJournal
from pwasm_tpu.service.journal import fold_records as ref_fold
from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
from pwasm_tpu_torch.service.client import ServiceClient, wait_for_socket
from pwasm_tpu_torch.service.journal import JobJournal, fold_records
from pwasm_tpu_torch.utils.fsio import payload_crc

from test_torch_service import (SLOW, _cold, _corpus, _daemon, _job_args,
                                _serve_env)


def _stub_runner(log):
    """A runner standing in for ``cli.run``: records each argv and
    writes the injected ``--stats`` sink."""
    def runner(argv, stdout=None, stderr=None, warm=None, **kw):
        log.append(list(argv))
        sp = next((a.split("=", 1)[1] for a in argv
                   if a.startswith("--stats=")), None)
        if sp:
            with open(sp, "w") as f:
                json.dump({"stats_version": 1, "alignments": 1}, f)
        return 0
    return runner


def _journal_file(path, recs, torn=None):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        if torn is not None:
            f.write(torn)                       # no newline: torn
    return str(path)


def _spool(path, job_id, crc_ok=True):
    payload = {"version": 1, "job_id": job_id, "state": "done", "rc": 0,
               "trace_id": "t.1", "flight": None,
               "stats": {"alignments": 7}, "stderr_tail": "tail"}
    payload["crc"] = payload_crc(payload) + (0 if crc_ok else 1)
    text = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    with open(path, "w") as f:
        f.write(text)
    return {"path": str(path), "bytes": len(text)}


def test_torn_last_record_never_happened(tmp_path):
    """Whole lines count; a torn last line and garbage lines are
    skipped; records of an id with no admit fold away — in both
    packages' folds."""
    jp = tmp_path / "j.journal"
    j = JobJournal(str(jp))
    j.open()
    assert j.append("admit", job_id="job-0001", argv=["a", "-o", "x"])
    assert j.append("start", job_id="job-0001", lane=0)
    assert j.append("finish", job_id="job-0002", state="done", rc=0)
    j.close()
    with open(jp, "a") as f:
        f.write("not json\n")
        f.write('{"v":1,"rec":"finish","job_id":"job-0001","sta')
    recs = j.replay()
    assert [r["rec"] for r in recs] == ["admit", "start", "finish"]
    folded = fold_records(recs)
    assert set(folded) == {"job-0001"}
    row = folded["job-0001"]
    assert row["start"]["lane"] == 0 and row["finish"] is None
    assert folded == ref_fold(RefJournal(str(jp)).replay())


def test_replay_requeues_resumes_restores(tmp_path):
    """After a hard kill: the queued job re-runs as submitted, the
    running one as a --resume continuation on its lane, the finished
    one restores without running, a spooled result restores from its
    file with its CRC checked (a rotted spool is reported, never
    served), and new ids continue past the recovered."""
    spool_ok = _spool(tmp_path / "ok.result.json", "job-0004")
    spool_bad = _spool(tmp_path / "bad.result.json", "job-0005",
                       crc_ok=False)
    recs = [
        {"v": 1, "rec": "admit", "job_id": "job-0001",
         "argv": ["a.paf", "-o", "a.dfa"], "client": "uid:7", "t": 1.0},
        {"v": 1, "rec": "admit", "job_id": "job-0002",
         "argv": ["b.paf", "-o", "b.dfa"], "client": "uid:8", "t": 2.0},
        {"v": 1, "rec": "start", "job_id": "job-0002", "lane": 0},
        {"v": 1, "rec": "admit", "job_id": "job-0003",
         "argv": ["c.paf", "-o", "c.dfa"], "client": "uid:7", "t": 3.0},
        {"v": 1, "rec": "finish", "job_id": "job-0003", "state": "done",
         "rc": 0, "t": 3.5}]
    for jid, sp in (("job-0004", spool_ok), ("job-0005", spool_bad)):
        recs += [{"v": 1, "rec": "admit", "job_id": jid,
                  "argv": ["d.paf", "-o", "d.dfa"], "t": 4.0},
                 {"v": 1, "rec": "finish", "job_id": jid,
                  "state": "done", "rc": 0, "spool": sp, "t": 4.5}]
    jp = _journal_file(tmp_path / "crash.journal", recs,
                       torn='{"v":1,"rec":"admit","job_id":"job-9999"')
    ran: list = []
    with _daemon(runner=_stub_runner(ran), journal_path=jp) as h:
        with ServiceClient(h.sock) as c:
            assert c.result("job-0001", timeout=30)["rc"] == 0
            r2 = c.result("job-0002", timeout=30)
            assert r2["rc"] == 0 and "recovered" in r2["job"]["detail"]
            r3 = c.result("job-0003", timeout=30)
            assert r3["job"]["state"] == "done" and r3["rc"] == 0
            r4 = c.result("job-0004", timeout=30)
            assert r4["stats"] == {"alignments": 7}
            assert r4["stderr_tail"] == "tail"
            r5 = c.result("job-0005", timeout=30)
            assert r5["stats"] is None and "CRC" in r5["spool_error"]
            assert c.status("job-9999")["error"] == "unknown_job"
            st = c.stats()["stats"]
            nxt = c.submit(["e.paf", "-o", str(tmp_path / "e.dfa")],
                           cwd=str(tmp_path))
            assert nxt["job_id"] == "job-0006"
            assert c.result("job-0006", timeout=30)["rc"] == 0
    assert st["journal"]["replays"] == 1
    assert st["journal"]["jobs_recovered"] == 2
    assert st["spool"]["bytes"] == spool_ok["bytes"] + spool_bad["bytes"]
    heads = [a[0] for a in ran]
    assert heads[:2] == ["a.paf", "b.paf"] and "c.paf" not in heads
    assert "--resume" in ran[1] and "--resume" not in ran[0]


def test_reference_written_journal_replays_in_the_port(tmp_path):
    """The journal's line format is the reference's: records written by
    the reference's ``JobJournal`` replay in the port's daemon."""
    jp = str(tmp_path / "ref.journal")
    rj = RefJournal(jp)
    rj.open()
    rj.append("admit", job_id="job-0007", argv=["r.paf", "-o", "r.dfa"],
              client="", priority="", trace_id="ref.1", t=1.0)
    rj.append("start", job_id="job-0007", lane=0)
    rj.close()
    ran: list = []
    with _daemon(runner=_stub_runner(ran), journal_path=jp) as h:
        with ServiceClient(h.sock) as c:
            res = c.result("job-0007", timeout=30)
    assert res["rc"] == 0 and res["job"]["trace_id"] == "ref.1"
    assert ran[0][0] == "r.paf" and "--resume" in ran[0]


def test_kill9_drill_replay_recovers_byte_identical(tmp_path):
    """kill -9 a live ``serve`` mid-job (after its first durable
    checkpoint) with a second job queued; a fresh daemon on the same
    socket replays the journal, resumes the interrupted job from its
    checkpoint and re-runs the queued one: both reports equal both
    packages' cold runs."""
    paf, fa = _corpus(tmp_path)
    want_a = _cold(tmp_path, "colda", paf, fa, [SLOW])
    want_b = _cold(tmp_path, "coldb", paf, fa)
    sockdir = tempfile.mkdtemp(prefix="pwkill9")
    sock = os.path.join(sockdir, "s")

    def spawn():
        return subprocess.Popen(
            [sys.executable, "-m", "pwasm_tpu_torch", "serve",
             f"--socket={sock}"], env=_serve_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    sp = spawn()
    sp2 = None
    try:
        assert wait_for_socket(sock, 60)
        with ServiceClient(sock) as c:
            ja = c.submit(_job_args(tmp_path, "a", paf, fa, [SLOW]))
            jb = c.submit(_job_args(tmp_path, "b", paf, fa))
            assert ja.get("ok") and jb.get("ok"), (ja, jb)
            ck = str(tmp_path / "a.dfa.ckpt")
            deadline = time.monotonic() + 60
            while not (c.status(ja["job_id"])["job"]["state"]
                       == "running" and os.path.exists(ck)):
                assert time.monotonic() < deadline
                time.sleep(0.02)
        sp.kill()
        sp.wait(timeout=30)
        assert os.path.exists(sock + ".journal")
        sp2 = spawn()
        assert wait_for_socket(sock, 60)
        with ServiceClient(sock) as c:
            ra = c.result(ja["job_id"], timeout=240)
            rb = c.result(jb["job_id"], timeout=240)
            st = c.stats()["stats"]
            c.drain()
        assert ra.get("rc") == 0 and rb.get("rc") == 0, (ra, rb)
        assert "recovered" in ra["job"]["detail"]
        assert st["journal"]["jobs_recovered"] == 2
        assert (tmp_path / "a.dfa").read_bytes() == want_a
        assert (tmp_path / "b.dfa").read_bytes() == want_b
        assert sp2.wait(timeout=120) == EXIT_PREEMPTED
        assert not os.path.exists(sock + ".journal")
    finally:
        for p in (sp, sp2):
            if p is not None:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                p.stderr.close()
        shutil.rmtree(sockdir, ignore_errors=True)


def test_clean_drain_retires_the_journal(tmp_path):
    """A drained daemon told every client its verdict: it retires its
    journal, and a restart on it has nothing to replay."""
    jp = str(tmp_path / "d.journal")
    ran: list = []
    with _daemon(runner=_stub_runner(ran), journal_path=jp) as h:
        with ServiceClient(h.sock) as c:
            sub = c.submit(["x.paf", "-o", str(tmp_path / "x.dfa")],
                           cwd=str(tmp_path))
            assert c.result(sub["job_id"], timeout=30)["rc"] == 0
            assert os.path.exists(jp)
            assert c.drain()["ok"]
        h.thread.join(30)
        assert h.rc == [EXIT_PREEMPTED]
    assert not os.path.exists(jp)
    with _daemon(runner=_stub_runner(ran), journal_path=jp) as h:
        with ServiceClient(h.sock) as c:
            st = c.stats()["stats"]
    assert st["journal"]["replays"] == 0 and len(ran) == 1
