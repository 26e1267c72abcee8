"""The port's delta streams against the reference's daemon, on the CPU.

A ``stream`` frame with ``"delta": true`` is held against the result
cache's per-line digest columns until it can be classified: a stream
whose records extend a cached run is served that run's report and
queued as a ``--resume`` of the tail, any other goes cold.  No test of
the reference sends such a frame, so each case here drives the same
frame sequence through the port's daemon and the reference's daemon
(``--slo-rules=off``), both with ``--device=cpu`` jobs, and holds them
to each other: every answer frame's ``ok``/``error``/``buffered``/
``records``, the job's end state, the journal's record kinds, the
``cache_delta`` stats (the job's and svc-stats'), and the report bytes,
which must also equal each package's cold run of the whole stream.

While a case sends its frames, each daemon's runner waits on a gate,
so a queued job consumes nothing and ``buffered`` is deterministic.
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

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu.service.daemon import Daemon as RefDaemon
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.service.cache import line_digest
from pwasm_tpu_torch.service.client import ServiceClient, wait_for_socket
from pwasm_tpu_torch.service.daemon import Daemon
from pwasm_tpu_torch.stream.pafstream import (MAX_RECORD_BYTES,
                                              LineAssembler)

from test_torch_cache_serve import _lines

N_SEED = 20          # records of the cached run a case extends
N_ALL = 24           # records of the whole corpus
SIDES = (("port", Daemon, run, {}),
         ("ref", RefDaemon, ref_run, {"slo_rules": "off"}))


@pytest.fixture(scope="module")
def corpus():
    q, lines = _lines(N_ALL, 120, 3)
    d = tempfile.mkdtemp(prefix="pwdelta")
    fa = os.path.join(d, "q.fa")
    write_fasta(fa, [("q", q.encode())])
    yield SimpleNamespace(lines=[ln + "\n" for ln in lines], fa=fa, dir=d,
                          colds={})
    shutil.rmtree(d, ignore_errors=True)


def _text(lines):
    return "".join(lines)


def _chunks(text, size=700):
    """Frames that split records mid-line."""
    return [text[i:i + size] for i in range(0, len(text), size)]


def _cold(corpus, side, lines):
    """``side``'s cold run of ``lines`` as a file (memoized)."""
    key = (side, _text(lines))
    if key not in corpus.colds:
        runner = run if side == "port" else ref_run
        d = tempfile.mkdtemp(dir=corpus.dir)
        paf = os.path.join(d, "in.paf")
        open(paf, "w").write(_text(lines))
        out = os.path.join(d, "cold.dfa")
        assert runner([paf, "-r", corpus.fa, "-o", out, "--device=cpu"],
                      stdout=io.StringIO(), stderr=io.StringIO()) == 0
        corpus.colds[key] = open(out, "rb").read()
    return corpus.colds[key]


@contextmanager
def _daemon(name, cls, runner, extra, tmp, **kw):
    sockdir = tempfile.mkdtemp(prefix="pwds")
    sock = os.path.join(sockdir, "s.sock")
    gate = threading.Event()
    gate.set()

    def gated(argv, **k):
        assert gate.wait(60)
        return runner(argv, **k)

    err = io.StringIO()
    dm = cls(sock, stderr=err, runner=gated,
             result_cache=os.path.join(tmp, name + "_rc"), **extra, **kw)
    journal = dm.journal
    journal.unlink = journal.close      # keep it for the comparison
    rcbox: list = []
    t = threading.Thread(target=lambda: rcbox.append(dm.serve()),
                         daemon=True)
    t.start()
    assert wait_for_socket(sock, 15), err.getvalue()
    try:
        yield SimpleNamespace(name=name, daemon=dm, sock=sock, gate=gate,
                              rc=rcbox, err=err, thread=t, dir=tmp,
                              journal=journal.path)
    finally:
        gate.set()
        if not dm.drain.requested:
            dm.drain.request("test teardown")
        t.join(20)
        shutil.rmtree(sockdir, ignore_errors=True)


def _argv(h, tag):
    return ["-r", h.corpus.fa, "-o", os.path.join(h.dir, f"{h.name}_{tag}"
                                                  ".dfa"), "--device=cpu"]


def _answer(r):
    return (r.get("ok"), r.get("error"), r.get("buffered"),
            r.get("records"))


def _kinds(h, job_id):
    recs = [json.loads(ln) for ln in open(h.journal)]
    return [r["rec"] for r in recs if r.get("job_id") == job_id]


def _verdict(h, c, job_id):
    res = c.result(job_id, timeout=120)
    assert res.get("ok"), res
    st = res.get("stats") or {}
    cache = c.stats()["stats"]["cache"]
    return {"state": res["job"]["state"], "rc": res.get("rc"),
            "cache_delta": (st.get("cache_delta"),
                            st.get("cache_records_served"),
                            st.get("cache_records_total")),
            "svc_cache": {k: cache[k] for k in (
                "insertions", "delta_hits", "delta_records_served",
                "delta_records_total")},
            "journal": _kinds(h, job_id)}


def _seed_stream(h, lines, tag="seed"):
    with ServiceClient(h.sock) as c:
        r = c.stream(_argv(h, tag), _chunks(_text(lines)),
                     cwd=h.dir, delta=True)
        assert r.get("ok"), r
        v = _verdict(h, c, r["job_id"])
    assert v["state"] == "done", v
    return v


def _seed_file(h, lines, tag="seedf"):
    paf = os.path.join(h.dir, f"{h.name}_{tag}.paf")
    open(paf, "w").write(_text(lines))
    with ServiceClient(h.sock) as c:
        r = c.submit([paf] + _argv(h, tag), cwd=h.dir)
        assert r.get("ok"), r
        v = _verdict(h, c, r["job_id"])
    assert v["state"] == "done", v
    return v


class _Frames:
    """One delta stream driven frame by frame, each answer kept."""

    def __init__(self, h, c, tag="delta"):
        self.h, self.c, self.tag = h, c, tag
        self.asm = LineAssembler()
        self.answers = []
        r = c.stream_open(_argv(h, tag), cwd=h.dir, delta=True)
        assert r.get("ok"), r
        self.job_id = r["job_id"]
        self.answers.append(("open", r.get("ok"), r.get("error")))

    def data(self, chunk, digests="mirror"):
        if digests == "mirror":
            # what ServiceClient.stream sends: the lines this frame
            # completes, advancing the mirror only once it is accepted
            digs = [line_digest(ln) for ln in self.asm.preview(chunk)]
        else:
            digs = digests
        r = self.c.stream_data(self.job_id, chunk, digests=digs)
        if r.get("ok"):
            self.asm.push(chunk)
        self.answers.append(("data",) + _answer(r))
        return r

    def end(self):
        r = self.c.stream_end(self.job_id)
        self.answers.append(("end",) + _answer(r))
        return r

    def state(self):
        return self.h.daemon.jobs[self.job_id].state


def _report(h, tag="delta"):
    return open(os.path.join(h.dir, f"{h.name}_{tag}.dfa"), "rb").read()


# ---------------------------------------------------------------------------
# the cases: each returns its observations; the report's lines (or None)
# ---------------------------------------------------------------------------
def case_no_candidate(h, L):
    """An empty cache: resolved at open, run cold, inserted as a
    delta-indexed entry."""
    with ServiceClient(h.sock) as c:
        h.gate.clear()
        f = _Frames(h, c)
        obs = {"mode": h.daemon.jobs[f.job_id].dstate["mode"]}
        for ch in _chunks(_text(L)):
            f.data(ch)
        f.end()
        h.gate.set()
        obs.update(_verdict(h, c, f.job_id))
        fam = h.daemon.jobs[f.job_id].dstate["family"]
        obs["index"] = sorted(nl for nl, _dx in
                              h.daemon.cache.delta_index(fam))
    obs["answers"] = f.answers
    return obs, L


def case_strict_prefix(h, L):
    """A cached 20-record run; a 24-record stream promotes mid-stream
    once its column passes the entry's."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    with ServiceClient(h.sock) as c:
        h.gate.clear()
        f = _Frames(h, c)
        modes = []
        for ch in _chunks(_text(L)):
            f.data(ch)
            modes.append(h.daemon.jobs[f.job_id].dstate["mode"])
        f.end()
        obs["modes"] = modes
        obs["argv_resume"] = "--resume" in h.daemon.jobs[f.job_id].argv
        h.gate.set()
        obs.update(_verdict(h, c, f.job_id))
    obs["answers"] = f.answers
    assert obs["cache_delta"] == (True, N_SEED - 1, N_ALL), obs
    return obs, L


def case_equal_at_end(h, L):
    """The same 20 records again: held to the end, then served by the
    exact-length lookup that only stream-end allows."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    with ServiceClient(h.sock) as c:
        h.gate.clear()
        f = _Frames(h, c)
        for ch in _chunks(_text(L[:N_SEED])):
            f.data(ch)
        obs["held_before_end"] = f.state()
        f.end()
        h.gate.set()
        obs.update(_verdict(h, c, f.job_id))
    obs["answers"] = f.answers
    assert obs["cache_delta"] == (True, N_SEED - 1, N_SEED), obs
    return obs, L[:N_SEED]


def case_divergent(h, L):
    """The fifth record differs: the stream goes cold there."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    grown = list(L)
    grown[4] = L[N_ALL - 1]
    with ServiceClient(h.sock) as c:
        h.gate.clear()
        f = _Frames(h, c)
        modes = []
        for ln in grown:
            f.data(ln)
            modes.append(h.daemon.jobs[f.job_id].dstate["mode"])
        f.end()
        obs["modes"] = modes
        h.gate.set()
        obs.update(_verdict(h, c, f.job_id))
    obs["answers"] = f.answers
    assert obs["modes"][:4] == ["holding"] * 4
    assert obs["modes"][4] == "resolved"
    assert obs["cache_delta"][0] is None, obs
    return obs, grown


def case_past_cap(h, L):
    """``--stream-buffer=8``: a stream still matching its candidate
    is parked up to eight records, then goes cold."""
    obs = {"seed": _seed_file(h, L[:N_SEED])}
    with ServiceClient(h.sock) as c:
        h.gate.clear()
        f = _Frames(h, c)
        f.data(_text(L[:4]))
        obs["held"] = h.daemon.jobs[f.job_id].dstate["mode"]
        f.data(_text(L[4:9]))
        obs["after"] = h.daemon.jobs[f.job_id].dstate["mode"]
        f.end()
        h.gate.set()
        obs.update(_verdict(h, c, f.job_id))
    obs["answers"] = f.answers
    assert (obs["held"], obs["after"]) == ("holding", "resolved")
    return obs, L[:9]


def case_bad_digests(h, L):
    """A frame whose advisory digests disagree answers bad_request and
    parks nothing; its resend with the right digests is held."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    with ServiceClient(h.sock) as c:
        h.gate.clear()
        f = _Frames(h, c)
        r = f.data(_text(L[:3]), digests=["0" * 16] * 3)
        obs["detail"] = r.get("detail")
        obs["parked"] = len(h.daemon.jobs[f.job_id].dstate["held"])
        f.data(_text(L[:3]))
        for ch in _chunks(_text(L[3:])):
            f.data(ch)
        f.end()
        h.gate.set()
        obs.update(_verdict(h, c, f.job_id))
    obs["answers"] = f.answers
    assert obs["parked"] == 0 and f.answers[1][2] == "bad_request"
    return obs, L


def case_oversized_record(h, L):
    """An unterminated record past MAX_RECORD_BYTES while held answers
    bad_request; the stream then goes on."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    with ServiceClient(h.sock) as c:
        h.gate.clear()
        f = _Frames(h, c)
        f.data(_text(L[:2]))
        r = f.data("A" * (MAX_RECORD_BYTES + 1))
        obs["detail"] = r.get("detail")
        obs["mode"] = h.daemon.jobs[f.job_id].dstate["mode"]
        for ch in _chunks(_text(L[2:])):
            f.data(ch)
        f.end()
        h.gate.set()
        obs.update(_verdict(h, c, f.job_id))
    obs["answers"] = f.answers
    assert f.answers[2][2] == "bad_request" and obs["mode"] == "holding"
    return obs, L


def case_cancel_held(h, L):
    """A cancel while held retires the stream at once: it never
    queued, never ran."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    with ServiceClient(h.sock) as c:
        f = _Frames(h, c)
        f.data(_text(L[:5]))
        r = c.cancel(f.job_id)
        obs["cancel"] = (r.get("ok"), r.get("state"), r.get("was"))
        r = c.stream_data(f.job_id, _text(L[5:7]))
        obs["after"] = (r.get("ok"), r.get("error"))
        obs.update(_verdict(h, c, f.job_id))
    obs["answers"] = f.answers
    assert obs["cancel"] == (True, "cancelled", "held"), obs
    return obs, None


def case_drain_held(h, L):
    """A drain while held preempts the stream, and the daemon exits
    75."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    with ServiceClient(h.sock) as c:
        f = _Frames(h, c)
        f.data(_text(L[:5]))
        obs["drain"] = c.drain().get("ok")
        obs.update(_verdict(h, c, f.job_id))
    h.thread.join(20)
    obs["serve_rc"] = h.rc
    obs["answers"] = f.answers
    assert obs["state"] == "preempted" and obs["serve_rc"] == [75], obs
    return obs, None


def _wait_state(h, job_id, state, budget_s=60.0):
    """Wait until the daemon holds ``job_id`` in ``state``."""
    deadline = time.monotonic() + budget_s
    while h.daemon.jobs[job_id].state != state:
        assert time.monotonic() < deadline, \
            (job_id, h.daemon.jobs[job_id].state, state)
        time.sleep(0.01)


def case_queue_full_promote(h, L):
    """``--max-queue=1``, one job running and one queued: the frame
    that would promote answers queue_full and is unwound (no --resume,
    no delta); after the queue empties its verbatim resend promotes.
    The case waits on the busy jobs' states, and holds the gate while
    it sends the frames, as every case does."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    text = _text(L)
    cut = len(_text(L[:N_SEED + 1])) + 10   # past the entry's column
    first, second = text[:cut], text[cut:]
    with ServiceClient(h.sock) as c:
        h.gate.clear()
        busy = []
        for i, state in enumerate(("running", "queued")):
            busy.append(c.submit([os.path.join(h.dir,
                                               f"{h.name}_seedq.paf")]
                                 + _argv(h, f"busy{i}"), cwd=h.dir))
            assert busy[-1].get("ok"), busy
            # the first runs (held at the gate), the second queues
            _wait_state(h, busy[-1]["job_id"], state)
        assert h.daemon.queue.depth() == 1
        f = _Frames(h, c)
        r = f.data(first)
        obs["retry_hint"] = r.get("retry_after_s", 0) > 0
        job = h.daemon.jobs[f.job_id]
        obs["unwound"] = ("--resume" in job.argv, job.delta,
                          job.dstate["mode"])
        h.gate.set()
        for b in busy:
            assert c.result(b["job_id"], timeout=120).get("rc") == 0
        # the gate again while the frames go: the promoted job must not
        # consume its feed before the answers report ``buffered``
        h.gate.clear()
        f.data(first)
        f.data(second)
        f.end()
        h.gate.set()
        obs.update(_verdict(h, c, f.job_id))
    obs["answers"] = f.answers
    assert f.answers[1][2] == "queue_full", f.answers
    assert obs["unwound"] == (False, None, "holding"), obs
    assert obs["cache_delta"] == (True, N_SEED - 1, N_ALL), obs
    return obs, L


def case_file_extends_stream(h, L):
    """A file job extends a stream-inserted entry (one family)."""
    obs = {"seed": _seed_stream(h, L[:N_SEED])}
    obs["file"] = _seed_file(h, L, tag="delta")
    assert obs["file"]["cache_delta"] == (True, N_SEED - 1, N_ALL), obs
    return obs, L


def case_stream_extends_file(h, L):
    """A delta stream extends a file-inserted entry (one family)."""
    obs = {"seed": _seed_file(h, L[:N_SEED])}
    with ServiceClient(h.sock) as c:
        r = c.stream(_argv(h, "delta"), _chunks(_text(L)), cwd=h.dir,
                     delta=True)
        assert r.get("ok"), r
        obs.update(_verdict(h, c, r["job_id"]))
    assert obs["cache_delta"] == (True, N_SEED - 1, N_ALL), obs
    return obs, L


CASES = {
    "no_candidate": (case_no_candidate, {}),
    "strict_prefix_mid_stream": (case_strict_prefix, {}),
    "equal_length_at_end": (case_equal_at_end, {}),
    "divergent_line_goes_cold": (case_divergent, {}),
    "held_past_cap_goes_cold": (case_past_cap, {"stream_buffer": 8}),
    "disagreeing_digests": (case_bad_digests, {}),
    "oversized_record_while_held": (case_oversized_record, {}),
    "cancel_while_held": (case_cancel_held, {}),
    "drain_while_held": (case_drain_held, {}),
    "queue_full_during_promote": (case_queue_full_promote,
                                  {"max_queue": 1}),
    "file_extends_stream_entry": (case_file_extends_stream, {}),
    "stream_extends_file_entry": (case_stream_extends_file, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_delta_stream_matches_reference(case, corpus, tmp_path):
    fn, kw = CASES[case]
    seen = {}
    for name, cls, runner, extra in SIDES:
        side = tmp_path / name
        side.mkdir()
        # the queue_full case's busy jobs read a file of their own
        open(side / f"{name}_seedq.paf", "w").write(
            _text(corpus.lines[:4]))
        with _daemon(name, cls, runner, extra, str(side), **kw) as h:
            h.corpus = corpus
            obs, lines = fn(h, corpus.lines)
            report = _report(h) if lines is not None else None
        seen[name] = obs
        if lines is not None:
            assert report == _cold(corpus, name, lines), (case, name)
    assert seen["port"] == seen["ref"]
    if seen["port"].get("answers") is not None:
        assert seen["port"]["answers"][0] == ("open", True, None)


def test_held_stream_is_not_reaped_by_stream_idle_s(corpus, tmp_path):
    """``--stream-idle-s`` runs on the feed's clock, which ticks only
    while a worker reads the feed: a held stream has no worker, so a
    client that goes away leaves it queued until a cancel or a drain
    (the reference does the same)."""
    seen = {}
    for name, cls, runner, extra in SIDES:
        side = tmp_path / name
        side.mkdir()
        with _daemon(name, cls, runner, extra, str(side),
                     stream_idle_s=0.3) as h:
            h.corpus = corpus
            _seed_stream(h, corpus.lines[:N_SEED])
            with ServiceClient(h.sock) as c:
                f = _Frames(h, c)
                f.data(_text(corpus.lines[:3]))
            time.sleep(1.5)
            with ServiceClient(h.sock) as c:
                st = c.status(f.job_id)["job"]["state"]
                r = c.cancel(f.job_id)
            seen[name] = (st, r.get("was"), f.answers)
    assert seen["port"] == seen["ref"]
    assert seen["port"][:2] == ("queued", "held")
