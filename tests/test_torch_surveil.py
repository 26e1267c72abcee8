"""The port's ``--m2m-stream`` and ``surveil/`` against the JAX
package's, on the CPU.

- ``surveil/records.py`` and ``surveil/partition.py``: the record
  assembler over random byte splits, the scatter bookkeeping over
  random histories, the fragment merge and the argv rewrite give the
  reference's answers, errors included.
- A cold ``--m2m-stream --device=cpu`` equals the reference's in its
  outputs, ``-s``, rc and ``--stats`` ``m2m`` block, and the port's
  ``--many2many`` over the same targets byte for byte.
- A session served over the stream verbs equals the reference daemon's
  session and the cold run; svc-stats, ``top`` and the ``pwasm_m2m_*``
  families count its flow.
- With ``--result-cache``, arrivals splice from the section cache (only
  the new pairs dispatch), ``--many2many`` and ``--m2m-stream`` hit each
  other's sections both ways, and ``--deadline-s`` preempts with exit
  75, after which a resubmission completes byte-identical.
- Nothing falls back: ``--device=cuda`` without CUDA exits 1 once a
  pair is owed.

The router's scatter cases of ``tests/test_surveil.py`` are in
``test_torch_scatter.py``.
"""

import io
import json
import os
import random
import shutil
import tempfile
import threading
from contextlib import contextmanager
from types import SimpleNamespace

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.surveil import partition as ref_partition
from pwasm_tpu.surveil import records as ref_records
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
from pwasm_tpu_torch.service.client import ServiceClient, wait_for_socket
from pwasm_tpu_torch.service.daemon import Daemon
from pwasm_tpu_torch.service.top import render
from pwasm_tpu_torch.surveil import partition, records
from pwasm_tpu_torch.surveil.session import MAX_ARRIVAL_BATCH


# ---------------------------------------------------------------------------
# corpus helpers
# ---------------------------------------------------------------------------
def _seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _corpus(tmp_path, nq=2, nt=7, seed=11):
    rng = random.Random(seed)
    qs = [(f"cds{i}", _seq(rng, 50 + 10 * i)) for i in range(nq)]
    ts = [(f"asm{i}", _seq(rng, 120 + 15 * i)) for i in range(nt)]
    qfa = str(tmp_path / "q.fa")
    with open(qfa, "w") as f:
        for n, s in qs:
            f.write(f">{n}\n{s}\n")
    return qfa, [f">{n}\n{s}\n" for n, s in ts]


def _write_targets(tmp_path, recs, name="t.fa"):
    tfa = str(tmp_path / name)
    with open(tfa, "w") as f:
        f.write("".join(recs))
    return tfa


def _cold(tmp_path, qfa, tfa, tag, extra=(), who="port", job="--m2m-stream"):
    """One cold run: (rc, -o bytes, -s bytes, --stats JSON, stderr)."""
    o, s, st = (str(tmp_path / f"{tag}.{ext}")
                for ext in ("tsv", "sum", "json"))
    err = io.StringIO()
    fn = run if who == "port" else ref_run
    rc = fn([job, tfa, "-r", qfa, "-o", o, "-s", s, f"--stats={st}",
             "--device=cpu", *extra], stderr=err)

    def read(p, mode="rb"):
        if not os.path.exists(p):
            return None
        with open(p, mode) as f:
            return f.read() if mode == "rb" else json.load(f)
    return SimpleNamespace(rc=rc, o=read(o), s=read(s), stats=read(st, "r"),
                           err=err.getvalue())


# ---------------------------------------------------------------------------
# records and partition
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_fasta_assembler_equals_the_reference_over_random_splits(seed):
    rng = random.Random(seed)
    recs = []
    for k in range(rng.randrange(1, 9)):
        seq = _seq(rng, rng.randrange(1, 90))
        lines = [seq[i:i + rng.randrange(5, 40)]
                 for i in range(0, len(seq), 30)]
        eol = rng.choice(("\n", "\r\n", "\r"))
        recs.append(f">t{k} d{k}{eol}" + eol.join(lines) + eol
                    + rng.choice(("", eol, f"  {eol}")))
    text = "".join(recs)
    if rng.random() < 0.5:
        text = text.rstrip("\r\n")       # no newline after the last
    cuts = sorted(rng.sample(range(1, len(text)), min(len(text) - 1,
                                                      rng.randrange(12))))
    chunks = [text[a:b] for a, b in zip([0] + cuts, cuts + [len(text)])]
    got = []
    for mod in (records, ref_records):
        asm = mod.FastaAssembler()
        out = [r for ch in chunks for r in asm.feed(ch)]
        out += asm.finish()
        got.append((out, asm.records_out, asm.pending_lines))
    assert got[0] == got[1]
    assert got[0][0] and all(records.parse_record(r)
                             == ref_records.parse_record(r)
                             for r in got[0][0])
    # one chunk gives the same records as any split
    asm = records.FastaAssembler()
    assert asm.feed(text) + asm.finish() == got[0][0]


@pytest.mark.parametrize("text", [
    "no header\nACGT\n", ">\nACGT\n", "", ">  \nAC\n", "> x y\nA C\n\nG\n"])
def test_parse_record_equals_the_reference(text):
    got = []
    for mod in (records, ref_records):
        try:
            got.append(mod.parse_record(text))
        except ValueError as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]


@pytest.mark.parametrize("seed", range(4))
def test_scatter_state_equals_the_reference_over_random_histories(seed):
    rng = random.Random(seed)
    sides = [partition.ScatterState(), ref_partition.ScatterState()]
    for _ in range(3):
        assert sides[0].add_sub() == sides[1].add_sub()
    for _ in range(60):
        op = rng.random()
        victim = rng.randrange(len(sides[0].orders))
        got = []
        for st in sides:
            try:
                if op < 0.7:
                    got.append(st.assign())
                elif op < 0.85 and st.live_subs():
                    dead = st.live_subs()[0]
                    order = st.kill(dead)
                    k = st.add_sub()
                    st.adopt(k, order)
                    got.append((dead, order, k))
                elif op < 0.9:
                    got.append(st.adopt(0, [99]))
                else:
                    got.append(st.kill(victim))
            except ValueError as e:
                got.append(("error", str(e)))
        assert got[0] == got[1]
        assert (sides[0].orders, sides[0].live, sides[0].nrec) \
            == (sides[1].orders, sides[1].live, sides[1].nrec)


@pytest.mark.parametrize("args", [
    ["--m2m-stream", "-r", "q.fa", "-o", "out.tsv", "-s", "out.sum",
     "--stats=x.json", "--band=16"],
    ["--m2m-stream", "-r", "q.fa", "--stats", "x.json", "-o", "o"],
    ["--m2m-stream", "--stats", "-o", "o", "-s"],
    ["-o", "only", "--stats", "--trace-json=t.json"]])
def test_rewrite_out_args_equals_the_reference(args):
    for kw in ({"o": "f.frag00", "s": "s.frag00"}, {"o": "f"}, {},
               {"o": "f", "strip": ("stats", "trace-json")}):
        assert partition.rewrite_out_args(list(args), **kw) \
            == ref_partition.rewrite_out_args(list(args), **kw)


FRAG0 = b">q1\t60\t3\nt0\t100\t7\nt2\t110\t.\nt4\t130\t9\n"
FRAG1 = b">q1\t60\t2\nt1\t105\t9\nt3\t120\t3\n"


@pytest.mark.parametrize("case", [
    ([FRAG0, FRAG1], [[0, 2, 4], [1, 3]], 5),
    ([FRAG0 + b">q2\t70\t3\nt0\t100\t.\nt2\t110\t.\nt4\t130\t.\n",
      FRAG1 + b">q2\t70\t2\nt1\t105\t.\nt3\t120\t.\n"],
     [[0, 2, 4], [1, 3]], 5),
    ([FRAG0, FRAG1], [[0, 2, 4], [1]], 5),
    ([FRAG0, FRAG1], [[0, 2, 4], [1, 3]], 6),
    ([FRAG0, FRAG1.replace(b">q1", b">qX")], [[0, 2, 4], [1, 3]], 5),
    ([FRAG0, b"t1\t105\t9\n"], [[0, 2, 4], [1]], 4),
    ([FRAG0, b">q1\t60\n"], [[0, 2, 4], []], 3),
    ([FRAG0], [[0, 2, 4], [1]], 5),
    ([FRAG0, FRAG1.replace(b"\t9\n", b"\t9\t1\n")], [[0, 2, 4], [1, 3]],
     5)])
def test_merge_fragments_equals_the_reference(case):
    frags, orders, total = case
    for summary in (False, True):
        got = []
        for mod in (partition, ref_partition):
            try:
                got.append(mod.merge_fragments(list(frags), orders, total,
                                               summary=summary))
            except ValueError as e:
                got.append(("error", str(e)))
        assert got[0] == got[1]


# ---------------------------------------------------------------------------
# cold runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [
    dict(nq=2, nt=7, seed=11, extra=()),
    dict(nq=3, nt=MAX_ARRIVAL_BATCH + 9, seed=5, extra=("--band=16",)),
    dict(nq=1, nt=3, seed=2, extra=("--band=4", "-v"))])
def test_cold_session_equals_the_reference_and_many2many(tmp_path, shape):
    qfa, recs = _corpus(tmp_path, shape["nq"], shape["nt"], shape["seed"])
    # wrapped lines and a blank line between records: the same records
    tfa = _write_targets(tmp_path, [r.replace("A", "A\n", 1) + "\n"
                                    for r in recs])
    extra = shape["extra"]
    port = _cold(tmp_path, qfa, tfa, "p", extra)
    ref = _cold(tmp_path, qfa, tfa, "r", extra, who="ref")
    m2m = _cold(tmp_path, qfa, tfa, "m", extra, job="--many2many")
    assert port.rc == ref.rc == m2m.rc == 0, (port.err, ref.err)
    assert port.o == ref.o == m2m.o and port.s == ref.s == m2m.s
    assert port.stats["m2m"] == ref.stats["m2m"]
    nt, nq = shape["nt"], shape["nq"]
    assert port.stats["m2m"]["batches"] == -(-nt // MAX_ARRIVAL_BATCH)
    assert port.stats["m2m"]["pairs_dispatched"] == nq * nt
    assert port.stats["alignments"] == nq * nt
    if "-v" in extra:
        assert port.err.splitlines()[0] == ref.err.splitlines()[0]
    # no -o: the report on stdout
    out = io.StringIO()
    assert run(["--m2m-stream", tfa, "-r", qfa, "--device=cpu", *extra],
               stdout=out, stderr=io.StringIO()) == 0
    assert out.getvalue().encode() == port.o


@pytest.mark.parametrize("argv", [
    ["--m2m-stream", "-r", "Q"],
    ["--m2m-stream", "T", "T", "-r", "Q"],
    ["--m2m-stream", "T", "-r", "Q", "-w", "m.mfa"],
    ["--m2m-stream", "T", "-r", "Q", "--deadline-s=0"],
    ["--m2m-stream", "T", "-r", "Q", "--band=0"],
    ["--m2m-stream", "T"],
    ["--m2m-stream", "NOFILE", "-r", "Q"],
    ["--m2m-stream", "EMPTY", "-r", "Q"],
    ["--m2m-stream", "GARBAGE", "-r", "Q"],
    ["--m2m-stream", "T", "-r", "Q", "-o", "/nonexistent/dir/x.tsv"]])
def test_usage_and_input_errors_equal_the_reference(tmp_path, argv):
    qfa, recs = _corpus(tmp_path)
    names = {"T": _write_targets(tmp_path, recs), "Q": qfa,
             "NOFILE": str(tmp_path / "absent.fa"),
             "EMPTY": _write_targets(tmp_path, [], "empty.fa"),
             "GARBAGE": _write_targets(tmp_path, ["no header\nAC\n"],
                                       "garbage.fa")}
    argv = [names.get(a, a) for a in argv]
    got = []
    for fn, dev in ((run, "--device=cpu"), (ref_run, "--device=cpu")):
        err = io.StringIO()
        rc = fn(argv + [dev], stdout=io.StringIO(), stderr=err)
        got.append((rc, err.getvalue().splitlines()[-1]))
    assert got[0] == got[1] and got[0][0] == 1, got


def test_stats_without_a_file_is_a_usage_error(tmp_path):
    """``--stats`` with no file is refused as ``--many2many``'s is (the
    reference's session writes a file named ``True``)."""
    qfa, recs = _corpus(tmp_path)
    err = io.StringIO()
    assert run(["--m2m-stream", _write_targets(tmp_path, recs), "-r", qfa,
                "--stats", "--device=cpu"], stderr=err) == 1
    assert err.getvalue().endswith(
        "Error: --stats requires a file argument\n")


def test_cuda_without_cuda_exits_1_once_a_pair_is_owed(tmp_path):
    """No CUDA on this box: the default ``--device=cuda`` raises at the
    first owed dispatch (never a CPU run); a session whose every pair is
    spliced from the cache touches no device and completes."""
    qfa, recs = _corpus(tmp_path)
    tfa = _write_targets(tmp_path, recs)
    rc_dir = f"--result-cache={tmp_path / 'rc'}"
    for argv in (["--m2m-stream", tfa, "-r", qfa],
                 ["--m2m-stream", tfa, "-r", qfa, "--device=cuda",
                  rc_dir]):
        err = io.StringIO()
        assert run(argv + ["-o", str(tmp_path / "x.tsv")],
                   stderr=err) == 1
        assert "--device=cpu" in err.getvalue()
        assert not (tmp_path / "x.tsv").exists()
    cold = _cold(tmp_path, qfa, tfa, "cold", (rc_dir,))
    err = io.StringIO()
    assert run(["--m2m-stream", tfa, "-r", qfa, "-o",
                str(tmp_path / "x.tsv"), rc_dir], stderr=err) == 0, \
        err.getvalue()
    assert (tmp_path / "x.tsv").read_bytes() == cold.o


# ---------------------------------------------------------------------------
# the section cache: arrivals, the two-way hit, deadlines
# ---------------------------------------------------------------------------
def test_incremental_arrivals_splice_from_section_cache(tmp_path):
    """A --result-cache primed with 5 targets re-scores ONLY the 2
    arrivals on the grown input — the counters say so, as the
    reference's — and the spliced bytes equal the cache-off run."""
    qfa, recs = _corpus(tmp_path)
    got = {}
    for who in ("port", "ref"):
        rc_dir = f"--result-cache={tmp_path / who}"
        prime = _cold(tmp_path, qfa, _write_targets(tmp_path, recs[:5],
                                                    "five.fa"),
                      f"{who}_prime", (rc_dir,), who=who)
        assert prime.rc == 0
        got[who] = _cold(tmp_path, qfa, _write_targets(tmp_path, recs,
                                                       "seven.fa"),
                         f"{who}_inc", (rc_dir,), who=who)
    full = _cold(tmp_path, qfa, _write_targets(tmp_path, recs, "seven.fa"),
                 "full")
    port, ref = got["port"], got["ref"]
    assert port.rc == ref.rc == 0
    assert port.stats["m2m"] == ref.stats["m2m"]
    m2m = port.stats["m2m"]
    assert (m2m["targets_reused"], m2m["pairs_dispatched"],
            m2m["pairs_reused"]) == (5, 2 * 2, 2 * 5)
    assert port.o == ref.o == full.o and port.s == ref.s == full.s


def test_many2many_and_m2m_stream_hit_each_other_both_ways(tmp_path):
    """--many2many's sections feed a session's family pool (every pair
    spliced, none dispatched), and a session's sections answer a
    --many2many job exactly (every section from the cache, no device
    session), each byte-equal to the uncached runs."""
    qfa, recs = _corpus(tmp_path, nq=3, nt=9, seed=4)
    ta = _write_targets(tmp_path, recs[:6], "ta.fa")
    tb = _write_targets(tmp_path, recs[3:], "tb.fa")
    rc_dir = f"--result-cache={tmp_path / 'rc'}"
    want_a = _cold(tmp_path, qfa, ta, "wa", job="--many2many")
    want_b = _cold(tmp_path, qfa, tb, "wb", job="--many2many")
    # --many2many first, then the session over the same targets
    assert _cold(tmp_path, qfa, ta, "ma", (rc_dir,),
                 job="--many2many").rc == 0
    sa = _cold(tmp_path, qfa, ta, "sa", (rc_dir,))
    assert sa.rc == 0 and (sa.o, sa.s) == (want_a.o, want_a.s)
    assert sa.stats["m2m"]["pairs_dispatched"] == 0
    assert sa.stats["m2m"]["pairs_reused"] == 3 * 6
    # the session first (a target set the cache holds only partly: the
    # three shared targets splice), then --many2many hits its sections
    sb = _cold(tmp_path, qfa, tb, "sb", (rc_dir,))
    assert sb.rc == 0 and (sb.o, sb.s) == (want_b.o, want_b.s)
    assert sb.stats["m2m"]["pairs_dispatched"] == 3 * 3
    mb = _cold(tmp_path, qfa, tb, "mb", (rc_dir, "-v"), job="--many2many")
    assert mb.rc == 0 and (mb.o, mb.s) == (want_b.o, want_b.s)
    assert mb.stats["alignments"] == 0
    assert "all 3 section(s) served from the result cache" in mb.err


def test_deadline_preempts_resumable_and_resubmission_completes(tmp_path):
    """--deadline-s at the per-CDS dispatch boundary: a session with a
    spent budget exits 75 with no report, as the reference's; its
    resubmission completes byte-identical to the cold run; and the same
    spent budget over a primed cache completes from splices."""
    qfa, recs = _corpus(tmp_path)
    tfa = _write_targets(tmp_path, recs)
    cold = _cold(tmp_path, qfa, tfa, "cold")
    for who in ("port", "ref"):
        rc_dir = f"--result-cache={tmp_path / who}"
        pre = _cold(tmp_path, qfa, tfa, f"{who}_dl",
                    (rc_dir, "--deadline-s=0.000001"), who=who)
        assert pre.rc == EXIT_PREEMPTED and pre.o is None, pre.err
        assert "deadline_exceeded" in pre.err
        assert pre.stats["preempted"] is True
        if who == "port":
            port_pre = pre
        else:
            assert pre.stats["m2m"] == port_pre.stats["m2m"]
            assert pre.err.splitlines()[-1] == port_pre.err.splitlines()[-1]
    again = _cold(tmp_path, qfa, tfa, "again", (f"--result-cache="
                                                f"{tmp_path / 'port'}",))
    assert again.rc == 0 and (again.o, again.s) == (cold.o, cold.s)
    primed = _cold(tmp_path, qfa, tfa, "primed",
                   (f"--result-cache={tmp_path / 'port'}",
                    "--deadline-s=0.000001"))
    assert primed.rc == 0 and (primed.o, primed.s) == (cold.o, cold.s)
    assert primed.stats["m2m"]["pairs_dispatched"] == 0


def test_deadline_mid_session_caches_the_scored_batches(tmp_path,
                                                         monkeypatch):
    """A budget that runs out during the first arrival batch (the
    scorer slowed past it): exit 75 at the next dispatch boundary, the
    first batch's partial sections cached; the resubmission dispatches
    only the rest and gives the cold bytes."""
    import time

    from pwasm_tpu_torch.parallel import many2many
    from pwasm_tpu_torch.surveil import session
    monkeypatch.setattr(session, "MAX_ARRIVAL_BATCH", 4)
    qfa, recs = _corpus(tmp_path, nq=2, nt=10, seed=8)
    tfa = _write_targets(tmp_path, recs)
    cold = _cold(tmp_path, qfa, tfa, "cold")
    scorer = many2many.many2many_scores_ragged

    def slow(*a, **kw):
        time.sleep(3.5)
        return scorer(*a, **kw)
    monkeypatch.setattr(many2many, "many2many_scores_ragged", slow)
    rc_dir = f"--result-cache={tmp_path / 'rc'}"
    # a file read in one chunk past the batch cap is one batch of every
    # record but the last (held until the end of the file), then the
    # last
    pre = _cold(tmp_path, qfa, tfa, "pre", (rc_dir, "--deadline-s=3"))
    monkeypatch.setattr(many2many, "many2many_scores_ragged", scorer)
    assert pre.rc == EXIT_PREEMPTED, pre.err
    assert pre.stats["m2m"]["targets_scored"] == 9
    assert "9 of 10 target(s) scored and cached" in pre.err
    assert pre.o is None
    again = _cold(tmp_path, qfa, tfa, "again", (rc_dir,))
    assert again.rc == 0 and (again.o, again.s) == (cold.o, cold.s)
    assert again.stats["m2m"]["pairs_reused"] == 2 * 9
    assert again.stats["m2m"]["pairs_dispatched"] == 2 * 1


# ---------------------------------------------------------------------------
# served sessions
# ---------------------------------------------------------------------------
@contextmanager
def _daemon(cls=Daemon, **kw):
    d = tempfile.mkdtemp(prefix="pwsv")
    sock = os.path.join(d, "s.sock")
    err = io.StringIO()
    dm = cls(sock, stderr=err, journal_path=None, **kw)
    rcbox: list = []
    t = threading.Thread(target=lambda: rcbox.append(dm.serve()),
                         daemon=True)
    t.start()
    assert wait_for_socket(sock, 15), err.getvalue()
    try:
        yield SimpleNamespace(daemon=dm, sock=sock, err=err, rc=rcbox)
    finally:
        if not dm.drain.requested:
            dm.drain.request("test teardown")
        t.join(20)
        shutil.rmtree(d, ignore_errors=True)


def _session(sock, qfa, text, tag, tmp_path, extra=()):
    o, s = str(tmp_path / f"{tag}.tsv"), str(tmp_path / f"{tag}.sum")
    with ServiceClient(sock) as c:
        r = c.stream(["--m2m-stream", "-r", qfa, "-o", o, "-s", s,
                      "--device=cpu", *extra],
                     [text[i:i + 61] for i in range(0, len(text), 61)],
                     cwd=str(tmp_path))
        assert r.get("ok"), r
        res = c.result(r["job_id"], timeout=180)
        st = c.stats()["stats"]
        expo = c.metrics()["metrics"]
    with open(o, "rb") as f, open(s, "rb") as g:
        return SimpleNamespace(res=res, o=f.read(), s=g.read(), st=st,
                               expo=expo)


def test_served_session_equals_the_reference_daemon_and_cold(tmp_path):
    """Records chunked at arbitrary byte splits over the stream verbs:
    the port's served report and summary equal the reference daemon's
    session and the cold run; the result's m2m block, svc-stats' m2m
    block, the top pane and the pwasm_m2m_* families count the session
    (arrival batches are where the feed ran dry, so they are not
    compared)."""
    from pwasm_tpu.service.daemon import Daemon as RefDaemon
    qfa, recs = _corpus(tmp_path)
    tfa = _write_targets(tmp_path, recs)
    cold = _cold(tmp_path, qfa, tfa, "cold")
    got = {}
    for who, cls, kw in (("port", Daemon, {}),
                         ("ref", RefDaemon, {"slo_rules": "off"})):
        with _daemon(cls, **kw) as h:
            got[who] = _session(h.sock, qfa, "".join(recs), who, tmp_path)
    port, ref = got["port"], got["ref"]
    for sv in (port, ref):
        assert sv.res.get("rc") == 0, sv.res
        assert (sv.o, sv.s) == (cold.o, cold.s)

    def flow(block):
        return {k: v for k, v in block.items() if k != "batches"}
    m2m = port.res["stats"]["m2m"]
    assert flow(m2m) == flow(ref.res["stats"]["m2m"])
    assert m2m["targets_in"] == len(recs)
    assert m2m["pairs_dispatched"] == 2 * len(recs)
    assert flow(port.st["m2m"]) == flow(ref.st["m2m"])
    blk = port.st["m2m"]
    assert blk["sessions"] == 1 and blk["active"] == 0 \
        and blk["targets_in"] == len(recs), blk
    line = [ln for ln in render(port.st).splitlines()
            if ln.startswith(" M2M:")]
    assert line and "1 session(s)" in line[0]
    assert "pwasm_m2m_sessions_total 1" in port.expo
    assert f"pwasm_m2m_targets_total {len(recs)}" in port.expo


def test_served_sessions_splice_and_hit_many2many(tmp_path):
    """A daemon with --result-cache: a first session of 5 targets, a
    second over those 5 plus 2 new dispatches only the new pairs (to the
    cold bytes of the 7), and a served --many2many over the 7 then
    answers every section from the cache."""
    qfa, recs = _corpus(tmp_path)
    want = _cold(tmp_path, qfa, _write_targets(tmp_path, recs), "cold")
    with _daemon(result_cache=str(tmp_path / "rc")) as h:
        first = _session(h.sock, qfa, "".join(recs[:5]), "s5", tmp_path)
        assert first.res["rc"] == 0
        second = _session(h.sock, qfa, "".join(recs), "s7", tmp_path)
        m2m = second.res["stats"]["m2m"]
        assert (m2m["pairs_dispatched"], m2m["pairs_reused"],
                m2m["targets_reused"]) == (2 * 2, 2 * 5, 5)
        assert (second.o, second.s) == (want.o, want.s)
        assert second.st["m2m"]["sessions"] == 2
        tfa = _write_targets(tmp_path, recs, "all.fa")
        stj = str(tmp_path / "m.json")
        with ServiceClient(h.sock) as c:
            r = c.submit(["--many2many", tfa, "-r", qfa, "-o",
                          str(tmp_path / "m.tsv"), f"--stats={stj}",
                          "--device=cpu"])
            assert c.result(r["job_id"], timeout=120)["rc"] == 0
        assert (tmp_path / "m.tsv").read_bytes() == want.o
        with open(stj) as f:
            assert json.load(f)["alignments"] == 0
