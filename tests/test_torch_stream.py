"""The port's streaming ingest (``pwasm_tpu_torch/stream/pafstream.py``)
and the CLI's ``--follow[=IDLE_S]`` and block-read default ingest,
against the JAX package's.

The host cases of the reference's tests/test_stream.py, ported: the
assembler under fuzzed chunking, the follow reader's growth and
rotation, the stream feed's batching and its drain, ``--follow``'s
byte parity with the one-shot run (LF and CRLF, a CRLF split across two
appends, with and without ``--realign``), ``-`` for stdin, the usage
errors, and a real SIGTERM mid-stream (exit 75, then ``--resume``).
Every CLI case's bytes are held to the port's one-shot run and to
``pwasm_tpu.cli --device=cpu``'s.  New here: ``BlockLineReader`` against
the text-mode read it replaced, line numbers on CR/CRLF inputs, a
multi-byte character split across two appends (where the port's
``--follow`` decodes as the one-shot read does and the reference's does
not), ``--device-deadline`` not counting the wait for input, and
``--deadline-s`` ending a follow that never grows.
"""

import io
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pwasm_tpu.cli import CliError as RefCliError
from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.core.fasta import write_fasta
from pwasm_tpu.stream.pafstream import LineAssembler as RefLineAssembler
from pwasm_tpu.stream.pafstream import StreamFeed as RefStreamFeed
from pwasm_tpu_torch import stream
from pwasm_tpu_torch.cli import run
from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
from pwasm_tpu_torch.stream.pafstream import (MAX_RECORD_BYTES,
                                              BlockLineReader, FollowReader,
                                              LineAssembler, StreamFeed)

from helpers import make_paf_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(tmp_path, n=16, qlen=120, seed=3, tname="asm"):
    rng = np.random.default_rng(seed)
    q = "".join("ACGT"[i] for i in rng.integers(0, 4, qlen))
    lines = []
    for i in range(n):
        cut = 10 + int(rng.integers(0, qlen - 40))
        qb = q[cut]
        tb = "ACGT"[("ACGT".index(qb) + 1) % 4]
        ops = [("=", cut), ("*", tb, qb), ("=", 20), ("ins", "gg"),
               ("=", qlen - cut - 21)]
        lines.append(make_paf_line("q", q, f"{tname}{i}", "+", ops)[0])
    fa = tmp_path / "q.fa"
    write_fasta(str(fa), [("q", q.encode())])
    paf = tmp_path / "in.paf"
    paf.write_text("".join(ln + "\n" for ln in lines))
    return str(paf), str(fa), lines


def _fuzz_chunks(text, n_cuts, seed, also=()):
    """``text`` cut at ``n_cuts`` random offsets and at ``also``."""
    rng = np.random.default_rng(seed)
    cuts = sorted(set(rng.integers(1, len(text), n_cuts).tolist())
                  | set(also)) + [len(text)]
    chunks, prev = [], 0
    for c in cuts:
        if c > prev:
            chunks.append(text[prev:c])
            prev = c
    return chunks


def _outputs(tmp_path, tag, msa):
    names = ("dfa", "sum") + (("mfa",) if msa else ())
    return {n: (tmp_path / f"{tag}.{n}").read_bytes() for n in names}


def _out_args(tmp_path, tag, msa):
    return (["-o", str(tmp_path / f"{tag}.dfa"),
             "-s", str(tmp_path / f"{tag}.sum")]
            + (["-w", str(tmp_path / f"{tag}.mfa")] if msa else []))


def _oneshots(tmp_path, paf, fa, extra=(), msa=False):
    """The port's and the reference's one-shot runs of ``paf`` at
    ``--device=cpu``: their outputs, which must be equal."""
    got = {}
    for tag, fn, dev in (("one_port", run, ["--device=cpu"]),
                         ("one_ref", ref_run, [])):
        err = io.StringIO()
        rc = fn([paf, "-r", fa, *_out_args(tmp_path, tag, msa),
                 "--batch=4", *extra, *dev], stderr=err)
        assert rc == 0, err.getvalue()[:2000]
        got[tag] = _outputs(tmp_path, tag, msa)
    assert got["one_port"] == got["one_ref"]
    return got["one_port"]


def _reader_pos(path):
    """The offset of this process's open handle of ``path`` (the follow
    reader's: the writer below closes its own between appends), or
    None while none is open."""
    want = os.path.realpath(path)
    for fd in os.listdir("/proc/self/fd"):
        try:
            if os.readlink(f"/proc/self/fd/{fd}") == want:
                with open(f"/proc/self/fdinfo/{fd}") as f:
                    return int(f.readline().split()[1])   # "pos: N"
        except (OSError, ValueError, IndexError):
            continue
    return None


def _wait(cond, limit_s=60.0):
    t_end = time.monotonic() + limit_s
    while not cond() and time.monotonic() < t_end:
        time.sleep(0.005)


def _follow(tmp_path, tag, grow, fa, chunks, extra=(), msa=False,
            fn=run, pause_s=0.005, idle="1.0", sync=False):
    """``fn``'s ``--follow=idle`` run of ``grow`` while a thread appends
    ``chunks`` (bytes or str) to it, ``pause_s`` apart; with ``sync``
    each append waits until the reader has read the ones before it (so
    each is a read of its own).  Returns the outputs."""
    open(grow, "wb").close()

    def writer():
        done = 0
        if sync:
            _wait(lambda: _reader_pos(grow) is not None)
        for ch in chunks:
            data = ch if isinstance(ch, bytes) else ch.encode()
            with open(grow, "ab") as f:
                f.write(data)
            done += len(data)
            if sync:
                _wait(lambda: _reader_pos(grow) == done)
            else:
                time.sleep(pause_s)

    t = threading.Thread(target=writer)
    t.start()
    err = io.StringIO()
    dev = ["--device=cpu"] if fn is run else []
    try:
        rc = fn([grow, f"--follow={idle}", "-r", fa,
                 *_out_args(tmp_path, tag, msa), "--batch=4", *extra, *dev],
                stderr=err)
    finally:
        t.join()
    assert rc == 0, err.getvalue()[:2000]
    return _outputs(tmp_path, tag, msa)


# ---------------------------------------------------------------------------
# units: assembler, block reader, follow reader, feed
# ---------------------------------------------------------------------------
def test_package_exports_the_reference_names():
    assert stream.__all__ == ["FollowReader", "LineAssembler", "StreamFeed"]
    assert MAX_RECORD_BYTES == 4 << 20


def test_line_assembler_fuzzed_chunking_rebuilds_lines():
    rng = np.random.default_rng(11)
    for trial in range(20):
        lines = [f"rec{k}\tpayload{'x' * int(rng.integers(0, 9))}\n"
                 for k in range(int(rng.integers(1, 30)))]
        text = "".join(lines)
        if rng.random() < 0.5:
            text = text[:-1]       # final record without its newline
        asm, ref = LineAssembler(), RefLineAssembler()
        got = []
        for ch in _fuzz_chunks(text, int(rng.integers(1, 40)),
                               int(rng.integers(0, 1 << 30))):
            assert asm.completed(ch) == ch.count("\n")
            assert asm.preview(ch) == ref.preview(ch)
            pushed = asm.push(ch)
            assert pushed == ref.push(ch)
            got.extend(pushed)
        tail = asm.flush()
        assert tail == ref.flush()
        got.extend(tail)
        assert "".join(got) == text         # nothing lost or reordered
        assert len(got) == len(lines)       # record boundaries exact
        assert asm.pending == ""


# inputs as bytes: LF, CRLF, lone CR, no final newline, and multi-byte
# characters (2-, 3- and 4-byte) that block sizes 1 and 7 split
BLOCK_INPUTS = {
    "lf": b"a\tb\nc\td\n\n#x\ne\n",
    "crlf": b"a\tb\r\nc\td\r\n\r\ne\r\n",
    "cr": b"a\tb\rc\td\r\re\r",
    "no_final_newline": b"a\tb\nc\r\nlast\tline",
    "multibyte": "asmé\tx\n€€\r\n\U0001f600z\ntailé"
                 .encode(),
}


@pytest.mark.parametrize("block", [1, 7, 1 << 20])
@pytest.mark.parametrize("kind", sorted(BLOCK_INPUTS))
def test_block_reader_equals_the_text_mode_read(tmp_path, kind, block):
    path = tmp_path / "in.paf"
    path.write_bytes(BLOCK_INPUTS[kind])
    with open(path, encoding="utf-8") as f:
        want = list(f)
    rd = BlockLineReader(str(path), block_bytes=block)
    assert list(rd) == want
    assert rd.consumed
    rd.close()


@pytest.mark.parametrize("block", [1, 7, 1 << 20])
def test_block_reader_raises_on_invalid_utf8_as_text_mode(tmp_path, block):
    path = tmp_path / "bad.paf"
    path.write_bytes(b"ok\tline\nbad\xff\xfebyte\n")
    with pytest.raises(UnicodeDecodeError):
        with open(path, encoding="utf-8") as f:
            list(f)
    with pytest.raises(UnicodeDecodeError):
        list(BlockLineReader(str(path), block_bytes=block))


@pytest.mark.parametrize("rotate", ["recreate", "truncate"])
def test_follow_reader_tails_growth_and_survives_rotation(tmp_path, rotate):
    """Growth, a partial line, then a new incarnation of the file: a new
    inode at the path (removed and created again; the reader's open
    handle keeps the old inode's number in use) or the same file
    truncated and rewritten (copytruncate)."""
    path = str(tmp_path / "grow.paf")
    open(path, "w").close()
    rd = FollowReader(path, idle_timeout_s=0.4, poll_s=0.01)

    def writer():
        with open(path, "a") as f:
            f.write("a1\na2\npar")     # partial line stays pending
            f.flush()
            time.sleep(0.05)
            f.write("tial\n")
            f.flush()
        time.sleep(0.05)
        if rotate == "recreate":
            os.unlink(path)
        with open(path, "w") as f:
            f.write("b1\nb2")           # final record, no newline

    t = threading.Thread(target=writer)
    t.start()
    got = list(rd)
    t.join()
    rd.close()
    assert got == ["a1\n", "a2\n", "partial\n", "b1\n", "b2"]
    assert rd.rotations == 1 and not rd.consumed


def test_follow_reader_joins_a_character_split_across_appends(tmp_path):
    """The port's one change to the reader: an incremental strict
    decoder, fresh after a rotation, where the reference decodes each
    chunk on its own with errors="replace"."""
    path = str(tmp_path / "grow.paf")
    data = "xéy\n€z".encode()
    cut = data.index(b"\xa9")              # inside the 2-byte "é"
    open(path, "wb").close()
    rd = FollowReader(path, idle_timeout_s=0.3, poll_s=0.01)

    def writer():
        for part in (data[:cut], data[cut:]):
            with open(path, "ab") as f:
                f.write(part)
            time.sleep(0.1)

    t = threading.Thread(target=writer)
    t.start()
    got = list(rd)
    t.join()
    rd.close()
    assert got == ["xéy\n", "€z"] and rd.consumed


def test_stream_feed_batches_lag_and_final_partial():
    for cls in (StreamFeed, RefStreamFeed):
        feed = cls()
        batches = []
        feed.on_batch = batches.append
        feed.feed("r1\nr2\nr3")
        assert feed.buffered == 2 and feed.records_in == 2
        assert feed.tail_bytes == 2 and feed.lag_age_s() >= 0.0
        assert next(feed) == "r1\n" and next(feed) == "r2\n"
        assert feed.buffered == 0 and feed.records_out == 2
        assert feed.lag_age_s() == 0.0
        assert batches == [2]          # one arrival batch drained
        feed.feed("-tail\nlast")
        feed.end()                     # the newline-less tail arrives now
        assert list(feed) == ["r3-tail\n", "last"]
        assert feed.batches == 2 and feed.records_out == 4
        with pytest.raises(ValueError):
            feed.feed("too late\n")


def test_stream_feed_drain_wakes_blocked_consumer():
    feed = StreamFeed()
    drain = SimpleNamespace(requested=False)
    feed.bind_drain(drain)
    got = []

    def consume():
        got.extend(feed)

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.1)
    assert t.is_alive()            # blocked waiting for records
    drain.requested = True
    t.join(5)
    assert not t.is_alive() and got == []


def test_stream_feed_idle_timeout_requests_the_drain():
    reasons = []
    drain = SimpleNamespace(requested=False, request=reasons.append)
    feed = StreamFeed(idle_timeout_s=0.2)
    feed.bind_drain(drain)
    assert list(feed) == [] and len(reasons) == 1
    assert "idle" in reasons[0]


# ---------------------------------------------------------------------------
# the CLI: the default ingest and --follow
# ---------------------------------------------------------------------------
def test_skip_bad_lines_numbers_on_cr_inputs(tmp_path):
    """``file_line`` counts as the text-mode read did: the warnings'
    line numbers on LF, CRLF and lone-CR inputs with blank lines, a
    comment and no final newline equal the reference's."""
    _paf, fa, lines = _corpus(tmp_path, n=6)
    rows = lines[:2] + ["", "# note", "too\tfew"] + lines[2:4] \
        + ["bad"] + lines[4:]
    for eol in ("\n", "\r\n", "\r"):
        paf = tmp_path / "eol.paf"
        paf.write_bytes(eol.join(rows).encode())
        got = {}
        for tag, fn, dev in (("p", run, ["--device=cpu"]),
                             ("r", ref_run, [])):
            err = io.StringIO()
            assert fn([str(paf), "-r", fa, *_out_args(tmp_path, tag, False),
                       "--skip-bad-lines", *dev], stderr=err) == 0
            got[tag] = (err.getvalue(), _outputs(tmp_path, tag, False))
        assert got["p"] == got["r"], eol
        assert "line 5\n" in got["p"][0] and "line 8\n" in got["p"][0]


@pytest.mark.parametrize("eol", ["lf", "crlf"])
@pytest.mark.parametrize("realign", [False, True],
                         ids=["default", "realign"])
def test_follow_mode_byte_parity_with_oneshot(tmp_path, realign, eol):
    """A file grown in fuzzed chunks (split inside lines, and for CRLF
    between every \\r and its \\n) follows to the one-shot bytes of both
    packages."""
    _paf, fa, lines = _corpus(tmp_path)
    sep = "\n" if eol == "lf" else "\r\n"
    text = "".join(ln + sep for ln in lines)
    paf = tmp_path / f"{eol}.paf"
    paf.write_bytes(text.encode())
    extra = ["--realign"] if realign else []
    want = _oneshots(tmp_path, str(paf), fa, extra, msa=realign)
    crs = [i + 1 for i, c in enumerate(text) if c == "\r"]
    chunks = _fuzz_chunks(text, 40, seed=9, also=crs)
    got = _follow(tmp_path, "fol", str(tmp_path / "grow.paf"), fa, chunks,
                  extra, msa=realign)
    assert got == want


def test_stdin_dash_marker_reads_stdin(tmp_path, monkeypatch):
    """`pafreport - ...` is the documented pipe shape: '-' reads
    stdin exactly like the no-positional form."""
    paf, fa, lines = _corpus(tmp_path, n=4)
    want = _oneshots(tmp_path, paf, fa)["dfa"]
    for argv in (["-"], []):
        monkeypatch.setattr(
            "sys.stdin", io.StringIO("".join(ln + "\n" for ln in lines)))
        err = io.StringIO()
        rc = run([*argv, "-r", fa, "-o", str(tmp_path / "d.dfa"),
                  "--batch=4", "--device=cpu"], stderr=err)
        assert rc == 0, err.getvalue()[:2000]
        assert (tmp_path / "d.dfa").read_bytes() == want


@pytest.mark.parametrize("argv,msg", [
    (["PAF", "--follow=nope"], "Invalid --follow value: nope"),
    (["PAF", "--follow=0"], "Invalid --follow value: 0"),
    (["PAF", "--follow=-2"], "Invalid --follow value: -2"),
    (["PAF", "--follow=inf"], "Invalid --follow value: inf"),
    (["--follow"], "--follow requires an input PAF file to tail "
                   "(stdin already streams)"),
    (["-", "--follow=2"], "--follow requires an input PAF file to tail "
                          "(stdin already streams)")])
def test_follow_usage_errors(tmp_path, argv, msg):
    paf, fa, _ = _corpus(tmp_path, n=2)
    argv = [paf if a == "PAF" else a for a in argv] + ["-r", fa]
    err = io.StringIO()
    assert run(argv + ["--device=cpu"], stderr=err) == 1
    assert err.getvalue().splitlines()[-1] == msg
    with pytest.raises(RefCliError) as ref:      # the reference raises it
        ref_run(argv, stderr=io.StringIO())
    assert str(ref.value).splitlines()[-1] == msg
    assert not os.path.exists(tmp_path / "grow.paf")


def test_follow_sigterm_midstream_exit75_then_resume_parity(tmp_path):
    """SIGTERM a bare --follow after its first durable checkpoint: exit
    75 (the reader is woken by the drain, not by input); --resume over
    the COMPLETED file finishes the report byte-identically to both
    packages' one-shot runs."""
    paf, fa, lines = _corpus(tmp_path, n=24)
    want = _oneshots(tmp_path, paf, fa)["dfa"]
    grow = str(tmp_path / "grow.paf")
    open(grow, "w").close()
    rep = str(tmp_path / "st.dfa")
    env = dict(os.environ, PYTHONPATH=REPO)
    sp = subprocess.Popen(
        [sys.executable, "-m", "pwasm_tpu_torch", grow, "--follow",
         "-r", fa, "-o", rep, "--batch=4", "--device=cpu"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        # feed enough for several durable batches, then hold the rest
        with open(grow, "a") as f:
            f.write("".join(ln + "\n" for ln in lines[:16]))
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if os.path.exists(rep + ".ckpt"):
                break
            assert sp.poll() is None, sp.stderr.read()[:2000]
            time.sleep(0.02)
        assert os.path.exists(rep + ".ckpt"), "no ckpt before signal"
        sp.send_signal(signal.SIGTERM)
        rc = sp.wait(timeout=60)
        err = sp.stderr.read()
        assert rc == EXIT_PREEMPTED, err[:2000]
        assert "preempted (caught SIGTERM)" in err
    finally:
        if sp.poll() is None:
            sp.kill()
            sp.wait()
        sp.stderr.close()
    assert os.path.exists(rep + ".ckpt")
    # the writer finishes the file; --resume completes the report
    with open(grow, "a") as f:
        f.write("".join(ln + "\n" for ln in lines[16:]))
    err = io.StringIO()
    rc = run([grow, "--resume", "-r", fa, "-o", rep, "--batch=4",
              "--device=cpu"], stderr=err)
    assert rc == 0, err.getvalue()[:2000]
    assert open(rep, "rb").read() == want
    assert not os.path.exists(rep + ".ckpt")


def test_follow_split_multibyte_character_equals_oneshot(tmp_path):
    """Target names with a 2-byte "é", the file written in two appends
    split inside it: the port's --follow report equals both one-shot
    runs; the reference's --follow decodes each append on its own and
    writes two U+FFFD instead (recorded here, not copied)."""
    _paf, fa, lines = _corpus(tmp_path, n=3, tname="asmé")
    data = "".join(ln + "\n" for ln in lines).encode()
    paf = tmp_path / "utf8.paf"
    paf.write_bytes(data)
    want = _oneshots(tmp_path, str(paf), fa)
    assert "asmé0".encode() in want["dfa"]
    cut = data.index("é".encode()) + 1
    chunks = [data[:cut], data[cut:]]
    got = _follow(tmp_path, "fol", str(tmp_path / "grow.paf"), fa, chunks,
                  sync=True)
    assert got == want
    ref = _follow(tmp_path, "ref", str(tmp_path / "grow_ref.paf"), fa,
                  chunks, fn=ref_run, sync=True)
    assert ref["dfa"] != want["dfa"]
    assert "asm��0".encode() in ref["dfa"]


def test_follow_device_deadline_does_not_count_the_wait(tmp_path):
    """--device-deadline bounds a supervised attempt (the fetch of a
    submitted batch), not the wait for input: with the writer pausing
    1 s between appends, a 0.5 s deadline never times out."""
    import json

    paf, fa, lines = _corpus(tmp_path, n=12)
    want = _oneshots(tmp_path, paf, fa)
    text = "".join(ln + "\n" for ln in lines)
    chunks = [text[:len(text) // 3], text[len(text) // 3:2 * len(text) // 3],
              text[2 * len(text) // 3:]]
    st = tmp_path / "st.json"
    got = _follow(tmp_path, "fol", str(tmp_path / "grow.paf"), fa, chunks,
                  ["--device-deadline=0.5", f"--stats={st}"], pause_s=1.0,
                  idle="3")
    assert got == want
    res = json.loads(st.read_text())["resilience"]
    assert res["deadline_timeouts"] == 0


def test_follow_deadline_s_on_a_file_that_never_grows(tmp_path):
    paf, fa, lines = _corpus(tmp_path, n=4)
    grow = tmp_path / "grow.paf"
    grow.write_text("".join(ln + "\n" for ln in lines[:2]))
    err = io.StringIO()
    t0 = time.monotonic()
    rc = run([str(grow), "--follow", "-r", fa, "-o",
              str(tmp_path / "d.dfa"), "--deadline-s=1", "--device=cpu"],
             stderr=err)
    assert rc == EXIT_PREEMPTED, err.getvalue()[:2000]
    assert time.monotonic() - t0 < 30
    assert "deadline_exceeded: --deadline-s=1 budget spent" \
        in err.getvalue()
    assert os.path.exists(str(tmp_path / "d.dfa") + ".ckpt")
