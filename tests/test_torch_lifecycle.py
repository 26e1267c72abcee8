"""The port's graceful drain (``pwasm_tpu_torch/resilience/lifecycle.py``)
and ``--deadline-s`` against the JAX package's.

``SignalDrain`` as a unit (the reference's tests/test_durability.py
cases, with the handler called directly: no test raises a real signal
in its own process), then the CLI drained mid-run.  Both packages drain
with ``--inject-faults=preempt=N``, which requests the drain at the
N-th supervised device call.  Comparisons are exact: exit 75, the drain's stderr lines, the checkpoint, the
partial ``--stats``, the events and the resumed outputs.  One test runs
the CLI as a process and sends it a real SIGTERM, then a real SIGKILL.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.resilience.lifecycle import SignalDrain as RefSignalDrain
from pwasm_tpu_torch.cli import _load_checkpoint, run
from pwasm_tpu_torch.core.errors import EXIT_PREEMPTED
from pwasm_tpu_torch.resilience import PreemptedError, SignalDrain

from test_durability import _corpus
from test_torch_cli_m2m import _fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# SignalDrain as a unit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cls", [SignalDrain, RefSignalDrain],
                         ids=["port", "ref"])
def test_first_signal_flags_second_hard_aborts(cls):
    err = io.StringIO()
    exits = []
    main = threading.current_thread() is threading.main_thread()
    with cls(stderr=err, hard_exit=exits.append) as drain:
        if main:
            assert signal.getsignal(signal.SIGTERM) == drain._on_signal
            assert signal.getsignal(signal.SIGINT) == drain._on_signal
        assert not drain.requested
        drain._on_signal(signal.SIGTERM, None)
        assert drain.requested and drain.reason == "caught SIGTERM"
        assert not exits
        drain._on_signal(signal.SIGINT, None)
        assert exits == [128 + signal.SIGINT]
        assert drain.reason == "caught SIGTERM"
    assert signal.getsignal(signal.SIGTERM) != drain._on_signal
    assert err.getvalue() == (
        "pwasm: caught SIGTERM — draining: finishing the in-flight batch, "
        "flushing a final checkpoint, then exiting resumable (exit 75); a "
        "second signal hard-aborts\n"
        "pwasm: second signal (SIGINT) — hard abort\n")


def test_request_is_idempotent_and_logged():
    events = []

    class Obs:
        def event(self, name, **fields):
            events.append((name, fields))

    drain = SignalDrain(stderr=io.StringIO(), hard_exit=lambda c: None)
    drain.obs = Obs()
    drain.request("first")
    drain.request("second")
    assert drain.reason == "first"
    assert events == [("drain", {"reason": "first"})]


def test_interrupting_phase_raises_on_request_and_on_entry():
    drain = SignalDrain(stderr=io.StringIO(), hard_exit=lambda c: None)
    with pytest.raises(PreemptedError):
        with drain.interrupting():
            drain.request("mid-tail")
    assert not drain._interrupt       # disarmed by the unwind
    drain.request("after")            # outside the phase: a flag only
    with pytest.raises(PreemptedError, match="mid-tail"):
        with drain.interrupting():    # a pending request raises on entry
            raise AssertionError("the phase body must not run")


def test_request_from_another_thread_only_sets_the_flag():
    drain = SignalDrain(stderr=io.StringIO(), hard_exit=lambda c: None)
    raised = []

    def other():
        try:
            drain.request("deadline_exceeded: from a timer")
        except PreemptedError as e:   # must not happen
            raised.append(e)

    with drain.interrupting():
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        assert not t.is_alive()
        assert drain.requested and not raised
    assert drain.reason == "deadline_exceeded: from a timer"


def test_say_survives_a_stream_that_raises():
    class Reentrant(io.StringIO):
        def write(self, s):
            raise RuntimeError("reentrant call")

    drain = SignalDrain(stderr=Reentrant(), hard_exit=lambda c: None)
    drain.request("caught SIGTERM")    # falls back to fd 2, never raises
    assert drain.requested


# ---------------------------------------------------------------------------
# the CLI drained at the N-th dispatch, against the reference's preempt=N
# ---------------------------------------------------------------------------
def _args(paf, fa, d, tag, extra=()):
    p = str(d / tag)
    return [paf, "-r", fa, "-o", f"{p}.dfa", "-w", f"{p}.mfa",
            f"--cons={p}.cons", "--batch=2", f"--stats={p}.json", *extra]


def _run_both(paf, fa, d, n, extra=()):
    """Both packages drained at ``--inject-faults=preempt=n``, the port
    (outputs ``p.*``) and the reference (``r.*``); "OUT" in ``extra``
    stands for ``port`` or ``ref``: {who: (rc, stderr)}."""
    got = {}
    err = io.StringIO()
    got["port"] = (run(_args(paf, fa, d, "p", [
        a.replace("OUT", "port") for a in extra])
        + ["--device=cpu", f"--inject-faults=preempt={n}"], stderr=err),
        err.getvalue())
    err = io.StringIO()
    got["ref"] = (ref_run(_args(paf, fa, d, "r", [
        a.replace("OUT", "ref") for a in extra])
        + ["--device=tpu", f"--inject-faults=preempt={n}"], stderr=err),
        err.getvalue())
    return got


def _drain_lines(err: str) -> list[str]:
    return [ln for ln in err.splitlines() if ln.startswith("pwasm: ")
            and not ln.startswith("pwasm: fault injection armed")]


def _outs(d, tag):
    return tuple((d / f"{tag}.{ext}").read_bytes()
                 for ext in ("dfa", "mfa", "cons"))


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """The 12-alignment corpus run whole by the reference: (dir, paf, fa,
    its --stats)."""
    d = tmp_path_factory.mktemp("lifecycle")
    paf, fa = _corpus(d, n=12)
    mp = pytest.MonkeyPatch()
    mp.setenv("PWASM_DEVICE_PROBE", "0")
    try:
        err = io.StringIO()
        assert ref_run(_args(paf, fa, d, "whole") + ["--device=tpu"],
                       stderr=err) == 0, err.getvalue()
    finally:
        mp.undo()
    return d, paf, fa, json.loads((d / "whole.json").read_text())


@pytest.mark.parametrize("n", [1, 3, "tail"])
def test_preempt_at_n_drains_as_the_reference(whole, tmp_path, monkeypatch,
                                              n):
    """At a ctx_scan dispatch the line loop stops at its next line and
    the in-flight batches complete; at the tail's consensus dispatch
    (the ctx_scan flushes + 1) the whole report is durable and the MSA
    outputs are left to --resume."""
    d0, paf, fa, st_whole = whole
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    by_site = st_whole["device"]["by_site"]
    if n == "tail":
        assert by_site["consensus"] == 1
        n = by_site["ctx_scan"] + 1
    got = _run_both(paf, fa, tmp_path, n)
    assert got["port"][0] == got["ref"][0] == EXIT_PREEMPTED == 75
    lines = _drain_lines(got["port"][1])
    assert lines == _drain_lines(got["ref"][1]) and len(lines) == 2
    assert "draining" in lines[0] and "preempted" in lines[1]
    st = {who: json.loads((tmp_path / f"{who}.json").read_text())
          for who in ("p", "r")}
    assert st["p"]["preempted"] is st["r"]["preempted"] is True
    for key in ("alignments", "lines", "events", "resumed_past"):
        assert st["p"][key] == st["r"][key], key
    assert st["p"]["resilience"]["checkpoints"] \
        == st["r"]["resilience"]["checkpoints"]
    ck = _load_checkpoint(str(tmp_path / "p.dfa"))
    assert ck == _load_checkpoint(str(tmp_path / "r.dfa"))
    assert (tmp_path / "p.dfa").read_bytes() \
        == (tmp_path / "r.dfa").read_bytes()
    if n == by_site["ctx_scan"] + 1:
        assert ck[1] == 12 and st["p"]["alignments"] == 12
    else:
        assert 0 < ck[1] < 12
    assert f"{ck[1]} record(s) durable" in lines[1]
    err = io.StringIO()
    assert run(_args(paf, fa, tmp_path, "p", ["--resume"])
               + ["--device=cpu"], stderr=err) == 0, err.getvalue()
    assert _outs(tmp_path, "p") == _outs(d0, "whole")
    assert not (tmp_path / "p.dfa.ckpt").exists()
    st = json.loads((tmp_path / "p.json").read_text())
    assert st["preempted"] is False and st["resumed_past"] == ck[1]


def test_preempt_without_a_report_checkpoints_nothing(whole, monkeypatch):
    _d0, paf, fa, _st = whole
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    lines = {}
    err = io.StringIO()
    assert run([paf, "-r", fa, "--batch=2", "--device=cpu",
                "--inject-faults=preempt=1"],
               stdout=io.StringIO(), stderr=err) == EXIT_PREEMPTED
    lines["port"] = _drain_lines(err.getvalue())
    err = io.StringIO()
    assert ref_run([paf, "-r", fa, "--batch=2", "--device=tpu",
                    "--inject-faults=preempt=1"], stdout=io.StringIO(),
                   stderr=err) == EXIT_PREEMPTED
    lines["ref"] = _drain_lines(err.getvalue())
    assert lines["port"] == lines["ref"]
    assert "no -o report (nothing checkpointed)" in lines["port"][-1]


def _shape(events):
    return [(e["event"], sorted(k for k in e if k not in ("wall_s",)))
            for e in events]


def test_drain_events_and_checkpoint_counts_match_the_reference(
        whole, tmp_path, monkeypatch):
    _d0, paf, fa, _st = whole
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    got = _run_both(paf, fa, tmp_path, 3,
                    [f"--log-json={tmp_path / 'OUT.ndjson'}"])
    assert got["port"][0] == got["ref"][0] == EXIT_PREEMPTED
    evs = {who: [json.loads(ln) for ln in
                 (tmp_path / f"{who}.ndjson").read_text().splitlines()]
           for who in ("port", "ref")}
    assert _shape(evs["port"]) == _shape(evs["ref"])
    names = [e["event"] for e in evs["port"]]
    assert names[0] == "run_start" and names[-1] == "run_finish"
    assert "drain" in names and "ckpt_write" in names
    fields = ("rc", "preempted", "reason", "records", "alignments")
    assert {k: evs["port"][-1][k] for k in fields} \
        == {k: evs["ref"][-1][k] for k in fields}
    assert evs["port"][-1]["rc"] == 75
    clocks = ("ts_wall", "ts_mono", "run_id")
    for a, b in zip(evs["port"], evs["ref"]):
        if a["event"] in ("drain", "ckpt_write"):
            assert {k: v for k, v in a.items() if k not in clocks} \
                == {k: v for k, v in b.items() if k not in clocks}


# ---------------------------------------------------------------------------
# --deadline-s on both paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["main", "many2many"])
@pytest.mark.parametrize("val", ["0", "-1", "nope", "inf"])
def test_bad_deadline_exits_1_as_the_reference(whole, tmp_path, path, val):
    _d0, paf, fa, _st = whole
    if path == "main":
        args = [paf, "-r", fa, "-o", str(tmp_path / "OUT.dfa")]
    else:
        _qs, qfa, tfa = _fixture(tmp_path, n_q=2, n_t=3)
        args = ["--many2many", tfa, "-r", qfa, "-o",
                str(tmp_path / "OUT.tsv")]
    last = {}
    for who, fn in (("port", run), ("ref", ref_run)):
        err = io.StringIO()
        assert fn([a.replace("OUT", who) for a in args]
                  + [f"--deadline-s={val}", "--device=cpu"],
                  stdout=io.StringIO(), stderr=err) == 1
        last[who] = err.getvalue().splitlines()[-1]
    assert last["port"] == last["ref"]
    assert val in last["port"] and "deadline-s" in last["port"]
    assert not any(p.name.startswith("port.") for p in tmp_path.iterdir())


def test_deadline_drains_the_main_path(whole, tmp_path):
    """A 0.3 s budget against twelve one-record batches whose ctx_scan
    dispatch sleeps 0.1 s (an injected hang, which then runs the work):
    the timer drains the run mid-input."""
    d0, paf, fa, _st = whole
    args = _args(paf, fa, tmp_path, "dl") + ["--batch=1", "--device=cpu"]
    err = io.StringIO()
    rc = run(args + ["--deadline-s=0.3", "--inject-faults=rate=1,"
                     "kinds=hang,hang_s=0.1,sites=ctx_scan"], stderr=err)
    assert rc == EXIT_PREEMPTED, err.getvalue()
    assert "deadline_exceeded: --deadline-s=0.3 budget spent" \
        in err.getvalue()
    ck = _load_checkpoint(str(tmp_path / "dl.dfa"))
    assert isinstance(ck, tuple) and 0 < ck[1] < 12
    assert json.loads((tmp_path / "dl.json").read_text())["preempted"]
    err = io.StringIO()
    assert run(args + ["--resume"], stderr=err) == 0, err.getvalue()
    assert _outs(tmp_path, "dl") == _outs(d0, "whole")
    assert not (tmp_path / "dl.dfa.ckpt").exists()


def test_deadline_preempts_many2many_as_the_reference(tmp_path):
    _qs, qfa, tfa = _fixture(tmp_path, n_q=3, n_t=4)
    got = {}
    for who, fn in (("port", run), ("ref", ref_run)):
        err = io.StringIO()
        rc = fn(["--many2many", tfa, "-r", qfa, "-o",
                 str(tmp_path / f"{who}.tsv"), "-s",
                 str(tmp_path / f"{who}.sum"), "--deadline-s=0.000001",
                 f"--stats={tmp_path / f'{who}.json'}", "--device=cpu"],
                stdout=io.StringIO(), stderr=err)
        got[who] = (rc, err.getvalue(),
                    json.loads((tmp_path / f"{who}.json").read_text()))
    assert got["port"][0] == got["ref"][0] == EXIT_PREEMPTED
    assert got["port"][1] == got["ref"][1]
    assert got["port"][1].startswith("Warning: many2many preempted at a "
                                     "per-CDS dispatch boundary "
                                     "(deadline_exceeded")
    for key in ("preempted", "lines", "alignments", "aligned_bases"):
        assert got["port"][2][key] == got["ref"][2][key], key
    assert got["port"][2]["preempted"] is True
    assert got["port"][2]["device"]["dispatches"] == 0
    assert not any(p.suffix in (".tsv", ".sum") for p in tmp_path.iterdir())


# ---------------------------------------------------------------------------
# real signals to a CLI process reading its PAF from a pipe
# ---------------------------------------------------------------------------
def test_real_sigterm_drains_and_sigkill_resumes(whole, tmp_path):
    d0, paf, fa, _st = whole
    with open(paf) as f:
        lines = f.readlines()
    env = dict(os.environ, PYTHONPATH=REPO)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        tag = sig.name
        args = _args("-", fa, tmp_path, tag) + ["--device=cpu"]
        proc = subprocess.Popen(
            [sys.executable, "-m", "pwasm_tpu_torch.cli", *args],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, env=env, cwd=str(tmp_path), text=True)
        try:
            proc.stdin.write("".join(lines[:8]))
            proc.stdin.flush()
            t_end = time.monotonic() + 120
            while True:
                ck = _load_checkpoint(str(tmp_path / f"{tag}.dfa"))
                if isinstance(ck, tuple) and ck[1] >= 4:
                    break
                assert proc.poll() is None and time.monotonic() < t_end, \
                    f"no checkpoint of 4 records: {ck}"
                time.sleep(0.05)
            proc.send_signal(sig)
            if sig == signal.SIGTERM:
                # the blocked read is retried after the handler: the loop
                # sees the flag at the next line
                proc.stdin.write(lines[8])
                proc.stdin.flush()
            _out, err = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if sig == signal.SIGTERM:
            assert proc.returncode == EXIT_PREEMPTED, err
            assert "draining" in err and "preempted" in err
            assert json.loads((tmp_path / f"{tag}.json").read_text())[
                "preempted"] is True
        else:
            assert proc.returncode == -signal.SIGKILL
        ck = _load_checkpoint(str(tmp_path / f"{tag}.dfa"))
        assert isinstance(ck, tuple) and 4 <= ck[1] < 12
        err = io.StringIO()
        assert run(_args(paf, fa, tmp_path, tag, ["--resume"])
                   + ["--device=cpu"], stderr=err) == 0, err.getvalue()
        assert _outs(tmp_path, tag) == _outs(d0, "whole")
        assert not (tmp_path / f"{tag}.dfa.ckpt").exists()
