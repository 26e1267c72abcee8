"""Checkpoints and ``--resume`` of the port's CLI against the JAX
package's (``pwasm_tpu.cli`` at ``--device=tpu`` on its CPU backend,
``PWASM_DEVICE_PROBE=0``).

Both packages kill a run with ``--inject-faults=kill=K``: its K-th
supervised device attempt raises a ``BaseException`` (``InjectedKill``)
before the work.  Every comparison is exact: the killed reports, the
checkpoints (their ``resilience`` state too), the quarantine
diagnostics and the resumed outputs.
"""

import io
import json
import os
import shutil

import pytest

from pwasm_tpu.cli import _ckpt_crc as ref_ckpt_crc
from pwasm_tpu.cli import _load_checkpoint as ref_load_checkpoint
from pwasm_tpu.cli import run as ref_run
from pwasm_tpu.resilience.faults import InjectedKill
from pwasm_tpu.utils.fsio import payload_crc as ref_payload_crc
from pwasm_tpu_torch import cli as port_cli
from pwasm_tpu_torch.cli import _ckpt_crc, _load_checkpoint, run
from pwasm_tpu_torch.resilience.faults import InjectedKill as PortKill
from pwasm_tpu_torch.utils import fsio

from test_durability import _corpus, _corrupt_ckpt


def _args(paf, fa, d, tag, extra=()):
    p = str(d / tag)
    return [paf, "-r", fa, "-o", f"{p}.dfa", "-w", f"{p}.mfa",
            "--batch=2", f"--stats={p}.json", *extra]


def _port(paf, fa, d, tag, extra=()):
    err = io.StringIO()
    rc = run(_args(paf, fa, d, tag, extra) + ["--device=cpu"], stderr=err)
    return rc, err.getvalue()


def _ref(paf, fa, d, tag, extra=()):
    err = io.StringIO()
    rc = ref_run(_args(paf, fa, d, tag, extra) + ["--device=tpu"],
                 stderr=err)
    return rc, err.getvalue()


RUNNERS = {"port": _port, "ref": _ref}


def _outs(d, tag):
    return tuple((d / f"{tag}.{ext}").read_bytes() for ext in ("dfa", "mfa"))


def _ckpt(d, tag):
    path = d / f"{tag}.dfa.ckpt"
    return json.loads(path.read_text()) if path.exists() else None


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The 12-alignment corpus of the reference's kill sweep, run whole
    by both packages at ``--batch=2``: (dir, paf, fa, dispatches)."""
    d = tmp_path_factory.mktemp("resume")
    paf, fa = _corpus(d, n=12)
    mp = pytest.MonkeyPatch()
    mp.setenv("PWASM_DEVICE_PROBE", "0")
    try:
        for tag, runner in RUNNERS.items():
            rc, err = runner(paf, fa, d, f"whole_{tag}")
            assert rc == 0, err
    finally:
        mp.undo()
    assert _outs(d, "whole_port") == _outs(d, "whole_ref")
    st = json.loads((d / "whole_port.json").read_text())
    dispatches = sum(st["device"]["by_site"].values())
    assert dispatches >= 4    # the sweep below kills mid-run 4+ times
    return d, paf, fa, dispatches


def _kill(who, paf, fa, d, tag, k, monkeypatch):
    """Kill ``who``'s run at supervised attempt ``k``
    (``--inject-faults=kill=K``); True when it was killed (False: the
    run ended first, rc 0)."""
    if who == "port":
        try:
            rc, err = _port(paf, fa, d, tag, [f"--inject-faults=kill={k}"])
        except PortKill:
            return True
    else:
        try:
            rc, err = _ref(paf, fa, d, tag, [f"--inject-faults=kill={k}"])
        except InjectedKill:
            return True
    assert rc == 0, err
    return False


# ---------------------------------------------------------------------------
# the clean-prefix repair: a batch's finish that raises drops the later
# in-flight batches
# ---------------------------------------------------------------------------
def _fail_second_finish(monkeypatch, module):
    """Make the second report batch's ``finish`` raise OSError once."""
    orig = module.submit_diff_info_batch
    calls = [0]

    def submit(*a, **kw):
        fin = orig(*a, **kw)
        calls[0] += 1
        if calls[0] != 2:
            return fin

        def failing():
            raise OSError("injected write failure")
        return failing

    monkeypatch.setattr(module, "submit_diff_info_batch", submit)
    return calls


def test_failed_finish_leaves_a_clean_prefix(base, monkeypatch):
    from pwasm_tpu.report import device_report as ref_dr
    from pwasm_tpu_torch.report import device_report as port_dr

    d, paf, fa, _n = base
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    for tag, module in (("fail_port", port_dr), ("fail_ref", ref_dr)):
        with monkeypatch.context() as mp:
            calls = _fail_second_finish(mp, module)
            with pytest.raises(OSError, match="injected write failure"):
                RUNNERS[tag[5:]](paf, fa, d, tag)
        assert calls[0] >= 4   # batches 3 and 4 were in flight
    port, ref = ((d / f"fail_{t}.dfa").read_bytes() for t in ("port", "ref"))
    assert port == ref
    # the first batch's two records, a prefix of the whole report
    assert port.count(b"\n>") + port.startswith(b">") == 2
    assert _outs(d, "whole_ref")[0].startswith(port)
    assert _ckpt(d, "fail_port")["records"] \
        == _ckpt(d, "fail_ref")["records"] == 2


# ---------------------------------------------------------------------------
# checkpoint v2 at a kill, and --resume, within and across packages
# ---------------------------------------------------------------------------
KILL_CASES = [("port", "port", k) for k in range(1, 9)] \
    + [("ref", "port", 4), ("port", "ref", 4)]


@pytest.mark.parametrize("kill_by,resume_by,k", KILL_CASES)
def test_kill_then_resume_matches_the_reference(base, tmp_path, monkeypatch,
                                                kill_by, resume_by, k):
    d0, paf, fa, dispatches = base
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    d = tmp_path
    want = _outs(d0, "whole_ref")
    if kill_by == resume_by:
        # both packages killed at K: the same report bytes, the same
        # checkpoint; then each resumes its own run
        tags = {"port": "k_port", "ref": "k_ref"}
        killed = {who: _kill(who, paf, fa, d, tag, k, monkeypatch)
                  for who, tag in tags.items()}
        assert killed["port"] == killed["ref"] == (k <= dispatches)
        assert (d / "k_port.dfa").read_bytes() \
            == (d / "k_ref.dfa").read_bytes()
        ck_p, ck_r = _ckpt(d, "k_port"), _ckpt(d, "k_ref")
        assert (ck_p is None) == (ck_r is None) == (k <= 1 or k > dispatches)
        if ck_p is not None:
            # the same checkpoint, the supervisor's state included
            assert ck_p == ck_r
            assert ck_p["version"] == 2 and ck_p["crc"] == _ckpt_crc(ck_p)
            assert set(ck_p) == {"version", "bytes", "records",
                                 "resilience", "crc"}
            assert ck_p["resilience"]["fault_calls"] > 0
            assert _load_checkpoint(str(d / "k_port.dfa")) \
                == (ck_p["bytes"], ck_p["records"], ck_p["resilience"])
        resume = tags.items()
    else:
        # one package's killed run resumed by the other
        assert _kill(kill_by, paf, fa, d, "x", k, monkeypatch)
        ck = _ckpt(d, "x")
        assert ck is not None and ck["records"] > 0
        assert (ck["crc"] == _ckpt_crc(ck) == ref_ckpt_crc(ck))
        resume = [(resume_by, "x")]
    for who, tag in resume:
        rc, err = RUNNERS[who](paf, fa, d, tag, ["--resume"])
        assert rc == 0, err
        assert _outs(d, tag) == want, (who, tag)
        assert not (d / f"{tag}.dfa.ckpt").exists()
        headers = [ln for ln in (d / f"{tag}.dfa").read_text().splitlines()
                   if ln.startswith(">")]
        assert len(headers) == len(set(headers)) == 12


# ---------------------------------------------------------------------------
# the corruption matrix: quarantine and a clean restart
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("how", ["truncated", "badcrc", "bytes_past_eof",
                                 "mid_record", "legacy_v1"])
def test_corrupt_checkpoint_quarantines_as_the_reference(base, tmp_path,
                                                         monkeypatch, how):
    d0, paf, fa, _n = base
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    dp, dr = tmp_path / "port", tmp_path / "ref"
    assert _kill("port", paf, fa, dp, "c", 5, monkeypatch)
    report = str(dp / "c.dfa")
    _corrupt_ckpt(report + ".ckpt", report, how)
    for ext in ("dfa", "dfa.ckpt"):
        shutil.copy(dp / f"c.{ext}", dr / f"c.{ext}")
    why = _load_checkpoint(report)
    assert isinstance(why, str)
    assert why == ref_load_checkpoint(str(dr / "c.dfa"))
    warn = {}
    for who, dd in (("port", dp), ("ref", dr)):
        rc, err = RUNNERS[who](paf, fa, dd, "c", ["--resume"])
        assert rc == 0, err
        warn[who] = [ln.replace(str(dd), "D") for ln in err.splitlines()
                     if "quarantined" in ln]
        assert not (dd / "c.dfa.ckpt").exists()
        assert _outs(dd, "c") == _outs(d0, "whole_ref")
    assert warn["port"] == warn["ref"] and len(warn["port"]) == 1
    assert why in warn["port"][0]
    assert (dp / "c.dfa.ckpt.bad").read_bytes() \
        == (dr / "c.dfa.ckpt.bad").read_bytes()


# ---------------------------------------------------------------------------
# without a checkpoint: the header scan, and a fresh run's unlink
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("msa", [False, True], ids=["fast_path", "msa"])
def test_header_scan_resume_matches_the_reference(base, tmp_path,
                                                  monkeypatch, msa):
    """A report cut mid-record with no checkpoint: both drop the torn
    last record and skip the rest; without an MSA output the port takes
    the parse-only fast path, with one it extracts and merges every
    alignment and skips only report rows."""
    d0, paf, fa, _n = base
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    whole = (d0 / "whole_ref.dfa").read_bytes()
    cut = whole[:len(whole) * 3 // 5 + 7]
    stats = {}
    for who in ("port", "ref"):
        (tmp_path / f"h_{who}.dfa").write_bytes(cut)
        args = [paf, "-r", fa, "-o", str(tmp_path / f"h_{who}.dfa"),
                "--batch=2", "--resume",
                f"--stats={tmp_path / f'h_{who}.json'}",
                "--device=cpu" if who == "port" else "--device=tpu"]
        if msa:
            args.append(f"-w{tmp_path / f'h_{who}.mfa'}")
        err = io.StringIO()
        rc = (run if who == "port" else ref_run)(args, stderr=err)
        assert rc == 0, err.getvalue()
        assert (tmp_path / f"h_{who}.dfa").read_bytes() == whole
        if msa:
            assert (tmp_path / f"h_{who}.mfa").read_bytes() \
                == (d0 / "whole_ref.mfa").read_bytes()
        stats[who] = json.loads((tmp_path / f"h_{who}.json").read_text())
    keys = ("resumed_past", "alignments", "aligned_bases", "events")
    assert {k: stats["port"][k] for k in keys} \
        == {k: stats["ref"][k] for k in keys}
    assert 0 < stats["port"]["resumed_past"] < 12
    assert stats["port"]["resilience"]["checkpoints"] \
        == stats["ref"]["resilience"]["checkpoints"]


def test_fresh_run_unlinks_a_stale_checkpoint(base, tmp_path, monkeypatch):
    """A run without --resume drops the checkpoint a killed predecessor
    left at its report path before it writes anything: killed at its
    first dispatch, neither package leaves one."""
    _d0, paf, fa, _n = base
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    for who in ("port", "ref"):
        stale = tmp_path / f"s_{who}.dfa.ckpt"
        stale.write_text('{"version": 2, "bytes": 1, "records": 1, '
                         '"crc": 0}')
        assert _kill(who, paf, fa, tmp_path, f"s_{who}", 1, monkeypatch)
        assert not stale.exists()
        assert (tmp_path / f"s_{who}.dfa").read_bytes() == b""


def test_resume_requires_a_report(base, monkeypatch):
    _d0, paf, fa, _n = base
    errs = []
    for runner, dev in ((run, "cpu"), (ref_run, "cpu")):
        err = io.StringIO()
        assert runner([paf, "-r", fa, "--resume", f"--device={dev}"],
                      stdout=io.StringIO(), stderr=err) == 1
        errs.append(err.getvalue().splitlines()[-1])
    assert errs[0] == errs[1] == "--resume requires -o <report>"


# ---------------------------------------------------------------------------
# the durable-write helpers
# ---------------------------------------------------------------------------
def test_durable_helpers_match_the_reference(tmp_path):
    payload = {"bytes": 371, "records": 2, "resilience": {"b": [1, "x"]}}
    assert fsio.payload_crc(payload) == ref_payload_crc(payload)
    dest = tmp_path / "r.dfa.ckpt"
    fsio.write_durable_text(str(dest), "ab", tmp_suffix=".tmp")
    assert dest.read_text() == "ab"
    assert sorted(os.listdir(tmp_path)) == ["r.dfa.ckpt"]
    fsio.write_durable_bytes(str(dest), b"xyz")
    assert dest.read_bytes() == b"xyz"
    fsio.truncate_durable(str(dest), 1)
    assert dest.read_bytes() == b"x"
    # the checkpoint's own tmp name is the reference's
    seen = []
    orig = fsio.write_durable_text

    def spy(dest, text, tmp_suffix=None):
        seen.append(tmp_suffix)
        return orig(dest, text, tmp_suffix)

    (tmp_path / "r.dfa").write_text(">h\n")
    with open(tmp_path / "r.dfa", "a") as f, \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(fsio, "write_durable_text", spy)
        assert port_cli._write_checkpoint(f, str(tmp_path / "r.dfa"), 1)
    assert seen == [".tmp"]
    ck = json.loads(dest.read_text())
    assert ck == {"version": 2, "bytes": 3, "records": 1,
                  "crc": ref_ckpt_crc(ck)}
    assert _load_checkpoint(str(tmp_path / "r.dfa")) == (3, 1, None)
    assert ref_load_checkpoint(str(tmp_path / "r.dfa")) == (3, 1, None)
