"""The port's batch supervisor, fault injection and guardrails
(``pwasm_tpu_torch/resilience/``) against the JAX package's.

The units of the reference's tests/test_resilience.py, each run on both
packages' classes with the same scripted attempts: the fault plans draw
the same sequence from the same spec, and the supervisors end with the
same counters and the same exported state.  The port has one policy,
``--fallback=fail``: where the reference degrades (``DeviceWorkFailed``
or a fallback callable), the port raises ``ResilienceError``; the
reference runs here with ``fallback="fail"`` too.
"""

import io
import time

import numpy as np
import pytest
import torch

from pwasm_tpu.resilience import BatchSupervisor as RefSupervisor
from pwasm_tpu.resilience import BisectableBatch as RefBisectable
from pwasm_tpu.resilience import ResilienceError as RefResilienceError
from pwasm_tpu.resilience import ResiliencePolicy as RefPolicy
from pwasm_tpu.resilience import is_oom_error as ref_is_oom_error
from pwasm_tpu.resilience import parse_fault_spec as ref_parse_fault_spec
from pwasm_tpu.resilience import guardrails as ref_guardrails
from pwasm_tpu.utils.runstats import RunStats as RefRunStats
from pwasm_tpu_torch.ops import banded_dp
from pwasm_tpu_torch.resilience import (BatchSupervisor, BisectableBatch,
                                        GuardrailViolation, InjectedKill,
                                        ResilienceError, ResiliencePolicy,
                                        is_oom_error, parse_fault_spec)
from pwasm_tpu_torch.resilience import guardrails
from pwasm_tpu_torch.utils.runstats import RunStats

PKGS = {"port": (BatchSupervisor, ResiliencePolicy, RunStats,
                 BisectableBatch, ResilienceError),
        "ref": (RefSupervisor, RefPolicy, RefRunStats, RefBisectable,
                RefResilienceError)}


def _sup(who, probe=None, faults=None, **kw):
    """A supervisor of ``who``'s package with a fast backoff and the
    fail policy; returns (supervisor, its RunStats)."""
    sup_cls, pol_cls, st_cls, _b, _e = PKGS[who]
    kw.setdefault("backoff_s", 0.001)
    kw.setdefault("backoff_cap_s", 0.002)
    st = st_cls()
    extra = {"fallback": "fail"} if who == "ref" else {}
    return sup_cls(pol_cls(**kw, **extra), stats=st, stderr=io.StringIO(),
                   probe=probe, faults=faults), st


def _counters(st) -> dict:
    """The ``--stats`` blocks a supervisor writes, walls left out."""
    d = st.as_dict()
    dev = {k: v for k, v in d["device"].items()
           if k not in ("compile_s", "steady_s")}
    return dict(resilience=d["resilience"], device=dev)


def _both(script, **kw):
    """Run ``script(sup, err_cls)`` on each package's supervisor and
    return {who: (result, counters, exported state)}."""
    out = {}
    for who in PKGS:
        sup, st = _sup(who, **kw)
        out[who] = (script(sup, PKGS[who][4], PKGS[who][3]), _counters(st),
                    sup.export_state())
    return out


# ---------------------------------------------------------------------------
# fault plan: spec parsing, determinism, equal to the reference's
# ---------------------------------------------------------------------------
def test_fault_spec_parsing():
    spec = ("seed=7,rate=0.3,kinds=raise+corrupt,sites=ctx_scan+realign,"
            "hang_s=1.5,kill=9,preempt=4,oom=64,down=2-4+9-9")
    p = parse_fault_spec(spec)
    assert p.seed == 7 and p.rate == 0.3
    assert p.kinds == ("raise", "corrupt")
    assert p.sites == frozenset({"ctx_scan", "realign"})
    assert p.hang_s == 1.5 and p.kill == 9 and p.preempt == 4
    assert p.oom == 64 and p.down == ((2, 4), (9, 9))
    # the "fault injection armed" line prints this repr in both
    assert repr(p) == repr(ref_parse_fault_spec(spec))
    d = parse_fault_spec("rate=1")
    assert d.seed == 0 and len(d.kinds) == 4 and d.sites is None


@pytest.mark.parametrize("bad", ["rate=2", "rate=x", "kinds=explode",
                                 "kinds=", "nonsense", "seed=1.5",
                                 "hang_s=-1", "kill=-2", "frob=1",
                                 "down=3-2", "oom=-1"])
def test_fault_spec_rejects(bad):
    with pytest.raises(ValueError) as port:
        parse_fault_spec(bad)
    with pytest.raises(ValueError) as ref:
        ref_parse_fault_spec(bad)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("spec", [
    "seed=3,rate=0.5", "seed=7,rate=0.3,kinds=raise+nan+corrupt",
    "seed=4,rate=0.25,kinds=hang,hang_s=3", "seed=9,rate=1,sites=realign",
    "rate=0.6,down=3-5"])
def test_fault_draws_deterministic_and_seeded(spec):
    sites = ("ctx_scan", "realign", "consensus", "refine", "many2many")
    a, b, ref = (parse_fault_spec(spec), parse_fault_spec(spec),
                 ref_parse_fault_spec(spec))
    seq = []
    for k in range(60):
        site = sites[k * 7 % 5]
        for plan in (a, b, ref):
            plan.note_call()
        got = [plan.draw(site) for plan in (a, b, ref)]
        assert got[0] == got[1] == got[2], (k, site, got)
        seq.append(got[0])
    assert any(seq), "the spec must inject within 60 draws"
    other = parse_fault_spec(spec.replace("seed=", "seed=1") if "seed="
                             in spec else "seed=5," + spec)
    assert seq != [other.draw(sites[k * 7 % 5]) or other.note_call()
                   for k in range(60)]
    # sites= restricts injection but still advances the counters
    r = parse_fault_spec("seed=3,rate=1,sites=other")
    assert [r.draw("s") for _ in range(5)] == [None] * 5


@pytest.mark.parametrize("kind", ["nan", "corrupt"])
def test_corrupt_equals_the_reference(kind):
    """``corrupt`` picks the same leaf and writes the same garbage in
    both packages, on a copy: the inputs are never written."""
    rng = np.random.default_rng(5)
    res = (rng.integers(0, 9, 40).astype(np.int32),
           rng.integers(0, 3, (4, 10)).astype(np.int8),
           rng.random(12).astype(np.float32), np.ones(3, dtype=bool))
    keep = [x.copy() for x in res]
    for seed in range(12):
        spec = f"seed={seed},rate=1,kinds={kind}"
        got = parse_fault_spec(spec).corrupt(res, "realign", kind)
        want = ref_parse_fault_spec(spec).corrupt(res, "realign", kind)
        for g, w in zip(got, want):
            assert np.array_equal(g, w, equal_nan=True)
    for x, k in zip(res, keep):
        assert np.array_equal(x, k)


def test_fault_kill_is_uncatchable_by_supervisor():
    plan = parse_fault_spec("kill=3")
    sup, _st = _sup("port", faults=plan, max_retries=5)
    sup.run("s", lambda: 1)
    sup.run("s", lambda: 2)
    with pytest.raises(InjectedKill):
        sup.run("s", lambda: 3)
    assert issubclass(InjectedKill, BaseException) \
        and not issubclass(InjectedKill, Exception)


# ---------------------------------------------------------------------------
# supervisor: retry / guardrail / deadline / breaker / policy
# ---------------------------------------------------------------------------
def test_supervisor_retries_then_succeeds():
    def script(sup, _err, _b):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return "ok"

        assert sup.run("s", flaky) == "ok"
        assert sup.consecutive("s") == 0   # success resets the window
        return len(calls)

    got = _both(script, max_retries=3)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 3
    assert got["port"][1]["resilience"]["retries"] == 2


def test_supervisor_guardrail_reject_reexecutes():
    def script(sup, _err, _b):
        results = iter([np.array([99]), np.array([1])])

        def validate(r):
            if r[0] > 10:
                raise (GuardrailViolation if sup.__class__ is
                       BatchSupervisor else
                       ref_guardrails.GuardrailViolation)("out of range")

        return int(sup.run("s", lambda: next(results),
                           validate=validate)[0])

    got = _both(script, max_retries=2)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1
    res = got["port"][1]["resilience"]
    assert res["guardrail_rejects"] == 1 and res["retries"] == 1


def test_supervisor_deadline_timeout():
    sup, st = _sup("port", max_retries=1, deadline_s=0.05)
    with pytest.raises(ResilienceError) as ei:
        sup.run("s", lambda: time.sleep(0.5))
    assert st.res_deadline_timeouts == 2   # initial attempt + 1 retry
    assert "DeadlineExceeded: s: batch exceeded the 0.05s device " \
        "deadline" in str(ei.value)
    # a slow attempt inside the deadline returns its result
    sup, st = _sup("port", max_retries=0, deadline_s=2.0)
    assert sup.run("s", lambda: time.sleep(0.01) or "late") == "late"
    assert st.res_deadline_timeouts == 0


def test_supervisor_breaker_opens_on_unhealthy_probe():
    def script(sup, err_cls, _b):
        calls = []

        def dead():
            calls.append(1)
            raise RuntimeError("boom")

        for _ in range(3):
            with pytest.raises(err_cls):
                sup.run("s", dead)
        assert sup.breaker_open
        n = len(calls)
        # breaker open: the device is never touched again, and the
        # port's one policy aborts
        with pytest.raises(err_cls) as ei:
            sup.run("s", dead)
        assert "circuit breaker open" in str(ei.value)
        return len(calls) == n

    got = _both(script, probe=lambda: (False, "card gone"),
                max_retries=0, breaker_threshold=3)
    assert got["port"] == got["ref"]
    assert got["port"][0] is True
    res = got["port"][1]["resilience"]
    assert res["breaker_trips"] == 1 and res["fallbacks"] == 0


def test_supervisor_breaker_half_opens_on_healthy_probe():
    def script(sup, err_cls, _b):
        for _ in range(2):
            with pytest.raises(err_cls):
                sup.run("s", lambda: (_ for _ in ()).throw(
                    RuntimeError("computational")))
        assert not sup.breaker_open
        return sup.run("s", lambda: "fine")

    got = _both(script, probe=lambda: (True, ""), max_retries=0,
                breaker_threshold=2)
    assert got["port"] == got["ref"]
    assert got["port"][0] == "fine"
    assert got["port"][1]["resilience"]["breaker_trips"] == 0
    assert got["port"][2]["half_opens"] == {"s": 1}


def test_supervisor_per_site_windows_and_thresholds():
    def script(sup, err_cls, _b):
        with pytest.raises(err_cls):
            sup.run("realign", lambda: (_ for _ in ()).throw(
                RuntimeError("x")))
        seen = [sup.consecutive("realign"), sup.consecutive("ctx_scan")]
        for _ in range(2):
            with pytest.raises(err_cls):
                sup.run("ctx_scan", lambda: (_ for _ in ()).throw(
                    RuntimeError("y")))
        return seen + [sup.consecutive("ctx_scan"),
                       sup.consecutive("realign")]

    got = _both(script, probe=lambda: (True, ""), max_retries=0,
                breaker_threshold=5, site_thresholds={"ctx_scan": 2})
    assert got["port"] == got["ref"]
    # failures at one site charge no other; ctx_scan's threshold of 2
    # half-opened it (window reset)
    assert got["port"][0] == [1, 0, 0, 1]


def test_supervisor_site_breaker_trips_on_repeated_half_opens():
    def script(sup, err_cls, _b):
        calls = []

        def bad():
            calls.append(1)
            raise RuntimeError("miscompiled")

        for _ in range(4):   # 2 windows of 2 failures -> 2 half-opens
            with pytest.raises(err_cls):
                sup.run("refine", bad)
        assert sup.site_breaker_open("refine") and not sup.breaker_open
        n = len(calls)
        with pytest.raises(err_cls):
            sup.run("refine", bad)      # the tripped site aborts at once
        return len(calls) == n, sup.run("consensus", lambda: "dev")

    got = _both(script, probe=lambda: (True, ""), max_retries=0,
                breaker_threshold=2, site_trip_limit=2)
    assert got["port"] == got["ref"]
    assert got["port"][0] == (True, "dev")
    res = got["port"][1]["resilience"]
    assert res["breaker_trips"] == 0 and res["site_breaker_trips"] == 1


def test_supervisor_fallback_fail_policy_is_fatal():
    sup, _st = _sup("port", max_retries=0)
    with pytest.raises(ResilienceError) as ei:
        sup.run("s", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert ei.value.exit_code == 1
    assert str(ei.value) == ("Error: device work 's' failed and "
                             "--fallback=fail forbids degrading "
                             "(RuntimeError: x)\n")
    # the reference's degradation policy does not exist in the port
    with pytest.raises(ValueError):
        ResiliencePolicy(fallback="cpu")
    assert ResiliencePolicy().fallback == "fail"


# ---------------------------------------------------------------------------
# OOM: classification, bisection, the ceiling's demotion and re-promotion
# ---------------------------------------------------------------------------
def test_oom_classifier_equals_the_reference():
    cases = [RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
             torch.cuda.OutOfMemoryError("CUDA out of memory."),
             RuntimeError("fwdptr kernel launch failed: CUDA error 2: out "
                          "of memory"),
             RuntimeError("RESOURCE_EXHAUSTED: while allocating"),
             RuntimeError("failed to allocate 10 bytes"),
             RuntimeError("illegal memory access"), ValueError("oom"),
             None]
    assert [is_oom_error(e) for e in cases] \
        == [ref_is_oom_error(e) for e in cases] \
        == [True, True, True, True, True, False, False, False]


def _oom_script(limit: int, n: int = 37):
    """A bisectable batch of ``n`` items whose attempt fails with an
    allocator-shaped error above ``limit`` items."""
    def script(sup, _err, bis_cls):
        sizes = []

        def attempt_for(items):
            sizes.append(len(items))
            if len(items) > limit:
                raise RuntimeError(f"CUDA out of memory ({len(items)})")
            return [x * 2 for x in items]

        items = list(range(n))
        got = sup.run("ctx_scan", lambda: attempt_for(items),
                      bisect=bis_cls(
                          items=items, attempt_for=attempt_for,
                          combine=lambda parts: [y for _i, r in parts
                                                 for y in r],
                          validate_for=lambda r, it: None))
        assert got == [x * 2 for x in items]
        return sizes, sup.bucket_ceiling

    return script


def test_oom_bisection_equals_the_reference():
    got = _both(_oom_script(limit=5), max_retries=2)
    assert got["port"] == got["ref"]
    sizes, ceiling = got["port"][0]
    # 37 -> 19 + 18 -> 10 + 9 ... : the failing sizes' buckets 64, 32
    # and 16 demote the ceiling to 32, 16 and 8
    assert sizes[0] == 37 and max(s for s in sizes if s <= 5) == 5
    assert ceiling == 8
    res = got["port"][1]["resilience"]
    assert res["oom_events"] == res["batch_splits"] == 7
    assert res["bucket_demotions"] == 3 and res["retries"] == 0
    assert res["breaker_trips"] == 0


def test_oom_at_the_floor_aborts():
    def script(sup, err_cls, bis_cls):
        with pytest.raises(err_cls) as ei:
            sup.run("ctx_scan", lambda: (_ for _ in ()).throw(
                RuntimeError("out of memory")),
                bisect=bis_cls(items=[1], attempt_for=None,
                               combine=None))
        return "out of memory" in str(ei.value)

    got = _both(script)
    assert got["port"] == got["ref"]
    assert got["port"][0] is True


def test_ceiling_demotion_and_repromotion():
    """After an OOM at 16 items demotes the ceiling to 4, clean flushes
    that fill it (more than half the ceiling) raise it a pow2 step
    every ``repromote_after`` of them, back to None at the bucket that
    failed."""
    def script(sup, _err, bis_cls):
        _oom_script(limit=5, n=16)(sup, _err, bis_cls)
        ceilings = [sup.bucket_ceiling]
        for size in (3, 3, 1, 3, 4, 5, 5, 8):
            sup.run("ctx_scan", lambda: None, size=size)
            ceilings.append(sup.bucket_ceiling)
        return ceilings

    got = _both(script, repromote_after=2)
    assert got["port"] == got["ref"]
    assert got["port"][0] == [4, 4, 8, 8, 8, 8, 8, None, None]
    assert got["port"][1]["resilience"]["bucket_repromotions"] == 2


# ---------------------------------------------------------------------------
# checkpointed state
# ---------------------------------------------------------------------------
def test_export_restore_round_trip_across_packages():
    def script(sup, err_cls, bis_cls):
        _oom_script(limit=5)(sup, err_cls, bis_cls)
        for _ in range(2):
            with pytest.raises(err_cls):
                sup.run("realign", lambda: (_ for _ in ()).throw(
                    RuntimeError("x")))
        return None

    plans = {who: pkg("seed=1,rate=0.2,kinds=raise")
             for who, pkg in (("port", parse_fault_spec),
                              ("ref", ref_parse_fault_spec))}
    states = {}
    for who in PKGS:
        sup, _st = _sup(who, probe=lambda: (True, ""), faults=plans[who],
                        max_retries=0, breaker_threshold=2)
        try:
            script(sup, PKGS[who][4], PKGS[who][3])
        except (ResilienceError, RefResilienceError):
            pass
        states[who] = sup.export_state()
    assert states["port"] == states["ref"]
    st = states["port"]
    # an injected raise aborted the bisection after its first demotion
    assert st["bucket_ceiling"] == 32 and st["fault_calls"] > 0
    # each package restores what the other exported, field for field
    for src, dst in (("port", "ref"), ("ref", "port"), ("port", "port")):
        plan = (parse_fault_spec if dst == "port"
                else ref_parse_fault_spec)("seed=1")
        sup, _st = _sup(dst, faults=plan)
        sup.restore_state(states[src])
        assert sup.export_state() == states[src], (src, dst)
    # a malformed field drops only itself
    sup, _st = _sup("port", faults=parse_fault_spec("seed=1"))
    sup.restore_state(dict(st, half_opens="garbage", bucket_ceiling=16))
    got = sup.export_state()
    assert got["half_opens"] == {} and got["bucket_ceiling"] == 16
    assert got["fault_calls"] == st["fault_calls"]


def test_restored_open_breaker_aborts_without_touching_the_device():
    sup, st = _sup("port")
    sup.restore_state({"breaker_open": True})
    calls = []
    with pytest.raises(ResilienceError, match="circuit breaker open"):
        sup.run("ctx_scan", lambda: calls.append(1))
    assert not calls and st.res_degraded_batches == 1


# ---------------------------------------------------------------------------
# guardrails: the reference's checks, copied
# ---------------------------------------------------------------------------
def _raises(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except (GuardrailViolation, ref_guardrails.GuardrailViolation) as e:
        return str(e)
    return None


def test_guardrail_consensus_conservation():
    rng = np.random.default_rng(0)
    pile = rng.integers(0, 7, (16, 64)).astype(np.int8)
    counts = np.stack([(pile == k).sum(0) for k in range(6)],
                      axis=1).astype(np.int32)
    chars = np.full(64, ord("A"), dtype=np.int64)
    bad = counts.copy()
    bad[5, 2] += 1                           # breaks conservation
    weird = chars.copy()
    weird[0] = ord("Z")                      # outside the alphabet
    for args in ((chars, counts, pile), (chars, bad, pile),
                 (weird, counts, pile)):
        assert _raises(guardrails.check_consensus, *args) \
            == _raises(ref_guardrails.check_consensus, *args)
    assert _raises(guardrails.check_consensus, chars, counts, pile) is None
    assert _raises(guardrails.check_consensus, chars, bad, pile)
    assert _raises(guardrails.check_consensus, weird, counts, pile)


def test_guardrail_realign_conservation():
    from pwasm_tpu_torch.ops.realign import banded_realign_rows

    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, 24).astype(np.int8)
    t = rng.integers(0, 4, 24).astype(np.int8)
    q_lens = np.array([24], dtype=np.int32)
    t_lens = np.array([24], dtype=np.int32)
    res = tuple(x.numpy() for x in banded_realign_rows(
        *(torch.from_numpy(x) for x in (q[None, :], t[None, :], q_lens,
                                        t_lens)), band=8))
    kw = dict(q_lens=q_lens, t_lens=t_lens, match_score=1)
    assert _raises(guardrails.check_realign, *res, **kw) is None
    scores, leads, iy, ops, ok = [x.copy() for x in res]
    iy[0, 3] += 2                            # fake target consumption
    bad = (scores, leads, iy, ops, ok)
    assert _raises(guardrails.check_realign, *bad, **kw) \
        == _raises(ref_guardrails.check_realign, *bad, **kw) is not None


def test_corrupted_outputs_always_caught_or_harmless():
    """Every corrupt/nan injection into a ctx_scan-shaped output dict is
    either rejected by the guardrail or lands outside the live rows the
    report reads, and the port's verdict is the reference's."""
    n_events, pad = 4, 64
    host = {
        "aa": np.full(pad, ord("M"), dtype=np.uint8),
        "aapos": np.arange(pad, dtype=np.int32) % 7,
        "hpoly": np.zeros(pad, dtype=bool),
        "motif": np.ones(pad, dtype=np.int32),
        "stop_aapos": np.full(pad, -1, dtype=np.int32),
        "s_aapos": np.zeros((pad, 3), dtype=np.int32),
    }
    kw = dict(ref_len=30, n_motifs=4, skip_codan=False)
    assert _raises(guardrails.check_ctx_scan, host, n_events, **kw) is None
    caught = harmless = 0
    for seed in range(30):
        spec = f"seed={seed},rate=1,kinds=corrupt"
        bad = parse_fault_spec(spec).corrupt(
            {k: v.copy() for k, v in host.items()}, "ctx_scan", "corrupt")
        ref_bad = ref_parse_fault_spec(spec).corrupt(
            {k: v.copy() for k, v in host.items()}, "ctx_scan", "corrupt")
        assert all(np.array_equal(bad[k], ref_bad[k]) for k in host)
        assert any((bad[k] != host[k]).any() for k in host)
        why = _raises(guardrails.check_ctx_scan, bad, n_events, **kw)
        assert why == _raises(ref_guardrails.check_ctx_scan, ref_bad,
                              n_events, **kw)
        if why is None:
            # passed validation: the live prefix must be untouched
            for k in host:
                assert (np.asarray(bad[k])[:n_events]
                        == host[k][:n_events]).all(), k
            harmless += 1
        else:
            caught += 1
    assert caught > 0


# ---------------------------------------------------------------------------
# check_launch names the CUDA error (the OOM classifier reads it)
# ---------------------------------------------------------------------------
class _FakeCudart:
    """torch's ``_cudart`` binding as far as ``cuda_error_text`` reads it:
    the CUDA runtime's strings of the codes a launcher returns."""

    TEXT = {1: "invalid argument", 2: "out of memory",
            700: "an illegal memory access was encountered"}

    def cudaError(self, rc):
        return rc

    def cudaGetErrorString(self, err):
        return self.TEXT[err]


@pytest.mark.parametrize("rc,oom", [(2, True), (1, False), (700, False)])
def test_check_launch_names_the_cuda_error(monkeypatch, rc, oom):
    monkeypatch.setattr(torch.cuda, "cudart", lambda: _FakeCudart())
    banded_dp.check_launch(0, "walk")           # success: no raise
    with pytest.raises(RuntimeError) as ei:
        banded_dp.check_launch(rc, "walk")
    assert str(ei.value) == (f"walk kernel launch failed: CUDA error "
                             f"{rc}: {_FakeCudart.TEXT[rc]}")
    assert is_oom_error(ei.value) is oom
    # a launch OOM is bisected, not retried at the same shape
    sup, st = _sup("port", max_retries=3)
    with pytest.raises(ResilienceError):
        sup.run("realign", lambda: banded_dp.check_launch(rc, "fwdptr"))
    assert (st.res_oom_events, st.res_retries) \
        == ((1, 0) if oom else (0, 3))
