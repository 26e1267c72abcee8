"""The port's device leases (``pwasm_tpu_torch/service/leases.py``), its
CLI's lane pool and scope over CUDA devices, and the ``inspect`` verb's
flight record.

A selection of ``tests/test_leases.py`` and ``tests/test_flight.py``,
one case a contract: FIFO grants, the drain, the lane's own supervisor
state, the clamped pool and its warning over a monkeypatched CUDA
inventory, the scope entering the lane's device on each worker thread,
and a finished job's flight record from RAM and from the spool.
"""

import io
import threading
import time

import pytest
import torch

from pwasm_tpu.service.leases import LeaseManager as RefLeaseManager
from pwasm_tpu_torch import cli as cli_mod
from pwasm_tpu_torch.core.config import Config
from pwasm_tpu_torch.parallel import mesh as pm
from pwasm_tpu_torch.service.client import ServiceClient
from pwasm_tpu_torch.service.daemon import _JobWarm
from pwasm_tpu_torch.service.leases import DeviceLease, LeaseManager

from test_torch_service import _cold, _corpus, _daemon, _job_args


def test_lanes_partition_the_device_indices_as_the_reference():
    for lanes, per in ((4, 2), (3, 1)):
        got = [lease.devices for lease in LeaseManager(lanes, per).leases()]
        want = [lease.devices
                for lease in RefLeaseManager(lanes, per).leases()]
        assert got == want


def test_fifo_grant_order_no_starvation():
    """Grants go to waiters strictly in arrival order."""
    lm = LeaseManager(1)
    first = lm.acquire()
    order: list[int] = []
    started = []

    def waiter(k):
        started.append(k)
        lease = lm.acquire(timeout=10)
        order.append(k)
        time.sleep(0.01)
        lm.release(lease)

    threads = []
    for k in range(5):
        t = threading.Thread(target=waiter, args=(k,))
        threads.append(t)
        t.start()
        while k not in started:
            time.sleep(0.001)
        time.sleep(0.02)
    assert lm.waiting_count() == 5
    lm.release(first)
    for t in threads:
        t.join(10)
    assert order == [0, 1, 2, 3, 4]
    assert lm.wait_s_total > 0


def test_drain_wakes_waiters_and_rejects_new_acquires():
    lm = LeaseManager(1)
    held = lm.acquire()
    got: list = ["sentinel"]

    def waiter():
        got[0] = lm.acquire(timeout=10)

    t = threading.Thread(target=waiter)
    t.start()
    while lm.waiting_count() == 0:
        time.sleep(0.001)
    lm.drain()
    t.join(5)
    assert got[0] is None
    lm.release(held)
    assert lm.acquire(timeout=0.05) is None


def test_lane_state_rides_its_lease():
    """A job's warm view reads and writes the supervisor state on ITS
    lease: lane 0's open breaker is lane 0's alone, the roll-up is the
    worst lane, and the device span shows only when asked."""
    lm = LeaseManager(2)
    a, b = lm.acquire(), lm.acquire()
    wa = _JobWarm(None, a, expose_devices=True)
    wb = _JobWarm(None, b)
    assert wa.lease_devices == a.devices and wb.lease_devices is None
    wa.supervisor_state = {"breaker_open": True}
    assert a.supervisor_state == {"breaker_open": True}
    assert wb.supervisor_state is None and a.monitor is None
    assert [r["breaker_state"] for r in lm.lane_states()] == [2, 0]
    assert lm.breaker_rollup() == 2
    lm.release(a)
    lm.release(b)
    assert isinstance(DeviceLease(3, 6, 8).devices, tuple)


def _cuda(n):
    return [torch.device("cuda", k) for k in range(n)]


@pytest.mark.parametrize("n_dev,span,want,warned", [
    (4, (2, 4), [2, 3], False),        # a lane on its own cards
    (1, (1, 2), [0], False),           # one card: every lane on cuda:0
    (2, (2, 4), [0], True),            # two cards, lanes past them
    (3, (1, 4), [1, 2], True)])        # a span cut at the last card
def test_lane_device_pool_clamps_and_warns(monkeypatch, n_dev, span, want,
                                           warned):
    monkeypatch.setattr(pm, "visible_devices", lambda: _cuda(n_dev))
    err = io.StringIO()
    pool = cli_mod._lane_device_pool(span, err)
    assert [d.index for d in pool] == want
    assert ("oversubscribes" in err.getvalue()) == warned


def test_lane_device_scope_enters_each_threads_lane(monkeypatch):
    """The scope makes the lane's first device the current CUDA device
    of the thread that runs the job, for the job's extent: two worker
    threads on two lanes enter two devices.  It is inert for a cold
    run, a --device=cpu job and a single-lane daemon."""
    monkeypatch.setattr(pm, "visible_devices", lambda: _cuda(2))
    entered: list = []

    class FakeDevice:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append((threading.get_ident(), self.dev.index))

        def __exit__(self, *exc):
            entered.append((threading.get_ident(), None))

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    cfg = Config()
    cfg.device = "cuda"
    lm = LeaseManager(2)
    seen: dict = {}
    barrier = threading.Barrier(2)

    def worker(k):
        warm = _JobWarm(None, lm.acquire(), expose_devices=True)
        with cli_mod._lane_device_scope(cfg, warm, io.StringIO()) as pool:
            barrier.wait(5)
            seen[threading.get_ident()] = [d.index for d in pool]

    ts = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert sorted(seen.values()) == [[0], [1]]
    for tid, pool in seen.items():
        assert [i for t, i in entered if t == tid] == [pool[0], None]
    entered.clear()
    cpu = Config()
    cpu.device = "cpu"
    lease_warm = _JobWarm(None, DeviceLease(0, 0, 1), expose_devices=True)
    for c, warm in ((cfg, None), (cpu, lease_warm),
                    (cfg, _JobWarm(None, DeviceLease(0, 0, 1)))):
        with cli_mod._lane_device_scope(c, warm) as pool:
            assert pool is None
    assert entered == []


def test_shard_in_a_lease_spans_its_lane(tmp_path, monkeypatch):
    """``--shard`` inside a leased job builds its mesh from the lane's
    pool: asking for more devices than the lease holds names the lease,
    and a lane of the pool runs to the cold run's bytes (the pool's
    entries are the CPU here, as in ``test_torch_cli_shard.py``)."""
    from pwasm_tpu_torch import device as devmod

    cpu = torch.device("cpu")
    real = devmod.resolve_device
    monkeypatch.setattr(devmod, "resolve_device",
                        lambda name, stats=None: cpu if name == "cuda"
                        else real(name, stats))
    monkeypatch.setattr(pm, "visible_devices", lambda: [cpu] * 4)
    monkeypatch.setenv("PWASM_DEVICE_PROBE", "0")
    paf, fa = _corpus(tmp_path, n=8)
    cold = _cold(tmp_path, "cold", paf, fa)
    lm = LeaseManager(2, devices_per_lease=2)
    lm.acquire()
    warm = _JobWarm(None, lm.acquire(), expose_devices=True)
    args = [a.replace("--device=cpu", "--device=cuda")
            for a in _job_args(tmp_path, "sh", paf, fa)]
    err = io.StringIO()
    assert cli_mod.run(args + ["--shard=3"], stderr=err, warm=warm) == 1
    assert "the job's device lease holds 2" in err.getvalue()
    err = io.StringIO()
    assert cli_mod.run(args + ["--shard", "-v"], stderr=err,
                       warm=warm) == 0, err.getvalue()
    assert "sharding over mesh" in err.getvalue()
    assert (tmp_path / "sh.dfa").read_bytes() == cold


@pytest.mark.parametrize("spool", [False, True])
def test_inspect_a_finished_jobs_flight_record(tmp_path, spool):
    """``inspect`` answers a finished job's flight record: its trace_id,
    the accounted phases (queue wait, lease wait, exec) covering the
    job's wall, the run's own spans inside; from the CRC-verified spool
    once the result moved there."""
    paf, fa = _corpus(tmp_path, n=6)
    kw = dict(spool_threshold_bytes=1, spool_dir=str(tmp_path / "sp")) \
        if spool else {}
    with _daemon(journal_path=None, **kw) as h:
        with ServiceClient(h.sock, trace_id="drill.9") as c:
            sub = c.submit(_job_args(tmp_path, "fl", paf, fa))
            assert c.result(sub["job_id"], timeout=60)["rc"] == 0
            rec = c.inspect(sub["job_id"])
    assert rec["ok"] and "spool_error" not in rec
    assert rec["trace_id"] == "drill.9"
    fl = rec["flight"]
    assert {"queue_wait", "lease_wait", "exec", "run", "input_loop",
            "msa_tail"} <= set(fl["phases"])
    assert fl["coverage"] >= 0.9
    assert fl["trace_id"] == "drill.9"
    assert (tmp_path / "sp").is_dir() == spool
