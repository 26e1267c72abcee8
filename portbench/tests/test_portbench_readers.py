"""The metric arithmetic on recorded fixtures."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, readers


def rec(client, t_done, work=200, rc=0, wall=0.5, run=0.4, host=None):
    return dict(client=client, t_done=t_done, work=work, rc=rc,
                wall_s=wall, key=0,
                stats={"wall_s": run, "host": host or {}})


def test_rate_sums_each_clients_own_window():
    ctx = SimpleNamespace(t0=10.0, client_ends={0: 14.0, 1: 12.0},
                          client_begins={0: 10.0, 1: 10.0},
                          records=[rec(0, 12.0), rec(0, 14.0),
                                   rec(1, 12.0), rec(1, 12.0, rc=1)])
    # client 0: 400 over 4 s; client 1: 200 over 2 s (the failed job's
    # work does not count, its time does)
    assert readers.rate(ctx) == pytest.approx(100.0 + 100.0)
    ctx.client_begins[1] = 11.0        # a client's own window
    assert readers.rate(ctx) == pytest.approx(100.0 + 200.0)


def test_served_overhead_and_host_stages():
    ctx = SimpleNamespace(records=[
        rec(0, 1, wall=0.50, run=0.45,
            host={"parse_s": 0.01, "extract_s": 0.02}),
        rec(0, 2, wall=0.70, run=0.60,
            host={"parse_s": 0.03, "extract_s": 0.04})])
    assert readers.served_overhead_ms(ctx) == pytest.approx(75.0)
    assert readers.host_stage_ms(ctx, ("parse_s", "extract_s")) == \
        pytest.approx(50.0)


def test_percentile_needs_ten_beyond():
    v = list(range(1, 101))            # 100 samples: p90 is 90, 10 beyond
    assert readers.percentile(v, 0.90) == 90
    assert readers.percentile(v[:99], 0.90) is None
    assert readers.percentile([], 0.90) is None


def test_idle_share_from_intervals():
    dev = [(0.0, 1.0, "k", "kernel"), (0.5, 1.0, "k", "kernel"),
           (3.0, 0.5, "c", "gpu_memcpy")]
    busy = harness.union_seconds(dev)
    assert busy == pytest.approx(2.0)
    ctx = SimpleNamespace(trace=dict(busy_s=busy, window_s=8.0))
    assert readers.idle_pct(ctx) == pytest.approx(75.0)
    b = harness.breakdown(dict(device=dev, host=[(1.6, 1.0, "aten::mm")]),
                          0.0, 8.0)
    assert b["device_ops"][0] == ["k", 2.0]
    assert b["idle_gaps"][0] == ["host outside torch ops", 4.5]
    assert b["idle_gaps"][1] == ["aten::mm", 1.5]


def test_short_kernel_names():
    n = ("void (anonymous namespace)::scores_subwarp_kernel<8, 8, false>"
         "(signed char const*, int)")
    assert harness.short_name(n) == "scores_subwarp_kernel<8, 8, false>"


def test_scores_least_work_by_hand(tmp_path):
    """Two queries of 6 bases, targets of 5, 6 and 40 bases, band 4: the
    40-base target is out of band; the others are in the two width groups
    (t <= m at width 6, t > m none), so one dispatch of Q=2, T=2: cells
    2*2*6*4 = 96, operations 8*96, bytes 2*6 + 2*(6+4) + 4*2*2."""
    bench = harness.with_held(harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json")))
    plan = harness.cell_plan(bench, "m2m-config3-c1")
    codes = lambda s: np.frombuffer(s.encode(), np.uint8) % 4
    inputs = SimpleNamespace(corpora=[SimpleNamespace(
        queries=[("q0", codes("ACGTAC")), ("q1", codes("GGTACA"))],
        targets=[("t0", codes("ACGTA")), ("t1", codes("ACGTAC")),
                 ("t2", codes("A" * 40))])], work={})
    ops, nbytes = plan.driver.kernel_work(dict(band=4), {}, inputs,
                                          0)["scores"]
    assert ops == 8 * 96
    assert nbytes == 12 + 20 + 16


def test_roofline_share():
    class Drv:
        @staticmethod
        def kernel_work(cfg, traffic, inputs, key):
            return {"scores": (33.5e12 * 0.001, 1.0)}   # 1 ms of ops
    ctx = SimpleNamespace(
        plan=SimpleNamespace(driver=Drv, config={}, traffic={}),
        inputs=None, peaks={"int_ops_per_s": 33.5e12,
                            "hbm_bytes_per_s": 3.35e12},
        records=[rec(0, 1), rec(0, 2)],
        trace=dict(device=[(0.0, 0.004, "void scores_kernel<1>()",
                            "kernel"),
                           (0.01, 0.5, "other", "kernel")]))
    assert readers.roofline_pct(ctx, "scores", ("scores_kernel",)) == \
        pytest.approx(50.0)
