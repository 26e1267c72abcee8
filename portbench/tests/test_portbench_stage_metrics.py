"""The stage-table readers (``metrics/*_ms.pafreport.py``,
``metrics/realign_yield_pct.pafreport.py``) on recorded fixtures: the
mean over rc-0 jobs of a ``stages`` row of their ``--stats``, and None
where no job carries the block or the stage."""

import os
from types import SimpleNamespace

import pytest

from portbench import harness

STAGE_METRICS = {"msa_merge_ms.pafreport": "msa_merge",
                 "refine_ms.pafreport": "refine",
                 "write_ms.pafreport": "write",
                 "realign_ms.pafreport": "realign",
                 "consensus_ms.pafreport": "consensus"}
YIELD = "realign_yield_pct.pafreport"


def reader(name):
    return harness.load_module(
        os.path.join(harness.HERE, "metrics", name + ".py"),
        "m_" + name.replace(".", "_")).read


def rec(rc=0, stages=None):
    st = {"wall_s": 1.0, "host": {}}
    if stages is not None:
        st["stages"] = stages
    return dict(client=0, rc=rc, wall_s=1.1, key=0, stats=st)


def row(s, **counters):
    return dict(s=s, self_s=s / 2, n=1, items=200, **counters)


@pytest.mark.parametrize("name", sorted(STAGE_METRICS))
def test_stage_ms_is_the_mean_of_rc0_jobs(name):
    stage = STAGE_METRICS[name]
    ctx = SimpleNamespace(records=[
        rec(stages={stage: row(0.10), "run": row(1.0)}),
        rec(stages={stage: row(0.30)}),
        rec(rc=1, stages={stage: row(9.0)}),         # a failed job: out
        rec(stages={"run": row(1.0)})])               # no such stage: out
    assert reader(name)(ctx) == pytest.approx(200.0)


@pytest.mark.parametrize("name", sorted(STAGE_METRICS) + [YIELD])
def test_none_without_the_block_or_the_stage(name):
    read = reader(name)
    assert read(SimpleNamespace(records=[])) is None
    # the parent program's --stats: no stages block
    assert read(SimpleNamespace(records=[rec(), rec()])) is None
    assert read(SimpleNamespace(records=[
        rec(stages={"run": row(1.0)})])) is None
    assert read(SimpleNamespace(records=[
        rec(rc=1, stages={s: row(1.0, lane_dispatches=4, lanes_done=4)
                          for s in STAGE_METRICS.values()})])) is None


def test_realign_yield_sums_lanes_over_jobs():
    read = reader(YIELD)
    ctx = SimpleNamespace(records=[
        rec(stages={"realign": row(0.2, lane_dispatches=210,
                                   lanes_done=200)}),
        rec(stages={"realign": row(0.2, lane_dispatches=190,
                                   lanes_done=190)}),
        rec(rc=1, stages={"realign": row(0.2, lane_dispatches=100,
                                         lanes_done=0)}),
        rec(stages={"realign": row(0.2)})])     # no counters: out
    assert read(ctx) == pytest.approx(100.0 * 390 / 400)
    # no lane launched: nothing to read
    assert read(SimpleNamespace(records=[rec(stages={"realign": row(
        0.1, lane_dispatches=0, lanes_done=0)})])) is None


def test_new_metrics_are_in_the_benchmark():
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in list(STAGE_METRICS) + [YIELD]:
        assert got[name]["moves"] == "aln_per_s"
        assert "pafreport-msa-realign-c1" in got[name]["workloads"]
    assert got["write_ms.pafreport"]["workloads"] == [
        "pafreport-msa-realign-c1", "pafreport-report-c1"]
    assert got[YIELD]["source"] == "program_counter"
