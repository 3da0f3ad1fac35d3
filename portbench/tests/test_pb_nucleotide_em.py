"""The nucleotide EM cell (``realign.em_1mb``): a whole run on the CPU at a
small size (a 400-base genome pair, records of 100-200 bases) through
``run.run``, and its per-layer readers, which read their spans and counters
and return None where a run gives them nothing (as on a program without
them)."""

from __future__ import annotations

import pytest
import torch

from portbench import run

WORKLOAD = "realign.em_1mb"
SMALL = ({"record_lengths": [100, 200]}, {"x_bases": 400})
SPANS = {"nem.head_share": "head", "nem.stage_share": "nem.stage",
         "nem.device_wait_share": "nem.device_wait"}
FILLS = {"nem.lane_fill": ("nem.cells_band", "nem.cells_lane"),
         "nem.sm_fill": ("nem.diagonals", "nem.sm_slots")}
TRACE = ("nem_pipeline_roofline", "mfu.nem", "device.idle_pct.nem")


def reader(name):
    return run.load_module(run.BENCH_DIR / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("trace_on", [0, 1])
def test_the_cell_runs_small_on_the_cpu(trace_on):
    rc, res = run.run(["--workload", WORKLOAD, "--seed", str(2 ** 33 + 7), "--seconds", "0.1",
                       "--trace", str(trace_on)], device=torch.device("cpu"),
                      overrides=SMALL[0], config_overrides=SMALL[1])
    assert rc == 0 and res["correct"], res
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"likelihood_rel", "transition_rel", "emission_rel",
                                  "m_step_rel"}
    if trace_on:
        # on the CPU: no SM slots, no device operations to trace
        assert set(res["metrics"]) == {*SPANS, "nem.lane_fill", "mfu.nem"}
        assert 0 < res["metrics"]["nem.lane_fill"]["value"] <= 100
    else:
        assert set(res["metrics"]) == {"realign_bases_per_s", "setup_s"}
        assert res["metrics"]["realign_bases_per_s"]["value"] > 0


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_shares_read_their_span(name):
    timing = {"head": 6.0, "nem.stage": 1.5, "nem.device_wait": 3.0}
    assert reader(name)({"window_s": 30.0, "timing": timing}) == \
        pytest.approx(100.0 * timing[SPANS[name]] / 30.0)
    assert reader(name)({"window_s": 30.0, "timing": {}}) is None
    assert reader(name)({"timing": timing}) is None
    assert reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(FILLS))
def test_fills_read_the_window_counters(name):
    part, whole = FILLS[name]
    assert reader(name)({"window_s": 30.0, "timing": {part: 53.0, whole: 200.0}}) == \
        pytest.approx(26.5)
    assert reader(name)({"window_s": 30.0, "timing": {part: 53.0, whole: 0}}) is None
    assert reader(name)({"window_s": 30.0, "timing": {"head": 1.0}}) is None
    assert reader(name)({}) is None


@pytest.mark.parametrize("name", TRACE)
def test_trace_readers_need_a_trace(name):
    assert reader(name)({}) is None
    assert reader(name)({"window_s": 30.0, "work": {"ops": 1e12, "bytes": 1e9}}) is None
    traced = {"window_s": 30.0, "work": {"ops": 67e12, "bytes": 1e9},
              "trace": {"busy_s": 12.0, "window_s": 30.0,
                        "device_seconds": {"recursion_kernel<true>": 4.0}}}
    want = {"nem_pipeline_roofline": 25.0, "mfu.nem": 100.0 / 30.0,
            "device.idle_pct.nem": 60.0}
    assert reader(name)(traced) == pytest.approx(want[name])
