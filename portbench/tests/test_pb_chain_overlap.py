"""``nem.chain_overlap``, the nucleotide E-step's chains side by side: its
reader on hand-made readings, and a small run of ``realign.em_1mb`` on the
CPU that reports it with every other metric the cell's traced run reads
there."""

from __future__ import annotations

import pytest
import torch

from portbench import run

WORKLOAD = "realign.em_1mb"
SMALL = ({"record_lengths": [100, 200]}, {"x_bases": 400})


def reader():
    return run.load_module(run.BENCH_DIR / "metrics" / "nem.chain_overlap.py").read


def test_chain_overlap_reads_the_window_counters():
    timing = {"nem.diagonals": 2_000_108.0, "nem.chain_diagonals": 361_542.0}
    assert reader()({"window_s": 30.0, "timing": timing}) == \
        pytest.approx(2_000_108 / 361_542)
    # the parent's counters: no chain diagonals
    assert reader()({"window_s": 30.0, "timing": {"nem.diagonals": 5.0}}) is None
    assert reader()({"window_s": 30.0, "timing": {"nem.diagonals": 5.0,
                                                  "nem.chain_diagonals": 0}}) is None
    assert reader()({"window_s": 30.0, "timing": {}}) is None
    assert reader()({}) is None


def test_the_traced_cell_reports_chain_overlap_on_the_cpu():
    rc, res = run.run(["--workload", WORKLOAD, "--seed", str(2 ** 33 + 11), "--seconds",
                       "0.1", "--trace", "1"], device=torch.device("cpu"),
                      overrides=SMALL[0], config_overrides=SMALL[1])
    assert rc == 0 and res["correct"], res
    # on the CPU: no SM slots, no device operations to trace
    assert set(res["metrics"]) == {"nem.head_share", "nem.stage_share",
                                   "nem.device_wait_share", "nem.lane_fill", "mfu.nem",
                                   "realign.head_ns_per_anchor", "nem.chain_overlap"}
    assert res["metrics"]["nem.chain_overlap"]["value"] >= 1
