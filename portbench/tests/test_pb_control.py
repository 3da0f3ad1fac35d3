"""The comparison that decides ``correct`` fails when it should: the control
(the reference in the precision below the configuration's, in the
program's place) and the faults a cell can have, each planted under a
whole run at a small size on the CPU."""

from __future__ import annotations

import pytest
import torch

from portbench import control, faults
from portbench.tests.small import CELLS, SMALL, bench, run_small


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_the_program_passes(workload):
    traffic, config = SMALL[workload]
    seeds = (21, 2 ** 31 + 5)
    for seed in seeds:
        r = control.readings(workload, seed, True, device=torch.device("cpu"),
                             overrides=traffic, config_overrides=config, bench=bench())
        assert all(v <= r["limits"][k] for k, v in r["program"].items()), r
        assert any(v > r["limits"][k] for k, v in r["control"].items()), r


@pytest.mark.parametrize("workload,fault", [(w, f) for w in faults.FAULTS
                                             for f in faults.FAULTS[w]])
def test_a_planted_fault_reads_incorrect(workload, fault):
    undo = faults.plant(workload, fault)
    try:
        rc, res = run_small(workload, seed=33)
    finally:
        undo()
    assert rc == 0 and res["correct"] is False, res["checks"]
