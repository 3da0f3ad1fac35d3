"""Sizes at which a test drives a whole run of each cell on the CPU, through
the program's plain versions: the mix's and the configuration's keys
replaced, as ``run.run`` takes them.  ``sigalign.reads`` is built and
measured but not in BENCHMARK.json (PERF.md, Open questions): its entries
sit in ``reads_cell.json``, and the tests run it with them added."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL_READS = {"median": 120, "sigma": 0.1, "min": 100, "max": 150}
SMALL = {
    "sigalign.em": ({"reads": 2, "read_lengths": SMALL_READS}, None),
    "sigalign.reads": ({"pool": 3, "reads_per_call": 2, "compared_per_call": 1,
                        "read_lengths": SMALL_READS}, None),
    "realign.records": ({"record_lengths": [150, 400], "bases_per_call": 300},
                        {"x_bases": 1000}),
}
CELLS = tuple(SMALL)


def bench() -> dict:
    """BENCHMARK.json with the entries of ``sigalign.reads`` added."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((Path(__file__).parent / "reads_cell.json").read_text())
    for key, entries in extra.items():
        b[key] += entries
    return b


def run_small(workload: str, seed: int = 5, trace: int = 0, seconds: float = 0.1):
    """(exit code, result) of one run of ``workload`` on the CPU at its
    small size."""
    import torch

    from portbench import run
    traffic, config = SMALL[workload]
    return run.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                    "--trace", str(trace)], device=torch.device("cpu"), overrides=traffic,
                   config_overrides=config, bench=bench())
