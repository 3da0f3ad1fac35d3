"""Readings that set a cell's limits: the program against the plain reference
on many seeds, and the control (the reference computed in the precision
below the configuration's, put in the program's place) against it.

    python3 portbench/control.py --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--out FILE]

Each seed runs the cell's set-up (which drives the timed path through its
first steps or its warm-up call) and no window; the program's state is then
freed and both comparisons run, in one process.  One JSON line a seed on
standard output, and all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run as runner  # noqa: E402
from portbench import trace as tr  # noqa: E402

CONTROL_DTYPE = {"float64": "float32", "float32": "bfloat16"}


def readings(workload: str, seed: int, control: bool, device=None, overrides=None,
             config_overrides=None, bench=None) -> dict:
    import torch
    bench = bench or json.loads((runner.ROOT / "BENCHMARK.json").read_text())
    spec = runner.cell_spec(bench, workload)
    device = device or torch.device("cuda", 0)
    cell = runner.make_cell(spec, workload, seed, device, overrides, config_overrides)
    t0 = time.perf_counter()
    cell.setup(tr.Spans(traced=False))
    t1 = time.perf_counter()
    cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "setup_s": t1 - t0, "program": cell.check()}
    t2 = time.perf_counter()
    out["reference_s"] = t2 - t1
    if control:
        dtype = getattr(torch, CONTROL_DTYPE[cell.ctx["config"]["precision"]])
        out["control_dtype"] = str(dtype)
        out["control"] = cell.control(dtype)
        out["control_s"] = time.perf_counter() - t2
    out["limits"] = spec["limits"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None, help="plant this fault of faults.FAULTS")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.fault:
        from portbench import faults
        faults.plant(args.workload, args.fault)
    rows = []
    for seed in args.seeds:
        rows.append(dict(readings(args.workload, seed, seed in args.control_seeds),
                         fault=args.fault))
        print(json.dumps(rows[-1]), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
