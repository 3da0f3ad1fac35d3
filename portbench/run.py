"""Run one benchmark cell of the PyTorch/CUDA port once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); the mix names the driver that runs
it (``portbench/drivers/<driver>.py``), the per-layer metrics are read by
``portbench/metrics/<metric>.py`` and the limits of the comparison with the
plain reference sit in ``portbench/limits/<cell>.json``.  So a cell, a
configuration, a mix or a metric is added by adding files and entries.

A run: set-up (inputs from the seed, the program's own set-up, a warm-up of
every shape the window uses), the measured window of ``--seconds``
(under torch.profiler with ``--trace 1``), the device's memory peak, then the
program's state is freed and what the window's path produced is compared
with the plain reference.  The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.  Without a card, or with
fewer cards than the cell asks for, or with JAX or the JAX package loaded, the
run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "cpecan_signal_tpu")
# the kernels build into build/torch_kernels/ (the program's own, in the
# checkout); a Triton cache, should the program come to use one, goes here
TRITON_CACHE = ROOT / "build" / "bench_cache" / "triton"


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_module(path: Path):
    """A file of the benchmark as a module of its own (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry with its configuration, mix, limits and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in e2e_names else [])]
    return {"cell": w, "config": json.loads((ROOT / config["file"]).read_text()),
            "traffic": json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text()),
            "limits": json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer}


def make_cell(spec: dict, workload: str, seed: int, device, overrides=None,
              config_overrides=None):
    """The driver's cell for a run, its mix and configuration with any keys
    replaced (the benchmark's own tests run small)."""
    traffic = dict(spec["traffic"], **(overrides or {}))
    driver = load_module(BENCH_DIR / "drivers" / f"{traffic['driver']}.py")
    return driver.Cell({"config": dict(spec["config"], **(config_overrides or {})),
                        "traffic": traffic, "seed": seed % (1 << 64), "device": device,
                        "log": log, "workload": workload})


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def run(argv=None, *, device=None, overrides: dict | None = None,
        config_overrides: dict | None = None, bench: dict | None = None):
    """One run.  Returns (exit code, result or None).  ``device``, the
    overrides (keys of the mix, of the configuration replaced) and ``bench``
    (in place of BENCHMARK.json) serve the benchmark's own tests, which drive
    a run on the CPU at a small size."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = cell_spec(bench, args.workload)
    chips = int(spec["cell"]["chips"])
    os.environ["TRITON_CACHE_DIR"] = str(TRITON_CACHE)
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"needs {chips} CUDA device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3, None
        device = torch.device("cuda", 0)
    cell = make_cell(spec, args.workload, args.seed, device, overrides, config_overrides)

    from portbench import trace as tr
    spans = tr.Spans(traced=bool(args.trace))
    with contextlib.redirect_stdout(sys.stderr):
        cell.setup(spans)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - T_START
        log(f"set-up {setup_s:.3f} s")
        spans.seconds.clear()
        prof = None
        if args.trace:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA]
                                             if device.type == "cuda" else []))
            prof.__enter__()
        w0 = time.time()
        with spans(tr.WINDOW):
            measured = cell.window(args.seconds, spans)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        w1 = time.time()
        spans.seconds.pop(tr.WINDOW)
        traced = None
        if prof is not None:
            prof.__exit__(None, None, None)
            events = tr.events_of(prof)
            traced = tr.reduce(events, tr.window_of(events, (w0, w1)))
            prof = None
        dev = (device_info(torch, chips) if device.type == "cuda" else
               {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0})
        cell.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        readings = dict(measured["readings"], spans=dict(spans.seconds), trace=traced)
        if args.trace:
            readings["work"] = cell.work()
        log(f"window {readings.get('window_s', 0.0):.3f} s; comparing with the reference")
        numbers = cell.check()

    if args.trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(measured["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    # a number that reads infinite (an answer that never came) stays valid JSON
    checks = {k: {"value": v if v <= sys.float_info.max else sys.float_info.max,
                  "limit": spec["limits"][k]} for k, v in numbers.items()}
    correct = (all(v <= spec["limits"][k] for k, v in numbers.items())
               and set(checks) == set(spec["limits"]) and cell.failed == 0)
    result = {"correct": correct, "attempted": cell.attempted, "failed": cell.failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"refusing to report: modules {loaded} are loaded in this process")
        return 4, None
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    return 0, result


def main(argv=None) -> int:
    rc, result = run(argv)
    if result is not None:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
