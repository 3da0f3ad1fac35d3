"""Time the PyTorch port's backward kernel under three launch bounds, or
against an earlier version of its source, on one CUDA card.

    python3 tools/torch_backward_launch_bounds.py [--rounds 5] [--reps 10]
        [--parent DIR] [--builds as_built,parent]

csrc/fb_sm3.cu instantiates backward_kernel under __launch_bounds__
(MAX_THREADS): stage 4 at 1024 (64 registers a thread, so that the one
instance runs every window width up to 1024 lanes), stage 3 at
NARROW_THREADS for windows that fit it and at 1024 past them.  This script
builds three libraries from the same source: as it is ("as_built"), with
every instance bound to 1024 ("bound_1024") and with the bound removed
("unbounded": the register allocator picks its own count).  It prints
ptxas's registers and spills of each, and times stage 3 and stage 4 of each
on the same CUDA tensors at W = 128, Dp = 4096, B = 64 (chip_smoke.py's
kernel problems).  Each round times the builds in one order and then in the
reverse order, each time the mean of ``--reps`` launches by CUDA events.
The last line is a JSON object: per stage and build the median ms and the
spread (max - min) / median over its times, and each build's median over
the unbounded one.  Every build's outputs must agree with the as-built
one's (p, totals, exits and gacc exactly, stats to the stage-4 tolerance
of chip_smoke.py), else it exits nonzero.

``--parent DIR`` adds a build "parent" of DIR's
cpecan_signal_tpu_torch/csrc/fb_sm3.cu (an unpacked earlier commit), so the
two versions are timed in one process on one card; a parent whose stage-3
entry point takes the match state where this one takes the posterior
state mask gets the state.  ``--builds`` names the builds to time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BOUND = "__global__ void __launch_bounds__(MAX_THREADS)"
BUILDS = ("as_built", "bound_1024", "unbounded")
W, DP, B = 128, 4096, 64
# the stage-3 entry point's last int argument before the device: the
# posterior state mask here, the match state before the mask existed
MASK_ARG = 18


class MatchStateLib:
    """A library whose fb_backward_sm3 takes the match state: the wrapper's
    one-state mask is turned into that state."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def fb_backward_sm3(self, *args):
        args = list(args)
        args[MASK_ARG] = args[MASK_ARG].bit_length() - 1
        return self.lib.fb_backward_sm3(*args)


def build_variants(tmp: Path, names, parent: Path | None = None) -> dict:
    """{build: lib} for ``names`` (of BUILDS and "parent"), compiled side by
    side with the library's own flags."""
    import chip_smoke
    from cpecan_signal_tpu_torch.ops import _build

    sources = sorted(_build.CSRC.glob("*.cu"))
    if [p.name for p in sources] != ["fb_sm3.cu"]:
        raise SystemExit(f"expected csrc/fb_sm3.cu alone, found {sources}")
    src = sources[0].read_text()
    if src.count(BOUND) != 1:
        raise SystemExit(f"expected one {BOUND!r} in fb_sm3.cu, found {src.count(BOUND)}")
    procs = {}
    texts = {"as_built": src,
             "bound_1024": src.replace(BOUND, "__global__ void __launch_bounds__(1024)"),
             "unbounded": src.replace(BOUND, "__global__ void")}
    if parent is not None:
        texts["parent"] = (parent / "cpecan_signal_tpu_torch/csrc/fb_sm3.cu").read_text()
    texts = {name: texts[name] for name in names}
    for name, text in texts.items():
        cu, so = tmp / f"{name}.cu", tmp / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{out}")
        for line in chip_smoke.ptxas_lines(out):
            if "backward" in line:
                print(f"ptxas {name}: {line}", flush=True)
        libs[name] = _build.bind(so)
    if "parent" in libs and "int pmask" not in texts["parent"]:
        libs["parent"] = MatchStateLib(libs["parent"])
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an unpacked earlier commit to time against")
    ap.add_argument("--builds", default=None,
                    help="comma-separated builds to time (default: the three "
                    "bounds, and parent with --parent)")
    args = ap.parse_args()
    builds = tuple(args.builds.split(",")) if args.builds else (
        BUILDS + (("parent",) if args.parent else ()))
    if builds[0] != "as_built" or ("parent" in builds) != (args.parent is not None):
        ap.error("--builds starts with as_built, and names parent with --parent only")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no usable CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import _build
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    device = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), builds, args.parent)
        pore = syn.write_pore_model(str(Path(tmp) / "synthetic.model"), rng)
        plan, b = chip_smoke.kernel_problems(pore, W, DP, B, rng, device)
    edges = pp.to_device(edge_table(plan), device)
    groups = pp.sm3_wgroups(plan)
    bargs = (b.diag_scalars, b.d_last, b.end, b.tp_scalar)
    E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, DP)
    F = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    runs = {3: lambda: fk.backward_sm3(edges, plan.match_state, E, F, *bargs),
            4: lambda: fk.backward_sm3(edges, plan.match_state, E, F, *bargs,
                                       stages=4, wgroups=groups)}

    def use(name):   # the wrappers launch through _build.load_library()
        _build.load_library = lambda: libs[name]

    outs = {}
    for name in builds:
        use(name)
        outs[name] = {st: run() for st, run in runs.items()}
    torch.cuda.synchronize()
    for name in builds[1:]:
        for st in runs:
            a, u = outs["as_built"][st], outs[name][st]
            same = all(torch.equal(x, y) for x, y in zip(a[:4], u[:4]))
            if st == 4:
                same = same and torch.allclose(a[4], u[4], atol=chip_smoke.STATS_ATOL,
                                               rtol=chip_smoke.STATS_RTOL)
            if not same:
                raise AssertionError(f"stage {st}: the {name} build's outputs differ")
    del outs

    times = {st: {name: [] for name in builds} for st in runs}
    for r in range(args.rounds):
        for name in builds + builds[::-1]:
            use(name)
            for st, run in runs.items():
                times[st][name].append(chip_smoke.cuda_ms(run, args.reps))
        print(f"round {r}: " + "; ".join(
            f"stage {st} {name} " + ", ".join(f"{t:.3f}" for t in v[name][-2:])
            for st, v in times.items() for name in v), flush=True)

    result = {"card": card, "W": W, "Dp": DP, "B": B}
    for st, v in times.items():
        med = {name: statistics.median(ts) for name, ts in v.items()}
        for name, ts in v.items():
            result[f"stage{st}_{name}_ms"] = med[name]
            result[f"stage{st}_{name}_spread"] = (max(ts) - min(ts)) / med[name]
        base = "unbounded" if "unbounded" in med else builds[-1]
        for name in builds:
            if name != base:
                result[f"stage{st}_{name}_over_{base}"] = med[name] / med[base]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
