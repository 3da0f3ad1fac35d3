"""Time the PyTorch port's kernels against an earlier version of their
source, and at other compile-time settings, on one CUDA card.

    python3 tools/torch_recursion_ab.py [--rounds 5] [--reps 10]
        [--parent DIR] [--builds as_built,lanes2,lanes4,parent]
        [--runs forward,emissions,...] [--e2e]

Builds csrc/fb_sm3.cu as it is ("as_built"), with LANES_PER_THREAD 2 and 4
("lanes2", "lanes4": a recursion block of W / 2 or W / 4 threads), with the
emissions kernel's variants ("emit_plain": E written with plain stores
instead of streaming ones; "emit_k32", "emit_k128": tiles of
32 or 128 diagonals; "emit_t256", "emit_t1024": blocks of 256 or 1024
threads; on request only) and, with ``--parent DIR``, DIR's
cpecan_signal_tpu_torch/csrc/fb_sm3.cu ("parent": an unpacked earlier
commit, e.g. ``git archive <commit> | tar -x -C .scratch/parent``), side by
side with the library's own flags, and prints ptxas's registers and spills
of each.  It then times, on the same CUDA tensors (chip_smoke.py's kernel
problems, W = 128, Dp = 4096, B = 64):

  * emissions: the threeState emissions at that shape; emissions50k: the
    50 kb read's launch (chip_smoke.long_read_jobs, B = 1); emissionsW1024:
    W = 1024, Dp = 512, B = 64 on band offsets (chip_smoke.emission_inputs);
    emissions_forward: the emissions and the forward that reads E, in turn;
    emissions_forward_small: the same at W = 128, Dp = 1024, B = 16, whose E
    (25 MB) fits in the card's 50 MB L2;

  * forward, forward5, forwardE: the threeState forward, and the fiveState
    and echelon forwards of the problems below;
  * forwardV, stage3V: the vanilla forward and stage-3 backward (the CLIs'
    default machine; chip_smoke.py's vanilla problems);
  * stage3, stage4: the threeState backward at stage 3 and stage 4;
  * pgroups: the fiveState stage 4 with one posterior channel per to-state;
  * pstates: the echelon stage-3 backward with its 5 posterior channels at
    Dp = 1024.

``--runs`` times those named only.  Each round times the builds in one
order and then in the reverse order, each time the mean of ``--reps``
launches by CUDA events.  Every build's outputs must equal the as-built
one's (E, F, p, totals, exits and gacc bit for bit; stats to the stage-4
tolerance of chip_smoke.py), else it exits nonzero.  ``--e2e`` then times,
per build in the same alternating rounds (host clock, synchronised), the
threeState alignment of chip_smoke.py's 50 reads (batch_align_stream) and
its 50 kb read (batch_align_jobs), and requires their pairs to be equal.
The last line is a JSON object: per run and build the median ms (s for
the end-to-end runs), the spread (max - min) / median over its times, and
each build's median over the last build's.  A parent whose recursions
keep no offsets (its F is absolute) is called without the offF arguments,
and its outputs are timed but not compared.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LANES = "#define LANES_PER_THREAD 1"
BUILDS = ("as_built", "lanes2", "lanes4")
# compile-time variants: build -> (the line of fb_sm3.cu, its replacement)
VARIANTS = {"lanes2": (LANES, "#define LANES_PER_THREAD 2"),
            "lanes4": (LANES, "#define LANES_PER_THREAD 4"),
            "emit_plain": ("#define EMIT_STREAM_STORE 1", "#define EMIT_STREAM_STORE 0"),
            "emit_k32": ("#define EMIT_TILE 64", "#define EMIT_TILE 32"),
            "emit_k128": ("#define EMIT_TILE 64", "#define EMIT_TILE 128"),
            "emit_t256": ("#define EMIT_THREADS 512", "#define EMIT_THREADS 256"),
            "emit_t1024": ("#define EMIT_THREADS 512", "#define EMIT_THREADS 1024")}
W, DP, B = 128, 4096, 64
PSTATES_DP = 1024
WIDE_W, WIDE_DP = 1024, 512   # the emissions at the widest window
SMALL_DP, SMALL_B = 1024, 16   # an E that fits in L2 (25 MB)
OFFSET_ENTRIES = {"fb_forward": 7, "fb_backward_sm3": 2, "fb_backward_sm3_em": 2,
                  "fb_backward_sm3_pgroups": 2}   # entry -> index of its offF argument


class NoOffsetLib:
    """A library whose recursions predate the per-diagonal offsets: the
    wrappers' offF argument is dropped (its forward writes absolute F and
    leaves offF as allocated; its backward reads no offF)."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in OFFSET_ENTRIES:
            return fn
        i = OFFSET_ENTRIES[name]
        return lambda *args: fn(*args[:i], *args[i + 1:])


def bind_parent(so: Path, text: str):
    """Bind an earlier library: the entry points its source defines, without
    the offF arguments if its recursions keep no offsets."""
    from cpecan_signal_tpu_torch.ops import _build

    names = [n for n in _build._SIGNATURES if n in text]
    if "double* offF" in text:
        return _build.bind(so, names)
    lib = ctypes.CDLL(str(so))
    for name in names:
        argtypes, restype = _build._SIGNATURES[name]
        fn = getattr(lib, name)
        if name in OFFSET_ENTRIES:
            i = OFFSET_ENTRIES[name]
            argtypes = argtypes[:i] + argtypes[i + 1:]
        fn.argtypes = argtypes
        fn.restype = restype
    return NoOffsetLib(lib)


def build_variants(tmp: Path, names, parent: Path | None = None) -> dict:
    """{build: lib} for ``names`` ("as_built", VARIANTS' builds, "parent"),
    compiled side by side."""
    import chip_smoke
    from cpecan_signal_tpu_torch.ops import _build

    sources = sorted(_build.CSRC.glob("*.cu"))
    if [p.name for p in sources] != ["fb_sm3.cu"]:
        raise SystemExit(f"expected csrc/fb_sm3.cu alone, found {sources}")
    src = sources[0].read_text()
    texts = {}
    for name in names:
        if name == "as_built":
            texts[name] = src
        elif name == "parent":
            texts[name] = (parent / "cpecan_signal_tpu_torch/csrc/fb_sm3.cu").read_text()
        else:
            line, repl = VARIANTS[name]
            if src.count(line) != 1:
                raise SystemExit(f"expected one {line!r} in fb_sm3.cu")
            texts[name] = src.replace(line, repl)
    procs = {}
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
            print(f"ptxas {name}: {line}", flush=True)
        libs[name] = (bind_parent(so, texts[name]) if name == "parent"
                      else _build.bind(so))
    return libs


def profile_kernels(runs, use, reps: int = 3) -> None:
    """Device milliseconds per launch of each CUDA kernel in each run of the
    as-built build (torch.profiler), so that a wrapper that launches several
    kernels (the backward: recursion, epilogue, carry) shows its parts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    use("as_built")
    for k, run in runs.items():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        parts = []
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
            if t and "kernel" in ev.key:
                parts.append(f"{ev.key.split('(')[0]} {t / 1e3 / reps:.3f} ms x{ev.count // reps}")
        print(f"profile {k}: " + ("; ".join(parts) or "no device time"), flush=True)


def same_outputs(a, u) -> list[bool]:
    """Outputs of one run by two builds: tensors equal bit for bit, a fifth
    (stage-4 stats) to chip_smoke.py's stage-4 tolerance."""
    import torch

    import chip_smoke

    same = [torch.equal(x, y) for x, y in zip(a[:4], u[:4])]
    if len(a) == 5:
        same.append(torch.allclose(a[4], u[4], atol=chip_smoke.STATS_ATOL,
                                   rtol=chip_smoke.STATS_RTOL))
    return same


def time_end_to_end(builds, use, pore_path: str, tmp: str, rounds: int) -> dict:
    """Per build, seconds of chip_smoke.py's threeState alignment of its 50
    reads and of its 50 kb read (host clock around a synchronised call), in
    alternating rounds; every build's pairs must equal the as-built one's."""
    import os

    import numpy as np
    import torch

    import chip_smoke
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.engine.batch_align import (batch_align_jobs,
                                                            batch_align_stream)
    from cpecan_signal_tpu_torch.models.params import cli_defaults
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model

    device = torch.device("cuda")
    data_rng = np.random.default_rng([chip_smoke.SEED, 1])
    ref_seq = syn.write_reference(os.path.join(tmp, "ref.fa"), 30000, data_rng)
    paths = syn.write_read_set(os.path.join(tmp, "reads"), ref_seq,
                               load_pore_model(pore_path), 50, data_rng)
    params = cli_defaults()
    per_read = chip_smoke.read_jobs(paths, ref_seq, pore_path, params)
    _events, long_jobs = chip_smoke.long_read_jobs(load_pore_model(pore_path), ref_seq,
                                                   data_rng, params)
    runs = {"align50": lambda: batch_align_stream(iter(per_read), params.threshold,
                                                  device=device)[1],
            "read50k": lambda: batch_align_jobs(long_jobs, params.threshold, device=device)}
    want = {}
    for name in builds:
        use(name)
        for k, run in runs.items():
            got = run()
            key = [(np.asarray(p.probs), np.asarray(p.x), np.asarray(p.y)) for p in got]
            if name == builds[0]:
                want[k] = key
            elif not all(np.array_equal(a, b) for g, w in zip(key, want[k])
                         for a, b in zip(g, w)) or len(key) != len(want[k]):
                raise AssertionError(f"{k}: the {name} build's pairs differ")
    print(f"check e2e: every build's pairs equal ({len(paths)} reads, "
          f"{len(long_jobs)} job(s) of the 50 kb read)", flush=True)
    times = {k: {name: [] for name in builds} for k in runs}
    for r in range(rounds):
        for name in builds + builds[::-1]:
            use(name)
            for k, run in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times[k][name].append(time.perf_counter() - t0)
        print(f"e2e round {r}: " + "; ".join(
            f"{k} {name} " + ", ".join(f"{t:.4f}" for t in v[name][-2:])
            for k, v in times.items() for name in v), flush=True)
    return times


def summarize(result: dict, times: dict, builds, unit: str) -> None:
    """Per run and build: the median, the spread (max - min) / median, and
    each build's median over the last build's."""
    for k, v in times.items():
        med = {name: statistics.median(ts) for name, ts in v.items()}
        for name, ts in v.items():
            result[f"{k}_{name}_{unit}"] = med[name]
            result[f"{k}_{name}_spread"] = (max(ts) - min(ts)) / med[name]
        base = builds[-1]
        for name in med:
            if name != base:
                result[f"{k}_{name}_over_{base}"] = med[name] / med[base]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an unpacked earlier commit to time against")
    ap.add_argument("--profile", action="store_true",
                    help="also print each run's device time per CUDA kernel "
                    "(torch.profiler, as-built build)")
    ap.add_argument("--builds", default=None,
                    help="comma-separated builds to time (default: as_built, "
                    "lanes2, lanes4, and parent with --parent)")
    ap.add_argument("--runs", default=None,
                    help="comma-separated runs to time (default: all)")
    ap.add_argument("--e2e", action="store_true",
                    help="also time the 50-read alignment and the 50 kb read per build")
    args = ap.parse_args()
    builds = tuple(args.builds.split(",")) if args.builds else (
        BUILDS + (("parent",) if args.parent else ()))
    if builds[0] != "as_built" or ("parent" in builds) != (args.parent is not None):
        ap.error("--builds starts with as_built, and names parent with --parent only")
    unknown = set(builds) - set(VARIANTS) - {"as_built", "parent"}
    if unknown:
        ap.error(f"unknown builds {sorted(unknown)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no usable CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.em.discrete import _to_state_pgroups
    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.batch_align import batch_align_jobs
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.models.params import cli_defaults
    from cpecan_signal_tpu_torch.ops import _build
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    device = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    tmp = tempfile.mkdtemp()
    try:
        libs = build_variants(Path(tmp), builds, args.parent)
        pore_path = str(Path(tmp) / "synthetic.model")
        pore = syn.write_pore_model(pore_path, rng)
        plan, b = chip_smoke.kernel_problems(pore, W, DP, B, rng, device)
        plan5, b5 = chip_smoke.five_problems(chip_smoke.nucleotide_set(tmp), W, DP,
                                             chip_smoke.FIVE_SHAPES[-1][2], B, device)
        planE, bE = chip_smoke.generic_problems(pore, "echelon", W, PSTATES_DP, B, rng,
                                                device)
        planV, bV = chip_smoke.generic_problems(pore, "vanilla", W, DP, B, rng, device)
        ew = chip_smoke.emission_inputs(rng, B, WIDE_DP, WIDE_W, device)

        def use(name):   # the wrappers launch through _build.load_library()
            _build.load_library = lambda: libs[name]

        use("as_built")
        # the 50 kb read's emissions launch, as the path makes it
        params = cli_defaults()
        long_calls = []
        _events, long_jobs = chip_smoke.long_read_jobs(
            pore, "".join(rng.choice(list("ACGT"), 30000)), rng, params)
        with chip_smoke.recording_emissions(fk, long_calls):
            batch_align_jobs(long_jobs, params.threshold, device=device)
        e50 = max(long_calls, key=lambda a: a[5])
        del long_calls, long_jobs
        print(f"emissions50k: W={e50[4]} Dp={e50[5]} B={e50[0].shape[0]}", flush=True)
        _plan_s, bs = chip_smoke.kernel_problems(pore, W, SMALL_DP, SMALL_B, rng, device)

        edges = pp.to_device(edge_table(plan), device)
        E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, DP)
        F = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
        bargs = (edges, plan.match_state, E, *F, b.diag_scalars, b.d_last, b.end,
                 b.tp_scalar)
        edges5 = pp.to_device(edge_table(plan5), device)
        F5 = fk.forward_sm3(edges5, b5.E, b5.diag_scalars, b5.d_last, b5.start,
                            b5.tp_scalar)
        edgesV = pp.to_device(edge_table(planV), device)
        FV = fk.forward_sm3(edgesV, bV.E, bV.diag_scalars, bV.d_last, bV.start,
                            bV.tp_scalar)
        edgesE = pp.to_device(edge_table(planE), device)
        FE = fk.forward_sm3(edgesE, bE.E, bE.diag_scalars, bE.d_last, bE.start,
                            bE.tp_scalar)

        def emissions_forward():
            e = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, DP)
            return e, *fk.forward_sm3(edges, e, b.diag_scalars, b.d_last, b.start,
                                      b.tp_scalar)

        def emissions_forward_small():
            e = fk.emissions_sm3(bs.x0, bs.yr0, bs.xarr, bs.evr, W, SMALL_DP)
            return e, *fk.forward_sm3(edges, e, bs.diag_scalars, bs.d_last, bs.start,
                                      bs.tp_scalar)

        runs = {
            "emissions": lambda: (fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, DP),),
            "emissions50k": lambda: (fk.emissions_sm3(*e50),),
            "emissionsW1024": lambda: (fk.emissions_sm3(*ew, WIDE_W, WIDE_DP),),
            "emissions_forward": emissions_forward,
            "emissions_forward_small": emissions_forward_small,
            "forward": lambda: fk.forward_sm3(edges, E, b.diag_scalars, b.d_last,
                                              b.start, b.tp_scalar),
            "forward5": lambda: fk.forward_sm3(edges5, b5.E, b5.diag_scalars, b5.d_last,
                                               b5.start, b5.tp_scalar),
            "forwardE": lambda: fk.forward_sm3(edgesE, bE.E, bE.diag_scalars, bE.d_last,
                                               bE.start, bE.tp_scalar),
            "forwardV": lambda: fk.forward_sm3(edgesV, bV.E, bV.diag_scalars, bV.d_last,
                                               bV.start, bV.tp_scalar),
            "stage3V": lambda: fk.backward_sm3(edgesV, planV.match_state, bV.E, *FV,
                                               bV.diag_scalars, bV.d_last, bV.end,
                                               bV.tp_scalar),
            "stage3": lambda: fk.backward_sm3(*bargs),
            "stage4": lambda: fk.backward_sm3(*bargs, stages=4,
                                              wgroups=pp.sm3_wgroups(plan)),
            "pgroups": lambda: fk.backward_sm3(
                edges5, plan5.match_state, b5.E, *F5, b5.diag_scalars, b5.d_last, b5.end,
                b5.tp_scalar, stages=4, wgroups=pp.sm3_wgroups(plan5),
                pgroups=_to_state_pgroups(plan5)),
            "pstates": lambda: fk.backward_sm3(
                edgesE, planE.match_state, bE.E, *FE, bE.diag_scalars, bE.d_last, bE.end,
                bE.tp_scalar, pstates=chip_smoke.ECHELON_PSTATES),
        }
        if args.runs:
            names = args.runs.split(",")
            if set(names) - set(runs):
                ap.error(f"unknown runs {sorted(set(names) - set(runs))}")
            runs = {k: runs[k] for k in names}

        outs = {}
        for name in builds:
            use(name)
            outs[name] = {k: run() for k, run in runs.items()}
        torch.cuda.synchronize()
        for name in builds[1:]:
            if isinstance(libs[name], NoOffsetLib):
                print("check parent: its recursions keep no offsets (absolute F); "
                      "timed only", flush=True)
                continue
            for k in runs:
                a, u = outs["as_built"][k], outs[name][k]
                same = same_outputs(a, u)
                print(f"check {k} {name}: outputs equal {same}; max abs diff "
                      + ", ".join(f"{float((x - y).abs().max()):.3g}" for x, y in zip(a, u)),
                      flush=True)
                if not all(same):
                    raise AssertionError(f"{k}: the {name} build's outputs differ")
        del outs

        if args.profile:
            profile_kernels(runs, use)

        times = {k: {name: [] for name in builds} for k in runs}
        for r in range(args.rounds):
            for name in builds + builds[::-1]:
                use(name)
                for k, run in runs.items():
                    times[k][name].append(chip_smoke.cuda_ms(run, args.reps))
            print(f"round {r}: " + "; ".join(
                f"{k} {name} " + ", ".join(f"{t:.3f}" for t in v[name][-2:])
                for k, v in times.items() for name in v), flush=True)

        result = {"card": card, "W": W, "Dp": DP, "B": B, "pstates_Dp": PSTATES_DP,
                  "emissions50k_W": e50[4], "emissions50k_Dp": e50[5]}
        summarize(result, times, builds, "ms")
        if args.e2e:
            summarize(result, time_end_to_end(builds, use, pore_path, tmp, args.rounds),
                      builds, "s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
