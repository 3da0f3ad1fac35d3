"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of cpecan_signal_tpu_torch from csrc/, holds each
kernel against its plain PyTorch version on the card, drives the port's main
path (threeState signal alignment through cli/signal_align) on 50 synthetic
two-strand reads, checks the card's pairs against the CPU plain path, and
times the device-batched path.  Each phase prints one line; any failure
raises and the script exits nonzero.  Without a usable CUDA device it exits
nonzero before printing any result.  The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPLACES = {
    "emissions": "cpecan_signal_tpu/ops/pallas_fb.py:162",
    "forward": "cpecan_signal_tpu/ops/pallas_fb.py:343",
    "backward": "cpecan_signal_tpu/ops/pallas_fb.py:627",
}
SOURCE = "cpecan_signal_tpu_torch/csrc/fb_sm3.cu"
# tolerances of the kernel-vs-plain comparison on the card
E_RTOL = 1e-6                 # emissions: the same f32 ops, no FMA contraction
F_ATOL, F_RTOL = 1e-3, 1e-5   # forward log-probs and totals
P_ATOL = 1e-4                 # match posteriors
# whole-path tolerances (tests/test_readpath_random.py:89-96)
PAIR_TOL, PROB_TOL = 1, 1.2e-3
SEED = 20261016


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_problems(pore, W: int, Dp: int, B: int, rng, device):
    """B problems from make_sm3_problem on synthetic reads whose band fits a
    W-lane window and whose diagonal count fits Dp."""
    from cpecan_signal_tpu.core.band import band_construct
    from cpecan_signal_tpu.core.window import smooth_band
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.engine import pipeline as pp

    probs, plan = [], None
    while len(probs) < B:
        target = "".join(rng.choice(list("ACGT"), int(0.40 * Dp)))
        events, path = syn.simulate_events(pore, target, rng)
        n_kmers = len(target) - 5
        anchors = syn.path_anchors(path, n_kmers, len(events), 20)
        band = band_construct(anchors, n_kmers, len(events), 20)
        wb = smooth_band(band, width_multiple=W)
        if wb.W != W or wb.n_diagonals > Dp or len(events) > Dp // 2:
            continue
        plan, prob = pp.make_sm3_problem(pore, target, events, wb, device=device,
                                         ragged_left=bool(len(probs) % 2),
                                         pad_lx=Dp // 2, pad_ly=Dp // 2, pad_d=Dp)
        probs.append(prob)
    return plan, pp.stack_problems(probs)


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def phase_kernels(pore, device, rng) -> dict:
    """Each kernel against its plain version on the same CUDA tensors."""
    import torch

    from cpecan_signal_tpu_torch.engine.pipeline import to_device
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    stats = {k: {"max_abs_err": 0.0} for k in ("emissions", "forward", "backward")}
    for W in (64, 128):
        for Dp in (1024, 4096):
            plan, b = kernel_problems(pore, W, Dp, 64, rng, device)
            edges = to_device(edge_table(plan), device)
            m = plan.match_state
            t0 = time.perf_counter()
            E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
            F = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
            P, T = fk.backward_sm3(edges, m, E, F, b.diag_scalars, b.d_last, b.end,
                                   b.tp_scalar)
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            E_ref = fk.emissions_sm3_ref(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
            F_ref = fk.forward_sm3_ref(edges, E, b.diag_scalars, b.d_last, b.start,
                                       b.tp_scalar)
            P_ref, T_ref = fk.backward_sm3_ref(edges, m, E, F, b.diag_scalars,
                                               b.d_last, b.end, b.tp_scalar)
            ok_e = bool(((E - E_ref).abs() <= E_RTOL * E_ref.abs()).all())
            ok_f = bool(torch.allclose(F, F_ref, atol=F_ATOL, rtol=F_RTOL))
            ok_t = bool(torch.allclose(T, T_ref, atol=F_ATOL, rtol=F_RTOL))
            ok_p = bool(torch.allclose(P, P_ref, atol=P_ATOL, rtol=0))
            errs = {"emissions": max_err(E, E_ref), "forward": max_err(F, F_ref),
                    "backward": max(max_err(P, P_ref), max_err(T, T_ref))}
            times = {
                "emissions": (cuda_ms(lambda: fk.emissions_sm3(
                    b.x0, b.yr0, b.xarr, b.evr, W, Dp), 5),
                    cuda_ms(lambda: fk.emissions_sm3_ref(
                        b.x0, b.yr0, b.xarr, b.evr, W, Dp), 1)),
                "forward": (cuda_ms(lambda: fk.forward_sm3(
                    edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar), 3),
                    cuda_ms(lambda: fk.forward_sm3_ref(
                        edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar), 1)),
                "backward": (cuda_ms(lambda: fk.backward_sm3(
                    edges, m, E, F, b.diag_scalars, b.d_last, b.end, b.tp_scalar), 3),
                    cuda_ms(lambda: fk.backward_sm3_ref(
                        edges, m, E, F, b.diag_scalars, b.d_last, b.end,
                        b.tp_scalar), 1)),
            }
            print(f"kernels W={W} Dp={Dp} B=64: first call {t_first:.3f} s; "
                  f"E err {errs['emissions']:.3g} (rtol {E_RTOL}) ok={ok_e}; "
                  f"F err {errs['forward']:.3g} (atol {F_ATOL} rtol {F_RTOL}) ok={ok_f}; "
                  f"p err {max_err(P, P_ref):.3g} (atol {P_ATOL}) ok={ok_p}; "
                  f"totals err {max_err(T, T_ref):.3g} (atol {F_ATOL} rtol {F_RTOL}) "
                  f"ok={ok_t}; ms kernel/plain: "
                  + ", ".join(f"{k} {v[0]:.3f}/{v[1]:.3f}" for k, v in times.items()),
                  flush=True)
            if not (ok_e and ok_f and ok_t and ok_p):
                raise AssertionError(f"kernel disagrees with its plain version at "
                                     f"W={W} Dp={Dp}")
            for k in stats:
                stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], errs[k])
                if W == 128 and Dp == 4096:
                    stats[k]["ms"], stats[k]["plain_ms"] = times[k]
            del E, F, P, T, E_ref, F_ref, P_ref, T_ref, b
            torch.cuda.empty_cache()
    return stats


def read_jobs(paths, ref_seq, model_path, params):
    """Per-read split-job lists of the given npRead files (host prep)."""
    from cpecan_signal_tpu.io.npread import load_npread
    from cpecan_signal_tpu.models.pore_model import load_pore_model
    from cpecan_signal_tpu_torch.cli.vanilla_align import (guide_alignment,
                                                           prepare_read, strand_jobs)

    pore = load_pore_model(model_path)
    out = []
    for path in paths:
        npr = load_npread(path)
        guide = guide_alignment(ref_seq, npr.twoD_read, params.constraint_diagonal_trim)
        prep = prepare_read(ref_seq, npr, params, sm_type="threeState", guide=guide,
                            substitute=None, template_model=pore,
                            complement_model=pore)
        if prep["status"] != "ok":
            raise AssertionError(f"{path} did not map")
        out.append([j for ctx in prep["strand_ctx"] for j in strand_jobs(ctx, params)])
    return out


def pairs_agree(got, want) -> tuple[int, float]:
    """(pairs missing from either side, max posterior drift on common pairs)."""
    db = {(x, y): p for p, x, y in got.as_tuples()}
    ds = {(x, y): p for p, x, y in want.as_tuples()}
    common = set(db) & set(ds)
    drift = max((abs(db[k] - ds[k]) / 1e7 for k in common), default=0.0)
    return max(len(db), len(ds)) - len(common), drift


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch reports no usable CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from cpecan_signal_tpu.models.params import cli_defaults
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.cli import signal_align
    from cpecan_signal_tpu_torch.engine.align import collect_split_jobs
    from cpecan_signal_tpu_torch.engine.batch_align import (batch_align_jobs,
                                                            batch_align_stream)
    from cpecan_signal_tpu_torch.ops import _build
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk
    from cpecan_signal_tpu.models.state_machines import make_signal_sm3

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"environment: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name}; nvidia-smi: {card}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "synthetic.model")
        pore = syn.write_pore_model(model, rng)
        stats = phase_kernels(pore, device, rng)

        # --- main path through the CLI
        ref = os.path.join(tmp, "ref.fa")
        ref_seq = syn.write_reference(ref, 30000, rng)
        reads = os.path.join(tmp, "reads")
        paths = syn.write_read_set(reads, ref_seq, pore, 50, rng)
        os.environ["SIGALIGN_PLATFORM"] = "cuda"
        for k in fk.LAUNCHES:
            fk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        rc = signal_align.main(["-d", reads, "-r", ref, "-o", os.path.join(tmp, "out"),
                                "-T", model, "-C", model, "-s"])
        t_cli = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        with open(os.path.join(tmp, "out", "posteriors.tsv")) as fh:
            rows = [line.split("\t") for line in fh]
        labels = {r[3] for r in rows}
        want = {os.path.basename(p) for p in paths}
        print(f"cli: rc={rc} {len(rows)} TSV rows, {len(labels)}/{len(want)} reads, "
              f"launches {launches}, {t_cli:.2f} s", flush=True)
        if rc != 0 or labels != want or min(launches.values()) < 1:
            raise AssertionError("main path failed: rc, reads or kernel launches")

        # --- agreement: kernels on the card vs plain versions on the CPU
        params = cli_defaults()
        per_read = read_jobs(paths, ref_seq, model, params)
        sizes = [sum(len(j.sm.sm3_pack[2]) for j in jl) for jl in per_read]
        jobs5 = [j for i in np.argsort(sizes)[:5] for j in per_read[i]]
        got = batch_align_jobs(jobs5, params.threshold, device=device)
        want5 = batch_align_jobs(jobs5, params.threshold, device=torch.device("cpu"))
        worst = [pairs_agree(g, w) for g, w in zip(got, want5)]
        miss = max(m for m, _ in worst)
        drift = max(d for _, d in worst)
        print(f"agreement: {len(jobs5)} jobs of 5 reads, cuda vs cpu: max pairs "
              f"differing {miss} (tol {PAIR_TOL}), max posterior drift {drift:.3g} "
              f"(tol {PROB_TOL})", flush=True)
        if miss > PAIR_TOL or drift > PROB_TOL:
            raise AssertionError("cuda and cpu paths disagree")

        # --- timing of the device-batched path
        n_ev = sum(sizes)
        batch_align_stream(iter(per_read), params.threshold, device=device)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_align_stream(iter(per_read), params.threshold, device=device)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t_med = sorted(times)[1]

        target = ""
        while len(target) < 50000:
            target += syn.evolve_sequence(ref_seq, rng, 0.04, 0.02)
        target = target[:50000]
        events, path = syn.simulate_events(pore, target, rng)
        anchors = syn.path_anchors(path, len(target) - 5, len(events), 40)
        long_jobs = collect_split_jobs(lambda t, e: make_signal_sm3(pore, t, e), target,
                                       events, anchors, params)
        batch_align_jobs(long_jobs, params.threshold, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = batch_align_jobs(long_jobs, params.threshold, device=device)
        torch.cuda.synchronize()
        t_long = time.perf_counter() - t0
        n_pairs = sum(len(p.probs) for p in out)
        if n_pairs < len(events) // 2:
            raise AssertionError(f"50 kb read gave {n_pairs} pairs for {len(events)} events")
        print(f"timing: 50 reads ({n_ev} events) batch_align_stream median of 3 "
              f"{t_med:.4f} s (runs {', '.join(f'{t:.4f}' for t in times)}): "
              f"{50 / t_med:.2f} reads/s, {n_ev / t_med:.0f} events/s; 50 kb read "
              f"({len(events)} events, {len(long_jobs)} split jobs, {n_pairs} pairs) "
              f"{t_long:.4f} s; card {card}", flush=True)

    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
         "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"]}
        for k in ("emissions", "forward", "backward")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
