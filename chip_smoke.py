"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of cpecan_signal_tpu_torch from csrc/ (and prints
ptxas's registers and spills for each), holds each kernel against its plain
PyTorch version on the card (narrow windows, and a 1024-lane one that takes
the backward kernel's wide instance), then drives the port's two paths on 50
synthetic two-strand reads:

  * alignment: cli/signal_align -s (emissions, forward, stage-3 backward),
    checked against the CPU plain path and timed;
  * training: cli/train_models, threeState, 3 EM iterations on the card
    (emissions, forward, stage-4 backward), the likelihood required not to
    fall once the first M-step has normalized the model, and one E-step
    checked against the CPU plain path.

Each path runs with the kernel launch counts set to 0 just before it and
read just after.  Each phase prints one line; any failure raises and the
script exits nonzero.  Without a usable CUDA device it exits nonzero before
printing any result.  The last line is {"ok": true, "device": {...}}; the
line before it lists the kernels, the one before that the card.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

KERNELS = ("emissions", "forward", "backward", "backward_em")
REPLACES = {
    "emissions": "cpecan_signal_tpu/ops/pallas_fb.py:162",
    "forward": "cpecan_signal_tpu/ops/pallas_fb.py:343",
    "backward": "cpecan_signal_tpu/ops/pallas_fb.py:627",
    "backward_em": "cpecan_signal_tpu/ops/pallas_fb.py:627 (stages=4, wgroups)",
}
SOURCE = "cpecan_signal_tpu_torch/csrc/fb_sm3.cu"
# tolerances of the kernel-vs-plain comparison on the card
E_RTOL = 1e-6                 # emissions: the same f32 ops, no FMA contraction
F_ATOL, F_RTOL = 1e-3, 1e-5   # forward log-probs and totals
P_ATOL = 1e-4                 # match posteriors
WIN_ATOL = 1e-6               # exits, gacc: the same sums in the same order
STATS_ATOL, STATS_RTOL = 1e-3, 1e-5   # stats: another summation order
# E-step on the card against the CPU plain path (sums over buckets and the
# per-k-mer scatter run in other orders; the scatter uses atomics)
STEP_RTOL, STEP_ATOL, LIK_RTOL = 1e-4, 1e-5, 1e-5
LIK_DROP = 1e-5               # largest relative fall of the EM likelihood
# whole-path tolerances (tests/test_readpath_random.py:89-96)
PAIR_TOL, PROB_TOL = 1, 1.2e-3
SEED = 20261016
EM_ITERATIONS = 3
WIDE_W = 1024   # past the backward kernel's NARROW_THREADS (csrc/fb_sm3.cu)

# The least time the card could take for a kernel's work: the larger of its
# bytes (every input read once, every output written once) at the H100
# SXM's 3.35 TB/s and its f32 operations at 67 TFLOP/s (no tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per window cell, counted from csrc/fb_sm3.cu for the
# threeState edge table (8 edges, 3 states; a logAdd is 14 operations, an
# exp or a log 1): emissions 4 Gaussians of 6 and 4 adds and clamps;
# forward 8 edges x (2 adds + logAdd); backward the recursion (8 x 16), the
# correction (3 x 16), the two logsumexps and the posterior; stage 4 adds
# 8 edges x (4 adds, min, exp, 1-2 tally adds).
OPS_PER_CELL = {"emissions": 28, "forward": 128, "backward": 220, "backward_em": 290}


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


def timed_once(fn):
    """(``fn()``, its milliseconds on the card by CUDA events): for the plain
    versions, whose one call is both the reference and the timing."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def nbytes(*tensors) -> int:
    return sum(t.element_size() * t.numel() for t in tensors)


def rows_bytes(t, d_last, rows_past: int) -> int:
    """Bytes of rows 0 .. d_last + rows_past of each problem's slice of
    ``t`` (B, rows, ...): what a kernel that stops at d_last reads of it."""
    per_row = t[0, 0].numel() * t.element_size()
    rows = (d_last.long() + 1 + rows_past).clamp(max=t.shape[1])
    return int(rows.sum()) * per_row


def bound(name: str, moved: int, cells: int) -> tuple[float, str]:
    """(bound_ms, "bytes" or "operations") of one kernel call moving
    ``moved`` bytes (its inputs read once, its outputs written once) and
    working on ``cells`` cells."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_CELL[name] * cells / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(nvcc: str, flags, sources, out: str) -> subprocess.Popen:
    """nvcc -Xptxas -v of the sources into a throwaway cubin (started, not
    waited for): registers, stack, spills and shared memory of each kernel."""
    flags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return subprocess.Popen([nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o", out, *sources],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(text: str) -> list[str]:
    """One line per kernel: its (mangled) name, registers, stack and spills."""
    out, name, frame = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            frame = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {frame}")
            name = None
    return out


def kernel_problems(pore, W: int, Dp: int, B: int, rng, device):
    """B problems from make_sm3_problem on synthetic reads whose band fits a
    W-lane window and whose diagonal count fits Dp."""
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.core.band import band_construct
    from cpecan_signal_tpu_torch.core.window import smooth_band
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


def wide_problems(pore, B: int, rng, device):
    """B problems of unanchored synthetic reads of 960-1000 bases, whose
    band (expansion 50) needs a window of WIDE_W lanes."""
    import numpy as np

    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.core.band import band_construct
    from cpecan_signal_tpu_torch.core.window import smooth_band
    from cpecan_signal_tpu_torch.engine import pipeline as pp

    cases = []
    while len(cases) < B:
        target = "".join(rng.choice(list("ACGT"), int(rng.integers(960, 1000))))
        events, _path = syn.simulate_events(pore, target, rng)
        wb = smooth_band(band_construct(np.zeros((0, 2), dtype=np.int64), len(target) - 5,
                                        len(events), 50), width_multiple=128)
        if wb.W == WIDE_W:
            cases.append((target, events, wb))
    Dp = max(wb.n_diagonals for *_x, wb in cases)
    probs, plan = [], None
    for i, (target, events, wb) in enumerate(cases):
        plan, prob = pp.make_sm3_problem(pore, target, events, wb, device=device,
                                         ragged_left=bool(i % 2), pad_lx=1000,
                                         pad_ly=max(len(e) for _t, e, _w in cases),
                                         pad_d=Dp)
        probs.append(prob)
    return plan, pp.stack_problems(probs)


def phase_wide(pore, device, rng, stats) -> None:
    """Each kernel against its plain version on WIDE_W-lane windows, where
    stage 3 takes the backward kernel's 1024-thread instance (past
    NARROW_THREADS of csrc/fb_sm3.cu) and stage 4 its only one.  Adds the
    errors to ``stats``."""
    import torch

    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    plan, b = wide_problems(pore, 4, rng, device)
    W, Dp = WIDE_W, b.diag_scalars.shape[1] - 1
    edges = pp.to_device(edge_table(plan), device)
    groups = pp.sm3_wgroups(plan)
    E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    args = (edges, plan.match_state, E, F, b.diag_scalars, b.d_last, b.end, b.tp_scalar)
    P, T = fk.backward_sm3(*args)
    got = fk.backward_sm3(*args, stages=4, wgroups=groups)
    torch.cuda.synchronize()
    E_ref = fk.emissions_sm3_ref(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F_ref = fk.forward_sm3_ref(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    ref = fk.backward_sm3_ref(*args, 4, groups)   # its p, totals are stage 3's
    e4 = dict(zip(("p", "totals", "exits", "gacc", "stats"),
                  (max_err(a, r) for a, r in zip(got, ref))))
    ok = {"E": bool(((E - E_ref).abs() <= E_RTOL * E_ref.abs()).all()),
          "F": bool(torch.allclose(F, F_ref, atol=F_ATOL, rtol=F_RTOL)),
          "p": max_err(P, ref[0]) <= P_ATOL and e4["p"] <= P_ATOL,
          "totals": all(bool(torch.allclose(t, ref[1], atol=F_ATOL, rtol=F_RTOL))
                        for t in (T, got[1])),
          "exits/gacc": max(e4["exits"], e4["gacc"]) <= WIN_ATOL,
          "stats": bool(torch.allclose(got[4], ref[4], atol=STATS_ATOL, rtol=STATS_RTOL))}
    errs = {"emissions": max_err(E, E_ref), "forward": max_err(F, F_ref),
            "backward": max(max_err(P, ref[0]), max_err(T, ref[1])),
            "backward_em": max(e4.values())}
    ms3 = cuda_ms(lambda: fk.backward_sm3(*args), 3)
    ms4 = cuda_ms(lambda: fk.backward_sm3(*args, stages=4, wgroups=groups), 3)
    print(f"kernels W={W} Dp={Dp} B=4: errors {errs}; ok {ok}; ms backward {ms3:.3f}, "
          f"backward_em {ms4:.3f}", flush=True)
    if not all(ok.values()):
        raise AssertionError(f"kernel disagrees with its plain version at W={W}: {ok}")
    for k, e in errs.items():
        stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], e)


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def grid_cells(E) -> int:
    """Cells of an emission grid (every row computed, padding included)."""
    B, De, _C, W = E.shape
    return B * De * W


def phase_kernels(pore, device, rng) -> dict:
    """Each kernel against its plain version on the same CUDA tensors; the
    stage-4 backward at (W, Dp) in {64, 128} x 1024 and (128, 4096).  Times,
    bounds and the line's numbers are those of W = 128, Dp = 4096, B = 64."""
    import torch

    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    stats = {k: {"max_abs_err": 0.0} for k in KERNELS}
    for W, Dp in ((64, 1024), (128, 1024), (64, 4096), (128, 4096)):
        em = (W, Dp) != (64, 4096)
        plan, b = kernel_problems(pore, W, Dp, 64, rng, device)
        edges = pp.to_device(edge_table(plan), device)
        groups = pp.sm3_wgroups(plan)
        m = plan.match_state
        bargs = (b.diag_scalars, b.d_last, b.end, b.tp_scalar)

        def run_e():
            return fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp)

        def run_f():
            return fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)

        def run_b():
            return fk.backward_sm3(edges, m, E, F, *bargs)

        def run_b4():
            return fk.backward_sm3(edges, m, E, F, *bargs, stages=4, wgroups=groups)

        t0 = time.perf_counter()
        E = run_e()
        F = run_f()
        P, T = run_b()
        em_out = run_b4() if em else ()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        E_ref, e_plain = timed_once(lambda: fk.emissions_sm3_ref(b.x0, b.yr0, b.xarr,
                                                                 b.evr, W, Dp))
        F_ref, f_plain = timed_once(lambda: fk.forward_sm3_ref(
            edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar))
        (P_ref, T_ref), b_plain = timed_once(lambda: fk.backward_sm3_ref(
            edges, m, E, F, *bargs))
        errs = {"emissions": max_err(E, E_ref), "forward": max_err(F, F_ref),
                "backward": max(max_err(P, P_ref), max_err(T, T_ref))}
        ok = {"E": bool(((E - E_ref).abs() <= E_RTOL * E_ref.abs()).all()),
              "F": bool(torch.allclose(F, F_ref, atol=F_ATOL, rtol=F_RTOL)),
              "totals": bool(torch.allclose(T, T_ref, atol=F_ATOL, rtol=F_RTOL)),
              "p": bool(torch.allclose(P, P_ref, atol=P_ATOL, rtol=0))}
        times = {"emissions": (cuda_ms(run_e, 5), e_plain),
                 "forward": (cuda_ms(run_f, 3), f_plain),
                 "backward": (cuda_ms(run_b, 3), b_plain)}
        line = ""
        if em:
            ref4, b4_plain = timed_once(lambda: fk.backward_sm3_ref(
                edges, m, E, F, *bargs, 4, groups))
            e4 = dict(zip(("p", "totals", "exits", "gacc", "stats"),
                          (max_err(a, r) for a, r in zip(em_out, ref4))))
            ok.update({
                "em p/totals": e4["p"] <= P_ATOL and bool(torch.allclose(
                    em_out[1], ref4[1], atol=F_ATOL, rtol=F_RTOL)),
                "exits": e4["exits"] <= WIN_ATOL, "gacc": e4["gacc"] <= WIN_ATOL,
                "stats": bool(torch.allclose(em_out[4], ref4[4], atol=STATS_ATOL,
                                             rtol=STATS_RTOL))})
            errs["backward_em"] = max(e4.values())
            times["backward_em"] = (cuda_ms(run_b4, 3), b4_plain)
            line = ("; stage 4 err " + ", ".join(f"{k} {v:.3g}" for k, v in e4.items())
                    + f" (exits/gacc atol {WIN_ATOL}, stats atol {STATS_ATOL} rtol "
                    f"{STATS_RTOL})")
        print(f"kernels W={W} Dp={Dp} B=64: first call {t_first:.3f} s; "
              f"E err {errs['emissions']:.3g} (rtol {E_RTOL}); F err {errs['forward']:.3g} "
              f"(atol {F_ATOL} rtol {F_RTOL}); p err {max_err(P, P_ref):.3g} "
              f"(atol {P_ATOL}); totals err {max_err(T, T_ref):.3g}{line}; ok {ok}; "
              "ms kernel/plain: "
              + ", ".join(f"{k} {v[0]:.3f}/{v[1]:.3f}" for k, v in times.items()),
              flush=True)
        if not all(ok.values()):
            raise AssertionError(f"kernel disagrees with its plain version at "
                                 f"W={W} Dp={Dp}: {ok}")
        for k, e in errs.items():
            stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], e)
        if (W, Dp) == (128, 4096):
            # the recursions stop at d_last: they read E, F and the diagonal
            # scalars up to it (backward: E to d_last + 2, the scalars to
            # d_last + 1) and write every row of their outputs
            dl = b.d_last
            cells = int((dl.long() + 1).sum()) * W
            small = nbytes(dl, edges, b.tp_scalar)
            fwd_in = rows_bytes(E, dl, 0) + rows_bytes(b.diag_scalars, dl, 0)
            bwd_in = (rows_bytes(E, dl, 2) + rows_bytes(F, dl, 0)
                      + rows_bytes(b.diag_scalars, dl, 1) + nbytes(b.end))
            moved = {"emissions": (nbytes(b.x0, b.yr0, b.xarr, b.evr, E), grid_cells(E)),
                     "forward": (fwd_in + small + nbytes(b.start, F), cells),
                     "backward": (bwd_in + small + nbytes(P, T), cells),
                     "backward_em": (bwd_in + small + nbytes(*em_out), cells)}
            for k, (ms, plain) in times.items():
                stats[k]["ms"], stats[k]["plain_ms"] = ms, plain
                stats[k]["bound_ms"], stats[k]["bound_by"] = bound(k, *moved[k])
        del E, F, P, T, E_ref, F_ref, P_ref, T_ref, b, em_out
        torch.cuda.empty_cache()
    return stats


def read_jobs(paths, ref_seq, model_path, params):
    """Per-read split-job lists of the given npRead files (host prep)."""
    from cpecan_signal_tpu_torch.cli.vanilla_align import (guide_alignment,
                                                           prepare_read, strand_jobs)
    from cpecan_signal_tpu_torch.io.npread import load_npread
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model

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


def reset_launches(fk) -> None:
    for k in fk.LAUNCHES:
        fk.LAUNCHES[k] = 0


def phase_train(tmp, reads, ref, model, fk) -> dict:
    """cli/train_models on the read set on the card: EM_ITERATIONS
    iterations, launch counts of this path alone, the likelihood required
    not to fall."""
    from cpecan_signal_tpu_torch.cli import train_models
    from cpecan_signal_tpu_torch.em.accumulators import ContinuousPairHmm

    out_dir = os.path.join(tmp, "train")
    os.makedirs(out_dir)
    buf = io.StringIO()
    reset_launches(fk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_models.main(["-r", ref, "-d", reads, "-T", model, "-C", model,
                                "-i", str(EM_ITERATIONS), "-o", out_dir])
    t_train = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    log = buf.getvalue()
    strands = re.findall(r"strand (\w): (\d+) split jobs \((\d+) events\) in (\d+) "
                         r"device buckets", log)
    budget = re.search(r"EM bucket memory: (.*)", log)
    iters = [(float(s), float(lik)) for s, lik in
             re.findall(r"iteration \d+: E-step ([\d.]+) s, likelihood (-?[\d.]+)", log)]
    n_ev = sum(int(ev) for _s, _j, ev, _b in strands)
    liks = [lik for _s, lik in iters]
    print(f"train: rc={rc} {EM_ITERATIONS} iterations in {t_train:.2f} s; "
          + "; ".join(f"strand {s}: {j} split jobs, {ev} events, {nb} buckets"
                      for s, j, ev, nb in strands)
          + f"; bucket memory {budget.group(1) if budget else None}; likelihood {liks}; "
          f"E-step s {[s for s, _l in iters]}, events/s "
          f"{[round(n_ev / s) for s, _l in iters]}; launches {launches}", flush=True)
    if rc != 0 or len(iters) != EM_ITERATIONS or len(strands) != 2 or budget is None:
        raise AssertionError(f"train path failed: rc, iterations or strands\n{log}")
    # iteration 0 runs on the default gapX emissions, log 0.1 for every k-mer,
    # which do not sum to 1 over the k-mers; the first M-step normalizes
    # them, so EM's guarantee that the likelihood never falls holds from
    # iteration 1 on (as the JAX package's tests/test_cli.py states)
    for a, b in zip(liks[1:], liks[2:]):
        if b < a - LIK_DROP * abs(a):
            raise AssertionError(f"EM likelihood fell: {liks}")
    for k in ("emissions", "forward", "backward_em"):
        if launches[k] < 1:
            raise AssertionError(f"train path never launched the {k} kernel")
    for name in ("template", "complement"):
        hmm = ContinuousPairHmm.load(os.path.join(out_dir, f"{name}_trained.hmm"))
        if abs(hmm.transitions.sum(1) - 1.0).max() > 1e-5 or hmm.kmer_gap.sum() <= 0:
            raise AssertionError(f"{name}_trained.hmm is not a trained model")
    return launches


def phase_em_agreement(paths, ref_seq, model, device) -> None:
    """One E-step over the jobs of the 5 smallest reads, both strands: the
    card's kernels against the CPU plain path."""
    import numpy as np
    import torch

    from cpecan_signal_tpu_torch.cli.train_models import _prepare_read
    from cpecan_signal_tpu_torch.em import sm3_em
    from cpecan_signal_tpu_torch.io.npread import load_npread
    from cpecan_signal_tpu_torch.models.params import cli_defaults
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model

    params = cli_defaults()
    pore = load_pore_model(model)
    npreads = [load_npread(p) for p in paths]
    small = sorted(range(len(npreads)), key=lambda i: npreads[i].read_length)[:5]
    preps = [_prepare_read(ref_seq, npreads[i], params) for i in small]
    worst = {"trans": 0.0, "kmer_gap": 0.0, "likelihood": 0.0}
    n_jobs = 0
    for strand in ("t", "c"):
        jobs = sm3_em.collect_sm3_em_jobs(preps, {"t": pore, "c": pore}, params, strand)
        n_jobs += len(jobs)
        (t_c, k_c, l_c), (t_p, k_p, l_p) = (
            sm3_em.sm3_em_step(sm3_em.build_sm3_em_buckets(jobs, device=dev))
            for dev in (device, torch.device("cpu")))
        ok = (np.allclose(t_c, t_p, rtol=STEP_RTOL, atol=STEP_ATOL)
              and np.allclose(k_c, k_p, rtol=STEP_RTOL, atol=STEP_ATOL)
              and abs(l_c - l_p) <= LIK_RTOL * abs(l_p))
        worst["trans"] = max(worst["trans"], float(np.abs(t_c - t_p).max()))
        worst["kmer_gap"] = max(worst["kmer_gap"], float(np.abs(k_c - k_p).max()))
        worst["likelihood"] = max(worst["likelihood"], abs(l_c - l_p) / abs(l_p))
        if not ok:
            raise AssertionError(f"E-step on the card and the CPU disagree (strand "
                                 f"{strand}): {worst}")
    print(f"em agreement: one E-step over {n_jobs} jobs of the 5 smallest reads, cuda "
          f"vs cpu: max abs err trans {worst['trans']:.3g}, kmer_gap "
          f"{worst['kmer_gap']:.3g} (rtol {STEP_RTOL} atol {STEP_ATOL}), likelihood "
          f"relative {worst['likelihood']:.3g} (tol {LIK_RTOL})", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch reports no usable CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.cli import signal_align
    from cpecan_signal_tpu_torch.engine.align import collect_split_jobs
    from cpecan_signal_tpu_torch.engine.batch_align import (batch_align_jobs,
                                                            batch_align_stream)
    from cpecan_signal_tpu_torch.models.params import cli_defaults
    from cpecan_signal_tpu_torch.models.state_machines import make_signal_sm3
    from cpecan_signal_tpu_torch.ops import _build
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    t_start = time.perf_counter()
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"environment: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name}; nvidia-smi: {card}", flush=True)

    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        # the library and the register report build side by side
        t0 = time.perf_counter()
        report = ptxas_report(_build._nvcc(), _build.NVCC_FLAGS,
                              [str(p) for p in sorted(_build.CSRC.glob("*.cu"))],
                              os.path.join(tmp, "fb.cubin"))
        try:
            lib_path = _build.build()
            _build.load_library()
        finally:
            ptxas_out = report.communicate()[0]
        print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
        if report.returncode != 0:
            raise AssertionError(f"nvcc -Xptxas -v failed:\n{ptxas_out}")
        for line in ptxas_lines(ptxas_out):
            print(f"ptxas: {line}", flush=True)

        model = os.path.join(tmp, "synthetic.model")
        pore = syn.write_pore_model(model, rng)
        stats = phase_kernels(pore, device, rng)
        phase_wide(pore, device, rng, stats)

        # --- alignment path through the CLI; the reference and the reads
        # come from a generator of their own, so that the read set does not
        # depend on what the kernel phase draws
        data_rng = np.random.default_rng([SEED, 1])
        ref = os.path.join(tmp, "ref.fa")
        ref_seq = syn.write_reference(ref, 30000, data_rng)
        reads = os.path.join(tmp, "reads")
        paths = syn.write_read_set(reads, ref_seq, pore, 50, data_rng)
        os.environ["SIGALIGN_PLATFORM"] = "cuda"
        reset_launches(fk)
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
        if rc != 0 or labels != want or min(launches[k] for k in KERNELS[:3]) < 1:
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

        # --- timing of the device-batched alignment path
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
            target += syn.evolve_sequence(ref_seq, data_rng, 0.04, 0.02)
        target = target[:50000]
        events, path = syn.simulate_events(pore, target, data_rng)
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

        # --- training path through the CLI, and one E-step against the CPU
        launches["backward_em"] = phase_train(tmp, reads, ref, model, fk)["backward_em"]
        phase_em_agreement(paths, ref_seq, model, device)

    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
         "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
         "bound_ms": stats[k]["bound_ms"], "bound_by": stats[k]["bound_by"],
         "library_ms": None}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
