"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of cpecan_signal_tpu_torch from csrc/ (and prints
ptxas's registers and spills for each), holds each kernel against its plain
PyTorch version on the card (narrow windows, and 1024-lane ones: a
1024-thread recursion block) at the threeState, vanilla, echelon and
fiveState plans (the emissions also with offsets off the band, the tile
kernel's device-memory path), and the stage-4 configurations of the vanilla
and threeStateHdp E-steps, and the recursions' per-diagonal offsets (a start
or end vector moved by -2^16 moves only the totals; offset), then drives the
port's paths on 50 synthetic two-strand reads:

  * alignment: cli/signal_align -s (emissions, forward, stage-3 backward),
    checked against the CPU plain path and timed, and one 50 kb read, whose
    emissions launch is also checked and timed alone with its bound; that
    read's job and a 100 kb fiveState record held against the f64 oracle
    (drift: at most 1 pair missing or extra and 1.2e-3 posterior drift);
  * training: cli/train_models, threeState, 3 EM iterations on the card
    (emissions, forward, stage-4 backward), the likelihood required not to
    fall once the first M-step has normalized the model, and one E-step
    checked against the CPU plain path;
  * several processes: 2 ranks on the one card over gloo (distributed):
    signal_align -s on 10 reads and one train_models iteration, against one
    process;
  * the generic window machines: cli/signal_align with no machine flag
    (vanilla), --fourState and --echelon (forward, stage-3 backward; echelon
    with its per-state posteriors), each checked against the CPU plain path;
    vanilla timed;
  * vanilla training: cli/train_models --vanilla, 3 iterations (forward,
    stage-4 backward with the beta and alpha window groups and the
    transition channels gathered per skip bin on the card), one E-step
    checked against the CPU plain path and between two card runs bit for
    bit;
  * the HDP paths: cli/build_hdp from the threeState alignment's TSV (its
    input on the 5 smallest reads checked against the CPU plain path);
    threeStateHdp alignment with those HDPs (E built on the card from the
    density table; cli/vanilla_align --threeStateHdp on one read, the read
    set timed, checked against the CPU plain path); threeStateHdp training,
    cli/train_models --threeStateHdp, 3 iterations (stage-4 backward with
    one posterior channel per middle edge into match, pgroups), each
    iteration's HDPs rebuilt by Gibbs sampling; one E-step checked against
    the CPU plain path.

and the nucleotide paths on a synthetic 1 Mb genome pair (fiveState: the
backward kernel's per-edge-group posterior channels, pgroups, checked
against the plain versions first):

  * realignment: cli/realign over 10 guide CIGARs of 100 kb, 3 of them on
    the second genome's reverse strand, scored against the true alignment;
    two 1 kb records checked against the CPU plain path;
  * nucleotide EM: cli/em on the 1 Mb chunk, 3 iterations (forward, stage-4
    backward with pgroups), the likelihood required not to fall; one E-step
    over the small records checked against the CPU, and two card runs of
    one E-step over the chunk required to agree bit for bit.

and the f64 oracle's routes on the card (engine/fb.py, plain PyTorch, no
kernel of csrc/), each against the kernels' route: realign_record and
cli/em --engine host on the small records, train_models --engine host and
threeStateHdp at --assignmentThreshold 0 on the smallest reads, and
vanilla_align.align_read(device_batch=False); with the oracle's
microseconds a diagonal.

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

KERNELS = ("emissions", "forward", "backward", "backward_em", "backward_pstates",
           "backward_pgroups")
REPLACES = {
    "emissions": "cpecan_signal_tpu/ops/pallas_fb.py:162",
    "forward": "cpecan_signal_tpu/ops/pallas_fb.py:343",
    "backward": "cpecan_signal_tpu/ops/pallas_fb.py:627",
    "backward_em": "cpecan_signal_tpu/ops/pallas_fb.py:627 (stages=4, wgroups)",
    "backward_pstates": "cpecan_signal_tpu/ops/pallas_fb.py:627 (stages=3, pstates)",
    "backward_pgroups": "cpecan_signal_tpu/ops/pallas_fb.py:627 (stages=4, pgroups)",
}
# the generic window machines through the CLI: signal_align flags, the
# backward mode each launches, and how many of the smallest reads its
# card-vs-CPU check takes (the CPU plain echelon path takes ~50 ms a
# diagonal: the smallest read's two jobs of ~860 diagonals, about a minute;
# vanilla and fourState took 5 until PR 9's phases joined the run)
MACHINES = {"vanilla": ([], "backward", 3), "fourState": (["--fourState"], "backward", 3),
            "echelon": (["--echelon"], "backward_pstates", 1)}
# echelon's CLI run takes the first ECHELON_READS reads of the set: a read
# gives it about 90000 TSV rows, whose writing set the pace of that run
ECHELON_READS = 10
ECHELON_PSTATES = (1, 2, 3, 4, 5)   # match1..match5
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
# the f64 oracle's E-steps (exact logaddexp) against the kernels' (f32, the
# reference's cubic logAdd): threeState as tests/test_torch_em.py holds
# them, the nucleotide E-step as tests/test_torch_discrete.py (likelihood
# relative)
HOST_RTOL, HOST_ATOL = 1e-3, 1e-4
NUC_HOST_RTOL, NUC_HOST_ATOL, NUC_HOST_LIK = 2e-3, 1e-4, 1e-2
LIK_DROP = 1e-5               # largest relative fall of the EM likelihood
# whole-path tolerances (tests/test_readpath_random.py:89-96)
PAIR_TOL, PROB_TOL = 1, 1.2e-3
SEED = 20261016
EM_ITERATIONS = 3
WIDE_W = 1024   # the widest window: a recursion block of 1024 threads (csrc/fb_sm3.cu)
# threeState kernel checks against the plain versions (W, Dp), B = 64, the
# stage-4 backward at each ((64, 2048) was checked too until PR 9's phases
# joined the run).  The kernels line carries the numbers of LINE_SHAPE
# (backward_pstates: echelon at W = 128, Dp = 1024)
KERNEL_SHAPES = ((64, 1024), (128, 1024), (128, 4096))
LINE_SHAPE = (128, 4096)
# the generic plans' kernel checks, B problems each: (W, Dp, against the
# plain versions); vanilla also at a width and depth of the CLI's windows
GENERIC_B = 64
GENERIC_SHAPES = {"vanilla": ((128, 1024, True), (128, 4096, False), (256, 2048, True)),
                  "echelon": ((128, 1024, True), (128, 4096, False))}
# anchors every 80 events with expansion 50 give 256-lane windows
WIDE_BAND = {256: (80, 50)}
# the nucleotide workloads: a random genome X and its descendant Y (5 %
# substitutions, 0.5 % insertions and 0.5 % deletions, run lengths
# geometric with mean 2); NUC_RECORDS guide CIGARs of the true alignment,
# 100 kb of X each, the 1 Mb chunk cli/em takes as one job, those in
# NUC_REVERSE on Y's reverse strand (Y holds their segment reverse-
# complemented); NUC_SMALL (X start, length, the record it lies in) for the
# card-against-CPU checks
NUC_BASES, NUC_RECORDS, NUC_REVERSE = 1_000_000, 10, (2, 5, 8)
NUC_RATES = (0.05, 0.005, 0.005)
NUC_SMALL = ((20_000, 1000, 0), (520_000, 1000, 5))
QUALITY_MIN = 0.9   # precision and recall of the realigned pairs against the truth
# cli/em starts from Jukes-Cantor emissions at this divergence (its
# --setJukesCantorStartingEmissions; match-emission trace 0.7527): from
# random emissions three iterations leave the trace near 0.25 (0.22, 0.24,
# 0.27, 0.32, 0.57 over five iterations on a 4 kb CPU rehearsal)
NUC_JC_START = 0.3
# fiveState kernel checks against the plain versions, B = 64: (W, Dp, guide
# diagonal expansion, whether the forward and stage-3 backward are held
# against theirs too; the pgroups stage 4 always is) on segments of the
# genome pair of (Dp - 96) / 2 bases; the kernels line's backward_pgroups
# entry takes the W = 128 numbers.  The
# W = 64 check runs at Dp = 1024 and the small records are 1 kb, so that the
# plain versions, which set the pace of these checks, keep the run within
# its time limit on a slow host.  FIVE_WIDE (W, Dp, expansion, B): narrow
# bands in 1024-lane windows (1024-thread recursion blocks, 5 epilogue
# warps a block)
FIVE_SHAPES = ((64, 1024, 20, True), (128, 4096, 60, False))
FIVE_WIDE = (WIDE_W, 512, 20, 2)
# the two stage-4 configurations of the vanilla and threeStateHdp E-steps
# (B = 64): (W, Dp, against the plain versions); the plain versions, which
# set the pace of these checks, run at the smaller depth
STAGE4_SHAPES = ((128, 1024, True), (128, 4096, False))
STAGE4_GROUPS = {"vanilla": (((0,), (1,)), None),           # (wgroups, pgroups)
                 "threeStateHdp": (((0, 1, 2),), ((3,), (4,), (5,)))}
# the HDP phases: the grid and HdpType of build_hdp's defaults (30-90 pA,
# 1200 points, flat over ACEGOT); the Gibbs chain cut from the reference's
# 10000 samples, 100000 burn-in sweeps and thinning 100 to 2000 sweeps for
# the build (both strands in parallel; 4000 until PR 9's phases joined the
# run) and 400 for each training iteration's rebuild (of about 1.4 million
# assignments a strand)
HDP_GRID = (30.0, 90.0, 1200)
HDP_BUILD_GIBBS = ["--samples", "100", "--burnIn", "1000", "--thinning", "10"]
HDP_TRAIN_GIBBS = ["--samples", "20", "--burnIn", "200", "--thinning", "10"]
HDP_THRESHOLD = 0.01
# assignments (k-mer, event) of one E-step shared by the card and the CPU:
# a cell whose posterior lies within the posteriors' atol of the threshold
# may fall on either side
HDP_ASSIGN_SHARE = 0.99
# the vanilla and threeStateHdp E-steps are held to the CPU plain path on the
# EM_AGREE_READS smallest reads (5 until the f64 oracle's phase joined the
# run, 3 until PR 9's phases did)
EM_AGREE_READS = 2
# the offset phase: a boundary vector on the 2^-7 grid moved by -2^16 (exact
# in f32) must change the kernels' posteriors and tallies by no more than
# OFFSET_ATOL and move every total by 2^16 to its f32 spacing
OFFSET_SHIFT, OFFSET_GRID, OFFSET_ATOL = 2.0 ** 16, 2.0 ** -7, 1e-6
# the distributed phase: ranks on the one card, the reads they share
DIST_RANKS, DIST_READS = 2, 10

# The least time the card could take for a kernel's work: the larger of its
# bytes (every input read once, every output written once) at the H100
# SXM's 3.35 TB/s and its f32 operations at 67 TFLOP/s (no tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
LADD_OPS = 14   # the reference logAdd, counted in csrc/fb_sm3.cu


def ops_per_cell(kernel: str, edges, n_states: int = 0, n_post: int = 1,
                 wgroups=(), pgroups=()) -> int:
    """f32 operations per window cell of one launch, counted from
    csrc/fb_sm3.cu and the launch's edge table (an exp or a log is 1).
    An edge adds each of its terms (emission class, per-cell channels,
    scalar transitions) to its source and logAdds the sum: terms + 14.
    forward: its edges.  backward (stage 3): the recursion's edges, the
    middle edges of the match-through-diagonal correction, per state 11
    (3 adds forming the two logsumexps' terms, and in each a max, a
    subtract, an exp and an add), per posterior channel 4 (add, subtract,
    min, exp) and 7 a cell (the logsumexps' log and add, the 3 mask tests).
    stage 4 adds per edge 6 + terms (source + b, terms, - total, min, exp,
    mask, tally add), per window group its member edges + 2 (tally add,
    shift) and the likelihood's add; with edge groups (backward_pgroups) the
    channel sums' adds, one per group member, replace the match posterior's
    4."""
    rows = edges.tolist()
    terms = [1 + sum(1 for v in r[4:] if v >= 0) for r in rows]
    edge_ops = sum(t + LADD_OPS for t in terms)
    if kernel == "forward":
        return edge_ops
    middle = sum(t + LADD_OPS for t, r in zip(terms, rows) if r[0] == 1)
    ops = edge_ops + middle + 11 * n_states + 4 * n_post + 7
    if kernel in ("backward_em", "backward_pgroups"):
        ops += sum(6 + t for t in terms) + sum(len(g) + 2 for g in wgroups) + 1
    if kernel == "backward_pgroups":
        ops += sum(len(g) for g in pgroups) - 4 * n_post
    return ops


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


def bound(ops: int, moved: int, cells: int) -> tuple[float, str]:
    """(bound_ms, "bytes" or "operations") of one kernel call moving
    ``moved`` bytes (its inputs read once, its outputs written once) and
    doing ``ops`` operations on each of ``cells`` cells."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops * cells / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def recursion_inputs(E, F, ds, d_last, small: int) -> tuple[int, int]:
    """Input bytes of a forward and of a backward launch: the recursions
    stop at d_last, so they read E, F and the diagonal scalars up to it
    (backward: E to d_last + 2, the scalars to d_last + 1), and the small
    arguments (d_last, edges, scalar terms) once."""
    return (rows_bytes(E, d_last, 0) + rows_bytes(ds, d_last, 0) + small,
            rows_bytes(E, d_last, 2) + rows_bytes(F, d_last, 0)
            + rows_bytes(ds, d_last, 1) + small)


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
    """Each kernel against its plain version on WIDE_W-lane windows (the
    recursions' 1024-thread blocks, stages 3 and 4).  Adds the errors to
    ``stats``."""
    import torch

    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    plan, b = wide_problems(pore, 4, rng, device)
    W, Dp = WIDE_W, b.diag_scalars.shape[1] - 1
    edges = pp.to_device(edge_table(plan), device)
    groups = pp.sm3_wgroups(plan)
    E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F, offF = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    args = (edges, plan.match_state, E, F, offF, b.diag_scalars, b.d_last, b.end,
            b.tp_scalar)
    P, T = fk.backward_sm3(*args)
    got = fk.backward_sm3(*args, stages=4, wgroups=groups)
    torch.cuda.synchronize()
    E_ref = fk.emissions_sm3_ref(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F_ref, offF_ref = fk.forward_sm3_ref(edges, E, b.diag_scalars, b.d_last, b.start,
                                         b.tp_scalar)
    ref = fk.backward_sm3_ref(*args, 4, groups)   # its p, totals are stage 3's
    e4 = dict(zip(("p", "totals", "exits", "gacc", "stats"),
                  (max_err(a, r) for a, r in zip(got, ref))))
    ok = {"E": bool(((E - E_ref).abs() <= E_RTOL * E_ref.abs()).all()),
          "F": forward_ok(F, offF, F_ref, offF_ref),
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


def forward_ok(F, offF, F_ref, offF_ref) -> bool:
    """The forward kernel's (F, offF) against its plain version's: F, stored
    relative to the offsets, within the F tolerance; the offsets (sums of
    row maxima) equal."""
    import torch

    return bool(torch.allclose(F, F_ref, atol=F_ATOL, rtol=F_RTOL)
                and torch.equal(offF, offF_ref))


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def grid_cells(E) -> int:
    """Cells of an emission grid (every row computed, padding included)."""
    B, De, _C, W = E.shape
    return B * De * W


def emission_inputs(rng, B: int, Dp: int, W: int, device, *, random_tiles=False,
                    unaligned=False, w0_start=0, lY=None, cols=None):
    """Inputs (x0, yr0, xarr, evr) of an emissions launch on ``device``: B
    problems' x packs and event rows drawn at random, and the offsets that
    pipeline.band_scalars gives for random +-1 walks of w0 from about
    ``w0_start`` (band offsets; lY drawn from ``lY``, default Dp/4..Dp/2).
    The rows hold ``cols`` = (lXp, lYp) columns, by default Dp / 2 and Dp
    and two windows on each side, in 16-byte units (``unaligned``: 1 and 3
    floats more, so that no row starts on 16 bytes).  With ``random_tiles``
    every other tile of the kernel's diagonals takes offsets anywhere, past
    both ends of the rows."""
    import numpy as np
    import torch

    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    lXp, lYp = cols or (Dp // 8 * 4 + 4 * W, Dp // 4 * 4 + 4 * W)
    if unaligned:
        lXp, lYp = lXp + 1, lYp + 3
    steps = rng.choice([-1, 1], (B, Dp))
    steps[:, 0] = 0
    w0 = (w0_start + 2 * rng.integers(-20, 20, (B, 1)) + np.cumsum(steps, 1)).astype(np.int32)
    lo, hi = lY or (Dp // 4, Dp // 2)
    _ds, x0, yr0 = pp.band_scalars(torch.from_numpy(np.stack([w0, w0, w0 + 2 * W], 1)),
                                   torch.from_numpy(rng.integers(lo, hi, B).astype(np.int32)),
                                   W, lXp, lYp)
    if random_tiles:
        odd = torch.from_numpy((np.arange(Dp + 1) // fk.emission_config(W)[0]) % 2 == 1)
        n_odd = int(odd.sum())
        x0[:, odd] = torch.from_numpy(rng.integers(-W - 5, lXp + 5, (B, n_odd)).astype(np.int32))
        yr0[:, odd] = torch.from_numpy(rng.integers(-W - 5, lYp + 5, (B, n_odd)).astype(np.int32))
    xarr = rng.normal(0, 3, (B, 13, lXp)).astype(np.float32)
    evr = rng.normal(50, 10, (B, 2, lYp)).astype(np.float32)
    return tuple(t.to(device) for t in (x0, yr0, torch.from_numpy(xarr), torch.from_numpy(evr)))


def emissions_agree(E, E_ref) -> tuple[float, bool, bool]:
    """(max abs error, equal bit for bit, within E_RTOL) of the kernel's E
    against the plain version's."""
    return (max_err(E, E_ref), bool((E == E_ref).all()),
            bool(((E - E_ref).abs() <= E_RTOL * E_ref.abs()).all()))


def emissions_bound(x0, yr0, xarr, evr, E) -> tuple[float, str]:
    """bound() of one emissions launch: its inputs read once and E written
    once, 28 f32 operations a cell of E (4 Gaussians of 6, then 4 adds and
    clamps; csrc/fb_sm3.cu emit_cell)."""
    return bound(28, nbytes(x0, yr0, xarr, evr, E), grid_cells(E))


@contextlib.contextmanager
def recording_emissions(fk, calls: list):
    """Within the block, each call of fk.emissions_sm3 appends its arguments
    to ``calls`` (the call itself is made as before)."""
    real = fk.emissions_sm3

    def record(*args):
        calls.append(args)
        return real(*args)

    fk.emissions_sm3 = record
    try:
        yield
    finally:
        fk.emissions_sm3 = real


def phase_emissions(device, rng, stats) -> None:
    """The emissions kernel against its plain version off the band: every
    other tile of diagonals with random offsets past both ends of the rows
    (the tile kernel's device-memory path) at B = 64, W = 128, Dp = 4096 and
    at W = 1024, and rows that do not start on 16 bytes.  Adds the errors
    to ``stats``."""
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    out = []
    for W, Dp, B, unaligned in ((128, 4096, 64, False), (1024, 512, 8, False),
                                (128, 1000, 4, True)):
        x0, yr0, xarr, evr = emission_inputs(rng, B, Dp, W, device, random_tiles=True,
                                             unaligned=unaligned)
        err, equal, ok = emissions_agree(fk.emissions_sm3(x0, yr0, xarr, evr, W, Dp),
                                         fk.emissions_sm3_ref(x0, yr0, xarr, evr, W, Dp))
        out.append(f"W={W} Dp={Dp} B={B}{' unaligned rows' if unaligned else ''}: "
                   f"err {err:.3g}, equal {equal}, ok {ok}")
        if not ok:
            raise AssertionError(f"emissions disagree with the plain version off the "
                                 f"band: {out[-1]}")
        stats["emissions"]["max_abs_err"] = max(stats["emissions"]["max_abs_err"], err)
    print(f"emissions, random offsets in every other tile (rtol {E_RTOL}): "
          + "; ".join(out), flush=True)


def phase_long_emissions(args, card: str, stats) -> None:
    """The 50 kb read's emissions launch (``args`` as the path called it):
    against the plain version, timed, with its bound."""
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    x0, yr0, xarr, evr, W, Dp = args
    E = fk.emissions_sm3(*args)
    E_ref, plain = timed_once(lambda: fk.emissions_sm3_ref(*args))
    err, equal, ok = emissions_agree(E, E_ref)
    ms = cuda_ms(lambda: fk.emissions_sm3(*args), 20)
    bound_ms, by = emissions_bound(x0, yr0, xarr, evr, E)
    print(f"emissions 50 kb read: W={W} Dp={Dp} B={x0.shape[0]}: ms {ms:.4f}, bound "
          f"{bound_ms:.4f} ({by}), plain {plain:.3f}; err {err:.3g}, equal {equal}, "
          f"ok {ok}; card {card}", flush=True)
    if not ok:
        raise AssertionError("emissions of the 50 kb read disagree with the plain version")
    stats["emissions"]["max_abs_err"] = max(stats["emissions"]["max_abs_err"], err)


def phase_kernels(pore, device, rng) -> dict:
    """Each kernel against its plain version on the same CUDA tensors at B =
    64 and (W, Dp) in KERNEL_SHAPES (the stage-4 backward where W = 128 or
    Dp = 1024).  The line's numbers, times and bounds are those of
    LINE_SHAPE."""
    import torch

    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    stats = {k: {"max_abs_err": 0.0} for k in KERNELS}
    for W, Dp in KERNEL_SHAPES:
        em = W == 128 or Dp == 1024
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
            return fk.backward_sm3(edges, m, E, F, offF, *bargs)

        def run_b4():
            return fk.backward_sm3(edges, m, E, F, offF, *bargs, stages=4, wgroups=groups)

        t0 = time.perf_counter()
        E = run_e()
        F, offF = run_f()
        P, T = run_b()
        em_out = run_b4() if em else ()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        runs = {"emissions": (run_e, 5), "forward": (run_f, 3), "backward": (run_b, 3)}
        if em:
            runs["backward_em"] = (run_b4, 3)
        ms = {k: cuda_ms(fn, reps) for k, (fn, reps) in runs.items()}
        head = f"kernels W={W} Dp={Dp} B=64: first call {t_first:.3f} s"
        E_ref, e_plain = timed_once(lambda: fk.emissions_sm3_ref(b.x0, b.yr0, b.xarr,
                                                                 b.evr, W, Dp))
        (F_ref, offF_ref), f_plain = timed_once(lambda: fk.forward_sm3_ref(
            edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar))
        (P_ref, T_ref), b_plain = timed_once(lambda: fk.backward_sm3_ref(
            edges, m, E, F, offF, *bargs))
        errs = {"emissions": max_err(E, E_ref), "forward": max_err(F, F_ref),
                "backward": max(max_err(P, P_ref), max_err(T, T_ref))}
        ok = {"E": bool(((E - E_ref).abs() <= E_RTOL * E_ref.abs()).all()),
              "F": forward_ok(F, offF, F_ref, offF_ref),
              "totals": bool(torch.allclose(T, T_ref, atol=F_ATOL, rtol=F_RTOL)),
              "p": bool(torch.allclose(P, P_ref, atol=P_ATOL, rtol=0))}
        plain = {"emissions": e_plain, "forward": f_plain, "backward": b_plain}
        line = ""
        if em:
            ref4, plain["backward_em"] = timed_once(lambda: fk.backward_sm3_ref(
                edges, m, E, F, offF, *bargs, 4, groups))
            e4 = dict(zip(("p", "totals", "exits", "gacc", "stats"),
                          (max_err(a, r) for a, r in zip(em_out, ref4))))
            ok.update({
                "em p/totals": e4["p"] <= P_ATOL and bool(torch.allclose(
                    em_out[1], ref4[1], atol=F_ATOL, rtol=F_RTOL)),
                "exits": e4["exits"] <= WIN_ATOL, "gacc": e4["gacc"] <= WIN_ATOL,
                "stats": bool(torch.allclose(em_out[4], ref4[4], atol=STATS_ATOL,
                                             rtol=STATS_RTOL))})
            errs["backward_em"] = max(e4.values())
            line = ("; stage 4 err " + ", ".join(f"{k} {v:.3g}" for k, v in e4.items())
                    + f" (exits/gacc atol {WIN_ATOL}, stats atol {STATS_ATOL} rtol "
                    f"{STATS_RTOL})")
        print(f"{head}; E err {errs['emissions']:.3g} (rtol {E_RTOL}); F err "
              f"{errs['forward']:.3g} (atol {F_ATOL} rtol {F_RTOL}); p err "
              f"{max_err(P, P_ref):.3g} (atol {P_ATOL}); totals err {max_err(T, T_ref):.3g}"
              f"{line}; ok {ok}; ms kernel/plain: "
              + ", ".join(f"{k} {ms[k]:.3f}/{plain[k]:.3f}" for k in ms),
              flush=True)
        if not all(ok.values()):
            raise AssertionError(f"kernel disagrees with its plain version at "
                                 f"W={W} Dp={Dp}: {ok}")
        for k, e in errs.items():
            stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], e)
        if (W, Dp) == LINE_SHAPE:
            dl = b.d_last
            cells = int((dl.long() + 1).sum()) * W
            fwd_in, bwd_in = recursion_inputs(E, F, b.diag_scalars, dl,
                                              nbytes(dl, edges, b.tp_scalar))
            S = plan.n_states
            moved = {"forward": (ops_per_cell("forward", edges),
                                 fwd_in + nbytes(b.start, F, offF), cells),
                     "backward": (ops_per_cell("backward", edges, S),
                                  bwd_in + nbytes(b.end, offF, P, T), cells),
                     "backward_em": (ops_per_cell("backward_em", edges, S, wgroups=groups),
                                     bwd_in + nbytes(b.end, offF, *em_out), cells)}
            for k in ms:
                stats[k]["ms"], stats[k]["plain_ms"] = ms[k], plain[k]
                stats[k]["bound_ms"], stats[k]["bound_by"] = (
                    emissions_bound(b.x0, b.yr0, b.xarr, b.evr, E) if k == "emissions"
                    else bound(*moved[k]))
        del E, F, offF, P, T, E_ref, F_ref, P_ref, T_ref, b, em_out
        torch.cuda.empty_cache()
    return stats


def long_read_jobs(pore, ref_seq, rng, params):
    """(events, split jobs) of the 50 kb read: 50000 bases evolved from the
    reference (4 % substitutions, 2 % indels), its simulated events, anchors
    at every 40th pair of its true path; it makes one unsplit job."""
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.engine.align import collect_split_jobs
    from cpecan_signal_tpu_torch.models.state_machines import make_signal_sm3

    target = ""
    while len(target) < 50000:
        target += syn.evolve_sequence(ref_seq, rng, 0.04, 0.02)
    target = target[:50000]
    events, path = syn.simulate_events(pore, target, rng)
    anchors = syn.path_anchors(path, len(target) - 5, len(events), 40)
    return events, collect_split_jobs(lambda t, e: make_signal_sm3(pore, t, e), target,
                                      events, anchors, params)


def read_jobs(paths, ref_seq, model_path, params, sm_type="threeState", hdp_density=None):
    """Per-read split-job lists of the given npRead files (host prep);
    threeStateHdp takes ``hdp_density``, a strand's density by "t" / "c"."""
    from cpecan_signal_tpu_torch.cli.vanilla_align import (guide_alignment,
                                                           prepare_read, strand_jobs)
    from cpecan_signal_tpu_torch.io.npread import load_npread
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model

    pore = load_pore_model(model_path)
    out = []
    for path in paths:
        npr = load_npread(path)
        guide = guide_alignment(ref_seq, npr.twoD_read, params.constraint_diagonal_trim)
        prep = prepare_read(ref_seq, npr, params, sm_type=sm_type, guide=guide,
                            substitute=None, template_model=pore,
                            complement_model=pore, hdp_density=hdp_density)
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


def generic_problems(pore, name: str, W: int, Dp: int, B: int, rng, device,
                     n_distinct: int = 4, width_multiple: int | None = None,
                     bases: tuple[int, int] | None = None):
    """(plan, WindowProblem batch) of B problems of the vanilla or echelon
    machine (template strand) whose window is W lanes and whose diagonals
    fit Dp: ``n_distinct`` synthetic reads (ragged ends mixed) repeated
    across the batch, so the host builds few emission grids.  Reads are
    anchored every 20 events with expansion 20 (WIDE_BAND's spacing and
    expansion at its widths), or with ``bases`` drawn unanchored (expansion
    50) and the window rounded to ``width_multiple``."""
    import numpy as np
    import torch

    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.core.band import band_construct
    from cpecan_signal_tpu_torch.core.window import smooth_band
    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.models import state_machines as sms

    make = {"vanilla": sms.make_signal_vanilla, "echelon": sms.make_signal_echelon}[name]
    probs, plan = [], None
    while len(probs) < n_distinct:
        n_bases = int(rng.integers(*bases)) if bases else int(0.40 * Dp)
        target = "".join(rng.choice(list("ACGT"), n_bases))
        events, path = syn.simulate_events(pore, target, rng)
        n_kmers = len(target) - 5
        if bases:
            band = band_construct(np.zeros((0, 2), dtype=np.int64), n_kmers, len(events), 50)
        else:
            every, expansion = WIDE_BAND.get(W, (20, 20))
            band = band_construct(syn.path_anchors(path, n_kmers, len(events), every),
                                  n_kmers, len(events), expansion)
        wb = smooth_band(band, width_multiple=width_multiple or W)
        if wb.W != W or wb.n_diagonals > Dp:
            continue
        plan, prob = pp.make_window_problem(make(pore, target, events, "template"), wb,
                                            device=device, ragged_left=bool(len(probs) % 2),
                                            ragged_right=len(probs) < 2, pad_d=Dp)
        probs.append(prob)
    batch = pp.stack_window_problems(probs)
    idx = torch.arange(B, device=device) % n_distinct
    return plan, pp.WindowProblem(*(f[idx] for f in batch))


def phase_generic_kernels(pore, device, rng, stats) -> None:
    """The forward and stage-3 backward kernels at the vanilla plan (3
    states, 7 edges, 8 channels) and the echelon plan (7 states, 46 edges,
    17 channels; backward with the per-state posteriors), B = 64 (4 distinct
    problems repeated) at GENERIC_SHAPES: timed, and where marked held
    against their plain versions and these timed; then echelon on a
    1024-lane window.  The backward_pstates entry of the kernels line takes
    the W = 128, Dp = 1024 numbers (the plain echelon backward takes about a
    minute there); errors join ``stats``."""
    import torch

    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    for name, shapes in GENERIC_SHAPES.items():
        pstates = ECHELON_PSTATES if name == "echelon" else None
        bname = "backward_pstates" if pstates else "backward"
        for W, Dp, check in shapes:
            plan, b = generic_problems(pore, name, W, Dp, GENERIC_B, rng, device)
            edges = pp.to_device(edge_table(plan), device)
            fargs = (edges, b.E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)

            def run_f():
                return fk.forward_sm3(*fargs)

            F, offF = run_f()

            def run_b():
                return fk.backward_sm3(edges, plan.match_state, b.E, F, offF, b.diag_scalars,
                                       b.d_last, b.end, b.tp_scalar, pstates=pstates)

            P, T = run_b()
            torch.cuda.synchronize()
            head = (f"kernels {name} plan ({plan.n_states} states, {len(plan.edges)} edges, "
                    f"{b.E.shape[2]} channels) W={W} Dp={Dp} B={GENERIC_B}")
            ms = {"forward": cuda_ms(run_f, 3), bname: cuda_ms(run_b, 3)}
            plain = {}
            if check:
                (F_ref, offF_ref), plain["forward"] = timed_once(
                    lambda: fk.forward_sm3_ref(*fargs))
                (P_ref, T_ref), plain[bname] = timed_once(lambda: fk.backward_sm3_ref(
                    edges, plan.match_state, b.E, F, offF, b.diag_scalars, b.d_last, b.end,
                    b.tp_scalar, pstates=pstates))
                errs = {"F": max_err(F, F_ref), "p": max_err(P, P_ref),
                        "totals": max_err(T, T_ref)}
                ok = {"F": forward_ok(F, offF, F_ref, offF_ref),
                      "p": errs["p"] <= P_ATOL,
                      "totals": bool(torch.allclose(T, T_ref, atol=F_ATOL, rtol=F_RTOL))}
                head += f": errors {errs}; ok {ok}"
                if not all(ok.values()):
                    raise AssertionError(f"{head}: kernel disagrees with its plain version")
                stats["forward"]["max_abs_err"] = max(stats["forward"]["max_abs_err"],
                                                      errs["F"])
                stats[bname]["max_abs_err"] = max(stats[bname]["max_abs_err"],
                                                  errs["p"], errs["totals"])
            dl = b.d_last
            cells = int((dl.long() + 1).sum()) * W
            fwd_in, bwd_in = recursion_inputs(b.E, F, b.diag_scalars, dl,
                                              nbytes(dl, edges, b.tp_scalar))
            n_post = len(pstates) if pstates else 1
            bounds = {"forward": bound(ops_per_cell("forward", edges), fwd_in
                                       + nbytes(b.start, F, offF), cells),
                      bname: bound(ops_per_cell(bname, edges, plan.n_states, n_post),
                                   bwd_in + nbytes(b.end, offF, P, T), cells)}
            print(f"{head}; ms kernel/plain/bound: "
                  + ", ".join(f"{k} {ms[k]:.3f}/"
                              + (f"{plain[k]:.3f}" if k in plain else "not timed")
                              + f"/{bounds[k][0]:.4f} ({bounds[k][1]})" for k in ms),
                  flush=True)
            if name == "echelon" and (W, Dp) == (128, 1024):
                stats[bname].update(ms=ms[bname], plain_ms=plain[bname],
                                    bound_ms=bounds[bname][0], bound_by=bounds[bname][1])
            del F, offF, P, T, b
            torch.cuda.empty_cache()

    # echelon on a 1024-lane window: 4 x 7 carry rows of 1026 floats (115 KB
    # of shared memory) leave no room for 3 E rows of 17 channels, so the
    # recursions take their unstaged route (csrc/fb_sm3.cu ring_depth)
    plan, b = generic_problems(pore, "echelon", WIDE_W, 360, 2, rng, device, n_distinct=2,
                               width_multiple=WIDE_W, bases=(150, 170))
    edges = pp.to_device(edge_table(plan), device)
    fargs = (edges, b.E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    F, offF = fk.forward_sm3(*fargs)
    bargs = (edges, plan.match_state, b.E, F, offF, b.diag_scalars, b.d_last, b.end,
             b.tp_scalar)
    P, T = fk.backward_sm3(*bargs, pstates=ECHELON_PSTATES)
    torch.cuda.synchronize()
    F_ref, offF_ref = fk.forward_sm3_ref(*fargs)
    P_ref, T_ref = fk.backward_sm3_ref(*bargs, pstates=ECHELON_PSTATES)
    errs = {"F": max_err(F, F_ref), "p": max_err(P, P_ref), "totals": max_err(T, T_ref)}
    ok = (forward_ok(F, offF, F_ref, offF_ref) and errs["p"] <= P_ATOL
          and torch.allclose(T, T_ref, atol=F_ATOL, rtol=F_RTOL))
    print(f"kernels echelon W={WIDE_W} Dp={b.diag_scalars.shape[1] - 1} B=2: errors "
          f"{errs}; ok {ok}", flush=True)
    if not ok or float(P.sum()) <= 0:
        raise AssertionError("echelon kernels disagree with their plain versions "
                             f"at W={WIDE_W}: {errs}")
    stats["forward"]["max_abs_err"] = max(stats["forward"]["max_abs_err"], errs["F"])
    stats["backward_pstates"]["max_abs_err"] = max(stats["backward_pstates"]["max_abs_err"],
                                                   errs["p"], errs["totals"])


def phase_generic_cli(tmp, reads, ref, model, paths, fk, machine: str) -> dict:
    """cli/signal_align with one generic machine on the read set on the
    card: the launches of this run alone, the batch's seconds by stage."""
    from cpecan_signal_tpu_torch.cli import signal_align

    flags, bname, _n = MACHINES[machine]
    out = os.path.join(tmp, f"out_{machine}")
    buf = io.StringIO()
    reset_launches(fk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = signal_align.main(["-d", reads, "-r", ref, "-o", out, "-T", model, "-C", model,
                                *flags])
    t_cli = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    with open(os.path.join(out, "posteriors.tsv")) as fh:
        rows = [line.split("\t") for line in fh]
    labels = {r[3] for r in rows}
    stages = re.search(r"seconds by stage: (.*)", buf.getvalue())
    print(f"cli {machine}: rc={rc} {len(rows)} TSV rows, {len(labels)}/{len(paths)} reads, "
          f"launches {launches}, {t_cli:.2f} s; batch seconds by stage: "
          f"{stages.group(1) if stages else None}", flush=True)
    if rc != 0 or labels != {os.path.basename(p) for p in paths}:
        raise AssertionError(f"{machine} path failed: rc or reads")
    if launches["forward"] < 1 or launches[bname] < 1:
        raise AssertionError(f"{machine} path never launched the forward or {bname} kernel")
    return launches


def phase_generic_agreement(small_paths, ref_seq, model, device, machine: str) -> None:
    """batch_align_jobs of one machine over the jobs of the given reads:
    the card's kernels against the CPU plain path."""
    import torch

    from cpecan_signal_tpu_torch.engine.batch_align import batch_align_jobs
    from cpecan_signal_tpu_torch.models.params import cli_defaults

    params = cli_defaults()
    jobs = [j for jl in read_jobs(small_paths, ref_seq, model, params, machine) for j in jl]
    t0 = time.perf_counter()
    got = batch_align_jobs(jobs, params.threshold, device=device)
    t1 = time.perf_counter()
    want = batch_align_jobs(jobs, params.threshold, device=torch.device("cpu"))
    t2 = time.perf_counter()
    worst = [pairs_agree(g, w) for g, w in zip(got, want)]
    miss = max(m for m, _ in worst)
    drift = max(d for _, d in worst)
    print(f"agreement {machine}: {len(jobs)} jobs of {len(small_paths)} reads, cuda vs cpu "
          f"({t1 - t0:.2f} s / {t2 - t1:.2f} s): max pairs differing {miss} (tol {PAIR_TOL}), "
          f"max posterior drift {drift:.3g} (tol {PROB_TOL})", flush=True)
    if miss > PAIR_TOL or drift > PROB_TOL:
        raise AssertionError(f"{machine}: cuda and cpu paths disagree")


def phase_vanilla_timing(paths, ref_seq, model, device, card: str) -> None:
    """batch_align_stream of the default machine (vanilla) over the read
    set, median of 3 runs, each from prepared split jobs to pairs: host
    packing of the emission grids, the card's work, the host extraction."""
    import torch

    from cpecan_signal_tpu_torch.engine.batch_align import batch_align_stream
    from cpecan_signal_tpu_torch.models.params import cli_defaults

    params = cli_defaults()
    per_read = read_jobs(paths, ref_seq, model, params, "vanilla")
    runs = []
    for _ in range(3):
        timing = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_align_stream(iter(per_read), params.threshold, device=device, timing=timing)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, timing))
    t_med, timing = sorted(runs, key=lambda r: r[0])[1]
    n_jobs = sum(len(jl) for jl in per_read)
    print(f"timing vanilla: {len(paths)} reads ({n_jobs} split jobs) batch_align_stream "
          f"median of 3 {t_med:.4f} s (runs {', '.join(f'{t:.4f}' for t, _ in runs)}): "
          f"{len(paths) / t_med:.2f} reads/s; median run by stage "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(timing.items()))
          + f"; card {card}", flush=True)


def nucleotide_set(tmp) -> dict:
    """The nucleotide workloads' inputs, from a generator of their own
    (default_rng([SEED, 2])): the genome pair (FASTA), the NUC_RECORDS guide
    records (a CIGAR file and the same lines for stdin), the small records,
    and per record the true aligned pairs in its own coordinates (x - x1,
    y - the record's first y)."""
    import numpy as np

    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.core.amap import pairs_to_cigar_ops
    from cpecan_signal_tpu_torch.io.cigar import CigarRecord
    from cpecan_signal_tpu_torch.io.fasta import reverse_complement, write_fasta

    rng = np.random.default_rng([SEED, 2])
    x = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, NUC_BASES)].tobytes().decode()
    y, truth = syn.evolve_with_truth(x, rng, *NUC_RATES)
    step = NUC_BASES // NUC_RECORDS
    spans = []
    for k in range(NUC_RECORDS):
        sel = truth[(truth[:, 0] >= k * step) & (truth[:, 0] < (k + 1) * step)]
        spans.append((int(sel[0, 1]), int(sel[-1, 1]) + 1))
    # Y as stored: the reverse records' segments reverse-complemented
    pieces, pos = [], 0
    for k in NUC_REVERSE:
        a, b = spans[k]
        pieces += [y[pos:a], reverse_complement(y[a:b])]
        pos = b
    y_fa = "".join(pieces + [y[pos:]])

    def record(x1, x2, k):
        sel = truth[(truth[:, 0] >= x1) & (truth[:, 0] < x2)]
        c, d = int(sel[0, 1]), int(sel[-1, 1]) + 1
        local = sel - [x1, c]
        ops = pairs_to_cigar_ops(np.concatenate([np.ones((len(local), 1), dtype=np.int64),
                                                 local], axis=1), x2 - x1, d - c)
        if k in NUC_REVERSE:   # y[c:d] is the reverse complement of y_fa[a+b-d:a+b-c]
            a, b = spans[k]
            rec = CigarRecord("X", x1, x2, True, "Y", a + b - c, a + b - d, False, 0.0, ops)
        else:
            rec = CigarRecord("X", x1, x2, True, "Y", c, d, True, 0.0, ops)
        return rec, local

    big = [record(k * step, (k + 1) * step, k) for k in range(NUC_RECORDS)]
    small = [record(x1, x1 + n, k)[0] for x1, n, k in NUC_SMALL]
    fasta = os.path.join(tmp, "pair.fa")
    write_fasta(fasta, [("X", x), ("Y", y_fa)])
    text = "".join(r.to_line() + "\n" for r, _t in big)
    cigars = os.path.join(tmp, "pair.cig")
    with open(cigars, "w") as fh:
        fh.write(text)
    return {"x": x, "y": y, "seqs": {"X": x, "Y": y_fa}, "fasta": fasta, "cigars": cigars,
            "text": text, "records": [r for r, _t in big], "truth": [t for _r, t in big],
            "small": small, "truth_all": truth}


def five_problems(nuc, W: int, Dp: int, expansion: int, B: int, device):
    """(plan, WindowProblem) of B fiveState problems on (Dp - 96) / 2-base
    segments of the genome pair (guide anchors every 10th true pair, ragged
    ends mixed), through the symbol lane's staging and device-built E."""
    import numpy as np

    from cpecan_signal_tpu_torch.core.window import smooth_band
    from cpecan_signal_tpu_torch.em.discrete import collect_symbol_split_jobs
    from cpecan_signal_tpu_torch.engine import readpath
    from cpecan_signal_tpu_torch.models.params import AlignmentParams
    from cpecan_signal_tpu_torch.models.state_machines import (bind_symbol_sequences,
                                                                make_symbol_sm5)

    def make_sm(sx, sy):
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, sx, sy)
        return sm

    truth, params = nuc["truth_all"], AlignmentParams(diagonal_expansion=expansion)
    n = (Dp - 96) // 2
    staged, x1 = [], 0
    while len(staged) < B:
        sel = truth[(truth[:, 0] >= x1) & (truth[:, 0] < x1 + n)]
        c, d = int(sel[0, 1]), int(sel[-1, 1]) + 1
        i = len(staged)
        jobs = collect_symbol_split_jobs(make_sm, nuc["x"][x1:x1 + n], nuc["y"][c:d],
                                         (sel - [x1, c])[::10], params,
                                         ragged_left=bool(i % 2), ragged_right=i % 4 < 2)
        x1 += n
        wb = smooth_band(jobs[0].band, width_multiple=W)
        if len(jobs) == 1 and wb.W == W and wb.n_diagonals + 2 <= Dp:
            staged.append((i, *readpath.stage_symbol_job(jobs[0], wb)))
    tables, bucket, _n = readpath.stage_symbol_bucket(staged, list(range(B)), Dp, device)
    return staged[0][2], readpath.symbol_problem(W, tables, bucket)


def phase_five_kernels(nuc, device, stats) -> None:
    """The forward, stage-3 backward and stage-4 backward with one posterior
    channel per to-state (pgroups) kernels at the fiveState plan (5 states,
    13 edges, 3 channels gathered on the device), B = 64 at FIVE_SHAPES and
    at FIVE_WIDE, against their plain versions on the same CUDA tensors (the
    forward and stage 3 where FIVE_SHAPES marks it); the last of
    FIVE_SHAPES gives the kernels line's backward_pgroups entry its times
    and bound."""
    import torch

    from cpecan_signal_tpu_torch.em.discrete import _to_state_pgroups
    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    for W, Dp, expansion, full, B in ([(*shape, GENERIC_B) for shape in FIVE_SHAPES]
                                      + [(*FIVE_WIDE[:3], True, FIVE_WIDE[3])]):
        plan, b = five_problems(nuc, W, Dp, expansion, B, device)
        edges = pp.to_device(edge_table(plan), device)
        groups, pgroups = pp.sm3_wgroups(plan), _to_state_pgroups(plan)
        m = plan.match_state
        fargs = (edges, b.E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)

        def run_f():
            return fk.forward_sm3(*fargs)

        F, offF = run_f()
        bargs = (edges, m, b.E, F, offF, b.diag_scalars, b.d_last, b.end, b.tp_scalar)

        def run_b():
            return fk.backward_sm3(*bargs)

        def run_pg():
            return fk.backward_sm3(*bargs, stages=4, wgroups=groups, pgroups=pgroups)

        P, T = run_b()
        got = run_pg()
        torch.cuda.synchronize()
        ms = {"forward": cuda_ms(run_f, 3), "backward": cuda_ms(run_b, 3),
              "backward_pgroups": cuda_ms(run_pg, 3)}
        plain, errs, ok = {}, {}, {}
        if full:
            (F_ref, offF_ref), plain["forward"] = timed_once(
                lambda: fk.forward_sm3_ref(*fargs))
            (P_ref, T_ref), plain["backward"] = timed_once(lambda: fk.backward_sm3_ref(*bargs))
            errs = {"F": max_err(F, F_ref), "p": max_err(P, P_ref),
                    "totals": max_err(T, T_ref)}
            ok = {"F": forward_ok(F, offF, F_ref, offF_ref),
                  "p": errs["p"] <= P_ATOL,
                  "totals": bool(torch.allclose(T, T_ref, atol=F_ATOL, rtol=F_RTOL))}
            del F_ref, offF_ref, P_ref, T_ref
        ref, plain["backward_pgroups"] = timed_once(lambda: fk.backward_sm3_ref(
            *bargs, 4, groups, None, pgroups))
        e4 = dict(zip(("p", "totals", "exits", "gacc", "stats"),
                      (max_err(a, r) for a, r in zip(got, ref))))
        ok.update({
              "pgroups totals": bool(torch.allclose(got[1], ref[1], atol=F_ATOL,
                                                    rtol=F_RTOL)),
              "pgroups p": e4["p"] <= P_ATOL,
              "exits/gacc": max(e4["exits"], e4["gacc"]) <= WIN_ATOL,
              "stats": bool(torch.allclose(got[4], ref[4], atol=STATS_ATOL,
                                           rtol=STATS_RTOL))})
        dl = b.d_last
        cells = int((dl.long() + 1).sum()) * W
        fwd_in, bwd_in = recursion_inputs(b.E, F, b.diag_scalars, dl,
                                          nbytes(dl, edges, b.tp_scalar))
        S = plan.n_states
        bounds = {"forward": bound(ops_per_cell("forward", edges),
                                   fwd_in + nbytes(b.start, F, offF),
                                   cells),
                  "backward": bound(ops_per_cell("backward", edges, S),
                                    bwd_in + nbytes(b.end, offF, P, T), cells),
                  "backward_pgroups": bound(ops_per_cell("backward_pgroups", edges, S,
                                                         wgroups=groups, pgroups=pgroups),
                                            bwd_in + nbytes(b.end, offF, *got), cells)}
        print(f"kernels fiveState plan ({S} states, {len(plan.edges)} edges, "
              f"{b.E.shape[2]} channels, {len(pgroups)} posterior channels) W={W} Dp={Dp} "
              f"B={B}: errors {errs}, pgroups stage 4 "
              + ", ".join(f"{k} {v:.3g}" for k, v in e4.items()) + f"; ok {ok}; "
              "ms kernel/plain/bound: "
              + ", ".join(f"{k} {ms[k]:.3f}/"
                          + (f"{plain[k]:.3f}" if k in plain else "not timed")
                          + f"/{bounds[k][0]:.4f} ({bounds[k][1]})" for k in ms), flush=True)
        if not all(ok.values()):
            raise AssertionError(f"fiveState kernels disagree with their plain versions at "
                                 f"W={W}: {ok}")
        if full:
            stats["forward"]["max_abs_err"] = max(stats["forward"]["max_abs_err"], errs["F"])
            stats["backward"]["max_abs_err"] = max(stats["backward"]["max_abs_err"],
                                                   errs["p"], errs["totals"])
        st = stats["backward_pgroups"]
        st["max_abs_err"] = max(st["max_abs_err"], *e4.values())
        if (W, Dp) == FIVE_SHAPES[-1][:2]:
            st.update(ms=ms["backward_pgroups"], plain_ms=plain["backward_pgroups"],
                      bound_ms=bounds["backward_pgroups"][0],
                      bound_by=bounds["backward_pgroups"][1])
        del F, offF, P, T, got, ref, b
        torch.cuda.empty_cache()


def cigar_pairs(ops) -> set:
    """The aligned (x, y) pairs of a CIGAR's match blocks, in the record's
    own coordinates."""
    out, i, j = set(), 0, 0
    for op, n in ops:
        if op == "M":
            out.update(zip(range(i, i + n), range(j, j + n)))
            i += n
            j += n
        elif op == "D":
            i += n
        else:
            j += n
    return out


def phase_realign(nuc, fk) -> dict:
    """cli/realign on the card over the NUC_RECORDS guide records (stdin),
    the launch counts of this run alone; the realigned pairs scored against
    the true alignment."""
    from cpecan_signal_tpu_torch.cli import realign
    from cpecan_signal_tpu_torch.io.cigar import parse_cigar_line

    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO(nuc["text"])
    reset_launches(fk)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = realign.main([nuc["fasta"]])
    finally:
        sys.stdin = stdin
    t_cli = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    recs = [parse_cigar_line(line) for line in out.getvalue().splitlines()]
    stages = re.search(r"seconds by stage: (.*)", err.getvalue())
    tail = re.search(r"\btail ([\d.]+)", err.getvalue())
    n_got = n_true = n_hit = 0
    for rec, truth in zip(recs, nuc["truth"]):
        got = cigar_pairs(rec.ops)
        n_got += len(got)
        n_true += len(truth)
        n_hit += len(got & set(map(tuple, truth.tolist())))
    precision, recall = n_hit / max(n_got, 1), n_hit / max(n_true, 1)
    print(f"realign: rc={rc} {len(recs)}/{NUC_RECORDS} records realigned "
          f"({sum(r.strand2 is False for r in recs)} on the reverse strand), {n_got} aligned "
          f"pairs, {t_cli:.2f} s, host tail {float(tail.group(1)) if tail else None} s; "
          f"against the true alignment: precision {precision:.4f}, recall {recall:.4f} "
          f"(>= {QUALITY_MIN}); launches {launches}; seconds by stage: "
          f"{stages.group(1) if stages else None}", flush=True)
    if rc != 0 or len(recs) != NUC_RECORDS or stages is None:
        raise AssertionError(f"realign path failed: rc or records\n{err.getvalue()}")
    if min(precision, recall) < QUALITY_MIN:
        raise AssertionError(f"realigned pairs too far from the truth: {precision}, {recall}")
    if launches["forward"] < 1 or launches["backward"] < 1:
        raise AssertionError("realign path never launched the forward or backward kernel")
    return launches


def phase_realign_agreement(nuc, device) -> None:
    """The small records' split jobs through batch_align_jobs on the card
    and on the CPU plain path: pairs per job, and the CIGARs realigned from
    each."""
    import torch

    from cpecan_signal_tpu_torch.cli import realign
    from cpecan_signal_tpu_torch.engine.batch_align import assemble_pairs, batch_align_jobs
    from cpecan_signal_tpu_torch.models.params import AlignmentParams

    params = AlignmentParams()
    heads, spans, jobs = realign.record_jobs(nuc["small"], nuc["seqs"], params, None)
    t0 = time.perf_counter()
    got = batch_align_jobs(jobs, params.threshold, device=device)
    t1 = time.perf_counter()
    want = batch_align_jobs(jobs, params.threshold, device=torch.device("cpu"))
    t2 = time.perf_counter()
    worst = [pairs_agree(g, w) for g, w in zip(got, want)]
    miss = max(m for m, _ in worst)
    drift = max(d for _, d in worst)
    lines = [[realign.finish_record(rec, assemble_pairs(frags[span]), sx, sy, aall,
                                    params)[0].to_line()
              for rec, (sx, sy, aall), span in zip(nuc["small"], heads, spans)]
             for frags in (got, want)]
    print(f"realign agreement: {len(jobs)} jobs of {len(nuc['small'])} records of "
          f"{[n for _x, n, _k in NUC_SMALL]} bases, cuda vs cpu ({t1 - t0:.2f} s / "
          f"{t2 - t1:.2f} s): max pairs differing {miss} (tol {PAIR_TOL}), max posterior "
          f"drift {drift:.3g} (tol {PROB_TOL}), CIGARs equal {lines[0] == lines[1]}",
          flush=True)
    if miss > PAIR_TOL or drift > PROB_TOL or lines[0] != lines[1]:
        raise AssertionError("realign: cuda and cpu paths disagree")


def phase_nuc_em(tmp, nuc, fk) -> dict:
    """cli/em on the card over the 1 Mb chunk: EM_ITERATIONS iterations, one
    trial from Jukes-Cantor emissions (NUC_JC_START), the launch counts of
    this run alone; the likelihood required not to fall, and the trained
    match emissions to favour identity (trace above 0.5) more than the
    start did."""
    import numpy as np

    from cpecan_signal_tpu_torch.cli import em
    from cpecan_signal_tpu_torch.em.accumulators import DiscreteHmm

    model = os.path.join(tmp, "nucleotide.hmm")
    matrix = os.path.join(tmp, "lastz.matrix")
    buf = io.StringIO()
    reset_launches(fk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = em.main(["--alignments", nuc["cigars"], "--fastas", nuc["fasta"],
                      "--outputModel", model, "--iterations", str(EM_ITERATIONS),
                      "--trials", "1", "--setJukesCantorStartingEmissions", str(NUC_JC_START),
                      "--blastScoringMatrixFile", matrix])
    t_em = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    log = buf.getvalue()
    chunks = re.search(r"(\d+) alignments in (\d+) chunks", log)
    iters = re.findall(r"E-step ([\d.]+) s, (\d+) buckets, launches (\{[^}]*\}), "
                       r"likelihood (-?[\d.]+)", log)
    liks = [float(lik) for *_r, lik in iters]
    hmm = DiscreteHmm.load(model)
    trace = float(np.trace(hmm.emissions[0]))
    start = DiscreteHmm.empty(5, 4)
    em.set_jukes_cantor(start, NUC_JC_START)
    trace0 = float(np.trace(start.emissions[0]))
    print(f"em nucleotide: rc={rc} {chunks.group(0) if chunks else None}, {EM_ITERATIONS} "
          f"iterations in {t_em:.2f} s; per iteration E-step s {[float(s) for s, *_r in iters]}, "
          f"buckets {[int(b) for _s, b, *_r in iters]}, launches {[l for _s, _b, l, _k in iters]}; "
          f"likelihood {liks}; match emission trace {trace:.4f} (start {trace0:.4f})",
          flush=True)
    if rc != 0 or len(iters) != EM_ITERATIONS or not os.path.exists(matrix):
        raise AssertionError(f"nucleotide EM path failed: rc or iterations\n{log}")
    for a, b in zip(liks, liks[1:]):
        if b < a - LIK_DROP * abs(a):
            raise AssertionError(f"nucleotide EM likelihood fell: {liks}")
    if trace <= max(0.5, trace0):
        raise AssertionError(f"trained match emissions do not favour identity: {trace}")
    if launches["forward"] < 1 or launches["backward_pgroups"] < 1:
        raise AssertionError("nucleotide EM never launched the forward or pgroups kernel")
    return launches


def phase_nuc_em_agreement(tmp, nuc, device) -> None:
    """One E-step of the trained model over the small records on the card
    and on the CPU plain path; and two card runs of one E-step over the 1 Mb
    chunk, which must agree bit for bit."""
    import numpy as np
    import torch

    from cpecan_signal_tpu_torch.cli import em
    from cpecan_signal_tpu_torch.em.accumulators import DiscreteHmm
    from cpecan_signal_tpu_torch.models.params import AlignmentParams

    params = AlignmentParams()
    hmm = DiscreteHmm.load(os.path.join(tmp, "nucleotide.hmm"))
    t0 = time.perf_counter()
    c, p = (em._estep_all_chunks([nuc["small"]], nuc["seqs"], params, hmm, dev)
            for dev in (device, torch.device("cpu")))
    t1 = time.perf_counter()
    errs = {"trans": float(np.abs(c.transitions - p.transitions).max()),
            "emiss": float(np.abs(c.emissions - p.emissions).max()),
            "likelihood": abs(c.likelihood - p.likelihood) / abs(p.likelihood)}
    ok = (np.allclose(c.transitions, p.transitions, rtol=STEP_RTOL, atol=STEP_ATOL)
          and np.allclose(c.emissions, p.emissions, rtol=STEP_RTOL, atol=STEP_ATOL)
          and errs["likelihood"] <= LIK_RTOL)
    runs = []
    for _ in range(2):
        t = time.perf_counter()
        runs.append((em._estep_all_chunks([nuc["records"]], nuc["seqs"], params, hmm, device),
                     time.perf_counter() - t))
    (a, ta), (b, tb) = runs
    same = (np.array_equal(a.transitions, b.transitions)
            and np.array_equal(a.emissions, b.emissions) and a.likelihood == b.likelihood)
    print(f"em nucleotide agreement: one E-step over the small records, cuda vs cpu "
          f"({t1 - t0:.2f} s): max abs err trans {errs['trans']:.3g}, emiss "
          f"{errs['emiss']:.3g} (rtol {STEP_RTOL} atol {STEP_ATOL}), likelihood relative "
          f"{errs['likelihood']:.3g} (tol {LIK_RTOL}); two card E-steps over the 1 Mb chunk "
          f"({ta:.2f} s, {tb:.2f} s) bit-identical {same}", flush=True)
    if not ok or not same:
        raise AssertionError("nucleotide E-step: cuda and cpu disagree, or two card runs differ")


def hdp_table(pore, device):
    """(table (NUM_OF_KMERS + 2, 1200) f32 on ``device``, g0, dg): a density
    table on HDP_GRID whose row of a k-mer is a normal density (sd 1.5 pA)
    at the pore model's level, for the threeStateHdp kernel checks."""
    import numpy as np

    from cpecan_signal_tpu_torch.engine import pipeline as pp

    grid = np.linspace(*HDP_GRID[:2], HDP_GRID[2])
    level = np.concatenate([pore.match_model[:-2, 0], [60.0, 60.0]])
    tab = np.exp(-0.5 * ((grid[None, :] - level[:, None]) / 1.5) ** 2) / (1.5 * 2.5066283)
    return pp.to_device(tab.astype(np.float32), device), grid[0], grid[1] - grid[0]


def stage4_problems(pore, machine: str, W: int, Dp: int, B: int, rng, device):
    """(plan, WindowProblem, wgroups, pgroups) of B problems (4 distinct
    synthetic reads, anchored every 20 events with expansion 20, repeated)
    of the vanilla E-step (its 5 transition channels gathered through the
    skip-bin grid from the model's bins) or the threeStateHdp E-step (E
    built by readpath.hdp_emissions from ``hdp_table``), W lanes, padded to
    Dp diagonals, on ``device``."""
    import numpy as np
    import torch

    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.core.band import band_construct
    from cpecan_signal_tpu_torch.core.window import smooth_band
    from cpecan_signal_tpu_torch.em import hdp_em, vanilla_em
    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine import readpath
    from cpecan_signal_tpu_torch.engine.plan import plan_key_names
    from cpecan_signal_tpu_torch.models import state_machines as sms
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    cases = []
    while len(cases) < 4:
        target = "".join(rng.choice(list("ACGT"), int(0.40 * Dp)))
        events, path = syn.simulate_events(pore, target, rng)
        n_kmers = len(target) - 5
        band = band_construct(syn.path_anchors(path, n_kmers, len(events), 20), n_kmers,
                              len(events), 20)
        wb = smooth_band(band, width_multiple=W)
        if wb.W == W and wb.n_diagonals <= Dp:
            cases.append((target, events, wb, bool(len(cases) % 2), len(cases) < 2))
    idx = torch.arange(B) % len(cases)
    cpu = torch.device("cpu")
    if machine == "vanilla":
        probs, keys, sm = [], [], None
        for target, events, wb, rl, rr in cases:
            sm = sms.make_signal_vanilla(pore, target, events, "template")
            plan, prob = pp.make_window_problem(sm, wb, device=cpu, ragged_left=rl,
                                                ragged_right=rr, pad_d=Dp)
            probs.append(prob)
            keys.append(vanilla_em._bin_keys(sm, wb, prob.x0.numpy(), Dp))
        batch = vanilla_em.VanillaBatch(*pp.stack_window_problems(probs),
                                        *(torch.from_numpy(np.stack(c)) for c in zip(*keys)))
        batch = vanilla_em.VanillaBatch(*(f[idx].to(device) for f in batch))
        tabs, _scalars = sms.vanilla_transition_tables(pore.skip_bins, "template")
        T = pp.to_device(np.stack([np.maximum(tabs[k], pp.NEG_INF)
                                   for k in plan_key_names(sm)[1]]).astype(np.float32), device)
        cells = batch.bin_grid.long()
        for c in range(T.shape[0]):
            batch.E[:, :, plan.n_eclasses + c, :] = T[c][cells]
        return plan, pp.WindowProblem(*batch[:7]), vanilla_em.vanilla_wgroups(plan), None
    zero = hdp_em._zero_density
    items = [(sms.make_signal_sm3_hdp(zero, t, e), wb, rl, rr) for t, e, wb, rl, rr in cases]
    plan, fields = pp.stack_window_scalars(items, Dp, cpu)
    rank, mean = (torch.from_numpy(np.stack(a)) for a in zip(
        *(pp.hdp_inputs(sm, Dp + 2) for sm, *_r in items)))
    ds, dl, start, end, tp, x0 = (f[idx].to(device) for f in fields)
    tab, g0, dg = hdp_table(pore, device)
    E = readpath.hdp_emissions(tab, g0, dg, rank[idx].to(device), mean[idx].to(device),
                               ds[:, :Dp, 0, fk.DS_W0], dl, W)
    return (plan, pp.WindowProblem(E, ds, dl, start, end, tp, x0), pp.sm3_wgroups(plan),
            hdp_em.hdp_pgroups(plan))


def phase_stage4_configs(pore, device, rng, stats) -> None:
    """The two stage-4 configurations that the vanilla and threeStateHdp
    E-steps add: the vanilla plan (7 edges, 3 emission classes, 5 transition
    channels) with window groups (beta, alpha), and the threeStateHdp plan
    (8 edges) with one posterior channel per middle edge into match
    (pgroups), with the forward, at B = 64 and STAGE4_SHAPES: timed, and
    where marked held against the plain versions; errors join ``stats``."""
    import torch

    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    for machine, (want_w, want_p) in STAGE4_GROUPS.items():
        kernel = "backward_em" if want_p is None else "backward_pgroups"
        for W, Dp, check in STAGE4_SHAPES:
            plan, b, wgroups, pgroups = stage4_problems(pore, machine, W, Dp, GENERIC_B, rng,
                                                        device)
            if (wgroups, pgroups) != (want_w, want_p):
                raise AssertionError(f"{machine}: groups {wgroups}, {pgroups}")
            edges = pp.to_device(edge_table(plan), device)
            fargs = (edges, b.E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)

            def run_f():
                return fk.forward_sm3(*fargs)

            F, offF = run_f()
            bargs = (edges, plan.match_state, b.E, F, offF, b.diag_scalars, b.d_last, b.end,
                     b.tp_scalar)

            def run_b4():
                return fk.backward_sm3(*bargs, stages=4, wgroups=wgroups, pgroups=pgroups)

            got = run_b4()
            torch.cuda.synchronize()
            ms = {"forward": cuda_ms(run_f, 3), kernel: cuda_ms(run_b4, 3)}
            plain, line = {}, ""
            if check:
                (F_ref, offF_ref), plain["forward"] = timed_once(
                    lambda: fk.forward_sm3_ref(*fargs))
                ref, plain[kernel] = timed_once(lambda: fk.backward_sm3_ref(
                    *bargs, 4, wgroups, None, pgroups))
                e4 = dict(zip(("p", "totals", "exits", "gacc", "stats"),
                              (max_err(a, r) for a, r in zip(got, ref))))
                ok = {"F": forward_ok(F, offF, F_ref, offF_ref),
                      "p": e4["p"] <= P_ATOL,
                      "totals": bool(torch.allclose(got[1], ref[1], atol=F_ATOL,
                                                    rtol=F_RTOL)),
                      "exits/gacc": max(e4["exits"], e4["gacc"]) <= WIN_ATOL,
                      "stats": bool(torch.allclose(got[4], ref[4], atol=STATS_ATOL,
                                                   rtol=STATS_RTOL))}
                line = (f": errors F {max_err(F, F_ref):.3g}, "
                        + ", ".join(f"{k} {v:.3g}" for k, v in e4.items()) + f"; ok {ok}")
                if not all(ok.values()) or float(got[0].sum()) <= 0:
                    raise AssertionError(f"stage 4 {machine}{line}")
                stats["forward"]["max_abs_err"] = max(stats["forward"]["max_abs_err"],
                                                      max_err(F, F_ref))
                stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"],
                                                   *e4.values())
                del F_ref, ref
            dl = b.d_last
            cells = int((dl.long() + 1).sum()) * W
            fwd_in, bwd_in = recursion_inputs(b.E, F, b.diag_scalars, dl,
                                              nbytes(dl, edges, b.tp_scalar))
            S = plan.n_states
            bounds = {"forward": bound(ops_per_cell("forward", edges),
                                       fwd_in + nbytes(b.start, F, offF), cells),
                      kernel: bound(ops_per_cell(kernel, edges, S, wgroups=wgroups,
                                                 pgroups=pgroups or ()),
                                    bwd_in + nbytes(b.end, offF, *got), cells)}
            print(f"stage 4 {machine} plan ({S} states, {len(plan.edges)} edges, "
                  f"{b.E.shape[2]} channels, wgroups {wgroups}, pgroups {pgroups}) W={W} "
                  f"Dp={Dp} B={GENERIC_B}{line}; ms kernel/plain/bound: "
                  + ", ".join(f"{k} {ms[k]:.3f}/"
                              + (f"{plain[k]:.3f}" if k in plain else "not timed")
                              + f"/{bounds[k][0]:.4f} ({bounds[k][1]})" for k in ms),
                  flush=True)
            del F, offF, got, b
            torch.cuda.empty_cache()


def align_small(tmp, small, ref_seq, model, params, device):
    """threeState alignment of the ``small`` reads' split jobs on the card
    and by the CPU plain path, each written as a posterior TSV.  Returns
    (jobs, card pairs, CPU pairs, {"cuda": TSV path, "cpu": TSV path})."""
    import torch

    from cpecan_signal_tpu_torch.cli.vanilla_align import (finish_read, guide_alignment,
                                                           prepare_read, strand_jobs)
    from cpecan_signal_tpu_torch.engine.batch_align import assemble_pairs, batch_align_jobs
    from cpecan_signal_tpu_torch.io.npread import load_npread
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model

    pore = load_pore_model(model)
    preps, jobs, owners = [], [], []
    for path in small:
        npr = load_npread(path)
        prep = prepare_read(ref_seq, npr, params, sm_type="threeState",
                            guide=guide_alignment(ref_seq, npr.twoD_read,
                                                  params.constraint_diagonal_trim),
                            substitute=None, template_model=pore, complement_model=pore)
        for ctx in prep["strand_ctx"]:
            for j in strand_jobs(ctx, params):
                jobs.append(j)
                owners.append((len(preps), ctx["strand"]))
        preps.append((os.path.basename(path), prep))
    tsv, results = {}, []
    for name, dev in (("cuda", device), ("cpu", torch.device("cpu"))):
        pairs = batch_align_jobs(jobs, params.threshold, device=dev)
        tsv[name] = os.path.join(tmp, f"small_{name}.tsv")
        with open(tsv[name], "w") as fh:
            for k, (label, prep) in enumerate(preps):
                finish_read(prep, {s: assemble_pairs([f for f, o in zip(pairs, owners)
                                                      if o == (k, s)]) for s in "tc"},
                            fh, label, "ref")
        results.append(pairs)
    return jobs, results[0], results[1], tsv


def tsv_keys(path) -> dict:
    """(read, strand) -> the (reference position, event) keys of a
    posterior TSV's rows, and the (k-mer, descaled mean) they assign."""
    out = {}
    with open(path) as fh:
        for line in fh:
            r = line.rstrip("\n").split("\t")
            out.setdefault((r[3], r[4]), {})[(r[1], r[5])] = (r[9], r[13])
    return out


def phase_build_hdp(tmp, tsv, model, small_tsv, card: str) -> tuple[str, str]:
    """cli/build_hdp from the threeState posterior TSV of the read set:
    HdpType 0 on HDP_GRID, the chain cut to HDP_BUILD_GIBBS, both strands
    in parallel; timed.  Its check: the assignments it reads, the threeState
    alignment TSV of the 5 smallest reads (``small_tsv``, written by
    ``align_small``), come out of the card as out of the CPU plain path (per
    read and strand at most PAIR_TOL rows differing, and the same k-mer and
    event mean on the shared rows), and the built HDPs hold finite
    densities (the median of each strand's most frequent k-mer's points and
    of its density are printed beside).  Returns the template and
    complement .nhdp paths."""
    import numpy as np

    from cpecan_signal_tpu_torch.cli import build_hdp
    from cpecan_signal_tpu_torch.hdp.nanopore import deserialize_nhdp

    out = [os.path.join(tmp, f"{s}.nhdp") for s in ("template", "complement")]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = build_hdp.main(["-a", tsv, "-p", "0", "-T", model, "-C", model, "-v", out[0],
                             "-w", out[1], *HDP_BUILD_GIBBS])
    t_build = time.perf_counter() - t0
    counts = re.findall(r"build_hdp - (\w): (\d+) assignments", buf.getvalue())
    points = {"t": {}, "c": {}}
    with open(tsv) as fh:
        for line in fh:
            r = line.split("\t")
            points[r[4]].setdefault(r[9], []).append(float(r[13]))
    centred = []
    for strand, path in zip("tc", out):
        nhdp = deserialize_nhdp(path)
        kmer, pts = max(points[strand].items(), key=lambda kv: len(kv[1]))
        cdf = np.cumsum(nhdp.kmer_density(kmer, nhdp.hdp.grid))
        table = nhdp.density_table()
        centred.append((kmer, len(pts), float(np.median(pts)),
                        float(nhdp.hdp.grid[np.searchsorted(cdf / cdf[-1], 0.5)]),
                        bool(np.isfinite(table).all() and (table >= 0).all())))
    ok = rc == 0 and len(counts) == 2 and all(fin for *_r, fin in centred)
    keys = {name: tsv_keys(path) for name, path in small_tsv.items()}
    miss = max(len(set(keys["cuda"].get(k, {})) ^ set(keys["cpu"].get(k, {})))
               for k in set(keys["cuda"]) | set(keys["cpu"]))
    same = all(keys["cuda"][k][c] == keys["cpu"][k][c] for k in keys["cuda"]
               for c in set(keys["cuda"][k]) & set(keys["cpu"].get(k, {})))
    print(f"build_hdp: rc={rc} HdpType 0 grid {HDP_GRID}, Gibbs {HDP_BUILD_GIBBS}, "
          f"assignments {dict(counts)} in {t_build:.2f} s; most frequent k-mer (points, "
          f"their median, its density's median, table finite): {centred}; its input on "
          f"the 5 smallest reads, cuda vs cpu: {len(keys['cuda'])} read strands, rows "
          f"differing at most {miss} a read and strand (tol {PAIR_TOL}), shared rows' "
          f"k-mer and mean equal {same}; card {card}", flush=True)
    if not ok or miss > PAIR_TOL or not same or len(keys["cuda"]) != 10:
        raise AssertionError(f"build_hdp failed: {buf.getvalue()[-2000:]}")
    return out[0], out[1]


def phase_hdp_align(tmp, ref, ref_seq, model, paths, small, nhdp_paths, fk, device,
                    card: str) -> dict:
    """threeStateHdp alignment on the card: cli/vanilla_align --threeStateHdp
    -v -w on one read (the launch counts of this path alone), then
    batch_align_stream over the read set, median of 3 (reads/s, events/s,
    seconds by stage), then the jobs of the 5 smallest reads against the
    CPU plain path."""
    import torch

    from cpecan_signal_tpu_torch.cli import vanilla_align
    from cpecan_signal_tpu_torch.engine.batch_align import (batch_align_jobs,
                                                            batch_align_stream)
    from cpecan_signal_tpu_torch.hdp.nanopore import deserialize_nhdp
    from cpecan_signal_tpu_torch.models.params import cli_defaults

    out = os.path.join(tmp, "hdp_one.tsv")
    buf = io.StringIO()
    reset_launches(fk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = vanilla_align.main(["-r", ref, "-q", paths[0], "-T", model, "-C", model,
                                 "-u", out, "--threeStateHdp", "-v", nhdp_paths[0], "-w",
                                 nhdp_paths[1]])
    t_cli = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    with open(out) as fh:
        n_rows = sum(1 for _ in fh)
    print(f"cli threeStateHdp: rc={rc} vanilla_align on {os.path.basename(paths[0])}: "
          f"{n_rows} TSV rows ({buf.getvalue().strip()}), launches {launches}, {t_cli:.2f} s",
          flush=True)
    if rc != 0 or n_rows < 100 or launches["forward"] < 1 or launches["backward"] < 1:
        raise AssertionError("threeStateHdp alignment path failed")

    params = cli_defaults()
    density = {s: deserialize_nhdp(p).density_logp_fn() for s, p in zip("tc", nhdp_paths)}
    per_read = read_jobs(paths, ref_seq, model, params, "threeStateHdp", density)
    n_ev = sum(len(j.sm.event_means) for jl in per_read for j in jl)
    batch_align_stream(iter(per_read), params.threshold, device=device)
    runs = []
    for _ in range(3):
        timing = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _jobs, pairs = batch_align_stream(iter(per_read), params.threshold,
                                          device=device, timing=timing)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, timing, sum(len(p.probs) for p in pairs)))
    t_med, timing, n_pairs = sorted(runs, key=lambda r: r[0])[1]
    print(f"timing threeStateHdp: {len(paths)} reads ({n_ev} events, "
          f"{sum(len(jl) for jl in per_read)} split jobs, {n_pairs} pairs) batch_align_stream "
          f"median of 3 {t_med:.4f} s (runs {', '.join(f'{t:.4f}' for t, *_r in runs)}): "
          f"{len(paths) / t_med:.2f} reads/s, {n_ev / t_med:.0f} events/s; median run by "
          "stage " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(timing.items()))
          + f"; card {card}", flush=True)
    if n_pairs < n_ev // 2:
        raise AssertionError(f"threeStateHdp: {n_pairs} pairs for {n_ev} events")

    jobs = [j for jl in read_jobs(small, ref_seq, model, params, "threeStateHdp", density)
            for j in jl]
    t0 = time.perf_counter()
    got = batch_align_jobs(jobs, params.threshold, device=device)
    t1 = time.perf_counter()
    want = batch_align_jobs(jobs, params.threshold, device=torch.device("cpu"))
    t2 = time.perf_counter()
    worst = [pairs_agree(g, w) for g, w in zip(got, want)]
    miss, drift = max(m for m, _ in worst), max(d for _, d in worst)
    print(f"agreement threeStateHdp: {len(jobs)} jobs of {len(small)} reads, cuda vs cpu "
          f"({t1 - t0:.2f} s / {t2 - t1:.2f} s): max pairs differing {miss} (tol "
          f"{PAIR_TOL}), max posterior drift {drift:.3g} (tol {PROB_TOL})", flush=True)
    if miss > PAIR_TOL or drift > PROB_TOL:
        raise AssertionError("threeStateHdp: cuda and cpu paths disagree")
    return launches


def phase_train_machine(tmp, reads, ref, model, fk, machine: str, extra) -> dict:
    """cli/train_models of ``machine`` (vanilla or threeStateHdp) on the read
    set on the card, EM_ITERATIONS iterations: the launch counts of this
    path alone, the E-step (and HDP rebuild) seconds, the likelihoods, which
    are printed and must be finite but are not held to rise: vanilla's
    M-step normalizes its 60 skip bins jointly, as the reference does
    (VanillaHmm.normalize, continuousHmm.c:424-433), so it maximizes
    nothing; threeStateHdp's emissions are each iteration a new Gibbs
    chain's densities, added raw into the log-space recursion (the
    reference's quirk, models/state_machines.make_signal_sm3_hdp).  Each is
    checked against the CPU plain path instead (phase_em_machine_agreement)."""
    import numpy as np

    from cpecan_signal_tpu_torch.cli import train_models
    from cpecan_signal_tpu_torch.em.accumulators import load_signal_hmm

    out_dir = os.path.join(tmp, f"train_{machine}")
    os.makedirs(out_dir)
    buf = io.StringIO()
    reset_launches(fk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_models.main(["-r", ref, "-d", reads, "-T", model, "-C", model, "-i",
                                str(EM_ITERATIONS), "-o", out_dir, f"--{machine}", *extra])
    t_train = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    log = buf.getvalue()
    strands = re.findall(r"strand (\w): (\d+) split jobs \((\d+) events\) in (\d+) "
                         r"device buckets", log)
    iters = re.findall(r"iteration \d+: E-step ([\d.]+) s(?:, HDP rebuild ([\d.]+) s)?, "
                       r"likelihood (-?[\d.]+)", log)
    n_ev = sum(int(ev) for _s, _j, ev, _b in strands)
    estep = [float(e) for e, _g, _l in iters]
    liks = [float(lik) for _e, _g, lik in iters]
    rebuild = [float(g) for _e, g, _l in iters if g]
    assigned = re.findall(r"strand (\w): (\d+) assignments", log)
    print(f"train {machine}: rc={rc} {EM_ITERATIONS} iterations in {t_train:.2f} s; "
          + "; ".join(f"strand {s}: {j} split jobs, {ev} events, {nb} buckets"
                      for s, j, ev, nb in strands)
          + f"; likelihood {liks}; E-step s {estep}, events/s "
          f"{[round(n_ev / s) for s in estep]}"
          + (f"; HDP rebuild s {rebuild}, assignments {[int(a) for _s, a in assigned]}"
             if rebuild else "") + f"; launches {launches}", flush=True)
    if rc != 0 or len(iters) != EM_ITERATIONS or len(strands) != 2:
        raise AssertionError(f"train {machine} failed\n{log[-3000:]}")
    if not np.isfinite(liks).all():
        raise AssertionError(f"train {machine}: likelihood {liks}")
    kernel = "backward_pgroups" if machine == "threeStateHdp" else "backward_em"
    if launches["forward"] < 1 or launches[kernel] < 1:
        raise AssertionError(f"train {machine} never launched the forward or {kernel} kernel")
    for name in ("template", "complement"):
        hmm = load_signal_hmm(os.path.join(out_dir, f"{name}_trained.hmm"))
        total = hmm.bins.sum() if machine == "vanilla" else hmm.transitions.sum(1)
        if np.abs(total - 1.0).max() > 1e-4:
            raise AssertionError(f"{machine} {name}_trained.hmm is not a trained model")
        if machine == "threeStateHdp" and not os.path.exists(
                os.path.join(out_dir, f"{name}_trained.nhdp")):
            raise AssertionError(f"threeStateHdp wrote no {name}_trained.nhdp")
    return launches


def phase_em_machine_agreement(small, ref_seq, model, device, machine: str,
                               nhdp_paths=None) -> None:
    """One E-step of ``machine`` over the jobs of the ``small`` reads, both
    strands: the card's kernels against the CPU plain path (tallies rtol
    1e-4 + atol 1e-5, likelihood 1e-5 relative; threeStateHdp: at least
    HDP_ASSIGN_SHARE of the assignments shared), and two card runs equal bit
    for bit."""
    from collections import Counter

    import numpy as np
    import torch

    from cpecan_signal_tpu_torch.cli.train_models import _prepare_read
    from cpecan_signal_tpu_torch.em import hdp_em, sm3_em, vanilla_em
    from cpecan_signal_tpu_torch.hdp.nanopore import deserialize_nhdp
    from cpecan_signal_tpu_torch.io.npread import load_npread
    from cpecan_signal_tpu_torch.models.params import cli_defaults
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model

    params = cli_defaults()
    pore = load_pore_model(model)
    hdp = machine == "threeStateHdp"
    preps = [_prepare_read(ref_seq, load_npread(p), params, descale=hdp) for p in small]
    worst = {"tallies": 0.0, "likelihood": 0.0, "assignments": 1.0}
    n_jobs, same, t_card, t_cpu = 0, True, 0.0, 0.0
    for strand in ("t", "c"):
        if hdp:
            jobs = hdp_em.collect_hdp_em_jobs(preps, params, strand)
            nhdp = deserialize_nhdp(nhdp_paths[0 if strand == "t" else 1])

            def step(dev):
                b = hdp_em.build_hdp_em_buckets(jobs, device=dev, threshold=HDP_THRESHOLD)
                return hdp_em.hdp_em_step(b, nhdp, None, HDP_THRESHOLD)
        else:
            jobs = sm3_em.collect_sm3_em_jobs(preps, {"t": pore, "c": pore}, params, strand)

            def step(dev):
                b = vanilla_em.build_vanilla_em_buckets(jobs, strand, device=dev)
                return vanilla_em.vanilla_em_step(b, pore.skip_bins)
        n_jobs += len(jobs)
        t0 = time.perf_counter()
        card, again = step(device), step(device)
        t1 = time.perf_counter()
        plain = step(torch.device("cpu"))
        t_card, t_cpu = t_card + (t1 - t0) / 2, t_cpu + time.perf_counter() - t1
        tallies = (card[0], plain[0])
        lik = (card[1], plain[1])
        same = same and all(np.array_equal(np.asarray(a), np.asarray(b))
                            for a, b in zip(card, again))
        if not np.allclose(*tallies, rtol=STEP_RTOL, atol=STEP_ATOL) or \
                abs(lik[0] - lik[1]) > LIK_RTOL * abs(lik[1]):
            raise AssertionError(f"{machine} E-step on the card and the CPU disagree "
                                 f"(strand {strand})")
        worst["tallies"] = max(worst["tallies"], float(np.abs(tallies[0] - tallies[1]).max()))
        worst["likelihood"] = max(worst["likelihood"], abs(lik[0] - lik[1]) / abs(lik[1]))
        if hdp:
            a = Counter(zip(card[2], card[3]))
            b = Counter(zip(plain[2], plain[3]))
            share = sum((a & b).values()) / max(len(card[2]), len(plain[2]), 1)
            worst["assignments"] = min(worst["assignments"], share)
            if share < HDP_ASSIGN_SHARE or len(card[2]) < 100:
                raise AssertionError(f"threeStateHdp assignments: {share} shared")
    print(f"em {machine} agreement: one E-step over {n_jobs} jobs of {len(small)} reads, "
          f"cuda vs cpu ({t_card:.2f} s / {t_cpu:.2f} s): max abs err tallies "
          f"{worst['tallies']:.3g} (rtol {STEP_RTOL} atol {STEP_ATOL}), likelihood relative "
          f"{worst['likelihood']:.3g} (tol {LIK_RTOL})"
          + (f", assignments shared {worst['assignments']:.5f} (>= {HDP_ASSIGN_SHARE})"
             if hdp else "") + f"; two card runs bit-identical {same}", flush=True)
    if not same:
        raise AssertionError(f"{machine}: two card E-steps differ")


def oracle_us_per_diagonal(job, device) -> tuple[int, int, float, float]:
    """(diagonals, band width, forward and backward microseconds a diagonal)
    of the f64 oracle (engine/fb.py) on one split job on the card, the host
    clock around each pass ending in a synchronize."""
    import torch

    from cpecan_signal_tpu_torch.engine import fb

    plan, inp = fb.prepare_inputs(job.sm, job.band, ragged_left=job.ragged_left,
                                  ragged_right=job.ragged_right, device=device)
    D, W = inp.valid.shape
    out = []
    for fn in (fb.forward, fb.backward):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(plan, inp)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / D * 1e6)
    return D, W, out[0], out[1]


def phase_host_f64(tmp, nuc, ref, ref_seq, model, small, nhdp_paths, device, card) -> None:
    """The routes of the f64 oracle on the card (engine/fb.py; no kernel of
    csrc/): realign_record on the two 1 kb records against the batched kernel
    route (each record's pairs within the pair tolerance, and its CIGAR);
    one cli/em --engine host iteration on them against the kernel E-step
    (its model within tests/test_torch_discrete.py's f64 tolerances);
    train_models --engine host
    (threeState, one iteration) on the 2 smallest reads against the device
    E-step (test_torch_em's f64 tolerances, rtol 1e-3 + atol 1e-4), and
    threeStateHdp at --assignmentThreshold 0 (the oracle's route: every
    cell an assignment) on the smallest read against its E-step on the CPU
    (rtol 1e-9, the same assignments); align_read(device_batch=False) on those reads against the
    batched route; and the oracle's microseconds a diagonal, threeState and
    fiveState."""
    import numpy as np
    import torch

    from cpecan_signal_tpu_torch.cli import em, realign, train_models
    from cpecan_signal_tpu_torch.cli.vanilla_align import align_read, guide_alignment
    from cpecan_signal_tpu_torch.engine.batch_align import assemble_pairs, batch_align_jobs
    from cpecan_signal_tpu_torch.hdp.nanopore import deserialize_nhdp
    from cpecan_signal_tpu_torch.io.npread import load_npread
    from cpecan_signal_tpu_torch.models.params import AlignmentParams, cli_defaults
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    params = AlignmentParams()
    # realign_record against the batched kernel route, record by record
    heads, spans, jobs = realign.record_jobs(nuc["small"], nuc["seqs"], params, None)
    frags = batch_align_jobs(jobs, params.threshold, device=device)
    t0 = time.perf_counter()
    worst, same = [], []
    for rec, (sx, sy, aall), span in zip(nuc["small"], heads, spans):
        _x, _y, _a, anchors, make_sm = realign.stage_record_head(rec, nuc["seqs"], params, None)
        host = realign.align_sequence_pair(make_sm, sx, sy, anchors, params, ragged_left=True,
                                           ragged_right=True, device=device)
        worst.append(pairs_agree(host, assemble_pairs(frags[span])))
        lines = [r.to_line() for r in realign.realign_record(rec, nuc["seqs"], params,
                                                             device=device)]
        want = [r.to_line() for r in realign.finish_record(rec, assemble_pairs(frags[span]),
                                                           sx, sy, aall, params)]
        same.append(lines == want)
    t_realign = time.perf_counter() - t0
    miss, drift = max(m for m, _d in worst), max(d for _m, d in worst)
    # one cli/em iteration, --engine host against the kernel E-step
    cig = os.path.join(tmp, "small.cig")
    with open(cig, "w") as fh:
        fh.write("".join(r.to_line() + "\n" for r in nuc["small"]))
    t0 = time.perf_counter()
    models = {eng: em.expectation_maximisation(
        cig, [nuc["fasta"]], os.path.join(tmp, f"small_{eng}.hmm"), iterations=1, trials=1,
        set_jukes_cantor_divergence=NUC_JC_START, engine=eng, device=device,
        log=lambda m: None) for eng in ("host", "pallas")}
    t_em = time.perf_counter() - t0
    h, k = models["host"], models["pallas"]
    em_ok = (np.allclose(h.transitions, k.transitions, rtol=NUC_HOST_RTOL, atol=NUC_HOST_ATOL)
             and np.allclose(h.emissions, k.emissions, rtol=NUC_HOST_RTOL, atol=NUC_HOST_ATOL)
             and abs(h.likelihood - k.likelihood) <= NUC_HOST_LIK * abs(k.likelihood))
    # train_models --engine host, and threeStateHdp at threshold 0
    reads2 = small[:2]
    quiet = dict(log=lambda *a: None, device=device)
    t0 = time.perf_counter()
    runs = {eng: train_models.train(ref, reads2, model, model, iterations=1, engine=eng,
                                    out_dir=tmp, **quiet) for eng in ("host", "pallas")}
    t_train = time.perf_counter() - t0
    th, tk = runs["host"], runs["pallas"]
    train_ok = (np.allclose(th["likelihoods"], tk["likelihoods"], rtol=HOST_RTOL) and all(
        np.allclose(th["accumulators"][s].kmer_gap, tk["accumulators"][s].kmer_gap,
                    rtol=HOST_RTOL, atol=HOST_ATOL)
        and np.allclose(th["accumulators"][s].transitions, tk["accumulators"][s].transitions,
                        rtol=HOST_RTOL, atol=HOST_ATOL) for s in "tc"))
    hdp_dir = os.path.join(tmp, "train_hdp0")
    os.makedirs(hdp_dir)
    t0 = time.perf_counter()
    hdp0 = train_models.train(
        ref, reads2[:1], model, model, iterations=1, sm_type="threeStateHdp",
        assignment_threshold=0.0, template_hdp=nhdp_paths[0], complement_hdp=nhdp_paths[1],
        gibbs=dict(num_samples=5, burn_in=20, thinning=2), out_dir=hdp_dir, **quiet)
    t_hdp = time.perf_counter() - t0
    prep_params = cli_defaults()
    preps = [train_models._prepare_read(ref_seq, load_npread(reads2[0]), prep_params,
                                        descale=True)]
    hdp_ok = True
    for s, path in zip("tc", nhdp_paths):
        cpu_acc = train_models._host_estep(
            preps, s, "threeStateHdp", dict.fromkeys("tc"), {"transitions": None},
            prep_params, 0.0,
            deserialize_nhdp(path).density_logp_fn(), cpu, None, None)
        cpu_acc.normalize()
        got = hdp0["accumulators"][s]
        hdp_ok &= (got.kmer_assignments == cpu_acc.kmer_assignments
                   and got.event_assignments == cpu_acc.event_assignments
                   and np.allclose(got.transitions, cpu_acc.transitions, rtol=1e-9)
                   and abs(got.likelihood - cpu_acc.likelihood) <= 1e-9 * abs(cpu_acc.likelihood))
    n_assign = [hdp0["accumulators"][s].n_assignments for s in "tc"]
    # align_read(device_batch=False) against the batched route
    pore = load_pore_model(model)
    t0 = time.perf_counter()
    read_worst = []
    for path in reads2:
        npr = load_npread(path)
        guide = guide_alignment(ref_seq, npr.twoD_read, prep_params.constraint_diagonal_trim)
        res = [align_read(ref_seq, "ref", npr, pore, pore, prep_params, "threeState",
                          guide=guide, device_batch=b, device=device) for b in (False, True)]
        read_worst += [pairs_agree(res[0][s], res[1][s]) for s in "tc"]
    t_read = time.perf_counter() - t0
    r_miss, r_drift = max(m for m, _d in read_worst), max(d for _m, d in read_worst)
    # the oracle's time a diagonal on the card, at f64
    sizes = [(len(j.sm.sm3_pack[2]), j) for jl in read_jobs(reads2[1:], ref_seq, model,
                                                             prep_params) for j in jl]
    d3 = oracle_us_per_diagonal(max(sizes, key=lambda t: t[0])[1], device)
    d5 = oracle_us_per_diagonal(jobs[0], device)
    t_all = time.perf_counter() - t_phase
    print(f"host f64: realign_record on {len(nuc['small'])} records vs the batched kernel "
          f"route ({t_realign:.2f} s): max pairs differing {miss} (tol {PAIR_TOL}), max "
          f"posterior drift {drift:.3g} (tol {PROB_TOL}), CIGARs equal {same}; cli/em "
          f"--engine host vs pallas, one iteration ({t_em:.2f} s): agree {em_ok} "
          f"(likelihood {h.likelihood:.4f} / {k.likelihood:.4f}); train_models --engine host "
          f"vs pallas on 2 reads ({t_train:.2f} s): agree {train_ok} (likelihood "
          f"{th['likelihoods']} / {tk['likelihoods']}); threeStateHdp at threshold 0 "
          f"on 1 read ({t_hdp:.2f} s): {n_assign} assignments, equal to the CPU oracle's "
          f"{hdp_ok}; "
          f"align_read(device_batch=False) vs batched on 2 reads ({t_read:.2f} s): max pairs "
          f"differing {r_miss}, max posterior drift {r_drift:.3g}; f64 oracle us a diagonal "
          f"(forward, backward): threeState D {d3[0]} W {d3[1]} {d3[2]:.1f}, {d3[3]:.1f}; "
          f"fiveState D {d5[0]} W {d5[1]} {d5[2]:.1f}, {d5[3]:.1f}; phase {t_all:.1f} s; "
          f"card {card}", flush=True)
    if miss > PAIR_TOL or drift > PROB_TOL or r_miss > PAIR_TOL or r_drift > PROB_TOL:
        raise AssertionError("host f64: the oracle's pairs and the kernels' disagree")
    if not (em_ok and train_ok and hdp_ok):
        raise AssertionError("host f64: an oracle E-step disagrees with its reference")


def offset_problems(pore, device, rng) -> dict:
    """{machine: (kernels' stage 4, plain versions' stage 4, batch)}: two
    threeState problems at W = 64, Dp = 512 and one fiveState problem of a
    200-base pair at W = 64, their start and end vectors on the 2^-7 grid."""
    import torch

    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.core.window import smooth_band
    from cpecan_signal_tpu_torch.em.discrete import collect_symbol_split_jobs
    from cpecan_signal_tpu_torch.engine import pipeline as pp
    from cpecan_signal_tpu_torch.engine.plan import edge_table
    from cpecan_signal_tpu_torch.models.params import AlignmentParams
    from cpecan_signal_tpu_torch.models.state_machines import (bind_symbol_sequences,
                                                                make_symbol_sm5)
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    def on_grid(v):
        return torch.where(v > fk.NEG_INF / 2, torch.round(v / OFFSET_GRID) * OFFSET_GRID, v)

    def plain(plan, b, E, one_group):   # run_sm3 / run_window, the plain versions
        edges = pp.to_device(edge_table(plan), device)
        F, offF = fk.forward_sm3_ref(edges, E, b.diag_scalars, b.d_last, b.start,
                                     b.tp_scalar)
        P, T, exits, gacc, st = fk.backward_sm3_ref(
            edges, plan.match_state, E, F, offF, b.diag_scalars, b.d_last, b.end,
            b.tp_scalar, 4, pp.sm3_wgroups(plan))
        return (P, T, exits[:, :, 0], gacc[:, 0], st) if one_group else (P, T, exits,
                                                                         gacc, st)

    plan3, b3 = kernel_problems(pore, 64, 512, 2, rng, device)
    x = "".join(rng.choice(list("ACGT"), 200))
    y, truth = syn.evolve_with_truth(x, rng, 0.05, 0.01, 0.01)

    def make_sm(a, b):
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, a, b)
        return sm

    job, = collect_symbol_split_jobs(make_sm, x, y, truth[::10], AlignmentParams(),
                                     ragged_left=True, ragged_right=False)
    wb = smooth_band(job.band, width_multiple=64)
    plan5, prob = pp.make_window_problem(job.sm, wb, device=device, ragged_left=True,
                                         ragged_right=False)
    b5 = pp.stack_window_problems([prob])
    Dp3 = b3.diag_scalars.shape[1] - 1
    return {"threeState": (lambda b: pp.run_sm3(plan3, 64, b, stages=4),
                           lambda b: plain(plan3, b, fk.emissions_sm3_ref(
                               b.x0, b.yr0, b.xarr, b.evr, 64, Dp3), True),
                           b3._replace(start=on_grid(b3.start), end=on_grid(b3.end))),
            "fiveState": (lambda b: pp.run_window(plan5, wb.W, b, stages=4),
                          lambda b: plain(plan5, b, b.E, False),
                          b5._replace(start=on_grid(b5.start), end=on_grid(b5.end)))}


def phase_offset(pore, device, rng, stats) -> None:
    """The recursions' offsets on the card (tests/test_torch_offset.py's
    checks): a start or end vector moved by -2^16 changes the kernels'
    posteriors, pairs and stage-4 tallies by at most OFFSET_ATOL and moves
    every total by 2^16, to the total's f32 spacing; and the kernels agree
    with their plain versions on the moved inputs."""
    import numpy as np
    import torch

    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    for machine, (run, run_plain, base) in offset_problems(pore, device, rng).items():
        want = run(base)
        for vector in ("start", "end"):
            moved = base._replace(**{vector: getattr(base, vector) - OFFSET_SHIFT})
            got = run(moved)
            ref = run_plain(moved)
            torch.cuda.synchronize()
            p_err = max_err(got[0], want[0])
            pairs_ok = torch.equal(got[0] > 0.01, want[0] > 0.01)
            t_want, t_got = want[1].cpu().numpy(), got[1].cpu().numpy()
            real = t_want > fk.NEG_INF / 2
            shift_err = np.abs(t_got[real] - (t_want[real] - np.float32(OFFSET_SHIFT)))
            t_ok = bool((real == (t_got > fk.NEG_INF / 2)).all() and real.sum() > 100
                        and (shift_err <= np.spacing(np.abs(t_got[real]))).all())
            # exits, gacc and the per-edge tallies (the stats lanes below the
            # likelihood's, which sums the moved totals)
            tallies = [(g[..., :fk.LIK_LANE], w[..., :fk.LIK_LANE])
                       if w.shape[-1] == fk.STATS_LANES else (g, w)
                       for g, w in zip(got[2:], want[2:])]
            tally_err = max(max_err(g, w) for g, w in tallies)
            tally_ok = all(bool(torch.allclose(g, w, rtol=OFFSET_ATOL, atol=OFFSET_ATOL))
                           for g, w in tallies)
            e4 = dict(zip(("p", "totals", "exits", "gacc", "stats"),
                          (max_err(a, r) for a, r in zip(got, ref))))
            plain_ok = (e4["p"] <= P_ATOL and max(e4["exits"], e4["gacc"]) <= WIN_ATOL
                        and bool(torch.allclose(got[1], ref[1], atol=F_ATOL, rtol=F_RTOL))
                        and bool(torch.allclose(got[4], ref[4], atol=STATS_ATOL,
                                                rtol=STATS_RTOL)))
            ok = p_err <= OFFSET_ATOL and pairs_ok and t_ok and tally_ok
            print(f"offset {machine} {vector} - 2^16: kernels against the unmoved run: p "
                  f"err {p_err:.3g}, pairs equal {pairs_ok}, totals moved by 2^16 to "
                  f"their spacing {t_ok} (largest error {float(shift_err.max()):.3g}), "
                  f"tallies err {tally_err:.3g} (rtol and atol {OFFSET_ATOL}); against the plain "
                  f"versions {e4}: ok {plain_ok}", flush=True)
            if not (ok and plain_ok):
                raise AssertionError(f"offset check failed: {machine} {vector}")
            stats["backward_em"]["max_abs_err"] = max(stats["backward_em"]["max_abs_err"],
                                                      e4["p"], e4["exits"], e4["gacc"])


def drift_row(job, threshold, device) -> dict:
    """One unsplit job through the kernels (engine/batch_align) and the f64
    oracle on the card (exact logaddexp): its pairs missing and extra, and
    the largest posterior drift on the pairs both give
    (tools/torch_f32_drift.py's comparison)."""
    import torch

    from cpecan_signal_tpu_torch.engine import fb
    from cpecan_signal_tpu_torch.engine.align import AlignedPairs, _extract_pairs
    from cpecan_signal_tpu_torch.engine.batch_align import batch_align_jobs

    (f32,) = batch_align_jobs([job], threshold, device=device)
    t0 = time.perf_counter()
    plan, inp = fb.prepare_inputs(job.sm, job.band, ragged_left=job.ragged_left,
                                  ragged_right=job.ragged_right, device=device,
                                  dtype=torch.float64)
    F, B = fb.forward(plan, inp), fb.backward(plan, inp)
    p, _ = fb.posterior_match_probs(plan, inp, F, B)
    f64 = AlignedPairs(*_extract_pairs(p.double().cpu().numpy(), inp.x.cpu().numpy(),
                                       inp.y.cpu().numpy(), threshold, job.off_x,
                                       job.off_y))
    a = {(x, y): q for q, x, y in f32.as_tuples()}
    b = {(x, y): q for q, x, y in f64.as_tuples()}
    common = set(a) & set(b)
    return {"Dp": int(inp.valid.shape[0]), "W": int(inp.valid.shape[1]), "pairs": len(b),
            "missing": len(set(b) - set(a)), "extra": len(set(a) - set(b)),
            "drift": max((abs(a[k] - b[k]) / 1e7 for k in common), default=0.0),
            "oracle_s": time.perf_counter() - t0}


def phase_drift(long_jobs, nuc, params, device, card: str) -> None:
    """The kernels' f32 posteriors against the f64 oracle at depth (ROADMAP
    §3's fault, repaired by the offsets): the 50 kb read's unsplit job and a
    100 kb fiveState record (the first guide record's pair, anchors at every
    25th true pair, as tools/torch_f32_drift.py makes it).  Raises past
    PAIR_TOL pairs or PROB_TOL drift."""
    from cpecan_signal_tpu_torch.engine.align import collect_symbol_split_jobs
    from cpecan_signal_tpu_torch.models.params import AlignmentParams
    from cpecan_signal_tpu_torch.models.state_machines import (bind_symbol_sequences,
                                                                make_symbol_sm5)

    def make_sm(a, b):
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, a, b)
        return sm

    local = nuc["truth"][0]   # the first record: x from 0, y from its first pair
    c = int(nuc["truth_all"][0, 1])
    (five,) = collect_symbol_split_jobs(make_sm, nuc["x"][:NUC_BASES // NUC_RECORDS],
                                        nuc["y"][c:c + int(local[-1, 1]) + 1],
                                        local[::25], AlignmentParams(),
                                        ragged_left=True, ragged_right=True)
    (three,) = long_jobs
    for name, job, threshold in (("threeState 50 kb read", three, params.threshold),
                                 ("fiveState 100 kb record", five,
                                  AlignmentParams().threshold)):
        r = drift_row(job, threshold, device)
        ok = max(r["missing"], r["extra"]) <= PAIR_TOL and r["drift"] <= PROB_TOL
        print(f"drift {name}: Dp {r['Dp']} W {r['W']}, {r['pairs']} oracle pairs, "
              f"missing {r['missing']} extra {r['extra']} (tol {PAIR_TOL}), max posterior "
              f"drift {r['drift']:.4g} (tol {PROB_TOL}); oracle {r['oracle_s']:.1f} s; "
              f"ok {ok}; card {card}", flush=True)
        if not ok:
            raise AssertionError(f"f32 drift past its limits: {name}")


def launch_ranks(module: str, args: list[str], ranks: int, log_dir: str,
                 timeout: int = 600) -> None:
    """``python -m module args`` as ``ranks`` ranks of one gloo group on this
    machine (on SIGALIGN_PLATFORM's device, the card here), each with the
    SIGALIGN_* variables and its log in ``log_dir``; every rank must exit 0
    within ``timeout`` seconds."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(ranks):
        env = dict(os.environ, SIGALIGN_COORDINATOR=f"localhost:{port}",
                   SIGALIGN_NUM_PROCS=str(ranks), SIGALIGN_PROC_ID=str(r))
        log = open(os.path.join(log_dir, f"{module.rsplit('.', 1)[-1]}.rank{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, "-m", module, *args], cwd=root,
                                       env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for proc, _log in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for r, (proc, log) in enumerate(procs):
        if proc.returncode != 0:
            with open(log.name) as fh:
                tail = fh.read()[-3000:]
            raise AssertionError(f"{module} rank {r} exited {proc.returncode}:\n{tail}")


def phase_distributed(tmp, ref, model, paths, fk) -> dict:
    """DIST_RANKS ranks on the one card over gloo (parallel/distributed.py):
    ``signal_align -s`` on DIST_READS reads and one ``train_models``
    iteration, each against one process on the same reads: the same TSV
    rows, and the trained tallies within the E-step limits.  Returns the
    one-process runs' kernel launches."""
    import numpy as np

    from cpecan_signal_tpu_torch.cli import signal_align, train_models
    from cpecan_signal_tpu_torch.em.accumulators import ContinuousPairHmm

    reads = os.path.join(tmp, "reads_dist")
    os.makedirs(reads)
    for p in paths[:DIST_READS]:
        os.symlink(p, os.path.join(reads, os.path.basename(p)))
    sa = ["-d", reads, "-r", ref, "-T", model, "-C", model, "-s"]
    tm = ["-r", ref, "-d", reads, "-T", model, "-C", model, "-i", "1"]
    out = {name: os.path.join(tmp, f"dist_{name}") for name in ("sa1", "sa2", "tm1", "tm2")}
    for d in out.values():
        os.makedirs(d)
    reset_launches(fk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        rc = signal_align.main(sa + ["-o", out["sa1"]])
        rc |= train_models.main(tm + ["-o", out["tm1"]])
    t_one = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    t0 = time.perf_counter()
    launch_ranks("cpecan_signal_tpu_torch.cli.signal_align", sa + ["-o", out["sa2"]],
                 DIST_RANKS, tmp)
    launch_ranks("cpecan_signal_tpu_torch.cli.train_models", tm + ["-o", out["tm2"]],
                 DIST_RANKS, tmp)
    t_two = time.perf_counter() - t0
    rows = {}
    for name in ("sa1", "sa2"):
        with open(os.path.join(out[name], "posteriors.tsv")) as fh:
            rows[name] = sorted(fh)
    labels = {r.split("\t")[3] for r in rows["sa1"]}
    same_rows = rows["sa1"] == rows["sa2"]
    errs = {}
    for strand in ("template", "complement"):
        one, two = (ContinuousPairHmm.load(os.path.join(out[n], f"{strand}_trained.hmm"))
                    for n in ("tm1", "tm2"))
        for k in ("transitions", "kmer_gap"):
            a, b = getattr(two, k), getattr(one, k)
            errs[f"{strand} {k}"] = float(np.max(np.abs(a - b) - STEP_RTOL * np.abs(b)))
        errs[f"{strand} likelihood"] = abs(two.likelihood - one.likelihood) / abs(one.likelihood)
    ok = (rc == 0 and same_rows and len(labels) == DIST_READS
          and all(v <= (LIK_RTOL if "likelihood" in k else STEP_ATOL)
                  for k, v in errs.items()))
    print(f"distributed: {DIST_RANKS} ranks on one card (gloo) against one process, "
          f"{DIST_READS} reads: signal_align -s {len(rows['sa2'])} TSV rows, equal rows "
          f"{same_rows}; train_models 1 iteration, tallies past rtol {STEP_RTOL} by at most "
          f"(atol {STEP_ATOL}) / likelihood relative (tol {LIK_RTOL}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; one process {t_one:.1f} s, {DIST_RANKS} ranks {t_two:.1f} s (each rank "
          f"starts a process); ok {ok}", flush=True)
    if not ok:
        raise AssertionError("the ranks disagree with one process")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch reports no usable CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.cli import signal_align
    from cpecan_signal_tpu_torch.engine.batch_align import (batch_align_jobs,
                                                            batch_align_stream)
    from cpecan_signal_tpu_torch.models.params import cli_defaults
    from cpecan_signal_tpu_torch.ops import _build
    from cpecan_signal_tpu_torch.ops import fb_kernels as fk

    t_start = time.perf_counter()

    def mark(label: str) -> None:
        print(f"elapsed after {label}: {time.perf_counter() - t_start:.1f} s", flush=True)

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
        phase_emissions(device, rng, stats)
        phase_wide(pore, device, rng, stats)
        phase_generic_kernels(pore, device, rng, stats)
        nuc = nucleotide_set(tmp)
        phase_five_kernels(nuc, device, stats)
        phase_stage4_configs(pore, device, rng, stats)
        phase_offset(pore, device, rng, stats)
        mark("the kernel checks")

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
        small = [paths[i] for i in np.argsort(sizes)[:5]]
        jobs5, got, want5, small_tsv = align_small(tmp, small, ref_seq, model, params,
                                                   device)
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

        events, long_jobs = long_read_jobs(pore, ref_seq, data_rng, params)
        long_calls = []
        with recording_emissions(fk, long_calls):
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
        phase_long_emissions(max(long_calls, key=lambda a: a[5]), card, stats)
        del long_calls
        mark("threeState alignment")
        phase_drift(long_jobs, nuc, params, device, card)
        mark("the f32 drift")

        # --- training path through the CLI, and one E-step against the CPU
        path_launches = [launches, phase_train(tmp, reads, ref, model, fk)]
        phase_em_agreement(paths, ref_seq, model, device)
        mark("threeState training")
        path_launches.append(phase_distributed(tmp, ref, model, paths, fk))
        mark("several processes")

        # --- the generic window machines through the CLI, each against the
        # CPU plain path on the jobs of the 5 smallest reads (echelon: the
        # smallest, MACHINES); vanilla timed
        ech_reads = os.path.join(tmp, "reads_echelon")
        os.makedirs(ech_reads)
        for p in paths[:ECHELON_READS]:
            os.symlink(p, os.path.join(ech_reads, os.path.basename(p)))
        for machine in MACHINES:
            cli_set = ((ech_reads, paths[:ECHELON_READS]) if machine == "echelon"
                       else (reads, paths))
            path_launches.append(phase_generic_cli(tmp, cli_set[0], ref, model, cli_set[1],
                                                   fk, machine))
            phase_generic_agreement(small[:MACHINES[machine][2]], ref_seq, model, device,
                                    machine)
        phase_vanilla_timing(paths, ref_seq, model, device, card)
        mark("the generic machines")

        # --- vanilla EM; the HDPs built from the threeState alignment's TSV,
        # threeStateHdp alignment and HDP EM on them; each against the CPU
        # plain path on the smallest reads
        path_launches.append(phase_train_machine(tmp, reads, ref, model, fk, "vanilla", []))
        phase_em_machine_agreement(small[:EM_AGREE_READS], ref_seq, model, device, "vanilla")
        mark("vanilla training")
        nhdp_paths = phase_build_hdp(tmp, os.path.join(tmp, "out", "posteriors.tsv"), model,
                                     small_tsv, card)
        path_launches.append(phase_hdp_align(tmp, ref, ref_seq, model, paths, small,
                                             nhdp_paths, fk, device, card))
        path_launches.append(phase_train_machine(
            tmp, reads, ref, model, fk, "threeStateHdp",
            ["-v", nhdp_paths[0], "-w", nhdp_paths[1], "--assignmentThreshold",
             str(HDP_THRESHOLD), *HDP_TRAIN_GIBBS]))
        phase_em_machine_agreement(small[:EM_AGREE_READS], ref_seq, model, device,
                                   "threeStateHdp", nhdp_paths)
        mark("the HDP paths")

        # --- the nucleotide paths through their CLIs: realignment, then
        # nucleotide EM; each checked against the CPU plain path on small
        # records
        path_launches.append(phase_realign(nuc, fk))
        phase_realign_agreement(nuc, device)
        path_launches.append(phase_nuc_em(tmp, nuc, fk))
        phase_nuc_em_agreement(tmp, nuc, device)
        launches = {k: sum(pl[k] for pl in path_launches) for k in KERNELS}
        mark("the nucleotide paths")

        # --- the f64 oracle's routes on the card (no kernel of csrc/)
        phase_host_f64(tmp, nuc, ref, ref_seq, model, small, nhdp_paths, device, card)

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
