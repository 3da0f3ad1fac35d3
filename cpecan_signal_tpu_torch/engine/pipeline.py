"""Problem packing and the kernel pipelines (port of
engine/pallas_pipeline.py:32-214, 256-391, 426-447): threeState problems
(emissions -> forward -> backward, and the E-step tallies on top), and the
generic window problems of any machine, whose emission and per-cell
transition grids are built on the host (forward -> backward, at stage 3 or
with the EM tallies of stage 4).

The staging every lane shares: which jobs share a launch
(``launch_groups``), a job's window rows padded to its launch's diagonals
(``pad_window``), the kernels' per-diagonal rows built from them on the
host or on the card (``band_scalars``), and the upload and the one
download (``to_device``, ``to_host``).

Index conventions: per-x arrays are indexed by x (= x_idx + 1, so slot 0 is
the x = -1 sentinel) shifted by +PADX so window cells left of the matrix stay
in bounds; reversed event arrays are indexed by ri = lY - y (increasing along
a diagonal).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..constants import KMER_LENGTH, NUM_OF_KMERS
from ..core.window import WindowBand
from ..models.pore_model import PoreModel
from ..models.state_machines import LOG_TENTH, SHORT_GAP_X, make_signal_sm3
from ..ops import fb_kernels as fk
from .plan import EnginePlan, _build_plan, edge_table, plan_from
from .window import prepare_window_inputs

NEG_INF = fk.NEG_INF


class SM3Problem(NamedTuple):
    """One threeState problem, or a batch of them stacked on a leading axis."""

    xarr: torch.Tensor          # (13, lXp) f32 per-x parameter pack
    evr: torch.Tensor           # (2, lYp) f32 reversed event rows
    x0: torch.Tensor            # (Dp+1,) int32 emission x-slice offsets
    yr0: torch.Tensor           # (Dp+1,) int32
    diag_scalars: torch.Tensor  # (Dp+1, 1, 8) int32 (ops/fb_kernels DS_*)
    d_last: torch.Tensor        # () int32
    start: torch.Tensor         # (S,) f32
    end: torch.Tensor           # (S,) f32
    tp_scalar: torch.Tensor     # (n,) f32
    xrank: torch.Tensor         # (lXp,) int32 k-mer rank per xarr column


def _gauss_pack(table: np.ndarray, ranks: np.ndarray):
    """(mu, inv_sd, logc) triplets for level & noise from a model table
    gathered by rank; sigma == 0 rows (sentinels) become NEG_INF emissions."""
    mu_l = table[ranks, 0]
    sd_l = table[ranks, 1]
    mu_n = table[ranks, 2]
    sd_n = table[ranks, 3]

    def pack(mu, sd):
        ok = sd != 0.0
        inv = np.where(ok, 1.0 / np.where(ok, sd, 1.0), 0.0)
        logc = np.where(ok, -0.91893853320467267 - np.log(np.where(ok, sd, 1.0)),
                        NEG_INF)
        return np.where(ok, mu, 0.0), inv, logc

    return pack(mu_l, sd_l) + pack(mu_n, sd_n)


def finite_f32(v):
    """Finite f32: saturate -inf transition/boundary values to NEG_INF so
    in-kernel f32 arithmetic stays NaN-free."""
    return np.maximum(np.asarray(v, dtype=np.float64), NEG_INF).astype(np.float32)


# ---------------------------------------------------------------------------
# Window rows and launches: the staging every lane shares
# ---------------------------------------------------------------------------

MAX_BUCKET = 64    # problems a launch


def launch_groups(keys, sizes=None, size_cap=math.inf) -> list[tuple[object, list[int]]]:
    """Which jobs share a launch.  Job i joins the group of ``keys[i]``
    (groups in the order of their first job, jobs in job order); each group
    is cut, in order, into chunks of at most MAX_BUCKET jobs whose padded
    size, their count times the largest of their ``sizes``, stays within
    ``size_cap``.  A job over the cap alone gets a chunk of its own.
    Returns [(key, job indices)]."""
    sizes = [0] * len(keys) if sizes is None else sizes
    groups: dict[object, list[int]] = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    out = []
    for key, idxs in groups.items():
        chunk, top = [], 0
        for i in idxs:
            size = max(top, sizes[i])
            if chunk and (len(chunk) >= MAX_BUCKET or (len(chunk) + 1) * size > size_cap):
                out.append((key, chunk))
                chunk, size = [], sizes[i]
            chunk.append(i)
            top = size
        out.append((key, chunk))
    return out


def pad_window(wb: WindowBand, Dp: int) -> np.ndarray:
    """(3, Dp) int32 window rows (w0, xmyL, xmyR) of a band padded to Dp
    diagonals: past the last one, w0 steps +1 and -1 in turn and the xmy
    range is empty (xmyL = w0 + 2W + 2 > xmyR = w0), so padded rows stay
    invalid."""
    D = wb.n_diagonals
    out = np.empty((3, Dp), dtype=np.int32)
    out[0, :D] = wb.w0
    out[1, :D] = wb.xmyL
    out[2, :D] = wb.xmyR
    w0p = wb.w0[D - 1] + (np.arange(Dp - D) % 2 == 0)
    out[0, D:] = w0p
    out[1, D:] = w0p + 2 * wb.W + 2
    out[2, D:] = w0p
    return out


def band_scalars(win: torch.Tensor, lY: torch.Tensor, W: int, lXp: int, lYp: int):
    """The kernels' per-diagonal rows of a batch, on the device of ``win``:
    from the padded window rows ``win`` (B, 3, Dp) int32 and the event
    counts ``lY`` (B,), the DS_* rows (B, Dp+1, 1, 8) and the emission
    offsets x0, yr0 (B, Dp+1) int32 into per-x and reversed-event rows
    padded by W on the left (x0 = (d + w0) / 2 + W clamped to [0, lXp - W],
    yr0 = lY - (d - w0) / 2 + W clamped to [0, lYp - W]).  DS_XS is the
    step of x0; row Dp of the DS_* rows repeats row Dp - 1 (the kernels peek
    at d + 1), x0 and yr0 are 0 there.  All divisions are exact ((d +- w0)
    is even)."""
    w0 = win[:, 0]
    B, Dp = w0.shape
    dev = win.device
    d = torch.arange(Dp, dtype=torch.int32, device=dev)
    x0 = torch.zeros((B, Dp + 1), dtype=torch.int32, device=dev)
    yr0 = torch.zeros((B, Dp + 1), dtype=torch.int32, device=dev)
    x0[:, :Dp] = torch.clamp((d + w0) // 2 + W, 0, lXp - W)
    yr0[:, :Dp] = torch.clamp(lY[:, None] - (d - w0) // 2 + W, 0, lYp - W)
    ds = torch.zeros((B, Dp + 1, 8), dtype=torch.int32, device=dev)
    ds[:, 2:Dp, fk.DS_FM] = (w0[:, 2:] - w0[:, :-2]) // 2
    ds[:, 1:Dp, fk.DS_FL] = (w0[:, 1:] - 1 - w0[:, :-1]) // 2
    ds[:, :Dp - 1, fk.DS_BL] = (w0[:, :-1] + 1 - w0[:, 1:]) // 2
    ds[:, :Dp - 2, fk.DS_BM] = (w0[:, :-2] - w0[:, 2:]) // 2
    ds[:, :Dp, fk.DS_W0] = w0
    ds[:, :Dp, fk.DS_XMYL] = win[:, 1]
    ds[:, :Dp, fk.DS_XMYR] = win[:, 2]
    ds[:, 1:Dp, fk.DS_XS] = x0[:, 1:Dp] - x0[:, :Dp - 1]
    ds[:, Dp] = ds[:, Dp - 1]
    return ds[:, :, None, :], x0, yr0


def window_band_scalars(win: torch.Tensor, W: int):
    """(DS_* rows, x0) of WindowProblems from their window rows: the rows of
    ``band_scalars`` and x0 the grid x of window lane 0, row Dp repeating
    row Dp - 1.  Lane 0 lies at most W - 1 lanes left of the band and x
    grows by at most one a diagonal, so bounds of Dp + 2W + 128 never
    clamp."""
    B, _three, Dp = win.shape
    bound = Dp + 2 * W + 128
    ds, x0, _yr0 = band_scalars(win, torch.zeros(B, dtype=torch.int32, device=win.device),
                                W, bound, bound)
    x0 = x0 - W
    x0[:, Dp] = x0[:, Dp - 1]
    return ds, x0


def make_sm3_problem(pore: PoreModel, target_seq: str, events: np.ndarray,
                     wband: WindowBand, *, device: torch.device,
                     transitions=None, kmer_gap_probs=None, ragged_left=True,
                     ragged_right=True, pad_lx: int | None = None,
                     pad_ly: int | None = None, pad_d: int | None = None
                     ) -> tuple[EnginePlan, SM3Problem]:
    """Host-packed threeState problem (make_sm3_pallas_problem).  Dp is the
    diagonal count padded to ``pad_d``; the kernels need no block rounding."""
    sm = make_signal_sm3(pore, target_seq, events, transitions, kmer_gap_probs)
    plan, tp_scalar, cell_sources = _build_plan(sm, "exact")
    assert not cell_sources

    W = wband.W
    D = wband.n_diagonals
    Dp = max(D, pad_d or D)
    lX = len(target_seq) - KMER_LENGTH + 1
    lY = len(events)
    lx_cap = lX if pad_lx is None else pad_lx
    ly_cap = lY if pad_ly is None else pad_ly

    # per-x parameter pack: slots x = 0..lX (+1 sentinel at 0), padded by W
    # on both sides so any window slice is in bounds
    PADX = W
    lXp = -(-(lx_cap + 1 + 2 * W + 2 * 128) // 128) * 128
    xarr = np.zeros((fk.N_XPARAMS, lXp), dtype=np.float32)
    xarr[[2, 5, 8, 11, 12]] = NEG_INF   # logc and gapX rows default to invalid
    ranks = sm.kmer_ranks
    sl = slice(PADX, PADX + lX + 1)
    for row, vals in enumerate(_gauss_pack(pore.match_model, ranks)
                               + _gauss_pack(pore.y_model, ranks)):
        xarr[row, sl] = vals
    gapx_tab = np.full(NUM_OF_KMERS + 2, LOG_TENTH)
    if kmer_gap_probs is not None:
        gapx_tab[:NUM_OF_KMERS] = kmer_gap_probs
    gapx_tab[NUM_OF_KMERS:] = NEG_INF
    xarr[12, sl] = np.maximum(gapx_tab[ranks], NEG_INF)
    xrank = np.full(lXp, NUM_OF_KMERS + 1, dtype=np.int32)
    xrank[sl] = ranks

    # reversed event rows: ri = lY - y in [0, lY], padded by W
    PADY = W
    lYp = -(-(ly_cap + 1 + 2 * W + 2 * 128) // 128) * 128
    evr = np.zeros((2, lYp), dtype=np.float32)
    evr[0, PADY:PADY + lY] = events[::-1, 0]
    evr[1, PADY:PADY + lY] = events[::-1, 1]

    ds, x0, yr0 = band_scalars(torch.from_numpy(pad_window(wband, Dp)[None]),
                               torch.tensor([lY], dtype=torch.int32), W, lXp, lYp)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    prob = SM3Problem(
        xarr=t(xarr, torch.float32), evr=t(evr, torch.float32),
        x0=t(x0[0], torch.int32), yr0=t(yr0[0], torch.int32),
        diag_scalars=t(ds[0], torch.int32),
        d_last=t(D - 1, torch.int32),
        start=t(finite_f32(sm.ragged_start if ragged_left else sm.start), torch.float32),
        end=t(finite_f32(sm.ragged_end if ragged_right else sm.end), torch.float32),
        tp_scalar=t(finite_f32(tp_scalar), torch.float32),
        xrank=t(xrank, torch.int32))
    return plan, prob


def stack_problems(probs: list[SM3Problem]) -> SM3Problem:
    """Stack equally padded problems into one batch."""
    return SM3Problem(*(torch.stack(fields, dim=0) for fields in zip(*probs)))


def problem_from_numpy(plan, prob, device: torch.device, Dp: int | None = None
                       ) -> tuple[EnginePlan, SM3Problem]:
    """Carry a JAX ``SM3PallasProblem`` batch (or an object with its fields
    as numpy arrays) and its ``EnginePlan`` over to the port: diag_scalars
    at nh = 1, rows past Dp+1 dropped (Dp defaults to the scalar rows - 1),
    start/end/tp_scalar as f32.  Returns (port plan, SM3Problem)."""
    ds = np.asarray(prob.diag_scalars)
    if Dp is None:
        Dp = ds.shape[-3] - 1

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return plan_from(plan), SM3Problem(
        xarr=t(prob.xarr, torch.float32), evr=t(prob.evr, torch.float32),
        x0=t(np.asarray(prob.x0)[..., :Dp + 1], torch.int32),
        yr0=t(np.asarray(prob.yr0)[..., :Dp + 1], torch.int32),
        diag_scalars=t(ds[..., :Dp + 1, :1, :], torch.int32),
        d_last=t(prob.d_last, torch.int32),
        start=t(prob.start, torch.float32), end=t(prob.end, torch.float32),
        tp_scalar=t(prob.tp_scalar, torch.float32),
        xrank=t(prob.xrank, torch.int32))


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  CUDA uploads go through pinned
    memory without blocking, so dispatching a bucket never waits for the
    work already queued on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_host(handles: list[torch.Tensor]) -> list[np.ndarray]:
    """ONE device-to-host copy for all pending buckets: the packed outputs
    are concatenated on the device and split on the host."""
    if not handles:
        return []
    combined = torch.cat([h.reshape(-1) for h in handles]).cpu().numpy()
    out = []
    off = 0
    for h in handles:
        out.append(combined[off:off + h.numel()].reshape(h.shape))
        off += h.numel()
    return out


def run_sm3(plan: EnginePlan, W: int, batch: SM3Problem, stages: int = 3):
    """emissions -> forward -> fused backward on a stacked batch.  Stage 3
    (alignment) returns (p (B, Dp, W) match posteriors, totals (B, Dp));
    stage 4 (EM) returns the five outputs of the JAX ``run_sm3_pallas``:
    (p, totals, exits (B, Dp), gacc (B, W), stats (B, 128)), the window
    tallies of the one default group (the edges into shortGapX)."""
    if stages not in (3, 4):
        raise ValueError(f"stages={stages}: the port runs stage 3 or 4")
    Dp = batch.diag_scalars.shape[1] - 1
    edges = to_device(edge_table(plan), batch.xarr.device)
    E = fk.emissions_sm3(batch.x0, batch.yr0, batch.xarr, batch.evr, W, Dp)
    F, offF = fk.forward_sm3(edges, E, batch.diag_scalars, batch.d_last, batch.start,
                             batch.tp_scalar)
    out = fk.backward_sm3(edges, plan.match_state, E, F, offF, batch.diag_scalars,
                          batch.d_last, batch.end, batch.tp_scalar, stages=stages,
                          wgroups=sm3_wgroups(plan) if stages == 4 else None)
    if stages == 3:
        return out
    p, totals, exits, gacc, stats = out
    return p, totals, exits[:, :, 0], gacc[:, 0], stats


def sm3_wgroups(plan: EnginePlan) -> tuple[tuple[int, ...]]:
    """The one stage-4 window group of the threeState E-step: the edges into
    shortGapX, whose posteriors are the per-k-mer gapX tallies (also the
    default group of ``run_window`` at stage 4, as in the JAX package)."""
    return (tuple(i for i, e in enumerate(plan.edges) if e.to == SHORT_GAP_X),)


def gapx_kmer_tallies(batch: SM3Problem, W: int, exits: torch.Tensor,
                      gacc: torch.Tensor) -> torch.Tensor:
    """Scatter the kernel's compact gapX outputs into per-k-mer tallies
    (B, NUM_OF_KMERS + 2): exits[d] belongs to the x column x0[d] + W - 1,
    gacc lane j to x0[0] + j, and xrank maps a column to its k-mer.  One
    scatter_add_ over the batch, on the batch's device."""
    B, Dp = exits.shape
    lane = torch.arange(W, device=exits.device)
    cols = torch.cat([batch.x0[:, :Dp] + (W - 1), batch.x0[:, :1] + lane], dim=1)
    kmer = torch.gather(batch.xrank, 1, cols.long()).long()
    t = torch.zeros((B, NUM_OF_KMERS + 2), dtype=exits.dtype, device=exits.device)
    return t.scatter_add_(1, kmer, torch.cat([exits, gacc], dim=1))


def unpack_stats(plan: EnginePlan, stats: np.ndarray):
    """stats (B, 128) -> (trans (B, S, S), likelihood (B,)), numpy."""
    stats = np.asarray(stats)
    S = plan.n_states
    trans = np.zeros((stats.shape[0], S, S))
    for ei, e in enumerate(plan.edges):
        trans[:, e.frm, e.to] += stats[:, ei]
    return trans, stats[:, fk.LIK_LANE]


def sm3_expectations(plan: EnginePlan, W: int, batch: SM3Problem):
    """Batched threeState E-step (the port of sm3_pallas_expectations): the
    stage-4 pipeline's per-edge tallies and likelihood (stats lanes) and its
    window gapX tallies scattered per k-mer, summed over the batch on its
    device.  Returns (trans (S, S), kmer_gap (NUM_OF_KMERS,), likelihood ())
    as f32 tensors."""
    _p, _totals, exits, gacc, stats = run_sm3(plan, W, batch, stages=4)
    S = plan.n_states
    n_e = len(plan.edges)
    kmer_gap = gapx_kmer_tallies(batch, W, exits, gacc).sum(0)[:NUM_OF_KMERS]
    onehot = np.zeros((n_e, S * S), dtype=np.float32)
    for ei, e in enumerate(plan.edges):
        onehot[ei, e.frm * S + e.to] += 1.0
    trans = (stats[:, :n_e] @ to_device(onehot, stats.device)).sum(0).reshape(S, S)
    return trans, kmer_gap, stats[:, fk.LIK_LANE].sum()


# ---------------------------------------------------------------------------
# Generic window problems: vanilla, fourState, echelon
# ---------------------------------------------------------------------------

class WindowProblem(NamedTuple):
    """A window-banded problem of any machine with host-built E (the JAX
    ``WindowPallasProblem``): channels 0..C-1 of E are the emission classes,
    channels C.. the per-cell transition rows (vanilla skip-bin terms,
    echelon duration posteriors).  One problem, or a batch stacked on a
    leading axis."""

    E: torch.Tensor             # (Dp+2, C+T, W) f32; rows >= D are 0
    diag_scalars: torch.Tensor  # (Dp+1, 1, 8) int32
    d_last: torch.Tensor        # () int32
    start: torch.Tensor         # (S,) f32
    end: torch.Tensor           # (S,) f32
    tp_scalar: torch.Tensor     # (max(n, 1),) f32
    x0: torch.Tensor            # (Dp+1,) int32 grid x of window lane 0 per
                                # diagonal (the per-x key of stage-4 tallies)


def _plan_channels(sm) -> tuple[EnginePlan, int]:
    """The machine's plan and C + T, its emission classes and per-cell
    transition rows: the channels of E."""
    plan, _tp, cells = _build_plan(sm, "exact")
    return plan, plan.n_eclasses + len(cells)


def hdp_inputs(sm, Lc: int) -> tuple[np.ndarray, np.ndarray]:
    """(k-mer ranks by grid x, event means by grid y) of a threeStateHdp
    machine, padded to Lc with their last values (slot 0 of the means is
    y = -1): the arrays readpath.hdp_emissions indexes."""
    r = np.asarray(sm.kmer_ranks, dtype=np.int32)
    rank = np.full(Lc, r[-1], dtype=np.int32)
    rank[:len(r)] = r
    ev = np.asarray(sm.event_means, dtype=np.float32)
    mean = np.zeros(Lc, dtype=np.float32)
    mean[1:1 + len(ev)] = ev
    if len(ev):
        mean[1 + len(ev):] = ev[-1]
    return rank, mean


def stack_window_scalars(items, Dp: int, device: torch.device):
    """(plan, [diag scalars, d_last, start, end, tp_scalar, x0] stacked on
    ``device``) of [(sm, wband, ragged_left, ragged_right)], one machine and
    one window width, padded to Dp diagonals: every WindowProblem field but
    E (make_window_pallas_problem, engine/pallas_pipeline.py:314-360).
    Lanes whose E the device builds (the threeStateHdp buckets) need nothing
    more from the host."""
    plan, rows = None, []
    for sm, wb, rl, rr in items:
        iplan, tp_scalar, _cells = _build_plan(sm, "exact")
        # buckets key on the machine's name; a plan that varied under one
        # name would run with the wrong edge table
        assert plan is None or iplan == plan, sm.spec.name
        plan = iplan
        rows.append((np.int32(wb.n_diagonals - 1),
                     finite_f32(sm.ragged_start if rl else sm.start),
                     finite_f32(sm.ragged_end if rr else sm.end),
                     finite_f32(tp_scalar if tp_scalar.size else np.zeros(1))))
    win = np.stack([pad_window(wb, Dp) for _sm, wb, *_r in items])
    ds, x0 = window_band_scalars(torch.from_numpy(win), items[0][1].W)
    d_last, start, end, tp_scalar = (np.stack(col) for col in zip(*rows))
    return plan, [to_device(a, device)
                  for a in (ds.numpy(), d_last, start, end, tp_scalar, x0.numpy())]


def _fill_window_grids(sm, wband: WindowBand, E_out: np.ndarray, *,
                       ragged_left: bool, ragged_right: bool) -> None:
    """Pack one problem's emission and transition grids for the generic
    kernels (make_window_pallas_problem, engine/pallas_pipeline.py:314-360)
    into ``E_out``, a zeroed (Dp+2, C+T, W) f32 array.  Emissions and
    transition rows saturate at NEG_INF, so the f32 kernels stay NaN-free
    (vanilla's all-zero emission class comes with log(0) transition
    rows)."""
    plan, winp = prepare_window_inputs(sm, wband, ragged_left=ragged_left,
                                       ragged_right=ragged_right)
    D = wband.n_diagonals
    C = winp.E.shape[1]
    assert C == plan.n_eclasses and E_out.shape[1] == C + winp.TP.shape[1]
    np.maximum(winp.E[:D], NEG_INF, out=E_out[:D, :C], casting="unsafe")
    np.maximum(winp.TP[:D], NEG_INF, out=E_out[:D, C:], casting="unsafe")


def make_window_problem(sm, wband: WindowBand, *, device: torch.device,
                        ragged_left=True, ragged_right=True,
                        pad_d: int | None = None) -> tuple[EnginePlan, WindowProblem]:
    """One generic window problem on ``device`` (make_window_pallas_problem).
    Dp is the diagonal count padded to ``pad_d``; the kernels need no block
    rounding, so E has Dp + 2 rows where the JAX problem has Dp + KD."""
    _plan, CT = _plan_channels(sm)
    Dp = max(wband.n_diagonals, pad_d or wband.n_diagonals)
    E = np.zeros((Dp + 2, CT, wband.W), dtype=np.float32)
    _fill_window_grids(sm, wband, E, ragged_left=ragged_left, ragged_right=ragged_right)
    plan, rest = stack_window_scalars([(sm, wband, ragged_left, ragged_right)], Dp, device)
    return plan, WindowProblem(torch.as_tensor(E, device=device), *(t[0] for t in rest))


def pack_window_bucket(items, device: torch.device) -> tuple[EnginePlan, WindowProblem]:
    """Stack the problems of ``items`` [(sm, wband, ragged_left,
    ragged_right)], one machine and one window width, padded to the longest,
    into one batch on ``device``.  On a card E is packed straight into
    pinned host memory and uploaded without blocking, so the card works on
    earlier buckets meanwhile.  The grids fill in parallel threads: numpy
    releases the GIL in their array arithmetic, which is most of the packing
    time."""
    _plan, CT = _plan_channels(items[0][0])
    Dp = max(wb.n_diagonals for _sm, wb, *_r in items)
    E = torch.zeros((len(items), Dp + 2, CT, items[0][1].W), dtype=torch.float32,
                    pin_memory=device.type == "cuda")
    E_np = E.numpy()

    def fill(b):
        sm, wb, rl, rr = items[b]
        _fill_window_grids(sm, wb, E_np[b], ragged_left=rl, ragged_right=rr)

    with ThreadPoolExecutor(max_workers=min(len(items), os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(len(items))))
    plan, rest = stack_window_scalars(items, Dp, device)
    return plan, WindowProblem(E.to(device, non_blocking=True), *rest)


def stack_window_problems(probs: list[WindowProblem]) -> WindowProblem:
    """Stack equally padded window problems into one batch."""
    return WindowProblem(*(torch.stack(fields, dim=0) for fields in zip(*probs)))


def window_problem_from_numpy(plan, prob, device: torch.device, Dp: int | None = None
                              ) -> tuple[EnginePlan, WindowProblem]:
    """Carry a JAX ``WindowPallasProblem`` batch (or an object with its
    fields as numpy arrays) and its ``EnginePlan`` over to the port: rows
    past Dp+2 of E and Dp+1 of the diagonal scalars and x0 dropped (Dp
    defaults to the scalar rows - 1)."""
    ds = np.asarray(prob.diag_scalars)
    if Dp is None:
        Dp = ds.shape[-3] - 1

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return plan_from(plan), WindowProblem(
        E=t(np.asarray(prob.E)[..., :Dp + 2, :, :], torch.float32),
        diag_scalars=t(ds[..., :Dp + 1, :1, :], torch.int32),
        d_last=t(prob.d_last, torch.int32),
        start=t(prob.start, torch.float32), end=t(prob.end, torch.float32),
        tp_scalar=t(prob.tp_scalar, torch.float32),
        x0=t(np.asarray(prob.x0)[..., :Dp + 1], torch.int32))


def run_window(plan: EnginePlan, W: int, batch: WindowProblem, stages: int = 3,
               pstates: tuple[int, ...] | None = None,
               wgroups: tuple[tuple[int, ...], ...] | None = None,
               pgroups: tuple[tuple[int, ...], ...] | None = None):
    """Forward -> fused backward on a stacked WindowProblem batch, on the
    batch's device (run_window_pallas, engine/pallas_pipeline.py:363-390).
    Stage 3 returns (p (B, Dp, W) match posteriors, or (B, Dp, P, W) with
    ``pstates``, totals (B, Dp)).  Stage 4 returns (p, totals, exits (B, Dp,
    G), gacc (B, G, W), stats (B, 128)), the EM tallies of ops/fb_kernels
    .backward_sm3: ``wgroups`` defaults to one group, the edges into
    shortGapX, as in the JAX function, and with ``pgroups`` p is (B, Dp, P,
    W), the per-edge-group posterior sums."""
    if stages not in (3, 4):
        raise ValueError(f"stages={stages}: the port runs stage 3 or 4")
    if batch.E.shape[-1] != W:
        raise ValueError(f"E has {batch.E.shape[-1]} lanes, not W = {W}")
    edges = to_device(edge_table(plan), batch.E.device)
    F, offF = fk.forward_sm3(edges, batch.E, batch.diag_scalars, batch.d_last,
                             batch.start, batch.tp_scalar)
    if stages == 4 and wgroups is None:
        wgroups = sm3_wgroups(plan)
    return fk.backward_sm3(edges, plan.match_state, batch.E, F, offF, batch.diag_scalars,
                           batch.d_last, batch.end, batch.tp_scalar, stages=stages,
                           wgroups=wgroups, pstates=pstates, pgroups=pgroups)
