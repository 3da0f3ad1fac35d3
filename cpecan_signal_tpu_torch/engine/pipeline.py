"""Problem packing and the kernel pipelines (port of
engine/pallas_pipeline.py:32-214, 256-391, 426-447): threeState problems
(emissions -> forward -> backward, and the E-step tallies on top), and the
generic window problems of any machine, whose emission and per-cell
transition grids are built on the host (forward -> backward, at stage 3 or
with the EM tallies of stage 4).

Index conventions: per-x arrays are indexed by x (= x_idx + 1, so slot 0 is
the x = -1 sentinel) shifted by +PADX so window cells left of the matrix stay
in bounds; reversed event arrays are indexed by ri = lY - y (increasing along
a diagonal).
"""

from __future__ import annotations

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


def _san(v):
    """Finite f32: saturate -inf transition/boundary values to NEG_INF so
    in-kernel f32 arithmetic stays NaN-free."""
    return np.maximum(np.asarray(v, dtype=np.float64), NEG_INF).astype(np.float32)


def _window_diag_scalars(wband: WindowBand, Dp: int):
    """(Dp+1, 1, 8) int32 DS_* rows for a window band padded to Dp diagonals;
    padded rows keep stepping the window with empty xmy ranges so they stay
    invalid.  DS_XS and the row-Dp copy are left to the caller.  Returns
    (ds, padded w0)."""
    D, W = wband.n_diagonals, wband.W
    w0 = np.empty(Dp, dtype=np.int64)
    w0[:D] = wband.w0
    for d in range(D, Dp):
        w0[d] = w0[d - 1] + (1 if (d - D) % 2 == 0 else -1)
    xmyL = np.empty(Dp, dtype=np.int64)
    xmyR = np.empty(Dp, dtype=np.int64)
    xmyL[:D] = wband.xmyL
    xmyR[:D] = wband.xmyR
    xmyL[D:] = w0[D:] + 2 * W + 2
    xmyR[D:] = w0[D:]

    ds = np.zeros((Dp + 1, 1, 8), dtype=np.int32)
    ds[2:Dp, 0, fk.DS_FM] = (w0[2:] - w0[:-2]) // 2
    ds[1:Dp, 0, fk.DS_FL] = (w0[1:] - 1 - w0[:-1]) // 2
    ds[:Dp - 1, 0, fk.DS_BL] = (w0[:-1] + 1 - w0[1:]) // 2
    ds[:Dp - 2, 0, fk.DS_BM] = (w0[:-2] - w0[2:]) // 2
    ds[:Dp, 0, fk.DS_W0] = w0
    ds[:Dp, 0, fk.DS_XMYL] = xmyL
    ds[:Dp, 0, fk.DS_XMYR] = xmyR
    return ds, w0


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

    ds, w0 = _window_diag_scalars(wband, Dp)
    d_arange = np.arange(Dp)
    x0 = np.zeros(Dp + 1, dtype=np.int32)
    yr0 = np.zeros(Dp + 1, dtype=np.int32)
    x0[:Dp] = np.clip((d_arange + w0) // 2 + PADX, 0, lXp - W)
    yr0[:Dp] = np.clip(lY - (d_arange - w0) // 2 + PADY, 0, lYp - W)
    ds[1:Dp, 0, fk.DS_XS] = x0[1:Dp] - x0[:Dp - 1]  # x-window step, in {0,1}
    ds[Dp] = ds[Dp - 1]  # row Dp: read when the kernels peek at d+1

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    prob = SM3Problem(
        xarr=t(xarr, torch.float32), evr=t(evr, torch.float32),
        x0=t(x0, torch.int32), yr0=t(yr0, torch.int32),
        diag_scalars=t(ds, torch.int32),
        d_last=t(D - 1, torch.int32),
        start=t(_san(sm.ragged_start if ragged_left else sm.start), torch.float32),
        end=t(_san(sm.ragged_end if ragged_right else sm.end), torch.float32),
        tp_scalar=t(_san(tp_scalar), torch.float32),
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


def window_scalars(sm, wband: WindowBand, Dp: int, *, ragged_left: bool,
                   ragged_right: bool):
    """The machine's plan and every WindowProblem field of one problem but E,
    as numpy: (diag scalars (Dp+1, 1, 8), d_last, start, end, tp_scalar,
    x0), padded to Dp diagonals (make_window_pallas_problem,
    engine/pallas_pipeline.py:314-360).  Lanes whose E the device builds
    (the threeStateHdp buckets) need nothing more from the host."""
    plan, tp_scalar, _cells = _build_plan(sm, "exact")
    ds, w0 = _window_diag_scalars(wband, Dp)
    # DS_XS (the x-window step) for the stage-4 window tallies
    x_of_j0 = (np.arange(Dp) + w0) // 2
    ds[1:Dp, 0, fk.DS_XS] = np.clip(x_of_j0[1:] - x_of_j0[:-1], 0, 1)
    ds[Dp] = ds[Dp - 1]
    x0 = np.empty(Dp + 1, dtype=np.int32)
    x0[:Dp] = x_of_j0
    x0[Dp] = x_of_j0[Dp - 1]
    start = sm.ragged_start if ragged_left else sm.start
    end = sm.ragged_end if ragged_right else sm.end
    tp_scalar = tp_scalar if tp_scalar.size else np.zeros(1)
    return plan, (ds, np.int32(wband.n_diagonals - 1), _san(start), _san(end),
                  _san(tp_scalar), x0)


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
    ``device``) of [(sm, wband, ragged_left, ragged_right)], one machine,
    padded to Dp diagonals: every WindowProblem field but E."""
    plan, rows = None, []
    for sm, wb, rl, rr in items:
        iplan, rest = window_scalars(sm, wb, Dp, ragged_left=rl, ragged_right=rr)
        assert plan is None or iplan == plan, sm.spec.name
        plan = iplan
        rows.append(rest)
    return plan, [to_device(np.stack(col), device) for col in zip(*rows)]


def _fill_window_problem(sm, wband: WindowBand, Dp: int, E_out: np.ndarray, *,
                         ragged_left: bool, ragged_right: bool):
    """Pack one problem for the generic kernels (make_window_pallas_problem,
    engine/pallas_pipeline.py:314-360) into ``E_out``, a zeroed (Dp+2, C+T,
    W) f32 array, and return (plan, the other WindowProblem fields as numpy,
    ``window_scalars``).  Emissions and transition rows saturate at NEG_INF,
    so the f32 kernels stay NaN-free (vanilla's all-zero emission class
    comes with log(0) transition rows)."""
    plan, winp = prepare_window_inputs(sm, wband, ragged_left=ragged_left,
                                       ragged_right=ragged_right)
    D = wband.n_diagonals
    C = winp.E.shape[1]
    assert C == plan.n_eclasses and E_out.shape[1] == C + winp.TP.shape[1]
    np.maximum(winp.E[:D], NEG_INF, out=E_out[:D, :C], casting="unsafe")
    np.maximum(winp.TP[:D], NEG_INF, out=E_out[:D, C:], casting="unsafe")
    return window_scalars(sm, wband, Dp, ragged_left=ragged_left,
                          ragged_right=ragged_right)


def make_window_problem(sm, wband: WindowBand, *, device: torch.device,
                        ragged_left=True, ragged_right=True,
                        pad_d: int | None = None) -> tuple[EnginePlan, WindowProblem]:
    """One generic window problem on ``device`` (make_window_pallas_problem).
    Dp is the diagonal count padded to ``pad_d``; the kernels need no block
    rounding, so E has Dp + 2 rows where the JAX problem has Dp + KD."""
    _plan, CT = _plan_channels(sm)
    Dp = max(wband.n_diagonals, pad_d or wband.n_diagonals)
    E = np.zeros((Dp + 2, CT, wband.W), dtype=np.float32)
    plan, rest = _fill_window_problem(sm, wband, Dp, E, ragged_left=ragged_left,
                                      ragged_right=ragged_right)
    return plan, WindowProblem(*(torch.as_tensor(a, device=device) for a in (E, *rest)))


def pack_window_bucket(items, device: torch.device) -> tuple[EnginePlan, WindowProblem]:
    """Stack the problems of ``items`` [(sm, wband, ragged_left,
    ragged_right)], one machine and one window width, padded to the longest,
    into one batch on ``device``.  On a card the batch is packed straight
    into pinned host memory and uploaded without blocking, so the card works
    on earlier buckets meanwhile.  The problems fill in parallel threads:
    numpy releases the GIL in the grids' array arithmetic, which is most of
    the packing time."""
    sm0, wb0 = items[0][:2]
    plan, CT = _plan_channels(sm0)
    Dp = max(wb.n_diagonals for _sm, wb, *_r in items)
    pinned = device.type == "cuda"
    E = torch.zeros((len(items), Dp + 2, CT, wb0.W), dtype=torch.float32,
                    pin_memory=pinned)
    E_np = E.numpy()

    def fill(b):
        sm, wb, rl, rr = items[b]
        return _fill_window_problem(sm, wb, Dp, E_np[b], ragged_left=rl, ragged_right=rr)

    rows = []
    with ThreadPoolExecutor(max_workers=min(len(items), os.cpu_count() or 1)) as pool:
        for (sm, *_r), (iplan, rest) in zip(items, pool.map(fill, range(len(items)))):
            # buckets key on the machine's name; a plan that varied under one
            # name would run with the wrong edge table
            assert iplan == plan, sm.spec.name
            rows.append(rest)
    fields = [E] + [torch.from_numpy(np.stack(col)) for col in zip(*rows)]
    if pinned:
        fields = [t if t.is_pinned() else t.pin_memory() for t in fields]
    return plan, WindowProblem(*(t.to(device, non_blocking=True) for t in fields))


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
