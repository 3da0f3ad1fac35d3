"""The f64 oracle: the generic banded forward-backward engine on torch (port
of ``cpecan_signal_tpu/engine/fb.py:123-436``).

Reference-band layout, exact logaddexp, any machine; every other engine is
held against it.  Replaces the reference's forward sweep with checkpointed
traceback (getPosteriorProbsWithBanding, pairwiseAligner.c:870-1006) with a
full banded FB per split: posterior output depends only on f*b/total per
cell.

Layout (as the JAX module): a diagonal d holds cells k = 0..width[d)-1 at
xmy = xmyL[d] + 2k, padded to the band width W; ``prepare_inputs`` packs
the emissions of every band cell into (D+1, W, C) and the per-cell
transition terms into (D+1, W, T) on the host, then moves them to the
device.  Neighbour algebra for a cell (d, k):
  lower  (x-1, y)   = diag d-1 at k + dL[d]
  middle (x-1, y-1) = diag d-2 at k + dM[d]
  upper  (x, y-1)   = diag d-1 at k + dL[d] + 1
and backward: diag d+1 at k + uS[d] (upper: - 1), diag d+2 at k + mS[d].

The recursion runs one diagonal at a time, a fixed handful of launches a
diagonal whatever the machine (the JAX module is a jitted lax.scan; a torch
loop that wrote each edge separately would cost about four launches per
edge per diagonal).  The edges are laid out as S x K slots, K the most
edges into one state (forward) or out of one (backward), padded slots
reading -inf; per chunk of diagonals one table holds, for every slot and
cell, the flat index of its source cell in F (or B) and the edge's
emission and transition term (-inf at cells off the band).  A diagonal is
then one gather from the flat F, one add, and a logAdd fold over the K
slots, written in place into F: the fold visits each state's edges in plan
order, as the JAX scan does (so ``logadd="lookup"``, whose cubic depends on
the order, gives the JAX result too).  F and B live as (D, S, W) and are
returned as (D, W, S) views, the JAX shapes.

``engine/window.py`` runs the same recursion in the window layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import LOG_ZERO, PAIR_ALIGNMENT_PROB_1
from ..core.band import Band
from ..models.state_machines import SRC_MIDDLE, SRC_UPPER, StateMachine
from ..ops.logmath import get_logadd, logaddexp
from .plan import EdgePlan, EnginePlan, _build_plan, plan_key_names  # noqa: F401

NEG_INF = LOG_ZERO
CHUNK = 1024   # diagonals whose gather tables are built at once


class EngineInputs(NamedTuple):
    """Tensors of one banded alignment problem, all on one device."""

    E: torch.Tensor          # (D+1, W, C) emissions; row D zero padding
    TP: torch.Tensor         # (D+1, W, T) per-cell transition terms (T may be 0)
    tp_scalar: torch.Tensor  # (n_scalar,)
    valid: torch.Tensor      # (D, W) bool
    dL: torch.Tensor         # (D,) int64 forward lower-neighbour shift
    dM: torch.Tensor         # (D,) forward middle-neighbour shift
    uS: torch.Tensor         # (D,) backward diag+1 shift
    mS: torch.Tensor         # (D,) backward diag+2 shift
    x: torch.Tensor          # (D, W) int32 matrix x coordinate (0..lX)
    y: torch.Tensor          # (D, W) int32 matrix y coordinate
    start: torch.Tensor      # (S,)
    end: torch.Tensor        # (S,)
    last_real: torch.Tensor  # (D,) bool: True exactly at the final real
                             # diagonal (trailing padded diagonals are invalid)
    aux: dict                # per-cell grids for the EM tallies: "rank",
                             # "bin", "sx", "sy" (int64), "mean" (dtype)


class Lanes(NamedTuple):
    """A banded problem as the recursion reads it, whatever its layout: the
    classes and transition terms on the middle axis, cells last."""

    E: torch.Tensor          # (D+1, C, W)
    TP: torch.Tensor         # (D+1, T, W)
    tp_scalar: torch.Tensor
    valid: torch.Tensor      # (D, W)
    fL: torch.Tensor         # (D,) int64: F[d-1] at k + fL[d] (upper: + 1)
    fM: torch.Tensor         # F[d-2] at k + fM[d]
    bL: torch.Tensor         # B[d+1] at k + bL[d] (upper: - 1)
    bM: torch.Tensor         # B[d+2] at k + bM[d]
    last_real: torch.Tensor  # (D,) bool
    start: torch.Tensor
    end: torch.Tensor


def _aux_grids(sm: StateMachine, x_idx, y_idx, dtype, device) -> dict:
    """Per-cell int grids of the EM tallies (and the HDP event means)."""
    aux = {}
    if hasattr(sm, "kmer_ranks"):
        aux["rank"] = torch.as_tensor(np.asarray(sm.kmer_ranks)[x_idx + 1], dtype=torch.int64,
                                      device=device)
    if hasattr(sm, "skip_bin_idx"):
        aux["bin"] = torch.as_tensor(np.asarray(sm.skip_bin_idx)[x_idx + 1],
                                     dtype=torch.int64, device=device)
    if hasattr(sm, "symbol_codes"):
        cx, cy = sm.symbol_codes
        aux["sx"] = torch.as_tensor(np.asarray(cx)[x_idx + 1], dtype=torch.int64, device=device)
        aux["sy"] = torch.as_tensor(np.asarray(cy)[y_idx + 1], dtype=torch.int64, device=device)
    if hasattr(sm, "event_means"):
        ev_means = np.concatenate([[0.0], np.asarray(sm.event_means)])
        aux["mean"] = torch.as_tensor(ev_means[y_idx + 1], dtype=dtype, device=device)
    return aux


def prepare_inputs(sm: StateMachine, band: Band, *, ragged_left: bool, ragged_right: bool,
                   device: torch.device, dtype=torch.float64, pad_width: int | None = None,
                   pad_diagonals: int | None = None) -> tuple[EnginePlan, EngineInputs]:
    """Host packing of the band's geometry grids, emissions and transition
    terms (numpy, as the JAX module), then tensors on ``device``."""
    D = band.n_diagonals
    W = int(band.max_width) if pad_width is None else pad_width
    assert W >= band.max_width
    Dp = D if pad_diagonals is None else pad_diagonals
    assert Dp >= D

    # padded rows replicate the final xmyL with width 0 (valid == False)
    xmyL = np.concatenate([band.xmyL, np.full(Dp - D, band.xmyL[-1])]).astype(np.int64)
    widths = np.concatenate([band.widths, np.zeros(Dp - D)]).astype(np.int64)

    d_grid = np.arange(Dp)[:, None]
    k_grid = np.arange(W)[None, :]
    xmy = xmyL[:, None] + 2 * k_grid
    x = (d_grid + xmy) // 2
    y = (d_grid - xmy) // 2
    valid = k_grid < widths[:, None]

    x_idx = np.clip(x - 1, -1, max(band.lX - 1, -1))
    y_idx = np.clip(y - 1, -1, max(band.lY - 1, -1))

    E = np.zeros((Dp + 1, W, sm.spec.n_eclasses), dtype=np.float64)
    E[:Dp] = sm.emissions(x_idx, y_idx)
    E[:Dp][~valid] = 0.0  # keep padding finite; masking handles correctness

    plan, tp_scalar, cell_sources = _build_plan(sm, "exact")
    TP = np.zeros((Dp + 1, W, len(cell_sources)), dtype=np.float64)
    for t, (kind, arr) in enumerate(cell_sources):
        TP[:Dp, :, t] = arr[x_idx + 1] if kind == "x" else arr[y_idx + 1]

    dL = np.zeros(Dp, dtype=np.int64)
    dM = np.zeros(Dp, dtype=np.int64)
    uS = np.zeros(Dp, dtype=np.int64)
    mS = np.zeros(Dp, dtype=np.int64)
    dL[1:] = (xmyL[1:] - 1 - xmyL[:-1]) // 2
    dM[2:] = (xmyL[2:] - xmyL[:-2]) // 2
    uS[:-1] = (xmyL[:-1] + 1 - xmyL[1:]) // 2
    mS[:-2] = (xmyL[:-2] - xmyL[2:]) // 2

    start = sm.ragged_start if ragged_left else sm.start
    end = sm.ragged_end if ragged_right else sm.end

    def on(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return plan, EngineInputs(
        E=on(E, dtype), TP=on(TP, dtype), tp_scalar=on(tp_scalar, dtype),
        valid=on(valid, torch.bool), dL=on(dL, torch.int64), dM=on(dM, torch.int64),
        uS=on(uS, torch.int64), mS=on(mS, torch.int64),
        x=on(x, torch.int32), y=on(y, torch.int32),
        start=on(start, dtype), end=on(end, dtype),
        last_real=on(np.arange(Dp) == D - 1, torch.bool),
        aux=_aux_grids(sm, x_idx, y_idx, dtype, device))


def lanes(inp: EngineInputs) -> Lanes:
    """The reference-band problem with its classes on the middle axis (views)."""
    return Lanes(inp.E.permute(0, 2, 1), inp.TP.permute(0, 2, 1), inp.tp_scalar, inp.valid,
                 inp.dL, inp.dM, inp.uS, inp.mS, inp.last_real, inp.start, inp.end)


def to_lanes(T: torch.Tensor) -> torch.Tensor:
    """(D, W, S) <-> (D, S, W): F, B between the JAX shape and the lanes."""
    return T.permute(0, 2, 1)


# ---------------------------------------------------------------------------
# The recursion, in lanes: F and B as (D, S, W)
# ---------------------------------------------------------------------------

def edge_add(plan: EnginePlan, ln: Lanes, lo: int, hi: int) -> torch.Tensor:
    """(hi-lo, n_edges, W): each edge's emission plus its transition term
    (scalars, then per-cell terms) at the cells of rows lo..hi-1."""
    E, TP = ln.E[lo:hi], ln.TP[lo:hi]
    out = torch.empty((hi - lo, len(plan.edges), E.shape[2]), dtype=E.dtype, device=E.device)
    for i, e in enumerate(plan.edges):
        tp = None
        for s in e.scalar_ids:
            tp = ln.tp_scalar[s] if tp is None else tp + ln.tp_scalar[s]
        for c in e.cell_ids:
            tp = TP[:, c] if tp is None else tp + TP[:, c]
        out[:, i] = E[:, e.eclass] if tp is None else E[:, e.eclass] + tp
    return out


def _slots(plan: EnginePlan, key: str) -> np.ndarray:
    """(S, K) edge index per slot: the edges into (``key="to"``) or out of
    (``"frm"``) each state in plan order, -1 padded."""
    groups = [[i for i, e in enumerate(plan.edges) if getattr(e, key) == s]
              for s in range(plan.n_states)]
    slots = np.full((plan.n_states, max(1, max(map(len, groups)))), -1, dtype=np.int64)
    for s, g in enumerate(groups):
        slots[s, :len(g)] = g
    return slots


def _slot_fields(plan: EnginePlan, slots: np.ndarray, device):
    """Per slot: edge (padded slots edge 0), src, the state read (frm in the
    forward, to in the backward: filled by the caller) and the padding mask."""
    edge = np.maximum(slots, 0)
    src = np.array([[plan.edges[e].src for e in row] for row in edge])
    frm = np.array([[plan.edges[e].frm for e in row] for row in edge])
    to = np.array([[plan.edges[e].to for e in row] for row in edge])

    def on(a, dt=torch.int64):
        return torch.as_tensor(a, dtype=dt, device=device)
    return on(edge), on(src), on(frm), on(to), on(slots < 0, torch.bool)


def _gather_table(plan, ln, slots, d0: int, d1: int, backward: bool):
    """Flat source indices (n, S*K*W) into the (D*S*W + 1) buffer (the last
    element -inf) and edge terms (n, S*K*W) of diagonals d0..d1-1."""
    D, W = ln.valid.shape
    S = plan.n_states
    dev = ln.valid.device
    edge, src, frm, to, pad = _slot_fields(plan, slots, dev)
    d = torch.arange(d0, d1, device=dev)[:, None, None]
    k = torch.arange(W, device=dev)
    mid, up = src == SRC_MIDDLE, (src == SRC_UPPER).long()
    if backward:
        row = d + torch.where(mid, 2, 1)
        sh = torch.where(mid, ln.bM[d0:d1, None, None], ln.bL[d0:d1, None, None] - up)
        state, row_ok = to, row <= D - 1
    else:
        row = d - torch.where(mid, 2, 1)
        sh = torch.where(mid, ln.fM[d0:d1, None, None], ln.fL[d0:d1, None, None] + up)
        state, row_ok = frm, row >= 0
    col = k + sh[..., None]                                       # (n, S, K, W)
    ok = (col >= 0) & (col < W) & (row_ok & ~pad)[..., None]
    idx = torch.where(ok, (row * S + state)[..., None] * W + col, D * S * W)
    # edge terms: the current cell's in the forward, the to-cell's (shifted,
    # on diag d+1 or d+2) in the backward
    if backward:
        lo, hi = d0 + 1, min(d1 + 2, D + 1)
        ea = edge_add(plan, ln, lo, hi)
        n_e = len(plan.edges)
        flat = ((row.clamp(max=hi - 1) - lo) * n_e + edge)[..., None] * W + col.clamp(0, W - 1)
        term = ea.reshape(-1)[flat]
    else:
        term = edge_add(plan, ln, d0, d1)[:, edge]                 # (n, S, K, W)
    term = torch.where(ln.valid[d0:d1, None, None, :], term, NEG_INF)
    n = d1 - d0
    return idx.reshape(n, -1), term.reshape(n, -1)


def _fold(val: torch.Tensor, ladd, out: torch.Tensor) -> None:
    """out (S, W) = the logAdd fold of val (S, K, W) over its K slots, in slot
    order."""
    K = val.shape[1]
    if K == 1:
        out.copy_(val[:, 0])
        return
    cur = val[:, 0]
    for j in range(1, K - 1):
        cur = ladd(cur, val[:, j])
    if ladd is logaddexp:
        torch.logaddexp(cur, val[:, K - 1], out=out)
    else:
        out.copy_(ladd(cur, val[:, K - 1]))


def _recursion(plan: EnginePlan, ln: Lanes, backward: bool) -> torch.Tensor:
    D, W = ln.valid.shape
    S = plan.n_states
    buf = torch.full((D * S * W + 1,), NEG_INF, dtype=ln.E.dtype, device=ln.E.device)
    out = buf[:-1].view(D, S, W)
    slots = _slots(plan, "frm" if backward else "to")
    K = slots.shape[1]
    ladd = get_logadd(plan.logadd)
    if backward:
        last = ln.last_real.cpu().numpy()
        out[D - 1] = torch.where(ln.valid[D - 1][None, :] & bool(last[D - 1]),
                                 ln.end[:, None], NEG_INF)
        chunks = [(d0, min(d0 + CHUNK, D - 1)) for d0 in range(0, D - 1, CHUNK)][::-1]
    else:
        out[0] = torch.where(ln.valid[0][None, :], ln.start[:, None], NEG_INF)
        chunks = [(d0, min(d0 + CHUNK, D)) for d0 in range(1, D, CHUNK)]
    for d0, d1 in chunks:
        idx, term = _gather_table(plan, ln, slots, d0, d1, backward)
        order = range(d1 - d0 - 1, -1, -1) if backward else range(d1 - d0)
        for i in order:
            d = d0 + i
            if backward and last[d]:
                out[d] = torch.where(ln.valid[d][None, :], ln.end[:, None], NEG_INF)
                continue
            _fold(buf.index_select(0, idx[i]).add_(term[i]).view(S, K, W), ladd, out[d])
    return out


def forward_lanes(plan: EnginePlan, ln: Lanes) -> torch.Tensor:
    """Banded forward pass -> F (D, S, W)."""
    return _recursion(plan, ln, backward=False)


def backward_lanes(plan: EnginePlan, ln: Lanes) -> torch.Tensor:
    """Banded backward pass -> B (D, S, W); the end probabilities are
    injected at the ``last_real`` diagonal, so trailing padded diagonals are
    transparent."""
    return _recursion(plan, ln, backward=True)


def shifted_rows(V: torch.Tensor, shift: torch.Tensor, back: int, lo: int, hi: int,
                 fill: float = NEG_INF) -> torch.Tensor:
    """Rows d in lo..hi-1 of V (D, ..., W) read at V[d - back] lane k +
    shift[d] (``fill`` where that lane is off the window or d < back)."""
    W = V.shape[-1]
    d = torch.arange(lo, hi, device=V.device)
    col = torch.arange(W, device=V.device) + shift[lo:hi, None]        # (n, W)
    ok = (col >= 0) & (col < W) & (d >= back)[:, None]
    src = V[(d - back).clamp(min=0)]                                    # (n, ..., W)
    view = (len(d),) + (1,) * (V.dim() - 2) + (W,)
    g = torch.gather(src, -1, col.clamp(0, W - 1).view(view).expand_as(src))
    return torch.where(ok.view(view), g, fill)


def totals_lanes(plan: EnginePlan, ln: Lanes, F: torch.Tensor, B: torch.Tensor
                 ) -> torch.Tensor:
    """Per-diagonal totals with the match-through-diagonal correction
    (diagonalCalculationTotalProbability, pairwiseAligner.c:736-754): at
    diagonal d, F[d-1] extended by the MIDDLE edges onto diag d+1's cells,
    dotted with B[d+1]."""
    D, W = ln.valid.shape
    S = plan.n_states
    vmask = torch.where(ln.valid, 0.0, NEG_INF).to(F.dtype)[:, None, :]
    t1 = torch.logsumexp((F + B + vmask).reshape(D, -1), dim=1)
    if D <= 2:
        return t1
    mids = [(i, e) for i, e in enumerate(plan.edges) if e.src == SRC_MIDDLE]
    t2 = []
    for lo in range(1, D - 1, CHUNK):
        hi = min(lo + CHUNK, D - 1)
        ea = edge_add(plan, ln, lo + 1, hi + 1)            # emissions at diag d+1
        # F[d-1] on diag d+1's lanes: the middle shift of diag d+1
        prev = shifted_rows(F, ln.fM[1:], 1, lo, hi)        # fM[d+1] for row d
        c = torch.full((hi - lo, S, W), NEG_INF, dtype=F.dtype, device=F.device)
        for i, e in mids:
            val = prev[:, e.frm] + ea[:, i]
            c[:, e.to] = torch.logaddexp(c[:, e.to], val)
        c = torch.where(ln.valid[lo + 1:hi + 1, None, :], c, NEG_INF)
        t2.append(torch.logsumexp((c + B[lo + 1:hi + 1] + vmask[lo + 1:hi + 1])
                                  .reshape(hi - lo, -1), dim=1))
    totals = t1.clone()
    totals[1:D - 1] = torch.logaddexp(t1[1:D - 1], torch.cat(t2))
    return totals


def _final_totals(totals: torch.Tensor, last_real: torch.Tensor) -> torch.Tensor:
    """Every diagonal's total replaced by the last real diagonal's."""
    last_total = torch.where(last_real, totals, 0.0).sum()
    return torch.full_like(totals, float(last_total))


def match_probs_lanes(plan: EnginePlan, ln: Lanes, F, B, x, y, total_mode: str):
    """Posterior match probabilities (D, W) and the totals used."""
    totals = totals_lanes(plan, ln, F, B)
    if total_mode == "final":
        totals = _final_totals(totals, ln.last_real)
    m = plan.match_state
    p = torch.exp(F[:, m] + B[:, m] - totals[:, None])
    ok = ln.valid & (x > 0) & (y > 0)
    return torch.where(ok, torch.clamp(p, max=1.0), 0.0), totals


# ---------------------------------------------------------------------------
# The public API, in the JAX shapes
# ---------------------------------------------------------------------------

def forward(plan: EnginePlan, inp: EngineInputs) -> torch.Tensor:
    """Banded forward pass -> F (D, W, S) log-probabilities."""
    return to_lanes(forward_lanes(plan, lanes(inp)))


def backward(plan: EnginePlan, inp: EngineInputs) -> torch.Tensor:
    """Banded backward pass -> B (D, W, S)."""
    return to_lanes(backward_lanes(plan, lanes(inp)))


def diagonal_totals(plan: EnginePlan, inp: EngineInputs, F, B) -> torch.Tensor:
    """Per-diagonal total probability incl. the match-through-diagonal
    correction -> (D,)."""
    return totals_lanes(plan, lanes(inp), to_lanes(F), to_lanes(B))


def posterior_match_probs(plan: EnginePlan, inp: EngineInputs, F, B,
                          total_mode: str = "per_diagonal"):
    """Posterior match probabilities per band cell -> ((D, W), totals), zero
    where invalid or x == 0 or y == 0 (diagonalCalculationPosteriorMatchProbs,
    pairwiseAligner.c:756-795); ``total_mode="final"`` divides by the last
    real diagonal's total."""
    return match_probs_lanes(plan, lanes(inp), to_lanes(F), to_lanes(B), inp.x, inp.y,
                             total_mode)


def posterior_multi_match_probs(plan: EnginePlan, inp: EngineInputs, F, B,
                                n_match_states: int = 6):
    """Echelon posterior extraction (diagonalCalculationMultiPosteriorMatch-
    Probs, pairwiseAligner.c:797-839): per-cell posteriors (n, D, W) of every
    match state s in [match_state, n_match_states); state s contributes
    pairs (x+n-1, y-1) for n in 0..s-1 on the host side."""
    Fl, Bl = to_lanes(F), to_lanes(B)
    totals = totals_lanes(plan, lanes(inp), Fl, Bl)
    ss = list(range(plan.match_state, n_match_states))
    p = torch.exp(Fl[:, ss] + Bl[:, ss] - totals[:, None, None]).permute(1, 0, 2)
    ok = inp.valid & (inp.x > 0) & (inp.y > 0)
    return torch.where(ok[None], torch.clamp(p, max=1.0), 0.0), totals


def extract_multi_pairs(p_states: np.ndarray, x: np.ndarray, y: np.ndarray,
                        threshold: float, match_state: int = 1):
    """Host-side pair emission for the multi-state posteriors."""
    probs, xs, ys = [], [], []
    for si in range(p_states.shape[0]):
        s = match_state + si
        mask = p_states[si] >= threshold
        if not mask.any():
            continue
        pq = np.floor(p_states[si][mask] * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
        cx = x[mask].astype(np.int64)
        cy = y[mask].astype(np.int64)
        for n in range(s):
            probs.append(pq)
            xs.append(cx + n - 1)
            ys.append(cy - 1)
    if not probs:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    return (np.concatenate(probs), np.concatenate(xs), np.concatenate(ys))
