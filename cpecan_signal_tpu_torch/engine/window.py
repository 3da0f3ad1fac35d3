"""The constant-shift window layout (port of ``cpecan_signal_tpu/engine/window.py``).

Host half: the window's cell grids, its per-diagonal shift scalars, and a
state machine's emission and per-cell transition grids over the window, all
numpy (``window_grids`` :76-85, ``shift_scalars`` :88-99,
``prepare_window_inputs`` :102-149 without the device arrays and the
``aux`` dict); the device kernels' packing reads them.  Scan half (below):
the window-layout forward-backward on torch, the window layout's oracle.
The window covers the band with W lanes whose left edge moves by exactly
+-1 in xmy per diagonal (core/window.py); cells outside the true band are
masked.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.window import WindowBand
from ..models.state_machines import StateMachine
from .expectations import threestate_lanes
from .fb import (Lanes, _aux_grids, backward_lanes, forward_lanes, match_probs_lanes,
                 totals_lanes)
from .plan import EnginePlan, _build_plan


class WindowInputs(NamedTuple):
    """Host grids of one window-banded problem (f64)."""

    E: np.ndarray          # (D+1, C, W) emissions; out-of-band cells 0.0
    TP: np.ndarray         # (D+1, T, W) per-cell transition terms
    tp_scalar: np.ndarray  # (n,) scalar transition terms
    start: np.ndarray      # (S,)
    end: np.ndarray        # (S,)


def window_grids(wband: WindowBand):
    """(D, W) x/y/valid grids for the window (host-side numpy)."""
    D, W = wband.n_diagonals, wband.W
    d_grid = np.arange(D)[:, None]
    j_grid = np.arange(W)[None, :]
    xmy = wband.w0[:, None] + 2 * j_grid
    x = (d_grid + xmy) // 2
    y = (d_grid - xmy) // 2
    valid = (xmy >= wband.xmyL[:, None]) & (xmy <= wband.xmyR[:, None])
    return x, y, valid


def shift_scalars(w0: np.ndarray):
    """Per-diagonal lane shifts (fL, fM, bL, bM), int32 (D,): the forward
    lower source F[d-1] sits at j + fL[d], the middle source F[d-2] at
    j + fM[d]; the backward diagonal d+1 at j + bL[d], d+2 at j + bM[d]."""
    D = len(w0)
    fL = np.zeros(D, dtype=np.int32)
    fM = np.zeros(D, dtype=np.int32)
    bL = np.zeros(D, dtype=np.int32)
    bM = np.zeros(D, dtype=np.int32)
    fL[1:] = (w0[1:] - 1 - w0[:-1]) // 2
    fM[2:] = (w0[2:] - w0[:-2]) // 2
    bL[:-1] = (w0[:-1] + 1 - w0[1:]) // 2
    bM[:-2] = (w0[:-2] - w0[2:]) // 2
    return fL, fM, bL, bM


def prepare_window_inputs(sm: StateMachine, wband: WindowBand, *,
                          ragged_left: bool, ragged_right: bool
                          ) -> tuple[EnginePlan, WindowInputs]:
    """The machine's plan and its window grids: emissions of every class at
    every window cell (0.0 outside the true band), the per-cell transition
    sources gathered per x or per y, the scalar terms and the start/end
    vectors (ragged or not)."""
    D, W = wband.n_diagonals, wband.W
    x, y, valid = window_grids(wband)
    x_idx = np.clip(x - 1, -1, max(wband.lX - 1, -1))
    y_idx = np.clip(y - 1, -1, max(wband.lY - 1, -1))

    # emissions are evaluated at the true band's cells only (about 30 % of
    # the window for the CLIs' unsplit jobs: the window also covers the
    # band's drift); every other cell is 0.0
    C = sm.spec.n_eclasses
    E = np.zeros((D + 1, C, W), dtype=np.float64)
    dv, jv = np.nonzero(valid)
    E[dv, :, jv] = sm.emissions(x_idx[dv, jv], y_idx[dv, jv])

    plan, tp_scalar, cell_sources = _build_plan(sm, "exact")
    TP = np.zeros((D + 1, len(cell_sources), W), dtype=np.float64)
    for t, (kind, arr) in enumerate(cell_sources):
        TP[:D, t, :] = arr[x_idx + 1] if kind == "x" else arr[y_idx + 1]

    start = np.asarray(sm.ragged_start if ragged_left else sm.start, dtype=np.float64)
    end = np.asarray(sm.ragged_end if ragged_right else sm.end, dtype=np.float64)
    return plan, WindowInputs(E, TP, tp_scalar, start, end)


# ---------------------------------------------------------------------------
# The scan half: the window-layout forward-backward on torch (port of
# engine/window.py:152-342), f32 or f64 with exact logadd.  The window is
# the fb engine's recursion with its lane shifts in {-1, 0, +1}: the same
# lanes code (engine/fb.py) runs it, F and B as (D, S, W).
# ---------------------------------------------------------------------------

class WindowScanInputs(NamedTuple):
    """Tensors of one window-banded problem, all on one device."""

    E: torch.Tensor          # (D+1, C, W) emissions
    TP: torch.Tensor         # (D+1, T, W) per-cell transition terms
    tp_scalar: torch.Tensor
    valid: torch.Tensor      # (D, W) true-band membership
    fL: torch.Tensor         # (D,) int64 forward lower shift in {-1, 0}
    fM: torch.Tensor         # (D,) forward middle shift in {-1, 0, +1}
    bL: torch.Tensor         # (D,) backward diag+1 shift in {0, +1}
    bM: torch.Tensor         # (D,) backward diag+2 shift in {-1, 0, +1}
    x: torch.Tensor          # (D, W) int32
    y: torch.Tensor
    start: torch.Tensor      # (S,)
    end: torch.Tensor
    last_real: torch.Tensor  # (D,) bool
    aux: dict


def window_scan_inputs(sm: StateMachine, wband: WindowBand, *, ragged_left: bool,
                       ragged_right: bool, device: torch.device, dtype=torch.float64
                       ) -> tuple[EnginePlan, WindowScanInputs]:
    """The host grids of ``prepare_window_inputs`` with the window's cell
    grids, shift scalars and EM grids, as tensors on ``device``."""
    plan, host = prepare_window_inputs(sm, wband, ragged_left=ragged_left,
                                       ragged_right=ragged_right)
    x, y, valid = window_grids(wband)
    x_idx = np.clip(x - 1, -1, max(wband.lX - 1, -1))
    y_idx = np.clip(y - 1, -1, max(wband.lY - 1, -1))
    shifts = [torch.as_tensor(s, dtype=torch.int64, device=device)
              for s in shift_scalars(wband.w0)]

    def on(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    D = wband.n_diagonals
    return plan, WindowScanInputs(
        on(host.E, dtype), on(host.TP, dtype), on(host.tp_scalar, dtype),
        on(valid, torch.bool), *shifts, on(x, torch.int32), on(y, torch.int32),
        on(host.start, dtype), on(host.end, dtype), on(np.arange(D) == D - 1, torch.bool),
        _aux_grids(sm, x_idx, y_idx, dtype, device))


def _lanes(inp: WindowScanInputs):
    return Lanes(inp.E, inp.TP, inp.tp_scalar, inp.valid, inp.fL, inp.fM, inp.bL, inp.bM,
                 inp.last_real, inp.start, inp.end)


def forward(plan: EnginePlan, inp: WindowScanInputs) -> torch.Tensor:
    """Forward pass -> F (D, S, W)."""
    return forward_lanes(plan, _lanes(inp))


def backward(plan: EnginePlan, inp: WindowScanInputs) -> torch.Tensor:
    """Backward pass -> B (D, S, W); end probabilities injected at last_real."""
    return backward_lanes(plan, _lanes(inp))


def diagonal_totals(plan: EnginePlan, inp: WindowScanInputs, F, B) -> torch.Tensor:
    """Per-diagonal totals with the match-through-diagonal correction
    (diagonalCalculationTotalProbability, pairwiseAligner.c:736-754)."""
    return totals_lanes(plan, _lanes(inp), F, B)


def posterior_match_probs(plan: EnginePlan, inp: WindowScanInputs, F, B,
                          total_mode: str = "per_diagonal"):
    """Posterior match probabilities (D, W) and the totals used."""
    return match_probs_lanes(plan, _lanes(inp), F, B, inp.x, inp.y, total_mode)


def threestate_expectations(plan: EnginePlan, inp: WindowScanInputs, F, B):
    """threeState EM tallies in the window layout: transitions, per-kmer gapX
    tallies and the likelihood."""
    return threestate_lanes(plan, _lanes(inp), F, B, inp.aux["rank"])
