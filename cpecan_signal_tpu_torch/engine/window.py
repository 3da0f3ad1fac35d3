"""Host half of the constant-shift window layout: the window's cell grids,
its per-diagonal shift scalars, and a state machine's emission and per-cell
transition grids over the window, all numpy.

A jax-free rewrite of ``cpecan_signal_tpu/engine/window.py``:
``window_grids`` (:76-85), ``shift_scalars`` (:88-99) and
``prepare_window_inputs`` (:102-149) without the device arrays and the
``aux`` dict.  The window covers the band with W lanes whose left edge moves
by exactly +-1 in xmy per diagonal (core/window.py); cells outside the true
band are masked by the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.window import WindowBand
from ..models.state_machines import StateMachine
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
