"""Smoothed constant-step band windows.

The reference band's per-diagonal [xmyL, xmyR] limits move arbitrarily (within
parity), which forces dynamic gathers in a vectorized wavefront.  A *window* is
a covering band of constant width W whose left edge moves by exactly +-1 in xmy
per diagonal — the TPU layout contract: every neighbor access becomes a static
lane shift selected by one scalar per diagonal, and true-band semantics are
preserved by masking cells outside [xmyL, xmyR] (they stay LOG_ZERO exactly as
in the reference engine).

Feasibility: the window left edge w0 must satisfy, per diagonal,
    xmyR[d] - 2(W-1) <= w0[d] <= xmyL[d]
with |w0[d+1] - w0[d]| = 1.  A backward reachability sweep intersects the
constraint intervals with the +-1-step cone; if empty, W is increased.  A
forward greedy pass then picks w0 tracking the band center.

Copied from ``cpecan_signal_tpu/core/window.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .band import Band


class WindowBand(NamedTuple):
    lX: int
    lY: int
    W: int
    w0: np.ndarray     # (D,) leftmost covered xmy per diagonal; steps +-1
    xmyL: np.ndarray   # (D,) true band limits (masking)
    xmyR: np.ndarray

    @property
    def n_diagonals(self) -> int:
        return len(self.w0)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smooth_band(band: Band, width_multiple: int = 8,
                min_width: int | None = None) -> WindowBand:
    """Compute a feasible constant-step window covering ``band``.

    Vectorized in "u-space": with u = (d + w0)/2 (exact — (d + w0) is always
    even by xmy parity), the exact +-1 xmy steps become nondecreasing integer
    steps in {0, 1}, and the constraint xmyR - 2(W-1) <= w0 <= xmyL becomes
    Ulo <= u <= Uhi.  Backward reachability is then two suffix scans
      B[d] = min_{j>=d} Uhi[j]                (nondecreasing in d)
      A[d] = max_{j>=d} (Ulo[j] - (j - d))    (A[d+1] <= A[d] + 1)
    and u = prefix_max(A) is a valid path: it is nondecreasing, steps by at
    most 1 (since A[d+1] <= A[d] + 1), and stays <= B because B is
    nondecreasing and A <= B everywhere when feasible."""
    D = band.n_diagonals
    xmyL = band.xmyL.astype(np.int64)
    xmyR = band.xmyR.astype(np.int64)
    W = _round_up(max(int(band.max_width), min_width or 1), width_multiple)

    d = np.arange(D, dtype=np.int64)
    Uhi = (d + xmyL) >> 1
    base_lo = (d + xmyR) >> 1
    while True:
        Ulo = base_lo - (W - 1)
        B = np.minimum.accumulate(Uhi[::-1])[::-1]
        A = np.maximum.accumulate((Ulo - d)[::-1])[::-1] + d
        if (A <= B).all():
            break
        W += width_multiple

    u = np.maximum.accumulate(A)
    w0 = 2 * u - d
    # coverage + parity checks (cheap, vectorized)
    assert ((w0 <= xmyL) & (w0 >= xmyR - 2 * (W - 1))).all()
    assert ((d + w0) % 2 == (d + xmyL) % 2).all()
    return WindowBand(lX=band.lX, lY=band.lY, W=W, w0=w0, xmyL=xmyL, xmyR=xmyR)
