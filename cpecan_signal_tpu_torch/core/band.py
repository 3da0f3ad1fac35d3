"""Anti-diagonal band geometry.

Coordinate system (pairwiseAligner.c:28-227): a DP cell (x, y) with
x in [0, lX], y in [0, lY] lives on anti-diagonal ``xay = x + y`` at offset
``xmy = x - y``; valid cells on a diagonal step xmy by 2.  A Band precomputes,
for every diagonal, the inclusive [xmyL, xmyR] limits from the anchor chain
+- ``expansion`` cells, including the reference's parity ("avoid off-by-one")
and coordinate-bounding corrections (band_construct, pairwiseAligner.c:98-184).

This is host-side NumPy: the engine consumes the produced arrays
(xmyL, width per diagonal) as static inputs of the jitted DP.

Copied from ``cpecan_signal_tpu/core/band.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _avoid_off_by_one(xay: int, xmy: int) -> int:
    return xmy if (xay + xmy) % 2 == 0 else xmy + 1


def _x_of(xay: int, xmy: int) -> int:
    return (xay + xmy) // 2


def _y_of(xay: int, xmy: int) -> int:
    return (xay - xmy) // 2


def _bound(z: int, l: int) -> int:
    return 0 if z < 0 else (l if z > l else z)


@dataclass(frozen=True)
class Band:
    """Per-diagonal band limits; diagonals indexed 0..lX+lY inclusive."""

    lX: int
    lY: int
    xmyL: np.ndarray  # int64[lX+lY+1]
    xmyR: np.ndarray  # int64[lX+lY+1]

    @property
    def n_diagonals(self) -> int:
        return self.lX + self.lY + 1

    @property
    def widths(self) -> np.ndarray:
        return (self.xmyR - self.xmyL) // 2 + 1

    @property
    def max_width(self) -> int:
        return int(self.widths.max())


def _set_current_diagonal(xay: int, xL: int, yL: int, xU: int, yU: int) -> tuple[int, int]:
    """One diagonal's [xmyL, xmyR] from the current band-segment corners
    (band_setCurrentDiagonal, pairwiseAligner.c:108-126)."""
    xmyL = xL - yL
    xmyR = xU - yU
    xmyL = _avoid_off_by_one(xay, xmyL)
    xmyR = _avoid_off_by_one(xay, xmyR)
    # Bound by the (xL, yL) / (xU, yU) corners.
    if _x_of(xay, xmyL) < xL:
        xmyL += 2 * (xL - _x_of(xay, xmyL))
    if yL < _y_of(xay, xmyL):
        xmyL += 2 * (_y_of(xay, xmyL) - yL)
    if xU < _x_of(xay, xmyR):
        xmyR -= 2 * (_x_of(xay, xmyR) - xU)
    if _y_of(xay, xmyR) < yU:
        xmyR -= 2 * (yU - _y_of(xay, xmyR))
    if xmyL > xmyR or (xay + xmyL) % 2 != 0 or (xay + xmyR) % 2 != 0:
        raise ValueError(f"invalid diagonal xay={xay} xmyL={xmyL} xmyR={xmyR}")
    return xmyL, xmyR


def _band_construct_loop(anchor_pairs: np.ndarray | list, lX: int, lY: int,
                         expansion: int) -> Band:
    """Reference per-diagonal loop (kept as the differential-test oracle for
    the vectorized band_construct below)."""
    assert lX >= 0 and lY >= 0 and expansion % 2 == 0
    anchors = np.asarray(anchor_pairs, dtype=np.int64).reshape(-1, 2)
    n_diag = lX + lY + 1
    xmyL = np.zeros(n_diag, dtype=np.int64)
    xmyR = np.zeros(n_diag, dtype=np.int64)

    anchor_idx = 0
    xay = 0
    pxay = pxmy = 0
    nxay = nxmy = 0
    xL = yL = xU = yU = 0
    while xay <= lX + lY:
        xmyL[xay], xmyR[xay] = _set_current_diagonal(xay, xL, yL, xU, yU)
        advance = nxay == xay
        xay += 1
        if advance:
            pxay, pxmy = nxay, nxmy
            if anchor_idx < len(anchors):
                # +1: matrix coordinates are sequence coordinates + 1
                x = int(anchors[anchor_idx, 0]) + 1
                y = int(anchors[anchor_idx, 1]) + 1
                anchor_idx += 1
                assert x > _x_of(pxay, pxmy) and y > _y_of(pxay, pxmy)
                assert 0 < x <= lX and 0 < y <= lY
            else:
                x, y = lX, lY
            nxay = x + y
            nxmy = x - y
            xL = _bound(_x_of(pxay, pxmy - expansion), lX)
            yL = _bound(_y_of(nxay, nxmy - expansion), lY)
            xU = _bound(_x_of(nxay, nxmy + expansion), lX)
            yU = _bound(_y_of(pxay, pxmy + expansion), lY)
    return Band(lX=lX, lY=lY, xmyL=xmyL, xmyR=xmyR)


def band_construct(anchor_pairs: np.ndarray | list, lX: int, lY: int, expansion: int) -> Band:
    """Build the band from anchors (sequence coordinates, strictly increasing in
    both axes) with +-expansion cells around the anchor path.

    Exact reimplementation of band_construct (pairwiseAligner.c:132-184):
    between consecutive anchors (px, py) -> (nx, ny) (in matrix coordinates,
    i.e. sequence + 1) the band segment corners are
      xL = bound(x(pxay, pxmy - e)), yL = bound(y(nxay, nxmy - e)),
      xU = bound(x(nxay, nxmy + e)), yU = bound(y(pxay, pxmy + e)).

    Fully vectorized (the per-diagonal loop cost dominated host prep on long
    reads): diagonal d in (pxay, nxay] of chain segment i gets segment i's
    corners; the parity fix and the four corner-bounding corrections of
    band_setCurrentDiagonal (pairwiseAligner.c:108-126) are applied in the
    reference's sequential order as elementwise passes.  Differentially
    tested against _band_construct_loop (tests/test_core.py).
    """
    assert lX >= 0 and lY >= 0 and expansion % 2 == 0
    anchors = np.asarray(anchor_pairs, dtype=np.int64).reshape(-1, 2)
    if len(anchors):
        ax, ay = anchors[:, 0], anchors[:, 1]
        assert (ax >= 0).all() and (ay >= 0).all(), "negative anchor"
        assert (ax < lX).all() and (ay < lY).all(), "anchor out of range"
        assert ((ax[1:] > ax[:-1]) & (ay[1:] > ay[:-1])).all(), \
            "anchors must strictly increase in both axes"

    # chain of matrix-coordinate points: (0,0) -> anchors+1 -> (lX, lY)
    cx = np.concatenate([[0], anchors[:, 0] + 1, [lX]])
    cy = np.concatenate([[0], anchors[:, 1] + 1, [lY]])
    pxay, pxmy = (cx + cy)[:-1], (cx - cy)[:-1]
    nxay, nxmy = (cx + cy)[1:], (cx - cy)[1:]

    bound = lambda z, l: np.clip(z, 0, l)
    xLs = bound((pxay + pxmy - expansion) // 2, lX)
    yLs = bound((nxay - nxmy + expansion) // 2, lY)
    xUs = bound((nxay + nxmy + expansion) // 2, lX)
    yUs = bound((pxay - pxmy - expansion) // 2, lY)

    n_diag = lX + lY + 1
    counts = nxay - pxay                       # telescoping: sums to lX + lY
    seg = np.repeat(np.arange(len(counts)), counts)
    d = np.arange(1, n_diag, dtype=np.int64)
    xL, yL, xU, yU = xLs[seg], yLs[seg], xUs[seg], yUs[seg]

    L = xL - yL
    R = xU - yU
    L = L + ((d + L) & 1)                      # avoid-off-by-one parity fix
    R = R + ((d + R) & 1)
    # sequential corner-bounding corrections (each uses the updated value)
    L = L + 2 * np.maximum(xL - (d + L) // 2, 0)
    L = L + 2 * np.maximum((d - L) // 2 - yL, 0)
    R = R - 2 * np.maximum((d + R) // 2 - xU, 0)
    R = R - 2 * np.maximum(yU - (d - R) // 2, 0)
    if not ((L <= R).all() and (((d + L) % 2) == 0).all()
            and (((d + R) % 2) == 0).all()):
        bad = int(np.flatnonzero((L > R) | ((d + L) % 2 != 0)
                                 | ((d + R) % 2 != 0))[0])
        raise ValueError(
            f"invalid diagonal xay={d[bad]} xmyL={L[bad]} xmyR={R[bad]}")

    xmyL = np.zeros(n_diag, dtype=np.int64)
    xmyR = np.zeros(n_diag, dtype=np.int64)
    xmyL[1:], xmyR[1:] = L, R
    return Band(lX=lX, lY=lY, xmyL=xmyL, xmyR=xmyR)
