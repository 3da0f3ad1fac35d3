"""Anchors, splits and bands of the pair HMMs, worked out again from the
inputs: frozen copies of the rules of cPecan's pairwiseAligner.c that the
port's ``core/anchors.py`` and ``core/band.py`` follow
(filterToRemoveOverlap :1160-1200, the CIGAR to anchor conversion
:1039-1063, getSplitPoints :1289-1340, the sub-anchor selection
:1389-1402, band_construct :98-184).  NumPy only; nothing here is the
program's.
"""

from __future__ import annotations

import math

import numpy as np


def filter_to_remove_overlap(pairs: np.ndarray) -> np.ndarray:
    """The strictly increasing chain kept from (x, y)-sorted pairs: a pair
    survives that lies below every later pair on both axes and above every
    earlier pair on both axes (by value, as the two-pass C filter does)."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return pairs
    x, y = pairs[:, 0], pairs[:, 1]
    big = np.iinfo(np.int64).max
    sx = np.minimum.accumulate(np.concatenate([x[1:], [big]])[::-1])[::-1]
    sy = np.minimum.accumulate(np.concatenate([y[1:], [big]])[::-1])[::-1]
    back = (x < sx) & (y < sy)
    small = np.iinfo(np.int64).min
    px = np.maximum.accumulate(np.concatenate([[small], x[:-1]]))
    py = np.maximum.accumulate(np.concatenate([[small], y[:-1]]))
    key = x * (int(y.max()) + 1) + y
    keep = (x > px) & (y > py) & np.isin(key, key[back])
    return pairs[keep]


def cigar_anchor_pairs(start1: int, start2: int, ops, trim: int) -> np.ndarray:
    """(x, y) pairs of the CIGAR's match runs, ``trim`` dropped at each end of
    every run; D steps x, I steps y."""
    j, k = start1, start2
    out = []
    for op, n in ops:
        if op == "M":
            if n > 2 * trim:
                r = np.arange(trim, n - trim, dtype=np.int64)
                out.append(np.stack([j + r, k + r], axis=1))
            j += n
            k += n
        elif op == "D":
            j += n
        elif op == "I":
            k += n
        else:
            raise ValueError(f"unknown CIGAR op {op!r}")
    return np.concatenate(out) if out else np.zeros((0, 2), dtype=np.int64)


def sorted_chain(pairs: np.ndarray) -> np.ndarray:
    if len(pairs) == 0:
        return pairs
    return filter_to_remove_overlap(pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))])


def split_points(anchors: np.ndarray, lX: int, lY: int, cap: int, ragged_left: bool,
                 ragged_right: bool) -> list[tuple[int, int, int, int]]:
    """Sub-rectangles (x1, y1, x2, y2): a gap between anchors whose rectangle
    exceeds ``cap`` cells is cut, its middle left out."""
    out = []
    x1 = y1 = x2 = y2 = 0

    def check(x3, y3, skip):
        nonlocal x1, y1
        gx, gy = x3 - x2, y3 - y2
        if gx * gy > cap:
            m = int(math.sqrt(cap))
            hx, hy = min(gx // 2, m), min(gy // 2, m)
            if not skip:
                out.append((x1, y1, x2 + hx, y2 + hy))
            x1, y1 = x3 - hx, y3 - hy
            return True
        return False

    for i, (x3, y3) in enumerate(np.asarray(anchors, dtype=np.int64).reshape(-1, 2).tolist()):
        check(x3, y3, ragged_left and i == 0)
        x2, y2 = x3 + 1, y3 + 1
    split = check(lX, lY, ragged_left and len(anchors) == 0)
    if not split or not ragged_right:
        out.append((x1, y1, lX, lY))
    return out


def anchors_in(anchors: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> np.ndarray:
    s = anchors.sum(axis=1)
    sub = anchors[(s >= x1 + y1) & (s < x2 + y2)].copy()
    sub[:, 0] -= x1
    sub[:, 1] -= y1
    return sub


def band(anchors: np.ndarray, lX: int, lY: int, expansion: int):
    """(xmyL, xmyR) per anti-diagonal 0..lX+lY: the cells x - y of the band
    +-``expansion`` around the chain (0,0) -> anchors + 1 -> (lX, lY), with
    the C code's parity fix and corner bounds."""
    a = np.asarray(anchors, dtype=np.int64).reshape(-1, 2)
    cx = np.concatenate([[0], a[:, 0] + 1, [lX]])
    cy = np.concatenate([[0], a[:, 1] + 1, [lY]])
    ps, pd = (cx + cy)[:-1], (cx - cy)[:-1]
    ns, nd = (cx + cy)[1:], (cx - cy)[1:]
    xLs = np.clip((ps + pd - expansion) // 2, 0, lX)
    yLs = np.clip((ns - nd + expansion) // 2, 0, lY)
    xUs = np.clip((ns + nd + expansion) // 2, 0, lX)
    yUs = np.clip((ps - pd - expansion) // 2, 0, lY)
    seg = np.repeat(np.arange(len(ns)), ns - ps)
    d = np.arange(1, lX + lY + 1, dtype=np.int64)
    xL, yL, xU, yU = xLs[seg], yLs[seg], xUs[seg], yUs[seg]
    L = xL - yL
    R = xU - yU
    L = L + ((d + L) & 1)
    R = R + ((d + R) & 1)
    L = L + 2 * np.maximum(xL - (d + L) // 2, 0)
    L = L + 2 * np.maximum((d - L) // 2 - yL, 0)
    R = R - 2 * np.maximum((d + R) // 2 - xU, 0)
    R = R - 2 * np.maximum(yU - (d - R) // 2, 0)
    if (L > R).any():
        raise ValueError("empty band diagonal")
    return np.concatenate([[0], L]), np.concatenate([[0], R])
