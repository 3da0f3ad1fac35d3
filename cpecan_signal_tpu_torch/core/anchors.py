"""Anchor-pair utilities: monotonic-chain filtering, guide-alignment
conversion, event-map remapping, and split-point computation.

Host-side NumPy mirrors of:
  - filterToRemoveOverlap           pairwiseAligner.c:1160-1200
  - convertPairwiseForwardStrandAlignmentToAnchorPairs  pairwiseAligner.c:1039-1063
  - nanopore_remapAnchorPairs[WithOffset]               nanopore.c:202-226
  - getSplitPoints                  pairwiseAligner.c:1289-1340

Copied from ``cpecan_signal_tpu/core/anchors.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


def filter_to_remove_overlap(pairs: np.ndarray) -> np.ndarray:
    """Keep a strictly monotonic chain from sorted-but-overlapping pairs.

    Two-pass filter: backwards, keep pairs strictly below the running minima;
    forwards, emit pairs strictly above the running maxima that survived pass 1.
    Input must be lexicographically sorted (x, then y).
    """
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    n = len(pairs)
    keep_back = np.zeros(n, dtype=bool)
    px = py = np.iinfo(np.int64).max
    for i in range(n - 1, -1, -1):
        x, y = pairs[i]
        if x < px and y < py:
            keep_back[i] = True
        px = min(px, x)
        py = min(py, y)
    out = []
    px = py = np.iinfo(np.int64).min
    back_set = {tuple(p) for p in pairs[keep_back]}
    for x, y in pairs:
        if x > px and y > py and (x, y) in back_set:
            out.append((x, y))
        px = max(px, x)
        py = max(py, y)
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def cigar_to_anchor_pairs(start1: int, start2: int, ops: list[tuple[str, int]],
                          trim: int) -> np.ndarray:
    """Exonerate-CIGAR match blocks -> (x, y) pairs, trimming ``trim`` pairs
    from each end of every match block.

    Op semantics (convertPairwiseForwardStrandAlignmentToAnchorPairs,
    pairwiseAligner.c:1039-1063): 'M' advances both coordinates, 'D' advances
    seq1 only (gap in seq2), 'I' advances seq2 only (gap in seq1).
    """
    j, k = start1, start2
    pairs = []
    for op, length in ops:
        if op == "M":
            for l in range(trim, length - trim):
                pairs.append((j + l, k + l))
            j += length
            k += length
        elif op == "D":
            j += length
        elif op == "I":
            k += length
        else:
            raise ValueError(f"unknown cigar op {op!r}")
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def remap_anchor_pairs(pairs: np.ndarray, event_map: np.ndarray) -> np.ndarray:
    """Map reference-side y coordinates through the 2D-read event map
    (nanopore_remapAnchorPairs, nanopore.c:202-212)."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    out = pairs.copy()
    out[:, 1] = event_map[pairs[:, 1]]
    return out


def remap_anchor_pairs_with_offset(pairs: np.ndarray, event_map: np.ndarray,
                                   map_offset: int) -> np.ndarray:
    """Map reference-side y coordinates through the 2D-read event map, rebased
    to the event index of the guide-alignment start (nanopore.c:214-226)."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    out = pairs.copy()
    out[:, 1] = event_map[pairs[:, 1]] - event_map[map_offset]
    return out


def get_split_points(anchor_pairs: np.ndarray, lX: int, lY: int,
                     split_matrix_bigger_than_this: int,
                     ragged_left: bool, ragged_right: bool,
                     max_gap_min_dim: int | None = None) -> list[tuple[int, int, int, int]]:
    """Split the alignment into sub-rectangles wherever the gap between
    consecutive anchors exceeds the area cap (getSplitPoints,
    pairwiseAligner.c:1289-1340).  Returns [(x1, y1, x2, y2), ...].

    max_gap_min_dim (TPU extension, off by default): additionally split when
    min(gap_x, gap_y) exceeds it.  The banded window's width between two
    distant anchors grows to ~min(gap_x, gap_y) + 2*expansion + 1, so an
    unanchored square transient inflates the static window width W for the
    whole problem (VERDICT r2: the W=512 bucket was 80% masked lanes); the
    width split caps W at ~max_gap_min_dim + 2*expansion + 1 by cutting the
    unanchored middle of the gap exactly like the reference's area split
    (ragged ends, uncovered center)."""
    anchors = np.asarray(anchor_pairs, dtype=np.int64).reshape(-1, 2)
    split_points: list[tuple[int, int, int, int]] = []
    x1 = y1 = 0
    x2 = y2 = 0

    def check_split(x1_, y1_, x3, y3, skip_block):
        nonlocal x1, y1
        lX2 = x3 - x2
        lY2 = y3 - y2
        wide = (max_gap_min_dim is not None
                and min(lX2, lY2) > max_gap_min_dim)
        if lX2 * lY2 > split_matrix_bigger_than_this or wide:
            max_len = int(math.sqrt(split_matrix_bigger_than_this))
            if wide:
                # clamp: a degenerate max_gap_min_dim < 2 must not produce
                # zero-size half-rectangles
                max_len = min(max_len, max(max_gap_min_dim // 2, 1))
            hX = min(lX2 // 2, max_len)
            hY = min(lY2 // 2, max_len)
            if not skip_block:
                split_points.append((x1, y1, x2 + hX, y2 + hY))
            x1 = x3 - hX
            y1 = y3 - hY
            return True
        return False

    for i, (x3, y3) in enumerate(anchors):
        check_split(x1, y1, int(x3), int(y3), ragged_left and i == 0)
        assert x3 >= x2 and y3 >= y2 and x3 < lX and y3 < lY
        x2 = int(x3) + 1
        y2 = int(y3) + 1
    did_split = check_split(x1, y1, lX, lY, ragged_left and len(anchors) == 0)
    if not did_split or not ragged_right:
        split_points.append((x1, y1, lX, lY))
    return split_points


def anchors_in_window(anchors: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> np.ndarray:
    """Anchors with x+y inside [x1+y1, x2+y2), shifted to window coordinates
    (the sub-anchor selection of pairwiseAligner.c:1389-1402)."""
    anchors = np.asarray(anchors, dtype=np.int64).reshape(-1, 2)
    s = anchors.sum(axis=1)
    sel = (s >= x1 + y1) & (s < x2 + y2)
    sub = anchors[sel].copy()
    sub[:, 0] -= x1
    sub[:, 1] -= y1
    return sub
