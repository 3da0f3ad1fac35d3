"""Anchor-pair utilities: monotonic-chain filtering, guide-alignment
conversion, event-map remapping, and split-point computation.

Host-side NumPy mirrors of:
  - filterToRemoveOverlap           pairwiseAligner.c:1160-1200
  - convertPairwiseForwardStrandAlignmentToAnchorPairs  pairwiseAligner.c:1039-1063
  - nanopore_remapAnchorPairs[WithOffset]               nanopore.c:202-226
  - getSplitPoints                  pairwiseAligner.c:1289-1340

Copied from ``cpecan_signal_tpu/core/anchors.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.  The
overlap filter, the CIGAR conversion and the split points work on whole
arrays instead of a Python loop an anchor; their results are the same.
"""

from __future__ import annotations

import math

import numpy as np


def filter_to_remove_overlap(pairs: np.ndarray) -> np.ndarray:
    """Keep a strictly monotonic chain from sorted-but-overlapping pairs.

    Two-pass filter: backwards, keep pairs strictly below the running minima;
    forwards, emit pairs strictly above the running maxima that survived pass 1.
    Input must be lexicographically sorted (x, then y).

    Pass 1 is a strict suffix minimum, pass 2 a strict prefix maximum over
    every earlier pair, kept or not; a pair passes pass 1 where any pair of
    the same value does (the reference's set of kept values).
    """
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    x, y = pairs[:, 0].copy(), pairs[:, 1].copy()
    n = len(x)
    big, small = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    after_x, after_y = np.full(n, big), np.full(n, big)      # strict suffix minima
    after_x[:-1] = np.minimum.accumulate(x[::-1])[::-1][1:]
    after_y[:-1] = np.minimum.accumulate(y[::-1])[::-1][1:]
    before_x, before_y = np.full(n, small), np.full(n, small)  # strict prefix maxima
    before_x[1:] = np.maximum.accumulate(x)[:-1]
    before_y[1:] = np.maximum.accumulate(y)[:-1]
    keep_back = (x < after_x) & (y < after_y)
    # a pair counts as kept in pass 1 where any pair of its value is: runs of
    # equal pairs once sorted (the input's own order where it is sorted)
    order = None if _is_sorted(x, y) else np.lexsort((y, x))
    sx, sy, kept = (x, y, keep_back) if order is None else (x[order], y[order], keep_back[order])
    new_run = np.ones(n, dtype=bool)
    new_run[1:] = (sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1])
    run = np.cumsum(new_run) - 1
    run_kept = np.zeros(n, dtype=bool)
    run_kept[run[kept]] = True
    in_back = run_kept[run]
    if order is not None:
        in_back[order] = in_back.copy()
    keep = in_back & (x > before_x) & (y > before_y)
    return pairs[np.flatnonzero(keep)]


def _is_sorted(x: np.ndarray, y: np.ndarray) -> bool:
    """Whether the pairs (x, y) are in lexicographic (x, then y) order."""
    return bool(((x[1:] > x[:-1]) | ((x[1:] == x[:-1]) & (y[1:] >= y[:-1]))).all())


def cigar_to_anchor_pairs(start1: int, start2: int, ops: list[tuple[str, int]],
                          trim: int) -> np.ndarray:
    """Exonerate-CIGAR match blocks -> (x, y) pairs, trimming ``trim`` pairs
    from each end of every match block.

    Op semantics (convertPairwiseForwardStrandAlignmentToAnchorPairs,
    pairwiseAligner.c:1039-1063): 'M' advances both coordinates, 'D' advances
    seq1 only (gap in seq2), 'I' advances seq2 only (gap in seq1).
    """
    for op, _length in ops:
        if op not in ("M", "D", "I"):
            raise ValueError(f"unknown cigar op {op!r}")
    kind = np.array([op for op, _ in ops], dtype="<U1")
    length = np.array([n for _, n in ops], dtype=np.int64)
    match = kind == "M"
    step_x = np.where(match | (kind == "D"), length, 0)
    step_y = np.where(match | (kind == "I"), length, 0)
    j = start1 + np.cumsum(step_x) - step_x          # each op's start
    k = start2 + np.cumsum(step_y) - step_y
    count = np.where(match, np.maximum(length - 2 * trim, 0), 0)
    total = int(count.sum())
    if total == 0:
        return np.zeros((0, 2), dtype=np.int64)
    # within-block offsets trim, trim + 1, ... of each match block
    offset = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(count) - count, count) + trim
    return np.stack([np.repeat(j, count) + offset, np.repeat(k, count) + offset], axis=1)


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
    n = len(anchors)
    # the gap before each anchor, and before the end (lX, lY): from one past
    # the previous anchor (from 0 before the first)
    ends = np.concatenate([anchors, np.array([[lX, lY]], dtype=np.int64)])
    prev = np.concatenate([np.zeros((1, 2), dtype=np.int64), anchors + 1])
    gx, gy = ends[:, 0] - prev[:, 0], ends[:, 1] - prev[:, 1]
    wide = (np.minimum(gx, gy) > max_gap_min_dim if max_gap_min_dim is not None
            else np.zeros(n + 1, dtype=bool))
    split = (gx * gy > split_matrix_bigger_than_this) | wide
    assert ((anchors >= prev[:n]).all(axis=1)
            & (anchors[:, 0] < lX) & (anchors[:, 1] < lY)).all()
    at = np.flatnonzero(split)
    max_len = int(math.sqrt(split_matrix_bigger_than_this))
    # clamp: a degenerate max_gap_min_dim < 2 must not produce zero-size
    # half-rectangles
    cap = np.where(wide[at], min(max_len, max((max_gap_min_dim or 0) // 2, 1)), max_len)
    hx, hy = np.minimum(gx[at] // 2, cap), np.minimum(gy[at] // 2, cap)
    x1 = np.concatenate([[0], ends[at, 0] - hx])     # each rectangle's start
    y1 = np.concatenate([[0], ends[at, 1] - hy])
    split_points: list[tuple[int, int, int, int]] = list(zip(
        x1[:-1].tolist(), y1[:-1].tolist(), (prev[at, 0] + hx).tolist(),
        (prev[at, 1] + hy).tolist()))
    if ragged_left and len(at) and at[0] == 0:
        split_points = split_points[1:]          # skip_block on the first gap
    did_split = len(at) > 0 and at[-1] == n
    if not did_split or not ragged_right:
        split_points.append((int(x1[-1]), int(y1[-1]), lX, lY))
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
