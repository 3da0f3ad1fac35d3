"""Aligned-pair post-processing: AMAP gap reweighting, ordered-pair filtering,
CIGAR conversion, long-indel splitting, and rescoring.

Mirrors pairwiseAligner.c:1616-1663 (reweighting), multipleAligner.c:949-997
(pairwise consistency filter — for the two-sequence case the MSA machinery
reduces to a maximum-weight strictly-monotone chain, implemented here as a
weighted LIS), and cPecanRealign.c:58-209, 295-340 (cigar conversion, indel
splitting, rescoring).

Copied from ``cpecan_signal_tpu/core/amap.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import bisect

import numpy as np

from ..constants import PAIR_ALIGNMENT_PROB_1
from ..io.cigar import CigarRecord


def indel_probabilities(pairs: np.ndarray, seq_length: int, x_axis: bool) -> np.ndarray:
    """Per-position indel weights: PROB_1 minus the summed pair probabilities
    (getIndelProbabilities, pairwiseAligner.c:1619-1634)."""
    out = np.full(seq_length, PAIR_ALIGNMENT_PROB_1, dtype=np.int64)
    col = 1 if x_axis else 2
    np.subtract.at(out, pairs[:, col], pairs[:, 0])
    return np.maximum(out, 0)


def reweight_aligned_pairs(pairs: np.ndarray, lx: int, ly: int,
                           gap_gamma: float) -> np.ndarray:
    """AMAP reweighting: weight -= gamma * (indelProbX + indelProbY)
    (reweightAlignedPairs2, pairwiseAligner.c:1651-1663).  pairs rows are
    (weight, x, y)."""
    if gap_gamma <= 0.0 or len(pairs) == 0:
        return pairs
    ix = indel_probabilities(pairs, lx, True)
    iy = indel_probabilities(pairs, ly, False)
    out = pairs.copy()
    out[:, 0] = pairs[:, 0] - (gap_gamma * (ix[pairs[:, 1]] + iy[pairs[:, 2]])).astype(np.int64)
    return out


def filter_pairs_to_ordered(pairs: np.ndarray) -> np.ndarray:
    """Maximum-weight strictly-monotone chain of (weight, x, y) pairs.

    The reference routes this through its MSA consistency machinery
    (filterPairwiseAlignmentToMakePairsOrdered, multipleAligner.c:949-997);
    for two sequences any consistent column set is a monotone chain, so the
    optimum is a weighted LIS (O(n log n)).
    """
    if len(pairs) == 0:
        return pairs
    order = np.lexsort((pairs[:, 2], pairs[:, 1]))
    p = pairs[order]
    n = len(p)
    # DP over pairs sorted by (x, y): best[i] = max chain weight ending at i.
    # Fenwick tree over compressed y for prefix-max.
    ys = np.unique(p[:, 2])
    m = len(ys)
    tree_val = np.full(m + 1, -np.inf)
    tree_idx = np.full(m + 1, -1, dtype=np.int64)

    def update(j, val, idx):
        j += 1
        while j <= m:
            if val > tree_val[j]:
                tree_val[j] = val
                tree_idx[j] = idx
            j += j & (-j)

    def query(j):  # max over y-rank < j
        best_v, best_i = -np.inf, -1
        while j > 0:
            if tree_val[j] > best_v:
                best_v, best_i = tree_val[j], tree_idx[j]
            j -= j & (-j)
        return best_v, best_i

    best = np.zeros(n)
    back = np.full(n, -1, dtype=np.int64)
    # process in x order; delay updates until x strictly increases
    i = 0
    while i < n:
        j = i
        while j < n and p[j, 1] == p[i, 1]:
            yr = int(np.searchsorted(ys, p[j, 2]))
            v, bi = query(yr)  # strictly smaller y
            prev = max(v, 0.0) if v > 0 else 0.0
            back[j] = bi if v > 0 else -1
            best[j] = prev + float(p[j, 0])
            j += 1
        for k in range(i, j):
            yr = int(np.searchsorted(ys, p[k, 2]))
            update(yr, best[k], k)
        i = j
    end = int(np.argmax(best))
    chain = []
    while end >= 0:
        chain.append(order[end])
        end = int(back[end])
    chain.reverse()
    return pairs[np.asarray(chain, dtype=np.int64)]


def pairs_to_cigar_ops(pairs: np.ndarray, lx: int, ly: int) -> list[tuple[str, int]]:
    """Strictly-monotone (weight, x, y) pairs -> exonerate ops
    (convertAlignedPairsToPairwiseAlignment, cPecanRealign.c:58-101).
    'D' = gap in seq2 (INDEL_X), 'I' = gap in seq1 (INDEL_Y)."""
    ops: list[tuple[str, int]] = []
    px = py = -1
    ml = 0
    coords = list(map(tuple, pairs[:, 1:])) + [(lx, ly)]
    for x, y in coords:
        if x - px > 0 and y - py > 0:
            if x - px > 1 or y - py > 1:
                if ml > 0:
                    ops.append(("M", ml))
                    ml = 0
                if x - px > 1:
                    ops.append(("D", int(x - px - 1)))
                if y - py > 1:
                    ops.append(("I", int(y - py - 1)))
            ml += 1
            px, py = x, y
    if ml > 1:
        ops.append(("M", ml - 1))
    return ops


def has_long_indel(ops: list[tuple[str, int]], max_len: int) -> bool:
    run = 0
    for op, ln in ops:
        if op == "M":
            run = 0
        else:
            run += ln
            if run > max_len:
                return True
    return False


def split_long_indels(rec: CigarRecord, max_len: int) -> list[CigarRecord]:
    """Split an alignment wherever an indel run exceeds max_len
    (splitPairwiseAlignment, cPecanRealign.c:125-209); split alignments never
    start or end with indels."""
    if not has_long_indel(rec.ops, max_len):
        return [rec]
    out: list[CigarRecord] = []
    pos1, pos2 = rec.start1, rec.start2
    d1 = 1 if rec.strand1 else -1
    d2 = 1 if rec.strand2 else -1
    cur_ops: list[tuple[str, int]] = []
    indel_buf: list[tuple[str, int]] = []
    run = 0
    cs1, cs2 = pos1, pos2
    ce1, ce2 = pos1, pos2
    for op, ln in rec.ops:
        if op == "M":
            if run > max_len and cur_ops:
                out.append(CigarRecord(rec.contig1, cs1, ce1, rec.strand1,
                                       rec.contig2, cs2, ce2, rec.strand2,
                                       rec.score, cur_ops))
                cur_ops = []
                indel_buf = []
                cs1, cs2 = pos1, pos2
                ce1, ce2 = cs1, cs2
            elif not cur_ops:
                indel_buf = []
                cs1, cs2 = pos1, pos2
                ce1, ce2 = cs1, cs2
            run = 0
            cur_ops.extend(indel_buf)
            indel_buf = []
            pos1 += d1 * ln
            pos2 += d2 * ln
            ce1, ce2 = pos1, pos2
            cur_ops.append((op, ln))
        elif op == "D":
            run += ln
            pos1 += d1 * ln
            indel_buf.append((op, ln))
        else:  # "I"
            run += ln
            pos2 += d2 * ln
            indel_buf.append((op, ln))
    if cur_ops:
        out.append(CigarRecord(rec.contig1, cs1, ce1, rec.strand1,
                               rec.contig2, cs2, ce2, rec.strand2,
                               rec.score, cur_ops))
    return out


def score_by_identity(sx: str, sy: str, pairs: np.ndarray,
                      ignore_gaps: bool) -> float:
    if len(pairs) == 0:
        return 0.0
    matches = sum(1 for _, x, y in pairs.tolist()
                  if sx[x].upper() == sy[y].upper() and sx[x].upper() != "N")
    if ignore_gaps:
        return 100.0 * matches / len(pairs)
    denom = len(sx) + len(sy)
    return 0.0 if denom == 0 else 100.0 * 2.0 * matches / denom


def score_by_posterior(pairs: np.ndarray, lx: int, ly: int,
                       ignore_gaps: bool) -> float:
    if len(pairs) == 0:
        return 0.0
    total = float(pairs[:, 0].sum())
    if ignore_gaps:
        return 100.0 * total / (len(pairs) * PAIR_ALIGNMENT_PROB_1)
    denom = lx + ly
    return 0.0 if denom == 0 else 100.0 * 2.0 * total / (denom * PAIR_ALIGNMENT_PROB_1)
