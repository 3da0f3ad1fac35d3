"""Aligned-pair post-processing: AMAP gap reweighting, ordered-pair filtering,
CIGAR conversion, long-indel splitting, and rescoring.

Mirrors pairwiseAligner.c:1616-1663 (reweighting), multipleAligner.c:949-997
(pairwise consistency filter — for the two-sequence case the MSA machinery
reduces to a maximum-weight strictly-monotone chain, implemented here as a
weighted LIS), and cPecanRealign.c:58-209, 295-340 (cigar conversion, indel
splitting, rescoring).

Copied from ``cpecan_signal_tpu/core/amap.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.  The
heaviest-chain DP of ``filter_pairs_to_ordered`` runs in host C++
(``csrc/amap_chain.cpp``, built by g++ at first use) instead of a Python
loop a pair; its chain is the same.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..constants import PAIR_ALIGNMENT_PROB_1
from ..io.cigar import CigarRecord
from ..ops._build import host_library

CHAIN_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


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


@functools.cache
def chain_library() -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/amap_chain.cpp``, once a process."""
    lib = ctypes.CDLL(str(host_library("amap_chain.cpp", CHAIN_FLAGS)))
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.amap_chain.argtypes = [i64, p, p, p, i64, p]
    lib.amap_chain.restype = i64
    return lib


def filter_pairs_to_ordered(pairs: np.ndarray) -> np.ndarray:
    """Maximum-weight strictly-monotone chain of (weight, x, y) pairs, in
    increasing x and y.

    The reference routes this through its MSA consistency machinery
    (filterPairwiseAlignmentToMakePairsOrdered, multipleAligner.c:949-997);
    for two sequences any consistent column set is a monotone chain, so the
    optimum is a weighted LIS (O(n log n)): a Fenwick tree of prefix maxima
    over the pairs' y ranks, in ``csrc/amap_chain.cpp``.
    """
    if len(pairs) == 0:
        return pairs
    order = np.lexsort((pairs[:, 2], pairs[:, 1]))
    p = pairs[order]
    ys, yr = np.unique(p[:, 2], return_inverse=True)
    w = np.ascontiguousarray(p[:, 0], dtype=np.float64)
    x = np.ascontiguousarray(p[:, 1], dtype=np.int64)
    yr = np.ascontiguousarray(yr, dtype=np.int64)
    chain = np.empty(len(p), dtype=np.int64)
    k = chain_library().amap_chain(len(p), w.ctypes.data, x.ctypes.data, yr.ctypes.data,
                                   len(ys), chain.ctypes.data)
    return pairs[order[chain[:k]]]


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
