"""Seed-and-chain anchor generation: the lastz-equivalent guide aligner.

The reference shells out to a vendored lastz binary to produce chained CIGAR
anchors (getBlastPairs, pairwiseAligner.c:1065-1145).  Here anchoring is a
host-side exact-seed + weighted-LIS chainer producing the same interface — a
monotone (x, y) int array — which tests can also inject directly (SURVEY §7
"hard parts": the anchor interface is a plain (x, y) array).

Algorithm: exact k-mer seed matches via hashing, greedy diagonal-run merging
into ungapped segments (HSP analogues), then sparse chaining of segments by
score with a gap penalty, finally per-position pair emission with end-trim
(the reference trims ``constraintDiagonalTrim`` pairs off every match block).

Copied from ``cpecan_signal_tpu/anchor/seed_chain.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..core.anchors import filter_to_remove_overlap


def _seed_matches(sx: str, sy: str, k: int, repeat_mask: bool = True) -> np.ndarray:
    """All exact k-mer match positions (x, y), case-insensitive."""
    sx = sx.upper()
    sy = sy.upper()
    index: dict[str, list[int]] = {}
    for i in range(len(sx) - k + 1):
        w = sx[i:i + k]
        if "N" in w:
            continue
        index.setdefault(w, []).append(i)
    max_hits = 32 if repeat_mask else 256
    out = []
    for j in range(len(sy) - k + 1):
        w = sy[j:j + k]
        hits = index.get(w)
        if hits is None or len(hits) > max_hits:  # repeat masking analogue
            continue
        for i in hits:
            out.append((i, j))
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def _merge_diagonal_runs(seeds: np.ndarray, k: int) -> list[tuple[int, int, int]]:
    """Merge seeds on the same diagonal into maximal runs -> (x, y, length)."""
    if len(seeds) == 0:
        return []
    diag = seeds[:, 0] - seeds[:, 1]
    order = np.lexsort((seeds[:, 0], diag))
    runs = []
    cx = cy = clen = None
    for idx in order:
        x, y = int(seeds[idx, 0]), int(seeds[idx, 1])
        if clen is not None and x - y == cx - cy and x <= cx + clen:
            clen = max(clen, x - cx + k)
        else:
            if clen is not None:
                runs.append((cx, cy, clen))
            cx, cy, clen = x, y, k
    runs.append((cx, cy, clen))
    return runs


def _chain_runs(runs: list[tuple[int, int, int]]) -> list[tuple[int, int, int]]:
    """Sparse chaining: max-score monotone chain with affine-ish gap cost."""
    if not runs:
        return []
    runs = sorted(runs, key=lambda r: (r[0] + r[1], r[0]))
    n = len(runs)
    score = np.zeros(n)
    back = np.full(n, -1, dtype=np.int64)
    for i, (xi, yi, li) in enumerate(runs):
        score[i] = li
        for j in range(max(0, i - 64), i):
            xj, yj, lj = runs[j]
            if xj + lj <= xi and yj + lj <= yi:
                gap = abs((xi - yi) - (xj - yj)) * 0.5 + 0.01 * ((xi - xj) + (yi - yj))
                s = score[j] + li - gap
                if s > score[i]:
                    score[i] = s
                    back[i] = j
    best = int(np.argmax(score))
    chain = []
    while best >= 0:
        chain.append(runs[best])
        best = int(back[best])
    return chain[::-1]


def get_anchor_pairs(sx: str, sy: str, k: int = 12, run_trim: int = 2,
                     repeat_mask: bool = True) -> np.ndarray:
    """Monotone anchor (x, y) pairs between two nucleotide sequences.

    Drop-in for getBlastPairsForPairwiseAlignmentParameters.  Unlike lastz's
    gapped HSPs — whose block *ends* are unreliable and therefore trimmed by
    constraintDiagonalTrim (pairwiseAligner.c:1039-1063) — chained exact-match
    runs are trustworthy along their whole length, so only a small fixed
    ``run_trim`` is shaved per run end.  Output is strictly monotone.
    """
    seeds = _seed_matches(sx, sy, k, repeat_mask=repeat_mask)
    runs = _merge_diagonal_runs(seeds, k)
    chain = _chain_runs(runs)
    pairs = []
    for (x, y, length) in chain:
        for l in range(run_trim, length - run_trim):
            pairs.append((x + l, y + l))
    if not pairs:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.asarray(sorted(set(pairs)), dtype=np.int64)
    return filter_to_remove_overlap(pairs)


def _reanchor_gap(sx: str, sy: str, px: int, py: int, x: int, y: int,
                  params, out: list) -> None:
    """Bottom-level re-anchoring of one inter-anchor gap at relaxed
    stringency — smaller seeds, no repeat masking (getBlastPairsForPairwise-
    AlignmentParametersP, pairwiseAligner.c:1202-1228: lastz re-run on the
    gap substring with repeat masking off)."""
    lx2, ly2 = x - px, y - py
    if lx2 * ly2 <= params.repeat_mask_matrix_bigger_than_this:
        return
    sub = get_anchor_pairs(sx[px:x], sy[py:y], k=10, repeat_mask=False)
    for bx, by in sub:
        out.append((int(bx) + px, int(by) + py))


def get_anchor_pairs_for_params(sx: str, sy: str, params) -> np.ndarray:
    """Anchor generation honoring anchorMatrixBiggerThanThis (small matrices
    get no anchors -> full DP, pairwiseAligner.c:1238-1240) with recursive
    re-anchoring of large inter-anchor gaps (pairwiseAligner.c:1230-1281)."""
    if len(sx) * len(sy) <= params.anchor_matrix_bigger_than_this:
        return np.zeros((0, 2), dtype=np.int64)
    top = get_anchor_pairs(sx, sy)
    combined: list[tuple[int, int]] = []
    px = py = 0
    for x, y in top:
        _reanchor_gap(sx, sy, px, py, int(x), int(y), params, combined)
        combined.append((int(x), int(y)))
        px, py = int(x) + 1, int(y) + 1
    _reanchor_gap(sx, sy, px, py, len(sx), len(sy), params, combined)
    if not combined:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.asarray(combined, dtype=np.int64)
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return filter_to_remove_overlap(pairs[order])
