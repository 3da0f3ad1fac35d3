"""Nucleotide traffic from a seed: a genome pair and guide CIGARs of its true
alignment.

A frozen copy of ``chip_smoke.nucleotide_set``: X is random, Y descends from
X (``signal.evolve_with_truth``), and records cut from the true alignment
cover X in consecutive spans.  The records on Y's reverse strand hold their
Y segment reverse-complemented in Y as stored, so that the realigner reads
them back the right way round.  Record lengths are the same for every seed
(log-uniform quantiles scaled to X's length); the seed orders them and picks
the reverse ones.
"""

from __future__ import annotations

import numpy as np

from .signal import evolve_with_truth, guide_ops, random_codes, revcomp_codes, to_str


def record_lengths(total: int, lo: int, hi: int) -> np.ndarray:
    """Lengths from lo to hi, log-uniform quantiles, summing to ``total``."""
    mean = (hi - lo) / np.log(hi / lo)
    n = max(int(round(total / mean)), 1)
    q = np.exp(np.log(lo) + (np.arange(n) + 0.5) / n * np.log(hi / lo))
    out = np.floor(q * total / q.sum()).astype(np.int64)
    out[-1] += total - out.sum()
    return out


def cigar_ops(local: np.ndarray, lx: int, ly: int) -> list[tuple[str, int]]:
    """Ops of a record spanning [0, lx) x [0, ly) through the pairs
    ``local``: leading and trailing gaps included."""
    ops = []
    if local[0, 0] > 0:
        ops.append(("D", int(local[0, 0])))
    if local[0, 1] > 0:
        ops.append(("I", int(local[0, 1])))
    ops += guide_ops(local)
    if lx - 1 - local[-1, 0] > 0:
        ops.append(("D", int(lx - 1 - local[-1, 0])))
    if ly - 1 - local[-1, 1] > 0:
        ops.append(("I", int(ly - 1 - local[-1, 1])))
    return ops


def genome_pair(rng: np.random.Generator, n_bases: int, rates, lengths: np.ndarray,
                reverse_share: float) -> dict:
    """X, Y as stored, and the records: dicts of (x1, x2, y start, y end,
    y forward, ops) in the realigner's CIGAR coordinates, in an order drawn
    from ``rng``."""
    x = random_codes(rng, n_bases)
    y, truth = evolve_with_truth(x, rng, *rates)
    order = rng.permutation(lengths)
    bounds = np.concatenate([[0], np.cumsum(order)])
    n = len(order)
    reverse = np.zeros(n, dtype=bool)
    reverse[rng.choice(n, int(round(reverse_share * n)), replace=False)] = True
    cuts = np.searchsorted(truth[:, 0], bounds)
    recs = []
    for k in range(n):
        sel = truth[cuts[k]:cuts[k + 1]]
        c, d = int(sel[0, 1]), int(sel[-1, 1]) + 1
        x1, x2 = int(bounds[k]), int(bounds[k + 1])
        recs.append({"x1": x1, "x2": x2, "c": c, "d": d, "forward": not reverse[k],
                     "ops": cigar_ops(sel - [x1, c], x2 - x1, d - c)})
    y_stored = y.copy()
    for r in recs:
        if not r["forward"]:
            y_stored[r["c"]:r["d"]] = revcomp_codes(y[r["c"]:r["d"]])
    return {"x": to_str(x), "y": to_str(y_stored), "records": recs}
