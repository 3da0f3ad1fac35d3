"""The plain reference of cPecanRealign: a guide CIGAR record realigned with
the fiveState nucleotide pair HMM, then AMAP.

Worked out again from the record and the two sequences: the record's
subsequences and anchors (its match runs less ``trim`` at each end, kept
where the bases agree; cPecanRealign.c:556-583), the splits and bands, the
fiveState machine's emissions and transitions (stateMachine5 with its
defaults, stateMachine.c:60-82, 743-1154), the posterior match
probabilities of every split (``hmm.BandedHMM``) and the output tail
(cPecanRealign.c:591-645): pairs at or above the threshold, quantised;
each weight less gamma times the indel probabilities of its two positions
(pairwiseAligner.c:1616-1663); the heaviest strictly increasing chain of
pairs (multipleAligner.c:949-997 for two sequences).
"""

from __future__ import annotations

import numpy as np
import torch

from . import band as bd
from .hmm import LOWER, MIDDLE, UPPER, BandedHMM, Job, Machine

PROB_1 = 10_000_000
M, SX, SY, LX, LY = 0, 1, 2, 3, 4
GAPX, MATCH, GAPY = 0, 1, 2
_MATCH, _TRANSVERSION, _TRANSITION, _GAP = (-2.1149196655034745, -4.5691014376830479,
                                            -3.9833860032220842, -1.6094379124341003)
_N_GAP, _N_MATCH = -1.386294361, -2.772588722
T = {"match_continue": -0.030064059121770816, "match_from_short_x": -1.272871422049609,
     "match_from_long_x": -5.673280173170473, "short_open_x": -4.34381910900448,
     "short_extend_x": -0.3388262689231553, "long_open_x": -6.30810595366929,
     "long_extend_x": -0.003442492794189331}
EDGES = (
    (LOWER, M, SX, GAPX, T["short_open_x"]),
    (LOWER, SX, SX, GAPX, T["short_extend_x"]),
    (LOWER, M, LX, GAPX, T["long_open_x"]),
    (LOWER, LX, LX, GAPX, T["long_extend_x"]),
    (MIDDLE, M, M, MATCH, T["match_continue"]),
    (MIDDLE, SX, M, MATCH, T["match_from_short_x"]),
    (MIDDLE, SY, M, MATCH, T["match_from_short_x"]),
    (MIDDLE, LX, M, MATCH, T["match_from_long_x"]),
    (MIDDLE, LY, M, MATCH, T["match_from_long_x"]),
    (UPPER, M, SY, GAPY, T["short_open_x"]),
    (UPPER, SY, SY, GAPY, T["short_extend_x"]),
    (UPPER, M, LY, GAPY, T["long_open_x"]),
    (UPPER, LY, LY, GAPY, T["long_extend_x"]),
)
MACHINE = Machine(5, M, EDGES)
RAGGED_START = np.array([-np.inf, -np.inf, -np.inf, 0.0, 0.0])
RAGGED_END = np.array([T["long_open_x"], T["long_open_x"], T["long_open_x"],
                       T["long_extend_x"], T["long_extend_x"]])
_CODE = np.full(256, 4, dtype=np.int64)
for _i, _b in enumerate("ACGT"):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i


def _tables():
    """Match (5, 5) and gap (5,) log-probabilities; code 4 is N."""
    m = np.full((5, 5), _N_MATCH)
    m[:4, :4] = _TRANSVERSION
    for i in range(4):
        m[i, i] = _MATCH
        m[i, i ^ 2] = _TRANSITION          # A<->G, C<->T
    g = np.full(5, _GAP)
    g[4] = _N_GAP
    return m, g


def codes(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


def revcomp(seq: str) -> str:
    return seq[::-1].translate(str.maketrans("ACGTacgtNn", "TGCAtgcaNn"))


def head(rec: dict, seqs: dict, trim: int):
    """(sub_x, sub_y, anchors) of a record ``rec`` (contig1/2, start1/2,
    end1/2, strand1/2, ops), rebased to the forward strand of each."""
    def sub(seq, s, e, fwd):
        return seq[s:e] if fwd else revcomp(seq[e:s])
    sx = sub(seqs[rec["contig1"]], rec["start1"], rec["end1"], rec["strand1"])
    sy = sub(seqs[rec["contig2"]], rec["start2"], rec["end2"], rec["strand2"])
    a = bd.cigar_anchor_pairs(0, 0, rec["ops"], trim)
    cx, cy = codes(sx), codes(sy)
    if len(a):
        a = a[(cx[a[:, 0]] == cy[a[:, 1]]) & (cx[a[:, 0]] != 4)]
    return sx, sy, bd.sorted_chain(a)


class RealignProblems:
    """Every split of every given record, on ``device``."""

    def __init__(self, heads, expansion: int, split_cap: int, device, dtype=torch.float64):
        self.device, self.dtype = device, dtype
        self.jobs, self.owner = [], []
        cxs, cys, xo, yo = [], [], [], []
        nx = ny = 0
        for r, (sx, sy, anchors) in enumerate(heads):
            cx, cy = codes(sx), codes(sy)
            for (x1, y1, x2, y2) in bd.split_points(anchors, len(sx), len(sy), split_cap,
                                                    True, True):
                L, R = bd.band(bd.anchors_in(anchors, x1, y1, x2, y2), x2 - x1, y2 - y1,
                               expansion)
                self.jobs.append(Job(x2 - x1, y2 - y1, L, R, RAGGED_START, RAGGED_END, x1, y1))
                self.owner.append(r)
                cxs.append(np.concatenate([[4], cx[x1:x2]]))
                cys.append(np.concatenate([[4], cy[y1:y2]]))
                xo.append(nx)
                yo.append(ny)
                nx += x2 - x1 + 1
                ny += y2 - y1 + 1
        dev = device
        self.cx = torch.as_tensor(np.concatenate(cxs), device=dev)
        self.cy = torch.as_tensor(np.concatenate(cys), device=dev)
        self.xo = torch.as_tensor(xo, device=dev)
        self.yo = torch.as_tensor(yo, device=dev)
        m, g = _tables()
        self.match = torch.as_tensor(m, dtype=dtype, device=dev)
        self.gap = torch.as_tensor(g, dtype=dtype, device=dev)

    def emissions(self, job, x_idx, y_idx):
        a = self.cx[(self.xo[job] + x_idx + 1).clamp(0, len(self.cx) - 1)]
        b = self.cy[(self.yo[job] + y_idx + 1).clamp(0, len(self.cy) - 1)]
        return torch.stack([self.gap[a], self.match[a, b], self.gap[b]], dim=-1)

    def pairs(self, threshold: float, n_records: int):
        """Per record: (weight, x, y) int64 rows of the pairs at or above
        ``threshold``, weight = floor(p * 1e7)."""
        h = BandedHMM(self.jobs, MACHINE, self.emissions, self.device, self.dtype)
        h.forward()
        h.backward()
        parts = [[] for _ in range(n_records)]
        for r, (x, y, p) in zip(self.owner, h.match_pairs(threshold)):
            parts[r].append(np.stack([np.floor(p * PROB_1).astype(np.int64), x, y], axis=1))
        return [np.concatenate(p) if p else np.zeros((0, 3), dtype=np.int64) for p in parts]


def reweight(pairs: np.ndarray, lx: int, ly: int, gamma: float) -> np.ndarray:
    """weight -= gamma * (indel probability of x + of y), each position's
    indel probability PROB_1 less its pairs' weights (floored at 0)."""
    if gamma <= 0 or len(pairs) == 0:
        return pairs
    ix = np.full(lx, PROB_1, dtype=np.int64)
    iy = np.full(ly, PROB_1, dtype=np.int64)
    np.subtract.at(ix, pairs[:, 1], pairs[:, 0])
    np.subtract.at(iy, pairs[:, 2], pairs[:, 0])
    out = pairs.copy()
    out[:, 0] -= (gamma * (np.maximum(ix, 0)[pairs[:, 1]]
                           + np.maximum(iy, 0)[pairs[:, 2]])).astype(np.int64)
    return out


def heaviest_chain(pairs: np.ndarray) -> np.ndarray:
    """The heaviest chain of (weight, x, y) pairs strictly increasing in x
    and y (a chain's weight the sum of its positive-prefix weights, as the
    C code's consistency filter gives for two sequences): a weighted
    longest increasing subsequence over a prefix-maximum tree on y."""
    if len(pairs) == 0:
        return pairs
    order = np.lexsort((pairs[:, 2], pairs[:, 1]))
    p = pairs[order]
    ys = np.unique(p[:, 2])
    yr = np.searchsorted(ys, p[:, 2]).tolist()
    m = len(ys)
    tv = [-np.inf] * (m + 1)
    ti = [-1] * (m + 1)
    n = len(p)
    w = p[:, 0].astype(float).tolist()
    xs = p[:, 1].tolist()
    best = [0.0] * n
    back = [-1] * n
    i = 0
    while i < n:
        j = i
        while j < n and xs[j] == xs[i]:
            q, bv, bi = yr[j], -np.inf, -1
            while q > 0:
                if tv[q] > bv:
                    bv, bi = tv[q], ti[q]
                q -= q & (-q)
            back[j] = bi if bv > 0 else -1
            best[j] = (bv if bv > 0 else 0.0) + w[j]
            j += 1
        for k in range(i, j):
            q = yr[k] + 1
            while q <= m:
                if best[k] > tv[q]:
                    tv[q], ti[q] = best[k], k
                q += q & (-q)
        i = j
    end = int(np.argmax(best))
    chain = []
    while end >= 0:
        chain.append(order[end])
        end = back[end]
    return pairs[np.asarray(chain[::-1], dtype=np.int64)]


def realigned_pairs(pairs: np.ndarray, lx: int, ly: int, gamma: float) -> np.ndarray:
    """(x, y) rows of the realigned record, in order."""
    ch = heaviest_chain(reweight(pairs, lx, ly, gamma))
    ch = ch[np.lexsort((ch[:, 2], ch[:, 1]))] if len(ch) else ch
    return ch[:, 1:]


def ops_pairs(ops) -> np.ndarray:
    """(x, y) rows a CIGAR's match runs cover, from (0, 0)."""
    out, x, y = [], 0, 0
    for op, n in ops:
        if op == "M":
            r = np.arange(n, dtype=np.int64)
            out.append(np.stack([x + r, y + r], axis=1))
            x += n
            y += n
        elif op == "D":
            x += n
        else:
            y += n
    return np.concatenate(out) if out else np.zeros((0, 2), dtype=np.int64)

