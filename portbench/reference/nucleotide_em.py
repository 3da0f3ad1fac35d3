"""The plain reference of cPecanEm's iteration on the fiveState nucleotide pair
HMM: each record's expected transition and emission uses and likelihood
under a model (the E-step, cPecanRealign --outputExpectations), and the
M-step that turns summed uses into the next model.

Worked out again from the model and the records, not taken from the
program:
- The machine.  A model is cPecanEm's Hmm: transitions (5, 5) and emissions
  (5, 4, 4), states match, shortGapX, shortGapY, longGapX, longGapY, and a
  transition (from, to).  cPecanRealign --loadHmm builds the fiveState
  machine from it as stateMachine5_loadSymmetric does (stateMachine.c:
  1100-1154): each transition the mean of its X and Y forms, log taken
  (match continue from match -> match alone); where the short gap's extend
  exceeds the long gap's, the short and long parameters trade places
  (stateMachine.c:1132-1138); the match emissions are the mean of (x, y)
  and (y, x) (emissions_loadMatchProbsSymmetrically, stateMachine.c:
  688-706); the gap emissions of both axes one table, the uses of the
  X-gap states summed by x and of the Y-gap states by y, normalized
  (emissions_loadGapProbs, stateMachine.c:708-732).  A symbol N (code 4)
  matches at log 1/16 and gaps at log 1/4, to nine decimals
  (stateMachine.c:158-171).  The switches between the two short or the two
  long gaps are loaded but no cell calculation reads them
  (stateMachine5_cellCalculate), so the edges are ``nucleotide.EDGES``
  with the model's values.  Every split is
  ragged at both ends: start in either long gap; end from the match and
  short-gap states at the long gap's open, from the long gaps at its extend
  (stateMachine5 raggedStartStateProb / raggedEndStateProb).
- The records' subsequences, anchors, splits and bands are
  ``nucleotide.RealignProblems``'; F, B and the per-edge tallies
  ``hmm.BandedHMM``'s.
- The expected uses (cell_updateExpectations, pairwiseAligner.c:407-424):
  each edge's posterior adds to its (from, to) transition, and to the
  to-state's emission under the symbols of the cell it enters, x's and y's,
  where neither is N.  A record's uses are its splits' summed, and so is
  its likelihood: each split's log P on each of its anti-diagonals past
  the first, which is what the per-diagonal totals add up to
  (``BandedHMM.likelihoods``).
- The M-step (hmmDiscrete_normalize2, discreteHmm.c:124-153): the summed
  uses, each started at the merge's pseudocount, each transition row over
  its sum, each state's 16 emissions over their sum.

Departures: the log-space sums use exact logaddexp, not the C code's cubic
logAdd; uses are summed in float64 whatever the precision of F and B.
Plain PyTorch on one device; nothing here is the program's.
"""

from __future__ import annotations

import numpy as np
import torch

from .hmm import BandedHMM
from .nucleotide import EDGES, MACHINE, RAGGED_START, RealignProblems

M, SX, SY, LX, LY = range(5)
N_SYM = 4
PSEUDOCOUNT = 1e-12        # what the merge of the chunks' uses starts at
_N_MATCH, _N_GAP = -2.772588722, -1.386294361   # log 1/16, log 1/4 as the C code writes them


def _log(v):
    with np.errstate(divide="ignore"):
        return np.log(np.asarray(v, dtype=np.float64))


def machine(trans: np.ndarray, emiss: np.ndarray):
    """(edge log transitions (13,) in ``EDGES`` order, ragged end (5,),
    match (5, 5), gap (5,)) of the machine loaded from the model."""
    t = np.asarray(trans, dtype=np.float64)
    e = np.asarray(emiss, dtype=np.float64)
    p = {"continue": _log(t[M, M]),
         "from_short": _log((t[SX, M] + t[SY, M]) / 2),
         "from_long": _log((t[LX, M] + t[LY, M]) / 2),
         "short_open": _log((t[M, SX] + t[M, SY]) / 2),
         "short_extend": _log((t[SX, SX] + t[SY, SY]) / 2),
         "long_open": _log((t[M, LX] + t[M, LY]) / 2),
         "long_extend": _log((t[LX, LX] + t[LY, LY]) / 2)}
    if p["short_extend"] > p["long_extend"]:
        for a in ("extend", "open"):
            p["short_" + a], p["long_" + a] = p["long_" + a], p["short_" + a]
        p["from_short"], p["from_long"] = p["from_long"], p["from_short"]
    value = {(M, SX): "short_open", (SX, SX): "short_extend", (M, LX): "long_open",
             (LX, LX): "long_extend", (M, M): "continue", (SX, M): "from_short",
             (SY, M): "from_short", (LX, M): "from_long", (LY, M): "from_long",
             (M, SY): "short_open", (SY, SY): "short_extend", (M, LY): "long_open",
             (LY, LY): "long_extend"}
    edge_t = np.array([p[value[(e_[1], e_[2])]] for e_ in EDGES])
    end = np.array([p["long_open"]] * 3 + [p["long_extend"]] * 2)
    match = np.full((5, 5), _N_MATCH)
    match[:4, :4] = _log((e[M] + e[M].T) / 2)
    gap = e[SX].sum(1) + e[LX].sum(1) + e[SY].sum(0) + e[LY].sum(0)
    gap = np.concatenate([_log(gap / gap.sum()), [_N_GAP]])
    return edge_t, end, match, gap


class EmProblems:
    """Every split of every given record (``nucleotide.head``), each record a
    group of its own, on ``device`` in ``dtype``."""

    def __init__(self, heads, expansion: int, split_cap: int, device, dtype=torch.float64):
        self.problems = RealignProblems(heads, expansion, split_cap, device, dtype)
        for j, r in zip(self.problems.jobs, self.problems.owner):
            j.group = r
        self.n_records = len(heads)
        self.device, self.dtype = device, dtype

    def e_step(self, trans: np.ndarray, emiss: np.ndarray) -> list:
        """Per record: (trans (5, 5), emiss (5, 4, 4), likelihood) float64
        under the model (trans, emiss)."""
        pr = self.problems
        edge_t, end, match, gap = machine(trans, emiss)
        for j in pr.jobs:
            j.trans, j.start, j.end = edge_t, RAGGED_START, end
        pr.match = torch.as_tensor(match, dtype=self.dtype, device=self.device)
        pr.gap = torch.as_tensor(gap, dtype=self.dtype, device=self.device)
        h = BandedHMM(pr.jobs, MACHINE, pr.emissions, self.device, self.dtype)
        h.forward()
        h.backward()
        per_edge, _ = h.edge_tallies()
        keyed = self._keyed_entries(h).cpu().numpy()
        lik = h.likelihoods().cpu().numpy()
        per_edge = per_edge.cpu().numpy()
        out = []
        for g in range(self.n_records):
            t = np.zeros((5, 5))
            for k, e_ in enumerate(EDGES):
                t[e_[1], e_[2]] += per_edge[g, k]
            out.append((t, keyed[g].reshape(5, N_SYM, N_SYM), float(lik[g])))
        return out

    def _keyed_entries(self, h: BandedHMM) -> torch.Tensor:
        """(G, S, 16) float64: the expected entries into each state by the
        key 4 cx + cy of the cell entered, cells with an N left out; the
        posteriors as ``BandedHMM.edge_tallies`` forms them."""
        pr, S = self.problems, MACHINE.n_states
        dev = self.device
        out = torch.zeros(h.n_groups * S * N_SYM * N_SYM, dtype=torch.float64, device=dev)
        states = torch.arange(S, device=dev)[None, None, :, None]
        for c0, c1 in h._chunks(1):
            idx, term = h._table(c0, c1, backward=False)
            _n, A, _S, _K, W = idx.shape
            d, a, k, x, y, valid = h._cells(c0, c1, A, W)
            bidx = h._flat(d[:, :, None, :], a[:, :, None, :], states, k[:, :, None, :], S)
            lp = (h.F[idx] + term + h.B[bidx][:, :, :, None, :]
                  - h.logP[:A][None, :, None, None, None])
            into = torch.exp(lp.double()).sum(dim=3)                    # (n, A, S, W)
            job = h.t_order[a].expand(x.shape)
            cx = pr.cx[(pr.xo[job] + x).clamp(0, len(pr.cx) - 1)]
            cy = pr.cy[(pr.yo[job] + y).clamp(0, len(pr.cy) - 1)]
            ok = (valid & (cx < N_SYM) & (cy < N_SYM))[:, :, None, :].expand(into.shape)
            key = (h.group[:A][None, :, None, None] * S + states) * N_SYM * N_SYM \
                + (cx * N_SYM + cy)[:, :, None, :]
            out.index_add_(0, key[ok], into[ok])
        return out.view(h.n_groups, S, N_SYM * N_SYM)


def m_step(trans: np.ndarray, emiss: np.ndarray, dtype=torch.float64):
    """The next model (trans (5, 5), emiss (5, 4, 4)) from summed uses,
    computed in ``dtype`` and returned as float64 numpy."""
    t = torch.as_tensor(np.asarray(trans), dtype=dtype) + PSEUDOCOUNT
    e = torch.as_tensor(np.asarray(emiss), dtype=dtype) + PSEUDOCOUNT
    t = t / t.sum(dim=1, keepdim=True)
    e = e / e.sum(dim=(1, 2), keepdim=True)
    return t.double().numpy(), e.double().numpy()
