"""EM expectation tallies from the f64 oracle's F and B (port of
``cpecan_signal_tpu/engine/expectations.py:30-165``).

For every diagonal d (1..D-1) and edge (frm -> to),

    p = exp(F[d-src][from-cell, frm] + B[d][cell, to] + eP + tP - total_d)

is accumulated into (a) the (S, S) transition tally, (b) per-kmer gapX
tallies (threeState), (c) skip-bin alpha/beta tallies (vanilla), (d) symbol
emission tallies (discrete fiveState), or (e) HDP (kmer, event) assignment
masks (diagonalCalculation_Expectations and the per-machine
``cellCalculateUpdateExpectations`` callbacks, pairwiseAligner.c:407-511,
841-863).  The likelihood is the sum of per-diagonal totals, the
reference's "once per diagonal" accumulation (pairwiseAligner.c:852-857).

Everything is computed from the full F and B with bulk gathers, in the
lanes of engine/fb.py (so the window layout's tallies share it).
"""

from __future__ import annotations

import torch

from ..constants import N_SKIP_BINS, NUM_OF_KMERS
from ..models.state_machines import MATCH, SHORT_GAP_X, SRC_MIDDLE
from .fb import EngineInputs, EnginePlan, Lanes, lanes, shifted_rows, to_lanes, totals_lanes


def likelihood(valid: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """Sum of per-diagonal totals over real diagonals d >= 1 (the reference's
    per-diagonal likelihood accumulation, pairwiseAligner.c:852-857)."""
    D = valid.shape[0]
    real = valid.any(dim=1) & (torch.arange(D, device=valid.device) >= 1)
    return torch.where(real, totals, 0.0).sum()


def _shifted_sources(ln: Lanes, F: torch.Tensor):
    """F (D, S, W) gathered at each cell's lower/middle/upper from-cells ->
    three (D, S, W) tensors (rows 0[/1] are -inf)."""
    D = F.shape[0]
    return (shifted_rows(F, ln.fL, 1, 0, D), shifted_rows(F, ln.fM, 2, 0, D),
            shifted_rows(F, ln.fL + 1, 1, 0, D))


def edge_posteriors_lanes(plan: EnginePlan, ln: Lanes, F, B, totals):
    """Yield (edge, p (D, W)) masked to valid cells with d >= 1; F and B in
    lanes (D, S, W)."""
    D = ln.valid.shape[0]
    srcs = _shifted_sources(ln, F)
    mask = ln.valid & (torch.arange(D, device=F.device) >= 1)[:, None]
    for e in plan.edges:
        tp = sum((ln.TP[:D, i] for i in e.cell_ids),
                 sum((ln.tp_scalar[i] for i in e.scalar_ids), 0.0))
        logp = srcs[e.src][:, e.frm] + B[:, e.to] + ln.E[:D, e.eclass] + tp - totals[:, None]
        yield e, torch.where(mask, torch.exp(logp), 0.0)


def _edge_posteriors(plan: EnginePlan, inp: EngineInputs, F, B, totals):
    """Yield (edge, p_grid (D, W)) of the reference-band problem."""
    yield from edge_posteriors_lanes(plan, lanes(inp), to_lanes(F), to_lanes(B), totals)


def _setup(plan: EnginePlan, inp: EngineInputs, F, B):
    ln, Fl, Bl = lanes(inp), to_lanes(F), to_lanes(B)
    totals = totals_lanes(plan, ln, Fl, Bl)
    S = plan.n_states
    trans = torch.zeros((S, S), dtype=F.dtype, device=F.device)
    return ln, Fl, Bl, totals, trans


def transition_expectations(plan: EnginePlan, inp: EngineInputs, F, B):
    """(S, S) transition tallies + likelihood (sum of per-diagonal totals)."""
    ln, Fl, Bl, totals, trans = _setup(plan, inp, F, B)
    for e, p in edge_posteriors_lanes(plan, ln, Fl, Bl, totals):
        trans[e.frm, e.to] += p.sum()
    return trans, likelihood(inp.valid, totals)


def threestate_lanes(plan: EnginePlan, ln: Lanes, F, B, ranks: torch.Tensor):
    """threeState tallies in lanes: transitions, per-kmer gapX tallies (edges
    entering shortGapX, by the k-mer rank of the cell) and the likelihood."""
    totals = totals_lanes(plan, ln, F, B)
    S = plan.n_states
    trans = torch.zeros((S, S), dtype=F.dtype, device=F.device)
    kmer_gap = torch.zeros(NUM_OF_KMERS + 2, dtype=F.dtype, device=F.device)
    flat = ranks.reshape(-1)
    for e, p in edge_posteriors_lanes(plan, ln, F, B, totals):
        trans[e.frm, e.to] += p.sum()
        if e.to == SHORT_GAP_X:
            kmer_gap.index_add_(0, flat, p.reshape(-1))
    return trans, kmer_gap[:NUM_OF_KMERS], likelihood(ln.valid, totals)


def threestate_expectations(plan: EnginePlan, inp: EngineInputs, F, B):
    """threeState signal EM tallies (cell_signal_updateTransAndKmerSkip-
    Expectations, pairwiseAligner.c:426-443): transitions + per-kmer tallies
    for edges entering shortGapX."""
    return threestate_lanes(plan, lanes(inp), to_lanes(F), to_lanes(B), inp.aux["rank"])


def discrete_expectations(plan: EnginePlan, inp: EngineInputs, F, B):
    """fiveState/symbol EM tallies (cell_updateExpectations,
    pairwiseAligner.c:407-424): transitions + per-(to, x, y) emission tallies
    for all edges; gaps involving N excluded."""
    ln, Fl, Bl, totals, trans = _setup(plan, inp, F, B)
    n_sym = 4
    emiss = torch.zeros((plan.n_states, n_sym, n_sym), dtype=F.dtype, device=F.device)
    sx, sy = inp.aux["sx"], inp.aux["sy"]
    sym_ok = (sx < n_sym) & (sy < n_sym)
    flat = (sx.clamp(0, n_sym - 1) * n_sym + sy.clamp(0, n_sym - 1)).reshape(-1)
    for e, p in edge_posteriors_lanes(plan, ln, Fl, Bl, totals):
        trans[e.frm, e.to] += p.sum()
        pe = torch.where(sym_ok, p, 0.0)
        emiss[e.to] += torch.zeros(n_sym * n_sym, dtype=F.dtype, device=F.device).index_add_(
            0, flat, pe.reshape(-1)).reshape(n_sym, n_sym)
    return trans, emiss, likelihood(inp.valid, totals)


def vanilla_expectations(plan: EnginePlan, inp: EngineInputs, F, B):
    """Vanilla skip-bin EM tallies (cell_signal_updateBetaAndAlphaProb,
    pairwiseAligner.c:478-498): beta bins [0,30) from match->shortGapX,
    alpha bins [30,60) from shortGapX->shortGapX."""
    ln, Fl, Bl, totals, _trans = _setup(plan, inp, F, B)
    bins = torch.zeros(2 * N_SKIP_BINS, dtype=F.dtype, device=F.device)
    flat = inp.aux["bin"].reshape(-1)
    for e, p in edge_posteriors_lanes(plan, ln, Fl, Bl, totals):
        if e.frm == MATCH and e.to == SHORT_GAP_X:
            bins.index_add_(0, flat, p.reshape(-1))
        if e.frm == SHORT_GAP_X and e.to == SHORT_GAP_X:
            bins.index_add_(0, flat + N_SKIP_BINS, p.reshape(-1))
    return bins, likelihood(inp.valid, totals)


def hdp_expectations(plan: EnginePlan, inp: EngineInputs, F, B, threshold: float):
    """threeStateHdp EM tallies (cell_signal_updateTransAndKmerSkip-
    Expectations2, pairwiseAligner.c:445-476): transitions + an assignment
    mask per MIDDLE edge into match where p >= threshold (at threshold 0
    every cell, off the band too, as the JAX engine).  Returns (trans,
    likelihood, assign_mask (n_mid, D, W), ranks, means): the ranks and
    means grids are the assignments' source, read in the masks' order."""
    ln, Fl, Bl, totals, trans = _setup(plan, inp, F, B)
    masks = []
    for e, p in edge_posteriors_lanes(plan, ln, Fl, Bl, totals):
        trans[e.frm, e.to] += p.sum()
        if e.src == SRC_MIDDLE and e.to == MATCH:
            masks.append(p >= threshold)
    return (trans, likelihood(inp.valid, totals), torch.stack(masks, dim=0),
            inp.aux["rank"], inp.aux["mean"])

