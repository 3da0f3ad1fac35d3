"""High-level alignment API: anchors -> splits -> banded FB -> aligned pairs
(port of ``cpecan_signal_tpu/engine/align.py``; ``window_grids`` lives in
engine/window.py and stays importable here).

An alignment problem is split into independent sub-matrices at large anchor
gaps (getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps,
pairwiseAligner.c:1356-1484); each split is one ``SplitJob``, the unit the
device-batched path stacks across strands and reads.  ``align_events_to_target``
and ``align_sequence_pair`` run the splits one by one through the f64
oracle (engine/fb.py) on one device and shift the pairs back to global
coordinates (getAlignedPairsUsingAnchors, pairwiseAligner.c:1356-1484).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..constants import KMER_LENGTH, PAIR_ALIGNMENT_PROB_1
from ..core.anchors import anchors_in_window, get_split_points
from ..core.band import band_construct
from ..models.params import AlignmentParams
from ..models.state_machines import StateMachine
from ..utils.device import resolve_device
from . import fb
from .window import window_grids  # noqa: F401  (re-exported)


@dataclass
class AlignedPairs:
    """Posterior-aligned pairs: prob quantized to int(p * 1e7)."""

    probs: np.ndarray  # int64 (n,)
    x: np.ndarray      # int64 (n,) sequence coordinates
    y: np.ndarray      # int64 (n,)

    def as_tuples(self) -> list[tuple[int, int, int]]:
        return list(zip(self.probs.tolist(), self.x.tolist(), self.y.tolist()))

    @property
    def score(self) -> float:
        """Mean match posterior x100 (scoreByPosteriorProbabilityIgnoringGaps,
        vanillaAlign.c:172-177)."""
        if len(self.probs) == 0:
            return 0.0
        return 100.0 * self.probs.sum() / (len(self.probs) * PAIR_ALIGNMENT_PROB_1)


def _extract_pairs(p_grid: np.ndarray, x: np.ndarray, y: np.ndarray,
                   threshold: float, off_x: int, off_y: int):
    mask = p_grid >= threshold
    probs = np.floor(p_grid[mask] * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
    xs = x[mask].astype(np.int64) - 1 + off_x
    ys = y[mask].astype(np.int64) - 1 + off_y
    return probs, xs, ys


@dataclass
class SplitJob:
    """One split sub-problem, ready for (batched) banded FB."""

    sm: StateMachine
    band: object          # core.band.Band
    off_x: int
    off_y: int
    ragged_left: bool
    ragged_right: bool


def split_windows(lX: int, lY: int, anchors: np.ndarray, params: AlignmentParams,
                  ragged_left: bool, ragged_right: bool):
    """The split windows of one problem: ((x1, y1, x2, y2), band, ragged
    left, ragged right) of each, in order (em/expectation_driver._split_loop
    of the JAX package).  Inner splits are ragged on their inner sides."""
    anchors = np.asarray(anchors, dtype=np.int64).reshape(-1, 2)
    splits = get_split_points(anchors, lX, lY, params.split_matrix_bigger_than_this,
                              ragged_left, ragged_right,
                              max_gap_min_dim=params.max_gap_min_dim)
    for i, (x1, y1, x2, y2) in enumerate(splits):
        sub_anchors = anchors_in_window(anchors, x1, y1, x2, y2)
        band = band_construct(sub_anchors, x2 - x1, y2 - y1, params.diagonal_expansion)
        yield ((x1, y1, x2, y2), band, ragged_left or i > 0,
               ragged_right or i < len(splits) - 1)


def collect_split_jobs(
    make_sm: Callable[[str, np.ndarray], StateMachine],
    target_seq: str,
    events: np.ndarray,
    anchors: np.ndarray,
    params: AlignmentParams,
    *,
    ragged_left: bool = True,
    ragged_right: bool = True,
    kmers: bool = True,
) -> list[SplitJob]:
    """Split/band/state-machine prep of one strand's alignment, without
    running the engine.  With ``kmers`` the matrix's x axis is the k-mers of
    ``target_seq`` (a signal target), else its symbols."""
    k = KMER_LENGTH - 1 if kmers else 0
    return [SplitJob(make_sm(target_seq[x1:x2 + k], events[y1:y2]), band, x1, y1, rl, rr)
            for (x1, y1, x2, y2), band, rl, rr in split_windows(
                len(target_seq) - k, len(events), anchors, params, ragged_left, ragged_right)]


def _split_pairs(sm, band, x1: int, y1: int, ragged_left: bool, ragged_right: bool,
                 params: AlignmentParams, device, dtype, total_mode: str, multi_match: bool):
    """One split through the oracle -> its pairs in global coordinates."""
    plan, inp = fb.prepare_inputs(sm, band, ragged_left=ragged_left,
                                  ragged_right=ragged_right, device=device, dtype=dtype)
    F = fb.forward(plan, inp)
    B = fb.backward(plan, inp)
    x, y = inp.x.cpu().numpy(), inp.y.cpu().numpy()
    if multi_match:
        p_states, _ = fb.posterior_multi_match_probs(plan, inp, F, B)
        probs, xs, ys = fb.extract_multi_pairs(p_states.cpu().numpy(), x, y,
                                               params.threshold)
        return probs, xs + x1, ys + y1
    p_grid, _totals = fb.posterior_match_probs(plan, inp, F, B, total_mode)
    return _extract_pairs(p_grid.cpu().numpy(), x, y, params.threshold, x1, y1)


def _concat(parts) -> AlignedPairs:
    if not parts:
        z = np.zeros(0, dtype=np.int64)
        return AlignedPairs(z, z, z)
    return AlignedPairs(*(np.concatenate(c) for c in zip(*parts)))


def align_events_to_target(
    make_sm: Callable[[str, np.ndarray], StateMachine],
    target_seq: str,
    events: np.ndarray,
    anchors: np.ndarray,
    params: AlignmentParams,
    *,
    ragged_left: bool = True,
    ragged_right: bool = True,
    device: torch.device | None = None,
    dtype=torch.float64,
    total_mode: str = "per_diagonal",
    multi_match: bool = False,
) -> AlignedPairs:
    """Align an event sequence to a nucleotide target with anchor banding,
    split by split through the f64 oracle on ``device`` (default: the
    resolved device, the card unless the caller asks for the CPU).

    make_sm(target_subseq, events_subarray) builds the state machine for one
    split (splits re-slice the raw sequences exactly like sequence_sliceFcn,
    pairwiseAligner.c:1383-1384).  multi_match selects the echelon
    multi-state posterior extraction (diagonalCalculationMultiPosteriorMatchProbs).
    """
    device = resolve_device() if device is None else device
    return _concat([_split_pairs(job.sm, job.band, job.off_x, job.off_y, job.ragged_left,
                                 job.ragged_right, params, device, dtype, total_mode,
                                 multi_match)
                    for job in collect_split_jobs(make_sm, target_seq, events, anchors, params,
                                                  ragged_left=ragged_left,
                                                  ragged_right=ragged_right)])


def collect_symbol_split_jobs(make_sm, seq_x: str, seq_y: str, anchors: np.ndarray,
                              params: AlignmentParams, *, ragged_left: bool,
                              ragged_right: bool) -> list[SplitJob]:
    """Split a nucleotide-pair problem (raw sequence lengths, no k-mer
    shortening) into SplitJobs."""
    return collect_split_jobs(make_sm, seq_x, seq_y, anchors, params, ragged_left=ragged_left,
                              ragged_right=ragged_right, kmers=False)


def align_sequence_pair(
    make_sm: Callable[[str, str], StateMachine],
    seq_x: str,
    seq_y: str,
    anchors: np.ndarray,
    params: AlignmentParams,
    *,
    ragged_left: bool = False,
    ragged_right: bool = False,
    device: torch.device | None = None,
    dtype=torch.float64,
    total_mode: str = "per_diagonal",
) -> AlignedPairs:
    """Nucleotide-nucleotide variant (the cPecanRealign path): lX/lY are the
    raw sequence lengths; make_sm(sub_x, sub_y) builds a symbol machine."""
    device = resolve_device() if device is None else device
    return _concat([_split_pairs(job.sm, job.band, job.off_x, job.off_y, job.ragged_left,
                                 job.ragged_right, params, device, dtype, total_mode, False)
                    for job in collect_symbol_split_jobs(
                        make_sm, seq_x, seq_y, anchors, params,
                        ragged_left=ragged_left, ragged_right=ragged_right)])
