"""Split jobs and aligned-pair records (jax-free copies of engine/align.py:26-94;
``window_grids`` lives in engine/window.py and stays importable here).

An alignment problem is split into independent sub-matrices at large anchor
gaps (getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps,
pairwiseAligner.c:1356-1484); each split is one ``SplitJob``, the unit the
device-batched path stacks across strands and reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..constants import KMER_LENGTH, PAIR_ALIGNMENT_PROB_1
from ..core.anchors import anchors_in_window, get_split_points
from ..core.band import band_construct
from ..models.params import AlignmentParams
from ..models.state_machines import StateMachine
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


def collect_split_jobs(
    make_sm: Callable[[str, np.ndarray], StateMachine],
    target_seq: str,
    events: np.ndarray,
    anchors: np.ndarray,
    params: AlignmentParams,
    *,
    ragged_left: bool = True,
    ragged_right: bool = True,
) -> list[SplitJob]:
    """Split/band/state-machine prep of one strand's alignment, without
    running the engine."""
    lX = len(target_seq) - KMER_LENGTH + 1
    lY = len(events)
    anchors = np.asarray(anchors, dtype=np.int64).reshape(-1, 2)
    splits = get_split_points(anchors, lX, lY, params.split_matrix_bigger_than_this,
                              ragged_left, ragged_right,
                              max_gap_min_dim=params.max_gap_min_dim)
    jobs = []
    for i, (x1, y1, x2, y2) in enumerate(splits):
        sub_target = target_seq[x1: x2 + KMER_LENGTH - 1]
        sub_events = events[y1:y2]
        sub_anchors = anchors_in_window(anchors, x1, y1, x2, y2)
        band = band_construct(sub_anchors, x2 - x1, y2 - y1, params.diagonal_expansion)
        jobs.append(SplitJob(make_sm(sub_target, sub_events), band, x1, y1,
                             ragged_left or i > 0,
                             ragged_right or i < len(splits) - 1))
    return jobs
