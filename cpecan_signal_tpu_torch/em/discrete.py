"""Device-batched fiveState (nucleotide) E-step and batched realignment (port
of em/discrete_pallas.py).

The reference distributes nucleotide EM as jobs that each run
``cPecanRealign --outputExpectations`` over an alignment chunk of at most
1 Mb (cPecanEm.py:107-242, cPecanRealign.c:556-645).  Here every CIGAR
record's split jobs are stacked into buckets of the symbol lane
(engine/readpath.py: codes and window stream up, E gathered on the device);
the stage-4 backward kernel's stats lanes carry the transition tallies and
the likelihood, and its edge-group posterior channels (``pgroups``, one per
to-state) the per-state posterior grids, from which the per-(state,
symbol-pair) emission tallies are reduced on the device
(cell_updateExpectations, pairwiseAligner.c:407-424).  Nothing grid-sized
crosses to the host.

Per-job results are returned separately and summed by the caller in job
order.  Each job's tallies are computed without atomics, in an order that
depends only on the job (one block per problem in the kernel, adjacent-pair
sums over its lanes and diagonals here), so they are the same bit for bit
however the jobs are bucketed, and from run to run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.anchors import anchors_in_window, get_split_points
from ..core.band import band_construct
from ..core.window import smooth_band
from ..engine import pipeline as pp
from ..engine import readpath
from ..engine.align import AlignedPairs, SplitJob
from ..models.params import AlignmentParams
from ..ops import fb_kernels as fk

N_SYM = 4


def collect_symbol_split_jobs(make_sm, seq_x: str, seq_y: str, anchors: np.ndarray,
                              params: AlignmentParams, *, ragged_left: bool,
                              ragged_right: bool) -> list[SplitJob]:
    """Split a nucleotide-pair problem (raw sequence lengths, no k-mer
    shortening) into SplitJobs: the symbol analogue of
    engine/align.collect_split_jobs."""
    lX, lY = len(seq_x), len(seq_y)
    anchors = np.asarray(anchors, dtype=np.int64).reshape(-1, 2)
    splits = get_split_points(anchors, lX, lY, params.split_matrix_bigger_than_this,
                              ragged_left, ragged_right,
                              max_gap_min_dim=params.max_gap_min_dim)
    jobs = []
    for i, (x1, y1, x2, y2) in enumerate(splits):
        sub_anchors = anchors_in_window(anchors, x1, y1, x2, y2)
        band = band_construct(sub_anchors, x2 - x1, y2 - y1, params.diagonal_expansion)
        jobs.append(SplitJob(make_sm(seq_x[x1:x2], seq_y[y1:y2]), band, x1, y1,
                             ragged_left or i > 0, ragged_right or i < len(splits) - 1))
    return jobs


def _to_state_pgroups(plan) -> tuple[tuple[int, ...], ...]:
    """One edge group per state: the edges into it."""
    return tuple(tuple(ei for ei, e in enumerate(plan.edges) if e.to == s)
                 for s in range(plan.n_states))


def pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by adjacent pairs, level by level, an odd level
    padded with one 0.0.  Elementwise adds in a fixed order: the result
    depends on no launch configuration, and zeros appended to the axis leave
    it unchanged bit for bit."""
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = torch.nn.functional.pad(v, (0, 1))
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def symbol_pair_tallies(p: torch.Tensor, w0: torch.Tensor, cxp: torch.Tensor,
                        cyp: torch.Tensor) -> torch.Tensor:
    """Per-(state, symbol-pair) emission tallies (B, S, 16) from the
    per-to-state posterior channels p (B, Dp, S, W) (em/discrete_pallas.py:
    93-110): a cell's key is 4 cx + cy of its codes (readpath.cell_codes),
    and a pair with an N (code 4) is dropped.  The 16 masked sums run in a
    fixed key order, each over the lanes and then the diagonals by
    ``pairwise_sum``: no atomics."""
    sx, sy = readpath.cell_codes(cxp, cyp, w0, p.shape[3])
    key = torch.where((sx < N_SYM) & (sy < N_SYM), sx * N_SYM + sy, N_SYM * N_SYM)
    key = key.to(torch.uint8)[:, :, None, :]                     # (B, Dp, 1, W)
    del sx, sy
    tallies = []
    for c in range(N_SYM * N_SYM):
        lanes = pairwise_sum(torch.where(key == c, p, 0.0))      # (B, Dp, S)
        tallies.append(pairwise_sum(lanes.transpose(1, 2)))      # (B, S)
    return torch.stack(tallies, dim=2)


def em_bucket_step(plan, W: int, Dp: int, staged, chunk, device: torch.device
                   ) -> torch.Tensor:
    """One bucket's E-step on ``device``: staging and upload, E gathered on
    the device, forward and stage-4 backward with one posterior channel per
    to-state, the symbol-pair tallies.  Returns (B, 128 + S * 16) f32
    [stats | emission tallies] per problem; the bucket's E, F and P are
    freed on return."""
    bufs, _n_cy = readpath.stage_symbol_bucket(staged, chunk, device)
    sj0 = staged[chunk[0]][1]
    n_tp, S = len(sj0.tp_scalar), len(sj0.start)
    prob, cxp, cyp, _real = readpath.symbol_problem(W, Dp, n_tp, S, *bufs)
    p, _totals, _exits, _gacc, stats = pp.run_window(plan, W, prob, stages=4,
                                                     pgroups=_to_state_pgroups(plan))
    w0 = prob.diag_scalars[:, :Dp, 0, fk.DS_W0]
    del prob
    emiss = symbol_pair_tallies(p, w0, cxp, cyp)
    return torch.cat([stats, emiss.reshape(len(chunk), -1)], dim=1)


def discrete_expectations_batched(jobs: list[SplitJob], *, device: torch.device,
                                  width_multiple: int = 128, timing: dict | None = None):
    """Every job's fiveState EM tallies through the device path, bucket by
    bucket (each freed before the next is built), collected with one copy.
    Returns a list (per job, input order) of (trans (S, S) f64, emiss (S, 4,
    4) f64, likelihood float).  ``timing`` gains the number of buckets."""
    staged = []
    for i, j in enumerate(jobs):
        st = readpath.stage_symbol_job(j, smooth_band(j.band, width_multiple=width_multiple))
        if st is None:
            raise ValueError(f"job {i} ({j.sm.spec.name}) has no bound symbol machine")
        staged.append((i, *st))
    buckets = readpath.symbol_buckets(staged)
    pending = [(plan, chunk, em_bucket_step(plan, W, Dp, staged, chunk, device))
               for plan, W, Dp, chunk in buckets]
    if timing is not None:
        timing["buckets"] = timing.get("buckets", 0) + len(buckets)
    packed_of = readpath._collect_packed([h for _p, _c, h in pending])
    out = [None] * len(jobs)
    for (plan, chunk, _h), packed in zip(pending, packed_of):
        packed = packed.astype(np.float64)
        S = plan.n_states
        emiss = packed[:, fk.STATS_LANES:].reshape(-1, S, N_SYM, N_SYM)
        for bi, si in enumerate(chunk):
            trans = np.zeros((S, S))
            for ei, e in enumerate(plan.edges):
                trans[e.frm, e.to] += packed[bi, ei]
            out[staged[si][0]] = (trans, emiss[bi], float(packed[bi, fk.LIK_LANE]))
    return out


# ---------------------------------------------------------------------------
# Batched realignment (posterior pairs for many CIGAR records at once)
# ---------------------------------------------------------------------------

@dataclass
class StagedRecord:
    """realign_record's head (anchors, subsequences, rebase), held for the
    batched posterior pass and the per-record tail."""

    rec: object
    sub_x: str
    sub_y: str
    anchors_all: np.ndarray
    anchors: np.ndarray
    shift1: int
    shift2: int
    flip1: bool
    flip2: bool
    jobs: slice              # range into the flat job list


def batched_pairs_for_records(staged_jobs: list[SplitJob], threshold: float, *,
                              device: torch.device, timing: dict | None = None
                              ) -> list[AlignedPairs]:
    """Posterior pairs for a flat list of symbol split jobs through the
    device batch path (engine/batch_align)."""
    from ..engine.batch_align import batch_align_jobs

    return batch_align_jobs(staged_jobs, threshold, device=device, timing=timing)
