"""Device-batched fiveState (nucleotide) E-step and batched realignment (port
of em/discrete_pallas.py).

The reference distributes nucleotide EM as jobs that each run
``cPecanRealign --outputExpectations`` over an alignment chunk of at most
1 Mb (cPecanEm.py:107-242, cPecanRealign.c:556-645).  Here every CIGAR
record's split jobs are stacked into buckets of the symbol lane
(engine/readpath.py: codes and window rows up, E gathered on the device);
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

The E-step's spans and counters (``utils/observability``): the host
staging ("nem.stage": every job's codes and window band, the bucketing and
each bucket's upload), the host blocked on the card for the results
("nem.device_wait"), and per bucket "nem.jobs", "nem.diagonals" (each job's
own), "nem.chain_diagonals" (its longest job's own: the launch's serial
chain), "nem.cells_band" (its true band's cells), "nem.cells_lane" (B x Dp x
W, the launch's lanes) and "nem.sm_slots" (SMs x the recursion blocks an SM
holds x Dp; 0 off a card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.window import smooth_band
from ..engine import pipeline as pp
from ..engine import readpath
from ..engine.align import AlignedPairs, SplitJob, collect_symbol_split_jobs  # noqa: F401
from ..ops import fb_kernels as fk
from ..utils.observability import counters, timed

N_SYM = 4
E_CHANNELS = 3       # the symbol lane's E: gapX, match, gapY (readpath.symbol_emissions)


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


def em_bucket_step(plan, W: int, Dp: int, staged, chunk, device: torch.device,
                   timing: dict | None = None) -> torch.Tensor:
    """One bucket's E-step on ``device``: staging and upload (span
    "nem.stage"), E gathered on the device, forward and stage-4 backward
    with one posterior channel per to-state, the symbol-pair tallies.
    Returns (B, 128 + S * 16) f32 [stats | emission tallies] per problem;
    the bucket's E, F and P are freed on return."""
    with timed("nem.stage", timing):
        tables, bucket, _n_cy = readpath.stage_symbol_bucket(staged, chunk, Dp, device)
    prob = readpath.symbol_problem(W, tables, bucket)
    p, _totals, _exits, _gacc, stats = pp.run_window(plan, W, prob, stages=4,
                                                     pgroups=_to_state_pgroups(plan))
    w0 = prob.diag_scalars[:, :Dp, 0, fk.DS_W0]
    del prob
    emiss = symbol_pair_tallies(p, w0, bucket.cx, bucket.cy)
    return torch.cat([stats, emiss.reshape(len(chunk), -1)], dim=1)


def _bucket_counts(staged, chunk, W: int, Dp: int) -> dict:
    """A bucket's counters, from its jobs' window bands."""
    bands = [staged[si][1].wband for si in chunk]
    return {"nem.jobs": len(chunk), "nem.diagonals": sum(b.n_diagonals for b in bands),
            "nem.chain_diagonals": max(b.n_diagonals for b in bands),
            "nem.cells_band": sum(int(((b.xmyR - b.xmyL) // 2 + 1).sum()) for b in bands),
            "nem.cells_lane": len(chunk) * Dp * W}


def discrete_expectations_batched(jobs: list[SplitJob], *, device: torch.device,
                                  width_multiple: int = 128, timing: dict | None = None):
    """Every job's fiveState EM tallies through the device path, bucket by
    bucket (each freed before the next is built), collected with one copy.
    Returns a list (per job, input order) of (trans (S, S) f64, emiss (S, 4,
    4) f64, likelihood float).  ``timing`` gains the number of buckets and
    the spans and counters of the module's docstring."""
    with timed("nem.stage", timing):
        staged = []
        for i, j in enumerate(jobs):
            st = readpath.stage_symbol_job(j, smooth_band(j.band,
                                                          width_multiple=width_multiple))
            if st is None:
                raise ValueError(f"job {i} ({j.sm.spec.name}) has no bound symbol machine")
            staged.append((i, *st))
        buckets = readpath.symbol_buckets(staged)
    pending = []
    for plan, W, Dp, chunk in buckets:
        pending.append((plan, chunk, em_bucket_step(plan, W, Dp, staged, chunk, device,
                                                    timing)))
        for name, n in _bucket_counts(staged, chunk, W, Dp).items():
            counters.add(name, n, timing)
        counters.add("nem.sm_slots", Dp * fk.sm_slots_per_diagonal(
            device, plan.n_states, E_CHANNELS, W), timing)
    counters.add("buckets", len(buckets), timing)
    with timed("nem.device_wait", timing):
        packed_of = pp.to_host([h for _p, _c, h in pending])
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

def batched_pairs_for_records(staged_jobs: list[SplitJob], threshold: float, *,
                              device: torch.device, timing: dict | None = None
                              ) -> list[AlignedPairs]:
    """Posterior pairs for a flat list of symbol split jobs through the
    device batch path (engine/batch_align)."""
    from ..engine.batch_align import batch_align_jobs

    return batch_align_jobs(staged_jobs, threshold, device=device, timing=timing)
