"""The threeStateHdp E-step on the device (port of em/pallas_em.py:449-760).

The reference's flagship trainable model (vanillaAlign.c:318-360, the HDP
branch).  What changes per iteration: the HDP density table (rebuilt by
Gibbs sampling after each M-step) and the 9 transition scalars.  What is
static per problem, packed once before the EM loop: the window scalars and
the k-mer rank and event mean of every grid x and y.  Each step builds E on
the device from the density table (``readpath.hdp_emissions``: the
interpolation of dir_proc_density, hdp.c:2577-2601, the raw density), runs
the forward and the stage-4 backward with one posterior channel for each
middle edge into match (``pgroups``), and compacts on the device, channel by
channel, the cells whose posterior passes the threshold
(``readpath.extract_compact``, pairwiseAligner.c:445-477): they become the
(k-mer, event mean) assignments that the next Gibbs chain samples, in the
order channel, problem, bucket.

A job with more passing cells than its K slots (or a diagonal of more than
16) is run again on the device, with the other such jobs of its bucket and
a slot for every cell of its window, so that every job uses the one
interpolation (the JAX package re-runs it through its host f64 engine).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.kmers import rank_to_kmer
from ..core.window import smooth_band
from ..engine import pipeline as pp
from ..engine import readpath
from ..engine.align import split_windows
from ..engine.plan import EnginePlan, _build_plan
from ..models.state_machines import (MATCH, SM3_NANOPORE_TRANSITIONS, SRC_MIDDLE,
                                     make_signal_sm3_hdp)
from ..ops import fb_kernels as fk
from .sm3_em import EmJob, _EmBudget, stream

# at a threshold of 0 every cell, masked ones included (posterior exactly
# 0.0), passes the >= test: the JAX package sends it to its host f64 engine,
# and so does the port (train_models routes it to the oracle's E-step)
THRESHOLD_ITEM = ("an assignment threshold of 0 runs on the f64 oracle's E-step "
                  "(train_models --engine host, the route --engine auto takes at 0), "
                  "not on the device buckets")


def _zero_density(ranks, means):
    return np.zeros(np.broadcast(ranks, means).shape)


class HdpBatch(NamedTuple):
    """A bucket's static tensors."""

    diag_scalars: torch.Tensor  # (B, Dp+1, 1, 8) int32
    d_last: torch.Tensor        # (B,) int32
    x0: torch.Tensor            # (B, Dp+1) int32
    rank: torch.Tensor          # (B, Lc) int32 row of the bucket's table per grid x
    meanp: torch.Tensor         # (B, Lc) f32 event mean per grid y


@dataclass
class HdpEmBucket:
    """One width bucket of stacked threeStateHdp problems."""

    plan: EnginePlan
    W: int
    Dp: int
    K: int                    # assignment slots of a problem and channel
    batch: HdpBatch           # on the device, or on the host when streamed
    rank_orig: np.ndarray     # (B, Lc) int32 k-mer rank per grid x
    meanp: np.ndarray         # (B, Lc) f32 event mean per grid y
    uniq: np.ndarray          # distinct ranks of the bucket (the table's rows)
    w0s: list                 # per problem its window's w0 (D,) int64
    ragged_left: np.ndarray
    ragged_right: np.ndarray
    resident: bool
    device: torch.device


def hdp_pgroups(plan: EnginePlan) -> tuple[tuple[int, ...], ...]:
    """One posterior channel per middle edge into match (pallas_em.py:509)."""
    return tuple((ei,) for ei, e in enumerate(plan.edges)
                 if e.src == SRC_MIDDLE and e.to == MATCH)


def collect_hdp_em_jobs(reads: list[dict], params, strand: str) -> list[EmJob]:
    """Like sm3_em.collect_sm3_em_jobs but for the HDP machine: no pore model,
    the emissions come from the density table; the reads are prepared with
    descaled events, as the reference queries its HDP."""
    from ..constants import KMER_LENGTH

    jobs = []
    for prep in reads:
        target, events, anchors, _sp = prep[strand]
        if len(events) == 0:
            continue
        lX = len(target) - KMER_LENGTH + 1
        for (x1, y1, x2, y2), band, rl, rr in split_windows(
                lX, len(events), anchors, params, True, True):
            jobs.append(EmJob(None, target[x1:x2 + KMER_LENGTH - 1], events[y1:y2],
                              band, rl, rr))
    return jobs


def build_hdp_em_buckets(jobs: list[EmJob], *, device: torch.device,
                         width_multiple: int = 128, threshold: float = 0.01,
                         max_assignments: int | None = None,
                         budget: _EmBudget | None = None) -> list[HdpEmBucket]:
    """Pack jobs into width-bucketed threeStateHdp problems (once, before the
    EM loop): only the window scalars, ranks and event means; E is built on
    the device at every step.  K = min(Dp W, 4 Dp + 512) assignment slots a
    problem and channel, or ``max_assignments``."""
    if threshold <= 0.0:
        raise ValueError(THRESHOLD_ITEM)
    if budget is None:
        budget = _EmBudget(device)
    wbands = [smooth_band(j.band, width_multiple=width_multiple) for j in jobs]
    cpu = torch.device("cpu")
    buckets = []
    for W, chunk in sorted(pp.launch_groups([wb.W for wb in wbands]),
                           key=lambda group: group[0]):
        Dp = max(wbands[i].n_diagonals for i in chunk)
        sms = [make_signal_sm3_hdp(_zero_density, jobs[i].target, jobs[i].events)
               for i in chunk]
        plan, (ds, d_last, _start, _end, _tp, x0) = pp.stack_window_scalars(
            [(sm, wbands[i], jobs[i].ragged_left, jobs[i].ragged_right)
             for sm, i in zip(sms, chunk)], Dp, cpu)
        rank, meanp = (np.stack(a) for a in zip(*(pp.hdp_inputs(sm, Dp + 2)
                                                  for sm in sms)))
        uniq = np.unique(rank)
        remap = np.searchsorted(uniq, rank).astype(np.int32)
        K = min(Dp * W, 4 * Dp + 512) if max_assignments is None else max_assignments
        batch, resident = budget.place(HdpBatch(
            ds, d_last, x0, torch.from_numpy(remap), torch.from_numpy(meanp)))
        buckets.append(HdpEmBucket(
            plan=plan, W=W, Dp=Dp, K=K, batch=batch, rank_orig=rank, meanp=meanp,
            uniq=uniq, w0s=[np.asarray(wbands[i].w0, dtype=np.int64) for i in chunk],
            ragged_left=np.array([jobs[i].ragged_left for i in chunk]),
            ragged_right=np.array([jobs[i].ragged_right for i in chunk]),
            resident=resident, device=device))
    return buckets


def _hdp_iteration_arrays(transitions: dict | None):
    """(tp_vec, start, ragged_start, end, ragged_end) f32 for a transitions
    dict, through the plan builder the problems used."""
    t = dict(SM3_NANOPORE_TRANSITIONS)
    if transitions:
        t.update(transitions)
    sm = make_signal_sm3_hdp(_zero_density, "ACGTACGTA", np.zeros((2, 3)), t)
    _plan, tp_scalar, cell_sources = _build_plan(sm, "exact")
    assert not cell_sources
    return (pp.finite_f32(tp_scalar), pp.finite_f32(sm.start), pp.finite_f32(sm.ragged_start),
            pp.finite_f32(sm.end), pp.finite_f32(sm.ragged_end))


def bucket_step(b: HdpEmBucket, tab: torch.Tensor, g0: float, dg: float, tp_vec, start,
                end, threshold: float, rows=None, K: int | None = None,
                L: int | None = None):
    """One bucket's E-step (or that of its problems ``rows``): E from the
    density table rows ``tab`` (the bucket's distinct ranks), the forward,
    the stage-4 backward with the pgroups channels, and per channel the
    compacted assignment cells.  Returns (stats (B, 128) f32, [count | K
    flat cell indices] (B, P, K + 1) int32)."""
    batch = stream(b.batch, b.resident, b.device)
    if rows is not None:
        batch = HdpBatch(*(t[rows] for t in batch))
        start, end = start[rows], end[rows]
    B = batch.d_last.shape[0]
    E = readpath.hdp_emissions(tab, g0, dg, batch.rank, batch.meanp,
                               batch.diag_scalars[:, :b.Dp, 0, fk.DS_W0], batch.d_last, b.W)
    prob = pp.WindowProblem(E, batch.diag_scalars, batch.d_last, start, end,
                            tp_vec.expand(B, -1).contiguous(), batch.x0)
    p, _totals, _exits, _gacc, stats = pp.run_window(b.plan, b.W, prob, stages=4,
                                                     pgroups=hdp_pgroups(b.plan))
    del E, prob
    K = b.K if K is None else K
    packs = []
    for c in range(p.shape[2]):
        cnt, outi = readpath.extract_compact(p[:, :, c, :], threshold, K, L)
        packs.append(torch.cat([cnt[:, None], outi], dim=1))
    return stats, torch.stack(packs, dim=1)


def hdp_em_step(buckets: list[HdpEmBucket], nhdp, transitions: dict | None,
                threshold: float):
    """One full threeStateHdp E-step over all buckets against the current HDP
    densities and transitions.  Returns (trans (3, 3) f64, likelihood,
    k-mer assignments, event-mean assignments), the tallies summed in f64
    and the assignments concatenated in the order channel, problem, bucket
    (the JAX hdp_em_step's order).  The problems whose assignments
    overflowed their slots are run again, a bucket's together, with a slot
    for every window cell."""
    if not buckets:
        return np.zeros((3, 3)), 0.0, [], []
    if threshold <= 0.0:
        raise ValueError(THRESHOLD_ITEM)
    table = nhdp.density_table()
    grid = nhdp.hdp.grid
    g0, dg = float(grid[0]), float(grid[1] - grid[0]) or 1.0
    tp_vec, sv, rsv, ev, rev = _hdp_iteration_arrays(transitions)

    def on(a, device):
        return pp.to_device(np.ascontiguousarray(a, dtype=np.float32), device)

    pending = []
    for b in buckets:
        tab = on(np.maximum(table[np.minimum(b.uniq, table.shape[0] - 1)], 0.0), b.device)
        start = on(np.where(b.ragged_left[:, None], rsv, sv), b.device)
        end = on(np.where(b.ragged_right[:, None], rev, ev), b.device)
        args = (tab, g0, dg, on(tp_vec, b.device), start, end, threshold)
        pending.append((b, args, *bucket_step(b, *args)))
    # one copy: the stats travel as their int32 bit patterns beside the cells
    host = pp.to_host([t for _b, _a, st, cells in pending
                                     for t in (st.view(torch.int32), cells)])

    trans = np.zeros((3, 3))
    lik = 0.0
    kmers, means = [], []
    for bi_, (b, args, _s, _c) in enumerate(pending):
        stats, cells = host[2 * bi_].view(np.float32), host[2 * bi_ + 1]
        over = np.flatnonzero((cells[:, :, 0] > b.K).any(axis=1))
        if len(over):   # again with a slot for every cell, L = W never drops a lane
            _st, again = bucket_step(b, *args, rows=over.tolist(), K=b.Dp * b.W, L=b.W)
            full = dict(zip(over.tolist(), again.cpu().numpy()))
        Lc = b.rank_orig.shape[1]
        for bi, w0 in enumerate(b.w0s):
            for ei, e in enumerate(b.plan.edges):
                trans[e.frm, e.to] += stats[bi, ei]
            lik += float(stats[bi, fk.LIK_LANE])
            per_c = full[bi] if bi in over else cells[bi]
            for c in range(per_c.shape[0]):
                fi = per_c[c, 1:1 + per_c[c, 0]].astype(np.int64)
                d = fi // b.W
                j = fi - d * b.W
                keep = d < len(w0)
                d, j = d[keep], j[keep]
                xmy = w0[d] + 2 * j
                x = (d + xmy) >> 1
                y = (d - xmy) >> 1
                ranks, inv = np.unique(b.rank_orig[bi, np.clip(x, 0, Lc - 1)],
                                       return_inverse=True)
                names = np.array([rank_to_kmer(int(r)) for r in ranks], dtype=object)
                kmers.extend(names[inv].tolist())
                means.extend(b.meanp[bi, np.clip(y, 0, Lc - 1)].tolist())
    return trans, lik, kmers, means

