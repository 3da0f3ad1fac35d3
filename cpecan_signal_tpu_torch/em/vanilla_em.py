"""The vanilla (skip-bin) E-step on the device (port of
em/pallas_em.py:276-446).

The vanilla machine's per-cell transitions are functions of the k-mer skip
bin (stateMachine.c:1368-1409), and the M-step changes only the 60-bin
vector (vanillaHmm_loadSkipProbsIntoStateMachine, continuousHmm.c:457-466).
So every read's split jobs are packed once, before the EM loop, into
width-bucketed generic window problems whose emission channels are static,
with a skip-bin grid (the bin of every window cell) and the bin keys of the
stage-4 window tallies beside them.  Each iteration regenerates the per-bin
log tables from the trained bins (models.state_machines
.vanilla_transition_tables), gathers them into E's transition channels on
the device, and runs the forward and the stage-4 backward with two window
groups: the M->X (beta) and X->X (alpha) edge posteriors per x column, whose
exits and lane remainders are then tallied per skip bin.

The per-bin tallies are per-bin masked sums in a fixed order
(em/discrete.pairwise_sum), with no atomics, one row per job; the rows are
summed on the host in f64 in job order.  So the tallies are the same bit
for bit however the jobs are bucketed, and from run to run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..constants import N_SKIP_BINS
from ..core.window import smooth_band
from ..engine import pipeline as pp
from ..engine.plan import EnginePlan, plan_key_names
from ..engine.window import window_grids
from ..models.state_machines import (MATCH, SHORT_GAP_X, make_signal_vanilla,
                                     vanilla_transition_tables)
from ..ops import fb_kernels as fk
from .discrete import pairwise_sum
from .sm3_em import EmJob, _EmBudget, stream

N_OUT = 2 * N_SKIP_BINS + 1   # per job: beta bins, alpha bins, likelihood


class VanillaBatch(NamedTuple):
    """A bucket's tensors: the window problem (E's transition channels are
    rewritten every step), the skip bin of every window cell (sentinel
    N_SKIP_BINS past the last diagonal) and the bin keys of the window
    tallies: of exits[d] (the column leaving at diagonal d) and of lane j of
    gacc."""

    E: torch.Tensor             # (B, Dp+2, C+T, W) f32
    diag_scalars: torch.Tensor  # (B, Dp+1, 1, 8) int32
    d_last: torch.Tensor        # (B,) int32
    start: torch.Tensor         # (B, S) f32
    end: torch.Tensor           # (B, S) f32
    tp_scalar: torch.Tensor     # (B, n) f32
    x0: torch.Tensor            # (B, Dp+1) int32
    bin_grid: torch.Tensor      # (B, Dp+2, W) uint8
    exit_bin: torch.Tensor      # (B, Dp) uint8
    gacc_bin: torch.Tensor      # (B, W) uint8


@dataclass
class VanillaEmBucket:
    """One width bucket of stacked vanilla problems."""

    plan: EnginePlan
    W: int
    batch: VanillaBatch      # on the device, or on the host when streamed
    cell_keys: list          # the transition key of each per-cell channel
    strand_name: str
    jobs: list               # indices of the bucket's jobs in the job list
    resident: bool
    device: torch.device


def vanilla_wgroups(plan: EnginePlan) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The stage-4 window groups of the vanilla E-step: (beta, alpha), the
    M->X and the X->X edges (pallas_em._vanilla_wgroups)."""
    beta = tuple(ei for ei, e in enumerate(plan.edges)
                 if e.frm == MATCH and e.to == SHORT_GAP_X)
    alpha = tuple(ei for ei, e in enumerate(plan.edges)
                  if e.frm == SHORT_GAP_X and e.to == SHORT_GAP_X)
    assert beta and alpha
    return beta, alpha


def _bin_keys(sm, wband, x0: np.ndarray, Dp: int):
    """(bin grid (Dp+2, W), exit keys (Dp,), gacc keys (W,)) uint8 of one
    problem: the cell grid clipped like prepare_window_inputs' x_idx, rows
    past the last diagonal the sentinel; an x outside [1, lX] carries no
    mass and keys the sentinel."""
    D, W, lX = wband.n_diagonals, wband.W, wband.lX
    x, _y, _valid = window_grids(wband)
    bins = np.full((Dp + 2, W), N_SKIP_BINS, dtype=np.uint8)
    bins[:D] = sm.skip_bin_idx[np.clip(x - 1, -1, max(lX - 1, -1)) + 1]
    xbin = np.full(lX + 2, N_SKIP_BINS, dtype=np.uint8)
    xbin[1:lX + 1] = sm.skip_bin_idx[1:lX + 1]
    exits = xbin[np.clip(x0[:Dp] + (W - 1), 0, lX + 1)]
    gacc = xbin[np.clip(x0[0] + np.arange(W), 0, lX + 1)]
    return bins, exits, gacc


def build_vanilla_em_buckets(jobs: list[EmJob], strand: str, *, device: torch.device,
                             width_multiple: int = 128,
                             budget: _EmBudget | None = None) -> list[VanillaEmBucket]:
    """Pack jobs into width-bucketed vanilla problems (once, before the EM
    loop): buckets of one window width (pipeline.launch_groups), in
    increasing width, each padded to its longest job.  ``strand`` is 't' or
    'c' (the vanilla strand defaults); ``budget`` (shared across strands by
    the caller) decides which buckets stay on the device."""
    if budget is None:
        budget = _EmBudget(device)
    strand_name = "template" if strand == "t" else "complement"
    wbands = [smooth_band(j.band, width_multiple=width_multiple) for j in jobs]
    cpu = torch.device("cpu")
    buckets = []
    for W, chunk in sorted(pp.launch_groups([wb.W for wb in wbands]),
                           key=lambda group: group[0]):
        sms = [make_signal_vanilla(jobs[i].pore, jobs[i].target, jobs[i].events,
                                   strand_name) for i in chunk]
        plan, prob = pp.pack_window_bucket(
            [(sm, wbands[i], jobs[i].ragged_left, jobs[i].ragged_right)
             for sm, i in zip(sms, chunk)], cpu)
        Dp = prob.diag_scalars.shape[1] - 1
        keys = [_bin_keys(sm, wbands[i], prob.x0[bi].numpy(), Dp)
                for bi, (sm, i) in enumerate(zip(sms, chunk))]
        batch, resident = budget.place(VanillaBatch(
            *prob, *(torch.from_numpy(np.stack(col)) for col in zip(*keys))))
        buckets.append(VanillaEmBucket(
            plan=plan, W=W, batch=batch, cell_keys=plan_key_names(sms[0])[1],
            strand_name=strand_name, jobs=chunk, resident=resident, device=device))
    return buckets


def bin_tallies(exits: torch.Tensor, gacc: torch.Tensor, exit_bin: torch.Tensor,
                gacc_bin: torch.Tensor) -> torch.Tensor:
    """Per-job skip-bin tallies (B, G * N_SKIP_BINS) of the window groups'
    exits (B, Dp, G) and lane remainders gacc (B, G, W): bin k of group g
    sums the exits whose column keys k, then the lanes that key k, each by
    ``pairwise_sum`` (fixed-order elementwise adds; the sentinel bin is
    dropped)."""
    k = torch.arange(N_SKIP_BINS, device=exits.device, dtype=torch.uint8)
    ex_mask = exit_bin[:, None, :] == k[None, :, None]        # (B, bins, Dp)
    ga_mask = gacc_bin[:, None, :] == k[None, :, None]        # (B, bins, W)
    out = []
    for g in range(exits.shape[2]):
        out.append(pairwise_sum(torch.where(ex_mask, exits[:, None, :, g], 0.0))
                   + pairwise_sum(torch.where(ga_mask, gacc[:, None, g, :], 0.0)))
    return torch.cat(out, dim=1)


def bucket_step(bucket: VanillaEmBucket, tables: torch.Tensor) -> torch.Tensor:
    """One bucket's E-step with the per-bin tables (T, N_SKIP_BINS + 1) f32
    of its transition channels: the tables gathered into E through the bin
    grid (in place), the forward and the stage-4 backward with the (beta,
    alpha) window groups.  Returns (B, N_OUT) f32 per job: beta tallies,
    alpha tallies, likelihood."""
    b = stream(bucket.batch, bucket.resident, bucket.device)
    C = bucket.plan.n_eclasses
    cells = b.bin_grid.long()
    for c in range(tables.shape[0]):
        b.E[:, :, C + c, :] = tables[c][cells]
    del cells
    _p, _totals, exits, gacc, stats = pp.run_window(
        bucket.plan, bucket.W, pp.WindowProblem(*b[:7]), stages=4,
        wgroups=vanilla_wgroups(bucket.plan))
    return torch.cat([bin_tallies(exits, gacc, b.exit_bin, b.gacc_bin),
                      stats[:, fk.LIK_LANE:fk.LIK_LANE + 1]], dim=1)


def vanilla_em_step(buckets: list[VanillaEmBucket], bins: np.ndarray):
    """One full vanilla E-step over all buckets with the given skip bins
    (60,).  Returns (bin tallies (60,) f64, likelihood): the contract of
    summing the host vanilla_expectations over reads.  Every bucket is
    dispatched, the per-job rows are collected with one copy and summed in
    f64 in job order."""
    if not buckets:
        return np.zeros(2 * N_SKIP_BINS), 0.0
    rows = []
    for b in buckets:
        tabs, _scalars = vanilla_transition_tables(np.asarray(bins), b.strand_name)
        T = np.stack([np.maximum(tabs[k], pp.NEG_INF) for k in b.cell_keys])
        rows.append(bucket_step(b, pp.to_device(T.astype(np.float32), b.device)))
    per_job = np.zeros((sum(len(b.jobs) for b in buckets), N_OUT))
    for b, packed in zip(buckets, pp.to_host(rows)):
        per_job[b.jobs] = packed
    return per_job[:, :-1].sum(0), float(per_job[:, -1].sum())
