"""The threeState E-step on the device: every read's split jobs at once
(port of the SM3 half of em/pallas_em.py:38-273).

All reads' split jobs (reads x strands x splits) are packed once, before the
EM loop, into width-bucketed batches of ``SM3Problem``s.  Each iteration
updates only what the M-step changed and runs the stage-4 pipeline
(engine/pipeline.sm3_expectations: the emissions, forward and stage-4
backward kernels, then one per-k-mer scatter), so the card, not a host f64
loop, carries the E-step.

What changes per iteration in a bucket:
  * xarr row 12 (per-x gapX log-prob): regathered from the trained 4096-vector
    through the problem's xrank pack, in place (the row is rewritten whole
    every iteration, so the bucket keeps no second copy);
  * tp_scalar: the transition log-probs, one vector broadcast per problem;
  * start/end: boundary vectors recomputed from the transitions and chosen
    per problem by its ragged flags.
Everything else (emission parameter packs, window scalars) is static.

Buckets stay on the card up to a byte budget (``_EmBudget``); the rest stay
in pinned host memory and are uploaded, without blocking, at every step.

Each step adds every bucket's work to ``utils/observability.counters``, as
host integers counted when the bucket was built: ``em.problems``,
``em.diagonals`` (each problem's own), ``em.cells_lane`` (W lanes a
diagonal), ``em.cells_band`` (the true band's cells) and, on a card,
``em.sm_slots`` (SMs x recursion blocks an SM holds x the bucket's padded
diagonal count Dp: what a launch could hold while it runs).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import KMER_LENGTH, NUM_OF_KMERS
from ..core.window import smooth_band
from ..engine import pipeline as pp
from ..engine.align import split_windows
from ..engine.plan import EnginePlan, _build_plan
from ..models.params import AlignmentParams
from ..models.pore_model import PoreModel, scale_model
from ..models.state_machines import (LOG_TENTH, SM3_NANOPORE_TRANSITIONS,
                                     make_signal_sm3)
from ..ops import fb_kernels as fk
from ..parallel.distributed import ranks_sharing_device
from ..utils.observability import counters, timed

BUDGET_ENV = "CPECAN_EM_HBM_BUDGET"   # bytes of buckets kept on the card
BUDGET_FREE_SHARE = 0.5   # default budget: this share of the card's free memory


def _nbytes(prob: pp.SM3Problem) -> int:
    return sum(t.element_size() * t.numel() for t in prob)


class _EmBudget:
    """Bytes of buckets kept on ``device`` across one build set (both
    strands), and the residency decision for each bucket.  The budget is
    ``budget`` if given, else $CPECAN_EM_HBM_BUDGET, else half of the card's
    free memory when the budget is made, divided among the ranks of this
    host that share the card (parallel/distributed.ranks_sharing_device; on
    the CPU: no limit)."""

    def __init__(self, device: torch.device, budget: float | None = None):
        self.device = device
        if budget is None and os.environ.get(BUDGET_ENV):
            budget = float(os.environ[BUDGET_ENV])
        if budget is None:
            budget = (BUDGET_FREE_SHARE * torch.cuda.mem_get_info(device)[0]
                      / ranks_sharing_device() if device.type == "cuda" else math.inf)
        self.budget = budget
        self.resident = 0
        self.streamed = 0
        self.n_streamed = 0

    def place(self, prob):
        """A host-built bucket (a NamedTuple of CPU tensors) -> (its tensors,
        resident?).  Within the budget it is uploaded and stays on the
        device; past it it stays on the host (pinned, for a CUDA device) and
        streams through the device per step (``stream``)."""
        n = _nbytes(prob)
        if self.resident + n <= self.budget:
            self.resident += n
            return type(prob)(*(pp.to_device(t.numpy(), self.device) for t in prob)), True
        self.streamed += n
        self.n_streamed += 1
        if self.device.type == "cuda":
            prob = type(prob)(*(t.pin_memory() for t in prob))
        return prob, False

    def summary(self) -> str:
        limit = ("no limit" if math.isinf(self.budget)
                 else f"{self.budget / 1e9:.1f} GB")
        return (f"device-resident {self.resident / 1e6:.0f} MB"
                + (f", streamed per-iteration {self.streamed / 1e6:.0f} MB "
                   f"({self.n_streamed} buckets over the {limit} budget)"
                   if self.n_streamed else f" (budget {limit})"))


def stream(batch, resident: bool, device: torch.device):
    """A bucket's tensors on ``device``: as they are when resident, else
    uploaded without blocking (a NamedTuple of tensors)."""
    if resident:
        return batch
    return type(batch)(*(t.to(device, non_blocking=True) for t in batch))


@dataclass
class EmJob:
    """One split sub-problem of one read-strand, ready for packing."""

    pore: PoreModel
    target: str
    events: np.ndarray
    band: object
    ragged_left: bool
    ragged_right: bool


def collect_sm3_em_jobs(reads: list[dict], models: dict, params: AlignmentParams,
                        strand: str) -> list[EmJob]:
    """reads are train_models._prepare_read dicts {'t': (target, events,
    anchors, scale params), 'c': ...}; models maps strand -> unscaled
    PoreModel.  Tallies are per-strand HMMs, so buckets are built per
    strand."""
    jobs = []
    for prep in reads:
        target, events, anchors, sp = prep[strand]
        if len(events) == 0:
            continue
        pore = scale_model(models[strand], sp.scale, sp.shift, sp.var,
                           sp.scale_sd, sp.var_sd)
        lX = len(target) - KMER_LENGTH + 1
        for (x1, y1, x2, y2), band, rl, rr in split_windows(
                lX, len(events), anchors, params, True, True):
            jobs.append(EmJob(pore, target[x1:x2 + KMER_LENGTH - 1],
                              events[y1:y2], band, rl, rr))
    return jobs


@dataclass
class SM3EmBucket:
    """One width bucket of stacked problems, and the work a step of it does
    (host integers, counted at build)."""

    plan: EnginePlan
    W: int
    batch: pp.SM3Problem     # on the device, or on the host when streamed
    ragged_left: np.ndarray  # (B,) bool
    ragged_right: np.ndarray
    resident: bool
    device: torch.device
    Dp: int                  # diagonals of the launch: its longest problem's
    counts: dict             # em.problems, em.diagonals, em.cells_lane, em.cells_band


def _bucket_counts(W: int, bands) -> dict:
    """A bucket's counters from each problem's true band limits (xmyL,
    xmyR) over its own diagonals: B, the diagonals, W lanes on each of them
    and the band's cells there ((xmyR - xmyL) / 2 + 1 a diagonal)."""
    D = sum(len(xmyL) for xmyL, _ in bands)
    return {"em.problems": len(bands), "em.diagonals": D, "em.cells_lane": W * D,
            "em.cells_band": sum(int(((xmyR - xmyL) // 2 + 1).sum()) for xmyL, xmyR in bands)}


def build_sm3_em_buckets(jobs: list[EmJob], *, device: torch.device,
                         width_multiple: int = 128,
                         budget: _EmBudget | None = None) -> list[SM3EmBucket]:
    """Pack jobs into width-bucketed stacked problems (once, before the EM
    loop): buckets of one window width (pipeline.launch_groups), in
    increasing width, each padded to its longest job (Dp = its diagonal
    count).  ``budget`` (shared across strands by the caller) decides which
    buckets stay on the device."""
    with timed("em.build_buckets"):
        if budget is None:
            budget = _EmBudget(device)
        wbands = [smooth_band(j.band, width_multiple=width_multiple) for j in jobs]
        cpu = torch.device("cpu")
        buckets = []
        for W, chunk in sorted(pp.launch_groups([wb.W for wb in wbands]),
                               key=lambda group: group[0]):
            Dp = max(wbands[i].n_diagonals for i in chunk)
            lxp = max(len(jobs[i].target) for i in chunk)
            lyp = max(len(jobs[i].events) for i in chunk)
            plan, probs = None, []
            for i in chunk:
                j = jobs[i]
                plan, prob = pp.make_sm3_problem(
                    j.pore, j.target, j.events, wbands[i], device=cpu,
                    ragged_left=j.ragged_left, ragged_right=j.ragged_right,
                    pad_lx=lxp, pad_ly=lyp, pad_d=Dp)
                probs.append(prob)
            batch, resident = budget.place(pp.stack_problems(probs))
            buckets.append(SM3EmBucket(
                plan=plan, W=W, batch=batch,
                ragged_left=np.array([jobs[i].ragged_left for i in chunk]),
                ragged_right=np.array([jobs[i].ragged_right for i in chunk]),
                resident=resident, device=device, Dp=Dp,
                counts=_bucket_counts(W, [(wbands[i].xmyL, wbands[i].xmyR)
                                          for i in chunk])))
        return buckets


def bucket_from_jax(bucket, device: torch.device) -> SM3EmBucket:
    """A JAX ``pallas_em.SM3EmBucket`` (or any object with its fields, the
    batch's arrays readable as numpy) carried over to the port, resident on
    ``device``."""
    plan, batch = pp.problem_from_numpy(bucket.plan, bucket.batch, device)
    ds = np.asarray(bucket.batch.diag_scalars, dtype=np.int64)[:, :, 0]
    bands = [(ds[b, :d + 1, fk.DS_XMYL], ds[b, :d + 1, fk.DS_XMYR])
             for b, d in enumerate(np.asarray(bucket.batch.d_last))]
    return SM3EmBucket(plan=plan, W=int(bucket.W), batch=batch,
                       ragged_left=np.asarray(bucket.ragged_left, dtype=bool),
                       ragged_right=np.asarray(bucket.ragged_right, dtype=bool),
                       resident=True, device=device, Dp=ds.shape[1] - 1,
                       counts=_bucket_counts(int(bucket.W), bands))


def _sm3_iteration_arrays(transitions: dict | None):
    """(tp_vec, start, ragged_start, end, ragged_end) f32 for a transitions
    dict, computed through the same _build_plan the problems used, so the
    scalar order always matches."""
    t = dict(SM3_NANOPORE_TRANSITIONS)
    if transitions:
        t.update(transitions)
    dummy = np.zeros((NUM_OF_KMERS + 2, 5))
    dummy[:, 1] = dummy[:, 3] = 1.0
    pore = PoreModel(1.0, dummy, 1.0, dummy.copy(), np.full(60, 1 / 30.0))
    sm = make_signal_sm3(pore, "ACGTACGTA", np.zeros((2, 3)), t)
    _plan, tp_scalar, cell_sources = _build_plan(sm, "exact")
    assert not cell_sources
    return (pp.finite_f32(tp_scalar), pp.finite_f32(sm.start), pp.finite_f32(sm.ragged_start),
            pp.finite_f32(sm.end), pp.finite_f32(sm.ragged_end))


def bucket_step(bucket: SM3EmBucket, gapx_tab: torch.Tensor, tp_vec: torch.Tensor,
                start: torch.Tensor, end: torch.Tensor):
    """One bucket's E-step with this iteration's parameters (all on the
    bucket's device): xarr row 12 regathered through xrank (in place),
    tp_scalar broadcast, start/end per problem.  Returns the tensors of
    pipeline.sm3_expectations."""
    batch = stream(bucket.batch, bucket.resident, bucket.device)
    batch.xarr[:, 12, :] = gapx_tab[batch.xrank.long()]
    B = batch.xrank.shape[0]
    batch = batch._replace(start=start, end=end,
                           tp_scalar=tp_vec.expand(B, -1).contiguous())
    return pp.sm3_expectations(bucket.plan, bucket.W, batch)


def sm3_em_step(buckets: list[SM3EmBucket], transitions: dict | None = None,
                kmer_gaps: np.ndarray | None = None):
    """One full E-step over all buckets with the given M-step parameters.
    Returns (trans (3, 3), kmer_gap (4096,), likelihood) as f64 numpy / float,
    summed over all problems: the contract of summing the host
    sm3_expectations over reads.  The sums over buckets run on the device,
    in f64, and are copied back once."""
    if not buckets:
        return np.zeros((3, 3)), np.zeros(NUM_OF_KMERS), 0.0
    device = buckets[0].device
    tp_vec, sv, rsv, ev, rev = _sm3_iteration_arrays(transitions)
    gapx_tab = np.full(NUM_OF_KMERS + 2, LOG_TENTH, dtype=np.float32)
    if kmer_gaps is not None:
        gapx_tab[:NUM_OF_KMERS] = np.maximum(kmer_gaps, pp.NEG_INF)
    gapx_tab[NUM_OF_KMERS:] = pp.NEG_INF
    gapx_t = pp.to_device(gapx_tab, device)
    tp_t = pp.to_device(tp_vec, device)

    f64 = dict(dtype=torch.float64, device=device)
    trans_sum = torch.zeros((3, 3), **f64)
    kmer_sum = torch.zeros(NUM_OF_KMERS, **f64)
    lik_sum = torch.zeros((), **f64)
    for b in buckets:
        start = pp.to_device(np.where(b.ragged_left[:, None], rsv, sv), device)
        end = pp.to_device(np.where(b.ragged_right[:, None], rev, ev), device)
        trans, kmer, lik = bucket_step(b, gapx_t, tp_t, start, end)
        for name, n in b.counts.items():
            counters.add(name, n)
        # E has emissions_sm3's 3 channels
        slots = fk.sm_slots_per_diagonal(device, b.plan.n_states, 3, b.W)
        if slots:
            counters.add("em.sm_slots", slots * b.Dp)
        trans_sum += trans.double()
        kmer_sum += kmer.double()
        lik_sum += lik.double()
    return (trans_sum.cpu().numpy(), kmer_sum.cpu().numpy(), float(lik_sum))
