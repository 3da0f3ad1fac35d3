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
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import KMER_LENGTH, NUM_OF_KMERS
from ..core.anchors import anchors_in_window, get_split_points
from ..core.band import band_construct
from ..core.window import smooth_band
from ..engine import pipeline as pp
from ..engine.plan import EnginePlan, _build_plan
from ..models.params import AlignmentParams
from ..models.pore_model import PoreModel, scale_model
from ..models.state_machines import (LOG_TENTH, SM3_NANOPORE_TRANSITIONS,
                                     make_signal_sm3)

MAX_BUCKET = 64  # problems per device batch (bounds host packing memory)
BUDGET_ENV = "CPECAN_EM_HBM_BUDGET"   # bytes of buckets kept on the card
BUDGET_FREE_SHARE = 0.5   # default budget: this share of the card's free memory


def _split_loop(target_len_dp, events_len, anchors, params, ragged_left, ragged_right):
    """Split windows of one strand with their bands and ragged flags (copy of
    em/expectation_driver._split_loop)."""
    anchors = np.asarray(anchors, dtype=np.int64).reshape(-1, 2)
    splits = get_split_points(anchors, target_len_dp, events_len,
                              params.split_matrix_bigger_than_this,
                              ragged_left, ragged_right,
                              max_gap_min_dim=params.max_gap_min_dim)
    for i, (x1, y1, x2, y2) in enumerate(splits):
        sub_anchors = anchors_in_window(anchors, x1, y1, x2, y2)
        band = band_construct(sub_anchors, x2 - x1, y2 - y1, params.diagonal_expansion)
        rl = ragged_left or i > 0
        rr = ragged_right or i < len(splits) - 1
        yield (x1, y1, x2, y2), band, rl, rr


def _nbytes(prob: pp.SM3Problem) -> int:
    return sum(t.element_size() * t.numel() for t in prob)


class _EmBudget:
    """Bytes of buckets kept on ``device`` across one build set (both
    strands), and the residency decision for each bucket.  The budget is
    ``budget`` if given, else $CPECAN_EM_HBM_BUDGET, else half of the card's
    free memory when the budget is made (on the CPU: no limit)."""

    def __init__(self, device: torch.device, budget: float | None = None):
        self.device = device
        if budget is None and os.environ.get(BUDGET_ENV):
            budget = float(os.environ[BUDGET_ENV])
        if budget is None:
            budget = (BUDGET_FREE_SHARE * torch.cuda.mem_get_info(device)[0]
                      if device.type == "cuda" else math.inf)
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
        for (x1, y1, x2, y2), band, rl, rr in _split_loop(
                lX, len(events), anchors, params, True, True):
            jobs.append(EmJob(pore, target[x1:x2 + KMER_LENGTH - 1],
                              events[y1:y2], band, rl, rr))
    return jobs


@dataclass
class SM3EmBucket:
    """One width bucket of stacked problems."""

    plan: EnginePlan
    W: int
    batch: pp.SM3Problem     # on the device, or on the host when streamed
    ragged_left: np.ndarray  # (B,) bool
    ragged_right: np.ndarray
    resident: bool
    device: torch.device


def build_sm3_em_buckets(jobs: list[EmJob], *, device: torch.device,
                         width_multiple: int = 128,
                         budget: _EmBudget | None = None) -> list[SM3EmBucket]:
    """Pack jobs into width-bucketed stacked problems (once, before the EM
    loop): one bucket per window width and MAX_BUCKET jobs, padded to the
    chunk's longest job (Dp = its diagonal count).  ``budget`` (shared
    across strands by the caller) decides which buckets stay on the device."""
    if budget is None:
        budget = _EmBudget(device)
    wbands = [smooth_band(j.band, width_multiple=width_multiple) for j in jobs]
    groups: dict[int, list[int]] = {}
    for i, wb in enumerate(wbands):
        groups.setdefault(wb.W, []).append(i)

    cpu = torch.device("cpu")
    buckets = []
    for W, idxs in sorted(groups.items()):
        for lo in range(0, len(idxs), MAX_BUCKET):
            chunk = idxs[lo:lo + MAX_BUCKET]
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
                resident=resident, device=device))
    return buckets


def bucket_from_jax(bucket, device: torch.device) -> SM3EmBucket:
    """A JAX ``pallas_em.SM3EmBucket`` (or any object with its fields, the
    batch's arrays readable as numpy) carried over to the port, resident on
    ``device``."""
    plan, batch = pp.problem_from_numpy(bucket.plan, bucket.batch, device)
    return SM3EmBucket(plan=plan, W=int(bucket.W), batch=batch,
                       ragged_left=np.asarray(bucket.ragged_left, dtype=bool),
                       ragged_right=np.asarray(bucket.ragged_right, dtype=bool),
                       resident=True, device=device)


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
    return (pp._san(tp_scalar), pp._san(sm.start), pp._san(sm.ragged_start),
            pp._san(sm.end), pp._san(sm.ragged_end))


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
        trans_sum += trans.double()
        kmer_sum += kmer.double()
        lik_sum += lik.double()
    return (trans_sum.cpu().numpy(), kmer_sum.cpu().numpy(), float(lik_sum))
