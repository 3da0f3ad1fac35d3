"""Data-parallel execution over several processes (port of
cpecan_signal_tpu/parallel/mesh.py).

The reference's distribution model is process-level data parallelism over
reads with a filesystem reduce (SURVEY §2.3): worker pools
(signalAlign.py:103-146) and per-read expectation files summed on a shared
filesystem (trainModels.py:126-135).  The JAX module shards one stacked
batch over a device mesh and sums the E-step's tallies with a psum inside
shard_map.  In the port each process (a torch.distributed rank,
parallel/distributed.py) is one member of the data mesh: it holds its own
problems on its own device, runs them, and the tallies are summed across
the ranks by ``allreduce_sum`` (in rank order, so every run gives the same
bits).  With one process each function is the local computation.

An E-step's batch is a list of this rank's ``em/sm3_em.EmJob`` split jobs
(pore model, target, events, band, ragged ends).  It runs in one of two
forms, as in the JAX module:
  * the scan form (``em_step_fn``, ``distributed_em_step``,
    ``distributed_train_step``): each job through the f64 oracle
    (engine/fb.py, engine/expectations.py), summed in job order;
  * the kernels' form (``pallas_em_step_fn``,
    ``distributed_train_step_pallas``; the name is the JAX package's): the
    jobs packed into buckets and run through the stage-4 kernels
    (em/sm3_em.py).
``distributed_posteriors`` runs a stacked threeState batch
(engine/pipeline.SM3Problem) through the alignment kernels, with no
collective.  JAX's ``make_mesh`` and ``shard_batch`` have no counterpart:
nothing is sharded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..em.sm3_em import EmJob, build_sm3_em_buckets, sm3_em_step
from ..engine import expectations as exp_kernels
from ..engine import fb
from ..engine import pipeline as pp
from ..engine.plan import EnginePlan
from ..models.state_machines import make_signal_sm3
from ..utils.device import resolve_device
from .distributed import allreduce_sum


def distributed_posteriors(plan: EnginePlan, W: int, batch: pp.SM3Problem):
    """This rank's stacked batch through the emissions, forward and stage-3
    backward kernels: (p (B, Dp, W) match posteriors, totals (B, Dp)).  No
    collective: each rank keeps its problems' posteriors."""
    return pp.run_sm3(plan, W, batch)


def oracle_expectations(jobs: list[EmJob], transitions: dict | None = None,
                        kmer_gaps: np.ndarray | None = None,
                        device: torch.device | None = None):
    """The scan form of the local E-step: each job's threeState machine
    (with the M-step's ``transitions`` and ``kmer_gaps``) through the f64
    oracle on ``device`` (default: the resolved device), the tallies summed
    in job order.  Returns (transitions (3, 3), kmer_gap (4096,),
    likelihood) as f64 numpy."""
    device = resolve_device() if device is None else device
    trans, kmer_gap, lik = np.zeros((3, 3)), np.zeros(4096), 0.0
    for j in jobs:
        sm = make_signal_sm3(j.pore, j.target, j.events, transitions, kmer_gaps)
        plan, inp = fb.prepare_inputs(sm, j.band, ragged_left=j.ragged_left,
                                      ragged_right=j.ragged_right, device=device,
                                      dtype=torch.float64)
        t, k, l = exp_kernels.threestate_expectations(plan, inp, fb.forward(plan, inp),
                                                      fb.backward(plan, inp))
        trans += t.cpu().numpy()
        kmer_gap += k.cpu().numpy()
        lik += float(l)
    return trans, kmer_gap, lik


def em_step_fn(transitions: dict | None = None, kmer_gaps: np.ndarray | None = None,
               device: torch.device | None = None):
    """The distributed E-step of the scan form: a function of this rank's
    jobs -> (transitions, kmer_gap, likelihood) summed over every rank's
    jobs, the same on every rank."""
    def step(jobs: list[EmJob]):
        trans, kmer_gap, lik = oracle_expectations(jobs, transitions, kmer_gaps, device)
        return allreduce_sum(trans, kmer_gap, np.asarray(lik))

    return step


def distributed_em_step(jobs: list[EmJob], transitions: dict | None = None,
                        kmer_gaps: np.ndarray | None = None,
                        device: torch.device | None = None):
    """One distributed E-step and reduce over this rank's ``jobs`` (the
    equivalent of add_and_norm_expectations, trainModels.py:126-135).
    Returns the global (transitions (3, 3), kmer_gap (4096,), likelihood)."""
    return em_step_fn(transitions, kmer_gaps, device)(jobs)


def em_m_step(trans, kmer_gap):
    """The M-step every rank takes on the reduced tallies: transitions
    row-normalized, k-mer tallies normalized (continuousPairHmm_normalize,
    continuousHmm.c:174-191)."""
    trans, kmer_gap = np.asarray(trans), np.asarray(kmer_gap)
    row = trans.sum(axis=1, keepdims=True)
    trans_n = np.where(row > 0, trans / np.where(row > 0, row, 1.0), trans)
    tot = kmer_gap.sum()
    kmer_n = kmer_gap / tot if tot > 0 else kmer_gap
    return trans_n, kmer_n


def distributed_train_step(jobs: list[EmJob], transitions: dict | None = None,
                           kmer_gaps: np.ndarray | None = None,
                           device: torch.device | None = None):
    """E-step, reduce and M-step of the scan form: (normalized transitions,
    normalized k-mer tallies, likelihood)."""
    trans, kmer_gap, lik = distributed_em_step(jobs, transitions, kmer_gaps, device)
    return (*em_m_step(trans, kmer_gap), lik)


def pallas_em_step_fn(transitions: dict | None = None, kmer_gaps: np.ndarray | None = None,
                      device: torch.device | None = None):
    """The distributed E-step on the kernels: a function of this rank's jobs
    -> the global (transitions, kmer_gap, likelihood).  The jobs are packed
    into width buckets on ``device`` and run through the stage-4 pipeline
    (em/sm3_em.sm3_em_step), then reduced."""
    def step(jobs: list[EmJob]):
        dev = resolve_device() if device is None else device
        buckets = build_sm3_em_buckets(jobs, device=dev)
        trans, kmer_gap, lik = sm3_em_step(buckets, transitions, kmer_gaps)
        return allreduce_sum(trans, kmer_gap, np.asarray(lik))

    return step


def distributed_train_step_pallas(jobs: list[EmJob], transitions: dict | None = None,
                                  kmer_gaps: np.ndarray | None = None,
                                  device: torch.device | None = None):
    """E-step on the kernels, reduce and M-step: (normalized transitions,
    normalized k-mer tallies, likelihood)."""
    trans, kmer_gap, lik = pallas_em_step_fn(transitions, kmer_gaps, device)(jobs)
    return (*em_m_step(trans, kmer_gap), lik)
