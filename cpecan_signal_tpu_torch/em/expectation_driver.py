"""E-step drivers on the f64 oracle: run the banded FB over each split and
collect its expectation tallies into accumulators (port of
``cpecan_signal_tpu/em/expectation_driver.py:22-130``; the equivalent of
getExpectationsUsingAnchors + getSignalExpectations,
pairwiseAligner.c:1571-1614 / vanillaAlign.c:318-359).

Each driver runs its splits one by one on one device (default: the resolved
device, the card unless the caller asks for the CPU) and sums the tallies
on the host in f64, in split order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.kmers import rank_to_kmer
from ..engine import expectations as exp_kernels
from ..engine import fb
from ..engine.align import collect_split_jobs
from ..models.params import AlignmentParams
from ..utils.device import resolve_device
from .accumulators import ContinuousPairHmm, DiscreteHmm, HdpHmm, VanillaHmm


def _splits(make_sm, seq_x, seq_y, kmers: bool, anchors, params, ragged_left, ragged_right,
            device, dtype):
    """(plan, inputs, F, B) of every split, in split order.  With ``kmers``
    the matrix's x axis is the k-mers of ``seq_x`` (a signal target), else
    its symbols."""
    for job in collect_split_jobs(make_sm, seq_x, seq_y, anchors, params,
                                  ragged_left=ragged_left, ragged_right=ragged_right,
                                  kmers=kmers):
        plan, inp = fb.prepare_inputs(job.sm, job.band, ragged_left=job.ragged_left,
                                      ragged_right=job.ragged_right, device=device,
                                      dtype=dtype)
        yield plan, inp, fb.forward(plan, inp), fb.backward(plan, inp)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def sm3_expectations(make_sm: Callable, target_seq: str, events: np.ndarray,
                     anchors: np.ndarray, params: AlignmentParams,
                     *, ragged_left=True, ragged_right=True,
                     device: torch.device | None = None, dtype=torch.float64
                     ) -> ContinuousPairHmm:
    """threeState E-step over one read -> ContinuousPairHmm tallies."""
    device = resolve_device() if device is None else device
    acc = ContinuousPairHmm.empty()
    for plan, inp, F, B in _splits(make_sm, target_seq, events, True, anchors, params,
                                   ragged_left, ragged_right, device, dtype):
        trans, kmer_gap, lik = exp_kernels.threestate_expectations(plan, inp, F, B)
        acc.transitions += _host(trans)
        acc.kmer_gap += _host(kmer_gap)
        acc.likelihood += float(lik)
    return acc


def vanilla_expectations(make_sm: Callable, target_seq: str, events: np.ndarray,
                         anchors: np.ndarray, params: AlignmentParams,
                         *, ragged_left=True, ragged_right=True,
                         device: torch.device | None = None, dtype=torch.float64
                         ) -> VanillaHmm:
    """vanilla E-step -> skip-bin tallies."""
    device = resolve_device() if device is None else device
    acc = VanillaHmm.empty()
    for plan, inp, F, B in _splits(make_sm, target_seq, events, True, anchors, params,
                                   ragged_left, ragged_right, device, dtype):
        bins, lik = exp_kernels.vanilla_expectations(plan, inp, F, B)
        acc.bins += _host(bins)
        acc.likelihood += float(lik)
    return acc


def _rank_kmers(ranks: np.ndarray) -> list[str]:
    """The k-mer string of every rank in ``ranks``, decoded once per rank."""
    uniq, inv = np.unique(ranks, return_inverse=True)
    names = np.array([rank_to_kmer(int(r)) for r in uniq], dtype=object)
    return names[inv].tolist()


def hdp_expectations(make_sm: Callable, target_seq: str, events: np.ndarray,
                     anchors: np.ndarray, params: AlignmentParams, threshold: float,
                     *, ragged_left=True, ragged_right=True,
                     device: torch.device | None = None, dtype=torch.float64) -> HdpHmm:
    """threeStateHdp E-step -> transitions + (kmer, event) assignments, in
    the order mask, diagonal, cell (the JAX driver's)."""
    device = resolve_device() if device is None else device
    acc = HdpHmm.empty(threshold=threshold)
    for plan, inp, F, B in _splits(make_sm, target_seq, events, True, anchors, params,
                                   ragged_left, ragged_right, device, dtype):
        trans, lik, masks, ranks, means = exp_kernels.hdp_expectations(plan, inp, F, B,
                                                                       threshold)
        acc.transitions += _host(trans)
        acc.likelihood += float(lik)
        masks, ranks, means = _host(masks), _host(ranks), _host(means)
        # assignments store the literal kmer string at the clamped x position
        # (cell_signal_updateTransAndKmerSkipExpectations2 keeps a char
        # pointer; here the rank is decoded back to the kmer string)
        for m in masks:
            acc.kmer_assignments.extend(_rank_kmers(ranks[m]))
            acc.event_assignments.extend(means[m].tolist())
    return acc


def discrete_expectations(make_sm: Callable, seq_x: str, seq_y: str,
                          anchors: np.ndarray, params: AlignmentParams,
                          *, ragged_left=False, ragged_right=False,
                          device: torch.device | None = None, dtype=torch.float64,
                          state_number=5) -> DiscreteHmm:
    """fiveState symbol E-step (the cPecanRealign --outputExpectations path)."""
    device = resolve_device() if device is None else device
    acc = DiscreteHmm.empty(state_number=state_number)
    for plan, inp, F, B in _splits(make_sm, seq_x, seq_y, False, anchors, params,
                                   ragged_left, ragged_right, device, dtype):
        trans, emiss, lik = exp_kernels.discrete_expectations(plan, inp, F, B)
        acc.transitions += _host(trans)
        acc.emissions += _host(emiss)
        acc.likelihood += float(lik)
    return acc
