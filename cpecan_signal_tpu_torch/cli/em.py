"""Nucleotide-HMM EM: the cPecanEm equivalent (port of cli/em.py, its
device E-step :87-107).

The reference fans alignment chunks of at most 1 Mb out as jobs running
cPecanRealign --outputExpectations, with a follow-on merge and normalize
(cPecanEm.py:107-242).  Here each chunk's records are split and all their
split jobs stacked into device buckets of the symbol lane (em/discrete.py):
the card carries the fiveState recursions and the EM tallies, per-job
results are summed in job order and the chunks in chunk order, so the
accumulator does not depend on bucketing.  Random-restart trials select the
maximum-likelihood model.  Also the Hmm utilities (Jukes-Cantor start, tied
emissions, cPecanEm.py:19-105) and the lastz scoring-matrix export
(makeBlastScoringMatrix, cPecanEm.py:301-359).

Not ported: the host f64 E-step (``engine="host"``) and the re-banding
between iterations (``update_band``, which realigns with the host engine),
ROADMAP queue 1 item 10; several processes (SIGALIGN_COORDINATOR), item 11.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from itertools import product

import numpy as np
import torch

from ..em.accumulators import DiscreteHmm
from ..io.cigar import CigarRecord, read_cigars
from ..models.params import AlignmentParams
from ..ops import fb_kernels as fk
from ..utils.device import resolve_device

SYMBOL_NUMBER = 4
UNPORTED = {
    "host": "the host f64 E-step engine is ROADMAP queue 1 item 10",
    "update_band": "update_band re-bands with the host f64 realign engine, "
                   "ROADMAP queue 1 item 10",
    "coordinator": "multi-process EM (SIGALIGN_COORDINATOR) is ROADMAP queue 1 item 11",
}


def set_jukes_cantor(hmm: DiscreteHmm, divergence: float) -> None:
    i = (0.25 + 0.75 * math.exp(-4.0 * divergence / 3.0)) / 4.0
    j = (0.25 - 0.25 * math.exp(-4.0 * divergence / 3.0)) / 4.0
    for s in range(hmm.state_number):
        hmm.emissions[s] = np.where(np.eye(SYMBOL_NUMBER, dtype=bool), i, j)


def tie_emissions(hmm: DiscreteHmm) -> None:
    """Collapse emissions to overall identity vs non-identity
    (Hmm.tieEmissions, cPecanEm.py:98-105)."""
    for s in range(hmm.state_number):
        e = hmm.emissions[s]
        ident = np.trace(e)
        off = (1.0 - ident) / (SYMBOL_NUMBER**2 - SYMBOL_NUMBER)
        hmm.emissions[s] = np.where(np.eye(SYMBOL_NUMBER, dtype=bool),
                                    ident / SYMBOL_NUMBER, off)


def chunk_alignments(records: list[CigarRecord], max_bases: int = 1_000_000
                     ) -> list[list[CigarRecord]]:
    """≤1 Mb alignment chunks (the jobTree target granularity,
    cPecanEm.py:128-158)."""
    chunks: list[list[CigarRecord]] = [[]]
    size = 0
    for rec in records:
        n = abs(rec.end1 - rec.start1)
        if size + n > max_bases and chunks[-1]:
            chunks.append([])
            size = 0
        chunks[-1].append(rec)
        size += n
    return [c for c in chunks if c]


def _chunk_tallies(chunk, seqs, params, hmm, device, timing=None) -> DiscreteHmm:
    """Device E-step over one chunk: every record's split jobs in one set of
    symbol-lane buckets; per-job tallies summed in job order."""
    from .realign import record_expectations

    acc = DiscreteHmm.empty(5, SYMBOL_NUMBER, pseudocount=0.0)
    record_expectations(chunk, seqs, params, hmm, acc, device=device, timing=timing)
    return acc


def _estep_all_chunks(trial_chunks, seqs, params, hmm, device, timing=None) -> DiscreteHmm:
    """Full E-step: per-chunk tallies, then an in-order sum over the chunks
    (the reference's follow-on merge, cPecanEm.py:182-209)."""
    S, n = 5, SYMBOL_NUMBER
    acc = DiscreteHmm.empty(S, n, pseudocount=1e-12)
    for chunk in trial_chunks:
        a = _chunk_tallies(chunk, seqs, params, hmm, device, timing)
        acc.transitions += a.transitions
        acc.emissions += a.emissions
        acc.likelihood += float(a.likelihood)
    return acc


def expectation_maximisation(alignment_file: str, fasta_files: list[str],
                             output_model: str, iterations: int = 10,
                             trials: int = 1, max_bases_per_chunk: int = 1_000_000,
                             set_jukes_cantor_divergence: float | None = None,
                             tie_emission_params: bool = False,
                             params: AlignmentParams | None = None,
                             update_band: bool = False, seed: int = 0,
                             engine: str = "auto", device: torch.device | None = None,
                             log=print) -> DiscreteHmm:
    """Random-restart EM over a CIGAR alignment set on the device E-step;
    returns (and writes) the maximum-likelihood model
    (expectationMaximisation and ...Trials, cPecanEm.py:107-242).  Each
    iteration logs its E-step seconds, device buckets and kernel launches,
    then its likelihood."""
    from .realign import load_sequences

    if engine == "host":
        raise NotImplementedError(UNPORTED["host"])
    if engine not in ("auto", "pallas"):
        raise ValueError(f"unknown E-step engine {engine!r}")
    if update_band:
        raise NotImplementedError(UNPORTED["update_band"])
    if os.environ.get("SIGALIGN_COORDINATOR") is not None:
        raise NotImplementedError(UNPORTED["coordinator"])
    device = resolve_device() if device is None else device

    params = params or AlignmentParams()
    seqs = load_sequences(fasta_files)
    with open(alignment_file) as fh:
        records = list(read_cigars(fh))
    chunks = chunk_alignments(records, max_bases_per_chunk)
    log(f"em - {len(records)} alignments in {len(chunks)} chunks (device {device})")

    rng = np.random.default_rng(seed)
    best: DiscreteHmm | None = None
    for trial in range(trials):
        hmm = DiscreteHmm.empty(5, SYMBOL_NUMBER)
        hmm.randomize(rng)
        if set_jukes_cantor_divergence is not None:
            set_jukes_cantor(hmm, set_jukes_cantor_divergence)
        running = []
        for it in range(iterations):
            timing: dict = {}
            launches = dict(fk.LAUNCHES)
            t0 = time.perf_counter()
            acc = _estep_all_chunks(chunks, seqs, params, hmm, device, timing)
            t_step = time.perf_counter() - t0
            launched = {k: v - launches[k] for k, v in fk.LAUNCHES.items() if v > launches[k]}
            acc.normalize()
            if tie_emission_params:
                tie_emissions(acc)
            running.append(acc.likelihood)
            log(f"em - trial {trial} iteration {it}: E-step {t_step:.4f} s, "
                f"{timing.get('buckets', 0)} buckets, launches {launched}, "
                f"likelihood {acc.likelihood:.2f}")
            hmm = acc
        hmm.running_likelihoods = running
        if best is None or hmm.likelihood > best.likelihood:
            best = hmm
    best.write(output_model)
    return best


def make_blast_scoring_matrix(hmm: DiscreteHmm, sequences: list[str]):
    """lastz-style scoring matrix from a trained HMM (makeBlastScoringMatrix,
    cPecanEm.py:301-339)."""
    t = hmm.transitions
    e = hmm.emissions
    # collapse to three states
    t3 = np.zeros((3, 3))
    t3[:] = t[:3, :3]
    row = t3.sum(axis=1, keepdims=True)
    t3 = t3 / row
    match_e = e[0] / e[0].sum()

    gc = sum(sum(1.0 for c in s if c in "GC") for s in sequences) / \
        max(sum(len(s) for s in sequences), 1)

    def base_prob(x):
        return gc / 2.0 if x in (1, 2) else (1.0 - gc) / 2.0

    match_probs = [match_e[x, y] / (base_prob(x) * base_prob(y))
                   for x, y in product(range(4), range(4))]
    match_continue = t3[0, 0]
    n_prob = math.sqrt(math.exp(
        (6.94 + sum(math.log(x * match_continue) for x in match_probs))
        / len(match_probs)))
    weight = 100
    match_scores = [weight * math.log(x * match_continue / n_prob**2)
                    for x in match_probs]
    gap_open = weight * math.log(
        (0.5 * (t3[0, 1] / n_prob + t3[0, 2] / n_prob))
        * ((t3[1, 0] + t3[2, 0]) / (2 * n_prob**2))
        * (n_prob**2 / match_continue))
    gap_extend = weight * math.log(0.5 * (t3[1, 1] / n_prob + t3[2, 2] / n_prob))
    return match_scores, gap_open, gap_extend


def write_lastz_scoring_matrix(fh, match_scores, gap_open, gap_extend) -> None:
    fh.write(f"gap_open_penalty = {int(round(-gap_open))}\n")
    fh.write(f"gap_extend_penalty = {int(round(-gap_extend))}\n")
    bases = "ACGT"
    fh.write("\t\t" + "\t".join(bases) + "\n")
    for x in range(4):
        row = "\t".join(str(int(round(v)))
                        for v in match_scores[x * 4:(x + 1) * 4])
        fh.write(f"\t{bases[x]}\t{row}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description="nucleotide HMM EM (cPecanEm equivalent)")
    ap.add_argument("--alignments", required=True)
    ap.add_argument("--fastas", nargs="+", required=True)
    ap.add_argument("--outputModel", required=True)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--maxAlignmentLengthPerJob", type=int, default=1_000_000)
    ap.add_argument("--setJukesCantorStartingEmissions", type=float, default=None)
    ap.add_argument("--tieEmissions", action="store_true")
    ap.add_argument("--blastScoringMatrixFile", default=None)
    ap.add_argument("--engine", choices=("auto", "host", "pallas"), default="auto",
                    help="E-step engine: 'pallas' = each chunk's records batched on "
                         "the device (the name is the JAX CLI's), 'host' = f64 scan "
                         "per record (not ported), 'auto' = pallas")
    args = ap.parse_args(argv)

    hmm = expectation_maximisation(
        args.alignments, args.fastas, args.outputModel,
        iterations=args.iterations, trials=args.trials,
        max_bases_per_chunk=args.maxAlignmentLengthPerJob,
        set_jukes_cantor_divergence=args.setJukesCantorStartingEmissions,
        tie_emission_params=args.tieEmissions, engine=args.engine)
    if args.blastScoringMatrixFile:
        from .realign import load_sequences
        seqs = list(load_sequences(args.fastas).values())
        with open(args.blastScoringMatrixFile, "w") as fh:
            write_lastz_scoring_matrix(fh, *make_blast_scoring_matrix(hmm, seqs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
