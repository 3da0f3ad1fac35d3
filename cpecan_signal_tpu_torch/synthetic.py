"""Synthetic pore models and npRead files, made from a numpy seed.

The repository carries no real pore models or reads, so the port's tests and
``chip_smoke.py`` drive the main path on synthetic inputs of the real shape:
a 4096 (+2 sentinel) k-mer x 5-parameter pore model with levels of 40-90 pA,
and two-strand npRead files whose events follow the threeState generative
process (stay / skip moves along the read's k-mers, Gaussian level noise),
written with the jax-free ``io.npread.write_npread``.
"""

from __future__ import annotations

import os

import numpy as np

from .constants import KMER_LENGTH, MODEL_PARAMS, NUM_OF_KMERS
from .core.anchors import filter_to_remove_overlap
from .core.kmers import sequence_kmer_ranks
from .io.fasta import reverse_complement, write_fasta
from .io.npread import NanoporeRead, ScaleParams, write_npread
from .models.pore_model import PoreModel, load_pore_model

NOISE_SD = 0.3   # model noise sd: lambda = noise_mean^3 / NOISE_SD^2


def write_pore_model(path: str, rng: np.random.Generator) -> PoreModel:
    """Random pore-model file in the 3-line format (levels 40-90 pA, level
    sd 1.0, noise mean 1-3 with sd NOISE_SD); returns it loaded."""
    level = rng.uniform(40, 90, NUM_OF_KMERS)
    noise = rng.uniform(1, 3, NUM_OF_KMERS)
    rows = np.stack([level, np.ones(NUM_OF_KMERS), noise,
                     np.full(NUM_OF_KMERS, NOISE_SD), noise**3 / NOISE_SD**2], axis=1)
    assert rows.shape[1] == MODEL_PARAMS
    line = "0 " + " ".join(repr(float(v)) for v in rows.ravel())
    with open(path, "w") as fh:
        fh.write(line + "\n")
        fh.write(" ".join(["0.1"] * 30) + "\n")
        fh.write(line + "\n")
    return load_pore_model(path)


def evolve_sequence(seq: str, rng: np.random.Generator, sub: float, indel: float) -> str:
    """Copy of ``seq`` with substitutions and 1-3 base indels."""
    bases = "ACGT"
    out = []
    i = 0
    while i < len(seq):
        r = rng.random()
        if r < indel / 2:          # deletion of 1-3
            i += int(rng.integers(1, 4))
            continue
        if r < indel:              # insertion of 1-3
            out.extend(rng.choice(list(bases), int(rng.integers(1, 4))))
        c = seq[i]
        if rng.random() < sub:
            c = bases[int(rng.integers(4))]
        out.append(c)
        i += 1
    return "".join(out)


def simulate_events(pore: PoreModel, target: str, rng: np.random.Generator,
                    stay: float = 0.10, skip: float = 0.04, noise_sd: float = 0.6):
    """Events (n, 3) walking ``target``'s k-mers with stay/skip moves, and
    the true path as (k-mer index, event index) pairs."""
    ranks = sequence_kmer_ranks(target)
    events, path = [], []
    k = 0
    while k < len(ranks):
        r = pore.match_model[ranks[k]]
        mean = r[0] + rng.normal(0.0, noise_sd)
        sd_noise = max(r[2] + rng.normal(0.0, 0.2), 0.3)
        events.append((mean, sd_noise, max(rng.normal(0.01, 0.004), 0.002)))
        path.append((k, len(events) - 1))
        u = rng.random()
        if u < stay:
            continue                       # next event, same k-mer
        k += 1
        if u > 1.0 - skip:
            k += 1                         # skip a k-mer
    return np.asarray(events, dtype=np.float64), np.asarray(path, dtype=np.int64)


def path_anchors(path: np.ndarray, n_kmers: int, n_events: int, stride: int) -> np.ndarray:
    """Guide-like anchors: every ``stride``-th pair of the true path."""
    a = path[::max(stride, 1)]
    a = a[(a[:, 0] < n_kmers) & (a[:, 1] < n_events)]
    return filter_to_remove_overlap(a.astype(np.int64))


def _event_map(path: np.ndarray, n_kmers: int) -> np.ndarray:
    """k-mer index -> first event of that k-mer (skipped k-mers take the
    previous k-mer's event)."""
    first = np.full(n_kmers, -1, dtype=np.int64)
    for k, e in path[::-1]:
        if k < n_kmers:
            first[k] = e
    first[0] = max(first[0], 0)
    return np.maximum.accumulate(first)


def make_npread(read: str, pore: PoreModel, rng: np.random.Generator) -> NanoporeRead:
    """Two-strand npRead of ``read``: template events along the read,
    complement events along its reverse complement, with the event maps
    (read position -> event index; the complement map decreases)."""
    n = len(read)
    n_kmers = n - KMER_LENGTH + 1
    t_ev, t_path = simulate_events(pore, read, rng)
    c_ev, c_path = simulate_events(pore, reverse_complement(read), rng)
    t_first = _event_map(t_path, n_kmers)
    c_first = _event_map(c_path, n_kmers)
    pos = np.minimum(np.arange(n), n_kmers - 1)
    t_map = t_first[pos]
    c_map = c_first[n_kmers - 1 - pos]
    unit = ScaleParams(1.0, 0.0, 1.0, 1.0, 1.0)
    return NanoporeRead(n, read, unit, unit, t_map, t_ev, c_map, c_ev)


def write_read_set(directory: str, ref_seq: str, pore: PoreModel, n_reads: int,
                   rng: np.random.Generator, min_bases: int = 300,
                   max_bases: int = 2500) -> list[str]:
    """``n_reads`` npRead files of reads drawn from ``ref_seq`` (1-8 %
    substitutions, 0.5-2 % indels), ``min_bases``..``max_bases`` long."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n_reads):
        n_bases = int(rng.integers(min_bases, max_bases))
        lo = int(rng.integers(0, max(len(ref_seq) - n_bases - 1, 1)))
        read = evolve_sequence(ref_seq[lo:lo + n_bases], rng,
                               float(rng.uniform(0.01, 0.08)),
                               float(rng.uniform(0.005, 0.02)))
        path = os.path.join(directory, f"read{i:03d}.npRead")
        write_npread(path, make_npread(read, pore, rng))
        paths.append(path)
    return paths


def write_reference(path: str, n_bases: int, rng: np.random.Generator) -> str:
    """Random one-contig reference FASTA; returns its sequence."""
    seq = "".join(rng.choice(list("ACGT"), n_bases))
    write_fasta(path, [("ref", seq)])
    return seq
