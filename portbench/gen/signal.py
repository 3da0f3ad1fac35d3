"""Signal traffic from a seed: a 6-mer pore model, a reference contig, and
two-strand reads with their events and guides.

A frozen, vectorised copy of the port's ``synthetic.py`` generators
(``write_pore_model``, ``evolve_with_truth``, ``simulate_events``,
``make_npread``), kept here so that the yardstick does not move when the
program's generators do.  The event process is the same: along the read's
k-mers an event stays on its k-mer with probability ``stay``, skips one k-mer
with probability ``skip`` and moves on by one otherwise; levels carry
Gaussian noise.  Each read also carries the guide that its true placement
gives, in the shape bwa would hand signalAlign: a CIGAR of match runs and
gaps from the first to the last aligned base.
"""

from __future__ import annotations

import numpy as np

K = 6
N_KMERS = 4 ** K
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
NOISE_SD = 0.3        # model noise sd: lambda = noise_mean^3 / NOISE_SD^2
STRUCTURE_SEED = 1150  # the reads' shapes are the same for every run seed
_POW4 = 4 ** np.arange(K - 1, -1, -1, dtype=np.int64)


def pore_model(rng: np.random.Generator) -> np.ndarray:
    """(4096, 5) pore-model rows (level mean 40-90 pA, level sd 1, noise mean
    1-3, noise sd NOISE_SD, noise lambda), as ``synthetic.write_pore_model``
    draws them."""
    level = rng.uniform(40, 90, N_KMERS)
    noise = rng.uniform(1, 3, N_KMERS)
    return np.stack([level, np.ones(N_KMERS), noise, np.full(N_KMERS, NOISE_SD),
                     noise ** 3 / NOISE_SD ** 2], axis=1)


def random_codes(rng: np.random.Generator, n: int) -> np.ndarray:
    """n base codes 0..3 (A, C, G, T)."""
    return rng.integers(0, 4, n).astype(np.uint8)


def to_str(codes: np.ndarray) -> str:
    return BASES[codes].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def evolve_with_truth(x: np.ndarray, rng: np.random.Generator, sub: float, ins: float,
                      dele: float, mean_len: float = 2.0,
                      structure: np.random.Generator | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Codes descended from the codes ``x`` and their true alignment: deletion
    runs start at a base with probability ``dele``, insertion runs follow a
    base with probability ``ins`` (run lengths geometric, mean ``mean_len``),
    a kept base is substituted by one of the other three with probability
    ``sub``.  ``structure`` (default ``rng``) draws where the indels fall and
    how long they are, ``rng`` the rest.  Returns (y, truth (n, 2) int64 of
    (x, y) index pairs)."""
    structure = rng if structure is None else structure
    n = len(x)
    cover = np.zeros(n + 1, dtype=np.int64)
    starts = np.flatnonzero(structure.random(n) < dele)
    ends = np.minimum(starts + structure.geometric(1.0 / mean_len, len(starts)), n)
    np.add.at(cover, starts, 1)
    np.add.at(cover, ends, -1)
    keep = np.cumsum(cover[:n]) == 0
    swap = keep & (rng.random(n) < sub)
    code = np.where(swap, (x.astype(np.int64) + rng.integers(1, 4, n)) % 4, x)
    ins_len = np.where(structure.random(n) < ins, structure.geometric(1.0 / mean_len, n), 0)
    emit = keep + ins_len
    off = np.cumsum(emit) - emit
    y = rng.integers(0, 4, int(emit.sum()))
    kept = np.flatnonzero(keep)
    y[off[kept]] = code[kept]
    return y.astype(np.uint8), np.stack([kept, off[kept]], axis=1).astype(np.int64)


def kmer_ranks(codes: np.ndarray) -> np.ndarray:
    """Ranks of the len - K + 1 k-mers (lexicographic over ACGT)."""
    win = np.lib.stride_tricks.sliding_window_view(codes.astype(np.int64), K)
    return (win * _POW4).sum(axis=1)


def simulate_events(model: np.ndarray, ranks: np.ndarray, rng: np.random.Generator,
                    stay: float = 0.10, skip: float = 0.04, noise_sd: float = 0.6,
                    structure: np.random.Generator | None = None):
    """Events (n, 3) walking the k-mers ``ranks``, and each k-mer's first
    event (a skipped k-mer takes the previous k-mer's).  A visited k-mer
    holds Geometric(1 - stay) events; leaving it skips the next k-mer with
    probability skip / (1 - stay), as the per-event draws of
    ``synthetic.simulate_events`` give.  ``structure`` (default ``rng``)
    draws the stays and skips, ``rng`` the events' values."""
    structure = rng if structure is None else structure
    n = len(ranks)
    jump2 = structure.random(n) < skip / (1.0 - stay)
    # k is visited unless k-1 was visited and left by a skip: within a run of
    # r skips just before k, visits alternate from the run's visited start
    run = np.zeros(n, dtype=np.int64)
    if n > 1:
        idx = np.arange(1, n)
        last_plain = np.maximum.accumulate(np.where(~jump2[:-1], idx, 0))
        run[1:] = idx - last_plain
    visited = run % 2 == 0
    counts = np.where(visited, structure.geometric(1.0 - stay, n), 0)
    total = int(counts.sum())
    r = np.repeat(ranks, counts)
    ev = np.empty((total, 3))
    ev[:, 0] = model[r, 0] + rng.normal(0.0, noise_sd, total)
    ev[:, 1] = np.maximum(model[r, 2] + rng.normal(0.0, 0.2, total), 0.3)
    ev[:, 2] = np.maximum(rng.normal(0.01, 0.004, total), 0.002)
    first = np.where(visited, np.cumsum(counts) - counts, -1)
    first[0] = max(first[0], 0)
    return ev, np.maximum.accumulate(first)


def read_lengths(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """The same n read lengths for every seed: the quantiles (i + 0.5) / n of
    a log-normal (median, sigma), clipped to [lo, hi]."""
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def guide_ops(truth: np.ndarray) -> list[tuple[str, int]]:
    """CIGAR ops (M, D: a gap in the read, I: a gap in the reference) from
    the first to the last true pair."""
    dx, dy = np.diff(truth, axis=0).T
    code = np.stack([np.where(dx > 1, 1, -1), np.where(dy > 1, 2, -1),
                     np.zeros_like(dx)], axis=1).ravel()         # 0 M, 1 D, 2 I
    size = np.stack([dx - 1, dy - 1, np.ones_like(dx)], axis=1).ravel()
    keep = code >= 0
    code = np.concatenate([[0], code[keep]])
    size = np.concatenate([[1], size[keep]])
    starts = np.concatenate([[0], np.flatnonzero(np.diff(code) != 0) + 1])
    return [("MDI"[c], int(n)) for c, n in zip(code[starts].tolist(),
                                               np.add.reduceat(size, starts).tolist())]


def make_read(ref: np.ndarray, models, rng: np.random.Generator, n_bases: int,
              sub: float, indel: float, structure: np.random.Generator | None = None) -> dict:
    """One two-strand read of about ``n_bases`` drawn from ``ref`` (either
    strand) with ``sub`` substitutions and ``indel`` indels a base, its
    events under the template and complement ``models`` and event maps as an
    npRead holds them, and its guide from the true placement.
    ``structure`` (default ``rng``) draws the read's shape: where its indels
    fall and how many events each k-mer holds; ``rng`` all the rest."""
    lo = int(rng.integers(0, len(ref) - n_bases - 1))
    forward = bool(rng.random() < 0.5)
    src = ref[lo:lo + n_bases]
    if not forward:
        src = revcomp_codes(src)
    read, truth = evolve_with_truth(src, rng, sub, indel / 2, indel / 2, structure=structure)
    n = len(read)
    n_kmers = n - K + 1
    t_ev, t_first = simulate_events(models[0], kmer_ranks(read), rng, structure=structure)
    c_ev, c_first = simulate_events(models[1], kmer_ranks(revcomp_codes(read)), rng,
                                    structure=structure)
    pos = np.minimum(np.arange(n), n_kmers - 1)
    a, b = int(truth[0, 0]), int(truth[-1, 0]) + 1
    start1, end1 = (lo + a, lo + b) if forward else (lo + n_bases - a, lo + n_bases - b)
    return {"seq": read, "t_events": t_ev, "t_map": t_first[pos],
            "c_events": c_ev, "c_map": c_first[n_kmers - 1 - pos],
            "guide": {"strand1": forward, "start1": start1, "end1": end1,
                      "start2": int(truth[0, 1]), "end2": int(truth[-1, 1]) + 1,
                      "ops": guide_ops(truth)}}


def error_rates(n: int, sub_range, indel_range) -> np.ndarray:
    """(n, 2) substitution and indel rates spread evenly over their ranges,
    the i-th for the i-th shortest read: every seed pairs the same lengths
    with the same rates (two low-discrepancy sequences, so that neither
    rate follows the length).  A read's indels decide how far its anchors
    lie apart, so its band's width and the buckets it falls in."""
    i = np.arange(n) + 0.5
    u = (i * 0.6180339887498949) % 1.0
    v = (i * 0.7548776662466927) % 1.0
    return np.stack([sub_range[0] + u * (sub_range[1] - sub_range[0]),
                     indel_range[0] + v * (indel_range[1] - indel_range[0])], axis=1)


def read_pool(ref: np.ndarray, models, rng: np.random.Generator,
              lengths: np.ndarray, sub_range, indel_range) -> list[dict]:
    """Reads of the given lengths with their error rates (``error_rates``),
    in an order drawn from ``rng``.  Every seed gives each read the same
    shape (its indels and its events' count a k-mer come from a generator
    of the read's rank alone, STRUCTURE_SEED), so its bands, buckets and
    work; the seed draws the reference, the models, where and on which
    strand each read lies, its substitutions and every value."""
    lengths = np.sort(lengths)
    rates = error_rates(len(lengths), sub_range, indel_range)
    return [make_read(ref, models, rng, int(lengths[i]), *map(float, rates[i]),
                      structure=np.random.default_rng([STRUCTURE_SEED, i]))
            for i in rng.permutation(len(lengths))]
