"""K-mer ranking and sequence -> integer-rank arrays.

The reference ranks 6-mers lexicographically over ACGT (base-4 positional code,
stateMachine.c:120-139) and re-derives the rank with a malloc'd char buffer for
every DP cell.  Here ranks are precomputed once per sequence into int32 arrays so
the TPU engine only ever does integer gathers.

Three k-mer coordinate conventions exist in the reference (pairwiseAligner.c:308-331):
  - ``lead``  (sequence_getKmer):  position i -> chars [i, i+K)        (threeState/fourState/fiveState-kmer)
  - ``trail`` (sequence_getKmer2): position i -> chars [i-1, i+K-1),
              clamped to [0, K) at i <= 0                               (vanilla/echelon)
  - ``clamp`` (sequence_getKmer3): position i -> chars [max(i,0), +K)   (threeStateHdp)

A position whose k-mer contains a non-ACGT char gets rank KMER_SENTINEL; model
parameter tables are padded so that sentinel gathers return 0.0 (matching
emissions_signal_getModelLevelMean's ``kmerIndex > NUM_OF_KMERS -> 0.0``,
stateMachine.c:221-240) and gap tables return LOG_ZERO
(emissions_kmer_getGapProb, stateMachine.c:175-187).

Copied from ``cpecan_signal_tpu/core/kmers.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..constants import KMER_LENGTH, KMER_SENTINEL, NUM_OF_KMERS

_BASE_CODE = np.full(256, -1, dtype=np.int32)
for _i, _b in enumerate("ACGT"):
    _BASE_CODE[ord(_b)] = _i

_POW4 = 4 ** np.arange(KMER_LENGTH - 1, -1, -1, dtype=np.int64)


def base_codes(seq: str) -> np.ndarray:
    """Per-character base codes, -1 for non-ACGT (case sensitive like the reference)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _BASE_CODE[raw]


def kmer_rank(kmer: str) -> int:
    """Rank of a single k-mer string; KMER_SENTINEL if it contains non-ACGT."""
    codes = base_codes(kmer)
    if len(codes) != KMER_LENGTH or (codes < 0).any():
        return KMER_SENTINEL
    return int((codes.astype(np.int64) * _POW4).sum())


def rank_to_kmer(rank: int) -> str:
    """Inverse of kmer_rank for valid ranks."""
    assert 0 <= rank < NUM_OF_KMERS
    out = []
    for p in _POW4:
        out.append("ACGT"[(rank // int(p)) % 4])
    return "".join(out)


def sequence_kmer_ranks(seq: str) -> np.ndarray:
    """Ranks of all len(seq)-K+1 k-mers of ``seq`` (lead convention), int32.

    Vectorized sliding-window positional code; sentinel where any char is non-ACGT.
    """
    codes = base_codes(seq).astype(np.int64)
    n = len(seq) - KMER_LENGTH + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int32)
    win = np.lib.stride_tricks.sliding_window_view(codes, KMER_LENGTH)
    ranks = (win * _POW4).sum(axis=1)
    bad = (win < 0).any(axis=1)
    ranks = np.where(bad, KMER_SENTINEL, ranks)
    return ranks.astype(np.int32)


def ranks_with_convention(seq: str, convention: str) -> np.ndarray:
    """Per-DP-position k-mer rank array of length lX = len(seq)-K+1, plus the
    x=-1 sentinel prepended (index 0 <-> DP position -1).

    The returned array R satisfies R[x_dp + 1] = rank of the k-mer the engine
    reads at DP sequence index x_dp (x_dp in [-1, lX)).
    """
    base = sequence_kmer_ranks(seq)
    lx = len(base)
    out = np.empty(lx + 1, dtype=np.int32)
    if convention == "lead":
        out[0] = KMER_SENTINEL  # getKmer(-1) reads the "n" string -> invalid kmer
        out[1:] = base
    elif convention == "trail":
        # getKmer2: i<=0 -> chars[0:K]; i>0 -> chars[i-1:i-1+K]
        out[0] = base[0] if lx else KMER_SENTINEL
        if lx:
            out[1] = base[0]
            out[2:] = base[: lx - 1]
    elif convention == "clamp":
        out[0] = base[0] if lx else KMER_SENTINEL
        out[1:] = base
    else:
        raise ValueError(f"unknown k-mer convention: {convention}")
    return out


def trailing_pair_ranks(seq: str) -> tuple[np.ndarray, np.ndarray]:
    """(rank of kmer_{i-1}, rank of kmer_i) per DP position for the vanilla /
    echelon skip-bin computation (emissions_signal_getKmerSkipBin,
    stateMachine.c:388-419), index 0 <-> DP position -1.

    At DP position i the reference reads chars [i-1, i+K-1) as kmer_{i-1} and
    [i, i+K) as kmer_i via the getKmer2 pointer.
    """
    base = sequence_kmer_ranks(seq)
    lx = len(base)
    km1 = np.empty(lx + 1, dtype=np.int32)
    ki = np.empty(lx + 1, dtype=np.int32)
    if lx == 0:
        km1[:] = KMER_SENTINEL
        ki[:] = KMER_SENTINEL
        return km1, ki
    # Output index j corresponds to DP position i = j-1; the getKmer2 pointer
    # resolves to element max(i-1, 0), so kmer_{i-1} = base[max(j-2, 0)] and
    # kmer_i = base[max(j-2, 0) + 1] (DP positions -1 and 0 coincide).
    ptr = np.maximum(np.arange(lx + 1) - 2, 0)
    km1[:] = base[ptr]
    ki[:] = base[np.minimum(ptr + 1, lx - 1)]
    return km1, ki
