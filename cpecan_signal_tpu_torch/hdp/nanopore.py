"""NanoporeHDP: one leaf DP per k-mer over an arbitrary alphabet.

Mirrors impl/nanopore_hdp.c: topology builders (flat / multiset / middle-2-nts
/ purine-composition, :448-833), NIG prior fit from the pore model by MLE
(:123-158 -> hdp_math_utils.c:777), alignment-TSV ingestion (:184-261), and
serialization (:834-873).  The default build path uses the expanded
epigenetic alphabet "ACEGOT" with a 30-90 pA x 1200-point sampling grid
(loadNanoporeHdpFromScratch, :875-908).

Divergence note: the reference's NIG-prior fit reads the *level mean* into the
precision variable due to a sscanf copy/paste slip (nanopore_hdp.c:140-144);
here the intended precision 1/level_sd^2 is used.

Copied from ``cpecan_signal_tpu/hdp/nanopore.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np

from ..constants import EPIGENETIC_ALPHABET, KMER_LENGTH, LOG_ZERO
from .core import HierarchicalDirichletProcess

DEFAULT_GRID = (30.0, 90.0, 1200)

# alignment TSV columns (nanopore_hdp.c:9-13: strand 4, kmer 9, signal 13 —
# 0-based; matches this package's 15-column posterior TSV where col 13 is the
# descaled event mean)
COL_STRAND = 4
COL_KMER = 9
COL_SIGNAL = 13


def kmer_id(kmer: str, alphabet: str) -> int:
    """Lexicographic rank over the alphabet (nanopore_hdp.c kmer_id :375)."""
    n = len(alphabet)
    idx = {c: i for i, c in enumerate(alphabet)}
    x = 0
    for c in kmer:
        x = x * n + idx[c]
    return x


def id_to_kmer(i: int, alphabet: str, k: int = KMER_LENGTH) -> str:
    n = len(alphabet)
    out = []
    for _ in range(k):
        out.append(alphabet[i % n])
        i //= n
    return "".join(reversed(out))


def multiset_number(n: int, k: int) -> int:
    return math.comb(n + k - 1, k)


def _word(word_id: int, n: int, k: int) -> list[int]:
    w = []
    for _ in range(k):
        w.append(word_id % n)
        word_id //= n
    return w[::-1]


def word_id_to_multiset_id(word_id: int, n: int, k: int) -> int:
    """Rank of the sorted multiset among all multisets (nanopore_hdp.c:312-370
    semantics: combinatorial rank of the nondecreasing word)."""
    ms = sorted(_word(word_id, n, k))
    # rank nondecreasing sequences lexicographically
    rank = 0
    prev = 0
    for pos, c in enumerate(ms):
        for v in range(prev, c):
            # count nondecreasing completions starting with value >= v
            rank += multiset_number(n - v, k - pos - 1)
        prev = c
    return rank


def kmer_id_to_middle_nts_id(word_id: int, n: int, k: int) -> int:
    w = _word(word_id, n, k)
    return n * w[k // 2 - 1] + w[k // 2]


def kmer_id_to_purine_id(word_id: int, alphabet: str, k: int) -> int:
    """Purine (A/G and their methyl variants) composition pattern id
    (nanopore_hdp.c purine topology :690-833)."""
    purines = {i for i, c in enumerate(alphabet) if c in "AG"}
    w = _word(word_id, len(alphabet), k)
    pid = 0
    for c in w:
        pid = 2 * pid + (1 if c in purines else 0)
    return pid


def nig_prior_from_model(model_path: str) -> tuple[float, float, float, float]:
    """MLE Normal-Inverse-Gamma prior from pore-model level means/precisions
    (mle_normal_inverse_gamma_params, hdp_math_utils.c:777-810)."""
    from ..models.pore_model import load_pore_model
    from ..constants import NUM_OF_KMERS
    pore = load_pore_model(model_path)
    mus = pore.match_model[:NUM_OF_KMERS, 0]
    sds = pore.match_model[:NUM_OF_KMERS, 1]
    taus = 1.0 / (sds * sds)
    return mle_normal_inverse_gamma(mus, taus)


def _digamma(x: float) -> float:
    """Asymptotic digamma with recurrence (cephes-style, as in
    hdp_math_utils.c:572-660)."""
    result = 0.0
    while x < 6.0:
        result -= 1.0 / x
        x += 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    series = inv2 * (1 / 12.0 - inv2 * (1 / 120.0 - inv2 * (1 / 252.0 - inv2 *
             (1 / 240.0 - inv2 * (1 / 132.0)))))
    return result + math.log(x) - 0.5 * inv - series


def _trigamma(x: float) -> float:
    result = 0.0
    while x < 6.0:
        result += 1.0 / (x * x)
        x += 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    return result + inv * (1.0 + 0.5 * inv + inv2 * (1 / 6.0 - inv2 *
                           (1 / 30.0 - inv2 * (1 / 42.0))))


def mle_normal_inverse_gamma(mus, taus):
    mus = np.asarray(mus, dtype=np.float64)
    taus = np.asarray(taus, dtype=np.float64)
    n = len(mus)
    sum_tau = taus.sum()
    sum_log_tau = np.log(taus).sum()
    mu0 = float((mus * taus).sum() / sum_tau)
    nu = float(n / (taus * (mus - mu0) ** 2).sum())
    # Newton iteration for alpha (newton_approx_alpha, hdp_math_utils.c:763-790)
    const = sum_log_tau / n - math.log(sum_tau / n)
    alpha = 1.0
    for _ in range(200):
        f = math.log(alpha) - _digamma(alpha) + const
        df = 1.0 / alpha - _trigamma(alpha)
        alpha_new = alpha - f / df
        if abs(alpha_new - alpha) < 1e-12:
            alpha = alpha_new
            break
        alpha = alpha_new
    beta = n * alpha / sum_tau
    return mu0, nu, float(alpha), float(beta)


@dataclass
class NanoporeHDP:
    """Leaf DP per k-mer + hierarchy per topology; wraps the native HDP."""

    alphabet: str
    kmer_length: int
    hdp: HierarchicalDirichletProcess
    topology: str

    @property
    def num_leaves(self) -> int:
        return len(self.alphabet) ** self.kmer_length

    def kmer_id(self, kmer: str) -> int:
        return kmer_id(kmer, self.alphabet)

    def rank_seq(self, seq: str, convention: str = "clamp") -> np.ndarray:
        """Per-DP-position k-mer ids over THIS alphabet, with the x = -1
        sentinel prepended (the contract of core.kmers.ranks_with_convention
        but over an expanded alphabet — e.g. an 'ACEGOT' target produced by
        the --substitute methylation rewrite, vanillaAlign.c:638-642).
        clamp follows sequence_getKmer3 (x < 0 reads the first k-mer)."""
        assert convention == "clamp"
        k = self.kmer_length
        lx = len(seq) - k + 1
        out = np.empty(lx + 1, dtype=np.int64)
        for x in range(lx):
            out[x + 1] = self.kmer_id(seq[x:x + k])
        out[0] = out[1] if lx > 0 else 0
        return out

    def update_from_alignment(self, tsv_path: str, strand_filter: str | None = None,
                              substitute: dict[str, str] | None = None) -> int:
        """Ingest (signal, kmer) pairs from a 15-column alignment TSV
        (update_nhdp_from_alignment_with_filter, nanopore_hdp.c:184-261)."""
        signals, ids = [], []
        with open(tsv_path) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if strand_filter is not None and f[COL_STRAND] != strand_filter:
                    continue
                kmer = f[COL_KMER]
                if substitute:
                    kmer = "".join(substitute.get(c, c) for c in kmer)
                if any(c not in self.alphabet for c in kmer):
                    continue
                signals.append(float(f[COL_SIGNAL]))
                ids.append(self.kmer_id(kmer))
        if signals:
            self.hdp.set_data(np.asarray(signals), np.asarray(ids))
        return len(signals)

    def set_assignments(self, kmers: list[str], signals: list[float]) -> int:
        ids = [self.kmer_id(k) for k in kmers]
        if ids:
            self.hdp.set_data(np.asarray(signals, dtype=np.float64),
                              np.asarray(ids, dtype=np.int64))
        return len(ids)

    def gibbs(self, num_samples=10_000, burn_in=100_000, thinning=100,
              verbose=False) -> None:
        """Default training budget per round (vanillaAlign.c:148)."""
        self.hdp.gibbs(num_samples, burn_in, thinning, verbose)

    def finalize(self) -> None:
        self.hdp.finalize()

    def kmer_density(self, kmer: str, xs) -> np.ndarray:
        return self.hdp.densities(self.kmer_id(kmer), np.atleast_1d(xs))

    def density_table(self, standard_ranks: bool = True) -> np.ndarray:
        """(num_ACGT_kmers+2, grid) density table for the TPU emission gather;
        ranks are standard ACGT ranks mapped into this alphabet."""
        from ..constants import NUM_OF_KMERS
        from ..core.kmers import rank_to_kmer
        grid = self.hdp.grid
        table = np.zeros((NUM_OF_KMERS + 2, len(grid)))
        for r in range(NUM_OF_KMERS):
            kmer = rank_to_kmer(r)
            table[r] = self.hdp.densities(self.kmer_id(kmer), grid)
        return table

    def alphabet_density_fn(self):
        """Density function over THIS alphabet's k-mer ids, evaluated
        lazily per distinct id (a full ACEGOT table would be 46,656 x grid
        — ~450 MB — so rows are materialized on demand and cached).  The
        returned function carries a ``rank_seq`` attribute so
        make_signal_sm3_hdp can rank substituted targets over the expanded
        alphabet.  Raw-density semantics as density_logp_fn."""
        grid = self.hdp.grid
        cache: dict[int, np.ndarray] = {}

        def density(ids: np.ndarray, means: np.ndarray) -> np.ndarray:
            ids = np.asarray(ids)
            uniq = np.unique(ids)
            for i in uniq:
                if int(i) not in cache:
                    cache[int(i)] = self.hdp.densities(int(i), grid)
            if len(cache) > 8192:   # bound memory on pathological id churn
                for key in list(cache)[: len(cache) - 8192]:
                    del cache[key]
                for i in uniq:
                    if int(i) not in cache:
                        cache[int(i)] = self.hdp.densities(int(i), grid)
            table = np.stack([cache[int(i)] for i in uniq])
            rows = np.searchsorted(uniq, ids)
            pos = np.clip((means - grid[0]) / (grid[1] - grid[0]), 0,
                          len(grid) - 1 - 1e-9)
            i0 = pos.astype(np.int64)
            t = pos - i0
            v = ((1 - t) * table[rows, i0]
                 + t * table[rows, np.minimum(i0 + 1, len(grid) - 1)])
            return np.maximum(v, 0.0)

        density.rank_seq = self.rank_seq
        return density

    def density_logp_fn(self):
        """Vectorized density function for make_signal_sm3_hdp: linear
        interpolation over the finalized grid table, clamped >= 0 as in
        dir_proc_density (hdp.c:2577-2601).

        NOTE reference parity: the returned value is the RAW density, not
        its log — stateMachine3HDP_cellCalculate adds
        `eP = getMatchProbFcn(...)` (the density itself) straight into the
        log-space recursion (stateMachine.c:1353-1362), so a zero density
        contributes eP = 0.0, not -inf.  The name is kept for the
        make_signal_sm3_hdp call-site contract ("the emission channel
        value")."""
        table = self.density_table()
        grid = self.hdp.grid

        def density_logp(ranks: np.ndarray, means: np.ndarray) -> np.ndarray:
            ranks = np.minimum(np.asarray(ranks), table.shape[0] - 1)
            pos = np.clip((means - grid[0]) / (grid[1] - grid[0]), 0,
                          len(grid) - 1 - 1e-9)
            i0 = pos.astype(np.int64)
            t = pos - i0
            v = (1 - t) * table[ranks, i0] + t * table[ranks, np.minimum(i0 + 1,
                                                                         len(grid) - 1)]
            return np.maximum(v, 0.0)

        # the same table, exposed for the device alignment fast path
        # (make_signal_sm3_hdp builds sm.hdp_pack from it; the device does
        # this exact interpolation on chip, engine/batch_align hdp buckets)
        density_logp.density_table = (table.astype(np.float32),
                                      float(grid[0]),
                                      float(grid[1] - grid[0]))
        return density_logp

    def serialize_chain(self, path: str) -> None:
        """Full chain serialization: alphabet/topology header + the live
        factor tree, data, accumulators and RNG stream, so Gibbs resumes in
        place after deserialization (the reference's full serialization,
        hdp.c:2825-3278 wrapped by serialize_nhdp, nanopore_hdp.c:834-873)."""
        import tempfile
        fd, tmp = tempfile.mkstemp(suffix=".hdpchain")
        os.close(fd)
        try:
            self.hdp.serialize_chain(tmp)
            with open(path, "w") as out:
                out.write(f"nhdpchain\t{self.alphabet}\t{self.kmer_length}\t"
                          f"{self.topology}\n")
                with open(tmp) as fh:
                    for line in fh:
                        out.write(line)
        finally:
            os.unlink(tmp)

    def serialize(self, path: str) -> None:
        """alphabet header + structure params + finalized distributions
        (serialize_nhdp, nanopore_hdp.c:834-873 — own format, same content)."""
        with open(path, "w") as fh:
            fh.write(f"{self.alphabet}\t{self.kmer_length}\t{self.topology}\n")
            p = self.hdp.params
            fh.write("\t".join(str(p[k]) for k in
                               ("mu", "nu", "alpha", "beta", "grid_start",
                                "grid_stop", "grid_length")) + "\n")
            fh.write(f"{self.hdp.samples_taken}\n")
            for dp_id in range(self.hdp.num_dps):
                if self.hdp.is_observed(dp_id):
                    distr = self.hdp.posterior_predictive(dp_id)
                    fh.write(f"{dp_id}\t" + "\t".join(f"{v:.17g}" for v in distr)
                             + "\n")


def _topology_parents(topology: str, alphabet: str, k: int) -> tuple[np.ndarray, int]:
    n = len(alphabet)
    num_leaves = n ** k
    if topology == "flat":
        parents = np.full(num_leaves + 1, num_leaves, dtype=np.int64)
        parents[num_leaves] = -1
        return parents, 2
    if topology == "multiset":
        num_mid = multiset_number(n, k)
        base = num_leaves + num_mid
        parents = np.empty(base + 1, dtype=np.int64)
        for wid in range(num_leaves):
            parents[wid] = num_leaves + word_id_to_multiset_id(wid, n, k)
        parents[num_leaves:base] = base
        parents[base] = -1
        return parents, 3
    if topology == "middle_2_nts":
        num_mid = n * n
        base = num_leaves + num_mid
        parents = np.empty(base + 1, dtype=np.int64)
        for wid in range(num_leaves):
            parents[wid] = num_leaves + kmer_id_to_middle_nts_id(wid, n, k)
        parents[num_leaves:base] = base
        parents[base] = -1
        return parents, 3
    if topology == "purine":
        num_mid = 2 ** k
        base = num_leaves + num_mid
        parents = np.empty(base + 1, dtype=np.int64)
        for wid in range(num_leaves):
            parents[wid] = num_leaves + kmer_id_to_purine_id(wid, alphabet, k)
        parents[num_leaves:base] = base
        parents[base] = -1
        return parents, 3
    raise ValueError(f"unknown HDP topology {topology!r}")


# NanoporeHdpType enum order (nanopore_hdp.h / vanillaAlign -p 0..3)
HDP_TYPES = ["flat", "multiset", "middle_2_nts", "purine"]


def build_nanopore_hdp(topology: str, model_path: str,
                       alphabet: str = EPIGENETIC_ALPHABET,
                       kmer_length: int = KMER_LENGTH,
                       grid=DEFAULT_GRID, gamma=None,
                       gamma_alpha=None, gamma_beta=None, seed: int = 0
                       ) -> NanoporeHDP:
    """Topology + NIG-prior construction (loadNanoporeHdpFromScratch,
    nanopore_hdp.c:875-908; default gammas follow its fixed-gamma path)."""
    parents, depth = _topology_parents(topology, alphabet, kmer_length)
    mu, nu, alpha, beta = nig_prior_from_model(model_path)
    if gamma is None and gamma_alpha is None:
        gamma = [1.0] * depth
    hdp = HierarchicalDirichletProcess(
        parents, depth, mu, nu, alpha, beta,
        grid[0], grid[1], grid[2], gamma=gamma,
        gamma_alpha=gamma_alpha, gamma_beta=gamma_beta, seed=seed)
    return NanoporeHDP(alphabet=alphabet, kmer_length=kmer_length, hdp=hdp,
                       topology=topology)


def deserialize_nhdp_chain(path: str) -> NanoporeHDP:
    """Inverse of NanoporeHDP.serialize_chain: restores the live factor tree,
    data, accumulators and RNG stream; Gibbs sampling continues in place."""
    import tempfile
    with open(path) as fh:
        head = fh.readline().rstrip("\n").split("\t")
        if head[0] != "nhdpchain":
            raise ValueError(f"not an nhdp chain file: {path}")
        _, alphabet, k, topology = head
        fd, tmp = tempfile.mkstemp(suffix=".hdpchain")
        os.close(fd)
        try:
            with open(tmp, "w") as out:
                for line in fh:
                    out.write(line)
            hdp = HierarchicalDirichletProcess.deserialize_chain(tmp)
        finally:
            os.unlink(tmp)
    return NanoporeHDP(alphabet=alphabet, kmer_length=int(k), hdp=hdp,
                       topology=topology)


def deserialize_nhdp(path: str) -> NanoporeHDP:
    with open(path) as fh:
        first = fh.readline().rstrip("\n").split("\t")
    if first and first[0] == "nhdpchain":
        return deserialize_nhdp_chain(path)
    with open(path) as fh:
        alphabet, k, topology = fh.readline().rstrip("\n").split("\t")
        k = int(k)
        mu, nu, alpha, beta, gs, ge, gl = fh.readline().split()
        samples = int(fh.readline())
        parents, depth = _topology_parents(topology, alphabet, k)
        hdp = HierarchicalDirichletProcess(
            parents, depth, float(mu), float(nu), float(alpha), float(beta),
            float(gs), float(ge), int(gl), gamma=[1.0] * depth)
        for line in fh:
            f = line.rstrip("\n").split("\t")
            hdp.set_posterior_predictive(int(f[0]),
                                         np.asarray(f[1:], dtype=np.float64))
    return NanoporeHDP(alphabet=alphabet, kmer_length=k, hdp=hdp,
                       topology=topology)
