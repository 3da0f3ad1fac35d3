"""Distribution metrics between Dirichlet-process posterior predictives.

Vectorized NumPy equivalent of the reference's metric suite + memo matrices
(hdp.c:2603-2823): symmetrized KL divergence, Hellinger distance, L2
distance and Jensen-Shannon distance, each integrated over the sampling grid
with the trapezoid rule, with a condensed upper-triangular memo matrix
(get_dir_proc_distance, hdp.c:2603-2626) so repeated queries are O(1).

Densities for unobserved DPs fall back to the nearest observed ancestor
exactly like dir_proc_distance (hdp.c:2640-2648); the fallback is built into
``HierarchicalDirichletProcess.posterior_predictive`` query order here by
resolving through ``is_observed``.

Copied from ``cpecan_signal_tpu/hdp/metrics.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def _trapz(grid: np.ndarray, y: np.ndarray) -> float:
    return float(np.trapezoid(y, grid)) if hasattr(np, "trapezoid") \
        else float(np.trapz(y, grid))


def kl_divergence(grid, p, q) -> float:
    """Symmetrized KL (the reference integrates p log p/q + q log q/p,
    hdp.c:2656-2674)."""
    p = np.asarray(p)
    q = np.asarray(q)
    with np.errstate(divide="ignore", invalid="ignore"):
        y = p * np.log(p / q) + q * np.log(q / p)
    return _trapz(grid, y)


def hellinger_distance(grid, p, q) -> float:
    return float(np.sqrt(max(0.0, 1.0 - _trapz(grid, np.sqrt(np.asarray(p)
                                                             * np.asarray(q))))))


def l2_distance(grid, p, q) -> float:
    d = np.asarray(p) - np.asarray(q)
    return float(np.sqrt(_trapz(grid, d * d)))


def shannon_jensen_distance(grid, p, q) -> float:
    p = np.asarray(p)
    q = np.asarray(q)
    m = 0.5 * (p + q)
    with np.errstate(divide="ignore", invalid="ignore"):
        y = 0.5 * (p * np.log(p / m) + q * np.log(q / m))
    y = np.nan_to_num(y, nan=0.0)
    return float(np.sqrt(max(0.0, _trapz(grid, y))))


METRICS = {
    "kl": kl_divergence,
    "hellinger": hellinger_distance,
    "l2": l2_distance,
    "shannon_jensen": shannon_jensen_distance,
}


class DistributionMetricMemo:
    """Memoized pairwise distances between a finalized HDP's DPs
    (new_distr_metric_memo / get_dir_proc_distance, hdp.c:2603-2626)."""

    def __init__(self, hdp, metric: str = "kl"):
        self.hdp = hdp
        self.metric = METRICS[metric] if isinstance(metric, str) else metric
        n = hdp.num_dps
        self._memo = np.full((n * (n - 1)) // 2, -1.0)

    def _resolved_distr(self, dp_id: int) -> np.ndarray:
        # densities() already resolves unobserved DPs to the nearest observed
        # ancestor (hdp_densities; dir_proc_distance hdp.c:2640-2648)
        return self.hdp.densities(dp_id, self.hdp.grid)

    def distance(self, dp_id_1: int, dp_id_2: int) -> float:
        n = self.hdp.num_dps
        if not (0 <= dp_id_1 < n and 0 <= dp_id_2 < n):
            raise IndexError("invalid Dirichlet process ID")
        if dp_id_1 == dp_id_2:
            return 0.0
        if dp_id_1 < dp_id_2:
            dp_id_1, dp_id_2 = dp_id_2, dp_id_1
        idx = ((dp_id_1 - 1) * dp_id_1) // 2 + dp_id_2
        if self._memo[idx] < 0:
            self._memo[idx] = self.metric(self.hdp.grid,
                                          self._resolved_distr(dp_id_1),
                                          self._resolved_distr(dp_id_2))
        return self._memo[idx]


def compare_hdp_distrs(hdp_1, dp_id_1: int, hdp_2, dp_id_2: int,
                       metric: str = "kl") -> float:
    """Cross-HDP comparison on hdp_1's grid (compare_hdp_distrs,
    hdp.c:2767-2799)."""
    fn = METRICS[metric] if isinstance(metric, str) else metric
    grid = hdp_1.grid
    return fn(grid, hdp_1.densities(dp_id_1, grid), hdp_2.densities(dp_id_2, grid))
