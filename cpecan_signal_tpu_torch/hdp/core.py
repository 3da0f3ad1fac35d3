"""ctypes wrapper around the native HDP core (csrc/hdp_core.cpp).

The sequential CRF Gibbs chain runs in C++ on the host (as in the reference,
impl/hdp.c); finalized distributions are exported as grid tables for the
device emission path.

Copied from ``cpecan_signal_tpu/hdp/core.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package, and with a
loader of its own: the port's copy of the native source,
``cpecan_signal_tpu_torch/csrc/hdp_core.cpp``, is built at first use with
the same g++ flags into ``build/torch_kernels/`` at the repository root,
under a name keyed by a hash of the source, the flags and the host CPU
(``ops/_build.host_library``).
Neither package builds or loads the other's library.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..ops._build import CSRC, host_library

SOURCE = CSRC / "hdp_core.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp", "-shared")
_lib = None
_lib_path: Path | None = None
_lock = threading.Lock()


def _load_lib():
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        path = host_library(SOURCE.name, CXX_FLAGS)
        lib = ctypes.CDLL(str(path))
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.hdp_create.restype = ctypes.c_void_p
        lib.hdp_create.argtypes = [ctypes.c_int64, i64p, ctypes.c_int64, f64p, f64p,
                                   f64p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_int64, ctypes.c_uint64]
        lib.hdp_set_data.argtypes = [ctypes.c_void_p, f64p, i64p, ctypes.c_int64]
        lib.hdp_gibbs.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int]
        lib.hdp_finalize_distrs.argtypes = [ctypes.c_void_p]
        lib.hdp_densities.argtypes = [ctypes.c_void_p, ctypes.c_int64, f64p, f64p,
                                      ctypes.c_int64]
        lib.hdp_get_post_pred.argtypes = [ctypes.c_void_p, ctypes.c_int64, f64p]
        lib.hdp_set_post_pred.argtypes = [ctypes.c_void_p, ctypes.c_int64, f64p]
        lib.hdp_is_observed.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.hdp_is_observed.restype = ctypes.c_int
        lib.hdp_get_gamma.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.hdp_get_gamma.restype = ctypes.c_double
        lib.hdp_samples_taken.argtypes = [ctypes.c_void_p]
        lib.hdp_samples_taken.restype = ctypes.c_int64
        lib.hdp_destroy.argtypes = [ctypes.c_void_p]
        lib.hdp_reset_data.argtypes = [ctypes.c_void_p]
        lib.hdp_enable_snapshots.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.hdp_snapshot_count.argtypes = [ctypes.c_void_p]
        lib.hdp_snapshot_count.restype = ctypes.c_int64
        lib.hdp_get_snapshots.argtypes = [ctypes.c_void_p, f64p, i64p]
        lib.hdp_joint_log_density.argtypes = [ctypes.c_void_p]
        lib.hdp_joint_log_density.restype = ctypes.c_double
        lib.hdp_factor_counts.argtypes = [ctypes.c_void_p, i64p]
        lib.hdp_serialize_chain.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hdp_serialize_chain.restype = ctypes.c_int
        lib.hdp_deserialize_chain.argtypes = [ctypes.c_char_p]
        lib.hdp_deserialize_chain.restype = ctypes.c_void_p
        _lib, _lib_path = lib, path
        return lib


def loaded_library() -> Path | None:
    """The path of the library this process loaded (None before first use)."""
    return _lib_path


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class HierarchicalDirichletProcess:
    """A DP tree with NIG base; mirrors new_hier_dir_proc[_2] (hdp.c:876-...)."""

    def __init__(self, parent_ids, depth: int, mu: float, nu: float,
                 alpha: float, beta: float, grid_start: float, grid_stop: float,
                 grid_length: int, gamma=None, gamma_alpha=None, gamma_beta=None,
                 seed: int = 0):
        lib = _load_lib()
        parent_ids = np.ascontiguousarray(parent_ids, dtype=np.int64)
        self.num_dps = len(parent_ids)
        self.depth = depth
        self.grid = np.linspace(grid_start, grid_stop, grid_length)
        self.sample_gamma = gamma is None
        if self.sample_gamma:
            ga = np.ascontiguousarray(gamma_alpha, dtype=np.float64)
            gb = np.ascontiguousarray(gamma_beta, dtype=np.float64)
            g = np.zeros(depth)
        else:
            g = np.ascontiguousarray(gamma, dtype=np.float64)
            ga = gb = np.zeros(depth)
        self.params = dict(mu=mu, nu=nu, alpha=alpha, beta=beta,
                           grid_start=grid_start, grid_stop=grid_stop,
                           grid_length=grid_length)
        self._h = lib.hdp_create(self.num_dps, _i64p(parent_ids), depth,
                                 _f64p(g), _f64p(ga), _f64p(gb),
                                 1 if self.sample_gamma else 0,
                                 mu, nu, 2.0 * alpha, beta,
                                 grid_start, grid_stop, grid_length, seed)
        self._lib = lib

    def set_data(self, data, dp_ids) -> None:
        data = np.ascontiguousarray(data, dtype=np.float64)
        dp_ids = np.ascontiguousarray(dp_ids, dtype=np.int64)
        self._lib.hdp_set_data(self._h, _f64p(data), _i64p(dp_ids), len(data))

    def reset_data(self) -> None:
        """Destroy the factor tree and clear data/accumulators so new data
        can be passed (reset_hdp_data, hdp.c:1603-1661)."""
        self._lib.hdp_reset_data(self._h)

    def gibbs(self, num_samples: int, burn_in: int, thinning: int,
              verbose: bool = False) -> None:
        self._lib.hdp_gibbs(self._h, num_samples, burn_in, thinning,
                            1 if verbose else 0)

    def finalize(self) -> None:
        self._lib.hdp_finalize_distrs(self._h)

    def densities(self, dp_id: int, xs) -> np.ndarray:
        xs = np.ascontiguousarray(xs, dtype=np.float64)
        out = np.empty(len(xs))
        self._lib.hdp_densities(self._h, dp_id, _f64p(xs), _f64p(out), len(xs))
        return out

    def posterior_predictive(self, dp_id: int) -> np.ndarray:
        out = np.empty(len(self.grid))
        self._lib.hdp_get_post_pred(self._h, dp_id, _f64p(out))
        return out

    def set_posterior_predictive(self, dp_id: int, distr) -> None:
        distr = np.ascontiguousarray(distr, dtype=np.float64)
        self._lib.hdp_set_post_pred(self._h, dp_id, _f64p(distr))

    def is_observed(self, dp_id: int) -> bool:
        return bool(self._lib.hdp_is_observed(self._h, dp_id))

    @property
    def samples_taken(self) -> int:
        return int(self._lib.hdp_samples_taken(self._h))

    def gamma_at(self, depth: int) -> float:
        return float(self._lib.hdp_get_gamma(self._h, depth))

    # --- snapshot diagnostics (hdp.c:2285-2478) ---

    def enable_snapshots(self, enable: bool = True) -> None:
        """Record (joint log density, total factor count) once per Gibbs
        sweep (execute_gibbs_sampling_with_snapshots, hdp.c:2486-2520)."""
        self._lib.hdp_enable_snapshots(self._h, 1 if enable else 0)

    @property
    def snapshots(self) -> tuple[np.ndarray, np.ndarray]:
        n = int(self._lib.hdp_snapshot_count(self._h))
        density = np.empty(n)
        factors = np.empty(n, dtype=np.int64)
        if n:
            self._lib.hdp_get_snapshots(self._h, _f64p(density), _i64p(factors))
        return density, factors

    def joint_log_density(self) -> float:
        """Joint log density of the current factor configuration
        (snapshot_joint_log_density, hdp.c:2302-2312)."""
        return float(self._lib.hdp_joint_log_density(self._h))

    def factor_counts(self) -> np.ndarray:
        """Per-DP factor counts (snapshot_num_factors, hdp.c:2315-2326)."""
        out = np.empty(self.num_dps, dtype=np.int64)
        self._lib.hdp_factor_counts(self._h, _i64p(out))
        return out

    # --- full chain serialization (hdp.c:2825-3278 equivalent) ---

    def serialize_chain(self, path: str) -> None:
        """Serialize structure + data + the LIVE factor tree + RNG stream so
        Gibbs sampling resumes in place after deserialization (the
        reference's full serialization, hdp.c:2825-3278)."""
        if not self._lib.hdp_serialize_chain(self._h, path.encode()):
            raise IOError(f"hdp chain serialization failed: {path}")

    @classmethod
    def deserialize_chain(cls, path: str) -> "HierarchicalDirichletProcess":
        lib = _load_lib()
        h = lib.hdp_deserialize_chain(path.encode())
        if not h:
            raise IOError(f"hdp chain deserialization failed: {path}")
        self = cls.__new__(cls)
        self._lib = lib
        self._h = h
        with open(path) as fh:
            fh.readline()
            head = fh.readline().split()
            self.num_dps, self.depth = int(head[0]), int(head[1])
            self.sample_gamma = bool(int(head[2]))
            prior = [float(v) for v in fh.readline().split()]
            grid = fh.readline().split()
        g0, g1, glen = float(grid[0]), float(grid[1]), int(grid[2])
        self.grid = np.linspace(g0, g1, glen)
        self.params = dict(mu=prior[0], nu=prior[1], alpha=prior[2] / 2.0,
                           beta=prior[3], grid_start=g0, grid_stop=g1,
                           grid_length=glen)
        return self

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hdp_destroy(self._h)
            self._h = None
