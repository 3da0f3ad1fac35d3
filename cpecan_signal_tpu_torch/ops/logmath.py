"""Log-space arithmetic primitives (port of ``cpecan_signal_tpu/ops/logmath.py``).

Two logAdd flavors, as torch functions on tensors of any floating dtype:
  - ``logaddexp``: exact (torch.logaddexp), the f64 engine's default;
  - ``logadd_lookup``: the reference's branch-free 4-piece cubic
    approximation with underflow threshold 7.5 (pairwiseAligner.c:235-255),
    kept for bit-parity validation against the C implementation.

Both operate on log-probabilities with -inf as LOG_ZERO.
"""

from __future__ import annotations

import torch

LOG_UNDERFLOW_THRESHOLD = 7.5

# Cubic coefficients (highest order first) per segment; segment boundaries at
# x <= 1.0, 2.5, 4.5, 7.5 — values from pairwiseAligner.c:238-249.
_SEGS = (
    (1.00, (-0.009350833524763, 0.130659527668286, 0.498799810682272, 0.693203116424741)),
    (2.50, (-0.014532321752540, 0.139942324101744, 0.495635523139337, 0.692140569840976)),
    (4.50, (-0.004605031767994, 0.063427417320019, 0.695956496475118, 0.514272634594009)),
    (7.50, (-0.000458661602210, 0.009695946122598, 0.930734667215156, 0.168037164329057)),
)


def _lookup(x: torch.Tensor) -> torch.Tensor:
    """softplus-like log(exp(x)+1) on x in [0, 7.5] via piecewise cubics."""
    out = None
    for bound, (a, b, c, d) in _SEGS:
        val = ((a * x + b) * x + c) * x + d
        out = val if out is None else torch.where(x <= prev_bound, out, val)
        prev_bound = bound
    return out


def logadd_lookup(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reference logAdd: max + lookup(|x-y|), with underflow cutoff at 7.5."""
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = hi - lo
    approx = _lookup(torch.clamp(d, 0.0, LOG_UNDERFLOW_THRESHOLD)) + lo
    use_hi = torch.isneginf(lo) | (d >= LOG_UNDERFLOW_THRESHOLD) | torch.isnan(d)
    return torch.where(use_hi, hi, approx)


def logaddexp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, y)


def get_logadd(mode: str = "exact"):
    if mode == "exact":
        return logaddexp
    if mode == "lookup":
        return logadd_lookup
    raise ValueError(f"unknown logadd mode: {mode}")
