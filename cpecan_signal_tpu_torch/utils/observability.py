"""Structured logging, counters, and profiling hooks.

The reference's observability is sonLib log levels (st_logInfo/st_logDebug)
plus per-read summary lines and running-likelihood tables (SURVEY §5).  Here:
a leveled logger, process-wide counters for the alignment statistics the
reference logs (anchor counts, band widths, split counts, pairs emitted), and
a torch.profiler trace context for the card's kernels.

Copied from ``cpecan_signal_tpu/utils/observability.py``; ``profile_trace``
is the port's own (torch.profiler, a Chrome trace, in place of
jax.profiler), so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

logger = logging.getLogger("cpecan_signal_tpu_torch")


def set_log_level(level: str) -> None:
    """sonLib-style --logLevel values (st_setLogLevelFromString)."""
    mapping = {"OFF": logging.CRITICAL, "CRITICAL": logging.CRITICAL,
               "INFO": logging.INFO, "DEBUG": logging.DEBUG}
    logging.basicConfig(format="%(asctime)s %(name)s %(levelname)s %(message)s")
    logger.setLevel(mapping.get(level.upper(), logging.INFO))


class Counters:
    """Process-wide counters (anchor/band statistics, SURVEY §5)."""

    def __init__(self):
        self.values: dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        self.values[name] += value

    def observe(self, name: str, value: float) -> None:
        self.values[f"{name}.sum"] += value
        self.values[f"{name}.count"] += 1
        self.values[f"{name}.max"] = max(self.values.get(f"{name}.max", value),
                                         value)

    def snapshot(self) -> dict[str, float]:
        return dict(self.values)

    def report(self, log=logger.info) -> None:
        for k in sorted(self.values):
            log(f"counter {k} = {self.values[k]}")


counters = Counters()


@contextlib.contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    yield
    counters.observe(f"time.{name}", time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace of the CPU and (where there is one) the card's
    kernels over the block, written to ``log_dir`` as a Chrome trace
    (``trace.<pid>.json``, view in chrome://tracing or Perfetto); yields
    the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.json"))
