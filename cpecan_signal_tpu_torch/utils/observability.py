"""Structured logging, counters, and profiling hooks.

The reference's observability is sonLib log levels (st_logInfo/st_logDebug)
plus per-read summary lines and running-likelihood tables (SURVEY §5).  Here:
a leveled logger, process-wide counters for the alignment statistics the
reference logs (anchor counts, band widths, split counts, pairs emitted), and
a torch.profiler trace context for the card's kernels.

``timed`` is the port's one span: it adds its seconds to ``counters``
(``time.<name>``) and to a caller's ``timing`` dict, and while a torch
profiler records it also marks the profiler's timeline as
``cpecan:<name>``, beside the kernels the span launched.

Copied from ``cpecan_signal_tpu/utils/observability.py``; ``profile_trace``
and the profiler region of ``timed`` are the port's own (torch.profiler, a
Chrome trace, in place of jax.profiler), so that the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
from collections import defaultdict
from time import perf_counter

import torch

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

    def add(self, name: str, value: float = 1.0, timing: dict | None = None) -> None:
        """Add ``value`` under ``name``, and into ``timing[name]`` when the
        caller passed a dict."""
        self.values[name] += value
        if timing is not None:
            timing[name] = timing.get(name, 0) + value

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


# whether a torch profiler records (0.2 us; opening a region costs more even
# with none recording)
_profiling = torch._C._autograd._profiler_enabled
# the region a span opens while a profiler records: a function-scope record.
# torch.profiler.record_function's user-scope region is mirrored onto the
# card's timeline as an annotation from the span's first kernel to its last,
# host gaps included, which a reader of the device's busy time would count
_region = torch._C._profiler._RecordFunctionFast


class timed:
    """A span: ``with timed(name, timing):`` adds the block's seconds to
    ``counters`` (``time.<name>.sum`` / ``.count`` / ``.max``) and, when the
    caller passed a dict, to ``timing[name]``.  Only while a torch profiler
    records does it also open the region ``cpecan:<name>`` on the
    profiler's clock; otherwise it makes no call into torch beyond that
    check.  Spans nest, each level counting its own seconds."""

    __slots__ = ("name", "timing", "region", "t0")

    def __init__(self, name: str, timing: dict | None = None):
        self.name = name
        self.timing = timing

    def __enter__(self):
        self.region = None
        if _profiling():
            self.region = _region("cpecan:" + self.name)
            self.region.__enter__()
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self.t0
        if self.region is not None:
            self.region.__exit__(*exc)
        counters.observe("time." + self.name, dt)
        if self.timing is not None:
            self.timing[self.name] = self.timing.get(self.name, 0.0) + dt
        return False


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace of the CPU and (where there is one) the card's
    kernels over the block, with the program's spans (``timed``) as
    ``cpecan:<name>`` regions, written to ``log_dir`` as a Chrome trace
    (``trace.<pid>.json``, view in chrome://tracing or Perfetto); yields
    the profiler."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.json"))
