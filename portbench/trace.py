"""The traced run: the harness's host spans and the device's operations, from
one torch.profiler trace of the measured window, reduced to what the
per-layer readers and the result's breakdown take.

A span is a ``torch.profiler.record_function`` region named ``SPAN +
name``, opened by the harness around its calls into the program's layers;
device operations are the trace's kernels, copies and fills.  Times are
seconds.  ``reduce`` works on plain tuples so that it can be checked
without a card.
"""

from __future__ import annotations

import contextlib
import time

SPAN = "portbench:"
WINDOW = "window"       # the span around the whole measured window


class Spans:
    """Host spans of a run: a context manager per call into a layer, which
    in a traced run also marks the profiler's timeline."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            import torch
            with torch.profiler.record_function(SPAN + name):
                yield
        else:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def _call(e, *names):
    """The first of an event's accessors that this torch has, called."""
    for n in names:
        f = getattr(e, n, None)
        if f is not None:
            return f()
    raise AttributeError(f"profiler event has none of {names}")


def events_of(prof) -> list[tuple[str, str, float, float]]:
    """(kind, name, start s, end s) of the profiler's device operations
    (kind "device": kernels, copies, fills) and of the harness's spans (kind
    "span"), on the profiler's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        try:
            t0 = _call(e, "start_ns") * 1e-9
            dt = _call(e, "duration_ns") * 1e-9
        except AttributeError:
            t0 = _call(e, "start_us") * 1e-6
            dt = _call(e, "duration_us") * 1e-6
        on_device = str(e.device_type()).split(".")[-1].upper() == "CUDA"
        if name.startswith(SPAN):
            if not on_device:      # the profiler mirrors annotations onto the device
                out.append(("span", name[len(SPAN):], t0, t0 + dt))
        elif on_device:
            out.append(("device", name, t0, t0 + dt))
    return out


def window_of(events, fallback: tuple[float, float]) -> tuple[float, float]:
    """The extent of the harness's ``WINDOW`` span, else ``fallback``."""
    w = [(t0, t1) for k, n, t0, t1 in events if k == "span" and n == WINDOW]
    return w[0] if w else fallback


def _union(intervals):
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def reduce(events, window: tuple[float, float], top: int = 10) -> dict:
    """busy_s (the union of device operations inside ``window``), window_s,
    the device seconds of each operation by name, the largest ``top`` of
    them, and the ``top`` host spans that the device sat idle under the
    longest (the idle time inside each span, by span name; "outside spans"
    for the rest)."""
    w0, w1 = window
    dev = sorted((max(t0, w0), min(t1, w1), n) for k, n, t0, t1 in events
                 if k == "device" and t1 > w0 and t0 < w1)
    by_name: dict[str, float] = {}
    for t0, t1, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t1 - t0)
    busy = _union([(t0, t1) for t0, t1, _n in dev])
    gaps, end = [], w0
    for t0, t1, _n in dev:
        if t0 > end:
            gaps.append((end, t0))
        end = max(end, t1)
    if end < w1:
        gaps.append((end, w1))
    spans = sorted((t0, t1, n) for k, n, t0, t1 in events if k == "span" and n != WINDOW)
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        covered = 0.0
        for s0, s1, n in spans:
            if s1 <= g0 or s0 >= g1:
                continue
            ov = min(s1, g1) - max(s0, g0)
            idle[n] = idle.get(n, 0.0) + ov
            covered += ov
        rest = (g1 - g0) - covered
        if rest > 0:
            idle["outside spans"] = idle.get("outside spans", 0.0) + rest
    rank = lambda d: sorted(([n, v] for n, v in d.items()), key=lambda x: -x[1])[:top]  # noqa: E731
    return {"busy_s": busy, "window_s": w1 - w0, "device_seconds": by_name,
            "device_ops": rank(by_name), "idle_gaps": rank(idle)}
