"""What the per-layer metric files share: shares of the window, the device's
idle share and the pipeline's roofline from a traced run's readings.  A
reader returns None where its run gives it nothing to read."""

from __future__ import annotations

from portbench import roofline


def span_share(readings: dict, key: str, source: str = "timing"):
    """A program's span (``timing`` dict) or a harness span, in % of the
    window."""
    v = (readings.get(source) or {}).get(key)
    w = readings.get("window_s")
    return None if v is None or not w else 100.0 * v / w


def idle_pct(readings: dict):
    t = readings.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(readings: dict):
    """The least time of the window's pipeline work over the device time of
    the pipeline's kernels, in %."""
    t, w = readings.get("trace"), readings.get("work")
    if not t or not w:
        return None
    kernels = roofline.pipeline_seconds(t["device_seconds"])
    if kernels <= 0:
        return None
    return 100.0 * roofline.least_seconds(w["ops"], w["bytes"])[0] / kernels


def mfu_pct(readings: dict):
    """The window's pipeline operations over what the card's f32 peak does in
    the window, in %."""
    w, s = readings.get("work"), readings.get("window_s")
    if not w or not s or not readings.get("trace"):
        return None
    return 100.0 * w["ops"] / (s * roofline.F32_OPS_PER_S)
