"""The realign heads' reader: the span "head" over the counter
"head.anchors" in ns an anchor, and None where either is missing (as on a
program that has no such counter)."""

from __future__ import annotations

import pytest

from portbench import run


def reader():
    return run.load_module(run.BENCH_DIR / "metrics" / "realign.head_ns_per_anchor.py").read


def test_head_ns_per_anchor_reads_span_over_counter():
    timing = {"head": 0.75, "head.stage": 0.5, "head.anchors": 1_500_000}
    assert reader()({"window_s": 30.0, "timing": timing}) == pytest.approx(500.0)


@pytest.mark.parametrize("timing", [{"head": 0.75, "head.stage": 0.5},   # the parent's
                                    {"head.anchors": 1_500_000},
                                    {"head": 0.75, "head.anchors": 0},
                                    None])
def test_head_ns_per_anchor_none_without_its_inputs(timing):
    readings = {"window_s": 30.0} if timing is None else {"window_s": 30.0, "timing": timing}
    assert reader()(readings) is None
