"""The per-layer readers of the program's spans and counters: each returns
its value from hand-made readings and counters, and None where its inputs
are missing (as on a program that has no such span or counter)."""

from __future__ import annotations

import pytest

from portbench import run
from cpecan_signal_tpu_torch.utils import observability

SHARES = {"realign.stage_share": "head.stage", "realign.split_share": "head.split",
          "realign.assemble_share": "tail.assemble", "realign.reweight_share": "tail.reweight",
          "realign.filter_share": "tail.filter", "realign.cigar_share": "tail.cigar"}
EM = ("em.lane_fill", "em.sm_fill", "em.setup_prep_s", "em.setup_build_s")


def reader(name):
    return run.load_module(run.BENCH_DIR / "metrics" / f"{name}.py").read


@pytest.fixture
def counters(monkeypatch):
    c = observability.Counters()
    monkeypatch.setattr(observability, "counters", c)
    return c


@pytest.mark.parametrize("name", sorted(SHARES))
def test_realign_share_reads_its_span(name):
    timing = {"head": 6.0, "tail": 12.0, SHARES[name]: 3.0}
    assert reader(name)({"window_s": 30.0, "timing": timing}) == pytest.approx(10.0)
    # the parent's timing: head and tail alone
    assert reader(name)({"window_s": 30.0, "timing": {"head": 6.0, "tail": 12.0}}) is None
    assert reader(name)({"timing": timing}) is None


def test_em_fills_read_the_counters(counters):
    em = {"window_s": 30.0, "iterations": 49}
    counters.add("em.cells_lane", 1000)
    counters.add("em.cells_band", 265)
    counters.add("em.diagonals", 76)
    assert reader("em.lane_fill")(em) == pytest.approx(26.5)
    assert reader("em.sm_fill")(em) is None          # no slots: a step on the CPU
    counters.add("em.sm_slots", 1000)
    assert reader("em.sm_fill")(em) == pytest.approx(7.6)


def test_em_setup_spans_read_the_counters(counters):
    em = {"window_s": 30.0, "iterations": 49}
    assert reader("em.setup_prep_s")(em) is None
    assert reader("em.setup_build_s")(em) is None
    counters.observe("time.prepare_read", 4.0)
    counters.observe("time.prepare_read", 5.5)
    counters.observe("time.em.build_buckets", 1.25)
    assert reader("em.setup_prep_s")(em) == pytest.approx(9.5)
    assert reader("em.setup_build_s")(em) == pytest.approx(1.25)


@pytest.mark.parametrize("name", EM)
def test_em_readers_need_the_em_window(name, counters):
    """A run that is no EM window (no iterations) reads nothing, whatever the
    process's counters hold."""
    for k in ("em.cells_lane", "em.cells_band", "em.diagonals", "em.sm_slots"):
        counters.add(k, 10)
    counters.observe("time.prepare_read", 1.0)
    counters.observe("time.em.build_buckets", 1.0)
    assert reader(name)({}) is None
    assert reader(name)({"window_s": 30.0, "timing": {}}) is None
    assert reader(name)({"window_s": 30.0, "iterations": 3}) is not None


@pytest.mark.parametrize("name", EM)
def test_em_readers_on_a_program_without_the_counters(name, counters):
    assert reader(name)({"window_s": 30.0, "iterations": 49}) is None
