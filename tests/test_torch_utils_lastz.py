"""The port's copies of utils/observability.py and anchor/lastz.py against
the JAX package's, the trace of its ``profile_trace``, and the device
E-step's bucket budget shared by the ranks on one card.

lastz itself is not in the repository (``parity/build/lastz`` is absent), so
both packages' ``lastz_anchor_pairs`` read the same CIGAR text from a stand-in
executable that prints it: the walk from CIGAR blocks to trimmed,
overlap-filtered anchor pairs is what is compared.
"""

import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.anchor import lastz as jlastz
from cpecan_signal_tpu.utils import observability as jobs
from cpecan_signal_tpu_torch.anchor import lastz as tlastz
from cpecan_signal_tpu_torch.em import sm3_em
from cpecan_signal_tpu_torch.io.cigar import CigarRecord
from cpecan_signal_tpu_torch.parallel import distributed
from cpecan_signal_tpu_torch.utils import observability as tobs


def _drive(mod):
    """The counters test of tests/test_aux.py on a fresh Counters of
    ``mod``, and ``timed`` into the module's own counters."""
    c = mod.Counters()
    c.add("reads")
    c.add("reads")
    c.add("pairs", 5.5)
    c.observe("band_width", 40)
    c.observe("band_width", 60)
    c.observe("band_width", 50)
    before = mod.counters.snapshot().get("time.noop.count", 0)
    with mod.timed("noop"):
        pass
    lines = []
    c.report(log=lines.append)
    return c.snapshot(), lines, mod.counters.snapshot()["time.noop.count"] - before


def test_counters_and_timed_match_jax():
    got, want = _drive(tobs), _drive(jobs)
    assert got == want
    assert got[0]["reads"] == 2 and got[0]["band_width.sum"] == 150
    assert got[0]["band_width.max"] == 60 and got[2] == 1


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """The trace holds the program's spans as ``cpecan:<name>`` regions."""
    log_dir = str(tmp_path / "trace")
    with tobs.profile_trace(log_dir):
        with tobs.timed("trace_test"):
            torch.ones(64).cumsum(0)
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as fh:
        events = json.load(fh)["traceEvents"]
    assert events
    assert any(e.get("name") == "cpecan:trace_test" for e in events)


def _fake_lastz(tmp_path, records) -> str:
    """An executable that prints ``records`` as lastz --format=cigar lines
    (query y as contig1, target x as contig2), whatever its arguments."""
    text = "".join(r.to_line() + "\n" for r in records)
    path = tmp_path / "lastz"
    path.write_text(f"#!{sys.executable}\nimport sys\nsys.stdout.write({text!r})\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def _records(rng, n: int):
    """n forward-strand CIGAR records of random M / D / I blocks (D advances
    the target x, I the query y), spans consistent with their ops."""
    out, x, y = [], 0, 0
    for _ in range(n):
        ops = [("M", int(rng.integers(20, 80)))]
        for _ in range(int(rng.integers(1, 5))):
            ops += [(str(rng.choice(["D", "I"])), int(rng.integers(1, 6))),
                    ("M", int(rng.integers(5, 80)))]
        dx = sum(n for op, n in ops if op in "MD")
        dy = sum(n for op, n in ops if op in "MI")
        out.append(CigarRecord("y", y, y + dy, True, "x", x, x + dx, True, 3000.0, ops))
        x += dx + int(rng.integers(-30, 60))   # records may overlap
        y += dy + int(rng.integers(-30, 60))
        x, y = max(x, 0), max(y, 0)
    return out


@pytest.mark.parametrize("trim", [0, 14])
def test_lastz_cigar_walk_matches_jax(tmp_path, trim):
    rng = np.random.default_rng(5 + trim)
    binary = _fake_lastz(tmp_path, _records(rng, 6))
    sx, sy = "ACGT" * 300, "ACGT" * 300
    got = tlastz.lastz_anchor_pairs(sx, sy, trim=trim, binary=binary)
    want = jlastz.lastz_anchor_pairs(sx, sy, trim=trim, binary=binary)
    assert len(got) > 100
    np.testing.assert_array_equal(got, want)
    assert tlastz.lastz_available(binary) and tlastz.LASTZ_ARGS == jlastz.LASTZ_ARGS
    assert tlastz.lastz_anchor_pairs("", sy, binary=binary).shape == (0, 2)


def test_em_budget_divided_among_ranks_sharing_the_card(monkeypatch):
    """The default budget is BUDGET_FREE_SHARE of the card's free memory
    over the ranks of this host on that card (rank r on card r modulo the
    cards): 1 alone, 2 for two ranks on one card, 1 for two ranks on two
    cards, 2 and 1 for three ranks on two."""
    free = 60e9
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 80e9))
    monkeypatch.delenv(sm3_em.BUDGET_ENV, raising=False)
    cuda = torch.device("cuda")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for ranks, rank, cards, share in ((1, 0, 1, 1), (2, 1, 1, 2), (2, 1, 2, 1),
                                      (3, 2, 2, 2), (3, 1, 2, 1)):
        monkeypatch.setattr(distributed, "process_count", lambda n=ranks: n)
        monkeypatch.setattr(distributed, "process_index", lambda r=rank: r)
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        assert distributed.ranks_sharing_device() == share
        budget = sm3_em._EmBudget(cuda)
        assert budget.budget == sm3_em.BUDGET_FREE_SHARE * free / share
    assert sm3_em._EmBudget(torch.device("cpu")).budget == float("inf")
