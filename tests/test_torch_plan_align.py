"""PyTorch port: plans, split jobs, window grids, ladd and device selection
against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages unchanged.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cpecan_signal_tpu.core.window import smooth_band
from cpecan_signal_tpu.engine import align as jalign
from cpecan_signal_tpu.engine import fb as jfb
from cpecan_signal_tpu.engine import window as jwindow
from cpecan_signal_tpu.models import state_machines as smm
from cpecan_signal_tpu.models.params import AlignmentParams
from cpecan_signal_tpu.ops import pallas_fb as pk
from cpecan_signal_tpu_torch.engine import align as talign
from cpecan_signal_tpu_torch.engine import plan as tplan
from cpecan_signal_tpu_torch.ops import fb_kernels as fk
from cpecan_signal_tpu_torch.utils.device import resolve_device
from test_readpath_random import _rand_pore, _rand_signal_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _machines():
    rng = np.random.default_rng(3)
    pore = _rand_pore(rng)
    target, events, _anchors = _rand_signal_case(rng, pore, 40)
    sm5 = smm.make_symbol_sm5()
    smm.bind_symbol_sequences(sm5, "ACGTACGTTG", "ACGTTCGTTG")
    return {
        "threeState": smm.make_signal_sm3(pore, target, events),
        "fourState": smm.make_signal_sm4(pore, target, events),
        "vanilla": smm.make_signal_vanilla(pore, target, events, "template"),
        "echelon": smm.make_signal_echelon(pore, target, events, "complement"),
        "threeStateHdp": smm.make_signal_sm3_hdp(
            lambda r, m: np.zeros(np.broadcast(r, m).shape), target, events),
        "fiveState": sm5,
    }


@pytest.mark.parametrize("name", ["threeState", "fourState", "vanilla", "echelon",
                                  "threeStateHdp", "fiveState"])
def test_build_plan_matches_jax(name):
    """The port's plan is the JAX plan field for field (exact), and its
    edge table lists each edge's terms in plan order."""
    sm = _machines()[name]
    jplan, jtp, jcells = jfb._build_plan(sm, "exact")
    plan, tp, cells = tplan._build_plan(sm, "exact")
    assert plan == tplan.plan_from(jplan)
    assert (plan.name, plan.n_states, plan.match_state, plan.n_eclasses) == \
        (jplan.name, jplan.n_states, jplan.match_state, jplan.n_eclasses)
    np.testing.assert_array_equal(tp, jtp)
    assert [k for k, _ in cells] == [k for k, _ in jcells]
    for (_k, a), (_kj, b) in zip(cells, jcells):
        np.testing.assert_array_equal(a, b)
    tab = tplan.edge_table(plan)
    assert tab.shape == (len(plan.edges), tplan.EDGE_COLS)
    for row, e in zip(tab, plan.edges):
        assert tuple(row[:4]) == (e.src, e.frm, e.to, e.eclass)
        ids = tplan.MAX_EDGE_IDS
        assert tuple(i for i in row[4:4 + ids] if i >= 0) == e.scalar_ids
        assert tuple(c - plan.n_eclasses for c in row[4 + ids:] if c >= 0) == e.cell_ids


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_collect_split_jobs_and_window_grids(seed):
    """Split jobs (offsets, ragged flags, bands, machines) and the window
    grids of their smoothed bands equal the JAX package's, exactly."""
    rng = np.random.default_rng(seed)
    pore = _rand_pore(rng)
    target, events, anchors = _rand_signal_case(rng, pore, int(rng.integers(120, 220)))
    # a small split area forces several splits at the anchor gaps
    params = AlignmentParams(diagonal_expansion=6, split_matrix_bigger_than_this=40 * 40)
    rl, rr = bool(seed % 2), bool(seed % 3)

    def mk(t, e):
        return smm.make_signal_sm3(pore, t, e)

    got = talign.collect_split_jobs(mk, target, events, anchors, params,
                                    ragged_left=rl, ragged_right=rr)
    want = jalign.collect_split_jobs(mk, target, events, anchors, params,
                                     ragged_left=rl, ragged_right=rr)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g.off_x, g.off_y, g.ragged_left, g.ragged_right) == \
            (w.off_x, w.off_y, w.ragged_left, w.ragged_right)
        for field in ("xmyL", "xmyR"):
            np.testing.assert_array_equal(getattr(g.band, field), getattr(w.band, field))
        np.testing.assert_array_equal(g.sm.kmer_ranks, w.sm.kmer_ranks)
        np.testing.assert_array_equal(g.sm.sm3_pack[2], w.sm.sm3_pack[2])
        for width in (64, 128):
            wb = smooth_band(g.band, width_multiple=width)
            for a, b in zip(talign.window_grids(wb), jwindow.window_grids(wb)):
                np.testing.assert_array_equal(a, b)


def _ladd_grid():
    """(x, y) pairs whose gap d = hi - lo spans the four cubic pieces, their
    boundaries, the 7.5 cut-off, and NEG_INF operands."""
    hi = np.array([-60.0, -12.25, -3.5, -0.75, 0.0, 0.3, 4.0, 25.0], np.float32)
    d = np.concatenate([np.linspace(0.0, 9.0, 181), [1.0, 2.5, 4.5, 7.5],
                        np.nextafter(np.float32([1.0, 2.5, 4.5, 7.5]), np.float32(0))])
    x = np.repeat(hi, len(d)).astype(np.float32)
    y = (x - np.tile(d, len(hi))).astype(np.float32)
    neg = np.float32(fk.NEG_INF)
    extra_x = np.array([neg, neg, neg, -5.0, 2 * neg], np.float32)
    extra_y = np.array([neg, -3.0, 2 * neg, neg, neg], np.float32)
    # swapped order too: ladd is symmetric in its arguments
    x = np.concatenate([x, extra_x, y])
    y = np.concatenate([y, extra_y, x[:len(y)]])
    return x, y


def test_ladd_matches_jax():
    """Bit for bit against JAX's op-by-op _ladd (the same f32 multiplies and
    adds, each rounded).  XLA's CPU compiler fuses the Horner steps of a
    jitted _ladd (as in Pallas interpret mode) into fused multiply-adds,
    which round once instead of twice; against that the gap is at most 2
    ulp of the lookup value (|lookup| <= 8) or of hi, whichever is larger."""
    x, y = _ladd_grid()
    got = fk.ladd(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    eager = np.asarray(pk._ladd(jax.numpy.asarray(x), jax.numpy.asarray(y)))
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jax.jit(pk._ladd)(x, y))
    scale = np.maximum(np.abs(np.maximum(x, y)), 8.0).astype(np.float32)
    assert (np.abs(got - jitted) <= 2 * np.spacing(scale)).all()
    assert (got >= fk.NEG_INF).all() and got.min() == np.float32(fk.NEG_INF)


def test_resolve_device(monkeypatch):
    """cuda by default, cpu only when asked for ($SIGALIGN_PLATFORM or the
    argument); cuda without a usable card raises instead of falling back;
    unknown platforms raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SIGALIGN_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    assert resolve_device() == torch.device("cpu")
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cuda")
    with pytest.raises(RuntimeError, match="no usable CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError, match="unsupported platform"):
        resolve_device("tpu")


def test_port_imports_no_jax():
    """Importing every module of the port (in a fresh interpreter: this test
    process has jax loaded by conftest.py) never loads jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cpecan_signal_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert len(names) >= 14, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
