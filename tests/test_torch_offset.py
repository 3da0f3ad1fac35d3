"""The recursions' per-diagonal offsets, on the port's plain path (CPU).

The kernels keep F and b relative to an offset per (problem, diagonal),
held apart in f64 (csrc/fb_sm3.cu, Kernel 2; ops/fb_kernels.forward_sm3_ref
and backward_sm3_ref take the same steps).  A start (or end) vector shifted
by -2^16 then changes nothing but the offsets: with its values on a 2^-7
grid the shift is exact in f32, so the posteriors, the stage-4 tallies and
the pairs equal the unshifted run's to 1e-6, and each diagonal's total moves
by exactly 2^16, to the f32 spacing of the total.  Stored as absolute log
values, F near -65536 would be rounded to 2^-7 on every cell, about 0.4 % of
a posterior.

One threeState problem pair (W = 64, Dp = 512) and one fiveState problem
(the nucleotide machine, W = 64), each through stage 4, whose posteriors
and totals are stage 3's (test_torch_kernels.py holds them equal).
"""

import numpy as np
import pytest
import torch

from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.core.band import band_construct
from cpecan_signal_tpu_torch.core.window import smooth_band
from cpecan_signal_tpu_torch.em.discrete import collect_symbol_split_jobs
from cpecan_signal_tpu_torch.engine import pipeline as tpp
from cpecan_signal_tpu_torch.models.params import AlignmentParams
from cpecan_signal_tpu_torch.models.state_machines import (bind_symbol_sequences,
                                                            make_symbol_sm5)
from cpecan_signal_tpu_torch.ops import fb_kernels as fk

CPU = torch.device("cpu")
SHIFT = 2.0 ** 16
GRID = 2.0 ** -7
W, DP = 64, 512
EQ_ATOL = 1e-6
PAIR_P = 0.01          # a cell is a pair at this posterior (the CLIs' threshold)


def _sm3_case(tmp_path_factory):
    """Two threeState problems (ragged and unragged left end) whose band
    fits W lanes and Dp diagonals."""
    rng = np.random.default_rng(41)
    pore = syn.write_pore_model(str(tmp_path_factory.mktemp("m") / "m.model"), rng)
    probs, plan = [], None
    while len(probs) < 2:
        target = "".join(rng.choice(list("ACGT"), int(0.4 * DP)))
        events, path = syn.simulate_events(pore, target, rng)
        n_kmers = len(target) - 5
        band = band_construct(syn.path_anchors(path, n_kmers, len(events), 20),
                              n_kmers, len(events), 20)
        wb = smooth_band(band, width_multiple=W)
        if wb.W != W or wb.n_diagonals > DP or len(events) > DP // 2:
            continue
        plan, prob = tpp.make_sm3_problem(pore, target, events, wb, device=CPU,
                                          ragged_left=bool(len(probs) % 2),
                                          pad_lx=DP // 2, pad_ly=DP // 2, pad_d=DP)
        probs.append(prob)
    batch = tpp.stack_problems(probs)
    return lambda b, stages: tpp.run_sm3(plan, W, b, stages=stages), batch


def _five_case():
    """One fiveState problem of a 200-base pair and its descendant."""
    rng = np.random.default_rng(43)
    sx = "".join(rng.choice(list("ACGT"), 200))
    sy, truth = syn.evolve_with_truth(sx, rng, 0.05, 0.01, 0.01)

    def make_sm(x, y):
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, x, y)
        return sm

    job, = collect_symbol_split_jobs(make_sm, sx, sy, truth[::10], AlignmentParams(),
                                     ragged_left=True, ragged_right=False)
    wb = smooth_band(job.band, width_multiple=W)
    plan, prob = tpp.make_window_problem(job.sm, wb, device=CPU, ragged_left=True,
                                         ragged_right=False)
    batch = tpp.stack_window_problems([prob])
    return lambda b, stages: tpp.run_window(plan, wb.W, b, stages=stages), batch


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{machine: (run, batch with start and end on the grid, its stage-4
    outputs)}."""
    out = {}
    for name, (run, batch) in (("threeState", _sm3_case(tmp_path_factory)),
                               ("fiveState", _five_case())):
        base = batch._replace(start=_on_grid(batch.start), end=_on_grid(batch.end))
        out[name] = (run, base, run(base, 4))
    return out


def _on_grid(v: torch.Tensor) -> torch.Tensor:
    """v's finite entries rounded to the 2^-7 grid, where a shift by -2^16
    is exact in f32 (|v| < 2^16); log 0 entries stay."""
    finite = v > fk.NEG_INF / 2
    return torch.where(finite, torch.round(v * (1 / GRID)) * GRID, v)


@pytest.mark.parametrize("vector", ["start", "end"])
@pytest.mark.parametrize("machine", ["threeState", "fiveState"])
def test_shifted_boundary_vector_moves_only_the_totals(cases, machine, vector):
    run, base, want = cases[machine]
    moved = base._replace(**{vector: getattr(base, vector) - SHIFT})
    assert bool((getattr(moved, vector) < -SHIFT / 2).any())
    got = run(moved, 4)
    p_want, p_got = want[0].numpy(), got[0].numpy()
    np.testing.assert_allclose(p_got, p_want, rtol=0, atol=EQ_ATOL)
    np.testing.assert_array_equal(p_got > PAIR_P, p_want > PAIR_P)
    t_want, t_got = want[1].numpy(), got[1].numpy()
    real = t_want > fk.NEG_INF / 2
    assert real.sum() > 100
    np.testing.assert_array_equal(real, t_got > fk.NEG_INF / 2)
    err = np.abs(t_got[real] - (t_want[real] - np.float32(SHIFT)))
    assert (err <= np.spacing(np.abs(t_got[real]))).all(), err.max()
    # exits, gacc and the per-edge tallies (stats lanes below the
    # likelihood lane), all sums of posteriors
    for w, g in zip(want[2:], got[2:]):
        w, g = w.numpy(), g.numpy()
        if w.shape[-1] == fk.STATS_LANES:
            w, g = w[..., :fk.LIK_LANE], g[..., :fk.LIK_LANE]
        np.testing.assert_allclose(g, w, rtol=EQ_ATOL, atol=EQ_ATOL)
