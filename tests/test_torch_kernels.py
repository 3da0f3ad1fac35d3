"""PyTorch port: the three kernels' plain versions against the JAX Pallas
kernels (interpret mode, kd=2, as tests/test_pallas_kernels.py runs them).
The CUDA kernels are held against the plain versions in test_torch_cuda.py.

Problems are built by the JAX package from numpy-seeded synthetic reads
(``__graft_entry__._tiny_pallas_batch``'s shape: B = 3, 40-60 bases) and
carried over with ``problem_from_numpy``.  JAX's outputs lose their TPU
padding first: E rows past Dp+2, Fpad's kd-row halo, the singleton axes.

Tolerances.  XLA's CPU compiler fuses multiply-adds inside the interpreted
kernels (see test_torch_plan_align.test_ladd_matches_jax), so E differs by
an ulp or two (rtol 1e-6); F and the totals accumulate such differences
over the diagonal chain (atol 1e-3 + rtol 1e-5, F reaching |1e3|); the
posteriors are exp of differences of those (atol 1e-4).
"""

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.constants import MODEL_PARAMS, NUM_OF_KMERS
from cpecan_signal_tpu.core.band import band_construct
from cpecan_signal_tpu.core.kmers import sequence_kmer_ranks
from cpecan_signal_tpu.core.window import smooth_band
from cpecan_signal_tpu.engine import pallas_pipeline as jpp
from cpecan_signal_tpu.models.pore_model import PoreModel
from cpecan_signal_tpu.ops import pallas_fb as pk
from cpecan_signal_tpu_torch.engine import pipeline as tpp
from cpecan_signal_tpu_torch.engine.plan import edge_table
from cpecan_signal_tpu_torch.ops import fb_kernels as fk

KD = 2
E_RTOL = 1e-6
F_ATOL, F_RTOL = 1e-3, 1e-5
P_ATOL = 1e-4


def _pore(rng):
    match = np.zeros((NUM_OF_KMERS + 2, MODEL_PARAMS))
    match[:NUM_OF_KMERS, 0] = rng.uniform(40, 90, NUM_OF_KMERS)
    match[:NUM_OF_KMERS, 1] = 1.0
    match[:NUM_OF_KMERS, 2] = rng.uniform(1, 3, NUM_OF_KMERS)
    match[:NUM_OF_KMERS, 3] = 0.3
    match[:NUM_OF_KMERS, 4] = 5.0
    return PoreModel(0.9, match, 0.9, match.copy(), np.full(60, 1 / 30))


def _jax_batch(W, seed, B=3, n_bases=50):
    """B equally padded JAX problems with ragged/unragged ends mixed."""
    rng = np.random.default_rng(seed)
    pore = _pore(rng)
    probs, plan = [], None
    for b in range(B):
        target = "".join(rng.choice(list("ACGT"), n_bases + int(rng.integers(-10, 10))))
        ranks = sequence_kmer_ranks(target)
        n_ev = len(ranks) - int(rng.integers(0, 5))
        means = pore.match_model[ranks[:n_ev], 0] + rng.normal(0, 0.5, n_ev)
        events = np.stack([means, np.full(n_ev, 2.0), np.full(n_ev, 0.01)], axis=1)
        wband = smooth_band(band_construct([], len(ranks), n_ev, 2), width_multiple=W)
        assert wband.W == W
        plan, prob = jpp.make_sm3_pallas_problem(
            pore, target, events, wband, ragged_left=bool(b % 2),
            ragged_right=bool(b // 2 % 2), pad_lx=n_bases + 10, pad_ly=n_bases + 10,
            pad_d=2 * (n_bases + 10))
        probs.append(prob)
    return pore, plan, jpp.stack_problems(probs)


@pytest.fixture(scope="module", params=[(64, 5), (128, 6)], ids=["W64", "W128"])
def case(request):
    """JAX interpret-mode outputs of the three kernels, and the carried-over
    port problem."""
    W, seed = request.param
    _pore_, plan, b = _jax_batch(W, seed)
    Dp = b.diag_scalars.shape[1] - 1
    E = pk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp, interpret=True, kd=KD)
    Fpad = pk.forward_sm3(plan, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar,
                          kd=KD, interpret=True)
    p, tot, *_ = pk.backward_sm3(plan, E, Fpad, b.diag_scalars, b.d_last, b.end,
                                 b.tp_scalar, kd=KD, stages=3, interpret=True)
    tplan, tb = tpp.problem_from_numpy(plan, b, torch.device("cpu"))
    return {
        "W": W, "Dp": Dp, "plan": tplan, "prob": tb, "jplan": plan, "jprob": b,
        "E": np.array(E[:, :Dp + 2]), "F": np.array(Fpad[:, KD:]),
        "p": np.array(p[:, :, 0]), "tot": np.array(tot[:, :, 0, 0]),
    }


def _edges(c, device="cpu"):
    return torch.from_numpy(edge_table(c["plan"])).to(device)


def test_emissions_plain_matches_pallas(case):
    tb = case["prob"]
    E = fk.emissions_sm3(tb.x0, tb.yr0, tb.xarr, tb.evr, case["W"], case["Dp"]).numpy()
    assert E.shape == case["E"].shape
    np.testing.assert_allclose(E, case["E"], rtol=E_RTOL, atol=0)
    assert (E[:, case["Dp"]:] == 0).all()


def test_forward_plain_matches_pallas(case):
    tb = case["prob"]
    E = torch.from_numpy(case["E"])
    F, offF = fk.forward_sm3(_edges(case), E, tb.diag_scalars, tb.d_last, tb.start,
                             tb.tp_scalar)
    # F is stored relative to its per-diagonal offsets: JAX's is absolute
    F_abs = F.double() + offF[:, :, None, None]
    np.testing.assert_allclose(F_abs.numpy(), case["F"], atol=F_ATOL, rtol=F_RTOL)
    # cells outside the band are NEG_INF exactly, as in the TPU kernel
    np.testing.assert_array_equal(F.numpy() <= fk.NEG_INF, case["F"] <= fk.NEG_INF)


def test_backward_plain_matches_pallas(case):
    tb = case["prob"]
    E, F = torch.from_numpy(case["E"]), torch.from_numpy(case["F"])
    offF = torch.zeros(F.shape[:2], dtype=torch.float64)   # JAX's F is absolute
    p, tot = fk.backward_sm3(_edges(case), case["plan"].match_state, E, F, offF,
                             tb.diag_scalars, tb.d_last, tb.end, tb.tp_scalar)
    np.testing.assert_allclose(p.numpy(), case["p"], atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(tot.numpy(), case["tot"], atol=F_ATOL, rtol=F_RTOL)


def test_run_sm3_matches_pallas_pipeline(case):
    """emissions -> forward -> backward from the carried-over problem."""
    p, tot = tpp.run_sm3(case["plan"], case["W"], case["prob"])
    np.testing.assert_allclose(p.numpy(), case["p"], atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(tot.numpy(), case["tot"], atol=F_ATOL, rtol=F_RTOL)
    # about one aligned pair per two diagonals carries the posterior mass
    assert p.sum() > 0.25 * case["prob"].d_last.sum()
    # stage 4 (EM) adds the tallies and leaves p and the totals as they are
    # (the tallies themselves: tests/test_torch_em.py)
    p4, tot4, exits, gacc, stats = tpp.run_sm3(case["plan"], case["W"], case["prob"],
                                               stages=4)
    torch.testing.assert_close(p4, p, rtol=0, atol=0)
    torch.testing.assert_close(tot4, tot, rtol=0, atol=0)
    B, Dp = tot.shape
    assert exits.shape == (B, Dp) and gacc.shape == (B, case["W"])
    assert stats.shape == (B, fk.STATS_LANES)
    with pytest.raises(ValueError, match="stage 3 or 4"):
        tpp.run_sm3(case["plan"], case["W"], case["prob"], stages=2)


def test_make_sm3_problem_matches_jax():
    """The port's host packing equals make_sm3_pallas_problem's at the same
    padding (the kernels need no kd rounding; Dp is given explicitly)."""
    rng = np.random.default_rng(9)
    pore = _pore(rng)
    target = "".join(rng.choice(list("ACGT"), 70))
    ranks = sequence_kmer_ranks(target)
    events = np.stack([pore.match_model[ranks, 0] + rng.normal(0, 0.5, len(ranks)),
                       np.full(len(ranks), 1.8), np.full(len(ranks), 0.01)], axis=1)
    wb = smooth_band(band_construct([], len(ranks), len(ranks), 4), width_multiple=64)
    gaps = rng.uniform(-4, -1, NUM_OF_KMERS)
    jplan, jprob = jpp.make_sm3_pallas_problem(pore, target, events, wb,
                                               kmer_gap_probs=gaps, ragged_left=False,
                                               pad_lx=90, pad_ly=95, pad_d=150)
    Dp = jprob.diag_scalars.shape[0] - 1
    plan, prob = tpp.make_sm3_problem(pore, target, events, wb, device=torch.device("cpu"),
                                      kmer_gap_probs=gaps, ragged_left=False,
                                      pad_lx=90, pad_ly=95, pad_d=Dp)
    assert edge_table(plan).tolist() == edge_table(tpp.plan_from(jplan)).tolist()
    for name in tpp.SM3Problem._fields:
        np.testing.assert_array_equal(getattr(prob, name).numpy(),
                                      np.asarray(getattr(jprob, name)), err_msg=name)
