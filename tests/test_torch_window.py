"""PyTorch port: the generic window problems (vanilla, fourState, echelon)
and the kernels' plain versions at their plans, against the JAX package on
the CPU.

  * make_window_problem against make_window_pallas_problem: E rows < D and
    the diagonal scalars exactly (the port pads E to Dp + 2 rows, the JAX
    problem to Dp + KD);
  * run_window (plain versions) against run_window_pallas (interpret mode,
    kd = 2), echelon with its per-state posteriors (pstates);
  * fourState against the f64 window engine, as test_pallas_generic does
    for vanilla and echelon;
  * the kernels' limits: 64 edges, 32-bit stage-4 group masks, the pstates
    list; and chip_smoke's per-plan operation count.

Tolerances as tests/test_torch_kernels.py: p atol 1e-4, totals atol 1e-3 +
rtol 1e-5 (XLA fuses multiply-adds in interpret mode; the plain versions
round each operation), compared over the diagonals d < D of each problem.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_signal_tpu.engine import pallas_pipeline as jpp
from cpecan_signal_tpu.engine import window as jwindow
from cpecan_signal_tpu.models import state_machines as jsm
from cpecan_signal_tpu_torch.engine import pipeline as tpp
from cpecan_signal_tpu_torch.engine import plan as tplan
from cpecan_signal_tpu_torch.engine import window as twindow
from cpecan_signal_tpu_torch.ops import fb_kernels as fk
from test_pallas_generic import _synthetic

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
KD = 2
F_ATOL, F_RTOL = 1e-3, 1e-5
P_ATOL = 1e-4

# name -> (bases, seed, machine factory); echelon at 36 bases, as
# test_pallas_generic (its interpret-mode kernels are the suite's slowest)
MACHINES = {
    "vanilla-template": (64, 1, lambda p, t, e: jsm.make_signal_vanilla(p, t, e, "template")),
    "vanilla-complement": (64, 2, lambda p, t, e: jsm.make_signal_vanilla(p, t, e,
                                                                          "complement")),
    "fourState": (64, 4, jsm.make_signal_sm4),
    "echelon": (36, 3, jsm.make_signal_echelon),
}
ECHELON_PSTATES = (1, 2, 3, 4, 5)


def _machine(name):
    n_bases, seed, make = MACHINES[name]
    pore, target, events, wband = _synthetic(n_bases=n_bases, seed=seed)
    return make(pore, target, events), wband


@pytest.mark.parametrize("name", list(MACHINES))
def test_make_window_problem_matches_jax(name):
    """Host packing: the window grids and shift scalars, the f64 emission
    and transition grids, and every field of the packed problem equal the
    JAX package's."""
    sm, wb = _machine(name)
    D = wb.n_diagonals
    for a, b in zip(twindow.window_grids(wb), jwindow.window_grids(wb)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(twindow.shift_scalars(wb.w0), jwindow.shift_scalars(wb.w0)):
        np.testing.assert_array_equal(a, b)
    plan, winp = twindow.prepare_window_inputs(sm, wb, ragged_left=True, ragged_right=False)
    jplan, jwinp = jwindow.prepare_window_inputs(sm, wb, ragged_left=True,
                                                 ragged_right=False, dtype=jnp.float64)
    assert plan == tplan.plan_from(jplan)
    for field in twindow.WindowInputs._fields:
        np.testing.assert_array_equal(getattr(winp, field),
                                      np.asarray(getattr(jwinp, field)), err_msg=field)

    jplan, jprob = jpp.make_window_pallas_problem(sm, wb, ragged_left=False)
    Dp = jprob.diag_scalars.shape[0] - 1
    plan, prob = tpp.make_window_problem(sm, wb, device=CPU, ragged_left=False, pad_d=Dp)
    assert plan == tplan.plan_from(jplan)
    assert prob.E.shape == (Dp + 2,) + np.asarray(jprob.E).shape[1:]
    np.testing.assert_array_equal(prob.E[:D].numpy(), np.asarray(jprob.E)[:D])
    assert (prob.E[D:] == 0).all()
    for field in tpp.WindowProblem._fields[1:]:
        np.testing.assert_array_equal(getattr(prob, field).numpy(),
                                      np.asarray(getattr(jprob, field)), err_msg=field)
    assert prob.E.dtype == prob.start.dtype == torch.float32
    assert prob.diag_scalars.dtype == prob.x0.dtype == torch.int32


@pytest.fixture(scope="module", params=["vanilla-template", "fourState", "echelon"])
def window_case(request):
    """Two problems of one machine (ragged ends swapped) through the JAX
    interpret-mode pipeline, and the batch carried over to the port."""
    name = request.param
    sm, wb = _machine(name)
    probs = [jpp.make_window_pallas_problem(sm, wb, ragged_left=rl, ragged_right=not rl)
             for rl in (True, False)]
    jplan = probs[0][0]
    batch = jpp.stack_problems([p for _plan, p in probs])
    pstates = ECHELON_PSTATES if name == "echelon" else None
    p, tot = jpp.run_window_pallas(jplan, wb.W, batch, interpret=True, kd=KD,
                                   pstates=pstates)
    plan, tb = tpp.window_problem_from_numpy(jplan, batch, CPU)
    return {"name": name, "sm": sm, "wb": wb, "plan": plan, "batch": tb,
            "pstates": pstates, "p": np.asarray(p), "tot": np.asarray(tot)}


def test_run_window_matches_pallas(window_case):
    c = window_case
    D, W = c["wb"].n_diagonals, c["wb"].W
    before = dict(fk.LAUNCHES)
    p, tot = tpp.run_window(c["plan"], W, c["batch"], pstates=c["pstates"])
    assert fk.LAUNCHES == before             # plain versions on the CPU
    assert p.shape[:2] == tot.shape == (2, c["batch"].diag_scalars.shape[1] - 1)
    if c["pstates"] is not None:
        assert p.shape[2] == len(c["pstates"])
    np.testing.assert_allclose(p.numpy()[:, :D], c["p"][:, :D], atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(tot.numpy()[:, :D], c["tot"][:, :D], atol=F_ATOL, rtol=F_RTOL)
    # about one aligned event per two diagonals carries the posterior mass
    assert float(p.sum()) > 0.25 * D
    # stage 4 (the EM tallies, one window group of edge 0) runs the same
    # recursion: the same totals, and the same match posteriors
    p4, tot4, _exits, _gacc, _stats = tpp.run_window(c["plan"], W, c["batch"], stages=4,
                                                     wgroups=((0,),))
    assert torch.equal(tot4, tot)
    if c["pstates"] is None:
        assert torch.equal(p4, p)
    with pytest.raises(ValueError, match="stage 3 or 4"):
        tpp.run_window(c["plan"], W, c["batch"], stages=2)


def test_echelon_pstates_channels():
    """The echelon mode's channels are the per-state posteriors of the
    listed states; the default output is the match state's alone, equal to
    the pstates channel of the match state, with the same totals."""
    sm, wb = _machine("echelon")
    plan, prob = tpp.make_window_problem(sm, wb, device=CPU, ragged_right=False)
    b = tpp.stack_window_problems([prob])
    edges = torch.from_numpy(tplan.edge_table(plan))
    F = fk.forward_sm3(edges, b.E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    args = (edges, plan.match_state, b.E, F, b.diag_scalars, b.d_last, b.end, b.tp_scalar)
    p_all, tot_all = fk.backward_sm3(*args, pstates=ECHELON_PSTATES)
    p_m, tot_m = fk.backward_sm3(*args)
    assert p_all.shape == (1, wb.n_diagonals, 5, wb.W)
    torch.testing.assert_close(tot_all, tot_m, rtol=0, atol=0)
    m = ECHELON_PSTATES.index(plan.match_state)
    torch.testing.assert_close(p_all[:, :, m], p_m, rtol=0, atol=0)
    p_sub, _ = fk.backward_sm3(*args, pstates=(2, 4))
    torch.testing.assert_close(p_sub, p_all[:, :, [1, 3]], rtol=0, atol=0)
    assert float(p_all[:, :, 1:].sum()) > 0       # multi-k-mer states carry mass


def test_fourstate_matches_window_engine():
    """fourState on the port's plain pipeline against the f64 window engine
    (test_pallas_generic._check_machine's check; the JAX suite has no
    fourState differential test)."""
    sm, wb = _machine("fourState")
    D, W = wb.n_diagonals, wb.W
    plan, prob = tpp.make_window_problem(sm, wb, device=CPU)
    p_k, tot_k = (t.numpy() for t in tpp.run_window(plan, W, tpp.stack_window_problems(
        [prob, prob])))
    plan_w, winp = jwindow.prepare_window_inputs(sm, wb, ragged_left=True,
                                                 ragged_right=True, dtype=jnp.float64)
    F = jwindow.forward(plan_w, winp)
    B = jwindow.backward(plan_w, winp)
    p_h, tot_h = (np.asarray(a) for a in jwindow.posterior_match_probs(plan_w, winp, F, B))
    assert (p_k[0][:D] >= 0.01).sum() == (p_h >= 0.01).sum() > D // 4
    mask = (p_h >= 0.01) | (p_k[0][:D] >= 0.01)
    assert np.abs(p_k[0][:D] - p_h)[mask].max() < 2e-3
    fin = np.isfinite(tot_h)
    assert np.abs(tot_k[0][:D] - tot_h)[fin].max() < 0.1
    np.testing.assert_array_equal(p_k[0], p_k[1])


def _cu_define(name):
    with open(os.path.join(REPO, "cpecan_signal_tpu_torch", "csrc", "fb_sm3.cu")) as fh:
        return int(re.search(rf"#define {name} (\d+)", fh.read()).group(1))


def test_edge_limits():
    """MAX_EDGES (64 in the kernels and their wrappers) keeps every edge's
    stage-4 stats lane below the likelihood lane and takes echelon's 46
    edges; the stage-4 group masks are 32-bit, so a group edge >= 32
    raises instead of being mis-encoded."""
    assert fk.MAX_EDGES == _cu_define("MAX_EDGES") == 64
    assert fk.LIK_LANE == _cu_define("LIK_LANE") and fk.MAX_EDGES <= fk.LIK_LANE
    assert fk.MAX_STATES == _cu_define("MAX_S")
    sm, _wb = _machine("echelon")
    tab = tplan.edge_table(tplan._build_plan(sm, "exact")[0])
    assert tab.shape[0] == 46
    fk._check_edges(torch.from_numpy(tab), 7)
    fk._check_edges(torch.from_numpy(np.resize(tab, (64, tab.shape[1]))), 7)
    with pytest.raises(ValueError, match="exceed the kernel limits"):
        fk._check_edges(torch.from_numpy(np.resize(tab, (65, tab.shape[1]))), 7)
    with pytest.raises(ValueError, match="exceed the kernel limits"):
        fk._check_edges(torch.from_numpy(tab), 9)
    assert fk.group_masks(((0, 31), (5,)), 46) == [-(1 << 31) + 1, 1 << 5, 0, 0]
    with pytest.raises(ValueError, match="32-bit"):
        fk.group_masks(((3, 32),), 46)
    with pytest.raises(ValueError, match="outside"):
        fk.group_masks(((8,),), 8)


def test_pstates_checks():
    assert fk.pstate_mask((1, 2, 3, 4, 5), 7, 3) == 0b111110
    for bad in ((2, 1), (1, 1), (0, 7), ()):
        with pytest.raises(ValueError, match="strictly increasing"):
            fk.pstate_mask(bad, 7, 3)
    with pytest.raises(ValueError, match="stage 3"):
        fk.pstate_mask((1, 2), 7, 4)


def test_bound_counts_per_plan():
    """chip_smoke's operation count per cell comes from the launch's edge
    table: threeState's is the count it used before (128 / 220 / 290), and
    echelon's 46 edges and 5 posterior channels cost more per cell."""
    pore, target, events, _wb = _synthetic(n_bases=20, seed=0)
    plan = tplan._build_plan(jsm.make_signal_sm3(pore, target, events), "exact")[0]
    tab = tplan.edge_table(plan)
    assert chip_smoke.ops_per_cell("forward", tab) == 128
    assert chip_smoke.ops_per_cell("backward", tab, plan.n_states) == 220
    assert chip_smoke.ops_per_cell("backward_em", tab, plan.n_states,
                                   wgroups=tpp.sm3_wgroups(plan)) == 290
    sm, _wb = _machine("echelon")
    etab = tplan.edge_table(tplan._build_plan(sm, "exact")[0])
    fwd = chip_smoke.ops_per_cell("forward", etab)
    bwd = chip_smoke.ops_per_cell("backward_pstates", etab, 7, n_post=5)
    assert 46 * 16 <= fwd and bwd > fwd + 35 * 16
