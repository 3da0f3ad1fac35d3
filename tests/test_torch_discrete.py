"""PyTorch port: the nucleotide (fiveState symbol) slice on the CPU against
the JAX package.

Inputs are tests/test_discrete_pallas.py's random sequence pairs (numpy
seed, 36-60 bases, anchors every tenth base).

  * (a) the stage-4 backward's plain version with edge groups (``pgroups``)
    against JAX backward_sm3(stages=4, pgroups=..., interpret mode, kd = 2)
    on the same E and F: fiveState's one group per to-state, and a group of
    single edges;
  * (b) the symbol lane's device-built E equal to make_window_problem's
    host E at every band cell;
  * (c) em/discrete.discrete_expectations_batched against JAX's (interpret
    mode) and the host f64 oracle, and the same per-job tallies bit for bit
    however the jobs are bucketed;
  * (d) the symbol lane's pairs against JAX batch_align_jobs (interpret),
    and the full-grid re-route of a job whose pairs overflow.

Tolerances.  The plain versions and the interpreted kernels do the same f32
operations but XLA contracts multiply-adds into FMAs and sums lanes in
another order (tests/test_torch_em.py): posterior channels atol 1e-4, stats
atol 1e-3 + rtol 1e-5 (PERF.md section 2).  Whole E-steps carry those
differences down the diagonal chain: trans and emiss rtol 1e-4 + atol
1e-5, likelihood 1e-5 relative.  Against the f64 oracle (exact logaddexp,
not the reference's cubic logAdd) test_discrete_pallas.py's own rtol 2e-3 +
atol 1e-4 and 1e-2 relative.  Pairs: at most 1 pair per job and 1.2e-3
posterior drift (tests/test_readpath_random.py).
"""

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.core.window import smooth_band as jsmooth
from cpecan_signal_tpu.em import discrete_pallas as jdp
from cpecan_signal_tpu.em.expectation_driver import discrete_expectations
from cpecan_signal_tpu.engine import pallas_pipeline as jpp
from cpecan_signal_tpu.engine.batch_align import batch_align_jobs as jbatch_align_jobs
from cpecan_signal_tpu.models.params import AlignmentParams as JParams
from cpecan_signal_tpu.ops import pallas_fb as pk
from cpecan_signal_tpu_torch.em import discrete as tdisc
from cpecan_signal_tpu_torch.engine import batch_align as tba
from cpecan_signal_tpu_torch.engine import pipeline as tpp
from cpecan_signal_tpu_torch.engine import readpath as trp
from cpecan_signal_tpu_torch.engine.plan import edge_table
from cpecan_signal_tpu_torch.engine.window import window_grids
from cpecan_signal_tpu_torch.models import state_machines as tsm
from cpecan_signal_tpu_torch.models.params import AlignmentParams
from cpecan_signal_tpu_torch.ops import fb_kernels as fk
from test_discrete_pallas import _random_pair, make_sm as jmake_sm

CPU = torch.device("cpu")
KD = 2
P_ATOL = 1e-4
T_ATOL, T_RTOL = 1e-3, 1e-5
STEP_RTOL, STEP_ATOL, LIK_RTOL = 1e-4, 1e-5, 1e-5
HOST_RTOL, HOST_ATOL, HOST_LIK = 2e-3, 1e-4, 1e-2
PAIR_TOL, PROB_TOL = 1, 1.2e-3


def tmake_sm(sx, sy):
    sm = tsm.make_symbol_sm5()
    tsm.bind_symbol_sequences(sm, sx, sy)
    return sm


def _pairs(seed, sizes):
    rng = np.random.default_rng(seed)
    return [_random_pair(rng, n) for n in sizes]


def _jobs(cases, ragged):
    """The cases' split jobs in both packages: (jax jobs, port jobs, owner
    of each job)."""
    jj, tj, owners = [], [], []
    for ci, (sx, sy, anchors) in enumerate(cases):
        a = jdp.collect_symbol_split_jobs(jmake_sm, sx, sy, anchors, JParams(),
                                          ragged_left=ragged, ragged_right=ragged)
        b = tdisc.collect_symbol_split_jobs(tmake_sm, sx, sy, anchors, AlignmentParams(),
                                            ragged_left=ragged, ragged_right=ragged)
        assert len(a) == len(b)
        jj += a
        tj += b
        owners += [ci] * len(a)
    return jj, tj, owners


@pytest.fixture(scope="module")
def window_case():
    """Two symbol jobs (ragged ends swapped) as one JAX window batch at W =
    128, run through the interpreted forward kernel."""
    (sx, sy, anchors), = _pairs(3, (57,))
    jobs = [jdp.collect_symbol_split_jobs(jmake_sm, sx, sy, anchors, JParams(),
                                          ragged_left=rl, ragged_right=not rl)[0]
            for rl in (True, False)]
    wb = jsmooth(jobs[0].band, width_multiple=128)
    probs = [jpp.make_window_pallas_problem(j.sm, wb, ragged_left=j.ragged_left,
                                            ragged_right=j.ragged_right) for j in jobs]
    jplan = probs[0][0]
    batch = jpp.stack_problems([p for _plan, p in probs])
    Fpad = pk.forward_sm3(jplan, batch.E, batch.diag_scalars, batch.d_last, batch.start,
                          batch.tp_scalar, kd=KD, interpret=True)
    plan, tb = tpp.window_problem_from_numpy(jplan, batch, CPU)
    Dp = tb.diag_scalars.shape[1] - 1
    F = torch.from_numpy(np.array(Fpad[:, KD:KD + Dp]))
    return {"jplan": jplan, "batch": batch, "Fpad": Fpad, "plan": plan, "tb": tb,
            "F": F, "W": wb.W, "D": wb.n_diagonals}


@pytest.mark.parametrize("groups", ["per_to_state", "single_edges"])
def test_backward_pgroups_plain_matches_pallas(groups, window_case):
    """(a) p channels and stats of the plain stage-4 backward with edge
    groups equal the interpreted Pallas kernel's on the same E and F; exits
    and gacc are the default shortGapX group's, as without edge groups."""
    c = window_case
    plan, tb, b = c["plan"], c["tb"], c["batch"]
    pgroups = (tdisc._to_state_pgroups(plan) if groups == "per_to_state"
               else ((0,), (3,), (4,), (6,), (8,), (9,), (11,), (12,)))
    p, tot, exits, gacc, stats = pk.backward_sm3(
        c["jplan"], b.E, c["Fpad"], b.diag_scalars, b.d_last, b.end, b.tp_scalar, kd=KD,
        stages=4, interpret=True, pgroups=pgroups)
    edges = torch.from_numpy(edge_table(plan))
    args = (edges, plan.match_state, tb.E, c["F"], tb.diag_scalars, tb.d_last, tb.end,
            tb.tp_scalar)
    got = fk.backward_sm3(*args, stages=4, wgroups=tpp.sm3_wgroups(plan), pgroups=pgroups)
    g_p, g_tot, g_exits, g_gacc, g_stats = (t.numpy() for t in got)
    assert g_p.shape == (2, tb.diag_scalars.shape[1] - 1, len(pgroups), c["W"])
    np.testing.assert_allclose(g_p, np.array(p)[:, :g_p.shape[1]], atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(g_tot, np.array(tot[:, :, 0, 0]), atol=T_ATOL, rtol=T_RTOL)
    np.testing.assert_allclose(g_exits, np.array(exits[:, :, 0]), atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(g_gacc, np.array(gacc), atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(g_stats, np.array(stats[:, 0]), atol=T_ATOL, rtol=T_RTOL)
    # each channel holds its edges' posterior mass, which the stats lanes sum
    for ci, members in enumerate(pgroups):
        np.testing.assert_allclose(g_p[:, :, ci].sum((1, 2)), g_stats[:, list(members)].sum(1),
                                   rtol=1e-5)
    # the other outputs are those of the match-posterior stage 4
    plain = fk.backward_sm3(*args, stages=4, wgroups=tpp.sm3_wgroups(plan))
    for a, r in zip(got[1:], plain[1:]):
        assert torch.equal(a, r)


def test_pgroups_limits():
    """The edge-group mode's limits: stage 4 only, 1-8 groups, members
    among the plan's edges (any of 64: 64-bit masks)."""
    assert fk.pgroup_masks(((0, 63), (1,)), 64, 4) == [1 - (1 << 63), 2]
    for bad, match in ((((0,),), "stage-4"), ((), "1-8"), (((0,),) * 9, "1-8"),
                       (((13,),), r"outside \[0, 13\)")):
        with pytest.raises(ValueError, match=match):
            fk.pgroup_masks(bad, 13, 3 if match == "stage-4" else 4)


def test_symbol_emissions_match_host_packing():
    """(b) The symbol lane's E, gathered on the device from the code arrays
    and the tables, equals make_window_problem's host-built E at every band
    cell; the diagonal scalars agree on the rows the kernels read."""
    from cpecan_signal_tpu_torch.core.window import smooth_band

    cases = _pairs(7, (40, 60))
    _jj, tjobs, _o = _jobs(cases, ragged=True)
    for W in (64, 128):
        staged, plan = [], None
        for i, j in enumerate(tjobs):
            wb = smooth_band(j.band, width_multiple=W)
            if wb.W != W:
                continue
            sj, plan = trp.stage_symbol_job(j, wb)
            staged.append((i, sj, plan))
        assert staged
        Dp = trp._dp_ladder(max(s[1].wband.n_diagonals for s in staged) + 2)
        bufs, _n = trp.stage_symbol_bucket(staged, list(range(len(staged))), CPU)
        sj0 = staged[0][1]
        prob, _cx, _cy, real = trp.symbol_problem(W, Dp, len(sj0.tp_scalar), len(sj0.start),
                                                  *bufs)
        assert prob.E.shape == (len(staged), Dp + 2, 3, W) and real.all()
        for bi, (i, sj, _p) in enumerate(staged):
            job = tjobs[i]
            hplan, host = tpp.make_window_problem(job.sm, sj.wband, device=CPU,
                                                  ragged_left=job.ragged_left,
                                                  ragged_right=job.ragged_right, pad_d=Dp)
            assert hplan == plan
            D = sj.wband.n_diagonals
            _x, _y, valid = window_grids(sj.wband)
            dv, jv = np.nonzero(valid)
            np.testing.assert_array_equal(prob.E[bi, dv, :, jv].numpy(),
                                          host.E[dv, :, jv].numpy())
            assert (prob.E[bi, D:] == 0).all()
            np.testing.assert_array_equal(prob.diag_scalars[bi, :D - 2].numpy(),
                                          host.diag_scalars[:D - 2].numpy())
            np.testing.assert_array_equal(prob.x0[bi, :D].numpy(), host.x0[:D].numpy())
            for field in ("d_last", "start", "end", "tp_scalar"):
                np.testing.assert_array_equal(getattr(prob, field)[bi].numpy(),
                                              getattr(host, field).numpy(), err_msg=field)


@pytest.fixture(scope="module")
def em_case():
    """Three pairs (one split into several jobs by a small split size) and
    their jobs in both packages, with JAX's interpreted E-step."""
    cases = _pairs(3, (36, 57, 44))
    jj, tj, owners = _jobs(cases, ragged=False)
    want = jdp.discrete_expectations_batched(jj, interpret=True)
    return cases, jj, tj, owners, want


def test_discrete_expectations_match_pallas_and_host(em_case):
    """(c) Per-job tallies against JAX's device E-step (interpret mode);
    per-pair sums against the host f64 oracle."""
    cases, _jj, tj, owners, want = em_case
    before = dict(fk.LAUNCHES)
    got = tdisc.discrete_expectations_batched(tj, device=CPU)
    assert fk.LAUNCHES == before             # plain versions on the CPU
    assert len(got) == len(want)
    for (gt, ge, gl), (wt, we, wl) in zip(got, want):
        assert gt.shape == (5, 5) and ge.shape == (5, 4, 4)
        np.testing.assert_allclose(gt, wt, rtol=STEP_RTOL, atol=STEP_ATOL)
        np.testing.assert_allclose(ge, we, rtol=STEP_RTOL, atol=STEP_ATOL)
        assert abs(gl - wl) <= LIK_RTOL * abs(wl)
    for ci, (sx, sy, anchors) in enumerate(cases):
        acc = discrete_expectations(jmake_sm, sx, sy, anchors, JParams(),
                                    ragged_left=False, ragged_right=False)
        mine = [g for g, o in zip(got, owners) if o == ci]
        np.testing.assert_allclose(sum(m[0] for m in mine), acc.transitions,
                                   rtol=HOST_RTOL, atol=HOST_ATOL)
        np.testing.assert_allclose(sum(m[1] for m in mine), acc.emissions,
                                   rtol=HOST_RTOL, atol=HOST_ATOL)
        assert abs(sum(m[2] for m in mine) - acc.likelihood) < \
            HOST_LIK * max(abs(acc.likelihood), 1)
        # the match state's emissions carry most of the mass, on the diagonal
        assert np.trace(sum(m[1] for m in mine)[0]) > 0.5 * sum(m[1] for m in mine)[0].sum()


def test_discrete_tallies_independent_of_bucketing(em_case, monkeypatch):
    """(c) Each job's tallies are the same bit for bit whether the jobs run
    in one bucket, one bucket each, or in reverse order."""
    _cases, _jj, tj, _owners, _want = em_case
    together = tdisc.discrete_expectations_batched(tj, device=CPU)
    reverse = tdisc.discrete_expectations_batched(tj[::-1], device=CPU)[::-1]
    monkeypatch.setattr(trp, "MAX_BUCKET", 1)
    timing = {}
    alone = tdisc.discrete_expectations_batched(tj, device=CPU, timing=timing)
    assert timing["buckets"] == len(tj)
    for other in (reverse, alone):
        for (a, b, c), (x, y, z) in zip(together, other):
            assert np.array_equal(a, x) and np.array_equal(b, y) and c == z


def test_pairwise_sum_ignores_trailing_zeros():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.random((3, 37)).astype(np.float32))
    s = tdisc.pairwise_sum(v)
    for pad in (1, 27, 91):
        assert torch.equal(tdisc.pairwise_sum(torch.nn.functional.pad(v, (0, pad))), s)
    np.testing.assert_allclose(s.numpy(), v.numpy().sum(1), rtol=1e-6)


def _agree(got, want):
    db = {(x, y): p for p, x, y in got.as_tuples()}
    ds = {(x, y): p for p, x, y in want.as_tuples()}
    common = set(db) & set(ds)
    drift = max((abs(db[k] - ds[k]) / 1e7 for k in common), default=0.0)
    return max(len(db), len(ds)) - len(common), drift


def test_symbol_lane_pairs_match_pallas():
    """(d) Pairs of every job through the symbol lane (64- and 128-lane
    windows, ragged ends) against JAX batch_align_jobs in interpret mode."""
    cases = _pairs(5, (48, 60))
    cases.append(_pairs(9, (70,))[0][:2] + (np.zeros((0, 2), dtype=np.int64),))
    jj, tj, _o = _jobs(cases, ragged=True)
    widths = {tba.job_window(j.band).W for j in tj}
    assert widths == {64, 128}
    before = dict(fk.LAUNCHES)
    got = tba.batch_align_jobs(tj, 0.01, device=CPU)
    assert fk.LAUNCHES == before
    want = jbatch_align_jobs(jj, 0.01, interpret=True)
    for g, w in zip(got, want):
        miss, drift = _agree(g, w)
        assert miss <= PAIR_TOL and drift <= PROB_TOL, (miss, drift)
        assert len(g.probs) > 0


def test_symbol_overflow_reroutes_to_full_grid(monkeypatch):
    """(d) A symbol job whose pairs overflow the compact extraction goes to
    the full-grid buckets, with the same pairs."""
    (sx, sy, anchors), = _pairs(5, (48,))
    _jj, tj, _o = _jobs([(sx, sy, anchors)], ragged=True)
    want = tba.batch_align_jobs(tj, 0.01, device=CPU)
    calls = []
    real = tba._run_generic_buckets
    monkeypatch.setattr(tba, "_run_generic_buckets",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    monkeypatch.setattr(trp, "_EXTRACT_L", 0)
    got = tba.batch_align_jobs(tj, 0.01, device=CPU)
    assert calls and list(calls[0]) == [("fiveState", tba.job_window(tj[0].band).W)]
    for g, w in zip(got, want):
        assert _agree(g, w) == (0, 0.0)
