"""PyTorch port on a CUDA card: each hand-written kernel against its plain
PyTorch version on the same CUDA tensors (at the threeState, vanilla,
echelon and fiveState plans, the last with the backward kernel's edge-group
posterior channels, and at the stage-4 configurations of the vanilla and
threeStateHdp E-steps), the threeStateHdp emission grid, and the
device-batched slice on the card against the CPU plain path (threeState,
vanilla and threeStateHdp alignment, and the nucleotide, vanilla and
threeStateHdp E-steps, whose tallies must also agree bit for bit between two
card runs).

Every test needs a card and skips without one.  The file imports no jax, so
on a machine with a card and without jax it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: the kernels run the same rounded f32 operations as the plain
versions (no FMA contraction, the same expf/logf), so E is held to rtol
1e-6; F and the totals to atol 1e-3 + rtol 1e-5 and p to atol 1e-4 leave
room only for the order of the block-wide sums.  The slice is held to
<= 1 pair per job and 1.2e-3 posterior (tests/test_readpath_random.py).
"""

import numpy as np
import pytest
import torch

from cpecan_signal_tpu_torch.core.band import band_construct
from cpecan_signal_tpu_torch.core.window import smooth_band
from cpecan_signal_tpu_torch.models.params import AlignmentParams
from cpecan_signal_tpu_torch.models.state_machines import (make_signal_echelon,
                                                            make_signal_sm3,
                                                            make_signal_vanilla)
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.em import sm3_em
from cpecan_signal_tpu_torch.engine import pipeline as pp
from cpecan_signal_tpu_torch.engine.align import SplitJob
from cpecan_signal_tpu_torch.engine.batch_align import batch_align_jobs
from cpecan_signal_tpu_torch.engine.plan import edge_table
from cpecan_signal_tpu_torch.ops import fb_kernels as fk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_forward_close(got, want):
    """(F, offF) against (F, offF): F relative to its offsets within the F
    tolerance, the offsets (sums of row maxima) exactly."""
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    assert torch.equal(got[1], want[1])


def _pore(tmp_path, rng):
    return syn.write_pore_model(str(tmp_path / "synthetic.model"), rng)


def _cases(pore, rng, n, W, expansion=20):
    """n synthetic (target, events, window band) triples fitting W lanes."""
    out = []
    while len(out) < n:
        target = "".join(rng.choice(list("ACGT"), int(rng.integers(60, 160))))
        events, path = syn.simulate_events(pore, target, rng)
        n_kmers = len(target) - 5
        band = band_construct(syn.path_anchors(path, n_kmers, len(events), 20),
                              n_kmers, len(events), expansion)
        wb = smooth_band(band, width_multiple=W)
        if wb.W == W:
            out.append((target, events, band, wb))
    return out


@pytest.mark.parametrize("W", [64, 128])
def test_cuda_kernels_match_plain(W, cuda_device, tmp_path):
    rng = np.random.default_rng(W)
    pore = _pore(tmp_path, rng)
    cases = _cases(pore, rng, 5, W)
    Dp = max(wb.n_diagonals for *_x, wb in cases) + 3
    plan, probs = None, []
    for i, (target, events, _band, wb) in enumerate(cases):
        plan, prob = pp.make_sm3_problem(pore, target, events, wb, device=cuda_device,
                                         ragged_left=bool(i % 2), ragged_right=i < 3,
                                         pad_lx=170, pad_ly=200, pad_d=Dp)
        probs.append(prob)
    b = pp.stack_problems(probs)
    edges = pp.to_device(edge_table(plan), cuda_device)
    before = dict(fk.LAUNCHES)
    E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F, offF = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    p, tot = fk.backward_sm3(edges, plan.match_state, E, F, offF, b.diag_scalars,
                             b.d_last, b.end, b.tp_scalar)
    torch.cuda.synchronize()
    assert all(fk.LAUNCHES[k] == before[k] + 1 for k in ("emissions", "forward", "backward"))
    assert fk.LAUNCHES["backward_em"] == before["backward_em"]
    E_ref = fk.emissions_sm3_ref(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F_ref, offF_ref = fk.forward_sm3_ref(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    p_ref, tot_ref = fk.backward_sm3_ref(edges, plan.match_state, E, F, offF,
                                         b.diag_scalars, b.d_last, b.end, b.tp_scalar)
    torch.testing.assert_close(E, E_ref, rtol=1e-6, atol=0)
    assert_forward_close((F, offF), (F_ref, offF_ref))
    torch.testing.assert_close(p, p_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(tot, tot_ref, rtol=1e-5, atol=1e-3)
    assert float(p.sum()) > 0.25 * float(b.d_last.sum())


@pytest.mark.parametrize("W", [64, 128])
def test_cuda_backward_em_matches_plain(W, cuda_device, tmp_path):
    """The stage-4 backward kernel against its plain version: p, totals,
    exits and gacc to the stage-3 tolerances and 1e-6 (the same sums in the
    same order), stats to atol 1e-3 + rtol 1e-5 (the kernel sums each lane
    over the diagonals first, the plain version each diagonal over the lanes
    first); with the default group and with four groups."""
    rng = np.random.default_rng(W + 7)
    pore = _pore(tmp_path, rng)
    cases = _cases(pore, rng, 4, W)
    Dp = max(wb.n_diagonals for *_x, wb in cases) + 5
    plan, probs = None, []
    for i, (target, events, _band, wb) in enumerate(cases):
        plan, prob = pp.make_sm3_problem(pore, target, events, wb, device=cuda_device,
                                         ragged_left=bool(i % 2), ragged_right=i < 2,
                                         pad_lx=170, pad_ly=200, pad_d=Dp)
        probs.append(prob)
    b = pp.stack_problems(probs)
    edges = pp.to_device(edge_table(plan), cuda_device)
    E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F, offF = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    args = (edges, plan.match_state, E, F, offF, b.diag_scalars, b.d_last, b.end,
            b.tp_scalar)
    for groups in (pp.sm3_wgroups(plan), ((0, 1, 2), (3,), (6, 7), (4, 5))):
        before = fk.LAUNCHES["backward_em"]
        got = fk.backward_sm3(*args, stages=4, wgroups=groups)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["backward_em"] == before + 1
        want = fk.backward_sm3_ref(*args, 4, groups)
        p, tot, exits, gacc, stats = got
        torch.testing.assert_close(p, want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(tot, want[1], rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(exits, want[2], rtol=0, atol=1e-6)
        torch.testing.assert_close(gacc, want[3], rtol=0, atol=1e-6)
        torch.testing.assert_close(stats, want[4], rtol=1e-5, atol=1e-3)
        assert exits.shape == (len(probs), Dp, len(groups)) and float(exits.sum()) > 0.5


@pytest.mark.parametrize("W, bases", [(640, (570, 630)), (1024, (960, 1000))])
def test_cuda_backward_wide_window_matches_plain(W, bases, cuda_device, tmp_path):
    """Wide windows (two unanchored reads) match the plain version at both
    stages as the narrow ones do: 1024 lanes, the widest block the backward
    kernel's 64 registers a thread allow, and 640 lanes, where stage 4's
    dynamic shared memory (47 KB) and the static arrays together pass the
    48 KB a block gets without the opt-in."""
    rng = np.random.default_rng(23)
    pore = _pore(tmp_path, rng)
    plan, probs = None, []
    while len(probs) < 2:
        target = "".join(rng.choice(list("ACGT"), int(rng.integers(*bases))))
        events, _path = syn.simulate_events(pore, target, rng)
        wb = smooth_band(band_construct(np.zeros((0, 2), dtype=np.int64), len(target) - 5,
                                        len(events), 50), width_multiple=128)
        if wb.W == W:
            plan, prob = pp.make_sm3_problem(pore, target, events, wb, device=cuda_device,
                                             pad_lx=1000, pad_ly=1300, pad_d=2400)
            probs.append(prob)
    b = pp.stack_problems(probs)
    edges = pp.to_device(edge_table(plan), cuda_device)
    E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, b.diag_scalars.shape[1] - 1)
    F, offF = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    args = (edges, plan.match_state, E, F, offF, b.diag_scalars, b.d_last, b.end,
            b.tp_scalar)
    groups = pp.sm3_wgroups(plan)
    p3, tot3 = fk.backward_sm3(*args)
    got = fk.backward_sm3(*args, stages=4, wgroups=groups)
    torch.cuda.synchronize()
    want = fk.backward_sm3_ref(*args, 4, groups)
    for p, tot in ((p3, tot3), got[:2]):
        torch.testing.assert_close(p, want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(tot, want[1], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=1e-3)
    assert float(p3.sum()) > 0.25 * float(b.d_last.sum())


def test_cuda_em_budget_streaming_matches_resident(cuda_device, tmp_path):
    """A zero budget keeps every EM bucket in pinned host memory and uploads
    it at each step (row 12 of xarr then rewritten on the upload); two
    E-steps give those of an all-resident build.  trans and the likelihood
    are equal; kmer_gap is held to rtol 1e-5, since the per-k-mer
    scatter_add_ adds its f32 terms (all >= 0) with atomics in no fixed
    order."""
    rng = np.random.default_rng(31)
    pore = _pore(tmp_path, rng)
    jobs = [sm3_em.EmJob(pore, t, e, band, bool(i % 2), i < 3)
            for i, (t, e, band, _wb) in enumerate(_cases(pore, rng, 6, 64))]
    res_budget = sm3_em._EmBudget(cuda_device, budget=float("inf"))
    resident = sm3_em.build_sm3_em_buckets(jobs, device=cuda_device, budget=res_budget)
    str_budget = sm3_em._EmBudget(cuda_device, budget=0)
    streamed = sm3_em.build_sm3_em_buckets(jobs, device=cuda_device, budget=str_budget)
    assert all(b.resident and b.batch.xarr.is_cuda for b in resident)
    assert not any(b.resident for b in streamed)
    assert all(t.is_pinned() for b in streamed for t in b.batch)
    assert str_budget.streamed == res_budget.resident > 0
    kmer_gaps = np.log(rng.dirichlet(np.ones(4096))).astype(np.float64)
    trans = {"match_continue": float(np.log(0.8)), "match_from_gap_x": float(np.log(0.7))}
    before = fk.LAUNCHES["backward_em"]
    for step in ((None, None), (trans, kmer_gaps)):
        (t_r, k_r, l_r), (t_s, k_s, l_s) = (sm3_em.sm3_em_step(bs, *step)
                                            for bs in (resident, streamed))
        np.testing.assert_array_equal(t_s, t_r)
        assert l_s == l_r
        np.testing.assert_allclose(k_s, k_r, rtol=1e-5, atol=0)
        assert k_r.sum() > 0
    assert fk.LAUNCHES["backward_em"] == before + 4 * len(resident)


def test_cuda_wrappers_reject_bad_input(cuda_device):
    """Wrong dtypes and mixed devices raise before any launch."""
    x0 = torch.zeros((1, 9), dtype=torch.int64, device=cuda_device)
    xarr = torch.zeros((1, 13, 512), device=cuda_device)
    evr = torch.zeros((1, 2, 512), device=cuda_device)
    before = dict(fk.LAUNCHES)
    with pytest.raises(TypeError):
        fk.emissions_sm3(x0, x0, xarr, evr, 64, 8)
    with pytest.raises(ValueError, match="different devices"):
        fk.emissions_sm3(x0.int(), x0.int().cpu(), xarr, evr, 64, 8)
    with pytest.raises(ValueError, match="multiple of 32"):
        fk.emissions_sm3(x0.int(), x0.int(), xarr, evr, 48, 8)
    assert fk.LAUNCHES == before


def test_cuda_slice_matches_cpu(cuda_device, tmp_path):
    """batch_align_jobs on the card (kernels) against the CPU (plain
    versions) on the same synthetic split jobs, ragged ends mixed."""
    rng = np.random.default_rng(7)
    pore = _pore(tmp_path, rng)
    jobs = [SplitJob(make_signal_sm3(pore, t, e), band, 0, 0, bool(i % 2), i < 4)
            for i, (t, e, band, _wb) in enumerate(_cases(pore, rng, 8, 64, expansion=6))]
    before = fk.LAUNCHES["backward"]
    got = batch_align_jobs(jobs, AlignmentParams().threshold, device=cuda_device)
    assert fk.LAUNCHES["backward"] > before
    want = batch_align_jobs(jobs, AlignmentParams().threshold, device=torch.device("cpu"))
    for g, w in zip(got, want):
        dg = {(x, y): q for q, x, y in g.as_tuples()}
        dw = {(x, y): q for q, x, y in w.as_tuples()}
        common = set(dg) & set(dw)
        assert len(common) >= max(len(dg), len(dw), 1) - 1
        assert all(abs(dg[k] - dw[k]) < 1.2e-3 * 1e7 for k in common)


GENERIC = {"vanilla": (make_signal_vanilla, None),
           "echelon": (make_signal_echelon, (1, 2, 3, 4, 5))}


@pytest.mark.parametrize("name", list(GENERIC))
@pytest.mark.parametrize("W", [128, 1024])
def test_cuda_generic_kernels_match_plain(name, W, cuda_device, tmp_path):
    """The forward and stage-3 backward kernels at the vanilla plan (3
    states, 7 edges, 8 channels) and the echelon plan (7 states, 46 edges,
    17 channels, backward with the per-state posteriors) against their plain
    versions: 4 anchored reads at 128 lanes, 2 unanchored reads of 960-1000
    bases whose band needs 1024 lanes (echelon's carry rows then take 86 KB
    of shared memory)."""
    make, pstates = GENERIC[name]
    rng = np.random.default_rng(W + len(name))
    pore = _pore(tmp_path, rng)
    if W == 128:
        cases = [(t, e, wb) for t, e, _band, wb in _cases(pore, rng, 4, W)]
    else:
        cases = []
        while len(cases) < 2:
            target = "".join(rng.choice(list("ACGT"), int(rng.integers(960, 1000))))
            events, _path = syn.simulate_events(pore, target, rng)
            wb = smooth_band(band_construct(np.zeros((0, 2), dtype=np.int64),
                                            len(target) - 5, len(events), 50),
                             width_multiple=128)
            if wb.W == W:
                cases.append((target, events, wb))
    Dp = max(wb.n_diagonals for *_x, wb in cases) + 3
    plan, probs = None, []
    for i, (target, events, wb) in enumerate(cases):
        plan, prob = pp.make_window_problem(make(pore, target, events, "template"), wb,
                                            device=cuda_device, ragged_left=bool(i % 2),
                                            ragged_right=i < 2, pad_d=Dp)
        probs.append(prob)
    b = pp.stack_window_problems(probs)
    edges = pp.to_device(edge_table(plan), cuda_device)
    fargs = (edges, b.E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    before = dict(fk.LAUNCHES)
    F, offF = fk.forward_sm3(*fargs)
    bargs = (edges, plan.match_state, b.E, F, offF, b.diag_scalars, b.d_last, b.end,
             b.tp_scalar)
    p, tot = fk.backward_sm3(*bargs, pstates=pstates)
    torch.cuda.synchronize()
    mode = "backward" if pstates is None else "backward_pstates"
    assert fk.LAUNCHES["forward"] == before["forward"] + 1
    assert fk.LAUNCHES[mode] == before[mode] + 1
    F_ref, offF_ref = fk.forward_sm3_ref(*fargs)
    p_ref, tot_ref = fk.backward_sm3_ref(*bargs, pstates=pstates)
    assert_forward_close((F, offF), (F_ref, offF_ref))
    torch.testing.assert_close(p, p_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(tot, tot_ref, rtol=1e-5, atol=1e-3)
    assert p.shape == ((len(cases), Dp, W) if pstates is None
                       else (len(cases), Dp, len(pstates), W))
    assert float(p.sum()) > 0.25 * float(b.d_last.sum())


def test_cuda_generic_slice_matches_cpu(cuda_device, tmp_path):
    """batch_align_jobs of vanilla jobs (the CLIs' default machine) on the
    card against the CPU plain path, ragged ends and strands mixed."""
    rng = np.random.default_rng(11)
    pore = _pore(tmp_path, rng)
    jobs = [SplitJob(make_signal_vanilla(pore, t, e, "template" if i % 2 else "complement"),
                     band, 0, 0, bool(i % 2), i < 4)
            for i, (t, e, band, _wb) in enumerate(_cases(pore, rng, 8, 64, expansion=6))]
    before = fk.LAUNCHES["backward"]
    got = batch_align_jobs(jobs, AlignmentParams().threshold, device=cuda_device)
    assert fk.LAUNCHES["backward"] > before
    want = batch_align_jobs(jobs, AlignmentParams().threshold, device=torch.device("cpu"))
    for g, w in zip(got, want):
        dg = {(x, y): q for q, x, y in g.as_tuples()}
        dw = {(x, y): q for q, x, y in w.as_tuples()}
        common = set(dg) & set(dw)
        assert len(common) >= max(len(dg), len(dw), 1) - 1
        assert all(abs(dg[k] - dw[k]) < 1.2e-3 * 1e7 for k in common)


def _symbol_problems(rng, n, W, expansion, device):
    """(plan, WindowProblem) of n fiveState problems on random 300-base
    pairs (5 % substitutions, 0.5 % indels), ragged ends mixed, staged by
    the symbol lane (E gathered on the device)."""
    from cpecan_signal_tpu_torch.core.window import smooth_band
    from cpecan_signal_tpu_torch.engine import readpath

    staged = []
    for i, job in enumerate(_symbol_jobs(rng, 4 * n, expansion)):
        wb = smooth_band(job.band, width_multiple=W)
        if wb.W == W and len(staged) < n:
            staged.append((i, *readpath.stage_symbol_job(job, wb)))
    assert len(staged) == n
    return _symbol_bucket(staged, W, device)


def _symbol_bucket(staged, W, device):
    """(plan, WindowProblem) of the staged symbol jobs as one bucket."""
    from cpecan_signal_tpu_torch.engine import readpath

    n = len(staged)
    Dp = max(sj.wband.n_diagonals for _i, sj, _p in staged) + 3
    tables, bucket, _n = readpath.stage_symbol_bucket(staged, list(range(n)), Dp, device)
    return staged[0][2], readpath.symbol_problem(W, tables, bucket)


def _bound_sm5(sx, sy):
    from cpecan_signal_tpu_torch.models.state_machines import (bind_symbol_sequences,
                                                                make_symbol_sm5)

    sm = make_symbol_sm5()
    bind_symbol_sequences(sm, sx, sy)
    return sm


def _symbol_jobs(rng, n, expansion):
    from cpecan_signal_tpu_torch.em.discrete import collect_symbol_split_jobs

    jobs = []
    for i in range(n):
        x = "".join(rng.choice(list("ACGT"), 300))
        y, truth = syn.evolve_with_truth(x, rng, 0.05, 0.005, 0.005)
        jobs += collect_symbol_split_jobs(_bound_sm5, x, y, truth[::10],
                                          AlignmentParams(diagonal_expansion=expansion),
                                          ragged_left=bool(i % 2), ragged_right=i % 4 < 2)
    return jobs


@pytest.mark.parametrize("W, expansion", [(64, 20), (128, 60)])
def test_cuda_backward_pgroups_matches_plain(W, expansion, cuda_device):
    """The stage-4 backward kernel with edge groups against its plain
    version: the posterior channels to p's atol 1e-4, totals, exits and gacc
    as without groups, stats to atol 1e-3 + rtol 1e-5; one channel per
    to-state (the nucleotide E-step's) and eight single-edge channels."""
    rng = np.random.default_rng(W + 3)
    _check_pgroups(*_symbol_problems(rng, 5, W, expansion, cuda_device), W, pgroup_sets=2)


@pytest.mark.parametrize("W, bases", [(640, (570, 630)), (1024, (960, 1000))])
def test_cuda_backward_pgroups_wide_window_matches_plain(W, bases, cuda_device):
    """The edge-group stage 4 on wide windows (two unanchored pairs of
    570-630 and 960-1000 bases) as on the narrow ones: past 512 lanes, and
    at 1024, the widest recursion block."""
    from cpecan_signal_tpu_torch.em.discrete import collect_symbol_split_jobs
    from cpecan_signal_tpu_torch.engine import readpath

    rng = np.random.default_rng(W + 5)
    staged = []
    while len(staged) < 2:
        x = "".join(rng.choice(list("ACGT"), int(rng.integers(*bases))))
        y, _truth = syn.evolve_with_truth(x, rng, 0.05, 0.005, 0.005)
        job, = collect_symbol_split_jobs(_bound_sm5, x, y, np.zeros((0, 2), dtype=np.int64),
                                         AlignmentParams(), ragged_left=False,
                                         ragged_right=bool(staged))
        wb = smooth_band(job.band, width_multiple=128)
        if wb.W == W:
            staged.append((len(staged), *readpath.stage_symbol_job(job, wb)))
    _check_pgroups(*_symbol_bucket(staged, W, cuda_device), W, pgroup_sets=1)


def _check_pgroups(plan, b, W, pgroup_sets):
    """The fiveState forward and the edge-group stage 4 of the bucket on the
    card against their plain versions; the first ``pgroup_sets`` of: one
    channel per to-state, eight single-edge channels."""
    from cpecan_signal_tpu_torch.em.discrete import _to_state_pgroups

    dev = b.E.device
    edges = pp.to_device(edge_table(plan), dev)
    F, offF = fk.forward_sm3(edges, b.E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    assert_forward_close((F, offF), fk.forward_sm3_ref(edges, b.E, b.diag_scalars,
                                                       b.d_last, b.start, b.tp_scalar))
    args = (edges, plan.match_state, b.E, F, offF, b.diag_scalars, b.d_last, b.end,
            b.tp_scalar)
    groups = pp.sm3_wgroups(plan)
    sets = (_to_state_pgroups(plan), tuple((e,) for e in (0, 2, 4, 5, 8, 9, 11, 12)))
    for pgroups in sets[:pgroup_sets]:
        before = dict(fk.LAUNCHES)
        got = fk.backward_sm3(*args, stages=4, wgroups=groups, pgroups=pgroups)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["backward_pgroups"] == before["backward_pgroups"] + 1
        assert fk.LAUNCHES["backward_em"] == before["backward_em"]
        want = fk.backward_sm3_ref(*args, 4, groups, None, pgroups)
        p, tot, exits, gacc, stats = got
        assert p.shape == (b.E.shape[0], F.shape[1], len(pgroups), W)
        torch.testing.assert_close(p, want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(tot, want[1], rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(exits, want[2], rtol=0, atol=1e-6)
        torch.testing.assert_close(gacc, want[3], rtol=0, atol=1e-6)
        torch.testing.assert_close(stats, want[4], rtol=1e-5, atol=1e-3)
        assert float(p.sum()) > 0.25 * float(b.d_last.sum())


def test_cuda_discrete_estep_matches_cpu(cuda_device):
    """The nucleotide E-step (em/discrete.py) on the card against the CPU
    plain path (trans and emiss rtol 1e-4 + atol 1e-5, likelihood 1e-5
    relative), and two card runs equal bit for bit."""
    from cpecan_signal_tpu_torch.em.discrete import discrete_expectations_batched

    jobs = _symbol_jobs(np.random.default_rng(5), 6, 20)
    before = fk.LAUNCHES["backward_pgroups"]
    got = discrete_expectations_batched(jobs, device=cuda_device)
    assert fk.LAUNCHES["backward_pgroups"] > before
    again = discrete_expectations_batched(jobs, device=cuda_device)
    want = discrete_expectations_batched(jobs, device=torch.device("cpu"))
    for (t, e, lik), (t2, e2, lik2), (wt, we, wl) in zip(got, again, want):
        assert np.array_equal(t, t2) and np.array_equal(e, e2) and lik == lik2
        np.testing.assert_allclose(t, wt, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(e, we, rtol=1e-4, atol=1e-5)
        assert abs(lik - wl) <= 1e-5 * abs(wl)


def test_cuda_discrete_estep_independent_of_rungs(cuda_device, monkeypatch):
    """On the card, symbol jobs of four Dp rungs share one launch padded to
    the longest's rung (readpath.symbol_buckets), and each job's tallies and
    likelihood equal those of one job a launch bit for bit: the kernels stop
    at each job's own last diagonal."""
    from cpecan_signal_tpu_torch.em.discrete import (collect_symbol_split_jobs,
                                                     discrete_expectations_batched)
    from cpecan_signal_tpu_torch.engine import readpath

    rng = np.random.default_rng(17)
    jobs = []
    for i, n in enumerate((100, 400, 1200, 250)):
        x = "".join(rng.choice(list("ACGT"), n))
        y, truth = syn.evolve_with_truth(x, rng, 0.05, 0.005, 0.005)
        jobs += collect_symbol_split_jobs(_bound_sm5, x, y, truth[::10], AlignmentParams(),
                                          ragged_left=bool(i % 2), ragged_right=i < 2)
    wbands = [smooth_band(j.band, width_multiple=128) for j in jobs]
    assert len({readpath._dp_ladder(wb.n_diagonals + 2) for wb in wbands}) == 4
    assert len({wb.W for wb in wbands}) == 1
    timing = {}
    together = discrete_expectations_batched(jobs, device=cuda_device, timing=timing)
    assert timing["buckets"] == 1
    monkeypatch.setattr(readpath.pp, "MAX_BUCKET", 1)
    alone = discrete_expectations_batched(jobs, device=cuda_device)
    for (t, e, lik), (t2, e2, lik2) in zip(together, alone):
        assert np.array_equal(t, t2) and np.array_equal(e, e2) and lik == lik2


def test_cuda_launch_config_matches_wrappers(cuda_device):
    """The C library sizes the recursion's E ring, the epilogue block and
    the emissions block as ops/fb_kernels.ring_depth, epilogue_warps and
    emission_config do (the CPU tests check those at every plan and width)."""
    import ctypes

    from cpecan_signal_tpu_torch.ops._build import load_library

    lib = load_library()
    cfg = (ctypes.c_int * 4)()
    for S, C, n_edges in ((3, 3, 8), (4, 3, 11), (3, 8, 7), (7, 17, 46), (5, 3, 13)):
        for W in range(32, 1025, 32):
            for em in (0, 1):
                lib.fb_launch_config(S, C, W, n_edges, em, cfg)
                assert tuple(cfg) == (fk.ring_depth(S, C, W)
                                      + fk.epilogue_warps(S, W, n_edges, bool(em)))
    for W in range(32, 1025, 32):
        lib.fb_emissions_config(W, cfg)
        assert tuple(cfg) == fk.emission_config(W)


def test_cuda_em_step_counts_sm_slots(cuda_device, monkeypatch):
    """An EM step on the card adds SMs x the recursion blocks an SM holds x
    each bucket's Dp to em.sm_slots; the occupancy calculator gives at least
    one block at every width, and one at 1024 lanes."""
    from cpecan_signal_tpu_torch.utils.observability import counters
    from test_torch_tracing import _em_jobs

    assert fk.recursion_blocks_per_sm(3, 3, 1024, 0) == 1
    assert all(fk.recursion_blocks_per_sm(3, 3, W, 0) >= 1 for W in range(32, 1025, 32))
    monkeypatch.setattr(sm3_em.pp, "MAX_BUCKET", 2)
    jobs = _em_jobs(np.random.default_rng(7), (30, 44, 38, 52, 41))
    buckets = sm3_em.build_sm3_em_buckets(jobs, device=cuda_device, width_multiple=64)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    want = sum(sms * fk.recursion_blocks_per_sm(3, 3, b.W, torch.cuda.current_device()) * b.Dp
               for b in buckets)
    before = counters.snapshot().get("em.sm_slots", 0.0)
    sm3_em.sm3_em_step(buckets)
    assert counters.snapshot()["em.sm_slots"] - before == want > 0


@pytest.mark.parametrize("W, Dp, B, offsets", [
    (128, 301, 4, "band"),        # Dp no multiple of the tile
    (32, 40, 3, "band"),          # Dp below the tile
    (1024, 512, 2, "band"),       # 1024 threads and 66 KB of shared memory a block
    (128, 1000, 1, "band"),       # one problem
    (128, 301, 4, "random"),      # every other tile off the band: device-memory path
    (1024, 512, 2, "random"),
    (64, 301, 2, "unaligned"),    # rows off 16 bytes: every tile from device memory
])
def test_cuda_emissions_match_plain_bit_for_bit(W, Dp, B, offsets, cuda_device):
    """The tiled emissions kernel equals its plain version bit for bit on
    band offsets (pipeline.band_scalars of random +-1 walks, both clamps away)
    and off the band (every other tile's offsets random past both ends of
    the rows), at the launch shapes' edges."""
    import chip_smoke

    rng = np.random.default_rng(W + Dp + B)
    x0, yr0, xarr, evr = chip_smoke.emission_inputs(
        rng, B, Dp, W, cuda_device, random_tiles=offsets == "random",
        unaligned=offsets == "unaligned")
    E = fk.emissions_sm3(x0, yr0, xarr, evr, W, Dp)
    E_ref = fk.emissions_sm3_ref(x0, yr0, xarr, evr, W, Dp)
    torch.cuda.synchronize()
    assert E.shape == (B, Dp + 2, 3, W)
    assert torch.equal(E, E_ref), float((E - E_ref).abs().max())
    assert (E[:, Dp:] == 0).all()


@pytest.mark.parametrize("Dp", [256, 301])
def test_cuda_ring_edges_match_plain(Dp, cuda_device, tmp_path):
    """The recursions' E ring at its edges: problems whose last diagonal
    comes before the ring's depth (d_last 6-14 against 12 slots) beside
    longer ones, ragged starts and ends mixed, at the smallest Dp rung (256)
    and at a Dp that is no multiple of the ring's depth; forward, stage 3
    and stage 4 against their plain versions at the tolerances above."""
    rng = np.random.default_rng(41)
    pore = _pore(tmp_path, rng)
    W = 64
    assert fk.ring_depth(3, 3, W)[0] == 12
    cases = []
    for n_bases in (8, 9, 10, 12, 40, 60):
        while True:
            target = "".join(rng.choice(list("ACGT"), n_bases))
            events, _path = syn.simulate_events(pore, target, rng)
            wb = smooth_band(band_construct(np.zeros((0, 2), dtype=np.int64),
                                            len(target) - 5, len(events), 20),
                             width_multiple=W)
            if wb.W == W:
                cases.append((target, events, wb))
                break
    plan, probs = None, []
    for i, (target, events, wb) in enumerate(cases):
        plan, prob = pp.make_sm3_problem(pore, target, events, wb, device=cuda_device,
                                         ragged_left=bool(i % 2), ragged_right=i < 3,
                                         pad_lx=170, pad_ly=400, pad_d=Dp)
        probs.append(prob)
    b = pp.stack_problems(probs)
    assert int(b.d_last.min()) < 12 < int(b.d_last.max())
    edges = pp.to_device(edge_table(plan), cuda_device)
    E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F, offF = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    args = (edges, plan.match_state, E, F, offF, b.diag_scalars, b.d_last, b.end,
            b.tp_scalar)
    groups = pp.sm3_wgroups(plan)
    p3, tot3 = fk.backward_sm3(*args)
    got = fk.backward_sm3(*args, stages=4, wgroups=groups)
    torch.cuda.synchronize()
    assert_forward_close((F, offF), fk.forward_sm3_ref(edges, E, b.diag_scalars,
                                                       b.d_last, b.start, b.tp_scalar))
    want = fk.backward_sm3_ref(*args, 4, groups)
    for p, tot in ((p3, tot3), got[:2]):
        torch.testing.assert_close(p, want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(tot, want[1], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=1e-3)
    assert float(p3.sum()) > 0.25 * float(b.d_last.sum())


# ---------------------------------------------------------------------------
# The vanilla and threeStateHdp E-steps and threeStateHdp alignment
# ---------------------------------------------------------------------------

HDP_GRID = (30.0, 90.0, 1200)


def _hdp_table(pore, device):
    """(table, g0, dg): a density table on HDP_GRID whose row of a k-mer is
    a normal density (sd 1.5 pA) at the pore model's level."""
    grid = np.linspace(*HDP_GRID[:2], HDP_GRID[2])
    level = np.concatenate([pore.match_model[:-2, 0], [60.0, 60.0]])
    tab = np.exp(-0.5 * ((grid[None, :] - level[:, None]) / 1.5) ** 2) / (1.5 * 2.5066283)
    return pp.to_device(tab.astype(np.float32), device), grid[0], grid[1] - grid[0]


def _em_problems(machine, pore, rng, W, Dp, B, device):
    """(plan, WindowProblem, wgroups, pgroups) of B problems (4 reads
    repeated, anchored every 20 events) of the vanilla E-step (the 5
    transition channels gathered on the card through the skip-bin grid) or
    the threeStateHdp E-step (E from the density table), padded to Dp."""
    from cpecan_signal_tpu_torch.em import hdp_em, vanilla_em
    from cpecan_signal_tpu_torch.engine import readpath
    from cpecan_signal_tpu_torch.engine.plan import plan_key_names
    from cpecan_signal_tpu_torch.models import state_machines as sms

    cases = []
    while len(cases) < 4:
        target = "".join(rng.choice(list("ACGT"), int(0.40 * Dp)))
        events, path = syn.simulate_events(pore, target, rng)
        n_kmers = len(target) - 5
        wb = smooth_band(band_construct(syn.path_anchors(path, n_kmers, len(events), 20),
                                        n_kmers, len(events), 20), width_multiple=W)
        if wb.W == W and wb.n_diagonals <= Dp:
            cases.append((target, events, wb, bool(len(cases) % 2), len(cases) < 2))
    idx = torch.arange(B) % 4
    cpu = torch.device("cpu")
    if machine == "vanilla":
        probs, keys = [], []
        for target, events, wb, rl, rr in cases:
            sm = sms.make_signal_vanilla(pore, target, events, "template")
            plan, prob = pp.make_window_problem(sm, wb, device=cpu, ragged_left=rl,
                                                ragged_right=rr, pad_d=Dp)
            probs.append(prob)
            keys.append(vanilla_em._bin_keys(sm, wb, prob.x0.numpy(), Dp))
        batch = vanilla_em.VanillaBatch(*pp.stack_window_problems(probs),
                                        *(torch.from_numpy(np.stack(c)) for c in zip(*keys)))
        batch = vanilla_em.VanillaBatch(*(f[idx].to(device) for f in batch))
        tabs, _s = sms.vanilla_transition_tables(pore.skip_bins, "template")
        cells = batch.bin_grid.long()
        for c, k in enumerate(plan_key_names(sm)[1]):
            row = pp.to_device(np.maximum(tabs[k], pp.NEG_INF).astype(np.float32), device)
            batch.E[:, :, plan.n_eclasses + c, :] = row[cells]
        return plan, pp.WindowProblem(*batch[:7]), vanilla_em.vanilla_wgroups(plan), None
    items = [(sms.make_signal_sm3_hdp(hdp_em._zero_density, t, e), wb, rl, rr)
             for t, e, wb, rl, rr in cases]
    plan, fields = pp.stack_window_scalars(items, Dp, cpu)
    rank, mean = (torch.from_numpy(np.stack(a)) for a in zip(
        *(pp.hdp_inputs(sm, Dp + 2) for sm, *_r in items)))
    ds, dl, start, end, tp, x0 = (f[idx].to(device) for f in fields)
    E = readpath.hdp_emissions(*_hdp_table(pore, device), rank[idx].to(device),
                               mean[idx].to(device), ds[:, :Dp, 0, fk.DS_W0], dl, W)
    return (plan, pp.WindowProblem(E, ds, dl, start, end, tp, x0), pp.sm3_wgroups(plan),
            hdp_em.hdp_pgroups(plan))


@pytest.mark.parametrize("machine, groups", [
    ("vanilla", (((0,), (1,)), None)),
    ("threeStateHdp", (((0, 1, 2),), ((3,), (4,), (5,))))])
def test_cuda_em_stage4_configs_match_plain(machine, groups, cuda_device, tmp_path):
    """The two stage-4 configurations of the vanilla and threeStateHdp
    E-steps at W = 128, Dp = 4096, B = 64, against the plain versions: the
    vanilla plan (7 edges, 3 emission classes, 5 transition channels) with
    window groups (beta, alpha), the threeStateHdp plan (8 edges) with one
    posterior channel per middle edge into match."""
    rng = np.random.default_rng(53 + len(machine))
    pore = _pore(tmp_path, rng)
    W, Dp = 128, 4096
    plan, b, wgroups, pgroups = _em_problems(machine, pore, rng, W, Dp, 64, cuda_device)
    assert (wgroups, pgroups) == groups
    edges = pp.to_device(edge_table(plan), cuda_device)
    fargs = (edges, b.E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    F, offF = fk.forward_sm3(*fargs)
    args = (edges, plan.match_state, b.E, F, offF, b.diag_scalars, b.d_last, b.end,
            b.tp_scalar)
    kernel = "backward_em" if pgroups is None else "backward_pgroups"
    before = fk.LAUNCHES[kernel]
    got = fk.backward_sm3(*args, stages=4, wgroups=wgroups, pgroups=pgroups)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[kernel] == before + 1
    assert_forward_close((F, offF), fk.forward_sm3_ref(*fargs))
    want = fk.backward_sm3_ref(*args, 4, wgroups, None, pgroups)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=1e-3)
    assert float(got[0].sum()) > 0.25 * float(b.d_last.sum())


def test_cuda_hdp_emissions_match_cpu(cuda_device, tmp_path):
    """readpath.hdp_emissions on the card against the CPU on the same
    inputs (rtol 1e-6: the same f32 operations)."""
    from cpecan_signal_tpu_torch.engine import readpath

    rng = np.random.default_rng(59)
    pore = _pore(tmp_path, rng)
    tab, g0, dg = _hdp_table(pore, cuda_device)
    B, Dp, W, Lc = 8, 600, 128, 602
    w0 = torch.from_numpy(np.cumsum(rng.choice([-1, 1], (B, Dp)), axis=1).astype(np.int32)
                          - 40)
    rank = torch.from_numpy(rng.integers(0, 4098, (B, Lc)).astype(np.int32))
    mean = torch.from_numpy(rng.uniform(20, 100, (B, Lc)).astype(np.float32))
    d_last = torch.from_numpy(rng.integers(300, Dp, B).astype(np.int32))
    got = readpath.hdp_emissions(tab, g0, dg, rank.to(cuda_device), mean.to(cuda_device),
                                 w0.to(cuda_device), d_last.to(cuda_device), W).cpu()
    want = readpath.hdp_emissions(tab.cpu(), g0, dg, rank, mean, w0, d_last, W)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert float(got[:, :, 1].max()) > 0.1


def _hdp_nhdp(pore, model_path):
    """A flat NanoporeHDP (grid (30, 120, 120), a short chain) on two points
    near each k-mer's level."""
    from cpecan_signal_tpu_torch.core.kmers import rank_to_kmer
    from cpecan_signal_tpu_torch.hdp.nanopore import build_nanopore_hdp

    rng = np.random.default_rng(5)
    nhdp = build_nanopore_hdp("flat", model_path, alphabet="ACGT", grid=(30.0, 120.0, 120),
                              seed=5)
    nhdp.set_assignments([rank_to_kmer(r) for r in range(4096)] * 2,
                         list(np.tile(pore.match_model[:4096, 0], 2)
                              + rng.normal(0, 0.6, 8192)))
    nhdp.gibbs(num_samples=20, burn_in=100, thinning=5)
    nhdp.finalize()
    return nhdp


def test_cuda_vanilla_and_hdp_esteps_match_cpu(cuda_device, tmp_path):
    """The vanilla and threeStateHdp E-steps on the card against the CPU
    plain path (tallies rtol 1e-4 + atol 1e-5, likelihood 1e-5 relative;
    the assignments of the HDP step 99 % shared: a cell within p's atol of
    the threshold may fall on either side), and two card runs equal bit for
    bit (no atomics)."""
    from collections import Counter

    from cpecan_signal_tpu_torch.em import hdp_em, vanilla_em

    rng = np.random.default_rng(61)
    pore = _pore(tmp_path, rng)
    cases = _cases(pore, rng, 8, 128)
    jobs = [sm3_em.EmJob(pore, t, e, band, bool(i % 2), i < 4)
            for i, (t, e, band, _wb) in enumerate(cases)]
    before = fk.LAUNCHES["backward_em"]
    runs = [vanilla_em.vanilla_em_step(
        vanilla_em.build_vanilla_em_buckets(jobs, "t", device=dev), pore.skip_bins)
        for dev in (cuda_device, cuda_device, torch.device("cpu"))]
    assert fk.LAUNCHES["backward_em"] > before
    (b1, l1), (b2, l2), (bw, lw) = runs
    np.testing.assert_array_equal(b1, b2)
    assert l1 == l2
    np.testing.assert_allclose(b1, bw, rtol=1e-4, atol=1e-5)
    assert abs(l1 - lw) <= 1e-5 * abs(lw) and b1.sum() > 1.0

    nhdp = _hdp_nhdp(pore, str(tmp_path / "synthetic.model"))
    before = fk.LAUNCHES["backward_pgroups"]
    runs = [hdp_em.hdp_em_step(hdp_em.build_hdp_em_buckets(jobs, device=dev), nhdp, None,
                               0.01)
            for dev in (cuda_device, cuda_device, torch.device("cpu"))]
    assert fk.LAUNCHES["backward_pgroups"] > before
    (t1, l1, k1, m1), again, (tw, lw, kw, mw) = runs
    assert (t1.tolist(), l1, k1, m1) == (again[0].tolist(), *again[1:])
    np.testing.assert_allclose(t1, tw, rtol=1e-4, atol=1e-5)
    assert abs(l1 - lw) <= 1e-5 * abs(lw)
    shared = sum((Counter(zip(k1, m1)) & Counter(zip(kw, mw))).values())
    assert len(k1) > 100 and shared >= 0.99 * max(len(k1), len(kw))


def test_cuda_hdp_slice_matches_cpu(cuda_device, tmp_path):
    """batch_align_jobs of threeStateHdp jobs (E built on the card from the
    density table, pairs compacted on the card) against the CPU plain
    path, ragged ends mixed."""
    from cpecan_signal_tpu_torch.models.state_machines import make_signal_sm3_hdp

    rng = np.random.default_rng(67)
    pore = _pore(tmp_path, rng)
    density = _hdp_nhdp(pore, str(tmp_path / "synthetic.model")).density_logp_fn()
    jobs = [SplitJob(make_signal_sm3_hdp(density, t, e), band, 0, 0, bool(i % 2), i < 4)
            for i, (t, e, band, _wb) in enumerate(_cases(pore, rng, 8, 64, expansion=6))]
    before = fk.LAUNCHES["backward"]
    got = batch_align_jobs(jobs, AlignmentParams().threshold, device=cuda_device)
    assert fk.LAUNCHES["backward"] > before
    want = batch_align_jobs(jobs, AlignmentParams().threshold, device=torch.device("cpu"))
    assert sum(len(g.probs) for g in got) > 100
    for g, w in zip(got, want):
        dg = {(x, y): q for q, x, y in g.as_tuples()}
        dw = {(x, y): q for q, x, y in w.as_tuples()}
        common = set(dg) & set(dw)
        assert len(common) >= max(len(dg), len(dw), 1) - 1
        assert all(abs(dg[k] - dw[k]) < 1.2e-3 * 1e7 for k in common)


@pytest.mark.parametrize("machine", ["threeState", "fiveState"])
def test_cuda_f64_oracle_matches_cpu(machine, cuda_device, tmp_path):
    """The f64 oracle (engine/fb.py) on the card against the same call on the
    CPU: F, B and totals within 1e-9 (log values), posteriors within 1e-9;
    and the threeState E-step's tallies within rtol 1e-9."""
    from cpecan_signal_tpu_torch.engine import expectations, fb
    from cpecan_signal_tpu_torch.models.state_machines import (bind_symbol_sequences,
                                                                make_symbol_sm5)

    rng = np.random.default_rng(8)
    if machine == "threeState":
        pore = _pore(tmp_path, rng)
        target, events, band, _wb = _cases(pore, rng, 1, 64)[0]
        sm = make_signal_sm3(pore, target, events)
    else:
        x = "".join(rng.choice(list("ACGT"), 300))
        y = "".join(c for c in x if rng.random() > 0.03)
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, x, y)
        band = band_construct(np.zeros((0, 2), dtype=np.int64), len(x), len(y), 20)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        plan, inp = fb.prepare_inputs(sm, band, ragged_left=True, ragged_right=True,
                                      device=dev)
        F, B = fb.forward(plan, inp), fb.backward(plan, inp)
        tot = fb.diagonal_totals(plan, inp, F, B)
        p, _ = fb.posterior_match_probs(plan, inp, F, B)
        tallies = (expectations.threestate_expectations(plan, inp, F, B)
                   if machine == "threeState" else
                   expectations.discrete_expectations(plan, inp, F, B))
        out[dev.type] = [t.cpu().numpy() for t in (F, B, tot, p, *tallies)]
    for g, w in zip(out["cuda"][:4], out["cpu"][:4]):
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-9)
    for g, w in zip(out["cuda"][4:], out["cpu"][4:]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-300)
