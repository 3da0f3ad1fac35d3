"""PyTorch port: the threeStateHdp emission grid and E-step on the CPU against
the JAX package.

The NanoporeHDP is built like tests/test_hdp_pallas.py's ``small_nhdp``
(flat topology over ACGT, grid (30, 120, 120), a short chain on 300 random
assignments) from a synthetic pore model, serialized once, and read back by
each package, so that both hold the same density table (the Gibbs chain
itself is not reproducible: tests/test_torch_hdp.py).  The problems are
tests/test_hdp_pallas.py's random targets and events.

  * (a) readpath.hdp_emissions against the E the JAX E-step builds in jnp
    (captured where it enters the JAX kernels), rtol 1e-6, and against the
    host density function (f64), rtol 1e-5;
  * (b) the port's hdp_em_step (the plain kernels on the CPU) against the
    JAX hdp_em_step (interpret mode) and the host f64 engine
    (em/expectation_driver.hdp_expectations), at the default and at trained
    transitions: tallies rtol 1e-4 + atol 1e-5 and the likelihood 1e-5
    relative against JAX; the same assignments in the same order; against
    the f64 engine tests/test_hdp_pallas.py's tolerances;
  * (c) a run whose assignment buffers overflow (max_assignments = 1) is
    re-run job by job on the device and equals an ample-K run bit for bit;
  * (d) at a threshold of 0 the device buckets raise, naming the f64
    oracle's route, whose E-step there equals the JAX host engine's.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.em import pallas_em as jem
from cpecan_signal_tpu.em.expectation_driver import _split_loop, hdp_expectations
from cpecan_signal_tpu.engine import pallas_pipeline as jpp
from cpecan_signal_tpu.hdp.nanopore import build_nanopore_hdp
from cpecan_signal_tpu.hdp.nanopore import deserialize_nhdp as jload
from cpecan_signal_tpu.models.params import AlignmentParams
from cpecan_signal_tpu.models.state_machines import make_signal_sm3_hdp
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.core.window import smooth_band
from cpecan_signal_tpu_torch.em import hdp_em as tem
from cpecan_signal_tpu_torch.em.sm3_em import EmJob as TJob
from cpecan_signal_tpu_torch.engine import readpath
from cpecan_signal_tpu_torch.engine.window import window_grids
from cpecan_signal_tpu_torch.hdp.nanopore import deserialize_nhdp as tload
from test_hdp_pallas import _fixture_problem

CPU = torch.device("cpu")
THRESHOLD = 0.01
E_RTOL = 1e-6
STEP_RTOL, STEP_ATOL, LIK_RTOL = 1e-4, 1e-5, 1e-5


def _small_nhdp_file(tmp_path_factory) -> str:
    """tests/test_hdp_pallas.py's small_nhdp on a synthetic pore model,
    serialized."""
    d = tmp_path_factory.mktemp("nhdp")
    rng = np.random.default_rng(9)
    model = str(d / "synthetic.model")
    syn.write_pore_model(model, np.random.default_rng(1))
    nhdp = build_nanopore_hdp("flat", model, alphabet="ACGT",
                              grid=(30.0, 120.0, 120), seed=5)
    kmers = ["".join(rng.choice(list("ACGT"), 6)) for _ in range(300)]
    nhdp.set_assignments(kmers, list(rng.uniform(45.0, 95.0, 300)))
    nhdp.gibbs(num_samples=40, burn_in=400, thinning=10)
    nhdp.finalize()
    path = str(d / "small.nhdp")
    nhdp.serialize(path)
    return path


@pytest.fixture(scope="module")
def nhdps(tmp_path_factory):
    """(JAX NanoporeHDP, port NanoporeHDP) read from one file."""
    path = _small_nhdp_file(tmp_path_factory)
    return jload(path), tload(path)


def _jobs(seed, sizes, params):
    """Split jobs of random problems, as (JAX EmJobs, port EmJobs, cases)."""
    rng = np.random.default_rng(seed)
    cases = [_fixture_problem(rng, None, n) for n in sizes]
    jj, tj = [], []
    for target, events, anchors in cases:
        for (x1, y1, x2, y2), band, rl, rr in _split_loop(
                len(target) - 5, len(events), anchors, params, True, True):
            args = (None, target[x1:x2 + 5], events[y1:y2], band, rl, rr)
            jj.append(jem.EmJob(*args))
            tj.append(TJob(*args))
    return jj, tj, cases


def test_hdp_emissions_match_jax_and_host(nhdps, monkeypatch):
    """The emission grid built on the device equals the JAX E-step's (rtol
    1e-6) at every cell, and its match channel is the host density function
    at the cells of the band."""
    jn, tn = nhdps
    params = AlignmentParams()
    jj, tj, _cases = _jobs(2, (42, 54), params)
    seen = []
    real_run = jpp.run_window_pallas

    def capture(plan, W, batch, *a, **k):
        seen.append(np.array(batch.E))
        return real_run(plan, W, batch, *a, **k)

    monkeypatch.setattr(jpp, "run_window_pallas", capture)
    (jb,) = jem.build_hdp_em_buckets(jj, interpret=True, threshold=THRESHOLD)
    jem.hdp_em_step([jb], jn, None, THRESHOLD)
    (tb,) = tem.build_hdp_em_buckets(tj, device=CPU, threshold=THRESHOLD)
    table = tn.density_table()
    grid = tn.hdp.grid
    tab = torch.from_numpy(np.maximum(table[tb.uniq], 0.0).astype(np.float32))
    E = readpath.hdp_emissions(tab, grid[0], grid[1] - grid[0], tb.batch.rank,
                               tb.batch.meanp, tb.batch.diag_scalars[:, :tb.Dp, 0, 4],
                               tb.batch.d_last, tb.W).numpy()
    (want,) = seen
    Dp = tb.Dp
    assert E.shape == (len(tj), Dp + 2, 3, tb.W)
    np.testing.assert_allclose(E[:, :Dp], want[:, :Dp], rtol=E_RTOL, atol=0)
    assert not E[:, Dp:].any() and (E[:, :, 1] > 0).any()
    # the match channel at the band's cells is the f64 host density
    density = tn.density_logp_fn()
    for bi, j in enumerate(tj):
        wb = smooth_band(j.band, width_multiple=128)
        x, y, valid = window_grids(wb)
        r = tb.rank_orig[bi][x[valid]]
        mu = tb.meanp[bi][y[valid]]
        np.testing.assert_allclose(E[bi, :wb.n_diagonals, 1][valid],
                                   density(r, mu.astype(np.float64)), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def two_steps(nhdps):
    """hdp_em_step of the port, the JAX device path and the host f64 engine
    at the default transitions and at the host's trained ones."""
    jn, tn = nhdps
    params = AlignmentParams()
    jj, tj, cases = _jobs(2, (42, 54, 46), params)
    jb = jem.build_hdp_em_buckets(jj, interpret=True, threshold=THRESHOLD)
    tb = tem.build_hdp_em_buckets(tj, device=CPU, threshold=THRESHOLD)
    density = jn.density_logp_fn()
    out, trans = [], None
    for _it in range(2):
        port = tem.hdp_em_step(tb, tn, trans, THRESHOLD)
        jx = jem.hdp_em_step(jb, jn, trans, THRESHOLD)
        host = None
        for target, events, anchors in cases:
            acc = hdp_expectations(
                lambda t, e, _d=density, _s=trans: make_signal_sm3_hdp(_d, t, e, _s),
                target, events, anchors, params, THRESHOLD)
            if host is None:
                host = acc
            else:
                host.add(acc)
        out.append((port, jx, (host.transitions.copy(), host.likelihood,
                               list(host.kmer_assignments),
                               list(host.event_assignments))))
        host.normalize()
        trans = host.to_sm3_params()
    return out


@pytest.mark.parametrize("it", [0, 1])
def test_hdp_em_step_matches_jax_and_host(it, two_steps):
    (t, lik, kmers, means), (jt, jl, jk, jm), (ht, hl, hk, hm) = two_steps[it]
    assert t.shape == (3, 3) and t.sum() > 1.0 and len(kmers) > 20
    np.testing.assert_allclose(t, jt, rtol=STEP_RTOL, atol=STEP_ATOL)
    assert abs(lik - jl) <= LIK_RTOL * abs(jl)
    assert kmers == jk
    np.testing.assert_array_equal(np.asarray(means), np.asarray(jm))
    # the f64 engine (exact logaddexp where the kernels take the reference's
    # cubic logAdd): tests/test_hdp_pallas.py's tolerances at the default
    # and at trained transitions; at trained transitions the likelihood of
    # the JAX device E-step lies 0.57 % from the f64 engine's on these
    # problems too, so it is held to 1e-2 there
    rtol, atol, lik_rtol = ((1e-3, 1e-5, 1e-3), (5e-3, 1e-3, 1e-2))[it]
    np.testing.assert_allclose(t, ht, rtol=rtol, atol=atol)
    assert abs(lik - hl) < lik_rtol * max(abs(hl), 1)
    cd = Counter(zip(kmers, np.round(means, 2)))
    ch = Counter(zip(hk, np.round(hm, 2)))
    assert sum((cd & ch).values()) >= 0.99 * max(len(kmers), len(hk))


def test_hdp_overflow_reruns_on_the_device(nhdps):
    """With one assignment slot every job overflows; each is run again alone
    with a slot per window cell, and the step equals an ample-K run bit for
    bit (tallies, likelihood, assignments in order)."""
    _jn, tn = nhdps
    params = AlignmentParams()
    _jj, tj, _cases = _jobs(5, (42, 50), params)
    ample = tem.hdp_em_step(tem.build_hdp_em_buckets(tj, device=CPU, threshold=THRESHOLD),
                            tn, None, THRESHOLD)
    tight = tem.hdp_em_step(tem.build_hdp_em_buckets(tj, device=CPU, threshold=THRESHOLD,
                                                     max_assignments=1),
                            tn, None, THRESHOLD)
    assert len(ample[2]) > len(tj)
    np.testing.assert_array_equal(tight[0], ample[0])
    assert tight[1] == ample[1] and tight[2] == ample[2] and tight[3] == ample[3]


def test_hdp_threshold_zero_raises(nhdps):
    """A threshold of 0 is not for the device buckets (every cell would
    pass): they raise, naming the route that takes it, the f64 oracle's
    E-step; there (em/expectation_driver.hdp_expectations) it gives the JAX
    host engine's transitions (rtol 1e-9) and assignments, every cell's in
    JAX's order."""
    from cpecan_signal_tpu_torch.em.expectation_driver import hdp_expectations as thdp
    from cpecan_signal_tpu_torch.models.params import AlignmentParams as TParams
    from cpecan_signal_tpu_torch.models.state_machines import make_signal_sm3_hdp as tmake

    jn, tn = nhdps
    params = AlignmentParams()
    _jj, tj, cases = _jobs(5, (42,), params)
    with pytest.raises(ValueError, match="--engine host"):
        tem.build_hdp_em_buckets(tj, device=CPU, threshold=0.0)
    (target, events, anchors), = cases
    got = thdp(lambda t, e: tmake(tn.density_logp_fn(), t, e), target, events, anchors,
               TParams(), 0.0, device=CPU)
    want = hdp_expectations(lambda t, e: make_signal_sm3_hdp(jn.density_logp_fn(), t, e),
                            target, events, anchors, params, 0.0)
    np.testing.assert_allclose(got.transitions, want.transitions, rtol=1e-9)
    assert got.likelihood == pytest.approx(want.likelihood, rel=1e-9)
    assert got.kmer_assignments == want.kmer_assignments
    assert got.event_assignments == want.event_assignments
    assert got.n_assignments == 3 * sum(j.band.n_diagonals * j.band.max_width for j in tj)
