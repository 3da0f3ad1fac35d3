"""PyTorch port: the threeState EM slice on the CPU against the JAX package.

Inputs are tests/test_pallas_em.py's synthetic reads (numpy seed, 36-48
bases a strand, no anchors), packed into EM buckets by each package.

  * (a) the stage-4 backward's plain version against JAX backward_sm3
    (stages=4, interpret mode, kd=2) on the same E and F, at W = 64 and 128;
  * (b) the port's sm3_expectations against JAX sm3_pallas_expectations;
  * (c) two iterations of the port's sm3_em_step against the JAX device
    E-step and the host f64 sm3_expectations, all fed the same M-step
    parameters;
  * (d) a zero device budget (every bucket streamed) against a resident build;
  * (e) the port's train_models CLI against the JAX CLI's host engine on
    synthetic npReads, and a resume from a checkpoint.

Tolerances.  The plain versions and the JAX kernels do the same f32
operations, but XLA's CPU compiler contracts multiply-adds into FMAs inside
interpreted kernels (tests/test_torch_kernels.py), and the sums over lanes
run in another order: posteriors and their window tallies are held to atol
1e-4, totals to atol 1e-3 + rtol 1e-5, the stats lanes (sums of up to
hundreds of posteriors, and the likelihood, a sum of totals) to rtol 1e-5 +
atol 1e-3.  Whole E-steps, whose forward pass carries the FMA differences
down the diagonal chain, are held to rtol 1e-4 + atol 1e-4 and the
likelihood to 1e-5 relative; against the host f64 engine (exact logaddexp,
not the reference's cubic logAdd) to test_pallas_em.py's rtol 1e-3 + atol
1e-4.
"""

import os
import re

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.constants import NUM_OF_KMERS
from cpecan_signal_tpu.em import pallas_em as jem
from cpecan_signal_tpu.engine import pallas_pipeline as jpp
from cpecan_signal_tpu.models.params import AlignmentParams
from cpecan_signal_tpu.ops import pallas_fb as pk
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.em import sm3_em as tem
from cpecan_signal_tpu_torch.em.accumulators import ContinuousPairHmm
from cpecan_signal_tpu_torch.engine import pipeline as tpp
from cpecan_signal_tpu_torch.engine.plan import edge_table
from cpecan_signal_tpu_torch.ops import fb_kernels as fk
from test_pallas_em import _host_estep, _reads_and_model

CPU = torch.device("cpu")
KD = 2
P_ATOL = 1e-4
T_ATOL, T_RTOL = 1e-3, 1e-5
STEP_RTOL, STEP_ATOL, LIK_RTOL = 1e-4, 1e-4, 1e-5
HOST_RTOL, HOST_ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def em_set():
    reads, models = _reads_and_model(n_reads=2, n_bases=40, seed=11)
    return reads, models, AlignmentParams(diagonal_expansion=4)


@pytest.fixture(scope="module")
def jax_buckets(em_set):
    """The JAX package's EM buckets of strand t at both widths."""
    reads, models, params = em_set
    jobs = jem.collect_sm3_em_jobs(reads, models, params, "t")
    return {W: jem.build_sm3_em_buckets(jobs, width_multiple=W, interpret=True)
            for W in (64, 128)}


@pytest.mark.parametrize("W", [64, 128])
def test_backward_stage4_plain_matches_pallas(W, jax_buckets):
    """exits, gacc, stats, totals and p of the plain stage-4 backward equal
    the interpreted Pallas kernel's on the same E and F."""
    (jb,) = jax_buckets[W]
    assert jb.W == W
    b, plan = jb.batch, jb.plan
    Dp = b.diag_scalars.shape[1] - 1
    E = pk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp, interpret=True, kd=KD)
    Fpad = pk.forward_sm3(plan, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar,
                          kd=KD, interpret=True)
    p, tot, exits, gacc, stats = pk.backward_sm3(
        plan, E, Fpad, b.diag_scalars, b.d_last, b.end, b.tp_scalar, kd=KD,
        stages=4, interpret=True)
    tb = tem.bucket_from_jax(jb, CPU)
    edges = torch.from_numpy(edge_table(tb.plan))
    got = fk.backward_sm3(edges, tb.plan.match_state, torch.from_numpy(np.array(E[:, :Dp + 2])),
                          torch.from_numpy(np.array(Fpad[:, KD:])), tb.batch.diag_scalars,
                          tb.batch.d_last, tb.batch.end, tb.batch.tp_scalar, stages=4,
                          wgroups=tpp.sm3_wgroups(tb.plan))
    g_p, g_tot, g_exits, g_gacc, g_stats = (t.numpy() for t in got)
    assert g_exits.shape == (len(tb.ragged_left), Dp, 1) and g_gacc.shape[1:] == (1, W)
    np.testing.assert_allclose(g_p, np.array(p[:, :, 0]), atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(g_tot, np.array(tot[:, :, 0, 0]), atol=T_ATOL, rtol=T_RTOL)
    np.testing.assert_allclose(g_exits, np.array(exits[:, :, 0]), atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(g_gacc, np.array(gacc), atol=P_ATOL, rtol=0)
    np.testing.assert_allclose(g_stats, np.array(stats[:, 0]), atol=T_ATOL, rtol=T_RTOL)
    # the gapX window tally keeps its mass: what left as exits or stayed in
    # gacc is what the stats lanes of the edges into shortGapX hold
    (members,) = tpp.sm3_wgroups(tb.plan)
    np.testing.assert_allclose(g_exits.sum((1, 2)) + g_gacc.sum((1, 2)),
                               g_stats[:, list(members)].sum(1), rtol=1e-5)
    assert (g_stats[:, fk.LIK_LANE] < 0).all() and g_exits.sum() > 0.5


def test_sm3_expectations_matches_pallas(jax_buckets):
    """The port's batched E-step on a carried-over bucket equals JAX
    sm3_pallas_expectations (interpret mode) on the same bucket."""
    (jb,) = jax_buckets[128]
    j_trans, j_kmer, j_lik = jpp.sm3_pallas_expectations(jb.plan, jb.W, jb.batch,
                                                         interpret=True)
    tb = tem.bucket_from_jax(jb, CPU)
    trans, kmer, lik = tpp.sm3_expectations(tb.plan, tb.W, tb.batch)
    assert trans.shape == (3, 3) and kmer.shape == (NUM_OF_KMERS,)
    np.testing.assert_allclose(trans.numpy(), np.array(j_trans), rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    np.testing.assert_allclose(kmer.numpy(), np.array(j_kmer), rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    assert abs(float(lik) - float(j_lik)) <= LIK_RTOL * abs(float(j_lik))


@pytest.fixture(scope="module")
def two_iterations(em_set, jax_buckets):
    """Two E-steps of the port, the JAX device path and the host f64 engine
    on strand t; iteration 1 runs on the M-step of the host's iteration 0."""
    reads, models, params = em_set
    port_buckets = tem.build_sm3_em_buckets(
        tem.collect_sm3_em_jobs(reads, models, params, "t"), device=CPU)
    out, mstep = [], (None, None)
    for _it in range(2):
        port = tem.sm3_em_step(port_buckets, *mstep)
        jx = jem.sm3_em_step(jax_buckets[128], *mstep)
        host = _host_estep(reads, models, params, "t", *mstep)
        out.append((port, jx, host))
        acc = ContinuousPairHmm(transitions=host.transitions.copy(),
                                kmer_gap=host.kmer_gap.copy())
        acc.normalize()
        mstep = acc.to_sm3_params()
    return out


@pytest.mark.parametrize("it", [0, 1])
def test_sm3_em_step_matches_jax_and_host(it, two_iterations):
    (t, k, lik), (jt, jk, jl), host = two_iterations[it]
    assert k.shape == (NUM_OF_KMERS,) and k.sum() > 0.5
    np.testing.assert_allclose(t, jt, rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(k, jk, rtol=STEP_RTOL, atol=STEP_ATOL)
    assert abs(lik - jl) <= LIK_RTOL * abs(jl)
    np.testing.assert_allclose(t, host.transitions, rtol=HOST_RTOL, atol=HOST_ATOL)
    np.testing.assert_allclose(k, host.kmer_gap[:NUM_OF_KMERS], rtol=HOST_RTOL,
                               atol=HOST_ATOL)
    assert abs(lik - host.likelihood) < HOST_RTOL * abs(host.likelihood)


def test_em_budget_streaming_matches_resident():
    """A zero budget keeps every bucket on the host (streamed per step):
    the same bytes are accounted and the E-step results are identical."""
    reads, models = _reads_and_model(n_reads=3, n_bases=40, seed=23)
    jobs = tem.collect_sm3_em_jobs(reads, models, AlignmentParams(), "t")
    b_res = tem._EmBudget(CPU, budget=1e12)
    res = tem.build_sm3_em_buckets(jobs, device=CPU, budget=b_res)
    b_str = tem._EmBudget(CPU, budget=0)
    streamed = tem.build_sm3_em_buckets(jobs, device=CPU, budget=b_str)
    assert b_res.n_streamed == 0 and b_res.resident > 0
    assert b_str.n_streamed == len(streamed) and b_str.resident == 0
    assert b_str.streamed == b_res.resident
    assert not any(b.resident for b in streamed) and all(b.resident for b in res)
    assert "streamed per-iteration" in b_str.summary()
    for a, b in zip(tem.sm3_em_step(res), tem.sm3_em_step(streamed)):
        np.testing.assert_array_equal(a, b)


def _npread_set(tmp_path, n_reads=2, seed=4):
    rng = np.random.default_rng(seed)
    model = str(tmp_path / "synthetic.model")
    pore = syn.write_pore_model(model, rng)
    ref = str(tmp_path / "ref.fa")
    ref_seq = syn.write_reference(ref, 2500, rng)
    reads = str(tmp_path / "reads")
    syn.write_read_set(reads, ref_seq, pore, n_reads, rng, min_bases=90, max_bases=150)
    return model, ref, reads


def test_train_models_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """train_models over 2 iterations on 2 synthetic npReads: the port (the
    device E-step's plain versions on the CPU) against the JAX CLI's host
    f64 engine, likelihood history and both trained HMM files."""
    from cpecan_signal_tpu.cli import train_models as jtm
    from cpecan_signal_tpu_torch.cli import train_models as ttm

    model, ref, reads = _npread_set(tmp_path)
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    args = ["-r", ref, "-d", reads, "-T", model, "-C", model, "-i", "2"]
    hist = {}
    for name, mod, extra in (("port", ttm, []), ("jax", jtm, ["--engine", "host"])):
        out = tmp_path / name
        out.mkdir()
        capsys.readouterr()
        assert mod.main(args + ["-o", str(out)] + extra) == 0
        hist[name] = [float(v) for v in re.findall(r"iteration \d+: .*likelihood (-?[\d.]+)",
                                                   capsys.readouterr().out)]
    assert len(hist["port"]) == len(hist["jax"]) == 2
    np.testing.assert_allclose(hist["port"], hist["jax"], rtol=HOST_RTOL)
    for name in ("template", "complement"):
        got = ContinuousPairHmm.load(str(tmp_path / "port" / f"{name}_trained.hmm"))
        want = ContinuousPairHmm.load(str(tmp_path / "jax" / f"{name}_trained.hmm"))
        np.testing.assert_allclose(got.transitions, want.transitions, rtol=HOST_RTOL,
                                   atol=HOST_ATOL)
        np.testing.assert_allclose(got.kmer_gap, want.kmer_gap, rtol=HOST_RTOL,
                                   atol=HOST_ATOL)
        np.testing.assert_allclose(got.transitions.sum(1), 1.0, atol=1e-5)


def test_train_models_resumes_from_checkpoint(tmp_path):
    """Two iterations in one run and one iteration, then a resumed second,
    give the same likelihood history and trained HMM."""
    from cpecan_signal_tpu_torch.cli import train_models as ttm

    model, ref, reads = _npread_set(tmp_path, n_reads=1, seed=6)
    paths = [os.path.join(reads, f) for f in sorted(os.listdir(reads))]
    run = dict(device=CPU, log=lambda *a: None)
    whole = ttm.train(ref, paths, model, model, iterations=2,
                      out_dir=str(tmp_path), **run)
    ck = str(tmp_path / "ck")
    first = ttm.train(ref, paths, model, model, iterations=1, out_dir=str(tmp_path),
                      checkpoint_dir=ck, **run)
    resumed = ttm.train(ref, paths, model, model, iterations=2, out_dir=str(tmp_path),
                        checkpoint_dir=ck, **run)
    assert len(first["likelihoods"]) == 1 and len(resumed["estep_seconds"]) == 1
    assert resumed["likelihoods"] == whole["likelihoods"]
    for s in ("t", "c"):
        np.testing.assert_array_equal(resumed["accumulators"][s].kmer_gap,
                                      whole["accumulators"][s].kmer_gap)


@pytest.mark.parametrize("what, kwargs", [
    ("ROADMAP queue 1, 'Host engines'", dict(sm_type="threeStateHdp", template_hdp="t.nhdp",
                                             complement_hdp="c.nhdp")),
    ("ROADMAP queue 1, 'Host engines'", dict(engine="host")),
    ("ROADMAP queue 1, 'Host engines'", dict(jobs=2)),
])
def test_train_models_unported_options_raise(what, kwargs, tmp_path):
    from cpecan_signal_tpu_torch.cli import train_models as ttm

    with pytest.raises(NotImplementedError, match=what):
        ttm.train("ref.fa", [], "m", "m", device=CPU, **kwargs)


@pytest.mark.parametrize("flag", [["--templateHdp", "t.hdp"], ["--complementHdp", "c.hdp"],
                                  ["--assignmentThreshold", "0.5"], ["--samples", "5"],
                                  ["--burnIn", "5"], ["--thinning", "5"]])
def test_train_models_main_rejects_hdp_flags(flag):
    """An option that only threeStateHdp training reads raises instead of
    being ignored by the threeState run."""
    from cpecan_signal_tpu_torch.cli import train_models as ttm

    with pytest.raises(ValueError, match=f"{flag[0]}: only --threeStateHdp training"):
        ttm.main(["-r", "ref.fa", "-d", "reads", "-T", "m", "-C", "m", *flag])
