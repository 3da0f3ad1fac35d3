"""PyTorch port: the vanilla (skip-bin) E-step and its training CLI on the CPU
against the JAX package.

Inputs are tests/test_pallas_em.py's vanilla problems (numpy seed, random
pore model and skip bins, 40-70 base targets, no anchors), packed into EM
buckets by each package, and synthetic npReads for the CLI.

  * (a) two iterations of the port's vanilla_em_step (the plain kernels on
    the CPU) against the JAX device E-step (interpret mode) and the host
    f64 engine (em/expectation_driver.vanilla_expectations), all fed the
    same bins: against JAX the tallies to rtol 1e-4 + atol 1e-5 and the
    likelihood to 1e-5 relative, against the f64 engine (exact logaddexp
    where the kernels take the reference's cubic logAdd)
    tests/test_pallas_em.py's rtol 2e-3 + atol 1e-4;
  * (b) one bucket per job against one bucket for all: the tallies and the
    likelihood are the same bit for bit (per-bin masked sums in a fixed
    order, no atomics, rows summed in job order);
  * (c) train_models --vanilla over 2 iterations against the JAX CLI's host
    engine: the likelihood history and both trained HMM files;
  * (d) a resume from a checkpoint gives the uninterrupted run's history
    and bins bit for bit.
"""

import os
import re

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.constants import MODEL_PARAMS, NUM_OF_KMERS
from cpecan_signal_tpu.core.band import band_construct
from cpecan_signal_tpu.core.kmers import sequence_kmer_ranks
from cpecan_signal_tpu.em import pallas_em as jem
from cpecan_signal_tpu.em.expectation_driver import vanilla_expectations
from cpecan_signal_tpu.models.params import AlignmentParams
from cpecan_signal_tpu.models.pore_model import PoreModel as JPore
from cpecan_signal_tpu.models.state_machines import make_signal_vanilla
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.em import vanilla_em as tem
from cpecan_signal_tpu_torch.em.accumulators import VanillaHmm
from cpecan_signal_tpu_torch.em.sm3_em import EmJob as TJob
from cpecan_signal_tpu_torch.models.pore_model import PoreModel as TPore

CPU = torch.device("cpu")
STEP_RTOL, STEP_ATOL, LIK_RTOL = 1e-4, 1e-5, 1e-5
HOST_RTOL, HOST_ATOL = 2e-3, 1e-4


@pytest.fixture(scope="module")
def vanilla_set():
    """(JAX jobs, port jobs, per-job (target, events), the JAX pore model,
    starting bins): test_pallas_em.py's vanilla problems, of three lengths
    so that the buckets of (b) differ in depth."""
    rng = np.random.default_rng(7)
    match = np.zeros((NUM_OF_KMERS + 2, MODEL_PARAMS))
    match[:NUM_OF_KMERS, 0] = rng.uniform(40, 90, NUM_OF_KMERS)
    match[:NUM_OF_KMERS, 1] = 1.0
    match[:NUM_OF_KMERS, 2] = rng.uniform(1, 3, NUM_OF_KMERS)
    match[:NUM_OF_KMERS, 3] = 0.3
    match[:NUM_OF_KMERS, 4] = 5.0
    skip = np.concatenate([rng.uniform(0.05, 0.3, 30), rng.uniform(0.2, 0.5, 30)])
    jpore = JPore(0.9, match, 0.9, match.copy(), skip.copy())
    tpore = TPore(0.9, match.copy(), 0.9, match.copy(), skip.copy())
    jj, tj, cases = [], [], []
    for n in (40, 56, 70, 56):
        target = "".join(rng.choice(list("ACGT"), n))
        ranks = sequence_kmer_ranks(target)
        n_ev = len(ranks) - int(rng.integers(0, 4))
        events = np.stack([match[ranks[:n_ev], 0] + rng.normal(0, 0.7, n_ev),
                           np.full(n_ev, 2.0), np.full(n_ev, 0.01)], axis=1)
        band = band_construct([], len(ranks), n_ev, 4)
        rl, rr = bool(n % 3), n != 70
        jj.append(jem.EmJob(jpore, target, events, band, rl, rr))
        tj.append(TJob(tpore, target, events, band, rl, rr))
        cases.append((target, events, rl, rr))
    return jj, tj, cases, jpore, skip


@pytest.fixture(scope="module")
def two_iterations(vanilla_set):
    """Two E-steps of the port, the JAX device path and the host f64 engine;
    iteration 1 runs on the host's normalized bins of iteration 0."""
    jj, tj, cases, jpore, skip = vanilla_set
    params = AlignmentParams()
    jb = jem.build_vanilla_em_buckets(jj, "t", interpret=True)
    tb = tem.build_vanilla_em_buckets(tj, "t", device=CPU)
    out, bins = [], skip
    for _it in range(2):
        host = VanillaHmm.empty()
        for target, events, rl, rr in cases:
            acc = vanilla_expectations(
                lambda t, e, _b=bins: make_signal_vanilla(jpore, t, e, "template", _b),
                target, events, np.zeros((0, 2)), params, ragged_left=rl,
                ragged_right=rr)
            host.bins += acc.bins
            host.likelihood += acc.likelihood
        out.append((tem.vanilla_em_step(tb, bins), jem.vanilla_em_step(jb, bins),
                    (host.bins.copy(), host.likelihood)))
        host.normalize()
        bins = host.bins
    return out


@pytest.mark.parametrize("it", [0, 1])
def test_vanilla_em_step_matches_jax_and_host(it, two_iterations):
    (b, lik), (jb, jl), (hb, hl) = two_iterations[it]
    assert b.shape == (60,) and b.sum() > 1.0
    np.testing.assert_allclose(b, jb, rtol=STEP_RTOL, atol=STEP_ATOL)
    assert abs(lik - jl) <= LIK_RTOL * abs(jl)
    np.testing.assert_allclose(b, hb, rtol=HOST_RTOL, atol=HOST_ATOL)
    assert abs(lik - hl) < HOST_RTOL * abs(hl)


def test_vanilla_em_bucketing_bit_identical(vanilla_set, monkeypatch):
    """A bucket per job (each padded to its own depth) and one bucket for
    all give the same tallies and likelihood bit for bit."""
    _jj, tj, _cases, _jpore, skip = vanilla_set
    whole = tem.build_vanilla_em_buckets(tj, "t", device=CPU)
    monkeypatch.setattr(tem, "MAX_BUCKET", 1)
    apart = tem.build_vanilla_em_buckets(tj, "t", device=CPU)
    assert len(whole) == 1 and len(apart) == len(tj)
    assert len({b.batch.diag_scalars.shape[1] for b in apart}) > 1
    b1, l1 = tem.vanilla_em_step(whole, skip)
    b2, l2 = tem.vanilla_em_step(apart, skip)
    np.testing.assert_array_equal(b1, b2)
    assert l1 == l2


def _npread_set(tmp_path, n_reads=2, seed=4):
    rng = np.random.default_rng(seed)
    model = str(tmp_path / "synthetic.model")
    pore = syn.write_pore_model(model, rng)
    ref = str(tmp_path / "ref.fa")
    ref_seq = syn.write_reference(ref, 2500, rng)
    reads = str(tmp_path / "reads")
    syn.write_read_set(reads, ref_seq, pore, n_reads, rng, min_bases=90, max_bases=150)
    return model, ref, reads


def test_train_models_vanilla_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """train_models --vanilla over 2 iterations on 2 synthetic npReads: the
    port (the plain kernels on the CPU) against the JAX CLI's host f64
    engine, the likelihood history and both trained skip-bin files."""
    from cpecan_signal_tpu.cli import train_models as jtm
    from cpecan_signal_tpu_torch.cli import train_models as ttm

    model, ref, reads = _npread_set(tmp_path)
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    args = ["-r", ref, "-d", reads, "-T", model, "-C", model, "-i", "2", "--vanilla"]
    hist = {}
    for name, mod, extra in (("port", ttm, []), ("jax", jtm, ["--engine", "host"])):
        out = tmp_path / name
        out.mkdir()
        capsys.readouterr()
        assert mod.main(args + ["-o", str(out)] + extra) == 0
        hist[name] = [float(v) for v in re.findall(r"iteration \d+: .*likelihood (-?[\d.]+)",
                                                   capsys.readouterr().out)]
    assert len(hist["port"]) == len(hist["jax"]) == 2, hist
    np.testing.assert_allclose(hist["port"], hist["jax"], rtol=HOST_RTOL)
    for name in ("template", "complement"):
        got = VanillaHmm.load(str(tmp_path / "port" / f"{name}_trained.hmm"))
        want = VanillaHmm.load(str(tmp_path / "jax" / f"{name}_trained.hmm"))
        np.testing.assert_allclose(got.bins, want.bins, rtol=HOST_RTOL, atol=HOST_ATOL)
        np.testing.assert_allclose(got.bins.sum(), 1.0, atol=6e-5)   # printed with %f


def test_train_models_vanilla_resumes_from_checkpoint(tmp_path):
    from cpecan_signal_tpu_torch.cli import train_models as ttm

    model, ref, reads = _npread_set(tmp_path, n_reads=1, seed=6)
    paths = [os.path.join(reads, f) for f in sorted(os.listdir(reads))]
    run = dict(device=CPU, log=lambda *a: None, sm_type="vanilla")
    whole = ttm.train(ref, paths, model, model, iterations=2, out_dir=str(tmp_path), **run)
    ck = str(tmp_path / "ck")
    ttm.train(ref, paths, model, model, iterations=1, out_dir=str(tmp_path),
              checkpoint_dir=ck, **run)
    resumed = ttm.train(ref, paths, model, model, iterations=2, out_dir=str(tmp_path),
                        checkpoint_dir=ck, **run)
    assert len(resumed["estep_seconds"]) == 1
    assert resumed["likelihoods"] == whole["likelihoods"]
    for s in ("t", "c"):
        np.testing.assert_array_equal(resumed["accumulators"][s].bins,
                                      whole["accumulators"][s].bins)
