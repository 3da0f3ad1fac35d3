"""PyTorch port: threeStateHdp alignment and training on the CPU against the
JAX package.

  * batch_align_jobs on threeStateHdp jobs: those whose machine carries its
    density table build E on the device (readpath.hdp_emissions) and compact
    their pairs there; a --substitute job (alphabet_density_fn: ranks over
    the HDP's own alphabet) takes the generic buckets with host-built grids.
    Against the JAX batch_align_jobs (interpret mode): per job at most 1 pair
    missing or extra and 1.2e-3 posterior drift
    (tests/test_readpath_random.py).  The device compaction keeps every
    passing cell: its pairs are those of the full posterior grid
    thresholded on the host;
  * vanilla_align --threeStateHdp -v -w against the JAX CLI (whose CPU
    route is the f64 host engine) on one synthetic npRead: the rows of
    tests/test_torch_generic_cli.py's check;
  * train_models --threeStateHdp against the JAX CLI's host engine: one
    iteration (from the same HDP files) gives the same likelihood (f32
    against f64: rtol 2e-3), transitions and assignments; two iterations
    rebuild both HDPs (the Gibbs chain: tests/test_torch_hdp.py) and write
    them; a threshold of 0 raises, naming ROADMAP 'Host engines'.
"""

import os
import re

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.core.band import band_construct
from cpecan_signal_tpu.engine.align import SplitJob as JJob
from cpecan_signal_tpu.engine.batch_align import batch_align_jobs as jalign
from cpecan_signal_tpu.hdp import nanopore as jn
from cpecan_signal_tpu.models.params import AlignmentParams
from cpecan_signal_tpu.models.state_machines import make_signal_sm3_hdp
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.core.kmers import rank_to_kmer
from cpecan_signal_tpu_torch.em.accumulators import HdpHmm
from cpecan_signal_tpu_torch.engine import readpath
from cpecan_signal_tpu_torch.engine.align import SplitJob
from cpecan_signal_tpu_torch.engine.batch_align import batch_align_jobs
from test_hdp_pallas import _fixture_problem
from test_torch_generic_cli import _assert_rows_agree, _rows

CPU = torch.device("cpu")
PAIR_TOL, PROB_TOL = 1, 1.2e-3
HOST_RTOL = 2e-3
GIBBS = ["--samples", "20", "--burnIn", "100", "--thinning", "5"]


def _build(path, model, alphabet="ACGT", levels=None, seed=5):
    """A flat NanoporeHDP (grid (30, 120, 120), a short chain) on two points
    near each k-mer's level of ``model`` (or ``levels``), serialized."""
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model

    rng = np.random.default_rng(seed)
    if levels is None:
        levels = load_pore_model(model).match_model[:4096, 0]
    kmers = [rank_to_kmer(r) for r in range(4096)] * 2
    means = list(np.tile(levels, 2) + rng.normal(0, 0.6, 8192))
    if alphabet != "ACGT":   # the methylated C of --substitute, 2 pA higher
        kmers += [k.replace("C", "E") for k in kmers[:4096] if "C" in k]
        means += [m + 2.0 for k, m in zip(kmers[:4096], means[:4096]) if "C" in k]
    nhdp = jn.build_nanopore_hdp("flat", model, alphabet=alphabet, grid=(30.0, 120.0, 120),
                                 seed=seed)
    nhdp.set_assignments(kmers, means)
    nhdp.gibbs(num_samples=20, burn_in=100, thinning=5)
    nhdp.finalize()
    nhdp.serialize(path)
    return path


@pytest.fixture(scope="module")
def hdp_set(tmp_path_factory):
    """A synthetic pore model, its read set and HDPs built on its levels."""
    tmp = tmp_path_factory.mktemp("hdp_align")
    rng = np.random.default_rng(31)
    model = str(tmp / "synthetic.model")
    pore = syn.write_pore_model(model, rng)
    ref = str(tmp / "ref.fa")
    ref_seq = syn.write_reference(ref, 2500, rng)
    reads = str(tmp / "reads")
    syn.write_read_set(reads, ref_seq, pore, 2, rng, min_bases=90, max_bases=150)
    nhdp = _build(str(tmp / "acgt.nhdp"), model)
    return tmp, model, ref, reads, nhdp


def _agree(got, want):
    for g, w in zip(got, want):
        db = {(x, y): p for p, x, y in g.as_tuples()}
        ds = {(x, y): p for p, x, y in w.as_tuples()}
        common = set(db) & set(ds)
        assert len(common) >= max(len(db), len(ds), 1) - PAIR_TOL, (len(db), len(ds))
        assert all(abs(db[k] - ds[k]) <= PROB_TOL * 1e7 for k in common)


def _jobs(hdp_set):
    """(port jobs, JAX jobs): random problems on the device-table route, and
    one --substitute problem on the generic route."""
    tmp, model, _ref, _reads, path = hdp_set
    params = AlignmentParams(diagonal_expansion=6)
    rng = np.random.default_rng(12)
    acegt = _build(str(tmp / "acegt.nhdp"), model, alphabet="ACEGT")
    cases = []
    for ci in range(4):
        target, events, anchors = _fixture_problem(rng, None, int(rng.integers(30, 60)))
        cases.append((target, events, anchors, path, False))
    target, events, anchors = _fixture_problem(rng, None, 48)
    cases.append((target.replace("C", "E"), events, anchors, acegt, True))
    out = {"port": [], "jax": []}
    from cpecan_signal_tpu_torch.hdp.nanopore import deserialize_nhdp as tload
    for target, events, anchors, hdp_path, sub in cases:
        rl, rr = bool(rng.integers(2)), bool(rng.integers(2))
        band = band_construct(anchors, len(target) - 5, len(events), params.diagonal_expansion)
        for key, load, Job in (("port", tload, SplitJob), ("jax", jn.deserialize_nhdp, JJob)):
            nhdp = load(hdp_path)
            dens = nhdp.alphabet_density_fn() if sub else nhdp.density_logp_fn()
            sm = make_signal_sm3_hdp(dens, target, events)
            assert (getattr(sm, "hdp_pack", None) is None) == sub
            out[key].append(Job(sm, band, 0, 0, rl, rr))
    return out["port"], out["jax"], params


def test_hdp_batch_align_matches_jax(hdp_set, monkeypatch):
    port_jobs, jax_jobs, params = _jobs(hdp_set)
    want = jalign(jax_jobs, params.threshold, interpret=True)
    got = batch_align_jobs(port_jobs, params.threshold, device=CPU)
    assert sum(len(p.probs) for p in got) > 50
    _agree(got, want)
    # every passing cell gets its slot: the pairs are those of the full
    # posterior grids thresholded on the host
    from cpecan_signal_tpu_torch.engine import batch_align as tba
    from cpecan_signal_tpu_torch.engine.align import _extract_pairs
    from cpecan_signal_tpu_torch.engine.window import window_grids

    grids = []
    real_run = tba.pp.run_window

    def run(*a, **k):
        out = real_run(*a, **k)
        grids.append(out[0].numpy())
        return out

    monkeypatch.setattr(tba.pp, "run_window", run)
    for job, pairs in zip(port_jobs[:4], got):
        grids.clear()
        (alone,) = batch_align_jobs([job], params.threshold, device=CPU)
        wb = tba.job_window(job.band)
        x, y, _valid = window_grids(wb)
        want = _extract_pairs(grids[0][0, :wb.n_diagonals], x, y, params.threshold, 0, 0)
        for field, w in zip(("probs", "x", "y"), want):
            np.testing.assert_array_equal(getattr(alone, field), getattr(pairs, field))
            np.testing.assert_array_equal(np.sort(getattr(alone, field)), np.sort(w))


def test_vanilla_align_three_state_hdp_matches_jax(hdp_set, monkeypatch):
    from cpecan_signal_tpu.cli import vanilla_align as jva
    from cpecan_signal_tpu_torch.cli import vanilla_align as tva

    tmp, model, ref, reads, nhdp = hdp_set
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    npread = os.path.join(reads, "read001.npRead")
    out = {}
    for name, main in (("port", tva.main), ("jax", jva.main)):
        path = str(tmp / f"{name}_hdp.tsv")
        assert main(["-r", ref, "-q", npread, "-T", model, "-C", model, "-L", "r1",
                     "-u", path, "--threeStateHdp", "-v", nhdp, "-w", nhdp]) == 0
        out[name] = _rows(path)
    assert len(out["port"]) > 100
    _assert_rows_agree(out["port"], out["jax"], {("r1", "t"), ("r1", "c")})
    assert tva.main(["-r", ref, "-q", npread, "-T", model, "-C", model,
                     "--threeStateHdp", "-v", nhdp]) == 1


def test_train_models_three_state_hdp_matches_jax_cli(hdp_set, tmp_path, monkeypatch,
                                                      capsys):
    from cpecan_signal_tpu.cli import train_models as jtm
    from cpecan_signal_tpu_torch.cli import train_models as ttm

    _tmp, model, ref, reads, nhdp = hdp_set
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    base = ["-r", ref, "-d", reads, "-T", model, "-C", model, "--threeStateHdp",
            "-v", nhdp, "-w", nhdp, "--assignmentThreshold", "0.01", *GIBBS]
    liks = {}
    for name, mod, extra in (("port", ttm, []), ("jax", jtm, ["--engine", "host"])):
        out = tmp_path / name
        out.mkdir()
        capsys.readouterr()
        assert mod.main(base + ["-i", "1", "-o", str(out)] + extra) == 0
        liks[name] = [float(v) for v in re.findall(r"iteration \d+: .*likelihood (-?[\d.]+)",
                                                   capsys.readouterr().out)]
    np.testing.assert_allclose(liks["port"], liks["jax"], rtol=HOST_RTOL)
    for name in ("template", "complement"):
        got = HdpHmm.load(str(tmp_path / "port" / f"{name}_trained.hmm"))
        want = HdpHmm.load(str(tmp_path / "jax" / f"{name}_trained.hmm"))
        np.testing.assert_allclose(got.transitions, want.transitions, rtol=HOST_RTOL,
                                   atol=1e-4)
        assert got.n_assignments > 50
        assert abs(got.n_assignments - want.n_assignments) <= 0.01 * want.n_assignments
        assert os.path.exists(tmp_path / "port" / f"{name}_trained.nhdp")
    # two iterations: the second runs on the rebuilt HDPs
    out = tmp_path / "two"
    out.mkdir()
    capsys.readouterr()
    assert ttm.main(base + ["-i", "2", "-o", str(out)]) == 0
    log = capsys.readouterr().out
    two = [float(v) for v in re.findall(r"iteration \d+: .*likelihood (-?[\d.]+)", log)]
    assert len(two) == 2 and np.isfinite(two).all() and "HDP rebuild" in log
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, 'Host engines'"):
        ttm.main(base[:-8] + GIBBS + ["-i", "1", "-o", str(out)])


def test_train_models_three_state_hdp_resumes_from_checkpoint(hdp_set, tmp_path):
    """A checkpointed iteration keeps both rebuilt HDPs beside the npz; a
    resumed run starts from them (their density tables) and runs the
    remaining iteration."""
    from cpecan_signal_tpu_torch.cli import train_models as ttm
    from cpecan_signal_tpu_torch.hdp.nanopore import deserialize_nhdp

    _tmp, model, ref, reads, nhdp = hdp_set
    paths = [os.path.join(reads, f) for f in sorted(os.listdir(reads))]
    ck = str(tmp_path / "ck")
    run = dict(sm_type="threeStateHdp", template_hdp=nhdp, complement_hdp=nhdp,
               assignment_threshold=0.01, out_dir=str(tmp_path), checkpoint_dir=ck,
               gibbs=dict(num_samples=20, burn_in=100, thinning=5), device=CPU,
               log=lambda *a: None)
    first = ttm.train(ref, paths, model, model, iterations=1, **run)
    saved = {s: os.path.join(ck, f"{name}_000000.nhdp")
             for s, name in (("t", "template"), ("c", "complement"))}
    assert all(os.path.exists(p) for p in saved.values())
    np.testing.assert_array_equal(
        deserialize_nhdp(saved["t"]).density_table(),
        deserialize_nhdp(str(tmp_path / "template_trained.nhdp")).density_table())
    resumed = ttm.train(ref, paths, model, model, iterations=2, **run)
    assert len(first["likelihoods"]) == 1 and len(resumed["estep_seconds"]) == 1
    assert len(resumed["likelihoods"]) == 2 and resumed["likelihoods"][0] == \
        first["likelihoods"][0]
