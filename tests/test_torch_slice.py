"""PyTorch port: the whole threeState slice on the CPU.

  * the fast lane's staged bucket arrays, model scaling and Gauss pack,
    per-diagonal rows and pair extraction against the JAX fast lane's
    decode of its flat transport of the same jobs and its functions;
  * batch_align_jobs against the JAX fast lane (interpret mode) and the f64
    oracle align_events_to_target, on fresh seeds of
    tests/test_readpath_random._threestate_cases, at its tolerances: <= 1
    pair per job and 1.2e-3 posterior drift (f32 with the reference's cubic
    logAdd against exact f64 logaddexp; see that module's docstring);
  * the overflow re-route through the full-grid path;
  * the signal_align CLI on synthetic npReads, against the JAX CLI, and the
    attribution of pairs when one read fails half way.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_signal_tpu.engine import batch_align as jba
from cpecan_signal_tpu.engine import readpath as jrp
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.cli import signal_align as sa
from cpecan_signal_tpu_torch.engine import batch_align as tba
from cpecan_signal_tpu_torch.engine import pipeline as tpp
from cpecan_signal_tpu_torch.engine import readpath as trp
from cpecan_signal_tpu_torch.engine.align import SplitJob
from test_readpath_random import _pairs_match, _threestate_cases
from test_torch_generic_cli import assert_columns_agree
from test_torch_staging import jax_flat_staging

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cases():
    params, jobs, wants = _threestate_cases(211, 7)
    port_jobs = [SplitJob(j.sm, j.band, j.off_x, j.off_y, j.ragged_left,
                          j.ragged_right) for j in jobs]
    return params, jobs, port_jobs, wants


@pytest.fixture(scope="module")
def port_run(cases):
    """The port's lane on the cases, with every bucket's staging (its jobs,
    their base slots and the staged host arrays) and run (its tables and
    device arrays) recorded."""
    params, _jobs, port_jobs, _wants = cases
    staged, ran = [], []
    stage, run_bucket = trp._stage_fast_bucket, trp._run_bucket

    def stage_spy(jobs, slots, *args):
        staged.append((jobs, slots, stage(jobs, slots, *args)))
        return staged[-1][2]

    def run_spy(*args):
        ran.append(args)
        return run_bucket(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trp, "_stage_fast_bucket", stage_spy)
        mp.setattr(trp, "_run_bucket", run_spy)
        got = tba.batch_align_jobs(port_jobs, params.threshold, device=CPU)
    return got, staged, ran


def test_slice_matches_jax_fast_lane_and_oracle(cases, port_run):
    params, jobs, _port_jobs, wants = cases
    got, _staged, _ran = port_run
    jax_got = jba.batch_align_jobs(jobs, params.threshold, interpret=True)
    assert len(got) == len(wants) == 7
    for g, j, w in zip(got, jax_got, wants):
        _pairs_match(g, w)
        _pairs_match(g, j)


def test_overflow_reroute_matches(cases, monkeypatch):
    """A job whose pairs overflow the compact extraction (here: any passing
    lane, with no slots per diagonal) comes back through the full-grid path
    with the same pairs."""
    params, _jobs, port_jobs, wants = cases
    calls = []
    full_grid = tba._run_full_grid
    monkeypatch.setattr(tba, "_run_full_grid",
                        lambda *a: calls.append(len(a[2])) or full_grid(*a))
    monkeypatch.setattr(trp, "_EXTRACT_L", 0)
    got = tba.batch_align_jobs(port_jobs, params.threshold, device=CPU)
    assert calls and sum(calls) == len(port_jobs)
    for g, w in zip(got, wants):
        _pairs_match(g, w)


def test_device_packing_matches_jax(port_run):
    """Every bucket's staged arrays equal the JAX fast lane's decode of its
    flat transport of the same jobs (``_unpack_dev``): ranks, event rows,
    lengths, base slots, scales and rows exactly, the window rows on each
    job's diagonals (past them both step w0 alike and keep the range empty).
    On the device: the per-diagonal rows and the extraction equal the JAX
    functions' exactly, the f32 model scaling + Gauss pack to 1 ulp of
    log(sd) (torch's and XLA's f32 log may round differently, 6e-8 absolute
    at |log(sd)| < 1, seen after the cancellation in logc = -0.919 -
    log(sd))."""
    _got, staged, ran = port_run
    assert staged and len(staged) == len(ran)
    for (jobs, slots, host), (_plan, W, Kg, thr, mt, yt, gapx, b) in zip(staged, ran):
        Dp, lXp, lYp = host.win.shape[2], host.xrank.shape[1], host.evr.shape[2]
        want = dict(zip(("xrank", "win", "lY", "d_last", "bidx", "evr", "scale8",
                         "tp_scalar", "start", "end", "real"),
                        (np.asarray(a) for a in jrp._unpack_dev(
                            *(jnp.asarray(a) for a in jax_flat_staging(jobs, slots)),
                            W=W, Dp=Dp, lXp=lXp, lYp=lYp, n_tp=len(jobs[0].tp_scalar),
                            S=len(jobs[0].start)))))
        assert want.pop("real").all()
        win = want.pop("win")
        for name, a in want.items():
            np.testing.assert_array_equal(getattr(host, name), a, err_msg=name)
        for bi, fj in enumerate(jobs):
            D = fj.wband.n_diagonals
            np.testing.assert_array_equal(host.win[bi, :, :D], win[bi, :, :D])
            np.testing.assert_array_equal(host.win[bi, ::2, D:], win[bi, ::2, D:])
            assert (host.win[bi, 1, D:] > host.win[bi, 2, D:]).all()
        xa = trp._pack_xarr(mt, yt, gapx, b.bidx, b.xrank, b.scale8).numpy()
        ja = np.asarray(jrp._pack_xarr(*(jnp.asarray(a.numpy()) for a in
                                         (mt, yt, gapx, b.bidx, b.xrank, b.scale8))))
        np.testing.assert_allclose(xa, ja, rtol=2e-7, atol=1.2e-7)
        for a, ref in zip(tpp.band_scalars(b.win, b.lY, W, lXp, lYp),
                          jrp._pack_ds(jnp.asarray(b.win.numpy()), jnp.asarray(b.lY.numpy()),
                                       W, lXp, lYp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ref))
        # extraction on a synthetic posterior grid with crowded diagonals
        rng = np.random.default_rng(Dp + W)
        p = (rng.random((len(jobs), Dp, W)) ** 8).astype(np.float32)
        for a, ref in zip(trp.extract_global(torch.from_numpy(p), thr, Kg),
                          jrp._extract_global(jnp.asarray(p), thr, Kg,
                                              jnp.ones(len(jobs), dtype=bool))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ref))


def test_run_fast_jobs_and_pad_window(cases, port_run):
    """batch_align_jobs (stage + dispatch + one collection) gives the pairs
    of the recorded run and fills its timing keys; every staged job's window
    rows are the host rule pad_window's at its bucket's Dp."""
    params, _jobs, port_jobs, _wants = cases
    got, staged, _ran = port_run
    timing = {}
    again = tba.batch_align_jobs(port_jobs, params.threshold, device=CPU, timing=timing)
    assert set(timing) == {"host_pack", "device_wait", "host_extract"}
    for a, b in zip(again, got):
        for field in ("probs", "x", "y"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert sum(len(jobs) for jobs, _s, _h in staged) == len(port_jobs)
    for jobs, _slots, host in staged:
        for bi, fj in enumerate(jobs):
            np.testing.assert_array_equal(host.win[bi],
                                          tpp.pad_window(fj.wband, host.win.shape[2]))


def test_unported_machines_raise():
    """Every machine of the JAX package's batch path has a lane in the port:
    threeStateHdp jobs, which raised until the hdp package was ported, align
    on their device-built emissions against the JAX package's pairs, and
    fiveState jobs, which raised until the symbol lane was ported, align."""
    from cpecan_signal_tpu.engine.batch_align import batch_align_jobs as jalign
    from cpecan_signal_tpu.models.state_machines import (bind_symbol_sequences,
                                                         make_signal_sm3_hdp,
                                                         make_symbol_sm5)
    from cpecan_signal_tpu.core.band import band_construct

    def density(ranks, means):
        return np.clip(1.0 - np.abs(means - 0.5), 0.0, None) + 0.0 * ranks

    rng = np.random.default_rng(3)
    grid = np.linspace(0.0, 1.0, 40)
    density.density_table = (np.tile(density(0, grid), (4098, 1)).astype(np.float32),
                             0.0, float(grid[1] - grid[0]))
    events = np.column_stack([rng.uniform(0.0, 1.0, 8), np.full(8, 2.0), np.full(8, 0.01)])
    hdp = make_signal_sm3_hdp(density, "ACGTACGTACGTAC", events)
    assert hdp.hdp_pack is not None
    job = SplitJob(hdp, band_construct([], 9, 8, 4), 0, 0, True, True)
    (pairs,) = tba.batch_align_jobs([job], 0.01, device=CPU)
    (want,) = jalign([job], 0.01, interpret=True)
    assert len(pairs.probs) == len(want.probs) > 0
    np.testing.assert_allclose(pairs.probs, want.probs, atol=1.2e-3 * 1e7)
    sm = make_symbol_sm5()
    bind_symbol_sequences(sm, "ACGTACGTAC", "ACGTTCGTAC")
    job = SplitJob(sm, band_construct([], 10, 10, 4), 0, 0, True, True)
    (pairs,) = tba.batch_align_jobs([job], 0.01, device=CPU)
    assert len(pairs.probs) >= 8


def _read_set(tmp_path, n_reads, seed=5):
    rng = np.random.default_rng(seed)
    model = str(tmp_path / "synthetic.model")
    pore = syn.write_pore_model(model, rng)
    ref = str(tmp_path / "ref.fa")
    ref_seq = syn.write_reference(ref, 2500, rng)
    reads = str(tmp_path / "reads")
    syn.write_read_set(reads, ref_seq, pore, n_reads, rng, min_bases=90, max_bases=150)
    return model, ref, reads


def _tsv(out_dir):
    with open(os.path.join(out_dir, "posteriors.tsv")) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def test_signal_align_cli_matches_jax_cli(tmp_path, monkeypatch):
    """The port's signal_align -s on 2 synthetic npReads writes TSV rows for
    both reads and strands; the rows agree with the JAX CLI's (f64 host
    engine) per read and strand to <= 2 pairs (one per split job) and
    1.2e-3 posterior, and in every other column on the rows both write."""
    from cpecan_signal_tpu.cli import signal_align as jsa

    model, ref, reads = _read_set(tmp_path, 2)
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    args = ["-d", reads, "-r", ref, "-T", model, "-C", model, "-s"]
    assert sa.main(args + ["-o", str(tmp_path / "port")]) == 0
    assert jsa.main(args + ["-o", str(tmp_path / "jax")]) == 0
    rows, jrows = _tsv(tmp_path / "port"), _tsv(tmp_path / "jax")
    assert {(r[3], r[4]) for r in rows} == {(f"read{i:03d}.npRead", s)
                                            for i in range(2) for s in "tc"}
    assert all(len(r) == 15 for r in rows)
    for key in {(r[3], r[4]) for r in jrows}:
        got = {(r[1], r[5]): float(r[12]) for r in rows if (r[3], r[4]) == key}
        want = {(r[1], r[5]): float(r[12]) for r in jrows if (r[3], r[4]) == key}
        common = set(got) & set(want)
        assert len(common) >= max(len(got), len(want)) - 2, key
        assert max(abs(got[k] - want[k]) for k in common) < 1.2e-3
    assert_columns_agree(rows, jrows)


def test_failed_strand_keeps_later_reads_attributed(tmp_path, monkeypatch):
    """A read whose complement strand raises while its jobs are collected is
    reported as an error and does not shift the pairs of the reads after
    it: their TSV rows equal those of a run where nothing fails."""
    model, ref, reads = _read_set(tmp_path, 3, seed=8)
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    monkeypatch.setattr(sa.random, "shuffle", lambda paths: None)
    args = ["-d", reads, "-r", ref, "-T", model, "-C", model, "-s", "--retries", "0"]
    assert sa.main(args + ["-o", str(tmp_path / "clean")]) == 0
    clean = _tsv(tmp_path / "clean")

    real_jobs = sa.strand_jobs
    calls = []

    def failing(ctx, params):
        calls.append(ctx["strand"])
        if len(calls) == 2:          # the first read's complement strand
            assert ctx["strand"] == "c"
            raise RuntimeError("complement strand failed")
        return real_jobs(ctx, params)

    monkeypatch.setattr(sa, "strand_jobs", failing)
    assert sa.main(args + ["-o", str(tmp_path / "failed")]) == 0
    failed = _tsv(tmp_path / "failed")
    assert {r[3] for r in failed} == {"read001.npRead", "read002.npRead"}
    assert failed == [r for r in clean if r[3] != "read000.npRead"]
