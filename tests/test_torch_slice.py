"""PyTorch port: the whole threeState slice on the CPU.

  * the fast lane's device-side packing (flat-transport unpack, model
    scaling and Gauss pack, window scalars, pair extraction) against the JAX
    fast lane's functions on the same inputs;
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
from cpecan_signal_tpu_torch.engine import readpath as trp
from cpecan_signal_tpu_torch.engine.align import SplitJob
from test_readpath_random import _pairs_match, _threestate_cases
from test_torch_generic_cli import assert_columns_agree

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cases():
    params, jobs, wants = _threestate_cases(211, 7)
    port_jobs = [SplitJob(j.sm, j.band, j.off_x, j.off_y, j.ragged_left,
                          j.ragged_right) for j in jobs]
    return params, jobs, port_jobs, wants


@pytest.fixture(scope="module")
def port_run(cases):
    """The port's lane on the cases, with every bucket's inputs recorded."""
    params, _jobs, port_jobs, _wants = cases
    seen = []
    run_bucket = trp._run_bucket

    def spy(*args):
        seen.append(args)
        return run_bucket(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trp, "_run_bucket", spy)
        got = tba.batch_align_jobs(port_jobs, params.threshold, device=CPU)
    return got, seen


def test_slice_matches_jax_fast_lane_and_oracle(cases, port_run):
    params, jobs, _port_jobs, wants = cases
    got, _seen = port_run
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
    """Every bucket's on-device packing equals the JAX fast lane's on the
    same flat-transport inputs: unpack, window scalars and extraction
    exactly; the f32 model scaling + Gauss pack to 1 ulp of log(sd)
    (torch's and XLA's f32 log may round differently, 6e-8 absolute at
    |log(sd)| < 1, seen after the cancellation in logc = -0.919 - log(sd))."""
    _got, seen = port_run
    assert seen
    for (plan, W, Dp, lXp, lYp, Kg, n_tp, S, thr, mt, yt, gapx, meta_i, meta_f,
         flat_r, flat_w, flat_e) in seen:
        kw = dict(W=W, Dp=Dp, lXp=lXp, lYp=lYp, n_tp=n_tp, S=S)
        t = trp._unpack_dev(meta_i, meta_f, flat_r, flat_w, flat_e, **kw)
        j = jrp._unpack_dev(*(jnp.asarray(a.numpy()) for a in
                              (meta_i, meta_f, flat_r, flat_w, flat_e)), **kw)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        xrank, win, lY, _dl, bidx, _evr, scale8, *_rest, real = t
        xa = trp._pack_xarr(mt, yt, gapx, bidx, xrank, scale8).numpy()
        ja = np.asarray(jrp._pack_xarr(*(jnp.asarray(a.numpy()) for a in
                                         (mt, yt, gapx, bidx, xrank, scale8))))
        np.testing.assert_allclose(xa, ja, rtol=2e-7, atol=1.2e-7)
        for a, b in zip(trp._pack_ds(win, lY, W, lXp, lYp),
                        jrp._pack_ds(jnp.asarray(win.numpy()), jnp.asarray(lY.numpy()),
                                     W, lXp, lYp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # extraction on a synthetic posterior grid with crowded diagonals
        rng = np.random.default_rng(Dp + W)
        p = (rng.random((len(real), Dp, W)) ** 8).astype(np.float32)
        for a, b in zip(trp._extract_global(torch.from_numpy(p), thr, Kg, real),
                        jrp._extract_global(jnp.asarray(p), thr, Kg,
                                            jnp.asarray(real.numpy()))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_run_fast_jobs_and_pad_window(cases, port_run):
    """run_fast_jobs (stage + dispatch + one collection) gives the pairs of
    the batched path and fills its timing keys; the device's window decode
    pads past each job's diagonals exactly as the host rule pad_window."""
    params, _jobs, port_jobs, _wants = cases
    got, seen = port_run
    staged = []
    for i, j in enumerate(port_jobs):
        staged.append((i, *trp.stage_fast_job(j, tba.job_window(j.band))))
    timing = {}
    out = trp.run_fast_jobs(staged, params.threshold, device=CPU, timing=timing)
    assert set(timing) == {"host_pack", "device_wait", "host_extract"}
    for i, pairs in out.items():
        for field in ("probs", "x", "y"):
            np.testing.assert_array_equal(getattr(pairs, field), getattr(got[i], field))
    by_w0 = {}
    for _i, fj, _plan in staged:
        by_w0.setdefault((fj.wband.W, int(fj.wband.w0[0]), fj.wband.n_diagonals),
                         []).append(fj.wband)
    for (_plan, W, Dp, *_r, meta_i, _mf, _fr, flat_w, _fe) in seen:
        win = trp._unpack_win(meta_i, flat_w.to(torch.int32), W, Dp).numpy()
        for bi in range(len(meta_i)):
            key = (W, int(meta_i[bi, trp.MI_W00]), int(meta_i[bi, trp.MI_WIN_D]))
            assert any((trp.pad_window(wb, Dp) == win[bi]).all() for wb in by_w0[key])


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
