"""PyTorch port: device-batched alignment of the generic window machines
(vanilla, fourState, echelon) on the CPU, against the JAX package's
batch_align_jobs (interpret mode) on the same split jobs: random lengths,
anchors, ragged ends and split offsets, at the fast lane's tolerances (<= 1
pair per job, 1.2e-3 posterior drift; tests/test_readpath_random.py).
"""

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.core.anchors import filter_to_remove_overlap
from cpecan_signal_tpu.core.band import band_construct
from cpecan_signal_tpu.core.kmers import sequence_kmer_ranks
from cpecan_signal_tpu.engine import batch_align as jba
from cpecan_signal_tpu.engine.align import SplitJob as JSplitJob
from cpecan_signal_tpu.models import state_machines as jsm
from cpecan_signal_tpu.models.params import AlignmentParams
from cpecan_signal_tpu_torch.engine import batch_align as tba
from cpecan_signal_tpu_torch.engine.align import SplitJob
from cpecan_signal_tpu_torch.ops import fb_kernels as fk
from test_readpath_random import _pairs_match, _rand_pore

CPU = torch.device("cpu")
MAKERS = {
    "vanilla": lambda pore, t, e, i: jsm.make_signal_vanilla(
        pore, t, e, "template" if i % 2 else "complement"),
    "fourState": lambda pore, t, e, i: jsm.make_signal_sm4(pore, t, e),
    "echelon": lambda pore, t, e, i: jsm.make_signal_echelon(pore, t, e),
}


def _cases(name, seed, n_jobs, lo, hi):
    """Split jobs of one machine: events one per k-mer with Gaussian noise,
    0-3 anchors, random ragged ends and split offsets, skip bins of their
    own (vanilla and echelon read them per cell)."""
    rng = np.random.default_rng(seed)
    pore = _rand_pore(rng)
    pore.skip_bins[:] = np.concatenate([rng.uniform(0.05, 0.3, 30),
                                        rng.uniform(0.1, 0.5, 30)])
    params = AlignmentParams(diagonal_expansion=6)
    jobs = []
    for i in range(n_jobs):
        target = "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))
        ranks = sequence_kmer_ranks(target)
        n_ev = len(ranks) - int(rng.integers(0, 4))
        events = np.column_stack([pore.match_model[ranks[:n_ev], 0]
                                  + rng.normal(0, 0.4, n_ev),
                                  np.full(n_ev, 2.0), rng.uniform(0.002, 0.02, n_ev)])
        k = int(rng.integers(0, 4))
        anchors = (filter_to_remove_overlap(np.stack(
            [np.sort(rng.choice(min(len(ranks), n_ev) - 1, k, replace=False))] * 2,
            axis=1).astype(np.int64)) if k else np.zeros((0, 2), np.int64))
        band = band_construct(anchors, len(ranks), n_ev, params.diagonal_expansion)
        jobs.append((MAKERS[name](pore, target, events, i), band,
                     int(rng.integers(0, 500)), int(rng.integers(0, 500)),
                     bool(rng.integers(2)), bool(rng.integers(2))))
    return params, jobs


@pytest.mark.parametrize("name, seed, n_jobs, lo, hi", [
    ("vanilla", 41, 6, 28, 140),
    ("fourState", 43, 6, 28, 140),
    ("echelon", 47, 4, 26, 60),
])
def test_batch_align_matches_jax(name, seed, n_jobs, lo, hi):
    params, cases = _cases(name, seed, n_jobs, lo, hi)
    before = dict(fk.LAUNCHES)
    got = tba.batch_align_jobs([SplitJob(*c) for c in cases], params.threshold,
                               device=CPU)
    assert fk.LAUNCHES == before             # plain versions on the CPU
    want = jba.batch_align_jobs([JSplitJob(*c) for c in cases], params.threshold,
                                interpret=True)
    assert len(got) == len(want) == n_jobs
    for (_sm, band, off_x, off_y, *_r), g, w in zip(cases, got, want):
        _pairs_match(g, w)
        assert len(g.probs) >= min(band.lX, band.lY) // 2
        assert g.x.min() >= off_x - 1 and g.y.min() >= off_y - 1


def test_generic_buckets_split_by_size(monkeypatch):
    """Bucket sizing (at most MAX_BUCKET problems and BUCKET_E_BYTES of host
    E per bucket; a job larger than that alone) changes the buckets, not
    the pairs."""
    params, cases = _cases("vanilla", 53, 5, 28, 120)
    jobs = [SplitJob(*c) for c in cases]
    real = tba.pp.run_window

    def run(**limits):
        sizes = []
        with monkeypatch.context() as mp:
            mp.setattr(tba.pp, "run_window",
                       lambda plan, W, b, **kw: sizes.append(len(b.E)) or real(plan, W, b, **kw))
            for name, value in limits.items():
                mp.setattr(tba.pp if name == "MAX_BUCKET" else tba, name, value)
            return tba.batch_align_jobs(jobs, params.threshold, device=CPU), sizes

    whole, whole_sizes = run()
    by_count, count_sizes = run(MAX_BUCKET=2)
    by_bytes, bytes_sizes = run(BUCKET_E_BYTES=1)
    assert sum(whole_sizes) == sum(count_sizes) == 5 and max(whole_sizes) > 2
    assert max(count_sizes) == 2 and bytes_sizes == [1] * 5
    for other in (by_count, by_bytes):
        for a, b in zip(whole, other):
            for field in ("probs", "x", "y"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_threestatehdp_jobs_raise():
    """threeStateHdp jobs align: one whose density carries no table (the
    --substitute route) takes the generic buckets beside a fourState job,
    within the JAX package's pairs; the CLI factory of threeStateHdp
    without a density raises, naming the options that give one, and that
    of a machine the CLI does not align (fiveState) raises too."""
    from cpecan_signal_tpu_torch.cli import vanilla_align as tva

    params, cases = _cases("fourState", 59, 1, 30, 40)
    sm, band, *_r = cases[0]
    rng = np.random.default_rng(61)
    target = "".join(rng.choice(list("ACGT"), 14))
    events = np.column_stack([rng.uniform(0.0, 1.0, 8), np.full(8, 2.0), np.full(8, 0.01)])
    hdp = jsm.make_signal_sm3_hdp(lambda r, m: np.clip(1.0 - np.abs(m - 0.5), 0, None)
                                  + 0.01 * (r % 7), target, events)
    assert getattr(hdp, "hdp_pack", None) is None
    hband = band_construct(np.zeros((0, 2), np.int64), 9, 8, 4)
    jobs = [(sm, band), (hdp, hband)]
    got = tba.batch_align_jobs([SplitJob(m, b, 0, 0, True, True) for m, b in jobs], 0.01,
                               device=CPU)
    want = jba.batch_align_jobs([JSplitJob(m, b, 0, 0, True, True) for m, b in jobs], 0.01,
                                interpret=True)
    assert len(got[1].probs) > 0
    for g, w in zip(got, want):
        _pairs_match(g, w)
    with pytest.raises(ValueError, match="--templateHdp, --complementHdp"):
        tva.make_sm_factory("threeStateHdp", None, "t")
    with pytest.raises(ValueError, match="unsupported state machine"):
        tva.make_sm_factory("fiveState", None, "t")
