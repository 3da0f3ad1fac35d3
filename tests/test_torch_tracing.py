"""The port's one tracer, ``utils/observability``, and where it is wired.

  * (a) ``timed`` with a caller's dict: the seconds land under the key and
    in ``counters`` (``time.<name>.sum`` / ``.count``); nested spans count
    each level;
  * (b) under ``torch.profiler.profile`` on the CPU a span is the event
    ``cpecan:<name>`` whose interval holds the aten op issued inside it;
  * (c) with no profiler running a span opens no profiler region;
  * (d) ``realign_records_batched``'s sub-spans of the heads and the tails
    sum to their parents, beside the batch's own;
  * (e) an EM step adds each bucket's problems, diagonals, lane cells and
    band cells to the counters, as counted by hand from the jobs, and no SM
    slots on the CPU;
  * (f) the nucleotide E-step (``record_expectations``) records its heads,
    its staging and its wait on the device, and adds each bucket's jobs,
    diagonals, band cells, lane cells (B x Dp x W) and, on the CPU, no SM
    slots; ``realign_records_batched`` records none of its ``nem.*`` spans
    and counters.
"""

import numpy as np
import pytest
import torch

from cpecan_signal_tpu_torch.anchor.seed_chain import get_anchor_pairs
from cpecan_signal_tpu_torch.cli.realign import (realign_records_batched, record_expectations,
                                                  record_jobs)
from cpecan_signal_tpu_torch.constants import MODEL_PARAMS, NUM_OF_KMERS
from cpecan_signal_tpu_torch.core.amap import pairs_to_cigar_ops
from cpecan_signal_tpu_torch.core.kmers import sequence_kmer_ranks
from cpecan_signal_tpu_torch.core.window import smooth_band
from cpecan_signal_tpu_torch.em import sm3_em
from cpecan_signal_tpu_torch.em.accumulators import DiscreteHmm
from cpecan_signal_tpu_torch.engine import readpath
from cpecan_signal_tpu_torch.io.cigar import CigarRecord
from cpecan_signal_tpu_torch.io.npread import ScaleParams
from cpecan_signal_tpu_torch.models.params import AlignmentParams
from cpecan_signal_tpu_torch.models.pore_model import PoreModel
from cpecan_signal_tpu_torch.utils import observability as tobs

CPU = torch.device("cpu")
HEADS = ("head.stage", "head.split")
TAILS = ("tail.assemble", "tail.reweight", "tail.filter", "tail.cigar")


def _count(name):
    return tobs.counters.snapshot().get(name, 0.0)


def test_timed_adds_to_the_dict_and_the_counters():
    timing = {}
    sums = {n: _count(f"time.{n}.sum") for n in ("t.outer", "t.inner")}
    counts = {n: _count(f"time.{n}.count") for n in ("t.outer", "t.inner")}
    with tobs.timed("t.outer", timing):
        for _ in range(3):
            with tobs.timed("t.inner", timing):
                sum(range(20000))
    assert set(timing) == {"t.outer", "t.inner"}
    assert 0 < timing["t.inner"] <= timing["t.outer"]
    for n in timing:
        assert _count(f"time.{n}.sum") - sums[n] == pytest.approx(timing[n])
    assert _count("time.t.inner.count") - counts["t.inner"] == 3
    assert _count("time.t.outer.count") - counts["t.outer"] == 1
    with tobs.timed("t.outer"):      # no dict: the counters alone
        pass
    assert set(timing) == {"t.outer", "t.inner"}
    assert _count("time.t.outer.count") - counts["t.outer"] == 2


def test_a_count_goes_to_the_counters_and_the_dict():
    timing = {}
    before = _count("t.jobs")
    tobs.counters.add("t.jobs", 3, timing)
    tobs.counters.add("t.jobs", 2, timing)
    assert timing == {"t.jobs": 5} and _count("t.jobs") - before == 5


def test_a_span_that_raises_still_counts_and_closes():
    before = _count("time.t.raises.count")
    with pytest.raises(ValueError):
        with tobs.timed("t.raises"):
            raise ValueError("inside")
    assert _count("time.t.raises.count") - before == 1


def _events(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


def test_span_is_a_profiler_region_around_its_ops():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.timed("t.traced"):
            torch.ones(64).cumsum(0)
        torch.ones(8).cumprod(0)
    ev = _events(prof)
    (span,) = [e for e in ev if e[0] == "cpecan:t.traced"]
    inside = [e for e in ev if e[0] == "aten::cumsum"]
    outside = [e for e in ev if e[0] == "aten::cumprod"]
    assert inside and outside
    assert all(span[1] <= e[1] and e[2] <= span[2] for e in inside)
    assert all(e[1] >= span[2] for e in outside)


def test_no_profiler_no_region(monkeypatch):
    """Without a profiler recording, a span makes no call into torch's
    profiler beyond the enabled check."""
    def refuse(*_a, **_k):
        raise AssertionError("a profiler region was opened")

    monkeypatch.setattr(tobs, "_region", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tobs._profiling()
    timing = {}
    with tobs.timed("t.quiet", timing):
        with tobs.timed("t.quiet.inner", timing):
            pass
    assert set(timing) == {"t.quiet", "t.quiet.inner"}


def _records(rng, n, n_bases):
    """n forward-strand records of n_bases-base pairs (7 % substitutions, 2
    % deletions), guide CIGARs from the seed-chain anchors; the second on
    the reverse strand of its y."""
    from cpecan_signal_tpu_torch.io.fasta import reverse_complement

    seqs, recs = {}, []
    for i in range(n):
        sx = "".join(rng.choice(list("ACGT"), n_bases))
        sy = "".join((c if rng.random() > 0.07 else rng.choice(list("ACGT")))
                     for c in sx if rng.random() > 0.02)
        anchors = get_anchor_pairs(sx, sy, k=8)
        pairs = np.concatenate([np.ones((len(anchors), 1), dtype=np.int64), anchors], axis=1)
        ops = pairs_to_cigar_ops(pairs, len(sx), len(sy))
        seqs[f"x{i}"] = sx
        if i % 2:
            seqs[f"y{i}"] = reverse_complement(sy)
            recs.append(CigarRecord(f"x{i}", 0, len(sx), True, f"y{i}", len(sy), 0, False,
                                    0.0, ops))
        else:
            seqs[f"y{i}"] = sy
            recs.append(CigarRecord(f"x{i}", 0, len(sx), True, f"y{i}", 0, len(sy), True,
                                    0.0, ops))
    return recs, seqs


def _sums_to(parts, whole):
    return abs(parts - whole) <= max(0.1 * whole, 5e-3)


def test_realign_spans_split_heads_and_tails():
    recs, seqs = _records(np.random.default_rng(3), 2, 300)
    timing = {}
    out = realign_records_batched(recs, seqs, AlignmentParams(), device=CPU, timing=timing)
    assert len(out) == 2 and all(len(r) == 1 for r in out)
    for key in ("head", "batch", "tail", "host_pack", "device_wait", "host_extract",
                *HEADS, *TAILS):
        assert timing[key] > 0, key
    assert _sums_to(sum(timing[k] for k in HEADS), timing["head"])
    assert _sums_to(sum(timing[k] for k in TAILS), timing["tail"])
    # a second call adds to the same keys
    again = dict(timing)
    realign_records_batched(recs, seqs, AlignmentParams(), device=CPU, timing=timing)
    assert set(timing) == set(again) and all(timing[k] > again[k] for k in again)


def _em_jobs(rng, lengths):
    """Jobs of one strand of reads of ``lengths`` bases (events a k-mer,
    less a few, no anchors) against a random pore model."""
    match = np.zeros((NUM_OF_KMERS + 2, MODEL_PARAMS))
    match[:NUM_OF_KMERS, 0] = rng.uniform(40, 90, NUM_OF_KMERS)
    match[:NUM_OF_KMERS, 1] = 1.0
    match[:NUM_OF_KMERS, 2] = rng.uniform(1, 3, NUM_OF_KMERS)
    match[:NUM_OF_KMERS, 3] = 0.3
    match[:NUM_OF_KMERS, 4] = 5.0
    pore = PoreModel(0.9, match, 0.9, match.copy(), np.full(60, 1 / 30))
    sp = ScaleParams(1.0, 0.0, 1.0, 1.0, 1.0)
    reads = []
    for n in lengths:
        target = "".join(rng.choice(list("ACGT"), n))
        ranks = sequence_kmer_ranks(target)
        n_ev = len(ranks) - int(rng.integers(0, 6))
        events = np.stack([match[ranks[:n_ev], 0] + rng.normal(0, 0.5, n_ev),
                           np.full(n_ev, 2.0), np.full(n_ev, 0.01)], axis=1)
        reads.append({"t": (target, events, np.zeros((0, 2), dtype=np.int64), sp)})
    return sm3_em.collect_sm3_em_jobs(reads, {"t": pore}, AlignmentParams(diagonal_expansion=4),
                                      "t")


def test_em_step_counts_its_buckets(monkeypatch):
    monkeypatch.setattr(sm3_em.pp, "MAX_BUCKET", 2)     # several buckets, padded
    jobs = _em_jobs(np.random.default_rng(7), (30, 44, 38, 52, 41))
    wbands = [smooth_band(j.band, width_multiple=64) for j in jobs]
    names = ("em.problems", "em.diagonals", "em.cells_lane", "em.cells_band", "em.sm_slots")
    builds = _count("time.em.build_buckets.count")
    buckets = sm3_em.build_sm3_em_buckets(jobs, device=CPU, width_multiple=64)
    assert _count("time.em.build_buckets.count") - builds == 1
    assert len(buckets) == 3
    want = {"em.problems": len(jobs),
            "em.diagonals": sum(w.n_diagonals for w in wbands),
            "em.cells_lane": sum(w.W * w.n_diagonals for w in wbands),
            "em.cells_band": sum(int(j.band.widths.sum()) for j in jobs),
            "em.sm_slots": 0}
    before = {n: _count(n) for n in names}
    sm3_em.sm3_em_step(buckets)
    got = {n: _count(n) - before[n] for n in names}
    assert got == want
    assert sum(b.Dp * b.counts["em.problems"] for b in buckets) > want["em.diagonals"]


NEM_SPANS = ("head", "nem.stage", "nem.device_wait")
NEM_COUNTS = ("nem.jobs", "nem.diagonals", "nem.chain_diagonals", "nem.cells_band",
              "nem.cells_lane", "nem.sm_slots")


def test_nucleotide_estep_spans_and_counters():
    recs, seqs = _records(np.random.default_rng(5), 3, 300)
    params = AlignmentParams()
    _heads, _spans, jobs = record_jobs(recs, seqs, params, None)
    staged = [(i, *readpath.stage_symbol_job(j, smooth_band(j.band, width_multiple=128)))
              for i, j in enumerate(jobs)]
    buckets = readpath.symbol_buckets(staged)
    want = {"nem.jobs": len(jobs),
            "nem.diagonals": sum(sj.wband.n_diagonals for _i, sj, _p in staged),
            "nem.chain_diagonals": sum(max(staged[si][1].wband.n_diagonals for si in chunk)
                                       for *_k, chunk in buckets),
            "nem.cells_band": sum(int(j.band.widths.sum()) for j in jobs),
            "nem.cells_lane": sum(len(chunk) * Dp * W for _p, W, Dp, chunk in buckets),
            "nem.sm_slots": 0}
    before = {n: _count(n) for n in NEM_COUNTS}
    timing = {}
    record_expectations(recs, seqs, params, None, DiscreteHmm.empty(5, 4), device=CPU,
                        timing=timing)
    for key in (*NEM_SPANS, *HEADS):
        assert timing[key] > 0, key
    assert _sums_to(sum(timing[k] for k in HEADS), timing["head"])
    assert {n: timing[n] for n in NEM_COUNTS} == want
    assert {n: _count(n) - before[n] for n in NEM_COUNTS} == want
    assert timing["buckets"] == len(buckets)
    # lane fill at most 100 %
    assert 0 < timing["nem.cells_band"] <= timing["nem.cells_lane"]


def test_realign_records_no_nucleotide_estep_spans():
    recs, seqs = _records(np.random.default_rng(3), 2, 300)
    names = [f"time.{n}.count" for n in NEM_SPANS[1:]] + list(NEM_COUNTS)
    before = {n: _count(n) for n in names}
    timing = {}
    realign_records_batched(recs, seqs, AlignmentParams(), device=CPU, timing=timing)
    assert not [k for k in timing if k.startswith("nem.")]
    assert {n: _count(n) for n in names} == before
