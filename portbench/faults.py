"""Faults a cell can have, planted in the program under a whole run: the
comparison with the reference has to read each as not correct.  Each
``plant`` replaces one function of the program and returns what undoes it;
the benchmark's own runs never plant one.

    python3 portbench/control.py --workload <cell> --fault <name> ...

reads a fault at the cell's own size; the tests plant each at a small size.
"""

from __future__ import annotations

import numpy as np
import torch


class _Patch:
    def __init__(self):
        self.undo = []

    def setattr(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __call__(self):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)


def _half_batch_em(patch):
    """Half of each bucket left out, the tallies of the rest doubled."""
    from cpecan_signal_tpu_torch.engine import pipeline as pp
    real = pp.sm3_expectations

    def half(plan, W, batch):
        B = batch.xrank.shape[0]
        h = max(B // 2, 1)
        trans, kmer, lik = real(plan, W, type(batch)(*(t[:h] for t in batch)))
        return trans * (B / h), kmer * (B / h), lik * (B / h)
    patch.setattr(pp, "sm3_expectations", half)


def _unchanged_em(patch):
    """The M-step hands back the state it was given: the defaults."""
    from cpecan_signal_tpu_torch.em import accumulators
    patch.setattr(accumulators.ContinuousPairHmm, "to_sm3_params",
                        lambda self: (None, None))


def _altered_em(patch):
    """One k-mer's gap tally moved by one expected use where it is made."""
    from cpecan_signal_tpu_torch.engine import pipeline as pp
    real = pp.sm3_expectations

    def altered(plan, W, batch):
        trans, kmer, lik = real(plan, W, batch)
        kmer = kmer.clone()
        kmer[int(torch.argmax(kmer))] += 1.0
        return trans, kmer, lik
    patch.setattr(pp, "sm3_expectations", altered)


def _stream_fault(patch, fn):
    from cpecan_signal_tpu_torch.engine import batch_align
    real = batch_align.batch_align_stream

    def broken(per_read_jobs, threshold, **kw):
        jobs, out = real(per_read_jobs, threshold, **kw)
        return jobs, fn(out)
    patch.setattr(batch_align, "batch_align_stream", broken)


def _half_batch_reads(patch):
    """Every other job of a call left out of the batch: no pairs come back."""
    from cpecan_signal_tpu_torch.engine.align import AlignedPairs
    z = np.zeros(0, dtype=np.int64)
    _stream_fault(patch, lambda out: [p if i % 2 else AlignedPairs(z, z, z)
                                            for i, p in enumerate(out)])


def _altered_reads(patch):
    """One job's posteriors halved where the batch produces them."""
    def alter(out):
        p = out[0]
        out[0] = type(p)(p.probs // 2, p.x, p.y)
        return out
    _stream_fault(patch, alter)


def _record_fault(patch, fn):
    from cpecan_signal_tpu_torch.em import discrete
    real = discrete.batched_pairs_for_records

    def broken(jobs, threshold, **kw):
        return fn(real(jobs, threshold, **kw))
    patch.setattr(discrete, "batched_pairs_for_records", broken)


def _half_batch_realign(patch):
    """Every other split job left out of the device batch."""
    from cpecan_signal_tpu_torch.engine.align import AlignedPairs
    z = np.zeros(0, dtype=np.int64)
    _record_fault(patch, lambda out: [p if i % 2 else AlignedPairs(z, z, z)
                                            for i, p in enumerate(out)])


def _altered_realign(patch):
    """A run of a record's aligned pairs shifted by one base on y where the
    batch produces them."""
    def alter(out):
        p = out[0]
        y = p.y.copy()
        mid = slice(len(y) // 3, 2 * len(y) // 3)
        y[mid] = np.minimum(y[mid] + 1, y.max())
        out[0] = type(p)(p.probs, p.x, y)
        return out
    _record_fault(patch, alter)


FAULTS = {
    "sigalign.em": {"unchanged_state": _unchanged_em, "half_batch": _half_batch_em,
                    "altered_answer": _altered_em},
    "sigalign.reads": {"half_batch": _half_batch_reads, "altered_answer": _altered_reads},
    "realign.records": {"half_batch": _half_batch_realign, "altered_answer": _altered_realign},
}


def plant(workload: str, fault: str):
    """Plant ``fault`` of ``workload``; returns the undo."""
    patch = _Patch()
    FAULTS[workload][fault](patch)
    return patch
