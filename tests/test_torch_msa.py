"""PyTorch port: the posterior-pair multiple aligner (msa.py over the port's
f64 oracle) on the CPU, tests/test_msa.py's 4 tests on the port, each
alignment also against the JAX package's msa.make_alignment on the same
sequences: the same pairwise pairs, columns and consistent pairs."""

import numpy as np
import torch

from cpecan_signal_tpu import msa as jmsa
from cpecan_signal_tpu.models.params import AlignmentParams as JParams
from cpecan_signal_tpu_torch.models.params import AlignmentParams
from cpecan_signal_tpu_torch.msa import _ColumnPoset, make_alignment

CPU = torch.device("cpu")


def _same_as_jax(msa, seqs, **kw):
    want = jmsa.make_alignment(seqs, params=JParams(threshold=0.3), **kw)
    assert msa.pairwise_pairs == want.pairwise_pairs
    assert msa.columns == want.columns
    assert msa.consistent_pairs == want.consistent_pairs


def test_poset_rejects_order_violations():
    poset = _ColumnPoset([5, 5])
    assert poset.merge((0, 1), (1, 1))
    assert poset.merge((0, 3), (1, 3))
    # (0,2)-(1,4) would be fine; (0,4)-(1,2) crosses the (0,3)-(1,3) column
    assert poset.merge((0, 2), (1, 2))
    assert not poset.can_merge((0, 4), (1, 0))


def test_poset_rejects_same_sequence():
    poset = _ColumnPoset([5, 5])
    poset.merge((0, 1), (1, 1))
    assert not poset.can_merge((0, 2), (0, 3))


def test_make_alignment_related_seqs():
    rng = np.random.default_rng(0)
    base = "".join(rng.choice(list("ACGT"), 60))

    def mutate(s):
        return "".join(c if rng.random() > 0.08 else rng.choice(list("ACGT"))
                       for c in s)

    seqs = [base, mutate(base), mutate(base)]
    msa = make_alignment(seqs, params=AlignmentParams(threshold=0.3), device=CPU)
    assert len(msa.pairwise_pairs) > 100
    # consistent pairs are the bulk, and columns mostly align homologous sites
    assert len(msa.consistent_pairs) > 0.8 * len(msa.pairwise_pairs)
    full_cols = [c for c in msa.columns if len(c) == 3]
    assert len(full_cols) > 30
    same_pos = sum(1 for c in full_cols if len({p for _, p in c}) == 1)
    assert same_pos / len(full_cols) > 0.8
    _same_as_jax(msa, seqs)


def test_make_alignment_spanning_tree_rounds():
    """Distance-matrix-guided extra spanning trees + progressive merging
    (makeAlignment, multipleAligner.c:892-944; getNextBestPair :866)."""
    rng = np.random.default_rng(5)
    base = "".join(rng.choice(list("ACGT"), 120))

    def mutate(s, p):
        out = []
        for c in s:
            r = rng.random()
            if r < p:
                out.append(str(rng.choice([b for b in "ACGT" if b != c])))
            else:
                out.append(c)
        return "".join(out)

    seqs = [mutate(base, 0.03 * i) for i in range(6)]
    params = AlignmentParams(threshold=0.3)

    for progressive in (False, True):
        msa = make_alignment(seqs, spanning_trees=2, params=params,
                             use_progressive_merging=progressive, device=CPU)
        n_alignments = {(t[1], t[3]) for t in msa.pairwise_pairs}
        # initial star = 5 alignments; the distance-guided round must add more
        assert len(n_alignments) > 5, (progressive, n_alignments)
        assert len(msa.consistent_pairs) > 0.7 * len(msa.pairwise_pairs)
        deep = [c for c in msa.columns if len(c) >= 4]
        assert len(deep) > 40, (progressive, len(deep))
        _same_as_jax(msa, seqs, spanning_trees=2, use_progressive_merging=progressive)
