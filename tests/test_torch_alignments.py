"""PyTorch port: the alignment-TSV analysis utilities (analysis/alignments.py,
the port's copy) on tests/test_aux.py's table, against the JAX package's
module: the same histograms, calls, statistics, comparison and build rows."""

import numpy as np
import pytest

from cpecan_signal_tpu.analysis import alignments as jal
from cpecan_signal_tpu_torch.analysis import alignments as tal
from test_aux import tsv  # noqa: F401  (the fixture)


def _outputs(mod, path):
    table = mod.AlignmentTable.read(path)
    hist = mod.kmer_event_histograms(table)
    hist_raw = mod.kmer_event_histograms(table, threshold=0.5, use_descaled=False)
    return (table, hist, hist_raw, mod.process_posteriors(table, threshold=0.0),
            mod.process_posteriors(table), mod.duration_analysis(table),
            mod.summarize_alignments(table, table.by_strand("t")),
            mod.make_build_alignment([(table, None)], threshold=0.0, max_per_kmer=10),
            mod.make_build_alignment([(table, "E")], threshold=0.3, max_per_kmer=3))


def test_alignment_table_analysis(tsv):  # noqa: F811
    """tests/test_aux.py's checks on the port's copy, and every output equal
    to the JAX module's."""
    got = _outputs(tal, tsv)
    want = _outputs(jal, tsv)
    table, hist, _raw, calls, _c, stats, _cmp, build, _b = got
    assert len(table.rows) == 50
    assert len(hist["ACGTAC"]) == 50
    assert len(calls) == 50
    assert stats["n"] == 50 and stats["max"] == pytest.approx(0.5)
    cmp = tal.summarize_alignments(table, table)
    assert cmp["jaccard"] == 1.0 and cmp["only_a"] == 0
    assert 0 < len(build) <= 20
    assert got[0].rows == want[0].rows
    for g, w in zip(got[1:3], want[1:3]):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    for g, w in zip(got[3:], want[3:]):
        assert repr(g) == repr(w)
