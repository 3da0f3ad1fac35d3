"""The signal CLIs' several-process routes on the CPU (the helpers and
launch of tests/test_torch_distributed.py): train_models (1 iteration) on 2
ranks against 1 process within PERF.md §2's E-step limits (tallies rtol 1e-4
+ atol 1e-5, likelihood 1e-5 relative); signal_align -s on 2 ranks, and
with ``--jobs 2`` on the CPU, writing the rows one process writes.
"""

import glob

import numpy as np
import pytest

from cpecan_signal_tpu_torch import synthetic as syn
from test_torch_distributed import LIK_RTOL, STEP_ATOL, STEP_RTOL, _launch, _worker

N_READS = 3


@pytest.fixture(scope="module")
def read_set(tmp_path_factory):
    """A reference, a pore model and 3 two-strand reads of 150-250 bases."""
    tmp = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(11)
    model = str(tmp / "m.model")
    pore = syn.write_pore_model(model, rng)
    ref = str(tmp / "ref.fa")
    ref_seq = syn.write_reference(ref, 4000, rng)
    reads = str(tmp / "reads")
    syn.write_read_set(reads, ref_seq, pore, N_READS, rng, min_bases=150, max_bases=250)
    return ref, reads, model


def test_train_models_two_ranks_match_one(tmp_path, read_set):
    ref, reads, model = read_set
    two = _worker(tmp_path, "train", 2, ref, reads, model, tmp_path)
    one = _worker(tmp_path, "train", 0, ref, reads, model, tmp_path)
    for k in one:
        if k.endswith("likelihood"):
            assert float(two[k]) == pytest.approx(float(one[k]), rel=LIK_RTOL)
        else:
            np.testing.assert_allclose(two[k], one[k], rtol=STEP_RTOL, atol=STEP_ATOL)


def _rows(path: str) -> list[str]:
    with open(path) as fh:
        return sorted(fh)


def test_signal_align_two_ranks_and_jobs_match_one(tmp_path, read_set):
    ref, reads, model = read_set
    cli = ["-m", "cpecan_signal_tpu_torch.cli.signal_align", "-d", reads, "-r", ref,
           "-T", model, "-C", model, "-s"]
    runs = {"one": (0, []), "two": (2, []), "jobs": (0, ["--jobs", "2"])}
    for name, (ranks, extra) in runs.items():
        _launch(cli + ["-o", str(tmp_path / name), *extra], ranks)
    want = _rows(str(tmp_path / "one" / "posteriors.tsv"))
    assert len({r.split("\t")[3] for r in want}) == N_READS   # every read aligned
    for name in ("two", "jobs"):
        assert _rows(str(tmp_path / name / "posteriors.tsv")) == want, name
        assert not glob.glob(str(tmp_path / name / "*.part*")), name
