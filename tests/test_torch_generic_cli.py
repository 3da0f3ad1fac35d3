"""PyTorch port: the CLIs with the generic window machines on the CPU, against
the JAX CLIs (whose CPU route is the f64 host engine) on synthetic npReads:

  * signal_align with no machine flag (vanilla), --fourState and --echelon;
  * vanilla_align with no machine flag, -f and -e on one read;
  * vanilla_align -y/-z with a trained vanilla model (.hmm skip bins)
    written by the port's accumulators and loaded by both CLIs.

Rows agree per read and strand to <= 2 pairs (one per split job) and
1.2e-3 posterior (f32 with the reference's cubic logAdd against f64 exact
logaddexp; tests/test_readpath_random.py).  Echelon emits one row per
k-mer of a multi-k-mer event, so a (position, event) key may hold several
rows: they are compared as sorted lists.  On the rows both CLIs write, every
other column agrees too: the k-mer and name columns equal, the event,
model and descaled values to the last printed digit.
"""

import os

import numpy as np
import pytest

from cpecan_signal_tpu.cli import signal_align as jsa
from cpecan_signal_tpu.cli import vanilla_align as jva
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.cli import signal_align as sa
from cpecan_signal_tpu_torch.cli import vanilla_align as tva
from cpecan_signal_tpu_torch.em.accumulators import VanillaHmm

PAIR_TOL, PROB_TOL = 2, 1.2e-3
# TSV columns besides the keys (read 3, strand 4, position 1, event 5) and
# the posterior (12): contig, reference k-mer, read k-mer; event mean, noise,
# duration, expected level and noise, descaled mean and expected level,
# printed with 6 decimals
TEXT_COLS = (0, 2, 9)
VALUE_COLS, VALUE_ATOL = (6, 7, 8, 10, 11, 13, 14), 2e-6


@pytest.fixture(scope="module")
def read_set(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("generic_cli")
    rng = np.random.default_rng(17)
    model = str(tmp / "synthetic.model")
    pore = syn.write_pore_model(model, rng)
    ref = str(tmp / "ref.fa")
    ref_seq = syn.write_reference(ref, 2500, rng)
    reads = str(tmp / "reads")
    syn.write_read_set(reads, ref_seq, pore, 2, rng, min_bases=90, max_bases=150)
    return tmp, model, ref, reads


def _rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def assert_columns_agree(rows, jrows):
    """The columns other than the posterior, on the (read, strand, position,
    event) keys both tables hold: one value set per key on each side, the
    text columns equal and the numbers within VALUE_ATOL."""
    def by_key(table):
        out = {}
        for r in table:
            out.setdefault((r[3], r[4], r[1], r[5]), set()).add(
                tuple(r[i] for i in TEXT_COLS + VALUE_COLS))
        return out

    got, want = by_key(rows), by_key(jrows)
    common = set(got) & set(want)
    assert common
    for key in common:
        assert len(got[key]) == len(want[key]) == 1, key
        (g,), (w,) = got[key], want[key]
        n = len(TEXT_COLS)
        assert g[:n] == w[:n], (key, g, w)
        assert np.allclose([float(v) for v in g[n:]], [float(v) for v in w[n:]],
                           rtol=0, atol=VALUE_ATOL), (key, g, w)


def _assert_rows_agree(rows, jrows, keys):
    """Per (read, strand): rows keyed by (reference position, event), each
    key's posteriors compared as a sorted list; the other columns by
    assert_columns_agree."""
    assert all(len(r) == 15 for r in rows)
    assert_columns_agree(rows, jrows)
    assert {(r[3], r[4]) for r in rows} == {(r[3], r[4]) for r in jrows} == keys
    for key in keys:
        got, want = {}, {}
        for table, rs in ((got, rows), (want, jrows)):
            for r in rs:
                if (r[3], r[4]) == key:
                    table.setdefault((r[1], r[5]), []).append(float(r[12]))
        missing = sum(abs(len(got.get(k, [])) - len(want.get(k, [])))
                      for k in set(got) | set(want))
        assert missing <= PAIR_TOL, (key, missing, len(got), len(want))
        drift = max(abs(a - b) for k in set(got) & set(want)
                    for a, b in zip(sorted(got[k]), sorted(want[k])))
        assert drift < PROB_TOL, (key, drift)


@pytest.mark.parametrize("flags", [[], ["--fourState"], ["--echelon"]],
                         ids=["vanilla", "fourState", "echelon"])
def test_signal_align_cli_matches_jax(flags, read_set, monkeypatch):
    tmp, model, ref, reads = read_set
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    name = flags[0][2:] if flags else "vanilla"
    args = ["-d", reads, "-r", ref, "-T", model, "-C", model] + flags
    assert sa.main(args + ["-o", str(tmp / f"port_{name}")]) == 0
    assert jsa.main(args + ["-o", str(tmp / f"jax_{name}")]) == 0
    rows = _rows(tmp / f"port_{name}" / "posteriors.tsv")
    jrows = _rows(tmp / f"jax_{name}" / "posteriors.tsv")
    _assert_rows_agree(rows, jrows, {(f"read{i:03d}.npRead", s) for i in range(2)
                                     for s in "tc"})


def _vanilla_align(main, read_set, out, extra):
    tmp, model, ref, reads = read_set
    npread = os.path.join(reads, "read001.npRead")
    assert main(["-r", ref, "-q", npread, "-T", model, "-C", model, "-L", "r1",
                 "-u", str(tmp / out)] + extra) == 0
    return _rows(tmp / out)


@pytest.mark.parametrize("flags", [[], ["-f"], ["-e"]], ids=["vanilla", "fourState", "echelon"])
def test_vanilla_align_cli_matches_jax(flags, read_set, monkeypatch):
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    tag = flags[0] if flags else "none"
    rows = _vanilla_align(tva.main, read_set, f"port_va{tag}.tsv", flags)
    jrows = _vanilla_align(jva.main, read_set, f"jax_va{tag}.tsv", flags)
    _assert_rows_agree(rows, jrows, {("r1", "t"), ("r1", "c")})


def test_vanilla_align_loads_trained_models(read_set, monkeypatch):
    """-y/-z: skip bins of a vanilla model written by the port's
    accumulators (one file per strand) reach both CLIs' machines; the rows
    agree, and differ from those of the default bins."""
    tmp = read_set[0]
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    rng = np.random.default_rng(23)
    hmms = []
    for strand in "tc":
        hmm = VanillaHmm(bins=np.concatenate([rng.uniform(0.01, 0.1, 30),
                                              rng.uniform(0.2, 0.6, 30)]))
        hmm.write(str(tmp / f"{strand}.hmm"))
        hmms.append(str(tmp / f"{strand}.hmm"))
    trained = ["-y", hmms[0], "-z", hmms[1]]
    rows = _vanilla_align(tva.main, read_set, "port_trained.tsv", trained)
    jrows = _vanilla_align(jva.main, read_set, "jax_trained.tsv", trained)
    _assert_rows_agree(rows, jrows, {("r1", "t"), ("r1", "c")})
    default = _vanilla_align(tva.main, read_set, "port_default.tsv", [])
    assert [r[12] for r in rows] != [r[12] for r in default]
