"""PyTorch port: AMAP's heaviest-chain filter (core/amap.filter_pairs_to_ordered,
its DP in csrc/amap_chain.cpp) against the JAX package's Python version, pair
for pair, on edge cases, random pairs and a near-diagonal record; the native
library's build and load; finish_record's count of the pairs it filters; the
benchmark's reader of that count."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from cpecan_signal_tpu.core import amap as jamap
from cpecan_signal_tpu_torch.core import amap as tamap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pairs(rows):
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def _random(seed, n=400, lx=120, ly=110):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1, 10_000_000, n), rng.integers(0, lx, n),
                     rng.integers(0, ly, n)], axis=1)


def _near_diagonal(n=50_000):
    """About 1.3 pairs a base along a diagonal that drifts by indels."""
    rng = np.random.default_rng(11)
    lx = int(n / 1.3)
    x = np.sort(rng.integers(0, lx, n))
    y = np.maximum(x + rng.integers(-3, 4, n) + (x // 997) % 5, 0)
    w = rng.integers(100_000, 10_000_000, n)
    return np.stack([w, x, y], axis=1), lx, int(y.max()) + 1


CASES = {
    "empty": lambda: _pairs([]),
    "one_pair": lambda: _pairs([[5_000_000, 3, 4]]),
    "one_x": lambda: _pairs([[w, 7, y] for w, y in
                             [(10, 3), (900, 1), (40, 8), (900, 2)]]),
    "one_y": lambda: _pairs([[w, x, 5] for w, x in
                             [(10, 3), (900, 1), (40, 8), (900, 2)]]),
    "duplicate_rows": lambda: _pairs([[300, 1, 1], [500, 1, 1], [500, 2, 2],
                                      [300, 2, 2], [200, 0, 0], [200, 0, 0]]),
    "zero_weights": lambda: _pairs([[0, x, y] for x, y in
                                    [(0, 0), (1, 1), (2, 1), (3, 4), (1, 3)]]),
    "negative_weights": lambda: _pairs([[-5, 0, 0], [7, 1, 1], [-2, 2, 2], [-9, 3, 0],
                                        [4, 3, 3], [-1, 4, 2]]),
    "weight_ties": lambda: _pairs([[100, 0, 1], [100, 1, 0], [100, 2, 2], [100, 2, 3],
                                   [100, 3, 2], [200, 4, 4], [100, 5, 4]]),
    # a zero-weight chain ahead of a positive pair: no back link to it
    "zero_prefix": lambda: _pairs([[0, 0, 0], [0, 1, 1], [5, 2, 2], [0, 3, 1], [7, 4, 3]]),
    # equal prefix maxima in two Fenwick nodes (ranks 2 and 0, seen from
    # rank 3): the first met, the higher rank's, wins
    "fenwick_ties": lambda: _pairs([[100, 1, 0], [100, 0, 2], [50, 2, 3], [-10, 5, 1]]),
    **{f"random_{s}": (lambda s=s: _random(s)) for s in range(6)},
    # small weights on a small grid: many ties in weight, rank and x
    **{f"random_ties_{s}": (lambda s=s: _random(s, n=150, lx=12, ly=12) % [7, 12, 12]
                            - [3, 0, 0]) for s in range(3)},
}


@pytest.mark.parametrize("reweight", [False, True], ids=["raw", "reweighted"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_jax(case, reweight):
    pairs = CASES[case]()
    if reweight:
        lx = int(pairs[:, 1].max()) + 1 if len(pairs) else 0
        ly = int(pairs[:, 2].max()) + 1 if len(pairs) else 0
        pairs = tamap.reweight_aligned_pairs(pairs, lx, ly, 0.5)
    want = jamap.filter_pairs_to_ordered(pairs)
    got = tamap.filter_pairs_to_ordered(pairs)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_chain_matches_jax_near_diagonal():
    pairs, lx, ly = _near_diagonal()
    w = tamap.reweight_aligned_pairs(pairs, lx, ly, 0.5)
    for p in (pairs, w):
        got = tamap.filter_pairs_to_ordered(p)
        assert np.array_equal(got, jamap.filter_pairs_to_ordered(p))
        # the chain comes in strictly increasing x and y
        assert (np.diff(got[:, 1]) > 0).all() and (np.diff(got[:, 2]) > 0).all()


def test_library_built_under_its_key_and_loaded_once():
    """A fresh process filters twice: the library it maps is the one named by
    the hash of the source, the flags and the CPU, in build/torch_kernels/,
    and it was loaded once."""
    code = (
        "import numpy as np\n"
        "from cpecan_signal_tpu_torch.core import amap\n"
        "from cpecan_signal_tpu_torch.ops import _build\n"
        "p = np.array([[5, 0, 0], [6, 1, 1]])\n"
        "amap.filter_pairs_to_ordered(p); amap.filter_pairs_to_ordered(p)\n"
        "maps = {ln.split()[-1] for ln in open('/proc/self/maps') if 'libamap_chain' in ln}\n"
        "print(_build.host_library_path('amap_chain.cpp', amap.CHAIN_FLAGS))\n"
        "print(sorted(maps))\n"
        "print(amap.chain_library.cache_info().misses)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    path, maps, misses = res.stdout.split("\n")[:3]
    assert os.path.dirname(path) == os.path.join(REPO, "build", "torch_kernels")
    name = os.path.basename(path)
    assert name.startswith("libamap_chain_") and len(name) == len("libamap_chain_.so") + 16
    assert maps == repr([path]) and misses == "1"


def test_finish_record_counts_the_pairs_it_filters():
    from cpecan_signal_tpu_torch.cli.realign import finish_record
    from cpecan_signal_tpu_torch.io.cigar import CigarRecord
    from cpecan_signal_tpu_torch.models.params import AlignmentParams

    pairs = _random(3, n=300, lx=60, ly=60)
    aligned = SimpleNamespace(probs=pairs[:, 0], x=pairs[:, 1], y=pairs[:, 2])
    rec = CigarRecord("a", 0, 60, True, "b", 0, 60, True, 0.0, [("M", 60)])
    timing = {"amap.filter_pairs": 7}
    out = finish_record(rec, aligned, "A" * 60, "C" * 60, np.zeros((0, 2), np.int64),
                        AlignmentParams(gap_gamma=0.5), timing=timing)
    assert len(out) == 1
    assert timing["amap.filter_pairs"] == 7 + len(pairs)
    assert timing["tail.filter"] > 0


def test_filter_ns_reader():
    from portbench import run

    read = run.load_module(run.BENCH_DIR / "metrics" / "realign.filter_ns_per_pair.py").read
    timing = {"tail": 12.0, "tail.filter": 0.5, "amap.filter_pairs": 1_000_000}
    assert read({"window_s": 30.0, "timing": timing}) == pytest.approx(500.0)
    # a program without the counter (the filter's span alone)
    assert read({"window_s": 30.0, "timing": {"tail": 12.0, "tail.filter": 0.5}}) is None
    assert read({"window_s": 30.0}) is None
