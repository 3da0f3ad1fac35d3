"""PyTorch port: the realign heads' anchor pass on whole arrays gives what the
JAX package's per-anchor loops give.

  * ``core/anchors.filter_to_remove_overlap``, ``get_split_points`` and
    ``cigar_to_anchor_pairs`` against the JAX package's copies, element for
    element, on edge cases and seeded random inputs; the same exceptions on
    the same inputs;
  * ``cli/realign.stage_record_head`` and ``record_jobs`` against the JAX
    CLI's ``stage_record_head`` and split collection on a synthetic 20 kb
    pair with forward and reverse records and lower-case and ``N`` bases
    planted on anchor positions: anchors, split offsets, bands;
  * the counter ``head.anchors`` and its benchmark reader.
"""

import numpy as np
import pytest

from cpecan_signal_tpu.cli import realign as jrealign
from cpecan_signal_tpu.core import anchors as janchors
from cpecan_signal_tpu.em.discrete_pallas import collect_symbol_split_jobs as jcollect
from cpecan_signal_tpu.io.cigar import CigarRecord as JRec
from cpecan_signal_tpu.models.params import AlignmentParams as JParams
from cpecan_signal_tpu_torch.cli import realign as trealign
from cpecan_signal_tpu_torch.core import anchors as tanchors
from cpecan_signal_tpu_torch.io.cigar import CigarRecord as TRec
from cpecan_signal_tpu_torch.models.params import AlignmentParams as TParams
from portbench.gen import genome_pair as gen

TRIM = 14


def _same_pairs(got, want):
    assert got.dtype == np.int64 and got.shape == want.shape
    assert np.array_equal(got, want)


def _sorted(p):
    p = np.asarray(p, dtype=np.int64).reshape(-1, 2)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


# ---------------------------------------------------------------------------
# filter_to_remove_overlap
# ---------------------------------------------------------------------------

def _random_ties(seed, n=2000):
    """n sorted pairs near a diagonal, drawn from few values: many equal x,
    equal y and equal pairs."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, n // 3, n)
    return _sorted(np.stack([x, x + rng.integers(-4, 5, n)], axis=1))


OVERLAP_CASES = {
    "empty": np.zeros((0, 2), np.int64),
    "one": [[3, 7]],
    "all_equal_x": [[5, y] for y in range(8)],
    "all_equal_y": [[x, 5] for x in range(8)],
    "duplicate_runs": [[0, 0], [0, 0], [1, 1], [1, 1], [1, 1], [2, 3], [2, 3], [4, 4]],
    "equal_to_later_kept": [[1, 1], [1, 1], [2, 2]],
    "increasing": [[i, 2 * i + 1] for i in range(12)],
    "decreasing": [[i, 20 - i] for i in range(12)],
    "crossing": [[0, 5], [1, 1], [1, 2], [2, 0], [3, 3], [3, 9], [4, 4], [6, 5]],
    **{f"random_{s}": _random_ties(s) for s in range(6)},
}


@pytest.mark.parametrize("case", sorted(OVERLAP_CASES))
def test_filter_to_remove_overlap_matches_jax(case):
    pairs = np.asarray(OVERLAP_CASES[case], dtype=np.int64).reshape(-1, 2)
    _same_pairs(tanchors.filter_to_remove_overlap(pairs),
                janchors.filter_to_remove_overlap(pairs))


def test_filter_to_remove_overlap_unsorted_input_matches_jax():
    """Callers that pass pairs out of order (equal pairs apart) get what the
    loops give too: the first (1, 1) passes pass 1 through its later twin."""
    twin = np.array([[1, 1], [0, 5], [1, 1], [2, 2]], dtype=np.int64)
    _same_pairs(tanchors.filter_to_remove_overlap(twin), twin[:1])
    _same_pairs(janchors.filter_to_remove_overlap(twin), twin[:1])
    for seed in range(6):
        pairs = np.random.default_rng(seed).permutation(_random_ties(seed, 300))
        _same_pairs(tanchors.filter_to_remove_overlap(pairs),
                    janchors.filter_to_remove_overlap(pairs))
        lists = pairs.tolist()                        # not an array: converted the same
        _same_pairs(tanchors.filter_to_remove_overlap(lists),
                    janchors.filter_to_remove_overlap(lists))


# ---------------------------------------------------------------------------
# get_split_points
# ---------------------------------------------------------------------------

def _split_cases():
    flags = [(rl, rr) for rl in (False, True) for rr in (False, True)]
    cases = {}
    for rl, rr in flags:
        cases[f"none_{rl}_{rr}"] = (np.zeros((0, 2)), 40, 50, 100, rl, rr, None)
        cases[f"none_split_{rl}_{rr}"] = (np.zeros((0, 2)), 40, 50, 10, rl, rr, None)
        cases[f"one_{rl}_{rr}"] = ([[7, 9]], 40, 50, 100, rl, rr, None)
        cases[f"first_gap_{rl}_{rr}"] = ([[30, 35], [31, 36]], 40, 50, 100, rl, rr, None)
    # a gap from (1, 1) to (10, 12) is 9 x 11 = 99, to (11, 11) 100, to
    # (2, 102) 1 x 101: just under, at and just over a cap of 100
    for name, (x, y) in {"under": (10, 12), "at": (11, 11), "over": (2, 102)}.items():
        for rl, rr in flags:
            cases[f"cap_{name}_{rl}_{rr}"] = ([[0, 0], [x, y], [x + 1, y + 1]], x + 3, y + 3,
                                              100, rl, rr, None)
    anchors = [[0, 0], [20, 25], [21, 26], [60, 61], [62, 90]]
    for dim in (1, 2, 3, 10, 30):
        for rl, rr in flags:
            cases[f"gap_dim_{dim}_{rl}_{rr}"] = (anchors, 70, 100, 10**6, rl, rr, dim)
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(50, 400))
        xs = np.cumsum(rng.integers(1, 60, n)) - 1
        ys = np.cumsum(rng.integers(1, 60, n)) - 1
        dim = None if seed % 2 else int(rng.integers(1, 40))
        cases[f"random_{seed}"] = (np.stack([xs, ys], axis=1), int(xs[-1] + rng.integers(1, 200)),
                                   int(ys[-1] + rng.integers(1, 200)), int(rng.integers(50, 900)),
                                   bool(seed & 1), bool(seed & 2), dim)
    return cases


SPLIT_CASES = _split_cases()


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_get_split_points_matches_jax(case):
    anchors, lX, lY, cap, rl, rr, dim = SPLIT_CASES[case]
    anchors = np.asarray(anchors, dtype=np.int64).reshape(-1, 2)
    got = tanchors.get_split_points(anchors, lX, lY, cap, rl, rr, max_gap_min_dim=dim)
    want = janchors.get_split_points(anchors, lX, lY, cap, rl, rr, max_gap_min_dim=dim)
    assert got == want
    assert all(type(v) is int for rect in got for v in rect)


@pytest.mark.parametrize("anchors", [[[5, 5], [4, 8]], [[5, 5], [8, 5]], [[5, 5], [40, 6]],
                                     [[5, 5], [6, 50]], [[-1, 2]], [[0, 0], [3, 3], [2, 9]]],
                         ids=["x_back", "y_repeat", "x_out", "y_out", "negative", "late"])
def test_get_split_points_bad_anchor_raises(anchors):
    anchors = np.asarray(anchors, dtype=np.int64)
    for mod in (janchors, tanchors):
        with pytest.raises(AssertionError):
            mod.get_split_points(anchors, 40, 50, 10, True, True)


# ---------------------------------------------------------------------------
# cigar_to_anchor_pairs
# ---------------------------------------------------------------------------

CIGARS = {
    "blocks": [("M", 10), ("I", 3), ("M", 7), ("D", 4), ("M", 30), ("I", 1), ("D", 2),
               ("M", 5)],
    "zero_length": [("M", 0), ("I", 0), ("M", 6), ("D", 0), ("M", 0), ("M", 9)],
    "gaps_only": [("I", 5), ("D", 7), ("I", 2)],
    "empty": [],
    "one_block": [("M", 28)],
}


@pytest.mark.parametrize("trim", [0, 1, 3, 4, 5, 14, 15, 40])
@pytest.mark.parametrize("case", sorted(CIGARS))
def test_cigar_to_anchor_pairs_matches_jax(case, trim):
    """Trims of 0, of half a block (a 28-base block at 14, a 10-base block at
    5) and of more than half a block."""
    for start in ((0, 0), (17, 1000)):
        _same_pairs(tanchors.cigar_to_anchor_pairs(*start, CIGARS[case], trim),
                    janchors.cigar_to_anchor_pairs(*start, CIGARS[case], trim))


def test_cigar_to_anchor_pairs_unknown_op_raises():
    ops = [("M", 20), ("X", 3), ("M", 5)]
    for mod in (janchors, tanchors):
        with pytest.raises(ValueError, match="unknown cigar op 'X'"):
            mod.cigar_to_anchor_pairs(0, 0, ops, 2)


# ---------------------------------------------------------------------------
# stage_record_head and record_jobs on a 20 kb pair
# ---------------------------------------------------------------------------

def _plant(seqs, recs, rng):
    """``seqs`` with bases lower-cased or set to N (or n) on both sides of
    some of the records' anchors, and lower-cased at random elsewhere."""
    arr = {k: np.frombuffer(v.encode("ascii"), dtype=np.uint8).copy() for k, v in seqs.items()}
    for rec in _records(TRec, recs):
        anchors = trealign.stage_record_head(rec, seqs, _params(TParams), None)[2]
        pick = anchors[rng.random(len(anchors)) < 0.04]
        gx = rec.start1 + pick[:, 0]
        gy = rec.start2 + pick[:, 1] if rec.strand2 else rec.start2 - 1 - pick[:, 1]
        kind = rng.integers(0, 4, len(pick))    # 0: x lower, 1: both lower, 2: N, 3: n
        for g, k, mine in ((gx, "X", (kind == 0) | (kind == 1)), (gy, "Y", kind == 1)):
            arr[k][g[mine]] = np.char.lower(arr[k][g[mine]].view("S1")).view(np.uint8)
        for g, k in ((gx, "X"), (gy, "Y")):
            arr[k][g[kind == 2]] = ord("N")
            arr[k][g[kind == 3]] = ord("n")
    for v in arr.values():
        low = rng.random(len(v)) < 0.05
        v[low] = np.char.lower(v[low].view("S1")).view(np.uint8)
    return {k: v.tobytes().decode("ascii") for k, v in arr.items()}


@pytest.fixture(scope="module")
def pair_20kb():
    rng = np.random.default_rng(20_000)
    pair = gen.genome_pair(rng, 20_000, (0.05, 0.005, 0.005),
                           gen.record_lengths(20_000, 2000, 8000), 0.4)
    recs = [(r["x1"], r["x2"], r["c"] if r["forward"] else r["d"],
             r["d"] if r["forward"] else r["c"], r["forward"], list(r["ops"]))
            for r in pair["records"]]
    assert any(r[4] for r in recs) and not all(r[4] for r in recs)
    return _plant({"X": pair["x"], "Y": pair["y"]}, recs, rng), recs


def _records(cls, recs):
    return [cls("X", x1, x2, True, "Y", s2, e2, fwd, 0.0, list(ops))
            for x1, x2, s2, e2, fwd, ops in recs]


def _params(cls):
    # the realign cells' settings; a split cap that the planted N's gaps reach
    return cls(gap_gamma=0.5, diagonal_expansion=20, constraint_diagonal_trim=TRIM,
               split_matrix_bigger_than_this=40 ** 2)


def test_stage_record_head_matches_jax(pair_20kb):
    seqs, recs = pair_20kb
    dropped = 0
    for jrec, trec in zip(_records(JRec, recs), _records(TRec, recs)):
        want = jrealign.stage_record_head(jrec, seqs, _params(JParams), None)
        got = trealign.stage_record_head(trec, seqs, _params(TParams), None)
        assert got[0] == want[0] and got[1] == want[1]
        _same_pairs(got[2], want[2])
        _same_pairs(got[3], want[3])
        sub_x, sub_y, anchors_all = got[:3]
        bx = np.array([sub_x[x] for x in anchors_all[:, 0]])
        by = np.array([sub_y[y] for y in anchors_all[:, 1]])
        # the planted bases sit on anchors: matches in other cases stay,
        # N against N (in either case) goes
        assert (np.char.islower(bx) & (bx != "n") & (np.char.upper(bx) == np.char.upper(by))
                & (bx != by)).any()
        n_n = np.isin(bx, ["N", "n"]) & np.isin(by, ["N", "n"])
        assert (n_n & (bx != by)).any()
        dropped += int(n_n.sum())
    assert dropped > 0


def test_record_jobs_match_jax_split_collection(pair_20kb):
    seqs, recs = pair_20kb
    jparams, tparams = _params(JParams), _params(TParams)
    want = []
    for rec in _records(JRec, recs):
        sub_x, sub_y, _, anchors, make_sm = jrealign.stage_record_head(rec, seqs, jparams, None)
        want.append(jcollect(make_sm, sub_x, sub_y, anchors, jparams, ragged_left=True,
                             ragged_right=True))
    timing = {}
    heads, spans, jobs = trealign.record_jobs(_records(TRec, recs), seqs, tparams, None, timing)
    assert len(heads) == len(spans) == len(want)
    assert sum(len(w) for w in want) > len(want)          # some records split
    for span, wjobs in zip(spans, want):
        tjobs = jobs[span]
        assert len(tjobs) == len(wjobs)
        for t, w in zip(tjobs, wjobs):
            assert (t.off_x, t.off_y, t.ragged_left, t.ragged_right) == \
                (w.off_x, w.off_y, w.ragged_left, w.ragged_right)
            for field in ("xmyL", "xmyR", "lX", "lY"):
                assert np.array_equal(np.asarray(getattr(t.band, field)),
                                      np.asarray(getattr(w.band, field))), field
            for tc, wc in zip(t.sm.symbol_codes, w.sm.symbol_codes):
                assert np.array_equal(tc, wc)


def test_head_anchors_counter_counts_cigar_anchors(pair_20kb):
    """``head.anchors`` is the anchors the CIGARs give before the mismatch
    filter: each match block's length less twice the trim, added up."""
    seqs, recs = pair_20kb
    by_hand = sum(max(n - 2 * TRIM, 0) for *_, ops in recs for op, n in ops if op == "M")
    timing = {"head.anchors": 5}
    trealign.record_jobs(_records(TRec, recs), seqs, _params(TParams), None, timing)
    assert timing["head.anchors"] == 5 + by_hand
    assert timing["head.stage"] > 0 and timing["head.split"] > 0


def test_head_ns_per_anchor_reader():
    from portbench import run

    read = run.load_module(run.BENCH_DIR / "metrics" / "realign.head_ns_per_anchor.py").read
    timing = {"head": 0.5, "head.stage": 0.3, "head.anchors": 2_000_000}
    assert read({"window_s": 30.0, "timing": timing}) == pytest.approx(250.0)
    # a program without the counter (the heads' span alone)
    assert read({"window_s": 30.0, "timing": {"head": 0.5, "head.stage": 0.3}}) is None
    assert read({"window_s": 30.0}) is None
