"""The benchmark's generators: the same inputs from the same seed, the same
sizes from every seed, and statistics that hold to the port's own
synthetic generators."""

from __future__ import annotations

import numpy as np

from portbench.drivers import signal_inputs
from portbench.gen import genome_pair, signal

CONFIG = {"reference_bases": 200_000}
TRAFFIC = {"read_lengths": {"median": 2000, "sigma": 0.75, "min": 1000, "max": 50000},
           "substitutions": [0.01, 0.08], "indels": [0.005, 0.02]}


def _flat(inputs):
    out = [inputs["ref"], *inputs["models"]]
    for r in inputs["reads"]:
        out += [r["seq"], r["t_events"], r["t_map"], r["c_events"], r["c_map"]]
    return out


def test_signal_inputs_repeat_per_seed():
    big = 2 ** 31 + 12345
    a = signal_inputs.draw(CONFIG, TRAFFIC, big, 6)
    b = signal_inputs.draw(CONFIG, TRAFFIC, big, 6)
    c = signal_inputs.draw(CONFIG, TRAFFIC, big + 1, 6)
    assert all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    assert [r["guide"] for r in a["reads"]] == [r["guide"] for r in b["reads"]]
    assert not np.array_equal(a["ref"], c["ref"])


def test_every_seed_draws_the_same_lengths():
    la = sorted(len(r["seq"]) for r in signal_inputs.draw(CONFIG, TRAFFIC, 1, 8)["reads"])
    lb = sorted(len(r["seq"]) for r in signal_inputs.draw(CONFIG, TRAFFIC, 2, 8)["reads"])
    want = sorted(signal.read_lengths(8, 2000, 0.75, 1000, 50000))
    # a read's length moves by its indels only (0.5-2 %)
    assert np.allclose(la, want, rtol=0.04) and np.allclose(lb, want, rtol=0.04)


def test_every_seed_gives_the_reads_the_same_shape():
    """Two seeds draw other values but the same shapes: each read's guide
    and its events' count, so the same bands and buckets."""
    a = signal_inputs.draw(CONFIG, TRAFFIC, 11, 6)["reads"]
    b = signal_inputs.draw(CONFIG, TRAFFIC, 12, 6)["reads"]
    key = lambda r: len(r["seq"])  # noqa: E731
    for ra, rb in zip(sorted(a, key=key), sorted(b, key=key)):
        assert ra["guide"]["ops"] == rb["guide"]["ops"]
        assert np.array_equal(ra["t_map"], rb["t_map"])
        assert len(ra["c_events"]) == len(rb["c_events"])
        assert not np.array_equal(ra["t_events"], rb["t_events"])


def test_every_seed_pairs_lengths_with_the_same_rates():
    r = signal.error_rates(64, (0.01, 0.08), (0.005, 0.02))
    assert r.shape == (64, 2)
    assert r[:, 0].min() >= 0.01 and r[:, 0].max() <= 0.08
    assert r[:, 1].min() >= 0.005 and r[:, 1].max() <= 0.02
    # spread over the range, not following the length
    assert abs(np.corrcoef(np.arange(64), r[:, 1])[0, 1]) < 0.2
    assert np.histogram(r[:, 1], bins=4, range=(0.005, 0.02))[0].min() >= 12


def test_read_lengths_are_lognormal_quantiles():
    n = signal.read_lengths(64, 6000, 0.75, 1000, 50000)
    assert len(n) == 64 and abs(np.median(n) - 6000) <= 2 and n.min() >= 1000 and n.max() <= 50000
    assert 7000 < n.mean() < 9000


def test_events_hold_to_the_port_generator():
    """Events per k-mer and the level, noise and duration statistics of the
    frozen copy agree with synthetic.simulate_events on one target."""
    from cpecan_signal_tpu_torch import synthetic
    from cpecan_signal_tpu_torch.models.pore_model import PoreModel

    rng = np.random.default_rng(7)
    model = signal.pore_model(rng)
    codes = signal.random_codes(rng, 30_000)
    ev, first = signal.simulate_events(model, signal.kmer_ranks(codes), np.random.default_rng(8))
    pad = np.concatenate([model, np.zeros((2, 5))])
    pm = PoreModel(0.0, pad, 0.0, pad.copy(), np.full(60, 0.1))
    ev2, path = synthetic.simulate_events(pm, signal.to_str(codes), np.random.default_rng(8))
    n_kmers = len(codes) - signal.K + 1
    assert abs(len(ev) / n_kmers - len(ev2) / n_kmers) < 0.02
    ranks = signal.kmer_ranks(codes)
    lvl2 = ev2[:, 0] - model[ranks[path[:, 0]], 0]
    # a skipped k-mer repeats the first event of the k-mer before it
    visited = np.flatnonzero(np.r_[True, np.diff(first) > 0])
    kmer_of = visited[np.searchsorted(first[visited], np.arange(len(ev)), side="right") - 1]
    lvl = ev[:, 0] - model[ranks[kmer_of], 0]
    assert abs(lvl.std() - lvl2.std()) < 0.02 and abs(lvl.mean()) < 0.02
    for col in (1, 2):
        assert abs(ev[:, col].mean() - ev2[:, col].mean()) < 0.02 * ev2[:, col].mean()
    assert first[0] == 0 and (np.diff(first) >= 0).all() and first[-1] < len(ev)


def test_guide_ops_walk_the_truth():
    rng = np.random.default_rng(3)
    x = signal.random_codes(rng, 5000)
    _y, truth = signal.evolve_with_truth(x, rng, 0.05, 0.01, 0.01)
    pairs, px, py = [], int(truth[0, 0]), int(truth[0, 1])
    for op, n in signal.guide_ops(truth):
        if op == "M":
            pairs += [(px + i, py + i) for i in range(n)]
            px, py = px + n, py + n
        elif op == "D":
            px += n
        else:
            py += n
    assert np.array_equal(np.asarray(pairs), truth)


def test_genome_pair_records_cover_x():
    rng = np.random.default_rng(11)
    lengths = genome_pair.record_lengths(60_000, 2000, 20_000)
    assert lengths.sum() == 60_000
    pair = genome_pair.genome_pair(rng, 60_000, (0.05, 0.005, 0.005), lengths, 0.3)
    recs = pair["records"]
    assert [r["x1"] for r in recs[1:]] == [r["x2"] for r in recs[:-1]]
    assert sum(not r["forward"] for r in recs) == round(0.3 * len(recs))
    comp = str.maketrans("ACGT", "TGCA")
    for r in recs:
        y = pair["y"][r["c"]:r["d"]]
        if not r["forward"]:
            y = y.translate(comp)[::-1]
        xs, ys, same = 0, 0, 0
        for op, n in r["ops"]:
            if op == "M":
                seg_x = pair["x"][r["x1"] + xs:r["x1"] + xs + n]
                same += sum(a == b for a, b in zip(seg_x, y[ys:ys + n]))
                xs, ys = xs + n, ys + n
            elif op == "D":
                xs += n
            else:
                ys += n
        assert (xs, ys) == (r["x2"] - r["x1"], r["d"] - r["c"])
        assert same / (r["x2"] - r["x1"]) > 0.9
