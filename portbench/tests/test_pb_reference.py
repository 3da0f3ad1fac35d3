"""The plain references: held to the port's f64 oracle cell by cell, and to
the program's plain path on the CPU; importing nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers import em_iterations, signal_inputs
from portbench.reference import band as bd
from portbench.reference import nucleotide as nuc
from portbench.reference import signal as rs

CPU = torch.device("cpu")
CONFIG = {"reference_bases": 20_000,
          "settings": {"diagonal_expansion": 50, "constraint_trim": 14, "threshold": 0.01,
                       "split_matrix_bigger_than_this": 9_000_000}}
TRAFFIC = {"read_lengths": {"median": 300, "sigma": 0.2, "min": 200, "max": 400},
           "substitutions": [0.01, 0.08], "indels": [0.005, 0.02]}
REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "cpecan_signal_tpu",
                                               "cpecan_signal_tpu_torch"), (path.name, n)


def test_overlap_filter_and_band_match_the_port():
    from cpecan_signal_tpu_torch.core.anchors import filter_to_remove_overlap
    from cpecan_signal_tpu_torch.core.band import band_construct

    rng = np.random.default_rng(0)
    for _ in range(20):
        p = np.sort(rng.integers(0, 300, (60, 2)), axis=0)
        p[::7] = p[::7][:, ::-1]
        p = p[np.lexsort((p[:, 1], p[:, 0]))]
        assert np.array_equal(bd.filter_to_remove_overlap(p), filter_to_remove_overlap(p))
        chain = filter_to_remove_overlap(p)
        chain = chain[(chain[:, 0] < 290) & (chain[:, 1] < 280)]
        b = band_construct(chain, 300, 290, 20)
        L, R = bd.band(chain, 300, 290, 20)
        assert np.array_equal(L, b.xmyL) and np.array_equal(R, b.xmyR)


def _one_signal_job():
    inputs = signal_inputs.draw(CONFIG, TRAFFIC, 31, 1)
    prog = signal_inputs.Program(inputs, CONFIG)
    strands = rs.strands(inputs["reads"][0], inputs["ref"], 0, 14)
    return inputs, prog, strands


def test_signal_forward_backward_match_the_port_oracle():
    """F and the match posteriors of one threeState job against the port's
    f64 oracle (engine/fb.py) at every band cell."""
    from cpecan_signal_tpu_torch.cli.vanilla_align import strand_jobs
    from cpecan_signal_tpu_torch.engine import fb

    inputs, prog, strands = _one_signal_job()
    job = strand_jobs(prog.prepare(0)["strand_ctx"][0], prog.params)[0]
    plan, inp = fb.prepare_inputs(job.sm, job.band, ragged_left=True, ragged_right=True,
                                  device=CPU)
    F = fb.forward(plan, inp).numpy()
    B = fb.backward(plan, inp)
    p_oracle, _t = fb.posterior_match_probs(plan, inp, torch.as_tensor(F), B)
    problems = rs.SignalProblems(strands[:1], inputs["models"], 50, 9_000_000, CPU)
    h = problems.hmm([(None, None), (None, None)])
    h.forward()
    h.backward()
    j = problems.jobs[0]
    assert np.array_equal(j.xmyL, job.band.xmyL) and np.array_equal(j.xmyR, job.band.xmyR)
    for d in range(0, j.lX + j.lY + 1, 7):
        w = (j.xmyR[d] - j.xmyL[d]) // 2 + 1
        mine = h._view(h.F, d)[0, :, :w].numpy().T
        np.testing.assert_allclose(mine, F[d, :w], rtol=1e-9, atol=1e-9)
    x, y, p = h.match_pairs(0.01)[0]
    po = p_oracle.numpy()
    xo, yo = inp.x.numpy(), inp.y.numpy()
    keep = po >= 0.01
    want = dict(zip(zip(xo[keep] - 1, yo[keep] - 1), po[keep]))
    got = dict(zip(zip(x.tolist(), y.tolist()), p))
    assert want.keys() == got.keys()
    assert max(abs(want[k] - got[k]) for k in want) < 1e-9


def test_symbol_posteriors_match_the_port_oracle():
    from cpecan_signal_tpu_torch.engine.align import align_sequence_pair
    from cpecan_signal_tpu_torch.models.params import AlignmentParams
    from cpecan_signal_tpu_torch.models.state_machines import (bind_symbol_sequences,
                                                               make_symbol_sm5)

    from portbench.gen import signal as gen
    rng = np.random.default_rng(4)
    x = gen.random_codes(rng, 700)
    y, truth = gen.evolve_with_truth(x, rng, 0.05, 0.005, 0.005)
    rec = {"contig1": "X", "start1": 0, "end1": 700, "strand1": True, "contig2": "Y",
           "start2": 0, "end2": len(y), "strand2": True,
           "ops": [("D", int(truth[0, 0]))] * int(truth[0, 0] > 0) + gen.guide_ops(truth)}
    seqs = {"X": gen.to_str(x), "Y": gen.to_str(y)}
    sx, sy, anchors = nuc.head(rec, seqs, 14)

    def mk(a, b):
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, a, b)
        return sm
    want = align_sequence_pair(mk, sx, sy, anchors, AlignmentParams(), ragged_left=True,
                               ragged_right=True, device=CPU)
    got = nuc.RealignProblems([(sx, sy, anchors)], 20, 3000 ** 2, CPU).pairs(0.01, 1)[0]
    w = {(a, b): p for p, a, b in zip(want.probs, want.x, want.y)}
    g = {(a, b): p for p, a, b in got.tolist()}
    assert len(w.keys() ^ g.keys()) <= 1
    assert max(abs(w[k] - g[k]) for k in w.keys() & g.keys()) <= 2


def test_heaviest_chain_matches_the_port_filter():
    from cpecan_signal_tpu_torch.core.amap import filter_pairs_to_ordered, reweight_aligned_pairs

    rng = np.random.default_rng(5)
    for _ in range(10):
        pairs = np.stack([rng.integers(1, 10_000_000, 300), rng.integers(0, 80, 300),
                          rng.integers(0, 80, 300)], axis=1)
        pairs = pairs[np.unique(pairs[:, 1:], axis=0, return_index=True)[1]]
        assert np.array_equal(nuc.reweight(pairs, 80, 80, 0.5),
                              reweight_aligned_pairs(pairs, 80, 80, 0.5))
        assert np.array_equal(nuc.heaviest_chain(pairs), filter_pairs_to_ordered(pairs))


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_em_reference_holds_to_the_program_on_the_cpu(seed):
    """Iterations 0 and 1 of the program's E-step (plain versions, CPU)
    against the reference's, within the program's f32 drift."""
    from portbench.tests.small import run_small
    rc, res = run_small("sigalign.em", seed=seed)
    assert rc == 0 and res["correct"]
    assert res["checks"]["likelihood_rel"]["value"] < 1e-4
    assert res["checks"]["transition_rel"]["value"] < 1e-3


def test_compare_reads_nan_as_infinite():
    z = (np.eye(3), np.ones(4096), -1.0)
    nan = (np.full((3, 3), np.nan), np.ones(4096), -1.0)
    got = em_iterations.compare([[nan, z]], [[z, z]])
    assert got["transition_rel"] == float("inf")
