"""The nucleotide EM cell's program path (``cli/em.em_iteration``) against
the benchmark's plain reference (``portbench/reference/nucleotide_em.py``),
on the CPU at a small size: a 400-base genome pair cut into records of
100-200 bases, through the cell's own driver (``portbench/drivers/
nucleotide_em.py``), the program's plain versions in f32.

  * iterations 0 and 1 (the second from the model the first trained)
    within the cell's limits (``portbench/limits/realign.em_1mb.json``), on
    a small and a large seed;
  * the control (the reference in bfloat16 in the program's place) and each
    planted fault of ``portbench/faults_nem.py`` fail at least one limit;
  * the reference's tallies equal the port's f64 oracle's (``engine="host"``)
    to 1e-9: both are exact log-space sums in f64;
  * the reference loads a model into the machine's tables as the program
    does (``cli/realign.sm5_from_hmm``), the short and long gaps traded too;
  * ``expectation_maximisation``'s model equals two ``em_iteration`` calls
    by hand, bit for bit, and each record's tallies sum to the chunk's.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from cpecan_signal_tpu_torch.cli import em as tem
from cpecan_signal_tpu_torch.cli.realign import record_expectations, sm5_from_hmm
from cpecan_signal_tpu_torch.em.accumulators import DiscreteHmm
from cpecan_signal_tpu_torch.io.fasta import write_fasta
from portbench import faults_nem, run
from portbench import trace as tr
from portbench.reference import nucleotide_em as ref_em

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "realign.em_1mb"
SMALL = ({"record_lengths": [100, 200]}, {"x_bases": 400})
ORACLE_RTOL = 1e-9


def small_cell(seed):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = run.cell_spec(bench, WORKLOAD)
    return run.make_cell(spec, WORKLOAD, seed, CPU, *SMALL), spec["limits"]


def set_up(seed):
    cell, limits = small_cell(seed)
    cell.setup(tr.Spans(traced=False))
    return cell, limits


@pytest.fixture(scope="module")
def sound():
    cell, limits = set_up(5)
    return cell, limits, cell.check()


def _failing(numbers, limits):
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 9])
def test_em_iterations_hold_to_the_reference(seed, sound):
    if seed == 5:
        cell, limits, numbers = sound
    else:
        cell, limits = set_up(seed)
        numbers = cell.check()
    assert set(numbers) == set(limits)
    assert not _failing(numbers, limits), numbers
    # iteration 1 ran on the model iteration 0 trained, not the start
    assert not np.allclose(cell.recorded[0][2][0], cell.start[0])


@pytest.mark.parametrize("fault", ["bfloat16", *sorted(faults_nem.FAULTS)])
def test_control_and_faults_fail_a_limit(fault, sound):
    if fault == "bfloat16":
        cell, limits, _numbers = sound
        numbers = cell.control(torch.bfloat16)
    else:
        undo = faults_nem.plant(fault)
        try:
            cell, limits = set_up(33)
        finally:
            undo()
        numbers = cell.check()
    assert _failing(numbers, limits), numbers


def test_reference_matches_the_f64_oracle(sound):
    cell, _limits, _numbers = sound
    hmm = DiscreteHmm(transitions=cell.start[0].copy(), emissions=cell.start[1].copy())
    per_record = []
    tem.em_iteration(cell.chunks, cell.seqs, cell.params, hmm, CPU, engine="host",
                     per_record=per_record)
    for i, (rt, re_, rl) in zip(cell.compared, cell.reference[0][0]):
        ht, he, hl = per_record[i]
        np.testing.assert_allclose(ht, rt, rtol=ORACLE_RTOL, atol=1e-12)
        np.testing.assert_allclose(he, re_, rtol=ORACLE_RTOL, atol=1e-12)
        assert hl == pytest.approx(rl, rel=ORACLE_RTOL)


@pytest.mark.parametrize("swap", [False, True])
def test_reference_loads_a_model_as_the_program_does(swap):
    rng = np.random.default_rng(11)
    hmm = DiscreteHmm.empty(5, 4)
    hmm.randomize(rng)
    t = hmm.transitions
    short, long_ = (t[1, 1] + t[2, 2]) / 2, (t[3, 3] + t[4, 4]) / 2
    if (short > long_) != swap:        # make the short gap's extend the larger, or not
        t[[1, 2, 3, 4]] = t[[3, 4, 1, 2]]
        t[:, [1, 2, 3, 4]] = t[:, [3, 4, 1, 2]]
    sm = sm5_from_hmm(hmm)
    edge_t, end, match, gap = ref_em.machine(hmm.transitions, hmm.emissions)
    assert [(e[0], e[1], e[2]) for e in ref_em.EDGES] == \
        [(e.src, e.frm, e.to) for e in sm.spec.edges]
    np.testing.assert_allclose(edge_t, [sm.tvals[e.tkeys[0]].val for e in sm.spec.edges],
                               rtol=1e-14)
    np.testing.assert_allclose(end, sm.ragged_end, rtol=1e-14)
    mt, gx, gy = sm.symbol_tables
    np.testing.assert_allclose(match, mt, rtol=1e-14)
    np.testing.assert_allclose(gap, gx, rtol=1e-14)
    np.testing.assert_allclose(gap, gy, rtol=1e-14)


def test_expectation_maximisation_runs_through_em_iteration(sound, tmp_path):
    cell, _limits, _numbers = sound
    fasta = tmp_path / "pair.fa"
    write_fasta(str(fasta), list(cell.seqs.items()))
    cig = tmp_path / "pair.cig"
    cig.write_text("".join(r.to_line() + "\n" for r in cell.chunks[0]))
    got = tem.expectation_maximisation(str(cig), [str(fasta)], str(tmp_path / "m.hmm"),
                                       iterations=2, trials=1, seed=9,
                                       set_jukes_cantor_divergence=0.3, params=cell.params,
                                       device=CPU, log=lambda _m: None)
    rng = np.random.default_rng(9)
    hmm = DiscreteHmm.empty(5, 4)
    hmm.randomize(rng)
    tem.set_jukes_cantor(hmm, 0.3)
    chunks = tem.chunk_alignments(cell.chunks[0])
    running = []
    for _ in range(2):
        hmm = tem.em_iteration(chunks, cell.seqs, cell.params, hmm, CPU)
        running.append(hmm.likelihood)
    assert np.array_equal(got.transitions, hmm.transitions)
    assert np.array_equal(got.emissions, hmm.emissions)
    assert got.running_likelihoods == running


def test_per_record_tallies_sum_to_the_chunk(sound):
    cell, _limits, _numbers = sound
    acc = DiscreteHmm.empty(5, 4)
    per_record = []
    record_expectations(cell.chunks[0], cell.seqs, cell.params, cell.hmm, acc, device=CPU,
                        per_record=per_record)
    assert len(per_record) == len(cell.chunks[0])
    np.testing.assert_allclose(sum(r[0] for r in per_record), acc.transitions, rtol=1e-12)
    np.testing.assert_allclose(sum(r[1] for r in per_record), acc.emissions, rtol=1e-12)
    assert math.isclose(sum(r[2] for r in per_record), acc.likelihood, rel_tol=1e-12)
    # the list leaves the chunk's sum as it was
    again = DiscreteHmm.empty(5, 4)
    record_expectations(cell.chunks[0], cell.seqs, cell.params, cell.hmm, again, device=CPU)
    assert np.array_equal(again.transitions, acc.transitions)
    assert np.array_equal(again.emissions, acc.emissions) and again.likelihood == acc.likelihood
