"""PyTorch port: the nucleotide CLIs on the CPU against the JAX CLIs.

Records are tests/test_em_nucleotide.py-style: random sequence pairs (5-8 %
substitutions, 2 % deletions), guide CIGARs from the seed-chain anchors,
one record of each set on the reverse strand of its second sequence.

  * (e) cli/realign.main against the JAX CLI's device route (``--engine
    pallas``, interpret mode) on the same stdin CIGARs: the CIGAR lines
    equal; ``--outputExpectations`` within the E-step tolerances of
    tests/test_torch_discrete.py (trans and emiss rtol 1e-4 + atol 1e-5 on
    the file's 6 printed decimals, likelihood 1e-5 relative);
  * (f) cli/em.expectation_maximisation against the JAX one (``engine=
    "pallas"``): each iteration's likelihood within 1e-4 relative, the final
    transitions and emissions within atol 1e-4, the lastz scoring matrix
    written from it equal; and EM's guarantee that the likelihood does not fall;
  * the Hmm utilities (chunking, Jukes-Cantor start, tied emissions) equal
    the JAX CLI's;
  * (g) what is not ported raises NotImplementedError naming its ROADMAP
    item: the host engine (``--engine host``, ``--matchGamma``,
    ``realign_record``), ``update_band`` and SIGALIGN_COORDINATOR.
"""

import io

import numpy as np
import pytest

from cpecan_signal_tpu.cli import em as jem
from cpecan_signal_tpu.cli import realign as jrealign
from cpecan_signal_tpu_torch.anchor.seed_chain import get_anchor_pairs
from cpecan_signal_tpu_torch.cli import em as tem
from cpecan_signal_tpu_torch.cli import realign as trealign
from cpecan_signal_tpu_torch.core.amap import pairs_to_cigar_ops
from cpecan_signal_tpu_torch.em.accumulators import DiscreteHmm
from cpecan_signal_tpu_torch.io.cigar import CigarRecord, parse_cigar_line
from cpecan_signal_tpu_torch.io.fasta import reverse_complement, write_fasta
from cpecan_signal_tpu_torch.models.params import AlignmentParams
from cpecan_signal_tpu_torch.ops import fb_kernels as fk

STEP_RTOL, STEP_ATOL, LIK_RTOL = 1e-4, 1e-5, 1e-5
EM_LIK_RTOL, EM_ATOL = 1e-4, 1e-4


def write_records(tmp_path, n, n_bases, seed, reverse=(1,)):
    """n records of n_bases-base pairs; the records in ``reverse`` align x
    to the reverse strand of y (strand2 False, start2 > end2).  Returns
    (fasta path, CIGAR text)."""
    rng = np.random.default_rng(seed)
    seqs, lines = [], []
    for i in range(n):
        sx = "".join(rng.choice(list("ACGT"), n_bases))
        sy = "".join((c if rng.random() > 0.07 else rng.choice(list("ACGT")))
                     for c in sx if rng.random() > 0.02)
        anchors = get_anchor_pairs(sx, sy, k=8)
        pairs = np.concatenate([np.ones((len(anchors), 1), dtype=np.int64), anchors], axis=1)
        ops = pairs_to_cigar_ops(pairs, len(sx), len(sy))
        if i in reverse:
            seqs += [(f"x{i}", sx), (f"y{i}", reverse_complement(sy))]
            rec = CigarRecord(f"x{i}", 0, len(sx), True, f"y{i}", len(sy), 0, False, 0.0, ops)
        else:
            seqs += [(f"x{i}", sx), (f"y{i}", sy)]
            rec = CigarRecord(f"x{i}", 0, len(sx), True, f"y{i}", 0, len(sy), True, 0.0, ops)
        lines.append(rec.to_line() + "\n")
    fasta = str(tmp_path / "pairs.fa")
    write_fasta(fasta, seqs)
    return fasta, "".join(lines)


def _run(main, argv, stdin, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")


def test_realign_cli_matches_jax_cli(tmp_path, monkeypatch, capsys, cpu_platform):
    """(e) The realigned CIGAR lines, reverse-strand records among them, and
    the --outputExpectations file against the JAX CLI's device route."""
    fasta, cigars = write_records(tmp_path, 3, 100, seed=6)
    argv = [fasta, "--constraintDiagonalTrim", "2"]
    before = dict(fk.LAUNCHES)
    got = _run(trealign.main, argv, cigars, monkeypatch, capsys).splitlines()
    assert fk.LAUNCHES == before             # plain versions on the CPU
    want = _run(jrealign.main, argv + ["--engine", "pallas"], cigars, monkeypatch,
                capsys).splitlines()
    assert len(got) == 3 and got == want
    recs = [parse_cigar_line(line) for line in got]
    assert [r.strand2 for r in recs] == [True, False, True]
    assert recs[1].start2 > recs[1].end2 == 0

    exp = {}
    for name, main, extra in (("port", trealign.main, []),
                              ("jax", jrealign.main, ["--engine", "pallas"])):
        path = str(tmp_path / f"{name}.exp")
        assert _run(main, [fasta, "--constraintDiagonalTrim", "2", "--outputExpectations",
                           path, *extra], cigars, monkeypatch, capsys) == ""
        exp[name] = DiscreteHmm.load(path)
    g, w = exp["port"], exp["jax"]
    np.testing.assert_allclose(g.transitions, w.transitions, rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(g.emissions, w.emissions, rtol=STEP_RTOL, atol=STEP_ATOL)
    assert abs(g.likelihood - w.likelihood) <= LIK_RTOL * abs(w.likelihood)
    assert g.likelihood < 0 and g.transitions.sum() > 100


def test_em_matches_jax_em(tmp_path, cpu_platform):
    """(f) Two EM iterations, one trial, from the same seeded start."""
    fasta, cigars = write_records(tmp_path, 3, 100, seed=6, reverse=(2,))
    cig = str(tmp_path / "pairs.cig")
    with open(cig, "w") as fh:
        fh.write(cigars)
    params = AlignmentParams(constraint_diagonal_trim=2)
    log = []
    got = tem.expectation_maximisation(cig, [fasta], str(tmp_path / "port.hmm"), iterations=2,
                                       params=params, log=log.append)
    from cpecan_signal_tpu.models.params import AlignmentParams as JParams
    want = jem.expectation_maximisation(cig, [fasta], str(tmp_path / "jax.hmm"), iterations=2,
                                        params=JParams(constraint_diagonal_trim=2),
                                        engine="pallas", log=lambda m: None)
    np.testing.assert_allclose(got.running_likelihoods, want.running_likelihoods,
                               rtol=EM_LIK_RTOL)
    assert got.running_likelihoods[1] >= got.running_likelihoods[0]
    np.testing.assert_allclose(got.transitions, want.transitions, atol=EM_ATOL, rtol=0)
    np.testing.assert_allclose(got.emissions, want.emissions, atol=EM_ATOL, rtol=0)
    seqs = ["ACGT" * 100]
    # the matrix as written (rounded scores) equal; its unrounded scores
    # move with the model's last digits
    (gm, go, ge), (wm, wo, we) = (tem.make_blast_scoring_matrix(got, seqs),
                                  jem.make_blast_scoring_matrix(want, seqs))
    np.testing.assert_allclose(gm + [go, ge], wm + [wo, we], rtol=0, atol=1e-2)
    out, jout = io.StringIO(), io.StringIO()
    tem.write_lastz_scoring_matrix(out, *tem.make_blast_scoring_matrix(got, seqs))
    jem.write_lastz_scoring_matrix(jout, *jem.make_blast_scoring_matrix(want, seqs))
    assert out.getvalue() == jout.getvalue()
    loaded = DiscreteHmm.load(str(tmp_path / "port.hmm"))
    np.testing.assert_allclose(loaded.transitions, got.transitions, atol=1e-6)
    # each iteration logs its E-step seconds, buckets and likelihood
    its = [m for m in log if "iteration" in m]
    assert len(its) == 2 and all("buckets" in m and "E-step" in m for m in its)
    assert float(its[-1].rsplit(" ", 1)[-1]) == pytest.approx(got.likelihood, abs=0.01)


def test_hmm_utilities_match_jax():
    """chunk_alignments, set_jukes_cantor and tie_emissions are the JAX
    CLI's own."""
    from cpecan_signal_tpu.em.accumulators import DiscreteHmm as JHmm

    recs = [CigarRecord("a", 0, n, True, "b", 0, n, True, 0, [("M", 10)])
            for n in (600_000, 300_000, 200_000, 900_000)]
    assert [len(c) for c in tem.chunk_alignments(recs)] == [
        len(c) for c in jem.chunk_alignments(recs)] == [2, 1, 1]
    a, b = DiscreteHmm.empty(5, 4), JHmm.empty(5, 4)
    tem.set_jukes_cantor(a, 0.1)
    jem.set_jukes_cantor(b, 0.1)
    np.testing.assert_array_equal(a.emissions, b.emissions)
    a.randomize(np.random.default_rng(0))
    b.randomize(np.random.default_rng(0))
    tem.tie_emissions(a)
    jem.tie_emissions(b)
    np.testing.assert_array_equal(a.emissions, b.emissions)


def test_unported_routes_raise(tmp_path, monkeypatch, cpu_platform):
    """(g) The host engine, re-banding and several processes raise
    NotImplementedError naming their ROADMAP item; nothing runs in their
    place."""
    fasta, cigars = write_records(tmp_path, 1, 40, seed=1, reverse=())
    cig = str(tmp_path / "one.cig")
    with open(cig, "w") as fh:
        fh.write(cigars)
    monkeypatch.setattr("sys.stdin", io.StringIO(cigars))
    for extra in (["--engine", "host"], ["--matchGamma", "0.5"]):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
            trealign.main([fasta, *extra])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        trealign.realign_record(None, {}, AlignmentParams())
    out = str(tmp_path / "m.hmm")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        tem.expectation_maximisation(cig, [fasta], out, iterations=1, engine="host")
    with pytest.raises(NotImplementedError, match="update_band.*ROADMAP queue 1 item 10"):
        tem.expectation_maximisation(cig, [fasta], out, iterations=1, update_band=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        tem.main(["--alignments", cig, "--fastas", fasta, "--outputModel", out,
                  "--engine", "host"])
    monkeypatch.setenv("SIGALIGN_COORDINATOR", "localhost:1234")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11"):
        tem.expectation_maximisation(cig, [fasta], out, iterations=1)
