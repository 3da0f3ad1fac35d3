"""The port's several processes (parallel/distributed.py, parallel/mesh.py
and the CLIs' multi-process routes), in gloo groups of 2 processes on the
CPU, as tests/test_distributed.py runs the JAX package's (which is
slow-marked; these are small enough for tier-1).

Each rank is a subprocess (tests/torch_distributed_worker.py, or a CLI run
with ``python -m``) with the SIGALIGN_* variables and a timeout of its own;
the one-process run it is held against is a subprocess too, with the same
thread count.  Limits:
  * the collectives: the sum in rank order of the per-rank values, exactly;
  * the E-step: 2 ranks against 1 within rtol 1e-12 for the f64 oracle (the
    same jobs, summed in another order) and within the E-step limits below
    for the kernels (each bucket summed in f32); the f64 oracle's step against the JAX package's
    ``pmesh.distributed_em_step`` on the same numpy-seeded batch (f64) within
    rtol 1e-9 (PERF.md §2, the oracle), the kernels' plain versions against
    it within test_torch_em.py's limits for the kernels against the f64
    E-step (rtol 1e-3 + atol 1e-4, likelihood 1e-3 relative);
  * cli/em: 2 ranks equal 1 bit for bit (the chunks summed in chunk order).
The signal CLIs' routes: test_torch_distributed_cli.py.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.anchor.seed_chain import get_anchor_pairs
from cpecan_signal_tpu_torch.core.amap import pairs_to_cigar_ops
from cpecan_signal_tpu_torch.io.cigar import CigarRecord
from cpecan_signal_tpu_torch.io.fasta import write_fasta
from torch_distributed_worker import N_JOBS, em_jobs, rank_values

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_distributed_worker.py")
TIMEOUT_S = 300            # a subprocess that takes longer fails the test
STEP_RTOL, STEP_ATOL, LIK_RTOL = 1e-4, 1e-5, 1e-5
ORACLE_RTOL = 1e-9
HOST_RTOL, HOST_ATOL = 1e-3, 1e-4   # kernels against the f64 E-step (test_torch_em.py)
ORDER_RTOL = 1e-12


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(cmd: list[str], ranks: int) -> None:
    """Run ``cmd`` as ``ranks`` ranks of one gloo group (0: one process, no
    group) on the CPU, each under TIMEOUT_S; every one must exit 0."""
    base = {k: v for k, v in os.environ.items() if not k.startswith("SIGALIGN_")}
    base.update(SIGALIGN_PLATFORM="cpu", OMP_NUM_THREADS="2")
    envs = [base] if ranks == 0 else [
        dict(base, SIGALIGN_COORDINATOR=f"localhost:{port}", SIGALIGN_NUM_PROCS=str(ranks),
             SIGALIGN_PROC_ID=str(r)) for port in [_free_port()] for r in range(ranks)]
    procs = [subprocess.Popen([sys.executable, *cmd], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for env in envs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {cmd} failed:\n{o[-3000:]}"


def _worker(tmp_path, name: str, ranks: int, *args) -> dict:
    out = str(tmp_path / f"{name}_{ranks}.npz")
    _launch([WORKER, name, out, *map(str, args)], ranks)
    return dict(np.load(out))


def test_collectives_sum_in_rank_order(tmp_path):
    got = _worker(tmp_path, "collectives", 2)
    v = [rank_values(r) for r in range(2)]

    def total(key):
        return np.stack([x[key] for x in v]).sum(axis=0)

    np.testing.assert_array_equal(got["a"], total("a"))
    np.testing.assert_array_equal(got["b"], total("b"))
    np.testing.assert_array_equal(got["c"], np.concatenate([x["c"] for x in v]))
    np.testing.assert_array_equal(got["sm3_trans"], total("trans"))
    np.testing.assert_array_equal(got["sm3_kmer_gap"], total("kmer_gap"))
    np.testing.assert_array_equal(got["van_bins"], total("bins"))
    np.testing.assert_array_equal(got["hdp_trans"], total("trans"))
    for k in ("sm3_lik", "van_lik", "hdp_lik"):
        assert float(got[k]) == float(total("lik"))
    assert list(got["hdp_kmers"]) == v[0]["kmers"] + v[1]["kmers"]
    np.testing.assert_array_equal(got["hdp_events"],
                                  np.concatenate([x["events"] for x in v]))


def test_em_step_two_ranks_match_one_and_jax(tmp_path):
    seed = 7
    two = _worker(tmp_path, "em_step", 2, seed)
    one = _worker(tmp_path, "em_step", 0, seed)
    for k in two:   # the kernels' form sums each bucket in f32
        tol = dict(rtol=STEP_RTOL, atol=STEP_ATOL) if k.startswith("k_") else \
            dict(rtol=ORDER_RTOL, atol=0)
        np.testing.assert_allclose(two[k], one[k], **tol)

    from __graft_entry__ import _tiny_batch
    from cpecan_signal_tpu.parallel import mesh as pmesh

    plan, W, batch = _tiny_batch(N_JOBS, dtype=np.float64, seed=seed)
    assert len(em_jobs(seed)) == N_JOBS
    trans, kmer_gap, lik = (np.asarray(a) for a in pmesh.distributed_em_step(
        plan, W, pmesh.make_mesh(2), batch))
    # the f64 oracle (scan form) against the JAX scan engine at f64
    np.testing.assert_allclose(one["trans"], trans, rtol=ORACLE_RTOL)
    np.testing.assert_allclose(one["kmer_gap"], kmer_gap, rtol=ORACLE_RTOL, atol=1e-12)
    assert float(one["lik"]) == pytest.approx(float(lik), rel=ORACLE_RTOL)
    # the kernels' plain versions (f32, the reference's cubic logAdd, window
    # bands) against that f64 exact E-step
    np.testing.assert_allclose(one["k_trans"], trans, rtol=HOST_RTOL, atol=HOST_ATOL)
    np.testing.assert_allclose(one["k_kmer_gap"], kmer_gap, rtol=HOST_RTOL, atol=HOST_ATOL)
    assert float(one["k_lik"]) == pytest.approx(float(lik), rel=HOST_RTOL)


def _write_records(tmp_path, n: int, n_bases: int, seed: int):
    """n records of n_bases-base pairs and their descendants, the guide from
    seed anchors: (CIGAR file, FASTA file)."""
    rng = np.random.default_rng(seed)
    seqs, lines = [], []
    for i in range(n):
        sx = "".join(rng.choice(list("ACGT"), n_bases))
        sy = syn.evolve_sequence(sx, rng, 0.07, 0.02)
        anchors = get_anchor_pairs(sx, sy, k=8)
        pairs = np.concatenate([np.ones((len(anchors), 1), dtype=np.int64), anchors], axis=1)
        ops = pairs_to_cigar_ops(pairs, len(sx), len(sy))
        seqs += [(f"x{i}", sx), (f"y{i}", sy)]
        rec = CigarRecord(f"x{i}", 0, len(sx), True, f"y{i}", 0, len(sy), True, 0.0, ops)
        lines.append(rec.to_line() + "\n")
    fasta, cigars = str(tmp_path / "pairs.fa"), str(tmp_path / "in.cigars")
    write_fasta(fasta, seqs)
    with open(cigars, "w") as fh:
        fh.writelines(lines)
    return cigars, fasta


def test_em_cli_two_ranks_equal_one_bit_for_bit(tmp_path):
    cigars, fasta = _write_records(tmp_path, 2, 80, seed=5)
    two = _worker(tmp_path, "em_cli", 2, cigars, fasta)
    one = _worker(tmp_path, "em_cli", 0, cigars, fasta)
    for k in one:
        np.testing.assert_array_equal(two[k], one[k])
