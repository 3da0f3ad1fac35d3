"""One rank of the port's several-process tests (tests/test_torch_distributed.py).

    python tests/torch_distributed_worker.py MODE OUT [ARGS...]

Joins the gloo group that SIGALIGN_COORDINATOR / SIGALIGN_NUM_PROCS /
SIGALIGN_PROC_ID name (without them: one process, no group), runs MODE on
the CPU and, on rank 0, writes what it got to OUT (npz):

  * collectives: ``allreduce_sum``, ``allgather_concat`` (a different row
    count on every rank) and ``merge_accumulator`` on the three signal
    accumulators, from the per-rank values ``rank_values`` makes;
  * em_step SEED: this rank's share of ``em_jobs(SEED)`` (every n-th job
    from its rank on) through ``parallel/mesh.distributed_em_step`` (the f64
    oracle) and ``pallas_em_step_fn`` (the plain kernels);
  * em_cli CIGARS FASTA: cli/em's ``expectation_maximisation`` (2
    iterations, chunks of one record) -> the model's arrays;
  * train REF READS MODEL OUTDIR: cli/train_models' ``train`` (threeState, 1
    iteration) -> the two strands' tallies.

Imports the port only: no jax.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_JOBS = 6       # em_step's jobs
N_BASES = 40     # bases of each job's target


def rank_values(rank: int) -> dict:
    """The values rank ``rank`` contributes to the collectives."""
    rng = np.random.default_rng([7, rank])
    kmers = ["".join(rng.choice(list("ACGT"), 6)) for _ in range(3 + rank)]
    return {"a": rng.random((3, 4)), "b": rng.integers(0, 100, 5),
            "c": rng.random((2 + rank, 3)),
            "trans": rng.random((3, 3)), "kmer_gap": rng.random(4096),
            "lik": float(rng.normal()), "bins": rng.random(120),
            "kmers": kmers, "events": rng.normal(60.0, 5.0, len(kmers))}


def em_jobs(seed: int):
    """N_JOBS threeState E-step jobs on random pore-model data, made from
    ``seed`` as the JAX package's ``__graft_entry__._tiny_batch`` makes its
    batch (unanchored bands of expansion 2, both ends ragged)."""
    from cpecan_signal_tpu_torch.constants import MODEL_PARAMS, NUM_OF_KMERS
    from cpecan_signal_tpu_torch.core.band import band_construct
    from cpecan_signal_tpu_torch.core.kmers import sequence_kmer_ranks
    from cpecan_signal_tpu_torch.em.sm3_em import EmJob
    from cpecan_signal_tpu_torch.models.pore_model import PoreModel

    rng = np.random.default_rng(seed)
    match = np.zeros((NUM_OF_KMERS + 2, MODEL_PARAMS))
    match[:NUM_OF_KMERS, 0] = rng.uniform(40, 90, NUM_OF_KMERS)
    match[:NUM_OF_KMERS, 1] = 1.0
    match[:NUM_OF_KMERS, 2] = rng.uniform(1, 3, NUM_OF_KMERS)
    match[:NUM_OF_KMERS, 3] = 0.3
    match[:NUM_OF_KMERS, 4] = 5.0
    pore = PoreModel(0.9, match, 0.9, match.copy(), np.full(60, 1 / 30))
    jobs = []
    for _ in range(N_JOBS):
        target = "".join(rng.choice(list("ACGT"), N_BASES))
        ranks = sequence_kmer_ranks(target)
        means = match[ranks, 0] + rng.normal(0, 0.5, len(ranks))
        events = np.stack([means, np.full(len(ranks), 2.0), np.full(len(ranks), 0.01)],
                          axis=1)
        band = band_construct([], len(ranks), len(events), 2)
        jobs.append(EmJob(pore, target, events, band, True, True))
    return jobs


def collectives() -> dict:
    from cpecan_signal_tpu_torch.em.accumulators import ContinuousPairHmm, HdpHmm, VanillaHmm
    from cpecan_signal_tpu_torch.parallel import distributed as pd

    v = rank_values(pd.process_index())
    a, b = pd.allreduce_sum(v["a"], v["b"])
    c = pd.allgather_concat(v["c"])
    sm3 = pd.merge_accumulator(ContinuousPairHmm(transitions=v["trans"].copy(),
                                                 kmer_gap=v["kmer_gap"].copy(),
                                                 likelihood=v["lik"]))
    van = pd.merge_accumulator(VanillaHmm(bins=v["bins"].copy(), likelihood=v["lik"]))
    hdp = pd.merge_accumulator(HdpHmm(transitions=v["trans"].copy(), likelihood=v["lik"],
                                      kmer_assignments=list(v["kmers"]),
                                      event_assignments=list(v["events"])))
    return {"a": a, "b": b, "c": c, "sm3_trans": sm3.transitions,
            "sm3_kmer_gap": sm3.kmer_gap, "sm3_lik": sm3.likelihood, "van_bins": van.bins,
            "van_lik": van.likelihood, "hdp_trans": hdp.transitions,
            "hdp_lik": hdp.likelihood, "hdp_kmers": np.array(hdp.kmer_assignments),
            "hdp_events": np.array(hdp.event_assignments)}


def em_step(seed: int) -> dict:
    import torch

    from cpecan_signal_tpu_torch.parallel import distributed as pd
    from cpecan_signal_tpu_torch.parallel import mesh

    cpu = torch.device("cpu")
    mine = em_jobs(seed)[pd.process_index()::pd.process_count()]
    trans, kmer_gap, lik = mesh.distributed_em_step(mine, device=cpu)
    k_trans, k_kmer_gap, k_lik = mesh.pallas_em_step_fn(device=cpu)(mine)
    return {"trans": trans, "kmer_gap": kmer_gap, "lik": lik, "k_trans": k_trans,
            "k_kmer_gap": k_kmer_gap, "k_lik": k_lik}


def em_cli(cigars: str, fasta: str) -> dict:
    from cpecan_signal_tpu_torch.cli import em

    hmm = em.expectation_maximisation(cigars, [fasta], cigars + ".hmm", iterations=2,
                                      trials=1, max_bases_per_chunk=1,
                                      set_jukes_cantor_divergence=0.3)
    return {"trans": hmm.transitions, "emiss": hmm.emissions, "lik": hmm.likelihood,
            "running": np.asarray(hmm.running_likelihoods)}


def train(ref: str, reads: str, model: str, out_dir: str) -> dict:
    import glob

    from cpecan_signal_tpu_torch.cli import train_models

    paths = sorted(glob.glob(os.path.join(reads, "*.npRead")))
    got = train_models.train(ref, paths, model, model, iterations=1, out_dir=out_dir)
    accs = got["accumulators"]
    return {f"{s}_{k}": np.asarray(getattr(accs[s], k))
            for s in ("t", "c") for k in ("transitions", "kmer_gap", "likelihood")}


def main(argv) -> int:
    from cpecan_signal_tpu_torch.parallel import distributed as pd

    mode, out, *args = argv
    if os.environ.get("SIGALIGN_COORDINATOR") and mode in ("collectives", "em_step"):
        pd.initialize()   # the CLIs join the group themselves
    got = {"collectives": collectives, "em_step": lambda seed: em_step(int(seed)),
           "em_cli": em_cli, "train": train}[mode](*args)
    if pd.process_index() == 0:
        np.savez(out, **got)
    pd.barrier("done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
