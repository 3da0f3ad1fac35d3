"""Several processes: the runtime of the CLIs' multi-process routes, on
torch.distributed (port of cpecan_signal_tpu/parallel/distributed.py).

The reference's cluster story is jobTree fan-out with a filesystem reduce
(cPecanEm.py:404-426) and per-host worker pools
(scripts/signalAlign.py:103-146).  Here, as in the JAX package, each process
(a rank) loads its own slice of the inputs (``partition_paths``), runs it on
its own device, and the EM tallies are summed across the ranks before the
M-step (``allreduce_sum``, ``merge_accumulator``).

A launcher starts one process per rank with three variables, or passes them
to ``initialize``: SIGALIGN_COORDINATOR (``host:port`` of rank 0, or a
``tcp://`` address), SIGALIGN_NUM_PROCS and SIGALIGN_PROC_ID.  Ranks on one
host take the cards round robin (rank ``LOCAL_RANK`` or, without it, the
rank itself, modulo the card count); several ranks may share one card.

Backend: gloo.  What the ranks reduce is host numpy (EM tallies, the
nucleotide EM's chunk table), and two ranks on one card cannot use NCCL,
which refuses two ranks on one device.  The sums are gathered and added in
rank order, as the JAX package's ``process_allgather(...).sum(axis=0)``, so
every run of the same ranks gives the same bits.

Not ported: ``global_data_mesh``, ``make_global_batch`` and ``replicate``,
JAX's sharding of one global batch over a device mesh.  Each rank holds its
own problems on its own device and nothing is sharded (ROADMAP §1 leaves the
JAX package's nh = 2 packing out the same way; parallel/mesh.py).

Elasticity: EM state is checkpointed every iteration (utils/checkpoint.py);
a failed rank restarts the job from the latest checkpoint.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 1800   # a collective that waits longer for a rank raises


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group.  The arguments default to the
    SIGALIGN_COORDINATOR / SIGALIGN_NUM_PROCS / SIGALIGN_PROC_ID variables;
    the coordinator is ``host:port`` (or ``tcp://host:port``) where rank 0
    listens.  With a card and no SIGALIGN_PLATFORM=cpu, this process's
    current card becomes ``device_index()``."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("SIGALIGN_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ["SIGALIGN_NUM_PROCS"])
    if process_id is None:
        process_id = int(os.environ["SIGALIGN_PROC_ID"])
    if not coordinator_address:
        raise ValueError("no coordinator address (SIGALIGN_COORDINATOR)")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if os.environ.get("SIGALIGN_PLATFORM") != "cpu" and torch.cuda.is_available():
        torch.cuda.set_device(device_index())


def is_initialized() -> bool:
    """True once ``initialize`` joined the process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def _local() -> tuple[int, int]:
    """(this process's rank on its host, ranks on its host): LOCAL_RANK and
    LOCAL_WORLD_SIZE where a launcher sets them, else every rank on this
    host."""
    rank = int(os.environ.get("LOCAL_RANK", process_index()))
    return rank, int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def device_index() -> int:
    """The card of this rank: its local rank modulo the cards."""
    return _local()[0] % max(torch.cuda.device_count(), 1)


def ranks_sharing_device() -> int:
    """How many ranks of this host use this rank's card (1 alone)."""
    rank, n = _local()
    cards = max(torch.cuda.device_count(), 1)
    return len(range(rank % cards, n, cards))


def partition_paths(paths: list[str], process_id: int | None = None,
                    num_processes: int | None = None) -> list[str]:
    """This rank's slice of the input file list, every n-th path from its
    rank on (the multi-host analogue of the reference's per-worker queue,
    signalAlign.py:103-146)."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return paths[pid::n]


def _allgather(a: np.ndarray) -> np.ndarray:
    """(ranks, *a.shape): every rank's ``a`` (the same shape and dtype on
    every rank), in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return np.stack([o.numpy() for o in out])


def allreduce_sum(*arrays):
    """Sum each array across the ranks: gathered, then summed over the rank
    axis (``.sum(axis=0)``, rank order), so every rank and every run gets
    the same bits.  Returns numpy arrays; the identity with one process."""
    if process_count() == 1:
        return tuple(np.asarray(a) for a in arrays)
    return tuple(_allgather(np.asarray(a)).sum(axis=0) for a in arrays)


def allgather_concat(a: np.ndarray) -> np.ndarray:
    """Concatenate a per-rank array of any length along axis 0, rows in rank
    order: padded to the longest, gathered, unpadded."""
    a = np.asarray(a)
    if process_count() == 1:
        return a
    ns = _allgather(np.asarray([a.shape[0]], dtype=np.int64)).reshape(-1)
    m = int(ns.max())
    if m == 0:
        return a
    pad = np.zeros((m - a.shape[0],) + a.shape[1:], a.dtype)
    g = _allgather(np.concatenate([a, pad]))
    return np.concatenate([g[i, :int(ns[i])] for i in range(g.shape[0])])


def merge_accumulator(acc):
    """Sum an EM accumulator's tallies across the ranks, in place (the
    multi-host form of the reference's expectation-file sum,
    trainModels.py:126-135): ContinuousPairHmm (transitions, kmer_gap,
    likelihood), VanillaHmm (bins, likelihood) and HdpHmm (transitions and
    likelihood summed; the assignments concatenated in rank order, each
    k-mer as 16 bytes)."""
    if process_count() == 1:
        return acc
    from ..em.accumulators import ContinuousPairHmm, HdpHmm, VanillaHmm

    if isinstance(acc, ContinuousPairHmm):
        t, k, l = allreduce_sum(acc.transitions, acc.kmer_gap, np.asarray(acc.likelihood))
        acc.transitions, acc.kmer_gap, acc.likelihood = t, k, float(l)
    elif isinstance(acc, VanillaHmm):
        b, l = allreduce_sum(acc.bins, np.asarray(acc.likelihood))
        acc.bins, acc.likelihood = b, float(l)
    elif isinstance(acc, HdpHmm):
        t, l = allreduce_sum(acc.transitions, np.asarray(acc.likelihood))
        acc.transitions, acc.likelihood = t, float(l)
        kw = max((len(k) for k in acc.kmer_assignments), default=0)
        if kw > 16:
            raise ValueError(f"k-mer assignment wider than the 16-byte pack: {kw}")
        kb = np.array(acc.kmer_assignments, dtype="S16").reshape(-1, 1)
        kb = kb.view(np.uint8).reshape(-1, 16) if len(kb) else np.zeros((0, 16), np.uint8)
        kmers = allgather_concat(kb)
        events = allgather_concat(np.asarray(acc.event_assignments, dtype=np.float64))
        acc.kmer_assignments = [bytes(r).rstrip(b"\x00").decode() for r in kmers]
        acc.event_assignments = list(events)
    else:
        raise TypeError(f"cannot merge accumulator {type(acc)!r}")
    return acc


def barrier(tag: str = "barrier") -> None:
    """Wait for every rank (``tag`` names the point, for the reader)."""
    del tag
    if process_count() > 1:
        dist.barrier()
