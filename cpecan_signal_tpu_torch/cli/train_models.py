"""Baum-Welch training CLI: the trainModels.py equivalent (port of
cli/train_models.py).

Outer EM loop (trainModels.py:180-340): every read's split jobs, both
strands, are packed once into device buckets; per iteration the E-step runs
the stage-4 kernels over all of them, the per-strand tallies are normalized,
and the M-step loads them back as the next iteration's parameters:
  * threeState (default, em/sm3_em.py): transitions and k-mer gap
    probabilities;
  * vanilla (--vanilla, em/vanilla_em.py): the 60 skip bins;
  * threeStateHdp (--threeStateHdp, em/hdp_em.py): transitions, and each
    strand's HDP rebuilt by Gibbs sampling from the iteration's (k-mer, event
    mean) assignments for the next E-step (trainModels.py:321-324), written
    to ``{template,complement}_trained.nhdp`` after the last iteration.
Each iteration writes the two ``*_trained.hmm`` files and, with a checkpoint
directory, an npz checkpoint (and for threeStateHdp a copy of both HDPs)
that a later run resumes from.

``--engine host`` runs the E-step read by read through the f64 oracle
(em/expectation_driver.py) on the same device; ``--jobs N`` (N > 1) runs it
in N spawned worker processes on the CPU, as the JAX CLI forces its
workers onto the CPU, while the parent process keeps the card.  The
pool's results are summed in read order, so ``--jobs 2``
gives what ``--jobs 1`` gives on the CPU, bit for bit.  ``--engine auto``
takes the device E-step, but the host route for threeStateHdp at
``--assignmentThreshold 0`` and, on the CPU, for ``--jobs > 1`` (as the JAX
CLI routes them); on the card it reads no ``--jobs``, so the E-step stays
there unless ``--engine host`` asks for the CPU pool.

Several processes (SIGALIGN_COORDINATOR, SIGALIGN_NUM_PROCS,
SIGALIGN_PROC_ID; parallel/distributed.py): each rank trains on every n-th
read of the sorted list from its rank on, on its own device (ranks may share
a card: the device E-step's bucket budget is divided among them), and the
iteration's accumulators are summed across the ranks (``merge_accumulator``)
before the M-step, so every rank takes the same M-step.  Rank 0 rebuilds the
HDPs (the Gibbs chain is not reproducible) and writes them, the models and
the checkpoints; the other ranks read the HDPs back after a barrier (a
shared filesystem, as the reference's expectation files need).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import multiprocessing as mp
import os
import shutil
import sys
import threading
import time

import numpy as np
import torch

from ..constants import KMER_LENGTH
from ..core.anchors import filter_to_remove_overlap, remap_anchor_pairs_with_offset
from ..em.accumulators import ContinuousPairHmm, HdpHmm, VanillaHmm
from ..em.expectation_driver import (hdp_expectations, sm3_expectations,
                                     vanilla_expectations)
from ..em.hdp_em import build_hdp_em_buckets, collect_hdp_em_jobs, hdp_em_step
from ..em.sm3_em import (_EmBudget, build_sm3_em_buckets, collect_sm3_em_jobs,
                         sm3_em_step)
from ..em.vanilla_em import build_vanilla_em_buckets, vanilla_em_step
from ..hdp.nanopore import NanoporeHDP, deserialize_nhdp
from ..io.fasta import read_first_sequence, reverse_complement
from ..io.npread import load_npread
from ..models.params import AlignmentParams, cli_defaults
from ..models.pore_model import load_pore_model, scale_model
from ..models.state_machines import make_signal_sm3, make_signal_sm3_hdp, make_signal_vanilla
from ..parallel import distributed
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from .build_hdp import DEFAULT_GIBBS, _fresh_like
from .vanilla_align import guide_alignment, rebased_anchor_pairs

MACHINES = ("threeState", "vanilla", "threeStateHdp")
# main's options that only threeStateHdp training reads
HDP_FLAGS = ("templateHdp", "complementHdp", "assignmentThreshold", "samples",
             "burnIn", "thinning")
STRAND_NAMES = {"t": "template", "c": "complement"}


def _prepare_read(ref_seq, npread, params, descale=False):
    """Guide + per-strand (target, events, anchors, scale params) tuples, as
    the alignment CLI prepares a read; threeStateHdp trains on descaled
    event means (``descale``)."""
    guide = guide_alignment(ref_seq, npread.twoD_read, params.constraint_diagonal_trim)
    if guide is None:
        return None
    if descale:
        npread = npread.descale()
    if guide.strand1:
        trimmed = ref_seq[guide.start1:guide.end1]
    else:
        trimmed = reverse_complement(ref_seq[guide.end1:guide.start1])
    rc_trimmed = reverse_complement(trimmed)
    anchors = rebased_anchor_pairs(guide, params.constraint_diagonal_trim)
    end2 = min(guide.end2, len(npread.template_event_map) - 1)
    lX_kmers = len(trimmed) - KMER_LENGTH + 1

    tm = npread.template_event_map
    t_events = npread.template_events[int(tm[guide.start2]):int(tm[end2])]
    t_anchors = remap_anchor_pairs_with_offset(anchors, tm, guide.start2)
    if len(t_anchors):
        ok_t = ((t_anchors[:, 0] >= 0) & (t_anchors[:, 0] < max(lX_kmers, 1))
                & (t_anchors[:, 1] >= 0) & (t_anchors[:, 1] < max(len(t_events), 1)))
        t_anchors = t_anchors[ok_t]
    t_anchors = filter_to_remove_overlap(t_anchors)

    cm = npread.complement_event_map
    ev_lo = int(cm[end2])
    c_events = npread.complement_events[ev_lo:int(cm[guide.start2])]
    if len(anchors):
        cx = (lX_kmers - 1) - anchors[:, 0]
        cy = cm[np.minimum(anchors[:, 1] + guide.start2, len(cm) - 1)] - ev_lo
        c_anchors = np.stack([cx, cy], axis=1)[::-1]
        ok = (c_anchors >= 0).all(axis=1) & (c_anchors[:, 0] < max(lX_kmers, 1)) & \
             (c_anchors[:, 1] < max(len(c_events), 1))
        c_anchors = filter_to_remove_overlap(c_anchors[ok])
    else:
        c_anchors = anchors
    return {"t": (trimmed, t_events, t_anchors, npread.template_params),
            "c": (rc_trimmed, c_events, c_anchors, npread.complement_params)}


def _strand_estep(prep, strand, sm_type, model, state, params, assignment_threshold,
                  density, device):
    """One read-strand's E-step on the f64 oracle -> its accumulator (None
    for a strand without events)."""
    target, events, anchors, sp = prep[strand]
    if len(events) == 0:
        return None
    if sm_type == "threeStateHdp":
        return hdp_expectations(lambda t, e: make_signal_sm3_hdp(density, t, e,
                                                                 state["transitions"]),
                                target, events, anchors, params, assignment_threshold,
                                device=device)
    pore = scale_model(model, sp.scale, sp.shift, sp.var, sp.scale_sd, sp.var_sd)
    if sm_type == "threeState":
        return sm3_expectations(lambda t, e: make_signal_sm3(pore, t, e, state["transitions"],
                                                             state["kmer_gaps"]),
                                target, events, anchors, params, device=device)
    return vanilla_expectations(lambda t, e: make_signal_vanilla(
        pore, t, e, STRAND_NAMES[strand], state["bins"]),
        target, events, anchors, params, device=device)


# a --jobs worker's state: its read preparations, pore models and current
# HDP density, set once by _pool_init (a spawned worker imports this module
# afresh)
_POOL: dict = {}


def _pool_init(reads, model_paths, n_threads):
    """--jobs worker initializer: the read preparations are pickled once per
    worker, not once per work item; the worker takes the parent's intra-op
    thread count, so its sums split as the parent's would."""
    torch.set_num_threads(n_threads)
    _POOL.update(reads=reads, models={s: load_pore_model(p) for s, p in model_paths.items()},
                 density=(None, None))


def _pool_estep(args):
    """--jobs work item: one read-strand's E-step on the worker's CPU."""
    read_idx, strand, sm_type, state, params, assignment_threshold, hdp_key = args
    density = None
    if hdp_key is not None:
        if _POOL["density"][0] != hdp_key:
            _POOL["density"] = (hdp_key, deserialize_nhdp(hdp_key[0]).density_logp_fn())
        density = _POOL["density"][1]
    return _strand_estep(_POOL["reads"][read_idx], strand, sm_type, _POOL["models"][strand],
                         state, params, assignment_threshold, density, torch.device("cpu"))


def _host_estep(reads, strand, sm_type, models, state, params, assignment_threshold,
                density, device, pool, hdp_key):
    """One strand's E-step on the f64 oracle, read by read on ``device`` or
    in ``pool``; the reads' accumulators summed in read order."""
    if sm_type == "threeState":
        acc = ContinuousPairHmm.empty()
    elif sm_type == "vanilla":
        acc = VanillaHmm.empty()
    else:
        acc = HdpHmm.empty(threshold=assignment_threshold)
    if pool is not None:
        results = pool.imap(_pool_estep, [(i, strand, sm_type, state, params,
                                           assignment_threshold, hdp_key)
                                          for i in range(len(reads))])
    else:
        results = (_strand_estep(prep, strand, sm_type, models[strand], state, params,
                                 assignment_threshold, density, device) for prep in reads)
    for r in results:
        if r is not None:
            acc.add(r)
    return acc


def _rebuild_hdps(nhdps: dict, accs: dict, gibbs: dict) -> set:
    """Each strand's HDP rebuilt from its iteration's assignments: a fresh
    chain of the old one's topology and prior (build_hdp._fresh_like),
    Gibbs-sampled and finalized (the reference's vanillaAlign --buildHDP
    each iteration, trainModels.py:321-324).  The two strands sample in
    parallel threads: the native chain releases the GIL.  Returns the
    strands rebuilt (a strand without assignments keeps its HDP)."""
    rebuilt = set()

    def one(strand):
        acc = accs[strand]
        if not acc.n_assignments:
            return
        old = nhdps[strand]
        nhdp = NanoporeHDP(alphabet=old.alphabet, kmer_length=old.kmer_length,
                           topology=old.topology, hdp=_fresh_like(old))
        nhdp.set_assignments(acc.kmer_assignments, acc.event_assignments)
        nhdp.gibbs(**gibbs)
        nhdp.finalize()
        nhdps[strand] = nhdp
        rebuilt.add(strand)

    threads = [threading.Thread(target=one, args=(s,)) for s in ("t", "c")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return rebuilt


def _route(engine: str, jobs: int, device: torch.device, hdp_every_cell: bool,
           log=print) -> tuple[str, int]:
    """(engine, jobs) of a run: "auto" takes the device E-step, but the f64
    oracle for threeStateHdp at threshold 0 (``hdp_every_cell``), and on
    the CPU for ``jobs`` > 1 (the JAX CLI's routes).  On the card "auto"
    reads no ``jobs``: the pool's workers would leave the card."""
    if engine == "auto":
        if jobs > 1 and device.type != "cpu":
            log(f"train_models - --jobs {jobs} not read: the E-step stays on {device} "
                "(--engine host for the CPU pool)")
            jobs = 1
        engine = "host" if jobs > 1 or hdp_every_cell else "pallas"
    return engine, jobs


def train(ref_path: str, npread_paths: list[str], template_model_path: str,
          complement_model_path: str, iterations: int = 10,
          sm_type: str = "threeState", params: AlignmentParams | None = None,
          out_dir: str = ".", assignment_threshold: float = 0.0,
          checkpoint_dir: str | None = None, template_hdp: str | None = None,
          complement_hdp: str | None = None, gibbs: dict | None = None, jobs: int = 1,
          engine: str = "auto", device: torch.device | None = None,
          log=print) -> dict:
    """Run EM for ``sm_type`` (threeState, vanilla or threeStateHdp).
    threeStateHdp collects the (k-mer, event) assignments whose posterior
    passes ``assignment_threshold`` against the serialized NanoporeHDPs
    ``template_hdp`` / ``complement_hdp`` and rebuilds both after every
    M-step with the Gibbs budget ``gibbs``.  ``engine``: "pallas", the
    device E-step; "host", the f64 oracle read by read on ``device``, or
    with ``jobs`` > 1 in that many worker processes on the CPU; "auto", the
    device E-step but for threeStateHdp at threshold 0 and, on the CPU, for
    ``jobs`` > 1 (on the card "auto" reads no ``jobs``).
    Returns the final per-strand accumulators, the likelihood of every
    iteration run, and what the run measured: (split jobs, events, buckets)
    per strand and the bucket memory summary (device E-step), the seconds of
    each iteration's E-step (both strands, to the tallies on the host) and,
    for threeStateHdp, of each iteration's HDP rebuild."""
    if sm_type not in MACHINES:
        raise ValueError(f"EM for {sm_type} not driven by this CLI")
    if engine not in ("auto", "pallas", "host"):
        raise ValueError(f"unknown E-step engine {engine!r}")
    dist_run = os.environ.get("SIGALIGN_COORDINATOR") is not None
    if dist_run:
        if not distributed.is_initialized():
            distributed.initialize()   # before the device is resolved
        npread_paths = distributed.partition_paths(sorted(npread_paths))
    rank0 = distributed.process_index() == 0
    hdp = sm_type == "threeStateHdp"
    device = resolve_device() if device is None else device
    engine, jobs = _route(engine, jobs, device, hdp and assignment_threshold <= 0.0, log)
    nhdps = {}
    if hdp:
        if not (template_hdp and complement_hdp):
            raise ValueError("threeStateHdp training needs template_hdp and "
                             "complement_hdp (serialized NanoporeHDPs)")
        gibbs = gibbs or DEFAULT_GIBBS
        nhdps = {"t": deserialize_nhdp(template_hdp), "c": deserialize_nhdp(complement_hdp)}
    params = params or cli_defaults()
    _, ref_seq = read_first_sequence(ref_path)
    models = {"t": load_pore_model(template_model_path),
              "c": load_pore_model(complement_model_path)}

    reads = []
    for path in npread_paths:
        prep = _prepare_read(ref_seq, load_npread(path), params, descale=hdp)
        if prep is not None:
            reads.append(prep)
    if not reads and not dist_run:
        raise RuntimeError("no mappable training reads")
    log(f"train_models - using {len(reads)} reads"
        + (f" (rank {distributed.process_index()} of {distributed.process_count()})"
           if dist_run else ""))

    # every read's splits pooled into width buckets, built once; one budget
    # for both strands: one card
    buckets, counts = {}, {}
    em_budget = _EmBudget(device)
    for strand in ("t", "c") if engine == "pallas" else ():
        if hdp:
            sj = collect_hdp_em_jobs(reads, params, strand)
            buckets[strand] = build_hdp_em_buckets(sj, device=device,
                                                   threshold=assignment_threshold,
                                                   budget=em_budget)
        else:
            sj = collect_sm3_em_jobs(reads, models, params, strand)
            if sm_type == "vanilla":
                buckets[strand] = build_vanilla_em_buckets(sj, strand, device=device,
                                                           budget=em_budget)
            else:
                buckets[strand] = build_sm3_em_buckets(sj, device=device, budget=em_budget)
        n_ev = sum(len(j.events) for j in sj)
        counts[strand] = (len(sj), n_ev, len(buckets[strand]))
        log(f"train_models - device EM strand {strand}: {len(sj)} split jobs "
            f"({n_ev} events) in {len(buckets[strand])} device buckets")
    if engine == "pallas":
        log(f"train_models - EM bucket memory: {em_budget.summary()}")
    else:
        log(f"train_models - f64 oracle E-step on "
            f"{f'the CPU in {jobs} worker processes' if jobs > 1 else device}")

    state = {s: {"transitions": None, "kmer_gaps": None, "bins": None} for s in ("t", "c")}
    history = []
    start_iter = 0
    rebuilt = set()   # the strands whose HDP a Gibbs chain of this run built
    if checkpoint_dir:
        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt:
            loaded, start_iter = load_checkpoint(ckpt)
            history = [float(v) for v in np.atleast_1d(loaded.get("history", []))]
            for strand in ("t", "c"):
                st = loaded.get(strand, {})
                for k in ("transitions", "kmer_gaps", "bins"):
                    if k in st:
                        state[strand][k] = (
                            {kk: np.asarray(v) for kk, v in st[k].items()}
                            if isinstance(st[k], dict) else np.asarray(st[k]))
                saved = os.path.join(checkpoint_dir, f"{STRAND_NAMES[strand]}_"
                                                     f"{start_iter - 1:06d}.nhdp")
                if hdp and os.path.exists(saved):
                    nhdps[strand] = deserialize_nhdp(saved)
                    rebuilt.add(strand)
            log(f"train_models - resumed from {ckpt} at iteration {start_iter}")

    # the files a --jobs worker loads its HDP from: the given ones, or the
    # checkpoint's, then each iteration's rebuilt one
    hdp_files = {"t": template_hdp, "c": complement_hdp}
    for strand in rebuilt:
        hdp_files[strand] = os.path.join(checkpoint_dir, f"{STRAND_NAMES[strand]}_"
                                                         f"{start_iter - 1:06d}.nhdp")
    final, estep_s, gibbs_s = {}, [], []
    with contextlib.ExitStack() as stack:
        pool = None
        if engine == "host" and jobs > 1:
            # spawned workers import this module afresh and run on the CPU
            pool = stack.enter_context(mp.get_context("spawn").Pool(
                jobs, initializer=_pool_init,
                initargs=(reads, {"t": template_model_path, "c": complement_model_path},
                          torch.get_num_threads())))
        for it in range(start_iter, iterations):
            accs = {}
            t0 = time.perf_counter()
            for strand in ("t", "c"):
                st = state[strand]
                if engine == "host":
                    density = nhdps[strand].density_logp_fn() if hdp and pool is None else None
                    accs[strand] = _host_estep(
                        reads, strand, sm_type, models, st, params, assignment_threshold,
                        density, device, pool, (hdp_files[strand], it) if hdp else None)
                elif sm_type == "threeState":
                    trans, kmer_gap, lik = sm3_em_step(buckets[strand], st["transitions"],
                                                       st["kmer_gaps"])
                    accs[strand] = ContinuousPairHmm(transitions=trans, kmer_gap=kmer_gap,
                                                     likelihood=lik)
                elif sm_type == "vanilla":
                    bins = st["bins"] if st["bins"] is not None else models[strand].skip_bins
                    tallies, lik = vanilla_em_step(buckets[strand], bins)
                    accs[strand] = VanillaHmm(bins=tallies, likelihood=lik)
                else:
                    trans, lik, kmers, means = hdp_em_step(buckets[strand], nhdps[strand],
                                                           st["transitions"],
                                                           assignment_threshold)
                    accs[strand] = HdpHmm(transitions=trans, threshold=assignment_threshold,
                                          likelihood=lik, kmer_assignments=kmers,
                                          event_assignments=means)
            estep_s.append(time.perf_counter() - t0)
            for strand, acc in accs.items():
                distributed.merge_accumulator(acc)
                acc.normalize()
                st = state[strand]
                if sm_type == "threeState":
                    st["transitions"], st["kmer_gaps"] = acc.to_sm3_params()
                elif sm_type == "vanilla":
                    st["bins"] = acc.bins
                else:
                    st["transitions"] = acc.to_sm3_params()
                    log(f"train_models - iteration {it} strand {strand}: "
                        f"{acc.n_assignments} assignments, likelihood {acc.likelihood:.2f}")
            rebuild = ""
            if hdp:
                t1 = time.perf_counter()
                if rank0:
                    rebuilt |= _rebuild_hdps(nhdps, accs, gibbs)
                gibbs_s.append(time.perf_counter() - t1)
                rebuild = f", HDP rebuild {gibbs_s[-1]:.4f} s"
                # serializing takes seconds a strand (about 4000 k-mers of 1200
                # grid values in text), so the HDPs are written after the last
                # iteration and where a checkpoint, the --jobs workers or the
                # other ranks need them
                if it == iterations - 1 or checkpoint_dir or pool is not None or dist_run:
                    for strand in rebuilt if rank0 else ():
                        hdp_files[strand] = os.path.join(
                            out_dir, f"{STRAND_NAMES[strand]}_trained.nhdp")
                        nhdps[strand].serialize(hdp_files[strand])
                if dist_run:
                    distributed.barrier(f"hdp_rebuild_{it}")
                    # the strands rank 0 rebuilt: those with assignments
                    # (the merged accumulators are the same on every rank)
                    for strand in () if rank0 else [s for s, a in accs.items()
                                                    if a.n_assignments]:
                        hdp_files[strand] = os.path.join(
                            out_dir, f"{STRAND_NAMES[strand]}_trained.nhdp")
                        nhdps[strand] = deserialize_nhdp(hdp_files[strand])
                        rebuilt.add(strand)
            lik = sum(a.likelihood for a in accs.values())
            history.append(lik)
            log(f"train_models - iteration {it}: E-step {estep_s[-1]:.4f} s{rebuild}, "
                f"likelihood {lik:.2f}")
            final = accs
            for strand, name in STRAND_NAMES.items() if rank0 else ():
                final[strand].write(os.path.join(out_dir, f"{name}_trained.hmm"))
            if checkpoint_dir and rank0:
                os.makedirs(checkpoint_dir, exist_ok=True)
                ck_state = {"history": np.asarray(history)}
                for strand, name in STRAND_NAMES.items():
                    ck_state[strand] = {k: v for k, v in state[strand].items()
                                        if v is not None}
                    if strand in rebuilt:
                        shutil.copyfile(os.path.join(out_dir, f"{name}_trained.nhdp"),
                                        os.path.join(checkpoint_dir, f"{name}_{it:06d}.nhdp"))
                save_checkpoint(os.path.join(checkpoint_dir, f"ckpt_{it:06d}.npz"),
                                ck_state, step=it + 1)
    return {"accumulators": final, "likelihoods": history, "jobs": counts,
            "budget": em_budget.summary() if engine == "pallas" else None,
            "estep_seconds": estep_s, "gibbs_seconds": gibbs_s}


def main(argv=None):
    ap = argparse.ArgumentParser(description="EM training (trainModels equivalent)")
    ap.add_argument("--ref", "-r", required=True)
    ap.add_argument("--npReads", "-d", required=True,
                    help="directory of .npRead files or a glob")
    ap.add_argument("--templateModel", "-T", required=True)
    ap.add_argument("--complementModel", "-C", required=True)
    ap.add_argument("--iterations", "-i", type=int, default=10)
    ap.add_argument("--strawMan", "-s", action="store_true")
    ap.add_argument("--vanilla", action="store_true")
    ap.add_argument("--threeStateHdp", action="store_true")
    ap.add_argument("--templateHdp", "-v", default=None,
                    help="serialized template NanoporeHDP (threeStateHdp)")
    ap.add_argument("--complementHdp", "-w", default=None)
    ap.add_argument("--assignmentThreshold", type=float, default=0.0)
    ap.add_argument("--samples", type=int, default=10_000)
    ap.add_argument("--burnIn", type=int, default=100_000)
    ap.add_argument("--thinning", type=int, default=100)
    ap.add_argument("--outDir", "-o", default=".")
    ap.add_argument("--amount", "-a", type=int, default=None,
                    help="cap total training bases (cull_training_files)")
    ap.add_argument("--jobs", "-j", type=int, default=1,
                    help="worker processes of the f64 E-step, on the CPU (the "
                         "reference's 4-way pool); not read by the device E-step, "
                         "nor by --engine auto on the card")
    ap.add_argument("--engine", choices=("auto", "pallas", "host"),
                    default="auto",
                    help="E-step engine: 'pallas' = the device E-step (the "
                         "stage-4 kernels; the name is the JAX CLI's), "
                         "'host' = the f64 oracle read by read, 'auto' = pallas "
                         "but host for threeStateHdp at --assignmentThreshold 0 "
                         "and, on the CPU, for --jobs > 1")
    args = ap.parse_args(argv)
    hdp_only = [f"--{k}" for k in HDP_FLAGS if getattr(args, k) != ap.get_default(k)]
    if hdp_only and not args.threeStateHdp:
        raise ValueError(f"{', '.join(hdp_only)}: only --threeStateHdp training reads "
                         "these options")

    if os.path.isdir(args.npReads):
        paths = sorted(glob.glob(os.path.join(args.npReads, "*.npRead")))
    else:
        paths = sorted(glob.glob(args.npReads))
    if args.amount:
        total, kept = 0, []
        for p in paths:
            with open(p) as fh:
                n = int(fh.readline().split()[0])
            if total + n > args.amount:
                break
            total += n
            kept.append(p)
        paths = kept
    sm_type = ("threeStateHdp" if args.threeStateHdp else
               "vanilla" if args.vanilla else "threeState")
    train(args.ref, paths, args.templateModel, args.complementModel,
          iterations=args.iterations, sm_type=sm_type, out_dir=args.outDir,
          assignment_threshold=args.assignmentThreshold,
          template_hdp=args.templateHdp, complement_hdp=args.complementHdp,
          gibbs=dict(num_samples=args.samples, burn_in=args.burnIn,
                     thinning=args.thinning),
          jobs=args.jobs, engine=args.engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
