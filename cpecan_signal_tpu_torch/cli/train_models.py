"""Baum-Welch training CLI: the trainModels.py equivalent (port of
cli/train_models.py:34-72, 138-455, on the device E-step).

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
"""

from __future__ import annotations

import argparse
import glob
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
from ..em.hdp_em import (THRESHOLD_ITEM, build_hdp_em_buckets, collect_hdp_em_jobs,
                         hdp_em_step)
from ..em.sm3_em import (_EmBudget, build_sm3_em_buckets, collect_sm3_em_jobs,
                         sm3_em_step)
from ..em.vanilla_em import build_vanilla_em_buckets, vanilla_em_step
from ..hdp.nanopore import NanoporeHDP, deserialize_nhdp
from ..io.fasta import read_first_sequence, reverse_complement
from ..io.npread import load_npread
from ..models.params import AlignmentParams, cli_defaults
from ..models.pore_model import load_pore_model
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from .build_hdp import DEFAULT_GIBBS, _fresh_like
from .vanilla_align import guide_alignment, rebased_anchor_pairs

MACHINES = ("threeState", "vanilla", "threeStateHdp")
# what the JAX CLI trains that the port does not yet
UNPORTED = {
    "host": "the host f64 E-step engine is ROADMAP queue 1, 'Host engines'",
    "jobs": "--jobs > 1 (host worker processes) is ROADMAP queue 1, 'Host engines'",
    "coordinator": ("multi-host training (SIGALIGN_COORDINATOR) is ROADMAP queue 1, "
                    "'Several processes'"),
}
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


def train(ref_path: str, npread_paths: list[str], template_model_path: str,
          complement_model_path: str, iterations: int = 10,
          sm_type: str = "threeState", params: AlignmentParams | None = None,
          out_dir: str = ".", assignment_threshold: float = 0.0,
          checkpoint_dir: str | None = None, template_hdp: str | None = None,
          complement_hdp: str | None = None, gibbs: dict | None = None, jobs: int = 1,
          engine: str = "auto", device: torch.device | None = None,
          log=print) -> dict:
    """Run EM on the device E-step for ``sm_type`` (threeState, vanilla or
    threeStateHdp).  threeStateHdp collects the (k-mer, event) assignments
    whose posterior passes ``assignment_threshold`` (> 0) against the
    serialized NanoporeHDPs ``template_hdp`` / ``complement_hdp`` and
    rebuilds both after every M-step with the Gibbs budget ``gibbs``.
    Returns the final per-strand accumulators, the likelihood of every
    iteration run, and what the run measured: (split jobs, events, buckets)
    per strand, the bucket memory summary, the seconds of each iteration's
    E-step (both strands, to the tallies on the host) and, for
    threeStateHdp, of each iteration's HDP rebuild."""
    if sm_type not in MACHINES:
        raise ValueError(f"EM for {sm_type} not driven by this CLI")
    if engine == "host":
        raise NotImplementedError(UNPORTED["host"])
    if engine not in ("auto", "pallas"):
        raise ValueError(f"unknown E-step engine {engine!r}")
    if jobs > 1:
        raise NotImplementedError(UNPORTED["jobs"])
    if os.environ.get("SIGALIGN_COORDINATOR") is not None:
        raise NotImplementedError(UNPORTED["coordinator"])
    hdp = sm_type == "threeStateHdp"
    nhdps = {}
    if hdp:
        if not (template_hdp and complement_hdp):
            raise ValueError("threeStateHdp training needs template_hdp and "
                             "complement_hdp (serialized NanoporeHDPs)")
        if assignment_threshold <= 0.0:
            raise NotImplementedError(THRESHOLD_ITEM)
        gibbs = gibbs or DEFAULT_GIBBS
        nhdps = {"t": deserialize_nhdp(template_hdp), "c": deserialize_nhdp(complement_hdp)}
    device = resolve_device() if device is None else device
    params = params or cli_defaults()
    _, ref_seq = read_first_sequence(ref_path)
    models = {"t": load_pore_model(template_model_path),
              "c": load_pore_model(complement_model_path)}

    reads = []
    for path in npread_paths:
        prep = _prepare_read(ref_seq, load_npread(path), params, descale=hdp)
        if prep is not None:
            reads.append(prep)
    if not reads:
        raise RuntimeError("no mappable training reads")
    log(f"train_models - using {len(reads)} reads")

    # every read's splits pooled into width buckets, built once; one budget
    # for both strands: one card
    buckets, counts = {}, {}
    em_budget = _EmBudget(device)
    for strand in ("t", "c"):
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
    log(f"train_models - EM bucket memory: {em_budget.summary()}")

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

    final, estep_s, gibbs_s = {}, [], []
    for it in range(start_iter, iterations):
        accs = {}
        t0 = time.perf_counter()
        for strand in ("t", "c"):
            st = state[strand]
            if sm_type == "threeState":
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
            rebuilt |= _rebuild_hdps(nhdps, accs, gibbs)
            gibbs_s.append(time.perf_counter() - t1)
            rebuild = f", HDP rebuild {gibbs_s[-1]:.4f} s"
            # serializing takes seconds a strand (about 4000 k-mers of 1200
            # grid values in text), so the HDPs are written after the last
            # iteration and where a checkpoint needs them
            if it == iterations - 1 or checkpoint_dir:
                for strand in rebuilt:
                    nhdps[strand].serialize(os.path.join(
                        out_dir, f"{STRAND_NAMES[strand]}_trained.nhdp"))
        lik = sum(a.likelihood for a in accs.values())
        history.append(lik)
        log(f"train_models - iteration {it}: E-step {estep_s[-1]:.4f} s{rebuild}, "
            f"likelihood {lik:.2f}")
        final = accs
        for strand, name in STRAND_NAMES.items():
            final[strand].write(os.path.join(out_dir, f"{name}_trained.hmm"))
        if checkpoint_dir:
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
            "budget": em_budget.summary(), "estep_seconds": estep_s,
            "gibbs_seconds": gibbs_s}


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
                    help="host worker processes for the E-step (the "
                         "reference's 4-way pool); not ported")
    ap.add_argument("--engine", choices=("auto", "pallas", "host"),
                    default="auto",
                    help="E-step engine: 'pallas' = the device E-step (the "
                         "stage-4 kernels; the name is the JAX CLI's), "
                         "'host' = f64 scan loop (not ported), 'auto' = pallas")
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
