"""Baum-Welch training CLI: the trainModels.py equivalent (port of
cli/train_models.py:34-72, 138-455, threeState on the device E-step).

Outer EM loop (trainModels.py:180-340): every read's split jobs, both
strands, are packed once into device buckets (em/sm3_em.py); per iteration
the E-step runs the stage-4 kernels over all of them, the per-strand tallies
are normalized, and the M-step loads them back as the next iteration's
transitions and k-mer gap probabilities.  Each iteration writes the two
``*_trained.hmm`` files and, with a checkpoint directory, an npz checkpoint
that a later run resumes from.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np
import torch

from ..constants import KMER_LENGTH
from ..core.anchors import filter_to_remove_overlap, remap_anchor_pairs_with_offset
from ..em.accumulators import ContinuousPairHmm
from ..em.sm3_em import (_EmBudget, build_sm3_em_buckets, collect_sm3_em_jobs,
                         sm3_em_step)
from ..io.fasta import read_first_sequence, reverse_complement
from ..io.npread import load_npread
from ..models.params import AlignmentParams, cli_defaults
from ..models.pore_model import load_pore_model
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from .vanilla_align import guide_alignment, rebased_anchor_pairs

# what the JAX CLI trains that the port does not yet
UNPORTED = {
    "vanilla": "vanilla EM is ROADMAP queue 1, 'vanilla EM'",
    "threeStateHdp": ("threeStateHdp EM is ROADMAP queue 1, 'The hdp package, "
                      "threeStateHdp alignment and HDP EM'"),
    "host": "the host f64 E-step engine is ROADMAP queue 1, 'Host engines'",
    "jobs": "--jobs > 1 (host worker processes) is ROADMAP queue 1, 'Host engines'",
    "coordinator": ("multi-host training (SIGALIGN_COORDINATOR) is ROADMAP queue 1, "
                    "'Several processes'"),
}
# main's options that only threeStateHdp training reads
HDP_FLAGS = ("templateHdp", "complementHdp", "assignmentThreshold", "samples",
             "burnIn", "thinning")


def _prepare_read(ref_seq, npread, params):
    """Guide + per-strand (target, events, anchors, scale params) tuples, as
    the alignment CLI prepares a read."""
    guide = guide_alignment(ref_seq, npread.twoD_read, params.constraint_diagonal_trim)
    if guide is None:
        return None
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


def train(ref_path: str, npread_paths: list[str], template_model_path: str,
          complement_model_path: str, iterations: int = 10,
          sm_type: str = "threeState", params: AlignmentParams | None = None,
          out_dir: str = ".", checkpoint_dir: str | None = None, jobs: int = 1,
          engine: str = "auto", device: torch.device | None = None,
          log=print) -> dict:
    """Run threeState EM on the device E-step.  Returns the final per-strand
    accumulators, the likelihood of every iteration run, and what the run
    measured: (split jobs, events, buckets) per strand, the bucket memory
    summary and the seconds of each iteration's E-step (both strands, to
    the tallies on the host)."""
    if sm_type != "threeState":
        raise NotImplementedError(f"{sm_type} training is not ported: "
                                  f"{UNPORTED.get(sm_type, 'unknown machine')}")
    if engine == "host":
        raise NotImplementedError(UNPORTED["host"])
    if engine not in ("auto", "pallas"):
        raise ValueError(f"unknown E-step engine {engine!r}")
    if jobs > 1:
        raise NotImplementedError(UNPORTED["jobs"])
    if os.environ.get("SIGALIGN_COORDINATOR") is not None:
        raise NotImplementedError(UNPORTED["coordinator"])
    device = resolve_device() if device is None else device
    params = params or cli_defaults()
    _, ref_seq = read_first_sequence(ref_path)
    models = {"t": load_pore_model(template_model_path),
              "c": load_pore_model(complement_model_path)}

    reads = []
    for path in npread_paths:
        prep = _prepare_read(ref_seq, load_npread(path), params)
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
        sj = collect_sm3_em_jobs(reads, models, params, strand)
        buckets[strand] = build_sm3_em_buckets(sj, device=device, budget=em_budget)
        n_ev = sum(len(j.events) for j in sj)
        counts[strand] = (len(sj), n_ev, len(buckets[strand]))
        log(f"train_models - device EM strand {strand}: {len(sj)} split jobs "
            f"({n_ev} events) in {len(buckets[strand])} device buckets")
    log(f"train_models - EM bucket memory: {em_budget.summary()}")

    state = {s: {"transitions": None, "kmer_gaps": None} for s in ("t", "c")}
    history = []
    start_iter = 0
    if checkpoint_dir:
        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt:
            loaded, start_iter = load_checkpoint(ckpt)
            history = [float(v) for v in np.atleast_1d(loaded.get("history", []))]
            for strand in ("t", "c"):
                st = loaded.get(strand, {})
                for k in ("transitions", "kmer_gaps"):
                    if k in st:
                        state[strand][k] = (
                            {kk: np.asarray(v) for kk, v in st[k].items()}
                            if isinstance(st[k], dict) else np.asarray(st[k]))
            log(f"train_models - resumed from {ckpt} at iteration {start_iter}")

    final, estep_s = {}, []
    for it in range(start_iter, iterations):
        accs = {}
        t0 = time.perf_counter()
        for strand in ("t", "c"):
            st = state[strand]
            trans, kmer_gap, lik = sm3_em_step(buckets[strand], st["transitions"],
                                               st["kmer_gaps"])
            accs[strand] = ContinuousPairHmm(transitions=trans, kmer_gap=kmer_gap,
                                             likelihood=lik)
        estep_s.append(time.perf_counter() - t0)
        for strand, acc in accs.items():
            acc.normalize()
            state[strand]["transitions"], state[strand]["kmer_gaps"] = acc.to_sm3_params()
        lik = sum(a.likelihood for a in accs.values())
        history.append(lik)
        log(f"train_models - iteration {it}: E-step {estep_s[-1]:.4f} s, "
            f"likelihood {lik:.2f}")
        final = accs
        for strand, name in (("t", "template"), ("c", "complement")):
            final[strand].write(os.path.join(out_dir, f"{name}_trained.hmm"))
        if checkpoint_dir:
            ck_state = {"history": np.asarray(history)}
            for strand in ("t", "c"):
                ck_state[strand] = {k: v for k, v in state[strand].items()
                                    if v is not None}
            save_checkpoint(os.path.join(checkpoint_dir, f"ckpt_{it:06d}.npz"),
                            ck_state, step=it + 1)
    return {"accumulators": final, "likelihoods": history, "jobs": counts,
            "budget": em_budget.summary(), "estep_seconds": estep_s}


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
    if hdp_only:
        raise NotImplementedError(f"{', '.join(hdp_only)}: "
                                  f"{UNPORTED['threeStateHdp']}")

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
          jobs=args.jobs, engine=args.engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
