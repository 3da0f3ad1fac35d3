"""Signal alignment of one read + CLI: the vanillaAlign equivalent (port of
cli/vanilla_align.py).

Given a reference sequence, an npRead and pore models, aligns the template
and complement event sequences to the reference with anchor banding on the
device-batched path (or, with ``align_read(device_batch=False)``, strand by
strand through the f64 oracle) and writes the 15-column posterior TSV
(writePosteriorProbs, vanillaAlign.c:26-96).  The machine is vanilla by
default, threeState (-s), fourState (-f), echelon (-e) or threeStateHdp
(--threeStateHdp, with NanoporeHDPs -v / -w); trained models (-y / -z,
.hmm files) replace the defaults.  The guide alignment comes from
the built-in seed-chain anchorer (both strands tried) or from an exonerate
CIGAR file.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..anchor.seed_chain import get_anchor_pairs
from ..constants import KMER_LENGTH, MODEL_PARAMS, PAIR_ALIGNMENT_PROB_1
from ..core.anchors import (cigar_to_anchor_pairs, filter_to_remove_overlap,
                             remap_anchor_pairs_with_offset)
from ..core.kmers import kmer_rank
from ..engine.align import AlignedPairs, align_events_to_target, collect_split_jobs
from ..em.accumulators import load_signal_hmm, signal_sm_params
from ..engine.batch_align import assemble_pairs, batch_align_jobs
from ..hdp.nanopore import deserialize_nhdp
from ..io.cigar import CigarRecord, parse_cigar_line
from ..io.fasta import read_first_sequence, reverse_complement
from ..io.npread import NanoporeRead, load_npread
from ..models.params import AlignmentParams, cli_defaults
from ..models.pore_model import PoreModel, load_pore_model, scale_model
from ..models.state_machines import (make_signal_echelon, make_signal_sm3,
                                      make_signal_sm3_hdp, make_signal_sm4,
                                      make_signal_vanilla)
from ..utils.device import resolve_device
from ..utils.observability import timed


def guide_alignment(ref_seq: str, read_seq: str, trim: int) -> CigarRecord | None:
    """Built-in guide: seed-chain on both strands, pick the larger chain.

    Returns a CigarRecord-shaped guide whose ops are one M block per chained
    anchor run (enough structure for guideAlignmentToRebasedAnchorPairs).
    """
    best = None
    for strand1, ref in ((True, ref_seq), (False, reverse_complement(ref_seq))):
        pairs = get_anchor_pairs(ref, read_seq)
        if len(pairs) == 0:
            continue
        score = len(pairs)
        if best is None or score > best[0]:
            best = (score, strand1, pairs)
    if best is None:
        return None
    _, strand1, pairs = best
    n = len(ref_seq)
    # runs of consecutive pairs become M blocks with I/D gaps
    ops: list[tuple[str, int]] = []
    px, py = pairs[0]
    ops.append(("M", 1))
    for x, y in pairs[1:]:
        dx, dy = x - px, y - py
        if dx == 1 and dy == 1:
            _op, ln = ops[-1]
            ops[-1] = ("M", ln + 1)
        else:
            if dx > 1:
                ops.append(("D", int(dx - 1)))
            if dy > 1:
                ops.append(("I", int(dy - 1)))
            ops.append(("M", 1))
        px, py = x, y
    start1_f = int(pairs[0, 0])
    end1_f = int(pairs[-1, 0]) + 1
    if strand1:
        start1, end1 = start1_f, end1_f
    else:
        # reverse-strand window on the forward reference, flipped so
        # start1 > end1 (bwa-style '-' strand record)
        start1, end1 = n - start1_f, n - end1_f
    return CigarRecord(
        contig1="ref", start1=start1, end1=end1, strand1=strand1,
        contig2="read", start2=int(pairs[0, 1]), end2=int(pairs[-1, 1]) + 1,
        strand2=True, score=float(len(pairs)), ops=ops)


def rebased_anchor_pairs(guide: CigarRecord, trim: int) -> np.ndarray:
    """guideAlignmentToRebasedAnchorPairs (vanillaAlign.c:278-299): rebase the
    reference coordinates to 0 on the aligned (possibly reverse) strand."""
    start2 = guide.start2
    start1 = 0
    pairs = cigar_to_anchor_pairs(start1, start2, guide.ops, trim)
    if len(pairs) == 0:
        return pairs
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return filter_to_remove_overlap(pairs[order])


def write_posterior_probs(fh, read_label: str, contig: str, match_model: np.ndarray,
                          scale: float, shift: float, events: np.ndarray,
                          target: str, forward: bool, event_offset: int,
                          ref_offset: int, pairs: AlignedPairs, strand: str) -> None:
    """15-column TSV rows (writePosteriorProbs, vanillaAlign.c:26-96).  The
    per-row arithmetic runs on arrays and the k-mer columns are looked up
    once per reference position: an echelon read gives about 10^5 rows."""
    ref_len = len(target)
    same_dir = (strand == "t" and forward) or (strand == "c" and not forward)
    x_adj = (pairs.x + ref_offset if same_dir
             else (ref_len - KMER_LENGTH) - (pairs.x + (ref_len - ref_offset)))
    y = pairs.y + event_offset
    p = pairs.probs / PAIR_ALIGNMENT_PROB_1
    ev = events[y]
    descaled_mean = (ev[:, 0] - shift) / scale
    ux, ui = np.unique(pairs.x, return_inverse=True)
    kmers = [target[x_i:x_i + KMER_LENGTH] for x_i in ux.tolist()]
    ranks = np.array([kmer_rank(k) for k in kmers], dtype=np.int64)
    known = ranks < len(match_model) - 2
    e_level = np.zeros(len(ux))
    e_noise = np.zeros(len(ux))
    e_level[known] = match_model[ranks[known], 0]
    e_noise[known] = match_model[ranks[known], 2]
    descaled_e = ((e_level - shift) / scale).tolist()
    e_level, e_noise = e_level.tolist(), e_noise.tolist()
    ref_kmers = kmers if same_dir else [reverse_complement(k) for k in kmers]
    chunk = 1 << 16
    for lo in range(0, len(y), chunk):
        sl = slice(lo, lo + chunk)
        fh.write("".join(
            f"{contig}\t{xa}\t{ref_kmers[u]}\t{read_label}\t{strand}\t{yy}\t"
            f"{mean:f}\t{noise:f}\t{duration:f}\t{kmers[u]}\t{e_level[u]:f}\t"
            f"{e_noise[u]:f}\t{pp:f}\t{dm:f}\t{descaled_e[u]:f}\n"
            for xa, u, yy, (mean, noise, duration), pp, dm in zip(
                x_adj[sl].tolist(), ui[sl].tolist(), y[sl].tolist(), ev[sl].tolist(),
                p[sl].tolist(), descaled_mean[sl].tolist())))


def make_sm_factory(sm_type: str, pore: PoreModel, strand: str, transitions=None,
                    kmer_gap_probs=None, skip_bins=None, hdp_density=None):
    """State-machine factory of one strand ("t" or "c"): (target, events)
    -> machine, with trained transitions and k-mer gap probabilities
    (threeState, fourState, threeStateHdp) or skip bins (vanilla, echelon)
    where given; threeStateHdp emits from ``hdp_density`` (a NanoporeHDP's
    density_logp_fn, or alphabet_density_fn for --substitute targets)."""
    sname = "template" if strand == "t" else "complement"
    if sm_type == "threeState":
        return lambda t, e: make_signal_sm3(pore, t, e, transitions, kmer_gap_probs)
    if sm_type == "fourState":
        return lambda t, e: make_signal_sm4(pore, t, e, transitions, kmer_gap_probs)
    if sm_type == "vanilla":
        return lambda t, e: make_signal_vanilla(pore, t, e, sname, skip_bins)
    if sm_type == "echelon":
        return lambda t, e: make_signal_echelon(pore, t, e, sname, skip_bins)
    if sm_type == "threeStateHdp":
        if hdp_density is None:
            raise ValueError("threeStateHdp needs an HDP density (--templateHdp, "
                             "--complementHdp)")
        return lambda t, e: make_signal_sm3_hdp(hdp_density, t, e, transitions)
    raise ValueError(f"unsupported state machine type {sm_type}")


def prepare_read(ref_seq: str, npread: NanoporeRead, params: AlignmentParams,
                 *, sm_type: str, guide: CigarRecord | None,
                 substitute: str | None, template_model, complement_model,
                 trained: dict | None = None, hdp_density: dict | None = None) -> dict:
    """Phase 1 of a read: guide, reference trimming, per-strand event windows
    and anchors, and state-machine factories — everything up to running the
    engine, so a multi-read caller can pool split jobs across reads.
    ``trained`` maps a strand ("t", "c") to the keyword arguments of
    make_sm_factory from a trained model (em/accumulators.signal_sm_params),
    ``hdp_density`` a strand to its threeStateHdp density; threeStateHdp
    aligns the descaled events against the unscaled model, as the reference
    queries its HDP."""
    with timed("prepare_read"):
        trained = trained or {}
        hdp_density = hdp_density or {}
        if guide is None:
            guide = guide_alignment(ref_seq, npread.twoD_read,
                                    params.constraint_diagonal_trim)
        if guide is None:
            return {"status": "unmapped"}
        if sm_type == "threeStateHdp":
            npread = npread.descale()

        # the reference window on the mapped strand
        if guide.strand1:
            trimmed = ref_seq[guide.start1:guide.end1]
        else:
            trimmed = reverse_complement(ref_seq[guide.end1:guide.start1])
        rc_trimmed = reverse_complement(trimmed)
        t_target = trimmed if substitute is None else trimmed.replace("C", substitute)
        c_target = rc_trimmed if substitute is None else rc_trimmed.replace("C", substitute)

        anchors = rebased_anchor_pairs(guide, params.constraint_diagonal_trim)
        forward = guide.strand1

        results = {"status": "ok", "n_anchors": len(anchors)}
        end2 = min(guide.end2, len(npread.template_event_map) - 1)
        lX_kmers = len(trimmed) - KMER_LENGTH + 1

        # template strand: the event map increases with read position
        tm = npread.template_event_map
        ev_start_t = int(tm[guide.start2])
        ev_end_t = int(tm[end2])
        t_events = npread.template_events[ev_start_t:ev_end_t]
        t_anchors = remap_anchor_pairs_with_offset(anchors, tm, guide.start2)
        if len(t_anchors):
            ok_t = ((t_anchors[:, 0] >= 0) & (t_anchors[:, 0] < max(lX_kmers, 1))
                    & (t_anchors[:, 1] >= 0) & (t_anchors[:, 1] < max(len(t_events), 1)))
            t_anchors = t_anchors[ok_t]
        t_anchors = filter_to_remove_overlap(t_anchors)

        # complement strand: the complement event map decreases with read
        # position; events [cm[end2], cm[start2]) in increasing order align to
        # the reverse-complement target with anchors mirrored on both axes
        # (the intended form of vanillaAlign.c:301-316)
        cm = npread.complement_event_map
        ev_lo_c = int(cm[end2])
        ev_hi_c = int(cm[guide.start2])
        c_events = npread.complement_events[ev_lo_c:ev_hi_c]
        if len(anchors):
            cx = (lX_kmers - 1) - anchors[:, 0]
            cy = cm[np.minimum(anchors[:, 1] + guide.start2, len(cm) - 1)] - ev_lo_c
            c_anchors = np.stack([cx, cy], axis=1)[::-1]
            ok = (c_anchors[:, 0] >= 0) & (c_anchors[:, 1] >= 0) & \
                 (c_anchors[:, 0] < max(lX_kmers, 1)) & (c_anchors[:, 1] < max(len(c_events), 1))
            c_anchors = filter_to_remove_overlap(c_anchors[ok])
        else:
            c_anchors = anchors

        strand_ctx = []
        for strand, target, raw_target, model, sparams, events_all, strand_events, \
                strand_anchors, ref_off, ev_off in (
                ("t", t_target, trimmed, template_model, npread.template_params,
                 npread.template_events, t_events, t_anchors, guide.start1, ev_start_t),
                ("c", c_target, rc_trimmed, complement_model, npread.complement_params,
                 npread.complement_events, c_events, c_anchors, guide.end1, ev_lo_c)):
            scaled = model
            if sm_type != "threeStateHdp":
                scaled = scale_model(model, sparams.scale, sparams.shift, sparams.var,
                                     sparams.scale_sd, sparams.var_sd)
            make_sm = (make_sm_factory(sm_type, scaled, strand,
                                       hdp_density=hdp_density.get(strand),
                                       **trained.get(strand, {}))
                       if len(strand_events) else None)
            strand_ctx.append({
                "strand": strand, "target": target, "raw_target": raw_target,
                "scaled": scaled, "sparams": sparams, "events_all": events_all,
                "events": strand_events, "anchors": strand_anchors,
                "ref_off": ref_off, "ev_off": ev_off, "make_sm": make_sm,
            })
        results["forward"] = forward
        results["strand_ctx"] = strand_ctx
        results["sm_type"] = sm_type
        return results


def strand_jobs(ctx: dict, params: AlignmentParams):
    """Split jobs of one prepared strand (none for a strand without events)."""
    if ctx["make_sm"] is None:
        return []
    return collect_split_jobs(ctx["make_sm"], ctx["target"], ctx["events"],
                              ctx["anchors"], params, ragged_left=True,
                              ragged_right=True)


def compute_pairs(prep: dict, params: AlignmentParams, *, device,
                  device_batch: bool = True) -> dict:
    """Phase 2 of a read: both strands' split jobs in one device batch, or
    (``device_batch=False``) each strand through the f64 oracle on
    ``device`` (echelon with its per-state posteriors)."""
    if not device_batch:
        empty = AlignedPairs(*(np.zeros(0, dtype=np.int64),) * 3)
        return {ctx["strand"]: (empty if ctx["make_sm"] is None else align_events_to_target(
                    ctx["make_sm"], ctx["target"], ctx["events"], ctx["anchors"], params,
                    device=device, multi_match=prep["sm_type"] == "echelon"))
                for ctx in prep["strand_ctx"]}
    all_jobs, owners = [], []
    for ctx in prep["strand_ctx"]:
        jobs = strand_jobs(ctx, params)
        all_jobs.extend(jobs)
        owners.extend(ctx["strand"] for _ in jobs)
    frags = batch_align_jobs(all_jobs, params.threshold, device=device) if all_jobs else []
    return {s: assemble_pairs([f for f, o in zip(frags, owners) if o == s])
            for s in ("t", "c")}


def align_read(ref_seq: str, contig: str, npread: NanoporeRead, template_model: PoreModel,
               complement_model: PoreModel, params: AlignmentParams,
               sm_type: str = "vanilla", guide: CigarRecord | None = None,
               substitute: str | None = None, read_label: str = "read", out_fh=None,
               trained: dict | None = None, hdp_density: dict | None = None, *,
               device_batch: bool = True, device=None) -> dict:
    """Full two-strand signal alignment of one read (vanillaAlign.c:361-805):
    prepare_read, compute_pairs (``device_batch``), finish_read, on
    ``device`` (default: the resolved device)."""
    device = resolve_device() if device is None else device
    prep = prepare_read(ref_seq, npread, params, sm_type=sm_type, guide=guide,
                        substitute=substitute, template_model=template_model,
                        complement_model=complement_model, trained=trained,
                        hdp_density=hdp_density)
    if prep["status"] != "ok":
        return prep
    pairs = compute_pairs(prep, params, device=device, device_batch=device_batch)
    return finish_read(prep, pairs, out_fh, read_label, contig)


def finish_read(prep: dict, pairs_by_strand: dict, out_fh, read_label: str,
                contig: str) -> dict:
    """Phase 3 of a read: TSV rows + result assembly."""
    results = {"status": "ok", "n_anchors": prep["n_anchors"]}
    for ctx in prep["strand_ctx"]:
        pairs = pairs_by_strand[ctx["strand"]]
        results[ctx["strand"]] = pairs
        if out_fh is not None:
            scaled = ctx["scaled"]
            write_posterior_probs(out_fh, read_label, contig,
                                  scaled.match_model if scaled else
                                  np.zeros((2, MODEL_PARAMS)),
                                  ctx["sparams"].scale, ctx["sparams"].shift,
                                  ctx["events_all"], ctx["raw_target"],
                                  prep["forward"], ctx["ev_off"],
                                  ctx["ref_off"], pairs, ctx["strand"])
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="signal alignment (vanillaAlign equivalent)")
    ap.add_argument("--reference", "-r", required=True)
    ap.add_argument("--npRead", "-q", required=True)
    ap.add_argument("--templateModel", "-T", required=True)
    ap.add_argument("--complementModel", "-C", required=True)
    ap.add_argument("--posteriors", "-u", default=None)
    ap.add_argument("--readLabel", "-L", default="read")
    ap.add_argument("--strawMan", "-s", action="store_true")
    ap.add_argument("--fourState", "-f", action="store_true")
    ap.add_argument("--echelon", "-e", action="store_true")
    ap.add_argument("--threeStateHdp", action="store_true")
    ap.add_argument("--templateHmm", "-y", default=None,
                    help="trained template HMM to load (vanillaAlign -y)")
    ap.add_argument("--complementHmm", "-z", default=None)
    ap.add_argument("--templateHdp", "-v", default=None,
                    help="serialized template NanoporeHDP (threeStateHdp)")
    ap.add_argument("--complementHdp", "-w", default=None)
    ap.add_argument("--substitute", "-M", default=None)
    ap.add_argument("--threshold", "-D", type=float, default=0.01)
    ap.add_argument("--diagonalExpansion", "-x", type=int, default=50)
    ap.add_argument("--constraintTrim", "-m", type=int, default=14)
    ap.add_argument("--cigar", default=None,
                    help="guide alignment cigar file (else built-in anchorer)")
    args = ap.parse_args(argv)

    sm_type = ("threeState" if args.strawMan else
               "fourState" if args.fourState else
               "echelon" if args.echelon else
               "threeStateHdp" if args.threeStateHdp else "vanilla")
    # HDP densities (threeStateHdp).  With --substitute the target holds
    # symbols of the HDP's own alphabet (E/O), so the density ranks k-mers
    # over that alphabet (alphabet_density_fn) and the jobs take the
    # host-built grids; else the device builds E from the density table
    hdp_density = {}
    for strand, path in (("t", args.templateHdp), ("c", args.complementHdp)):
        if path:
            nhdp = deserialize_nhdp(path)
            hdp_density[strand] = (nhdp.alphabet_density_fn() if args.substitute
                                   else nhdp.density_logp_fn())
    if sm_type == "threeStateHdp" and len(hdp_density) < 2:
        print("threeStateHdp needs --templateHdp and --complementHdp", file=sys.stderr)
        return 1
    device = resolve_device()
    contig, ref_seq = read_first_sequence(args.reference)
    npread = load_npread(args.npRead)
    params = cli_defaults().with_(threshold=args.threshold,
                                  diagonal_expansion=args.diagonalExpansion,
                                  constraint_diagonal_trim=args.constraintTrim)
    guide = None
    if args.cigar:
        with open(args.cigar) as fh:
            guide = parse_cigar_line(fh.readline())

    # trained models (vanillaAlign -y/-z, vanillaAlign.c:223-226): transitions
    # and k-mer gap probabilities, or skip bins, by the file's model type
    trained = {strand: signal_sm_params(load_signal_hmm(path))
               for strand, path in (("t", args.templateHmm), ("c", args.complementHmm))
               if path}
    prep = prepare_read(ref_seq, npread, params, sm_type=sm_type, guide=guide,
                        substitute=args.substitute,
                        template_model=load_pore_model(args.templateModel),
                        complement_model=load_pore_model(args.complementModel),
                        trained=trained, hdp_density=hdp_density)
    if prep["status"] != "ok":
        print(f"{args.readLabel} unmapped", file=sys.stderr)
        return 1
    pairs = compute_pairs(prep, params, device=device)
    # "w": re-running into an existing file must not duplicate rows
    out_fh = open(args.posteriors, "w") if args.posteriors else None
    try:
        res = finish_read(prep, pairs, out_fh, args.readLabel, contig)
    finally:
        if out_fh:
            out_fh.close()
    t, c = res["t"], res["c"]
    print(f"{args.readLabel} {res['n_anchors']}\t{len(t.probs)}({t.score:f})\t"
          f"{len(c.probs)}({c.score:f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
