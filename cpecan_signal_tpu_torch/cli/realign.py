"""Nucleotide realigner: the cPecanRealign equivalent (port of
cli/realign.py).

Reads exonerate CIGARs on stdin and fasta sequences, realigns every record
with the 5-state pair HMM using the input alignment as anchors, and writes
realigned CIGARs to stdout (cPecanRealign.c:382-675): all records' split
jobs go through the symbol lane on the card in one batch
(engine/batch_align), then each record's AMAP reweighting, ordered-pair
filter and CIGAR conversion run on the host.  ``--outputExpectations``
writes the records' fiveState EM tallies instead (em/discrete.py), the
nucleotide-EM worker path.  ``--engine host`` runs each record through the
f64 oracle on the same device instead (``realign_record``,
engine/align.align_sequence_pair and em/expectation_driver), as the JAX
CLI's host route does.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..core import amap
from ..core.anchors import cigar_to_anchor_pairs, filter_to_remove_overlap
from ..em.accumulators import DiscreteHmm
from ..em.expectation_driver import discrete_expectations
from ..engine.align import align_sequence_pair
from ..io.cigar import CigarRecord, read_cigars
from ..io.fasta import read_fasta, reverse_complement
from ..models.params import AlignmentParams
from ..models.state_machines import bind_symbol_sequences, make_symbol_sm5
from ..utils.device import resolve_device
from ..utils.observability import counters, timed

def load_sequences(paths: list[str]) -> dict[str, str]:
    seqs: dict[str, str] = {}
    for path in paths:
        for name, seq in read_fasta(path):
            if name in seqs and len(seq) <= len(seqs[name]):
                continue
            seqs[name] = seq
    return seqs


def get_sub_sequence(seq: str, start: int, end: int, strand: bool) -> str:
    if strand:
        return seq[start:end]
    return reverse_complement(seq[end:start])


def sm5_from_hmm(hmm: DiscreteHmm | None):
    """StateMachine5 loaded from a trained discrete HMM (stateMachine5_load-
    Symmetric/-Asymmetric, stateMachine.c:1050-1154) or defaults; dispatch on
    the HMM file's type field like cPecanRealign's loadHmm path."""
    if hmm is None:
        return make_symbol_sm5()
    from ..em.accumulators import TYPE_FIVE_STATE_ASYMMETRIC
    if hmm.type == TYPE_FIVE_STATE_ASYMMETRIC:
        return _sm5_from_hmm_asymmetric(hmm)
    t = hmm.transitions

    def lg(v):
        with np.errstate(divide="ignore"):
            return float(np.log(v))

    trans = {
        "match_continue": lg(t[0, 0]),
        "match_from_short_x": lg((t[1, 0] + t[2, 0]) / 2),
        "match_from_long_x": lg((t[3, 0] + t[4, 0]) / 2),
        "short_open_x": lg((t[0, 1] + t[0, 2]) / 2),
        "short_extend_x": lg((t[1, 1] + t[2, 2]) / 2),
        "short_switch_to_x": lg((t[1, 2] + t[2, 1]) / 2),
        "long_open_x": lg((t[0, 3] + t[0, 4]) / 2),
        "long_extend_x": lg((t[3, 3] + t[4, 4]) / 2),
        "long_switch_to_x": lg((t[3, 4] + t[4, 3]) / 2),
    }
    # long/short swap guard (stateMachine.c:1132-1138)
    if trans["short_extend_x"] > trans["long_extend_x"]:
        for a, b in (("short_extend_x", "long_extend_x"),
                     ("match_from_short_x", "match_from_long_x"),
                     ("short_open_x", "long_open_x"),
                     ("short_switch_to_x", "long_switch_to_x")):
            trans[a], trans[b] = trans[b], trans[a]
    for k in list(trans):
        if k.endswith("_x"):
            trans[k[:-2] + "_y"] = trans[k]
    # symmetric emission load (emissions_em_loadMatchProbsSymmetrically + gap
    # collapse, stateMachine.c:688-732)
    with np.errstate(divide="ignore"):
        e = hmm.emissions[0]
        match4 = np.log((e + e.T) / 2.0)
        gap = np.zeros(4)
        for s in (1, 3):
            gap += hmm.emissions[s].sum(axis=1)
        for s in (2, 4):
            gap += hmm.emissions[s].sum(axis=0)
        gap4 = np.log(gap / gap.sum())
    return make_symbol_sm5(trans, match4, gap4, gap4)


def _sm5_from_hmm_asymmetric(hmm: DiscreteHmm):
    """stateMachine5_loadAsymmetric (stateMachine.c:1050-1098): per-axis
    transition loads with independent long/short swap guards; match emissions
    un-symmetrized, gapX/gapY collapsed from their own gap states only."""
    t = hmm.transitions

    def lg(v):
        with np.errstate(divide="ignore"):
            return float(np.log(v))

    trans = {"match_continue": lg(t[0, 0])}
    for axis, (sg, lg_) in (("x", (1, 3)), ("y", (2, 4))):
        other_sg = 2 if axis == "x" else 1
        other_lg = 4 if axis == "x" else 3
        a = {
            f"match_from_short_{axis}": lg(t[sg, 0]),
            f"match_from_long_{axis}": lg(t[lg_, 0]),
            f"short_open_{axis}": lg(t[0, sg]),
            f"short_extend_{axis}": lg(t[sg, sg]),
            f"short_switch_to_{axis}": lg(t[other_sg, sg]),
            f"long_open_{axis}": lg(t[0, lg_]),
            f"long_extend_{axis}": lg(t[lg_, lg_]),
            f"long_switch_to_{axis}": lg(t[other_lg, lg_]),
        }
        if a[f"short_extend_{axis}"] > a[f"long_extend_{axis}"]:
            for p, q in ((f"short_extend_{axis}", f"long_extend_{axis}"),
                         (f"match_from_short_{axis}", f"match_from_long_{axis}"),
                         (f"short_open_{axis}", f"long_open_{axis}"),
                         (f"short_switch_to_{axis}", f"long_switch_to_{axis}")):
                a[p], a[q] = a[q], a[p]
        trans.update(a)
    with np.errstate(divide="ignore"):
        match4 = np.log(hmm.emissions[0])
        gx = hmm.emissions[1].sum(axis=1) + hmm.emissions[3].sum(axis=1)
        gy = hmm.emissions[2].sum(axis=0) + hmm.emissions[4].sum(axis=0)
        gapx4 = np.log(gx / gx.sum())
        gapy4 = np.log(gy / gy.sum())
    return make_symbol_sm5(trans, match4, gapx4, gapy4)


def stage_record_head(rec: CigarRecord, seqs: dict[str, str],
                      params: AlignmentParams, hmm: DiscreteHmm | None,
                      timing: dict | None = None):
    """realign_record's input prep: rebase to forward strand, CIGAR ->
    anchors, mismatch filter (cPecanRealign.c:556-583).  Returns
    (sub_x, sub_y, anchors_all, filtered_anchors, make_sm).  ``timing``
    gains the count of anchors the CIGAR gave ("head.anchors")."""
    seq_x = seqs[rec.contig1]
    seq_y = seqs[rec.contig2]
    flip1, flip2 = not rec.strand1, not rec.strand2
    shift1 = rec.start1 if rec.strand1 else rec.end1
    shift2 = rec.start2 if rec.strand2 else rec.end2
    sub_x = get_sub_sequence(seq_x, rec.start1, rec.end1, rec.strand1)
    sub_y = get_sub_sequence(seq_y, rec.start2, rec.end2, rec.strand2)

    # rebased forward-strand record
    s1, e1 = (rec.start1 - shift1, rec.end1 - shift1)
    s2, e2 = (rec.start2 - shift2, rec.end2 - shift2)
    if flip1:
        s1, e1 = e1, s1
    if flip2:
        s2, e2 = e2, s2
    anchors_all = cigar_to_anchor_pairs(s1, s2, rec.ops,
                                        params.constraint_diagonal_trim)
    counters.add("head.anchors", len(anchors_all), timing)
    # mismatch filter (cPecanRealign matchFn :268-272), on upper-cased bytes
    bx = np.frombuffer(sub_x.upper().encode("ascii"), dtype=np.uint8)[anchors_all[:, 0]]
    by = np.frombuffer(sub_y.upper().encode("ascii"), dtype=np.uint8)[anchors_all[:, 1]]
    anchors = anchors_all[(bx == by) & (bx != ord("N"))]
    anchors = filter_to_remove_overlap(anchors[np.lexsort(
        (anchors[:, 1], anchors[:, 0]))]) if len(anchors) else anchors

    def make_sm(sx, sy):
        sm = sm5_from_hmm(hmm)
        bind_symbol_sequences(sm, sx, sy)
        return sm

    return sub_x, sub_y, anchors_all, anchors, make_sm


def finish_record(rec: CigarRecord, aligned, sub_x: str, sub_y: str,
                  anchors_all, params: AlignmentParams,
                  rescore: str | None = None, rescore_original: bool = False,
                  split_indels_longer_than: int = -1,
                  timing: dict | None = None) -> list[CigarRecord]:
    """realign_record's output stage: AMAP reweight + consistency filter,
    rescoring, aligned-pairs -> CIGAR, coordinate restore
    (cPecanRealign.c:591-645).  ``timing`` gains the seconds of the
    reweight ("tail.reweight"), the filter ("tail.filter") and the rest
    ("tail.cigar"), and the count of pairs filtered ("amap.filter_pairs")."""
    flip1, flip2 = not rec.strand1, not rec.strand2
    shift1 = rec.start1 if rec.strand1 else rec.end1
    shift2 = rec.start2 if rec.strand2 else rec.end2
    s1, e1 = (rec.start1 - shift1, rec.end1 - shift1)
    s2, e2 = (rec.start2 - shift2, rec.end2 - shift2)
    if flip1:
        s1, e1 = e1, s1
    if flip2:
        s2, e2 = e2, s2
    pairs = np.stack([aligned.probs, aligned.x, aligned.y], axis=1) \
        if len(aligned.probs) else np.zeros((0, 3), dtype=np.int64)

    score = rec.score
    if rescore_original:
        # score the input anchors by the computed posteriors (scoreAnchorPairs)
        pair_w = {(x, y): w for w, x, y in pairs.tolist()}
        pairs = np.asarray([[pair_w.get((x, y), 0), x, y]
                            for x, y in anchors_all.tolist()], dtype=np.int64
                           ).reshape(-1, 3)
    else:
        with timed("tail.reweight", timing):
            pairs = amap.reweight_aligned_pairs(pairs, len(sub_x), len(sub_y),
                                                params.gap_gamma)
        with timed("tail.filter", timing):
            counters.add("amap.filter_pairs", len(pairs), timing)
            pairs = amap.filter_pairs_to_ordered(pairs)

    with timed("tail.cigar", timing):
        if rescore == "posterior":
            score = amap.score_by_posterior(pairs, len(sub_x), len(sub_y), False)
        elif rescore == "posterior_ignoring_gaps":
            score = amap.score_by_posterior(pairs, len(sub_x), len(sub_y), True)
        elif rescore == "identity":
            score = amap.score_by_identity(sub_x, sub_y, pairs, False)
        elif rescore == "identity_ignoring_gaps":
            score = amap.score_by_identity(sub_x, sub_y, pairs, True)

        ops = amap.pairs_to_cigar_ops(pairs, len(sub_x), len(sub_y))
        out = CigarRecord(rec.contig1, 0, e1 if not flip1 else s1, True,
                          rec.contig2, 0, e2 if not flip2 else s2, True,
                          score, ops)
        # restore original coordinates/strands
        def rebase(start, end, strand, shift, flip):
            start += shift
            end += shift
            if flip:
                return end, start, not strand
            return start, end, strand

        out.start1, out.end1, out.strand1 = rebase(0, len(sub_x), True, shift1, flip1)
        out.start2, out.end2, out.strand2 = rebase(0, len(sub_y), True, shift2, flip2)
        if split_indels_longer_than != -1:
            return amap.split_long_indels(out, split_indels_longer_than)
        return [out]


def realign_record(rec: CigarRecord, seqs: dict[str, str],
                   params: AlignmentParams, hmm: DiscreteHmm | None = None,
                   match_gamma: float = 0.0, rescore: str | None = None,
                   rescore_original: bool = False,
                   split_indels_longer_than: int = -1,
                   expectations: DiscreteHmm | None = None, *,
                   device: torch.device | None = None) -> list[CigarRecord] | None:
    """One CIGAR record through the f64 oracle on ``device`` (default: the
    resolved device) (the cPecanRealign.c:556-645 per-record loop): head ->
    banded FB (or, with ``expectations``, the E-step, whose tallies are
    added to it) -> output tail.  ``match_gamma`` is accepted as the JAX
    CLI accepts it, and read by neither."""
    device = resolve_device() if device is None else device
    sub_x, sub_y, anchors_all, anchors, make_sm = stage_record_head(rec, seqs, params, hmm)
    if expectations is not None:
        expectations.add(discrete_expectations(make_sm, sub_x, sub_y, anchors, params,
                                               ragged_left=True, ragged_right=True,
                                               device=device))
        return None
    aligned = align_sequence_pair(make_sm, sub_x, sub_y, anchors, params, ragged_left=True,
                                  ragged_right=True, device=device)
    return finish_record(rec, aligned, sub_x, sub_y, anchors_all, params,
                         rescore=rescore, rescore_original=rescore_original,
                         split_indels_longer_than=split_indels_longer_than)


def record_jobs(records: list[CigarRecord], seqs: dict[str, str],
                params: AlignmentParams, hmm: DiscreteHmm | None,
                timing: dict | None = None):
    """Every record's head and split jobs, flattened.  Returns (heads
    [(sub_x, sub_y, anchors_all)], spans [slice into jobs], jobs).
    ``timing`` gains the seconds of the heads' staging ("head.stage": CIGAR
    to anchors, mismatch and overlap filters) and of their banding and
    splits ("head.split"), and the count of anchors staged
    ("head.anchors")."""
    from ..em.discrete import collect_symbol_split_jobs

    heads, spans, jobs = [], [], []
    for rec in records:
        with timed("head.stage", timing):
            sub_x, sub_y, anchors_all, anchors, make_sm = stage_record_head(rec, seqs, params,
                                                                            hmm, timing)
        with timed("head.split", timing):
            rj = collect_symbol_split_jobs(make_sm, sub_x, sub_y, anchors, params,
                                           ragged_left=True, ragged_right=True)
        spans.append(slice(len(jobs), len(jobs) + len(rj)))
        jobs.extend(rj)
        heads.append((sub_x, sub_y, anchors_all))
    return heads, spans, jobs


def realign_records_batched(records: list[CigarRecord], seqs: dict[str, str],
                            params: AlignmentParams, hmm: DiscreteHmm | None = None,
                            rescore: str | None = None, rescore_original: bool = False,
                            split_indels_longer_than: int = -1, *,
                            device: torch.device, timing: dict | None = None
                            ) -> list[list[CigarRecord]]:
    """Many CIGAR records at once: every record's split jobs in device
    buckets (engine/batch_align), then the per-record output tails
    (cPecanRealign.c:556-645).  ``timing`` gains the seconds of the heads
    and splits ("head", with "head.stage" and "head.split"), the device
    batch ("batch", with its own stages) and the tails ("tail", with
    "tail.assemble" and finish_record's "tail.reweight", "tail.filter" and
    "tail.cigar"), and finish_record's count "amap.filter_pairs"."""
    from ..em.discrete import batched_pairs_for_records
    from ..engine.batch_align import assemble_pairs

    with timed("head", timing):
        heads, spans, jobs = record_jobs(records, seqs, params, hmm, timing)
    with timed("batch", timing):
        frags = batched_pairs_for_records(jobs, params.threshold, device=device,
                                          timing=timing)
    out = []
    with timed("tail", timing):
        for rec, (sub_x, sub_y, anchors_all), span in zip(records, heads, spans):
            with timed("tail.assemble", timing):
                aligned = assemble_pairs(frags[span])
            out.append(finish_record(
                rec, aligned, sub_x, sub_y, anchors_all, params,
                rescore=rescore, rescore_original=rescore_original,
                split_indels_longer_than=split_indels_longer_than, timing=timing))
    return out


def record_expectations(records: list[CigarRecord], seqs: dict[str, str],
                        params: AlignmentParams, hmm: DiscreteHmm | None, acc: DiscreteHmm,
                        *, device: torch.device, timing: dict | None = None,
                        per_record: list | None = None) -> None:
    """Add the records' fiveState EM tallies to ``acc``, job by job in job
    order (the --outputExpectations worker, cPecanRealign.c:584-588).
    ``timing`` gains the seconds of the heads and splits ("head", with
    "head.stage" and "head.split") and the device E-step's spans and
    counters (``discrete_expectations_batched``).  ``per_record`` (a list)
    gains each record's own (trans, emiss, likelihood), in record order:
    its jobs' tallies summed in job order."""
    from ..em.discrete import discrete_expectations_batched

    with timed("head", timing):
        _heads, spans, jobs = record_jobs(records, seqs, params, hmm, timing)
    results = discrete_expectations_batched(jobs, device=device, timing=timing)
    for trans, emiss, lik in results:
        acc.transitions += trans
        acc.emissions += emiss
        acc.likelihood += lik
    if per_record is not None:
        for span in spans:
            mine = results[span]
            per_record.append((sum((r[0] for r in mine), np.zeros_like(acc.transitions)),
                               sum((r[1] for r in mine), np.zeros_like(acc.emissions)),
                               sum((r[2] for r in mine), 0.0)))


def main(argv=None):
    ap = argparse.ArgumentParser(description="nucleotide realigner (cPecanRealign equivalent)")
    ap.add_argument("fastas", nargs="+")
    ap.add_argument("--loadHmm", default=None)
    ap.add_argument("--outputExpectations", default=None)
    ap.add_argument("--gapGamma", type=float, default=0.5)
    ap.add_argument("--matchGamma", type=float, default=0.0)
    ap.add_argument("--diagonalExpansion", type=int, default=20)
    ap.add_argument("--constraintDiagonalTrim", type=int, default=14)
    ap.add_argument("--splitMatrixBiggerThanThis", type=int, default=3000)
    ap.add_argument("--splitIndelsLongerThanThis", type=int, default=-1)
    ap.add_argument("--rescoreOriginalAlignment", action="store_true")
    ap.add_argument("--rescoreByIdentity", action="store_true")
    ap.add_argument("--rescoreByIdentityIgnoringGaps", action="store_true")
    ap.add_argument("--rescoreByPosteriorProb", action="store_true")
    ap.add_argument("--rescoreByPosteriorProbIgnoringGaps", action="store_true")
    ap.add_argument("--engine", choices=("auto", "host", "pallas"), default="auto",
                    help="DP engine: 'pallas' = all records' split jobs batched on "
                         "the device (the name is the JAX CLI's), 'host' = the f64 "
                         "oracle per record on the same device, 'auto' = pallas")
    args = ap.parse_args(argv)
    device = resolve_device()

    params = AlignmentParams(
        gap_gamma=args.gapGamma,
        diagonal_expansion=args.diagonalExpansion,
        constraint_diagonal_trim=args.constraintDiagonalTrim,
        split_matrix_bigger_than_this=args.splitMatrixBiggerThanThis ** 2)
    seqs = load_sequences(args.fastas)
    hmm = DiscreteHmm.load(args.loadHmm) if args.loadHmm else None
    rescore = None
    if args.rescoreByPosteriorProb:
        rescore = "posterior"
    elif args.rescoreByPosteriorProbIgnoringGaps:
        rescore = "posterior_ignoring_gaps"
    elif args.rescoreByIdentity:
        rescore = "identity"
    elif args.rescoreByIdentityIgnoringGaps:
        rescore = "identity_ignoring_gaps"

    records = list(read_cigars(sys.stdin))
    timing: dict = {}
    t0 = time.perf_counter()
    if args.engine == "host":
        expectations = (DiscreteHmm.empty(pseudocount=1e-12) if args.outputExpectations
                        else None)
        for rec in records:
            out = realign_record(rec, seqs, params, hmm=hmm, match_gamma=args.matchGamma,
                                 rescore=rescore,
                                 rescore_original=args.rescoreOriginalAlignment,
                                 split_indels_longer_than=args.splitIndelsLongerThanThis,
                                 expectations=expectations, device=device)
            for r in out or ():
                print(r.to_line())
        if expectations is not None:
            expectations.write(args.outputExpectations)
    elif args.outputExpectations:
        expectations = DiscreteHmm.empty(pseudocount=1e-12)
        record_expectations(records, seqs, params, hmm, expectations, device=device,
                            timing=timing)
        expectations.write(args.outputExpectations)
    else:
        for out in realign_records_batched(
                records, seqs, params, hmm=hmm, rescore=rescore,
                rescore_original=args.rescoreOriginalAlignment,
                split_indels_longer_than=args.splitIndelsLongerThanThis, device=device,
                timing=timing):
            for r in out:
                print(r.to_line())
    print(f"realign - {len(records)} records in {time.perf_counter() - t0:.4f} s; "
          "seconds by stage: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(timing.items())),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
