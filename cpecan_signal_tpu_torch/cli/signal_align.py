"""Multi-read alignment CLI: the signalAlign.py equivalent (port of
cli/signal_align.py:104-204, 207-363, single process).

Enumerates fast5 and npRead files (shuffled, capped at --nb_files; a fast5
read goes through io/fast5, which imports h5py only then), pools every
read's template and complement split jobs into device batches (one
process, one device, engine/batch_align), and writes the 15-column
posterior TSV (signalAlign.py:54-146).  The machine is vanilla by default, threeState
(-s), fourState or echelon.  Every machine takes the pooled route,
echelon included (the JAX CLI aligns echelon reads one at a time).
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import sys

from ..engine.batch_align import assemble_pairs, batch_align_stream
from ..io.fasta import read_first_sequence
from ..io.npread import load_npread
from ..models.params import cli_defaults
from ..models.pore_model import load_pore_model
from ..utils.device import resolve_device
from .vanilla_align import finish_read, guide_alignment, prepare_read, strand_jobs


class TargetRegions:
    """BED-ish region filter (TargetRegions, nanoporeLib.py:246-270)."""

    def __init__(self, path: str):
        self.regions = []
        with open(path) as fh:
            for line in fh:
                f = line.split()
                if len(f) >= 2:
                    self.regions.append((int(f[0]), int(f[1])))

    def hits(self, start: int, end: int) -> bool:
        return any(s <= end and start <= e for s, e in self.regions)


def _batch_align_all(work, device, timing=None):
    """Pool every read's split jobs (reads x strands x splits) into bucketed
    device batches, then write per-read part TSVs.  ``work`` is a list of
    (work index, work item); returns [(work index, label, message, part path
    or None)].  ``timing`` gathers batch_align_stream's seconds by stage.

    A read's ``owners`` entries (which read and strand each job belongs to)
    are recorded only once all its strands' jobs are collected, so a read
    that fails half way contributes no jobs and no owners, and the pairs of
    the reads after it stay attributed to them."""
    out_early = []
    preps = []               # (label, widx, prep, contig, params, out_tsv)
    owners = []
    models = {}
    threshold = work[0][1][5].threshold if work else 0.01

    def per_read_jobs():
        """Per-read prep as a lazy stream, so device waves run while later
        reads are still loaded and prepared on the host."""
        for widx, w in work:
            (path, ref_seq, contig, tmodel_path, cmodel_path, params,
             sm_type, out_tsv, substitute, regions_path) = w
            label = os.path.basename(path)
            # per-read containment: a corrupt read degrades to a retryable
            # 'error:' result instead of ending the whole batch
            try:
                if path.endswith(".fast5"):
                    from ..io.fast5 import fast5_to_npread
                    npread = fast5_to_npread(path)
                else:
                    npread = load_npread(path)
                guide = guide_alignment(ref_seq, npread.twoD_read,
                                        params.constraint_diagonal_trim)
                if guide is None:
                    out_early.append((widx, label, "unmapped", None))
                    continue
                if regions_path is not None:
                    lo, hi = sorted((guide.start1, guide.end1))
                    if not TargetRegions(regions_path).hits(lo, hi):
                        out_early.append((widx, label, "outside target regions", None))
                        continue
                for mp in (tmodel_path, cmodel_path):
                    if mp not in models:
                        models[mp] = load_pore_model(mp)
                prep = prepare_read(ref_seq, npread, params, sm_type=sm_type,
                                    guide=guide, substitute=substitute,
                                    template_model=models[tmodel_path],
                                    complement_model=models[cmodel_path])
                if prep["status"] != "ok":
                    out_early.append((widx, label, prep["status"], None))
                    continue
                read_jobs, read_owners = [], []
                for ctx in prep["strand_ctx"]:
                    jobs = strand_jobs(ctx, params)
                    read_jobs.extend(jobs)
                    read_owners.extend(ctx["strand"] for _ in jobs)
            except Exception as exc:  # noqa: BLE001 - reported per read, retried
                out_early.append((widx, label, f"error: {exc}", None))
                continue
            key = len(preps)
            owners.extend((key, s) for s in read_owners)
            preps.append((label, widx, prep, contig, params, out_tsv))
            yield read_jobs

    _jobs, frags = batch_align_stream(per_read_jobs(), threshold, device=device,
                                      timing=timing)

    out = []
    for key, (label, widx, prep, contig, params, out_tsv) in enumerate(preps):
        pairs = {s: assemble_pairs([f for f, o in zip(frags, owners) if o == (key, s)])
                 for s in ("t", "c")}
        tmp = f"{out_tsv}.{os.getpid()}.{widx}.part"
        with open(tmp, "w") as fh:
            res = finish_read(prep, pairs, fh, label, contig)
        t, c = res["t"], res["c"]
        out.append((widx, label, f"{res['n_anchors']} anchors, "
                    f"t {len(t.probs)}({t.score:.2f}) "
                    f"c {len(c.probs)}({c.score:.2f})", tmp))
    return out_early + out


def main(argv=None):
    ap = argparse.ArgumentParser(description="align many reads (signalAlign equivalent)")
    ap.add_argument("--file_directory", "-d", required=True,
                    help="directory of .fast5 and .npRead files (or a glob)")
    ap.add_argument("--ref", "-r", required=True)
    ap.add_argument("--output_location", "-o", required=True)
    ap.add_argument("--templateModel", "-T", required=True)
    ap.add_argument("--complementModel", "-C", required=True)
    ap.add_argument("--strawMan", "-s", action="store_true")
    ap.add_argument("--fourState", action="store_true")
    ap.add_argument("--echelon", action="store_true")
    ap.add_argument("--nb_files", "-n", type=int, default=500)
    ap.add_argument("--jobs", "-j", type=int, default=1)
    ap.add_argument("--threshold", "-t", type=float, default=0.01)
    ap.add_argument("--diagonalExpansion", "-e", type=int, default=50)
    ap.add_argument("--constraintTrim", "-m", type=int, default=14)
    ap.add_argument("--targetRegions", "-q", default=None)
    ap.add_argument("--retries", type=int, default=2,
                    help="re-attempts for reads that fail with an error")
    ap.add_argument("--un_banded", "-ub", action="store_true")
    ap.add_argument("--substitute", "-M", default=None)
    args = ap.parse_args(argv)

    sm_type = ("threeState" if args.strawMan else
               "fourState" if args.fourState else
               "echelon" if args.echelon else "vanilla")
    if args.jobs > 1:
        raise NotImplementedError("--jobs > 1 (per-read worker processes) is not "
                                  "ported: ROADMAP queue 1, 'Several processes'")
    if os.environ.get("SIGALIGN_COORDINATOR") is not None:
        raise NotImplementedError("multi-host launch (SIGALIGN_COORDINATOR) is not "
                                  "ported: ROADMAP queue 1, 'Several processes'")
    device = resolve_device()
    contig, ref_seq = read_first_sequence(args.ref)
    params = cli_defaults().with_(
        threshold=args.threshold, diagonal_expansion=args.diagonalExpansion,
        constraint_diagonal_trim=args.constraintTrim)
    if args.un_banded:
        params = params.with_(diagonal_expansion=2, anchor_matrix_bigger_than_this=1 << 62)

    if os.path.isdir(args.file_directory):
        paths = sorted(glob.glob(os.path.join(args.file_directory, "*.fast5"))
                       + glob.glob(os.path.join(args.file_directory, "*.npRead")))
    else:
        paths = sorted(glob.glob(args.file_directory))
    random.shuffle(paths)  # signalAlign.py:92 shuffles before capping
    paths = paths[:args.nb_files]
    if not paths:
        print("signal_align - no input files", file=sys.stderr)
        return 1

    os.makedirs(args.output_location, exist_ok=True)
    out_tsv = os.path.join(args.output_location, "posteriors.tsv")
    if os.path.exists(out_tsv):
        os.unlink(out_tsv)
    work = [(p, ref_seq, contig, args.templateModel, args.complementModel,
             params, sm_type, out_tsv, args.substitute, args.targetRegions)
            for p in paths]
    timing: dict = {}
    results = {r[0]: r for r in _batch_align_all(list(enumerate(work)), device, timing)}

    # failure recovery: re-run errored reads, keyed by work index — never by
    # basename, which can collide across directories
    for _attempt in range(max(args.retries, 0)):
        redo = [widx for widx, r in results.items() if r[2].startswith("error:")]
        if not redo:
            break
        for widx in redo:
            print(f"signal_align - retrying {results[widx][1]}", file=sys.stderr)
        results.update((r[0], r) for r in
                       _batch_align_all([(widx, work[widx]) for widx in redo], device,
                                        timing))
    ok = 0
    with open(out_tsv, "a") as merged:
        for _widx, label, msg, part in sorted(results.values()):
            print(f"signal_align - {label}: {msg}", file=sys.stderr)
            ok += "anchors" in msg
            if part and os.path.exists(part):
                with open(part) as fh:
                    merged.write(fh.read())
                os.unlink(part)
    print(f"signal_align - aligned {ok}/{len(results)} reads -> {out_tsv}")
    print("signal_align - seconds by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(timing.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
