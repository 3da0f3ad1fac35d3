"""HDP build/update drivers.

  - build_hdp_from_alignment: one-shot template+complement NHDP build from a
    posterior-alignment TSV (nanoporeHdp_buildNanoporeHdpFromAlignment,
    nanopore_hdp.c:910-944; template rows are strand 't', complement 'c',
    both trained with the reference's default Gibbs budget 10k/100k/100).
  - update_hdp_from_assignments: Gibbs-update an existing serialized HDP from
    an HdpHmm expectations file (updateHdpFromAssignments, vanillaAlign.c:142-154).
  - compare_distributions CLI: dump every k-mer's density on a linspace grid
    (compareDistributions.c:43-95).

Copied from ``cpecan_signal_tpu/cli/build_hdp.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package; ``main``
drops the JAX CLI's ensure_host_platform, which only selects a JAX
backend (the HDP code runs on the host in both packages), and a build
from alignments names its pore models (-T, -C), which the JAX CLI
defaults to files outside the repository.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..constants import EPIGENETIC_ALPHABET, KMER_LENGTH
from ..em.accumulators import HdpHmm
from ..hdp.nanopore import (HDP_TYPES, NanoporeHDP, build_nanopore_hdp,
                            deserialize_nhdp)

DEFAULT_GIBBS = dict(num_samples=10_000, burn_in=100_000, thinning=100)


def build_hdp_from_alignment(hdp_type: str | int, template_model: str,
                             complement_model: str, alignments_tsv: str,
                             template_out: str, complement_out: str,
                             alphabet: str = EPIGENETIC_ALPHABET,
                             gibbs=DEFAULT_GIBBS, grid=None,
                             log=print) -> tuple[NanoporeHDP, NanoporeHDP]:
    if isinstance(hdp_type, int):
        hdp_type = HDP_TYPES[hdp_type]
    out = [None, None]

    def build_one(i, strand, model, path):
        kwargs = {} if grid is None else {"grid": grid}
        nhdp = build_nanopore_hdp(hdp_type, model, alphabet=alphabet, **kwargs)
        n = nhdp.update_from_alignment(alignments_tsv, strand_filter=strand)
        log(f"build_hdp - {strand}: {n} assignments")
        if n:
            nhdp.gibbs(**gibbs)
            nhdp.finalize()
            nhdp.serialize(path)
        out[i] = nhdp

    # template and complement build in parallel, mirroring the reference's
    # OpenMP sections (nanopore_hdp.c:915-944); the Gibbs loop runs inside
    # the native library, which releases the GIL for the ctypes call
    import threading
    threads = [threading.Thread(target=build_one, args=(i, s, m, p))
               for i, (s, m, p) in enumerate(
                   (("t", template_model, template_out),
                    ("c", complement_model, complement_out)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return tuple(out)


def update_hdp_from_assignments(nhdp_path: str, expectations_path: str,
                                out_path: str, gibbs=DEFAULT_GIBBS,
                                log=print) -> NanoporeHDP:
    """Reload assignments from an HdpHmm file into a *fresh* HDP of the same
    topology, Gibbs-sample, finalize and serialize.

    Divergence note: the reference deserializes the full factor tree and
    continues sampling in place (vanillaAlign.c:142-154); here the sampler is
    re-initialized from the assignments, which draws from the same posterior.
    """
    old = deserialize_nhdp(nhdp_path)
    hmm = HdpHmm.load(expectations_path)
    from ..hdp.nanopore import build_nanopore_hdp as build
    # reuse the old prior parameters by rebuilding with the same structure
    nhdp = NanoporeHDP(
        alphabet=old.alphabet, kmer_length=old.kmer_length,
        topology=old.topology,
        hdp=_fresh_like(old))
    n = nhdp.set_assignments(hmm.kmer_assignments, hmm.event_assignments)
    log(f"update_hdp - {n} assignments")
    if n:
        nhdp.gibbs(**gibbs)
        nhdp.finalize()
    nhdp.serialize(out_path)
    return nhdp


def _fresh_like(old: NanoporeHDP):
    from ..hdp.core import HierarchicalDirichletProcess
    from ..hdp.nanopore import _topology_parents
    p = old.hdp.params
    parents, depth = _topology_parents(old.topology, old.alphabet, old.kmer_length)
    return HierarchicalDirichletProcess(
        parents, depth, p["mu"], p["nu"], p["alpha"], p["beta"],
        p["grid_start"], p["grid_stop"], p["grid_length"],
        gamma=[1.0] * depth)


def compare_distributions_main(argv=None):
    """Dump every k-mer's density on a grid to per-kmer files
    (compareDistributions.c)."""
    ap = argparse.ArgumentParser(description="dump HDP kmer distributions")
    ap.add_argument("nhdp")
    ap.add_argument("out_dir")
    ap.add_argument("--start", type=float, default=30.0)
    ap.add_argument("--stop", type=float, default=90.0)
    ap.add_argument("--points", type=int, default=600)
    args = ap.parse_args(argv)

    nhdp = deserialize_nhdp(args.nhdp)
    os.makedirs(args.out_dir, exist_ok=True)
    xs = np.linspace(args.start, args.stop, args.points)
    n = len(nhdp.alphabet)

    def kmers(prefix, k):
        if k == 0:
            yield prefix
            return
        for c in nhdp.alphabet:
            yield from kmers(prefix + c, k - 1)

    for kmer in kmers("", nhdp.kmer_length):
        dens = nhdp.kmer_density(kmer, xs)
        with open(os.path.join(args.out_dir, f"{kmer}_distr.txt"), "w") as fh:
            for x, d in zip(xs, dens):
                fh.write(f"{x}\t{d}\n")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description="build/update nanopore HDPs")
    ap.add_argument("--buildHDP", "-U", action="store_true")
    ap.add_argument("--HdpType", "-p", type=int, default=0)
    ap.add_argument("--alignments", "-a", default=None)
    # the JAX CLI defaults these to the reference's R7.3 models outside the
    # repository; here a build from alignments names them
    ap.add_argument("--templateModel", "-T", default=None)
    ap.add_argument("--complementModel", "-C", default=None)
    ap.add_argument("--templateHdp", "-v", required=True)
    ap.add_argument("--complementHdp", "-w", required=True)
    ap.add_argument("--templateExpectations", "-t", default=None)
    ap.add_argument("--complementExpectations", "-c", default=None)
    ap.add_argument("--samples", type=int, default=10_000)
    ap.add_argument("--burnIn", type=int, default=100_000)
    ap.add_argument("--thinning", type=int, default=100)
    args = ap.parse_args(argv)

    gibbs = dict(num_samples=args.samples, burn_in=args.burnIn,
                 thinning=args.thinning)
    if args.alignments:
        if not (args.templateModel and args.complementModel):
            ap.error("--alignments needs --templateModel and --complementModel")
        build_hdp_from_alignment(args.HdpType, args.templateModel,
                                 args.complementModel, args.alignments,
                                 args.templateHdp, args.complementHdp,
                                 gibbs=gibbs)
    else:
        if args.templateExpectations:
            update_hdp_from_assignments(args.templateHdp,
                                        args.templateExpectations,
                                        args.templateHdp, gibbs=gibbs)
        if args.complementExpectations:
            update_hdp_from_assignments(args.complementHdp,
                                        args.complementExpectations,
                                        args.complementHdp, gibbs=gibbs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
