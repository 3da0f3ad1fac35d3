"""lastz-backed anchor generation (the reference's production anchorer).

The reference shells out to its vendored lastz for guide anchors
(getBlastPairs, pairwiseAligner.c:1065-1145: ``--hspthresh=1800 --chain
--strand=plus --gapped --gap=100,100 --format=cigar --ambiguous=iupac,100,100``)
and converts the CIGAR match blocks to (x, y) anchor pairs with
``constraintDiagonalTrim`` pairs shaved off each block end
(convertPairwiseForwardStrandAlignmentToAnchorPairs,
pairwiseAligner.c:1039-1063).  This module reproduces that pipeline against
the same vendored lastz (built in parity/build) so the package's default
seed-chain anchorer (anchor/seed_chain.py) can be differentially measured
against it — and so a user can opt into lastz anchors outright.

CIGAR convention note: lastz's cigar writer emits the QUERY (second input
file) as contig1 and its 'D' advances the TARGET (first file) — which is
the OPPOSITE pairing of the reference's own cigar writer
(cPecanRealign.c:58-101: contig1 = seq1, INDEL_X/'D' advances seq1).  The
reference reads lastz output through that mismatched convention with its
contig assertion compiled out (NDEBUG); here the walk is done with the
arithmetically correct roles and validated against the record's span
coordinates, so the produced anchors are exact.

Copied from ``cpecan_signal_tpu/anchor/lastz.py`` with its imports made
relative to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np

from ..core.anchors import filter_to_remove_overlap
from ..io.cigar import parse_cigar_line

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_LASTZ = os.path.join(_REPO, "parity", "build", "lastz")

LASTZ_ARGS = ["--hspthresh=1800", "--chain", "--strand=plus", "--gapped",
              "--gap=100,100", "--format=cigar", "--ambiguous=iupac,100,100"]


def lastz_available(binary: str | None = None) -> bool:
    return os.path.exists(binary or os.environ.get("CPECAN_LASTZ",
                                                   DEFAULT_LASTZ))


def lastz_anchor_pairs(sx: str, sy: str, trim: int = 14,
                       binary: str | None = None) -> np.ndarray:
    """Monotone (x, y) anchor pairs from lastz, reference-equivalent:
    per-CIGAR match blocks with ``trim`` pairs shaved per end, sorted and
    overlap-filtered."""
    binary = binary or os.environ.get("CPECAN_LASTZ", DEFAULT_LASTZ)
    if len(sx) == 0 or len(sy) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    with tempfile.TemporaryDirectory() as td:
        fx = os.path.join(td, "x.fa")
        fy = os.path.join(td, "y.fa")
        with open(fx, "w") as fh:
            fh.write(">x\n" + sx + "\n")
        with open(fy, "w") as fh:
            fh.write(">y\n" + sy + "\n")
        r = subprocess.run([binary, fx, fy] + LASTZ_ARGS,
                           capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"lastz failed: {r.stderr[-300:]}")
    pairs: list[tuple[int, int]] = []
    for line in r.stdout.splitlines():
        rec = parse_cigar_line(line)
        if rec is None:
            continue
        # lastz: contig1 = query = y side, contig2 = target = x side;
        # 'D' advances x only, 'I' advances y only (span-validated below)
        assert rec.contig1 == "y" and rec.contig2 == "x", (rec.contig1,
                                                          rec.contig2)
        x = rec.start2
        y = rec.start1
        for op, ln in rec.ops:
            if op == "M":
                for l in range(trim, ln - trim):
                    pairs.append((x + l, y + l))
                x += ln
                y += ln
            elif op == "D":
                x += ln
            else:
                y += ln
        assert x == rec.end2 and y == rec.end1, \
            f"lastz cigar span mismatch: {x} vs {rec.end2}, {y} vs {rec.end1}"
    if not pairs:
        return np.zeros((0, 2), dtype=np.int64)
    arr = np.asarray(sorted(pairs), dtype=np.int64)
    return filter_to_remove_overlap(arr)
