"""Exonerate-style CIGAR records (sonLib cigarRead/cigarWrite equivalents).

Line format (as produced by lastz --format=cigar and consumed by cigarRead):
  cigar: <q> <qstart> <qend> <qstrand> <t> <tstart> <tend> <tstrand> <score>
         [op length]...
Strand is '+'/'-'; on '-', start > end (coordinates are exclusive-end on the
forward strand).

Copied from ``cpecan_signal_tpu/io/cigar.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator


@dataclass
class CigarRecord:
    contig1: str
    start1: int
    end1: int
    strand1: bool  # True == '+'
    contig2: str
    start2: int
    end2: int
    strand2: bool
    score: float
    ops: list[tuple[str, int]] = field(default_factory=list)

    def to_line(self) -> str:
        parts = ["cigar:",
                 self.contig1, str(self.start1), str(self.end1),
                 "+" if self.strand1 else "-",
                 self.contig2, str(self.start2), str(self.end2),
                 "+" if self.strand2 else "-",
                 str(self.score)]
        for op, ln in self.ops:
            parts.append(op)
            parts.append(str(ln))
        return " ".join(parts)


def parse_cigar_line(line: str) -> CigarRecord | None:
    tokens = line.split()
    if not tokens or tokens[0] != "cigar:":
        return None
    rec = CigarRecord(
        contig1=tokens[1], start1=int(tokens[2]), end1=int(tokens[3]),
        strand1=tokens[4] == "+",
        contig2=tokens[5], start2=int(tokens[6]), end2=int(tokens[7]),
        strand2=tokens[8] == "+",
        score=float(tokens[9]))
    ops = tokens[10:]
    rec.ops = [(ops[i], int(ops[i + 1])) for i in range(0, len(ops), 2)]
    return rec


def read_cigars(fh) -> Iterator[CigarRecord]:
    for line in fh:
        rec = parse_cigar_line(line)
        if rec is not None:
            yield rec
