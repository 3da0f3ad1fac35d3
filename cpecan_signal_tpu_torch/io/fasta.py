"""Minimal FASTA reading/writing (sonLib fastaRead/fastaWrite equivalents).

Copied from ``cpecan_signal_tpu/io/fasta.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Iterator


def read_fasta(path: str) -> Iterator[tuple[str, str]]:
    name = None
    chunks: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def read_first_sequence(path: str) -> tuple[str, str]:
    """First sequence of a fasta, or a bare one-line sequence file (the
    reference's ZymoRef.txt style, vanillaAlign.c:602-604)."""
    with open(path) as fh:
        first = fh.readline().rstrip("\n")
    if first.startswith(">"):
        return next(iter(read_fasta(path)))
    return "seq", first


def write_fasta(path: str, records: list[tuple[str, str]], width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")


_COMP = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMP)[::-1]
