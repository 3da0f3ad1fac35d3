"""Alignment-TSV analysis utilities.

Equivalents of the reference's analysis scripts (SURVEY §2.2 aux scripts):
  - read_alignment_tsv / per-kmer event histograms
    (generate_kmer_histograms.py + alignmentAnalysisLib.py:16-60)
  - process_posteriors: aligned pairs -> eventalign-style rows
    (process_posteriors.py)
  - summarize_alignments: compare two alignment sets (summarize_alignments.py)
  - duration_analysis: event-duration distributions (duration_analysis.py)

Copied from ``cpecan_signal_tpu/analysis/alignments.py`` with its imports made
relative to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

# 15-column posterior TSV layout (writePosteriorProbs, vanillaAlign.c:86-88)
COLS = ["contig", "ref_pos", "ref_kmer", "read_file", "strand", "event_idx",
        "event_mean", "event_noise", "event_duration", "aligned_kmer",
        "e_level", "e_noise", "posterior", "descaled_mean", "descaled_e_level"]


@dataclass
class AlignmentTable:
    rows: list[dict]

    @classmethod
    def read(cls, path: str) -> "AlignmentTable":
        rows = []
        with open(path) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) != len(COLS):
                    continue
                row = dict(zip(COLS, f))
                for k in ("ref_pos", "event_idx"):
                    row[k] = int(row[k])
                for k in ("event_mean", "event_noise", "event_duration",
                          "e_level", "e_noise", "posterior", "descaled_mean",
                          "descaled_e_level"):
                    row[k] = float(row[k])
                rows.append(row)
        return cls(rows)

    def by_strand(self, strand: str) -> "AlignmentTable":
        return AlignmentTable([r for r in self.rows if r["strand"] == strand])


def kmer_event_histograms(table: AlignmentTable, threshold: float = 0.0,
                          use_descaled: bool = True) -> dict[str, np.ndarray]:
    """Per-kmer observed event means (the kmer histogram inputs,
    alignmentAnalysisLib.py:16-60)."""
    out: dict[str, list[float]] = defaultdict(list)
    key = "descaled_mean" if use_descaled else "event_mean"
    for r in table.rows:
        if r["posterior"] >= threshold:
            out[r["aligned_kmer"]].append(r[key])
    return {k: np.asarray(v) for k, v in out.items()}


def process_posteriors(table: AlignmentTable, threshold: float = 0.5
                       ) -> list[dict]:
    """Max-posterior event->position calls, eventalign-style
    (process_posteriors.py)."""
    best: dict[tuple[str, int], dict] = {}
    for r in table.rows:
        key = (r["strand"], r["event_idx"])
        if key not in best or r["posterior"] > best[key]["posterior"]:
            best[key] = r
    return [r for r in best.values() if r["posterior"] >= threshold]


def summarize_alignments(a: AlignmentTable, b: AlignmentTable) -> dict:
    """Compare two alignment sets (summarize_alignments.py): shared
    (strand, event, ref_pos) calls, mean posteriors, counts."""
    def keyset(t):
        return {(r["strand"], r["event_idx"], r["ref_pos"]) for r in t.rows}

    ka, kb = keyset(a), keyset(b)
    return {
        "n_a": len(a.rows), "n_b": len(b.rows),
        "shared": len(ka & kb),
        "only_a": len(ka - kb), "only_b": len(kb - ka),
        "jaccard": len(ka & kb) / max(len(ka | kb), 1),
        "mean_posterior_a": float(np.mean([r["posterior"] for r in a.rows]) if a.rows else 0),
        "mean_posterior_b": float(np.mean([r["posterior"] for r in b.rows]) if b.rows else 0),
    }


def duration_analysis(table: AlignmentTable) -> dict:
    """Event duration distribution statistics (duration_analysis.py)."""
    d = np.asarray([r["event_duration"] for r in table.rows])
    if len(d) == 0:
        return {"n": 0}
    return {"n": len(d), "mean": float(d.mean()), "median": float(np.median(d)),
            "p90": float(np.percentile(d, 90)), "max": float(d.max())}


def make_build_alignment(tables: list[tuple[AlignmentTable, str | None]],
                         threshold: float = 0.8, max_per_kmer: int = 100,
                         seed: int = 0) -> list[tuple[str, str, float]]:
    """Sample (strand, kmer, signal) assignments for HDP building from
    alignment tables, optionally rewriting C to a substitution character per
    group (makeBuildAlignments.py).  Returns rows (strand, kmer, signal)."""
    rng = np.random.default_rng(seed)
    by_kmer: dict[tuple[str, str], list[tuple[str, float]]] = defaultdict(list)
    for table, substitute in tables:
        for r in table.rows:
            if r["posterior"] < threshold:
                continue
            kmer = r["aligned_kmer"]
            if substitute:
                kmer = kmer.replace("C", substitute)
            by_kmer[(r["strand"], kmer)].append((r["strand"], r["descaled_mean"]))
    out = []
    for (strand, kmer), vals in by_kmer.items():
        if len(vals) > max_per_kmer:
            idx = rng.choice(len(vals), max_per_kmer, replace=False)
            vals = [vals[i] for i in idx]
        out.extend((strand, kmer, v) for _, v in vals)
    return out
