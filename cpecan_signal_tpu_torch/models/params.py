"""Alignment runtime parameters.

Single config object mirroring PairwiseAlignmentParameters and its defaults
(pairwiseAligner.c:1428-1441); the vanillaAlign CLI overrides diagonalExpansion
to 50 (vanillaAlign.c:371).

Copied from ``cpecan_signal_tpu/models/params.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class AlignmentParams:
    threshold: float = 0.01
    min_diags_between_traceback: int = 1000
    traceback_diagonals: int = 40
    diagonal_expansion: int = 20
    constraint_diagonal_trim: int = 14
    anchor_matrix_bigger_than_this: int = 500 * 500
    repeat_mask_matrix_bigger_than_this: int = 500 * 500
    split_matrix_bigger_than_this: int = 3000 * 3000
    align_ambiguity_characters: bool = False
    gap_gamma: float = 0.5
    # TPU extension (None = reference parity): split unanchored gaps whose
    # min dimension exceeds this, capping the static window width at
    # ~max_gap_min_dim + 2*expansion + 1 (see core/anchors.get_split_points).
    max_gap_min_dim: int | None = None

    def with_(self, **kw) -> "AlignmentParams":
        return replace(self, **kw)


def cli_defaults() -> AlignmentParams:
    """vanillaAlign CLI defaults (expansion 50, vanillaAlign.c:371-373)."""
    return AlignmentParams(diagonal_expansion=50)
