"""The least time an H100 could take for the pair-HMM work of a run, counted
from the problem and not from any implementation's intermediates.

Operations: each band cell of each job (the cells the band holds, whatever
lanes an implementation pads it to) times the f32 operations of the
pipeline per cell: the emissions, the forward and the backward with its
posteriors or, for EM, its tallies.  The per-cell arithmetic follows the
logAdd and edge structure the port's kernels evaluate (a copy of
``chip_smoke.ops_per_cell``; an exp or a log counts 1).  Bytes: the
pipeline's inputs read once (the event rows, the per-k-mer parameter pack,
the band's per-diagonal scalars, the start and end vectors) and its outputs
written once (the tallies for EM, a posterior per band cell for
alignment).  F, B and E are intermediates and are not counted.  Peaks: the
H100 SXM's published 67 TFLOP/s of f32 outside the tensor cores and 3.35 TB/s
of HBM3, at its 700 W limit.
"""

from __future__ import annotations

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
LADD_OPS = 14            # the C code's cubic logAdd
EMISSION_OPS = {"signal": 28, "symbol": 0}   # per cell: two Gaussians for two classes;
                                             # a symbol machine looks its tables up
PACK_ROWS = 13           # f32 parameters a k-mer carries into the emissions
DIAG_SCALARS = 8         # int32 scalars a diagonal carries
# kernels of the emissions -> forward -> backward pipeline, by name
PIPELINE_KERNELS = ("emissions_kernel", "recursion_kernel", "epilogue_kernel",
                    "carry_kernel")


def ops_per_cell(kernel: str, edges, n_states: int, n_post: int = 1,
                 wgroups=(), terms_per_edge: int = 2) -> int:
    """f32 operations per band cell of one kernel.  ``edges`` are (src, ...)
    tuples, src 1 the middle (match) edges.  An edge adds its terms
    (emission and transition) to its source and logAdds the sum: terms + 14.
    forward: its edges.  backward: the edges, the middle edges of the
    match-through-diagonal total, 11 a state (the totals' two logsumexps),
    4 a posterior channel and 7 a cell; at EM's stage 4 also 6 + terms an
    edge (its tally), each window group's members + 2 and the likelihood's
    add."""
    edge_ops = len(edges) * (terms_per_edge + LADD_OPS)
    if kernel == "forward":
        return edge_ops
    middle = sum(terms_per_edge + LADD_OPS for e in edges if e[0] == 1)
    ops = edge_ops + middle + 11 * n_states + 4 * n_post + 7
    if kernel == "backward_em":
        ops += len(edges) * (6 + terms_per_edge) + sum(len(g) + 2 for g in wgroups) + 1
    return ops


def pipeline_ops_per_cell(edges, n_states: int, emissions: str, em: bool,
                          wgroups=()) -> int:
    """Operations per band cell of emissions, forward and backward."""
    back = ops_per_cell("backward_em" if em else "backward", edges, n_states,
                        wgroups=wgroups)
    return EMISSION_OPS[emissions] + ops_per_cell("forward", edges, n_states) + back


def job_bytes(n_kmers: int, n_events: int, n_diagonals: int, n_states: int,
              band_cells: int, em: bool) -> int:
    """Bytes one job's pipeline reads once and writes once."""
    inputs = (PACK_ROWS * n_kmers + 2 * n_events) * 4 + DIAG_SCALARS * 4 * n_diagonals \
        + 2 * n_states * 4
    return inputs + (0 if em else 4 * band_cells)


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pipeline_seconds(device_seconds: dict[str, float]) -> float:
    """Summed device time of the pipeline's kernels, by kernel name."""
    return sum(v for n, v in device_seconds.items()
               if any(k in n for k in PIPELINE_KERNELS))
