"""Static per-machine compute plans (jax-free copy of engine/fb.py:53-120).

``EnginePlan`` is what the forward/backward kernels are generic over.  The
CUDA kernels take it as a small int32 edge table (``edge_table``), one row
per edge, so a new machine needs a new table and no new kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.state_machines import StateMachine


@dataclass(frozen=True)
class EdgePlan:
    """Static per-edge compute plan: transition log-prob = sum of scalar table
    entries (indices into tp_scalar) + per-cell table entries (extra E
    channels n_eclasses + cell id)."""

    src: int
    frm: int
    to: int
    eclass: int
    scalar_ids: tuple[int, ...]
    cell_ids: tuple[int, ...]


@dataclass(frozen=True)
class EnginePlan:
    """Hashable static plan of one state machine."""

    name: str
    n_states: int
    match_state: int
    edges: tuple[EdgePlan, ...]
    logadd: str = "exact"
    n_eclasses: int = 0


def _build_plan(sm: StateMachine, logadd: str) -> tuple[EnginePlan, np.ndarray, list]:
    """Split the state machine's transition values into a scalar vector and a
    list of per-cell source arrays (per-x or per-y, resolved later)."""
    scalar_keys: list[str] = []
    cell_keys: list[str] = []
    for e in sm.spec.edges:
        for k in e.tkeys:
            tv = sm.tvals[k]
            if tv.kind == "s" and k not in scalar_keys:
                scalar_keys.append(k)
            elif tv.kind != "s" and k not in cell_keys:
                cell_keys.append(k)
    edges = tuple(
        EdgePlan(
            e.src, e.frm, e.to, e.eclass,
            tuple(scalar_keys.index(k) for k in e.tkeys if sm.tvals[k].kind == "s"),
            tuple(cell_keys.index(k) for k in e.tkeys if sm.tvals[k].kind != "s"),
        )
        for e in sm.spec.edges
    )
    plan = EnginePlan(sm.spec.name, sm.spec.n_states, sm.spec.match_state, edges,
                      logadd, sm.spec.n_eclasses)
    tp_scalar = np.array([sm.tvals[k].val for k in scalar_keys], dtype=np.float64)
    cell_sources = [(sm.tvals[k].kind, sm.tvals[k].val) for k in cell_keys]
    return plan, tp_scalar, cell_sources


def plan_from(plan) -> EnginePlan:
    """Port-side copy of any object with EnginePlan's fields (e.g. the JAX
    package's ``engine.fb.EnginePlan``)."""
    return EnginePlan(plan.name, plan.n_states, plan.match_state,
                      tuple(EdgePlan(e.src, e.frm, e.to, e.eclass,
                                     tuple(e.scalar_ids), tuple(e.cell_ids))
                            for e in plan.edges),
                      plan.logadd, plan.n_eclasses)


# Edge-table layout shared with csrc/fb_sm3.cu: one int32 row per edge,
# [src, frm, to, eclass, scalar ids (MAX_EDGE_IDS, -1 padded),
#  E channel ids of the per-cell terms (MAX_EDGE_IDS, -1 padded)].
MAX_EDGE_IDS = 4
EDGE_COLS = 4 + 2 * MAX_EDGE_IDS


def edge_table(plan: EnginePlan) -> np.ndarray:
    """(n_edges, EDGE_COLS) int32 edge table of ``plan``.  Summation order
    inside the kernels follows the table order (emission class first, then
    the cell channels; scalars left to right), as in ops/pallas_fb."""
    tab = np.full((len(plan.edges), EDGE_COLS), -1, dtype=np.int32)
    for i, e in enumerate(plan.edges):
        if len(e.scalar_ids) > MAX_EDGE_IDS or len(e.cell_ids) > MAX_EDGE_IDS:
            raise ValueError(f"edge {i} of {plan.name} has more than "
                             f"{MAX_EDGE_IDS} scalar or cell terms")
        tab[i, :4] = (e.src, e.frm, e.to, e.eclass)
        tab[i, 4:4 + len(e.scalar_ids)] = e.scalar_ids
        chans = [plan.n_eclasses + c for c in e.cell_ids]
        tab[i, 4 + MAX_EDGE_IDS:4 + MAX_EDGE_IDS + len(chans)] = chans
    return tab
