"""State machines as declarative transition-edge specs + emission builders.

The reference factors its DP engine over (a) a Sequence element getter and
(b) a ``cellCalculate`` function pointer enumerating the active transitions of
one HMM cell (stateMachine.h:76-102, SURVEY §1).  Here that factoring becomes
data: a state machine is

  * a tuple of ``Edge(src, frm, to, eclass, tkeys)`` — ``src`` names which
    earlier anti-diagonal feeds the transition (LOWER = (x-1,y), MIDDLE =
    (x-1,y-1), UPPER = (x,y-1)), ``eclass`` selects one of the model's
    per-cell emission columns, and ``tkeys`` are transition log-prob terms
    (scalars, or per-x / per-y arrays for k-mer-dependent transitions);
  * start/end/ragged state vectors;
  * a vectorized emission builder that fills an (n_diagonals, band_width,
    n_eclasses) tensor for the whole band in one bulk pass (gathers + pdf
    evals; no per-cell dispatch).

One generic engine (engine/fb.py) consumes any spec: threeState, threeStateHdp,
vanilla, fourState, fiveState and echelon are all edge lists, mirroring the
reference's seven cellCalculate variants (stateMachine.c:829-1460).

Copied from ``cpecan_signal_tpu/models/state_machines.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..constants import KMER_LENGTH, KMER_SENTINEL, LOG_ZERO, NUM_OF_KMERS
from ..core import kmers as kmerlib
from .pore_model import (LEVEL_MEAN, LEVEL_SD, NOISE_LAMBDA, NOISE_MEAN,
                         NOISE_SD, PoreModel, skip_bin_indices)

SRC_LOWER, SRC_MIDDLE, SRC_UPPER = 0, 1, 2

# Canonical state ids (stateMachine.h State enum)
MATCH, SHORT_GAP_X, SHORT_GAP_Y, LONG_GAP_X, LONG_GAP_Y = 0, 1, 2, 3, 4


@dataclass(frozen=True)
class Edge:
    src: int
    frm: int
    to: int
    eclass: int
    tkeys: tuple[str, ...]


@dataclass(frozen=True)
class SMSpec:
    """Static (hashable) part of a state machine — shapes the jitted engine."""

    name: str
    n_states: int
    match_state: int
    n_eclasses: int
    edges: tuple[Edge, ...]


@dataclass
class TV:
    """Transition value: scalar log-prob, or per-x / per-y log-prob array.

    Arrays are indexed by (x_idx + 1) resp. (y_idx + 1) so that DP index -1
    maps to slot 0.
    """

    kind: str  # "s" | "x" | "y"
    val: float | np.ndarray


@dataclass
class StateMachine:
    """A concrete, alignment-ready state machine instance."""

    spec: SMSpec
    tvals: dict[str, TV]
    start: np.ndarray
    ragged_start: np.ndarray
    end: np.ndarray
    ragged_end: np.ndarray
    # emissions(x_idx, y_idx) -> float array (..., n_eclasses); x_idx/y_idx are
    # int arrays of DP sequence indices (-1 allowed).
    emissions: Callable[[np.ndarray, np.ndarray], np.ndarray] = field(repr=False, default=None)


# ---------------------------------------------------------------------------
# Nucleotide symbol machines (fiveState / threeState on bases)
# ---------------------------------------------------------------------------

# Default symbol emissions (emissions_symbol_setEmissionsToDefaults,
# stateMachine.c:60-82): match/transition/transversion log-probs + log(0.2) gaps.
_EM_MATCH = -2.1149196655034745
_EM_TRANSVERSION = -4.5691014376830479
_EM_TRANSITION = -3.9833860032220842
_EM_GAP = -1.6094379124341003
_LOG_QUARTER = -1.386294361  # N gap prob (stateMachine.c:158-160)
_LOG_SIXTEENTH = -2.772588722  # N match prob (stateMachine.c:169-171)

SYMBOL_MATCH_DEFAULT = np.array(
    [[_EM_MATCH, _EM_TRANSVERSION, _EM_TRANSITION, _EM_TRANSVERSION],
     [_EM_TRANSVERSION, _EM_MATCH, _EM_TRANSVERSION, _EM_TRANSITION],
     [_EM_TRANSITION, _EM_TRANSVERSION, _EM_MATCH, _EM_TRANSVERSION],
     [_EM_TRANSVERSION, _EM_TRANSITION, _EM_TRANSVERSION, _EM_MATCH]])
SYMBOL_GAP_DEFAULT = np.full(4, _EM_GAP)


def _pad_symbol_tables(match4: np.ndarray, gapx4: np.ndarray, gapy4: np.ndarray):
    """5x5 / 5 tables with index 4 = N (log 1/16 match, log 1/4 gap)."""
    match = np.full((5, 5), _LOG_SIXTEENTH)
    match[:4, :4] = match4
    gapx = np.concatenate([gapx4, [_LOG_QUARTER]])
    gapy = np.concatenate([gapy4, [_LOG_QUARTER]])
    return match, gapx, gapy


def symbol_codes_for_dp(seq: str) -> np.ndarray:
    """Per-DP-position symbol codes with slot 0 <-> index -1 (code 4 = N)."""
    codes = kmerlib.base_codes(seq)
    codes = np.where(codes < 0, 4, codes).astype(np.int32)
    return np.concatenate([[np.int32(4)], codes])


_GAPX_CLASS, _MATCH_CLASS, _GAPY_CLASS = 0, 1, 2

_SM5_EDGES = (
    Edge(SRC_LOWER, MATCH, SHORT_GAP_X, _GAPX_CLASS, ("short_open_x",)),
    Edge(SRC_LOWER, SHORT_GAP_X, SHORT_GAP_X, _GAPX_CLASS, ("short_extend_x",)),
    Edge(SRC_LOWER, MATCH, LONG_GAP_X, _GAPX_CLASS, ("long_open_x",)),
    Edge(SRC_LOWER, LONG_GAP_X, LONG_GAP_X, _GAPX_CLASS, ("long_extend_x",)),
    Edge(SRC_MIDDLE, MATCH, MATCH, _MATCH_CLASS, ("match_continue",)),
    Edge(SRC_MIDDLE, SHORT_GAP_X, MATCH, _MATCH_CLASS, ("match_from_short_x",)),
    Edge(SRC_MIDDLE, SHORT_GAP_Y, MATCH, _MATCH_CLASS, ("match_from_short_y",)),
    Edge(SRC_MIDDLE, LONG_GAP_X, MATCH, _MATCH_CLASS, ("match_from_long_x",)),
    Edge(SRC_MIDDLE, LONG_GAP_Y, MATCH, _MATCH_CLASS, ("match_from_long_y",)),
    Edge(SRC_UPPER, MATCH, SHORT_GAP_Y, _GAPY_CLASS, ("short_open_y",)),
    Edge(SRC_UPPER, SHORT_GAP_Y, SHORT_GAP_Y, _GAPY_CLASS, ("short_extend_y",)),
    Edge(SRC_UPPER, MATCH, LONG_GAP_Y, _GAPY_CLASS, ("long_open_y",)),
    Edge(SRC_UPPER, LONG_GAP_Y, LONG_GAP_Y, _GAPY_CLASS, ("long_extend_y",)),
)

SM5_SPEC = SMSpec("fiveState", 5, MATCH, 3, _SM5_EDGES)

# Default 5-state transitions (stateMachine5_construct, stateMachine.c:920-937)
SM5_DEFAULT_TRANSITIONS = {
    "match_continue": -0.030064059121770816,
    "match_from_short_x": -1.272871422049609,
    "match_from_long_x": -5.673280173170473,
    "short_open_x": -4.34381910900448,
    "short_extend_x": -0.3388262689231553,
    "short_switch_to_x": -4.910694825551255,
    "long_open_x": -6.30810595366929,
    "long_extend_x": -0.003442492794189331,
    "long_switch_to_x": -6.30810595366929,
}
for _k in list(SM5_DEFAULT_TRANSITIONS):
    if _k.endswith("_x"):
        SM5_DEFAULT_TRANSITIONS[_k[:-2] + "_y"] = SM5_DEFAULT_TRANSITIONS[_k]


def make_symbol_sm5(transitions: dict[str, float] | None = None,
                    match_table: np.ndarray | None = None,
                    gapx_table: np.ndarray | None = None,
                    gapy_table: np.ndarray | None = None) -> StateMachine:
    """5-state affine nucleotide machine (stateMachine5, stateMachine.c:743-1154)."""
    t = dict(SM5_DEFAULT_TRANSITIONS)
    if transitions:
        t.update(transitions)
    match, gapx, gapy = _pad_symbol_tables(
        SYMBOL_MATCH_DEFAULT if match_table is None else match_table,
        SYMBOL_GAP_DEFAULT if gapx_table is None else gapx_table,
        SYMBOL_GAP_DEFAULT if gapy_table is None else gapy_table)

    start = np.full(5, LOG_ZERO)
    start[MATCH] = 0.0
    ragged_start = np.full(5, LOG_ZERO)
    ragged_start[LONG_GAP_X] = 0.0
    ragged_start[LONG_GAP_Y] = 0.0
    end = np.array([t["match_continue"], t["match_from_short_x"], t["match_from_short_y"],
                    t["match_from_long_x"], t["match_from_long_y"]])
    ragged_end = np.array([t["long_open_x"], t["long_open_x"], t["long_open_y"],
                           t["long_extend_x"], t["long_extend_y"]])

    def emissions(x_idx, y_idx, _m=match, _gx=gapx, _gy=gapy):
        raise RuntimeError("symbol emissions are built per sequence; use bind_symbol_sequences")

    sm = StateMachine(SM5_SPEC, {k: TV("s", v) for k, v in t.items()},
                      start, ragged_start, end, ragged_end, emissions)
    sm.symbol_tables = (match, gapx, gapy)
    return sm


def bind_symbol_sequences(sm: StateMachine, seq_x: str, seq_y: str) -> None:
    """Attach per-sequence symbol-code arrays and build the emission closure."""
    match, gapx, gapy = sm.symbol_tables
    cx = symbol_codes_for_dp(seq_x)
    cy = symbol_codes_for_dp(seq_y)

    def emissions(x_idx, y_idx):
        ix = cx[x_idx + 1]
        iy = cy[y_idx + 1]
        e = np.empty(x_idx.shape + (3,), dtype=np.float64)
        e[..., _GAPX_CLASS] = gapx[ix]
        e[..., _MATCH_CLASS] = match[ix, iy]
        e[..., _GAPY_CLASS] = gapy[iy]
        return e

    sm.emissions = emissions
    sm.symbol_codes = (cx, cy)


# ---------------------------------------------------------------------------
# Signal machines
# ---------------------------------------------------------------------------

def _two_dist_logp(table: np.ndarray, ranks: np.ndarray, means, noises) -> np.ndarray:
    """strawMan match emission: logN(mean; level) + logN(noise; fluct)
    (emissions_signal_strawManGetKmerEventMatchProb, stateMachine.c:595-629).
    NumPy version for host prep; jnp version lives in engine prep."""
    p = table[ranks]
    with np.errstate(divide="ignore", invalid="ignore"):
        l1 = _np_log_gauss(means, p[..., LEVEL_MEAN], p[..., LEVEL_SD])
        l2 = _np_log_gauss(noises, p[..., NOISE_MEAN], p[..., NOISE_SD])
    return l1 + l2


def _np_log_gauss(x, mu, sigma):
    ok = sigma != 0.0
    safe = np.where(ok, sigma, 1.0)
    a = (x - mu) / safe
    vals = -0.91893853320467267 - np.log(safe) - 0.5 * a * a
    return np.where(ok, vals, LOG_ZERO)


def _np_log_inv_gauss(noise, mu, lam):
    bad = (mu == 0.0) | (lam <= 0.0) | (noise <= 0.0)
    mu_ = np.where(bad, 1.0, mu)
    lam_ = np.where(bad, 1.0, lam)
    noise_ = np.where(bad, 1.0, noise)
    a = (noise_ - mu_) / mu_
    lp = (np.log(lam_) - 1.8378770664093453 - 3.0 * np.log(noise_)
          - lam_ * a * a / noise_) / 2.0
    return np.where(bad, LOG_ZERO, lp)


def _two_dist_mixed_logp(table: np.ndarray, ranks: np.ndarray, means, noises) -> np.ndarray:
    """Gaussian level x inverse-Gaussian noise (emissions_signal_
    getEventMatchProbWithTwoDists, stateMachine.c:499-528) — vanilla/echelon."""
    p = table[ranks]
    l1 = _np_log_gauss(means, p[..., LEVEL_MEAN], p[..., LEVEL_SD])
    l2 = _np_log_inv_gauss(noises, p[..., NOISE_MEAN], p[..., NOISE_LAMBDA])
    return l1 + l2


_SM3_EDGES = (
    Edge(SRC_LOWER, MATCH, SHORT_GAP_X, _GAPX_CLASS, ("gap_open_x",)),
    Edge(SRC_LOWER, SHORT_GAP_X, SHORT_GAP_X, _GAPX_CLASS, ("gap_extend_x",)),
    Edge(SRC_LOWER, SHORT_GAP_Y, SHORT_GAP_X, _GAPX_CLASS, ("gap_switch_to_x",)),
    Edge(SRC_MIDDLE, MATCH, MATCH, _MATCH_CLASS, ("match_continue",)),
    Edge(SRC_MIDDLE, SHORT_GAP_X, MATCH, _MATCH_CLASS, ("match_from_gap_x",)),
    Edge(SRC_MIDDLE, SHORT_GAP_Y, MATCH, _MATCH_CLASS, ("match_from_gap_y",)),
    Edge(SRC_UPPER, MATCH, SHORT_GAP_Y, _GAPY_CLASS, ("gap_open_y",)),
    Edge(SRC_UPPER, SHORT_GAP_Y, SHORT_GAP_Y, _GAPY_CLASS, ("gap_extend_y",)),
)

SM3_SPEC = SMSpec("threeState", 3, MATCH, 3, _SM3_EDGES)
SM3_HDP_SPEC = SMSpec("threeStateHdp", 3, MATCH, 3, _SM3_EDGES)

# Nanopore defaults (stateMachine3_setTransitionsToNanoporeDefaults,
# stateMachine.c:1278-1289)
SM3_NANOPORE_TRANSITIONS = {
    "match_continue": -0.23552123624314988,
    "match_from_gap_x": -0.21880828092192281,
    "match_from_gap_y": -0.013406326748077823,
    "gap_open_x": -1.6269694202638481,
    "gap_open_y": -4.3187242127300092,
    "gap_extend_x": -1.6269694202638481,
    "gap_extend_y": -4.3187242127239411,
    "gap_switch_to_x": LOG_ZERO,
    "gap_switch_to_y": LOG_ZERO,
}

# Nucleotide defaults (stateMachine3_setTransitionsToNucleotideDefaults,
# stateMachine.c:1265-1276)
SM3_NUCLEOTIDE_TRANSITIONS = {
    "match_continue": -0.030064059121770816,
    "match_from_gap_x": -1.272871422049609,
    "match_from_gap_y": -1.272871422049609,
    "gap_open_x": -4.21256642,
    "gap_open_y": -4.21256642,
    "gap_extend_x": -0.3388262689231553,
    "gap_extend_y": -0.3388262689231553,
    "gap_switch_to_x": -4.910694825551255,
    "gap_switch_to_y": -4.910694825551255,
}

LOG_TENTH = -2.3025850929940455  # default per-kmer gap prob (stateMachine.c:1506-1508)


def _sm3_boundary_vectors(t: dict[str, float]):
    start = np.array([0.0, LOG_ZERO, LOG_ZERO])
    ragged_start = np.array([LOG_ZERO, 0.0, 0.0])
    end = np.array([t["match_continue"], t["match_from_gap_x"], t["match_from_gap_y"]])
    ragged_end = np.array([(t["gap_open_x"] + t["gap_open_y"]) / 2.0,
                           t["gap_extend_x"], t["gap_extend_y"]])
    return start, ragged_start, end, ragged_end


def make_signal_sm3(pore: PoreModel, target_seq: str, events: np.ndarray,
                    transitions: dict[str, float] | None = None,
                    kmer_gap_probs: np.ndarray | None = None) -> StateMachine:
    """threeState "strawMan" signal machine (stateMachine.c:1463-1511, 1725-1735).

    target_seq: nucleotide string; DP length lX = len - K + 1 (lead k-mers).
    events: (lY, 3) event triples (mean, noise, duration).
    kmer_gap_probs: log-space per-kmer gapX emission (EM-trainable); defaults to
    log(0.1) everywhere.
    """
    t = dict(SM3_NANOPORE_TRANSITIONS)
    if transitions:
        t.update(transitions)

    gapx = np.full(NUM_OF_KMERS + 2, LOG_TENTH)
    if kmer_gap_probs is not None:
        gapx[:NUM_OF_KMERS] = kmer_gap_probs
    gapx[NUM_OF_KMERS:] = LOG_ZERO  # sentinel -> LOG_ZERO (emissions_kmer_getGapProb)

    ranks = kmerlib.ranks_with_convention(target_seq, "lead")
    ev = np.concatenate([np.zeros((1, events.shape[1])), events], axis=0)

    match_table = pore.match_model
    y_table = pore.y_model

    def emissions(x_idx, y_idx):
        r = ranks[x_idx + 1]
        means = ev[y_idx + 1, 0]
        noises = ev[y_idx + 1, 1]
        e = np.empty(np.broadcast(x_idx, y_idx).shape + (3,), dtype=np.float64)
        e[..., _GAPX_CLASS] = gapx[r]
        e[..., _MATCH_CLASS] = _two_dist_logp(match_table, r, means, noises)
        e[..., _GAPY_CLASS] = _two_dist_logp(y_table, r, means, noises)
        return e

    start, ragged_start, end, ragged_end = _sm3_boundary_vectors(t)
    sm = StateMachine(SM3_SPEC, {k: TV("s", v) for k, v in t.items()},
                      start, ragged_start, end, ragged_end, emissions)
    sm.kmer_ranks = ranks  # exposed for EM per-kmer tallies
    sm.event_means = events[:, 0]
    # ingredients for the Pallas SM3 parameter-pack path (engine/batch_align
    # routes threeState jobs through make_sm3_pallas_problem, avoiding the
    # host-built (Dp, C, W) emission grid of the generic window path)
    sm.sm3_pack = (pore, target_seq, events, transitions, kmer_gap_probs)
    return sm


_SM4_EDGES = (
    Edge(SRC_LOWER, MATCH, SHORT_GAP_X, _GAPX_CLASS, ("short_open_x",)),
    Edge(SRC_LOWER, SHORT_GAP_X, SHORT_GAP_X, _GAPX_CLASS, ("short_extend_x",)),
    Edge(SRC_LOWER, MATCH, LONG_GAP_X, _GAPX_CLASS, ("long_open_x",)),
    Edge(SRC_LOWER, LONG_GAP_X, LONG_GAP_X, _GAPX_CLASS, ("long_extend_x",)),
    Edge(SRC_LOWER, SHORT_GAP_Y, LONG_GAP_X, _GAPX_CLASS, ("long_switch_to_x",)),
    Edge(SRC_MIDDLE, MATCH, MATCH, _MATCH_CLASS, ("match_continue",)),
    Edge(SRC_MIDDLE, SHORT_GAP_X, MATCH, _MATCH_CLASS, ("match_from_short_x",)),
    Edge(SRC_MIDDLE, SHORT_GAP_Y, MATCH, _MATCH_CLASS, ("match_from_short_y",)),
    Edge(SRC_MIDDLE, LONG_GAP_X, MATCH, _MATCH_CLASS, ("match_from_long_x",)),
    Edge(SRC_UPPER, MATCH, SHORT_GAP_Y, _GAPY_CLASS, ("short_open_y",)),
    Edge(SRC_UPPER, SHORT_GAP_Y, SHORT_GAP_Y, _GAPY_CLASS, ("short_extend_y",)),
)

SM4_SPEC = SMSpec("fourState", 4, MATCH, 3, _SM4_EDGES)

# Template-read defaults (stateMachine4_construct, stateMachine.c:993-1011)
SM4_DEFAULT_TRANSITIONS = {
    "match_continue": -0.23552123624314988,
    "short_open_x": -1.6269694202638481,
    "short_open_y": -4.7241893208381773,
    "long_open_x": -5.4173365013981227,
    "short_extend_x": -1.6269694202638481,
    "match_from_short_x": -0.21880828092192281,
    "long_extend_x": -0.003442492794189331,
    "match_from_long_x": -5.6732801731704612,
    "match_from_short_y": -0.013406326748077823,
    "short_extend_y": -4.724189320832104,
    "long_switch_to_x": -5.4173365013920494,
}


def make_signal_sm4(pore: PoreModel, target_seq: str, events: np.ndarray,
                    transitions: dict[str, float] | None = None,
                    kmer_gap_probs: np.ndarray | None = None) -> StateMachine:
    """fourState signal machine (stateMachine4, stateMachine.c:960-1039)."""
    t = dict(SM4_DEFAULT_TRANSITIONS)
    if transitions:
        t.update(transitions)

    gapx = np.full(NUM_OF_KMERS + 2, LOG_TENTH)
    if kmer_gap_probs is not None:
        gapx[:NUM_OF_KMERS] = kmer_gap_probs
    gapx[NUM_OF_KMERS:] = LOG_ZERO

    ranks = kmerlib.ranks_with_convention(target_seq, "lead")
    ev = np.concatenate([np.zeros((1, events.shape[1])), events], axis=0)
    match_table, y_table = pore.match_model, pore.y_model

    def emissions(x_idx, y_idx):
        r = ranks[x_idx + 1]
        means = ev[y_idx + 1, 0]
        noises = ev[y_idx + 1, 1]
        e = np.empty(np.broadcast(x_idx, y_idx).shape + (3,), dtype=np.float64)
        e[..., _GAPX_CLASS] = gapx[r]
        e[..., _MATCH_CLASS] = _two_dist_logp(match_table, r, means, noises)
        e[..., _GAPY_CLASS] = _two_dist_logp(y_table, r, means, noises)
        return e

    start = np.array([0.0, LOG_ZERO, LOG_ZERO, LOG_ZERO])
    # raggedStart: longGapX | shortGapY (stateMachine4_raggedStartStateProb :791-794)
    ragged_start = np.array([LOG_ZERO, LOG_ZERO, 0.0, 0.0])
    end = np.array([t["match_continue"], t["match_from_short_x"],
                    t["match_from_short_y"], t["match_from_long_x"]])
    ragged_end = np.array([t["long_open_x"], t["long_open_x"],
                           t["long_open_x"], t["long_extend_x"]])
    sm = StateMachine(SM4_SPEC, {k: TV("s", v) for k, v in t.items()},
                      start, ragged_start, end, ragged_end, emissions)
    sm.kmer_ranks = ranks
    sm.event_means = events[:, 0]
    return sm


# Vanilla: per-cell transitions from k-mer skip bins; gap emissions folded into
# transitions (stateMachine3Vanilla_cellCalculate, stateMachine.c:1368-1409).
_ZERO_CLASS, _VMATCH_CLASS, _VSCALED_CLASS = 0, 1, 2

_VANILLA_EDGES = (
    Edge(SRC_LOWER, MATCH, SHORT_GAP_X, _ZERO_CLASS, ("la_mx",)),
    Edge(SRC_LOWER, SHORT_GAP_X, SHORT_GAP_X, _ZERO_CLASS, ("la_xx",)),
    Edge(SRC_MIDDLE, MATCH, MATCH, _VMATCH_CLASS, ("la_mm",)),
    Edge(SRC_MIDDLE, SHORT_GAP_X, MATCH, _VMATCH_CLASS, ("la_xm",)),
    Edge(SRC_MIDDLE, SHORT_GAP_Y, MATCH, _VMATCH_CLASS, ("la_ym",)),
    Edge(SRC_UPPER, MATCH, SHORT_GAP_Y, _VSCALED_CLASS, ("la_my",)),
    Edge(SRC_UPPER, SHORT_GAP_Y, SHORT_GAP_Y, _VSCALED_CLASS, ("la_yy",)),
)

VANILLA_SPEC = SMSpec("vanilla", 3, MATCH, 3, _VANILLA_EDGES)

# Strand-specific fudge factors (stateMachine3Vanilla_setStrandTransitions...,
# stateMachine.c:1291-1303); note 0.17f etc are *float* literals in C.
VANILLA_STRAND_DEFAULTS = {
    "template": {"m_to_y_not_x": np.float32(0.17), "e_to_e": np.float32(0.55)},
    "complement": {"m_to_y_not_x": np.float32(0.14), "e_to_e": np.float32(0.49)},
}
# End-state probs (stateMachine3Vanilla_construct, stateMachine.c:1577-1579)
VANILLA_END_MATCH = -0.23552123624314988
VANILLA_END_FROM_X = -1.6269694202638481
VANILLA_END_FROM_Y = -4.3187242127300092


def vanilla_transition_tables(bins: np.ndarray, strand: str):
    """Per-skip-bin log transition tables for the vanilla machine's five
    per-cell keys, plus its two scalar values (stateMachine3Vanilla's
    kmer-dependent transitions, stateMachine.c:1368-1409).  ``bins`` holds
    beta = bins[0:30] (M->X skip prob per bin) and alpha = bins[30:60]
    (X->X extend prob).  Tables have N_SKIP_BINS + 1 entries — the last is a
    0.0 sentinel the Pallas EM path gathers for padded/out-of-band cells."""
    from ..constants import N_SKIP_BINS

    sd = VANILLA_STRAND_DEFAULTS[strand]
    m_to_y_not_x = float(sd["m_to_y_not_x"])
    e_to_e = float(sd["e_to_e"])
    beta = np.asarray(bins[:N_SKIP_BINS], dtype=np.float64)
    alpha = np.asarray(bins[N_SKIP_BINS:2 * N_SKIP_BINS], dtype=np.float64)
    with np.errstate(divide="ignore"):
        a_my = (1.0 - beta) * m_to_y_not_x
        tabs = {
            "la_mx": np.log(beta),
            "la_xx": np.log(alpha),
            "la_my": np.log(a_my),
            "la_mm": np.log(1.0 - a_my - beta),
            "la_xm": np.log(1.0 - alpha),
        }
        scalars = {"la_yy": float(np.log(e_to_e)),
                   "la_ym": float(np.log(1.0 - e_to_e))}
    tabs = {k: np.concatenate([v, [0.0]]) for k, v in tabs.items()}
    return tabs, scalars


def make_signal_vanilla(pore: PoreModel, target_seq: str, events: np.ndarray,
                        strand: str = "template",
                        skip_bins: np.ndarray | None = None) -> StateMachine:
    """Nanopolish-style vanilla machine: transitions are per-column functions of
    the k-mer skip bins (beta = bins[0:30], alpha = bins[30:60]).

    skip_bins overrides the pore model's (EM-trained VanillaHmm bins).
    """
    bins = pore.skip_bins if skip_bins is None else skip_bins

    km1, ki = kmerlib.trailing_pair_ranks(target_seq)
    bin_idx = skip_bin_indices(km1, ki, pore.match_model)
    tabs, scalars = vanilla_transition_tables(bins, strand)
    la_mx = tabs["la_mx"][bin_idx]
    la_xx = tabs["la_xx"][bin_idx]
    la_my = tabs["la_my"][bin_idx]
    la_mm = tabs["la_mm"][bin_idx]
    la_xm = tabs["la_xm"][bin_idx]
    la_yy = scalars["la_yy"]
    la_ym = scalars["la_ym"]

    ranks = kmerlib.ranks_with_convention(target_seq, "trail")
    ev = np.concatenate([np.zeros((1, events.shape[1])), events], axis=0)
    match_table, y_table = pore.match_model, pore.y_model

    def emissions(x_idx, y_idx):
        # vanilla match emissions use the kmer one past the getKmer2 pointer
        # (the x+1 offset inside getEventMatchProbWithTwoDists) == lead kmer_i.
        r = ki[x_idx + 1]
        means = ev[y_idx + 1, 0]
        noises = ev[y_idx + 1, 1]
        e = np.empty(np.broadcast(x_idx, y_idx).shape + (3,), dtype=np.float64)
        e[..., _ZERO_CLASS] = 0.0
        e[..., _VMATCH_CLASS] = _two_dist_mixed_logp(match_table, r, means, noises)
        e[..., _VSCALED_CLASS] = _two_dist_mixed_logp(y_table, r, means, noises)
        return e

    start = np.array([0.0, LOG_ZERO, LOG_ZERO])
    ragged_start = np.array([LOG_ZERO, 0.0, 0.0])
    end = np.array([VANILLA_END_MATCH, VANILLA_END_FROM_X, VANILLA_END_FROM_Y])
    ragged_end = np.array([(VANILLA_END_FROM_X + VANILLA_END_FROM_Y) / 2.0,
                           VANILLA_END_FROM_X, VANILLA_END_FROM_Y])

    tvals = {
        "la_mx": TV("x", la_mx), "la_xx": TV("x", la_xx),
        "la_mm": TV("x", la_mm), "la_xm": TV("x", la_xm),
        "la_my": TV("x", la_my),
        "la_ym": TV("s", la_ym), "la_yy": TV("s", la_yy),
    }
    sm = StateMachine(VANILLA_SPEC, tvals, start, ragged_start, end, ragged_end, emissions)
    sm.kmer_ranks = ki
    sm.skip_bin_idx = bin_idx
    sm.event_means = events[:, 0]
    return sm


def make_signal_sm3_hdp(density_logp: Callable[[np.ndarray, np.ndarray], np.ndarray],
                        target_seq: str, events: np.ndarray,
                        transitions: dict[str, float] | None = None,
                        density_table=None) -> StateMachine:
    """threeStateHdp machine: match/gapY emission channel = the HDP
    posterior-predictive density of (kmer, descaled event mean); gapX
    emission = log(0.1) (stateMachine3HDP_cellCalculate,
    stateMachine.c:1336-1366).

    density_logp(ranks, means) must return the value the reference adds as
    eP — which is the RAW density, not its log (stateMachine.c:1353-1362
    adds `getMatchProbFcn(...)` = dir_proc_density straight into the
    log-space recursion; zero density contributes 0.0).  Uses the clamped
    k-mer convention (sequence_getKmer3).
    """
    t = dict(SM3_NANOPORE_TRANSITIONS)
    if transitions:
        t.update(transitions)

    # a density fn carrying rank_seq (NanoporeHDP.alphabet_density_fn) ranks
    # the target over the HDP's own alphabet — required for --substitute
    # targets whose k-mers contain E/O (epigenetic alphabet)
    if hasattr(density_logp, "rank_seq"):
        ranks = density_logp.rank_seq(target_seq, "clamp")
    else:
        ranks = kmerlib.ranks_with_convention(target_seq, "clamp")
    ev = np.concatenate([np.zeros((1, events.shape[1])), events], axis=0)

    def emissions(x_idx, y_idx):
        r = ranks[x_idx + 1]
        means = ev[y_idx + 1, 0]
        dens = density_logp(r, means)
        e = np.empty(np.broadcast(x_idx, y_idx).shape + (3,), dtype=np.float64)
        e[..., _GAPX_CLASS] = LOG_TENTH
        e[..., _MATCH_CLASS] = dens
        e[..., _GAPY_CLASS] = dens
        return e

    start, ragged_start, end, ragged_end = _sm3_boundary_vectors(t)
    sm = StateMachine(SM3_HDP_SPEC, {k: TV("s", v) for k, v in t.items()},
                      start, ragged_start, end, ragged_end, emissions)
    sm.kmer_ranks = ranks
    sm.event_means = events[:, 0]
    if density_table is None:
        density_table = getattr(density_logp, "density_table", None)
    if density_table is not None and not hasattr(density_logp, "rank_seq"):
        # (table (R, ng) f32, g0, dg) enables the device alignment fast
        # path (engine/batch_align hdp buckets): the on-device analogue of
        # dir_proc_density's grid interpolation (hdp.c:2577-2601).  The
        # alphabet-ranked (--substitute) mode stays host-evaluated: its
        # ranks are not standard ACGT ranks.
        tab, g0, dg = density_table
        sm.hdp_pack = (tab, float(g0), float(dg), target_seq, events, t)
    return sm


# ---------------------------------------------------------------------------
# Echelon machine: 7 states, events may emit 1..5 kmers
# ---------------------------------------------------------------------------
# States (stateMachine.c SignalState enum :1164-1166): match0 (extra event),
# match1..match5 (event emits n kmers), gapX = 6.  matchState = match1.
ECH_GAPX = 6
_ECH_ZERO, _ECH_M1, _ECH_M2, _ECH_M3, _ECH_M4, _ECH_M5, _ECH_SCALED = range(7)

_ECHELON_EDGES = tuple(
    [Edge(SRC_LOWER, n, ECH_GAPX, _ECH_ZERO, ("la_mx",)) for n in range(1, 6)]
    + [Edge(SRC_LOWER, ECH_GAPX, ECH_GAPX, _ECH_ZERO, ("la_xx",))]
    + [Edge(SRC_MIDDLE, frm, n, n, ("la_mh", f"dur{n}"))
       for n in range(1, 6) for frm in range(6)]
    + [Edge(SRC_MIDDLE, ECH_GAPX, n, n, ("la_xh", f"dur{n}")) for n in range(1, 6)]
    + [Edge(SRC_UPPER, n, 0, _ECH_SCALED, ("la_mh", "dur0")) for n in range(1, 6)]
)

ECHELON_SPEC = SMSpec("echelon", 7, 1, 7, _ECHELON_EDGES)

# End-state values as in the reference (stateMachineEchelon_construct,
# stateMachine.c:1617-1620 — the comment notes they are not in log space; the
# literal behavior is reproduced).
ECHELON_END_MATCH = 0.79015888282447311
ECHELON_END_FROM_X = 0.19652425498269727


def _poisson_posterior_np(n: int, durations: np.ndarray) -> np.ndarray:
    """emissions_signal_poissonPosteriorProb (stateMachine.c:345-370)."""
    c = 0.00332005312085
    l_beta = 0.1397619423751586
    l_factorials = [0.0, 0.0, 0.69314718056, 1.79175946923, 3.17805383035,
                    4.78749174278]
    lam = durations / c
    safe = np.where(lam <= 0, 1.0, lam)
    lp = (n + 1) * l_beta + n * np.log(safe) - l_factorials[n] - 2.0 * lam
    return np.where(lam <= 0, LOG_ZERO, lp)


def make_signal_echelon(pore: PoreModel, target_seq: str, events: np.ndarray,
                        strand: str = "template",
                        skip_bins: np.ndarray | None = None) -> StateMachine:
    """Echelon machine (stateMachineEchelon, stateMachine.c:1411-1460,
    1602-1642): an event may emit n = 1..5 consecutive k-mers; transitions mix
    per-x skip-bin probabilities with per-y Poisson duration posteriors.  The
    target is 'n'-padded (sequence_padSequence, pairwiseAligner.c:282-285) so
    multi-kmer emissions past the end go to LOG_ZERO via the uppercase check
    (emissions_signal_multipleKmerMatchProb, stateMachine.c:530-549)."""
    bins = pore.skip_bins if skip_bins is None else skip_bins
    padded = target_seq + "n" * 30
    lX = len(target_seq) - KMER_LENGTH + 1

    km1, ki = kmerlib.trailing_pair_ranks(target_seq)
    bin_idx = skip_bin_indices(km1, ki, pore.match_model)
    beta = bins[bin_idx]
    alpha = bins[bin_idx + 30]
    with np.errstate(divide="ignore"):
        la_mx = np.log(beta)
        la_xx = np.log(alpha)
        la_mh = np.log(1.0 - beta)
        la_xh = np.log(1.0 - alpha)

    # per-y duration posteriors (slot 0 <-> y = -1)
    dur = np.zeros((6, len(events) + 1))
    for n in range(6):
        dur[n, 1:] = _poisson_posterior_np(n, events[:, 2])
        dur[n, 0] = LOG_ZERO

    # trailing-convention rank arrays at offsets 0..4 from the getKmer2
    # pointer, over the 'n'-padded sequence; plus the uppercase check at
    # offset KMER_LENGTH * n from the pointer.
    base_padded = kmerlib.sequence_kmer_ranks(padded)
    codes = kmerlib.base_codes(padded)

    def ranks_at_offset(off: int) -> np.ndarray:
        # DP slot j <-> x_idx = j - 1; getKmer2 pointer = elements[i - 1]
        # for i > 0 else elements[0]; multipleKmerMatchProb passes
        # x_i = pointer + off and getEventMatchProbWithTwoDists reads the
        # kmer at x_i + 1 (stateMachine.c:499-512), so the k-mer for offset
        # off starts at pointer + off + 1.
        out = np.full(lX + 1, KMER_SENTINEL, dtype=np.int32)
        for j in range(lX + 1):
            i = j - 1
            p = i - 1 if i > 0 else 0
            idx = p + off + 1
            if 0 <= idx < len(base_padded):
                out[j] = base_padded[idx]
        return out

    rank_off = np.stack([ranks_at_offset(o) for o in range(5)])
    ok_n = np.zeros((6, lX + 1), dtype=bool)
    for n in range(1, 6):
        for j in range(lX + 1):
            i = j - 1
            p = i - 1 if i > 0 else 0
            idx = p + KMER_LENGTH * n
            ok_n[n, j] = idx < len(codes) and codes[idx] >= 0  # uppercase ACGT

    ev = np.concatenate([np.zeros((1, events.shape[1])), events], axis=0)
    match_table, y_table = pore.match_model, pore.y_model
    ki_padded = np.full(lX + 1, KMER_SENTINEL, dtype=np.int32)
    ki_padded[:len(ki)] = ki

    def emissions(x_idx, y_idx):
        j = x_idx + 1
        means = ev[y_idx + 1, 0]
        noises = ev[y_idx + 1, 1]
        shape = np.broadcast(x_idx, y_idx).shape
        e = np.zeros(shape + (7,), dtype=np.float64)
        # classes 1..5: logAdd of the n single-kmer two-dist probs - log n.
        # The reference seeds its logAdd chain with p = 0.0 — log-space 1.0,
        # NOT LOG_ZERO (emissions_signal_multipleKmerMatchProb,
        # stateMachine.c:532) — so every multi-kmer emission carries a
        # spurious +1 term that dominates the sum; reproduced for parity.
        per_off = np.stack([
            _two_dist_mixed_logp(match_table, rank_off[o][j], means, noises)
            for o in range(5)])
        running = np.zeros(shape)
        for n in range(1, 6):
            running = np.logaddexp(running, per_off[n - 1])
            e[..., n] = np.where(ok_n[n][j], running - np.log(n), LOG_ZERO)
        e[..., _ECH_SCALED] = _two_dist_mixed_logp(y_table, ki_padded[j], means,
                                                   noises)
        return e

    start = np.full(7, LOG_ZERO)
    start[1] = 0.0
    ragged_start = np.full(7, LOG_ZERO)
    ragged_start[ECH_GAPX] = 0.0
    end = np.full(7, ECHELON_END_MATCH)
    end[ECH_GAPX] = ECHELON_END_FROM_X
    ragged_end = end.copy()

    tvals = {"la_mx": TV("x", la_mx), "la_xx": TV("x", la_xx),
             "la_mh": TV("x", la_mh), "la_xh": TV("x", la_xh)}
    for n in range(6):
        tvals[f"dur{n}"] = TV("y", dur[n])
    sm = StateMachine(ECHELON_SPEC, tvals, start, ragged_start, end, ragged_end,
                      emissions)
    sm.kmer_ranks = ki_padded
    sm.skip_bin_idx = bin_idx
    sm.event_means = events[:, 0]
    return sm
