"""The plain reference of signalAlign's threeState pair HMM (``-s``):
events of a read aligned to k-mers of the reference.

From a read (its sequence' events and event maps), its guide and the pore
models this module works out again what the program derives: the
reference window and anchors of each strand (vanillaAlign.c:278-316 as the
port's ``prepare_read`` reads it), the splits and bands, the emissions of
every cell and the machine's transitions; then ``hmm.BandedHMM`` gives the
posteriors, the E-step's tallies and the likelihood, and ``m_step`` the
next parameters (continuousHmm.c:174-232).  Emissions (stateMachine.c:
595-629): gapX the k-mer's gap probability; match the Gaussian level and
the Gaussian noise of the match model scaled to the read; gapY the same
under the unscaled second model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import band as bd
from .hmm import LOWER, MIDDLE, UPPER, BandedHMM, Job, Machine

K = 6
N_KMERS = 4 ** K
SENTINEL = N_KMERS + 1
LOG_TENTH = float(np.log(0.1))
M, X, Y = 0, 1, 2
GAPX, MATCH, GAPY = 0, 1, 2
# stateMachine3_setTransitionsToNanoporeDefaults (stateMachine.c:1278-1289)
DEFAULT_TRANSITIONS = {
    "match_continue": -0.23552123624314988,
    "match_from_gap_x": -0.21880828092192281,
    "match_from_gap_y": -0.013406326748077823,
    "gap_open_x": -1.6269694202638481,
    "gap_open_y": -4.3187242127300092,
    "gap_extend_x": -1.6269694202638481,
    "gap_extend_y": -4.3187242127239411,
    "gap_switch_to_x": float("-inf"),
    "gap_switch_to_y": float("-inf"),
}
# (src, frm, to, emission class, transition key): stateMachine3 cellCalculate
EDGES = (
    (LOWER, M, X, GAPX, "gap_open_x"),
    (LOWER, X, X, GAPX, "gap_extend_x"),
    (LOWER, Y, X, GAPX, "gap_switch_to_x"),
    (MIDDLE, M, M, MATCH, "match_continue"),
    (MIDDLE, X, M, MATCH, "match_from_gap_x"),
    (MIDDLE, Y, M, MATCH, "match_from_gap_y"),
    (UPPER, M, Y, GAPY, "gap_open_y"),
    (UPPER, Y, Y, GAPY, "gap_extend_y"),
)
MACHINE = Machine(3, M, tuple((s, f, t, c, 0.0) for s, f, t, c, _k in EDGES))
_POW4 = 4 ** np.arange(K - 1, -1, -1, dtype=np.int64)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def ranks_lead(codes: np.ndarray) -> np.ndarray:
    """Rank of the k-mer read at sequence index i, at slot i + 1; slot 0 (the
    index -1) is the sentinel."""
    n = len(codes) - K + 1
    out = np.full(max(n, 0) + 1, SENTINEL, dtype=np.int64)
    if n > 0:
        win = np.lib.stride_tricks.sliding_window_view(codes.astype(np.int64), K)
        out[1:] = (win * _POW4).sum(axis=1)
    return out


def scaled(model: np.ndarray, sp=(1.0, 0.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    """The match model scaled to a read (emissions_signal_scaleModel,
    stateMachine.c:631-673): level mean * scale + shift, level sd * var,
    noise mean * scale_sd, lambda * var_sd, noise sd from mean and lambda."""
    scale, shift, var, scale_sd, var_sd = sp
    m = model.copy()
    m[:, 0] = m[:, 0] * scale + shift
    m[:, 1] = m[:, 1] * var
    m[:, 2] = m[:, 2] * scale_sd
    m[:, 4] = m[:, 4] * var_sd
    m[:, 3] = np.sqrt(m[:, 2] ** 3 / m[:, 4])
    return m


def boundary(t: dict) -> tuple[np.ndarray, np.ndarray]:
    """The ragged start and end vectors (both sides of a signal job are
    ragged)."""
    return (np.array([-np.inf, 0.0, 0.0]),
            np.array([(t["gap_open_x"] + t["gap_open_y"]) / 2.0, t["gap_extend_x"],
                      t["gap_extend_y"]]))


@dataclass
class Strand:
    """One read-strand's alignment problem before splitting."""

    read: int
    strand: int            # 0 template, 1 complement
    target: np.ndarray     # base codes of the reference window on this strand
    events: np.ndarray     # (n, 3)
    anchors: np.ndarray    # (m, 2) k-mer index, event index


def strands(read: dict, ref: np.ndarray, index: int, trim: int) -> list[Strand]:
    """Both strands of a read: the reference window the guide covers, the
    events between the guide's ends and the guide's anchors moved onto them
    (the template's event map increases along the read, the complement's
    decreases; the complement aligns to the reverse complement with its
    anchors mirrored)."""
    g = read["guide"]
    if g["strand1"]:
        win = ref[g["start1"]:g["end1"]]
    else:
        win = revcomp(ref[g["end1"]:g["start1"]])
    anchors = bd.sorted_chain(bd.cigar_anchor_pairs(0, g["start2"], g["ops"], trim))
    tm, cm = read["t_map"], read["c_map"]
    end2 = min(g["end2"], len(tm) - 1)
    lx = len(win) - K + 1
    t_ev = read["t_events"][int(tm[g["start2"]]):int(tm[end2])]
    ta = anchors.copy()
    if len(ta):
        ta[:, 1] = tm[ta[:, 1]] - tm[g["start2"]]
        ta = ta[(ta[:, 0] >= 0) & (ta[:, 0] < max(lx, 1)) & (ta[:, 1] >= 0)
                & (ta[:, 1] < max(len(t_ev), 1))]
    ta = bd.filter_to_remove_overlap(ta)
    lo = int(cm[end2])
    c_ev = read["c_events"][lo:int(cm[g["start2"]])]
    ca = anchors
    if len(anchors):
        cx = (lx - 1) - anchors[:, 0]
        cy = cm[np.minimum(anchors[:, 1] + g["start2"], len(cm) - 1)] - lo
        ca = np.stack([cx, cy], axis=1)[::-1]
        ca = bd.filter_to_remove_overlap(ca[(ca >= 0).all(axis=1) & (ca[:, 0] < max(lx, 1))
                                            & (ca[:, 1] < max(len(c_ev), 1))])
    return [Strand(index, 0, win, t_ev, ta), Strand(index, 1, revcomp(win), c_ev, ca)]


class SignalProblems:
    """Every split of every given strand, with the flat per-cell inputs the
    emissions read, on ``device``."""

    def __init__(self, strand_list: list[Strand], models, expansion: int, split_cap: int,
                 device, dtype=torch.float64):
        self.device, self.dtype = device, dtype
        self.jobs: list[Job] = []
        self.owner: list[tuple[int, int]] = []
        ranks, events, xo, yo, strand_id = [], [], [], [], []
        nx = ny = 0
        for s in strand_list:
            if len(s.events) == 0:
                continue
            lx = len(s.target) - K + 1
            for (x1, y1, x2, y2) in bd.split_points(s.anchors, lx, len(s.events), split_cap,
                                                    True, True):
                sub = bd.anchors_in(s.anchors, x1, y1, x2, y2)
                L, R = bd.band(sub, x2 - x1, y2 - y1, expansion)
                self.jobs.append(Job(x2 - x1, y2 - y1, L, R, None, None, x1, y1,
                                     group=s.strand))
                self.owner.append((s.read, s.strand))
                r = ranks_lead(s.target[x1:x2 + K - 1])
                ranks.append(r)
                ev = np.concatenate([np.zeros((1, 3)), s.events[y1:y2]])
                events.append(ev)
                xo.append(nx)
                yo.append(ny)
                nx += len(r)
                ny += len(ev)
                strand_id.append(s.strand)
        dev = device
        self.ranks = torch.as_tensor(np.concatenate(ranks), device=dev)
        self.ev = torch.as_tensor(np.concatenate(events), dtype=dtype, device=dev)
        self.xo = torch.as_tensor(xo, device=dev)
        self.yo = torch.as_tensor(yo, device=dev)
        self.strand_of = torch.as_tensor(strand_id, device=dev)
        pad = np.zeros((2, 5))
        self.match = torch.as_tensor(np.stack([np.concatenate([scaled(m), pad])
                                               for m in models]), dtype=dtype, device=dev)
        self.ymodel = torch.as_tensor(np.stack([np.concatenate([m, pad]) for m in models]),
                                      dtype=dtype, device=dev)
        self.gapx = None

    def rank(self, job, x_idx):
        """Rank of the k-mer at x_idx of each cell's problem ``job``."""
        i = (self.xo[job] + x_idx + 1).clamp(0, len(self.ranks) - 1)
        return self.ranks[i]

    def _log_gauss(self, v, mu, sd):
        ok = sd != 0
        safe = torch.where(ok, sd, torch.ones_like(sd))
        a = (v - mu) / safe
        out = -0.91893853320467267 - torch.log(safe) - 0.5 * a * a
        return torch.where(ok, out, float("-inf"))

    def emissions(self, job, x_idx, y_idx):
        r = self.rank(job, x_idx)
        st = self.strand_of[job]
        ev = self.ev[(self.yo[job] + y_idx + 1).clamp(0, len(self.ev) - 1)]
        mean, noise = ev[..., 0], ev[..., 1]
        mm = self.match[st, r]
        ym = self.ymodel[st, r]
        e_match = (self._log_gauss(mean, mm[..., 0], mm[..., 1])
                   + self._log_gauss(noise, mm[..., 2], mm[..., 3]))
        e_gapy = (self._log_gauss(mean, ym[..., 0], ym[..., 1])
                  + self._log_gauss(noise, ym[..., 2], ym[..., 3]))
        return torch.stack([self.gapx[st, r], e_match, e_gapy], dim=-1)

    def hmm(self, params) -> BandedHMM:
        """The problems under each strand's (transitions, log k-mer gap
        probabilities or None)."""
        gx = np.full((2, N_KMERS + 2), LOG_TENTH)
        for s, (t, kg) in enumerate(params):
            if kg is not None:
                gx[s, :N_KMERS] = kg
            gx[s, N_KMERS:] = -np.inf
        self.gapx = torch.as_tensor(gx, dtype=self.dtype, device=self.device)
        for j in self.jobs:
            t = dict(DEFAULT_TRANSITIONS)
            t.update(params[j.group][0] or {})
            j.start, j.end = boundary(t)
            j.trans = np.array([t[e[4]] for e in EDGES])
        return BandedHMM(self.jobs, MACHINE, self.emissions, self.device, self.dtype)

    def e_step(self, params):
        """Per strand: transition tallies (3, 3), k-mer gap tallies (4096,)
        and the likelihood, as float64 numpy."""
        h = self.hmm(params)
        h.forward()
        h.backward()
        edge, kmer = h.edge_tallies(self.rank, key_states=(X,), n_keys=N_KMERS)
        lik = h.likelihoods().cpu().numpy()
        edge, kmer = edge.cpu().numpy(), kmer.cpu().numpy()
        out = []
        for s in range(2):
            trans = np.zeros((3, 3))
            for i, e in enumerate(EDGES):
                trans[e[1], e[2]] += edge[s, i] if s < len(edge) else 0.0
            out.append((trans, kmer[s] if s < len(kmer) else np.zeros(N_KMERS),
                        float(lik[s]) if s < len(lik) else 0.0))
        return out


def m_step(trans: np.ndarray, kmer: np.ndarray) -> tuple[dict, np.ndarray]:
    """Normalised tallies -> (transitions, log k-mer gap probabilities):
    rows of the transitions and the k-mer tallies each sum to 1; gapX's
    extension is tied to 1 - P(gapX -> match) and gapX -> gapY is banned."""
    tot = trans.sum(axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        t = np.where(tot > 0, trans / tot, trans)
        kg = kmer / kmer.sum() if kmer.sum() > 0 else kmer
        return ({"match_continue": np.log(t[0, 0]), "gap_open_x": np.log(t[0, 1]),
                 "gap_open_y": np.log(t[0, 2]), "match_from_gap_x": np.log(t[1, 0]),
                 "gap_extend_x": np.log(1.0 - t[1, 0]), "gap_switch_to_y": -np.inf,
                 "match_from_gap_y": np.log(t[2, 0]), "gap_extend_y": np.log(t[2, 2]),
                 "gap_switch_to_x": np.log(t[2, 1])}, np.log(kg))
