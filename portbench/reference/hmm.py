"""The plain reference of the banded pair HMMs: forward, backward, posterior
match probabilities and per-edge tallies, over many problems at once.

Plain PyTorch on one device, in the precision asked for (float64 for the
reference; a lower one for the control).  A problem is one split of one
alignment: ``lX`` x ``lY`` cells, the band (``xmyL``, ``xmyR`` per
anti-diagonal), its start and end vectors, and a function that gives the
emission of any cell.  A machine is its list of edges
``(src, frm, to, eclass, log transition)``; src 0 reads the cell (x-1, y) on
the previous anti-diagonal, 1 the cell (x-1, y-1) two back, 2 the cell
(x, y-1).  The recursions are the textbook ones, in log space:

    F[c, to] = E_e(c) + lse_e (F[src_e(c), frm_e] + t_e)
    B[c, frm] = lse_e (B[dst_e(c), to_e] + E_e(dst_e(c)) + t_e)

and a posterior is exp(F + B - log P), log P the forward's total with the end
vector.  Problems are stacked longest first, so at anti-diagonal d the
problems still running are a prefix; F and B are kept for every cell of
every running problem, diagonal after diagonal, in one flat buffer.  A
diagonal of the recursion is one gather from that buffer (a table of source
indices built per chunk of diagonals), one add of the edge terms and a fold
over each state's edges.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

LOWER, MIDDLE, UPPER = 0, 1, 2
TABLE_BYTES = 1 << 29      # bytes of the gather and term tables of one chunk


@dataclass
class Job:
    lX: int
    lY: int
    xmyL: np.ndarray       # (lX + lY + 1,)
    xmyR: np.ndarray
    start: np.ndarray      # (S,)
    end: np.ndarray        # (S,)
    off_x: int = 0         # added to x - 1 and y - 1 when pairs are reported
    off_y: int = 0
    trans: np.ndarray | None = None   # (n_edges,) log transitions, else the machine's
    group: int = 0         # tallies and likelihoods are summed per group


@dataclass(frozen=True)
class Machine:
    n_states: int
    match_state: int
    edges: tuple           # ((src, frm, to, eclass, log transition), ...)


def _slots(machine: Machine, key: int) -> np.ndarray:
    """(S, K) edge per slot: the edges into (key 2) or out of (key 1) each
    state, -1 padded."""
    groups = [[i for i, e in enumerate(machine.edges) if e[key] == s]
              for s in range(machine.n_states)]
    out = np.full((machine.n_states, max(map(len, groups))), -1, dtype=np.int64)
    for s, g in enumerate(groups):
        out[s, :len(g)] = g
    return out


class BandedHMM:
    """F, B and log P of ``jobs`` under ``machine``.  ``emissions(job, x_idx,
    y_idx)`` returns the (..., 3) emissions of the cells at sequence indices
    x_idx, y_idx (-1 before the first symbol) of the problems ``job``
    (indices into ``jobs``), all tensors on ``device``, in ``dtype``.  log P
    and the rows of F and B are in the stacked order ``order``."""

    def __init__(self, jobs: list[Job], machine: Machine,
                 emissions: Callable, device, dtype=torch.float64):
        self.machine, self.emissions = machine, emissions
        self.device, self.dtype = device, dtype
        self.order = sorted(range(len(jobs)), key=lambda i: -(jobs[i].lX + jobs[i].lY))
        self.jobs = [jobs[i] for i in self.order]
        self.t_order = torch.as_tensor(self.order, device=device)   # stacked -> given index
        n = len(self.jobs)
        D = np.array([j.lX + j.lY + 1 for j in self.jobs])
        self.D = D
        Dmax = int(D[0])
        xl = np.zeros((n, Dmax), dtype=np.int64)
        wd = np.zeros((n, Dmax), dtype=np.int64)
        for a, j in enumerate(self.jobs):
            xl[a, :D[a]] = j.xmyL
            xl[a, D[a]:] = j.xmyL[-1]
            wd[a, :D[a]] = (j.xmyR - j.xmyL) // 2 + 1
        self.n_act = (D[None, :] > np.arange(Dmax + 2)[:, None]).sum(1)   # (Dmax + 2,)
        S = machine.n_states
        kf = _slots(machine, 2).shape[1]
        kb = _slots(machine, 1).shape[1]
        wmax = int(wd.max())
        per_diag = max(1, n * S * max(kf, kb) * wmax * 16)
        self.C = int(np.clip(TABLE_BYTES // per_diag, 8, 512))
        # lane width of each chunk of diagonals: its widest band
        self.Wc = [int(max(1, wd[:, c:c + self.C].max())) for c in range(0, Dmax, self.C)]
        Wd = np.repeat(self.Wc, self.C)[:Dmax]
        self.Wd = Wd
        sizes = self.n_act[:Dmax] * S * Wd
        self.off = np.concatenate([[0], np.cumsum(sizes)])
        self.size = int(self.off[-1])
        dev = device
        self.t_xl = torch.as_tensor(xl, device=dev)
        self.t_wd = torch.as_tensor(wd, device=dev)
        self.t_D = torch.as_tensor(D, device=dev)
        self.t_off = torch.as_tensor(self.off, device=dev)
        self.t_Wd = torch.as_tensor(np.concatenate([Wd, [1]]), device=dev)
        base = np.array([e[4] for e in machine.edges], dtype=np.float64)
        self.trans = torch.as_tensor(np.stack([base if j.trans is None else j.trans
                                               for j in self.jobs]), dtype=dtype, device=dev)
        self.group = torch.as_tensor([j.group for j in self.jobs], device=dev)
        self.n_groups = max(j.group for j in self.jobs) + 1
        self.start = torch.as_tensor(np.stack([j.start for j in self.jobs]), dtype=dtype,
                                     device=dev)
        self.end = torch.as_tensor(np.stack([j.end for j in self.jobs]), dtype=dtype,
                                   device=dev)
        self.F = self.B = None
        self.logP = None

    # -- geometry ---------------------------------------------------------
    def _cells(self, d0: int, d1: int, A: int, W: int):
        """d (n,1,1), job (1,A,1), lane (1,1,W) and the cell's x, y, validity."""
        dev = self.device
        d = torch.arange(d0, d1, device=dev)[:, None, None]
        a = torch.arange(A, device=dev)[None, :, None]
        k = torch.arange(W, device=dev)[None, None, :]
        xl = self.t_xl[:A, d0:d1].T[:, :, None]
        valid = (k < self.t_wd[:A, d0:d1].T[:, :, None]) & (d < self.t_D[:A][None, :, None])
        xmy = xl + 2 * k
        return d, a, k, (d + xmy) // 2, (d - xmy) // 2, valid

    def _flat(self, row, a, state, col, S):
        """Flat index of (row, job, state, lane) in the F/B buffer, or the
        sentinel (an element that holds -inf) where that cell is off the
        band or its problem has ended."""
        rowc = row.clamp(0, len(self.off) - 2)
        Wr = self.t_Wd[rowc]
        ok = ((row >= 0) & (row < self.t_D[a]) & (col >= 0)
              & (col < self.t_wd[a, rowc.clamp(max=self.t_wd.shape[1] - 1)]))
        idx = self.t_off[rowc] + (a * S + state) * Wr + col
        return torch.where(ok, idx, self.size)

    def _table(self, d0: int, d1: int, backward: bool):
        """Source indices and edge terms (n, A, S, K, W) of diagonals
        d0..d1-1: the edges into each state (forward) or out of it
        (backward)."""
        m, S = self.machine, self.machine.n_states
        A = int(self.n_act[d0])
        W = self.Wc[d0 // self.C]
        slots = torch.as_tensor(_slots(m, 1 if backward else 2), device=self.device)
        K = slots.shape[1]
        e = slots.clamp(min=0)
        src = torch.as_tensor([x[0] for x in m.edges], device=self.device)[e]
        frm = torch.as_tensor([x[1] for x in m.edges], device=self.device)[e]
        to = torch.as_tensor([x[2] for x in m.edges], device=self.device)[e]
        ecl = torch.as_tensor([x[3] for x in m.edges], device=self.device)[e]
        d, a, k, x, y, valid = self._cells(d0, d1, A, W)
        d, a, k, x, y, valid = (t[:, :, None, None, :] for t in (d, a, k, x, y, valid))
        sh = lambda t: t[None, None, :, :, None]   # noqa: E731  (S, K) -> broadcast
        src, frm, to, ecl, pad = sh(src), sh(frm), sh(to), sh(ecl), sh(slots < 0)
        step = torch.where(src == MIDDLE, 2, 1)
        dxs = (src != UPPER).long()                 # x step of the edge
        dys = (src != LOWER).long()
        rows = d + step if backward else d - step
        rowc = rows.clamp(0, len(self.off) - 2)
        xl_row = self.t_xl[a.clamp(max=self.t_xl.shape[0] - 1),
                           rowc.clamp(max=self.t_xl.shape[1] - 1)]
        if backward:
            xs, ys = x + dxs, y + dys               # the to-cell
        else:
            xs, ys = x - dxs, y - dys               # the from-cell
        col = ((xs - ys) - xl_row) // 2
        idx = self._flat(rows, a, to if backward else frm, col, S)
        ex, ey = (xs, ys) if backward else (x, y)   # the cell that emits
        shape = (d1 - d0, A, S, K, W)
        E = self.emissions(self.t_order[a].expand(ex.shape), ex - 1, ey - 1)   # (..., 3)
        term = torch.gather(E.expand(*shape, E.shape[-1]), -1,
                            ecl.expand(shape).unsqueeze(-1)).squeeze(-1)
        term = term + self.trans[:A][:, slots.clamp(min=0)][None, :, :, :, None]
        term = torch.where(valid & ~pad, term, float("-inf"))
        return idx.expand(shape).contiguous(), term.contiguous()

    @staticmethod
    def _fold(val, out):
        K = val.shape[2]
        if K == 1:
            out.copy_(val[:, :, 0])
            return
        cur = val[:, :, 0]
        for i in range(1, K - 1):
            cur = torch.logaddexp(cur, val[:, :, i])
        torch.logaddexp(cur, val[:, :, K - 1], out=out)

    def _chunks(self, lo: int):
        """(d0, d1) of the storage chunks of diagonals lo..Dmax-1."""
        Dmax = int(self.D[0])
        return [(max(c, lo), min(c + self.C, Dmax)) for c in range(0, Dmax, self.C)
                if min(c + self.C, Dmax) > max(c, lo)]

    def _view(self, buf, d):
        S = self.machine.n_states
        lo = int(self.off[d])
        return buf[lo:lo + int(self.n_act[d]) * S * int(self.Wd[d])].view(
            int(self.n_act[d]), S, int(self.Wd[d]))

    def _lane_of_end(self, a):
        j = self.jobs[a]
        return (j.lX - j.lY - int(j.xmyL[-1])) // 2

    # -- recursions -------------------------------------------------------
    def forward(self):
        S = self.machine.n_states
        buf = torch.full((self.size + 1,), float("-inf"), dtype=self.dtype, device=self.device)
        F0 = self._view(buf, 0)
        F0[:, :, 0] = self.start
        for c0, c1 in self._chunks(1):
            idx, term = self._table(c0, c1, backward=False)
            A = idx.shape[1]
            flat_idx = idx.view(c1 - c0, -1)
            flat_term = term.view(c1 - c0, -1)
            for i in range(c1 - c0):
                d = c0 + i
                na = int(self.n_act[d])
                val = buf.index_select(0, flat_idx[i]).add_(flat_term[i]).view(
                    A, S, -1, idx.shape[-1])
                self._fold(val[:na], self._view(buf, d))
        self.F = buf
        ends = []
        for a in range(len(self.jobs)):
            Fl = self._view(buf, int(self.D[a]) - 1)[a, :, self._lane_of_end(a)]
            ends.append(torch.logsumexp(Fl + self.end[a], dim=0))
        self.logP = torch.stack(ends)
        return self.logP

    def backward(self):
        S = self.machine.n_states
        buf = torch.full((self.size + 1,), float("-inf"), dtype=self.dtype, device=self.device)
        for c0, c1 in self._chunks(0)[::-1]:
            idx, term = self._table(c0, c1, backward=True)
            A = idx.shape[1]
            flat_idx = idx.view(c1 - c0, -1)
            flat_term = term.view(c1 - c0, -1)
            for i in range(c1 - c0 - 1, -1, -1):
                d = c0 + i
                na = int(self.n_act[d])
                out = self._view(buf, d)
                val = buf.index_select(0, flat_idx[i]).add_(flat_term[i]).view(
                    A, S, -1, idx.shape[-1])
                self._fold(val[:na], out)
                for a in range(int(self.n_act[d + 1]), na):     # problems ending here
                    out[a] = float("-inf")
                    out[a, :, self._lane_of_end(a)] = self.end[a]
        self.B = buf
        return buf

    # -- what the posteriors give ----------------------------------------
    def edge_tallies(self, cell_key: Callable | None = None, key_states=(), n_keys: int = 0):
        """Expected uses of each edge summed over the problems of each group,
        (G, n_edges); with ``cell_key(job, x_idx)`` also the expected entries
        into the states ``key_states`` summed by the key of the cell entered,
        (G, n_keys).  Summed in float64 whatever the precision of F and B."""
        m, S = self.machine, self.machine.n_states
        slots = torch.as_tensor(_slots(m, 2), device=self.device)
        G = self.n_groups
        tallies = torch.zeros(G * len(m.edges), dtype=torch.float64, device=self.device)
        keyed = torch.zeros(G * max(n_keys, 1), dtype=torch.float64, device=self.device)
        for c0, c1 in self._chunks(1):
            idx, term = self._table(c0, c1, backward=False)
            n, A, _S, K, W = idx.shape
            d, a, k, x, y, valid = self._cells(c0, c1, A, W)
            bidx = self._flat(d[:, :, None, :], a[:, :, None, :],
                              torch.arange(S, device=self.device)[None, None, :, None],
                              k[:, :, None, :], S)                   # (n, A, S, W)
            lp = (self.F[idx] + term + self.B[bidx][:, :, :, None, :]
                  - self.logP[:A][None, :, None, None, None])
            p = torch.exp(lp.double())                               # (n, A, S, K, W)
            ps = p.sum(dim=(0, 4))                                   # (A, S, K)
            grp = self.group[:A, None, None].expand(ps.shape)
            edge = slots[None].expand(ps.shape)
            ok = edge >= 0
            tallies.index_add_(0, (grp * len(m.edges) + edge.clamp(min=0))[ok], ps[ok])
            if cell_key is not None:
                into = p[:, :, list(key_states)].sum(dim=(2, 3))     # (n, A, W)
                key = cell_key(self.t_order[a].expand(x.shape), x - 1)
                ok = valid & (key >= 0) & (key < n_keys)
                flat = self.group[:A][None, :, None] * n_keys + key.clamp(0, n_keys - 1)
                keyed.index_add_(0, flat[ok], into[ok])
        return tallies.view(G, -1), keyed.view(G, -1)

    def likelihoods(self) -> torch.Tensor:
        """(G,) the per-diagonal likelihood the C code accumulates, per group:
        the total of every anti-diagonal d >= 1, which is log P on each."""
        D = torch.as_tensor(self.D - 1, dtype=torch.float64, device=self.device)
        out = torch.zeros(self.n_groups, dtype=torch.float64, device=self.device)
        return out.index_add_(0, self.group, self.logP.double() * D)

    def match_pairs(self, threshold: float):
        """Per problem, in the order given: (x, y, p) arrays of the cells whose
        match posterior is at least ``threshold``, x and y the sequence
        indices plus the job's offsets, p in [0, 1] (float64)."""
        M = self.machine.match_state
        out = [[] for _ in self.jobs]
        for c0, c1 in self._chunks(1):
            A = int(self.n_act[c0])
            W = self.Wc[c0 // self.C]
            d, a, k, x, y, valid = self._cells(c0, c1, A, W)
            S = self.machine.n_states
            fi = self._flat(d, a, torch.full_like(k, M), k, S)
            lp = self.F[fi] + self.B[fi] - self.logP[:A][None, :, None]
            p = torch.exp(lp.double()).clamp(max=1.0)
            keep = valid & (x > 0) & (y > 0) & (p >= threshold)
            nz = torch.nonzero(keep)
            if len(nz) == 0:
                continue
            av = nz[:, 1]
            xs = x.expand(keep.shape)[keep]
            ys = y.expand(keep.shape)[keep]
            pv = p[keep]
            arr = torch.stack([av.double(), xs.double(), ys.double(), pv], 1).cpu().numpy()
            for a_ in np.unique(arr[:, 0]).astype(int):
                sel = arr[arr[:, 0] == a_]
                out[a_].append(sel[:, 1:])
        res = [None] * len(self.jobs)
        for a_, parts in enumerate(out):
            j = self.jobs[a_]
            arr = np.concatenate(parts) if parts else np.zeros((0, 3))
            arr = arr[np.lexsort((arr[:, 1], arr[:, 0]))]
            res[self.order[a_]] = (arr[:, 0].astype(np.int64) - 1 + j.off_x,
                                   arr[:, 1].astype(np.int64) - 1 + j.off_y, arr[:, 2])
        return res
