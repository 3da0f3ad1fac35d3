"""Device-packed threeState alignment lane: the CLIs' fast route (port of
engine/readpath.py:58-899, threeState lane), and the symbol lane beside it.

Per problem the host ships only the irreducible inputs and reads back only
the threshold-passing pairs:

  up:   per bucket, padded arrays: k-mer ranks (or symbol codes), reversed
        event rows, the window rows of pipeline.pad_window and the
        per-problem scale, transition, start and end rows;
  down: one globally-compacted (quantized prob, flat cell index) buffer per
        bucket, all buckets concatenated on the device and fetched with one
        device-to-host copy per collection (pipeline.to_host).

On the device (plain torch ops around the three kernels of ops/fb_kernels):
the per-read model scaling and Gauss pack (``_pack_xarr``, kept in f32 so
the emissions round like the JAX fast lane's), the per-diagonal rows
(pipeline.band_scalars) and the pair extraction (``extract_global``).
Torch queues CUDA work asynchronously, so every bucket is dispatched before
the one synchronising copy in ``collect_fast_jobs``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..constants import KMER_SENTINEL, NUM_OF_KMERS, PAIR_ALIGNMENT_PROB_1
from ..core.window import WindowBand
from ..models.state_machines import (LOG_TENTH, _GAPX_CLASS, _GAPY_CLASS,
                                     _MATCH_CLASS)

from ..ops import fb_kernels as fk
from ..utils.observability import timed
from . import pipeline as pp
from .align import AlignedPairs
from .plan import _build_plan

NEG_INF = fk.NEG_INF
_DQ = 256        # Dp quantization ladder step (bounds the number of buckets)
_NBASE = 4       # base-model slots per bucket (stacked table upload)
_EXTRACT_L = 16  # per-diagonal slot cap of the two-stage compaction
FAST_DIAGONALS = 512 * 1024   # fast-lane padded diagonals per bucket
BUCKET_CELLS = 3 << 27     # symbol-lane window cells per bucket (the E-step's
                           # E 4.8 GB, F and P 8.1 GB each, the backward's
                           # workspace 9.8 GB: b and the window-group sums)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _dp_ladder(d: int) -> int:
    """Quantized Dp: 256-multiples up to 1024, powers of two to 16384, then
    8192-multiples.  In the fast lane the rung keys the buckets; in the
    symbol lane it sets only a launch's Dp (``symbol_buckets``)."""
    if d <= 1024:
        return round_up(max(d, _DQ), _DQ)
    if d <= 16384:
        p = 2048
        while p < d:
            p *= 2
        return p
    return round_up(d, 8192)


# ---------------------------------------------------------------------------
# Model tables (uploaded once per bucket group)
# ---------------------------------------------------------------------------

def _table_stack(bases: list, device: torch.device):
    """(match, y) f32 stacks (_NBASE, NUM_OF_KMERS + 2, 5) for up to
    _NBASE base PoreModels (padded by repeating the first)."""
    pads = list(bases) + [bases[0]] * (_NBASE - len(bases))
    mt = np.stack([np.asarray(b.match_model, np.float32) for b in pads])
    yt = np.stack([np.asarray(b.y_model, np.float32) for b in pads])
    return pp.to_device(mt, device), pp.to_device(yt, device)


def _gapx_table(kmer_gap_probs, device: torch.device) -> torch.Tensor:
    """Per-kmer gapX log-prob table (NUM_OF_KMERS + 2,); sentinel rows
    NEG_INF (emissions_kmer_getGapProb sentinel -> LOG_ZERO)."""
    tab = np.full(NUM_OF_KMERS + 2, LOG_TENTH, dtype=np.float32)
    if kmer_gap_probs is not None:
        tab[:NUM_OF_KMERS] = np.maximum(kmer_gap_probs, NEG_INF)
    tab[NUM_OF_KMERS:] = NEG_INF
    return pp.to_device(tab, device)


# ---------------------------------------------------------------------------
# On-device packing
# ---------------------------------------------------------------------------

def _pack_xarr(mt, yt, gapx, bidx, xrank, scale8):
    """Per-x parameter pack (B, 13, lXp) f32 from rank-gathered base-table
    rows, with the per-read model scaling (emissions_signal_scaleModel,
    stateMachine.c:631-673) applied on the device in f32 — the same
    arithmetic as the JAX fast lane.  scale8 (B, 8) = (scale, shift, var,
    scale_sd, var_sd, apply_flag, 0, 0); sentinel ranks gather all-zero rows
    -> sd == 0 -> NEG_INF emissions."""
    xr = xrank.long()
    bi = bidx.long()[:, None]
    m = mt[bi, xr]                      # (B, lXp, 5)
    y = yt[bi, xr]
    s = scale8[:, None, :]
    lm = m[..., 0] * s[..., 0] + s[..., 1]
    lsd = m[..., 1] * s[..., 2]
    nm = m[..., 2] * s[..., 3]
    nl = m[..., 4] * s[..., 4]
    nmc = torch.clamp_min(nm, 0.0)
    pos = nl > 0
    nsd = torch.where(pos, torch.sqrt(nmc * (nmc * nmc) / torch.where(pos, nl, 1.0)),
                      0.0)
    ap = s[..., 5] > 0
    lm = torch.where(ap, lm, m[..., 0])
    lsd = torch.where(ap, lsd, m[..., 1])
    nm = torch.where(ap, nm, m[..., 2])
    nsd = torch.where(ap, nsd, m[..., 3])

    def pk3(mu, sd):
        ok = sd != 0.0
        safe = torch.where(ok, sd, 1.0)
        inv = torch.where(ok, 1.0 / safe, 0.0)
        logc = torch.where(ok, -0.91893853320467267 - torch.log(safe), NEG_INF)
        return torch.where(ok, mu, 0.0), inv, logc

    rows = (pk3(lm, lsd) + pk3(nm, nsd)
            + pk3(y[..., 0], y[..., 1]) + pk3(y[..., 2], y[..., 3]))
    gx = torch.clamp_min(gapx[xr], NEG_INF)
    return torch.stack(list(rows) + [gx], dim=1)


def extract_global(p, threshold: float, Kg: int, L: int | None = None):
    """Globally-compacted pair extraction: one (Kg,) slot buffer shared by
    the whole bucket, in (problem, diagonal, lane) order.  Stage 1 keeps at
    most L threshold-passing lanes per diagonal (match posteriors of one
    diagonal sum to <= 1, so more than L = 16 cells above a 1% threshold is
    rare and flags the problem as overflowed); stage 2 compacts the slots.
    Returns (cnt (B,) per-problem pair counts, over (B,) overflow flags,
    outq (Kg,) int32 floor(p * 1e7) in f32, outi (Kg,) flat indices
    problem*Dp*W + d*W + j).  A problem whose slots spill past Kg is
    detected on the host (its cumsum extent crosses Kg)."""
    L = _EXTRACT_L if L is None else L
    B, Dp, W = p.shape
    dev = p.device
    m = p >= np.float32(threshold)
    csl = torch.cumsum(m.to(torch.int32), dim=2)
    cnt_d = csl[:, :, -1]                                       # (B, Dp)
    # lane of the (s+1)-th passing cell of each diagonal -> slot s < L
    lane = torch.arange(W, dtype=torch.int32, device=dev).expand(B, Dp, W)
    slot = torch.where(m & (csl <= L), csl - 1, L).long()
    lane_idx = torch.full((B, Dp, L + 1), W, dtype=torch.int32, device=dev)
    lane_idx.scatter_(2, slot, lane)
    lane_idx = lane_idx[:, :, :L]
    valid2 = (torch.arange(L, device=dev)[None, None, :]
              < torch.clamp_max(cnt_d, L)[:, :, None])
    gflat = (torch.clamp_max(lane_idx, W - 1)
             + torch.arange(Dp, dtype=torch.int32, device=dev)[None, :, None] * W
             + (torch.arange(B, dtype=torch.int32, device=dev) * (Dp * W))[:, None, None])
    v = valid2.reshape(-1)
    f = gflat.reshape(-1)
    idx = torch.cumsum(v.to(torch.int32), dim=0) - 1
    tgt = torch.where(v, torch.clamp_max(idx, Kg), Kg).long()
    outi = torch.zeros(Kg + 1, dtype=torch.int32, device=dev)
    outi.scatter_(0, tgt, f)          # slot Kg collects the discarded cells
    outi = outi[:Kg]
    outq = torch.floor(p.reshape(-1)[outi.long()]
                       * np.float32(PAIR_ALIGNMENT_PROB_1)).to(torch.int32)
    cnt = torch.clamp_max(cnt_d, L).sum(dim=1).to(torch.int32)
    over = (cnt_d > L).any(dim=1).to(torch.int32)
    return cnt, over, outq, outi


class FastBucket(NamedTuple):
    """A fast-lane bucket's staged arrays: numpy on the host, then tensors
    on the device."""

    xrank: object      # (B, lXp) int32 k-mer rank per x column, [W, W + lX + 1)
                       # the job's, KMER_SENTINEL elsewhere
    evr: object        # (B, 2, lYp) f32 reversed event rows at [W, W + lY), 0 elsewhere
    win: object        # (B, 3, Dp) int32 window rows (pipeline.pad_window)
    lY: object         # (B,) int32
    d_last: object     # (B,) int32
    bidx: object       # (B,) int32 slot of the job's base model in the tables
    scale8: object     # (B, 8) f32 (see _pack_xarr)
    tp_scalar: object  # (B, n) f32
    start: object      # (B, S) f32
    end: object        # (B, S) f32


def _run_bucket(plan, W: int, Kg: int, threshold: float, mt, yt, gapx, b: FastBucket):
    """One bucket on its device: the parameter pack and the per-diagonal
    rows, the three kernels (stage 3), the pair extraction -> one int32
    block [cnt | over | outq | outi]."""
    xarr = _pack_xarr(mt, yt, gapx, b.bidx, b.xrank, b.scale8)
    ds, x0, yr0 = pp.band_scalars(b.win, b.lY, W, b.xrank.shape[1], b.evr.shape[2])
    prob = pp.SM3Problem(
        xarr=xarr.contiguous(), evr=b.evr, x0=x0, yr0=yr0, diag_scalars=ds,
        d_last=b.d_last, start=b.start, end=b.end, tp_scalar=b.tp_scalar,
        xrank=b.xrank)
    p, _totals = pp.run_sm3(plan, W, prob)
    return torch.cat(extract_global(p, threshold, Kg))


# ---------------------------------------------------------------------------
# Host staging
# ---------------------------------------------------------------------------

@dataclass
class _FastJob:
    """Staged inputs of one packable (threeState) split job."""

    base: object             # PoreModel whose tables to use
    scale8: np.ndarray       # (8,) f32
    gapx_key: object         # kmer_gap_probs identity (for grouping)
    gapx: object             # the array itself (or None)
    ranks: np.ndarray        # (lX + 1,) int32 incl. x = -1 sentinel slot
    events: np.ndarray       # (lY, >= 2) f64
    wband: WindowBand
    tp_scalar: np.ndarray    # (n,) f32
    start: np.ndarray        # (S,) f32
    end: np.ndarray          # (S,) f32
    off_x: int
    off_y: int


def stage_fast_job(job, wband: WindowBand):
    """SplitJob -> (_FastJob, plan), or None when the machine has no sm3
    pack."""
    pack = getattr(job.sm, "sm3_pack", None)
    if pack is None:
        return None
    pore, _target, events, _transitions, kmer_gap_probs = pack
    plan, tp_scalar, cell_sources = _build_plan(job.sm, "exact")
    assert not cell_sources
    prov = getattr(pore, "scale_provenance", None)
    if prov is not None:
        base, (sc, sh, va, ssd, vsd) = prov
        scale8 = np.array([sc, sh, va, ssd, vsd, 1.0, 0.0, 0.0], dtype=np.float32)
    else:
        base = pore
        scale8 = np.array([1, 0, 1, 1, 1, 0, 0, 0], dtype=np.float32)
    sm = job.sm
    return _FastJob(
        base=base, scale8=scale8,
        gapx_key=id(kmer_gap_probs) if kmer_gap_probs is not None else 0,
        gapx=kmer_gap_probs,
        ranks=np.asarray(sm.kmer_ranks, dtype=np.int32),
        events=np.asarray(events),
        wband=wband,
        tp_scalar=pp.finite_f32(tp_scalar),
        start=pp.finite_f32(sm.ragged_start if job.ragged_left else sm.start),
        end=pp.finite_f32(sm.ragged_end if job.ragged_right else sm.end),
        off_x=job.off_x, off_y=job.off_y), plan


def _decode_global(packed, chunk, staged, W, Dp, Kg, out):
    """Pair decode from a bucket's block [cnt (B,) | over (B,) | outq (Kg,) |
    outi (Kg,)]: per-problem extents from the count cumsum; a diagonal-slot
    overflow or an extent crossing Kg maps that job to None (full-grid
    re-route)."""
    nB = (len(packed) - 2 * Kg) // 2
    cnt = packed[:nB]
    over = packed[nB:2 * nB]
    outq = packed[2 * nB:2 * nB + Kg]
    outi = packed[2 * nB + Kg:]
    ends = np.cumsum(cnt)
    starts = ends - cnt
    for bi, si in enumerate(chunk):
        ji, job, _plan = staged[si]
        if over[bi] or ends[bi] > Kg:
            out[ji] = None
            continue
        gi = outi[starts[bi]:ends[bi]].astype(np.int64) - bi * (Dp * W)
        d = gi // W
        j = gi - d * W
        w0 = np.asarray(job.wband.w0, dtype=np.int64)
        w0d = w0[np.minimum(d, len(w0) - 1)]
        xmy = w0d + 2 * j
        x = (d + xmy) >> 1
        y = (d - xmy) >> 1
        out[ji] = AlignedPairs(outq[starts[bi]:ends[bi]].astype(np.int64),
                               x - 1 + job.off_x, y - 1 + job.off_y)


def _stage_rows(jobs, Dp: int):
    """The rows every lane stages per job: window rows (B, 3, Dp), d_last
    (B,), tp_scalar (B, n), start and end (B, S)."""
    return (np.stack([pp.pad_window(j.wband, Dp) for j in jobs]),
            np.array([j.wband.n_diagonals - 1 for j in jobs], dtype=np.int32),
            np.stack([j.tp_scalar for j in jobs]), np.stack([j.start for j in jobs]),
            np.stack([j.end for j in jobs]))


def _stage_fast_bucket(jobs: list[_FastJob], slots: list[int], W: int, Dp: int,
                       lXp: int, lYp: int) -> FastBucket:
    """Host staging of one fast-lane bucket (numpy); ``slots`` are the jobs'
    base-table slots."""
    B = len(jobs)
    xrank = np.full((B, lXp), KMER_SENTINEL, dtype=np.int32)
    evr = np.zeros((B, 2, lYp), dtype=np.float32)
    for b, fj in enumerate(jobs):
        xrank[b, W:W + len(fj.ranks)] = fj.ranks
        evr[b, :, W:W + len(fj.events)] = fj.events[::-1, :2].T
    win, d_last, tp_scalar, start, end = _stage_rows(jobs, Dp)
    return FastBucket(xrank, evr, win, np.array([len(fj.events) for fj in jobs], np.int32),
                      d_last, np.array(slots, dtype=np.int32),
                      np.stack([fj.scale8 for fj in jobs]), tp_scalar, start, end)


def dispatch_fast_jobs(staged: list[tuple[int, _FastJob, object]],
                       threshold: float, *, device: torch.device) -> list:
    """Bucket, stage and dispatch all staged jobs (asynchronously on CUDA);
    returns the pending list for collect_fast_jobs.  Buckets key on (plan,
    W, Dp rung, gapX table, base-model set): the base models, in order of
    first use, form sets of _NBASE that share a bucket's stacked tables;
    a bucket holds at most FAST_DIAGONALS padded diagonals."""
    bases: list = []
    slot: dict[int, int] = {}
    keys, sizes = [], []
    for _ji, fj, plan in staged:
        if id(fj.base) not in slot:
            slot[id(fj.base)] = len(bases)
            bases.append(fj.base)
        Dp = _dp_ladder(fj.wband.n_diagonals + 2)
        keys.append((plan, fj.wband.W, Dp, fj.gapx_key, slot[id(fj.base)] // _NBASE))
        sizes.append(Dp)
    tables: dict[int, tuple] = {}
    gapx_tables: dict[object, torch.Tensor] = {}
    pending = []   # (staged, chunk, handle, W, Dp, Kg)
    for (plan, W, Dp, gapx_key, base_set), chunk in pp.launch_groups(keys, sizes,
                                                                      FAST_DIAGONALS):
        jobs = [staged[si][1] for si in chunk]
        if base_set not in tables:
            tables[base_set] = _table_stack(bases[base_set * _NBASE:(base_set + 1) * _NBASE],
                                            device)
        if gapx_key not in gapx_tables:
            gapx_tables[gapx_key] = _gapx_table(jobs[0].gapx, device)
        lXp = round_up(Dp + 1 + 2 * W + 2 * 128, 128)
        host = _stage_fast_bucket(jobs, [slot[id(fj.base)] % _NBASE for fj in jobs],
                                  W, Dp, lXp, lXp)
        # pair capacity ~1 per event observed; 1.2x + slack, with the
        # full-grid re-route catching the (rare) spill
        n_ev = sum(len(fj.events) for fj in jobs)
        Kg = round_up(n_ev + n_ev // 5 + 512, 2048)
        handle = _run_bucket(plan, W, Kg, float(threshold), *tables[base_set],
                             gapx_tables[gapx_key],
                             FastBucket(*(pp.to_device(a, device) for a in host)))
        pending.append((staged, chunk, handle, W, Dp, Kg))
    return pending


def collect_fast_jobs(pending: list, *, timing: dict | None = None) -> dict[int, object]:
    """Single-copy collection + host decode of any number of dispatched
    waves (their pending lists concatenated)."""
    with timed("device_wait", timing):
        packed_of = pp.to_host([p[2] for p in pending])
    out: dict[int, object] = {}
    with timed("host_extract", timing):
        for (staged, chunk, _handle, W, Dp, Kg), packed in zip(pending, packed_of):
            _decode_global(packed, chunk, staged, W, Dp, Kg, out)
    return out


# ---------------------------------------------------------------------------
# Symbol-machine (fiveState nucleotide) lane (engine/readpath.py:905-1127)
# ---------------------------------------------------------------------------
# The realign and nucleotide-EM machines emit from tiny symbol tables (5x5
# match, 5 gap rows, stateMachine.c:60-194), so E is a gather of the per-cell
# symbol-code pair, built on the device from two small code arrays instead of
# a host-packed (Dp, 3, W) grid.  The upload is the padded codes, the window
# rows and the per-problem rows; alignment reads back the compacted pairs.

@dataclass
class _SymJob:
    """Staged inputs of one symbol-machine split job."""

    tab_key: bytes           # the tables' bytes (buckets share one table set)
    match_t: np.ndarray      # (5, 5) f32
    gapx_t: np.ndarray       # (5,) f32
    gapy_t: np.ndarray       # (5,) f32
    cx: np.ndarray           # (lX + 1,) int32 codes incl. the x = -1 sentinel
    cy: np.ndarray           # (lY + 1,) int32
    wband: WindowBand
    tp_scalar: np.ndarray
    start: np.ndarray
    end: np.ndarray
    off_x: int
    off_y: int


def stage_symbol_job(job, wband: WindowBand):
    """SplitJob with a bound symbol machine -> (_SymJob, plan), else None."""
    sm = job.sm
    codes = getattr(sm, "symbol_codes", None)
    tables = getattr(sm, "symbol_tables", None)
    if codes is None or tables is None:
        return None
    plan, tp_scalar, cell_sources = _build_plan(sm, "exact")
    if cell_sources:
        return None
    mt, gx, gy = (pp.finite_f32(t) for t in tables)
    cx, cy = codes
    return _SymJob(
        tab_key=mt.tobytes() + gx.tobytes() + gy.tobytes(), match_t=mt, gapx_t=gx,
        gapy_t=gy, cx=np.asarray(cx, dtype=np.int32), cy=np.asarray(cy, dtype=np.int32),
        wband=wband, tp_scalar=pp.finite_f32(tp_scalar),
        start=pp.finite_f32(sm.ragged_start if job.ragged_left else sm.start),
        end=pp.finite_f32(sm.ragged_end if job.ragged_right else sm.end),
        off_x=job.off_x, off_y=job.off_y), plan


def cell_codes(cxp, cyp, w0, W: int):
    """The symbol codes (B, Dp, W) int32 of every window cell's x and y:
    cell (d, j) of problem b lies at x = (d + xmy) / 2, y = (d - xmy) / 2
    with xmy = w0[b, d] + 2j, both clipped to the code arrays cxp / cyp (B,
    Lc), whose slot 0 is position -1 (code 4 = N)."""
    B, Dp = w0.shape
    dev = w0.device
    Lc = cxp.shape[1]
    d = torch.arange(Dp, dtype=torch.int32, device=dev)[None, :, None]
    xmy = w0[:, :, None] + 2 * torch.arange(W, dtype=torch.int32, device=dev)
    rows = (torch.arange(B, device=dev) * Lc)[:, None, None]
    return (cxp.reshape(-1)[rows + ((d + xmy) // 2).clamp(0, Lc - 1)],
            cyp.reshape(-1)[rows + ((d - xmy) // 2).clamp(0, Lc - 1)])


def symbol_emissions(mt, gx, gy, cxp, cyp, w0, d_last, W: int) -> torch.Tensor:
    """Symbol emission grid E (B, Dp+2, 3, W) of a bucket, on its device
    (engine/readpath.py:996-1012): the cell's codes (``cell_codes``) pick
    channel 0 = gapX gx[cx], 1 = match mt[cx, cy], 2 = gapY gy[cy] (the
    machine's class order).  Rows d > d_last and the two rows past Dp are
    zero."""
    B, Dp = w0.shape
    ix, iy = (c.long() for c in cell_codes(cxp, cyp, w0, W))
    live = torch.arange(Dp, device=w0.device)[None, :, None] <= d_last[:, None, None]
    E = torch.zeros((B, Dp + 2, 3, W), dtype=torch.float32, device=w0.device)
    E[:, :Dp, 0] = torch.where(live, gx[ix], 0.0)
    E[:, :Dp, 1] = torch.where(live, mt.reshape(-1)[ix * mt.shape[1] + iy], 0.0)
    E[:, :Dp, 2] = torch.where(live, gy[iy], 0.0)
    return E


def hdp_emissions(tab, g0: float, dg: float, rank, meanp, w0, d_last, W: int
                  ) -> torch.Tensor:
    """threeStateHdp emission grid E (B, Dp+2, 3, W) of a bucket, on its
    device: the HDP density of each cell's k-mer at its event mean, the grid
    interpolation of dir_proc_density (hdp.c:2577-2601) that both JAX
    builders do in jnp (engine/batch_align.py:180-211,
    em/pallas_em.py:514-545).  A cell (d, j) lies at x = (d + xmy) / 2, y =
    (d - xmy) / 2 with xmy = w0[b, d] + 2j; ``rank`` (B, Lc) and ``meanp``
    (B, Lc) are indexed by x and y clipped to [0, Lc - 1] and pick the row
    of ``tab`` (R, ng) f32 and the event mean.  The density, linear on the
    grid g0 + i dg and clamped at >= 0, fills the match and gapY channels
    (the raw density, the reference's quirk: models/state_machines
    .make_signal_sm3_hdp), gapX gets log 0.1; rows d > d_last and the two
    rows past Dp are zero.  The f32 operations are the JAX ones, in its
    order."""
    B, Dp = w0.shape
    dev = w0.device
    Lc = rank.shape[1]
    ng = tab.shape[1]
    d = torch.arange(Dp, dtype=torch.int32, device=dev)[None, :, None]
    xmy = w0[:, :, None] + 2 * torch.arange(W, dtype=torch.int32, device=dev)
    rows = (torch.arange(B, device=dev) * Lc)[:, None, None]
    r = rank.reshape(-1)[rows + ((d + xmy) // 2).clamp(0, Lc - 1)].long()
    mu = meanp.reshape(-1)[rows + ((d - xmy) // 2).clamp(0, Lc - 1)]
    del xmy
    # g0 and dg as f32 tensors on the device: a CUDA division by a host
    # scalar multiplies by its reciprocal, which rounds otherwise
    g0, dg = (torch.tensor(np.float32(v), device=dev) for v in (g0, dg))
    pos = torch.clamp((mu - g0) / dg, 0.0, ng - 1 - 1e-6)
    del mu
    i0 = pos.to(torch.int32)
    t = pos - i0
    flat = tab.reshape(-1)
    r = r * ng
    v = ((1.0 - t) * flat[r + i0] + t * flat[r + torch.clamp_max(i0 + 1, ng - 1)])
    del r, i0, t, pos
    dens = torch.clamp_min(v, 0.0)
    live = d <= d_last[:, None, None]
    E = torch.zeros((B, Dp + 2, 3, W), dtype=torch.float32, device=dev)
    E[:, :Dp, _GAPX_CLASS] = torch.where(live, LOG_TENTH, 0.0)
    E[:, :Dp, _MATCH_CLASS] = torch.where(live, dens, 0.0)
    E[:, :Dp, _GAPY_CLASS] = E[:, :Dp, _MATCH_CLASS]
    return E


def extract_compact(p: torch.Tensor, threshold: float, K: int, L: int | None = None):
    """Per-problem compaction of threshold-passing cells (the JAX
    ``_extract_compact``, engine/readpath.py:350-390): p (B, Dp, W) ->
    (count (B,) int32, flat cell indices d * W + j (B, K) int32) in
    row-major (d, j) order.  Stage 1 keeps at most L (default 16) passing
    lanes of each diagonal, stage 2 compacts the slots.  A problem with a
    diagonal of more than L passing lanes gets count K + 1; one with more
    than K passing cells gets its true count: either way count > K means
    that its list is incomplete.  L = W never drops a lane."""
    L = _EXTRACT_L if L is None else L
    B, Dp, W = p.shape
    dev = p.device
    m = p >= np.float32(threshold)
    csl = torch.cumsum(m.to(torch.int32), dim=2)
    cnt_d = csl[:, :, -1]
    lane = torch.arange(W, dtype=torch.int32, device=dev).expand(B, Dp, W)
    slot = torch.where(m & (csl <= L), csl - 1, L).long()
    del m, csl
    lane_idx = torch.full((B, Dp, L + 1), W, dtype=torch.int32, device=dev)
    lane_idx.scatter_(2, slot, lane)
    del slot
    valid2 = (torch.arange(L, device=dev)[None, None, :]
              < torch.clamp_max(cnt_d, L)[:, :, None]).reshape(B, Dp * L)
    f2 = (torch.clamp_max(lane_idx[:, :, :L], W - 1)
          + torch.arange(Dp, dtype=torch.int32, device=dev)[None, :, None] * W
          ).reshape(B, Dp * L)
    idx = torch.cumsum(valid2.to(torch.int32), dim=1) - 1
    total = idx[:, -1] + 1
    tgt = torch.where(valid2, torch.clamp_max(idx, K), K).long()
    outi = torch.zeros((B, K + 1), dtype=torch.int32, device=dev)
    outi.scatter_(1, tgt, f2)          # slot K collects the discarded cells
    cnt = torch.where((cnt_d > L).any(dim=1), K + 1, total).to(torch.int32)
    return cnt, outi[:, :K]


def symbol_buckets(staged) -> list[tuple]:
    """Launches of staged symbol jobs, for realignment and the nucleotide
    E-step alike: one key (plan, W, table set) each, its jobs longest first
    (window diagonals, descending; ties in job order), cut into launches of
    at most MAX_BUCKET jobs and BUCKET_CELLS window cells
    (pipeline.launch_groups), each padded to the Dp rung of its longest
    job.  Jobs of every length share a launch, so a launch's chain is its
    longest job's and no more launches run one after another than the cap
    forces.  Returns [(plan, W, Dp, staged indices)]."""
    order = sorted(range(len(staged)), key=lambda i: -staged[i][1].wband.n_diagonals)
    keys, sizes = [], []
    for i in order:
        _ji, sj, plan = staged[i]
        keys.append((plan, sj.wband.W, sj.tab_key))
        sizes.append(_dp_ladder(sj.wband.n_diagonals + 2) * sj.wband.W)
    out = []
    for (plan, W, _tk), chunk in pp.launch_groups(keys, sizes, BUCKET_CELLS):
        idxs = [order[c] for c in chunk]
        out.append((plan, W, _dp_ladder(staged[idxs[0]][1].wband.n_diagonals + 2), idxs))
    return out


class SymbolBucket(NamedTuple):
    """A symbol-lane bucket's staged arrays on its device."""

    cx: torch.Tensor         # (B, Dp + 2) int32 x codes (slot 0: x = -1), 4 (N) past the end
    cy: torch.Tensor         # (B, Dp + 2) int32 y codes
    win: torch.Tensor        # (B, 3, Dp) int32 window rows (pipeline.pad_window)
    d_last: torch.Tensor     # (B,) int32
    tp_scalar: torch.Tensor  # (B, n) f32
    start: torch.Tensor      # (B, S) f32
    end: torch.Tensor        # (B, S) f32


def stage_symbol_bucket(staged, idxs, Dp: int, device: torch.device):
    """Host staging of one bucket of symbol jobs (``idxs`` into ``staged``)
    padded to Dp diagonals, uploaded to ``device``.  Returns (the tables
    (match, gapX, gapY), the SymbolBucket, the count of the jobs' y
    codes)."""
    jobs = [staged[si][1] for si in idxs]
    codes = np.full((2, len(jobs), Dp + 2), 4, dtype=np.int32)
    for b, sj in enumerate(jobs):
        codes[0, b, :len(sj.cx)] = sj.cx
        codes[1, b, :len(sj.cy)] = sj.cy
    tables = tuple(pp.to_device(t, device) for t in (jobs[0].match_t, jobs[0].gapx_t,
                                                     jobs[0].gapy_t))
    bucket = SymbolBucket(*(pp.to_device(a, device)
                            for a in (codes[0], codes[1], *_stage_rows(jobs, Dp))))
    return tables, bucket, sum(len(sj.cy) for sj in jobs)


def symbol_problem(W: int, tables, b: SymbolBucket) -> pp.WindowProblem:
    """The window problem the kernels take of a staged symbol bucket, built
    on its device: E from ``symbol_emissions``, the DS_* rows and x0 from
    its window rows."""
    ds, x0 = pp.window_band_scalars(b.win, W)
    E = symbol_emissions(*tables, b.cx, b.cy, b.win[:, 0], b.d_last, W)
    return pp.WindowProblem(E=E, diag_scalars=ds, d_last=b.d_last, start=b.start,
                            end=b.end, tp_scalar=b.tp_scalar, x0=x0)


def run_symbol_jobs(staged: list[tuple[int, _SymJob, object]], threshold: float,
                    *, device: torch.device, timing: dict | None = None
                    ) -> dict[int, object]:
    """The symbol lane's alignment (run_symbol_jobs, nh = 1): buckets of
    ``symbol_buckets``, each staged, its E gathered, forward and stage-3
    backward, and its pairs compacted on the device; all buckets dispatched,
    then collected with one copy.  Returns {job_index: AlignedPairs}, None
    for a job whose pairs overflowed (the caller's full-grid re-route)."""
    pending = []
    with timed("host_pack", timing):
        for plan, W, Dp, chunk in symbol_buckets(staged):
            tables, bucket, n_cy = stage_symbol_bucket(staged, chunk, Dp, device)
            # nucleotide posteriors spread more mass off the diagonal than the
            # signal lane's: room for 2 pairs a y position, the full-grid
            # re-route catching the rare spill
            Kg = round_up(2 * n_cy + 512, 2048)
            p, _totals = pp.run_window(plan, W, symbol_problem(W, tables, bucket))
            pending.append((staged, chunk, torch.cat(extract_global(p, threshold, Kg)),
                            W, Dp, Kg))
    return collect_fast_jobs(pending, timing=timing)
