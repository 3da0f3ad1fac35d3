"""Device-packed threeState alignment lane: the CLIs' fast route (port of
engine/readpath.py:58-899, threeState lane).

Per problem the host ships only the irreducible inputs and reads back only
the threshold-passing pairs:

  up:   per bucket, flat variable-length buffers: int16 rank codes, an int16
        window stream of one word per diagonal, f32 reversed event rows and
        small per-problem meta blocks;
  down: one globally-compacted (quantized prob, flat cell index) buffer per
        bucket, all buckets concatenated on the device and fetched with one
        device-to-host copy per collection.

On the device (plain torch ops around the three kernels of ops/fb_kernels):
the flat-transport unpack, the per-read model scaling and Gauss pack
(``_pack_xarr``, kept in f32 so the emissions round like the JAX fast
lane's), the per-diagonal DS_* scalars (``_pack_ds``) and the pair
extraction (``_extract_global``).  Torch queues CUDA work asynchronously, so
every bucket is dispatched before the one synchronising copy in
``collect_fast_jobs``.
"""

from __future__ import annotations

from dataclasses import dataclass

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
_ALLOWED_B = (1, 2, 4, 8, 16, 32, 64, 128)
_DQ = 256        # Dp quantization ladder step (bounds the number of buckets)
_NBASE = 4       # base-model slots per bucket (stacked table upload)
_EXTRACT_L = 16  # per-diagonal slot cap of the two-stage compaction
MAX_BUCKET = 64            # symbol-lane problems per bucket
BUCKET_CELLS = 3 << 27     # symbol-lane window cells per bucket (the E-step's
                           # E 4.8 GB, F and P 8.1 GB each, the backward's
                           # workspace 9.8 GB: b and the window-group sums)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _dp_ladder(d: int) -> int:
    """Quantized Dp: 256-multiples up to 1024, powers of two to 16384, then
    8192-multiples; coarse rungs merge jobs into few buckets."""
    if d <= 1024:
        return _round_up(max(d, _DQ), _DQ)
    if d <= 16384:
        p = 2048
        while p < d:
            p *= 2
        return p
    return _round_up(d, 8192)


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


def _pack_ds(win, lY, W: int, lXp: int, lYp: int):
    """Per-diagonal DS_* scalars (B, Dp+1, 1, 8) and emission offsets x0/yr0
    (B, Dp+1) from the (B, 3, Dp) window rows (w0, xmyL, xmyR).  All
    divisions are exact ((d +- w0) is even)."""
    w0, xl, xr = win[:, 0], win[:, 1], win[:, 2]
    B, Dp = w0.shape
    z = torch.zeros((B, 1), dtype=torch.int32, device=w0.device)
    fL = torch.cat([z, (w0[:, 1:] - 1 - w0[:, :-1]) // 2], 1)
    fM = torch.cat([z, z, (w0[:, 2:] - w0[:, :-2]) // 2], 1)
    bL = torch.cat([(w0[:, :-1] + 1 - w0[:, 1:]) // 2, z], 1)
    bM = torch.cat([(w0[:, :-2] - w0[:, 2:]) // 2, z, z], 1)
    d = torch.arange(Dp, dtype=torch.int32, device=w0.device)[None, :]
    x0 = torch.clamp((d + w0) // 2 + W, 0, lXp - W)              # PADX == W
    yr0 = torch.clamp(lY[:, None] - (d - w0) // 2 + W, 0, lYp - W)
    xs = torch.cat([z, x0[:, 1:] - x0[:, :-1]], 1)
    lanes = [None] * 8
    lanes[fk.DS_FL], lanes[fk.DS_FM] = fL, fM
    lanes[fk.DS_BL], lanes[fk.DS_BM] = bL, bM
    lanes[fk.DS_W0], lanes[fk.DS_XMYL], lanes[fk.DS_XMYR] = w0, xl, xr
    lanes[fk.DS_XS] = xs
    ds = torch.stack(lanes, dim=-1)                              # (B, Dp, 8)
    ds = torch.cat([ds, ds[:, -1:]], dim=1)[:, :, None, :].to(torch.int32)
    x0 = torch.cat([x0, z], 1).to(torch.int32)
    yr0 = torch.cat([yr0, z], 1).to(torch.int32)
    return ds.contiguous(), x0.contiguous(), yr0.contiguous()


# ---------------------------------------------------------------------------
# Flat transport
# ---------------------------------------------------------------------------

_META_I = 12      # int32 meta lanes per problem (offsets/lengths/flags)
(MI_RANK_OFF, MI_RANK_LEN, MI_EV_OFF, MI_EV_LEN, MI_WIN_OFF, MI_WIN_D,
 MI_BASE, MI_W00, MI_REAL) = range(9)


def _flat_win_encode(wb: WindowBand) -> np.ndarray:
    """Per-diagonal window stream.  w0 steps are exactly +-1 and the true
    band lies inside the W-lane window, so the halved edge offsets are in
    [0, W-1]: for W <= 128 one int16 word per diagonal
    (step<<14 | uL<<7 | uR); wider windows use three int16 rows
    [w0 delta | uL | uR]."""
    w0 = np.asarray(wb.w0, dtype=np.int64)
    delta = np.diff(w0)
    uL = (np.asarray(wb.xmyL, dtype=np.int64) - w0) >> 1
    uR = (np.asarray(wb.xmyR, dtype=np.int64) - w0) >> 1
    assert len(delta) == 0 or (np.abs(delta) == 1).all()
    assert uL.min(initial=0) >= 0 and uR.max(initial=0) < wb.W
    D = len(w0)
    if wb.W <= 128:
        s = np.empty(D, dtype=np.int64)
        s[0] = 0
        s[1:] = (delta + 1) >> 1             # +-1 -> 1/0
        return ((s << 14) | (uL << 7) | uR).astype(np.int16)
    out = np.empty(3 * D, dtype=np.int16)
    out[0] = 0
    out[1:D] = delta
    out[D:2 * D] = uL
    out[2 * D:] = uR
    return out


def _unpack_win(meta_i, fw, W: int, Dp: int):
    """Decode the window stream into (B, 3, Dp) int32 (w0, xmyL, xmyR); rows
    past D get pad_window's stepping-w0 / empty-range rows."""
    dev = meta_i.device
    dd = torch.arange(Dp, dtype=torch.int32, device=dev)[None, :]
    D = meta_i[:, MI_WIN_D:MI_WIN_D + 1]
    wreal = dd < D
    woff = meta_i[:, MI_WIN_OFF:MI_WIN_OFF + 1]
    didx = torch.minimum(dd, D - 1).clamp_min(0)
    if W <= 128:   # 1-word encoding: step<<14 | uL<<7 | uR
        word = fw[(woff + didx).long()]
        delta = torch.where(wreal & (dd > 0), 2 * (word >> 14) - 1, 0)
        uL = (word >> 7) & 127
        uR = word & 127
    else:          # 3-row encoding
        delta = torch.where(wreal, fw[(woff + didx).long()], 0)
        uL = fw[(woff + D + didx).long()]
        uR = fw[(woff + 2 * D + didx).long()]
    w0 = meta_i[:, MI_W00:MI_W00 + 1] + torch.cumsum(delta, dim=1)
    w0 = w0 + torch.where(wreal, 0, torch.where((dd - D) % 2 == 0, 1, 0))
    xmyL = w0 + torch.where(wreal, 2 * uL, 2 * 10**6)
    xmyR = w0 + torch.where(wreal, 2 * uR, 0)
    return torch.stack([w0, xmyL, xmyR], dim=1).to(torch.int32)


def _unpack_dev(meta_i, meta_f, flat_r, flat_w, flat_e, *, W: int, Dp: int,
                lXp: int, lYp: int, n_tp: int, S: int):
    """Unpack the flat transport into the padded per-problem arrays the
    pipeline consumes."""
    dev = meta_i.device
    fr = flat_r.to(torch.int32)
    fw = flat_w.to(torch.int32)

    # ranks: sentinel-filled (B, lXp) with the job's codes at [W, W + len)
    xa = torch.arange(lXp, dtype=torch.int32, device=dev)[None, :] - W
    rlen = meta_i[:, MI_RANK_LEN:MI_RANK_LEN + 1]
    rok = (xa >= 0) & (xa < rlen)
    ridx = meta_i[:, MI_RANK_OFF:MI_RANK_OFF + 1] + torch.minimum(xa.clamp_min(0),
                                                                  rlen - 1)
    xrank = torch.where(rok, fr[ridx.long()], KMER_SENTINEL)

    # events: zero-filled (B, 2, lYp) with reversed rows at [W, W + n)
    ya = torch.arange(lYp, dtype=torch.int32, device=dev)[None, :] - W
    elen = meta_i[:, MI_EV_LEN:MI_EV_LEN + 1]
    eok = (ya >= 0) & (ya < elen)
    ebase = (meta_i[:, MI_EV_OFF:MI_EV_OFF + 1]
             + torch.minimum(ya.clamp_min(0), elen - 1)).long()
    evm = torch.where(eok, flat_e[ebase], 0.0)
    evn = torch.where(eok, flat_e[ebase + elen.long()], 0.0)
    evr = torch.stack([evm, evn], dim=1)

    win = _unpack_win(meta_i, fw, W, Dp)
    lY = meta_i[:, MI_EV_LEN]
    d_last = meta_i[:, MI_WIN_D] - 1
    bidx = meta_i[:, MI_BASE]
    real = meta_i[:, MI_REAL] > 0
    scale8 = meta_f[:, :8]
    tps = meta_f[:, 8:8 + n_tp].contiguous()
    start = meta_f[:, 8 + n_tp:8 + n_tp + S].contiguous()
    end = meta_f[:, 8 + n_tp + S:8 + n_tp + 2 * S].contiguous()
    return xrank, win, lY, d_last, bidx, evr, scale8, tps, start, end, real


def _extract_global(p, threshold: float, Kg: int, real, L: int | None = None):
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
    m = (p >= np.float32(threshold)) & real[:, None, None]
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


def _run_bucket(plan, W, Dp, lXp, lYp, Kg, n_tp, S, threshold,
                mt, yt, gapx, meta_i, meta_f, flat_r, flat_w, flat_e):
    """One bucket: unpack -> device packing -> the three kernels (stage 3)
    -> pair extraction -> one int32 block [cnt | over | outq | outi]."""
    (xrank, win, lY, d_last, bidx, evr, scale8, tps, start, end,
     real) = _unpack_dev(meta_i, meta_f, flat_r, flat_w, flat_e,
                         W=W, Dp=Dp, lXp=lXp, lYp=lYp, n_tp=n_tp, S=S)
    xarr = _pack_xarr(mt, yt, gapx, bidx, xrank, scale8)
    ds, x0, yr0 = _pack_ds(win, lY, W, lXp, lYp)
    prob = pp.SM3Problem(
        xarr=xarr.contiguous(), evr=evr.contiguous(), x0=x0, yr0=yr0,
        diag_scalars=ds, d_last=d_last.contiguous(), start=start, end=end,
        tp_scalar=tps, xrank=xrank)
    p, _totals = pp.run_sm3(plan, W, prob)
    cnt, over, outq, outi = _extract_global(p, threshold, Kg, real)
    return torch.cat([cnt, over, outq, outi])


# ---------------------------------------------------------------------------
# Host staging
# ---------------------------------------------------------------------------

def pad_window(wb: WindowBand, Dp: int):
    """(3, Dp) int32 (w0, xmyL, xmyR) padded past D with stepping-w0 rows
    whose xmy range is empty."""
    D = wb.n_diagonals
    out = np.empty((3, Dp), dtype=np.int32)
    out[0, :D] = wb.w0
    out[1, :D] = wb.xmyL
    out[2, :D] = wb.xmyR
    if Dp > D:
        i = np.arange(Dp - D)
        w0p = wb.w0[D - 1] + np.where(i % 2 == 0, 1, 0)
        out[0, D:] = w0p
        out[1, D:] = w0p + 2 * 10**6     # empty range: xmyL > xmyR
        out[2, D:] = w0p
    return out


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
        tp_scalar=pp._san(tp_scalar),
        start=pp._san(sm.ragged_start if job.ragged_left else sm.start),
        end=pp._san(sm.ragged_end if job.ragged_right else sm.end),
        off_x=job.off_x, off_y=job.off_y), plan


def _chunk_sizes(n: int, Dp: int = 256) -> list[int]:
    """Greedy decomposition of n into allowed batch sizes; the final chunk is
    padded up to the smallest allowed size that fits.  The chunk cap shrinks
    as Dp grows so a bucket's device footprint stays bounded."""
    big = _ALLOWED_B[-1]
    while big > 1 and big * Dp > 512 * 1024:
        big //= 2
    out = []
    for s in sorted((b for b in _ALLOWED_B if b <= big), reverse=True):
        while n >= s:
            out.append(s)
            n -= s
    if n > 0:
        out.append(next(b for b in _ALLOWED_B if b >= n))
    return out


def _collect_packed(handles: list[torch.Tensor]) -> list[np.ndarray]:
    """ONE device-to-host copy for all pending buckets: the packed outputs
    are concatenated on the device and split on the host."""
    if not handles:
        return []
    combined = torch.cat([h.reshape(-1) for h in handles]).cpu().numpy()
    out = []
    off = 0
    for h in handles:
        out.append(combined[off:off + h.numel()].reshape(h.shape))
        off += h.numel()
    return out


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


def _flat(parts, dtype, quantum=2048) -> np.ndarray:
    n = sum(len(p) for p in parts)
    buf = np.zeros(_round_up(max(n, 1), quantum), dtype=dtype)
    if n:
        np.concatenate(parts, out=buf[:n])
    return buf


def dispatch_fast_jobs(staged: list[tuple[int, _FastJob, object]],
                       threshold: float, *, device: torch.device) -> list:
    """Group, stage and dispatch all staged jobs (asynchronously on CUDA);
    returns the pending list for collect_fast_jobs.  Buckets key on
    (plan, W, Dp rung, gapX table); problems of up to _NBASE base models
    share a bucket through the stacked tables."""
    groups: dict[tuple, list[int]] = {}
    for si, (_ji, fj, plan) in enumerate(staged):
        key = (plan, fj.wband.W, _dp_ladder(fj.wband.n_diagonals + 2), fj.gapx_key)
        groups.setdefault(key, []).append(si)

    pending = []   # (staged, chunk, handle, W, Dp, Kg)
    for (plan, W, Dp, _gk), sidx in groups.items():
        lXp = _round_up(Dp + 1 + 2 * W + 2 * 128, 128)
        lYp = lXp
        subgroups: list[tuple[list, list]] = []   # (bases, staged indices)
        for si in sidx:
            fj = staged[si][1]
            if not subgroups or len(subgroups[-1][0]) >= _NBASE and \
                    id(fj.base) not in {id(b) for b in subgroups[-1][0]}:
                subgroups.append(([], []))
            bases, members = subgroups[-1]
            if id(fj.base) not in {id(b) for b in bases}:
                bases.append(fj.base)
            members.append(si)
        for bases, members in subgroups:
            mt, yt = _table_stack(bases, device)
            base_slot = {id(b): i for i, b in enumerate(bases)}
            gapx = _gapx_table(staged[members[0]][1].gapx, device)
            fj0 = staged[members[0]][1]
            n_tp = len(fj0.tp_scalar)
            S = len(fj0.start)
            pos = 0
            for B in _chunk_sizes(len(members), Dp):
                chunk = members[pos:pos + B]
                pos += len(chunk)
                idxs = chunk + [chunk[-1]] * (B - len(chunk))
                meta_i = np.zeros((B, _META_I), dtype=np.int32)
                meta_f = np.zeros((B, 8 + n_tp + 2 * S), dtype=np.float32)
                ranks_l, win_l, ev_l = [], [], []
                ro = wo = eo = 0
                sum_ev = 0
                for bi, si in enumerate(idxs):
                    fj = staged[si][1]
                    r = fj.ranks
                    ev = fj.events
                    D = fj.wband.n_diagonals
                    real = bi < len(chunk)
                    meta_i[bi, MI_RANK_OFF] = ro
                    meta_i[bi, MI_RANK_LEN] = len(r)
                    meta_i[bi, MI_EV_OFF] = eo
                    meta_i[bi, MI_EV_LEN] = len(ev)
                    meta_i[bi, MI_WIN_OFF] = wo
                    meta_i[bi, MI_WIN_D] = D
                    meta_i[bi, MI_BASE] = base_slot[id(fj.base)]
                    meta_i[bi, MI_W00] = int(fj.wband.w0[0])
                    meta_i[bi, MI_REAL] = 1 if real else 0
                    if real:
                        wenc = _flat_win_encode(fj.wband)
                        ranks_l.append(r.astype(np.int16))
                        win_l.append(wenc)
                        ev_l.append(np.concatenate(
                            [ev[::-1, 0], ev[::-1, 1]]).astype(np.float32))
                        ro += len(r)
                        wo += len(wenc)
                        eo += 2 * len(ev)
                        sum_ev += len(ev)
                    else:
                        # padding rows reuse the previous job's segments
                        wlen = D if W <= 128 else 3 * D
                        meta_i[bi, MI_RANK_OFF] = ro - len(r)
                        meta_i[bi, MI_EV_OFF] = eo - 2 * len(ev)
                        meta_i[bi, MI_WIN_OFF] = wo - wlen
                    meta_f[bi, :8] = fj.scale8
                    meta_f[bi, 8:8 + n_tp] = fj.tp_scalar
                    meta_f[bi, 8 + n_tp:8 + n_tp + S] = fj.start
                    meta_f[bi, 8 + n_tp + S:] = fj.end

                # pair capacity ~1 per event observed; 1.2x + slack, with the
                # full-grid re-route catching the (rare) spill
                Kg = _round_up(sum_ev + sum_ev // 5 + 512, 2048)
                bufs = [pp.to_device(a, device) for a in (
                    meta_i, meta_f, _flat(ranks_l, np.int16),
                    _flat(win_l, np.int16), _flat(ev_l, np.float32))]
                handle = _run_bucket(plan, W, Dp, lXp, lYp, Kg, n_tp, S,
                                     float(threshold), mt, yt, gapx, *bufs)
                pending.append((staged, chunk, handle, W, Dp, Kg))
    return pending


def collect_fast_jobs(pending: list, *, timing: dict | None = None) -> dict[int, object]:
    """Single-copy collection + host decode of any number of dispatched
    waves (their pending lists concatenated)."""
    with timed("device_wait", timing):
        packed_of = _collect_packed([p[2] for p in pending])
    out: dict[int, object] = {}
    with timed("host_extract", timing):
        for (staged, chunk, _handle, W, Dp, Kg), packed in zip(pending, packed_of):
            _decode_global(packed, chunk, staged, W, Dp, Kg, out)
    return out


def run_fast_jobs(staged: list[tuple[int, _FastJob, object]], threshold: float,
                  *, device: torch.device, timing: dict | None = None) -> dict[int, object]:
    """Dispatch all staged jobs (list of (job_index, _FastJob, plan)), then
    collect and decode.  Returns {job_index: AlignedPairs}, with overflowed
    jobs mapped to None for the caller's full-grid re-route."""
    with timed("host_pack", timing):
        pending = dispatch_fast_jobs(staged, threshold, device=device)
    return collect_fast_jobs(pending, timing=timing)


# ---------------------------------------------------------------------------
# Symbol-machine (fiveState nucleotide) lane (engine/readpath.py:905-1127)
# ---------------------------------------------------------------------------
# The realign and nucleotide-EM machines emit from tiny symbol tables (5x5
# match, 5 gap rows, stateMachine.c:60-194), so E is a gather of the per-cell
# symbol-code pair, built on the device from two small code arrays instead of
# a host-packed (Dp, 3, W) grid.  The upload is the int8 codes, the window
# stream and small meta blocks; alignment reads back the compacted pairs.

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
    mt, gx, gy = (pp._san(t) for t in tables)
    cx, cy = codes
    return _SymJob(
        tab_key=mt.tobytes() + gx.tobytes() + gy.tobytes(), match_t=mt, gapx_t=gx,
        gapy_t=gy, cx=np.asarray(cx, dtype=np.int32), cy=np.asarray(cy, dtype=np.int32),
        wband=wband, tp_scalar=pp._san(tp_scalar),
        start=pp._san(sm.ragged_start if job.ragged_left else sm.start),
        end=pp._san(sm.ragged_end if job.ragged_right else sm.end),
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
    """Buckets of staged symbol jobs, for realignment and the nucleotide
    E-step alike: one (plan, W, Dp rung, table set) each, consecutive jobs,
    at most MAX_BUCKET problems and BUCKET_CELLS window cells (one job at
    least).  Returns [(plan, W, Dp, staged indices)]."""
    groups: dict[tuple, list[int]] = {}
    for si, (_ji, sj, plan) in enumerate(staged):
        key = (plan, sj.wband.W, _dp_ladder(sj.wband.n_diagonals + 2), sj.tab_key)
        groups.setdefault(key, []).append(si)
    out = []
    for (plan, W, Dp, _tk), sidx in groups.items():
        cap = max(1, min(MAX_BUCKET, BUCKET_CELLS // (Dp * W)))
        out += [(plan, W, Dp, sidx[lo:lo + cap]) for lo in range(0, len(sidx), cap)]
    return out


def stage_symbol_bucket(staged, idxs, device: torch.device):
    """Host staging of one bucket of symbol jobs (``idxs`` into ``staged``):
    the flat int8 code stream, the window stream and the meta blocks,
    uploaded to ``device``.  Returns (tensors, the jobs' y codes)."""
    sj0 = staged[idxs[0]][1]
    n_tp, S = len(sj0.tp_scalar), len(sj0.start)
    B = len(idxs)
    meta_i = np.zeros((B, _META_I), dtype=np.int32)
    meta_f = np.zeros((B, n_tp + 2 * S), dtype=np.float32)
    codes_l, win_l = [], []
    co = wo = n_cy = 0
    for bi, si in enumerate(idxs):
        sj = staged[si][1]
        D = sj.wband.n_diagonals
        meta_i[bi, MI_RANK_LEN] = len(sj.cx)
        meta_i[bi, MI_EV_LEN] = len(sj.cy)
        meta_i[bi, MI_WIN_D] = D
        meta_i[bi, MI_W00] = int(sj.wband.w0[0])
        meta_i[bi, MI_REAL] = 1
        meta_i[bi, MI_RANK_OFF] = co
        meta_i[bi, MI_EV_OFF] = co + len(sj.cx)
        meta_i[bi, MI_WIN_OFF] = wo
        wenc = _flat_win_encode(sj.wband)
        codes_l += [sj.cx.astype(np.int8), sj.cy.astype(np.int8)]
        win_l.append(wenc)
        co += len(sj.cx) + len(sj.cy)
        wo += len(wenc)
        n_cy += len(sj.cy)
        meta_f[bi, :n_tp] = sj.tp_scalar
        meta_f[bi, n_tp:n_tp + S] = sj.start
        meta_f[bi, n_tp + S:] = sj.end
    tables = (sj0.match_t, sj0.gapx_t, sj0.gapy_t)
    bufs = [pp.to_device(a, device) for a in (
        *tables, meta_i, meta_f, _flat(codes_l, np.int8), _flat(win_l, np.int16))]
    return bufs, n_cy


def symbol_problem(W: int, Dp: int, n_tp: int, S: int, mt, gx, gy, meta_i, meta_f,
                   flat_c, flat_w):
    """Device unpack of a staged symbol bucket into the window problem the
    kernels take (E from ``symbol_emissions``, the DS_* scalars from the
    window stream).  Returns (WindowProblem, cxp, cyp, real)."""
    dev = meta_i.device
    Lc = Dp + 2
    fc = flat_c.to(torch.int32)
    la = torch.arange(Lc, dtype=torch.int32, device=dev)[None, :]

    def codes(off, ln):
        n = meta_i[:, ln:ln + 1]
        idx = meta_i[:, off:off + 1] + torch.minimum(la, n - 1)
        return torch.where(la < n, fc[idx.long()], 4)

    cxp = codes(MI_RANK_OFF, MI_RANK_LEN)
    cyp = codes(MI_EV_OFF, MI_EV_LEN)
    win = _unpack_win(meta_i, flat_w.to(torch.int32), W, Dp)
    lY = meta_i[:, MI_EV_LEN] - 1
    d_last = meta_i[:, MI_WIN_D] - 1
    # code arrays this long never clip the emission offsets, so DS_XS is
    # the x-window step exactly as pipeline.make_window_problem sets it
    Lq = Dp + 2 * W + 128
    ds, x0, _yr0 = _pack_ds(win, lY, W, Lq, Lq)
    E = symbol_emissions(mt, gx, gy, cxp, cyp, win[:, 0], d_last, W)
    prob = pp.WindowProblem(
        E=E, diag_scalars=ds, d_last=d_last.contiguous(),
        start=meta_f[:, n_tp:n_tp + S].contiguous(),
        end=meta_f[:, n_tp + S:n_tp + 2 * S].contiguous(),
        tp_scalar=meta_f[:, :n_tp].contiguous(),
        x0=torch.cat([x0[:, :Dp], x0[:, Dp - 1:Dp]], 1) - W)   # _pack_ds pads x by W
    return prob, cxp, cyp, meta_i[:, MI_REAL] > 0


def run_symbol_jobs(staged: list[tuple[int, _SymJob, object]], threshold: float,
                    *, device: torch.device, timing: dict | None = None
                    ) -> dict[int, object]:
    """The symbol lane's alignment (run_symbol_jobs, nh = 1): buckets of
    ``symbol_buckets``, each unpacked, its E gathered, forward and stage-3
    backward, and its pairs compacted on the device; all buckets dispatched,
    then collected with one copy.  Returns {job_index: AlignedPairs}, None
    for a job whose pairs overflowed (the caller's full-grid re-route)."""
    pending = []
    with timed("host_pack", timing):
        for plan, W, Dp, chunk in symbol_buckets(staged):
            sj0 = staged[chunk[0]][1]
            bufs, n_cy = stage_symbol_bucket(staged, chunk, device)
            # nucleotide posteriors spread more mass off the diagonal than the
            # signal lane's: room for 2 pairs a y position, the full-grid
            # re-route catching the rare spill
            Kg = _round_up(2 * n_cy + 512, 2048)
            prob, _cxp, _cyp, real = symbol_problem(W, Dp, len(sj0.tp_scalar),
                                                    len(sj0.start), *bufs)
            p, _totals = pp.run_window(plan, W, prob)
            cnt, over, outq, outi = _extract_global(p, threshold, Kg, real)
            pending.append((staged, chunk, torch.cat([cnt, over, outq, outi]), W, Dp, Kg))
    return collect_fast_jobs(pending, timing=timing)
