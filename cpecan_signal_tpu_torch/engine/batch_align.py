"""Device-batched alignment of split jobs (port of engine/batch_align.py:51-162,
282-402).

The CLIs collect SplitJobs (reads x strands x splits, engine/align.py); this
module stages every threeState job into the device-packed fast lane
(engine/readpath.py), dispatches waves while later reads are still being
prepared, collects all waves with one copy, and re-routes the rare job whose
pairs overflowed the compact extraction through the full-grid path.  Jobs
of the symbol machine (fiveState, realign) take the symbol lane of
engine/readpath.py, whose emissions are gathered on the device; one that
overflows re-routes to the generic machines' full-grid buckets.
threeStateHdp jobs build their emissions on the device from the HDP density
table (only window scalars, k-mer ranks and event means are packed on the
host) and compact their pairs there, with a slot for every passing cell.
Jobs of the generic window machines (vanilla, fourState, echelon, and
threeStateHdp with the --substitute alphabet) are packed on the host into
buckets of one machine and one window width, every bucket dispatched before
any result is awaited, and their posterior grids copied back once and
thresholded on the host.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..constants import PAIR_ALIGNMENT_PROB_1
from ..core.window import WindowBand, smooth_band
from ..models.state_machines import ECH_GAPX
from ..ops import fb_kernels as fk
from . import pipeline as pp
from . import readpath
from .align import AlignedPairs, SplitJob, _extract_pairs
from .window import window_grids

MAX_BUCKET = 64      # full-grid problems per device batch (bounds host packing)
BUCKET_E_BYTES = 4 << 30   # host-built E per generic bucket (pinned, uploaded)
WAVE_EVENTS = 8000   # events staged per dispatched wave


def _run_full_grid(jobs, wbands, idxs, threshold, device, out):
    """Full-grid path for threeState jobs whose compact extraction
    overflowed: host-packed problems batched per window width, the same
    kernels, the whole (Dp, W) posterior grid copied back and thresholded on
    the host."""
    by_width: dict[int, list[int]] = {}
    for i in idxs:
        by_width.setdefault(wbands[i].W, []).append(i)
    chunks = [w_idxs[lo:lo + MAX_BUCKET] for w_idxs in by_width.values()
              for lo in range(0, len(w_idxs), MAX_BUCKET)]
    for chunk in chunks:
        Dmax = max(wbands[i].n_diagonals for i in chunk)
        lxp = max(len(jobs[i].sm.sm3_pack[1]) for i in chunk)
        lyp = max(len(jobs[i].sm.sm3_pack[2]) for i in chunk)
        plan, probs = None, []
        for i in chunk:
            pore, target, events, trans, gapx = jobs[i].sm.sm3_pack
            iplan, prob = pp.make_sm3_problem(
                pore, target, events, wbands[i], device=device,
                transitions=trans, kmer_gap_probs=gapx,
                ragged_left=jobs[i].ragged_left,
                ragged_right=jobs[i].ragged_right,
                pad_lx=lxp, pad_ly=lyp, pad_d=Dmax)
            assert plan is None or iplan == plan, (jobs[i].sm.spec.name,)
            plan = iplan
            probs.append(prob)
        p, _totals = pp.run_sm3(plan, wbands[chunk[0]].W, pp.stack_problems(probs))
        p = p.cpu().numpy()
        for bi, i in enumerate(chunk):
            wb = wbands[i]
            x, y, _valid = window_grids(wb)
            out[i] = AlignedPairs(*_extract_pairs(p[bi][:wb.n_diagonals], x, y,
                                                  threshold, jobs[i].off_x,
                                                  jobs[i].off_y))


def _extract_multi_window(p_states, wb, threshold, off_x, off_y):
    """Echelon pairs from the per-state posteriors p_states (P, D, W) of
    matchN states n = 1..P in the window layout: a cell passing the
    threshold in state n emits the pairs (x + k - 1, y - 1), k < n
    (diagonalCalculationMultiPosteriorMatchProbs, pairwiseAligner.c:797-839,
    as engine/fb.extract_multi_pairs)."""
    x, y, valid = window_grids(wb)
    probs, xs, ys = [], [], []
    for si in range(p_states.shape[0]):
        pg = np.where(valid & (x > 0) & (y > 0), p_states[si], 0.0)
        mask = pg >= threshold
        if not mask.any():
            continue
        pq = np.floor(pg[mask] * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
        cx = x[mask].astype(np.int64)
        cy = y[mask].astype(np.int64)
        for k in range(si + 1):          # state si + 1 emits si + 1 k-mers
            probs.append(pq)
            xs.append(cx + k - 1 + off_x)
            ys.append(cy - 1 + off_y)
    if not probs:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    return np.concatenate(probs), np.concatenate(xs), np.concatenate(ys)


def _generic_chunks(wbands, idxs, plan_channels):
    """Split one (machine, width) group, in job order, into buckets of at
    most MAX_BUCKET problems whose E (padded to the bucket's longest job)
    stays within BUCKET_E_BYTES; a job larger than that alone gets a bucket
    of its own."""
    chunks, cur, dmax = [], [], 0
    for i in idxs:
        wb = wbands[i]
        d = max(dmax, wb.n_diagonals)
        e_bytes = (len(cur) + 1) * (d + 2) * plan_channels * wb.W * 4
        if cur and (len(cur) >= MAX_BUCKET or e_bytes > BUCKET_E_BYTES):
            chunks.append(cur)
            cur, d = [], wb.n_diagonals
        cur.append(i)
        dmax = d
    return chunks + [cur] if cur else chunks


def _run_generic_buckets(jobs, wbands, groups, threshold, device, out, timing=None):
    """Generic window machines (vanilla, fourState, echelon): pack and
    dispatch every bucket first, then collect every posterior grid with one
    copy and extract the pairs on the host.  Echelon buckets run the
    backward kernel's per-state posteriors (pstates = its matchN states)."""
    t0 = time.perf_counter()
    pending = []
    for (name, _W), idxs in groups.items():
        CT = pp._plan_channels(jobs[idxs[0]].sm)[1]
        for chunk in _generic_chunks(wbands, idxs, CT):
            plan, batch = pp.pack_window_bucket(
                [(jobs[i].sm, wbands[i], jobs[i].ragged_left, jobs[i].ragged_right)
                 for i in chunk], device)
            pstates = (tuple(range(plan.match_state, ECH_GAPX))   # match1..match5
                       if name == "echelon" else None)
            p, _totals = pp.run_window(plan, wbands[chunk[0]].W, batch, pstates=pstates)
            pending.append((chunk, p, pstates))
    t1 = time.perf_counter()
    grids = readpath._collect_packed([p for _c, p, _s in pending])
    t2 = time.perf_counter()
    for (chunk, _p, pstates), p in zip(pending, grids):
        for bi, i in enumerate(chunk):
            wb = wbands[i]
            D = wb.n_diagonals
            if pstates is not None:
                pairs = _extract_multi_window(p[bi, :D].transpose(1, 0, 2), wb, threshold,
                                              jobs[i].off_x, jobs[i].off_y)
            else:
                x, y, _valid = window_grids(wb)
                pairs = _extract_pairs(p[bi, :D], x, y, threshold, jobs[i].off_x,
                                       jobs[i].off_y)
            out[i] = AlignedPairs(*pairs)
    if timing is not None:
        for key, dt in (("host_pack", t1 - t0), ("device_wait", t2 - t1),
                        ("host_extract", time.perf_counter() - t2)):
            timing[key] = timing.get(key, 0.0) + dt


def job_window(band) -> WindowBand:
    """The constant-step window a job runs in: 64 lanes when its true band
    fits (most split jobs under the default expansion), else a multiple of
    128 (engine/batch_align.py:324-333, for the threeState and symbol jobs
    there)."""
    wb = smooth_band(band, width_multiple=64)
    return wb if wb.W == 64 else smooth_band(band, width_multiple=128)


class _Placed(NamedTuple):
    """What the compact decode needs of a job: its window and offsets."""

    wband: WindowBand
    off_x: int
    off_y: int


def _run_hdp_buckets(jobs, wbands, idxs, threshold, device, out, timing=None) -> None:
    """threeStateHdp jobs whose machine carries its density table
    (``sm.hdp_pack``; the JAX _hdp_align_fn / _run_hdp_buckets,
    engine/batch_align.py:165-279): the host packs only the window scalars,
    the k-mer ranks and the event means; E is built on the device from the
    table (``readpath.hdp_emissions``), then the forward and stage-3
    backward.  Buckets per (table, window width), bounded like the generic
    buckets.  The raw densities spread a read's posterior over many cells
    (tens of pairs an event), so the pairs are compacted with a slot for
    every passing cell: the count is read back (one wait a bucket), then
    ``readpath._extract_global`` keeps every lane of a diagonal; all buckets
    are collected with one copy."""
    t0 = time.perf_counter()
    groups: dict[tuple, list[int]] = {}
    for i in idxs:
        groups.setdefault((id(jobs[i].sm.hdp_pack[0]), wbands[i].W), []).append(i)
    pending = []
    for (_tid, W), g_idxs in groups.items():
        tab0, g0, dg = jobs[g_idxs[0]].sm.hdp_pack[:3]
        tab = pp.to_device(np.maximum(tab0, 0.0).astype(np.float32), device)
        for chunk in _generic_chunks(wbands, g_idxs, 3):
            Dp = max(wbands[i].n_diagonals for i in chunk)
            plan, (ds, d_last, start, end, tp, x0) = pp.stack_window_scalars(
                [(jobs[i].sm, wbands[i], jobs[i].ragged_left, jobs[i].ragged_right)
                 for i in chunk], Dp, device)
            rank, mean = (np.stack(a) for a in zip(*(pp.hdp_inputs(jobs[i].sm, Dp + 2)
                                                     for i in chunk)))
            E = readpath.hdp_emissions(tab, g0, dg or 1.0, pp.to_device(rank, device),
                                       pp.to_device(mean, device),
                                       ds[:, :Dp, 0, fk.DS_W0], d_last, W)
            p, _totals = pp.run_window(plan, W, pp.WindowProblem(E, ds, d_last, start,
                                                                 end, tp, x0))
            del E
            Kg = readpath._round_up(int((p >= np.float32(threshold)).sum()) + 1, 2048)
            real = torch.ones(len(chunk), dtype=torch.bool, device=device)
            cnt, over, outq, outi = readpath._extract_global(p, threshold, Kg, real, L=W)
            staged = [(i, _Placed(wbands[i], jobs[i].off_x, jobs[i].off_y), plan)
                      for i in chunk]
            pending.append((staged, list(range(len(chunk))),
                            torch.cat([cnt, over, outq, outi]), W, Dp, Kg))
    if timing is not None:
        timing["host_pack"] = timing.get("host_pack", 0.0) + (time.perf_counter() - t0)
    for ji, pairs in readpath.collect_fast_jobs(pending, timing=timing).items():
        assert pairs is not None, ji   # a slot for every passing cell
        out[ji] = pairs


def batch_align_stream(per_read_jobs, threshold: float, *, device: torch.device,
                       timing: dict | None = None):
    """Streaming device-batched alignment: ``per_read_jobs`` yields per-read
    SplitJob lists (so split/band prep runs lazily); jobs are staged as they
    arrive and dispatched in waves of ~WAVE_EVENTS events, so the card
    computes while the host prepares the remaining reads; one copy then
    collects every wave.  Symbol (fiveState) jobs take the symbol lane after
    the threeState waves are collected, threeStateHdp jobs whose machine
    carries its density table their device-built buckets after them, and
    the jobs of the generic window machines (threeStateHdp ones without a
    table among them: the --substitute alphabet) are bucketed by (machine,
    window width) and run last.  Returns (jobs, pairs) with pairs aligned
    to jobs."""
    t0 = time.perf_counter()
    jobs: list[SplitJob] = []
    wbands = []
    staged_wave: list = []
    staged_sym: list = []
    hdp_idxs: list[int] = []
    pending: list = []
    generic: dict[tuple, list[int]] = {}
    ev_acc = 0

    def flush():
        nonlocal staged_wave, ev_acc
        if staged_wave:
            pending.extend(readpath.dispatch_fast_jobs(staged_wave, threshold,
                                                       device=device))
            staged_wave = []
            ev_acc = 0

    for jl in per_read_jobs:
        for j in jl:
            i = len(jobs)
            jobs.append(j)
            wb = job_window(j.band)
            wbands.append(wb)
            if getattr(j.sm, "hdp_pack", None) is not None:
                hdp_idxs.append(i)
                continue
            if getattr(j.sm, "sm3_pack", None) is None:
                sym = readpath.stage_symbol_job(j, wb)
                if sym is not None:
                    staged_sym.append((i, *sym))
                else:
                    generic.setdefault((j.sm.spec.name, wb.W), []).append(i)
                continue
            fj, plan = readpath.stage_fast_job(j, wb)
            staged_wave.append((i, fj, plan))
            ev_acc += len(fj.events)
        if ev_acc >= WAVE_EVENTS:
            flush()
    flush()
    if timing is not None:
        timing["host_pack"] = timing.get("host_pack", 0.0) + (time.perf_counter() - t0)

    out: list[AlignedPairs | None] = [None] * len(jobs)
    overflow = []
    for ji, pairs in readpath.collect_fast_jobs(pending, timing=timing).items():
        if pairs is None:
            overflow.append(ji)
        else:
            out[ji] = pairs
    if overflow:
        _run_full_grid(jobs, wbands, overflow, threshold, device, out)
    if staged_sym:
        for ji, pairs in readpath.run_symbol_jobs(staged_sym, threshold, device=device,
                                                  timing=timing).items():
            if pairs is None:   # overflow: the full-grid generic buckets
                generic.setdefault((jobs[ji].sm.spec.name, wbands[ji].W), []).append(ji)
            else:
                out[ji] = pairs
    if hdp_idxs:
        _run_hdp_buckets(jobs, wbands, hdp_idxs, threshold, device, out, timing)
    if generic:
        _run_generic_buckets(jobs, wbands, generic, threshold, device, out, timing)
    return jobs, out


def batch_align_jobs(jobs: list[SplitJob], threshold: float, *,
                     device: torch.device, timing: dict | None = None
                     ) -> list[AlignedPairs]:
    """Run every job's banded FB on ``device`` (bucketed + stacked) and
    return per-job AlignedPairs (split-local coordinates already shifted by
    the job's off_x/off_y)."""
    _jobs, out = batch_align_stream(iter([list(jobs)]), threshold, device=device,
                                    timing=timing)
    return out


def assemble_pairs(frags: list[AlignedPairs]) -> AlignedPairs:
    """Concatenate split fragments (in split order) into one AlignedPairs."""
    if not frags:
        z = np.zeros(0, dtype=np.int64)
        return AlignedPairs(z, z, z)
    return AlignedPairs(np.concatenate([f.probs for f in frags]),
                        np.concatenate([f.x for f in frags]),
                        np.concatenate([f.y for f in frags]))
