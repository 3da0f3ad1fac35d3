"""Device-batched alignment of split jobs (port of engine/batch_align.py:89-162,
282-402, threeState lane).

The CLIs collect SplitJobs (reads x strands x splits, engine/align.py); this
module stages every threeState job into the device-packed fast lane
(engine/readpath.py), dispatches waves while later reads are still being
prepared, collects all waves with one copy, and re-routes the rare job whose
pairs overflowed the compact extraction through the full-grid path.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.window import WindowBand, smooth_band
from . import pipeline as pp
from . import readpath
from .align import AlignedPairs, SplitJob, _extract_pairs, window_grids

MAX_BUCKET = 64      # full-grid problems per device batch (bounds host packing)
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


def job_window(band) -> WindowBand:
    """The constant-step window a job runs in: 64 lanes when its true band
    fits (most split jobs under the default expansion), else a multiple of
    128."""
    wb = smooth_band(band, width_multiple=64)
    return wb if wb.W == 64 else smooth_band(band, width_multiple=128)


def _unsupported(job) -> NotImplementedError:
    """The error for a job whose machine has no lane in the port yet."""
    sm = job.sm
    if getattr(sm, "symbol_codes", None) is not None:
        what = "the symbol (fiveState/realign) lane, ROADMAP queue 1 item 8"
    elif getattr(sm, "hdp_pack", None) is not None:
        what = "threeStateHdp alignment, ROADMAP queue 1 item 7"
    else:
        what = "the generic window machines, ROADMAP queue 1 item 7"
    return NotImplementedError(f"{sm.spec.name} jobs need {what}; the port "
                               "aligns threeState jobs only")


def batch_align_stream(per_read_jobs, threshold: float, *, device: torch.device,
                       timing: dict | None = None):
    """Streaming device-batched alignment: ``per_read_jobs`` yields per-read
    SplitJob lists (so split/band prep runs lazily); jobs are staged as they
    arrive and dispatched in waves of ~WAVE_EVENTS events, so the card
    computes while the host prepares the remaining reads; one copy then
    collects every wave.  Returns (jobs, pairs) with pairs aligned to jobs.
    Jobs whose machine is not threeState raise NotImplementedError."""
    t0 = time.perf_counter()
    jobs: list[SplitJob] = []
    wbands = []
    staged_wave: list = []
    pending: list = []
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
            if getattr(j.sm, "sm3_pack", None) is None:
                raise _unsupported(j)
            i = len(jobs)
            jobs.append(j)
            wb = job_window(j.band)
            wbands.append(wb)
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
