"""The port's one staging path from split jobs to kernel launches, on the CPU.

  * the window-row builder (``pipeline.band_scalars``, with
    ``pipeline.pad_window`` and ``window_band_scalars``) against the JAX
    package's builders in each lane that uses it: the host-packed threeState
    problem (make_sm3_pallas_problem), the generic window problem
    (make_window_pallas_problem), and the symbol and fast lanes (the JAX
    device lanes' flat-transport decode, ``_unpack_win`` / ``_unpack_dev``,
    and ``_pack_ds``): DS_* rows, x0 and yr0 equal on every job's own
    diagonals, and the padded diagonals keep an empty band;
  * the one bucketing rule (``pipeline.launch_groups``): the jobs that share
    each launch of the three cells' paths (the threeState EM buckets, the
    symbol lane of realignment, the nucleotide E-step) on the tests' job
    sets, with both caps binding: the threeState EM lists the staging
    produced before the rule was one function, the symbol lane's longest
    job first;
  * the symbol lane's launches (``readpath.symbol_buckets``): no Dp rung in
    a key, jobs longest first, a launch's Dp the rung of its longest job,
    its window cells within BUCKET_CELLS, one window width a launch.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_signal_tpu.core.band import band_construct
from cpecan_signal_tpu.core.window import smooth_band
from cpecan_signal_tpu.engine import pallas_pipeline as jpp
from cpecan_signal_tpu.engine import readpath as jrp
from cpecan_signal_tpu.models.pore_model import scale_model
from cpecan_signal_tpu.models.state_machines import (bind_symbol_sequences, make_signal_sm3,
                                                     make_symbol_sm5)
from cpecan_signal_tpu_torch.cli.realign import record_jobs
from cpecan_signal_tpu_torch.em import discrete, sm3_em
from cpecan_signal_tpu_torch.engine import batch_align as tba
from cpecan_signal_tpu_torch.engine import pipeline as tpp
from cpecan_signal_tpu_torch.engine import readpath as trp
from cpecan_signal_tpu_torch.engine.align import SplitJob
from cpecan_signal_tpu_torch.models.params import AlignmentParams
from cpecan_signal_tpu_torch.ops import fb_kernels as fk
from test_readpath_random import _rand_pore, _rand_signal_case
from test_torch_tracing import _em_jobs, _records
from test_torch_window import _machine

CPU = torch.device("cpu")
WIDTHS = (64, 256)     # window multiples: the JAX stream's 1-word and 3-row encodings


def jax_flat_staging(jobs, slots=None):
    """The JAX device lanes' flat transport of ``jobs`` (the port's staged
    _FastJobs, or _SymJobs with ``slots`` None), every row real: (meta_i,
    meta_f, flat ranks or codes, flat window stream, flat events), as the
    JAX package's dispatch_fast_jobs and run_symbol_jobs stage a bucket."""
    fast = slots is not None
    n_tp, S = len(jobs[0].tp_scalar), len(jobs[0].start)
    meta_i = np.zeros((len(jobs), jrp._META_I), dtype=np.int32)
    meta_f = np.zeros((len(jobs), (8 if fast else 0) + n_tp + 2 * S), dtype=np.float32)
    first, wins, events = [], [], []
    ro = wo = eo = 0
    for bi, j in enumerate(jobs):
        rows = [j.ranks] if fast else [j.cx, j.cy]
        ev = j.events if fast else np.zeros((0, 2))
        meta_i[bi, [jrp.MI_RANK_OFF, jrp.MI_RANK_LEN, jrp.MI_EV_OFF, jrp.MI_EV_LEN,
                    jrp.MI_WIN_OFF, jrp.MI_WIN_D, jrp.MI_W00, jrp.MI_REAL]] = (
            ro, len(rows[0]), eo if fast else ro + len(j.cx),
            len(ev) if fast else len(j.cy), wo, j.wband.n_diagonals, j.wband.w0[0], 1)
        if fast:
            meta_i[bi, jrp.MI_BASE] = slots[bi]
            meta_f[bi, :8] = j.scale8
        meta_f[bi, -(n_tp + 2 * S):] = np.concatenate([j.tp_scalar, j.start, j.end])
        first += rows
        wins.append(jrp._flat_win_encode(j.wband))
        events.append(np.concatenate([ev[::-1, 0], ev[::-1, 1]]).astype(np.float32))
        ro += sum(len(r) for r in rows)
        wo += len(wins[-1])
        eo += 2 * len(ev)
    return (meta_i, meta_f, np.concatenate(first).astype(np.int16),
            np.concatenate(wins), np.concatenate(events))


def _signal_jobs(seed, n, width):
    """n threeState split jobs on random reads (every other one with a
    scaled model), each with its window of a multiple of ``width`` lanes."""
    rng = np.random.default_rng(seed)
    base = _rand_pore(rng)
    out = []
    for ci in range(n):
        pore = scale_model(base, 1.1, 2.0, 1.05, 0.9, 1.0) if ci % 2 else base
        target, events, anchors = _rand_signal_case(rng, pore, int(rng.integers(24, 200)))
        band = band_construct(anchors, len(target) - 5, len(events), 6)
        out.append((SplitJob(make_signal_sm3(pore, target, events), band, 0, 0,
                             bool(ci % 2), bool(ci % 3)),
                    smooth_band(band, width_multiple=width)))
    return out


def _symbol_jobs(seed, n, width):
    """n fiveState split jobs on random pairs (10 % substitutions, no
    anchors) in windows of ``width`` lanes, staged for the symbol lane."""
    rng = np.random.default_rng(seed)
    staged = []
    for ci in range(n):
        sx = "".join(rng.choice(list("ACGT"), int(rng.integers(24, 180))))
        sy = "".join(c if rng.random() > 0.1 else "G" for c in sx)
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, sx, sy)
        band = band_construct(np.zeros((0, 2), dtype=np.int64), len(sx), len(sy), 6)
        job = SplitJob(sm, band, 0, 0, bool(ci % 2), bool(ci % 3))
        staged.append(trp.stage_symbol_job(job, smooth_band(band, width_multiple=width)))
    return staged


def _lane_rows(lane, width):
    """[(port (DS_* rows, x0, yr0), JAX (the same), D)] of one problem each,
    yr0 None where the lane has none; x0 is the grid x in window problems."""
    out = []
    if lane == "sm3_problem":
        for job, wb in _signal_jobs(5, 4, width):
            pore, target, events, trans, gapx = job.sm.sm3_pack
            kw = dict(transitions=trans, kmer_gap_probs=gapx, ragged_left=job.ragged_left,
                      ragged_right=job.ragged_right, pad_lx=len(target) + 9,
                      pad_ly=len(events) + 5, pad_d=wb.n_diagonals + 37)
            _jp, j = jpp.make_sm3_pallas_problem(pore, target, events, wb, **kw)
            _tp, t = tpp.make_sm3_problem(pore, target, events, wb, device=CPU, **kw)
            out.append(((t.diag_scalars, t.x0, t.yr0), (j.diag_scalars, j.x0, j.yr0),
                        wb.n_diagonals))
    elif lane == "window_problem":
        for name in ("vanilla-template", "fourState", "echelon"):
            sm, wb = _machine(name)
            wb = smooth_band(band_construct([], wb.lX, wb.lY, 4), width_multiple=width)
            _jp, j = jpp.make_window_pallas_problem(sm, wb, ragged_left=False)
            _tp, t = tpp.make_window_problem(sm, wb, device=CPU, ragged_left=False,
                                             pad_d=wb.n_diagonals + 21)
            out.append(((t.diag_scalars, t.x0, None), (j.diag_scalars, j.x0, None),
                        wb.n_diagonals))
    elif lane == "symbol_lane":
        staged = [(i, *s) for i, s in enumerate(_symbol_jobs(7, 5, width))]
        for W in {s[1].wband.W for s in staged}:
            group = [s for s in staged if s[1].wband.W == W]
            jobs = [sj for _i, sj, _p in group]
            Dp = trp._dp_ladder(max(sj.wband.n_diagonals for sj in jobs) + 2)
            tables, bucket, _n = trp.stage_symbol_bucket(group, list(range(len(group))), Dp,
                                                         CPU)
            prob = trp.symbol_problem(W, tables, bucket)
            meta_i, _mf, _fc, flat_w, _fe = jax_flat_staging(jobs)
            win = jrp._unpack_win(jnp.asarray(meta_i), jnp.asarray(flat_w.astype(np.int32)),
                                  W, Dp)
            lY = np.array([len(sj.cy) - 1 for sj in jobs], dtype=np.int32)
            Lq = Dp + 2 * W + 128
            jds, jx0, jyr0 = jrp._pack_ds(win, jnp.asarray(lY), W, Lq, Lq)
            tds, tx0, tyr0 = tpp.band_scalars(bucket.win, torch.from_numpy(lY), W, Lq, Lq)
            assert torch.equal(prob.diag_scalars, tds)
            for b, sj in enumerate(jobs):
                out.append(((tds[b], tx0[b], tyr0[b]), (jds[b], jx0[b], jyr0[b]),
                            sj.wband.n_diagonals))
                out.append(((prob.diag_scalars[b], prob.x0[b], None),
                            (jds[b], np.asarray(jx0[b]) - W, None), sj.wband.n_diagonals))
    else:
        staged = [trp.stage_fast_job(job, wb) for job, wb in _signal_jobs(9, 6, width)]
        for W in {fj.wband.W for fj, _p in staged}:
            jobs = [fj for fj, _p in staged if fj.wband.W == W]
            Dp = trp._dp_ladder(max(fj.wband.n_diagonals for fj in jobs) + 2)
            lXp = trp.round_up(Dp + 1 + 2 * W + 2 * 128, 128)
            slots = [b % 2 for b in range(len(jobs))]
            host = trp._stage_fast_bucket(jobs, slots, W, Dp, lXp, lXp)
            _xr, win, lY, *_r = jrp._unpack_dev(
                *(jnp.asarray(a) for a in jax_flat_staging(jobs, slots)), W=W, Dp=Dp,
                lXp=lXp, lYp=lXp, n_tp=len(jobs[0].tp_scalar), S=len(jobs[0].start))
            tds, tx0, tyr0 = tpp.band_scalars(torch.from_numpy(host.win),
                                              torch.from_numpy(host.lY), W, lXp, lXp)
            jds, jx0, jyr0 = jrp._pack_ds(win, lY, W, lXp, lXp)
            for b, fj in enumerate(jobs):
                out.append(((tds[b], tx0[b], tyr0[b]), (jds[b], jx0[b], jyr0[b]),
                            fj.wband.n_diagonals))
    return out


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("lane", ["sm3_problem", "window_problem", "symbol_lane",
                                  "fast_lane"])
def test_band_scalars_match_jax_builders(lane, width):
    rows = _lane_rows(lane, width)
    assert rows
    for port, jax, D in rows:
        ds = np.asarray(port[0])[:, 0]
        for name, a, b in zip(("diag_scalars", "x0", "yr0"), port, jax):
            if a is not None:
                a, b = np.asarray(a), np.asarray(b)
                np.testing.assert_array_equal(a[:D], b[:D], err_msg=f"{lane} {name}")
        assert len(ds) > D
        # padded diagonals: w0 keeps stepping by one, the band stays empty
        assert (np.abs(np.diff(ds[D - 1:-1, fk.DS_W0])) == 1).all()
        assert (ds[D:, fk.DS_XMYL] > ds[D:, fk.DS_XMYR]).all()


# ---------------------------------------------------------------------------
# Launch membership of the cells' paths
# ---------------------------------------------------------------------------

# the jobs of each launch (threeState EM: MAX_BUCKET 2, as the staging gave
# them before the bucketing rule was one function; symbol lane: MAX_BUCKET 2
# and BUCKET_CELLS 3 x 768 x 128, one key a window width, longest job first:
# diagonals 599, 598, 596, 595, 594, 591 at W 256 and 595, 594, 591 at W 128,
# the ties in job order)
PARENT_LAUNCHES = {
    "sm3_em": [[0, 1], [2, 3], [4, 6], [8], [7], [5]],
    "realign": [[8], [0], [5], [7], [3], [2], [6, 1], [4]],
    "nem": [[8], [0], [5], [7], [3], [2], [6, 1], [4]],
}


def _sm3_em_launches(mp):
    jobs = _em_jobs(np.random.default_rng(7), (30, 44, 38, 52, 41, 160, 35, 90, 47))
    index = {id(j.events): i for i, j in enumerate(jobs)}
    cur, out = [], []
    make, stack = tpp.make_sm3_problem, tpp.stack_problems

    def recording_make(pore, target, events, *a, **kw):
        cur.append(index[id(events)])
        return make(pore, target, events, *a, **kw)

    def recording_stack(probs):
        out.append(list(cur))
        cur.clear()
        return stack(probs)

    mp.setattr(tpp, "make_sm3_problem", recording_make)
    mp.setattr(tpp, "stack_problems", recording_stack)
    sm3_em.build_sm3_em_buckets(jobs, device=CPU, width_multiple=64)
    return out


class _Launched(Exception):
    """Raised once the symbol lane has decided its launches."""


def _symbol_launches(mp, path):
    recs, seqs = _records(np.random.default_rng(11), 9, 300)
    _heads, _spans, jobs = record_jobs(recs, seqs, AlignmentParams(), None)
    mp.setattr(trp, "BUCKET_CELLS", 3 * 768 * 128)
    out = []
    buckets = trp.symbol_buckets

    def recording(staged):
        out.extend([staged[si][0] for si in chunk] for *_key, chunk in buckets(staged))
        raise _Launched

    mp.setattr(trp, "symbol_buckets", recording)
    with pytest.raises(_Launched):
        if path == "realign":
            tba.batch_align_jobs(jobs, 0.01, device=CPU)
        else:
            discrete.discrete_expectations_batched(jobs, device=CPU)
    return out


@pytest.mark.parametrize("path", list(PARENT_LAUNCHES))
def test_cell_paths_keep_their_launches(path, monkeypatch):
    monkeypatch.setattr(tpp, "MAX_BUCKET", 2)
    got = (_sm3_em_launches(monkeypatch) if path == "sm3_em"
           else _symbol_launches(monkeypatch, path))
    assert got == PARENT_LAUNCHES[path]


def test_launch_groups_cut_by_count_and_size(monkeypatch):
    """Groups in order of their first job, jobs in order; a chunk's size is
    its count times its largest job's; a job over the cap goes alone."""
    monkeypatch.setattr(tpp, "MAX_BUCKET", 3)
    keys = ["a", "b", "a", "a", "a", "b", "a"]
    assert tpp.launch_groups(keys) == [("a", [0, 2, 3]), ("a", [4, 6]), ("b", [1, 5])]
    sizes = [2, 1, 2, 9, 1, 5, 1]
    assert tpp.launch_groups(keys, sizes, 8) == [
        ("a", [0, 2]), ("a", [3]), ("a", [4, 6]), ("b", [1]), ("b", [5])]


def _fake_staged(rng, n):
    """``n`` staged symbol jobs with the fields ``symbol_buckets`` reads:
    window diagonals log-uniform over 100-200 k (every Dp rung band), W 64
    or 128, one of two table sets."""
    diags = np.exp(rng.uniform(np.log(100), np.log(200_000), n)).astype(int)
    out = []
    for i, d in enumerate(diags):
        wband = SimpleNamespace(n_diagonals=int(d), W=int(rng.choice((64, 128))))
        tab_key = (b"a", b"b")[rng.integers(2)]
        out.append((i, SimpleNamespace(wband=wband, tab_key=tab_key), "fiveState"))
    return out


@pytest.mark.parametrize("cells", [None, 40 * 16384 * 128])
@pytest.mark.parametrize("seed", [3, 4])
def test_symbol_buckets_longest_first_without_rungs(seed, cells, monkeypatch):
    """Each key (plan, W, table set) holds jobs of every Dp rung, longest
    first; a launch's Dp is its longest job's rung, its count x Dp x W within
    BUCKET_CELLS unless it holds one job, and W 64 and 128 never share one."""
    if cells is not None:
        monkeypatch.setattr(trp, "BUCKET_CELLS", cells)
    staged = _fake_staged(np.random.default_rng(seed), 200)
    launches = trp.symbol_buckets(staged)
    assert sorted(i for *_k, chunk in launches for i in chunk) == list(range(len(staged)))
    by_key: dict = {}
    for plan, W, Dp, chunk in launches:
        jobs = [staged[i][1] for i in chunk]
        assert {sj.wband.W for sj in jobs} == {W}
        assert len({sj.tab_key for sj in jobs}) == 1
        assert len(chunk) <= tpp.MAX_BUCKET
        assert Dp == trp._dp_ladder(max(sj.wband.n_diagonals for sj in jobs) + 2)
        assert len(chunk) == 1 or len(chunk) * Dp * W <= trp.BUCKET_CELLS
        by_key.setdefault((plan, W, jobs[0].tab_key), []).extend(chunk)
    assert len(by_key) == 4
    for chunk in by_key.values():
        d = [staged[i][1].wband.n_diagonals for i in chunk]
        assert d == sorted(d, reverse=True)
    # the key holds no rung: jobs of several rungs share a launch
    assert any(len({trp._dp_ladder(staged[i][1].wband.n_diagonals + 2) for i in chunk}) > 1
               for *_k, chunk in launches)


def test_symbol_lane_pairs_independent_of_launches(monkeypatch):
    """Realignment's pairs of jobs of mixed lengths are the same bit for bit
    in the symbol lane's launches as with one job a launch."""
    recs, seqs = _records(np.random.default_rng(11), 2, 300)
    short, short_seqs = _records(np.random.default_rng(12), 2, 120)
    recs += [dataclasses.replace(r, contig1="s" + r.contig1, contig2="s" + r.contig2)
             for r in short]
    seqs.update({"s" + k: v for k, v in short_seqs.items()})
    _heads, _spans, jobs = record_jobs(recs, seqs, AlignmentParams(), None)
    staged = [(i, *trp.stage_symbol_job(j, tba.job_window(j.band))) for i, j in enumerate(jobs)]
    launches = trp.symbol_buckets(staged)
    assert len(launches) < len(jobs)
    assert any(len({staged[i][1].wband.n_diagonals for i in chunk}) > 1
               for *_k, chunk in launches)
    together = tba.batch_align_jobs(jobs, 0.01, device=CPU)
    monkeypatch.setattr(tpp, "MAX_BUCKET", 1)
    alone = tba.batch_align_jobs(jobs, 0.01, device=CPU)
    for a, b in zip(together, alone):
        assert len(a.probs) > 0
        assert a.as_tuples() == b.as_tuples()
