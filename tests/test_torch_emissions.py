"""The premises of the emissions kernel's tile design (csrc/fb_sm3.cu,
Kernel 1), on the CPU:

  * along every band the port builds, x0 steps by 0 or +1 a diagonal and yr0
    by 0 or -1 (padded diagonals and both clamps included), so K consecutive
    diagonals read at most K - 1 + W columns of each row: the offsets of the
    main path's launches (readpath, recorded from batch_align_jobs), of
    pipeline.make_sm3_problem, and of the one window-row builder,
    pipeline.band_scalars, on walks that meet both clamps;
  * the launch configuration's Python mirror (fb_kernels.emission_config)
    fits the 227 KB of shared memory a block may use at every width, and
    stages at least K - 1 + W columns a row;
  * a numpy model of the kernel's staging (span, 16-byte aligned rows, the
    bulk-copied middle and the <= 3 columns at either end loaded one by one,
    the device-memory path of tiles that do not fit) reads, cell for cell,
    the values the plain version gathers.  Unstaged columns hold NaN, so a
    read outside what was staged shows.

The kernel against the plain version on the card is in
tests/test_torch_cuda.py; the plain version against the Pallas kernel in
tests/test_torch_kernels.py::test_emissions_plain_matches_pallas.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.core.band import band_construct
from cpecan_signal_tpu_torch.core.window import smooth_band
from cpecan_signal_tpu_torch.engine import batch_align as tba
from cpecan_signal_tpu_torch.engine import pipeline as pp
from cpecan_signal_tpu_torch.engine import readpath as trp
from cpecan_signal_tpu_torch.engine.align import collect_split_jobs
from cpecan_signal_tpu_torch.models.params import cli_defaults
from cpecan_signal_tpu_torch.models.state_machines import make_signal_sm3
from cpecan_signal_tpu_torch.ops import fb_kernels as fk

CPU = torch.device("cpu")
BLOCK_SMEM = 232448          # the H100's shared memory per block (227 KB)
WIDTHS = list(range(32, 1025, 32))


def assert_band_offsets(x0, yr0, W, n_diag):
    """x0 steps in {0, 1} and yr0 in {0, -1} over each problem's first
    n_diag[b] diagonals, and every tile of K diagonals of them spans at most
    K - 1 + W columns of each row."""
    K = fk.emission_config(W)[0]
    for b in range(x0.shape[0]):
        xs, ys = x0[b, :n_diag[b]], yr0[b, :n_diag[b]]
        assert set(np.diff(xs).tolist()) <= {0, 1}, b
        assert set(np.diff(ys).tolist()) <= {0, -1}, b
        for d0 in range(0, len(xs), K):
            assert xs[d0:d0 + K].max() - xs[d0:d0 + K].min() <= K - 1
            assert ys[d0:d0 + K].max() - ys[d0:d0 + K].min() <= K - 1


@pytest.fixture(scope="module")
def pore(tmp_path_factory):
    rng = np.random.default_rng(5)
    return syn.write_pore_model(str(tmp_path_factory.mktemp("m") / "synthetic.model"), rng)


def test_main_path_offsets_step_by_one(pore, monkeypatch):
    """The emissions launches of batch_align_jobs (the readpath fast lane) on
    random threeState jobs, two window widths, with padded diagonals."""
    rng = np.random.default_rng(17)
    params = cli_defaults()
    jobs = []
    for n_bases, stride in ((160, 20), (420, 40), (300, 0), (700, 60)):
        target = "".join(rng.choice(list("ACGT"), n_bases))
        events, path = syn.simulate_events(pore, target, rng)
        anchors = (syn.path_anchors(path, n_bases - 5, len(events), stride) if stride
                   else np.zeros((0, 2), dtype=np.int64))
        jobs += collect_split_jobs(lambda t, e: make_signal_sm3(pore, t, e), target,
                                   events, anchors, params)
    seen = []
    real = fk.emissions_sm3

    def record(x0, yr0, xarr, evr, W, Dp):
        seen.append((x0.numpy().copy(), yr0.numpy().copy(), W, Dp))
        return real(x0, yr0, xarr, evr, W, Dp)

    monkeypatch.setattr(fk, "emissions_sm3", record)
    tba.batch_align_jobs(jobs, params.threshold, device=CPU)
    assert len({W for *_a, W, _d in seen}) >= 2
    for x0, yr0, W, Dp in seen:
        assert_band_offsets(x0, yr0, W, [Dp] * x0.shape[0])
    assert any(x0.shape[1] - 1 > 64 for x0, *_r in seen)   # tiles of 64 diagonals


def test_host_problem_offsets_step_by_one(pore):
    """pipeline.make_sm3_problem (pad_window and band_scalars) on random
    windows, padded past their last diagonal (Dp a rung above D)."""
    rng = np.random.default_rng(23)
    for n_bases, expansion, W in ((60, 20, 64), (200, 50, 128), (120, 8, 32)):
        target = "".join(rng.choice(list("ACGT"), n_bases))
        events, path = syn.simulate_events(pore, target, rng)
        anchors = syn.path_anchors(path, n_bases - 5, len(events), 25)
        wb = smooth_band(band_construct(anchors, n_bases - 5, len(events), expansion),
                         width_multiple=W)
        Dp = wb.n_diagonals + 150
        _plan, prob = pp.make_sm3_problem(pore, target, events, wb, device=CPU, pad_d=Dp)
        assert_band_offsets(prob.x0.numpy()[None], prob.yr0.numpy()[None], wb.W, [Dp])


def test_pack_ds_offsets_step_by_one_at_both_clamps():
    """pipeline.band_scalars on random +-1 walks of w0 whose offsets run
    into 0 and into lXp - W (lYp - W) within the same problems."""
    rng = np.random.default_rng(29)
    B, Dp, W = 6, 900, 64
    lXp, lYp = 384, 320
    x0, yr0, _xarr, _evr = chip_smoke.emission_inputs(
        rng, B, Dp, W, CPU, w0_start=-300, lY=(350, 450), cols=(lXp, lYp))
    x0, yr0 = x0.numpy()[:, :Dp], yr0.numpy()[:, :Dp]
    for a, hi in ((x0, lXp - W), (yr0, lYp - W)):
        assert (a == 0).any() and (a == hi).any()
    assert_band_offsets(x0, yr0, W, [Dp] * B)


def test_emission_config_fits():
    """At every window width the block's shared memory fits the 227 KB,
    a staged row holds a span of K - 1 + W columns from the 16-byte
    boundary before it, and the block is whole windows of whole warps."""
    for W in WIDTHS:
        K, row, threads, smem = fk.emission_config(W)
        assert 32 <= K <= 128 and K % 32 == 0
        assert row % 4 == 0 and row >= K - 1 + W + 3
        assert smem == 16 + 4 * (fk.EMIT_ROWS * row + 2 * K + 4)
        assert smem <= BLOCK_SMEM
        assert threads % W == 0 and threads % 32 == 0 and K <= threads <= 1024
    assert fk.emission_config(128) == (64, 196, 512, 12304)
    assert fk.emission_config(1024)[3] > 48 * 1024   # the opt-in above 48 KB


def staged_reads(x0, yr0, xarr, evr, W, Dp):
    """Model of the kernel's loads: (the values each cell reads from the 13
    x-pack rows and the 2 event rows (B, Dp, 15, W), staged tiles, tiles).
    Per (problem, tile of K diagonals): the span of clamped columns; if the
    rows start on 16 bytes (lXp, lYp multiples of 4) and the span fits,
    each row is staged from its 16-byte boundary: the aligned middle as one
    copy of whole 16-byte units, the <= 3 columns at either end one by
    one, the rest NaN; else the cells read the inputs."""
    K, RS, _threads, _smem = fk.emission_config(W)
    B, _, lXp = xarr.shape
    lYp = evr.shape[2]
    lane = np.arange(W)
    out = np.full((B, Dp, 15, W), np.nan, np.float32)
    n_staged = n_tiles = 0
    for b in range(B):
        src = [xarr[b, r] for r in range(13)] + [evr[b, 0], evr[b, 1]]
        for d0 in range(0, Dp, K):
            n = min(K, Dp - d0)   # x0 and yr0 hold Dp + 1 offsets; the last is not read
            xs, ys = x0[b, d0:d0 + n].astype(np.int64), yr0[b, d0:d0 + n].astype(np.int64)
            xi = np.clip(xs[:, None] + lane, 0, lXp - 1)
            yi = np.clip(ys[:, None] + lane, 0, lYp - 1)
            lo = {"x": min(max(xs.min(), 0), lXp - 1), "y": min(max(ys.min(), 0), lYp - 1)}
            hi = {"x": min(max(xs.max() + W - 1, 0), lXp - 1),
                  "y": min(max(ys.max() + W - 1, 0), lYp - 1)}
            staged = ((lXp | lYp) & 3) == 0 and all(hi[k] - lo[k] < K - 1 + W for k in "xy")
            n_tiles += 1
            n_staged += staged
            for r in range(15):
                k, idx = ("x", xi) if r < 13 else ("y", yi)
                if not staged:
                    out[b, d0:d0 + K, r] = src[r][idx]
                    continue
                base = lo[k] & ~3
                a0 = min((lo[k] + 3) & ~3, hi[k] + 1)
                b0 = max((hi[k] + 1) & ~3, a0)
                assert (a0 - base) % 4 == 0 and (b0 - a0) % 4 == 0 and b0 - base <= RS
                row = np.full(RS, np.nan, np.float32)
                row[a0 - base:b0 - base] = src[r][a0:b0]
                for e in range(8):          # the kernel's 8 loads a row
                    c = lo[k] + e if e < 4 else b0 + e - 4
                    if (c < a0) if e < 4 else (c <= hi[k]):
                        row[c - base] = src[r][c]
                out[b, d0:d0 + K, r] = row[idx - base]
    return out, n_staged, n_tiles


def plain_reads(x0, yr0, xarr, evr, W, Dp):
    lane = np.arange(W)
    xi = np.clip(x0[:, :Dp, None].astype(np.int64) + lane, 0, xarr.shape[2] - 1)
    yi = np.clip(yr0[:, :Dp, None].astype(np.int64) + lane, 0, evr.shape[2] - 1)
    b = np.arange(x0.shape[0])[:, None, None]
    rows = [xarr[:, r][b, xi] for r in range(13)] + [evr[:, 0][b, yi], evr[:, 1][b, yi]]
    return np.stack(rows, 2)


@pytest.mark.parametrize("case", ["band", "random", "unaligned", "short"])
def test_staged_tiles_read_what_the_plain_version_reads(case):
    """The staging model against the plain gather, bit for bit: band offsets
    (every tile staged; Dp not a multiple of K), random offsets past both
    ends of the rows (tiles too wide take the device-memory path), rows that
    do not start on 16 bytes (no tile staged), and Dp below K; and E of the
    plain version is the function of those reads (its rows >= Dp zero)."""
    rng = np.random.default_rng({"band": 1, "random": 2, "unaligned": 3, "short": 4}[case])
    W, Dp, B = 64, {"short": 40}.get(case, 301), 3
    x0, yr0, xarr, evr = (t.numpy() for t in chip_smoke.emission_inputs(
        rng, B, Dp, W, CPU, random_tiles=case == "random", unaligned=case == "unaligned"))
    got, n_staged, n_tiles = staged_reads(x0, yr0, xarr, evr, W, Dp)
    np.testing.assert_array_equal(got, plain_reads(x0, yr0, xarr, evr, W, Dp))
    if case in ("band", "short"):
        assert n_staged == n_tiles
    elif case == "random":
        assert 0 < n_staged < n_tiles
    else:
        assert n_staged == 0
    E = fk.emissions_sm3(*(torch.from_numpy(a) for a in (x0, yr0, xarr, evr)), W, Dp)
    assert E.shape == (B, Dp + 2, 3, W) and (E[:, Dp:] == 0).all()
    np.testing.assert_array_equal(E[:, :Dp, 0].numpy(), got[:, :, 12])
