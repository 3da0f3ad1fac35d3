"""PyTorch port on a CUDA card: each hand-written kernel against its plain
PyTorch version on the same CUDA tensors, and the device-batched slice on
the card against the CPU plain path.

Every test needs a card and skips without one.  The file imports no jax, so
on a machine with a card and without jax it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: the kernels run the same rounded f32 operations as the plain
versions (no FMA contraction, the same expf/logf), so E is held to rtol
1e-6; F and the totals to atol 1e-3 + rtol 1e-5 and p to atol 1e-4 leave
room only for the order of the block-wide sums.  The slice is held to
<= 1 pair per job and 1.2e-3 posterior (tests/test_readpath_random.py).
"""

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.core.band import band_construct
from cpecan_signal_tpu.core.window import smooth_band
from cpecan_signal_tpu.models.params import AlignmentParams
from cpecan_signal_tpu.models.state_machines import make_signal_sm3
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.engine import pipeline as pp
from cpecan_signal_tpu_torch.engine.align import SplitJob
from cpecan_signal_tpu_torch.engine.batch_align import batch_align_jobs
from cpecan_signal_tpu_torch.engine.plan import edge_table
from cpecan_signal_tpu_torch.ops import fb_kernels as fk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _pore(tmp_path, rng):
    return syn.write_pore_model(str(tmp_path / "synthetic.model"), rng)


def _cases(pore, rng, n, W, expansion=20):
    """n synthetic (target, events, window band) triples fitting W lanes."""
    out = []
    while len(out) < n:
        target = "".join(rng.choice(list("ACGT"), int(rng.integers(60, 160))))
        events, path = syn.simulate_events(pore, target, rng)
        n_kmers = len(target) - 5
        band = band_construct(syn.path_anchors(path, n_kmers, len(events), 20),
                              n_kmers, len(events), expansion)
        wb = smooth_band(band, width_multiple=W)
        if wb.W == W:
            out.append((target, events, band, wb))
    return out


@pytest.mark.parametrize("W", [64, 128])
def test_cuda_kernels_match_plain(W, cuda_device, tmp_path):
    rng = np.random.default_rng(W)
    pore = _pore(tmp_path, rng)
    cases = _cases(pore, rng, 5, W)
    Dp = max(wb.n_diagonals for *_x, wb in cases) + 3
    plan, probs = None, []
    for i, (target, events, _band, wb) in enumerate(cases):
        plan, prob = pp.make_sm3_problem(pore, target, events, wb, device=cuda_device,
                                         ragged_left=bool(i % 2), ragged_right=i < 3,
                                         pad_lx=170, pad_ly=200, pad_d=Dp)
        probs.append(prob)
    b = pp.stack_problems(probs)
    edges = pp.to_device(edge_table(plan), cuda_device)
    before = dict(fk.LAUNCHES)
    E = fk.emissions_sm3(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F = fk.forward_sm3(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    p, tot = fk.backward_sm3(edges, plan.match_state, E, F, b.diag_scalars, b.d_last,
                             b.end, b.tp_scalar)
    torch.cuda.synchronize()
    assert all(fk.LAUNCHES[k] == before[k] + 1 for k in before)
    E_ref = fk.emissions_sm3_ref(b.x0, b.yr0, b.xarr, b.evr, W, Dp)
    F_ref = fk.forward_sm3_ref(edges, E, b.diag_scalars, b.d_last, b.start, b.tp_scalar)
    p_ref, tot_ref = fk.backward_sm3_ref(edges, plan.match_state, E, F, b.diag_scalars,
                                         b.d_last, b.end, b.tp_scalar)
    torch.testing.assert_close(E, E_ref, rtol=1e-6, atol=0)
    torch.testing.assert_close(F, F_ref, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(p, p_ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(tot, tot_ref, rtol=1e-5, atol=1e-3)
    assert float(p.sum()) > 0.25 * float(b.d_last.sum())


def test_cuda_wrappers_reject_bad_input(cuda_device):
    """Wrong dtypes and mixed devices raise before any launch."""
    x0 = torch.zeros((1, 9), dtype=torch.int64, device=cuda_device)
    xarr = torch.zeros((1, 13, 512), device=cuda_device)
    evr = torch.zeros((1, 2, 512), device=cuda_device)
    before = dict(fk.LAUNCHES)
    with pytest.raises(TypeError):
        fk.emissions_sm3(x0, x0, xarr, evr, 64, 8)
    with pytest.raises(ValueError, match="different devices"):
        fk.emissions_sm3(x0.int(), x0.int().cpu(), xarr, evr, 64, 8)
    with pytest.raises(ValueError, match="multiple of 32"):
        fk.emissions_sm3(x0.int(), x0.int(), xarr, evr, 48, 8)
    assert fk.LAUNCHES == before


def test_cuda_slice_matches_cpu(cuda_device, tmp_path):
    """batch_align_jobs on the card (kernels) against the CPU (plain
    versions) on the same synthetic split jobs, ragged ends mixed."""
    rng = np.random.default_rng(7)
    pore = _pore(tmp_path, rng)
    jobs = [SplitJob(make_signal_sm3(pore, t, e), band, 0, 0, bool(i % 2), i < 4)
            for i, (t, e, band, _wb) in enumerate(_cases(pore, rng, 8, 64, expansion=6))]
    before = fk.LAUNCHES["backward"]
    got = batch_align_jobs(jobs, AlignmentParams().threshold, device=cuda_device)
    assert fk.LAUNCHES["backward"] > before
    want = batch_align_jobs(jobs, AlignmentParams().threshold, device=torch.device("cpu"))
    for g, w in zip(got, want):
        dg = {(x, y): q for q, x, y in g.as_tuples()}
        dw = {(x, y): q for q, x, y in w.as_tuples()}
        common = set(dg) & set(dw)
        assert len(common) >= max(len(dg), len(dw), 1) - 1
        assert all(abs(dg[k] - dw[k]) < 1.2e-3 * 1e7 for k in common)
