"""Launch configuration of the port's recursion and epilogue kernels
(ops/fb_kernels.ring_depth, epilogue_warps, backward_work_floats, the
mirror of csrc/fb_sm3.cu's sizing) at every plan the port runs and every
window width it takes: each must fit the 227 KB of shared memory a block may
use, stage the E rows in a ring of at least 3 slots or, where not even 3
rows fit beside the carry rows, take the unstaged route (E read from device
memory), and give the epilogue at least one warp."""

import numpy as np
import pytest

from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.engine.pipeline import _plan_channels
from cpecan_signal_tpu_torch.models import state_machines as sms
from cpecan_signal_tpu_torch.ops import fb_kernels as fk

BLOCK_SMEM = 232448          # the H100's shared memory per block (227 KB)
STATIC_SMEM = 4096           # room kept for the kernels' static arrays
WIDTHS = list(range(32, 1025, 32))


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """{machine: (S, C, n_edges)} of every machine the port aligns or trains."""
    rng = np.random.default_rng(3)
    pore = syn.write_pore_model(str(tmp_path_factory.mktemp("m") / "synthetic.model"), rng)
    target = "".join(rng.choice(list("ACGT"), 40))
    events, _path = syn.simulate_events(pore, target, rng)
    sm5 = sms.make_symbol_sm5()
    sms.bind_symbol_sequences(sm5, "ACGTACGTAC", "ACGTACGTA")
    machines = {"threeState": sms.make_signal_sm3(pore, target, events),
                "fourState": sms.make_signal_sm4(pore, target, events),
                "vanilla": sms.make_signal_vanilla(pore, target, events, "template"),
                "echelon": sms.make_signal_echelon(pore, target, events, "template"),
                "fiveState": sm5}
    out = {}
    for name, sm in machines.items():
        plan, C = _plan_channels(sm)
        out[name] = (plan.n_states, C, len(plan.edges))
    return out


@pytest.mark.parametrize("name", ["threeState", "fourState", "vanilla", "echelon",
                                  "fiveState"])
def test_recursion_ring_fits(name, plans):
    S, C, _n = plans[name]
    unstaged = []
    for W in WIDTHS:
        K, smem = fk.ring_depth(S, C, W)
        carry = (4 * S * (W + 2) + 3) // 4 * 16
        row = C * W * 4 + 32
        assert carry % 16 == 0 and smem == carry + K * row
        assert smem + STATIC_SMEM <= BLOCK_SMEM
        if K == 0:
            # the unstaged route only where 3 rows do not fit
            assert carry + 3 * row > BLOCK_SMEM - STATIC_SMEM
            unstaged.append(W)
        else:
            assert 3 <= K <= fk.RING_MAX
            assert K == fk.RING_MAX or carry + (K + 1) * row > BLOCK_SMEM - STATIC_SMEM
    # every plan but echelon (17 channels, 7 states) stages every width
    if name == "echelon":
        assert unstaged == [W for W in WIDTHS if W >= 736]
    else:
        assert unstaged == []


@pytest.mark.parametrize("name", ["threeState", "fourState", "vanilla", "echelon",
                                  "fiveState"])
@pytest.mark.parametrize("em", [False, True])
def test_epilogue_block_fits(name, em, plans):
    S, _C, n_edges = plans[name]
    for W in WIDTHS:
        n, smem = fk.epilogue_warps(S, W, n_edges, em)
        per = (2 * S * W + (32 * n_edges if em else 0)) * 4
        assert 1 <= n <= fk.EPI_WARPS and smem == n * per
        assert smem + STATIC_SMEM <= BLOCK_SMEM
        assert n == fk.EPI_WARPS or (n + 1) * per > BLOCK_SMEM - STATIC_SMEM


def test_backward_workspace_floats():
    # offB (f64, 2 floats a diagonal), b, then at stage 4 the window-group
    # sums and the per-edge lane sums
    assert fk.backward_work_floats(64, 4096, 3, 128) == 64 * 4096 * (2 + 3 * 128)
    assert fk.backward_work_floats(2, 10, 5, 64, 1, 13) == 2 * 10 * (2 + 5 * 64 + 64 + 13)
