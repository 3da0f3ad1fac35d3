"""PyTorch port: the f64 oracle and what stands on it, on the CPU against the
JAX package (f64, as tests/conftest.py enables it).

The same numpy-seeded inputs (one state machine object, built by the JAX
package's factories: the engines read only its fields) go through the JAX
function and its port:

  * ops/logmath and ops/pdfs, elementwise: within 1e-12;
  * engine/fb: F, B and the per-diagonal totals (log values) within atol
    1e-9, posteriors within 1e-9, for the threeState signal, fiveState
    symbol, vanilla, echelon (multi_match), fourState and threeStateHdp
    machines, ragged and not, with trailing padded diagonals; the
    reference's cubic logAdd (``logadd="lookup"``); and the brute-force
    full-matrix oracle (tests/oracle.py) at full band, as
    tests/test_engine_random.py holds the JAX engine;
  * engine/expectations, each kind, and em/expectation_driver, each
    function: tallies within rtol 1e-9 (HDP assignments equal, in order,
    at a threshold and at 0);
  * engine/align: align_events_to_target (threeState; echelon's
    multi_match) and align_sequence_pair: pairs equal, but where a
    posterior lies within 1e-9 of the threshold;
  * engine/window's scan half against JAX's engine/window.py at f64 (and
    f32 within 1e-3 of it).
"""

import numpy as np
import pytest
import torch

from cpecan_signal_tpu.core.band import band_construct
from cpecan_signal_tpu.core.window import smooth_band
from cpecan_signal_tpu.em import expectation_driver as jdrv
from cpecan_signal_tpu.engine import align as jalign
from cpecan_signal_tpu.engine import expectations as jexp
from cpecan_signal_tpu.engine import fb as jfb
from cpecan_signal_tpu.engine import window as jwin
from cpecan_signal_tpu.models import state_machines as jsm
from cpecan_signal_tpu.models.params import AlignmentParams as JParams
from cpecan_signal_tpu.ops import logmath as jlog
from cpecan_signal_tpu.ops import pdfs as jpdfs
from cpecan_signal_tpu_torch.constants import PAIR_ALIGNMENT_PROB_1
from cpecan_signal_tpu_torch.em import expectation_driver as tdrv
from cpecan_signal_tpu_torch.engine import align as talign
from cpecan_signal_tpu_torch.engine import expectations as texp
from cpecan_signal_tpu_torch.engine import fb as tfb
from cpecan_signal_tpu_torch.engine import window as twin
from cpecan_signal_tpu_torch.engine.plan import plan_from
from cpecan_signal_tpu_torch.models.params import AlignmentParams
from cpecan_signal_tpu_torch.ops import logmath as tlog
from cpecan_signal_tpu_torch.ops import pdfs as tpdfs
from oracle import full_backward, full_forward, total_prob
from test_engine_random import evolve, random_anchors, random_seq, synthetic_pore_model

CPU = torch.device("cpu")
LOG_ATOL = 1e-9      # F, B, totals (log values)
P_ATOL = 1e-9        # posteriors
TALLY_RTOL = 1e-9    # E-step tallies
MACHINES = ("threeState", "fiveState", "vanilla", "echelon", "fourState", "threeStateHdp")


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_log(got, want, atol=LOG_ATOL):
    """Log values: the same cells -inf, the finite ones within atol."""
    got, want = _np(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


def _density(ranks, means):
    """A raw HDP density (the reference adds it, not its log, into the
    recursion) peaked at a rank-dependent level."""
    level = 40.0 + (np.asarray(ranks) % 97) * 0.5
    return 0.4 * np.exp(-0.5 * ((np.asarray(means) - level) / 6.0) ** 2)


def _machine(name, rng, n=40):
    """(machine, lX, lY, anchors) of a random problem of about ``n`` x
    positions."""
    if name == "fiveState":
        sx = random_seq(rng, n)
        sy = evolve(rng, sx)
        sm = jsm.make_symbol_sm5()
        jsm.bind_symbol_sequences(sm, sx, sy)
        lX, lY = len(sx), len(sy)
    else:
        pore = synthetic_pore_model(rng)
        target = random_seq(rng, n + 5)
        lX, lY = n, int(n * rng.uniform(0.9, 1.3))
        events = np.stack([rng.uniform(40, 90, lY), rng.uniform(1, 3, lY),
                           rng.uniform(0.001, 0.1, lY)], axis=1)
        make = {"threeState": lambda: jsm.make_signal_sm3(pore, target, events),
                "fourState": lambda: jsm.make_signal_sm4(pore, target, events),
                "vanilla": lambda: jsm.make_signal_vanilla(pore, target, events, "template"),
                "echelon": lambda: jsm.make_signal_echelon(pore, target, events, "complement"),
                "threeStateHdp": lambda: jsm.make_signal_sm3_hdp(_density, target, events)}
        sm = make[name]()
    return sm, lX, lY, random_anchors(rng, lX, lY)


def _both(sm, band, rl, rr, pad=0):
    jp, ji = jfb.prepare_inputs(sm, band, ragged_left=rl, ragged_right=rr,
                                pad_diagonals=band.n_diagonals + pad)
    tp, ti = tfb.prepare_inputs(sm, band, ragged_left=rl, ragged_right=rr, device=CPU,
                                pad_diagonals=band.n_diagonals + pad)
    assert plan_from(jp) == tp
    return jp, ji, tp, ti


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _pdf_args(rng, n=500):
    u = lambda lo, hi: rng.uniform(lo, hi, n)   # noqa: E731
    zero_some = lambda a: np.where(rng.random(n) < 0.1, 0.0, a)   # noqa: E731
    return {
        "log_gauss_pdf": (u(30, 90), u(30, 90), zero_some(u(0.2, 3))),
        "log_inv_gauss_pdf": (zero_some(u(0.2, 4)), zero_some(u(0.5, 3)),
                              zero_some(u(-1, 10))),
        "log_bivariate_gauss_pdf": (u(30, 90), u(0.5, 3), u(30, 90), zero_some(u(0.2, 3)),
                                    u(0.5, 3), zero_some(u(0.1, 1)), u(-0.9, 0.9)),
    }


@pytest.mark.parametrize("fn", ["logaddexp", "logadd_lookup", "log_gauss_pdf",
                                "log_inv_gauss_pdf", "log_bivariate_gauss_pdf",
                                "poisson_posterior_logp"])
def test_ops_match_jax(fn):
    rng = np.random.default_rng(1)
    if fn in ("logaddexp", "logadd_lookup"):
        x = rng.uniform(-40, 5, 2000)
        y = x + rng.uniform(-10, 10, 2000)      # every cubic segment and the cutoff
        x[::7] = -np.inf
        y[::11] = -np.inf
        cases = [(x, y), (y, x)]
        mods = (jlog, tlog)
    elif fn == "poisson_posterior_logp":
        d = np.where(rng.random(300) < 0.1, 0.0, rng.uniform(0.0005, 0.05, 300))
        cases = [(n, d) for n in range(6)]
        mods = (jpdfs, tpdfs)
    else:
        cases = [_pdf_args(rng)[fn]]
        mods = (jpdfs, tpdfs)
    for args in cases:
        want = np.asarray(getattr(mods[0], fn)(*args))
        got = getattr(mods[1], fn)(*(a if np.isscalar(a) else torch.as_tensor(a)
                                     for a in args))
        _close_log(got, want, atol=1e-12)
    assert tlog.get_logadd("lookup") is tlog.logadd_lookup
    with pytest.raises(ValueError):
        tlog.get_logadd("cubic")


# ---------------------------------------------------------------------------
# engine/fb
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("machine", MACHINES)
def test_oracle_matches_jax(machine):
    """F, B, totals and posteriors (per diagonal and final; echelon's per
    match state) on a random anchored band, ragged and not, with 3 trailing
    padded diagonals."""
    rng = np.random.default_rng(MACHINES.index(machine) + 20)
    sm, lX, lY, anchors = _machine(machine, rng)
    band = band_construct(anchors, lX, lY, 4)
    for rl, rr, pad in ((True, True, 3), (False, False, 0)):
        jp, ji, tp, ti = _both(sm, band, rl, rr, pad)
        F, B = jfb.forward(jp, ji), jfb.backward(jp, ji)
        tF, tB = tfb.forward(tp, ti), tfb.backward(tp, ti)
        assert tF.shape == F.shape and tF.dtype == torch.float64
        _close_log(tF, F)
        _close_log(tB, B)
        _close_log(tfb.diagonal_totals(tp, ti, tF, tB), jfb.diagonal_totals(jp, ji, F, B))
        for mode in ("per_diagonal", "final"):
            p, tot = tfb.posterior_match_probs(tp, ti, tF, tB, mode)
            wp, wtot = jfb.posterior_match_probs(jp, ji, F, B, mode)
            np.testing.assert_allclose(_np(p), np.asarray(wp), rtol=0, atol=P_ATOL)
            _close_log(tot, wtot)
        if machine == "echelon":
            p, _ = tfb.posterior_multi_match_probs(tp, ti, tF, tB)
            wp, _ = jfb.posterior_multi_match_probs(jp, ji, F, B)
            np.testing.assert_allclose(_np(p), np.asarray(wp), rtol=0, atol=P_ATOL)
            x, y = np.asarray(ji.x), np.asarray(ji.y)
            got = tfb.extract_multi_pairs(_np(p), x, y, 0.01)
            want = jfb.extract_multi_pairs(np.asarray(wp), x, y, 0.01)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_oracle_lookup_logadd_matches_jax():
    """The reference's cubic logAdd, folded over each state's edges in plan
    order as the JAX scan folds them."""
    from dataclasses import replace

    rng = np.random.default_rng(3)
    for machine in ("threeState", "fiveState"):
        sm, lX, lY, anchors = _machine(machine, rng)
        band = band_construct(anchors, lX, lY, 4)
        jp, ji, tp, ti = _both(sm, band, True, True)
        jp, tp = replace(jp, logadd="lookup"), replace(tp, logadd="lookup")
        F, B = jfb.forward(jp, ji), jfb.backward(jp, ji)
        _close_log(tfb.forward(tp, ti), F)
        _close_log(tfb.backward(tp, ti), B)


@pytest.mark.parametrize("case", ["sm5-0", "sm5-1", "sm3-7", "sm3-8"])
def test_full_band_matches_brute_force_oracle(case):
    """tests/test_engine_random.py's brute-force checks at full band, on the
    port's oracle."""
    kind, seed = case.split("-")
    rng = np.random.default_rng(int(seed))
    if kind == "sm5":
        sx = random_seq(rng, rng.integers(3, 25))
        sy = evolve(rng, sx)
        sm = jsm.make_symbol_sm5()
        jsm.bind_symbol_sequences(sm, sx, sy)
        lX, lY, rl, rr = len(sx), len(sy), False, False
    else:
        pore = synthetic_pore_model(rng)
        n_bases = int(rng.integers(8, 25))
        target = random_seq(rng, n_bases)
        lX, lY = n_bases - 5, int(rng.integers(3, 20))
        events = np.stack([rng.uniform(40, 90, lY), rng.uniform(1, 3, lY),
                           rng.uniform(0.001, 0.1, lY)], axis=1)
        sm = jsm.make_signal_sm3(pore, target, events)
        rl = rr = True
    Fo = full_forward(sm, lX, lY, ragged_left=rl)
    Bo = full_backward(sm, lX, lY, ragged_right=rr)
    tf = total_prob(sm, Fo, ragged_right=rr)
    band = band_construct([], lX, lY, 2)
    plan, inp = tfb.prepare_inputs(sm, band, ragged_left=rl, ragged_right=rr, device=CPU)
    F, B = tfb.forward(plan, inp), tfb.backward(plan, inp)
    Fn, Bn = _np(F), _np(B)
    x, y, valid = _np(inp.x), _np(inp.y), _np(inp.valid)
    for d in range(band.n_diagonals):
        for k in np.where(valid[d])[0]:
            np.testing.assert_allclose(Fn[d, k], Fo[x[d, k], y[d, k]], atol=1e-8)
            np.testing.assert_allclose(Bn[d, k], Bo[x[d, k], y[d, k]], atol=1e-8)
    np.testing.assert_allclose(_np(tfb.diagonal_totals(plan, inp, F, B)), tf, atol=1e-6)


# ---------------------------------------------------------------------------
# engine/expectations and em/expectation_driver
# ---------------------------------------------------------------------------

def _close_tallies(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=TALLY_RTOL, atol=1e-300)


@pytest.mark.parametrize("kind", ["transition", "threestate", "discrete", "vanilla", "hdp",
                                  "hdp-threshold-0"])
def test_expectations_match_jax(kind):
    machine = {"transition": "fourState", "threestate": "threeState",
               "discrete": "fiveState", "vanilla": "vanilla"}.get(kind, "threeStateHdp")
    rng = np.random.default_rng(40 + len(kind))
    sm, lX, lY, anchors = _machine(machine, rng)
    band = band_construct(anchors, lX, lY, 4)
    jp, ji, tp, ti = _both(sm, band, True, True)
    F, B = jfb.forward(jp, ji), jfb.backward(jp, ji)
    tF, tB = tfb.forward(tp, ti), tfb.backward(tp, ti)
    if kind.startswith("hdp"):
        threshold = 0.0 if kind.endswith("0") else 0.01
        got = texp.hdp_expectations(tp, ti, tF, tB, threshold)
        want = jexp.hdp_expectations(jp, ji, F, B, threshold)
        _close_tallies(got[:2], want[:2])
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert _np(got[2]).all() == (threshold == 0.0)
        return
    fn = {"transition": "transition_expectations", "threestate": "threestate_expectations",
          "discrete": "discrete_expectations", "vanilla": "vanilla_expectations"}[kind]
    got = getattr(texp, fn)(tp, ti, tF, tB)
    want = getattr(jexp, fn)(jp, ji, F, B)
    assert len(got) == len(want)
    _close_tallies(got, want)
    assert float(_np(got[0]).sum()) > 1.0
    if kind == "transition":    # the per-edge posterior grids themselves
        totals = jfb.diagonal_totals(jp, ji, F, B)
        for (ge, gp), (we, wp) in zip(texp._edge_posteriors(tp, ti, tF, tB,
                                                            torch.tensor(np.asarray(totals))),
                                      jexp._edge_posteriors(jp, ji, F, B, totals)):
            assert (ge.src, ge.frm, ge.to) == (we.src, we.frm, we.to)
            np.testing.assert_allclose(_np(gp), np.asarray(wp), rtol=0, atol=P_ATOL)


def _signal_case(rng, n_bases=70):
    pore = synthetic_pore_model(rng)
    target = random_seq(rng, n_bases)
    lX = n_bases - 5
    lY = int(lX * 1.2)
    events = np.stack([rng.uniform(40, 90, lY), rng.uniform(1, 3, lY),
                       rng.uniform(0.001, 0.1, lY)], axis=1)
    return pore, target, events, random_anchors(rng, lX, lY)


@pytest.mark.parametrize("driver", ["sm3_expectations", "vanilla_expectations",
                                    "hdp_expectations", "discrete_expectations"])
def test_expectation_driver_matches_jax(driver):
    """Each driver over a problem split at an anchor gap: tallies within
    rtol 1e-9; HDP assignments equal."""
    rng = np.random.default_rng(7)
    jparams = JParams(split_matrix_bigger_than_this=15 * 15, diagonal_expansion=4)
    tparams = AlignmentParams(split_matrix_bigger_than_this=15 * 15, diagonal_expansion=4)

    def gapped(anchors, lX):
        return anchors[(anchors[:, 0] < lX // 3) | (anchors[:, 0] > 2 * lX // 3)]
    if driver == "discrete_expectations":
        sx = random_seq(rng, 120)
        sy = evolve(rng, sx)
        anchors = gapped(random_anchors(rng, len(sx), len(sy)), len(sx))

        def make_sm(a, b):
            sm = jsm.make_symbol_sm5()
            jsm.bind_symbol_sequences(sm, a, b)
            return sm
        args = (make_sm, sx, sy, anchors)
    else:
        pore, target, events, anchors = _signal_case(rng)
        make_sm = {"sm3_expectations": lambda t, e: jsm.make_signal_sm3(pore, t, e),
                   "vanilla_expectations": lambda t, e: jsm.make_signal_vanilla(pore, t, e),
                   "hdp_expectations": lambda t, e: jsm.make_signal_sm3_hdp(_density, t, e)
                   }[driver]
        args = (make_sm, target, events, gapped(anchors, len(target) - 5))
    extra = (0.01,) if driver == "hdp_expectations" else ()
    got = getattr(tdrv, driver)(*args, tparams, *extra, device=CPU)
    want = getattr(jdrv, driver)(*args, jparams, *extra)
    lX = len(args[1]) - (0 if driver.startswith("d") else 5)
    n_splits = len(list(talign.split_windows(lX, len(args[2]), args[3], tparams, True, True)))
    assert n_splits > 1
    for field in ("transitions", "kmer_gap", "bins", "emissions"):
        if hasattr(want, field):
            np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                       rtol=TALLY_RTOL, atol=1e-300)
    assert got.likelihood == pytest.approx(want.likelihood, rel=TALLY_RTOL)
    if driver == "hdp_expectations":
        assert got.kmer_assignments == want.kmer_assignments
        assert got.event_assignments == want.event_assignments
        assert got.n_assignments > 10


# ---------------------------------------------------------------------------
# engine/align
# ---------------------------------------------------------------------------

def _assert_pairs(got, want, threshold):
    """Pairs equal, but for pairs whose posterior lies within 1e-9 of the
    threshold (one quantum of the int(p * 1e7) posteriors beside it)."""
    g, w = set(got.as_tuples()), set(want.as_tuples())
    assert len(g) > 20
    for p, _x, _y in g ^ w:
        assert abs(p / PAIR_ALIGNMENT_PROB_1 - threshold) <= 1e-9 + 1.0 / PAIR_ALIGNMENT_PROB_1


@pytest.mark.parametrize("route", ["threeState", "echelon", "sequence_pair"])
def test_align_matches_jax(route):
    rng = np.random.default_rng(17)
    jparams = JParams(split_matrix_bigger_than_this=50 * 50, diagonal_expansion=6)
    tparams = AlignmentParams(split_matrix_bigger_than_this=50 * 50, diagonal_expansion=6)
    if route == "sequence_pair":
        sx = random_seq(rng, 150)
        sy = evolve(rng, sx, subst=0.05, indel=0.02)
        anchors = random_anchors(rng, len(sx), len(sy))[::4]

        def make_sm(a, b):
            sm = jsm.make_symbol_sm5()
            jsm.bind_symbol_sequences(sm, a, b)
            return sm
        got = talign.align_sequence_pair(make_sm, sx, sy, anchors, tparams, device=CPU)
        want = jalign.align_sequence_pair(make_sm, sx, sy, anchors, jparams)
    else:
        pore, target, events, anchors = _signal_case(rng, 90)
        ranks_lvl = pore.match_model[:4096, 0]
        from cpecan_signal_tpu.core.kmers import sequence_kmer_ranks
        r = sequence_kmer_ranks(target)
        events = np.stack([ranks_lvl[r] + rng.normal(0, 0.5, len(r)), np.full(len(r), 2.0),
                           np.full(len(r), 0.01)], axis=1)
        anchors = np.stack([np.arange(2, len(r), 7), np.arange(2, len(r), 7)], axis=1)
        make = jsm.make_signal_sm3 if route == "threeState" else (
            lambda p, t, e: jsm.make_signal_echelon(p, t, e, "template"))
        kw = dict(multi_match=route == "echelon")
        got = talign.align_events_to_target(lambda t, e: make(pore, t, e), target, events,
                                            anchors, tparams, device=CPU, **kw)
        want = jalign.align_events_to_target(lambda t, e: make(pore, t, e), target, events,
                                             anchors, jparams, **kw)
    _assert_pairs(got, want, tparams.threshold)
    assert got.score == pytest.approx(want.score, rel=1e-9)


# ---------------------------------------------------------------------------
# engine/window: the scan half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("machine", ["threeState", "fiveState"])
def test_window_scan_matches_jax(machine):
    """F, B, totals, posteriors and the threeState tallies of the window
    layout against JAX's engine/window.py at f64; the f32 run within 1e-3
    of the f64 one."""
    rng = np.random.default_rng(9)
    sm, lX, lY, anchors = _machine(machine, rng, n=60)
    wb = smooth_band(band_construct(anchors, lX, lY, 6), width_multiple=16)
    jp, ji = jwin.prepare_window_inputs(sm, wb, ragged_left=True, ragged_right=False)
    tp, ti = twin.window_scan_inputs(sm, wb, ragged_left=True, ragged_right=False,
                                     device=CPU)
    F, B = jwin.forward(jp, ji), jwin.backward(jp, ji)
    tF, tB = twin.forward(tp, ti), twin.backward(tp, ti)
    _close_log(tF, F)
    _close_log(tB, B)
    _close_log(twin.diagonal_totals(tp, ti, tF, tB), jwin.diagonal_totals(jp, ji, F, B))
    p, _ = twin.posterior_match_probs(tp, ti, tF, tB)
    wp, _ = jwin.posterior_match_probs(jp, ji, F, B)
    np.testing.assert_allclose(_np(p), np.asarray(wp), rtol=0, atol=P_ATOL)
    if machine == "threeState":
        _close_tallies(twin.threestate_expectations(tp, ti, tF, tB),
                       jwin.threestate_expectations(jp, ji, F, B))
    tp32, ti32 = twin.window_scan_inputs(sm, wb, ragged_left=True, ragged_right=False,
                                         device=CPU, dtype=torch.float32)
    F32, B32 = twin.forward(tp32, ti32), twin.backward(tp32, ti32)
    p32, _ = twin.posterior_match_probs(tp32, ti32, F32, B32)
    assert p32.dtype == torch.float32
    np.testing.assert_allclose(_np(p32), _np(p), rtol=0, atol=1e-3)


@pytest.mark.parametrize("sm_type", ["threeState", "echelon"])
def test_align_read_serial_matches_jax(sm_type, tmp_path):
    """vanilla_align.align_read(device_batch=False), each strand through the
    oracle (echelon with its per-state posteriors), against the JAX CLI's
    serial route on one synthetic npRead: the same pairs, strand by strand,
    and the same TSV."""
    from cpecan_signal_tpu.cli import vanilla_align as jva
    from cpecan_signal_tpu.io.npread import load_npread as jload
    from cpecan_signal_tpu.models.params import cli_defaults as jdefaults
    from cpecan_signal_tpu.models.pore_model import load_pore_model as jpore
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.cli import vanilla_align as tva
    from cpecan_signal_tpu_torch.io.npread import load_npread as tload
    from cpecan_signal_tpu_torch.models.params import cli_defaults as tdefaults
    from cpecan_signal_tpu_torch.models.pore_model import load_pore_model as tpore

    rng = np.random.default_rng(23)
    model = str(tmp_path / "synthetic.model")
    syn.write_pore_model(model, rng)
    ref_seq = syn.write_reference(str(tmp_path / "ref.fa"), 2000, rng)
    (path,) = syn.write_read_set(str(tmp_path / "reads"), ref_seq, tpore(model), 1, rng,
                                 min_bases=120, max_bases=160)
    out = {}
    for name, mod, load, pore, params, kw in (
            ("port", tva, tload, tpore, tdefaults(), dict(device=CPU)),
            ("jax", jva, jload, jpore, jdefaults(), {})):
        tsv = tmp_path / f"{name}.tsv"
        with open(tsv, "w") as fh:
            res = mod.align_read(ref_seq, "ref", load(path), pore(model), pore(model), params,
                                 sm_type, read_label="r", out_fh=fh, device_batch=False, **kw)
        out[name] = (res, tsv.read_text())
    (got, got_tsv), (want, want_tsv) = out["port"], out["jax"]
    assert got["status"] == want["status"] == "ok"
    for strand in "tc":
        assert got[strand].as_tuples() == want[strand].as_tuples()
        assert len(got[strand].probs) > 20
    assert got_tsv == want_tsv
