"""The banded forward-backward kernels of the threeState path.

Each public function dispatches on the device of its tensors:

  * CPU tensors go to the plain PyTorch version beside it (``*_ref``), which
    is how the tests run on a machine without a card;
  * CUDA tensors go to the hand-written kernel in ``csrc/fb_sm3.cu`` (built
    and bound by ``ops/_build.py``), or the call raises.  There is no
    fallback from a CUDA tensor to the plain version or to the CPU.

Inputs keep the JAX package's layouts (ops/pallas_fb.py) at nh = 1:
``x0``/``yr0`` (B, Dp+1) int32, ``xarr`` (B, 13, lXp), ``evr`` (B, 2, lYp),
``diag_scalars`` (B, Dp+1, 1, 8) int32, ``d_last`` (B,), ``start``/``end``
(B, S), ``tp_scalar`` (B, n) f32.  Outputs drop the TPU halo and padding:
E (B, Dp+2, 3, W), F (B, Dp, S, W), p (B, Dp, W), totals (B, Dp), and at
stage 4 (the EM tallies) exits (B, Dp, G), gacc (B, G, W), stats (B, 128).
With ``pstates`` (the echelon posteriors, stage 3) or ``pgroups`` (the
per-edge-group posterior sums, stage 4) p is (B, Dp, P, W).

``LAUNCHES`` counts kernel launches per kernel (plain-version calls do not
count), so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.state_machines import SRC_MIDDLE
from ..engine.plan import EDGE_COLS, MAX_EDGE_IDS

NEG_INF = -1e30  # finite stand-in for log(0): keeps f32 arithmetic NaN-free
_LOG_UNDERFLOW = 7.5
N_XPARAMS = 13   # rows of the per-x parameter pack (see emissions_sm3)
DS_FL, DS_FM, DS_BL, DS_BM, DS_W0, DS_XMYL, DS_XMYR, DS_XS = range(8)
MAX_STATES = 8   # csrc/fb_sm3.cu MAX_S
MAX_EDGES = 64   # csrc/fb_sm3.cu MAX_EDGES; edge e tallies in stats lane e < LIK_LANE
MAX_GROUPS = 4   # csrc/fb_sm3.cu MAX_G: windowed tally groups at stage 4
MASK_BITS = 32   # a stage-4 group is a 32-bit edge mask: its edges are < 32
STATS_LANES = 128
LIK_LANE = 64    # stats lane of the likelihood (lanes < 64: per-edge tallies)

LAUNCHES = {"emissions": 0, "forward": 0, "backward": 0, "backward_em": 0,
            "backward_pstates": 0, "backward_pgroups": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

# the logAdd lookup's 4 cubic pieces: d <= 1, <= 2.5, <= 4.5, above; each
# ((a d + b) d + c) d + e with its coefficients rounded to f32
_LADD_BOUNDS = (1.0, 2.5, 4.5)
_LADD_PIECES = ((-0.009350833524763, 0.130659527668286, 0.498799810682272, 0.693203116424741),
                (-0.014532321752540, 0.139942324101744, 0.495635523139337, 0.692140569840976),
                (-0.004605031767994, 0.063427417320019, 0.695956496475118, 0.514272634594009),
                (-0.000458661602210, 0.009695946122598, 0.930734667215156, 0.168037164329057))


@functools.cache
def _ladd_pieces(device: torch.device) -> torch.Tensor:
    return torch.tensor(_LADD_PIECES, dtype=torch.float32, device=device)


def ladd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reference logAdd (pairwiseAligner.c:238-255): lo + lookup(hi - lo)
    with lookup(d) ~= log(exp(d) + 1) as a 4-piece cubic, truncated to hi
    for d >= 7.5 and saturated at NEG_INF (ops/pallas_fb._ladd).  Each cell
    evaluates only its own piece (f32 coefficients, the same rounded
    operations as evaluating all four and selecting)."""
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = torch.clamp_max(hi - lo, _LOG_UNDERFLOW)
    # each cell's piece, by comparisons against the pieces' bounds
    piece = (d > _LADD_BOUNDS[0]).long() + (d > _LADD_BOUNDS[1]) + (d > _LADD_BOUNDS[2])
    c = _ladd_pieces(d.device)[piece].unbind(-1)
    lut = ((c[0] * d + c[1]) * d + c[2]) * d + c[3]
    out = torch.where(d >= _LOG_UNDERFLOW, hi, lo + lut)
    return torch.clamp_min(out, NEG_INF)


def _shift(v: torch.Tensor, s: torch.Tensor, fill: float = NEG_INF) -> torch.Tensor:
    """out[b, ..., j] = v[b, ..., j + sign(s[b])]; lanes shifted in from
    outside the window get ``fill``."""
    pad = torch.full(v.shape[:-1] + (1,), fill, dtype=v.dtype, device=v.device)
    up = torch.cat([v[..., 1:], pad], dim=-1)
    down = torch.cat([pad, v[..., :-1]], dim=-1)
    s = s.reshape((-1,) + (1,) * (v.dim() - 1))
    return torch.where(s == 0, v, torch.where(s > 0, up, down))


def _edge_rows(edges: torch.Tensor) -> list[tuple]:
    """Edge table -> [(src, frm, to, channels, scalar ids)] (engine/plan)."""
    rows = []
    for r in edges.tolist():
        chans = (r[3],) + tuple(c for c in r[4 + MAX_EDGE_IDS:] if c >= 0)
        scal = tuple(i for i in r[4:4 + MAX_EDGE_IDS] if i >= 0)
        rows.append((r[0], r[1], r[2], chans, scal))
    return rows


def _esum(Ed, chans):
    """Sum of an edge's E channels (B, W), emission class first."""
    es = Ed[:, chans[0]]
    for ch in chans[1:]:
        es = es + Ed[:, ch]
    return es


def _add_tp(val, tps, scal):
    """val + the sum of the edge's scalar transition terms (none: val)."""
    if not scal:
        return val
    t = tps[:, scal[0]:scal[0] + 1]
    for i in scal[1:]:
        t = t + tps[:, i:i + 1]
    return val + t


def emissions_sm3_ref(x0, yr0, xarr, evr, W: int, Dp: int) -> torch.Tensor:
    """Plain version of ``emissions_sm3``."""
    B, _, lXp = xarr.shape
    lYp = evr.shape[2]
    lane = torch.arange(W, device=xarr.device)
    xi = (x0[:, :Dp, None].long() + lane).clamp(0, lXp - 1).reshape(B, -1)
    yi = (yr0[:, :Dp, None].long() + lane).clamp(0, lYp - 1).reshape(B, -1)

    def xrow(r):
        return torch.gather(xarr[:, r], 1, xi).reshape(B, Dp, W)

    mean = torch.gather(evr[:, 0], 1, yi).reshape(B, Dp, W)
    noise = torch.gather(evr[:, 1], 1, yi).reshape(B, Dp, W)

    def gauss(base, obs):
        a = (obs - xrow(base)) * xrow(base + 1)
        return torch.clamp_min(xrow(base + 2) - 0.5 * a * a, NEG_INF)

    E = torch.zeros((B, Dp + 2, 3, W), dtype=torch.float32, device=xarr.device)
    E[:, :Dp, 0] = xrow(12)
    E[:, :Dp, 1] = torch.clamp_min(gauss(0, mean) + gauss(3, noise), NEG_INF)
    E[:, :Dp, 2] = torch.clamp_min(gauss(6, mean) + gauss(9, noise), NEG_INF)
    return E


def _valid(dsd, d, d_last, lane):
    """(B, W) band mask of diagonal d from its (B, 8) scalar rows."""
    xmy = dsd[:, DS_W0:DS_W0 + 1] + 2 * lane
    ok = (xmy >= dsd[:, DS_XMYL:DS_XMYL + 1]) & (xmy <= dsd[:, DS_XMYR:DS_XMYR + 1])
    return ok & (d <= d_last)[:, None], xmy


def forward_sm3_ref(edges, E, diag_scalars, d_last, start, tp_scalar) -> torch.Tensor:
    """Plain version of ``forward_sm3``."""
    B, _De, _C, W = E.shape
    S = start.shape[1]
    Dp = diag_scalars.shape[1] - 1
    dev = E.device
    rows = _edge_rows(edges)
    lane = torch.arange(W, device=dev)
    neg = torch.full((B, S, W), NEG_INF, dtype=torch.float32, device=dev)
    F = torch.empty((B, Dp, S, W), dtype=torch.float32, device=dev)
    f1, f2 = neg, neg
    for d in range(Dp):
        dsd = diag_scalars[:, d, 0, :]
        valid, _xmy = _valid(dsd, d, d_last, lane)
        if d == 0:
            cur = torch.where(valid[:, None, :], start[:, :, None], NEG_INF)
        else:
            sL = dsd[:, DS_FL]
            srcs = (_shift(f1, sL), _shift(f2, dsd[:, DS_FM]), _shift(f1, sL + 1))
            Ed = E[:, d]
            acc = [neg[:, 0]] * S
            for src, frm, to, chans, scal in rows:
                val = _add_tp(srcs[src][:, frm] + _esum(Ed, chans), tp_scalar, scal)
                acc[to] = ladd(acc[to], val)
            cur = torch.where(valid[:, None, :], torch.stack(acc, dim=1), NEG_INF)
        F[:, d] = cur
        f2, f1 = f1, cur
    return F


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the lanes (the last axis, a multiple of 32) in the order of
    the kernels' block reduction (csrc/fb_sm3.cu block_sum2): in each warp
    of 32 lanes a butterfly that adds lane i + o to lane i for o = 16, 8,
    4, 2, 1, then the warps' sums left to right."""
    w = x.reshape(x.shape[:-1] + (-1, 32))
    for o in (16, 8, 4, 2, 1):
        w = w[..., :o] + w[..., o:2 * o]
    out = w[..., 0, 0]
    for i in range(1, w.shape[-2]):
        out = out + w[..., i, 0]
    return out


def _lse_rows(v: torch.Tensor) -> torch.Tensor:
    """logsumexp over (S, W) per problem: v (B, S, W) -> (B,), summed as
    the backward kernel sums it (per lane over the states, then
    ``_block_sum``), so that a total, whose rounding every posterior of
    its diagonal carries, is the kernel's to the bit."""
    S = v.shape[1]
    m_l = v[:, 0]
    for s in range(1, S):
        m_l = torch.maximum(m_l, v[:, s])
    m = m_l.amax(dim=1, keepdim=True)
    sum_l = torch.exp(v[:, 0] - m)
    for s in range(1, S):
        sum_l = sum_l + torch.exp(v[:, s] - m)
    out = m + torch.log(torch.clamp_min(_block_sum(sum_l)[:, None], 1e-38))
    return torch.where(m <= NEG_INF, NEG_INF, out)[:, 0]


def group_masks(wgroups, n_edges: int) -> list[int]:
    """``wgroups`` (G <= MAX_GROUPS tuples of edge indices) -> one int32
    bitmask per group, bit e set when edge e belongs to it (padded with 0 to
    MAX_GROUPS), as the stage-4 kernel takes them."""
    if wgroups is None:
        raise ValueError("stage 4 needs wgroups (engine/pipeline.sm3_wgroups for "
                         "the threeState E-step)")
    if not 1 <= len(wgroups) <= MAX_GROUPS:
        raise ValueError(f"{len(wgroups)} window groups; the kernel takes 1-{MAX_GROUPS}")
    masks = []
    for members in wgroups:
        m = 0
        for e in members:
            if not 0 <= e < n_edges:
                raise ValueError(f"window group edge {e} outside [0, {n_edges})")
            if e >= MASK_BITS:
                raise ValueError(f"window group edge {e}: the stage-4 group masks "
                                 f"are {MASK_BITS}-bit, so group edges must be < {MASK_BITS}")
            m |= 1 << e
        masks.append(m - (1 << 32) if m >= 1 << 31 else m)   # as a C int
    return masks + [0] * (MAX_GROUPS - len(masks))


def pstate_mask(pstates, S: int, stages: int) -> int:
    """``pstates`` (strictly increasing state indices, the echelon matchN
    states) -> the state bitmask the stage-3 kernel takes: channel c of p
    is the c-th set bit."""
    if stages != 3:
        raise ValueError("pstates is the echelon multi-state posterior mode (stage 3)")
    states = list(pstates)
    if not states or any(not 0 <= s < S for s in states) or \
            any(a >= b for a, b in zip(states, states[1:])):
        raise ValueError(f"pstates {states}: strictly increasing states in [0, {S})")
    return sum(1 << s for s in states)


def pgroup_masks(pgroups, n_edges: int, stages: int) -> list[int]:
    """``pgroups`` (1..MAX_STATES tuples of edge indices) -> one 64-bit edge
    bitmask per posterior channel, bit e set when edge e belongs to it, as
    the stage-4 kernel's edge-group mode takes them."""
    if stages != 4:
        raise ValueError("pgroups is a stage-4 (EM) posterior mode")
    if not 1 <= len(pgroups) <= MAX_STATES:
        raise ValueError(f"{len(pgroups)} edge groups; the kernel takes 1-{MAX_STATES}")
    masks = []
    for members in pgroups:
        m = 0
        for e in members:
            if not 0 <= e < n_edges:
                raise ValueError(f"edge group member {e} outside [0, {n_edges})")
            m |= 1 << e
        masks.append(m - (1 << 64) if m >= 1 << 63 else m)   # as a C long long
    return masks


def backward_sm3_ref(edges, match_state: int, E, F, diag_scalars, d_last, end,
                     tp_scalar, stages: int = 3, wgroups=None, pstates=None,
                     pgroups=None):
    """Plain version of ``backward_sm3``.  At stage 4 the EM tallies sum in
    the JAX kernel's order: per diagonal the sum over lanes, then the sum
    over diagonals from the last to the first."""
    B, De, _C, W = E.shape
    S = end.shape[1]
    Dp = F.shape[1]
    dev = E.device
    rows = _edge_rows(edges)
    mid_rows = [r for r in rows if r[0] == SRC_MIDDLE]
    lane = torch.arange(W, device=dev)
    neg = torch.full((B, S, W), NEG_INF, dtype=torch.float32, device=dev)
    if pstates is not None and pgroups is not None:
        raise ValueError("pstates and pgroups are two posterior modes; pass one")
    if pstates is not None:
        pstate_mask(pstates, S, stages)
        P = torch.empty((B, Dp, len(pstates), W), dtype=torch.float32, device=dev)
    elif pgroups is not None:
        pgroup_masks(pgroups, len(rows), stages)
        P = torch.zeros((B, Dp, len(pgroups), W), dtype=torch.float32, device=dev)
    else:
        P = torch.empty((B, Dp, W), dtype=torch.float32, device=dev)
    Pc = P if P.dim() == 4 else P[:, :, None]   # (B, Dp, P, W) view
    T = torch.empty((B, Dp), dtype=torch.float32, device=dev)
    if stages == 4:
        group_masks(wgroups, len(rows))          # the kernel's limits
        G = len(wgroups)
        exits = torch.zeros((B, Dp, G), dtype=torch.float32, device=dev)
        gacc = torch.zeros((B, G, W), dtype=torch.float32, device=dev)
        stats = torch.zeros((B, STATS_LANES), dtype=torch.float32, device=dev)
    elif stages != 3:
        raise ValueError(f"stages={stages}: the port runs stage 3 or 4")
    b1, b2 = neg, neg
    for d in range(Dp - 1, -1, -1):
        dsd = diag_scalars[:, d, 0, :]
        valid, xmy = _valid(dsd, d, d_last, lane)
        E1, E2 = E[:, d + 1], E[:, d + 2]
        sbL, sbM = dsd[:, DS_BL], dsd[:, DS_BM]
        # the sources of each edge kind, shifted once: b[d+1] / E[d+1] by
        # DS_BL (lower) and DS_BL - 1 (upper), b[d+2] / E[d+2] by DS_BM; the
        # E channels shift with a 0.0 fill, so an edge's channel sum equals
        # the shift of the channels' sum
        bs = (_shift(b1, sbL), _shift(b2, sbM), _shift(b1, sbL - 1))
        es = (_shift(E1, sbL, fill=0.0), _shift(E2, sbM, fill=0.0),
              _shift(E1, sbL - 1, fill=0.0))
        acc = [neg[:, 0]] * S
        for src, frm, to, chans, scal in rows:
            val = bs[src][:, to] + _esum(es[src], chans)
            acc[frm] = ladd(acc[frm], _add_tp(val, tp_scalar, scal))
        cur = torch.stack(acc, dim=1)
        at_end = (d == d_last)[:, None, None]
        cur = torch.where(at_end, end[:, :, None], cur)
        cur = torch.where(valid[:, None, :], cur, NEG_INF)

        Fd = F[:, d]
        vmask = torch.where(valid, 0.0, NEG_INF)[:, None, :]
        t1 = _lse_rows(Fd + cur + vmask)
        Fm1 = _shift(F[:, d - 1] if d >= 1 else neg, diag_scalars[:, d + 1, 0, DS_FM])
        c = [neg[:, 0]] * S
        for _src, frm, to, chans, scal in mid_rows:
            val = Fm1[:, frm] + _esum(E1, chans)
            c[to] = ladd(c[to], _add_tp(val, tp_scalar, scal))
        t2 = _lse_rows(torch.stack(c, dim=1) + b1)
        total = ladd(t1, t2) if 1 <= d < Dp - 1 else t1
        T[:, d] = total

        # one channel per listed state (the match state alone by default),
        # masked to x > 0 and y > 0; edge groups fill p in _em_tallies
        ok = valid & (xmy > -d) & (xmy < d)
        for c, m in enumerate(() if pgroups is not None else
                              (match_state,) if pstates is None else pstates):
            p = torch.exp(torch.clamp_max(Fd[:, m] + cur[:, m] - total[:, None], 0.0))
            Pc[:, d, c] = torch.where(ok, p, 0.0)
        if stages == 4:
            _em_tallies(rows, wgroups, d, dsd, valid, cur, total, F, E[:, d],
                        tp_scalar, d_last, exits, gacc, stats,
                        pgroups, Pc[:, d] if pgroups is not None else None)
        b2, b1 = b1, cur
    if stages == 4:
        return P, T, exits, gacc, stats
    return P, T


def _em_tallies(rows, wgroups, d, dsd, valid, cur, total, F, Ed, tp_scalar,
                d_last, exits, gacc, stats, pgroups=None, p_d=None) -> None:
    """Stage-4 tallies of diagonal d (ops/pallas_fb.py:559-611), in place:
    per-edge posteriors pe = exp(min(F_src[frm] + b[to] + E + tp - total, 0))
    over the band cells of d >= 1, summed over lanes into the stats lanes;
    the window groups' sums join the (B, G, W) tally, which leaves lane W-1
    as exits[d] and shifts right by one lane where the x-window steps
    (DS_XS[d] == 1).  The likelihood lane adds total[d] for 1 <= d <= d_last.
    With ``pgroups``, channel c of p_d (B, P, W), zeroed by the caller, sums
    the posteriors of the edges of group c in edge order (:579-599)."""
    B, S, W = cur.shape
    neg = torch.full((B, S, W), NEG_INF, dtype=torch.float32, device=cur.device)
    Fm1 = F[:, d - 1] if d >= 1 else neg
    Fm2 = F[:, d - 2] if d >= 2 else neg
    sfL = dsd[:, DS_FL]
    srcs = (_shift(Fm1, sfL), _shift(Fm2, dsd[:, DS_FM]), _shift(Fm1, sfL + 1))
    em_ok = valid & (d >= 1)
    pg = [torch.zeros((B, W), dtype=torch.float32, device=cur.device) for _ in wgroups]
    for ei, (src, frm, to, chans, scal) in enumerate(rows):
        logp = _add_tp(srcs[src][:, frm] + cur[:, to] + _esum(Ed, chans), tp_scalar,
                       scal) - total[:, None]
        pe = torch.where(em_ok, torch.exp(torch.clamp_max(logp, 0.0)), 0.0)
        stats[:, ei] += pe.sum(dim=1)
        for g, members in enumerate(wgroups):
            if ei in members:
                pg[g] = pg[g] + pe
        for c, members in enumerate(pgroups or ()):
            if ei in members:
                p_d[:, c] += pe
    lik_ok = (d >= 1) & (d <= d_last)
    stats[:, LIK_LANE] += torch.where(lik_ok, total, 0.0)
    step = (dsd[:, DS_XS] == 1)[:, None]
    for g in range(len(wgroups)):
        gnew = gacc[:, g] + pg[g]
        exits[:, d, g] = torch.where(step[:, 0], gnew[:, W - 1], 0.0)
        gacc[:, g] = torch.where(step, _shift(gnew, -dsd[:, DS_XS], fill=0.0), gnew)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; anything else raises."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """dtype, rank, sizes (None = any) and contiguity of a kernel argument."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != n
                                    for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_width(W: int) -> None:
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError(f"window width {W} must be a multiple of 32 in [32, 1024]")


def _launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point of the kernel library on the current stream;
    raise if the launch was refused, else count it."""
    from ._build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(*args, device.index, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.fb_error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_edges(edges: torch.Tensor, S: int) -> None:
    _check(edges, "edges", torch.int32, (None, EDGE_COLS))
    if edges.shape[0] > MAX_EDGES or S > MAX_STATES:
        raise ValueError(f"{edges.shape[0]} edges / {S} states exceed the "
                         f"kernel limits {MAX_EDGES} / {MAX_STATES}")


def emissions_sm3(x0, yr0, xarr, evr, W: int, Dp: int) -> torch.Tensor:
    """threeState emission grid E (B, Dp+2, 3, W): for problem b, diagonal
    d < Dp and lane j, the 13 per-x pack rows at x0[b, d] + j and the two
    reversed event rows at yr0[b, d] + j give channel 0 = gapX (row 12),
    1 = match (Gauss(level) + Gauss(noise) on rows 0-5), 2 = gapY (rows
    6-11).  Rows >= Dp are zero: the backward pass reads them past the end.
    Replaces ops/pallas_fb.emissions_sm3."""
    if not _on_cuda(x0, yr0, xarr, evr):
        return emissions_sm3_ref(x0, yr0, xarr, evr, W, Dp)
    B, _, lXp = xarr.shape
    lYp = evr.shape[2]
    _check(x0, "x0", torch.int32, (B, Dp + 1))
    _check(yr0, "yr0", torch.int32, (B, Dp + 1))
    _check(xarr, "xarr", torch.float32, (B, N_XPARAMS, None))
    _check(evr, "evr", torch.float32, (B, 2, None))
    _check_width(W)
    E = torch.empty((B, Dp + 2, 3, W), dtype=torch.float32, device=xarr.device)
    _launch("emissions", "fb_emissions_sm3", xarr.device,
            _p(x0), _p(yr0), _p(xarr), _p(evr), _p(E), B, Dp, Dp + 2, W,
            lXp, lYp, Dp + 1)
    return E


def forward_sm3(edges, E, diag_scalars, d_last, start, tp_scalar) -> torch.Tensor:
    """Banded forward recursion over anti-diagonals, generic over the edge
    table: F[d][to] = ladd over edges of F_src[frm] + E channels + scalar
    terms, with the lower/upper sources F[d-1] shifted by DS_FL / DS_FL+1,
    the middle source F[d-2] shifted by DS_FM, cells outside [xmyL, xmyR]
    or past d_last at NEG_INF and the start vector at d = 0.  Returns
    F (B, Dp, S, W).  Replaces ops/pallas_fb.forward_sm3 (nh = 1)."""
    if not _on_cuda(edges, E, diag_scalars, d_last, start, tp_scalar):
        return forward_sm3_ref(edges, E, diag_scalars, d_last, start, tp_scalar)
    B, De, C, W = E.shape
    S = start.shape[1]
    Dp = diag_scalars.shape[1] - 1
    _check(E, "E", torch.float32, (B, None, None, W))
    if De < Dp + 2:
        raise ValueError(f"E has {De} rows, needs >= Dp + 2 = {Dp + 2}")
    _check(diag_scalars, "diag_scalars", torch.int32, (B, Dp + 1, 1, 8))
    _check(d_last, "d_last", torch.int32, (B,))
    _check(start, "start", torch.float32, (B, S))
    _check(tp_scalar, "tp_scalar", torch.float32, (B, None))
    _check_edges(edges, S)
    _check_width(W)
    F = torch.empty((B, Dp, S, W), dtype=torch.float32, device=E.device)
    _launch("forward", "fb_forward", E.device,
            _p(E), _p(diag_scalars), _p(d_last), _p(start), _p(tp_scalar),
            _p(edges), _p(F), B, Dp, De, C, S, W, tp_scalar.shape[1],
            edges.shape[0], Dp + 1)
    return F


def backward_sm3(edges, match_state: int, E, F, diag_scalars, d_last, end,
                 tp_scalar, stages: int = 3, wgroups=None, pstates=None,
                 pgroups=None):
    """Fused backward pass.  Stage 3: the reverse recursion from b[d+1] /
    b[d+2] with E[d+1] / E[d+2] (E shifted with a 0.0 fill), the end vector
    injected at d_last, the per-diagonal total lse(F*b) ladd the
    match-through-diagonal correction, and the match posterior
    exp(min(F + b - total, 0)) masked to x > 0, y > 0.  Returns
    (p (B, Dp, W), totals (B, Dp)).  Replaces ops/pallas_fb.backward_sm3
    at stages <= 3, nh = 1.

    Stage 4 adds the EM tallies of ops/pallas_fb.backward_sm3 (stages=4,
    ``wgroups``, 1-4 tuples of edge indices; the threeState E-step's one
    group, the edges into shortGapX, is engine/pipeline.sm3_wgroups): per-edge
    posterior sums in stats lanes 0..n_edges-1, the likelihood (sum of
    total[d], 1 <= d <= d_last) in lane LIK_LANE, and per window group a
    tally whose lane W-1 leaves as exits[d, g] where DS_XS[d] == 1 (x =
    x0[d] + W - 1) and whose rest comes out as gacc[g] (lane j: x = x0[0] +
    j).  Returns (p, totals, exits (B, Dp, G), gacc (B, G, W), stats
    (B, 128)).

    ``pstates`` (stage 3 only; strictly increasing states) is the echelon
    mode of ops/pallas_fb.py:537-547: p becomes (B, Dp, P, W), channel c the
    posterior exp(min(F + b - total, 0)) of state pstates[c], masked as the
    match posterior (diagonalCalculationMultiPosteriorMatchProbs,
    pairwiseAligner.c:797-839).

    ``pgroups`` (stage 4 only; 1-8 tuples of edge indices, any of the 64
    edges) is the mode of ops/pallas_fb.py:535, :579-599: p becomes (B, Dp,
    P, W), channel c the sum, in edge order, of the stage-4 per-edge
    posteriors of the edges of group pgroups[c] (0 off the band, at d = 0
    and past d_last), in place of the match posterior; the nucleotide
    E-step's groups are the edges into each state (cell_updateExpectations,
    pairwiseAligner.c:407-424)."""
    if stages not in (3, 4):
        raise ValueError(f"stages={stages}: the port runs stage 3 or 4")
    if not _on_cuda(edges, E, F, diag_scalars, d_last, end, tp_scalar):
        return backward_sm3_ref(edges, match_state, E, F, diag_scalars,
                                d_last, end, tp_scalar, stages, wgroups, pstates,
                                pgroups)
    B, De, C, W = E.shape
    S = end.shape[1]
    Dp = F.shape[1]
    _check(E, "E", torch.float32, (B, None, None, W))
    if De < Dp + 2:
        raise ValueError(f"E has {De} rows, needs >= Dp + 2 = {Dp + 2}")
    _check(F, "F", torch.float32, (B, Dp, S, W))
    _check(diag_scalars, "diag_scalars", torch.int32, (B, Dp + 1, 1, 8))
    _check(d_last, "d_last", torch.int32, (B,))
    _check(end, "end", torch.float32, (B, S))
    _check(tp_scalar, "tp_scalar", torch.float32, (B, None))
    _check_edges(edges, S)
    _check_width(W)
    if not 0 <= match_state < S:
        raise ValueError(f"match_state {match_state} outside [0, {S})")
    dev = E.device
    if pstates is not None and pgroups is not None:
        raise ValueError("pstates and pgroups are two posterior modes; pass one")
    if pgroups is not None:
        pmasks = pgroup_masks(pgroups, edges.shape[0], stages)
        P = torch.empty((B, Dp, len(pgroups), W), dtype=torch.float32, device=dev)
    elif pstates is None:
        P = torch.empty((B, Dp, W), dtype=torch.float32, device=dev)
        pmask = 1 << match_state
    else:
        pmask = pstate_mask(pstates, S, stages)
        P = torch.empty((B, Dp, len(pstates), W), dtype=torch.float32, device=dev)
    T = torch.empty((B, Dp), dtype=torch.float32, device=dev)
    args = (_p(E), _p(F), _p(diag_scalars), _p(d_last), _p(end), _p(tp_scalar),
            _p(edges), _p(P), _p(T))
    dims = (B, Dp, De, C, S, W, tp_scalar.shape[1], edges.shape[0], Dp + 1)
    if stages == 3:
        _launch("backward" if pstates is None else "backward_pstates",
                "fb_backward_sm3", dev, *args, *dims, pmask)
        return P, T
    masks = group_masks(wgroups, edges.shape[0])
    G = len(wgroups)
    exits = torch.empty((B, Dp, G), dtype=torch.float32, device=dev)
    gacc = torch.empty((B, G, W), dtype=torch.float32, device=dev)
    stats = torch.empty((B, STATS_LANES), dtype=torch.float32, device=dev)
    if pgroups is None:
        _launch("backward_em", "fb_backward_sm3_em", dev, *args, _p(exits), _p(gacc),
                _p(stats), *dims, match_state, G, *masks)
    else:
        host_masks = (ctypes.c_longlong * len(pmasks))(*pmasks)
        _launch("backward_pgroups", "fb_backward_sm3_pgroups", dev, *args, _p(exits),
                _p(gacc), _p(stats), *dims, G, *masks, len(pmasks), host_masks)
    return P, T, exits, gacc, stats
