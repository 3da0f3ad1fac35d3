"""f32 drift of the PyTorch port's kernels against the f64 oracle, by depth,
on one CUDA card, and its cause.

    python3 tools/torch_f32_drift.py [--budget 300] [--out f32_drift.json]

Makes threeState split jobs of growing depth, each one unsplit job (a read
evolved from a random reference, 4 % substitutions and 2 % indels, its
events simulated from a random pore model, anchors at every 40th pair of
its true path, as chip_smoke.py's 50 kb read): about 1k to 5k events, then
deeper, up to the 50 kb read (Dp = 106496 diagonals) while the oracle's
time stays within ``--budget`` seconds.  Then fiveState jobs of realign's
records (chip_smoke.py's genome-pair generator): 1 kb, 20 kb and 100 kb
pairs, the last about 200 k diagonals.  Each job runs through the
production path on the card (engine/batch_align: the hand-written kernels,
f32, the reference's cubic logAdd) and through the f64 oracle on the card
(engine/fb.py: exact logaddexp), and the tool reports per job the pair
Jaccard, the pairs only the oracle has (missing) and only the kernels have
(extra), and the largest posterior drift on the pairs both have, against
the limits of tests/test_readpath_random.py (1 pair, 1.2e-3), with the
oracle's microseconds a diagonal (forward, backward; the host clock
around each pass, synchronised).

To tell the two ways the kernels differ from that oracle apart, each job
also runs through the oracle at f32 with exact logaddexp, at f64 with the
cubic logAdd, and at f32 with the cubic logAdd; each of these is compared
with the f64 exact oracle and with the kernels.

Prints the card's name and power limit, one line per job, and as its last
line a JSON object, which it also writes to ``--out``.  Needs a card: it
exits nonzero without one.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAIR_TOL, PROB_TOL = 1, 1.2e-3
SEED = 20261017
# target lengths in bases (about as many events) and jobs of each
THREE_SIZES = ((1000, 3), (2000, 3), (3000, 2), (5000, 2), (10000, 1), (15000, 1),
               (25000, 1), (35000, 1), (50000, 1))
FIVE_SIZES = (1000, 20000, 100000)
# the oracle's other arithmetics: (name, dtype, logadd)
VARIANTS = (("f32_exact", "float32", "exact"), ("f64_lookup", "float64", "lookup"),
            ("f32_lookup", "float32", "lookup"))


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def timed_oracle(job, device, dtype="float64", logadd="exact"):
    """(F, B, plan, inputs, forward us a diagonal, backward us a diagonal,
    seconds of the host packing)."""
    import dataclasses

    import torch

    from cpecan_signal_tpu_torch.engine import fb

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan, inp = fb.prepare_inputs(job.sm, job.band, ragged_left=job.ragged_left,
                                  ragged_right=job.ragged_right, device=device,
                                  dtype=getattr(torch, dtype))
    plan = dataclasses.replace(plan, logadd=logadd)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    D = inp.valid.shape[0]
    out = []
    for fn in (fb.forward, fb.backward):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(fn(plan, inp))
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / D * 1e6)
    F, t_f, B, t_b = out
    return F, B, plan, inp, t_f, t_b, t_prep


def oracle_pairs(job, threshold, device, dtype="float64", logadd="exact"):
    """The oracle's pairs of one job and its timing: (pairs, (D, W),
    forward and backward us a diagonal, seconds of the host packing and of
    the posteriors to pairs)."""
    from cpecan_signal_tpu_torch.engine import fb
    from cpecan_signal_tpu_torch.engine.align import AlignedPairs, _extract_pairs

    F, B, plan, inp, t_f, t_b, t_prep = timed_oracle(job, device, dtype, logadd)
    t0 = time.perf_counter()
    p, _ = fb.posterior_match_probs(plan, inp, F, B)
    pairs = AlignedPairs(*_extract_pairs(p.double().cpu().numpy(), inp.x.cpu().numpy(),
                                         inp.y.cpu().numpy(), threshold, job.off_x,
                                         job.off_y))
    return pairs, inp.valid.shape, t_f, t_b, t_prep, time.perf_counter() - t0


def compare(f32, f64) -> dict:
    a = {(x, y): p for p, x, y in f32.as_tuples()}
    b = {(x, y): p for p, x, y in f64.as_tuples()}
    common = set(a) & set(b)
    drift = max((abs(a[k] - b[k]) / 1e7 for k in common), default=0.0)
    return {"pairs_f32": len(a), "pairs_f64": len(b),
            "jaccard": len(common) / max(len(set(a) | set(b)), 1),
            "missing": len(set(b) - set(a)), "extra": len(set(a) - set(b)),
            "max_posterior_drift": drift}


def three_jobs(rng, pore, ref_seq, n_bases, params):
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.engine.align import collect_split_jobs
    from cpecan_signal_tpu_torch.models.state_machines import make_signal_sm3

    target = ""
    while len(target) < n_bases:
        start = int(rng.integers(0, len(ref_seq) // 2))
        target += syn.evolve_sequence(ref_seq[start:], rng, 0.04, 0.02)
    target = target[:n_bases]
    events, path = syn.simulate_events(pore, target, rng)
    anchors = syn.path_anchors(path, len(target) - 5, len(events), 40)
    return len(events), collect_split_jobs(lambda t, e: make_signal_sm3(pore, t, e), target,
                                           events, anchors, params)


def five_job(rng, n_bases, params):
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.engine.align import collect_symbol_split_jobs
    from cpecan_signal_tpu_torch.models.state_machines import (bind_symbol_sequences,
                                                                make_symbol_sm5)

    x = "".join(rng.choice(list("ACGT"), n_bases))
    y, truth = syn.evolve_with_truth(x, rng, 0.05, 0.005, 0.005)

    def make_sm(a, b):
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, a, b)
        return sm
    (job,) = collect_symbol_split_jobs(make_sm, x, y, truth[::25], params,
                                       ragged_left=True, ragged_right=True)
    return job


def measure(job, threshold, device, variants=VARIANTS) -> dict:
    """One job through the kernels and the oracle's arithmetics, with the
    seconds of each stage (the host clock, synchronised)."""
    import torch

    from cpecan_signal_tpu_torch.engine.batch_align import batch_align_jobs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (f32,) = batch_align_jobs([job], threshold, device=device)
    t_kern = time.perf_counter() - t0
    f64, (D, W), t_f, t_b, t_prep, t_post = oracle_pairs(job, threshold, device)
    row = {"Dp": D, "W": W, **compare(f32, f64), "oracle_forward_us_per_diagonal": t_f,
           "oracle_backward_us_per_diagonal": t_b,
           "seconds_by_stage": {"kernels": t_kern, "oracle_packing": t_prep,
                                "oracle_posteriors": t_post}}
    row["within_limits"] = (max(row["missing"], row["extra"]) <= PAIR_TOL
                            and row["max_posterior_drift"] <= PROB_TOL)
    for name, dtype, logadd in variants:
        v = oracle_pairs(job, threshold, device, dtype, logadd)[0]
        c = compare(v, f64)
        row[name] = {"vs_f64_exact": {k: c[k] for k in ("max_posterior_drift", "missing",
                                                        "extra")},
                     "kernels_vs": {k: compare(f32, v)[k] for k in ("max_posterior_drift",
                                                                    "missing", "extra")}}
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget", type=float, default=300.0,
                    help="seconds of f64 oracle time before deeper threeState jobs "
                         "are skipped")
    ap.add_argument("--out", default="f32_drift.json")
    ap.add_argument("--machines", default="threeState,fiveState",
                    help="comma-separated: threeState, fiveState")
    ap.add_argument("--five-bases", default=",".join(map(str, FIVE_SIZES)),
                    help="comma-separated lengths of the fiveState pairs")
    ap.add_argument("--variants", default=",".join(v[0] for v in VARIANTS),
                    help="comma-separated oracle arithmetics besides f64 exact: "
                         + ", ".join(v[0] for v in VARIANTS) + " (empty: none)")
    args = ap.parse_args(argv)
    machines = args.machines.split(",")
    variants = [v for v in VARIANTS if v[0] in args.variants.split(",")]

    import torch

    if not torch.cuda.is_available():
        print("torch_f32_drift: torch reports no usable CUDA device", file=sys.stderr)
        return 1
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.models.params import AlignmentParams, cli_defaults

    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    rng = np.random.default_rng(SEED)
    model = os.path.join(os.path.dirname(args.out) or ".", "f32_drift.model")
    os.makedirs(os.path.dirname(model) or ".", exist_ok=True)
    pore = syn.write_pore_model(model, rng)
    ref_seq = "".join(rng.choice(list("ACGT"), 60000))
    params = cli_defaults()
    rows, spent = [], 0.0
    t_start = time.perf_counter()
    for n_bases, n_jobs in THREE_SIZES if "threeState" in machines else ():
        for _ in range(n_jobs):
            n_ev, jobs = three_jobs(rng, pore, ref_seq, n_bases, params)
            (job,) = jobs
            if spent > args.budget:
                print(f"skipped: {n_bases} bases, oracle budget spent ({spent:.1f} s)",
                      flush=True)
                continue
            t0 = time.perf_counter()
            row = {"machine": "threeState", "bases": n_bases, "events": n_ev,
                   **measure(job, params.threshold, device, variants)}
            spent += (row["oracle_forward_us_per_diagonal"]
                      + row["oracle_backward_us_per_diagonal"]) * row["Dp"] * 1e-6
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            print(json.dumps(row), flush=True)
    five = []
    for n_bases in map(int, args.five_bases.split(",")) if "fiveState" in machines else ():
        five_params = AlignmentParams()
        job = five_job(rng, n_bases, five_params)
        t0 = time.perf_counter()
        row = {"machine": "fiveState", "bases": n_bases,
               **measure(job, five_params.threshold, device, variants)}
        row["seconds"] = time.perf_counter() - t0
        five.append(row)
        print(json.dumps(row), flush=True)
    result = {"card": card, "threeState": rows, "fiveState": five,
              "oracle_seconds": spent, "seconds": time.perf_counter() - t_start,
              "all_within_limits": all(r["within_limits"] for r in rows + five)}
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
