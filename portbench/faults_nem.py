"""Faults of the nucleotide EM cell (``realign.em_1mb``), planted in the program
under a whole run: the comparison with the reference has to read each as
not correct.  Each ``plant`` replaces one function of the program and
returns what undoes it; the benchmark's own runs never plant one.

    python3 portbench/faults_nem.py --fault <name> --seeds <n> ... [--out FILE]

reads a fault at the cell's own size (``control.readings``: set-up, no
window, the comparison), one JSON line a seed; the tests plant each at a
small size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import control  # noqa: E402
from portbench.faults import _Patch  # noqa: E402

WORKLOAD = "realign.em_1mb"


def _stale_model(patch):
    """Each iteration's E-step runs with the model the one before it was
    given: iteration 1 with iteration 0's."""
    from cpecan_signal_tpu_torch.cli import em
    real = em._estep_all_chunks
    given = []

    def stale(chunks, seqs, params, hmm, *a, **kw):
        given.append(hmm)
        return real(chunks, seqs, params, given[max(len(given) - 2, 0)], *a, **kw)
    patch.setattr(em, "_estep_all_chunks", stale)


def _dropped_pair(patch):
    """The emission tallies of one symbol pair (A, A) made 0 where they are
    made."""
    from cpecan_signal_tpu_torch.em import discrete
    real = discrete.symbol_pair_tallies

    def dropped(*a, **kw):
        out = real(*a, **kw)
        out[:, :, 0] = 0.0
        return out
    patch.setattr(discrete, "symbol_pair_tallies", dropped)


def _swapped_states(patch):
    """The posterior channels of the two short-gap states swapped."""
    from cpecan_signal_tpu_torch.em import discrete
    real = discrete._to_state_pgroups

    def swapped(plan):
        g = list(real(plan))
        g[1], g[2] = g[2], g[1]
        return tuple(g)
    patch.setattr(discrete, "_to_state_pgroups", swapped)


def _half_records(patch):
    """Every other record's tallies left out of the chunk's sum."""
    from cpecan_signal_tpu_torch.cli import realign
    real = realign.record_expectations

    def half(records, seqs, params, hmm, acc, *, per_record=None, **kw):
        mine: list = []
        real(records, seqs, params, hmm, acc, per_record=mine, **kw)
        for trans, emiss, lik in mine[1::2]:
            acc.transitions -= trans
            acc.emissions -= emiss
            acc.likelihood -= lik
        if per_record is not None:
            per_record.extend(mine)
    patch.setattr(realign, "record_expectations", half)


FAULTS = {"stale_model": _stale_model, "dropped_pair": _dropped_pair,
          "swapped_states": _swapped_states, "half_records": _half_records}


def plant(fault: str):
    """Plant ``fault``; returns the undo."""
    patch = _Patch()
    FAULTS[fault](patch)
    return patch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        undo = plant(args.fault)
        try:
            r = control.readings(WORKLOAD, seed, False)
        finally:
            undo()
        r["fault"] = args.fault
        r["failing"] = sorted(k for k, v in r["program"].items()
                              if not v <= r["limits"][k] or not np.isfinite(v))
        rows.append(r)
        print(json.dumps(r), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
