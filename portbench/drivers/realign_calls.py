"""Cells that realign guide CIGAR records call after call, as
``cli/realign`` does for the records it reads: one
``realign_records_batched`` over a call's records (every record's head and
split jobs, the symbol lane's device batch, every record's AMAP tail).

The genome pair and its records come from the seed (``gen/genome_pair``).  A
call takes the next records of a cycle through them, in an order drawn from
the seed, until they span ``bases_per_call`` bases of X (so every seed's
window works through the same records, in another order).  A closed loop: the next call starts when the
last returns.  The warm-up call (set-up) holds the longest record.  Each
call keeps the output of a record or so drawn from the seed for the
comparison with the reference.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import roofline
from portbench.gen import genome_pair as gen
from portbench.reference import nucleotide as ref_nuc


class Cell:
    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.traffic = ctx["traffic"]
        self.kept: dict[int, np.ndarray] = {}     # record -> (x, y) pairs of its output
        self.attempted = self.failed = 0
        self.completed: list[int] = []

    def setup(self, span):
        from cpecan_signal_tpu_torch.io.cigar import CigarRecord
        from cpecan_signal_tpu_torch.models.params import AlignmentParams

        ctx, t = self.ctx, self.traffic
        s = ctx["config"]["settings"]
        rng = np.random.default_rng([ctx["seed"], 1])
        lengths = gen.record_lengths(int(ctx["config"]["x_bases"]), *t["record_lengths"])
        pair = gen.genome_pair(rng, int(ctx["config"]["x_bases"]), tuple(ctx["config"]["rates"]),
                               lengths, float(t["reverse_share"]))
        self.seqs = {"X": pair["x"], "Y": pair["y"]}
        self.recs = []
        for r in pair["records"]:
            fwd = r["forward"]
            self.recs.append({"contig1": "X", "start1": r["x1"], "end1": r["x2"], "strand1": True,
                              "contig2": "Y", "start2": r["c"] if fwd else r["d"],
                              "end2": r["d"] if fwd else r["c"], "strand2": fwd,
                              "ops": r["ops"]})
        self.records = [CigarRecord(r["contig1"], r["start1"], r["end1"], True, r["contig2"],
                                    r["start2"], r["end2"], r["strand2"], 0.0, list(r["ops"]))
                        for r in self.recs]
        self.params = AlignmentParams(gap_gamma=s["gap_gamma"],
                                      diagonal_expansion=s["diagonal_expansion"],
                                      constraint_diagonal_trim=s["constraint_trim"],
                                      split_matrix_bigger_than_this=s["split_matrix"] ** 2,
                                      threshold=s["threshold"])
        self.span_x = np.array([r["end1"] - r["start1"] for r in self.recs])
        self.longest = int(np.argmax(self.span_x))
        self.order = np.random.default_rng([ctx["seed"], 2]).permutation(len(self.recs))
        self.next = 0
        ids = self.draw_call()
        self.next = 0
        if self.longest not in ids:
            ids[0] = self.longest
        self.call(ids, -1, span, {})

    def draw_call(self) -> list[int]:
        """The records of the next call: the next ones of the cycle."""
        ids, bases = [], 0
        while bases < self.traffic["bases_per_call"]:
            i = int(self.order[self.next % len(self.order)])
            self.next += 1
            ids.append(i)
            bases += int(self.span_x[i])
        return ids

    def call(self, ids: list[int], c: int, span, timing: dict) -> None:
        from cpecan_signal_tpu_torch.cli.realign import realign_records_batched

        with span("realign_records_batched"):
            try:
                out = realign_records_batched([self.records[i] for i in ids], self.seqs,
                                              self.params, device=self.ctx["device"],
                                              timing=timing)
            except Exception as exc:  # noqa: BLE001 - a call that fails fails its records
                self.ctx["log"](f"call {c}: {exc}")
                out = None
        self.attempted += len(ids)
        if out is None:
            self.failed += len(ids)
            return
        rng = np.random.default_rng([self.ctx["seed"], 3, c + 1])
        sample = set(rng.choice(ids, int(self.traffic["compared_per_call"]),
                                replace=False).tolist()) | {self.longest}
        for i, recs in zip(ids, out):
            if len(recs) != 1:
                self.failed += 1
            elif i in sample and i not in self.kept:
                self.kept[i] = ref_nuc.ops_pairs(recs[0].ops)

    def window(self, seconds: float, span) -> dict:
        timing: dict = {}
        self.attempted = self.failed = 0
        t0 = time.perf_counter()
        c = 0
        while True:
            ids = self.draw_call()
            self.call(ids, c, span, timing)
            self.completed += ids
            c += 1
            t1 = time.perf_counter()
            self.ctx["log"](f"call {c}: {int(self.span_x[ids].sum())} bases, "
                            f"{t1 - t0:.3f} s into the window")
            if t1 - t0 >= seconds:
                break
        self.window_s = t1 - t0
        bases = int(self.span_x[self.completed].sum())
        return {"end_to_end": {"realign_bases_per_s": bases / self.window_s},
                "readings": {"window_s": self.window_s, "calls": c, "bases": bases,
                             "timing": timing}}

    def release(self):
        self.records = None

    def _heads(self, ids):
        trim = self.ctx["config"]["settings"]["constraint_trim"]
        return [ref_nuc.head(self.recs[i], self.seqs, trim) for i in ids]

    def _problems(self, heads, device, dtype=None):
        import torch
        s = self.ctx["config"]["settings"]
        return ref_nuc.RealignProblems(heads, s["diagonal_expansion"], s["split_matrix"] ** 2,
                                       device, dtype or torch.float64)

    def work(self) -> dict:
        """Operations and bytes of the window's calls' pipeline on the
        reference's bands (every record of every completed call)."""
        import torch
        per_cell = roofline.pipeline_ops_per_cell(ref_nuc.EDGES, 5, "symbol", em=False)
        recs, counts = np.unique(self.completed, return_counts=True)
        problems = self._problems(self._heads(recs.tolist()), torch.device("cpu"))
        cells = nbytes = 0
        for j, r in zip(problems.jobs, problems.owner):
            c = int(((j.xmyR - j.xmyL) // 2 + 1).sum())
            cells += c * counts[r]
            # a symbol job's inputs: one code per base on each side
            nbytes += (j.lX + j.lY + roofline.DIAG_SCALARS * 4 * len(j.xmyL) + 4 * c) * counts[r]
        return {"ops": per_cell * cells, "bytes": nbytes}

    def reference_output(self, dtype=None) -> dict:
        """record -> (x, y) pairs of the reference's realignment."""
        ids = sorted(self.kept)
        if not ids:
            return {}
        heads = self._heads(ids)
        s = self.ctx["config"]["settings"]
        pairs = self._problems(heads, self.ctx["device"], dtype).pairs(s["threshold"], len(ids))
        return {i: ref_nuc.realigned_pairs(p, len(h[0]), len(h[1]), s["gap_gamma"])
                for i, h, p in zip(ids, heads, pairs)}

    def check(self) -> dict:
        """The number compared, the worst over the kept records: the pairs
        in one realignment and not the other, as a share of the reference's
        pairs."""
        self.reference = self.reference_output()
        return compare(self.kept, self.reference)

    def control(self, dtype) -> dict:
        return compare(self.reference_output(dtype), self.reference)


def compare(program: dict, reference: dict) -> dict:
    """A record that never came back reads infinite."""
    shares = []
    for i, r in reference.items():
        p = program.get(i, np.zeros((0, 2), dtype=np.int64))
        a, b = set(map(tuple, p.tolist())), set(map(tuple, r.tolist()))
        shares.append(len(a ^ b) / max(len(b), 1))
    v = np.asarray(shares)
    ok = len(v) and np.isfinite(v).all() and program.keys() <= reference.keys()
    return {"pairs_off_share": float(v.max()) if ok else float("inf")}
