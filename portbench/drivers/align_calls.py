"""Cells that align read sets call after call, as ``cli/signal_align`` does
for each batch of reads, less the guide (each read brings its own, as bwa
would hand it over) and the files (the TSV goes to memory).

A call takes the next ``reads_per_call`` reads of a cycle through the pool
in an order drawn from the seed.  The cycle is cut into calls of matched
sizes: the pool sorted by length falls into runs of one read per call, and
the seed deals each run's reads out to the calls, so every call and every
seed holds the same mix of lengths, in another order.  A call does what ``signal_align._batch_align_all`` does: lazily per
read ``prepare_read`` and ``strand_jobs``, one ``batch_align_stream`` over
them, then per read ``assemble_pairs`` for each strand and ``finish_read``.
A closed loop: the next call starts when the last returns.  The warm-up call
(set-up) holds the pool's longest read.  Each call keeps the pairs of a few
of its reads, drawn from the seed, for the comparison with the reference.
"""

from __future__ import annotations

import io
import time

import numpy as np

from portbench import roofline
from portbench.drivers import signal_inputs
from portbench.reference import signal as ref_signal

PROB_1 = 10_000_000


class Cell:
    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.traffic = ctx["traffic"]
        self.kept: dict[int, dict] = {}      # read -> {"t": (x, y, p), "c": ...}
        self.attempted = self.failed = 0
        self.completed: list[int] = []       # reads of the window's completed calls

    def setup(self, span):
        ctx = self.ctx
        self.inputs = signal_inputs.draw(ctx["config"], self.traffic, ctx["seed"],
                                         int(self.traffic["pool"]))
        self.program = signal_inputs.Program(self.inputs, ctx["config"])
        self.events = np.array([signal_inputs.n_events(r) for r in self.inputs["reads"]])
        lengths = [len(r["seq"]) for r in self.inputs["reads"]]
        self.longest = int(np.argmax(lengths))
        self.order = self.cycle(np.asarray(lengths), np.random.default_rng([ctx["seed"], 2]))
        ids = self.draw_call(0)
        if self.longest not in ids:
            ids[0] = self.longest
        self.call(ids, -1, span, {})

    def cycle(self, lengths: np.ndarray, rng) -> np.ndarray:
        """The pool's order: calls of matched lengths, each shuffled."""
        n = int(self.traffic["reads_per_call"])
        k = len(lengths) // n
        runs = np.argsort(lengths, kind="stable")[:k * n].reshape(n, k)
        calls = np.stack([rng.permutation(r) for r in runs], axis=1)    # (k calls, n)
        calls = np.stack([rng.permutation(c) for c in calls])
        rest = np.argsort(lengths, kind="stable")[k * n:]
        return np.concatenate([calls.ravel(), rng.permutation(rest)])

    def draw_call(self, c: int) -> list[int]:
        """The reads of window call c: the next ones of the cycle."""
        n = int(self.traffic["reads_per_call"])
        return self.order[(c * n + np.arange(n)) % len(self.order)].tolist()

    def call(self, ids: list[int], c: int, span, timing: dict) -> None:
        from cpecan_signal_tpu_torch.cli.vanilla_align import finish_read, strand_jobs
        from cpecan_signal_tpu_torch.engine.batch_align import (assemble_pairs,
                                                                batch_align_stream)

        prog = self.program
        preps, owners = [], []
        failed = 0

        def per_read_jobs():
            nonlocal failed
            for i in ids:
                try:
                    prep = prog.prepare(i)
                    if prep["status"] != "ok":
                        failed += 1
                        continue
                    jobs, own = [], []
                    for ctx in prep["strand_ctx"]:
                        sj = strand_jobs(ctx, prog.params)
                        jobs.extend(sj)
                        own.extend(ctx["strand"] for _ in sj)
                except Exception as exc:  # noqa: BLE001 - a read that fails is counted
                    self.ctx["log"](f"read {i}: {exc}")
                    failed += 1
                    continue
                owners.extend((len(preps), s) for s in own)
                preps.append((i, prep))
                yield jobs

        with span("batch_align_stream"):
            _jobs, frags = batch_align_stream(per_read_jobs(), prog.params.threshold,
                                              device=self.ctx["device"], timing=timing)
        rng = np.random.default_rng([self.ctx["seed"], 3, c + 1])
        sample = set(rng.choice(ids, int(self.traffic["compared_per_call"]),
                                replace=False).tolist()) | {self.longest}
        with span("finish_read"):
            for key, (i, prep) in enumerate(preps):
                pairs = {s: assemble_pairs([f for f, o in zip(frags, owners) if o == (key, s)])
                         for s in ("t", "c")}
                finish_read(prep, pairs, io.StringIO(), f"read{i}", "ref")
                if i in sample and i not in self.kept:
                    self.kept[i] = {s: (p.x.copy(), p.y.copy(), p.probs / PROB_1)
                                    for s, p in pairs.items()}
        self.attempted += len(ids)
        self.failed += failed

    def window(self, seconds: float, span) -> dict:
        timing: dict = {}
        self.attempted = self.failed = 0
        t0 = time.perf_counter()
        c = 0
        while True:
            ids = self.draw_call(c)
            self.call(ids, c, span, timing)
            self.completed += ids
            c += 1
            t1 = time.perf_counter()
            self.ctx["log"](f"call {c}: {int(self.events[ids].sum())} events, "
                            f"{t1 - t0:.3f} s into the window")
            if t1 - t0 >= seconds:
                break
        self.window_s = t1 - t0
        events = int(self.events[self.completed].sum())
        return {"end_to_end": {"events_per_s": events / self.window_s},
                "readings": {"window_s": self.window_s, "calls": c, "events": events,
                             "timing": timing}}

    def release(self):
        self.program = None

    def _problems(self, reads, device, dtype=None):
        import torch
        st = self.ctx["config"]["settings"]
        strands = [s for i in reads for s in ref_signal.strands(
            self.inputs["reads"][i], self.inputs["ref"], i, st["constraint_trim"])]
        return ref_signal.SignalProblems(strands, self.inputs["models"],
                                         st["diagonal_expansion"],
                                         st["split_matrix_bigger_than_this"], device,
                                         dtype or torch.float64)

    def work(self) -> dict:
        """Operations and bytes of the window's calls' pipeline, on the
        reference's bands (every read of every completed call)."""
        import torch
        per_cell = roofline.pipeline_ops_per_cell(ref_signal.EDGES, 3, "signal", em=False)
        reads, counts = np.unique(self.completed, return_counts=True)
        problems = self._problems(reads.tolist(), torch.device("cpu"))
        times = dict(zip(reads.tolist(), counts.tolist()))
        cells = nbytes = 0
        for j, (r, _s) in zip(problems.jobs, problems.owner):
            c = int(((j.xmyR - j.xmyL) // 2 + 1).sum())
            cells += c * times[r]
            nbytes += roofline.job_bytes(j.lX, j.lY, len(j.xmyL), 3, c, em=False) * times[r]
        return {"ops": per_cell * cells, "bytes": nbytes}

    def reference_pairs(self, dtype=None) -> dict:
        """(read, strand) -> (x, y, p) of the reference, for the kept reads."""
        reads = sorted(self.kept)
        if not reads:
            return {}
        problems = self._problems(reads, self.ctx["device"], dtype)
        h = problems.hmm([(None, None), (None, None)])
        h.forward()
        h.backward()
        out: dict = {}
        threshold = self.ctx["config"]["settings"]["threshold"]
        for (r, s), (x, y, p) in zip(problems.owner, h.match_pairs(threshold)):
            key = (r, "tc"[s])
            px, py, pp = out.get(key, (np.zeros(0, np.int64),) * 2 + (np.zeros(0),))
            out[key] = (np.concatenate([px, x]), np.concatenate([py, y]),
                        np.concatenate([pp, np.floor(p * PROB_1) / PROB_1]))
        return out

    def check(self) -> dict:
        """The numbers compared over the kept reads' strands (``compare``)."""
        self.reference = self.reference_pairs()
        return compare({(r, s): v for r, d in self.kept.items() for s, v in d.items()},
                       self.reference)

    def control(self, dtype) -> dict:
        return compare(self.reference_pairs(dtype), self.reference)


def compare(program: dict, reference: dict) -> dict:
    """The worst strand's pairs in one and not the other, as a share of the
    reference's pairs, and the worst posterior gap of a shared pair.  A
    strand that never came back, or a run that kept none, reads infinite."""
    off, gap = [], []
    empty = (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    for key, (rx, ry, rp) in reference.items():
        px, py, pp = program.get(key, empty)
        a = dict(zip(zip(px.tolist(), py.tolist()), pp.tolist()))
        b = dict(zip(zip(rx.tolist(), ry.tolist()), rp.tolist()))
        off.append(len(a.keys() ^ b.keys()) / max(len(b), 1))
        gap.append(max((abs(a[k] - b[k]) for k in a.keys() & b.keys()), default=0.0))
    ok = bool(off) and np.isfinite(off + gap).all() and program.keys() <= reference.keys()
    return {"pairs_off_share": float(max(off)) if ok else float("inf"),
            "posterior_gap": float(max(gap)) if ok else float("inf")}
