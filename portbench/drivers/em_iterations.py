"""Cells that time whole threeState EM iterations over a resident read set.

Set-up draws the read pool, prepares every read with its guide
(``cli/vanilla_align.prepare_read``), collects both strands' split jobs and
builds their device buckets once (``em/sm3_em``), as ``cli/train_models.
train`` does for ``-s``.  An iteration is what ``train`` does per iteration on
the card: ``sm3_em_step`` on each strand's buckets, then the accumulator's
``normalize`` and ``to_sm3_params``, whose parameters the next iteration
takes.  Iterations 0 and 1 run in set-up, through the same call; their
tallies are what the reference is held to.  The window runs further
iterations from there.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import roofline
from portbench.drivers import signal_inputs
from portbench.reference import signal as ref_signal

STRANDS = ("t", "c")


class Cell:
    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.traffic = ctx["traffic"]
        self.recorded = []           # [(per strand (trans, kmer, lik))] of iterations 0, 1
        self.iterations = 0

    # -- set-up -----------------------------------------------------------
    def setup(self, span):
        import torch  # noqa: F401
        from cpecan_signal_tpu_torch.em.sm3_em import (_EmBudget, build_sm3_em_buckets,
                                                       collect_sm3_em_jobs)

        ctx = self.ctx
        self.inputs = signal_inputs.draw(ctx["config"], self.traffic, ctx["seed"],
                                         int(self.traffic["reads"]))
        self.program = prog = signal_inputs.Program(self.inputs, ctx["config"])
        preps = []
        self.failed = 0
        for i in range(len(prog.reads)):
            try:
                p = prog.prepare(i)
            except Exception as exc:  # noqa: BLE001 - a read that fails prep is counted
                ctx["log"](f"read {i}: prep failed: {exc}")
                p = {"status": "error"}
            if p["status"] != "ok":
                self.failed += 1
                continue
            preps.append({c["strand"]: (c["target"], c["events"], c["anchors"], c["sparams"])
                          for c in p["strand_ctx"]})
        self.attempted = len(prog.reads)
        models = {"t": prog.models[0], "c": prog.models[1]}
        budget = _EmBudget(ctx["device"])
        self.buckets = {s: build_sm3_em_buckets(collect_sm3_em_jobs(preps, models, prog.params, s),
                                                device=ctx["device"], budget=budget)
                        for s in STRANDS}
        self.state = {s: (None, None) for s in STRANDS}
        for _ in range(2):
            self.recorded.append(self.iteration(span))

    def iteration(self, span):
        """One EM iteration: both strands' E-steps, then each strand's M-step.
        Returns the E-steps' (trans, kmer, likelihood) per strand."""
        from cpecan_signal_tpu_torch.em.accumulators import ContinuousPairHmm
        from cpecan_signal_tpu_torch.em.sm3_em import sm3_em_step

        out = []
        for s in STRANDS:
            with span("e_step"):
                trans, kmer, lik = sm3_em_step(self.buckets[s], *self.state[s])
            out.append((trans.copy(), kmer.copy(), float(lik)))
            with span("m_step"):
                acc = ContinuousPairHmm(transitions=trans, kmer_gap=kmer, likelihood=lik)
                acc.normalize()
                self.state[s] = acc.to_sm3_params()
        return out

    # -- the window -------------------------------------------------------
    def window(self, seconds: float, span) -> dict:
        from cpecan_signal_tpu_torch.ops import fb_kernels

        launches0 = sum(fb_kernels.LAUNCHES.values())
        t0 = time.perf_counter()
        n = 0
        while True:
            self.iteration(span)
            n += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        self.iterations = n
        self.window_s = t1 - t0
        launches = sum(fb_kernels.LAUNCHES.values()) - launches0
        return {"end_to_end": {"em_iter_s": self.window_s / n},
                "readings": {"window_s": self.window_s, "iterations": n,
                             "launches": launches}}

    def release(self):
        self.buckets = None

    # -- what the traced run counts ---------------------------------------
    def work(self) -> dict:
        """Operations and bytes of the window's iterations' pipeline, counted
        on the reference's bands."""
        problems = self._problems(ops_only=True)
        edges = ref_signal.EDGES
        per_cell = roofline.pipeline_ops_per_cell(edges, 3, "signal", em=True,
                                                  wgroups=((0, 1, 2),))
        cells = nbytes = 0
        for j in problems.jobs:
            c = int(((j.xmyR - j.xmyL) // 2 + 1).sum())
            cells += c
            nbytes += roofline.job_bytes(j.lX, j.lY, len(j.xmyL), 3, c, em=True)
        n = self.iterations
        return {"ops": per_cell * cells * n, "bytes": nbytes * n}

    # -- correctness ------------------------------------------------------
    def _problems(self, ops_only=False, dtype=None):
        import torch
        ref = self.inputs["ref"]
        strands = [s for i, r in enumerate(self.inputs["reads"])
                   for s in ref_signal.strands(r, ref, i, self.ctx["config"]["settings"]
                                               ["constraint_trim"])]
        st = self.ctx["config"]["settings"]
        device = torch.device("cpu") if ops_only else self.ctx["device"]
        return ref_signal.SignalProblems(strands, self.inputs["models"],
                                         st["diagonal_expansion"],
                                         st["split_matrix_bigger_than_this"], device,
                                         dtype or torch.float64)

    def reference_iterations(self, dtype=None):
        """The reference's iterations 0 and 1: per strand (trans, kmer, lik)."""
        problems = self._problems(dtype=dtype)
        params = [(None, None), (None, None)]
        out = []
        for _ in range(2):
            res = problems.e_step(params)
            out.append(res)
            params = [ref_signal.m_step(t, k) for t, k, _lik in res]
        return out

    def check(self) -> dict:
        """The numbers compared: the worst relative gap, over iterations 0
        and 1 and both strands, of the likelihood, of a transition tally and
        of a k-mer gap tally (a tally's gap over the reference's, floored at
        one expected use)."""
        self.reference = self.reference_iterations()
        return compare(self.recorded, self.reference)

    def control(self, dtype) -> dict:
        """The same numbers with the reference computed in ``dtype`` put in
        the program's place."""
        return compare(self.reference_iterations(dtype), self.reference)


def compare(program, reference) -> dict:
    gaps = {"likelihood_rel": [], "transition_rel": [], "kmer_gap_rel": []}
    for prog_it, ref_it in zip(program, reference):
        for (pt, pk, pl), (rt, rk, rl) in zip(prog_it, ref_it):
            gaps["likelihood_rel"].append(abs(pl - rl) / abs(rl))
            gaps["transition_rel"].append((np.abs(pt - rt) / np.maximum(np.abs(rt), 1.0)).max())
            gaps["kmer_gap_rel"].append((np.abs(pk - rk) / np.maximum(np.abs(rk), 1.0)).max())
    return {k: worst(v) for k, v in gaps.items()}


def worst(values) -> float:
    """The largest of ``values``; a NaN or an empty list reads infinite."""
    v = np.asarray(values, dtype=np.float64)
    return float(v.max()) if len(v) and np.isfinite(v).all() else float("inf")
