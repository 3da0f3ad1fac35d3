"""Cells that time cPecanEm's iterations over one alignment job: every record
of a chunk of at most ``max_alignment_length_per_job`` bases of X through
``cli/em.em_iteration`` (the E-step of cPecanRealign --outputExpectations on
the card, then the M-step), back to back, each iteration taking the model
the last one made.

The genome pair and its records come from the seed (``gen/genome_pair``),
and so does the start model: transitions drawn uniform and each row
normalized, emissions Jukes-Cantor at the mix's divergence
(cPecanEm.py:19-105, ``--setJukesCantorStartingEmissions``).  Set-up runs
iterations 0 and 1 through ``em_iteration`` and keeps what the check holds
to the reference: each compared record's tallies (the longest record and
``compared_records`` drawn from the seed) and the model each iteration
hands on.  The window runs further iterations; its rate is the chunk's X
bases per completed iteration.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import roofline
from portbench.gen import genome_pair as gen
from portbench.reference import nucleotide as ref_nuc
from portbench.reference import nucleotide_em as ref_em

S, N_SYM = 5, 4
TALLY_FLOATS = len(ref_nuc.EDGES) + 1 + S * N_SYM * N_SYM   # a job's tallies out


def start_model(rng: np.random.Generator, divergence: float):
    """(trans (5, 5), emiss (5, 4, 4)): uniform transitions, each row
    normalized; every state's emissions Jukes-Cantor at ``divergence``."""
    t = rng.random((S, S))
    t /= t.sum(axis=1, keepdims=True)
    same = (0.25 + 0.75 * np.exp(-4.0 * divergence / 3.0)) / 4.0
    other = (0.25 - 0.25 * np.exp(-4.0 * divergence / 3.0)) / 4.0
    e = np.broadcast_to(np.where(np.eye(N_SYM, dtype=bool), same, other), (S, N_SYM, N_SYM))
    return t, e.copy()


class Cell:
    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.traffic = ctx["traffic"]
        self.attempted = self.failed = 0
        self.recorded = []     # per iteration 0, 1: (compared records' tallies, model handed on)
        self.iterations = 0

    # -- set-up -----------------------------------------------------------
    def setup(self, span):
        from cpecan_signal_tpu_torch.cli.em import chunk_alignments, em_iteration
        from cpecan_signal_tpu_torch.em.accumulators import DiscreteHmm
        from cpecan_signal_tpu_torch.io.cigar import CigarRecord
        from cpecan_signal_tpu_torch.models.params import AlignmentParams

        ctx, t, cfg = self.ctx, self.traffic, self.ctx["config"]
        s = cfg["settings"]
        self.em_iteration = em_iteration
        rng = np.random.default_rng([ctx["seed"], 1])
        lengths = gen.record_lengths(int(cfg["x_bases"]), *t["record_lengths"])
        pair = gen.genome_pair(rng, int(cfg["x_bases"]), tuple(cfg["rates"]), lengths,
                               float(t["reverse_share"]))
        self.seqs = {"X": pair["x"], "Y": pair["y"]}
        self.recs = [{"contig1": "X", "start1": r["x1"], "end1": r["x2"], "strand1": True,
                      "contig2": "Y", "start2": r["c"] if r["forward"] else r["d"],
                      "end2": r["d"] if r["forward"] else r["c"], "strand2": r["forward"],
                      "ops": r["ops"]} for r in pair["records"]]
        records = [CigarRecord(r["contig1"], r["start1"], r["end1"], True, r["contig2"],
                               r["start2"], r["end2"], r["strand2"], 0.0, list(r["ops"]))
                   for r in self.recs]
        self.chunks = chunk_alignments(records, int(cfg["max_alignment_length_per_job"]))
        if len(self.chunks) != 1:
            raise ValueError(f"the records make {len(self.chunks)} chunks, not one job")
        self.bases = sum(r["end1"] - r["start1"] for r in self.recs)
        self.params = AlignmentParams(gap_gamma=s["gap_gamma"],
                                      diagonal_expansion=s["diagonal_expansion"],
                                      constraint_diagonal_trim=s["constraint_trim"],
                                      split_matrix_bigger_than_this=s["split_matrix"] ** 2)
        self.tie = bool(s["tie_emissions"])
        span_x = np.array([r["end1"] - r["start1"] for r in self.recs])
        longest = int(np.argmax(span_x))
        others = [i for i in range(len(self.recs)) if i != longest]
        drawn = np.random.default_rng([ctx["seed"], 3]).choice(
            others, min(int(t["compared_records"]), len(others)), replace=False)
        self.compared = [longest] + sorted(int(i) for i in drawn)
        self.start = start_model(np.random.default_rng([ctx["seed"], 4]),
                                 float(t["jukes_cantor"]))
        self.hmm = DiscreteHmm(transitions=self.start[0].copy(),
                               emissions=self.start[1].copy())
        for _ in range(2):
            per_record: list = []
            with span("em_iteration"):
                self.hmm = self.em_iteration(self.chunks, self.seqs, self.params, self.hmm,
                                             ctx["device"], tie=self.tie,
                                             per_record=per_record)
            if len(per_record) != len(self.recs):
                raise ValueError(f"{len(per_record)} records' tallies for {len(self.recs)}")
            chunk = (sum(r[0] for r in per_record), sum(r[1] for r in per_record))
            self.recorded.append(([per_record[i] for i in self.compared], chunk,
                                  (self.hmm.transitions.copy(), self.hmm.emissions.copy())))

    # -- the window -------------------------------------------------------
    def window(self, seconds: float, span) -> dict:
        timing: dict = {}
        n_rec = len(self.recs)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.attempted += n_rec
            with span("em_iteration"):
                try:
                    self.hmm = self.em_iteration(self.chunks, self.seqs, self.params, self.hmm,
                                                 self.ctx["device"], timing=timing,
                                                 tie=self.tie)
                except Exception as exc:  # noqa: BLE001 - a failed iteration fails its records
                    self.ctx["log"](f"iteration {n + 2}: {exc}")
                    self.failed += n_rec
            n += 1
            t1 = time.perf_counter()
            self.ctx["log"](f"iteration {n + 1}: {t1 - t0:.3f} s into the window")
            if t1 - t0 >= seconds:
                break
        self.iterations = n
        self.window_s = t1 - t0
        return {"end_to_end": {"realign_bases_per_s": self.bases * n / self.window_s},
                "readings": {"window_s": self.window_s, "iterations": n,
                             "bases": self.bases * n, "timing": timing}}

    def release(self):
        self.chunks = self.hmm = None

    # -- what the traced run counts ---------------------------------------
    def _problems(self, ids, device, dtype=None):
        import torch
        s = self.ctx["config"]["settings"]
        heads = [ref_nuc.head(self.recs[i], self.seqs, s["constraint_trim"]) for i in ids]
        return ref_em.EmProblems(heads, s["diagonal_expansion"], s["split_matrix"] ** 2, device,
                                 dtype or torch.float64)

    def work(self) -> dict:
        """Operations and bytes of the window's iterations' pipeline on the
        reference's bands (every record of the chunk): the forward and the
        stage-4 backward with one posterior channel per state; symbol
        emissions are lookups."""
        import torch
        edges = ref_nuc.EDGES
        per_cell = (roofline.ops_per_cell("forward", edges, S)
                    + roofline.ops_per_cell("backward_em", edges, S, n_post=S))
        problems = self._problems(range(len(self.recs)), torch.device("cpu")).problems
        cells = nbytes = 0
        for j in problems.jobs:
            c = int(((j.xmyR - j.xmyL) // 2 + 1).sum())
            cells += c
            # in: a code per base on each side, the diagonals' scalars, the
            # start and end vectors; out: the job's tallies
            nbytes += (j.lX + j.lY + roofline.DIAG_SCALARS * 4 * len(j.xmyL) + 2 * S * 4
                       + 4 * TALLY_FLOATS)
        n = self.iterations
        return {"ops": per_cell * cells * n, "bytes": nbytes * n}

    # -- correctness ------------------------------------------------------
    def reference_iterations(self, dtype=None) -> list:
        """The reference's iterations 0 and 1 on the compared records: their
        tallies under the start model, then under the reference's M-step of
        the program's iteration-0 chunk tallies; and that M-step."""
        import torch
        dtype = dtype or torch.float64
        problems = self._problems(self.compared, self.ctx["device"], dtype)
        model = self.start
        out = []
        for it in range(2):
            next_model = ref_em.m_step(*self.recorded[it][1], dtype=dtype)
            out.append((problems.e_step(*model), next_model))
            model = next_model
        return out

    def check(self) -> dict:
        """The numbers compared, the worst over iterations 0 and 1 and the
        compared records: the relative gap of the likelihood, of a
        transition and of an emission tally (a tally's gap over the
        reference's, floored at one expected use), and of the model handed
        on (``m_step_rel``)."""
        self.reference = self.reference_iterations()
        return compare([(r[0], r[2]) for r in self.recorded], self.reference)

    def control(self, dtype) -> dict:
        """The same numbers with the reference computed in ``dtype`` put in
        the program's place."""
        return compare(self.reference_iterations(dtype), self.reference)


def compare(program, reference) -> dict:
    """Each side: per iteration (per compared record (trans, emiss, lik),
    (trans, emiss) of the model handed on)."""
    gaps = {"likelihood_rel": [], "transition_rel": [], "emission_rel": [], "m_step_rel": []}
    for (p_recs, p_model), (r_recs, r_model) in zip(program, reference):
        if len(p_recs) != len(r_recs):
            gaps["likelihood_rel"].append(np.inf)
        for (pt, pe, pl), (rt, re_, rl) in zip(p_recs, r_recs):
            gaps["likelihood_rel"].append(abs(pl - rl) / abs(rl))
            gaps["transition_rel"].append((np.abs(pt - rt) / np.maximum(np.abs(rt), 1.0)).max())
            gaps["emission_rel"].append((np.abs(pe - re_) / np.maximum(np.abs(re_), 1.0)).max())
        for pm, rm in zip(p_model, r_model):
            gaps["m_step_rel"].append((np.abs(pm - rm) / np.abs(rm)).max())
    return {k: worst(v) for k, v in gaps.items()}


def worst(values) -> float:
    """The largest of ``values``; a NaN or an empty list reads infinite."""
    v = np.asarray(values, dtype=np.float64)
    return float(v.max()) if len(v) and np.isfinite(v).all() else float("inf")
