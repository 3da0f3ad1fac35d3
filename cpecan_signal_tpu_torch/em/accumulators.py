"""EM accumulators: host-side pytrees mirroring the reference HMM expectation
objects and their text file formats.

  - ContinuousPairHmm  (continuousHmm.c:89-370)   — threeState
  - VanillaHmm         (continuousHmm.c:372-629)  — vanilla skip bins
  - HdpHmm             (continuousHmm.c:630-900)  — threeStateHdp + assignments
  - DiscreteHmm        (discreteHmm.c)            — fiveState symbol EM

File formats are kept byte-compatible in structure (tab-separated, same line
layout) so models interoperate with the reference's outputs.  The reduce step
(summing per-read expectation files, trainModels.py:126-135) is `add()`; on
device, psum over these pytrees is the distributed equivalent (SURVEY §2.3 P4).

Copied from ``cpecan_signal_tpu/em/accumulators.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import LOG_ZERO, NUM_OF_KMERS, N_SKIP_BINS

# StateMachineType enum values (stateMachine.h:20-29)
TYPE_FIVE_STATE = 0
TYPE_FIVE_STATE_ASYMMETRIC = 1
TYPE_THREE_STATE = 2
TYPE_THREE_STATE_ASYMMETRIC = 3
TYPE_VANILLA = 4
TYPE_ECHELON = 5
TYPE_FOUR_STATE = 6
TYPE_THREE_STATE_HDP = 7


def _safe_log(x):
    with np.errstate(divide="ignore"):
        return np.log(x)


@dataclass
class ContinuousPairHmm:
    """threeState expectation accumulator: 3x3 transitions + per-kmer gap
    tallies + likelihood."""

    transitions: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    kmer_gap: np.ndarray = field(default_factory=lambda: np.zeros(NUM_OF_KMERS))
    likelihood: float = 0.0
    state_number: int = 3
    symbol_set_size: int = NUM_OF_KMERS
    type: int = TYPE_THREE_STATE

    @classmethod
    def empty(cls, pseudocount: float = 0.0) -> "ContinuousPairHmm":
        return cls(transitions=np.full((3, 3), pseudocount),
                   kmer_gap=np.full(NUM_OF_KMERS, pseudocount))

    def add(self, other: "ContinuousPairHmm") -> None:
        """Reduce step (ContinuousPairHmm.add_expectations_file,
        nanoporeLib.py:991-1015): sum transitions, kmer tallies, likelihood."""
        self.transitions += other.transitions
        self.kmer_gap += other.kmer_gap
        self.likelihood += other.likelihood

    def randomize(self, rng: np.random.Generator) -> None:
        self.transitions = rng.random((3, 3))
        self.kmer_gap = rng.random(NUM_OF_KMERS)
        self.normalize()

    def normalize(self) -> None:
        """Row-normalize transitions + normalize kmer gap tallies
        (continuousPairHmm_normalize, continuousHmm.c:174-191)."""
        totals = self.transitions.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore"):
            self.transitions = np.where(totals > 0, self.transitions / totals, self.transitions)
        total = self.kmer_gap.sum()
        if total > 0:
            self.kmer_gap = self.kmer_gap / total

    def to_sm3_params(self) -> tuple[dict[str, float], np.ndarray]:
        """M-step -> (transitions dict for make_signal_sm3, log kmer gap probs)
        (continuousPairHmm_loadTransitionsAndKmerGapProbs, continuousHmm.c:206-232).
        Note GAP_EXTEND_X is tied to 1 - E[gapX->match] and gapX->gapY is banned."""
        t = self.transitions
        params = {
            "match_continue": _safe_log(t[0, 0]),
            "gap_open_x": _safe_log(t[0, 1]),
            "gap_open_y": _safe_log(t[0, 2]),
            "match_from_gap_x": _safe_log(t[1, 0]),
            "gap_extend_x": _safe_log(1.0 - t[1, 0]),
            "gap_switch_to_y": LOG_ZERO,
            "match_from_gap_y": _safe_log(t[2, 0]),
            "gap_extend_y": _safe_log(t[2, 2]),
            "gap_switch_to_x": _safe_log(t[2, 1]),
        }
        return params, _safe_log(self.kmer_gap)

    def write(self, path: str) -> None:
        """3-line format (continuousPairHmm_writeToFile, continuousHmm.c:234-271)."""
        if np.isnan(self.transitions).any():
            return
        with open(path, "w") as fh:
            fh.write(f"{self.type}\t{self.state_number}\t{self.symbol_set_size}\t\n")
            fh.write("".join(f"{v:f}\t" for v in self.transitions.ravel()))
            fh.write(f"{self.likelihood:f}\n")
            fh.write("".join(f"{v:f}\t" for v in self.kmer_gap))
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "ContinuousPairHmm":
        with open(path) as fh:
            head = fh.readline().split()
            type_, s, n = int(head[0]), int(head[1]), int(head[2])
            line2 = fh.readline().split()
            trans = np.asarray(line2[:s * s], dtype=np.float64).reshape(s, s)
            likelihood = float(line2[s * s])
            kmer_gap = np.asarray(fh.readline().split(), dtype=np.float64)
        if len(kmer_gap) != n:
            raise ValueError(f"expected {n} kmer gap probs, got {len(kmer_gap)}")
        return cls(transitions=trans, kmer_gap=kmer_gap, likelihood=likelihood,
                   state_number=s, symbol_set_size=n, type=type_)


@dataclass
class VanillaHmm:
    """Vanilla skip-bin accumulator: 60 alpha/beta bin tallies + carried
    match/scaled models (continuousHmm.c:372-629)."""

    bins: np.ndarray = field(default_factory=lambda: np.zeros(2 * N_SKIP_BINS))
    match_model: np.ndarray | None = None    # (1 + 4096*5,) flat incl. correlation
    scaled_model: np.ndarray | None = None
    likelihood: float = 0.0
    state_number: int = 3
    symbol_set_size: int = NUM_OF_KMERS
    type: int = TYPE_VANILLA

    @classmethod
    def empty(cls, pseudocount: float = 0.0) -> "VanillaHmm":
        return cls(bins=np.full(2 * N_SKIP_BINS, pseudocount))

    def add(self, other: "VanillaHmm") -> None:
        self.bins += other.bins
        self.likelihood += other.likelihood

    def normalize(self, split_alpha_beta: bool = False) -> None:
        """C behavior normalizes all 60 bins jointly (vanillaHmm_normalize-
        KmerSkipBins, continuousHmm.c:424-433, a known bug acknowledged in its
        comment); split_alpha_beta=True gives the corrected Python behavior
        (ConditionalSignalHmm.normalize, nanoporeLib.py:1189-1197)."""
        if split_alpha_beta:
            for sl in (slice(0, N_SKIP_BINS), slice(N_SKIP_BINS, 2 * N_SKIP_BINS)):
                t = self.bins[sl].sum()
                if t > 0:
                    self.bins[sl] = self.bins[sl] / t
        else:
            t = self.bins.sum()
            if t > 0:
                self.bins = self.bins / t

    def implant_match_models(self, pore) -> None:
        """vanillaHmm_implantMatchModelsintoHmm (continuousHmm.c:443-454)."""
        from ..models.pore_model import PoreModel
        assert isinstance(pore, PoreModel)
        self.match_model = np.concatenate(
            [[pore.correlation], pore.match_model[:NUM_OF_KMERS].ravel()])
        self.scaled_model = np.concatenate(
            [[pore.y_correlation], pore.y_model[:NUM_OF_KMERS].ravel()])

    def write(self, path: str) -> None:
        if np.isnan(self.bins).any():
            return
        with open(path, "w") as fh:
            fh.write(f"{self.type}\t{self.state_number}\t{self.symbol_set_size}\t\n")
            fh.write("".join(f"{v:f}\t" for v in self.bins))
            fh.write(f"{self.likelihood:f}\n")
            for model in (self.match_model, self.scaled_model):
                vals = model if model is not None else np.zeros(1 + NUM_OF_KMERS * 5)
                fh.write("".join(f"{v:f}\t" for v in vals))
                fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "VanillaHmm":
        with open(path) as fh:
            head = fh.readline().split()
            type_, s, n = int(head[0]), int(head[1]), int(head[2])
            line2 = fh.readline().split()
            bins = np.asarray(line2[:2 * N_SKIP_BINS], dtype=np.float64)
            likelihood = float(line2[2 * N_SKIP_BINS])
            match_model = np.asarray(fh.readline().split(), dtype=np.float64)
            scaled_model = np.asarray(fh.readline().split(), dtype=np.float64)
        return cls(bins=bins, match_model=match_model, scaled_model=scaled_model,
                   likelihood=likelihood, state_number=s, symbol_set_size=n, type=type_)


@dataclass
class HdpHmm:
    """threeStateHdp accumulator: 3x3 transitions + (kmer, event-mean)
    assignments above the posterior threshold (continuousHmm.c:630-900)."""

    transitions: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    threshold: float = 0.0
    likelihood: float = 0.0
    kmer_assignments: list[str] = field(default_factory=list)
    event_assignments: list[float] = field(default_factory=list)
    state_number: int = 3
    type: int = TYPE_THREE_STATE_HDP

    @classmethod
    def empty(cls, pseudocount: float = 0.0, threshold: float = 0.0) -> "HdpHmm":
        return cls(transitions=np.full((3, 3), pseudocount), threshold=threshold)

    @property
    def n_assignments(self) -> int:
        return len(self.kmer_assignments)

    def add(self, other: "HdpHmm") -> None:
        self.transitions += other.transitions
        self.likelihood += other.likelihood
        self.kmer_assignments.extend(other.kmer_assignments)
        self.event_assignments.extend(other.event_assignments)

    def normalize(self) -> None:
        totals = self.transitions.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore"):
            self.transitions = np.where(totals > 0, self.transitions / totals, self.transitions)

    def to_sm3_params(self) -> dict[str, float]:
        """hdpHmm_loadTransitions (continuousHmm.c:679-700)."""
        t = self.transitions
        return {
            "match_continue": _safe_log(t[0, 0]),
            "gap_open_x": _safe_log(t[0, 1]),
            "gap_open_y": _safe_log(t[0, 2]),
            "match_from_gap_x": _safe_log(t[1, 0]),
            "gap_extend_x": _safe_log(1.0 - t[1, 0]),
            "gap_switch_to_y": LOG_ZERO,
            "match_from_gap_y": _safe_log(t[2, 0]),
            "gap_extend_y": _safe_log(t[2, 2]),
            "gap_switch_to_x": _safe_log(t[2, 1]),
        }

    def write(self, path: str) -> None:
        """4-line format incl. assignments (hdpHmm_writeToFile,
        continuousHmm.c:702-749)."""
        if np.isnan(self.transitions).any():
            return
        with open(path, "w") as fh:
            fh.write(f"{self.type}\t{self.state_number}\t{self.threshold:f}\t"
                     f"{self.n_assignments}\t\n")
            fh.write("".join(f"{v:f}\t" for v in self.transitions.ravel()))
            fh.write(f"{self.likelihood:f}\n")
            fh.write("".join(f"{v:f}\t" for v in self.event_assignments))
            fh.write("\n")
            fh.write("".join(f"{k}\t" for k in self.kmer_assignments))
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "HdpHmm":
        with open(path) as fh:
            head = fh.readline().split()
            type_, s, thresh, n_assign = (int(head[0]), int(head[1]),
                                          float(head[2]), int(head[3]))
            line2 = fh.readline().split()
            trans = np.asarray(line2[:s * s], dtype=np.float64).reshape(s, s)
            likelihood = float(line2[s * s])
            events = [float(v) for v in fh.readline().split()]
            kmers = fh.readline().split()
        if len(events) != n_assign or len(kmers) != n_assign:
            raise ValueError("assignment count mismatch in HdpHmm file")
        return cls(transitions=trans, threshold=thresh, likelihood=likelihood,
                   kmer_assignments=kmers, event_assignments=events,
                   state_number=s, type=type_)


@dataclass
class DiscreteHmm:
    """fiveState symbol EM accumulator (discreteHmm.c): (S,S) transitions +
    (S, n, n) emission tallies."""

    transitions: np.ndarray
    emissions: np.ndarray
    likelihood: float = 0.0
    type: int = TYPE_FIVE_STATE

    @classmethod
    def empty(cls, state_number: int = 5, symbol_set_size: int = 4,
              pseudocount: float = 0.0, type: int = TYPE_FIVE_STATE) -> "DiscreteHmm":
        return cls(np.full((state_number, state_number), pseudocount),
                   np.full((state_number, symbol_set_size, symbol_set_size), pseudocount),
                   type=type)

    @property
    def state_number(self) -> int:
        return self.transitions.shape[0]

    @property
    def symbol_set_size(self) -> int:
        return self.emissions.shape[1]

    def add(self, other: "DiscreteHmm") -> None:
        self.transitions += other.transitions
        self.emissions += other.emissions
        self.likelihood += other.likelihood

    def randomize(self, rng: np.random.Generator) -> None:
        self.transitions = rng.random(self.transitions.shape)
        self.emissions = rng.random(self.emissions.shape)
        self.normalize()

    def normalize(self, normalize_emissions: bool = True) -> None:
        """hmmDiscrete_normalize2 (discreteHmm.c:124-153)."""
        totals = self.transitions.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore"):
            self.transitions = np.where(totals > 0, self.transitions / totals,
                                        self.transitions)
        if normalize_emissions:
            for s in range(self.state_number):
                t = self.emissions[s].sum()
                if t > 0:
                    self.emissions[s] = self.emissions[s] / t

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(f"{self.type}\t{self.state_number}\t{self.symbol_set_size}\t\n")
            fh.write("".join(f"{v:f}\t" for v in self.transitions.ravel()))
            fh.write(f"{self.likelihood:f}\n")
            fh.write("".join(f"{v:f}\t" for v in self.emissions.ravel()))
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "DiscreteHmm":
        with open(path) as fh:
            head = fh.readline().split()
            type_, s, n = int(head[0]), int(head[1]), int(head[2])
            line2 = fh.readline().split()
            trans = np.asarray(line2[:s * s], dtype=np.float64).reshape(s, s)
            likelihood = float(line2[s * s])
            emiss = np.asarray(fh.readline().split(), dtype=np.float64).reshape(s, n, n)
        return cls(transitions=trans, emissions=emiss, likelihood=likelihood, type=type_)


def load_signal_hmm(path: str):
    """Type-dispatched signal-HMM load (hmmContinuous_loadSignalHmm,
    continuousHmm.c:903-911): reads the type field of the header and returns
    the matching accumulator instance."""
    with open(path) as fh:
        type_ = int(fh.readline().split()[0])
    if type_ in (TYPE_THREE_STATE, TYPE_THREE_STATE_ASYMMETRIC):
        return ContinuousPairHmm.load(path)
    if type_ in (TYPE_VANILLA, TYPE_ECHELON):
        return VanillaHmm.load(path)
    if type_ == TYPE_THREE_STATE_HDP:
        return HdpHmm.load(path)
    raise ValueError(f"unsupported signal HMM type {type_} in {path}")


def signal_sm_params(hmm) -> dict:
    """M-step parameter bundle for make_sm_factory from a loaded accumulator:
    {"transitions": ..., "kmer_gap_probs": ..., "skip_bins": ...} with None
    for fields the model type does not train."""
    if isinstance(hmm, ContinuousPairHmm):
        trans, kmer_gaps = hmm.to_sm3_params()
        return {"transitions": trans, "kmer_gap_probs": kmer_gaps,
                "skip_bins": None}
    if isinstance(hmm, VanillaHmm):
        return {"transitions": None, "kmer_gap_probs": None,
                "skip_bins": hmm.bins.copy()}
    if isinstance(hmm, HdpHmm):
        return {"transitions": hmm.to_sm3_params(), "kmer_gap_probs": None,
                "skip_bins": None}
    raise TypeError(type(hmm))
