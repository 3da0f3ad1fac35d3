"""Pore model (k-mer event model) loading, padding, and per-read scaling.

File format (emissions_signal_loadPoreModel, stateMachine.c:242-320):
  line 1: [correlation] then MODEL_PARAMS values per k-mer (match model)
  line 2: 30 k-mer-skip bin probs (vanilla/echelon); duplicated into bins 30-59
  line 3: [correlation] then MODEL_PARAMS values per k-mer (scaled / extra-event
          "Y" model)

Tables are padded to NUM_OF_KMERS + 2 rows so the KMER_SENTINEL gather returns
0.0 for every parameter, matching emissions_signal_getModelLevelMean & co.
(``kmerIndex > NUM_OF_KMERS -> 0.0``, stateMachine.c:221-240).

Copied from ``cpecan_signal_tpu/models/pore_model.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import MODEL_PARAMS, N_SKIP_BINS, NUM_OF_KMERS, SKIP_BIN_WIDTH_PA

# Column order within a row: level_mean, level_sd, noise_mean, noise_sd, noise_lambda
LEVEL_MEAN, LEVEL_SD, NOISE_MEAN, NOISE_SD, NOISE_LAMBDA = range(MODEL_PARAMS)


@dataclass
class PoreModel:
    """match/Y-model tables of shape (NUM_OF_KMERS+2, MODEL_PARAMS), float64."""

    correlation: float
    match_model: np.ndarray
    y_correlation: float
    y_model: np.ndarray
    skip_bins: np.ndarray  # (60,): [0:30]=beta bins, [30:60]=alpha bins (duplicated on load)

    def copy(self) -> "PoreModel":
        return PoreModel(self.correlation, self.match_model.copy(),
                         self.y_correlation, self.y_model.copy(), self.skip_bins.copy())


def _parse_model_line(tokens: list[str]) -> tuple[float, np.ndarray]:
    expected = 1 + NUM_OF_KMERS * MODEL_PARAMS
    if len(tokens) != expected:
        raise ValueError(f"pore model line has {len(tokens)} fields, expected {expected}")
    vals = np.asarray(tokens, dtype=np.float64)
    table = np.zeros((NUM_OF_KMERS + 2, MODEL_PARAMS), dtype=np.float64)
    table[:NUM_OF_KMERS] = vals[1:].reshape(NUM_OF_KMERS, MODEL_PARAMS)
    return float(vals[0]), table


def load_pore_model(path: str) -> PoreModel:
    with open(path) as fh:
        lines = [fh.readline() for _ in range(3)]
    corr, match = _parse_model_line(lines[0].split())
    bin_tokens = lines[1].split()
    if len(bin_tokens) != N_SKIP_BINS:
        raise ValueError(f"expected {N_SKIP_BINS} skip bins, got {len(bin_tokens)}")
    bins30 = np.asarray(bin_tokens, dtype=np.float64)
    skip_bins = np.concatenate([bins30, bins30])  # stateMachine.c:284-293
    y_corr, y_model = _parse_model_line(lines[2].split())
    return PoreModel(corr, match, y_corr, y_model, skip_bins)


def scale_model(model: PoreModel, scale: float, shift: float, var: float,
                scale_sd: float, var_sd: float, noise_only: bool = False) -> PoreModel:
    """Per-read model rescaling (emissions_signal_scaleModel, stateMachine.c:631-673).

    level_mean = mean*scale + shift; level_sd *= var; noise_mean *= scale_sd;
    noise_lambda *= var_sd; noise_sd = sqrt(noise_mean^3 / noise_lambda).
    Only applied to the match model (the reference never rescales the Y table).
    Padding rows stay zero because 0*scale+shift would perturb them -> we only
    scale the real k-mer rows.
    """
    out = model.copy()
    m = out.match_model
    k = NUM_OF_KMERS
    if not noise_only:
        m[:k, LEVEL_MEAN] = m[:k, LEVEL_MEAN] * scale + shift
    m[:k, LEVEL_SD] = m[:k, LEVEL_SD] * var
    m[:k, NOISE_MEAN] = m[:k, NOISE_MEAN] * scale_sd
    m[:k, NOISE_LAMBDA] = m[:k, NOISE_LAMBDA] * var_sd
    with np.errstate(divide="ignore", invalid="ignore"):
        sd = np.sqrt(m[:k, NOISE_MEAN] ** 3 / m[:k, NOISE_LAMBDA])
    m[:k, NOISE_SD] = np.nan_to_num(sd, nan=0.0, posinf=0.0)
    # provenance for the device-packed read path (engine/readpath): a scaled
    # model that remembers (base, scale params) lets the per-read scaling run
    # on device from ONE shared base-table upload.  Not recorded for
    # noise_only or re-scaled models — those fall back to per-model upload.
    if not noise_only and not hasattr(model, "scale_provenance"):
        out.scale_provenance = (model, (scale, shift, var, scale_sd, var_sd))
    return out


def skip_bin_indices(km1_ranks: np.ndarray, ki_ranks: np.ndarray,
                     match_model: np.ndarray) -> np.ndarray:
    """Per-position skip-prob bin from |level_mean(k_i) - level_mean(k_{i-1})|
    in 0.5 pA bins, clamped to bin 29 (emissions_signal_getKmerSkipBin,
    stateMachine.c:388-419).  Inputs are the trailing-pair rank arrays.
    """
    mu_i = match_model[ki_ranks, LEVEL_MEAN]
    mu_im1 = match_model[km1_ranks, LEVEL_MEAN]
    d = np.abs(mu_i - mu_im1)
    bins = (d / SKIP_BIN_WIDTH_PA).astype(np.int64)
    return np.minimum(bins, N_SKIP_BINS - 1).astype(np.int32)
