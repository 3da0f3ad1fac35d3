"""Elementwise log-density primitives for signal emissions (port of
``cpecan_signal_tpu/ops/pdfs.py``, as torch functions).

Closed forms mirror stateMachine.c:
  - log_gauss_pdf           (emissions_signal_logGaussPdf :333-343)
  - log_inv_gauss_pdf       (emissions_signal_logInvGaussPdf :322-331)
  - log_bivariate_gauss_pdf (emissions_signal_getBivariateGaussPdfMatchProb :556-593)
  - poisson_posterior_logp  (emissions_signal_poissonPosteriorProb :345-370)

Inputs are tensors of pre-gathered model parameters (or Python numbers),
never per-cell table walks.
"""

from __future__ import annotations

import torch

from ..constants import LOG_ZERO

_LOG_INV_SQRT_2PI = -0.91893853320467267
_LOG_2PI = 1.8378770664093453
_LOG_INV_2PI = -1.8378770664093453


def log_gauss_pdf(x, mu, sigma):
    """log N(x; mu, sigma); LOG_ZERO where sigma == 0 (reference behavior)."""
    safe_sigma = torch.where(sigma == 0.0, 1.0, sigma)
    a = (x - mu) / safe_sigma
    lp = _LOG_INV_SQRT_2PI - torch.log(safe_sigma) - 0.5 * a * a
    return torch.where(sigma == 0.0, LOG_ZERO, lp)


def log_inv_gauss_pdf(noise, noise_mu, noise_lambda):
    """log inverse-Gaussian density of event noise."""
    safe_mu = torch.where(noise_mu == 0.0, 1.0, noise_mu)
    safe_lam = torch.where(noise_lambda <= 0.0, 1.0, noise_lambda)
    safe_noise = torch.where(noise <= 0.0, 1.0, noise)
    a = (noise - safe_mu) / safe_mu
    lp = (
        torch.log(safe_lam) - _LOG_2PI - 3.0 * torch.log(safe_noise)
        - safe_lam * a * a / safe_noise
    ) / 2.0
    bad = (noise_mu == 0.0) | (noise_lambda <= 0.0) | (noise <= 0.0)
    return torch.where(bad, LOG_ZERO, lp)


def log_bivariate_gauss_pdf(mean, noise, level_mu, level_sd, noise_mu, noise_sd, rho):
    """Correlated bivariate Gaussian over (event mean, event noise)."""
    rho2 = rho * rho
    safe_lsd = torch.where(level_sd == 0.0, 1.0, level_sd)
    safe_nsd = torch.where(noise_sd == 0.0, 1.0, noise_sd)
    xu = (mean - level_mu) / safe_lsd
    yu = (noise - noise_mu) / safe_nsd
    exp_c = -1.0 / (2.0 * (1.0 - rho2))
    a = exp_c * (xu * xu + yu * yu - 2.0 * rho * xu * yu)
    c = _LOG_INV_2PI - torch.log(safe_lsd * safe_nsd * torch.sqrt(1.0 - rho2))
    bad = (level_sd == 0.0) | (noise_sd == 0.0)
    return torch.where(bad, LOG_ZERO, c + a)


# Poisson-posterior duration model constants (stateMachine.c:345-370).
_POISSON_C = 0.00332005312085
_POISSON_L_BETA = 0.1397619423751586
_L_FACTORIALS = (0.0, 0.0, 0.69314718056, 1.79175946923, 3.17805383035, 4.78749174278)


def poisson_posterior_logp(n: int, duration):
    """log P(n kmers | event duration) via the reference's heuristic Poisson posterior."""
    lam = duration / _POISSON_C
    safe_lam = torch.where(lam <= 0.0, 1.0, lam)
    a = (n + 1) * _POISSON_L_BETA
    b = n * torch.log(safe_lam)
    lp = a + b - _L_FACTORIALS[n] - 2.0 * lam
    return torch.where(lam <= 0.0, LOG_ZERO, lp)
