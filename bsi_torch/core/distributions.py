"""Probability helpers for the algorithm cores.

Counterpart of ``bsi_tpu/core/distributions.py``: the log-uniform
noise-precision distribution and the (discretized) Gaussian likelihoods.
"""

from __future__ import annotations

import math

import torch

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class LogUniform:
    """Log-uniform distribution on ``[low, high]``.

    Density p(x) = 1 / (x * (ln(high) - ln(low))) for x in [low, high].
    """

    def __init__(self, low: float, high: float):
        self.low = float(low)
        self.high = float(high)
        self.ln_low = math.log(self.low)
        self.ln_high = math.log(self.high)
        self.diff_ln_high_ln_low = self.ln_high - self.ln_low

    def reciprocal_pdf(self, value: torch.Tensor) -> torch.Tensor:
        """Return the reciprocal probability density at ``value``."""
        return value * self.diff_ln_high_ln_low

    def cdf(self, value: torch.Tensor) -> torch.Tensor:
        return (torch.log(value) - self.ln_low) / self.diff_ln_high_ln_low

    def icdf(self, quantile: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.diff_ln_high_ln_low * quantile + self.ln_low)


def normal_cdf(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """CDF of a Normal(loc, scale) evaluated at x."""
    z = (x - loc) / scale
    return 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))


def normal_log_prob(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Log density of a Normal(loc, scale) evaluated at x."""
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(torch.as_tensor(scale, dtype=z.dtype)) - 0.5 * math.log(
        2.0 * math.pi
    )


def discretized_normal_log_prob(
    x: torch.Tensor,
    loc: torch.Tensor,
    scale: torch.Tensor,
    discretization,
    *,
    min_prob: float = 1e-20,
) -> torch.Tensor:
    """Per-dimension log-likelihood of ``x`` under a Normal discretized into bins.

    The probability of the bin containing ``x`` is the CDF difference between
    its boundaries; the outermost bins absorb the full tails.
    """
    boundaries = discretization.bin_boundaries(dtype=x.dtype, device=x.device)
    x_idx = discretization.bucketize(x)
    cdf_left = normal_cdf(boundaries[x_idx], loc, scale)
    cdf_right = normal_cdf(boundaries[x_idx + 1], loc, scale)
    cdf_left = torch.where(x_idx == 0, 0.0, cdf_left)
    cdf_right = torch.where(x_idx == discretization.k - 1, 1.0, cdf_right)
    return torch.log(torch.clamp(cdf_right - cdf_left, min=min_prob))
