"""Bayesian Sample Inference (arXiv:2502.07580): the training loss and the
sampler's steps, with EDM preconditioning.

The belief over a sample is ``N(mu, 1/lambda)``; a noise level ``t`` in
[0, 1] maps to a precision through the log-uniform law on
``[lambda_0, lambda_0 + alpha_M]``. ``cfg``: ``lambda_0``, ``alpha_M``.
"""

from __future__ import annotations

import math

import torch


class BSI:
    def __init__(self, cfg: dict, model):
        self.l0 = float(cfg["lambda_0"])
        self.hi = self.l0 + float(cfg["alpha_M"])
        self.ln_lo, self.ln_ratio = math.log(self.l0), math.log(self.hi) - math.log(self.l0)
        self.model = model  # (mu, t) -> prediction

    def precision(self, t):
        """lambda(t): the log-uniform law's inverse CDF."""
        return torch.exp(self.ln_ratio * t + self.ln_lo)

    def level(self, lam):
        """t(lambda): its CDF."""
        return (torch.log(lam) - self.ln_lo) / self.ln_ratio

    def preconditioning(self, t):
        """(c_skip, c_out, c_in) at t, each ``[B]``."""
        lam = self.precision(t)
        alpha = lam - self.l0
        kappa = 1.0 + alpha * (alpha / lam)
        return alpha / kappa, torch.rsqrt(kappa), torch.sqrt(lam / kappa)

    def predict(self, mu, t, c=None):
        """x_hat = c_skip mu + c_out F(c_in mu, t); ``c`` given skips the
        coefficients' computation."""
        c_skip, c_out, c_in = c if c is not None else self.preconditioning(t)
        r = lambda v: v[:, None, None, None]
        return r(c_skip) * mu + r(c_out) * self.model(r(c_in) * mu, t)

    def train_losses(self, x, t, eps):
        """Per-example loss ``[B]``: the weighted mean squared decoding error
        at lambda(t), the model seeing t(lambda(t))."""
        lam = self.precision(t)
        r = lambda v: v[:, None, None, None]
        mu = r((lam - self.l0) / lam) * x + r(torch.rsqrt(lam)) * eps
        x_hat = self.predict(mu, self.level(lam))
        return lam * self.ln_ratio * ((x - x_hat) ** 2).reshape(x.shape[0], -1).mean(-1)

    def schedule(self, k: int, device):
        """The linear schedule of k steps: t_i = i / k."""
        return torch.linspace(0.0, 1.0, k + 1, device=device)

    def start(self, t0, eps0):
        """The initial belief mean: ``eps0 / sqrt(lambda(t_0))``."""
        return torch.rsqrt(self.precision(t0)) * eps0

    def update(self, mu, x_hat, eps, t_i, t_next):
        """One belief update: a measurement ``y = x_hat + eps / sqrt(alpha)``
        of precision ``alpha = lambda(t_next) - lambda(t_i)``, then
        ``mu <- (alpha y + lambda_i mu) / lambda_next``."""
        lam_i, lam_n = self.precision(t_i), self.precision(t_next)
        alpha = lam_n - lam_i
        y = x_hat + torch.rsqrt(alpha) * eps
        return (alpha * y + lam_i * mu) / lam_n
