"""Bayesian Flow Networks (BFN) baseline for continuous data.

Counterpart of ``bsi_tpu/core/bfn.py`` (arXiv:2308.07037), with the same
public surface as :class:`~bsi_torch.core.bsi.BSI`. The model predicts
*epsilon*, converted to a clipped x-prediction. The additive-accuracy
sampler is a Python loop carrying the running precision ``rho`` where JAX
runs a ``lax.scan``.

The JAX package's two departures from the reference are kept:
``discrete_time_loss`` with ``t=None`` runs on the default schedule (the
reference calls a nonexistent ``self.linspace``), and every time draw is
``(n_samples, batch)`` with or without low-discrepancy sampling (the
reference's non-LDS branch transposes it). ``train_loss`` returns
per-example losses ``(batch,)`` like BSI and VDM.

Each random function is split into a part that draws and a part that takes
the draws, as in ``bsi.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .common import (ModelFn, broadcast_right, cut_rows, index_draws, mc_var, normal_draws, protect_const,
                     quantile_draws, resolve_device)
from .discretization import Discretization
from .distributions import discretized_normal_log_prob, normal_log_prob


@dataclasses.dataclass(frozen=True)
class BFN:
    """Bayesian Flow Network for continuous data.

    Args:
        sigma_1: Target output noise level at t=1 (must be < 1).
        k: Default number of sampling steps.
        x_min / x_max: Clipping range of x-predictions.
        t_min: Times below this produce a zero x-prediction (the flow
            distribution is degenerate at t=0).
    """

    data_shape: tuple[int, ...]
    sigma_1: float
    k: int = 50
    x_min: float = -1.0
    x_max: float = 1.0
    t_min: float = 1e-6
    low_discrepancy_sampling: bool = True
    discretization: Optional[Discretization] = None

    def __post_init__(self):
        object.__setattr__(self, "data_shape", tuple(self.data_shape))
        if not self.sigma_1 < 1.0:
            raise ValueError("`sigma_1 < 1` is required by the BFN formulas")

    @property
    def n_dim(self) -> int:
        return math.prod(self.data_shape)

    def default_schedule(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.linspace(0.0, 1.0, self.k + 1, dtype=dtype, device=device)

    # ------------------------------------------------------------------ ELBO

    def elbo(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
             n_recon_samples: int = 1, n_measure_samples: int = 1, *, estimate_var: bool = False):
        """Monte Carlo estimate of the continuous-time ELBO; returns
        ``(elbo, bits_per_dim, extra)`` per batch element."""
        draws = self.elbo_noise(generator, x, n_recon_samples, n_measure_samples)
        return self._elbo_on(model_fn, x, *draws, estimate_var=estimate_var)

    def elbo_noise(self, generator: torch.Generator, x: torch.Tensor, n_recon_samples: int = 1,
                   n_measure_samples: int = 1):
        """The draws of one ``elbo``: the reconstruction's standard normal
        ``(n_recon, batch, *data)``, then the latent loss's time quantiles
        ``(n_measure, batch)`` and standard normal ``(n_measure, batch, *data)``."""
        return (normal_draws(generator, x, n_recon_samples),
                quantile_draws(generator, x, n_measure_samples, self.low_discrepancy_sampling),
                normal_draws(generator, x, n_measure_samples))

    def _elbo_on(self, model_fn: ModelFn, x: torch.Tensor, recon_eps: torch.Tensor, t: torch.Tensor,
                 latent_eps: torch.Tensor, *, estimate_var: bool = False):
        """``elbo`` on given draws (:meth:`elbo_noise`'s)."""
        l_recon = self._reconstruction_loss_on(model_fn, x, recon_eps)
        l_latent = self._continuous_time_loss_on(model_fn, x, t, latent_eps)
        return self._assemble_elbo(l_recon, l_latent, recon_eps.shape[0], t.shape[0], estimate_var)

    def finite_elbo(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                    n_recon_samples: int = 1, n_measure_samples: int = 1, *,
                    t: Optional[torch.Tensor] = None, estimate_var: bool = False):
        """The n-step ELBO for a schedule ``t`` (the default one when None)."""
        n = self.k if t is None else t.shape[0] - 1
        recon_eps = normal_draws(generator, x, n_recon_samples)
        i = index_draws(generator, x, n_measure_samples, n)
        return self._finite_elbo_on(model_fn, x, recon_eps, i, normal_draws(generator, x, n_measure_samples), t=t,
                                    estimate_var=estimate_var)

    def _finite_elbo_on(self, model_fn: ModelFn, x: torch.Tensor, recon_eps: torch.Tensor, i: torch.Tensor,
                        latent_eps: torch.Tensor, *, t: Optional[torch.Tensor] = None, estimate_var: bool = False):
        """``finite_elbo`` on given draws: the reconstruction's standard
        normal, the step indices ``(n_measure, batch)`` and their normal."""
        l_recon = self._reconstruction_loss_on(model_fn, x, recon_eps)
        l_latent = self._discrete_time_loss_on(model_fn, x, i, latent_eps, t=t)
        return self._assemble_elbo(l_recon, l_latent, recon_eps.shape[0], i.shape[0], estimate_var)

    def _assemble_elbo(self, l_recon, l_latent, n_recon: int, n_measure: int, estimate_var: bool):
        elbo = -(l_recon.mean(dim=0) + l_latent.mean(dim=0))
        conversion_factor = -1.0 / (math.log(2.0) * self.n_dim)
        bpd = conversion_factor * elbo
        extra = {"l_recon": l_recon, "l_latent": l_latent}
        if estimate_var:
            if n_recon < 2 or n_measure < 2:
                raise ValueError("Need at least two samples of each to estimate variance")
            extra["bpd_var"] = conversion_factor**2 * (mc_var(l_recon, n_recon) + mc_var(l_latent, n_measure))
        return elbo, bpd, extra

    # ------------------------------------------------------------ loss parts

    def reconstruction_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                            n_samples: int = 1) -> torch.Tensor:
        """Negative reconstruction log-likelihood at t=1, ``(n_samples,
        batch)``, discretized by CDF differences when a discretization is set."""
        return self._reconstruction_loss_on(model_fn, x, normal_draws(generator, x, n_samples))

    def _reconstruction_loss_on(self, model_fn: ModelFn, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        n, batch = eps.shape[:2]
        t = protect_const(torch.ones((n, batch), dtype=x.dtype, device=x.device))
        mu = self._flow(x, t, eps)
        x_hat = self._predict_x_flat(model_fn, mu, t)
        scale = torch.tensor(self.sigma_1, dtype=x.dtype, device=x.device)
        if self.discretization is None:
            log_p = normal_log_prob(x[None], x_hat, scale)
        else:
            log_p = discretized_normal_log_prob(x[None], x_hat, scale, self.discretization)
        return -log_p.reshape(n, batch, -1).sum(-1)

    def discrete_time_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                           n_samples: int = 1, *, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The n-step latent loss, ``(n_samples, batch)``: a uniformly drawn
        step ``i`` of the schedule ``t`` (the default one when None) per sample."""
        n = self.k if t is None else t.shape[0] - 1
        i = index_draws(generator, x, n_samples, n)
        return self._discrete_time_loss_on(model_fn, x, i, normal_draws(generator, x, n_samples), t=t)

    def _discrete_time_loss_on(self, model_fn: ModelFn, x: torch.Tensor, i: torch.Tensor, eps: torch.Tensor,
                               *, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if t is None:
            t = self.default_schedule(x.dtype, x.device)
        t = t.to(device=x.device, dtype=x.dtype)
        n = t.shape[0] - 1
        n_samples, batch = i.shape
        t_i = t[i]
        mu = self._flow(x, t_i, eps)
        x_hat = self._predict_x_flat(model_fn, mu, t_i)
        decoding_error = ((x[None] - x_hat) ** 2).reshape(n_samples, batch, -1).sum(-1)
        s1 = self.sigma_1
        return 0.5 * n * (1 - s1 ** (2.0 / n)) * (s1 ** ((-2.0 / n) * (i + 1).to(x.dtype)) * decoding_error)

    def continuous_time_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                             n_samples: int = 1) -> torch.Tensor:
        """The continuous-time latent loss, ``(n_samples, batch)``."""
        t = quantile_draws(generator, x, n_samples, self.low_discrepancy_sampling)
        return self._continuous_time_loss_on(model_fn, x, t, normal_draws(generator, x, n_samples))

    def _continuous_time_loss_on(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                                 eps: torch.Tensor) -> torch.Tensor:
        n_samples, batch = t.shape
        mu = self._flow(x, t, eps)
        x_hat = self._predict_x_flat(model_fn, mu, t)
        decoding_error = ((x[None] - x_hat) ** 2).reshape(n_samples, batch, -1).sum(-1)
        s1 = self.sigma_1
        return -math.log(s1) * (s1 ** (-2.0 * t) * decoding_error)

    # ---------------------------------------------------------------- training

    def train_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """Per-example training loss, shape ``(batch,)``: one sample of the
        continuous-time loss without constant factors, mean over data dims."""
        return self._train_loss_on(model_fn, x, *self.train_noise(generator, x))

    def train_noise(self, generator: torch.Generator, x: torch.Tensor):
        """The draws of one ``train_loss``: the time quantiles ``t`` [batch]
        and the standard normal ``eps`` of x's shape."""
        return quantile_draws(generator, x, 1, self.low_discrepancy_sampling)[0], normal_draws(generator, x, 1)[0]

    def _train_loss_on(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
        mu = self._flow(x, t, eps)
        x_hat = self._predict_x(model_fn, mu, t)
        decoding_error = ((x - x_hat) ** 2).reshape(x.shape[0], -1).mean(-1)
        return self.sigma_1 ** (-2.0 * t) * decoding_error

    # -------------------------------------------------------------- sampling

    def sample(self, model_fn: ModelFn, generator: torch.Generator, n_samples: int, *,
               device: torch.device | str | None = None, t: Optional[torch.Tensor] = None,
               dtype=torch.float32, rows: Optional[slice] = None) -> torch.Tensor:
        """The additive-accuracy sampler along ``t`` (the default schedule
        when None), on ``device`` (the card when None), the generator's
        device; ``rows`` as :meth:`BSI.sample <bsi_torch.core.bsi.BSI.sample>`."""
        with torch.inference_mode():
            t, step_eps = self._noise(generator, n_samples, device, t, dtype, rows)
            n = len(range(n_samples)[rows]) if rows is not None else n_samples
            mu, _ = self._sample_loop(model_fn, n, step_eps, t)
            return self._predict_x(model_fn, mu, protect_const(t.new_ones((n,))))

    def sample_history(self, model_fn: ModelFn, generator: torch.Generator, n_samples: int, *,
                       device: torch.device | str | None = None, t: Optional[torch.Tensor] = None,
                       dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Draw samples and return ``(mus, x_hats, ys)`` of shapes
        ``(k+1, n, *data)``, ``(k+1, n, *data)`` and ``(k, n, *data)``, as BSI."""
        with torch.inference_mode():
            t, step_eps = self._noise(generator, n_samples, device, t, dtype)
            mu, (mus, x_hats, ys) = self._sample_loop(model_fn, n_samples, step_eps, t, with_history=True)
            final_x_hat = self._predict_x(model_fn, mu, protect_const(t.new_ones((n_samples,))))
            return torch.stack(mus), torch.stack(x_hats + [final_x_hat]), torch.stack(ys)

    def _noise(self, generator, n_samples, device, t, dtype, rows: Optional[slice] = None):
        """Schedule and the step noise of one sampling run (its ``rows`` alone
        when given)."""
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(f"generator lives on {generator.device}, sampling runs on {device}")
        t = self.default_schedule(dtype, device) if t is None else t.to(device=device, dtype=dtype)
        shape = (n_samples,) + self.data_shape
        return t, lambda i: cut_rows(torch.randn(shape, generator=generator, dtype=dtype, device=device), rows)

    def _sample_loop(self, model_fn: ModelFn, n_samples: int, step_eps, t: torch.Tensor, *,
                     with_history: bool = False):
        """The update loop on given noise, ``step_eps(i)`` the measurement
        noise of step ``i``, from ``mu = 0`` at precision ``rho = 1``. Returns
        ``(mu_final, history)``: None or the lists ``(mus, x_hats, ys)``,
        ``mus`` starting with the initial belief."""
        s1 = self.sigma_1
        alphas = (s1 ** (-2.0 * t[1:])) * (1.0 - s1 ** (2.0 * torch.diff(t)))
        mu = torch.zeros((n_samples,) + self.data_shape, dtype=t.dtype, device=t.device)
        rho = torch.ones((), dtype=t.dtype, device=t.device)
        mus, x_hats, ys = [mu], [], []
        for i in range(t.shape[0] - 1):
            x_hat = self._predict_x(model_fn, mu, t[i].expand(n_samples))
            y = x_hat + torch.rsqrt(alphas[i]) * step_eps(i)
            mu = (rho * mu + alphas[i] * y) / (rho + alphas[i])
            rho = rho + alphas[i]
            if with_history:
                mus.append(mu)
                x_hats.append(x_hat)
                ys.append(y)
        return mu, ((mus, x_hats, ys) if with_history else None)

    # --------------------------------------------------------------- internals

    def _predict_x(self, model_fn: ModelFn, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The eps-prediction as a clipped x-prediction; zero below ``t_min``."""
        eps_hat = model_fn(mu, t)
        gamma = 1.0 - self.sigma_1 ** (2.0 * torch.clamp(t, min=self.t_min))
        x_hat = mu / broadcast_right(gamma, mu) - broadcast_right(torch.sqrt((1.0 - gamma) / gamma), eps_hat) * eps_hat
        x_hat = torch.clamp(x_hat, self.x_min, self.x_max)
        return torch.where(broadcast_right(t < self.t_min, x_hat), 0.0, x_hat)

    def _predict_x_flat(self, model_fn: ModelFn, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``_predict_x`` over ``(n_samples, batch, *data)`` via one flat model call."""
        n, b = mu.shape[:2]
        out = self._predict_x(model_fn, mu.reshape((n * b,) + mu.shape[2:]), t.reshape(-1))
        return out.reshape((n, b) + out.shape[1:])

    def _sample_flow_distribution(self, generator: torch.Generator, x: torch.Tensor,
                                  t: torch.Tensor) -> torch.Tensor:
        """Sample the flow distribution ``p_F(mu | x, t)`` for ``t`` of shape ``(..., batch)``."""
        eps = torch.randn(t.shape + self.data_shape, generator=generator, dtype=x.dtype, device=x.device)
        return self._flow(x, t, eps)

    def _flow(self, x: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        x_b = x.reshape((1,) * (t.ndim - 1) + x.shape)
        gamma = 1.0 - self.sigma_1 ** (2.0 * t)
        return broadcast_right(gamma, x_b) * x_b + broadcast_right(torch.sqrt(gamma * (1.0 - gamma)), eps) * eps
