"""Variational Diffusion Models (VDM) baseline.

Counterpart of ``bsi_tpu/core/vdm.py`` (arXiv:2107.00630), with the same
public surface as :class:`~bsi_torch.core.bsi.BSI`. The model predicts
*epsilon*; time runs 1 -> 0 (the opposite of BSI). The ancestral step uses
the log-space softplus identities of the JAX package, and JAX's
``lax.scan`` over the schedule is a Python loop.

Each random function is split into a part that draws and a part that takes
the draws, as in ``bsi.py``: ``train_loss`` over ``train_noise`` and
``_train_loss_on``, ``elbo`` over ``elbo_noise`` and ``_elbo_on``, each loss
part over its ``_..._on``, and the sampler over ``_sample_loop``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .common import (ModelFn, broadcast_right, cut_rows, index_draws, mc_var, normal_draws, quantile_draws,
                     resolve_device)
from .discretization import Discretization
from .distributions import normal_log_prob


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, JAX's formula (torch's
    ``softplus`` switches to ``x`` above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class VDM:
    """Variational Diffusion Model with a linear ``gamma(t)`` noise schedule.

    ``gamma`` interpolates between ``-log(snr_max)`` at t=0 and
    ``-log(snr_min)`` at t=1.
    """

    data_shape: tuple[int, ...]
    snr_min: float
    snr_max: float
    k: int = 50
    low_discrepancy_sampling: bool = True
    discretization: Optional[Discretization] = None

    def __post_init__(self):
        object.__setattr__(self, "data_shape", tuple(self.data_shape))

    @property
    def gamma_0(self) -> float:
        return -math.log(self.snr_max)

    @property
    def gamma_1(self) -> float:
        return -math.log(self.snr_min)

    @property
    def n_dim(self) -> int:
        return math.prod(self.data_shape)

    def default_schedule(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Sampling-time schedule; time runs 1 -> 0 for VDM."""
        return torch.linspace(1.0, 0.0, self.k + 1, dtype=dtype, device=device)

    # --------------------------------------------------------------- schedule

    def gamma(self, t: torch.Tensor) -> torch.Tensor:
        return self.gamma_0 + (self.gamma_1 - self.gamma_0) * t

    def sigma2(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.gamma(t))

    def alpha(self, t: torch.Tensor) -> torch.Tensor:
        # sqrt(1 - sigma2) through sigmoid(-gamma): no cancellation near t=1
        return torch.sqrt(torch.sigmoid(-self.gamma(t)))

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        return torch.exp(-self.gamma(t))

    # ------------------------------------------------------------------ ELBO

    def elbo(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
             n_recon_samples: int = 1, n_measure_samples: int = 1, *, estimate_var: bool = False):
        """Monte Carlo estimate of the infinite-step ELBO (prior + recon +
        diffusion); returns ``(elbo, bits_per_dim, extra)`` per batch element."""
        draws = self.elbo_noise(generator, x, n_recon_samples, n_measure_samples)
        return self._elbo_on(model_fn, x, *draws, estimate_var=estimate_var)

    def elbo_noise(self, generator: torch.Generator, x: torch.Tensor, n_recon_samples: int = 1,
                   n_measure_samples: int = 1):
        """The draws of one ``elbo``: the reconstruction's standard normal
        ``(n_recon, batch, *data)``, then the diffusion's time quantiles
        ``(n_measure, batch)`` and standard normal ``(n_measure, batch, *data)``."""
        return (normal_draws(generator, x, n_recon_samples),
                quantile_draws(generator, x, n_measure_samples, self.low_discrepancy_sampling),
                normal_draws(generator, x, n_measure_samples))

    def _elbo_on(self, model_fn: ModelFn, x: torch.Tensor, recon_eps: torch.Tensor, t: torch.Tensor,
                 diff_eps: torch.Tensor, *, estimate_var: bool = False):
        """``elbo`` on given draws (:meth:`elbo_noise`'s)."""
        l_recon = self._reconstruction_loss_on(x, recon_eps)
        l_diff = self._inf_diffusion_loss_on(model_fn, x, t, diff_eps)
        return self._assemble_elbo(self.prior_loss(x), l_recon, l_diff, recon_eps.shape[0], t.shape[0],
                                   estimate_var)

    def finite_elbo(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                    n_recon_samples: int = 1, n_measure_samples: int = 1, *,
                    t: Optional[torch.Tensor] = None, estimate_var: bool = False):
        """The finite-step ELBO for a schedule ``t`` (the default one when None)."""
        T = self.k if t is None else t.shape[0] - 1
        recon_eps = normal_draws(generator, x, n_recon_samples)
        i = index_draws(generator, x, n_measure_samples, T)
        return self._finite_elbo_on(model_fn, x, recon_eps, i, normal_draws(generator, x, n_measure_samples), t=t,
                                    estimate_var=estimate_var)

    def _finite_elbo_on(self, model_fn: ModelFn, x: torch.Tensor, recon_eps: torch.Tensor, i: torch.Tensor,
                        diff_eps: torch.Tensor, *, t: Optional[torch.Tensor] = None, estimate_var: bool = False):
        """``finite_elbo`` on given draws: the reconstruction's standard
        normal, the step indices ``(n_measure, batch)`` and their normal."""
        l_recon = self._reconstruction_loss_on(x, recon_eps)
        l_diff = self._finite_diffusion_loss_on(model_fn, x, i, diff_eps, t=t)
        return self._assemble_elbo(self.prior_loss(x), l_recon, l_diff, recon_eps.shape[0], i.shape[0],
                                   estimate_var)

    def _assemble_elbo(self, l_prior, l_recon, l_diff, n_recon: int, n_measure: int, estimate_var: bool):
        elbo = -(l_prior + l_recon.mean(dim=0) + l_diff.mean(dim=0))
        conversion_factor = -1.0 / (math.log(2.0) * self.n_dim)
        bpd = conversion_factor * elbo
        extra = {"l_prior": l_prior, "l_recon": l_recon, "l_diff": l_diff}
        if estimate_var:
            if n_recon < 2 or n_measure < 2:
                raise ValueError("Need at least two samples of each to estimate variance")
            extra["bpd_var"] = conversion_factor**2 * (mc_var(l_recon, n_recon) + mc_var(l_diff, n_measure))
        return elbo, bpd, extra

    # ------------------------------------------------------------ loss parts

    def prior_loss(self, x: torch.Tensor) -> torch.Tensor:
        """KL(q(z_1|x) || N(0, 1)) per batch element."""
        var_1 = self.sigma2(torch.ones((), dtype=x.dtype, device=x.device))
        per_dim = var_1 + (1 - var_1) * torch.square(x) - torch.log(var_1) - 1
        return 0.5 * per_dim.reshape(x.shape[0], -1).sum(-1)

    def reconstruction_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                            n_samples: int = 1) -> torch.Tensor:
        """Negative reconstruction log-likelihood, ``(n_samples, batch)``.

        The model is not called: x is read back from z_0 directly. With a
        discretization the Normal is evaluated at every bin center and
        normalised by a log-softmax over the bins, as in the JAX package.
        """
        return self._reconstruction_loss_on(x, normal_draws(generator, x, n_samples))

    def _reconstruction_loss_on(self, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        n = eps.shape[0]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        alpha_0 = self.alpha(zero)
        std = torch.sqrt(self.sigma2(zero))
        z_0 = alpha_0 * x[None] + std * eps
        x_hat = z_0 / alpha_0
        scale = std / alpha_0
        if self.discretization is None:
            log_p = normal_log_prob(x[None], x_hat, scale)
        else:
            # the bins go in the trailing dim, the softmax's reduction
            centers = self.discretization.bin_centers(x.dtype, x.device)
            log_p_binned = torch.log_softmax(normal_log_prob(centers, x_hat[..., None], scale), dim=-1)
            x_idx = self.discretization.bucketize(x)
            log_p = torch.gather(log_p_binned, -1, x_idx[None].expand(x_hat.shape)[..., None])[..., 0]
        return -log_p.reshape(n, x.shape[0], -1).sum(-1)

    def finite_diffusion_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                              n_samples: int = 1, *, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Diffusion loss of the finite-step ELBO, ``(n_samples, batch)``: a
        uniformly drawn step ``i`` of the schedule ``t`` per sample."""
        T = self.k if t is None else t.shape[0] - 1
        i = index_draws(generator, x, n_samples, T)
        return self._finite_diffusion_loss_on(model_fn, x, i, normal_draws(generator, x, n_samples), t=t)

    def _finite_diffusion_loss_on(self, model_fn: ModelFn, x: torch.Tensor, i: torch.Tensor, eps: torch.Tensor,
                                  *, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if t is None:
            t = self.default_schedule(x.dtype, x.device)
        t = t.to(device=x.device, dtype=x.dtype)
        T = t.shape[0] - 1
        n, batch = i.shape
        s_i, t_i = t[i + 1], t[i]
        z_t = self._zt_given_x(x, t_i, eps)
        x_hat = self._predict_x_flat(model_fn, z_t, t_i)
        decoding_error = ((x[None] - x_hat) ** 2).reshape(n, batch, -1).sum(-1)
        return 0.5 * T * (self.snr(s_i) - self.snr(t_i)) * decoding_error

    def inf_diffusion_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                           n_samples: int = 1) -> torch.Tensor:
        """Diffusion loss of the infinite-step ELBO, ``(n_samples, batch)``."""
        t = quantile_draws(generator, x, n_samples, self.low_discrepancy_sampling)
        return self._inf_diffusion_loss_on(model_fn, x, t, normal_draws(generator, x, n_samples))

    def _inf_diffusion_loss_on(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                               eps: torch.Tensor) -> torch.Tensor:
        n, batch = t.shape
        z_t = self._zt_given_x(x, t, eps)
        x_hat = self._predict_x_flat(model_fn, z_t, t)
        decoding_error = ((x[None] - x_hat) ** 2).reshape(n, batch, -1).sum(-1)
        # gamma is linear in t, so d(snr)/dt is available in closed form
        dsnr_t_dt = -self.snr(t) * (self.gamma_0 - self.gamma_1)
        return 0.5 * dsnr_t_dt * decoding_error

    # ---------------------------------------------------------------- training

    def train_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """Per-example training loss, shape ``(batch,)``: one sample of the
        infinite-step diffusion loss with a mean over data dims."""
        return self._train_loss_on(model_fn, x, *self.train_noise(generator, x))

    def train_noise(self, generator: torch.Generator, x: torch.Tensor):
        """The draws of one ``train_loss``: the time quantiles ``t`` [batch]
        and the standard normal ``eps`` of x's shape."""
        return quantile_draws(generator, x, 1, self.low_discrepancy_sampling)[0], normal_draws(generator, x, 1)[0]

    def _train_loss_on(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
        return self._inf_diffusion_loss_on(model_fn, x, t[None], eps[None])[0] / self.n_dim

    # -------------------------------------------------------------- sampling

    def sample(self, model_fn: ModelFn, generator: torch.Generator, n_samples: int, *,
               device: torch.device | str | None = None, t: Optional[torch.Tensor] = None,
               dtype=torch.float32, rows: Optional[slice] = None) -> torch.Tensor:
        """Ancestral sampling along ``t`` (the default schedule when None), on
        ``device`` (the card when None), the generator's device; ``rows`` as
        :meth:`BSI.sample <bsi_torch.core.bsi.BSI.sample>`."""
        with torch.inference_mode():
            t, z, step_eps = self._noise(generator, n_samples, device, t, dtype, rows)
            z, _ = self._sample_loop(model_fn, z, step_eps, t)
            return z / self.alpha(t.new_zeros(()))

    def sample_history(self, model_fn: ModelFn, generator: torch.Generator, n_samples: int, *,
                       device: torch.device | str | None = None, t: Optional[torch.Tensor] = None,
                       dtype=torch.float32) -> torch.Tensor:
        """Draw samples and return the ``(k+1, n, *data)`` trajectory: the
        x_hat of every step, then the sample."""
        with torch.inference_mode():
            t, z, step_eps = self._noise(generator, n_samples, device, t, dtype)
            z, x_hats = self._sample_loop(model_fn, z, step_eps, t, with_history=True)
            return torch.stack(x_hats + [z / self.alpha(t.new_zeros(()))])

    def _noise(self, generator, n_samples, device, t, dtype, rows: Optional[slice] = None):
        """Schedule, the initial latent and the step noise of one sampling run
        (their ``rows`` alone when given)."""
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(f"generator lives on {generator.device}, sampling runs on {device}")
        t = self.default_schedule(dtype, device) if t is None else t.to(device=device, dtype=dtype)
        shape = (n_samples,) + self.data_shape
        draw = lambda: cut_rows(torch.randn(shape, generator=generator, dtype=dtype, device=device), rows)
        z = draw()
        return t, z, lambda i: draw()

    def _sample_loop(self, model_fn: ModelFn, z: torch.Tensor, step_eps, t: torch.Tensor, *,
                     with_history: bool = False):
        """The ancestral loop on given noise: ``z`` the latent at ``t[0]`` and
        ``step_eps(i)`` the noise of step ``i``. Returns ``(z at t[-1],
        x_hats)``, the list of each step's x_hat or None."""
        n_samples = z.shape[0]
        x_hats = []
        for i in range(t.shape[0] - 1):
            tb, sb = t[i].expand(n_samples), t[i + 1].expand(n_samples)
            x_hat = self._predict_x(model_fn, z, tb)
            z = self._zs_given_zt_x(sb, z, tb, x_hat, step_eps(i))
            if with_history:
                x_hats.append(x_hat)
        return z, (x_hats if with_history else None)

    # --------------------------------------------------------------- internals

    def _predict_x(self, model_fn: ModelFn, z_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The model's eps-prediction as an x-prediction."""
        eps_hat = model_fn(z_t, t)
        sigma = torch.sqrt(self.sigma2(t))
        return (z_t - broadcast_right(sigma, z_t) * eps_hat) / broadcast_right(self.alpha(t), z_t)

    def _predict_x_flat(self, model_fn: ModelFn, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``_predict_x`` over ``(n_samples, batch, *data)`` via one flat model call."""
        n, b = z.shape[:2]
        out = self._predict_x(model_fn, z.reshape((n * b,) + z.shape[2:]), t.reshape(-1))
        return out.reshape((n, b) + out.shape[1:])

    def _sample_zt_given_x(self, generator: torch.Generator, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Sample the forward marginal ``q(z_t | x)`` for ``t`` of shape ``(..., batch)``."""
        eps = torch.randn(t.shape + self.data_shape, generator=generator, dtype=x.dtype, device=x.device)
        return self._zt_given_x(x, t, eps)

    def _zt_given_x(self, x: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        x_b = x.reshape((1,) * (t.ndim - 1) + x.shape)
        return broadcast_right(self.alpha(t), x_b) * x_b + broadcast_right(torch.sqrt(self.sigma2(t)), eps) * eps

    def _zs_given_zt_x(self, s: torch.Tensor, z_t: torch.Tensor, t: torch.Tensor, x: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
        """One ancestral step ``q(z_s | z_t, x)`` on the standard normal
        ``eps``, in log space for stability."""
        sp = _softplus
        g_s, g_t = self.gamma(s), self.gamma(t)
        sigma2_ts_over_sigma2_t = -torch.expm1(sp(-g_t) - sp(g_t) - sp(-g_s) + sp(g_s))
        z_coef = torch.exp(0.5 * (sp(g_s) - sp(g_t)) + sp(-g_t) - sp(-g_s))
        mean = broadcast_right(z_coef, z_t) * z_t + broadcast_right(self.alpha(s) * sigma2_ts_over_sigma2_t, x) * x
        std = torch.sqrt(self.sigma2(s) * sigma2_ts_over_sigma2_t)
        return mean + broadcast_right(std, eps) * eps
