"""Bayesian Sample Inference (BSI): the training loss and the samplers.

PyTorch counterpart of ``bsi_tpu/core/bsi.py``. The class is a frozen
dataclass of hyperparameters acting on a ``model_fn(mu, t)`` callable, as in
the JAX package. Randomness comes from an explicit ``torch.Generator`` where
JAX threads a key, and JAX's ``lax.scan`` over the schedule is a Python loop
(eager PyTorch launches each step's kernels directly).

Each random function is split into a part that draws and a part that takes
the draws (``train_loss`` over ``_train_loss_on``, ``elbo`` over
``_elbo_on``, each loss part over its ``_..._on``, ``_sample_loop``), so
the tests can feed JAX's own draws to the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from bsi_torch.utils import profiling

from .common import (ModelFn, broadcast_right, cut_rows, index_draws, mc_var, normal_draws, protect_const,
                     quantile_draws, resolve_device, sample_lds_t)
from .discretization import Discretization
from .distributions import LogUniform, discretized_normal_log_prob, normal_log_prob

# Noise of one sampling step: step index -> standard normal of the sample shape.
StepNoise = Callable[[int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BSI:
    """Bayesian Sample Inference.

    The generative model maintains a Gaussian belief ``N(mu, 1/lambda)`` over
    the data sample and refines it through simulated noisy measurements of
    increasing precision.

    Args:
        data_shape: Per-sample data shape, e.g. ``(32, 32, 3)`` for CIFAR-10
            (images are NHWC, as in the JAX package).
        lambda_0: Initial belief precision.
        alpha_M: Maximum total measurement precision (e.g. 1e6).
        alpha_R: Reconstruction precision.
        k: Default number of sampling steps.
        preconditioning: ``"edm"`` or ``None``.
        low_discrepancy_sampling: Low-discrepancy noise-level sampling for the
            training loss.
        discretization: Optional data discretization for bits-per-dim.
    """

    data_shape: tuple[int, ...]
    lambda_0: float
    alpha_M: float
    alpha_R: float
    k: int = 50
    preconditioning: Optional[str] = "edm"
    low_discrepancy_sampling: bool = True
    discretization: Optional[Discretization] = None

    def __post_init__(self):
        object.__setattr__(self, "data_shape", tuple(self.data_shape))
        if self.preconditioning not in (None, "edm"):
            raise ValueError(f"Unknown preconditioning {self.preconditioning!r}")

    @property
    def p_lambda(self) -> LogUniform:
        """Noise-precision distribution p(lambda) on [lambda_0, lambda_0 + alpha_M]."""
        return LogUniform(self.lambda_0, self.lambda_0 + self.alpha_M)

    @property
    def n_dim(self) -> int:
        return math.prod(self.data_shape)

    def default_schedule(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.linspace(0.0, 1.0, self.k + 1, dtype=dtype, device=device)

    # ------------------------------------------------------------------ ELBO

    def elbo(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
             n_recon_samples: int = 1, n_measure_samples: int = 1, *, estimate_var: bool = False):
        """Monte Carlo estimate of the infinite-step ELBO.

        Returns ``(elbo, bits_per_dim, extra)``, each per batch element;
        ``extra`` carries the per-sample loss parts ``l_recon`` and
        ``l_measure`` (and the estimator variance of the bpd, ``bpd_var``,
        when ``estimate_var`` is set). ``generator`` lives on x's device.
        """
        draws = self.elbo_noise(generator, x, n_recon_samples, n_measure_samples)
        return self._elbo_on(model_fn, x, *draws, estimate_var=estimate_var)

    def elbo_noise(self, generator: torch.Generator, x: torch.Tensor, n_recon_samples: int = 1,
                   n_measure_samples: int = 1):
        """The draws of one ``elbo``: the reconstruction's standard normal
        ``(n_recon, batch, *data)``, then the measurement's time quantiles
        ``(n_measure, batch)`` and standard normal ``(n_measure, batch, *data)``."""
        return (normal_draws(generator, x, n_recon_samples),
                *self._inf_measurement_noise(generator, x, n_measure_samples))

    def _elbo_on(self, model_fn: ModelFn, x: torch.Tensor, recon_eps: torch.Tensor, t: torch.Tensor,
                 measure_eps: torch.Tensor, *, estimate_var: bool = False):
        """``elbo`` on given draws (:meth:`elbo_noise`'s)."""
        l_recon = self._reconstruction_loss_on(model_fn, x, recon_eps)
        l_measure = self._inf_measurement_loss_on(model_fn, x, t, measure_eps)
        return self._assemble_elbo(l_recon, l_measure, recon_eps.shape[0], t.shape[0], estimate_var)

    def finite_elbo(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                    n_recon_samples: int = 1, n_measure_samples: int = 1, *,
                    t: Optional[torch.Tensor] = None, estimate_var: bool = False):
        """Monte Carlo estimate of the finite-step ELBO for a step schedule
        ``t`` (the default schedule when None); returns as :meth:`elbo`."""
        l_recon = self.reconstruction_loss(model_fn, generator, x, n_recon_samples)
        l_measure = self.finite_measurement_loss(model_fn, generator, x, n_measure_samples, t=t)
        return self._assemble_elbo(l_recon, l_measure, n_recon_samples, n_measure_samples, estimate_var)

    def _assemble_elbo(self, l_recon, l_measure, n_recon: int, n_measure: int, estimate_var: bool):
        elbo = -(l_recon.mean(dim=0) + l_measure.mean(dim=0))
        conversion_factor = -1.0 / (math.log(2.0) * self.n_dim)
        bpd = conversion_factor * elbo
        extra = {"l_recon": l_recon, "l_measure": l_measure}
        if estimate_var:
            if n_recon < 2 or n_measure < 2:
                raise ValueError("Need at least two samples of each to estimate variance")
            extra["bpd_var"] = conversion_factor**2 * (mc_var(l_recon, n_recon) + mc_var(l_measure, n_measure))
        return elbo, bpd, extra

    # ------------------------------------------------------------ loss parts

    def reconstruction_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                            n_samples: int = 1) -> torch.Tensor:
        """Sampled negative reconstruction log-likelihood, ``(n_samples, batch)``.

        The belief is pushed to full precision ``lambda_0 + alpha_M``, decoded
        at t=1, and the data scored under a Normal(x_hat, 1/sqrt(alpha_R)),
        discretized into bins when a discretization is configured.
        """
        return self._reconstruction_loss_on(model_fn, x, normal_draws(generator, x, n_samples))

    def _reconstruction_loss_on(self, model_fn: ModelFn, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        n, batch = eps.shape[:2]
        lambda_M = torch.full((n, batch), self.lambda_0 + self.alpha_M, dtype=x.dtype, device=x.device)
        mu = self._q_mu_lambda(x, lambda_M, eps)
        x_hat = self._predict_x_flat(model_fn, mu, protect_const(torch.ones_like(lambda_M)))
        scale = torch.tensor(1.0 / math.sqrt(self.alpha_R), dtype=x.dtype, device=x.device)
        if self.discretization is None:
            log_p = normal_log_prob(x[None], x_hat, scale)
        else:
            log_p = discretized_normal_log_prob(x[None], x_hat, scale, self.discretization)
        return -log_p.reshape(n, batch, -1).sum(-1)

    def inf_measurement_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                             n_samples: int = 1) -> torch.Tensor:
        """Sampled measurement loss of the infinite-step ELBO, ``(n_samples,
        batch)``, importance-sampled over ``lambda ~ p(lambda)``."""
        return self._inf_measurement_loss_on(model_fn, x, *self._inf_measurement_noise(generator, x, n_samples))

    def _inf_measurement_noise(self, generator: torch.Generator, x: torch.Tensor, n_samples: int):
        t = quantile_draws(generator, x, n_samples, self.low_discrepancy_sampling)
        return t, normal_draws(generator, x, n_samples)

    def _inf_measurement_loss_on(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                                 eps: torch.Tensor) -> torch.Tensor:
        """The model sees ``p_lambda.cdf(p_lambda.icdf(t))``, as in ``train_loss``."""
        n, batch = t.shape
        lambda_ = self.p_lambda.icdf(t)
        mu = self._q_mu_lambda(x, lambda_, eps)
        x_hat = self._predict_x_flat(model_fn, mu, self.p_lambda.cdf(lambda_))
        decoding_error = ((x[None] - x_hat) ** 2).reshape(n, batch, -1).sum(-1)
        return 0.5 * self.p_lambda.reciprocal_pdf(lambda_) * decoding_error

    def finite_measurement_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor,
                                n_samples: int = 1, *, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sampled measurement loss of the finite-step ELBO, ``(n_samples,
        batch)``: a uniformly drawn step ``i`` of the schedule ``t`` per
        sample."""
        k = self.k if t is None else t.shape[0] - 1
        i = index_draws(generator, x, n_samples, k)
        return self._finite_measurement_loss_on(model_fn, x, i, normal_draws(generator, x, n_samples), t=t)

    def _finite_measurement_loss_on(self, model_fn: ModelFn, x: torch.Tensor, i: torch.Tensor,
                                    eps: torch.Tensor, *, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if t is None:
            t = self.default_schedule(x.dtype, x.device)
        t = t.to(device=x.device, dtype=x.dtype)
        lambda_ = self.p_lambda.icdf(t)
        alpha = torch.diff(lambda_)
        n, batch = i.shape
        mu = self._q_mu_lambda(x, lambda_[i], eps)
        x_hat = self._predict_x_flat(model_fn, mu, t[i])
        decoding_error = ((x[None] - x_hat) ** 2).reshape(n, batch, -1).sum(-1)
        return (0.5 * alpha.shape[0]) * alpha[i] * decoding_error

    # ---------------------------------------------------------------- training

    def train_loss(self, model_fn: ModelFn, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """Per-example training loss, shape ``(batch,)``.

        A 1-sample estimate of the infinite-step ELBO measurement term with a
        mean over data dimensions (instead of a sum) and without constant
        factors. ``generator`` lives on x's device.
        """
        t, eps = self.train_noise(generator, x)
        return self._train_loss_on(model_fn, x, t, eps)

    def train_noise(self, generator: torch.Generator, x: torch.Tensor):
        """The draws of one ``train_loss``: the time quantiles ``t`` [batch]
        and the standard normal ``eps`` of x's shape."""
        return quantile_draws(generator, x, 1, self.low_discrepancy_sampling)[0], normal_draws(generator, x, 1)[0]

    def _train_loss_on(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
        """``train_loss`` on given draws. The model sees
        ``p_lambda.cdf(p_lambda.icdf(t))``, as in the JAX package, which
        differs from ``t`` in the last bits."""
        lambda_ = self.p_lambda.icdf(t)
        mu = self._q_mu_lambda(x, lambda_, eps)
        x_hat = self._predict_x(model_fn, mu, self.p_lambda.cdf(lambda_))
        decoding_error = ((x - x_hat) ** 2).reshape(x.shape[0], -1).mean(-1)
        return self.p_lambda.reciprocal_pdf(lambda_) * decoding_error

    def _sample_lambda(self, generator: torch.Generator, n_samples: int, batch_size: int,
                       dtype) -> torch.Tensor:
        """Sample noise precisions ``lambda ~ p(lambda)``, shape ``(n_samples, batch)``."""
        t = sample_lds_t(generator, n_samples, batch_size,
                         low_discrepancy=self.low_discrepancy_sampling, dtype=dtype)
        return self.p_lambda.icdf(t)

    def _sample_q_mu_lambda(self, generator: torch.Generator, x: torch.Tensor,
                            lambda_: torch.Tensor) -> torch.Tensor:
        """Sample the posterior-mean belief ``mu ~ q(mu | x, lambda)``."""
        eps = torch.randn(lambda_.shape + self.data_shape, generator=generator, dtype=x.dtype,
                          device=x.device)
        return self._q_mu_lambda(x, lambda_, eps)

    def _q_mu_lambda(self, x: torch.Tensor, lambda_: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """``mu = (lambda - lambda_0) / lambda * x + eps / sqrt(lambda)``.

        ``lambda_`` has shape ``(..., batch)`` and ``eps`` that shape plus the
        data shape; x broadcasts to it.
        """
        x_b = x.reshape((1,) * (lambda_.ndim - 1) + x.shape)
        mean_coef = (lambda_ - self.lambda_0) / lambda_
        return broadcast_right(mean_coef, x_b) * x_b + broadcast_right(torch.rsqrt(lambda_), eps) * eps

    # -------------------------------------------------------------- sampling

    def sample(
        self,
        model_fn: ModelFn,
        generator: torch.Generator,
        n_samples: int,
        *,
        device: torch.device | str | None = None,
        t: Optional[torch.Tensor] = None,
        dtype=torch.float32,
        rows: Optional[slice] = None,
    ) -> torch.Tensor:
        """Draw ``n_samples`` samples via the k-step Bayesian update loop.

        Each step decodes ``x_hat``, simulates a measurement
        ``y = x_hat + eps / sqrt(alpha_i)`` and performs the precision-weighted
        belief update ``mu <- (alpha_i * y + lambda_i * mu) / lambda_{i+1}``.
        Runs on ``device`` (the card when ``None``), which must be the
        generator's device. With ``rows`` (a slice of ``range(n_samples)``)
        the noise is drawn for all ``n_samples`` and only those rows are
        sampled: the rows of the whole run, at their cost alone.
        """
        with torch.inference_mode():
            t, eps0, step_eps = self._noise(generator, n_samples, device, t, dtype, rows)
            mu, _ = self._sample_loop(model_fn, eps0, step_eps, t)
            with profiling.span("sample.denoise", device=mu.device):
                return self._predict_x(model_fn, mu, protect_const(t.new_ones((mu.shape[0],))))

    def sample_history(
        self,
        model_fn: ModelFn,
        generator: torch.Generator,
        n_samples: int,
        *,
        device: torch.device | str | None = None,
        t: Optional[torch.Tensor] = None,
        dtype=torch.float32,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Draw samples and return all intermediate states.

        Returns ``(mus, x_hats, ys)`` of shapes ``(k+1, n, *data)``,
        ``(k+1, n, *data)`` and ``(k, n, *data)``.
        """
        with torch.inference_mode():
            t, eps0, step_eps = self._noise(generator, n_samples, device, t, dtype)
            mu_final, (mus, x_hats, ys) = self._sample_loop(
                model_fn, eps0, step_eps, t, with_history=True
            )
            with profiling.span("sample.denoise", device=mu_final.device):
                final_x_hat = self._predict_x(
                    model_fn, mu_final, protect_const(t.new_ones((n_samples,)))
                )
            return (
                torch.stack(mus),
                torch.stack(x_hats + [final_x_hat]),
                torch.stack(ys),
            )

    def _noise(self, generator, n_samples, device, t, dtype, rows: Optional[slice] = None):
        """Schedule and the standard-normal draws of one sampling run (their
        ``rows`` alone when given)."""
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(
                f"generator lives on {generator.device}, sampling runs on {device}"
            )
        if t is None:
            t = self.default_schedule(dtype, device)
        t = t.to(device=device, dtype=dtype)
        shape = (n_samples,) + self.data_shape
        draw = lambda: cut_rows(torch.randn(shape, generator=generator, dtype=dtype, device=device), rows)
        eps0 = draw()
        return t, eps0, lambda i: draw()

    def _sample_loop(
        self,
        model_fn: ModelFn,
        eps0: torch.Tensor,
        step_eps: StepNoise,
        t: torch.Tensor,
        *,
        with_history: bool = False,
    ):
        """The update loop on given noise: ``eps0`` for the initial belief and
        ``step_eps(i)`` for the measurement of step ``i``.

        Returns ``(mu_final, history)``, where history is ``None`` or the
        lists ``(mus, x_hats, ys)``, ``mus`` starting with the initial belief.
        """
        lambda_ = self.p_lambda.icdf(t)
        alpha = torch.diff(lambda_)
        n_samples = eps0.shape[0]
        mu = torch.rsqrt(lambda_[0]) * eps0
        mus, x_hats, ys = [mu], [], []
        for i in range(alpha.shape[0]):
            with profiling.span("sample.step", i=i):
                with profiling.span("sample.denoise", device=mu.device):
                    x_hat = self._predict_x(model_fn, mu, t[i].expand(n_samples))
                y = x_hat + torch.rsqrt(alpha[i]) * step_eps(i)
                mu = (alpha[i] * y + lambda_[i] * mu) / lambda_[i + 1]
            if with_history:
                mus.append(mu)
                x_hats.append(x_hat)
                ys.append(y)
        return mu, ((mus, x_hats, ys) if with_history else None)

    # --------------------------------------------------------------- internals

    def _predict_x_flat(self, model_fn: ModelFn, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``_predict_x`` over a ``(n_samples, batch, *data)`` tensor via one flat model call."""
        n, b = mu.shape[:2]
        out = self._predict_x(model_fn, mu.reshape((n * b,) + mu.shape[2:]), t.reshape(-1))
        return out.reshape((n, b) + out.shape[1:])

    def _predict_x(self, model_fn: ModelFn, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Decode the belief mean into a data estimate, with optional preconditioning."""
        if self.preconditioning is None:
            return model_fn(mu, t)
        c_skip, c_out, c_in = self._edm_preconditioning(t)
        return broadcast_right(c_skip, mu) * mu + broadcast_right(c_out, mu) * model_fn(
            broadcast_right(c_in, mu) * mu, t
        )

    def _edm_preconditioning(self, t: torch.Tensor):
        """EDM-style preconditioning coefficients.

        ``kappa`` is written as ``1 + alpha * (alpha / lambda)`` to avoid
        squaring alpha (f32 overflow), as in the JAX package.
        """
        lambda_ = self.p_lambda.icdf(t)
        alpha = lambda_ - self.lambda_0
        kappa = 1.0 + alpha * (alpha / lambda_)
        c_skip = alpha / kappa
        c_out = torch.rsqrt(kappa)
        c_in = torch.sqrt(lambda_ / kappa)
        return c_skip, c_out, c_in
