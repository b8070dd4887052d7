"""Shared helpers for the algorithm cores.

Counterpart of ``bsi_tpu/core/common.py``. The cores act on a
``model_fn(mu, t) -> prediction`` callable; the caller binds the network,
its precision and its train/eval mode into it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# Uniform model contract shared by all algorithms:
#   model_fn(mu: [batch, *data_shape], t: [batch]) -> [batch, *data_shape]
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def protect_const(x: torch.Tensor) -> torch.Tensor:
    """Identity.

    The JAX package wraps constant timestep vectors in an optimization
    barrier to dodge an XLA:TPU compiler crash. Eager PyTorch has no such
    compiler pass, so there is nothing to protect against.
    """
    return x


def broadcast_right(x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Append trailing singleton dims to ``x`` so it broadcasts against ``other``."""
    if other.ndim < x.ndim:
        raise ValueError(f"cannot broadcast {tuple(x.shape)} against {tuple(other.shape)}")
    return x.reshape(x.shape + (1,) * (other.ndim - x.ndim))


def cut_rows(x: torch.Tensor, rows: Optional[slice]) -> torch.Tensor:
    """``x[rows]`` along the batch, or ``x`` itself when ``rows`` is None."""
    return x if rows is None else x[rows]


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names another.

    ``None`` means ``"cuda"``. Raises instead of carrying on on the CPU when
    there is no card.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bsi_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def lds_grid(perm: torch.Tensor, offset: torch.Tensor, n_samples: int, batch_size: int) -> torch.Tensor:
    """The stratified time quantiles of :func:`sample_lds_t` from its draws: a
    permutation ``perm`` of ``range(n_samples * batch_size)`` and one uniform
    ``offset``. Returns ``(n_samples, batch_size)`` in ``offset``'s dtype."""
    total = n_samples * batch_size
    grid = perm.to(offset.dtype) / (1 + total)
    # torch.remainder takes the divisor's sign, as jnp.remainder does
    return torch.remainder(grid.reshape(n_samples, batch_size) + offset, 1.0)


def sample_lds_t(
    generator: torch.Generator,
    n_samples: int,
    batch_size: int,
    *,
    low_discrepancy: bool = True,
    dtype=torch.float32,
) -> torch.Tensor:
    """Sample time quantiles ``t in [0, 1)`` of shape ``(n_samples, batch_size)``
    on the generator's device.

    With ``low_discrepancy=True`` this is the VDM-style stratified sampler: one
    uniform offset shared by an evenly spaced grid ``i / (1 + total)``, randomly
    permuted so a batch element is not evaluated at consecutive noise levels.
    Otherwise plain iid uniforms. ``torch.rand`` and ``torch.randperm`` stand
    in for JAX's uniform and permutation, so the numbers differ from JAX's.
    """
    device = generator.device
    if low_discrepancy:
        offset = torch.rand((), generator=generator, dtype=dtype, device=device)
        perm = torch.randperm(n_samples * batch_size, generator=generator, device=device)
        return lds_grid(perm, offset, n_samples, batch_size)
    return torch.rand((n_samples, batch_size), generator=generator, dtype=dtype, device=device)


def _check_generator(generator: torch.Generator, x: torch.Tensor) -> None:
    if generator.device.type != x.device.type:
        raise ValueError(f"generator lives on {generator.device}, x on {x.device}")


def normal_draws(generator: torch.Generator, x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Standard normal of shape ``(n_samples, *x.shape)`` in x's dtype, from
    ``generator``, which lives on x's device."""
    _check_generator(generator, x)
    return torch.randn((n_samples,) + tuple(x.shape), generator=generator, dtype=x.dtype, device=x.device)


def quantile_draws(generator: torch.Generator, x: torch.Tensor, n_samples: int,
                   low_discrepancy: bool) -> torch.Tensor:
    """Time quantiles ``(n_samples, batch)`` in x's dtype (:func:`sample_lds_t`)."""
    _check_generator(generator, x)
    return sample_lds_t(generator, n_samples, x.shape[0], low_discrepancy=low_discrepancy, dtype=x.dtype)


def index_draws(generator: torch.Generator, x: torch.Tensor, n_samples: int, n_steps: int) -> torch.Tensor:
    """Uniform step indices in ``[0, n_steps)``, shape ``(n_samples, batch)``."""
    _check_generator(generator, x)
    return torch.randint(0, n_steps, (n_samples, x.shape[0]), generator=generator, device=x.device)


def mc_var(values: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Variance of the Monte Carlo mean estimator from per-sample values.

    ``values`` has shape ``(n_samples, batch)``; returns per-batch variance of
    the mean estimate (unbiased sample variance divided by n).
    """
    return torch.var(values, dim=0, correction=1) / n_samples
