"""Sampling-step schedules in noise-variance space.

Counterpart of ``bsi_tpu/core/schedules.py``: schedules are defined over
the belief variance ``1/lambda`` between ``1/lambda_0`` (max) and
``1/(lambda_0 + alpha_M)`` (min) and mapped to step times through the
lambda-CDF. ``linear`` returns ``k + 1`` points; the variance schedules
return ``k`` points, as in the JAX package. For VDM only the linear
schedule applies, and its time runs 1 -> 0.
"""

from __future__ import annotations

import math

import torch

SCHEDULES = ("linear", "cosine", "edm", "edm7")


def get_schedule(name: str, k: int, algorithm, dtype=torch.float32, device=None) -> torch.Tensor:
    from .vdm import VDM

    if name == "linear":
        if isinstance(algorithm, VDM):
            return torch.linspace(1.0, 0.0, k + 1, dtype=dtype, device=device)
        return torch.linspace(0.0, 1.0, k + 1, dtype=dtype, device=device)

    if isinstance(algorithm, VDM):
        raise ValueError("Variance-space schedules are only defined for BSI/BFN-style time")

    max_variance = 1.0 / algorithm.lambda_0
    min_variance = 1.0 / (algorithm.lambda_0 + algorithm.alpha_M)
    grid = torch.linspace(0.0, 1.0, k, dtype=dtype, device=device)

    if name == "cosine":
        variance = (max_variance - min_variance) * torch.cos(grid * math.pi / 2) ** 2 + min_variance
    elif name == "edm":
        variance = torch.linspace(max_variance**0.5, min_variance**0.5, k, dtype=dtype, device=device) ** 2
    elif name == "edm7":
        rho = 7.0
        max_std, min_std = max_variance**0.5, min_variance**0.5
        stds = (max_std ** (1 / rho) + grid * (min_std ** (1 / rho) - max_std ** (1 / rho))) ** rho
        variance = stds**2
    else:
        raise ValueError(f"Unknown schedule {name!r}; options: {SCHEDULES}")

    return algorithm.p_lambda.cdf(1.0 / variance)
