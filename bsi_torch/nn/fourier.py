"""Per-pixel Fourier features of the data values.

Counterpart of ``bsi_tpu/nn/fourier.py``: a parameter-free transform over the
trailing (channel) axis of NHWC data.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FourierFeatures:
    """Features ``sin(2 pi 2^n x + {0, pi/2})`` for ``n in [n_min, n_max]``.

    Input ``[..., C]`` maps to ``[..., C * n_features()]`` with (channel,
    frequency, phase) ordering.
    """

    n_min: int
    n_max: int

    def n_features(self) -> int:
        return 2 * (self.n_max - self.n_min + 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ns = np.arange(self.n_min, self.n_max + 1)
        as_x = lambda a: torch.as_tensor(a, dtype=x.dtype, device=x.device)
        coefs = as_x(2 * math.pi * (2.0**ns))
        offsets = as_x(np.array([0.0, math.pi / 2]))
        # [..., C, n, 2] -> flatten the trailing three axes into channels
        args = coefs[:, None] * x[..., None, None] + offsets
        return torch.sin(args).reshape(*x.shape[:-1], -1)
