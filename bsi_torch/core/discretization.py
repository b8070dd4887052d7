"""Discretization of a continuous interval into bins.

Counterpart of ``bsi_tpu/core/discretization.py``, used for discretized
Gaussian likelihoods and for turning model outputs into 8-bit images.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Discretization:
    """A discretization of the interval ``[min, max]`` into ``k`` bins.

    The bins are open on the right and centered on
    ``min + (max - min) * (i - 1) / (k - 1)`` for ``i = 1..k``.
    """

    min: float
    max: float
    k: int

    @classmethod
    def image_8bit(cls) -> "Discretization":
        """Discretization of 8-bit images rescaled to the [-1, 1] interval."""
        return cls(-1.0, 1.0, 256)

    def bin_boundaries(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The ``k + 1`` boundaries of the bins (including outer edges)."""
        lo, hi = self.range
        return torch.linspace(lo, hi, self.k + 1, dtype=dtype, device=device)

    def bucketize(self, x: torch.Tensor) -> torch.Tensor:
        """Find the discrete bucket index of continuous values in [min, max]."""
        dx = self.dx
        idx = (x - (self.min - dx / 2)) / dx
        return torch.clamp(idx.to(torch.int32), 0, self.k - 1).long()

    def bin_centers(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The ``k`` bin centers."""
        return torch.linspace(self.min, self.max, self.k, dtype=dtype, device=device)

    def to_unit_interval(self, x: torch.Tensor) -> torch.Tensor:
        """Map x from [min, max] to [0, 1]."""
        return (x - self.min) / (self.max - self.min)

    def to_8bit_image(self, data: torch.Tensor) -> torch.Tensor:
        """Convert continuous data in the [min, max] range into 8-bit values."""
        scaled = self.to_unit_interval(data) * 255
        return torch.clamp(scaled, 0, 255).to(torch.uint8)

    @property
    def range(self) -> tuple[float, float]:
        """The full covered interval, half a bin wider than [min, max] on each side."""
        dx = self.dx
        return (self.min - dx / 2, self.max + dx / 2)

    @property
    def dx(self) -> float:
        """Width of a single bin."""
        return (self.max - self.min) / (self.k - 1)
