"""Nyquist-scaled sinusoidal positional embedding.

Counterpart of ``bsi_tpu/nn/pos_emb.py``: frequencies geometrically spaced
from 1/8 up to ``Nyquist / (2 * golden_ratio)`` of the expected sampling rate.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NyquistPositionalEmbedding:
    """Sine/cosine embedding of ``t`` with Nyquist-bounded frequencies.

    Args:
        size: Number of embedding features (must be even).
        expected_rate: Expected sampling rate per unit interval.
    """

    size: int
    expected_rate: int

    def __post_init__(self):
        if self.size % 2 != 0:
            raise ValueError("size must be even")

    @property
    def _scale_bias(self) -> tuple[np.ndarray, np.ndarray]:
        k = self.size // 2
        nyquist = self.expected_rate / 2
        golden_ratio = (1 + math.sqrt(5)) / 2
        freqs = np.geomspace(1 / 8, nyquist / (2 * golden_ratio), num=k)
        scale = np.repeat(2 * np.pi * freqs, 2)
        bias = np.tile(np.array([0.0, np.pi / 2]), k)
        # Rounded to float32 before they meet t, as in the JAX package: at f64
        # the unrounded constants differ by about 1e-8.
        return scale.astype(np.float32), bias.astype(np.float32)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """Embed ``t`` of any shape into ``t.shape + (size,)``."""
        scale, bias = self._scale_bias
        as_t = lambda a: torch.as_tensor(a, dtype=t.dtype, device=t.device)
        return torch.sin(as_t(scale) * t[..., None] + as_t(bias))

    def table(self, t: np.ndarray) -> np.ndarray:
        """Pure-numpy embedding of concrete positions (the DiT's fixed patch
        table). The f32 constants meet ``t`` as numpy promotes them: an f64
        ``t`` gives an f64 table, as in the JAX package."""
        scale, bias = self._scale_bias
        return np.sin(scale * np.asarray(t)[..., None] + bias)
