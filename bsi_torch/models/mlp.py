"""MLP denoiser for toy and low-dimensional data.

Counterpart of ``bsi_tpu/models/mlp.py``: its submodules are ``trunk`` (an
:class:`~bsi_torch.nn.MLP`, ``Dense_0`` ...) and ``head``, as flax names
them, so ``convert.params_from_jax`` carries the JAX parameters across.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bsi_torch.core.common import resolve_device
from bsi_torch.nn import MLP, Dense, FourierFeatures, NyquistPositionalEmbedding

from .utils import actfn_from_str


class DenoisingMLP(nn.Module):
    """Flattens the data, concatenates the t-embedding (and optional Fourier
    features of the flattened data), and runs an MLP back to the data shape.

    Args:
        data_shape: Per-sample data shape.
        pos_emb: Nyquist embedding for the timestep.
        hidden_width: Width of every hidden layer.
        layers: Dense layers of the trunk (``layers - 1`` hidden widths).
        actfn: Activation name.
        zero_init: Start the head at zero (weights and bias).
        fourier_features: Optional Fourier features of the flattened data.
        dtype: Compute dtype (parameters stay f32).
        device: Where the parameters live; ``None`` means the card.
    """

    def __init__(
        self,
        data_shape: tuple[int, ...],
        pos_emb: NyquistPositionalEmbedding,
        hidden_width: int = 256,
        layers: int = 2,
        actfn: str = "silu",
        zero_init: bool = False,
        fourier_features: FourierFeatures | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.data_shape = tuple(data_shape)
        self.pos_emb = pos_emb
        self.fourier_features = fourier_features
        self.act = actfn_from_str(actfn)
        n_dim = math.prod(self.data_shape)
        in_features = n_dim * (1 + (fourier_features.n_features() if fourier_features else 0)) + pos_emb.size
        kw = dict(dtype=dtype, device=device)
        self.trunk = MLP(in_features, hidden_width, [hidden_width] * (layers - 1), actfn=self.act, **kw)
        self.head = Dense(hidden_width, n_dim, **kw)
        if zero_init:
            nn.init.zeros_(self.head.weight)

    def forward(self, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``mu`` [B, *data_shape] and ``t`` [B] -> prediction [B, *data_shape]."""
        flat = mu.reshape(mu.shape[0], -1)
        parts = [flat, self.pos_emb(t)]
        if self.fourier_features is not None:
            parts.append(self.fourier_features(flat))
        x = self.act(self.trunk(torch.cat(parts, dim=-1)))
        return self.head(x).reshape(mu.shape[0], *self.data_shape)
