"""Plain MLP block.

Counterpart of ``bsi_tpu/nn/mlp.py``; its Dense layers are ``Dense_0``,
``Dense_1``, ... as flax names them.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from .layers import Dense


class MLP(nn.Module):
    """Dense stack: in -> hidden_features... -> out with ``actfn`` between.

    ``hidden_features`` may be an int (with ``hidden_layers`` copies) or an
    explicit list of widths. Zero hidden layers gives a single Dense.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        hidden_features: Sequence[int] | int,
        hidden_layers: int | None = None,
        actfn: Callable[[torch.Tensor], torch.Tensor] = lambda x: x,
        *,
        dtype=None,
        device=None,
    ):
        super().__init__()
        self.hidden_features = hidden_features
        self.hidden_layers = hidden_layers
        self.actfn = actfn
        widths = [in_features] + self.widths() + [out_features]
        for i, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"Dense_{i}", Dense(w_in, w_out, dtype=dtype, device=device))
        self.n_layers = len(widths) - 1
        self.tp = None

    def set_layout(self, tp) -> None:
        """Run the layers as Megatron pairs over ``tp``'s model group
        (a :class:`~bsi_torch.parallel.TensorParallel`; None: whole):
        ``Dense_{even}`` column-parallel, ``Dense_{odd}`` row-parallel."""
        if tp is not None and self.n_layers % 2:
            raise ValueError(f"tensor parallelism pairs the MLP's layers; it has {self.n_layers}")
        self.tp = tp

    def widths(self) -> list[int]:
        hf = self.hidden_features
        if isinstance(hf, int):
            if self.hidden_layers is None:
                raise ValueError("hidden_layers required when hidden_features is an int")
            return [hf] * self.hidden_layers
        hf = list(hf)
        if self.hidden_layers is not None and len(hf) != self.hidden_layers:
            raise ValueError("len(hidden_features) must equal hidden_layers")
        return hf

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        for i in range(self.n_layers):
            layer = getattr(self, f"Dense_{i}")
            if tp is None:
                x = layer(x)
            elif i % 2 == 0:
                x = layer(tp.enter(x))
            else:
                x = tp.leave(layer, x)
            if i < self.n_layers - 1:
                x = self.actfn(x)
        return x
