"""Small helpers shared by the denoiser models."""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.nn import functional as F

_ACTFNS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    # flax's nn.gelu is the tanh approximation
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
    "softplus": F.softplus,
    "tanh": torch.tanh,
}


def actfn_from_str(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Look up an activation function by name."""
    try:
        return _ACTFNS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}; options: {sorted(_ACTFNS)}")
