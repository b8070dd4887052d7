"""Shared helpers for the algorithm cores.

Counterpart of ``bsi_tpu/core/common.py``. The cores act on a
``model_fn(mu, t) -> prediction`` callable; the caller binds the network,
its precision and its train/eval mode into it.
"""

from __future__ import annotations

from typing import Callable

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
