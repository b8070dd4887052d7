"""Carry weights from the JAX package's flax models to the port's modules.

The port names its submodules after the flax names, so the mapping is
mechanical: the flax path joined by dots, with

- Dense ``kernel`` [in, out] -> ``weight`` [out, in];
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- GroupNorm ``scale`` -> ``weight``; every ``bias`` -> ``bias``.

qkv projections stay in the grouped layout both packages use.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's model from a flax variable tree
    (``{"params": {...}}`` or the inner dict) with array leaves."""
    tree = params["params"] if "params" in params else params
    state: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.asarray(value)
            if name == "kernel" and arr.ndim == 2:
                arr, name = arr.T, "weight"
            elif name == "kernel" and arr.ndim == 4:
                arr, name = arr.transpose(3, 2, 0, 1), "weight"
            elif name == "scale":
                name = "weight"
            elif name != "bias":
                raise ValueError(f"no mapping for flax leaf {prefix}{name} of shape {arr.shape}")
            state[prefix + name] = torch.tensor(arr)

    walk(tree, "")
    return state
