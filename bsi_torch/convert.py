"""Carry weights and train states between the JAX package and the port.

The port names its submodules after the flax names, so the mapping is
mechanical: the flax path joined by dots, with

- Dense ``kernel`` [in, out] -> ``weight`` [out, in];
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- LayerNorm and GroupNorm ``scale`` -> ``weight``; every ``bias`` -> ``bias``.

qkv projections stay in the grouped layout both packages use. A DiT tree in
the JAX package's scan layout (``blocks/block/...`` with a leading depth
axis, what its ``scan_blocks=True`` builds) is split into the loop layout's
``block_{i}`` first, as ``unstack_block_params`` does. :func:`params_to_jax`
is the inverse, into the loop layout (for the port's gradients, say) or,
with ``scan_blocks=True``, the scan layout that the JAX package's pipeline
shards (as ``stack_block_params`` builds it),
:func:`train_state_from_jax` carries a whole JAX train state across, and
:func:`inception_params_from_jax` the FID network's weights.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from bsi_torch.core.common import resolve_device
from bsi_torch.train import AdamState, TrainState


def _unstack_blocks(node: Any) -> Any:
    """The loop block layout of a tree: every ``blocks: {block: {...}}`` node,
    whose leaves carry a leading depth axis, becomes ``block_0`` ...
    ``block_{depth-1}``."""
    if not isinstance(node, Mapping):
        return node
    out: dict[str, Any] = {}
    for name, value in node.items():
        if name == "blocks" and isinstance(value, Mapping) and set(value) == {"block"}:
            stacked = _map_leaves(value["block"], np.asarray)
            for i in range(len(_first_leaf(stacked))):
                out[f"block_{i}"] = _map_leaves(stacked, lambda a, i=i: a[i])
        else:
            out[name] = _unstack_blocks(value)
    return out


def _first_leaf(node: Any) -> Any:
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    return node


def _map_leaves(node: Any, fn: Callable[[Any], Any]) -> Any:
    if isinstance(node, Mapping):
        return {name: _map_leaves(value, fn) for name, value in node.items()}
    return fn(node)


def params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's model from a flax variable tree
    (``{"params": {...}}`` or the inner dict) with array leaves, in the loop
    or the scan block layout."""
    tree = _unstack_blocks(params["params"] if "params" in params else params)
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
            state[prefix + name] = _tensor(arr)

    walk(tree, "")
    return state


def inception_params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The state dict of :class:`bsi_torch.metrics.inception.InceptionV3FID`
    from the JAX package's flat Inception parameter dict (HWIO convolutions
    -> OIHW; the BatchNorm entries keep their names), in the arrays' dtype."""
    return {key: _tensor(np.asarray(value).transpose(3, 2, 0, 1) if key.endswith("conv.weight")
                         else np.asarray(value))
            for key, value in params.items()}


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor of ``arr``'s values and dtype; numpy's bfloat16 (ml_dtypes,
    which JAX's bf16 arrays become) goes through f32, exactly."""
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


def params_to_jax(state: Mapping[str, torch.Tensor], *, scan_blocks: bool = False) -> dict[str, Any]:
    """A flax-shaped tree of numpy arrays (the inner ``params`` dict) from
    tensors named as the port names its parameters (bf16 ones as f32, which
    holds their values exactly). With ``scan_blocks`` every ``block_{i}``
    subtree is stacked into ``blocks/block`` with a leading depth axis, the
    JAX package's scan layout."""
    tree: dict[str, Any] = {}
    for path, tensor in state.items():
        *parents, name = path.split(".")
        tensor = tensor.detach().cpu()
        arr = (tensor.float() if tensor.dtype == torch.bfloat16 else tensor).numpy()
        if name == "weight" and arr.ndim == 2:
            arr, name = arr.T, "kernel"
        elif name == "weight" and arr.ndim == 4:
            arr, name = arr.transpose(2, 3, 1, 0), "kernel"
        elif name == "weight" and arr.ndim == 1:
            name = "scale"
        elif name != "bias":
            raise ValueError(f"no flax name for {path} of shape {arr.shape}")
        node = tree
        for parent in parents:
            node = node.setdefault(parent, {})
        node[name] = arr
    return _stack_blocks(tree) if scan_blocks else tree


def _stack_blocks(node: Any) -> Any:
    """The scan block layout of a tree: ``block_0`` ... ``block_{depth-1}``
    stacked into ``blocks: {block: {...}}``, after the other entries."""
    if not isinstance(node, Mapping):
        return node
    if "block_0" not in node:
        return {name: _stack_blocks(value) for name, value in node.items()}
    depth = sum(1 for name in node if name.startswith("block_"))
    out = {name: value for name, value in node.items() if not name.startswith("block_")}
    layers = [node[f"block_{i}"] for i in range(depth)]

    def stack(*path):
        leaves = []
        for layer in layers:
            for key in path:
                layer = layer[key]
            leaves.append(layer)
        return np.stack(leaves, axis=0)

    def walk(template: Mapping[str, Any], path: tuple) -> dict:
        return {k: walk(v, path + (k,)) if isinstance(v, Mapping) else stack(*path, k) for k, v in template.items()}

    out["blocks"] = {"block": walk(layers[0], ())}
    return out


def train_state_from_jax(
    state: Any,
    *,
    generator: torch.Generator,
    device: torch.device | str | None = None,
    convert: Callable[[Any], dict[str, torch.Tensor]] = params_from_jax,
) -> TrainState:
    """The port's :class:`~bsi_torch.train.TrainState` from a JAX ``TrainState``
    whose optimizer is ``make_optimizer``'s chain (clip, then optax's adam or
    adamw, or ``scale_by_adam_cast`` with bf16 moments): its step, params,
    EMA params and Adam moments, each in its own dtype, and count.

    ``convert`` maps a parameter-shaped tree to named tensors
    (:func:`params_from_jax` for the flax models). The tensors go to
    ``device``, the card when ``None``. ``generator`` becomes the state's
    generator (its draws cannot be JAX's); the JAX key's words become the
    state's ``dropout_seed``, so a run resumed from the same JAX state
    replays the same masks.
    """
    device = resolve_device(device)
    adam = _find_adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the JAX optimizer state")
    tensors = lambda tree: {k: v.to(device) for k, v in convert(tree).items()}
    params = {k: v.requires_grad_() for k, v in tensors(state.params).items()}
    opt_state = AdamState(count=int(adam.count), mu=tensors(adam.mu), nu=tensors(adam.nu))
    return TrainState(step=int(state.step), params=params, ema_params=tensors(state.ema_params),
                      opt_state=opt_state, generator=generator, dropout_seed=_key_seed(state.rng))


def _key_seed(rng: Any) -> int:
    """The words of a JAX PRNG key as one integer, without JAX: a typed key
    array holds them in ``_base_array``, a raw ``uint32`` key is them."""
    words = np.asarray(getattr(rng, "_base_array", rng)).astype(np.uint64).reshape(-1)
    seed = 0
    for word in words:
        seed = (seed << 32) | int(word)
    return seed


def _find_adam_state(opt_state: Any):
    """The first node with ``count``, ``mu`` and ``nu`` in a nest of optax states."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None
