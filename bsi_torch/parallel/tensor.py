"""Tensor parallelism (Megatron) over the model axis.

Counterpart of ``bsi_tpu/parallel/tensor.py``: the DiT's weight matrices
shard over the model group in column/row pairs, by the JAX package's name
rules read on the port's names:

- column-parallel: ``ada_in``, ``attn.to_qkv`` and ``mlp.Dense_{even}``;
- row-parallel: ``attn.to_out``, ``ada_out`` and ``mlp.Dense_{odd}``.

A torch ``Linear`` weight is ``[out, in]``: a column-parallel layer shards
dim 0 of its weight and its bias, a row-parallel one dim 1 of its weight;
its bias stays whole and is added once, after the pair's all-reduce. (The
JAX rules name only the kernels, so the column biases stay replicated
there and GSPMD slices them; here each rank keeps its slice.) Every other
leaf stays replicated. With FSDP a leaf also shards its largest remaining
divisible dim over the data group, as ``tp_state_sharding`` composes them.

The DiT runs the pairs with :class:`TensorParallel`: "f" in front of each
column-parallel layer and "g" after each row-parallel one
(:mod:`.collectives`), or, under sequence parallelism, the all-gather and
reduce-scatter of the token stream in their place
(``bsi_torch/parallel/sequence.py``). ``to_qkv``'s output is in the grouped
layout ``(g qkv x)``, so a column shard holds whole head groups when tp
divides the group count; otherwise :func:`check_heads` raises rather than
reshard.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional

import torch
from torch.nn import functional as F

from bsi_torch.nn.layers import compute_dtype
from bsi_torch.ops.flash_attention_packed import qkv_heads_per_group

from . import collectives as C
from .fsdp import MIN_SIZE, assign_zero3_dim
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

_COL = tuple(re.compile(p) for p in (
    r"(^|\.)ada_in\.(weight|bias)$",
    r"(^|\.)attn\.to_qkv\.(weight|bias)$",
    r"(^|\.)mlp\.Dense_(\d*[02468])\.(weight|bias)$",
))
_ROW = tuple(re.compile(p) for p in (
    r"(^|\.)attn\.to_out\.weight$",
    r"(^|\.)ada_out\.weight$",
    r"(^|\.)mlp\.Dense_(\d*[13579])\.weight$",
))


def tp_leaf_spec(name: str, shape, tp: int) -> list:
    """The leaf's TP assignment, ``[axis name or None] * rank``."""
    spec = [None] * len(shape)
    if tp <= 1 or not shape:
        return spec
    if any(r.search(name) for r in _COL) and shape[0] % tp == 0:
        spec[0] = MODEL_AXIS
    elif len(shape) == 2 and any(r.search(name) for r in _ROW) and shape[1] % tp == 0:
        spec[1] = MODEL_AXIS
    return spec


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a leaf is cut: the dim sharded over the model group and the dim
    sharded over the data group, each None where it is whole."""

    model_dim: Optional[int] = None
    data_dim: Optional[int] = None


def tp_plan(params: Mapping[str, object], tp: int, fsdp: bool = False, data_size: int = 1,
            min_size: int = MIN_SIZE) -> dict[str, Shard]:
    """Each leaf's :class:`Shard`: TP over the model group by the name rules
    and, with ``fsdp``, ZeRO-3 over the data group on a second dim."""
    plan = {}
    for name, p in params.items():
        shape = tuple(p.shape)
        spec = tp_leaf_spec(name, shape, tp)
        if fsdp:
            spec = assign_zero3_dim(spec, shape, data_size, min_size)
        plan[name] = Shard(spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None,
                           spec.index(DATA_AXIS) if DATA_AXIS in spec else None)
    return plan


def check_heads(dim: int, heads: int, tp: int) -> None:
    """Raise unless a column shard of ``to_qkv`` holds whole head groups:
    tp must divide the grouped layout's group count."""
    hpg = qkv_heads_per_group(dim // heads, heads)
    groups = heads // hpg
    if groups % tp:
        raise ValueError(f"model_parallelism={tp} does not divide the {groups} qkv head groups of {heads} heads "
                         f"of {dim // heads} ({hpg} a group): a column shard of to_qkv would split a group")


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The model group a DiT's Megatron pairs run over, and whether the
    token stream between them is split over it (sequence parallelism)."""

    mesh: Mesh
    sequence: bool = False

    @property
    def size(self) -> int:
        return self.mesh.model_size

    @property
    def rank(self) -> int:
        return self.mesh.model_rank

    @property
    def group(self):
        return self.mesh.model_group

    def enter(self, x: torch.Tensor, *, tokens: bool = True) -> torch.Tensor:
        """The input of a column-parallel layer: "f", or, for the token
        stream under sequence parallelism, its shards all-gathered."""
        if self.sequence and tokens:
            return C.gather_tokens(x, self.group, self.size)
        return C.copy_to_model(x, self.group)

    def leave(self, layer, x: torch.Tensor, *, tokens: bool = True) -> torch.Tensor:
        """A row-parallel ``Dense`` on this rank's input columns: its partial
        product summed over the group ("g", or, for the token stream under
        sequence parallelism, a reduce-scatter of the tokens), then its
        bias, once."""
        dt = compute_dtype(layer.dtype, x, layer.weight)
        y = F.linear(x.to(dt), layer.weight.to(dt))
        bias = layer.bias.to(dt)
        if self.sequence and tokens:
            # the bias meets this rank's tokens only: its gradient is summed
            return C.scatter_tokens(y, self.group, self.size) + C.copy_to_model(bias, self.group)
        return C.reduce_from_model(y, self.group) + bias

    def dropout(self, layer, x: torch.Tensor) -> torch.Tensor:
        """``layer`` (an ``nn.Dropout``) on the token stream ``x``. Under
        sequence parallelism ``x`` is this rank's ``S/tp`` tokens: the mask
        is their part of one draw over the whole ``[B, S, D]`` stream. Each
        token shard then has its own mask, each token's is the one the
        replica draws without the split, and every model rank advances the
        generator alike, so the attention's seeds stay replicated."""
        if not (self.sequence and layer.training):
            return layer(x)
        keep = layer(x.new_ones((x.shape[0], x.shape[1] * self.size) + tuple(x.shape[2:])))
        return x * C.chunk_of(keep, 1, self.size, self.rank)

    def conditioning(self, mod: torch.Tensor) -> torch.Tensor:
        """A block's replicated adaLN output ``[B, 6D]``: under sequence
        parallelism each rank's tokens give only part of its gradient (the
        LayerNorm+modulate's dshift and dscale, the gates'), summed here
        over the group in one all-reduce."""
        return C.copy_to_model(mod, self.group) if self.sequence else mod
