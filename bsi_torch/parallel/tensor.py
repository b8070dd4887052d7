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
    sharded over the data group, each None where it is whole; under
    pipeline parallelism the stage that holds it (None: every stage) and
    whether its gradient is summed over the pipe group (a leaf only the
    first stage reads, :func:`bsi_torch.parallel.pipeline.pp_plan`)."""

    model_dim: Optional[int] = None
    data_dim: Optional[int] = None
    stage: Optional[int] = None
    pipe_sum: bool = False


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

    def conditioning(self, mod: torch.Tensor) -> torch.Tensor:
        """A block's replicated adaLN output ``[B, 6D]``: under sequence
        parallelism each rank's tokens give only part of its gradient (the
        LayerNorm+modulate's dshift and dscale, the gates'), summed here
        over the group in one all-reduce."""
        return C.copy_to_model(mod, self.group) if self.sequence else mod


def cut_dropout(layer, x: torch.Tensor, *, rows=None, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """``layer`` (an ``nn.Dropout``) on the DiT's token stream ``x``, its mask
    cut from the draw the whole stream would take.

    ``rows`` (a pipeline microbatch, :class:`bsi_torch.parallel.pipeline.MicroRows`)
    says that ``x`` holds rows ``[rows.row, rows.row + len(x))`` of a batch
    of ``rows.batch``; under sequence parallelism (``tp.sequence``) ``x``
    holds this rank's ``S/tp`` tokens. The mask is then its part of one
    draw over the whole ``[batch, S, D]`` stream: each token of each row is
    masked as without the cut, and every rank advances the generator alike,
    so the attention's seeds stay replicated. With ``rows.masks`` the draw
    is made on the first microbatch (row 0) and kept there, as bits and
    the kept value, for the later ones to cut. Without either cut it is
    ``layer(x)``."""
    sequence = tp is not None and tp.sequence
    if not layer.training or (rows is None and not sequence):
        return layer(x)
    shape = list(x.shape)
    if rows is not None:
        shape[0] = rows.batch
    if sequence:
        shape[1] *= tp.size
    masks = rows.masks if rows is not None else None
    if masks is not None and rows.row > 0:
        bits, scale = masks[layer]
        keep = bits.narrow(0, rows.row, x.shape[0]) * scale
    else:
        keep = layer(x.new_ones(shape))
        if masks is not None:
            masks[layer] = (keep != 0, keep.amax())
        if rows is not None:
            keep = keep.narrow(0, rows.row, x.shape[0])
    if sequence:
        keep = C.chunk_of(keep, 1, tp.size, tp.rank)
    return x * keep
