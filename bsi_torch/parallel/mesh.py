"""The device mesh over ``torch.distributed`` process groups.

Counterpart of ``bsi_tpu/parallel/mesh.py``. One process drives one GPU.
The JAX mesh's ``(data[, pipe], model)`` axes become three families of
process groups:

- ``data``: the ranks that hold the same model shard and read different
  rows of the batch (data parallelism, FSDP's ZeRO-3 axis);
- ``pipe``: the ranks of one replica that hold consecutive stages of the
  DiT's blocks (pipeline parallelism, :mod:`.pipeline`); only built when
  ``pipeline_parallelism > 1``;
- ``model``: the ranks of one stage that split its weights (tensor
  parallelism) and, with sequence parallelism, its token stream.

Rank ``r`` is ``(data_rank * pipeline_parallelism + pipe_rank) *
model_parallelism + model_rank``, the JAX mesh's ``(data, pipe, model)``
order: the model axis is innermost, so a model group stays inside one node.
The ``dcn_data_parallelism`` factor is the outermost part of the data axis,
as the JAX mesh lays it out, which this order gives with no reshuffle.

Without a process group the mesh is ``(1, 1)`` and holds no groups: every
collective of the layouts is skipped and a single-process run is what it
was. With one, the collectives run at any size, one rank included (where
each is a copy).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the ``(data, pipe, model)`` mesh and its groups
    (None without a process group; ``pipe_group`` also None at one stage)."""

    data_size: int = 1
    model_size: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None
    pipe_size: int = 1
    pipe_rank: int = 0
    pipe_group: Optional[Any] = None

    @property
    def distributed(self) -> bool:
        """Whether the collectives run (a process group exists)."""
        return self.data_group is not None

    @property
    def shape(self) -> dict[str, int]:
        """The axes' sizes; the pipe axis only where it has more than one
        stage, as the JAX mesh omits it."""
        pipe = {PIPE_AXIS: self.pipe_size} if self.pipe_size > 1 else {}
        return {DATA_AXIS: self.data_size, **pipe, MODEL_AXIS: self.model_size}

    @property
    def rank(self) -> int:
        return self.pipe_peer(self.pipe_rank)

    def pipe_peer(self, stage: int) -> int:
        """The global rank of stage ``stage`` of this rank's pipe group."""
        return (self.data_rank * self.pipe_size + stage) * self.model_size + self.model_rank

    @property
    def writes(self) -> bool:
        """Whether this rank writes the run's files (logs, plots, checkpoints)."""
        return self.rank == 0

    def device(self) -> Optional[torch.device]:
        """Where this mesh's collectives want their tensors: the card for
        NCCL, the CPU for gloo, None without a process group."""
        if not self.distributed:
            return None
        if dist.get_backend(self.data_group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")


def make_mesh(
    model_parallelism: int = 1,
    pipeline_parallelism: int = 1,
    dcn_data_parallelism: int = 1,
) -> Mesh:
    """The ``(data, pipe, model)`` mesh over every process of the default
    group.

    Raises on a world size that the model, pipe and DCN factors do not
    divide, with the JAX package's message (in one process without a group
    the world is one device). Every rank must call it, in the same order as
    every other group constructor: ``torch.distributed.new_group`` is
    collective.
    """
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    per_replica = model_parallelism * pipeline_parallelism
    if n % (per_replica * dcn_data_parallelism):
        raise ValueError(
            f"{n} devices not divisible by model_parallelism={model_parallelism}"
            f" x pipeline_parallelism={pipeline_parallelism}"
            f" x dcn_data_parallelism={dcn_data_parallelism}"
        )
    if not grouped:
        return Mesh()
    tp, pp = model_parallelism, pipeline_parallelism
    data_size = n // (tp * pp)
    rank = dist.get_rank()
    at = lambda d, p, m: (d * pp + p) * tp + m
    mine = (rank // (tp * pp), rank // tp % pp, rank % tp)
    data_group = model_group = pipe_group = None
    # new_group is collective: every rank builds every group, in one order
    for p in range(pp):
        for m in range(tp):
            group = dist.new_group([at(d, p, m) for d in range(data_size)])
            if mine[1:] == (p, m):
                data_group = group
    for d in range(data_size):
        for p in range(pp):
            group = dist.new_group([at(d, p, m) for m in range(tp)])
            if mine[:2] == (d, p):
                model_group = group
    if pp > 1:
        for d in range(data_size):
            for m in range(tp):
                group = dist.new_group([at(d, p, m) for p in range(pp)])
                if (mine[0], mine[2]) == (d, m):
                    pipe_group = group
    return Mesh(data_size=data_size, model_size=tp, data_rank=mine[0], model_rank=mine[2], data_group=data_group,
                model_group=model_group, pipe_size=pp, pipe_rank=mine[1], pipe_group=pipe_group)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
