"""A train state laid out over the mesh: which part of each leaf this rank
holds, and the collectives the train step runs on it.

Counterpart of the JAX trainer's ``_state_sharding_for``
(``bsi_tpu/train/loop.py:192-211``) and of what XLA inserts for it. Each
leaf of ``params`` (and of ``ema_params`` and the Adam moments, which
mirror its names) has a :class:`~bsi_torch.parallel.tensor.Shard`: a dim
cut over the model group (tensor parallelism), a dim cut over the data
group (FSDP), both, or neither, and under pipeline parallelism the stage
that holds it (a DiT block's leaves; every other leaf is on every stage,
:func:`~bsi_torch.parallel.pipeline.pp_plan`). A rank's state holds only
the leaves of its stage (:meth:`holds`). The train step then

- all-gathers the FSDP leaves before the forward (:meth:`gather_params`:
  the whole model at once, once a step);
- after the backward, reduce-scatters the FSDP leaves' gradients and
  all-reduces the rest, both averaged over the data group
  (:meth:`reduce_grads`: the gradient of the global batch's mean loss),
  and sums the patch embedding's over the pipe group (only stage 0 reads
  it);
- takes the global norm over every rank's shards, each leaf counted once
  (:meth:`grad_norm`);
- draws the global batch's noise and keeps this rank's rows
  (:meth:`global_like`, :meth:`rows`), and seeds its dropout masks from
  (seed, data rank) (:meth:`dropout_seed`).

Checkpoints hold full leaves: :meth:`full_items` gathers every leaf of the
model, a stage's leaves broadcast from their stage, :meth:`local` cuts one
for this rank.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import torch
import torch.distributed as dist

from . import collectives as C
from .fsdp import fsdp_plan
from .mesh import Mesh
from .pipeline import pp_plan
from .tensor import Shard, tp_plan

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class StateLayout:
    """The mesh and each leaf's :class:`Shard`; see the module doc."""

    def __init__(self, mesh: Mesh, plan: Mapping[str, Shard], shapes: Mapping[str, tuple] | None = None):
        self.mesh = mesh
        self.plan = dict(plan)
        # every leaf's full shape, for the stages that receive a leaf they do not hold
        self.shapes = dict(shapes or {})

    @classmethod
    def build(cls, mesh: Mesh, params: Mapping[str, torch.Tensor], *, fsdp: bool = False,
              tensor: bool = False) -> "StateLayout":
        """Replicated leaves; with ``fsdp`` ZeRO-3 over the data group; with
        ``tensor`` the DiT's Megatron pairs over the model group (composed
        with FSDP on a second dim); with a pipe axis the stages' blocks
        (:func:`~bsi_torch.parallel.pipeline.pp_plan`, TP and FSDP
        composed). ``params`` are full-size."""
        shapes = {name: tuple(p.shape) for name, p in params.items()}
        if mesh.pipe_size > 1:
            return cls(mesh, pp_plan(params, mesh, fsdp=fsdp), shapes)
        if tensor and mesh.model_size > 1:
            plan = tp_plan(params, mesh.model_size, fsdp=fsdp, data_size=mesh.data_size)
        elif fsdp:
            plan = {name: Shard(data_dim=dim) for name, dim in fsdp_plan(params, mesh.data_size).items()}
        else:
            plan = {name: Shard() for name in params}
        return cls(mesh, plan, shapes)

    @property
    def distributed(self) -> bool:
        return self.mesh.distributed

    @property
    def pipelined(self) -> bool:
        return self.mesh.pipe_size > 1

    @property
    def names(self) -> list[str]:
        """Every leaf of the model, held here or not, in the model's order."""
        return list(self.plan)

    def holds(self, name: str) -> bool:
        """Whether this rank's state holds (its part of) leaf ``name``."""
        stage = self.plan[name].stage
        return stage is None or stage == self.mesh.pipe_rank

    # -------------------------------------------------------- state leaves

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the full leaf ``full`` (a copy), of a leaf it
        holds."""
        if not self.holds(name):
            raise ValueError(f"stage {self.mesh.pipe_rank} does not hold {name} (stage {self.plan[name].stage})")
        s, m = self.plan[name], self.mesh
        out = full
        if s.model_dim is not None:
            out = C.chunk_of(out, s.model_dim, m.model_size, m.model_rank)
        if s.data_dim is not None:
            out = C.chunk_of(out, s.data_dim, m.data_size, m.data_rank)
        return out.clone() if out is full else out

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's part (collective over the groups
        of this stage the leaf is cut over)."""
        s, m = self.plan[name], self.mesh
        out = local
        if s.data_dim is not None:
            out = C.gather_dim(out, s.data_dim, m.data_group, m.data_size)
        if s.model_dim is not None:
            out = C.gather_dim(out, s.model_dim, m.model_group, m.model_size)
        return out

    def full_items(self, named: Mapping[str, torch.Tensor]) -> Iterator[tuple[str, torch.Tensor]]:
        """``(name, full leaf)`` for every leaf of the model, one at a time,
        from ``named`` (this rank's parts of the leaves it holds: params, the
        EMA or an Adam moment, of one dtype where a stage has to receive a
        leaf): each gathered over the groups it is cut over, and under a
        pipe axis a stage's leaf broadcast from its stage. Collective: every
        rank must take every item, in order."""
        m = self.mesh
        dtypes = {t.dtype for t in named.values()}
        for name in self.names:
            stage = self.plan[name].stage
            if stage is None or not self.pipelined:
                yield name, self.full(name, named[name])
                continue
            if stage == m.pipe_rank:
                out = self.full(name, named[name]).contiguous()
            else:
                if len(dtypes) != 1:
                    raise ValueError(f"receiving {name}: the leaves here are of {len(dtypes)} dtypes, not one")
                device = next(iter(named.values())).device
                out = torch.empty(self.shapes[name], dtype=next(iter(dtypes)), device=device)
            yield name, C.broadcast_from(out, m.pipe_peer(stage), m.pipe_group)

    def gather_params(self, params: Mapping[str, torch.Tensor], *, grad: bool = True) -> dict[str, torch.Tensor]:
        """The parameters the forward reads: FSDP leaves all-gathered over the
        data group (with ``grad``, fresh leaves that require grad), TP leaves
        left at their model-group shard, the rest as they are."""
        m = self.mesh
        out = {}
        for name, p in params.items():
            dim = self.plan[name].data_dim
            if dim is None:
                out[name] = p
                continue
            with torch.no_grad():
                full = C.gather_dim(p.detach(), dim, m.data_group, m.data_size)
            out[name] = full.requires_grad_() if grad else full
        return out

    # ----------------------------------------------------------- gradients

    def reduce_grads(self, names: list[str], grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The gradients of the parameters ``gather_params`` gave, averaged
        over the data group: FSDP leaves reduce-scattered to this rank's
        shard, the others all-reduced in one bucket a dtype; under a pipe
        axis the leaves only stage 0 reads (zero elsewhere) then summed over
        the pipe group."""
        m = self.mesh
        out = list(grads)
        whole = []
        for i, name in enumerate(names):
            dim = self.plan[name].data_dim
            if dim is None:
                whole.append(out[i])
            else:
                out[i] = C.reduce_scatter_dim(out[i], dim, m.data_group, m.data_size)
                if m.data_size > 1:
                    out[i].mul_(1.0 / m.data_size)
        if whole:
            C.all_reduce_mean_(whole, m.data_group, m.data_size)
        if self.pipelined:
            for i, name in enumerate(names):
                if self.plan[name].pipe_sum:
                    dist.all_reduce(out[i], group=m.pipe_group)
        return out

    def grad_norm(self, names: list[str], grads: list[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients over every rank's shards, a 0-d
        tensor: each cut leaf's squared norm summed over the groups of more
        than one rank it is cut over, then the norm over leaves, as
        ``global_norm`` takes it. Under a pipe axis the squares of a stage's
        leaves are summed over the pipe group and every other leaf (the same
        on every stage) is counted once."""
        m = self.mesh
        norms = torch.stack(torch._foreach_norm(grads))
        # a group of one rank holds whole leaves: their norms stand as they are
        over_data = torch.tensor([self.plan[n].data_dim is not None and m.data_size > 1 for n in names],
                                 device=norms.device)
        over_model = torch.tensor([self.plan[n].model_dim is not None and m.model_size > 1 for n in names],
                                  device=norms.device)
        cut = over_data | over_model
        if not (self.pipelined or bool(cut.any())):
            return torch.linalg.vector_norm(norms)
        sq = norms.square()
        for mask, group in ((over_data, m.data_group), (over_model, m.model_group)):
            if bool(mask.any()):
                part = torch.where(mask, sq, torch.zeros_like(sq))
                dist.all_reduce(part, group=group)
                sq = torch.where(mask, part, sq)
        if not self.pipelined:
            return torch.linalg.vector_norm(torch.where(cut, sq.sqrt(), norms))
        staged = torch.tensor([self.plan[n].stage is not None for n in names], device=sq.device)
        held = torch.where(staged, sq, torch.zeros_like(sq)).sum().reshape(1)
        dist.all_reduce(held, group=m.pipe_group)
        return (held[0] + torch.where(staged, torch.zeros_like(sq), sq).sum()).sqrt()

    def mean_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """A 0-d metric averaged over the data group."""
        m = self.mesh
        out = x.detach().reshape(1).clone()
        dist.all_reduce(out, group=m.data_group)
        if m.data_size > 1:
            out.mul_(1.0 / m.data_size)
        return out.reshape(())

    def sum_over_data(self, values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """0-d sums summed over the data group, in one all-reduce."""
        names = sorted(values)
        flat = torch.stack([values[k].detach().reshape(()) for k in names])
        dist.all_reduce(flat, group=self.mesh.data_group)
        return dict(zip(names, flat.unbind()))

    # --------------------------------------------------------------- draws

    def global_like(self, batch: torch.Tensor) -> torch.Tensor:
        """A view of the global batch's shape, dtype and device (its rows are
        not the global batch's): what the noise draws read."""
        return batch[:1].expand((batch.shape[0] * self.mesh.data_size,) + tuple(batch.shape[1:]))

    def rows(self, x: torch.Tensor, dim: int, local: int) -> torch.Tensor:
        """This data rank's ``local`` rows of a global draw along ``dim``."""
        return x.narrow(dim, self.mesh.data_rank * local, local)

    def dropout_seed(self, seed: int) -> int:
        """The seed of this data rank's dropout masks: ``seed`` itself at data
        rank 0 (one process draws what it drew before), a distinct one on
        every other data rank; the model ranks of one replica share it
        (under sequence parallelism each keeps its tokens' part of the
        masks, ``cut_dropout``)."""
        rank = self.mesh.data_rank
        return seed if rank == 0 else _mix64((seed + _mix64(rank + 0x9E3779B97F4A7C15)) & _MASK64)
