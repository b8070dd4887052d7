"""The collectives of the layouts, on plain local tensors.

The layouts call ``torch.distributed`` directly, on the tensors of the
functional train state (no ``DistributedDataParallel``, no DTensor): the
kernels take plain tensors and the step reaches the model through
``torch.func.functional_call``. Two kinds:

- after ``torch.autograd.grad``: :func:`all_reduce_mean_` (the data
  group's gradient average, bucketed into one flat buffer a dtype),
  :func:`gather_dim` and :func:`reduce_scatter_dim` (FSDP's parameter
  gather and gradient reduce-scatter, on any dim);
- inside the forward, as autograd functions over the model group: the
  Megatron pair's "f" (:func:`copy_to_model`: identity forward, all-reduce
  backward) and "g" (:func:`reduce_from_model`: all-reduce forward,
  identity backward), and sequence parallelism's all-gather and
  reduce-scatter over the token dim (:func:`gather_tokens`,
  :func:`scatter_tokens`) and the split of a replicated stream
  (:func:`split_tokens`);
- the pipeline's point-to-point transfers over the pipe group
  (:func:`send_to`, :func:`recv_from`, :func:`broadcast_from`), which
  ``bsi_torch/parallel/pipeline.py`` calls in an explicit order in its
  forward and its backward. They move raw bytes, so any dtype crosses
  gloo; under gloo a CUDA tensor goes through host memory (gloo's own
  send of a CUDA tensor fails: ``writev ... Bad address`` on the card).

Sums only (gloo has no average); the mean divides after. Every function
takes ``(group, size)`` or the peer's global rank and the group; the
callers skip them without a process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim``, rank order."""
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((size * front.shape[0],) + tuple(front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's ``1/size`` chunk along ``dim`` of the sum of the ranks' ``x``."""
    front = x.movedim(dim, 0).contiguous()
    if front.shape[0] % size:
        raise ValueError(f"reduce-scatter of dim {dim} of {tuple(x.shape)} over {size} ranks")
    out = front.new_empty((front.shape[0] // size,) + tuple(front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def chunk_of(x: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s ``1/size`` chunk of ``x`` along ``dim`` (a copy)."""
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {size} ranks")
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


def all_reduce_mean_(tensors: list[torch.Tensor], group, size: int) -> None:
    """Replace each tensor by its mean over the group's ranks: one flat
    buffer a dtype, one all-reduce each."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if size > 1:
            flat.mul_(1.0 / size)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return gather_dim(x, 1, group, size)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, 1, ctx.group, ctx.size), None, None


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return reduce_scatter_dim(x, 1, group, size)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, 1, ctx.group, ctx.size), None, None


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.group, ctx.size = group, size
        return chunk_of(x, 1, size, rank)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, 1, ctx.group, ctx.size), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.size, ctx.rank = size, rank
        return gather_dim(x, 1, group, size)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, 1, ctx.size, ctx.rank), None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f": ``x`` as it is; its gradient summed over the group."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "g": ``x`` summed over the group; its gradient as it is."""
    return _ReduceFromModel.apply(x, group)


def gather_tokens(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``[B, S/size, D]`` shards -> ``[B, S, D]`` (gradient reduce-scattered)."""
    return _GatherTokens.apply(x, group, size)


def scatter_tokens(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Partial ``[B, S, D]`` -> this rank's ``[B, S/size, D]`` of their sum
    (gradient all-gathered)."""
    return _ScatterTokens.apply(x, group, size)


def split_tokens(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """A replicated ``[B, S, D]`` -> this rank's ``[B, S/size, D]``; the
    gradient all-gathered back to every rank's full stream."""
    return _SplitTokens.apply(x, group, size, rank)


def unsplit_tokens(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """The inverse of :func:`split_tokens`: the shards all-gathered into
    the replicated stream; the (replicated) gradient cut to this rank's
    shard."""
    return _GatherReplicated.apply(x, group, size, rank)


def _staged(device: torch.device, group) -> bool:
    """Whether a transfer of a tensor on ``device`` goes through host memory:
    a CUDA tensor under gloo."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def send_to(x: torch.Tensor, dst: int, group) -> None:
    """Send ``x`` to global rank ``dst`` of ``group``; returns once it may
    be reused."""
    raw = _bytes(x)
    dist.send(raw.cpu() if _staged(x.device, group) else raw, dst=dst, group=group)


def recv_from(shape, dtype: torch.dtype, device: torch.device, src: int, group) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``device``, received from global
    rank ``src`` of ``group``."""
    staged = _staged(device, group)
    out = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
    dist.recv(_bytes(out), src=src, group=group)
    return out.to(device) if staged else out


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, in place of
    each rank's ``x`` (contiguous, of the same shape and dtype)."""
    if _staged(x.device, group):
        host = x.cpu()
        dist.broadcast(_bytes(host), src=src, group=group)
        x.copy_(host)
    else:
        dist.broadcast(_bytes(x), src=src, group=group)
    return x
