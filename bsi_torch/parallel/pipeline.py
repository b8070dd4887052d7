"""GPipe pipeline parallelism for the DiT over the mesh's ``pipe`` axis.

Counterpart of ``bsi_tpu/parallel/pipeline.py``. The DiT's ``depth``
blocks are cut into ``P`` contiguous stages: stage ``s`` (the rank at
``pipe_rank = s``) holds blocks ``s*depth/P ... (s+1)*depth/P - 1``
(:func:`stage_blocks`; the plan of which leaves a stage holds is
:func:`pp_plan`, the counterpart of ``pp_state_sharding``). The model
needs ``scan_blocks=True``, as in the JAX package, though the flag changes
nothing else here. A pipelined call (:func:`make_pipeline_apply`) is a
``model_apply`` like :func:`bsi_torch.train.module_apply`'s:

- stage 0 embeds the images; every stage computes the conditioning
  ``t_emb(t)``, which has no parameters;
- each stage runs its blocks over ``M`` microbatches of its local batch in
  a GPipe fill-drain schedule: it receives microbatch ``m``'s tokens from
  the previous stage, runs its blocks on them and sends the result on.
  There is no ring and no bubble tick: a stage waits in its receive;
- the last stage's tokens are broadcast to every stage of the pipe group,
  which decodes them, so the loss and everything downstream of the model is
  the same on every pipe rank.

The backward is written out too, not left to the autograd engine, because
``torch.autograd.grad(loss, params)`` computes only the nodes that lead to
``params``: a node that only receives would never send its cotangent back.
Each stage's blocks run inside one autograd Function (:class:`_Stage`)
whose inputs are the stage's parameters (and, on stage 0, the embedded
tokens). Its forward builds one graph a microbatch on detached copies of
them; its backward drains the microbatches in reverse: the last stage cuts
the cotangent of the broadcast output (its own: every pipe rank has the
same loss, and the cotangent enters the blocks once, not once a stage),
every other stage receives microbatch ``m``'s cotangent from the next
stage, runs its graph back, and sends the input's cotangent to the previous
one. Every stage meets its transfers in one fixed order, forward ``0 ...
M-1``, backward ``M-1 ... 0``, which the tests read back (``trace``). The gradient of every leaf, on the stage that
holds it, is the one-process gradient; the embedding's leaves, which every
stage holds and only stage 0 reads, take theirs by a sum over the pipe
group (``StateLayout.reduce_grads``), and the decoder's are the same on
every stage, which decodes the same tokens.

Dropout draws what a run without the pipeline draws. Each block's masks
are drawn for the stage's whole local batch and cut to the microbatch's
rows (:class:`MicroRows`, the attention's seeds through ``DrawShard``,
the pre-MLP mask through ``cut_dropout``), and the generator state at
which each block draws is the one it has in the unpipelined run: stage 0
starts from the step's seeded state, records the state before each of its
blocks on microbatch 0 and sets it again for microbatches 1 ... M-1, and
sends the state after its last block to stage 1 before microbatch 0's
tokens, and so on down the pipe. The pre-MLP mask is drawn once, on
microbatch 0, and kept for the others (as bits); the attention's seeds,
``[batch, heads]`` integers, are drawn again. ``remat`` recomputes a block
from the state it started from (``torch.utils.checkpoint`` restores it).

Tensor and sequence parallelism compose: each stage's blocks run their
Megatron pairs over the stage's model group, and under sequence parallelism
split and gather the token stream over it on entry and exit
(``DiT.run_blocks``).
"""

from __future__ import annotations

import contextlib
import re
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from . import collectives as C
from .fsdp import MIN_SIZE, assign_zero3_dim
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh
from .tensor import Shard, tp_leaf_spec

_BLOCK = re.compile(r"(?:^|\.)block_(\d+)\.")
# The leaves only the first stage reads (the patch embedding).
_FIRST_STAGE = re.compile(r"(?:^|\.)patch_encoder\.")


class MicroRows(NamedTuple):
    """A pipeline microbatch: rows ``[row, row + its size)`` of a stage's
    local batch of ``batch`` rows. A block's dropout masks are drawn for the
    whole local batch and cut to these rows. ``masks``, one dict shared by
    the microbatches of a call, keeps each ``nn.Dropout``'s draw of
    microbatch 0 for the others to cut (``cut_dropout``)."""

    batch: int
    row: int
    masks: Optional[dict] = None


def block_index(name: str) -> Optional[int]:
    """The block a parameter name belongs to (``dit.block_3.attn...`` -> 3),
    or None."""
    match = _BLOCK.search(name)
    return int(match.group(1)) if match else None


def stage_blocks(depth: int, pipe_size: int, stage: int) -> tuple[int, int]:
    """``(lo, hi)``: stage ``stage`` runs blocks ``[lo, hi)``. Raises, with
    the JAX package's message, where ``pipe_size`` does not divide ``depth``."""
    if depth % pipe_size:
        raise ValueError(f"model depth {depth} not divisible by pipe axis {pipe_size}")
    per = depth // pipe_size
    return stage * per, (stage + 1) * per


def pp_plan(params: Mapping[str, torch.Tensor], mesh: Mesh, *, fsdp: bool = False,
            min_size: int = MIN_SIZE) -> dict[str, Shard]:
    """Each leaf's :class:`Shard` under pipeline parallelism, as
    ``pp_state_sharding`` lays out the JAX package's stacked state: a block's
    leaves belong to the stage that runs the block; with a model group of
    more than one rank the Megatron pairs' leaves also split over it
    (``tp_plan``'s rules); with ``fsdp`` every leaf also shards its largest
    remaining divisible dim over the data group, a block's leaf when the
    stacked leaf of all ``depth`` blocks (what JAX measures) has
    ``min_size`` elements. Every other leaf is held by every stage; the
    patch embedding's gradient is summed over the pipe group."""
    index = {name: block_index(name) for name in params}
    depth = 1 + max((i for i in index.values() if i is not None), default=-1)
    per = depth // mesh.pipe_size if depth and depth % mesh.pipe_size == 0 else None
    plan = {}
    for name, p in params.items():
        shape, i = tuple(p.shape), index[name]
        spec = tp_leaf_spec(name, shape, mesh.model_size)
        if fsdp:
            spec = assign_zero3_dim(spec, shape, mesh.data_size, min_size if i is None else -(-min_size // depth))
        plan[name] = Shard(spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None,
                           spec.index(DATA_AXIS) if DATA_AXIS in spec else None,
                           stage=i // per if i is not None and per is not None else None,
                           pipe_sum=bool(_FIRST_STAGE.search(name)))
    return plan


def _rng_state(device: torch.device) -> torch.Tensor:
    return torch.cuda.get_rng_state(device) if device.type == "cuda" else torch.get_rng_state()


def _set_rng_state(state: torch.Tensor, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


class _Bound(nn.Module):
    """Calls ``fn(*args)`` with ``module``'s parameters bound to the tensors
    ``torch.func.functional_call`` passes (names prefixed ``module.``)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, fn, *args):
        return fn(*args)


class _Stage(torch.autograd.Function):
    """One stage's blocks over every microbatch; see the module doc."""

    @staticmethod
    def forward(ctx, pipe, tokens, c, dtype, *params):
        return pipe.forward(ctx, tokens, c, dtype, params)

    @staticmethod
    def backward(ctx, g):
        d_tokens, d_params = ctx.pipe.backward(ctx, g)
        return (None, d_tokens, None, None, *d_params)


class _Pipeline:
    """This rank's stage of a pipelined DiT (what :func:`make_pipeline_apply`
    returns calls it)."""

    def __init__(self, model, mesh: Mesh, microbatches: int):
        self.model, self.mesh, self.micro = model, mesh, microbatches
        self.size, self.stage = mesh.pipe_size, mesh.pipe_rank
        self.lo, self.hi = stage_blocks(model.depth, self.size, self.stage)
        self.names = [name for name, _ in model.named_parameters()
                      if (i := block_index(name)) is not None and self.lo <= i < self.hi]
        self.bound = _Bound(model)
        dit = model.dit
        height, width = dit.input_size
        self.tokens = (height // dit.patch_size) * (width // dit.patch_size)
        self.width = dit.hidden_size
        # a list to log each transfer into, as (op, peer rank, shape), or None
        self.trace: Optional[list] = None

    def _send(self, x: torch.Tensor, stage: int) -> None:
        peer = self.mesh.pipe_peer(stage)
        if self.trace is not None:
            self.trace.append(("send", peer, tuple(x.shape)))
        C.send_to(x, peer, self.mesh.pipe_group)

    def _recv(self, shape, dtype: torch.dtype, device: torch.device, stage: int) -> torch.Tensor:
        peer = self.mesh.pipe_peer(stage)
        out = C.recv_from(shape, dtype, device, peer, self.mesh.pipe_group)
        if self.trace is not None:
            self.trace.append(("recv", peer, tuple(shape)))
        return out

    def __call__(self, mu: torch.Tensor, t: torch.Tensor, params: list) -> torch.Tensor:
        """The model's output on every pipe rank; runs inside ``_Bound``."""
        model = self.model
        if self.stage == 0:
            tokens, c = model.embed(mu, t)
        else:
            tokens, c = None, model.dit.t_emb(t)
        if c.requires_grad:
            raise ValueError("the pipeline does not differentiate through t")
        encoder = model.dit.patch_encoder
        dtype = encoder.dtype if encoder.dtype is not None else torch.promote_types(mu.dtype, encoder.weight.dtype)
        if tokens is not None and tokens.dtype != dtype:
            raise AssertionError(f"embedded tokens are {tokens.dtype}, the pipeline expects {dtype}")
        grad = torch.is_grad_enabled() and (any(p.requires_grad for p in params)
                                            or (tokens is not None and tokens.requires_grad))
        if grad:
            out = _Stage.apply(self, tokens, c, dtype, *params)
        else:
            out = self.forward(None, tokens, c, dtype, params)
        return model.decode(out)

    def forward(self, ctx, tokens, c, dtype, params):
        """Receive, run and send every microbatch, then broadcast the last
        stage's tokens; with ``ctx`` (a gradient will be taken) each
        microbatch's graph is kept on it for :meth:`backward`."""
        size, stage, micro = self.size, self.stage, self.micro
        batch, device = c.shape[0], c.device
        if batch % micro:
            raise ValueError(f"per-device batch {batch} not divisible by microbatches={micro}")
        rows = batch // micro
        shape = (rows, self.tokens, self.width)
        grad = ctx is not None
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params] if grad else list(params)
        # the generator state before each of this stage's blocks, where they draw
        draws = getattr(self.model.dit, f"block_{self.lo}").draws
        states: list = [None] * (self.hi - self.lo)

        def before_block(i: int) -> None:
            k = i - self.lo
            if states[k] is None:
                states[k] = _rng_state(device)
            else:
                _set_rng_state(states[k], device)

        saved, outs, masks = [], [], {}

        def run() -> None:
            for m in range(micro):
                if stage == 0:
                    x = tokens[m * rows:(m + 1) * rows]
                else:
                    if draws and m == 0:
                        states[0] = self._recv(_rng_state(device).shape, torch.uint8, self.mesh.device(),
                                               stage - 1).cpu()
                    x = self._recv(shape, dtype, device, stage - 1)
                if grad:
                    x = x.detach().requires_grad_(stage > 0 or tokens.requires_grad)
                with torch.enable_grad() if grad else contextlib.nullcontext():
                    y = self.model.dit.run_blocks(x, c[m * rows:(m + 1) * rows], self.lo, self.hi,
                                                  rows=MicroRows(batch, m * rows, masks),
                                                  before_block=before_block if draws else None)
                if y.dtype != dtype:
                    raise AssertionError(f"stage {stage} gives {y.dtype} tokens, the pipeline expects {dtype}")
                if stage < size - 1:
                    if draws and m == 0:
                        self._send(_rng_state(device).to(self.mesh.device()), stage + 1)
                    self._send(y, stage + 1)
                else:
                    outs.append(y.detach())
                if grad:
                    saved.append((x, y))

        if grad:
            torch.func.functional_call(self.bound, {f"module.{n}": p for n, p in zip(self.names, leaves)}, (run,))
        else:
            run()
        if stage == size - 1:
            out = torch.cat(outs)
        else:
            out = torch.empty((batch,) + shape[1:], dtype=dtype, device=device)
        C.broadcast_from(out, self.mesh.pipe_peer(size - 1), self.mesh.pipe_group)
        if grad:
            ctx.pipe, ctx.saved, ctx.leaves, ctx.rows = self, saved, leaves, rows
        return out

    def backward(self, ctx, g):
        """Drain the microbatches in reverse: receive (or, on the last stage,
        cut) each one's cotangent, run its graph back, send its input's
        cotangent to the previous stage; the stage's parameters' gradients
        are summed over the microbatches."""
        size, stage, rows = self.size, self.stage, ctx.rows
        trainable = [k for k, leaf in enumerate(ctx.leaves) if leaf.requires_grad]
        d_params: list = [None] * len(ctx.leaves)
        d_tokens = [None] * self.micro
        for m in reversed(range(self.micro)):
            x, y = ctx.saved[m]
            ctx.saved[m] = None
            if stage == size - 1:
                gy = g[m * rows:(m + 1) * rows]
            else:
                gy = self._recv(y.shape, y.dtype, y.device, stage + 1)
            inputs = ([x] if x.requires_grad else []) + [ctx.leaves[k] for k in trainable]
            grads = list(torch.autograd.grad(y, inputs, gy, allow_unused=True))
            if x.requires_grad:
                dx = grads.pop(0)
                dx = torch.zeros_like(x) if dx is None else dx
                if stage > 0:
                    self._send(dx, stage - 1)
                else:
                    d_tokens[m] = dx
            for k, gk in zip(trainable, grads):
                if gk is not None:
                    d_params[k] = gk if d_params[k] is None else d_params[k] + gk
        d_params = [torch.zeros_like(leaf) if d is None and leaf.requires_grad else d
                    for leaf, d in zip(ctx.leaves, d_params)]
        ctx.saved = ctx.leaves = None
        return (torch.cat(d_tokens) if d_tokens[0] is not None else None), d_params


def make_pipeline_apply(model, mesh: Mesh, microbatches: Optional[int] = None, *, train: bool = True):
    """A pipelined ``model_apply(params, mu, t)`` of ``model`` (a
    ``DenoisingDiT(scan_blocks=True)``) over ``mesh``'s pipe axis, in
    ``train()`` (dropout on) or ``eval()`` mode: a drop-in for
    :func:`bsi_torch.train.module_apply` in the train step, the eval step and
    the sampler. ``params`` holds this stage's blocks' leaves and every other
    leaf (what :func:`pp_plan` gives a stage, the FSDP leaves gathered).
    ``microbatches`` defaults to the pipe-axis size and must divide the
    local batch. Every rank of the pipe group must call it in lockstep."""
    if not getattr(model, "scan_blocks", False):
        raise ValueError("pipeline parallelism needs a model built with scan_blocks=True (stacked transformer blocks)")
    if mesh.pipe_group is None:
        raise ValueError("make_pipeline_apply needs a mesh with a pipe axis of more than one stage "
                         "(make_mesh(pipeline_parallelism=P) under a process group)")
    pipe = _Pipeline(model, mesh, int(microbatches or mesh.pipe_size))

    def apply(params: dict, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        model.train(train)
        missing = [n for n in pipe.names if n not in params]
        if missing:
            raise ValueError(f"stage {pipe.stage} holds blocks [{pipe.lo}, {pipe.hi}); params lack {missing[:3]} ...")
        return torch.func.functional_call(pipe.bound, {f"module.{n}": p for n, p in params.items()},
                                          (pipe, mu, t, [params[n] for n in pipe.names]))

    apply.pipeline = pipe
    return apply
