"""The train step (loss -> grads -> clip/AdamW -> EMA -> switch-EMA), the
ELBO eval step and the sampling function.

Counterpart of ``bsi_tpu/train/step.py``: ``make_train_step`` (with
gradient accumulation), ``make_eval_step`` and ``make_sample_fn``. The JAX
step is one jitted program over an immutable state; this one runs eagerly
and updates the state's tensors in place.

``model_apply(params, mu, t)`` binds a parameter dict to a network, as the
JAX package's ``model_apply`` does; :func:`module_apply` makes one from an
``nn.Module`` with ``torch.func.functional_call``, so a bf16 training model
and an f32 eval model can run on the same f32 parameters (the precision
split of ``bsi_tpu/tasks/task.py``).

Dropout, the modules' ``nn.Dropout`` in ``train()`` mode and the attention
kernels' seeds, draws from the device's default generator. The train step
reseeds that generator for its forward from the state's ``dropout_seed``
and its step, as JAX folds the step into ``state.rng``, inside
``torch.random.fork_rng``, which restores the generator's stream after: the
masks of a step are a function of the state, and the caller's own draws are
untouched. The algorithm's noise comes from the state's generator. With
gradient accumulation each micro-batch draws its own masks, from
(``dropout_seed``, step, micro-batch index).

Under a parallel layout (``layout``, a
:class:`~bsi_torch.parallel.StateLayout`) each data rank holds its rows of
the global batch and the state's shards. The step then draws the global
batch's ``t`` and ``eps`` from the replicated generator and keeps its rows
(one image-sized draw a rank), all-gathers the FSDP parameters before the
forward, averages the gradients and the loss over the data group, and
takes the global norm over every rank's shards. The attention kernels'
seeds are drawn for the global ``[batch, heads]`` and cut to the rank's
rows and heads (``TokenAttention``). The ``nn.Dropout`` masks cannot be cut
by row: they come from (``dropout_seed``, step, micro-batch, data rank),
equal on the model ranks of one replica (under sequence parallelism each
keeps its tokens' part of them); data rank 0 draws what one process
draws.

Under pipeline parallelism ``model_apply`` is
:func:`bsi_torch.parallel.make_pipeline_apply`'s: every pipe rank of a
replica draws the same noise, holds its stage's blocks and the rest of the
parameters, and returns the same loss, metrics and samples. A stage that
does not read a parameter it holds (the patch embedding past stage 0)
takes a zero gradient for it, which the layout sums over the pipe group.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch import nn

from bsi_torch.utils import profiling

from .ema import EMAConfig, ema_update, maybe_switch_ema
from .optim import Optimizer, global_norm
from .state import TrainState

ModelApply = Callable[[dict, torch.Tensor, torch.Tensor], torch.Tensor]
# Noise of one step: (step, batch) -> (t [batch], eps of the batch's shape);
# with accumulation (step, micro-batch, its index) -> the same for it.
StepNoise = Callable[..., tuple]
# Draws of one eval step: batch -> BSI.elbo_noise's (recon eps, t, measure eps).
EvalNoise = Callable[[torch.Tensor], tuple]

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """The splitmix64 finaliser: a bijection of 64-bit integers."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_seed(dropout_seed: int, step: int) -> int:
    """The 64-bit seed of step ``step``'s dropout draws under a state's
    ``dropout_seed``: distinct steps and distinct seeds give distinct seeds."""
    return _mix64((_mix64(dropout_seed & _MASK64) + step) & _MASK64)


def micro_seed(dropout_seed: int, step: int, micro: int) -> int:
    """The seed of micro-batch ``micro``'s dropout draws in step ``step``
    of an accumulated step: distinct for distinct (seed, step, micro)."""
    return _mix64((step_seed(dropout_seed, step) + micro) & _MASK64)


@contextlib.contextmanager
def _dropout_rng(device: torch.device, seed: int):
    """Seeds the default generator of ``device`` with ``seed`` for the body of
    the ``with``, and restores its stream (and the CPU's) after."""
    index = None
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
    with torch.random.fork_rng(devices=[] if index is None else [index]):
        generator = torch.default_generator if index is None else torch.cuda.default_generators[index]
        generator.manual_seed(seed)
        yield


def module_apply(module: nn.Module, *, train: bool = True) -> ModelApply:
    """``model_apply`` of ``module`` in ``train()`` (dropout on) or ``eval()``
    mode; the parameters come from the dict passed at each call."""

    def apply(params: dict, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        module.train(train)
        return torch.func.functional_call(module, params, (mu, t))

    return apply


def eval_params(state: TrainState, *, use_ema: bool = True, layout=None) -> dict:
    """The parameters an evaluation reads: the EMA's (the parameters' when
    ``use_ema`` is False), with ``layout`` the FSDP leaves all-gathered, once
    for the whole evaluation."""
    params = state.ema_params if use_ema else state.params
    if layout is not None and layout.distributed:
        params = layout.gather_params(params, grad=False)
    return params


def make_train_step(
    algorithm,
    model_apply: ModelApply,
    tx: Optimizer,
    ema_cfg: EMAConfig,
    accum_steps: int = 1,
    *,
    noise: Optional[StepNoise] = None,
    layout=None,
):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    The step updates ``state`` in place and returns it, with metrics
    ``train/loss`` (the batch mean) and ``train/grad_norm`` (the global norm
    of the unclipped gradients), both 0-d tensors on the device. The noise
    of step ``n`` comes from ``state.generator`` unless ``noise`` is given,
    which the tests use to feed the JAX package's draws; its dropout masks
    from (``state.dropout_seed``, ``n``).

    ``accum_steps > 1`` accumulates gradients as the JAX step's scan does:
    the batch arrives shaped ``[accum, micro, ...]``, each micro-batch takes
    its own draws (``noise(n, micro_batch, i)`` when given) and its own
    dropout masks (:func:`micro_seed`), the losses and gradients are summed
    in micro-batch order and scaled by ``1 / accum_steps``, and the
    optimizer, the EMA and the schedule advance once.

    With ``layout`` (a :class:`~bsi_torch.parallel.StateLayout`) ``batch`` is
    this data rank's rows and ``state`` holds its shards; ``noise`` is then
    asked for the global batch's draws (a view of the global shape is
    passed), of which the rank keeps its rows. The metrics are the global
    batch's.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    spread = layout is not None and layout.distributed
    unused = spread and layout.pipelined

    def loss_and_grads(state: TrainState, params: dict, batch: torch.Tensor, seed: int, *micro):
        model_fn = lambda mu, tt: model_apply(params, mu, tt)
        with profiling.span("step.forward", device=batch.device):
            t, eps = draws(state, batch, *micro)
            if spread:
                seed = layout.dropout_seed(seed)
            with _dropout_rng(batch.device, seed):
                loss = algorithm._train_loss_on(model_fn, batch, t, eps).mean()
        leaves = list(params.values())
        with profiling.span("step.backward", device=batch.device):
            grads = torch.autograd.grad(loss, leaves, allow_unused=unused)
        return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]

    def draws(state: TrainState, batch: torch.Tensor, *micro):
        like = layout.global_like(batch) if spread else batch
        if noise is None:
            t, eps = algorithm.train_noise(state.generator, like)
        else:
            t, eps = noise(state.step, like, *micro)
        if spread:
            t, eps = layout.rows(t, 0, batch.shape[0]), layout.rows(eps, 0, batch.shape[0])
        return t, eps

    def train_step(state: TrainState, batch: torch.Tensor):
        with profiling.span("step", step=state.step):
            return body(state, batch)

    def body(state: TrainState, batch: torch.Tensor):
        params = layout.gather_params(state.params) if spread else state.params
        if accum_steps == 1:
            loss, grads = loss_and_grads(state, params, batch, step_seed(state.dropout_seed, state.step))
        else:
            if batch.shape[0] != accum_steps:
                raise ValueError(f"batch of shape {tuple(batch.shape)}: want [{accum_steps}, micro, ...]")
            for i in range(accum_steps):
                mloss, mgrads = loss_and_grads(state, params, batch[i],
                                               micro_seed(state.dropout_seed, state.step, i), i)
                if i == 0:
                    loss, grads = mloss, mgrads
                else:
                    loss = loss + mloss
                    torch._foreach_add_(grads, mgrads)
            inv = 1.0 / accum_steps
            loss = loss * inv
            torch._foreach_mul_(grads, inv)
        del params
        with profiling.span("step.update", device=batch.device):
            if spread:
                names = list(state.params)
                grads = layout.reduce_grads(names, grads)
                norm = layout.grad_norm(names, grads)
                loss = layout.mean_over_data(loss)
            else:
                norm = global_norm(grads)
            tx.update(grads, state.opt_state, state.params, grad_norm=norm)
            ema_update(ema_cfg, state.step, state.ema_params, state.params)
            maybe_switch_ema(ema_cfg, state.step, state.ema_params, state.params)
        state.step += 1
        return state, {"train/loss": loss, "train/grad_norm": norm}

    return train_step


def make_eval_step(
    algorithm,
    model_apply: ModelApply,
    *,
    n_recon_samples: int = 1,
    n_measure_samples: int = 1,
    use_ema: bool = True,
    noise: Optional[EvalNoise] = None,
    layout=None,
):
    """Build ``eval_step(state, batch, mask, generator) -> metrics``: masked
    ELBO sums over the batch.

    ``metrics`` holds 0-d tensors ``elbo_sum``, ``bpd_sum``, ``count`` (the
    mask's sum) and ``part_sum/l_recon``, ``part_sum/l_measure`` (each part's
    per-example mean over its samples, summed), so that a caller aggregates
    exactly over a ragged last batch: pad it and zero its mask. The model
    sees the EMA parameters unless ``use_ema`` is False, and should be in
    eval mode (``module_apply(model, train=False)``). The draws come from
    ``generator`` (on the batch's device) unless ``noise`` is given, which
    the tests use to feed the JAX package's draws.

    With ``layout`` ``batch`` is this data rank's rows: the draws are the
    global batch's (``noise`` is passed a view of its shape), cut to the
    rank's rows, and the sums are over its rows (the caller sums them over
    the data group). The FSDP parameters are all-gathered for the step.
    """
    spread = layout is not None and layout.distributed

    def eval_step(state: TrainState, batch: torch.Tensor, mask: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> dict:
        params = eval_params(state, use_ema=use_ema, layout=layout)
        model_fn = lambda mu, t: model_apply(params, mu, t)
        with torch.inference_mode():
            like = layout.global_like(batch) if spread else batch
            if noise is None:
                draws = algorithm.elbo_noise(generator, like, n_recon_samples, n_measure_samples)
            else:
                draws = noise(like)
            if spread:
                draws = tuple(layout.rows(d, 1, batch.shape[0]) for d in draws)
            elbo, bpd, extra = algorithm._elbo_on(model_fn, batch, *draws)
            m = mask.to(elbo.dtype)
            out = {"elbo_sum": (elbo * m).sum(), "bpd_sum": (bpd * m).sum(), "count": m.sum()}
            for name, part in extra.items():
                per_example = part.mean(dim=0) if part.ndim > 1 else part
                out[f"part_sum/{name}"] = (per_example * m).sum()
        return out

    return eval_step


def make_sample_fn(algorithm, model_apply: ModelApply, *, use_ema: bool = True, layout=None):
    """Build ``sample(state, generator, n_samples, t=None, dtype=float32,
    rows=None)``: the algorithm's sampler on the EMA parameters (the
    parameters when ``use_ema`` is False), on the generator's device; with
    ``rows`` (a slice of ``range(n_samples)``) the noise of ``n_samples`` is
    drawn and only those rows are sampled. The model should be in eval mode.
    With ``layout`` the FSDP parameters are all-gathered once a call; every
    rank of a model group must call it in lockstep."""

    def sample(state: TrainState, generator: torch.Generator, n_samples: int, t=None, dtype=torch.float32,
               rows: Optional[slice] = None):
        with profiling.span("sample"):
            params = eval_params(state, use_ema=use_ema, layout=layout)
            model_fn = lambda mu, tt: model_apply(params, mu, tt)
            return algorithm.sample(model_fn, generator, n_samples, device=generator.device, t=t, dtype=dtype,
                                    rows=rows)

    return sample
