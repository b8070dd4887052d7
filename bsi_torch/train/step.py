"""The train step: loss -> grads -> clip/AdamW -> EMA -> switch-EMA.

Counterpart of ``bsi_tpu/train/step.py::make_train_step`` with
``accum_steps=1``. The JAX step is one jitted program over an immutable
state; this one runs eagerly and updates the state's tensors in place.

``model_apply(params, mu, t)`` binds a parameter dict to a network, as the
JAX package's ``model_apply`` does; :func:`module_apply` makes one from an
``nn.Module`` with ``torch.func.functional_call``, so a bf16 training model
and an f32 eval model can run on the same f32 parameters (the precision
split of ``bsi_tpu/tasks/task.py``). Dropout is the module's
``nn.Dropout`` in ``train()`` mode, drawing from PyTorch's default generator
of the device; the algorithm's noise comes from the state's generator.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .ema import EMAConfig, ema_update, maybe_switch_ema
from .optim import Optimizer, global_norm
from .state import TrainState

ModelApply = Callable[[dict, torch.Tensor, torch.Tensor], torch.Tensor]
# Noise of one step: (step, batch) -> (t [batch], eps of the batch's shape).
StepNoise = Callable[[int, torch.Tensor], tuple]


def module_apply(module: nn.Module, *, train: bool = True) -> ModelApply:
    """``model_apply`` of ``module`` in ``train()`` (dropout on) or ``eval()``
    mode; the parameters come from the dict passed at each call."""

    def apply(params: dict, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        module.train(train)
        return torch.func.functional_call(module, params, (mu, t))

    return apply


def make_train_step(
    algorithm,
    model_apply: ModelApply,
    tx: Optimizer,
    ema_cfg: EMAConfig,
    *,
    noise: Optional[StepNoise] = None,
):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    The step updates ``state`` in place and returns it, with metrics
    ``train/loss`` (the batch mean) and ``train/grad_norm`` (the global norm
    of the unclipped gradients), both 0-d tensors on the device. The noise
    of step ``n`` comes from ``state.generator`` unless ``noise`` is given,
    which the tests use to feed the JAX package's draws.
    """

    def train_step(state: TrainState, batch: torch.Tensor):
        if noise is None:
            t, eps = algorithm.train_noise(state.generator, batch)
        else:
            t, eps = noise(state.step, batch)
        model_fn = lambda mu, tt: model_apply(state.params, mu, tt)
        loss = algorithm._train_loss_on(model_fn, batch, t, eps).mean()
        grads = torch.autograd.grad(loss, list(state.params.values()))
        norm = global_norm(grads)
        tx.update(grads, state.opt_state, state.params, grad_norm=norm)
        ema_update(ema_cfg, state.step, state.ema_params, state.params)
        maybe_switch_ema(ema_cfg, state.step, state.ema_params, state.params)
        state.step += 1
        return state, {"train/loss": loss.detach(), "train/grad_norm": norm}

    return train_step
