"""Train state: everything the train step updates.

Counterpart of ``bsi_tpu/train/state.py``. The JAX state is an immutable
pytree that the jitted step donates and replaces; here the step updates the
tensors of this state in place and advances ``step`` and the generator.
"""

from __future__ import annotations

import dataclasses

import torch

from .optim import AdamState


@dataclasses.dataclass
class TrainState:
    """``params`` and ``ema_params`` map parameter names to tensors;
    ``params`` are leaves that require grad. ``generator`` draws the noise of
    each step (on the device the step runs on); ``step`` counts the steps
    taken. ``dropout_seed`` is what the JAX state's ``rng`` is to its
    dropout: the train step draws every dropout mask of step ``n`` from
    (``dropout_seed``, ``n``) alone, so a step is a function of the state
    and the batch, and a resumed run replays its masks."""

    step: int
    params: dict[str, torch.Tensor]
    ema_params: dict[str, torch.Tensor]
    opt_state: AdamState
    generator: torch.Generator
    dropout_seed: int

    @classmethod
    def create(cls, *, params, opt_state: AdamState, generator: torch.Generator,
               ema_params=None, dropout_seed: int | None = None) -> "TrainState":
        """A state at step 0. ``params`` may be a module's own parameters
        (``dict(model.named_parameters())``), which the step then trains in
        place. Without ``ema_params`` the EMA starts as a copy of them;
        without ``dropout_seed`` it is the generator's seed."""
        params = dict(params)
        if ema_params is None:
            # real copies: the step updates params in place
            ema_params = {name: p.detach().clone() for name, p in params.items()}
        if dropout_seed is None:
            dropout_seed = generator.initial_seed()
        return cls(step=0, params=params, ema_params=dict(ema_params), opt_state=opt_state,
                   generator=generator, dropout_seed=dropout_seed)
