"""Exponential moving average of parameters.

Counterpart of ``bsi_tpu/train/ema.py``, with its semantics:
- the update counter ``step`` is the number of previous updates;
- before ``update_after_step`` the EMA is a copy of the online params;
- afterwards the decay follows the inverse-power warmup
  ``1 - (1 + epoch / inv_gamma) ** -power`` capped at ``beta``, with
  ``epoch = step - update_after_step - 1``;
- updates apply only on steps divisible by ``update_every``;
- optional "switch EMA": the EMA is copied back into the online params every
  ``update_model_with_ema_every`` steps.

The decay is a host number (the step count lives on the host), computed in
f32 as the JAX package computes it, so no update waits on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    beta: float = 0.9999
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0
    min_value: float = 0.0
    update_after_step: int = 1000
    update_every: int = 1
    update_model_with_ema_every: Optional[int] = None


def ema_decay(cfg: EMAConfig, step: int) -> np.float32:
    """Current decay for the (0-based) update counter ``step``, in f32."""
    f32 = np.float32
    epoch = f32(step) - f32(cfg.update_after_step) - f32(1)
    if epoch <= 0:
        return f32(0.0)
    value = f32(1.0) - (f32(1.0) + epoch / f32(cfg.inv_gamma)) ** f32(-cfg.power)
    return np.clip(value, f32(cfg.min_value), f32(cfg.beta))


@torch.no_grad()
def ema_update(cfg: EMAConfig, step: int, ema_params: dict[str, torch.Tensor],
               params: dict[str, torch.Tensor]) -> None:
    """One EMA update of ``ema_params`` in place: ``decay * ema + (1 - decay) * param``.

    A decay of 0 is a copy; off-cycle steps leave the EMA as it is.
    """
    if cfg.update_every > 1 and step % cfg.update_every:
        return
    ema = list(ema_params.values())
    online = [params[name] for name in ema_params]
    decay = ema_decay(cfg, step)
    if decay == 0:
        torch._foreach_copy_(ema, online)
        return
    torch._foreach_mul_(ema, float(decay))
    torch._foreach_add_(ema, online, alpha=float(np.float32(1.0) - decay))


@torch.no_grad()
def maybe_switch_ema(cfg: EMAConfig, step: int, ema_params: dict[str, torch.Tensor],
                     params: dict[str, torch.Tensor]) -> None:
    """Switch-EMA: copy the EMA into the online params in place on the configured cadence."""
    every = cfg.update_model_with_ema_every
    if every is None or step % every:
        return
    torch._foreach_copy_([params[name] for name in ema_params], list(ema_params.values()))
