"""AdamW with global-norm clipping, its learning-rate schedules, and the EMA
of the parameters, as the recipes state them.

Clipping scales the gradients by ``clip / |g|`` where ``|g| >= clip``.
AdamW (eps 1e-8 outside the root, bias corrections at the incremented
count, decoupled weight decay on the pre-update parameters) takes the
learning rate at the count before the increment. The EMA decay at update
``n`` is ``min(beta, 1 - (1 + (n - after - 1) / inv_gamma) ** -power)``,
0 (a copy) while that epoch is not positive.
"""

from __future__ import annotations

import math

import torch


def learning_rate(sched: dict, lr: float, count: int, max_steps: int) -> float:
    """``sched``: ``{"name": "warmup" | "cosine", "warmup_steps",
    "start_lr", "end_lr"}``: a linear warmup from start_lr, then constant or
    a cosine to end_lr at ``max_steps``."""
    warm = int(sched["warmup_steps"])
    if count < warm:
        return sched["start_lr"] + (lr - sched["start_lr"]) * count / warm
    if sched["name"] == "warmup":
        return lr
    decay = max(max_steps - warm, 1)
    frac = min(count - warm, decay) / decay
    end = sched["end_lr"] / lr
    return lr * ((1 - end) * 0.5 * (1 + math.cos(math.pi * frac)) + end)


def ema_decay(ema: dict, step: int) -> float:
    epoch = step - ema["update_after_step"] - 1
    if epoch <= 0:
        return 0.0
    return min(ema["beta"], max(0.0, 1.0 - (1.0 + epoch / ema["inv_gamma"]) ** -ema["power"]))


class AdamW:
    """One state of AdamW over a dict of f32 parameters (updated in place):
    the first moment at zero, the second at ``nu0``, ``count`` updates made."""

    def __init__(self, params: dict, opt: dict, sched: dict, clip: float, max_steps: int, count: int,
                 nu0: float = 0.0):
        self.params, self.opt, self.sched, self.clip, self.max_steps = params, opt, sched, clip, max_steps
        self.count = count
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.full_like(p, nu0) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Returns the clipped gradients the moments took."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        factor = 1.0 if norm < self.clip else float(self.clip / norm)
        b1, b2 = self.opt["betas"]
        lr = learning_rate(self.sched, self.opt["lr"], self.count, self.max_steps)
        self.count += 1
        c1, c2 = 1 - b1**self.count, 1 - b2**self.count
        clipped = {}
        for n, p in self.params.items():
            g = grads[n] * factor
            clipped[n] = g
            self.mu[n].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + 1e-8) + self.opt["weight_decay"] * p
            p.sub_(lr * step)
        return clipped


@torch.no_grad()
def ema_update(ema_cfg: dict, step: int, ema: dict, params: dict) -> None:
    d = ema_decay(ema_cfg, step)
    for n, e in ema.items():
        e.mul_(d).add_(params[n], alpha=1 - d)
