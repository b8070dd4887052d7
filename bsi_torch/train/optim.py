"""AdamW/Adam with global-norm clipping, and the learning-rate schedules.

Counterpart of ``bsi_tpu/train/optim.py``, which chains optax transforms.
The update here is optax's, written with ``torch._foreach_*`` over the
parameter list:

- ``clip_by_global_norm``: ``g * max / |g|`` only where ``|g| >= max`` (no
  epsilon, no scaling below the limit, unlike
  ``torch.nn.utils.clip_grad_norm_``);
- ``scale_by_adam``: ``mu_hat / (sqrt(nu_hat) + eps)``, eps outside the square
  root, bias corrections ``1 - b**count`` at the incremented count;
- ``add_decayed_weights``: ``+ weight_decay * param`` on the pre-update param;
- ``scale_by_learning_rate``: ``* -schedule(count)`` at the count *before*
  the increment, so the first update uses the schedule's value at 0.

A schedule is a plain function of the update count. The count lives on the
host, so the learning rate and the bias corrections are host numbers and no
update waits on the device.

``mu_dtype``/``nu_dtype`` store the moments in another dtype (bf16 for the
DiT). With both set, as the JAX package's ``scale_by_adam_cast``: the new
moments are computed in the gradient's dtype from the upcast stored ones,
the update is taken from those unrounded moments, and only the stored copies
are rounded. (An in-place update of bf16 moments would round them before
the update.) With ``mu_dtype`` alone, as optax's own ``mu_dtype``:
``b1 * m`` is computed and rounded in the stored dtype before ``(1 - b1) *
g`` is added; the rest as above.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def _linear(start: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: ``start`` to ``end`` over ``steps`` counts, then
    ``end``. optax evaluates it in f32 (an int32 count divides to f32), and
    so does this, so the first value of a warmup from 1e-8 to 2e-4 is
    9.997e-9, not 1e-8."""
    f32 = np.float32
    if steps <= 0:
        return lambda count: f32(start)

    def schedule(count: int) -> np.float32:
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return f32(start - end) * frac + f32(end)

    return schedule


def warmup_schedule(lr: float, warmup_steps: int = 1000, start_lr: float = 1e-8) -> Schedule:
    """Linear warmup from ``start_lr`` to ``lr``, then constant (in f32, as optax)."""
    warm = _linear(start_lr, lr, warmup_steps)
    return lambda count: warm(count) if count < warmup_steps else np.float32(lr)


def warmup_cosine_schedule(
    lr: float,
    warmup_steps: int,
    max_steps: int,
    start_lr: float = 1e-8,
    end_lr: Optional[float] = None,
) -> Schedule:
    """Linear warmup then cosine annealing to ``end_lr`` at ``max_steps``.

    The cosine part is evaluated in double and rounded to f32, as optax's
    joined schedule rounds it.
    """
    if end_lr is None:
        end_lr = 0.01 * lr
    warm = _linear(start_lr, lr, warmup_steps)
    decay_steps = float(max(max_steps - warmup_steps, 1))
    alpha = end_lr / lr

    def cosine(count: int) -> np.float32:
        count = min(count, decay_steps)
        decayed = (1 - alpha) * (0.5 * (1 + math.cos(math.pi * count / decay_steps))) + alpha
        return np.float32(lr * decayed)

    return lambda count: warm(count) if count < warmup_steps else cosine(count - warmup_steps)


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count and the two moments,
    keyed by parameter name."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def _dtype(name) -> Optional[torch.dtype]:
    """A torch dtype from its name ("bfloat16") or itself; None stays None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _working(stored: list[torch.Tensor], like: list[torch.Tensor]) -> list[torch.Tensor]:
    """The moments in the gradients' dtypes: the stored tensors themselves
    where the dtypes agree (updated in place), upcast copies elsewhere."""
    return [s if s.dtype == g.dtype else s.to(g.dtype) for s, g in zip(stored, like)]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors, a 0-d tensor on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam or AdamW with optional global-norm clipping; see :func:`make_optimizer`."""

    schedule: Union[Schedule, float]
    decoupled: bool
    b1: float
    b2: float
    eps: float
    weight_decay: float
    gradient_clip: Optional[float]
    mu_dtype: Optional[torch.dtype] = None
    nu_dtype: Optional[torch.dtype] = None

    def lr(self, count: int) -> float:
        """The learning rate of the update at ``count`` previous updates."""
        return float(self.schedule(count)) if callable(self.schedule) else self.schedule

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda dtype: {name: torch.zeros_like(p, dtype=dtype or p.dtype,
                                                      memory_format=torch.preserve_format).detach()
                               for name, p in params.items()}
        return AdamState(count=0, mu=zeros(self.mu_dtype), nu=zeros(self.nu_dtype))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState, params: dict[str, torch.Tensor],
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """One step: updates ``params`` and ``state`` in place from ``grads``
        (in the order of ``params``). ``grad_norm`` is the global norm of
        ``grads`` where the caller has it already. ``grads`` are overwritten."""
        names = list(params)
        p, mu, nu = list(params.values()), [state.mu[n] for n in names], [state.nu[n] for n in names]
        g = list(grads)
        if self.gradient_clip is not None:
            norm = global_norm(g) if grad_norm is None else grad_norm
            # optax: where(norm < max, g, g / norm * max)
            factor = torch.where(norm < self.gradient_clip, 1.0, self.gradient_clip / norm)
            torch._foreach_mul_(g, factor.to(g[0].dtype))
        lr = self.lr(state.count)
        state.count += 1
        c1 = 1 - self.b1 ** state.count
        c2 = 1 - self.b2 ** state.count
        nu_w = _working(nu, g)
        if self.mu_dtype is not None and self.nu_dtype is None:
            # optax.scale_by_adam(mu_dtype=...): b1 * m is taken in the stored
            # dtype (the weak-typed b1 rounded to it) and rounded, then
            # (1 - b1) * g is added in the gradient's dtype
            mu_w = [m.to(gi.dtype) for m, gi in zip(torch._foreach_mul(
                mu, torch.tensor(self.b1, dtype=self.mu_dtype, device=mu[0].device)), g)]
        else:
            mu_w = _working(mu, g)
            torch._foreach_mul_(mu_w, self.b1)
        torch._foreach_add_(mu_w, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu_w, self.b2)
        torch._foreach_addcmul_(nu_w, g, g, value=1 - self.b2)
        denom = torch._foreach_div(nu_w, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_w, c1)
        torch._foreach_div_(step, denom)
        if self.decoupled:
            torch._foreach_add_(step, p, alpha=self.weight_decay)
        torch._foreach_add_(p, step, alpha=-lr)
        # round into the storage dtype only now, after the update used them
        for stored, work in ((mu, mu_w), (nu, nu_w)):
            cast = [(s, w) for s, w in zip(stored, work) if s is not w]
            if cast:
                torch._foreach_copy_([s for s, _ in cast], [w for _, w in cast])


def make_optimizer(
    schedule: Union[Schedule, float],
    *,
    name: str = "adamw",
    betas: Sequence[float] = (0.9, 0.999),
    weight_decay: float = 0.01,
    eps: float = 1e-8,
    gradient_clip: Optional[float] = 1.0,
    mu_dtype=None,
    nu_dtype=None,
) -> Optimizer:
    """AdamW/Adam with optional global-norm gradient clipping, as optax chains
    them. ``mu_dtype``/``nu_dtype`` (a name such as ``"bfloat16"`` or a torch
    dtype) store the first/second moment in that dtype, as the JAX package's
    ``make_optimizer`` does through ``scale_by_adam_cast``; None keeps each
    parameter's dtype."""
    if name not in ("adam", "adamw"):
        raise ValueError(f"Unknown optimizer {name!r}")
    b1, b2 = betas
    return Optimizer(schedule=schedule, decoupled=name == "adamw", b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay, gradient_clip=gradient_clip, mu_dtype=_dtype(mu_dtype),
                     nu_dtype=_dtype(nu_dtype))
