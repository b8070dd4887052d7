"""The reference's side of a cell's check: its readings of the first train
steps, and its step-by-step check of a sampling call.

The model is the file of its kind (``kind``, found by
:func:`benchmark.reference.model`). Work runs in blocks of ``chunk`` rows,
so that an f32 step at the cells' batches fits beside what is left on the
card.
"""

from __future__ import annotations

import torch

from . import model
from .bsi import BSI
from .draws import step_seed, train_noise
from .layers import F32, Precision
from .optim import AdamW, ema_update


def model_fn(kind: str, params: dict, cfg: dict, drop=None, rows=slice(None), prec: Precision = F32):
    forward = model(kind).forward
    return lambda mu, t: forward(params, mu, t, cfg, drop, rows, prec)


def leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in tensors.items()}


def train_readings(kind: str, model_cfg: dict, algo_cfg: dict, opt: dict, weights: dict, batches: list,
                   noise_seed: int, dropout_seed: int, start_step: int, nu0: float, *, chunk: int,
                   prec: Precision = F32, dropout_dtype=torch.float32) -> dict:
    """Runs ``len(batches)`` train steps from ``weights`` (f32, not changed)
    with Adam's first moment at zero and its second at ``nu0`` at count
    ``start_step``, the EMA equal to the weights. ``opt``: ``optimizer``
    (lr, betas, weight_decay), ``schedule``, ``max_steps``, ``clip``, ``ema``. Returns the loss of each step, the
    norms of the first step's clipped gradients by leaf, and the norms of
    the parameters' and the EMA's change after the last step by leaf, and
    the first step's clipped gradients themselves, on the host (``grads``)."""
    device = batches[0].device
    params = {n: w.detach().clone().requires_grad_() for n, w in weights.items()}
    ema = {n: w.detach().clone() for n, w in weights.items()}
    tx = AdamW(params, opt["optimizer"], opt["schedule"], opt["clip"], opt["max_steps"], start_step, nu0)
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    rate = model_cfg.get("dropout") or 0.0
    losses, first = [], None
    for i, x in enumerate(batches):
        step = start_step + i
        t, eps = train_noise(gen, x)
        drop = model(kind).dropout_plan(model_cfg, x.shape[0], step_seed(dropout_seed, step), rate, dropout_dtype,
                                        device) if rate > 0 else None
        n = x.shape[0]
        total = 0.0
        for lo in range(0, n, chunk):
            rows = slice(lo, min(lo + chunk, n))
            algo = BSI(algo_cfg, model_fn(kind, params, model_cfg, drop, rows, prec))
            loss = algo.train_losses(x[rows], t[rows], eps[rows]).sum() / n
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {k: p.grad for k, p in params.items()}
        clipped = tx.step(grads)
        if first is None:
            first = {n: g.cpu() for n, g in clipped.items()}
        ema_update(opt["ema"], step, ema, params)
        for p in params.values():
            p.grad = None
    return {"loss": losses, "grad": leaf_norms(first), "grads": first,
            "change": leaf_norms({n: params[n].detach() - weights[n] for n in weights}),
            "ema_change": leaf_norms({n: ema[n] - weights[n] for n in weights})}


@torch.no_grad()
def sample_check(kind: str, model_cfg: dict, algo_cfg: dict, weights: dict, record: dict, eps: list, rows,
                 *, chunk: int, arith=torch.float32) -> dict:
    """Checks one sampling call of the program along its own trajectory.

    ``record``: the program's denoiser calls in order, ``inputs`` (what
    the network was given, ``c_in * mu``), ``t`` and ``outputs``, and the
    call's ``samples``; ``eps``: the call's draws (:func:`~.draws.sampling_noise`);
    ``rows``: the rows checked. At each step the reference network takes
    the program's input and its output is held to the program's
    (``denoiser``); the belief mean is taken back from the program's input,
    and the reference's update from it, the program's prediction and the
    draw gives the next step's input, held to the program's (``update``),
    as are the first input to the initial belief and the samples to the
    last prediction. Each gap is ``|a - b| / |b|`` over the rows (2-norms),
    the largest over the steps. ``arith`` is the dtype of the sampler's
    elementwise arithmetic (the control's is bf16)."""
    algo = BSI(algo_cfg, None)
    k = len(eps) - 1
    t32 = algo.schedule(k, eps[0].device)
    t = t32.to(arith)
    take = lambda v: v[rows].to(arith)
    gap = lambda a, b: float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))
    denoiser, update = 0.0, 0.0
    r = lambda v: v[:, None, None, None]
    n = len(rows)
    ones = lambda v: torch.full((n,), float(v), device=eps[0].device, dtype=arith)
    # the start: the first input is c_in(t_0) times eps_0 / sqrt(lambda(t_0))
    c0 = algo.preconditioning(ones(t[0]))
    update = max(update, gap(take(record["inputs"][0]), r(c0[2]) * algo.start(t[0], take(eps[0]))))
    fn = model_fn(kind, weights, model_cfg)
    for i in range(k + 1):
        x_in, t_i, out = take(record["inputs"][i]), ones(t[i] if i < k else 1.0), take(record["outputs"][i])
        net_in = record["inputs"][i][rows].float()
        net_t = torch.full((n,), float(t32[i]) if i < k else 1.0, device=net_in.device)
        ref = torch.cat([fn(net_in[lo:lo + chunk], net_t[lo:lo + chunk]) for lo in range(0, n, chunk)])
        denoiser = max(denoiser, gap(record["outputs"][i][rows].float(), ref))
        c_skip, c_out, c_in = algo.preconditioning(t_i)
        mu = x_in / r(c_in)
        x_hat = r(c_skip) * mu + r(c_out) * out
        if i < k:
            nxt = algo.update(mu, x_hat, take(eps[i + 1]), t[i], t[i + 1])
            c_next = algo.preconditioning(ones(t[i + 1] if i + 1 < k else 1.0))
            update = max(update, gap(take(record["inputs"][i + 1]), r(c_next[2]) * nxt))
        else:
            update = max(update, gap(take(record["samples"]), x_hat))
    return {"denoiser": denoiser, "update": update}
