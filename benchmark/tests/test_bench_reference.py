"""The plain reference held to the port at tiny widths on the CPU: the same
leaves, the same forward, loss, gradients, sampler step, optimizer and EMA,
the same draws; and whole train steps of the harness's check in f32."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, reference
from benchmark import weights as weightgen
from benchmark.reference import bsi as rbsi
from benchmark.reference import draws, optim, steps
from benchmark.tests import tiny

BENCH = harness.read_json(harness.REPO / "BENCHMARK.json")
# the first cell of each model kind
CELL_OF = {}
for entry in BENCH["workloads"]:
    CELL_OF.setdefault(harness.load_cell(entry["name"]).kind, entry["name"])
# the port's plain attention (its path off the card) takes its softmax in
# f32 at any dtype, so f64 agrees to f32's rounding there
TOL = dict(rtol=1e-5, atol=1e-7)


def port_model(cell, dtype=torch.float64):
    from bsi_torch.tasks.task import build_model

    return build_model(cell.config["program"]["task"]["model"], tuple(cell.config["data_shape"]),
                       device="cpu").to(dtype)


def weights(cell, dtype=torch.float64):
    shapes = cell.model.param_shapes(cell.reference_model())
    return {n: w.to(dtype) for n, w in weightgen.make(shapes, 7, "cpu", cell.model.SMALL_WEIGHTS).items()}


@pytest.mark.parametrize("kind", reference.kinds())
def test_leaves_and_forward_match_the_port(kind):
    cell = tiny.cell(CELL_OF[kind])
    model, w = port_model(cell), weights(cell)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {n: tuple(v.shape) for n, v in w.items()}
    mu = torch.randn((3, *cell.config["data_shape"]), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    t = torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64)
    ours = steps.model_fn(kind, w, cell.reference_model())(mu, t)
    theirs = torch.func.functional_call(model.eval(), w, (mu, t))
    torch.testing.assert_close(ours, theirs, **TOL)


@pytest.mark.parametrize("kind", reference.kinds())
def test_loss_gradients_and_sampler_step_match_the_port(kind):
    from bsi_torch.core import BSI

    cell = tiny.cell(CELL_OF[kind])
    model, w = port_model(cell), weights(cell)
    algo_cfg = cell.algorithm()
    port = BSI(data_shape=tuple(cell.config["data_shape"]), lambda_0=algo_cfg["lambda_0"], alpha_M=algo_cfg["alpha_M"],
               alpha_R=algo_cfg["alpha_R"], preconditioning="edm")
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((4, *cell.config["data_shape"]), generator=gen, dtype=torch.float64) * 2 - 1
    t, eps = draws.train_noise(torch.Generator().manual_seed(3), x)
    t2, eps2 = port.train_noise(torch.Generator().manual_seed(3), x)
    torch.testing.assert_close((t, eps), (t2, eps2), rtol=0, atol=0)
    params = {n: v.clone().requires_grad_() for n, v in w.items()}
    ref = rbsi.BSI(algo_cfg, steps.model_fn(kind, params, cell.reference_model()))
    loss = ref.train_losses(x, t, eps).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    pparams = {n: v.clone().requires_grad_() for n, v in w.items()}
    port_fn = lambda m, tt: torch.func.functional_call(model.eval(), pparams, (m, tt))
    ploss = port._train_loss_on(port_fn, x, t, eps).mean()
    pgrads = torch.autograd.grad(ploss, list(pparams.values()))
    torch.testing.assert_close(loss, ploss, **TOL)
    torch.testing.assert_close(grads, pgrads, **TOL)
    # one sampler step and the last prediction, on the port's own draws
    k = 3
    sched = torch.linspace(0, 1, k + 1, dtype=torch.float64)
    noise = [torch.randn(x.shape, generator=gen, dtype=torch.float64) for _ in range(k + 1)]
    apply = lambda m, tt: torch.func.functional_call(model.eval(), w, (m, tt))
    mu_port, _ = port._sample_loop(apply, noise[0], lambda i: noise[i + 1], sched)
    ref = rbsi.BSI(algo_cfg, apply)
    mu = ref.start(sched[0], noise[0])
    for i in range(k):
        mu = ref.update(mu, ref.predict(mu, sched[i].expand(4)), noise[i + 1], sched[i], sched[i + 1])
    torch.testing.assert_close(mu, mu_port, **TOL)


def test_adamw_clipping_schedules_and_ema_match_the_port():
    from bsi_torch.train import EMAConfig, ema_update, make_optimizer, warmup_cosine_schedule

    gen = torch.Generator().manual_seed(4)
    p0 = {"a": torch.randn(5, 3, generator=gen, dtype=torch.float64), "b": torch.randn(7, generator=gen,
                                                                                      dtype=torch.float64)}
    sched = {"name": "cosine", "warmup_steps": 1000, "start_lr": 1e-8, "end_lr": 5e-5}
    opt = {"lr": 5e-4, "betas": [0.9, 0.99], "weight_decay": 0.01}
    ema_cfg = {"beta": 0.9999, "power": 2 / 3, "inv_gamma": 1.0, "update_after_step": 1000}
    ref_p = {n: v.clone() for n, v in p0.items()}
    ref_ema = {n: v.clone() for n, v in p0.items()}
    tx = optim.AdamW(ref_p, opt, sched, 1.0, 100000, 2000, nu0=1e-3)
    port_tx = make_optimizer(warmup_cosine_schedule(5e-4, 1000, 100000, 1e-8, 5e-5), betas=(0.9, 0.99),
                             weight_decay=0.01, gradient_clip=1.0)
    port_p = {n: v.clone() for n, v in p0.items()}
    port_ema = {n: v.clone() for n, v in p0.items()}
    state = port_tx.init(port_p)
    state.count = 2000
    for v in state.nu.values():
        v.fill_(1e-3)
    port_ema_cfg = EMAConfig(power=2 / 3)
    for step in range(2000, 2003):
        g = {n: torch.randn(v.shape, generator=gen, dtype=torch.float64) * 3 for n, v in p0.items()}
        tx.step({n: v.clone() for n, v in g.items()})
        optim.ema_update(ema_cfg, step, ref_ema, ref_p)
        port_tx.update([g[n].clone() for n in port_p], state, port_p)
        ema_update(port_ema_cfg, step, port_ema, port_p)
    # the port's schedule is evaluated in f32, as optax's
    torch.testing.assert_close(ref_p, port_p, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(ref_ema, port_ema, rtol=1e-6, atol=1e-9)


def test_philox_keep_mask_is_the_kernels():
    from bsi_torch.ops.dropout_mask import _philox_keep_mask, draw_seeds

    seeds = draw_seeds(3, 2, "cpu", torch.Generator().manual_seed(5))
    assert torch.equal(draws.philox_keep(seeds, 40, 0.95), _philox_keep_mask(seeds, 40, 0.95))


def test_data_rows_are_the_train_stream():
    from bsi_torch.data.sampler import InfiniteIndexStream

    stream = InfiniteIndexStream(50, 9)
    assert np.array_equal(draws.data_rows(50, 9, 120), np.concatenate([stream.next_indices(60) for _ in range(2)]))


TRAIN_CELLS = [w["name"] for w in BENCH["workloads"] if harness.load_cell(w["name"]).traffic["driver"] == "train"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_checked_train_steps_agree_in_f32(name):
    """The harness's whole check, program and reference, at tiny widths in
    f32: the draws of data, noise and dropout are worked out alike."""
    cell = tiny.cell(name, precision="32")
    drv = harness.load_module(harness.HERE / "drivers" / "train.py")
    out = drv.run(cell, seed=31, seconds=0.5, trace=False, t0=time.time(), device=torch.device("cpu"))
    assert max(out.checks["loss"], out.checks["grad"], out.checks["grad_diff"], out.checks["change_median"]) < 1e-5, \
        out.checks
