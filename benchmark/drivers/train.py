"""Training: the body of ``Trainer.fit`` through the trainer's own members.

Set-up builds the trainer through ``build_task``, puts the benchmark's
weights into its state (parameters and EMA) at step ``start_step`` of the
traffic (past the EMA's warm-up, so it runs its steady multiply-add, at a
decay still low enough that the EMA's move over the checked steps lies
well above f32's resolution), with Adam's first moment at zero and its
second as :func:`second_moment` sets it, with the noise and dropout seeds
of the run, and drives it through the check's
first steps: each the next batch of the data module's ``train_batches()``,
``Trainer._to_device``, ``Trainer._train_step``, the window's own call and
feed. They build and warm every kernel, and give the program's readings:
each step's loss, the first step's clipped gradients (the first moment
over ``1 - beta_1``, kept on the host) and the change of the parameters
and of the EMA over the steps. The window then runs the same loop, with
``fit``'s host fetch of the loss every ``log_every`` steps, for
``--seconds``; a CUDA event after each step gives the steps' periods on the
device's timeline. A traced run profiles the window's last ``log_every``
steps, from just after a fetch, when the device is idle; its ``mfu`` is
the rate of the steps before them.

After the window the program is freed and the reference runs the checked
steps again from the same weights, rows, noise and dropout.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import compare, harness
from benchmark import trace as tracing
from benchmark import weights as weightgen
from benchmark.reference import draws, steps
from benchmark.reference.layers import Precision, tf32


def images(cell, seed: int) -> np.ndarray:
    """The run's uint8 training images, ``[n_train, H, W, C]``."""
    h, w, c = cell.config["data_shape"]
    return np.random.default_rng(seed).integers(0, 256, (cell.traffic["n_train"], h, w, c), dtype=np.uint8)


def setup(cell, s: dict, device):
    """The trainer with the run's weights, data and seeds in its state;
    returns ``(trainer, data, images, weights, shapes)``."""
    from bsi_torch.data.base import ArrayDataModule

    tr = cell.traffic
    shapes = cell.model.param_shapes(cell.reference_model())
    u8 = images(cell, s["data"])
    data = ArrayDataModule(u8, u8[:tr["batch"]], batch_size=tr["batch"], eval_batch_size=tr["batch"], seed=s["data"])
    trainer = harness.build_trainer(cell, data, device, harness.scratch_dir())
    trainer.state = trainer.init_state()
    w = weightgen.make(shapes, s["weights"], device, cell.model.SMALL_WEIGHTS)
    harness.install_weights(trainer, w, shapes)
    state = trainer.state
    state.step = state.opt_state.count = tr["start_step"]
    for nu in state.opt_state.nu.values():
        nu.fill_(second_moment(cell, shapes))
    state.generator = torch.Generator(device=device).manual_seed(s["noise"])
    state.dropout_seed = s["dropout"]
    return trainer, data, u8, w, shapes


def second_moment(cell, shapes: dict) -> float:
    """The state's second moment, every element alike: the squared norm of
    a gradient at the clip spread evenly over the parameters. The first
    moment starts at zero, so the first step's gradient is read back from
    it; with the second at zero Adam's first steps would move every
    element by the whole learning rate, the gradients' round-off too."""
    clip = float(cell.config["program"]["trainer"]["gradient_clip_val"])
    return clip**2 / sum(int(np.prod(s)) for s in shapes.values())


def check_steps(trainer, data, w: dict, n: int) -> tuple[dict, object]:
    """Runs the first ``n`` steps as the window runs them; returns the
    program's readings and the data module's batch stream."""
    batches = data.train_batches()
    prog = {"loss": []}
    for i in range(n):
        trainer.state, metrics = trainer._train_step(trainer.state, trainer._to_device(next(batches)))
        prog["loss"].append(float(metrics["train/loss"]))
        if i == 0:
            scale = 1.0 / (1.0 - trainer.optimizer.b1)
            prog["grad"], prog["grads"] = {}, {}
            for name, m in trainer.state.opt_state.mu.items():
                g = m * scale
                prog["grad"][name], prog["grads"][name] = steps.leaf_norms({name: g})[name], g.cpu()
    with torch.no_grad():
        prog["change"] = steps.leaf_norms({n: p - w[n] for n, p in trainer.state.params.items()})
        prog["ema_change"] = steps.leaf_norms({n: e - w[n] for n, e in trainer.state.ema_params.items()})
    return prog, batches


def optimizer_cfg(cell) -> dict:
    task, trainer = cell.config["program"]["task"], cell.config["program"]["trainer"]
    sched = dict(task["lr_scheduler"])
    return {"optimizer": task["optimizer"], "schedule": sched, "clip": float(trainer["gradient_clip_val"]),
            "max_steps": int(sched.get("max_steps", trainer["max_steps"])), "ema": task["ema"]}


def reference(cell, s: dict, u8: np.ndarray, device, prec: Precision) -> dict:
    """The reference's readings of the checked steps (TF32 off)."""
    tr = cell.traffic
    shapes = cell.model.param_shapes(cell.reference_model())
    w = weightgen.make(shapes, s["weights"], device, cell.model.SMALL_WEIGHTS)
    b = tr["batch"]
    rows = draws.data_rows(len(u8), s["data"], tr["check_steps"] * b)
    batches = [torch.from_numpy(draws.to_unit(u8[rows[i * b:(i + 1) * b]])).to(device)
               for i in range(tr["check_steps"])]
    dtype = torch.bfloat16 if cell.precision == "bf16" else torch.float32
    with tf32(False):
        return steps.train_readings(cell.kind, cell.reference_model(), cell.algorithm(), optimizer_cfg(cell), w,
                                    batches, s["noise"], s["dropout"], tr["start_step"], second_moment(cell, shapes),
                                    chunk=tr["reference_chunk"], prec=prec, dropout_dtype=dtype)


def run(cell, *, seed: int, seconds: float, trace: bool, t0: float, device) -> SimpleNamespace:
    tr = cell.traffic
    s = harness.seeds(seed)
    dev = harness.Device(device)
    trainer, data, u8, w, _ = setup(cell, s, device)
    prog, batches = check_steps(trainer, data, w, tr["check_steps"])
    del w
    if trace:
        tracing.warm(dev)
    dev.sync()
    setup_peak = dev.peak()
    dev.reset_peak()
    setup_s = time.time() - t0

    log_every, batch = trainer.log_every, tr["batch"]
    stretch, profiled_from, profiled_s = None, None, 0.0
    done, bad = 0, 0
    start = time.perf_counter()
    marks = [dev.mark()]
    while True:
        elapsed = time.perf_counter() - start
        if not trace and elapsed >= seconds:
            break
        if trace and stretch is None and done and done % log_every == 0 and \
                elapsed + 1.3 * log_every * elapsed / done >= seconds:
            stretch, profiled_from, begin = tracing.Stretch(dev), done, time.perf_counter()
            stretch.start()
        trainer.state, metrics = trainer._train_step(trainer.state, trainer._to_device(next(batches)))
        marks.append(dev.mark())
        done += 1
        if done % log_every == 0:
            bad += not np.isfinite(float(metrics["train/loss"]))
            if stretch is not None and done - profiled_from == log_every:
                stretch.close()
                profiled_s = time.perf_counter() - begin
                break
    dev.sync()
    window_s = time.perf_counter() - start
    window_peak = dev.peak()
    e2e = {"train_examples_per_s": done * batch / window_s,
           "train_step_ms_p95": float(np.percentile(dev.periods_ms(marks), 95)), "setup_s": setup_s}
    traced = stretch.read() if stretch is not None else None
    del trainer, data, batches, metrics, marks
    dev.free()
    ref = reference(cell, s, u8, device, Precision("f32"))
    # the rate of the traced run's unprofiled steps, for mfu
    info = SimpleNamespace(cell=cell, trace=traced, batch=batch, steps=log_every,
                           examples=(done - log_every) * batch if traced else done * batch,
                           window_s=window_s - profiled_s, window_peak_bytes=window_peak)
    return SimpleNamespace(e2e=e2e, attempted=done, failed=bad * log_every, peak_bytes=max(setup_peak, window_peak),
                           trace=traced, info=info, checks=compare.train_numbers(prog, ref))
