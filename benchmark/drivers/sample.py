"""Sampling: ``Trainer.sample_fn`` on the EMA parameters, as ``python -m
bsi_torch.scripts.eval_fid`` calls it for a batch of its FID sweep.

Set-up builds the trainer through ``build_task`` with both TF32 flags off
(an f32 traffic's precision), puts the benchmark's weights into its state
and warms the sampler with one call of one step (two denoiser calls) at the
window's batch. The window calls the sampler, one call after another, each
with the schedule of ``k`` steps and ``batch`` samples from one generator
seeded for the run, each synchronised; the last call that starts inside
``--seconds`` runs to its end. A traced run profiles its first call and
stops the profiler between calls, whose gaps the rate leaves out; its
``mfu`` is the rate of the calls after it.

The check: a forward hook on the eval model keeps each denoiser call's
input and output. After the window one call, and rows of it, drawn from
the run's seed, are checked step by step by the reference along the
program's own trajectory (Fourier features amplify a difference of the
input ~100 times a step, so a free-running reference would part from it),
and the flags are read again: TF32 in an f32 run fails.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import harness
from benchmark import trace as tracing
from benchmark import weights as weightgen
from benchmark.reference import draws, steps
from benchmark.reference.layers import tf32


def setup(cell, s: dict, device):
    """The trainer with the run's weights; returns ``(trainer, schedule,
    records)``, ``records`` filled by the hook while a record is open."""
    from bsi_torch.core import get_schedule
    from bsi_torch.data.base import ArrayDataModule

    tr = cell.traffic
    if cell.precision == "f32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    h, w, c = cell.config["data_shape"]
    u8 = np.zeros((tr["batch"], h, w, c), np.uint8)
    data = ArrayDataModule(u8, u8, batch_size=tr["batch"], eval_batch_size=tr["batch"], seed=0)
    trainer = harness.build_trainer(cell, data, device, harness.scratch_dir())
    trainer.state = trainer.init_state()
    shapes = cell.model.param_shapes(cell.reference_model())
    harness.install_weights(trainer, weightgen.make(shapes, s["weights"], device, cell.model.SMALL_WEIGHTS), shapes)
    records = SimpleNamespace(open=None, done=[])

    def keep(module, args, output):
        if records.open is not None:
            records.open["inputs"].append(args[0])
            records.open["outputs"].append(output)

    trainer.eval_model.register_forward_hook(keep)
    schedule = get_schedule(tr["schedule"], tr["k"], trainer.algorithm, device=device)
    warm = get_schedule(tr["schedule"], 1, trainer.algorithm, device=device)
    trainer.sample_fn(trainer.state, torch.Generator(device=device).manual_seed(s["sample"] + 1), tr["batch"], t=warm)
    return trainer, schedule, records


def call(trainer, generator, batch: int, schedule, records, dev) -> float:
    """One sampling call, recorded; returns its seconds."""
    records.open = {"inputs": [], "outputs": []}
    start = time.perf_counter()
    out = trainer.sample_fn(trainer.state, generator, batch, t=schedule)
    dev.sync()
    seconds = time.perf_counter() - start
    records.open["samples"] = out
    records.done.append(records.open)
    records.open = None
    return seconds


def pick(s: dict, calls: int, batch: int, rows: int):
    """The checked call and rows, drawn from the run's seed."""
    rng = np.random.default_rng(s["check"])
    return int(rng.integers(calls)), np.sort(rng.choice(batch, size=rows, replace=False))


def reference(cell, s: dict, record: dict, j: int, rows, device, control: bool = False) -> dict:
    """The reference's check of call ``j``; the ``control`` runs its
    products in TF32 and the sampler's arithmetic in bf16, the precisions
    below the cell's f32 with TF32 off."""
    tr = cell.traffic
    shapes = cell.model.param_shapes(cell.reference_model())
    w = weightgen.make(shapes, s["weights"], device, cell.model.SMALL_WEIGHTS)
    h, wd, c = cell.config["data_shape"]
    eps = draws.sampling_noise(torch.Generator(device=device).manual_seed(s["sample"]), (tr["batch"], h, wd, c),
                               tr["k"], skip_calls=j)
    with tf32(control):
        return steps.sample_check(cell.kind, cell.reference_model(), cell.algorithm(), w, record, eps,
                                  torch.as_tensor(rows, device=device), chunk=tr["reference_chunk"],
                                  arith=torch.bfloat16 if control else torch.float32)


def tf32_read() -> float:
    return float(torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)


def run(cell, *, seed: int, seconds: float, trace: bool, t0: float, device) -> SimpleNamespace:
    tr = cell.traffic
    s = harness.seeds(seed)
    dev = harness.Device(device)
    trainer, schedule, records = setup(cell, s, device)
    if trace:
        tracing.warm(dev)
    dev.sync()
    setup_peak = dev.peak()
    dev.reset_peak()
    setup_s = time.time() - t0

    generator = torch.Generator(device=device).manual_seed(s["sample"])
    durations, traced = [], None
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        if trace and traced is None:
            stretch = tracing.Stretch(dev)
            stretch.start()
            durations.append(call(trainer, generator, tr["batch"], schedule, records, dev))
            stretch.close()
            traced = stretch.read()
        else:
            durations.append(call(trainer, generator, tr["batch"], schedule, records, dev))
    window_peak = dev.peak()
    samples = tr["batch"] * len(durations)
    e2e = {"samples_per_s": samples / sum(durations), "setup_s": setup_s}
    failed = sum(int((~torch.isfinite(r["samples"]).flatten(1).all(1)).sum()) for r in records.done)
    j, rows = pick(s, len(durations), tr["batch"], tr["check_rows"])
    record = records.done[j]
    checks = {"tf32": tf32_read()} if cell.precision == "f32" else {}
    del trainer, records
    dev.free()
    checks.update(reference(cell, s, record, j, rows, device))
    # the rate of the traced run's unprofiled calls (its first is profiled), for mfu
    rated = durations[1:] if trace and len(durations) > 1 else durations
    info = SimpleNamespace(cell=cell, trace=traced, batch=tr["batch"], forwards=tr["k"] + 1,
                           samples=tr["batch"] * len(rated), window_s=sum(rated), window_peak_bytes=window_peak)
    return SimpleNamespace(e2e=e2e, attempted=samples, failed=failed, peak_bytes=max(setup_peak, window_peak),
                           trace=traced, info=info, checks=checks)
