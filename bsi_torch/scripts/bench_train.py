"""Training throughput of the flagship recipes on one card.

    python -m bsi_torch.scripts.bench_train [--model unet|dit] [--batch N] [--steps 30] [--remat]
        [--mu-dtype bfloat16] [--nu-dtype bfloat16] [--accum N]

Counterpart of ``scripts/bench_train.py``. Times the train step (loss,
backward, AdamW and EMA: ``bsi_torch/train/step.py``) of one bench:

- ``unet``: the CIFAR-10 VDM-UNet (dim 128, 32 levels), dropout 0.1,
  batch 128, AdamW 2e-4 (the cifar10-vdm recipe);
- ``dit``: DiT-L/2 at 32x32, dropout 0.05, batch 64, AdamW 5e-4 (the
  single-card operating point of the imagenet32 recipe);

both bf16 compute on f32 parameters, BSI with EDM preconditioning (k=50),
warmup 100 and a cosine to 1e6 steps, clip 1.0, EMA after step 1000, on
synthetic 8-bit images from a seed. ``--accum`` splits the batch (the
optimizer batch) into that many micro-batches, as
``trainer.accumulate_grad_batches`` does.

Timing: one warm-up step, then ``--steps`` steps chained, synchronised once
at the end. MFU is model-FLOPs MFU: three times the FLOPs of one forward at
the micro-batch, counted from the layer shapes
(``profile_sampling.count_flops``), times ``accum`` and the steps, against
the card's dense bf16 peak (``profile_sampling.PEAK_FLOPS``; no ``mfu`` on
a card not in it). ``peak_mem_gib`` is the peak allocated after a reset that follows the
warm-up. Prints one JSON line. Runs on the card, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from bsi_torch.core.common import resolve_device
from bsi_torch.profile_sampling import build_algo, build_model, card, count_flops, peak_flops, synchronize
from bsi_torch.train import EMAConfig, TrainState, make_optimizer, make_train_step, module_apply, warmup_cosine_schedule

# Each bench's dropout, learning rate and default batch.
DROPOUT = {"unet": 0.1, "dit": 0.05}
LR = {"unet": 2e-4, "dit": 5e-4}
BATCH = {"unet": 128, "dit": 64}


def _phase(msg: str) -> None:
    print(f"[bench_train] {msg}", file=sys.stderr, flush=True)


def build(model_name: str, device=None, seed: int = 0, image_size: int = 32, *, remat: bool = False,
          mu_dtype: str | None = None, nu_dtype: str | None = None, batch: int | None = None, model=None):
    """The train bench ``model_name`` ("unet" or "dit"): ``(model, algorithm,
    optimizer, EMA config, batch)``, the model in train mode with random
    weights from ``seed`` on ``device`` (the card when None). ``model``
    stands in for the full-width one (the tests' narrow models)."""
    if model_name not in DROPOUT:
        raise ValueError(f"unknown model {model_name!r}")
    device = resolve_device(device)
    if model is None:
        model = build_model(model_name, device, seed=seed, image_size=image_size, dropout=DROPOUT[model_name])
    if model_name == "dit":
        model.dit.remat = remat
    tx = make_optimizer(warmup_cosine_schedule(LR[model_name], warmup_steps=100, max_steps=10**6),
                        mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    algo = build_algo(50, model.data_shape[0])
    return model.train(), algo, tx, EMAConfig(update_after_step=1000), batch or BATCH[model_name]


def run(model_name: str, *, batch: int | None = None, steps: int = 30, remat: bool = False,
        mu_dtype: str | None = None, nu_dtype: str | None = None, accum: int = 1, device=None, seed: int = 0,
        image_size: int = 32, model=None, window=None) -> dict:
    """Time ``steps`` train steps of the bench ``model_name`` on
    ``image_size`` square images after one warm-up and return the JSON
    record (not printed).

    ``batch`` is the optimizer batch, split into ``accum`` micro-batches.
    ``window()``, when given, runs between the warm-up and the timed steps,
    after the peak memory's reset: ``chip_smoke.py`` zeroes its launch
    counters there. Raises on a non-finite loss or gradient norm, and when
    the Adam moments are not stored in the dtypes asked for."""
    device = resolve_device(device)
    model, algo, tx, ema, batch = build(model_name, device, seed, image_size, remat=remat, mu_dtype=mu_dtype,
                                        nu_dtype=nu_dtype, batch=batch, model=model)
    if batch % accum != 0:
        raise ValueError(f"batch {batch} not divisible by accum {accum}")
    micro = batch // accum
    shape = tuple(algo.data_shape)
    params = dict(model.named_parameters())
    state = TrainState.create(params=params, opt_state=tx.init(params),
                              generator=torch.Generator(device=device).manual_seed(seed + 1))
    step_fn = make_train_step(algo, module_apply(model), tx, ema, accum_steps=accum)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (batch,) + shape, generator=gen, device=device) / 255.0 * 2.0 - 1.0
    with torch.no_grad():
        fwd_flops = sum(count_flops(model, lambda: model(x[:micro], torch.full((micro,), 0.5, device=device)))
                        .values())
    if accum > 1:
        x = x.reshape((accum, micro) + shape)

    _phase(f"{model_name}: warm-up step (the first builds the kernels)")
    state, metrics = step_fn(state, x)
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if window is not None:
        window()
    _phase(f"{model_name}: timing {steps} chained steps")
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, x)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    final_loss, grad_norm = float(metrics["train/loss"]), float(metrics["train/grad_norm"])
    if not (math.isfinite(final_loss) and math.isfinite(grad_norm)):
        raise FloatingPointError(f"{model_name}: loss {final_loss}, grad norm {grad_norm}")
    for kind, want in (("mu", mu_dtype), ("nu", nu_dtype)):
        stored = {m.dtype for m in getattr(state.opt_state, kind).values()}
        if stored != {getattr(torch, want) if want else torch.float32}:
            raise AssertionError(f"{model_name}: Adam {kind} stored as {stored}, asked for {want}")

    step_flops = 3 * fwd_flops * accum
    label = f"batch {batch}" + (f" = {accum} x {micro} accum" if accum > 1 else "")
    record = {
        "metric": f"bsi-{model_name}{'' if image_size == 32 else f' {image_size}x{image_size}'} train throughput "
                  f"(bf16, {label})",
        "value": batch * steps / elapsed,
        "unit": "examples/sec/chip",
        "step_ms": elapsed / steps * 1e3,
        "final_loss": final_loss,
        "grad_norm": grad_norm,
        "remat": bool(remat),
        "mu_dtype": mu_dtype,
        "nu_dtype": nu_dtype,
        "accum": accum,
        "steps": steps,
        "step": int(state.step),
        "tflop_per_step": step_flops / 1e12,
        "tflops_per_sec": step_flops * steps / elapsed / 1e12,
        "flops_model": "3x-forward",
    }
    peak = peak_flops(device)
    if peak is not None:
        record["mfu"] = step_flops * steps / elapsed / peak
    record["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    return {**record, **card(device)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.bench_train", description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("unet", "dit"), default="unet")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--mu-dtype", default=None, choices=(None, "bfloat16"))
    p.add_argument("--nu-dtype", default=None, choices=(None, "bfloat16"))
    p.add_argument("--accum", type=int, default=1)
    args = p.parse_args(argv)
    record = run(args.model, batch=args.batch, steps=args.steps, remat=args.remat, mu_dtype=args.mu_dtype,
                 nu_dtype=args.nu_dtype, accum=args.accum)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
