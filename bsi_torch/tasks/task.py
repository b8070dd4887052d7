"""Generic generative-modeling task: config -> Trainer.

Counterpart of ``bsi_tpu/tasks/task.py``: one function instantiates the
denoiser, the algorithm, the optimizer with its learning-rate schedule and
the EMA config from a resolved config, and assembles a
:class:`~bsi_torch.train.loop.Trainer`.

Precision: ``trainer.precision: bf16`` builds the *training* model with
bf16 compute and an *eval* model in f32; the parameters are f32 either way
and live in the train state, which both models read through
``module_apply``.

``trainer.dropout_prng_impl`` picks the TPU's hardware bit generator for
the JAX package's dropout masks (``bsi_tpu/train/step.py::dropout_key_for``)
and is not read here: the port's masks are a function of (dropout seed,
step, micro-batch) either way.

Device: the card unless the config says ``trainer.device`` (``+trainer.device=cpu``
on the command line) or the caller passes ``device``; with no card and no
such request it raises rather than train on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Optional

import torch

from bsi_torch.config import instantiate
from bsi_torch.core.common import resolve_device
from bsi_torch.metrics import build_validation_fid
from bsi_torch.train import EMAConfig, make_optimizer, warmup_cosine_schedule, warmup_schedule
from bsi_torch.train.loop import Trainer
from bsi_torch.utils.logging import MetricLogger

PARALLEL_ITEM = "parallel layouts, ROADMAP.md queue 1 item 2"


def build_model(model_cfg: dict, data_shape: tuple[int, ...], dtype=None, device=None):
    cfg = dict(model_cfg)
    # optional sub-components selected as 'none' compose to a target-less
    # stub dict; the model expects None
    for key in ("fourier_features", "pos_emb"):
        if isinstance(cfg.get(key), dict) and "_target_" not in cfg[key]:
            cfg[key] = None
    return instantiate(cfg, data_shape=tuple(data_shape), dtype=dtype, device=device)


def build_algorithm(algo_cfg: dict, data_shape: tuple[int, ...], discretization):
    return instantiate(algo_cfg, data_shape=tuple(data_shape), discretization=discretization)


def build_schedule(ls_cfg: Optional[dict], opt_cfg: dict, max_steps: int):
    lr = float(opt_cfg["lr"])
    if ls_cfg is None:
        return lr
    name = ls_cfg.get("name", "warmup")
    if name == "warmup":
        return warmup_schedule(
            lr,
            warmup_steps=int(ls_cfg.get("warmup_steps", 1000)),
            start_lr=float(ls_cfg.get("start_lr", 1e-8)),
        )
    if name == "cosine":
        return warmup_cosine_schedule(
            lr,
            warmup_steps=int(ls_cfg.get("warmup_steps", 1000)),
            max_steps=int(ls_cfg.get("max_steps", max_steps)),
            start_lr=float(ls_cfg.get("start_lr", 1e-8)),
            end_lr=float(ls_cfg["end_lr"]) if ls_cfg.get("end_lr") is not None else None,
        )
    raise ValueError(f"Unknown lr_scheduler {name!r}")


def build_optimizer(opt_cfg: dict, ls_cfg: Optional[dict], max_steps: int, gradient_clip):
    """Returns ``(optimizer, schedule)``; the schedule also feeds the
    ``train/lr`` log."""
    schedule = build_schedule(ls_cfg, opt_cfg, max_steps)
    return make_optimizer(
        schedule,
        name=opt_cfg.get("name", "adamw"),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
        weight_decay=float(opt_cfg.get("weight_decay", 0.01)),
        gradient_clip=gradient_clip,
        mu_dtype=opt_cfg.get("mu_dtype"),
        nu_dtype=opt_cfg.get("nu_dtype"),
    ), schedule


def build_ema(ema_cfg: Optional[dict]) -> EMAConfig:
    if ema_cfg is None:
        return EMAConfig()
    fields = {f.name for f in dataclasses.fields(EMAConfig)}
    return EMAConfig(**{k: v for k, v in ema_cfg.items() if k in fields})


def _check_single_device(trainer_cfg: dict) -> None:
    """The parallel layouts are not ported: refuse them rather than train
    on one device under a config that asks for more."""
    for key in ("model_parallelism", "pipeline_parallelism", "dcn_data_parallelism"):
        if int(trainer_cfg.get(key, 1) or 1) > 1:
            raise NotImplementedError(f"trainer.{key} > 1 is not ported yet; it waits for {PARALLEL_ITEM}")
    for key in ("fsdp", "sequence_parallel"):
        if trainer_cfg.get(key):
            raise NotImplementedError(f"trainer.{key} is not ported yet; it waits for {PARALLEL_ITEM}")


def build_task(
    config: dict,
    data,
    *,
    run_dir: str | Path,
    seed: int = 0,
    logger: Optional[MetricLogger] = None,
    preemption=None,
    device: torch.device | str | None = None,
) -> Trainer:
    """Assemble a Trainer from a fully-resolved config and a data module.

    The models are built, and their parameters initialised, from ``seed``
    (the trainer's :meth:`~bsi_torch.train.loop.Trainer.init_state` copies
    them into the train state).
    """
    task_cfg: dict[str, Any] = config["task"]
    trainer_cfg: dict[str, Any] = config.get("trainer", {})
    _check_single_device(trainer_cfg)
    device = resolve_device(device if device is not None else trainer_cfg.get("device"))
    data_shape = data.data_shape()

    precision = str(trainer_cfg.get("precision", "32"))
    train_dtype = torch.bfloat16 if precision in ("bf16", "bf16-mixed") else None
    model_cfg = dict(task_cfg["model"])
    devices = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        model = build_model(model_cfg, data_shape, dtype=train_dtype, device=device)
    eval_model = build_model(model_cfg, data_shape, device=device) if train_dtype is not None else model

    algorithm = build_algorithm(task_cfg["algorithm"], data_shape, data.discretization())
    callbacks = ()
    if trainer_cfg.get("plots", True):
        from .plots import PlotsCallback

        callbacks = (PlotsCallback(),)
    # validation FID where the statistics and the Inception weights exist,
    # none otherwise (a warning per missing split, as in the JAX package)
    fid_metrics = None
    if trainer_cfg.get("fid", True):
        fid_metrics = build_validation_fid(data, stats_root=trainer_cfg.get("fid_stats_root", "."),
                                           warn=logging.getLogger(__name__).warning, device=device)

    profiler = None
    if trainer_cfg.get("profile_steps"):
        from bsi_torch.utils.profiling import StepWindowProfiler

        profiler = StepWindowProfiler(Path(run_dir) / "profile", num_steps=int(trainer_cfg["profile_steps"]))

    max_steps = int(trainer_cfg.get("max_steps", 10000))
    optimizer, lr_schedule = build_optimizer(
        task_cfg["optimizer"],
        task_cfg.get("lr_scheduler"),
        max_steps,
        trainer_cfg.get("gradient_clip_val", 1.0),
    )
    stall = trainer_cfg.get("stall_timeout_s")
    return Trainer(
        algorithm=algorithm,
        model=model,
        eval_model=eval_model,
        optimizer=optimizer,
        data=data,
        ema=build_ema(task_cfg.get("ema")),
        max_steps=max_steps,
        val_check_interval=int(trainer_cfg.get("val_check_interval", max_steps)),
        log_every=int(trainer_cfg.get("log_every_n_steps", 50)),
        n_elbo_recon_samples=int(task_cfg.get("n_elbo_recon_samples", 1)),
        n_elbo_measure_samples=int(task_cfg.get("n_elbo_measure_samples", 1)),
        limit_eval_batches=trainer_cfg.get("limit_eval_batches"),
        sanity_val_batches=int(trainer_cfg.get("num_sanity_val_steps", 0) or 0),
        run_dir=run_dir,
        logger=logger,
        config=config,
        seed=seed,
        device=device,
        callbacks=callbacks,
        preemption=preemption,
        profiler=profiler,
        async_checkpointing=bool(trainer_cfg.get("async_checkpointing", True)),
        accumulate_grad_batches=int(trainer_cfg.get("accumulate_grad_batches", 1) or 1),
        lr_schedule=lr_schedule,
        stall_timeout_s=float(stall) if stall is not None else None,
        fid_metrics=fid_metrics,
    )
