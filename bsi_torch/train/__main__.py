"""Training entry point of the port.

Counterpart of the repo's ``train.py``, over the same ``configs/`` tree:

    python -m bsi_torch.train experiment=cifar10-vdm
    python -m bsi_torch.train data=synthetic mode=debug +trainer.device=cpu
    python -m bsi_torch.train -m experiment=cifar10-vdm seed=1,2   # a sweep

It runs on the card unless ``+trainer.device=cpu`` asks for the CPU, and
raises when there is no card and no such request. Checkpoints embed the
resolved config; resume with ``from_ckpt=<dir>``.

On several GPUs, one process each, as ``torchrun`` starts them (or
``python -m bsi_torch.scripts.launch`` on SLURM):

    torchrun --nproc-per-node=8 -m bsi_torch.train experiment=imagenet32 \
        trainer.fsdp=yes trainer.model_parallelism=2

Each process joins the group from torchrun's variables before anything
touches the card (NCCL; gloo on the CPU), reads its data rank's share of
every batch, and rank 0 alone writes the logs, plots and checkpoints.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import sys
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from bsi_torch.config import ConfigLoader, instantiate
from bsi_torch.parallel import host_shard, initialize_distributed
from bsi_torch.tasks import build_task
from bsi_torch.utils.logging import MetricLogger, SilentLogger
from bsi_torch.utils.preemption import PreemptionHandler
from bsi_torch.utils.seed import resolve_seed

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"


def _from_rank0(value):
    """``value`` as rank 0 has it, on every rank (itself without a group):
    the run seed a config without one draws, the run directory's stamp."""
    box = [value]
    if dist.is_initialized():
        dist.broadcast_object_list(box, src=0)
    return box[0]


def run_one(config: dict) -> dict:
    """Train (and test, where the config asks) one resolved config."""
    trainer_cfg = config.get("trainer", {})
    initialize_distributed(trainer_cfg.get("device"))
    seed = config["seed"] = _from_rank0(resolve_seed(config))
    if config.get("debug_nans"):
        import torch

        torch.autograd.set_detect_anomaly(True)
    title = config.get("title") or "run"
    name = config.get("name") or config["task"].get("name", "task")
    stamp = _from_rank0(time.strftime("%Y%m%d-%H%M%S"))
    run_dir = Path(config.get("run_root", "runs")) / str(title) / f"{name}-{seed % 10**6}-{stamp}"

    # Requeue: reuse the W&B run recorded in the checkpoint we resume from.
    from_ckpt = config.get("from_ckpt")
    wandb_cfg = dict(config.get("logging", {}).get("wandb") or {})
    if from_ckpt:
        meta_file = Path(from_ckpt) / "meta.json"
        if meta_file.exists():
            prev = json.loads(meta_file.read_text()).get("config") or {}
            prev_id = (prev.get("logging", {}).get("wandb") or {}).get("id")
            if prev_id:
                wandb_cfg.update({"id": prev_id, "resume": "allow"})

    shard_id, num_shards = host_shard(int(trainer_cfg.get("model_parallelism", 1) or 1),
                                      int(trainer_cfg.get("pipeline_parallelism", 1) or 1))
    data = instantiate(config["data"], seed=seed, shard_id=shard_id, num_shards=num_shards)
    writes = not dist.is_initialized() or dist.get_rank() == 0
    logger = MetricLogger(run_dir, wandb_config=wandb_cfg) if writes else SilentLogger()
    preemption = PreemptionHandler().install()
    try:
        if getattr(logger, "_wandb", None) is not None:
            config.setdefault("logging", {}).setdefault("wandb", {})["id"] = logger._wandb.id
        logger.console_line(f"run dir: {run_dir}")
        logger.console_line(json.dumps(config, indent=2, default=str))
        trainer = build_task(config, data, run_dir=run_dir, seed=seed, logger=logger, preemption=preemption)
        metrics = trainer.fit(from_checkpoint=from_ckpt)
        if config.get("eval_testset") and not metrics.get("preempted"):
            # test the best checkpoint, not the final state
            best_ckpt = trainer.run_dir / "ckpt_best"
            if best_ckpt.exists():
                trainer.restore(best_ckpt)
            metrics.update(trainer.test())
    finally:
        preemption.uninstall()
        logger.close()
    return metrics


def expand_sweep(loader: ConfigLoader, overrides: list[str]) -> list[list[str]]:
    """Expand the chosen config's ``sweep`` table and comma-lists in CLI
    overrides (``seed=1,2 task=vdm,bsi``) into a cartesian product."""
    base_overrides: list[str] = []
    axes: list[list[str]] = []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        # a bare top-level comma list (no brackets/braces) sweeps that key
        if "," in raw and not any(ch in raw for ch in "[]{}"):
            axes.append([f"{key}={v}" for v in raw.split(",")])
        else:
            base_overrides.append(ov)

    probe = base_overrides + [axis[0] for axis in axes]
    base = loader.load("train", probe)
    for key, values in (base.get("sweep") or {}).items():
        if not any(axis[0].startswith(f"{key}=") for axis in axes):
            axes.append([f"{key}={v}" for v in values])

    expanded: list[list[str]] = [base_overrides]
    for axis in axes:
        expanded = [prev + [choice] for prev in expanded for choice in axis]
    return expanded


def main(argv: list[str] | None = None) -> int:
    faulthandler.enable()
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.train", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("overrides", nargs="*", help="config overrides (key=value)")
    parser.add_argument("-m", "--multirun", action="store_true", help="run the sweep")
    args = parser.parse_args(argv)

    loader = ConfigLoader(CONFIG_DIR)
    runs = expand_sweep(loader, args.overrides) if args.multirun else [args.overrides]

    results = []
    for i, ov in enumerate(runs):
        config = loader.load("train", ov)
        config.pop("sweep", None)
        if len(runs) > 1:
            print(f"=== run {i + 1}/{len(runs)}: {ov} ===", flush=True)
        try:
            results.append(run_one(config))
        except Exception:
            # print before re-raising: launchers that capture output can
            # swallow the traceback
            traceback.print_exc()
            raise
    # the best checkpoint's score, per run and across the sweep
    scores = [r.get("best/bpd", r.get("val/bpd")) for r in results]
    scores = [s for s in scores if s is not None]
    if scores:
        print(f"best val/bpd: {min(scores):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
