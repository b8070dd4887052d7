"""A tiny training config shared by the port's trainer, watchdog and CLI
tests: the repo's ``configs/`` with a 32-wide one-level UNet (or a 16-wide
MLP, or a 32-wide two-block DiT) on 4x4x3 synthetic images, batches of 4, on the CPU."""

from __future__ import annotations

from pathlib import Path

from bsi_torch.config import ConfigLoader
from bsi_torch.data import SyntheticDataModule

CONFIGS = Path(__file__).resolve().parents[1] / "configs"

TINY = [
    "data=synthetic", "data.data_shape=[4,4,3]", "data.n_train=16", "data.n_val=6", "data.batch_size=4",
    "data.eval_batch_size=4", "task.algorithm.k=3", "task.lr_scheduler.warmup_steps=2",
    "task.ema.update_after_step=1", "trainer.plots=no", "trainer.log_every_n_steps=1",
    "trainer.num_sanity_val_steps=0", "seed=5", "+trainer.device=cpu",
]
MODELS = {
    "unet": ["task.model.dim=32", "task.model.levels=1"],
    "mlp": ["task.model=mlp", "task.model.hidden_width=16"],
    "dit": ["task.model=dit", "task.model.dim=32", "task.model.depth=2", "task.model.heads=2",
            "task.model.dropout=0.1"],
}


def tiny_overrides(run_root, *extra: str, model: str = "unet") -> list[str]:
    return TINY + MODELS[model] + [f"run_root={run_root}", *extra]


def tiny_config(run_root, *extra: str, model: str = "unet", loader=ConfigLoader) -> dict:
    """The resolved tiny config (``loader`` may be the JAX package's)."""
    return loader(CONFIGS).load("train", tiny_overrides(run_root, *extra, model=model))


def tiny_trainer(tmp_path, *extra: str, model: str = "unet", name: str = "run", **kw):
    """The port's Trainer built by ``build_task`` from the tiny config, with
    its synthetic data module, in ``tmp_path / name``."""
    from bsi_torch.tasks import build_task

    config = tiny_config(tmp_path, *extra, model=model)
    data_cfg = {k: v for k, v in config["data"].items() if k not in ("_target_", "name")}
    data = SyntheticDataModule(seed=config["seed"], **data_cfg)
    return build_task(config, data, run_dir=tmp_path / name, seed=config["seed"], device="cpu", **kw)
