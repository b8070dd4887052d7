"""Shared plumbing of the eval scripts.

Counterpart of ``scripts/_common.py``: a script rebuilds the training setup
from the config its checkpoint embeds (``meta.json``), with ``key=value``
overrides (``+key=value`` adds a key) read by the port's config engine.
The scripts run on the card unless the overrides carry
``+trainer.device=cpu`` (or the checkpoint's own config names the CPU, as a
CPU run's does).

The scripts parse their arguments intermixed (``parse_intermixed_args``),
so the overrides may follow the flags: ``parse_args`` of some Python 3.12
releases refuses ``compute_fid_stats synthetic train --out-root R
data.data_shape=[32,32,3]``'s override.

Their draws come from ``torch.Generator``s seeded with the JAX scripts'
constants, so they are not JAX's draws.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

from bsi_torch.config import instantiate, resolve_interpolations
from bsi_torch.config.config import _set_path, _yaml_load
from bsi_torch.tasks import build_task
from bsi_torch.train import load_checkpoint_config
from bsi_torch.utils.seed import resolve_seed

REPO_ROOT = Path(__file__).resolve().parents[2]
# the JAX scripts' PRNG seeds: sampling and the ELBO, then trajectories and
# the per-noise-level errors
SAMPLE_SEED = 5410195033249451849
HISTORY_SEED = 2363185049904024905


def load_trainer(ckpt_path: str, overrides: list[str] = (), *, run_dir: str | Path | None = None):
    """Rebuild ``(trainer, config, data)`` from a checkpoint and overrides and
    restore its state. The trainer's log goes to ``run_dir`` (a directory in
    the temp dir when None)."""
    config = load_checkpoint_config(ckpt_path)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        _set_path(config, key.lstrip("+"), _yaml_load(raw), allow_new=key.startswith("+"))
    config = resolve_interpolations(config)
    seed = resolve_seed(config)

    data = instantiate(config["data"], seed=seed)
    run_dir = run_dir or Path(tempfile.gettempdir()) / "bsi_torch_eval"
    trainer = build_task(config, data, run_dir=run_dir, seed=seed)
    trainer.restore(ckpt_path)
    return trainer, config, data


def eval_dataloader(data, split: str):
    """Batches of the requested split ('test', 'val' or 'train')."""
    splits = data.test_splits() if split == "test" else data.eval_splits()
    if split in splits:
        arr = splits[split]
    elif split == "train":
        arr = splits["train"]
    else:
        raise ValueError(f"Unknown split {split!r}; options: {sorted(splits)}")
    return data.eval_batches(arr)
