"""Metric logging: JSONL on disk, console summaries, optional W&B.

Counterpart of ``bsi_tpu/utils/logging.py``: one record per ``log`` call in
``<run_dir>/metrics.jsonl``, the resolved config in ``config.json``, console
lines, and a W&B run only when the config turns one on (``wandb`` is
imported then and only then).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Mapping, Optional


class MetricLogger:
    def __init__(
        self,
        run_dir: str | Path,
        *,
        wandb_config: Optional[Mapping[str, Any]] = None,
    ):
        self.run_dir = Path(run_dir)
        self._wandb = None
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._file = (self.run_dir / "metrics.jsonl").open("a")
        if wandb_config is not None and wandb_config.get("mode") != "disabled":
            try:
                import wandb

                self._wandb = wandb.init(dir=str(self.run_dir), **dict(wandb_config))
            except Exception as e:  # wandb missing or offline failure
                print(f"[logger] wandb unavailable ({e}); using JSONL only", file=sys.stderr)

    def log(self, step: int, metrics: Mapping[str, Any]) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: _to_py(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def log_hyperparams(self, config: Mapping[str, Any]) -> None:
        (self.run_dir / "config.json").write_text(json.dumps(config, indent=2, default=str))
        if self._wandb is not None:
            self._wandb.config.update(dict(config), allow_val_change=True)

    def console_line(self, text: str) -> None:
        print(text, flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()


class SilentLogger(MetricLogger):
    """The logger of a rank that writes nothing (every rank but 0 of a
    parallel run): no files, no console, no W&B."""

    def __init__(self):
        self._wandb = None
        self._file = None

    def log(self, step: int, metrics: Mapping[str, Any]) -> None:
        pass

    def log_hyperparams(self, config: Mapping[str, Any]) -> None:
        pass

    def console_line(self, text: str) -> None:
        pass


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def count_params(params: Mapping[str, Any]) -> int:
    """Elements in a dict of tensors."""
    return sum(int(p.numel()) for p in params.values())
