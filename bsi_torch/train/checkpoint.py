"""Checkpoints with the config in them.

Counterpart of ``bsi_tpu/train/checkpoint.py``, which writes an orbax tree.
A checkpoint here is a directory holding

- ``state.pt``: the whole :class:`~bsi_torch.train.TrainState` by
  ``torch.save``: ``step``, ``params``, ``ema_params``, the Adam state with
  its ``count``, ``dropout_seed`` and the generator's state, so a run resumed
  from it draws what the run that wrote it would have drawn next;
- ``meta.json``: the same as the JAX package's, ``config`` (the resolved
  config), ``data_state`` (the data stream's cursor) and ``extra``
  (``best_bpd``).

Both are written to a private name and renamed into place, and ``meta.json``
only after ``state.pt``, so a crash mid-write leaves the old checkpoint, or
the new state with the old cursor (resume then replays a few batches, never
skips any). orbax checkpoints of the JAX package are not read here; the
tests carry JAX states across with ``convert.train_state_from_jax``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import time
from pathlib import Path
from typing import Any, Optional

import torch

from .optim import AdamState
from .state import TrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def state_to_host(state: TrainState) -> dict[str, Any]:
    """The state as a dict of CPU tensors and numbers (copies); the only
    part of a save that waits for the device."""
    host = lambda tensors: {name: t.detach().to("cpu", copy=True) for name, t in tensors.items()}
    return {
        "step": int(state.step),
        "params": host(state.params),
        "ema_params": host(state.ema_params),
        "opt_state": {"count": int(state.opt_state.count), "mu": host(state.opt_state.mu),
                      "nu": host(state.opt_state.nu)},
        "dropout_seed": int(state.dropout_seed),
        "generator": state.generator.get_state(),
    }


def _replace_file(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def _write(path: Path, host: dict[str, Any], meta: dict[str, Any]) -> tuple[Path, float]:
    """Write a checkpoint; returns its path and the seconds it took."""
    t0 = time.perf_counter()
    path.mkdir(parents=True, exist_ok=True)
    _replace_file(path / STATE_FILE, lambda tmp: torch.save(host, tmp))
    _replace_file(path / META_FILE, lambda tmp: tmp.write_text(json.dumps(meta, indent=2, default=str)))
    return path, time.perf_counter() - t0


def _meta(config, data_state, extra) -> dict[str, Any]:
    return {"config": config, "data_state": data_state, "extra": extra or {}}


def save_checkpoint(
    path: str | Path,
    state: TrainState,
    *,
    config: Optional[dict] = None,
    data_state: Optional[dict] = None,
    extra: Optional[dict] = None,
) -> None:
    """Save a train state (+ config + data cursor + extra meta) to ``path``.

    ``extra`` carries small bookkeeping, such as the best validation bpd so
    far, so a requeued run does not overwrite ``ckpt_best`` with a worse
    model.
    """
    _write(Path(path).absolute(), state_to_host(state), _meta(config, data_state, extra))


class AsyncCheckpointWriter:
    """Checkpoint writer that overlaps disk writes with training.

    ``save`` blocks only for the device-to-host copy of the state; one
    background thread serialises and writes the checkpoints in the order
    they were saved, each ``meta.json`` after its ``state.pt``. ``wait``
    blocks until every save has been written, raises the first error a
    write met, and returns each write's path and seconds.
    """

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: list[concurrent.futures.Future] = []

    def save(
        self,
        path: str | Path,
        state: TrainState,
        *,
        config: Optional[dict] = None,
        data_state: Optional[dict] = None,
        extra: Optional[dict] = None,
    ) -> None:
        host = state_to_host(state)
        meta = _meta(config, data_state, extra)
        self._pending.append(self._pool.submit(_write, Path(path).absolute(), host, meta))

    def wait(self) -> list[tuple[Path, float]]:
        pending, self._pending = self._pending, []
        return [future.result() for future in pending]


def load_checkpoint(path: str | Path, state: TrainState) -> tuple[TrainState, dict]:
    """Restore a checkpoint written by :func:`save_checkpoint` into ``state``.

    ``state`` (a freshly initialised one, say) gives the devices and dtypes:
    its tensors are overwritten in place, its step, count, dropout seed and
    generator state set from the checkpoint. Returns ``(state, meta)``,
    ``meta`` with ``config``, ``data_state`` and ``extra``.
    """
    path = Path(path).absolute()
    saved = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for ours, theirs, what in ((state.params, saved["params"], "params"),
                                   (state.ema_params, saved["ema_params"], "ema_params"),
                                   (state.opt_state.mu, saved["opt_state"]["mu"], "mu"),
                                   (state.opt_state.nu, saved["opt_state"]["nu"], "nu")):
            if set(ours) != set(theirs):
                raise ValueError(f"checkpoint {path}: {what} names differ from the state's "
                                 f"({sorted(set(ours) ^ set(theirs))[:5]} ...)")
            for name, tensor in ours.items():
                if tensor.shape != theirs[name].shape:
                    raise ValueError(f"checkpoint {path}: {what}[{name}] has shape "
                                     f"{tuple(theirs[name].shape)}, the state {tuple(tensor.shape)}")
                tensor.copy_(theirs[name])
    state.step = int(saved["step"])
    state.opt_state = AdamState(count=int(saved["opt_state"]["count"]), mu=state.opt_state.mu,
                                nu=state.opt_state.nu)
    state.dropout_seed = int(saved["dropout_seed"])
    state.generator.set_state(saved["generator"])
    meta_file = path / META_FILE
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    return state, meta


def load_checkpoint_config(path: str | Path) -> dict:
    """The resolved config a checkpoint embeds in its ``meta.json`` (how the
    eval scripts rebuild the training setup)."""
    meta = json.loads((Path(path).absolute() / META_FILE).read_text())
    config = meta.get("config")
    if config is None:
        raise ValueError(f"Checkpoint at {path} does not embed a config")
    return config
