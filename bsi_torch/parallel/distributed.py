"""Joining the processes of a run, and this process's share of the data.

Counterpart of ``bsi_tpu/parallel/distributed.py``. One process drives one
GPU; ``torchrun`` (or the SLURM script of ``bsi_torch/utils/launcher.py``)
starts them and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``. Each data rank then reads its own
``1/data_size`` of every batch, and the pipe and model ranks of one replica
read the same rows; its batch stays on its own device (JAX's
``make_array_from_process_local_data`` has no counterpart).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# How long a collective waits for the other ranks before it fails the run.
TIMEOUT_S = 1800.0


def initialize_distributed(device: Optional[str] = None) -> bool:
    """Join the process group that the environment describes, before
    anything touches the card; returns whether a group exists.

    The decision is the environment's alone: with none of torchrun's
    variables set this does nothing. On a card (``device`` None or
    ``"cuda"``) the group is NCCL, after ``torch.cuda.set_device(LOCAL_RANK)``;
    with ``device="cpu"`` it is gloo. NCCL without a card raises: a run that
    asked for the card never carries on over gloo.
    """
    if dist.is_initialized():
        return True
    if not all(os.environ.get(k) for k in _ENV):
        missing = [k for k in _ENV if os.environ.get(k)]
        if missing:
            raise RuntimeError(f"torch.distributed environment incomplete: {missing} set, but "
                               f"{[k for k in _ENV if not os.environ.get(k)]} not")
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("a process group over NCCL needs a CUDA device, and there is none; "
                               "ask for the CPU (+trainer.device=cpu) to run over gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend="gloo" if cpu else "nccl", timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **({} if cpu else {"device_id": torch.device("cuda", torch.cuda.current_device())}))
    return True


def host_shard(model_parallelism: int = 1, pipeline_parallelism: int = 1) -> tuple[int, int]:
    """``(shard_id, num_shards)`` of this process's data: its data rank and
    the data size (the pipe and model ranks of one replica read the same
    rows)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    world, rank = dist.get_world_size(), dist.get_rank()
    per_replica = model_parallelism * pipeline_parallelism
    if world % per_replica:
        raise ValueError(f"{world} devices not divisible by model_parallelism={model_parallelism}"
                         + (f" x pipeline_parallelism={pipeline_parallelism}" if pipeline_parallelism > 1 else ""))
    return rank // per_replica, world // per_replica


def check_host_batch(local_rows: int, global_batch: int, num_shards: int) -> None:
    """The divisibility contract of a host-sharded batch: every data rank
    holds exactly ``global_batch / num_shards`` rows."""
    if local_rows * num_shards != global_batch:
        raise ValueError(
            f"host shard of {local_rows} rows x {num_shards} processes = "
            f"{local_rows * num_shards} rows, but the configured global batch is "
            f"{global_batch}; multi-host batches must be equal per host "
            f"(global_batch % num_hosts == 0)"
        )
