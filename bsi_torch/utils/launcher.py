"""Cluster launchers: a SLURM sbatch script and per-node ``torchrun`` lines.

Counterpart of ``bsi_tpu/utils/launcher.py``. One process drives one GPU:

- :func:`render_slurm_script`: an sbatch script that starts
  ``--gpus-per-node`` processes on each of ``--nodes`` nodes
  (``--ntasks-per-node``), each running ``python -m bsi_torch.train`` with
  torch.distributed's variables set from SLURM's (``MASTER_ADDR`` the first
  node, ``WORLD_SIZE`` the tasks, ``RANK`` and ``LOCAL_RANK`` the task's
  ``SLURM_PROCID`` and ``SLURM_LOCALID``), armed with
  ``--signal=USR1@<grace>`` and ``--requeue``: the
  :class:`~bsi_torch.utils.preemption.PreemptionHandler` writes
  ``ckpt_interrupt`` and the requeued job resumes from it (``from_ckpt``);
- :func:`render_pod_commands`: the ``torchrun --nnodes --nproc-per-node
  --rdzv-endpoint`` line of each node, for any fan-out tool;
- :func:`submit_slurm`: write the script and hand it to ``sbatch``, or
  dry-run where there is no ``sbatch``.

Each job's runs live under ``<run_root>/<job name>``, so a requeued job
finds its own newest ``ckpt_interrupt``.
"""

from __future__ import annotations

import shlex
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={gpus_per_node}
#SBATCH --gpus-per-node={gpus_per_node}
#SBATCH --cpus-per-task={cpus_per_task}
#SBATCH --mem={mem_gb}G
#SBATCH --time={timeout_min}
#SBATCH --signal=USR1@{grace_s}
#SBATCH --requeue
#SBATCH --open-mode=append
#SBATCH --output={log_dir}/%x-%j.out
{extra_directives}
# torch.distributed over NCCL: one process a GPU, the first node hosts the
# rendezvous.
nodes=($(scontrol show hostnames "$SLURM_JOB_NODELIST"))
export MASTER_ADDR="${{nodes[0]}}"
export MASTER_PORT="{master_port}"
export WORLD_SIZE="$SLURM_NTASKS"

# On requeue, resume from this job's newest interrupt checkpoint.
resume=""
ckpt=$(ls -dt {run_root}/{job_name}/*/*/ckpt_interrupt 2>/dev/null | head -n 1)
if [ -n "$ckpt" ]; then
  resume="from_ckpt=$ckpt"
fi

srun --kill-on-bad-exit=1 bash -c '
  export RANK="$SLURM_PROCID" LOCAL_RANK="$SLURM_LOCALID"
  exec {python} -m bsi_torch.train {args} '"$resume"'
'
"""


def _job_args(args: Sequence[str], run_root: str, job_name: str) -> list[str]:
    return [*args, f"run_root={run_root}/{job_name}"]


def render_slurm_script(
    args: Sequence[str],
    *,
    job_name: str = "bsi-torch",
    nodes: int = 1,
    gpus_per_node: int = 8,
    cpus_per_task: int = 8,
    mem_gb: int = 64,
    timeout_min: int = 1440,
    grace_s: int = 120,
    master_port: int = 29500,
    run_root: str = "runs",
    log_dir: str = "slurm-logs",
    python: str = "python",
    extra_directives: Sequence[str] = (),
) -> str:
    """A requeue-able sbatch script for one training run on ``nodes`` x
    ``gpus_per_node`` GPUs. ``--signal=USR1@grace`` is the reference's
    ``signal: USR1@120``."""
    return SLURM_TEMPLATE.format(
        job_name=job_name,
        nodes=nodes,
        gpus_per_node=gpus_per_node,
        cpus_per_task=cpus_per_task,
        mem_gb=mem_gb,
        timeout_min=timeout_min,
        grace_s=grace_s,
        master_port=master_port,
        run_root=run_root,
        log_dir=log_dir,
        python=python,
        args=" ".join(shlex.quote(a) for a in _job_args(args, run_root, job_name)),
        extra_directives="\n".join(f"#SBATCH {d}" for d in extra_directives),
    )


def render_pod_commands(
    args: Sequence[str],
    *,
    num_nodes: int,
    gpus_per_node: int = 8,
    rdzv_endpoint: str = "localhost:29500",
    job_name: str = "bsi-torch",
    run_root: str = "runs",
    torchrun: str = "torchrun",
) -> list[str]:
    """The ``torchrun`` command line of each node, the same on every node:
    ``num_nodes`` x ``gpus_per_node`` processes meeting at
    ``rdzv_endpoint`` (a host and port every node reaches)."""
    tail = " ".join(shlex.quote(a) for a in _job_args(args, run_root, job_name))
    cmd = (f"{torchrun} --nnodes={num_nodes} --nproc-per-node={gpus_per_node} --rdzv-backend=c10d "
           f"--rdzv-endpoint={rdzv_endpoint} --rdzv-id={job_name} -m bsi_torch.train {tail}")
    return [cmd] * num_nodes


def torchrun_env(*, rank: int = 0, world_size: int = 1, local_rank: int = 0, master_addr: str = "localhost",
                 master_port: int = 29500) -> dict[str, str]:
    """The variables ``torchrun`` sets for one process, as
    :func:`bsi_torch.parallel.initialize_distributed` reads them."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world_size), "LOCAL_RANK": str(local_rank),
            "LOCAL_WORLD_SIZE": str(world_size), "MASTER_ADDR": master_addr, "MASTER_PORT": str(master_port)}


def submit_slurm(
    script: str,
    *,
    script_path: str | Path,
    dry_run: Optional[bool] = None,
) -> tuple[Path, Optional[str]]:
    """Write ``script`` to ``script_path`` and submit it with ``sbatch``.

    Returns ``(path, job_id)``; ``job_id`` is None in a dry run (forced
    where ``sbatch`` is not on the path).
    """
    path = Path(script_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(script)
    if dry_run is None:
        dry_run = shutil.which("sbatch") is None
    if dry_run:
        return path, None
    out = subprocess.run(["sbatch", "--parsable", str(path)], capture_output=True, text=True, check=True)
    return path, out.stdout.strip().split(";")[0]
