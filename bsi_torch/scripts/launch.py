"""Submit training runs to SLURM, or print per-node ``torchrun`` lines.

Counterpart of ``scripts/launch.py``:

    python -m bsi_torch.scripts.launch [--backend slurm|pod] [--nodes N]
        [--gpus-per-node G] [--name X] [--timeout-min M] [--mem-gb G]
        [--rdzv-endpoint HOST:PORT] [--dry-run] [-m] [overrides...]

Each sweep point (``-m``: comma lists and the config's ``sweep``, expanded
as ``python -m bsi_torch.train -m`` does) becomes one requeue-able sbatch
job, or one set of ``torchrun`` lines with ``--backend pod``. Without
``sbatch`` on the machine it dry-runs and prints where the scripts went.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from bsi_torch.utils.launcher import render_pod_commands, render_slurm_script, submit_slurm


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.launch")
    parser.add_argument("--backend", choices=["slurm", "pod"], default="slurm")
    parser.add_argument("--nodes", type=int, default=1)
    parser.add_argument("--gpus-per-node", type=int, default=8)
    parser.add_argument("--name", default="bsi-torch")
    parser.add_argument("--timeout-min", type=int, default=1440)
    parser.add_argument("--mem-gb", type=int, default=64)
    parser.add_argument("--grace-s", type=int, default=120)
    parser.add_argument("--run-root", default="runs")
    parser.add_argument("--rdzv-endpoint", default="localhost:29500")
    parser.add_argument("--out-dir", default="slurm-scripts")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("-m", "--multirun", action="store_true")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    if args.multirun:
        from bsi_torch.config import ConfigLoader
        from bsi_torch.train.__main__ import CONFIG_DIR, expand_sweep

        sweeps = expand_sweep(ConfigLoader(CONFIG_DIR), args.overrides)
    else:
        sweeps = [list(args.overrides)]

    for i, overrides in enumerate(sweeps):
        name = args.name if len(sweeps) == 1 else f"{args.name}-{i}"
        if args.backend == "pod":
            for j, cmd in enumerate(render_pod_commands(overrides, num_nodes=args.nodes,
                                                        gpus_per_node=args.gpus_per_node,
                                                        rdzv_endpoint=args.rdzv_endpoint, job_name=name,
                                                        run_root=args.run_root)):
                print(f"[{name} node {j}] {cmd}")
            continue
        script = render_slurm_script(overrides, job_name=name, nodes=args.nodes, gpus_per_node=args.gpus_per_node,
                                     mem_gb=args.mem_gb, timeout_min=args.timeout_min, grace_s=args.grace_s,
                                     run_root=args.run_root)
        path, job_id = submit_slurm(script, script_path=Path(args.out_dir) / f"{name}.sbatch",
                                    dry_run=True if args.dry_run else None)
        status = f"submitted as job {job_id}" if job_id else "dry-run (no sbatch)"
        print(f"[{name}] {path}: {status}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
