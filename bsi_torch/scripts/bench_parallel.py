"""Train throughput under the parallel layouts: DP, FSDP, TP, SP, PP.

    torchrun --nproc_per_node N -m bsi_torch.scripts.bench_parallel [--dp D] [--tp T] [--pp P] [--sp]
        [--fsdp] [--micro M] [--dcn S] [--batch B] [--steps 40] [--model dit|unet]

Counterpart of ``scripts/bench_parallel.py``; one process a card, as
``torchrun`` starts them. For example, on 8 cards:

    torchrun --nproc_per_node 8 -m bsi_torch.scripts.bench_parallel --dp 8                  # pure DP
    torchrun --nproc_per_node 8 -m bsi_torch.scripts.bench_parallel --dp 4 --tp 2 --fsdp    # TP x FSDP
    torchrun --nproc_per_node 8 -m bsi_torch.scripts.bench_parallel --dp 4 --tp 2 --sp      # Megatron-SP
    torchrun --nproc_per_node 8 -m bsi_torch.scripts.bench_parallel --dp 2 --pp 4 --micro 8 # GPipe PP
    torchrun --nproc_per_node 8 -m bsi_torch.scripts.bench_parallel --dp 2 --pp 2 --tp 2    # PP x TP

Runs the production ``Trainer`` (the train step the recipes run) on
synthetic data of the recipe's shape, the bench model (DiT-L/2, dropout
0.05, or the CIFAR-10 UNet, dropout 0.1; bf16 compute, AdamW 5e-4) over the
mesh ``bsi_torch.parallel.make_mesh`` lays out, and prints one JSON line
from rank 0: examples/s a card and ms a step, from ``metrics.jsonl``'s
timestamps after the first step, the peak device memory of rank 0, and the
card's name and power limit. ``--dp 1`` is the same protocol on one card;
under ``torchrun`` it runs over a process group of one rank (NCCL). The
product of the factors must be the world size; a world size that the
model, pipe and DCN factors do not divide raises ``make_mesh``'s message.
Runs on the card, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from bsi_torch.core.common import resolve_device
from bsi_torch.data import SyntheticDataModule
from bsi_torch.parallel import initialize_distributed, make_mesh
from bsi_torch.profile_sampling import build_algo, build_model, card
from bsi_torch.scripts.bench_train import DROPOUT
from bsi_torch.train import EMAConfig, make_optimizer, warmup_cosine_schedule
from bsi_torch.train.loop import Trainer
from bsi_torch.utils.logging import MetricLogger, SilentLogger


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.bench_parallel",
                                description=__doc__.splitlines()[0])
    p.add_argument("--dp", type=int, default=1, help="data-parallel ways")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ways")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages")
    p.add_argument("--sp", action="store_true", help="sequence parallelism (needs --tp > 1)")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--micro", type=int, default=None, help="PP microbatches")
    p.add_argument("--dcn", type=int, default=1, help="data-parallel ways across nodes")
    p.add_argument("--batch", type=int, default=None, help="global batch (default 64 a card)")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--model", choices=("dit", "unet"), default="dit")
    p.add_argument("--device", default=None, help="cpu to run on the CPU over gloo (default: the card)")
    return p.parse_args(argv)


def run(args: argparse.Namespace, model=None) -> dict | None:
    """The bench of ``args``; returns rank 0's record (None on the other
    ranks). ``model`` stands in for the full-width one (the tests' narrow
    DiT)."""
    initialize_distributed(args.device)
    device = resolve_device(args.device)
    n_cards = args.dp * args.tp * args.pp * args.dcn
    mesh = make_mesh(model_parallelism=args.tp, pipeline_parallelism=args.pp, dcn_data_parallelism=args.dcn)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_cards:
        raise ValueError(f"the mesh needs {n_cards} processes (dp {args.dp} x tp {args.tp} x pp {args.pp} x "
                         f"dcn {args.dcn}), and the world has {world}")
    batch = args.batch or 64 * n_cards
    if model is None:
        kw = dict(scan_blocks=args.pp > 1) if args.model == "dit" else {}
        model = build_model(args.model, device, dropout=DROPOUT[args.model], **kw)
    shape = tuple(model.data_shape)
    data = SyntheticDataModule(n_train=max(4 * batch, 512), n_val=batch, data_shape=shape, batch_size=batch,
                               train_eval_size=batch, shard_id=mesh.data_rank, num_shards=mesh.data_size)
    writes = not dist.is_initialized() or dist.get_rank() == 0
    with tempfile.TemporaryDirectory(prefix="bsi_torch_bench_parallel_") as tmp:
        run_dir = Path(tmp)
        trainer = Trainer(
            algorithm=build_algo(50, shape[0]),
            model=model,
            optimizer=make_optimizer(warmup_cosine_schedule(5e-4, 100, 10**6)),
            data=data,
            ema=EMAConfig(update_after_step=10**9),
            max_steps=args.steps,
            val_check_interval=10**9,
            log_every=1,
            run_dir=run_dir,
            logger=MetricLogger(run_dir) if writes else SilentLogger(),
            seed=0,
            device=device,
            mesh=mesh,
            fsdp=args.fsdp,
            sequence_parallel=args.sp,
            pp_microbatches=args.micro,
        )
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        trainer.fit()
        wall = time.monotonic() - t0
        trainer.logger.close()
        if not writes:
            return None
        recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()
                if '"train/loss"' in line]
    # a step's time from the records' timestamps, the first step's skipped
    pts = [(r["step"], r["time"]) for r in recs]
    spans = [(s2 - s1, t2 - t1) for (s1, t1), (s2, t2) in zip(pts[1:], pts[2:]) if t2 > t1]
    step_s = sum(t for _, t in spans) / max(sum(s for s, _ in spans), 1)
    layout = (f"dp{args.dp} tp{args.tp} pp{args.pp}{' sp' if args.sp else ''}{' fsdp' if args.fsdp else ''}"
              f"{f' dcn{args.dcn}' if args.dcn > 1 else ''}")
    return {
        "metric": f"bsi-{args.model} train throughput ({layout}, global batch {batch})",
        "value": batch / step_s / n_cards,
        "unit": "examples/sec/chip",
        "step_ms": step_s * 1e3,
        "chips": n_cards,
        "wall_s": wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None,
        **card(device),
    }


def main(argv=None) -> None:
    record = run(parse_args(argv))
    if record is not None:
        print(json.dumps(record), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
