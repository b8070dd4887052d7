"""Bulk sampling from a checkpoint.

Counterpart of ``scripts/generate_samples.py``: draws ``n`` samples at a
step count and schedule (the EMA weights, or the raw ones with
``--noema``) and saves them, with the Inception embeddings' sums and the
FID against each precomputed split when the weights and statistics exist,
to one ``.npz``.

    python -m bsi_torch.scripts.generate_samples -c <ckpt_dir> -o out.npz -n 1024 [-k 128]
        [-s linear] [--noema] [--seed S] [--fid-stats-root .] [overrides...]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from bsi_torch.core import get_schedule
from bsi_torch.metrics import (FeatureStats, default_weights_path, fid_from_stats, fid_stats_path, images_to_uint8,
                               load_params, make_embed_fn)
from bsi_torch.train import make_sample_fn

from ._common import SAMPLE_SEED, load_trainer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.generate_samples", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-o", "--out", required=True)
    parser.add_argument("-n", "--num-samples", type=int, required=True)
    parser.add_argument("-k", type=int, default=None)
    parser.add_argument("-s", "--schedule", default="linear")
    parser.add_argument("--noema", action="store_true", help="use raw (non-EMA) weights")
    parser.add_argument("--seed", type=int, default=SAMPLE_SEED)
    parser.add_argument("--fid-stats-root", default=".")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    trainer, config, data = load_trainer(args.checkpoint, args.overrides)
    algo = trainer.algorithm
    disc = data.discretization()
    k = args.k or algo.k
    t = get_schedule(args.schedule, k, algo, device=trainer.device)
    sample_fn = make_sample_fn(algo, trainer.eval_apply, use_ema=not args.noema, layout=trainer.layout)

    batch_size = data.eval_batch_size
    generator = torch.Generator(device=trainer.device).manual_seed(args.seed)
    chunks = []
    remaining = args.num_samples
    while remaining > 0:
        batch = sample_fn(trainer.state, generator, batch_size, t=t)
        chunks.append(batch.cpu().numpy()[:min(batch_size, remaining)])
        remaining -= batch_size
        print(f"{args.num_samples - max(remaining, 0)}/{args.num_samples}", end="\r")
    samples = np.concatenate(chunks)

    out = {"samples": samples, "k": k, "schedule": args.schedule, "ema": not args.noema}

    weights = default_weights_path()
    if weights is not None:
        embed = make_embed_fn(load_params(weights), device=trainer.device)
        imgs = images_to_uint8(disc.to_unit_interval(torch.from_numpy(samples)).numpy())
        stats = FeatureStats(2048)
        for s in range(0, len(imgs), 256):
            stats.update(embed(imgs[s:s + 256]))
        out["embedding_sum"] = stats.sum
        out["embedding_cov_sum"] = stats.cov_sum
        out["embedding_n"] = stats.n
        for split in ("train", "test"):
            path = fid_stats_path(args.fid_stats_root, data.short_name(), split)
            if path.exists():
                out[f"fid_{split}"] = fid_from_stats(stats, FeatureStats.from_npz(path))
                print(f"\nFID vs {split}: {out[f'fid_{split}']:.3f}")

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **out)
    print(f"\nwrote {out_path} ({len(samples)} samples)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
