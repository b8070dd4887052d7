"""FID over sampling-step counts and a schedule.

Counterpart of ``scripts/eval_fid.py``: for each ``k`` of the sweep, draws
``n`` samples with the schedule (linear, cosine, edm or edm7 in
lambda-variance space), embeds them with the FID InceptionV3 and computes
the FID against the precomputed train AND test statistics. The JSON is
written even when the sweep fails part-way.

    python -m bsi_torch.scripts.eval_fid -c <ckpt_dir> -o out.json -k 10 20 50 [-s linear]
        [-n N] [--fid-stats-root .] [--inception-weights W] [--batch-size B] [overrides...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from bsi_torch.core import get_schedule
from bsi_torch.metrics import (FeatureStats, default_weights_path, fid_from_stats, fid_stats_path, images_to_uint8,
                               load_params, make_embed_fn)

from ._common import SAMPLE_SEED, load_trainer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.eval_fid", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-o", "--out", required=True)
    parser.add_argument("-n", "--num-samples", type=int, default=None)
    parser.add_argument("-s", "--schedule", default="linear")
    parser.add_argument("-k", nargs="+", type=int, required=True)
    parser.add_argument("--fid-stats-root", default=".")
    parser.add_argument("--inception-weights", default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    weights = args.inception_weights or default_weights_path()
    if weights is None:
        raise SystemExit("Inception weights not found: pass --inception-weights or set BSI_TPU_INCEPTION_WEIGHTS "
                         "(no weights can be downloaded here)")

    trainer, config, data = load_trainer(args.checkpoint, args.overrides)
    embed = make_embed_fn(load_params(weights), device=trainer.device)
    algo = trainer.algorithm
    disc = data.discretization()

    real_stats = {split: FeatureStats.from_npz(fid_stats_path(args.fid_stats_root, data.short_name(), split))
                  for split in ("train", "test")}
    n = args.num_samples or real_stats["test"].n
    batch_size = args.batch_size or data.eval_batch_size

    generator = torch.Generator(device=trainer.device).manual_seed(SAMPLE_SEED)
    fids: dict[int, dict[str, float]] = {}
    out_path = Path(args.out)
    try:
        for k in args.k:
            t = get_schedule(args.schedule, k, algo, device=trainer.device)
            fake = FeatureStats(len(real_stats["test"].sum))
            remaining = n
            while remaining > 0:
                take = min(batch_size, remaining)
                batch = trainer.sample_fn(trainer.state, generator, batch_size, t=t)
                fake.update(embed(images_to_uint8(disc.to_unit_interval(batch).cpu().numpy())[:take]))
                remaining -= take
            fids[k] = {split: fid_from_stats(fake, real_stats[split]) for split in real_stats}
            print(f"k={k}: {fids[k]}")
    finally:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({
            "ckpt": str(args.checkpoint),
            "config": {"n": n, "k": args.k, "schedule": args.schedule, "overrides": args.overrides},
            "fid": fids,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
