"""Real-set Inception statistics for FID.

Counterpart of ``scripts/compute_fid_stats.py``: embeds a split of a
dataset with the FID InceptionV3 and stores (n, sum, cov_sum), the
torchmetrics state format, under ``<out-root>/data/fid-stats/<dataset>/
<split>.npz``. ``train`` covers the whole training set, the validation
split included. Trailing overrides reach the config (``data.root=...``,
``data.data_shape=[32,32,3]``; ``+trainer.device=cpu`` runs on the CPU).

    python -m bsi_torch.scripts.compute_fid_stats <dataset> <train|val|test>
        [--inception-weights W] [--batch-size 512] [--out-root .] [overrides...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from bsi_torch.config import ConfigLoader, instantiate
from bsi_torch.metrics import (FeatureStats, default_weights_path, fid_stats_path, images_to_uint8, load_params,
                               make_embed_fn)

from ._common import REPO_ROOT


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.compute_fid_stats", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset")
    parser.add_argument("split", choices=["train", "val", "test"])
    parser.add_argument("--inception-weights", default=None)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--out-root", default=str(REPO_ROOT))
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    weights = args.inception_weights or default_weights_path()
    if weights is None:
        raise SystemExit("Inception weights not found: pass --inception-weights or set BSI_TPU_INCEPTION_WEIGHTS")

    config = ConfigLoader(REPO_ROOT / "configs").load(
        "train", [f"data={args.dataset}", f"data.eval_batch_size={args.batch_size}", *args.overrides])
    embed = make_embed_fn(load_params(weights), device=config.get("trainer", {}).get("device"))
    data = instantiate(config["data"], seed=0)
    disc = data.discretization()

    if args.split == "train":
        # the whole training set, its validation split included
        sources = [data._train, data._val]
    elif args.split == "val":
        sources = [data.eval_splits()["val"]]
    else:
        sources = [data.test_splits()["test"]]

    total = sum(len(s) for s in sources)
    stats = FeatureStats(2048)
    for arrays in sources:
        for start in range(0, len(arrays), args.batch_size):
            idx = np.arange(start, min(start + args.batch_size, len(arrays)))
            batch = torch.from_numpy(np.asarray(data._prepare(arrays[idx])))
            stats.update(embed(images_to_uint8(disc.to_unit_interval(batch).numpy())))
            print(f"{stats.n}/{total}", end="\r")

    out = fid_stats_path(args.out_root, data.short_name(), args.split)
    stats.save_npz(out)
    print(f"\nwrote {out} (n={stats.n})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
