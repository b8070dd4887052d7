"""Whole sampling trajectories as 8-bit arrays.

Counterpart of ``scripts/generate_sample_history.py``: runs
``sample_history`` and stores the (mus, x_hats, ys) trajectories, or the
x_hats alone for VDM, as uint8 in an ``.npz``.

    python -m bsi_torch.scripts.generate_sample_history -c <ckpt_dir> -o out.npz -n 16 [-k 64]
        [-s linear] [--seed S] [overrides...]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from bsi_torch.core import get_schedule

from ._common import HISTORY_SEED, load_trainer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.generate_sample_history",
                                     description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-o", "--out", required=True)
    parser.add_argument("-n", "--num-samples", type=int, default=16)
    parser.add_argument("-k", type=int, default=None)
    parser.add_argument("-s", "--schedule", default="linear")
    parser.add_argument("--seed", type=int, default=HISTORY_SEED)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    trainer, config, data = load_trainer(args.checkpoint, args.overrides)
    algo, device = trainer.algorithm, trainer.device
    disc = data.discretization()
    t = get_schedule(args.schedule, args.k or algo.k, algo, device=device)

    model_fn = trainer.eval_model_fn()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    history = algo.sample_history(model_fn, generator, args.num_samples, device=device, t=t)

    to8 = lambda a: disc.to_8bit_image(a).cpu().numpy()
    if isinstance(history, tuple):
        mus, x_hats, ys = history
        out = {"mus": to8(mus), "x_hats": to8(x_hats), "ys": to8(ys)}
    else:  # VDM returns only the x_hat trajectory
        out = {"x_hats": to8(history)}

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **out)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
