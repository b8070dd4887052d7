"""Bits per dimension from the infinite- or finite-step ELBO.

Counterpart of ``scripts/eval_elbo.py``: for each step count ``k`` (or
``inf``) the per-example bpd with Monte Carlo variance estimates over a data
split, the across-batch and within-estimator variances aggregated into one
standard error, ``(var(ddof=1) + mean(bpd_var)) / n``.

    python -m bsi_torch.scripts.eval_elbo -c <ckpt_dir> -o out.json [-k inf 10 100]
        [--split test] [-r 2] [-m 2] [overrides...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from bsi_torch.core import VDM

from ._common import SAMPLE_SEED, eval_dataloader, load_trainer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.eval_elbo", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-o", "--out", required=True)
    parser.add_argument("-k", nargs="+", default=["inf"], help="step counts or 'inf'")
    parser.add_argument("--split", default="test")
    parser.add_argument("-r", "--recon-samples", type=int, default=2)
    parser.add_argument("-m", "--measure-samples", type=int, default=2)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    trainer, config, data = load_trainer(args.checkpoint, args.overrides)
    algo, device = trainer.algorithm, trainer.device
    model_fn = trainer.eval_model_fn()
    generator = torch.Generator(device=device).manual_seed(SAMPLE_SEED)

    results_mean, results_var = {}, {}
    for k in args.k:
        t = None
        if k != "inf":
            ends = (1.0, 0.0) if isinstance(algo, VDM) else (0.0, 1.0)
            t = torch.linspace(*ends, int(k) + 1, device=device)
        bpds, bpd_vars = [], []
        with torch.inference_mode():
            for batch, mask in eval_dataloader(data, args.split):
                x = torch.as_tensor(batch, device=device)
                if t is None:
                    _, bpd, extra = algo.elbo(model_fn, generator, x, args.recon_samples, args.measure_samples,
                                              estimate_var=True)
                else:
                    _, bpd, extra = algo.finite_elbo(model_fn, generator, x, args.recon_samples,
                                                     args.measure_samples, t=t, estimate_var=True)
                bpds.append(bpd.cpu().numpy()[mask])
                bpd_vars.append(extra["bpd_var"].cpu().numpy()[mask])
        bpds = np.concatenate(bpds)
        bpd_vars = np.concatenate(bpd_vars)
        n = len(bpds)
        results_mean[str(k)] = float(bpds.mean())
        results_var[str(k)] = float((bpds.var(ddof=1) + bpd_vars.mean()) / n)
        print(f"k={k}: bpd {results_mean[str(k)]:.4f} +- {np.sqrt(results_var[str(k)]):.4f} (n={n})")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "ckpt": str(args.checkpoint),
        "config": {"split": args.split, "r_samples": args.recon_samples, "m_samples": args.measure_samples,
                   "k": args.k, "overrides": args.overrides},
        "bpd_means": results_mean,
        "bpd_mean_vars": results_var,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
