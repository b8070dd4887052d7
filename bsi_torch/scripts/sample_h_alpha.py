"""Decoding error per noise level over a data split.

Counterpart of ``scripts/sample_h_alpha.py``: for a grid of log-spaced
precisions ``lambda``, noises each example of the split to that precision,
decodes it with the EMA model and records the mean squared decoding error
in bits: where along the noise schedule the model spends its capacity.
One model forward per lambda, as the JAX script's ``lax.map``: all lambdas
of a batch at once would not fit (the JAX script counts 46 GB for the
CIFAR-10 UNet at 32 lambdas of 128).

    python -m bsi_torch.scripts.sample_h_alpha -c <ckpt_dir> -o out.npz [-n 1000] [--split test]
        [--seed S] [overrides...]
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

from ._common import HISTORY_SEED, eval_dataloader, load_trainer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.sample_h_alpha", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-o", "--out", required=True)
    parser.add_argument("-n", "--num-lambdas", type=int, default=1000)
    parser.add_argument("--split", default="test")
    parser.add_argument("--seed", type=int, default=HISTORY_SEED)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    trainer, config, data = load_trainer(args.checkpoint, args.overrides)
    algo, state, device = trainer.algorithm, trainer.state, trainer.device
    if not hasattr(algo, "_sample_q_mu_lambda"):
        raise SystemExit("sample_h_alpha requires a BSI-style algorithm")
    model_fn = lambda mu, tt: trainer.eval_apply(state.ema_params, mu, tt)

    lambdas = torch.logspace(math.log10(algo.lambda_0), math.log10(algo.lambda_0 + algo.alpha_M),
                             args.num_lambdas, device=device)
    t = algo.p_lambda.cdf(lambdas)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def batch_errors(x: torch.Tensor) -> torch.Tensor:
        rows = []
        for lam_i, t_i in zip(lambdas, t):
            mu = algo._sample_q_mu_lambda(generator, x, lam_i.expand(len(x)))
            x_hat = algo._predict_x(model_fn, mu, t_i.expand(len(x)))
            rows.append(((x - x_hat) ** 2).reshape(len(x), -1).mean(-1))
        return torch.stack(rows)

    errors = []
    with torch.inference_mode():
        for batch, mask in eval_dataloader(data, args.split):
            err = batch_errors(torch.as_tensor(batch, device=device)).cpu().numpy()
            errors.append(err[:, mask] / math.log(2))
    errors = np.concatenate(errors, axis=1)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, ckpt=str(args.checkpoint),
                        **{"lambda": lambdas.cpu().numpy(), "squared_error_samples_bpd": errors})
    print(f"wrote {out_path} ({errors.shape[1]} examples x {args.num_lambdas} lambdas)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
