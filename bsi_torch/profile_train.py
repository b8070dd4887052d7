"""Where the time of one train step goes on the card.

    python -m bsi_torch.profile_train [--model unet|dit] [--image-size 32|16] [--batch N] [--steps 3] [--out FILE]

Builds the train bench (``bsi_torch/scripts/bench_train.py::build``, the JAX
package's ``scripts/bench_train.py``) for ``--model``, with random weights
and synthetic 8-bit images from a seed:

- ``unet``: the full-width CIFAR-10 VDM-UNet, batch 128, dropout 0.1, AdamW
  2e-4;
- ``dit``: DiT-L/2 (the imagenet32 recipe's model: 32x32, patch 2, dim 1024,
  depth 24, 16 heads, Fourier features 6..8), batch 64, dropout 0.05, AdamW
  5e-4 with bf16 Adam moments (``bench.py``'s ``dit-train`` row), each
  block's ``ada_out`` filled with normals of std 0.02 so the blocks are not
  the identity;

both bf16 compute on f32 parameters, on ``--image-size`` square images (16
runs the UNet's attention over 256 pixels, through K5f and K5b), BSI with
EDM preconditioning (lambda_0
1e-2, alpha_M 1e6, alpha_R 2e6, k=50), warmup 100 and a cosine to 1e6
steps, clip 1.0, EMA after step 1000. Times ``--steps`` train steps with
host clocks around synchronised steps, then profiles as many under
``torch.profiler``, and prints what ``profile_sampling`` prints for a
sampling step: wall and device-busy ms per step, the device's idle share,
device ms by kernel kind (K2, K3, K4f and K4b by name for the DiT) and the
top kernels, and the FLOPs (three times the forward's, counted from the
layer shapes). ``--out`` also writes the numbers as JSON. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from bsi_torch.profile_sampling import count_flops, summarize
from bsi_torch.scripts.bench_train import build
from bsi_torch.train import TrainState, make_train_step, module_apply


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("unet", "dit"), default="unet")
    parser.add_argument("--image-size", type=int, choices=(32, 16), default=32)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda")
    moments = dict(mu_dtype="bfloat16", nu_dtype="bfloat16") if args.model == "dit" else {}
    model, algo, tx, ema, batch_size = build(args.model, dev, args.seed, args.image_size, **moments)
    batch_size = args.batch or batch_size
    params = dict(model.named_parameters())
    state = TrainState.create(params=params, opt_state=tx.init(params),
                              generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    train_step = make_train_step(algo, module_apply(model), tx, ema)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    batch = torch.randint(0, 256, (batch_size, args.image_size, args.image_size, 3), generator=gen,
                          device=dev) / 255.0 * 2.0 - 1.0

    def step():
        nonlocal state
        state, _ = train_step(state, batch)

    mu = torch.zeros_like(batch)
    t = torch.full((batch_size,), 0.5, device=dev)
    with torch.no_grad():
        flops = {f"{kind} (x3: forward + backward)": 3.0 * f
                 for kind, f in count_flops(model, lambda: model(mu, t)).items()}
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    result = {"model": args.model, "image_size": args.image_size, "batch": batch_size, "wall_ms_per_step_runs": wall,
              **summarize(prof, args.steps, statistics.median(wall), flops)}
    print(json.dumps(result, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
