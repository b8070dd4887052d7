"""Where the time of one UNet train step goes on the card.

    python -m bsi_torch.profile_train [--batch 128] [--steps 3] [--out FILE]

Builds the JAX package's UNet train bench (``scripts/bench_train.py``): the
full-width CIFAR-10 VDM-UNet, bf16 compute on f32 parameters, dropout 0.1,
BSI with EDM preconditioning, AdamW 2e-4 with warmup 100 and a cosine to 1e6
steps, clip 1.0, EMA after step 1000, random weights and synthetic 8-bit
images from a seed. Times ``--steps`` train steps with host clocks around
synchronised steps, then profiles as many under ``torch.profiler``, and
prints what ``profile_sampling`` prints for a sampling step: wall and
device-busy ms per step, the device's idle share, device ms by kernel kind
and the top kernels, and the FLOPs (three times the forward's, counted from
the layer shapes). ``--out`` also writes the numbers as JSON. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from bsi_torch import BSI
from bsi_torch.models import DenoisingVDMUNet
from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding
from bsi_torch.profile_sampling import count_flops, summarize
from bsi_torch.train import (
    EMAConfig,
    TrainState,
    make_optimizer,
    make_train_step,
    module_apply,
    warmup_cosine_schedule,
)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda")
    torch.manual_seed(args.seed)
    model = DenoisingVDMUNet(
        (32, 32, 3), NyquistPositionalEmbedding(32, 100), dim=128, levels=32, pos_emb_mult=4,
        n_attention_heads=1, dropout=0.1, fourier_features=FourierFeatures(6, 8),
        dtype=torch.bfloat16, device=dev,
    )
    algo = BSI(data_shape=(32, 32, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=50)
    params = dict(model.named_parameters())
    tx = make_optimizer(warmup_cosine_schedule(2e-4, warmup_steps=100, max_steps=10**6))
    state = TrainState.create(params=params, opt_state=tx.init(params),
                              generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    train_step = make_train_step(algo, module_apply(model), tx, EMAConfig(update_after_step=1000))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    batch = torch.randint(0, 256, (args.batch, 32, 32, 3), generator=gen, device=dev) / 255.0 * 2.0 - 1.0

    def step():
        nonlocal state
        state, _ = train_step(state, batch)

    mu = torch.zeros_like(batch)
    t = torch.full((args.batch,), 0.5, device=dev)
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
    result = {"batch": args.batch, "wall_ms_per_step_runs": wall,
              **summarize(prof, args.steps, statistics.median(wall), flops)}
    print(json.dumps(result, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
