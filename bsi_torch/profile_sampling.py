"""Where the time of one BSI sampling step goes on the card.

    python -m bsi_torch.profile_sampling [--model unet|dit] [--image-size 32|16] [--batch 64] [--steps 3] [--out FILE]

Builds the full-width model (bf16, random weights from a seed): the
CIFAR-10 VDM-UNet, or with ``--model dit`` DiT-L/2 at 32x32 (patch 2, dim
1024, depth 24, 16 heads, Fourier features 6..8, ``ada_out`` filled with
normals of std 0.02 so the blocks are not the identity), on
``--image-size`` square images (16 runs the UNet's attention over 256
pixels, through K5f instead of K1), times ``--steps``
preconditioned decodes as the k=128 sampler runs them, once with host clocks
around synchronised steps and once under ``torch.profiler``, and prints:
wall ms per step, device-busy ms per step (kernel time summed), the device's
idle share, the kernels grouped by kind (the port's kernels, matmuls and
convolutions, the rest) and by name, and the step's FLOPs counted from the
layer shapes. ``--out`` also writes the numbers as JSON. Needs a CUDA device.

It also holds what the port's benches share (``bsi_torch/bench.py``,
``bsi_torch/scripts/bench_train.py``, ``profile_train``, ``chip_smoke.py``):
the bench models (``UNET``, ``DIT_L2``, ``build_model``, ``build_algo``), the
FLOP count from the layer shapes, and the card's name, power limit and peak
(``card``, ``peak_flops``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from bsi_torch import BSI
from bsi_torch.models import DenoisingDiT, DenoisingVDMUNet
from bsi_torch.nn import Attention2D, FourierFeatures, NyquistPositionalEmbedding, TokenAttention

# The CIFAR-10 VDM-UNet (configs/experiment/cifar10-vdm.yaml), the JAX
# package's UNet bench model (bench.py, scripts/bench_train.py).
UNET = dict(dim=128, levels=32, pos_emb_mult=4, n_attention_heads=1)
# DiT-L/2 at 32x32, the JAX package's DiT serving shape (bench.py).
DIT_L2 = dict(data_shape=(32, 32, 3), patch_size=2, dim=1024, depth=24, heads=16)
# Dense bf16 FLOP/s by card name (NVIDIA's data sheet: the H100 SXM).
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def _kind(name: str) -> str:
    if "bh_attn_fwd" in name:
        return "K5f flash_attention_dropout"
    if "bh_attn_bwd" in name:
        return "K5b flash_attention_bwd"
    if "packed_attn_fwd" in name:
        return "K2 fused-qkv attention"
    if "packed_attn_bwd" in name:
        return "K3 fused-qkv attention backward"
    if "ln_mod_fwd" in name:
        return "K4f layernorm_modulate"
    if "ln_mod_bwd" in name:
        return "K4b layernorm_modulate backward"
    if "attn_fwd" in name:
        return "K1 flash_attention"
    if "gn_silu_fwd" in name:
        return "K7 groupnorm_silu_fwd"
    if "gn_silu_bwd" in name:
        return "K7b groupnorm_silu_bwd"
    low = name.lower()
    # cuBLAS's Hopper matmuls are named nvjet_* on CUDA 12.8
    if any(key in low for key in ("conv", "cudnn", "xmma", "gemm", "sm90", "nvjet")):
        return "convolution / matmul (cuDNN, cuBLAS)"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer, EMA and clipping (foreach kernels)"
    if "copy_kernel" in low:
        return "casts and copies (weights cast to bf16 at use, layout copies)"
    return "other (elementwise, reductions, cat)"


def count_flops(model: torch.nn.Module, run) -> dict[str, float]:
    """FLOPs of ``run()`` by layer kind, from the shapes the layers see:
    2 per multiply-add of convolutions and dense layers, 4*B*S^2*(H*D) for
    attention's two products."""
    flops: dict[str, float] = defaultdict(float)

    def conv(mod, inp, out):
        flops["convolution"] += 2.0 * out.numel() * mod.weight[0].numel()

    def dense(mod, inp, out):
        flops["dense"] += 2.0 * out.numel() * mod.in_features

    def attention(mod, inp, out):
        b, c, h, w = inp[0].shape
        flops["attention"] += 4.0 * b * (h * w) ** 2 * c

    def token_attention(mod, inp, out):
        b, s, f = inp[0].shape
        flops["attention"] += 4.0 * b * s**2 * f

    hooks = []
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            hooks.append(mod.register_forward_hook(conv))
        elif isinstance(mod, torch.nn.Linear):
            hooks.append(mod.register_forward_hook(dense))
        elif isinstance(mod, Attention2D):
            hooks.append(mod.register_forward_hook(attention))
        elif isinstance(mod, TokenAttention):
            hooks.append(mod.register_forward_hook(token_attention))
    try:
        run()
    finally:
        for hook in hooks:
            hook.remove()
    return dict(flops)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value:
            return float(value)
    return 0.0


def card(device: torch.device) -> dict:
    """The card's name and its power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (None
    for both off a card)."""
    if device.type != "cuda":
        return {"device": None, "power_limit": None}
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(device), "power_limit": lines[min(index, len(lines) - 1)]}


def peak_flops(device: torch.device) -> float | None:
    """The card's dense bf16 peak, by its name; None off a card or for a
    card not in ``PEAK_FLOPS``."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((peak for kind, peak in PEAK_FLOPS.items() if name.startswith(kind)), None)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def summarize(prof, steps: int, wall_ms: float, flops: dict[str, float]) -> dict:
    """The card, wall and device-busy ms per step, the idle share, device ms
    by kernel kind and the top kernels from a profile of ``steps`` steps."""
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key][0] += us / 1e3 / steps
            by_name[evt.key][1] += evt.count / steps
    busy = sum(ms for ms, _ in by_name.values())
    by_kind: dict[str, float] = defaultdict(float)
    for name, (ms, _) in by_name.items():
        by_kind[_kind(name)] += ms
    gpu = card(torch.device("cuda"))
    return {
        "device": gpu["device"],
        "nvidia_smi": gpu["power_limit"],
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy if busy > 0 else None,
        "device_idle_share": (1.0 - busy / wall_ms) if busy > 0 else None,
        "by_kind_ms_per_step": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "tflop_per_step": {k: v / 1e12 for k, v in flops.items()},
        "tflop_per_s_of_wall": sum(flops.values()) / 1e9 / wall_ms,
        "top_kernels": [
            {"name": name[:120], "ms_per_step": ms, "launches_per_step": n}
            for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
        ],
    }


def fill_ada_out(model: torch.nn.Module, seed: int, std: float = 0.02) -> None:
    """Fill every DiT block's ``ada_out`` (zero at adaLN-Zero init, which makes
    each block the identity) with normals of ``std`` from a generator seeded
    with ``seed`` on the model's device."""
    generator = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if ".ada_out." in name:
                param.copy_(torch.randn(param.shape, generator=generator, device=generator.device) * std)


def build_model(name: str, device, dtype=torch.bfloat16, seed: int = 0, image_size: int = 32,
                **kw) -> torch.nn.Module:
    """The full-width bench model ``name`` ("unet" or "dit") on ``image_size``
    square RGB images, with random weights from ``seed``, in eval mode:
    Fourier features 6..8, the UNet's timestep embedding
    ``NyquistPositionalEmbedding(32, 100)``, the DiT's ``ada_out`` filled.
    ``kw`` (``dropout``, ``remat``, ``actfn``, ...) goes to the model's
    constructor."""
    torch.manual_seed(seed)
    ff = FourierFeatures(6, 8)
    shape = (image_size, image_size, 3)
    if name == "unet":
        return DenoisingVDMUNet(shape, NyquistPositionalEmbedding(32, 100), fourier_features=ff, dtype=dtype,
                                device=device, **UNET, **kw).eval()
    if name != "dit":
        raise ValueError(f"unknown model {name!r}")
    model = DenoisingDiT(fourier_features=ff, dtype=dtype, device=device, **{**DIT_L2, "data_shape": shape},
                         **kw).eval()
    fill_ada_out(model, seed)
    return model


def build_algo(k: int, image_size: int = 32) -> BSI:
    """BSI as the JAX package's benches run it: lambda_0 1e-2, alpha_M 1e6,
    alpha_R 2e6, EDM preconditioning, ``k`` sampling steps."""
    shape = (image_size, image_size, 3)
    return BSI(data_shape=shape, lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=k, preconditioning="edm")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("unet", "dit"), default="unet")
    parser.add_argument("--image-size", type=int, choices=(32, 16), default=32)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampling needs a CUDA device")
    dev = torch.device("cuda")
    shape = (args.image_size, args.image_size, 3)
    model = build_model(args.model, dev, seed=args.seed, image_size=args.image_size)
    algo = build_algo(128, args.image_size)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mu = torch.randn((args.batch,) + shape, generator=gen, device=dev)
    t = torch.full((args.batch,), 0.5, device=dev)

    def step():
        return algo._predict_x(model, mu, t)

    with torch.inference_mode():
        flops = count_flops(model, step)
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

    result = {"model": args.model, "image_size": args.image_size, "batch": args.batch, **summarize(prof, args.steps, statistics.median(wall), flops)}
    print(json.dumps(result, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
