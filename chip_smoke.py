#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bsi_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each one
against its plain PyTorch version at the main path's shapes, checks the
full-width CIFAR-10 VDM-UNet on the card against the same weights on the
CPU, then runs the main path -- BSI sampling at k=128, batch 64, bf16 --
and checks that it went through the kernels. Prints one line per phase, a
JSON line with every kernel's numbers, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 1 before printing a result.
"""

from __future__ import annotations

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over HBM bandwidth and its operations over the peak
# rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# Full-width CIFAR-10 VDM-UNet (configs/experiment/cifar10-vdm.yaml); bench.py
# times the same model and sampler.
DATA_SHAPE = (32, 32, 3)
UNET = dict(dim=128, levels=32, pos_emb_mult=4, n_attention_heads=1)
BATCH = 64
K_STEPS = 128
# One UNet forward: 34 GroupNorm+SiLU at 128 channels (32 down, centre in
# and out) and 32 at 256 (the up blocks' concatenated input); one attention.
K7_PER_FORWARD = 66
K1_PER_FORWARD = 1


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, *, reps: int = 30, flush=None) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between two
    CUDA events, after one warm-up; ``flush()`` runs untimed before each."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name: str, got, want, atol: float, rtol: float = 0.0) -> float:
    """Max abs error of ``got`` against ``want``; raises where it exceeds
    ``atol + rtol * |want|``."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    if not excess <= 0:
        raise AssertionError(f"{name}: max abs err {diff.max().item()} exceeds atol {atol} + rtol {rtol}")
    return diff.max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch.nn import functional as F

    from bsi_torch import BSI
    from bsi_torch.models import DenoisingVDMUNet
    from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding
    from bsi_torch.ops import _build
    from bsi_torch.ops import flash_attention as fa
    from bsi_torch.ops import groupnorm_silu as gn

    dev = torch.device("cuda")
    # f32 results are compared against the CPU and the plain versions: no TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---------------------------------------------------------------- card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase("card", nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())

    # --------------------------------------------------------------- build
    # nvcc builds K1 in a thread while Triton compiles K7 on its first launch.
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nvcc = pool.submit(_build.build, fa.SOURCE)
        x = torch.randn(2, 64, 64, device=dev)
        gn.groupnorm_silu_cuda(x, torch.ones(64, device=dev), torch.zeros(64, device=dev), 32)
        torch.cuda.synchronize()
        triton_s = time.perf_counter() - start
        lib_path, nvcc_s, log = nvcc.result()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    phase("build", k1_nvcc_s=f"{nvcc_s:.2f}", k7_triton_first_launch_s=f"{triton_s:.2f}",
          total_s=f"{time.perf_counter() - start:.2f}", library=lib_path.name)
    for line in ptxas:
        phase("build.ptxas", info=repr(line))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *shape, dtype=torch.float32: torch.randn(
        *shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    # Evicts the 50 MB L2 between timed runs, so every kernel reads its
    # inputs from HBM, as its bound assumes.
    scrub = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = lambda: scrub.zero_()
    kernels = []

    # ------------------------------------------------------ K1 vs its twin
    for shape, dtype, atol in [
        ((BATCH, 1, 1024, 128), torch.bfloat16, 2e-2),
        ((BATCH, 1, 1024, 128), torch.float32, 1e-5),
        ((3, 2, 200, 64), torch.bfloat16, 2e-2),
        ((3, 2, 200, 64), torch.float32, 1e-5),
        ((2, 2, 384, 256), torch.bfloat16, 2e-2),
        ((2, 2, 384, 256), torch.float32, 1e-5),
    ]:
        q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
        got = fa.flash_attention_cuda(q, k, v)
        want = fa._fwd_math(q, k, v, fa._scale(q))
        torch.cuda.synchronize()
        err = check_close(f"K1 {shape} {dtype}", got, want, atol)
        phase("k1.check", shape=shape, dtype=str(dtype), max_abs_err=f"{err:.3e}", atol=atol)
    b, h, s, d = BATCH, 1, 1024, 128
    q, k, v = (randn(b, h, s, d, dtype=torch.bfloat16) for _ in range(3))
    err = check_close("K1 main", fa.flash_attention_cuda(q, k, v), fa._fwd_math(q, k, v, fa._scale(q)), 2e-2)
    k1 = dict(
        name="flash_attention", route="cuda", source="bsi_torch/ops/csrc/flash_attention.cu",
        replaces="bsi_tpu/ops/flash_attention.py:232", shape=[b, h, s, d], dtype="bfloat16",
        max_abs_err=err,
        ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v), flush=flush),
        plain_ms=time_ms(lambda: fa._fwd_math(q, k, v, fa._scale(q)).to(q.dtype), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), flush=flush),
    )
    k1_flops = 4 * b * h * s * s * d
    k1_bytes = 4 * b * h * s * d * q.element_size()
    k1["bound_ms"] = max(k1_flops / BF16_TENSOR_FLOPS, k1_bytes / HBM_BYTES_PER_S) * 1e3
    k1["bound_by"] = "operations" if k1_flops / BF16_TENSOR_FLOPS > k1_bytes / HBM_BYTES_PER_S else "bytes"
    phase("k1.time", **{key: k1[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    kernels.append(k1)

    # ------------------------------------------------------ K7 vs its twin
    # bf16: both sides round z to bf16 before the SiLU and the product after it;
    # f32 statistics summed in another order can move either rounding by one
    # bf16 ulp (2^-7 relative at most), beside 2e-2 absolute.
    k7_times = {}
    for c in (128, 256):
        for dtype, atol, rtol in ((torch.bfloat16, 2e-2, 2**-7), (torch.float32, 1e-5, 0.0)):
            x = randn(BATCH, 1024, c, dtype=dtype)
            gamma = (1.0 + 0.1 * randn(c)).to(dtype)
            beta = (0.1 * randn(c)).to(dtype)
            got = gn.groupnorm_silu_cuda(x, gamma, beta, 32)
            want = gn._reference_math(x, gamma, beta, 32)
            torch.cuda.synchronize()
            err = check_close(f"K7 C={c} {dtype}", got, want, atol, rtol)
            phase("k7.check", shape=(BATCH, 1024, c), dtype=str(dtype), max_abs_err=f"{err:.3e}",
                  atol=atol, rtol=rtol)
            if dtype != torch.bfloat16:
                continue
            x_nchw = x.permute(0, 2, 1).contiguous()
            elems = x.numel()
            k7_bytes = 2 * elems * x.element_size() + 2 * c * x.element_size()
            # per element: x*x, two sums, x - mean, one FMA for the affine,
            # negate, exp, add, divide, the final product: 11 f32 operations
            k7_ops = 11 * elems
            k7_times[c] = dict(
                max_abs_err=err,
                ms=time_ms(lambda: gn.groupnorm_silu_cuda(x, gamma, beta, 32), flush=flush),
                plain_ms=time_ms(lambda: gn._reference_math(x, gamma, beta, 32), flush=flush),
                library_ms=time_ms(
                    lambda: F.silu(F.group_norm(x_nchw, 32, gamma, beta, 1e-6)), flush=flush),
                bound_ms=max(k7_bytes / HBM_BYTES_PER_S, k7_ops / F32_FLOPS) * 1e3,
                bound_by="bytes" if k7_bytes / HBM_BYTES_PER_S >= k7_ops / F32_FLOPS else "operations",
            )
            phase("k7.time", shape=(BATCH, 1024, c), **{
                key: k7_times[c][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    kernels.append(dict(
        name="groupnorm_silu_fwd", route="triton", source="bsi_torch/ops/groupnorm_silu.py",
        replaces="bsi_tpu/ops/groupnorm_silu.py:133", shape=[BATCH, 1024, 256], dtype="bfloat16",
        **k7_times[256], at_c128=k7_times[128],
    ))

    # --------------------------------------- whole model, card against CPU
    pos_emb = NyquistPositionalEmbedding(32, 100)
    ff = FourierFeatures(n_min=6, n_max=8)
    torch.manual_seed(SEED)
    model_cpu = DenoisingVDMUNet(DATA_SHAPE, pos_emb, fourier_features=ff, device="cpu", **UNET).eval()
    weights = model_cpu.state_dict()
    model_f32 = DenoisingVDMUNet(DATA_SHAPE, pos_emb, fourier_features=ff, device=dev, **UNET).eval()
    model_f32.load_state_dict(weights)
    cpu_gen = torch.Generator().manual_seed(SEED)
    mu = torch.randn((2,) + DATA_SHAPE, generator=cpu_gen)
    t = torch.rand(2, generator=cpu_gen)
    with torch.inference_mode():
        ref = model_cpu(mu, t)
        out = model_f32(mu.to(dev), t.to(dev)).cpu()
    scale = ref.abs().max().item()
    # f32 on both sides, TF32 off: the two differ only in the order of sums in
    # the 168 convolutions (cuDNN's against the CPU's), the attention and the
    # norms, compounded through 66 residual blocks.
    model_tol = 1e-4 * max(1.0, scale)
    err = check_close("UNet f32 card vs CPU", out, ref, model_tol)
    phase("model.check", batch=2, dtype="float32", max_abs_err=f"{err:.3e}", atol=f"{model_tol:.3e}",
          output_max_abs=f"{scale:.3e}", finite=bool(torch.isfinite(out).all()))

    algo = BSI(data_shape=DATA_SHAPE, lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=K_STEPS,
               preconditioning="edm")
    # The sampler, card against CPU, k=4 on the same noise. At random weights
    # the Fourier features (frequencies up to 2 pi 2^8) make the UNet so
    # sensitive to its input that two free-running samplers part by orders of
    # magnitude more than one forward's error. So: (a) the card decodes every
    # state of the CPU's trajectory as the CPU did, and (b) the update loop
    # itself agrees on a closed-form model.
    eps = torch.randn((5, 2) + DATA_SHAPE, generator=cpu_gen)
    t4 = torch.linspace(0.0, 1.0, 5)
    closed_form = lambda m, tt: torch.tanh(m) * tt[:, None, None, None]
    with torch.inference_mode():
        _, (mus, x_hats, _) = algo._sample_loop(
            model_cpu, eps[0], lambda i: eps[i + 1], t4, with_history=True)
        decode_err = max(
            check_close(f"sampler decode step {i}",
                        algo._predict_x(model_f32, mus[i].to(dev), t4[i].expand(2).to(dev)).cpu(),
                        x_hats[i], model_tol)
            for i in range(4)
        )
        loop_cpu, _ = algo._sample_loop(closed_form, eps[0], lambda i: eps[i + 1], t4)
        loop_dev, _ = algo._sample_loop(
            closed_form, eps[0].to(dev), lambda i: eps[i + 1].to(dev), t4.to(dev))
    loop_err = check_close("sampler loop card vs CPU", loop_dev.cpu(), loop_cpu, 1e-5, 1e-5)
    phase("sampler.check", k=4, batch=2, dtype="float32", decode_max_abs_err=f"{decode_err:.3e}",
          decode_atol=f"{model_tol:.3e}", loop_max_abs_err=f"{loop_err:.3e}", loop_tol="1e-5+1e-5*|x|")
    del model_f32

    # ------------------------------------------------ main path: sampling
    del scrub, q, k, v, x, x_nchw, got, want
    model = DenoisingVDMUNet(DATA_SHAPE, pos_emb, fourier_features=ff, dtype=torch.bfloat16,
                             device=dev, **UNET).eval()
    model.load_state_dict(weights)
    sample_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    algo.sample(model, sample_gen, BATCH)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(3):
        fa.flash_attention_cuda.launches = 0
        gn.groupnorm_silu_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = algo.sample(model, sample_gen, BATCH)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = {"flash_attention": fa.flash_attention_cuda.launches,
                    "groupnorm_silu_fwd": gn.groupnorm_silu_cuda.launches}
        want = {"flash_attention": K1_PER_FORWARD * (K_STEPS + 1),
                "groupnorm_silu_fwd": K7_PER_FORWARD * (K_STEPS + 1)}
        if launches != want:
            raise AssertionError(f"kernel launches per sampling run {launches}, want {want}")
        if samples.shape != (BATCH,) + DATA_SHAPE or not torch.isfinite(samples).all():
            raise AssertionError(f"bad samples: shape {tuple(samples.shape)}, "
                                 f"finite {bool(torch.isfinite(samples).all())}")
    peak = torch.cuda.max_memory_allocated()
    phase("sample", k=K_STEPS, batch=BATCH, dtype="bfloat16", run_s=secs,
          samples_per_s=f"{BATCH / statistics.median(secs):.3f}", peak_mem_gib=f"{peak / 2**30:.3f}",
          launches=launches, finite=True, shape=tuple(samples.shape))
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]

    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
