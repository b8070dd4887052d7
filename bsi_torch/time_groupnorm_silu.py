"""Check and time K7f and K7b (GroupNorm+SiLU, forward and backward) on one GPU.

    python bsi_torch/time_groupnorm_silu.py [--root DIR] [--sweep] [--out FILE]

Imports ``bsi_torch`` from ``DIR`` (the checkout this file is in by
default, so an unpacked older commit can be timed by the same script),
holds both kernels against their plain versions at the UNet's shapes
(bf16 within 2e-2 plus one bf16 ulp, f32 within 1e-5; the backward's
dgamma and dbeta within 1e-4 of their largest element), then times them:
medians of 30 launches between CUDA events, the L2 flushed before each,
beside the kernel's own device time from a profile (``device_ms``; the
backward's ``ms`` includes the wrapper's sum over the batch) and each
shape's bound (bytes over 3.35 TB/s). With ``--sweep`` (a
checkout whose kernels take a cluster plan) each shape is also timed at
every cluster size its slabs allow, through the C entry with the plan's
cluster replaced. Prints one line per check and per time, and the card's
name, power limit and SM clock at the start and the end; with ``--out``
also writes them as JSON. Exits non-zero if a check fails or there is no
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
# (shape [B, rows, C], dtype name) of the forward: the 32x32 UNet's sampling
# (b64, C 128 and 256), the 16x16's, and its f32 eval step; of the backward:
# the train steps' (b128).
FWD = [((64, 1024, 128), "bfloat16"), ((64, 1024, 256), "bfloat16"), ((64, 256, 128), "bfloat16"),
       ((64, 256, 256), "bfloat16"), ((64, 256, 128), "float32"), ((64, 256, 256), "float32")]
BWD = [((128, 1024, 128), "bfloat16"), ((128, 1024, 256), "bfloat16"), ((128, 256, 128), "bfloat16"),
       ((128, 256, 256), "bfloat16")]
GROUPS = 32


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def median_ms(fn, flush, reps: int = 30) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, flush, reps: int = 30) -> float | None:
    """The median device time of the K7 kernel ``fn()`` launches, from a
    ``torch.profiler`` trace of ``reps`` calls, the L2 flushed before each;
    None if the trace shows none."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    times = [evt.time_range.elapsed_us() / 1e3 for evt in prof.events()
             if evt.device_type == torch.autograd.DeviceType.CUDA and "gn_silu" in evt.name]
    return statistics.median(times) if times else None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_groupnorm_silu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from bsi_torch.ops import groupnorm_silu as gn

    dev = torch.device("cuda")
    record = {"root": args.root, "card": smi("name,power.limit"), "sm_clock_start": smi("clocks.sm"),
              "checks": [], "times": []}
    print(f"[card] {record['card']} sm_clock={record['sm_clock_start']} bsi_torch={gn.__file__}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    scrub = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scrub.zero_
    failed = 0

    def inputs(shape, dtype):
        c = shape[-1]
        x = (torch.randn(*shape, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
        gamma = (1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
        beta = (0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
        g = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        return x, gamma, beta, g

    def check(name, shape, dtype, got, want):
        nonlocal failed
        ulp = 2**-7 if dtype == torch.bfloat16 else 0.0
        errs, ok = [], True
        for i, (a, b) in enumerate(zip(got, want)):
            a, b = a.float(), b.float()
            atol = (2e-2 if dtype == torch.bfloat16 else 1e-5) if i == 0 else 1e-4 * b.abs().max().item()
            diff = (a - b).abs()
            ok = ok and bool((diff <= atol + ulp * b.abs()).all())
            errs.append(diff.max().item())
        failed += not ok
        record["checks"].append(dict(kernel=name, shape=shape, dtype=str(dtype), max_abs_err=errs, ok=ok))
        print(f"[check] {name} {shape} {dtype} max_abs_err={['%.3e' % e for e in errs]} ok={ok}", flush=True)

    # A cluster plan of this checkout's kernels, if it has one: time every
    # cluster size through the C entry.
    sweep = args.sweep and hasattr(gn, "plan")

    def cluster_variants(shape, dtype, backward):
        """The shape's plan at every cluster size its chunks allow."""
        b, rows, c = shape
        base = gn.plan(b, rows, c, GROUPS, dtype, backward)
        size = dtype.itemsize
        for n in (1, 2, 4, 8):
            smem = gn._smem_bytes(backward, size, base.chunks, n, base.chunk_rows, base.width)
            if n <= base.chunks and smem <= gn.SMEM_LIMIT:
                yield base._replace(cluster=n, smem_bytes=smem)

    def launch_fwd(p, x, gamma, beta, out):
        b, rows, c = x.shape
        code = gn._lib().bsi_groupnorm_silu_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), b, rows, c, GROUPS,
            int(x.dtype == torch.bfloat16), p.width, p.chunk_rows, p.cluster, p.smem_bytes,
            1.0 / (rows * (c // GROUPS)), gn._EPS, x.device.index, torch.cuda.current_stream().cuda_stream)
        gn._build.check(gn._lib(), code, "groupnorm_silu_fwd kernel")

    def launch_bwd(p, x, gamma, beta, g, dx, dgamma_b, dbeta_b):
        b, rows, c = x.shape
        code = gn._lib().bsi_groupnorm_silu_bwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(), dx.data_ptr(), dgamma_b.data_ptr(),
            dbeta_b.data_ptr(), b, rows, c, GROUPS, int(x.dtype == torch.bfloat16), p.width, p.chunk_rows,
            p.cluster, p.smem_bytes, 1.0 / (rows * (c // GROUPS)), gn._EPS, x.device.index,
            torch.cuda.current_stream().cuda_stream)
        gn._build.check(gn._lib(), code, "groupnorm_silu_bwd kernel")

    for backward, cases in ((False, FWD), (True, BWD)):
        name = "k7b" if backward else "k7f"
        for shape, dtype_name in cases:
            dtype = getattr(torch, dtype_name)
            x, gamma, beta, g = inputs(shape, dtype)
            if backward:
                kernel = lambda: gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g, GROUPS)
                plain = lambda: gn._bwd_math(x, gamma, beta, g, GROUPS)
                n_bytes = 3 * x.numel() * x.element_size()
            else:
                kernel = lambda: (gn.groupnorm_silu_cuda(x, gamma, beta, GROUPS),)
                plain = lambda: (gn._reference_math(x, gamma, beta, GROUPS),)
                n_bytes = 2 * x.numel() * x.element_size()
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            check(name, shape, dtype, got, want)
            del got, want
            bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            row = dict(kernel=name, shape=shape, dtype=dtype_name, ms=median_ms(kernel, flush),
                       device_ms=device_ms(kernel, flush), bound_ms=bound_ms)
            row["share_of_bound"] = bound_ms / row["ms"]
            if sweep:
                row["by_cluster"] = {}
                out = torch.empty_like(x)
                dgamma_b = torch.empty(shape[0], shape[2], device=dev)
                dbeta_b = torch.empty_like(dgamma_b)
                for p in cluster_variants(shape, dtype, backward):
                    if backward:
                        call = lambda p=p: launch_bwd(p, x, gamma, beta, g, out, dgamma_b, dbeta_b)
                    else:
                        call = lambda p=p: launch_fwd(p, x, gamma, beta, out)
                    row["by_cluster"][p.cluster] = dict(
                        ms=median_ms(call, flush), device_ms=device_ms(call, flush), smem_bytes=p.smem_bytes,
                        clusters_held=gn.max_active_clusters(p, dtype, backward))
                row["plan_cluster"] = gn.plan(*shape, GROUPS, dtype, backward).cluster
            record["times"].append(row)
            print("[time] " + " ".join(f"{key}={val}" for key, val in row.items()), flush=True)
            del x, gamma, beta, g
    record["sm_clock_end"] = smi("clocks.sm")
    print(f"[card] sm_clock_end={record['sm_clock_end']} failed_checks={failed}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
