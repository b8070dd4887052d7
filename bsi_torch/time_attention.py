"""Check and time the attention kernels K1, K5f, K2 and K6f and the
backwards K3, K6b and K5b on one GPU.

    python bsi_torch/time_attention.py [--root DIR] [--out FILE]

Imports ``bsi_torch`` from ``DIR`` (the checkout this file is in by
default, so an unpacked older commit can be timed by the same script),
builds its kernels, holds each against its plain version at the UNet's and
DiT-L/2's shapes and at ragged lengths (bf16 within 2e-2, the gradients
within 2e-2 of their largest element; f32 within 1e-5), then times the
kernels and their plain versions at those shapes: medians of 30 launches
between CUDA events, the L2 flushed before each (``chip_smoke.py`` times
the library's attention beside them). Where the checkout's forwards can
write the backward's row statistics (``with_lse``) they are timed with the
store on too, and the backwards with the forward's output and statistics
given (``ms``, as a train step calls them) and without (``ms_standalone``,
the forward launched first); an older checkout's backwards take neither.
Prints one line per check and per time, and the card's name, power limit
and SM clock at the start and the end; with ``--out`` also writes them as
JSON. Exits non-zero if a check fails or there is no card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

# (shape [B, H, S, D], dtype name, dropout rate) of each check.
CHECKS = [
    ((64, 1, 1024, 128), "bfloat16", 0.0),
    ((64, 1, 1024, 128), "float32", 0.0),
    ((64, 1, 256, 128), "bfloat16", 0.1),
    ((64, 1, 256, 128), "float32", 0.1),
    ((3, 1, 200, 128), "bfloat16", 0.1),
    ((3, 1, 200, 128), "float32", 0.1),
    ((2, 2, 1, 128), "bfloat16", 0.0),
    ((2, 2, 63, 128), "float32", 0.0),
    ((2, 1, 1000, 128), "bfloat16", 0.0),
    ((2, 1, 1000, 128), "float32", 0.1),
    ((2, 2, 384, 64), "bfloat16", 0.1),
    ((2, 2, 384, 256), "float32", 0.1),
]
# ((batch, seq, heads, head_dim), dtype name, dropout rate) of each K2 and
# K6f check: DiT-L/2's shape, then ragged lengths at head_dim 64 (head
# pairs, and one head a group at an odd head count) and 128.
PACKED_CHECKS = [
    ((64, 256, 16, 64), "bfloat16", 0.0),
    ((64, 256, 16, 64), "bfloat16", 0.05),
    ((64, 256, 16, 64), "float32", 0.05),
    *(((b, s, h, d), dtype, rate)
      for b, s, h, d in ((2, 1, 4, 64), (2, 63, 4, 64), (3, 200, 4, 64), (1, 1000, 2, 64), (2, 200, 3, 64),
                         (2, 1, 2, 128), (2, 63, 2, 128), (3, 200, 2, 128), (1, 1000, 2, 128))
      for dtype in ("bfloat16", "float32") for rate in (0.0, 0.05)),
]
# (kernel, shape, dtype name, dropout rate) of each time.
TIMES = [
    ("k1", (64, 1, 1024, 128), "bfloat16", 0.0),
    ("k5f", (64, 1, 1024, 128), "bfloat16", 0.0),
    ("k5f", (64, 1, 256, 128), "bfloat16", 0.0),
    ("k5f", (64, 1, 256, 128), "bfloat16", 0.1),
    ("k5f", (64, 1, 256, 128), "float32", 0.0),
    ("k1", (64, 1, 1024, 128), "float32", 0.0),
    ("k2", (64, 256, 16, 64), "bfloat16", 0.0),
    ("k2", (64, 256, 16, 64), "bfloat16", 0.05),
    ("k6f", (64, 256, 16, 64), "bfloat16", 0.0),
    ("k2", (64, 256, 8, 128), "bfloat16", 0.0),
]
# ((batch, seq, heads, head_dim), dtype name, dropout rate) of each K3 and K6b
# check (over the grouped qkv buffer and over three tensors), and ((B, H, S,
# D), ...) of each K5b check: the main shapes, then ragged lengths.
BWD_CHECKS = [
    ((64, 256, 16, 64), "bfloat16", 0.0),
    ((64, 256, 16, 64), "bfloat16", 0.05),
    ((64, 256, 16, 64), "float32", 0.05),
    ((3, 200, 4, 64), "bfloat16", 0.05),
    ((2, 63, 2, 128), "bfloat16", 0.05),
    ((2, 1, 4, 64), "bfloat16", 0.0),
]
K5B_CHECKS = [
    ((128, 1, 256, 128), "bfloat16", 0.0),
    ((128, 1, 256, 128), "bfloat16", 0.1),
    ((3, 1, 200, 128), "bfloat16", 0.1),
    ((2, 2, 384, 64), "bfloat16", 0.1),
]
# (kernel, shape, dtype name, dropout rate) of each backward time.
BWD_TIMES = [
    ("k3", (64, 256, 16, 64), "bfloat16", 0.0),
    ("k3", (64, 256, 16, 64), "bfloat16", 0.05),
    ("k6b", (64, 256, 16, 64), "bfloat16", 0.05),
    ("k5b", (128, 1, 256, 128), "bfloat16", 0.0),
    ("k5b", (128, 1, 256, 128), "bfloat16", 0.1),
]


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from bsi_torch.ops import flash_attention as fa
    from bsi_torch.ops import flash_attention_packed as fap
    from bsi_torch.ops.dropout_mask import draw_seeds

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    record = {"root": args.root, "card": smi("name,power.limit"), "sm_clock_start": smi("clocks.sm"),
              "checks": [], "times": []}
    print(f"[card] {record['card']} sm_clock={record['sm_clock_start']} bsi_torch={fa.__file__}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda shape, dtype: torch.randn(*shape, generator=gen, device=dev).to(dtype)
    inputs = lambda shape, dtype: [randn(shape, dtype) for _ in range(3)]
    seeds = lambda shape: draw_seeds(shape[0], shape[1], dev, gen).reshape(-1)
    k5f = lambda q, k, v, sd, rate: fa.flash_attention_dropout_cuda(q, k, v, sd, rate)
    # K2 on a grouped qkv buffer, K6f on q, k, v [B, S, H*D]; seeds [B, H].
    k2 = lambda qkv, heads, sd, rate: fap.flash_attention_fused_cuda(qkv, heads, sd, rate)
    k6f = lambda qkv, heads, sd, rate: fap.flash_attention_packed_cuda(*split3(qkv), heads, sd, rate)
    split3 = lambda qkv: [t.contiguous() for t in qkv.chunk(3, dim=-1)]

    failed = 0

    def report(name, shape, dtype_name, rate, got, want, atol):
        nonlocal failed
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= atol
        failed += not ok
        record["checks"].append(dict(kernel=name, shape=shape, dtype=dtype_name, rate=rate, max_abs_err=err,
                                     atol=atol, ok=ok))
        print(f"[check] {name} {shape} {dtype_name} rate={rate} max_abs_err={err:.3e} atol={atol} ok={ok}",
              flush=True)

    for shape, dtype_name, rate in CHECKS:
        dtype = getattr(torch, dtype_name)
        q, k, v = inputs(shape, dtype)
        sd = seeds(shape) if rate else None
        want = fa._fwd_math(q, k, v, fa._scale(q), fa._keep(q, sd, rate), 1.0 - rate)
        atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        results = {"k5f": k5f(q, k, v, sd, rate)}
        if rate == 0.0:
            results["k1"] = fa.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        for name, got in results.items():
            report(name, shape, dtype_name, rate, got, want, atol)
    for (b, s, h, d), dtype_name, rate in PACKED_CHECKS:
        dtype = getattr(torch, dtype_name)
        qkv = randn((b, s, 3 * h * d), dtype)
        sd = draw_seeds(b, h, dev, gen) if rate else None
        keeps = fap._philox_keep_mask(sd, s, 1.0 - rate) if rate else None
        atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        report("k2", (b, s, h, d), dtype_name, rate, k2(qkv, h, sd, rate),
               fap._fused_fwd_math(qkv, h, keeps, 1.0 - rate), atol)
        report("k6f", (b, s, h, d), dtype_name, rate, k6f(qkv, h, sd, rate),
               fap._packed_heads_math(*split3(qkv), h, keeps, 1.0 - rate), atol)
        del qkv, keeps

    # Whether this checkout's forwards write the statistics and its
    # backwards take them.
    stats = "with_lse" in inspect.signature(fap.flash_attention_fused_cuda).parameters

    def k3_k6b(qkv, do, h, sd, rate, given):
        """K3's dqkv and K6b's dq, dk, dv, from the forwards' statistics when
        `given` (and the checkout takes them)."""
        q, k, v = split3(qkv)
        kw3 = kw6 = {}
        if given and stats:
            out, lse = fap.flash_attention_fused_cuda(qkv, h, sd, rate, with_lse=True)
            kw3 = dict(out=out, lse=lse)
            out6, lse6 = fap.flash_attention_packed_cuda(q, k, v, h, sd, rate, with_lse=True)
            kw6 = dict(out=out6, lse=lse6)
        return (fap.flash_attention_fused_bwd_cuda(qkv, do, h, sd, rate, **kw3),
                fap.flash_attention_packed_bwd_cuda(q, k, v, do, h, sd, rate, **kw6))

    def k5b(q, k, v, do, sd, rate, given):
        kw = {}
        if given and stats:
            out, lse = fa.flash_attention_dropout_cuda(q, k, v, sd, rate, with_lse=True)
            kw = dict(out=out, lse=lse)
        return fa.flash_attention_bwd_cuda(q, k, v, do, sd, rate, **kw)

    def report_bwd(name, shape, dtype_name, rate, got, want, given, dv_want, seq):
        nonlocal failed
        # dQ and dK vanish at S = 1 (a softmax over one key is constant):
        # there they are held to the tolerance of dV's largest element, the
        # scale of the terms that cancel (delta from the bf16 output, dP
        # from the products)
        scale = want.float().abs().max().item()
        if seq == 1:
            scale = max(scale, dv_want.float().abs().max().item())
        tol = (2e-2 if dtype_name == "bfloat16" else 1e-5) * scale
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= tol
        failed += not ok
        record["checks"].append(dict(kernel=name, shape=shape, dtype=dtype_name, rate=rate, stats_given=given,
                                     max_abs_err=err, tol=tol, ok=ok))
        print(f"[check] {name} {shape} {dtype_name} rate={rate} stats_given={given} max_abs_err={err:.3e} "
              f"tol={tol:.3e} ok={ok}", flush=True)

    for (b, s, h, d), dtype_name, rate in BWD_CHECKS:
        dtype = getattr(torch, dtype_name)
        qkv, do = randn((b, s, 3 * h * d), dtype), randn((b, s, h * d), dtype)
        sd = draw_seeds(b, h, dev, gen) if rate else None
        keeps = fap._philox_keep_mask(sd, s, 1.0 - rate) if rate else None
        want3 = fap._fused_bwd_math(qkv, do, h, keeps, 1.0 - rate)
        want6 = fap._packed_heads_bwd_math(*split3(qkv), do, h, keeps, 1.0 - rate)
        for given in (True, False):
            got3, got6 = k3_k6b(qkv, do, h, sd, rate, given)
            report_bwd("k3", (b, s, h, d), dtype_name, rate, got3, want3, given, want6[2], s)
            for part, g, w in zip("qkv", got6, want6):
                report_bwd(f"k6b d{part}", (b, s, h, d), dtype_name, rate, g, w, given, want6[2], s)
        del qkv, do, keeps, want3, want6
    for shape, dtype_name, rate in K5B_CHECKS:
        dtype = getattr(torch, dtype_name)
        q, k, v, do = inputs(shape, dtype) + [randn(shape, dtype)]
        sd = seeds(shape) if rate else None
        wants = fa._bwd_math(q, k, v, do, fa._scale(q), fa._keep(q, sd, rate), 1.0 - rate)
        for given in (True, False):
            for part, g, w in zip("qkv", k5b(q, k, v, do, sd, rate, given), wants):
                report_bwd(f"k5b d{part}", shape, dtype_name, rate, g, w.to(dtype), given, wants[2], shape[2])

    scrub = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scrub.zero_
    for name, shape, dtype_name, rate in TIMES:
        dtype = getattr(torch, dtype_name)
        row = dict(kernel=name, shape=shape, dtype=dtype_name, rate=rate)
        if name in ("k1", "k5f"):
            q, k, v = inputs(shape, dtype)
            sd = seeds(shape) if rate else None
            kernel = (lambda: fa.flash_attention_cuda(q, k, v)) if name == "k1" else (lambda: k5f(q, k, v, sd, rate))
            row["ms"] = median_ms(kernel, flush)
            if name == "k5f" and stats:
                row["ms_with_lse"] = median_ms(
                    lambda: fa.flash_attention_dropout_cuda(q, k, v, sd, rate, with_lse=True), flush)
            if rate == 0.0:
                row["plain_ms"] = median_ms(lambda: fa._fwd_math(q, k, v, fa._scale(q)).to(dtype), flush)
        else:
            b, s, h, d = shape
            qkv = randn((b, s, 3 * h * d), dtype)
            sd = draw_seeds(b, h, dev, gen) if rate else None
            q, k, v = split3(qkv)
            if name == "k2":
                kernel = lambda **kw: fap.flash_attention_fused_cuda(qkv, h, sd, rate, **kw)
            else:
                kernel = lambda **kw: fap.flash_attention_packed_cuda(q, k, v, h, sd, rate, **kw)
            row["ms"] = median_ms(kernel, flush)
            if stats:
                row["ms_with_lse"] = median_ms(lambda: kernel(with_lse=True), flush)
            if rate == 0.0:
                row["plain_ms"] = median_ms(lambda: fap._fused_fwd_math(qkv, h), flush)
        record["times"].append(row)
        print("[time] " + " ".join(f"{key}={val}" for key, val in row.items()), flush=True)
    for name, shape, dtype_name, rate in BWD_TIMES:
        dtype = getattr(torch, dtype_name)
        row = dict(kernel=name, shape=shape, dtype=dtype_name, rate=rate)
        if name == "k5b":
            q, k, v, do = inputs(shape, dtype) + [randn(shape, dtype)]
            sd = seeds(shape) if rate else None
            kw = {}
            if stats:
                out, lse = fa.flash_attention_dropout_cuda(q, k, v, sd, rate, with_lse=True)
                kw = dict(out=out, lse=lse)
            kernel = lambda **given: fa.flash_attention_bwd_cuda(q, k, v, do, sd, rate, **given)
        else:
            b, s, h, d = shape
            qkv, do = randn((b, s, 3 * h * d), dtype), randn((b, s, h * d), dtype)
            sd = draw_seeds(b, h, dev, gen) if rate else None
            q, k, v = split3(qkv)
            if name == "k3":
                forward = lambda: fap.flash_attention_fused_cuda(qkv, h, sd, rate, with_lse=True)
                kernel = lambda **given: fap.flash_attention_fused_bwd_cuda(qkv, do, h, sd, rate, **given)
            else:
                forward = lambda: fap.flash_attention_packed_cuda(q, k, v, h, sd, rate, with_lse=True)
                kernel = lambda **given: fap.flash_attention_packed_bwd_cuda(q, k, v, do, h, sd, rate, **given)
            kw = dict(zip(("out", "lse"), forward())) if stats else {}
        row["ms"] = median_ms(lambda: kernel(**kw), flush)
        row["ms_standalone"] = median_ms(kernel, flush)
        record["times"].append(row)
        print("[time] " + " ".join(f"{key}={val}" for key, val in row.items()), flush=True)
    record["sm_clock_end"] = smi("clocks.sm")
    print(f"[card] sm_clock_end={record['sm_clock_end']} failed_checks={failed}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
