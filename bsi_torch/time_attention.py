"""Check and time the attention forwards K1, K5f, K2 and K6f on one GPU.

    python bsi_torch/time_attention.py [--root DIR] [--out FILE]

Imports ``bsi_torch`` from ``DIR`` (the checkout this file is in by
default, so an unpacked older commit can be timed by the same script),
builds its K1, K5f and K2/K6f, holds each against its plain version at the
UNet's and DiT-L/2's shapes and at ragged lengths (bf16 within 2e-2, f32
within 1e-5), then times the kernels and their plain versions at those
shapes: medians of 30 launches between CUDA events, the L2 flushed before
each (``chip_smoke.py`` times the library's attention beside them).
Prints one line per check and per time, and the card's name, power limit
and SM clock at the start and the end; with ``--out`` also writes them as
JSON. Exits non-zero if a check fails or there is no card.
"""

from __future__ import annotations

import argparse
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
            if rate == 0.0:
                row["plain_ms"] = median_ms(lambda: fa._fwd_math(q, k, v, fa._scale(q)).to(dtype), flush)
        else:
            b, s, h, d = shape
            qkv = randn((b, s, 3 * h * d), dtype)
            sd = draw_seeds(b, h, dev, gen) if rate else None
            if name == "k2":
                kernel = lambda: k2(qkv, h, sd, rate)
            else:
                q, k, v = split3(qkv)
                kernel = lambda: fap.flash_attention_packed_cuda(q, k, v, h, sd, rate)
            row["ms"] = median_ms(kernel, flush)
            if rate == 0.0:
                row["plain_ms"] = median_ms(lambda: fap._fused_fwd_math(qkv, h), flush)
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
