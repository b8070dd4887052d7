"""Check and time K4f and K4b (the DiT's LayerNorm+modulate, forward and backward) on one GPU.

    python bsi_torch/time_ln_modulate.py [--root DIR] [--sweep] [--out FILE]

Imports ``bsi_torch`` from ``DIR`` (the checkout this file is in by
default, so an unpacked older commit can be timed by the same script),
holds both kernels against their plain versions at DiT-L/2's shapes
([64, 256, 1024], shift and scale column slices of a [64, 6144] adaLN
output, as the DiT block passes them; bf16 within 2e-2 plus one bf16 ulp,
f32 within 1e-5; K4b's dshift and dscale within 1e-4 of their largest
element), then times them at bf16: medians of 30 calls between CUDA
events, the L2 flushed before each (``ms``: by ``zero_``, which leaves it
full of dirty lines the timed call writes back; ``ms_clean_l2``: by a
read of the scrub buffer), and from a ``torch.profiler``
trace of 30 calls, the L2 flushed between them, the median over calls of
the summed device time of every kernel a call launches (``device_ms``,
with the kernels' names) and of the kernel itself (``kernel_device_ms``,
the kernels named ``ln_mod_*``), beside the bound (bytes over 3.35 TB/s).
With ``--sweep`` (a checkout whose K4b takes a plan) K4b is also timed at
every cluster size and ring depth its rows allow, through the C entry.
Prints one line per check and per time, and the card's name, power limit
and SM clock at the start and the end; with ``--out`` also writes them as
JSON. Exits non-zero if a check fails or there is no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
SHAPE = (64, 256, 1024)  # DiT-L/2 at 32x32: batch 64, 256 tokens, dim 1024
REPS = 30


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def median_ms(fn, flush, reps: int = REPS) -> float:
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


def device_ms(fn, mark, reps: int = REPS) -> dict:
    """From a profile of ``reps`` calls of ``fn``, each after ``mark()`` (an
    in-place bitwise not, which flushes the L2 and whose kernel separates the
    calls): the median summed device ms of a call's kernels, of its
    ``ln_mod_*`` kernels alone, and the kernels a call launches (the same in
    every call, or this raises)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            mark()
            fn()
        mark()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    calls = []
    for e in events:
        if "bitwise_not" in e.name:
            calls.append([])
        elif calls:
            calls[-1].append(e)
    calls = [c for c in calls[:-1] if c]
    launched = [collections.Counter(e.name for e in c) for c in calls]
    if not calls or any(n != launched[0] for n in launched):
        raise AssertionError(f"profile: calls launched different kernels: {launched}")
    total = [sum(e.time_range.elapsed_us() for e in c) / 1e3 for c in calls]
    own = [sum(e.time_range.elapsed_us() for e in c if "ln_mod" in e.name) / 1e3 for c in calls]
    return dict(device_ms=statistics.median(total), kernel_device_ms=statistics.median(own),
                calls=len(calls), kernels=dict(launched[0]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_ln_modulate: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from bsi_torch.ops import ln_modulate as lm

    dev = torch.device("cuda")
    record = {"root": args.root, "card": smi("name,power.limit"), "sm_clock_start": smi("clocks.sm"),
              "checks": [], "times": []}
    print(f"[card] {record['card']} sm_clock={record['sm_clock_start']} bsi_torch={lm.__file__}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    scrub = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    # zero_ leaves the L2 full of dirty lines, which the timed call writes
    # back as it evicts them; a read of the scrub buffer leaves it clean
    clean_flush = lambda: scrub.view(torch.int64).amax()
    failed = 0
    b, seq, d = SHAPE

    def inputs(dtype):
        x = (torch.randn(*SHAPE, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
        g = torch.randn(*SHAPE, generator=gen, device=dev).to(dtype)
        mod = torch.randn(b, 6 * d, generator=gen, device=dev).to(dtype)
        return x, g, mod[:, :d], mod[:, d:2 * d]

    def check(name, dtype, got, want):
        nonlocal failed
        ulp = 2**-7 if dtype == torch.bfloat16 else 0.0
        errs, ok = [], True
        for i, (a, w) in enumerate(zip(got, want)):
            a, w = a.float(), w.float()
            atol = (2e-2 if dtype == torch.bfloat16 else 1e-5) if i == 0 else 1e-4 * w.abs().max().item()
            diff = (a - w).abs()
            ok = ok and bool((diff <= atol + ulp * w.abs()).all())
            errs.append(diff.max().item())
        failed += not ok
        record["checks"].append(dict(kernel=name, shape=SHAPE, dtype=str(dtype), max_abs_err=errs, ok=ok))
        print(f"[check] {name} {SHAPE} {dtype} max_abs_err={['%.3e' % e for e in errs]} ok={ok}", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        x, g, shift, scale = inputs(dtype)
        check("k4f", dtype, (lm.layernorm_modulate_cuda(x, shift, scale),), (lm._reference_math(x, shift, scale),))
        check("k4b", dtype, lm.layernorm_modulate_bwd_cuda(x, scale, g), lm._bwd_math(x, scale, g))
        torch.cuda.synchronize()

    x, g, shift, scale = inputs(torch.bfloat16)
    elem_bytes = x.numel() * x.element_size()
    for name, fn, n_bytes in (
        ("k4f", lambda: lm.layernorm_modulate_cuda(x, shift, scale), 2 * elem_bytes + 2 * b * d * x.element_size()),
        ("k4b", lambda: lm.layernorm_modulate_bwd_cuda(x, scale, g), 3 * elem_bytes + 3 * b * d * x.element_size()),
    ):
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        row = dict(kernel=name, shape=SHAPE, dtype="bfloat16", ms=median_ms(fn, scrub.zero_),
                   ms_clean_l2=median_ms(fn, clean_flush), **device_ms(fn, scrub.bitwise_not_), bound_ms=bound_ms)
        row["share_of_bound"] = bound_ms / row["kernel_device_ms"]
        if name == "k4b" and hasattr(lm, "plan"):
            row["plan"] = lm.plan(*SHAPE, torch.bfloat16)._asdict()
        record["times"].append(row)
        print("[time] " + " ".join(f"{key}={val}" for key, val in row.items()), flush=True)

    if args.sweep and hasattr(lm, "plan"):
        # every cluster size and ring depth the rows allow, through the C entry
        base = lm.plan(*SHAPE, torch.bfloat16)
        dx, dshift = torch.empty_like(x), torch.empty(b, d, dtype=x.dtype, device=dev)
        dscale = torch.empty_like(dshift)
        lib = lm._lib()
        for cluster in (1, 2, 4, 8):
            for stages in range(1, lm._MAX_STAGES + 1):
                smem = lm._smem_bytes(True, x.element_size(), d, stages)
                if smem > lm.SMEM_LIMIT or stages > -(-base.tiles // cluster):
                    continue
                p = base._replace(cluster=cluster, stages=stages, smem_bytes=smem)

                def call(p=p):
                    code = lib.bsi_ln_modulate_bwd(
                        x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), dshift.data_ptr(),
                        dscale.data_ptr(), b, seq, d, *scale.stride(), 1, 1, p.rows, p.stages, p.cluster,
                        p.smem_bytes, lm._EPS, x.device.index, torch.cuda.current_stream().cuda_stream)
                    lm._build.check(lib, code, "ln_modulate_bwd kernel")

                row = dict(kernel="k4b", sweep=True, cluster=cluster, stages=stages, smem_bytes=smem,
                           clusters_held=lm.max_active_clusters(p, d, x.dtype), ms=median_ms(call, scrub.zero_),
                           ms_clean_l2=median_ms(call, clean_flush),
                           kernel_device_ms=device_ms(call, scrub.bitwise_not_)["kernel_device_ms"])
                record["times"].append(row)
                print("[sweep] " + " ".join(f"{key}={val}" for key, val in row.items()), flush=True)
    record["sm_clock_end"] = smi("clocks.sm")
    print(f"[card] sm_clock_end={record['sm_clock_end']} failed_checks={failed}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
