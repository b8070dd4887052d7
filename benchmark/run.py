"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
check compared, beside its limit, which also close standard error. Exits
with another code than 0, and prints no result, without the CUDA devices
the cell asks for, or when the process holds JAX or the JAX package.
Triton's and CUDA's kernel caches live under ``benchmark/.cache/``, beside
the port's own ``bsi_torch/ops/_build/``: only a checkout's first run
builds. The program runs with its own defaults (its CPU thread pools
included), as ``python -m bsi_torch.train`` does. An end-to-end metric's
name is the quantity the driver measures, up to its first dot; what follows
the dot names the cells that the metric's bound holds
(``train_examples_per_s.dit-l2-in32``).
"""

import time

T0 = time.time()  # set-up is timed from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(HERE / ".cache" / "nv")

    import torch

    from benchmark import compare, harness

    cell = harness.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), found {found}; no result",
              file=sys.stderr)
        return 2
    driver = harness.load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py")
    out = driver.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=T0,
                     device=torch.device("cuda", 0))
    held = harness.forbidden_modules()
    if held:
        print(f"benchmark: the run holds {held}; no result", file=sys.stderr)
        return 3
    if args.trace:
        metrics = harness.per_layer(cell, out.info)
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": compare.verdict(out.checks, cell.limits), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": harness.device_record(cell.chips, out.peak_bytes, out.trace)}
    if out.trace is not None:
        result["breakdown"] = harness.breakdown(out.trace)
        print(f"benchmark: traced run: {json.dumps(out.e2e)}", file=sys.stderr)
    # a number that is not finite (a loss gone to NaN) prints as null and fails
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": cell.limits[k]}
                        for k, v in compare.compared(out.checks, cell.limits).items()}
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
