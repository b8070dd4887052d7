"""Headline bench of the port: sampling and training throughput of the flagship models on one card.

    python -m bsi_torch.bench

Counterpart of the repo's ``bench.py``, with its five rows:

- sampling, samples/s at k=128, batch 64, bf16: the CIFAR-10 VDM-UNet (dim
  128, 32 levels; the headline number) and DiT-L/2 at 32x32 (patch 2, dim
  1024, depth 24, 16 heads: the imagenet32 recipe's model);
- training, examples/s of the train step (``scripts/bench_train.py``): the
  UNet at batch 128; DiT-L/2 at batch 64 with bf16 Adam moments and
  ``remat``; and the imagenet32 recipe's optimizer batch 512 as 16
  micro-batches of 32, with ``remat``.

Each record carries ``tflops_per_sec`` and ``mfu``: the FLOPs are counted
from the layer shapes (``profile_sampling.count_flops``; a sampling run
makes k+1 forwards, a train step three forwards' worth per micro-batch)
against the card's dense bf16 peak, so an inflated rate would show as an
impossible MFU. Each also carries its peak device memory and the card's
name and power limit.

``vs_baseline`` divides by the ``A100_BASELINE_*`` constants, which are
analytic estimates of the torch reference on one A100 (~45 and ~161 GFLOP a
forward at ~60 TFLOP/s of TF32, three forwards a train example), not
measurements.

Protocol: each row runs in a bounded retry loop that builds its model anew
on each attempt (``_attempt``), and degrades to ``{"error": ...}`` after
``RETRIES`` failures; each record is printed to stdout as one JSON line the
moment it exists; progress goes to stderr; the last stdout line is the
combined record (the UNet sampling record, or the first row that has a
``value``, with every row under ``dit`` and ``train``). The command then
exits 1 if any row is an error record. It runs on the card, and raises
without one.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from bsi_torch.core.common import resolve_device
from bsi_torch.profile_sampling import build_algo, build_model, card, count_flops, peak_flops, synchronize
from bsi_torch.scripts import bench_train

_T0 = time.monotonic()

# Analytic A100 estimates of the torch reference (module docstring):
# samples/s and examples/s.
A100_BASELINE_UNET = 8.0
A100_BASELINE_DIT = 2.9
A100_BASELINE_UNET_TRAIN = 444.0
A100_BASELINE_DIT_TRAIN = 124.0
K_STEPS = 128
BATCH = 64
RETRIES = 3

# The rows, in the order they run: a sampling row's model and metric, a
# train row's arguments to bench_train.run; then the baseline each row's
# vs_baseline divides by.
SAMPLING_ROWS = {
    "unet-sampling": ("unet", f"bsi-cifar10-unet sampling throughput (k={K_STEPS}, bf16, batch {BATCH})"),
    "dit-sampling": ("dit", f"bsi-dit-L/2-32x32 sampling throughput (k={K_STEPS}, bf16, batch {BATCH})"),
}
TRAIN_ROWS = {
    "unet-train": dict(model_name="unet", steps=30),
    "dit-train": dict(model_name="dit", steps=30, mu_dtype="bfloat16", nu_dtype="bfloat16", remat=True),
    "dit-train-b512": dict(model_name="dit", batch=512, accum=16, steps=6, mu_dtype="bfloat16",
                           nu_dtype="bfloat16", remat=True),
}
BASELINES = {"unet-sampling": A100_BASELINE_UNET, "dit-sampling": A100_BASELINE_DIT,
             "unet-train": A100_BASELINE_UNET_TRAIN, "dit-train": A100_BASELINE_DIT_TRAIN,
             "dit-train-b512": A100_BASELINE_DIT_TRAIN}


def _phase(msg: str) -> None:
    """Progress on stderr (stdout stays line-oriented JSON)."""
    print(f"[bench +{time.monotonic() - _T0:.0f}s] {msg}", file=sys.stderr, flush=True)


def _emit(record: dict) -> None:
    """Print one record the moment it exists: a later failure cannot erase
    a number already measured."""
    print(json.dumps(record), flush=True)


def _attempt(label: str, fn, *, retries: int = RETRIES) -> dict:
    """``fn()`` with bounded retries, each a fresh call (the model is built
    anew); an error record after the last failure instead of raising."""
    last = None
    for i in range(1, retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- one row's failure must not lose the others
            last = e
            _phase(f"{label}: attempt {i}/{retries} failed: {type(e).__name__}: {e}")
            if i < retries:
                time.sleep(10 * i)
    return {"error": f"{type(last).__name__}: {last}"}


def bench_sampling(model: torch.nn.Module, algo, *, batch: int, n_iters: int = 3, seed: int = 0,
                   before_run=None, after_run=None) -> dict:
    """Time ``algo.sample`` with ``model``: one warm-up, then ``n_iters``
    runs of ``batch`` samples, each synchronised. Raises on samples of the
    wrong shape or not finite. ``before_run()`` runs before each timed run
    (after the peak memory's reset) and ``after_run(samples)`` after it,
    outside the clock: ``chip_smoke.py`` gates each run's kernel launches
    there."""
    device = next(model.parameters()).device
    shape = tuple(algo.data_shape)
    mu = torch.zeros((batch,) + shape, device=device)
    t = torch.full((batch,), 0.5, device=device)
    with torch.inference_mode():
        fwd_flops = sum(count_flops(model, lambda: algo._predict_x(model, mu, t)).values())
    gen = torch.Generator(device=device).manual_seed(seed)
    _phase(f"{type(model).__name__}: warm-up run (the first builds the kernels)")
    algo.sample(model, gen, batch, device=device)
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_s = []
    for _ in range(n_iters):
        if before_run is not None:
            before_run()
        t0 = time.perf_counter()
        samples = algo.sample(model, gen, batch, device=device)
        synchronize(device)
        run_s.append(time.perf_counter() - t0)
        if samples.shape != (batch,) + shape or not bool(torch.isfinite(samples).all()):
            raise AssertionError(f"bad samples: shape {tuple(samples.shape)}, "
                                 f"finite {bool(torch.isfinite(samples).all())}")
        if after_run is not None:
            after_run(samples)
    elapsed = sum(run_s)
    run_flops = fwd_flops * (algo.k + 1)
    record = {"value": n_iters * batch / elapsed, "unit": "samples/sec/chip", "k": algo.k, "batch": batch,
              "run_s": run_s, "sample_ms": elapsed / (n_iters * batch) * 1e3, "tflop_per_run": run_flops / 1e12,
              "tflops_per_sec": run_flops * n_iters / elapsed / 1e12, "flops_model": "forward-only"}
    peak = peak_flops(device)
    if peak is not None:
        record["mfu"] = run_flops * n_iters / elapsed / peak
    record["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    return {**record, **card(device)}


def measure(label: str, device=None) -> dict:
    """The record of the row ``label`` on ``device``."""
    if label in SAMPLING_ROWS:
        name, _ = SAMPLING_ROWS[label]
        return bench_sampling(build_model(name, resolve_device(device)), build_algo(K_STEPS), batch=BATCH)
    return bench_train.run(**TRAIN_ROWS[label], device=device)


def finish(label: str, record: dict) -> dict:
    """The row's record as printed: a sampling row's ``metric`` first, and
    ``vs_baseline`` where it has a ``value``."""
    if label in SAMPLING_ROWS:
        record = {"metric": SAMPLING_ROWS[label][1], **record}
    if "value" in record:
        record = {**record, "vs_baseline": record["value"] / BASELINES[label]}
    return record


def combine(records: dict) -> dict:
    """The last line: the UNet sampling record, or if that has no ``value``
    the first row's that has one, with the DiT sampling row under ``dit``
    and the train rows under ``train``."""
    combined = dict(records["unet-sampling"])
    for label in ("dit-sampling", "unet-train", "dit-train", "dit-train-b512"):
        if "value" not in combined and "value" in records[label]:
            combined = dict(records[label])
    combined["dit"] = records["dit-sampling"]
    combined["train"] = {"unet": records["unet-train"], "dit": records["dit-train"],
                         "dit_b512": records["dit-train-b512"]}
    return combined


def main(device=None) -> int:
    """Run the five rows; returns the exit code (1 if a row failed)."""
    device = resolve_device(device)
    records = {}
    for label in (*SAMPLING_ROWS, *TRAIN_ROWS):
        records[label] = finish(label, _attempt(label, lambda: measure(label, device)))
        _emit(records[label])
    print(json.dumps(combine(records)), flush=True)
    return 1 if any("error" in record for record in records.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
